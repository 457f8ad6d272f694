"""The device mesh of the distributed data plane, in one process (cf.
``glt_tpu/parallel/multihost.py``).

``glt_tpu`` runs its shard bodies under ``shard_map`` on a
``jax.sharding.Mesh`` that may span hosts.  Here a :class:`Mesh` is a
tuple of S torch devices in this process with the mesh's axis names:
shard ``s`` lives on ``mesh.devices[s]``, and the shard bodies run in
turn in Python.  Every shard may sit on one device (S x ``"cpu"`` in the
tests, S x ``cuda:0`` on one card), where each exchange is a copy in
that device's memory.

A 2-D ``(host, chip)`` mesh of shape ``(H, C)`` (:func:`global_mesh_2d`)
lays its S = H * C shards out row-major, shard ``s = h * C + c`` at grid
cell ``(h, c)``, as ``glt_tpu``'s reshape of ``jax.devices()``: the flat
route addresses the shards in the 1-D order, and the hierarchical route
(:mod:`.dist_sampler`) runs its per-host leg along the ``chip`` axis and
its cross-host leg along the ``host`` axis.

A mesh of distinct CUDA devices and one that spans processes raise
``NotImplementedError``: their collectives (``torch.distributed`` over
NCCL) wait for multihost on ``torch.distributed`` (ROADMAP queue A item
7, step 5).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..utils.device import DeviceLike, resolve_device

_LATER = ("waits for multihost on torch.distributed (ROADMAP queue A "
          "item 7, step 5)")


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Mesh:
    """S torch devices of this process along named axes (the stand-in for
    ``jax.sharding.Mesh``; 1-D: ``Mesh(["cuda:0"] * 4, ("shard",))``;
    2-D: ``Mesh([["cpu"] * 2] * 2, ("host", "chip"))``, one row of
    devices a host).

    Every device must be the same one: S shards on one card or on the
    CPU.  ``devices`` is the flat, row-major tuple of resolved devices,
    ``shape`` maps each axis name to its size.
    """

    def __init__(self, devices: Sequence,
                 axis_names: Union[str, Sequence[str]] = ("shard",)):
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        if len(names) not in (1, 2):
            raise ValueError(f"a mesh has one or two axes, got {names}")
        if len(names) == 2:
            if any(isinstance(r, (str, torch.device)) for r in devices):
                raise ValueError("a 2-D mesh takes one row of devices a "
                                 "host (see global_mesh_2d)")
            rows = [list(r) for r in devices]
        else:
            rows = [list(devices)]
        if len({len(r) for r in rows}) > 1:
            raise ValueError(f"the rows of a 2-D mesh differ in length: "
                             f"{[len(r) for r in rows]}")
        devs = tuple(resolve_device(d) for r in rows for d in r)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{[str(d) for d in devs]}")
        if devs[0].type == "cuda":
            cur = torch.cuda.current_device()
            devs = tuple(torch.device("cuda", cur if d.index is None
                                      else d.index) for d in devs)
        if len(set(devs)) != 1:
            raise NotImplementedError(
                f"a mesh over distinct devices {sorted(map(str, set(devs)))}"
                f" {_LATER}; put every shard on one device")
        if _process_count() > 1:
            raise NotImplementedError(f"a mesh that spans processes {_LATER}")
        self.devices: Tuple[torch.device, ...] = devs
        self.axis_names = names
        self.shape = ({names[0]: len(devs)} if len(names) == 1 else
                      {names[0]: len(rows), names[1]: len(rows[0])})

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every shard of this mesh lives on."""
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.size} x {str(self.device)!r}, "
                f"axis_names={self.axis_names})")


def global_mesh_2d(devices: Sequence[DeviceLike], host_axis: str = "host",
                   chip_axis: str = "chip", num_hosts: Optional[int] = None
                   ) -> Mesh:
    """The ``(host, chip)`` mesh of ``devices`` (the S shard devices of
    this process, flat) reshaped ``[num_hosts, S // num_hosts]`` row-major,
    as ``glt_tpu``'s ``global_mesh_2d`` reshapes ``jax.devices()``.

    ``num_hosts`` defaults to the process count (1 here: a degenerate
    ``1 x S`` grid); pass 2 to lay S shards of one card out as two
    hosts.  Raises ``ValueError`` when S is not divisible by it.
    """
    devs = list(devices)
    n = len(devs)
    h = _process_count() if num_hosts is None else int(num_hosts)
    if h <= 0 or n % h:
        raise ValueError(f"cannot reshape {n} devices onto {h} mesh rows "
                         f"({host_axis!r} axis): not divisible")
    c = n // h
    return Mesh([devs[r * c:(r + 1) * c] for r in range(h)],
                (host_axis, chip_axis))


def resolve_mesh_axes(mesh: Mesh, axis_name=None):
    """A sampler's or step's ``axis_name`` against its mesh: ``None``
    gives the mesh's own axis (the name of a 1-D mesh, the name tuple
    of an N-D one); an explicit value passes through."""
    if axis_name is not None:
        return axis_name
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def mesh_axis_sizes(mesh: Mesh, axis_name):
    """``(num_hosts, chips_per_host)`` for a 2-D axis tuple, else None
    (a 1-D mesh has no topology to choose)."""
    if isinstance(axis_name, str):
        return None
    return tuple(int(mesh.shape[a]) for a in axis_name)


def mesh_axes(mesh: Mesh):
    """The dim-0 sharding axes of ``mesh``: its axis name (1-D) or the
    full name tuple."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


def local_shard_range(mesh: Mesh, axis_name: str = "shard") -> range:
    """Global shard indices whose device lives in this process: every
    shard, since a mesh never spans processes here (the check of a
    process's contiguous block waits for step 5 of queue A item 7)."""
    del axis_name
    return range(mesh.size)
