"""The device mesh of the distributed data plane, in one process (cf.
``glt_tpu/parallel/multihost.py``).

``glt_tpu`` runs its shard bodies under ``shard_map`` on a
``jax.sharding.Mesh`` that may span hosts.  Here a :class:`Mesh` is a
tuple of S torch devices in this process with the mesh's axis names:
shard ``s`` lives on ``mesh.devices[s]``, and the shard bodies run in
turn in Python.  Every shard may sit on one device (S x ``"cpu"`` in the
tests, S x ``cuda:0`` on one card), where each exchange is a copy in
that device's memory.

A mesh of distinct CUDA devices, one that spans processes, and the 2-D
``(host, chip)`` mesh raise ``NotImplementedError``: their collectives
(``torch.distributed`` over NCCL) and the hierarchical routing wait for
a machine with more than one card (ROADMAP queue A item 7).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..utils.device import DeviceLike, resolve_device

_LATER = ("waits for a machine with more than one card (ROADMAP queue A "
          "item 7: multihost on torch.distributed)")


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Mesh:
    """S torch devices of this process along named axes (the stand-in for
    ``jax.sharding.Mesh``; 1-D: ``Mesh(["cuda:0"] * 4, ("shard",))``).

    Every device must be the same one: S shards on one card or on the
    CPU.  ``devices`` is the flat tuple of resolved devices, ``shape``
    maps each axis name to its size.
    """

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_names: Union[str, Sequence[str]] = ("shard",)):
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        if len(names) != 1:
            raise NotImplementedError(
                f"a mesh over axes {names}: the 2-D (host, chip) mesh and "
                f"its hierarchical routing {_LATER}")
        devs = tuple(resolve_device(d) for d in devices)
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
        self.shape = {names[0]: len(devs)}

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
    shard, since a mesh never spans processes here."""
    del axis_name
    return range(mesh.size)
