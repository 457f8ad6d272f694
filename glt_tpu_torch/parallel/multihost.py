"""The device mesh of the distributed data plane, in one process or
across several (cf. ``glt_tpu/parallel/multihost.py``).

``glt_tpu`` runs its shard bodies under ``shard_map`` on a
``jax.sharding.Mesh`` that may span hosts.  Here a :class:`Mesh` is S
shards along named axes, and the shard bodies run in turn in Python.
Inside one process every shard sits on one device (S x ``"cpu"`` in the
tests, S x ``cuda:0`` on one card), and each exchange is a copy in that
device's memory.

A 2-D ``(host, chip)`` mesh of shape ``(H, C)`` (:func:`global_mesh_2d`)
lays its S = H * C shards out row-major, shard ``s = h * C + c`` at grid
cell ``(h, c)``, as ``glt_tpu``'s reshape of ``jax.devices()``: the flat
route addresses the shards in the 1-D order, and the hierarchical route
(:mod:`.dist_sampler`) runs its per-host leg along the ``chip`` axis and
its cross-host leg along the ``host`` axis.

**Across processes.**  :func:`initialize` joins a ``torch.distributed``
group over gloo (the rendezvous env names of ``glt_tpu``:
``GLT_COORDINATOR_ADDR`` or ``MASTER_ADDR``/``MASTER_PORT``,
``GLT_NUM_PROCESSES`` or ``WORLD_SIZE``, ``GLT_PROCESS_ID`` or
``RANK``).  Then :func:`global_mesh` and :func:`global_mesh_2d` build
one mesh over every process's shards: each process contributes its
local shard devices (all one device), and the mesh records which
process owns each flat shard (:class:`Fleet`).  Each process owns one
contiguous run of flat shards (:func:`local_shard_range`) and holds
only those shards' rows: a spanning mesh's sharded tensors (graph
blocks, feature rows, labels, seed blocks) are this process's
``[S_local, ...]`` rows, row ``j`` global shard ``range.start + j``,
and ``num_shards`` stays the global S.  The helpers :func:`assemble_global`,
:func:`shard_graph_global`, :func:`shard_feature_global`,
:func:`labels_global` and :func:`feed_seeds` build those rows.

Every exchange of the data plane then crosses processes through the
transport of :class:`Fleet`: an all-to-all is ``all_to_all_single``
over the whole group, a leg of the 2-D grid one over the group of a
host row (``chip``) or a chip column (``host``), made once per mesh,
the ring's rotation one ``batch_isend_irecv`` pair, and a reduction an
``all_reduce``.  Gloo moves host memory, so a block on the card is
staged by hand: one copy to pinned host memory, the collective on CPU
tensors, one copy back (:func:`transport_stats` counts the bytes).
The pieces a process keeps for its own shards never leave the device.
The sampling and the gathers stay on the card.

A mesh over distinct CUDA devices raises ``NotImplementedError``: its
collectives would be NCCL's, which needs a second card (NCCL refuses
two ranks on one card), so the processes of a fleet on one card share
it over gloo.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.topology import CSRTopo
from ..utils.device import DeviceLike, resolve_device
from .sharding import ShardedFeature, ShardedGraph, shard_graph_blocks

__all__ = [
    "Fleet", "Mesh", "TIMEOUT_ENV", "agree_max", "agree_sum",
    "assemble_global", "barrier", "collective_deadline_secs",
    "feed_seeds", "global_mesh", "global_mesh_2d", "initialize",
    "labels_global", "local_shard_range", "mesh_axes", "mesh_axis_sizes",
    "process_count", "process_index", "reset_transport_stats", "resolve_mesh_axes", "shard_feature_global",
    "shard_graph_global", "shard_hetero_graph_global", "shutdown",
    "transport_stats",
]


def _dist():
    return torch.distributed


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the group (1 outside one)."""
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's index in the group (0 outside one)."""
    return _dist().get_rank() if _initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-process group (idempotent).

    Defaults come from the environment, as ``glt_tpu``'s: the
    coordinator is ``GLT_COORDINATOR_ADDR``, else
    ``MASTER_ADDR:MASTER_PORT``; the process count ``GLT_NUM_PROCESSES``,
    else ``WORLD_SIZE``; this process's index ``GLT_PROCESS_ID``, else
    ``RANK``.  The group is gloo over ``tcp://<coordinator>``; nothing
    here detects a cluster, so all three must be given.
    """
    if _initialized():
        return
    if coordinator_address is None:
        addr = os.environ.get("GLT_COORDINATOR_ADDR")
        if addr is None:
            host = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            addr = f"{host}:{port}" if host and port else None
        coordinator_address = addr
    if num_processes is None:
        n = os.environ.get("GLT_NUM_PROCESSES",
                           os.environ.get("WORLD_SIZE"))
        num_processes = int(n) if n is not None else None
    if process_id is None:
        r = os.environ.get("GLT_PROCESS_ID", os.environ.get("RANK"))
        process_id = int(r) if r is not None else None
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize needs the coordinator address, the process count "
            "and this process's index: pass them, or set "
            "GLT_COORDINATOR_ADDR (or MASTER_ADDR and MASTER_PORT), "
            "GLT_NUM_PROCESSES (or WORLD_SIZE) and GLT_PROCESS_ID (or "
            "RANK)")
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def shutdown() -> None:
    """Leave the group (a no-op outside one); spanning meshes made
    before are unusable after."""
    _FLEETS.clear()
    if _initialized():
        _dist().destroy_process_group()


# -- deadline-bounded host collectives --------------------------------------
#
# With GLT_MULTIHOST_TIMEOUT_S set, every host-side collective of this
# module runs under the supervisor's deadline, so a dead or straggling
# peer surfaces as a BarrierTimeoutError instead of a hang.  Unset, the
# calls run as they are.

#: Env var: seconds a multi-process barrier or host collective may block
#: before a structured BarrierTimeoutError; 0 or unset = unbounded.
TIMEOUT_ENV = "GLT_MULTIHOST_TIMEOUT_S"


def collective_deadline_secs() -> float:
    """The configured collective deadline (0.0 = unbounded)."""
    try:
        return float(os.environ.get(TIMEOUT_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def _bounded(fn, what: str):
    """Run a host-side collective under the configured deadline."""
    deadline = collective_deadline_secs()
    if deadline <= 0:
        return fn()
    from ..distributed.supervisor import run_with_deadline

    return run_with_deadline(fn, deadline, what=what)


def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """A named barrier of every process that cannot hang forever.

    One process: a no-op.  Several: every process gathers the name's
    hash (a mismatch raises ``RuntimeError``), under ``timeout_s``
    (default: the :data:`TIMEOUT_ENV` deadline, unbounded when neither
    is set).  Raises :class:`~glt_tpu_torch.distributed.supervisor.
    BarrierTimeoutError` at the deadline: checkpoint and exit.
    """
    if process_count() == 1:
        return
    dist = _dist()

    def sync():
        tag = torch.tensor([zlib.crc32(name.encode())], dtype=torch.int64)
        seen = [torch.zeros_like(tag) for _ in range(dist.get_world_size())]
        dist.all_gather(seen, tag)
        if any(int(t) != int(tag) for t in seen):
            raise RuntimeError(f"barrier {name!r}: the processes entered "
                               f"different barriers")

    what = f"barrier {name!r}"
    if timeout_s is None:
        _bounded(sync, what=what)
    else:
        from ..distributed.supervisor import run_with_deadline

        run_with_deadline(sync, float(timeout_s), what=what)


def agree_max(value: int) -> int:
    """Max of a host-side int across processes (one process: itself).

    Agrees on padding widths (the per-shard edge-block width) when each
    process computed its own from its partitions only."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    _bounded(lambda: _dist().all_reduce(t, op=_dist().ReduceOp.MAX),
             what="agree_max all_reduce")
    return int(t)


def agree_first(value):
    """Process 0's value (a picklable host object) on every process (one
    process: the value).  Makes a decision that each process measured on
    its own, such as an autotuned route, one decision."""
    if process_count() == 1:
        return value
    box = [value]
    _bounded(lambda: _dist().broadcast_object_list(box, src=0),
             what="agree_first broadcast")
    return box[0]


def agree_sum(arr: np.ndarray) -> np.ndarray:
    """Elementwise sum of a host array across processes (one process:
    the array).  Assembles global statistics from per-partition data,
    such as in-degree hotness when each process holds its partitions'
    edges only."""
    arr = np.asarray(arr)
    if process_count() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).clone()
    _bounded(lambda: _dist().all_reduce(t), what="agree_sum all_reduce")
    return t.numpy()


# -- the transport ----------------------------------------------------------

_STATS = {"collectives": 0, "gloo_bytes": 0, "d2h_bytes": 0,
          "h2d_bytes": 0, "host_syncs": 0}


def transport_stats() -> Dict[str, int]:
    """What the transport of every spanning mesh moved since the last
    :func:`reset_transport_stats`: ``collectives`` (gloo calls),
    ``gloo_bytes`` (bytes this process sent to others), ``d2h_bytes``
    and ``h2d_bytes`` (the staging through pinned host memory) and
    ``host_syncs`` (device-to-host stagings, each a wait for the
    device)."""
    return dict(_STATS)


def reset_transport_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A flat byte view of ``t`` in host memory (pinned when ``t`` is
    on the card; the copy waits for the device)."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    if not b.is_cuda:
        return b
    host = torch.empty(b.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(b)
    _STATS["d2h_bytes"] += b.numel()
    _STATS["host_syncs"] += 1
    return host


def _to_device(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if dev.type != "cuda":
        return host
    _STATS["h2d_bytes"] += host.numel()
    return host.to(dev, non_blocking=True)


def _from_bytes(buf: torch.Tensor, dtype: torch.dtype,
                shape: tuple) -> torch.Tensor:
    return buf.view(dtype).reshape(shape)


class Fleet:
    """The processes of a mesh that spans them: ``owners[s]`` is the
    process holding flat shard ``s``; ``local`` this process's
    contiguous run; ``groups(h, c)`` the process groups of a 2-D grid's
    legs.  The exchanges of :mod:`.dist_sampler` and :mod:`.dist_feature`
    find it by the shard count (:func:`fleet_for`)."""

    def __init__(self, owners: Sequence[int], device_ids: Sequence):
        self.owners = tuple(int(p) for p in owners)
        self.rank = process_index()
        self.device_ids = tuple(device_ids)
        self.local = _owned_run(self.owners, self.device_ids, ("shard",),
                                (len(self.owners),))
        self._groups = {}

    @property
    def size(self) -> int:
        return len(self.owners)

    def groups(self, h: int, c: int):
        """The ``(host row, chip column)`` process groups of the ``(h,
        c)`` grid, one a row and one a column, made once (every process
        makes them in the same order, as ``new_group`` needs)."""
        key = (int(h), int(c))
        if key not in self._groups:
            dist = _dist()
            rows = [sorted({self.owners[r * c + q] for q in range(c)})
                    for r in range(h)]
            cols = [sorted({self.owners[r * c + q] for r in range(h)})
                    for q in range(c)]
            self._groups[key] = ([dist.new_group(rk) for rk in rows],
                                 [dist.new_group(rk) for rk in cols])
        return self._groups[key]

    def exchange(self, shards: Sequence[int], piece, group=None
                 ) -> Dict[int, List[torch.Tensor]]:
        """Every ordered pair of ``shards`` (ascending global ids, the
        members of one collective) moves ``piece(src, dst)`` (``src``
        local; every piece of one shape and dtype) to ``dst``.  Returns,
        per local ``dst``, the pieces from every member in ``shards``
        order.  Pieces between two local shards stay on the device; the
        rest ride one ``all_to_all_single`` over ``group`` (the whole
        group when None), staged through pinned host memory."""
        shards = list(shards)
        owner = self.owners
        mine = [s for s in shards if owner[s] == self.rank]
        procs = sorted({owner[s] for s in shards})
        got = {q: {r: piece(r, q) for r in mine} for q in mine}
        if procs != [self.rank]:
            like = got[mine[0]][mine[0]]
            nbytes = like.numel() * like.element_size()
            dev = like.device
            of = {p: [s for s in shards if owner[s] == p] for p in procs}
            send, in_split, out_split = [], [], []
            for p in procs:
                if p == self.rank:
                    in_split.append(0)
                    out_split.append(0)
                    continue
                parts = [piece(r, q) for q in of[p] for r in mine]
                send += parts
                in_split.append(len(parts) * nbytes)
                out_split.append(len(mine) * len(of[p]) * nbytes)
            flat = torch.cat([x.reshape(-1) for x in send])
            recv = self._all_to_all(_to_host(flat), in_split, out_split,
                                    group)
            recv = _to_device(recv, dev)
            off = 0
            for p, n in zip(procs, out_split):
                if not n:
                    continue
                for q in mine:
                    for r in of[p]:
                        got[q][r] = _from_bytes(recv[off: off + nbytes],
                                                like.dtype, like.shape)
                        off += nbytes
        return {q: [got[q][r] for r in shards] for q in mine}

    def _all_to_all(self, host: torch.Tensor, in_split, out_split, group):
        out = torch.empty(sum(out_split), dtype=torch.uint8,
                          pin_memory=torch.cuda.is_available())
        _dist().all_to_all_single(out, host, out_split, in_split,
                                  group=group)
        _STATS["collectives"] += 1
        _STATS["gloo_bytes"] += sum(in_split)
        return out

    def rotate(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ring's step (``ppermute`` i -> i + 1): shard ``j`` gets
        what shard ``j - 1`` held.  One send of this process's last
        block to the next shard's process and one receive from the
        previous shard's, paired in one ``batch_isend_irecv``."""
        dist = _dist()
        s = len(self.owners)
        lo, hi = self.local.start, self.local.stop
        last = xs[-1]
        buf = _to_host(last)
        recv = torch.empty(buf.numel(), dtype=torch.uint8,
                           pin_memory=last.is_cuda)
        ops = [dist.P2POp(dist.isend, buf, self.owners[hi % s]),
               dist.P2POp(dist.irecv, recv, self.owners[(lo - 1) % s])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _STATS["collectives"] += 1
        _STATS["gloo_bytes"] += buf.numel()
        first = _from_bytes(_to_device(recv, last.device), last.dtype,
                            tuple(last.shape))
        return [first] + list(xs[:-1])

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every process, staged through host memory;
        every process gets the same bits."""
        dist = _dist()
        host = t.detach().contiguous().reshape(-1)
        if host.is_cuda:
            pinned = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            pinned.copy_(host)
            _STATS["d2h_bytes"] += pinned.numel() * pinned.element_size()
            _STATS["host_syncs"] += 1
            host = pinned
        else:
            host = host.clone()
        dist.all_reduce(host)
        _STATS["collectives"] += 1
        _STATS["gloo_bytes"] += host.numel() * host.element_size()
        if t.is_cuda:
            _STATS["h2d_bytes"] += host.numel() * host.element_size()
            host = host.to(t.device, non_blocking=True)
        return host.reshape(t.shape)

    def any_host(self, flags: np.ndarray) -> np.ndarray:
        """Elementwise OR of a host bool array over every process (one
        all-reduce of host memory: no wait for the device)."""
        t = torch.from_numpy(np.asarray(flags, np.int32).reshape(-1))
        t = t.clone()
        _dist().all_reduce(t, op=_dist().ReduceOp.MAX)
        _STATS["collectives"] += 1
        _STATS["gloo_bytes"] += t.numel() * 4
        return t.numpy().reshape(np.shape(flags)) > 0


_FLEETS: Dict[int, Fleet] = {}


def _register(owners: Sequence[int], device_ids) -> Fleet:
    """The fleet of a spanning layout of S shards: one a shard count (a
    second layout of the same S raises)."""
    owners = tuple(owners)
    fleet = _FLEETS.get(len(owners))
    if fleet is not None:
        if fleet.owners != owners:
            raise ValueError(
                f"a spanning mesh of {len(owners)} shards already exists "
                f"with owners {fleet.owners}, not {owners}")
        return fleet
    fleet = _FLEETS[len(owners)] = Fleet(owners, device_ids)
    return fleet


def fleet_for(num_shards: int) -> Fleet:
    """The fleet of the spanning mesh of ``num_shards`` shards (raises
    when none exists)."""
    fleet = _FLEETS.get(int(num_shards))
    if fleet is None:
        raise ValueError(
            f"no mesh of {num_shards} shards spans the processes: build "
            f"it with global_mesh or global_mesh_2d, or pass one block a "
            f"shard")
    return fleet


def local_ids(num_shards: int, count: int) -> range:
    """The global ids of ``count`` per-shard blocks of a mesh of
    ``num_shards`` shards: every shard when ``count == num_shards`` (a
    mesh in this process), else this process's run of a spanning
    mesh."""
    if count == num_shards:
        return range(num_shards)
    fleet = _FLEETS.get(int(num_shards))
    if fleet is None or len(fleet.local) != count:
        held = ("" if fleet is None else
                f" ({len(fleet.local)} of them in this process)")
        raise ValueError(f"{count} shard blocks for {num_shards} "
                         f"shards{held}")
    return fleet.local


class Mesh:
    """S shards along named axes (the stand-in for ``jax.sharding.Mesh``;
    1-D: ``Mesh(["cuda:0"] * 4, ("shard",))``; 2-D: ``Mesh([["cpu"] * 2]
    * 2, ("host", "chip"))``, one row of devices a host).

    In one process every device must be the same one: S shards on one
    card or on the CPU.  ``devices`` is the flat, row-major tuple of
    resolved devices, ``shape`` maps each axis name to its size.  A mesh
    that spans processes comes from :func:`global_mesh` or
    :func:`global_mesh_2d` (``fleet``): there ``devices`` holds this
    process's device at every slot, ``owners`` the process of each flat
    shard and ``spans`` is True.
    """

    def __init__(self, devices: Sequence,
                 axis_names: Union[str, Sequence[str]] = ("shard",),
                 fleet: Optional[Fleet] = None):
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
                f" would exchange over NCCL, which needs a second card "
                f"(one process a card); put every shard of a process on "
                f"one device, and span processes with global_mesh")
        if fleet is not None and fleet.size != len(devs):
            raise ValueError(f"a fleet of {fleet.size} shards for a mesh "
                             f"of {len(devs)}")
        self.devices: Tuple[torch.device, ...] = devs
        self.axis_names = names
        self.shape = ({names[0]: len(devs)} if len(names) == 1 else
                      {names[0]: len(rows), names[1]: len(rows[0])})
        self.fleet = fleet
        self.device_ids = (fleet.device_ids if fleet is not None
                           else tuple(str(d) for d in devs))

    @property
    def owners(self) -> Tuple[int, ...]:
        """The process holding each flat shard."""
        if self.fleet is not None:
            return self.fleet.owners
        return (process_index(),) * self.size

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every shard of this mesh in this process lives on."""
        return self.devices[0]

    @property
    def spans(self) -> bool:
        """Whether the mesh's shards live in more than one process."""
        return self.fleet is not None and len(set(self.owners)) > 1

    @property
    def local(self) -> range:
        """The flat shards of this process (:func:`local_shard_range`)."""
        return (self.fleet.local if self.fleet is not None
                else range(self.size))

    def __repr__(self) -> str:
        where = (f", {len(set(self.owners))} processes" if self.spans
                 else "")
        return (f"Mesh({self.size} x {str(self.device)!r}, "
                f"axis_names={self.axis_names}{where})")


def _gather_local(devs: Sequence[torch.device]):
    """Every process's local shard count and device names, in process
    order: ``(owners, device_ids)``."""
    dist = _dist()
    mine = [str(d) for d in devs]
    seen = [None] * dist.get_world_size()
    _bounded(lambda: dist.all_gather_object(seen, mine),
             what="global_mesh all_gather")
    owners = [p for p, names in enumerate(seen) for _ in names]
    ids = [f"{p}:{name}" for p, names in enumerate(seen) for name in names]
    if any(not names for names in seen):
        raise ValueError("every process of a spanning mesh holds at least "
                         "one shard")
    return owners, ids


def _local_devices(devices) -> List[torch.device]:
    devs = [resolve_device(d) for d in (
        [None] if devices is None else list(devices))]
    Mesh(devs)   # one device type, one device
    return devs


def global_mesh(devices: Optional[Sequence[DeviceLike]] = None,
                axis_name: str = "shard") -> Mesh:
    """One-axis mesh over every process's shards, in process order.

    ``devices``: this process's shard devices (all one device; default
    one shard on ``"cuda"``).  Shard ``s`` of a dim-0-sharded tensor is
    held by the process owning slot ``s``.  In one process: the mesh of
    ``devices``."""
    devs = _local_devices(devices)
    if process_count() == 1:
        return Mesh(devs, (axis_name,))
    owners, ids = _gather_local(devs)
    return Mesh([devs[0]] * len(owners), (axis_name,),
                fleet=_register(owners, ids))


def global_mesh_2d(devices: Optional[Sequence[DeviceLike]] = None,
                   host_axis: str = "host", chip_axis: str = "chip",
                   num_hosts: Optional[int] = None) -> Mesh:
    """The ``(host, chip)`` mesh of every process's shard ``devices``
    (flat, in process order) reshaped ``[num_hosts, S // num_hosts]``
    row-major, as ``glt_tpu``'s ``global_mesh_2d`` reshapes
    ``jax.devices()``.

    ``num_hosts`` defaults to the process count (one row a process);
    pass 2 to lay S shards of one process out as two hosts.  Raises
    ``ValueError`` when S is not divisible by it, or when a process's
    shards straddle a host-row boundary without covering whole rows
    (each row must be a union of whole process blocks, or each process
    block a union of whole rows).  Across processes the mesh makes its
    row and column process groups once, here.
    """
    devs = _local_devices(devices)
    world = process_count()
    if world == 1:
        owners, ids = [0] * len(devs), None
    else:
        owners, ids = _gather_local(devs)
    n = len(owners)
    h = world if num_hosts is None else int(num_hosts)
    if h <= 0 or n % h:
        raise ValueError(f"cannot reshape {n} devices onto {h} mesh rows "
                         f"({host_axis!r} axis): not divisible")
    c = n // h
    for r in range(h):
        procs = set(owners[r * c:(r + 1) * c])
        if len(procs) > 1:
            for p in sorted(procs):
                owned = [i for i, o in enumerate(owners) if o == p]
                row_slice = set(range(r * c, (r + 1) * c))
                if not row_slice.issuperset(owned) and \
                        not row_slice.issubset(owned):
                    raise ValueError(
                        f"process {p} devices straddle mesh row {r} of "
                        f"axes ({host_axis!r}, {chip_axis!r}): it owns "
                        f"flat device slots {owned}, row {r} spans "
                        f"{sorted(row_slice)}; pick num_hosts so host "
                        f"rows align with process boundaries")
    if world == 1:
        return Mesh([devs[r * c:(r + 1) * c] for r in range(h)],
                    (host_axis, chip_axis))
    fleet = _register(owners, ids)
    fleet.groups(h, c)
    return Mesh([[devs[0]] * c for _ in range(h)], (host_axis, chip_axis),
                fleet=fleet)


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


def local_shard_range(mesh, axis_name: str = "shard") -> range:
    """Global shard indices held by this process: every shard of a mesh
    in this process, this process's run of a spanning one.

    The per-process helpers build rows for this range only (the
    reference's "each machine loads its own partition").  Raises if the
    process's shards are not contiguous, the invariant the arithmetic
    partition book depends on.
    """
    del axis_name
    return _owned_run(mesh.owners, mesh.device_ids, tuple(mesh.axis_names),
                      tuple(mesh.shape.values()))


def _owned_run(owners, device_ids, axes: tuple, shape: tuple) -> range:
    """This process's flat slots of a mesh as a range (raises unless
    they are one contiguous run)."""
    me = process_index()
    mine = [i for i, p in enumerate(owners) if p == me]
    if not mine:
        return range(0)
    lo, hi = min(mine), max(mine) + 1
    if mine != list(range(lo, hi)):
        offending = [device_ids[i] for i in mine]
        raise ValueError(
            f"local devices are not contiguous on mesh axes {axes!r} "
            f"(shape {shape}): process {me} owns flat shard slots {mine} "
            f"(device ids {offending}), expected one contiguous run — "
            f"rebuild the mesh with global_mesh/global_mesh_2d so each "
            f"process's devices form a contiguous block in flat "
            f"(row-major) device order")
    return range(lo, hi)


def local_rows(x, mesh: Mesh):
    """This process's rows of a per-shard array: ``x[local]`` when ``x``
    holds every shard's row of a spanning mesh, else ``x``."""
    if mesh.spans and x.shape[0] == mesh.size:
        return x[mesh.local.start: mesh.local.stop]
    return x


# -- per-process sharded construction ---------------------------------------

def assemble_global(local_block: np.ndarray, mesh: Mesh,
                    axis_name: str = "shard") -> torch.Tensor:
    """This process's ``[S_local, ...]`` block as the mesh's tensor of
    those shards, on the mesh's device.  Every process's block must
    have the same trailing shape (checked across processes), and the
    leading axis this process's shard count."""
    del axis_name
    blk = np.ascontiguousarray(local_block)
    n_local = len(local_shard_range(mesh))
    if blk.shape[0] != n_local:
        raise ValueError(f"a block of {blk.shape[0]} shards, this process "
                         f"holds {n_local}")
    if mesh.spans:
        trailing = tuple(int(x) for x in blk.shape[1:])
        seen = [None] * process_count()
        _bounded(lambda: _dist().all_gather_object(seen, trailing),
                 what="assemble_global all_gather")
        if len(set(map(tuple, seen))) != 1:
            raise ValueError(f"the processes' blocks differ in their "
                             f"trailing shapes: {seen}")
    return torch.from_numpy(blk).to(mesh.device)


def shard_graph_global(topo: CSRTopo, mesh: Mesh,
                       axis_name: str = "shard") -> ShardedGraph:
    """Full-topology convenience: every process holds ``topo`` and builds
    only its own shards' CSR blocks (the edge width is every shard's
    maximum, the same in every process)."""
    num_shards = mesh.size
    rng = local_shard_range(mesh, axis_name)
    ip, ix, ei, c = shard_graph_blocks(topo, num_shards, shard_range=rng)
    return ShardedGraph(
        indptr=assemble_global(ip, mesh, axis_name),
        indices=assemble_global(ix, mesh, axis_name),
        edge_ids=assemble_global(ei, mesh, axis_name),
        nodes_per_shard=c, num_nodes=topo.num_nodes, num_shards=num_shards)


def shard_hetero_graph_global(topos, mesh: Mesh, axis_name: str = "shard"):
    """Every edge type's CSR sharded by its source type's ranges, this
    process's blocks only."""
    return {et: shard_graph_global(t, mesh, axis_name)
            for et, t in topos.items()}


def shard_feature_global(feature: np.ndarray, mesh: Mesh,
                         axis_name: str = "shard",
                         dtype=None) -> ShardedFeature:
    """``[N, d]`` rows -> this process's ``[S_local, c, d]`` blocks of a
    :class:`ShardedFeature` (zero padded, cast to ``dtype`` if given)."""
    feature = np.asarray(feature)
    n, d = feature.shape
    num_shards = mesh.size
    c = -(-n // num_shards)
    rng = local_shard_range(mesh, axis_name)
    rows = np.zeros((len(rng), c, d), feature.dtype if dtype is None
                    else np.dtype(dtype))
    for j, s in enumerate(rng):
        lo, hi = min(s * c, n), min((s + 1) * c, n)
        rows[j, : hi - lo] = feature[lo:hi]
    return ShardedFeature(rows=assemble_global(rows, mesh, axis_name),
                          nodes_per_shard=c, num_shards=num_shards)


def labels_global(labels: np.ndarray, mesh: Mesh, nodes_per_shard: int,
                  axis_name: str = "shard", fill: int = -1) -> torch.Tensor:
    """Global ``[N]`` labels -> this process's ``[S_local, c]`` block."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    c = nodes_per_shard
    rng = local_shard_range(mesh, axis_name)
    blk = np.full((len(rng), c), fill, labels.dtype)
    for j, s in enumerate(rng):
        lo, hi = min(s * c, n), min((s + 1) * c, n)
        blk[j, : hi - lo] = labels[lo:hi]
    return assemble_global(blk, mesh, axis_name)


def feed_seeds(seeds: np.ndarray, mesh: Mesh,
               axis_name: str = "shard") -> np.ndarray:
    """``[S, B]`` per-shard seed batch -> this process's ``[S_local, B]``
    rows, a host array (the steps take host seeds).  Every process may
    hold the full matrix (``DistDataset.split_seeds`` is reproducible
    from a shared seed); each feeds its own rows."""
    seeds = np.asarray(seeds)
    rng = local_shard_range(mesh, axis_name)
    return seeds[rng.start: rng.stop]
