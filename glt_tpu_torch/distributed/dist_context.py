"""Process-role bookkeeping for distributed deployments (cf.
``glt_tpu/distributed/dist_context.py``).

The data plane's ranks live in the mesh
(:mod:`glt_tpu_torch.parallel.multihost`); this module tracks the
**host-process role topology** of the server-client deployment: which
role this process plays (WORKER / SERVER / CLIENT), its rank within the
role group, and the fleet's shape (several servers and several clients).
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Optional


class DistRole(enum.Enum):
    WORKER = 1   # non-server worker group
    SERVER = 2   # sampling server (server-client mode)
    CLIENT = 3   # trainer client (server-client mode)


@dataclass(frozen=True)
class DistContext:
    """Distributed context of the current process (cf. dist_context.py:33).

    ``world_size``/``rank`` are within the role group;
    ``global_world_size``/``global_rank`` span all role groups (servers
    enumerate first, then clients — the reference's naming convention).
    """
    role: DistRole
    group_name: str
    world_size: int
    rank: int
    global_world_size: int
    global_rank: int

    def __post_init__(self):
        if not (0 < self.world_size and 0 <= self.rank < self.world_size):
            raise ValueError(
                f"rank {self.rank} not in [0, {self.world_size})")
        if not (self.world_size <= self.global_world_size
                and 0 <= self.global_rank < self.global_world_size):
            raise ValueError(
                f"global rank {self.global_rank} / world "
                f"{self.global_world_size} inconsistent with role world "
                f"{self.world_size}")

    def is_worker(self) -> bool:
        return self.role == DistRole.WORKER

    def is_server(self) -> bool:
        return self.role == DistRole.SERVER

    def is_client(self) -> bool:
        return self.role == DistRole.CLIENT

    def num_servers(self) -> int:
        if self.role == DistRole.SERVER:
            return self.world_size
        if self.role == DistRole.CLIENT:
            return self.global_world_size - self.world_size
        return 0

    def num_clients(self) -> int:
        if self.role == DistRole.CLIENT:
            return self.world_size
        if self.role == DistRole.SERVER:
            return self.global_world_size - self.world_size
        return 0

    @property
    def worker_name(self) -> str:
        return f"{self.group_name}-{self.rank}"


_lock = threading.Lock()
_context: Optional[DistContext] = None


def get_context() -> Optional[DistContext]:
    return _context


def _set(ctx: DistContext) -> DistContext:
    global _context
    with _lock:
        _context = ctx
    return ctx


def _set_default(ctx: DistContext) -> DistContext:
    """Install ``ctx`` as the process context only if none is set.

    Used by in-process conveniences (e.g. DistServer construction) so
    that hosting several roles in one process — the single-host test
    topology — does not silently last-writer-win the global; explicit
    ``init_*_context`` calls always overwrite.
    """
    global _context
    with _lock:
        if _context is None:
            _context = ctx
    return ctx


def init_worker_group(world_size: int = 1, rank: int = 0,
                      group_name: str = "_default_worker") -> DistContext:
    """Declare this process a worker (cf. init_worker_group,
    dist_context.py:169)."""
    return _set(DistContext(DistRole.WORKER, group_name, world_size, rank,
                            world_size, rank))


def make_server_context(num_servers: int, server_rank: int,
                        num_clients: int = 0,
                        group_name: str = "_default_server") -> DistContext:
    """Build (without installing) a SERVER context; servers take global
    ranks [0, num_servers), clients follow — the reference's convention."""
    return DistContext(
        DistRole.SERVER, group_name, num_servers, server_rank,
        num_servers + max(num_clients, 0), server_rank)


def init_server_context(num_servers: int, server_rank: int,
                        num_clients: int = 0,
                        group_name: str = "_default_server") -> DistContext:
    """Declare this process a sampling server."""
    return _set(make_server_context(num_servers, server_rank, num_clients,
                                    group_name))


def init_client_context(num_clients: int, client_rank: int,
                        num_servers: int = 0,
                        group_name: str = "_default_client") -> DistContext:
    """Declare this process a trainer client."""
    return _set(DistContext(
        DistRole.CLIENT, group_name, num_clients, client_rank,
        max(num_servers, 0) + num_clients,
        max(num_servers, 0) + client_rank))
