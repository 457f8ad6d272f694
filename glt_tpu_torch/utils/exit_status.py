"""Interpreter-exit flag for safe ``__del__`` cleanup, cf.
``glt_tpu/utils/exit_status.py``: destructors that touch shared
resources (shm rings, sockets, worker processes) check :func:`is_exiting`
to skip teardown the interpreter already did.
"""
from __future__ import annotations

import atexit

_EXITING = False


def _mark_exit() -> None:
    global _EXITING
    _EXITING = True


atexit.register(_mark_exit)


def is_exiting() -> bool:
    return _EXITING
