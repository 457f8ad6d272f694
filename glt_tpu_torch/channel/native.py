"""Build and bind the native shared-memory ring
(``glt_tpu_torch/csrc/shm_queue.cc``).

The ring is host code, compiled by ``g++`` (not ``nvcc``) at its first
use into ``build/glt_tpu_torch/shm-<hash>/libglt_shm.so`` beside the
package, ``<hash>`` covering the source and the flags.  The build goes
to a private temporary path and is published by an atomic rename, so
concurrent builders (threads, or processes sharing the checkout) each
publish a whole library and none loads a half-written one.  A failed
build raises with the compiler's output.  Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "shm_queue.cc"
BUILD_ROOT = _PKG.parent / "build" / "glt_tpu_torch"
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-pthread", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"shm-{h.hexdigest()[:16]}" / "libglt_shm.so"


def ensure_built() -> str:
    """The library's path, building it first if it is not there."""
    so = library_path()
    if so.exists():
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp),
                              "-lrt"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {SOURCE} (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return str(so)


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use; the seconds-long build
    runs outside the lock, the load and prototypes inside it)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so_path = ensure_built()
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(so_path, use_errno=True)
            u64, vp = ctypes.c_uint64, ctypes.c_void_p
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for name, res, args in (
                    ("glt_shmq_create", vp, [ctypes.c_char_p, u64]),
                    ("glt_shmq_attach", vp, [ctypes.c_char_p]),
                    ("glt_shmq_enqueue", ctypes.c_int,
                     [vp, ctypes.c_char_p, u64]),
                    ("glt_shmq_next_size", u64, [vp]),
                    ("glt_shmq_dequeue", ctypes.c_int64, [vp, vp, u64]),
                    ("glt_shmq_msg_count", u64, [vp]),
                    ("glt_shmq_dequeue_alloc", ctypes.c_int,
                     [vp, ctypes.POINTER(u8p), ctypes.POINTER(u64),
                      ctypes.c_int]),
                    ("glt_shmq_buf_free", None, [u8p]),
                    ("glt_shmq_close", None, [vp]),
                    ("glt_shmq_unlink", ctypes.c_int, [ctypes.c_char_p])):
                fn = getattr(L, name)
                fn.restype = res
                fn.argtypes = args
            _LIB = L
    return _LIB
