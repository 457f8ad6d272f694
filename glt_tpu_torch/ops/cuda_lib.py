"""Build and load the port's CUDA kernels (``glt_tpu_torch/csrc/*.cu``).

The kernels are CUDA C++ with a plain C interface, compiled by ``nvcc``
for ``sm_90a`` into one shared library and loaded with :mod:`ctypes`.
The build runs at the first CUDA call, from the sources in the
checkout: one ``nvcc -c`` per source, all started together, then one
link.  The library lands in ``build/glt_tpu_torch/<hash>/`` beside the
package, where ``<hash>`` covers the sources and flags, so an edited
source never loads a stale library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "glt_tpu_torch"
SOURCES = ("sample.cu", "threefry.cu", "gather.cu", "fused_frontier.cu",
           "gather_dequant.cu", "fused_frontier_dequant.cu")
# Headers the sources include; they count in the build hash.
HEADERS = ("dequant.cuh", "threefry.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry points: name -> argument types.  Pointers and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int).
_SIGNATURES = {
    # indptr, n_ptr, indices, edge_ids, seeds, key, rows, fanout,
    # replace, by_id, eid_mode, nbrs, eids, mask, stream
    "glt_sample_neighbors": [_P, _I64, _P, _P, _P, _P, _I64, _I32, _I32,
                             _I32, _I32, _P, _P, _P, _P],
    # keys, data, value, counter_mode, n_keys, n_counters, out, stream
    "glt_threefry_hash": [_P, _P, _I64, _I32, _I64, _I64, _P, _P],
    # table, idx, out, n_rows, batch, row_bytes, stream
    "glt_gather_rows": [_P, _P, _P, _I64, _I64, _I64, _P],
    # table, uidx, inv, out, n_rows, batch, row_bytes, stream
    "glt_fused_frontier": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    # table, idx, sz, out, n_rows, batch, d, codec, stream
    "glt_gather_rows_dequant": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _P],
    # table, uidx, inv, sz, out, n_rows, batch, d, codec, stream
    "glt_fused_frontier_dequant": [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                   _I32, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build from source")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libglt_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, n + ".o") for n in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", o]
                  for n, o in zip(SOURCES, objs)])
        staged = os.path.join(tmp, lib_path.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", staged]])
        os.replace(staged, lib_path)     # atomic publish
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.glt_error_string.argtypes = [ctypes.c_int]
            lib.glt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().glt_error_string(status).decode()
        raise RuntimeError(f"{kernel} failed to launch: CUDA error "
                           f"{status} ({msg})")
