"""The H100's launch limits: the one source of truth for the swept
kernels' launch points (cf. ``glt_tpu/ops/tpu_limits.py``).

Every number here is a limit of one NVIDIA H100 SXM that the CUDA
kernels' launch points (``ops/gather_cuda.py``, ``ops/sample_cuda.py``)
and the static launch model (``analysis/kernelmodel.py``, GLT017 and
GLT019) reason about.  The analyzer resolves these names through its
symbol table, so editing a value here re-checks every swept point
against the new limit on the next lint run.

Sources: the hopper-kernels table (132 SMs; 227 KB, 232,448 bytes, of
shared memory a block, above 48 KB only as dynamic shared memory after
``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
...)``; loads fastest as 16 bytes a thread) and CUDA's compute-capability
9.0 limits (1,024 threads a block, 32-lane warps).

Stdlib-only on purpose: the analyzer runs without torch.
"""
from __future__ import annotations

# Threads a block may launch.
MAX_THREADS_PER_BLOCK = 1024

# Lanes of a warp: a block's threads and a row's lane group tile it.
WARP = 32

# Dynamic shared memory a launch may ask for without the opt-in attribute
# (none of the port's kernels sets it), and the most it may ask for with it.
MAX_DYNAMIC_SMEM_BYTES = 48 * 1024
MAX_DYNAMIC_SMEM_OPTIN_BYTES = 232_448

# Widest vector load or store a thread issues (one 128-bit access).
MAX_VECTOR_BYTES = 16

# Streaming multiprocessors, and the resident blocks an SM holds at most
# (the bounds of a grid cap in blocks per SM).
NUM_SMS = 132
MAX_BLOCKS_PER_SM = 32
