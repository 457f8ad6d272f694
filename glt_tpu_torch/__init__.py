"""glt_tpu_torch — the graph learning data engine on PyTorch and CUDA.

A port of :mod:`glt_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It imports torch, numpy and the standard library only, and mirrors the
module layout of ``glt_tpu``: the counterpart of ``glt_tpu/x/y.py``
lives at ``glt_tpu_torch/x/y.py``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without
a CUDA device it raises unless the caller asks for ``device="cpu"``.
On a CUDA tensor the hot ops launch the hand-written kernels under
``csrc/`` (built with ``nvcc`` at first use); on a CPU tensor they run
their plain PyTorch versions.
"""
from .typing import PADDING_ID

__all__ = ["PADDING_ID"]
