"""Gather roofline: a measured device-memcpy bandwidth ceiling (cf.
``glt_tpu/obs/roofline.py``).

A gather's ``gather_gb_s`` means most as a fraction of what the card
can actually stream, not only of the datasheet number.  PyTorch-Direct
and GIDS (PAPERS.md) anchor their irregular-gather claims the same way:
achieved vs a *measured* sequential-copy peak.

Methodology:

  * the probe is ``x -> x + 1.0`` over a contiguous f32 CUDA buffer:
    one read + one write of device memory per pass = ``2 * nbytes``
    traffic, the same in/out streaming a memcpy pays, with no gather
    indirection;
  * passes chain (``x = x + 1.0``) between two CUDA events, so the
    elapsed time is the card's, not the host's enqueue;
  * ``memcpy_gb_s = 2 * nbytes * iters / elapsed``; a gather's
    ``roofline_fraction(gather_gb_s, memcpy_gb_s)`` is then its share of
    the measured ceiling.

The peak table holds NVIDIA datasheet numbers only.
"""
from __future__ import annotations

import os
from typing import Dict

#: Datasheet memory bandwidth (GB/s) by device-name substring, most
#: specific first (matched against the lowercased, space-stripped
#: ``torch.cuda.get_device_name``).  ``GLT_HBM_GBPS`` overrides it for
#: hardware the table doesn't know.
DEVICE_HBM_GB_S = (
    ("h100nvl", 3900.0),
    ("h100pcie", 2000.0),
    ("h100", 3350.0),          # H100 SXM (HBM3)
)
#: Last-resort constant: the H100 SXM datasheet figure.
DEFAULT_HBM_GB_S = 3350.0


def measure_memcpy_roofline(nbytes: int = 1 << 27, iters: int = 10,
                            warmup: int = 2, device=None
                            ) -> Dict[str, float]:
    """Measure the streaming-copy bandwidth of a CUDA device.

    Returns ``{"memcpy_gb_s", "bytes", "iters", "elapsed_s"}``.  The
    default 128 MiB buffer is larger than the H100's 50 MB L2 cache.
    Without CUDA it raises: a CPU time is not a device ceiling.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the roofline probe times a CUDA buffer; no "
                           "CUDA device here")
    n = max(int(nbytes) // 4, 1024)
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    for _ in range(max(warmup, 1)):
        x = x + 1.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = x + 1.0
    end.record()
    end.synchronize()
    elapsed = start.elapsed_time(end) / 1e3
    moved_gb = 2.0 * n * 4 * iters / 1e9
    return {
        "memcpy_gb_s": moved_gb / max(elapsed, 1e-9),
        "bytes": float(n * 4),
        "iters": float(iters),
        "elapsed_s": elapsed,
    }


def roofline_fraction(achieved_gb_s: float, roofline_gb_s: float) -> float:
    """Achieved bandwidth as a fraction of the measured roofline."""
    return float(achieved_gb_s) / max(float(roofline_gb_s), 1e-9)


def peak_hbm_gb_s(measure_fallback: bool = False) -> Dict[str, object]:
    """Resolve the peak memory bandwidth WITH its provenance.

    Returns ``{"gb_s": float, "source": str}`` where source is one of
    ``env`` (``GLT_HBM_GBPS`` override), ``device_name:<name>`` (the
    datasheet table), ``measured_memcpy`` (opt-in small memcpy probe
    when the card is unknown), or ``default_h100_sxm``.
    """
    env = os.environ.get("GLT_HBM_GBPS")
    if env:
        try:
            return {"gb_s": float(env), "source": "env"}
        except ValueError:
            pass
    name = None
    try:
        import torch
        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — resolution must never raise
        name = None
    if name:
        canon = str(name).lower().replace(" ", "")
        for sub, gb_s in DEVICE_HBM_GB_S:
            if sub in canon:
                return {"gb_s": gb_s, "source": f"device_name:{name}"}
        if measure_fallback:
            try:
                probe = measure_memcpy_roofline(nbytes=1 << 24, iters=4)
                return {"gb_s": probe["memcpy_gb_s"],
                        "source": "measured_memcpy"}
            except Exception:  # noqa: BLE001
                pass
    return {"gb_s": DEFAULT_HBM_GB_S, "source": "default_h100_sxm"}
