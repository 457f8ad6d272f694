"""Per-stage cost attribution: expected-bytes models -> roofline table
(cf. ``glt_tpu/obs/attrib.py``; the byte models are copies).

This module gives every pipeline stage (sample /
dedup / gather / train) an **expected-bytes model**: the bytes the
stage must move if it did no redundant work.  Dividing by measured
stage time yields an achieved bandwidth, and dividing THAT by the
measured memcpy ceiling (:mod:`.roofline`) yields a comparable
``{stage}_roofline_frac`` — the fraction of the machine the stage
actually uses.

Byte models are intentionally FLOORS (useful bytes, not implementation
traffic): a fraction above 1.0 is impossible, a fraction far below 1.0
means the stage is latency- or compute-bound — exactly the signal that
picks the next optimization target.

Module-level code is stdlib-only, so pure-host tooling can import the
models.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

STAGES: Tuple[str, ...] = ("sample", "dedup", "gather", "train")


def sample_expected_bytes(batch_size: int, fanouts: Sequence[int],
                          index_bytes: int = 4) -> int:
    """Bytes a fanout neighbor-sampling pass must touch.

    Per hop, each frontier node reads its CSR degree (two ``indptr``
    entries) and ``fanout`` neighbor ids from ``indices``, and writes
    the sampled node + edge ids.  Frontier sizes are the no-dedup
    expansion ``batch * prod(fanouts[:i])`` — the worst case the padded
    capacities are sized for.
    """
    batch_size = int(batch_size)
    total = batch_size * index_bytes            # seed ids read
    frontier = batch_size
    for f in fanouts:
        total += frontier * 2 * index_bytes     # indptr bounds
        total += frontier * int(f) * index_bytes  # neighbor ids read
        total += frontier * int(f) * 2 * index_bytes  # node + edge out
        frontier *= int(f)
    return total


def dedup_expected_bytes(num_ids: int, index_bytes: int = 4,
                         passes: int = 4) -> int:
    """Bytes for the unique-first-occurrence pass over ``num_ids`` ids.

    A sort-based unique reads and writes the id vector ~``passes``
    times (sort + segment marks + scatter of the inverse map).
    """
    return int(num_ids) * index_bytes * int(passes)


def gather_expected_bytes(rows: int, dim: int, itemsize: int = 4) -> int:
    """Payload bytes of a feature gather: the useful rows the model
    consumes (the numerator every ``gather_gb_s`` variant shares)."""
    return int(rows) * int(dim) * int(itemsize)


def train_expected_bytes(param_bytes: int, batch_feature_bytes: int
                         ) -> int:
    """Analytic floor for one optimizer step: parameters are read by
    the forward pass, their gradients written and read, and the adam
    moments read+written (~5x params), plus the batch features read
    twice (forward + backward recompute/use)."""
    return 5 * int(param_bytes) + 2 * int(batch_feature_bytes)


def param_nbytes(params) -> int:
    """Total bytes of a model's parameters: an ``nn.Module`` (its
    ``parameters()``) or a state dict (its tensor values)."""
    tensors = (params.values() if isinstance(params, dict)
               else params.parameters())
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if hasattr(t, "element_size")))


def compiled_cost_bytes(fn, *args) -> Optional[float]:
    """Always None: the compiler's own byte count is not available.

    ``glt_tpu`` reads ``bytes accessed`` from XLA's cost analysis of a
    jitted function.  Eager PyTorch and a captured CUDA graph have no
    such analysis, so callers use the analytic models above; the
    signature stays for callers written against either package.
    """
    return None


def stage_roofline_table(stage_ms: Mapping[str, float],
                         stage_bytes: Mapping[str, float],
                         memcpy_gb_s: float) -> Dict[str, dict]:
    """Fold per-stage times + expected bytes into the roofline table.

    Returns ``{stage: {"ms", "gb", "gb_s", "roofline_frac"}}`` for
    stages present in BOTH mappings (an unmeasured stage is omitted,
    never emitted as a sentinel — the ``prune_unmeasured`` contract).
    """
    table: Dict[str, dict] = {}
    for stage in stage_ms:
        ms = stage_ms[stage]
        nbytes = stage_bytes.get(stage)
        if nbytes is None or ms is None or ms <= 0 or nbytes <= 0:
            continue
        gb = float(nbytes) / 1e9
        gb_s = gb / (float(ms) / 1e3)
        frac = gb_s / memcpy_gb_s if memcpy_gb_s > 0 else 0.0
        table[stage] = {
            "ms": round(float(ms), 3),
            "gb": round(gb, 6),
            "gb_s": round(gb_s, 3),
            "roofline_frac": round(frac, 4),
        }
    return table


def flat_roofline_fracs(table: Mapping[str, dict],
                        skip: Sequence[str] = ()) -> Dict[str, float]:
    """``{stage}_roofline_frac`` keys for a benchmark's JSON line
    (``skip`` keeps pre-existing headline keys authoritative)."""
    return {f"{stage}_roofline_frac": row["roofline_frac"]
            for stage, row in table.items() if stage not in skip}
