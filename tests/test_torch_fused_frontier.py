"""glt_tpu_torch.ops.fused_frontier against glt_tpu's, on the CPU.

The port's CPU route (kernel B3's plain version) against
``glt_tpu``'s ``fused_frontier(..., force="xla")``: unique ids, inverse
and features compare with == (bf16 by bits).  The kernel itself is held
against the plain version on the card in ``test_torch_kernels.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu.ops.fused_frontier import fused_frontier as jax_fused
from glt_tpu_torch.ops import (
    dedup_gather_rows,
    fused_frontier,
    fused_frontier_cuda,
    fused_frontier_plain,
    fused_frontier_supported,
)
from glt_tpu_torch.store.quant import encode, raw_spec

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _ids(kind, n, b, rng):
    if kind == "duplicates":
        ids = rng.integers(0, 6, b)
        ids[rng.random(b) < 0.2] = -1
    elif kind == "all_padding":
        ids = np.full(b, -1)
    elif kind == "all_unique":
        ids = rng.permutation(n)[:b]
    else:                                   # mixed, ids past N clamp
        ids = rng.integers(-2, n + 3, b)
    return ids.astype(np.int32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("d", [64, 100, 128])
@pytest.mark.parametrize("kind", ["duplicates", "all_padding", "all_unique",
                                  "mixed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_id2index", [False, True])
def test_fused_frontier_matches_jax(d, kind, dtype, with_id2index):
    rng = np.random.default_rng(d)
    n, b = 97, 61
    table = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bf16":
        table = table.astype(ml_dtypes.bfloat16)
    ids = _ids(kind, n, b, rng)
    perm = rng.permutation(n).astype(np.int32) if with_id2index else None
    ref = jax_fused(jnp.asarray(table), jnp.asarray(ids),
                    id2index=None if perm is None else jnp.asarray(perm),
                    force="xla")
    tt = (torch.from_numpy(table.view(np.int16)).view(torch.bfloat16)
          if dtype == "bf16" else torch.from_numpy(table))
    before = fused_frontier_cuda.launches
    got = fused_frontier(tt, torch.from_numpy(ids),
                         id2index=None if perm is None
                         else torch.from_numpy(perm))
    assert fused_frontier_cuda.launches == before   # CPU: plain version
    np.testing.assert_array_equal(got.unique_ids.numpy(),
                                  np.asarray(ref.unique_ids))
    np.testing.assert_array_equal(got.inverse.numpy(),
                                  np.asarray(ref.inverse))
    assert got.features.dtype == tt.dtype
    feats = (got.features.view(torch.int16) if dtype == "bf16"
             else got.features).numpy()
    np.testing.assert_array_equal(feats, _bits(ref.features))
    # The same bits as the port's own dedup gather.
    assert torch.equal(got.features, dedup_gather_rows(
        tt, torch.from_numpy(ids),
        id2index=None if perm is None else torch.from_numpy(perm)))


def test_seam_and_gate():
    table = torch.randn(10, 3)
    uidx = torch.tensor([4, 2, 0, 0], dtype=torch.int32)
    inv = torch.tensor([0, 1, 0, -1], dtype=torch.int32)
    want = torch.stack([table[4], table[2], table[4], torch.zeros(3)])
    assert torch.equal(fused_frontier_plain(table, uidx, inv), want)
    with pytest.raises(ValueError, match="CUDA"):
        fused_frontier_cuda(table, uidx, inv)
    # dequant= is ported (kernel B5): a raw spec is the raw gather, a
    # compressed one decodes to f32 (held to glt_tpu in
    # test_torch_feature_tiers.py).
    ids = torch.tensor([4, 2, 4, -1], dtype=torch.int32)
    assert torch.equal(
        fused_frontier(table, ids, dequant=raw_spec(np.float32)).features,
        want)
    enc, spec = encode(table.numpy(), "int8")
    got = fused_frontier(torch.from_numpy(enc), ids, dequant=spec).features
    assert got.dtype == torch.float32 and torch.equal(got[3], torch.zeros(3))
    assert fused_frontier_supported(table)
    assert fused_frontier_supported(table.to(torch.bfloat16))
    assert fused_frontier_supported(table.to(torch.int8))
    assert not fused_frontier_supported(table.to(torch.float16))
    assert not fused_frontier_supported(table[0])
