"""The port's refresh driver and node_subgraph against glt_tpu's, on the
CPU.

``node_subgraph`` and ``relabel_by_reference`` compare with ==.  A small
graph's refreshed stores, with GraphSAGE weights carried across by
``params_from_flax``, agree with JAX's within 1e-5 of the output scale
(f32 matmuls sum in another order in XLA and in torch) for raw and int8
input stores; bf16 output stores within 2^-7 (a last-bit difference
before the bf16 rounding can move a value by one bf16 step).  Against a
numpy sweep the mean layer is exact to 1e-5.  A driver given the state
of one interrupted by an ``on_sweep`` error resumes and publishes
bit-identical stores.
"""
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.ops.subgraph import node_subgraph as jax_subgraph
from glt_tpu.ops.unique import relabel_by_reference as jax_relabel
from glt_tpu.refresh import RefreshDriver as JaxDriver
from glt_tpu.refresh import sage_refresh_layers as jax_layers
from glt_tpu.store import DiskFeatureStore as JaxStore
from glt_tpu.store import write_feature_store as jax_write
from glt_tpu_torch.models import GraphSAGE, params_from_flax
from glt_tpu_torch.ops import node_subgraph, relabel_by_reference
from glt_tpu_torch.refresh import RefreshDriver, sage_refresh_layers
from glt_tpu_torch.store import DiskFeatureStore, write_feature_store

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, D, MAXDEG = 300, 64, 16


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 12, N)
    indptr = np.zeros(N + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, N, indptr[-1]).astype(np.int64)
    feats = rng.standard_normal((N, D)).astype(np.float32)
    return indptr, indices, feats


@pytest.fixture(scope="module")
def sage(graph):
    """The flax GraphSAGE of tests/test_refresh.py and its port twin."""
    from glt_tpu.models.sage import GraphSAGE as JaxSAGE

    _, _, feats = graph
    model = JaxSAGE(hidden_features=32, out_features=16, num_layers=2,
                    dtype=jnp.float32)
    ei = jnp.zeros((2, 1), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(feats[:2]), ei,
                        jnp.ones(1, bool))
    twin = GraphSAGE(D, 32, 16, num_layers=2)
    twin.load_state_dict(params_from_flax(params))
    return jax_layers(model, params), sage_refresh_layers(twin.eval())


def _sha(root):
    with open(os.path.join(root, "features.bin"), "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.mark.parametrize("max_degree", [4, 16])
def test_node_subgraph_equals_jax(graph, max_degree):
    indptr, indices, _ = graph
    rng = np.random.default_rng(1)
    nodes = np.full(80, -1, np.int32)
    nodes[:60] = rng.permutation(N)[:60]
    ref = jax_subgraph(jnp.asarray(indptr, jnp.int32),
                       jnp.asarray(indices, jnp.int32), jnp.asarray(nodes),
                       max_degree)
    got = node_subgraph(torch.from_numpy(indptr.astype(np.int32)),
                        torch.from_numpy(indices.astype(np.int32)),
                        torch.from_numpy(nodes), max_degree)
    for f in ("rows", "cols", "eids", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    q = rng.integers(-1, N, 200).astype(np.int32)
    np.testing.assert_array_equal(
        relabel_by_reference(torch.from_numpy(nodes),
                             torch.from_numpy(q)).numpy(),
        np.asarray(jax_relabel(jnp.asarray(nodes), jnp.asarray(q))))


@pytest.mark.parametrize("block_size", [7, 64, 300])
def test_frontier_equals_jax(graph, tmp_path, block_size):
    indptr, indices, feats = graph
    root = write_feature_store(str(tmp_path / "in"), feats)
    kw = dict(block_size=block_size, max_degree=MAXDEG)
    ours = RefreshDriver(indptr, indices, [], DiskFeatureStore(root),
                         str(tmp_path / "o"), device="cpu", **kw)
    theirs = JaxDriver(indptr, indices, [], JaxStore(root),
                       str(tmp_path / "o"), **kw)
    for sweep in range(ours.num_sweeps):
        got, want = ours.frontier(sweep), theirs._frontier(sweep)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


def _run_both(graph, layers, tmp_path, codec, out_codec):
    indptr, indices, feats = graph
    kw = dict(block_size=64, max_degree=MAXDEG, out_codec=out_codec,
              dram_budget_bytes=feats.nbytes // 8)
    jroot = jax_write(str(tmp_path / f"in_j_{codec}"), feats, codec=codec)
    troot = write_feature_store(str(tmp_path / f"in_t_{codec}"), feats,
                                codec=codec)
    jrep = JaxDriver(indptr, indices, layers[0], JaxStore(jroot),
                     str(tmp_path / "out_j"), **kw).run()
    trep = RefreshDriver(indptr, indices, layers[1], DiskFeatureStore(troot),
                         str(tmp_path / "out_t"), device="cpu", **kw).run()
    return jrep, trep


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_refresh_equals_jax(graph, sage, tmp_path, codec):
    jrep, trep = _run_both(graph, sage, tmp_path, codec, "raw")
    # The DRAM/disk split depends on when the asynchronous stage-ahead
    # lands, in both packages; the other totals are deterministic.
    for k in ("layers", "num_sweeps", "nodes", "bytes_from_hbm",
              "stage_errors"):
        assert trep[k] == jrep[k], k
    assert 0.0 <= trep["dram_hit_rate"] <= 1.0
    for layer in (0, 1):
        got = DiskFeatureStore(os.path.join(
            str(tmp_path / "out_t"), f"layer_{layer}")).read_rows(
                np.arange(N))
        want = JaxStore(os.path.join(
            str(tmp_path / "out_j"), f"layer_{layer}")).read_rows(
                np.arange(N))
        scale = max(float(np.abs(want).max()), 1e-9)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, layer


def test_refresh_bf16_out_codec(graph, sage, tmp_path):
    jrep, trep = _run_both(graph, sage, tmp_path, "raw", "bf16")
    out = DiskFeatureStore(trep["out_root"])
    assert out.codec == "bf16" and out.is_compressed
    got = out.read_rows(np.arange(N))
    from glt_tpu_torch.store import quant

    got = quant.decode(got, out.quant_spec())
    want = np.asarray(JaxStore(jrep["out_root"]).read_rows(np.arange(N)),
                      np.float32)
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)
    assert rel < 2.0**-7, rel


def test_mean_layer_matches_numpy(graph, tmp_path):
    """A hand-written mean layer against an explicit numpy sweep: pins
    the frontier construction and the neighbor -> owner direction."""
    indptr, indices, feats = graph

    def mean_layer(x, edge_index, edge_mask):
        src = edge_index[0].clamp(0, x.shape[0] - 1).long()
        dst = edge_index[1].clamp(0, x.shape[0] - 1).long()
        w = edge_mask.to(x.dtype)[:, None]
        summ = torch.zeros_like(x).index_add_(0, dst, x[src] * w)
        cnt = torch.zeros((x.shape[0], 1)).index_add_(0, dst, w)
        return x + summ / cnt.clamp(min=1.0)

    root = write_feature_store(str(tmp_path / "in"), feats)
    rep = RefreshDriver(indptr, indices, [mean_layer],
                        DiskFeatureStore(root), str(tmp_path / "out"),
                        block_size=64, max_degree=MAXDEG,
                        dram_budget_bytes=feats.nbytes // 4,
                        device="cpu").run()
    got = DiskFeatureStore(rep["out_root"]).read_rows(np.arange(N))
    want = np.empty_like(feats)
    for v in range(N):
        nb = indices[indptr[v]:indptr[v + 1]]
        agg = feats[nb].mean(0) if nb.size else np.zeros(D, np.float32)
        want[v] = feats[v] + agg
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert rep["stage_errors"] == 0 and rep["nodes"] == N


@pytest.mark.parametrize("at", [(0, 2), (1, 2)])
def test_resume_after_on_sweep_error_is_bit_identical(graph, sage,
                                                      tmp_path, at):
    indptr, indices, feats = graph
    layers = sage[1]
    root = write_feature_store(str(tmp_path / "in"), feats, codec="int8")
    kw = dict(block_size=64, max_degree=MAXDEG, device="cpu",
              dram_budget_bytes=feats.nbytes // 8)
    base = RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                         str(tmp_path / "a"), **kw).run()

    class Boom(Exception):
        pass

    def bomb(drv, layer, sweep):
        if (layer, sweep) == at:
            raise Boom

    first = RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                          str(tmp_path / "b"), on_sweep=bomb, **kw)
    with pytest.raises(Boom):
        first.run()
    assert first.state_dict() == {"layer": at[0], "sweep": at[1] + 1}
    # A fresh driver (a new process) resumes from the saved cursor.
    drv = RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                        str(tmp_path / "b"), **kw)
    drv.load_state_dict(first.state_dict())
    rep = drv.run()
    for layer in (0, 1):
        assert (_sha(os.path.join(str(tmp_path / "b"), f"layer_{layer}"))
                == _sha(os.path.join(str(tmp_path / "a"),
                                     f"layer_{layer}")))
    assert _sha(rep["out_root"]) == _sha(base["out_root"])
    # the resumed run redid only the sweeps after the cursor
    assert rep["nodes"] < base["nodes"]


def test_contract_errors(graph, tmp_path):
    indptr, indices, feats = graph
    root = write_feature_store(str(tmp_path / "in"), feats)
    with pytest.raises(ValueError, match="raw|bf16"):
        RefreshDriver(indptr, indices, [lambda x, e, m: x],
                      DiskFeatureStore(root), str(tmp_path / "o"),
                      out_codec="int8", device="cpu")
    with pytest.raises(ValueError, match="rows"):
        RefreshDriver(indptr[: N // 2 + 1], indices, [lambda x, e, m: x],
                      DiskFeatureStore(root), str(tmp_path / "o"),
                      device="cpu")


@pytest.mark.parametrize("at", [(0, 2), (1, 1)])
def test_resume_under_checkpointer_matches_straight_run(graph, sage,
                                                         tmp_path, at):
    """A refresh killed after sweep ``at`` under ``checkpointer=`` and
    resumed by a fresh driver (a new process) publishes rows within 1e-5
    of a refresh that ran straight through (bit-identical here), and
    redoes none of the checkpointed sweeps."""
    from glt_tpu_torch.ckpt import Checkpointer, latest_step

    indptr, indices, feats = graph
    layers = sage[1]
    root = write_feature_store(str(tmp_path / "in"), feats, codec="int8")
    kw = dict(block_size=64, max_degree=MAXDEG, device="cpu",
              dram_budget_bytes=feats.nbytes // 8)
    base = RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                         str(tmp_path / "a"), **kw).run()

    class Boom(Exception):
        pass

    def bomb(drv, layer, sweep):
        if (layer, sweep) == at:
            raise Boom

    ck_root = str(tmp_path / "ck")
    with pytest.raises(Boom):
        RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                      str(tmp_path / "b"), on_sweep=bomb,
                      checkpointer=Checkpointer(ck_root, every_n_steps=1,
                                                keep=2), **kw).run()
    drv = RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                        str(tmp_path / "b"), **kw)
    done = at[0] * drv.num_sweeps + at[1] + 1
    assert latest_step(ck_root) == done
    drv.checkpointer = Checkpointer(ck_root, every_n_steps=1, keep=2)
    rep = drv.run()
    assert rep["nodes"] == N * 2 - (at[0] * N + (at[1] + 1) * 64)
    want = DiskFeatureStore(base["out_root"]).read_rows(np.arange(N))
    got = DiskFeatureStore(rep["out_root"]).read_rows(np.arange(N))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert _sha(rep["out_root"]) == _sha(base["out_root"])
