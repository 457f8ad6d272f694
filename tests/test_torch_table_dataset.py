"""Table ingestion and the vineyard connector against ``glt_tpu``'s (cf.
``tests/test_aux.py`` ``TestTableDataset`` and ``TestVineyardConnector``),
and the twin of ``examples/table_dataset_train.py``, on the CPU.

Each dataset is built by both packages from the same records (or the
same fragment) and compared: CSR arrays, every node's feature row and
every label with ``==``; the port's loader runs over it.  The table
twin's first steps, from the JAX example's weights carried across by
``params_from_flax``, give its losses, accuracies and parameters within
1e-5 (f32 math in another order), dropout off on both sides as in
``tests/test_torch_examples.py`` (flax and the port draw their masks
differently).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples import table_dataset_train as jax_twin
from glt_tpu.data import table_dataset as jtd
from glt_tpu.data import vineyard as jvy
from glt_tpu.loader import NeighborLoader as JaxLoader
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models import train as jtrain
from glt_tpu_torch.data import (ArrowFragmentAdapter, MockFragment,
                                TableDataset, fragment_to_dataset,
                                load_edge_features, load_vertex_features,
                                to_csr)
from glt_tpu_torch.data import table_dataset as ttd
from glt_tpu_torch.examples import table_dataset_train as twin
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import make_train_step, params_from_flax
from test_aux import ListTableReader

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def same_topo(t, j):
    for f in ("indptr", "indices", "edge_ids"):
        a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(a, b, err_msg=f)


def same_dataset(tds, jds, ntype=None):
    """Graphs, every feature row and the labels of two datasets equal."""
    if isinstance(jds.graph, dict):
        assert sorted(tds.graph) == sorted(jds.graph)
        for et in jds.graph:
            same_topo(tds.graph[et].topo, jds.graph[et].topo)
    else:
        same_topo(tds.get_graph().topo, jds.get_graph().topo)
    types = [None] if ntype is None else ntype
    for t in types:
        jf, tf = jds.get_node_feature(t), tds.get_node_feature(t)
        n = jf.shape[0]
        assert tuple(tf.shape) == tuple(jf.shape)
        np.testing.assert_array_equal(
            tf.gather(torch.arange(n)).numpy(),
            np.asarray(jf.gather(jnp.arange(n))))
        jl, tl = jds.get_node_label(t), tds.get_node_label(t)
        assert (jl is None) == (tl is None)
        if jl is not None:
            assert np.asarray(tl).dtype == np.asarray(jl).dtype
            np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))


def _records(n=12):
    edges = [(i, (i + 1) % n) for i in range(n)]
    nodes = [(i, f"{float(i)}:{float(2 * i)}:{float(i % 3)}")
             for i in np.random.default_rng(0).permutation(n)]
    return {"e": edges, "v": [(i, s.encode()) for i, s in nodes]}


class TestTableDataset:
    def test_from_tables_homo_with_labels(self):
        n = 12
        tables = _records(n)
        readers = []

        def factory(name):
            r = ListTableReader(tables[name], batch_limit=4)
            readers.append(r)
            return r

        kw = dict(reader_factory=factory, label_from_last_column=True,
                  reader_batch_size=5)
        ds = TableDataset.from_tables({"edge": "e"}, {"node": "v"},
                                      device="cpu", **kw)
        jds = jtd.TableDataset.from_tables({"edge": "e"}, {"node": "v"},
                                           graph_mode="HOST", **kw)
        assert readers and all(r.closed for r in readers)
        assert isinstance(ds, TableDataset) and ds.device.type == "cpu"
        same_dataset(ds, jds)
        np.testing.assert_array_equal(ds.node_labels, np.arange(n) % 3)
        for batch in NeighborLoader(ds, [2], np.arange(n), batch_size=4):
            mask = batch.node_mask.numpy()
            x, node = batch.x.numpy()[mask], batch.node.numpy()[mask]
            np.testing.assert_allclose(x[:, 0], node)
            np.testing.assert_allclose(x[:, 1], 2 * node)

    def test_from_tables_needs_reader(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "common_io", None)
        with pytest.raises(ImportError, match="reader_factory") as te:
            TableDataset.from_tables({"e": "t1"}, {"v": "t2"}, device="cpu")
        with pytest.raises(ImportError) as je:
            jtd.TableDataset.from_tables({"e": "t1"}, {"v": "t2"})
        assert str(te.value) == str(je.value)

    def test_from_tables_hetero_arity_mismatch(self):
        for td, kw in ((ttd, {"device": "cpu"}), (jtd, {})):
            with pytest.raises(ValueError, match="hetero"):
                td.TableDataset.from_tables(
                    {"e": "t1"}, {"u": "t2", "i": "t3"},
                    reader_factory=lambda t: ListTableReader([(0, 1)]), **kw)

    def test_from_tables_gapped_ids(self):
        tables = {"e": [(0, 2), (2, 4), (4, 0)],
                  "v": [(0, "1.0"), (2, "3.0"), (4, "5.0")]}
        kw = dict(reader_factory=lambda t: ListTableReader(tables[t]))
        ds = TableDataset.from_tables({"edge": "e"}, {"node": "v"},
                                      device="cpu", **kw)
        jds = jtd.TableDataset.from_tables({"edge": "e"}, {"node": "v"},
                                           graph_mode="HOST", **kw)
        same_dataset(ds, jds)
        x = ds.get_node_feature().gather(torch.tensor([0, 2, 4, 1]))
        np.testing.assert_allclose(x[:, 0].numpy(), [1.0, 3.0, 5.0, 0.0])

    def test_from_tables_hetero(self):
        ui, iu = ("user", "clicks", "item"), ("item", "rev", "user")
        tables = {"ui": [(u, u % 3) for u in range(6)],
                  "iu": [(u % 3, u) for u in range(6)],
                  "user": [(u, f"{u}.0:1.0:{u % 2}") for u in range(6)],
                  "item": [(i, f"{-i}.0:2.0:{i % 2}") for i in range(3)]}
        kw = dict(reader_factory=lambda t: ListTableReader(tables[t]),
                  label_from_last_column=True,
                  num_nodes={"user": 6, "item": 3})
        et, nt = {ui: "ui", iu: "iu"}, {"user": "user", "item": "item"}
        ds = TableDataset.from_tables(et, nt, device="cpu", **kw)
        jds = jtd.TableDataset.from_tables(et, nt, graph_mode="HOST", **kw)
        same_dataset(ds, jds, ntype=["user", "item"])

    def test_from_arrays(self):
        rng = np.random.default_rng(4)
        src, dst = rng.integers(0, 20, 60), rng.integers(0, 20, 60)
        ids = rng.permutation(25)[:20]
        feat = rng.standard_normal((20, 5)).astype(np.float32)
        lab = rng.integers(0, 4, 20)
        ds = TableDataset.from_arrays(src, dst, ids, feat, lab, device="cpu")
        jds = jtd.TableDataset.from_arrays(src, dst, ids, feat, lab,
                                           graph_mode="HOST")
        same_dataset(ds, jds)
        plain = TableDataset.from_arrays(src, dst, device="cpu")
        same_topo(plain.get_graph().topo,
                  jtd.TableDataset.from_arrays(src, dst).get_graph().topo)

    def test_from_odps_and_default_device(self, monkeypatch):
        tables = _records()
        kw = dict(reader_factory=lambda t: ListTableReader(tables[t]),
                  label_from_last_column=True)
        ds = TableDataset.from_odps("e", "v", device="cpu", **kw)
        same_dataset(ds, jtd.TableDataset.from_odps(
            "e", "v", graph_mode="HOST", **kw))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TableDataset.from_odps("e", "v", **kw)

    def test_reader_helpers_equal_jax(self):
        recs = [(i, i + 1) for i in range(23)]
        got = ttd.drain_table("t", lambda t: ListTableReader(recs, 5),
                              (StopIteration,), batch_size=7)
        want = jtd.drain_table("t", lambda t: ListTableReader(recs, 5),
                               (StopIteration,), batch_size=7)
        assert got == want == recs
        for f in ("1.5:-2:3e-3", b"0.25:4"):
            assert ttd.parse_feature_field(f) == jtd.parse_feature_field(f)
        fac = lambda t: None                           # noqa: E731
        assert ttd.resolve_reader_factory(fac)[0] is fac


def _fragment(pkg):
    n = 8
    dst = np.concatenate([[(i + 1) % n, (i + 2) % n] for i in range(n)])
    frag = pkg.MockFragment(
        np.arange(n + 1) * 2, dst, edge_ids=np.arange(2 * n) * 10,
        vertex_cols={"feat": np.arange(n, dtype=np.float32)[:, None]
                     * np.ones((1, 3), np.float32),
                     "label": np.arange(n) % 2},
        edge_cols={"w": np.ones(2 * n, np.float32)})
    return frag, n


class TestVineyardConnector:
    def test_to_csr_and_features(self):
        frag, n = _fragment(sys.modules["glt_tpu_torch.data.vineyard"])
        jfrag, _ = _fragment(jvy)
        assert isinstance(frag, MockFragment)
        same_topo(to_csr(frag), jvy.to_csr(jfrag))
        np.testing.assert_array_equal(to_csr(frag).edge_ids,
                                      np.arange(2 * n) * 10)
        for cols in (["feat"], None, ["label", "feat"]):
            x = load_vertex_features(frag, columns=cols)
            assert x.dtype == np.float32
            np.testing.assert_array_equal(
                x, jvy.load_vertex_features(jfrag, columns=cols))
        np.testing.assert_array_equal(
            load_edge_features(frag, columns=["w"]),
            jvy.load_edge_features(jfrag, columns=["w"]))
        with pytest.raises(KeyError, match="nope"):
            load_vertex_features(frag, columns=["nope"])

    def test_fragment_to_dataset_samples(self):
        frag, n = _fragment(sys.modules["glt_tpu_torch.data.vineyard"])
        ds = fragment_to_dataset(frag, feature_columns=["feat"],
                                 label_column="label", device="cpu")
        jds = jvy.fragment_to_dataset(_fragment(jvy)[0],
                                      feature_columns=["feat"],
                                      label_column="label",
                                      graph_mode="HOST")
        same_dataset(ds, jds)
        for batch in NeighborLoader(ds, [2], np.arange(n), batch_size=4):
            mask = batch.node_mask.numpy()
            node = batch.node.numpy()[mask]
            np.testing.assert_allclose(batch.x.numpy()[mask][:, 0], node)
            np.testing.assert_array_equal(batch.y.numpy()[mask], node % 2)

    def test_arrow_fragment_adapter(self):
        n = 6
        indptr = np.arange(n + 1) * 2
        dst = np.concatenate([[(i + 1) % n, (i + 2) % n] for i in range(n)])

        class _Vid:
            def __init__(self, v): self._v = v
            def GetValue(self): return self._v

        class _Entry:
            def __init__(self, nbr, eid): self._n, self._e = nbr, eid
            def get_neighbor(self): return _Vid(self._n)
            def edge_id(self): return self._e

        class _Chunked:
            def __init__(self, arr):
                a = np.asarray(arr)
                h = a.shape[0] // 2
                self._chunks = [a[:h], a[h:]]
            @property
            def num_chunks(self): return len(self._chunks)
            def chunk(self, i): return self._chunks[i]

        class _Table:
            def __init__(self, cols): self._c = cols
            def ColumnNames(self): return list(self._c)
            def GetColumnByName(self, name): return _Chunked(self._c[name])

        class _Frag:
            def GetOutgoingOffsetArray(self, v_label, e_label):
                return indptr
            def GetOutgoingOffsetLength(self, v_label, e_label):
                return n + 1
            def InnerVertices(self, v_label):
                return range(n)
            def GetOutgoingAdjList(self, v, e_label):
                return [_Entry(dst[2 * v + k], (2 * v + k) * 10)
                        for k in range(2)]
            def vertex_data_table(self, v_label):
                return _Table({"feat": np.arange(n, dtype=np.float32),
                               "label": np.arange(n) % 2})
            def edge_data_table(self, e_label):
                return _Table({"w": np.ones(2 * n, np.float32)})

        frag, jfrag = ArrowFragmentAdapter(_Frag()), \
            jvy.ArrowFragmentAdapter(_Frag())
        same_topo(to_csr(frag), jvy.to_csr(jfrag))
        np.testing.assert_array_equal(to_csr(frag).indices, dst)
        np.testing.assert_array_equal(
            load_vertex_features(frag, columns=["feat"]),
            jvy.load_vertex_features(jfrag, columns=["feat"]))
        np.testing.assert_array_equal(
            load_edge_features(frag), jvy.load_edge_features(jfrag))
        ds = fragment_to_dataset(frag, feature_columns=["feat"],
                                 label_column="label", device="cpu")
        same_dataset(ds, jvy.fragment_to_dataset(
            jfrag, feature_columns=["feat"], label_column="label",
            graph_mode="HOST"))

    def test_vineyard_stays_gated(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "vineyard", None)
        vy = sys.modules["glt_tpu_torch.data.vineyard"]
        with pytest.raises(ImportError) as te:
            to_csr("/tmp/vineyard.sock", object_id=1)
        with pytest.raises(ImportError) as je:
            jvy.to_csr("/tmp/vineyard.sock", object_id=1)
        assert str(te.value) == str(je.value)
        with pytest.raises(ImportError):
            vy.connect_fragment("/tmp/vineyard.sock", 1)


# ---------------------------------------------------------------------------
# The table twin
# ---------------------------------------------------------------------------

def test_table_twin_synthetic_tables_equal_jax():
    got, gc = twin.synthetic_tables()
    want, wc = jax_twin.synthetic_tables()
    assert gc == wc == 6 and got == want
    assert len(got["edges"]) == 16000 and len(got["nodes"]) == 2000


def test_table_twin_first_steps_match_jax():
    """Four batches through both examples' calls from the same weights,
    dropout off: loss, accuracy and the parameters within 1e-5."""
    tables, classes = jax_twin.synthetic_tables()
    jds = jtd.TableDataset.from_tables(
        {"edge": "edges"}, {"node": "nodes"},
        reader_factory=lambda name: jax_twin.ListTableReader(tables[name]),
        graph_mode="DEVICE", label_from_last_column=True,
        reader_batch_size=256)
    n = jds.get_graph().num_nodes
    jloader = JaxLoader(jds, [5, 5], np.arange(n), batch_size=twin.BATCH,
                        shuffle=True, seed=0)
    jm = JaxSAGE(hidden_features=twin.HIDDEN, out_features=classes,
                 dropout_rate=0.0)
    tx = optax.adam(twin.LR)
    first = next(iter(jloader))
    jstate = jtrain.create_train_state(jm, jax.random.PRNGKey(0), first, tx)
    jstep = jtrain.make_train_step(jm, tx, batch_size=twin.BATCH)

    ds, loader, state = twin.build(twin.parse_args(["--device", "cpu"]))
    state.model.dropout_rate = 0.0
    same_dataset(ds, jds)
    state.model.load_state_dict(params_from_flax(jstate.params))
    step = make_train_step(twin.BATCH)
    for i, (jb, tb) in enumerate(zip(jloader, loader)):
        if i == 4:
            break
        np.testing.assert_array_equal(tb.node.numpy(), np.asarray(jb.node))
        jstate, jl, ja = jstep(jstate, jb)
        state, tl, ta = step(state, tb)
        _close(float(tl), float(jl), f"batch {i} loss")
        _close(float(ta), float(ja), f"batch {i} acc")
    assert state.step == int(jstate.step) == 4
    want = params_from_flax(jstate.params)
    for k, v in state.model.state_dict().items():
        _close(v.numpy(), want[k].numpy(), k)


def test_table_twin_main_trains_on_cpu():
    state, history = twin.main(["--device", "cpu", "--epochs", "2"])
    assert state.step == sum(len(h) for h in history) == 2 * 16
    assert all(np.isfinite(h).all() for h in history)
    assert np.mean(history[-1]) < np.mean(history[0])
