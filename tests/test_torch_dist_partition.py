"""The port's per-rank partitioners against ``glt_tpu``'s (cf.
``tests/test_partition.py`` ``TestDistRandomPartitioner``), on the host.

``hash_partition`` is held ``==`` over 100,000 ids; each round trip runs
both packages' partitioners on the same rank chunks (arrays or table
slices through the reader protocol) into two directories, and every file
of the two on-disk layouts must be equal, array for array, with no spill
directory left behind.  The port's ``load_partition`` then reads each
partition as ``glt_tpu``'s does.
"""
import json
import os

import numpy as np
import pytest

from glt_tpu.partition import DistRandomPartitioner as JaxDistPartitioner
from glt_tpu.partition import \
    DistTableRandomPartitioner as JaxTablePartitioner
from glt_tpu.partition import hash_partition as jax_hash_partition
from glt_tpu.partition import load_partition as jax_load_partition
from glt_tpu_torch.partition import (DistRandomPartitioner,
                                     DistTableRandomPartitioner,
                                     hash_partition, load_partition)
from test_aux import ListTableReader


def ring(n):
    src = np.repeat(np.arange(n), 2)
    dst = np.concatenate([[(i + 1) % n, (i + 2) % n] for i in range(n)])
    return np.stack([src, dst])


def same_layout(a: str, b: str) -> int:
    """Every file under ``a`` equals the file of the same name under
    ``b`` (``.npy`` array for array, ``META.json`` as JSON); returns the
    files compared."""
    fa = sorted(os.path.relpath(os.path.join(d, f), a)
                for d, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(d, f), b)
                for d, _, fs in os.walk(b) for f in fs)
    assert fa == fb
    assert not any(f.startswith("_spill_rank") for f in fa)
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert json.load(open(pa)) == json.load(open(pb)), f
    return len(fa)


@pytest.mark.parametrize("num_parts,seed", [(8, 0), (3, 5), (2, 3), (7, 11)])
def test_hash_partition_equals_jax(num_parts, seed):
    ids = np.arange(100_000)
    got = hash_partition(ids, num_parts, seed)
    want = jax_hash_partition(ids, num_parts, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    big = np.random.default_rng(seed).integers(0, 1 << 62, 10_000)
    np.testing.assert_array_equal(hash_partition(big, num_parts, seed),
                                  jax_hash_partition(big, num_parts, seed))


def test_partition_exports_cover_glt_tpus():
    import glt_tpu.partition as jpart
    import glt_tpu_torch.partition as tpart

    assert set(tpart.__all__) == set(jpart.__all__)
    for name in tpart.__all__:
        assert hasattr(tpart, name), name


def test_hash_partition_balance():
    counts = np.bincount(hash_partition(np.arange(100000), 8, 0))
    assert counts.min() > 100000 / 8 * 0.9


@pytest.mark.parametrize("strategy", ["by_src", "by_dst"])
def test_two_rank_round_trip_equals_jax(tmp_path, strategy):
    n = 40
    ei = ring(n)
    eids = np.arange(ei.shape[1])
    feat = np.arange(n, dtype=np.float32)[:, None]
    half = ei.shape[1] // 2
    roots = {}
    for name, cls in (("jax", JaxDistPartitioner),
                      ("port", DistRandomPartitioner)):
        root = str(tmp_path / name)
        part = cls(root, 3, n, ei.shape[1], seed=5,
                   edge_assign_strategy=strategy)
        part.partition_rank_chunk(0, ei[:, :half], eids[:half],
                                  node_ids=np.arange(0, 20),
                                  node_feat=feat[:20])
        part.partition_rank_chunk(1, ei[:, half:], eids[half:],
                                  node_ids=np.arange(20, 40),
                                  node_feat=feat[20:])
        part.finalize()
        roots[name] = root
    assert same_layout(roots["port"], roots["jax"]) > 3 * 3
    np.testing.assert_array_equal(
        np.load(os.path.join(roots["port"], "node_pb.npy")),
        hash_partition(np.arange(n), 3, 5))
    all_nodes, all_edges = [], 0
    for p in range(3):
        graph, node_feat, _, npb, _, meta = load_partition(roots["port"], p)
        jgraph, jfeat, _, _, _, jmeta = jax_load_partition(roots["jax"], p)
        assert meta == jmeta
        np.testing.assert_array_equal(graph.edge_index, jgraph.edge_index)
        np.testing.assert_array_equal(node_feat.ids, jfeat.ids)
        anchor = graph.edge_index[0 if strategy == "by_src" else 1]
        assert (npb[anchor] == p).all()
        np.testing.assert_array_equal(node_feat.feats[:, 0], node_feat.ids)
        all_nodes.extend(node_feat.ids.tolist())
        all_edges += graph.eids.shape[0]
    assert sorted(all_nodes) == list(range(n))
    assert all_edges == ei.shape[1]


def test_finalize_refuses_uncovered_edges_as_jax(tmp_path):
    ei = ring(10)
    msgs = []
    for name, cls in (("jax", JaxDistPartitioner),
                      ("port", DistRandomPartitioner)):
        part = cls(str(tmp_path / name), 2, 10, ei.shape[1])
        part.partition_rank_chunk(0, ei[:, :12], np.arange(12))
        with pytest.raises(RuntimeError) as e:
            part.finalize(with_node_feat=False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "8 of 20" in msgs[1]


def _tables(n, ei, feat_str):
    return {
        "edges_r0": list(zip(ei[0, :30].tolist(), ei[1, :30].tolist())),
        "edges_r1": list(zip(ei[0, 30:].tolist(), ei[1, 30:].tolist())),
        "nodes_r0": [(i, feat_str[i]) for i in range(15)],
        "nodes_r1": [(i, feat_str[i].encode()) for i in range(15, n)],
    }


def test_table_fed_round_trip_equals_jax(tmp_path):
    n = 30
    ei = ring(n)
    tables = _tables(n, ei, [f"{i}.0:{2 * i}.0" for i in range(n)])
    roots = {}
    for name, cls in (("jax", JaxTablePartitioner),
                      ("port", DistTableRandomPartitioner)):
        factory = lambda t: ListTableReader(tables[t], batch_limit=7)
        part = cls(str(tmp_path / name), 2, n, ei.shape[1], seed=3)
        got = part.partition_rank_tables(0, "edges_r0", "nodes_r0",
                                         reader_factory=factory,
                                         edge_id_offset=0,
                                         reader_batch_size=8)
        assert got == 30
        part.partition_rank_tables(1, "edges_r1", "nodes_r1",
                                   reader_factory=factory,
                                   edge_id_offset=got, reader_batch_size=8)
        part.finalize()
        roots[name] = str(tmp_path / name)
    same_layout(roots["port"], roots["jax"])
    for p in range(2):
        graph, node_feat, _, npb, _, _ = load_partition(roots["port"], p)
        assert (npb[graph.edge_index[0]] == p).all()
        np.testing.assert_array_equal(node_feat.feats[:, 1],
                                      2 * node_feat.ids)


def test_table_fed_empty_node_slice_equals_jax(tmp_path):
    n = 10
    ei = ring(n)
    tables = {
        "e0": list(zip(ei[0, :10].tolist(), ei[1, :10].tolist())),
        "e1": list(zip(ei[0, 10:].tolist(), ei[1, 10:].tolist())),
        "v0": [(i, f"{i}.0") for i in range(n)],
        "v1": [],
    }
    for name, cls in (("jax", JaxTablePartitioner),
                      ("port", DistTableRandomPartitioner)):
        factory = lambda t: ListTableReader(tables[t])
        part = cls(str(tmp_path / name), 2, n, ei.shape[1])
        got = part.partition_rank_tables(0, "e0", "v0",
                                         reader_factory=factory)
        part.partition_rank_tables(1, "e1", "v1", reader_factory=factory,
                                   edge_id_offset=got)
        part.finalize()
    same_layout(str(tmp_path / "port"), str(tmp_path / "jax"))
    ids = []
    for p in range(2):
        ids.extend(load_partition(str(tmp_path / "port"), p)[1].ids.tolist())
    assert sorted(ids) == list(range(n))
