"""glt_tpu_torch.store (disk store, writer, DRAM stager) against
glt_tpu.store, on the CPU.

Stores cross-open between the packages with equal sha256 and equal rows
(==); the publish, overwrite, truncation and bit-rot contracts and the
writer's reattach hold; the stager's counters equal ``glt_tpu``'s over
the same gather sequence, and its chaos contract holds under a
duck-typed fault hook (a stall degrades to demand reads, a failed
staging read is counted, a failed demand read raises).
"""
import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu.store import DiskFeatureStore as JaxStore
from glt_tpu.store import DramStager as JaxStager
from glt_tpu.store import StoreCorruptError as JaxCorruptError
from glt_tpu.store import FeatureStoreWriter as JaxWriter
from glt_tpu.store import write_feature_store as jax_write
from glt_tpu_torch.store import (
    DATA_NAME,
    MANIFEST_NAME,
    DiskFeatureStore,
    DramStager,
    FeatureStoreWriter,
    StoreCorruptError,
    StoreError,
    quant,
    write_feature_store,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


class Faults:
    """Duck-typed fault hook: fail or stall the n-th chunk read."""

    def __init__(self, fail_at=None, delay_at=(), delay_s=0.0):
        self.fail_at, self.delay_at, self.delay_s = fail_at, delay_at, delay_s
        self.reads = self.failures = self.delays = 0
        self._lock = threading.Lock()

    def on_disk_read(self):
        with self._lock:
            self.reads += 1
            n = self.reads
        if n == self.fail_at:
            self.failures += 1
            raise OSError(f"fault injection: disk read {n}")
        if n in self.delay_at:
            self.delays += 1
            time.sleep(self.delay_s)


def _rows(n=64, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _sha(root):
    with open(os.path.join(root, DATA_NAME), "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _as_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
def test_stores_cross_open_with_equal_sha(tmp_path, codec):
    x = _rows(97, 13)
    x[:, 2] = 0.5                                       # a constant column
    jroot = jax_write(str(tmp_path / "j"), x, codec=codec)
    troot = write_feature_store(str(tmp_path / "t"), x, codec=codec)
    assert _sha(jroot) == _sha(troot)
    with open(os.path.join(jroot, MANIFEST_NAME)) as fh:
        man_j = json.load(fh)
    with open(os.path.join(troot, MANIFEST_NAME)) as fh:
        man_t = json.load(fh)
    assert man_j == man_t
    ids = np.array([0, 96, 5, -1, 5, 40])
    for ours, theirs in ((DiskFeatureStore(jroot), JaxStore(troot)),
                         (DiskFeatureStore(troot), JaxStore(jroot))):
        assert ours.codec == theirs.codec == codec
        assert ours.sha256 == theirs.sha256
        ours.verify()
        theirs.verify()
        np.testing.assert_array_equal(ours.read_rows(ids),
                                      _as_bits(theirs.read_rows(ids)))
        decoded = quant.decode(ours.read_rows(ids), ours.quant_spec())
        from glt_tpu.store import quant as jq
        want = jq.decode(theirs.read_rows(ids), theirs.quant_spec())
        np.testing.assert_array_equal(decoded.view(np.uint32),
                                      np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
def test_write_read_roundtrip(tmp_path, codec):
    x = _rows()
    root = write_feature_store(str(tmp_path / "s"), x, codec=codec)
    st = DiskFeatureStore(root)
    assert st.shape == x.shape and st.logical_dtype == np.float32
    assert st.is_compressed == (codec != "raw")
    enc, spec = quant.encode(x, codec)
    np.testing.assert_array_equal(st.read_rows(np.arange(64)), enc)
    st = DiskFeatureStore(root)
    got = st.read_rows(np.array([3, -1, 7]))
    np.testing.assert_array_equal(got[1], 0)
    assert st.bytes_read == 2 * st.row_nbytes and st.chunk_reads == 1


def test_1d_promoted_and_3d_refused(tmp_path):
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "a"),
                                              np.arange(5.0)))
    assert st.shape == (5, 1)
    with pytest.raises(StoreError, match=r"\[N, d\]"):
        write_feature_store(str(tmp_path / "b"), np.zeros((2, 2, 2)))


def test_refuses_existing_and_publishes_atomically(tmp_path):
    root = write_feature_store(str(tmp_path / "s"), _rows())
    with pytest.raises(StoreError, match="already exists"):
        write_feature_store(root, _rows(seed=1))
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp-")]
    write_feature_store(root, _rows(seed=1), overwrite=True)
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith((".tmp-", ".trash-"))]
    np.testing.assert_array_equal(
        DiskFeatureStore(root).read_rows(np.arange(64)), _rows(seed=1))


def test_out_of_range_is_structured_before_any_write(tmp_path):
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "s"), _rows()))
    out = np.full((3, 8), 7.0, np.float32)
    with pytest.raises(StoreError, match="out of range"):
        st.gather_into(out, np.array([1, 64, 2]))
    assert (out == 7.0).all()


def test_pool_chunked_gather_matches_inline(tmp_path):
    x = _rows(500, 4)
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "s"), x))
    ids = np.random.default_rng(3).integers(-1, 500, 300)
    out = np.zeros((300, 4), np.float32)
    with ThreadPoolExecutor(3) as pool:
        for fu in st.gather_into(out, ids, pool=pool, row_chunk=37):
            fu.result()
    np.testing.assert_array_equal(out, np.where((ids >= 0)[:, None],
                                                x[np.maximum(ids, 0)], 0))


def test_truncation_and_bit_rot_are_structured(tmp_path):
    root = write_feature_store(str(tmp_path / "s"), _rows())
    data = os.path.join(root, DATA_NAME)
    with open(data, "r+b") as fh:
        fh.seek(100)
        b = fh.read(1)
        fh.seek(100)
        fh.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(StoreCorruptError, match="sha256"):
        DiskFeatureStore(root).verify()
    with pytest.raises(JaxCorruptError, match="sha256"):
        JaxStore(root).verify()
    with open(data, "r+b") as fh:
        fh.truncate(os.path.getsize(data) - 4)
    with pytest.raises(StoreCorruptError, match="truncated"):
        DiskFeatureStore(root)
    man = os.path.join(root, MANIFEST_NAME)
    with open(man) as fh:
        m = json.load(fh)
    m["format_version"] = 99
    with open(man, "w") as fh:
        json.dump(m, fh)
    with pytest.raises(StoreError, match="format"):
        DiskFeatureStore(root)
    with open(man, "w") as fh:
        fh.write("{not json")
    with pytest.raises(StoreError, match="unreadable"):
        DiskFeatureStore(root)


@pytest.mark.parametrize("codec", ["raw", "bf16"])
def test_writer_equals_jax_writer_and_reattaches(tmp_path, codec):
    x = _rows(100, 6)
    roots = []
    for Writer, name in ((FeatureStoreWriter, "t"), (JaxWriter, "j")):
        w = Writer(str(tmp_path / name), 100, 6, codec=codec)
        for lo in range(0, 100, 30):
            w.write_rows(lo, x[lo:lo + 30])
        roots.append(w.finalize())
    assert _sha(roots[0]) == _sha(roots[1])
    # An interrupted writer re-attaches to its partial file; rewriting
    # the sweeps after the last one written is bit-identical.
    w = FeatureStoreWriter(str(tmp_path / "r"), 100, 6, codec=codec)
    w.write_rows(0, x[:30])
    w.write_rows(30, x[30:60])
    w.flush()
    del w
    w2 = FeatureStoreWriter(str(tmp_path / "r"), 100, 6, codec=codec)
    assert w2.reattached
    w2.write_rows(60, x[60:90])
    w2.write_rows(90, x[90:])
    assert _sha(w2.finalize()) == _sha(roots[0])
    DiskFeatureStore(str(tmp_path / "r")).verify()


def test_writer_contracts(tmp_path):
    with pytest.raises(StoreError, match="QuantSpec"):
        FeatureStoreWriter(str(tmp_path / "a"), 10, 4, codec="int8")
    x = _rows(10, 4)
    enc, spec = quant.encode(x, "int8")
    w = FeatureStoreWriter(str(tmp_path / "b"), 10, 4, spec=spec)
    with pytest.raises(StoreError, match="out of\\s+bounds"):
        w.write_rows(8, x[:5])
    w.write_rows(0, x)
    np.testing.assert_array_equal(
        DiskFeatureStore(w.finalize()).read_rows(np.arange(10)), enc)
    w = FeatureStoreWriter(str(tmp_path / "c"), 10, 4)
    w.abort()
    assert not os.path.exists(tmp_path / "c")
    assert not os.path.exists(tmp_path / ".partial-c")
    with pytest.raises(StoreError, match="already exists"):
        FeatureStoreWriter(str(tmp_path / "b"), 10, 4)


def _stager_sequence(Store, Stager, root, rng_seed):
    rng = np.random.default_rng(rng_seed)
    st = Store(root)
    sg = Stager(st, 20 * st.row_nbytes)
    scores = np.zeros(st.num_rows)
    scores[:10] = np.arange(10, 0, -1)
    try:
        sg.warm(scores)
        outs, stats = [], []
        for _ in range(8):
            ids = rng.integers(-1, st.num_rows, 25)
            ids[:5] = rng.integers(0, 6, 5)              # hot ids repeat
            outs.append(_as_bits(sg.gather(ids)))
            stats.append(sg.epoch_stats())
        return outs, stats, sg.stats()
    finally:
        sg.close()


@pytest.mark.parametrize("codec", ["raw", "int8", "bf16"])
def test_stager_counters_equal_jax(tmp_path, codec):
    x = _rows(120, 5)
    root = write_feature_store(str(tmp_path / "s"), x, codec=codec)
    a = _stager_sequence(DiskFeatureStore, DramStager, root, 7)
    b = _stager_sequence(JaxStore, JaxStager, root, 7)
    for ra, rb in zip(a[0], b[0]):
        np.testing.assert_array_equal(ra, rb)
    assert a[1] == b[1]
    assert a[2] == b[2]
    assert a[2]["resident_bytes"] <= a[2]["budget_bytes"]


def test_stager_budget_enforced_and_zero_budget_refused(tmp_path):
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "s"),
                                              _rows(200, 8)))
    with pytest.raises(ValueError, match="zero"):
        DramStager(st, st.row_nbytes - 1)
    sg = DramStager(st, 16 * st.row_nbytes + 5)
    try:
        assert sg.capacity == 16
        rng = np.random.default_rng(0)
        for _ in range(30):
            sg.gather(rng.integers(0, 200, 40))
            assert sg.resident_bytes() <= sg.dram_budget_bytes
        with pytest.raises(ValueError, match="cover"):
            sg.warm(np.zeros(5))
    finally:
        sg.close()


def test_stage_ahead_installs_for_later_hits(tmp_path):
    x = _rows(64, 4)
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "s"), x))
    sg = DramStager(st, 32 * st.row_nbytes)
    try:
        assert sg.stage_ahead(np.array([3, 9, 9, 27, -1])).result() == 3
        got = sg.gather(np.array([9, 3, 27]))
        np.testing.assert_array_equal(got, x[[9, 3, 27]])
        s = sg.stats()
        assert s["hits"] == 3 and s["misses"] == 0 and s["staged_rows"] == 3
    finally:
        sg.close()


def test_demand_read_error_raises_and_caches_nothing(tmp_path):
    root = write_feature_store(str(tmp_path / "s"), _rows(32, 4))
    hook = Faults(fail_at=1)
    sg = DramStager(DiskFeatureStore(root, faults=hook),
                    8 * 16)
    try:
        with pytest.raises(OSError, match="fault injection"):
            sg.gather(np.array([0, 1, 2]))
        assert hook.failures == 1 and sg.resident_rows() == 0
        np.testing.assert_array_equal(
            sg.gather(np.array([5])),
            DiskFeatureStore(root).read_rows(np.array([5])))
    finally:
        sg.close()


def test_failed_chunk_vetoes_dram_install(tmp_path):
    root = write_feature_store(str(tmp_path / "s"), _rows(64, 4))
    hook = Faults(fail_at=2)
    sg = DramStager(DiskFeatureStore(root, faults=hook), 64 * 16)
    try:
        out = np.zeros((32, 4), np.float32)
        with ThreadPoolExecutor(2) as pool:
            futs = sg.gather_into(out, np.arange(32), pool=pool,
                                  row_chunk=8)
            assert len(futs) == 4
            errs = [fu.exception() for fu in futs]
        assert sum(e is not None for e in errs) == 1
        assert sg.resident_rows() == 0
    finally:
        sg.close()


def test_stalled_staging_degrades_not_hangs(tmp_path):
    x = _rows(64, 4)
    root = write_feature_store(str(tmp_path / "s"), x)
    hook = Faults(delay_at=(1,), delay_s=2.0)
    sg = DramStager(DiskFeatureStore(root, faults=hook), 16 * 16)
    try:
        ids = np.array([3, 9, 27])
        fut = sg.stage_ahead(ids)               # read 1 stalls
        deadline = time.time() + 5
        while hook.delays < 1:
            assert time.time() < deadline, "stage thread never read"
            time.sleep(0.01)
        t0 = time.time()
        got = sg.gather(ids)                    # read 2: demand, no delay
        assert time.time() - t0 < 1.0
        np.testing.assert_array_equal(got, x[ids])
        fut.result()
        assert sg.stats()["stage_errors"] == 0
    finally:
        sg.close()


def test_staging_read_error_counted_as_degraded(tmp_path):
    x = _rows(32, 4)
    root = write_feature_store(str(tmp_path / "s"), x)
    sg = DramStager(DiskFeatureStore(root, faults=Faults(fail_at=1)), 8 * 16)
    try:
        assert sg.stage_ahead(np.array([1, 2])).result() == 0
        assert sg.stats()["stage_errors"] == 1
        np.testing.assert_array_equal(sg.gather(np.array([1, 2])), x[[1, 2]])
    finally:
        sg.close()
