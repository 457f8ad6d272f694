"""The port's channel package against ``glt_tpu``'s (cf.
``tests/test_channel.py``): the serialized bytes are ``==`` to
``glt_tpu``'s for every dtype both send (bf16 as its 16-bit patterns),
the native ring is the port's own copy of ``csrc/shm_queue.cc`` built by
g++ into a hashed directory (published by an atomic rename), and a ring
created by one package is read by the other."""
import ctypes
import errno
import multiprocessing as mp
import os
import queue
import subprocess
import threading

import numpy as np
import pytest
import torch

from glt_tpu_torch.channel import (QueueSourceDied, ShmChannel, bounded_get,
                                   bounded_put, deserialize, serialize,
                                   serialized_size)
from glt_tpu_torch.channel import native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every dtype the wire format knows (glt_tpu's nine).
WIRE_DTYPES = ("float32", "float64", "int32", "int64", "int16", "int8",
               "uint8", "bool", "float16")


def _array(dtype, shape=(3, 4)):
    rng = np.random.default_rng(0)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    return (rng.standard_normal(shape) * 50).astype(dtype)


@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_serialize_bytes_equal_glt_tpu(dtype):
    from glt_tpu.channel import deserialize as jax_deserialize
    from glt_tpu.channel import serialize as jax_serialize

    msg = {"x": _array(dtype), "#META.batch_size": np.array(7, np.int64),
           "scalar": np.array(3, dtype), "empty": np.zeros((0, 5), dtype)}
    buf = serialize(msg)
    assert buf == jax_serialize(msg)
    assert len(buf) == serialized_size(msg)
    for out in (deserialize(buf), jax_deserialize(memoryview(buf))):
        assert list(out) == list(msg)
        for k in msg:
            assert out[k].dtype == msg[k].dtype
            np.testing.assert_array_equal(out[k], msg[k])


def _message(x):
    return {"node": np.arange(x.shape[0], dtype=np.int32),
            "row": np.zeros(2, np.int32), "col": np.zeros(2, np.int32),
            "node_mask": np.ones(x.shape[0], bool),
            "edge_mask": np.ones(2, bool),
            "#META.batch_size": np.array(x.shape[0], np.int64), "x": x}


def test_bf16_bits_travel_as_glt_tpu_int16():
    """bf16 rows leave the port as uint16 bit patterns; on the wire they
    are int16 (a code glt_tpu reads), byte for byte, named in a
    ``#UINT16`` entry, and come back as uint16 and the same bf16 values
    through message_to_batch."""
    from glt_tpu.channel import deserialize as jax_deserialize
    from glt_tpu.channel import serialize as jax_serialize
    from glt_tpu_torch.distributed.sample_message import (_host,
                                                         message_to_batch)

    x = torch.randn(6, 5).to(torch.bfloat16)
    bits = _host(x)
    assert bits.dtype == np.uint16
    msg = _message(bits)
    buf = serialize(msg)
    assert len(buf) == serialized_size(msg)
    on_wire = dict(msg, x=bits.view(np.int16),
                   **{"#UINT16": np.frombuffer(b"x", np.uint8)})
    assert buf == jax_serialize(on_wire)
    jm = jax_deserialize(memoryview(buf))
    np.testing.assert_array_equal(jm["x"], bits.view(np.int16))
    back = deserialize(buf)
    assert list(back) == list(msg) and back["x"].dtype == np.uint16
    b = message_to_batch(back, device="cpu")
    assert b.x.dtype == torch.bfloat16 and torch.equal(b.x, x)


def test_int16_x_is_not_read_as_bf16():
    """A real int16 ``x`` travels as glt_tpu's bytes and stays int16: only
    the port's uint16 bf16 bits are read back as bf16."""
    from glt_tpu.channel import serialize as jax_serialize
    from glt_tpu_torch.distributed.sample_message import message_to_batch

    msg = _message(np.arange(-15, 15, dtype=np.int16).reshape(6, 5))
    buf = serialize(msg)
    assert buf == jax_serialize(msg)
    back = deserialize(buf)
    assert back["x"].dtype == np.int16
    b = message_to_batch(back, device="cpu")
    assert b.x.dtype == torch.int16
    np.testing.assert_array_equal(b.x.numpy(), msg["x"])
    with pytest.raises(ValueError, match="#UINT16"):
        serialize(dict(msg, x=msg["x"].view(np.uint16),
                       **{"#UINT16": np.zeros(1, np.uint8)}))


def test_unsupported_dtype_rejected():
    with pytest.raises(TypeError, match="unsupported dtype"):
        serialize({"c": np.zeros(2, np.complex64)})


def test_roundtrip_and_empty():
    msg = {"node": np.arange(10, dtype=np.int64),
           "x": np.random.default_rng(0).normal(size=(4, 3)).astype(
               np.float32),
           "mask": np.array([True, False, True]),
           "#META.bs": np.array(7, dtype=np.int32)}
    out = deserialize(memoryview(serialize(msg)))
    for k in msg:
        np.testing.assert_array_equal(out[k], msg[k])
        assert out[k].dtype == msg[k].dtype
    assert deserialize(memoryview(serialize({}))) == {}


def test_send_recv_fifo_and_empty():
    ch = ShmChannel(capacity_bytes=1 << 20)
    try:
        assert ch.empty()
        for i in range(50):
            ch.send({"i": np.array([i]), "b": np.ones((2, 2), np.float32)})
        assert not ch.empty()
        for i in range(50):
            out = ch.recv()
            assert out["i"][0] == i
            np.testing.assert_array_equal(out["b"], np.ones((2, 2)))
        assert ch.empty()
        assert ch.recv(timeout=0) is None
    finally:
        ch.close()


def test_oversized_message_raises_not_hangs():
    ch = ShmChannel(capacity_bytes=4096)
    try:
        with pytest.raises(ValueError, match="exceeds channel capacity 4096"):
            ch.send({"big": np.zeros(10000, np.float64)})
    finally:
        ch.close()


def test_wraparound():
    ch = ShmChannel(capacity_bytes=8192)
    try:
        for round_ in range(20):
            msg = {"x": np.full(300, round_, np.int32)}
            ch.send(msg)
            np.testing.assert_array_equal(ch.recv()["x"], msg["x"])
    finally:
        ch.close()


def test_ring_too_large_for_shm_raises_with_size():
    """A ring /dev/shm cannot hold fails at creation with the size asked
    for (its pages are reserved up front), never a SIGBUS on write."""
    with pytest.raises(OSError, match=str(1 << 56)):
        ShmChannel(capacity_bytes=1 << 56)


def _producer(ch, n):
    for i in range(n):
        ch.send({"i": np.array([i]), "payload": np.full(1000, i, np.float32)})


def test_producer_subprocess():
    ctx = mp.get_context("spawn")
    ch = ShmChannel(capacity_bytes=1 << 20)
    try:
        p = ctx.Process(target=_producer, args=(ch, 20))
        p.start()
        for i in range(20):
            out = ch.recv(timeout=60)
            assert out["i"][0] == i and (out["payload"] == i).all()
        p.join(timeout=30)
        assert p.exitcode == 0
    finally:
        ch.close()


@pytest.mark.parametrize("writer", ["glt_tpu", "port"])
def test_rings_interoperate_with_glt_tpu(writer):
    """One C ABI and one ring layout: a ring made by either package is
    attached by name and read by the other."""
    from glt_tpu.channel import ShmChannel as JaxChannel

    make, read = ((JaxChannel, ShmChannel) if writer == "glt_tpu"
                  else (ShmChannel, JaxChannel))
    w = make(capacity_bytes=1 << 16)
    try:
        r = read(capacity_bytes=w.capacity, name=w.name, _attach=True)
        msg = {"node": np.arange(7, dtype=np.int32),
               "x": np.ones((7, 3), np.float32)}
        w.send(msg)
        out = r.recv(timeout=10)
        for k in msg:
            np.testing.assert_array_equal(out[k], msg[k])
        r.close(unlink=False)
    finally:
        w.close()


def test_native_build_is_hashed_under_build():
    so = native.ensure_built()
    assert so == str(native.library_path())
    rel = os.path.relpath(so, REPO).split(os.sep)
    assert rel[:2] == ["build", "glt_tpu_torch"]
    assert rel[2].startswith("shm-")


def test_concurrent_builds_publish_one_whole_library(tmp_path, monkeypatch):
    """Builders racing on an empty build root each compile to a private
    path and rename: every one returns a loadable library."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    paths, errs = [], []

    def build():
        try:
            paths.append(native.ensure_built())
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=build) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs and len(set(paths)) == 1
    lib = ctypes.CDLL(paths[0])
    assert hasattr(lib, "glt_shmq_dequeue_alloc")
    leftovers = [p for p in os.listdir(os.path.dirname(paths[0]))
                 if p.endswith(".tmp")]
    assert leftovers == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "shm_queue.cc"
    bad.write_text("this is not C++ ;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.ensure_built()


def test_cuda_sources_do_not_include_the_ring():
    from glt_tpu_torch.ops import cuda_lib

    assert all(s.endswith(".cu") for s in cuda_lib.SOURCES)
    assert "shm_queue.cc" not in cuda_lib.SOURCES


def test_cpp_unit_tests_on_the_ports_copy(tmp_path):
    """The repo's native ring tests, linked against the port's copy."""
    exe = str(tmp_path / "test_shm_queue")
    subprocess.run(
        ["g++", "-O1", "-pthread", "-std=c++17",
         os.path.join(REPO, "glt_tpu_torch", "csrc", "shm_queue.cc"),
         os.path.join(REPO, "csrc", "test_shm_queue.cc"), "-o", exe, "-lrt"],
        check=True, capture_output=True)
    out = subprocess.run([exe], check=True, capture_output=True, timeout=60)
    assert b"all native shm queue tests passed" in out.stdout


def test_bounded_get_raises_when_source_dies():
    q = queue.Queue()
    waits = []
    with pytest.raises(QueueSourceDied):
        bounded_get(q, alive=lambda: False, poll=0.01,
                    on_wait=lambda: waits.append(1))
    assert waits == [1]
    q.put(5)
    assert bounded_get(q, alive=lambda: False, poll=0.01) == 5
    # A final put that races the source's death is still delivered.
    state = {"alive": True}

    def on_wait():
        q.put("last")
        state["alive"] = False

    assert bounded_get(q, alive=lambda: state["alive"], poll=0.01,
                       on_wait=on_wait) == "last"


def test_bounded_put_gives_up_when_stopped():
    q = queue.Queue(maxsize=1)
    stop = threading.Event()
    assert bounded_put(q, 1, stop, timeout=0.01)
    stop.set()
    assert not bounded_put(q, 2, stop, timeout=0.01)
    assert q.qsize() == 1


def test_shared_array_reservation_failure_names_the_size(monkeypatch):
    from glt_tpu_torch.data import shared

    def full(fd, off, size):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(shared.os, "posix_fallocate", full)
    with pytest.raises(OSError, match="cannot reserve 4096 bytes"):
        shared.SharedArray.from_array(np.zeros(1024, np.float32))
