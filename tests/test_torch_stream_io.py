"""The streaming replay's input and checkpoint layers on the CPU: the
port's :class:`~repro_torch.data.trace_store.TraceStore`, its
:class:`~repro_torch.data.pipeline.Prefetcher` and its
:class:`~repro_torch.checkpoint.manager.CheckpointManager`, each mirroring
the JAX package's tests of the same pieces (``tests/test_stream.py``),
and the carry-over between the two packages: a store or a flat checkpoint
written by either one is read by the other, and the two packages' stores
of the same trace are byte-identical.  The JAX package's ``data`` and
``checkpoint`` modules import in this process."""

import json

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.data.trace_store import TraceStore as JaxTraceStore
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.devices import make_device
from repro_torch.core.replay import replay_stream
from repro_torch.core.replay.engine import ReplayEngine
from repro_torch.core.replay.spec import trace_to_arrays
from repro_torch.data import Prefetcher, TraceStore, TraceStoreCorrupt


def _trace(seed, n=300, pages=24, write_frac=0.3):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, pages, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < write_frac
    return [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]


# ------------------------------------------------------------- TraceStore
def test_trace_store_roundtrip(tmp_path):
    trace = _trace(11)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    assert (st.n, st.size) == (len(trace), 64)
    assert st.max_addr == max(a for a, _, _ in trace)
    assert np.array_equal(np.asarray(st.column("addr")),
                          np.asarray([a for a, _, _ in trace]))
    assert np.array_equal(st.writes(),
                          np.asarray([w for _, _, w in trace]))
    st2 = TraceStore(tmp_path / "t.store")
    got = st2.slice(10, 20)
    assert got["addr"].tolist() == [a for a, _, _ in trace[10:20]]
    spans = [(lo, hi) for lo, hi, _ in st2.chunks(77)]
    assert spans[0] == (0, 77) and spans[-1][1] == len(trace)
    # chunk-aligned resume: iteration picks up mid-store
    tail = [(lo, hi) for lo, hi, _ in st2.chunks(77, start=154)]
    assert tail == spans[2:]


def test_trace_store_validation(tmp_path):
    with pytest.raises(ValueError, match="empty"):
        TraceStore.write(tmp_path / "e", [], [])
    with pytest.raises(ValueError, match="64 B line"):
        TraceStore.write(tmp_path / "l", [32], [False], size=64)
    with pytest.raises(ValueError, match="negative"):
        TraceStore.write(tmp_path / "n", [-64], [False])
    with pytest.raises(FileNotFoundError, match="TraceStore"):
        TraceStore(tmp_path / "missing")


def test_trace_store_optional_columns(tmp_path):
    st = TraceStore.write(tmp_path / "t", [0, 64, 128],
                          [True, False, True],
                          hosts=[0, 1, 0], routes=[1, 0, 1])
    assert "host" in st.column_names and "route" in st.column_names
    assert np.asarray(st.column("host")).tolist() == [0, 1, 0]


def test_trace_store_validate_detects_bit_flip(tmp_path):
    st = TraceStore.from_trace(tmp_path / "t.store", _trace(17, n=64))
    st.validate()
    f = tmp_path / "t.store" / "addr.npy"
    raw = bytearray(f.read_bytes())
    raw[-5] ^= 0x01
    f.write_bytes(bytes(raw))
    with pytest.raises(TraceStoreCorrupt, match="checksum mismatch"):
        TraceStore(tmp_path / "t.store").validate()


def test_trace_store_validate_detects_truncation(tmp_path):
    TraceStore.from_trace(tmp_path / "t.store", _trace(18, n=64))
    f = tmp_path / "t.store" / "op.npy"
    f.write_bytes(f.read_bytes()[: len(f.read_bytes()) // 2])
    with pytest.raises(TraceStoreCorrupt, match="checksum|truncated"):
        TraceStore(tmp_path / "t.store").validate()
    # a store without checksums: the row-count check still catches it
    hdr = tmp_path / "t.store" / "header.json"
    meta = json.loads(hdr.read_text())
    meta.pop("checksums")
    hdr.write_text(json.dumps(meta))
    full = np.asarray(TraceStore.from_trace(
        tmp_path / "u.store", _trace(18, n=64)).column("op"))
    np.save(f, full[:40])
    reopened = TraceStore(tmp_path / "t.store")
    with pytest.raises(TraceStoreCorrupt, match="truncated|rows"):
        reopened.validate()
    (tmp_path / "t.store" / "addr.npy").unlink()
    with pytest.raises(TraceStoreCorrupt, match="unreadable"):
        reopened.validate()


def test_stream_surfaces_corrupt_store_instead_of_hanging(tmp_path):
    TraceStore.from_trace(tmp_path / "t.store", _trace(19, n=64))
    f = tmp_path / "t.store" / "addr.npy"
    f.write_bytes(f.read_bytes()[:30])      # a partial .npy header
    pf = Prefetcher(TraceStore(tmp_path / "t.store").chunks(16), depth=2)
    with pytest.raises(Exception):
        list(pf)
    pf.close()


# -------------------------------------------------------------- Prefetcher
def test_prefetcher_order_and_exhaustion():
    items = [np.arange(i + 1) for i in range(10)]
    pf = Prefetcher(iter(items), depth=2)
    got = list(pf)
    assert len(got) == 10
    for a, b in zip(items, got):
        assert np.array_equal(a, b)
    with pytest.raises(StopIteration):
        next(pf)                            # exhaustion is idempotent
    pf.close()
    pf.close()                              # and so is close


def test_prefetcher_forwards_producer_error():
    def boom():
        yield np.zeros(4)
        raise RuntimeError("bang")

    pf = Prefetcher(boom(), depth=1)
    assert np.array_equal(next(pf), np.zeros(4))
    with pytest.raises(RuntimeError, match="bang"):
        next(pf)
    pf.close()


def test_prefetcher_peak_accounting():
    pf = Prefetcher(iter([np.zeros(10, np.int64),
                          np.ones(5, np.uint8)]), depth=2)
    assert [a.nbytes for a in pf] == [80, 5]
    assert 0 < pf.peak_buffered_bytes <= 85
    pf.close()
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([]), depth=0)


# -------------------------------------------------------- CheckpointManager
TREE = {"b": (np.arange(6, dtype=np.int64).reshape(2, 3),
              torch.tensor([1.5, -2.0])),
        "a": {"x": torch.tensor([True, False]),
              "y": np.asarray([7], np.uint8)}}


def test_checkpoint_save_restore_places_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        mgr.save(step, TREE, extra={"step": step})
    assert sorted(mgr.all_steps()) == [2, 3]       # keep=2 collects step 1
    tree, extra, step = mgr.restore(TREE)
    assert (extra, step) == ({"step": 3}, 3)
    assert isinstance(tree["b"][1], torch.Tensor)
    assert tree["b"][1].device == torch.device("cpu")
    assert torch.equal(tree["b"][1], TREE["b"][1])
    assert np.array_equal(tree["b"][0], TREE["b"][0])
    assert torch.equal(tree["a"]["x"], TREE["a"]["x"])
    flat, _, _ = mgr.restore_flat(2)
    assert sorted(flat) == ["a/x", "a/y", "b/0", "b/1"]


def test_checkpoint_async_and_bfloat16(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = {"w": torch.arange(4, dtype=torch.bfloat16) / 3}
    mgr.save_async(5, t)
    mgr.wait()
    got, _, _ = mgr.restore(t)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t["w"])


def test_checkpoint_skips_torn_steps_and_refuses_remesh(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, TREE)
    mgr.save(2, TREE)
    victim = sorted((tmp_path / "step_00000002").glob("*.bin"))[0]
    raw = bytearray(victim.read_bytes())
    raw[0] ^= 0xFF
    victim.write_bytes(bytes(raw))
    (tmp_path / "step_00000003.tmp").mkdir()       # a crash mid-save
    _, _, step = mgr.restore_latest_good()
    assert step == 1
    with pytest.raises(NotImplementedError, match="14d"):
        mgr.restore(TREE, mesh=object())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore_latest_good()


# -------------------------------------------------------------- carry-over
def test_stores_of_both_packages_are_byte_identical(tmp_path):
    # the JAX package's from_trace imports its replay layer, which does
    # not import here; its write takes the same columns
    trace = _trace(31, n=500)
    ours = TraceStore.from_trace(tmp_path / "ours", trace, hosts=[0] * 500)
    addrs, writes, size = trace_to_arrays(trace)
    theirs = JaxTraceStore.write(tmp_path / "theirs", addrs, writes,
                                 size=size, hosts=[0] * 500)
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    for name in names:
        assert ((tmp_path / "ours" / name).read_bytes()
                == (tmp_path / "theirs" / name).read_bytes()), name
    assert ours.column_names == theirs.column_names


def test_a_store_of_either_package_replays_equal(tmp_path):
    trace = _trace(32, n=400, pages=64)
    addrs, writes, size = trace_to_arrays(trace)
    JaxTraceStore.write(tmp_path / "jax", addrs, writes, size=size)
    TraceStore.from_trace(tmp_path / "torch", trace)
    want = ReplayEngine(make_device("cxl-ssd"), outstanding=8,
                        torch_device="cpu").run(trace)
    for name in ("jax", "torch"):
        got = replay_stream(TraceStore(tmp_path / name), make_device(
            "cxl-ssd"), chunk_size=64, outstanding=8, torch_device="cpu")
        assert got.latency_ticks.tolist() == want.latency_ticks.tolist()
        theirs = JaxTraceStore(tmp_path / name)
        theirs.validate()
        assert [lo for lo, _, _ in theirs.chunks(64)] == list(
            range(0, 400, 64))


def test_flat_checkpoints_restore_across_packages(tmp_path):
    flat = {"carry/words": np.arange(9, dtype=np.int64),
            "parts/0/fl": np.asarray([1, 0, 3], np.int32),
            "builder/deg": np.asarray([1, 0], np.uint8)}
    extra = {"format": "any", "seen": 3}
    CheckpointManager(tmp_path / "ours").save(3, flat, extra=extra)
    JaxCheckpoints(str(tmp_path / "theirs")).save(3, flat, extra=extra)
    for writer in ("ours", "theirs"):
        for reader in (CheckpointManager, JaxCheckpoints):
            got, ex, step = reader(str(tmp_path / writer)).restore_flat()
            assert (ex, step) == (extra, 3), (writer, reader)
            assert sorted(got) == sorted(flat)
            for k, v in flat.items():
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
