"""The streaming forms of the scan lane on the CPU (its plain twin):
chunked replay (``chunk_size=``), bounded outputs
(``return_latencies=False``), ``ReplayEngine.run_store`` and
:func:`~repro_torch.core.replay.stream.replay_stream` with crash-safe
checkpoints, and the chunked multi-host replay.

The contract, as the JAX package's ``tests/test_stream.py`` states it for
its lanes: consuming a trace in chunks — in memory or from an on-disk
:class:`~repro_torch.data.trace_store.TraceStore` — gives *exactly* the
one-shot replay: per-access latencies, hit / evict / poison flags, every
scalar and the whole :class:`MetricsBundle`, on the five devices, under
QoS, ECMP and NAND, poison and transport fault plans, at chunk sizes that
do and do not divide the trace (1 and ragged tails included).  The tests
here mirror that file's wherever the port has the counterpart, and hold
the port's streamed outputs equal to the JAX package's chunked and
streamed lanes, which run in one child process for this file; the
golden ``python_scan`` pins and ``metrics`` blocks hold streamed too, and
the ``derived`` streaming oracle of ``results/BENCH_replay.json``
(2000 DRAM accesses at chunks 64 and 256).
"""

import json

import numpy as np
import pytest

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import DRAMDevice, make_device
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay import (MultiHostReplay, ReplayEngine,
                                     ReplayUnsupported, replay_stream)
from repro_torch.core.replay import metrics as M
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.stream import SNAPSHOT_FORMAT
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.data import TraceStore
from test_torch_reference import REPO, golden, run_reference
from torch_scenarios import (make_target, scenario_outstanding,
                             scenario_trace)

CACHE_KW = dict(capacity_bytes=16 * 4096, mshr_entries=4, writeback_buffer=2)
DEVICES = ["dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache"]
N = 300
CPU = dict(torch_device="cpu")
# the single-host scenarios with a python_scan pin
PINNED = ([f"{d}@{a}" for d in DEVICES for a in ("direct", "fabric")]
          + ["dram@stream", "pmem@stream", "dram-qos@fabric",
             "ssd-gc@direct"])
# results/BENCH_replay.json "streaming" "derived": the JAX package's
# streamed DRAM lane over 2000 accesses at chunks 64 and 256
DERIVED = {"sum_latency_ticks": 213359992, "end_tick": 6746000}


def _mk(name):
    if name == "cxl-ssd-cache":
        return make_device(name, cache_cfg=DRAMCacheConfig(policy="lru",
                                                           **CACHE_KW))
    return make_device(name)


def _trace(seed, n=N, pages=24, write_frac=0.3):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, pages, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < write_frac
    return [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]


def _stream_trace_arrays(n):
    """``benchmarks/replay_bench.py::_stream_trace_arrays``: 1024 pages,
    30% writes, ``default_rng(5)``."""
    rng = np.random.default_rng(5)
    pages = rng.integers(0, 1024, n)
    addrs = pages * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < 0.3
    return addrs.astype(np.int64), writes


def _qos_target():
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                       num_leaves=2, qos_weights={"h0": 3.0, "h1": 1.0})
    return fab.mount("h1", "d1", make_device("dram"))


def _ecmp_target(dev="dram"):
    fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True)
    return fab.mount("h0", "d0", _mk(dev))


def _transport_target(seed=7, down=(("s0", "sp0", 40, 180),)):
    tgt = _ecmp_target()
    install(FaultPlan(FaultConfig(link_retry_rate=0.25, down_links=down,
                                  poison_rate=0.1), seed=seed), [tgt])
    return tgt


def _nand_target():
    dev = _mk("cxl-ssd-cache")
    install(FaultPlan(FaultConfig(nand_read_retry_rate=0.3,
                                  poison_rate=0.1), seed=0), [dev])
    return dev


def _multi_targets():
    fab = Fabric.build("spine_leaf", num_hosts=3, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True,
                       qos_weights={"h0": 3.0, "h1": 1.0, "h2": 1.0})
    pool = MemoryPool(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
    return pool.views(["h0", "h1", "h2"])


def _engine(target, metrics=True, **kw):
    return ReplayEngine(target, outstanding=8,
                        metrics=MetricsSpec() if metrics else None,
                        **CPU, **kw)


def _jm(bundle):
    return json.dumps(bundle.to_jsonable(), sort_keys=True)


def _assert_same(base, res, key=None):
    assert res.latency_ticks.tolist() == base.latency_ticks.tolist(), key
    assert res.hit_flags.tolist() == base.hit_flags.tolist(), key
    assert res.evict_flags.tolist() == base.evict_flags.tolist(), key
    assert (res.elapsed_ticks, res.sum_latency_ticks, res.end_tick,
            res.gc_runs) == (base.elapsed_ticks, base.sum_latency_ticks,
                             base.end_tick, base.gc_runs), key
    if base.poison_flags is not None:
        assert res.poison_flags.tolist() == base.poison_flags.tolist(), key
    if base.availability is not None:
        assert json.dumps(res.availability, sort_keys=True, default=str) \
            == json.dumps(base.availability, sort_keys=True, default=str)
    if base.metrics is not None:
        assert _jm(res.metrics) == _jm(base.metrics), key


def _assert_bounded(base, res, key=None):
    assert res.latency_ticks is None and res.hit_flags is None, key
    assert (res.elapsed_ticks, res.sum_latency_ticks, res.end_tick,
            res.gc_runs) == (base.elapsed_ticks, base.sum_latency_ticks,
                             base.end_tick, base.gc_runs), key
    if base.metrics is not None:
        assert _jm(res.metrics) == _jm(base.metrics), key


# ---------------------------------------------------------- the reference
# the JAX package's chunked and streamed lanes on this file's cases, in
# one child (its replay layer does not import in this process)
REFERENCE = '''
import json, tempfile
from pathlib import Path
import numpy as np
import jax.numpy as jnp
from jax.experimental import enable_x64
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import DRAMDevice, make_device
from repro.core.fabric import Fabric, MemoryPool
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import MultiHostReplay, ReplayEngine, replay_stream
from repro.core.replay.metrics import MetricsSpec, bucket_index_jnp
from repro.data.trace_store import TraceStore
CACHE_KW = dict(capacity_bytes=16 * 4096, mshr_entries=4, writeback_buffer=2)


def trace(seed, n=300, pages=24, write_frac=0.3):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, pages, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < write_frac
    return [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]


def jm(b):
    return json.dumps(b.to_jsonable(), sort_keys=True)


def put(key, res):
    OUT[key + "/scalars"] = np.asarray([res.elapsed_ticks,
                                        res.sum_latency_ticks, res.end_tick])
    if res.latency_ticks is not None:
        OUT[key + "/lat"] = np.asarray(res.latency_ticks)
    if res.poison_flags is not None:
        OUT[key + "/poison"] = np.asarray(res.poison_flags)
    if res.metrics is not None:
        OUT[key + "/metrics"] = np.asarray(jm(res.metrics))


def cached():
    return make_device("cxl-ssd-cache",
                       cache_cfg=DRAMCacheConfig(policy="lru", **CACHE_KW))


def transport():
    fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True)
    tgt = fab.mount("h0", "d0", make_device("dram"))
    install(FaultPlan(FaultConfig(link_retry_rate=0.25,
                                  down_links=(("s0", "sp0", 40, 180),),
                                  poison_rate=0.1), seed=7), [tgt])
    return tgt


def multi_targets():
    fab = Fabric.build("spine_leaf", num_hosts=3, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True,
                       qos_weights={"h0": 3.0, "h1": 1.0, "h2": 1.0})
    pool = MemoryPool(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
    return pool.views(["h0", "h1", "h2"])


spec = MetricsSpec()
t1 = trace(1)
eng = ReplayEngine(cached(), outstanding=8, metrics=spec)
put("cache/chunk77", eng.run(t1, chunk_size=77))
put("cache/bounded77", ReplayEngine(cached(), outstanding=8, metrics=spec)
    .run(t1, chunk_size=77, return_latencies=False))
a, w = IN["derived_addrs"], IN["derived_writes"]
put("derived/oneshot", ReplayEngine(make_device("dram"), metrics=spec)
    .run_arrays(a, w, return_latencies=False))
with tempfile.TemporaryDirectory() as td:
    store = TraceStore.write(Path(td) / "d.store", a, w)
    put("derived/stream64", replay_stream(store, make_device("dram"),
                                          chunk_size=64, metrics=spec,
                                          return_latencies=False))
    t15 = trace(15)
    store = TraceStore.from_trace(Path(td) / "t.store", t15)
    put("transport/stream32", replay_stream(store, transport(),
                                            chunk_size=32, outstanding=8,
                                            metrics=spec))
traces = [trace(100 + h, n=160) for h in range(3)]
mres, lat = MultiHostReplay(multi_targets(), outstanding=8,
                            metrics=spec).run_recorded(traces, chunk_size=7)
OUT["multi/chunk7/lat"] = np.concatenate(lat)
OUT["multi/chunk7/metrics"] = np.asarray(jm(mres.metrics))
bres = MultiHostReplay(multi_targets(), outstanding=8, metrics=spec).run(
    traces, chunk_size=7, return_latencies=False)
OUT["multi/bounded7/metrics"] = np.asarray(jm(bres.metrics))
OUT["multi/bounded7/hosts"] = np.asarray(
    [[h.accesses, h.elapsed_ticks, h.sum_latency_ticks, h.end_tick]
     for h in bres.per_host] + [[0, bres.elapsed_ticks, 0, 0]])
with enable_x64():
    v = jnp.asarray(IN["bucket_values"])
    OUT["buckets"] = np.stack([np.asarray(bucket_index_jnp(v, nb))
                               for nb in range(8, 209)])
'''


def _bucket_values():
    """int64 values around every power of two and its quarter steps, and a
    few spread over the whole range."""
    vals = {0, 1, 2, 7, 8, 9, (1 << 63) - 1}
    for e in range(3, 63):
        for q in range(4):
            at = (1 << e) + q * (1 << (e - 2))
            vals.update((at - 1, at, at + 1))
    vals.update(int(x) for x in np.random.default_rng(0).integers(
        0, 1 << 62, 500))
    return np.asarray(sorted(v for v in vals if 0 <= v < 1 << 63), np.int64)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    a, w = _stream_trace_arrays(2000)
    return run_reference(REFERENCE, tmp_path_factory.mktemp("stream_ref"),
                         inputs={"derived_addrs": a, "derived_writes": w,
                                 "bucket_values": _bucket_values()})


def _assert_reference(ref, key, res):
    assert ref[key + "/scalars"].tolist() == [
        res.elapsed_ticks, res.sum_latency_ticks, res.end_tick], key
    if key + "/lat" in ref:
        assert ref[key + "/lat"].tolist() == res.latency_ticks.tolist(), key
    if key + "/poison" in ref:
        assert ref[key + "/poison"].tolist() == res.poison_flags.tolist()
    if key + "/metrics" in ref:
        assert str(ref[key + "/metrics"]) == _jm(res.metrics), key


# ------------------------------------------------------- chunk parity (1P)
@pytest.mark.parametrize("name", DEVICES)
def test_chunked_matches_oneshot_all_devices(name):
    trace = _trace(1)
    base = _engine(_mk(name)).run(trace)
    for chunk in (1, 8, 77, len(trace)):
        _assert_same(base, _engine(_mk(name)).run(trace, chunk_size=chunk),
                     (name, chunk))
        _assert_bounded(base, _engine(_mk(name)).run(
            trace, chunk_size=chunk, return_latencies=False), (name, chunk))


@pytest.mark.parametrize("length", [1, 7, 8, 9, 19])
def test_ragged_tail_lengths_exact(length):
    """Lengths {1, C-1, C, C+1, 2C+3} at C=8: the last chunk is shorter,
    and nothing is padded into the state."""
    trace = _trace(3, n=length)
    base = _engine(_mk("cxl-ssd-cache")).run(trace)
    _assert_same(base, _engine(_mk("cxl-ssd-cache")).run(trace,
                                                         chunk_size=8))


def test_chunked_qos_and_ecmp_exact():
    trace = _trace(5)
    for mk in (_qos_target, _ecmp_target):
        base = _engine(mk()).run(trace)
        for chunk in (1, 8, 77, len(trace)):
            _assert_same(base, _engine(mk()).run(trace, chunk_size=chunk),
                         (mk.__name__, chunk))


def test_chunked_fault_plan_exact():
    """Transport faults + QoS: the chunked lane carries the QoS virtual
    clock explicitly (retries decouple it from busy-until)."""
    def mk():
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, ecmp=True,
                           qos_weights={"h0": 2.0, "h1": 1.0})
        tgt = fab.mount("h0", "d0", make_device("dram"))
        install(FaultPlan(FaultConfig(link_retry_rate=0.25), seed=7), [tgt])
        return tgt

    trace = _trace(6)
    base = _engine(mk()).run(trace)
    for chunk in (8, 77, len(trace)):
        _assert_same(base, _engine(mk()).run(trace, chunk_size=chunk), chunk)


def test_chunked_nand_fault_and_poison_exact():
    trace = _trace(7)
    base = _engine(_nand_target()).run(trace)
    assert base.poison_flags.any()
    for chunk in (8, 77):
        _assert_same(base, _engine(_nand_target()).run(trace,
                                                       chunk_size=chunk),
                     chunk)
        _assert_bounded(base, _engine(_nand_target()).run(
            trace, chunk_size=chunk, return_latencies=False), chunk)


def test_chunked_refusals_match_oneshot():
    eng = ReplayEngine(_mk("dram"), outstanding=8, **CPU)
    with pytest.raises(ReplayUnsupported, match="empty"):
        eng.run([], chunk_size=8)
    with pytest.raises(ValueError, match="chunk_size"):
        eng.run(_trace(1, n=4), chunk_size=0)
    qos = ReplayEngine(_qos_target(), outstanding=8, **CPU)
    with pytest.raises(ReplayUnsupported, match="start_tick"):
        qos.run(_trace(1, n=4), start_tick=-5, chunk_size=2)


def test_qos_throttle_counter_matches_python():
    trace = _trace(9, n=160)
    py = TraceDriver(_qos_target(), outstanding=8, engine="python",
                     metrics=MetricsSpec()).run(trace)
    sc = _engine(_qos_target()).run(trace, chunk_size=13)
    thr = [p["qos_throttle_events"]
           for p in py.metrics.to_jsonable()["ports"].values()]
    assert sum(thr) > 0, "scenario must exercise the throttle counter"
    assert _jm(py.metrics) == _jm(sc.metrics)


def test_chunked_lanes_equal_the_references(reference):
    trace = _trace(1)
    _assert_reference(reference, "cache/chunk77", _engine(
        _mk("cxl-ssd-cache")).run(trace, chunk_size=77))
    _assert_reference(reference, "cache/bounded77", _engine(
        _mk("cxl-ssd-cache")).run(trace, chunk_size=77,
                                  return_latencies=False))


# -------------------------------------------------------------- multihost
def test_multihost_chunked_matches_oneshot():
    traces = [_trace(100 + h, n=160) for h in range(3)]
    res0, lat0 = MultiHostReplay(_multi_targets(), outstanding=8,
                                 **CPU).run_recorded(traces)
    m0 = MultiHostReplay(_multi_targets(), outstanding=8,
                         metrics=MetricsSpec(), **CPU).run(traces)
    for chunk in (1, 7, 8, sum(map(len, traces))):
        res, lat = MultiHostReplay(_multi_targets(), outstanding=8,
                                   **CPU).run_recorded(traces,
                                                       chunk_size=chunk)
        for a, b in zip(lat0, lat):
            assert np.array_equal(a, b), chunk
        for h0, h in zip(res0.per_host, res.per_host):
            assert int(h0.end_tick) == int(h.end_tick), chunk
        mres = MultiHostReplay(_multi_targets(), outstanding=8,
                               metrics=MetricsSpec(), **CPU).run(
            traces, chunk_size=chunk)
        assert _jm(mres.metrics) == _jm(m0.metrics), chunk
        bres = MultiHostReplay(_multi_targets(), outstanding=8,
                               metrics=MetricsSpec(), **CPU).run(
            traces, chunk_size=chunk, return_latencies=False)
        assert _jm(bres.metrics) == _jm(m0.metrics), chunk
        assert bres.elapsed_ticks == m0.elapsed_ticks
        assert [(h.accesses, h.sum_latency_ticks, h.end_tick)
                for h in bres.per_host] == [
            (h.accesses, h.sum_latency_ticks, h.end_tick)
            for h in m0.per_host]


def test_multihost_chunked_equals_the_reference(reference):
    traces = [_trace(100 + h, n=160) for h in range(3)]
    mres, lat = MultiHostReplay(_multi_targets(), outstanding=8,
                                metrics=MetricsSpec(), **CPU).run_recorded(
        traces, chunk_size=7)
    assert reference["multi/chunk7/lat"].tolist() == np.concatenate(
        lat).tolist()
    assert str(reference["multi/chunk7/metrics"]) == _jm(mres.metrics)
    bres = MultiHostReplay(_multi_targets(), outstanding=8,
                           metrics=MetricsSpec(), **CPU).run(
        traces, chunk_size=7, return_latencies=False)
    assert str(reference["multi/bounded7/metrics"]) == _jm(bres.metrics)
    assert reference["multi/bounded7/hosts"].tolist() == [
        [h.accesses, h.elapsed_ticks, h.sum_latency_ticks, h.end_tick]
        for h in bres.per_host] + [[0, bres.elapsed_ticks, 0, 0]]


# ---------------------------------------------------------- replay_stream
@pytest.mark.parametrize("name", DEVICES)
def test_replay_stream_matches_oneshot(name, tmp_path):
    trace = _trace(13)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_mk(name)).run(trace)
    stats = {}
    res = replay_stream(st, _mk(name), chunk_size=77, outstanding=8,
                        metrics=MetricsSpec(), stats=stats, **CPU)
    _assert_same(base, res, name)
    assert stats["chunks"] == -(-len(trace) // 77)
    assert stats["peak_input_bound_bytes"] == 3 * 77 * st.row_bytes
    assert stats["peak_buffered_bytes"] <= stats["peak_input_bound_bytes"]


def test_replay_stream_bounded_output(tmp_path):
    """return_latencies=False: O(buckets) outputs, same metrics."""
    trace = _trace(14)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_qos_target()).run(trace)
    res = replay_stream(st, _qos_target(), chunk_size=64, outstanding=8,
                        metrics=MetricsSpec(), return_latencies=False, **CPU)
    _assert_bounded(base, res)


def test_replay_stream_ecmp_counts_its_route_choices(tmp_path):
    """A fault-free ECMP mount streamed from a store: the route choices
    are hashed chunk by chunk and their counts feed the bundle's ports
    and ``ecmp`` block, equal to the one-shot's, in both output modes."""
    trace = _trace(17)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_ecmp_target("cxl-ssd-cache")).run(trace)
    assert base.metrics.to_jsonable()["ecmp"]
    for lat in (True, False):
        res = replay_stream(st, _ecmp_target("cxl-ssd-cache"),
                            chunk_size=50, outstanding=8,
                            metrics=MetricsSpec(), return_latencies=lat,
                            **CPU)
        (_assert_same if lat else _assert_bounded)(base, res, lat)


def test_replay_stream_transport_faults_exact(tmp_path, reference):
    """Transport fault plans (link-retry + down window + poison) stream
    tick-identically: the hop code is built chunk by chunk, never from
    the whole trace."""
    trace = _trace(15)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_transport_target()).run(trace)
    for chunk in (32, 77, N):
        res = replay_stream(st, _transport_target(), chunk_size=chunk,
                            outstanding=8, metrics=MetricsSpec(), **CPU)
        _assert_same(base, res, chunk)
        if chunk == 32:
            _assert_reference(reference, "transport/stream32", res)


def test_fault_window_at_chunk_seams(tmp_path):
    """A port-down window opening AND closing exactly at a chunk seam
    (window [C, 3C)), replayed at chunk sizes {1, C-1, C, C+1}."""
    C = 40

    def mk():
        tgt = _ecmp_target()
        install(FaultPlan(FaultConfig(down_links=(("s0", "sp0", C, 3 * C),)),
                          seed=3), [tgt])
        return tgt

    trace = _trace(23, n=160)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(mk()).run(trace)
    for chunk in (1, C - 1, C, C + 1):
        res = replay_stream(st, mk(), chunk_size=chunk, outstanding=8,
                            metrics=MetricsSpec(), **CPU)
        _assert_same(base, res, chunk)


def test_replay_stream_nand_faults_ok(tmp_path):
    trace = _trace(16)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_nand_target()).run(trace)
    res = replay_stream(st, _nand_target(), chunk_size=77, outstanding=8,
                        metrics=MetricsSpec(), **CPU)
    _assert_same(base, res)


# ------------------------------------------------- crash-safe checkpoints
class _Crashy:
    """Store wrapper whose chunk iterator dies after ``die_after`` chunks —
    a deterministic stand-in for kill -9 mid-trace."""

    def __init__(self, store, die_after):
        self._s = store
        self.die_after = die_after

    def __getattr__(self, name):
        return getattr(self._s, name)

    def chunks(self, chunk_size, start=0):
        for k, item in enumerate(self._s.chunks(chunk_size, start=start)):
            if k == self.die_after:
                raise RuntimeError("simulated crash")
            yield item


def _stream(store, target, chunk, ck, **kw):
    return replay_stream(store, target, chunk_size=chunk, outstanding=8,
                         metrics=MetricsSpec(), checkpoint_dir=str(ck),
                         checkpoint_every=1, **CPU, **kw)


def test_replay_stream_crash_resume_byte_identical(tmp_path):
    """Kill a checkpointed run mid-trace, resume: latencies, poison flags,
    availability and the MetricsBundle are byte-identical to the
    uninterrupted run, under a transport fault plan, at chunk sizes that
    do and do not divide the trace, in both output modes.  Resume points
    land INSIDE the down window [40, 180)."""
    trace = _trace(24, n=240)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_transport_target()).run(trace)
    resumed_in_window = False
    for chunk, die_after, lat in ((32, 2, True), (32, 4, True),
                                  (80, 1, True), (80, 2, False)):
        ck = tmp_path / f"ck_{chunk}_{die_after}"
        with pytest.raises(RuntimeError, match="simulated crash"):
            _stream(_Crashy(st, die_after), _transport_target(), chunk, ck,
                    return_latencies=lat)
        stats = {}
        res = _stream(st, _transport_target(), chunk, ck, resume=True,
                      stats=stats, return_latencies=lat)
        assert stats["resumed_from"] == chunk * die_after
        resumed_in_window |= 40 < stats["resumed_from"] < 180
        (_assert_same if lat else _assert_bounded)(base, res,
                                                   (chunk, die_after))
    assert resumed_in_window, "no tested resume point fell in the window"


def test_replay_stream_torn_checkpoint_falls_back(tmp_path):
    """A bit-flipped (torn) newest checkpoint is skipped: resume walks
    back to the previous good snapshot and still matches one-shot."""
    trace = _trace(25, n=240)
    st = TraceStore.from_trace(tmp_path / "t.store", trace)
    base = _engine(_transport_target()).run(trace)
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError):
        _stream(_Crashy(st, 4), _transport_target(), 40, ck)
    steps = sorted(int(p.name.split("_")[1]) for p in ck.glob("step_*"))
    assert len(steps) >= 2
    victim = sorted((ck / f"step_{steps[-1]:08d}").glob("*.bin"))[0]
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    stats = {}
    res = _stream(st, _transport_target(), 40, ck, resume=True, stats=stats)
    assert stats["resumed_from"] == steps[-2]
    _assert_same(base, res)


def test_replay_stream_resume_guards(tmp_path):
    st = TraceStore.from_trace(tmp_path / "t.store", _trace(26, n=64))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        replay_stream(st, _mk("dram"), chunk_size=8, resume=True, **CPU)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        replay_stream(st, _mk("dram"), chunk_size=8, checkpoint_every=2,
                      **CPU)
    # resume with no checkpoint on disk is a fresh start
    base = ReplayEngine(_mk("dram"), outstanding=8, **CPU).run(
        _trace(26, n=64))
    stats = {}
    res = replay_stream(st, _mk("dram"), chunk_size=8, outstanding=8,
                        checkpoint_dir=str(tmp_path / "empty"),
                        checkpoint_every=2, resume=True, stats=stats, **CPU)
    assert stats["resumed_from"] == 0 and stats["checkpoints_written"] > 0
    assert res.latency_ticks.tolist() == base.latency_ticks.tolist()
    # a checkpoint of a different trace is refused, typed
    st2 = TraceStore.from_trace(tmp_path / "t2.store", _trace(27, n=32))
    with pytest.raises(ValueError, match="different trace"):
        replay_stream(st2, _mk("dram"), chunk_size=8,
                      checkpoint_dir=str(tmp_path / "empty"), resume=True,
                      **CPU)


def test_replay_stream_refuses_foreign_and_misshapen_snapshots(tmp_path):
    """A snapshot in another format (the JAX package's are format 1) is
    refused, never resumed; a snapshot of another replay configuration
    fails on its leaves, with the reference's wording."""
    from repro_torch.checkpoint import CheckpointManager

    st = TraceStore.from_trace(tmp_path / "t.store", _trace(28, n=64))
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError):
        replay_stream(_Crashy(st, 3), _mk("cxl-ssd-cache"), chunk_size=8,
                      outstanding=8, checkpoint_dir=str(ck),
                      checkpoint_every=1, **CPU)
    mgr = CheckpointManager(ck)
    flat, extra, step = mgr.restore_flat()
    assert extra["format"] == SNAPSHOT_FORMAT
    mgr.save(step + 8, flat, extra={**extra, "format": 1})
    with pytest.raises(ValueError, match="snapshot format 1"):
        replay_stream(st, _mk("cxl-ssd-cache"), chunk_size=8, outstanding=8,
                      checkpoint_dir=str(ck), resume=True, **CPU)
    # another outstanding: the carry's slots no longer fit
    with pytest.raises(ValueError, match="different replay configuration"):
        ReplayEngine(_mk("cxl-ssd-cache"), outstanding=4, **CPU).run_store(
            st, chunk_size=8, resume_state=_decode(flat, extra, st))
    del flat["carry/scan/maps"]
    with pytest.raises(KeyError, match="missing carry leaf"):
        ReplayEngine(_mk("cxl-ssd-cache"), outstanding=8, **CPU).run_store(
            st, chunk_size=8, resume_state=_decode(flat, extra, st))


def _decode(flat, extra, st):
    from repro_torch.core.replay.stream import _decode_snapshot

    return _decode_snapshot(flat, extra, n=st.n, size=st.size)


# ------------------------------------------- bounded-output accumulators
def test_bucket_index_torch_equals_the_references(reference):
    import torch

    v = torch.from_numpy(_bucket_values())
    got = np.stack([M.bucket_index_torch(v, nb).numpy()
                    for nb in range(8, 209)])
    assert np.array_equal(got, reference["buckets"])
    small = v[v < (1 << 53)]
    assert M.bucket_index_torch(small, 208).tolist() == M.bucket_index(
        small.numpy(), 208).tolist()


def test_derived_streaming_oracle(reference):
    """``results/BENCH_replay.json`` ``streaming.derived``: 2000 DRAM
    accesses streamed at chunks 64 and 256 with bounded outputs give the
    pinned sums, and bundles equal to the JAX one-shot's."""
    import tempfile

    a, w = _stream_trace_arrays(2000)
    one = ReplayEngine(make_device("dram"), metrics=MetricsSpec(),
                       **CPU).run_arrays(a, w, return_latencies=False)
    _assert_reference(reference, "derived/oneshot", one)
    with tempfile.TemporaryDirectory() as td:
        store = TraceStore.write(f"{td}/d.store", a, w)
        for chunk in (64, 256):
            stats = {}
            got = replay_stream(store, make_device("dram"), chunk_size=chunk,
                                metrics=MetricsSpec(),
                                return_latencies=False, stats=stats, **CPU)
            assert {k: getattr(got, k) for k in DERIVED} == DERIVED
            assert stats["chunks"] == 2000 // chunk + (2000 % chunk > 0)
            _assert_bounded(one, got, chunk)
            if chunk == 64:
                _assert_reference(reference, "derived/stream64", got)


# ----------------------------------------------------- the golden pins
@pytest.mark.parametrize("name", PINNED)
def test_golden_pins_hold_streamed(name):
    """Each single-host scenario with a ``python_scan`` pin, replayed at
    chunk 64 and at a ragged chunk, equals its pin and its ``metrics``
    block."""
    trace = scenario_trace(name)
    pin = golden(name)
    for chunk in (64, len(trace) // 3 + 1):
        res = ReplayEngine(make_target(name), metrics=MetricsSpec(),
                           outstanding=scenario_outstanding(name),
                           **CPU).run(trace, chunk_size=chunk)
        assert res.latency_ticks.tolist() == pin["python_scan"][
            "latency_ticks"], (name, chunk)
        assert res.metrics.to_jsonable() == pin["metrics"], (name, chunk)


# -------------------------------------------- property tests (hypothesis)
try:
    from hypothesis import given, settings
    from hypothesis import strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @settings(max_examples=8, deadline=None)
    @given(name=hst.sampled_from(DEVICES),
           chunk=hst.sampled_from([1, 8, 0]),
           qos=hst.booleans(), faulty=hst.booleans(),
           want_metrics=hst.booleans(), lat=hst.booleans())
    def test_chunk_parity_property(name, chunk, qos, faulty, want_metrics,
                                   lat):
        trace = _trace(21, n=64)
        chunk = chunk or len(trace)

        def mk():
            tgt = _qos_target() if qos and name == "dram" else _mk(name)
            if faulty and name == "cxl-ssd-cache":
                install(FaultPlan(FaultConfig(nand_read_retry_rate=0.3),
                                  seed=0), [tgt])
            return tgt

        base = _engine(mk(), metrics=want_metrics).run(trace)
        res = _engine(mk(), metrics=want_metrics).run(
            trace, chunk_size=chunk, return_latencies=lat)
        (_assert_same if lat else _assert_bounded)(base, res)
