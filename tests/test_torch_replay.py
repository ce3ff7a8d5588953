"""The port's kernel lane (``engine="cuda"``) against the JAX package's
``engine="pallas"``.

On the CPU the lane runs the fused kernel's plain version
(``torch_device="cpu"``).  The reference lane imports only with the alias of
``test_torch_reference.run_reference``, so it runs in one child process for
this file.  Latencies, flags and ticks are integers: every comparison is
exact, field by field.
"""

import json

import numpy as np
import pytest

from golden import scenarios as sc
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.replay.cuda_engine import cuda_params, run_cuda
from repro_torch.core.replay.spec import ReplayUnsupported
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from repro_torch.core.workloads.traces import hash_seed, make_trace
from test_torch_reference import golden, run_reference
import torch_scenarios as sc_port

POLICIES = ("lru", "fifo", "direct")
FRAMES = 64
SMALL_CACHE = dict(capacity_bytes=FRAMES * 4096, mshr_entries=4,
                   writeback_buffer=2)
N = 2000
OUTSTANDING = 16
START_TICK = 5000
FIELDS = ("latency_ticks", "hit_flags", "evict_flags", "elapsed_ticks",
          "sum_latency_ticks", "end_tick")
# int32-ns overflow with a short trace: a 1 MB/s cache DRAM makes every
# fill occupy the fill path for ~4 ms
SLOW_FILL = dict(capacity_bytes=16 * 4096, dram_bw_gbps=0.001)

REFERENCE = f"""
import json
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import make_device
from repro.core.replay.metrics import MetricsSpec
from repro.core.replay.pallas_engine import pallas_params, run_pallas
from repro.core.workloads.driver import TraceDriver

def cached(**kw):
    return make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(**kw))

a, w = IN["addrs"], IN["writes"]
for pol in {POLICIES!r}:
    res = run_pallas(cached(policy=pol, **{SMALL_CACHE!r}), a, w,
                     outstanding={OUTSTANDING}, start_tick={START_TICK},
                     validate=True)
    for f in {FIELDS!r}:
        OUT[pol + "/" + f] = np.asarray(getattr(res, f))
    for size, kw in (("table1", {{}}), ("golden", {sc.CACHE_KW!r})):
        OUT["params/" + pol + "/" + size] = np.asarray(json.dumps(
            pallas_params(cached(policy=pol, **kw), 0.5)))

trace = [(int(x), 64, bool(y)) for x, y in zip(a, w)]
res = TraceDriver(cached(policy="lru", **{SMALL_CACHE!r}), outstanding=8,
                  engine="pallas").run(trace)
OUT["driver"] = np.asarray([res.elapsed_ticks, res.sum_latency_ticks,
                            res.end_tick, res.accesses, res.bytes_moved])

def refusal(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return "none"

OUT["refuse/policy"] = np.asarray(refusal(lambda: run_pallas(
    cached(policy="2q"), a[:8], w[:8])))
OUT["refuse/device"] = np.asarray(refusal(lambda: run_pallas(
    make_device("dram"), a[:8], w[:8])))
OUT["refuse/overflow"] = np.asarray(refusal(lambda: run_pallas(
    cached(**{SLOW_FILL!r}), a[:600], w[:600])))
OUT["refuse/page"] = np.asarray(refusal(lambda: run_pallas(
    cached(), np.asarray([2**43]), np.asarray([False]))))
OUT["refuse/metrics"] = np.asarray(refusal(lambda: TraceDriver(
    cached(), engine="pallas", metrics=MetricsSpec())))
"""


@pytest.fixture(scope="module")
def trace():
    rng = np.random.default_rng(2024)
    addrs = rng.integers(0, 4 * FRAMES, N) * 4096 + rng.integers(0, 64, N) * 64
    return addrs.astype(np.int64), rng.random(N) < 0.3


@pytest.fixture(scope="module")
def reference(trace, tmp_path_factory):
    addrs, writes = trace
    return run_reference(REFERENCE, tmp_path_factory.mktemp("replay"),
                         {"addrs": addrs, "writes": writes})


def _cached(**kw):
    return make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(**kw))


@pytest.mark.parametrize("engine", ["cuda", "pallas"])
def test_golden_pallas_pin(engine):
    name = "cxl-ssd-cache@direct"
    res = TraceDriver(_cached(policy="lru", **sc.CACHE_KW),
                      outstanding=sc.OUTSTANDING, engine=engine,
                      torch_device="cpu").run(make_trace(hash_seed(name)))
    pin = golden(name)["pallas"]
    assert res.latency_ticks.tolist() == pin["latency_ticks"]
    assert res.latency_ticks[0] == 7_677_000
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(res, f) == pin[f], f


@pytest.mark.parametrize("policy", POLICIES)
def test_run_cuda_equals_run_pallas(policy, trace, reference):
    addrs, writes = trace
    res = run_cuda(_cached(policy=policy, **SMALL_CACHE), addrs, writes,
                   outstanding=OUTSTANDING, start_tick=START_TICK,
                   validate=True, torch_device="cpu")
    for f in FIELDS:
        got, want = np.asarray(getattr(res, f)), reference[f"{policy}/{f}"]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert res.accesses == N and res.bytes_moved == 64 * N
    assert 0 < res.hits < N


def test_driver_lane_equals_reference_driver(trace, reference):
    addrs, writes = trace
    rows = [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]
    res = TraceDriver(_cached(policy="lru", **SMALL_CACHE), outstanding=8,
                      engine="cuda", torch_device="cpu").run(rows)
    assert [res.elapsed_ticks, res.sum_latency_ticks, res.end_tick,
            res.accesses, res.bytes_moved] == reference["driver"].tolist()


@pytest.mark.parametrize("size", ["table1", "golden"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_params_equal_pallas_params(policy, size, reference):
    kw = {} if size == "table1" else sc.CACHE_KW
    got = cuda_params(_cached(policy=policy, **kw), 0.5)
    assert got == json.loads(str(reference[f"params/{policy}/{size}"]))


def test_refusals_mirror_the_reference(trace, reference):
    addrs, writes = trace
    cases = {
        "policy": lambda: run_cuda(_cached(policy="2q"), addrs[:8],
                                   writes[:8], torch_device="cpu"),
        "device": lambda: run_cuda(make_device("dram"), addrs[:8],
                                   writes[:8], torch_device="cpu"),
        "overflow": lambda: run_cuda(_cached(**SLOW_FILL), addrs[:600],
                                     writes[:600], torch_device="cpu"),
        "page": lambda: run_cuda(_cached(), np.asarray([2**43]),
                                 np.asarray([False]), torch_device="cpu"),
        "metrics": lambda: TraceDriver(_cached(), engine="cuda",
                                       metrics=object(), torch_device="cpu"),
    }
    for case, fn in cases.items():
        assert str(reference[f"refuse/{case}"]) == "ReplayUnsupported", case
        with pytest.raises(ReplayUnsupported):
            fn()


def test_cuda_lane_refuses_uncached_devices_by_name():
    with pytest.raises(ReplayUnsupported, match="engine='python'"):
        TraceDriver(make_device("cxl-ssd"), engine="cuda",
                    torch_device="cpu").run([(0, 64, False)])


@pytest.mark.parametrize("engine,chunk", [("scan", 64)])
def test_multi_host_scan_lane_and_its_streaming_hold_the_pin(engine, chunk):
    """The fused multi-host replay runs (here its twin, on a multi-host
    fault scenario, equal to the golden pin), and so does its streaming
    half, chunk by chunk."""
    name = "faults-portdown@multihost_x2"
    res = MultiHostDriver(sc_port.make_multi_targets(name), outstanding=8,
                          engine=engine, torch_device="cpu").run(
        sc_port.multi_traces(name))
    want = [pin["latency_ticks"] for pin in golden(name)["python_scan"]]
    assert [r.latency_ticks.tolist() for r in res.per_host] == want
    from repro_torch.core.replay.multihost import MultiHostReplay
    _, lat = MultiHostReplay(sc_port.make_multi_targets(name), outstanding=8,
                             torch_device="cpu").run_recorded(
        sc_port.multi_traces(name), chunk_size=chunk)
    assert [x.tolist() for x in lat] == want


def test_empty_trace_takes_the_python_lane():
    res = TraceDriver(_cached(), engine="cuda").run([])
    assert (res.accesses, res.elapsed_ticks, res.sum_latency_ticks) == (0, 0, 0)
