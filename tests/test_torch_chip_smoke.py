"""How ``chip_smoke.py`` takes device times from the profiler.

On the card's machine a profiler session now and then records no device
activity at all.  These tests drive the script's timing helpers with a
stand-in profiler on the CPU: a session that records nothing is retried,
a timing that the profiler never records falls back to CUDA events and
says so, and device events are split by kind.  The last tests hold the
script's correctness gates: the spill gate reads a ptxas report on every
run, and the tolerance check fails on any element outside it or NaN.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.profiler
from torch.autograd import DeviceType

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, us, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_time_total=us,
                           device_type=device)


# torch as the helpers see it: only the card's synchronize is called
_TORCH = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))


@pytest.fixture
def sessions(monkeypatch):
    """A stand-in ``torch.profiler.profile`` that hands out the event lists
    of ``sessions.queue`` one per session, and counts the sessions."""
    state = SimpleNamespace(queue=[], opened=0)

    class Profile:
        def __init__(self, **kw):
            state.opened += 1
            self.acts = state.queue.pop(0) if state.queue else []

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [_event("cpu_op", 5.0, DeviceType.CPU)] + self.acts

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    return state


def test_an_empty_profiler_session_is_tried_again(smoke, sessions):
    kernel = _event("cache_sim_kernel", 40.0)
    sessions.queue = [[], [], [kernel]]
    calls = []
    acts = smoke.device_events(_TORCH, lambda: calls.append(1), bool)
    assert acts == [kernel]
    assert sessions.opened == 3 and len(calls) == 3


def test_device_events_give_up_after_the_set_number_of_sessions(
        smoke, sessions):
    sessions.queue = [[]] * 10
    assert smoke.device_events(_TORCH, lambda: None, bool) == []
    assert sessions.opened == smoke.PROFILE_TRIES


def test_a_timing_the_profiler_never_records_falls_back_to_cuda_events(
        smoke, sessions, monkeypatch, capsys):
    sessions.queue = [[_event("other_kernel", 9.0)]] * smoke.PROFILE_TRIES
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, reps=1: 12.0)
    ms = smoke.device_ms(_TORCH, lambda i: None, reps=4,
                         match="flash_decode_kernel")
    assert ms == pytest.approx(3.0)
    assert smoke.EVENT_TIMED == ["flash_decode_kernel"]
    assert "CUDA events" in smoke.timing_note()
    assert "fallback=CUDA events" in capsys.readouterr().out


def test_device_ms_averages_a_named_kernel_over_its_recorded_launches(
        smoke, sessions):
    sessions.queue = [[_event("flash_decode_kernel<4>", 30.0),
                       _event("flash_decode_kernel<4>", 50.0),
                       _event("elementwise", 1000.0)]]
    names = []
    ms = smoke.device_ms(_TORCH, lambda i: None, reps=24,
                         match="flash_decode_kernel", names=names)
    assert ms == pytest.approx(0.040)          # 80 us over 2 launches
    assert names == ["flash_decode_kernel<4>"]
    assert smoke.EVENT_TIMED == []
    assert smoke.timing_note() == "device time per call by torch.profiler"


def test_device_ms_without_a_name_sums_every_device_event_per_call(
        smoke, sessions):
    sessions.queue = [[_event("a", 30.0), _event("Memcpy DtoD", 10.0)]]
    assert smoke.device_ms(_TORCH, lambda i: None, reps=2) == \
        pytest.approx(0.020)


def test_split_by_kind(smoke):
    acts = [_event("flash_attention_kernel", 3000.0),
            _event("sm90_xmma_gemm_f32f32", 2000.0),
            _event("Memset (Device)", 500.0),
            _event("vectorized_elementwise_kernel", 250.0)]
    kinds = smoke.split_by_kind(acts, ("flash_attention_kernel",),
                                "flash_attention")
    assert kinds == {"flash_attention": 3.0, "matmuls": 2.0,
                     "other_kernels": 0.25, "copies": 0.5}


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_attention_kernelILi15ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelILi15ELb1EEEvNS_6ParamsE
    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used 232 registers, 560 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelILi8ELb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


@pytest.mark.parametrize("stores,loads", [(0, 0), (8, 0), (0, 4), (24, 16)])
def test_ptxas_spills_sums_every_kernel_of_the_report(smoke, stores, loads):
    log = PTXAS.format(stores=stores, loads=loads)
    assert smoke.ptxas_spills(log, "flash_attention_kernel") == stores + loads
    # no report, or one of another kernel, is refused, never read as 0
    for other in ("", log.replace("flash_attention", "flash_decode")):
        with pytest.raises(ValueError, match="names no"):
            smoke.ptxas_spills(other, "flash_attention_kernel")


def test_library_built_earlier_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A library found on disk brings the report of the build that made
    it, so the spill gate reads a report on every run."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "build_log", {})
    lib = _build.library_path("flash_attention")
    lib.write_bytes(b"")
    report = PTXAS.format(stores=0, loads=0)
    lib.with_suffix(".ptxas").write_text(report)
    assert _build.build("flash_attention") == lib     # no nvcc: it exists
    assert _build.build_log == {"flash_attention": report}


@pytest.mark.parametrize("case", ["within", "outside", "nan_got", "nan_want"])
def test_close_err_fails_on_any_element_outside_or_nan(smoke, case):
    tol = dict(atol=2e-5, rtol=2e-5)
    want = torch.linspace(-4, 4, 65)        # holds 0, where the share peaks
    got = want + 1e-5                       # share 1e-5 / (2e-5 + 2e-5|w|)
    if case == "outside":
        got[7] += 1e-3
    elif case == "nan_got":
        got[7] = float("nan")
    elif case == "nan_want":
        want = want.clone()
        want[7] = float("nan")
    err, share, ok = smoke.close_err(torch, got, want, tol)
    assert ok == (case == "within")
    if case == "within":
        assert err == pytest.approx(1e-5, rel=1e-2)
        assert share == pytest.approx(0.5, rel=1e-2)
    elif case == "outside":
        assert err > 1e-3 and share > 1
    else:                                   # a NaN reads as inf, not lost
        assert err == float("inf") and share == float("inf")


# ------------------------------------------------------- the fabric phase
def test_golden_pin_reads_the_fabric_scenario(smoke):
    from test_torch_reference import golden

    pin = smoke.golden_pin(smoke.FABRIC_GOLDEN, "pallas")
    assert pin == golden("cxl-ssd-cache@fabric")["pallas"]
    assert pin["latency_ticks"][0] == 7_677_000
    assert smoke.golden_pin(smoke.GOLDEN, "pallas") == \
        golden("cxl-ssd-cache@direct")["pallas"]


def test_refuses_catches_only_the_named_exception(smoke):
    from repro_torch.core.replay.spec import ReplayUnsupported

    def raise_(exc):
        raise exc

    assert smoke.refuses(lambda: raise_(ReplayUnsupported("x")),
                         ReplayUnsupported)
    assert not smoke.refuses(lambda: None, ReplayUnsupported)
    with pytest.raises(KeyError):
        smoke.refuses(lambda: raise_(KeyError("x")), ReplayUnsupported)


def test_the_phase_plan_is_refused_on_its_mount(smoke):
    import numpy as np

    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay.cuda_engine import run_cuda
    from repro_torch.core.replay.spec import ReplayUnsupported

    mount = Fabric.build("two_level", **smoke.FABRIC).mount(
        "h0", "d0", make_device("cxl-ssd-cache"))
    addrs, writes = np.arange(0, 64 * 8, 64), np.zeros(8, bool)
    assert run_cuda(mount, addrs, writes, torch_device="cpu").accesses == 8
    install(FaultPlan(FaultConfig(**smoke.FABRIC_PLAN)), [mount])
    assert smoke.refuses(lambda: run_cuda(mount, addrs, writes,
                                          torch_device="cpu"),
                         ReplayUnsupported)


def test_twin_mismatches_are_zero_and_catch_a_broken_twin(smoke,
                                                          monkeypatch):
    from repro_torch.core.fabric import routing

    values = smoke.twin_values(3, 4096)
    assert values[2] == 2**63 and values[3] == 2**64 - 1
    cpu = torch.device("cpu")
    assert smoke.twin_mismatches(torch, cpu, values, 3) == {
        "flow_choices_torch": 0, "nand_read_retries_torch": 0,
        "erase_fails_torch": 0}
    monkeypatch.setattr(routing, "flow_choices_torch",
                        lambda src, dst, x, n: torch.zeros(
                            x.shape, dtype=torch.int32))
    assert smoke.twin_mismatches(torch, cpu, values, 3)[
        "flow_choices_torch"] > 0


def test_nand_plain_equals_the_scalar_plan(smoke):
    import numpy as np

    from repro_torch.core.faults import FaultConfig, FaultPlan

    plan = FaultPlan(FaultConfig(**smoke.TWIN_NAND), seed=5)
    retries, fails = smoke.nand_plain(plan.nand_statics(),
                                      np.arange(400, dtype=np.uint64))
    assert retries.tolist() == [plan.nand_read_retries(i) for i in range(400)]
    assert fails.tolist() == [plan.erase_fails(i) for i in range(400)]


# --------------------------------------------------------- the scan phase
def test_scan_phase_replays_the_scan_scenarios(smoke):
    from test_torch_scan import SCAN_SCENARIOS

    assert smoke.SCAN_SCENARIOS == SCAN_SCENARIOS
    assert smoke.SCAN_DEVICES == ["dram", "cxl-dram", "pmem", "cxl-ssd",
                                  "cxl-ssd-cache"]
    kinds = {"dram", "pmem", "ssd-buf", "ssd-cache"}
    assert set(smoke.SCAN_ROUND_TRIPS) == kinds == set(smoke.SCAN_OPS)


def test_copy_verdict_separates_two_spreads(smoke, sessions):
    """The page copy against its library call, alternating: each launch's
    device time from one profiler session (our kernel by its name, every
    other kernel the library's), medians, 10th-90th percentile spreads,
    and whether they separate."""
    mine = [_event("scatter_kernel", 10.0 + 0.01 * i) for i in range(20)]
    lib = [_event("index_copy_kernel", 8.0 + 0.01 * i) for i in range(20)]
    sessions.queue = [[e for pair in zip(mine, lib) for e in pair]
                      + [_event("Memcpy DtoH", 1.0)]]
    got = smoke.copy_verdict(_TORCH, "scatter_kernel", lambda i: None,
                             lambda i: None, calls=20)
    assert (got["kernel_launches"], got["library_launches"]) == (20, 20)
    assert got["separate"] and got["faster"] == "library"
    assert got["library"] == "index_copy_kernel"
    assert 10.0 < got["kernel_us_median"] < 10.2
    assert 8.0 < got["library_us_median"] < 8.2
    sessions.queue = [[_event("gather_kernel", 8.0 + (i % 3))
                       for i in range(10)]
                      + [_event("index_select", 8.5 + (i % 3))
                         for i in range(10)]]
    got = smoke.copy_verdict(_TORCH, "gather_kernel", lambda i: None,
                             lambda i: None, calls=10)
    assert not got["separate"]


@pytest.mark.parametrize("device", ["dram", "cxl-dram", "pmem", "cxl-ssd",
                                    "cxl-ssd-cache"])
def test_flag_tap_sees_the_scan_lanes_flags(smoke, device):
    """The python lane's per-access hit and dirty-evict flags, as the tap
    reads them off the device's counters, are the scan lane's."""
    import numpy as np

    from repro_torch.core.devices import make_device
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.core.workloads.traces import make_trace

    # pages enough to fill Table I's 4096 frames, or few, so that caches
    # and page registers hit and evict dirty pages
    cached = device == "cxl-ssd-cache"
    trace = make_trace(2, n=8000 if cached else 3000,
                       pages=6000 if cached else 12)
    tap = smoke.FlagTap(make_device(device))
    want = TraceDriver(tap).run(trace)
    got = ReplayEngine(make_device(device), torch_device="cpu").run(trace)
    assert got.latency_ticks.tolist() == tap.latency
    assert got.hit_flags.tolist() == tap.hit
    assert got.evict_flags.tolist() == tap.evict
    assert got.end_tick == want.end_tick
    if device != "dram" and device != "cxl-dram":
        assert any(tap.hit)
    if device in ("cxl-ssd", "cxl-ssd-cache"):
        assert any(tap.evict)
    assert np.asarray(tap.hit).dtype == bool


def test_scan_row_carries_the_contract_keys(smoke):
    devs = smoke.SCAN_DEVICES
    scan = {"launches": {d: 1 for d in devs},
            "kernel_ms": {d: 2.0 for d in devs},
            "bound": {d: (0.01, "bytes") for d in devs},
            "serial": {d: 1.0 for d in devs},
            "plain_ms": {d: 3.0 for d in devs}}
    faulted = {name: {"launches": 1, "ms": 4.0, "accesses": 1 << 20,
                      "bytes_per_access": 29, "bound_ms": 0.01,
                      "bound_by": "operations", "serial_chain_ms": 1.0,
                      "reads": 10, "column_s": 0.0}
               for name in ("nand", "gc", "link")}
    multi = {name: {"launches": 1, "ms": 5.0, "hosts": 4,
                    "accesses": 1 << 20, "bytes_per_step": 36,
                    "bound_ms": 0.02, "bound_by": "operations",
                    "serial_chain_ms": 2.0, "wall_s": 9.0,
                    "column_s": 0.0}
             for name in ("table1x4", "qos-pool", "down")}
    stream = {"a/32768": {"launches": 37, "kernel_ms": 6.0, "wall_s": 1.0,
                          "host_s": 0.9, "peak_bytes": 10},
              "c/resume": {"launches": 12, "wall_s": 2.0, "peak_bytes": 1}}
    row = smoke.scan_row(scan, faulted, multi, 1 << 20, stream)
    assert row["serial_chain_ms_by_device"] == scan["serial"]
    assert row["multihost"] == multi
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in row, key
    assert row["faulted"] == faulted
    assert row["launches"] == 11 + 49 and row["library_ms"] is None
    assert row["resumable"] is True and row["streamed"] == stream
    assert row["route"] == "cuda"
    assert (REPO / row["source"]).exists()
    path, line = row["replaces"].split(":")
    src = (REPO / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def _scan_chunk")
    path, line = row["multihost_replaces"].split(":")
    src = (REPO / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def _make_multi_step")


def test_scan_churn_trace_fills_table1s_cache(smoke):
    """The twin check's 2^14 accesses of the main path's trace touch more
    pages than Table I's 4096 frames hold, so the cache evicts."""
    from repro_torch.core.workloads.traces import make_trace

    trace = make_trace(0, n=1 << 20, pages=16384)
    pages = {a // 4096 for a, _, _ in trace[:smoke.SCAN_CHURN_ACCESSES]}
    assert len(pages) > 2 * 4096


def test_scan_phase_runs_after_the_serving_and_prefill_paths(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("serve_phase(") < src.index("prefill_phase(")
            < src.index("scan_phase("))


# -------------------------------------------- the faults and assoc phases
def test_faults_and_assoc_phases_run_after_the_scan_phase(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("scan_phase(") < src.index("faults_phase(")
            < src.index("assoc_phase(") < src.index('{"kernels"'))


def test_the_phases_take_the_tests_constants(smoke):
    from test_torch_assoc import ASSOC_PINS, ASSOC_SWEEPS
    from test_torch_faults_scan import GC_TRACE

    assert smoke.FAULT_GC_TRACE == GC_TRACE
    assert smoke.ASSOC_SWEEPS == ASSOC_SWEEPS
    assert list(smoke.ASSOC_DEVICES) == ["dram", "cxl-dram", "pmem"]
    assert sorted(f"{d}@{a}" for d in smoke.ASSOC_DEVICES
                  for a in ("direct", "fabric", "stream")
                  if (d, a) != ("cxl-dram", "stream")) == sorted(ASSOC_PINS)


@pytest.mark.parametrize("case", ["nand", "link"])
def test_flag_tap_sees_the_faulted_lanes_flags(smoke, case):
    """Under the faults phase's plans (a short trace, the down window
    moved into it), the tap's python lane gives the scan lane's latencies,
    hit, dirty-evict and poison flags, metrics and availability."""
    import json

    import numpy as np

    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay import metrics as M
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.workloads.traces import make_trace

    def make():
        if case == "nand":
            dev = make_device("cxl-ssd-cache")
            install(FaultPlan(FaultConfig(**smoke.FAULT_NAND),
                              seed=smoke.FAULT_NAND_SEED), [dev])
            return dev
        mount = Fabric.build("spine_leaf", **smoke.FAULT_FABRIC).mount(
            "h0", "d0", make_device("cxl-ssd-cache"))
        install(FaultPlan(FaultConfig(
            **dict(smoke.FAULT_LINK, down_links=(("s0", "sp0", 500, 900),))),
            seed=smoke.FAULT_LINK_SEED), [mount])
        return mount

    trace = make_trace(6, n=3000, pages=6000)
    want, bundle, tap = smoke.python_lane(make(), trace)
    got = ReplayEngine(make(), metrics=M.MetricsSpec(),
                       torch_device="cpu").run(trace)
    assert got.latency_ticks.tolist() == tap.latency
    assert got.hit_flags.tolist() == tap.hit
    assert got.evict_flags.tolist() == tap.evict
    assert json.dumps(got.metrics.to_jsonable()) == json.dumps(
        bundle.to_jsonable())
    if case == "nand":
        assert got.poison_flags.tolist() == tap.poison and any(tap.poison)
    else:
        assert any(tap.degraded) and any(tap.failover)
        avail = M.availability_series(
            np.asarray(tap.issue), np.asarray(tap.issue)
            + np.asarray(tap.latency), np.asarray(tap.degraded),
            np.asarray(tap.failover), spec=M.MetricsSpec())
        assert got.availability == avail


def test_fault_bound_adds_the_fault_terms(smoke):
    from repro_torch.core.replay.spec import StackConfig

    base = dict(kind="ssd-cache", outstanding=32, posted_writes=True,
                num_hops=4, num_ports=6, num_pages=16384, cache_frames=4096)
    n = 1 << 20
    clean = smoke.fault_bound(
        {"cfg": StackConfig(**base), "accesses": n, "reads": 1000},
        smoke.INT32_LANES_PER_SM * 132 * 1980e6, 23.0, 1980.0)
    link = smoke.fault_bound(
        {"cfg": StackConfig(**base, fault_hops=True), "accesses": n,
         "reads": 1000}, smoke.INT32_LANES_PER_SM * 132 * 1980e6, 23.0,
        1980.0)
    nand = smoke.fault_bound(
        {"cfg": StackConfig(**base, faults=(0, 1, 2, 3)), "accesses": n,
         "reads": 1000}, smoke.INT32_LANES_PER_SM * 132 * 1980e6, 23.0,
        1980.0)
    assert clean["bytes_per_access"] == nand["bytes_per_access"] == 29
    assert link["bytes_per_access"] == 29 + 4 + 4
    assert link["serial_chain_ms"] > clean["serial_chain_ms"]
    assert nand["int64_ops"] == clean["int64_ops"] + 13 * 1000
    assert nand["serial_chain_ms"] > clean["serial_chain_ms"]


# ------------------------------------------------------- the multihost phase
def test_multihost_phase_runs_last(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("assoc_phase(") < src.index("multihost_phase(")
            < src.index('{"kernels"'))


def test_the_multihost_phase_takes_the_scenarios_constants(smoke):
    import torch_scenarios as ts

    assert sorted(smoke.MULTI_SCENARIOS) == sorted(
        ["multihost-qos-ecmp", *ts.MULTI_SSD_HOSTS, *ts.MULTI_FAULT_HOSTS])
    qos = dict(smoke.MULTI_QOS)
    assert qos.pop("qos_weights") == ts.MULTI["qos_weights"]
    assert qos["num_hosts"] == ts.MULTI["num_hosts"]
    # the golden down window over accesses 20-90 of 160, and its seed
    tgts = ts.make_multi_targets("faults-portdown@multihost_x2")
    plan = tgts[0].fault_plan
    u, v, lo, hi, of = smoke.MULTI_DOWN_WINDOW
    assert plan.config.down_links == ((u, v, lo, hi),) and of == 160
    assert plan.seed == smoke.MULTI_DOWN_SEED
    cases = smoke.multi_cases(0, 1 << 18)
    assert [len(t) for t in cases["qos-pool"][1]] == [349526, 349525,
                                                       349525]
    down = cases["down"][0]()[0].fault_plan
    assert down.config.down_links == (("s0", "sp0", 32768, 147456),)


# ------------------------------------------------------- the stream phase
def test_stream_phase_runs_after_the_multihost_phase(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("multihost_phase(") < src.index("stream_phase(")
            < src.index('{"kernels"'))
    assert "chunk_size" not in inspect.getsource(smoke.scan_phase)


def test_stream_phase_takes_the_benchmarks_trace_and_oracle(smoke):
    from test_torch_stream import DERIVED, _stream_trace_arrays

    for got, want in zip(smoke.stream_trace_arrays(5000),
                         _stream_trace_arrays(5000)):
        assert np.array_equal(got, want)
    assert smoke.STREAM_N == 1_200_000 and smoke.STREAM_DEPTH == 2
    assert smoke.STREAM_CHUNKS == (32768, 131072)
    assert smoke.STREAM_ORACLE == {"sum_latency_ticks": 127862809067,
                                   "end_tick": 3999680000}
    assert set(DERIVED) == set(smoke.STREAM_ORACLE)


def test_stream_phase_cases_exercise_their_seams(smoke):
    """(c) resumes from 4 x 2^14; (d) has seams inside its down window;
    (e) replays 2^18 steps in 16 launches."""
    c = smoke.STREAM_CRASH
    assert c["die_after"] // c["every"] * c["every"] * c["chunk"] == 4 << 14
    d = smoke.STREAM_LINK
    lo, hi = d["window"]
    assert any(lo < k * d["chunk"] < hi for k in range(1, 22))
    assert (lo, hi) == (1 << 14, 1 << 15) and d["accesses"] == 1 << 16
    e = smoke.STREAM_MULTI
    make, traces = smoke.multi_cases(0, e["per_host"])["table1x4"]
    steps = sum(len(t) for t in traces)
    assert -(-steps // e["chunk"]) == 16


def test_crashy_store_dies_after_its_chunks(smoke, tmp_path):
    from repro_torch.data import TraceStore

    store = TraceStore.write(tmp_path / "s", np.arange(10) * 64,
                             np.zeros(10, bool))
    crashy = smoke.Crashy(store, 2)
    assert crashy.n == 10
    it = crashy.chunks(3)
    assert [next(it)[0], next(it)[0]] == [0, 3]
    with pytest.raises(RuntimeError, match="simulated crash"):
        next(it)


def test_same_replay_sees_every_field(smoke):
    """On the twin, a chunked replay equals its one-shot on every field the
    phase compares, and a broken latency, flag or bundle is seen."""
    from repro_torch.core.devices import make_device
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.workloads.traces import make_trace

    trace = make_trace(2, n=600, pages=64)

    def run(**kw):
        return ReplayEngine(make_device("cxl-ssd-cache"),
                            metrics=MetricsSpec(),
                            torch_device="cpu").run(trace, **kw)

    one = run()
    same = smoke.same_replay(run(chunk_size=77), one)
    assert all(same.values()) and set(same) == {"ticks", "metrics",
                                                "latency", "flags"}
    bounded = smoke.same_replay(run(chunk_size=77, return_latencies=False),
                                one, bounded=True)
    assert all(bounded.values()), bounded
    broken = run(chunk_size=77)
    broken.latency_ticks[5] += 1
    broken.hit_flags[3] = not broken.hit_flags[3]
    same = smoke.same_replay(broken, one)
    assert not same["latency"] and not same["flags"]


@pytest.mark.parametrize("case", ["table1x4", "qos-pool", "down"])
def test_multi_python_lane_equals_the_twin_on_every_field(smoke, case):
    """At 300 accesses a host, the phase's python lane with its taps and
    its field-by-field comparison hold the multi-host twin equal; the
    bound and model count this run's lane switches and weighted hops."""
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay

    make, traces = smoke.multi_cases(3, 300)[case]
    eng = MultiHostReplay(make(), outstanding=32, metrics=MetricsSpec(),
                          torch_device="cpu")
    res = eng.run(traces)
    want, bundle, taps = smoke.multi_python_lane(make(), traces)
    same = smoke.multi_same(res, want, bundle, taps)
    assert all(same.values()), same
    assert ("availability" in same) == (case == "down")
    # a broken latency is seen
    res.per_host[1].latency_ticks[7] += 1
    assert not smoke.multi_same(res, want, bundle, taps)["latency"]
    prep = eng.prepare(traces)
    who = np.concatenate([np.full(int(n), i) for i, n in
                          enumerate(prep.lens)])      # any order of hosts
    b = smoke.multi_bound(torch, prep, who, 0,
                          smoke.INT32_LANES_PER_SM * 132 * 1980e6, 23.0,
                          1980.0)
    assert b["bytes_per_step"] == 36 + (8 if case == "down" else 0)
    assert b["lane_switches"] >= prep.cfg.num_hosts
    assert (b["weighted_hops"] > 0) == (case == "qos-pool")
    assert b["serial_chain_ms"] > 0 and b["bound_ms"] > 0
    if case == "down":
        f = res.metrics.faults
        assert f["degraded_accesses"] > 0 and f["failovers"] > 0
    if case == "table1x4":
        assert any(any(t.hit) for t in taps)


# -------------------------------------------------------- the sweep phase
def _sweep_lines(smoke, **override):
    """A run's ``[sweep]`` lines with every lane check equal, and the
    checks ``override`` names replaced by their lines (None drops one)."""
    lines = ["[sweep] sweep=cache lanes=128 waves=1 launches=1"]
    for name in smoke.SWEEP_CHECKS:
        same = override.get(name, {"latency": True, "flags": True})
        if same is not None:
            lines.append(smoke.sweep_check_line(name, same))
    return lines


def test_sweep_phase_runs_after_the_stream_phase(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("stream_phase(") < src.index("sweep_phase(")
            < src.index('{"kernels"'))
    phase = inspect.getsource(smoke.sweep_phase)
    # the entry points a user calls, each sweep one launch
    for fn in ("cache_design_sweep(", "host_count_sweep(",
               "fault_seed_sweep("):
        assert f"sw.{fn}" in phase, fn
    assert "torch_device=\"cpu\"" not in phase


def test_sweep_lines_pass_when_every_lane_check_is_equal(smoke):
    assert smoke.sweep_failures(_sweep_lines(smoke)) == []
    line = smoke.sweep_check_line("cache/first", {"latency": True,
                                                  "frames": True})
    assert line == "[sweep] check=cache/first fields=latency,frames " \
                   "differ=none"


@pytest.mark.parametrize("name", ["cache/first", "cache/twin", "hosts/3",
                                  "oracle/x8", "seeds/15",
                                  "overfill/refused"])
def test_sweep_lines_fail_on_a_missing_or_unequal_lane_check(smoke, name):
    missing = smoke.sweep_failures(_sweep_lines(smoke, **{name: None}))
    assert missing == [f"{name}: missing"]
    unequal = smoke.sweep_failures(_sweep_lines(
        smoke, **{name: {"latency": True, "flags": False}}))
    assert unequal == [f"{name}: ['flags']"]
    twice = _sweep_lines(smoke)
    twice.append(smoke.sweep_check_line(name, {"latency": True}))
    assert smoke.sweep_failures(twice) == [f"{name}: ['none', 'none']"]


def test_the_sweep_phase_takes_its_shapes(smoke):
    """128 cache lanes (8 capacities from 256 to Table I's 4096 frames x
    LRU / FIFO x 8 read times); host counts 1-4 of the four Table I
    mounts; 16 seeds with the checked lanes among them."""
    from repro_torch.core.devices import make_device

    caps = smoke.SWEEP_CAPS
    assert len(caps) * 2 * len(smoke.SWEEP_READ_T) == 128
    frames = make_device("cxl-ssd-cache").cache.cfg.capacity_pages
    assert frames == 4096 and (min(caps), max(caps)) == (256, frames)
    assert 4 in smoke.SWEEP_READ_T          # the device's own read_t
    assert set(smoke.SWEEP_TWIN["caps"]) <= set(caps)
    assert set(smoke.SWEEP_TWIN["read_t"]) <= set(smoke.SWEEP_READ_T)
    assert smoke.SWEEP_HOSTS == (1, 2, 3, 4) == tuple(
        range(1, smoke.MULTI_HOSTS + 1))
    assert all(0 <= s < smoke.SWEEP_SEEDS for s in smoke.SWEEP_SEED_CHECKED)
    assert len(smoke.SWEEP_CHECKS) == len(set(smoke.SWEEP_CHECKS))
    path, line = smoke.SWEEP_REPLACES.split(":")
    src = (REPO / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("@functools.partial(jax.jit")
    assert src[int(line)].startswith("def _run_cache_lanes")


def test_the_seed_sweeps_targets_fail_over_and_retry(smoke):
    """The down window scaled into a short trace still degrades accesses
    (failovers) and draws CRC retries, in every seed's lane."""
    from repro_torch.core.replay import sweep as sw
    from repro_torch.core.workloads.traces import make_trace

    n = 1 << 10
    traces = [make_trace(7 + i, n=n, pages=16384)
              for i in range(smoke.MULTI_DOWN["num_hosts"])]
    lanes = sw.fault_seed_sweep(lambda s: smoke.sweep_down_targets(s, n),
                                traces, [0, 1], torch_device="cpu")
    for lane in lanes:
        assert lane["fault_stats"]["failovers"] > 0
        assert lane["fault_stats"]["link_retries"] > 0
    assert lanes[0]["fault_stats"] != lanes[1]["fault_stats"]


def test_scan_row_carries_the_sweeps(smoke):
    devs = smoke.SCAN_DEVICES
    scan = {"launches": {d: 1 for d in devs},
            "kernel_ms": {d: 2.0 for d in devs},
            "bound": {d: (0.01, "bytes") for d in devs},
            "serial": {d: 1.0 for d in devs},
            "plain_ms": {d: 3.0 for d in devs}}
    run = {"launches": 1, "lanes": 128, "waves": 1, "ms": 2000.0,
           "wall_s": 3.0, "standalone_ms": [1650.0] * 4,
           "serial_ms": 128 * 1650.0, "bound_ms": 0.01, "column_s": 0.0,
           "timing": "profiler"}
    sweeps = {name: dict(run) for name in ("cache", "hosts", "seeds")}
    row = smoke.scan_row(scan, {}, {}, 1 << 20, {}, sweeps)
    assert row["launches"] == 5 + 3
    assert set(row["sweeps"]) == {"cache", "hosts", "seeds"}
    assert "timing" not in row["sweeps"]["cache"]
    assert row["sweep_kernels"] == ["replay_sweep_kernel",
                                    "replay_multi_sweep_kernel"]


# --------------------------------------------------------------- the fleet
def test_fleet_phase_runs_after_the_sweep_phase(smoke):
    import inspect

    src = inspect.getsource(smoke.main)
    assert (src.index("sweep_phase(") < src.index("fleet_phase(")
            < src.index('{"kernels"') < src.index("fleet_row(fleet)"))
    phase = inspect.getsource(smoke.fleet_phase)
    # the entry points a user calls, on the card
    for call in ("ShardedMultiHostReplay(", ".run_arrays(",
                 "host_count_sweep(", "sharded=True", "host_trace_torch"):
        assert call in phase or call in inspect.getsource(
            smoke.fleet_columns), call
    assert "reset_launches()" in phase


def test_the_fleet_phase_takes_the_benchmarks_oracle(smoke):
    import json

    oracle = json.loads((REPO / "results" / "BENCH_replay.json").read_text())[
        "fleet"]
    assert oracle["fabric"]["num_pods"] == smoke.FLEET_PODS
    assert (oracle["elapsed_ticks"], oracle["sum_latency_ticks"],
            oracle["p50_ticks"], oracle["p99_ticks"]) == (
        102596666, 52350937828, 655359, 655359)
    assert smoke.FLEET_SHARDS == (1, 2, 4, 8, 16)
    assert smoke.FLEET_PIN_SHARDS == (1, 2, 4, 8)
    assert max(smoke.FLEET_SWEEP) == oracle["hosts"]
    path, line = smoke.FLEET_REPLACES.split(":")
    src = (REPO / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def _body")


def test_the_fleet_mounts_are_the_benchmarks(smoke):
    tgts = smoke.fleet_mounts(64, smoke.FLEET_PODS)
    fab = tgts[0].fabric
    assert len(tgts) == 64 and len(fab.ports) == 320
    assert [t.host for t in tgts[:2]] == ["h0", "h1"]
    big = smoke.fleet_mounts(smoke.FLEET_BIG["hosts"],
                             smoke.FLEET_BIG["pods"])
    assert len(big[0].fabric.ports) == 2176


def test_the_fleets_big_case_refuses_one_cta_and_fits_its_shards(smoke):
    from repro_torch.core.replay import MultiHostReplay
    from repro_torch.kernels import replay_scan as rs

    big = smoke.FLEET_BIG
    a = np.zeros((big["hosts"], 2), np.int64)
    prep = MultiHostReplay(smoke.fleet_mounts(big["hosts"], big["pods"]),
                           outstanding=8,
                           torch_device="cpu").prepare_arrays(a, a > 0)
    with pytest.raises(ValueError, match="B of shared memory"):
        rs.layout_multi(prep.cfg, prep.params, 232448)
    for shards in smoke.FLEET_BIG_SHARDS:
        assert rs.layout_multi(prep.cfg, prep.params, 232448,
                               shards=shards).smem_bytes <= 232448


def test_ptxas_registers_reads_each_instance(smoke):
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_Z{k}replay_sharded_"
        f"kernelILi{k}E' for 'sm_90a'\nptxas info    : Function properties "
        f"for _Z{k}replay_sharded_kernelILi{k}E\n    0 bytes stack frame, 0 "
        f"bytes spill stores, 0 bytes spill loads\nptxas info    : Used "
        f"{200 + k} registers, used 1 barriers" for k in range(3))
    assert smoke.ptxas_registers(log, "replay_sharded_kernel") == [
        200, 201, 202]
    assert smoke.ptxas_spills(log, "replay_sharded_kernel") == 0
    assert smoke.ptxas_registers(log, "replay_multi_kernel") == []


def test_same_results_sees_latencies_fields_and_metrics(smoke):
    from repro_torch.core.replay import MetricsSpec, MultiHostReplay
    from torch_scenarios import shard_case

    def run():
        tgts, trs = shard_case("shard/multipod-8")
        return MultiHostReplay(tgts, outstanding=8, metrics=MetricsSpec(),
                               torch_device="cpu").run(trs)

    a, b = run(), run()
    assert smoke.same_results(a, b)
    b.per_host[3].latency_ticks[5] += 1
    assert not smoke.same_results(a, b)


def test_fleet_row_carries_the_contract_keys(smoke):
    run = {"launches": 1, "ms": 40.0, "timing": "profiler", "wall_s": 0.4,
           "steps": 102400, "shards": 8, "bound_ms": 0.01,
           "bound_by": "operations", "serial_chain_ms": 10.0,
           "bytes_per_step": 36}
    fleet = {"one-cta": dict(run, shards=None), "D1": dict(run, shards=1),
             "D8": run, "x512-D8": dict(run, steps=32768),
             "sweep": {"launches": 3, "wall_s": 1.0},
             "twin": {"plain_ms": 90.0, "steps": 1200, "launches": 0},
             "registers": [240, 250]}
    row = smoke.fleet_row(fleet)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in row, key
    assert row["launches"] == 1 + 1 + 1 + 3   # the one-CTA instance apart
    assert row["library_ms"] is None and row["route"] == "cuda"
    assert row["ms"] == 40.0 and row["plain_ms"] == 90.0
    assert set(row["ms_by_case"]) == {"one-cta", "D1", "D8", "x512-D8"}
    assert (REPO / row["source"]).exists()
