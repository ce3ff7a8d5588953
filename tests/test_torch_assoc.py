"""The associative lane (``engine="assoc"``) of the port against the
sequential folds, the python lane, the golden pins and the JAX package's
``AssocReplayEngine``.

``busy_until`` and ``port_busy_until`` equal their sequential folds under
hypothesis (int64, ticks near the range the sentinel leaves, gated and
seeded chains); ``_local_sort`` equals a full sort at bounded
displacement.  The solve (torch, on the CPU here) reproduces every
``assoc_supported`` golden pin and equals the python lane; refusals
are the reference's, word for word; and on the main-path trace of
``chip_smoke.py`` (2^20 uniform 64 B accesses over 64 MB, 30% writes,
seed 0) each of dram, cxl-dram and pmem certifies or refuses exactly as
the reference's numpy backend does, which runs in one child process for
this file.  Every comparison is exact.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.devices import DRAMDevice, DRAMTiming, make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.maxplus import NEG
from repro_torch.core.replay import (AssocReplayEngine, busy_until,
                                     port_busy_until)
from repro_torch.core.replay.assoc import _local_sort
from repro_torch.core.replay.spec import ReplayUnsupported, trace_to_arrays
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.core.workloads.traces import make_trace
from test_torch_reference import REPO, golden, run_reference
from torch_scenarios import make_target, scenario_outstanding, scenario_trace

ASSOC_SWEEPS = 256          # tests/golden/scenarios.py's Kleene budget
ASSOC_PINS = [f"{d}@{a}" for d in ("dram", "cxl-dram", "pmem")
              for a in ("direct", "fabric", "stream")
              if not (d == "cxl-dram" and a == "stream")]
MAIN = dict(seed=0, n=1 << 20, pages=16384)       # chip_smoke.py's trace
MAIN_DEVICES = ("dram", "cxl-dram", "pmem")
CPU = dict(torch_device="cpu")

# Refusal cases, one source for both packages.
REFUSALS_SRC = '''
def refusal_cases(AssocReplayEngine, make_device, DRAMDevice, DRAMTiming,
                  Fabric, FaultConfig, FaultPlan, install, kw):
    import numpy as np

    def planned():
        dev = make_device("dram")
        install(FaultPlan(FaultConfig(poison_rate=0.2), seed=1), [dev])
        return dev

    def instant():
        # infinite bandwidth: the media occupies nothing
        return DRAMDevice(timing=DRAMTiming(bw_gbps=float("inf")))

    def fabric():
        return Fabric.build("two_level", num_hosts=2, num_devices=2,
                            num_leaves=2)

    qos = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2,
                       qos_weights={"h0": 2.0, "h1": 1.0})
    ecmp = Fabric.build("spine_leaf", num_hosts=1, num_devices=1,
                        num_leaves=2, num_spines=3, ecmp=True)
    one = [(0, 64, False)]
    # tests/test_replay.py's latency-bound trace (its _trace(82))
    rng = np.random.default_rng(82)
    n = 400
    addrs = rng.integers(0, 48, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < 0.3
    bound = [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]
    return {
        "empty": lambda: AssocReplayEngine(make_device("dram"), **kw).run(
            []),
        "qos_negative_start": lambda: AssocReplayEngine(
            qos.mount("h0", "d0", make_device("dram")), **kw).run(
            one, start_tick=-5),
        "fault_plan": lambda: AssocReplayEngine(planned(), **kw).run(one),
        "cxl-ssd": lambda: AssocReplayEngine(make_device("cxl-ssd"),
                                             **kw).run(one),
        "cxl-ssd-cache": lambda: AssocReplayEngine(
            make_device("cxl-ssd-cache"), **kw).run(one),
        "ecmp": lambda: AssocReplayEngine(
            ecmp.mount("h0", "d0", DRAMDevice()), **kw).run(one),
        "zero_latency": lambda: AssocReplayEngine(instant(), **kw).run(
            one),
        "zero_occupancy": lambda: AssocReplayEngine(
            fabric().mount("h0", "d0", instant()), **kw).run(one),
        "latency_bound": lambda: AssocReplayEngine(
            make_device("cxl-dram"), outstanding=4, **kw).run(bound),
    }
'''


def refusal(fn) -> str:
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return "none"


REFERENCE = '''
import json, sys
sys.path.insert(0, IN["tests"].item())
from golden import scenarios as sc
from repro.core.devices import DRAMDevice, DRAMTiming, make_device
from repro.core.fabric import Fabric
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import AssocReplayEngine, ReplayUnsupported
from repro.core.replay import assoc as A

exec(IN["refusals_src"].item())


def refusal(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__ + ": " + str(e)
    return "none"


for k, fn in refusal_cases(AssocReplayEngine, make_device, DRAMDevice,
                           DRAMTiming, Fabric, FaultConfig, FaultPlan,
                           install, dict(backend="numpy")).items():
    OUT["refuse/" + k] = np.asarray(refusal(fn))
a, w = IN["main_a"], IN["main_w"]
for d in IN["devices"].tolist():
    eng = AssocReplayEngine(make_device(d), backend="numpy")
    try:
        res = eng.run_arrays(a, w)
        OUT["main/" + d] = np.asarray("certified")
        OUT["lat/" + d] = res.latency_ticks
        OUT["sweeps/" + d] = np.asarray(eng._last_sweeps)
        OUT["summary/" + d] = np.asarray([res.elapsed_ticks,
                                          res.sum_latency_ticks, res.end_tick])
    except ReplayUnsupported as e:
        OUT["main/" + d] = np.asarray("ReplayUnsupported: " + str(e))
'''


def main_trace():
    return make_trace(MAIN["seed"], n=MAIN["n"], pages=MAIN["pages"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    a, w, _ = trace_to_arrays(main_trace())
    return run_reference(REFERENCE, tmp_path_factory.mktemp("assoc"), {
        "tests": np.asarray(str(REPO / "tests")),
        "refusals_src": np.asarray(REFUSALS_SRC),
        "main_a": a, "main_w": w,
        "devices": np.asarray(MAIN_DEVICES)})


# ------------------------------------------------------------- primitives
def fold(arr, svc, active=None, init=None):
    free = NEG if init is None else init
    out = []
    for i in range(len(arr)):
        if active is None or active[i]:
            free = max(arr[i], free) + svc[i]
        out.append(free)
    return out


def port_fold(arr, svc, ports, num_ports, init=0):
    free = [init] * num_ports
    out = []
    for a, s, p in zip(arr, svc, ports):
        free[p] = max(a, free[p]) + s
        out.append(free[p])
    return out


ticks = st.integers(0, 1 << 60)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(ticks, st.integers(0, 1 << 40), st.booleans()),
                min_size=1, max_size=60),
       st.one_of(st.none(), st.integers(-(1 << 40), 1 << 60)),
       st.booleans())
def test_busy_until_equals_the_fold(rows, init, gated):
    arr = [r[0] for r in rows]
    svc = [r[1] for r in rows]
    act = [r[2] for r in rows] if gated else None
    got = busy_until(torch.tensor(arr), torch.tensor(svc),
                     None if act is None else torch.tensor(act), init)
    assert got.dtype == torch.int64
    assert got.tolist() == fold(arr, svc, act, init)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 5).flatmap(lambda p: st.tuples(
    st.just(p), st.lists(st.tuples(ticks, st.integers(0, 1 << 40),
                                   st.integers(0, p - 1)),
                         min_size=1, max_size=60))),
       st.integers(0, 1 << 50))
def test_port_busy_until_equals_the_fold(case, init):
    p, rows = case
    arr, svc, ports = (list(x) for x in zip(*rows))
    got = port_busy_until(torch.tensor(arr), torch.tensor(svc),
                          torch.tensor(ports), p, init)
    assert got.tolist() == port_fold(arr, svc, ports, p, init)


def test_busy_until_takes_one_service_for_all_and_a_batch_of_rows():
    arr = torch.tensor([[0, 5, 5, 40], [3, 3, 3, 3]])
    got = busy_until(arr, 10, arr > 2, init=0)
    assert got.tolist() == [fold(r, [10] * 4, [x > 2 for x in r], 0)
                            for r in arr.tolist()]


def test_the_sentinel_does_not_wrap():
    """NEG plus every service of a long inactive run stays far below any
    tick, and torch.cummax on int64 agrees with numpy's accumulate."""
    n = 4096
    svc = torch.full((n,), 1 << 40)
    arr = torch.full((n,), 1 << 61)
    act = torch.zeros(n, dtype=torch.bool)
    act[-1] = True
    got = busy_until(arr, svc, act)
    assert (got[:-1] == NEG).all() and int(got[-1]) == (1 << 61) + (1 << 40)
    x = np.random.default_rng(3).integers(NEG, 1 << 62, 10000)
    assert torch.cummax(torch.from_numpy(x), 0).values.tolist() == \
        np.maximum.accumulate(x).tolist()


def test_local_sort_equals_a_full_sort_at_bounded_displacement():
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(5, 900))
        occ = int(rng.integers(1, 40))
        spread = int(rng.integers(0, 400))
        x = np.arange(n) * occ + rng.integers(0, spread + 1, n)
        block = max(32, 2 * (spread // occ + 1))
        got = _local_sort(torch.from_numpy(x), block)
        assert got.tolist() == np.sort(x).tolist(), (n, occ, spread)


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("name", ASSOC_PINS)
def test_assoc_reproduces_the_pins(name):
    res = AssocReplayEngine(make_target(name),
                            outstanding=scenario_outstanding(name),
                            max_sweeps=ASSOC_SWEEPS,
                            **CPU).run(scenario_trace(name))
    pin = golden(name)["python_scan"]
    assert res.latency_ticks.tolist() == pin["latency_ticks"]
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(res, f) == pin[f], f


def test_the_pins_are_every_assoc_supported_scenario():
    from golden import scenarios as sc

    fixture = sc.load_fixture()["scenarios"]
    assert sorted(ASSOC_PINS) == sorted(n for n in fixture
                                        if sc.assoc_supported(n))


def _assert_equal(py, rp):
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick", "accesses"):
        assert getattr(py, f) == getattr(rp, f), f


@pytest.mark.parametrize("device", ["dram", "pmem"])
def test_assoc_equals_the_python_lane(device):
    """Bandwidth-bound replays (32 outstanding: the regime the drivers are
    sized for) certify and equal the python lane."""
    trace = make_trace(80, n=3000, pages=512)
    for start in (0, 12345):
        py = TraceDriver(make_device(device)).run(trace, start_tick=start)
        rp = AssocReplayEngine(make_device(device), **CPU).run(
            trace, start_tick=start)
        _assert_equal(py, rp)


def test_pmem_row_hits_and_non_posted_writes_are_exact():
    trace = [(i * 64, 64, i % 3 == 0) for i in range(1200)]
    dev = make_device("pmem")
    py = TraceDriver(dev).run(trace)
    rp = AssocReplayEngine(make_device("pmem"), **CPU).run(trace)
    _assert_equal(py, rp)
    assert int(rp.hit_flags.sum()) == dev.stats["row_hits"] > 0
    trace = make_trace(81, n=2000, pages=256, write_frac=0.5)
    _assert_equal(TraceDriver(make_device("dram"),
                              posted_writes=False).run(trace),
                  AssocReplayEngine(make_device("dram"), posted_writes=False,
                                    **CPU).run(trace))


def test_the_driver_dispatches_to_the_assoc_lane():
    trace = make_trace(85, n=2000, pages=256)
    py = TraceDriver(make_device("dram")).run(trace)
    ap = TraceDriver(make_device("dram"), engine="assoc", **CPU).run(trace)
    _assert_equal(py, ap)
    # no silent fallback: a shape it cannot certify is refused
    with pytest.raises(ReplayUnsupported, match="per-access state"):
        TraceDriver(make_device("cxl-ssd"), engine="assoc", **CPU).run(trace)
    with pytest.raises(ReplayUnsupported, match="metrics"):
        TraceDriver(make_device("dram"), engine="assoc", metrics=object())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_the_card_is_the_default_device():
    """Without ``torch_device`` the solve goes to the card, and a host
    without one is refused, never solved on the CPU in its place."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AssocReplayEngine(make_device("dram")).run(
            make_trace(86, n=200, pages=64))


# ------------------------------------------------------------- refusals
def _port_cases(**kw):
    ns = {}
    exec(REFUSALS_SRC, ns)
    return ns["refusal_cases"](AssocReplayEngine, make_device, DRAMDevice,
                               DRAMTiming, Fabric, FaultConfig, FaultPlan,
                               install, kw)


def test_refusals_are_the_reference_s_word_for_word(reference):
    got = {k: refusal(fn) for k, fn in _port_cases(**CPU).items()}
    for k, msg in got.items():
        want = str(reference["refuse/" + k])
        assert want.startswith("ReplayUnsupported: "), (k, want)
        assert msg == want, k


# ------------------------------------------- the main path's certificate
@pytest.mark.parametrize("device", MAIN_DEVICES)
def test_main_path_certifies_or_refuses_as_the_reference(device, reference):
    want = str(reference["main/" + device])
    eng = AssocReplayEngine(make_device(device), **CPU)
    a, w, _ = trace_to_arrays(main_trace())
    if want == "certified":
        res = eng.run_arrays(a, w)
        np.testing.assert_array_equal(res.latency_ticks,
                                      reference["lat/" + device])
        assert eng._last_sweeps == int(reference["sweeps/" + device])
        assert [res.elapsed_ticks, res.sum_latency_ticks, res.end_tick] == \
            reference["summary/" + device].tolist()
    else:
        with pytest.raises(ReplayUnsupported) as err:
            eng.run_arrays(a, w)
        assert f"ReplayUnsupported: {err.value}" == want


def test_the_main_path_outcomes_are_pinned(reference):
    """chip_smoke.py's [assoc] phase holds the card to these outcomes."""
    outcome = {d: str(reference["main/" + d]) == "certified"
               for d in MAIN_DEVICES}
    assert outcome == {"dram": True, "cxl-dram": False, "pmem": True}


def test_an_assoc_refusal_names_the_scan_lane():
    dev = make_device("dram")
    install(FaultPlan(FaultConfig(poison_rate=0.2), seed=1), [dev])
    with pytest.raises(ReplayUnsupported, match=r"\(poison\)"):
        TraceDriver(dev, engine="assoc", **CPU).run(make_trace(1, n=16))
    res = TraceDriver(dev, engine="scan", **CPU).run(make_trace(1, n=16))
    assert json.dumps(res.accesses) == "16"
