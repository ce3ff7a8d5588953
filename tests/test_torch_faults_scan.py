"""The faulted scan lane on the CPU, where ``engine="scan"`` runs the
``replay_scan`` kernel's plain twin, against the golden pins, the python
lane and the JAX package's ``ReplayEngine``.

The three single-host golden fault scenarios reproduce their
``python_scan`` pins and ``metrics`` blocks.  On them and on the faulted
mounts of ``torch_scenarios.FAULT_CASES`` (NAND read retries with GC
retirement on both flash devices, down windows that reroute an ECMP set
onto a longer failover path, a CXL-DRAM's private hop, weighted QoS ports
under CRC retries), the
per-access latencies, hit, dirty-evict and poison flags, the availability
series, the fault counters, the GC runs and the metrics bundles equal the
reference engine's; the reference runs in one child process for this
file.  The kernel's compact transport code (a path table, a path id and
one retry byte a hop) expands back to the reference's five hop columns.
Every comparison is exact.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.devices import make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay import stack
from repro_torch.core.replay.engine import ReplayEngine, expand_fault_codes
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.spec import ReplayUnsupported, trace_to_arrays
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.core.workloads.traces import make_trace
from repro_torch.kernels import replay_scan as rs
from test_torch_reference import REPO, golden, run_reference
from torch_scenarios import (FAULT_CASES, FAULT_CASES_SRC, FAULT_SCENARIOS,
                             fault_case, make_target, scenario_outstanding,
                             scenario_trace)

OUTSTANDING = 8
BLOCK_SIZE = 8          # tests/golden/scenarios.py's blocked-scan width
TRANSPORT = ["faults-linkretry@spine_leaf", "faults-portdown-failover@mesh",
             "link/cxl-dram", "down-ecmp/dram", "qos-retry/cxl-ssd-cache",
             "qos-retry-fixed/pmem"]
ALL = list(FAULT_SCENARIOS) + FAULT_CASES
# the GC trace of chip_smoke.py's [faults] phase on the golden
# faults-nand-retry@direct device: the longest power-of-two seeded trace
# the python lane finishes (2^13 accesses run out of space)
GC_TRACE = dict(seed=24, n=1 << 12, pages=16)


def target_and_trace(name):
    if name in FAULT_SCENARIOS:
        return make_target(name), scenario_trace(name)
    return fault_case(name)


REFERENCE = '''
import json, sys
sys.path.insert(0, IN["tests"].item())
exec(IN["cases_src"].item())
from golden import scenarios as sc
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import make_device
from repro.core.fabric import Fabric
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import ReplayEngine
from repro.core.replay import engine as E
from repro.core.replay.metrics import MetricsSpec
from repro.core.ssd.hil import SSDConfig
from repro.core.ssd.pal import NANDTiming


def target(name):
    if "@" in name:
        return sc.make_target(name)
    return make_fault_case(name, make_device, Fabric, DRAMCacheConfig,
                           FaultConfig, FaultPlan, install, SSDConfig,
                           NANDTiming)


def plan_of(dev):
    plan = getattr(dev, "fault_plan", None)
    return plan if plan is not None else dev.fabric.fault_plan


for name in IN["names"].tolist():
    a, w = IN["a/" + name], IN["w/" + name]
    res = ReplayEngine(target(name), outstanding=8,
                       metrics=MetricsSpec()).run_arrays(a, w)
    OUT["lat/" + name] = res.latency_ticks
    OUT["hit/" + name] = res.hit_flags
    OUT["evict/" + name] = res.evict_flags
    OUT["poison/" + name] = (res.poison_flags if res.poison_flags
                             is not None else np.zeros(0, bool))
    OUT["avail/" + name] = np.asarray(json.dumps(res.availability))
    OUT["metrics/" + name] = np.asarray(json.dumps(res.metrics.to_jsonable()))
    OUT["summary/" + name] = np.asarray([res.elapsed_ticks,
                                         res.sum_latency_ticks, res.end_tick,
                                         res.gc_runs])
for name in IN["transport"].tolist():
    dev = target(name)
    cols, faulted, fstats, n_ports, n_hops, deg, fo = E._fault_transport_cols(
        dev, plan_of(dev), IN["a/" + name], 64)
    for i, c in enumerate(cols):
        OUT[f"cols/{name}/{i}"] = c
    OUT["shape/" + name] = np.asarray([n_ports, n_hops])
    OUT["fstats/" + name] = np.asarray(json.dumps(fstats))
    OUT["faulted/" + name] = np.asarray(json.dumps(
        {k: (v if isinstance(v, dict) else np.asarray(v).tolist())
         for k, v in faulted.items()}))
    OUT["deg/" + name], OUT["fo/" + name] = deg, fo
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"tests": np.asarray(str(REPO / "tests")),
              "cases_src": np.asarray(FAULT_CASES_SRC),
              "names": np.asarray(ALL), "transport": np.asarray(TRANSPORT)}
    for name in ALL:
        a, w, _ = trace_to_arrays(target_and_trace(name)[1])
        inputs["a/" + name], inputs["w/" + name] = a, w
    return run_reference(REFERENCE, tmp_path_factory.mktemp("faults_scan"),
                         inputs)


def scan(name, **kw):
    tgt, trace = target_and_trace(name)
    return TraceDriver(tgt, outstanding=OUTSTANDING, engine="scan",
                       metrics=MetricsSpec(), torch_device="cpu",
                       **kw).run(trace)


def as_json(bundle):
    return json.loads(json.dumps(bundle.to_jsonable()))


# ------------------------------------------------------------ golden pins
@pytest.mark.parametrize("block_size", [1, BLOCK_SIZE])
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_fault_pins_on_the_twin(name, block_size):
    assert scenario_outstanding(name) == OUTSTANDING
    res = scan(name, block_size=block_size)
    pin = golden(name)["python_scan"]
    assert res.latency_ticks.tolist() == pin["latency_ticks"]
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(res, f) == pin[f], f
    assert as_json(res.metrics) == golden(name)["metrics"]


# ------------------------------------------- against the reference engine
@pytest.mark.parametrize("name", ALL)
def test_results_equal_the_reference_engine(name, reference):
    res = scan(name)
    np.testing.assert_array_equal(res.latency_ticks,
                                  reference["lat/" + name])
    np.testing.assert_array_equal(res.hit_flags, reference["hit/" + name])
    np.testing.assert_array_equal(res.evict_flags,
                                  reference["evict/" + name])
    want_poison = reference["poison/" + name]
    if want_poison.size:
        np.testing.assert_array_equal(res.poison_flags, want_poison)
    else:
        assert res.poison_flags is None
    assert json.loads(json.dumps(res.availability)) == json.loads(
        str(reference["avail/" + name]))
    assert as_json(res.metrics) == json.loads(
        str(reference["metrics/" + name]))
    assert [res.elapsed_ticks, res.sum_latency_ticks, res.end_tick,
            res.gc_runs] == reference["summary/" + name].tolist()


@pytest.mark.parametrize("name", TRANSPORT)
def test_path_codes_expand_to_the_reference_columns(name, reference):
    tgt, trace = target_and_trace(name)
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, path, retries, builder = ReplayEngine(
        tgt, outstanding=OUTSTANDING).prepare(addrs, size=size)
    got = expand_fault_codes(params, path, retries)
    assert [cfg.num_ports, cfg.num_hops] == reference[
        "shape/" + name].tolist() == [builder.num_ports, builder.num_hops]
    for i, g in enumerate(got):
        want = reference[f"cols/{name}/{i}"]
        assert g.dtype == want.dtype, (name, i)
        np.testing.assert_array_equal(g, want, err_msg=f"{name} col {i}")
    assert builder.fstats == json.loads(str(reference["fstats/" + name]))
    faulted = builder.faulted()
    want = json.loads(str(reference["faulted/" + name]))
    assert [list(k) for k in faulted["port_keys"]] == want["port_keys"]
    for k in ("packets", "bytes", "occupied"):
        assert faulted[k].tolist() == want[k], k
    assert faulted["ecmp"] == want["ecmp"]
    deg, fo = builder.flags()
    np.testing.assert_array_equal(deg, reference["deg/" + name])
    np.testing.assert_array_equal(fo, reference["fo/" + name])
    # the code is compact: a path id and one byte a hop an access
    assert path.dtype == np.int32 and retries.dtype == np.uint8
    assert retries.shape == (addrs.size, cfg.num_hops)


# ------------------------------------------------ against the python lane
@pytest.mark.parametrize("name", FAULT_CASES)
def test_faulted_cases_equal_the_python_lane(name):
    tgt, trace = fault_case(name)
    want = TraceDriver(tgt, outstanding=OUTSTANDING,
                       metrics=MetricsSpec()).run(trace)
    got = scan(name)
    assert (got.elapsed_ticks, got.sum_latency_ticks, got.end_tick) == (
        want.elapsed_ticks, want.sum_latency_ticks, want.end_tick)
    assert as_json(got.metrics) == as_json(want.metrics)
    faults = got.metrics.faults
    assert faults["nand_read_retries"] + faults["link_retries"] > 0


def test_gc_trace_retires_blocks_and_a_longer_one_runs_out():
    trace = make_trace(GC_TRACE["seed"], n=GC_TRACE["n"],
                       pages=GC_TRACE["pages"])
    name = "faults-nand-retry@direct"
    want = TraceDriver(make_target(name), metrics=MetricsSpec()).run(trace)
    got = TraceDriver(make_target(name), engine="scan", metrics=MetricsSpec(),
                      torch_device="cpu").run(trace)
    assert (got.sum_latency_ticks, got.end_tick) == (want.sum_latency_ticks,
                                                     want.end_tick)
    assert as_json(got.metrics) == as_json(want.metrics)
    assert got.metrics.faults["retired_blocks"] >= 1 and got.gc_runs > 0
    longer = make_trace(GC_TRACE["seed"], n=2 * GC_TRACE["n"],
                        pages=GC_TRACE["pages"])
    with pytest.raises(RuntimeError, match="out of space"):
        TraceDriver(make_target(name)).run(longer)
    with pytest.raises(ReplayUnsupported, match="out of free blocks"):
        TraceDriver(make_target(name), engine="scan",
                    torch_device="cpu").run(longer)


# --------------------------------------------------------------- the twin
@pytest.mark.parametrize("name", ["faults-nand-retry@direct",
                                  "nand-gc/cxl-ssd-cache", "nand-gc/cxl-ssd"])
def test_read_sequence_advances_once_a_page_read(name):
    """rd_seq counts every page read, host fills and GC migrations alike
    (c_hr + c_gw: a migration reads once and writes once); er_seq every
    erase; c_rr and c_rb are what fault_counters reports."""
    tgt, trace = target_and_trace(name)
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, _, _, _ = ReplayEngine(
        tgt, outstanding=OUTSTANDING, metrics=MetricsSpec()).prepare(
        addrs, size=size)
    state = stack.init_state(cfg, "cpu")
    rs.replay_scan(cfg, params, state, torch.from_numpy(addrs),
                   torch.from_numpy(writes))
    f = state["flash"]
    assert int(f["rd_seq"]) == int(f["c_hr"]) + int(f["c_gw"]) > 0
    assert int(f["er_seq"]) == int(f["c_ge"])
    assert stack.fault_counters(state) == (int(f["c_rr"]), int(f["c_rb"]))
    assert int(f["rtr_mask"].sum()) == int(f["c_rb"])


def test_poison_is_status_only():
    """A poison plan flags reads and moves no tick."""
    trace = make_trace(4, n=600, pages=64)
    dev = make_device("cxl-ssd-cache")
    install(FaultPlan(FaultConfig(poison_rate=0.3), seed=2), [dev])
    got = ReplayEngine(dev, torch_device="cpu").run(trace)
    clean = ReplayEngine(make_device("cxl-ssd-cache"),
                         torch_device="cpu").run(trace)
    np.testing.assert_array_equal(got.latency_ticks, clean.latency_ticks)
    writes = np.asarray([w for _, _, w in trace])
    assert got.poison_flags.any() and not got.poison_flags[writes].any()
    assert clean.poison_flags is None and clean.availability is None


def test_retry_bursts_past_a_byte_are_refused():
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    mount = fab.mount("h0", "d0", make_device("dram"))
    install(FaultPlan(FaultConfig(link_retry_rate=1.0, link_retry_max=1000),
                      seed=2), [mount])
    with pytest.raises(ReplayUnsupported, match="one-byte code"):
        ReplayEngine(mount, torch_device="cpu").run(make_trace(1, n=64))


def test_the_wrapper_refuses_codes_out_of_range():
    tgt, trace = fault_case("down-ecmp/dram")
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, path, retries, _ = ReplayEngine(
        tgt, outstanding=OUTSTANDING).prepare(addrs, size=size)
    a, w = torch.from_numpy(addrs), torch.from_numpy(writes)
    p, r = torch.from_numpy(path), torch.from_numpy(retries)

    def run(p, r):
        rs.replay_scan(cfg, params, stack.init_state(cfg, "cpu"), a, w, p,
                       retries=r)

    rows = np.asarray(params["hop_port"]).shape[0]
    for bad in (-1, rows):
        with pytest.raises(ValueError, match="routes must lie"):
            run(torch.full_like(p, bad), r)
    off = np.argwhere(np.asarray(params["hop_port"])[path] < 0)
    assert off.size, "the case has paths of mixed hop counts"
    r2 = r.clone()
    r2[tuple(off[0])] = 1
    with pytest.raises(ValueError, match="retry bytes must be 0"):
        run(p, r2)
    with pytest.raises(ValueError, match="retry bytes go with"):
        run(p, None)
    with pytest.raises(ValueError, match="uint8"):
        run(p, r.to(torch.int32))


def test_faulted_table1_keeps_every_access_in_shared_memory():
    """Table I's cached CXL-SSD over chip_smoke.py's 16,384 pages, mounted
    on its faulted 2 x 2 spine-leaf: the retry bytes' staging, the path
    table and the virtual clocks fit beside the map, frames, links and
    l2p (219,376 of the H100's 232,448 bytes); a fault-free stack stages
    no retry byte and keeps no virtual clock."""
    def link():
        mount = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                             num_leaves=2, num_spines=2, ecmp=True).mount(
            "h0", "d0", make_device("cxl-ssd-cache"))
        install(FaultPlan(FaultConfig(
            link_retry_rate=0.25, down_links=(("s0", "sp0", 64, 128),)),
            seed=7), [mount])
        return mount

    addrs = np.arange(1024, dtype=np.int64) * 16 * 4096 % (16384 * 4096)
    addrs[-1] = 16383 * 4096
    cfg, params, _, _, _ = ReplayEngine(link()).prepare(addrs)
    assert (cfg.fault_hops, cfg.num_hops, cfg.num_ports, cfg.num_pages) == (
        True, 4, 6, 16384)
    lay = rs.layout(cfg, params, 232448)
    assert lay.in_smem == ("where", "frames", "links", "l2p")
    assert lay.smem_bytes == 219_376 and lay.scratch_bytes == 0
    words = dict(zip(rs.LAYOUT, lay.words))
    assert words["out_issue"] - words["in_rt"] == 2 * rs.CHUNK * 4
    clean = dict(zip(rs.LAYOUT, rs.layout(
        *build_clean(), 232448).words))
    assert clean["out_issue"] == clean["in_rt"]
    assert clean["tables"] == clean["vft"]


def build_clean():
    cfg, params, _, _, _ = ReplayEngine(make_device("cxl-ssd-cache")).prepare(
        np.asarray([16383 * 4096]))
    return cfg, params
