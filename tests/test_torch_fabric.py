"""The port's CXL fabric against the JAX package: topologies, routing with
ECMP, QoS arbitration, pools, the congestion estimator, and the kernel
lane on fabric mounts.

The python lane is held against the golden ``python_scan`` pins; the
fabric and device counters after each run against the reference's, from
one child process for this file (its drivers import only with the alias
of ``test_torch_reference.run_reference``).  The reference's topologies,
routing and congestion estimator import cleanly and run in-process.
Ticks and counters are integers: those comparisons are exact.
"""

import json

import numpy as np
import pytest

from golden import scenarios as sc
from repro.core.fabric import Fabric as RefFabric
from repro.core.fabric.link_sim import LinkCongestionSim as RefCongestionSim
from repro_torch.core.devices import DRAMDevice, make_device
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.fabric.link_sim import LinkCongestionSim
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay.cuda_engine import run_cuda
from repro_torch.core.replay.spec import ReplayUnsupported, trace_to_arrays
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from test_torch_reference import REPO, golden
from test_torch_scenarios import (FABRIC_SCENARIOS, MULTI_SCENARIOS,
                                  STREAM_SCENARIOS, make_target,
                                  port_counters, reference_counters,
                                  run_python, scenario_trace)

SCENARIOS = STREAM_SCENARIOS + FABRIC_SCENARIOS + MULTI_SCENARIOS
KERNEL_PIN = "cxl-ssd-cache@fabric"
TOPOLOGIES = {
    "direct": dict(num_pairs=3),
    "single_switch": dict(num_hosts=3, num_devices=2),
    "two_level": dict(num_hosts=4, num_devices=2, num_leaves=2),
    "spine_leaf": dict(num_hosts=4, num_devices=4, num_leaves=2,
                       num_spines=3),
    "mesh": dict(num_hosts=3, num_devices=3, rows=3, cols=3),
    "multi_pod": dict(num_pods=2, hosts_per_pod=3),
}
RTOL = 1e-5          # float32 sums in another order (index_add_ vs segment_sum)


# what the JAX package's kernel lane refuses, beside the counters
REFUSALS = """
from repro.core.devices import make_device
from repro.core.fabric import Fabric
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay.pallas_engine import run_pallas

def refusal(target):
    try:
        run_pallas(target, IN["addrs"], IN["writes"])
    except Exception as e:
        return type(e).__name__
    return "none"

fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
OUT["refuse/dram"] = np.asarray(json.dumps(refusal(
    fab.mount("h0", "d0", make_device("dram")))))
mount = sc.make_target("cxl-ssd-cache@fabric")
install(FaultPlan(FaultConfig(link_retry_rate=0.25)), [mount])
OUT["refuse/plan"] = np.asarray(json.dumps(refusal(mount)))
mount = sc.make_target("cxl-ssd-cache@fabric")
mount.fabric.fault_plan = FaultPlan(FaultConfig(
    down_links=(("s1", "s_root", 0, 4),)))
OUT["refuse/fabric-plan"] = np.asarray(json.dumps(refusal(mount)))
mount = sc.make_target("cxl-ssd-cache@fabric")
install(FaultPlan(FaultConfig()), [mount])
OUT["refuse/inert-plan"] = np.asarray(json.dumps(refusal(mount)))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    addrs, writes, _ = trace_to_arrays(scenario_trace(KERNEL_PIN)[:8])
    return reference_counters(SCENARIOS, tmp_path_factory.mktemp("fabric"),
                              REFUSALS, {"addrs": addrs, "writes": writes})


# ------------------------------------------------- (a) the python lane pins
@pytest.mark.parametrize("name", SCENARIOS)
def test_python_lane_equals_golden_pin(name):
    summary, _, _ = run_python(name)
    assert summary == golden(name)["python_scan"]


# ------------------------------------- (b) fabric and device counters
@pytest.mark.parametrize("name", SCENARIOS)
def test_counters_equal_the_reference(name, reference):
    got = port_counters(name)
    assert got == reference[name]
    if "@fabric" in name or name.startswith("multihost"):
        assert got["fabrics"] and got["fabrics"][0]["port_report"]


@pytest.mark.parametrize("kind", sorted(TOPOLOGIES))
@pytest.mark.parametrize("ecmp", [False, True])
def test_routes_equal_the_reference(kind, ecmp):
    port = Fabric.build(kind, ecmp=ecmp, **TOPOLOGIES[kind])
    ref = RefFabric.build(kind, ecmp=ecmp, **TOPOLOGIES[kind])
    assert port.topology.kinds == ref.topology.kinds
    assert {k: (p.bw_gbps, p.prop_ns) for k, p in port.ports.items()} == \
        {k: (p.bw_gbps, p.prop_ns) for k, p in ref.ports.items()}
    hosts, devices = port.topology.hosts, port.topology.devices
    addrs = list(range(0, 64 * 97, 64 * 3))
    for src, dst in [(h, d) for h in hosts for d in devices] + \
            [(d, h) for h in hosts for d in devices]:
        got, want = _routes(port, src, dst, addrs), _routes(ref, src, dst,
                                                            addrs)
        assert got == want, (src, dst)
    assert any(isinstance(r, tuple) and len(r) == 3 for r in
               (_routes(port, h, d, addrs) for h in hosts for d in devices))


def _routes(fab, src, dst, addrs):
    """Paths, per-hop occupancy and ECMP picks of ``src -> dst``, or the
    refusal of an unroutable pair."""
    try:
        return (fab.paths(src, dst), fab.route_occupancy(src, dst, 64),
                [fab.select_path(src, dst, a) for a in addrs])
    except ValueError as e:
        return str(e)


def test_qos_weights_must_name_every_host():
    with pytest.raises(ValueError, match="every host"):
        Fabric.build("single_switch", num_hosts=3, num_devices=1,
                      qos_weights={"h0": 2.0, "h1": 2.0})


# ------------------------------------------ (c) the kernel lane on a mount
def _kernel_run(target):
    return TraceDriver(target, outstanding=sc.OUTSTANDING, engine="cuda",
                       torch_device="cpu").run(scenario_trace(KERNEL_PIN))


def test_kernel_lane_equals_the_fabric_pallas_pin():
    res = _kernel_run(make_target(KERNEL_PIN))
    pin = golden(KERNEL_PIN)["pallas"]
    assert res.latency_ticks.tolist() == pin["latency_ticks"]
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(res, f) == pin[f], f
    addrs, writes, size = trace_to_arrays(scenario_trace(KERNEL_PIN))
    checked = run_cuda(make_target(KERNEL_PIN), addrs, writes, size=size,
                       outstanding=sc.OUTSTANDING, validate=True,
                       torch_device="cpu")
    assert checked.latency_ticks.tolist() == pin["latency_ticks"]


def test_kernel_lane_ignores_fabric_hops():
    # the JAX package's design: the analytic model reads only the mounted
    # device, so a mount replays exactly as the bare device
    mounted = _kernel_run(make_target(KERNEL_PIN))
    bare = _kernel_run(make_target("cxl-ssd-cache@direct"))
    for f in ("latency_ticks", "hit_flags", "evict_flags"):
        np.testing.assert_array_equal(getattr(mounted, f), getattr(bare, f))
    assert (mounted.elapsed_ticks, mounted.end_tick) == (bare.elapsed_ticks,
                                                         bare.end_tick)


def test_run_cuda_refuses_what_the_pallas_lane_refuses(reference):
    assert [reference[f"refuse/{case}"] for case in (
        "dram", "plan", "fabric-plan", "inert-plan")] == [
        "ReplayUnsupported"] * 3 + ["none"]
    addrs, writes, _ = trace_to_arrays(scenario_trace(KERNEL_PIN)[:8])
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    dram = fab.mount("h0", "d0", make_device("dram"))
    with pytest.raises(ReplayUnsupported, match="DRAMDevice"):
        run_cuda(dram, addrs, writes, torch_device="cpu")
    mount = make_target(KERNEL_PIN)
    install(FaultPlan(FaultConfig(link_retry_rate=0.25)), [mount])
    with pytest.raises(ReplayUnsupported, match="link-retry"):
        run_cuda(mount, addrs, writes, torch_device="cpu")
    # a plan left on the fabric alone is refused too
    mount = make_target(KERNEL_PIN)
    mount.fabric.fault_plan = FaultPlan(FaultConfig(
        down_links=(("s1", "s_root", 0, 4),)))
    with pytest.raises(ReplayUnsupported, match="port-down"):
        run_cuda(mount, addrs, writes, torch_device="cpu")
    # an inert plan is no fault
    mount = make_target(KERNEL_PIN)
    install(FaultPlan(FaultConfig()), [mount])
    assert run_cuda(mount, addrs, writes, torch_device="cpu").accesses == 8


# ----------------------------- (f) results/BENCH_fabric.json["derived"]
# The port's twin of benchmarks/fabric_sweep.py::collect_derived (:108),
# at its configuration; the benchmark itself stays the JAX package's.
ACCESSES_PER_HOST = 20_000
TRACE_SEED = 20_250_731
SWEEP = [
    ("direct", "direct", lambda nh: dict(num_pairs=nh)),
    ("star", "single_switch", lambda nh: dict(num_hosts=nh, num_devices=1)),
    ("tree2", "two_level", lambda nh: dict(num_hosts=nh, num_devices=1,
                                           num_leaves=max(1, nh // 2))),
    ("spine", "spine_leaf", lambda nh: dict(num_hosts=nh, num_devices=1,
                                            num_leaves=max(1, nh // 2),
                                            num_spines=2)),
    ("mesh", "mesh", lambda nh: dict(num_hosts=nh, num_devices=1,
                                     rows=2, cols=2)),
]
HOST_COUNTS = [1, 2, 4]
QOS_WEIGHTS = {"h0": 3.0, "h1": 1.0}


def _stream_trace(host, n=ACCESSES_PER_HOST):
    rng = np.random.default_rng(TRACE_SEED + host)
    writes = rng.random(n) < 0.25
    return [((host << 30) + i * 64, 64, bool(w)) for i, w in enumerate(writes)]


def _pooled(fab, nh, tag):
    if tag == "direct":
        views = [fab.mount(f"h{i}", f"d{i}", DRAMDevice()) for i in range(nh)]
    else:
        views = MemoryPool(fab, {"d0": DRAMDevice()}).views(
            [f"h{i}" for i in range(nh)])
    return MultiHostDriver(views).run([_stream_trace(h) for h in range(nh)])


def _two_hosts(fab, devices):
    views = MemoryPool(fab, devices).views(["h0", "h1"])
    return MultiHostDriver(views).run([_stream_trace(h) for h in range(2)])


def collect_derived():
    out = {"accesses_per_host": ACCESSES_PER_HOST, "trace_seed": TRACE_SEED,
           "topologies": {}, "qos": {}, "ecmp": {}}
    for tag, kind, kw in SWEEP:
        for nh in HOST_COUNTS:
            res = _pooled(Fabric.build(kind, **kw(nh)), nh, tag)
            out["topologies"][f"{tag}/hosts{nh}"] = {
                "min_host_gbps": round(res.min_host_bandwidth_gbps, 6),
                "aggregate_gbps": round(res.aggregate_bandwidth_gbps, 6)}
    for label, weights in (("fcfs", None), ("qos3to1", QOS_WEIGHTS)):
        fab = Fabric.build("single_switch", num_hosts=2, num_devices=1,
                           qos_weights=weights)
        res = _two_hosts(fab, {"d0": DRAMDevice()})
        out["qos"][label] = {
            "own_window_gbps": [round(r.bandwidth_gbps, 6)
                                for r in res.per_host],
            "end_ticks": [r.end_tick for r in res.per_host],
            "aggregate_gbps": round(res.aggregate_bandwidth_gbps, 6)}
    for label, ecmp in (("single_path", False), ("ecmp", True)):
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, uplink_bw_gbps=8.0,
                           ecmp=ecmp)
        res = _two_hosts(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
        out["ecmp"][label] = {
            "aggregate_gbps": round(res.aggregate_bandwidth_gbps, 6),
            "spine_bytes": {s: fab.ports[("s0", s)].bytes
                            for s in ("sp0", "sp1")}}
    return out


def test_bench_fabric_derived_is_reproduced():
    want = json.loads((REPO / "results" / "BENCH_fabric.json").read_text())
    assert json.loads(json.dumps(collect_derived())) == want["derived"]


# ------------------------------------------- (h) the congestion estimator
def _traffic(n_hosts, n_devices, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_hosts, n), rng.integers(0, n_devices, n),
            rng.integers(1, 5, n) * 64)


ESTIMATOR_FABRICS = {
    "two_level": dict(kind="two_level", num_hosts=4, num_devices=2,
                      num_leaves=2),
    "spine_leaf_ecmp": dict(kind="spine_leaf", num_hosts=4, num_devices=4,
                            num_leaves=2, num_spines=2, ecmp=True),
    "mesh": dict(kind="mesh", num_hosts=3, num_devices=2, rows=2, cols=3),
}


@pytest.mark.parametrize("fabric", sorted(ESTIMATOR_FABRICS))
def test_congestion_estimator_equals_the_reference(fabric):
    kw = dict(ESTIMATOR_FABRICS[fabric])
    kind = kw.pop("kind")
    port_fab, ref_fab = Fabric.build(kind, **kw), RefFabric.build(kind, **kw)
    hosts, devices = port_fab.topology.hosts, port_fab.topology.devices
    sim = LinkCongestionSim(port_fab, hosts, devices, torch_device="cpu")
    ref = RefCongestionSim(ref_fab, hosts, devices)
    np.testing.assert_array_equal(sim.routes.numpy(), np.asarray(ref.routes))
    hi, di, nb = _traffic(len(hosts), len(devices), 50_000, seed=3)
    for window in (1e-3, 1e-5):
        got = sim.estimate(hi, di, nb, window_s=window)
        want = ref.estimate(hi, di, nb, window_s=window)
        assert got["link_names"] == want["link_names"]
        assert got["bottleneck_link"] == want["bottleneck_link"]
        for key in ("link_utilization", "pair_slowdown", "pair_bytes"):
            assert got[key].dtype == np.float32, key
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
    scales = [0.25, 0.5, 1.0, 2.0, 4.0]
    got = sim.what_if_bandwidth(hi, di, nb, 1e-5, scales)
    want = ref.what_if_bandwidth(hi, di, nb, 1e-5, scales)
    for key in ("bw_scales", "max_link_utilization", "mean_pair_slowdown"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   err_msg=key)
    assert np.all(np.diff(got["max_link_utilization"]) < 0)


def test_congestion_estimator_takes_tensors_where_they_lie():
    import torch

    fab = Fabric.build("two_level", num_hosts=2, num_devices=1, num_leaves=2)
    sim = LinkCongestionSim(fab, fab.topology.hosts, fab.topology.devices,
                            torch_device="cpu")
    hi, di, nb = _traffic(2, 1, 1000, seed=4)
    a = sim.estimate(hi, di, nb, window_s=1e-5)
    b = sim.estimate(torch.from_numpy(hi), torch.from_numpy(di),
                     torch.from_numpy(nb), window_s=1e-5)
    for key in ("link_utilization", "pair_slowdown", "pair_bytes"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["pair_bytes"].sum() == nb.sum()
