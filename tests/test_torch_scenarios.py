"""The port's twins of the golden scenario builders, and their checks.

``tests/golden/scenarios.py`` builds its targets from the JAX package; the
functions here build the same targets from the port (``make_target``,
``make_multi_targets``, ``multi_traces``, ``scenario_trace``, after
scenarios.py:123-335) and replay them through the port's python lane
(:func:`run_python`).  :data:`COUNTERS` is the one definition of the
fabric, fault and device counters the port's tests compare with the
reference: it is executed here on the port's objects and, as source, in
the reference's child process on the JAX package's.

Other test files import these names (``tests/`` is on ``sys.path``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from golden import scenarios as sc
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import CachedCXLSSDDevice, DRAMDevice, make_device
from repro_torch.core.fabric import Fabric, FabricAttachedDevice, MemoryPool
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.ssd.hil import HIL, SSDConfig
from repro_torch.core.ssd.pal import NANDTiming
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from repro_torch.core.workloads.traces import hash_seed, make_trace
from test_torch_reference import golden

# the scenarios of the golden fixture the port's python lane holds here
# (the five @direct ones are held by test_torch_devices.py; the fleet
# scenario needs data/workloads.py, ROADMAP Queue A item 13)
FABRIC_SCENARIOS = [f"{d}@fabric" for d in sc.DEVICES] + ["dram-qos@fabric"]
MULTI_SCENARIOS = ["multihost-qos-ecmp"] + sorted(sc.MULTI_SSD_HOSTS)
STREAM_SCENARIOS = ["dram@stream", "pmem@stream", "ssd-gc@direct"]
FAULT_SCENARIOS = list(sc.FAULT_SCENARIOS) + sorted(sc.MULTI_FAULT_HOSTS)
PINNED = STREAM_SCENARIOS + FABRIC_SCENARIOS + MULTI_SCENARIOS \
    + FAULT_SCENARIOS


def mk_device(name: str):
    if name == "cxl-ssd-cache":
        return make_device(name, cache_cfg=DRAMCacheConfig(policy="lru",
                                                           **sc.CACHE_KW))
    return make_device(name)


def gc_ssd_cfg(cap_pages: int) -> SSDConfig:
    """Tiny flash geometry so short pinned traces reach the GC watermark."""
    return SSDConfig(capacity_bytes=cap_pages * 4096, page_bytes=4096,
                     channels=2, dies_per_channel=2, pages_per_block=8,
                     timing=NANDTiming.low_latency(), hil_overhead_ns=1000.0)


def _gc_cached_ssd():
    return make_device("cxl-ssd-cache", ssd_cfg=gc_ssd_cfg(750),
                       cache_cfg=DRAMCacheConfig(capacity_bytes=8 * 4096,
                                                 mshr_entries=4,
                                                 writeback_buffer=2))


def _make_fault_target(name: str):
    if name == "faults-linkretry@spine_leaf":
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, ecmp=True)
        tgt = fab.mount("h0", "d0", mk_device("dram"))
        install(FaultPlan(FaultConfig(link_retry_rate=0.25), seed=7), [tgt])
        return tgt
    if name == "faults-portdown-failover@mesh":
        fab = Fabric.build("mesh", num_hosts=2, num_devices=2)
        tgt = fab.mount("h0", "d0", mk_device("cxl-dram"))
        install(FaultPlan(FaultConfig(
            down_links=(("s0_0", "s0_1", 10, 70),)), seed=7), [tgt])
        return tgt
    assert name == "faults-nand-retry@direct", name
    dev = _gc_cached_ssd()
    install(FaultPlan(FaultConfig(nand_read_retry_rate=0.3,
                                  erase_fail_rate=0.5,
                                  poison_rate=0.1), seed=0), [dev])
    return dev


def make_target(name: str):
    """Fresh port target of a single-host scenario."""
    if name in sc.FAULT_SCENARIOS:
        return _make_fault_target(name)
    if name == "dram-qos@fabric":
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2, qos_weights={"h0": 3.0, "h1": 1.0})
        return fab.mount("h1", "d1", mk_device("dram"))
    device, attach = name.split("@")
    if device == "ssd-gc":
        return _gc_cached_ssd()
    dev = mk_device(device)
    if attach == "fabric":
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2)
        return fab.mount("h1", "d1", dev)
    return dev


def make_multi_targets(name: str):
    """Fresh port targets of a multi-host scenario, one per host."""
    if name in sc.MULTI_FAULT_HOSTS:
        nh = sc.MULTI_FAULT_HOSTS[name]
        fab = Fabric.build("spine_leaf", num_hosts=nh, num_devices=nh,
                           num_leaves=2, num_spines=2, ecmp=True)
        tgts = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
                for i in range(nh)]
        cfg = (FaultConfig(down_links=(("s0", "sp0", 20, 90),))
               if name == "faults-portdown@multihost_x2"
               else FaultConfig(link_retry_rate=0.2, link_retry_max=2))
        install(FaultPlan(cfg, seed=11), tgts)
        return tgts
    if name == "multihost-qos-ecmp":
        m = sc.MULTI
        fab = Fabric.build("spine_leaf", num_hosts=m["num_hosts"],
                           num_devices=2, num_leaves=m["num_leaves"],
                           num_spines=m["num_spines"], ecmp=True,
                           qos_weights=m["qos_weights"])
        pool = MemoryPool(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
        return pool.views([f"h{i}" for i in range(m["num_hosts"])])
    cache_cfg = dict(policy="lru", **sc.CACHE_KW)
    if name == "multihost-ssd-pool":
        fab = Fabric.build("two_level", num_hosts=4, num_devices=2,
                           num_leaves=2)
        pool = MemoryPool(fab, {
            d: CachedCXLSSDDevice(cache_cfg=DRAMCacheConfig(**cache_cfg))
            for d in ("d0", "d1")})
        return pool.views([f"h{i}" for i in range(4)])
    nh = sc.MULTI_SSD_HOSTS[name]
    fab = Fabric.build("two_level", num_hosts=nh, num_devices=nh,
                       num_leaves=2)
    hil = HIL(gc_ssd_cfg(48)) if name == "multihost-ssd-sharedflash" else None
    return [fab.mount(f"h{i}", f"d{i}", CachedCXLSSDDevice(
                cache_cfg=DRAMCacheConfig(**cache_cfg), hil=hil))
            for i in range(nh)]


def multi_traces(name: str):
    if name in sc.MULTI_FAULT_HOSTS:
        return [make_trace(400 + h) for h in range(sc.MULTI_FAULT_HOSTS[name])]
    if name == "multihost-ssd-sharedflash":
        return [make_trace(300 + h, n=sc.N_ACCESSES, pages=24, write_frac=0.7)
                for h in range(sc.MULTI_SSD_HOSTS[name])]
    nh = sc.MULTI_SSD_HOSTS.get(name, sc.MULTI["num_hosts"])
    return [make_trace(100 + h) for h in range(nh)]


def scenario_trace(name: str):
    """The pinned trace of a single-host scenario."""
    if name in ("ssd-gc@direct", "faults-nand-retry@direct"):
        trace = [(p * 4096, 64, True) for p in range(750)]
        trace += [(((k * 9) % 750) * 4096 + (k % 64) * 64, 64, True)
                  for k in range(40)]
        if name == "faults-nand-retry@direct":
            trace += [(((k * 131) % 750) * 4096, 64, False)
                      for k in range(24)]
        return trace
    return make_trace(hash_seed(name))


class ServiceTap:
    """Record the latency of every service call of a target."""

    def __init__(self, dev):
        self._dev = dev
        self.latencies = []

    def service(self, now, addr, size, write, posted=False):
        done = self._dev.service(now, addr, size, write, posted)
        self.latencies.append(int(done - now))
        return done


def _summ(latencies, result) -> dict:
    return {"latency_ticks": list(latencies),
            "elapsed_ticks": result.elapsed_ticks,
            "sum_latency_ticks": result.sum_latency_ticks,
            "end_tick": result.end_tick}


def run_python(name: str):
    """The port's python lane on scenario ``name``: ``(summary, targets,
    elapsed_ticks)``, the summary in the pin's form (a list per host for a
    multi-host scenario)."""
    if sc.is_multi(name):
        targets = make_multi_targets(name)
        taps = [ServiceTap(t) for t in targets]
        res = MultiHostDriver(taps, outstanding=sc.OUTSTANDING).run(
            multi_traces(name))
        return ([_summ(tap.latencies, host)
                 for tap, host in zip(taps, res.per_host)],
                targets, res.elapsed_ticks)
    target = make_target(name)
    tap = ServiceTap(target)
    res = TraceDriver(tap, outstanding=sc.scenario_outstanding(name)).run(
        scenario_trace(name))
    return _summ(tap.latencies, res), [target], res.elapsed_ticks


# Executed on the port's objects below and, as source, on the reference's
# in its child process: one definition of what is compared.
COUNTERS = '''
def counters(targets, elapsed):
    """Fabric, fault and device counters reachable from ``targets``."""
    fabrics, devices = [], []

    def add(seq, obj):
        if obj is not None and all(o is not obj for o in seq):
            seq.append(obj)

    for t in targets:
        pool = getattr(t, "pool", None)
        add(fabrics, getattr(t, "fabric", None) or getattr(pool, "fabric",
                                                           None))
        add(devices, t)
        add(devices, getattr(t, "inner", None))
        for d in getattr(pool, "devices", ()):
            add(devices, d)
    out = {"fabrics": [], "devices": []}
    for fab in fabrics:
        out["fabrics"].append({
            "port_report": fab.port_report(elapsed),
            "fault_stats": fab.fault_stats,
            "ecmp_counts": fab.ecmp_counts,
            "stats": fab.stats,
        })
    for d in devices:
        row = {"name": d.name, "stats": d.stats,
               "flit_ord": d._flit_ord,
               "fault_ord": getattr(d, "_fault_ord", None)}
        cache = getattr(d, "cache", None)
        if cache is not None:
            row["cache"] = cache.stats
        hil = getattr(d, "hil", None)
        if hil is not None:
            row["hil"] = hil.stats
            row["ftl"] = hil.ftl.stats
            row["pal"] = hil.ftl.pal.stats
            row["retired_blocks"] = sorted(hil.ftl.retired_blocks)
        out["devices"].append(row)
    return out
'''
exec(COUNTERS)


def port_counters(name: str) -> dict:
    """The port's counters after its python lane ran ``name``, in the JSON
    form the reference child returns them."""
    _, targets, elapsed = run_python(name)
    return json.loads(json.dumps(counters(targets, elapsed)))


# Reference child code: the same scenarios on the JAX package (its own
# builders and drivers), their counters as one JSON string per scenario.
REFERENCE_COUNTERS = COUNTERS + '''
import json, sys
sys.path.insert(0, IN["tests"].item())
from golden import scenarios as sc
from repro.core.workloads.driver import MultiHostDriver, TraceDriver

for name in IN["names"].tolist():
    if sc.is_multi(name):
        targets = sc.make_multi_targets(name)
        res = MultiHostDriver(targets, outstanding=sc.OUTSTANDING).run(
            sc.multi_traces(name))
    else:
        targets = [sc.make_target(name)]
        res = TraceDriver(targets[0],
                          outstanding=sc.scenario_outstanding(name)).run(
            sc.scenario_trace(name))
    OUT[name] = np.asarray(json.dumps(counters(targets, res.elapsed_ticks)))
'''


def reference_counters(names, workdir, extra: str = "",
                       inputs: dict | None = None) -> dict:
    """The reference's counters of ``names``, from one child process.
    ``extra`` is more child code for the same process: it reads ``IN``
    (with ``inputs``) and leaves JSON strings in ``OUT``."""
    from test_torch_reference import REPO, run_reference

    out = run_reference(REFERENCE_COUNTERS + extra, workdir, {
        "names": np.asarray(list(names)),
        "tests": np.asarray(str(REPO / "tests")), **(inputs or {})})
    return {k: json.loads(str(v)) for k, v in out.items()}


# ------------------------------------------------------------------ checks
@pytest.mark.parametrize("name", PINNED)
def test_port_traces_equal_the_scenarios(name):
    if sc.is_multi(name):
        assert multi_traces(name) == sc.multi_traces(name)
    else:
        assert scenario_trace(name) == sc.scenario_trace(name)


def test_the_pinned_list_is_the_fixture_less_direct_and_fleet():
    fixture = set(sc.load_fixture()["scenarios"])
    direct = {f"{d}@direct" for d in sc.DEVICES}
    assert set(PINNED) == fixture - direct - {sc.FLEET_SCENARIO}
    assert len(PINNED) == 18 and len(set(PINNED)) == 18


@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_fault_targets_carry_an_active_plan(name):
    targets = (make_multi_targets(name) if sc.is_multi(name)
               else [make_target(name)])
    for t in targets:
        assert t.fault_plan is not None and t.fault_plan.active
        if isinstance(t, FabricAttachedDevice):
            assert t.fabric.fault_plan is t.fault_plan
        else:
            assert t.hil.ftl.fault_plan is t.fault_plan
            assert t.hil.ftl.pal.fault_plan is t.fault_plan

