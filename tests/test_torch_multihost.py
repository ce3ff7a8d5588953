"""The multi-host replay on the CPU, where ``MultiHostReplay`` runs the
``replay_scan`` kernel's multi-host twin (``replay_multi_plain``), against
the golden pins, the python lane and the JAX package's ``MultiHostReplay``.

The six golden multi-host scenarios reproduce their ``python_scan`` pins
(per host) and ``metrics`` blocks.  On them and on a heterogeneous DRAM
pool, segment- and interleave-mapped pools and ECMP without QoS, the
per-host latencies, results and metrics bundles equal the reference's,
which runs in one child process for this file (with the ``enable_x64``
alias applied there only).  The transport-fault code (a path table, a
path id and one retry byte a hop) expands to the reference's five hop
columns, and the reference's refusals are the port's, word for word.
Every comparison is exact.
"""

import json

import numpy as np
import pytest

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import (CachedCXLSSDDevice, DRAMDevice,
                                      DRAMTiming, make_device)
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.fabric.pool import PoolAddressMapper
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay.engine import expand_fault_codes
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.multihost import (MultiHostReplay,
                                               _MultiFaultColumns)
from repro_torch.core.replay.spec import MAX_ACCESSES, ReplayUnsupported
from repro_torch.core.ssd.hil import HIL
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from repro_torch.core.workloads.traces import make_trace
from test_torch_reference import REPO, golden, run_reference
from torch_scenarios import gc_ssd_cfg, make_multi_targets, multi_traces

OUTSTANDING = 8
PINNED = ["multihost-qos-ecmp", "multihost-ssd-mounts", "multihost-ssd-pool",
          "multihost-ssd-sharedflash", "faults-portdown@multihost_x2",
          "faults-linkretry@spine_leaf_x4"]
FAULTED = ["faults-portdown@multihost_x2", "faults-linkretry@spine_leaf_x4"]

# Multi-host shapes beyond the golden scenarios, one source for both
# packages (exec'd here and in the reference's child): a pool of DRAM
# devices of two timings and a CXL-DRAM (per-device timing), a
# segment-mapped cached CXL-SSD pool, an
# interleaved DRAM pool on a 4 KB granule, and ECMP without QoS.
CASES_SRC = '''
def make_case(name, make_device, Fabric, MemoryPool, PoolAddressMapper,
              DRAMCacheConfig, DRAMDevice, DRAMTiming):
    cached = DRAMCacheConfig(policy="lru", capacity_bytes=16 * 4096,
                             mshr_entries=4, writeback_buffer=2)
    if name == "pool-hetero-dram":
        fab = Fabric.build("two_level", num_hosts=3, num_devices=3,
                           num_leaves=2)
        slow = DRAMTiming(load_ns=110.0, bw_gbps=12.8)
        pool = MemoryPool(fab, {"d0": make_device("dram"),
                                "d1": DRAMDevice(timing=slow),
                                "d2": make_device("cxl-dram")})
        return pool.views(["h0", "h1", "h2"])
    if name == "pool-segment-ssd":
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2)
        pool = MemoryPool(fab, {
            d: make_device("cxl-ssd-cache", cache_cfg=cached)
            for d in ("d0", "d1")}, mapper=PoolAddressMapper(
                num_devices=2, mode="segment", segment_bytes=24 * 4096))
        return pool.views(["h0", "h1"])
    if name == "pool-interleave-dram":
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=3,
                           num_leaves=2, num_spines=2)
        pool = MemoryPool(fab, {d: make_device("dram")
                                for d in ("d0", "d1", "d2")},
                          mapper=PoolAddressMapper(num_devices=3,
                                                   granularity=4096))
        return pool.views(["h0", "h1"])
    assert name == "ecmp-mounts-ssd", name
    fab = Fabric.build("spine_leaf", num_hosts=3, num_devices=3,
                       num_leaves=2, num_spines=2, ecmp=True)
    return [fab.mount(f"h{i}", f"d{i}",
                      make_device("cxl-ssd-cache", cache_cfg=cached))
            for i in range(3)]


def case_traces(name, make_trace):
    hosts = 3 if name in ("pool-hetero-dram", "ecmp-mounts-ssd") else 2
    return [make_trace(700 + 11 * h + len(name), n=200, pages=48,
                       write_frac=0.4) for h in range(hosts)]
'''
exec(CASES_SRC)
CASES = ["pool-hetero-dram", "pool-segment-ssd", "pool-interleave-dram",
         "ecmp-mounts-ssd"]
ALL = PINNED + CASES


def targets_and_traces(name):
    if name in PINNED:
        return make_multi_targets(name), multi_traces(name)
    return (make_case(name, make_device, Fabric, MemoryPool,
                      PoolAddressMapper, DRAMCacheConfig, DRAMDevice,
                      DRAMTiming),
            case_traces(name, make_trace))


# Refusals, each built the same way in both packages: mixed media in one
# pool; mount mode sharing a device; a fabric with prior traffic; a pool
# under a link-retry plan; a padded trace over the stamp budget; QoS with
# start_tick < 0; a shared flash that runs out of free blocks; and the
# single-host reason that TraceDriver re-raises when the retry refuses too.
REFUSALS_SRC = '''
def refusal(name, P):
    cached = P.DRAMCacheConfig(policy="lru", capacity_bytes=16 * 4096,
                               mshr_entries=4, writeback_buffer=2)
    trace = [(64 * k, 64, k % 3 == 0) for k in range(40)]
    if name == "mixed-media":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        pool = P.MemoryPool(fab, {"d0": P.make_device("dram"),
                                  "d1": P.make_device("pmem")})
        return lambda: P.MultiHostReplay(pool.views(["h0", "h1"])).run(
            [trace, trace])
    if name == "shared-device":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        tg = [fab.mount(h, "d0", P.make_device("dram")) for h in ("h0", "h1")]
        return lambda: P.MultiHostReplay(tg).run([trace, trace])
    if name == "prior-traffic":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        other = fab.mount("h1", "d1", P.make_device("dram"))
        other.service(0, 0, 64, False)
        tg = [fab.mount("h0", "d0", P.make_device("dram"))]
        return lambda: P.MultiHostReplay(tg).run([trace])
    if name == "faulted-pool":
        # install() takes no pool view: the plan reaches the pool's fabric
        # through a mount of a third device on it
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=3,
                             num_leaves=2)
        P.install(P.FaultPlan(P.FaultConfig(link_retry_rate=0.2), seed=1),
                  [fab.mount("h0", "d2", P.make_device("dram"))])
        pool = P.MemoryPool(fab, {"d0": P.make_device("dram"),
                                  "d1": P.make_device("dram")})
        views = pool.views(["h0", "h1"])
        return lambda: P.MultiHostReplay(views).run([trace, trace])
    if name == "over-budget":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        tg = [fab.mount(f"h{i}", f"d{i}", P.make_device(
            "cxl-ssd-cache", cache_cfg=cached)) for i in range(2)]
        L = P.MAX_ACCESSES // 2 + 1
        a = P.np.zeros((2, L), P.np.int64)
        return lambda: P.MultiHostReplay(tg).run_arrays(
            a, a > 0, lens=P.np.asarray([4, 4]))
    if name == "qos-negative-start":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2, qos_weights={"h0": 3.0, "h1": 1.0})
        pool = P.MemoryPool(fab, {"d0": P.make_device("dram"),
                                  "d1": P.make_device("dram")})
        return lambda: P.MultiHostReplay(pool.views(["h0", "h1"])).run(
            [trace, trace], start_tick=-1)
    if name == "out-of-space":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        hil = P.HIL(P.gc_ssd_cfg(24))
        tg = [fab.mount(f"h{i}", f"d{i}", P.CachedCXLSSDDevice(
            cache_cfg=P.DRAMCacheConfig(capacity_bytes=4 * 4096,
                                        mshr_entries=2, writeback_buffer=1),
            hil=hil)) for i in range(2)]
        wr = [[(4096 * ((7 * k + 3 * h) % 40), 64, True) for k in range(600)]
              for h in range(2)]
        return lambda: P.MultiHostReplay(tg).run(wr)
    assert name == "single-host-reason", name
    dev = P.make_device("cxl-ssd-cache", cache_cfg=P.DRAMCacheConfig(
        policy="2q"))
    return lambda: P.TraceDriver(dev, engine="scan").run(trace)
'''
exec(REFUSALS_SRC)
# each refusal and words of the reason it must give
REFUSALS = {"mixed-media": "must be identically configured",
            "shared-device": "one private device per host",
            "prior-traffic": "fabric has prior traffic",
            "faulted-pool": "use engine='python' for faulted pools",
            "over-budget": "exceeds the packed-stamp budget",
            "qos-negative-start": "QoS replay needs start_tick >= 0",
            "out-of-space": "FTL ran out of free blocks",
            "single-host-reason": "'2q'"}


class _Port:
    """The port's classes under the names :data:`REFUSALS_SRC` reads, the
    replay on the CPU."""

    np = np
    DRAMCacheConfig = DRAMCacheConfig
    Fabric = Fabric
    MemoryPool = MemoryPool
    make_device = staticmethod(make_device)
    install = staticmethod(install)
    FaultPlan = FaultPlan
    FaultConfig = FaultConfig
    MAX_ACCESSES = MAX_ACCESSES
    HIL = HIL
    CachedCXLSSDDevice = CachedCXLSSDDevice
    gc_ssd_cfg = staticmethod(gc_ssd_cfg)

    @staticmethod
    def MultiHostReplay(targets):
        return MultiHostReplay(targets, outstanding=OUTSTANDING,
                               torch_device="cpu")

    @staticmethod
    def TraceDriver(dev, engine):
        return TraceDriver(dev, outstanding=OUTSTANDING, engine=engine,
                           torch_device="cpu")


REFERENCE = '''
import json, sys
sys.path.insert(0, IN["tests"].item())
exec(IN["cases_src"].item())
exec(IN["refusals_src"].item())
from golden import scenarios as sc
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import (CachedCXLSSDDevice, DRAMDevice, DRAMTiming,
                                make_device)
from repro.core.fabric import Fabric, MemoryPool
from repro.core.fabric.pool import PoolAddressMapper
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import MultiHostReplay
from repro.core.replay import multihost as M
from repro.core.replay.metrics import MetricsSpec
from repro.core.replay.spec import trace_to_arrays
from repro.core.replay.stack import MAX_ACCESSES
from repro.core.ssd.hil import HIL
from repro.core.workloads.driver import TraceDriver


def targets(name):
    if name in sc.MULTI_SSD_HOSTS or name in sc.MULTI_FAULT_HOSTS \\
            or name == "multihost-qos-ecmp":
        return sc.make_multi_targets(name)
    return make_case(name, make_device, Fabric, MemoryPool,
                     PoolAddressMapper, DRAMCacheConfig, DRAMDevice,
                     DRAMTiming)


for name in IN["names"].tolist():
    traces = [[(int(a), 64, bool(w)) for a, w in zip(IN[f"a/{name}/{h}"],
                                                      IN[f"w/{name}/{h}"])]
              for h in range(int(IN["hosts/" + name]))]
    eng = MultiHostReplay(targets(name), outstanding=8,
                          metrics=MetricsSpec())
    res, lat = eng.run_recorded(traces)
    for h, l in enumerate(lat):
        OUT[f"lat/{name}/{h}"] = l
    OUT["summary/" + name] = np.asarray(
        [[r.accesses, r.elapsed_ticks, r.sum_latency_ticks, r.end_tick]
         for r in res.per_host] + [[res.elapsed_ticks, eng.last_gc_runs,
                                    0, 0]])
    OUT["metrics/" + name] = np.asarray(json.dumps(res.metrics.to_jsonable()))
for name in IN["faulted"].tolist():
    eng = MultiHostReplay(targets(name), outstanding=8)
    traces = [[(int(a), 64, bool(w)) for a, w in zip(IN[f"a/{name}/{h}"],
                                                      IN[f"w/{name}/{h}"])]
              for h in range(int(IN["hosts/" + name]))]
    cfg, params, devs, addrs, writes, lens, size = eng.prepare(traces)
    for k in ("fhp", "fho", "fha", "fhon", "fhoc"):
        OUT[f"cols/{name}/{k}"] = params[k]
    OUT["fstats/" + name] = np.asarray(json.dumps(eng._meta["fault_stats"]))
    faulted = eng._meta["faulted"]
    OUT["faulted/" + name] = np.asarray(json.dumps(
        {k: (v if isinstance(v, dict) else np.asarray(v).tolist())
         for k, v in faulted.items()}))
    OUT["deg/" + name], OUT["fo/" + name] = eng.fault_flags


class P:
    pass


for k, v in dict(np=np, DRAMCacheConfig=DRAMCacheConfig, Fabric=Fabric,
                 MemoryPool=MemoryPool, make_device=make_device,
                 install=install, FaultPlan=FaultPlan,
                 FaultConfig=FaultConfig, MAX_ACCESSES=MAX_ACCESSES, HIL=HIL,
                 CachedCXLSSDDevice=CachedCXLSSDDevice,
                 gc_ssd_cfg=sc._gc_ssd_cfg,
                 MultiHostReplay=lambda t: MultiHostReplay(t, outstanding=8),
                 TraceDriver=lambda d, engine: TraceDriver(
                     d, outstanding=8, engine=engine)).items():
    setattr(P, k, staticmethod(v) if callable(v) and not isinstance(
        v, type) else v)
for name in IN["refusals"].tolist():
    try:
        refusal(name, P)()
        OUT["refusal/" + name] = np.asarray("no refusal")
    except Exception as e:
        OUT["refusal/" + name] = np.asarray(f"{type(e).__name__}: {e}")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"tests": np.asarray(str(REPO / "tests")),
              "cases_src": np.asarray(CASES_SRC),
              "refusals_src": np.asarray(REFUSALS_SRC),
              "names": np.asarray(ALL), "faulted": np.asarray(FAULTED),
              "refusals": np.asarray(list(REFUSALS))}
    for name in ALL:
        traces = targets_and_traces(name)[1]
        inputs["hosts/" + name] = np.asarray(len(traces))
        for h, tr in enumerate(traces):
            inputs[f"a/{name}/{h}"] = np.asarray([a for a, _, _ in tr])
            inputs[f"w/{name}/{h}"] = np.asarray([w for _, _, w in tr])
    return run_reference(REFERENCE, tmp_path_factory.mktemp("multihost"),
                         inputs)


def replay(name, **kw):
    tgts, traces = targets_and_traces(name)
    eng = MultiHostReplay(tgts, outstanding=OUTSTANDING,
                          metrics=MetricsSpec(), torch_device="cpu", **kw)
    return eng, eng.run(traces)


def as_json(bundle):
    return json.loads(json.dumps(bundle.to_jsonable()))


# ------------------------------------------------------------ golden pins
@pytest.mark.parametrize("name", PINNED)
def test_multi_host_pins_on_the_twin(name):
    res = MultiHostDriver(make_multi_targets(name), outstanding=OUTSTANDING,
                          engine="scan", metrics=MetricsSpec(),
                          torch_device="cpu").run(multi_traces(name))
    pins = golden(name)["python_scan"]
    assert len(res.per_host) == len(pins)
    for r, pin in zip(res.per_host, pins):
        assert r.latency_ticks.tolist() == pin["latency_ticks"]
        for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
            assert getattr(r, f) == pin[f], f
    assert as_json(res.metrics) == golden(name)["metrics"]


# ------------------------------------------- against the reference replay
@pytest.mark.parametrize("name", ALL)
def test_results_equal_the_reference_replay(name, reference):
    eng, res = replay(name)
    for h, r in enumerate(res.per_host):
        np.testing.assert_array_equal(r.latency_ticks,
                                      reference[f"lat/{name}/{h}"])
    want = reference["summary/" + name].tolist()
    assert [[r.accesses, r.elapsed_ticks, r.sum_latency_ticks, r.end_tick]
            for r in res.per_host] == want[:-1]
    assert [res.elapsed_ticks, eng.last_gc_runs] == want[-1][:2]
    assert as_json(res.metrics) == json.loads(
        str(reference["metrics/" + name]))


def test_the_cases_reach_their_shapes():
    """Each extra case takes the shape it is there for."""
    shapes = {}
    for name in CASES:
        tgts, traces = targets_and_traces(name)
        prep = MultiHostReplay(tgts, outstanding=OUTSTANDING,
                               torch_device="cpu").prepare(traces)
        shapes[name] = prep
    het = shapes["pool-hetero-dram"].params
    assert len(set(het["dev_occ"].tolist())) == 2
    assert len(set(het["dev_load"].tolist())) == 2
    seg = shapes["pool-segment-ssd"]
    assert set(np.unique(seg.devs[:, :200]).tolist()) == {0, 1}
    assert seg.addrs.max() < 24 * 4096
    inter = shapes["pool-interleave-dram"]
    assert set(np.unique(inter.devs[:, :200]).tolist()) == {0, 1, 2}
    ecmp = shapes["ecmp-mounts-ssd"]
    assert ecmp.cfg.max_routes > 1 and not ecmp.cfg.qos
    assert len(np.unique(ecmp.routes)) == ecmp.cfg.max_routes


# ------------------------------------------------- transport fault code
@pytest.mark.parametrize("name", FAULTED)
def test_path_codes_expand_to_the_reference_columns(name, reference):
    tgts, traces = targets_and_traces(name)
    eng = MultiHostReplay(tgts, outstanding=OUTSTANDING, torch_device="cpu")
    prep = eng.prepare(traces)
    table = {k: prep.params["path_" + k.removeprefix("hop_")]
             for k in ("hop_port", "hop_occ", "hop_after")}
    got = expand_fault_codes(table, prep.routes, prep.retries)
    live = (np.arange(prep.addrs.shape[1])
            < prep.lens[:, None])[..., None]
    for k, g in zip(("fhp", "fho", "fha", "fhon", "fhoc"), got):
        want = reference[f"cols/{name}/{k}"]
        g = (live & g) if k == "fhon" else np.where(live, g, 0).astype(
            g.dtype)
        assert g.dtype == want.dtype, (name, k)
        np.testing.assert_array_equal(g, want, err_msg=f"{name} {k}")
    fs = eng._meta["fault_stats"]
    assert fs == json.loads(str(reference["fstats/" + name]))
    faulted = eng._meta["faulted"]
    want = json.loads(str(reference["faulted/" + name]))
    assert [list(k) for k in faulted["port_keys"]] == want["port_keys"]
    for k in ("packets", "bytes", "occupied", "by_host"):
        assert faulted[k].tolist() == want[k], k
    assert faulted["ecmp"] == want["ecmp"]
    deg, fo = eng.fault_flags
    np.testing.assert_array_equal(deg, reference["deg/" + name])
    np.testing.assert_array_equal(fo, reference["fo/" + name])
    # compact: a path id and one byte a hop an access
    assert prep.routes.dtype == np.int32 and prep.retries.dtype == np.uint8
    assert fs["link_retries"] + fs["failovers"] > 0


def test_the_fault_table_keeps_each_hosts_paths_apart():
    tgts = make_multi_targets("faults-portdown@multihost_x2")
    eng = MultiHostReplay(tgts, outstanding=OUTSTANDING, torch_device="cpu")
    prep = eng.prepare(multi_traces("faults-portdown@multihost_x2"))
    dev = prep.params["path_dev"]
    for h in range(prep.cfg.num_hosts):
        n = int(prep.lens[h])
        assert set(dev[prep.routes[h, :n]].tolist()) == {h}
    fc = _MultiFaultColumns(eng._meta, eng._meta["transport_plan"],
                            prep.lens, prep.size)
    assert fc.num_hops == prep.cfg.max_hops


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_are_the_references(name, reference):
    want = str(reference["refusal/" + name])
    assert want.startswith("ReplayUnsupported: ") and REFUSALS[name] in want
    with pytest.raises(ReplayUnsupported) as e:
        refusal(name, _Port)()
    assert f"ReplayUnsupported: {e.value}" == want


@pytest.mark.parametrize("kw", [dict(chunk_size=64),
                                dict(return_latencies=False)])
def test_streaming_equals_the_one_shot_replay(kw):
    tgts, traces = targets_and_traces("multihost-ssd-mounts")
    want = MultiHostReplay(tgts, torch_device="cpu").run(traces)
    tgts, traces = targets_and_traces("multihost-ssd-mounts")
    got = MultiHostReplay(tgts, torch_device="cpu").run(traces, **kw)
    assert got.elapsed_ticks == want.elapsed_ticks
    for g, w in zip(got.per_host, want.per_host):
        assert (g.accesses, g.sum_latency_ticks, g.end_tick,
                g.elapsed_ticks) == (w.accesses, w.sum_latency_ticks,
                                     w.end_tick, w.elapsed_ticks)
        if "chunk_size" in kw:
            assert g.latency_ticks.tolist() == w.latency_ticks.tolist()


def test_block_size_is_validated_and_tick_invisible():
    tgts, traces = targets_and_traces("multihost-qos-ecmp")
    with pytest.raises(ValueError, match="block_size"):
        MultiHostReplay(tgts, block_size=0)
    a = MultiHostReplay(tgts, outstanding=OUTSTANDING, block_size=8,
                        torch_device="cpu").run(traces)
    pins = golden("multihost-qos-ecmp")["python_scan"]
    assert [r.latency_ticks.tolist() for r in a.per_host] == \
        [p["latency_ticks"] for p in pins]


# ------------------------------------------------ the single-host retry
def _pool_view():
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                       num_leaves=2)
    pool = MemoryPool(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
    return pool.view("h1")


def test_trace_driver_retries_a_pool_view_in_the_multi_host_replay():
    trace = make_trace(5, n=300, pages=48, write_frac=0.4)
    got = TraceDriver(_pool_view(), outstanding=OUTSTANDING, engine="scan",
                      metrics=MetricsSpec(), torch_device="cpu").run(trace)
    want = TraceDriver(_pool_view(), outstanding=OUTSTANDING,
                       metrics=MetricsSpec()).run(trace)
    for f in ("accesses", "elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(got, f) == getattr(want, f), f
    assert as_json(got.metrics) == as_json(want.metrics)
    assert got.latency_ticks.shape == (300,)


# ------------------------------------------------------------ the lanes
def test_poison_and_availability_ride_each_host():
    """A faulted multi-host replay carries per-host poison flags and the
    availability series of each host's degraded accesses."""
    from repro_torch.core.replay import metrics as M

    name = "faults-portdown@multihost_x2"
    tgts = make_multi_targets(name)
    install(FaultPlan(FaultConfig(down_links=(("s0", "sp0", 20, 90),),
                                  poison_rate=0.2), seed=11), tgts)
    eng = MultiHostReplay(tgts, outstanding=OUTSTANDING,
                          metrics=MetricsSpec(), torch_device="cpu")
    res = eng.run(multi_traces(name))
    deg, fo = eng.fault_flags
    plan = tgts[0].fault_plan
    for h, r in enumerate(res.per_host):
        n = r.accesses
        writes = np.asarray([w for _, _, w in multi_traces(name)[h]])
        np.testing.assert_array_equal(
            r.poison_flags, plan.poisoned_np(h, np.arange(n), writes))
        lat = r.latency_ticks
        assert r.availability["degraded_accesses"] == int(deg[h, :n].sum())
        assert r.availability["accesses"] == n == lat.size
    assert res.metrics.faults["poisoned_reads"] == sum(
        int(r.poison_flags.sum()) for r in res.per_host) > 0
    assert M.FAULT_COUNTERS == tuple(res.metrics.faults)
