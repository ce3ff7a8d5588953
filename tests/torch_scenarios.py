"""The port's builders of the golden scenarios' targets and traces.

``tests/golden/scenarios.py`` builds its targets from the JAX package; the
functions here build the same targets from the port (after
scenarios.py:123-335), with their own copies of its constants.  The module
imports the port and numpy only, neither pytest nor the golden fixture, so
``chip_smoke.py`` replays the scenarios on the card from it;
``test_torch_scenarios.py`` holds every constant and trace here equal to
the fixture's.
"""

from __future__ import annotations

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import CachedCXLSSDDevice, DRAMDevice, make_device
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.ssd.hil import HIL, SSDConfig
from repro_torch.core.ssd.pal import NANDTiming
from repro_torch.core.workloads.traces import hash_seed, make_trace
from repro_torch.data.workloads import WorkloadSpec, make_traces

# copies of tests/golden/scenarios.py's constants
CACHE_KW = dict(capacity_bytes=16 * 4096, mshr_entries=4, writeback_buffer=2)
DEVICES = ["dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache"]
N_ACCESSES = 160
OUTSTANDING = 8
STREAM_OUTSTANDING = 32
MULTI = dict(num_hosts=3, num_leaves=2, num_spines=2,
             qos_weights={"h0": 3.0, "h1": 1.0, "h2": 1.0})
MULTI_SSD_HOSTS = {"multihost-ssd-mounts": 2, "multihost-ssd-pool": 4,
                   "multihost-ssd-sharedflash": 2}
FAULT_SCENARIOS = ("faults-linkretry@spine_leaf",
                   "faults-portdown-failover@mesh",
                   "faults-nand-retry@direct")
MULTI_FAULT_HOSTS = {"faults-portdown@multihost_x2": 2,
                     "faults-linkretry@spine_leaf_x4": 4}
# a synthesized Zipfian fleet on a 2-pod datacenter fabric (host -> device
# paths through the core tier)
FLEET_SCENARIO = "fleet-zipf@multipod_2x4"
FLEET_GOLDEN_HOSTS = 8


def is_multi(name: str) -> bool:
    """Multi-host scenarios pin one latency list per host."""
    return (name.startswith("multihost") or name in MULTI_FAULT_HOSTS
            or name.startswith("fleet"))


def scenario_outstanding(name: str) -> int:
    return STREAM_OUTSTANDING if name.endswith("@stream") else OUTSTANDING


def mk_device(name: str):
    if name == "cxl-ssd-cache":
        return make_device(name, cache_cfg=DRAMCacheConfig(policy="lru",
                                                           **CACHE_KW))
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
    if name in FAULT_SCENARIOS:
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
    if name in MULTI_FAULT_HOSTS:
        nh = MULTI_FAULT_HOSTS[name]
        fab = Fabric.build("spine_leaf", num_hosts=nh, num_devices=nh,
                           num_leaves=2, num_spines=2, ecmp=True)
        tgts = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
                for i in range(nh)]
        cfg = (FaultConfig(down_links=(("s0", "sp0", 20, 90),))
               if name == "faults-portdown@multihost_x2"
               else FaultConfig(link_retry_rate=0.2, link_retry_max=2))
        install(FaultPlan(cfg, seed=11), tgts)
        return tgts
    if name == FLEET_SCENARIO:
        fab = Fabric.build("multi_pod", ecmp=True, num_pods=2,
                           hosts_per_pod=FLEET_GOLDEN_HOSTS // 2)
        return [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
                for i in range(FLEET_GOLDEN_HOSTS)]
    if name == "multihost-qos-ecmp":
        m = MULTI
        fab = Fabric.build("spine_leaf", num_hosts=m["num_hosts"],
                           num_devices=2, num_leaves=m["num_leaves"],
                           num_spines=m["num_spines"], ecmp=True,
                           qos_weights=m["qos_weights"])
        pool = MemoryPool(fab, {"d0": DRAMDevice(), "d1": DRAMDevice()})
        return pool.views([f"h{i}" for i in range(m["num_hosts"])])
    cache_cfg = dict(policy="lru", **CACHE_KW)
    if name == "multihost-ssd-pool":
        fab = Fabric.build("two_level", num_hosts=4, num_devices=2,
                           num_leaves=2)
        pool = MemoryPool(fab, {
            d: CachedCXLSSDDevice(cache_cfg=DRAMCacheConfig(**cache_cfg))
            for d in ("d0", "d1")})
        return pool.views([f"h{i}" for i in range(4)])
    nh = MULTI_SSD_HOSTS[name]
    fab = Fabric.build("two_level", num_hosts=nh, num_devices=nh,
                       num_leaves=2)
    hil = HIL(gc_ssd_cfg(48)) if name == "multihost-ssd-sharedflash" else None
    return [fab.mount(f"h{i}", f"d{i}", CachedCXLSSDDevice(
                cache_cfg=DRAMCacheConfig(**cache_cfg), hil=hil))
            for i in range(nh)]


def multi_traces(name: str):
    if name in MULTI_FAULT_HOSTS:
        return [make_trace(400 + h) for h in range(MULTI_FAULT_HOSTS[name])]
    if name == FLEET_SCENARIO:
        # the seeded synthetic workload generators' traffic
        spec = WorkloadSpec("zipfian", num_pages=48, zipf_s=1.1)
        return make_traces(spec, 29, FLEET_GOLDEN_HOSTS, N_ACCESSES)
    if name == "multihost-ssd-sharedflash":
        return [make_trace(300 + h, n=N_ACCESSES, pages=24, write_frac=0.7)
                for h in range(MULTI_SSD_HOSTS[name])]
    nh = MULTI_SSD_HOSTS.get(name, MULTI["num_hosts"])
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


# Faulted mounts beyond the golden scenarios, one source for both packages
# (exec'd here and in the JAX reference's child): NAND read retries with
# GC retirement on both flash devices, down windows that reroute an ECMP
# set onto a longer failover path, a CXL-DRAM's private hop behind a
# faulted fabric, and weighted QoS ports under CRC retries (with and
# without ECMP).
FAULT_CASES_SRC = '''
def make_fault_case(name, make_device, Fabric, DRAMCacheConfig, FaultConfig,
                    FaultPlan, install, SSDConfig, NANDTiming):
    def gc_flash(pages):
        return SSDConfig(capacity_bytes=pages * 4096, page_bytes=4096,
                         channels=2, dies_per_channel=2, pages_per_block=8,
                         timing=NANDTiming.low_latency(),
                         hil_overhead_ns=1000.0)
    cached = dict(policy="lru", capacity_bytes=16 * 4096, mshr_entries=4,
                  writeback_buffer=2)
    kind, shape = name.split("/")
    if kind == "nand-gc":
        dev = (make_device(shape, ssd_cfg=gc_flash(800),
                           cache_cfg=DRAMCacheConfig(
                               capacity_bytes=8 * 4096, mshr_entries=4,
                               writeback_buffer=2))
               if shape == "cxl-ssd-cache"
               else make_device(shape, ssd_cfg=gc_flash(800)))
        install(FaultPlan(FaultConfig(nand_read_retry_rate=0.4,
                                      erase_fail_rate=0.5, poison_rate=0.1),
                          seed=3), [dev])
        return dev
    if kind == "link":
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2)
        tgt = fab.mount("h1", "d0", make_device(shape), detach_link=False)
        install(FaultPlan(FaultConfig(link_retry_rate=0.3), seed=5), [tgt])
        return tgt
    qos = {"h0": 3.0, "h1": 1.0} if kind.startswith("qos") else None
    if kind == "qos-retry-fixed":
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2, qos_weights=qos)
        cfg = FaultConfig(link_retry_rate=0.3, link_retry_max=4)
    elif kind == "down-ecmp":
        # h0 on leaf s0, d0 on leaf s2: while both windows are down every
        # equal-cost path is, and the failover route detours through s1
        # (six hops against four)
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=3, num_spines=2, ecmp=True)
        cfg = FaultConfig(link_retry_rate=0.2,
                          down_links=(("s0", "sp1", 40, 120),
                                      ("s2", "sp0", 80, 160)))
    else:
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, ecmp=True,
                           qos_weights=qos)
        cfg = FaultConfig(link_retry_rate=0.2,
                          down_links=(("s0", "sp0", 40, 120),))
    dev = (make_device(shape, cache_cfg=DRAMCacheConfig(**cached))
           if shape == "cxl-ssd-cache" else make_device(shape))
    tgt = fab.mount("h0", "d0", dev)
    install(FaultPlan(cfg, seed=9), [tgt])
    return tgt


def fault_case_trace(name, make_trace):
    if name.startswith("nand-gc/"):
        trace = [(p * 4096, 64, True) for p in range(750)]
        trace += [(((k * 13) % 750) * 4096 + (k % 64) * 64, 64, k % 5 != 0)
                  for k in range(120)]
        return trace
    return make_trace(sum(map(ord, name)) % 997, n=400, pages=48,
                      write_frac=0.4)
'''
exec(FAULT_CASES_SRC)
FAULT_CASES = ["nand-gc/cxl-ssd-cache", "nand-gc/cxl-ssd", "link/cxl-dram",
               "down-ecmp/dram", "qos-retry/cxl-ssd-cache",
               "qos-retry-fixed/pmem"]


def fault_case(name: str):
    """Fresh port target and trace of the faulted mount ``name`` of
    :data:`FAULT_CASES`."""
    return (make_fault_case(name, make_device, Fabric, DRAMCacheConfig,
                            FaultConfig, FaultPlan, install, SSDConfig,
                            NANDTiming),
            fault_case_trace(name, make_trace))


# ``results/BENCH_replay.json``'s ``availability`` scenario, rebuilt from
# the port (benchmarks/replay_bench.py's ``collect_availability_derived``
# and its ``FOOTPRINT_PAGES`` / ``WRITE_FRAC``, which import the JAX
# package): DRAM devices privately mounted on a 2 x 2 spine-leaf with ECMP
# under CRC retries (rate 0.15, up to 2 a hop) and leaf s0's uplink to
# spine sp0 down over accesses [n / 4, 3n / 4) of each host's n
AVAIL_SEEDS = 16
AVAIL_HOSTS = (4, 8)
AVAIL_N = 320
AVAIL_PAGES = 1024
AVAIL_WRITE_FRAC = 0.3
AVAIL_TRACE_SEED = 17


def availability_case(num_hosts: int, accesses: int = AVAIL_N):
    """``(make_targets, traces)`` of the availability scenario at
    ``num_hosts`` hosts: ``make_targets(seed)`` mounts fresh targets under
    the plan of that seed."""
    import numpy as np

    fcfg = FaultConfig(link_retry_rate=0.15, link_retry_max=2,
                       down_links=(("s0", "sp0", accesses // 4,
                                    (3 * accesses) // 4),))

    def make_targets(seed):
        fab = Fabric.build("spine_leaf", num_hosts=num_hosts,
                           num_devices=num_hosts, num_leaves=2, num_spines=2,
                           ecmp=True)
        tgts = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
                for i in range(num_hosts)]
        install(FaultPlan(fcfg, seed=seed), tgts)
        return tgts

    rng = np.random.default_rng(AVAIL_TRACE_SEED)
    traces = []
    for _ in range(num_hosts):
        pages = rng.integers(0, AVAIL_PAGES, accesses)
        a = pages * 4096 + rng.integers(0, 64, accesses) * 64
        w = rng.random(accesses) < AVAIL_WRITE_FRAC
        traces.append([(int(x), 64, bool(y)) for x, y in zip(a, w)])
    return make_targets, traces


def availability_fields(lanes) -> dict:
    """The oracle's fields of ``fault_seed_sweep``'s lanes: per seed the
    pooled p50 / p99 / max latency, degraded fraction, failovers and
    failover penalty, time in degraded windows, link retries and elapsed
    ticks; the shared window axis; and the seed-averaged reachable
    fraction a window (``availability_curve``)."""
    import numpy as np

    def p(lat, q):
        return int(np.percentile(lat, q, method="higher"))

    seeds = {str(lane["seed"]): {
        "p50_ticks": p(lane["latency_ticks"], 50),
        "p99_ticks": p(lane["latency_ticks"], 99),
        "max_ticks": int(lane["latency_ticks"].max()),
        "degraded_fraction": lane["availability"]["degraded_fraction"],
        "failovers": lane["availability"]["failovers"],
        "failover_latency_penalty_ticks":
            lane["availability"]["failover_latency_penalty_ticks"],
        "time_in_degraded_windows_ticks":
            lane["availability"]["time_in_degraded_windows_ticks"],
        "link_retries": lane["fault_stats"]["link_retries"],
        "elapsed_ticks": int(lane["result"].elapsed_ticks),
    } for lane in lanes}
    av0 = lanes[0]["availability"]
    curve = {}
    for w in range(av0["num_windows"]):
        fracs = [lane["availability"]["windows"].get(str(w))
                 for lane in lanes]
        fracs = [f["reachable_fraction"] for f in fracs if f]
        if fracs:
            curve[str(w)] = round(sum(fracs) / len(fracs), 9)
    return {"window_ticks": av0["window_ticks"],
            "num_windows": av0["num_windows"], "seeds": seeds,
            "availability_curve": curve}


def shard_case(name: str):
    """``(targets, traces)`` of a sharded-lane case (fresh): a golden
    multi-host scenario, or ``shard/KIND-H``, ``H`` hosts mounted on a
    2-pod ``multi_pod`` fabric with ECMP, 60 seeded synthetic accesses a
    host (120 under NAND faults, so that reads reach the flash), where KIND is ``multipod`` (DRAM), ``qos`` (DRAM, weighted
    hosts), ``pmem``, ``cxl-ssd-cache`` (a private flash a host), ``nand``
    (that under NAND read retries) or ``transport`` (DRAM under CRC
    retries)."""
    if not name.startswith("shard/"):
        return make_multi_targets(name), multi_traces(name)
    kind, nh = name.split("/")[1].rsplit("-", 1)
    nh = int(nh)
    media = {"pmem": "pmem", "cxl-ssd-cache": "cxl-ssd-cache",
             "nand": "cxl-ssd-cache"}.get(kind, "dram")
    kw = ({"cache_cfg": DRAMCacheConfig(capacity_bytes=16 * 4096,
                                        mshr_entries=4, writeback_buffer=2)}
          if media == "cxl-ssd-cache" else {})
    qw = {f"h{i}": 1.0 + (i % 3) for i in range(nh)} if kind == "qos" else None
    fab = Fabric.build("multi_pod", ecmp=True, qos_weights=qw, num_pods=2,
                       hosts_per_pod=nh // 2)
    tgts = [fab.mount(f"h{i}", f"d{i}", make_device(media, **kw))
            for i in range(nh)]
    if kind == "nand":
        install(FaultPlan(FaultConfig(nand_read_retry_rate=0.3), seed=3),
                tgts)
    if kind == "transport":
        install(FaultPlan(FaultConfig(link_retry_rate=0.25,
                                      link_retry_max=2), seed=5), tgts)
    spec = WorkloadSpec("zipfian" if kind == "nand" else "hotspot",
                        num_pages=96, hot_frac=0.8, hot_pages=12, zipf_s=1.1)
    return tgts, make_traces(spec, 7, nh, 120 if kind == "nand" else 60)
