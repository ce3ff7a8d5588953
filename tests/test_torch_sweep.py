"""The design-space sweeps on the CPU, where each sweep replays its lanes
through the ``replay_scan`` sweep instances' plain twins, against the JAX
package's ``sweep.py`` and the port's own standalone replays.

The reference runs in one child process for this file (its ``sweep.py``
imports ``jax.experimental.enable_x64``, which only the child's alias
provides).  On the same seeded inputs, every array and field each sweep
returns equals the reference's: ``cache_design_sweep`` over capacities
``[4, 16, 8]`` x LRU / FIFO on a 16-frame cached CXL-SSD, with every
key of the cached stack's params overridden lane by lane, and over
per-lane ``(B, N)`` traces; ``host_count_sweep`` over ``[1, 2, 4]`` on a
DRAM pool and a cached two-level pool; ``fault_seed_sweep`` on a 4-host
spine-leaf under CRC retries and a down link whose spine and window the
seed picks (so the seeds' path sets differ), 4 seeds.  Each lane also equals
the port's standalone replay of its configuration, and every refusal of
the reference is the port's, word for word.  ``results/BENCH_replay.json``
``availability`` (16 seeds at 4 and 8 hosts) is reproduced field for
field.  Every comparison is exact (the failover penalty, a float, too).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import (CachedCXLSSDDevice, DRAMDevice,
                                      make_device)
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay import stack
from repro_torch.core.replay import sweep as sw
from repro_torch.core.replay.engine import ReplayEngine
from repro_torch.core.replay.multihost import MultiHostReplay
from repro_torch.core.replay.spec import (MAX_ACCESSES, ReplayUnsupported,
                                          build_stack)
from repro_torch.core.ssd.hil import HIL
from repro_torch.kernels import replay_scan as rs
from test_torch_reference import REPO, run_reference
from torch_scenarios import (AVAIL_HOSTS, AVAIL_N, AVAIL_SEEDS,
                             availability_case, availability_fields,
                             gc_ssd_cfg)

# The scenarios, one source for both packages (exec'd here and in the
# reference's child with a namespace ``P`` of the package's names).
SCENARIOS_SRC = '''
def cached_cfg(P, frames=16, policy="lru"):
    return P.DRAMCacheConfig(policy=policy, capacity_bytes=frames * 4096,
                             mshr_entries=4, writeback_buffer=2)


def cache_device(P, frames=16, policy="lru"):
    return P.make_device("cxl-ssd-cache",
                         cache_cfg=cached_cfg(P, frames, policy))


def gc_device(P):
    return P.make_device("cxl-ssd-cache", ssd_cfg=P.gc_ssd_cfg(750),
                         cache_cfg=P.DRAMCacheConfig(
                             capacity_bytes=8 * 4096, mshr_entries=4,
                             writeback_buffer=2))


def dram_pool(P, nh=4):
    fab = P.Fabric.build("single_switch", num_hosts=4, num_devices=1)
    pool = P.MemoryPool(fab, {"d0": P.DRAMDevice()})
    return pool.views([f"h{i}" for i in range(nh)])


def cached_pool(P, nh=4):
    # a fixed 4-host fabric: the sweep masks hosts, it does not rewire
    fab = P.Fabric.build("two_level", num_hosts=4, num_devices=2,
                         num_leaves=2)
    pool = P.MemoryPool(fab, {"d0": cache_device(P), "d1": cache_device(P)})
    return pool.views([f"h{i}" for i in range(nh)])


def seed_targets(P, seed, nh=4):
    # CRC retries and leaf s0's uplink to a spine down: to sp0 over a
    # window for even seeds, to sp1 for the whole trace for odd ones, so
    # the seeds' path sets differ
    fab = P.Fabric.build("spine_leaf", num_hosts=nh, num_devices=nh,
                         num_leaves=2, num_spines=2, ecmp=True)
    tgts = [fab.mount(f"h{i}", f"d{i}", P.make_device("dram"))
            for i in range(nh)]
    down = ("s0", "sp0", 40, 120) if seed % 2 == 0 else ("s0", "sp1", 0,
                                                         1 << 20)
    P.install(P.FaultPlan(P.FaultConfig(
        link_retry_rate=0.15, link_retry_max=2, down_links=(down,)),
        seed=seed), tgts)
    return tgts


def shared_flash(P, fabric, faults=None):
    fab = P.Fabric.build(fabric, num_hosts=2, num_devices=2, num_leaves=2,
                         **({"num_spines": 2, "ecmp": True}
                            if fabric == "spine_leaf" else {}))
    hil = P.HIL(P.gc_ssd_cfg(24))
    tgts = [fab.mount(f"h{i}", f"d{i}", P.CachedCXLSSDDevice(
        cache_cfg=P.DRAMCacheConfig(capacity_bytes=4 * 4096,
                                    mshr_entries=2, writeback_buffer=1),
        hil=hil)) for i in range(2)]
    if faults is not None:
        P.install(P.FaultPlan(P.FaultConfig(**faults[0]), seed=faults[1]),
                  tgts)
    return tgts


def overfill_traces():
    return [[(4096 * ((7 * k + 3 * h) % 40), 64, True) for k in range(600)]
            for h in range(2)]


def refusal(name, P):
    a = P.np.arange(64, dtype=P.np.int64) * 4096
    w = P.np.arange(64) % 3 == 0
    if name == "lane-lengths":
        return lambda: P.cache_design_sweep(
            cache_device(P), a, w, capacity_frames=[4, 8], is_lru=[True])
    if name == "unknown-timing":
        return lambda: P.cache_design_sweep(
            cache_device(P), a, w, capacity_frames=[4, 8],
            is_lru=[True, False], timing_overrides={"warp_t": [1, 2]})
    if name == "override-lanes":
        return lambda: P.cache_design_sweep(
            cache_device(P), a, w, capacity_frames=[4, 8],
            is_lru=[True, False], timing_overrides={"read_t": [1, 2, 3]})
    if name == "too-long":
        big = P.np.zeros(P.MAX_ACCESSES + 1, P.np.int64)
        return lambda: P.cache_design_sweep(
            cache_device(P), big, big > 0, capacity_frames=[4],
            is_lru=[True])
    if name == "not-cached":
        return lambda: P.cache_design_sweep(
            P.make_device("cxl-ssd"), a, w, capacity_frames=[4],
            is_lru=[True])
    if name == "direct-mapped":
        return lambda: P.cache_design_sweep(
            cache_device(P, policy="direct"), a, w, capacity_frames=[4],
            is_lru=[True])
    if name in ("cap-zero", "cap-over"):
        caps = [0, 4] if name == "cap-zero" else [4, 17]
        return lambda: P.cache_design_sweep(
            cache_device(P), a, w, capacity_frames=caps,
            is_lru=[True, True])
    if name == "gc-overfill":
        bad = P.np.arange(1100, dtype=P.np.int64) * 4096
        return lambda: P.cache_design_sweep(
            gc_device(P), bad, bad >= 0, capacity_frames=[8, 4],
            is_lru=[True, True])
    if name == "ecmp":
        fab = P.Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                             num_leaves=2, num_spines=2, ecmp=True)
        dev = fab.mount("h0", "d0", cache_device(P))
        return lambda: P.cache_design_sweep(dev, a, w, capacity_frames=[4],
                                            is_lru=[True])
    if name == "host-gc-overfill":
        tgts = shared_flash(P, "two_level")
        return lambda: P.host_count_sweep(tgts, overfill_traces(), [1, 2],
                                          outstanding=8)
    if name == "no-transport-plan":
        return lambda: P.fault_seed_sweep(
            lambda s: dram_pool(P, 2), [[(0, 64, False)]] * 2, [0, 1],
            outstanding=8)
    if name == "seed-shape":
        def mk(seed):
            fab = P.Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                                 num_leaves=2, num_spines=2, ecmp=True)
            tgts = [fab.mount(f"h{i}", f"d{i}",
                              cache_device(P, frames=16 >> seed))
                    for i in range(2)]
            P.install(P.FaultPlan(P.FaultConfig(link_retry_rate=0.2),
                                  seed=seed), tgts)
            return tgts
        tr = [[(4096 * k, 64, False) for k in range(20)]] * 2
        return lambda: P.fault_seed_sweep(mk, tr, [0, 1], outstanding=8)
    assert name == "seed-gc-overfill", name
    return lambda: P.fault_seed_sweep(
        lambda s: shared_flash(P, "spine_leaf",
                               ({"link_retry_rate": 0.2}, s)),
        overfill_traces(), [3, 4], outstanding=8)
'''
exec(SCENARIOS_SRC)

# each refusal and the words of its reason (the reference's own)
REFUSALS = {
    "lane-lengths": "capacity_frames and is_lru must share a length",
    "unknown-timing": "unknown timing parameter 'warp_t'",
    "override-lanes": "override 'read_t' must have 2 lanes",
    "too-long": "packed-stamp budget",
    "not-cached": "cache_design_sweep needs a cached CXL-SSD",
    "direct-mapped": "sweep direct-mapped separately",
    "cap-zero": "capacity lane exceeds the device's frames",
    "cap-over": "capacity lane exceeds the device's frames",
    "gc-overfill": "FTL ran out of free blocks during GC",
    "ecmp": "ECMP stack needs a per-access route column",
    "host-gc-overfill": "FTL ran out of free blocks",
    "no-transport-plan": "needs an active transport fault plan",
    "seed-shape": "fault seeds changed the compiled shape",
    "seed-gc-overfill": "FTL ran out of free blocks during GC",
}
CAPS, LRUS = [4, 16, 8], [True, False, True]
HOST_COUNTS = [1, 2, 4]
SEEDS = [0, 1, 2, 3]
POOLS = ("dram_pool", "cached_pool")


class P:
    """The port's names under the namespace :data:`SCENARIOS_SRC` reads,
    the sweeps on the CPU."""

    np = np
    DRAMCacheConfig = DRAMCacheConfig
    DRAMDevice = DRAMDevice
    CachedCXLSSDDevice = CachedCXLSSDDevice
    Fabric = Fabric
    MemoryPool = MemoryPool
    FaultConfig = FaultConfig
    FaultPlan = FaultPlan
    HIL = HIL
    MAX_ACCESSES = MAX_ACCESSES
    make_device = staticmethod(make_device)
    install = staticmethod(install)
    gc_ssd_cfg = staticmethod(gc_ssd_cfg)

    @staticmethod
    def cache_design_sweep(*a, **kw):
        return sw.cache_design_sweep(*a, torch_device="cpu", **kw)

    @staticmethod
    def host_count_sweep(*a, **kw):
        return sw.host_count_sweep(*a, torch_device="cpu", **kw)

    @staticmethod
    def fault_seed_sweep(*a, **kw):
        return sw.fault_seed_sweep(*a, torch_device="cpu", **kw)


def _columns(seed, n, pages, write_frac):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, pages, n) * 4096
         + rng.integers(0, 64, n) * 64).astype(np.int64)
    return a, rng.random(n) < write_frac


def _trace(seed, n, pages=48, write_frac=0.3):
    a, w = _columns(seed, n, pages, write_frac)
    return [(int(x), 64, bool(y)) for x, y in zip(a, w)]


CACHE_ADDRS, CACHE_WRITES = _columns(41, 1200, 24, 0.3)
LANE_ADDRS = np.stack([_columns(50 + k, 600, 40, 0.4)[0] for k in range(3)])
LANE_WRITES = np.stack([_columns(50 + k, 600, 40, 0.4)[1] for k in range(3)])
HOST_TRACES = {"dram_pool": [_trace(50 + h, 700) for h in range(4)],
               "cached_pool": [_trace(105 + h, 250) for h in range(4)]}
SEED_TRACES = [_trace(70 + h, 200, pages=1024) for h in range(4)]


def _all_overrides():
    """Every key of the cached stack's params, varied over 3 lanes (lane
    0 keeps the device's value)."""
    _, params = build_stack(cache_device(P), size=64, outstanding=32,
                            issue_overhead_ns=0.5, posted_writes=True,
                            n_accesses=CACHE_ADDRS.size,
                            max_addr=int(CACHE_ADDRS.max()))
    out = {}
    for k, v in params.items():
        if k == "is_lru":
            out[k] = np.asarray([True, False, True])
        elif k == "cap":
            out[k] = np.asarray([16, 8, 12], np.int64)
        else:
            v = np.asarray(v, np.int64)
            out[k] = np.stack([v, 2 * v, v // 2 + 1])
    return out


OVERRIDES = _all_overrides()

REFERENCE = '''
import json, sys
sys.path.insert(0, IN["tests"].item())
exec(IN["scenarios_src"].item())
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import CachedCXLSSDDevice, DRAMDevice, make_device
from repro.core.fabric import Fabric, MemoryPool
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import sweep
from repro.core.replay.stack import MAX_ACCESSES
from repro.core.ssd.hil import HIL
from golden import scenarios as sc


class P:
    pass


for k, v in dict(np=np, DRAMCacheConfig=DRAMCacheConfig,
                 DRAMDevice=DRAMDevice,
                 CachedCXLSSDDevice=CachedCXLSSDDevice, Fabric=Fabric,
                 MemoryPool=MemoryPool, FaultConfig=FaultConfig,
                 FaultPlan=FaultPlan, HIL=HIL, MAX_ACCESSES=MAX_ACCESSES,
                 make_device=make_device, install=install,
                 gc_ssd_cfg=sc._gc_ssd_cfg,
                 cache_design_sweep=sweep.cache_design_sweep,
                 host_count_sweep=sweep.host_count_sweep,
                 fault_seed_sweep=sweep.fault_seed_sweep).items():
    setattr(P, k, staticmethod(v) if callable(v) and not isinstance(
        v, type) else v)

OUT["disabled"] = np.asarray(sweep.DISABLED)


def trace(prefix, h):
    return [(int(a), 64, bool(w)) for a, w in zip(IN[f"{prefix}/a/{h}"],
                                                  IN[f"{prefix}/w/{h}"])]


def keep(prefix, out):
    for k, v in out.items():
        OUT[f"{prefix}/{k}"] = np.asarray(v)


keep("cache/basic", sweep.cache_design_sweep(
    cache_device(P), IN["cache/a"], IN["cache/w"],
    capacity_frames=IN["caps"], is_lru=IN["lrus"]))
keep("cache/override", sweep.cache_design_sweep(
    cache_device(P), IN["cache/a"], IN["cache/w"],
    capacity_frames=[16, 16, 16], is_lru=[True, True, True],
    timing_overrides={k[len("over/"):]: IN[k] for k in IN
                      if k.startswith("over/")}))
keep("cache/lanes", sweep.cache_design_sweep(
    cache_device(P), IN["lanes/a"], IN["lanes/w"],
    capacity_frames=[16, 5, 16], is_lru=[True, False, False]))

for pool in IN["pools"].tolist():
    info = {}
    traces = [trace(pool, h) for h in range(4)]
    lanes = sweep.host_count_sweep(globals()[pool](P), traces,
                                   IN["host_counts"].tolist(), info=info)
    OUT[f"hosts/{pool}"] = np.asarray(
        [[[r.accesses, r.bytes_moved, r.elapsed_ticks, r.sum_latency_ticks,
           r.end_tick] for r in lane.per_host] for lane in lanes])
    OUT[f"hosts/{pool}/elapsed"] = np.asarray([l.elapsed_ticks
                                               for l in lanes])
    OUT[f"hosts/{pool}/info"] = np.asarray(json.dumps(info))

traces = [trace("seeds", h) for h in range(4)]
for lane in sweep.fault_seed_sweep(lambda s: seed_targets(P, s), traces,
                                   IN["seeds"].tolist(), outstanding=8):
    s = lane["seed"]
    r = lane["result"]
    OUT[f"seeds/{s}/result"] = np.asarray(
        [[x.accesses, x.bytes_moved, x.elapsed_ticks, x.sum_latency_ticks,
          x.end_tick] for x in r.per_host] + [[r.elapsed_ticks] * 5])
    OUT[f"seeds/{s}/latency"] = lane["latency_ticks"]
    OUT[f"seeds/{s}/availability"] = np.asarray(json.dumps(
        lane["availability"], sort_keys=True))
    OUT[f"seeds/{s}/stats"] = np.asarray(json.dumps(lane["fault_stats"],
                                                    sort_keys=True))

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
              "scenarios_src": np.asarray(SCENARIOS_SRC),
              "caps": np.asarray(CAPS), "lrus": np.asarray(LRUS),
              "cache/a": CACHE_ADDRS, "cache/w": CACHE_WRITES,
              "lanes/a": LANE_ADDRS, "lanes/w": LANE_WRITES,
              "pools": np.asarray(POOLS),
              "host_counts": np.asarray(HOST_COUNTS),
              "seeds": np.asarray(SEEDS),
              "refusals": np.asarray(list(REFUSALS))}
    inputs.update({f"over/{k}": v for k, v in OVERRIDES.items()})
    for prefix, traces in [*HOST_TRACES.items(), ("seeds", SEED_TRACES)]:
        for h, tr in enumerate(traces):
            inputs[f"{prefix}/a/{h}"] = np.asarray([a for a, _, _ in tr])
            inputs[f"{prefix}/w/{h}"] = np.asarray([w for _, _, w in tr])
    return run_reference(REFERENCE, tmp_path_factory.mktemp("sweep"),
                         inputs, timeout=900)


# ------------------------------------------------------- the cache sweep
CACHE_RUNS = {
    "basic": lambda: P.cache_design_sweep(
        cache_device(P), CACHE_ADDRS, CACHE_WRITES, capacity_frames=CAPS,
        is_lru=LRUS),
    "override": lambda: P.cache_design_sweep(
        cache_device(P), CACHE_ADDRS, CACHE_WRITES,
        capacity_frames=[16, 16, 16], is_lru=[True, True, True],
        timing_overrides=OVERRIDES),
    "lanes": lambda: P.cache_design_sweep(
        cache_device(P), LANE_ADDRS, LANE_WRITES,
        capacity_frames=[16, 5, 16], is_lru=[True, False, False]),
}
CACHE_KEYS = ("latency_ticks", "hit_flags", "evict_flags",
              "sum_latency_ticks", "hit_rate", "elapsed_ticks")
_RUNS = {}


def cache_run(name):
    if name not in _RUNS:
        _RUNS[name] = CACHE_RUNS[name]()
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CACHE_RUNS))
def test_cache_design_sweep_equals_the_reference(reference, name):
    got = cache_run(name)
    assert sorted(got) == sorted(CACHE_KEYS)
    for k in CACHE_KEYS:
        want = reference[f"cache/{name}/{k}"]
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_cache_lanes_equal_standalone_engines():
    out = cache_run("basic")
    for k, (c, lru) in enumerate(zip(CAPS, LRUS)):
        r = ReplayEngine(cache_device(P, c, "lru" if lru else "fifo"),
                         torch_device="cpu").run_arrays(CACHE_ADDRS,
                                                        CACHE_WRITES)
        np.testing.assert_array_equal(out["latency_ticks"][k],
                                      r.latency_ticks)
        np.testing.assert_array_equal(out["hit_flags"][k], r.hit_flags)
        np.testing.assert_array_equal(out["evict_flags"][k], r.evict_flags)
        assert int(out["sum_latency_ticks"][k]) == r.sum_latency_ticks
        assert int(out["elapsed_ticks"][k]) == r.elapsed_ticks


def test_per_lane_traces_equal_standalone_engines():
    out = cache_run("lanes")
    for k, (c, lru) in enumerate(zip([16, 5, 16], [True, False, False])):
        r = ReplayEngine(cache_device(P, c, "lru" if lru else "fifo"),
                         torch_device="cpu").run_arrays(LANE_ADDRS[k],
                                                        LANE_WRITES[k])
        np.testing.assert_array_equal(out["latency_ticks"][k],
                                      r.latency_ticks)
        np.testing.assert_array_equal(out["hit_flags"][k], r.hit_flags)


@pytest.mark.parametrize("key", sorted(OVERRIDES))
def test_every_timing_key_moves_its_lane_as_a_standalone_replay(key):
    """A sweep that overrides ``key`` alone: each lane equals the
    one-launch replay (its plain twin) of the stack with that lane's
    params and a cache of that lane's capacity, fresh."""
    vals = OVERRIDES[key]
    out = P.cache_design_sweep(
        cache_device(P), CACHE_ADDRS[:400], CACHE_WRITES[:400],
        capacity_frames=[16] * 3, is_lru=[True] * 3,
        timing_overrides={key: vals})
    cfg, lanes = sw.cache_lanes(
        cache_device(P), CACHE_ADDRS[:400], CACHE_WRITES[:400],
        capacity_frames=[16] * 3, is_lru=[True] * 3,
        timing_overrides={key: vals})
    lat = []
    for k, p in enumerate(lanes):
        one = dataclasses.replace(cfg, cache_frames=int(p["cap"]))
        iss, dn, fl, _, _ = rs.replay_scan(
            one, p, stack.init_state(one), torch.from_numpy(
                CACHE_ADDRS[:400]), torch.from_numpy(CACHE_WRITES[:400]))
        np.testing.assert_array_equal(out["latency_ticks"][k],
                                      (dn - iss).numpy())
        np.testing.assert_array_equal(out["hit_flags"][k],
                                      (fl & 1).numpy().astype(bool))
        lat.append(out["latency_ticks"][k])
    # the key moves a lane (lane 0 keeps the device's value); no GC runs
    # on this trace, so no erase does
    assert any(not np.array_equal(lat[0], x) for x in lat[1:]) or (
        key == "erase_t"), key


def test_the_sweep_keeps_disabled_frames_and_their_constant(reference):
    assert sw.DISABLED == stack.DISABLED == int(reference["disabled"])
    cfg, lanes = sw.cache_lanes(cache_device(P), CACHE_ADDRS, CACHE_WRITES,
                                capacity_frames=CAPS, is_lru=LRUS)
    state = stack.init_sweep(cfg, CAPS)
    rs.replay_sweep(cfg, lanes, state, torch.from_numpy(CACHE_ADDRS),
                    torch.from_numpy(CACHE_WRITES))
    frames = state["media"]["frames"]
    for k, c in enumerate(CAPS):
        assert (frames[k, c:] == stack.DISABLED).all()
        assert (frames[k, :c] >= 0).all()      # every enabled frame filled


def test_replay_sweep_refuses_frames_other_than_a_fresh_capacity_lane():
    cfg, lanes = sw.cache_lanes(cache_device(P), CACHE_ADDRS, CACHE_WRITES,
                                capacity_frames=CAPS, is_lru=LRUS)
    a, w = torch.from_numpy(CACHE_ADDRS), torch.from_numpy(CACHE_WRITES)
    # every frame free is not a lane of capacity 4
    state = stack.init_sweep(cfg, [16, 16, 16])
    with pytest.raises(ValueError, match="fresh cache of its capacity"):
        rs.replay_sweep(cfg, lanes, state, a, w)
    state = stack.init_sweep(cfg, CAPS)
    state["media"]["frames"][1, 3] = 5
    with pytest.raises(ValueError, match="fresh cache of its capacity"):
        rs.replay_sweep(cfg, lanes, state, a, w)
    bad = [dict(p, cap=np.int64(17)) for p in lanes]
    with pytest.raises(ValueError, match="cap must lie in"):
        rs.replay_sweep(cfg, bad, stack.init_sweep(cfg, CAPS), a, w)
    with pytest.raises(ValueError, match="addresses must be"):
        rs.replay_sweep(cfg, lanes, stack.init_sweep(cfg, CAPS), a * 4096, w)


def test_victim_order_runs_over_the_lanes_capacity():
    cfg, lanes = sw.cache_lanes(cache_device(P), CACHE_ADDRS, CACHE_WRITES,
                                capacity_frames=CAPS, is_lru=LRUS)
    state = stack.init_sweep(cfg, CAPS)
    rs.replay_sweep(cfg, lanes, state, torch.from_numpy(CACHE_ADDRS),
                    torch.from_numpy(CACHE_WRITES))
    for k, c in enumerate(CAPS):
        frames = state["media"]["frames"][k].numpy()
        fill, head, tail, where, links = rs.victim_order(cfg, lanes[k],
                                                         frames)
        if lanes[k]["is_lru"]:
            assert fill == c and 0 <= head < c and 0 <= tail < c
            assert (links[c:] == -1).all()
        else:
            # FIFO: past a full cache the fill pointer counts nf + victim
            assert c <= fill < 2 * c
        assert set(where[where >= 0].tolist()) == set(range(c))


# ------------------------------------------------- the host-count sweep
_HOSTS = {}


def host_run(pool):
    if pool not in _HOSTS:
        info = {}
        _HOSTS[pool] = (P.host_count_sweep(globals()[pool](P),
                                           HOST_TRACES[pool], HOST_COUNTS,
                                           info=info), info)
    return _HOSTS[pool]


def _fields(r):
    return [r.accesses, r.bytes_moved, r.elapsed_ticks, r.sum_latency_ticks,
            r.end_tick]


@pytest.mark.parametrize("pool", POOLS)
def test_host_count_sweep_equals_the_reference(reference, pool):
    lanes, info = host_run(pool)
    got = np.asarray([[_fields(r) for r in lane.per_host]
                      for lane in lanes])
    np.testing.assert_array_equal(got, reference[f"hosts/{pool}"])
    np.testing.assert_array_equal([lane.elapsed_ticks for lane in lanes],
                                  reference[f"hosts/{pool}/elapsed"])
    assert info == json.loads(str(reference[f"hosts/{pool}/info"]))


@pytest.mark.parametrize("pool", POOLS)
def test_host_count_lanes_equal_standalone_replays(pool):
    lanes, _ = host_run(pool)
    for h, lane in zip(HOST_COUNTS, lanes):
        one = MultiHostReplay(globals()[pool](P, h),
                              torch_device="cpu").run(HOST_TRACES[pool][:h])
        assert one.elapsed_ticks == lane.elapsed_ticks
        assert [_fields(r) for r in one.per_host] == [
            _fields(r) for r in lane.per_host[:h]]
        assert all(r.accesses == 0 for r in lane.per_host[h:])


def test_a_fault_free_replay_has_no_fault_stats():
    eng = MultiHostReplay(dram_pool(P, 2), torch_device="cpu")
    assert eng.fault_stats is None
    eng.prepare(HOST_TRACES["dram_pool"][:2])
    assert eng.fault_stats is None


@pytest.mark.parametrize("devices", [None, range(2)])
def test_host_count_sweep_sharded_equals_the_unsharded_sweep(devices):
    # faulted mounts (CRC retries and a down window), a launch a host count
    # through the sharded lane; the reference's sharded sweep is held in
    # test_torch_shard.py
    info = {}
    got = P.host_count_sweep(seed_targets(P, 2), SEED_TRACES, [1, 2, 4],
                             outstanding=8, sharded=True, devices=devices,
                             info=info)
    want = P.host_count_sweep(seed_targets(P, 2), SEED_TRACES, [1, 2, 4],
                              outstanding=8)
    shards = 4 if devices is None else 2
    assert info == {"sharded": True, "device_count": shards,
                    "hosts_per_device": 4 // shards}
    for g, w in zip(got, want):
        assert g.elapsed_ticks == w.elapsed_ticks
        assert [_fields(r) for r in g.per_host] == [_fields(r)
                                                    for r in w.per_host]


def test_host_count_sweep_sharded_refuses_a_pool():
    with pytest.raises(ReplayUnsupported, match="unsharded MultiHostReplay"):
        P.host_count_sweep(dram_pool(P), HOST_TRACES["dram_pool"], [1, 2],
                           sharded=True)


# --------------------------------------------------- the fault-seed sweep
_SEEDS = {}


def seed_run():
    if not _SEEDS:
        info = {}
        _SEEDS["lanes"] = P.fault_seed_sweep(
            lambda s: seed_targets(P, s), SEED_TRACES, SEEDS, outstanding=8,
            info=info)
        _SEEDS["info"] = info
    return _SEEDS["lanes"]


def test_fault_seed_sweep_equals_the_reference(reference):
    lanes = seed_run()
    assert [lane["seed"] for lane in lanes] == SEEDS
    for lane in lanes:
        s, r = lane["seed"], lane["result"]
        np.testing.assert_array_equal(
            np.asarray([_fields(x) for x in r.per_host]
                       + [[r.elapsed_ticks] * 5]),
            reference[f"seeds/{s}/result"])
        np.testing.assert_array_equal(lane["latency_ticks"],
                                      reference[f"seeds/{s}/latency"])
        assert json.dumps(lane["availability"], sort_keys=True) == str(
            reference[f"seeds/{s}/availability"])
        assert json.dumps(lane["fault_stats"], sort_keys=True) == str(
            reference[f"seeds/{s}/stats"])


def test_fault_seed_lanes_equal_standalone_replays():
    lanes = seed_run()
    assert _SEEDS["info"]["column_seconds"] > 0
    for lane in lanes:
        eng = MultiHostReplay(seed_targets(P, lane["seed"]), outstanding=8,
                              torch_device="cpu")
        one = eng.run(SEED_TRACES)
        assert eng.fault_stats == lane["fault_stats"]
        assert one.elapsed_ticks == lane["result"].elapsed_ticks
        np.testing.assert_array_equal(
            np.concatenate([r.latency_ticks for r in one.per_host]),
            lane["latency_ticks"])
        assert [_fields(r) for r in one.per_host] == [
            _fields(r) for r in lane["result"].per_host]


def test_fault_seeds_take_different_path_sets():
    fl = sw.fault_lanes(lambda s: seed_targets(P, s), SEED_TRACES, SEEDS,
                        outstanding=8, torch_device="cpu")
    own = [MultiHostReplay(seed_targets(P, s), outstanding=8,
                           torch_device="cpu").prepare(SEED_TRACES)
           for s in SEEDS]
    tables = [{tuple(r) for r in p.params["path_port"].tolist()}
              for p in own]
    assert tables[0] != tables[1]
    union = {tuple(r) for r in fl.params["path_port"].tolist()}
    assert union == set().union(*tables)
    # each lane's remapped ids name the paths its own ids name
    for k, p in enumerate(own):
        live = np.arange(p.addrs.shape[1])[None, :] < p.lens[:, None]
        for key in ("path_port", "path_occ", "path_after"):
            np.testing.assert_array_equal(
                np.asarray(fl.params[key])[fl.routes[k]][live],
                np.asarray(p.params[key])[p.routes][live])


# -------------------------------------------------------------- refusals
def _refusal(name):
    try:
        refusal(name, P)()
    except Exception as e:      # noqa: BLE001 - compared by type and text
        return f"{type(e).__name__}: {e}"
    return "no refusal"


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_are_the_references(reference, name):
    got = _refusal(name)
    assert REFUSALS[name] in got, got
    assert got == str(reference["refusal/" + name])


# ------------------------------------------------- the availability oracle
AVAIL = json.loads((REPO / "results" / "BENCH_replay.json").read_text())[
    "availability"]


def test_the_availability_scenario_takes_the_oracles_constants():
    assert (AVAIL["n_seeds"], AVAIL["accesses_per_host"]) == (
        AVAIL_SEEDS, AVAIL_N)
    assert AVAIL["fault_config"] == {
        "link_retry_rate": 0.15, "link_retry_max": 2,
        "down_links": [["s0", "sp0", AVAIL_N // 4, 3 * AVAIL_N // 4]]}
    assert sorted(AVAIL) == sorted(
        ["n_seeds", "accesses_per_host", "fault_config"]
        + [f"hosts_x{nh}" for nh in AVAIL_HOSTS])


@pytest.mark.parametrize("nh", AVAIL_HOSTS)
def test_the_availability_oracle_is_reproduced(nh):
    """``results/BENCH_replay.json`` ``availability`` at ``nh`` hosts:
    every per-seed field, the window axis and the seed-averaged curve."""
    make_targets, traces = availability_case(nh)
    lanes = sw.fault_seed_sweep(make_targets, traces,
                                list(range(AVAIL_SEEDS)), outstanding=8,
                                torch_device="cpu")
    want = AVAIL[f"hosts_x{nh}"]
    got = availability_fields(lanes)
    assert got["seeds"] == want["seeds"]
    assert (got["window_ticks"], got["num_windows"]) == (
        want["window_ticks"], want["num_windows"])
    assert got["availability_curve"] == want["availability_curve"]


def test_the_sweeps_are_exported_as_the_reference_exports_them():
    import repro_torch.core.replay as replay

    assert replay.cache_design_sweep is sw.cache_design_sweep
    assert replay.host_count_sweep is sw.host_count_sweep
    src = (REPO / "src" / "repro_torch" / "core" / "replay"
           / "sweep.py").read_text()
    assert "import jax" not in src and "from repro." not in src
    assert Path(sw.__file__).name == "sweep.py"
