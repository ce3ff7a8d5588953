"""The sharded fleet replay on the CPU, where ``ShardedMultiHostReplay``
runs the ``replay_scan`` kernel's sharded twin (``replay_sharded_plain``):
the hosts split over D shards, each shard's least candidate, the least
over the shards, the owner's row and media lane.

Against the JAX package's ``ShardedMultiHostReplay``, run in one child
process for this file on eight forced host-platform devices (the
``enable_x64`` alias and ``XLA_FLAGS`` applied there only), at D in {1,
2, 4, 8} on every case of the reference's own ``tests/test_shard.py``:
``multi_pod`` mounts at H in {2, 8, 32}, PMEM and cached CXL-SSD media,
the metrics bundle under QoS, QoS alone, transport faults, NAND faults,
ragged lengths, ``run_arrays`` and ``return_latencies=False``.  Every
per-host latency stream, result, metrics bundle and mesh is equal; the
refusals are the reference's word for word; ``shard_count`` and
``host_count_sweep(sharded=True)`` are the reference's.  The golden
``fleet-zipf@multipod_2x4`` pin holds through the python lane, the
unsharded twin and the sharded twin, and the ``results/BENCH_replay.json``
``fleet`` oracle through the sharded twin at D = 8.  The one-CTA layout
of that fleet fits a block's shared memory (the repaired table), a 512-host
one does not, and its shards do."""

import dataclasses
import json

import numpy as np
import pytest

from golden import scenarios as sc
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import DRAMDevice, make_device
from repro_torch.core.fabric import Fabric, MemoryPool
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay import (MetricsSpec, MultiHostReplay,
                                     ReplayUnsupported,
                                     ShardedMultiHostReplay, shard_count)
from repro_torch.core.replay.shard import DEFAULT_SHARDS
from repro_torch.core.replay.sweep import host_count_sweep
from repro_torch.core.ssd.hil import HIL, SSDConfig
from repro_torch.core.ssd.pal import NANDTiming
from repro_torch.core.workloads.driver import MultiHostDriver
from repro_torch.data import WorkloadSpec, make_traces, traces_np
from repro_torch.kernels import replay_scan as rs
from test_torch_reference import REPO, golden, run_reference
from torch_scenarios import make_multi_targets, multi_traces

SHARDS = (1, 2, 4, 8)
OUTSTANDING = 8
H100_SMEM_OPTIN = 231424      # the budget the sharded lane's refusal names

# The cases of the reference's tests/test_shard.py, one source for both
# packages (exec'd here and in the reference's child): (targets, traces or
# (addrs, writes), replay keywords, run keywords) of each.
CASES_SRC = '''
N = 120
CACHE_KW = dict(capacity_bytes=16 * 4096, mshr_entries=4, writeback_buffer=2)


def mk_dev(P, name):
    if name == "cxl-ssd-cache":
        return P.make_device(name, cache_cfg=P.DRAMCacheConfig(
            policy="lru", **CACHE_KW))
    return P.make_device(name)


def mounts(P, nh, name="dram", qos=False):
    qw = {f"h{i}": 1.0 + (i % 3) for i in range(nh)} if qos else None
    fab = P.Fabric.build("multi_pod", ecmp=True, qos_weights=qw, num_pods=2,
                         hosts_per_pod=nh // 2)
    return [fab.mount(f"h{i}", f"d{i}", mk_dev(P, name)) for i in range(nh)]


def traces(P, nh, n=N, kind="hotspot", seed=7):
    spec = P.WorkloadSpec(kind, num_pages=96, hot_frac=0.8, hot_pages=12,
                          zipf_s=1.1)
    return P.make_traces(spec, seed, nh, n)


def case(P, name):
    """(make_targets, traces, run keywords) of case ``name``; traces are
    (addrs, writes) columns for a run_arrays case."""
    if name.startswith("multipod-"):
        nh = int(name.split("-")[1])
        return (lambda: mounts(P, nh), traces(P, nh, 40 if nh == 32 else N),
                {})
    if name in ("pmem", "cxl-ssd-cache"):
        return lambda: mounts(P, 4, name), traces(P, 4), {}
    if name == "metrics-qos":
        return (lambda: mounts(P, 4, qos=True), traces(P, 4, kind="zipfian"),
                {})
    if name == "qos":
        return lambda: mounts(P, 8, qos=True), traces(P, 8, kind="bursty"), {}
    if name == "transport":
        def mk():
            tgts = mounts(P, 4)
            P.install(P.FaultPlan(P.FaultConfig(link_retry_rate=0.25,
                                                link_retry_max=2), seed=5),
                      tgts)
            return tgts
        return mk, traces(P, 4), {}
    if name == "nand":
        def mk():
            tgts = mounts(P, 2, "cxl-ssd-cache")
            P.install(P.FaultPlan(P.FaultConfig(nand_read_retry_rate=0.3),
                                  seed=3), tgts)
            return tgts
        return mk, traces(P, 2, kind="zipfian"), {}
    if name == "ragged":
        tr = [t[:N - 17 * h] for h, t in enumerate(traces(P, 4))]
        return lambda: mounts(P, 4), tr, {}
    assert name in ("arrays", "arrays-bounded"), name
    spec = P.WorkloadSpec("scan", num_pages=64, stride_pages=3)
    return (lambda: mounts(P, 4), P.traces_np(spec, 13, 4, N),
            {"return_latencies": name == "arrays"})


def run_case(P, name, devices):
    """Replay case ``name`` through the sharded lane on ``devices``:
    (per-host latencies or None, per-host summaries + the span, metrics
    JSON or None, mesh)."""
    make, tr, kw = case(P, name)
    eng = P.Sharded(make(), devices)
    lat = None
    if isinstance(tr, tuple):
        res = eng.run_arrays(*tr, **kw)
    else:
        res, lat = eng.run_recorded(tr)
    summary = [[r.accesses, r.bytes_moved, r.elapsed_ticks,
                r.sum_latency_ticks, r.end_tick] for r in res.per_host]
    summary.append([res.elapsed_ticks, eng.last_gc_runs, 0, 0, 0])
    metrics = (json.dumps(res.metrics.to_jsonable())
               if res.metrics is not None else None)
    return lat, summary, metrics, dict(eng.last_mesh)


def refusal(P, name):
    """The sharded lane's refusal ``name`` as a callable."""
    if name == "chunk_size":
        eng = P.Sharded(mounts(P, 4), 8)
        return lambda: eng.run(traces(P, 4), chunk_size=64)
    if name == "pool":
        fab = P.Fabric.build("two_level", num_hosts=4, num_devices=2,
                             num_leaves=2)
        pool = P.MemoryPool(fab, {"d0": P.DRAMDevice(),
                                  "d1": P.DRAMDevice()})
        eng = P.Sharded(pool.views([f"h{i}" for i in range(4)]), 8)
        return lambda: eng.run(traces(P, 4))
    if name == "shared-flash":
        fab = P.Fabric.build("two_level", num_hosts=2, num_devices=2,
                             num_leaves=2)
        hil = P.HIL(P.SSDConfig(capacity_bytes=48 * 4096, page_bytes=4096,
                                channels=2, dies_per_channel=2,
                                pages_per_block=8,
                                timing=P.NANDTiming.low_latency()))
        tgts = [fab.mount(f"h{i}", f"d{i}", P.make_device(
            "cxl-ssd-cache", cache_cfg=P.DRAMCacheConfig(**CACHE_KW),
            hil=hil)) for i in range(2)]
        eng = P.Sharded(tgts, 8)
        return lambda: eng.run(traces(P, 2))
    assert name == "one-device-a-host", name
    # mounts always have one; the check behind it, on a config with one
    # device too many
    eng = P.Sharded(mounts(P, 4), 8)
    return lambda: P.dispatch_more_devices(eng, traces(P, 4))
'''
exec(CASES_SRC)
CASES = ["multipod-2", "multipod-8", "multipod-32", "pmem", "cxl-ssd-cache",
         "metrics-qos", "qos", "transport", "nand", "ragged", "arrays",
         "arrays-bounded"]
REFUSALS = {"chunk_size": "chunk_size", "pool": "unsharded MultiHostReplay",
            "shared-flash": "private flash",
            "one-device-a-host": "one mounted device per host"}
SWEEP_COUNTS = [2, 4, 8]


class _Port:
    """The port's classes under the names :data:`CASES_SRC` reads, the
    replay on the CPU."""

    DRAMCacheConfig = DRAMCacheConfig
    Fabric = Fabric
    MemoryPool = MemoryPool
    DRAMDevice = DRAMDevice
    HIL = HIL
    SSDConfig = SSDConfig
    NANDTiming = NANDTiming
    FaultConfig = FaultConfig
    FaultPlan = FaultPlan
    WorkloadSpec = WorkloadSpec
    make_device = staticmethod(make_device)
    install = staticmethod(install)
    make_traces = staticmethod(make_traces)
    traces_np = staticmethod(traces_np)

    @staticmethod
    def Sharded(targets, shards):
        return ShardedMultiHostReplay(targets, outstanding=OUTSTANDING,
                                      metrics=MetricsSpec(),
                                      devices=range(shards),
                                      torch_device="cpu")

    @staticmethod
    def dispatch_more_devices(eng, traces):
        prep = eng.prepare(traces)
        eng._dispatch(dataclasses.replace(prep, cfg=dataclasses.replace(
            prep.cfg, num_devs=prep.cfg.num_hosts + 1)), None)


REFERENCE = '''
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, IN["tests"].item())
exec(IN["cases_src"].item())
import jax
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import DRAMDevice, make_device
from repro.core.fabric import Fabric, MemoryPool
from repro.core.faults import FaultConfig, FaultPlan, install
from repro.core.replay import (MetricsSpec, ShardedMultiHostReplay,
                               shard_count)
from repro.core.replay.sweep import host_count_sweep
from repro.core.ssd.hil import HIL, SSDConfig
from repro.core.ssd.pal import NANDTiming
from repro.data import WorkloadSpec, make_traces, traces_np

assert jax.device_count() == 8, jax.device_count()


class P:
    pass


def dispatch_more_devices(eng, tr):
    cfg, params, devs, addrs, writes, lens, size = eng.prepare(tr)
    cfg = dataclasses.replace(cfg, num_devs=cfg.num_hosts + 1)
    eng._dispatch(cfg, params, devs, addrs, writes, lens, 0, None, True,
                  size, None)


for k, v in dict(DRAMCacheConfig=DRAMCacheConfig, Fabric=Fabric,
                 MemoryPool=MemoryPool, DRAMDevice=DRAMDevice, HIL=HIL,
                 SSDConfig=SSDConfig, NANDTiming=NANDTiming,
                 FaultConfig=FaultConfig, FaultPlan=FaultPlan,
                 WorkloadSpec=WorkloadSpec).items():
    setattr(P, k, v)
for k, v in dict(make_device=make_device, install=install,
                 make_traces=make_traces, traces_np=traces_np,
                 dispatch_more_devices=dispatch_more_devices,
                 Sharded=lambda t, d: ShardedMultiHostReplay(
                     t, outstanding=8, metrics=MetricsSpec(),
                     devices=jax.devices()[:d])).items():
    setattr(P, k, staticmethod(v))

for name in IN["cases"].tolist():
    for d in IN["shards"].tolist():
        lat, summary, metrics, mesh = run_case(P, name, d)
        key = f"{name}/{d}"
        if lat is not None:
            for h, x in enumerate(lat):
                OUT[f"lat/{key}/{h}"] = x
        OUT["summary/" + key] = np.asarray(summary)
        OUT["metrics/" + key] = np.asarray(json.dumps(metrics))
        OUT["mesh/" + key] = np.asarray(json.dumps(mesh))
for name in IN["refusals"].tolist():
    try:
        refusal(P, name)()
        OUT["refusal/" + name] = np.asarray("no refusal")
    except Exception as e:
        OUT["refusal/" + name] = np.asarray(f"{type(e).__name__}: {e}")
OUT["shard_count"] = np.asarray([[shard_count(h, devices=range(d))
                                  for d in range(1, 17)]
                                 for h in range(1, 41)])
OUT["shard_count_default"] = np.asarray(shard_count(8))
for d in (4, 8):
    info = {}
    lanes = host_count_sweep(mounts(P, 8), traces(P, 8),
                             IN["counts"].tolist(), outstanding=8,
                             sharded=True, info=info,
                             devices=jax.devices()[:d])
    OUT[f"sweep/{d}"] = np.asarray([[r.accesses, r.elapsed_ticks,
                                     r.sum_latency_ticks, r.end_tick]
                                    for lane in lanes
                                    for r in lane.per_host])
    OUT[f"sweep_span/{d}"] = np.asarray([lane.elapsed_ticks
                                         for lane in lanes])
    OUT[f"sweep_info/{d}"] = np.asarray(json.dumps(info))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(REFERENCE, tmp_path_factory.mktemp("shard"), {
        "tests": np.asarray(str(REPO / "tests")),
        "cases_src": np.asarray(CASES_SRC), "cases": np.asarray(CASES),
        "shards": np.asarray(SHARDS), "refusals": np.asarray(list(REFUSALS)),
        "counts": np.asarray(SWEEP_COUNTS)})


# ------------------------------------------- against the reference's lane
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_twin_equals_the_reference_sharded_lane(name, shards,
                                                        reference):
    lat, summary, metrics, mesh = run_case(_Port, name, shards)
    key = f"{name}/{shards}"
    assert mesh == json.loads(str(reference["mesh/" + key]))
    assert summary == reference["summary/" + key].tolist()
    want = json.loads(str(reference["metrics/" + key]))
    assert (json.loads(metrics) if metrics else None) == (
        json.loads(want) if want else None)
    if lat is not None:
        for h, x in enumerate(lat):
            np.testing.assert_array_equal(x, reference[f"lat/{key}/{h}"])


def test_the_cases_reach_their_shapes(reference):
    """Each case takes the shape it is there for, in the reference too."""
    faults = json.loads(json.loads(str(reference["metrics/transport/8"])))
    assert faults["faults"]["link_retries"] > 0
    nand = json.loads(json.loads(str(reference["metrics/nand/8"])))
    assert nand["faults"]["nand_read_retries"] > 0
    assert json.loads(str(reference["mesh/multipod-32/8"])) == {
        "device_count": 8, "hosts_per_device": 4}
    ragged = reference["summary/ragged/4"][:-1, 0].tolist()
    assert len(set(ragged)) == 4
    qos = json.loads(json.loads(str(reference["metrics/metrics-qos/4"])))
    assert sum(p["qos_throttle_events"] for p in qos["ports"].values()) > 0


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_are_the_references(name, reference):
    want = str(reference["refusal/" + name])
    assert want.startswith("ReplayUnsupported: ") and REFUSALS[name] in want
    with pytest.raises(ReplayUnsupported) as e:
        refusal(_Port, name)()
    assert f"ReplayUnsupported: {e.value}" == want


def test_shard_count_is_the_references(reference):
    got = [[shard_count(h, devices=range(d)) for d in range(1, 17)]
           for h in range(1, 41)]
    assert got == reference["shard_count"].tolist()
    # no device list: the portable cluster's 8 shards, as the reference's
    # 8 forced devices give
    assert shard_count(8) == DEFAULT_SHARDS == int(
        reference["shard_count_default"])
    assert (shard_count(8, devices=range(3)), shard_count(7, devices=range(4)),
            shard_count(6, devices=range(4))) == (2, 1, 3)


def test_more_shards_than_a_cluster_refuse():
    tgts = mounts(_Port, 32)
    eng = ShardedMultiHostReplay(tgts, outstanding=OUTSTANDING,
                                 devices=range(32), torch_device="cpu")
    with pytest.raises(ReplayUnsupported, match="32 shards exceed the 16"):
        eng.run(traces(_Port, 32, 10))


@pytest.mark.parametrize("shards", [4, 8])
def test_host_count_sweep_sharded_equals_the_references(shards, reference):
    info = {}
    lanes = host_count_sweep(mounts(_Port, 8), traces(_Port, 8),
                             SWEEP_COUNTS, outstanding=OUTSTANDING,
                             sharded=True, info=info, devices=range(shards),
                             torch_device="cpu")
    assert info == json.loads(str(reference[f"sweep_info/{shards}"]))
    assert info["sharded"] is True
    assert [[r.accesses, r.elapsed_ticks, r.sum_latency_ticks, r.end_tick]
            for lane in lanes for r in lane.per_host] == \
        reference[f"sweep/{shards}"].tolist()
    assert [lane.elapsed_ticks for lane in lanes] == \
        reference[f"sweep_span/{shards}"].tolist()
    # and the unsharded sweep
    base = host_count_sweep(mounts(_Port, 8), traces(_Port, 8), SWEEP_COUNTS,
                            outstanding=OUTSTANDING, torch_device="cpu")
    for a, b in zip(base, lanes):
        assert [(r.accesses, r.sum_latency_ticks, r.end_tick)
                for r in a.per_host] == [(r.accesses, r.sum_latency_ticks,
                                          r.end_tick) for r in b.per_host]


def test_sharded_twin_equals_the_unsharded_twin_at_every_shard_count():
    tr = traces(_Port, 8, kind="zipfian")
    want = MultiHostReplay(mounts(_Port, 8, qos=True), outstanding=8,
                           metrics=MetricsSpec(),
                           torch_device="cpu").run(tr)
    for d in (1, 2, 4, 8):
        got = _Port.Sharded(mounts(_Port, 8, qos=True), d).run(tr)
        assert got.metrics.to_jsonable() == want.metrics.to_jsonable()
        for g, w in zip(got.per_host, want.per_host):
            np.testing.assert_array_equal(g.latency_ticks, w.latency_ticks)


# ---------------------------------------------------------- the fleet pin
FLEET = sc.FLEET_SCENARIO


def _pin_of(res):
    return [{"latency_ticks": r.latency_ticks.tolist(),
             "elapsed_ticks": r.elapsed_ticks,
             "sum_latency_ticks": r.sum_latency_ticks,
             "end_tick": r.end_tick} for r in res.per_host]


def _python_pin():
    from test_torch_scenarios import run_python

    summary, _, _ = run_python(FLEET)
    return summary


@pytest.mark.parametrize("lane", ["python", "scan", "sharded"])
def test_fleet_pin_holds_through_every_lane(lane):
    pin = golden(FLEET)
    if lane == "python":
        assert _python_pin() == pin["python_scan"]
        res = MultiHostDriver(make_multi_targets(FLEET), outstanding=8,
                              metrics=MetricsSpec()).run(multi_traces(FLEET))
    elif lane == "scan":
        res = MultiHostDriver(make_multi_targets(FLEET), outstanding=8,
                              engine="scan", metrics=MetricsSpec(),
                              torch_device="cpu").run(multi_traces(FLEET))
        assert _pin_of(res) == pin["python_scan"]
    else:
        eng = ShardedMultiHostReplay(make_multi_targets(FLEET),
                                     outstanding=8, metrics=MetricsSpec(),
                                     torch_device="cpu")
        res = eng.run(multi_traces(FLEET))
        assert eng.last_mesh == {"device_count": 8, "hosts_per_device": 1}
        assert _pin_of(res) == pin["python_scan"]
    assert json.loads(json.dumps(res.metrics.to_jsonable())) == \
        pin["metrics"]


@pytest.mark.parametrize("shards", [2, 4])
def test_fleet_pin_holds_at_other_shard_counts(shards):
    res = _Port.Sharded(make_multi_targets(FLEET), shards).run(
        multi_traces(FLEET))
    assert _pin_of(res) == golden(FLEET)["python_scan"]


# ------------------------------------------- the BENCH_replay.json oracle
def fleet_mounts(hosts=64, pods=4):
    fab = Fabric.build("multi_pod", forward_ns=10.0, rt_extra_ns=4.0,
                       num_pods=pods, hosts_per_pod=hosts // pods)
    return [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
            for i in range(hosts)]


def fleet_columns():
    w = json.loads((REPO / "results" / "BENCH_replay.json").read_text())[
        "fleet"]
    spec = WorkloadSpec(w["workload"]["kind"],
                        num_pages=w["workload"]["num_pages"],
                        zipf_s=w["workload"]["zipf_s"],
                        write_frac=w["workload"]["write_frac"])
    return w, traces_np(spec, w["workload"]["seed"], w["hosts"],
                        w["accesses_per_host"])


def test_the_bench_fleet_oracle_on_the_sharded_twin():
    want, (addrs, writes) = fleet_columns()
    eng = ShardedMultiHostReplay(fleet_mounts(), outstanding=8,
                                 metrics=MetricsSpec(), torch_device="cpu")
    res = eng.run_arrays(addrs, writes)
    assert eng.last_mesh == {"device_count": 8, "hosts_per_device": 8}
    assert res.elapsed_ticks == want["elapsed_ticks"]
    assert sum(r.sum_latency_ticks for r in res.per_host) == \
        want["sum_latency_ticks"]
    assert res.metrics.percentile_ticks(50) == want["p50_ticks"]
    assert res.metrics.percentile_ticks(99) == want["p99_ticks"]
    assert sum(r.accesses for r in res.per_host) == want["n_accesses"]


# ------------------------------------------------------------ the layouts
def _fleet_prep(hosts, pods):
    a = np.zeros((hosts, 4), np.int64)
    return MultiHostReplay(fleet_mounts(hosts, pods), outstanding=8,
                           torch_device="cpu").prepare_arrays(a, a > 0)


def test_the_repaired_one_cta_layout_holds_the_fleet():
    prep = _fleet_prep(64, 4)
    cfg = prep.cfg
    assert cfg.mounts and not cfg.qos
    lay = rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN)
    assert lay.smem_bytes <= H100_SMEM_OPTIN
    # a mount's rows are its own device's: a row a host here
    tab = rs.multi_tables(cfg, prep.params)
    assert tab["port"].shape[0] == 64 * cfg.max_routes
    assert tab["dev"].tolist() == np.repeat(np.arange(64),
                                            cfg.max_routes).tolist()
    # a row a host (and the QoS mask and weights, ports x hosts)
    assert rs.kernel_table(cfg, prep.params, prep.lens).size == (
        2 * 64 + 4 * 64 + 64 + 3 * 64 * cfg.max_hops + 320 + 320 * 64)
    # a shard's table has no QoS words without QoS
    assert rs.shard_tables(cfg, prep.params, prep.lens, 8).shape == (
        8, 8 + 64 + 4 * 8 + 8 + 3 * 8 * cfg.max_hops)


def test_a_512_host_fleet_needs_shards():
    prep = _fleet_prep(512, 8)
    cfg = prep.cfg
    assert cfg.num_ports == 2176
    with pytest.raises(ValueError, match=r"tables need \d+ B of shared "
                                         r"memory, more than the 231424 B"):
        rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN)
    for d in (4, 8, 16):
        lay = rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN, shards=d)
        assert lay.smem_bytes <= H100_SMEM_OPTIN


def test_shard_tables_split_the_rows_by_host():
    prep = _fleet_prep(64, 4)
    cfg, params = prep.cfg, prep.params
    per_shard, local, width = rs.shard_rows(cfg, params, 8)
    tab = rs.multi_tables(cfg, params)
    assert width == 8 * cfg.max_routes
    for row in range(tab["port"].shape[0]):
        q = tab["dev"][row] // 8
        np.testing.assert_array_equal(per_shard[q]["port"][local[row]],
                                      tab["port"][row])
        assert per_shard[q]["dev"][local[row]] == tab["dev"][row] - 8 * q
    words = rs.shard_tables(cfg, params, prep.lens, 8)
    assert words.shape[0] == 8
    np.testing.assert_array_equal(words[3][:8], prep.lens[24:32])


def test_pool_layouts_keep_every_pair():
    # a pool's rows stay (host, device, route) for every pair
    tgts = make_multi_targets("multihost-qos-ecmp")
    prep = MultiHostReplay(tgts, outstanding=8, torch_device="cpu").prepare(
        multi_traces("multihost-qos-ecmp"))
    cfg = prep.cfg
    assert not cfg.mounts
    assert rs.multi_tables(cfg, prep.params)["port"].shape[0] == (
        cfg.num_hosts * cfg.num_devs * cfg.max_routes)
    with pytest.raises(ValueError, match="per-host fabric mounts"):
        rs.check_shardable(cfg, prep.params, 1)
