"""The scan lane (``engine="scan"``) on the CPU, where it runs the
``replay_scan`` kernel's plain twin, against the golden pins and the JAX
package's ``ReplayEngine``.

The single-host fault-free scenarios reproduce their ``python_scan`` pin
and ``metrics`` block at block sizes 1 and ``BLOCK_SIZE``.  Per-access
issue and completion ticks and flags (event bits included), the per-port
queueing and QoS totals and the metrics bundles equal the reference
scan's on those scenarios and on extra fabric mounts (ECMP, QoS, a kept
private link); the reference runs in one child process for this file.
Refusals mirror the reference's, and the slice's own cuts refuse by
name.  Every comparison is exact.
"""

import json

import numpy as np
import pytest
import torch

from golden import scenarios as sc
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.faults import FaultConfig, FaultPlan, install
from repro_torch.core.replay import stack
from repro_torch.core.replay.engine import ReplayEngine
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.spec import (MAX_ACCESSES, ReplayUnsupported,
                                          access_route_choices, build_stack,
                                          trace_to_arrays)
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.core.workloads.traces import make_trace
from repro_torch.kernels.replay_scan import replay_scan
from test_torch_reference import REPO, golden, run_reference
from test_torch_scenarios import make_target, scenario_trace

SCAN_SCENARIOS = ([f"{d}@{a}" for d in sc.DEVICES
                   for a in ("direct", "fabric")]
                  + ["dram@stream", "pmem@stream", "dram-qos@fabric",
                     "ssd-gc@direct"])

# Extra fabric mounts, built by the same source on both packages' objects:
# ECMP over a 2 x 2 spine-leaf, QoS weights with and without ECMP, and a
# CXL-DRAM that keeps its private link behind the fabric.
MOUNTS_SRC = '''
def make_mount(name, make_device, Fabric, DRAMCacheConfig):
    cached = dict(policy="lru", capacity_bytes=16 * 4096, mshr_entries=4,
                  writeback_buffer=2)
    if name.startswith("ecmp"):
        qos = {"h0": 3.0, "h1": 1.0} if "qos" in name else None
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, ecmp=True,
                           qos_weights=qos)
        kind = name.split("/")[1]
        dev = (make_device(kind, cache_cfg=DRAMCacheConfig(**cached))
               if kind == "cxl-ssd-cache" else make_device(kind))
        return fab.mount("h0", "d0", dev, detach_link=kind != "cxl-dram")
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                       num_leaves=2, qos_weights={"h0": 3.0, "h1": 1.0})
    if name == "qos/cxl-ssd":
        return fab.mount("h0", "d0", make_device("cxl-ssd"))
    assert name == "link/cxl-dram", name
    return fab.mount("h1", "d0", make_device("cxl-dram"), detach_link=False)
'''
exec(MOUNTS_SRC)
MOUNTS = ["ecmp/cxl-ssd-cache", "ecmp/dram", "ecmp/cxl-dram",
          "ecmp-qos/pmem", "qos/cxl-ssd", "link/cxl-dram"]
MOUNT_TRACE = dict(n=400, pages=48, write_frac=0.4)
# (hosts, accesses) trace columns for validate_trace_columns
COLUMNS = dict(addrs=np.arange(8, dtype=np.int64).reshape(2, 4) * 4096 + 64,
               writes=np.arange(8).reshape(2, 4) % 3 == 0,
               lens=np.asarray([4, 2]))
START_TICK = 12345


def mount(name):
    return make_mount(name, make_device, Fabric, DRAMCacheConfig)


def mount_trace(name):
    return make_trace(sc.hash_seed(name), **MOUNT_TRACE)


REFERENCE = MOUNTS_SRC + '''
import json, sys
sys.path.insert(0, IN["tests"].item())
import jax, jax.numpy as jnp
from jax.experimental import enable_x64
from golden import scenarios as sc
from repro.core.cache.dram_cache import DRAMCacheConfig
from repro.core.devices import make_device
from repro.core.fabric import Fabric
from repro.core.replay import ReplayEngine, ReplayUnsupported
from repro.core.replay import engine as E
from repro.core.replay.metrics import MetricsSpec
from repro.core.replay.spec import (access_route_choices, build_stack,
                                    trace_to_arrays)


def scan_columns(dev, trace, outstanding, start):
    """issues, dones, flags (event bits in) and the port totals of the
    reference's scan, straight from its jitted runner."""
    addrs, writes, size = trace_to_arrays(trace)
    with enable_x64():
        cfg, params = build_stack(
            dev, size=size, outstanding=outstanding, issue_overhead_ns=0.5,
            posted_writes=True, n_accesses=addrs.size,
            max_addr=int(addrs.max()), counters=True)
        pj = jax.tree.map(jnp.asarray, params)
        spec = MetricsSpec()
        if cfg.num_routes > 1:
            r = access_route_choices(dev, addrs)
            out = E._run_stack_ecmp(cfg, pj, jnp.asarray(addrs),
                                    jnp.asarray(writes), jnp.asarray(r),
                                    E._i64(start), 1, spec, True, size)
        else:
            out = E._run_stack(cfg, pj, jnp.asarray(addrs),
                               jnp.asarray(writes), E._i64(start), 1, spec,
                               True, size)
        issues, dones, flags, final, aux = out
        q = np.asarray(aux["q"]).reshape(-1)
        qthr = (np.asarray(aux["qthr"]).reshape(-1) if "qthr" in aux
                else np.zeros_like(q))
        return [np.asarray(issues), np.asarray(dones), np.asarray(flags),
                q, qthr]

for name in IN["scenarios"].tolist():
    cols = scan_columns(sc.make_target(name), sc.scenario_trace(name),
                        sc.scenario_outstanding(name), 0)
    for i, c in enumerate(cols):
        OUT[f"cols/{name}/{i}"] = c
for name in IN["mounts"].tolist():
    trace = [(int(a), 64, bool(w)) for a, w in
             zip(IN["trace/" + name + "/a"], IN["trace/" + name + "/w"])]
    cols = scan_columns(make_mount(name, make_device, Fabric,
                                   DRAMCacheConfig), trace, 8,
                        int(IN["start"]))
    for i, c in enumerate(cols):
        OUT[f"cols/{name}/{i}"] = c
    res = ReplayEngine(make_mount(name, make_device, Fabric,
                                  DRAMCacheConfig), outstanding=8,
                       metrics=MetricsSpec()).run(trace,
                                                  start_tick=int(IN["start"]))
    OUT["metrics/" + name] = np.asarray(json.dumps(res.metrics.to_jsonable()))
    OUT["summary/" + name] = np.asarray([res.elapsed_ticks,
                                         res.sum_latency_ticks, res.end_tick])

def refusal(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__ + ": " + str(e)
    return "none"

import dataclasses
from repro.core.replay.spec import media_stack, validate_trace_columns

def stack_json(cfg, params):
    return json.dumps({"cfg": dataclasses.asdict(cfg), "params": {
        k: np.asarray(v).tolist() for k, v in sorted(params.items())}})

for name in IN["scenarios"].tolist() + IN["mounts"].tolist():
    dev = (sc.make_target(name) if "@" in name
           else make_mount(name, make_device, Fabric, DRAMCacheConfig))
    OUT["stack/" + name] = np.asarray(stack_json(*build_stack(
        dev, size=64, outstanding=8, issue_overhead_ns=0.5,
        posted_writes=False, n_accesses=5000, max_addr=123456,
        counters=True)))
    inner = getattr(dev, "inner", dev)
    # "none" when media_stack takes the device (its stack under media_ok/)
    OUT["media/" + name] = np.asarray(refusal(lambda: OUT.__setitem__(
        "media_ok/" + name, np.asarray(stack_json(*media_stack(
            inner, size=64, outstanding=4, posted_writes=True,
            n_accesses=70000, max_addr=99 * 4096))))))
cols = IN["cols_addrs"], IN["cols_writes"]
OUT["columns"] = np.asarray(json.dumps(
    [x.tolist() for x in validate_trace_columns(*cols, IN["cols_lens"])]))
for k, (a, w, lens) in {
        "shape": (cols[0], cols[1][:1], None),
        "lens": (cols[0], cols[1], np.asarray([9, 1])),
        "empty": (cols[0], cols[1], np.asarray([0, 0])),
        "line": (cols[0] + 32, cols[1], None),
        "negative": (cols[0] - 4096, cols[1], None)}.items():
    OUT["columns/" + k] = np.asarray(refusal(
        lambda: validate_trace_columns(a, w, lens)))

def fresh_fabric_mount(kind):
    return Fabric.build("two_level", num_hosts=2, num_devices=2,
                        num_leaves=2).mount("h0", "d0", make_device(kind))

def busy_fabric():
    from repro.core.workloads.driver import TraceDriver
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    TraceDriver(fab.mount("h1", "d1", make_device("dram"))).run(
        [(0, 64, False)])
    return fab.mount("h0", "d0", make_device("dram"))

qos = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2,
                   qos_weights={"h0": 2.0, "h1": 1.0})
cases = {
    "empty": lambda: ReplayEngine(make_device("dram")).run_arrays(
        np.zeros(0, np.int64), np.zeros(0, bool)),
    "too_long": lambda: ReplayEngine(make_device("dram")).run_arrays(
        np.zeros(IN["too_long"].item(), np.int64),
        np.zeros(IN["too_long"].item(), bool)),
    "qos_negative_start": lambda: ReplayEngine(qos.mount(
        "h0", "d0", make_device("dram"))).run([(0, 64, False)],
                                              start_tick=-5),
    "busy_fabric": lambda: ReplayEngine(busy_fabric()).run([(0, 64, False)]),
    "private_ssd_link": lambda: ReplayEngine(
        Fabric.build("two_level", num_hosts=2, num_devices=2,
                     num_leaves=2).mount("h0", "d0", make_device("cxl-ssd"),
                                         detach_link=False)).run(
        [(0, 64, False)]),
    "policy": lambda: ReplayEngine(make_device(
        "cxl-ssd-cache", cache_cfg=DRAMCacheConfig(policy="2q"))).run(
        [(0, 64, False)]),
    "multi_line": lambda: ReplayEngine(make_device("dram")).run(
        [(32, 64, False)]),
}
for k, fn in cases.items():
    OUT["refuse/" + k] = np.asarray(refusal(fn))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {"tests": np.asarray(str(REPO / "tests")),
              "scenarios": np.asarray(SCAN_SCENARIOS),
              **{f"cols_{k}": v for k, v in COLUMNS.items()},
              "mounts": np.asarray(MOUNTS), "start": np.asarray(START_TICK),
              "too_long": np.asarray(MAX_ACCESSES + 1)}
    for name in MOUNTS:
        a, w, _ = trace_to_arrays(mount_trace(name))
        inputs[f"trace/{name}/a"], inputs[f"trace/{name}/w"] = a, w
    return run_reference(REFERENCE, tmp_path_factory.mktemp("scan"), inputs)


def port_columns(dev, trace, outstanding, start=0):
    """The port's per-access columns and port totals (plain twin)."""
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params = build_stack(
        dev, size=size, outstanding=outstanding, issue_overhead_ns=0.5,
        posted_writes=True, n_accesses=addrs.size, max_addr=int(addrs.max()),
        counters=True)
    routes = None
    if cfg.num_routes > 1:
        routes = torch.from_numpy(
            access_route_choices(dev, addrs).astype(np.int32))
    out = replay_scan(cfg, params, stack.init_state(cfg, "cpu"),
                      torch.from_numpy(addrs), torch.from_numpy(writes),
                      routes, start_tick=start)
    return cfg, [x.numpy() for x in out]


def assert_columns_equal(got, reference, key):
    for i, x in enumerate(got):
        want = reference[f"cols/{key}/{i}"]
        assert x.dtype == want.dtype, (key, i)
        np.testing.assert_array_equal(x, want, err_msg=f"{key} column {i}")


# ------------------------------------------------------------ golden pins
@pytest.mark.parametrize("block_size", [1, sc.BLOCK_SIZE])
@pytest.mark.parametrize("name", SCAN_SCENARIOS)
def test_scan_lane_reproduces_the_pins(name, block_size):
    res = TraceDriver(make_target(name),
                      outstanding=sc.scenario_outstanding(name),
                      engine="scan", block_size=block_size,
                      metrics=MetricsSpec(),
                      torch_device="cpu").run(scenario_trace(name))
    pin = golden(name)["python_scan"]
    assert res.latency_ticks.tolist() == pin["latency_ticks"]
    for f in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        assert getattr(res, f) == pin[f], f
    got = json.loads(json.dumps(res.metrics.to_jsonable()))
    assert got == golden(name)["metrics"]


def test_the_scan_scenarios_are_the_single_host_fault_free_ones():
    fixture = set(sc.load_fixture()["scenarios"])
    single = {n for n in fixture if not sc.is_multi(n)}
    assert set(SCAN_SCENARIOS) == single - set(sc.FAULT_SCENARIOS)
    assert len(SCAN_SCENARIOS) == 14


def test_gc_scenario_collects():
    res = TraceDriver(make_target("ssd-gc@direct"), outstanding=8,
                      engine="scan", torch_device="cpu").run(
        scenario_trace("ssd-gc@direct"))
    assert res.gc_runs == 2 and res.metrics is None


# ------------------------------------------- against the reference scan
@pytest.mark.parametrize("name", SCAN_SCENARIOS)
def test_columns_equal_the_reference_scan(name, reference):
    _, got = port_columns(make_target(name), scenario_trace(name),
                          sc.scenario_outstanding(name))
    assert_columns_equal(got, reference, name)


@pytest.mark.parametrize("name", MOUNTS)
def test_mounts_equal_the_reference_scan(name, reference):
    cfg, got = port_columns(mount(name), mount_trace(name), 8, START_TICK)
    assert_columns_equal(got, reference, name)
    if name.startswith("ecmp"):
        assert cfg.num_routes == 2
    if "qos" in name:
        assert cfg.qos_ports and got[4].sum() > 0    # throttles counted
    res = ReplayEngine(mount(name), outstanding=8, metrics=MetricsSpec(),
                       torch_device="cpu").run(mount_trace(name),
                                               start_tick=START_TICK)
    assert json.loads(json.dumps(res.metrics.to_jsonable())) == \
        json.loads(str(reference[f"metrics/{name}"]))
    assert [res.elapsed_ticks, res.sum_latency_ticks, res.end_tick] == \
        reference[f"summary/{name}"].tolist()


def test_event_bits_ride_only_with_metrics():
    name = "cxl-ssd-cache@direct"
    kw = dict(outstanding=8, torch_device="cpu")
    bare = ReplayEngine(make_target(name), **kw).run(scenario_trace(name))
    _, cols = port_columns(make_target(name), scenario_trace(name), 8)
    flags = cols[2]
    assert (flags >> 2).any()                # misses etc. are flagged
    np.testing.assert_array_equal(bare.hit_flags, (flags & 1).astype(bool))
    np.testing.assert_array_equal(bare.evict_flags, (flags & 2).astype(bool))


# ------------------------------------------------------------- refusals
def _refuses(fn, match=None):
    with pytest.raises(ReplayUnsupported, match=match):
        fn()


def _busy_fabric():
    fab = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2)
    TraceDriver(fab.mount("h1", "d1", make_device("dram"))).run(
        [(0, 64, False)])
    return fab.mount("h0", "d0", make_device("dram"))


def test_refusals_mirror_the_reference(reference):
    cpu = dict(torch_device="cpu")
    qos = Fabric.build("two_level", num_hosts=2, num_devices=2, num_leaves=2,
                       qos_weights={"h0": 2.0, "h1": 1.0})
    cases = {
        "empty": lambda: ReplayEngine(make_device("dram"), **cpu).run_arrays(
            np.zeros(0, np.int64), np.zeros(0, bool)),
        "too_long": lambda: ReplayEngine(
            make_device("dram"), **cpu).run_arrays(
            np.zeros(MAX_ACCESSES + 1, np.int64),
            np.zeros(MAX_ACCESSES + 1, bool)),
        "qos_negative_start": lambda: ReplayEngine(qos.mount(
            "h0", "d0", make_device("dram")), **cpu).run([(0, 64, False)],
                                                         start_tick=-5),
        "busy_fabric": lambda: ReplayEngine(_busy_fabric(), **cpu).run(
            [(0, 64, False)]),
        "private_ssd_link": lambda: ReplayEngine(
            Fabric.build("two_level", num_hosts=2, num_devices=2,
                         num_leaves=2).mount("h0", "d0",
                                             make_device("cxl-ssd"),
                                             detach_link=False),
            **cpu).run([(0, 64, False)]),
        "policy": lambda: ReplayEngine(make_device(
            "cxl-ssd-cache", cache_cfg=DRAMCacheConfig(policy="2q")),
            **cpu).run([(0, 64, False)]),
        "multi_line": lambda: ReplayEngine(make_device("dram"), **cpu).run(
            [(32, 64, False)]),
    }
    for case, fn in cases.items():
        want = str(reference[f"refuse/{case}"])
        assert want.startswith("ReplayUnsupported: "), (case, want)
        with pytest.raises(ReplayUnsupported) as err:
            fn()
        assert f"ReplayUnsupported: {err.value}" == want, case


PLANS = {"link": dict(link_retry_rate=0.25),
         "down": dict(down_links=(("s0", "s_root", 2, 9),)),
         "nand": dict(nand_read_retry_rate=0.3),
         "poison": dict(poison_rate=0.1)}
CLASS_NAMES = {"link": "link-retry", "down": "port-down", "nand": "NAND",
               "poison": "poison"}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_an_active_fault_plan_is_refused_by_name(plan):
    """The scan lane replays every fault class as the python lane does
    (both raise DeviceUnreachable where the down window cuts every
    route); the assoc and cuda lanes refuse the plan, naming its class."""
    from repro_torch.core.faults import DeviceUnreachable

    def target():
        fab = Fabric.build("two_level", num_hosts=2, num_devices=2,
                           num_leaves=2)
        dev = fab.mount("h0", "d0", make_device("cxl-ssd-cache"))
        if plan == "nand":
            dev = make_device("cxl-ssd-cache")
        install(FaultPlan(FaultConfig(**PLANS[plan]), seed=1), [dev])
        return dev

    trace = make_trace(1, n=16)
    if plan == "down":
        for engine in ("python", "scan"):
            with pytest.raises(DeviceUnreachable):
                TraceDriver(target(), engine=engine,
                            torch_device="cpu").run(trace)
    else:
        want = TraceDriver(target()).run(trace)
        got = TraceDriver(target(), engine="scan",
                          torch_device="cpu").run(trace)
        assert (got.sum_latency_ticks, got.elapsed_ticks, got.end_tick) == (
            want.sum_latency_ticks, want.elapsed_ticks, want.end_tick)
    for engine in ("assoc", "cuda"):
        _refuses(lambda: TraceDriver(target(), engine=engine,
                                     torch_device="cpu").run(trace),
                 rf"active fault plan \({CLASS_NAMES[plan]}\)")


def test_streaming_equals_the_one_shot_replay():
    eng = ReplayEngine(make_device("dram"), torch_device="cpu")
    trace = make_trace(1, n=16)
    want = eng.run(trace)
    got = eng.run(trace, chunk_size=4)
    assert got.latency_ticks.tolist() == want.latency_ticks.tolist()
    bounded = eng.run(trace, return_latencies=False)
    assert bounded.latency_ticks is None
    assert (bounded.sum_latency_ticks, bounded.end_tick,
            bounded.elapsed_ticks) == (want.sum_latency_ticks, want.end_tick,
                                       want.elapsed_ticks)
    with pytest.raises(ValueError, match="chunk_size"):
        eng.run(trace, chunk_size=0)


def test_fault_scenarios_are_refused(reference):
    """The single-host fault scenarios replay on the scan lane (their
    pins, in tests/test_torch_faults_scan.py); the associative lane
    refuses each of them, naming the engine that replays it."""
    for name in sc.FAULT_SCENARIOS:
        _refuses(lambda: TraceDriver(
            make_target(name), engine="assoc", torch_device="cpu").run(
            scenario_trace(name)), "use engine='scan'")
        res = TraceDriver(make_target(name), engine="scan",
                          outstanding=sc.scenario_outstanding(name),
                          torch_device="cpu").run(scenario_trace(name))
        assert res.latency_ticks.tolist() == \
            golden(name)["python_scan"]["latency_ticks"]


def test_block_size_belongs_to_the_scan_lane():
    for engine in ("python", "cuda"):
        with pytest.raises(ValueError, match="block_size"):
            TraceDriver(make_device("dram"), engine=engine, block_size=4)
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        TraceDriver(make_device("dram"), engine="scan", block_size=0)
    assert TraceDriver(make_device("dram"), engine="scan",
                       block_size=64).block_size == 64


def test_empty_trace_takes_the_python_lane():
    res = TraceDriver(make_device("dram"), engine="scan").run([])
    assert (res.accesses, res.elapsed_ticks) == (0, 0)


def test_the_kernel_takes_the_wrappers_argument_block():
    """``ARGS`` and ``SCALARS`` of the wrapper are the kernel's ``enum Arg``
    and ``enum Scalar``, field for field."""
    import re

    from repro_torch.kernels import replay_scan as rs

    src = (REPO / rs.__file__.replace(str(REPO) + "/", "")).with_name(
        "csrc").joinpath("replay_scan.cu").read_text()

    def enum(name):
        body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
        return [w.strip() for w in body.replace("\n", " ").split(",")
                if w.strip()][:-1]

    assert len(enum("Arg")) == len(rs.ARGS)
    for c, py in zip(enum("Arg"), rs.ARGS):
        assert c.startswith("A_"), c
    assert [c[2:].lower() for c in enum("Scalar")] == list(rs.SCALARS)
    assert [c[2:].lower() for c in enum("Lay")] == list(rs.LAYOUT)
    assert rs.KINDS == ("dram", "pmem", "ssd-buf", "ssd-cache")
    assert "kDram = 0, kPmem = 1, kSsdBuf = 2, kSsdCache = 3" in src
    args = rs.arg_block(*build_stack(
        make_device("pmem"), size=64, outstanding=4, issue_overhead_ns=0.5,
        posted_writes=True, n_accesses=9, max_addr=0), 9, 77)
    named = dict(zip(rs.ARGS, args.tolist()))
    assert (named["kind"], named["n"], named["start_tick"],
            named["outstanding"], named["num_pages"]) == (1, 9, 77, 4, 0)
    assert named["lat_write_hit"] > 0 and named["row_bytes"] == 256


def _stack_json(cfg, params):
    import dataclasses

    return json.loads(json.dumps({"cfg": dataclasses.asdict(cfg), "params": {
        k: np.asarray(v).tolist() for k, v in sorted(params.items())}}))


@pytest.mark.parametrize("name", SCAN_SCENARIOS + MOUNTS)
def test_stack_extraction_equals_the_reference(name, reference):
    from repro_torch.core.replay.spec import media_stack

    dev = make_target(name) if "@" in name else mount(name)
    want = json.loads(str(reference[f"stack/{name}"]))
    # the transport-fault flag is set by the faulted lane only
    assert want["cfg"]["fault_hops"] is False
    got = _stack_json(*build_stack(
        dev, size=64, outstanding=8, issue_overhead_ns=0.5,
        posted_writes=False, n_accesses=5000, max_addr=123456,
        counters=True))
    assert got == want
    inner = getattr(dev, "inner", dev)
    refused = str(reference[f"media/{name}"])
    if refused == "none":
        want = json.loads(str(reference[f"media_ok/{name}"]))
        assert _stack_json(*media_stack(
            inner, size=64, outstanding=4, posted_writes=True,
            n_accesses=70000, max_addr=99 * 4096)) == want
    else:
        with pytest.raises(ReplayUnsupported) as err:
            media_stack(inner, size=64, outstanding=4, posted_writes=True,
                        n_accesses=70000, max_addr=99 * 4096)
        assert f"ReplayUnsupported: {err.value}" == refused


def test_trace_columns_validate_like_the_reference(reference):
    from repro_torch.core.replay.spec import validate_trace_columns

    got = validate_trace_columns(COLUMNS["addrs"], COLUMNS["writes"],
                                 COLUMNS["lens"])
    assert [x.tolist() for x in got] == json.loads(str(reference["columns"]))
    a, w = COLUMNS["addrs"], COLUMNS["writes"]
    cases = {"shape": (a, w[:1], None), "lens": (a, w, np.asarray([9, 1])),
             "empty": (a, w, np.asarray([0, 0])), "line": (a + 32, w, None),
             "negative": (a - 4096, w, None)}
    for case, (aa, ww, lens) in cases.items():
        want = str(reference[f"columns/{case}"])
        with pytest.raises(ReplayUnsupported) as err:
            validate_trace_columns(aa, ww, lens)
        assert f"ReplayUnsupported: {err.value}" == want, case
