"""The port's deterministic fault injection against the JAX package.

The python lane replays the five fault scenarios of the golden fixture and
equals their ``python_scan`` pins; the fabric, fault and device counters
after each, and where routing gives up (``DeviceUnreachable``), equal the
reference's, from one child process for this file.  The torch twins of the
splitmix64 hashes (ECMP route choices, NAND read retries, erase failures)
are bit-equal to the numpy twins under hypothesis, in-process, and to the
reference's jnp twins in the child (they need JAX's x64 mode).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.fabric.routing import flow_choices as ref_flow_choices
from repro.core.faults import FaultConfig as RefFaultConfig
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.faults.plan import fault_hash_np as ref_fault_hash_np
from repro_torch.core.devices import make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.fabric.routing import flow_choices, flow_choices_torch
from repro_torch.core.faults import (DeviceUnreachable, FaultConfig,
                                     FaultPlan, erase_fails_torch, install,
                                     nand_read_retries_torch)
from repro_torch.core.faults.plan import (SALT_NAND_ERASE, SALT_NAND_READ,
                                          fault_hash_np)
from repro_torch.core.workloads.driver import TraceDriver
from test_torch_reference import golden
from test_torch_scenarios import (FAULT_SCENARIOS, port_counters,
                                  reference_counters, run_python)

M32 = (1 << 32) - 1
TOP = 1 << 63
# seeded values for the child's jnp twins: low ordinals, the top bit set,
# and the extremes
TWIN_VALUES = np.concatenate([
    np.arange(256, dtype=np.uint64),
    np.random.default_rng(0).integers(0, 2**64 - 1, 4096, dtype=np.uint64,
                                      endpoint=True),
    np.asarray([TOP, TOP + 1, 2**64 - 1, TOP - 1], np.uint64)])
TWIN_PAIRS = [("h0", "d0"), ("h3", "d1"), ("d2", "h1")]
NAND_PLANS = [dict(nand_read_retry_rate=0.35, nand_read_retry_max=2,
                   erase_fail_rate=0.4, seed=3),
              dict(nand_read_retry_rate=1.0, nand_read_retry_max=7,
                   erase_fail_rate=1.0, seed=2**64 - 1)]

# unreachable devices, each built the same way on both sides; ``down`` is
# a routing down-set, ``service`` a plan on a mount replayed by the driver
UNREACHABLE = {
    "spine_leaf": "fab = Fabric.build('spine_leaf', num_hosts=2, num_devices=2,"
                  " num_leaves=2, num_spines=2, ecmp=True)\n"
                  "fab.routing.select('h0', 'd0', 0, down=frozenset("
                  "{('s0', 'sp0'), ('s0', 'sp1')}))\n",
    "mesh": "fab = Fabric.build('mesh', num_hosts=2, num_devices=2)\n"
            "sw = [n for n in fab.routing.path('h0', 'd0') if n[0] == 's']\n"
            "fab.routing.select('h0', 'd0', 0, down=frozenset("
            "(u, v) for (u, v) in sorted(fab.ports) if sw[0] in (u, v)))\n",
    "service": "fab = Fabric.build('direct', num_pairs=2)\n"
               "tgt = fab.mount('h0', 'd0', make_device('dram'))\n"
               "install(FaultPlan(FaultConfig(down_links=(('h0', 'd0', 3, "
               "1000),)), seed=1), [tgt])\n"
               "TraceDriver(tgt, outstanding=8).run("
               "[(i * 64, 64, False) for i in range(8)])\n",
}

REFERENCE = """
from jax.experimental import enable_x64
import jax.numpy as jnp
from repro.core.devices import make_device
from repro.core.fabric import Fabric
from repro.core.fabric.routing import flow_choices_jnp
from repro.core.faults import (FaultConfig, FaultPlan, erase_fails_jnp,
                               install, nand_read_retries_jnp)

UNREACHABLE = json.loads(IN["unreachable"].item())
for case, code in UNREACHABLE.items():
    try:
        exec(code)
        OUT["unreachable/" + case] = np.asarray(json.dumps("none"))
    except Exception as e:
        OUT["unreachable/" + case] = np.asarray(json.dumps(
            [type(e).__name__, str(e)]))

values = IN["values"]
with enable_x64():
    x = jnp.asarray(values)
    for src, dst in json.loads(IN["pairs"].item()):
        for n in range(1, 17):
            OUT[f"flow/{src}/{dst}/{n}"] = np.asarray(json.dumps(np.asarray(
                flow_choices_jnp(src, dst, x, n)).tolist()))
    for i, kw in enumerate(json.loads(IN["plans"].item())):
        seed = kw.pop("seed")
        statics = FaultPlan(FaultConfig(**kw), seed=seed).nand_statics()
        seq = jnp.asarray(values.view(np.int64))
        OUT[f"nand/{i}"] = np.asarray(json.dumps(np.asarray(
            nand_read_retries_jnp(statics, seq)).tolist()))
        OUT[f"erase/{i}"] = np.asarray(json.dumps(np.asarray(
            erase_fails_jnp(statics, seq)).tolist()))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    return reference_counters(
        FAULT_SCENARIOS, tmp_path_factory.mktemp("faults"), REFERENCE,
        {"unreachable": np.asarray(json.dumps(UNREACHABLE)),
         "values": TWIN_VALUES, "pairs": np.asarray(json.dumps(TWIN_PAIRS)),
         "plans": np.asarray(json.dumps(NAND_PLANS))})


def _statics(kw):
    kw = dict(kw)
    seed = kw.pop("seed")
    return FaultPlan(FaultConfig(**kw), seed=seed).nand_statics()


# --------------------------------------------------- (a) fault scenario pins
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_python_lane_equals_golden_pin(name):
    summary, _, _ = run_python(name)
    assert summary == golden(name)["python_scan"]


# ------------------------------------------ (b) fault and device counters
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_counters_equal_the_reference(name, reference):
    got = port_counters(name)
    assert got == reference[name]
    faults = sum(sum(f["fault_stats"].values()) for f in got["fabrics"])
    nand = sum(d.get("pal", {}).get("read_retries", 0)
               + len(d.get("retired_blocks", ())) for d in got["devices"])
    assert faults + nand > 0        # the plan did inject faults


@pytest.mark.parametrize("case", sorted(UNREACHABLE))
def test_device_unreachable_where_the_reference_raises_it(case, reference):
    want = reference[f"unreachable/{case}"]
    assert want[0] == "DeviceUnreachable"
    with pytest.raises(DeviceUnreachable) as info:
        exec(UNREACHABLE[case], {
            "Fabric": Fabric, "make_device": make_device, "install": install,
            "FaultPlan": FaultPlan, "FaultConfig": FaultConfig,
            "TraceDriver": TraceDriver})
    assert str(info.value) == want[1]
    assert isinstance(info.value, ValueError)


def test_down_windows_and_failover_routes():
    plan = FaultPlan(FaultConfig(down_links=(("a", "b", 10, 20),)), seed=0)
    assert plan.down_links_at(9) == frozenset()
    assert plan.down_links_at(10) == frozenset({("a", "b"), ("b", "a")})
    assert plan.down_links_at(20) == frozenset()
    assert [(lo, hi) for lo, hi, _ in plan.down_segments(30)] == [
        (0, 10), (10, 20), (20, 30)]
    fab = Fabric.build("mesh", num_hosts=2, num_devices=2)
    nominal = fab.routing.path("h0", "d0")
    sw = [n for n in nominal if n.startswith("s")]
    cut = frozenset({(sw[0], sw[1]), (sw[1], sw[0])})
    alt = fab.routing.select("h0", "d0", 0, down=cut)
    assert alt != nominal and (alt[0], alt[-1]) == ("h0", "d0")


@given(seed=st.integers(0, 2**64 - 1), link=st.floats(0, 1),
       poison=st.floats(0, 1), kmax=st.integers(1, 8),
       ords=st.lists(st.integers(0, 2**63 - 1), min_size=1, max_size=32))
@settings(deadline=None, max_examples=60)
def test_plan_vector_twins_equal_the_reference(seed, link, poison, kmax,
                                               ords):
    kw = dict(link_retry_rate=link, link_retry_max=kmax, poison_rate=poison)
    port = FaultPlan(FaultConfig(**kw), seed=seed)
    ref = RefFaultPlan(RefFaultConfig(**kw), seed=seed)
    o = np.asarray(ords, np.int64)
    writes = o % 3 == 0
    np.testing.assert_array_equal(port.link_retries_np(("s0", "sp1"), o),
                                  ref.link_retries_np(("s0", "sp1"), o))
    np.testing.assert_array_equal(port.poisoned_np(1, o, writes),
                                  ref.poisoned_np(1, o, writes))
    assert [port.link_retries(("s0", "sp1"), x) for x in ords[:4]] == \
        [ref.link_retries(("s0", "sp1"), x) for x in ords[:4]]


# ------------------------------------------------------ (g) the hash twins
def _nand_np(statics, seq):
    """numpy composition of FaultPlan.nand_read_retries / erase_fails over
    an array of sequence numbers (from the reference's fault_hash_np)."""
    seed, read_thresh, read_max, erase_thresh = statics
    h = ref_fault_hash_np(seed, SALT_NAND_READ, 0, seq)
    hit = (h & np.uint64(M32)) < np.uint64(read_thresh)
    k = np.uint64(1) + (h >> np.uint64(32)) % np.uint64(read_max)
    retries = np.where(hit, k, np.uint64(0)).astype(np.int64)
    e = ref_fault_hash_np(seed, SALT_NAND_ERASE, 0, seq)
    return retries, (e & np.uint64(M32)) < np.uint64(erase_thresh)


U64 = st.lists(st.one_of(st.integers(0, 2**64 - 1),
                         st.integers(TOP, 2**64 - 1)),
               min_size=1, max_size=64)
NODES = st.sampled_from(["h0", "h1", "d0", "d3", "s0", "sp1", "p1s0"])


@given(addrs=U64, num_paths=st.integers(1, 16), src=NODES, dst=NODES)
@settings(deadline=None)
def test_flow_choices_torch_equals_numpy(addrs, num_paths, src, dst):
    a = np.asarray(addrs, np.uint64)
    want = ref_flow_choices(src, dst, a, num_paths)
    np.testing.assert_array_equal(flow_choices(src, dst, a, num_paths), want)
    got = flow_choices_torch(src, dst, a, num_paths, torch_device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # an int64 tensor of the same bits is hashed where it lies
    t = torch.from_numpy(a.view(np.int64))
    assert torch.equal(flow_choices_torch(src, dst, t, num_paths), got)


@given(seqs=U64, seed=st.integers(0, 2**64 - 1),
       read=st.floats(0, 1), erase=st.floats(0, 1),
       read_max=st.integers(1, 8))
@settings(deadline=None)
def test_nand_torch_twins_equal_numpy(seqs, seed, read, erase, read_max):
    statics = FaultPlan(FaultConfig(nand_read_retry_rate=read,
                                    nand_read_retry_max=read_max,
                                    erase_fail_rate=erase),
                        seed=seed).nand_statics() \
        or (seed, 0, read_max, 0)
    s = np.asarray(seqs, np.uint64)
    retries, fails = _nand_np(statics, s)
    t = torch.from_numpy(s.view(np.int64))
    got_r = nand_read_retries_torch(statics, t)
    got_e = erase_fails_torch(statics, t)
    assert got_r.dtype == torch.int64 and got_e.dtype == torch.bool
    np.testing.assert_array_equal(got_r.numpy(), retries)
    np.testing.assert_array_equal(got_e.numpy(), fails)


def test_nand_twins_equal_the_scalar_plan():
    for kw in NAND_PLANS:
        plan_kw = {k: v for k, v in kw.items() if k != "seed"}
        plan = FaultPlan(FaultConfig(**plan_kw), seed=kw["seed"])
        seq = torch.arange(300)
        r = nand_read_retries_torch(plan.nand_statics(), seq).tolist()
        e = erase_fails_torch(plan.nand_statics(), seq).tolist()
        assert r == [plan.nand_read_retries(i) for i in range(300)]
        assert e == [plan.erase_fails(i) for i in range(300)]
        assert max(r) >= 1 and any(e)


def test_port_fault_hash_equals_the_reference():
    ords = TWIN_VALUES
    for salt in (0xA1A1, SALT_NAND_READ, 0xE5E5):
        np.testing.assert_array_equal(fault_hash_np(9, salt, 5, ords),
                                      ref_fault_hash_np(9, salt, 5, ords))


@pytest.mark.parametrize("src,dst", TWIN_PAIRS)
def test_flow_choices_torch_equals_the_jnp_twin(src, dst, reference):
    x = torch.from_numpy(TWIN_VALUES.view(np.int64))
    for n in range(1, 17):
        assert flow_choices_torch(src, dst, x, n).tolist() == \
            reference[f"flow/{src}/{dst}/{n}"], n


@pytest.mark.parametrize("index", range(len(NAND_PLANS)))
def test_nand_torch_twins_equal_the_jnp_twins(index, reference):
    statics = _statics(NAND_PLANS[index])
    seq = torch.from_numpy(TWIN_VALUES.view(np.int64))
    assert nand_read_retries_torch(statics, seq).tolist() == \
        reference[f"nand/{index}"]
    assert erase_fails_torch(statics, seq).tolist() == \
        reference[f"erase/{index}"]


def test_install_refuses_pool_views():
    from repro_torch.core.devices import DRAMDevice
    from repro_torch.core.fabric import MemoryPool

    fab = Fabric.build("single_switch", num_hosts=2, num_devices=1)
    view = MemoryPool(fab, {"d0": DRAMDevice()}).view("h0")
    with pytest.raises(TypeError, match="pool views"):
        install(FaultPlan(FaultConfig(poison_rate=0.5)), [view])
