"""The port's twins of the golden scenario builders, and their checks.

``tests/golden/scenarios.py`` builds its targets from the JAX package;
``torch_scenarios.py`` builds the same targets from the port
(``make_target``, ``make_multi_targets``, ``multi_traces``,
``scenario_trace``, re-exported here), and :func:`run_python` replays them
through the port's python lane.  :data:`COUNTERS` is the one definition of the
fabric, fault and device counters the port's tests compare with the
reference: it is executed here on the port's objects and, as source, in
the reference's child process on the JAX package's.

Other test files import these names (``tests/`` is on ``sys.path``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import torch_scenarios as ts
from golden import scenarios as sc
from repro_torch.core.fabric import FabricAttachedDevice
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from test_torch_reference import golden
from torch_scenarios import (gc_ssd_cfg, make_multi_targets, make_target,
                             mk_device, multi_traces, scenario_trace)

__all__ = ["gc_ssd_cfg", "make_multi_targets", "make_target", "mk_device",
           "multi_traces", "scenario_trace"]

# the scenarios of the golden fixture the port's python lane holds here
# (the five @direct ones are held by test_torch_devices.py)
FABRIC_SCENARIOS = [f"{d}@fabric" for d in sc.DEVICES] + ["dram-qos@fabric"]
MULTI_SCENARIOS = ["multihost-qos-ecmp"] + sorted(sc.MULTI_SSD_HOSTS)
STREAM_SCENARIOS = ["dram@stream", "pmem@stream", "ssd-gc@direct"]
FAULT_SCENARIOS = list(sc.FAULT_SCENARIOS) + sorted(sc.MULTI_FAULT_HOSTS)
PINNED = STREAM_SCENARIOS + FABRIC_SCENARIOS + MULTI_SCENARIOS \
    + FAULT_SCENARIOS + [sc.FLEET_SCENARIO]


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


@pytest.mark.parametrize("name", [
    "CACHE_KW", "DEVICES", "N_ACCESSES", "OUTSTANDING", "STREAM_OUTSTANDING",
    "MULTI", "MULTI_SSD_HOSTS", "FAULT_SCENARIOS", "MULTI_FAULT_HOSTS",
    "FLEET_SCENARIO", "FLEET_GOLDEN_HOSTS"])
def test_builder_constants_equal_the_fixtures(name):
    assert getattr(ts, name) == getattr(sc, name)


def test_builder_helpers_agree_with_the_fixtures():
    names = list(sc.load_fixture()["scenarios"])
    assert [ts.is_multi(n) for n in names] == [sc.is_multi(n) for n in names]
    assert ([ts.scenario_outstanding(n) for n in names]
            == [sc.scenario_outstanding(n) for n in names])


def test_the_pinned_list_is_the_fixture_less_direct_and_fleet():
    # every pin but the five @direct ones, the fleet's included
    fixture = set(sc.load_fixture()["scenarios"])
    direct = {f"{d}@direct" for d in sc.DEVICES}
    assert set(PINNED) == fixture - direct
    assert sc.FLEET_SCENARIO in PINNED
    assert len(PINNED) == 19 and len(set(PINNED)) == 19


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

