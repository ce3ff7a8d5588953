"""The metrics layer of the port (``core/replay/metrics.py``, ``obs/``)
against the JAX package's.

The python lane's bundle must equal the golden ``metrics`` block of every
scenario whose ``python_scan`` pin the lane holds, key for key.  The
bucketing functions are held against the reference's own numpy functions
under hypothesis: their source is executed here, since importing
``repro.core.replay`` needs the alias of
``test_torch_reference.run_reference``.  Everything else that needs the
reference's drivers (the result properties, the poison count, Perfetto
documents, the availability helpers) comes from one child process for
this file.  Every comparison is exact.
"""

import ast
import json
import math
from typing import Dict, Optional, Tuple

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from golden import scenarios as sc
from repro_torch.core.replay import metrics as M
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.workloads.driver import MultiHostDriver, TraceDriver
from repro_torch.obs import to_perfetto, write_perfetto
from test_torch_reference import REPO, golden, run_reference
from test_torch_scenarios import (FAULT_SCENARIOS, PINNED, make_multi_targets,
                                  make_target, multi_traces, scenario_trace)

# every scenario whose python_scan pin the port's python lane holds
PYTHON_SCENARIOS = [f"{d}@direct" for d in sc.DEVICES] + PINNED
PERFETTO_SCENARIOS = ["cxl-ssd-cache@fabric", "faults-linkretry@spine_leaf"]
# per-access columns for the availability helpers: 40 accesses, a down
# window over ordinals 5-12 and one past the trace's end
AVAIL = dict(issues=np.arange(40, dtype=np.int64) * 300_000,
             lat=(np.arange(40, dtype=np.int64) % 7 + 1) * 90_000,
             degraded=(np.arange(40) >= 5) & (np.arange(40) < 12),
             failover=np.arange(40) % 9 == 6)
DOWN_LINKS = (("s0", "s1", 5, 12), ("s1", "s2", 38, 60), ("s2", "s3", 50, 60))


def run_port(name: str, spec=None):
    """The port's python lane on ``name`` with metrics."""
    spec = spec or MetricsSpec()
    if sc.is_multi(name):
        return MultiHostDriver(make_multi_targets(name),
                               outstanding=sc.OUTSTANDING,
                               metrics=spec).run(multi_traces(name))
    return TraceDriver(make_target(name),
                       outstanding=sc.scenario_outstanding(name),
                       metrics=spec).run(scenario_trace(name))


def jsonable(obj):
    return json.loads(json.dumps(obj))


REFERENCE = f"""
import json, sys
sys.path.insert(0, IN["tests"].item())
from golden import scenarios as sc
from repro.core.faults import FaultConfig, FaultPlan
from repro.core.replay.metrics import (MetricsSpec, availability_series,
                                       down_window_spans)
from repro.core.workloads.driver import MultiHostDriver, TraceDriver
from repro.obs import to_perfetto

def run(name):
    spec = MetricsSpec()
    if sc.is_multi(name):
        return MultiHostDriver(sc.make_multi_targets(name),
                               outstanding=sc.OUTSTANDING,
                               metrics=spec).run(sc.multi_traces(name))
    return TraceDriver(sc.make_target(name),
                       outstanding=sc.scenario_outstanding(name),
                       metrics=spec).run(sc.scenario_trace(name))

for name in IN["faults"].tolist():
    res = run(name)
    OUT["props/" + name] = np.asarray(json.dumps(dict(
        p99_ns=res.p99_ns, hit_rate=res.hit_rate,
        write_amplification=res.write_amplification,
        poisoned=res.metrics.faults["poisoned_reads"],
        bundle=res.metrics.to_jsonable())))
for name in IN["perfetto"].tolist():
    OUT["perfetto/" + name] = np.asarray(json.dumps(to_perfetto(run(name))))

issues, lat = IN["issues"], IN["lat"]
OUT["availability"] = np.asarray(json.dumps(availability_series(
    issues, issues + lat, IN["degraded"], IN["failover"],
    spec=MetricsSpec(window_ticks=2_000_000, num_windows=8),
    start_tick=100_000)))
plan = FaultPlan(FaultConfig(down_links={DOWN_LINKS!r}), seed=3)
OUT["spans"] = np.asarray(json.dumps(down_window_spans(
    plan, [issues, issues[:20]], hosts=["h0", "h1"])))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = run_reference(REFERENCE, tmp_path_factory.mktemp("metrics"), {
        "tests": np.asarray(str(REPO / "tests")),
        "faults": np.asarray(FAULT_SCENARIOS),
        "perfetto": np.asarray(PERFETTO_SCENARIOS), **{
            k: v for k, v in AVAIL.items()}})
    return {k: json.loads(str(v)) for k, v in out.items()}


# ------------------------------------------------------------ golden pins
def test_the_python_scenarios_are_the_fixture_less_fleet():
    # every pin of the fixture, the fleet's included
    fixture = set(sc.load_fixture()["scenarios"])
    assert set(PYTHON_SCENARIOS) == fixture
    assert sc.FLEET_SCENARIO in PYTHON_SCENARIOS
    assert len(PYTHON_SCENARIOS) == 24


@pytest.mark.parametrize("name", PYTHON_SCENARIOS)
def test_python_lane_metrics_equal_the_golden_block(name):
    res = run_port(name)
    assert jsonable(res.metrics.to_jsonable()) == golden(name)["metrics"]
    per_host = res.per_host if sc.is_multi(name) else [res]
    assert all(r.metrics is res.metrics for r in per_host)


def test_python_lane_without_metrics_has_none():
    res = TraceDriver(make_target("dram@direct")).run(
        scenario_trace("dram@direct"))
    assert res.metrics is None
    assert (res.p99_ns, res.hit_rate, res.write_amplification) == \
        (None, None, None)


# ------------------------------------------- through the reference child
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_properties_and_poison_count_equal_the_reference(name, reference):
    res = run_port(name)
    want = reference[f"props/{name}"]
    assert res.p99_ns == want["p99_ns"]
    assert res.hit_rate == want["hit_rate"]
    assert res.write_amplification == want["write_amplification"]
    assert res.metrics.faults["poisoned_reads"] == want["poisoned"]
    assert jsonable(res.metrics.to_jsonable()) == want["bundle"]


def test_the_nand_scenario_poisons_reads():
    # the poison count is exercised, not zero by construction
    assert run_port("faults-nand-retry@direct").metrics.faults[
        "poisoned_reads"] > 0


@pytest.mark.parametrize("name", PERFETTO_SCENARIOS)
def test_perfetto_document_equals_the_reference(name, reference, tmp_path):
    res = run_port(name)
    doc = to_perfetto(res)
    assert jsonable(doc) == reference[f"perfetto/{name}"]
    path = write_perfetto(res.metrics, str(tmp_path / "trace.json"))
    assert json.loads(open(path).read()) == jsonable(doc)


def test_availability_helpers_equal_the_reference(reference):
    from repro_torch.core.faults import FaultConfig, FaultPlan

    issues = AVAIL["issues"]
    got = M.availability_series(
        issues, issues + AVAIL["lat"], AVAIL["degraded"], AVAIL["failover"],
        spec=MetricsSpec(window_ticks=2_000_000, num_windows=8),
        start_tick=100_000)
    assert jsonable(got) == reference["availability"]
    plan = FaultPlan(FaultConfig(down_links=DOWN_LINKS), seed=3)
    spans = M.down_window_spans(plan, [issues, issues[:20]],
                                hosts=["h0", "h1"])
    assert jsonable(spans) == reference["spans"]
    assert len(spans) == 3          # h0 both windows in range, h1 one


def test_to_perfetto_refuses_a_result_without_metrics():
    res = TraceDriver(make_target("dram@direct")).run([(0, 64, False)])
    with pytest.raises(TypeError, match="MetricsBundle"):
        to_perfetto(res)


# ------------------------------------------- the reference's numpy code
def _reference_functions() -> dict:
    """``bucket_index``, ``bucket_bounds`` and ``percentile_from_hist`` as
    the JAX package defines them, executed from its source."""
    path = REPO / "src" / "repro" / "core" / "replay" / "metrics.py"
    tree = ast.parse(path.read_text())
    wanted = {"bucket_index", "bucket_bounds", "percentile_from_hist"}
    nodes = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {n.name for n in nodes} == wanted
    ns = {"np": np, "math": math, "Dict": Dict, "Optional": Optional,
          "Tuple": Tuple}
    exec(compile(ast.Module(nodes, []), str(path), "exec"), ns)
    return {k: ns[k] for k in wanted}


REF = _reference_functions()
LATENCIES = st.lists(st.integers(-(2**20), 2**53), min_size=1, max_size=64)


@settings(max_examples=200, deadline=None)
@given(lat=LATENCIES, num_buckets=st.integers(8, M.MAX_HIST_BUCKETS))
def test_bucket_index_equals_the_reference(lat, num_buckets):
    got = M.bucket_index(np.asarray(lat, np.int64), num_buckets)
    want = REF["bucket_index"](np.asarray(lat, np.int64), num_buckets)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@settings(max_examples=200, deadline=None)
@given(idx=st.integers(0, M.MAX_HIST_BUCKETS - 1))
def test_bucket_bounds_equal_the_reference_and_hold_their_values(idx):
    lo, hi = M.bucket_bounds(idx)
    assert (lo, hi) == REF["bucket_bounds"](idx)
    edges = np.asarray([lo, hi], np.int64)
    assert M.bucket_index(edges, M.MAX_HIST_BUCKETS).tolist() == [idx, idx]


@settings(max_examples=200, deadline=None)
@given(hist=st.lists(st.integers(0, 1000), min_size=8, max_size=64),
       q=st.floats(0, 100, allow_nan=False))
def test_percentile_from_hist_equals_the_reference(hist, q):
    assert M.percentile_from_hist(np.asarray(hist), q) == \
        REF["percentile_from_hist"](np.asarray(hist), q)


def test_bucket_index_is_exact_up_to_2_53():
    v = np.asarray([2**53 - 1, 2**53, 2**52 + 1, 7, 8, 0, -5], np.int64)
    got = M.bucket_index(v, M.MAX_HIST_BUCKETS)
    assert got.tolist() == REF["bucket_index"](v, M.MAX_HIST_BUCKETS).tolist()
    assert got.tolist()[3:] == [7, 8, 0, 0]


def test_metrics_spec_refuses_out_of_range_shapes():
    with pytest.raises(ValueError, match="hist_buckets"):
        MetricsSpec(hist_buckets=M.MAX_HIST_BUCKETS + 1)
    with pytest.raises(ValueError, match="window_ticks"):
        MetricsSpec(window_ticks=0)
