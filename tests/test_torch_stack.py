"""The scan lane's state layer (``core/replay/stack.py``) and its plain twin
against the port's python lane.

The twin runs through ``ReplayEngine(torch_device="cpu")``; the python
lane's per-access latencies come from a tap on its target.  Ticks, flags
and counters are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from golden import scenarios as sc
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.replay import init_state, media_init, step, stack
from repro_torch.core.replay.engine import ReplayEngine
from repro_torch.core.replay.spec import (DRAM, SSD_CACHE, ReplayUnsupported,
                                          build_stack)
from repro_torch.core.workloads.driver import TraceDriver
from repro_torch.core.workloads.traces import make_trace
from test_torch_scenarios import (ServiceTap, gc_ssd_cfg, make_target,
                                  scenario_trace)

FIELDS = ("elapsed_ticks", "sum_latency_ticks", "end_tick", "accesses",
          "bytes_moved")


def python_lane(device, trace, **kw):
    tap = ServiceTap(device)
    res = TraceDriver(tap, **kw).run(trace)
    return tap.latencies, res


def assert_twin_equals_python(make, trace, **kw):
    lat, want = python_lane(make(), trace, **kw)
    got = ReplayEngine(make(), torch_device="cpu", **kw).run(trace)
    assert got.latency_ticks.tolist() == lat
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    return got


def _cached(**kw):
    return make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(**kw))


@pytest.mark.parametrize("device", sc.DEVICES)
def test_twin_equals_python_on_the_golden_traces(device):
    name = f"{device}@direct"
    assert_twin_equals_python(lambda: make_target(name), scenario_trace(name),
                              outstanding=sc.OUTSTANDING)


@pytest.mark.parametrize("device", sc.DEVICES)
def test_twin_equals_python_at_table_i_width(device):
    # make_device defaults: the cached CXL-SSD is Table I's (4096 frames),
    # which these 8000 accesses over 8192 pages fill and then evict from
    trace = make_trace(11, n=8000, pages=8192)
    res = assert_twin_equals_python(lambda: make_device(device), trace,
                                    outstanding=32)
    if device == "cxl-ssd-cache":
        cfg, _ = build_stack(make_device(device), size=64, outstanding=32,
                             issue_overhead_ns=0.5, posted_writes=True,
                             n_accesses=8000, max_addr=8192 * 4096)
        assert cfg.cache_frames == 4096
        assert 0 < res.hits < 8000 and res.evict_flags.any()


@settings(max_examples=25, deadline=None)
@given(policy=st.sampled_from(["lru", "fifo", "direct"]),
       mshr=st.integers(1, 4), wb=st.integers(1, 3),
       outstanding=st.integers(1, 32), posted=st.booleans(),
       seed=st.integers(0, 2**16), frames=st.sampled_from([1, 3, 8, 16]))
def test_twin_equals_python_under_hypothesis(policy, mshr, wb, outstanding,
                                             posted, seed, frames):
    kw = dict(policy=policy, capacity_bytes=frames * 4096, mshr_entries=mshr,
              writeback_buffer=wb)
    trace = make_trace(seed, n=160, pages=24, write_frac=0.5)
    assert_twin_equals_python(lambda: _cached(**kw), trace,
                              outstanding=outstanding, posted_writes=posted)


@pytest.mark.parametrize("device", ["dram", "pmem", "cxl-ssd"])
@pytest.mark.parametrize("posted", [True, False])
def test_twin_equals_python_on_the_other_devices(device, posted):
    trace = make_trace(5, n=300, pages=24, write_frac=0.5)
    assert_twin_equals_python(lambda: make_device(device), trace,
                              outstanding=4, posted_writes=posted)


def test_twin_runs_greedy_gc_like_python():
    res = assert_twin_equals_python(lambda: make_target("ssd-gc@direct"),
                                    scenario_trace("ssd-gc@direct"),
                                    outstanding=sc.OUTSTANDING)
    assert res.gc_runs > 0


def _overfilled(cap_pages):
    return make_device("cxl-ssd-cache", ssd_cfg=gc_ssd_cfg(cap_pages),
                       cache_cfg=DRAMCacheConfig(capacity_bytes=4 * 4096,
                                                 mshr_entries=2,
                                                 writeback_buffer=1))


def test_twin_collects_often_like_python():
    trace = [((k * 7) % 60 * 4096, 64, True) for k in range(180)]
    res = assert_twin_equals_python(lambda: _overfilled(64), trace,
                                    outstanding=8)
    assert res.gc_runs > 10


def test_free_pool_underrun_refuses_where_python_runs_out_of_space():
    trace = [((k * 7) % 60 * 4096, 64, True) for k in range(180)]
    with pytest.raises(RuntimeError, match="out of space"):
        TraceDriver(_overfilled(48), outstanding=8).run(trace)
    with pytest.raises(ReplayUnsupported, match="ran out of free blocks"):
        ReplayEngine(_overfilled(48), outstanding=8,
                     torch_device="cpu").run(trace)


# ------------------------------------------------------------ the state
def test_state_mirrors_the_reference_layout():
    cfg, _ = build_stack(make_target("ssd-gc@direct"), size=64,
                         outstanding=8, issue_overhead_ns=0.5,
                         posted_writes=True, n_accesses=790,
                         max_addr=750 * 4096, counters=True)
    assert cfg.kind == SSD_CACHE and cfg.gc
    st_ = init_state(cfg, "cpu")
    md, f = st_["media"], st_["flash"]
    assert md["frames"].dtype == torch.int64
    assert md["frames"].shape == (cfg.cache_frames,)
    assert md["mready"].tolist() == [stack.BIG] * cfg.mshr_entries
    assert md["wtick"].tolist() == [stack.FREE] * cfg.wb_slots
    assert f["l2p"].dtype == torch.int32 and f["l2p"].shape == (1024,)
    nb = cfg.num_blocks
    assert f["free_q"].tolist() == list(range(1, nb)) + [0]
    assert f["free_mask"].tolist() == [False] + [True] * (nb - 1)
    assert int(f["fq_count"]) == nb - 1 and not bool(f["bad"])
    assert set(f) >= {"c_hr", "c_hw", "c_gw", "c_ge", "gcs", "p2l", "valid"}
    assert stack.flash_health(st_) == (False, 0)
    assert stack.flash_counters(st_) == [[0, 0, 0, 0, 0]]
    dram, _ = build_stack(make_device("dram"), size=64, outstanding=8,
                          issue_overhead_ns=0.5, posted_writes=True,
                          n_accesses=1, max_addr=0)
    assert dram.kind == DRAM
    assert init_state(dram)["flash"] is None
    assert set(media_init(dram, "cpu")) == {"busy"}
    assert stack.flash_health(init_state(dram)) == (False, 0)
    assert stack.flash_counters(init_state(dram)) is None


def test_step_updates_the_state_in_place():
    dev = _cached(capacity_bytes=2 * 4096)
    cfg, params = build_stack(dev, size=64, outstanding=1,
                              issue_overhead_ns=0.5, posted_writes=True,
                              n_accesses=3, max_addr=8192)
    from repro_torch.kernels.replay_scan import host_params

    p = host_params(params)
    st_ = init_state(cfg)
    frames = st_["media"]["frames"]
    out = step(cfg, p, st_, dict(t=0, addr=4096, write=True, posted=True,
                                 ctr=1))
    assert out["miss"] and not out["hit"] and out["done"] > 0
    assert st_["media"]["frames"] is frames
    assert int(frames[0]) == (1 << stack.STAMP_SHIFT) | (1 << 1) | 1
    again = step(cfg, p, st_, dict(t=10**9, addr=4096 + 64,
                                   write=False, posted=False, ctr=2))
    assert again["hit"] and not again["miss"]
    # an LRU touch restamps the frame and keeps it dirty
    assert int(frames[0]) == (2 << stack.STAMP_SHIFT) | (1 << 1) | 1


def test_packed_constants_match_the_reference():
    assert stack.PAGE_FIELD == ((1 << 38) - 1) << 1
    assert stack.STAMP_FIELD == -(1 << 39)
    assert stack.MAX_ACCESSES == (1 << 23) - 1
    assert (stack.MAX_ACCESSES << stack.STAMP_SHIFT) < 2**63
    assert np.int64(-1) & stack.PAGE_FIELD == stack.PAGE_FIELD
