"""``replay_scan.cu``'s own source on the CPU: the host compiler builds it
for a thread-per-CUDA-thread emulation of its block
(``REPLAY_SCAN_EMULATE``, ``torch_replay_scan_emulate.cpp``) under
AddressSanitizer, and the wrapper's packing (``replay_scan.call_launch``,
``replay_scan.layout``) feeds it CPU tensors.

Every output and every final state tensor must equal the plain twin's
(``replay_scan_plain``) on the 14 single-host fault-free scenarios, on
cache shapes over policy, MSHR, writeback, ``outstanding`` and posted
writes, on Table I's cached CXL-SSD past its 4096 frames (and past 2^14
accesses over 16,384 pages), under FIFO and direct mapping, on the other
devices at 2000 accesses, in the shared-memory and the device-memory
layout, on traces that wrap the staging buffers many times or end inside
a chunk, on ECMP and QoS mounts, and under fault plans: the three
single-host golden fault scenarios and the faulted mounts of
``torch_scenarios.FAULT_CASES`` (NAND read retries with GC retirement, a
down window with failover inside an ECMP set, a CXL-DRAM's private hop,
weighted QoS ports under CRC retries), each in both layouts.  The
multi-host instance (``replay_scan.call_launch_multi``) meets its twin
(``replay_multi_plain``) on the six golden multi-host scenarios, on
PMEM, CXL-SSD and NAND-faulted shared-flash mounts and on a trace whose
first host runs out long before the others, each in both layouts.

Resumable: a chunked sequence of emulated launches through one carry
(``replay_scan.new_carry``, the multi-host instance's windows from each
host's cursor through ``new_multi_carry``) equals one launch and the
twin's chunked replay on every output, every final state tensor and the
carry itself (its page map and recency links included), in both layouts:
Table I past its 4096 frames under LRU, FIFO and direct mapping, cache
shapes of 1, 2, 3 and 32 outstanding with seams after the first accesses
(slots still tied at the start tick), ECMP + QoS, faulted mounts with
seams inside their down windows and under NAND retries with GC, and the
multi-host instance on QoS + ECMP, shared flash under NAND faults,
transport faults and a host that runs out early.

Sweeps: the grid instances (``replay_scan.call_launch_sweep``,
``call_launch_multi_sweep``), emulated block after block with each
block's index, equal to their twins (``replay_sweep_plain``,
``replay_multi_sweep_plain``) on every output and every lane's final
state tensors, in both layouts: capacity, policy and timing lanes of
Table I past its 4096 frames, per-lane traces, a GC-pressured flash
under NAND faults; host-count lanes on multi-host scenarios (QoS + ECMP,
cached mounts, shared flash under NAND faults), an empty lane among
them; and fault-seed lanes whose seeds take different path sets (one
union path table).  ASan aborts on any index the kernel forms outside
its array, every per-lane offset included.

The sharded instance (``replay_scan.call_launch_sharded``): a
thread-block cluster emulated as its D blocks at once (D x 128 threads,
the cluster barrier a barrier of all of them, distributed shared memory a
pointer into the other block's buffer), equal to its twin
(``replay_sharded_plain``) and to the one-CTA twin (``replay_multi_plain``)
on every output and every final state tensor, in both layouts: multi-pod
DRAM mounts at D = 1, 2, 4, 8, QoS + ECMP, PMEM, cached CXL-SSD with
private flash, NAND and transport faults, the faulted spine-leaf golden
scenario and the golden fleet pin at D = 8.  The library only loads into a process that
starts with ASan's runtime, so the cases run in one child process for
this file.

    python tests/test_torch_scan_emulate.py LIBRARY OUT.json

runs them in such a process and writes their results."""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import make_device
from repro_torch.core.fabric import Fabric
from repro_torch.core.replay import stack
from repro_torch.core.replay.engine import ReplayEngine
from repro_torch.core.replay.metrics import MetricsSpec
from repro_torch.core.replay.multihost import MultiHostReplay
from repro_torch.core.replay.spec import trace_to_arrays
from repro_torch.kernels import _build
from repro_torch.kernels import replay_scan as rs
from torch_scenarios import (DEVICES, FAULT_CASES, FAULT_SCENARIOS,
                             fault_case, gc_ssd_cfg, make_multi_targets,
                             make_target, multi_traces, scenario_outstanding,
                             scenario_trace, shard_case)

REPO = Path(__file__).resolve().parents[1]
SHIM = REPO / "tests" / "torch_replay_scan_emulate.cpp"
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
# dynamic shared memory a block may opt in to on an H100: the budget the
# emulated layouts are computed for (on the card the wrapper asks for it)
H100_SMEM_OPTIN = 232448
SCAN_SCENARIOS = ([f"{d}@{a}" for d in DEVICES for a in ("direct", "fabric")]
                  + ["dram@stream", "pmem@stream", "dram-qos@fabric",
                     "ssd-gc@direct"])
# (policy, MSHR entries, writeback slots, outstanding, posted writes) of a
# 16-frame cache over 48 pages
CACHE_SHAPES = [("lru", 1, 1, 1, True), ("fifo", 4, 3, 32, False),
                ("direct", 2, 2, 7, True), ("lru", 3, 1, 33, False),
                ("fifo", 1, 2, 2, True), ("direct", 4, 3, 16, False),
                ("lru", 2, 2, 3, True)]
OTHER_DEVICES = ["dram", "cxl-dram", "pmem", "cxl-ssd"]
# (name, device, cache policy, accesses, pages, chunk): traces that wrap
# the two staging buffers 125 times, lengths that are not a multiple of the
# chunk, Table I's cached CXL-SSD past 2^14 accesses over chip_smoke.py's
# 16,384 pages, and Table I's geometry under FIFO and direct mapping
CHUNKED = [("ring/pmem", "pmem", None, 2000, 200, 16),
           ("ring/cxl-ssd-cache", "cxl-ssd-cache", "lru", 2000, 200, 16),
           ("odd/dram", "dram", None, 1001, 200, 64),
           ("odd/cxl-ssd", "cxl-ssd", None, 1001, 200, 64),
           ("table1/16461", "cxl-ssd-cache", None, (1 << 14) + 77, 16384,
            256),
           ("table1-fifo/8000", "cxl-ssd-cache", "fifo", 8000, 8192, 256),
           ("table1-direct/8000", "cxl-ssd-cache", "direct", 8000, 8192,
            256)]
CASES = (SCAN_SCENARIOS + ["ssd-gc@direct/global"]
         + [f"cache/{p}/m{m}/wb{wb}/out{o}/posted{int(pw)}"
            for p, m, wb, o, pw in CACHE_SHAPES]
         + ["table1/churn", "table1/global"]
         + [f"{d}/2000" for d in OTHER_DEVICES]
         + ["ecmp/dram", "ecmp-qos/cxl-ssd-cache"]
         + [c[0] for c in CHUNKED]
         + ["table1/16461/global", "table1-fifo/8000/global",
            "table1-direct/8000/global", "gc/chunk16", "gc/chunk16/global"])
# under fault plans, in both layouts
FAULTED = [f"{name}{lay}" for name in (*FAULT_SCENARIOS, *FAULT_CASES)
           for lay in ("", "/global")]
CASES = CASES + FAULTED
# the multi-host instance, in both layouts: the golden multi-host
# scenarios, then mounts of the kinds and statics they do not reach and a
# host that runs out of trace early
MULTI_SCENARIOS = ["multihost-qos-ecmp", "multihost-ssd-mounts",
                   "multihost-ssd-pool", "multihost-ssd-sharedflash",
                   "faults-portdown@multihost_x2",
                   "faults-linkretry@spine_leaf_x4"]
MULTI_EXTRA = ["multi/pmem", "multi/cxl-ssd", "multi/nand-shared",
               "multi/exhaust"]
MULTI_CASES = [f"{name}{lay}" for name in (*MULTI_SCENARIOS, *MULTI_EXTRA)
               for lay in ("", "/global")]
# resumable: (case, schedules) of a chunked sequence of launches, each in
# both layouts; a schedule is the launches' sizes, its last size repeated.
# Seams after the first accesses find LFB slots still tied at the start
# tick; the down windows of down-ecmp/dram ([40, 120), [80, 160)) and
# qos-retry/cxl-ssd-cache ([40, 120)) hold seams.
RESUMED = {"table1/churn": ((777,), (1, 2, 4096)),
           "table1-fifo/8000": ((999,),), "table1-direct/8000": ((999,),),
           "cache/lru/m1/wb1/out1/posted1": ((1, 1, 7, 50),),
           "cache/fifo/m1/wb2/out2/posted1": ((1, 2, 3, 64),),
           "cache/lru/m2/wb2/out3/posted1": ((1, 1, 1, 5, 60),),
           "cache/fifo/m4/wb3/out32/posted0": ((1, 1, 64),),
           "dram/2000": ((1, 3, 250),), "ecmp-qos/cxl-ssd-cache": ((7, 100),),
           "down-ecmp/dram": ((50,), (33,)),
           "qos-retry/cxl-ssd-cache": ((30,),),
           "nand-gc/cxl-ssd": ((100,),), "pmem/2000": ((300,),)}
RESUMED_CASES = [f"{name}{lay}" for name in RESUMED
                 for lay in ("", "/global")]
MULTI_RESUMED = {"multihost-qos-ecmp": ((1, 1, 7, 40),),
                 "multi/exhaust": ((64,),),
                 "faults-linkretry@spine_leaf_x4": ((64,),),
                 "multi/nand-shared": ((50,),),
                 "multihost-ssd-mounts": ((1, 7, 40),)}
MULTI_RESUMED_CASES = [f"{name}{lay}" for name in MULTI_RESUMED
                       for lay in ("", "/global")]


def _trace(n: int, pages: int, write_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, pages, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < write_frac
    return [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]


def _case(name: str):
    """``(make_target, trace, outstanding, posted, start_tick,
    placed_in_smem, chunk)`` of case ``name``; a ``/global`` case runs the
    device-memory layout."""
    base = name.removesuffix("/global")
    placed = base == name
    if base in FAULT_CASES:
        return (lambda: fault_case(base)[0], fault_case(base)[1], 8, True, 0,
                placed, rs.CHUNK)
    if base in SCAN_SCENARIOS or base in FAULT_SCENARIOS:
        return (lambda: make_target(base), scenario_trace(base),
                scenario_outstanding(base), True, 0, placed, rs.CHUNK)
    if base == "gc/chunk16":
        return (lambda: make_target("ssd-gc@direct"),
                scenario_trace("ssd-gc@direct"),
                scenario_outstanding("ssd-gc@direct"), True, 0, placed, 16)
    if base.startswith("cache/"):
        i = [c for c in CASES if c.startswith("cache/")].index(base)
        policy, mshr, wb, out, posted = CACHE_SHAPES[i]
        cfg = dict(policy=policy, capacity_bytes=16 * 4096,
                   mshr_entries=mshr, writeback_buffer=wb)
        return (lambda: make_device("cxl-ssd-cache",
                                    cache_cfg=DRAMCacheConfig(**cfg)),
                _trace(600, 48, 0.5, i), out, posted, 1000 * i, placed,
                rs.CHUNK)
    if base == "table1/churn":      # ~5100 of 8192 pages: fills, evicts
        return (lambda: make_device("cxl-ssd-cache"),
                _trace(8000, 8192, 0.3, 9), 32, True, 0, placed, rs.CHUNK)
    if name == "table1/global":
        return (lambda: make_device("cxl-ssd-cache"),
                _trace(3000, 8192, 0.3, 9), 32, True, 0, False, rs.CHUNK)
    if base.endswith("/2000"):
        d = base.split("/")[0]
        return lambda: make_device(d), _trace(2000, 4096, 0.3, 5), 32, True, \
            0, placed, rs.CHUNK
    chunked = {c[0]: c[1:] for c in CHUNKED}
    if base in chunked:
        device, policy, n, pages, chunk = chunked[base]
        kw = {}
        if device == "cxl-ssd-cache" and pages < 1000:
            kw = dict(cache_cfg=DRAMCacheConfig(policy=policy,
                                                capacity_bytes=64 * 4096))
        elif policy is not None:
            kw = dict(cache_cfg=DRAMCacheConfig(policy=policy))
        return (lambda: make_device(device, **kw),
                _trace(n, pages, 0.3, n % 97), 32, True, 0, placed, chunk)
    qos = {"h0": 2.0, "h1": 1.0} if name.startswith("ecmp-qos") else None
    kind = base.split("/")[1]

    def mount():
        fab = Fabric.build("spine_leaf", num_hosts=2, num_devices=2,
                           num_leaves=2, num_spines=2, ecmp=True,
                           qos_weights=qos)
        dev = (make_device(kind, cache_cfg=DRAMCacheConfig(
            capacity_bytes=16 * 4096)) if kind == "cxl-ssd-cache"
            else make_device(kind))
        return fab.mount("h0", "d0", dev)      # two routes through the spines

    return mount, _trace(800, 64, 0.3, 3 if qos is None else 4), 8, True, \
        0, placed, rs.CHUNK


def run_case(lib, name: str) -> dict:
    """The emulated kernel and the plain twin on case ``name``, each from a
    fresh state: the outputs and state tensors that differ, and the twin's
    hit and dirty-eviction counts, and the fault counts (NAND read
    retries, retired blocks, link retries) of the stack."""
    make, trace, outstanding, posted, start, placed, chunk = _case(name)
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, routes, retries, builder = ReplayEngine(
        make(), outstanding=outstanding, posted_writes=posted,
        metrics=MetricsSpec()).prepare(addrs, size=size)
    assert (cfg.num_routes > 1) == name.startswith("ecmp"), name
    routes = None if routes is None else torch.from_numpy(routes)
    retries = None if retries is None else torch.from_numpy(retries)
    a, w = torch.from_numpy(addrs), torch.from_numpy(writes)
    want_state, got_state = (stack.init_state(cfg, "cpu"),
                             stack.init_state(cfg, "cpu"))
    want = rs.replay_scan_plain(cfg, params, want_state, a, w, routes,
                                start_tick=start, retries=retries)
    lay = rs.layout(cfg, params, H100_SMEM_OPTIN, chunk=chunk,
                    placed=placed)
    err, got = rs.call_launch(lib, cfg, params, got_state, a, w, routes,
                              start, lay, None, retries=retries)
    differ = [k for k, g, x in zip(
        ("issues", "dones", "flags", "qacc", "qthr"), got, want)
        if not torch.equal(g, x)]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)]
    flags = want[2]
    rr, rb = stack.fault_counters(want_state)
    return {"err": err, "differ": differ, "accesses": len(trace),
            "hits": int((flags & 1).sum()),
            "evicts": int(((flags >> 1) & 1).sum()),
            "read_retries": rr, "retired": rb,
            "link_retries": (builder.fstats["link_retries"]
                             if builder is not None else 0),
            "failovers": (builder.fstats["failovers"]
                          if builder is not None else 0),
            "qthr": int(want[4].sum()),
            "in_smem": list(lay.in_smem)}


def schedule_spans(schedule, total: int):
    """The launches' sizes of ``schedule`` (its last size repeated) over
    ``total`` accesses or steps."""
    out = []
    while sum(out) < total:
        out.append(min(schedule[min(len(out), len(schedule) - 1)],
                       total - sum(out)))
    return out


_TWIN = {}    # the twin's replays of a case, shared by its two layouts


def run_resumed_case(lib, name: str, schedule) -> dict:
    """Case ``name`` as emulated launches of the ``schedule``'s sizes
    through one carry, against the twin's one-call replay and its chunked
    replay through a carry of its own: what differs (outputs, final
    state, the carries), and the launches."""
    make, trace, outstanding, posted, start, placed, stage = _case(name)
    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, routes, retries, _ = ReplayEngine(
        make(), outstanding=outstanding, posted_writes=posted,
        metrics=MetricsSpec()).prepare(addrs, size=size)
    cols = [torch.from_numpy(x) if x is not None else None
            for x in (addrs, writes, routes, retries)]
    spans = schedule_spans(schedule, len(trace))
    parts, lo = [], 0
    for span in spans:
        parts.append([None if x is None else x[lo:lo + span].contiguous()
                      for x in cols])
        lo += span
    key = (name.removesuffix("/global"), schedule)
    if key not in _TWIN:
        want_state, twin_state = (stack.init_state(cfg, "cpu")
                                  for _ in range(2))
        want = rs.replay_scan_plain(cfg, params, want_state, *cols[:3],
                                    start_tick=start, retries=cols[3])
        twin_carry = rs.new_carry(cfg, params, "cpu", start)
        twin = [rs.replay_scan_plain(cfg, params, twin_state, *part[:3],
                                     start_tick=start, retries=part[3],
                                     carry=twin_carry) for part in parts]
        _TWIN[key] = want, want_state, twin, twin_state, twin_carry
    want, want_state, twin, twin_state, twin_carry = _TWIN[key]
    lay = rs.layout(cfg, params, H100_SMEM_OPTIN, chunk=stage, placed=placed)
    got_state = stack.init_state(cfg, "cpu")
    got_carry = rs.new_carry(cfg, params, "cpu", start)
    got, errs = [], []
    for part in parts:
        err, out = rs.call_launch(lib, cfg, params, got_state, *part[:3],
                                  start, lay, None, retries=part[3],
                                  carry=got_carry)
        errs.append(err)
        got.append(out)
    differ = []
    for i, k in enumerate(("issues", "dones", "flags")):
        differ += [f"{who}.{k}" for who, outs in (("kernel", got),
                                                   ("twin", twin))
                   if not torch.equal(torch.cat([o[i] for o in outs]),
                                      want[i])]
    differ += [f"kernel.{k}" for i, k in ((3, "qacc"), (4, "qthr"))
               if not torch.equal(got[-1][i], want[i])]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)
                   or not torch.equal(twin_state[part][k], x)]
    differ += [f"carry.{k}" for k in ("words", "maps")
               if not torch.equal(getattr(got_carry, k),
                                  getattr(twin_carry, k))]
    return {"err": max(errs), "differ": differ, "launches": len(got),
            "seen": got_carry.seen, "accesses": len(trace)}


def _windows(x, base, width, lens):
    """Each host's window of ``width`` accesses of ``x`` from its cursor."""
    if x is None:
        return None
    out = np.zeros((x.shape[0], width) + x.shape[2:], x.dtype)
    for i, b in enumerate(base):
        e = min(int(b) + width, int(lens[i]))
        out[i, :max(e - int(b), 0)] = x[i, int(b):e]
    return torch.from_numpy(out)


def run_multi_resumed_case(lib, name: str, schedule) -> dict:
    """The multi-host case ``name`` as emulated launches over each host's
    window from its cursor, as wide as the ``schedule``'s sizes, through
    one carry, against the twin's one-call replay and its windowed replay:
    what differs, and the launches."""
    base_name = name.removesuffix("/global")
    targets, traces = _multi_case(base_name)
    prep = MultiHostReplay(targets, outstanding=8, metrics=MetricsSpec(),
                           torch_device="cpu").prepare(traces)
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want_state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash,
                                  "cpu")
    want = rs.replay_multi_plain(
        cfg, prep.params, want_state, *(t(x) for x in (
            prep.addrs, prep.writes, prep.lens, prep.devs, prep.routes)),
        retries=t(prep.retries))
    lay = rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN,
                          placed=base_name == name)
    got_state, twin_state = (stack.init_lanes(cfg.stack, cfg.num_devs,
                                              cfg.n_flash, "cpu")
                             for _ in range(2))
    got_carry, twin_carry = (rs.new_multi_carry(cfg, prep.params, "cpu")
                             for _ in range(2))
    got, twin, errs, cursors_equal = [], [], [], True
    for width in schedule_spans(schedule, int(prep.lens.sum())):
        base = rs.cursors(got_carry, cfg.num_hosts)
        cursors_equal &= bool((base == rs.cursors(
            twin_carry, cfg.num_hosts)).all())
        a, w, d, r, rt = (_windows(x, base, width, prep.lens) for x in (
            prep.addrs, prep.writes, prep.devs, prep.routes, prep.retries))
        lens = t(prep.lens)
        n = rs._check_multi(cfg, prep.params, got_state, a, w, lens, d, r,
                            rt, got_carry, base)
        err, out = rs.call_launch_multi(lib, cfg, prep.params, got_state, a,
                                        w, lens, d, r, 0, lay, None,
                                        retries=rt, n=n, carry=got_carry)
        errs.append(err)
        got.append(out)
        twin.append(rs.replay_multi_plain(
            cfg, prep.params, twin_state, a, w, lens, d, r, retries=rt,
            carry=twin_carry, base=base))
    differ = [] if cursors_equal else ["cursors"]
    for i, k in enumerate(("who", "issues", "dones", "flags")):
        differ += [f"{who}.{k}" for who, outs in (("kernel", got),
                                                   ("twin", twin))
                   if not torch.equal(torch.cat([o[i] for o in outs]),
                                      want[i])]
    differ += [f"kernel.{k}" for i, k in ((4, "qacc"), (5, "qthr"))
               if not torch.equal(got[-1][i], want[i])]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)
                   or not torch.equal(twin_state[part][k], x)]
    differ += [f"carry.{k}" for k in ("words", "maps")
               if not torch.equal(getattr(got_carry, k),
                                  getattr(twin_carry, k))]
    return {"err": max(errs), "differ": differ, "launches": len(got),
            "steps": int(prep.lens.sum())}


def _multi_case(name: str):
    """``(targets, traces)`` of multi-host case ``name`` (fresh)."""
    if name in MULTI_SCENARIOS:
        return make_multi_targets(name), multi_traces(name)
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.ssd.hil import HIL

    fab = Fabric.build("two_level", num_hosts=3, num_devices=3,
                       num_leaves=2)
    kind = name.split("/")[1]
    if kind == "nand-shared":
        # two cached front ends over one GC-pressured flash under NAND
        # read retries and erase fails
        hil = HIL(gc_ssd_cfg(64))
        tgts = [fab.mount(f"h{i}", f"d{i}", make_device(
            "cxl-ssd-cache", hil=hil, cache_cfg=DRAMCacheConfig(
                capacity_bytes=8 * 4096, mshr_entries=4,
                writeback_buffer=2))) for i in range(2)]
        install(FaultPlan(FaultConfig(nand_read_retry_rate=0.4,
                                      erase_fail_rate=0.5), seed=3), tgts)
        return tgts, [_trace(300, 40, 0.8, 20 + h) for h in range(2)]
    device = {"pmem": "pmem", "cxl-ssd": "cxl-ssd"}.get(kind, "cxl-ssd-cache")
    kw = ({"cache_cfg": DRAMCacheConfig(capacity_bytes=16 * 4096,
                                        mshr_entries=3, writeback_buffer=2)}
          if device == "cxl-ssd-cache" else {})
    tgts = [fab.mount(f"h{i}", f"d{i}", make_device(device, **kw))
            for i in range(3)]
    lens = (20, 400, 300) if kind == "exhaust" else (250, 250, 250)
    return tgts, [_trace(n, 48, 0.4, 10 + h) for h, n in enumerate(lens)]


def run_multi_case(lib, name: str) -> dict:
    """The emulated multi-host instance and its plain twin on case
    ``name``, each from fresh lanes: the outputs and state tensors that
    differ, and what the case exercised."""
    base = name.removesuffix("/global")
    targets, traces = _multi_case(base)
    eng = MultiHostReplay(targets, outstanding=8, metrics=MetricsSpec(),
                          torch_device="cpu")
    prep = eng.prepare(traces)
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(x)

    ins = [t(x) for x in (prep.addrs, prep.writes, prep.lens, prep.devs,
                          prep.routes)]
    want_state, got_state = (
        stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cpu")
        for _ in range(2))
    want = rs.replay_multi_plain(cfg, prep.params, want_state, *ins,
                                 retries=t(prep.retries))
    lay = rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN,
                          placed=base == name)
    err, got = rs.call_launch_multi(lib, cfg, prep.params, got_state, *ins,
                                    0, lay, None, retries=t(prep.retries))
    differ = [k for k, g, x in zip(
        ("who", "issues", "dones", "flags", "qacc", "qthr"), got, want)
        if not torch.equal(g, x)]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)]
    flags = want[3]
    rr, rb = stack.fault_counters(want_state)
    lens = prep.lens.tolist()
    # the step at which the first host to run out took its last access
    who = want[0].tolist()
    first_out = min(max(s for s, w in enumerate(who) if w == h)
                    for h in range(len(lens)) if lens[h])
    return {"err": err, "differ": differ, "steps": len(who),
            "hits": int((flags & 1).sum()),
            "evicts": int(((flags >> 1) & 1).sum()),
            "gc_runs": stack.flash_health(want_state)[1],
            "read_retries": rr, "retired": rb, "qthr": int(want[5].sum()),
            "first_out": first_out, "in_smem": list(lay.in_smem)}


# ------------------------------------------------------------- sweeps
# (device, trace, capacity_frames, is_lru, timing overrides) of the cache
# sweep cases: Table I's 4096 frames over ~5100 of 8192 pages (past its
# frames) at capacities down to 64, under LRU and FIFO and three flash
# read times and hit latencies; per-lane traces over a 16-frame cache; a
# GC-pressured flash under NAND read retries and erase fails
SWEEP_CASES = [f"{name}{lay}" for name in ("sweep/table1", "sweep/per-lane",
                                           "sweep/nand-gc")
               for lay in ("", "/global")]
# the multi-host sweeps: host counts (with an empty lane) and fault seeds
MULTI_SWEEP_CASES = [f"{name}{lay}" for name in (
    "hosts/multihost-qos-ecmp", "hosts/multihost-ssd-mounts",
    "hosts/multi/nand-shared", "seeds/spine-leaf") for lay in ("", "/global")]


def _sweep_case(name: str):
    """``(device, addrs, writes, caps, lrus, overrides)`` of cache sweep
    case ``name``."""
    if name == "sweep/table1":
        trace = _trace(6000, 8192, 0.3, 9)
        caps = [4096, 1024, 256, 64, 4096, 1024, 4096, 4096]
        lrus = [True, True, True, True, False, False, True, True]
        read_t = make_device("cxl-ssd-cache").hil.cfg.timing.read_ticks
        over = {"read_t": [read_t] * 6 + [2 * read_t, read_t // 2],
                "hit_lat": [50_000] * 7 + [70_000]}
        return (make_device("cxl-ssd-cache"), *trace_to_arrays(trace)[:2],
                caps, lrus, over)
    if name == "sweep/per-lane":
        a = np.stack([trace_to_arrays(_trace(700, 48, 0.5, 30 + k))[0]
                      for k in range(3)])
        w = np.stack([trace_to_arrays(_trace(700, 48, 0.5, 30 + k))[1]
                      for k in range(3)])
        dev = make_device("cxl-ssd-cache", cache_cfg=DRAMCacheConfig(
            capacity_bytes=16 * 4096, mshr_entries=3, writeback_buffer=2))
        return dev, a, w, [16, 5, 16], [True, False, False], None
    assert name == "sweep/nand-gc", name
    dev, trace = fault_case("nand-gc/cxl-ssd-cache")
    return (dev, *trace_to_arrays(trace)[:2], [8, 3, 8, 1],
            [True, True, False, False], None)


def run_sweep_case(lib, name: str) -> dict:
    """The emulated sweep instance and its twin on case ``name``, each
    from fresh lanes: what differs over the outputs and every lane's
    final state tensors, and what the lanes exercised."""
    from repro_torch.core.replay.sweep import cache_lanes

    base = name.removesuffix("/global")
    dev, addrs, writes, caps, lrus, over = _sweep_case(base)
    cfg, lanes = cache_lanes(dev, addrs, writes, capacity_frames=caps,
                             is_lru=lrus, timing_overrides=over,
                             outstanding=8)
    a, w = torch.from_numpy(addrs), torch.from_numpy(writes)
    if base not in _TWIN:
        want_state = stack.init_sweep(cfg, caps)
        want = rs.replay_sweep(cfg, lanes, want_state, a, w)
        _TWIN[base] = want, want_state
    want, want_state = _TWIN[base]
    got_state = stack.init_sweep(cfg, caps)
    lay = rs.sweep_layout(cfg, lanes, H100_SMEM_OPTIN, placed=base == name)
    err, got = rs.call_launch_sweep(lib, cfg, lanes, got_state, a, w, lay,
                                    None)
    differ = [k for k, g, x in zip(
        ("issues", "dones", "flags", "qacc", "qthr"), got, want)
        if not torch.equal(g, x)]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)]
    flags = want[2]
    rr, rb = stack.fault_counters(want_state)
    return {"err": err, "differ": differ, "lanes": len(lanes),
            "hits": (flags & 1).sum(1).tolist(),
            "evicts": ((flags >> 1) & 1).sum(1).tolist(),
            "disabled_kept": bool((want_state["media"]["frames"][
                torch.arange(cfg.cache_frames)[None, :]
                >= torch.tensor(caps)[:, None]] == stack.DISABLED).all()),
            "gc_runs": stack.flash_health(want_state)[1],
            "read_retries": rr, "retired": rb,
            "in_smem": list(lay.in_smem)}


def _seed_targets(seed: int):
    """Three cached CXL-SSDs on a 2 x 2 spine-leaf with ECMP under CRC
    retries and a link down for the whole trace, the seed picking which,
    so seeds take different path sets."""
    from repro_torch.core.faults import FaultConfig, FaultPlan, install

    fab = Fabric.build("spine_leaf", num_hosts=3, num_devices=3,
                       num_leaves=2, num_spines=2, ecmp=True)
    tgts = [fab.mount(f"h{i}", f"d{i}", make_device(
        "cxl-ssd-cache", cache_cfg=DRAMCacheConfig(
            capacity_bytes=16 * 4096, mshr_entries=3, writeback_buffer=2)))
        for i in range(3)]
    down = (("s0", "sp0") if seed % 2 else ("s1", "sp1")) + (0, 1 << 20)
    install(FaultPlan(FaultConfig(link_retry_rate=0.2, link_retry_max=2,
                                  down_links=(down,)), seed=seed), tgts)
    return tgts


def _multi_sweep_inputs(name: str):
    """``(cfg, params, lens (B, H), columns, routes, retries, extra)`` of
    multi-host sweep case ``name`` (numpy; routes and retries shared or a
    row a lane)."""
    if name.startswith("hosts/"):
        scen = name.removeprefix("hosts/")
        targets, traces = _multi_case(scen)
        prep = MultiHostReplay(targets, outstanding=8,
                               torch_device="cpu").prepare(traces)
        H = prep.cfg.num_hosts
        counts = [H, 1, 0, max(1, H - 1)]
        lens = np.stack([np.where(np.arange(H) < h, prep.lens, 0)
                         for h in counts])
        return (prep, prep.params, lens, prep.routes, prep.retries,
                {"counts": counts})
    from repro_torch.core.replay.sweep import fault_lanes

    traces = [_trace(300, 48, 0.4, 60 + h) for h in range(3)]
    fl = fault_lanes(_seed_targets, traces, [0, 1, 2, 3], outstanding=8,
                     torch_device="cpu")
    rows = [int(np.unique(r).size) for r in fl.routes]
    return (fl.prep, fl.params, np.tile(fl.prep.lens, (4, 1)), fl.routes,
            fl.retries, {"union_rows": int(fl.params["path_port"].shape[0]),
                         "lane_rows": rows})


def run_multi_sweep_case(lib, name: str) -> dict:
    """The emulated multi-host sweep instance and its twin on case
    ``name``, each from fresh lanes: what differs over the outputs and
    every lane's final state tensors, and what the lanes exercised."""
    base = name.removesuffix("/global")
    prep, params, lens, routes, retries, extra = _multi_sweep_inputs(base)
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(
            x))

    ins = (t(prep.addrs), t(prep.writes), t(lens), t(prep.devs), t(routes))
    B = lens.shape[0]
    key = ("multi", base)
    if key not in _TWIN:
        want_state = stack.init_multi_sweep(cfg.stack, B, cfg.num_devs,
                                            cfg.n_flash)
        want = rs.replay_multi_sweep(cfg, params, want_state, *ins,
                                     retries=t(retries))
        _TWIN[key] = want, want_state
    want, want_state = _TWIN[key]
    got_state = stack.init_multi_sweep(cfg.stack, B, cfg.num_devs,
                                       cfg.n_flash)
    lay = rs.layout_multi(cfg, params, H100_SMEM_OPTIN, placed=base == name)
    err, got = rs.call_launch_multi_sweep(lib, cfg, params, got_state, *ins,
                                          lay, None, retries=t(retries))
    differ = [k for k, g, x in zip(
        ("who", "issues", "dones", "flags", "qacc", "qthr"), got, want)
        if not torch.equal(g, x)]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (want_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)]
    # each lane against its own one-call replay (the twin of replay_multi)
    alone = []
    for k in range(B):
        n = int(lens[k].sum())
        if not n:
            alone.append(bool((want[0][k] == 0).all()))
            continue
        st = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash)
        one = rs.replay_multi(
            cfg, params, st, ins[0], ins[1], ins[2][k], ins[3],
            None if routes is None else (ins[4] if routes.ndim == 2
                                         else ins[4][k]),
            retries=None if retries is None else (
                t(retries) if retries.ndim == 3 else t(retries)[k]))
        alone.append(all(torch.equal(want[j][k][:n], one[j])
                         for j in range(4)))
    return {"err": err, "differ": differ, "lanes": B, "alone": alone,
            "steps": lens.sum(1).tolist(),
            "gc_runs": stack.flash_health(want_state)[1],
            "read_retries": stack.fault_counters(want_state)[0],
            "qthr": int(want[5].sum()), "in_smem": list(lay.in_smem),
            **extra}


# ------------------------------------------------------ the sharded instance
# (case, shards): multi-pod DRAM mounts at every portable cluster size, then
# the media, QoS and faults the sharded lane certifies, in both layouts
SHARDED = [("shard/multipod-8", d) for d in (1, 2, 4, 8)] + [
    ("shard/qos-8", 4), ("shard/pmem-4", 2), ("shard/cxl-ssd-cache-4", 2),
    ("shard/cxl-ssd-cache-4", 4), ("shard/nand-2", 2),
    ("shard/transport-4", 4), ("faults-linkretry@spine_leaf_x4", 2),
    ("fleet-zipf@multipod_2x4", 8)]
SHARDED_CASES = [f"{name}{lay}@{d}" for name, d in SHARDED
                 for lay in ("", "/global")]


def run_sharded_case(lib, case: str) -> dict:
    """The emulated sharded instance, its twin and the one-CTA twin on
    ``case`` (``name[/global]@shards``), each from fresh lanes: the
    outputs and state tensors that differ, and what the case exercised."""
    name, shards = case.rsplit("@", 1)
    shards = int(shards)
    base = name.removesuffix("/global")
    targets, traces = shard_case(base)
    prep = MultiHostReplay(targets, outstanding=8, metrics=MetricsSpec(),
                           torch_device="cpu").prepare(traces)
    cfg = prep.cfg

    def t(x):
        return None if x is None else torch.from_numpy(x)

    ins = [t(x) for x in (prep.addrs, prep.writes, prep.lens, prep.devs,
                          prep.routes)]
    one_state, twin_state, got_state = (
        stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cpu")
        for _ in range(3))
    one = rs.replay_multi_plain(cfg, prep.params, one_state, *ins,
                                retries=t(prep.retries))
    twin = rs.replay_sharded_plain(cfg, shards, prep.params, twin_state,
                                   *ins, retries=t(prep.retries))
    lay = rs.layout_multi(cfg, prep.params, H100_SMEM_OPTIN,
                          placed=base == name, shards=shards)
    err, got = rs.call_launch_sharded(lib, cfg, shards, prep.params,
                                      got_state, *ins, 0, lay, None,
                                      retries=t(prep.retries))
    names = ("who", "issues", "dones", "flags", "qacc", "qthr")
    differ = [f"{who}.{k}" for who, outs in (("kernel", got),
                                             ("twin", twin))
              for k, g, x in zip(names, outs, one) if not torch.equal(g, x)]
    for part in ("media", "flash"):
        differ += [f"{part}.{k}" for k, x in (one_state[part] or {}).items()
                   if not torch.equal(got_state[part][k], x)
                   or not torch.equal(twin_state[part][k], x)]
    rr, _ = stack.fault_counters(one_state)
    return {"err": err, "differ": differ, "steps": int(one[0].numel()),
            "hits": int((one[3] & 1).sum()), "qthr": int(one[5].sum()),
            "read_retries": rr, "in_smem": list(lay.in_smem),
            "hosts": cfg.num_hosts, "faulted": bool(cfg.fault_hops)}


def _child(lib_path: str, out_path: str) -> None:
    lib = ctypes.CDLL(lib_path)
    for fn in ("replay_scan_launch", "replay_scan_launch_multi",
               "replay_scan_launch_sweep", "replay_scan_launch_multi_sweep",
               "replay_scan_launch_sharded",
               "replay_scan_num_args", "replay_scan_layout_words",
               "replay_scan_num_margs", "replay_scan_layout_multi_words",
               "replay_scan_num_ptrs"):
        restype, argtypes = _build.SIGNATURES["replay_scan"][fn]
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    out = {"num_args": lib.replay_scan_num_args(), "args": len(rs.ARGS),
           "num_ptrs": [lib.replay_scan_num_ptrs(), len(rs.SWEEP_PTRS),
                        len(rs.MULTI_SWEEP_PTRS)],
           "sweeps": {name: run_sweep_case(lib, name)
                      for name in SWEEP_CASES},
           "multi_sweeps": {name: run_multi_sweep_case(lib, name)
                            for name in MULTI_SWEEP_CASES},
           "sharded": {name: run_sharded_case(lib, name)
                       for name in SHARDED_CASES},
           "num_margs": lib.replay_scan_num_margs(), "margs": len(rs.MARGS),
           "layout_multi": [lib.replay_scan_layout_multi_words(),
                            len(rs.LAYOUT_MULTI)],
           "cases": {name: run_case(lib, name) for name in CASES},
           "multi": {name: run_multi_case(lib, name)
                     for name in MULTI_CASES},
           "resumed": {f"{name}@{c}": run_resumed_case(lib, name, c)
                       for name in RESUMED_CASES
                       for c in RESUMED[name.removesuffix("/global")]},
           "multi_resumed": {
               f"{name}@{c}": run_multi_resumed_case(lib, name, c)
               for name in MULTI_RESUMED_CASES
               for c in MULTI_RESUMED[name.removesuffix("/global")]}}
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The cases' results, from the ASan build run in one child."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    tmp = tmp_path_factory.mktemp("replay_scan_emulate")
    lib = tmp / "libreplay_scan_emulate.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-g", "-fsanitize=address",
                    "-fno-omit-frame-pointer", "-shared", "-fPIC", "-pthread",
                    f"-I{CSRC}", str(SHIM), "-o", str(lib)],
                   check=True, capture_output=True, text=True, timeout=300)
    asan = subprocess.run([cxx, "-print-file-name=libasan.so"], check=True,
                          capture_output=True, text=True).stdout.strip()
    env = dict(os.environ, LD_PRELOAD=asan, ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    out = tmp / "cases.json"
    proc = subprocess.run([sys.executable, __file__, str(lib), str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return json.loads(out.read_text())


def test_the_emulation_takes_the_wrappers_argument_block(emulated):
    assert emulated["num_args"] == emulated["args"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_source_equals_its_twin(emulated, name):
    got = emulated["cases"][name]
    assert got["err"] == 0
    assert got["differ"] == [], f"{name}: {got['differ']} differ"


def test_table1_case_fills_and_evicts(emulated):
    churn = emulated["cases"]["table1/churn"]
    assert churn["hits"] > 0 and churn["evicts"] > 0, churn


@pytest.mark.parametrize("name", ["table1/16461", "table1-fifo/8000",
                                  "table1-direct/8000", "ring/cxl-ssd-cache"])
def test_chunked_and_policy_cases_fill_and_evict(emulated, name):
    got = emulated["cases"][name]
    assert got["hits"] > 0 and got["evicts"] > 0, got


# what each faulted case must exercise: (NAND read retries, retired
# blocks, link retries, failovers, QoS throttles) that must be nonzero
EXERCISES = {"faults-linkretry@spine_leaf": ("link_retries",),
             "faults-portdown-failover@mesh": ("failovers",),
             "faults-nand-retry@direct": ("read_retries", "retired"),
             "nand-gc/cxl-ssd-cache": ("read_retries",),
             "nand-gc/cxl-ssd": ("read_retries", "retired"),
             "link/cxl-dram": ("link_retries",),
             "down-ecmp/dram": ("link_retries", "failovers"),
             "qos-retry/cxl-ssd-cache": ("link_retries", "failovers",
                                         "qthr"),
             "qos-retry-fixed/pmem": ("link_retries", "qthr")}


@pytest.mark.parametrize("name", FAULTED)
def test_faulted_cases_exercise_their_faults(emulated, name):
    got = emulated["cases"][name]
    base = name.removesuffix("/global")
    assert all(got[k] > 0 for k in EXERCISES[base]), got
    # the device-memory layout keeps no placed array in shared memory
    if name.endswith("/global"):
        assert got["in_smem"] == [], got


def test_the_emulation_takes_the_multi_host_blocks(emulated):
    assert emulated["num_margs"] == emulated["margs"]
    assert emulated["layout_multi"][0] == emulated["layout_multi"][1]


@pytest.mark.parametrize("name", MULTI_CASES)
def test_multi_host_instance_equals_its_twin(emulated, name):
    got = emulated["multi"][name]
    assert got["err"] == 0
    assert got["differ"] == [], f"{name}: {got['differ']} differ"
    # the device-memory layout keeps no placed array in shared memory
    if name.endswith("/global"):
        assert got["in_smem"] == [], got


# what each multi-host case must exercise
MULTI_EXERCISES = {"multihost-qos-ecmp": ("qthr",),
                   "multihost-ssd-mounts": ("hits", "evicts"),
                   "multihost-ssd-pool": ("hits",),
                   "multihost-ssd-sharedflash": ("gc_runs",),
                   "multi/nand-shared": ("gc_runs", "read_retries",
                                         "retired"),
                   "multi/cxl-ssd": ("hits",), "multi/pmem": ("hits",)}


@pytest.mark.parametrize("name", sorted(MULTI_EXERCISES))
def test_multi_host_cases_exercise_their_paths(emulated, name):
    got = emulated["multi"][name]
    assert all(got[k] > 0 for k in MULTI_EXERCISES[name]), got


def test_multi_host_case_runs_one_host_out_early(emulated):
    got = emulated["multi"]["multi/exhaust"]
    # host 0's 20 accesses end in the first tenth of the 720 steps
    assert got["first_out"] < got["steps"] // 10, got


@pytest.mark.parametrize("name", RESUMED_CASES)
def test_resumed_launches_equal_one_launch_and_the_twin(emulated, name):
    for schedule in RESUMED[name.removesuffix("/global")]:
        got = emulated["resumed"][f"{name}@{schedule}"]
        assert got["err"] == 0
        assert got["differ"] == [], f"{name} @ {schedule}: {got['differ']}"
        assert got["launches"] == len(schedule_spans(schedule,
                                                     got["accesses"]))
        assert got["seen"] == got["accesses"]


@pytest.mark.parametrize("name", MULTI_RESUMED_CASES)
def test_resumed_multi_host_launches_equal_one_launch(emulated, name):
    for schedule in MULTI_RESUMED[name.removesuffix("/global")]:
        got = emulated["multi_resumed"][f"{name}@{schedule}"]
        assert got["err"] == 0
        assert got["differ"] == [], f"{name} @ {schedule}: {got['differ']}"
        assert got["launches"] == len(schedule_spans(schedule,
                                                     got["steps"]))


def test_the_emulation_takes_the_sweeps_pointers(emulated):
    got, single, multi = emulated["num_ptrs"]
    assert got == single == multi


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_instance_equals_its_twin(emulated, name):
    got = emulated["sweeps"][name]
    assert got["err"] == 0
    assert got["differ"] == [], f"{name}: {got['differ']} differ"
    # a capacity lane's disabled frames stay disabled
    assert got["disabled_kept"], got
    if name.endswith("/global"):
        assert got["in_smem"] == [], got


def test_sweep_cases_exercise_their_lanes(emulated):
    table1 = emulated["sweeps"]["sweep/table1"]
    # every lane fills and evicts; smaller caches hit less
    assert all(e > 0 for e in table1["evicts"]), table1
    assert table1["hits"][0] > table1["hits"][1] > table1["hits"][2] \
        > table1["hits"][3], table1
    # LRU and FIFO lanes of one capacity part ways
    assert table1["evicts"][0] != table1["evicts"][4], table1
    nand = emulated["sweeps"]["sweep/nand-gc"]
    assert nand["gc_runs"] > 0 and nand["read_retries"] > 0 \
        and nand["retired"] > 0, nand


@pytest.mark.parametrize("name", MULTI_SWEEP_CASES)
def test_multi_sweep_instance_equals_its_twin(emulated, name):
    got = emulated["multi_sweeps"][name]
    assert got["err"] == 0
    assert got["differ"] == [], f"{name}: {got['differ']} differ"
    assert all(got["alone"]), got
    if name.endswith("/global"):
        assert got["in_smem"] == [], got


def test_multi_sweep_cases_exercise_their_lanes(emulated):
    qos = emulated["multi_sweeps"]["hosts/multihost-qos-ecmp"]
    assert qos["qthr"] > 0 and 0 in qos["steps"], qos
    nand = emulated["multi_sweeps"]["hosts/multi/nand-shared"]
    assert nand["gc_runs"] > 0 and nand["read_retries"] > 0, nand
    seeds = emulated["multi_sweeps"]["seeds/spine-leaf"]
    # the seeds' path sets differ: the union table holds more paths than
    # any one lane takes
    assert seeds["union_rows"] > max(seeds["lane_rows"]), seeds


@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_instance_equals_its_twins(emulated, name):
    got = emulated["sharded"][name]
    assert got["err"] == 0
    assert got["differ"] == [], f"{name}: {got['differ']} differ"
    if "/global@" in name:
        assert got["in_smem"] == [], got


def test_sharded_cases_exercise_their_paths(emulated):
    got = emulated["sharded"]
    assert got["shard/qos-8@4"]["qthr"] > 0
    assert got["shard/cxl-ssd-cache-4@4"]["hits"] > 0
    assert got["shard/cxl-ssd-cache-4@4"]["in_smem"], got
    assert got["shard/nand-2@2"]["read_retries"] > 0
    assert got["shard/transport-4@4"]["faulted"]
    assert got["faults-linkretry@spine_leaf_x4@2"]["faulted"]
    assert got["fleet-zipf@multipod_2x4@8"]["steps"] == 8 * 160


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
