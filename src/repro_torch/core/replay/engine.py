"""Fused device-stack trace replay: the scan lane (``engine="scan"``).

One step per trace access, end to end: LFB slot recycling (the driver's
bounded-outstanding issue model), link/fabric transport with per-port
busy-until occupancy, then the device media — DRAM timing, PMEM
row-buffer, the CXL-SSD page-register buffer, or the full DRAM-cache layer
(fully-associative LRU/FIFO or direct-mapped frames, MSHR coalescing and
stalls, bounded writeback buffer) backed by the HIL/FTL/PAL flash model
(log-append allocation with greedy garbage collection when the trace can
outrun the headroom, per-die array occupancy with program suspend,
per-channel bus occupancy).

On the card the whole replay is one launch of the ``replay_scan`` kernel
(:mod:`repro_torch.kernels.replay_scan`); on the CPU
(``torch_device="cpu"``) its plain twin runs the state layer
:mod:`repro_torch.core.replay.stack` one access at a time.  Both mirror the
interpreted path *operation for operation* — every ``max(now,
busy_until)``, every separately-rounded ``ns()`` constant — so the replay
is **tick-identical** to
:meth:`repro_torch.core.workloads.driver.TraceDriver.run` over the same
device and to the JAX package's ``ReplayEngine``.  Scope cuts are checked
on the host before the replay (one 64 B line per access, packed-field
ranges); a GC free-pool underrun, where the interpreted FTL raises "out of
space", surfaces as :class:`ReplayUnsupported` through the stack's sticky
``bad`` flag — refuse, never drift.

Cut from this lane, each refused with :class:`ReplayUnsupported`: an
active fault plan (transport fault hops and NAND fault statics, ROADMAP
Queue A item 5b), and streaming (``chunk_size``,
``return_latencies=False``, item 12).

Ticks are int64 (1 tick = 1 ps); int32 would overflow after 2.1 ms of
simulated time.  Nothing here imports torch until a replay runs, so the
python lane stays torch-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.replay.spec import (
    MAX_ACCESSES,
    ReplayUnsupported,
    access_route_choices,
    build_stack,
    trace_to_arrays,
    validate_block_size,
)
from repro_torch.core.workloads.driver import TraceResult


@dataclass
class ReplayResult(TraceResult):
    """A :class:`TraceResult` plus the per-access arrays the fused lane
    produces for free (numpy, on the host).  The poison flags and the
    availability series of the JAX package's result come with its faulted
    lane (ROADMAP Queue A item 5b)."""

    latency_ticks: Optional[np.ndarray] = None   # done - issue, per access
    hit_flags: Optional[np.ndarray] = None
    evict_flags: Optional[np.ndarray] = None
    gc_runs: int = 0                             # flash GC collections run

    @property
    def hits(self) -> int:
        return int(self.hit_flags.sum()) if self.hit_flags is not None else 0


class ReplayEngine:
    """Fused stand-in for :class:`TraceDriver` (one host).

    ``run`` is tick-identical to ``TraceDriver(device, ...).run`` for the
    supported stacks (all five paper devices, directly attached or mounted
    behind a switch fabric on a fixed route or under ECMP, with or without
    QoS; cache policies lru/fifo/direct; FTL greedy GC included).
    Unsupported shapes raise :class:`ReplayUnsupported`.  ``block_size``
    is validated and otherwise tick-invisible: the kernel ignores it.
    ``metrics`` (a :class:`~repro_torch.core.replay.metrics.MetricsSpec`)
    attaches the metrics bundle to the result.  The replay runs on
    ``torch_device``: the card by default, ``"cpu"`` for the plain twin.
    """

    def __init__(self, device, outstanding: int = 32,
                 issue_overhead_ns: float = 0.5,
                 posted_writes: bool = True, block_size: int = 1,
                 metrics=None, torch_device="cuda") -> None:
        self.device = device
        self.outstanding = max(1, outstanding)
        self.issue_overhead_ns = issue_overhead_ns
        self.posted_writes = posted_writes
        self.block_size = validate_block_size(block_size)
        self.metrics = metrics        # Optional[MetricsSpec]
        self.torch_device = torch_device

    def run(self, trace, start_tick: int = 0,
            return_latencies: bool = True,
            chunk_size: Optional[int] = None) -> ReplayResult:
        addrs, writes, size = trace_to_arrays(trace)
        return self.run_arrays(addrs, writes, size=size,
                               start_tick=start_tick,
                               return_latencies=return_latencies,
                               chunk_size=chunk_size)

    # shared refusals of every entry point
    def _common_refusals(self, n: int, start_tick: int):
        if n == 0:
            raise ReplayUnsupported("empty trace")
        if n > MAX_ACCESSES:
            raise ReplayUnsupported(
                f"trace longer than {MAX_ACCESSES} accesses (packed-stamp "
                "budget); split the trace or use engine='python'")
        if start_tick < 0 and getattr(getattr(self.device, "fabric", None),
                                      "qos_enabled", False):
            # with start_tick >= 0 a lone origin's QoS floor provably never
            # binds (see spec._fabric_hops); negative ticks void the proof
            raise ReplayUnsupported(
                "QoS replay needs start_tick >= 0; use engine='python'")

    def _active_plan(self):
        # active fault plan discovery: install() sets it on the mount (and
        # on the shared fabric); direct devices carry it themselves
        plan = getattr(self.device, "fault_plan", None)
        if plan is None:
            plan = getattr(getattr(self.device, "fabric", None),
                           "fault_plan", None)
        if plan is not None and not plan.active:
            plan = None
        return plan

    def run_arrays(self, addrs: np.ndarray, writes: np.ndarray, *,
                   size: int = 64, start_tick: int = 0,
                   return_latencies: bool = True,
                   chunk_size: Optional[int] = None) -> ReplayResult:
        import torch

        from repro_torch import torch_device as _td
        from repro_torch.core.replay import stack
        from repro_torch.kernels.replay_scan import replay_scan

        addrs = np.asarray(addrs, np.int64)
        writes = np.asarray(writes, bool)
        self._common_refusals(int(addrs.size), start_tick)
        if chunk_size is not None and int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size!r}")
        cfg, params = build_stack(
            self.device, size=size, outstanding=self.outstanding,
            issue_overhead_ns=self.issue_overhead_ns,
            posted_writes=self.posted_writes, n_accesses=addrs.size,
            max_addr=int(addrs.max(initial=0)),
            counters=self.metrics is not None)
        if chunk_size is not None or not return_latencies:
            raise ReplayUnsupported(
                "streaming replay (chunk_size=, return_latencies=False) is "
                "not ported yet (ROADMAP Queue A item 12); use "
                "engine='python' or replay the whole trace")
        plan = self._active_plan()
        if plan is not None or cfg.faults:
            names = ", ".join(plan.class_names()) if plan else "nand"
            raise ReplayUnsupported(
                f"active fault plan ({names}): the faulted scan lane is not "
                "ported yet (ROADMAP Queue A item 5b); use engine='python'")
        dev = _td.resolve(self.torch_device)
        routes = None
        if cfg.num_routes > 1:
            routes = access_route_choices(self.device, addrs)
        state = stack.init_state(cfg, dev)
        issues, dones, flags, qacc, qthr = replay_scan(
            cfg, params, state, torch.from_numpy(addrs).to(dev),
            torch.from_numpy(writes).to(dev),
            None if routes is None else torch.from_numpy(
                routes.astype(np.int32)).to(dev),
            start_tick=start_tick)
        return self._finish(cfg, state, size=size, start_tick=start_tick,
                            issues=issues.cpu().numpy(),
                            dones=dones.cpu().numpy(),
                            flags=flags.cpu().numpy(),
                            qacc=qacc.cpu().numpy(), qthr=qthr.cpu().numpy(),
                            writes=writes, routes=routes)

    # post-processing: health check, metrics bundle, result assembly
    def _finish(self, cfg, state, *, size, start_tick, issues, dones, flags,
                qacc, qthr, writes, routes):
        from repro_torch.core.replay import stack

        bad, gcs = stack.flash_health(state)
        mb = None
        if self.metrics is None:
            flags = flags & 3            # event bits ride only with metrics
        else:
            from repro_torch.core.replay import metrics as _metrics
            mb = _metrics.bundle_single_deferred(
                self.metrics, self.device, cfg, issues, dones, flags,
                writes, qacc, stack.flash_counters(state), routes, size,
                qthr=qthr)
        if bad:
            raise ReplayUnsupported(
                "FTL ran out of free blocks during GC (device overfilled) — "
                "the interpreted path raises there too; shrink the trace or "
                "use engine='python' for the exact error")
        n = int(issues.size)
        first = int(issues[0])
        last = max(int(dones.max(initial=0)), start_tick)
        return ReplayResult(
            accesses=n,
            bytes_moved=n * size,
            elapsed_ticks=last - first,
            sum_latency_ticks=int((dones - issues).sum()),
            end_tick=last,
            latency_ticks=dones - issues,
            hit_flags=(flags & 1).astype(bool),
            evict_flags=(flags & 2).astype(bool),
            gc_runs=gcs,
            metrics=mb,
        )
