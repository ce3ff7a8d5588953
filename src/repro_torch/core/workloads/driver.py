"""Trace drivers: CPU issue models with bounded outstanding requests.

:class:`TraceDriver` models one core's load/store unit: ``outstanding``
line-fill-buffer slots.  Dependent chains (membench pointer chasing) use
``outstanding=1``; streaming kernels use the full LFB depth so bandwidth
saturates by Little's law.

:class:`MultiHostDriver` interleaves N such hosts onto *shared* targets
(fabric-attached devices or pool views): accesses are issued in global
issue-time order with deterministic host-index tie-breaking, so contention
on shared switch ports and device media emerges from the targets'
busy-until state rather than from run ordering.

The python lane is plain Python and uses no torch; the kernel lane
(``engine="cuda"``) loads :mod:`repro_torch.core.replay.cuda_engine` only
when it runs.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

from repro_torch.core.devices import MemDevice
from repro_torch.core.engine import ns, to_ns, to_s

Access = Tuple[int, int, bool]  # (addr, size, write)


@dataclass
class TraceResult:
    accesses: int
    bytes_moved: int
    elapsed_ticks: int
    sum_latency_ticks: int
    end_tick: int = 0      # absolute completion tick (chain multi-pass runs)
    # telemetry bundle of the metrics slice; None until that slice lands
    metrics: object = None

    @property
    def elapsed_s(self) -> float:
        return to_s(self.elapsed_ticks)

    @property
    def avg_latency_ns(self) -> float:
        return to_ns(self.sum_latency_ticks) / self.accesses if self.accesses else 0.0

    @property
    def bandwidth_gbps(self) -> float:
        return self.bytes_moved / self.elapsed_s / 1e9 if self.elapsed_ticks else 0.0


# "pallas" is the JAX package's name for the kernel lane; it is accepted
# here so code and golden lane names written for that package line up.
ENGINES = ("python", "scan", "assoc", "cuda", "pallas")
_NOT_PORTED = {
    "scan": "the fused scan lane is not ported yet (ROADMAP Queue A item 5)",
    "assoc": "the associative lane is not ported yet (ROADMAP Queue A item 6)",
}


class TraceDriver:
    """``outstanding≈32`` models LFBs + hardware prefetch streams; real cores
    need ~latency/occupancy (~24 for DDR4) in flight to reach media bandwidth.

    ``engine`` selects the replay backend:

    ``python``   interpret every access through the device objects (the
                 reference semantics; always available, no torch);
    ``cuda``     the fused cache+latency CUDA kernel for the cached
                 CXL-SSD, bare or fabric-mounted (the model has no
                 fabric hops) — bit-identical hit/evict decisions, analytic
                 closed-loop latency (see
                 :mod:`repro_torch.core.replay.cuda_engine`); ``"pallas"``
                 is an alias.  Runs on ``torch_device`` (the card by
                 default; ``"cpu"`` runs the kernel's plain version).

    ``scan`` and ``assoc`` raise :class:`NotImplementedError` until their
    slices are ported.
    """

    def __init__(self, device: MemDevice, outstanding: int = 32,
                 issue_overhead_ns: float = 0.5, posted_writes: bool = True,
                 engine: str = "python", block_size: int = 1,
                 metrics=None, torch_device="cuda") -> None:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
        if engine in _NOT_PORTED:
            raise NotImplementedError(
                f"engine={engine!r}: {_NOT_PORTED[engine]}; use "
                "engine='python' or engine='cuda'")
        from repro_torch.core.replay.spec import (require_metrics_lane,
                                                  validate_block_size)

        self.device = device
        self.outstanding = max(1, outstanding)
        self.issue_overhead_ns = issue_overhead_ns
        self.posted_writes = posted_writes
        self.engine = "cuda" if engine == "pallas" else engine
        self.block_size = validate_block_size(block_size)
        self.torch_device = torch_device
        self.metrics = metrics
        if metrics is not None:
            # the kernel lane has no carry slot for the accumulators: refuse
            # up front rather than returning metric-less results
            require_metrics_lane(self.engine)
            raise NotImplementedError(
                "metrics collection is not ported yet (ROADMAP Queue A "
                "item 7)")
        if self.block_size > 1:
            # blocking shapes the sequential scan's lowering only; accepting
            # it elsewhere would silently run identical replays
            raise ValueError(
                f"block_size applies to engine='scan', not {engine!r}")

    def run(self, trace: Iterable[Access], start_tick: int = 0) -> TraceResult:
        rows = list(trace) if self.engine != "python" else trace
        if self.engine != "python" and rows:
            return self._run_fast(rows, start_tick)
        # One-host case of the interleaved driver: a single shared issue
        # model keeps the two from drifting.
        multi = MultiHostDriver([self.device], outstanding=self.outstanding,
                                issue_overhead_ns=self.issue_overhead_ns,
                                posted_writes=self.posted_writes)
        return multi.run([rows], start_tick=start_tick).per_host[0]

    def _run_fast(self, rows, start_tick: int) -> TraceResult:
        from repro_torch.core.replay.cuda_engine import run_cuda
        from repro_torch.core.replay.spec import trace_to_arrays

        addrs, writes, size = trace_to_arrays(rows)
        return run_cuda(self.device, addrs, writes, size=size,
                        outstanding=self.outstanding,
                        issue_overhead_ns=self.issue_overhead_ns,
                        start_tick=start_tick, torch_device=self.torch_device)


# ----------------------------------------------------------- multi-host
@dataclass
class MultiHostResult:
    """Per-host :class:`TraceResult`\\ s plus cluster-level aggregates."""

    per_host: List[TraceResult]
    elapsed_ticks: int      # global span: first issue to last completion

    @property
    def num_hosts(self) -> int:
        return len(self.per_host)

    @property
    def total_bytes(self) -> int:
        return sum(r.bytes_moved for r in self.per_host)

    @property
    def aggregate_bandwidth_gbps(self) -> float:
        sec = to_s(self.elapsed_ticks)
        return self.total_bytes / sec / 1e9 if sec else 0.0

    @property
    def per_host_bandwidth_gbps(self) -> List[float]:
        """Each host's bytes over the *global* span — the fair-share number a
        tenant actually experiences while the others are active."""
        sec = to_s(self.elapsed_ticks)
        return [r.bytes_moved / sec / 1e9 if sec else 0.0
                for r in self.per_host]

    @property
    def min_host_bandwidth_gbps(self) -> float:
        return min(self.per_host_bandwidth_gbps) if self.per_host else 0.0


class _HostState:
    """Issue-side state of one host inside the interleaved replay."""

    __slots__ = ("target", "slots", "now", "trace", "pending", "n", "bytes",
                 "sum_lat", "first_issue", "last_done")

    def __init__(self, target: MemDevice, outstanding: int, start_tick: int,
                 trace: Iterable[Access]) -> None:
        self.target = target
        self.slots = [start_tick] * outstanding
        heapq.heapify(self.slots)
        self.now = start_tick
        self.trace = iter(trace)
        self.pending = next(self.trace, None)
        self.n = 0
        self.bytes = 0
        self.sum_lat = 0
        self.first_issue: int | None = None
        self.last_done = start_tick

    def next_issue_tick(self) -> int:
        return max(self.now, self.slots[0])


class MultiHostDriver:
    """Replay one trace per host against shared targets, interleaved.

    Each host keeps its own LFB slots and issue clock (exactly
    :class:`TraceDriver` semantics); globally, the host with the earliest
    next issue tick goes first (ties break on host index).  Running host
    traces back-to-back instead would serialize them through the shared
    busy-until state and hide all contention — the interleave is the point.
    Only the python lane exists in this slice.
    """

    def __init__(self, targets: Sequence[MemDevice], outstanding: int = 32,
                 issue_overhead_ns: float = 0.5,
                 posted_writes: bool = True, engine: str = "python",
                 block_size: int = 1, metrics=None) -> None:
        if not targets:
            raise ValueError("need at least one host target")
        if engine == "scan":
            raise NotImplementedError(
                "multi-host engine='scan' is not ported yet (ROADMAP Queue A "
                "item 10); use engine='python'")
        if engine != "python":
            raise ValueError(f"multi-host engine must be python|scan, "
                             f"got {engine!r}")
        from repro_torch.core.replay.spec import validate_block_size

        self.targets = list(targets)
        self.outstanding = max(1, outstanding)
        self.issue_overhead_ns = issue_overhead_ns
        self.posted_writes = posted_writes
        self.engine = engine
        self.block_size = validate_block_size(block_size)
        self.metrics = metrics
        if metrics is not None:
            raise NotImplementedError(
                "metrics collection is not ported yet (ROADMAP Queue A "
                "item 7)")
        if self.block_size > 1:
            raise ValueError(
                f"block_size applies to engine='scan', not {engine!r}")

    def run(self, traces: Sequence[Iterable[Access]],
            start_tick: int = 0) -> MultiHostResult:
        if len(traces) != len(self.targets):
            raise ValueError(f"{len(traces)} traces for "
                             f"{len(self.targets)} host targets")
        issue_ov = ns(self.issue_overhead_ns)
        hosts = [_HostState(t, self.outstanding, start_tick, tr)
                 for t, tr in zip(self.targets, traces)]

        # Global issue queue: (candidate issue tick, host index), one entry
        # per host with a pending access.  A host's candidate tick depends
        # only on its own slots/clock — other hosts move shared busy-until
        # state inside the targets, never this heap — so entries are always
        # current and ties resolve on host index, deterministically.
        ready = [(h.next_issue_tick(), i) for i, h in enumerate(hosts)
                 if h.pending is not None]
        heapq.heapify(ready)
        while ready:
            _, i = heapq.heappop(ready)
            h = hosts[i]
            addr, size, write = h.pending
            slot_free = heapq.heappop(h.slots)
            issue = max(h.now, slot_free)
            if h.first_issue is None:
                h.first_issue = issue
            done = h.target.service(issue, addr, size, write,
                                    posted=write and self.posted_writes)
            heapq.heappush(h.slots, done)
            h.sum_lat += done - issue
            h.last_done = max(h.last_done, done)
            h.now = issue + issue_ov
            h.n += 1
            h.bytes += size
            h.pending = next(h.trace, None)
            if h.pending is not None:
                heapq.heappush(ready, (h.next_issue_tick(), i))

        first = min((h.first_issue for h in hosts
                     if h.first_issue is not None), default=start_tick)
        last = max(h.last_done for h in hosts)
        per_host = [TraceResult(accesses=h.n, bytes_moved=h.bytes,
                                elapsed_ticks=(h.last_done - h.first_issue
                                               if h.first_issue is not None else 0),
                                sum_latency_ticks=h.sum_lat,
                                end_tick=h.last_done)
                    for h in hosts]
        return MultiHostResult(per_host=per_host, elapsed_ticks=last - first)
