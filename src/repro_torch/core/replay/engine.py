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

Under an active :class:`~repro_torch.core.faults.FaultPlan` the same
launch replays every fault class: NAND read retries and erase-fail block
retirement from the plan's statics (in the kernel's flash state); link
CRC retries and down-port failover from a path table and a compact
per-access code (a path id and one retry byte a hop) that
:class:`_FaultColumnBuilder` computes on the host through the same route
selection the python driver uses; poison as bit 6 of the flags, from
:meth:`FaultPlan.poisoned_np`.  The result then carries the fault
counters (in the metrics bundle), the per-access poison flags and, under
transport faults, the availability series.

Cut from this lane, refused with :class:`ReplayUnsupported`: streaming
(``chunk_size``, ``return_latencies=False``, ROADMAP Queue A item 12).

Ticks are int64 (1 tick = 1 ps); int32 would overflow after 2.1 ms of
simulated time.  Nothing here imports torch until a replay runs, so the
python lane stays torch-free.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fabric.fabric import FabricAttachedDevice
from repro_torch.core.replay.spec import (
    MAX_ACCESSES,
    ReplayUnsupported,
    _link_hops,
    access_route_choices,
    build_stack,
    trace_to_arrays,
    validate_block_size,
)
from repro_torch.core.workloads.driver import TraceResult

POISON_BIT = 6      # the flags' poison status bit (a read of a poisoned line)
MAX_RETRY_CODE = 255    # link retries a hop, as one byte of the code


@dataclass
class ReplayResult(TraceResult):
    """A :class:`TraceResult` plus the per-access arrays the fused lane
    produces for free (numpy, on the host)."""

    latency_ticks: Optional[np.ndarray] = None   # done - issue, per access
    hit_flags: Optional[np.ndarray] = None
    evict_flags: Optional[np.ndarray] = None
    gc_runs: int = 0                             # flash GC collections run
    # per-access poison status (bit 6 of the flags word) when an active
    # fault plan schedules poison; None otherwise.  Status only — a
    # poisoned read never fabricates latency.
    poison_flags: Optional[np.ndarray] = None
    # tick-windowed availability series + degraded-mode summary
    # (metrics.availability_series) when a transport fault plan is active.
    # Host-side observability only — outside the python-parity
    # MetricsBundle schema.
    availability: Optional[Dict] = None

    @property
    def hits(self) -> int:
        return int(self.hit_flags.sum()) if self.hit_flags is not None else 0


# ---------------------------------------------------------- fault columns
class _FaultColumnBuilder:
    """Per-access transport hops of a fabric mount under an active
    link-retry / down-window plan.

    Every access ordinal walks the *same* pure route selection the
    interpreted path uses (:meth:`Fabric.select_faulted` — degraded-set
    masking, ECMP over survivors, recomputed fallback routes) and the same
    per-hop occupancy rule (:meth:`Fabric.path_occupancy`), drawing the
    CRC-retry count of each hop from :meth:`FaultPlan.link_retries`.
    Raises :class:`~repro_torch.core.faults.DeviceUnreachable` for the
    same accesses the python driver would — at construction, since the
    plan's down segments already determine which route sets go empty.

    The static shapes — the port union and the hop width ``num_hops`` —
    come from the plan's :meth:`~FaultPlan.down_segments` alone.

    :meth:`columns` returns the compact code the kernel takes: beside
    :meth:`path_table` (each path's port indices, -1 on the hops it does
    not have, occupancy and extra, with a CXL-DRAM's private hop at the
    last column), per access the path id and one retry count a hop;
    :func:`expand_fault_codes` turns it into the JAX package's five hop
    columns."""

    def __init__(self, device, plan, size: int, n: int) -> None:
        from repro_torch.core.devices import CXLDRAMDevice

        self.fab = device.fabric
        self.plan = plan
        self.host, self.node = device.host, device.device_node
        self.size = int(size)
        self.n = int(n)
        fab = self.fab
        segs = (plan.down_segments(self.n) if plan.has_down
                else [(0, self.n, frozenset())])
        # union of every path any ordinal can take: per down segment, the
        # surviving (ECMP) set — or its recomputed failover routes — which
        # is exactly the candidate set select_faulted chooses from.  An
        # all-paths-down segment raises DeviceUnreachable here, matching
        # the first access the interpreted driver would fail on.
        self._occ: Dict[Tuple[str, ...], list] = {}
        for _, _, down in segs:
            ps = fab.routing.paths(self.host, self.node, down=down)
            for q in (ps if fab.ecmp else [ps[0]]):
                key = tuple(q)
                if key not in self._occ:
                    self._occ[key] = fab.path_occupancy(q, self.size)
        self._path_id = {key: i for i, key in enumerate(self._occ)}
        self.K = len(fab.paths(self.host, self.node))
        # a fabric-mounted CXL-DRAM kept on its private link
        # (detach_link=False) pays one extra uncontended transport stage
        # after the fabric — the same append build_stack does for the
        # clean route tensors
        self._ih: list = []
        if isinstance(device.inner, CXLDRAMDevice):
            self._ih, _ = _link_hops(device.inner.link, self.size)
        self.port_keys = sorted({pk for hops in self._occ.values()
                                 for pk, _, _ in hops})
        self._pidx = {k: i for i, k in enumerate(self.port_keys)}
        base = len(self.port_keys)
        self.num_hops = (max(len(h) for h in self._occ.values())
                         + (1 if self._ih else 0))
        self.num_ports = base + (1 if self._ih else 0)
        self._pkts = np.zeros(max(base, 1), np.int64)
        self._occt = np.zeros(max(base, 1), np.int64)
        self._ecmp: Dict[str, List[int]] = {}
        self._link_retries = 0
        self._failovers = 0
        self._degraded = 0
        self._deg = np.zeros(0, bool)
        self._fo = np.zeros(0, bool)

    def path_table(self) -> Dict[str, np.ndarray]:
        """``hop_port`` (int32, -1 where the path has no such hop),
        ``hop_occ`` and ``hop_after`` (int64), paths x ``num_hops`` each,
        in path-id order; a CXL-DRAM's private hop (port ``num_ports - 1``)
        sits at the last column of every path."""
        H, P = self.num_hops, len(self.port_keys)
        k = len(self._occ)
        port = np.full((k, H), -1, np.int32)
        occ = np.zeros((k, H), np.int64)
        after = np.zeros((k, H), np.int64)
        for i, hops in enumerate(self._occ.values()):
            for h, (pk, o, a) in enumerate(hops):
                port[i, h], occ[i, h], after[i, h] = self._pidx[pk], o, a
            if self._ih:
                port[i, H - 1] = P
                occ[i, H - 1], after[i, H - 1] = self._ih[0][1:]
        return {"hop_port": port, "hop_occ": occ, "hop_after": after}

    def columns(self, addrs: np.ndarray) -> Dict[str, np.ndarray]:
        """The hops of every access of ``addrs`` (ordinals from 0) as the
        compact code: ``path`` (int32) and ``retries`` (uint8, accesses x
        hops).  Updates the port / ECMP / counter totals and the
        per-access degraded / failover flags."""
        from repro_torch.core.fabric.fabric import LINE_BYTES
        from repro_torch.core.fabric.routing import flow_hash

        fab, plan = self.fab, self.plan
        host, node = self.host, self.node
        addrs = np.asarray(addrs, np.int64)
        m = int(addrs.size)
        path_ids = np.zeros(m, np.int32)
        retries = np.zeros((m, self.num_hops), np.uint8)
        deg = np.zeros(m, bool)
        fo = np.zeros(m, bool)
        for r in range(m):
            line_addr = int(addrs[r]) // LINE_BYTES
            path, dg, fv = fab.select_faulted(host, node, line_addr, r)
            if dg:
                deg[r] = True
                self._degraded += 1
                if fv:
                    fo[r] = True
                    self._failovers += 1
            elif fab.ecmp and self.K > 1:
                # mirror traverse_qos: clean ECMP choices still count
                k = flow_hash(host, node, line_addr) % self.K
                counts = self._ecmp.setdefault(f"{host}->{node}",
                                               [0] * self.K)
                counts[k] += 1
            key = tuple(path)
            path_ids[r] = self._path_id[key]
            for h, (pk, occ, _) in enumerate(self._occ[key]):
                rt = plan.link_retries(pk, r) if plan.has_link else 0
                if rt > MAX_RETRY_CODE:
                    raise ReplayUnsupported(
                        f"{rt} link retries on one hop exceed the scan "
                        f"lane's one-byte code ({MAX_RETRY_CODE}); use "
                        "engine='python'")
                self._link_retries += rt
                i = self._pidx[pk]
                retries[r, h] = rt
                self._pkts[i] += 1
                self._occt[i] += occ * (1 + rt)
        self._deg, self._fo = deg, fo
        return {"path": path_ids, "retries": retries}

    @property
    def fstats(self) -> Dict[str, int]:
        return {"link_retries": int(self._link_retries),
                "failovers": int(self._failovers),
                "degraded_accesses": int(self._degraded)}

    def faulted(self) -> Dict:
        """Host-side port/ECMP totals for metrics reconstruction."""
        return {
            "port_keys": self.port_keys,
            "packets": self._pkts.copy(),
            "bytes": self._pkts * self.size,  # goodput: retries move 0 bytes
            "occupied": self._occt.copy(),    # retries DO occupy the wire
            "ecmp": {k: list(v) for k, v in self._ecmp.items()},
        }

    def flags(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-access ``(degraded, failover)`` availability flags."""
        return self._deg, self._fo


def expand_fault_codes(table: Dict[str, np.ndarray], path: np.ndarray,
                       retries: np.ndarray):
    """The five hop columns ``(hp, ho, ha, hon, hoc)`` of the JAX
    package's faulted lane (port, occupancy with the retries charged,
    store-and-forward extra, on-mask, clean occupancy) that the compact
    code stands for: what the kernel forms from the path table, the path
    id and the retry bytes (an off hop is port 0, nothing else)."""
    port = table["hop_port"][path]
    hon = port >= 0
    occ = np.where(hon, table["hop_occ"][path], 0)
    ho = occ * (1 + retries.astype(np.int64))
    ha = np.where(hon, table["hop_after"][path], 0)
    return (np.where(hon, port, 0).astype(np.int32), ho, ha, hon, occ)


class ReplayEngine:
    """Fused stand-in for :class:`TraceDriver` (one host).

    ``run`` is tick-identical to ``TraceDriver(device, ...).run`` for the
    supported stacks (all five paper devices, directly attached or mounted
    behind a switch fabric on a fixed route or under ECMP, with or without
    QoS; cache policies lru/fifo/direct; FTL greedy GC included; under any
    installed fault plan).  Unsupported shapes raise
    :class:`ReplayUnsupported`.  ``block_size`` is validated and otherwise
    tick-invisible: the kernel ignores it.  ``metrics`` (a
    :class:`~repro_torch.core.replay.metrics.MetricsSpec`) attaches the
    metrics bundle to the result.  The replay runs on ``torch_device``:
    the card by default, ``"cpu"`` for the plain twin.
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
        # host seconds of the last run's fault-column build (0.0 without
        # transport faults)
        self.last_column_seconds = 0.0

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

    def prepare(self, addrs: np.ndarray, *, size: int = 64):
        """The replay's inputs besides the trace: ``(cfg, params, routes,
        retries, builder)``.  ``routes`` is the per-access ECMP route or,
        under transport faults, path id (int32 numpy, ``None`` on a fixed
        route); ``retries`` the faulted lane's retry bytes (uint8 numpy,
        accesses x hops, else ``None``) and ``builder`` its
        :class:`_FaultColumnBuilder` (its path table in ``params``)."""
        import time

        addrs = np.asarray(addrs, np.int64)
        cfg, params = build_stack(
            self.device, size=size, outstanding=self.outstanding,
            issue_overhead_ns=self.issue_overhead_ns,
            posted_writes=self.posted_writes, n_accesses=addrs.size,
            max_addr=int(addrs.max(initial=0)),
            counters=self.metrics is not None)
        plan = self._active_plan()
        self.last_column_seconds = 0.0
        if (plan is not None and (plan.has_link or plan.has_down)
                and isinstance(self.device, FabricAttachedDevice)):
            # transport faults: a path table replaces the static route
            # tensors, and each access carries its path and retry bytes
            # (raises DeviceUnreachable exactly where the python driver
            # would)
            t0 = time.perf_counter()
            builder = _FaultColumnBuilder(self.device, plan, size,
                                          int(addrs.size))
            code = builder.columns(addrs)
            self.last_column_seconds = time.perf_counter() - t0
            qp = tuple(
                i for i, key in enumerate(builder.port_keys)
                if self.device.fabric.ports[key].qos_enabled)
            cfg = dataclasses.replace(cfg, fault_hops=True,
                                      num_hops=builder.num_hops,
                                      num_ports=builder.num_ports,
                                      num_routes=1, qos_ports=qp)
            return (cfg, {**params, **builder.path_table()}, code["path"],
                    code["retries"], builder)
        routes = None
        if cfg.num_routes > 1:
            routes = access_route_choices(self.device, addrs).astype(
                np.int32)
        return cfg, params, routes, None, None

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
        # build_stack's refusals come first, as in the reference
        cfg, params, routes, retries, builder = self.prepare(addrs, size=size)
        if chunk_size is not None or not return_latencies:
            raise ReplayUnsupported(
                "streaming replay (chunk_size=, return_latencies=False) is "
                "not ported yet (ROADMAP Queue A item 12); use "
                "engine='python' or replay the whole trace")
        dev = _td.resolve(self.torch_device)

        def on_card(x):
            return None if x is None else torch.from_numpy(x).to(dev)

        state = stack.init_state(cfg, dev)
        issues, dones, flags, qacc, qthr = replay_scan(
            cfg, params, state, on_card(addrs), on_card(writes),
            on_card(routes), start_tick=start_tick,
            retries=on_card(retries))
        return self._finish(cfg, state, size=size, start_tick=start_tick,
                            issues=issues.cpu().numpy(),
                            dones=dones.cpu().numpy(),
                            flags=flags.cpu().numpy(),
                            qacc=qacc.cpu().numpy(), qthr=qthr.cpu().numpy(),
                            writes=writes,
                            routes=None if builder else routes,
                            plan=self._active_plan(), builder=builder)

    # post-processing: health check, poison bit, fault counters, metrics
    # bundle, availability, result assembly
    def _finish(self, cfg, state, *, size, start_tick, issues, dones, flags,
                qacc, qthr, writes, routes, plan, builder):
        from repro_torch.core.replay import stack

        bad, gcs = stack.flash_health(state)
        if self.metrics is None:
            flags = flags & 3            # event bits ride only with metrics
        poisoned = None
        if plan is not None and plan.has_poison:
            # status bit only: the histogram and media folds read bits 0-5
            poisoned = plan.poisoned_np(
                0, np.arange(issues.size, dtype=np.int64), writes)
            flags = flags | (poisoned.astype(np.int32) << POISON_BIT)
        fdict = None
        if plan is not None:
            rr, rb = stack.fault_counters(state)
            fdict = {"link_retries": 0, "failovers": 0,
                     "degraded_accesses": 0}
            if builder is not None:
                fdict.update(builder.fstats)
            fdict.update(nand_read_retries=rr, retired_blocks=rb,
                         poisoned_reads=int(poisoned.sum())
                         if poisoned is not None else 0)
        mb = None
        if self.metrics is not None:
            from repro_torch.core.replay import metrics as _metrics
            mb = _metrics.bundle_single_deferred(
                self.metrics, self.device, cfg, issues, dones, flags,
                writes, qacc, stack.flash_counters(state), routes, size,
                qthr=qthr, faults=fdict,
                faulted=builder.faulted() if builder is not None else None)
        if bad:
            raise ReplayUnsupported(
                "FTL ran out of free blocks during GC (device overfilled) — "
                "the interpreted path raises there too; shrink the trace or "
                "use engine='python' for the exact error")
        avail = None
        if builder is not None:
            from repro_torch.core.replay import metrics as _metrics
            deg, fo = builder.flags()
            avail = _metrics.availability_series(
                issues, dones, deg, fo, spec=self.metrics,
                start_tick=start_tick)
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
            poison_flags=(((flags >> POISON_BIT) & 1).astype(bool)
                          if poisoned is not None else None),
            availability=avail,
            metrics=mb,
        )
