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

Streaming: ``chunk_size=`` replays the trace as a sequence of launches,
one a chunk, that carry the whole replay state from one to the next on
the replay's device (:class:`repro_torch.kernels.replay_scan.Carry`; a
ragged last chunk is shorter, never padded into the state), equal to the
one-launch replay at any chunk size.  ``return_latencies=False`` keeps no
per-access outputs: each chunk folds into O(buckets + windows)
accumulators on the device (:class:`~repro_torch.core.replay.metrics.
StreamFold`).  :meth:`ReplayEngine.run_store` streams straight from an
on-disk :class:`~repro_torch.data.trace_store.TraceStore`, building the
route and fault columns chunk by chunk, and hands out a snapshot of the
whole resumable state after each chunk
(:func:`repro_torch.core.replay.stream.replay_stream` checkpoints it).

Ticks are int64 (1 tick = 1 ps); int32 would overflow after 2.1 ms of
simulated time.  Nothing here imports torch until a replay runs, so the
python lane stays torch-free.
"""

from __future__ import annotations

import dataclasses
import time
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
    columns.  The path table depends on the plan's down segments only, so
    columns for any ordinal range come without the rest of the trace:
    a streamed run builds them chunk by chunk, and the accumulated
    totals round-trip through :meth:`state` / :meth:`load_state` so a
    checkpointed run resumes mid-trace."""

    def __init__(self, device, plan, size: int, n: int,
                 keep_flags: bool = True) -> None:
        from repro_torch.core.devices import CXLDRAMDevice

        self.fab = device.fabric
        self.plan = plan
        self.host, self.node = device.host, device.device_node
        self.size = int(size)
        self.n = int(n)
        self.keep_flags = keep_flags
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
        self._deg_parts: List[np.ndarray] = []
        self._fo_parts: List[np.ndarray] = []

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

    def columns(self, addrs: np.ndarray, lo: int = 0) -> Dict[str, np.ndarray]:
        """The hops of the accesses ``addrs``, ordinals ``[lo, lo +
        len(addrs))``, as the compact code: ``path`` (int32) and
        ``retries`` (uint8, accesses x hops).  Updates the port / ECMP /
        counter totals and (with ``keep_flags``) the per-access degraded
        / failover flags."""
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
            j = lo + r
            line_addr = int(addrs[r]) // LINE_BYTES
            path, dg, fv = fab.select_faulted(host, node, line_addr, j)
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
                rt = plan.link_retries(pk, j) if plan.has_link else 0
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
        if self.keep_flags:
            self._deg_parts.append(deg)
            self._fo_parts.append(fo)
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
        """Per-access ``(degraded, failover)`` availability flags over
        every ordinal range built so far (empty without ``keep_flags``)."""
        if not self._deg_parts:
            z = np.zeros(0, bool)
            return z, z
        return (np.concatenate(self._deg_parts),
                np.concatenate(self._fo_parts))

    # ------------------------------------------------- checkpoint support
    def state(self) -> Dict:
        """The accumulated totals and flags as flat arrays."""
        deg, fo = self.flags()
        return {"pkts": self._pkts.copy(), "occt": self._occt.copy(),
                "ecmp": {k: np.asarray(v, np.int64)
                         for k, v in self._ecmp.items()},
                "counters": np.asarray(
                    [self._link_retries, self._failovers, self._degraded],
                    np.int64),
                "deg": deg, "fo": fo}

    def load_state(self, st: Dict) -> None:
        self._pkts = np.asarray(st["pkts"], np.int64).copy()
        self._occt = np.asarray(st["occt"], np.int64).copy()
        self._ecmp = {k: [int(x) for x in np.asarray(v)]
                      for k, v in st["ecmp"].items()}
        c = np.asarray(st["counters"], np.int64)
        self._link_retries = int(c[0])
        self._failovers = int(c[1])
        self._degraded = int(c[2])
        deg = np.asarray(st["deg"], bool)
        fo = np.asarray(st["fo"], bool)
        self._deg_parts = [deg.copy()] if deg.size else []
        self._fo_parts = [fo.copy()] if fo.size else []


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

    def _stack(self, n: int, max_addr: int, size: int, keep_flags=True):
        """``(cfg, params, builder)`` of a replay of ``n`` accesses below
        ``max_addr``: under transport faults a :class:`_FaultColumnBuilder`
        whose path table replaces the static route tensors (raises
        DeviceUnreachable exactly where the python driver would), else
        ``None``."""
        cfg, params = build_stack(
            self.device, size=size, outstanding=self.outstanding,
            issue_overhead_ns=self.issue_overhead_ns,
            posted_writes=self.posted_writes, n_accesses=n,
            max_addr=max_addr, counters=self.metrics is not None)
        plan = self._active_plan()
        if (plan is None or not (plan.has_link or plan.has_down)
                or not isinstance(self.device, FabricAttachedDevice)):
            return cfg, params, None
        builder = _FaultColumnBuilder(self.device, plan, size, n,
                                      keep_flags=keep_flags)
        qp = tuple(i for i, key in enumerate(builder.port_keys)
                   if self.device.fabric.ports[key].qos_enabled)
        cfg = dataclasses.replace(cfg, fault_hops=True,
                                  num_hops=builder.num_hops,
                                  num_ports=builder.num_ports,
                                  num_routes=1, qos_ports=qp)
        return cfg, {**params, **builder.path_table()}, builder

    def prepare(self, addrs: np.ndarray, *, size: int = 64):
        """The replay's inputs besides the trace: ``(cfg, params, routes,
        retries, builder)``.  ``routes`` is the per-access ECMP route or,
        under transport faults, path id (int32 numpy, ``None`` on a fixed
        route); ``retries`` the faulted lane's retry bytes (uint8 numpy,
        accesses x hops, else ``None``) and ``builder`` its
        :class:`_FaultColumnBuilder` (its path table in ``params``)."""
        addrs = np.asarray(addrs, np.int64)
        cfg, params, builder = self._stack(
            int(addrs.size), int(addrs.max(initial=0)), size)
        self.last_column_seconds = 0.0
        if builder is not None:
            t0 = time.perf_counter()
            code = builder.columns(addrs)
            self.last_column_seconds = time.perf_counter() - t0
            return cfg, params, code["path"], code["retries"], builder
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
        n = int(addrs.size)
        self._common_refusals(n, start_tick)
        if chunk_size is not None and int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size!r}")
        # build_stack's refusals come first, as in the reference
        cfg, params, routes, retries, builder = self.prepare(addrs, size=size)
        plan = self._active_plan()
        poisoned = None
        if plan is not None and plan.has_poison:
            poisoned = plan.poisoned_np(0, np.arange(n, dtype=np.int64),
                                        writes)
        # the bundle reconstructs the ports from the ECMP choices; a path
        # id is no route
        port_routes = None if builder else routes
        if chunk_size is not None or not return_latencies:
            chunk = n if chunk_size is None else int(chunk_size)

            def feed():
                for lo in range(0, n, chunk):
                    hi = min(lo + chunk, n)
                    yield lo, hi, {
                        "addr": addrs[lo:hi], "wr": writes[lo:hi],
                        "route": None if routes is None else routes[lo:hi],
                        "retries": (None if retries is None
                                    else retries[lo:hi])}

            out = self._stream(cfg, params, feed(), n=n, size=size,
                               start_tick=start_tick,
                               want_lat=bool(return_latencies))
            return self._finish(cfg, size=size, start_tick=start_tick,
                                writes=writes, poisoned=poisoned, plan=plan,
                                builder=builder, n=n, routes=port_routes,
                                **out)
        dev = _td.resolve(self.torch_device)

        def on_card(x):
            return None if x is None else torch.from_numpy(x).to(dev)

        state = stack.init_state(cfg, dev)
        issues, dones, flags, qacc, qthr = replay_scan(
            cfg, params, state, on_card(addrs), on_card(writes),
            on_card(routes), start_tick=start_tick,
            retries=on_card(retries))
        return self._finish(cfg, state=state, size=size,
                            start_tick=start_tick,
                            issues=issues.cpu().numpy(),
                            dones=dones.cpu().numpy(),
                            flags=flags.cpu().numpy(),
                            qacc=qacc.cpu().numpy(), qthr=qthr.cpu().numpy(),
                            writes=writes, poisoned=poisoned, plan=plan,
                            builder=builder, routes=port_routes)

    def run_store(self, store, *, chunk_size: int, start_tick: int = 0,
                  return_latencies: bool = True, chunk_iter=None,
                  resume_state: Optional[Dict] = None,
                  on_chunk=None) -> ReplayResult:
        """Streaming replay from an on-disk columnar trace
        (:class:`~repro_torch.data.trace_store.TraceStore`, or anything
        duck-typed like one: ``n``, ``size``, ``max_addr``, ``writes()``
        and ``chunks(chunk_size, start=...)``).  Input residency is
        O(chunk): each chunk's columns (optionally through a prefetching
        ``chunk_iter``; see :func:`repro_torch.core.replay.stream.
        replay_stream`) go to the device for one launch, and the carry
        stays there.  With ``return_latencies=True`` the per-access
        *outputs* are still materialized (inherently O(trace)); pass
        ``return_latencies=False`` for bounded memory end to end.

        Every active fault class streams, transport included: the ECMP
        choices, the hop code (:class:`_FaultColumnBuilder`) and the
        poison status are built chunk by chunk from the absolute access
        ordinals, equal to the one-shot lane.

        ``on_chunk(seen, snapshot)`` fires after each chunk lands;
        ``snapshot()`` captures the whole resumable state (the carry, the
        stack state, the streaming accumulators, the per-access output
        parts, the feed's accumulators) as host numpy.  Passing a
        captured snapshot back as ``resume_state`` (with ``chunk_iter``
        starting at ``resume_state['seen']``, or ``None`` to let the store
        seek) continues the run bit-exactly."""
        from repro_torch.core.fabric.fabric import LINE_BYTES
        from repro_torch.core.fabric.routing import flow_choices

        n = int(store.n)
        size = int(store.size)
        chunk = int(chunk_size)
        if chunk < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size!r}")
        self._common_refusals(n, start_tick)
        want_lat = bool(return_latencies)
        plan = self._active_plan()
        cfg, params, builder = self._stack(n, int(store.max_addr), size,
                                           keep_flags=want_lat)
        K = 0
        route_counts = None
        if cfg.num_routes > 1:
            K = len(self.device.fabric.paths(self.device.host,
                                             self.device.device_node))
            route_counts = np.zeros(K, np.int64)
        has_poison = plan is not None and plan.has_poison
        feed_state = {"psum": 0, "poison_parts": []}
        seen0 = 0
        if resume_state is not None:
            seen0 = int(resume_state["seen"])
            if not 0 <= seen0 <= n:
                raise ValueError(
                    f"resume cursor {seen0} outside trace of {n} accesses")
            feed_state["psum"] = int(resume_state.get("psum", 0))
            feed_state["poison_parts"] = [
                np.asarray(x, bool)
                for x in resume_state.get("poison_parts", [])]
            if route_counts is not None and \
                    resume_state.get("route_counts") is not None:
                route_counts[:] = np.asarray(resume_state["route_counts"])
            if builder is not None and \
                    resume_state.get("builder") is not None:
                builder.load_state(resume_state["builder"])
        if chunk_iter is not None:
            src = chunk_iter
        elif seen0:
            src = store.chunks(chunk, start=seen0)
        else:
            src = store.chunks(chunk)   # duck-typed stores may lack start=

        def feed():
            for lo, hi, cols in src:
                d = {"addr": np.asarray(cols["addr"], np.int64),
                     "wr": np.asarray(cols["wr"], bool),
                     "route": None, "retries": None}
                if builder is not None:
                    code = builder.columns(d["addr"], lo)
                    d["route"], d["retries"] = code["path"], code["retries"]
                elif route_counts is not None:
                    r = flow_choices(self.device.host,
                                     self.device.device_node,
                                     d["addr"] // LINE_BYTES, K)
                    route_counts[:] += np.bincount(r, minlength=K)
                    d["route"] = np.asarray(r, np.int32)
                if has_poison:
                    pz = plan.poisoned_np(
                        0, np.arange(lo, hi, dtype=np.int64), d["wr"])
                    feed_state["psum"] += int(pz.sum())
                    if want_lat:
                        feed_state["poison_parts"].append(pz)
                yield lo, hi, d

        def feed_snapshot():
            # the feed builds columns lazily, one pulled chunk at a time,
            # so its accumulators are in step with the carry
            return {"psum": int(feed_state["psum"]),
                    "route_counts": (None if route_counts is None
                                     else route_counts.copy()),
                    "poison_parts": list(feed_state["poison_parts"]),
                    "builder": (builder.state() if builder is not None
                                else None)}

        out = self._stream(
            cfg, params, feed(), n=n, size=size, start_tick=start_tick,
            want_lat=want_lat, resume_state=resume_state, on_chunk=on_chunk,
            feed_snapshot=feed_snapshot)
        return self._finish(
            cfg, size=size, start_tick=start_tick,
            writes=(store.writes() if self.metrics is not None and want_lat
                    else None),
            routes=None, plan=plan, builder=builder,
            poisoned=(np.concatenate(feed_state["poison_parts"])
                      if has_poison and want_lat else None),
            poison_total=feed_state["psum"] if has_poison else None,
            n=n, route_counts=route_counts, **out)

    def _stream(self, cfg, params, feed, *, n, size, start_tick, want_lat,
                resume_state=None, on_chunk=None, feed_snapshot=None
                ) -> Dict:
        """The chunk loop of every streamed replay: one ``replay_scan``
        launch a chunk of ``feed`` (``(lo, hi, columns)`` in order,
        covering the accesses from the resume point to ``n``) through one
        carry and one stack state on the replay's device, the outputs
        kept as host parts (``want_lat``) or folded into a
        :class:`~repro_torch.core.replay.metrics.StreamFold`.  Returns
        :meth:`_finish`'s replay arguments: the final ``state``, the
        port totals and the outputs or the ``fold``."""
        import torch

        from repro_torch import torch_device as _td
        from repro_torch.core.replay import stack
        from repro_torch.core.replay.metrics import StreamFold
        from repro_torch.kernels import replay_scan as rs

        dev = _td.resolve(self.torch_device)
        state = stack.init_state(cfg, dev)
        carry = rs.new_carry(cfg, params, dev, start_tick)
        fold = (None if want_lat else
                StreamFold(self.metrics, cfg.kind, dev, size=size,
                           start_tick=start_tick))
        parts: List[Tuple[np.ndarray, ...]] = []
        if resume_state is not None:
            _restore(resume_state["carry"], state, carry, fold)
            if want_lat:
                parts = [tuple(np.asarray(a) for a in t)
                         for t in resume_state["parts"]]
        seen = carry.seen

        def on_card(x):
            return None if x is None else torch.from_numpy(
                np.ascontiguousarray(x)).to(dev)

        for lo, hi, cols in feed:
            if not 0 < hi - lo or lo != seen:
                raise AssertionError(
                    f"chunk iterator out of order: [{lo}, {hi}) after {seen}")
            w = on_card(cols["wr"])
            iss, dn, fl, _, _ = rs.replay_scan(
                cfg, params, state, on_card(cols["addr"]), w,
                on_card(cols["route"]), start_tick=start_tick,
                retries=on_card(cols["retries"]), carry=carry)
            if want_lat:
                parts.append((iss.cpu().numpy(), dn.cpu().numpy(),
                              fl.cpu().numpy()))
            else:
                fold.update(iss, dn, fl, w)
            seen = hi
            if on_chunk is not None:
                on_chunk(seen, lambda: {
                    "seen": seen,
                    "carry": _carry_leaves(state, carry, fold),
                    "parts": list(parts),
                    **(feed_snapshot() if feed_snapshot else {})})
        if seen != n:
            raise AssertionError(
                f"chunk iterator produced {seen} of {n} accesses")

        qacc, qthr = rs.carry_ports(cfg, carry)
        issues = dones = flags = None
        if want_lat:
            issues, dones, flags = (np.concatenate([t[j] for t in parts])
                                    for j in range(3))
        return dict(state=state, issues=issues, dones=dones, flags=flags,
                    qacc=qacc, qthr=qthr, fold=fold)

    # post-processing: health check, poison bit, fault counters, metrics
    # bundle, availability, result assembly (one-shot, chunked and
    # store-streamed alike)
    def _finish(self, cfg, *, state, size, start_tick, issues, dones, flags,
                qacc, qthr, writes, routes, plan, builder, poisoned=None,
                poison_total=None, fold=None, n=None, route_counts=None):
        from repro_torch.core.replay import metrics as _metrics
        from repro_torch.core.replay import stack

        bad, gcs = stack.flash_health(state)
        want_lat = fold is None
        n = int(issues.size) if n is None else n
        if want_lat:
            if self.metrics is None:
                flags = flags & 3        # event bits ride only with metrics
            if poisoned is not None:
                # status bit only: the histogram and media folds read
                # bits 0-5
                flags = flags | (poisoned.astype(np.int32) << POISON_BIT)
        if poison_total is None and poisoned is not None:
            poison_total = int(poisoned.sum())
        fdict = None
        if plan is not None:
            rr, rb = stack.fault_counters(state)
            fdict = {"link_retries": 0, "failovers": 0,
                     "degraded_accesses": 0}
            if builder is not None:
                fdict.update(builder.fstats)
            fdict.update(nand_read_retries=rr, retired_blocks=rb,
                         poisoned_reads=poison_total or 0)
        mb = None
        if self.metrics is not None:
            common = dict(qthr=qthr, faults=fdict,
                          faulted=(builder.faulted() if builder is not None
                                   else None),
                          route_counts=route_counts)
            if want_lat:
                mb = _metrics.bundle_single_deferred(
                    self.metrics, self.device, cfg, issues, dones, flags,
                    writes, qacc, stack.flash_counters(state), routes, size,
                    **common)
            else:
                mb = _metrics.bundle_single_fused(
                    self.metrics, self.device, cfg, fold.acc.cpu().numpy(),
                    fold.med.cpu().numpy(), qacc,
                    stack.flash_counters(state), routes, n, size, **common)
        if bad:
            raise ReplayUnsupported(
                "FTL ran out of free blocks during GC (device overfilled) — "
                "the interpreted path raises there too; shrink the trace or "
                "use engine='python' for the exact error")
        avail = None
        if builder is not None and want_lat:
            deg, fo = builder.flags()
            avail = _metrics.availability_series(
                issues, dones, deg, fo, spec=self.metrics,
                start_tick=start_tick)
        if want_lat:
            first = int(issues[0])
            last = max(int(dones.max(initial=0)), start_tick)
            lat_sum = int((dones - issues).sum())
        else:
            first, last, lat_sum = (int(fold.first[0]), int(fold.last[0]),
                                    int(fold.sum[0]))
            last = max(last, start_tick)
        return ReplayResult(
            accesses=n,
            bytes_moved=n * size,
            elapsed_ticks=last - first,
            sum_latency_ticks=lat_sum,
            end_tick=last,
            latency_ticks=dones - issues if want_lat else None,
            hit_flags=(flags & 1).astype(bool) if want_lat else None,
            evict_flags=(flags & 2).astype(bool) if want_lat else None,
            gc_runs=gcs,
            poison_flags=(((flags >> POISON_BIT) & 1).astype(bool)
                          if want_lat and poisoned is not None else None),
            availability=avail,
            metrics=mb,
        )


# ------------------------------------------------------------ resumption
def _carry_leaves(state: Dict, carry, fold) -> Dict[str, np.ndarray]:
    """The whole resumable state of a streamed replay as host arrays, by
    name: the carry, the stack state's tensors and the streaming
    accumulators."""
    out = {f"scan/{k}": v for k, v in carry.leaves().items()}
    for part in ("media", "flash"):
        for k, v in (state[part] or {}).items():
            out[f"state/{part}/{k}"] = v.cpu().numpy()
    if fold is not None:
        out.update({f"fold/{k}": v for k, v in fold.leaves().items()})
    return out


def _restore(flat: Dict[str, np.ndarray], state: Dict, carry, fold) -> None:
    """Load a snapshot's carry leaves (:func:`_carry_leaves`) into a fresh
    ``state`` / ``carry`` / ``fold``, leaf by leaf against their names and
    shapes, so that a snapshot of another replay configuration fails
    loudly, never silently."""
    import torch

    template = _carry_leaves(state, carry, fold)
    for key, tmpl in template.items():
        arr = flat.get(key)
        if arr is None:
            raise KeyError(f"resume state missing carry leaf {key!r}")
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"resume carry leaf {key!r} has shape {arr.shape}, "
                f"expected {tuple(tmpl.shape)} — snapshot from a "
                "different replay configuration?")
    for part in ("media", "flash"):
        for k, v in (state[part] or {}).items():
            v.copy_(torch.from_numpy(np.asarray(
                flat[f"state/{part}/{k}"]).astype(template[
                    f"state/{part}/{k}"].dtype)))
    carry.load({k: np.asarray(flat[f"scan/{k}"]) for k in ("words", "maps")})
    if fold is not None:
        fold.load({k[len("fold/"):]: np.asarray(v) for k, v in flat.items()
                   if k.startswith("fold/")})
