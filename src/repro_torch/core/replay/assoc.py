"""The associative replay lane (``engine="assoc"``): no sequential step.

The scan lane walks the trace one access after another.  This lane
removes the walk for the stateless media stacks (DRAM- and PMEM-class):
every busy-until chain in the stack is a **max-plus recurrence**

    ``free_i = max(arr_i, free_{i-1}) + svc_i``

which has a closed form in prefix operations — with ``A`` the running sum
of the services, ``free = A + max(init, cummax(arr - A + svc))`` (see
:func:`repro_torch.core.maxplus.busy_until`), and a chain with
*constant* service time is one ``cummax``.  Transport hops, the media
occupancy chain and the issue-pacing recurrence are all of this shape;
PMEM row-hit state and posted-write tails are pure elementwise data.

The one genuine feedback loop is the LFB ring: ``issue_i = max(now_i,
popped_i)`` where ``popped_i`` is the slot freed by an *earlier
completion*.  Two facts make it tractable:

* completions are pushed in issue order and every pushed completion is
  ``>=`` every previously popped value (each completion exceeds its own
  issue tick by the stack's fixed minimum latency), so the popped sequence
  is exactly the **sorted** completion stream, offset by the LFB depth;
* the full system is a monotone set of max-plus constraints whose *least*
  fixed point is precisely what the sequential fold computes.

The solver therefore Kleene-iterates the data-parallel closed form
(pacing scan -> tandem transport/media -> sort -> popped floor) from below
until it reaches a fixed point, then **certifies** the candidate:

* fixed point: one more sweep changes nothing;
* strict suffix property: ``min_{j>=i} done_j > popped_i`` for every i,
  which proves the sorted-pop identity held index by index, hence the
  candidate satisfies the *causal* recurrence, whose solution is unique.

A certified solution is tick-identical to ``TraceDriver``.  If the
iteration does not converge inside ``max_sweeps`` (latency/window-bound
traces, where the LFB feedback chains through most of the trace), the lane
raises :class:`ReplayUnsupported` — exactness is never bought with
silence.

The solver runs on torch tensors on an explicit device (the card by
default, ``"cpu"`` for the host), where each sweep is a handful of
``cumsum`` / ``cummax`` / ``cummin`` / ``sort`` passes.  This lane has no
hand-written kernel: those library scans are its passes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.replay.engine import ReplayResult
from repro_torch.core.replay.spec import (
    ASSOC_KINDS,
    DRAM,
    ReplayUnsupported,
    StackConfig,
    build_stack,
    trace_to_arrays,
)

# ------------------------------------------------------------ local sort
def _local_sort(x, block: int):
    """Sort a 1-D tensor whose elements sit within ``block // 2`` positions
    of their sorted slot (bounded displacement).

    Completion streams have this shape: the media occupancy chain grows by
    at least ``occ`` per access, so two completions can only be out of
    order if their indices are within (tail spread / occ) of each other —
    a bound the caller computes from the device's timing constants.  Two
    passes of row sorts (aligned ``block``-wide rows, then rows offset by
    half a block) then give the full sorted order.  The solver certifies
    that the result is sorted before trusting it (a sorted permutation IS
    the sort), so an undershot bound surfaces as a refusal."""
    import torch

    n = x.shape[0]
    pad = (-n) % block
    y = (torch.cat([x, torch.full((pad,), torch.iinfo(x.dtype).max,
                                  dtype=x.dtype, device=x.device)])
         if pad else x)
    m = y.shape[0]
    y = torch.sort(y.reshape(-1, block), dim=1).values.reshape(-1)
    if m > block:
        h = block // 2
        mid = torch.sort(y[h:m - h].reshape(-1, block),
                         dim=1).values.reshape(-1)
        y = torch.cat([y[:h], mid, y[m - h:]])
    return y[:n]


# ------------------------------------------------------------------ solver
def _solve_core(cfg: StackConfig, p: Dict, addrs, writes, start_tick,
                max_sweeps: int, sort_block: int):
    """The certified Kleene solve on the device of ``addrs`` (int64) and
    ``writes`` (bool).  ``p`` holds the stack's scalar tick constants as
    Python ints.  Returns ``(issues, dones, hit_flags, sweeps, certified)``
    as numpy."""
    import torch

    dev = addrs.device
    n = int(addrs.shape[0])
    depth = cfg.outstanding
    start = int(start_tick)
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    ov = p["issue_ov"]
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    # ---- elementwise media data: return-path tails + hit flags
    posted = writes if cfg.posted_writes else no
    if cfg.kind == DRAM:
        tail = torch.where(posted, p["pack"], torch.full_like(ar, p["load"]))
        hit = no
    else:                                    # PMEM: row-buffer locality is
        row = addrs // p["row_bytes"]        # pure data, no timing feedback
        hit = torch.cat([no[:1], row[1:] == row[:-1]])
        lat = torch.as_tensor(np.asarray(p["lat"], np.int64), device=dev)
        tail = torch.where(posted, p["pack"],
                           lat[writes.long(), hit.long()])

    def cummax(x):
        return torch.cummax(x, dim=0).values

    def stage(arr, svc):
        # constant-service busy-until chain seeded at 0 (fresh port/media)
        return torch.clamp(cummax(arr - svc * ar), min=0) + svc * (ar + 1)

    def forward(u):
        """Issue ticks -> completion ticks: the tandem of transport-hop and
        media busy-until chains, mirrored stage for stage."""
        t = u
        for h in range(cfg.num_hops):
            t = stage(t, p["hop_occ"][h]) + p["hop_after"][h]
        t = t + p["rt_extra"]
        return stage(t, p["occ"]) + tail

    def pacing(floor):
        return cummax(floor - ov * ar) + ov * ar

    floor0 = torch.full((n,), start, dtype=torch.int64, device=dev)
    floor, sorted_ok = floor0, True
    u = pacing(floor0)
    dones = floor0
    converged = False
    sweeps = 0
    for sweeps in range(1, max_sweeps + 1):
        dones = forward(u)
        if n > depth:
            srt = _local_sort(dones, sort_block)
            sorted_ok = bool((srt[1:] >= srt[:-1]).all())
            floor = torch.where(ar < depth, start,
                                srt[torch.clamp(ar - depth, 0, n - 1)])
        u2 = pacing(floor)
        if bool((u2 == u).all()):
            converged = True
            break
        u = u2
    # On convergence ``dones == forward(u)``.  Certification: converged =>
    # fixed point; the popped stream was genuinely sorted (a sorted
    # permutation of the completions IS their sort, so an undershot
    # displacement bound in the row sort surfaces here); and the strict
    # suffix property proves the sorted-pop identity at every index —
    # together the candidate solves the causal recurrence, whose solution
    # is unique.
    suffmin = torch.flip(torch.cummin(torch.flip(dones, [0]), dim=0).values,
                         [0])
    certified = (converged and sorted_ok
                 and bool((suffmin > floor).all()))
    return (u.cpu().numpy(), dones.cpu().numpy(), hit.cpu().numpy(), sweeps,
            certified)


def _scalar_params(params: Dict) -> Dict:
    """The params with scalars as Python ints and the hop vectors as lists
    of ints (``lat`` stays a table)."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        out[k] = (a if k == "lat" else a.tolist()) if a.ndim else int(a)
    return out


# ------------------------------------------------------------------ facade
class AssocReplayEngine:
    """Fully data-parallel stand-in for :class:`TraceDriver` on stateless
    media stacks (``dram``, ``cxl-dram``, ``pmem``, directly attached or
    fabric-mounted on a single route).

    ``run`` either returns ticks **identical** to
    ``TraceDriver(device, ...).run`` or raises :class:`ReplayUnsupported`
    (stateful media, ECMP fan-out, an active fault plan, or a
    latency-bound trace whose LFB feedback defeats the ``max_sweeps``
    budget) — never a silently approximate result.  Fall back to
    ``engine="scan"`` on refusal.  The solve runs on ``torch_device``: the
    card by default, ``"cpu"`` for the host."""

    def __init__(self, device, outstanding: int = 32,
                 issue_overhead_ns: float = 0.5,
                 posted_writes: bool = True, max_sweeps: int = 24,
                 torch_device="cuda") -> None:
        self.device = device
        self.outstanding = max(1, outstanding)
        self.issue_overhead_ns = issue_overhead_ns
        self.posted_writes = posted_writes
        self.max_sweeps = max(1, int(max_sweeps))
        self.torch_device = torch_device

    def run(self, trace, start_tick: int = 0) -> ReplayResult:
        addrs, writes, size = trace_to_arrays(trace)
        return self.run_arrays(addrs, writes, size=size,
                               start_tick=start_tick)

    def run_arrays(self, addrs: np.ndarray, writes: np.ndarray, *,
                   size: int = 64, start_tick: int = 0) -> ReplayResult:
        addrs = np.asarray(addrs, np.int64)
        writes = np.asarray(writes, bool)
        if addrs.size == 0:
            raise ReplayUnsupported("empty trace")
        if start_tick < 0 and getattr(getattr(self.device, "fabric", None),
                                      "qos_enabled", False):
            # same contract as ReplayEngine: the lone-origin QoS no-floor
            # proof assumes non-negative ticks
            raise ReplayUnsupported(
                "QoS replay needs start_tick >= 0; use engine='python'")
        plan = getattr(self.device, "fault_plan", None)
        if plan is None:
            plan = getattr(getattr(self.device, "fabric", None),
                           "fault_plan", None)
        if plan is not None and plan.active:
            raise ReplayUnsupported(
                f"active fault plan ({', '.join(plan.class_names())}) "
                "perturbs per-access service times with no associative "
                "closed form; the fused scan lane replays every fault "
                "class tick-identically — use engine='scan' (or "
                "engine='python')")
        cfg, params = build_stack(
            self.device, size=size, outstanding=self.outstanding,
            issue_overhead_ns=self.issue_overhead_ns,
            posted_writes=self.posted_writes, n_accesses=addrs.size,
            max_addr=int(addrs.max(initial=0)))
        if cfg.kind not in ASSOC_KINDS:
            raise ReplayUnsupported(
                f"{cfg.kind!r} media keeps per-access state (cache frames / "
                "flash FTL) with no associative closed form; use "
                "engine='scan' (optionally blocked)")
        if cfg.num_routes > 1:
            raise ReplayUnsupported(
                "ECMP stacks occupy a different port set per access; the "
                "associative lane covers single-route mounts — use "
                "engine='scan'")
        min_lat = int(np.sum(params["hop_occ"]) + np.sum(params["hop_after"])
                      + params["rt_extra"] + params["occ"])
        if min_lat < 1:
            # the sorted-pop certification needs completions to strictly
            # exceed their issue ticks
            raise ReplayUnsupported(
                "zero-latency stack cannot be certified; use engine='scan'")
        occ = int(params["occ"])
        if occ < 1:
            raise ReplayUnsupported(
                "zero media occupancy voids the bounded-displacement sort "
                "(completions need not be locally ordered); use "
                "engine='scan'")
        # Completion displacement bound: the media chain grows >= occ per
        # access, so two completions can only swap order within
        # (tail spread / occ) indices — the row width of the local sort.
        if cfg.kind == DRAM:
            tails = [int(params["load"])]
        else:
            tails = [int(t) for t in np.asarray(params["lat"]).ravel()]
        if self.posted_writes:
            tails.append(int(params["pack"]))
        spread = max(tails) - min(tails)
        sort_block = max(32, 2 * (spread // occ + 1))
        import torch

        from repro_torch import torch_device as _td

        dev = _td.resolve(self.torch_device)
        issues, dones, hits, sweeps, certified = _solve_core(
            cfg, _scalar_params(params), torch.from_numpy(addrs).to(dev),
            torch.from_numpy(writes).to(dev), start_tick, self.max_sweeps,
            sort_block)
        if not certified:
            raise ReplayUnsupported(
                f"associative solve not certified after "
                f"{sweeps}/{self.max_sweeps} sweeps (latency-bound "
                "trace: the LFB feedback chains through the whole "
                "trace); use engine='scan'")
        self._last_sweeps = int(sweeps)
        first = int(issues[0])
        last = max(int(dones.max(initial=0)), start_tick)
        return ReplayResult(
            accesses=int(addrs.size),
            bytes_moved=int(addrs.size) * size,
            elapsed_ticks=last - first,
            sum_latency_ticks=int((dones - issues).sum()),
            end_tick=last,
            latency_ticks=dones - issues,
            hit_flags=hits,
            evict_flags=np.zeros(addrs.size, bool),
        )
