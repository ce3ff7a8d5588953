"""CUDA-kernel trace replay for the cached CXL-SSD (``engine="cuda"``).

The accelerator fast path: the fused kernel
(:func:`repro_torch.kernels.cache_sim.cache_sim_fused`) replays the DRAM-cache
state machine and emits latency in the same sequential pass, with the cache
state held in shared memory.

Fidelity contract (different from the scan lane's tick-exactness):

* hit / dirty-evict decisions are bit-identical to the vectorized cache
  replay (:mod:`repro_torch.core.cache.trace_sim`) and hence to the Python
  policy objects — the fully-associative LRU/FIFO cache maps to
  ``num_sets=1, ways=capacity``, direct-mapped to ``num_sets=capacity,
  ways=1``;
* latency follows a closed-loop analytic model (LFB-ring arrival throttling
  + fill-path busy-until queueing, nanosecond resolution) that tracks the
  shape of the exact replay but does not model MSHR coalescing, writeback
  stalls, or flash channel contention.  Use the python lane when ticks must
  match the interpreted driver exactly;
* a fabric mount (:class:`~repro_torch.core.fabric.FabricAttachedDevice`)
  replays as the device it mounts: the model has no fabric hops, as in the
  JAX package's pallas lane.  An active fault plan on the device or its
  fabric is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import torch_device as _td
from repro_torch.core.devices import CachedCXLSSDDevice
from repro_torch.core.engine import TICKS_PER_NS
from repro_torch.core.fabric.fabric import FabricAttachedDevice
from repro_torch.core.replay.engine import ReplayResult
from repro_torch.core.replay.spec import ReplayUnsupported
from repro_torch.kernels.cache_sim import cache_sim_fused, fill_latency_assoc


def _cached(device) -> CachedCXLSSDDevice:
    # a fabric mount replays its device alone: the kernel's analytic model
    # has no fabric hops, exactly as the JAX package's pallas lane
    inner = device.inner if isinstance(device, FabricAttachedDevice) else device
    if not isinstance(inner, CachedCXLSSDDevice):
        raise ReplayUnsupported(
            "engine='cuda' models the cached CXL-SSD; the lane for "
            f"{type(inner).__name__} (the fused scan, ROADMAP Queue A item 5) "
            "is not ported yet — use engine='python'")
    return inner


def cuda_params(device, issue_overhead_ns: float) -> dict:
    """Derive the fused kernel's geometry + ns-resolution latency model
    from a live device."""
    inner = _cached(device)
    cfg = inner.cache.cfg
    pol = inner.cache.policy.name
    if pol not in ("lru", "fifo", "direct"):
        raise ReplayUnsupported(f"cuda path supports lru/fifo/direct, "
                                f"got {pol!r}")
    frames = cfg.capacity_pages
    num_sets, ways = (frames, 1) if pol == "direct" else (1, frames)
    t = inner.hil.cfg.timing
    page = inner.hil.cfg.page_bytes
    miss_ns = (inner.hil.cfg.hil_overhead_ns + t.t_read_us * 1e3
               + page / t.channel_mbps * 1e3          # flash channel xfer
               + page / cfg.dram_bw_gbps              # cache-DRAM fill
               + cfg.hit_latency_ns)
    # A dirty eviction injects one flash program into the W-deep writeback
    # buffer; beyond its drain capacity the demand path stalls.  Amortize
    # that backpressure as program-time / W per dirty evict.
    wb_ns = (inner.hil.cfg.hil_overhead_ns
             + t.t_prog_us * 1e3) / max(1, cfg.writeback_buffer)
    return dict(num_sets=num_sets, ways=ways, policy=pol,
                issue_ns=max(1, int(round(issue_overhead_ns))),
                hit_ns=int(round(cfg.hit_latency_ns)),
                miss_ns=int(round(miss_ns)),
                miss_occ_ns=int(round(page / cfg.dram_bw_gbps)),
                wb_ns=int(round(wb_ns)))


def run_cuda(device, addrs: np.ndarray, writes: np.ndarray, *,
             size: int = 64, outstanding: int = 32,
             issue_overhead_ns: float = 0.5, start_tick: int = 0,
             validate: bool = False, torch_device="cuda") -> ReplayResult:
    """Replay (addrs, writes) through the fused kernel on ``torch_device``
    (the card by default; ``"cpu"`` runs the kernel's plain version);
    returns a :class:`~repro_torch.core.replay.engine.ReplayResult`.

    ``validate=True`` recomputes the latency stream from the kernel's own
    decisions + arrivals with :func:`~repro_torch.kernels.cache_sim.fill_latency_assoc`
    and raises if the two disagree bit-for-bit — a cheap end-to-end
    cross-check of the in-kernel sequential chain."""
    dev = _td.resolve(torch_device)
    plan = getattr(device, "fault_plan", None)
    if plan is None:
        plan = getattr(getattr(device, "fabric", None), "fault_plan", None)
    if plan is not None and plan.active:
        raise ReplayUnsupported(
            f"active fault plan ({', '.join(plan.class_names())}): the "
            "cuda kernel models the fault-free cached CXL-SSD; the fault "
            "classes replay in the python lane (the fused scan lane, "
            "ROADMAP Queue A item 5, is not ported yet) — use "
            "engine='python'")
    kw = cuda_params(device, issue_overhead_ns)
    # int32-nanosecond budget: arrival/busy cursors grow by at most
    # (miss_occ + issue) per access, plus one service term on top.
    n = int(np.asarray(addrs).shape[-1])
    worst_ns = (n * (kw["miss_occ_ns"] + kw["issue_ns"])
                + kw["miss_ns"] + kw["wb_ns"])
    if worst_ns >= 2**31:
        raise ReplayUnsupported(
            f"trace of {n} accesses can overflow the kernel's int32 "
            f"nanosecond clock (worst case {worst_ns} ns); split the trace "
            "or use engine='python'")
    pages64 = np.asarray(addrs, np.int64) // 4096
    if pages64.size and int(pages64.max()) >= 2**31:
        raise ReplayUnsupported(
            "page id exceeds the kernel's int32 tag range (addr >= 2^43); "
            "use engine='python'")
    pages = torch.from_numpy(pages64.astype(np.int32)).to(dev)
    wr = torch.from_numpy(np.asarray(writes, bool)).to(dev)
    hits, evicts, lat_ns, arr_ns = cache_sim_fused(
        pages, wr, outstanding=max(1, outstanding), **kw)
    if validate:
        lat2 = fill_latency_assoc(
            hits, evicts, arr_ns, hit_ns=kw["hit_ns"], miss_ns=kw["miss_ns"],
            miss_occ_ns=kw["miss_occ_ns"], wb_ns=kw["wb_ns"])
        if not torch.equal(lat2, lat_ns):
            bad = int(torch.nonzero(lat2 != lat_ns)[0, 0])
            raise AssertionError(
                f"cuda kernel latency diverged from the associative "
                f"reconstruction at access {bad}: kernel "
                f"{int(lat_ns[bad])}, assoc {int(lat2[bad])}")
    hits = hits.cpu().numpy()
    evicts = evicts.cpu().numpy()
    lat = lat_ns.cpu().numpy().astype(np.int64) * TICKS_PER_NS
    issues = start_tick + arr_ns.cpu().numpy().astype(np.int64) * TICKS_PER_NS
    dones = issues + lat
    n = pages64.size
    return ReplayResult(
        accesses=n, bytes_moved=n * size,
        elapsed_ticks=int(dones.max(initial=start_tick) - issues[0]),
        sum_latency_ticks=int(lat.sum()),
        end_tick=int(dones.max(initial=start_tick)),
        latency_ticks=lat, hit_flags=hits, evict_flags=evicts)
