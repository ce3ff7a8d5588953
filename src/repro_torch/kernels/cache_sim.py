"""Set-associative cache replay (the simulator hot spot), as a CUDA kernel
for Hopper beside its plain PyTorch version.

``cache_sim`` replays a trace of page ids and write flags through an LRU,
FIFO or direct-mapped cache and returns per-access hit and dirty-evict
flags; ``cache_sim_fused`` does the same in one pass with the closed-loop
latency chain of the cached CXL-SSD (per-access latency and arrival, int32
nanoseconds).  The update rule is bit-identical to the JAX package's Pallas
kernels and to the Python policy objects (:mod:`repro_torch.core.cache.policies`).

Both wrappers launch ``csrc/cache_sim.cu`` for CUDA tensors and run the
plain version (``cache_sim_plain`` / ``cache_sim_fused_plain``, per-access
loops over tensors) for CPU tensors; nothing falls back from one to the
other.  A trace is ``(N,)`` or ``(lanes, N)``: lanes are independent
replays, one CUDA block each.

The ``LAUNCHES`` counters count kernel launches only, so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

NEG = -(2**31) + 1
POLICIES = ("lru", "fifo", "direct")
LAUNCHES = {"cache_sim": 0, "cache_sim_fused": 0}

# shared memory the kernel needs besides the state and the ring: the block
# reduction's per-warp slots (32 x int32 match + 32 x int64 key)
RED_BYTES = 32 * 12


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(pages, writes, num_sets: int, ways: int, policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"kernel supports lru/fifo/direct, got {policy!r}")
    if policy == "direct" and ways != 1:
        raise ValueError("direct-mapped requires ways == 1")
    if num_sets < 1 or ways < 1:
        raise ValueError(f"need num_sets, ways >= 1, got {num_sets}, {ways}")
    if (pages.dim() not in (1, 2) or writes.shape != pages.shape
            or (pages.dim() == 2 and pages.shape[0] == 0)):
        raise ValueError(f"pages and writes must be matching (N,) or "
                         f"(lanes >= 1, N) tensors, got {tuple(pages.shape)} "
                         f"and {tuple(writes.shape)}")
    if pages.device != writes.device:
        raise ValueError(f"pages on {pages.device}, writes on {writes.device}")
    if pages.dtype.is_floating_point or pages.dtype == torch.bool:
        raise ValueError(f"pages must be integer page ids, got {pages.dtype}")
    if pages.numel():
        lo, hi = torch.aminmax(pages)
        if int(lo) < 0 or int(hi) >= 2**31:
            raise ValueError("page ids must lie in [0, 2**31), the kernel's "
                             "int32 tag range")


@dataclass(frozen=True)
class Timing:
    """Latency model of the fused kernel, all int32 nanoseconds."""

    outstanding: int = 32
    issue_ns: int = 1
    hit_ns: int = 50
    miss_ns: int = 5000
    miss_occ_ns: int = 213
    wb_ns: int = 0

    def __post_init__(self) -> None:
        for k, v in self.__dict__.items():
            if not 0 <= int(v) < 2**31:
                raise ValueError(f"{k}={v} is outside the kernel's int32 range")


# -------------------------------------------------------------- wrappers
def cache_sim(pages: torch.Tensor, writes: torch.Tensor, *, num_sets: int,
              ways: int, policy: str = "lru", return_state: bool = False):
    """Replay a trace. pages: integer ``(N,)`` or ``(lanes, N)``; writes:
    bool of the same shape.  Returns ``(hits, dirty_evicts)`` (bool), plus
    the final ``(tags, meta, dirty)`` state in ``(num_sets, ways)`` layout
    (a leading lanes axis for 2-D traces) when ``return_state``."""
    _check(pages, writes, num_sets, ways, policy)
    if pages.device.type == "cpu":
        hits, evicts, state = cache_sim_plain(pages, writes, num_sets=num_sets,
                                              ways=ways, policy=policy)
    else:
        hits, evicts, _, _, state = _launch(pages, writes, num_sets, ways,
                                            policy, None)
    return (hits, evicts, state) if return_state else (hits, evicts)


def cache_sim_fused(pages: torch.Tensor, writes: torch.Tensor, *,
                    num_sets: int, ways: int, policy: str = "lru",
                    outstanding: int = 32, issue_ns: int = 1, hit_ns: int = 50,
                    miss_ns: int = 5000, miss_occ_ns: int = 213,
                    wb_ns: int = 0):
    """Fused trace replay: ``(hits, dirty_evicts, latency_ns, arrival_ns)``.

    Decisions are bit-identical to :func:`cache_sim`.  Latency model
    (int32 nanoseconds): access *i* arrives ``issue_ns`` after its
    predecessor but no earlier than completion *i - K*
    (``K = max(1, outstanding)``, a ring of the last K completions); a hit
    costs ``hit_ns``; a miss queues on the fill path's busy-until
    (``miss_occ_ns`` occupancy per fill), then costs ``miss_ns``, plus
    ``wb_ns`` when it also evicts a dirty page.  Callers bound the trace so
    the int32 clock cannot wrap (see
    :func:`repro_torch.core.replay.cuda_engine.run_cuda`)."""
    _check(pages, writes, num_sets, ways, policy)
    tm = Timing(max(1, outstanding), issue_ns, hit_ns, miss_ns, miss_occ_ns,
                wb_ns)
    if pages.device.type == "cpu":
        return cache_sim_fused_plain(pages, writes, num_sets=num_sets,
                                     ways=ways, policy=policy,
                                     **tm.__dict__)
    hits, evicts, lat, arr, _ = _launch(pages, writes, num_sets, ways,
                                        policy, tm)
    return hits, evicts, lat, arr


def placement(num_sets: int, ways: int, outstanding: int,
              smem_limit: int) -> tuple[bool, int]:
    """Where the kernel keeps its state: ``(state_in_smem, dynamic
    shared-memory bytes)``.  The reduction slots and the K-slot ring always
    live in shared memory (a ring that does not fit raises ``ValueError``);
    the ``12 * num_sets * ways`` bytes of tags, stamps and dirty flags go
    there too if they fit, else in a global scratch."""
    used = RED_BYTES + 4 * outstanding
    if used > smem_limit:
        raise ValueError(
            f"outstanding={outstanding} needs a {4 * outstanding} B ring, "
            f"more than the {smem_limit - RED_BYTES} B of shared memory a "
            "block may use for it on this card")
    state_bytes = 12 * num_sets * ways
    state_in = used + state_bytes <= smem_limit
    return state_in, used + (state_bytes if state_in else 0)


def threads_for(ways: int) -> int:
    """Threads per block: one per way, rounded up to a warp, at most 1024."""
    return min(1024, -(-ways // 32) * 32)


_SMEM_OPTIN: dict[int, int] = {}


def _smem_optin(lib, index: int) -> int:
    if index not in _SMEM_OPTIN:
        out = ctypes.c_int(0)
        _raise_on(lib, lib.cache_sim_smem_optin(index, ctypes.byref(out)),
                  "cudaDeviceGetAttribute")
        _SMEM_OPTIN[index] = out.value
    return _SMEM_OPTIN[index]


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cache_sim_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _launch(pages, writes, num_sets, ways, policy, tm: Timing | None):
    """Launch the kernel on the tensors' card, on PyTorch's current stream."""
    from repro_torch.kernels import _build

    dev = pages.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    lib = _build.library("cache_sim")
    squeeze = pages.dim() == 1
    p = pages.reshape(1, -1) if squeeze else pages
    w = writes.reshape(1, -1) if squeeze else writes
    lanes, n = p.shape
    p = p.to(torch.int32).contiguous()
    w = w.to(torch.uint8).contiguous()
    fused = tm is not None
    k = tm.outstanding if fused else 1
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        state_in, smem = placement(num_sets, ways, k, _smem_optin(lib, index))
        hits = torch.empty((lanes, n), dtype=torch.uint8, device=dev)
        evicts = torch.empty((lanes, n), dtype=torch.uint8, device=dev)
        lat = arr = None
        if fused:
            lat = torch.empty((lanes, n), dtype=torch.int32, device=dev)
            arr = torch.empty((lanes, n), dtype=torch.int32, device=dev)
        state = torch.empty((lanes, 3, num_sets, ways), dtype=torch.int32,
                            device=dev)
        t = tm or Timing(1)
        err = lib.cache_sim_launch(
            p.data_ptr(), w.data_ptr(), n, lanes, num_sets, ways,
            int(policy == "lru"), int(fused), k, t.issue_ns, t.hit_ns,
            t.miss_ns, t.miss_occ_ns, t.wb_ns, int(state_in),
            threads_for(ways), smem, hits.data_ptr(), evicts.data_ptr(),
            lat.data_ptr() if fused else None,
            arr.data_ptr() if fused else None, state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "cache_sim kernel launch")
        LAUNCHES["cache_sim_fused" if fused else "cache_sim"] += 1

    out = [hits.view(torch.bool), evicts.view(torch.bool), lat, arr]
    st = (state[:, 0], state[:, 1], state[:, 2].bool())
    if squeeze:
        out = [x[0] if x is not None else None for x in out]
        st = tuple(x[0] for x in st)
    return (*out, st)


# ----------------------------------------------------------- plain twins
def cache_sim_plain(pages: torch.Tensor, writes: torch.Tensor, *,
                    num_sets: int, ways: int, policy: str = "lru"):
    """Plain PyTorch version of :func:`cache_sim`: one access per loop step,
    line for line the JAX package's ``lax.scan`` cache replay.  Runs on any
    device.  Returns ``(hits, dirty_evicts, (tags, meta, dirty))``."""
    _check(pages, writes, num_sets, ways, policy)
    if pages.dim() == 2:
        lanes = [cache_sim_plain(p, w, num_sets=num_sets, ways=ways,
                                 policy=policy) for p, w in zip(pages, writes)]
        return (torch.stack([r[0] for r in lanes]),
                torch.stack([r[1] for r in lanes]),
                tuple(torch.stack([r[2][j] for r in lanes]) for j in range(3)))
    dev = pages.device
    is_lru = policy == "lru"
    pages = pages.to(torch.int32)
    writes = writes.to(torch.bool)
    tags = torch.full((num_sets * ways,), -1, dtype=torch.int32, device=dev)
    meta = torch.zeros((num_sets * ways,), dtype=torch.int32, device=dev)
    dirty = torch.zeros((num_sets * ways,), dtype=torch.bool, device=dev)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
    n = pages.shape[0]
    ts = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    rows = torch.fmod(pages, num_sets).to(torch.int64) * ways  # lax.rem
    cols = torch.arange(ways, device=dev)
    hits = torch.empty(n, dtype=torch.bool, device=dev)
    evicts = torch.empty(n, dtype=torch.bool, device=dev)
    for i in range(n):
        page, wr, t = pages[i], writes[i], ts[i]
        line = rows[i] + cols                      # the set's ways, (W,)
        line_tags = tags[line]
        line_meta = meta[line]
        line_dirty = dirty[line]

        match = line_tags == page
        hit = match.any()
        hit_way = match.to(torch.int32).argmax()

        valid = line_tags >= 0
        # victim: invalid way first (key=NEG), else smallest meta (LRU ts or
        # FIFO insertion ts — same rule, different update discipline)
        victim_key = torch.where(valid, line_meta, neg)
        victim_way = victim_key.argmin().view(1)
        way = torch.where(hit, hit_way, victim_way)

        dirty_evict = ~hit & valid[victim_way] & line_dirty[victim_way]

        new_tag = torch.where(hit, line_tags[way], page)
        # LRU: bump timestamp on every touch. FIFO: stamp only on insert.
        stamp = torch.where(hit, t if is_lru else line_meta[way], t)
        new_dirty = torch.where(hit, line_dirty[way] | wr, wr)

        at = line[way]
        tags[at] = new_tag
        meta[at] = stamp
        dirty[at] = new_dirty
        hits[i] = hit
        evicts[i:i + 1] = dirty_evict
    shape = (num_sets, ways)
    return hits, evicts, (tags.view(shape), meta.view(shape), dirty.view(shape))


def cache_sim_fused_plain(pages: torch.Tensor, writes: torch.Tensor, *,
                          num_sets: int, ways: int, policy: str = "lru",
                          outstanding: int = 32, issue_ns: int = 1,
                          hit_ns: int = 50, miss_ns: int = 5000,
                          miss_occ_ns: int = 213, wb_ns: int = 0):
    """Plain PyTorch version of :func:`cache_sim_fused`: the decisions of
    :func:`cache_sim_plain`, then the closed-loop latency recurrence one
    access per step (int32 nanoseconds), line for line the JAX package's
    ``cache_sim_fused_ref``.  Returns ``(hits, dirty_evicts, latency_ns,
    arrival_ns)``."""
    hits, evicts, _ = cache_sim_plain(pages, writes, num_sets=num_sets,
                                      ways=ways, policy=policy)
    if hits.dim() == 2:
        lanes = [_latency_plain(h, e, outstanding, issue_ns, hit_ns, miss_ns,
                                miss_occ_ns, wb_ns) for h, e in zip(hits, evicts)]
        return (hits, evicts, torch.stack([x[0] for x in lanes]),
                torch.stack([x[1] for x in lanes]))
    return (hits, evicts, *_latency_plain(hits, evicts, outstanding, issue_ns,
                                          hit_ns, miss_ns, miss_occ_ns, wb_ns))


def _latency_plain(hits, evicts, outstanding, issue_ns, hit_ns, miss_ns,
                   miss_occ_ns, wb_ns):
    dev = hits.device
    K = max(1, outstanding)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    wb, zero = i32(wb_ns), i32(0)
    # prev-arrival starts at 0, like the kernel's init: the first access
    # arrives at issue_ns
    busy, prev, ring = i32(0), i32(0), torch.zeros(K, dtype=torch.int32,
                                                   device=dev)
    n = hits.shape[0]
    lat = torch.empty(n, dtype=torch.int32, device=dev)
    arr = torch.empty(n, dtype=torch.int32, device=dev)
    for i in range(n):
        hit, ev = hits[i], evicts[i]
        slot = i % K
        t = torch.maximum(prev + issue_ns, ring[slot])
        start = torch.maximum(t, busy)
        done = torch.where(hit, t + hit_ns,
                           start + miss_ns + torch.where(ev, wb, zero))
        busy = torch.where(hit, busy, start + miss_occ_ns)
        prev = t
        ring[slot] = done
        lat[i] = done - t
        arr[i] = t
    return lat, arr


def fill_latency_assoc(hits, evicts, arr_ns, *, hit_ns: int, miss_ns: int,
                       miss_occ_ns: int, wb_ns: int) -> torch.Tensor:
    """Recompute the fused kernel's latency stream from its decisions and
    arrivals, without the sequential chain.

    The fill path is a gated busy-until with constant occupancy: misses
    occupy it for ``miss_occ_ns`` each, hits bypass it.  With ``C`` the
    running miss count, the fill stage frees at
    ``occ * C + max(0, cummax(where(miss, arr - occ * (C - 1), -inf)))``,
    which equals the sequential fold exactly (int64 here, so no wrap).
    ``run_cuda(validate=True)`` uses it to cross-check every kernel run."""
    hits = torch.as_tensor(hits).to(torch.bool)
    evicts = torch.as_tensor(evicts).to(torch.bool)
    arr = torch.as_tensor(arr_ns)
    miss = ~hits
    a = arr.to(torch.int64)
    m = miss.to(torch.int64)
    c = torch.cumsum(m, -1)
    key = torch.where(miss, a - miss_occ_ns * (c - m),
                      torch.iinfo(torch.int64).min)
    free = miss_occ_ns * c + torch.cummax(key, -1).values.clamp(min=0)
    start = free - miss_occ_ns                   # fill-stage grant per miss
    lat = torch.where(hits, hit_ns,
                      start - a + miss_ns + torch.where(evicts, wb_ns, 0))
    return lat.to(arr.dtype)
