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

The kernel finds the hit way and the victim in O(1) instead of scanning
the set.  Per lane it keeps an open-addressing hash table of ``(page,
frame)`` int32 pairs (``2 ** table_bits(frames)`` slots, linear probing
from :func:`home`, backward-shift deletion); per frame its tag, dirty flag
and LRU list links (one int4) and its stamp; and per set its ``fill``
count of misses and, under LRU, the ends of its recency list (one int4).
:func:`layout` places them and :func:`placement` says whether in shared
memory or in a global scratch; the kernel takes the layout as it is.  The
trace streams through shared memory in chunks of ``CHUNK`` accesses.

The ``LAUNCHES`` counters count kernel launches only, so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

NEG = -(2**31) + 1
POLICIES = ("lru", "fifo", "direct")
LAUNCHES = {"cache_sim": 0, "cache_sim_fused": 0}

# accesses staged in shared memory at a time (a multiple of 16, so that
# the ring after them starts on 16 bytes), 13 bytes each: page and write
# flag in one int32, latency and arrival (int32), hit and dirty-evict flags
# in one byte
CHUNK = 1024
STAGING_BYTES = 13 * CHUNK
# the kernel's hash multiplier, home(page) = (page * HASH_MUL) mod 2**bits:
# an immediate in csrc/cache_sim.cu (kHashMul), which the library reports
# (cache_sim_hash_mul) and the card tests hold equal to this
HASH_MUL = 0x9E3779B1
MAX_FRAMES = 2**27          # keeps every per-lane offset in int32


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


class Placement(NamedTuple):
    """Where the kernel keeps a lane's structures (see :func:`placement`)."""

    state_in_smem: bool
    smem_bytes: int         # dynamic shared memory of a block
    scratch_bytes: int      # global scratch of each lane (0 if in smem)


class Layout(NamedTuple):
    """Offsets, in int32 words, of everything the kernel keeps, passed to
    it as they are (``struct Layout`` in ``csrc/cache_sim.cu``, field for
    field).  Shared memory starts with the ``chunk`` staged inputs (page
    and write flag in one word), then the staged latencies, arrivals and
    outcome bytes, then the K-slot arrival ring, then the lane's structures
    when they live there.  A lane's structures start with its hash table of
    ``2 ** table_bits`` ``(page, frame)`` pairs, then an int4 ``(tag, dirty,
    prev, next)`` per frame, an int4 ``(fill, head, tail, -)`` per set and
    a stamp per frame.  The table, the frames and the stamps each have a
    spare entry past their end, where the kernel sends the stores an access
    does not need instead of branching around them (the table one more, so
    that the frames start on 16 bytes).  Every int4 array starts on 16
    bytes, and ``lane_words`` is a multiple of four so that the next lane's
    table does too."""

    chunk: int
    lat: int
    arr: int
    out: int
    ring: int
    lane: int
    lane_words: int
    frames: int
    sets: int
    meta: int
    table_bits: int


def table_bits(frames: int) -> int:
    """log2 of the hash table's slots: the least power of two of at least
    ``2 * frames`` slots, and at least 4, so that a miss can insert its
    page before it deletes the victim's and still leave a slot empty."""
    return max(2, (2 * frames - 1).bit_length())


def home(page: int, bits: int) -> int:
    """The slot where the probe for ``page`` starts.  Pages congruent
    modulo ``2 ** bits`` share it."""
    return (page * HASH_MUL) & ((1 << bits) - 1)


STRESS_TRACES = ("uniform", "collide", "all_hit", "all_miss")


def stress_trace(kind: str, num_sets: int, ways: int, shape,
                 seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A seeded CPU trace ``(pages, writes)`` of ``shape`` that drives one
    case of the kernel, for its checks against the plain versions:
    ``uniform``, pages over 4x the frames; ``collide``, such pages times
    the hash table's size, so that all share one home slot and the
    resident pages form one probe cluster; ``all_hit``, pages of the
    frames' range, so that only first touches miss; ``all_miss``, each set
    cycling through ``ways + 1`` pages.  30% of the accesses write."""
    if kind not in STRESS_TRACES:
        raise ValueError(f"trace kind must be one of {STRESS_TRACES}, "
                         f"got {kind!r}")
    g = torch.Generator().manual_seed(seed)
    frames = num_sets * ways
    if kind == "all_hit":
        pages = torch.randint(0, frames, shape, generator=g)
    elif kind == "all_miss":
        n = math.prod(shape)
        pages = (torch.arange(n) % (frames + num_sets)).reshape(shape)
    else:
        pages = torch.randint(0, 4 * frames, shape, generator=g)
        if kind == "collide":
            pages = pages << table_bits(frames)
    writes = torch.rand(shape, generator=g) < 0.3
    return pages.to(torch.int32), writes


def _pad4(words: int) -> int:
    return -(-words // 4) * 4


def layout(num_sets: int, ways: int, outstanding: int) -> Layout:
    """The kernel's layout for a lane of ``num_sets x ways`` frames and a
    ring of ``outstanding`` slots."""
    frames = num_sets * ways
    bits = table_bits(frames)
    frames_at = 2 * ((1 << bits) + 2)
    sets_at = frames_at + 4 * (frames + 1)
    meta_at = sets_at + 4 * num_sets
    ring = STAGING_BYTES // 4
    return Layout(chunk=CHUNK, lat=CHUNK, arr=2 * CHUNK, out=3 * CHUNK,
                  ring=ring, lane=ring + _pad4(outstanding),
                  lane_words=_pad4(meta_at + frames + 1), frames=frames_at,
                  sets=sets_at, meta=meta_at, table_bits=bits)


def placement(num_sets: int, ways: int, outstanding: int,
              smem_limit: int) -> Placement:
    """Where the kernel keeps a lane's structures, given the dynamic shared
    memory a block may use.

    Shared memory always holds the ``STAGING_BYTES`` of the chunk being
    walked and the K-slot arrival ring (padded to a multiple of four
    words); a ring that does not fit raises ``ValueError``.  The lane's
    structures (:func:`layout`) follow there when they fit, else they go
    to a global scratch of ``scratch_bytes`` per lane.  Either way the
    kernel writes the final ``(tags, meta, dirty)`` state out at the end."""
    frames = num_sets * ways
    if frames > MAX_FRAMES:
        raise ValueError(f"{frames} frames exceed the kernel's "
                         f"{MAX_FRAMES} per lane")
    lay = layout(num_sets, ways, outstanding)
    used = 4 * lay.lane
    if used > smem_limit:
        raise ValueError(
            f"outstanding={outstanding} needs a {4 * outstanding} B ring, "
            f"more than the {smem_limit - STAGING_BYTES} B of shared memory "
            "a block may use for it on this card")
    lane = 4 * lay.lane_words
    if used + lane <= smem_limit:
        return Placement(True, used + lane, 0)
    return Placement(False, used, lane)


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
        where = placement(num_sets, ways, k, _smem_optin(lib, index))
        hits = torch.empty((lanes, n), dtype=torch.uint8, device=dev)
        evicts = torch.empty((lanes, n), dtype=torch.uint8, device=dev)
        lat = arr = scratch = None
        if fused:
            lat = torch.empty((lanes, n), dtype=torch.int32, device=dev)
            arr = torch.empty((lanes, n), dtype=torch.int32, device=dev)
        if not where.state_in_smem:
            scratch = torch.empty((lanes, where.scratch_bytes // 4),
                                  dtype=torch.int32, device=dev)
        state = torch.empty((lanes, 3, num_sets, ways), dtype=torch.int32,
                            device=dev)
        t = tm or Timing(1)
        err = lib.cache_sim_launch(
            p.data_ptr(), w.data_ptr(), n, lanes, num_sets, ways,
            int(policy == "lru"), int(fused),
            (ctypes.c_uint32 * len(Layout._fields))(*layout(num_sets, ways, k)),
            k, t.issue_ns, t.hit_ns, t.miss_ns, t.miss_occ_ns,
            t.wb_ns, int(where.state_in_smem), where.smem_bytes,
            hits.data_ptr(), evicts.data_ptr(),
            lat.data_ptr() if fused else None,
            arr.data_ptr() if fused else None, state.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
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
    arrivals with the associative busy-until form shared with the replay
    lanes (:func:`repro_torch.core.maxplus.busy_until`).

    The kernel's fill path is a gated max-plus chain — misses occupy the
    cache-DRAM fill stage for ``miss_occ_ns`` each, hits bypass it — so
    given the arrival stream the whole latency recurrence is one closed
    form, bit-identical to the sequential in-kernel chain.
    ``run_cuda(validate=True)`` uses it to cross-check every kernel run."""
    from repro_torch.core.maxplus import busy_until

    hits = torch.as_tensor(hits).to(torch.bool)
    evicts = torch.as_tensor(evicts).to(torch.bool)
    arr = torch.as_tensor(arr_ns)
    a = arr.to(torch.int64)
    free = busy_until(a, miss_occ_ns, active=~hits, init=0)
    start = free - miss_occ_ns                   # fill-stage grant per miss
    lat = torch.where(hits, hit_ns,
                      start - a + miss_ns + torch.where(evicts, wb_ns, 0))
    return lat.to(arr.dtype)
