"""Device-state layer of the scan lane: the stateful media/flash machinery,
as torch state and as the plain per-access twin ``step``.

One lane of state is one Python device object's mutable fields, as a dict
of int64 / int32 / bool tensors on an explicit device:

* **media state** (:func:`media_init`) — the per-device front end: DRAM
  busy-until, PMEM open row, the CXL-SSD page-register file, or the full
  DRAM-cache layer (packed LRU/FIFO/direct frames, MSHR table, writeback
  buffer, cache-DRAM busy-until);
* **flash state** (:func:`flash_init`) — the SimpleSSD backend (FTL
  mapping + write pointer + free-block pool, PAL die/channel occupancy).

:func:`step` replays one access against that state and mutates it in
place (the JAX package's pure functions return new pytrees).  It mirrors
``repro.core.replay.stack.step`` operation for operation; Python control
flow over torch scalars stands in for each ``lax.cond`` / ``fori_loop``
and for each ``jnp.where(en, ...)`` gated write.  It is the scan lane's
CPU path and the yardstick of the ``replay_scan`` kernel
(:mod:`repro_torch.kernels.replay_scan`), which keeps the same state in
shared and device memory; the card's main path never runs it.

Garbage collection: when the spec layer decides a trace could outrun the
log-append headroom (``StackConfig.gc``), the flash state carries the full
FTL bookkeeping (``p2l`` inverse map, per-block valid counts, FIFO
free-block queue) and block allocation gains a greedy-GC step — victim
select (fewest valid pages, ties to the lowest block id), valid pages
migrated read+program in offset order, erase, victim appended to the free
queue — mirroring :meth:`repro_torch.core.ssd.ftl.FTL._collect` tick for
tick.  A free-pool underrun (the interpreted path raises "FTL out of
space") sets the sticky ``bad`` flag, which the engine surfaces as
:class:`~repro_torch.core.replay.spec.ReplayUnsupported`.

NAND faults: with the plan's statics in ``StackConfig.faults`` the flash
state carries the read and erase sequence numbers of the PAL / FTL
(``rd_seq``, ``er_seq``), the retry and retirement totals (``c_rr``,
``c_rb``) and the retired-block mask; a read charges ``1 + retries``
sense and transfer rounds, and a failed GC erase retires its victim
(:func:`fault_counters` reads the totals).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.faults.plan import (erase_fails_torch,
                                          nand_read_retries_torch)
from repro_torch.core.replay.spec import (  # noqa: F401  (MAX_ACCESSES)
    DISABLED,
    DRAM,
    MAX_ACCESSES,
    PMEM,
    SSD_BUF,
    SSD_CACHE,
    StackConfig,
)

BIG = 1 << 62          # order-infinity that survives additions
FREE = -1              # free-slot sentinel (pages/addresses are >= 0)

# Packed cache-frame layout: stamp-major so argmin == OrderedDict order.
STAMP_SHIFT = 39
PAGE_BITS = 38
PAGE_FIELD = ((1 << PAGE_BITS) - 1) << 1      # bits [38:1]
STAMP_FIELD = -(1 << STAMP_SHIFT)             # bits [63:39] (sign-extended ok)
INT32_MAX = 2**31 - 1                         # GC score of a non-candidate

FLASH_KINDS = (SSD_BUF, SSD_CACHE)


def has_flash(cfg: StackConfig) -> bool:
    return cfg.kind in FLASH_KINDS


def _bump(f: Dict, key: str, by: int = 1) -> None:
    """``f[key] += by`` on a 0-d counter that exists only on some stacks."""
    if key in f:
        f[key] += by


# -------------------------------------------------------------- flash (PAL)
def _die(cfg: StackConfig, ppn: int) -> Tuple[int, int]:
    ch = ppn % cfg.channels
    return ch, ch * cfg.dies_per_channel + (ppn // cfg.channels) \
        % cfg.dies_per_channel


def _pal_read(cfg: StackConfig, p: Dict, f: Dict, t: int, ppn: int) -> int:
    """Mirror of :meth:`PAL._schedule` (read path, program-suspend rule).

    With NAND fault statics (``cfg.faults``) the read charges
    ``1 + retries`` full sense+transfer rounds, keyed on the in-state read
    sequence number — the twin of :meth:`PAL.read_page` consulting the
    plan on its ``_rd_seq``, which advances once a real read."""
    ch, i = _die(cfg, ppn)
    dbi, dpi = int(f["die_busy"][i]), int(f["die_prog"][i])
    cbi = int(f["chan_busy"][ch])
    read_t, xfer = p["read_t"], p["xfer_page"]
    if cfg.faults:
        retries = int(nand_read_retries_torch(cfg.faults, f["rd_seq"]))
        read_t *= 1 + retries
        xfer *= 1 + retries
        f["rd_seq"] += 1
        f["c_rr"] += retries
    ds = max(t, dbi)
    if dpi > ds:
        ds = min(dpi, ds + p["sus_t"])
    array_done = ds + read_t
    new_dp = dpi + read_t if dpi > ds else dpi
    done = max(array_done, cbi) + xfer
    f["die_busy"][i] = done
    f["die_prog"][i] = new_dp
    f["chan_busy"][ch] = done
    return done


def _pal_prog(cfg: StackConfig, p: Dict, f: Dict, t: int, ppn: int) -> int:
    """Mirror of :meth:`PAL._schedule` (program path: bus in, then array)."""
    ch, i = _die(cfg, ppn)
    ds = max(t, int(f["die_busy"][i]), int(f["die_prog"][i]))
    bus_done = max(ds, int(f["chan_busy"][ch])) + p["xfer_page"]
    done = bus_done + p["prog_t"]
    f["die_busy"][i] = bus_done
    f["die_prog"][i] = done
    f["chan_busy"][ch] = bus_done
    return done


def _pal_erase(cfg: StackConfig, p: Dict, f: Dict, t: int, ppn: int) -> int:
    """Mirror of :meth:`PAL.erase_block` (array-only, program waits out)."""
    _, i = _die(cfg, ppn)
    done = max(t, int(f["die_busy"][i]), int(f["die_prog"][i])) \
        + p["erase_t"]
    f["die_busy"][i] = done
    return done


# ----------------------------------------------------- FTL free-block FIFO
def _free_pop(cfg: StackConfig, f: Dict, en: bool) -> int:
    """``free_blocks.pop(0)``; an empty pool sets the sticky ``bad`` flag
    (the interpreted FTL raises "out of space" there)."""
    head, cnt = int(f["fq_head"]), int(f["fq_count"])
    v = int(f["free_q"][head])
    if en:
        f["fq_head"].fill_((head + 1) % cfg.num_blocks)
        f["fq_count"].fill_(cnt - 1)
        f["free_mask"][v] = False
        if cnt <= 0:
            f["bad"].fill_(True)
    return v


def _free_append(cfg: StackConfig, f: Dict, v: int) -> None:
    """``free_blocks.append(v)`` (erased victims re-enter at the back)."""
    cnt = int(f["fq_count"])
    f["free_q"][(int(f["fq_head"]) + cnt) % cfg.num_blocks] = v
    f["fq_count"].fill_(cnt + 1)
    f["free_mask"][v] = True


# -------------------------------------------------------------- FTL + GC
def _collect(cfg: StackConfig, p: Dict, f: Dict, now: int) -> int:
    """Mirror of :meth:`FTL._collect`: greedy victim (fewest valid pages,
    excluding the write block, free blocks and retired blocks, ties to the
    lowest block id), valid pages migrated read+program in offset order on
    a serial tick chain, erase, victim appended to the free pool unless
    its erase failed (the block is retired instead)."""
    nb, ppb = cfg.num_blocks, cfg.pages_per_block
    cand = (torch.arange(nb, device=f["valid"].device) != int(f["wpb"])) \
        & ~f["free_mask"]
    if cfg.faults:
        # grown bad blocks never re-enter candidacy (FTL.retired_blocks)
        cand &= ~f["rtr_mask"]
    any_cand = bool(cand.any())
    score = torch.where(cand, f["valid"], torch.full_like(f["valid"],
                                                          INT32_MAX))
    victim = int(torch.argmin(score))        # ties -> lowest block id
    base = victim * ppb
    t = now
    for off in range(ppb):
        ppn = base + off
        lpn = int(f["p2l"][ppn])
        if not (any_cand and lpn >= 0):
            continue
        t = _pal_read(cfg, p, f, t, ppn)
        # _next_ppn(t, allow_gc=False): migration draws straight from the
        # watermark-reserved pool, never re-entering GC
        wpb, wpp = int(f["wpb"]), int(f["wpp"])
        if wpp >= ppb:
            wpb, wpp = _free_pop(cfg, f, True), 0
        new_ppn = wpb * ppb + wpp
        f["wpb"].fill_(wpb)
        f["wpp"].fill_(wpp + 1)
        t = _pal_prog(cfg, p, f, t, new_ppn)
        # p2l.pop(ppn); l2p[lpn] = new_ppn; p2l[new_ppn] = lpn; valid moves
        f["p2l"][ppn] = FREE
        f["p2l"][new_ppn] = lpn
        f["l2p"][lpn] = new_ppn
        f["valid"][new_ppn // ppb] += 1
        f["valid"][victim] -= 1
        _bump(f, "c_gw")
    if any_cand:
        # python bumps gc_erases only when a victim existed (the
        # no-candidate early return skips the erase)
        t = _pal_erase(cfg, p, f, t, base)
        _bump(f, "c_ge")
        fail = False
        if cfg.faults:
            # FTL._collect's erase-fail consult: the erase sequence
            # advances once a victim's erase; a failed erase retires the
            # victim, which never returns to the free pool
            fail = bool(erase_fails_torch(cfg.faults, f["er_seq"]))
            f["er_seq"] += 1
            if fail:
                f["rtr_mask"][victim] = True
                f["c_rb"] += 1
        if not fail:
            _free_append(cfg, f, victim)
    return t


def _ftl_invalidate(cfg: StackConfig, f: Dict, lpn: int) -> None:
    """Mirror of :meth:`FTL._invalidate` (valid-count + inverse-map upkeep —
    only tracked on GC-capable stacks, where it decides victims)."""
    old = int(f["l2p"][lpn])
    if old >= 0:
        f["valid"][old // cfg.pages_per_block] -= 1
        f["p2l"][old] = FREE


def _alloc_ppn(cfg: StackConfig, p: Dict, f: Dict, t: int
               ) -> Tuple[int, int]:
    """Mirror of :meth:`FTL._next_ppn`: returns ``(ppn, gc_done)``."""
    ppb = cfg.pages_per_block
    need = int(f["wpp"]) >= ppb
    if not cfg.gc:
        # log-append lane: the free pool is a pristine counter (spec-time
        # headroom check guarantees GC can never trigger)
        wpb, wpp = int(f["wpb"]), int(f["wpp"])
        if need:
            wpb, wpp = int(f["nfree"]), 0
            f["nfree"] += 1
        f["wpb"].fill_(wpb)
        f["wpp"].fill_(wpp + 1)
        return wpb * ppb + wpp, t
    gc_done = t
    if need and int(f["fq_count"]) <= cfg.gc_watermark_blocks:
        f["gcs"] += 1
        gc_done = _collect(cfg, p, f, t)
    # `need` is the one taken before the collection, as in the reference
    v = _free_pop(cfg, f, need)
    wpb = v if need else int(f["wpb"])
    wpp = 0 if need else int(f["wpp"])
    f["wpb"].fill_(wpb)
    f["wpp"].fill_(wpp + 1)
    return wpb * ppb + wpp, gc_done


def _hil_write(cfg: StackConfig, p: Dict, f: Dict, t: int, lpn: int) -> int:
    """HIL overhead + FTL write: invalidate (GC stacks), allocate — running
    greedy GC when the free pool is at the watermark — then program."""
    _bump(f, "c_hw")
    if cfg.gc:
        _ftl_invalidate(cfg, f, lpn)
    ppn, t1 = _alloc_ppn(cfg, p, f, t + p["hil_ov"])
    f["l2p"][lpn] = ppn
    if cfg.gc:
        f["p2l"][ppn] = lpn
        f["valid"][ppn // cfg.pages_per_block] += 1
    return _pal_prog(cfg, p, f, t1, ppn)


def _hil_read(cfg: StackConfig, p: Dict, f: Dict, t: int, ppn: int) -> int:
    """HIL overhead + FTL read of a programmed page (callers check the
    mapping table first, exactly like the cache's ``is_written`` gate)."""
    _bump(f, "c_hr")
    return _pal_read(cfg, p, f, t + p["hil_ov"], ppn)


# ------------------------------------------------------------- device steps
def _first(mask: torch.Tensor) -> int:
    """``jnp.argmax`` of a bool mask: the lowest true index, 0 if none."""
    return int(mask.to(torch.int8).argmax())


def _dram_step(cfg, p, md, f, t, addr, wr, posted, ctr):
    occ_done = max(t, int(md["busy"])) + p["occ"]
    md["busy"].fill_(occ_done)
    return occ_done + (p["pack"] if posted else p["load"]), {}


def _pmem_step(cfg, p, md, f, t, addr, wr, posted, ctr):
    row = addr // p["row_bytes"]
    row_hit = row == int(md["row"])
    occ_done = max(t, int(md["busy"])) + p["occ"]
    md["busy"].fill_(occ_done)
    md["row"].fill_(row)
    done = occ_done + (p["pack"] if posted else p["lat"][int(wr)][int(row_hit)])
    return done, {"hit": row_hit}


def _match(frames: torch.Tensor, pfield: int) -> torch.Tensor:
    return ((frames & PAGE_FIELD) == pfield) & (frames >= 0)


def _buf_step(cfg, p, md, f, t, addr, wr, posted, ctr):
    """CXL-SSD page-register buffer: LRU over a handful of open pages;
    misses amplify to 4 KB flash ops (read-modify-write for writes)."""
    page = addr // cfg.page_bytes
    frames = md["frames"]
    pfield = page << 1
    match = _match(frames, pfield)
    fidx = _first(match)
    hit = bool(match[fidx])
    done0, flushed, filled = t, False, False
    if hit:
        old = int(frames[fidx])
        frames[fidx] = (ctr << STAMP_SHIFT) | pfield | ((old & 1) | int(wr))
    else:
        vic = int(torch.argmin(frames))
        vval = int(frames[vic])
        flushed = vval >= 0 and (vval & 1) > 0
        ppn = int(f["l2p"][page])
        filled = ppn >= 0
        if filled:
            done0 = _hil_read(cfg, p, f, t, ppn)
        if flushed:
            _hil_write(cfg, p, f, done0, (vval & PAGE_FIELD) >> 1)
        frames[vic] = (ctr << STAMP_SHIFT) | pfield | int(wr)
    return done0 + p["internal"], {"hit": hit, "evict": flushed,
                                   "fill": filled}


def _cache_step(cfg, p, md, f, t, addr, wr, posted, ctr):
    """The paper's DRAM cache layer, one access: MSHR coalesce -> resident
    hit -> miss (MSHR stall, evict + writeback queue, flash fill).  Mirrors
    :meth:`repro_torch.core.cache.dram_cache.DRAMCache.access` branch for
    branch."""
    page = addr // cfg.page_bytes
    frames, mpage, mready, wtick = (md["frames"], md["mpage"], md["mready"],
                                    md["wtick"])
    pfield = page << 1

    # ---- MSHR lookup (in-flight fill rides the existing SSD read)
    mm = mpage == page
    m_idx = _first(mm)
    m_exists = bool(mm[m_idx])
    m_ready = int(mready[m_idx])
    coalesce = m_exists and m_ready > t

    # ---- residency
    if cfg.cache_assoc:
        match = _match(frames, pfield)
        fidx = _first(match)
        resident = bool(match[fidx])
    else:
        fidx = page % p["cap"]
        fv = int(frames[fidx])
        resident = fv >= 0 and (fv & PAGE_FIELD) == pfield
    hit = not coalesce and resident
    miss = not coalesce and not resident
    old = int(frames[fidx])
    dram_busy = int(md["dram_busy"])

    # ---- hit: 64 B transfer occupies cache-DRAM bandwidth
    xdone = max(t, dram_busy) + p["line_xfer"]

    start2 = fill_done = t
    do_wb = stalled = evicted = False
    if miss:
        # MSHR allocate (stall if the table is full)
        stalled = int((mpage >= 0).sum()) >= cfg.mshr_entries
        start1 = t
        if stalled:
            vic_ready = int(mready.min())       # free slots hold BIG
            start1 = max(t, vic_ready)
            kill = mready <= vic_ready
            mpage[kill] = FREE
            mready[kill] = BIG
        # write-allocate insert: victim = argmin of packed stamps (invalid
        # frames are -1, below every valid packed value)
        vic = int(torch.argmin(frames)) if cfg.cache_assoc else fidx
        vval = int(frames[vic])
        evicted = vval >= 0
        do_wb = evicted and (vval & 1) > 0
        # writeback queue: background flash write, stall only if full.
        # Touched only for a dirty victim, as _queue_writeback is.
        stall = start1
        if do_wb:
            dead = wtick <= start1               # reap(now)
            wtick[dead] = FREE
            if int((~dead).sum()) >= cfg.wb_slots:
                stall = int(torch.where(dead, BIG, wtick).min())
                wtick[wtick <= stall] = FREE
            wdone = _hil_write(cfg, p, f, stall, (vval & PAGE_FIELD) >> 1)
            wtick[int(torch.argmin(wtick))] = wdone
            start2 = max(start1, stall)
        else:
            start2 = start1
        # fill from flash (virgin pages skip the read), then cache-DRAM
        ppn = int(f["l2p"][page])
        flash_done = _hil_read(cfg, p, f, start2, ppn) if ppn >= 0 else start2
        fill_done = max(flash_done, dram_busy) + p["page_xfer"]
        # MSHR insert (dict semantics: existing key overwrites) + expiry
        slot = m_idx if m_exists else int(torch.argmin(mpage))
        mpage[slot] = page
        mready[slot] = fill_done
        kill2 = mready <= t
        mpage[kill2] = FREE
        mready[kill2] = BIG
        frames[vic] = (ctr << STAMP_SHIFT) | pfield | int(wr)
    elif (coalesce and wr and resident) or hit:
        # touch (hit / coalesced store): LRU restamps, FIFO keeps the stamp
        stamp = ctr << STAMP_SHIFT if p["is_lru"] else old & STAMP_FIELD
        frames[fidx] = stamp | pfield | ((old & 1) | int(wr))

    if hit:
        md["dram_busy"].fill_(xdone)
    elif miss:
        md["dram_busy"].fill_(fill_done)
    hit_lat = p["hit_lat"]
    if coalesce:
        ret = t + hit_lat if wr else m_ready + hit_lat
    elif hit:
        if wr:
            ret = t + p["pack10"] if posted else t + hit_lat
        else:
            ret = max(xdone, t + hit_lat)
    else:
        ret = start2 + hit_lat if wr else fill_done + hit_lat
    return max(t, ret), {"hit": hit, "evict": do_wb, "miss": miss,
                         "coalesce": coalesce, "stall": stalled,
                         "eviction": evicted}


_STEPS = {DRAM: _dram_step, PMEM: _pmem_step, SSD_BUF: _buf_step,
          SSD_CACHE: _cache_step}


# -------------------------------------------------------------- state init
def flash_init(cfg: StackConfig, device) -> Dict:
    """One flash instance's state (one :class:`HIL`: FTL map + write pointer
    + free pool, PAL die/channel busy-until) on ``device``."""
    C, D = cfg.channels, cfg.dies_per_channel

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    f = {
        "l2p": torch.full((cfg.num_pages,), -1, dtype=torch.int32,
                          device=device),
        "wpb": i64(0), "wpp": i64(0),
        "die_busy": torch.zeros(C * D, dtype=torch.int64, device=device),
        "die_prog": torch.zeros(C * D, dtype=torch.int64, device=device),
        "chan_busy": torch.zeros(C, dtype=torch.int64, device=device),
    }
    if cfg.gc:
        nb = cfg.num_blocks
        blocks = torch.arange(nb, dtype=torch.int32, device=device)
        f.update({
            # free_blocks = deque(1..nb-1): slot nb-1 is initially unused
            "free_q": torch.where(blocks < nb - 1, blocks + 1, 0).to(
                torch.int32),
            "fq_head": i64(0),
            "fq_count": i64(nb - 1),
            "free_mask": blocks >= 1,
            "p2l": torch.full((nb * cfg.pages_per_block,), FREE,
                              dtype=torch.int32, device=device),
            "valid": torch.zeros(nb, dtype=torch.int32, device=device),
            "gcs": i64(0),
            "bad": torch.tensor(False, device=device),
        })
    else:
        f["nfree"] = i64(1)
    if cfg.faults:
        # deterministic NAND faults: in-state read / erase sequence numbers
        # (the PAL / FTL twins), retry and retirement totals, retired mask
        f["rd_seq"] = i64(0)
        f["c_rr"] = i64(0)
        if cfg.gc:
            f["er_seq"] = i64(0)
            f["rtr_mask"] = torch.zeros(cfg.num_blocks, dtype=torch.bool,
                                        device=device)
            f["c_rb"] = i64(0)
    if cfg.counters:
        # FTL.stats twins (host vs GC traffic); gc_runs rides on "gcs"
        f["c_hr"] = i64(0)
        f["c_hw"] = i64(0)
        if cfg.gc:
            f["c_gw"] = i64(0)
            f["c_ge"] = i64(0)
    return f


def media_init(cfg: StackConfig, device) -> Dict:
    """One front end's private state (no flash — see :func:`flash_init`)."""
    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.int64, device=device)

    if cfg.kind == DRAM:
        return {"busy": i64(0)}
    if cfg.kind == PMEM:
        return {"busy": i64(0), "row": i64(-1)}
    if cfg.kind == SSD_BUF:
        return {"frames": full(cfg.buf_entries, -1)}
    if cfg.kind == SSD_CACHE:
        return {"frames": full(cfg.cache_frames, -1),
                "mpage": full(cfg.mshr_entries, FREE),
                "mready": full(cfg.mshr_entries, BIG),
                "wtick": full(cfg.wb_slots, FREE),
                "dram_busy": i64(0)}
    raise ValueError(cfg.kind)


def init_state(cfg: StackConfig, device="cpu") -> Dict:
    """``{"media": ..., "flash": ...}`` of one single-host stack on
    ``device`` (``flash`` is ``None`` for flash-less kinds): one lane and
    no lane axis.  The multi-host replay's state is :func:`init_lanes`."""
    return {"media": media_init(cfg, device),
            "flash": flash_init(cfg, device) if has_flash(cfg) else None}


def init_lanes(cfg: StackConfig, num_devs: int, n_flash: int,
               device="cpu") -> Dict:
    """The multi-host replay's state: every tensor of :func:`init_state`
    with a leading lane axis, ``num_devs`` media lanes (one per mounted or
    pooled device) and ``n_flash`` flash lanes (one per distinct HIL:
    fewer than ``num_devs`` when front ends share one flash).  ``flash``
    is ``None`` for flash-less kinds."""
    def stacked(parts):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    flash = None
    if has_flash(cfg):
        flash = stacked([flash_init(cfg, device) for _ in range(n_flash)])
    return {"media": stacked([media_init(cfg, device)
                              for _ in range(num_devs)]),
            "flash": flash}


def capacity_frames(cfg: StackConfig, cap: int, device="cpu") -> torch.Tensor:
    """The initial frames of a cache lane of ``cap`` frames in a sweep
    (the JAX package's ``sweep.py`` :63-68): the cache's ``cache_frames``
    words, the first ``cap`` free and the rest :data:`DISABLED`."""
    idx = torch.arange(cfg.cache_frames, device=device)
    return torch.where(idx < int(cap), FREE, DISABLED)


def _stacked(parts) -> Dict:
    """States (``init_state`` / ``init_lanes`` dicts) with a new leading
    lane axis."""
    def part(name):
        if parts[0][name] is None:
            return None
        return {k: torch.stack([p[name][k] for p in parts])
                for k in parts[0][name]}

    return {"media": part("media"), "flash": part("flash")}


def init_sweep(cfg: StackConfig, caps, device="cpu") -> Dict:
    """The state of a single-host sweep: one :func:`init_state` a lane
    with a leading lane axis, lane *k*'s cache frames those of capacity
    ``caps[k]`` (:func:`capacity_frames`)."""
    state = _stacked([init_state(cfg, device) for _ in caps])
    if cfg.kind == SSD_CACHE:
        state["media"]["frames"] = torch.stack(
            [capacity_frames(cfg, c, device) for c in caps])
    return state


def init_multi_sweep(cfg: StackConfig, lanes: int, num_devs: int,
                     n_flash: int, device="cpu") -> Dict:
    """The state of a multi-host sweep: one :func:`init_lanes` a lane,
    with a leading lane axis."""
    return _stacked([init_lanes(cfg, num_devs, n_flash, device)
                     for _ in range(lanes)])


def lane(part: Optional[Dict], i: int) -> Optional[Dict]:
    """Lane ``i`` of a lane-stacked media or flash dict, as views: the
    in-place steps of :func:`media_step` write through to the stack."""
    return None if part is None else {k: v[i] for k, v in part.items()}


def media_step(cfg: StackConfig, p: Dict, md: Dict, f: Optional[Dict], t: int,
               addr: int, wr: bool, posted: bool, ctr: int):
    """One access against one (media, flash) lane pair, in place.  Returns
    ``(done, extras)`` where ``extras`` is a per-kind dict of event flags
    (``hit``/``evict``/``miss``/``coalesce``/``stall``/...)."""
    return _STEPS[cfg.kind](cfg, p, md, f, t, addr, wr, posted, ctr)


def step(cfg: StackConfig, p: Dict, state: Dict, access: Dict) -> Dict:
    """One access against ``state``, updated in place.

    ``access`` keys: ``t`` (arrival tick after transport), ``addr``,
    ``write``, ``posted``, ``ctr`` (monotone stamp), all Python ints or
    bools.  Returns ``out`` with ``done`` (completion tick), ``hit`` and
    ``evict`` and the kind's event flags."""
    done, ex = media_step(cfg, p, state["media"], state["flash"],
                          access["t"], access["addr"], access["write"],
                          access["posted"], access["ctr"])
    return {**ex, "done": done, "hit": ex.get("hit", False),
            "evict": ex.get("evict", False)}


def flash_health(state: Dict) -> Tuple[bool, int]:
    """``(bad, gc_runs)`` over every flash lane — ``bad`` is the sticky
    certify-or-refuse bit of any lane, ``gc_runs`` the lanes' GC runs
    summed (both zero for flash-less or log-append stacks)."""
    flash = state["flash"]
    if flash is None or "bad" not in flash:
        return False, 0
    return bool(flash["bad"].any()), int(flash["gcs"].sum())


def flash_counters(state: Dict):
    """:data:`~repro_torch.core.replay.metrics.FLASH_COUNTERS` of each
    flash lane, an ``(n_flash, 5)`` list (``(1, 5)`` for a single-host
    stack) — ``None`` when the stack carries no counters
    (``StackConfig.counters=False``) or no flash at all."""
    flash = state["flash"]
    if flash is None or "c_hr" not in flash:
        return None
    z = torch.zeros_like(flash["c_hr"])
    cols = [flash.get(k, z) for k in ("c_hr", "c_hw", "c_gw", "c_ge", "gcs")]
    return torch.stack(cols, -1).reshape(-1, 5).tolist()


def fault_counters(state: Dict) -> Tuple[int, int]:
    """``(nand_read_retries, retired_blocks)`` summed over the flash lanes
    — kept out of :func:`flash_counters` so the pinned metrics shape is
    untouched; both zero for stacks built without NAND fault statics."""
    flash = state["flash"]
    if flash is None or "c_rr" not in flash:
        return 0, 0
    retired = int(flash["c_rb"].sum()) if "c_rb" in flash else 0
    return int(flash["c_rr"].sum()), retired
