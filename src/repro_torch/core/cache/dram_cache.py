"""DRAM cache layer in front of the CXL-SSD (paper §II-C).

* 4 KB pages with valid + dirty bits, write-back / write-allocate;
* an MSHR table that coalesces overlapping 64 B requests targeting the same
  in-flight 4 KB page ("avoiding redundant SSD reads and reducing data
  traffic");
* pluggable replacement policy (the five of :mod:`repro_torch.core.cache.policies`);
* a bounded writeback buffer so dirty evictions drain to flash in the
  background instead of serializing with demand fills.

Latency/occupancy accounting is analytic (busy-until), identical in style to
the PAL: a DRAM-cache hit costs the paper's 50 ns; a fill occupies the cache
DRAM for a 4 KB transfer at DDR4 bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.cache.policies import CachePolicy, make_policy
from repro_torch.core.engine import ns
from repro_torch.core.ssd.hil import HIL

PAGE_BYTES = 4096
LINE_BYTES = 64


@dataclass
class DRAMCacheConfig:
    capacity_bytes: int = 16 << 20      # Table I: 16 MB
    policy: str = "lru"
    hit_latency_ns: float = 50.0        # Table I: DRAM cache access 50 ns
    dram_bw_gbps: float = 19.2          # DDR4-2400 single channel
    mshr_entries: int = 16
    writeback_buffer: int = 8

    @property
    def capacity_pages(self) -> int:
        return self.capacity_bytes // PAGE_BYTES


@dataclass
class _MSHREntry:
    page: int
    ready_tick: int
    coalesced: int = 0


class DRAMCache:
    """Write-back, write-allocate page cache backed by a SimpleSSD HIL."""

    def __init__(self, cfg: DRAMCacheConfig, ssd: HIL) -> None:
        self.cfg = cfg
        self.ssd = ssd
        self.policy: CachePolicy = make_policy(cfg.policy, cfg.capacity_pages)
        self._mshr: Dict[int, _MSHREntry] = {}
        self._wb_drain_tick = 0          # when the writeback buffer has room
        self._wb_inflight: list[int] = []  # completion ticks of queued writebacks
        self._dram_busy_until = 0
        self.stats = {
            "accesses": 0, "reads": 0, "writes": 0,
            "mshr_coalesced": 0, "mshr_stalls": 0,
            "fills": 0, "writebacks": 0,
        }

    # ------------------------------------------------------------- internals
    def _page_of(self, addr: int) -> int:
        return addr // PAGE_BYTES

    def _dram_xfer(self, now: int, nbytes: int) -> int:
        """Occupy cache-DRAM bandwidth; returns completion tick."""
        per_byte_ns = 1.0 / self.cfg.dram_bw_gbps  # ns per byte at GB/s
        start = max(now, self._dram_busy_until)
        done = start + ns(nbytes * per_byte_ns)
        self._dram_busy_until = done
        return done

    def _reap_writebacks(self, now: int) -> None:
        self._wb_inflight = [t for t in self._wb_inflight if t > now]

    def _queue_writeback(self, now: int, page: int) -> int:
        """Dirty eviction → background write to flash. Returns the tick at
        which the *demand path* may proceed (stall only if buffer full)."""
        self._reap_writebacks(now)
        stall_until = now
        if len(self._wb_inflight) >= self.cfg.writeback_buffer:
            stall_until = min(self._wb_inflight)
            self._reap_writebacks(stall_until)
        done = self.ssd.write(stall_until, page * PAGE_BYTES, PAGE_BYTES)
        self._wb_inflight.append(done)
        self.stats["writebacks"] += 1
        return stall_until

    # ------------------------------------------------------------------ api
    def access(self, now: int, addr: int, write: bool,
               posted: bool = False) -> int:
        """A 64 B access; returns completion tick (write-back semantics: a
        write completes when it lands in the DRAM cache).  ``posted`` writes
        return at queue-accept time; internal state (fills, writebacks,
        busy-until) advances identically either way."""
        self.stats["accesses"] += 1
        self.stats["writes" if write else "reads"] += 1
        page = self._page_of(addr)

        # In-flight fill → MSHR coalescing: ride the existing SSD read.  This
        # must be checked *before* residency — write-allocate inserts the
        # frame at miss time, but its data isn't in the cache DRAM until the
        # fill lands.
        ent = self._mshr.get(page)
        if ent is not None and ent.ready_tick > now:
            ent.coalesced += 1
            self.stats["mshr_coalesced"] += 1
            if write:
                # the store's line merges into the MSHR — ack now.  (Under a
                # direct-mapped policy a conflicting insert may have evicted
                # the frame while this fill was in flight; only mark dirty if
                # still resident.)
                if self.policy.lookup(page):
                    self.policy.touch(page, dirty=True)
                return now + ns(self.cfg.hit_latency_ns)
            return max(ent.ready_tick, now) + ns(self.cfg.hit_latency_ns)

        # Resident → hit at DRAM-cache latency.
        if self.policy.lookup(page):
            self.policy.hits += 1
            self.policy.touch(page, dirty=write)
            done = self._dram_xfer(now, LINE_BYTES)
            if write and posted:
                return now + ns(10.0)
            return max(done, now + ns(self.cfg.hit_latency_ns)) if not write \
                else now + ns(self.cfg.hit_latency_ns)

        # Miss → allocate MSHR (stall if the table is full).
        self.policy.misses += 1
        start = now
        if len(self._mshr) >= self.cfg.mshr_entries:
            self.stats["mshr_stalls"] += 1
            victim_ready = min(e.ready_tick for e in self._mshr.values())
            self._expire_mshrs(victim_ready)
            start = max(start, victim_ready)

        # Write-allocate: evict (write back if dirty), then fill from flash.
        ev = self.policy.insert(page, dirty=write)
        if ev is not None:
            self.policy.evictions += 1
            if ev.dirty:
                self.policy.dirty_evictions += 1
                start = max(start, self._queue_writeback(start, ev.page))

        self.stats["fills"] += 1
        if self.ssd.is_written(page * PAGE_BYTES):
            flash_done = self.ssd.read(start, page * PAGE_BYTES, PAGE_BYTES)
        else:
            flash_done = start  # virgin page: no flash read needed
        fill_done = self._dram_xfer(flash_done, PAGE_BYTES)
        self._mshr[page] = _MSHREntry(page=page, ready_tick=fill_done)
        self._expire_mshrs(now)
        if write:
            # write-allocate: the line lands in the fill buffer; ack at
            # cache latency (persistence domain = powered DRAM cache).
            return max(start, now) + ns(self.cfg.hit_latency_ns)
        return fill_done + ns(self.cfg.hit_latency_ns)

    def _expire_mshrs(self, now: int) -> None:
        for p in [p for p, e in self._mshr.items() if e.ready_tick <= now]:
            del self._mshr[p]

    def flush(self, now: int) -> int:
        """Write back all dirty pages (shutdown/persist); returns tick."""
        t = now
        for page in sorted(self.policy.resident_pages()):
            if self.policy.is_dirty(page):
                t = max(t, self.ssd.write(t, page * PAGE_BYTES, PAGE_BYTES))
        return t

    @property
    def hit_rate(self) -> float:
        return self.policy.hit_rate
