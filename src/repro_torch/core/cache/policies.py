"""The five replacement policies of CXL-SSD-Sim (paper §II-C).

``Direct`` (direct-mapped), ``LRU``, ``FIFO``, ``2Q`` and ``LFRU``.

These classes are the *shared* policy engine: the DRAM-cache model of the
simulator (:mod:`repro_torch.core.cache.dram_cache`) and the tiered-memory
runtime (a later slice of this package) both instantiate them, which is the
point of the reproduction — the replacement policy that manages 4 KB DRAM pages in
front of an SSD is the same object that manages KV/expert pages in HBM in
front of a capacity tier.

The interface is fully associative at the policy level and keyed by page id;
set-associativity (for ``Direct`` and the vectorized simulators) is layered
on top by the caller.  All operations are O(1) (ordered-dict / heap-free
designs) so multi-million-access traces stay cheap in pure Python, and the
vectorized replay (:mod:`repro_torch.core.cache.trace_sim` and the CUDA
kernel of :mod:`repro_torch.kernels.cache_sim`) is validated against these
as oracles.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class EvictionResult:
    page: int
    dirty: bool


class CachePolicy:
    """Abstract policy over a fixed number of page frames."""

    name = "abstract"

    def __init__(self, capacity_pages: int) -> None:
        if capacity_pages <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity_pages
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dirty_evictions = 0

    # -- interface ---------------------------------------------------------
    def lookup(self, page: int) -> bool:
        raise NotImplementedError

    def touch(self, page: int, dirty: bool = False) -> None:
        """Record an access to a resident page."""
        raise NotImplementedError

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        """Insert a page, evicting if full; returns the eviction, if any."""
        raise NotImplementedError

    def invalidate(self, page: int) -> bool:
        """Drop a page without writeback; True if it was resident."""
        raise NotImplementedError

    def is_dirty(self, page: int) -> bool:
        raise NotImplementedError

    def resident_pages(self) -> set[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.resident_pages())

    # -- convenience -------------------------------------------------------
    def access(self, page: int, write: bool = False) -> tuple[bool, Optional[EvictionResult]]:
        """Full access path: returns (hit, eviction)."""
        if self.lookup(page):
            self.hits += 1
            self.touch(page, dirty=write)
            return True, None
        self.misses += 1
        ev = self.insert(page, dirty=write)
        if ev is not None:
            self.evictions += 1
            if ev.dirty:
                self.dirty_evictions += 1
        return False, ev

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = self.dirty_evictions = 0


class LRUPolicy(CachePolicy):
    """Least Recently Used — an ordered dict with move-to-end on touch."""

    name = "lru"

    def __init__(self, capacity_pages: int) -> None:
        super().__init__(capacity_pages)
        self._map: OrderedDict[int, bool] = OrderedDict()  # page -> dirty

    def lookup(self, page: int) -> bool:
        return page in self._map

    def touch(self, page: int, dirty: bool = False) -> None:
        self._map[page] |= dirty
        self._map.move_to_end(page)

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        ev = None
        if len(self._map) >= self.capacity:
            victim, vdirty = self._map.popitem(last=False)
            ev = EvictionResult(victim, vdirty)
        self._map[page] = dirty
        return ev

    def invalidate(self, page: int) -> bool:
        return self._map.pop(page, None) is not None

    def is_dirty(self, page: int) -> bool:
        return self._map.get(page, False)

    def resident_pages(self) -> set[int]:
        return set(self._map)


class FIFOPolicy(CachePolicy):
    """First-In First-Out — insertion order only; touch does not promote."""

    name = "fifo"

    def __init__(self, capacity_pages: int) -> None:
        super().__init__(capacity_pages)
        self._map: OrderedDict[int, bool] = OrderedDict()

    def lookup(self, page: int) -> bool:
        return page in self._map

    def touch(self, page: int, dirty: bool = False) -> None:
        self._map[page] |= dirty  # no reordering: FIFO ignores recency

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        ev = None
        if len(self._map) >= self.capacity:
            victim, vdirty = self._map.popitem(last=False)
            ev = EvictionResult(victim, vdirty)
        self._map[page] = dirty
        return ev

    def invalidate(self, page: int) -> bool:
        return self._map.pop(page, None) is not None

    def is_dirty(self, page: int) -> bool:
        return self._map.get(page, False)

    def resident_pages(self) -> set[int]:
        return set(self._map)


class DirectPolicy(CachePolicy):
    """Direct-mapped: page p lives only in frame ``p % capacity``."""

    name = "direct"

    def __init__(self, capacity_pages: int) -> None:
        super().__init__(capacity_pages)
        self._frames: Dict[int, tuple[int, bool]] = {}  # frame -> (page, dirty)

    def _frame(self, page: int) -> int:
        return page % self.capacity

    def lookup(self, page: int) -> bool:
        entry = self._frames.get(self._frame(page))
        return entry is not None and entry[0] == page

    def touch(self, page: int, dirty: bool = False) -> None:
        f = self._frame(page)
        p, d = self._frames[f]
        assert p == page
        self._frames[f] = (p, d or dirty)

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        f = self._frame(page)
        ev = None
        if f in self._frames:
            vp, vd = self._frames[f]
            if vp != page:
                ev = EvictionResult(vp, vd)
        self._frames[f] = (page, dirty)
        return ev

    def invalidate(self, page: int) -> bool:
        f = self._frame(page)
        entry = self._frames.get(f)
        if entry is not None and entry[0] == page:
            del self._frames[f]
            return True
        return False

    def is_dirty(self, page: int) -> bool:
        entry = self._frames.get(self._frame(page))
        return bool(entry and entry[0] == page and entry[1])

    def resident_pages(self) -> set[int]:
        return {p for p, _ in self._frames.values()}


class TwoQPolicy(CachePolicy):
    """2Q (Johnson & Shasha '94, simplified full version).

    A1in: FIFO probation queue for first-touch pages (Kin = 25 % of frames).
    Am:   LRU queue for re-referenced pages.
    A1out: ghost FIFO of recently evicted probation pages (Kout = 50 % of
    frames, tags only).  A hit in A1out promotes straight into Am.
    """

    name = "2q"

    def __init__(self, capacity_pages: int, kin_frac: float = 0.25,
                 kout_frac: float = 0.5) -> None:
        super().__init__(capacity_pages)
        self.kin = max(1, int(capacity_pages * kin_frac))
        self.kout = max(1, int(capacity_pages * kout_frac))
        self._a1in: OrderedDict[int, bool] = OrderedDict()
        self._am: OrderedDict[int, bool] = OrderedDict()
        self._a1out: OrderedDict[int, None] = OrderedDict()  # ghosts

    def lookup(self, page: int) -> bool:
        return page in self._a1in or page in self._am

    def touch(self, page: int, dirty: bool = False) -> None:
        if page in self._am:
            self._am[page] |= dirty
            self._am.move_to_end(page)
        else:
            # A1in hit: stays in FIFO order (that's the 2Q rule — only an
            # A1out ghost hit promotes to Am).
            self._a1in[page] |= dirty

    def _evict_one(self) -> EvictionResult:
        if len(self._a1in) >= self.kin and self._a1in:
            victim, vd = self._a1in.popitem(last=False)
            self._a1out[victim] = None
            while len(self._a1out) > self.kout:
                self._a1out.popitem(last=False)
            return EvictionResult(victim, vd)
        if self._am:
            victim, vd = self._am.popitem(last=False)
            return EvictionResult(victim, vd)
        victim, vd = self._a1in.popitem(last=False)
        return EvictionResult(victim, vd)

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        ev = None
        if len(self._a1in) + len(self._am) >= self.capacity:
            ev = self._evict_one()
        if page in self._a1out:
            del self._a1out[page]
            self._am[page] = dirty
        else:
            self._a1in[page] = dirty
        return ev

    def invalidate(self, page: int) -> bool:
        if self._a1in.pop(page, None) is not None:
            return True
        return self._am.pop(page, None) is not None

    def is_dirty(self, page: int) -> bool:
        if page in self._a1in:
            return self._a1in[page]
        return self._am.get(page, False)

    def resident_pages(self) -> set[int]:
        return set(self._a1in) | set(self._am)


class LFRUPolicy(CachePolicy):
    """LFRU — Least Frequently Recently Used.

    Combines frequency and recency: victim = min over resident pages of
    ``(freq, last_use)``; frequency saturates and is halved on a sweep
    (aging) whenever an eviction happens with all-frequencies-high, so stale
    hot pages decay.  This matches the paper's description of LFRU as the
    frequency+recency hybrid among the five policies.
    """

    name = "lfru"

    def __init__(self, capacity_pages: int, freq_cap: int = 255) -> None:
        super().__init__(capacity_pages)
        self.freq_cap = freq_cap
        self._pages: Dict[int, list] = {}  # page -> [freq, last_use, dirty]
        self._clock = 0

    def lookup(self, page: int) -> bool:
        return page in self._pages

    def touch(self, page: int, dirty: bool = False) -> None:
        self._clock += 1
        ent = self._pages[page]
        ent[0] = min(ent[0] + 1, self.freq_cap)
        ent[1] = self._clock
        ent[2] = ent[2] or dirty

    def insert(self, page: int, dirty: bool = False) -> Optional[EvictionResult]:
        self._clock += 1
        ev = None
        if len(self._pages) >= self.capacity:
            victim = min(self._pages, key=lambda p: (self._pages[p][0], self._pages[p][1]))
            vf, _, vd = self._pages.pop(victim)
            ev = EvictionResult(victim, vd)
            if vf >= self.freq_cap // 2:  # aging sweep
                for ent in self._pages.values():
                    ent[0] >>= 1
        self._pages[page] = [1, self._clock, dirty]
        return ev

    def invalidate(self, page: int) -> bool:
        return self._pages.pop(page, None) is not None

    def is_dirty(self, page: int) -> bool:
        ent = self._pages.get(page)
        return bool(ent and ent[2])

    def resident_pages(self) -> set[int]:
        return set(self._pages)


POLICIES = {
    "direct": DirectPolicy,
    "lru": LRUPolicy,
    "fifo": FIFOPolicy,
    "2q": TwoQPolicy,
    "lfru": LFRUPolicy,
}


def make_policy(name: str, capacity_pages: int) -> CachePolicy:
    try:
        return POLICIES[name.lower()](capacity_pages)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; choose from {sorted(POLICIES)}") from None
