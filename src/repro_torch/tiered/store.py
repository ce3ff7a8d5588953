"""TieredStore — the paper's DRAM cache over a CXL-SSD, lifted to model
serving: a page pool on the card in front of a large capacity tier.

The same replacement policies that run inside the simulated DRAM cache
(:mod:`repro_torch.core.cache.policies`: direct, LRU, FIFO, 2Q, LFRU)
decide which model pages stay resident on the card, for example KV
segments of long-context decode (one ring-buffer segment's tokens for all
layers).  The capacity tier is host memory (numpy); with a backing device
from :mod:`repro_torch.core.devices` attached, every miss and writeback
also advances a simulated device clock (``sim_ticks``), so a run reports
the CXL-SSD time the cache layer absorbed.  Duplicate fetches within one
request are coalesced (the MSHR analogue).

Page movement on the card goes through the hand-written page kernels:
each batch of fills is one host-to-card copy and one ``page_scatter``,
each read one ``page_gather``, each writeback one card-to-host copy.  The
bookkeeping (counters, ``sim_ticks``, the order of backing-device calls)
is the JAX package's ``repro.tiered.store`` step for step, including two
of its behaviours: fills of one call that land in the same slot leave the
last page there for every page of that call (``hbm_pages=1``:
``read_pages([0, 1])`` returns page 1 twice), and a dirty page evicted by
a fill is written back from its slot before that call's scatter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache.policies import CachePolicy, make_policy
from repro_torch.core.devices import MemDevice
from repro_torch.core.engine import to_us
from repro_torch.kernels.ops import page_gather_op, page_scatter_op
from repro_torch.torch_device import resolve


@dataclass
class TieredStoreConfig:
    n_logical_pages: int
    page_shape: Tuple[int, ...]
    hbm_pages: int
    policy: str = "lru"
    dtype: str = "float32"          # a numpy dtype name (host capacity tier)
    writeback: bool = True          # dirty pages flush to the capacity tier


class TieredStore:
    def __init__(self, cfg: TieredStoreConfig,
                 backing: Optional[MemDevice] = None,
                 torch_device="cuda") -> None:
        if cfg.hbm_pages < 1:
            raise ValueError("need at least one HBM page")
        self.cfg = cfg
        self.device = resolve(torch_device)
        try:
            dtype = np.dtype(cfg.dtype)
        except TypeError as e:
            raise ValueError(f"dtype {cfg.dtype!r} has no numpy form for "
                             "the host capacity tier") from e
        self.page_elems = int(np.prod(cfg.page_shape))
        self.page_bytes = self.page_elems * dtype.itemsize
        # capacity tier ("CXL-SSD"): host numpy
        self._capacity = np.zeros((cfg.n_logical_pages,) + tuple(cfg.page_shape),
                                  dtype)
        # pool on the card + mapping
        self.pool = torch.zeros((cfg.hbm_pages,) + tuple(cfg.page_shape),
                                dtype=torch.from_numpy(self._capacity[:0]).dtype,
                                device=self.device)
        self.policy: CachePolicy = make_policy(cfg.policy, cfg.hbm_pages)
        self._slot_of: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(cfg.hbm_pages))
        self.backing = backing
        self.sim_ticks = 0            # simulated capacity-tier clock
        self.stats = {"reads": 0, "hits": 0, "misses": 0, "coalesced": 0,
                      "fills": 0, "writebacks": 0,
                      "bytes_in": 0, "bytes_out": 0}

    # ------------------------------------------------------------ internals
    def _sim_access(self, lpn: int, write: bool) -> None:
        if self.backing is not None:
            self.sim_ticks = max(self.sim_ticks, self.backing.service(
                self.sim_ticks, lpn * self.page_bytes, self.page_bytes, write))

    def _evict_for(self, lpn: int, dirty: bool) -> int:
        """Insert lpn into the policy; return the pool slot it may use."""
        ev = self.policy.insert(lpn, dirty=dirty)
        if ev is not None:
            slot = self._slot_of.pop(ev.page)
            if ev.dirty and self.cfg.writeback:
                # flush the evicted page back to the capacity tier
                self._capacity[ev.page] = self.pool[slot].cpu().numpy()
                self._sim_access(ev.page, write=True)
                self.stats["writebacks"] += 1
                self.stats["bytes_out"] += self.page_bytes
        else:
            slot = self._free_slots.pop()
        return slot

    # ------------------------------------------------------------------ api
    def write_page(self, lpn: int, data: np.ndarray, through: bool = False) -> None:
        """Store a page into the capacity tier (e.g. an evicted KV segment
        or an expert's weights).  ``through=True`` also caches it on the
        card."""
        self._capacity[lpn] = np.asarray(data, self._capacity.dtype)
        self._sim_access(lpn, write=True)
        if through:
            self.ensure_resident([lpn], dirty=False)

    def ensure_resident(self, lpns: Sequence[int], dirty: bool = False
                        ) -> torch.Tensor:
        """Make pages resident on the card; returns their pool slots (an
        int32 tensor on the host).

        Duplicates within the request are coalesced (MSHR analogue): a page
        is fetched from the capacity tier at most once.
        """
        slots = np.zeros(len(lpns), np.int32)
        seen: Dict[int, int] = {}
        fill_slots: List[int] = []
        fill_pages: List[np.ndarray] = []
        for i, lpn in enumerate(lpns):
            lpn = int(lpn)
            self.stats["reads"] += 1
            if lpn in seen:
                self.stats["coalesced"] += 1
                slots[i] = seen[lpn]
                continue
            if self.policy.lookup(lpn):
                self.stats["hits"] += 1
                self.policy.touch(lpn, dirty=dirty)
                slot = self._slot_of[lpn]
            else:
                self.stats["misses"] += 1
                self.stats["fills"] += 1
                self.stats["bytes_in"] += self.page_bytes
                self._sim_access(lpn, write=False)
                slot = self._evict_for(lpn, dirty)
                self._slot_of[lpn] = slot
                fill_slots.append(slot)
                fill_pages.append(self._capacity[lpn])
            seen[lpn] = slot
            slots[i] = slot
        if fill_slots:
            pages = torch.from_numpy(np.stack(fill_pages)).to(self.device)
            self.pool = page_scatter_op(
                self.pool, torch.tensor(fill_slots, dtype=torch.int32), pages)
        return torch.from_numpy(slots)

    def read_pages(self, lpns: Sequence[int]) -> torch.Tensor:
        """Resident-or-fetched gather: returns (n, *page_shape) from the
        card's pool."""
        slots = self.ensure_resident(lpns)
        return page_gather_op(self.pool, slots)

    def update_page(self, lpn: int, data) -> None:
        """Write-back update of a resident page (dirty bit set)."""
        slots = self.ensure_resident([lpn], dirty=True)
        page = torch.as_tensor(data, dtype=self.pool.dtype,
                               device=self.device)
        self.pool = page_scatter_op(self.pool, slots, page[None])
        self.policy.touch(int(lpn), dirty=True)

    def flush(self) -> None:
        for lpn in sorted(self.policy.resident_pages()):
            if self.policy.is_dirty(lpn):
                slot = self._slot_of[lpn]
                self._capacity[lpn] = self.pool[slot].cpu().numpy()
                self._sim_access(lpn, write=True)
                self.stats["writebacks"] += 1

    # ------------------------------------------------------------- metrics
    @property
    def hit_rate(self) -> float:
        tot = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / tot if tot else 0.0

    @property
    def sim_time_us(self) -> float:
        """Simulated capacity-tier (CXL-SSD) time spent on misses/flushes."""
        return to_us(self.sim_ticks)

    def capacity_page(self, lpn: int) -> np.ndarray:
        return self._capacity[lpn]
