"""Vectorized set-associative cache simulation over tensors.

Given an address trace (page ids + write flags), replay a set-associative
cache with LRU / FIFO / Direct replacement and produce per-access hit flags
plus eviction traffic.  On a CUDA tensor the replay is the ``cache_sim``
kernel of :mod:`repro_torch.kernels.cache_sim`; on a CPU tensor it is that
kernel's plain PyTorch version.  Both are validated against the pure-Python
policy objects (:mod:`repro_torch.core.cache.policies`).

Note 2Q / LFRU keep variable-length queue metadata and are simulated via the
object model only; Direct/LRU/FIFO (the set-friendly policies) get the
vectorized fast path.  This mirrors hardware reality: tag+timestamp updates
are what a cache controller does per access.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import torch_device as _td
from repro_torch.kernels.cache_sim import cache_sim


@dataclass
class TraceCacheSim:
    num_sets: int
    ways: int
    policy: str = "lru"  # 'lru' | 'fifo' | 'direct'
    torch_device: str = "cuda"   # where numpy/list traces are replayed

    def __post_init__(self) -> None:
        if self.policy not in ("lru", "fifo", "direct"):
            raise ValueError(f"vectorized sim supports lru/fifo/direct, got {self.policy}")
        if self.policy == "direct" and self.ways != 1:
            raise ValueError("direct-mapped requires ways == 1")

    def init_state(self):
        dev = _td.resolve(self.torch_device)
        shape = (self.num_sets, self.ways)
        return (
            torch.full(shape, -1, dtype=torch.int32, device=dev),  # tags (-1 = invalid)
            torch.zeros(shape, dtype=torch.int32, device=dev),     # meta: LRU ts / FIFO insert ts
            torch.zeros(shape, dtype=torch.bool, device=dev),      # dirty
        )

    def run(self, pages, is_write):
        """Replay a trace. Returns (hits[N] bool, dirty_evicts[N] bool, state).

        Tensors replay where they lie; anything else goes to
        ``torch_device`` first."""
        pages = _as_tensor(pages, self.torch_device)
        is_write = _as_tensor(is_write, pages.device).to(torch.bool)
        return _run_trace(pages, is_write, self.num_sets, self.ways,
                          self.policy == "lru")


def _as_tensor(x, torch_device):
    # page ids keep their integer type: the kernel wrapper range-checks
    # them before narrowing to int32
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=_td.resolve(torch_device))


def _run_trace(pages, is_write, num_sets: int, ways: int, is_lru: bool):
    # direct-mapped is LRU with one way: the policies only differ on hits
    policy = "lru" if is_lru else "fifo"
    hits, evicts, state = cache_sim(pages, is_write, num_sets=num_sets,
                                    ways=ways, policy=policy,
                                    return_state=True)
    return hits, evicts, state


def simulate_trace(pages, is_write, *, num_sets: int, ways: int,
                   policy: str = "lru", torch_device: str = "cuda") -> dict:
    """Convenience wrapper returning plain-numpy summary statistics."""
    sim = TraceCacheSim(num_sets=num_sets, ways=ways, policy=policy,
                        torch_device=torch_device)
    hits, evicts, _ = sim.run(pages, is_write)
    hits = hits.cpu().numpy()
    evicts = evicts.cpu().numpy()
    return {
        "accesses": int(hits.size),
        "hits": int(hits.sum()),
        "hit_rate": float(hits.mean()) if hits.size else 0.0,
        "dirty_evictions": int(evicts.sum()),
        "hit_flags": hits,
        "dirty_evict_flags": evicts,
    }
