from repro_torch.core.cache.policies import (
    POLICIES,
    CachePolicy,
    DirectPolicy,
    FIFOPolicy,
    LFRUPolicy,
    LRUPolicy,
    TwoQPolicy,
    make_policy,
)
from repro_torch.core.cache.dram_cache import DRAMCache, DRAMCacheConfig

__all__ = [
    "POLICIES",
    "CachePolicy",
    "DirectPolicy",
    "FIFOPolicy",
    "LFRUPolicy",
    "LRUPolicy",
    "TwoQPolicy",
    "make_policy",
    "DRAMCache",
    "DRAMCacheConfig",
    "TraceCacheSim",
    "simulate_trace",
]


def __getattr__(name):
    # The tensor replay imports torch; the device models and the python
    # driver lane do not need it, so it loads on first use.
    if name in ("TraceCacheSim", "simulate_trace"):
        from repro_torch.core.cache import trace_sim
        return getattr(trace_sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
