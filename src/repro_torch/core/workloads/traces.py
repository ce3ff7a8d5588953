"""Seeded synthetic traces.

``make_trace`` is the generator of the golden scenarios (uniform pages,
random 64 B line offsets, a write fraction), so a trace pinned there can be
re-derived here from its seed; ``hash_seed`` is the scenarios' stable
per-name seed."""

from __future__ import annotations

import numpy as np


def make_trace(seed: int, n: int = 160, pages: int = 24,
               write_frac: float = 0.3):
    """``n`` 64 B accesses ``[(addr, 64, write)]`` over ``pages`` 4 KB
    pages, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, pages, n) * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < write_frac
    return [(int(a), 64, bool(w)) for a, w in zip(addrs, writes)]


def hash_seed(name: str) -> int:
    """Stable small per-scenario trace seed (NOT Python's randomized
    ``hash``)."""
    return sum(ord(c) for c in name) % 997
