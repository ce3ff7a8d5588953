"""Trace validation and lane refusals shared by the port's fused lanes.

Only the pieces the kernel lane needs are here; the device-stack extraction
(``StackConfig``, ``build_stack``) belongs to the scan slice."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class ReplayUnsupported(ValueError):
    """The device/trace combination has no exact fused fast path.

    Every fast lane raises this instead of ever diverging silently; the
    message names the widest lane that still covers the shape.  In this
    slice the ladder is ``python`` (everything) > ``cuda`` (the cached
    CXL-SSD with an LRU, FIFO or direct-mapped cache).
    """


def validate_block_size(block_size) -> int:
    """Blocked-replay knob of the scan lane (``block_size`` accesses per
    sequential step).  Any block size is tick-identical there; here it is
    only validated, since no lane of this slice blocks."""
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size!r}")
    return b


def require_metrics_lane(engine: str) -> None:
    """Certify-or-refuse for telemetry: the kernel lane has no per-access
    carry slot for the metrics accumulators, so it refuses *explicitly*
    rather than returning a result with no (or wrong) metrics."""
    if engine in ("assoc", "pallas", "cuda"):
        raise ReplayUnsupported(
            f"engine {engine!r} cannot carry in-scan metrics; use "
            "engine='scan' (or 'python'), or drop metrics collection")


def trace_to_arrays(trace, *, line: int = 64) -> Tuple[np.ndarray, np.ndarray, int]:
    """Validate a ``[(addr, size, write)]`` trace for the fused fast path.

    Returns ``(addrs int64, writes bool, size)``.  Requires a uniform access
    size that stays inside one 64 B line (the vectorized step services
    exactly one cache line per access, like the drivers' typical traces)."""
    rows = list(trace)
    if not rows:
        raise ReplayUnsupported("empty trace")
    addrs = np.asarray([r[0] for r in rows], np.int64)
    sizes = np.asarray([r[1] for r in rows], np.int64)
    writes = np.asarray([r[2] for r in rows], bool)
    size = int(sizes[0])
    if not (sizes == size).all():
        raise ReplayUnsupported("fused replay needs a uniform access size")
    if size < 1 or ((addrs % line) + size > line).any():
        raise ReplayUnsupported(
            "fused replay needs accesses contained in one 64 B line")
    if (addrs < 0).any():
        raise ReplayUnsupported("negative addresses")
    return addrs, writes, size
