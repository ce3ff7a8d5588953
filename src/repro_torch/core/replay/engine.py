"""Result type of the fused replay lanes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.workloads.driver import TraceResult


@dataclass
class ReplayResult(TraceResult):
    """A :class:`TraceResult` plus the per-access arrays the fused lane
    produces for free (numpy, on the host)."""

    latency_ticks: Optional[np.ndarray] = None   # done - issue, per access
    hit_flags: Optional[np.ndarray] = None
    evict_flags: Optional[np.ndarray] = None

    @property
    def hits(self) -> int:
        return int(self.hit_flags.sum()) if self.hit_flags is not None else 0
