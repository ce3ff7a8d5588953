"""Straggler mitigation: a step-time watchdog.

At thousand-node scale, slow hosts (thermal throttling, failing NICs,
background daemons) stretch synchronous steps.  The watchdog keeps an EWMA
of step time, flags steps slower than ``threshold x EWMA``, attributes them
(in multi-process runs, via per-host timing exchange — here, per logical
shard), and drives two mitigations:

  * advisory: report offending hosts so the orchestrator can drain/replace
    them (the action at real scale);
  * in-run: after ``evict_after`` consecutive flags the launcher re-meshes
    without the slow host — exercised in tests through the elastic
    checkpoint-restore path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StragglerConfig:
    ewma_alpha: float = 0.1
    threshold: float = 2.0          # flag steps slower than 2x EWMA
    warmup_steps: int = 5           # ignore compile/first steps
    evict_after: int = 3            # consecutive flags before eviction advice


@dataclass
class StragglerReport:
    step: int
    duration_s: float
    ewma_s: float
    flagged: bool
    evict_advised: bool
    host: Optional[int] = None


class StragglerWatchdog:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()) -> None:
        self.cfg = cfg
        self.ewma: Optional[float] = None
        self.step = 0
        self._consecutive = 0
        self._t0: Optional[float] = None
        self.reports: List[StragglerReport] = []
        self.flagged_hosts: Dict[int, int] = {}

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, host: Optional[int] = None,
                 duration_s: Optional[float] = None) -> StragglerReport:
        if duration_s is None:
            assert self._t0 is not None, "start_step() not called"
            duration_s = time.perf_counter() - self._t0
        self.step += 1
        flagged = False
        evict = False
        if self.step <= self.cfg.warmup_steps or self.ewma is None:
            self.ewma = duration_s if self.ewma is None else (
                self.cfg.ewma_alpha * duration_s
                + (1 - self.cfg.ewma_alpha) * self.ewma)
        else:
            flagged = duration_s > self.cfg.threshold * self.ewma
            if flagged:
                self._consecutive += 1
                if host is not None:
                    self.flagged_hosts[host] = self.flagged_hosts.get(host, 0) + 1
                evict = self._consecutive >= self.cfg.evict_after
            else:
                self._consecutive = 0
                # only healthy steps update the EWMA (a straggler must not
                # drag the baseline up and mask itself)
                self.ewma = (self.cfg.ewma_alpha * duration_s
                             + (1 - self.cfg.ewma_alpha) * self.ewma)
        rep = StragglerReport(self.step, duration_s, float(self.ewma),
                              flagged, evict, host)
        self.reports.append(rep)
        return rep

    def worst_hosts(self, k: int = 3) -> List[int]:
        return sorted(self.flagged_hosts, key=self.flagged_hosts.get,
                      reverse=True)[:k]
