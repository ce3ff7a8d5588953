"""Fused replay lanes of the port.

This slice has the kernel lane for the cached CXL-SSD
(:mod:`repro_torch.core.replay.cuda_engine`, ``engine="cuda"``), the
trace validation it shares with later lanes (:mod:`.spec`) and the result
type (:mod:`.engine`).  The scan, associative, multi-host, metrics, sweep
and streaming lanes are later slices (see ROADMAP.md)."""

from repro_torch.core.replay.engine import ReplayResult
from repro_torch.core.replay.spec import (
    ReplayUnsupported,
    require_metrics_lane,
    trace_to_arrays,
    validate_block_size,
)

__all__ = ["ReplayResult", "ReplayUnsupported", "require_metrics_lane",
           "trace_to_arrays", "validate_block_size"]
