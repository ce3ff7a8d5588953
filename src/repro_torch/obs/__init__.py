"""Observability exports for replay telemetry.

Thin, dependency-free façade over :mod:`repro_torch.core.replay.metrics`:
configure a run with :class:`MetricsSpec`, get a :class:`MetricsBundle`
back on the result (``result.metrics``), and render it to a Chrome/Perfetto
``trace_events`` JSON with :func:`to_perfetto` / :func:`write_perfetto`
(open in https://ui.perfetto.dev or ``chrome://tracing``).
"""

from repro_torch.core.replay.metrics import (
    MetricsBundle,
    MetricsSpec,
    bucket_bounds,
    percentile_from_hist,
)
from repro_torch.obs.export import to_perfetto, write_perfetto

__all__ = [
    "MetricsBundle",
    "MetricsSpec",
    "bucket_bounds",
    "percentile_from_hist",
    "to_perfetto",
    "write_perfetto",
]
