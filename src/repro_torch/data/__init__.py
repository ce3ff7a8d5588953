"""Data layer of the port: the columnar on-disk trace format of the
streaming replay and its background prefetch.  The training loader and the
synthetic workloads come with their slices (ROADMAP Queue A items 14c and
13)."""

from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.trace_store import TraceStore, TraceStoreCorrupt

__all__ = ["Prefetcher", "TraceStore", "TraceStoreCorrupt"]
