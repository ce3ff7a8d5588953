"""Data layer of the port: the training loader (a seeded synthetic
corpus, sharded, with a checkpointable cursor), the columnar on-disk trace
format of the streaming replay and its background prefetch, and the
seeded synthetic fleet workloads (:mod:`repro_torch.data.workloads`: a
scalar oracle, a numpy twin and a torch twin that builds each host's
columns on the card)."""

from repro_torch.data.pipeline import (Prefetcher, ShardedLoader,
                                       make_batch_spec)
from repro_torch.data.trace_store import TraceStore, TraceStoreCorrupt
from repro_torch.data.workloads import (WORKLOAD_KINDS, WorkloadSpec,
                                        access_at, host_trace_np,
                                        host_trace_torch, make_traces,
                                        traces_np, zipf_cdf)

__all__ = ["Prefetcher", "ShardedLoader", "make_batch_spec", "TraceStore", "TraceStoreCorrupt",
           "WORKLOAD_KINDS", "WorkloadSpec", "access_at", "host_trace_np",
           "host_trace_torch", "make_traces", "traces_np", "zipf_cdf"]
