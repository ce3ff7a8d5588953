"""Fused replay lanes of the port.

* :class:`ReplayEngine` (``engine="scan"``) — single host, any of the five
  paper devices, directly attached or fabric-mounted, one launch of the
  ``replay_scan`` kernel per trace (its plain twin on the CPU),
  tick-identical to the python driver.
* :class:`MultiHostReplay` (``MultiHostDriver(engine="scan")``) — several
  hosts over fabric mounts or a memory pool, interleaved in issue order
  over shared ports and device state (QoS, ECMP, shared flash, fault
  plans), one launch of the kernel's multi-host instance per replay.
* :mod:`repro_torch.core.replay.stack` — the device-state layer they
  replay (``init_state(cfg, device)`` / ``step(cfg, p, state, access)``,
  greedy FTL GC included; ``init_lanes`` for the multi-host lanes).
* :mod:`repro_torch.core.replay.metrics` — :class:`MetricsSpec`-configured
  telemetry (latency histograms with p50/p95/p99, component counters,
  tick-windowed series), schema- and value-identical between the python
  driver and the scan lane; exportable to Perfetto via
  :mod:`repro_torch.obs`.
* :class:`AssocReplayEngine` (``engine="assoc"``) — stateless DRAM/PMEM
  media on a single route, certified Kleene iteration over closed-form
  prefix scans (:func:`busy_until`, :func:`port_busy_until`, from
  :mod:`repro_torch.core.maxplus`) on an explicit torch device.
* :func:`replay_stream` — the scan lane straight from an on-disk
  :class:`~repro_torch.data.trace_store.TraceStore`, one ``replay_scan``
  launch a chunk resuming the carry the last one left on the device, with
  bounded outputs (``return_latencies=False``) and crash-safe checkpoints
  (``ReplayEngine.run_arrays(chunk_size=)`` and
  ``MultiHostReplay.run(chunk_size=)`` chunk an in-memory trace alike).
* :func:`cache_design_sweep` / :func:`host_count_sweep` (and
  :func:`~repro_torch.core.replay.sweep.fault_seed_sweep`) — design-space
  sweeps: a batch of cache capacities, policies and timing constants, of
  host counts, or of fault-plan seeds, every lane in one launch of the
  ``replay_scan`` kernel's sweep instances (one block a lane), each lane
  equal to its standalone replay; their plain twins on the CPU.
* :mod:`repro_torch.core.replay.cuda_engine` — the cached CXL-SSD kernel
  lane (``engine="cuda"``, analytic latency).

* :class:`ShardedMultiHostReplay` / :func:`shard_count` — the multi-host
  replay with its hosts split over the CTAs of one thread-block cluster
  (a shard each: its hosts' state, route rows and media lanes in its
  shared memory; the ports replicated), one launch of the kernel's
  sharded instance, tick-identical to :class:`MultiHostReplay`
  (``host_count_sweep(sharded=True)`` runs through it).

Importing this package loads no torch: the state layer's names load it
on first use.
"""

import importlib

from repro_torch.core.maxplus import busy_until, port_busy_until
from repro_torch.core.replay.assoc import AssocReplayEngine
from repro_torch.core.replay.engine import ReplayEngine, ReplayResult
from repro_torch.core.replay.metrics import MetricsBundle, MetricsSpec
from repro_torch.core.replay.multihost import MultiHostReplay
from repro_torch.core.replay.shard import ShardedMultiHostReplay, shard_count
from repro_torch.core.replay.stream import replay_stream
from repro_torch.core.replay.sweep import cache_design_sweep, host_count_sweep
from repro_torch.core.replay.spec import (
    ReplayUnsupported,
    StackConfig,
    build_stack,
    media_stack,
    require_metrics_lane,
    trace_to_arrays,
    validate_block_size,
)

_STACK_NAMES = ("init_lanes", "init_state", "media_init", "media_step",
                "step")


def __getattr__(name):
    if name in _STACK_NAMES:
        return getattr(importlib.import_module(f"{__name__}.stack"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AssocReplayEngine",
    "MetricsBundle",
    "MetricsSpec",
    "MultiHostReplay",
    "ReplayEngine",
    "ReplayResult",
    "ReplayUnsupported",
    "ShardedMultiHostReplay",
    "StackConfig",
    "build_stack",
    "busy_until",
    "cache_design_sweep",
    "host_count_sweep",
    "init_lanes",
    "init_state",
    "media_init",
    "media_stack",
    "media_step",
    "port_busy_until",
    "replay_stream",
    "shard_count",
    "require_metrics_lane",
    "step",
    "trace_to_arrays",
    "validate_block_size",
]
