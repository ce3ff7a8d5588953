"""Rack-scale sharded fused multi-host replay: the host axis split over the
CTAs of one thread-block cluster.

:class:`ShardedMultiHostReplay` is :class:`MultiHostReplay` with its hosts
split into ``D`` blocks of ``H / D`` (host ``i`` in shard ``i // (H /
D)``, the JAX package's block assignment over its devices).  On the card a
shard is one CTA of a thread-block cluster
(:func:`repro_torch.kernels.replay_scan.replay_sharded`): it holds its
hosts' LFB slots, clocks, cursors and staged accesses, their route rows
(compacted from the mount diagonal's ``(H, H, K, hops)`` to a shard's
``(H / D, K, hops)``, or its hosts' rows of a faulted path table) and its
hosts' media and private flash lanes in its own shared memory, so one
replay holds about ``H / D`` hosts' state a CTA.  The *shared* simulator
state is replicated: every CTA keeps the per-port busy-untils, queueing and
throttle totals and the QoS virtual-finish / last-arrival tables, updated
identically from the same inputs, so the replicas never diverge.

The JAX package's two collectives a step keep its global issue order
exactly:

1. **winner election** — each shard races its own hosts (``max(own clock,
   oldest LFB slot)``, ties to the lowest local index) and posts its
   ``(candidate tick, local index)`` in a slot of its shared memory; after
   a cluster barrier every CTA reads the D slots (distributed shared
   memory) and takes the least, ties to the lowest shard, which is the
   global ``(tick, host index)`` order because hosts are block-assigned.
2. **the record** — the winner's slot also carries its access's route row
   and retry bytes, and every CTA reads that row's hops from the owner's
   table, then walks the same replicated port / QoS update.  Only the
   owner runs the media step and writes the step's outputs.

On the CPU (``torch_device="cpu"``) the plain twin
(:func:`~repro_torch.kernels.replay_scan.replay_sharded_plain`) runs the
same D-shard election over the state layer.

**Certify or refuse.**  The sharded lane is tick-identical (latencies,
metrics bundle, fault counters) to :class:`MultiHostReplay` for per-host
fabric *mounts* over any stack medium with *private* flash, QoS / ECMP /
transport-fault columns included.  Pooled views, shared-flash HILs and
``chunk_size`` refuse with the covering lane named, as the JAX package's
lane refuses them.

The shard count is the largest divisor of ``H`` not exceeding the shards
available: a ``devices`` sequence bounds it by its length, as the JAX
package's device list does, else :data:`DEFAULT_SHARDS`, the portable
cluster size, on the card and on the CPU alike (so the twin and the card
split the same way).  A cluster of more than :data:`MAX_SHARDS` CTAs, or
one the card cannot hold at the replay's layout, is refused.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.replay.multihost import MultiHostReplay, Prepared
from repro_torch.core.replay.spec import ReplayUnsupported

#: shards without a ``devices`` bound: the portable thread-block cluster
DEFAULT_SHARDS = 8
#: the largest thread-block cluster an H100 launches (a non-portable size)
MAX_SHARDS = 16


def shard_count(num_hosts: int, devices: Optional[Sequence] = None) -> int:
    """The shard count used for ``num_hosts``: the largest divisor of the
    host count that does not exceed the available (or given) shards."""
    n = len(devices) if devices is not None else DEFAULT_SHARDS
    d = max(1, min(n, num_hosts))
    while num_hosts % d:
        d -= 1
    return d


class ShardedMultiHostReplay(MultiHostReplay):
    """:class:`MultiHostReplay` with the host axis sharded across the CTAs
    of a thread-block cluster (see the module docstring for the structure
    and the exactness / refusal contract).  ``devices=None`` bounds the
    shards by :data:`DEFAULT_SHARDS`; the shard count is
    :func:`shard_count` of the host count.  ``last_mesh`` reports
    ``{"device_count", "hosts_per_device"}`` after a run.  The replay runs
    on ``torch_device``: the card by default (one launch of the
    ``replay_scan`` kernel's sharded instance), ``"cpu"`` for its plain
    twin."""

    def __init__(self, targets: Sequence, outstanding: int = 32,
                 issue_overhead_ns: float = 0.5,
                 posted_writes: bool = True, block_size: int = 1,
                 metrics=None, devices: Optional[Sequence] = None,
                 torch_device="cuda") -> None:
        super().__init__(targets, outstanding=outstanding,
                         issue_overhead_ns=issue_overhead_ns,
                         posted_writes=posted_writes, block_size=block_size,
                         metrics=metrics, torch_device=torch_device)
        self.devices = tuple(devices) if devices is not None else None
        self.last_mesh = None
        self._shards = 1

    def _dispatch(self, prep: Prepared, chunk_size) -> int:
        """The JAX package's refusals, then the shard count (recorded in
        :attr:`last_mesh`)."""
        cfg = prep.cfg
        if chunk_size is not None:
            raise ReplayUnsupported(
                "sharded multi-host replay is one-shot (per-host columns "
                "already live device-side); use MultiHostReplay with "
                "chunk_size= for streaming, or stream per shard")
        meta = self._meta
        if meta["mapper"] is not None:
            raise ReplayUnsupported(
                "sharded replay partitions per-host fabric mounts; pool "
                "views interleave one address space across every shard — "
                "use the unsharded MultiHostReplay lane")
        H = cfg.num_hosts
        if cfg.n_flash and cfg.n_flash != H:
            raise ReplayUnsupported(
                "sharded replay needs a private flash per host (a shared "
                "HIL couples every shard's state on every step); use the "
                "unsharded MultiHostReplay lane for pooled flash")
        if cfg.num_devs != H:
            raise ReplayUnsupported(
                "sharded replay expects one mounted device per host")
        D = shard_count(H, self.devices)
        if D > MAX_SHARDS:
            raise ReplayUnsupported(
                f"{D} shards exceed the {MAX_SHARDS} CTAs of the largest "
                "thread-block cluster; pass at most "
                f"{MAX_SHARDS} devices")
        self.last_mesh = {"device_count": D, "hosts_per_device": H // D}
        return D

    def _execute_prepared(self, prep: Prepared, start_tick: int,
                          want_lat: bool = True, chunk_size=None):
        self._shards = self._dispatch(prep, chunk_size)
        return super()._execute_prepared(prep, start_tick, want_lat, None)

    def _replay(self, prep: Prepared, state, dev, start_tick: int):
        from repro_torch.core.replay.multihost import on_device
        from repro_torch.kernels.replay_scan import replay_sharded

        return replay_sharded(
            prep.cfg, self._shards, prep.params, state,
            on_device(prep.addrs, dev), on_device(prep.writes, dev),
            on_device(prep.lens, dev), on_device(prep.devs, dev),
            on_device(prep.routes, dev), start_tick=start_tick,
            retries=on_device(prep.retries, dev))

    def _chunked(self, prep: Prepared, state, dev, start_tick: int,
                 want_lat: bool, chunk: int):
        """``return_latencies=False``: the one launch, folded on the device
        as the unsharded lane folds a window (a sharded replay does not
        stream)."""
        from repro_torch.core.replay.metrics import StreamFold
        from repro_torch.core.replay.multihost import fold_window, on_device

        cfg = prep.cfg
        fold = StreamFold(self.metrics, cfg.stack.kind, dev,
                          n_hosts=cfg.num_hosts, n_devs=cfg.num_devs,
                          size=prep.size, start_tick=start_tick)
        who, issues, dones, flags, qacc, qthr = self._replay(
            prep, state, dev, start_tick)
        fold_window(fold, cfg.num_hosts, who, issues, dones, flags,
                    on_device(prep.writes, dev), on_device(prep.devs, dev))
        return (None, None, None, None, qacc.cpu().numpy(),
                qthr.cpu().numpy(), fold)

    def replay_lens(self, prep: Prepared, lens: np.ndarray):
        """One launch over ``prep`` with the hosts' trace lengths ``lens``
        (a host of length 0 issues nothing): ``(who, issues, dones, bad)``
        in step order (numpy), ``bad`` the flash's out-of-space flag.  The
        sharded lane of ``host_count_sweep``."""
        from repro_torch import torch_device as _td
        from repro_torch.core.replay import stack

        self._shards = self._dispatch(prep, None)
        lens = np.asarray(lens, np.int64)
        if not lens.sum():
            empty = np.zeros(0, np.int64)
            return empty.astype(np.int32), empty, empty, False
        dev = _td.resolve(self.torch_device)
        cfg = prep.cfg
        state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, dev)
        who, issues, dones, _, _, _ = self._replay(
            Prepared(cfg, prep.params, prep.devs, prep.addrs, prep.writes,
                     lens, prep.size, prep.routes, prep.retries),
            state, dev, 0)
        bad, _ = stack.flash_health(state)
        return (who.cpu().numpy(), issues.cpu().numpy(),
                dones.cpu().numpy(), bool(bad))
