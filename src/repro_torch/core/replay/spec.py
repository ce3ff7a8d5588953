"""Device-stack extraction: turn a live
:class:`~repro_torch.core.devices.MemDevice` into the statics and tick
constants the fused scan lane consumes.

* :class:`StackConfig` — hashable statics that shape the replay (device
  kind, array sizes, policy branch, hop count); the kernel takes them in
  its argument block.
* params dict — numpy scalars/arrays of *timing constants* (occupancies,
  latencies, all pre-converted to ticks with the exact same ``ns()``
  arithmetic the Python devices use) plus route tensors.

Every tick constant here is computed by the *identical* float expression the
corresponding device method evaluates (``ns(size / bw)``, ``ns(nbytes *
(1.0 / bw))``, ...) so rounding agrees bit-for-bit and the fused replay stays
tick-identical to the interpreted path.  The kernel never recomputes them.

Unsupported shapes (2Q/LFRU policies, multi-line accesses) raise
:class:`ReplayUnsupported` — refuse, never drift.  Traces that could outrun
the FTL's log-append headroom select the GC-capable stack lane
(``StackConfig.gc``), which runs the same greedy collection the Python FTL
does (see :mod:`repro_torch.core.replay.stack`).

Numpy only: nothing here imports torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.devices import (
    CachedCXLSSDDevice,
    CXLDRAMDevice,
    CXLLink,
    CXLSSDDevice,
    DRAMDevice,
    MemDevice,
    NullLink,
    PMEMDevice,
    POSTED_ACK_NS,
)
from repro_torch.core.engine import ns, us
from repro_torch.core.fabric.fabric import LINE_BYTES, FabricAttachedDevice
from repro_torch.core.ssd.hil import HIL


class ReplayUnsupported(ValueError):
    """The device/trace combination has no exact fused fast path.

    Every fast lane raises this instead of ever diverging silently; the
    message names the widest lane that still covers the shape.  The port's
    ladder: ``python`` (everything) > ``scan`` (all five devices, single
    host, directly attached or fabric-mounted with ECMP and QoS, greedy
    GC, every fault class, one-shot or streamed) > ``assoc`` (stateless DRAM/PMEM
    media on a single route, bandwidth-bound traces) and ``cuda`` (the
    cached CXL-SSD, with an analytic latency model).
    """


# the packed frames' stamp field (stack.py) holds one stamp an access
MAX_ACCESSES = (1 << 23) - 1
# A disabled frame of a sweep's capacity lane (the JAX package's
# sweep.py): its page field (stack.py's bits [38:1]) is all ones, which
# no page has (build_stack refuses pages that reach it), and it lies above
# every valid packed word and every free one, so it never matches and is
# never a victim.
DISABLED = (1 << 62) | (((1 << 38) - 1) << 1)

# media kinds the fused step function branches on (static)
DRAM = "dram"
PMEM = "pmem"
SSD_BUF = "ssd-buf"        # cxl-ssd: page-register buffer straight to flash
SSD_CACHE = "ssd-cache"    # cxl-ssd-cache: DRAM cache + MSHR + writeback

# media kinds with no per-access state beyond busy-until chains — the
# stacks the associative lane (repro_torch.core.replay.assoc) covers
ASSOC_KINDS = (DRAM, PMEM)


def validate_block_size(block_size) -> int:
    """Blocked-replay knob of the scan lane (``block_size`` accesses per
    sequential step in the JAX package's ``lax.scan``).  Block seams are
    tick-invisible, so the port's scan kernel takes any block size and
    ignores it; here it is only validated."""
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size!r}")
    return b


@dataclass(frozen=True)
class StackConfig:
    """Static (hashable) shape of one host->device stack."""

    kind: str                    # DRAM | PMEM | SSD_BUF | SSD_CACHE
    outstanding: int
    posted_writes: bool
    num_hops: int                # transport hops (0 = directly attached)
    num_ports: int               # busy-until vector length (>= 1)
    num_routes: int = 1          # ECMP fan-out (1 = single fixed route)
    page_bytes: int = 4096
    # cache layer (SSD_CACHE)
    cache_frames: int = 0
    cache_assoc: bool = True     # True: lru/fifo (is_lru param); False: direct
    mshr_entries: int = 0
    wb_slots: int = 0
    # flash backend (SSD_BUF / SSD_CACHE)
    channels: int = 0
    dies_per_channel: int = 0
    pages_per_block: int = 0
    buf_entries: int = 0         # SSD_BUF page registers
    num_pages: int = 0           # l2p table size (trace footprint, pow2)
    # greedy-GC lane (selected when the trace could outrun log-append
    # headroom; see repro_torch.core.replay.stack)
    gc: bool = False
    num_blocks: int = 0
    gc_watermark_blocks: int = 0
    # flash state grows FTL.stats counter twins (metrics on)
    counters: bool = False
    # deterministic NAND fault statics from FaultPlan.nand_statics():
    # (seed, read_retry_threshold, read_retry_max, erase_fail_threshold),
    # or () when no NAND faults are planned.  They shape the replay: retry
    # rounds keyed on the in-state read sequence, erase-fail gating of the
    # GC free-append.
    faults: Tuple[int, ...] = ()
    # transport faults (link CRC retries / down-port failover): the replay
    # consumes per-access hop columns precomputed on the host instead of
    # the static route tensors — see ReplayEngine
    fault_hops: bool = False
    # QoS observability (single host): indices into the busy-until
    # container (hop position on a fixed route, union-port index under
    # ECMP / fault hops) whose fabric port runs weighted arbitration.
    # With one origin the ack floor provably never binds (see
    # _fabric_hops), so only the qos_throttle_events counter is mirrored.
    qos_ports: Tuple[int, ...] = ()


def _link_hops(link: CXLLink, size: int) -> Tuple[list, int]:
    """A private point-to-point link as a 1-hop route (NullLink: 0 hops)."""
    if isinstance(link, NullLink):
        return [], 0
    return [(0, ns(size / link.bw_gbps), 0)], ns(link.rt_extra_ns)


def _fabric_hops(dev: FabricAttachedDevice, size: int
                 ) -> Tuple[list, int, Tuple[int, ...]]:
    """Route tensor export: one (port_index, occ_ticks, after_ticks) per hop,
    from :meth:`Fabric.route_occupancy` (the single definition of the
    per-hop busy-until rule), plus the hop indices whose port runs weighted
    QoS arbitration.

    Single-host QoS note: a fabric with QoS weights leaves every *tick*
    unchanged — with one origin the active set is always the singleton, the
    pace equals the clean occupancy exactly (``int(occ * w/w)``), the
    virtual clock obeys the identical ``max(prev, now) + occ`` recurrence
    as the port's busy-until (same zero init, same arrival sequence), and
    the ack floor provably never binds (see :meth:`SwitchPort.qos_update`),
    so latencies are bit-identical to plain FCFS.  The *counter* twin,
    ``qos_throttle_events``, still fires whenever the virtual clock is
    ahead of the arrival — which, by that same recurrence identity, is
    exactly when the port's busy-until is — so the fused lanes mirror it
    straight off the busy-until state on the hops returned here.  ECMP, by
    contrast, changes which ports a transfer occupies, so it is exported
    as per-route tensors by :func:`_fabric_route_tensors`."""
    fab = dev.fabric
    occ_hops = fab.route_occupancy(dev.host, dev.device_node, size)
    hops = [(i, occ, after) for i, (_, occ, after) in enumerate(occ_hops)]
    qos = tuple(i for i, (key, _, _) in enumerate(occ_hops)
                if fab.ports[key].qos_enabled)
    return hops, ns(fab.rt_extra_ns), qos


def _qos_union_ports(fab, port_keys) -> Tuple[int, ...]:
    """Indices (into a sorted port-key union) of weighted-arbitration ports."""
    return tuple(i for i, key in enumerate(port_keys)
                 if fab.ports[key].qos_enabled)


def _fabric_route_tensors(dev: FabricAttachedDevice, size: int):
    """ECMP export: per-route hop tensors over the union of ports the path
    set touches.  All equal-cost routes share one hop count, so only the
    port indices differ per route.  Returns ``(hop_port (K,H) int32,
    hop_occ (K,H) int64, hop_after (K,H) int64, num_ports, rt_extra,
    qos_ports)`` — the last being the union-port indices under weighted
    arbitration (see the single-origin recurrence note on
    :func:`_fabric_hops`)."""
    fab = dev.fabric
    routes = fab.paths(dev.host, dev.device_node)
    K = len(routes)
    per_route = [fab.route_occupancy(dev.host, dev.device_node, size,
                                     choice=k) for k in range(K)]
    H = len(per_route[0])
    if any(len(r) != H for r in per_route):
        raise AssertionError("equal-cost routes must share one hop count")
    port_keys = sorted({key for hops in per_route for key, _, _ in hops})
    pidx = {key: i for i, key in enumerate(port_keys)}
    hop_port = np.zeros((K, H), np.int32)
    hop_occ = np.zeros((K, H), np.int64)
    hop_after = np.zeros((K, H), np.int64)
    for k, hops in enumerate(per_route):
        for h, (key, occ_h, after_h) in enumerate(hops):
            hop_port[k, h] = pidx[key]
            hop_occ[k, h] = occ_h
            hop_after[k, h] = after_h
    return (hop_port, hop_occ, hop_after, len(port_keys),
            ns(fab.rt_extra_ns), _qos_union_ports(fab, port_keys))


def access_route_choices(device: MemDevice, addrs: np.ndarray) -> np.ndarray:
    """Per-access ECMP route-choice column for a fabric-mounted device —
    the same :func:`~repro_torch.core.fabric.routing.flow_choices` hash over the
    same flow key (``addr // 64``) the interpreted
    :meth:`FabricAttachedDevice.service` evaluates per access."""
    from repro_torch.core.fabric.routing import flow_choices

    fab = device.fabric
    k = len(fab.paths(device.host, device.device_node))
    return flow_choices(device.host, device.device_node,
                        np.asarray(addrs, np.int64) // LINE_BYTES, k)


def _require_fresh(dev: MemDevice) -> None:
    if dev.stats.get("bytes", 0):
        raise ReplayUnsupported(
            f"device {dev.name!r} has prior traffic; the fused replay "
            "snapshots a fresh device (re-create it or use engine='python')")


def _ssd_params(hil: HIL) -> Dict[str, int]:
    t = hil.cfg.timing
    return {
        "hil_ov": ns(hil.cfg.hil_overhead_ns),
        "xfer_page": t.xfer_ticks(hil.cfg.page_bytes),
        "read_t": t.read_ticks,
        "prog_t": t.prog_ticks,
        "sus_t": us(t.t_suspend_us),
        "erase_t": t.erase_ticks,
    }


def _gc_possible(hil: HIL, n_accesses: int) -> bool:
    """Could this trace trigger FTL GC?  (Each access causes at most one
    demand flash program; GC's own migrations only run once GC has
    triggered.)  ``False`` selects the log-append stack — byte-identical to
    the pre-GC engine; ``True`` selects the GC-capable lane, which carries
    the full FTL bookkeeping (valid counts, inverse map, FIFO free pool)
    and runs greedy collection inside the scan."""
    ftl = hil.ftl
    blocks_needed = ftl.write_ptr_block + n_accesses // ftl.pages_per_block + 2
    return blocks_needed >= ftl.num_blocks - ftl.gc_watermark_blocks


def _gc_fields(hil: HIL, n_accesses: int) -> Dict[str, int]:
    """The GC statics for :class:`StackConfig` (empty when the headroom
    check proves GC unreachable, keeping the legacy compiled program)."""
    if not _gc_possible(hil, n_accesses):
        return {}
    return dict(gc=True, num_blocks=hil.ftl.num_blocks,
                gc_watermark_blocks=hil.ftl.gc_watermark_blocks)


def build_stack(device: MemDevice, *, size: int, outstanding: int,
                issue_overhead_ns: float, posted_writes: bool,
                n_accesses: int, max_addr: int,
                counters: bool = False) -> Tuple[StackConfig, Dict]:
    """Extract (static config, params dict) for one host->device stack."""
    _require_fresh(device)
    inner = device
    ecmp = None
    if isinstance(device, FabricAttachedDevice):
        if device.fabric.stats.get("transfers", 0):
            # shared ports may hold busy-until state from other mounts;
            # a zeroed replay would silently diverge from the python path
            raise ReplayUnsupported(
                "fabric has prior traffic; replay snapshots a fresh fabric "
                "(Fabric.reset() or re-build it, or use engine='python')")
        if len(device.fabric.paths(device.host, device.device_node)) > 1:
            ecmp = _fabric_route_tensors(device, size)
            hops, rt, qos_ports = [], ecmp[4], ecmp[5]
        else:
            hops, rt, qos_ports = _fabric_hops(device, size)
        inner = device.inner
        _require_fresh(inner)
    elif isinstance(device, (CXLDRAMDevice, CXLSSDDevice, CachedCXLSSDDevice)):
        hops, rt = _link_hops(device.link, size)
        qos_ports = ()
    elif isinstance(device, (DRAMDevice, PMEMDevice)):
        hops, rt, qos_ports = [], 0, ()
    else:
        raise ReplayUnsupported(f"no fused model for {type(device).__name__}")

    if ecmp is not None:
        hop_port, hop_occ, hop_after, n_ports, rt = ecmp[:5]
        params: Dict = {
            "issue_ov": ns(issue_overhead_ns),
            # per-route port indices into the path set's port union
            "hop_port": hop_port,
            "hop_occ": hop_occ,
            "hop_after": hop_after,
            "rt_extra": rt,
        }
        common = dict(outstanding=max(1, outstanding),
                      posted_writes=posted_writes,
                      num_hops=hop_occ.shape[1], num_ports=n_ports,
                      num_routes=hop_occ.shape[0], counters=counters,
                      qos_ports=qos_ports)
    else:
        params = {
            "issue_ov": ns(issue_overhead_ns),
            # hop h is port h on a single fixed route: positional arrays
            "hop_occ": np.asarray([h[1] for h in hops], np.int64),
            "hop_after": np.asarray([h[2] for h in hops], np.int64),
            "rt_extra": rt,
        }
        common = dict(outstanding=max(1, outstanding),
                      posted_writes=posted_writes,
                      num_hops=len(hops), num_ports=max(1, len(hops)),
                      counters=counters, qos_ports=qos_ports)

    if isinstance(inner, (DRAMDevice, CXLDRAMDevice)):
        if isinstance(inner, CXLDRAMDevice) and inner is not device:
            # Mounted behind a fabric with detach_link=False: the private
            # link is a second transport stage after the fabric.
            ih, irt = _link_hops(inner.link, size)
            if ih and ecmp is not None:
                # private link = one extra hop on every ECMP route, with
                # its own (uncontended) port slot after the fabric ports
                K = params["hop_occ"].shape[0]
                params["hop_occ"] = np.concatenate(
                    [params["hop_occ"], np.full((K, 1), ih[0][1])],
                    axis=1).astype(np.int64)
                params["hop_after"] = np.concatenate(
                    [params["hop_after"], np.full((K, 1), ih[0][2])],
                    axis=1).astype(np.int64)
                params["hop_port"] = np.concatenate(
                    [params["hop_port"],
                     np.full((K, 1), common["num_ports"])],
                    axis=1).astype(np.int32)
                params["rt_extra"] = rt + irt
                common.update(num_hops=common["num_hops"] + 1,
                              num_ports=common["num_ports"] + 1)
            elif ih:
                base = len(hops)
                params["hop_occ"] = np.concatenate(
                    [params["hop_occ"], [ih[0][1]]]).astype(np.int64)
                params["hop_after"] = np.concatenate(
                    [params["hop_after"], [ih[0][2]]]).astype(np.int64)
                params["rt_extra"] = rt + irt
                common.update(num_hops=base + 1, num_ports=base + 1)

    if inner is not device and hasattr(inner, "link") \
            and not isinstance(inner, (DRAMDevice, PMEMDevice,
                                       CXLDRAMDevice)) \
            and not isinstance(inner.link, NullLink):
        raise ReplayUnsupported(
            "fabric-mounted SSD device keeps a live private link "
            "(detach_link=False); use engine='python'")

    return _media_config(inner, common, params, size=size,
                         n_accesses=n_accesses, max_addr=max_addr)


def _media_config(inner: MemDevice, common: Dict, params: Dict, *,
                  size: int, n_accesses: int, max_addr: int
                  ) -> Tuple[StackConfig, Dict]:
    """Append the media half of the stack — kind statics + timing params —
    to an already-built transport ``common``/``params`` pair.  The single
    definition both :func:`build_stack` (single host, transport attached)
    and :func:`media_stack` (multi-host, transportless) extract through."""
    if isinstance(inner, (DRAMDevice, CXLDRAMDevice)):
        dram = inner.dram if isinstance(inner, CXLDRAMDevice) else inner
        params.update({
            "occ": ns(size / dram.t.bw_gbps),
            "load": ns(dram.t.load_ns),
            "pack": ns(POSTED_ACK_NS),
        })
        return StackConfig(kind=DRAM, **common), params

    if isinstance(inner, PMEMDevice):
        t = inner.t
        lat = np.zeros((2, 2), np.int64)        # [write][row_hit]
        lat[0, 0] = ns(t.read_ns)
        lat[0, 1] = ns(t.read_ns * t.row_hit_factor)
        lat[1, 0] = ns(t.write_ns)
        lat[1, 1] = ns(t.write_ns * t.row_hit_factor)
        params.update({
            "occ": ns(size / t.bw_gbps),
            "lat": lat,
            "pack": ns(POSTED_ACK_NS),
            "row_bytes": np.int64(t.row_bytes),
        })
        return StackConfig(kind=PMEM, **common), params

    # NAND fault statics ride the media config so every lane that builds
    # this stack (single-host scan, blocked scan, multi-host) mirrors the
    # PAL/FTL fault decisions tick-identically
    nand_faults: Tuple[int, ...] = ()
    if hasattr(inner, "hil"):
        _plan = getattr(inner.hil.ftl, "fault_plan", None)
        if _plan is not None:
            nand_faults = _plan.nand_statics()

    page_bytes = 4096
    if max_addr // page_bytes >= (1 << 38) - 1:
        raise ReplayUnsupported(
            "page id exceeds the packed-frame field (addr >= 2^50)")
    if hasattr(inner, "hil"):
        ftl = inner.hil.ftl
        if ftl.num_blocks * ftl.pages_per_block >= (1 << 31):
            raise ReplayUnsupported("physical page numbers overflow int32")
    n_pages = max(1, max_addr // page_bytes + 1)
    n_pages = 1 << (n_pages - 1).bit_length()   # pow2: stable compilations

    if isinstance(inner, CXLSSDDevice):
        from repro_torch.core.cache.policies import LRUPolicy
        if not isinstance(inner._buf, LRUPolicy):
            raise ReplayUnsupported("cxl-ssd page-register buffer must be LRU")
        params.update(_ssd_params(inner.hil))
        params["internal"] = ns(inner.internal_latency_ns)
        return StackConfig(
            kind=SSD_BUF, page_bytes=inner.hil.cfg.page_bytes,
            channels=inner.hil.cfg.channels,
            dies_per_channel=inner.hil.cfg.dies_per_channel,
            pages_per_block=inner.hil.ftl.pages_per_block,
            buf_entries=inner._buf.capacity, num_pages=n_pages,
            faults=nand_faults,
            **_gc_fields(inner.hil, n_accesses), **common), params

    if isinstance(inner, CachedCXLSSDDevice):
        cache = inner.cache
        pol = cache.policy.name
        if pol not in ("lru", "fifo", "direct"):
            raise ReplayUnsupported(
                f"fused replay supports lru/fifo/direct, got {pol!r}; "
                "use engine='python'")
        if cache.cfg.mshr_entries < 1 or cache.cfg.writeback_buffer < 1:
            raise ReplayUnsupported("cache needs >= 1 MSHR and wb slot")
        frames = cache.cfg.capacity_pages
        params.update(_ssd_params(inner.hil))
        per_byte_ns = 1.0 / cache.cfg.dram_bw_gbps
        params.update({
            "hit_lat": ns(cache.cfg.hit_latency_ns),
            "line_xfer": ns(64 * per_byte_ns),
            "page_xfer": ns(page_bytes * per_byte_ns),
            "pack10": ns(10.0),
            "is_lru": np.bool_(pol == "lru"),
            "cap": np.int64(frames),
        })
        return StackConfig(
            kind=SSD_CACHE, page_bytes=page_bytes,
            cache_frames=frames, cache_assoc=(pol != "direct"),
            mshr_entries=cache.cfg.mshr_entries,
            wb_slots=cache.cfg.writeback_buffer,
            channels=inner.hil.cfg.channels,
            dies_per_channel=inner.hil.cfg.dies_per_channel,
            pages_per_block=inner.hil.ftl.pages_per_block,
            num_pages=n_pages, faults=nand_faults,
            **_gc_fields(inner.hil, n_accesses), **common), params

    raise ReplayUnsupported(
        f"no fused model for {type(inner).__name__}; use engine='python'")


def require_metrics_lane(engine: str) -> None:
    """Certify-or-refuse for telemetry: only the python driver and the
    scan lane carry the metrics; the kernel (``cuda``) and associative
    lanes have no per-access slot for them, so they refuse *explicitly*
    rather than returning a result with no (or wrong) metrics."""
    if engine in ("assoc", "pallas", "cuda"):
        raise ReplayUnsupported(
            f"engine {engine!r} cannot carry in-scan metrics; use "
            "engine='scan' (or 'python'), or drop metrics collection")


def media_stack(inner: MemDevice, *, size: int, outstanding: int,
                posted_writes: bool, n_accesses: int, max_addr: int,
                counters: bool = False) -> Tuple[StackConfig, Dict]:
    """Transportless media extraction for the multi-host engine: the stack
    of one *inner* (already fabric-mounted, link-detached) device, with
    ``num_hops=0`` — the multi-host scan supplies its own route tensors and
    walks the shared ports itself.  ``n_accesses`` must count every access
    that can reach this device's flash (summed over hosts for shared
    targets), so the GC-lane selection stays conservative."""
    _require_fresh(inner)
    if hasattr(inner, "link") and not isinstance(inner.link, NullLink):
        raise ReplayUnsupported(
            f"multi-host target {inner.name!r} keeps a live private link "
            "(mount it with detach_link=True); use engine='python'")
    common = dict(outstanding=max(1, outstanding),
                  posted_writes=posted_writes, num_hops=0, num_ports=1,
                  counters=counters)
    return _media_config(inner, common, {}, size=size,
                         n_accesses=n_accesses, max_addr=max_addr)


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


def validate_trace_columns(addrs, writes, lens=None, *, size: int = 64,
                           line: int = 64
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Validate already-columnar ``(H, L)`` multi-host trace arrays — the
    array twin of :func:`trace_to_arrays` for traces that were synthesized
    as tensors (``repro.data.workloads``) or loaded from a
    :class:`~repro.data.trace_store.TraceStore` and never existed as python
    tuple lists.  Returns canonical ``(addrs int64, writes bool,
    lens int64)``; ``lens=None`` means every host plays all ``L`` columns.
    The same single-line containment rule applies (only the first ``lens[i]``
    entries of each row are checked — padding is never replayed)."""
    addrs = np.ascontiguousarray(np.asarray(addrs, np.int64))
    writes = np.ascontiguousarray(np.asarray(writes, bool))
    if addrs.ndim != 2 or writes.shape != addrs.shape:
        raise ReplayUnsupported(
            f"trace columns must be matching (hosts, accesses) arrays, got "
            f"addrs {addrs.shape} / writes {writes.shape}")
    H, L = addrs.shape
    if lens is None:
        lens = np.full(H, L, np.int64)
    else:
        lens = np.asarray(lens, np.int64)
        if lens.shape != (H,) or (lens < 0).any() or (lens > L).any():
            raise ReplayUnsupported(
                f"lens must be (hosts,) within [0, {L}], got {lens!r}")
    if not lens.any():
        raise ReplayUnsupported("empty trace")
    live = np.arange(L) < lens[:, None]
    if size < 1 or ((addrs % line) + size > line)[live].any():
        raise ReplayUnsupported(
            "fused replay needs accesses contained in one 64 B line")
    if (addrs < 0)[live].any():
        raise ReplayUnsupported("negative addresses")
    return addrs, writes, lens
