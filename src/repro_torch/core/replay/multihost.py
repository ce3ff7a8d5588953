"""Fused multi-host replay: N hosts interleaved in one replay.

The replay reproduces :class:`repro_torch.core.workloads.driver.
MultiHostDriver`'s global issue ordering exactly: each step selects the
host with the earliest candidate issue tick (``max(own clock, own oldest
LFB slot)``, ties to the lowest host index — the heap's ``(tick, index)``
order), pops that host's next access, walks its precomputed route over the
*shared* per-port busy-until vector, and serializes on the target device's
media state.  Contention between hosts therefore emerges from the same
shared state as in the interpreted driver, tick for tick.

On the card the whole replay is one launch of the ``replay_scan`` kernel's
multi-host instance (:func:`repro_torch.kernels.replay_scan.replay_multi`);
on the CPU (``torch_device="cpu"``) its plain twin runs the state layer
:mod:`repro_torch.core.replay.stack` one step at a time.  The device media
is one private media lane per mounted device (per host in mount mode, per
pool device in pool mode) over zero or more flash lanes — so the full
cached-CXL-SSD stack replays fused, including the pooled-flash shape (per
host private DRAM caches sharing one FTL/PAL flash array, built by handing
several :class:`CachedCXLSSDDevice` front ends one ``hil=``) and greedy
FTL garbage collection.

QoS and ECMP are mirrored operation-for-operation:

* **ECMP** — the per-access route choice is precomputed host-side with the
  same :func:`~repro_torch.core.fabric.routing.flow_choices` hash the
  interpreted path evaluates per access, and the hop tables gain a route
  axis.
* **QoS** — per-port per-host virtual-finish-time and last-arrival tables
  replicate :meth:`SwitchPort.qos_update`: the weight sum runs over hosts
  in sorted-name order (the same float64 add order as the Python ``dict``
  walk), the pace uses the identical ``int(occ * (W / w))`` truncation,
  and the resulting floor binds the final host acknowledgment only — the
  physical port walk is untouched, exactly like the interpreted path.

Supported targets (homogeneous): :class:`FabricAttachedDevice` mounts and
:class:`HostPortView` pool views over any media the stack layer models —
DRAM-class (heterogeneous timing allowed), PMEM, CXL-SSD, cached CXL-SSD
(lru/fifo/direct, identical configuration across targets).  The pool's
address mapper is applied host-side (it is a pure function of the
address), so interleave and segment modes cost nothing in the replay.
Anything else raises :class:`ReplayUnsupported` naming the widest lane
that still covers the shape (the ``engine='python'`` fallback) — lanes
refuse, they never silently diverge.

Transport faults (link CRC-retry bursts, port/link down windows with ECMP
exclusion and failover reroutes, poison status) mirror tick-identically on
per-host mounts: every (host, ordinal) pair walks the same pure
:meth:`Fabric.select_faulted` route selection the interpreted mount
performs — keyed on that host's own access ordinal, exactly the per-mount
``_fault_ord`` counter.  :class:`_MultiFaultColumns` emits the compact
code of the single-host lane per host: a path table (over the global
sorted port set) and, per (host, access), a path id and one retry byte a
hop; :func:`~repro_torch.core.replay.engine.expand_fault_codes` turns it
into the JAX package's five ``(H, L, hops)`` columns.  CRC retries charge
the physical occupancy while the QoS virtual clock paces on the clean
occupancy.  Pool views with link/down faults refuse (interleaving
scrambles the per-host fault ordinals); an unreachable down segment raises
:class:`~repro_torch.core.faults.DeviceUnreachable` at prepare, matching
the first access the python driver would fail on.

Streaming: ``chunk_size=`` replays the steps as a sequence of launches
that carry every host's LFB slots, clock and cursor, the shared ports and
QoS tables and every lane's state from one to the next on the device; a
launch takes each host's window of ``chunk`` accesses from its cursor and
replays at most ``chunk`` steps, so no host outruns its window.
``return_latencies=False`` folds each launch's ``(who, issue, done,
flags)`` columns into per-host and per-device accumulators on the device
(:class:`~repro_torch.core.replay.metrics.StreamFold`) and returns the
per-host scalars only.  ``block_size`` is validated and tick-invisible.  Nothing here imports
torch until a replay runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.devices import (POSTED_ACK_NS, CXLDRAMDevice,
                                      DRAMDevice, NullLink)
from repro_torch.core.engine import ns
from repro_torch.core.fabric.fabric import (LINE_BYTES, Fabric,
                                            FabricAttachedDevice)
from repro_torch.core.fabric.pool import HostPortView
from repro_torch.core.fabric.routing import flow_choices, flow_hash
from repro_torch.core.replay.engine import (MAX_RETRY_CODE, POISON_BIT,
                                            ReplayResult)
from repro_torch.core.replay.spec import (DRAM, MAX_ACCESSES, SSD_BUF,
                                          SSD_CACHE, ReplayUnsupported,
                                          StackConfig, media_stack,
                                          trace_to_arrays,
                                          validate_block_size,
                                          validate_trace_columns)
from repro_torch.core.workloads.driver import MultiHostResult, TraceResult

BIG = 1 << 62
# "never arrived" sentinel for the QoS last-arrival table: far enough below
# zero that sentinel + activity window can never exceed a valid tick.
NEVER = -(1 << 61)
# hops a faulted access's retry bytes can cover: the kernel packs them
# into one int64 an access
MAX_FAULT_HOPS = 8


@dataclass(frozen=True)
class MultiCfg:
    num_hosts: int
    outstanding: int
    posted_writes: bool
    num_ports: int
    max_hops: int
    num_devs: int
    stack: StackConfig           # media/flash statics (transportless)
    n_flash: int = 0             # flash instances (0 for flash-less media)
    max_routes: int = 1
    qos: bool = False
    # host indices in sorted-host-name order: the QoS weight sum must add
    # floats in exactly the order SwitchPort.qos_update's sorted() walk does
    host_order: Tuple[int, ...] = ()
    # transport faults active: a path table and per-access path ids and
    # retry bytes replace the static per-(host, dev, route) hop tables
    fault_hops: bool = False
    # per-host fabric mounts (host i reaches device i only), not pool
    # views: the kernel keeps the (host, route) rows only
    mounts: bool = False


def _port_index(fabric: Fabric) -> Dict[Tuple[str, str], int]:
    return {key: i for i, key in enumerate(sorted(fabric.ports))}


def _route_rows(fabric: Fabric, host: str, node: str, size: int,
                pidx: Dict[Tuple[str, str], int], max_hops: int,
                choice: int):
    hops = fabric.route_occupancy(host, node, size, choice=choice)
    if len(hops) > max_hops:
        raise AssertionError("max_hops underestimated")
    port = np.zeros(max_hops, np.int32)
    occ = np.zeros(max_hops, np.int64)
    after = np.zeros(max_hops, np.int64)
    on = np.zeros(max_hops, bool)
    for h, (key, occ_h, after_h) in enumerate(hops):
        port[h] = pidx[key]
        occ[h] = occ_h
        after[h] = after_h
        on[h] = True
    return port, occ, after, on


def _extract_targets(targets: Sequence, size: int):
    """Shared fabric + route/QoS tables and metadata for mounts or pool
    views (the media half is extracted separately by :func:`_media_setup`,
    which needs the mapped address range)."""
    first = targets[0]
    if isinstance(first, FabricAttachedDevice):
        fabric = first.fabric
        if not all(isinstance(t, FabricAttachedDevice)
                   and t.fabric is fabric for t in targets):
            raise ReplayUnsupported("hosts must share one fabric")
        hosts = [t.host for t in targets]
        nodes = [t.device_node for t in targets]
        inners = [t.inner for t in targets]
        dev_of = {n: i for i, n in enumerate(nodes)}
        if len(dev_of) != len(nodes):
            raise ReplayUnsupported(
                "fused mount mode needs one private device per host "
                "(share devices through a MemoryPool instead)")
        mapper = None
    elif isinstance(first, HostPortView):
        pool = first.pool
        if not all(isinstance(t, HostPortView) and t.pool is pool
                   for t in targets):
            raise ReplayUnsupported("pool views must share one MemoryPool")
        fabric = pool.fabric
        hosts = [t.host for t in targets]
        nodes = pool.device_nodes
        inners = list(pool.devices)
        mapper = pool.mapper
    else:
        raise ReplayUnsupported(
            f"multi-host fused replay supports FabricAttachedDevice / "
            f"HostPortView targets, got {type(first).__name__}; "
            "use engine='python'")
    for t in list(targets) + inners:
        if t.stats.get("bytes", 0):
            raise ReplayUnsupported("targets must be fresh (no prior traffic)")
    if fabric.stats.get("transfers", 0):
        raise ReplayUnsupported(
            "fabric has prior traffic; replay snapshots a fresh fabric "
            "(Fabric.reset() or re-build it, or use engine='python')")
    qos = fabric.qos_enabled
    if qos and len(set(hosts)) != len(hosts):
        raise ReplayUnsupported(
            "QoS arbitration keys per-origin state by host name; give each "
            "host view a distinct host node (or use engine='python')")
    plan = getattr(fabric, "fault_plan", None)
    if plan is None:
        plan = next((q for q in (getattr(t, "fault_plan", None)
                                 for t in targets) if q is not None), None)
    if plan is not None and not plan.active:
        plan = None
    if (plan is not None and (plan.has_link or plan.has_down)
            and mapper is not None):
        raise ReplayUnsupported(
            f"multi-host fused replay mirrors transport faults "
            f"({', '.join(plan.class_names())}) on per-host fabric mounts "
            "only — pool address interleaving scrambles the per-host fault "
            "ordinals; use engine='python' for faulted pools")

    pidx = _port_index(fabric)
    pairs = ([(i, i) for i in range(len(hosts))] if mapper is None else
             [(i, d) for i in range(len(hosts)) for d in range(len(nodes))])
    max_hops = max(fabric.routing.hops(hosts[i], nodes[d]) for i, d in pairs)
    H, NDEV = len(hosts), len(nodes)
    route_count = np.ones((H, NDEV), np.int32)
    for i, d in pairs:
        route_count[i, d] = len(fabric.paths(hosts[i], nodes[d]))
    K = int(route_count.max())
    hop_port = np.zeros((H, NDEV, K, max_hops), np.int32)
    hop_occ = np.zeros((H, NDEV, K, max_hops), np.int64)
    hop_after = np.zeros((H, NDEV, K, max_hops), np.int64)
    hop_on = np.zeros((H, NDEV, K, max_hops), bool)
    for i, h in enumerate(hosts):
        for d, n in enumerate(nodes):
            if mapper is None and d != i:
                continue        # mount mode: host i only reaches device i
            for k in range(route_count[i, d]):
                (hop_port[i, d, k], hop_occ[i, d, k], hop_after[i, d, k],
                 hop_on[i, d, k]) = _route_rows(fabric, h, n, size, pidx,
                                                max_hops, k)
    params = {
        "hop_port": hop_port, "hop_occ": hop_occ, "hop_after": hop_after,
        "hop_on": hop_on,
        "rt_extra": ns(fabric.rt_extra_ns),
    }
    host_order: Tuple[int, ...] = ()
    if qos:
        ports_sorted = sorted(fabric.ports)
        params["qos_on"] = np.asarray(
            [fabric.ports[key].qos_enabled for key in ports_sorted], bool)
        params["qos_w"] = np.asarray(
            [[fabric.ports[key].weight_of(hname) for hname in hosts]
             for key in ports_sorted], np.float64)
        host_order = tuple(int(j) for j in
                           sorted(range(H), key=lambda j: hosts[j]))
    # transport faults ride the fabric: the interpreted mount passes an
    # ordinal into traverse_qos only when the plan sits on the *fabric*
    # (FabricAttachedDevice.service checks fabric.fault_plan), so the
    # fused columns key on exactly that
    fab_plan = getattr(fabric, "fault_plan", None)
    if fab_plan is not None and not fab_plan.active:
        fab_plan = None
    transport_plan = (fab_plan if fab_plan is not None
                      and (fab_plan.has_link or fab_plan.has_down) else None)
    meta = dict(fabric=fabric, mapper=mapper, hosts=hosts, nodes=nodes,
                inners=inners, route_count=route_count, qos=qos,
                host_order=host_order, num_ports=len(pidx),
                max_hops=max_hops, max_routes=K, num_devs=NDEV,
                fault_plan=plan, transport_plan=transport_plan)
    return params, meta


def _dram_class(dev):
    """Bare DRAM, or CXL-DRAM whose private link the fabric mount
    neutralized (the only shapes with per-device timing arrays)."""
    if isinstance(dev, DRAMDevice):
        return dev
    if isinstance(dev, CXLDRAMDevice) and isinstance(dev.link, NullLink):
        return dev.dram
    return None


def _params_equal(a: Dict, b: Dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _media_setup(inners: Sequence, *, size: int, outstanding: int,
                 posted_writes: bool, n_accesses: int, max_addr: int,
                 counters: bool = False):
    """The media half of the multi-host stack: one
    :class:`~repro_torch.core.replay.spec.StackConfig` shared by every
    target, media timing params, and the media-lane -> flash-lane map
    (deduplicated by the backing :class:`HIL` object, so front ends built
    over one shared ``hil=`` contend on one flash state — exactly like the
    interpreted path).  Heterogeneous timing is allowed for DRAM-class
    media (per-device arrays); every other kind must be identically
    configured."""
    specs = [media_stack(d, size=size, outstanding=outstanding,
                         posted_writes=posted_writes, n_accesses=n_accesses,
                         max_addr=max_addr, counters=counters)
             for d in inners]
    cfg0, mp0 = specs[0]
    for k, (cfgk, mpk) in enumerate(specs[1:], start=1):
        if cfgk != cfg0 or (cfg0.kind != DRAM
                            and not _params_equal(mpk, mp0)):
            raise ReplayUnsupported(
                f"multi-host targets must be identically configured "
                f"({cfg0.kind!r} media differs at target {k}); "
                "use engine='python'")
    if cfg0.kind == DRAM:
        drams = [_dram_class(d) for d in inners]
        media_params = {
            "dev_occ": np.asarray([ns(size / d.t.bw_gbps) for d in drams],
                                  np.int64),
            "dev_load": np.asarray([ns(d.t.load_ns) for d in drams],
                                   np.int64),
            "dev_pack": np.asarray([ns(POSTED_ACK_NS)] * len(drams),
                                   np.int64),
        }
        return cfg0, media_params, np.zeros(len(inners), np.int32), 0
    if cfg0.kind not in (SSD_BUF, SSD_CACHE):
        return cfg0, mp0, np.zeros(len(inners), np.int32), 0
    flash_lane: Dict[int, int] = {}
    flash_of = np.zeros(len(inners), np.int32)
    for i, d in enumerate(inners):
        flash_of[i] = flash_lane.setdefault(id(d.hil), len(flash_lane))
    return cfg0, mp0, flash_of, len(flash_lane)


def _map_addrs(mapper, host_idx: int, addrs: np.ndarray):
    """Host-side pool address mapping (pure per-address arithmetic)."""
    if mapper is None:
        return np.full(addrs.shape, host_idx, np.int32), addrs
    if mapper.mode == "interleave":
        frame, off = np.divmod(addrs, mapper.granularity)
        dev = (frame % mapper.num_devices).astype(np.int32)
        local = (frame // mapper.num_devices) * mapper.granularity + off
        return dev, local
    dev64, local = np.divmod(addrs, mapper.segment_bytes)
    if (dev64 >= mapper.num_devices).any():
        raise ReplayUnsupported("address beyond pool capacity")
    return dev64.astype(np.int32), local


# -------------------------------------------------- transport fault columns
class _MultiFaultColumns:
    """Per-host per-access transport hops of per-host fabric mounts under
    the installed link-retry / down-window plan — the multi-host twin of
    :class:`~repro_torch.core.replay.engine._FaultColumnBuilder`, with the
    host axis and the *global* sorted-port index (so the shared port
    busy-untils, the QoS tables and the ``qos_on`` / ``qos_w`` params keep
    their indexing untouched).

    Every (host, ordinal) walks the same pure route selection the
    interpreted mount performs (:meth:`Fabric.select_faulted`, keyed on
    that host's *own* access ordinal — the per-mount ``_fault_ord``
    counter) and the same per-hop occupancy rule.  Raises
    :class:`~repro_torch.core.faults.DeviceUnreachable` at construction
    for the same segments the python driver would fail on.

    The code is the single-host lane's: :attr:`table` holds every path
    any host takes (``hop_port``, -1 on a hop the path does not have,
    ``hop_occ``, ``hop_after``, paths x hops, and ``path_dev``, the
    device its host reaches), and :meth:`columns` gives per (host,
    access) the path id and one CRC-retry count a hop, with the
    accumulated per-port / per-host / ECMP totals for the metrics'
    ``faulted=`` override, the fault counters and the per-host
    degraded / failover availability flags."""

    def __init__(self, meta: Dict, plan, lens: np.ndarray,
                 size: int) -> None:
        fab = meta["fabric"]
        self.fab, self.plan, self.size = fab, plan, int(size)
        self.hosts, self.nodes = meta["hosts"], meta["nodes"]
        self.pidx = _port_index(fab)
        self.lens = np.asarray(lens, np.int64)
        H = len(self.hosts)
        # candidate path set per host: one entry per distinct down segment
        # — the route chosen for an ordinal depends only on its segment's
        # down set and the flow hash, never on the ordinal itself
        self._occ: List[Dict[Tuple[str, ...], list]] = [{} for _ in range(H)]
        for i in range(H):
            n_i = int(self.lens[i])
            if not n_i:
                continue
            segs = (plan.down_segments(n_i) if plan.has_down
                    else [(0, n_i, frozenset())])
            for _, _, down in segs:
                ps = fab.routing.paths(self.hosts[i], self.nodes[i],
                                       down=down)
                for q in (ps if fab.ecmp else [ps[0]]):
                    key = tuple(q)
                    if key not in self._occ[i]:
                        self._occ[i][key] = fab.path_occupancy(q, size)
        self.num_hops = max((len(hops) for d in self._occ
                             for hops in d.values()), default=1)
        # path ids: host by host, each host's paths in discovery order
        self._path_id: List[Dict[Tuple[str, ...], int]] = []
        rows = []
        for i in range(H):
            ids = {}
            for key, hops in self._occ[i].items():
                ids[key] = len(rows)
                rows.append((i, hops))
            self._path_id.append(ids)
        FH = self.num_hops
        port = np.full((max(len(rows), 1), FH), -1, np.int32)
        occ = np.zeros((max(len(rows), 1), FH), np.int64)
        after = np.zeros((max(len(rows), 1), FH), np.int64)
        path_dev = np.zeros(max(len(rows), 1), np.int32)
        for r, (i, hops) in enumerate(rows):
            path_dev[r] = i                 # mount mode: host i -> device i
            for h, (pk, o, a) in enumerate(hops):
                port[r, h], occ[r, h], after[r, h] = self.pidx[pk], o, a
        self.table = {"hop_port": port, "hop_occ": occ, "hop_after": after,
                      "path_dev": path_dev}

    def columns(self, addrs: np.ndarray):
        """``(path, retries, faulted, fstats, deg, fo)``: per (host,
        access) path ids (int32, ``(H, L)``) and retry bytes (uint8,
        ``(H, L, num_hops)``); the per-port / per-host / ECMP totals for
        the metrics; the fault counters; the per-host degraded / failover
        flags (``(H, L)`` bool)."""
        fab, plan = self.fab, self.plan
        P = len(self.pidx)
        H, L = addrs.shape
        FH = self.num_hops
        path = np.zeros((H, L), np.int32)
        retries = np.zeros((H, L, FH), np.uint8)
        deg = np.zeros((H, L), bool)
        fo = np.zeros((H, L), bool)
        pkts = np.zeros(P, np.int64)
        occt = np.zeros(P, np.int64)
        by_host = np.zeros((P, H), np.int64)
        ecmp: Dict[str, List[int]] = {}
        link_retries = failovers = degraded = 0
        for i in range(H):
            host, node = self.hosts[i], self.nodes[i]
            K = len(fab.paths(host, node))
            for j in range(int(self.lens[i])):
                line_addr = int(addrs[i, j]) // LINE_BYTES
                p, dg, fv = fab.select_faulted(host, node, line_addr, j)
                if dg:
                    deg[i, j] = True
                    degraded += 1
                    if fv:
                        fo[i, j] = True
                        failovers += 1
                elif fab.ecmp and K > 1:
                    # mirror traverse_qos: clean ECMP choices still count
                    k = flow_hash(host, node, line_addr) % K
                    ecmp.setdefault(f"{host}->{node}", [0] * K)[k] += 1
                key = tuple(p)
                path[i, j] = self._path_id[i][key]
                for h, (pk, occ, _) in enumerate(self._occ[i][key]):
                    rt = plan.link_retries(pk, j) if plan.has_link else 0
                    if rt > MAX_RETRY_CODE:
                        raise ReplayUnsupported(
                            f"{rt} link retries on one hop exceed the scan "
                            f"lane's one-byte code ({MAX_RETRY_CODE}); use "
                            "engine='python'")
                    link_retries += rt
                    pi = self.pidx[pk]
                    retries[i, j, h] = rt
                    pkts[pi] += 1
                    occt[pi] += occ * (1 + rt)
                    by_host[pi, i] += self.size   # goodput: retries move 0 B
        faulted = {"port_keys": sorted(fab.ports), "packets": pkts,
                   "bytes": pkts * self.size, "occupied": occt,
                   "by_host": by_host, "ecmp": ecmp}
        fstats = {"link_retries": int(link_retries),
                  "failovers": int(failovers),
                  "degraded_accesses": int(degraded)}
        return path, retries, faulted, fstats, deg, fo


@dataclass
class Prepared:
    """One replay's inputs, on the host: the config, the params (route or
    path tables, QoS weights, media timing, ``flash_of``), and the
    ``(H, L)`` columns (device-local addresses, writes, devices, routes —
    or, under transport faults, path ids — and retry bytes)."""

    cfg: MultiCfg
    params: Dict
    devs: np.ndarray
    addrs: np.ndarray
    writes: np.ndarray
    lens: np.ndarray
    size: int
    routes: Optional[np.ndarray] = None
    retries: Optional[np.ndarray] = None


class MultiHostReplay:
    """Fused stand-in for :class:`MultiHostDriver` (pooled or per-host
    fabric targets over any stack-layer media — DRAM-class, PMEM, CXL-SSD,
    cached CXL-SSD with private or shared flash — QoS weights, ECMP,
    greedy FTL GC and fault plans included).  ``run`` is tick-identical to
    the interpreted driver for supported shapes.  The replay runs on
    ``torch_device``: the card by default (one ``replay_scan`` launch),
    ``"cpu"`` for the plain twin."""

    def __init__(self, targets: Sequence, outstanding: int = 32,
                 issue_overhead_ns: float = 0.5,
                 posted_writes: bool = True, block_size: int = 1,
                 metrics=None, torch_device="cuda") -> None:
        if not targets:
            raise ReplayUnsupported("need at least one host target")
        self.targets = list(targets)
        self.outstanding = max(1, outstanding)
        self.issue_overhead_ns = issue_overhead_ns
        self.posted_writes = posted_writes
        self.block_size = validate_block_size(block_size)
        self.torch_device = torch_device
        self.last_gc_runs = 0    # flash GC collections in the last run
        self.metrics = metrics   # Optional[MetricsSpec]
        self.last_metrics = None  # MetricsBundle of the last run
        # host seconds of the last prepare's fault-column build (0.0
        # without transport faults)
        self.last_column_seconds = 0.0
        self._meta = None

    def prepare(self, traces: Sequence) -> Prepared:
        """The replay's inputs (:class:`Prepared`) from per-host
        ``[(addr, size, write)]`` traces."""
        if len(traces) != len(self.targets):
            raise ValueError(f"{len(traces)} traces for "
                             f"{len(self.targets)} host targets")
        parsed = [trace_to_arrays(tr) for tr in traces]
        size = parsed[0][2]
        if any(pz != size for _, _, pz in parsed):
            raise ReplayUnsupported("hosts must share one access size")
        H = len(self.targets)
        L = max(a.size for a, _, _ in parsed)
        addrs = np.zeros((H, L), np.int64)
        writes = np.zeros((H, L), bool)
        lens = np.asarray([a.size for a, _, _ in parsed], np.int64)
        for i, (a, w, _) in enumerate(parsed):
            addrs[i, :a.size] = a
            writes[i, :a.size] = w
        return self.prepare_arrays(addrs, writes, lens=lens, size=size)

    def prepare_arrays(self, addrs, writes, *, lens=None,
                       size: int = 64) -> Prepared:
        """:meth:`prepare` for traces that already live as ``(H, L)``
        columns.  Pool address mapping, ECMP route-choice hashing and the
        transport fault code stay host-side numpy column ops (pure
        per-address arithmetic, bit-equal to the per-access scalar
        path)."""
        addrs, writes, lens = validate_trace_columns(
            addrs, writes, lens, size=size)
        H, L = addrs.shape
        if H != len(self.targets):
            raise ValueError(f"{H} trace rows for "
                             f"{len(self.targets)} host targets")
        params, meta = _extract_targets(self.targets, size)
        self._meta = meta        # labels/fabric for metrics bundle assembly
        devs = np.zeros((H, L), np.int32)
        routes = np.zeros((H, L), np.int32)
        mapper, route_count = meta["mapper"], meta["route_count"]
        tplan = meta["transport_plan"]
        if mapper is not None:
            addrs = addrs.copy()    # mapping rewrites to device-local addrs
        for i in range(H):
            n = int(lens[i])
            dev, local = _map_addrs(mapper, i, addrs[i, :n])
            addrs[i, :n] = local
            devs[i, :n] = dev
            if meta["max_routes"] > 1 and tplan is None:
                # same hash, same flow key (device-local line address) as
                # HostPortView / FabricAttachedDevice evaluate per access
                for d in np.unique(dev):
                    m = dev == d
                    routes[i, :n][m] = flow_choices(
                        meta["hosts"][i], meta["nodes"][d],
                        local[m] // LINE_BYTES, int(route_count[i, d]))
        stack_cfg, media_params, flash_of, n_flash = _media_setup(
            meta["inners"], size=size, outstanding=self.outstanding,
            posted_writes=self.posted_writes, n_accesses=int(lens.sum()),
            max_addr=int(addrs.max(initial=0)),
            counters=self.metrics is not None)
        if n_flash and H * L > MAX_ACCESSES:
            raise ReplayUnsupported(
                f"multi-host SSD replay of {H}x{L} steps exceeds the "
                f"packed-stamp budget ({MAX_ACCESSES}); split the traces "
                "or use engine='python'")
        params.update(media_params)
        params["flash_of"] = flash_of
        params["issue_ov"] = ns(self.issue_overhead_ns)
        max_hops, max_routes = meta["max_hops"], meta["max_routes"]
        retries = None
        self.last_column_seconds = 0.0
        if tplan is not None:
            # link-retry / down-window code: a path table replaces the
            # static per-(host, dev, route) tables, and each access
            # carries its path id (the ECMP choice over survivors baked
            # in) and retry bytes; the route axis collapses
            t0 = time.perf_counter()
            fc = _MultiFaultColumns(meta, tplan, lens, size)
            routes, retries, faulted, fstats, degf, fof = fc.columns(addrs)
            self.last_column_seconds = time.perf_counter() - t0
            if fc.num_hops > MAX_FAULT_HOPS:
                raise ReplayUnsupported(
                    f"a faulted path of {fc.num_hops} hops exceeds the scan "
                    f"lane's {MAX_FAULT_HOPS} retry bytes an access; use "
                    "engine='python'")
            params.update({f"path_{k.removeprefix('hop_')}": v
                           for k, v in fc.table.items()
                           if k.startswith("hop_")})
            params["path_dev"] = fc.table["path_dev"]
            meta["faulted"] = faulted
            meta["fault_stats"] = fstats
            meta["deg_flags"] = degf
            meta["fo_flags"] = fof
            max_hops, max_routes = fc.num_hops, 1
        # poison status parity: the driver tallies each target plan's
        # deterministic (host, ordinal) poison flags on the service path
        poison = np.zeros((H, L), bool)
        for i, tgt in enumerate(self.targets):
            tp = getattr(tgt, "fault_plan", None)
            if tp is not None and tp.has_poison:
                n_i = int(lens[i])
                poison[i, :n_i] = tp.poisoned_np(
                    i, np.arange(n_i, dtype=np.int64), writes[i, :n_i])
        meta["poison"] = poison
        meta["poisoned_reads"] = int(poison.sum())
        cfg = MultiCfg(num_hosts=H, outstanding=self.outstanding,
                       posted_writes=self.posted_writes,
                       num_ports=meta["num_ports"],
                       max_hops=max_hops, num_devs=meta["num_devs"],
                       stack=stack_cfg, n_flash=n_flash,
                       max_routes=max_routes, qos=meta["qos"],
                       host_order=meta["host_order"],
                       fault_hops=tplan is not None,
                       mounts=mapper is None)
        return Prepared(cfg, params, devs, addrs, writes, lens, size,
                        routes if (tplan is not None or max_routes > 1)
                        else None, retries)

    @property
    def fault_flags(self):
        """Per-host ``(degraded, failover)`` flag arrays (each ``(H, L)``
        bool) from the last :meth:`prepare` under an active transport
        plan, else ``None``."""
        if self._meta is None or "deg_flags" not in self._meta:
            return None
        return self._meta["deg_flags"], self._meta["fo_flags"]

    @property
    def fault_stats(self) -> Optional[Dict[str, int]]:
        """The transport-fault counters (link retries, failovers,
        degraded accesses) of the last :meth:`prepare` under an active
        transport plan, else ``None``."""
        if self._meta is None or "fault_stats" not in self._meta:
            return None
        return dict(self._meta["fault_stats"])

    @staticmethod
    def aggregate(who, issues, dones, lens, size: int,
                  start_tick: int = 0) -> MultiHostResult:
        """Fold per-step (host, issue, done) streams into per-host
        results.  Steps beyond ``sum(lens)`` (the JAX package pads its
        scan to ``H * L`` steps) pick exhausted hosts and are dropped."""
        who = np.asarray(who)
        issues = np.asarray(issues)
        dones = np.asarray(dones)
        lens = np.asarray(lens)
        valid = np.arange(who.size) < int(lens.sum())
        per_host: List[TraceResult] = []
        firsts, lasts = [], []
        for i in range(lens.size):
            m = valid & (who == i)
            iss, dn = issues[m], dones[m]
            n = int(m.sum())
            first = int(iss[0]) if n else None
            last = max(int(dn.max(initial=0)), start_tick) if n else start_tick
            per_host.append(TraceResult(
                accesses=n, bytes_moved=n * size,
                elapsed_ticks=(last - first) if first is not None else 0,
                sum_latency_ticks=int((dn - iss).sum()),
                end_tick=last))
            if first is not None:
                firsts.append(first)
            lasts.append(last)
        first_all = min(firsts, default=start_tick)
        return MultiHostResult(per_host=per_host,
                               elapsed_ticks=max(lasts) - first_all)

    def _execute_prepared(self, prep: Prepared, start_tick: int,
                          want_lat: bool = True, chunk_size=None):
        """The replay of prepared inputs, after the health check: with
        ``want_lat`` ``(who, issues, dones, flags)`` in step order (numpy)
        then ``step_ord, lens, size, bundle``; else the
        :class:`MultiHostResult` of the per-host scalars.  Sets
        :attr:`last_gc_runs` and :attr:`last_metrics`."""
        from repro_torch import torch_device as _td
        from repro_torch.core.replay import stack

        cfg = prep.cfg
        if cfg.qos and start_tick < 0:
            raise ReplayUnsupported(
                "QoS replay needs start_tick >= 0 (the virtual-clock and "
                "arrival sentinels assume non-negative ticks)")
        if chunk_size is not None and int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size!r}")
        dev = _td.resolve(self.torch_device)
        state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, dev)
        fold = None
        if chunk_size is None and want_lat:
            out = self._replay(prep, state, dev, start_tick)
            who, issues, dones, flags, qacc, qthr = (x.cpu().numpy()
                                                     for x in out)
        else:
            who, issues, dones, flags, qacc, qthr, fold = self._chunked(
                prep, state, dev, start_tick, want_lat,
                int(prep.lens.sum()) if chunk_size is None
                else int(chunk_size))
        bad, gcs = stack.flash_health(state)
        self.last_gc_runs = gcs
        if bad:
            raise ReplayUnsupported(
                "FTL ran out of free blocks during GC (device overfilled) — "
                "the interpreted path raises there too; shrink the traces "
                "or use engine='python' for the exact error")
        meta = self._meta
        bundle = None
        fdict = None
        if self.metrics is not None and (meta.get("fault_plan") is not None
                                         or meta.get("poisoned_reads")):
            rr, rb = stack.fault_counters(state)
            fs = meta.get("fault_stats") or {}
            fdict = {"link_retries": fs.get("link_retries", 0),
                     "failovers": fs.get("failovers", 0),
                     "degraded_accesses": fs.get("degraded_accesses", 0),
                     "nand_read_retries": rr,
                     "retired_blocks": rb,
                     "poisoned_reads": int(meta.get("poisoned_reads", 0))}
        if fold is not None:
            if self.metrics is not None:
                from repro_torch.core.replay import metrics as _metrics
                bundle = _metrics.bundle_multi_fused(
                    self.metrics, meta, cfg, fold.acc.cpu().numpy(),
                    fold.med.cpu().numpy(), qacc, qthr if cfg.qos else None,
                    stack.flash_counters(state), prep.devs, prep.routes,
                    prep.lens, prep.size, prep.params, faults=fdict,
                    faulted=meta.get("faulted"))
            self.last_metrics = bundle
            return self._attach(self.aggregate_scalars(
                fold, prep.lens, prep.size, start_tick), bundle)
        if self.metrics is None:
            flags = flags & 3            # event bits ride only with metrics
        step_ord = step_ordinals(who, cfg.num_hosts)
        flags = flags | (meta["poison"][who, step_ord].astype(np.int32)
                         << POISON_BIT)
        if self.metrics is not None:
            from repro_torch.core.replay import metrics as _metrics
            bundle = _metrics.bundle_multi_deferred(
                self.metrics, meta, cfg, who, issues, dones, flags,
                step_ord, prep.writes, qacc,
                qthr if cfg.qos else None, stack.flash_counters(state),
                prep.devs, prep.routes, prep.lens, prep.size, prep.params,
                faults=fdict, faulted=meta.get("faulted"))
        self.last_metrics = bundle
        return who, issues, dones, flags, step_ord, prep.lens, prep.size, \
            bundle

    def _replay(self, prep: Prepared, state: Dict, dev, start_tick: int):
        """The whole replay in one call of :func:`~repro_torch.kernels.
        replay_scan.replay_multi` on ``dev``: its ``(who, issues, dones,
        flags, qacc, qthr)``."""
        from repro_torch.kernels.replay_scan import replay_multi

        return replay_multi(
            prep.cfg, prep.params, state, on_device(prep.addrs, dev),
            on_device(prep.writes, dev), on_device(prep.lens, dev),
            on_device(prep.devs, dev), on_device(prep.routes, dev),
            start_tick=start_tick, retries=on_device(prep.retries, dev))

    def _chunked(self, prep: Prepared, state: Dict, dev, start_tick: int,
                 want_lat: bool, chunk: int):
        """The chunked replay: launches of at most ``chunk`` steps over
        each host's window of ``chunk`` accesses from its cursor, through
        one carry (the JAX package's ``_run_chunked``).  Returns ``(who,
        issues, dones, flags, qacc, qthr, fold)``: the step columns
        (numpy, ``None`` without ``want_lat``) and the
        :class:`~repro_torch.core.replay.metrics.StreamFold` of a replay
        that keeps none."""
        import torch

        from repro_torch.core.replay.metrics import StreamFold
        from repro_torch.kernels import replay_scan as rs

        cfg = prep.cfg
        H, total = cfg.num_hosts, int(prep.lens.sum())
        carry = rs.new_multi_carry(cfg, prep.params, dev, start_tick)
        fold = (None if want_lat else
                StreamFold(self.metrics, cfg.stack.kind, dev, n_hosts=H,
                           n_devs=cfg.num_devs, size=prep.size,
                           start_tick=start_tick))
        lens = torch.from_numpy(prep.lens).to(dev)
        cols = (prep.addrs, prep.writes, prep.devs, prep.routes, prep.retries)
        parts = []
        while carry.seen < total:
            base = rs.cursors(carry, H)
            win = []
            for x in cols:
                if x is None:
                    win.append(None)
                    continue
                w = np.zeros((H, chunk) + x.shape[2:], x.dtype)
                for i in range(H):
                    b = int(base[i])
                    e = min(b + chunk, int(prep.lens[i]))
                    w[i, :max(e - b, 0)] = x[i, b:e]
                win.append(torch.from_numpy(w).to(dev))
            addrs, writes, devs, routes, retries = win
            out = rs.replay_multi(
                cfg, prep.params, state, addrs, writes, lens, devs, routes,
                start_tick=start_tick, retries=retries, carry=carry,
                base=base)
            who, issues, dones, flags, qacc, qthr = out
            if want_lat:
                parts.append([x.cpu().numpy() for x in (who, issues, dones,
                                                        flags)])
                continue
            fold_window(fold, H, who, issues, dones, flags, writes, devs)
        qacc, qthr = qacc.cpu().numpy(), qthr.cpu().numpy()
        if not want_lat:
            return None, None, None, None, qacc, qthr, fold
        who, issues, dones, flags = (np.concatenate([p[j] for p in parts])
                                     for j in range(4))
        return who, issues, dones, flags, qacc, qthr, None

    @staticmethod
    def aggregate_scalars(fold, lens, size: int,
                          start_tick: int = 0) -> MultiHostResult:
        """The ``return_latencies=False`` twin of :meth:`aggregate`: fold
        the per-host first / last / sum / count scalars of a
        :class:`~repro_torch.core.replay.metrics.StreamFold` (O(hosts),
        never O(trace)) into the same result shape."""
        firsts, lasts, sums, cnts = (getattr(fold, k).cpu().numpy()
                                     for k in ("first", "last", "sum", "cnt"))
        per_host: List[TraceResult] = []
        first_list, last_list = [], []
        for i in range(np.asarray(lens).size):
            n = int(cnts[i])
            first = int(firsts[i]) if n else None
            last = max(int(lasts[i]), start_tick) if n else start_tick
            per_host.append(TraceResult(
                accesses=n, bytes_moved=n * size,
                elapsed_ticks=(last - first) if first is not None else 0,
                sum_latency_ticks=int(sums[i]),
                end_tick=last))
            if first is not None:
                first_list.append(first)
            last_list.append(last)
        first_all = min(first_list, default=start_tick)
        return MultiHostResult(per_host=per_host,
                               elapsed_ticks=max(last_list) - first_all)

    def _results(self, who, issues, dones, flags, step_ord, lens, size,
                 bundle, start_tick: int) -> MultiHostResult:
        """Per-host :class:`ReplayResult`\\ s (latency, hit, dirty-evict
        and poison flags, and under transport faults the availability
        series) and the cluster aggregate, with the bundle attached."""
        res = self.aggregate(who, issues, dones, lens, size, start_tick)
        poisoned = any(getattr(getattr(t, "fault_plan", None), "has_poison",
                               False) for t in self.targets)
        flags_deg = self.fault_flags
        per_host = []
        for i, r in enumerate(res.per_host):
            m = who == i
            f = flags[m]
            avail = None
            if flags_deg is not None:
                from repro_torch.core.replay import metrics as _metrics
                n = int(lens[i])
                avail = _metrics.availability_series(
                    issues[m], dones[m], flags_deg[0][i, :n],
                    flags_deg[1][i, :n], spec=self.metrics,
                    start_tick=start_tick)
            per_host.append(ReplayResult(
                accesses=r.accesses, bytes_moved=r.bytes_moved,
                elapsed_ticks=r.elapsed_ticks,
                sum_latency_ticks=r.sum_latency_ticks, end_tick=r.end_tick,
                latency_ticks=dones[m] - issues[m],
                hit_flags=(f & 1).astype(bool),
                evict_flags=(f & 2).astype(bool), gc_runs=self.last_gc_runs,
                poison_flags=(((f >> POISON_BIT) & 1).astype(bool)
                              if poisoned else None),
                availability=avail))
        res.per_host = per_host
        return self._attach(res, bundle)

    @staticmethod
    def _attach(res: MultiHostResult, bundle) -> MultiHostResult:
        if bundle is not None:
            res.metrics = bundle
            for r in res.per_host:
                r.metrics = bundle
        return res

    def run(self, traces: Sequence, start_tick: int = 0,
            return_latencies: bool = True,
            chunk_size=None) -> MultiHostResult:
        out = self._execute_prepared(self.prepare(traces), start_tick,
                                     want_lat=bool(return_latencies),
                                     chunk_size=chunk_size)
        if not return_latencies:
            return out
        return self._results(*out, start_tick=start_tick)

    def run_arrays(self, addrs, writes, *, lens=None, size: int = 64,
                   start_tick: int = 0, return_latencies: bool = True,
                   chunk_size=None) -> MultiHostResult:
        """:meth:`run` over already-columnar ``(H, L)`` trace arrays (see
        :meth:`prepare_arrays`)."""
        prep = self.prepare_arrays(addrs, writes, lens=lens, size=size)
        out = self._execute_prepared(prep, start_tick,
                                     want_lat=bool(return_latencies),
                                     chunk_size=chunk_size)
        if not return_latencies:
            return out
        return self._results(*out, start_tick=start_tick)

    def run_recorded(self, traces: Sequence, start_tick: int = 0,
                     chunk_size=None
                     ) -> Tuple[MultiHostResult, List[np.ndarray]]:
        """:meth:`run` plus the per-access latency stream of every host
        (in that host's issue order)."""
        res = self.run(traces, start_tick, chunk_size=chunk_size)
        return res, [r.latency_ticks for r in res.per_host]


def on_device(x: Optional[np.ndarray], dev):
    """A host array as a tensor on ``dev`` (``None`` stays ``None``)."""
    import torch

    return None if x is None else torch.from_numpy(x).to(dev)


def fold_window(fold, num_hosts: int, who, issues, dones, flags, writes,
                devs) -> None:
    """Fold one launch's steps into ``fold`` (a :class:`~repro_torch.core.
    replay.metrics.StreamFold`), each with its access's write flag and
    device from the window columns ``writes`` / ``devs`` ``(H, W)``: a
    host's steps of the launch take its window's accesses in order."""
    import torch

    host = who.long()
    order = torch.sort(host, stable=True).indices
    counts = torch.bincount(host, minlength=num_hosts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(host)
    pos[order] = (torch.arange(host.numel(), device=host.device)
                  - starts[host[order]])
    fold.update(issues, dones, flags, writes[host, pos], host=host,
                dev=devs[host, pos].long())


def step_ordinals(who: np.ndarray, num_hosts: int) -> np.ndarray:
    """Each step's access ordinal within its host's trace: steps take a
    host's accesses in trace order, so it is the count of that host's
    earlier steps."""
    who = np.asarray(who, np.int64)
    order = np.argsort(who, kind="stable")
    counts = np.bincount(who, minlength=num_hosts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ords = np.empty(who.size, np.int64)
    ords[order] = np.arange(who.size) - np.repeat(starts, counts)
    return ords
