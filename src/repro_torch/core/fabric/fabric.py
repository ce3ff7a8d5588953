"""The fabric proper: routed, contended transport between endpoints.

:meth:`Fabric.traverse` mirrors :meth:`repro_torch.core.devices.CXLLink.traverse`
— same analytic busy-until fast path, same return convention (arrival tick
including the CXL.mem round-trip extra) — but walks a routed multi-hop path
with per-port occupancy and per-switch store-and-forward latency.  On a
``direct`` topology with matching parameters it reproduces ``CXLLink``
timing *exactly* (tested), so mounting a device behind the fabric is a
strict generalization of the paper's point-to-point configuration.

Two scheduling/routing refinements are opt-in:

* ``qos_weights`` — per-host weighted virtual-finish-time arbitration on
  every port (see :class:`~repro_torch.core.fabric.switch.SwitchPort`); all-equal
  weights keep the exact FCFS discipline.
* ``ecmp=True`` — per-access load balancing over *all* equal-cost shortest
  paths, selected by a deterministic flow hash over
  ``(src, dst, line_addr)`` (see :mod:`repro_torch.core.fabric.routing`).

:class:`FabricAttachedDevice` composes the fabric with any existing
:class:`~repro_torch.core.devices.MemDevice` unchanged: fabric transport first,
then the device's own media timing.  Devices that embed a private
``CXLLink`` (cxl-dram, cxl-ssd, cxl-ssd-cache) are neutralized via
:meth:`~repro_torch.core.devices.MemDevice.detach_link` so link latency is not
double-counted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.devices import MemDevice
from repro_torch.core.engine import ns
from repro_torch.core.fabric.routing import RoutingTable, flow_hash
from repro_torch.core.fabric.switch import SwitchPort
from repro_torch.core.fabric.topology import SWITCH, Topology, build_topology

DEFAULT_FORWARD_NS = 35.0    # per-switch store-and-forward latency
DEFAULT_RT_EXTRA_NS = 50.0   # Table I: total CXL.mem network round-trip extra
LINE_BYTES = 64              # flow-hash granularity: one cache line


class Fabric:
    """A switch fabric instantiated from a static :class:`Topology`."""

    def __init__(self, topology: Topology,
                 forward_ns: float = DEFAULT_FORWARD_NS,
                 rt_extra_ns: float = DEFAULT_RT_EXTRA_NS,
                 ecmp: bool = False,
                 qos_weights: Optional[Dict[str, float]] = None) -> None:
        topology.validate()
        self.topology = topology
        self.routing = RoutingTable(topology)
        self.forward_ns = forward_ns
        self.rt_extra_ns = rt_extra_ns
        self.ecmp = ecmp
        self.ports: Dict[Tuple[str, str], SwitchPort] = {
            (u, v): SwitchPort(u, v, spec.bw_gbps, spec.prop_ns)
            for (u, v), spec in topology.links.items()
        }
        if qos_weights:
            self.set_qos_weights(qos_weights)
        self.stats = {"transfers": 0, "bytes": 0}
        # ECMP observability: "src->dst" -> per-path selection counts, for
        # pairs that actually have alternatives (len(paths) > 1)
        self.ecmp_counts: Dict[str, List[int]] = {}
        # deterministic fault injection (repro_torch.core.faults.install wires
        # this); counters mirror the fused lanes' fault telemetry
        self.fault_plan = None
        self.fault_stats = {"link_retries": 0, "failovers": 0,
                            "degraded_accesses": 0}

    @classmethod
    def build(cls, kind: str, *, forward_ns: float = DEFAULT_FORWARD_NS,
              rt_extra_ns: float = DEFAULT_RT_EXTRA_NS, ecmp: bool = False,
              qos_weights: Optional[Dict[str, float]] = None,
              **topo_kwargs) -> "Fabric":
        return cls(build_topology(kind, **topo_kwargs),
                   forward_ns=forward_ns, rt_extra_ns=rt_extra_ns,
                   ecmp=ecmp, qos_weights=qos_weights)

    # ---------------------------------------------------------------- QoS
    def set_qos_weights(self, weights: Dict[str, float]) -> None:
        """Install per-origin weights on every port.  Every host of the
        topology must be weighted explicitly — the all-equal-weights FCFS
        shortcut looks only at configured values, so a partially-configured
        map like ``{"h0": 2, "h1": 2}`` on a three-host fabric would
        silently drop the implied 2:2:1 split.  Configure before any
        traffic: the fused replay snapshots a fresh fabric, and mid-run
        weight changes are not part of the modeled discipline."""
        if getattr(self, "stats", {}).get("transfers", 0):
            raise ValueError("set QoS weights before the fabric carries "
                             "traffic (or Fabric.reset() first)")
        hosts = set(self.topology.hosts)
        missing = sorted(hosts - set(weights))
        unknown = sorted(set(weights) - hosts)
        if missing or unknown:
            raise ValueError(
                f"QoS weights must name every host exactly once "
                f"(missing: {missing or 'none'}, not a host: "
                f"{unknown or 'none'})")
        for port in self.ports.values():
            port.set_weights(weights)

    @property
    def qos_enabled(self) -> bool:
        return any(p.qos_enabled for p in self.ports.values())

    # ------------------------------------------------------------ transport
    def path(self, src: str, dst: str) -> List[str]:
        return self.routing.path(src, dst)

    def paths(self, src: str, dst: str) -> List[List[str]]:
        """The ECMP path set actually used for ``src -> dst``: all
        equal-cost shortest paths when ECMP is on, else the primary path."""
        if self.ecmp:
            return self.routing.paths(src, dst)
        return [self.routing.path(src, dst)]

    def select_path(self, src: str, dst: str,
                    line_addr: Optional[int]) -> List[str]:
        if self.ecmp and line_addr is not None:
            return self.routing.select(src, dst, line_addr)
        return self.routing.path(src, dst)

    def route_occupancy(self, src: str, dst: str, nbytes: int,
                        choice: Optional[int] = None
                        ) -> List[Tuple[Tuple[str, str], int, int]]:
        """Tensor export of :meth:`traverse`'s per-hop timing for ``nbytes``:
        one ``(port_key, occ_ticks, after_ticks)`` triple per hop, where
        ``after`` folds propagation plus the per-switch store-and-forward
        latency, each rounded separately with ``ns()`` exactly as
        :meth:`traverse` does.  ``choice`` picks a route from the ECMP path
        set (default: the primary path).  The fused replay engines build
        their route tensors from this single definition so the busy-until
        rule cannot drift between the interpreted and vectorized paths."""
        if choice is None:
            path = self.routing.path(src, dst)
        else:
            path = self.paths(src, dst)[choice]
        return self.path_occupancy(path, nbytes)

    def path_occupancy(self, path: List[str], nbytes: int
                       ) -> List[Tuple[Tuple[str, str], int, int]]:
        """:meth:`route_occupancy` for an *explicit* node sequence — the
        fused fault lanes build union route tables (failover routes have
        different hop counts) from this same single definition."""
        hops = []
        for u, v in zip(path, path[1:]):
            port = self.ports[(u, v)]
            after = ns(port.prop_ns)
            if self.topology.kind(v) == SWITCH:
                after += ns(self.forward_ns)
            hops.append(((u, v), port.occ_ticks(nbytes), after))
        return hops

    def select_faulted(self, src: str, dst: str,
                       line_addr: Optional[int], ordinal: Optional[int]
                       ) -> Tuple[List[str], bool, bool]:
        """Route selection under the installed fault plan: returns
        ``(path, degraded, failover)``.  ``degraded`` — the access routed
        over a pair whose (ECMP) path set was reduced by down ports;
        ``failover`` — the chosen path differs from the fault-free choice.
        Pure function of the routing tables and the plan, so the fused
        lanes precompute their per-access route columns with exactly this.
        Raises :class:`~repro_torch.core.faults.DeviceUnreachable` when every
        route is down."""
        plan = self.fault_plan
        down = (plan.down_links_at(ordinal)
                if plan is not None and ordinal is not None and plan.has_down
                else frozenset())
        if self.ecmp and line_addr is not None:
            base = self.routing.paths(src, dst)
            paths = self.routing.paths(src, dst, down=down) if down else base
            degraded = bool(down) and paths != base
            if len(paths) > 1:
                path = paths[flow_hash(src, dst, line_addr) % len(paths)]
            else:
                path = paths[0]
            if not degraded:
                return path, False, False
            nominal = (base[flow_hash(src, dst, line_addr) % len(base)]
                       if len(base) > 1 else base[0])
            return path, True, path != nominal
        nominal = self.routing.path(src, dst)
        if not down:
            return nominal, False, False
        path = self.routing.paths(src, dst, down=down)[0]
        return path, path != nominal, path != nominal

    def traverse_qos(self, now: int, src: str, dst: str, nbytes: int,
                     line_addr: Optional[int] = None,
                     ordinal: Optional[int] = None) -> Tuple[int, int]:
        """Carry ``nbytes`` from ``src`` to ``dst``.  Returns ``(arrival,
        ack_floor)``: the physical completion tick (arrival + round-trip
        extra, queueing on every port's busy-until along the route — the
        data path is pure FCFS, identical with or without QoS) and the
        weighted-arbitration floor on the *final host acknowledgment*
        (0 when no port regulates this origin).  Callers must apply the
        floor after media service, never to the data path — a floored
        timestamp fed into shared busy-until state would block other
        hosts' earlier traffic.  ``line_addr`` keys the ECMP flow hash
        (ignored unless the fabric was built with ``ecmp=True``).
        ``ordinal`` is the issuing host's access ordinal, keying the
        installed fault plan (down windows exclude dead paths — rerouting
        onto longer paths when a whole equal-cost set is down — and
        CRC-retry bursts charge extra serializations per port); ``None``
        leaves the plan unconsulted.  QoS pacing stays keyed on the clean
        occupancy — retries stretch serialization, not the host's
        entitlement."""
        plan = self.fault_plan
        if plan is not None and ordinal is not None and plan.active:
            path, degraded, failover = self.select_faulted(
                src, dst, line_addr, ordinal)
            if degraded:
                self.fault_stats["degraded_accesses"] += 1
                if failover:
                    self.fault_stats["failovers"] += 1
            elif (self.ecmp and line_addr is not None
                    and self.routing.num_paths(src, dst) > 1):
                paths = self.routing.paths(src, dst)
                k = flow_hash(src, dst, line_addr) % len(paths)
                counts = self.ecmp_counts.setdefault(
                    f"{src}->{dst}", [0] * len(paths))
                counts[k] += 1
            retry_on = plan.has_link
        elif self.ecmp and line_addr is not None:
            paths = self.routing.paths(src, dst)
            if len(paths) > 1:
                k = flow_hash(src, dst, line_addr) % len(paths)
                counts = self.ecmp_counts.setdefault(
                    f"{src}->{dst}", [0] * len(paths))
                counts[k] += 1
                path = paths[k]
            else:
                path = paths[0]
            retry_on = False
        else:
            path = self.routing.path(src, dst)
            retry_on = False
        t = now
        floor = 0
        for u, v in zip(path, path[1:]):
            port = self.ports[(u, v)]
            r = plan.link_retries((u, v), ordinal) if retry_on else 0
            if r:
                self.fault_stats["link_retries"] += r
            if port.qos_enabled:
                floor = max(floor, port.qos_update(t, nbytes, src))
            t = port.transmit(t, nbytes, origin=src, retries=r)
            if self.topology.kind(v) == SWITCH:
                t += ns(self.forward_ns)
        self.stats["transfers"] += 1
        self.stats["bytes"] += nbytes
        return t + ns(self.rt_extra_ns), floor

    def traverse(self, now: int, src: str, dst: str, nbytes: int,
                 line_addr: Optional[int] = None,
                 ordinal: Optional[int] = None) -> int:
        """The :meth:`traverse_qos` physical arrival tick alone — the exact
        :meth:`CXLLink.traverse` contract.  QoS-floored mounts go through
        :meth:`traverse_qos` (the floor binds the host ack, not the data
        arrival this returns)."""
        return self.traverse_qos(now, src, dst, nbytes, line_addr,
                                 ordinal=ordinal)[0]

    # ------------------------------------------------------------ mounting
    def mount(self, host: str, device_node: str, device: MemDevice,
              detach_link: bool = True) -> "FabricAttachedDevice":
        """Attach ``device`` at ``device_node`` as seen from ``host``."""
        return FabricAttachedDevice(self, host, device_node, device,
                                    detach_link=detach_link)

    # -------------------------------------------------------------- reports
    def port_report(self, elapsed_ticks: int) -> List[dict]:
        """Per-port traffic/occupancy summary, sorted by bytes desc then name
        (deterministic).  ``utilization`` is the fraction of the elapsed
        window the port spent serializing; ``bytes_by_host`` attributes the
        port's traffic to the originating endpoints; ``qos_weights`` echoes
        the arbitration weights when weighted scheduling is active."""
        rows = []
        for p in self.ports.values():
            if not p.packets:
                continue
            row = {
                "port": f"{p.src}->{p.dst}",
                "bytes": p.bytes,
                "packets": p.packets,
                "utilization": p.utilization(elapsed_ticks),
                "achieved_gbps": p.achieved_gbps(elapsed_ticks),
                "queued_ticks": p.queued_ticks,
                "qos_throttle_events": p.qos_throttle_events,
                "bytes_by_host": dict(sorted(p.bytes_by_origin.items())),
            }
            if p.qos_enabled:
                row["qos_weights"] = dict(sorted(p.weight_by_origin.items()))
            rows.append(row)
        rows.sort(key=lambda r: (-r["bytes"], r["port"]))
        return rows

    def bottleneck_port(self, src: str, dst: str) -> SwitchPort:
        """The minimum-bandwidth port along the primary route (first on
        ties)."""
        path = self.routing.path(src, dst)
        hops = [self.ports[(u, v)] for u, v in zip(path, path[1:])]
        return min(hops, key=lambda p: p.bw_gbps)

    def reset(self) -> None:
        for p in self.ports.values():
            p.reset()
        self.stats = {"transfers": 0, "bytes": 0}
        self.ecmp_counts = {}
        self.fault_stats = {"link_retries": 0, "failovers": 0,
                            "degraded_accesses": 0}


class FabricAttachedDevice(MemDevice):
    """Any :class:`MemDevice` mounted behind the fabric, unchanged.

    ``service`` = fabric transport (routed, contended) + the inner device's
    own media timing.  Presents the standard ``MemDevice`` interface so
    :class:`~repro_torch.core.workloads.driver.TraceDriver` and the event-driven
    path both work against fabric-attached memory.
    """

    is_cxl = True

    def __init__(self, fabric: Fabric, host: str, device_node: str,
                 inner: MemDevice, detach_link: bool = True) -> None:
        super().__init__(inner.engine)
        for node, kind in ((host, "host"), (device_node, "device")):
            if node not in fabric.topology.kinds:
                raise ValueError(f"unknown {kind} node {node!r}")
        fabric.routing.path(host, device_node)  # fail fast if unroutable
        self.fabric = fabric
        self.host = host
        self.device_node = device_node
        # Detach only after validation: a failed mount must not leave the
        # caller's device silently mutated (NullLink'd).
        self.inner = inner.detach_link() if detach_link else inner
        self.name = f"fabric:{inner.name}@{device_node}"
        # per-mount access ordinal: the fault-plan key for this host's
        # traffic (the fused lanes key their precomputed columns on the
        # trace index, which is exactly this counter)
        self._fault_ord = 0

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        ordinal = None
        if self.fabric.fault_plan is not None:
            ordinal = self._fault_ord
            self._fault_ord += 1
        t, floor = self.fabric.traverse_qos(now, self.host, self.device_node,
                                            size,
                                            line_addr=addr // LINE_BYTES,
                                            ordinal=ordinal)
        return max(self.inner.service(t, addr, size, write, posted), floor)
