"""Switch-port timing: per-port serialization occupancy (busy-until), with
optional weighted QoS arbitration.

A :class:`SwitchPort` is one *directed* egress port of the fabric — the unit
of bandwidth contention.  It uses the same analytic busy-until discipline as
:class:`repro_torch.core.devices.CXLLink.traverse`: a transfer occupies the port
for ``nbytes / bw`` and later arrivals queue behind it.  Store-and-forward
means a packet is fully serialized onto a link before the next hop begins,
so multi-hop paths pay serialization once per hop.

QoS discipline (``weight_by_origin``): weighted virtual-finish-time
arbitration in requester-throttling form, the way CXL.mem QoS actually
operates (the switch signals load back to the host, which slows its
injection — in-flight data is never reordered).  Packets always serialize
at their FCFS position — ``busy_until``, and every downstream busy-until
they touch, advances exactly as without QoS, so the port never idles and
the one-pass analytic model keeps processing order aligned with simulated
time.  Separately, each origin *o* carries a virtual finish time
``vft[o]`` advancing by ``occ * W_active / w_o`` per transfer — *o*'s
service interval on a GPS (generalized processor sharing) port shared with
the currently-contending origins.  When *o* is virtually backlogged
(``vft[o] > now``: it has been injecting faster than its weighted share),
:meth:`qos_update` returns that virtual finish as a *completion floor*;
the fabric applies the floor to the final acknowledgment the issuing host
sees (never to the data path), so the host's line-fill-buffer slots recycle
no faster than its share while other origins' packets flow untouched.
Under contention the bandwidth split converges to the weight ratio — the
allocation a smallest-virtual-finish-time pick over queued transfers would
produce; a lone (or under-share, or sparse) origin is never floored, so
the discipline is work-conserving and degenerates to FCFS exactly.

When every configured weight is equal the port runs the legacy FCFS path
bit-for-bit (the arbitration is skipped entirely, not just neutral).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.engine import ns, to_s

# An origin counts toward the contending (active) weight sum if it arrived
# at the port within this many serialization quanta — generous enough that a
# closed-loop host throttled below its fair share still registers, short
# enough that a finished trace releases its share promptly.
ACTIVE_WINDOW_OCC = 16


@dataclass
class SwitchPort:
    """Directed egress port ``src -> dst`` with busy-until occupancy."""

    src: str
    dst: str
    bw_gbps: float
    prop_ns: float = 0.0

    busy_until: int = 0
    packets: int = 0
    bytes: int = 0
    queued_ticks: int = 0     # total ticks transfers waited for the port
    occupied_ticks: int = 0   # total ticks the port was serializing
    # QoS observability: transfers whose origin was virtually backlogged
    # here (qos_update returned a nonzero completion floor)
    qos_throttle_events: int = 0
    # fault observability: extra full serializations charged by CRC-retry
    # bursts (see repro_torch.core.faults) — each retry re-serializes the flit
    crc_retries: int = 0
    # traffic attribution: originating endpoint -> bytes carried for it
    bytes_by_origin: Dict[str, int] = field(default_factory=dict)
    # QoS weights: originating endpoint -> relative share of this port under
    # contention.  An empty or all-equal map keeps the exact FCFS
    # discipline (the gate looks at configured values only).  Missing
    # origins default to 1.0 when arbitration is active — but
    # Fabric.set_qos_weights requires every host be configured explicitly,
    # so the default only matters for hand-built ports.
    weight_by_origin: Dict[str, float] = field(default_factory=dict)
    # weighted-arbitration state (only touched when QoS is enabled):
    # per-origin virtual finish times and last arrival ticks
    _vft: Dict[str, int] = field(default_factory=dict)
    _last_arr: Dict[str, int] = field(default_factory=dict)

    @property
    def qos_enabled(self) -> bool:
        """Weighted arbitration runs only when configured weights differ;
        all-equal weights mean FCFS, taken on the exact legacy path."""
        w = self.weight_by_origin
        return bool(w) and min(w.values()) != max(w.values())

    def weight_of(self, origin: str) -> float:
        return float(self.weight_by_origin.get(origin, 1.0))

    def set_weights(self, weights: Dict[str, float]) -> None:
        for origin, w in weights.items():
            if not w > 0:
                raise ValueError(
                    f"QoS weight for {origin!r} must be > 0, got {w}")
        self.weight_by_origin = dict(weights)

    def occ_ticks(self, nbytes: int) -> int:
        """Serialization occupancy for ``nbytes`` — THE definition of this
        port's busy-until increment.  Both the interpreted path
        (:meth:`transmit`) and the fused replay's route-tensor export
        (:meth:`Fabric.route_occupancy`) call this, so the rule cannot
        drift between them."""
        return ns(nbytes / self.bw_gbps)   # bytes / (GB/s) == ns

    def qos_update(self, now: int, nbytes: int, origin: str) -> int:
        """Advance ``origin``'s virtual finish time for one transfer
        arriving at ``now`` and return the completion *floor* it imposes
        (0 when the origin is within its share).  The virtual clock
        advances by ``occ * W_active / w_o`` per transfer — origin *o*'s
        service interval on a GPS port shared with the currently-contending
        origins, where a peer contends if it arrived within the last
        :data:`ACTIVE_WINDOW_OCC` serialization quanta.  An idle spell
        resyncs the clock to the arrival tick, so sparse traffic is never
        penalized and no credit is banked; only a virtually backlogged
        origin (``vft > now``) is floored.  The float expressions here are
        mirrored operation-for-operation (same summation order, same
        truncation) by the fused multi-host scan in
        :mod:`repro_torch.core.replay.multihost`; do not reorder them."""
        occ = self.occ_ticks(nbytes)
        w_self = self.weight_of(origin)
        prev = self._vft.get(origin, 0)
        win = occ * ACTIVE_WINDOW_OCC
        w_active = 0.0
        for o in sorted(set(self._last_arr) | {origin}):
            if o == origin or self._last_arr[o] + win > now:
                w_active = w_active + self.weight_of(o)
        pace = int(occ * (w_active / w_self))
        self._vft[origin] = max(prev, now) + pace
        self._last_arr[origin] = now
        if prev > now:
            self.qos_throttle_events += 1
            return prev + pace
        return 0

    def transmit(self, now: int, nbytes: int,
                 origin: Optional[str] = None, retries: int = 0) -> int:
        """Serialize ``nbytes`` onto this port starting no earlier than
        ``now``; returns the tick the last byte arrives at ``dst``.
        ``origin`` attributes the traffic to its source endpoint.  QoS
        never bends this data path — weighted arbitration floors the final
        host acknowledgment via :meth:`qos_update` instead.  ``retries``
        charges that many extra full serializations (CXL link-level
        CRC-retry: the whole flit goes back on the wire), occupying the
        port for ``occ * (1 + retries)``; ``bytes`` stays goodput."""
        occ = self.occ_ticks(nbytes) * (1 + retries)
        start = max(now, self.busy_until)
        self.queued_ticks += start - now
        self.busy_until = start + occ
        self.packets += 1
        self.bytes += nbytes
        self.occupied_ticks += occ
        self.crc_retries += retries
        if origin is not None:
            self.bytes_by_origin[origin] = \
                self.bytes_by_origin.get(origin, 0) + nbytes
        return start + occ + ns(self.prop_ns)

    def utilization(self, elapsed_ticks: int) -> float:
        """Fraction of ``elapsed_ticks`` the port spent serializing."""
        return self.occupied_ticks / elapsed_ticks if elapsed_ticks else 0.0

    def achieved_gbps(self, elapsed_ticks: int) -> float:
        sec = to_s(elapsed_ticks)
        return self.bytes / sec / 1e9 if sec else 0.0

    def reset(self) -> None:
        self.busy_until = 0
        self.packets = 0
        self.bytes = 0
        self.queued_ticks = 0
        self.occupied_ticks = 0
        self.qos_throttle_events = 0
        self.crc_retries = 0
        self.bytes_by_origin = {}
        self._vft = {}
        self._last_arr = {}
