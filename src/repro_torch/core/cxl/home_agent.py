"""Home Agent: the gem5 ``Bridge`` analogue between MemBus and IOBus.

Responsibilities (paper §II-B):

* address-to-port mapping — decide whether a packet targets local memory or
  a CXL range;
* packet-format conversion — gem5 ``Packet`` → CXL flit for CXL-bound
  requests (``ReadReq``→``M2SReq``, ``WriteReq``→``M2SRwD``), warning on any
  other command;
* coherence-field handling — ``MetaValue`` from the request semantics;
* latency accounting — the CXL.mem protocol-handling latency (25 ns) is
  charged in the Home Agent event loop before forwarding; the full
  CXL network traversal is 50 ns round trip (Table I, validated against the
  authors' FPGA prototype).
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.cxl.flit import (
    CXLCommand,
    CXLFlit,
    MemCmd,
    Packet,
    decode_flit,
    encode_flit,
    flit_to_response_packet,
    packet_to_flit,
)
from repro_torch.core.engine import EventEngine, ns

log = logging.getLogger(__name__)

# Table I / §III-A constants.
CXL_PROTOCOL_NS = 25.0        # sub-protocol processing per direction
CXL_NETWORK_RT_NS = 50.0      # total CXL.mem network round-trip latency


@dataclass(frozen=True)
class AddressRange:
    base: int
    size: int

    def contains(self, addr: int) -> bool:
        return self.base <= addr < self.base + self.size

    @property
    def end(self) -> int:
        return self.base + self.size


class HomeAgent:
    """Routes packets; converts CXL-bound ones to flits and charges latency."""

    def __init__(self, engine: EventEngine) -> None:
        self.engine = engine
        self._ports: list[Tuple[AddressRange, object, bool]] = []  # (range, device, is_cxl)
        self._tags = itertools.count()
        self._inflight: Dict[int, Tuple[Packet, Callable[[Packet], None]]] = {}
        self.stats = {
            "pkts_routed": 0,
            "pkts_converted": 0,
            "flit_bytes_m2s": 0,
            "flit_bytes_s2m": 0,
            "warnings": 0,
        }

    # ------------------------------------------------------------- topology
    def attach(self, rng: AddressRange, device: object, is_cxl: bool) -> None:
        for existing, _, _ in self._ports:
            if rng.base < existing.end and existing.base < rng.end:
                raise ValueError(f"overlapping address ranges: {rng} vs {existing}")
        self._ports.append((rng, device, is_cxl))

    def route(self, addr: int) -> Optional[Tuple[AddressRange, object, bool]]:
        for rng, dev, is_cxl in self._ports:
            if rng.contains(addr):
                return rng, dev, is_cxl
        return None

    # ------------------------------------------------------------- requests
    def send(self, pkt: Packet, on_response: Callable[[Packet], None]) -> None:
        """Issue a packet; ``on_response`` fires when the device responds."""
        port = self.route(pkt.addr)
        if port is None:
            raise ValueError(f"address {pkt.addr:#x} maps to no device")
        rng, dev, is_cxl = port
        self.stats["pkts_routed"] += 1

        if not is_cxl:
            # Local path: no conversion (paper: "If not, no packet format
            # conversion occurs").
            dev.access(pkt, on_response)
            return

        if pkt.cmd not in (MemCmd.ReadReq, MemCmd.WriteReq, MemCmd.InvalidateReq,
                           MemCmd.FlushReq, MemCmd.CleanEvict):
            # Paper: "Other requests trigger a warning."
            self.stats["warnings"] += 1
            log.warning("HomeAgent: unconvertible command %s at %#x", pkt.cmd, pkt.addr)
            return

        tag = next(self._tags) & 0xFFFF
        flit = packet_to_flit(pkt, tag)
        wire = encode_flit(flit)  # exercises the wire format
        self.stats["pkts_converted"] += 1
        self.stats["flit_bytes_m2s"] += len(wire) * max(1, flit.length_blocks if flit.opcode is CXLCommand.M2SRwD else 1)
        self._inflight[tag] = (pkt, on_response)
        pkt.is_cxl = True
        pkt.meta_value = flit.meta_value

        # Charge protocol handling in the Home Agent event loop *before*
        # forwarding (paper §II-B-2).  The 25 ns protocol cost is part of the
        # 50 ns total CXL.mem network round trip (Table I): 25 ns on the M2S
        # path here, 25 ns on the S2M path in the responder.
        def forward() -> None:
            dev.access_flit(decode_flit(wire, data=flit.data), self._make_responder(tag))

        self.engine.schedule(ns(CXL_NETWORK_RT_NS / 2), forward)

    def _make_responder(self, tag: int) -> Callable[[CXLFlit], None]:
        def respond(resp_flit: CXLFlit) -> None:
            pkt, cb = self._inflight.pop(tag)
            self.stats["flit_bytes_s2m"] += 64 * (
                resp_flit.length_blocks if resp_flit.opcode is CXLCommand.S2MDRS else 1)
            # Return half of the network round trip on the S2M path.
            def deliver() -> None:
                cb(flit_to_response_packet(resp_flit, pkt))
            self.engine.schedule(ns(CXL_NETWORK_RT_NS / 2), deliver)
        return respond
