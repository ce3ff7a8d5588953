"""CXL.mem sub-protocol flit codec.

Implements the transaction subset the paper adds to gem5's packet layer
(§II-B): ``M2SReq`` (master→subordinate read), ``M2SRwD`` (master→
subordinate request-with-data, i.e. write), ``S2MDRS`` (subordinate→master
data response) and ``S2MNDR`` (subordinate→master no-data response), plus the
coherence ``MetaField``/``MetaValue`` handling of §II-B-3.

A CXL flit is 64 bytes (the paper's granularity; the CXL 2.0 spec carries a
68 B flit on the wire — 64 B payload + 4 B CRC, which we model as protocol
latency, not payload).  We pack a real binary header so the codec can be
property-tested for roundtripping:

``byte 0``      opcode (CXLCommand)
``byte 1``      meta_field << 4 | meta_value
``byte 2``      snp_type
``bytes 3-4``   tag (little endian)
``bytes 5-12``  address (64-bit LE; 64 B aligned for cacheline ops)
``bytes 13-14`` length in logical blocks (for SSD-bound multi-line requests)
``byte 15``     flags (bit0: poison, bit1: dirty-evict hint)
``bytes 16-63`` inline data window (first 48 B) — full 64 B data rides in
                ``CXLFlit.data`` (header + data slots in hardware).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Optional

CXL_FLIT_BYTES = 64
CACHELINE_BYTES = 64


class MemCmd(enum.Enum):
    """gem5-side memory commands (the subset the Bridge converts)."""

    ReadReq = enum.auto()
    WriteReq = enum.auto()
    ReadResp = enum.auto()
    WriteResp = enum.auto()
    CleanEvict = enum.auto()        # flush without invalidate
    InvalidateReq = enum.auto()     # invalidate
    FlushReq = enum.auto()          # writeback-flush, line stays shared
    # CXL.mem transaction types added by the paper:
    M2SReq = enum.auto()
    M2SRwD = enum.auto()
    S2MDRS = enum.auto()
    S2MNDR = enum.auto()


class CXLCommand(enum.IntEnum):
    """Opcode field inside the flit header."""

    M2SReq = 0x1
    M2SRwD = 0x2
    S2MDRS = 0x3
    S2MNDR = 0x4


class MetaField(enum.IntEnum):
    """Which metadata the host is communicating about."""

    Meta0State = 0x0
    NoOp = 0x3


class MetaValue(enum.IntEnum):
    """Host cache-state hint carried in M2S messages (§II-B-3)."""

    Invalid = 0x0   # host holds no cacheable copy
    Any = 0x2       # host may hold shared/exclusive/modified copy
    Shared = 0x3    # host retains >=1 copy in shared state


class SnpType(enum.IntEnum):
    NoOp = 0x0
    SnpData = 0x1
    SnpCur = 0x2
    SnpInv = 0x3


@dataclass
class Packet:
    """gem5-style packet traversing MemBus/IOBus."""

    cmd: MemCmd
    addr: int
    size: int = CACHELINE_BYTES
    data: Optional[bytes] = None
    req_id: int = 0
    # set by the bridge when it converts the packet
    is_cxl: bool = False
    meta_value: MetaValue = MetaValue.Any
    # CXL poison: the device flagged the returned data as corrupt; the
    # flag rides the response flit (byte 15 bit 0) end-to-end and must
    # surface to the requester as status, never as fabricated latency
    poison: bool = False

    def is_read(self) -> bool:
        return self.cmd in (MemCmd.ReadReq, MemCmd.M2SReq)

    def is_write(self) -> bool:
        return self.cmd in (MemCmd.WriteReq, MemCmd.M2SRwD)


@dataclass
class CXLFlit:
    """A decoded CXL.mem flit."""

    opcode: CXLCommand
    addr: int
    tag: int
    meta_field: MetaField = MetaField.Meta0State
    meta_value: MetaValue = MetaValue.Any
    snp_type: SnpType = SnpType.NoOp
    length_blocks: int = 1          # logical blocks (for SSD-bound requests)
    poison: bool = False
    dirty_evict: bool = False
    data: bytes = field(default=b"", repr=False)

    @property
    def is_request(self) -> bool:
        return self.opcode in (CXLCommand.M2SReq, CXLCommand.M2SRwD)


_HEADER = struct.Struct("<BBBHQHB48s")
assert _HEADER.size == CXL_FLIT_BYTES, _HEADER.size


def encode_flit(flit: CXLFlit) -> bytes:
    """Pack a flit into its 64-byte wire format (header flit)."""
    if flit.addr % CACHELINE_BYTES and flit.opcode in (CXLCommand.M2SReq, CXLCommand.M2SRwD):
        raise ValueError(f"unaligned CXL.mem address: {flit.addr:#x}")
    if not 0 <= flit.tag < (1 << 16):
        raise ValueError(f"tag out of range: {flit.tag}")
    if not 0 <= flit.length_blocks < (1 << 16):
        raise ValueError(f"length_blocks out of range: {flit.length_blocks}")
    flags = (1 if flit.poison else 0) | ((1 if flit.dirty_evict else 0) << 1)
    inline = flit.data[:48].ljust(48, b"\x00")
    return _HEADER.pack(
        int(flit.opcode),
        (int(flit.meta_field) << 4) | int(flit.meta_value),
        int(flit.snp_type),
        flit.tag,
        flit.addr,
        flit.length_blocks,
        flags,
        inline,
    )


def decode_flit(raw: bytes, data: bytes = b"") -> CXLFlit:
    """Unpack a 64-byte header flit (optionally attaching full data slots)."""
    if len(raw) != CXL_FLIT_BYTES:
        raise ValueError(f"flit must be {CXL_FLIT_BYTES} bytes, got {len(raw)}")
    op, meta, snp, tag, addr, length, flags, inline = _HEADER.unpack(raw)
    if flags & ~0b11:
        # decode-side guard: only poison (bit0) and dirty-evict (bit1) are
        # defined — a set reserved bit means a corrupt or misframed flit
        raise ValueError(f"reserved flag bits set in flit header: {flags:#04x}")
    return CXLFlit(
        opcode=CXLCommand(op),
        addr=addr,
        tag=tag,
        meta_field=MetaField(meta >> 4),
        meta_value=MetaValue(meta & 0xF),
        snp_type=SnpType(snp),
        length_blocks=length,
        poison=bool(flags & 1),
        dirty_evict=bool(flags & 2),
        data=data if data else bytes(inline).rstrip(b"\x00"),
    )


def meta_value_for(cmd: MemCmd) -> MetaValue:
    """§II-B-3 conversion logic: derive MetaValue from the gem5 request.

    * If the packet does not invalidate or flush the line → ``Any``.
    * If it invalidates → ``Invalid``.
    * If it flushes without invalidating → ``Shared``.
    """
    if cmd in (MemCmd.InvalidateReq, MemCmd.CleanEvict):
        return MetaValue.Invalid
    if cmd is MemCmd.FlushReq:
        return MetaValue.Shared
    return MetaValue.Any


def packet_to_flit(pkt: Packet, tag: int) -> CXLFlit:
    """Bridge conversion: gem5 Packet → CXL.mem flit (§II-B-2).

    ReadReq → M2SReq; WriteReq → M2SRwD.  Other commands carry their
    coherence action in the MetaValue of an M2SReq (MemRdFwd-style).
    """
    mv = meta_value_for(pkt.cmd)
    nblocks = max(1, (pkt.size + CACHELINE_BYTES - 1) // CACHELINE_BYTES)
    if pkt.cmd is MemCmd.ReadReq:
        op = CXLCommand.M2SReq
        data = b""
    elif pkt.cmd is MemCmd.WriteReq:
        op = CXLCommand.M2SRwD
        data = pkt.data or b"\x00" * pkt.size
    elif pkt.cmd in (MemCmd.InvalidateReq, MemCmd.FlushReq, MemCmd.CleanEvict):
        op = CXLCommand.M2SReq
        data = b""
    else:
        raise ValueError(f"unconvertible command reaches the bridge: {pkt.cmd}")
    return CXLFlit(
        opcode=op,
        addr=pkt.addr - (pkt.addr % CACHELINE_BYTES),
        tag=tag & 0xFFFF,
        meta_value=mv,
        length_blocks=nblocks,
        data=data,
    )


def flit_to_response_packet(flit: CXLFlit, req: Packet) -> Packet:
    """Device response flit → gem5 response packet.  The poison flag the
    device set on the flit propagates to the packet, so the requester sees
    corrupt data as *status* (this used to be dropped here — the flit codec
    packed poison but no consumer ever read it)."""
    if flit.opcode is CXLCommand.S2MDRS:
        return Packet(cmd=MemCmd.ReadResp, addr=req.addr, size=req.size,
                      data=flit.data, req_id=req.req_id, is_cxl=True,
                      poison=flit.poison)
    if flit.opcode is CXLCommand.S2MNDR:
        return Packet(cmd=MemCmd.WriteResp, addr=req.addr, size=req.size,
                      req_id=req.req_id, is_cxl=True, poison=flit.poison)
    raise ValueError(f"not a response flit: {flit.opcode}")
