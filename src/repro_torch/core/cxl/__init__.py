from repro_torch.core.cxl.flit import (
    CXL_FLIT_BYTES,
    CXLCommand,
    CXLFlit,
    MemCmd,
    MetaField,
    MetaValue,
    Packet,
    SnpType,
    decode_flit,
    encode_flit,
    packet_to_flit,
    flit_to_response_packet,
)
from repro_torch.core.cxl.home_agent import AddressRange, HomeAgent

__all__ = [
    "CXL_FLIT_BYTES",
    "CXLCommand",
    "CXLFlit",
    "MemCmd",
    "MetaField",
    "MetaValue",
    "Packet",
    "SnpType",
    "decode_flit",
    "encode_flit",
    "packet_to_flit",
    "flit_to_response_packet",
    "AddressRange",
    "HomeAgent",
]
