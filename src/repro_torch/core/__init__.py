"""repro_torch.core — the simulator core (paper pillar 1): tick engine,
CXL.mem protocol layer, SimpleSSD-style SSD backend, DRAM cache layer with
five replacement policies, and the five device models."""

from repro_torch.core.engine import EventEngine, ns, us, to_ns, to_us, to_s
from repro_torch.core.devices import (
    DEVICE_NAMES,
    CachedCXLSSDDevice,
    CXLDRAMDevice,
    CXLSSDDevice,
    DRAMDevice,
    PMEMDevice,
    make_device,
)

__all__ = [
    "EventEngine", "ns", "us", "to_ns", "to_us", "to_s",
    "DEVICE_NAMES", "make_device",
    "DRAMDevice", "CXLDRAMDevice", "PMEMDevice", "CXLSSDDevice",
    "CachedCXLSSDDevice",
]
