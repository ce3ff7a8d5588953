"""HIL — Host Interface Layer (SimpleSSD's ``HIL::Read/Write``).

The CXL-SSD device calls ``HIL.read/write`` with byte addresses; the HIL
splits requests into 4 KB logical pages, drives the FTL, and returns the
completion *tick* — exactly the contract the paper describes ("the gem5
simulator determines the latency of access requests based on the Tick value
returned by SimpleSSD").

``InitSimpleSSDEngine`` mirrors the paper's gem5-side initialization hook.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ssd.ftl import FTL
from repro_torch.core.ssd.pal import NANDTiming, PAL


@dataclass
class SSDConfig:
    capacity_bytes: int = 16 << 30          # Table I: 16 GB
    page_bytes: int = 4096
    channels: int = 8
    dies_per_channel: int = 4
    pages_per_block: int = 256
    timing: NANDTiming = field(default_factory=NANDTiming)
    # host-interface DMA/firmware overhead per request (NVMe-class firmware
    # path, amortized; SimpleSSD charges a comparable fixed HIL cost)
    hil_overhead_ns: float = 2000.0


class HIL:
    def __init__(self, cfg: SSDConfig | None = None) -> None:
        self.cfg = cfg or SSDConfig()
        self.pal = PAL(self.cfg.channels, self.cfg.dies_per_channel,
                       self.cfg.page_bytes, self.cfg.timing)
        total_pages = self.cfg.capacity_bytes // self.cfg.page_bytes
        self.ftl = FTL(self.pal, total_pages, self.cfg.pages_per_block)
        self.stats = {"read_reqs": 0, "write_reqs": 0,
                      "read_pages": 0, "write_pages": 0}

    # ------------------------------------------------------------------ api
    def _pages(self, addr: int, size: int) -> range:
        first = addr // self.cfg.page_bytes
        last = (addr + max(size, 1) - 1) // self.cfg.page_bytes
        return range(first, last + 1)

    def _overhead(self) -> int:
        from repro_torch.core.engine import ns
        return ns(self.cfg.hil_overhead_ns)

    def read(self, now: int, addr: int, size: int) -> int:
        """SimpleSSD ``HIL::Read``: returns completion tick."""
        self.stats["read_reqs"] += 1
        t0 = now + self._overhead()
        done = t0
        for lpn in self._pages(addr, size):
            self.stats["read_pages"] += 1
            done = max(done, self.ftl.read(t0, lpn))
        return done

    def is_written(self, addr: int, size: int = 1) -> bool:
        """True if any page in [addr, addr+size) has ever been programmed —
        lets a cache skip the flash read when filling a virgin page."""
        return any(lpn in self.ftl.l2p for lpn in self._pages(addr, size))

    def write(self, now: int, addr: int, size: int) -> int:
        """SimpleSSD ``HIL::Write``: returns completion tick."""
        self.stats["write_reqs"] += 1
        t0 = now + self._overhead()
        done = t0
        for lpn in self._pages(addr, size):
            self.stats["write_pages"] += 1
            done = max(done, self.ftl.write(t0, lpn))
        return done


def InitSimpleSSDEngine(cfg: SSDConfig | None = None) -> HIL:
    """Paper §II-A: gem5 calls this at init to set up the SimpleSSD engine."""
    return HIL(cfg)
