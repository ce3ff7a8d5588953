"""The five memory devices evaluated in the paper (§III).

``dram``          local DDR4-2400
``cxl-dram``      DRAM behind the CXL.mem link
``pmem``          persistent memory (SpecPMT timing: 150 ns R / 500 ns W)
``cxl-ssd``       SSD memory expander, no DRAM cache (SimpleSSD backend)
``cxl-ssd-cache`` SSD expander + the paper's DRAM cache layer

Every device implements two access paths:

* ``service(now, addr, size, write) -> completion_tick`` — the analytic
  busy-until fast path used by trace drivers (millions of accesses);
* ``access(pkt, cb)`` / ``access_flit(flit, cb)`` — the event-driven path
  used through the :class:`~repro_torch.core.cxl.home_agent.HomeAgent` in
  full-system mode (integration tests exercise both and assert they agree).

Bandwidth emerges from per-access media occupancy (Little's law: enough
outstanding 64 B requests saturate ``64 B / occupancy``); latency from the
device constants of Table I.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.cache.dram_cache import DRAMCache, DRAMCacheConfig, PAGE_BYTES
from repro_torch.core.cxl.flit import CXLCommand, CXLFlit, MemCmd, Packet
from repro_torch.core.engine import EventEngine, ns
from repro_torch.core.ssd.hil import HIL, SSDConfig

LINE = 64
POSTED_ACK_NS = 10.0   # store accepted into the write queue


# --------------------------------------------------------------------- base
class MemDevice:
    name = "abstract"
    is_cxl = False

    def __init__(self, engine: Optional[EventEngine] = None) -> None:
        self.engine = engine
        self.stats = {"reads": 0, "writes": 0, "bytes": 0}
        # deterministic fault injection (repro_torch.core.faults.install): the
        # device marks read-response flits poisoned per the plan, keyed on
        # its own flit ordinal — corrupt data surfaces as status, never as
        # fabricated latency
        self.fault_plan = None
        self._flit_ord = 0

    def _poison_next(self, write: bool) -> bool:
        plan = self.fault_plan
        if plan is None or not plan.has_poison:
            return False
        ordinal = self._flit_ord
        self._flit_ord += 1
        return plan.poisoned(0, ordinal, write)

    # analytic fast path ---------------------------------------------------
    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        """``posted=True`` models regular stores retiring into the write queue
        (slot freed at accept time); ``posted=False`` models loads and
        persistent stores (clwb/fence) that wait for the media — the Viper
        case that exposes PMEM's 500 ns writes (paper Fig. 5/6)."""
        raise NotImplementedError

    def _count(self, size: int, write: bool) -> None:
        self.stats["writes" if write else "reads"] += 1
        self.stats["bytes"] += size

    # fabric mount hook ----------------------------------------------------
    def detach_link(self) -> "MemDevice":
        """Replace this device's private point-to-point CXL link (if any)
        with a :class:`NullLink`, so a switch fabric can own transport
        instead.  No-op for devices without a ``link`` (dram, pmem).
        Returns ``self`` for chaining."""
        if hasattr(self, "link"):
            self.link = NullLink()
        return self

    # event-driven path ------------------------------------------------------
    def access(self, pkt: Packet, cb: Callable[[Packet], None]) -> None:
        done = self.service(self.engine.now, pkt.addr, pkt.size, pkt.is_write())
        resp = Packet(cmd=MemCmd.WriteResp if pkt.is_write() else MemCmd.ReadResp,
                      addr=pkt.addr, size=pkt.size, req_id=pkt.req_id)
        self.engine.schedule_at(done, lambda: cb(resp))

    def access_flit(self, flit: CXLFlit, cb: Callable[[CXLFlit], None]) -> None:
        write = flit.opcode is CXLCommand.M2SRwD
        size = flit.length_blocks * LINE
        done = self.service(self.engine.now, flit.addr, size, write)
        resp = CXLFlit(
            opcode=CXLCommand.S2MNDR if write else CXLCommand.S2MDRS,
            addr=flit.addr, tag=flit.tag, length_blocks=flit.length_blocks,
            data=b"" if write else b"\x00" * min(size, LINE),
            poison=self._poison_next(write),
        )
        self.engine.schedule_at(done, lambda: cb(resp))


# --------------------------------------------------------------------- DRAM
@dataclass
class DRAMTiming:
    load_ns: float = 80.0           # idle random-load latency, DDR4-2400
    bw_gbps: float = 19.2           # one channel (Table I: 1 memory channel)


class DRAMDevice(MemDevice):
    name = "dram"

    def __init__(self, engine: Optional[EventEngine] = None,
                 timing: DRAMTiming | None = None) -> None:
        super().__init__(engine)
        self.t = timing or DRAMTiming()
        self._busy = 0

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        occ = ns(size / self.t.bw_gbps)  # bytes / (GB/s) == ns
        start = max(now, self._busy)
        self._busy = start + occ
        if write and posted:
            return start + occ + ns(POSTED_ACK_NS)
        return start + occ + ns(self.t.load_ns)


# ----------------------------------------------------------------- CXL link
class CXLLink:
    """PCIe 4.0 x8-class CXL link: 16 GB/s per direction."""

    def __init__(self, bw_gbps: float = 16.0, rt_extra_ns: float = 50.0) -> None:
        self.bw_gbps = bw_gbps
        self.rt_extra_ns = rt_extra_ns  # Table I: total CXL.mem network latency
        self._busy = 0

    def traverse(self, now: int, nbytes: int) -> int:
        occ = ns(nbytes / self.bw_gbps)
        start = max(now, self._busy)
        self._busy = start + occ
        return start + occ + ns(self.rt_extra_ns)


class NullLink(CXLLink):
    """Zero-cost link: transport is modeled elsewhere (the fabric layer).

    Used by :class:`repro_torch.core.fabric.FabricAttachedDevice` to neutralize a
    CXL device's private point-to-point link so the switch fabric owns the
    full transport path and link latency is not double-counted.
    """

    def __init__(self) -> None:
        super().__init__(bw_gbps=float("inf"), rt_extra_ns=0.0)

    def traverse(self, now: int, nbytes: int) -> int:
        return now


class CXLDRAMDevice(MemDevice):
    name = "cxl-dram"
    is_cxl = True

    def __init__(self, engine: Optional[EventEngine] = None,
                 timing: DRAMTiming | None = None,
                 link: CXLLink | None = None) -> None:
        super().__init__(engine)
        self.dram = DRAMDevice(engine, timing)
        self.link = link or CXLLink()

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        t = self.link.traverse(now, size)
        return self.dram.service(t, addr, size, write, posted)


# --------------------------------------------------------------------- PMEM
@dataclass
class PMEMTiming:
    read_ns: float = 150.0          # SpecPMT
    write_ns: float = 500.0
    row_bytes: int = 256            # Table I: PMEM rowbuffer 256 B
    row_hit_factor: float = 0.6     # open-row access cuts media latency
    bw_gbps: float = 12.5           # ~0.65 x DDR4 channel (paper Fig. 3)


class PMEMDevice(MemDevice):
    name = "pmem"

    def __init__(self, engine: Optional[EventEngine] = None,
                 timing: PMEMTiming | None = None) -> None:
        super().__init__(engine)
        self.t = timing or PMEMTiming()
        self._busy = 0
        self._open_row = -1
        self.stats["row_hits"] = 0

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        row = addr // self.t.row_bytes
        lat = self.t.write_ns if write else self.t.read_ns
        if row == self._open_row:
            lat *= self.t.row_hit_factor
            self.stats["row_hits"] += 1
        self._open_row = row
        occ = ns(size / self.t.bw_gbps)
        start = max(now, self._busy)
        self._busy = start + occ
        if write and posted:
            return start + occ + ns(POSTED_ACK_NS)
        return start + occ + ns(lat)


# ------------------------------------------------------------------ CXL-SSD
def _memory_semantic_ssd() -> SSDConfig:
    """Default CXL-SSD build: low-latency NAND (see NANDTiming.low_latency)."""
    from repro_torch.core.ssd.pal import NANDTiming
    return SSDConfig(timing=NANDTiming.low_latency(), hil_overhead_ns=1000.0)


class CXLSSDDevice(MemDevice):
    """Uncached SSD memory expander — the paper's motivating pain point.

    Without a DRAM cache layer, the controller only has NAND page registers
    (a handful of open 4 KB pages).  Every 64 B access that misses them
    amplifies to a 4 KB flash page operation (§II-A granularity mismatch);
    a 64 B *write* miss is a read-modify-write — the page must be fetched
    before the line can merge.  Average access latency is therefore in the
    microseconds-to-tens-of-microseconds band.
    """

    name = "cxl-ssd"
    is_cxl = True

    def __init__(self, engine: Optional[EventEngine] = None,
                 ssd_cfg: SSDConfig | None = None,
                 link: CXLLink | None = None,
                 page_registers: int = 4,
                 internal_latency_ns: float = 250.0) -> None:
        super().__init__(engine)
        self.hil = HIL(ssd_cfg or _memory_semantic_ssd())
        self.link = link or CXLLink()
        self.internal_latency_ns = internal_latency_ns
        from repro_torch.core.cache.policies import LRUPolicy
        self._buf = LRUPolicy(max(1, page_registers))  # open-page registers
        self.stats.update({"buf_hits": 0, "flash_reads": 0, "flash_writes": 0,
                           "rmw_fills": 0})

    def _flush_if_evicted(self, now: int, page: Optional[int]) -> None:
        if page is not None:
            self.hil.write(now, page * PAGE_BYTES, PAGE_BYTES)
            self.stats["flash_writes"] += 1

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        t = self.link.traverse(now, size)
        page = addr // PAGE_BYTES
        if self._buf.lookup(page):
            self.stats["buf_hits"] += 1
            self._buf.touch(page, dirty=write)
            return t + ns(self.internal_latency_ns)
        # Miss: fetch the page into a register (read amplification).  Writes
        # are read-modify-write unless the page was never programmed.
        done = t
        if self.hil.is_written(page * PAGE_BYTES):
            self.stats["rmw_fills" if write else "flash_reads"] += 1
            done = self.hil.read(t, page * PAGE_BYTES, PAGE_BYTES)
        ev = self._buf.insert(page, dirty=write)
        if ev is not None and ev.dirty:
            self._flush_if_evicted(done, ev.page)
        return done + ns(self.internal_latency_ns)


class CachedCXLSSDDevice(MemDevice):
    """The paper's contribution: CXL-SSD fronted by the DRAM cache layer.

    ``hil=`` mounts an *existing* flash backend instead of building a fresh
    one: several cached front-ends sharing one ``HIL`` model the pooled
    CXL-SSD shape — per-host private DRAM caches over shared FTL/PAL flash
    — where cross-host contention emerges from the shared die/channel
    busy-until state (and the shared free-block pool under GC)."""

    name = "cxl-ssd-cache"
    is_cxl = True

    def __init__(self, engine: Optional[EventEngine] = None,
                 ssd_cfg: SSDConfig | None = None,
                 cache_cfg: DRAMCacheConfig | None = None,
                 link: CXLLink | None = None,
                 hil: HIL | None = None) -> None:
        super().__init__(engine)
        if hil is not None and ssd_cfg is not None:
            raise ValueError("pass ssd_cfg or a shared hil, not both")
        self.hil = hil if hil is not None else HIL(ssd_cfg or
                                                  _memory_semantic_ssd())
        self.cache = DRAMCache(cache_cfg or DRAMCacheConfig(), self.hil)
        self.link = link or CXLLink()

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        t = self.link.traverse(now, size)
        done = t
        for line_addr in range(addr - addr % LINE, addr + size, LINE):
            done = max(done, self.cache.access(t, line_addr, write, posted=posted))
        return done

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate


DEVICE_NAMES = ["dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache"]


def make_device(name: str, engine: Optional[EventEngine] = None,
                **kwargs) -> MemDevice:
    table = {
        "dram": DRAMDevice,
        "cxl-dram": CXLDRAMDevice,
        "pmem": PMEMDevice,
        "cxl-ssd": CXLSSDDevice,
        "cxl-ssd-cache": CachedCXLSSDDevice,
    }
    try:
        cls = table[name]
    except KeyError:
        raise ValueError(f"unknown device {name!r}; choose from {DEVICE_NAMES}") from None
    # Constructor errors (e.g. bad kwargs) propagate with their real message —
    # only the name lookup is guarded.
    return cls(engine, **kwargs)
