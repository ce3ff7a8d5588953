"""Pooled memory: many hosts sharing many devices through the fabric.

The pooling story CXL 2.0+ sells: a rack of memory devices behind a switch,
carved up or interleaved across hosts.  :class:`PoolAddressMapper` turns a
host-physical address into ``(device_index, device_local_address)``;
:class:`MemoryPool` binds the mapper + fabric + devices and hands out
per-host :class:`HostPortView`\\ s — each a plain ``MemDevice``, so existing
drivers (``TraceDriver``, ``MultiHostDriver``) run against pooled memory
unchanged while per-host stats accumulate on the view.

Mapping modes:

``interleave``  frames of ``granularity`` bytes round-robin across devices
                (spreads one host's bandwidth over all devices)
``segment``     contiguous ``segment_bytes`` slabs, one device per slab
                (capacity pooling: each slab is a private region)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.devices import MemDevice
from repro_torch.core.fabric.fabric import Fabric, LINE_BYTES

DEFAULT_GRANULARITY = 4096   # one flash/DRAM-cache page


@dataclass(frozen=True)
class PoolAddressMapper:
    num_devices: int
    mode: str = "interleave"              # 'interleave' | 'segment'
    granularity: int = DEFAULT_GRANULARITY
    segment_bytes: int = 1 << 30          # per-device slab in 'segment' mode

    def __post_init__(self) -> None:
        if self.num_devices < 1:
            raise ValueError("pool needs at least one device")
        if self.mode not in ("interleave", "segment"):
            raise ValueError(f"unknown pool mode {self.mode!r}")
        if self.granularity < 1 or self.segment_bytes < 1:
            raise ValueError("granularity/segment_bytes must be positive")

    def map(self, addr: int) -> Tuple[int, int]:
        """Global pool address -> ``(device_index, device_local_addr)``."""
        if self.mode == "interleave":
            frame, off = divmod(addr, self.granularity)
            dev, local_frame = frame % self.num_devices, frame // self.num_devices
            return dev, local_frame * self.granularity + off
        dev, local = divmod(addr, self.segment_bytes)
        if dev >= self.num_devices:
            raise ValueError(
                f"address {addr:#x} beyond pool capacity "
                f"({self.num_devices} x {self.segment_bytes:#x})")
        return dev, local


class MemoryPool:
    """Devices mounted at fabric nodes + an address mapper across them."""

    def __init__(self, fabric: Fabric, devices: Dict[str, MemDevice],
                 mapper: Optional[PoolAddressMapper] = None,
                 detach_links: bool = True) -> None:
        if not devices:
            raise ValueError("pool needs at least one device")
        for node in devices:
            if node not in fabric.topology.kinds:
                raise ValueError(f"unknown fabric node {node!r}")
        self.mapper = mapper or PoolAddressMapper(num_devices=len(devices))
        if self.mapper.num_devices != len(devices):
            raise ValueError("mapper.num_devices != number of pool devices")
        self.fabric = fabric
        self.device_nodes: List[str] = sorted(devices)
        # Detach only after all validation: a failed construction must not
        # leave the caller's devices silently mutated (NullLink'd).
        self.devices: List[MemDevice] = [
            devices[n].detach_link() if detach_links else devices[n]
            for n in self.device_nodes]

    def view(self, host: str) -> "HostPortView":
        """This host's window onto the pool (a normal ``MemDevice``)."""
        return HostPortView(self, host)

    def views(self, hosts: Sequence[str]) -> List["HostPortView"]:
        return [self.view(h) for h in hosts]


class HostPortView(MemDevice):
    """One host's port into a :class:`MemoryPool`.

    ``service`` routes each access through the fabric from this host to the
    device the mapper selects; contention with other hosts emerges from the
    shared port and device busy-until state.  Stats on this object are
    per-host; stats on the pooled devices are aggregate.
    """

    def __init__(self, pool: MemoryPool, host: str) -> None:
        # Inherit an engine so the event-driven path (access/access_flit)
        # works; pooled devices share one engine in full-system mode.
        super().__init__(pool.devices[0].engine)
        if host not in pool.fabric.topology.kinds:
            raise ValueError(f"unknown host node {host!r}")
        self.pool = pool
        self.host = host
        self.name = f"pool-view:{host}"
        for node in pool.device_nodes:          # fail fast if unroutable
            pool.fabric.routing.path(host, node)

    def service(self, now: int, addr: int, size: int, write: bool,
                posted: bool = False) -> int:
        self._count(size, write)
        dev_idx, local = self.pool.mapper.map(addr)
        node = self.pool.device_nodes[dev_idx]
        # ECMP flow key: the device-local line address — the same value the
        # fused replay hashes host-side after applying the pool mapper.
        t, floor = self.pool.fabric.traverse_qos(now, self.host, node, size,
                                                 line_addr=local // LINE_BYTES)
        done = self.pool.devices[dev_idx].service(t, local, size, write,
                                                  posted)
        return max(done, floor)
