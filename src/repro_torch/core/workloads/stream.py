"""STREAM (McCalpin) bandwidth kernels over the simulated devices (Fig. 3).

Copy:  a[i] = b[i]            2 arrays touched / iteration
Scale: a[i] = q*b[i]          2
Add:   a[i] = b[i] + c[i]     3
Triad: a[i] = b[i] + q*c[i]   3

The paper uses an 8 MB dataset; accesses are sequential 64 B lines with the
full LFB depth outstanding, so the result is the device's sustainable
bandwidth.
"""

from __future__ import annotations

from typing import Dict, Iterator

from repro_torch.core.devices import MemDevice
from repro_torch.core.workloads.driver import Access, TraceDriver, TraceResult

LINE = 64


def _kernel_trace(base: int, array_bytes: int, reads: int, writes: int) -> Iterator[Access]:
    """Interleave per-iteration reads then writes, line by line."""
    nlines = array_bytes // LINE
    # array layout: [w0][r0][r1] each array_bytes long
    for i in range(nlines):
        off = i * LINE
        for r in range(reads):
            yield (base + (1 + r) * array_bytes + off, LINE, False)
        for w in range(writes):
            yield (base + w * array_bytes + off, LINE, True)


def run_stream(device: MemDevice, dataset_bytes: int = 8 << 20,
               outstanding: int = 32, iterations: int = 2,
               base_addr: int = 0) -> Dict[str, TraceResult]:
    """Run the four STREAM kernels; returns per-kernel TraceResult.

    Like the real STREAM, each kernel runs ``iterations`` times and the last
    pass is reported — the first pass warms any cache layer (the paper's
    cached CXL-SSD point is precisely its warm steady state).
    """
    kernels = {
        "copy": (1, 1),
        "scale": (1, 1),
        "add": (2, 1),
        "triad": (2, 1),
    }
    results: Dict[str, TraceResult] = {}
    t = 0
    for name, (reads, writes) in kernels.items():
        arrays = reads + writes
        array_bytes = (dataset_bytes // arrays) // LINE * LINE
        driver = TraceDriver(device, outstanding=outstanding)
        for _ in range(max(1, iterations)):
            res = driver.run(_kernel_trace(base_addr, array_bytes, reads, writes),
                             start_tick=t)
            t = res.end_tick
        results[name] = res
    return results
