"""membench-style load-latency measurement (Fig. 4).

Random dependent 64 B loads (pointer chasing): each load's address depends on
the previous load's value, so exactly one access is in flight — the measured
quantity is pure access latency, not bandwidth.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.devices import MemDevice
from repro_torch.core.workloads.driver import TraceDriver, TraceResult

LINE = 64


def run_membench(device: MemDevice, working_set_bytes: int = 8 << 20,
                 accesses: int = 20_000, seed: int = 7, iterations: int = 2,
                 base_addr: int = 0) -> TraceResult:
    """Pointer-chase latency.  ``iterations=2`` reports the warm pass (hot
    data), matching the paper's random-read latency comparison where the
    cached CXL-SSD serves hits from its DRAM layer."""
    rng = np.random.default_rng(seed)
    nlines = working_set_bytes // LINE
    # A random permutation cycle == pointer-chase order.
    order = rng.permutation(nlines)
    addrs = base_addr + order[:accesses] * LINE

    # Untimed init: membench writes the pointer array before chasing it, so
    # the working set exists on the backing medium.
    init = TraceDriver(device, outstanding=32)
    res = init.run((base_addr + i * LINE, LINE, True) for i in range(nlines))
    t = res.end_tick

    driver = TraceDriver(device, outstanding=1)  # dependent chain
    for _ in range(max(1, iterations)):
        res = driver.run(((int(a), LINE, False) for a in addrs), start_tick=t)
        t = res.end_tick
    return res
