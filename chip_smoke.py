#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check what comes out.

    python3 chip_smoke.py [--seed 0] [--accesses 1048576]

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and ``nvcc``.  Phases, each printing one line:

1. probe: torch, CUDA, the card, its power limit, nvcc;
2. build: the CUDA kernels, from the sources in the checkout;
3. kernels: ``cache_sim`` and ``cache_sim_fused`` on the card, bit-equal to
   their plain PyTorch versions on the same inputs, at four shapes;
4. main path: ``TraceDriver(make_device("cxl-ssd-cache"), engine="cuda")``
   at the paper's Table I width (16 MB LRU cache = 1 set x 4096 ways, 16 GB
   low-latency SSD, 32 outstanding) over a seeded trace of 2^20 accesses,
   plus ``simulate_trace`` on the same trace; checked against
   ``run_cuda(validate=True)`` and, access by access, the host-side LRU
   policy object (decisions) and a plain-Python latency recurrence over
   that object's decisions (latencies and arrivals);
5. golden: the pinned ``cxl-ssd-cache@direct`` kernel-lane latencies of
   ``tests/golden/golden_traces.json``, reproduced on the card.

Then one JSON line per kernel (launches on the main path, error against the
plain version, times, bounds) and, last, the result line.  Any failed check
ends the run with a non-zero exit; without a CUDA device it exits at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_LANES_PER_SM = 64        # Hopper SM: 4 partitions x 16 INT32 units
# integer operations of the set scan per way: the tag compare and the
# first-match select (2), the validity compare and the key select (2),
# packing (key, way) into one 64-bit word (2 halves), and the 64-bit min
# (a compare and a select for each half, 4)
OPS_PER_WAY = 10
GOLDEN = "cxl-ssd-cache@direct"
GOLDEN_CACHE = dict(capacity_bytes=16 * 4096, mshr_entries=4,
                    writeback_buffer=2)
CHECK_SHAPES = [(1, 4096, "lru"), (1, 4096, "fifo"), (4096, 1, "direct"),
                (4096, 8, "lru")]
CHECK_ACCESSES = 8192
SOURCE = "src/repro_torch/kernels/csrc/cache_sim.cu"
REPLACES = {"cache_sim": "src/repro/kernels/cache_sim.py:33",
            "cache_sim_fused": "src/repro/kernels/cache_sim.py:139"}


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(accesses: int, ways: int, io_bytes_per_access: int,
             state_bytes: int, int32_ops_per_s: float) -> tuple[float, str]:
    """Roofline bound: each input read once and each output written once
    over the HBM rate, against the set scan's ``OPS_PER_WAY`` integer
    operations per way of the accessed set over the card's INT32 rate."""
    t_bytes = (accesses * io_bytes_per_access + state_bytes) / HBM_BYTES_PER_S
    t_ops = accesses * ways * OPS_PER_WAY / int32_ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def latency_chain(hits, evicts, *, outstanding, issue_ns, hit_ns, miss_ns,
                  miss_occ_ns, wb_ns, **_):
    """The closed-loop latency model in plain Python integers, one access
    at a time: arrival through the ring of the last ``outstanding``
    completions, then busy-until queueing on the fill path for misses.
    Returns ``(latency_ns, arrival_ns)`` as int64 arrays."""
    ring = [0] * outstanding
    busy = prev = 0
    lat, arr = [], []
    for i, (hit, ev) in enumerate(zip(hits.tolist(), evicts.tolist())):
        slot = i % outstanding
        t = max(prev + issue_ns, ring[slot])
        if hit:
            done = t + hit_ns
        else:
            start = max(t, busy)
            done = start + miss_ns + (wb_ns if ev else 0)
            busy = start + miss_occ_ns
        ring[slot] = done
        prev = t
        lat.append(done - t)
        arr.append(t)
    return np.asarray(lat, np.int64), np.asarray(arr, np.int64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accesses", type=int, default=1 << 20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.core.cache.dram_cache import DRAMCacheConfig
    from repro_torch.core.cache.policies import make_policy
    from repro_torch.core.cache.trace_sim import simulate_trace
    from repro_torch.core.devices import make_device
    from repro_torch.core.engine import TICKS_PER_NS
    from repro_torch.core.replay.cuda_engine import cuda_params, run_cuda
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.core.workloads.traces import hash_seed, make_trace
    from repro_torch.kernels import _build
    from repro_torch.kernels import cache_sim as ks

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])

    # 1. probe ---------------------------------------------------------
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    say("probe", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(kind), count=torch.cuda.device_count(),
        nvcc=repr(nvcc), sm_clock_max_mhz=sm_clock_mhz)
    print(card, flush=True)

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = [_build.build(name) for name in _build.SOURCES]
    for name in _build.SOURCES:
        _build.library(name)
    ptxas = [ln.strip() for log in _build.build_log.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        libraries=",".join(p.name for p in libs))
    for ln in ptxas:
        say("build", ptxas=repr(ln))

    # 3. kernels against their plain versions, on the card --------------
    table1 = make_device("cxl-ssd-cache")
    timing = {k: v for k, v in cuda_params(table1, 0.5).items()
              if k.endswith("_ns")}
    rng = np.random.default_rng(args.seed)
    mismatches = {"cache_sim": 0, "cache_sim_fused": 0}
    max_err = {"cache_sim": 0, "cache_sim_fused": 0}
    plain_ms = {}
    plain_kernel_ms = {}
    for num_sets, ways, policy in CHECK_SHAPES:
        frames = num_sets * ways
        pages = torch.from_numpy(
            rng.integers(0, 4 * frames, CHECK_ACCESSES).astype(np.int32)).to(dev)
        writes = torch.from_numpy(rng.random(CHECK_ACCESSES) < 0.3).to(dev)
        geo = dict(num_sets=num_sets, ways=ways, policy=policy)
        fused_kw = dict(geo, outstanding=32, **timing)

        got = ks.cache_sim(pages, writes, return_state=True, **geo)
        want = ks.cache_sim_plain(pages, writes, **geo)
        got_f = ks.cache_sim_fused(pages, writes, **fused_kw)
        want_f = ks.cache_sim_fused_plain(pages, writes, **fused_kw)
        torch.cuda.synchronize()
        pairs = {"cache_sim": [(got[0], want[0]), (got[1], want[1])]
                 + list(zip(got[2], want[2])),
                 "cache_sim_fused": list(zip(got_f, want_f))}
        calls = {"cache_sim": lambda: ks.cache_sim(pages, writes,
                                                   return_state=True, **geo),
                 "cache_sim_fused": lambda: ks.cache_sim_fused(pages, writes,
                                                               **fused_kw)}
        for name, ps in pairs.items():
            bad = sum(int((a != b).sum()) for a, b in ps)
            err = max(int((a.long() - b.long()).abs().max()) for a, b in ps)
            mismatches[name] += bad
            max_err[name] = max(max_err[name], err)
            ms = cuda_ms(torch, calls[name], reps=3)
            say("kernels", kernel=name, shape=f"{num_sets}x{ways}",
                policy=policy, accesses=CHECK_ACCESSES, mismatches=bad,
                max_abs_err=err, kernel_ms=f"{ms:.3f}",
                ns_per_access=f"{ms * 1e6 / CHECK_ACCESSES:.1f}")
            if (num_sets, ways, policy) == CHECK_SHAPES[0]:
                plain_kernel_ms[name] = ms
        if (num_sets, ways, policy) == CHECK_SHAPES[0]:
            # main-path state shape: the plain versions on the same inputs
            plain_ms["cache_sim"] = cuda_ms(
                torch, lambda: ks.cache_sim_plain(pages, writes, **geo))
            plain_ms["cache_sim_fused"] = cuda_ms(
                torch, lambda: ks.cache_sim_fused_plain(pages, writes,
                                                        **fused_kw))
    check(mismatches == {"cache_sim": 0, "cache_sim_fused": 0},
          f"kernels disagree with their plain versions: {mismatches}")

    # 4. main path at Table I width --------------------------------------
    trace = make_trace(args.seed, n=args.accesses, pages=16384)
    addrs = np.fromiter((a for a, _, _ in trace), np.int64, len(trace))
    wr = np.fromiter((w for _, _, w in trace), bool, len(trace))
    page_ids = addrs // 4096
    device = make_device("cxl-ssd-cache")
    kw = cuda_params(device, 0.5)
    check((kw["num_sets"], kw["ways"], kw["policy"]) == (1, 4096, "lru"),
          f"Table I geometry {kw}")

    ks.reset_launches()
    t0 = time.perf_counter()
    res = TraceDriver(device, engine="cuda").run(trace)
    t1 = time.perf_counter()
    stats = simulate_trace(page_ids, wr, num_sets=1, ways=4096)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(ks.LAUNCHES)
    check(all(v >= 1 for v in launches.values()),
          f"main path missed a kernel: launches {launches}")

    n = args.accesses
    lat = res.latency_ticks
    check(res.accesses == n and lat.shape == (n,) and lat.dtype == np.int64
          and res.hit_flags.shape == (n,) and res.evict_flags.shape == (n,),
          "main-path result shapes")
    check(bool((lat > 0).all()) and np.isfinite(res.avg_latency_ns),
          "main-path latencies must be positive and finite")
    again = run_cuda(make_device("cxl-ssd-cache"), addrs, wr, validate=True)
    for field in ("latency_ticks", "hit_flags", "evict_flags"):
        check(np.array_equal(getattr(res, field), getattr(again, field)),
              f"TraceDriver and run_cuda(validate=True) differ in {field}")
    for field in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        check(getattr(res, field) == getattr(again, field),
              f"TraceDriver and run_cuda(validate=True) differ in {field}")
    check(np.array_equal(stats["hit_flags"], res.hit_flags)
          and np.array_equal(stats["dirty_evict_flags"], res.evict_flags),
          "simulate_trace and the driver disagree on decisions")

    policy = make_policy("lru", 4096)
    host_hits = np.empty(n, bool)
    host_evicts = np.empty(n, bool)
    for i, (p, w) in enumerate(zip(page_ids.tolist(), wr.tolist())):
        hit, ev = policy.access(p, w)
        host_hits[i] = hit
        host_evicts[i] = ev is not None and ev.dirty
    check(np.array_equal(host_hits, res.hit_flags),
          "hit flags differ from the host LRU policy")
    check(np.array_equal(host_evicts, res.evict_flags),
          "dirty-evict flags differ from the host LRU policy")

    # latencies and arrivals over the whole trace, against a plain-Python
    # recurrence fed by the host policy's decisions (not the kernel's)
    pages_t = torch.from_numpy(page_ids.astype(np.int32)).to(dev)
    writes_t = torch.from_numpy(wr).to(dev)
    fused_kw = dict(kw, outstanding=32)
    geo = dict(num_sets=1, ways=4096, policy="lru")
    host_lat, host_arr = latency_chain(host_hits, host_evicts, **fused_kw)
    check(int(host_arr.max()) + int(host_lat.max()) < 2**31,
          "host latency chain left the int32 nanosecond range")
    _, _, k_lat, k_arr = ks.cache_sim_fused(pages_t, writes_t, **fused_kw)
    check(np.array_equal(k_lat.cpu().numpy(), host_lat)
          and np.array_equal(k_arr.cpu().numpy(), host_arr),
          "kernel latencies or arrivals differ from the host recurrence")
    check(np.array_equal(res.latency_ticks, host_lat * TICKS_PER_NS),
          "driver latencies differ from the host recurrence")
    kernel_ms = {
        "cache_sim_fused": cuda_ms(
            torch, lambda: ks.cache_sim_fused(pages_t, writes_t, **fused_kw),
            reps=3),
        "cache_sim": cuda_ms(
            torch, lambda: ks.cache_sim(pages_t, writes_t,
                                        return_state=True, **geo), reps=3),
    }
    say("main", accesses=n, hit_rate=f"{res.hits / n:.6f}",
        dirty_evicts=int(res.evict_flags.sum()),
        avg_latency_ns=f"{res.avg_latency_ns:.3f}",
        elapsed_ticks=res.elapsed_ticks, end_tick=res.end_tick,
        fused_kernel_ms=f"{kernel_ms['cache_sim_fused']:.3f}",
        ns_per_access=f"{kernel_ms['cache_sim_fused'] * 1e6 / n:.1f}",
        decisions_kernel_ms=f"{kernel_ms['cache_sim']:.3f}",
        driver_wall_s=f"{t1 - t0:.3f}", simulate_trace_wall_s=f"{t2 - t1:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        host_policy_check="pass", host_latency_check="pass",
        validate="pass")

    # 5. golden pin on the card -------------------------------------------
    pin = json.loads((ROOT / "tests/golden/golden_traces.json").read_text())
    pin = pin["scenarios"][GOLDEN]["pallas"]
    gdev = make_device("cxl-ssd-cache",
                       cache_cfg=DRAMCacheConfig(policy="lru", **GOLDEN_CACHE))
    gres = TraceDriver(gdev, outstanding=8, engine="cuda").run(
        make_trace(hash_seed(GOLDEN)))
    for field in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        check(getattr(gres, field) == pin[field], f"golden {field}")
    check(gres.latency_ticks.tolist() == pin["latency_ticks"],
          "golden per-access latencies")
    say("golden", scenario=GOLDEN, lane="cuda", accesses=gres.accesses,
        first_latency_ticks=int(gres.latency_ticks[0]),
        elapsed_ticks=gres.elapsed_ticks, equal="all fields")

    # 6. kernels line ------------------------------------------------------
    int32_ops_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                       * INT32_LANES_PER_SM * sm_clock_mhz * 1e6)
    rows = []
    for name, io in (("cache_sim", 7), ("cache_sim_fused", 15)):
        state = 12 * 4096 if name == "cache_sim" else 0
        b_ms, b_by = bound_ms(n, 4096, io, state, int32_ops_per_s)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "tolerance": 0,
            "ms": kernel_ms[name],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "accesses": n, "plain_accesses": CHECK_ACCESSES,
            "kernel_ms_at_plain_accesses": plain_kernel_ms[name],
            "shapes": [f"{s}x{w}:{p}" for s, w, p in CHECK_SHAPES],
            "mismatches": mismatches[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
