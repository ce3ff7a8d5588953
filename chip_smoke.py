#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check what comes out.

    python3 chip_smoke.py [--seed 0] [--accesses 1048576]

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and ``nvcc``.  Phases, each printing one or more lines:

1. probe: torch, CUDA, the card, its power limit, nvcc;
2. build: the CUDA kernels, one ``nvcc`` per source, all started together,
   from the sources in the checkout, with each kernel's registers and
   spills, and beside them the probe ``tools/smem_latency.cu``;
3. kernels: ``cache_sim`` and ``cache_sim_fused`` on the card, bit-equal to
   their plain PyTorch versions on the same inputs, at nine shapes and
   traces: Table I's 1 x 4096 (LRU, FIFO over two lanes, a trace whose
   pages all hit after their first touch, one where every access
   misses), direct-mapped 4096 x 1, 4096 x 8 (state in global scratch),
   3 x 40 (sets not a power of two) and 1 x 64 over pages that are all
   multiples of the kernel's hash-table size (one long probe cluster);
4. main path (replay): ``TraceDriver(make_device("cxl-ssd-cache"),
   engine="cuda")`` at the paper's Table I width (16 MB LRU cache = 1 set x
   4096 ways, 16 GB low-latency SSD, 32 outstanding) over a seeded trace of
   2^20 accesses, plus ``simulate_trace`` on the same trace; checked against
   ``run_cuda(validate=True)`` and, access by access, the host-side LRU
   policy object (decisions) and a plain-Python latency recurrence over
   that object's decisions (latencies and arrivals); the kernels' serial
   chain bound, a model: dependent shared-memory round trips x the card's
   shared-memory latency, measured here by ``tools/smem_latency.cu``;
5. golden: the pinned ``cxl-ssd-cache@direct`` kernel-lane latencies of
   ``tests/golden/golden_traces.json``, reproduced on the card;
6. fabric: the golden ``cxl-ssd-cache@fabric`` kernel-lane pin through
   a two-level fabric mount (``TraceDriver`` and ``run_cuda(validate=
   True)``); Table I's cached CXL-SSD mounted behind
   ``Fabric.build("two_level", num_hosts=2, num_devices=2,
   num_leaves=2)`` replaying the main path's trace with
   ``engine="cuda"``: ``cache_sim_fused`` launched, every output
   bit-equal to phase 4's direct run (the kernel lane reads the mounted
   device alone, as the JAX package's pallas lane does), ``TraceDriver``'s
   wall time; an installed link-retry ``FaultPlan`` refused with
   ``ReplayUnsupported``; the torch hash twins (``flow_choices_torch``,
   ``nand_read_retries_torch``, ``erase_fails_torch``) bit-equal to their
   numpy twins over 2^20 seeded uint64 values; ``LinkCongestionSim`` at
   4 hosts x 4 devices on a spine-leaf with ECMP over 2^22 accesses
   against its own CPU result (rtol 1e-5), and its wall time;
7. decode kernels: ``flash_decode`` against its plain version at hd 120 /
   128 / 64, G 1 / 4 / 5 / 8 / 16, fill levels on tile and split edges, a
   4096-slot cache and forced split plans with empty ranges; its split
   plans (CTAs, cluster size, rows a CTA) and device times at glm4-9b's and
   hymba-1.5b's attention shapes; ``page_gather`` and ``page_scatter``
   against theirs over float32, bfloat16 and int32 pages with a repeated
   slot (exact);
8. main path (serve): ``repro_torch.launch.serve.serve`` of h2o-danube-3-4b
   at full width (24 layers, d_model 3840, 32/8 heads of 120, seeded random
   weights from a torch.Generator on the card), batch 4, context 512,
   32 + 608 steps, LRU tiered KV store backed by a simulated CXL-SSD;
   launches of all three serving kernels, the store's counters and clock
   against values pinned from the JAX package's store, ``flash_decode``
   against its plain version on the run's final caches of all 24 layers,
   and the greedy tokens of a second run, which must be identical;
9. profile: where a serving step's time goes on the card (the port's
   kernels, matrix products, other kernels, copies, idle), by the profiler;
10. scheduler: ``BatchScheduler`` at full width, 4 slots, 8 seeded requests,
   all complete, twice with identical outputs;
11. prefill: ``flash_attention``'s ptxas report (the run fails on a
   spill); the kernel against its plain version over head dims 64 / 120 /
   128 / 36 / 100 (the last two not multiples of 8), group sizes 1 / 4 /
   5 / 8 / 16, six masks (causal, sliding window, cross lengths, a ragged
   S, S and Skv one past a tile edge, causal and cross) and q scaled x 1
   and x 4; then the main path
   ``make_prefill_step(cfg)(params, {"tokens": ...})`` of h2o-danube-3-4b
   at full width (the serve phase's weights), batch 2 x 8192 seeded
   tokens: 24 kernel launches, finite logits, the kernel against its plain
   version on layer 0's own q / k / v, the logits of the first 64
   positions against 64 decode steps (equal greedy argmax), the host wall
   time, the device time by kind, and the kernel's time beside its bound
   (split TF32 on the tensor cores, and the FP32 FMA bound of the same
   flops), its plain version and ``F.scaled_dot_product_attention``.

Then the card's name and power limit, one JSON line of every kernel
(launches on its main path, error against the plain version, device times,
bounds) and, last, the result line.  Any failed check ends the run with a
non-zero exit; without a CUDA device it exits at once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
TF32_SPLIT_TERMS = 3           # flash_attention's products in split TF32
INT32_LANES_PER_SM = 64        # Hopper SM: 4 partitions x 16 INT32 units
# integer operations of one access of the cache_sim kernel, a miss in a
# full LRU set (its costliest case; a probe and a deletion of one step):
# the look-ahead's input split, set, home slots, victim select and address
# (12), the stamp (1), the probe's compares (2), hit, full and dirty-evict
# tests (5), the touched frame and table slot selects (2), the deletion's
# compares, home slot and distances (10), the list move, the frame record
# and the set record (22), the outcome byte (3); the fused kernel adds the
# latency chain (9) and the ring slot (3)
OPS_PER_ACCESS = {"cache_sim": 57, "cache_sim_fused": 69}
# dependent shared-memory round trips of one access on the kernel's serial
# chain, a model: the thread issues in order, so every access waits on the
# set's record, then on the victim's frame (its tag gives the victim's home
# slot), both issued ahead by the previous access; a hit then reads its own
# frame (3); a miss while the set fills needs nothing more (2); a miss in a
# full set reads the victim's first probe slot, then the deletion's next
# slot (4).  Longer probes and shifts are not counted.
ROUND_TRIPS = {"hit": 3, "fill": 2, "evict": 4}
SMEM_PROBE = ROOT / "tools" / "smem_latency.cu"
SMEM_HOPS = 1 << 16            # dependent loads timed by the latency probe
GOLDEN = "cxl-ssd-cache@direct"
GOLDEN_CACHE = dict(capacity_bytes=16 * 4096, mshr_entries=4,
                    writeback_buffer=2)
GOLDEN_PINS = ROOT / "tests" / "golden" / "golden_traces.json"
# the fabric phase: the golden fabric scenario's mount (tests/golden/
# scenarios.py: a two-level tree, host h1 to device d1), and Table I's
# cached CXL-SSD behind the same tree for the main path's trace
FABRIC_GOLDEN = "cxl-ssd-cache@fabric"
FABRIC = dict(num_hosts=2, num_devices=2, num_leaves=2)
FABRIC_PLAN = dict(link_retry_rate=0.25)      # refused by the kernel lane
# the torch hash twins: 2^20 seeded uint64 values (the top bit set in
# half), ECMP path counts, and a NAND plan with both fault classes on
TWIN_VALUES = 1 << 20
TWIN_FLOWS = [("h0", "d0", 2), ("h3", "d1", 3), ("d2", "h1", 5),
              ("h1", "d3", 16)]
TWIN_NAND = dict(nand_read_retry_rate=0.35, nand_read_retry_max=3,
                 erase_fail_rate=0.4)
# the congestion estimator: 4 hosts x 4 devices on a spine-leaf with ECMP
ESTIMATOR = dict(num_hosts=4, num_devices=4, num_leaves=2, num_spines=2,
                 ecmp=True)
ESTIMATOR_ACCESSES = 1 << 22
ESTIMATOR_SCALES = [0.5, 1.0, 2.0, 4.0]
ESTIMATOR_RTOL = 1e-5          # float32 sums in another order
# (num_sets, ways, policy, lanes, trace): the first is the main path's
CHECK_SHAPES = [(1, 4096, "lru", 1, "uniform"), (1, 4096, "fifo", 1, "uniform"),
                (4096, 1, "direct", 1, "uniform"), (4096, 8, "lru", 1, "uniform"),
                (1, 64, "lru", 1, "collide"), (1, 4096, "fifo", 2, "uniform"),
                (3, 40, "lru", 1, "uniform"), (1, 4096, "lru", 1, "all_hit"),
                (1, 4096, "lru", 1, "all_miss")]
CHECK_ACCESSES = 8192          # per lane
SOURCE = "src/repro_torch/kernels/csrc/cache_sim.cu"
REPLACES = {"cache_sim": "src/repro/kernels/cache_sim.py:33",
            "cache_sim_fused": "src/repro/kernels/cache_sim.py:139"}
# the serving main path: repro_torch.launch.serve at full width
SERVE = dict(arch="h2o-danube-3-4b", batch=4, context=512, prompt_len=32,
             gen=608, policy="lru", kv_page_tokens=16, seed=0)
# the tiered store's counters and simulated CXL-SSD clock on that run,
# from the JAX package's TieredStore on the same archive schedule and page
# shape (tests/test_torch_tiered.py recomputes them)
TIERED_PIN = {"reads": 74, "hits": 44, "misses": 28, "coalesced": 2,
              "fills": 28, "writebacks": 0, "bytes_in": 165150720,
              "bytes_out": 0, "sim_ticks": 25236186660}
DECODE_SOURCES = {"flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
                  "page_gather": "src/repro_torch/kernels/csrc/page_gather.cu",
                  "page_scatter": "src/repro_torch/kernels/csrc/page_gather.cu"}
DECODE_REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:26",
                   "page_gather": "src/repro/kernels/page_gather.py:24",
                   "page_scatter": "src/repro/kernels/page_gather.py:50"}
# the device-side name of each kernel, as the profiler reports it
KERNEL_NAMES = {"flash_decode": "flash_decode_kernel",
                "page_gather": "gather_kernel",
                "page_scatter": "scatter_kernel"}
DECODE_TOL = dict(out=2e-5, m=1e-5, l_rtol=1e-4)   # tests/test_kernels.py
# (hd, G, n_valid, Skv) of each flash_decode check at B 4, KV 8: tile
# edges (32 rows) and split edges (about 64 rows a CTA; 448 = 7 x 64) of
# the serving cache, G 5 / 8 / 16, and a 4096-slot cache over 16 CTAs of
# 65 to 256 rows (chunks of 64)
DECODE_CHECKS = ([(hd, g, n, 512) for hd in (120, 128, 64) for g in (4, 1)
                  for n in (1, 31, 32, 512)]
                 + [(hd, g, n, 512) for hd in (120, 64) for g in (5, 8, 16)
                    for n in (63, 64, 65, 448, 511)]
                 + [(hd, g, n, 4096) for hd, g in ((120, 4), (128, 16))
                    for n in (1025, 4000, 4096)])
# (hd, G, n_valid, cluster): plans forced on the kernel, with short and
# empty last ranges (40 keys over 16 CTAs of 3 leave two CTAs none) and
# ranges of two chunks (1000 keys over 8 CTAs of 125)
DECODE_FORCED = [(120, 4, 40, 16), (64, 5, 100, 16), (128, 16, 300, 2),
                 (120, 4, 512, 1), (120, 4, 1000, 8)]
# other families' attention shapes timed at B 4, n_valid 512
DECODE_ARCHS = ("glm4-9b", "hymba-1_5b")
DECODE_LAYERS = 24             # stacked caches rotated over, past the L2
# the prefill main path: make_prefill_step at full width
PREFILL = dict(batch=2, seq=8192)
PREFILL_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PREFILL_REPLACES = "src/repro/kernels/flash_attention.py:25"
PREFILL_KERNEL = "flash_attention_kernel"
PREFILL_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_kernels.py, float32
# (S, Skv, causal, window) of each mask the kernel is checked on; a block
# is 128 query rows (position, head) of one KV head, 16 a warp, a key tile
# 32 keys; "edge" ends one key past a tile (and, at G 1, one row past a
# block), "cross_edge" one key past a tile with one partial block
PREFILL_MODES = {"causal": (256, 256, True, 0),
                 "window": (320, 320, True, 100),
                 "cross": (160, 200, False, 0),
                 "ragged": (333, 333, True, 0),
                 "edge": (129, 129, True, 0),
                 "cross_edge": (65, 129, False, 0)}
# (hd, G, mode, q scale): hd 36 and 100 are multiples of 4 but not of 8
# (zero-filled columns); q x 4 makes the scores large
PREFILL_CHECKS = [(hd, g, mode, q_scale) for hd in (64, 120, 128, 36, 100)
                  for g in (1, 4, 5, 8, 16) for mode in PREFILL_MODES
                  for q_scale in (1.0, 4.0)]
PARITY_TOKENS = 64             # decode steps held against the prefill
PARITY_TOL = 2e-3              # tests/test_models_smoke.py prefill/decode
PREFILL_TIMING_REPS = 8
SCHED_REQUESTS, SCHED_SLOTS, SCHED_NEW = 8, 4, 32
PROFILE_STEPS = 16              # decode steps at a full ring, profiled
TIMING_REPS = 24                # calls per device time, on rotating inputs
PROFILE_TRIES = 3               # profiler sessions before a timing gives up
EVENT_TIMED: list = []          # timings taken by CUDA events instead


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def golden_pin(scenario: str, lane: str) -> dict:
    """The pinned lane ``lane`` of ``scenario`` in the golden fixture."""
    return json.loads(GOLDEN_PINS.read_text())["scenarios"][scenario][lane]


def refuses(fn, exc) -> bool:
    """Whether ``fn()`` raises ``exc`` (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def nand_plain(statics, seq):
    """numpy twins of ``FaultPlan.nand_read_retries`` and ``erase_fails``
    over the uint64 array ``seq``: ``(retries int64, fails bool)``."""
    from repro_torch.core.faults.plan import (SALT_NAND_ERASE,
                                              SALT_NAND_READ, fault_hash_np)

    seed, read_thresh, read_max, erase_thresh = statics
    m32 = np.uint64((1 << 32) - 1)
    h = fault_hash_np(seed, SALT_NAND_READ, 0, seq)
    k = np.uint64(1) + (h >> np.uint64(32)) % np.uint64(read_max)
    retries = np.where((h & m32) < np.uint64(read_thresh), k,
                       np.uint64(0)).astype(np.int64)
    e = fault_hash_np(seed, SALT_NAND_ERASE, 0, seq)
    return retries, (e & m32) < np.uint64(erase_thresh)


def twin_mismatches(torch, dev, values: np.ndarray, seed: int) -> dict:
    """Elements where each torch hash twin, on ``dev``, differs from its
    numpy twin over the uint64 array ``values``."""
    from repro_torch.core.fabric.routing import (flow_choices,
                                                 flow_choices_torch)
    from repro_torch.core.faults import (FaultConfig, FaultPlan,
                                         erase_fails_torch,
                                         nand_read_retries_torch)

    bits = torch.from_numpy(values.view(np.int64)).to(dev)
    flows = 0
    for src, dst, paths in TWIN_FLOWS:
        got = flow_choices_torch(src, dst, bits, paths).cpu().numpy()
        flows += int((got != flow_choices(src, dst, values, paths)).sum())
    statics = FaultPlan(FaultConfig(**TWIN_NAND), seed=seed).nand_statics()
    retries, fails = nand_plain(statics, values)
    got_r = nand_read_retries_torch(statics, bits).cpu().numpy()
    got_e = erase_fails_torch(statics, bits).cpu().numpy()
    return {"flow_choices_torch": flows,
            "nand_read_retries_torch": int((got_r != retries).sum()),
            "erase_fails_torch": int((got_e != fails).sum())}


def twin_values(seed: int, n: int) -> np.ndarray:
    """``n`` seeded uint64 values, the extremes first."""
    values = np.random.default_rng(seed).integers(
        0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    values[:4] = [0, 2**63 - 1, 2**63, 2**64 - 1]
    return values


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_spills(log: str, kernel: str) -> int:
    """Bytes of spill stores and loads of every function whose (mangled)
    name holds ``kernel`` in an ``nvcc -Xptxas -v`` report.  Raises
    ``ValueError`` when the report names no such function, so a missing
    report never reads as no spills."""
    found = re.findall(
        r"Function properties for (\S*" + re.escape(kernel) + r"\S*)\n"
        r"\s*\d+ bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads", log)
    if not found:
        raise ValueError(f"the ptxas report names no {kernel}")
    return sum(int(a) + int(b) for _, a, b in found)


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


def bound_ms(accesses: int, ops_per_access: int, io_bytes_per_access: int,
             state_bytes: int, int32_ops_per_s: float) -> tuple[float, str]:
    """Roofline bound: each input read once and each output written once
    over the HBM rate, against ``ops_per_access`` integer operations per
    access over the card's INT32 rate."""
    t_bytes = (accesses * io_bytes_per_access + state_bytes) / HBM_BYTES_PER_S
    t_ops = accesses * ops_per_access / int32_ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def build_smem_probe(build) -> Path:
    """Build ``tools/smem_latency.cu`` with the kernels' ``nvcc`` flags."""
    out = build.build_dir() / "libsmem_latency.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(SMEM_PROBE)], capture_output=True, text=True)
    check(proc.returncode == 0,
          f"build of {SMEM_PROBE.name} failed:\n{proc.stdout}{proc.stderr}")
    return out


def smem_latency_cycles(torch, path: Path) -> float:
    """SM clock cycles of one dependent shared-memory load on this card,
    timed by ``tools/smem_latency.cu`` over ``SMEM_HOPS`` loads."""
    lib = ctypes.CDLL(str(path))
    lib.smem_latency.restype = ctypes.c_int
    lib.smem_latency.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = lib.smem_latency(SMEM_HOPS, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"shared-memory latency probe launch failed: {err}")
    return int(out[0]) / SMEM_HOPS


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


# ------------------------------------------------------------- serving path
def device_events(torch, run, enough) -> list:
    """The card's events (kernels, copies, memsets) that the profiler
    recorded while ``run()`` ran, from the first of ``PROFILE_TRIES``
    sessions whose events satisfy ``enough``; [] when none did.  On the
    card's machine a whole session now and then comes back with no device
    activity at all, so one empty session is not taken to mean that the
    card did nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        acts = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        if enough(acts):
            return acts
        say("timing", profiler_session="no device activity, again")
    return []


def device_ms(torch, fn, reps: int = TIMING_REPS,
              match: str | None = None, names: list | None = None) -> float:
    """Mean device time of one call ``fn(i)``, i < reps, from the
    profiler's record of the card: the summed durations of every kernel,
    copy and memset the calls ran, or of the kernels whose name holds
    ``match`` only (their names are appended to ``names`` when given).
    Host time between launches is not counted.  Where the profiler
    records nothing in ``PROFILE_TRIES`` sessions, the same calls are
    timed by CUDA events instead, host gaps included, and a ``[timing]``
    line says so.  Callers rotate the inputs with ``i`` over more than the
    50 MB L2 cache, so each call finds its data in device memory, as on
    the serving path."""
    def run():
        for i in range(reps):
            fn(i)

    def mine(acts):
        return [e for e in acts if match is None or match in e.name]

    fn(0)
    torch.cuda.synchronize()
    acts = mine(device_events(torch, run, lambda a: bool(mine(a))))
    if not acts:
        EVENT_TIMED.append(match or "all kernels of the call")
        say("timing", fallback="CUDA events", what=match or "all kernels",
            reason=f"the profiler recorded no device activity in "
                   f"{PROFILE_TRIES} sessions")
        return cuda_ms(torch, run) / reps
    if names is not None:
        names.extend(sorted({e.name for e in acts}))
    # a named kernel launches once a call: average over the launches the
    # profiler recorded, so one it misses does not count as no time
    calls = len(acts) if match else reps
    return sum(e.device_time_total for e in acts) / calls / 1e3


def timing_note() -> str:
    """The kernels line's ``timing`` entry: how its device times were
    taken."""
    note = "device time per call by torch.profiler"
    if EVENT_TIMED:
        note += (f"; by CUDA events, host gaps included, for "
                 f"{len(EVENT_TIMED)} timings the profiler did not record "
                 f"({', '.join(EVENT_TIMED)})")
    return note


def split_by_kind(acts, own: tuple, own_kind: str) -> dict:
    """Device milliseconds of the profiler's events ``acts`` by kind: the
    kernels whose name holds one of ``own`` (as ``own_kind``), matrix
    products, other kernels, and copies and memsets."""
    kinds = {own_kind: 0.0, "matmuls": 0.0, "other_kernels": 0.0,
             "copies": 0.0}
    for e in acts:
        if any(k in e.name for k in own):
            kind = own_kind
        elif e.name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif any(k in e.name.lower() for k in ("gemm", "gemv", "splitk")):
            kind = "matmuls"
        else:
            kind = "other_kernels"
        kinds[kind] += e.device_time_total / 1e3
    return kinds


def decode_err(got, want) -> dict:
    """flash_decode against its plain version: max |out|, max |m| and max
    relative l error."""
    (o, m, l), (wo, wm, wl) = got, want
    return {"out": float((o - wo).abs().max()),
            "m": float((m - wm).abs().max()),
            "l_rel": float(((l - wl).abs() / wl.abs()).max())}


def decode_within(err: dict) -> bool:
    return (err["out"] <= DECODE_TOL["out"] and err["m"] <= DECODE_TOL["m"]
            and err["l_rel"] <= DECODE_TOL["l_rtol"])


def worst_of(errs) -> dict:
    errs = list(errs)
    return {k: max(e[k] for e in errs) for k in errs[0]}


def listed(values) -> str:
    """The distinct values, in order, comma-separated."""
    return ",".join(map(str, dict.fromkeys(values)))


def decode_kernel_checks(torch, dev, seed: int) -> dict:
    """Phase 6: the serving kernels against their plain versions; the
    decode kernel's split plans and its device time at other families'
    attention shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ops import page_gather_op, page_scatter_op

    gen = torch.Generator(device=dev).manual_seed(seed)
    B, KV = 4, 8

    def inputs(g, hd, skv, kv=KV, layers=()):
        q = torch.randn(B, kv * g, hd, device=dev, generator=gen)
        kc, vc = (torch.randn(*layers, B, skv, kv, hd, device=dev,
                              generator=gen) for _ in range(2))
        return q, kc, vc

    errs = []
    for hd, g, n_valid, Skv in DECODE_CHECKS:
        q, kc, vc = inputs(g, hd, Skv)
        errs.append(decode_err(fd.flash_decode(q, kc, vc, n_valid),
                               fd.flash_decode_plain(q, kc, vc, n_valid)))
    for hd, g, n_valid, cluster in DECODE_FORCED:
        q, kc, vc = inputs(g, hd, max(512, n_valid))
        plan = fd.split_plan(n_valid, hd, B * KV, cluster=cluster)
        errs.append(decode_err(fd._launch(q, kc, vc, n_valid, plan),
                               fd.flash_decode_plain(q, kc, vc, n_valid)))
    worst = worst_of(errs)
    check(all(decode_within(e) for e in errs),
          f"flash_decode disagrees with its plain version: {worst}")
    say("decode", kernel="flash_decode", shapes=len(DECODE_CHECKS),
        forced_plans=len(DECODE_FORCED), B=B, KV=KV,
        hd=listed(c[0] for c in DECODE_CHECKS),
        G=listed(c[1] for c in DECODE_CHECKS),
        n_valid=listed(c[2] for c in DECODE_CHECKS),
        Skv=listed(c[3] for c in DECODE_CHECKS),
        forced=json.dumps(DECODE_FORCED, separators=(",", ":")),
        max_out_err=f"{worst['out']:.3e}", max_m_err=f"{worst['m']:.3e}",
        max_l_rel_err=f"{worst['l_rel']:.3e}",
        tol=json.dumps(DECODE_TOL, separators=(",", ":")))

    # the split plans: the serving shape, other families', a long cache
    shapes = {"h2o-danube-3-4b": (KV, 4, 120, 512)}
    for arch in DECODE_ARCHS:
        cfg = get_arch(arch)
        shapes[arch] = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                        cfg.resolved_head_dim, 512)
    shapes["h2o-danube-3-4b@4096"] = (KV, 4, 120, 4096)
    for name, (kv, g, hd, n_valid) in shapes.items():
        plan = fd.split_plan(n_valid, hd, B * kv)
        say("decode", plan=name, B=B, KV=kv, G=g, hd=hd, n_valid=n_valid,
            ctas=plan.ctas, cluster=plan.cluster, rows_per_cta=plan.rows,
            chunk_rows=plan.chunk,
            max_active_clusters=fd.max_active_clusters(g, hd, plan))

    # device time at other families' attention shapes, rotating over
    # stacked caches past the 50 MB L2, against the plain version and the
    # bytes bound
    times = {}
    for arch in DECODE_ARCHS:
        kv, g, hd, n = shapes[arch]
        q, kc, vc = inputs(g, hd, n, kv=kv, layers=(DECODE_LAYERS,))
        err = decode_err(fd.flash_decode(q, kc[0], vc[0], n),
                         fd.flash_decode_plain(q, kc[0], vc[0], n))
        check(decode_within(err), f"flash_decode disagrees with its plain "
                                  f"version at {arch}'s shape: {err}")
        ms = device_ms(torch, lambda i: fd.flash_decode(
            q, kc[i % DECODE_LAYERS], vc[i % DECODE_LAYERS], n),
            match=KERNEL_NAMES["flash_decode"])
        plain = device_ms(torch, lambda i: fd.flash_decode_plain(
            q, kc[i % DECODE_LAYERS], vc[i % DECODE_LAYERS], n))
        nbytes = 4 * (2 * B * n * kv * hd + 2 * B * kv * g * hd
                      + 2 * B * kv * g)
        times[arch] = {"shape": f"KV{kv}xG{g}xhd{hd}",
                       "us": round(ms * 1e3, 3),
                       "plain_us": round(plain * 1e3, 3),
                       "bound_us": round(nbytes / HBM_BYTES_PER_S * 1e6, 3),
                       "max_out_err": err["out"]}
        del q, kc, vc
    say("decode", kernel="flash_decode", B=B, n_valid=512,
        times=json.dumps(times, separators=(",", ":")))

    shape = (9, 24, 4, 16, 8, 120)   # pool slots x one KV page of the serve path
    table = torch.tensor([7, 2, 7, 0], dtype=torch.int32)   # slot 7 twice
    bad = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        pool = torch.randint(-1000, 1000, shape, device=dev,
                             generator=gen).to(dtype)
        pages = torch.randint(-1000, 1000, (4,) + shape[1:], device=dev,
                              generator=gen).to(dtype)
        if not torch.equal(page_gather_op(pool, table), pool[table.long()]):
            bad.append(f"gather {dtype}")
        got = page_scatter_op(pool.clone(), table, pages)
        want = pool.clone()
        for i, slot in enumerate(table.tolist()):
            want[slot] = pages[i]
        if not (torch.equal(got, want) and torch.equal(got[7], pages[2])):
            bad.append(f"scatter {dtype}")
    check(not bad, f"page kernels disagree with their plain versions: {bad}")
    say("decode", kernel="page_gather,page_scatter",
        dtypes="float32,bfloat16,int32", page_shape="x".join(map(str, shape[1:])),
        table=table.tolist(), mismatches=0, last_writer_wins="yes")
    return worst


def serve_phase(torch, dev) -> dict:
    """Phase 7: the serving main path at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import page_gather as pg
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init_params

    kw = dict(SERVE)
    cfg = get_arch(kw.pop("arch"))
    steps = kw["prompt_len"] + kw["gen"]
    t0 = time.perf_counter()
    params = init_params(cfg, kw["seed"], torch_device=dev)
    torch.cuda.synchronize()
    say("serve", arch=cfg.name, params=cfg.param_count(),
        param_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
        init_s=f"{time.perf_counter() - t0:.2f}",
        weights="'seeded torch.Generator on the card: not the JAX "
                "package's PRNG draws, so not bit-equal to its weights'")

    fd.reset_launches()
    pg.reset_launches()
    res = serve(params, cfg, **kw)
    launches = {**fd.LAUNCHES, **pg.LAUNCHES}
    check(all(v >= 1 for v in launches.values()),
          f"serving main path missed a kernel: launches {launches}")
    check(launches["flash_decode"] == steps * cfg.n_layers,
          f"flash_decode launches {launches['flash_decode']} != "
          f"{steps} steps x {cfg.n_layers} layers")
    for line in res.report():
        print(line, flush=True)
    check(res.tokens.shape == (steps, kw["batch"])
          and 0 <= res.tokens.min() and res.tokens.max() < cfg.vocab,
          "greedy tokens out of shape or range")
    check(all(bool(torch.isfinite(res.state[k]).all()) for k in "kv"),
          "non-finite values in the final KV caches")
    stats = dict(res.tiered.stats, sim_ticks=res.tiered.sim_ticks)
    check(stats == TIERED_PIN,
          f"tiered counters {stats} differ from the JAX pins {TIERED_PIN}")

    # flash_decode on the run's own final caches, every layer
    gen = torch.Generator(device=dev).manual_seed(kw["seed"] + 1)
    n_valid = min(steps, res.state["k"].shape[2])
    q = torch.randn(kw["batch"], cfg.n_heads, cfg.resolved_head_dim,
                    device=dev, generator=gen)
    errs = [decode_err(fd.flash_decode(q, res.state["k"][i],
                                       res.state["v"][i], n_valid),
                       fd.flash_decode_plain(q, res.state["k"][i],
                                             res.state["v"][i], n_valid))
            for i in range(cfg.n_layers)]
    worst = worst_of(errs)
    check(all(decode_within(e) for e in errs),
          f"flash_decode disagrees with its plain version on the run's "
          f"caches: {worst}")

    again = serve(params, cfg, **kw)
    check(np.array_equal(again.tokens, res.tokens),
          "two greedy runs gave different tokens")
    check(dict(again.tiered.stats, sim_ticks=again.tiered.sim_ticks) == stats,
          "two runs gave different tiered counters")
    say("serve", steps=steps, batch=kw["batch"],
        tok_per_s=f"{kw['batch'] * steps / res.seconds:.1f}",
        ms_per_step=f"{res.seconds / steps * 1e3:.3f}",
        archive_ms_per_step=f"{res.archive_seconds / steps * 1e3:.3f}",
        second_run_ms_per_step=f"{again.seconds / steps * 1e3:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        tiered_vs_jax_pins="equal",
        sim_cxl_ssd_us=f"{res.tiered.sim_time_us:.5f}",
        full_width_check=f"{cfg.n_layers}_layers_n_valid_{n_valid}",
        max_out_err=f"{worst['out']:.3e}", max_m_err=f"{worst['m']:.3e}",
        max_l_rel_err=f"{worst['l_rel']:.3e}",
        greedy_tokens_second_run="identical",
        first_tokens=json.dumps(res.tokens[:4].tolist(),
                                separators=(",", ":")))
    del again
    return dict(cfg=cfg, params=params, res=res, launches=launches,
                worst=worst, q=q, n_valid=n_valid, steps=steps)


def profile_phase(torch, run: dict) -> None:
    """Phase 8: where a decode step's time goes at a full ring (n_valid
    512): 16 steps that continue the main run, timed on the host clock,
    then 16 more under the profiler for the device time by kind."""
    from repro_torch.distributed.step import make_serve_step

    cfg, params, res = run["cfg"], run["params"], run["res"]
    step = make_serve_step(cfg)
    dev = params["embed"].device
    carry = [res.state, torch.from_numpy(res.tokens[-1]).to(dev)]

    def steps():
        state, tokens = carry
        for _ in range(PROFILE_STEPS):
            logits, state = step(params, state, tokens)
            tokens = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(
                torch.int32)
        torch.cuda.synchronize()
        carry[:] = [state, tokens]

    steps()                                               # warm
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS

    def enough(acts):
        kinds = split_by_kind(acts, tuple(KERNEL_NAMES.values()),
                              "port_kernels")
        return kinds["port_kernels"] > 0 and kinds["matmuls"] > 0

    kinds = {k: v / PROFILE_STEPS for k, v in split_by_kind(   # ms/step
        device_events(torch, steps, enough), tuple(KERNEL_NAMES.values()),
        "port_kernels").items()}
    check(kinds["port_kernels"] > 0 and kinds["matmuls"] > 0,
          f"the profile of the decode steps saw no kernels: {kinds}")
    busy = sum(kinds.values())
    main_ms = res.seconds * 1e3 / run["steps"]
    say("profile", decode_steps=PROFILE_STEPS,
        n_valid=min(res.state["cur"], res.state["k"].shape[2]),
        wall_ms_per_step=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        **{f"{k}_ms_per_step": f"{v:.4f}" for k, v in kinds.items()},
        idle_share=f"{1 - busy / wall_ms:.4f}",
        main_run_ms_per_step=f"{main_ms:.3f}")


def scheduler_phase(torch, run: dict, seed: int) -> None:
    """Phase 9: continuous batching at full width, twice."""
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serving.scheduler import (BatchScheduler, Request,
                                               SchedulerConfig)

    cfg, params = run["cfg"], run["params"]
    step = make_serve_step(cfg)

    def once():
        rng = np.random.default_rng(seed + 2)
        sched = BatchScheduler(
            lambda st, toks: step(params, st, toks),
            lambda b: init_decode_state(params, cfg, b, SERVE["context"]),
            SchedulerConfig(batch_slots=SCHED_SLOTS), cfg.vocab,
            torch_device=params["embed"].device)
        for rid in range(SCHED_REQUESTS):
            prompt = rng.integers(0, cfg.vocab, rng.integers(16, 65))
            sched.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                                 max_new_tokens=SCHED_NEW))
        t0 = time.perf_counter()
        done = sched.run(max_ticks=4000)
        return sched, {r: d.output for r, d in done.items()}, \
            time.perf_counter() - t0

    fd.reset_launches()
    sched, outs, secs = once()
    launches = fd.LAUNCHES["flash_decode"]
    check(sorted(outs) == list(range(SCHED_REQUESTS))
          and all(len(o) == SCHED_NEW for o in outs.values()),
          f"scheduler left requests unfinished: {sorted(outs)}")
    check(launches == sched.ticks * cfg.n_layers,
          f"scheduler ran {launches} flash_decode launches in "
          f"{sched.ticks} ticks")
    _, outs2, secs2 = once()
    check(outs2 == outs, "two scheduler runs gave different outputs")
    say("scheduler", requests=SCHED_REQUESTS, slots=SCHED_SLOTS,
        max_new_tokens=SCHED_NEW, ticks=sched.ticks,
        seconds=f"{secs:.2f}", second_run_seconds=f"{secs2:.2f}",
        ms_per_tick=f"{secs / sched.ticks * 1e3:.3f}",
        flash_decode_launches=launches, outputs_second_run="identical",
        first_outputs=json.dumps(outs[0][:8]))


def serve_kernel_rows(torch, dev, run: dict, check_worst: dict) -> list:
    """The serving kernels' rows of the kernels line: device times at the
    main path's shapes, plain versions and library calls on the same
    inputs, and bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels.ops import page_gather_op, page_scatter_op

    res, q, n = run["res"], run["q"], run["n_valid"]
    kc, vc = res.state["k"], res.state["v"]      # rotate over the 24 layers
    layers = kc.shape[0]
    B, H, hd = q.shape
    KV = kc.shape[3]
    ms = {"flash_decode": device_ms(
        torch, lambda i: fd.flash_decode(q, kc[i % layers], vc[i % layers], n),
        match=KERNEL_NAMES["flash_decode"])}
    plain = {"flash_decode": device_ms(
        torch, lambda i: fd.flash_decode_plain(q, kc[i % layers],
                                               vc[i % layers], n))}
    qs = q[:, :, None]
    ks = [kc[i, :, :n].transpose(1, 2) for i in range(layers)]
    vs = [vc[i, :, :n].transpose(1, 2) for i in range(layers)]
    lib = {"flash_decode": device_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            qs, ks[i % layers], vs[i % layers], enable_gqa=True))}
    lib_err = float((F.scaled_dot_product_attention(
        qs, ks[0], vs[0], enable_gqa=True)[:, :, 0]
        - fd.flash_decode_plain(q, kc[0], vc[0], n)[0]).abs().max())
    fd_bytes = 4 * (2 * B * n * KV * hd + 2 * B * H * hd + 2 * B * H)
    fd_flops = 4 * B * H * n * hd

    # two pages a call, rotating over the pool's 32 slots (189 MB)
    pool = res.tiered.pool.clone()
    slots = pool.shape[0]
    tables = [torch.tensor([(2 * i) % slots, (2 * i + 1) % slots],
                           dtype=torch.int32, device=dev)
              for i in range(slots // 2)]
    idxs = [t.long() for t in tables]
    # source pages rotate too, over as many pairs again
    sources = torch.randn((slots,) + tuple(pool.shape[1:]), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    flat = pool.view(slots, -1)

    def tb(i):
        return tables[i % len(tables)]

    def ix(i):
        return idxs[i % len(idxs)]

    ms["page_gather"] = device_ms(
        torch, lambda i: page_gather_op(pool, tb(i)),
        match=KERNEL_NAMES["page_gather"])
    srcs = [sources[i] for i in idxs]              # its own 2 pages a call
    ms["page_scatter"] = device_ms(
        torch, lambda i: page_scatter_op(pool, tb(i), srcs[i % len(srcs)]),
        match=KERNEL_NAMES["page_scatter"])
    plain["page_gather"] = device_ms(
        torch, lambda i: pg.page_gather_plain(flat, tb(i)))
    plain["page_scatter"] = device_ms(
        torch, lambda i: pg.page_scatter_plain(
            flat, tb(i), srcs[i % len(srcs)].view(2, -1)))
    lib["page_gather"] = device_ms(
        torch, lambda i: torch.index_select(pool, 0, ix(i)))
    lib["page_scatter"] = device_ms(
        torch, lambda i: pool.index_copy_(0, ix(i), srcs[i % len(srcs)]))
    page_bytes = res.tiered.page_bytes
    copy_bytes = 2 * 2 * page_bytes + 2 * 4

    steps, launches = run["steps"], run["launches"]
    say("serve", device_ms_per_step_at_full_ring=json.dumps(
        {k: round(ms[k] * launches[k] / steps, 6) for k in ms},
        separators=(",", ":")),
        flash_decode_us=f"{ms['flash_decode'] * 1e3:.2f}",
        page_gather_us_2_pages=f"{ms['page_gather'] * 1e3:.2f}",
        page_scatter_us_2_pages=f"{ms['page_scatter'] * 1e3:.2f}",
        sdpa_vs_plain_max_err=f"{lib_err:.3e}")

    rows = []
    plan = fd.split_plan(n, hd, B * KV)
    shapes = {"flash_decode": f"q {B}x{H}x{hd}, caches {B}x{kc.shape[2]}x"
                              f"{KV}x{hd} (the run's, one layer a call), "
                              f"n_valid {n}; {plan.ctas} CTAs in clusters "
                              f"of {plan.cluster}, {plan.rows} rows a CTA",
              "page_gather": f"2 pages of {page_bytes} B a call from the "
                             f"run's pool, rotating over its {slots} slots",
              "page_scatter": f"2 pages of {page_bytes} B a call into the "
                              f"run's pool, rotating over its {slots} slots"}
    library = {"flash_decode": "F.scaled_dot_product_attention(enable_gqa)",
               "page_gather": "torch.index_select",
               "page_scatter": "Tensor.index_copy_"}
    for name in ("flash_decode", "page_gather", "page_scatter"):
        if name == "flash_decode":
            t_bytes, t_ops = fd_bytes / HBM_BYTES_PER_S, \
                fd_flops / FP32_FLOPS_PER_S
            err = max(check_worst["out"], run["worst"]["out"])
            tol = DECODE_TOL
        else:
            t_bytes, t_ops, err, tol = copy_bytes / HBM_BYTES_PER_S, 0.0, 0, 0
        rows.append({
            "name": name, "route": "cuda", "source": DECODE_SOURCES[name],
            "replaces": DECODE_REPLACES[name],
            "launches": launches[name], "max_abs_err": err,
            "tolerance": tol, "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib[name], "library": library[name],
            "shape": shapes[name],
            "timing": timing_note(),
        })
    return rows


# ------------------------------------------------------------ prefill path
def close_err(torch, got, want, tol: dict) -> tuple[float, float, bool]:
    """Max |got - want|, the largest error as a share of its element's
    tolerance ``atol + rtol * |want|``, and whether every element is
    within it.  A NaN in either fails the check and reads as inf."""
    diff = (got - want).abs()
    bound = tol["atol"] + tol["rtol"] * want.abs()
    ok = bool((diff <= bound).all())
    inf = float("inf")
    share = (diff / bound).nan_to_num(nan=inf).max()
    return float(diff.nan_to_num(nan=inf).max()), float(share), ok


def prefill_kernel_checks(torch, dev, seed: int) -> float:
    """Phase 10a: flash_attention against its plain version on the card."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    B, KV = 2, 2
    worst, share, bad = 0.0, 0.0, []
    for hd, g, mode, q_scale in PREFILL_CHECKS:
        S, Skv, causal, window = PREFILL_MODES[mode]
        q = torch.randn(B, S, KV * g, hd, device=dev, generator=gen) * q_scale
        k, v = (torch.randn(B, Skv, KV, hd, device=dev, generator=gen)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err, case, ok = close_err(torch, got, want, PREFILL_TOL)
        worst, share = max(worst, err), max(share, case)
        if not ok:
            bad.append((hd, g, mode, q_scale, err))
    check(not bad, f"flash_attention disagrees with its plain version: {bad}")
    say("prefill", kernel="flash_attention", shapes=len(PREFILL_CHECKS),
        B=B, KV=KV, hd=listed(c[0] for c in PREFILL_CHECKS),
        G=listed(c[1] for c in PREFILL_CHECKS),
        q_scale=listed(c[3] for c in PREFILL_CHECKS),
        masks=json.dumps({m: dict(zip(("S", "Skv", "causal", "window"), c))
                          for m, c in PREFILL_MODES.items()},
                         separators=(",", ":")),
        max_abs_err=f"{worst:.3e}", max_share_of_tol=f"{share:.3f}",
        tol=json.dumps(PREFILL_TOL, separators=(",", ":")))
    return worst


def prefill_phase(torch, run: dict, seed: int, check_worst: float) -> dict:
    """Phase 10b: the prefill main path at full width, checked and
    measured; returns the kernel's row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.distributed.step import make_prefill_step, make_serve_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False    # float32, as the
    torch.backends.cudnn.allow_tf32 = False          # reference computes
    cfg, params = run["cfg"], run["params"]
    dev = params["embed"].device
    B, S = PREFILL["batch"], PREFILL["seq"]
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev, generator=gen,
                           dtype=torch.int32)
    step = make_prefill_step(cfg)

    fa.reset_launches()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_attention"]
    check(launches == cfg.n_layers,
          f"prefill ran {launches} flash_attention launches, not one per "
          f"layer ({cfg.n_layers})")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab),
          f"prefill logits of shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    head = logits[0, :PARITY_TOKENS].clone()
    del logits

    t0 = time.perf_counter()
    step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    def enough(acts):
        kinds = split_by_kind(acts, (PREFILL_KERNEL,), "flash_attention")
        return kinds["flash_attention"] > 0 and kinds["matmuls"] > 0

    kinds = split_by_kind(
        device_events(torch, lambda: step(params, {"tokens": tokens}),
                      enough), (PREFILL_KERNEL,), "flash_attention")
    busy = sum(kinds.values())
    check(kinds["flash_attention"] > 0 and kinds["matmuls"] > 0,
          f"the profile of the prefill saw no kernels: {kinds}")

    # the kernel on layer 0's own q / k / v, against its plain version
    window = cfg.swa_window
    positions = torch.arange(S, device=dev)[None, :]
    with torch.no_grad():
        blk = {k: params["blocks"][k][0] for k in T.BLOCK_KEYS}
        h = L.rms_norm(L.embed_tokens(params["embed"], tokens.long()),
                       blk["ln1"], cfg.norm_eps)
        q, k, v = T.attention_inputs(h, blk, cfg, positions)
        del h
        layer_err, _, ok = close_err(
            torch, fa.flash_attention(q, k, v, window=window),
            fa.flash_attention_plain(q, k, v, window=window), PREFILL_TOL)
    check(ok, f"flash_attention disagrees with its plain version on layer "
              f"0 at the full shape: max error {layer_err:.3e}")

    # prefill against decode: the first prompt's first tokens, one a step
    serve = make_serve_step(cfg)
    state = T.init_decode_state(params, cfg, 1, PARITY_TOKENS)
    dec = []
    for t in range(PARITY_TOKENS):
        lg, state = serve(params, state, tokens[:1, t])
        dec.append(lg[0])
    dec = torch.stack(dec)
    parity_err, _, ok = close_err(torch, dec, head,
                                  dict(atol=PARITY_TOL, rtol=PARITY_TOL))
    check(ok, f"prefill logits differ from {PARITY_TOKENS} decode steps: "
              f"max error {parity_err:.3e}")
    check(torch.equal(dec[:, :cfg.vocab].argmax(-1),
                      head[:, :cfg.vocab].argmax(-1)),
          "prefill and decode disagree on the greedy tokens")
    del state, dec

    # device time of the kernel, its plain version and the library call
    # on layer 0's inputs (0.38 GB a call, 7.6x the 50 MB L2)
    reps = PREFILL_TIMING_REPS
    ms = device_ms(torch, lambda i: fa.flash_attention(q, k, v, window=window),
                   reps=reps, match=PREFILL_KERNEL)
    events_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                          window=window),
                        reps=reps)
    plain_ms = device_ms(
        torch, lambda i: fa.flash_attention_plain(q, k, v, window=window),
        reps=2)
    band = L._block_mask(positions[0], positions[0], window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_names = []
    lib_ms = device_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True),
        reps=2, names=lib_names)
    lib_err = float((F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True).transpose(1, 2)
        - fa.flash_attention(q, k, v, window=window)).abs().max())
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    # (query, key) pairs the causal band keeps, for one batch row and head
    pairs = int(np.minimum(np.arange(1, S + 1), window or S).sum())
    flops = 4 * hd * pairs * B * H
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    # the kernel's work: every product three times over, on the tensor
    # cores; the same flops on the FP32 FMA units beside it
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = TF32_SPLIT_TERMS * flops / TF32_FLOPS_PER_S
    fma_ms = flops / FP32_FLOPS_PER_S * 1e3
    say("prefill", arch=cfg.name, batch=B, seq=S, tokens=B * S,
        first_wall_ms=f"{first_s * 1e3:.3f}", wall_ms=f"{wall_s * 1e3:.3f}",
        tok_per_s=f"{B * S / wall_s:.1f}",
        device_busy_ms=f"{busy:.3f}",
        **{f"{k}_ms": f"{v:.4f}" for k, v in kinds.items()},
        idle_share=f"{1 - busy / (wall_s * 1e3):.4f}",
        launches=launches, max_logit=f"{float(head.abs().max()):.3f}",
        layer0_max_abs_err=f"{layer_err:.3e}",
        decode_parity_tokens=PARITY_TOKENS,
        decode_parity_max_err=f"{parity_err:.3e}", greedy_argmax="equal",
        tf32="off")
    say("prefill", flash_attention_ms=f"{ms:.4f}",
        flash_attention_cuda_events_ms=f"{events_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", sdpa_ms=f"{lib_ms:.4f}",
        bound_ms=f"{max(t_bytes, t_ops) * 1e3:.4f}",
        fp32_fma_bound_ms=f"{fma_ms:.4f}",
        live_pairs_per_head=pairs, gflop=f"{flops / 1e9:.1f}",
        tflops=f"{flops / ms / 1e9:.2f}",
        split_tf32_tflops=f"{TF32_SPLIT_TERMS * flops / ms / 1e9:.2f}",
        sdpa_vs_kernel_max_err=f"{lib_err:.3e}",
        sdpa_kernels=repr(",".join(lib_names)[:200]))
    return {
        "name": "flash_attention", "route": "cuda", "source": PREFILL_SOURCE,
        "replaces": PREFILL_REPLACES, "launches": launches,
        "max_abs_err": max(check_worst, layer_err), "tolerance": PREFILL_TOL,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_note": "3 x the flops (split TF32) over the TF32 tensor-core "
                      "peak",
        "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention(attn_mask=band, "
                   "enable_gqa=True)",
        "shape": f"q {B}x{S}x{H}x{hd}, k/v {B}x{S}x{cfg.n_kv_heads}x{hd} "
                 f"(layer 0 of the run), causal, window {window}",
        "timing": timing_note(),
    }


def fabric_phase(torch, dev, trace, direct, seed: int) -> dict:
    """[fabric]: the kernel lane on fabric mounts, the fault refusal, the
    torch hash twins and the congestion estimator, all on the card."""
    from repro_torch.core.cache.dram_cache import DRAMCacheConfig
    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.fabric.link_sim import LinkCongestionSim
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay.cuda_engine import run_cuda
    from repro_torch.core.replay.spec import ReplayUnsupported, trace_to_arrays
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.core.workloads.traces import hash_seed, make_trace
    from repro_torch.kernels import cache_sim as ks

    # the golden fabric scenario's pallas pin, through the driver and
    # through run_cuda(validate=True)
    pin = golden_pin(FABRIC_GOLDEN, "pallas")
    gtrace = make_trace(hash_seed(FABRIC_GOLDEN))
    addrs, writes, size = trace_to_arrays(gtrace)

    def golden_mount():
        fab = Fabric.build("two_level", **FABRIC)
        return fab.mount("h1", "d1", make_device(
            "cxl-ssd-cache", cache_cfg=DRAMCacheConfig(policy="lru",
                                                       **GOLDEN_CACHE)))

    runs = {"driver": TraceDriver(golden_mount(), outstanding=8,
                                  engine="cuda").run(gtrace),
            "validate": run_cuda(golden_mount(), addrs, writes, size=size,
                                 outstanding=8, validate=True)}
    for how, gres in runs.items():
        check(gres.latency_ticks.tolist() == pin["latency_ticks"],
              f"fabric golden per-access latencies ({how})")
        for field in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
            check(getattr(gres, field) == pin[field],
                  f"fabric golden {field} ({how})")
    say("fabric", scenario=FABRIC_GOLDEN, lane="cuda",
        accesses=len(gtrace), elapsed_ticks=runs["driver"].elapsed_ticks,
        equal="all fields", validate="pass")

    # the main path's trace on Table I's cached CXL-SSD behind a two-level
    # tree: the kernel lane reads the mounted device alone (the JAX
    # package's design), so every output equals the direct run's
    fab = Fabric.build("two_level", **FABRIC)
    mount = fab.mount("h0", "d0", make_device("cxl-ssd-cache"))
    ks.reset_launches()
    t0 = time.perf_counter()
    fres = TraceDriver(mount, engine="cuda").run(trace)
    wall = time.perf_counter() - t0
    launches = dict(ks.LAUNCHES)
    check(launches["cache_sim_fused"] >= 1,
          f"the fabric mount's replay missed cache_sim_fused: {launches}")
    for field in ("latency_ticks", "hit_flags", "evict_flags"):
        check(np.array_equal(getattr(fres, field), getattr(direct, field)),
              f"fabric-mounted and direct replays differ in {field}")
    for field in ("elapsed_ticks", "sum_latency_ticks", "end_tick"):
        check(getattr(fres, field) == getattr(direct, field),
              f"fabric-mounted and direct replays differ in {field}")
    install(FaultPlan(FaultConfig(**FABRIC_PLAN)), [mount])
    check(refuses(lambda: run_cuda(mount, addrs, writes), ReplayUnsupported),
          "run_cuda replayed a mount with an active fault plan")
    say("fabric", mount="two_level h0->d0", device="cxl-ssd-cache Table I",
        accesses=fres.accesses, equal_to_direct="all fields",
        launches=json.dumps(launches, separators=(",", ":")),
        driver_wall_s=f"{wall:.3f}", fault_plan="refused")

    # the torch hash twins on the card, bit for bit
    mism = twin_mismatches(torch, dev, twin_values(seed, TWIN_VALUES), seed)
    check(not any(mism.values()), f"torch hash twins differ: {mism}")
    say("fabric", twins=",".join(mism), values=TWIN_VALUES, mismatches=0)

    # the congestion estimator on the card against its CPU result
    sfab = Fabric.build("spine_leaf", **ESTIMATOR)
    hosts, devices = sfab.topology.hosts, sfab.topology.devices
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, len(hosts), ESTIMATOR_ACCESSES)
    di = rng.integers(0, len(devices), ESTIMATOR_ACCESSES)
    nb = rng.integers(1, 5, ESTIMATOR_ACCESSES) * 64
    sims = {"cuda": LinkCongestionSim(sfab, hosts, devices),
            "cpu": LinkCongestionSim(sfab, hosts, devices,
                                     torch_device="cpu")}
    sims["cuda"].estimate(hi, di, nb, window_s=1e-3)        # warm up
    torch.cuda.synchronize()
    out, secs = {}, {}
    for where, sim in sims.items():
        t0 = time.perf_counter()
        est = sim.estimate(hi, di, nb, window_s=1e-3)       # ends on the host
        secs[where] = time.perf_counter() - t0
        out[where] = (est, sim.what_if_bandwidth(hi, di, nb, 1e-3,
                                                 ESTIMATOR_SCALES))
    (est, wif), (cest, cwif) = out["cuda"], out["cpu"]
    check(est["bottleneck_link"] == cest["bottleneck_link"],
          "estimator bottleneck differs between the card and the CPU")
    worst = 0.0
    for got, want, keys in ((est, cest, ("link_utilization", "pair_slowdown",
                                         "pair_bytes")),
                            (wif, cwif, ("max_link_utilization",
                                         "mean_pair_slowdown"))):
        for key in keys:
            rel = np.abs(got[key].astype(np.float64) - want[key]) \
                / np.maximum(np.abs(want[key]), 1e-30)
            worst = max(worst, float(rel.max()))
    check(worst <= ESTIMATOR_RTOL,
          f"estimator on the card vs the CPU: rel err {worst} > "
          f"{ESTIMATOR_RTOL}")
    check(int(est["pair_bytes"].sum()) == int(nb.sum()),
          "estimator lost bytes")
    say("fabric", estimator="spine_leaf 4x4 ecmp",
        accesses=ESTIMATOR_ACCESSES, links=len(est["link_names"]),
        bottleneck=est["bottleneck_link"],
        max_rel_err=f"{worst:.3e}", rtol=ESTIMATOR_RTOL,
        estimate_wall_ms=f"{secs['cuda'] * 1e3:.3f}",
        cpu_estimate_wall_ms=f"{secs['cpu'] * 1e3:.3f}")
    return {"launches": launches, "driver_wall_s": wall}


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
    with ThreadPoolExecutor(len(_build.SOURCES) + 1) as pool:   # one nvcc each
        probe_lib = pool.submit(build_smem_probe, _build)
        libs = list(pool.map(_build.build, _build.SOURCES))
        probe_lib = probe_lib.result()
    for name in _build.SOURCES:
        _build.library(name)
    ptxas = [f"{name}: {ln.strip()}" for name, log in _build.build_log.items()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        libraries=",".join(p.name for p in libs))
    for ln in ptxas:
        say("build", ptxas=repr(ln))
    spilled = ptxas_spills(_build.build_log.get("flash_attention", ""),
                           "flash_attention_kernel")
    say("prefill", kernel="flash_attention", spill_bytes=spilled)
    check(spilled == 0, f"flash_attention spills {spilled} bytes: {ptxas}")

    # 3. kernels against their plain versions, on the card --------------
    table1 = make_device("cxl-ssd-cache")
    timing = {k: v for k, v in cuda_params(table1, 0.5).items()
              if k.endswith("_ns")}
    mismatches = {"cache_sim": 0, "cache_sim_fused": 0}
    max_err = {"cache_sim": 0, "cache_sim_fused": 0}
    plain_ms = {}
    plain_kernel_ms = {}
    check(_build.library("cache_sim").cache_sim_hash_mul() == ks.HASH_MUL,
          "the kernel's hash multiplier differs from the wrapper's HASH_MUL")
    for index, case in enumerate(CHECK_SHAPES):
        num_sets, ways, policy, lanes, trace_kind = case
        shape = (CHECK_ACCESSES,) if lanes == 1 else (lanes, CHECK_ACCESSES)
        pages, writes = ks.stress_trace(trace_kind, num_sets, ways, shape,
                                        seed=args.seed + index)
        pages, writes = pages.to(dev), writes.to(dev)
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
                policy=policy, lanes=lanes, trace=trace_kind,
                accesses=CHECK_ACCESSES, mismatches=bad, max_abs_err=err,
                kernel_ms=f"{ms:.3f}",
                ns_per_access=f"{ms * 1e6 / CHECK_ACCESSES:.1f}")
            if case == CHECK_SHAPES[0]:
                plain_kernel_ms[name] = ms
        if case == CHECK_SHAPES[0]:
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
    # the serial-chain bound, a model: dependent shared-memory round trips
    # of this trace's accesses x the latency (one set: its first `frames`
    # misses fill it)
    smem_cycles = smem_latency_cycles(torch, probe_lib)
    misses = n - res.hits
    fills = min(misses, geo["num_sets"] * geo["ways"])
    round_trips = (ROUND_TRIPS["hit"] * res.hits + ROUND_TRIPS["fill"] * fills
                   + ROUND_TRIPS["evict"] * (misses - fills))
    serial_ms = round_trips * smem_cycles / (sm_clock_mhz * 1e3)
    say("main", accesses=n, hit_rate=f"{res.hits / n:.6f}",
        dirty_evicts=int(res.evict_flags.sum()),
        avg_latency_ns=f"{res.avg_latency_ns:.3f}",
        elapsed_ticks=res.elapsed_ticks, end_tick=res.end_tick,
        fused_kernel_ms=f"{kernel_ms['cache_sim_fused']:.3f}",
        ns_per_access=f"{kernel_ms['cache_sim_fused'] * 1e6 / n:.1f}",
        decisions_kernel_ms=f"{kernel_ms['cache_sim']:.3f}",
        driver_wall_s=f"{t1 - t0:.3f}", simulate_trace_wall_s=f"{t2 - t1:.3f}",
        smem_latency_cycles=f"{smem_cycles:.2f}",
        round_trips_per_access=f"{round_trips / n:.4f}",
        serial_chain_bound_ms=f"{serial_ms:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        host_policy_check="pass", host_latency_check="pass",
        validate="pass")

    # 5. golden pin on the card -------------------------------------------
    pin = golden_pin(GOLDEN, "pallas")
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

    # 6. the replay lane on the fabric ------------------------------------
    fabric = fabric_phase(torch, dev, trace, res, args.seed)

    # 7.-10. the serving path --------------------------------------------
    check_worst = decode_kernel_checks(torch, dev, args.seed)
    run = serve_phase(torch, dev)
    profile_phase(torch, run)
    scheduler_phase(torch, run, args.seed)
    serve_rows = serve_kernel_rows(torch, dev, run, check_worst)

    # 11. the prefill path ------------------------------------------------
    prefill_row = prefill_phase(torch, run, args.seed,
                                prefill_kernel_checks(torch, dev, args.seed))

    # kernels line -------------------------------------------------------
    int32_ops_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                       * INT32_LANES_PER_SM * sm_clock_mhz * 1e6)
    rows = []
    for name, io in (("cache_sim", 7), ("cache_sim_fused", 15)):
        state = 12 * 4096 if name == "cache_sim" else 0
        b_ms, b_by = bound_ms(n, OPS_PER_ACCESS[name], io, state,
                              int32_ops_per_s)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "tolerance": 0,
            "ms": kernel_ms[name],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "accesses": n, "plain_accesses": CHECK_ACCESSES,
            "kernel_ms_at_plain_accesses": plain_kernel_ms[name],
            "shapes": [f"{s}x{w}:{p}:{lanes}:{t}"
                       for s, w, p, lanes, t in CHECK_SHAPES],
            "mismatches": mismatches[name],
            "fabric_launches": fabric["launches"][name],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": rows + serve_rows + [prefill_row]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
