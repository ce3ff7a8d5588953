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
   slot (exact), and (after the serving run, on its pool) each against
   its library call (``torch.index_select``, ``Tensor.index_copy_``) over
   200 calls of each in turn: medians and 10th-90th percentile spreads,
   and whether they separate;
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
   flops), its plain version and ``F.scaled_dot_product_attention``;
12. scan: the tick-exact scan lane, ``TraceDriver(make_device(d),
   engine="scan")``, for the five devices at their defaults over the main
   path's trace, one ``replay_scan`` launch each, every replay equal access
   for access (latency ticks, hit and dirty-evict flags, elapsed and end
   ticks) to the python lane run on this host, with the kernel's device
   time, both walls, its bound and its serial-chain model (and PR 22's
   model of its warp-wide chain beside it); the 14 single-host
   fault-free golden ``python_scan`` pins and ``metrics`` blocks (GC
   included); the kernel against its plain twin (CPU tensors of this
   process) on the pins' traces, 4096 accesses of each device and 2^14
   of Table I's cached CXL-SSD (its cache filled and evicting).  It runs
   after the host-bound serving loop, so that its 2^20-access python-lane
   replays leave no load on that loop's host;
13. faults: the faulted scan lane, each replay one ``replay_scan`` launch
   held access for access against the python lane on this host (latency
   ticks, hit, dirty-evict and poison flags, elapsed and end ticks, GC
   runs, the fault counters and the metrics bundle, and the availability
   series under transport faults): Table I's cached CXL-SSD over the main
   path's trace under the golden ``faults-nand-retry@direct`` rates (NAND
   read retries and poison; its 16 GB run no GC at this footprint); the
   golden scenario's GC-pressured flash under the same plan over the
   longest power-of-two seeded trace that the python lane finishes
   (blocks retired); Table I's device mounted h0 -> d0 on a 2 x 2
   spine-leaf with ECMP under CRC retries and a down window, over the
   main path's first 2^18 accesses (link retries, degraded accesses and
   failovers), with the host time of the
   fault-column builder apart from the kernel's device time; each
   replay's bytes an access, bound and serial-chain model with its fault
   terms; the three golden fault scenarios' pins and metrics, and the
   kernel against its twin on them and on the GC trace;
14. assoc: ``TraceDriver(make_device(d), engine="assoc")`` over the main
   path's trace for dram, cxl-dram and pmem, each equal to phase 12's
   python lane or refused where the JAX package's numpy backend refuses
   (pinned: cxl-dram's trace is latency-bound); its wall, sweeps and
   device time by kind; the golden ``assoc_supported`` pins;
15. multihost: the fused multi-host replay, each replay one launch of
   ``replay_scan``'s multi-host instance held against the python lane on
   this host on every field (each host's latency ticks, hit, dirty-evict
   and poison flags, elapsed, end and latency-sum ticks, the span, GC
   runs, the metrics bundle with its fault counters, each host's
   availability series; that comparison at a quarter of the depth, each
   host's first 2^16 accesses, the timed replay at the full depth): ``MultiHostDriver(targets, engine="scan")`` over
   four Table I cached CXL-SSDs privately mounted on a two-level tree at
   4 x 2^18 accesses (the full-width path), three hosts on the golden
   ``multihost-qos-ecmp`` fabric pooling two DRAM devices at 2^20
   accesses, and two Table I devices on a 2 x 2 spine-leaf with ECMP
   under the ``faults-portdown@multihost_x2`` down window scaled to
   2 x 2^18 accesses (with the fault-column builder's host time); each
   with its kernel time, walls, bound and serial-chain model; the six
   golden multi-host pins and metrics; the kernel against its twin on
   them in both layouts and on the full-width targets;
16. stream: the streaming forms of the scan lane, one ``replay_scan``
   launch a chunk through a carry kept on the card, ``ceil(n / chunk)``
   launches each, every replay equal to its one-shot on every field:
   (a) ``replay_stream`` over a ``TraceStore`` of
   ``results/BENCH_replay.json``'s 1.2 M-access DRAM stream at chunks
   32768 and 131072 (prefetch depth 2, ``return_latencies=False``)
   against that file's one-shot sums, with each run's peak device memory;
   (b) the main path's trace through Table I's cached CXL-SSD streamed at
   chunks 2^10, 2^14 and 2^16 (latencies, flags and bundles equal to the
   [scan] phase's one-shot) and at 2^16 with bounded outputs, the kernel
   time summed over the launches and the wall beside the one-shot's; (c)
   Table I under the golden ``faults-nand-retry@direct`` plan over 2^18
   accesses, checkpointed every two chunks of 2^14, crashed after five
   and resumed from 4 x 2^14, byte-identical to the uninterrupted run;
   (d) the [faults] phase's spine-leaf mount with its down window scaled
   to accesses 2^14-2^15 of 2^16, streamed at chunk 3000 (seams inside
   the window), availability included; (e) the [multihost] phase's four
   Table I mounts at 4 x 2^16 steps, chunk 2^14, in both output modes;
17. sweep: the design-space sweeps, each one launch of ``replay_scan``'s
   sweep instances (one block a lane) through its entry point: (a)
   ``cache_design_sweep`` of Table I over the main path's trace, 128
   lanes (8 capacities from 256 to 4096 frames x LRU / FIFO x 8 flash
   read times), four lanes (the first, the last, the smallest FIFO, a
   timing lane) equal to standalone one-launch replays (latencies, flags,
   final frames) and 16 lanes at 4096 accesses to the twin; (b)
   ``host_count_sweep`` over the [multihost] phase's four Table I mounts
   at 1-4 hosts, 2^18 accesses a host, each lane equal to
   ``MultiHostReplay`` of its hosts; (c) ``fault_seed_sweep``:
   ``results/BENCH_replay.json``'s ``availability`` oracle (16 seeds at 4
   and 8 hosts) on every field, and two Table I mounts on the [multihost]
   phase's down window with CRC retries over 16 seeds, 2 x 2^16
   accesses, three lanes equal to standalone runs; (d) a GC-overfilled
   sweep refused.  Each sweep's lanes and waves, kernel time, wall and
   host time, its checked lanes' standalone kernel times and the serial
   cost it replaces, and the fault-column builder's host time;
18. fleet: the sharded fleet replay, each replay one launch of
   ``replay_scan``'s cluster instance (one CTA a shard of hosts; its
   registers and spills, and the cluster barrier's and a distributed
   shared-memory load's cycles by ``tools/smem_latency.cu``): (a)
   ``results/BENCH_replay.json``'s 64-host fleet, its columns built on the
   card by ``host_trace_torch`` (equal to ``host_trace_np``; both times),
   through ``ShardedMultiHostReplay.run_arrays`` at D = 1, 2, 4, 8 and 16
   where the card launches it and through the repaired one-CTA
   ``MultiHostReplay``, each exact on the oracle's four numbers, equal to
   the others and timed (kernel, ns a step, wall, bound, serial-chain
   model); (b) 512 hosts on ``multi_pod`` 8 x 64, 64 accesses a host:
   the one-CTA layout refused with its bytes, D = 8 and 16 equal to the
   unsharded CPU twin on every field; (c) the golden fleet pin at D = 1,
   2, 4, 8; (d) ``host_count_sweep(sharded=True)`` of (a) at 16, 32 and
   64 hosts, a launch each, equal to the unsharded sweep; the kernel
   against its twin on five cases.

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
# the scan phase: the five devices at make_device's defaults (the cached
# CXL-SSD is Table I's), the 14 single-host fault-free golden scenarios
# (tests/test_torch_scan.py), and the kernel against its twin at 4096
# accesses of each device
SCAN_DEVICES = ["dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache"]
SCAN_SCENARIOS = ([f"{d}@{a}" for d in SCAN_DEVICES
                   for a in ("direct", "fabric")]
                  + ["dram@stream", "pmem@stream", "dram-qos@fabric",
                     "ssd-gc@direct"])
SCAN_TWIN_ACCESSES = 4096
# Table I's cached CXL-SSD against its twin past its 4096 frames: the
# main-path trace's first 2^14 accesses touch about 10,000 of its 16,384
# pages, so the cache fills, evicts and writes back
SCAN_CHURN_ACCESSES = 1 << 14
SCAN_SOURCE = "src/repro_torch/kernels/csrc/replay_scan.cu"
# no Pallas kernel: the JAX package's per-access lax.scan step
SCAN_REPLACES = "src/repro/core/replay/engine.py:441"
SCAN_KERNEL = "replay_scan_kernel"
# dependent shared-memory round trips of one replay_scan access on its
# serial chain, a model of the one-thread walk (its input and, on the
# flash, its l2p entry are loaded one access ahead): the LFB tree's first
# sibling, the next ones loaded a level ahead (1); the buffer adds its
# page map, then the frame, the PAL's busy-untils on the fill and the
# recency list (+4); the cache adds its MSHR lookup, the page map, then
# the frame, the MSHR's expiry on a full table, the PAL's busy-untils on
# the fill and the recency list (+6); and one for each transport hop on
# a fixed route (its busy-until; ECMP reads the hop's port first).  The
# writeback's and GC's extra trips are not counted.
SCAN_ROUND_TRIPS = {"dram": 1, "pmem": 1, "ssd-buf": 5, "ssd-cache": 7}
SCAN_HOP_TRIPS = 1
# bytes of one access through device memory: address (8) and write flag
# (1) in, issue and completion ticks (8 + 8) and flags (4) out
SCAN_IO_BYTES = 29
# int64 operations of one access on the tick chain (each counted as two
# INT32 operations): the LFB min over 32 slots and the issue (33), the
# stamp and the next issue (2), and the media step: DRAM 4, PMEM 8, the
# buffer's match and argmin over 4 registers and its commit (14), the
# cache's over Table I's 4096 frames cut to one hash probe, as the
# cache_sim kernel finds a frame, with the MSHR and writeback tables and
# the commit (40)
SCAN_OPS = {"dram": 39, "pmem": 43, "ssd-buf": 49, "ssd-cache": 75}
# the faults phase: Table I's cached CXL-SSD under the golden
# faults-nand-retry@direct rates, then mounted behind a 2 x 2 spine-leaf
# with ECMP under CRC retries and a down window over the second quarter
# of the main path's first 2^18 accesses (cut from 2^20 so that the
# script keeps its time limit with the [sweep] phase: the python lane
# took 111 s there); the golden scenario's GC-pressured flash on
# the longest power-of-two seeded trace that the python lane finishes
# (2^13 accesses run out of space, tests/test_torch_faults_scan.py)
FAULT_NAND = dict(nand_read_retry_rate=0.3, erase_fail_rate=0.5,
                  poison_rate=0.1)
FAULT_NAND_SEED = 0
FAULT_FABRIC = dict(num_hosts=2, num_devices=2, num_leaves=2, num_spines=2,
                    ecmp=True)
FAULT_LINK = dict(link_retry_rate=0.25,
                  down_links=(("s0", "sp0", 1 << 16, 1 << 17),))
FAULT_LINK_ACCESSES = 1 << 18
FAULT_LINK_SEED = 7
FAULT_GC_SCENARIO = "faults-nand-retry@direct"
FAULT_GC_TRACE = dict(seed=24, n=1 << 12, pages=16)
# a transport-faulted access also moves its path id (4 B) and one retry
# byte a hop in; per hop it adds the path table's port read before the
# port's busy-until (one round trip on the chain) and the retry multiply
# and the off-hop test (3 int64 operations); each flash read adds the NAND
# retry decision, 13 dependent int64 steps (the xor, add, two shift-xor-
# multiply rounds, shift-xor, mask, compare, shift, remainder and the two
# retry multiplies), counted as operations and, at 4 cycles a step, on
# the chain
FAULT_PATH_BYTES = 4
FAULT_HOP_TRIPS = 1
FAULT_HOP_OPS = 3
NAND_HASH_STEPS = 13
ALU_STEP_CYCLES = 4
# the multihost phase: four Table I cached CXL-SSDs privately mounted h_i ->
# d_i on a two-level tree (benchmarks/replay_bench.py::_multi_targets(4)),
# 4 x 2^18 accesses; the golden multihost-qos-ecmp fabric (3 hosts, a
# 2 x 2 spine-leaf, ECMP, QoS weights 3:1:1) pooling two DRAM devices at
# 2^20 accesses in all; two Table I devices on a 2 x 2 spine-leaf with ECMP
# under the faults-portdown@multihost_x2 down window (s0-sp0 over
# accesses 20-90 of 160), scaled to 2 x 2^18 accesses; the six golden
# multi-host scenarios
MULTI_HOSTS = 4
MULTI_PER_HOST = 1 << 18
# the python lane's comparison runs the same cases at a quarter of the
# depth, each host's first accesses (at 2^18 a host its taps took 171 s,
# which the script's time limit no longer holds beside the [sweep] phase)
MULTI_PYTHON_PER_HOST = 1 << 16
MULTI_FABRIC = dict(num_leaves=2)
MULTI_QOS = dict(num_hosts=3, num_devices=2, num_leaves=2, num_spines=2,
                 ecmp=True, qos_weights={"h0": 3.0, "h1": 1.0, "h2": 1.0})
MULTI_DOWN = dict(num_hosts=2, num_devices=2, num_leaves=2, num_spines=2,
                  ecmp=True)
MULTI_DOWN_WINDOW = ("s0", "sp0", 20, 90, 160)     # (u, v, from, to, of)
MULTI_DOWN_SEED = 11
MULTI_SCENARIOS = ["multihost-qos-ecmp", "multihost-ssd-mounts",
                   "multihost-ssd-pool", "multihost-ssd-sharedflash",
                   "faults-portdown@multihost_x2",
                   "faults-linkretry@spine_leaf_x4"]
MULTI_TWIN_PER_HOST = 1024      # the full-width targets against the twin
MULTI_KERNEL = "replay_multi_kernel"
MULTI_REPLACES = "src/repro/core/replay/multihost.py:349"
# bytes of one multi-host step through device memory: address (8) and
# route row with the write flag (4) in, host (4), issue and completion
# ticks (8 + 8) and flags (4) out; a faulted step moves its packed retry
# bytes (8) too
MULTI_IO_BYTES = 36
MULTI_FAULT_BYTES = 8
# int64 operations a step adds to the single-host walk's: the host race, a
# compare and select a host (2 x hosts), the staged access and its
# successor's loads and the host's cursor, clock and candidate (6), and the
# lane switch's pointers and scalars when the lane changes (24); a weighted
# port's QoS mirror adds its membership tests (2 x hosts) and the vft,
# last-arrival, pace and floor updates (8), its float64 adds, divide and
# multiply apart
MULTI_STEP_OPS = 6
MULTI_LANE_OPS = 24
MULTI_QOS_OPS = 8
# dependent shared-memory round trips a step adds to the single-host
# model: the race over the hosts' candidates (1), the host's staged
# access and tree root (1), the lane's scalars (1); a weighted hop adds its
# vft and last-arrival reads (1).  The lanes' arrays in device memory (the
# map, links and l2p at full width) are L2 round trips the model leaves
# out.
MULTI_STEP_TRIPS = 3
MULTI_QOS_TRIPS = 1
# the stream phase: resumable replay_scan, one launch a chunk.  (a)
# results/BENCH_replay.json's streaming lane: 1.2 M DRAM accesses as
# benchmarks/replay_bench.py::_stream_trace_arrays builds them (1024
# pages, 30% writes, default_rng(5)), streamed from a TraceStore at its
# chunks with bounded outputs, and its one-shot oracle; (b) the main path's
# trace through Table I's cached CXL-SSD at three chunk sizes; (c) Table I
# under the golden faults-nand-retry@direct plan, crashed after five
# chunks and resumed from its checkpoint of two chunks ago; (d) the
# [faults] phase's spine-leaf mount with its down window scaled into
# 2^16 accesses, seams inside it; (e) the [multihost] phase's four Table I
# mounts at 2^16 accesses a host
STREAM_N = 1_200_000
STREAM_PAGES = 1024
STREAM_WRITE_FRAC = 0.3
STREAM_SEED = 5
STREAM_CHUNKS = (32768, 131072)
STREAM_DEPTH = 2
STREAM_ORACLE = {"sum_latency_ticks": 127862809067, "end_tick": 3999680000}
STREAM_MAIN_CHUNKS = (1 << 10, 1 << 14, 1 << 16)
STREAM_CRASH = dict(accesses=1 << 18, chunk=1 << 14, every=2, die_after=5)
STREAM_LINK = dict(accesses=1 << 16, window=(1 << 14, 1 << 15), chunk=3000)
STREAM_MULTI = dict(per_host=1 << 16, chunk=1 << 14)
# the sweep phase: the design-space sweeps, one replay_scan launch each,
# one block a lane.  (a) Table I over the main path's trace, 128 lanes:
# 8 capacities (frames) x LRU / FIFO x 8 flash read times (quarters of
# Table I's read_t), its twin check at 4096 accesses x 16 lanes; (b) the
# [multihost] phase's four Table I mounts at 1-4 hosts, 2^18 accesses a
# host; (c) results/BENCH_replay.json's availability oracle, and the
# [multihost] phase's two-host down window with CRC retries, 16 seeds,
# 2^16 accesses a host; (d) a GC-overfilled cache sweep, refused
SWEEP_KERNEL = "replay_sweep_kernel"
MULTI_SWEEP_KERNEL = "replay_multi_sweep_kernel"
SWEEP_REPLACES = "src/repro/core/replay/sweep.py:56"
SWEEP_CAPS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
SWEEP_READ_T = (2, 3, 4, 5, 6, 8, 12, 16)
SWEEP_TWIN = dict(accesses=4096, caps=(256, 1024, 2048, 4096),
                  read_t=(4, 8))
SWEEP_HOSTS = (1, 2, 3, 4)
SWEEP_HOST_PER_HOST = 1 << 18
SWEEP_SEEDS = 16
SWEEP_SEED_PER_HOST = 1 << 16
SWEEP_LINK = dict(link_retry_rate=0.15, link_retry_max=2)
SWEEP_SEED_CHECKED = (0, 7, 15)        # lanes held against standalone runs
# every lane check the phase prints, each of which must be equal
SWEEP_CHECKS = (("cache/first", "cache/last", "cache/fifo-smallest",
                 "cache/timing", "cache/twin")
                + tuple(f"hosts/{h}" for h in SWEEP_HOSTS)
                + ("oracle/x4", "oracle/x8")
                + tuple(f"seeds/{s}" for s in SWEEP_SEED_CHECKED)
                + ("overfill/refused",))
# the fleet phase: the sharded multi-host replay, one launch of
# replay_scan's cluster instance (a CTA a shard) a replay.  (a)
# results/BENCH_replay.json's fleet: 64 hosts x 1600 zipfian accesses
# (1024 pages, s = 1.1, 30% writes, seed 23) on multi_pod 4 x 16 (forward
# 10 ns, +4 ns a round trip), DRAM mounts, 8 outstanding, its columns built
# on the card; (b) 512 hosts on multi_pod 8 x 64 (2176 ports), 64 accesses
# a host of the same workload, whose tables one CTA cannot hold; (c) the
# golden fleet pin; (d) host_count_sweep(sharded=True) of (a)
FLEET_KERNEL = "replay_sharded_kernel"
FLEET_REPLACES = "src/repro/core/replay/shard.py:90"
FLEET_FABRIC = dict(forward_ns=10.0, rt_extra_ns=4.0)
FLEET_PODS = 4
FLEET_SHARDS = (1, 2, 4, 8, 16)
FLEET_BIG = dict(hosts=512, pods=8, per_host=64)
FLEET_BIG_SHARDS = (8, 16)
FLEET_PIN = "fleet-zipf@multipod_2x4"
FLEET_PIN_SHARDS = (1, 2, 4, 8)
FLEET_SWEEP = (16, 32, 64)
# the kernel against its twin (tests/torch_scenarios.py::shard_case):
# (case, shards)
FLEET_TWIN = (("shard/multipod-8", 8), ("shard/multipod-16", 16),
              ("shard/cxl-ssd-cache-4", 4), ("shard/qos-8", 4),
              ("faults-linkretry@spine_leaf_x4", 2))
# a sharded step adds to the one-CTA instance's chain a cluster barrier and
# two dependent distributed-shared-memory round trips (the slots, the
# winner's row), each timed by tools/smem_latency.cu's cluster probe
CLUSTER_HOPS = 2048
FLEET_DSMEM_TRIPS = 2
# the assoc phase: which of the main path's replays the associative lane
# certifies (True) or refuses (False), as the JAX package's numpy backend
# does (tests/test_torch_assoc.py holds the two equal)
ASSOC_DEVICES = {"dram": True, "cxl-dram": False, "pmem": True}
ASSOC_SWEEPS = 256             # tests/golden/scenarios.py's Kleene budget
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
COPY_ALTERNATIONS = 200         # page copy vs library call, in turn
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


def copy_verdict(torch, kernel: str, ours, theirs,
                 calls: int = COPY_ALTERNATIONS) -> dict:
    """A page copy against its library call: ``ours(i)`` (one launch of
    our kernel, named ``kernel``) and ``theirs(i)`` in turn, ``calls``
    times each, in one profiler session; each launch's device
    microseconds (every other kernel of the session is the library's),
    their medians and 10th-90th percentile spreads, and whether the
    spreads separate."""
    def run():
        for i in range(calls):
            ours(i)
            theirs(i)

    ours(0)
    theirs(0)
    torch.cuda.synchronize()
    acts = [e for e in device_events(
        torch, run, lambda a: any(kernel in e.name for e in a))
        if not e.name.startswith(("Memcpy", "Memset"))]
    mine = np.asarray([e.device_time_total for e in acts
                       if kernel in e.name], float)
    lib = [e for e in acts if kernel not in e.name]
    libs = np.asarray([e.device_time_total for e in lib], float)
    check(len(mine) > 0 and len(libs) > 0,
          f"the profiler recorded no {kernel} or library launch")
    lo, med, hi = (np.percentile(mine, q) for q in (10, 50, 90))
    llo, lmed, lhi = (np.percentile(libs, q) for q in (10, 50, 90))
    return {"library": ",".join(sorted({e.name[:60] for e in lib})),
            "calls": calls, "kernel_launches": int(len(mine)),
            "library_launches": int(len(libs)),
            "kernel_us_median": round(float(med), 3),
            "kernel_us_p10_p90": [round(float(lo), 3), round(float(hi), 3)],
            "library_us_median": round(float(lmed), 3),
            "library_us_p10_p90": [round(float(llo), 3), round(float(lhi), 3)],
            "separate": bool(hi < llo or lhi < lo),
            "faster": "kernel" if med < lmed else "library"}


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
    # the kernels through their launch alone (the wrapper's slot checks
    # are reductions and a read to the host), so that every other kernel
    # of the session is the library call's
    gathered = torch.empty((2,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                           device=dev)
    verdict = {
        "page_scatter": copy_verdict(
            torch, KERNEL_NAMES["page_scatter"],
            lambda i: pg._launch("page_scatter", pool, srcs[i % len(srcs)],
                                 tb(i)),
            lambda i: pool.index_copy_(0, ix(i), srcs[i % len(srcs)])),
        "page_gather": copy_verdict(
            torch, KERNEL_NAMES["page_gather"],
            lambda i: pg._launch("page_gather", gathered, pool, tb(i)),
            lambda i: torch.index_select(pool, 0, ix(i)))}
    for name, v in verdict.items():
        say("decode", page_copy=name, library=v.pop("library"),
            **{k: json.dumps(x) if isinstance(x, list) else x
               for k, x in v.items()})
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
            **({"alternating": verdict[name]} if name in verdict else {}),
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


class FlagTap:
    """A python-lane target that records, per access, the issue and
    completion ticks and whether the device counted a hit and a dirty
    eviction (cache or page-register hits and dirty evictions, PMEM row
    hits); behind a fabric, whether the fabric counted the access degraded
    and failed over; under a poison plan, the plan's verdict on it (the
    python driver's own, per access, keyed on ``host``, the target's index
    in its driver).  ``dev`` may be a device, a fabric mount, a pool view
    or a metrics tap over any of them; other attributes are the
    target's."""

    def __init__(self, dev, host: int = 0):
        self._dev = dev
        self.host = host
        self.issue, self.latency, self.hit, self.evict = [], [], [], []
        self.degraded, self.failover, self.poison = [], [], []

    def __getattr__(self, name):
        return getattr(self._dev, name)

    def counts(self) -> tuple[int, ...]:
        d = getattr(self._dev, "inner", self._dev)
        if hasattr(d, "cache"):
            out = (d.cache.policy.hits, d.cache.policy.dirty_evictions)
        else:
            out = (d.stats.get("buf_hits", d.stats.get("row_hits", 0)),
                   d.stats.get("flash_writes", 0))
        fab = getattr(self._dev, "fabric", None)
        fs = getattr(fab, "fault_stats", {})
        return out + (fs.get("degraded_accesses", 0), fs.get("failovers", 0))

    def service(self, now, addr, size, write, posted=False):
        before = self.counts()
        done = self._dev.service(now, addr, size, write, posted)
        h, e, dg, fo = (b > a for a, b in zip(before, self.counts()))
        plan = getattr(self._dev, "fault_plan", None)
        self.issue.append(now)
        self.latency.append(done - now)
        self.hit.append(h)
        self.evict.append(e)
        self.degraded.append(dg)
        self.failover.append(fo)
        self.poison.append(plan is not None and plan.has_poison and bool(
            plan.poisoned(self.host, len(self.issue) - 1, write)))
        return done


def scan_inputs(torch, make, trace, outstanding=32, metrics=False):
    """``(cfg, params, addrs, writes, routes, retries)`` of one replay of
    ``trace`` on a fresh ``make()``, as ``ReplayEngine`` prepares them
    (path ids and retry bytes under transport faults), on the CPU."""
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.spec import trace_to_arrays

    addrs, writes, size = trace_to_arrays(trace)
    cfg, params, routes, retries, _ = ReplayEngine(
        make(), outstanding=outstanding,
        metrics=MetricsSpec() if metrics else None).prepare(addrs, size=size)

    def cpu(x):
        return None if x is None else torch.from_numpy(x)

    return (cfg, params, cpu(addrs), cpu(writes), cpu(routes), cpu(retries))


def scan_against_twin(torch, make, trace, outstanding):
    """``replay_scan`` on the card against its plain twin on CPU tensors
    of this process, from fresh states: the elements that differ over
    every output and every final state tensor, the twin's wall
    milliseconds and its per-access flags."""
    from repro_torch.core.replay import stack
    from repro_torch.kernels import replay_scan as rs

    cfg, params, a, w, routes, retries = scan_inputs(
        torch, make, trace, outstanding, metrics=True)
    cpu, card = stack.init_state(cfg, "cpu"), stack.init_state(cfg, "cuda")
    t0 = time.perf_counter()
    want = rs.replay_scan(cfg, params, cpu, a, w, routes, retries=retries)
    plain_ms = (time.perf_counter() - t0) * 1e3

    def on_card(x):
        return None if x is None else x.cuda()

    got = rs.replay_scan(cfg, params, card, a.cuda(), w.cuda(),
                         on_card(routes), retries=on_card(retries))
    torch.cuda.synchronize()
    pairs = list(zip(got, want))
    for part in ("media", "flash"):
        pairs += [(card[part][k], x) for k, x in (cpu[part] or {}).items()]
    return sum(int((g.cpu() != x).sum()) for g, x in pairs), plain_ms, want[2]


def scan_kernel_ms(torch, make, trace) -> tuple[float, str]:
    """Device milliseconds of one ``replay_scan`` launch over ``trace`` on
    a fresh ``make()`` (32 outstanding), and how they were timed: by the
    profiler, or by CUDA events when it recorded nothing."""
    from repro_torch.core.replay import stack
    from repro_torch.kernels import replay_scan as rs

    cfg, params, *inputs = scan_inputs(torch, make, trace)
    a, w, r, rt = (None if x is None else x.cuda() for x in inputs)

    def run():
        rs.replay_scan(cfg, params, stack.init_state(cfg, "cuda"), a, w, r,
                       retries=rt)

    acts = [e for e in device_events(
        torch, run, lambda acts: any(SCAN_KERNEL in e.name for e in acts))
        if SCAN_KERNEL in e.name]
    if acts:
        return acts[0].device_time_total / 1e3, "profiler"
    EVENT_TIMED.append(SCAN_KERNEL)
    say("timing", fallback="CUDA events", what=SCAN_KERNEL,
        reason=f"the profiler recorded no device activity in "
               f"{PROFILE_TRIES} sessions")
    return cuda_ms(torch, run), "CUDA events"


def scan_phase(torch, trace, smem_cycles: float, sm_clock_mhz: float,
               int32_ops_per_s: float) -> dict:
    """[scan]: the tick-exact scan lane on the card for the five devices,
    each replay equal access for access to the python lane; the golden
    pins and metrics; the kernel against its twin; the refusals."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import (make_target, scenario_outstanding,
                                 scenario_trace)

    from repro_torch.core.devices import make_device
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.spec import build_stack
    from repro_torch.core.workloads.driver import TraceDriver
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    log = _build.build_log.get("replay_scan", "")
    spilled = ptxas_spills(log, SCAN_KERNEL)
    report = [ln.strip() for ln in log.splitlines()
              if "registers" in ln or "spill" in ln or "smem" in ln]
    say("scan", kernel="replay_scan", ptxas=repr(" | ".join(report)),
        spill_bytes=spilled)
    check(spilled == 0, f"replay_scan spills {spilled} bytes: {report}")

    # the main path: one replay per device, its launches counted alone
    n = len(trace)
    max_addr = max(a for a, _, _ in trace)
    runs, launches, kernel_ms, bound, serial = {}, {}, {}, {}, {}
    python = {}
    for d in SCAN_DEVICES:
        rs.reset_launches()
        t0 = time.perf_counter()
        res = TraceDriver(make_device(d), engine="scan").run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[d] = rs.LAUNCHES["replay_scan"]
        check(launches[d] == 1,
              f"the {d} scan replay launched replay_scan {launches[d]} times")
        runs[d] = (res, wall)
    for d in SCAN_DEVICES:
        res, wall = runs[d]
        tap = FlagTap(make_device(d))
        t0 = time.perf_counter()
        want = TraceDriver(tap).run(trace)
        py_wall = time.perf_counter() - t0
        check(np.array_equal(res.latency_ticks,
                             np.asarray(tap.latency, np.int64)),
              f"{d}: scan latencies differ from the python lane")
        check(np.array_equal(res.hit_flags, np.asarray(tap.hit))
              and np.array_equal(res.evict_flags, np.asarray(tap.evict)),
              f"{d}: scan hit or evict flags differ from the python lane")
        for field in ("elapsed_ticks", "end_tick", "sum_latency_ticks"):
            check(getattr(res, field) == getattr(want, field),
                  f"{d}: scan {field} differs from the python lane")
        python[d] = (np.asarray(tap.latency, np.int64), want)
        kernel_ms[d], how = scan_kernel_ms(torch, lambda: make_device(d),
                                           trace)
        cfg, _ = build_stack(make_device(d), size=64, outstanding=32,
                             issue_overhead_ns=0.5, posted_writes=True,
                             n_accesses=n, max_addr=max_addr)
        state = 2 * 4 * cfg.num_pages + 2 * 8 * cfg.cache_frames
        bound[d] = bound_ms(n, 2 * SCAN_OPS[cfg.kind], SCAN_IO_BYTES, state,
                            int32_ops_per_s)
        serial[d] = (n * (SCAN_ROUND_TRIPS[cfg.kind]
                          + SCAN_HOP_TRIPS * cfg.num_hops) * smem_cycles
                     / (sm_clock_mhz * 1e3))
        say("scan", device=d, accesses=n, equal_to_python="all fields",
            launches=launches[d], kernel_ms=f"{kernel_ms[d]:.3f}",
            timing=how, ns_per_access=f"{kernel_ms[d] * 1e6 / n:.1f}",
            driver_wall_s=f"{wall:.3f}", python_wall_s=f"{py_wall:.3f}",
            hit_rate=f"{res.hits / n:.6f}",
            avg_latency_ns=f"{res.avg_latency_ns:.3f}",
            bound_ms=f"{bound[d][0]:.6f}",
            serial_chain_ms=f"{serial[d]:.3f}")

    # the golden pins and metrics blocks on the card, GC included
    for name in SCAN_SCENARIOS:
        res = TraceDriver(make_target(name),
                          outstanding=scenario_outstanding(name),
                          engine="scan", metrics=MetricsSpec()).run(
            scenario_trace(name))
        pin = golden_pin(name, "python_scan")
        check(res.latency_ticks.tolist() == pin["latency_ticks"]
              and all(getattr(res, f) == pin[f] for f in (
                  "elapsed_ticks", "sum_latency_ticks", "end_tick")),
              f"scan pin {name} on the card")
        check(json.loads(json.dumps(res.metrics.to_jsonable()))
              == golden_pin(name, "metrics"), f"scan metrics {name}")
        if name == "ssd-gc@direct":
            check(res.gc_runs > 0, "the GC scenario ran no GC on the card")
            say("scan", scenario=name, gc_runs=res.gc_runs, pin="equal",
                metrics="equal")
    say("scan", pins=len(SCAN_SCENARIOS), python_scan="equal",
        metrics="equal")

    # the kernel against its plain twin: the pins' traces, then 4096
    # accesses of each device, then Table I's cached CXL-SSD over enough
    # accesses to fill its cache and evict from it
    mismatches, plain_ms = 0, {}
    for name in SCAN_SCENARIOS:
        bad, _, _ = scan_against_twin(
            torch, lambda: make_target(name), scenario_trace(name),
            scenario_outstanding(name))
        mismatches += bad
    for d in SCAN_DEVICES:
        bad, plain_ms[d], _ = scan_against_twin(
            torch, lambda: make_device(d), trace[:SCAN_TWIN_ACCESSES], 32)
        mismatches += bad
    bad, churn_ms, flags = scan_against_twin(
        torch, lambda: make_device("cxl-ssd-cache"),
        trace[:SCAN_CHURN_ACCESSES], 32)
    mismatches += bad
    check(mismatches == 0, f"replay_scan differs from its twin in "
                           f"{mismatches} elements")
    churn_hits = int((flags & 1).sum())
    churn_evicts = int(((flags >> 1) & 1).sum())
    check(churn_hits > 0 and churn_evicts > 0,
          f"the churn trace neither hit nor evicted ({churn_hits} hits, "
          f"{churn_evicts} dirty evictions)")
    say("scan", twin_checks=len(SCAN_SCENARIOS) + len(SCAN_DEVICES) + 1,
        mismatches=0, twin_ms_at_4096=json.dumps(
            {d: round(v, 3) for d, v in plain_ms.items()},
            separators=(",", ":")),
        churn_accesses=SCAN_CHURN_ACCESSES, churn_hits=churn_hits,
        churn_dirty_evictions=churn_evicts, churn_twin_ms=f"{churn_ms:.3f}")

    return {"launches": launches, "kernel_ms": kernel_ms, "bound": bound,
            "serial": serial, "plain_ms": plain_ms,
            "walls": {d: runs[d][1] for d in SCAN_DEVICES},
            "python": python, "table1": runs["cxl-ssd-cache"][0]}


def stream_trace_arrays(n: int):
    """``benchmarks/replay_bench.py::_stream_trace_arrays``: ``n`` DRAM
    accesses over 1024 pages, 30% writes, from ``default_rng(5)``."""
    rng = np.random.default_rng(STREAM_SEED)
    pages = rng.integers(0, STREAM_PAGES, n)
    addrs = pages * 4096 + rng.integers(0, 64, n) * 64
    writes = rng.random(n) < STREAM_WRITE_FRAC
    return addrs.astype(np.int64), writes


class Crashy:
    """A store whose chunk iterator fails after ``die_after`` chunks: a
    crash in the middle of a streamed replay."""

    def __init__(self, store, die_after: int) -> None:
        self._s = store
        self.die_after = die_after

    def __getattr__(self, name):
        return getattr(self._s, name)

    def chunks(self, chunk_size, start=0):
        for k, item in enumerate(self._s.chunks(chunk_size, start=start)):
            if k == self.die_after:
                raise RuntimeError("simulated crash")
            yield item


def stream_run(torch, run, *, profile: bool = True) -> tuple:
    """``run()`` with the launch count at 0: its result and ``{launches,
    wall_s, peak_bytes}`` (the device memory it allocated above what was
    allocated before it), then, with ``profile``, ``kernel_ms`` summed over
    the launches of a second run under the profiler (CUDA events around
    the whole run when the profiler records nothing) and ``host_s``."""
    from repro_torch.kernels import replay_scan as rs

    def mine(acts):
        return [e for e in acts
                if SCAN_KERNEL in e.name or MULTI_KERNEL in e.name]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rs.reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0,
           "launches": rs.LAUNCHES["replay_scan"],
           "peak_bytes": torch.cuda.max_memory_allocated() - base}
    if profile:
        acts = mine(device_events(torch, run, lambda a: bool(mine(a))))
        if acts:
            out["kernel_ms"] = sum(e.device_time_total for e in acts) / 1e3
            out["timing"] = "profiler"
            out["profiled_launches"] = len(acts)
        else:
            EVENT_TIMED.append("streamed " + SCAN_KERNEL)
            say("timing", fallback="CUDA events", what="a streamed replay",
                reason=f"the profiler recorded no device activity in "
                       f"{PROFILE_TRIES} sessions")
            out["kernel_ms"] = cuda_ms(torch, run)
            out["timing"] = "CUDA events"
        out["host_s"] = out["wall_s"] - out["kernel_ms"] / 1e3
    return res, out


def same_replay(got, want, bounded: bool = False) -> dict:
    """Which fields of a streamed single-host replay equal its one-shot:
    per-access latencies, hit, dirty-evict and poison flags and the
    availability series (unless ``bounded``), the scalars, GC runs and the
    metrics bundle (where the one-shot has one)."""
    def bundle(r):
        return None if r.metrics is None else json.loads(json.dumps(
            r.metrics.to_jsonable()))

    same = {"ticks": all(getattr(got, f) == getattr(want, f) for f in (
        "accesses", "elapsed_ticks", "sum_latency_ticks", "end_tick",
        "gc_runs"))}
    if want.metrics is not None:
        same["metrics"] = bundle(got) == bundle(want)
    if bounded:
        same["bounded"] = got.latency_ticks is None
        return same
    same["latency"] = np.array_equal(got.latency_ticks, want.latency_ticks)
    same["flags"] = (np.array_equal(got.hit_flags, want.hit_flags)
                     and np.array_equal(got.evict_flags, want.evict_flags))
    if want.poison_flags is not None:
        same["poison"] = np.array_equal(got.poison_flags, want.poison_flags)
    if want.availability is not None:
        same["availability"] = json.dumps(
            got.availability, sort_keys=True, default=str) == json.dumps(
            want.availability, sort_keys=True, default=str)
    return same


def stream_phase(torch, trace, scan: dict, seed: int) -> dict:
    """[stream]: the streaming forms of the scan lane on the card, one
    ``replay_scan`` launch a chunk, each replay equal to its one-shot on
    every field: the BENCH_replay.json streaming oracle, the main path's
    trace at three chunk sizes, a crash and its resume, transport faults
    with seams in the down window, and the multi-host replay."""
    import tempfile

    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.replay import replay_stream
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.core.replay.spec import trace_to_arrays
    from repro_torch.data import TraceStore

    spec = MetricsSpec()
    runs = {}
    t_phase = time.perf_counter()

    def need(same: dict, what: str) -> str:
        for field, ok in same.items():
            check(ok, f"[stream] {what}: {field} differs from the one-shot")
        return ",".join(same)

    def launches_are(out: dict, n: int, chunk: int, what: str) -> None:
        want = -(-n // chunk)
        check(out["launches"] == want,
              f"[stream] {what}: {out['launches']} launches, not {want}")

    tmp = tempfile.TemporaryDirectory()
    with tmp:
        # (a) the BENCH_replay.json streaming lane and its oracle
        addrs, writes = stream_trace_arrays(STREAM_N)
        one, out = stream_run(torch, lambda: ReplayEngine(
            make_device("dram")).run_arrays(addrs, writes))
        launches_are(out, 1, 1, "(a) one-shot")
        check({k: getattr(one, k) for k in STREAM_ORACLE} == STREAM_ORACLE,
              f"[stream] the one-shot DRAM stream: {one.sum_latency_ticks}, "
              f"{one.end_tick}")
        runs["a/oneshot"] = out
        say("stream", case="a", chunk="one-shot", accesses=STREAM_N,
            launches=out["launches"], kernel_ms=f"{out['kernel_ms']:.3f}",
            wall_s=f"{out['wall_s']:.3f}", host_s=f"{out['host_s']:.3f}",
            peak_device_bytes=out["peak_bytes"],
            sum_latency_ticks=one.sum_latency_ticks, end_tick=one.end_tick)
        store = TraceStore.write(Path(tmp.name) / "a.store", addrs, writes)
        for chunk in STREAM_CHUNKS:
            stats = {}
            got, out = stream_run(torch, lambda: replay_stream(
                store, make_device("dram"), chunk_size=chunk,
                prefetch_depth=STREAM_DEPTH, return_latencies=False,
                stats=stats))
            launches_are(out, STREAM_N, chunk, f"(a) chunk {chunk}")
            check({k: getattr(got, k) for k in STREAM_ORACLE}
                  == STREAM_ORACLE, f"[stream] (a) chunk {chunk}: "
                  f"{got.sum_latency_ticks}, {got.end_tick}")
            check(stats["peak_buffered_bytes"]
                  <= stats["peak_input_bound_bytes"],
                  f"[stream] (a) chunk {chunk}: {stats}")
            need(same_replay(got, one, bounded=True), f"(a) chunk {chunk}")
            runs[f"a/{chunk}"] = out
            say("stream", case="a", chunk=chunk, accesses=STREAM_N,
                equal_to_oneshot="sum_latency_ticks,end_tick,elapsed_ticks",
                oracle="equal", launches=out["launches"],
                kernel_ms=f"{out['kernel_ms']:.3f}",
                wall_s=f"{out['wall_s']:.3f}", host_s=f"{out['host_s']:.3f}",
                peak_device_bytes=out["peak_bytes"],
                stats=json.dumps(stats, separators=(",", ":")))

        # (b) the main path's trace through Table I's cached CXL-SSD
        n = len(trace)
        table1 = scan["table1"]
        one, out = stream_run(torch, lambda: ReplayEngine(
            make_device("cxl-ssd-cache"), metrics=spec).run(trace))
        launches_are(out, 1, 1, "(b) one-shot")
        need(same_replay(one, table1), "(b) one-shot")
        runs["b/oneshot"] = out
        say("stream", case="b", chunk="one-shot", accesses=n,
            launches=out["launches"], kernel_ms=f"{out['kernel_ms']:.3f}",
            wall_s=f"{out['wall_s']:.3f}", host_s=f"{out['host_s']:.3f}",
            peak_device_bytes=out["peak_bytes"])
        a, w, _ = trace_to_arrays(trace)
        store = TraceStore.write(Path(tmp.name) / "b.store", a, w)
        for chunk, lat in [(c, True) for c in STREAM_MAIN_CHUNKS] + [
                (STREAM_MAIN_CHUNKS[-1], False)]:
            got, out = stream_run(torch, lambda: replay_stream(
                store, make_device("cxl-ssd-cache"), chunk_size=chunk,
                metrics=spec, return_latencies=lat))
            launches_are(out, n, chunk, f"(b) chunk {chunk}")
            fields = need(same_replay(got, one, bounded=not lat),
                          f"(b) chunk {chunk}")
            if lat:
                need(same_replay(got, table1),
                     f"(b) chunk {chunk} against the [scan] one-shot")
            key = f"b/{chunk}" + ("" if lat else "/bounded")
            runs[key] = out
            say("stream", case="b", chunk=chunk, latencies=lat, accesses=n,
                equal_to_oneshot=fields, launches=out["launches"],
                kernel_ms=f"{out['kernel_ms']:.3f}",
                kernel_vs_oneshot=f"{out['kernel_ms'] / runs['b/oneshot']['kernel_ms']:.4f}",
                wall_s=f"{out['wall_s']:.3f}", host_s=f"{out['host_s']:.3f}",
                host_us_per_launch=f"{(out['wall_s'] - runs['b/oneshot']['wall_s']) * 1e6 / out['launches']:.1f}",
                peak_device_bytes=out["peak_bytes"])

        # (c) a crash and its resume, under NAND faults
        def nand():
            dev = make_device("cxl-ssd-cache")
            install(FaultPlan(FaultConfig(**FAULT_NAND),
                              seed=FAULT_NAND_SEED), [dev])
            return dev

        c = STREAM_CRASH
        a, w, _ = trace_to_arrays(trace[:c["accesses"]])
        store = TraceStore.write(Path(tmp.name) / "c.store", a, w)
        ck = str(Path(tmp.name) / "c.ckpt")
        whole, _ = stream_run(torch, lambda: replay_stream(
            store, nand(), chunk_size=c["chunk"], metrics=spec),
            profile=False)
        crashed = refuses(lambda: replay_stream(
            Crashy(store, c["die_after"]), nand(), chunk_size=c["chunk"],
            metrics=spec, checkpoint_dir=ck, checkpoint_every=c["every"]),
            RuntimeError)
        check(crashed, "[stream] (c) the crashing run did not crash")
        stats = {}
        got, out = stream_run(torch, lambda: replay_stream(
            store, nand(), chunk_size=c["chunk"], metrics=spec,
            checkpoint_dir=ck, resume=True, stats=stats), profile=False)
        resumed = c["die_after"] // c["every"] * c["every"] * c["chunk"]
        check(stats["resumed_from"] == resumed,
              f"[stream] (c) resumed from {stats['resumed_from']}")
        launches_are(out, c["accesses"] - resumed, c["chunk"], "(c) resume")
        fields = need(same_replay(got, whole), "(c) resumed")
        check(whole.poison_flags.any() and whole.metrics.faults[
            "nand_read_retries"] > 0, "[stream] (c) no NAND fault fired")
        runs["c/resume"] = out
        say("stream", case="c", accesses=c["accesses"], chunk=c["chunk"],
            crashed_after_chunks=c["die_after"],
            resumed_from=stats["resumed_from"], equal_to_uninterrupted=fields,
            launches=out["launches"], wall_s=f"{out['wall_s']:.3f}",
            stats=json.dumps(stats, separators=(",", ":")))

        # (d) transport faults, seams inside the down window
        d = STREAM_LINK

        def link():
            mount = Fabric.build("spine_leaf", **FAULT_FABRIC).mount(
                "h0", "d0", make_device("cxl-ssd-cache"))
            install(FaultPlan(FaultConfig(
                link_retry_rate=FAULT_LINK["link_retry_rate"],
                down_links=(("s0", "sp0") + d["window"],)),
                seed=FAULT_LINK_SEED), [mount])
            return mount

        part = trace[:d["accesses"]]
        one, _ = stream_run(torch, lambda: ReplayEngine(
            link(), metrics=spec).run(part), profile=False)
        a, w, _ = trace_to_arrays(part)
        store = TraceStore.write(Path(tmp.name) / "d.store", a, w)
        got, out = stream_run(torch, lambda: replay_stream(
            store, link(), chunk_size=d["chunk"], metrics=spec),
            profile=False)
        launches_are(out, d["accesses"], d["chunk"], "(d)")
        fields = need(same_replay(got, one), "(d)")
        f = got.metrics.faults
        check(f["degraded_accesses"] > 0 and f["link_retries"] > 0,
              f"[stream] (d) the window degraded nothing: {f}")
        seams = [k * d["chunk"] for k in range(1, d["accesses"] // d["chunk"]
                                               + 1)]
        inside = sum(d["window"][0] < x < d["window"][1] for x in seams)
        runs[f"d/{d['chunk']}"] = out
        say("stream", case="d", accesses=d["accesses"], chunk=d["chunk"],
            window=f"{d['window'][0]}-{d['window'][1]}",
            seams_in_window=inside, equal_to_oneshot=fields,
            launches=out["launches"], wall_s=f"{out['wall_s']:.3f}",
            faults=json.dumps(f, separators=(",", ":")))

        # (e) the multi-host replay
        e = STREAM_MULTI
        make, traces = multi_cases(seed, e["per_host"])["table1x4"]
        steps = sum(len(t) for t in traces)
        (one, lat0), out = stream_run(torch, lambda: MultiHostReplay(
            make(), metrics=spec).run_recorded(traces))
        launches_are(out, 1, 1, "(e) one-shot")
        runs["e/oneshot"] = out
        say("stream", case="e", chunk="one-shot", steps=steps,
            launches=out["launches"], kernel_ms=f"{out['kernel_ms']:.3f}",
            wall_s=f"{out['wall_s']:.3f}")
        want = json.dumps(one.metrics.to_jsonable(), sort_keys=True)
        for lat in (True, False):
            def run():
                eng = MultiHostReplay(make(), metrics=spec)
                if lat:
                    return eng.run_recorded(traces, chunk_size=e["chunk"])
                return eng.run(traces, chunk_size=e["chunk"],
                               return_latencies=False), None

            (got, lat1), out = stream_run(torch, run)
            launches_are(out, steps, e["chunk"], f"(e) latencies={lat}")
            same = {"ticks": got.elapsed_ticks == one.elapsed_ticks and all(
                (g.accesses, g.sum_latency_ticks, g.end_tick,
                 g.elapsed_ticks) == (w_.accesses, w_.sum_latency_ticks,
                                      w_.end_tick, w_.elapsed_ticks)
                for g, w_ in zip(got.per_host, one.per_host)),
                "metrics": json.dumps(got.metrics.to_jsonable(),
                                      sort_keys=True) == want}
            if lat:
                same["latency"] = all(np.array_equal(x, y)
                                      for x, y in zip(lat1, lat0))
            fields = need(same, f"(e) latencies={lat}")
            runs[f"e/{e['chunk']}" + ("" if lat else "/bounded")] = out
            say("stream", case="e", chunk=e["chunk"], latencies=lat,
                steps=steps, equal_to_oneshot=fields,
                launches=out["launches"], kernel_ms=f"{out['kernel_ms']:.3f}",
                wall_s=f"{out['wall_s']:.3f}", host_s=f"{out['host_s']:.3f}")
    say("stream", cases=5, equal="every field",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return runs


def scan_row(scan: dict, faults: dict, multi: dict, n: int,
             stream: dict, sweeps: dict | None = None) -> dict:
    """The kernels line's ``replay_scan`` row: the Table I cached CXL-SSD's
    numbers, with every device's, the faulted replays', the multi-host
    replays', the streamed ones' and the sweeps' beside them."""
    sweeps = sweeps or {}
    main = "cxl-ssd-cache"
    b_ms, b_by = scan["bound"][main]
    return {
        "name": "replay_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES,
        "launches": sum(scan["launches"].values())
        + sum(run["launches"] for run in faults.values())
        + sum(run["launches"] for run in multi.values())
        + sum(run["launches"] for run in stream.values())
        + sum(run["launches"] for run in sweeps.values()),
        "max_abs_err": 0, "tolerance": 0,
        "ms": scan["kernel_ms"][main], "plain_ms": scan["plain_ms"][main],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "accesses": n, "plain_accesses": SCAN_TWIN_ACCESSES,
        "device": main,
        "ms_by_device": scan["kernel_ms"],
        "bound_ms_by_device": {d: v[0] for d, v in scan["bound"].items()},
        "serial_chain_ms_by_device": scan["serial"],
        "plain_ms_by_device": scan["plain_ms"],
        "launches_by_device": scan["launches"],
        "faulted": {name: {k: run[k] for k in (
            "launches", "ms", "accesses", "bytes_per_access", "bound_ms",
            "bound_by", "serial_chain_ms", "reads", "column_s")}
            for name, run in faults.items()},
        "multihost": {name: {k: run[k] for k in (
            "launches", "ms", "hosts", "accesses", "bytes_per_step",
            "bound_ms", "bound_by", "serial_chain_ms", "wall_s",
            "column_s") + (("plain_ms",) if "plain_ms" in run else ())}
            for name, run in multi.items()},
        "multihost_replaces": MULTI_REPLACES,
        "resumable": True,
        "streamed": {name: {k: run[k] for k in (
            "launches", "kernel_ms", "wall_s", "host_s", "peak_bytes")
            if k in run} for name, run in stream.items()},
        "sweeps": {name: {k: run[k] for k in (
            "launches", "lanes", "waves", "ms", "wall_s", "standalone_ms",
            "serial_ms", "bound_ms", "column_s")}
            for name, run in sweeps.items()},
        "sweep_kernels": [SWEEP_KERNEL, MULTI_SWEEP_KERNEL],
        "sweep_replaces": SWEEP_REPLACES,
    }


def python_lane(target, trace):
    """The python lane over ``target`` with a metrics tap and a
    :class:`FlagTap` over it: ``(result, bundle, tap)``."""
    from repro_torch.core.replay import metrics as M
    from repro_torch.core.workloads.driver import MultiHostDriver

    spec = M.MetricsSpec()
    metric_tap = M.attach_taps([target])[0]
    tap = FlagTap(metric_tap)
    res = MultiHostDriver([tap], outstanding=32).run([trace]).per_host[0]
    bundle = M.collect_python(spec, [target], [metric_tap],
                              poisoned=sum(tap.poison))
    return res, bundle, tap


def faulted_replay(torch, name, make, trace) -> dict:
    """One faulted replay through ``engine="scan"`` on the card (one
    launch), held access for access against the python lane on this host:
    latencies, hit, dirty-evict and poison flags, elapsed and end ticks,
    GC runs, the fault counters and the metrics bundle, and under
    transport faults the availability series.  Returns its numbers."""
    from repro_torch.core.replay import metrics as M
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.engine import ReplayEngine
    from repro_torch.kernels import replay_scan as rs

    rs.reset_launches()
    eng = ReplayEngine(make(), metrics=M.MetricsSpec())
    t0 = time.perf_counter()
    res = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rs.LAUNCHES["replay_scan"]
    check(launches == 1, f"{name}: {launches} replay_scan launches")
    t0 = time.perf_counter()
    want, bundle, tap = python_lane(make(), trace)
    py_wall = time.perf_counter() - t0
    same = {
        "latency": np.array_equal(res.latency_ticks,
                                  np.asarray(tap.latency, np.int64)),
        "hit": np.array_equal(res.hit_flags, np.asarray(tap.hit)),
        "evict": np.array_equal(res.evict_flags, np.asarray(tap.evict)),
        "poison": np.array_equal(
            res.poison_flags if res.poison_flags is not None
            else np.zeros(len(trace), bool), np.asarray(tap.poison)),
        "ticks": all(getattr(res, f) == getattr(want, f) for f in (
            "elapsed_ticks", "end_tick", "sum_latency_ticks")),
        "gc_runs": res.gc_runs == bundle.flash[0]["gc_runs"]
        if bundle.flash else res.gc_runs == 0,
        "metrics": (json.loads(json.dumps(res.metrics.to_jsonable()))
                    == json.loads(json.dumps(bundle.to_jsonable()))),
    }
    if res.availability is not None:
        avail = M.availability_series(
            np.asarray(tap.issue, np.int64),
            np.asarray(tap.issue, np.int64) + np.asarray(tap.latency,
                                                        np.int64),
            np.asarray(tap.degraded), np.asarray(tap.failover),
            spec=M.MetricsSpec())
        same["availability"] = (json.loads(json.dumps(res.availability))
                                == json.loads(json.dumps(avail)))
    for field, ok in same.items():
        check(ok, f"{name}: scan {field} differs from the python lane")
    faults = res.metrics.faults
    # the kernel alone, by the profiler, on the same inputs
    cfg, params, *inputs = scan_inputs(torch, make, trace)
    a, w, r, rt = (None if x is None else x.cuda() for x in inputs)
    state = {}

    def run():
        state["s"] = stack.init_state(cfg, "cuda")
        rs.replay_scan(cfg, params, state["s"], a, w, r, retries=rt)

    acts = [e for e in device_events(
        torch, run, lambda acts: any(SCAN_KERNEL in e.name for e in acts))
        if SCAN_KERNEL in e.name]
    if acts:
        ms, how = acts[0].device_time_total / 1e3, "profiler"
    else:
        EVENT_TIMED.append(f"{SCAN_KERNEL} ({name})")
        ms, how = cuda_ms(torch, run), "CUDA events"
    flash = state["s"]["flash"] or {}
    reads = int(flash.get("rd_seq", 0))
    out = {"launches": launches, "ms": ms, "timing": how, "wall_s": wall,
           "python_wall_s": py_wall,
           "column_s": eng.last_column_seconds, "faults": dict(faults),
           "reads": reads, "gc_runs": res.gc_runs, "cfg": cfg,
           "accesses": len(trace)}
    say("faults", case=name, accesses=len(trace), equal_to_python=",".join(
        same), launches=launches, kernel_ms=f"{ms:.3f}", timing=how,
        driver_wall_s=f"{wall:.3f}", python_wall_s=f"{py_wall:.3f}",
        column_builder_s=f"{eng.last_column_seconds:.3f}",
        flash_reads=reads, gc_runs=res.gc_runs,
        faults=json.dumps(faults, separators=(",", ":")))
    return out


def fault_bound(run: dict, int32_ops_per_s: float, smem_cycles: float,
                sm_clock_mhz: float) -> dict:
    """The faulted replay's bytes an access, roofline bound and
    serial-chain model, from this run's inputs: the fault-free terms of
    its kind, plus the path code's bytes and each hop's round trip and
    operations under transport faults, plus the NAND decision of each of
    this run's flash reads."""
    cfg, n, reads = run["cfg"], run["accesses"], run["reads"]
    io = SCAN_IO_BYTES + (FAULT_PATH_BYTES + cfg.num_hops
                          if cfg.fault_hops else 0)
    hop_ops = FAULT_HOP_OPS * cfg.num_hops if cfg.fault_hops else 0
    nand_ops = NAND_HASH_STEPS * reads if cfg.faults else 0
    ops = n * (SCAN_OPS[cfg.kind] + hop_ops) + nand_ops
    state = 2 * 4 * cfg.num_pages + 2 * 8 * cfg.cache_frames
    b_ms, b_by = bound_ms(n, 2 * ops / n, io, state, int32_ops_per_s)
    trips = n * (SCAN_ROUND_TRIPS[cfg.kind] + SCAN_HOP_TRIPS * cfg.num_hops
                 + (FAULT_HOP_TRIPS * cfg.num_hops if cfg.fault_hops else 0))
    cycles = trips * smem_cycles + (
        reads * NAND_HASH_STEPS * ALU_STEP_CYCLES if cfg.faults else 0)
    return {"bytes_per_access": io, "bound_ms": b_ms, "bound_by": b_by,
            "serial_chain_ms": cycles / (sm_clock_mhz * 1e3),
            "int64_ops": ops}


def faults_phase(torch, trace, smem_cycles: float, sm_clock_mhz: float,
                 int32_ops_per_s: float) -> dict:
    """[faults]: the faulted scan lane on the card, each replay equal to
    the python lane; the kernel against its twin on the golden fault
    scenarios and the GC trace."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import (FAULT_SCENARIOS, make_target,
                                 scenario_outstanding, scenario_trace)

    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.workloads.traces import make_trace

    def nand():
        dev = make_device("cxl-ssd-cache")
        install(FaultPlan(FaultConfig(**FAULT_NAND), seed=FAULT_NAND_SEED),
                [dev])
        return dev

    def link():
        mount = Fabric.build("spine_leaf", **FAULT_FABRIC).mount(
            "h0", "d0", make_device("cxl-ssd-cache"))
        install(FaultPlan(FaultConfig(**FAULT_LINK), seed=FAULT_LINK_SEED),
                [mount])
        return mount

    gc_trace = make_trace(FAULT_GC_TRACE["seed"], n=FAULT_GC_TRACE["n"],
                          pages=FAULT_GC_TRACE["pages"])
    runs = {
        "nand": faulted_replay(torch, "nand", nand, trace),
        "gc": faulted_replay(torch, "gc",
                             lambda: make_target(FAULT_GC_SCENARIO),
                             gc_trace),
        "link": faulted_replay(torch, "link", link,
                               trace[:FAULT_LINK_ACCESSES]),
    }
    f = {k: v["faults"] for k, v in runs.items()}
    check(f["nand"]["nand_read_retries"] > 0
          and f["nand"]["poisoned_reads"] > 0,
          f"Table I under NAND faults: {f['nand']}")
    check(f["gc"]["retired_blocks"] >= 1 and runs["gc"]["gc_runs"] > 0,
          f"the GC trace retired no block: {f['gc']}")
    check(all(f["link"][k] > 0 for k in ("link_retries",
                                         "degraded_accesses", "failovers")),
          f"the fabric mount under transport faults: {f['link']}")
    for name, run in runs.items():
        run.update(fault_bound(run, int32_ops_per_s, smem_cycles,
                               sm_clock_mhz))
        say("faults", case=name, bytes_per_access=run["bytes_per_access"],
            bound_ms=f"{run['bound_ms']:.6f}", bound_by=run["bound_by"],
            serial_chain_ms=f"{run['serial_chain_ms']:.3f}")

    # the kernel against its plain twin: the golden fault scenarios (their
    # pins and metrics on the card too) and the GC trace
    mismatches = 0
    for name in FAULT_SCENARIOS:
        from repro_torch.core.replay.metrics import MetricsSpec
        from repro_torch.core.workloads.driver import TraceDriver

        res = TraceDriver(make_target(name),
                          outstanding=scenario_outstanding(name),
                          engine="scan", metrics=MetricsSpec()).run(
            scenario_trace(name))
        pin = golden_pin(name, "python_scan")
        check(res.latency_ticks.tolist() == pin["latency_ticks"]
              and all(getattr(res, k) == pin[k] for k in (
                  "elapsed_ticks", "sum_latency_ticks", "end_tick")),
              f"fault pin {name} on the card")
        check(json.loads(json.dumps(res.metrics.to_jsonable()))
              == golden_pin(name, "metrics"), f"fault metrics {name}")
        bad, _, _ = scan_against_twin(
            torch, lambda: make_target(name), scenario_trace(name),
            scenario_outstanding(name))
        mismatches += bad
    bad, gc_plain_ms, _ = scan_against_twin(
        torch, lambda: make_target(FAULT_GC_SCENARIO), gc_trace, 32)
    mismatches += bad
    check(mismatches == 0, f"replay_scan under faults differs from its "
                           f"twin in {mismatches} elements")
    say("faults", pins=len(FAULT_SCENARIOS), python_scan="equal",
        metrics="equal", twin_checks=len(FAULT_SCENARIOS) + 1, mismatches=0,
        gc_twin_ms=f"{gc_plain_ms:.3f}")
    return runs


def assoc_phase(torch, trace, scan: dict) -> dict:
    """[assoc]: ``engine="assoc"`` on the card over the main path's trace
    for dram, cxl-dram and pmem, each equal to the [scan] phase's python
    lane or refused where the JAX package's numpy backend refuses; its
    walls, sweeps and device time by kind; the golden assoc pins."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import (make_target, scenario_outstanding,
                                 scenario_trace)

    from repro_torch.core.devices import make_device
    from repro_torch.core.replay.assoc import AssocReplayEngine
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.core.workloads.driver import TraceDriver

    out = {}
    for d, certifies in ASSOC_DEVICES.items():
        t0 = time.perf_counter()
        try:
            res = TraceDriver(make_device(d), engine="assoc").run(trace)
            refused = None
        except ReplayUnsupported as e:
            res, refused = None, str(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check((refused is None) == certifies,
              f"assoc {d}: {'refused: ' + refused if refused else 'certified'}"
              f", the reference {'certifies' if certifies else 'refuses'}")
        fields = {}
        if res is not None:
            lat, want = scan["python"][d]
            check(np.array_equal(res.latency_ticks, lat)
                  and all(getattr(res, f) == getattr(want, f) for f in (
                      "elapsed_ticks", "end_tick", "sum_latency_ticks")),
                  f"assoc {d} differs from the python lane")
            eng = AssocReplayEngine(make_device(d))
            acts = device_events(torch, lambda: eng.run(trace),
                                 lambda acts: len(acts) > 0)
            kinds = {}
            for e in acts:
                k = e.name.split("<")[0].split("(")[0].strip()[:48]
                kinds[k] = kinds.get(k, 0.0) + e.device_time_total / 1e3
            top = dict(sorted(kinds.items(), key=lambda kv: -kv[1])[:6])
            fields = dict(sweeps=eng._last_sweeps,
                          device_ms=f"{sum(kinds.values()):.3f}",
                          device_ms_by_kind=json.dumps(
                              {k: round(v, 3) for k, v in top.items()},
                              separators=(",", ":")),
                          equal_to_python="all fields")
            out[d] = {"wall_s": wall, "sweeps": eng._last_sweeps,
                      "device_ms": sum(kinds.values())}
        else:
            fields = dict(refused=repr(refused[:60]))
            out[d] = {"wall_s": wall, "refused": refused}
        say("assoc", device=d, accesses=len(trace),
            outcome="certified" if refused is None else "refused",
            wall_s=f"{wall:.3f}", **fields)
    pins = [f"{d}@{a}" for d in ASSOC_DEVICES
            for a in ("direct", "fabric", "stream")
            if (d, a) != ("cxl-dram", "stream")]
    for name in pins:
        res = AssocReplayEngine(make_target(name),
                                outstanding=scenario_outstanding(name),
                                max_sweeps=ASSOC_SWEEPS).run(
            scenario_trace(name))
        pin = golden_pin(name, "python_scan")
        check(res.latency_ticks.tolist() == pin["latency_ticks"]
              and all(getattr(res, f) == pin[f] for f in (
                  "elapsed_ticks", "sum_latency_ticks", "end_tick")),
              f"assoc pin {name} on the card")
    say("assoc", pins=len(pins), python_scan="equal")
    return out


def multi_inputs(torch, prep, dev):
    """``(addrs, writes, lens, devs, routes)`` and the retry bytes of a
    prepared multi-host replay as tensors on ``dev`` (None where the
    replay has none)."""
    def t(x):
        return None if x is None else torch.from_numpy(x).to(dev)

    return ([t(x) for x in (prep.addrs, prep.writes, prep.lens, prep.devs,
                            prep.routes)], t(prep.retries))


def multi_python_lane(targets, traces):
    """The python lane over ``targets`` with metrics taps and a
    :class:`FlagTap` a host: ``(result, bundle, taps)``."""
    from repro_torch.core.replay import metrics as M
    from repro_torch.core.workloads.driver import MultiHostDriver

    metric_taps = M.attach_taps(targets)
    taps = [FlagTap(t, host=i) for i, t in enumerate(metric_taps)]
    res = MultiHostDriver(taps, outstanding=32).run(traces)
    bundle = M.collect_python(M.MetricsSpec(), targets, metric_taps,
                              poisoned=sum(sum(t.poison) for t in taps))
    return res, bundle, taps


def multi_same(res, want, bundle, taps) -> dict:
    """Whether a multi-host replay equals the python lane field by field:
    each host's latencies, hit, dirty-evict and poison flags, elapsed,
    end and latency-sum ticks, the cluster span, GC runs, the metrics
    bundle (fault counters included) and, under transport faults, each
    host's availability series."""
    from repro_torch.core.replay import metrics as M

    hosts = list(zip(res.per_host, want.per_host, taps))

    def flags(r, t, name):
        got = getattr(r, name + "_flags")
        if got is None:
            got = np.zeros(r.accesses, bool)
        return np.array_equal(got, np.asarray(getattr(t, name), bool))

    same = {
        "latency": all(np.array_equal(r.latency_ticks,
                                      np.asarray(t.latency, np.int64))
                       for r, _, t in hosts),
        "hit": all(flags(r, t, "hit") for r, _, t in hosts),
        "evict": all(flags(r, t, "evict") for r, _, t in hosts),
        "poison": all(flags(r, t, "poison") for r, _, t in hosts),
        "ticks": res.elapsed_ticks == want.elapsed_ticks and all(
            getattr(r, f) == getattr(w, f) for r, w, _ in hosts
            for f in ("accesses", "elapsed_ticks", "end_tick",
                      "sum_latency_ticks")),
        "gc_runs": res.per_host[0].gc_runs == sum(
            f["gc_runs"] for f in bundle.flash),
        "metrics": (json.loads(json.dumps(res.metrics.to_jsonable()))
                    == json.loads(json.dumps(bundle.to_jsonable()))),
    }
    if res.per_host[0].availability is not None:
        same["availability"] = all(
            json.loads(json.dumps(r.availability)) == json.loads(json.dumps(
                M.availability_series(
                    np.asarray(t.issue, np.int64),
                    np.asarray(t.issue, np.int64)
                    + np.asarray(t.latency, np.int64),
                    np.asarray(t.degraded), np.asarray(t.failover),
                    spec=M.MetricsSpec())))
            for r, _, t in hosts)
    return same


def multi_kernel_run(torch, prep) -> tuple[float, str, np.ndarray]:
    """Device milliseconds of one multi-host ``replay_scan`` launch on the
    prepared inputs, how they were timed, and the run's per-step hosts."""
    from repro_torch.core.replay import stack
    from repro_torch.kernels import replay_scan as rs

    cfg = prep.cfg
    ins, rt = multi_inputs(torch, prep, "cuda")
    out = {}

    def run():
        out["who"] = rs.replay_multi(
            cfg, prep.params, stack.init_lanes(cfg.stack, cfg.num_devs,
                                               cfg.n_flash, "cuda"),
            *ins, retries=rt)[0]

    acts = [e for e in device_events(
        torch, run, lambda acts: any(MULTI_KERNEL in e.name for e in acts))
        if MULTI_KERNEL in e.name]
    if acts:
        ms, how = acts[0].device_time_total / 1e3, "profiler"
    else:
        EVENT_TIMED.append(MULTI_KERNEL)
        say("timing", fallback="CUDA events", what=MULTI_KERNEL,
            reason=f"the profiler recorded no device activity in "
                   f"{PROFILE_TRIES} sessions")
        ms, how = cuda_ms(torch, run), "CUDA events"
    return ms, how, out["who"].cpu().numpy()


def multi_bound(torch, prep, who, reads: int, int32_ops_per_s: float,
                smem_cycles: float, sm_clock_mhz: float) -> dict:
    """A multi-host replay's bytes a step, roofline bound and serial-chain
    model from this run's inputs and hosts: the single-host terms of its
    kind, plus the race over the hosts, the step's bookkeeping, each lane
    switch the run made, each weighted hop's QoS mirror, a faulted run's
    retry bytes and hop terms, and its NAND decisions."""
    from repro_torch.core.replay.multihost import step_ordinals
    from repro_torch.kernels import replay_scan as rs

    cfg, n, H = prep.cfg, int(prep.lens.sum()), prep.cfg.num_hosts
    ords = step_ordinals(who, H)
    rows = rs.multi_rows(cfg, torch.from_numpy(prep.devs), None
                         if prep.routes is None else torch.from_numpy(
                             prep.routes)).numpy()[who, ords]
    tab = rs.multi_tables(cfg, prep.params)
    real = (tab["port"] >= 0)
    hops = int(real.sum(1)[rows].sum())
    qos_on = (np.asarray(prep.params["qos_on"]) if cfg.qos
              else np.zeros(cfg.num_ports, bool))
    weighted = int((real & qos_on[np.maximum(tab["port"], 0)]).sum(1)[
        rows].sum())
    lanes = tab["dev"][rows]
    switches = int((lanes[1:] != lanes[:-1]).sum()) + 1
    io = MULTI_IO_BYTES + (MULTI_FAULT_BYTES if cfg.fault_hops else 0)
    kind = cfg.stack.kind
    ops = (n * (SCAN_OPS[kind] + 2 * H + MULTI_STEP_OPS)
           + switches * MULTI_LANE_OPS
           + weighted * (2 * H + MULTI_QOS_OPS)
           + (hops * FAULT_HOP_OPS if cfg.fault_hops else 0)
           + (NAND_HASH_STEPS * reads if cfg.stack.faults else 0))
    state = cfg.num_devs * (2 * 4 * cfg.stack.num_pages
                            + 2 * 8 * cfg.stack.cache_frames)
    b_ms, b_by = bound_ms(n, 2 * ops / n, io, state, int32_ops_per_s)
    trips = (n * (MULTI_STEP_TRIPS + SCAN_ROUND_TRIPS[kind])
             + SCAN_HOP_TRIPS * hops + MULTI_QOS_TRIPS * weighted
             + (FAULT_HOP_TRIPS * hops if cfg.fault_hops else 0))
    cycles = trips * smem_cycles + (
        reads * NAND_HASH_STEPS * ALU_STEP_CYCLES if cfg.stack.faults else 0)
    return {"bytes_per_step": io, "bound_ms": b_ms, "bound_by": b_by,
            "serial_chain_ms": cycles / (sm_clock_mhz * 1e3),
            "lane_switches": switches, "weighted_hops": weighted,
            "int64_ops": ops}


def multi_against_twin(torch, targets, traces, outstanding, placed=True):
    """The multi-host instance on the card against its plain twin on CPU
    tensors of this process, from fresh lanes, in the shared-memory layout
    (``placed``) or the device-memory one: the elements that differ over
    every output and every final state tensor, and the twin's wall
    milliseconds."""
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    prep = MultiHostReplay(targets, outstanding=outstanding,
                           metrics=MetricsSpec()).prepare(traces)
    cfg = prep.cfg
    cpu_ins, cpu_rt = multi_inputs(torch, prep, "cpu")
    ins, rt = multi_inputs(torch, prep, "cuda")
    cpu = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cpu")
    card = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, "cuda")
    t0 = time.perf_counter()
    want = rs.replay_multi(cfg, prep.params, cpu, *cpu_ins, retries=cpu_rt)
    plain_ms = (time.perf_counter() - t0) * 1e3
    lib = _build.library("replay_scan")
    lay = rs.layout_multi(cfg, prep.params, rs._smem_optin(lib, 0),
                          placed=placed)
    err, got = rs.call_launch_multi(
        lib, cfg, prep.params, card, *ins, 0, lay,
        torch.cuda.current_stream().cuda_stream, retries=rt)
    check(err == 0, f"replay_scan (multi-host) launch failed: {err}")
    torch.cuda.synchronize()
    pairs = list(zip(got, want))
    for part in ("media", "flash"):
        pairs += [(card[part][k], x) for k, x in (cpu[part] or {}).items()]
    return sum(int((g.cpu() != x).sum()) for g, x in pairs), plain_ms


def multi_cases(seed: int, per_host: int) -> dict:
    """The [multihost] phase's replays, ``{name: (make_targets,
    traces)}``, at ``per_host`` accesses a host of the full-width one:
    ``table1x4`` (the full-width path), ``qos-pool`` (as many accesses in
    all over three hosts) and ``down`` (two hosts, the down window scaled
    to their length).  Traces are the main path's kind, host i from seed
    ``seed + i``."""
    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric, MemoryPool
    from repro_torch.core.faults import FaultConfig, FaultPlan, install
    from repro_torch.core.workloads.traces import make_trace

    def table1_mounts():
        fab = Fabric.build("two_level", num_hosts=MULTI_HOSTS,
                           num_devices=MULTI_HOSTS, **MULTI_FABRIC)
        return [fab.mount(f"h{i}", f"d{i}", make_device("cxl-ssd-cache"))
                for i in range(MULTI_HOSTS)]

    def qos_pool():
        fab = Fabric.build("spine_leaf", **MULTI_QOS)
        pool = MemoryPool(fab, {"d0": make_device("dram"),
                                "d1": make_device("dram")})
        return pool.views([f"h{i}" for i in range(MULTI_QOS["num_hosts"])])

    def down_mounts():
        fab = Fabric.build("spine_leaf", **MULTI_DOWN)
        tgts = [fab.mount(f"h{i}", f"d{i}", make_device("cxl-ssd-cache"))
                for i in range(MULTI_DOWN["num_hosts"])]
        u, v, lo, hi, of = MULTI_DOWN_WINDOW
        install(FaultPlan(FaultConfig(down_links=(
            (u, v, lo * per_host // of, hi * per_host // of),)),
            seed=MULTI_DOWN_SEED), tgts)
        return tgts

    def traces_of(lengths):
        return [make_trace(seed + i, n=n, pages=16384)
                for i, n in enumerate(lengths)]

    total = MULTI_HOSTS * per_host
    nq = MULTI_QOS["num_hosts"]
    return {
        "table1x4": (table1_mounts, traces_of([per_host] * MULTI_HOSTS)),
        "qos-pool": (qos_pool, traces_of([total // nq + (i < total % nq)
                                          for i in range(nq)])),
        "down": (down_mounts, traces_of([per_host]
                                        * MULTI_DOWN["num_hosts"])),
    }


def multihost_phase(torch, seed: int, smem_cycles: float,
                    sm_clock_mhz: float, int32_ops_per_s: float) -> dict:
    """[multihost]: the fused multi-host replay on the card, each replay
    one launch equal to the python lane on every field; the six golden
    multi-host pins and metrics; the kernel against its twin."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import make_multi_targets, multi_traces

    from repro_torch.core.replay.metrics import MetricsSpec
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.core.workloads.driver import MultiHostDriver
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    log = _build.build_log.get("replay_scan", "")
    say("multihost", kernel=MULTI_KERNEL,
        spill_bytes=ptxas_spills(log, MULTI_KERNEL))

    cases = multi_cases(seed, MULTI_PER_HOST)
    small = multi_cases(seed, MULTI_PYTHON_PER_HOST)
    runs = {}

    def replay(name, make, traces):
        eng = MultiHostReplay(make(), outstanding=32, metrics=MetricsSpec())
        if name == "down":
            return eng, eng.run(traces)
        # the entry point a user calls
        return eng, MultiHostDriver(eng.targets, outstanding=32,
                                    engine="scan",
                                    metrics=MetricsSpec()).run(traces)

    for name, (make, traces) in cases.items():
        rs.reset_launches()
        t0 = time.perf_counter()
        eng, res = replay(name, make, traces)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        column_s = eng.last_column_seconds
        launches = rs.LAUNCHES["replay_scan"]
        check(launches == 1, f"[multihost] {name}: {launches} launches")
        # the python lane, at the smaller depth
        s_make, s_traces = small[name]
        _, s_res = replay(name, s_make, s_traces)
        t0 = time.perf_counter()
        want, bundle, taps = multi_python_lane(s_make(), s_traces)
        py_wall = time.perf_counter() - t0
        same = multi_same(s_res, want, bundle, taps)
        for field, ok in same.items():
            check(ok, f"[multihost] {name}: {field} differs from the python "
                      "lane")
        prep = eng.prepare(traces)
        ms, how, who = multi_kernel_run(torch, prep)
        reads = sum(f["host_reads"] + f["gc_writes"]
                    for f in res.metrics.flash)
        run = {"launches": launches, "ms": ms, "timing": how,
               "wall_s": wall, "python_wall_s": py_wall,
               "column_s": column_s,
               "accesses": int(prep.lens.sum()),
               "hosts": prep.cfg.num_hosts, "gc_runs": res.per_host[0].gc_runs,
               "faults": dict(res.metrics.faults or {})}
        run.update(multi_bound(torch, prep, who, reads, int32_ops_per_s,
                               smem_cycles, sm_clock_mhz))
        runs[name] = run
        say("multihost", case=name, hosts=run["hosts"],
            accesses=run["accesses"], equal_to_python=",".join(same),
            python_accesses=sum(len(t) for t in s_traces),
            launches=launches, kernel_ms=f"{ms:.3f}", timing=how,
            ns_per_access=f"{ms * 1e6 / run['accesses']:.1f}",
            driver_wall_s=f"{wall:.3f}", host_s=f"{wall - ms / 1e3:.3f}",
            python_wall_s=f"{py_wall:.3f}",
            column_builder_s=f"{column_s:.3f}",
            hit_rate=f"{sum(r.hits for r in res.per_host) / run['accesses']:.6f}",
            gc_runs=run["gc_runs"], lane_switches=run["lane_switches"],
            weighted_hops=run["weighted_hops"],
            bytes_per_step=run["bytes_per_step"],
            bound_ms=f"{run['bound_ms']:.6f}", bound_by=run["bound_by"],
            serial_chain_ms=f"{run['serial_chain_ms']:.3f}",
            faults=json.dumps(run["faults"], separators=(",", ":")))
    f = runs["down"]["faults"]
    check(f.get("degraded_accesses", 0) > 0 and f.get("failovers", 0) > 0,
          f"the down window degraded nothing: {f}")
    check(runs["table1x4"]["accesses"] == MULTI_HOSTS * MULTI_PER_HOST,
          "the full-width replay's length")

    # the golden multi-host pins and metrics blocks on the card
    for name in MULTI_SCENARIOS:
        res = MultiHostDriver(make_multi_targets(name), outstanding=8,
                              engine="scan", metrics=MetricsSpec()).run(
            multi_traces(name))
        pins = golden_pin(name, "python_scan")
        check(len(pins) == len(res.per_host) and all(
            r.latency_ticks.tolist() == p["latency_ticks"]
            and all(getattr(r, k) == p[k] for k in (
                "elapsed_ticks", "sum_latency_ticks", "end_tick"))
            for r, p in zip(res.per_host, pins)),
            f"multi-host pin {name} on the card")
        check(json.loads(json.dumps(res.metrics.to_jsonable()))
              == golden_pin(name, "metrics"), f"multi-host metrics {name}")
    say("multihost", pins=len(MULTI_SCENARIOS), python_scan="equal",
        metrics="equal")

    # the kernel against its twin: the pins' scenarios in both layouts,
    # then the full-width targets over their traces' first accesses
    mismatches = 0
    for name in MULTI_SCENARIOS:
        for placed in (True, False):
            bad, _ = multi_against_twin(torch, make_multi_targets(name),
                                        multi_traces(name), 8, placed)
            mismatches += bad
    make, traces = cases["table1x4"]
    bad, plain_ms = multi_against_twin(
        torch, make(), [t[:MULTI_TWIN_PER_HOST] for t in traces], 32)
    mismatches += bad
    check(mismatches == 0, f"the multi-host instance differs from its twin "
                           f"in {mismatches} elements")
    say("multihost", twin_checks=2 * len(MULTI_SCENARIOS) + 1, mismatches=0,
        twin_accesses=MULTI_HOSTS * MULTI_TWIN_PER_HOST,
        twin_ms=f"{plain_ms:.3f}")
    runs["table1x4"]["plain_ms"] = plain_ms
    return runs


# ------------------------------------------------------------ the sweeps
def sweep_check_line(name: str, same: dict) -> str:
    """The ``[sweep]`` line of one lane check: its fields and those that
    differ."""
    differ = [k for k, ok in same.items() if not ok]
    return (f"[sweep] check={name} fields={','.join(same)} "
            f"differ={','.join(differ) or 'none'}")


def sweep_failures(lines) -> list:
    """The lane checks of :data:`SWEEP_CHECKS` that ``lines`` (the
    ``[sweep]`` lines of a run) miss, print twice, or print with a field
    that differs."""
    seen = {}
    for ln in lines:
        m = re.match(r"\[sweep\] check=(\S+) fields=(\S*) differ=(\S+)$",
                     ln.strip())
        if m:
            seen.setdefault(m.group(1), []).append(m.group(3))
    bad = []
    for name in SWEEP_CHECKS:
        got = seen.get(name, [])
        if len(got) != 1 or got[0] != "none":
            bad.append(f"{name}: {got or 'missing'}")
    return bad


def launch_ms(torch, run, kernel: str) -> tuple[float, str]:
    """Device milliseconds of the one launch of ``kernel`` that ``run()``
    makes, by the profiler (by CUDA events, host time included, where the
    profiler records none), and how it was timed."""
    acts = [e for e in device_events(
        torch, run, lambda a: any(kernel in e.name for e in a))
        if kernel in e.name]
    if acts:
        return sum(e.device_time_total for e in acts) / 1e3, "profiler"
    EVENT_TIMED.append(kernel)
    say("timing", fallback="CUDA events", what=kernel,
        reason=f"the profiler recorded no device activity in "
               f"{PROFILE_TRIES} sessions")
    return cuda_ms(torch, run), "CUDA events"


def sweep_down_targets(seed: int, per_host: int):
    """The [multihost] phase's two Table I mounts on the 2 x 2 spine-leaf
    with its down window scaled to ``per_host`` accesses, under CRC
    retries of fault seed ``seed``."""
    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.faults import FaultConfig, FaultPlan, install

    fab = Fabric.build("spine_leaf", **MULTI_DOWN)
    tgts = [fab.mount(f"h{i}", f"d{i}", make_device("cxl-ssd-cache"))
            for i in range(MULTI_DOWN["num_hosts"])]
    u, v, lo, hi, of = MULTI_DOWN_WINDOW
    install(FaultPlan(FaultConfig(down_links=(
        (u, v, lo * per_host // of, hi * per_host // of),), **SWEEP_LINK),
        seed=seed), tgts)
    return tgts


def sweep_phase(torch, trace, seed: int, scan: dict,
                smem_cycles: float, sm_clock_mhz: float,
                int32_ops_per_s: float) -> dict:
    """[sweep]: the design-space sweeps on the card, each one launch of
    ``replay_scan``'s sweep instances (one block a lane) through the
    entry point a user calls; checked lanes equal their standalone
    one-launch replays, the cache sweep its twin, the availability
    oracle reproduced, a GC overfill refused."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import (AVAIL_HOSTS, AVAIL_SEEDS, availability_case,
                                 availability_fields, gc_ssd_cfg)

    from repro_torch.core.cache.dram_cache import DRAMCacheConfig
    from repro_torch.core.devices import make_device
    from repro_torch.core.replay import stack
    from repro_torch.core.replay import sweep as sw
    from repro_torch.core.replay.multihost import MultiHostReplay
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.core.workloads.traces import make_trace
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = _build.build_log.get("replay_scan", "")
    say("sweep", kernels=f"{SWEEP_KERNEL},{MULTI_SWEEP_KERNEL}",
        spill_bytes=ptxas_spills(log, SWEEP_KERNEL)
        + ptxas_spills(log, MULTI_SWEEP_KERNEL), sms=sms)
    lines = []
    runs = {}

    def lane_check(name: str, same: dict) -> None:
        ln = sweep_check_line(name, same)
        print(ln, flush=True)
        lines.append(ln)

    def report(name, lanes, launches, ms, how, wall, alone_ms, bound,
               column_s=0.0):
        waves = -(-lanes // sms)
        serial = lanes * float(np.median(alone_ms))
        runs[name] = {"launches": launches, "lanes": lanes, "waves": waves,
                      "ms": ms, "timing": how, "wall_s": wall,
                      "standalone_ms": alone_ms, "serial_ms": serial,
                      "bound_ms": bound, "column_s": column_s}
        say("sweep", sweep=name, lanes=lanes, waves=waves,
            launches=launches, kernel_ms=f"{ms:.3f}", timing=how,
            wall_s=f"{wall:.3f}", host_s=f"{wall - ms / 1e3:.3f}",
            standalone_kernel_ms=",".join(f"{x:.3f}" for x in alone_ms),
            serial_ms=f"{serial:.3f}", serial_over_sweep=f"{serial / ms:.2f}",
            bound_ms=f"{bound:.6f}", column_builder_s=f"{column_s:.3f}")
        check(launches == 1, f"[sweep] {name}: {launches} launches")

    # (a) the cache sweep: Table I over the main path's trace, 128 lanes
    addrs = np.fromiter((a for a, _, _ in trace), np.int64, len(trace))
    wr = np.fromiter((w for _, _, w in trace), bool, len(trace))
    read_t = make_device("cxl-ssd-cache").hil.cfg.timing.read_ticks
    grid = [(c, lru, q) for c in SWEEP_CAPS for lru in (True, False)
            for q in SWEEP_READ_T]
    caps = [c for c, _, _ in grid]
    lrus = [lru for _, lru, _ in grid]
    over = {"read_t": [read_t * q // 4 for _, _, q in grid]}
    rs.reset_launches()
    t0 = time.perf_counter()
    out = sw.cache_design_sweep(make_device("cxl-ssd-cache"), addrs, wr,
                                capacity_frames=caps, is_lru=lrus,
                                timing_overrides=over)
    wall = time.perf_counter() - t0
    launches = rs.LAUNCHES["replay_scan"]
    cfg, lanes = sw.cache_lanes(make_device("cxl-ssd-cache"), addrs, wr,
                                capacity_frames=caps, is_lru=lrus,
                                timing_overrides=over)
    a, w = torch.from_numpy(addrs).cuda(), torch.from_numpy(wr).cuda()
    got = {}

    def run_sweep():
        got["state"] = stack.init_sweep(cfg, caps, "cuda")
        got["out"] = rs.replay_sweep(cfg, lanes, got["state"], a, w)

    ms, how = launch_ms(torch, run_sweep, SWEEP_KERNEL)
    issues, dones, flags = (x.cpu().numpy() for x in got["out"][:3])
    check(np.array_equal(out["latency_ticks"], dones - issues)
          and np.array_equal(out["hit_flags"], (flags & 1).astype(bool))
          and np.array_equal(out["evict_flags"], (flags & 2).astype(bool)),
          "[sweep] cache_design_sweep differs from its own launch")
    check(out["latency_ticks"].shape == (len(grid), len(trace))
          and bool((out["latency_ticks"] > 0).all()),
          "[sweep] cache sweep shapes and latencies")
    frames = got["state"]["media"]["frames"].cpu().numpy()
    fifo_min = grid.index((SWEEP_CAPS[0], False, 4))
    timing = grid.index((SWEEP_CAPS[-1], True, SWEEP_READ_T[-1]))
    alone_ms = []
    for name, k in (("first", 0), ("last", len(grid) - 1),
                    ("fifo-smallest", fifo_min), ("timing", timing)):
        one = dataclasses.replace(cfg, cache_frames=caps[k])
        st = {}

        def run_one():
            st["state"] = stack.init_state(one, "cuda")
            st["out"] = rs.replay_scan(one, lanes[k], st["state"], a, w)

        ms1, _ = launch_ms(torch, run_one, SCAN_KERNEL)
        alone_ms.append(ms1)
        i1, d1, f1 = (x.cpu().numpy() for x in st["out"][:3])
        lane_check(f"cache/{name}", {
            "latency": np.array_equal(d1 - i1, dones[k] - issues[k]),
            "flags": np.array_equal(f1, flags[k]),
            "frames": np.array_equal(st["state"]["media"]["frames"].cpu()
                                     .numpy(), frames[k, :caps[k]]),
            "disabled": bool((frames[k, caps[k]:] == stack.DISABLED).all())})
    # the twin, at 4096 accesses over 16 lanes
    n_twin = SWEEP_TWIN["accesses"]
    tgrid = [(c, lru, q) for c in SWEEP_TWIN["caps"] for lru in (True, False)
             for q in SWEEP_TWIN["read_t"]]
    tcfg, tlanes = sw.cache_lanes(
        make_device("cxl-ssd-cache"), addrs[:n_twin], wr[:n_twin],
        capacity_frames=[c for c, _, _ in tgrid],
        is_lru=[lru for _, lru, _ in tgrid],
        timing_overrides={"read_t": [read_t * q // 4 for _, _, q in tgrid]})
    tcaps = [c for c, _, _ in tgrid]
    cpu = stack.init_sweep(tcfg, tcaps)
    t0 = time.perf_counter()
    want = rs.replay_sweep(tcfg, tlanes, cpu, torch.from_numpy(
        addrs[:n_twin]), torch.from_numpy(wr[:n_twin]))
    twin_ms = (time.perf_counter() - t0) * 1e3
    card = stack.init_sweep(tcfg, tcaps, "cuda")
    have = rs.replay_sweep(tcfg, tlanes, card, a[:n_twin], w[:n_twin])
    same = {k: torch.equal(g.cpu(), x) for k, g, x in zip(
        ("issues", "dones", "flags", "qacc", "qthr"), have, want)}
    for part in ("media", "flash"):
        same[part] = all(torch.equal(card[part][k].cpu(), x)
                         for k, x in (cpu[part] or {}).items())
    lane_check("cache/twin", same)
    report("cache", len(grid), launches, ms, how, wall, alone_ms,
           scan["bound"]["cxl-ssd-cache"][0] * len(grid)
           / min(len(grid), sms))
    runs["cache"].update(twin_ms=twin_ms, twin_lanes=len(tgrid),
                         twin_accesses=n_twin,
                         hit_rate_min=float(out["hit_rate"].min()),
                         hit_rate_max=float(out["hit_rate"].max()))
    say("sweep", sweep="cache", twin_lanes=len(tgrid), twin_accesses=n_twin,
        twin_ms=f"{twin_ms:.3f}",
        hit_rate=f"{out['hit_rate'].min():.6f}-{out['hit_rate'].max():.6f}")

    # (b) host counts over the [multihost] phase's four Table I mounts,
    # the entry point's own launch timed by the profiler
    make, traces = multi_cases(seed, SWEEP_HOST_PER_HOST)["table1x4"]
    got = {}

    def run_hosts():
        rs.reset_launches()
        t0 = time.perf_counter()
        got["lanes"] = sw.host_count_sweep(make(), traces, list(SWEEP_HOSTS))
        torch.cuda.synchronize()
        got["wall"] = time.perf_counter() - t0
        got["launches"] = rs.LAUNCHES["replay_scan"]

    ms, how = launch_ms(torch, run_hosts, MULTI_SWEEP_KERNEL)
    alone_ms = []
    for h, lane in zip(SWEEP_HOSTS, got["lanes"]):
        one = MultiHostReplay(make()[:h])
        st = {}
        ms1, _ = launch_ms(torch, lambda: st.update(res=one.run(traces[:h])),
                           MULTI_KERNEL)
        alone_ms.append(ms1)
        res = st["res"]
        lane_check(f"hosts/{h}", {
            "ticks": res.elapsed_ticks == lane.elapsed_ticks and all(
                (r.accesses, r.elapsed_ticks, r.sum_latency_ticks,
                 r.end_tick) == (x.accesses, x.elapsed_ticks,
                                 x.sum_latency_ticks, x.end_tick)
                for r, x in zip(res.per_host, lane.per_host)),
            "absent": all(x.accesses == 0 for x in lane.per_host[h:])})
    # the widest lane's bound, from its hosts' order of a launch of its own
    prep = MultiHostReplay(make()).prepare(traces)
    hb = multi_bound(torch, prep, multi_kernel_run(torch, prep)[2], 0,
                     int32_ops_per_s, smem_cycles, sm_clock_mhz)["bound_ms"]
    report("hosts", len(SWEEP_HOSTS), got["launches"], ms, how, got["wall"],
           alone_ms, hb * len(SWEEP_HOSTS) / min(len(SWEEP_HOSTS), sms))

    # (c) fault seeds: the availability oracle, then the down window
    oracle = json.loads((ROOT / "results" / "BENCH_replay.json")
                        .read_text())["availability"]
    for nh in AVAIL_HOSTS:
        mk, tr = availability_case(nh)
        rs.reset_launches()
        lanes_av = sw.fault_seed_sweep(mk, tr, list(range(AVAIL_SEEDS)),
                                       outstanding=8)
        check(rs.LAUNCHES["replay_scan"] == 1,
              f"[sweep] oracle x{nh}: {rs.LAUNCHES['replay_scan']} launches")
        got_av, want_av = availability_fields(lanes_av), oracle[
            f"hosts_x{nh}"]
        lane_check(f"oracle/x{nh}", {
            k: got_av[k] == want_av[k] for k in (
                "seeds", "window_ticks", "num_windows",
                "availability_curve")})
    traces = [make_trace(seed + i, n=SWEEP_SEED_PER_HOST, pages=16384)
              for i in range(MULTI_DOWN["num_hosts"])]
    seeds = list(range(SWEEP_SEEDS))
    got, info = {}, {}

    def run_seeds():
        rs.reset_launches()
        t0 = time.perf_counter()
        got["lanes"] = sw.fault_seed_sweep(
            lambda s: sweep_down_targets(s, SWEEP_SEED_PER_HOST), traces,
            seeds, info=info)
        torch.cuda.synchronize()
        got["wall"] = time.perf_counter() - t0
        got["launches"] = rs.LAUNCHES["replay_scan"]

    ms, how = launch_ms(torch, run_seeds, MULTI_SWEEP_KERNEL)
    alone_ms = []
    for s in SWEEP_SEED_CHECKED:
        one = MultiHostReplay(sweep_down_targets(s, SWEEP_SEED_PER_HOST))
        st = {}
        ms1, _ = launch_ms(torch, lambda: st.update(res=one.run(traces)),
                           MULTI_KERNEL)
        alone_ms.append(ms1)
        res, stats = st["res"], one.fault_stats
        if s == SWEEP_SEED_CHECKED[0]:
            prep = one.prepare(traces)
            sb = multi_bound(torch, prep, multi_kernel_run(torch, prep)[2],
                             0, int32_ops_per_s, smem_cycles,
                             sm_clock_mhz)["bound_ms"]
        lane = got["lanes"][s]
        lane_check(f"seeds/{s}", {
            "latency": np.array_equal(np.concatenate(
                [r.latency_ticks for r in res.per_host]),
                lane["latency_ticks"]),
            "ticks": res.elapsed_ticks == lane["result"].elapsed_ticks
            and all((r.accesses, r.elapsed_ticks, r.sum_latency_ticks,
                     r.end_tick) == (x.accesses, x.elapsed_ticks,
                                     x.sum_latency_ticks, x.end_tick)
                    for r, x in zip(res.per_host, lane["result"].per_host)),
            "fault_stats": stats == lane["fault_stats"]})
    check(all(lane["fault_stats"]["failovers"] > 0
              and lane["fault_stats"]["link_retries"] > 0
              for lane in got["lanes"]), "[sweep] a seed lane saw no fault")
    report("seeds", len(seeds), got["launches"], ms, how, got["wall"],
           alone_ms, sb * len(seeds) / min(len(seeds), sms),
           column_s=info["column_seconds"])

    # (d) a GC-overfilled cache sweep is refused, lane-wise
    gdev = make_device("cxl-ssd-cache", ssd_cfg=gc_ssd_cfg(750),
                       cache_cfg=DRAMCacheConfig(capacity_bytes=8 * 4096,
                                                 mshr_entries=4,
                                                 writeback_buffer=2))
    bad = np.arange(1100, dtype=np.int64) * 4096
    lane_check("overfill/refused", {"refused": refuses(
        lambda: sw.cache_design_sweep(gdev, bad, bad >= 0,
                                      capacity_frames=[8, 4],
                                      is_lru=[True, True], outstanding=8),
        ReplayUnsupported)})

    failures = sweep_failures(lines)
    check(not failures, f"[sweep] lane checks failed: {failures}")
    say("sweep", checks=len(lines), equal="all",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    return runs

# ------------------------------------------------------------ the fleet
def cluster_latency_cycles(torch, path: Path, shards: int) -> tuple:
    """SM clock cycles of one cluster barrier and of one dependent
    distributed-shared-memory load on a cluster of ``shards`` CTAs, timed
    by ``tools/smem_latency.cu`` over ``CLUSTER_HOPS`` of each."""
    lib = ctypes.CDLL(str(path))
    lib.cluster_latency.restype = ctypes.c_int
    lib.cluster_latency.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    err = lib.cluster_latency(shards, CLUSTER_HOPS, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"cluster latency probe launch failed: {err}")
    bar, load, _ = out.tolist()
    return bar / CLUSTER_HOPS, load / CLUSTER_HOPS


def ptxas_registers(log: str, kernel: str) -> list:
    """Registers of every function whose (mangled) name holds ``kernel``
    in an ``nvcc -Xptxas -v`` report."""
    return [int(r) for r in re.findall(
        r"Compiling entry function '\S*" + re.escape(kernel) + r"\S*'"
        r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers", log)]


def fleet_mounts(hosts: int, pods: int):
    """``hosts`` DRAM devices mounted h_i -> d_i on a ``multi_pod`` fabric
    of ``pods`` pods, as results/BENCH_replay.json's fleet builds it."""
    from repro_torch.core.devices import make_device
    from repro_torch.core.fabric import Fabric

    fab = Fabric.build("multi_pod", num_pods=pods,
                       hosts_per_pod=hosts // pods, **FLEET_FABRIC)
    return [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
            for i in range(hosts)]


def fleet_columns(torch, spec, seed: int, hosts: int, n: int):
    """The fleet's ``(H, n)`` columns built on the card by
    ``host_trace_torch`` (as numpy, for ``run_arrays``), checked equal to
    ``host_trace_np``'s; the card's and numpy's seconds."""
    from repro_torch.data import host_trace_np, host_trace_torch

    t0 = time.perf_counter()
    want = [host_trace_np(spec, seed, h, n) for h in range(hosts)]
    numpy_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = [host_trace_torch(spec, seed, h, n) for h in range(hosts)]
    addrs = torch.stack([a for a, _ in cols])
    writes = torch.stack([w for _, w in cols])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    addrs, writes = addrs.cpu().numpy(), writes.cpu().numpy()
    check(np.array_equal(addrs, np.stack([a for a, _ in want]))
          and np.array_equal(writes, np.stack([w for _, w in want])),
          "host_trace_torch differs from host_trace_np")
    return addrs, writes, card_s, numpy_s


def fleet_kernel_ms(torch, prep, shards) -> tuple:
    """Device milliseconds of one launch on the prepared inputs through the
    kernel's sharded instance (the one-CTA instance for ``shards`` None),
    how they were timed, and the run's per-step hosts."""
    from repro_torch.core.replay import stack
    from repro_torch.kernels import replay_scan as rs

    cfg = prep.cfg
    ins, rt = multi_inputs(torch, prep, "cuda")
    out = {}

    def run():
        state = stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash,
                                 "cuda")
        out["who"] = (rs.replay_multi(cfg, prep.params, state, *ins,
                                      retries=rt) if shards is None else
                      rs.replay_sharded(cfg, shards, prep.params, state,
                                        *ins, retries=rt))[0]

    ms, how = launch_ms(torch, run, MULTI_KERNEL if shards is None
                        else FLEET_KERNEL)
    return ms, how, out["who"].cpu().numpy()


def same_results(a, b) -> bool:
    """Two multi-host results equal on every host's latencies and fields,
    the span and the metrics bundle."""
    return (a.elapsed_ticks == b.elapsed_ticks and all(
        np.array_equal(x.latency_ticks, y.latency_ticks)
        and (x.accesses, x.elapsed_ticks, x.sum_latency_ticks, x.end_tick)
        == (y.accesses, y.elapsed_ticks, y.sum_latency_ticks, y.end_tick)
        for x, y in zip(a.per_host, b.per_host))
        and json.dumps(a.metrics.to_jsonable())
        == json.dumps(b.metrics.to_jsonable()))


def fleet_phase(torch, seed: int, probe: Path, smem_cycles: float,
                sm_clock_mhz: float, int32_ops_per_s: float) -> dict:
    """[fleet]: the sharded fleet replay on the card, each replay one launch
    of ``replay_scan``'s cluster instance through its entry point: the
    BENCH_replay.json fleet oracle exact at every cluster size and through
    the repaired one-CTA instance, a fleet that one CTA cannot hold, the
    golden fleet pin, the sharded host-count sweep, and the kernel against
    its twin."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scenarios import make_multi_targets, multi_traces, shard_case

    from repro_torch.core.replay import (MetricsSpec, MultiHostReplay,
                                         ShardedMultiHostReplay)
    from repro_torch.core.replay import stack
    from repro_torch.core.replay.spec import ReplayUnsupported
    from repro_torch.core.replay.sweep import host_count_sweep
    from repro_torch.data import WorkloadSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_scan as rs

    t_phase = time.perf_counter()
    log = _build.build_log.get("replay_scan", "")
    regs = ptxas_registers(log, FLEET_KERNEL)
    spills = ptxas_spills(log, FLEET_KERNEL)
    say("fleet", kernel=FLEET_KERNEL, instances=len(regs),
        registers=f"{min(regs)}-{max(regs)}", spill_bytes=spills)
    check(spills == 0, f"{FLEET_KERNEL} spills {spills} bytes")
    barrier = {d: cluster_latency_cycles(torch, probe, d) for d in (2, 8, 16)}
    for d, (bar, load) in barrier.items():
        say("fleet", cluster=d, barrier_cycles=f"{bar:.1f}",
            dsmem_load_cycles=f"{load:.1f}")

    # (a) the BENCH_replay.json oracle --------------------------------
    oracle = json.loads((ROOT / "results" / "BENCH_replay.json")
                        .read_text())["fleet"]
    w = oracle["workload"]
    spec = WorkloadSpec(w["kind"], num_pages=w["num_pages"],
                        zipf_s=w["zipf_s"], write_frac=w["write_frac"])
    H, n = oracle["hosts"], oracle["accesses_per_host"]
    addrs, writes, card_s, numpy_s = fleet_columns(torch, spec, w["seed"],
                                                   H, n)
    say("fleet", synthesis="host_trace_torch", hosts=H, accesses=H * n,
        card_s=f"{card_s:.4f}", numpy_s=f"{numpy_s:.4f}", equal="all")
    want = (oracle["elapsed_ticks"], oracle["sum_latency_ticks"],
            oracle["p50_ticks"], oracle["p99_ticks"])
    runs, first = {}, None
    for shards in (None,) + FLEET_SHARDS:
        name = "one-cta" if shards is None else f"D{shards}"
        tgts = fleet_mounts(H, FLEET_PODS)
        eng = (MultiHostReplay(tgts, outstanding=8, metrics=MetricsSpec())
               if shards is None else ShardedMultiHostReplay(
                   tgts, outstanding=8, metrics=MetricsSpec(),
                   devices=range(shards)))
        rs.reset_launches()
        t0 = time.perf_counter()
        try:
            res = eng.run_arrays(addrs, writes)
        except ReplayUnsupported as e:
            check(shards == 16, f"[fleet] {name} refused: {e}")
            say("fleet", case=name, launchable=False, reason=repr(str(e)))
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rs.LAUNCHES["replay_scan"]
        got = (res.elapsed_ticks,
               sum(r.sum_latency_ticks for r in res.per_host),
               res.metrics.percentile_ticks(50),
               res.metrics.percentile_ticks(99))
        check(got == want, f"[fleet] {name}: {got} against the oracle's "
                           f"{want}")
        check(launches == 1, f"[fleet] {name}: {launches} launches")
        if first is None:
            first = res
        check(same_results(res, first), f"[fleet] {name} differs from the "
                                        "one-CTA replay")
        prep = eng.prepare_arrays(addrs, writes)
        ms, how, who = fleet_kernel_ms(torch, prep, shards)
        run = {"launches": launches, "ms": ms, "timing": how,
               "wall_s": wall, "steps": H * n, "shards": shards,
               "ns_per_step": ms * 1e6 / (H * n)}
        run.update(multi_bound(torch, prep, who, 0, int32_ops_per_s,
                               smem_cycles, sm_clock_mhz))
        if shards is not None:
            bar, load = barrier[min(barrier, key=lambda d: abs(d - shards))]
            run["serial_chain_ms"] += H * n * (
                bar + FLEET_DSMEM_TRIPS * load) / (sm_clock_mhz * 1e3)
            run["mesh"] = dict(eng.last_mesh)
        runs[name] = run
        say("fleet", case=name, hosts=H, steps=H * n, oracle="exact",
            elapsed_ticks=got[0], sum_latency_ticks=got[1], p50=got[2],
            p99=got[3], launches=launches, kernel_ms=f"{ms:.3f}",
            timing=how, ns_per_step=f"{run['ns_per_step']:.1f}",
            wall_s=f"{wall:.3f}", host_s=f"{wall - ms / 1e3:.3f}",
            bound_ms=f"{run['bound_ms']:.6f}", bound_by=run["bound_by"],
            serial_chain_ms=f"{run['serial_chain_ms']:.3f}",
            mesh=json.dumps(run.get("mesh"), separators=(",", ":")))

    # (b) a fleet one CTA cannot hold ---------------------------------
    big = FLEET_BIG
    Hb, nb = big["hosts"], big["per_host"]
    b_addrs, b_writes, _, _ = fleet_columns(torch, spec, w["seed"], Hb, nb)
    prep = MultiHostReplay(fleet_mounts(Hb, big["pods"]),
                           outstanding=8).prepare_arrays(b_addrs, b_writes)
    try:
        rs.layout_multi(prep.cfg, prep.params,
                        rs._smem_optin(_build.library("replay_scan"), 0))
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "B of shared memory" in refused,
          "[fleet] the one-CTA layout took the 512-host fleet")
    check(refuses(lambda: MultiHostReplay(
        fleet_mounts(Hb, big["pods"]), outstanding=8).run_arrays(
            b_addrs, b_writes), ValueError),
        "[fleet] the one-CTA lane ran the 512-host fleet")
    t0 = time.perf_counter()
    twin = MultiHostReplay(fleet_mounts(Hb, big["pods"]), outstanding=8,
                           metrics=MetricsSpec(), torch_device="cpu"
                           ).run_arrays(b_addrs, b_writes)
    twin_s = time.perf_counter() - t0
    say("fleet", case=f"x{Hb}", ports=prep.cfg.num_ports, steps=Hb * nb,
        one_cta="refused", reason=repr(refused), twin_s=f"{twin_s:.3f}")
    for shards in FLEET_BIG_SHARDS:
        eng = ShardedMultiHostReplay(fleet_mounts(Hb, big["pods"]),
                                     outstanding=8, metrics=MetricsSpec(),
                                     devices=range(shards))
        rs.reset_launches()
        t0 = time.perf_counter()
        try:
            res = eng.run_arrays(b_addrs, b_writes)
        except ReplayUnsupported as e:
            check(shards == 16, f"[fleet] x{Hb} D{shards} refused: {e}")
            say("fleet", case=f"x{Hb}-D{shards}", launchable=False,
                reason=repr(str(e)))
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rs.LAUNCHES["replay_scan"]
        check(launches == 1, f"[fleet] x{Hb} D{shards}: {launches} launches")
        check(same_results(res, twin), f"[fleet] x{Hb} D{shards} differs "
                                       "from the unsharded CPU twin")
        ms, how, _ = fleet_kernel_ms(torch, eng.prepare_arrays(
            b_addrs, b_writes), shards)
        runs[f"x{Hb}-D{shards}"] = {"launches": launches, "ms": ms,
                                    "timing": how, "wall_s": wall,
                                    "steps": Hb * nb, "shards": shards}
        lay = rs.layout_multi(prep.cfg, prep.params, rs._smem_optin(
            _build.library("replay_scan"), 0), shards=shards)
        say("fleet", case=f"x{Hb}-D{shards}", equal_to_twin="all fields",
            launches=launches, kernel_ms=f"{ms:.3f}", timing=how,
            ns_per_step=f"{ms * 1e6 / (Hb * nb):.1f}",
            wall_s=f"{wall:.3f}", smem_bytes_a_cta=lay.smem_bytes)

    # (c) the golden fleet pin ------------------------------------------
    pins = golden_pin(FLEET_PIN, "python_scan")
    for shards in FLEET_PIN_SHARDS:
        rs.reset_launches()
        res = ShardedMultiHostReplay(
            make_multi_targets(FLEET_PIN), outstanding=8,
            metrics=MetricsSpec(), devices=range(shards)).run(
                multi_traces(FLEET_PIN))
        check(rs.LAUNCHES["replay_scan"] == 1, "[fleet] pin launches")
        check(len(pins) == len(res.per_host) and all(
            r.latency_ticks.tolist() == p["latency_ticks"]
            and all(getattr(r, k) == p[k] for k in (
                "elapsed_ticks", "sum_latency_ticks", "end_tick"))
            for r, p in zip(res.per_host, pins)),
            f"[fleet] pin at D{shards}")
        check(json.loads(json.dumps(res.metrics.to_jsonable()))
              == golden_pin(FLEET_PIN, "metrics"),
              f"[fleet] pin metrics at D{shards}")
    say("fleet", pin=FLEET_PIN, shards=",".join(map(str, FLEET_PIN_SHARDS)),
        python_scan="equal", metrics="equal")

    # (d) the sharded host-count sweep ------------------------------------
    traces = [[(int(a), 64, bool(x)) for a, x in zip(addrs[h], writes[h])]
              for h in range(H)]
    rs.reset_launches()
    info = {}
    t0 = time.perf_counter()
    lanes = host_count_sweep(fleet_mounts(H, FLEET_PODS), traces,
                             list(FLEET_SWEEP), outstanding=8, sharded=True,
                             info=info)
    sweep_s = time.perf_counter() - t0
    sharded_launches = rs.LAUNCHES["replay_scan"]
    base = host_count_sweep(fleet_mounts(H, FLEET_PODS), traces,
                            list(FLEET_SWEEP), outstanding=8)
    check(sharded_launches == len(FLEET_SWEEP),
          f"[fleet] sweep launches {sharded_launches}")
    check(all(a.elapsed_ticks == b.elapsed_ticks and all(
        (x.accesses, x.sum_latency_ticks, x.end_tick)
        == (y.accesses, y.sum_latency_ticks, y.end_tick)
        for x, y in zip(a.per_host, b.per_host))
        for a, b in zip(lanes, base)), "[fleet] sharded sweep differs")
    say("fleet", sweep="host_count_sweep(sharded=True)",
        hosts=",".join(map(str, FLEET_SWEEP)), launches=sharded_launches,
        info=json.dumps(info, separators=(",", ":")),
        wall_s=f"{sweep_s:.3f}", equal_to_unsharded="all lanes")
    runs["sweep"] = {"launches": sharded_launches, "wall_s": sweep_s}

    # the kernel against its twin -----------------------------------------
    mismatches, plain_ms, plain_steps = 0, 0.0, 0
    for case, shards in FLEET_TWIN:
        tgts, trs = shard_case(case)
        p = MultiHostReplay(tgts, outstanding=8).prepare(trs)
        cfg = p.cfg
        states = [stack.init_lanes(cfg.stack, cfg.num_devs, cfg.n_flash, d)
                  for d in ("cpu", "cuda")]
        outs = []
        for state, dev in zip(states, ("cpu", "cuda")):
            ins, rt = multi_inputs(torch, p, dev)
            t0 = time.perf_counter()
            outs.append(rs.replay_sharded(cfg, shards, p.params, state,
                                          *ins, retries=rt))
            if dev == "cpu":
                plain_ms += (time.perf_counter() - t0) * 1e3
                plain_steps += int(p.lens.sum())
        torch.cuda.synchronize()
        pairs = list(zip(outs[1], outs[0]))
        for part in ("media", "flash"):
            pairs += [(states[1][part][k], x)
                      for k, x in (states[0][part] or {}).items()]
        mismatches += sum(int((g.cpu() != x).sum()) for g, x in pairs)
    check(mismatches == 0, f"the sharded instance differs from its twin in "
                           f"{mismatches} elements")
    say("fleet", twin_checks=len(FLEET_TWIN), mismatches=0,
        twin_steps=plain_steps, twin_ms=f"{plain_ms:.3f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    runs["twin"] = {"plain_ms": plain_ms, "steps": plain_steps,
                    "launches": 0}
    runs["registers"] = regs
    return runs


def fleet_row(fleet: dict) -> dict:
    """The kernels line's row of ``replay_scan``'s cluster instance: the
    64-host fleet at D = 8 (every cluster size, the 512-host fleet and the
    one-CTA instance beside it)."""
    main = fleet["D8"]
    timed = {k: v for k, v in fleet.items() if isinstance(v, dict)
             and "ms" in v}
    return {
        "name": "replay_scan (sharded)", "route": "cuda",
        "source": SCAN_SOURCE, "replaces": FLEET_REPLACES,
        "launches": sum(v["launches"] for k, v in fleet.items()
                        if isinstance(v, dict) and "launches" in v
                        and k != "one-cta"),
        "max_abs_err": 0, "tolerance": 0,
        "ms": main["ms"], "plain_ms": fleet["twin"]["plain_ms"],
        "plain_steps": fleet["twin"]["steps"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "steps": main["steps"], "shards": 8,
        "serial_chain_ms": main["serial_chain_ms"],
        "ms_by_case": {k: v["ms"] for k, v in timed.items()},
        "ns_per_step_by_case": {k: v["ms"] * 1e6 / v["steps"]
                                for k, v in timed.items()},
        "kernel": FLEET_KERNEL, "registers": fleet["registers"],
    }



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

    # 12. the tick-exact scan lane, after the host-bound serving loop so
    # that its python-lane replays leave nothing behind for that loop -----
    int32_ops_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                       * INT32_LANES_PER_SM * sm_clock_mhz * 1e6)
    scan = scan_phase(torch, trace, smem_cycles, sm_clock_mhz,
                      int32_ops_per_s)
    faults = faults_phase(torch, trace, smem_cycles, sm_clock_mhz,
                          int32_ops_per_s)
    assoc_phase(torch, trace, scan)
    multi = multihost_phase(torch, args.seed, smem_cycles, sm_clock_mhz,
                            int32_ops_per_s)
    stream = stream_phase(torch, trace, scan, args.seed)
    sweeps = sweep_phase(torch, trace, args.seed, scan, smem_cycles,
                         sm_clock_mhz, int32_ops_per_s)
    fleet = fleet_phase(torch, args.seed, probe_lib, smem_cycles,
                        sm_clock_mhz, int32_ops_per_s)

    # kernels line -------------------------------------------------------
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
    print(json.dumps({"kernels": rows + serve_rows + [
        prefill_row, scan_row(scan, faults, multi, n, stream, sweeps),
        fleet_row(fleet)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
