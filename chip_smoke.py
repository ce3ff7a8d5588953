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
11a. int8: phase 8's serving run again with ``kv_dtype="int8"`` (int8
   caches, float16 scales a slot and KV head): 640 x 24 launches of
   ``flash_decode_int8`` and none of the float32 instance, the store's
   counters equal to the same JAX pins (they do not depend on the page
   data), greedy tokens of a second run identical, the kernel against its
   plain version (dequantize, then ``flash_decode_plain``) on the run's
   final caches of all 24 layers; its device time a call beside the
   float32 kernel's on the float run's caches, its plain version,
   dequantize + ``F.scaled_dot_product_attention`` and its bytes bound;
11b. families: mamba2-2.7b (ssm, 32 of its 64 layers), hymba-1.5b
   (hybrid, 16 of 32), musicgen-large (audio, 4 codebooks, 24 of 48) and
   mixtral-8x7b (moe, 4 of its 32 layers: one float32 layer's experts
   are 5.6 GB) at full width
   with seeded weights: ``serve()`` at batch 4, 32 + 32 steps, twice
   (identical tokens and store counters; ``flash_decode`` launches = steps
   x attention layers, 0 for mamba2, and no store without attention);
   ``make_prefill_step`` on 2 x 1024 seeded tokens (one
   ``flash_attention`` launch an attention layer, finite logits); 64
   decode steps against the prefill's first 64 positions, within 2e-3 of
   the largest |logit| with equal argmax, or for mixtral (whose
   2048-token prefill drops other assignments than a decode) layer 0's
   ``moe_ffn_local`` on the card against the CPU on the same 64 tokens
   within 1e-5; ms a step, tok/s, prefill ms, peak device bytes, and
   the device-busy split and idle share of 4 decode steps;
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
   path's first 2^18 accesses under the golden ``faults-nand-retry@direct``
   rates (NAND
   read retries and poison; its 16 GB run no GC at this footprint); the
   golden scenario's GC-pressured flash under the same plan over the
   longest power-of-two seeded trace that the python lane finishes
   (blocks retired); Table I's device mounted h0 -> d0 on a 2 x 2
   spine-leaf with ECMP under CRC retries and a down window, over the
   main path's first 2^17 accesses (link retries, degraded accesses and
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
   availability series; that comparison at a sixteenth of the depth,
   each host's first 2^14 accesses, the timed replay at the full depth): ``MultiHostDriver(targets, engine="scan")`` over
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
   phase's down window with CRC retries over 16 seeds, 2 x 2^12
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

11c. vlm: llama-3.2-vision-90b at full width cut to 2 super-blocks (10
   self and 2 cross layers), gates 0.5, a seeded frontend: a 2 x 1024
   prefill and 64 decode steps on ``init_decode_state(frontend=...)``
   (12 ``flash_attention`` and 64 x 12 ``flash_decode`` launches), decode
   against the prefill, cross layer 0's kernels against their plain
   versions; prefill ms, ms a step, peak bytes;
11d. train: the ``lse`` instance and the three backward kernels against
   their plain versions (hd 64 / 120 / 128 x G 1-16 x five masks);
   minicpm-2b at full width and depth through ``launch/train.main`` (2 x
   2048, remat, 8 steps: 80 ``lse`` launches and 40 of each backward
   kernel a step), a profiled step's split, the kernels at layer 0's
   shape beside bounds, plain versions and SDPA; one step of the 2-layer
   cut on the card against the CPU (int8 moments, compression) and a
   checkpoint and resume (4 + 2 steps against 6);
11e. mesh: ``make_serve_step(cfg, mesh)`` on a data 2 x model 2 mesh of
   four processes on this card (gloo, ``run_local_ranks``), each rank on
   its blocks (``init_local_params``, ``init_local_decode_state``):
   h2o-danube-3-4b at full width and depth, a 64-slot ring over 96 steps
   (the second shard empty for 32, the ring wrapping at 64), logits
   against the one-device decode of the same seeded weights and tokens
   run first on this card (2e-3 of the largest, equal argmax); int8
   caches over 40 steps, held at steps 31 and 39 from the ranks' own
   caches; mixtral-8x7b cut to 2 layers, ``tp`` experts with and without
   ``resident_experts``; every rank's ``flash_decode`` launches equal to
   its (step, layer) pairs with a non-empty shard, its partials against
   the plain version on its final caches; ms a step beside the
   one-device step's, peak bytes a rank.  It runs after ``[train]`` and
   before ``[scan]`` (phase 12 on);
11f. mesh-train: training and prefill on a device mesh (four gloo
   processes on this card, see ``MESH_TRAIN``): (a) minicpm-2b at full
   width, 8 layers, data 2 x model 2, 4 x 2048, remat, ZeRO-1 AdamW, 4
   steps: step 1's loss and every gathered gradient against the
   one-device ones, later losses, ``lse`` 2 and each backward kernel 1
   launch a layer a step on every rank, each rank's layer-0 heads
   through the training kernels against their plain versions; (b) the
   same on pod 2 x data 1 x model 2, 3 steps on one batch (the loss
   falls); (c) mixtral-8x7b, 1 layer, ``tp`` experts FSDP-cut over data,
   2 steps; (d) the mesh prefill's logits and argmax against one device's;
   (e) ``pipeline_forward`` of (a)'s 8 blocks over 4 stages against the
   sequential forward, its launches a stage; (f) (a)'s step-2 checkpoint
   restored onto data 1 x model 2 (blocks bit-equal to the saved
   leaves), steps 3-4 against (a)'s; ms a step a rank beside one
   device's, peak bytes a rank, collectives a step.

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
# the python lane's comparison depth where it is slowest (20-31 s at
# 2^20): the first 2^18 accesses, replayed on the card again; the main
# path's replays stay at the whole trace
SCAN_PYTHON_ACCESSES = {"cxl-ssd": 1 << 18, "cxl-ssd-cache": 1 << 18}
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
# of the main path's first 2^17 accesses (cut from 2^20 so that the
# script keeps its time limit with the [sweep], [vlm] and [train]
# phases: the python lane took 111 s at 2^20); the
# golden scenario's GC-pressured flash on
# the longest power-of-two seeded trace that the python lane finishes
# (2^13 accesses run out of space, tests/test_torch_faults_scan.py)
FAULT_NAND = dict(nand_read_retry_rate=0.3, erase_fail_rate=0.5,
                  poison_rate=0.1)
FAULT_NAND_SEED = 0
# the NAND-faulted replay runs the main path's first 2^17 accesses (at
# 2^20 its python lane took 81 s, at 2^18 16 s: cut to make room for
# [mesh-train])
FAULT_NAND_ACCESSES = 1 << 17
FAULT_FABRIC = dict(num_hosts=2, num_devices=2, num_leaves=2, num_spines=2,
                    ecmp=True)
FAULT_LINK = dict(link_retry_rate=0.25,
                  down_links=(("s0", "sp0", 1 << 15, 1 << 16),))
FAULT_LINK_ACCESSES = 1 << 16     # at 2^17 its python lane took 12.7 s
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
# the python lane's comparison runs the same cases at a thirty-second of
# the depth, each host's first accesses (at 2^18 a host its taps took
# 171 s, which the script's time limit no longer holds beside the
# [sweep], [vlm], [train] and [mesh-train] phases; 2^14 before
# [mesh-train] came)
MULTI_PYTHON_PER_HOST = 1 << 13
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
# 2^12 accesses a host (at 2^16 its column builder took 69 s, at 2^13 7
# s);
# (d) a GC-overfilled cache sweep, refused
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
SWEEP_SEED_PER_HOST = 1 << 12
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
KERNEL_NAMES = {"flash_decode": "flash_decode_kernel",   # either instance
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
# [int8]: the serving main path with int8 caches; the kernel's instance
INT8_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
INT8_REPLACES = "src/repro/models/transformer.py:365"
# [families]: (arch, layers on the card, None for all) at full width; one
# layer of mixtral's float32 experts is 5.6 GB, so it runs 4 of its 32;
# for the script's time limit beside [mesh-train], mamba2 runs 32 of its
# 64 layers, hymba 16 of 32, musicgen 24 of 48
FAMILY_RUNS = (("mamba2-2_7b", 32), ("hymba-1_5b", 16),
               ("musicgen-large", 24), ("mixtral-8x7b", 4))
FAMILY_SERVE = dict(batch=4, context=512, prompt_len=32, gen=32,
                    policy="lru", kv_page_tokens=16)
FAMILY_PREFILL = dict(batch=2, seq=1024)
FAMILY_PROFILE_STEPS = 4       # decode steps under the profiler, per model
MOE_CHECK_TOKENS = 64          # mixtral's layer-0 MoE, card against the CPU
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
PREFILL_TIMING_REPS = 8
# [vlm]: llama-3.2-vision-90b at full width, cut to 2 super-blocks (10
# self layers, 2 cross layers: 43.4 GB of float32 weights; all 100 layers
# would be ~363 GB), every cross gate at 0.5 (the reference's zero gates
# would shut the cross layers out of every check), a seeded frontend
VLM = dict(arch="llama-3_2-vision-90b", super_blocks=2, batch=2, seq=1024,
           gate=0.5, frontend_scale=0.1, decode_steps=64)
# [train]: minicpm-2b at full width and depth through launch/train.main
# (4 steps: the script's time limit)
TRAIN = dict(arch="minicpm-2b", steps=4, batch=2, seq=2048)
TRAIN_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
TRAIN_REPLACES = "src/repro/models/flash_vjp.py:258"     # _flash_bwd (jnp)
LSE_REPLACES = "src/repro/models/flash_vjp.py:250"       # _flash_fwd (jnp)
BWD_KERNELS = {"flash_attention_bwd_delta": "flash_attention_bwd_delta_kernel",
               "flash_attention_bwd_dkdv": "flash_attention_bwd_dkdv_kernel",
               "flash_attention_bwd_dq": "flash_attention_bwd_dq_kernel"}
# the CPU tests' tolerance (tests/test_torch_flash_vjp.py,
# tests/test_torch_attention_bwd_tf32.py): the backward kernels take every
# product in split TF32 on the tensor cores (float32 accuracy) and sum over
# up to Skv keys (dq) or S x G query rows (dk, dv) in another order than
# the plain version (tests/test_torch_cuda.py holds the same)
BWD_TOL = dict(atol=2e-5, rtol=2e-5)
# (S, Skv, causal, window) of the backward checks: 64-row query and key
# tiles; "edge" ends one row and one key past a tile, "cross_edge" one key
BWD_MODES = {"causal": (256, 256, True, 0), "window": (320, 320, True, 100),
             "cross": (160, 200, False, 0), "edge": (129, 129, True, 0),
             "cross_edge": (64, 129, False, 0)}
# every (hd, mask) pair and every (hd, G) pair once (G's index is the
# mask's plus twice hd's, mod 5); tests/test_torch_cuda.py holds the
# whole product on the card
BWD_CHECKS = [(hd, (1, 4, 5, 8, 16)[(m + 2 * h) % 5], mode)
              for h, hd in enumerate((64, 120, 128))
              for m, mode in enumerate(BWD_MODES)]
# the 2-layer cut of minicpm-2b: one step on the card against the CPU port
# (int8 moments, compressed gradients; lr 1e-4: AdamW's first step moves a
# parameter by about lr * g / (|g| + eps), so a gradient within rounding
# of zero may move by up to 2 lr on the one side and not the other), and
# a checkpoint and resume through launch/train.main (4 + 2 steps against
# 6)
TRAIN_CUT = dict(layers=2, batch=1, seq=64, lr=1e-4)
TRAIN_RESUME = dict(layers=2, batch=2, seq=512, steps=6, every=4,
                    lr="1e-4", moments="int8")
GRAD_SHARE_TOL = 1e-4          # |grad error| / a leaf's largest |grad|
TRAIN_LAYERS_FULL = 40
# [mesh]: serving on a data 2 x model 2 mesh, four processes on the one
# card over gloo (repro_torch.launch.mesh.run_local_ranks), each rank on
# its blocks: h2o-danube-3-4b at full width and depth, a 64-slot ring (32
# slots a model rank) over 96 steps, so that the first 32 steps leave the
# second shard empty and the ring wraps at 64; int8 caches over 40 steps
# (past 32, so that both shards attend); mixtral-8x7b cut to 2 of its 32
# layers (2.8 GB of experts a layer a rank), its 'tp' body with and
# without resident_experts.  Logits within MESH_TOL x the largest |logit|
# of the one-device decode of the same weights and tokens, on the card.
# int8 caches quantize projections that the mesh computes as column
# blocks: an ulp of difference from the one-device product moves a value
# across a rounding edge now and then (a code 1 off), and from there the
# two free runs hold different caches and drift apart.  So the int8 run
# is held where the caches are equal: at steps 31 (the second shard still
# empty) and 39 (both shards attend), each from the ranks' own caches
# (gathered), against one one-device step from the same caches; the free
# run's drift and its differing codes are shown.  The MoE's capacity
# counts the tokens a rank routes (the reference's ep and tp bodies): at
# mixtral's factor 1.25 a rank's 2 tokens get 1 slot an expert where one
# device's 4 get 2, so the two drop different assignments.  The mesh runs
# take factor 8, at which neither drops (the reference's reduced configs
# take it "for parity"); every width stays.
MESH = dict(arch="h2o-danube-3-4b", shape=(2, 2), batch=4, context=64,
            steps=96, int8_steps=40, int8_held=(31, 39),
            moe_arch="mixtral-8x7b", moe_layers=2, moe_steps=16,
            moe_capacity=8.0)
MESH_TOL = 2e-3
MESH_TIMEOUT_S = 600
# [mesh-train]: training and prefill on a device mesh, four gloo processes
# on the one card (a fifth and sixth for the restore), float32 seeded
# weights, TF32 off, each cell against its one-device run on this card:
# (a) minicpm-2b at full width cut to 8 of its 40 layers on data 2 x
# model 2, global batch 4 x 2048 of the seeded Markov corpus, remat, f32
# AdamW with ZeRO-1 moments, 4 steps of WSD at peak 3e-3 (steps 1-4:
# warmup 1, stable 2, decay 1); step 1's gradients, every rank's layer-0
# heads through the training kernels; (b) the same model on pod 2 x data
# 1 x model 2, 3 steps on one batch; (c) mixtral-8x7b at full width cut
# to 1 of its 32 layers, 'tp' experts FSDP-cut over data, capacity factor
# 8 (a rank's capacity counts its own tokens: at 1.25 it drops what one
# device keeps, [mesh] above), batch 4 x 512, 2 steps; (d) the prefill of
# (a)'s model at its initial weights on 4 x 2048; (e) pipeline_forward of
# (a)'s 8 blocks over a 4-stage pod mesh, x 8 x 2048 x 2304, 4
# microbatches; (f) (a) saves at step 2, a data 1 x model 2 group restores
# it and takes steps 3-4.
MESH_TRAIN = dict(arch="minicpm-2b", layers=8, shape=(2, 2), batch=4,
                  seq=2048, steps=4, save_at=2, peak_lr=3e-3,
                  pod_shape=(2, 1, 2), pod_steps=3,
                  moe_arch="mixtral-8x7b", moe_layers=1, moe_batch=4,
                  moe_seq=512, moe_steps=2, moe_capacity=8.0, stages=4,
                  pipe_batch=8, microbatches=4, restore_shape=(1, 2))
# step 1's loss (relative) and gradients (of a leaf's largest |value|),
# later steps' losses, prefill logits and the pipeline (of the largest
# |value|), the restored run's losses against (a)'s
MESH_TRAIN_GATES = dict(loss1_rtol=1e-4, grad_share=1e-4, loss_rtol=1e-3,
                        prefill_share=1e-4, pipe_share=1e-4,
                        restore_rtol=1e-4)
MESH_TRAIN_TIMEOUT_S = 900
SCHED_REQUESTS, SCHED_SLOTS, SCHED_NEW = 8, 4, 32
PROFILE_STEPS = 16              # decode steps at a full ring, profiled
TIMING_REPS = 24                # calls per device time, on rotating inputs
COPY_ALTERNATIONS = 200         # page copy vs library call, in turn
PROFILE_TRIES = 3               # profiler sessions before a timing gives up
EVENT_TIMED: list = []          # timings taken by CUDA events instead


START = time.perf_counter()


def clock(phase: str) -> None:
    """A ``[clock]`` line: seconds since the script started, as ``phase``
    begins (the script's time limit is shared by every phase)."""
    say("clock", at=phase, s=f"{time.perf_counter() - START:.1f}")


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
    launches = {"flash_decode": fd.LAUNCHES["flash_decode"], **pg.LAUNCHES}
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
    cfg, params, res = run["cfg"], run["params"], run["res"]
    wall_ms, kinds = decode_split(
        torch, cfg, params, res.state,
        torch.from_numpy(res.tokens[-1]).to(params["embed"].device),
        PROFILE_STEPS)
    check(kinds["port_kernels"] > 0,
          f"the profile of the decode steps saw no port kernel: {kinds}")
    say("profile", decode_steps=PROFILE_STEPS,
        n_valid=min(res.state["cur"], res.state["k"].shape[2]),
        **split_fields(wall_ms, kinds),
        main_run_ms_per_step=f"{res.seconds * 1e3 / run['steps']:.3f}")


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
        blk = T.layer(params["blocks"], 0)
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


# --------------------------------------------- int8 caches, other families
def int8_phase(torch, run: dict) -> dict:
    """[int8]: the serving main path of h2o-danube-3-4b with
    ``kv_dtype="int8"`` (the serve phase's weights and settings), checked
    and measured; returns the int8 instance's row of the kernels line."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import page_gather as pg
    from repro_torch.launch.serve import serve

    kw = {k: v for k, v in SERVE.items() if k != "arch"}
    cfg = dataclasses.replace(run["cfg"], kv_dtype="int8")
    params, steps = run["params"], run["steps"]
    fd.reset_launches()
    pg.reset_launches()
    res = serve(params, cfg, **kw)
    launches = {**fd.LAUNCHES, **pg.LAUNCHES}
    check(launches["flash_decode_int8"] == steps * cfg.n_layers
          and launches["flash_decode"] == 0,
          f"int8 serving ran {launches}, not {steps} x {cfg.n_layers} "
          f"flash_decode_int8 launches and no float32 one")
    st = res.state
    check(st["k"].dtype == torch.int8 and st["k_scale"].dtype == torch.float16
          and bool(torch.isfinite(st["k_scale"].float()).all()),
          "the int8 run's caches are not int8 with finite float16 scales")
    check(res.tokens.shape == (steps, kw["batch"])
          and 0 <= res.tokens.min() and res.tokens.max() < cfg.vocab,
          "greedy tokens out of shape or range")
    stats = dict(res.tiered.stats, sim_ticks=res.tiered.sim_ticks)
    check(stats == TIERED_PIN,
          f"int8 tiered counters {stats} differ from the JAX pins")

    q, n = run["q"], run["n_valid"]
    layers = [(st["k"][i], st["v"][i], st["k_scale"][i], st["v_scale"][i])
              for i in range(cfg.n_layers)]
    errs = [decode_err(fd.flash_decode_int8(q, *c, n),
                       fd.flash_decode_int8_plain(q, *c, n)) for c in layers]
    worst = worst_of(errs)
    check(all(decode_within(e) for e in errs),
          f"flash_decode_int8 disagrees with its plain version on the run's "
          f"caches: {worst}")
    again = serve(params, cfg, **kw)
    check(np.array_equal(again.tokens, res.tokens),
          "two int8 greedy runs gave different tokens")
    check(dict(again.tiered.stats, sim_ticks=again.tiered.sim_ticks) == stats,
          "two int8 runs gave different tiered counters")
    del again

    # device time a call, rotating over the 24 layers' caches, beside the
    # float32 kernel on the float run's caches at the same step, the plain
    # version and the library call (dequantize + SDPA)
    nl = len(layers)
    fk, fv = run["res"].state["k"], run["res"].state["v"]
    ms = device_ms(torch, lambda i: fd.flash_decode_int8(q, *layers[i % nl], n),
                   match=KERNEL_NAMES["flash_decode"])
    float_ms = device_ms(torch, lambda i: fd.flash_decode(
        q, fk[i % nl], fv[i % nl], n), match=KERNEL_NAMES["flash_decode"])
    plain_ms = device_ms(torch, lambda i: fd.flash_decode_int8_plain(
        q, *layers[i % nl], n))

    def library(i):
        kc, vc, ks, vs = layers[i % nl]
        k = fd.dequantize(kc[:, :n], ks[:, :n]).transpose(1, 2)
        v = fd.dequantize(vc[:, :n], vs[:, :n]).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              enable_gqa=True)[:, :, 0]

    lib_ms = device_ms(torch, library)
    lib_err = float((library(0) - fd.flash_decode_int8_plain(
        q, *layers[0], n)[0]).abs().max())
    B, H, hd = q.shape
    KV = st["k"].shape[3]
    nbytes = (2 * B * n * KV * hd + 2 * 2 * B * n * KV
              + 4 * (2 * B * H * hd + 2 * B * H))
    flops = 4 * B * H * n * hd + 2 * B * n * KV * hd   # + the dequantization
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    say("int8", arch=cfg.name, kv_dtype="int8", steps=steps,
        batch=kw["batch"],
        tok_per_s=f"{kw['batch'] * steps / res.seconds:.1f}",
        ms_per_step=f"{res.seconds / steps * 1e3:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        tiered_vs_jax_pins="equal", greedy_tokens_second_run="identical",
        full_width_check=f"{nl}_layers_n_valid_{n}",
        max_out_err=f"{worst['out']:.3e}", max_m_err=f"{worst['m']:.3e}",
        max_l_rel_err=f"{worst['l_rel']:.3e}",
        first_tokens=json.dumps(res.tokens[:4].tolist(),
                                separators=(",", ":")))
    plan = fd.split_plan(n, hd, B * KV)
    say("int8", flash_decode_int8_us=f"{ms * 1e3:.3f}",
        flash_decode_float32_us=f"{float_ms * 1e3:.3f}",
        plain_us=f"{plain_ms * 1e3:.3f}",
        dequantize_sdpa_us=f"{lib_ms * 1e3:.3f}",
        bound_us=f"{max(t_bytes, t_ops) * 1e6:.3f}", cache_bytes=nbytes,
        sdpa_vs_plain_max_err=f"{lib_err:.3e}", ctas=plan.ctas,
        cluster=plan.cluster, max_active_clusters=fd.max_active_clusters(
            H // KV, hd, plan, int8=True))
    return {
        "name": "flash_decode_int8", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "launches": launches["flash_decode_int8"],
        "max_abs_err": worst["out"], "tolerance": DECODE_TOL,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "library": "fd.dequantize + F.scaled_dot_product_attention"
                   "(enable_gqa)",
        "float32_kernel_ms": float_ms,
        "shape": f"q {B}x{H}x{hd}, int8 caches {B}x{st['k'].shape[2]}x{KV}x"
                 f"{hd} with float16 scales (the run's, one layer a call), "
                 f"n_valid {n}",
        "timing": timing_note(),
    }


def decode_split(torch, cfg, params, state, tokens, steps: int):
    """``steps`` decode steps that go on from ``state`` (the caches are
    updated in place), timed on the host clock after as many to warm up,
    then as many more under the profiler: ``(host ms a step, device ms a
    step by kind)``."""
    from repro_torch.distributed.step import make_serve_step

    step = make_serve_step(cfg)
    carry = [state, tokens]

    def run():
        st, tok = carry
        for _ in range(steps):
            logits, st = step(params, st, tok)
            tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(
                torch.int32)
        torch.cuda.synchronize()
        carry[:] = [st, tok]

    run()                                                # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    own = tuple(KERNEL_NAMES.values())

    def enough(acts):
        return split_by_kind(acts, own, "port_kernels")["matmuls"] > 0

    kinds = {k: v / steps for k, v in split_by_kind(
        device_events(torch, run, enough), own, "port_kernels").items()}
    check(kinds["matmuls"] > 0,
          f"the profile of {cfg.name}'s decode steps saw no kernels: {kinds}")
    return wall_ms, kinds


def split_fields(wall_ms: float, kinds: dict) -> dict:
    """The fields of a profile line: host ms and device ms by kind a step,
    and the device's idle share of the host time."""
    busy = sum(kinds.values())
    return {"wall_ms_per_step": f"{wall_ms:.3f}",
            "device_busy_ms_per_step": f"{busy:.3f}",
            **{f"{k}_ms_per_step": f"{v:.4f}" for k, v in kinds.items()},
            "idle_share": f"{1 - busy / wall_ms:.4f}"}


def family_block(torch, dev, arch: str, layers, seed: int) -> None:
    """[families]: one model at full width (depth cut to ``layers`` where
    given; a cut never deepens the model, so a reduced configuration keeps
    its own depth): ``serve()`` twice, a prefill, decode against the
    prefill (or, for the MoE, its layer against the CPU), launches and a
    profile."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.distributed.step import make_prefill_step, make_serve_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import moe_ffn_local

    full = get_arch(arch)
    cfg = (dataclasses.replace(full, n_layers=min(layers, full.n_layers))
           if layers else full)
    attn = cfg.n_layers if cfg.n_heads else 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, torch_device=dev)
    torch.cuda.synchronize()
    param_gb = torch.cuda.memory_allocated() / 1e9
    init_s = time.perf_counter() - t0

    kw = dict(FAMILY_SERVE, seed=seed)
    steps = kw["prompt_len"] + kw["gen"]
    fd.reset_launches()
    res = serve(params, cfg, **kw)
    launches = fd.LAUNCHES["flash_decode"]
    check(launches == steps * attn,
          f"{cfg.name}: {launches} flash_decode launches, not {steps} steps "
          f"x {attn} attention layers")
    grid = (steps, kw["batch"]) + ((cfg.n_codebooks,) if cfg.n_codebooks
                                   else ())
    check(res.tokens.shape == grid and 0 <= res.tokens.min()
          and res.tokens.max() < cfg.vocab,
          f"{cfg.name}: greedy tokens out of shape or range")
    check((res.tiered is None) == (attn == 0),
          f"{cfg.name}: a tiered store where the model does not attend")
    again = serve(params, cfg, **kw)
    check(np.array_equal(again.tokens, res.tokens),
          f"{cfg.name}: two greedy runs gave different tokens")
    counters = [None if r.tiered is None else
                dict(r.tiered.stats, sim_ticks=r.tiered.sim_ticks)
                for r in (res, again)]
    check(counters[0] == counters[1],
          f"{cfg.name}: two runs gave different tiered counters")
    serve_s, again_s = res.seconds, again.seconds
    first = res.tokens[:2].tolist()
    del again

    split = split_fields(*decode_split(
        torch, cfg, params, res.state,
        torch.from_numpy(res.tokens[-1]).to(dev), FAMILY_PROFILE_STEPS))
    del res

    # prefill: one flash_attention launch an attention layer
    B, S = FAMILY_PREFILL["batch"], FAMILY_PREFILL["seq"]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    shape = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    tokens = torch.randint(0, cfg.vocab, shape, device=dev, generator=gen,
                           dtype=torch.int32)
    step = make_prefill_step(cfg, torch_device=dev)
    fa.reset_launches()
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_launches = fa.LAUNCHES["flash_attention"]
    check(prefill_launches == attn,
          f"{cfg.name}: prefill ran {prefill_launches} flash_attention "
          f"launches, not one an attention layer ({attn})")
    check(tuple(logits.shape) == shape + (cfg.padded_vocab,)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: prefill logits of shape {tuple(logits.shape)} or "
          f"not finite")
    head = logits[0, :PARITY_TOKENS].clone()
    del logits
    t0 = time.perf_counter()
    step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    if cfg.moe is None:
        # decode against the prefill: the first prompt, one token a step
        serve_step = make_serve_step(cfg)
        state = T.init_decode_state(params, cfg, 1, PARITY_TOKENS)
        dec = []
        for t in range(PARITY_TOKENS):
            lg, state = serve_step(params, state, tokens[:1, t])
            dec.append(lg[0])
        dec = torch.stack(dec)
        scale = float(head.abs().max())
        err = float((dec - head).abs().max())
        check(err <= PARITY_TOL * scale,
              f"{cfg.name}: prefill logits differ from {PARITY_TOKENS} "
              f"decode steps by {err:.3e}, over {PARITY_TOL} x {scale:.3f}")
        check(torch.equal(dec[..., :cfg.vocab].argmax(-1),
                          head[..., :cfg.vocab].argmax(-1)),
              f"{cfg.name}: prefill and decode disagree on the greedy tokens")
        parity = {"decode_parity_tokens": PARITY_TOKENS,
                  "decode_parity_max_err": f"{err:.3e}",
                  "max_logit": f"{scale:.3f}", "greedy_argmax": "equal"}
        del state, dec
    else:
        # a 2048-token prefill drops other assignments than a 1-token
        # decode, so the layer is held against the CPU on the same inputs
        moe = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        x = torch.randn(MOE_CHECK_TOKENS, cfg.d_model, device=dev,
                        generator=gen)
        with torch.no_grad():
            got, aux = moe_ffn_local(x, moe, cfg.moe)
            want, want_aux = moe_ffn_local(
                x.cpu(), {k: v.cpu() for k, v in moe.items()}, cfg.moe)
        err, _, ok = close_err(torch, got.cpu(), want, MOE_TOL)
        check(ok and abs(float(aux) - float(want_aux)) <= MOE_TOL["atol"],
              f"{cfg.name}: layer 0's moe_ffn_local on the card differs from "
              f"the CPU's by {err:.3e}")
        parity = {"moe_layer0_tokens": MOE_CHECK_TOKENS,
                  "moe_card_vs_cpu_max_err": f"{err:.3e}",
                  "moe_tol": json.dumps(MOE_TOL, separators=(",", ":"))}
        del moe, x, got, want
    say("families", arch=cfg.name, family=cfg.family,
        layers=f"{cfg.n_layers}/{full.n_layers}",
        cut="depth" if cfg.n_layers < full.n_layers else "none",
        param_gb=f"{param_gb:.2f}", init_s=f"{init_s:.2f}",
        batch=kw["batch"], steps=steps,
        tok_per_s=f"{kw['batch'] * steps / serve_s:.1f}",
        ms_per_step=f"{serve_s / steps * 1e3:.3f}",
        second_run_ms_per_step=f"{again_s / steps * 1e3:.3f}",
        flash_decode_launches=launches,
        tiered=json.dumps(counters[0], separators=(",", ":")),
        greedy_tokens_second_run="identical",
        prefill_tokens=f"{B}x{S}", prefill_ms=f"{prefill_ms:.3f}",
        flash_attention_launches=prefill_launches,
        peak_device_bytes=torch.cuda.max_memory_allocated(), **parity,
        first_tokens=json.dumps(first, separators=(",", ":")))
    say("families", arch=cfg.name, profile_steps=FAMILY_PROFILE_STEPS,
        **split)
    del params, tokens, head
    torch.cuda.empty_cache()


def families_phase(torch, dev, seed: int) -> None:
    """[families]: the moe, ssm, hybrid and audio families at full width."""
    for arch, layers in FAMILY_RUNS:
        family_block(torch, dev, arch, layers, seed)


# --------------------------------------------------------------- the vlm
def vlm_phase(torch, dev, seed: int) -> dict:
    """[vlm]: llama-3.2-vision-90b at full width, cut to
    ``VLM["super_blocks"]`` super-blocks: a prefill of ``batch x seq``
    tokens over a seeded frontend (one ``flash_attention`` launch a self
    and a cross layer), ``decode_steps`` decode steps on
    ``init_decode_state(frontend=...)`` (one ``flash_decode`` launch a
    self and a cross layer a step) against the prefill, and layer 0's
    cross kernels against their plain versions.  Returns the launches
    and errors that go into the two kernels' rows."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.distributed.step import make_prefill_step, make_serve_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    full = get_arch(VLM["arch"])
    cfg = dataclasses.replace(
        full, n_layers=VLM["super_blocks"] * full.cross_attn_every)
    n_cross = T.n_cross(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, torch_device=dev)
    params["cross"]["gate"].fill_(VLM["gate"])
    B, S, steps = VLM["batch"], VLM["seq"], VLM["decode_steps"]
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    frontend = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                           device=dev, generator=gen) * VLM["frontend_scale"]
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev, generator=gen,
                           dtype=torch.int32)
    torch.cuda.synchronize()
    param_gb = torch.cuda.memory_allocated() / 1e9
    init_s = time.perf_counter() - t0

    # the main path: a prefill, then decode steps, counts from 0
    prefill = make_prefill_step(cfg, torch_device=dev)
    batch = {"tokens": tokens, "frontend": frontend}
    fa.reset_launches()
    fd.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"vlm prefill logits of shape {tuple(logits.shape)} or not finite")
    head = logits[:, :steps].clone()
    del logits
    serve = make_serve_step(cfg)
    state = T.init_decode_state(params, cfg, B, steps, frontend=frontend)
    dec = []
    t0 = time.perf_counter()
    for t in range(steps):
        lg, state = serve(params, state, tokens[:, t])
        dec.append(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "flash_decode": fd.LAUNCHES["flash_decode"]}
    check(launches == {"flash_attention": cfg.n_layers + n_cross,
                       "flash_decode": steps * (cfg.n_layers + n_cross)},
          f"vlm launches {launches}: not one a self and a cross layer "
          f"({cfg.n_layers} + {n_cross}) in the prefill and in each of "
          f"{steps} decode steps")
    dec = torch.stack(dec, dim=1)
    scale = float(head.abs().max())
    err = float((dec - head).abs().max())
    check(bool(torch.isfinite(dec).all()) and err <= PARITY_TOL * scale,
          f"vlm prefill logits differ from {steps} decode steps by "
          f"{err:.3e}, over {PARITY_TOL} x {scale:.3f}")
    check(torch.equal(dec[..., :cfg.vocab].argmax(-1),
                      head[..., :cfg.vocab].argmax(-1)),
          "vlm prefill and decode disagree on the greedy tokens")
    del dec, head
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    # cross layer 0's kernels on its own tensors: its q of the embedded
    # prompt, its k / v of the frontend (the decode state's cross_k / v)
    with torch.no_grad():
        blk = T.layer(params["cross"], 0)
        x = L.embed_tokens(params["embed"], tokens.long())
        q, k, v = T.cross_inputs(x, frontend, blk, cfg)
        check(torch.equal(k, state["cross_k"][0])
              and torch.equal(v, state["cross_v"][0]),
              "the decode state's cross keys are not cross layer 0's")
        fa_err, _, ok = close_err(
            torch, fa.flash_attention(q, k, v, causal=False),
            fa.flash_attention_plain(q, k, v, causal=False), PREFILL_TOL)
        check(ok, f"cross flash_attention disagrees with its plain version "
                  f"at {B}x{S} over {cfg.n_frontend_tokens} keys: {fa_err:.3e}")
        q1 = q[:, 0].contiguous()
        fd_err = decode_err(fd.flash_decode(q1, k, v, k.shape[1]),
                            fd.flash_decode_plain(q1, k, v, k.shape[1]))
        check(decode_within(fd_err),
              f"cross flash_decode disagrees with its plain version at T = "
              f"{k.shape[1]}: {fd_err}")
        plan = fd.split_plan(k.shape[1], cfg.resolved_head_dim,
                             B * cfg.n_kv_heads)
    say("vlm", arch=cfg.name, layers=f"{cfg.n_layers}/{full.n_layers}",
        cross_layers=f"{n_cross}/{T.n_cross(full)}", cut="depth",
        param_gb=f"{param_gb:.2f}", init_s=f"{init_s:.2f}",
        gate=VLM["gate"], frontend=f"{B}x{cfg.n_frontend_tokens}x"
                                   f"{cfg.d_model}",
        prefill_tokens=f"{B}x{S}", first_prefill_ms=f"{first_prefill_ms:.3f}",
        prefill_ms=f"{prefill_ms:.3f}", decode_steps=steps,
        ms_per_step=f"{decode_s / steps * 1e3:.3f}",
        tok_per_s=f"{B * steps / decode_s:.1f}",
        launches=json.dumps(launches, separators=(",", ":")),
        decode_parity_max_err=f"{err:.3e}", max_logit=f"{scale:.3f}",
        greedy_argmax="equal",
        cross_flash_attention_max_abs_err=f"{fa_err:.3e}",
        cross_flash_decode_err=json.dumps(fd_err, separators=(",", ":")),
        cross_decode_plan=f"{plan.cluster}x{plan.rows}/{plan.chunk}",
        peak_device_bytes=torch.cuda.max_memory_allocated())
    del params, state, frontend, tokens, q, k, v, x
    torch.cuda.empty_cache()
    return {"launches": launches, "fa_err": fa_err, "fd_err": fd_err}


# ------------------------------------------------------------- training
def train_kernel_checks(torch, dev, seed: int) -> dict:
    """[train]: the ``lse`` instance of ``flash_attention`` and the three
    backward kernels against their plain versions over ``BWD_CHECKS``;
    the ``lse`` instance's out bit-equal to the inference instance's.
    Returns each kernel's largest error."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    B, KV = 2, 2
    worst = dict.fromkeys(("flash_attention_lse",) + tuple(BWD_KERNELS), 0.0)
    bad = []
    for hd, g, mode in BWD_CHECKS:
        S, Skv, causal, window = BWD_MODES[mode]
        kw = dict(causal=causal, window=window)
        q = torch.randn(B, S, KV * g, hd, device=dev, generator=gen)
        k, v = (torch.randn(B, Skv, KV, hd, device=dev, generator=gen)
                for _ in range(2))
        do = torch.randn(B, S, KV * g, hd, device=dev, generator=gen)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        if not torch.equal(out, fa.flash_attention(q, k, v, **kw)):
            bad.append((hd, g, mode, "lse instance's out differs"))
        _, want_lse = fa.flash_attention_lse_plain(q, k, v, **kw)
        pairs = [("flash_attention_lse", lse, want_lse, PREFILL_TOL),
                 ("flash_attention_bwd_delta",
                  fa.flash_attention_bwd_delta(out, do),
                  fa.flash_attention_bwd_delta_plain(out, do), PREFILL_TOL)]
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        pairs += [("flash_attention_bwd_dq", got[0], want[0], BWD_TOL),
                  ("flash_attention_bwd_dkdv", got[1], want[1], BWD_TOL),
                  ("flash_attention_bwd_dkdv", got[2], want[2], BWD_TOL)]
        for name, a, b, tol in pairs:
            err, _, ok = close_err(torch, a, b, tol)
            worst[name] = max(worst[name], err)
            if not ok:
                bad.append((hd, g, mode, name, err))
    check(not bad, f"training kernels disagree with their plain versions: "
                   f"{bad}")
    say("train", checks=len(BWD_CHECKS), B=B, KV=KV,
        hd=listed(c[0] for c in BWD_CHECKS), G=listed(c[1] for c in BWD_CHECKS),
        masks=json.dumps({m: dict(zip(("S", "Skv", "causal", "window"), c))
                          for m, c in BWD_MODES.items()},
                         separators=(",", ":")),
        lse_out="bit-equal to the inference instance",
        **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in worst.items()},
        bwd_tol=json.dumps(BWD_TOL, separators=(",", ":")))
    return worst


def train_split(acts) -> dict:
    """Device ms of a training step's events by kind."""
    kinds = {"matmuls": 0.0, "attention_forward": 0.0,
             "attention_backward": 0.0, "other_kernels": 0.0, "copies": 0.0}
    for e in acts:
        if "flash_attention_bwd" in e.name:
            kind = "attention_backward"
        elif PREFILL_KERNEL in e.name:
            kind = "attention_forward"
        elif e.name.startswith(("Memcpy", "Memset")):
            kind = "copies"
        elif any(k in e.name.lower() for k in ("gemm", "gemv", "splitk")):
            kind = "matmuls"
        else:
            kind = "other_kernels"
        kinds[kind] += e.device_time_total / 1e3
    return kinds


def cut_against_cpu(torch, dev, seed: int) -> dict:
    """One train step of the 2-layer cut of minicpm-2b at full width on
    the card and on the CPU port, from the same seeded state and batch
    (int8 moments, compressed gradients): loss, every gradient, the
    updated parameters and moment codes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.distributed.step import make_grad_fn, make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, compress_init
    from repro_torch.optim.schedules import wsd_schedule
    from repro_torch.tree import tree_paths

    c = TRAIN_CUT
    cfg = dataclasses.replace(get_arch(TRAIN["arch"]), n_layers=c["layers"])
    batch = ShardedLoader(cfg, c["seq"], c["batch"], seed=seed + 3).next()
    card = init_params(cfg, seed, torch_device=dev)
    cpu = {k: (v.to("cpu", copy=True) if torch.is_tensor(v) else
               {n: t.to("cpu", copy=True) for n, t in v.items()})
           for k, v in card.items()}
    out = {}
    for where, params in (("card", card), ("cpu", cpu)):
        on = params["embed"].device
        t0 = time.perf_counter()
        loss, grads = make_grad_fn(cfg, remat=True)(
            params, {k: torch.as_tensor(v, device=on)
                     for k, v in batch.items()})
        step = make_train_step(
            cfg, lr_fn=wsd_schedule(c["lr"], 2, 4, 4),
            adamw_cfg=AdamWConfig(moment_dtype="int8"), compress_grads=True)
        opt = adamw_init(params, "int8")
        params, opt, step_loss, comp = step(params, opt, batch, 3,
                                            compress_init(params))
        if on.type == "cuda":
            torch.cuda.synchronize()
        out[where] = dict(loss=float(loss), step_loss=float(step_loss),
                          grads=grads, params=params, opt=opt, comp=comp,
                          seconds=time.perf_counter() - t0)
    a, b = out["card"], out["cpu"]
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    check(loss_err <= 1e-4,
          f"cut: the card's loss {a['loss']} against the CPU's {b['loss']}")
    grad_share = 0.0
    for (name, g), (_, w) in zip(tree_paths(a["grads"]),
                                 tree_paths(b["grads"])):
        share = float((g.cpu() - w).abs().max() / w.abs().max().clamp(
            min=1e-30))
        grad_share = max(grad_share, share)
        check(share <= GRAD_SHARE_TOL,
              f"cut: gradient {name} on the card differs from the CPU's by "
              f"{share:.3e} of its largest element")
    moved = total = 0
    param_max = 0.0
    for (name, p), (_, w) in zip(tree_paths(a["params"]),
                                 tree_paths(b["params"])):
        d = (p.cpu() - w).abs()
        moved += int((d > 1e-5).sum())
        total += d.numel()
        param_max = max(param_max, float(d.max()))
    check(param_max <= 2.2 * c["lr"] and moved <= 1e-4 * total,
          f"cut: updated parameters differ by up to {param_max:.3e} "
          f"({moved} of {total} beyond 1e-5)")
    codes = diff_codes = 0
    for key in ("mu_q", "nu_q"):
        for (_, q), (_, w) in zip(tree_paths(a["opt"][key]),
                                  tree_paths(b["opt"][key])):
            diff_codes += int((q.cpu() != w).sum())
            codes += q.numel()
    check(diff_codes <= 2e-3 * codes,
          f"cut: {diff_codes} of {codes} int8 moment codes differ")
    say("train", cut=f"{cfg.n_layers}/{TRAIN_LAYERS_FULL} layers",
        batch=f"{c['batch']}x{c['seq']}", moments="int8", compress="on",
        lr=c["lr"], loss_card=f"{a['loss']:.6f}", loss_cpu=f"{b['loss']:.6f}",
        loss_rel_err=f"{loss_err:.3e}",
        grad_max_err_share_of_largest=f"{grad_share:.3e}",
        grad_tol=GRAD_SHARE_TOL, param_max_abs_err=f"{param_max:.3e}",
        params_beyond_1e_5=f"{moved}/{total}",
        int8_codes_differing=f"{diff_codes}/{codes}",
        card_s=f"{a['seconds']:.2f}", cpu_s=f"{b['seconds']:.2f}")
    del out, card, cpu, a, b
    torch.cuda.empty_cache()
    return {"grad_share": grad_share, "param_max": param_max}


def resume_against_uninterrupted(torch, dev, seed: int, ckpt: Path) -> dict:
    """``launch/train.main`` on the 2-layer cut: 6 steps checkpointed
    every 4 (and at the end) into ``ckpt``, the last checkpoint removed
    and the run resumed from step 4: its 2 losses against the
    uninterrupted run's."""
    import shutil

    from repro_torch.launch.train import main as train_main

    r = TRAIN_RESUME
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--arch", TRAIN["arch"], "--n-layers", str(r["layers"]),
            "--steps", str(r["steps"]), "--batch", str(r["batch"]),
            "--seq", str(r["seq"]), "--ckpt-every", str(r["every"]),
            "--lr", r["lr"], "--moment-dtype", r["moments"],
            "--seed", str(seed), "--log-every", "100", "--device", str(dev),
            "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    full = train_main(args)
    full_s = time.perf_counter() - t0
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt.glob("step_*"))
    check(steps == [r["every"], r["steps"]],
          f"resume: checkpoints at steps {steps}")
    shutil.rmtree(ckpt / f"step_{r['steps']:08d}")
    t0 = time.perf_counter()
    resumed = train_main(args + ["--resume"])
    resumed_s = time.perf_counter() - t0
    want = full.losses[r["every"]:]
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, want))
    check(resumed.start_step == r["every"] and len(resumed.losses) == len(want)
          and err <= 1e-5 and all(np.isfinite(full.losses)),
          f"resume: losses {resumed.losses} from step {resumed.start_step} "
          f"against {want}")
    shutil.rmtree(ckpt, ignore_errors=True)
    say("train", resume=f"{r['every']}+{r['steps'] - r['every']} against "
                        f"{r['steps']}", layers=r["layers"],
        batch=f"{r['batch']}x{r['seq']}", moments=r["moments"],
        losses=json.dumps([round(x, 6) for x in full.losses]),
        resumed_losses=json.dumps([round(x, 6) for x in resumed.losses]),
        max_rel_err=f"{err:.3e}",
        equal="bit-equal" if resumed.losses == want else "within 1e-5",
        full_run_s=f"{full_s:.2f}", resumed_run_s=f"{resumed_s:.2f}")
    del full, resumed
    torch.cuda.empty_cache()
    return {"resume_err": err}


def layer0_qkv(torch, dev, cfg, params, batch) -> tuple:
    """Layer 0's attention q, k and v of ``batch``, as the forward makes
    them."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    blk = T.layer(params["blocks"], 0)
    h = L.rms_norm(L.embed_tokens(params["embed"], tokens), blk["ln1"],
                   cfg.norm_eps)
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    return T.attention_inputs(h, blk, cfg, positions)


def profiled_ms(torch, fn, reps: int, sessions: int = 2) -> dict:
    """Device ms a call of ``fn()`` from ``sessions`` profiler sessions of
    ``reps`` calls each, every kernel, copy and memset of the call
    counted, with the events each session saw a call (a session that
    drops events reads as less time and fewer events).  A session that
    records nothing in ``PROFILE_TRIES`` tries is timed by CUDA events
    instead (its events a call None), as ``device_ms`` does."""
    fn()
    torch.cuda.synchronize()
    out, names = [], set()
    for _ in range(sessions):
        acts = device_events(torch, lambda: [fn() for _ in range(reps)],
                             lambda a: bool(a))
        if not acts:
            # as device_ms: timed by CUDA events instead, and said so
            EVENT_TIMED.append("a library call")
            say("timing", fallback="CUDA events", what="a library call",
                reason=f"the profiler recorded no device activity in "
                       f"{PROFILE_TRIES} sessions")
            out.append((cuda_ms(torch, fn, reps=reps), None))
            continue
        out.append((sum(e.device_time_total for e in acts) / reps / 1e3,
                    len(acts) / reps))
        names |= {e.name[:48] for e in acts}
    return {"ms": [round(m, 4) for m, _ in out],
            "events_a_call": [n for _, n in out], "names": sorted(names)}


def fullest_ms(prof: dict) -> float:
    """A ``profiled_ms`` result's time from its session that saw the most
    events a call (a session that drops events reads low); the last of
    equals, and the last session when none was profiled."""
    seen = [(n, i) for i, n in enumerate(prof["events_a_call"])
            if n is not None]
    return prof["ms"][max(seen)[1] if seen else -1]


def whole_sessions(prof: dict) -> bool:
    """Whether every session of a ``profiled_ms`` result was profiled and
    saw the same whole number of events a call (a session that drops
    events reads a fraction a call, or fewer than another)."""
    n = prof["events_a_call"]
    return None not in n and len(set(n)) == 1 and float(n[0]).is_integer()


def ratio(a: float, b: float) -> float:
    """``a / b``, NaN where ``b`` is not positive (a time that read as
    none)."""
    return a / b if b > 0 else float("nan")


def train_kernel_rows(torch, dev, seed: int, q, k, v, launches: dict,
                      sweep: dict) -> list:
    """The ``lse`` instance and the three backward kernels at the main
    path's shapes (layer 0's ``q`` / ``k`` / ``v``, causal, and a seeded
    dO): each against its plain version on the same tensors (the
    forward's evaluated in float64; the ``lse`` instance's out also
    bit-equal to the inference instance's), its
    device time beside its bound, its plain version and a library call.
    The kernels' times and the library's are taken by the profiler (every
    kernel of a library call counted) and, as a cross-check, by CUDA
    events.  Returns the four rows of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    do = torch.randn(q.shape, device=dev, generator=gen)
    out, lse = fa.flash_attention_lse(q, k, v)
    check(torch.equal(out, fa.flash_attention(q, k, v)),
          "at layer 0's shape the lse instance's out differs from the "
          "inference instance's")
    # the forward against its plain version evaluated in float64: at a
    # trained layer's scores the float32 plain version's own rounding is
    # most of the tolerance (its distance is reported beside)
    want_out, want_lse = fa.flash_attention_lse_plain(q, k, v)
    ref_out, ref_lse = fa.flash_attention_lse_plain(
        *(x.double() for x in (q, k, v)))
    plain32 = {"plain_float32_vs_float64": close_err(
        torch, want_out, ref_out, PREFILL_TOL)[:2],
        "kernel_vs_plain_float32": close_err(
        torch, out, want_out, PREFILL_TOL)[:2]}
    delta = fa.flash_attention_bwd_delta(out, do)
    want_delta = fa.flash_attention_bwd_delta_plain(out, do)
    lib_delta = lambda: torch.einsum("bshd,bshd->bhs", do, out)  # noqa: E731
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    # the backward likewise against its plain version in float64, on the
    # kernels' own out and lse (the float32 plain's distance beside)
    want = fa.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, out, lse, do)))
    want32 = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), want32, want):
        plain32[f"bwd_{name}_plain_float32_vs_float64"] = close_err(
            torch, a, b, BWD_TOL)[:2]
    for name, a, b in zip(("dq", "dk", "dv"), got, want32):
        plain32[f"bwd_{name}_kernel_vs_plain_float32"] = close_err(
            torch, a, b, BWD_TOL)[:2]
    del want32
    pairs = [("flash_attention_lse", out, ref_out, PREFILL_TOL),
             ("flash_attention_lse", lse, ref_lse, PREFILL_TOL),
             ("flash_attention_bwd_delta", delta, want_delta, PREFILL_TOL),
             ("library_delta", lib_delta(), want_delta, PREFILL_TOL),
             ("flash_attention_bwd_dq", got[0], want[0], BWD_TOL),
             ("flash_attention_bwd_dkdv", got[1], want[1], BWD_TOL),
             ("flash_attention_bwd_dkdv", got[2], want[2], BWD_TOL)]
    err, share, bad = {}, {}, []
    for name, a, b, tol in pairs:
        e, sh, ok = close_err(torch, a, b, tol)
        err[name], share[name] = max(err.get(name, 0.0), e), max(
            share.get(name, 0.0), sh)
        if not ok:
            bad.append((name, e, sh))
    check(not bad, f"at layer 0's shape the training kernels disagree with "
                   f"their plain versions: {bad}")
    del want, want_out, want_lse, ref_out, ref_lse, want_delta, got, delta
    torch.cuda.empty_cache()

    reps = PREFILL_TIMING_REPS
    ms = {"flash_attention_lse": device_ms(
        torch, lambda i: fa.flash_attention_lse(q, k, v), reps=reps,
        match=PREFILL_KERNEL)}
    ms["flash_attention_bwd_delta"] = device_ms(
        torch, lambda i: fa.flash_attention_bwd_delta(out, do), reps=reps,
        match=BWD_KERNELS["flash_attention_bwd_delta"])
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        ms[name] = device_ms(
            torch, lambda i: fa.flash_attention_bwd(q, k, v, out, lse, do),
            reps=reps, match=BWD_KERNELS[name])

    def events_ms(fn, n):
        fn()
        return cuda_ms(torch, fn, reps=n)

    # the plain versions (many kernels each) by CUDA events after a warm
    # call, host gaps included
    plain = {"flash_attention_lse": events_ms(
        lambda: fa.flash_attention_lse_plain(q, k, v), 2),
        "flash_attention_bwd_delta": events_ms(
            lambda: fa.flash_attention_bwd_delta_plain(out, do), reps)}
    plain["flash_attention_bwd_dkdv"] = plain["flash_attention_bwd_dq"] = \
        events_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, do), 2)
    # the library: einsum for delta; SDPA's forward; autograd through SDPA
    # less its forward.  Profiler (two sessions) and events, one run.
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    gqa = q.shape[2] != k.shape[2]         # minicpm-2b: G = 1, no flag

    def sdpa_fwd():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=gqa)

    def sdpa_both():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=gqa)
        torch.autograd.grad(o, leaves, dot)

    def ours_bwd():
        fa.flash_attention_bwd(q, k, v, out, lse, do)

    prof = {name: profiled_ms(torch, fn, reps) for name, fn in (
        ("delta", lib_delta), ("sdpa_forward", sdpa_fwd),
        ("sdpa_forward_backward", sdpa_both), ("ours_backward", ours_bwd))}
    ev = {name: events_ms(fn, reps) for name, fn in (
        ("delta", lib_delta), ("sdpa_forward", sdpa_fwd),
        ("sdpa_forward_backward", sdpa_both), ("ours_backward", ours_bwd),
        ("ours_lse", lambda: fa.flash_attention_lse(q, k, v)))}

    def lib_ms(*names):
        # by the profiler where every session of each term saw whole
        # calls, else every term by CUDA events: like from like
        if all(whole_sessions(prof[n]) for n in names):
            return [fullest_ms(prof[n]) for n in names], "profiler"
        return [ev[n] for n in names], "CUDA events"

    (lib_delta_ms,), delta_by = lib_ms("delta")
    (lib_fwd,), fwd_by = lib_ms("sdpa_forward")
    (lib_both, lib_fwd_b), bwd_by = lib_ms("sdpa_forward_backward",
                                           "sdpa_forward")
    lib_bwd = lib_both - lib_fwd_b
    ours_triple_by = ours_triple = sum(ms[n] for n in BWD_KERNELS)
    if bwd_by != "profiler":
        ours_triple_by = ev["ours_backward"]
    B, S, H, hd = q.shape
    pairs_live = S * (S + 1) // 2 * B * H          # live (q, k) pairs, causal
    n_q, n_kv, n_row = q.numel(), k.numel(), B * H * S
    work = {  # (flops of the float32 products, other flops, bytes)
        "flash_attention_lse": (4 * hd * pairs_live, 0,
                                4 * (2 * n_q + 2 * n_kv + n_row)),
        "flash_attention_bwd_delta": (0, 2 * n_q, 4 * (2 * n_q + n_row)),
        "flash_attention_bwd_dkdv": (8 * hd * pairs_live, 0,
                                     4 * (2 * n_q + 4 * n_kv + 2 * n_row)),
        "flash_attention_bwd_dq": (6 * hd * pairs_live, 0,
                                   4 * (3 * n_q + 2 * n_kv + 2 * n_row)),
    }
    rows = []
    for name, (mma, flops, nbytes) in work.items():
        # float32 products at float32 accuracy: split TF32 on the tensor
        # cores, 3 products each, the least time the card has for them
        t_ops = TF32_SPLIT_TERMS * mma / TF32_FLOPS_PER_S + \
            flops / FP32_FLOPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        lse_row = name == "flash_attention_lse"
        row = {
            "name": name, "route": "cuda",
            "source": PREFILL_SOURCE if lse_row else TRAIN_SOURCE,
            "replaces": (LSE_REPLACES + " (_flash_fwd, jnp; no Pallas kernel)"
                         if lse_row else TRAIN_REPLACES +
                         " (_flash_bwd, jnp; no Pallas kernel)"),
            "launches": launches[name], "max_abs_err": err[name],
            "max_err_share_of_tolerance": share[name],
            "reference": ("the plain version (float32)"
                          if name.endswith("delta") else
                          "the plain version evaluated in float64" if lse_row
                          else "the plain version evaluated in float64"),
            "sweep_max_abs_err": sweep[name],
            "tolerance": PREFILL_TOL if name in (
                "flash_attention_lse", "flash_attention_bwd_delta")
            else BWD_TOL,
            "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (lib_fwd if lse_row else lib_delta_ms if
                           name.endswith("delta") else lib_bwd),
            "library_timed_by": (fwd_by if lse_row else delta_by if
                                 name.endswith("delta") else bwd_by),
            "shape": f"q {B}x{S}x{H}x{hd}, k/v {B}x{S}x{k.shape[2]}x{hd}"
                     f" (layer 0 of the run), causal",
            "timing": timing_note() + "; the library likewise, every kernel "
                                      "of its call, where each profiler "
                                      "session saw whole calls, else by CUDA "
                                      "events (library_timed_by); the plain "
                                      "version by CUDA events, host gaps "
                                      "included",
        }
        if mma:
            row["bound_note"] = "3 x the product flops (split TF32) over " \
                                "TF32's peak"
        if lse_row:
            row["library"] = "F.scaled_dot_product_attention(is_causal=True)"
        elif name.endswith("delta"):
            row["library"] = "torch.einsum('bshd,bshd->bhs', dout, out)"
        else:
            row["library"] = ("torch.autograd.grad through "
                              "F.scaled_dot_product_attention(is_causal=True)"
                              " less its forward: dq, dk and dv together")
            row["plain_note"] = "the whole plain backward (dq, dk, dv)"
            row["fp32_fma_bound_ms"] = mma / FP32_FLOPS_PER_S * 1e3
        rows.append(row)
    say("train", kernels_at="layer 0's shape", lse_out="bit-equal to the "
        "inference instance",
        **{f"{n}_max_abs_err": f"{e:.3e}" for n, e in err.items()},
        **{f"{n}_share_of_tol": f"{e:.3f}" for n, e in share.items()},
        forward_reference="float64", backward_reference="float64",
        **{f"{n}_max_abs_err_share": f"{e:.3e},{sh:.3f}"
           for n, (e, sh) in plain32.items()})
    say("train", **{f"{r['name']}_ms": f"{r['ms']:.4f}" for r in rows},
        **{f"{r['name']}_bound_ms": f"{r['bound_ms']:.4f}" for r in rows},
        **{f"{r['name']}_plain_ms": f"{r['plain_ms']:.4f}" for r in rows},
        **{f"{r['name']}_fp32_fma_bound_ms": f"{r['fp32_fma_bound_ms']:.4f}"
           for r in rows if "fp32_fma_bound_ms" in r},
        library_delta_ms=f"{lib_delta_ms:.4f}",
        sdpa_forward_ms=f"{lib_fwd_b:.4f}",
        sdpa_forward_backward_ms=f"{lib_both:.4f}",
        sdpa_backward_ms=f"{lib_bwd:.4f}", sdpa_timed_by=bwd_by,
        ours_backward_ms=f"{ours_triple_by:.4f}",
        backward_over_sdpa=f"{ratio(ours_triple_by, lib_bwd):.3f}")
    ev_sdpa_bwd = ev["sdpa_forward_backward"] - ev["sdpa_forward"]
    say("train", timing="the library and our backward, both ways",
        profiler=json.dumps(prof, separators=(",", ":")),
        events_ms=json.dumps({n: round(x, 4) for n, x in ev.items()},
                             separators=(",", ":")),
        backward_over_sdpa_events=f"{ratio(ev['ours_backward'], ev_sdpa_bwd):.3f}")
    del out, lse, do, leaves, qt, kt, vt, dot
    return rows


def mesh_runs(seed: int) -> dict:
    """[mesh]'s runs: ``(config, steps, resident_experts)`` by label, and
    the seeded tokens (steps, batch) each feeds."""
    import dataclasses

    from repro_torch.configs import get_arch

    dense = get_arch(MESH["arch"])
    full = get_arch(MESH["moe_arch"])
    moe = dataclasses.replace(
        full, n_layers=MESH["moe_layers"],
        moe=dataclasses.replace(full.moe,
                                capacity_factor=MESH["moe_capacity"]))
    runs = {"float32": (dense, MESH["steps"], False),
            "int8": (dataclasses.replace(dense, kv_dtype="int8"),
                     MESH["int8_steps"], False),
            "moe_tp": (moe, MESH["moe_steps"], False),
            "moe_resident": (moe, MESH["moe_steps"], True)}
    rng = np.random.default_rng(seed + 32)
    tokens = {k: rng.integers(0, cfg.vocab, (steps, MESH["batch"]))
              for k, (cfg, steps, _) in runs.items() if k != "moe_resident"}
    tokens["moe_resident"] = tokens["moe_tp"]   # one reference for both
    return {"runs": runs, "tokens": tokens}


CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


def mesh_one_device(torch, cfg, seed: int, tokens: np.ndarray) -> dict:
    """The one-device decode of ``tokens`` on the card, the reference of a
    mesh run: its logits on the host, ms a step, peak device bytes, and
    for int8 caches the final caches on the host."""
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed)
    state = T.init_decode_state(params, cfg, tokens.shape[1],
                                MESH["context"])
    step = make_serve_step(cfg)
    toks = torch.as_tensor(tokens, device="cuda")
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(len(toks)):
        logits, state = step(params, state, toks[t])
        out.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"logits": torch.stack(out).cpu(),
           "ms_per_step": wall / len(toks) * 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if "k_scale" in state:
        res["final"] = {k: state[k].cpu() for k in CACHE_KEYS}
    del params, state, out
    torch.cuda.empty_cache()
    return res


def mesh_from_caches(torch, cfg, seed: int, held: dict,
                     tokens: np.ndarray) -> dict:
    """For each step ``cur`` of ``held`` (its caches on the host), one
    one-device decode step from those caches: its logits on the host."""
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    params = T.init_params(cfg, seed)
    out = {}
    for cur, caches in held.items():
        state = {"cur": cur, **{k: v.cuda() for k, v in caches.items()}}
        logits, _ = T.decode_step(params, cfg, state,
                                  torch.as_tensor(tokens[cur], device="cuda"))
        out[cur] = logits.cpu()
        del state
    del params
    torch.cuda.empty_cache()
    return out


def mesh_rank_run(torch, cfg, mesh, params, tokens: np.ndarray, steps: int,
                  resident: bool, seed: int) -> dict:
    """One run of the sharded serve step on this rank: its logits, the
    kernel launches against the (step, layer) pairs whose shard holds a
    valid slot, ms a step, and each layer's partial against its plain
    version on this rank's final caches; for int8 caches also the caches
    before each held step, and after the last."""
    from repro_torch.distributed import step as S
    from repro_torch.distributed.collectives import axis_index, axis_size
    from repro_torch.distributed.decode import shard_fill
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import kv_cache_len

    state = S.init_local_decode_state(cfg, mesh, MESH["batch"],
                                      MESH["context"])
    serve_step = S.make_serve_step(cfg, mesh, resident_experts=resident)
    toks = torch.as_tensor(tokens, device="cuda")
    quant = "k_scale" in state
    res = {}
    fd.reset_launches()
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        if quant and t in MESH["int8_held"]:
            res.setdefault("held", {})[t] = {
                k: state[k].to("cpu", copy=True) for k in CACHE_KEYS}
        logits, state = serve_step(params, state, toks[t])
        out.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fd.LAUNCHES)
    if quant:
        res["final"] = {k: state[k].cpu() for k in CACHE_KEYS}
    ring = kv_cache_len(cfg, MESH["context"])
    n_tp, tpi = axis_size(mesh, "model"), axis_index(mesh, "model")
    filled = sum(shard_fill(cur, ring, n_tp, tpi) >= 1
                 for cur in range(steps))
    n_loc = shard_fill(steps - 1, ring, n_tp, tpi)
    errs = []
    if n_loc:
        B, H, hd = state["k"].shape[1], cfg.n_heads, cfg.resolved_head_dim
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        q = torch.randn((B, H, hd), generator=gen, device="cuda")
        for i in range(cfg.n_layers):
            args = (q, state["k"][i], state["v"][i])
            if quant:
                args += (state["k_scale"][i], state["v_scale"][i])
                pair = (fd.flash_decode_int8, fd.flash_decode_int8_plain)
            else:
                pair = (fd.flash_decode, fd.flash_decode_plain)
            errs.append(decode_err(pair[0](*args, n_loc),
                                   pair[1](*args, n_loc)))
    return dict(res, logits=torch.stack(out).cpu(), launches=launches,
                pairs=filled * cfg.n_layers, ms_per_step=wall / steps * 1e3,
                n_local_last=n_loc,
                kernel_err=worst_of(errs) if errs else None)


def mesh_gather(torch, blocks: dict) -> dict:
    """Cache blocks by (data, model) coordinates put together: batch over
    data (dimension 1), slots over model (dimension 2)."""
    shape = MESH["shape"]
    return {k: torch.cat([torch.cat([blocks[(d, t)][k]
                                     for t in range(shape[1])], dim=2)
                          for d in range(shape[0])], dim=1)
            for k in CACHE_KEYS}


def mesh_rank(rank: int, seed: int) -> dict:
    """A rank of [mesh] (run by ``run_local_ranks``): its blocks of each
    run's weights, drawn as the one-device run draws them, then the runs."""
    import torch

    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(0)
    mesh = make_debug_mesh(*MESH["shape"])
    coords = mesh_coords(mesh)
    b_loc = MESH["batch"] // MESH["shape"][0]
    rows = slice(coords["data"] * b_loc, (coords["data"] + 1) * b_loc)
    plan = mesh_runs(seed)
    out = {"coords": coords, "runs": {}}
    params, layout = None, None
    torch.cuda.reset_peak_memory_stats()
    for label, (cfg, steps, resident) in plan["runs"].items():
        specs = S.serve_param_specs(cfg, mesh, resident_experts=resident)
        if (cfg.name, repr(specs)) != layout:
            params = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = S.init_local_params(cfg, seed, mesh, specs)
            torch.cuda.synchronize()
            out[f"init_s_{cfg.name}"] = time.perf_counter() - t0
            out[f"param_bytes_{cfg.name}"] = torch.cuda.memory_allocated()
            layout = (cfg.name, repr(specs))
        out["runs"][label] = mesh_rank_run(
            torch, cfg, mesh, params, plan["tokens"][label][:, rows], steps,
            resident, seed)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mesh_phase(torch, seed: int) -> dict:
    """[mesh]: the serve step on a 2 x 2 mesh of four processes on this
    card, each run held against the one-device decode of the same weights
    and tokens (run here first); each rank's partials against the plain
    version; launches equal to the (step, layer) pairs with a non-empty
    shard."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_local_ranks

    plan = mesh_runs(seed)
    ref = {}
    for label, (cfg, steps, _) in plan["runs"].items():
        if label == "moe_resident":          # the same weights and tokens
            ref[label] = ref["moe_tp"]
            continue
        ref[label] = mesh_one_device(torch, cfg, seed, plan["tokens"][label])
    torch.cuda.empty_cache()
    say("mesh", parent_allocated_bytes=torch.cuda.memory_allocated())
    work = tempfile.mkdtemp(prefix="mesh-")
    t0 = time.perf_counter()
    try:
        ranks = run_local_ranks(mesh_rank, MESH["shape"][0] * MESH["shape"][1],
                                work, args=(seed,), timeout_s=MESH_TIMEOUT_S)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in ranks}
    totals = {"flash_decode": 0, "flash_decode_int8": 0}
    for label, (cfg, steps, resident) in plan["runs"].items():
        runs = {k: r["runs"][label] for k, r in by.items()}
        for k, run in runs.items():
            name = "flash_decode_int8" if cfg.kv_dtype == "int8" \
                else "flash_decode"
            check(run["launches"][name] == run["pairs"]
                  and sum(run["launches"].values()) == run["pairs"],
                  f"[mesh] {label} rank {k}: launches {run['launches']}, "
                  f"not the {run['pairs']} (step, layer) pairs with a "
                  "non-empty shard")
            totals[name] += run["launches"][name]
            if run["kernel_err"] is not None:
                check(decode_within(run["kernel_err"]),
                      f"[mesh] {label} rank {k}: {name} against its plain "
                      f"version {run['kernel_err']}")
        got = torch.cat([runs[(d, 0)]["logits"]
                         for d in range(MESH["shape"][0])], dim=1)
        tp_equal = all(torch.equal(runs[(d, 0)]["logits"],
                                   runs[(d, t)]["logits"])
                       for d in range(MESH["shape"][0])
                       for t in range(MESH["shape"][1]))
        want = ref[label]["logits"]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"[mesh] {label}: logits {tuple(got.shape)}, not finite or "
              f"not {tuple(want.shape)}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        if cfg.kv_dtype == "int8":
            # each held step from the same caches; the free runs' codes
            tf = mesh_from_caches(
                torch, cfg, seed,
                {t: mesh_gather(torch, {k: r["held"][t]
                                        for k, r in runs.items()})
                 for t in MESH["int8_held"]}, plan["tokens"][label])
            held = {"step": ",".join(map(str, tf)),
                    "from": "the ranks' caches",
                    "err": max(float((got[t] - w).abs().max())
                               for t, w in tf.items()),
                    "scale": min(float(w.abs().max()) for w in tf.values()),
                    "argmax": all(torch.equal(got[t].argmax(-1),
                                              w.argmax(-1))
                                  for t, w in tf.items())}
            final = mesh_gather(torch, {k: r["final"]
                                        for k, r in runs.items()})
            diff = [(final[k].int() - ref[label]["final"][k].int()).abs()
                    for k in ("k", "v")]
            held.update(codes_differing=sum(int((d != 0).sum())
                                            for d in diff),
                        codes=sum(d.numel() for d in diff),
                        max_code_diff=max(int(d.max()) for d in diff))
        else:
            held = {"step": "all", "from": "zero caches", "err": err,
                    "scale": scale, "argmax": agree == 1.0}
        check(held["err"] <= MESH_TOL * held["scale"] and held["argmax"],
              f"[mesh] {label}: logits {held['err']:.3e} from the one-device "
              f"decode (limit {MESH_TOL} x {held['scale']:.3e}) at steps "
              f"{held['step']}, argmax equal {held['argmax']}")
        errs = [r["kernel_err"] for r in runs.values() if r["kernel_err"]]
        say("mesh", run=label, arch=cfg.name, layers=cfg.n_layers,
            kv=cfg.kv_dtype, resident_experts=resident, steps=steps,
            batch=MESH["batch"], ring=MESH["context"],
            ms_per_step=listed(f"{r['ms_per_step']:.3f}"
                               for r in runs.values()),
            one_device_ms_per_step=f"{ref[label]['ms_per_step']:.3f}",
            held_step=held["step"], held_from=repr(held["from"]),
            held_err=f"{held['err']:.3e}", held_largest=f"{held['scale']:.3e}",
            held_rel=f"{held['err'] / held['scale']:.3e}",
            held_argmax="equal",
            free_run_max_err=f"{err:.3e}", free_run_rel=f"{err / scale:.3e}",
            free_run_argmax_agree=f"{agree:.4f}",
            free_run_codes_differing=held.get("codes_differing", "n/a"),
            codes=held.get("codes", "n/a"),
            max_code_diff=held.get("max_code_diff", "n/a"),
            tp_ranks_bit_equal=tp_equal,
            launches=json.dumps({f"{d}{t}": r["launches"]
                                 for (d, t), r in runs.items()},
                                separators=(",", ":")),
            pairs=json.dumps({f"{d}{t}": r["pairs"]
                              for (d, t), r in runs.items()},
                             separators=(",", ":")),
            kernel_vs_plain=(json.dumps(worst_of(errs), separators=(",", ":"))
                             if errs else "no_valid_slot"),
            one_device_peak_bytes=ref[label]["peak_bytes"])
    say("mesh", ranks=len(ranks), ranks_wall_s=f"{ranks_s:.1f}",
        peak_bytes_by_rank=listed(r["peak_bytes"] for r in ranks),
        init_s=json.dumps({f"{d}{t}": {k: round(v, 3) for k, v in r.items()
                                       if k.startswith("init_s")}
                           for (d, t), r in by.items()},
                          separators=(",", ":")),
        launches=json.dumps(totals, separators=(",", ":")))
    return {"launches": totals}


# ------------------------------------------------------------ [mesh-train]
def mt_configs():
    """[mesh-train]'s two models: minicpm-2b cut to ``layers`` layers and
    mixtral-8x7b cut to ``moe_layers`` at capacity factor 8, both at full
    width."""
    import dataclasses

    from repro_torch.configs import get_arch

    dense = dataclasses.replace(get_arch(MESH_TRAIN["arch"]),
                                n_layers=MESH_TRAIN["layers"])
    full = get_arch(MESH_TRAIN["moe_arch"])
    moe = dataclasses.replace(
        full, n_layers=MESH_TRAIN["moe_layers"],
        moe=dataclasses.replace(full.moe,
                                capacity_factor=MESH_TRAIN["moe_capacity"]))
    return dense, moe


def mt_batches(cfg, seq: int, batch: int, n: int, seed: int) -> list:
    """``n`` global batches of the seeded Markov corpus, on the card."""
    import torch

    from repro_torch.data.pipeline import ShardedLoader

    loader = ShardedLoader(cfg, seq, batch, seed=seed + 33)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in loader.next().items()} for _ in range(n)]


def mt_lr():
    """WSD at peak 3e-3 over steps 1-4 (warmup 1, stable 2, decay 1)."""
    from repro_torch.optim.schedules import wsd_schedule
    return wsd_schedule(MESH_TRAIN["peak_lr"], 1, 2, 1)


def mt_hidden(torch, seed: int):
    """[mesh-train] (e)'s seeded activations, the same in every process."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    return torch.randn((MESH_TRAIN["pipe_batch"], MESH_TRAIN["seq"],
                        mt_configs()[0].d_model), generator=gen,
                       device="cuda")


def mt_save_grads(torch, grads, where: Path) -> dict:
    """Each leaf of ``grads`` (step 1's gradients, or the first moments
    they set) as ``where/<path>.npy``; its largest |value|."""
    from repro_torch.tree import tree_paths

    where.mkdir(parents=True, exist_ok=True)
    largest = {}
    for path, g in tree_paths(grads):
        np.save(where / f"{path.replace('/', '__')}.npy", g.cpu().numpy())
        largest[path] = float(g.abs().max())
    return largest


def mt_steps(torch, step, params, opt, batches, first: int) -> tuple:
    """Train steps ``first, first + 1, ...`` over ``batches``: losses, ms
    a step, and the kernel launches and collectives of all of them."""
    from repro_torch.distributed import collectives as col
    from repro_torch.kernels import flash_attention as fa

    fa.reset_launches()
    col.reset_calls()
    losses, ms, calls = [], [], []
    for i, batch in enumerate(batches):
        before = dict(col.CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, first + i)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        calls.append(sum(col.CALLS.values()) - sum(before.values()))
    return params, opt, {"losses": losses, "ms": ms,
                         "launches": dict(fa.LAUNCHES),
                         "collectives_a_step": calls}


def mt_one_device(torch, seed: int, work: Path) -> dict:
    """[mesh-train]'s one-device references on this card: (d) the
    prefill's logits, (a) 4 steps and step 1's first moments, (b) 3 steps
    on one batch, (c) mixtral's 2 steps and step-1 moments, (e) the
    sequential forward of (a)'s 8 blocks.  Arrays the ranks compare
    against go to ``work``; the rest is returned."""
    from repro_torch.distributed import step as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as A

    cfg, moe = mt_configs()
    MT = MESH_TRAIN
    ref: dict = {}
    torch.cuda.reset_peak_memory_stats()
    batches = mt_batches(cfg, MT["seq"], MT["batch"], MT["steps"], seed)
    params = T.init_params(cfg, seed)
    t0 = time.perf_counter()
    logits = S.make_prefill_step(cfg)(params, batches[0])
    torch.cuda.synchronize()
    ref["d_ms"] = (time.perf_counter() - t0) * 1e3
    top = logits.topk(2, dim=-1).values
    ref["d_largest"] = float(logits.abs().max())
    np.save(work / "d_logits.npy", logits.cpu().numpy())
    np.save(work / "d_argmax.npy", logits.argmax(-1).cpu().numpy())
    np.save(work / "d_gap.npy", (top[..., 0] - top[..., 1]).cpu().numpy())
    del logits, top
    step = S.make_train_step(cfg, lr_fn=mt_lr())
    params, opt, first = mt_steps(torch, step, params, A.adamw_init(params),
                                  batches[:1], 1)
    ref["a_largest"] = mt_save_grads(torch, opt["mu"], work / "a_mu")
    params, opt, rest = mt_steps(torch, step, params, opt, batches[1:], 2)
    ref["a"] = {k: first[k] + rest[k] for k in ("losses", "ms")}
    del params, opt
    torch.cuda.empty_cache()
    params = T.init_params(cfg, seed)
    params, opt, ref["b"] = mt_steps(torch, step, params,
                                     A.adamw_init(params),
                                     [batches[0]] * MT["pod_steps"], 1)
    del params, opt
    torch.cuda.empty_cache()
    mb = mt_batches(moe, MT["moe_seq"], MT["moe_batch"], MT["moe_steps"],
                    seed)
    params = T.init_params(moe, seed)
    step = S.make_train_step(moe, lr_fn=mt_lr())
    params, opt, first = mt_steps(torch, step, params, A.adamw_init(params),
                                  mb[:1], 1)
    ref["c_largest"] = mt_save_grads(torch, opt["mu"], work / "c_mu")
    params, opt, rest = mt_steps(torch, step, params, opt, mb[1:], 2)
    ref["c"] = {k: first[k] + rest[k] for k in ("losses", "ms")}
    del params, opt
    torch.cuda.empty_cache()
    blocks = T.init_params(cfg, seed)["blocks"]
    h = mt_hidden(torch, seed)
    positions = torch.arange(h.shape[1], device="cuda")[None, :]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(cfg.n_layers):
            h = T._block_forward(h, T.layer(blocks, i), cfg, positions)[0]
    torch.cuda.synchronize()
    ref["e_ms"] = (time.perf_counter() - t0) * 1e3
    ref["e_largest"] = float(h.abs().max())
    np.save(work / "e_y.npy", h.cpu().numpy())
    del blocks, h
    ref["peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    (work / "ref.json").write_text(json.dumps(ref))
    return ref


def mt_grad_errs(torch, grads, specs, mesh, where: Path) -> dict:
    """Each block of ``grads`` (laid out by ``specs``): its largest
    |error| against this rank's block of the one-device leaf saved under
    ``where``."""
    from repro_torch.distributed.sharding import shard_leaf
    from repro_torch.tree import tree_paths

    flat = dict(tree_paths(specs))
    errs = {}
    for path, g in tree_paths(grads):
        full = np.load(where / f"{path.replace('/', '__')}.npy",
                       mmap_mode="r")
        want = torch.from_numpy(np.array(
            shard_leaf(full, flat[path], mesh))).to(g.device)
        errs[path] = float((g - want).abs().max())
    return errs


def mt_layer0_kernels(torch, cfg, mesh, specs, params, tokens, seed) -> dict:
    """This rank's layer-0 heads (q, k, v of its ``wq`` / ``wk`` / ``wv``
    column blocks over its batch rows) through the ``lse`` instance and
    the three backward kernels, each against its plain version at
    ``[train]``'s tolerances (the ``lse`` forward's plain version in
    float64); the ``lse`` instance's out bit-equal to the inference
    instance's."""
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import regather
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    ctx = S.make_mesh_ctx(mesh, cfg=cfg, specs=specs)
    with torch.no_grad():
        top = {"embed": regather(params["embed"], specs["embed"],
                                 ctx.cspecs["embed"], mesh)}
        x = T._embed(top, cfg, tokens.long(), ctx)
        blk = T._compute_layout(T.layer(params["blocks"], 0), ctx, "blocks")
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        B, Sq, _ = h.shape
        hd = cfg.resolved_head_dim
        pos = torch.arange(Sq, device=h.device)[None, :]
        q, k, v = ((h @ blk[w]).reshape(B, Sq, -1, hd) for w in
                   ("wq", "wk", "wv"))
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        out, lse = fa.flash_attention_lse(q, k, v)
        same = torch.equal(out, fa.flash_attention(q, k, v))
        _, want_lse = fa.flash_attention_lse_plain(q.double(), k.double(),
                                                   v.double())
        gen = torch.Generator(device="cuda").manual_seed(seed + 43)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        got = fa.flash_attention_bwd(q, k, v, out, lse, do)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
        pairs = {"flash_attention_lse": (lse.double(), want_lse, PREFILL_TOL),
                 "flash_attention_bwd_delta": (
                     fa.flash_attention_bwd_delta(out, do),
                     fa.flash_attention_bwd_delta_plain(out, do),
                     PREFILL_TOL),
                 "flash_attention_bwd_dq": (got[0], want[0], BWD_TOL),
                 "flash_attention_bwd_dkdv": (torch.cat([got[1], got[2]]),
                                              torch.cat([want[1], want[2]]),
                                              BWD_TOL)}
        res = {"heads": q.shape[2], "kv_heads": k.shape[2],
               "lse_out_bit_equal": same}
        for name, (a, b, tol) in pairs.items():
            err, share, ok = close_err(torch, a, b, tol)
            res[name] = {"err": err, "share": share, "ok": ok}
    return res


def mt_prefill(torch, cfg, mesh, specs, params, batch, work: Path) -> dict:
    """(d): the mesh prefill's logit block against this rank's block of
    the one-device logits; its rows' vocab-block maxima and their ids."""
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import P, shard_leaf
    from repro_torch.kernels import flash_attention as fa

    fa.reset_launches()
    step = S.make_prefill_step(cfg, mesh, specs=specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step(params, S.local_batch(batch, mesh))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    full = np.load(work / "d_logits.npy", mmap_mode="r")
    want = torch.from_numpy(np.array(shard_leaf(
        full, P(("data",), None, "model"), mesh))).cuda()
    err = float((logits - want).abs().max())
    top = logits.max(dim=-1)
    res = {"ms": ms, "launches": launches, "err": err,
           "finite": bool(torch.isfinite(logits).all()),
           "block_max": top.values.cpu(), "block_argmax": top.indices.cpu(),
           "v_loc": logits.shape[-1]}
    del logits, want
    return res


def mt_train(torch, cfg, mesh, specs, params, batches, work: Path,
             save: bool, check_grads: bool) -> dict:
    """(a) / (b) / (c) on this rank: the train steps, step 1's gradients
    against the one-device ones (``check_grads``), read from the first
    moment they set (from zero, ``mu = (1 - b1) * clip * g``: the
    gradient times one scalar a side), and for (a) its parameters and
    moments saved after step ``save_at``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import step as S

    local = [S.local_batch(b, mesh) for b in batches]
    opt = S.init_local_opt_state(cfg, mesh, specs)
    ospecs = S.train_opt_specs(cfg, mesh, specs)
    step = S.make_train_step(cfg, mesh, lr_fn=mt_lr(), specs=specs)
    res: dict = {"losses": [], "ms": [], "collectives_a_step": [],
                 "launches": {}}
    cuts = sorted({1, MESH_TRAIN["save_at"] if save else 1, len(local)})
    done = 0
    for end in cuts:
        params, opt, run = mt_steps(torch, step, params, opt,
                                    local[done:end], done + 1)
        for k in ("losses", "ms", "collectives_a_step"):
            res[k] += run[k]
        for k, n in run["launches"].items():
            res["launches"][k] = res["launches"].get(k, 0) + n
        if end == 1 and check_grads:
            res["grad_errs"] = mt_grad_errs(
                torch, opt["mu"], ospecs["mu"], mesh,
                work / f"{'c' if cfg.moe is not None else 'a'}_mu")
        if save and end == MESH_TRAIN["save_at"]:
            t0 = time.perf_counter()
            CheckpointManager(str(work / "ckpt")).save(
                end, {"params": params, "opt": opt},
                {"losses": res["losses"]}, mesh=mesh,
                specs={"params": specs, "opt": ospecs})
            res["save_s"] = time.perf_counter() - t0
        done = end
    res["params"], res["opt"] = params, opt
    return res


def mesh_train_rank(rank: int, seed: int, work: str) -> dict:
    """A rank of [mesh-train] (run by ``run_local_ranks``): (d), (a), (b),
    (c) and (e) in turn, each from its own seeded weights."""
    import torch

    from repro_torch.distributed import step as S
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.sharding import mesh_coords
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_debug_mesh, make_stage_mesh
    from repro_torch.models import transformer as T

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    MT, work = MESH_TRAIN, Path(work)
    cfg, moe = mt_configs()
    out: dict = {}
    torch.cuda.reset_peak_memory_stats()
    mesh = make_debug_mesh(*MT["shape"])
    out["coords"] = mesh_coords(mesh)
    batches = mt_batches(cfg, MT["seq"], MT["batch"], MT["steps"], seed)
    specs = S.train_param_specs(cfg, mesh)
    params = S.init_local_params(cfg, seed, mesh, specs)
    out["d"] = mt_prefill(torch, cfg, mesh, specs, params, batches[0], work)
    a = mt_train(torch, cfg, mesh, specs, params, batches, work, save=True,
                 check_grads=True)
    out["a_kernels"] = mt_layer0_kernels(
        torch, cfg, mesh, specs, a.pop("params"),
        S.local_batch(batches[0], mesh)["tokens"].cuda(), seed)
    del a["opt"], params
    out["a"] = a
    out["a_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    pod = make_debug_mesh(MT["pod_shape"][1], MT["pod_shape"][2],
                          n_pod=MT["pod_shape"][0])
    pspecs = S.train_param_specs(cfg, pod)
    b = mt_train(torch, cfg, pod, pspecs,
                 S.init_local_params(cfg, seed, pod, pspecs),
                 [batches[0]] * MT["pod_steps"], work, save=False,
                 check_grads=False)
    del b["params"], b["opt"]
    out["b"], out["pod_coords"] = b, mesh_coords(pod)
    torch.cuda.empty_cache()

    mspecs = S.train_param_specs(moe, mesh)
    torch.cuda.reset_peak_memory_stats()
    c = mt_train(torch, moe, mesh, mspecs,
                 S.init_local_params(moe, seed, mesh, mspecs),
                 mt_batches(moe, MT["moe_seq"], MT["moe_batch"],
                            MT["moe_steps"], seed), work, save=False,
                 check_grads=True)
    del c["params"], c["opt"]
    out["c"] = c
    out["c_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    stages = make_stage_mesh(MT["stages"])
    blocks = T.init_params(cfg, seed)["blocks"]
    h = mt_hidden(torch, seed)
    positions = torch.arange(h.shape[1], device="cuda")[None, :]
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = pipeline_forward(
            lambda x, blk: T._block_forward(x, blk, cfg, positions)[0],
            stages, microbatches=MT["microbatches"])(h, blocks)
    torch.cuda.synchronize()
    want = torch.from_numpy(np.load(work / "e_y.npy")).cuda()
    out["e"] = {"ms": (time.perf_counter() - t0) * 1e3,
                "launches": dict(fa.LAUNCHES),
                "err": float((y - want).abs().max()),
                "stage": stages.get_local_rank("pod")}
    del blocks, h, y, want
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mesh_restore_rank(rank: int, seed: int, work: str) -> dict:
    """A rank of [mesh-train] (f): a data 1 x model 2 group restores (a)'s
    step-2 checkpoint (``mesh=`` / ``specs=``), each block held bit-equal
    to this rank's block of the saved leaf (read raw from its file), then
    takes steps 3-4."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import step as S
    from repro_torch.distributed.sharding import mesh_coords, shard_leaf
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import param_shapes
    from repro_torch.tree import tree_map, tree_paths

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    MT, work = MESH_TRAIN, Path(work)
    cfg, _ = mt_configs()
    mesh = make_debug_mesh(*MT["restore_shape"])
    specs = S.train_param_specs(cfg, mesh)
    all_specs = {"params": specs,
                 "opt": S.train_opt_specs(cfg, mesh, specs)}

    def meta(shapes):
        return tree_map(lambda s: torch.empty(s, device="meta"), shapes)

    template = {"params": meta(param_shapes(cfg)),
                "opt": S.meta_opt_state(cfg)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, extra, step_no = CheckpointManager(
        str(work / "ckpt")).restore_latest_good(
        template, mesh=mesh, specs=all_specs, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    cdir = work / "ckpt" / f"step_{step_no:08d}"
    manifest = json.loads((cdir / "manifest.json").read_text())
    flat_specs = dict(tree_paths(all_specs))
    unequal, leaves = [], 0
    for key, got in tree_paths(tree):
        ent = manifest["leaves"][key]
        raw = np.memmap(cdir / ent["file"], dtype=np.dtype(ent["dtype"]),
                        mode="r", shape=tuple(ent["shape"]) or (1,))
        raw = raw.reshape(tuple(ent["shape"]))
        spec = flat_specs.get(key)
        block = raw if spec is None else shard_leaf(raw, spec, mesh)
        leaves += 1
        if not torch.equal(torch.from_numpy(np.array(block)), got.cpu()):
            unequal.append(key)
    batches = mt_batches(cfg, MT["seq"], MT["batch"], MT["steps"], seed)
    params, opt = tree["params"], tree["opt"]
    step = S.make_train_step(cfg, mesh, lr_fn=mt_lr(), specs=specs)
    _, _, run = mt_steps(torch, step, params, opt,
                         [S.local_batch(b, mesh) for b in
                          batches[step_no:]], step_no + 1)
    return {"coords": mesh_coords(mesh), "step": step_no, "extra": extra,
            "restore_s": restore_s, "leaves": leaves, "unequal": unequal,
            "run": run, "peak_bytes": torch.cuda.max_memory_allocated()}


def mesh_train_phase(torch, seed: int) -> dict:
    """[mesh-train]: training and prefill on a device mesh, four gloo
    processes on this card (see MESH_TRAIN), each cell held against its
    one-device run on this card, computed here first.  Returns the
    kernels' launches on the ranks' main paths."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_local_ranks

    MT, G = MESH_TRAIN, MESH_TRAIN_GATES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, moe = mt_configs()
    work = Path(tempfile.mkdtemp(prefix="mesh-train-"))
    try:
        t0 = time.perf_counter()
        ref = mt_one_device(torch, seed, work)
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_local_ranks(mesh_train_rank, 4, work / "ranks4",
                                args=(seed, str(work)),
                                timeout_s=MESH_TRAIN_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = run_local_ranks(mesh_restore_rank, 2, work / "ranks2",
                                   args=(seed, str(work)),
                                   timeout_s=MESH_TRAIN_TIMEOUT_S)
        restore_group_s = time.perf_counter() - t0
        d_argmax = torch.from_numpy(np.load(work / "d_argmax.npy"))
        d_gap = torch.from_numpy(np.load(work / "d_gap.npy"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in ranks}
    nl = cfg.n_layers
    lse_want = 2 * nl * MT["steps"]
    bwd_want = nl * MT["steps"]
    for label, largest, cell_ref, steps in (
            ("a", ref["a_largest"], ref["a"], MT["steps"]),
            ("b", None, ref["b"], MT["pod_steps"]),
            ("c", ref["c_largest"], ref["c"], MT["moe_steps"])):
        runs = [r[label] for r in ranks]
        losses = np.array([run["losses"] for run in runs])
        check(bool((losses == losses[0]).all()),
              f"[mesh-train] ({label}) the ranks' losses differ: {losses}")
        want = np.array(cell_ref["losses"])
        rel = np.abs(losses[0] - want) / np.abs(want)
        check(bool(np.isfinite(losses).all()) and rel[0] <= G["loss1_rtol"]
              and bool((rel[1:] <= G["loss_rtol"]).all()),
              f"[mesh-train] ({label}) losses {losses[0]} against one "
              f"device's {want}: relative {rel}")
        if label == "b":
            check(losses[0][-1] < losses[0][0],
                  f"[mesh-train] (b) the loss did not fall: {losses[0]}")
        grad_share = None
        if largest is not None:
            share = {p: max(r[label]["grad_errs"][p] for r in ranks)
                     / max(largest[p], 1e-30) for p in largest}
            grad_share = max(share.values())
            check(grad_share <= G["grad_share"],
                  f"[mesh-train] ({label}) gradients against one device's: "
                  f"{ {p: f'{s:.2e}' for p, s in share.items()} }")
        if label in ("a", "b"):
            per = steps * nl
            for r in runs:
                got = r["launches"]
                check(got["flash_attention_lse"] == 2 * per
                      and all(got[k] == per for k in BWD_KERNELS)
                      and got["flash_attention"] == 0,
                      f"[mesh-train] ({label}) launches {got}, not "
                      f"{2 * per} lse and {per} of each backward kernel")
        ranks_ms = [float(np.median(r[label]["ms"][1:])) for r in ranks]
        say("mesh-train", cell=label,
            arch=(moe if label == "c" else cfg).name,
            layers=(moe if label == "c" else cfg).n_layers,
            mesh=("pod 2 x data 1 x model 2" if label == "b"
                  else "data 2 x model 2"),
            batch=(f"{MT['moe_batch']}x{MT['moe_seq']}" if label == "c"
                   else f"{MT['batch']}x{MT['seq']}"), steps=steps,
            losses=json.dumps([round(x, 6) for x in losses[0]]),
            one_device_losses=json.dumps([round(x, 6) for x in want]),
            loss_rel=listed(f"{x:.3e}" for x in rel),
            grad_share=("n/a" if grad_share is None
                        else f"{grad_share:.3e}"),
            grads_read_from="step 1's first moment (1 - b1) * clip * g",
            ms_per_step=listed(f"{x:.1f}" for x in ranks_ms),
            one_device_ms_per_step=(
                f"{float(np.median(cell_ref['ms'][1:])):.1f}"),
            collectives_a_step=listed(runs[0]["collectives_a_step"]),
            launches=json.dumps(runs[0]["launches"], separators=(",", ":")),
            peak_bytes_by_rank=listed(
                r["c_peak_bytes" if label == "c" else
                  ("a_peak_bytes" if label == "a" else "peak_bytes")]
                for r in ranks))
    kern = [r["a_kernels"] for r in ranks]
    for k in kern:
        check(k["lse_out_bit_equal"] and all(
            k[n]["ok"] for n in ("flash_attention_lse",) + tuple(BWD_KERNELS)),
            f"[mesh-train] a rank's layer-0 kernels against their plain "
            f"versions: {k}")
    say("mesh-train", cell="a", check="layer-0 kernels",
        heads_a_rank=kern[0]["heads"], kv_heads_a_rank=kern[0]["kv_heads"],
        lse_out="bit-equal to the inference instance",
        **{f"{n}_max_abs_err": f"{max(k[n]['err'] for k in kern):.3e}"
           for n in ("flash_attention_lse",) + tuple(BWD_KERNELS)},
        save_s=listed(f"{r['a']['save_s']:.2f}" for r in ranks))

    # (d): the blocks' maxima put together over the model axis
    d_err = max(r["d"]["err"] for r in ranks)
    scale = ref["d_largest"]
    check(all(r["d"]["finite"] for r in ranks) and
          d_err <= G["prefill_share"] * scale,
          f"[mesh-train] (d) prefill logits {d_err:.3e} from one device's "
          f"(limit {G['prefill_share']} x {scale:.3e})")
    rows = []
    for d in range(MT["shape"][0]):
        blocks = [by[(d, t)]["d"] for t in range(MT["shape"][1])]
        vals = torch.stack([b["block_max"] for b in blocks])
        ids = torch.stack([b["block_argmax"] + t * b["v_loc"]
                           for t, b in enumerate(blocks)])
        rows.append(torch.gather(ids, 0, vals.argmax(0, keepdim=True))[0])
    got_argmax = torch.cat(rows)
    sure = d_gap > G["prefill_share"] * scale
    agree = bool((got_argmax[sure] == d_argmax[sure]).all())
    check(agree, "[mesh-train] (d) argmax differs where one device's top "
                 "two logits are apart")
    say("mesh-train", cell="d", what="make_prefill_step(cfg, mesh)",
        batch=f"{MT['batch']}x{MT['seq']}",
        launches_by_rank=listed(r["d"]["launches"]["flash_attention"]
                                for r in ranks),
        max_abs_err=f"{d_err:.3e}", largest=f"{scale:.3e}",
        rel=f"{d_err / scale:.3e}",
        argmax_checked=int(sure.sum()), argmax_equal=agree,
        ms_by_rank=listed(f"{r['d']['ms']:.1f}" for r in ranks),
        one_device_ms=f"{ref['d_ms']:.1f}")
    # (e)
    e_err = max(r["e"]["err"] for r in ranks)
    e_per = MT["microbatches"] * nl // MT["stages"]
    check(e_err <= G["pipe_share"] * ref["e_largest"]
          and all(r["e"]["launches"]["flash_attention"] == e_per
                  for r in ranks),
          f"[mesh-train] (e) pipeline {e_err:.3e} from the sequential "
          f"forward (limit {G['pipe_share']} x {ref['e_largest']:.3e}), "
          f"launches {[r['e']['launches'] for r in ranks]} (want {e_per} "
          "a stage)")
    say("mesh-train", cell="e", what="pipeline_forward", stages=MT["stages"],
        microbatches=MT["microbatches"],
        x=f"{MT['pipe_batch']}x{MT['seq']}x{cfg.d_model}",
        launches_by_stage=listed(r["e"]["launches"]["flash_attention"]
                                 for r in sorted(ranks, key=lambda r:
                                                 r["e"]["stage"])),
        sequential_launches=nl, max_abs_err=f"{e_err:.3e}",
        largest=f"{ref['e_largest']:.3e}",
        ms_by_rank=listed(f"{r['e']['ms']:.1f}" for r in ranks),
        sequential_ms=f"{ref['e_ms']:.1f}")
    # (f)
    a_losses = ranks[0]["a"]["losses"]
    for r in restored:
        check(r["step"] == MT["save_at"] and not r["unequal"]
              and r["leaves"] > 0,
              f"[mesh-train] (f) restored step {r['step']}, blocks unequal "
              f"to the saved leaves: {r['unequal'][:8]}")
        rel = [abs(x - w) / abs(w) for x, w in
               zip(r["run"]["losses"], a_losses[MT["save_at"]:])]
        check(max(rel) <= G["restore_rtol"],
              f"[mesh-train] (f) steps 3-4 {r['run']['losses']} against "
              f"(a)'s {a_losses[MT['save_at']:]}: relative {rel}")
    say("mesh-train", cell="f", what="restore(mesh=, specs=)",
        saved_on="data 2 x model 2", restored_on="data 1 x model 2",
        leaves=restored[0]["leaves"], blocks="bit-equal to the saved leaves",
        losses=json.dumps(restored[0]["run"]["losses"]),
        a_losses=json.dumps(a_losses[MT["save_at"]:]),
        rel=listed(f"{abs(x - w) / abs(w):.3e}" for x, w in
                   zip(restored[0]["run"]["losses"],
                       a_losses[MT["save_at"]:])),
        restore_s=listed(f"{r['restore_s']:.2f}" for r in restored),
        ms_per_step=listed(f"{np.median(r['run']['ms']):.1f}"
                           for r in restored),
        peak_bytes_by_rank=listed(r["peak_bytes"] for r in restored))
    say("mesh-train", one_device_s=f"{one_s:.1f}",
        ranks_wall_s=f"{ranks_s:.1f}",
        restore_group_wall_s=f"{restore_group_s:.1f}",
        one_device_peak_bytes=ref["peak_bytes"])
    return {"launches": {
        "flash_attention_lse": sum(r["a"]["launches"]["flash_attention_lse"]
                                   for r in ranks),
        **{k: sum(r["a"]["launches"][k] for r in ranks) for k in BWD_KERNELS},
        "flash_attention": sum(r["d"]["launches"]["flash_attention"]
                               + r["e"]["launches"]["flash_attention"]
                               for r in ranks)}}


def train_phase(torch, dev, seed: int, worst: dict,
                ckpt: Path = ROOT / "build" / "train_resume_ckpt") -> list:
    """[train]: minicpm-2b at full width and depth through
    ``launch/train.main`` (remat, the ``lse`` forward twice a layer, the
    backward kernels once), its profile and kernel times at layer 0's
    shapes, the 2-layer cut against the CPU and a resume.  Returns the
    four kernels' rows of the kernels line."""
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.distributed.step import make_train_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedules import wsd_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, B, S = TRAIN["steps"], TRAIN["batch"], TRAIN["seq"]
    fa.reset_launches()
    t0 = time.perf_counter()
    res = train_main(["--arch", TRAIN["arch"], "--steps", str(steps),
                      "--batch", str(B), "--seq", str(S), "--device",
                      str(dev), "--seed", str(seed), "--log-every", "1"])
    run_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    cfg, nl = res.cfg, res.cfg.n_layers
    want = {"flash_attention": 0, "flash_attention_lse": steps * 2 * nl,
            **{k: steps * nl for k in BWD_KERNELS}}
    check(launches == want,
          f"train launches {launches}, not {want} (the remat recompute: "
          f"the lse forward twice a layer, each backward kernel once)")
    check(len(res.losses) == steps and all(np.isfinite(res.losses)),
          f"train losses {res.losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(res.step_seconds[1:])) * 1e3

    # one more step under the profiler: the device split and idle share
    loader = ShardedLoader(cfg, S, B, seed=seed + 1)
    loader.restore({"step": steps, "seed": seed + 1})
    step = make_train_step(cfg, lr_fn=wsd_schedule(3e-3, 5, 5, 2),
                           adamw_cfg=AdamWConfig())
    batch = loader.next()
    box = [res.params, res.opt_state]
    walls = []

    def run():
        t0 = time.perf_counter()
        box[:2] = step(box[0], box[1], batch, steps)[:2]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    kinds = train_split(device_events(
        torch, run, lambda a: train_split(a)["attention_backward"] > 0))
    wall_ms = walls[-1]                  # the profiled step's host time
    busy = sum(kinds.values())
    check(kinds["attention_backward"] > 0 and kinds["matmuls"] > 0,
          f"the profile of a train step saw no kernels: {kinds}")
    say("train", arch=cfg.name, layers=nl, params=int(cfg.param_count()),
        batch=f"{B}x{S}", steps=steps, remat="on", moments="f32",
        losses=json.dumps([round(x, 4) for x in res.losses]),
        run_s=f"{run_s:.2f}", ms_per_step=f"{step_ms:.3f}",
        tok_per_s=f"{B * S / step_ms * 1e3:.1f}",
        first_step_ms=f"{res.step_seconds[0] * 1e3:.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
        peak_device_bytes=peak)
    say("train", profile_step_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy:.3f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in kinds.items()},
        idle_share=f"{1 - busy / wall_ms:.4f}")

    # the kernels at the main path's shapes: layer 0's q / k / v of the
    # batch (a seeded dO in train_kernel_rows)
    params = box[0]
    del box, res
    with torch.no_grad():
        q, k, v = layer0_qkv(torch, dev, cfg, params, batch)
    del params
    torch.cuda.empty_cache()
    rows = train_kernel_rows(torch, dev, seed, q, k, v, launches, worst)
    del q, k, v
    torch.cuda.empty_cache()
    cut = cut_against_cpu(torch, dev, seed)
    resume = resume_against_uninterrupted(torch, dev, seed, ckpt)
    for row in rows:
        row.update(cut_grad_share=cut["grad_share"],
                   resume_max_rel_err=resume["resume_err"])
    return rows


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
        m = min(n, SCAN_PYTHON_ACCESSES.get(d, n))
        if m < n:
            res = TraceDriver(make_device(d), engine="scan").run(trace[:m])
        tap = FlagTap(make_device(d))
        t0 = time.perf_counter()
        want = TraceDriver(tap).run(trace[:m])
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
        res = runs[d][0]
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
            python_accesses=m,
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
        "nand": faulted_replay(torch, "nand", nand,
                               trace[:FAULT_NAND_ACCESSES]),
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
    for kernel in ("flash_attention_bwd_dkdv_kernel",
                   "flash_attention_bwd_dq_kernel"):
        spilled = ptxas_spills(_build.build_log.get("flash_attention_bwd", ""),
                               kernel)
        say("train", kernel=kernel, spill_bytes=spilled)
        check(spilled == 0, f"{kernel} spills {spilled} bytes: {ptxas}")

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
    clock("fabric")
    fabric = fabric_phase(torch, dev, trace, res, args.seed)

    # 7.-10. the serving path --------------------------------------------
    clock("serve")
    check_worst = decode_kernel_checks(torch, dev, args.seed)
    run = serve_phase(torch, dev)
    profile_phase(torch, run)
    scheduler_phase(torch, run, args.seed)
    serve_rows = serve_kernel_rows(torch, dev, run, check_worst)

    # 11. the prefill path ------------------------------------------------
    clock("prefill")
    prefill_row = prefill_phase(torch, run, args.seed,
                                prefill_kernel_checks(torch, dev, args.seed))

    # 11a.-11b. int8 caches on the serving path; the other families ------
    clock("int8")
    int8_row = int8_phase(torch, run)
    del run
    clock("families")
    families_phase(torch, dev, args.seed)

    # 11c.-11d. the vlm family; training on one card -------------------
    clock("vlm")
    vlm = vlm_phase(torch, dev, args.seed)
    prefill_row.update(vlm_launches=vlm["launches"]["flash_attention"],
                       vlm_cross_max_abs_err=vlm["fa_err"])
    for row in serve_rows:
        if row["name"] == "flash_decode":
            row.update(vlm_launches=vlm["launches"]["flash_decode"],
                       vlm_cross_err=vlm["fd_err"])
    clock("train")
    train_rows = train_phase(torch, dev, args.seed,
                             train_kernel_checks(torch, dev, args.seed))

    # 11e. serving on a device mesh: four processes on this card ---------
    clock("mesh")
    mesh = mesh_phase(torch, args.seed)
    for row in serve_rows + [int8_row]:
        if row["name"] in mesh["launches"]:
            row["mesh_launches"] = mesh["launches"][row["name"]]

    # 11f. training and prefill on a device mesh ---------------------------
    clock("mesh-train")
    mesh_train = mesh_train_phase(torch, args.seed)
    for row in train_rows + [prefill_row]:
        if row["name"] in mesh_train["launches"]:
            row["mesh_train_launches"] = mesh_train["launches"][row["name"]]

    # 12. the tick-exact scan lane, after the host-bound serving loop so
    # that its python-lane replays leave nothing behind for that loop -----
    int32_ops_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                       * INT32_LANES_PER_SM * sm_clock_mhz * 1e6)
    clock("scan")
    scan = scan_phase(torch, trace, smem_cycles, sm_clock_mhz,
                      int32_ops_per_s)
    clock("faults")
    faults = faults_phase(torch, trace, smem_cycles, sm_clock_mhz,
                          int32_ops_per_s)
    clock("assoc")
    assoc_phase(torch, trace, scan)
    clock("multihost")
    multi = multihost_phase(torch, args.seed, smem_cycles, sm_clock_mhz,
                            int32_ops_per_s)
    clock("stream")
    stream = stream_phase(torch, trace, scan, args.seed)
    clock("sweep")
    sweeps = sweep_phase(torch, trace, args.seed, scan, smem_cycles,
                         sm_clock_mhz, int32_ops_per_s)
    clock("fleet")
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
    clock("end")
    print(card, flush=True)
    print(json.dumps({"kernels": rows + serve_rows + [
        int8_row, prefill_row] + train_rows + [
        scan_row(scan, faults, multi, n, stream, sweeps), fleet_row(fleet)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
