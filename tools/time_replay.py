#!/usr/bin/env python3
"""Time the replay kernels of one checkout on the card, for A/B comparisons.

    python tools/time_replay.py CHECKOUT TAG [--sass]

Imports ``repro_torch`` from ``CHECKOUT/src`` (building its kernels there
if needed) and times ``cache_sim`` (decisions) and ``cache_sim_fused`` with
CUDA events, three calls each after a warm-up: at Table I's 1 set x 4096
ways (LRU, 32 outstanding) over 2^20 seeded accesses to 16,384 pages, 30%
writes; then at 4096 sets x 8 ways (state in the global scratch) over 2^18
accesses.  Then ``replay_scan`` for each of the five devices of
``chip_smoke.py``'s ``[scan]`` phase (``make_device`` defaults, 32
outstanding, posted writes) over that phase's trace of 2^20 accesses
(``make_trace(0, pages=16384)``), two calls each after one short
warm-up.  Prints one line for the cache kernels (the tag, each
call's milliseconds, the hit count and a digest of the fused kernel's hits
and latencies) and one for the scan (each device's milliseconds and a
digest of every replay's issue and done ticks and flags).  Then the
multi-host instance on ``chip_smoke.py``'s ``[multihost]`` cases at a
quarter of their depth (four Table I cached CXL-SSDs privately mounted on
a two-level tree, 4 x 2^16 steps; three hosts on the golden QoS + ECMP
fabric pooling two DRAM devices, 2^18 steps) and on
``results/BENCH_replay.json``'s 64-host DRAM fleet (102,400 steps), two
calls each, with a digest of the first two's hosts, ticks and flags (a
checkout whose one-block layout cannot hold the fleet prints that it was
refused).  The digests must agree between checkouts.  ``--sass`` also writes the cache library's SASS
to ``chiprun_out/sass_TAG.txt`` and prints its ptxas register and spill
lines.

Compare two checkouts within one machine, in separate processes and in
alternating order (A B B A ...): the kernels run on one SM, so their time
follows that machine's clock.
"""

import hashlib
import subprocess
import sys

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root + "/src")

import torch  # noqa: E402

from repro_torch.core.devices import make_device  # noqa: E402
from repro_torch.core.replay import stack  # noqa: E402
from repro_torch.core.replay.spec import build_stack, trace_to_arrays  # noqa: E402
from repro_torch.core.workloads.traces import make_trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_sim as ks  # noqa: E402
from repro_torch.kernels import replay_scan as rs  # noqa: E402

SCAN_DEVICES = ("dram", "cxl-dram", "pmem", "cxl-ssd", "cxl-ssd-cache")
SCAN_REPS = 2

TIMING = dict(outstanding=32, issue_ns=1, hit_ns=50, miss_ns=5000,
              miss_occ_ns=213, wb_ns=0)


def timed(fn, reps=3, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return ms, out


def trace(g, n, pages):
    return (torch.randint(0, pages, (n,), generator=g).to(torch.int32).cuda(),
            (torch.rand((n,), generator=g) < 0.3).cuda())


def main():
    _build.library("cache_sim")
    if "--sass" in sys.argv[3:]:
        sass = subprocess.run(
            ["/usr/local/cuda/bin/cuobjdump", "-sass",
             str(_build.library_path("cache_sim"))],
            capture_output=True, text=True).stdout
        with open(f"chiprun_out/sass_{tag}.txt", "w") as f:
            f.write(sass)
        for ln in _build.build_log.get("cache_sim", "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(tag, "ptxas", ln.strip())
    g = torch.Generator().manual_seed(0)
    pages, writes = trace(g, 1 << 20, 16384)
    geo = dict(num_sets=1, ways=4096, policy="lru")
    dec, hits = timed(lambda: ks.cache_sim(pages, writes, **geo))
    fused, out = timed(lambda: ks.cache_sim_fused(pages, writes, **geo,
                                                  **TIMING))
    dec_again, _ = timed(lambda: ks.cache_sim(pages, writes, **geo))
    digest = hashlib.md5(out[0].cpu().numpy().tobytes()
                         + out[2].cpu().numpy().tobytes()).hexdigest()[:12]
    pages, writes = trace(g, 1 << 18, 4 * 4096 * 8)
    geo = dict(num_sets=4096, ways=8, policy="lru")
    s_fused, _ = timed(lambda: ks.cache_sim_fused(pages, writes, **geo,
                                                  **TIMING))
    s_dec, _ = timed(lambda: ks.cache_sim(pages, writes, **geo))

    def f(v):
        return "/".join(f"{x:.1f}" for x in v)

    print(f"{tag} decisions_ms={f(dec)} fused_ms={f(fused)} "
          f"decisions_again_ms={f(dec_again)} scratch_fused_ms={f(s_fused)} "
          f"scratch_decisions_ms={f(s_dec)} hits={int(hits[0].sum())} "
          f"digest={digest}", flush=True)
    scan(f)


def scan(f):
    a, w, _ = trace_to_arrays(make_trace(0, n=1 << 20, pages=16384))
    addrs, writes = torch.from_numpy(a).cuda(), torch.from_numpy(w).cuda()
    h = hashlib.md5()
    line = []
    for d in SCAN_DEVICES:
        def replay(n=addrs.numel()):
            cfg, params = build_stack(make_device(d), size=64, outstanding=32,
                                      issue_overhead_ns=0.5,
                                      posted_writes=True, n_accesses=n,
                                      max_addr=int(a[:n].max()))
            return rs.replay_scan(cfg, params, stack.init_state(cfg, "cuda"),
                                  addrs[:n], writes[:n])

        replay(4096)
        ms, out = timed(replay, SCAN_REPS, warm=False)
        for x in out[:3]:
            h.update(x.cpu().numpy().tobytes())
        line.append(f"scan_{d}_ms={f(ms)}")
    print(f"{tag} {' '.join(line)} scan_digest={h.hexdigest()[:12]}",
          flush=True)
    multi(f)


def multi_cases():
    """``{name: (targets, traces)}`` of the multi-host timings."""
    import numpy as np

    from repro_torch.core.fabric import Fabric, MemoryPool

    def traces_of(lengths):
        return [make_trace(i, n=n, pages=16384)
                for i, n in enumerate(lengths)]

    fab = Fabric.build("two_level", num_hosts=4, num_devices=4,
                       num_leaves=2)
    table1 = [fab.mount(f"h{i}", f"d{i}", make_device("cxl-ssd-cache"))
              for i in range(4)]
    fab = Fabric.build("spine_leaf", num_hosts=3, num_devices=2,
                       num_leaves=2, num_spines=2, ecmp=True,
                       qos_weights={"h0": 3.0, "h1": 1.0, "h2": 1.0})
    pool = MemoryPool(fab, {"d0": make_device("dram"),
                            "d1": make_device("dram")})
    qos = pool.views(["h0", "h1", "h2"])
    # the fleet's zipfian columns (1024 pages, s = 1.1, 30% writes), drawn
    # here with numpy so that both checkouts replay the same trace
    rng = np.random.default_rng(23)
    w = 1.0 / np.arange(1, 1025) ** 1.1
    pages = rng.choice(1024, size=(64, 1600), p=w / w.sum())
    fleet_traces = [[(int(p) * 4096 + 64 * int(o), 64, bool(x))
                     for p, o, x in zip(pages[h], rng.integers(0, 64, 1600),
                                        rng.random(1600) < 0.3)]
                    for h in range(64)]
    fab = Fabric.build("multi_pod", forward_ns=10.0, rt_extra_ns=4.0,
                       num_pods=4, hosts_per_pod=16)
    fleet = [fab.mount(f"h{i}", f"d{i}", make_device("dram"))
             for i in range(64)]
    return {"table1x4": (table1, traces_of([1 << 16] * 4)),
            "qos_pool": (qos, traces_of([87382, 87381, 87381])),
            "fleet": (fleet, fleet_traces)}


def multi(f):
    from repro_torch.core.replay.multihost import MultiHostReplay

    h = hashlib.md5()
    line = []
    for name, (targets, traces) in multi_cases().items():
        prep = MultiHostReplay(targets, outstanding=32 if name != "fleet"
                               else 8).prepare(traces)
        cfg = prep.cfg

        def t(x):
            return None if x is None else torch.from_numpy(x).cuda()

        ins = [t(x) for x in (prep.addrs, prep.writes, prep.lens, prep.devs,
                              prep.routes)]

        def replay():
            return rs.replay_multi(cfg, prep.params, stack.init_lanes(
                cfg.stack, cfg.num_devs, cfg.n_flash, "cuda"), *ins,
                retries=t(prep.retries))

        try:
            ms, out = timed(replay, SCAN_REPS)
        except ValueError as e:          # a layout one block cannot hold
            line.append(f"multi_{name}=refused({str(e)[:60]!r})")
            continue
        if name != "fleet":              # a checkout that refuses it too
            for x in out[:4]:
                h.update(x.cpu().numpy().tobytes())
        line.append(f"multi_{name}_ms={f(ms)}")
    print(f"{tag} {' '.join(line)} multi_digest={h.hexdigest()[:12]}",
          flush=True)


if __name__ == "__main__":
    main()
