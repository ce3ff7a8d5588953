#!/usr/bin/env python3
"""Time the replay kernels of one checkout on the card, for A/B comparisons.

    python tools/time_replay.py CHECKOUT TAG [--sass]

Imports ``repro_torch`` from ``CHECKOUT/src`` (building its kernels there
if needed) and times ``cache_sim`` (decisions) and ``cache_sim_fused`` with
CUDA events, three calls each after a warm-up: at Table I's 1 set x 4096
ways (LRU, 32 outstanding) over 2^20 seeded accesses to 16,384 pages, 30%
writes; then at 4096 sets x 8 ways (state in the global scratch) over 2^18
accesses.  Prints one line: the tag, each call's milliseconds, the hit
count and a digest of the fused kernel's hits and latencies, which must
agree between checkouts.  ``--sass`` also writes the library's SASS to
``chiprun_out/sass_TAG.txt`` and prints its ptxas register and spill lines.

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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_sim as ks  # noqa: E402

TIMING = dict(outstanding=32, issue_ns=1, hit_ns=50, miss_ns=5000,
              miss_occ_ns=213, wb_ns=0)


def timed(fn, reps=3):
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


if __name__ == "__main__":
    main()
