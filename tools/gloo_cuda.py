#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and what a collective costs,
for ranks that share one card.

    python tools/gloo_cuda.py [--ranks 4] [--reps 200]

Starts ``--ranks`` processes on ``cuda:0`` (a gloo process group, a
``file://`` rendezvous under ``build/``), then in each:

1. calls ``all_reduce`` (sum, max), ``all_gather``, ``all_to_all_single``
   and ``broadcast`` of the whole group directly on CUDA tensors and
   prints, per collective, whether gloo ran it and gave the right values,
   or the error it raised;
2. times, over ``--reps`` calls each, the collectives of
   ``repro_torch.distributed.collectives`` (CUDA in and out) over the
   model axis
   of a 2 x 2 mesh at the sequence-sharded decode's shapes for
   h2o-danube-3-4b at batch 2 a rank: the q / k / v gather (2 x 2880
   floats a rank), the ``pmax`` of (2, 32), the merge's ``psum`` of (2,
   3872) and the output projection's ``psum`` of (2, 3840);
3. prints one JSON line per rank.  Run it on the machine with the card;
   it needs no network.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _direct(torch, dist, rank: int, world: int) -> dict:
    """Each collective of the whole group, straight on CUDA tensors."""
    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, run, want):
        try:
            got = run()
            torch.cuda.synchronize()
            out[name] = ("ran, right" if torch.equal(got.cpu(), want)
                         else f"ran, WRONG: {got.cpu().tolist()}")
        except Exception as exc:    # the point: record what gloo refuses
            out[name] = f"refused: {type(exc).__name__}: {str(exc)[:160]}"

    def reduce(op):
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, op=op)
        return t

    attempt("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM),
            torch.full((4,), float(world * (world + 1) // 2)))
    attempt("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX),
            torch.full((4,), float(world)))

    def gather():
        parts = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev))
        return torch.cat(parts)

    attempt("all_gather", gather,
            torch.arange(world, dtype=torch.float32).repeat_interleave(3))

    def a2a():
        src = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
        dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src)
        return dst

    attempt("all_to_all_single", a2a,
            torch.arange(world, dtype=torch.float32) * 10 + rank)

    def bcast():
        t = torch.full((2,), float(rank), device=dev)
        dist.broadcast(t, src=0)
        return t

    attempt("broadcast", bcast, torch.zeros(2))
    return out


def _timed(torch, reps: int) -> dict:
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(2, 2, device_type="cuda")
    dev = torch.device("cuda", 0)
    cases = {
        "all_gather_qkv": lambda: col.all_gather(
            torch.randn(2, 2880, device=dev), mesh, "model", 1),
        "pmax_m": lambda: col.pmax(torch.randn(2, 32, device=dev), mesh,
                                   "model"),
        "psum_merge": lambda: col.psum(torch.randn(2, 3872, device=dev),
                                       mesh, "model"),
        "psum_wo": lambda: col.psum(torch.randn(2, 3840, device=dev), mesh,
                                    "model"),
    }
    out = {}
    for name, fn in cases.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name + "_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


def rank_main(rank: int, world: int, reps: int) -> dict:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    res = {"rank": rank, "direct": _direct(torch, dist, rank, world)}
    if world == 4:
        res["timed"] = _timed(torch, reps)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import run_local_ranks

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="gloo_cuda-", dir=ROOT / "build")
    t0 = time.perf_counter()
    for res in run_local_ranks(rank_main, args.ranks, work,
                               args=(args.ranks, args.reps), timeout_s=300):
        print(json.dumps(res), flush=True)
    print(f"[gloo_cuda] ranks={args.ranks} wall_s="
          f"{time.perf_counter() - t0:.3f} torch={torch.__version__} "
          f"device={torch.cuda.get_device_name(0)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
