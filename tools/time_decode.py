#!/usr/bin/env python3
"""Time the ``flash_decode`` kernel on the card under every cluster size.

    python tools/time_decode.py [--clusters 1,2,4,8,16] [--reps 24]

At each attention shape (h2o-danube-3-4b's, the serving main path's, at
n_valid 512 and 4096; glm4-9b's and hymba-1.5b's at 512; batch 4), the
kernel runs once with ``split_plan``'s own plan and once with each forced
cluster size, on caches stacked 24 deep and rotated call by call so that
each call reads device memory, not the 50 MB L2.  Device time per call is
``chip_smoke.device_ms``'s (the profiler's kernel durations).  Every plan's
output is held against the plain version first.  Prints the card's name
and power limit, then one JSON line per shape: the default plan, the bytes
bound and the microseconds of each cluster size.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

LAYERS = 24
SHAPES = {"h2o-danube-3-4b": 512, "h2o-danube-3-4b@4096": 4096,
          "glm4-9b": 512, "hymba-1_5b": 512}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", default="1,2,4,8,16")
    ap.add_argument("--reps", type=int, default=smoke.TIMING_REPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_decode: no CUDA device")
    print(smoke.smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B = 4
    for name, n in SHAPES.items():
        cfg = get_arch(name.split("@")[0])
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        G = cfg.n_heads // KV
        q = torch.randn(B, KV * G, hd, device=dev, generator=gen)
        kc, vc = (torch.randn(LAYERS, B, n, KV, hd, device=dev, generator=gen)
                  for _ in range(2))
        plan = fd.split_plan(n, hd, B * KV)
        want = fd.flash_decode_plain(q, kc[0], vc[0], n)
        us = {}
        for c in [None] + [int(x) for x in args.clusters.split(",")]:
            p = plan if c is None else fd.split_plan(n, hd, B * KV, cluster=c)
            err = smoke.decode_err(fd._launch(q, kc[0], vc[0], n, p), want)
            smoke.check(smoke.decode_within(err),
                        f"{name} cluster {p.cluster}: {err}")
            ms = smoke.device_ms(
                torch, lambda i: fd._launch(q, kc[i % LAYERS], vc[i % LAYERS],
                                            n, p),
                reps=args.reps, match=smoke.KERNEL_NAMES["flash_decode"])
            us["plan" if c is None else str(c)] = round(ms * 1e3, 3)
        nbytes = 4 * (2 * B * n * KV * hd + 2 * B * KV * G * hd + 2 * B * KV * G)
        print(json.dumps({"shape": name, "B": B, "KV": KV, "G": G, "hd": hd,
                          "n_valid": n, "plan": plan._asdict(),
                          "bound_us": round(nbytes / smoke.HBM_BYTES_PER_S
                                            * 1e6, 3),
                          "us": us}), flush=True)
        del q, kc, vc


if __name__ == "__main__":
    main()
