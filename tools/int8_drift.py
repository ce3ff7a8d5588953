#!/usr/bin/env python3
"""How far two one-device decodes drift apart when their inputs differ by
one float32 ulp, with float32 and with int8 KV caches.

    python tools/int8_drift.py [--device cuda] [--reduced] [--seed 0]

Runs ``chip_smoke.py``'s ``[mesh]`` int8 model (h2o-danube-3-4b at full
width and depth; ``--reduced`` for its small twin), seeded weights, the
``[mesh]`` int8 run's tokens (40 steps, batch 4, a 64-slot ring), on one
device, twice for each cache kind: once as it is, once with every
embedding nudged one ulp up (``torch.nextafter``) before the first layer.
The nudge is the size of the differences that a device mesh's column
blocks and partial sums bring (``tests/test_torch_mesh_serve.py`` and
``[mesh]`` hold the float32 mesh to the one-device decode at ~1e-5 of the
largest logit).  Prints the card's name and power limit (on the card),
then one JSON line per cache kind: the largest logit difference and its
share of the largest |logit|, the share of (step, row) argmaxes that
agree, and for int8 how many cached codes differ after the run and by
how much at most.  A large int8 drift from a one-ulp nudge says that the
quantizer, not the mesh, sets how far a free-running int8 mesh decode
can stay from the one-device one.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def decode(cfg, params, tokens, dev, nudge: bool):
    """Logits (steps, batch, vocab) on the host and the final state."""
    embed = T._embed

    def nudged(*args, **kwargs):
        x = embed(*args, **kwargs)
        return torch.nextafter(x, torch.full_like(x, float("inf")))

    T._embed = nudged if nudge else embed
    try:
        state = T.init_decode_state(params, cfg, tokens.shape[1],
                                    smoke.MESH["context"])
        out = []
        for t in torch.as_tensor(tokens, device=dev):
            logits, state = T.decode_step(params, cfg, state, t)
            out.append(logits.cpu())
    finally:
        T._embed = embed
    return torch.stack(out), state


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("int8_drift: no CUDA device")
        print(smoke.smi("name,power.limit"), flush=True)
    plan = smoke.mesh_runs(args.seed)
    int8_cfg = plan["runs"]["int8"][0]
    tokens = plan["tokens"]["int8"]
    if args.reduced:
        int8_cfg = int8_cfg.reduced()
        tokens = tokens % int8_cfg.vocab
    for kv in ("model", "int8"):
        cfg = dataclasses.replace(int8_cfg, kv_dtype=kv)
        params = T.init_params(cfg, args.seed, torch_device=dev)
        base, s0 = decode(cfg, params, tokens, dev, nudge=False)
        moved, s1 = decode(cfg, params, tokens, dev, nudge=True)
        err = float((base - moved).abs().max())
        largest = float(base.abs().max())
        row = {"kv": kv, "arch": cfg.name, "layers": cfg.n_layers,
               "steps": len(tokens), "batch": tokens.shape[1],
               "ring": smoke.MESH["context"], "max_logit_diff": err,
               "largest_logit": largest, "rel": err / largest,
               "argmax_agree": float((base.argmax(-1) == moved.argmax(-1))
                                     .float().mean())}
        if kv == "int8":
            diff = [(s0[k].int() - s1[k].int()).abs() for k in ("k", "v")]
            row.update(codes_differing=sum(int((d != 0).sum()) for d in diff),
                       codes=sum(d.numel() for d in diff),
                       max_code_diff=max(int(d.max()) for d in diff))
        print(json.dumps(row), flush=True)
        del params, s0, s1
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
