"""Training driver: config -> seeded parameters -> train step -> loop with
checkpointing, the straggler watchdog, the WSD schedule and a
preemption-safe restart, on one device.

On the CPU (reduced config, the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --device cpu --steps 200 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt
On the card (full width; the attention kernels and their backward):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 8 --batch 2 --seq 2048

The loop is the JAX package's ``repro.launch.train`` loop (its flags,
schedule, loader seed, checkpoint cadence and final save) with
``--device`` (default ``cuda``), and two flags of the port's own:
``--n-layers`` keeps the config's first N layers (a depth cut, for a model
whose full depth does not fit beside its optimizer state), and
``--moment-dtype`` picks AdamW's float32 or int8 moments.  Checkpoints go
through :class:`repro_torch.checkpoint.manager.CheckpointManager`
(parameters, the optimizer state with its ``count`` and, under int8, its
codes and float16 scales; the loader's cursor in ``extra``).
:func:`main` returns a :class:`TrainResult`.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.distributed.step import make_train_step
from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedules import wsd_schedule


@dataclass
class TrainResult:
    cfg: ArchConfig
    start_step: int               # 0, or the step a resume started from
    losses: List[float]           # one a step run, in order
    step_seconds: List[float]     # host wall time a step (ends in a sync)
    params: dict
    opt_state: dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="keep the first N layers (a depth cut)")
    ap.add_argument("--moment-dtype", default="f32", choices=["f32", "int8"])
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} layers={cfg.n_layers} device={args.device}",
          flush=True)

    params = init_params(cfg, args.seed, torch_device=args.device)
    adamw_cfg = AdamWConfig(moment_dtype=args.moment_dtype)
    opt_state = adamw_init(params, args.moment_dtype)
    loader = ShardedLoader(cfg, args.seq, args.batch, seed=args.seed + 1)

    lr_fn = wsd_schedule(args.lr, warmup_steps=max(args.steps // 20, 5),
                         stable_steps=int(args.steps * 0.7),
                         decay_steps=max(int(args.steps * 0.25), 1))
    train_step = make_train_step(cfg, mesh=None, lr_fn=lr_fn,
                                 adamw_cfg=adamw_cfg)

    start_step = 0
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, extra, start_step = ckpt.restore(
            {"params": params, "opt": opt_state},
            device=params["embed"].device)
        params, opt_state = state["params"], state["opt"]
        loader.restore(extra["loader"])
        print(f"[train] resumed from step {start_step}", flush=True)

    watchdog = StragglerWatchdog()
    losses, seconds = [], []
    for step in range(start_step, args.steps):
        batch = loader.next()
        watchdog.start_step()
        params, opt_state, loss = train_step(params, opt_state, batch, step)
        loss = float(loss)                     # waits for the device
        rep = watchdog.end_step()
        losses.append(loss)
        seconds.append(rep.duration_s)
        if rep.flagged:
            print(f"[watchdog] step {step} slow: {rep.duration_s:.3f}s "
                  f"(ewma {rep.ewma_s:.3f}s)"
                  + (" -> EVICT ADVISED" if rep.evict_advised else ""))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(lr_fn(step)):.2e} "
                  f"({rep.duration_s:.2f}s/step)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, {"params": params, "opt": opt_state},
                            extra={"loader": loader.state()})
    if ckpt:
        ckpt.wait()
        ckpt.save(args.steps, {"params": params, "opt": opt_state},
                  extra={"loader": loader.state()})
    if losses:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"[train] done: loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return TrainResult(cfg, start_step, losses, seconds, params, opt_state)


if __name__ == "__main__":
    main()
