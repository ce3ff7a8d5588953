"""Serving driver: batched greedy token generation with the tiered KV store.

The paper's architecture end to end at serving time: the ring buffer on
the card holds the hot KV window while archived segments land in the
capacity tier ("CXL-SSD") managed by the CXL-SSD-Sim replacement policies,
with simulated device timing attached, so the run reports how much
CXL-SSD latency the cache layer absorbed.

On the card (full width, seeded random weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \\
      --batch 4 --context 512 --prompt-len 32 --gen 608
On the CPU (reduced config, the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 64

The loop (:func:`serve`) is the JAX package's ``repro.launch.serve`` loop:
every ``kv_page_tokens`` steps it archives the ring segment of **K** (not
V) into the store and, from the fourth segment on, reads two earlier
segments back (lookback picks from the same numpy generator as the first
tokens).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.devices import make_device
from repro_torch.distributed.step import make_serve_step
from repro_torch.models.transformer import init_decode_state, init_params
from repro_torch.tiered.store import TieredStore, TieredStoreConfig

POLICIES = ["lru", "fifo", "2q", "lfru", "direct"]


@dataclass
class ServeResult:
    cfg: ArchConfig
    batch: int
    steps: int
    seconds: float                    # host wall time of the loop
    archive_seconds: float            # of which archiving and lookback reads
                                      # (with the wait for queued steps)
    tokens: np.ndarray                # (steps, B) greedy picks, int32
    tiered: TieredStore
    state: dict                       # final decode state
    logits: Optional[List[torch.Tensor]] = None   # per step, if kept

    def report(self) -> List[str]:
        """The ``[serve]`` lines of the JAX driver."""
        t = self.tiered
        return [
            f"[serve] arch={self.cfg.name} batch={self.batch} "
            f"steps={self.steps} ({self.seconds:.2f}s, "
            f"{self.batch * self.steps / self.seconds:.1f} tok/s)",
            f"[serve] tiered-KV: hit-rate={t.hit_rate:.3f} "
            f"fills={t.stats['fills']} "
            f"writebacks={t.stats['writebacks']} "
            f"coalesced={t.stats['coalesced']} "
            f"sim-CXL-SSD-time={t.sim_time_us:.1f}us",
        ]


def serve(params, cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 64, context: int = 256, policy: str = "lru",
          kv_page_tokens: int = 16, seed: int = 0,
          forced: Optional[np.ndarray] = None,
          keep_logits: bool = False) -> ServeResult:
    """Run ``prompt_len + gen`` greedy decode steps of ``params`` on their
    device, archiving KV segments into a :class:`TieredStore` backed by a
    simulated CXL-SSD.  ``forced`` ``(steps, B)``, if given, is fed as the
    next tokens instead of the greedy picks (teacher forcing; the picks are
    still returned)."""
    dev = params["embed"].device
    serve_step = make_serve_step(cfg, mesh=None)
    state = init_decode_state(params, cfg, batch, context)
    # archived KV pages: a page is one ring segment of all layers,
    # (n_layers, batch, kv_page_tokens, KV, hd)
    n_kv_pages = max(context // kv_page_tokens * 4, 8)
    tiered = TieredStore(
        TieredStoreConfig(
            n_logical_pages=n_kv_pages,
            page_shape=(cfg.n_layers, batch, kv_page_tokens, cfg.n_kv_heads,
                        cfg.resolved_head_dim),
            hbm_pages=max(n_kv_pages // 4, 2),
            policy=policy),
        backing=make_device("cxl-ssd"), torch_device=dev)

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch,)).astype(np.int32)).to(dev)

    t0 = time.perf_counter()
    n_steps = prompt_len + gen
    ring = state["k"].shape[2]
    picks_out, logits_out = [], []
    archive_s = 0.0
    for step in range(n_steps):
        logits, state = serve_step(params, state, tokens)
        # greedy next token (mask vocab padding)
        logits = logits[..., :cfg.vocab]
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        picks_out.append(tokens)
        if keep_logits:
            logits_out.append(logits)
        if forced is not None:
            tokens = torch.from_numpy(
                np.asarray(forced[step], np.int32)).to(dev)
        # archive the K segment the ring has just filled into the capacity
        # tier (the paper's DRAM-cache-of-SSD flow)
        if ring and (step + 1) % kv_page_tokens == 0:
            seg = (step + 1) // kv_page_tokens - 1
            lo = (seg * kv_page_tokens) % ring
            if lo + kv_page_tokens <= ring:
                ta = time.perf_counter()
                page = state["k"][:, :, lo:lo + kv_page_tokens].cpu().numpy()
                tiered.write_page(seg % n_kv_pages, page)
                # touch a few historical pages (re-prefill / lookback reads)
                if seg > 2:
                    picks = rng.integers(0, seg, size=2) % n_kv_pages
                    tiered.read_pages(list(picks))
                archive_s += time.perf_counter() - ta
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return ServeResult(cfg=cfg, batch=batch, steps=n_steps, seconds=dt,
                       archive_seconds=archive_s,
                       tokens=torch.stack(picks_out).cpu().numpy(),
                       tiered=tiered, state=state,
                       logits=logits_out if keep_logits else None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--context", type=int, default=256)
    ap.add_argument("--policy", default="lru", choices=POLICIES)
    ap.add_argument("--kv-page-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, args.seed, torch_device=args.device)
    res = serve(params, cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, context=args.context, policy=args.policy,
                kv_page_tokens=args.kv_page_tokens, seed=args.seed)
    for line in res.report():
        print(line)


if __name__ == "__main__":
    main()
