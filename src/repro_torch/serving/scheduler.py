"""Continuous-batching serving scheduler.

Production serving keeps a fixed decode batch full: finished sequences free
their slot, queued requests claim it mid-flight (prefill-on-join), and the
per-slot KV ranges live in the ring buffer managed by the decode step.  The
scheduler owns:

  * a FIFO admission queue with per-request prompt/max-token budgets;
  * slot lifecycle (join → prefill token-feed → decode → retire on EOS or
    budget), with per-slot position counters so RoPE phases stay correct.

Retired slots' KV stays in the ring buffer; nothing is archived into a
:class:`repro_torch.tiered.TieredStore` here.

The model interface is the framework's ``serve_step`` (one token per slot
per tick); joining sequences are prefilled by feeding their prompt tokens
through the same step — simple, always-batched, and correct for the ring
KV cache (each slot's writes land at its own positions).

Note the deliberate simplification vs. per-slot position tracking: the
ring buffer is indexed by the GLOBAL step counter, so slots that join late
waste the slots' earlier ring positions.  With window-bounded caches (SWA)
this is harmless; for full caches the context budget shrinks by the join
offset.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.torch_device import resolve


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the scheduler
    output: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class SchedulerConfig:
    batch_slots: int = 4
    pad_id: int = 0


class BatchScheduler:
    """Drives ``serve_step`` with a continuously-full batch.  Token ids go
    to ``torch_device`` (the card unless the caller asks for the CPU), the
    logits come back to the host for the greedy pick."""

    def __init__(self, serve_step: Callable, init_state: Callable,
                 cfg: SchedulerConfig, vocab: int, torch_device="cuda") -> None:
        self._step = serve_step
        self._init_state = init_state
        self.cfg = cfg
        self.vocab = vocab
        self.device = resolve(torch_device)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.batch_slots
        self._cursor: List[int] = [0] * cfg.batch_slots  # prompt feed pos
        self.completed: Dict[int, Request] = {}
        self.state = None
        self.ticks = 0

    # ------------------------------------------------------------------ api
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                self.slots[i] = self.queue.popleft()
                self._cursor[i] = 0

    def _next_feed(self) -> np.ndarray:
        """Token each slot feeds this tick: prompt token (prefill phase) or
        its last generated token (decode phase); pad for empty slots."""
        toks = np.full((self.cfg.batch_slots,), self.cfg.pad_id, np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            cur = self._cursor[i]
            if cur < len(req.prompt):
                toks[i] = req.prompt[cur]
            elif req.output:
                toks[i] = req.output[-1]
            else:  # first decode token comes from the prompt's last logits
                toks[i] = req.prompt[-1]
        return toks

    def _absorb(self, logits: np.ndarray) -> None:
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._cursor[i] += 1
            if self._cursor[i] < len(req.prompt):
                continue  # still prefilling: discard logits
            tok = int(np.argmax(logits[i][: self.vocab]))
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.output) >= req.max_new_tokens:
                req.done = True
                self.completed[req.rid] = req
                self.slots[i] = None

    def run(self, max_ticks: int = 1000) -> Dict[int, Request]:
        """Tick until every submitted request completes (or max_ticks)."""
        if self.state is None:
            self.state = self._init_state(self.cfg.batch_slots)
        while (self.queue or any(self.slots)) and self.ticks < max_ticks:
            self._admit()
            toks = torch.from_numpy(self._next_feed()).to(self.device)
            logits, self.state = self._step(self.state, toks)
            self._absorb(logits.cpu().numpy())
            self.ticks += 1
        return self.completed

    @property
    def occupancy(self) -> float:
        return sum(s is not None for s in self.slots) / self.cfg.batch_slots
