"""Step functions.  This slice of the port has the prefill and serve steps
on one device; training and the sharded steps come with later slices
(ROADMAP Queue A item 14)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (ROADMAP_ITEM, decode_step,
                                            forward)
from repro_torch.torch_device import resolve


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"a {what} step over a device mesh is not ported yet "
            f"({ROADMAP_ITEM}); pass mesh=None")


def make_prefill_step(cfg: ArchConfig, mesh=None, *, torch_device="cuda"):
    """Inference prefill: ``prefill_step(params, batch) -> logits`` of the
    full-sequence forward, without gradients.  ``batch["tokens"]`` (B, S)
    may be a tensor or an array; it is moved to ``torch_device``, where the
    parameters must lie.  Only ``mesh=None`` (one device) is ported."""
    _refuse_mesh(mesh, "prefill")
    dev = resolve(torch_device)

    def prefill_step(params, batch):
        if params["embed"].device.type != dev.type:
            raise ValueError(f"parameters on {params['embed'].device}, but "
                             f"the step runs on {dev}")
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device)
        with torch.no_grad():
            logits, _ = forward(params, cfg, dict(batch, tokens=tokens))
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig, mesh=None):
    """One-token decode: ``serve_step(params, state, tokens) -> (logits,
    state)``.  Only ``mesh=None`` (one device) is ported."""
    _refuse_mesh(mesh, "serve")

    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens)

    return serve_step
