"""Step functions.  This slice of the port has the serve step on one
device; training, prefill and the sharded steps come with later
slices (ROADMAP Queue A item 14)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import ROADMAP_ITEM, decode_step


def make_serve_step(cfg: ArchConfig, mesh=None):
    """One-token decode: ``serve_step(params, state, tokens) -> (logits,
    state)``.  Only ``mesh=None`` (one device) is ported."""
    if mesh is not None:
        raise NotImplementedError(
            f"a serve step over a device mesh is not ported yet "
            f"({ROADMAP_ITEM}); pass mesh=None")

    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens)

    return serve_step
