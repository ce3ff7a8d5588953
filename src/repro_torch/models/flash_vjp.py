"""Differentiable prefill attention under the reference's names.

The reference (the JAX package's ``models/flash_vjp.py``) gives its jnp
attention a custom VJP that saves only ``(q, k, v, out, lse)`` and
recomputes the score tiles in the backward pass.  The port's counterpart
is :class:`repro_torch.kernels.flash_attention.FlashAttention` (on the
card the forward kernel's ``LSE`` instance and the three backward
kernels; CPU tensors take the plain versions); this module only names it
as the reference does.

``flash_attention_vjp`` and ``flash_attention_tri`` are the reference's
names: there they pick a tiling of the jnp scans (a full grid of blocks,
or only the causally reachable pairs) and ``q_block`` / ``kv_block``
their sizes; here both are the same function, and the kernels tile for
themselves.  A shape the kernels do not take raises ``ValueError`` on
both devices.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import FlashAttention


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        q_block: int = 256, kv_block: int = 256
                        ) -> torch.Tensor:
    """Attention ``(B, S, H, hd)`` of q ``(B, S, H, hd)`` over k, v ``(B,
    Skv, KV, hd)``, differentiable in all three (``q_block`` /
    ``kv_block`` are the reference's tiling and change nothing)."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window))


flash_attention_tri = flash_attention_vjp
