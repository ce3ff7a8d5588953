"""Public wrappers of the kernels, as the JAX package's ``kernels/ops.py``
has them.

The page kernels address pages as ``(P, R, C)``; their wrappers flatten
any trailing page shape onto that form and back.  The flattening is a
view, so :func:`page_scatter_op` still writes the caller's pool in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.page_gather import page_gather, page_scatter


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention; the JAX wrapper's ``bq`` / ``bk`` tile sizes are
    the kernel's own here."""
    return flash_attention(q, k, v, causal=causal, window=window)


def _as3d(x: torch.Tensor):
    """``(x as (P, R, C), original shape or None)``."""
    if x.dim() == 3:
        return x, None
    shape = tuple(x.shape)
    r = shape[1] if x.dim() > 1 else 1
    c = math.prod(shape[2:])
    return x.view(shape[0], r, max(c, 1)), shape


def page_gather_op(pool: torch.Tensor, table) -> torch.Tensor:
    pool3, orig = _as3d(pool)
    out = page_gather(pool3, table)
    if orig is not None:
        out = out.view((out.shape[0],) + orig[1:])
    return out


def page_scatter_op(pool: torch.Tensor, table, pages: torch.Tensor
                    ) -> torch.Tensor:
    pool3, orig = _as3d(pool)
    pages3, _ = _as3d(pages)
    out = page_scatter(pool3, table, pages3)
    return out.view(orig) if orig is not None else out


__all__ = ["flash_attention_op", "page_gather_op", "page_scatter_op"]
