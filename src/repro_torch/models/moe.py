"""Mixture-of-Experts layer in PyTorch: top-k routing with the Switch
balance loss, capacity-based sort-free dispatch, the experts' SwiGLU and
a deterministic combine.

The layout and numerics are the JAX package's (``repro.models.moe``):
parameters are a plain dict ``{"router" (D, E), "w_gate" (E, D, F),
"w_up" (E, D, F), "w_down" (E, F, D)}``; each expert takes at most
``capacity_for(T)`` tokens, ranked within their expert by a stable sort
of the expert ids, and the assignments past that capacity are dropped
(their tokens ride the residual).  Ties in the router's top-k go to the
lower expert index, as ``jax.lax.top_k`` gives them.  Where the reference
scatter-adds each token's weighted expert outputs, this module gathers
them and adds them in expert order, which is the reference's order and
needs no atomics on the card, so a run is repeatable bit for bit.

Only the one-device path is here: ``moe_ffn_sharded`` (a ``shard_map``
over a device mesh) raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

SHARDED_ITEM = "ROADMAP Queue A item 14d"
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def moe_param_shapes(d_model: int, cfg: MoEConfig, lead=()) -> Dict[str, tuple]:
    E, Fd = cfg.n_experts, cfg.d_expert
    lead = tuple(lead)
    return {"router": lead + (d_model, E), "w_gate": lead + (E, d_model, Fd),
            "w_up": lead + (E, d_model, Fd), "w_down": lead + (E, Fd, d_model)}


def init_moe_params(d_model: int, cfg: MoEConfig, normal, lead=()
                    ) -> Dict[str, torch.Tensor]:
    """Random expert parameters with the reference's scales, drawn by
    ``normal(shape, std)``, with ``lead`` axes in front (the stacked
    layers)."""
    shapes = moe_param_shapes(d_model, cfg, lead)
    s_in, s_out = d_model ** -0.5, cfg.d_expert ** -0.5
    return {k: normal(shapes[k], s_out if k == "w_down" else s_in)
            for k in MOE_KEYS}


def capacity_for(tokens: int, cfg: MoEConfig,
                 factor: Optional[float] = None) -> int:
    f = cfg.capacity_factor if factor is None else factor
    return max(1, math.ceil(tokens * cfg.top_k / cfg.n_experts * f))


def _route(x, router, top_k: int):
    """x: (T, D) -> (weights (T, K), expert_idx (T, K), aux_loss)."""
    logits = x.float() @ router.float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index
    # first, as jax.lax.top_k does
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    E = router.shape[1]
    density = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(density * mean_prob)
    return weights, idx, aux


def _grouping(flat, n_experts: int):
    """The flat assignments grouped by expert: ``order`` (a stable sort of
    the expert ids), ``counts (E,)`` and each expert's ``start``."""
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    return order, counts, start


def _dispatch_indices(expert_idx, n_experts: int, capacity: int):
    """``slots (E, C)`` of flat assignment ids ``t * K + k``, grouped by
    expert in a stable order, and ``valid (E, C)``."""
    flat = expert_idx.reshape(-1)
    TK = flat.numel()
    order, counts, start = _grouping(flat, n_experts)
    ar = torch.arange(capacity, device=flat.device)
    pos = start[:, None] + ar[None, :]
    valid = ar[None, :] < torch.clamp(counts, max=capacity)[:, None]
    slots = order[torch.clamp(pos, 0, TK - 1)]
    return slots, valid


def _expert_ffn(xe, w_gate, w_up, w_down):
    """xe: (E, C, D) grouped tokens -> (E, C, D)."""
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def moe_ffn_local(x, p: Dict[str, torch.Tensor], cfg: MoEConfig,
                  capacity_factor: Optional[float] = None):
    """One-device MoE: x (T, D) -> ((T, D), aux_loss)."""
    T, D = x.shape
    K = cfg.top_k
    weights, idx, aux = _route(x, p["router"], K)
    C = capacity_for(T, cfg, capacity_factor)
    slots, valid = _dispatch_indices(idx, cfg.n_experts, C)
    token_of = slots // K                                     # (E, C)
    xe = x[token_of] * valid[..., None]                       # (E, C, D)
    ye = _expert_ffn(xe.to(x.dtype), p["w_gate"], p["w_up"], p["w_down"])
    # where each assignment t * K + k landed: its rank within its expert
    flat = idx.reshape(-1)
    order, _, start = _grouping(flat, cfg.n_experts)
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=x.device) - start[flat[order]]
    kept = (rank < C).reshape(T, K)
    # each token's K weighted outputs, added in expert order (the
    # reference's scatter order); dropped assignments add nothing
    by_expert = torch.argsort(idx, dim=1)
    e_sorted = torch.gather(idx, 1, by_expert)
    r_sorted = torch.gather(rank.reshape(T, K), 1, by_expert)
    w_sorted = torch.gather(weights * kept, 1, by_expert)
    k_sorted = torch.gather(kept, 1, by_expert)
    out = torch.zeros((T, D), dtype=ye.dtype, device=x.device)
    for k in range(K):
        rows = ye[e_sorted[:, k], torch.clamp(r_sorted[:, k], max=C - 1)]
        out = out + torch.where(k_sorted[:, k, None],
                                rows * w_sorted[:, k, None], 0.0)
    return out.to(x.dtype), aux


def moe_ffn_sharded(*args, **kwargs):
    """The reference's ``shard_map`` MoE over a device mesh: not ported."""
    raise NotImplementedError(
        f"moe_ffn_sharded runs over a device mesh, which is not ported yet "
        f"({SHARDED_ITEM}); use moe_ffn_local on one device")
