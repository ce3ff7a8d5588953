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

:func:`moe_ffn_sharded` is the reference's ``shard_map`` MoE over a
device mesh, run by each rank on its own blocks over ``torch.distributed``
(:mod:`repro_torch.distributed.collectives`), in its three bodies:
resident experts (the decode layout: tokens gathered over dp, expert
weights never move), ``ep`` (an ``all_to_all`` of ``(E, C, D)`` blocks to
the experts' owners and back) and ``tp`` (each expert's hidden dimension
cut over tp, partial outputs summed).  :func:`expert_specs` gives the
blocks each body takes, which are its ``shard_map``'s ``in_specs``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def moe_param_shapes(d_model: int, cfg: MoEConfig, lead=()) -> Dict[str, tuple]:
    E, Fd = cfg.n_experts, cfg.d_expert
    lead = tuple(lead)
    return {"router": lead + (d_model, E), "w_gate": lead + (E, d_model, Fd),
            "w_up": lead + (E, d_model, Fd), "w_down": lead + (E, Fd, d_model)}


def init_moe_params(d_model: int, cfg: MoEConfig, normal, lead=(),
                    place=None) -> Dict[str, torch.Tensor]:
    """Random expert parameters with the reference's scales, drawn by
    ``normal(shape, std)``, with ``lead`` axes in front (the stacked
    layers); ``place(name, tensor)``, when given, takes each one as soon
    as it is drawn (to cut it to a rank's block)."""
    shapes = moe_param_shapes(d_model, cfg, lead)
    s_in, s_out = d_model ** -0.5, cfg.d_expert ** -0.5
    place = place or (lambda _, t: t)
    return {k: place(k, normal(shapes[k], s_out if k == "w_down" else s_in))
            for k in MOE_KEYS}


def capacity_for(tokens: int, cfg: MoEConfig,
                 factor: Optional[float] = None) -> int:
    f = cfg.capacity_factor if factor is None else factor
    return max(1, math.ceil(tokens * cfg.top_k / cfg.n_experts * f))


def _route_probs(x, router, top_k: int):
    """x: (T, D) -> (weights (T, K), expert_idx (T, K), probs (T, E))."""
    logits = x.float() @ router.float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index
    # first, as jax.lax.top_k does
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx, probs


def _balance(idx, probs):
    """The Switch balance loss of a token set: ``E`` times the sum over
    experts of the share of tokens whose first choice it is times its mean
    probability."""
    E = probs.shape[1]
    density = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    return E * torch.sum(density * probs.mean(dim=0))


def _route(x, router, top_k: int):
    """x: (T, D) -> (weights (T, K), expert_idx (T, K), aux_loss)."""
    weights, idx, probs = _route_probs(x, router, top_k)
    return weights, idx, _balance(idx, probs)


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


def _combine(ye, weights, idx, n_experts: int, capacity: int, e_lo: int = 0):
    """Each token's weighted outputs (T, D) from ``ye`` (E_y, C, D), the
    capacity slots of experts ``[e_lo, e_lo + E_y)``, added in expert
    order (the reference's scatter order); assignments past the capacity,
    or to other experts, add nothing."""
    T, K = idx.shape
    E_y, C = ye.shape[0], capacity
    flat = idx.reshape(-1)
    # where each assignment t * K + k landed: its rank within its expert
    order, _, start = _grouping(flat, n_experts)
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=idx.device) - start[flat[order]]
    kept = ((rank < C).reshape(T, K) & (idx >= e_lo) & (idx < e_lo + E_y))
    by_expert = torch.argsort(idx, dim=1)
    e_sorted = torch.gather(idx, 1, by_expert) - e_lo
    r_sorted = torch.gather(rank.reshape(T, K), 1, by_expert)
    w_sorted = torch.gather(weights * kept, 1, by_expert)
    k_sorted = torch.gather(kept, 1, by_expert)
    out = torch.zeros((T, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for k in range(K):
        rows = ye[torch.clamp(e_sorted[:, k], 0, E_y - 1),
                  torch.clamp(r_sorted[:, k], max=C - 1)]
        out = out + torch.where(k_sorted[:, k, None],
                                rows * w_sorted[:, k, None], 0.0)
    return out


def _grouped_tokens(x, slots, valid, K: int):
    """The tokens of ``x`` (T, D) in their experts' capacity slots (E, C,
    D); empty slots zero."""
    return x[slots // K] * valid[..., None]


def moe_ffn_local(x, p: Dict[str, torch.Tensor], cfg: MoEConfig,
                  capacity_factor: Optional[float] = None):
    """One-device MoE: x (T, D) -> ((T, D), aux_loss)."""
    T, D = x.shape
    K = cfg.top_k
    weights, idx, aux = _route(x, p["router"], K)
    C = capacity_for(T, cfg, capacity_factor)
    slots, valid = _dispatch_indices(idx, cfg.n_experts, C)
    xe = _grouped_tokens(x, slots, valid, K)                  # (E, C, D)
    ye = _expert_ffn(xe.to(x.dtype), p["w_gate"], p["w_up"], p["w_down"])
    return _combine(ye, weights, idx, cfg.n_experts, C).to(x.dtype), aux


# ----------------------------------------------------------- on a mesh
def moe_mode(cfg: MoEConfig, n_tp: int, resident_experts: bool = False
             ) -> str:
    """Which body of :func:`moe_ffn_sharded` runs: ``"resident"``,
    ``"ep"`` or ``"tp"``, as the reference chooses it."""
    if resident_experts and cfg.sharding == "ep" and n_tp > 1:
        return "resident"
    if cfg.sharding == "ep" and cfg.n_experts % n_tp == 0 and n_tp > 1:
        return "ep"
    return "tp"


def expert_specs(mode: str, dp_axes: Tuple[str, ...], tp_axis: str,
                 batch_replicated: bool = False) -> Dict[str, P]:
    """The blocks of ``router``, ``w_gate``, ``w_up``, ``w_down`` (without
    the layer axis) that body ``mode`` takes: the reference's
    ``in_specs``."""
    from repro_torch.distributed.sharding import P

    dp = None if batch_replicated or not dp_axes else tuple(dp_axes)
    tp = tp_axis
    if mode == "resident":
        return {"router": P(None, None), "w_gate": P(tp, None, dp),
                "w_up": P(tp, None, dp), "w_down": P(tp, dp, None)}
    if mode == "ep":
        return {"router": P(None, None), "w_gate": P(tp, None, None),
                "w_up": P(tp, None, None), "w_down": P(tp, None, None)}
    return {"router": P(None, None), "w_gate": P(None, None, tp),
            "w_up": P(None, None, tp), "w_down": P(None, tp, None)}


def moe_ffn_sharded(x, p: Dict[str, torch.Tensor], cfg: MoEConfig, mesh,
                    dp_axes: Tuple[str, ...], tp_axis: str,
                    capacity_factor: Optional[float] = None,
                    batch_replicated: bool = False,
                    resident_experts: bool = False, batch_aux: bool = False):
    """The MoE layer over a (dp..., tp) ``DeviceMesh``, on this rank's
    blocks: x (B_loc, S, D), its rows this rank's part of the batch over
    ``dp_axes`` (or the whole batch with ``batch_replicated``); ``p`` the
    blocks :func:`expert_specs` names for :func:`moe_mode`'s body.
    Returns (this rank's (B_loc, S, D), the aux loss).

    ``resident_experts`` (for ``ep`` configs) is the decode layout:
    experts over tp and their hidden dimension over dp stay put, and the
    few decode tokens are gathered instead.  Capacity counts the tokens a
    body routes: all of them there, this rank's in the ``ep`` and ``tp``
    bodies."""
    # imported here: repro_torch.distributed builds on the models
    from repro_torch.distributed import collectives as col

    B, S, D = x.shape
    K, E = cfg.top_k, cfg.n_experts
    n_tp = col.axis_size(mesh, tp_axis)
    dp_axes = () if batch_replicated else tuple(dp_axes)
    mode = moe_mode(cfg, n_tp, resident_experts)
    xf = x.reshape(-1, D)
    T_loc = xf.shape[0]
    if mode == "resident":
        # every token (tiny at decode) to every rank, which serves its
        # resident experts; gathered innermost axis first, so that the
        # rows run in the batch's (pod-major) order
        for axn in reversed(dp_axes):
            xf = col.all_gather(xf, mesh, axn, 0)
        weights, idx, aux = _route(xf, p["router"], K)
        C = capacity_for(xf.shape[0], cfg, capacity_factor)
        slots, valid = _dispatch_indices(idx, E, C)
        e_loc = p["w_gate"].shape[0]
        lo = col.axis_index(mesh, tp_axis) * e_loc
        xe = _grouped_tokens(xf, slots[lo:lo + e_loc], valid[lo:lo + e_loc], K)
        ye = _expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
        # the expert hidden dimension is cut over dp: partial sums
        for axn in dp_axes:
            ye = col.psum(ye, mesh, axn)
        out = col.psum(_combine(ye.float(), weights, idx, E, C, lo), mesh,
                       tp_axis)
        if dp_axes:                       # keep my dp slice of the tokens
            dpi = 0
            for axn in dp_axes:
                dpi = dpi * col.axis_size(mesh, axn) + col.axis_index(mesh, axn)
            out = out[dpi * T_loc:(dpi + 1) * T_loc]
        aux = col.pmean(aux, mesh, tp_axis)
        return out.reshape(x.shape).to(x.dtype), aux
    weights, idx, probs = _route_probs(xf, p["router"], K)
    C = capacity_for(T_loc, cfg, capacity_factor)
    slots, valid = _dispatch_indices(idx, E, C)
    if mode == "ep":
        # each expert's block to its owner; rows now hold my experts'
        # tokens from every source rank
        xe = _grouped_tokens(xf, slots, valid, K)              # (E, C, D)
        xr = col.exchange(xe, mesh, tp_axis)
        e_loc = E // n_tp
        xr = xr.reshape(n_tp, e_loc, C, D).transpose(0, 1) \
               .reshape(e_loc, n_tp * C, D)
        w = [col.scale_grad(p[k], 1.0 / n_tp)
             for k in ("w_gate", "w_up", "w_down")]
        yr = _expert_ffn(xr, *w)
        yr = yr.reshape(e_loc, n_tp, C, D).transpose(0, 1).reshape(E, C, D)
        ye = col.exchange(yr, mesh, tp_axis)
    else:
        xe = _grouped_tokens(col.copy_to(xf, mesh, tp_axis), slots, valid, K)
        ye = col.reduce_from(_expert_ffn(xe, p["w_gate"], p["w_up"],
                                         p["w_down"]),
                             mesh, tp_axis)      # reduce over F shards
    out = _combine(ye.float(), weights, idx, E, C)
    if batch_aux:
        counts = F.one_hot(idx[:, 0], E).float().sum(dim=0)
        prob_sum = probs.sum(dim=0)
        T_all = T_loc
        for axn in dp_axes:
            counts = col.psum(counts, mesh, axn)
            prob_sum = col.reduce_from(prob_sum, mesh, axn)
            T_all *= col.axis_size(mesh, axn)
        aux = E * torch.sum((counts / T_all) * (prob_sum / T_all))
    else:
        aux = col.pmean(_balance(idx, probs), mesh, tp_axis)
        for axn in dp_axes:
            aux = col.pmean(aux, mesh, axn)
    return out.reshape(x.shape).to(x.dtype), aux
