"""Flash-decoding with the KV cache's sequence axis cut over the model axis
(sequence parallelism for decode), run by each rank on its own blocks.

Each rank holds a contiguous slot range of the ring buffer, computes its
partial softmax over that range through the hand-written kernel
(:func:`repro_torch.kernels.flash_decode.flash_decode`, or its int8
instance), and the exact result comes back by a max / sum merge (``pmax``
and ``psum``), the math of
:func:`~repro_torch.kernels.flash_decode.combine_partials`.  Per layer the
collectives are small (one gather of a token's q / k / v projections, a
``pmax``, one ``psum`` of the weighted partials, one of the output
projection); the KV cache never moves.

:func:`_partial_attn` is the reference's plain partial (``repro``'s
``distributed/decode.py::_partial_attn``), kept as the kernel path's
plain version.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_int8)
from repro_torch.models.layers import NEG_INF, apply_rope


def _partial_attn(q, kc, vc, n_valid_local: int):
    """q: (B, H, hd); kc / vc: (B, S_loc, KV, hd).  Returns the locally
    normalised ``(out, m, l)`` partial-softmax statistics over the first
    ``n_valid_local`` slots (with none valid: ``m = -1e30`` and ``out`` the
    mean of the values, which the merge weighs by 0)."""
    B, S_loc, KV, hd = kc.shape
    H = q.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), kc.float()) * hd ** -0.5
    valid = torch.arange(S_loc, device=q.device) < n_valid_local
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, vc.float())
    out = out / torch.clamp(l, min=1e-37)[..., None]
    return out.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def local_partial(q, kc, vc, n_local: int, k_scale=None, v_scale=None):
    """This rank's ``(out, m, l)`` over its first ``n_local`` slots,
    through the kernel (its int8 instance when scales are given).  An
    empty range (``n_local == 0``, a shard the ring has not reached) runs
    no kernel: its partial is ``out = 0``, ``m = -1e30``, ``l = 0``, whose
    merge weight ``exp(m - m_g) * l`` is exactly 0."""
    if n_local == 0:
        B, H, hd = q.shape
        return (torch.zeros((B, H, hd), dtype=torch.float32, device=q.device),
                torch.full((B, H), NEG_INF, dtype=torch.float32,
                           device=q.device),
                torch.zeros((B, H), dtype=torch.float32, device=q.device))
    if k_scale is not None:
        return flash_decode_int8(q, kc, vc, k_scale, v_scale, n_local)
    return flash_decode(q, kc, vc, n_local)


def shard_fill(cur: int, ring: int, n_tp: int, tpi: int) -> int:
    """Valid slots of shard ``tpi`` (of ``n_tp``, ``ring // n_tp`` each)
    once token ``cur`` is written: the ring's first ``min(cur + 1, ring)``
    slots, intersected with the shard's range."""
    s_loc = ring // n_tp
    return min(max(min(cur + 1, ring) - tpi * s_loc, 0), s_loc)


def decode_attn_sharded(x, blk, cfg: ArchConfig, k_cache, v_cache, cur: int,
                        ctx, k_scale=None, v_scale=None):
    """One decode-attention layer on this rank's blocks.

    x: (B_loc, D), the rank's batch rows (all of them with
    ``ctx.batch_replicated``); ``wq`` / ``wk`` / ``wv`` column blocks
    ``(D, cols / n_tp)``, ``wo`` a row block ``(H * hd / n_tp, D)``;
    k_cache / v_cache: (B_loc, S_loc, KV, hd), the rank's slot range
    ``[tpi * S_loc, (tpi + 1) * S_loc)`` of a ring of ``S_loc * n_tp``
    slots (int8, with float16 scales (B_loc, S_loc, KV), when scales are
    given); cur: the global token position.  The rank that owns slot
    ``cur % ring`` writes this token's K / V there, in place.  Returns y
    (B_loc, D), the same on every rank of the model axis."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    n_tp = col.axis_size(mesh, tp)
    tpi = col.axis_index(mesh, tp)
    Bl = x.shape[0]
    S_loc = k_cache.shape[1]
    ring = S_loc * n_tp

    # projections, column blocks: one gather assembles all three
    cols = [blk["wq"].shape[1], blk["wk"].shape[1], blk["wv"].shape[1]]
    if n_tp * sum(cols) != (H + 2 * KV) * hd:
        raise ValueError(f"wq / wk / wv column blocks {cols} are not 1/{n_tp} "
                         f"of ({H * hd}, {KV * hd}, {KV * hd})")
    mine = torch.cat([x @ blk["wq"], x @ blk["wk"], x @ blk["wv"]], dim=1)
    full = col.all_gather(mine, mesh, tp, 1).reshape(Bl, n_tp, sum(cols))
    q, kn, vn = (t.reshape(Bl, -1) for t in torch.split(full, cols, dim=2))
    q, kn, vn = (q.reshape(Bl, H, hd), kn.reshape(Bl, KV, hd),
                 vn.reshape(Bl, KV, hd))
    pos = torch.full((Bl, 1), cur, device=x.device)
    q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    kn = apply_rope(kn[:, None], pos, cfg.rope_theta)[:, 0]

    # ring-buffer write: only the owning shard stores the new K / V
    slot = cur % ring
    if slot // S_loc == tpi:
        local_slot = slot - tpi * S_loc
        if k_scale is not None:
            from repro_torch.models.transformer import _quantize_kv
            k_cache[:, local_slot], k_scale[:, local_slot] = \
                _quantize_kv(kn.float())
            v_cache[:, local_slot], v_scale[:, local_slot] = \
                _quantize_kv(vn.float())
        else:
            k_cache[:, local_slot] = kn.to(k_cache.dtype)
            v_cache[:, local_slot] = vn.to(v_cache.dtype)

    # the local partial over my slot range, then the exact merge
    out, m, l = local_partial(q, k_cache, v_cache,
                              shard_fill(cur, ring, n_tp, tpi),
                              k_scale, v_scale)
    m_g = col.pmax(m, mesh, tp)
    w = torch.exp(m - m_g) * l
    sums = col.psum(torch.cat([(out * w[..., None]).reshape(Bl, -1), w],
                              dim=1), mesh, tp)
    num, denom = sums[:, :H * hd].reshape(Bl, H, hd), sums[:, H * hd:]
    out = num / torch.clamp(denom, min=1e-37)[..., None]

    # output projection: my head slice times the row block of wo, summed
    h_loc = blk["wo"].shape[0]
    mine = out.reshape(Bl, H * hd)[:, tpi * h_loc:(tpi + 1) * h_loc]
    return col.psum(mine.to(blk["wo"].dtype) @ blk["wo"], mesh, tp) \
        .to(x.dtype)
