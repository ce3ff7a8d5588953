"""Transformer layers of the serving and prefill paths in PyTorch: RMSNorm,
split-half RoPE, SwiGLU, token and codebook embeddings, full-sequence
attention and single-token decode attention.

Each function keeps the JAX package's layout and numerics (float32
normalisation and softmax, frequencies ``theta ** (arange / hd)`` in
float32, masking with ``NEG_INF = -1e30``), so the two agree to float32
rounding.  :func:`attention_ref` and :func:`decode_attention` are the
plain versions of the hand-written kernels
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.flash_decode`); :func:`flash_attention` is the
prefill path's call into its kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs    # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int) -> torch.Tensor:
    """(q_block, kv_block) causal (+ optional sliding-window) mask."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        causal &= q_pos[:, None] - k_pos[None, :] < window
    return causal


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention through the hand-written kernel (its plain version
    for CPU tensors).  q: (B, S, H, hd); k, v: (B, Skv, KV, hd).  When
    autograd records and an input requires a gradient, the call goes
    through :class:`repro_torch.kernels.flash_attention.FlashAttention`
    (the kernel's ``lse`` instance, then the backward kernels), as the
    reference's goes through its custom VJP.  JAX's ``q_block`` /
    ``kv_block`` / ``impl`` pick tilings of its jnp path and do not change
    the function; the kernels have their own tiles."""
    # imported here: the kernel module builds on this one
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    return kernel(q, k, v, causal=causal, window=window)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_start: int = 0) -> torch.Tensor:
    """O(S * Skv)-memory reference attention.  q: (B, S, H, hd) holds the
    rows at positions ``q_start ..`` of the sequence (a chunk of a longer
    one); k, v: (B, Skv, KV, hd), any Skv when not ``causal``.  It
    computes in float32, or in float64 for float64 inputs."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(ct), k.to(ct)) * hd ** -0.5
    if causal:
        q_pos = torch.arange(q_start, q_start + S, device=q.device)
        mask = _block_mask(q_pos, torch.arange(Skv, device=q.device), window)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(ct))
    return out.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode attention against a (possibly padded) KV cache.

    q: (B, H, hd); k_cache/v_cache: (B, Smax, KV, hd); cur_len: an int or
    an integer tensor of shape () or (B,), the number of valid cache
    entries.  Returns (B, H, hd)."""
    B, Smax, KV, hd = k_cache.shape
    H = q.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_cache.float()) \
        * hd ** -0.5
    pos = torch.arange(Smax, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device).reshape(-1).expand(B)
    valid = pos[None, :] < cur[:, None]
    if window > 0:
        valid &= pos[None, :] >= cur[:, None] - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


# --------------------------------------------------------------------- mlp
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------------------ embeds
def embed_tokens(table: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    return table[token_ids]


def embed_codebooks(tables: torch.Tensor,
                    token_grid: torch.Tensor) -> torch.Tensor:
    """MusicGen-style: tables (nq, V, D), token_grid (B, S, nq) -> the sum
    of the ``nq`` embeddings, added in codebook order."""
    embs = [tables[i][token_grid[..., i]] for i in range(tables.shape[0])]
    return functools.reduce(torch.add, embs)
