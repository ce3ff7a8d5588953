"""Decoder models: parameters, the full-sequence forward (prefill), the
ring-buffer decode state and one-token decode, in PyTorch, for the
dense, moe, ssm, hybrid and audio families.

The layout is the JAX package's: layer parameters are stacked along a
leading ``n_layers`` axis in a plain dict (``params["blocks"]["wq"]`` is
``(n_layers, d, H * hd)``; the MoE and SSM parameters are nested dicts,
``params["blocks"]["moe"]["w_gate"]`` ``(n_layers, E, d, F)``), weights
are applied as ``x @ W`` with ``W`` ``(d_in, d_out)``, and the decode
state holds ring-buffer KV caches ``(n_layers, B, Sc, KV, hd)`` of ``Sc =
min(context, window)`` slots, with ``kv_dtype="int8"`` int8 caches and
float16 scales ``(n_layers, B, Sc, KV)`` (one a slot and KV head), and
the SSM states ``{"h", "conv_buf"}`` stacked the same way.  Audio models
embed ``(B, S, nq)`` token grids through ``nq`` codebooks and predict
``(B, S, nq, V)`` logits.

Where JAX scans over the stacked layers, this module loops in Python, and
where JAX returns new caches and states, :func:`decode_step` writes this
token's K/V (and scales) and each layer's new SSM state into the state in
place (no copy of a cache).  Attention goes through the hand-written
kernels: prefill through
:func:`repro_torch.kernels.flash_attention.flash_attention` (once per
attention layer), decode through
:func:`repro_torch.kernels.flash_decode.flash_decode`, or
:func:`~repro_torch.kernels.flash_decode.flash_decode_int8` over int8
caches.

The port runs one device, for inference.  The vlm family
(cross-attention layers), a device mesh and ``remat=True`` (a training
option) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_int8
from repro_torch.models import layers as L
from repro_torch.models.moe import (init_moe_params, moe_ffn_local,
                                    moe_param_shapes)
from repro_torch.models.ssm import (init_ssm_params, ssd_decode_step,
                                    ssd_forward, ssm_param_shapes,
                                    ssm_state_shapes)
from repro_torch.torch_device import resolve

ROADMAP_ITEM = "ROADMAP Queue A item 14"
VLM_ITEM = "ROADMAP Queue A item 14b, the vlm bullet"
MESH_ITEM = "ROADMAP Queue A item 14d"
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio")


def require_ported(cfg: ArchConfig) -> None:
    """Refuse what the port does not run."""
    if cfg.cross_attn_every:
        also = (" (and with kv_dtype='int8' the reference's vlm decode "
                "loop passes no scales)" if cfg.kv_dtype == "int8" else "")
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers are not ported yet{also} "
            f"({VLM_ITEM})")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({ROADMAP_ITEM})")
    if cfg.kv_dtype not in ("model", "int8"):
        raise NotImplementedError(
            f"{cfg.name}: kv_dtype={cfg.kv_dtype!r} is not ported "
            f"({ROADMAP_ITEM})")


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the layout of :func:`init_params`."""
    require_ported(cfg)
    d, f, nl, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    qd = cfg.n_heads * cfg.resolved_head_dim
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    shapes: Dict[str, Any] = {}
    if cfg.n_codebooks:
        shapes["embed"] = (cfg.n_codebooks, V, d)
        shapes["lm_head"] = (cfg.n_codebooks, d, V)
    else:
        shapes["embed"] = (V, d)
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (d, V)
    shapes["final_norm"] = (d,)
    blocks: Dict[str, Any] = {"ln1": (nl, d)}
    if cfg.family == "ssm":
        blocks["ssm"] = ssm_param_shapes(d, cfg.ssm, (nl,))
    else:
        blocks.update({"ln2": (nl, d), "wq": (nl, d, qd), "wk": (nl, d, kvd),
                       "wv": (nl, d, kvd), "wo": (nl, qd, d)})
        if cfg.family == "hybrid":
            blocks["ssm"] = ssm_param_shapes(d, cfg.ssm, (nl,))
            blocks["norm_attn"] = (nl, d)
            blocks["norm_ssm"] = (nl, d)
        if cfg.moe is not None:
            blocks["moe"] = moe_param_shapes(d, cfg.moe, (nl,))
        elif f:
            blocks.update({"w_gate": (nl, d, f), "w_up": (nl, d, f),
                           "w_down": (nl, f, d)})
    shapes["blocks"] = blocks
    return shapes


# ----------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0, *, torch_device="cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's scales (normal draws times
    ``d_in ** -0.5``, embeddings times 0.02, norms at one, the SSM's
    constants), drawn from one ``torch.Generator`` seeded with ``seed`` on
    ``torch_device``.  The draws are not JAX's: to run JAX's weights,
    convert them with :func:`repro_torch.convert.params_from_jax`."""
    dev = resolve(torch_device)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd = cfg.n_heads * cfg.resolved_head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(std).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params: Dict[str, Any] = {"embed": normal(shapes["embed"], 0.02)}
    if "lm_head" in shapes:
        params["lm_head"] = normal(shapes["lm_head"], d ** -0.5)
    params["final_norm"] = ones(shapes["final_norm"])
    std = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
           "w_gate": d ** -0.5, "w_up": d ** -0.5}
    if qd:
        std["wo"] = qd ** -0.5
    if f:
        std["w_down"] = f ** -0.5
    blocks = {}
    for k, shape in shapes["blocks"].items():
        if k == "ssm":
            blocks[k] = init_ssm_params(d, cfg.ssm, normal, device=dev,
                                        dtype=dtype, lead=(nl,))
        elif k == "moe":
            blocks[k] = init_moe_params(d, cfg.moe, normal, lead=(nl,))
        elif k in std:
            blocks[k] = normal(shape, std[k])
        else:                                  # ln1, ln2, norm_attn, norm_ssm
            blocks[k] = ones(shape)
    params["blocks"] = blocks
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or state tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# -------------------------------------------------------------- forward
def _embed(params, cfg: ArchConfig, tokens):
    if cfg.n_codebooks:
        return L.embed_codebooks(params["embed"], tokens)
    return L.embed_tokens(params["embed"], tokens)


def _unembed(params, cfg: ArchConfig, x):
    if cfg.n_codebooks:
        return torch.einsum("bsd,qdv->bsqv", x, params["lm_head"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def attention_inputs(x, blk, cfg: ArchConfig, positions):
    """q (B, S, H, hd), k and v (B, S, KV, hd) of one attention layer, with
    RoPE applied to q and k.  x: (B, S, D), normalised."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ blk["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ blk["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ blk["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_forward(x, blk, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    q, k, v = attention_inputs(x, blk, cfg, positions)
    o = L.flash_attention(q, k, v, causal=True, window=cfg.swa_window)
    return o.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ blk["wo"]


def _ffn_forward(x, blk, cfg: ArchConfig):
    """The block's FFN on x (B, S, D): the MoE layer, SwiGLU, or nothing.
    Returns (y, aux)."""
    if cfg.moe is not None:
        B, S, D = x.shape
        y, aux = moe_ffn_local(x.reshape(-1, D), blk["moe"], cfg.moe)
        return y.reshape(B, S, D), aux
    if cfg.d_ff:
        return L.swiglu(x, blk["w_gate"], blk["w_up"], blk["w_down"]), 0.0
    return torch.zeros_like(x), 0.0


def _mix(a, s, blk, cfg: ArchConfig):
    """The hybrid family's fusion of its attention and SSM outputs."""
    return 0.5 * (L.rms_norm(a, blk["norm_attn"], cfg.norm_eps)
                  + L.rms_norm(s, blk["norm_ssm"], cfg.norm_eps))


def _block_forward(x, blk, cfg: ArchConfig, positions):
    """One decoder block (attention / SSM / both, then the FFN).  Returns
    (x, aux)."""
    h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssd_forward(h, blk["ssm"], cfg.ssm), 0.0
    a = _attn_forward(h, blk, cfg, positions)
    if cfg.family == "hybrid":
        a = _mix(a, ssd_forward(h, blk["ssm"], cfg.ssm), blk, cfg)
    x = x + a
    h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    y, aux = _ffn_forward(h2, blk, cfg)
    return x + y, aux


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            ctx=None, remat: bool = False):
    """Full-sequence forward.  batch["tokens"]: (B, S) integer token ids
    ((B, S, nq) for audio) on the parameters' device.  Returns ``(logits
    (B, S, padded_vocab) (audio: (B, S, nq, padded_vocab)), aux)``; ``aux``
    is the layers' summed MoE balance loss (a tensor), 0.0 for families
    without experts.  ``remat`` only matters for a backward pass, which
    is not ported."""
    require_ported(cfg)
    if ctx is not None:
        raise NotImplementedError(
            f"a forward on a device mesh is not ported yet ({MESH_ITEM})")
    if remat:
        raise NotImplementedError(
            f"remat=True is a training option and training is not ported "
            f"yet ({ROADMAP_ITEM}c); pass remat=False")
    x = _embed(params, cfg, batch["tokens"].long())
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = 0.0
    for i in range(cfg.n_layers):
        x, a = _block_forward(x, layer(params["blocks"], i), cfg, positions)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


# --------------------------------------------------------------- decode
def kv_cache_len(cfg: ArchConfig, context_len: int) -> int:
    if cfg.swa_window:
        return min(context_len, cfg.swa_window)
    return context_len


def decode_state_layout(cfg: ArchConfig, batch: int, context_len: int,
                        dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """``(shape, dtype)`` of each tensor of the decode state, nested as the
    state is: ring-buffer caches ``k``, ``v`` ``(n_layers, batch, Sc, KV,
    hd)`` where the model attends (int8, with float16 ``k_scale``,
    ``v_scale`` ``(n_layers, batch, Sc, KV)``, one a slot and KV head,
    under ``kv_dtype="int8"``), and SSM states ``ssm`` (``h`` float32
    whatever ``dtype``) where it has an SSM."""
    require_ported(cfg)
    nl = cfg.n_layers
    out: Dict[str, Any] = {}
    if cfg.n_heads:
        shape = (nl, batch, kv_cache_len(cfg, context_len), cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        quant = cfg.kv_dtype == "int8"
        out["k"] = out["v"] = (shape, torch.int8 if quant else dtype)
        if quant:
            out["k_scale"] = out["v_scale"] = (shape[:-1], torch.float16)
    if cfg.family in ("ssm", "hybrid"):
        shapes = ssm_state_shapes(batch, cfg.d_model, cfg.ssm, (nl,))
        out["ssm"] = {"h": (shapes["h"], torch.float32),
                      "conv_buf": (shapes["conv_buf"], dtype)}
    return out


def init_decode_state(params, cfg: ArchConfig, batch: int, context_len: int,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Decode state on the parameters' device: the step counter ``cur``
    (a Python int) and the zeroed tensors of
    :func:`decode_state_layout`."""
    dev = params["embed"].device

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.zeros(v[0], dtype=v[1], device=dev)
                for k, v in tree.items()}

    return {"cur": 0, **zeros(decode_state_layout(cfg, batch, context_len,
                                                  dtype))}


def _quantize_kv(t):
    """t: (B, KV, hd) float32 -> (int8 values, float16 scales (B, KV));
    the quotient uses the float32 scale, before its float16 cast."""
    scale = torch.clamp(t.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _attn_decode(x, blk, cfg: ArchConfig, k_cache, v_cache, cur: int,
                 k_scale=None, v_scale=None):
    """x: (B, D).  Writes this token's K/V (quantized, with their scales,
    when ``k_scale`` is given) at slot ``cur % Sc`` of the layer's caches,
    in place, and attends over the valid slots."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    Sc = k_cache.shape[1]
    q = (x @ blk["wq"]).reshape(B, cfg.n_heads, hd)
    k = (x @ blk["wk"]).reshape(B, cfg.n_kv_heads, hd)
    v = (x @ blk["wv"]).reshape(B, cfg.n_kv_heads, hd)
    pos = torch.full((B, 1), cur, device=x.device)
    q = L.apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = L.apply_rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    slot = cur % Sc
    n_valid = min(cur + 1, Sc)
    if k_scale is not None:
        k_cache[:, slot], k_scale[:, slot] = _quantize_kv(k.float())
        v_cache[:, slot], v_scale[:, slot] = _quantize_kv(v.float())
        o, _, _ = flash_decode_int8(q, k_cache, v_cache, k_scale, v_scale,
                                    n_valid)
    else:
        k_cache[:, slot] = k
        v_cache[:, slot] = v
        o, _, _ = flash_decode(q, k_cache, v_cache, n_valid)
    return o.to(x.dtype).reshape(B, cfg.n_heads * hd) @ blk["wo"]


def _ssm_decode(h, blk, cfg: ArchConfig, ssm_state, i: int):
    """The SSM's one-token step on h (B, D), writing layer ``i``'s new
    state into the stacked ``ssm_state`` in place."""
    y, new = ssd_decode_step(h, layer(ssm_state, i), blk["ssm"], cfg.ssm)
    for name, t in new.items():
        ssm_state[name][i].copy_(t)
    return y


def decode_step(params, cfg: ArchConfig, state: Dict[str, Any],
                tokens: torch.Tensor, ctx=None):
    """One decode step.  tokens: (B,) integer token ids ((B, nq) for
    audio) on the parameters' device.  Returns ``(logits (B, padded_vocab)
    (audio: (B, nq, padded_vocab)), new_state)``; the new state shares the
    caches and SSM states of ``state``, which this step updated in
    place."""
    require_ported(cfg)
    if ctx is not None:
        raise NotImplementedError(
            f"decode on a device mesh (distributed/decode.py) is not ported "
            f"yet ({MESH_ITEM})")
    tokens = tokens.long()
    x = _embed(params, cfg, tokens[:, None] if tokens.dim() == 1
               else tokens[:, None, :])[:, 0]
    cur = int(state["cur"])
    scales = ((state["k_scale"], state["v_scale"]) if "k_scale" in state
              else (None, None))
    for i in range(cfg.n_layers):
        blk = layer(params["blocks"], i)
        hn = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + _ssm_decode(hn, blk, cfg, state["ssm"], i)
            continue
        a = _attn_decode(hn, blk, cfg, state["k"][i], state["v"][i], cur,
                         *(s[i] if s is not None else None for s in scales))
        if cfg.family == "hybrid":
            a = _mix(a, _ssm_decode(hn, blk, cfg, state["ssm"], i), blk, cfg)
        x = x + a
        h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        y, _ = _ffn_forward(h2[:, None], blk, cfg)
        x = x + y[:, 0]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x[:, None])[:, 0], dict(state, cur=cur + 1)
