"""Dense decoder: parameters, the full-sequence forward (prefill), the
ring-buffer decode state and one-token decode, in PyTorch.

The layout is the JAX package's: layer parameters are stacked along a
leading ``n_layers`` axis in a plain dict (``params["blocks"]["wq"]`` is
``(n_layers, d, H * hd)``), weights are applied as ``x @ W`` with ``W``
``(d_in, d_out)``, and the decode state holds ring-buffer KV caches
``(n_layers, B, Sc, KV, hd)`` of ``Sc = min(context, window)`` slots.
Where JAX scans over the stacked layers, this module loops in Python, and
where JAX returns new caches, :func:`decode_step` writes this token's K/V
into the state's caches in place (one slot per layer, no copy).
Attention goes through the hand-written kernels: prefill through
:func:`repro_torch.kernels.flash_attention.flash_attention` (once per
layer), decode through :func:`repro_torch.kernels.flash_decode.flash_decode`.

This slice runs the dense family with a model-dtype KV cache on one
device, for inference.  Other families (moe, ssm, hybrid, vlm, audio),
``kv_dtype="int8"``, cross-attention layers, a device mesh and
``remat=True`` (a training option) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import layers as L
from repro_torch.torch_device import resolve

ROADMAP_ITEM = "ROADMAP Queue A item 14"
BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
              "w_down")


def require_ported(cfg: ArchConfig) -> None:
    """Refuse what this slice of the port does not run."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"runs the dense family; {ROADMAP_ITEM})")
    if cfg.kv_dtype != "model":
        raise NotImplementedError(
            f"{cfg.name}: kv_dtype={cfg.kv_dtype!r} is not ported yet "
            f"({ROADMAP_ITEM})")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers are not ported yet "
            f"({ROADMAP_ITEM})")


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the layout of :func:`init_params`."""
    require_ported(cfg)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd = cfg.n_heads * cfg.resolved_head_dim
    kvd = cfg.n_kv_heads * cfg.resolved_head_dim
    shapes: Dict[str, Any] = {"embed": (cfg.padded_vocab, d)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.padded_vocab)
    shapes["final_norm"] = (d,)
    shapes["blocks"] = {
        "ln1": (nl, d), "ln2": (nl, d),
        "wq": (nl, d, qd), "wk": (nl, d, kvd), "wv": (nl, d, kvd),
        "wo": (nl, qd, d),
        "w_gate": (nl, d, f), "w_up": (nl, d, f), "w_down": (nl, f, d),
    }
    return shapes


# ----------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0, *, torch_device="cuda",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's scales (normal draws times
    ``d_in ** -0.5``, embeddings times 0.02, norms at one), drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``torch_device``.  The draws
    are not JAX's: to run JAX's weights, convert them with
    :func:`repro_torch.convert.params_from_jax`."""
    dev = resolve(torch_device)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    qd = cfg.n_heads * cfg.resolved_head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(std).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params: Dict[str, Any] = {"embed": normal(shapes["embed"], 0.02)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(shapes["lm_head"], d ** -0.5)
    params["final_norm"] = ones(shapes["final_norm"])
    b = shapes["blocks"]
    std = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
           "wo": qd ** -0.5, "w_gate": d ** -0.5, "w_up": d ** -0.5,
           "w_down": f ** -0.5}
    params["blocks"] = {k: ones(b[k]) if k in ("ln1", "ln2")
                        else normal(b[k], std[k]) for k in BLOCK_KEYS}
    return params


# -------------------------------------------------------------- forward
def _embed(params, cfg: ArchConfig, tokens):
    return L.embed_tokens(params["embed"], tokens)


def _unembed(params, cfg: ArchConfig, x):
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
    """The dense family's SwiGLU FFN.  Returns (y, aux)."""
    return L.swiglu(x, blk["w_gate"], blk["w_up"], blk["w_down"]), 0.0


def _block_forward(x, blk, cfg: ArchConfig, positions):
    """One decoder block (self-attention + FFN).  Returns (x, aux)."""
    h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    x = x + _attn_forward(h, blk, cfg, positions)
    h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    y, aux = _ffn_forward(h2, blk, cfg)
    return x + y, aux


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            ctx=None, remat: bool = False):
    """Full-sequence forward.  batch["tokens"]: (B, S) integer token ids on
    the parameters' device.  Returns ``(logits (B, S, padded_vocab),
    aux)``; ``aux`` (the MoE balance loss) is 0.0 for the dense family.
    ``remat`` only matters for a backward pass, which is not ported."""
    require_ported(cfg)
    if ctx is not None:
        raise NotImplementedError(
            f"a forward on a device mesh is not ported yet ({ROADMAP_ITEM})")
    if remat:
        raise NotImplementedError(
            f"remat=True is a training option and training is not ported "
            f"yet ({ROADMAP_ITEM}); pass remat=False")
    x = _embed(params, cfg, batch["tokens"].long())
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    blocks = params["blocks"]
    aux = 0.0
    for i in range(cfg.n_layers):
        x, a = _block_forward(x, {k: blocks[k][i] for k in BLOCK_KEYS}, cfg,
                              positions)
        aux += a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


# --------------------------------------------------------------- decode
def kv_cache_len(cfg: ArchConfig, context_len: int) -> int:
    if cfg.swa_window:
        return min(context_len, cfg.swa_window)
    return context_len


def init_decode_state(params, cfg: ArchConfig, batch: int, context_len: int,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Decode state on the parameters' device: the step counter ``cur``
    (a Python int) and zeroed ring-buffer caches ``k``, ``v`` of shape
    ``(n_layers, batch, Sc, KV, hd)``."""
    require_ported(cfg)
    shape = (cfg.n_layers, batch, kv_cache_len(cfg, context_len),
             cfg.n_kv_heads, cfg.resolved_head_dim)
    dev = params["embed"].device
    return {"cur": 0,
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attn_decode(x, blk, cfg: ArchConfig, k_cache, v_cache, cur: int):
    """x: (B, D).  Writes this token's K/V at slot ``cur % Sc`` of the
    layer's caches, in place, and attends over the valid slots."""
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
    k_cache[:, slot] = k
    v_cache[:, slot] = v
    o, _, _ = flash_decode(q, k_cache, v_cache, min(cur + 1, Sc))
    return o.to(x.dtype).reshape(B, cfg.n_heads * hd) @ blk["wo"]


def decode_step(params, cfg: ArchConfig, state: Dict[str, Any],
                tokens: torch.Tensor, ctx=None):
    """One decode step.  tokens: (B,) integer token ids on the parameters'
    device.  Returns ``(logits (B, padded_vocab), new_state)``; the new
    state shares the caches of ``state``, which this step updated in
    place."""
    require_ported(cfg)
    if ctx is not None:
        raise NotImplementedError(
            f"decode on a device mesh (distributed/decode.py) is not ported "
            f"yet ({ROADMAP_ITEM})")
    x = _embed(params, cfg, tokens.long())
    cur = int(state["cur"])
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        blk = {k: blocks[k][i] for k in BLOCK_KEYS}
        hn = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        x = x + _attn_decode(hn, blk, cfg, state["k"][i], state["v"][i], cur)
        h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        x = x + L.swiglu(h2, blk["w_gate"], blk["w_up"], blk["w_down"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), dict(state, cur=cur + 1)
