"""Decoder models: parameters, the full-sequence forward (prefill and
training), the ring-buffer decode state and one-token decode, in PyTorch,
for the dense, moe, ssm, hybrid, vlm and audio families.

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
``(B, S, nq, V)`` logits.  VLM models (``cross_attn_every``) keep the
reference's super-block layout: the self blocks stacked ``(n_cross,
cross_attn_every, ...)`` and ``params["cross"]`` (``wq wk wv wo ln
gate``) stacked ``(n_cross, ...)``, one gated cross-attention layer after
each group of self layers, over ``batch["frontend"]`` ``(B, T, D)``;
their decode state carries the frontend's keys and values ``cross_k`` /
``cross_v`` ``(n_cross, B, T, KV, hd)``.

Where JAX scans over the stacked layers, this module loops in Python, and
where JAX returns new caches and states, :func:`decode_step` writes this
token's K/V (and scales) and each layer's new SSM state into the state in
place (no copy of a cache).  Attention goes through the hand-written
kernels: prefill through
:func:`repro_torch.kernels.flash_attention.flash_attention` (once per
attention layer, cross layers included; with gradients through its
autograd form, its ``FlashAttention``), decode through
:func:`repro_torch.kernels.flash_decode.flash_decode` (the vlm's cross
layers too, over all ``T`` frontend keys), or
:func:`~repro_torch.kernels.flash_decode.flash_decode_int8` over int8
caches.  ``forward(remat=True)`` checkpoints each block (and each vlm
super-block) with ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` does; ``remat_policy="dots"`` keeps the outputs of the
matrix products (``aten.mm``), as ``dots_with_no_batch_dims_saveable``
does.

On a device mesh (a :class:`MeshCtx`), :func:`decode_step` and
:func:`forward` run the dense and moe families, each rank on its own
blocks (the layouts of :mod:`repro_torch.distributed.sharding`) over
``torch.distributed``, doing by hand what the reference's partitioner
does from its specs: the embedding cut over the vocab (a local lookup,
then ``psum``), the SwiGLU column- then row-parallel (then ``psum``), the
MoE layer's ``moe_ffn_sharded``, the LM head cut over the vocab, norms
replicated, batch rows over the dp axes.  Decode attends
sequence-sharded through the kernel
(:func:`repro_torch.distributed.decode.decode_attn_sharded`) when the
model axis has more than one rank, and gathers its logits over the
vocab.  The mesh forward (prefill and training) attends head-parallel:
the ``wq`` / ``wk`` / ``wv`` column blocks give each rank ``H / n_tp``
query heads over ``KV / n_tp`` KV heads, which it runs through the
kernel, then the ``wo`` row block and a ``psum``; where the model axis
cuts inside a head (``KV % n_tp != 0``) it gathers q / k / v over the
model axis and attends over every head.  Its parameters may be stored
under any spec (``MeshCtx.specs``: the train rules, or fully sharded);
each is gathered, differentiably, to its compute spec
(``MeshCtx.cspecs``) just before its layer uses it, inside the layer's
remat.  Its logits stay cut over the vocab (this rank's block under
``P(dp, None, tp)``); the collectives carry gradients
(:mod:`repro_torch.distributed.collectives`).  The other families on a
mesh raise ``NotImplementedError`` (``MESH_ITEM``); so does the vlm
family with ``kv_dtype="int8"`` (the reference's vlm decode loop passes
no scales).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_int8
from repro_torch.models import layers as L
from repro_torch.models.moe import (init_moe_params, moe_ffn_local,
                                    moe_ffn_sharded, moe_param_shapes)
from repro_torch.models.ssm import (init_ssm_params, ssd_decode_step,
                                    ssd_forward, ssm_param_shapes,
                                    ssm_state_shapes)
from repro_torch.torch_device import resolve

ROADMAP_ITEM = "ROADMAP Queue A item 14"
MESH_ITEM = "ROADMAP Queue A item 14d iii-b"
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
MESH_FAMILIES = ("dense", "moe")


@dataclass(frozen=True)
class MeshCtx:
    """Distribution context of a step on a device mesh (None: one
    device): the ``DeviceMesh``, its dp axes and tp axis; for the mesh
    forward, the specs the parameters are stored under and their compute
    specs (None: stored in the compute layout)."""
    mesh: Any
    dp_axes: Tuple[str, ...]
    tp_axis: str
    # long-context decode with a tiny batch: the batch replicated over dp,
    # only the KV sequence axis cut over tp
    batch_replicated: bool = False
    # decode-time MoE layout: expert weights resident (tp x dp), tokens
    # gathered (repro_torch.models.moe.moe_ffn_sharded)
    resident_experts: bool = False
    specs: Any = None
    cspecs: Any = None


def require_mesh_ported(cfg: ArchConfig) -> None:
    """Refuse the families that do not run on a mesh yet."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a device mesh (decode, "
            f"forward, training) is not ported yet ({MESH_ITEM}); the dense "
            "and moe families run on a mesh")


def require_ported(cfg: ArchConfig) -> None:
    """Refuse what the port does not run."""
    if cfg.cross_attn_every and cfg.kv_dtype == "int8":
        raise NotImplementedError(
            f"{cfg.name}: kv_dtype='int8' with cross-attention layers: the "
            f"reference's vlm decode loop passes no scales ({ROADMAP_ITEM})")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({ROADMAP_ITEM})")
    if cfg.kv_dtype not in ("model", "int8"):
        raise NotImplementedError(
            f"{cfg.name}: kv_dtype={cfg.kv_dtype!r} is not ported "
            f"({ROADMAP_ITEM})")


def n_cross(cfg: ArchConfig) -> int:
    """Cross-attention layers (super-blocks) of a vlm config, else 0."""
    return cfg.n_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0


def layer_lead(cfg: ArchConfig) -> tuple:
    """The leading axes of the stacked self blocks: ``(n_layers,)``, or
    ``(n_cross, cross_attn_every)`` super-blocks for a vlm config."""
    if cfg.cross_attn_every:
        return (n_cross(cfg), cfg.cross_attn_every)
    return (cfg.n_layers,)


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the layout of :func:`init_params`."""
    require_ported(cfg)
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    lead = layer_lead(cfg)
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
    blocks: Dict[str, Any] = {"ln1": lead + (d,)}
    if cfg.family == "ssm":
        blocks["ssm"] = ssm_param_shapes(d, cfg.ssm, lead)
    else:
        blocks.update({"ln2": lead + (d,), "wq": lead + (d, qd),
                       "wk": lead + (d, kvd), "wv": lead + (d, kvd),
                       "wo": lead + (qd, d)})
        if cfg.family == "hybrid":
            blocks["ssm"] = ssm_param_shapes(d, cfg.ssm, lead)
            blocks["norm_attn"] = lead + (d,)
            blocks["norm_ssm"] = lead + (d,)
        if cfg.moe is not None:
            blocks["moe"] = moe_param_shapes(d, cfg.moe, lead)
        elif f:
            blocks.update({"w_gate": lead + (d, f), "w_up": lead + (d, f),
                           "w_down": lead + (f, d)})
    shapes["blocks"] = blocks
    if cfg.cross_attn_every:
        nc = n_cross(cfg)
        shapes["cross"] = {"wq": (nc, d, qd), "wk": (nc, d, kvd),
                           "wv": (nc, d, kvd), "wo": (nc, qd, d),
                           "ln": (nc, d), "gate": (nc, 1)}
    return shapes


# ----------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0, *, torch_device="cuda",
                dtype: torch.dtype = torch.float32,
                place=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's scales (normal draws times
    ``d_in ** -0.5``, embeddings times 0.02, norms at one, the SSM's
    constants, the vlm's cross-attention gates at zero), drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``torch_device``.  The
    draws are not JAX's: to run JAX's weights, convert them with
    :func:`repro_torch.convert.params_from_jax`.

    ``place(path, tensor)``, when given, takes each parameter as soon as
    it is drawn (``path`` as ``.blocks.wq``) and returns what the tree
    keeps: on a mesh, this rank's block of it
    (:func:`repro_torch.distributed.step.init_local_params`), so that at
    most one full parameter exists at a time.  The draws are the same
    with or without it."""
    dev = resolve(torch_device)
    keep = place or (lambda _, t: t)
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, lead = cfg.d_model, cfg.d_ff, layer_lead(cfg)
    qd = cfg.n_heads * cfg.resolved_head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(std).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params: Dict[str, Any] = {"embed": keep(".embed",
                                            normal(shapes["embed"], 0.02))}
    if "lm_head" in shapes:
        params["lm_head"] = keep(".lm_head",
                                 normal(shapes["lm_head"], d ** -0.5))
    params["final_norm"] = keep(".final_norm", ones(shapes["final_norm"]))
    std = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
           "w_gate": d ** -0.5, "w_up": d ** -0.5}
    if qd:
        std["wo"] = qd ** -0.5
    if f:
        std["w_down"] = f ** -0.5
    blocks = {}
    for k, shape in shapes["blocks"].items():
        if k == "ssm":
            ssm = init_ssm_params(d, cfg.ssm, normal, device=dev, dtype=dtype,
                                  lead=lead)
            blocks[k] = {n: keep(f".blocks.ssm.{n}", t)
                         for n, t in ssm.items()}
        elif k == "moe":
            blocks[k] = init_moe_params(
                d, cfg.moe, normal, lead=lead,
                place=lambda n, t: keep(f".blocks.moe.{n}", t))
        elif k in std:
            blocks[k] = keep(f".blocks.{k}", normal(shape, std[k]))
        else:                                  # ln1, ln2, norm_attn, norm_ssm
            blocks[k] = keep(f".blocks.{k}", ones(shape))
    params["blocks"] = blocks
    if "cross" in shapes:                      # gated cross-attn (llama3.2)
        cs = shapes["cross"]
        params["cross"] = {k: keep(f".cross.{k}", normal(cs[k], std[k]))
                           for k in ("wq", "wk", "wv", "wo")}
        params["cross"]["ln"] = keep(".cross.ln", ones(cs["ln"]))
        params["cross"]["gate"] = keep(".cross.gate", torch.zeros(
            cs["gate"], device=dev, dtype=dtype))
    return params


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or state tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def self_block(params, cfg: ArchConfig, i: int):
    """The parameters of self layer ``i`` (of ``n_layers``) in either
    layout (for a vlm, slot ``i % cross_attn_every`` of super-block ``i //
    cross_attn_every``)."""
    if cfg.cross_attn_every:
        g, j = divmod(i, cfg.cross_attn_every)
        return layer(layer(params["blocks"], g), j)
    return layer(params["blocks"], i)


# -------------------------------------------------------------- forward
def _embed(params, cfg: ArchConfig, tokens, ctx: Optional[MeshCtx] = None):
    """Token embeddings.  On a mesh whose embedding is cut over the vocab,
    each rank looks up the ids in its rows (zeros elsewhere) and the model
    axis sums them: one nonzero term, so the sum is exact."""
    if cfg.n_codebooks:
        return L.embed_codebooks(params["embed"], tokens)
    table = params["embed"]
    if ctx is None or table.shape[0] == cfg.padded_vocab:
        return L.embed_tokens(table, tokens)
    from repro_torch.distributed import collectives as col
    v_loc = table.shape[0]
    local = tokens - col.axis_index(ctx.mesh, ctx.tp_axis) * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = L.embed_tokens(table, torch.clamp(local, 0, v_loc - 1))
    return col.reduce_from(torch.where(inside[..., None], rows, 0.0),
                           ctx.mesh, ctx.tp_axis)


def _unembed(params, cfg: ArchConfig, x, ctx: Optional[MeshCtx] = None,
             gather: bool = True):
    """Logits.  On a mesh whose head is cut over the vocab, each rank's
    columns, gathered along the vocab (this rank's columns alone when
    not ``gather``)."""
    if cfg.n_codebooks:
        return torch.einsum("bsd,qdv->bsqv", x, params["lm_head"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if ctx is None or head.shape[-1] == cfg.padded_vocab:
        return x @ head
    from repro_torch.distributed import collectives as col
    logits = col.copy_to(x, ctx.mesh, ctx.tp_axis) @ head
    if not gather:
        return logits
    return col.all_gather(logits, ctx.mesh, ctx.tp_axis, logits.dim() - 1)


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


def cross_kv(frontend, blk, cfg: ArchConfig):
    """k and v (B, T, KV, hd) of one cross-attention layer over the
    frontend embeddings (B, T, D) (no RoPE)."""
    B, hd = frontend.shape[0], cfg.resolved_head_dim
    return ((frontend @ blk["wk"]).reshape(B, -1, cfg.n_kv_heads, hd),
            (frontend @ blk["wv"]).reshape(B, -1, cfg.n_kv_heads, hd))


def cross_inputs(x, frontend, blk, cfg: ArchConfig):
    """q (B, S, H, hd) of the normalised x, and :func:`cross_kv`, of one
    cross-attention layer."""
    B, S, _ = x.shape
    xn = L.rms_norm(x, blk["ln"], cfg.norm_eps)
    q = (xn @ blk["wq"]).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    return (q,) + cross_kv(frontend, blk, cfg)


def _cross_attn_forward(x, blk, cfg: ArchConfig, frontend):
    """x (B, S, D) attends over the frontend embeddings (B, T, D), not
    causally, through its gate: ``x + tanh(gate) * attention``."""
    B, S, _ = x.shape
    q, k, v = cross_inputs(x, frontend, blk, cfg)
    o = L.flash_attention(q, k, v, causal=False)
    o = o.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ blk["wo"]
    return x + torch.tanh(blk["gate"]) * o


def _ffn_forward(x, blk, cfg: ArchConfig, ctx: Optional[MeshCtx] = None,
                 batch_aux: bool = False):
    """The block's FFN on x (B, S, D): the MoE layer, SwiGLU, or nothing.
    Returns (y, aux).  On a mesh: ``moe_ffn_sharded`` (its balance loss
    over the whole batch with ``batch_aux``), or the SwiGLU on this
    rank's hidden columns (``w_gate`` / ``w_up`` column blocks, ``w_down``
    a row block) summed over the model axis."""
    if cfg.moe is not None:
        if ctx is not None:
            return moe_ffn_sharded(x, blk["moe"], cfg.moe, ctx.mesh,
                                   ctx.dp_axes, ctx.tp_axis,
                                   batch_replicated=ctx.batch_replicated,
                                   resident_experts=ctx.resident_experts,
                                   batch_aux=batch_aux)
        B, S, D = x.shape
        y, aux = moe_ffn_local(x.reshape(-1, D), blk["moe"], cfg.moe)
        return y.reshape(B, S, D), aux
    if cfg.d_ff:
        if ctx is None or blk["w_down"].shape[-2] == cfg.d_ff:
            return L.swiglu(x, blk["w_gate"], blk["w_up"], blk["w_down"]), 0.0
        from repro_torch.distributed import collectives as col
        y = L.swiglu(col.copy_to(x, ctx.mesh, ctx.tp_axis), blk["w_gate"],
                     blk["w_up"], blk["w_down"])
        return col.reduce_from(y, ctx.mesh, ctx.tp_axis), 0.0
    return torch.zeros_like(x), 0.0


def _mix(a, s, blk, cfg: ArchConfig):
    """The hybrid family's fusion of its attention and SSM outputs."""
    return 0.5 * (L.rms_norm(a, blk["norm_attn"], cfg.norm_eps)
                  + L.rms_norm(s, blk["norm_ssm"], cfg.norm_eps))


def _attn_mesh(x, blk, cfg: ArchConfig, positions, ctx: MeshCtx):
    """One attention layer of the mesh forward on this rank's blocks (see
    the module's docstring): replicated weights attend as on one device;
    column blocks that hold whole KV heads attend head-parallel; column
    blocks cut inside a head gather q / k / v over the model axis."""
    from repro_torch.distributed import collectives as col

    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mesh, tp = ctx.mesh, ctx.tp_axis
    cols = blk["wq"].shape[-1]
    if cols == H * hd:
        return _attn_forward(x, blk, cfg, positions)
    n_tp = col.axis_size(mesh, tp)
    if n_tp * cols != H * hd:
        raise ValueError(f"{cfg.name}: wq column block {cols} is not 1/{n_tp} "
                         f"of {H * hd}")
    xt = col.copy_to(x, mesh, tp)
    if KV % n_tp == 0:                          # whole heads: head-parallel
        q = (xt @ blk["wq"]).reshape(B, S, H // n_tp, hd)
        k = (xt @ blk["wk"]).reshape(B, S, KV // n_tp, hd)
        v = (xt @ blk["wv"]).reshape(B, S, KV // n_tp, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = L.flash_attention(q, k, v, causal=True, window=cfg.swa_window)
        o = o.reshape(B, S, cols)
    else:                                       # the cut falls in a head
        parts = [blk["wq"].shape[-1], blk["wk"].shape[-1],
                 blk["wv"].shape[-1]]
        mine = torch.cat([xt @ blk["wq"], xt @ blk["wk"], xt @ blk["wv"]],
                         dim=-1)
        full = col.gather(mine.reshape(B, S, 1, sum(parts)), mesh, tp, 2)
        q, k, v = (t.reshape(B, S, -1) for t in
                   torch.split(full, parts, dim=3))
        q = L.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
        k = L.apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
        o = L.flash_attention(q, k, v.reshape(B, S, KV, hd), causal=True,
                              window=cfg.swa_window)
        tpi = col.axis_index(mesh, tp)
        o = o.reshape(B, S, H * hd)[..., tpi * cols:(tpi + 1) * cols]
    return col.reduce_from(o @ blk["wo"], mesh, tp)


def _block_forward(x, blk, cfg: ArchConfig, positions,
                   ctx: Optional[MeshCtx] = None):
    """One decoder block (attention / SSM / both, then the FFN).  Returns
    (x, aux).  With a ``MeshCtx`` (dense and moe families): this rank's
    blocks, gathered to their compute specs first."""
    if ctx is not None:
        blk = _compute_layout(blk, ctx, "blocks")
    h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        return x + ssd_forward(h, blk["ssm"], cfg.ssm), 0.0
    if ctx is not None:
        a = _attn_mesh(h, blk, cfg, positions, ctx)
    else:
        a = _attn_forward(h, blk, cfg, positions)
    if cfg.family == "hybrid":
        a = _mix(a, ssd_forward(h, blk["ssm"], cfg.ssm), blk, cfg)
    x = x + a
    h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    y, aux = _ffn_forward(h2, blk, cfg, ctx, batch_aux=True)
    return x + y, aux


def _layer_spec(spec):
    """A stacked leaf's spec without its layer axis, which the mesh
    forward takes uncut."""
    from repro_torch.distributed.sharding import P
    if len(spec) and spec[0] is not None:
        raise ValueError(f"a spec that cuts the layer axis ({spec}) is not "
                         "supported by the mesh forward")
    return P(*tuple(spec)[1:])


def _compute_layout(tree, ctx: MeshCtx, key: Optional[str] = None):
    """``tree`` (a layer's blocks when ``key`` is ``"blocks"``, else the
    parameters' top-level leaf ``key``) gathered from ``ctx.specs`` to
    ``ctx.cspecs``; as it is when the context holds no specs."""
    if ctx.specs is None:
        return tree
    from repro_torch.distributed.sharding import regather

    if key != "blocks":
        return regather(tree, ctx.specs[key], ctx.cspecs[key], ctx.mesh)

    def walk(t, s, c):
        return {k: walk(v, s[k], c[k]) if isinstance(v, dict) else
                regather(v, _layer_spec(s[k]), _layer_spec(c[k]), ctx.mesh)
                for k, v in t.items()}

    return walk(tree, ctx.specs["blocks"], ctx.cspecs["blocks"])


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of matrix products without batch dimensions (``x
    @ W``) and recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable`` (batched products, ``bmm``, are
    recomputed)."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: bool, remat_policy: Optional[str]):
    """``fn`` checkpointed (recomputed in the backward pass) when
    ``remat`` and autograd records, else ``fn`` itself."""
    if remat_policy not in (None, "dots"):
        raise ValueError(f"remat_policy={remat_policy!r}: the reference "
                         "knows None and 'dots'")
    if not remat:
        return fn
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            ctx=None, remat: bool = False, unroll: bool = False,
            remat_policy: Optional[str] = None):
    """Full-sequence forward.  batch["tokens"]: (B, S) integer token ids
    ((B, S, nq) for audio) on the parameters' device; a vlm batch also
    carries ``batch["frontend"]`` (B, T, D).  Returns ``(logits (B, S,
    padded_vocab) (audio: (B, S, nq, padded_vocab)), aux)``; ``aux`` is
    the layers' summed MoE balance loss (a tensor), 0.0 for families
    without experts.  ``remat`` checkpoints each block (and each vlm
    super-block) for the backward pass; ``unroll`` (the reference's
    Python loop in place of ``lax.scan``) changes nothing here, where the
    layers are a Python loop.

    With a :class:`MeshCtx` (dense and moe families) every argument and
    result is this rank's block: the batch its dp rows, the parameters
    stored under ``ctx.specs`` (gathered to ``ctx.cspecs`` layer by
    layer), the logits ``(B_loc, S, V_loc)`` its block under ``P(dp,
    None, tp)``; ``aux`` is the balance loss of the whole batch (every
    rank holds it)."""
    require_ported(cfg)
    if ctx is not None:
        require_mesh_ported(cfg)
        if not isinstance(ctx, MeshCtx):
            raise TypeError(f"ctx must be a MeshCtx (a mesh's distribution "
                            f"context), got a {type(ctx).__name__}")
        return _forward_mesh(params, cfg, batch, ctx, remat, remat_policy)
    x = _embed(params, cfg, batch["tokens"].long())
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = _remat(lambda x, blk: _block_forward(x, blk, cfg, positions),
                  remat, remat_policy)
    aux = 0.0
    if cfg.cross_attn_every:
        frontend = torch.as_tensor(batch["frontend"], device=x.device)

        def super_block(x, g):
            a = 0.0
            for i in range(g * cfg.cross_attn_every,
                           (g + 1) * cfg.cross_attn_every):
                x, ai = body(x, self_block(params, cfg, i))
                a = a + ai
            x = _cross_attn_forward(x, layer(params["cross"], g), cfg,
                                    frontend)
            return x, a

        super_block = _remat(super_block, remat, remat_policy)
        for g in range(n_cross(cfg)):
            x, a = super_block(x, g)
            aux = aux + a
    else:
        for i in range(cfg.n_layers):
            x, a = body(x, layer(params["blocks"], i))
            aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


def _forward_mesh(params, cfg: ArchConfig, batch, ctx: MeshCtx, remat: bool,
                  remat_policy: Optional[str]):
    """:func:`forward` on a mesh (dense and moe families)."""
    top = {k: _compute_layout(params[k], ctx, k)
           for k in ("embed", "lm_head", "final_norm") if k in params}
    x = _embed(top, cfg, batch["tokens"].long(), ctx)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    body = _remat(lambda x, blk: _block_forward(x, blk, cfg, positions, ctx),
                  remat, remat_policy)
    aux = 0.0
    for i in range(cfg.n_layers):
        x, a = body(x, layer(params["blocks"], i))
        aux = aux + a
    x = L.rms_norm(x, top["final_norm"], cfg.norm_eps)
    return _unembed(top, cfg, x, ctx, gather=False), aux


# --------------------------------------------------------------- decode
def kv_cache_len(cfg: ArchConfig, context_len: int) -> int:
    if cfg.swa_window:
        return min(context_len, cfg.swa_window)
    return context_len


def decode_state_layout(cfg: ArchConfig, batch: int, context_len: int,
                        dtype: torch.dtype = torch.float32,
                        frontend_tokens: int = 0) -> Dict[str, Any]:
    """``(shape, dtype)`` of each tensor of the decode state, nested as the
    state is: ring-buffer caches ``k``, ``v`` ``(n_layers, batch, Sc, KV,
    hd)`` where the model attends (int8, with float16 ``k_scale``,
    ``v_scale`` ``(n_layers, batch, Sc, KV)``, one a slot and KV head,
    under ``kv_dtype="int8"``), SSM states ``ssm`` (``h`` float32
    whatever ``dtype``) where it has an SSM, and for a vlm given
    ``frontend_tokens`` T the frontend's keys and values ``cross_k``,
    ``cross_v`` ``(n_cross, batch, T, KV, hd)``."""
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
    if cfg.cross_attn_every and frontend_tokens:
        out["cross_k"] = out["cross_v"] = (
            (n_cross(cfg), batch, frontend_tokens, cfg.n_kv_heads,
             cfg.resolved_head_dim), dtype)
    return out


def init_decode_state(params, cfg: ArchConfig, batch: int, context_len: int,
                      dtype: torch.dtype = torch.float32,
                      frontend=None) -> Dict[str, Any]:
    """Decode state on the parameters' device: the step counter ``cur``
    (a Python int), the zeroed tensors of :func:`decode_state_layout`
    and, for a vlm given ``frontend`` (B, T, D), each cross layer's
    ``frontend @ wk`` / ``frontend @ wv`` as ``cross_k`` / ``cross_v``."""
    dev = params["embed"].device

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.zeros(v[0], dtype=v[1], device=dev)
                for k, v in tree.items()}

    state = {"cur": 0, **zeros(decode_state_layout(cfg, batch, context_len,
                                                   dtype))}
    if cfg.cross_attn_every and frontend is not None:
        frontend = torch.as_tensor(frontend, device=dev)
        kv = [cross_kv(frontend, layer(params["cross"], g), cfg)
              for g in range(n_cross(cfg))]
        state["cross_k"] = torch.stack([k for k, _ in kv])
        state["cross_v"] = torch.stack([v for _, v in kv])
    return state


def _quantize_kv(t):
    """t: (B, KV, hd) float32 -> (int8 values, float16 scales (B, KV));
    the quotient uses the float32 scale, before its float16 cast."""
    scale = torch.clamp(t.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _attn_decode(x, blk, cfg: ArchConfig, k_cache, v_cache, cur: int,
                 k_scale=None, v_scale=None, ctx: Optional[MeshCtx] = None):
    """x: (B, D).  Writes this token's K/V (quantized, with their scales,
    when ``k_scale`` is given) at slot ``cur % Sc`` of the layer's caches,
    in place, and attends over the valid slots.  With a ``MeshCtx`` whose
    model axis has more than one rank, the sequence-sharded path
    (:func:`repro_torch.distributed.decode.decode_attn_sharded`)."""
    if ctx is not None:
        from repro_torch.distributed import collectives as col
        if col.axis_size(ctx.mesh, ctx.tp_axis) > 1:
            from repro_torch.distributed.decode import decode_attn_sharded
            return decode_attn_sharded(x, blk, cfg, k_cache, v_cache, cur,
                                       ctx, k_scale=k_scale, v_scale=v_scale)
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


def _cross_decode(x, blk, cfg: ArchConfig, cross_k, cross_v):
    """x (B, D) attends over all T frontend keys of one cross layer (the
    reference's ``decode_attention`` at ``cur_len = T``), through its
    gate."""
    B = x.shape[0]
    q = (L.rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["wq"]) \
        .reshape(B, cfg.n_heads, cfg.resolved_head_dim)
    o, _, _ = flash_decode(q, cross_k, cross_v, cross_k.shape[1])
    return x + torch.tanh(blk["gate"]) * (o.reshape(B, -1) @ blk["wo"])


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
    place.  A vlm's state must come from ``init_decode_state(...,
    frontend=...)``.

    With a :class:`MeshCtx`, every argument and result is this rank's
    block (:func:`repro_torch.distributed.step.plan_shardings` and
    ``serve_param_specs``): tokens and logits the rank's batch rows, the
    logits over the whole vocab; the caches the rank's slot range."""
    require_ported(cfg)
    if ctx is not None:
        require_mesh_ported(cfg)
    every = cfg.cross_attn_every
    if every and "cross_k" not in state:
        raise ValueError(
            f"{cfg.name}: a vlm decode state needs the frontend's keys and "
            "values: build it with init_decode_state(..., frontend=...)")
    tokens = tokens.long()
    x = _embed(params, cfg, tokens[:, None] if tokens.dim() == 1
               else tokens[:, None, :], ctx)[:, 0]
    cur = int(state["cur"])
    scales = ((state["k_scale"], state["v_scale"]) if "k_scale" in state
              else (None, None))
    for i in range(cfg.n_layers):
        blk = self_block(params, cfg, i)
        hn = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + _ssm_decode(hn, blk, cfg, state["ssm"], i)
            continue
        a = _attn_decode(hn, blk, cfg, state["k"][i], state["v"][i], cur,
                         *(s[i] if s is not None else None for s in scales),
                         ctx=ctx)
        if cfg.family == "hybrid":
            a = _mix(a, _ssm_decode(hn, blk, cfg, state["ssm"], i), blk, cfg)
        x = x + a
        h2 = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        y, _ = _ffn_forward(h2[:, None], blk, cfg, ctx)
        x = x + y[:, 0]
        if every and (i + 1) % every == 0:
            g = i // every
            x = _cross_decode(x, layer(params["cross"], g), cfg,
                              state["cross_k"][g], state["cross_v"][g])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (_unembed(params, cfg, x[:, None], ctx)[:, 0],
            dict(state, cur=cur + 1))
