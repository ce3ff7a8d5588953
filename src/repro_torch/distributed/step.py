"""Step functions: the train step (loss, gradients through the
hand-written attention kernels, microbatch accumulation, optional
gradient compression, AdamW), the prefill step and the serve step, for
every family that :mod:`repro_torch.models.transformer` runs on one
device, and for the dense and moe families on a device mesh too (the
other families on a mesh: ROADMAP Queue A item 14d iii-b).

The loss takes the true logit by a gather (the reference's one-hot form,
``logsumexp(logits) - sum(logits * onehot)``, is the same float32 number
without a ``(B, S, V)`` one-hot).  On a mesh it keeps the vocab cut over
the model axis, as the reference does: the log-sum-exp is a ``pmax``
(held constant) plus the ``psum`` of the ranks' exp-sums, the true logit
comes from the rank that owns it (a ``psum``), and the mean over the
global batch sums the dp ranks' parts.

On a mesh each rank holds its blocks: :func:`plan_shardings` gives the
specs of the reference's plan, :meth:`ShardingPlan.local` cuts a full
tree to this rank's blocks (the reference's ``named`` + ``device_put``),
:func:`serve_param_specs` is the parameter layout the serve step takes,
:func:`train_param_specs` the train step's (the reference's train rules,
or fully sharded), :func:`init_local_params` draws either leaf by leaf,
:func:`init_local_opt_state` allocates the rank's moments (ZeRO-1:
``opt_state_specs``) and :func:`init_local_decode_state` its caches.  The
train and prefill steps take the rank's dp rows of the batch
(:func:`local_batch`); the train step leaves each rank exactly its blocks
of the one-device step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (P, MeshAxes, _dim, batch_spec,
                                              compute_specs,
                                              decode_state_specs, dp_reduce,
                                              fsdp_param_specs, local_shape,
                                              mesh_coords, opt_state_specs,
                                              param_specs, shard_leaf,
                                              shard_tree)
from repro_torch.models.moe import expert_specs, moe_mode
from repro_torch.models.transformer import (MeshCtx, decode_step,
                                            decode_state_layout, forward,
                                            init_params, kv_cache_len,
                                            param_shapes,
                                            require_mesh_ported)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compressed_gradients
from repro_torch.torch_device import resolve
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_mesh_ctx(mesh, batch_replicated: bool = False,
                  resident_experts: bool = False, *, cfg=None,
                  specs=None) -> MeshCtx:
    """The distribution context of a step on ``mesh``.  With ``specs``
    (the parameters' storage specs) and ``cfg``, the mesh forward gathers
    each leaf to its compute spec (``compute_specs``)."""
    ax = MeshAxes.for_mesh(mesh)
    cspecs = None
    if specs is not None:
        cspecs = compute_specs(param_shapes(cfg), cfg, mesh, ax)
    return MeshCtx(mesh=mesh, dp_axes=ax.dp, tp_axis=ax.tp,
                   batch_replicated=batch_replicated,
                   resident_experts=resident_experts, specs=specs,
                   cspecs=cspecs)


def _on(batch, dev):
    """The batch's arrays as tensors on ``dev``."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def dp_index(mesh, coords=None) -> tuple:
    """``(index, count)`` of this rank's (or ``coords``') block of batch
    rows: its place along the dp axes, row-major."""
    ax = MeshAxes.for_mesh(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    sizes = dict(zip(ax.dp, (_dim(mesh, a) for a in ax.dp)))
    i, n = 0, 1
    for a in ax.dp:
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


def local_batch(batch, mesh, coords=None):
    """This rank's dp rows of a global batch (arrays or tensors): the
    block that ``batch_spec`` gives it."""
    i, n = dp_index(mesh, coords)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"over {n} dp ranks")
        b = v.shape[0] // n
        out[k] = v[i * b:(i + 1) * b]
    return out


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean negative log-likelihood, in float32.  logits: (..., V);
    targets: (...) integer ids.  The true logit is gathered, not summed
    against a one-hot: the same float32 number without a ``(..., V)``
    one-hot."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - true_logit)


def sharded_nll(logits: torch.Tensor, targets: torch.Tensor, ctx: MeshCtx,
                vocab: int) -> torch.Tensor:
    """Each position's negative log-likelihood (float32) from this rank's
    vocab block ``logits`` (..., V_loc) of a ``vocab``-wide head, the
    same on every rank of the model axis: the log-sum-exp as ``pmax``
    (held constant) plus the log of the ``psum`` of the exp-sums; the
    true logit from the rank whose block holds it, ``psum``-ed."""
    from repro_torch.distributed import collectives as col

    mesh, tp = ctx.mesh, ctx.tp_axis
    logits = logits.float()
    v_loc = logits.shape[-1]
    if v_loc == vocab:
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return lse - true
    m = col.pmax(logits.detach().amax(dim=-1), mesh, tp)
    sums = col.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                           mesh, tp)
    local = targets.long() - col.axis_index(mesh, tp) * v_loc
    inside = (local >= 0) & (local < v_loc)
    picked = torch.gather(logits, -1,
                          torch.clamp(local, 0, v_loc - 1)[..., None])[..., 0]
    true = col.reduce_from(torch.where(inside, picked, 0.0), mesh, tp)
    return m + torch.log(sums) - true


def make_loss_fn(cfg: ArchConfig, ctx=None, remat: bool = True,
                 aux_coef: float = 0.01, unroll: bool = False,
                 remat_policy: Optional[str] = None) -> Callable:
    """``loss_fn(params, batch)``: next-token cross entropy of the forward
    plus ``aux_coef`` times its MoE balance loss.  ``batch`` holds tensors
    on the parameters' device.  With a :class:`MeshCtx` (dense and moe
    families) ``params`` and ``batch`` are this rank's blocks, and the
    loss is the global batch's, the same on every rank: the mean over the
    global batch is this rank's rows' sum over the global count, summed
    over the dp axes (``reduce_from``: each rank differentiates its own
    rows' part)."""
    if ctx is not None:
        require_mesh_ported(cfg)

    def loss_fn(params, batch):
        logits, aux = forward(params, cfg, batch, ctx=ctx, remat=remat,
                              unroll=unroll, remat_policy=remat_policy)
        tokens = batch["tokens"]
        if ctx is None:
            nll = cross_entropy(logits[:, :-1], tokens[:, 1:])
            return nll + aux_coef * aux
        from repro_torch.distributed import collectives as col

        nll = sharded_nll(logits[:, :-1], tokens[:, 1:], ctx,
                          cfg.padded_vocab)
        n_dp = 1
        for a in ctx.dp_axes:
            n_dp *= col.axis_size(ctx.mesh, a)
        loss = nll.sum() / (nll.numel() * n_dp)
        for a in ctx.dp_axes:
            loss = col.reduce_from(loss, ctx.mesh, a)
        return loss + aux_coef * aux

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` with respect to
    every parameter, as ``jax.value_and_grad``: the parameters are taken as
    new leaves that share their storage, so nothing is copied and the
    caller's tensors stay as they were."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        # a parameter the loss does not reach gets zeros, as in JAX
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def _mesh_setup(cfg: ArchConfig, mesh, specs):
    """``(ctx, specs)`` of a mesh step: the train rules' specs when none
    are given."""
    require_mesh_ported(cfg)
    specs = train_param_specs(cfg, mesh) if specs is None else specs
    return make_mesh_ctx(mesh, cfg=cfg, specs=specs), specs


def make_train_step(cfg: ArchConfig, mesh=None, *, lr_fn: Callable,
                    adamw_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True, compress_grads: bool = False,
                    unroll: bool = False, accum_steps: int = 1,
                    remat_policy: Optional[str] = None, specs=None):
    """``train_step(params, opt_state, batch, step[, comp_state]) ->
    (params, opt_state, loss[, comp_state])``.

    ``batch`` (``tokens``, and ``frontend`` for a vlm; arrays or tensors)
    is moved to the parameters' device; the gradients come from
    :func:`make_grad_fn` (``accum_steps`` microbatches).  With
    ``compress_grads`` and a ``comp_state`` the gradients pass through the
    int8 error-feedback transfer function first.  The parameters and the
    optimizer state are updated in place (see
    :func:`repro_torch.optim.adamw.adamw_update`) and returned.

    With a ``DeviceMesh`` (dense and moe families) every argument is this
    rank's block: the parameters under ``specs`` (:func:`train_param_specs`
    when not given), the optimizer state under its ``opt_state_specs``
    (:func:`init_local_opt_state`), the batch the rank's dp rows
    (:func:`local_batch`), ``comp_state`` like the parameters; the loss is
    the global batch's."""
    ctx, ospecs = None, None
    if mesh is not None:
        ctx, specs = _mesh_setup(cfg, mesh, specs)
        ospecs = train_opt_specs(cfg, mesh, specs, adamw_cfg.moment_dtype)
    grad_fn = make_grad_fn(cfg, mesh, remat=remat, unroll=unroll,
                           accum_steps=accum_steps, remat_policy=remat_policy,
                           specs=specs)
    on_mesh = {} if mesh is None else dict(mesh=mesh, specs=specs)

    def train_step(params, opt_state, batch, step, comp_state=None):
        loss, grads = grad_fn(params, _on(batch, params["embed"].device))
        if compress_grads and comp_state is not None:
            grads, comp_state = compressed_gradients(grads, comp_state,
                                                     **on_mesh)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr_fn(step), adamw_cfg, **on_mesh,
            **({} if mesh is None else dict(opt_specs=ospecs)))
        out = (params, opt_state, loss)
        return out + ((comp_state,) if compress_grads else ())

    return train_step


def make_grad_fn(cfg: ArchConfig, mesh=None, *, remat: bool = True,
                 unroll: bool = False, accum_steps: int = 1,
                 remat_policy: Optional[str] = None, specs=None):
    """``grad_fn(params, batch) -> (loss, grads)`` of the train step:
    ``accum_steps > 1`` splits the batch into that many microbatches of
    consecutive rows and averages their losses and gradients (float32
    sums), as the reference's scan over microbatches.  On a mesh (see
    :func:`make_train_step`) the microbatches are the rank's rows', and
    each gradient is summed over the dp axes its leaf is replicated on:
    each rank ends with its blocks of the one-device gradient of the
    global batch's loss.  (The moe balance loss is a function of a
    microbatch's token set: a mesh microbatch holds every dp rank's i-th
    slice, which the one-device microbatch does not.)"""
    ctx = None
    if mesh is not None:
        ctx, specs = _mesh_setup(cfg, mesh, specs)
    loss_fn = make_loss_fn(cfg, ctx, remat=remat, unroll=unroll,
                           remat_policy=remat_policy)

    def local(params, batch):
        if accum_steps <= 1:
            return value_and_grad(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} "
                             "microbatches")
        mb = B // accum_steps
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
        for i in range(accum_steps):
            loss, g = value_and_grad(
                loss_fn, params, {k: v[i * mb:(i + 1) * mb]
                                  for k, v in batch.items()})
            tree_map(lambda a, b: a.add_(b.float()), g_acc, g)
            loss_acc = loss_acc + loss
        inv = 1.0 / accum_steps
        return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)

    if mesh is None:
        return local

    def grad_fn(params, batch):
        loss, grads = local(params, batch)
        return loss, dp_reduce(grads, specs, mesh)

    return grad_fn


def make_prefill_step(cfg: ArchConfig, mesh=None, *, torch_device="cuda",
                      specs=None):
    """Inference prefill: ``prefill_step(params, batch) -> logits`` of the
    full-sequence forward, without gradients (the reference's prefill
    step, which drops the MoE balance loss).  ``batch["tokens"]`` (B, S)
    ((B, S, nq) for audio; a vlm's batch also ``frontend`` (B, T, D)) may
    hold tensors or arrays; they are moved to ``torch_device``, where the
    parameters must lie.  With a ``DeviceMesh`` (dense and moe families)
    the parameters are this rank's blocks under ``specs``
    (:func:`train_param_specs` when not given), the batch its dp rows,
    and the logits its block ``(B_loc, S, V_loc)`` under ``P(dp, None,
    tp)``."""
    dev = resolve(torch_device)
    ctx = None if mesh is None else _mesh_setup(cfg, mesh, specs)[0]

    def prefill_step(params, batch):
        if params["embed"].device.type != dev.type:
            raise ValueError(f"parameters on {params['embed'].device}, but "
                             f"the step runs on {dev}")
        with torch.no_grad():
            logits, _ = forward(params, cfg,
                                _on(batch, params["embed"].device), ctx=ctx)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig, mesh=None, batch_replicated: bool = False,
                    unroll: bool = False, resident_experts: bool = False):
    """One-token decode: ``serve_step(params, state, tokens) -> (logits,
    state)``.  With a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) every
    argument and result is this rank's block: parameters laid out by
    :func:`serve_param_specs`, the state by :func:`init_local_decode_state`
    (or ``plan_shardings(...).local``), tokens and logits the rank's batch
    rows (all of them with ``batch_replicated``), the logits over the
    whole vocab.  ``unroll`` changes nothing here, where the layers are a
    Python loop."""
    ctx = None
    if mesh is not None:
        require_mesh_ported(cfg)
        ctx = make_mesh_ctx(mesh, batch_replicated, resident_experts)

    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens, ctx=ctx)

    return serve_step


# convenience alias, as the reference's launchers name it
make_decode_step = make_serve_step


@dataclass
class ShardingPlan:
    """The specs of a step's arguments on a mesh."""
    params: Any
    opt_state: Any
    batch: Dict[str, P]
    decode_state: Any

    def local(self, mesh, specs, tree, coords=None):
        """``tree``'s leaves cut to the blocks of the rank at ``coords``
        (this rank of the live mesh when not given) under ``specs`` (one
        of this plan's trees): the counterpart of the reference's
        ``named``, whose ``NamedSharding`` a ``device_put`` applies."""
        return shard_tree(tree, specs, mesh, coords)


def plan_shardings(cfg: ArchConfig, mesh, params_shape, opt_shape=None,
                   decode_state_shape=None, kind: str = "train",
                   batch_replicated: bool = False) -> ShardingPlan:
    """The reference's plan: parameter, optimizer-state, batch and
    decode-state specs for trees of tensors or shapes."""
    ax = MeshAxes.for_mesh(mesh)
    pspecs = param_specs(params_shape, cfg, mesh, ax)
    ospecs = (opt_state_specs(opt_shape, pspecs, mesh, ax)
              if opt_shape is not None else None)
    dspecs = (decode_state_specs(decode_state_shape, cfg, mesh, ax,
                                 batch_replicated)
              if decode_state_shape is not None else None)
    return ShardingPlan(params=pspecs, opt_state=ospecs,
                        batch=batch_spec(cfg, ax, kind, batch_replicated),
                        decode_state=dspecs)


def train_param_specs(cfg: ArchConfig, mesh, fsdp: bool = False):
    """The parameter layout the train and prefill steps take on ``mesh``
    by default: the reference's train rules (``param_specs``: MoE experts
    FSDP-cut over the dp axes), or with ``fsdp`` every leaf cut over all
    axes (``fsdp_param_specs``)."""
    require_mesh_ported(cfg)
    ax = MeshAxes.for_mesh(mesh)
    shapes = param_shapes(cfg)
    if fsdp:
        return fsdp_param_specs(shapes, cfg, mesh, ax)
    return param_specs(shapes, cfg, mesh, ax)


def meta_opt_state(cfg: ArchConfig, moment_dtype: str = "f32"):
    """``adamw_init``'s whole state for ``cfg`` with its moments on the
    ``meta`` device (shapes and dtypes, no storage; ``count`` a real 0-d
    tensor): the template of a restore."""
    meta = tree_map(lambda s: torch.empty(s, device="meta"),
                    param_shapes(cfg))
    return adamw_init(meta, moment_dtype)


def train_opt_specs(cfg: ArchConfig, mesh, specs,
                    moment_dtype: str = "f32"):
    """``opt_state_specs`` of the AdamW state for parameters under
    ``specs``: the moments' ZeRO-1 layout."""
    ax = MeshAxes.for_mesh(mesh)
    return opt_state_specs(meta_opt_state(cfg, moment_dtype), specs, mesh,
                           ax)


def init_local_opt_state(cfg: ArchConfig, mesh, specs,
                         moment_dtype: str = "f32", *, torch_device="cuda"):
    """This rank's blocks of ``adamw_init(params, moment_dtype)`` (zeros,
    ``count`` 0) for parameters under ``specs``, the moments laid out by
    :func:`train_opt_specs`."""
    ospecs = train_opt_specs(cfg, mesh, specs, moment_dtype)
    dev = resolve(torch_device)
    state = meta_opt_state(cfg, moment_dtype)
    for k in state:
        if k != "count":
            state[k] = tree_map(
                lambda t, sp: torch.zeros(local_shape(t.shape, sp, mesh),
                                          dtype=t.dtype, device=dev),
                state[k], ospecs[k])
    return state


def serve_param_specs(cfg: ArchConfig, mesh, resident_experts: bool = False,
                      batch_replicated: bool = False):
    """The parameter layout the serve step takes on ``mesh``: the
    reference's decode-kind rules (``param_specs(kind="decode")``), and
    for MoE experts the blocks its ``moe_ffn_sharded`` body takes (its
    ``in_specs``, :func:`repro_torch.models.moe.expert_specs`).  The
    sequence-sharded attention needs ``wq`` / ``wk`` / ``wv`` / ``wo`` cut
    over the model axis when it has more than one rank."""
    require_mesh_ported(cfg)
    ax = MeshAxes.for_mesh(mesh)
    specs = param_specs(param_shapes(cfg), cfg, mesh, ax, kind="decode")
    n_tp = _dim(mesh, ax.tp)
    if n_tp > 1 and any(specs["blocks"][k] == P() for k in
                        ("wq", "wk", "wv", "wo")):
        raise ValueError(f"{cfg.name}: the attention projections do not "
                         f"split over {n_tp} ranks of the model axis")
    if cfg.moe is not None:
        mode = moe_mode(cfg.moe, n_tp, resident_experts)
        lead = (None,) * (len(specs["blocks"]["moe"]["router"]) - 2)
        specs["blocks"]["moe"] = {
            k: P(*lead, *v) for k, v in expert_specs(
                mode, ax.dp, ax.tp, batch_replicated).items()}
    return specs


def init_local_params(cfg: ArchConfig, seed: int, mesh, specs=None, *,
                      torch_device="cuda",
                      dtype: torch.dtype = torch.float32, coords=None):
    """This rank's blocks of ``init_params(cfg, seed)`` under ``specs``
    (:func:`serve_param_specs` when not given): the same draws, each
    parameter cut as soon as it is drawn and its full tensor dropped, so
    at most one full parameter exists at a time."""
    specs = serve_param_specs(cfg, mesh) if specs is None else specs
    coords = mesh_coords(mesh) if coords is None else coords
    flat = dict(_flat_specs(specs))

    def place(path, t):
        return shard_leaf(t, flat[path], mesh, coords).clone(
            memory_format=torch.contiguous_format)

    return init_params(cfg, seed, torch_device=torch_device, dtype=dtype,
                       place=place)


def _flat_specs(specs, path: str = ""):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _flat_specs(v, f"{path}.{k}")
    else:
        yield path, specs


def init_local_decode_state(cfg: ArchConfig, mesh, batch: int,
                            context_len: int,
                            dtype: torch.dtype = torch.float32, *,
                            batch_replicated: bool = False,
                            torch_device="cuda") -> Dict[str, Any]:
    """This rank's blocks of ``init_decode_state`` for a global ``batch``
    (zeros; ``cur`` 0), laid out by ``decode_state_specs``.  The
    sequence-sharded decode needs the ring's ``min(context, window)``
    slots to split over the model axis: a ring that does not is refused,
    as the reference's ``shard_map`` refuses it."""
    require_mesh_ported(cfg)
    ax = MeshAxes.for_mesh(mesh)
    ring, n_tp = kv_cache_len(cfg, context_len), _dim(mesh, ax.tp)
    if ring % n_tp:
        raise ValueError(f"{cfg.name}: a ring of {ring} slots does not split "
                         f"over {n_tp} ranks of the {ax.tp!r} axis")
    layout = decode_state_layout(cfg, batch, context_len, dtype)
    specs = decode_state_specs({k: v[0] for k, v in layout.items()}, cfg,
                               mesh, ax, batch_replicated)
    dev = resolve(torch_device)
    state: Dict[str, Any] = {"cur": 0}
    for k, (shape, dt) in layout.items():
        state[k] = torch.zeros(local_shape(shape, specs[k], mesh), dtype=dt,
                               device=dev)
    return state
