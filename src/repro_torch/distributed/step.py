"""Step functions: the train step (loss, gradients through the
hand-written attention kernels, microbatch accumulation, optional
gradient compression, AdamW), the prefill step and the serve step, for
every family that :mod:`repro_torch.models.transformer` runs on one
device; the serve step also on a device mesh (the dense and moe
families), with the sharding plan that lays its arguments out.  Training
and prefill on a mesh come with a later slice (ROADMAP Queue A item 14d
iii).

The loss takes the one-hot form of the reference (``logsumexp(logits) -
sum(logits * onehot)``), which there keeps the vocab axis sharded; on one
device it is the same number as a gather of the true logit.

On a mesh each rank holds its blocks: :func:`plan_shardings` gives the
specs of the reference's plan, :meth:`ShardingPlan.local` cuts a full
tree to this rank's blocks (the reference's ``named`` + ``device_put``),
:func:`serve_param_specs` is the parameter layout the serve step takes,
:func:`init_local_params` draws it leaf by leaf and
:func:`init_local_decode_state` allocates the rank's caches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (P, MeshAxes, _dim, batch_spec,
                                              decode_state_specs, local_shape,
                                              mesh_coords, opt_state_specs,
                                              param_specs, shard_leaf,
                                              shard_tree)
from repro_torch.models.moe import expert_specs, moe_mode
from repro_torch.models.transformer import (MESH_ITEM, MeshCtx, decode_step,
                                            decode_state_layout, forward,
                                            init_params, kv_cache_len,
                                            param_shapes,
                                            require_mesh_ported)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compressed_gradients
from repro_torch.torch_device import resolve
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"a {what} step over a device mesh is not ported yet "
            f"({MESH_ITEM}); pass mesh=None")


def make_mesh_ctx(mesh, batch_replicated: bool = False,
                  resident_experts: bool = False) -> MeshCtx:
    ax = MeshAxes.for_mesh(mesh)
    return MeshCtx(mesh=mesh, dp_axes=ax.dp, tp_axis=ax.tp,
                   batch_replicated=batch_replicated,
                   resident_experts=resident_experts)


def _on(batch, dev):
    """The batch's arrays as tensors on ``dev``."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean negative log-likelihood, in float32.  logits: (..., V);
    targets: (...) integer ids."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    onehot = torch.zeros_like(logits).scatter_(-1, targets.long()[..., None],
                                               1.0)
    true_logit = torch.sum(logits * onehot, dim=-1)
    return torch.mean(lse - true_logit)


def make_loss_fn(cfg: ArchConfig, ctx=None, remat: bool = True,
                 aux_coef: float = 0.01, unroll: bool = False,
                 remat_policy: Optional[str] = None) -> Callable:
    """``loss_fn(params, batch)``: next-token cross entropy of the forward
    plus ``aux_coef`` times its MoE balance loss.  ``batch`` holds tensors
    on the parameters' device."""
    if ctx is not None:
        raise NotImplementedError(
            f"a loss over a device mesh is not ported yet ({MESH_ITEM})")

    def loss_fn(params, batch):
        logits, aux = forward(params, cfg, batch, remat=remat, unroll=unroll,
                              remat_policy=remat_policy)
        tokens = batch["tokens"]
        return cross_entropy(logits[:, :-1], tokens[:, 1:]) + aux_coef * aux

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


def make_train_step(cfg: ArchConfig, mesh=None, *, lr_fn: Callable,
                    adamw_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True, compress_grads: bool = False,
                    unroll: bool = False, accum_steps: int = 1,
                    remat_policy: Optional[str] = None):
    """``train_step(params, opt_state, batch, step[, comp_state]) ->
    (params, opt_state, loss[, comp_state])``.

    ``batch`` (``tokens``, and ``frontend`` for a vlm; arrays or tensors)
    is moved to the parameters' device; the gradients come from
    :func:`make_grad_fn` (``accum_steps`` microbatches).  With
    ``compress_grads`` and a ``comp_state`` the gradients pass through the
    int8 error-feedback transfer function first.  The parameters and the
    optimizer state are updated in place (see
    :func:`repro_torch.optim.adamw.adamw_update`) and returned.  Only
    ``mesh=None`` (one device) is ported."""
    _refuse_mesh(mesh, "train")
    grad_fn = make_grad_fn(cfg, remat=remat, unroll=unroll,
                           accum_steps=accum_steps, remat_policy=remat_policy)

    def train_step(params, opt_state, batch, step, comp_state=None):
        loss, grads = grad_fn(params, _on(batch, params["embed"].device))
        if compress_grads and comp_state is not None:
            grads, comp_state = compressed_gradients(grads, comp_state)
        params, opt_state = adamw_update(grads, opt_state, params,
                                         lr_fn(step), adamw_cfg)
        out = (params, opt_state, loss)
        return out + ((comp_state,) if compress_grads else ())

    return train_step


def make_grad_fn(cfg: ArchConfig, *, remat: bool = True, unroll: bool = False,
                 accum_steps: int = 1, remat_policy: Optional[str] = None):
    """``grad_fn(params, batch) -> (loss, grads)`` of the train step:
    ``accum_steps > 1`` splits the batch into that many microbatches of
    consecutive rows and averages their losses and gradients (float32
    sums), as the reference's scan over microbatches."""
    loss_fn = make_loss_fn(cfg, None, remat=remat, unroll=unroll,
                           remat_policy=remat_policy)

    def grad_fn(params, batch):
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

    return grad_fn


def make_prefill_step(cfg: ArchConfig, mesh=None, *, torch_device="cuda"):
    """Inference prefill: ``prefill_step(params, batch) -> logits`` of the
    full-sequence forward, without gradients (the reference's prefill
    step, which drops the MoE balance loss).  ``batch["tokens"]`` (B, S)
    ((B, S, nq) for audio; a vlm's batch also ``frontend`` (B, T, D)) may
    hold tensors or arrays; they are moved to ``torch_device``, where the
    parameters must lie.  Only ``mesh=None`` (one device) is ported."""
    _refuse_mesh(mesh, "prefill")
    dev = resolve(torch_device)

    def prefill_step(params, batch):
        if params["embed"].device.type != dev.type:
            raise ValueError(f"parameters on {params['embed'].device}, but "
                             f"the step runs on {dev}")
        with torch.no_grad():
            logits, _ = forward(params, cfg,
                                _on(batch, params["embed"].device))
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
