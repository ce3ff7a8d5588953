"""Step functions on one device: the train step (loss, gradients through
the hand-written attention kernels, microbatch accumulation, optional
gradient compression, AdamW), the prefill step and the serve step, for
every family that :mod:`repro_torch.models.transformer` runs.  The
sharded steps come with a later slice (ROADMAP Queue A item 14d).

The loss takes the one-hot form of the reference (``logsumexp(logits) -
sum(logits * onehot)``), which there keeps the vocab axis sharded; on one
device it is the same number as a gather of the true logit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import MESH_ITEM, decode_step, forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compressed_gradients
from repro_torch.torch_device import resolve
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"a {what} step over a device mesh is not ported yet "
            f"({MESH_ITEM}); pass mesh=None")


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


def make_serve_step(cfg: ArchConfig, mesh=None):
    """One-token decode: ``serve_step(params, state, tokens) -> (logits,
    state)``.  Only ``mesh=None`` (one device) is ported."""
    _refuse_mesh(mesh, "serve")

    def serve_step(params, state, tokens):
        return decode_step(params, cfg, state, tokens)

    return serve_step
