"""Pipeline parallelism over a stage axis (GPipe schedule), the port of
the reference's ``distributed/pipeline.py``.

The layers are split across the ranks of ``stage_axis``, each stage
taking a contiguous slice of the stacked blocks, and the batch streams
through them as ``microbatches`` microbatches over ``M + P - 1`` ticks
(``P`` stages): at tick ``t`` stage ``s`` runs microbatch ``t - s``,
stage 0 reading it from the input and every other stage from what its
predecessor sent on the tick before (:func:`collectives.ppermute`, one
send / receive a tick along the axis).  The last stage keeps the finished
microbatches, and at the end every stage receives them (a ``broadcast``
from the last stage, where the reference takes a masked ``psum``), so
that the output is replicated as the reference's ``out_specs=P()``
makes it.

The reference runs every stage's layers on every tick and throws away
the results of the ticks on which the stage holds no microbatch; this
port skips those ticks, so a stage runs ``block_fn`` exactly
``microbatches`` times for each of its layers (a kernel launched once a
block call is launched ``microbatches x n_layers / P`` times a stage,
``microbatches x n_layers`` over the mesh, as the sequential forward of
the same batch in ``microbatches`` pieces).

Scope is the forward, as the reference's only caller (its test) uses it:
under grad mode, with an input that requires a gradient, ``fn`` raises
``NotImplementedError`` (ROADMAP Queue A item 14d iii-c) rather than
detach.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as col
from repro_torch.tree import tree_leaves, tree_map

BACKWARD_ITEM = "ROADMAP Queue A item 14d iii-c"


def pipeline_forward(block_fn: Callable, mesh, *, stage_axis: str = "pod",
                     microbatches: int = 4):
    """Returns ``fn(x, stacked_blocks) -> y`` running the layers split
    across ``stage_axis`` with GPipe microbatching.

    x: (B, ...) activations, the same on every rank (B % microbatches ==
    0); stacked_blocks: a tree of tensors stacked on a leading n_layers
    axis with n_layers % n_stages == 0, whole (each stage takes its
    contiguous slice, a view).  ``block_fn(h, blk) -> h`` is one layer.
    Returns y (B, ...) on every rank."""
    n_stages = col.axis_size(mesh, stage_axis)

    def fn(x, stacked_blocks):
        leaves = tree_leaves(stacked_blocks)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [x] + leaves):
            raise NotImplementedError(
                "a backward through pipeline_forward is not ported "
                f"({BACKWARD_ITEM}); call it under torch.no_grad()")
        B = x.shape[0]
        if B % microbatches:
            raise ValueError(f"a batch of {B} does not split into "
                             f"{microbatches} microbatches")
        stage = col.axis_index(mesh, stage_axis)
        n_layers = leaves[0].shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers do not split over "
                             f"{n_stages} stages")
        per = n_layers // n_stages
        blocks = tree_map(lambda t: t[stage * per:(stage + 1) * per],
                          stacked_blocks)
        xs = x.reshape(microbatches, B // microbatches, *x.shape[1:])

        def run_stage(h):
            for i in range(per):
                h = block_fn(h, tree_map(lambda t: t[i], blocks))
            return h

        outs = torch.empty_like(xs)
        buf = torch.zeros_like(xs[0])
        for t in range(microbatches + n_stages - 1):
            mb = t - stage
            y = buf
            if 0 <= mb < microbatches:
                y = run_stage(xs[mb] if stage == 0 else buf)
                if stage == n_stages - 1:
                    outs[mb] = y
            # every stage passes its tick's result on (the last stage's
            # wraps to stage 0, which does not read it), as the reference's
            # ppermute does
            buf = col.ppermute(y, mesh, stage_axis, 1)
        if n_stages > 1:
            group = mesh.get_group(stage_axis)
            outs = outs.contiguous()
            dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1),
                           group=group)
        return outs.reshape(B, *x.shape[1:])

    return fn
