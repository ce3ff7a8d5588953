"""The ``jax.lax`` collectives of the reference's ``shard_map`` islands,
over one mesh axis's process group of a
:class:`~torch.distributed.device_mesh.DeviceMesh`.

``all_gather`` and ``all_to_all`` are tiled (the pieces concatenated along
an existing dimension, as ``tiled=True``), ``psum`` / ``pmax`` / ``pmean``
reduce elementwise, ``axis_index`` is this rank's index along the axis.
Each call is one collective of the axis's group, so every rank of a group
must make the same calls in the same order.  An axis of size 1 moves
nothing.

Ranks that share one card run over gloo (NCCL takes one rank a device).
Gloo runs every one of these collectives on CUDA tensors itself
(``tools/gloo_cuda.py``: ``all_reduce`` sum and max, ``all_gather``,
``all_to_all_single`` and ``broadcast`` ran and gave the right values
under torch 2.11 on the H100), so nothing here copies through the host
or retries a collective another way; only :func:`ppermute`, whose
point-to-point sends that tool did not try, stages a CUDA tensor through
the host.  Every result is a new tensor on the input's device.

The functions above are forward-only.  Training differentiates through
the ones below, each an autograd function whose backward is the
conjugate collective (Megatron's f and g, and the gathers of ZeRO-3):

* :func:`copy_to` — identity forward, ``psum`` backward: where a value
  replicated over the axis enters blocks that each rank computes on its
  own columns (a column-parallel product);
* :func:`reduce_from` — ``psum`` forward, identity backward: the sum of
  the ranks' partial results (after a row-parallel product, the
  vocab-cut embedding), which every rank then holds and differentiates
  as its own copy;
* :func:`gather` — ``all_gather`` forward, reduce-scatter backward (the
  sum over the axis, this rank's piece kept);
* :func:`exchange` — ``all_to_all`` forward, the same ``all_to_all``
  backward (it is its own inverse);
* :func:`scale_grad` — identity forward, the gradient times a constant.

The rule they keep: every rank's autograd graph holds the same
collectives in the same order, so the backward (and a remat recompute)
issues them in the same order on every rank.

``CALLS`` counts the collectives this process issued, by kind (an axis
of size 1 moves nothing and counts nothing); ``reset_calls`` zeroes it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0, "ppermute": 0}


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The axis's pieces of ``x`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    CALLS["all_gather"] += 1
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    CALLS["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def psum_(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`psum` into ``x`` itself (contiguous), which it returns."""
    if axis_size(mesh, axis) > 1:
        CALLS["all_reduce"] += 1
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` split into the axis's size of equal blocks along dimension 0,
    block j sent to rank j, and the blocks received concatenated along
    dimension 0 in rank order (``jax.lax.all_to_all(x, axis, 0, 0,
    tiled=True)``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all over {n} ranks of a leading dimension "
                         f"of {x.shape[0]}")
    src = x.contiguous()
    out = torch.empty_like(src)
    CALLS["all_to_all"] += 1
    dist.all_to_all_single(out, src, group=mesh.get_group(axis))
    return out


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """This rank's ``x`` sent to the rank ``shift`` places on along
    ``axis`` (cyclically), and the tensor of the rank ``shift`` places
    back received (``jax.lax.ppermute`` with ``perm = [(i, i + shift)]``).
    ``x`` has the same shape and dtype on every rank.  A CUDA tensor goes
    through a host copy, so that gloo's send and receive see host
    memory."""
    n = axis_size(mesh, axis)
    if n == 1 or shift % n == 0:
        return x
    group = mesh.get_group(axis)
    i = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    send = x.detach().to("cpu").contiguous()
    recv = torch.empty_like(send)
    CALLS["ppermute"] += 1
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


# ------------------------------------------------- differentiable versions
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed):
        ctx.mesh, ctx.axis, ctx.dim, ctx.summed = mesh, axis, dim, summed
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, ctx.axis)
        if ctx.summed:
            g = psum(g, ctx.mesh, ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None, None)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Identity forward, ``psum`` over ``axis`` backward."""
    return x if axis_size(mesh, axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` over ``axis`` forward, identity backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0,
           summed: bool = True) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim`` forward; backward, this rank's
    piece of the gradient summed over ``axis`` (a reduce-scatter), or of
    its own gradient when ``summed`` is false (every rank of the axis
    then holds the same gradient of the whole)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), summed)


def exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`all_to_all` with its own inverse as the backward."""
    return x if axis_size(mesh, axis) == 1 else _Exchange.apply(x, mesh, axis)


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Identity forward; backward, the gradient times ``factor``."""
    return x if factor == 1 else _ScaleGrad.apply(x, factor)
