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
or retries a collective another way.  Every result is a new tensor on the
input's device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


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
    dist.all_to_all_single(out, src, group=mesh.get_group(axis))
    return out
