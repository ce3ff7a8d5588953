"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (the residual carried in float32 across
steps).

int8 cuts the all-reduce's bytes 4x (against float32) at the price of
quantization noise, which error feedback re-injects the next step so that
the optimizer sees an unbiased long-run gradient.  Applied per leaf with
one scale a tensor.  On one device there is no all-reduce: as in the
reference, :func:`compressed_gradients` applies the quantize / dequantize
transfer function and keeps the residual, the part that changes the
numerics.  Trees are nested dicts of tensors, as the parameters.  On a
device mesh (``mesh=``, ``specs=``) each tree holds this rank's blocks
and a leaf's scale is the largest magnitude over all its blocks (a
``pmax`` over the axes its spec cuts), so each block is quantized as the
one-device leaf is.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map


class CompressionState(NamedTuple):
    residual: Any            # tree of float32 error-feedback residuals


def compress_init(params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _quantize(g, largest=None):
    m = g.abs().max()
    m = m if largest is None else largest(m)
    scale = torch.clamp(m, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compressed_gradients(grads, state: CompressionState, *, mesh=None,
                         specs=None) -> Tuple[Any, CompressionState]:
    """The compress -> all-reduce -> decompress path's transfer function,
    leaf by leaf, and the new error-feedback residuals."""
    def largest(spec):
        if mesh is None:
            return None
        from repro_torch.distributed import collectives as col
        from repro_torch.distributed.sharding import spec_axes

        def reduce(m):
            for a in spec_axes(spec):
                m = col.pmax(m, mesh, a)
            return m

        return reduce

    def leaf(g, r, spec=None):
        g32 = g.float() + r
        deq = _dequantize(*_quantize(g32, largest(spec)))
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(leaf, grads, state.residual,
                     *(() if mesh is None else (specs,)))
    return (tree_map(lambda pair: pair[0], pairs),
            CompressionState(residual=tree_map(lambda pair: pair[1], pairs)))
