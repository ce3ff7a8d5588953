"""AdamW over trees of tensors (nested dicts, as the parameters): global-norm
clipping, decoupled weight decay, and float32 or int8 moments.

The state mirrors the parameter tree: ``{"mu", "nu", "count"}`` with
float32 moments, or, under ``moment_dtype="int8"`` (Dettmers-style
row-wise dynamic quantization, a quarter of the bytes), ``{"mu_q",
"mu_s", "nu_q", "nu_s", "count"}``: int8 codes of each moment's shape and
float16 scales of its shape less the last axis (one a row), with the
reference's codecs and rounding (``round`` half to even, the quotient by
the float32 scale before its float16 cast; the second moment over the
codes' range [0, 254] shifted by 127).  ``count`` is an int32 0-d tensor.

:func:`adamw_update` computes what the reference's does, leaf by leaf in
float32, but writes the new parameters and moments **in place** into the
given tensors (the reference returns new trees): at minicpm-2b's 3.0 B
parameters a second copy of parameters and float32 moments would be 36 GB
more than one card holds beside them.  It returns the same trees.

On a device mesh (``mesh=``, with the parameters' ``specs`` and the
moments' ``opt_specs`` from ``opt_state_specs``) every tree holds this
rank's blocks and the update is the one-device update of those blocks:
a moment that ZeRO-1 cuts over the dp axes updates this rank's dp piece
of its parameter, which is then gathered over the dp axes into the
parameter's block; :func:`global_norm` counts every element once (each
leaf's sum of squares summed over the axes that cut it, not over those it
is replicated on); an int8 moment's row scale takes the largest value
over the axes that cut its last dimension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # 'f32' | 'int8'
    moment_dtype: str = "f32"


def _q8_init(p):
    """(int8 codes, float16 row scales) of a moment tensor."""
    shape = tuple(p.shape) if p.dim() else (1,)
    return (torch.zeros(shape, dtype=torch.int8, device=p.device),
            torch.zeros(shape[:-1], dtype=torch.float16, device=p.device))


def _q8_encode_signed(x, row_max=None):
    m = x.abs().amax(dim=-1)
    m = m if row_max is None else row_max(m)
    scale = torch.clamp(m, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _q8_decode_signed(q, scale):
    return q.float() * scale.float()[..., None]


def _q8_encode_unsigned(x, row_max=None):
    """nu >= 0: the int8 range as [0, 254], for a bit more resolution."""
    m = x.amax(dim=-1)
    m = m if row_max is None else row_max(m)
    scale = torch.clamp(m, min=1e-20) / 254.0
    q = torch.clamp(torch.round(x / scale[..., None]), 0, 254) - 127
    return q.to(torch.int8), scale.to(torch.float16)


def _q8_decode_unsigned(q, scale):
    return (q.float() + 127.0) * scale.float()[..., None]


def adamw_init(params, moment_dtype: str = "f32") -> dict:
    count = torch.zeros((), dtype=torch.int32)
    if moment_dtype == "int8":
        return {"mu_q": tree_map(lambda p: _q8_init(p)[0], params),
                "mu_s": tree_map(lambda p: _q8_init(p)[1], params),
                "nu_q": tree_map(lambda p: _q8_init(p)[0], params),
                "nu_s": tree_map(lambda p: _q8_init(p)[1], params),
                "count": count}
    if moment_dtype != "f32":
        raise ValueError(f"moment_dtype={moment_dtype!r}: 'f32' or 'int8'")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": count}


def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.  On a mesh
    (``tree`` this rank's blocks under ``specs``) each leaf's sum is
    summed over the axes its spec cuts."""
    if mesh is None:
        total = sum(g.float().square().sum() for g in tree_leaves(tree))
        return torch.sqrt(total)
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import spec_axes

    groups: dict = {}
    for g, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        key = spec_axes(spec)
        groups[key] = groups.get(key, 0.0) + g.float().square().sum()
    total = 0.0
    for axes, part in groups.items():
        for a in axes:
            part = col.psum(part, mesh, a)
        total = total + part
    return torch.sqrt(total)


def _zero_dim(spec, ospec, ndim: int):
    """The dimension that ZeRO-1 cuts over the dp axes in ``ospec`` and
    ``spec`` leaves whole, with those axes; ``(None, ())`` when the two
    agree."""
    from repro_torch.distributed.sharding import _axes, _entries

    s, o = _entries(spec, ndim), _entries(ospec, ndim)
    for d, (a, b) in enumerate(zip(s, o)):
        if a != b:
            if a is not None:
                raise ValueError(f"moment spec {ospec} is not parameter "
                                 f"spec {spec} with one more dp cut")
            return d, _axes(b)
    return None, ()


def adamw_update(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig(),
                 *, mesh=None, specs=None, opt_specs=None
                 ) -> Tuple[Any, dict]:
    """One AdamW step at learning rate ``lr`` (a float or a 0-d tensor).
    Updates ``params`` and ``state`` in place and returns them.  On a
    mesh, ``specs`` / ``opt_specs`` lay out this rank's blocks (see the
    module's docstring)."""
    if (mesh is None) != (specs is None) or (mesh is None) != (
            opt_specs is None):
        raise ValueError("a mesh update needs mesh, specs and opt_specs "
                         "together")
    count = state["count"] + 1
    dev = tree_leaves(params)[0].device
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    clip = None
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0).to(dev)
    b1c = (1.0 - cfg.b1 ** count.float()).to(dev)
    b2c = (1.0 - cfg.b2 ** count.float()).to(dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

    def moments(p, g, mu, nu):
        """The leaf's float32 step: writes p, returns the new moments."""
        g = g.float()
        if clip is not None:
            g = g * clip
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_((p32 - lr * (step + cfg.weight_decay * p32)).to(p.dtype))
        return mu, nu

    def zero(p, g, ospec, spec):
        """``p`` and ``g`` cut to this rank's ZeRO-1 piece, and a function
        that gathers the updated piece back into ``p``."""
        if mesh is None:
            return p, g, lambda: None
        dim, axes = _zero_dim(spec, ospec, p.dim())
        if dim is None:
            return p, g, lambda: None
        from repro_torch.distributed.sharding import (P, shard_leaf,
                                                      unshard_leaf)

        cut = P(*(None,) * dim, axes)
        p_piece = shard_leaf(p, cut, mesh)
        return (p_piece, shard_leaf(g, cut, mesh),
                lambda: p.copy_(unshard_leaf(p_piece, cut, mesh)))

    def row_max(ospec, ndim):
        """The pmax of a row maximum over the axes cutting the last
        dimension of a moment under ``ospec``."""
        if mesh is None:
            return None
        from repro_torch.distributed import collectives as col
        from repro_torch.distributed.sharding import _axes, _entries

        axes = _axes(_entries(ospec, max(ndim, 1))[-1])

        def reduce(m):
            for a in axes:
                m = col.pmax(m, mesh, a)
            return m

        return reduce

    def f32(p, g, mu, nu, ospec=None, spec=None):
        p, g, back = zero(p, g, ospec, spec)
        new_mu, new_nu = moments(p, g, mu, nu)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        back()

    def int8(p, g, mu_q, mu_s, nu_q, nu_s, ospec=None, spec=None):
        p, g, back = zero(p, g, ospec, spec)
        mu, nu = moments(p, g,
                         _q8_decode_signed(mu_q, mu_s).reshape(p.shape),
                         _q8_decode_unsigned(nu_q, nu_s).reshape(p.shape))
        rm = row_max(ospec, p.dim())
        for q, s, (codes, scales) in (
                (mu_q, mu_s, _q8_encode_signed(mu if mu.dim() else mu[None],
                                               rm)),
                (nu_q, nu_s, _q8_encode_unsigned(nu if nu.dim()
                                                 else nu[None], rm))):
            q.copy_(codes)
            s.copy_(scales)
        back()

    with torch.no_grad():
        if cfg.moment_dtype == "int8":
            extra = (() if mesh is None else (opt_specs["mu_q"], specs))
            tree_map(int8, params, grads, state["mu_q"], state["mu_s"],
                     state["nu_q"], state["nu_s"], *extra)
        else:
            extra = (() if mesh is None else (opt_specs["mu"], specs))
            tree_map(f32, params, grads, state["mu"], state["nu"], *extra)
    state["count"] = count
    return params, state
