"""Sharding rules: parameter / optimizer / activation partition specs, and
the cut of a full tensor to one rank's block.

Axis roles, as in the JAX package (``repro.distributed.sharding``):
  * ``dp`` axes (``('data',)`` single-pod, ``('pod', 'data')`` multi-pod):
    batch / ZeRO-1 optimizer-state sharding.
  * ``tp`` axis (``'model'``): tensor parallelism — attention heads, FFN
    hidden, vocab, MoE experts (EP) or expert-hidden (TP-in-expert), SSM
    inner channels.

Rules are name-based over the stacked parameter tree (leaves carry a
leading ``n_layers`` axis; paths are the reference's ``_path_str``
strings, ``.blocks.moe.w_gate``).  Anything not matched is replicated.  A
rule whose axes do not divide its leaf falls back to replication (logged).

A spec is a :class:`P`: a tuple with one entry a dimension, each ``None``
or the mesh axes that dimension is cut over (a name, or a tuple of names
cut row-major), normalised as JAX's ``PartitionSpec`` is, so that the two
compare as tuples.  A mesh is anything with axis names and sizes: a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`), or an object with a ``shape`` mapping and
``axis_names``.  Leaves may be tensors, arrays or shape tuples.
:func:`shard_leaf` / :func:`shard_tree` cut full tensors to one rank's
blocks, which is what the reference's ``NamedSharding`` + ``device_put``
does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map

log = logging.getLogger(__name__)


class P(tuple):
    """A partition spec: ``P(None, "model")``.  Entries that are one-axis
    tuples become the axis name and empty tuples ``None``, as in JAX."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise TypeError(f"a {type(mesh).__name__} is not a device mesh: it "
                        "has no axis names")
    return tuple(names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a duck-typed mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(mesh.shape)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a live ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in axis_names(mesh)}


@dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]
    tp: str

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        names = axis_names(mesh)
        if names == ("data", "model"):
            return MeshAxes(dp=("data",), tp="model")
        if names == ("pod", "data", "model"):
            return MeshAxes(dp=("pod", "data"), tp="model")
        # generic: last axis is tp, all leading axes dp
        return MeshAxes(dp=names[:-1], tp=names[-1])


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dim(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in _axes(axes)], dtype=np.int64))


def _spec_fits(mesh, shape, spec: P) -> bool:
    for size, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            continue
        if size % _dim(mesh, axes) != 0:
            return False
    return True


def _rule(path: str, cfg: ArchConfig, ax: MeshAxes,
          kind: str = "train") -> P:
    """PartitionSpec for a stacked-leaf path (the reference's ``_rule``)."""
    tp = ax.tp
    # ---- top-level
    if path.endswith("embed"):
        if cfg.n_codebooks:
            return P(None, tp, None)
        return P(tp, None)
    if path.endswith("lm_head"):
        if cfg.n_codebooks:
            return P(None, None, tp)
        return P(None, tp)
    if path.endswith("final_norm"):
        return P(None)

    layered = ".blocks." in path or ".cross." in path
    lead = (None, None) if ".blocks." in path and cfg.cross_attn_every else \
           ((None,) if layered else ())

    name = path.split(".")[-1]
    # ---- moe (checked before dense mlp: names overlap)
    if ".moe." in path:
        if name == "router":
            return P(*lead, None, None)
        ep = cfg.moe is not None and cfg.moe.sharding == "ep"
        if ep:
            if kind == "decode":
                # resident-expert decode layout: experts over tp,
                # expert-hidden over dp
                if name == "w_down":   # (E, F, D)
                    return P(*lead, tp, ax.dp, None)
                return P(*lead, tp, None, ax.dp)
            # EP + FSDP (training): experts over tp and the within-expert
            # dim over the dp axes
            return P(*lead, tp, ax.dp, None)
        # tp-in-expert
        if kind == "decode":
            if name == "w_down":
                return P(*lead, None, tp, None)
            return P(*lead, None, None, tp)
        if name == "w_down":  # (E, F, D): F over tp, D over dp
            return P(*lead, None, tp, ax.dp)
        return P(*lead, None, ax.dp, tp)  # (E, D, F): D over dp, F over tp
    # ---- ssm (inner channels for pure SSM; replicated for hybrid)
    if ".ssm." in path:
        if cfg.family != "ssm":
            return P()
        if name in ("in_z", "in_x", "conv_x"):
            return P(*lead, None, tp)
        if name == "out_proj":
            return P(*lead, tp, None)
        if name in ("A_log", "D_skip", "dt_bias", "norm_w", "conv_bx"):
            return P(*lead, tp)
        if name == "in_dt":
            return P(*lead, None, tp)
        return P()  # in_B, in_C, conv_B/C + their biases: replicated
    # ---- attention
    if name in ("wq", "wk", "wv"):
        return P(*lead, None, tp)
    if name == "wo":
        return P(*lead, tp, None)
    # ---- dense mlp
    if name in ("w_gate", "w_up"):
        return P(*lead, None, tp)
    if name == "w_down":
        return P(*lead, tp, None)
    # ---- norms, gates, everything else
    return P()


def map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, ``path`` the
    reference's ``_path_str`` form (``.blocks.moe.w_gate``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=f"{path}.{k}")
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def param_specs(params, cfg: ArchConfig, mesh,
                ax: Optional[MeshAxes] = None, kind: str = "train"):
    """Spec tree for the parameter tree.  ``kind='decode'`` switches MoE
    experts to the resident layout (see :func:`_rule`)."""
    ax = ax or MeshAxes.for_mesh(mesh)

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        spec = _rule(path, cfg, ax, kind)
        if len(spec) > len(shape):
            spec = P(*tuple(spec)[:len(shape)])
        if not _spec_fits(mesh, shape, spec):
            log.info("sharding fallback to replicate: %s %s %s", path, shape,
                     spec)
            return P()
        return spec

    return map_with_path(leaf_spec, params)


def fsdp_param_specs(params, cfg: ArchConfig, mesh,
                     ax: Optional[MeshAxes] = None,
                     axes: Optional[Tuple[str, ...]] = None):
    """Fully-sharded (ZeRO-3) specs: every leaf's largest divisible dim
    shards over all mesh axes (else over tp alone, else replicated)."""
    ax = ax or MeshAxes.for_mesh(mesh)
    all_axes = axes if axes is not None else tuple(ax.dp) + (ax.tp,)
    n_all = _dim(mesh, all_axes)

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n_all == 0:
                return P(*(None,) * i, all_axes,
                         *(None,) * (len(shape) - i - 1))
        for i in order:  # fall back to a single-axis shard
            if shape[i] % _dim(mesh, ax.tp) == 0:
                return P(*(None,) * i, ax.tp, *(None,) * (len(shape) - i - 1))
        return P()

    return map_with_path(leaf_spec, params)


def opt_state_specs(opt_state, pspecs, mesh,
                    ax: Optional[MeshAxes] = None, zero1: bool = True):
    """Moment specs = param specs, plus ZeRO-1: the first dimension whose
    spec is free is also cut over the dp axes (when divisible).  int8
    moments' scales take their values' spec less the last axis."""
    ax = ax or MeshAxes.for_mesh(mesh)
    dp_size = _dim(mesh, ax.dp)

    def _uses_dp(spec_t) -> bool:
        return any(a in ax.dp for axes in spec_t for a in _axes(axes))

    def zero_spec(spec: P, leaf):
        if not zero1:
            return spec
        shape = _shape(leaf)
        spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
        if _uses_dp(spec_t):
            return spec  # already sharded over dp (e.g. MoE experts)
        for i, (s, size) in enumerate(zip(spec_t, shape)):
            if s is None and size % dp_size == 0 and size >= dp_size:
                return P(*spec_t[:i], ax.dp, *spec_t[i + 1:])
        return spec

    if "mu_q" in opt_state:
        q_mu = tree_map(zero_spec, pspecs, opt_state["mu_q"])
        q_nu = tree_map(zero_spec, pspecs, opt_state["nu_q"])

        def scale_spec(spec: P, leaf):
            cand = P(*(tuple(spec)[:-1] if len(spec) else ()))
            return cand if _spec_fits(mesh, _shape(leaf), cand) else P()

        return {"mu_q": q_mu, "mu_s": tree_map(scale_spec, q_mu,
                                               opt_state["mu_s"]),
                "nu_q": q_nu, "nu_s": tree_map(scale_spec, q_nu,
                                               opt_state["nu_s"]),
                "count": P()}
    return {"mu": tree_map(zero_spec, pspecs, opt_state["mu"]),
            "nu": tree_map(zero_spec, pspecs, opt_state["nu"]),
            "count": P()}


def batch_spec(cfg: ArchConfig, ax: MeshAxes, kind: str,
               batch_replicated: bool = False) -> Dict[str, P]:
    """Specs of a batch dict's inputs."""
    b = None if batch_replicated else ax.dp
    spec = {"tokens": P(b, None, None) if cfg.n_codebooks else P(b, None)}
    if cfg.cross_attn_every:
        spec["frontend"] = P(b, None, None)
    if kind == "train":
        spec["targets"] = spec["tokens"]
    return spec


def decode_state_specs(state, cfg: ArchConfig, mesh,
                       ax: Optional[MeshAxes] = None,
                       batch_replicated: bool = False):
    """Decode-state specs: the KV cache's sequence axis over tp (the
    flash-decoding layout) when it divides, batch over dp, SSM heads over
    tp for a pure SSM.  ``state`` holds tensors or shapes (a
    :func:`~repro_torch.models.transformer.decode_state_layout`'s shapes
    will do)."""
    ax = ax or MeshAxes.for_mesh(mesh)
    b = None if batch_replicated else ax.dp
    specs: Dict[str, Any] = {"cur": P()}
    if "k" in state:
        seq_ok = _shape(state["k"])[2] % _dim(mesh, ax.tp) == 0
        s = ax.tp if seq_ok else None
        specs["k"] = P(None, b, s, None, None)
        specs["v"] = P(None, b, s, None, None)
        if "k_scale" in state:
            specs["k_scale"] = P(None, b, s, None)
            specs["v_scale"] = P(None, b, s, None)
    if "ssm" in state:
        h_shard = ax.tp if (cfg.family == "ssm" and _shape(
            state["ssm"]["h"])[2] % _dim(mesh, ax.tp) == 0) else None
        specs["ssm"] = {"h": P(None, b, h_shard, None, None),
                        "conv_buf": P(None, b, None, None)}
    if "cross_k" in state:
        specs["cross_k"] = P(None, b, None, None, None)
        specs["cross_v"] = P(None, b, None, None, None)
    return specs


# ------------------------------------------------------ one rank's block
def block_slices(shape, spec: P, mesh, coords: Mapping[str, int]
                 ) -> Tuple[slice, ...]:
    """The slices of a full tensor of ``shape`` that the rank at
    ``coords`` (axis name -> index) holds under ``spec``.  A dimension
    cut over several axes is cut row-major over them, as JAX's
    ``NamedSharding`` cuts it.  A spec that does not divide its dimension
    is refused."""
    sizes = mesh_shape(mesh)
    out = []
    for d, size in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if size % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {axes} ({n} ways) under {spec}")
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a full ``shape`` under ``spec``."""
    zero = {a: 0 for a in axis_names(mesh)}
    return tuple(s.stop - s.start
                 for s in block_slices(shape, spec, mesh, zero))


def shard_leaf(full, spec: P, mesh, coords: Optional[Mapping[str, int]] = None):
    """The block of ``full`` (a tensor or array) that the rank at
    ``coords`` holds (this rank of the live mesh when ``coords`` is not
    given), as a view of ``full``."""
    if not hasattr(full, "shape"):          # a Python scalar (``cur``)
        return full
    coords = mesh_coords(mesh) if coords is None else coords
    return full[block_slices(_shape(full), spec, mesh, coords)]


def shard_tree(tree, specs, mesh, coords: Optional[Mapping[str, int]] = None):
    """:func:`shard_leaf` over a tree and its spec tree (views)."""
    coords = mesh_coords(mesh) if coords is None else coords
    return tree_map(lambda x, s: shard_leaf(x, s, mesh, coords), tree, specs)


# ------------------------------------------------ blocks put back together
def spec_axes(spec: P) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` cuts over, in its order."""
    return tuple(a for e in spec for a in _axes(e))


def _entries(spec: P, ndim: int) -> tuple:
    return tuple(spec)[:ndim] + (None,) * (ndim - len(spec))


def unshard_leaf(local, spec: P, mesh):
    """The whole tensor of which ``local`` is this rank's block under
    ``spec`` (a collective over every axis the spec cuts, so every rank
    of the mesh makes the call): what a global ``jax.Array`` is to the
    reference.  A dimension cut over several axes is put together
    innermost axis first, the inverse of :func:`block_slices`'
    row-major cut."""
    from repro_torch.distributed import collectives as col

    if not hasattr(local, "dim"):           # a Python scalar (``cur``)
        return local
    for d, entry in enumerate(_entries(spec, local.dim())):
        for a in reversed(_axes(entry)):
            local = col.all_gather(local, mesh, a, d)
    return local


def unshard_tree(local, specs, mesh):
    """:func:`unshard_leaf` over a tree and its spec tree."""
    return tree_map(lambda x, s: unshard_leaf(x, s, mesh), local, specs)


def tp_only(spec: P, tp: str) -> P:
    """``spec`` with every axis but ``tp`` dropped: the layout a layer
    computes in."""
    return P(*(tp if tp in _axes(e) else None for e in spec))


def compute_specs(params, cfg: ArchConfig, mesh,
                  ax: Optional[MeshAxes] = None):
    """The layout each parameter is used in by the mesh forward: the
    train rules' (:func:`_rule`) tp entries only, or replicated where
    they do not divide the leaf.  A leaf stored under any spec is
    gathered to this one, differentiably, just before its layer uses it
    (:func:`regather`)."""
    ax = ax or MeshAxes.for_mesh(mesh)

    def leaf_spec(path, leaf):
        shape = _shape(leaf)
        spec = tp_only(P(*tuple(_rule(path, cfg, ax))[:len(shape)]), ax.tp)
        return spec if _spec_fits(mesh, shape, spec) else P()

    return map_with_path(leaf_spec, params)


def regather(x, spec: P, cspec: P, mesh, ax: Optional[MeshAxes] = None):
    """This rank's block ``x`` under ``spec`` as its block under the
    compute spec ``cspec`` (tp entries only), differentiably.

    Forward: every dimension ``spec`` cuts otherwise than ``cspec`` is
    gathered over its axes (innermost first), then every dimension
    ``cspec`` cuts is narrowed to this rank's tp block.  Backward: each
    gather sums over a dp axis (the ranks' batch rows differ) and over
    the tp axis when ``cspec`` cuts over it (the tp ranks' blocks then
    hold disjoint gradients), and keeps this rank's piece; a tp cut that
    ``spec`` does not hold is summed over tp (``copy_to``) before the
    narrow.  So the gradient that comes back is this rank's block of the
    gradient of its own rows' objective summed over the dp axes that
    ``spec`` cuts; :func:`dp_reduce` sums the dp axes it does not."""
    from repro_torch.distributed import collectives as col

    ax = ax or MeshAxes.for_mesh(mesh)
    s, c = _entries(spec, x.dim()), _entries(cspec, x.dim())
    if s == c:
        return x
    tp_used = any(e is not None for e in c)
    for d in range(x.dim()):
        if s[d] != c[d]:
            for a in reversed(_axes(s[d])):
                x = col.gather(x, mesh, a, d, summed=a in ax.dp or tp_used)
    if tp_used and ax.tp not in spec_axes(P(*s)):
        x = col.copy_to(x, mesh, ax.tp)
    for d in range(x.dim()):
        if c[d] is not None and s[d] != c[d]:
            n = col.axis_size(mesh, ax.tp)
            step = x.shape[d] // n
            x = x.narrow(d, col.axis_index(mesh, ax.tp) * step, step)
    return x


def dp_reduce(grads, specs, mesh, ax: Optional[MeshAxes] = None):
    """Each gradient summed over the dp axes its leaf's spec does not cut
    (the leaf is replicated over them, each rank holding the gradient of
    its own rows; :func:`regather` summed the dp axes the spec cuts), in
    place."""
    from repro_torch.distributed import collectives as col

    ax = ax or MeshAxes.for_mesh(mesh)

    def leaf(g, spec):
        for a in ax.dp:
            if a not in spec_axes(spec):
                col.psum_(g, mesh, a)
        return g

    return tree_map(leaf, grads, specs)
