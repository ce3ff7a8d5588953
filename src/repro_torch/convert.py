"""Carry device configurations and model parameters across from the JAX
package's plain forms.

Device configurations (:func:`device_from_config`):

A configuration is a dict of plain dicts, the ``dataclasses.asdict`` form of
the device configuration dataclasses, so the JAX package and this one can
simulate the same hardware from one description::

    {"cache": {...DRAMCacheConfig...},
     "ssd":   {...SSDConfig..., "timing": {...NANDTiming...}},
     "dram":  {...DRAMTiming...},
     "pmem":  {...PMEMTiming...},
     "link":  {"bw_gbps": ..., "rt_extra_ns": ...},
     "cxl_ssd": {"page_registers": ..., "internal_latency_ns": ...}}

Every section is optional (a missing one keeps the device's Table I
default); a section the named device does not have is refused.

Model parameters (:func:`params_from_jax`): the pytree of the JAX
package's ``init_params`` as numpy arrays, in the same stacked layout (a
vlm's super-blocks and ``cross`` tree included), its ``MoEParams`` and
``SSMParams`` named tuples taken as dicts by field name.  Decode states
(:func:`decode_state_from_jax`): the JAX package's ``init_decode_state``
/ ``decode_step`` state (caches, int8 scales, ``SSMState``, a vlm's
``cross_k`` / ``cross_v``, ``cur``), so that both can go on from one
state.  On a device mesh, :func:`shard_params_from_jax` and
:func:`shard_decode_state_from_jax` give one rank its blocks of either, by
the specs of :mod:`repro_torch.distributed.sharding`: each leaf is cut on
the host and only the block is copied to the device, so a rank's device
holds its blocks only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cache.dram_cache import DRAMCacheConfig
from repro_torch.core.devices import (CXLLink, DRAMTiming, MemDevice,
                                      PMEMTiming, make_device)
from repro_torch.core.ssd.hil import SSDConfig
from repro_torch.core.ssd.pal import NANDTiming
from repro_torch.models.transformer import decode_state_layout, param_shapes
from repro_torch.torch_device import resolve

# sections each device takes, by device name
_SECTIONS = {
    "dram": ("dram",),
    "cxl-dram": ("dram", "link"),
    "pmem": ("pmem",),
    "cxl-ssd": ("ssd", "link", "cxl_ssd"),
    "cxl-ssd-cache": ("cache", "ssd", "link"),
}


def _ssd(d: dict) -> SSDConfig:
    d = dict(d)
    timing = d.pop("timing", None)
    if timing is not None:
        d["timing"] = NANDTiming(**timing)
    return SSDConfig(**d)


def device_from_config(name: str, cfg: dict) -> MemDevice:
    """Build the port's device ``name`` from a configuration dict."""
    if name not in _SECTIONS:
        raise ValueError(f"unknown device {name!r}; choose from "
                         f"{sorted(_SECTIONS)}")
    extra = set(cfg) - set(_SECTIONS[name])
    if extra:
        raise ValueError(f"device {name!r} takes sections "
                         f"{_SECTIONS[name]}, got {sorted(extra)}")
    kw = {}
    if "dram" in cfg:
        kw["timing"] = DRAMTiming(**cfg["dram"])
    if "pmem" in cfg:
        kw["timing"] = PMEMTiming(**cfg["pmem"])
    if "link" in cfg:
        kw["link"] = CXLLink(**cfg["link"])
    if "ssd" in cfg:
        kw["ssd_cfg"] = _ssd(cfg["ssd"])
    if "cache" in cfg:
        kw["cache_cfg"] = DRAMCacheConfig(**cfg["cache"])
    kw.update(cfg.get("cxl_ssd", {}))
    return make_device(name, **kw)


def _as_dict(node):
    """A pytree node as a dict: a named tuple (``MoEParams``, ``SSMParams``,
    ``SSMState``) by its field names."""
    if hasattr(node, "_asdict"):
        return dict(node._asdict())
    if not isinstance(node, dict):
        raise ValueError(f"expected a dict or a named tuple, got "
                         f"{type(node).__name__}")
    return node


def _convert(tree, shapes, where, dev, dtypes=None, specs=None, cut=None):
    """``tree`` as tensors on ``dev``, holding it to ``shapes`` (nested
    dicts of shape tuples) key for key and, where ``dtypes`` names one, to
    its dtype; a missing, extra or misshapen leaf is refused.  With
    ``cut``, each leaf becomes ``cut(array, spec)`` (its ``specs`` leaf)
    before it is copied."""
    tree = _as_dict(tree)
    if set(tree) != set(shapes):
        raise ValueError(f"{where}: expected keys {sorted(shapes)}, "
                         f"got {sorted(tree)}")
    out = {}
    for k, shape in shapes.items():
        if isinstance(shape, dict):
            out[k] = _convert(tree[k], shape, f"{where}{k}/", dev,
                              (dtypes or {}).get(k),
                              specs[k] if specs is not None else None, cut)
            continue
        a = np.asarray(tree[k])
        if a.shape != tuple(shape):
            raise ValueError(f"{where}{k}: expected shape {shape}, "
                             f"got {a.shape}")
        want = (dtypes or {}).get(k)
        if want is not None and a.dtype != want:
            raise ValueError(f"{where}{k}: expected dtype {want}, "
                             f"got {a.dtype}")
        if cut is not None:
            a = cut(a, specs[k])
        out[k] = torch.from_numpy(np.array(a)).to(dev)   # owns a copy
    return out


def params_from_jax(params: dict, cfg: ArchConfig, torch_device="cuda"
                    ) -> dict:
    """The port's parameters from the JAX package's ``init_params`` pytree
    (nested dicts and named tuples of numpy arrays: ``embed``,
    ``lm_head``, ``final_norm`` and the stacked ``blocks``, with their
    ``moe`` and ``ssm`` parameters), on ``torch_device``.  The layout is
    the same (``x @ W`` with ``W`` as ``(d_in, d_out)``), so each leaf is
    copied as it is; a missing, extra or misshapen leaf is refused."""
    return _convert(params, param_shapes(cfg), "params/",
                    resolve(torch_device))


def _cutter(mesh, coords):
    from repro_torch.distributed.sharding import mesh_coords, shard_leaf
    coords = mesh_coords(mesh) if coords is None else coords
    return lambda a, spec: shard_leaf(a, spec, mesh, coords)


def shard_params_from_jax(params: dict, cfg: ArchConfig, mesh, specs=None,
                          coords=None, torch_device="cuda") -> dict:
    """The blocks of :func:`params_from_jax` that the rank at ``coords``
    (this rank of the live ``mesh`` when not given) holds under ``specs``
    (the serve step's layout,
    :func:`repro_torch.distributed.step.serve_param_specs`, when not
    given; the train and prefill steps take
    :func:`~repro_torch.distributed.step.train_param_specs`)."""
    if specs is None:
        from repro_torch.distributed.step import serve_param_specs
        specs = serve_param_specs(cfg, mesh)
    return _convert(params, param_shapes(cfg), "params/",
                    resolve(torch_device), specs=specs,
                    cut=_cutter(mesh, coords))


def shard_opt_state_from_jax(state: dict, cfg: ArchConfig, mesh, specs=None,
                             coords=None, torch_device="cuda") -> dict:
    """The blocks of the JAX package's AdamW state (``adamw_init`` /
    ``adamw_update``'s ``{"mu", "nu", "count"}``, or the int8 moments'
    ``{"mu_q", "mu_s", "nu_q", "nu_s", "count"}``) that the rank at
    ``coords`` holds when the parameters lie under ``specs``
    (:func:`repro_torch.distributed.step.train_param_specs` when not
    given): the moments' ZeRO-1 layout of ``train_opt_specs``.  ``count``
    stays a 0-d int32 tensor on the host, as ``adamw_init`` makes it."""
    from repro_torch.distributed.step import (meta_opt_state,
                                              train_opt_specs,
                                              train_param_specs)
    from repro_torch.tree import tree_map

    specs = train_param_specs(cfg, mesh) if specs is None else specs
    moment_dtype = "int8" if "mu_q" in state else "f32"
    ospecs = train_opt_specs(cfg, mesh, specs, moment_dtype)
    meta = meta_opt_state(cfg, moment_dtype)
    if set(state) != set(meta):
        raise ValueError(f"opt/: expected keys {sorted(meta)}, got "
                         f"{sorted(state)}")
    dev = resolve(torch_device)
    out = {"count": torch.as_tensor(np.asarray(state["count"]),
                                    dtype=torch.int32)}
    for k in meta:
        if k != "count":
            out[k] = _convert(state[k], tree_map(lambda t: tuple(t.shape),
                                                 meta[k]),
                              f"opt/{k}/", dev, specs=ospecs[k],
                              cut=_cutter(mesh, coords))
    return out


def decode_state_from_jax(state: dict, cfg: ArchConfig, torch_device="cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """The port's decode state from the JAX package's (``cur``; caches
    ``k``, ``v``; int8 ``k_scale``, ``v_scale``; the stacked ``SSMState``
    as ``ssm``; a vlm's ``cross_k``, ``cross_v``), on ``torch_device``.
    Every leaf is held to the shape and dtype of
    :func:`repro_torch.models.transformer.decode_state_layout` for the
    state's batch, ring and frontend length and the model ``dtype``; a
    missing, extra, misshapen or mistyped leaf is refused."""
    return _decode_state(state, cfg, resolve(torch_device), dtype)


def shard_decode_state_from_jax(state: dict, cfg: ArchConfig, mesh,
                                batch_replicated: bool = False, coords=None,
                                torch_device="cuda",
                                dtype: torch.dtype = torch.float32) -> dict:
    """The blocks of :func:`decode_state_from_jax` that the rank at
    ``coords`` (this rank when not given) holds under
    ``decode_state_specs``.  A ring that does not split over the model
    axis is refused: the sequence-sharded decode needs it cut."""
    return _decode_state(state, cfg, resolve(torch_device), dtype,
                         (mesh, batch_replicated, coords))


def _decode_state(state, cfg: ArchConfig, dev, dtype, on_mesh=None) -> dict:
    state = _as_dict(state)
    if "k" in state:
        batch, ring = np.shape(state["k"])[1:3]
    elif "ssm" in state:
        batch, ring = np.shape(_as_dict(state["ssm"])["h"])[1], 1
    else:
        raise ValueError("state/: holds neither caches nor SSM states")
    frontend_tokens = (np.shape(state["cross_k"])[2] if "cross_k" in state
                       else 0)
    layout = decode_state_layout(cfg, batch, ring, dtype, frontend_tokens)
    if "k" in layout and layout["k"][0][2] != ring:
        raise ValueError(f"state/k: a ring of {ring} slots is longer than "
                         f"{cfg.name}'s window {cfg.swa_window}")

    def split(tree, i):
        return {k: split(v, i) if isinstance(v, dict) else
                (v[i] if i == 0 else _np_dtype(v[i]))
                for k, v in tree.items()}

    shapes = {"cur": (), **split(layout, 0)}
    specs = cut = None
    if on_mesh is not None:
        from repro_torch.distributed.sharding import decode_state_specs
        mesh, batch_replicated, coords = on_mesh
        specs = decode_state_specs(shapes, cfg, mesh,
                                   batch_replicated=batch_replicated)
        if "k" in specs and specs["k"][2] is None:
            raise ValueError(f"state/k: a ring of {ring} slots does not "
                             "split over the model axis")
        cut = _cutter(mesh, coords)
    out = _convert(state, shapes, "state/", dev, split(layout, 1), specs,
                   cut)
    out["cur"] = int(out["cur"])
    return out


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=dtype).numpy().dtype
