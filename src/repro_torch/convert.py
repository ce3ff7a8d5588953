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
package's ``init_params`` as numpy arrays, in the same stacked layout.
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
from repro_torch.models.transformer import param_shapes
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


def params_from_jax(params: dict, cfg: ArchConfig, torch_device="cuda"
                    ) -> dict:
    """The port's parameters from the JAX package's ``init_params`` pytree
    (nested dicts of numpy arrays: ``embed``, ``lm_head``, ``final_norm``
    and the stacked ``blocks``), on ``torch_device``.  The layout is the
    same (``x @ W`` with ``W`` as ``(d_in, d_out)``), so each leaf is copied
    as it is; a missing, extra or misshapen leaf is refused."""
    dev = resolve(torch_device)

    def convert(tree, shapes, where):
        if set(tree) != set(shapes):
            raise ValueError(f"{where}: expected keys {sorted(shapes)}, "
                             f"got {sorted(tree)}")
        out = {}
        for k, shape in shapes.items():
            if isinstance(shape, dict):
                out[k] = convert(tree[k], shape, f"{where}{k}/")
                continue
            a = np.asarray(tree[k])
            if a.shape != tuple(shape):
                raise ValueError(f"{where}{k}: expected shape {shape}, "
                                 f"got {a.shape}")
            out[k] = torch.from_numpy(np.array(a)).to(dev)   # owns a copy
        return out

    return convert(params, param_shapes(cfg), "params/")
