"""Mamba2's SSD (state-space duality) layer in PyTorch.

The layout and numerics are the JAX package's (``repro.models.ssm``):
parameters are a plain dict of the split projections (``in_z``, ``in_x``,
``in_B``, ``in_C``, ``in_dt``), the depthwise causal convolutions
(``conv_x``, ``conv_B``, ``conv_C`` and their biases), ``A_log``,
``D_skip``, ``dt_bias``, the gated RMSNorm's ``norm_w`` and
``out_proj``; the decode state is a dict ``{"h" (B, H, P, N) float32,
"conv_buf" (B, K - 1, d_in + 2N)}`` whose buffer holds the trailing
convolution inputs, x channels first, then B, then C.

:func:`ssd_forward` is the chunked algorithm over a whole sequence (the
reference scans over the chunks; this module loops over them in
Python); :func:`ssd_decode_step` is the one-token recurrence.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import rms_norm

NEG_INF = -1e30
SSM_KEYS = ("in_z", "in_x", "in_B", "in_C", "in_dt", "conv_x", "conv_B",
            "conv_C", "conv_bx", "conv_bB", "conv_bC", "A_log", "D_skip",
            "dt_bias", "norm_w", "out_proj")


def ssm_dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int, int]:
    """``(d_in, H, P, N)``: inner width, heads, head dim, state size."""
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.head_dim, cfg.head_dim, cfg.d_state


def ssm_param_shapes(d_model: int, cfg: SSMConfig, lead=()) -> Dict[str, tuple]:
    d_in, H, _, N = ssm_dims(d_model, cfg)
    K = cfg.conv_kernel
    shapes = {"in_z": (d_model, d_in), "in_x": (d_model, d_in),
              "in_B": (d_model, N), "in_C": (d_model, N),
              "in_dt": (d_model, H), "conv_x": (K, d_in), "conv_B": (K, N),
              "conv_C": (K, N), "conv_bx": (d_in,), "conv_bB": (N,),
              "conv_bC": (N,), "A_log": (H,), "D_skip": (H,),
              "dt_bias": (H,), "norm_w": (d_in,), "out_proj": (d_in, d_model)}
    return {k: tuple(lead) + shapes[k] for k in SSM_KEYS}


def init_ssm_params(d_model: int, cfg: SSMConfig, normal, *, device,
                    dtype: torch.dtype = torch.float32, lead=()
                    ) -> Dict[str, torch.Tensor]:
    """Parameters with the reference's scales and constants: normal draws
    by ``normal(shape, std)`` for the projections (``d_model ** -0.5``,
    ``out_proj`` ``d_in ** -0.5``) and convolutions (0.1), zero biases,
    ``A_log = log(1 .. H)``, ``D_skip = 1``, ``dt_bias = -2``, ``norm_w =
    1``.  ``lead`` axes go in front (the stacked layers)."""
    shapes = ssm_param_shapes(d_model, cfg, lead)
    d_in, H, _, _ = ssm_dims(d_model, cfg)
    std = {k: d_model ** -0.5 for k in SSM_KEYS if k.startswith("in_")}
    std.update(conv_x=0.1, conv_B=0.1, conv_C=0.1, out_proj=d_in ** -0.5)
    const = {"D_skip": 1.0, "dt_bias": -2.0, "norm_w": 1.0}
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device))
    p = {}
    for k in SSM_KEYS:
        if k in std:
            p[k] = normal(shapes[k], std[k])
        elif k == "A_log":
            p[k] = a_log.expand(shapes[k]).to(dtype).clone()
        else:
            p[k] = torch.full(shapes[k], const.get(k, 0.0), dtype=dtype,
                              device=device)
    return p


def _split_proj(u, p):
    return (u @ p["in_z"], u @ p["in_x"], u @ p["in_B"], u @ p["in_C"],
            u @ p["in_dt"])


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv along S.  x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _segsum_exp(a):
    """a: (B, L, H) -> (B, H, L, L) with [l, s] = exp(sum_{r=s+1..l} a_r),
    masked to s <= l."""
    cs = torch.cumsum(a, dim=1)
    diff = cs[:, :, None, :] - cs[:, None, :, :]        # (B, L, S, H)
    L = a.shape[1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    diff = torch.where(mask[None, :, :, None], diff, NEG_INF)
    return torch.exp(diff).permute(0, 3, 1, 2)


def ssd_forward(u, p, cfg: SSMConfig):
    """Chunked SSD over a full sequence.  u: (B, S, D) -> (B, S, D)."""
    Bsz, S, D = u.shape
    d_in, H, P, N = ssm_dims(D, cfg)
    L = min(cfg.chunk, S)
    pad = (-S) % L
    z, x, Bm, Cm, dt = _split_proj(u, p)

    x = F.silu(_causal_conv(x, p["conv_x"], p["conv_bx"]))
    Bm = F.silu(_causal_conv(Bm, p["conv_B"], p["conv_bB"]))
    Cm = F.silu(_causal_conv(Cm, p["conv_C"], p["conv_bC"]))

    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                  # (H,)

    if pad:
        x, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm, dt))
    nc = (S + pad) // L

    xh = x.reshape(Bsz, nc, L, H, P).float()
    Bc = Bm.reshape(Bsz, nc, L, N).float()
    Cc = Cm.reshape(Bsz, nc, L, N).float()
    dtc = dt.reshape(Bsz, nc, L, H)
    a = dtc * A

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        xk, Bk, Ck, ak, dk = xh[:, c], Bc[:, c], Cc[:, c], a[:, c], dtc[:, c]
        cs = torch.cumsum(ak, dim=1)                    # (B, L, H)
        decay = _segsum_exp(ak)                         # (B, H, L, S)
        CB = torch.einsum("bln,bsn->bls", Ck, Bk)
        W = CB[:, None] * decay * dk.permute(0, 2, 1)[:, :, None, :]
        y_diag = torch.einsum("bhls,bshp->blhp", W, xk)
        # the carried state's contribution
        y_off = torch.einsum("bln,bhpn->blhp", Ck, h) \
            * torch.exp(cs)[..., None]
        end_decay = torch.exp(cs[:, -1:, :] - cs)       # (B, L, H)
        S_new = torch.einsum("blh,bln,blhp->bhpn", end_decay * dk, Bk, xk)
        h = h * torch.exp(cs[:, -1])[:, :, None, None] + S_new
        ys.append(y_diag + y_off)

    y = torch.stack(ys, dim=1).reshape(Bsz, S + pad, H, P)[:, :S]
    y = y + x.reshape(Bsz, S + pad, H, P)[:, :S] * p["D_skip"].float()[:, None]
    y = y.reshape(Bsz, S, d_in)
    y = rms_norm(y * F.silu(z.float()), p["norm_w"])
    return (y @ p["out_proj"].to(y.dtype)).to(u.dtype)


def ssm_state_shapes(batch: int, d_model: int, cfg: SSMConfig, lead=()
                     ) -> Dict[str, tuple]:
    d_in, H, P, N = ssm_dims(d_model, cfg)
    return {"h": tuple(lead) + (batch, H, P, N),
            "conv_buf": tuple(lead) + (batch, cfg.conv_kernel - 1,
                                       d_in + 2 * N)}


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype: torch.dtype = torch.float32, device="cpu", lead=()
                   ) -> Dict[str, torch.Tensor]:
    """Zeroed state: ``h`` float32 whatever ``dtype``, ``conv_buf`` in
    ``dtype``; ``lead`` axes in front (the stacked layers)."""
    shapes = ssm_state_shapes(batch, d_model, cfg, lead)
    return {"h": torch.zeros(shapes["h"], dtype=torch.float32, device=device),
            "conv_buf": torch.zeros(shapes["conv_buf"], dtype=dtype,
                                    device=device)}


def ssd_decode_step(u, state, p, cfg: SSMConfig):
    """One-token recurrence.  u: (B, D) -> ((B, D), new state)."""
    Bsz, D = u.shape
    d_in, H, P, N = ssm_dims(D, cfg)

    z, x, Bm, Cm, dt = _split_proj(u, p)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                # (B, C)
    window = torch.cat([state["conv_buf"], xbc[:, None]], dim=1)   # (B, K, C)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv_b = torch.cat([p["conv_bx"], p["conv_bB"], p["conv_bC"]], dim=-1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, conv_w) + conv_b)
    x, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())   # (B, H)
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(Bsz, H, P).float()
    dA = torch.exp(dt * A)
    h = state["h"] * dA[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * p["D_skip"].float()[:, None]
    y = y.reshape(Bsz, d_in)
    y = rms_norm(y * F.silu(z.float()), p["norm_w"])
    out = (y @ p["out_proj"].to(y.dtype)).to(u.dtype)
    return out, {"h": h, "conv_buf": window[:, 1:]}
