"""Unsigned 64-bit arithmetic on ``torch.int64`` tensors.

The torch twins of the splitmix64 / FNV-1a hashes (fault decisions, ECMP
route choices) must equal their numpy ``uint64`` twins bit for bit.
torch has a ``uint64`` dtype, but no right shift, remainder or comparison
for it on the CPU or on the card, so each uint64 is held as the int64 with
the same bits: ``+``, ``*``, ``^`` and ``&`` wrap mod 2^64 exactly as the
unsigned forms do; a logical right shift and a remainder need the helpers
below.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import torch_device as _td

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1


def const(v: int) -> int:
    """The int64 with the bits of the uint64 ``v`` (a python int)."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bits of ``x`` by ``0 < k < 64``
    (``>>`` on int64 shifts the sign in)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def rem(x: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 bits of ``x`` mod ``n``, for ``1 <= n < 2**31``: the
    32-bit halves are each reduced, so no product leaves int64."""
    if not 1 <= n < 2**31:
        raise ValueError(f"modulus must be in [1, 2**31), got {n}")
    hi, lo = shr(x, 32), x & M32
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def as_bits(values, torch_device="cuda") -> torch.Tensor:
    """``values`` as an int64 tensor of their uint64 bits, as numpy's
    ``astype(np.uint64)`` takes them.  Tensors stay where they lie;
    anything else goes to ``torch_device`` first."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.int64)
    bits = np.ascontiguousarray(np.asarray(values).astype(np.uint64))
    return torch.from_numpy(bits.view(np.int64)).to(_td.resolve(torch_device))
