"""Where tensor work runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(torch_device="cuda") -> torch.device:
    """``torch_device`` as a :class:`torch.device`, refusing a CUDA device
    that is not there instead of quietly running on the CPU."""
    dev = torch.device(torch_device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"torch_device must be a cuda or cpu device, "
                         f"got {torch_device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch_device={str(torch_device)!r} but no CUDA device is "
            "available; pass torch_device='cpu' to run the kernels' plain "
            "PyTorch versions")
    return dev
