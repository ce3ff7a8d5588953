"""Step functions.  This slice has the single-device serve step."""

from repro_torch.distributed.step import make_serve_step

__all__ = ["make_serve_step"]
