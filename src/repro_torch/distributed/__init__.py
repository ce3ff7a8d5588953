"""Step functions.  This slice has the single-device prefill and serve
steps."""

from repro_torch.distributed.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
