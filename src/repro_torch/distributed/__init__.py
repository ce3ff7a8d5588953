"""Step functions on one device (train, prefill, serve) and the
straggler watchdog."""

from repro_torch.distributed.step import (cross_entropy, make_loss_fn,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
from repro_torch.distributed.straggler import (StragglerConfig,
                                               StragglerReport,
                                               StragglerWatchdog)

__all__ = ["cross_entropy", "make_loss_fn", "make_prefill_step",
           "make_serve_step", "make_train_step", "StragglerConfig",
           "StragglerReport", "StragglerWatchdog"]
