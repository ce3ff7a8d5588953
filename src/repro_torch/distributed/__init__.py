"""Sharding rules, step functions (train, prefill, serve; the serve step
also on a device mesh) and the straggler watchdog."""

from repro_torch.distributed.sharding import (MeshAxes, batch_spec,
                                              decode_state_specs,
                                              opt_state_specs, param_specs)
from repro_torch.distributed.step import (cross_entropy, make_decode_step,
                                          make_loss_fn, make_prefill_step,
                                          make_serve_step, make_train_step)
from repro_torch.distributed.straggler import (StragglerConfig,
                                               StragglerReport,
                                               StragglerWatchdog)

__all__ = ["MeshAxes", "batch_spec", "decode_state_specs", "param_specs",
           "opt_state_specs", "cross_entropy", "make_decode_step",
           "make_loss_fn", "make_prefill_step", "make_serve_step",
           "make_train_step", "StragglerConfig", "StragglerReport",
           "StragglerWatchdog"]
