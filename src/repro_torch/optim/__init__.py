from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import wsd_schedule, cosine_schedule
from repro_torch.optim.compression import (CompressionState, compress_init,
                                           compressed_gradients)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "wsd_schedule", "cosine_schedule",
           "CompressionState", "compress_init", "compressed_gradients"]
