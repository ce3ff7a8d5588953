from repro_torch.core.ssd.pal import NANDTiming, PAL
from repro_torch.core.ssd.ftl import FTL
from repro_torch.core.ssd.hil import HIL, SSDConfig

__all__ = ["NANDTiming", "PAL", "FTL", "HIL", "SSDConfig"]
