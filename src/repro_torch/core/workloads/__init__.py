from repro_torch.core.workloads.driver import (
    MultiHostDriver,
    MultiHostResult,
    TraceDriver,
    TraceResult,
)
from repro_torch.core.workloads.stream import run_stream
from repro_torch.core.workloads.membench import run_membench
from repro_torch.core.workloads.viper import ViperConfig, run_viper

__all__ = ["TraceDriver", "TraceResult", "MultiHostDriver", "MultiHostResult",
           "run_stream", "run_membench", "ViperConfig", "run_viper"]
