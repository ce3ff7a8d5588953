from repro_torch.core.workloads.driver import (
    MultiHostDriver,
    MultiHostResult,
    TraceDriver,
    TraceResult,
)

__all__ = ["TraceDriver", "TraceResult", "MultiHostDriver", "MultiHostResult"]
