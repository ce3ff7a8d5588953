"""repro_torch — the CXL-SSD simulator in PyTorch, with hand-written CUDA
kernels for Hopper.

The package mirrors the layout of the JAX package beside it (``core/``,
``core/cache/``, ``core/ssd/``, ``core/cxl/``, ``core/replay/``,
``core/workloads/``, ``kernels/``) and imports nothing from it.  This slice
covers single-host trace replay: the five device models, the interpreted
driver (``TraceDriver(engine="python")``) and the cached CXL-SSD kernel lane
(``TraceDriver(engine="cuda")``), which replays the DRAM-cache state machine
and its latency chain in one CUDA kernel.

Entry points that touch tensors run on the card by default
(``torch_device="cuda"``) and raise when there is none; pass
``torch_device="cpu"`` to run the kernels' plain PyTorch versions.
"""
