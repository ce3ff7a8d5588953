"""repro_torch — the CXL-SSD simulator in PyTorch, with hand-written CUDA
kernels for Hopper.

The package mirrors the layout of the JAX package beside it (``core/``,
``core/cache/``, ``core/ssd/``, ``core/cxl/``, ``core/replay/``,
``core/workloads/``, ``kernels/``, ``models/``, ``distributed/``, ...)
and imports nothing from it.  Ported so far: single-host trace replay (the
five device models, ``TraceDriver(engine="python")`` and the cached
CXL-SSD kernel lane ``TraceDriver(engine="cuda")``), tiered-KV serving of
the dense LM family (``launch/serve.py``, ``serving/scheduler.py``) and
its full-sequence prefill (``distributed.make_prefill_step``), each
through hand-written CUDA kernels (``kernels/csrc/``).

Entry points that touch tensors run on the card by default
(``torch_device="cuda"``) and raise when there is none; pass
``torch_device="cpu"`` to run the kernels' plain PyTorch versions.
"""
