"""repro_torch — the CXL-SSD simulator in PyTorch, with hand-written CUDA
kernels for Hopper.

The package mirrors the layout of the JAX package beside it (``core/``,
``core/cache/``, ``core/ssd/``, ``core/cxl/``, ``core/replay/``,
``core/workloads/``, ``kernels/``, ``models/``, ``distributed/``, ...)
and imports nothing from it.  Ported so far: trace replay (the five
device models, the python lane of ``TraceDriver`` / ``MultiHostDriver``
over direct devices, CXL fabrics with ECMP, QoS and pools, and
deterministic fault plans; the paper's STREAM, membench and Viper
workloads; the cached CXL-SSD kernel lane ``TraceDriver(engine="cuda")``,
on a bare device or a fabric mount), tiered-KV serving of
the dense LM family (``launch/serve.py``, ``serving/scheduler.py``) and
its full-sequence prefill (``distributed.make_prefill_step``), each
through hand-written CUDA kernels (``kernels/csrc/``).

Entry points that touch tensors run on the card by default
(``torch_device="cuda"``) and raise when there is none; pass
``torch_device="cpu"`` to run the kernels' plain PyTorch versions.
"""
