"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and are built with ``nvcc`` at first
use (:mod:`repro_torch.kernels._build`)."""
