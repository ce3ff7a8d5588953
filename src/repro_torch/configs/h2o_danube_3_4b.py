"""H2O-Danube-3-4B — dense LM, llama+mistral mix with sliding-window
attention.  SWA makes it eligible for the 500k-context decode shape.
[arXiv:2401.16818]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab=32_000,
    head_dim=120,
    rope_theta=100_000.0,
    swa_window=4096,          # mistral-style sliding window
    source="arXiv:2401.16818",
)
