"""Hymba-1.5B — hybrid head architecture: attention heads and Mamba(2)
heads run in PARALLEL inside every layer and their (normed) outputs fuse.
[arXiv:2411.13676; hf]"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    rope_theta=10_000.0,
    swa_window=1024,          # hymba uses SWA on most layers
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=128),
    source="arXiv:2411.13676; hf",
)
