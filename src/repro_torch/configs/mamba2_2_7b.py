"""Mamba2-2.7B — attention-free SSM using the SSD (state-space duality)
algorithm: chunked intra-chunk matmuls + inter-chunk state recurrence.
[arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    source="arXiv:2405.21060",
)
