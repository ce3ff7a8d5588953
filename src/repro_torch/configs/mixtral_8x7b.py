"""Mixtral-8x7B — 8 experts, top-2 routing, sliding-window attention.
With only 8 experts the model axis (16) shards INSIDE each expert
(``sharding='tp'``). [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=32_000,
    head_dim=128,
    rope_theta=1_000_000.0,
    swa_window=4096,          # per assignment spec
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14_336, sharding="tp"),
    source="arXiv:2401.04088; hf",
)
