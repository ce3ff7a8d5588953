"""Kimi K2 — trillion-parameter MoE: 384 experts, top-8 routing,
~32B active parameters.  The headline case for the paper's technique:
the expert store dwarfs HBM and lives in the capacity tier, with the
HBM expert cache run by the CXL-SSD-Sim replacement policies.
[arXiv:2501.kimi2 (paper-table)]"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=0,                   # FFN is fully MoE
    vocab=163_840,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, sharding="ep"),
    source="arXiv:2501.kimi2 (paper-table); ~1.05T total / ~32B active",
)
