"""GLM4-9B — dense LM, aggressive GQA (2 KV heads), RoPE.
[hf:THUDM/glm-4-9b]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab=151_552,
    head_dim=128,
    rope_theta=500_000.0,
    source="hf:THUDM/glm-4-9b",
)
