"""Llama-3.2-Vision-90B backbone — every 5th layer cross-attends to
precomputed image patch embeddings (the vision frontend is a STUB per the
assignment: input_specs() provides the patch embeddings).
[hf:meta-llama/Llama-3.2-90B-Vision]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,       # 100 layers -> 20 cross-attention layers
    n_frontend_tokens=1600,   # precomputed image patch embeddings (stub)
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up)",
)
