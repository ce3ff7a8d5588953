"""MusicGen-large — decoder-only transformer over EnCodec audio tokens:
4 parallel codebooks (vocab 2048 each) summed at the embedding and
predicted by 4 parallel heads.  The EnCodec frontend is a STUB
(input_specs() provides the token grid). [arXiv:2306.05284; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    rope_theta=10_000.0,
    n_codebooks=4,
    source="arXiv:2306.05284; hf",
)
