"""MiniCPM-2B — dense LM, WSD schedule (llama-like arch).
[arXiv:2404.06395; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,          # MHA (GQA with kv == heads)
    d_ff=5760,
    vocab=122_753,
    head_dim=64,
    rope_theta=10_000.0,
    source="arXiv:2404.06395; hf (WSD schedule: see repro.optim.schedules)",
)
