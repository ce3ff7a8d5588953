"""CodeQwen1.5-7B — dense LM, Qwen1.5 architecture.
[hf:Qwen/CodeQwen1.5-7B]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13_440,
    vocab=92_416,
    head_dim=128,
    rope_theta=1_000_000.0,   # qwen1.5 long-context base
    source="hf:Qwen/CodeQwen1.5-7B",
)
