"""Architecture configuration schema.

Every architecture is a frozen :class:`ArchConfig`, one module per
architecture under ``repro_torch.configs`` (data only, the same values as
the JAX package's).  :func:`get_arch` maps ``--arch`` ids to them.  The
model code of this package runs the dense family only and refuses the
others (:mod:`repro_torch.models.transformer`).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN hidden dim
    # 'ep' shards the expert dim over the model axis (needs n_experts >=
    # axis size); 'tp' shards each expert's d_expert instead (few experts)
    sharding: str = "ep"
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128             # SSD chunk length (state-space duality)
    conv_kernel: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free families
    n_kv_heads: int
    d_ff: int                    # dense FFN hidden (0 for pure-SSM / pure-MoE)
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    swa_window: int = 0          # sliding-window size; 0 = full causal
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # vlm: every Nth layer is a cross-attention layer over image tokens
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0   # precomputed patch/frame embeddings (stub)
    # audio: EnCodec-style parallel codebooks summed at the embedding
    n_codebooks: int = 0
    source: str = ""             # provenance note
    attn_block: int = 256        # flash-attention q/kv tile
    attn_impl: str = "masked"    # 'masked' | 'triangular'
    kv_dtype: str = "model"      # decode KV cache dtype: 'model' | 'int8'

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (e.g. minicpm's 122753 ->
        122880).  Pad logits are masked at sampling time."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, V = self.d_model, self.vocab
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += d * V                  # lm head
        total += d                          # final norm
        total += self.n_layers * self._per_layer_params()
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (2 * self.d_model + self._attn_params())
        if self.n_codebooks:
            total += (self.n_codebooks - 1) * V * d  # extra codebook embeds
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _ffn_params(self) -> int:
        if self.moe is not None:
            router = self.d_model * self.moe.n_experts
            expert = 3 * self.d_model * self.moe.d_expert  # gate/up/down
            return router + self.moe.n_experts * expert
        return 3 * self.d_model * self.d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        d, s = self.d_model, self.ssm
        d_in = s.expand * d
        n_heads = d_in // s.head_dim
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)
        conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
        out = d_in * d + d_in  # out_proj + gated norm
        return in_proj + conv + out + 2 * n_heads  # + A_log, D

    def _per_layer_params(self) -> int:
        d = self.d_model
        norms = 2 * d
        if self.family == "ssm":
            return d + self._ssm_params()
        if self.family == "hybrid":
            return (norms + self._attn_params() + self._ssm_params()
                    + self._ffn_params())
        return norms + self._attn_params() + self._ffn_params()

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small: Dict = dict(
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.n_heads else 0,
            swa_window=min(self.swa_window, 32) if self.swa_window else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            n_codebooks=self.n_codebooks and 2,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            small["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                     sharding=self.moe.sharding,
                                     capacity_factor=8.0)  # drop-free for parity
        if self.ssm is not None:
            small["ssm"] = SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)


ARCH_IDS = [
    "minicpm-2b",
    "codeqwen1_5-7b",
    "glm4-9b",
    "h2o-danube-3-4b",
    "hymba-1_5b",
    "llama-3_2-vision-90b",
    "mamba2-2_7b",
    "kimi-k2-1t-a32b",
    "mixtral-8x7b",
    "musicgen-large",
]


def get_arch(arch_id: str) -> ArchConfig:
    """Load ``repro_torch.configs.<arch>`` and return its CONFIG."""
    key = arch_id.replace(".", "_").replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG
