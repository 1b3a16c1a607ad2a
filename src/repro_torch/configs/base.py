"""Model configuration: the ``ModelConfig`` fields the ported families read.

A copy of the dense-, MoE- and hybrid-family parts of the JAX package's
``configs/base.py`` (the port never imports that package).  The other
families and the training/sharding knobs (the MoE ones ``opt_moe_ep`` and
``opt_moe_a2a`` included: TPU-mesh layouts) come with later slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    d_ff: int                     # per-expert hidden size


@dataclass(frozen=True)
class HybridConfig:
    """recurrentgemma-style mixed blocks."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    lru_width: Optional[int] = None
    window: int = 2048


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid (ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    # local/global attention: every ``global_every``-th layer global
    window: Optional[int] = None
    global_every: Optional[int] = None
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    dtype: str = "bfloat16"

    @property
    def padded_vocab_size(self) -> int:
        return self.vocab_size

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (tiny dims)."""
        base = dict(
            num_layers=min(self.num_layers, 2 if self.hybrid is None else 3),
            d_model=128,
            num_heads=4,
            num_kv_heads=(min(self.num_kv_heads, 4)
                          if self.num_kv_heads > 1 else 1),
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim else None,
        )
        if self.moe:
            base["moe"] = MoEConfig(num_experts=8, num_experts_per_tok=2,
                                    d_ff=64)
        if self.hybrid:
            base["hybrid"] = HybridConfig(
                pattern=self.hybrid.pattern, lru_width=128, window=32)
        if self.window:
            base["window"] = 32
        base.update(overrides)
        return dataclasses.replace(self, **base)
