"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent [arXiv:2402.19427]."""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    act="gelu",
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"),
                        lru_width=2560, window=2048),
    tie_embeddings=True,
)
