"""olmoe-1b-7b — MoE 64 experts top-8, fine-grained d_ff=1024 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, num_experts_per_tok=8, d_ff=1024),
    tie_embeddings=False,
)
