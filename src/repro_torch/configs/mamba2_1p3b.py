"""mamba2-1.3b — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=0,                   # no separate MLP: Mamba-2 blocks only
    vocab_size=50_280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    tie_embeddings=True,
)
