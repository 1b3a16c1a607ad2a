"""gemma3-1b — dense, GQA kv=1, 5:1 local:global, 262k vocab [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    qk_norm=True,
    act="gelu",
    window=512,               # sliding window for local layers
    global_every=6,           # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    logit_softcap=None,
)
