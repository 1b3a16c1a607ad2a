"""seamless-m4t-large-v2 — encoder-decoder backbone; frame-embedding stub
frontend [arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # decoder layers
    enc_layers=24,            # encoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    act="relu",
    frontend="frames",        # stub: a batch carries frame embeddings
    frontend_len=1024,        # encoder memory length (precomputed frames)
    rope_theta=10_000.0,
    tie_embeddings=True,
)
