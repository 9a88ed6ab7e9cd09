"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 — speech frontend STUB
(precomputed frame embeddings of width 1024).  [arXiv:2308.11596; hf]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", num_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=8192,
    vocab_size=256206, head_dim=64, rope_theta=1e4,
    enc_dec=True, num_enc_layers=24,
    frontend="speech", frontend_dim=1024,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio", num_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    head_dim=16, enc_dec=True, num_enc_layers=2,
    frontend="speech", frontend_dim=32,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
