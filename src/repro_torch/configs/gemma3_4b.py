"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global, 128k ctx, tied embeddings, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
    num_heads=8, num_kv_heads=4, d_ff=10240, vocab_size=262144,
    head_dim=256, qk_norm=True, rope_theta=1e6,
    local_global_period=6, local_window=1024, tie_embeddings=True,
    subquadratic=True,   # 5/6 of layers are sliding-window → long_500k runs
)

SMOKE = ModelConfig(
    name="gemma3-4b-smoke", family="dense", num_layers=7, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, local_global_period=3, local_window=16,
    tie_embeddings=True, subquadratic=True,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
