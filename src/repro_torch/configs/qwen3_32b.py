"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA, explicit head_dim=128.  [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="qwen3-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=64, num_kv_heads=8, d_ff=25600, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6, subquadratic=False,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    qk_norm=True, rope_theta=1e6,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
