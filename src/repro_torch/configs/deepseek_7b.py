"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32 → MHA) d_ff=11008
vocab=102400 — llama-arch.  [arXiv:2401.02954; hf]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=102400,
    head_dim=128, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    rope_theta=1e4,
    tt=TTConfig(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2),
)
