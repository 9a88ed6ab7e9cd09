"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend (STUB: precomputed patch embeddings of
width 1024, 1024 tokens) + InternLM2 backbone.  [arXiv:2404.16821; hf]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553,
    head_dim=128, rope_theta=1e6,
    frontend="vit", frontend_dim=1024, frontend_tokens=1024,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    frontend="vit", frontend_dim=32, frontend_tokens=16,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
