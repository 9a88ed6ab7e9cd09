"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code model.  [arXiv:2405.04324; hf]
"""
from .base import ModelConfig, TTConfig

FULL = ModelConfig(
    name="granite-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=49152,
    head_dim=128, rope_theta=1e4, subquadratic=False,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
