"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, sliding-window attention (W=4096).
[arXiv:2401.04088; hf]
"""
from .base import ModelConfig, MoEConfig, TTConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, rope_theta=1e6, window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=14336),
    subquadratic=True,   # SWA ring cache → long_500k runs
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    window=32, moe=MoEConfig(num_experts=4, top_k=2, expert_ff=128,
                             capacity_factor=16.0),  # dropless at test scale
    subquadratic=True,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
