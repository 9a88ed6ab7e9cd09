"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave (1 attention layer
per 8-layer period, at index 4), MoE every other layer.
[arXiv:2403.19887; hf]
"""
from .base import ModelConfig, MoEConfig, SSMConfig, TTConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    head_dim=128, rope_theta=1e4,
    attn_every=8, attn_index=4,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336,
                  every_n_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    subquadratic=True,   # hybrid: 28/32 layers are SSM
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    attn_every=4, attn_index=2,
    moe=MoEConfig(num_experts=4, top_k=2, expert_ff=128, every_n_layers=2,
                  capacity_factor=16.0),  # dropless at test scale
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1),
    subquadratic=True,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
