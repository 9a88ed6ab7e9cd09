"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 (per expert)
vocab=102400, MoE 64e top-6 + 2 shared — MLA kv_lora=512, first layer dense
(d_ff=10944).  [arXiv:2405.04434; hf]

Note (DESIGN.md §5): MLA is itself a low-rank factorization of the KV path;
TT composes with it on the q/o projections and expert FFNs only.
"""
from .base import MLAConfig, ModelConfig, MoEConfig, TTConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", num_layers=27, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
    head_dim=128, rope_theta=1e4,
    mla=MLAConfig(kv_lora=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408, num_shared=2,
                  shared_ff=1408, first_dense_ff=10944),
    subquadratic=False,  # MLA compresses the cache but attention is full
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe", num_layers=3,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=256,
    head_dim=16,
    mla=MLAConfig(kv_lora=32, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64, num_shared=1,
                  shared_ff=64, first_dense_ff=128,
                  capacity_factor=16.0),  # dropless at test scale
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
