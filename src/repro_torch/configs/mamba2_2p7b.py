"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), d_inner=5120, head_dim=64
(80 heads).  [arXiv:2405.21060; unverified]

The paper's technique targets FC layers: it applies to in/out projections
of each SSD block; the scan itself is untouched (DESIGN.md §5).
"""
from .base import ModelConfig, SSMConfig, TTConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm", num_layers=64, d_model=2560,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    subquadratic=True,   # O(1) decode state
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=256, head_dim=16,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1),
    subquadratic=True,
    tt=TTConfig(enabled=True, families=("ffn",), rank=4, min_factor=2),
)
