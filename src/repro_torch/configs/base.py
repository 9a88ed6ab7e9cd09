"""Configuration dataclasses: model architecture and TT compression.

The dense GQA + GLU-MLP subset of ``repro.configs.base``; fields of the
families the port does not run yet (MoE, MLA, SSM, cross-attention,
frontends) are left out until they are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class TTConfig:
    """How the paper's technique is applied to a model.

    ``families``: which projection families are TT-factorized.  The DSE
    (``core.dse.explore``) picks the factorization shape at build time.
    ``backend`` names the port's backends: ``einsum`` (the torch einsum
    chain), ``cuda_fused2`` (the hand-written Hopper d=2 kernel),
    ``cuda_fused`` (the whole chain of any depth in one launch),
    ``cuda_step`` (one step kernel per core) or ``auto``.  ``length`` is
    the preferred TT length d the DSE picks shapes for.  ``weights`` is the
    resident core dtype: ``int8`` serves quantized cores through the int8
    kernels.
    """
    enabled: bool = False
    families: tuple[str, ...] = ("ffn",)     # of: ffn, attn, lm_head
    rank: int = 16
    length: int = 2                          # paper §6.4 deploys length-2
    min_factor: int = 8
    backend: str = "einsum"                  # einsum | cuda_fused2 |
                                             # cuda_fused | cuda_step | auto
    weights: str = "fp32"                    # fp32 | int8

    @property
    def plan_policy(self) -> tuple[str, str]:
        """(backend, canonical weight mode) consumed by the plan resolver
        (``kernels.plan.PlanBook.from_tt_config``)."""
        return self.backend, "int8" if self.weights == "int8" else "fp"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tt: TTConfig = TTConfig()

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim
