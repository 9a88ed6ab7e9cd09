"""Configuration dataclasses: model architecture and TT compression.

The subset of ``repro.configs.base`` the port runs: GQA with its variants
(qk-norm, sliding windows, gemma3's local/global period, tied
embeddings), multi-head latent attention (``MLAConfig``), the Mamba-2 SSD
mixer (``SSMConfig``), the attention/SSM hybrid's period (one attention
layer every ``attn_every``, at ``attn_index``), and both FFNs, the GLU
MLP and the mixture of experts (``MoEConfig``), and the encoder-decoder
(``enc_dec``: ``num_enc_layers`` non-causal encoder layers over frame
embeddings of width ``frontend_dim`` from the ``speech`` front end, whose
output every decoder layer cross-attends to), and the ``vit`` front end
(precomputed image embeddings of width ``frontend_dim``, projected and
prepended to the token embeddings; ``frontend_tokens`` is the image rows
the serve CLI draws at most).
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
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    expert_ff: int = 0
    num_shared: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    every_n_layers: int = 1                  # MoE at layers where idx % n == n-1
    first_dense_ff: int = 0                  # dense FFN width for layer 0 (dsv2)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The reference's fields, and ``scan_dtype`` (the port's): the dtype
    the prefill's chunked scan accumulates in, ``float32`` as the
    reference's; ``float64`` parts the scan's own rounding from the rest
    of a model's (``launch.groupings``)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    scan_dtype: str = "float32"


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
    # attention variants
    qk_norm: bool = False
    rope_theta: float = 1e6
    window: int = 0                          # >0 → sliding-window attention
    local_global_period: int = 0             # gemma3: every Nth layer global
    local_window: int = 1024
    attn_every: int = 0                      # jamba: 1 attn layer per period
    attn_index: int = 0                      #        at this index
    # mixture of experts
    moe: MoEConfig | None = None
    # multi-head latent attention (deepseek-v2)
    mla: MLAConfig | None = None
    # state space (mamba2)
    ssm: SSMConfig | None = None
    # encoder-decoder (seamless)
    enc_dec: bool = False
    num_enc_layers: int = 0
    # the front end's stub: precomputed embeddings of width frontend_dim
    frontend: str | None = None              # 'vit' | 'speech'
    frontend_dim: int = 0
    frontend_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    tt: TTConfig = TTConfig()
    # attention-kind classification for shape applicability
    subquadratic: bool = False               # can run long_500k decode

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim
