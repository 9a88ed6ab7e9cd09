"""Config registry: ``get_config(arch, variant)`` + ``build(cfg)`` → Model.

The GQA decoders are ported: with a GLU MLP, deepseek-7b, granite-8b,
qwen3-32b (qk-norm) and gemma3-4b (sliding-window local layers between
global ones, qk-norm, tied and scaled embeddings); with a
mixture-of-experts FFN, mixtral-8x7b (sliding-window attention, 8 experts
top-2).  So is deepseek-v2-lite-16b: multi-head latent attention, a dense
first layer, then 64 experts top-6 with shared experts; mamba2-2.7b,
attention-free, every layer a Mamba-2 SSD mixer; and jamba-v0.1-52b, the
attention/SSM hybrid: periods of seven SSD blocks and one GQA block, each
with a GLU MLP or (every other layer) a 16-expert MoE FFN; and
seamless-m4t-large-v2, the encoder-decoder: a non-causal GQA encoder over
speech-frame embeddings and a GQA decoder whose every layer cross-attends
to the encoder's output; and internvl2-2b, the vision-language model: a
GQA decoder with the GLU MLP (InternLM2) whose prompt starts with
projected image embeddings (the InternViT stub).  That is every
architecture of the reference registry; ``PENDING`` lists none left to
port.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import TYPE_CHECKING

import torch

from .base import ModelConfig, TTConfig

if TYPE_CHECKING:                      # avoid configs ↔ models import cycle
    from repro_torch.models.model import Model

PORTED = ("deepseek_7b", "gemma3_4b", "granite_8b", "mixtral_8x7b",
          "qwen3_32b", "deepseek_v2_lite_16b", "mamba2_2p7b",
          "jamba_v0_1_52b", "seamless_m4t_large_v2", "internvl2_2b")

# architectures of the reference registry that are not ported yet
PENDING: tuple[str, ...] = ()

_PENDING_MSG = ("architecture {!r} is not ported yet (ROADMAP.md Queue 1, "
                "\"Remaining families\")")

# external ids (--arch flag) → module names
ALIASES = {a.replace("_", "-"): a for a in PORTED + PENDING}
ALIASES.update({"jamba-v0.1-52b": "jamba_v0_1_52b",
                "mamba2-2.7b": "mamba2_2p7b"})


def get_config(arch: str, variant: str = "full",
               tt: TTConfig | None = None) -> ModelConfig:
    name = ALIASES.get(arch, arch)
    if name in PENDING:
        raise NotImplementedError(_PENDING_MSG.format(arch))
    if name not in PORTED:
        raise ValueError(f"unknown architecture {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg: ModelConfig = {"full": mod.FULL, "smoke": mod.SMOKE}[variant]
    if tt is not None:
        cfg = dataclasses.replace(cfg, tt=tt)
    return cfg


def make_layer_plan(cfg: ModelConfig) -> list:
    """Groups ``[(period, count)]`` of the decoder stack (the SSM, the
    hybrid, the gemma3 local/global, the MLA and the last branch of the
    reference's ``make_layer_plan``): an SSM model (mamba2) is one Mamba-2
    block per layer with no FFN; the hybrid (jamba) is one group of
    ``attn_every``-block periods, block ``attn_index`` GQA and the rest
    Mamba-2, each with the mixture of experts where i % n == n - 1 (n =
    ``moe.every_n_layers``) and the GLU MLP elsewhere; a local block
    attends within ``local_window`` at RoPE theta 10,000, the global one
    closes each period at
    ``rope_theta``, and the layers past the last whole period are local;
    with MLA (deepseek-v2) the first layer's FFN is the dense
    ``first_dense_ff`` MLP and every other layer's the mixture of experts
    (every layer the GLU MLP without ``first_dense_ff``); otherwise every
    layer is one GQA block (windowed when ``window`` is set) with a
    mixture-of-experts FFN when the config has experts, else the GLU
    MLP (the vision-language model, internvl2, falls through to this last
    branch too).  The decoder of an encoder-decoder (seamless) is one GQA
    block per layer that cross-attends to the encoder's output
    (``make_enc_layer_plan`` gives the encoder)."""
    from repro_torch.models.transformer import BlockDef
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm") and not \
            cfg.enc_dec:
        raise NotImplementedError(_PENDING_MSG.format(cfg.name))
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [((BlockDef("ssm", ffn="none"),), L)]
    if cfg.enc_dec:
        return [((BlockDef("gqa", cross=True),), L)]
    if cfg.attn_every:
        n = cfg.moe.every_n_layers if cfg.moe else 0
        period = tuple(
            BlockDef("gqa" if i == cfg.attn_index else "ssm",
                     ffn="moe" if n and i % n == n - 1 else "mlp")
            for i in range(cfg.attn_every))
        return [(period, L // cfg.attn_every)]
    if cfg.local_global_period:
        p = cfg.local_global_period
        local = BlockDef("gqa", window=cfg.local_window, theta=10_000.0)
        glob = BlockDef("gqa", theta=cfg.rope_theta)
        groups = [(tuple([local] * (p - 1) + [glob]), L // p)]
        if L % p:
            groups.append(((local,), L % p))
        return groups
    if cfg.mla is not None:
        if cfg.moe and cfg.moe.first_dense_ff:
            return [((BlockDef("mla", ffn="dense0"),), 1),
                    ((BlockDef("mla", ffn="moe"),), L - 1)]
        return [((BlockDef("mla"),), L)]
    ffn = "moe" if (cfg.moe and cfg.moe.num_experts) else "mlp"
    return [((BlockDef("gqa", window=cfg.window, ffn=ffn),), L)]


def make_enc_layer_plan(cfg: ModelConfig) -> list | None:
    """Groups of the encoder stack, the second half of the reference's
    ``make_layer_plan`` (whose enc-dec branch returns ``(dec, enc)``):
    ``num_enc_layers`` non-causal GQA blocks with the GLU MLP for an
    encoder-decoder, None for every other model."""
    from repro_torch.models.transformer import BlockDef
    if not cfg.enc_dec:
        return None
    return [((BlockDef("gqa", causal=False),), cfg.num_enc_layers)]


def build(cfg: ModelConfig, param_dtype=torch.float32,
          device: str | torch.device | None = None) -> "Model":
    """The model for ``cfg``; ``device=None`` means the GPU."""
    from repro_torch.models.model import Model
    return Model(cfg, make_layer_plan(cfg), param_dtype, device,
                 enc_groups=make_enc_layer_plan(cfg))
