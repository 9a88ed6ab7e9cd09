"""int8 TT-core quantization: one symmetric fp32 scale per core.

Codes and scales are bit-identical to ``repro.core.quant``: the scale is
``max|G| / 127`` in fp32 (1 for an all-zero core) and ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def core_scale(G: torch.Tensor) -> torch.Tensor:
    """Symmetric per-core fp32 scale; an all-zero core gets scale 1 so it
    round-trips to exact zeros."""
    amax = G.float().abs().amax()
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_core(G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One core → (int8 core, fp32 scalar scale)."""
    s = core_scale(G)
    q = torch.clamp(torch.round(G.float() / s), -127, 127).to(torch.int8)
    return q, s


def quantize_cores(cores: Sequence[torch.Tensor]
                   ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """[G_t] → ([int8 cores], [fp32 scales])."""
    qs, ss = [], []
    for G in cores:
        q, s = quantize_core(G)
        qs.append(q)
        ss.append(s)
    return qs, ss


def dequantize_cores(qcores: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor],
                     dtype=torch.bfloat16) -> list[torch.Tensor]:
    return [(q.float() * s).to(dtype) for q, s in zip(qcores, scales)]
