"""int8 TT-core quantization: one symmetric fp32 scale per core.

Codes and scales are bit-identical to ``repro.core.quant``: the scale is
``max|G| / 127`` in fp32 (1 for an all-zero core) and ``torch.round``
rounds half to even like ``jnp.round``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def core_scale(G: torch.Tensor) -> torch.Tensor:
    """Symmetric fp32 scale of each trailing ``[r0, n, m, r1]`` core of
    ``G`` (one scalar for one core, ``[*lead]`` for a stack of them, e.g.
    experts); an all-zero core gets scale 1 so it round-trips to exact
    zeros."""
    amax = G.float().abs().amax(dim=(-4, -3, -2, -1))
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_core(G: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One core, or a stack of cores on leading axes, → (int8 codes, fp32
    scale per core: a scalar, or ``[*lead]``), every core of a stack on
    its own scale (the reference's ``quant_nd``)."""
    s = core_scale(G)
    q = torch.clamp(torch.round(G.float() / s[..., None, None, None, None]),
                    -127, 127).to(torch.int8)
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
    """int8 codes times their scales; a stacked core ``[*lead, r0, n, m,
    r1]`` takes a scale per core, ``[*lead]``."""
    return [(q.float() * s.reshape(s.shape + (1,) * 4)).to(dtype)
            for q, s in zip(qcores, scales)]
