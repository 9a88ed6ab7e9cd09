"""Compile-time core packing (paper §4.3.1 array packing)."""
from __future__ import annotations

import torch


def pack_core(G: torch.Tensor) -> torch.Tensor:
    """``G [r_{t-1}, n_t, m_t, r_t]`` → ``P [(n_t·r_t), (m_t·r_{t-1})]``
    so that the step contraction becomes ``state2 @ P`` (the layout of
    ``repro.core.packing.pack_core``).  Returns a contiguous tensor."""
    r0, n, m, r1 = G.shape
    return G.permute(1, 3, 2, 0).reshape(n * r1, m * r0).contiguous()
