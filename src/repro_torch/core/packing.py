"""Compile-time core packing (paper §4.3.1 array packing) and the chain's
state sizes."""
from __future__ import annotations

import torch

from .flops import prod


def pack_core(G: torch.Tensor) -> torch.Tensor:
    """``G [r_{t-1}, n_t, m_t, r_t]`` → ``P [(n_t·r_t), (m_t·r_{t-1})]``
    so that the step contraction becomes ``state2 @ P`` (the layout of
    ``repro.core.packing.pack_core``).  Returns a contiguous tensor."""
    r0, n, m, r1 = G.shape
    return G.permute(1, 3, 2, 0).reshape(n * r1, m * r0).contiguous()


def chain_state_sizes(ns, ms, ranks) -> list[int]:
    """Per-row feature sizes of the chain states s_0 … s_d.

    s_0 = N = Π n_t; after the step on core ``t`` (executed d → 1) the state
    is [m_t, b_t, r_{t-1}] flattened, so s_{d-t+1} = m_t·b_t·r_{t-1};
    s_d = M.  The fused chain kernel keeps s_1 … s_{d-1} on chip.
    """
    d = len(ns)
    f = prod(ns)
    sizes = [f]
    for t in range(d - 1, -1, -1):
        bt = f // (ns[t] * ranks[t + 1])
        f = ms[t] * bt * ranks[t]
        sizes.append(f)
    return sizes


def chain_weight_elems(ns, ms, ranks) -> int:
    """Total element count of the packed cores P_1 … P_d."""
    return sum(ns[t] * ranks[t + 1] * ms[t] * ranks[t]
               for t in range(len(ns)))
