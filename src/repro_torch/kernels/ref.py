"""Plain PyTorch versions of the hand-written kernels.

Each repeats its kernel's arithmetic in fp32 and casts back at the end.
The kernel wrappers (``kernels.tt_contract``) run these for CPU tensors;
``chip_smoke.py`` holds every kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch


def tt_fused2_ref(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
                  dims: tuple[int, int, int, int, int],
                  scales: torch.Tensor | None = None) -> torch.Tensor:
    """Whole d=2 TT layer on packed cores, ``x [B, n1·n2] → y [B, m1·m2]``
    (the body of ``repro.kernels.tt_contract._fused2_body``).

    ``p2 [n2, m2·r1]``, ``p1 [n1·r1, m1]``; with ``scales`` ([2] fp32 in
    execution order ``[s2, s1]``) the cores are int8 codes and each
    matmul's output is multiplied by its core's scale.  The intermediate
    stays fp32 for every activation dtype.
    """
    n1, n2, m1, m2, r1 = dims
    B = x.shape[0]
    f32 = torch.float32
    a = x.reshape(B * n1, n2).to(f32) @ p2.to(f32)             # stage 1
    if scales is not None:
        a = a * scales[0]
    a = a.reshape(B, n1, m2, r1).permute(0, 2, 1, 3)           # relayout
    y = a.reshape(B * m2, n1 * r1) @ p1.to(f32)                # stage 2
    if scales is not None:
        y = y * scales[1]
    y = y.reshape(B, m2, m1).permute(0, 2, 1)                  # m-major
    return y.reshape(B, m1 * m2).to(x.dtype)


def tt_fused2_experts_ref(x: torch.Tensor, p2: torch.Tensor,
                          p1: torch.Tensor,
                          dims: tuple[int, int, int, int, int],
                          scales: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The fused d=2 layer of every expert, ``x [E, C, n1·n2] → y [E, C,
    m1·m2]``: ``tt_fused2_ref`` on each expert's rows with its own packed
    cores ``p2 [E, n2, m2·r1]``, ``p1 [E, n1·r1, m1]`` and, for int8 codes,
    its own ``scales [E, 2]`` (the reference runs the fused2 body under
    ``vmap`` over the experts)."""
    return torch.stack([
        tt_fused2_ref(x[e], p2[e], p1[e], dims,
                      None if scales is None else scales[e])
        for e in range(x.shape[0])])


def tt_fused_chain_ref(x: torch.Tensor, packed: Sequence[torch.Tensor],
                       dims: tuple[tuple[int, ...], tuple[int, ...],
                                   tuple[int, ...]],
                       scales: torch.Tensor | None = None) -> torch.Tensor:
    """Whole TT chain of any depth d ≥ 2 on packed cores, ``x [B, N] →
    y [B, M]`` (the body of ``repro.kernels.tt_contract._fused_chain_body``).

    ``packed[j] = P_{d-j}`` (execution order, core d first), each
    ``[n_t·r_t, m_t·r_{t-1}]``; ``dims = (ns, ms, ranks)``.  For t = d … 1
    the state ``[B·b_t, n_t·r_t]`` is multiplied by ``P_t`` and relaid
    ``[B, b_t, m_t, r_{t-1}] → [B, m_t, b_t, r_{t-1}]``.  With ``scales``
    ([d] fp32, execution order) the cores are int8 codes and each step's
    output is multiplied by its core's scale.  The state stays fp32.
    """
    ns, ms, ranks = dims
    B = x.shape[0]
    f32 = torch.float32
    state = x.to(f32)
    f = state.shape[1]
    for j, t in enumerate(range(len(ns) - 1, -1, -1)):
        nt, mt, rt, rt_1 = ns[t], ms[t], ranks[t + 1], ranks[t]
        bt = f // (nt * rt)
        a = state.reshape(B * bt, nt * rt) @ packed[j].to(f32)
        if scales is not None:
            a = a * scales[j]
        a = a.reshape(B, bt, mt, rt_1).permute(0, 2, 1, 3)
        f = mt * bt * rt_1
        state = a.reshape(B, f)
    return state.to(x.dtype)


def tt_step_ref(G: torch.Tensor, X: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """One TT step on the raw core, ``out[m, b, r0] = Σ_{n, r1}
    G[r0, n, m, r1]·X[b, n, r1]`` (the body of
    ``repro.kernels.tt_contract._tt_step_body``), in fp32.

    With ``scale`` (one fp32 value) ``G`` holds int8 codes and the sum is
    multiplied by it.  The output is fp32 for every input dtype.
    """
    out = torch.einsum("rnmk,bnk->mbr", G.to(torch.float32),
                       X.to(torch.float32))
    if scale is not None:
        out = out * scale.reshape(())
    return out
