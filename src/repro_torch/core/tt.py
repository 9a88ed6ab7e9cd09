"""Tensor-Train matrix core math (T3F conventions) in PyTorch.

A TT-matrix for ``W ∈ R^{M×N}`` (``y = W x``) is a list of ``d`` cores,
core ``t`` of shape ``[r_{t-1}, n_t, m_t, r_t]``.  The forward pass is the
paper's Listing-1 einsum chain with the token axis kept leading
(``tt_apply_batched``), as in ``repro.core.tt``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .flops import clip_ranks, prod


@dataclasses.dataclass(frozen=True)
class TTPlan:
    """A fully specified factorization choice for one FC layer."""
    ms: tuple[int, ...]          # output factors, Π = M
    ns: tuple[int, ...]          # input factors,  Π = N
    ranks: tuple[int, ...]       # r_0 … r_d (r_0 = r_d = 1)

    def __post_init__(self):
        assert len(self.ms) == len(self.ns), (self.ms, self.ns)
        assert len(self.ranks) == len(self.ms) + 1
        assert self.ranks[0] == 1 and self.ranks[-1] == 1

    @property
    def d(self) -> int:
        return len(self.ms)

    @property
    def M(self) -> int:
        return prod(self.ms)

    @property
    def N(self) -> int:
        return prod(self.ns)

    @property
    def core_shapes(self) -> list[tuple[int, int, int, int]]:
        return [(self.ranks[t], self.ns[t], self.ms[t], self.ranks[t + 1])
                for t in range(self.d)]


def make_plan(ms: Sequence[int], ns: Sequence[int],
              rank: int | Sequence[int]) -> TTPlan:
    """Build a TTPlan; a scalar ``rank`` means [1, R, …, R, 1] (paper §2),
    clipped to the feasible max rank at each cut (paper footnote 5)."""
    ms, ns = tuple(int(m) for m in ms), tuple(int(n) for n in ns)
    d = len(ms)
    ranks = [1] + [rank] * (d - 1) + [1] if isinstance(rank, int) \
        else list(rank)
    return TTPlan(ms, ns, clip_ranks(ms, ns, ranks))


def tt_reconstruct(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Contract TT cores back to the dense ``W [M, N]`` (tests and the
    dense yardstick of the kernel timings)."""
    d = len(cores)
    acc = None
    ms, ns = [], []
    for G in cores:
        r0, nt, mt, r1 = G.shape
        ns.append(nt)
        ms.append(mt)
        acc = G.reshape(nt, mt, r1) if acc is None else \
            torch.tensordot(acc, G, dims=([acc.dim() - 1], [0]))
    acc = acc.reshape(tuple(x for t in range(d) for x in (ns[t], ms[t])))
    acc = acc.permute([2 * t + 1 for t in range(d)]
                      + [2 * t for t in range(d)])
    return acc.reshape(prod(ms), prod(ns))


def tt_apply_batched(cores: Sequence[torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
    """The paper chain with the token axis ``T`` leading throughout:
    ``x [T, N] → y [T, M]``.  Each step contracts in the state's dtype,
    like ``repro.core.tt.tt_apply_batched`` (bf16 states stay bf16)."""
    T = x.shape[0]
    state = x
    for t in range(len(cores) - 1, -1, -1):
        G = cores[t]
        r0, nt, mt, r1 = G.shape
        state = state.reshape(T, -1, nt, r1)
        state = torch.einsum("rnmk,tbnk->tmbr", G.to(state.dtype), state)
        state = state.reshape(T, -1)
    return state


def tt_apply_experts(cores: Sequence[torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
    """``tt_apply_batched`` of every expert of a stack: cores ``[E, r_{t-1},
    n_t, m_t, r_t]``, ``x [E, T, N] → y [E, T, M]``, expert ``e``'s rows
    through its own cores (the reference's chain under ``vmap``)."""
    E, T = x.shape[:2]
    state = x
    for t in range(len(cores) - 1, -1, -1):
        G = cores[t]
        _, r0, nt, mt, r1 = G.shape
        state = state.reshape(E, T, -1, nt, r1)
        state = torch.einsum("ernmk,etbnk->etmbr", G.to(state.dtype), state)
        state = state.reshape(E, T, -1)
    return state


def tt_apply(cores: Sequence[torch.Tensor], x: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a TT layer to ``x [..., N]`` → ``[..., M]``."""
    lead = x.shape[:-1]
    y = tt_apply_batched(cores, x.reshape(-1, x.shape[-1]))
    if bias is not None:
        y = y + bias
    return y.reshape(lead + (y.shape[-1],))
