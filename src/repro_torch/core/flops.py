"""Analytic parameter / FLOP models for TT-decomposed FC layers.

Eq. (4) (parameters) and Eq. (11)/(13) (FLOPs) of the paper, copied from
``repro.core.flops`` as far as the DSE needs them.  An FC layer
``y = Wx + b`` with ``W ∈ R^{M×N}`` is factorized with output factors
``ms`` (``Π m_t = M``), input factors ``ns`` (``Π n_t = N``) and TT-ranks
``ranks = [r_0..r_d]`` with ``r_0 = r_d = 1``; core ``t`` has shape
``[r_{t-1}, n_t, m_t, r_t]``.  Pure Python over ints.
"""
from __future__ import annotations

from typing import Sequence


def prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def dense_params(M: int, N: int, bias: bool = True) -> int:
    """Parameters of the unfactorized FC layer: M*N (+ M bias)."""
    return M * N + (M if bias else 0)


def dense_flops(M: int, N: int, bias: bool = True) -> int:
    """FLOPs of one dense matrix–vector product: 2*M*N (+ M bias adds)."""
    return 2 * M * N + (M if bias else 0)


def tt_params(ms: Sequence[int], ns: Sequence[int], ranks: Sequence[int],
              bias: bool = True) -> int:
    """Eq. (4): Memory = M + Σ_t r_{t-1}·m_t·n_t·r_t."""
    d = len(ms)
    assert len(ns) == d and len(ranks) == d + 1
    core = sum(ranks[t] * ms[t] * ns[t] * ranks[t + 1] for t in range(d))
    return core + (prod(ms) if bias else 0)


def tt_flops_step(ms: Sequence[int], ns: Sequence[int], ranks: Sequence[int],
                  t: int) -> int:
    """Eq. (13): FLOPs of einsum step ``t`` (1-indexed like the paper).

    FLOPs^(t) = 2 · r_t · r_{t-1} · m_t···m_d · n_1···n_t
    """
    d = len(ms)
    assert 1 <= t <= d
    return 2 * ranks[t] * ranks[t - 1] * prod(ms[t - 1:]) * prod(ns[:t])


def tt_flops(ms: Sequence[int], ns: Sequence[int], ranks: Sequence[int],
             bias: bool = True) -> int:
    """Eq. (11): FLOPs = M + Σ_t FLOPs^(t)."""
    d = len(ms)
    total = sum(tt_flops_step(ms, ns, ranks, t) for t in range(1, d + 1))
    return total + (prod(ms) if bias else 0)


def max_tt_rank_at_cut(ms: Sequence[int], ns: Sequence[int], t: int) -> int:
    """Paper footnote 5: r_t is bounded by the matrix rank of the t-th
    unfolding: min(Π_{i≤t} m_i·n_i, Π_{i>t} m_i·n_i)."""
    left = prod(ms[:t]) * prod(ns[:t])
    right = prod(ms[t:]) * prod(ns[t:])
    return min(left, right)


def clip_ranks(ms: Sequence[int], ns: Sequence[int],
               ranks: Sequence[int]) -> tuple[int, ...]:
    """Clip a requested rank list to the feasible TT max rank at each cut."""
    d = len(ms)
    out = [1]
    for t in range(1, d):
        out.append(min(int(ranks[t]), max_tt_rank_at_cut(ms, ns, t)))
    out.append(1)
    return tuple(out)


def einsum_loop_bounds(ms: Sequence[int], ns: Sequence[int],
                       ranks: Sequence[int], batch: int = 1
                       ) -> list[dict[str, int]]:
    """Loop bounds {mt, bt, nt, rt, rt_1} of each einsum kernel, in
    *execution* order (core d first), as in paper Listing 2 / Table 3."""
    d = len(ms)
    out = []
    b = batch * prod(ns)
    for t in range(d, 0, -1):
        nt, mt = ns[t - 1], ms[t - 1]
        rt, rt_1 = ranks[t], ranks[t - 1]
        bt = b // (nt * rt)
        out.append(dict(t=t, mt=mt, bt=bt, nt=nt, rt=rt, rt_1=rt_1,
                        flops=2 * mt * bt * nt * rt * rt_1))
        b = mt * bt * rt_1
    return out
