"""Design-space exploration for TT-decomposed FC layers (paper §4).

Copied from ``repro.core.dse`` through stage 4, as far as
``models.layers.plan_for`` needs it (the analytic stage 0–2 counts of
Tables 1–2 are not copied):

  stage 1  alignment strategy (§4.1)  — m descending, n ascending
  stage 2  vectorization (§4.2.1)     — ranks multiples of ``vl``
  stage 3  initial-layer (§4.2.2)     — FLOPs & params below dense
  stage 4  scalability (§4.2.3)       — thread table + prune long, light
                                        configurations

Candidates are enumerated at the fp32 weight dtype only and sorted by
(FLOPs, params), the same order the reference gives its fp32 candidates,
so the port picks the reference's TT shapes.  The measured rerank and the
quality gate are not ported.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Iterator, Sequence

from .flops import (dense_flops, dense_params, einsum_loop_bounds,
                    max_tt_rank_at_cut, tt_flops, tt_params)
from .tt import TTPlan, make_plan


@functools.lru_cache(maxsize=None)
def multiplicative_partitions(n: int, min_factor: int = 2
                              ) -> tuple[tuple[int, ...], ...]:
    """All multisets of integers ≥ ``min_factor`` with product ``n``,
    each ascending; ``n`` itself is the length-1 factorization."""
    out: list[tuple[int, ...]] = []

    def rec(remaining: int, start: int, acc: tuple[int, ...]):
        if remaining == 1:
            if acc:
                out.append(acc)
            return
        f = start
        while f * f <= remaining:
            if remaining % f == 0:
                rec(remaining // f, f, acc + (f,))
            f += 1
        if remaining >= start:
            out.append(acc + (remaining,))

    rec(n, min_factor, ())
    return tuple(sorted(set(out)))


def factorizations_by_length(n: int, max_d: int
                             ) -> dict[int, list[tuple[int, ...]]]:
    by_len: dict[int, list[tuple[int, ...]]] = {}
    for f in multiplicative_partitions(n):
        if len(f) <= max_d:
            by_len.setdefault(len(f), []).append(f)
    return by_len


def aligned_pair(fm: Sequence[int], fn: Sequence[int]
                 ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Definition 1: output factors descending, input factors ascending."""
    return tuple(sorted(fm, reverse=True)), tuple(sorted(fn))


def aligned_combination_shapes(M: int, N: int, max_d: int = 12,
                               min_d: int = 2, min_factor: int = 2
                               ) -> list[tuple[tuple[int, ...],
                                               tuple[int, ...]]]:
    """All aligned (ms, ns) combination shapes with equal length d."""
    fm_by = factorizations_by_length(M, max_d)
    fn_by = factorizations_by_length(N, max_d)
    out = []
    for d in range(min_d, max_d + 1):
        for fm in fm_by.get(d, ()):
            if fm[0] < min_factor:       # ascending → fm[0] is the minimum
                continue
            for fn in fn_by.get(d, ()):
                if fn[0] < min_factor:
                    continue
                out.append(aligned_pair(fm, fn))
    return out


@dataclasses.dataclass(frozen=True)
class DSEConfig:
    vl: int = 8                    # vector length (rank multiple)
    rank_cap: int = 3064           # paper's benchmark rank ceiling
    rank_step: int = 8             # grid step for enumerated solutions
    max_d: int = 12                # paper Fig. 10 explores lengths 2–12
    min_d: int = 2
    min_factor: int = 2            # discard shapes with any factor below
    batch: int = 1                 # tokens folded into the chain's b-dim
    # paper Fig. 9: FLOPs → thread count on the SpacemiT K1
    thread_table: tuple[tuple[float, int], ...] = (
        (2e6, 1), (4e6, 2), (8e6, 3), (float("inf"), 4))
    max_scalable_d: int = 4        # prune length > this …
    heavy_flops_min: float = 8e6   # … when the heaviest einsum is below this


def select_threads(flops: float, cfg: DSEConfig) -> int:
    """Paper §4.2.3 / Fig. 9: workload-dependent parallelism selection."""
    for bound, t in cfg.thread_table:
        if flops < bound:
            return t
    return cfg.thread_table[-1][1]


@dataclasses.dataclass(frozen=True)
class Solution:
    plan: TTPlan
    flops: int
    params: int
    threads: tuple[int, ...]       # per einsum, execution order
    max_einsum_flops: int

    @property
    def d(self) -> int:
        return self.plan.d


@dataclasses.dataclass
class DSEResult:
    M: int
    N: int
    counts: dict[str, float]
    solutions: list[Solution]      # sorted by (FLOPs, params) ascending

    def best(self, length: int | None = None, rank: int | None = None
             ) -> Solution | None:
        """First (= cheapest) solution matching the filters, or None."""
        for s in self.solutions:
            if length is not None and s.d != length:
                continue
            if rank is not None and any(r not in (1, rank)
                                        for r in s.plan.ranks):
                continue
            return s
        return None


def _uniform_rank_grid(ms, ns, cfg: DSEConfig) -> Iterable[int]:
    d = len(ms)
    cap = min(cfg.rank_cap,
              min(max_tt_rank_at_cut(ms, ns, t) for t in range(1, d)))
    r = cfg.vl
    while r <= cap:
        yield r
        r += cfg.rank_step


def generate_candidates(M: int, N: int, cfg: DSEConfig = DSEConfig(),
                        counts: dict | None = None) -> Iterator[Solution]:
    """Stages 2–4 as a lazy candidate stream, in shape-enumeration order;
    ``counts`` is filled in place with the funnel tallies."""
    dense_f, dense_p = dense_flops(M, N), dense_params(M, N)
    c = counts if counts is not None else {}
    c.update(vectorized_enumerated=0, initial_layer=0, scalability=0)
    for ms, ns in aligned_combination_shapes(M, N, cfg.max_d, cfg.min_d,
                                             cfg.min_factor):
        for R in _uniform_rank_grid(ms, ns, cfg):
            c["vectorized_enumerated"] += 1
            plan = make_plan(ms, ns, R)
            f = tt_flops(ms, ns, plan.ranks)
            p = tt_params(ms, ns, plan.ranks)
            if f >= dense_f or p >= dense_p:            # stage 3
                continue
            c["initial_layer"] += 1
            bounds = einsum_loop_bounds(ms, ns, plan.ranks, cfg.batch)
            heaviest = max(b["flops"] for b in bounds)
            if plan.d > cfg.max_scalable_d and heaviest < cfg.heavy_flops_min:
                continue                                # stage 4
            threads = tuple(select_threads(b["flops"], cfg) for b in bounds)
            c["scalability"] += 1
            yield Solution(plan, f, p, threads, heaviest)


def explore(M: int, N: int, cfg: DSEConfig = DSEConfig()) -> DSEResult:
    """Run the paper pipeline (stages 1–4) for one FC layer ``[N → M]``;
    ``counts`` holds the funnel tallies of stages 2–4."""
    counts: dict = {}
    survivors = list(generate_candidates(M, N, cfg, counts=counts))
    survivors.sort(key=lambda s: (s.flops, s.params))
    return DSEResult(M, N, counts, survivors)
