"""Plan-compile-execute pipeline for TT layer dispatch.

Every dispatch decision (backend routing, the shared-memory fit verdict)
is resolved ONCE into a frozen :class:`TTExecutionPlan`; ``kernels.ops.tt_forward`` executes plans and
decides nothing.  Three levels, outermost first:

``PlanBook``        per-model registry, primed from the param specs at
                    build time; ``plan_for_cores`` is a dict hit.
``resolve_plan``    process-wide memoized resolver.
``plan_tt_forward`` the resolver itself; every call increments
                    ``PLAN_RESOLUTIONS`` so a serving run can assert that
                    it planned nothing.

Backends (the reference's names in brackets): ``einsum`` [xla] — the
torch einsum chain; ``cuda_fused2`` [pallas_fused2] — the hand-written
Hopper d=2 kernel; ``cuda_fused`` [pallas_fused] — the whole chain of any
depth d≥2 in one launch; ``cuda_step`` [pallas_step] — one launch per core,
the state round-tripping through device memory; ``auto`` routes d=1 to
``einsum``, d=2 to ``cuda_fused2`` and d≥3 to ``cuda_fused`` when one row
of the chain's state fits a block's shared memory, else to ``cuda_step``
(the reference's rule, ``repro.kernels.plan``, priced for the card).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import hw
from .tt_contract import (check_chain_fits, check_fused2_fits,
                          chain_row_bytes)

BACKENDS = ("einsum", "cuda_fused2", "cuda_fused", "cuda_step", "auto")

WEIGHT_ALIASES = {"fp": "fp", "fp32": "fp", "int8": "int8"}

# number of plan resolutions actually executed (memo/PlanBook hits do not
# count).  Serving asserts this stays flat across a decode run.
PLAN_RESOLUTIONS = 0


def plan_resolutions() -> int:
    return PLAN_RESOLUTIONS


def normalize_weights(weights: str | None) -> str | None:
    if weights is None:
        return None
    if weights not in WEIGHT_ALIASES:
        raise ValueError(f"unknown weight mode {weights!r}: expected one of "
                         f"{tuple(WEIGHT_ALIASES)}")
    return WEIGHT_ALIASES[weights]


@dataclasses.dataclass(frozen=True)
class TTExecutionPlan:
    """Fully resolved execution recipe for one TT chain; ``backend`` is
    always concrete, never ``auto``.  Row tiles are the launch's business
    (``kernels.tt_contract``), not the plan's."""
    ns: tuple[int, ...]            # input factors (core order, t = 1..d)
    ms: tuple[int, ...]            # output factors
    ranks: tuple[int, ...]         # r_0 .. r_d
    backend: str                   # 'einsum' | 'cuda_fused2' |
                                   # 'cuda_fused' | 'cuda_step'
    weights: str                   # 'fp' | 'int8'


def plan_tt_forward(ns: Sequence[int], ms: Sequence[int],
                    ranks: Sequence[int], *, backend: str = "auto",
                    weights: str | None = None,
                    smem_bytes: int | None = None) -> TTExecutionPlan:
    """Resolve ONE execution plan for the chain ``(ns, ms, ranks)``.

    ``auto`` sends d=1 to the einsum chain, d=2 to the fused2 kernel and
    d≥3 to the fused chain when one row of its fp32 state fits one block's
    shared memory, else to the step kernel.  An explicit fused backend
    whose state for one row does not fit raises here rather than falling
    back.  ``smem_bytes`` overrides the card's shared memory per block
    (tests)."""
    global PLAN_RESOLUTIONS
    ns, ms, ranks = (tuple(int(v) for v in a) for a in (ns, ms, ranks))
    d = len(ns)
    if d < 1 or len(ms) != d or len(ranks) != d + 1:
        raise ValueError(
            f"inconsistent chain signature: ns={ns} ms={ms} ranks={ranks}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{BACKENDS}")
    weights = normalize_weights(weights) or "fp"
    smem = hw.device_spec().smem_per_block if smem_bytes is None \
        else smem_bytes

    resolved = backend
    if backend == "auto":
        if d == 1:
            resolved = "einsum"      # a single core is a plain matmul
        elif d == 2:
            resolved = "cuda_fused2"
        elif chain_row_bytes(ns, ms, ranks) <= smem:
            resolved = "cuda_fused"
        else:
            resolved = "cuda_step"
    elif backend == "cuda_fused2" and d != 2:
        raise ValueError(f"cuda_fused2 requires a length-2 plan, got d={d}")
    elif backend == "cuda_fused":
        if d < 2:
            raise ValueError(f"cuda_fused requires d >= 2, got d={d}")
        check_chain_fits(ns, ms, ranks, smem)

    if resolved == "cuda_fused2":
        check_fused2_fits(ns[0], ms[1], ranks[1], smem)
    PLAN_RESOLUTIONS += 1
    return TTExecutionPlan(ns=ns, ms=ms, ranks=ranks, backend=resolved,
                           weights=weights)


_PLAN_MEMO: dict = {}


def resolve_plan(ns, ms, ranks, *, backend: str = "auto",
                 weights: str | None = None) -> TTExecutionPlan:
    """Memoized :func:`plan_tt_forward`: the same planning inputs return
    the same plan object without re-resolution."""
    key = (tuple(ns), tuple(ms), tuple(ranks), backend,
           normalize_weights(weights) or "fp")
    plan = _PLAN_MEMO.get(key)
    if plan is None:
        plan = plan_tt_forward(ns, ms, ranks, backend=backend,
                               weights=weights)
        _PLAN_MEMO[key] = plan
    return plan


def chain_signature(core_shapes: Sequence[Sequence[int]]
                    ) -> tuple[tuple[int, ...], tuple[int, ...],
                               tuple[int, ...]]:
    """(ns, ms, ranks) of a core list from its per-core shapes: the
    trailing ``[r0, n, m, r1]`` of each, so a stack of experts' cores
    ``[E, r0, n, m, r1]`` keys as one expert's."""
    quads = [tuple(int(v) for v in s[-4:]) for s in core_shapes]
    return (tuple(q[1] for q in quads), tuple(q[2] for q in quads),
            tuple(q[0] for q in quads) + (quads[-1][3],))


class PlanBook:
    """Build-time plan registry for one model.

    Construction fixes the policy (requested backend, configured weight
    mode); ``prime()`` resolves every TT layer's plan from
    the param-spec tree; ``plan_for_cores`` is the per-call lookup — a
    dict hit on the chain signature, falling back to one memoized
    resolution for signatures that appear only at run time (the int8
    twin after ``Model.quantize_params``)."""

    def __init__(self, backend: str = "auto", weights: str = "fp"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: expected one "
                             f"of {BACKENDS}")
        self.backend = backend
        self.weights = normalize_weights(weights) or "fp"
        self._plans: dict = {}

    @classmethod
    def from_tt_config(cls, tt) -> "PlanBook":
        backend, weights = tt.plan_policy
        return cls(backend=backend, weights=weights)

    def __len__(self) -> int:
        return len(self._plans)

    def plan_for(self, ns, ms, ranks, *, weights: str | None = None
                 ) -> TTExecutionPlan:
        weights = normalize_weights(weights) or self.weights
        key = (tuple(ns), tuple(ms), tuple(ranks), weights)
        plan = self._plans.get(key)
        if plan is None:
            plan = resolve_plan(ns, ms, ranks, backend=self.backend,
                                weights=weights)
            self._plans[key] = plan
        return plan

    def plan_for_cores(self, cores) -> TTExecutionPlan:
        """Lookup for a concrete core list (only shapes and dtypes are
        read).  int8 cores force the int8 plan."""
        ns, ms, ranks = chain_signature([c.shape for c in cores])
        return self.plan_for(ns, ms, ranks,
                             weights="int8" if cores[0].dtype == torch.int8
                             else None)

    def prime(self, spec_tree) -> int:
        """Resolve a plan for every TT bundle of a param-spec tree
        (``models.spec.ParamSpec`` leaves; dicts and lists), an expert
        stack's by its trailing core shape (once per shape).  Returns the
        number of distinct plans resolved."""
        before = len(self._plans)

        def walk(node):
            if isinstance(node, list):
                for v in node:
                    walk(v)
                return
            if not isinstance(node, dict):
                return
            for k, v in node.items():
                if k == "tt" and isinstance(v, dict):
                    d = sum(1 for kk in v if kk.startswith("c"))
                    specs = [v[f"c{t}"] for t in range(d)]
                    ns, ms, ranks = chain_signature([s.shape for s in specs])
                    self.plan_for(ns, ms, ranks)
                else:
                    walk(v)

        walk(spec_tree)
        return len(self._plans) - before
