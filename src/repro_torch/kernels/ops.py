"""The TT layer executor: ``tt_forward(cores, x, plan=...)``.

Executes a resolved :class:`kernels.plan.TTExecutionPlan`:

  'einsum'      — the paper's einsum chain in torch (the reference's
                  ``xla`` backend); a baseline, not a kernel
  'cuda_fused2' — the hand-written Hopper d=2 kernel
                  (``kernels.tt_contract.tt_fused2[_int8]``)
  'cuda_fused'  — the whole chain of any depth d≥2 in one launch
                  (``kernels.tt_contract.tt_fused_chain[_int8]``)
  'cuda_step'   — one step kernel launch per core
                  (``kernels.tt_contract.tt_step[_int8]``), the state cast
                  to the activation dtype between steps

``plan.weights == 'int8'`` serves stored int8 cores with their per-core
``scales`` (the layout of ``models.layers.quantize_tt_params``); float
cores under an int8 plan are refused, since quantizing is a checkpoint
transform (``Model.quantize_params``), not a per-call step.

A stack of experts (cores ``[E, r_{t-1}, n_t, m_t, r_t]``, scales ``[E,
d]``, ``x [E, C, N]``; the reference runs these under ``vmap``) takes the
same plan, keyed by the trailing core shape: ``einsum`` runs the chain of
every expert batched, ``cuda_fused2`` one launch of
``tt_contract.tt_fused2_experts[_int8]`` across all experts.
``cuda_fused`` and ``cuda_step`` have no expert-batched kernel yet and
raise.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.packing import pack_core
from repro_torch.core.quant import dequantize_cores
from repro_torch.core.tt import tt_apply, tt_apply_experts
from .plan import TTExecutionPlan, chain_signature, resolve_plan
from .tt_contract import (tt_fused2, tt_fused2_experts, tt_fused2_experts_int8,
                          tt_fused2_int8, tt_fused_chain, tt_fused_chain_int8,
                          tt_step, tt_step_int8)

# where the chain and step kernels over an experts axis are listed
_NO_EXPERT_KERNEL = ("backend {!r} has no expert-batched kernel yet "
                     "(ROADMAP.md Queue 2, \"the chain and step kernels over "
                     "an experts axis\"); serve a stack of experts at length "
                     "2 through cuda_fused2 (auto) or einsum")


def _chain_with_step_kernel(cores: Sequence[torch.Tensor], x: torch.Tensor,
                            scales=None) -> torch.Tensor:
    """The paper's chain with each einsum in the step kernel
    (``repro.kernels.ops._chain_with_step_kernel``).  Layout between steps
    follows the paper exactly: reshapes only, and the state is cast to
    ``x.dtype`` after every step.  With ``scales`` the cores are int8 codes
    (one launch of the int8 step kernel per core)."""
    B = x.shape[0]
    state = x.reshape(-1)
    for t in range(len(cores) - 1, -1, -1):
        G = cores[t]
        _, nt, _, r1 = G.shape
        st = state.reshape(state.numel() // (nt * r1), nt, r1)
        if scales is not None:
            out = tt_step_int8(G, st, scales[t].reshape(1))
        else:
            out = tt_step(G, st)
        state = out.reshape(-1).to(x.dtype)       # [m, b, r0] flattened
    return state.reshape(-1, B).T


def tt_forward(cores: Sequence[torch.Tensor], x: torch.Tensor,
               bias: torch.Tensor | None = None, *,
               plan: TTExecutionPlan | None = None,
               backend: str = "auto",
               scales: torch.Tensor | Sequence[torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Apply a TT layer to ``x [..., N]`` → ``[..., M]`` in ``x.dtype``.

    ``plan=`` executes a pre-resolved plan (the model stack resolves each
    layer's plan once at build time); without one, a plan for ``backend``
    is resolved through the memo.  int8 cores imply int8 weights and need
    their per-core ``scales`` (core order).  Cores with a leading experts
    axis ``[E, ...]`` apply expert ``e``'s cores to ``x[e]`` (``x [E, ...,
    N]``; int8 scales ``[E, d]``).
    """
    ns, ms, ranks = chain_signature([G.shape for G in cores])
    N = 1
    for n in ns:
        N *= n
    if N != x.shape[-1]:
        raise ValueError(
            f"TT core list with input modes {ns} (prod={N}) does not match "
            f"x.shape[-1]={x.shape[-1]}")
    for t in range(len(cores) - 1):
        if cores[t].shape[-1] != cores[t + 1].shape[-4]:
            raise ValueError(
                f"TT rank mismatch between cores {t} and {t + 1}: "
                f"r={cores[t].shape[-1]} vs r={cores[t + 1].shape[-4]}")
    experts = cores[0].dim() - 4
    if experts not in (0, 1) or any(G.dim() != cores[0].dim()
                                    for G in cores):
        raise ValueError(f"TT cores must be [r0, n, m, r1], or stacked on "
                         f"one experts axis, got "
                         f"{[tuple(G.shape) for G in cores]}")
    if experts and (x.dim() < 2 or x.shape[0] != cores[0].shape[0]):
        raise ValueError(f"a stack of {cores[0].shape[0]} experts takes x "
                         f"[E, ..., N], got {tuple(x.shape)}")
    stored_int8 = cores[0].dtype == torch.int8
    if plan is None:
        plan = resolve_plan(ns, ms, ranks, backend=backend,
                            weights="int8" if stored_int8 else None)
    elif (plan.ns, plan.ms, plan.ranks) != (ns, ms, ranks):
        raise ValueError(
            f"plan/chain mismatch: plan is for n={plan.ns} m={plan.ms} "
            f"r={plan.ranks}, cores are n={ns} m={ms} r={ranks}")

    if plan.weights == "int8":
        if not stored_int8:
            raise ValueError("an int8 plan needs stored int8 cores: run "
                             "Model.quantize_params on the parameters first")
        if scales is None:
            raise ValueError("int8 cores require their per-core scales")
    elif stored_int8:
        raise ValueError("int8 cores cannot run the float path: resolve an "
                         "int8 plan")
    elif scales is not None:
        raise ValueError("scales were passed but the plan is not int8")

    lead = x.shape[:-1]
    if experts:
        return _experts_forward(cores, x, bias, plan, scales, ns, ms, ranks)
    x2 = x.reshape(-1, x.shape[-1])
    if plan.backend == "einsum":
        if plan.weights == "int8":
            y = tt_apply(dequantize_cores(cores, list(scales), torch.float32),
                         x2.float())
        else:
            y = tt_apply(cores, x2)
    elif plan.backend == "cuda_fused2":
        dims = (ns[0], ns[1], ms[0], ms[1], ranks[1])
        x2 = x2.contiguous()
        if plan.weights == "int8":
            s = torch.stack([scales[1], scales[0]]).float()
            y = tt_fused2_int8(x2, pack_core(cores[1]), pack_core(cores[0]),
                               s, dims)
        else:
            y = tt_fused2(x2, pack_core(cores[1]), pack_core(cores[0]), dims)
    elif plan.backend == "cuda_fused":
        packed = [pack_core(G) for G in reversed(cores)]
        x2 = x2.contiguous()
        if plan.weights == "int8":
            s = torch.stack(list(scales)[::-1]).float()
            y = tt_fused_chain_int8(x2, packed, s, (ns, ms, ranks))
        else:
            y = tt_fused_chain(x2, packed, (ns, ms, ranks))
    elif plan.backend == "cuda_step":
        y = _chain_with_step_kernel(cores, x2, scales)
    else:
        raise ValueError(f"plan resolved to unknown backend {plan.backend!r}")
    if bias is not None:
        y = y + bias
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


def _experts_forward(cores, x, bias, plan: TTExecutionPlan, scales, ns, ms,
                     ranks) -> torch.Tensor:
    """``tt_forward`` of a stack of experts: ``x [E, ..., N]`` → ``[E, ...,
    M]``, one batched chain (einsum) or one launch across all experts
    (fused2)."""
    E = x.shape[0]
    lead = x.shape[:-1]
    x3 = x.reshape(E, -1, x.shape[-1])
    if plan.backend == "einsum":
        if plan.weights == "int8":
            y = tt_apply_experts(dequantize_cores(
                cores, [scales[:, t] for t in range(len(cores))],
                torch.float32), x3.float())
        else:
            y = tt_apply_experts(cores, x3)
    elif plan.backend == "cuda_fused2":
        dims = (ns[0], ns[1], ms[0], ms[1], ranks[1])
        x3 = x3.contiguous()
        p2, p1 = pack_core(cores[1]), pack_core(cores[0])
        if plan.weights == "int8":
            s = torch.stack([scales[:, 1], scales[:, 0]], -1).float()
            y = tt_fused2_experts_int8(x3, p2, p1, s.contiguous(), dims)
        else:
            y = tt_fused2_experts(x3, p2, p1, dims)
    elif plan.backend in ("cuda_fused", "cuda_step"):
        raise NotImplementedError(_NO_EXPERT_KERNEL.format(plan.backend))
    else:
        raise ValueError(f"plan resolved to unknown backend {plan.backend!r}")
    if bias is not None:
        y = y + bias
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)
