"""The TT layer executor: ``tt_forward(cores, x, plan=...)``.

Executes a resolved :class:`kernels.plan.TTExecutionPlan`:

  'einsum'      — the paper's einsum chain in torch (the reference's
                  ``xla`` backend); a baseline, not a kernel
  'cuda_fused2' — the hand-written Hopper d=2 kernel
                  (``kernels.tt_contract.tt_fused2[_int8]``)

``plan.weights == 'int8'`` serves stored int8 cores with their per-core
``scales`` (the layout of ``models.layers.quantize_tt_params``); float
cores under an int8 plan are refused, since quantizing is a checkpoint
transform (``Model.quantize_params``), not a per-call step.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.packing import pack_core
from repro_torch.core.quant import dequantize_cores
from repro_torch.core.tt import tt_apply
from .plan import TTExecutionPlan, chain_signature, resolve_plan
from .tt_contract import tt_fused2, tt_fused2_int8


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
    their per-core ``scales`` (core order).
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
        if cores[t].shape[3] != cores[t + 1].shape[0]:
            raise ValueError(
                f"TT rank mismatch between cores {t} and {t + 1}: "
                f"r={cores[t].shape[3]} vs r={cores[t + 1].shape[0]}")
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
    else:
        raise ValueError(f"plan resolved to unknown backend {plan.backend!r}")
    if bias is not None:
        y = y + bias
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)
