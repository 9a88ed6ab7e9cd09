"""Elementary layers: norms (qk-norm included), RoPE, dense/TT linear,
GLU MLP, embeddings.

Every projection goes through ``linear_spec``/``linear_apply``, which
consult the model's ``TTConfig``: a covered projection gets TT cores picked
by the DSE, the others a dense weight.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import TTConfig
from repro_torch.core.dse import DSEConfig, explore
from repro_torch.core.flops import prod
from repro_torch.core.quant import quantize_core
from repro_torch.core.tt import TTPlan
from repro_torch.kernels.ops import tt_forward
from repro_torch.kernels.plan import PlanBook
from .spec import ParamSpec


# ---------------------------------------------------------------------------
# TT planning (offline, cached — the paper's design-tool step)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plan_for(M: int, N: int, rank: int, length: int, min_factor: int
             ) -> TTPlan | None:
    """The min-FLOPs surviving factorization of ``[N → M]`` at uniform
    rank ``rank``, preferring length ``length`` (``repro.models.layers``'s
    rule, so both packages pick the same shapes)."""
    cfg = DSEConfig(vl=rank, rank_step=rank, rank_cap=rank,
                    min_factor=min_factor, max_d=max(length, 4))
    res = explore(M, N, cfg)
    sol = res.best(length=length, rank=rank) or res.best(rank=rank)
    return sol.plan if sol else None


def _tt_core_specs(plan: TTPlan, dtype) -> dict[str, ParamSpec]:
    """Core specs whose implied dense W has std ≈ sqrt(2/(M+N))."""
    target_std = float(np.sqrt(2.0 / (plan.M + plan.N)))
    rank_prod = prod(plan.ranks[1:-1]) if plan.d > 1 else 1
    sigma = (target_std ** 2 / max(rank_prod, 1)) ** (1.0 / (2 * plan.d))
    return {f"c{t}": ParamSpec(shape, "normal", sigma, dtype)
            for t, shape in enumerate(plan.core_shapes)}


# ---------------------------------------------------------------------------
# Linear (dense or TT) — N in, M out
# ---------------------------------------------------------------------------

def linear_spec(in_dim: int, out_dim: int, tt: TTConfig | None,
                family: str, dtype=torch.float32) -> dict:
    """Spec dict of one projection: TT cores when the TTConfig covers
    ``family`` and the DSE finds a plan, else a dense ``w [in, out]``."""
    if tt is not None and tt.enabled and family in tt.families:
        plan = plan_for(out_dim, in_dim, tt.rank, tt.length, tt.min_factor)
        if plan is not None:
            return {"tt": _tt_core_specs(plan, dtype)}
    return {"w": ParamSpec((in_dim, out_dim), "normal",
                           1.0 / np.sqrt(in_dim), dtype)}


def linear_apply(params: dict, x: torch.Tensor,
                 backend: "PlanBook | str" = "einsum") -> torch.Tensor:
    """Apply one projection (dense weight or TT cores).

    ``backend`` is normally the model's ``PlanBook``: the layer's plan,
    resolved at build time, is looked up by chain signature.  TT storage is
    float cores ``{c0..c{d-1}}`` or the quantized layout ``{c0..c{d-1}
    int8, scales [d] fp32}`` of ``quantize_tt_params``; int8 cores run the
    int8 kernel.  A stack of experts (cores ``[E, r0, n, m, r1]``, scales
    ``[E, d]``, or a dense ``w [E, N, M]``) takes ``x [E, C, N]`` and
    applies expert ``e``'s projection to ``x[e]``: for TT cores one batched
    chain or one launch across all experts (``kernels.ops.tt_forward``)."""
    if "tt" not in params:
        return x @ params["w"]
    tt = params["tt"]
    d = sum(1 for k in tt if k.startswith("c"))
    cores = [tt[f"c{t}"] for t in range(d)]
    scales = tt["scales"] if cores[0].dtype == torch.int8 else None
    if isinstance(backend, PlanBook):
        return tt_forward(cores, x, plan=backend.plan_for_cores(cores),
                          scales=scales)
    return tt_forward(cores, x, backend=backend, scales=scales)


def quantize_tt_params(params):
    """Offline weight quantization of a parameter tree: every TT bundle
    ``{c0..c{d-1}}`` becomes int8 cores + ``scales [*stack, d]`` fp32, each
    core of a stack (the experts axis) on its own scale, as the reference's
    ``quant_nd`` peels every leading stack axis; every other leaf is shared
    with the input tree.  Already quantized bundles are returned as they
    are."""
    def bundle(tt: dict) -> dict:
        if "scales" in tt or tt["c0"].dtype == torch.int8:
            return tt
        d = sum(1 for k in tt if k.startswith("c"))
        out, ss = {}, []
        for t in range(d):
            out[f"c{t}"], s = quantize_core(tt[f"c{t}"])
            ss.append(s)
        out["scales"] = torch.stack(ss, -1).float()
        return out

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        return {k: bundle(v) if k == "tt" else walk(v)
                for k, v in node.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(dim: int, dtype=torch.float32) -> dict:
    return {"scale": ParamSpec((dim,), "ones", dtype=dtype)}


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def head_rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim of [..., heads, head_dim]."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., S, H, hd], positions [..., S] → rotated x (pairwise halves)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs                 # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d: int, ff: int, tt: TTConfig | None, dtype=torch.float32
             ) -> dict:
    return {"gate": linear_spec(d, ff, tt, "ffn", dtype),
            "up": linear_spec(d, ff, tt, "ffn", dtype),
            "down": linear_spec(ff, d, tt, "ffn", dtype)}


def mlp_apply(params: dict, x: torch.Tensor,
              backend: "PlanBook | str" = "einsum") -> torch.Tensor:
    g = linear_apply(params["gate"], x, backend)
    u = linear_apply(params["up"], x, backend)
    return linear_apply(params["down"], F.silu(g) * u, backend)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d: int, dtype=torch.float32) -> dict:
    return {"table": ParamSpec((vocab, d), "normal", 1.0 / np.sqrt(d),
                               dtype)}


def embed_apply(params: dict, tokens: torch.Tensor, d: int,
                scale: bool = False) -> torch.Tensor:
    """The rows of ``tokens``; with ``scale`` (gemma) times sqrt(d) rounded
    to the table's dtype first, as the reference rounds it (in bf16,
    sqrt(2560) = 50.596 becomes 50.5)."""
    out = params["table"][tokens]
    if scale:
        out = out * _rounded(float(np.sqrt(d)), out.dtype)
    return out


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to the nearest value of the float ``dtype`` (ties to
    even), on the host without a tensor op, so a captured step neither
    copies to the card nor reads back."""
    bits = 1 - round(math.log2(torch.finfo(dtype).eps))
    m, e = math.frexp(x)
    return math.ldexp(round(m * 2 ** bits), e - bits)
