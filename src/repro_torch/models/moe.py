"""Mixture-of-experts FFN with capacity-based dispatch (GShard-style): the
global ``moe_apply`` of ``repro.models.moe`` (the expert-parallel
``moe_apply_ep`` comes with the multi-device work, ROADMAP Queue 1 item
10).

Each token's router picks its top-k experts; every expert takes at most
``C`` assignments, in token-major order, and the rest are dropped.  The
experts' GLU MLPs are one stack (a leading experts axis on every weight),
so a TT expert projection is one batched chain or one launch of the
expert-batched fused2 kernel across all experts
(``models.layers.linear_apply``).

What a captured CUDA graph needs (``models.graph``) shapes the code: no
boolean indexing, no host read and no shape that depends on the data.  An
overflowing assignment is scattered into an extra row ``C`` of the
dispatch buffer, which is sliced off; the gather back clamps and zeroes
it.  The combine sums each token's k weighted expert outputs in a fixed
order (no atomics), so the bits do not change from run to run.

Drops are counted on the device (``drop_counter``): every ``moe_apply``
adds its assignments past ``C``, a captured step included, and the count
is read on the host once, after a run (``read_drops``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from .layers import mlp_apply, mlp_spec
from .spec import ParamSpec, map_tree

# assignments dropped past the capacity, one int64 counter per device,
# made before any capture (``Model`` makes its device's) and reset in place
DROPS: dict[torch.device, torch.Tensor] = {}


def drop_counter(device: str | torch.device) -> torch.Tensor:
    """The device's running count of dropped assignments (0-d int64 on the
    device), made at the first call for the device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in DROPS:
        DROPS[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return DROPS[dev]


def reset_drops() -> None:
    """Set every device's drop count to 0, in place (a captured graph keeps
    adding to the same tensor)."""
    for t in DROPS.values():
        t.zero_()


def read_drops() -> int:
    """Dropped assignments since the last ``reset_drops``, over every
    device: one host read per device."""
    return sum(int(t) for t in DROPS.values())


def moe_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The router ``[d, E]`` and the expert GLU MLPs stacked on a leading
    experts axis (TT cores ``[E, r0, n, m, r1]`` where the TTConfig covers
    ``ffn``); with shared experts, their MLP of ``shared_ff · num_shared``."""
    m = cfg.moe
    d = cfg.d_model
    expert = mlp_spec(d, m.expert_ff, cfg.tt, dtype)
    experts = map_tree(lambda s: dataclasses.replace(
        s, shape=(m.num_experts,) + s.shape), expert)
    out = {"router": ParamSpec((d, m.num_experts), "normal",
                               1.0 / np.sqrt(d), dtype),
           "experts": experts}
    if m.num_shared:
        out["shared"] = mlp_spec(d, m.shared_ff * m.num_shared, cfg.tt,
                                 dtype)
    return out


def capacity(m: MoEConfig, T: int) -> int:
    """Assignments each expert takes from a call of ``T`` tokens:
    ceil(k·T/E·cf), rounded up to a multiple of 128 from T = 128 on, and
    at least 8 (the reference's rule, in the same float arithmetic)."""
    C = int(math.ceil(m.top_k * T / m.num_experts * m.capacity_factor))
    return max(-(-C // 128) * 128, 8) if T >= 128 else max(C, 8)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order on ties): a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch_positions(e_flat: torch.Tensor, num_experts: int
                       ) -> torch.Tensor:
    """Position of each assignment within its expert's buffer, in flat
    (token-major) order: a stable sort by expert keeps the flat order
    within each expert, so ``index in the sorted order − the expert's
    first index`` is the position.  int32, as the reference's."""
    Tk = e_flat.shape[0]
    e_sorted, order = torch.sort(e_flat, stable=True)
    seg_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=e_flat.device,
                               dtype=e_sorted.dtype))
    pos_sorted = torch.arange(Tk, device=e_flat.device) - seg_start[e_sorted]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted).to(
        torch.int32)


def route(p, cfg: ModelConfig, xt: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The router of ``xt [T, d]``: (renormalised gates [T, k] fp32, expert
    indices [T, k]).  Logits in the parameters' dtype, softmax in fp32."""
    logits = xt @ p["router"]                                   # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gate, eidx = top_k(probs, cfg.moe.top_k)
    return gate / gate.sum(-1, keepdim=True), eidx


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, backend="einsum"
              ) -> torch.Tensor:
    """``x [B, S, d]`` → ``[B, S, d]``: the B·S tokens of this call route
    to their top-k experts, at most ``capacity(B·S)`` assignments an
    expert (token-major priority; the rest dropped and counted), the
    expert MLPs run as one stack, and each token sums its gated outputs,
    plus the shared experts' MLP when the config has them.  A caller must
    hand in the reference's token set: the capacity depends on it."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    xt = x.reshape(T, d)
    gate, eidx = route(p, cfg, xt)

    C = capacity(m, T)
    e_flat = eidx.reshape(-1)
    pos = dispatch_positions(e_flat, E).long()                  # [T·k]
    keep = pos < C
    drop_counter(x.device).add_((~keep).sum())
    # an overflowing assignment writes row C, which is sliced off
    pos = torch.where(keep, pos, C)
    buf = x.new_zeros((E, C + 1, d))
    buf[e_flat, pos] = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    ys = mlp_apply(p["experts"], buf[:, :C], backend)           # [E, C, d]

    y_tok = ys[e_flat, pos.clamp(max=C - 1)]                    # [T·k, d]
    y_tok = torch.where(keep[:, None], y_tok, y_tok.new_zeros(()))
    w = (y_tok * gate.reshape(-1, 1).to(y_tok.dtype)).reshape(T, k, d)
    y = w[:, 0]
    for j in range(1, k):                     # fixed order: deterministic
        y = y + w[:, j]
    if m.num_shared:
        y = y + mlp_apply(p["shared"], xt, backend)
    return y.reshape(B, S, d)
