"""Mamba-2 (SSD, state-space duality) block.

The reference's ``models/ssm.py``, with its arithmetic: the prefill is the
chunked SSD (quadratic within chunks of at most ``SSMConfig.chunk``
steps, a linear recurrence across them), the decode the O(1) recurrent
update of a per-slot state ``[B, H, N, P]`` held in fp32 whatever the
parameters' dtype.  The in/out projections go through ``linear_spec`` /
``linear_apply`` (TT cores on the ``ffn`` family, the fused2 kernel on a
card); the scan, the causal conv and the recurrent update are plain torch,
as they are plain ``jnp`` in the reference.

With bf16 parameters the elementwise chains around the scan (the causal
conv with its bias and SiLU, ``y + x·D`` and the gate ``y·silu(z)`` into
the norm) run in fp32 and round once at their end, as a compiler that
fuses them keeps them (XLA's excess precision); the roundings the
reference writes out are kept: the scan's ``y`` in the activation dtype
before ``+ x·D`` at prefill, after it at decode.  A random-weight
full-width model carries each rounding on through its layers, so two
groupings of one prompt differ by more than a few bf16 ulps of a logit
(``PERF.md`` §6).

Two places differ in form, not in value: the intra-chunk sum
(``einsum("bclhn,bcshn,bchls,bcshp->bclhp")`` there) is taken in explicit
steps, ``C·Bᵀ`` per group, times the decay matrix, then ``@ (x·dt)``, so
that every machine contracts in one order and no 5-D outer product is
made; and the inter-chunk ``lax.scan`` is a Python loop over the chunks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import linear_apply, linear_spec, rmsnorm_apply, rmsnorm_spec
from .spec import ParamSpec


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, conv_dim) of the config's SSM block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, heads, conv_dim


def ssm_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, heads, conv_dim = ssm_dims(cfg)
    in_dim = 2 * d_inner + 2 * s.n_groups * s.d_state + heads
    return {
        "in_proj": linear_spec(d, in_dim, cfg.tt, "ffn", dtype),
        "conv_w": ParamSpec((s.d_conv, conv_dim), "normal",
                            1.0 / np.sqrt(s.d_conv), dtype),
        "conv_b": ParamSpec((conv_dim,), "zeros", dtype=dtype),
        "A_log": ParamSpec((heads,), "zeros", dtype=dtype),
        "D": ParamSpec((heads,), "ones", dtype=dtype),
        "dt_bias": ParamSpec((heads,), "zeros", dtype=dtype),
        "norm": rmsnorm_spec(d_inner, dtype),
        "out_proj": linear_spec(d_inner, d, cfg.tt, "ffn", dtype),
    }


def _split_in(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """z, x, B, C, dt of the in-projection's output, along its last axis."""
    s = cfg.ssm
    d_inner, heads, _ = ssm_dims(cfg)
    gN = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gN, gN, heads], -1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] → lower-triangular cumulative sums S[i,j] = Σ_{j<k≤i} a_k
    (-inf above the diagonal)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, G, N] → [B, G·rep, N], head h taking group h // rep (the
    reference's ``jnp.repeat`` along the group axis)."""
    B, G, N = t.shape
    return t[:, :, None].expand(B, G, rep, N).reshape(B, G * rep, N)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, s0=None,
                acc=torch.float32):
    """Chunked SSD scan, accumulated in ``acc``.

    x [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative), Bm/Cm
    [B,S,G,N] with G dividing H.  ``s0`` (optional [B,H,N,P]) seeds the
    inter-chunk recurrence: running a sequence in pieces with the carried
    state is the same math as one pass, summed in another order (chunked
    prefill).  The chunk length L is the largest divisor of S that is at
    most ``chunk`` (a prime S at a smaller chunk gives L = 1).  The decays
    within a chunk are differences of its cumulative log-decays, as the
    reference takes them, so in fp32 their rounding grows with L.
    Returns y [B,S,H,P] in x's dtype and the final state [B,H,N,P]
    fp32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    while S % L:
        L -= 1
    nc = S // L
    xc = x.reshape(Bsz, nc, L, H, P).to(acc)
    dtc = dt.reshape(Bsz, nc, L, H).to(acc)
    # [B,nc,G,L,N]: each group once, broadcast over its ``rep`` heads (head
    # h takes group h // rep, the reference's ``jnp.repeat``)
    Bg = Bm.reshape(Bsz, nc, L, G, N).to(acc).permute(0, 1, 3, 2, 4)
    Cg = Cm.reshape(Bsz, nc, L, G, N).to(acc).permute(0, 1, 3, 2, 4)
    a_t = (dtc * A.to(acc)).permute(0, 1, 3, 2)          # [B,nc,H,L]
    a_cum = torch.cumsum(a_t, -1)                        # Σ_{k≤l}
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)   # [B,nc,H,L,P]

    def grouped(t):                                      # [B,nc,H,...]
        return t.reshape(Bsz, nc, G, rep, *t.shape[3:])

    # intra-chunk (quadratic within L): C·Bᵀ per group, times the decay
    # matrix of each of its heads, @ (x·dt)
    CB = (Cg @ Bg.transpose(-1, -2))[:, :, :, None]      # [B,nc,G,1,L,L]
    Lmat = torch.exp(_segsum(a_t))                       # [B,nc,H,L,L]
    y = (grouped(Lmat) * CB).reshape(Bsz, nc, H, L, L) @ xdt

    # each chunk's state, then the recurrence across chunks
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)    # [B,nc,H,L]
    states = (Bg.transpose(-1, -2)[:, :, :, None] @ grouped(
        xdt * decay_to_end[..., None])).reshape(Bsz, nc, H, N, P)
    chunk_decay = torch.exp(a_cum[..., -1])              # [B,nc,H]
    s = (torch.zeros((Bsz, H, N, P), dtype=acc, device=x.device)
         if s0 is None else s0.to(acc))
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, 1)                      # [B,nc,H,N,P]

    y_inter = (Cg[:, :, :, None] @ grouped(s_prevs)).reshape(
        Bsz, nc, H, L, P)
    y = y + y_inter * torch.exp(a_cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    return y.to(x.dtype), s.float()


def ssm_forward(p, cfg: ModelConfig, x, backend="einsum", true_len=None,
                s0=None, conv_hist=None):
    """Full-sequence forward.  x [B,S,d] → (y [B,S,d], final state
    [B,H,N,P] fp32, conv tail [B, K-1, conv_dim]).

    The conv tail is the last K-1 pre-conv inputs, where the decode's
    conv history starts.  ``true_len`` (optional 0-d integer tensor on the
    device) marks positions >= true_len as right-padding: their ``dt`` is
    0, which makes them no-ops on the state, and the tail is the K-1 rows
    of the left-padded inputs that start at ``true_len``, taken on the
    device, so the prefill reads nothing on the host and can be captured.
    ``s0`` [B,H,N,P] and ``conv_hist`` [B,K-1,conv_dim] resume a suffix
    from a carried state and conv history (chunked prefill)."""
    s = cfg.ssm
    d_inner, heads, _ = ssm_dims(cfg)
    zxbcdt = linear_apply(p["in_proj"], x, backend)
    z, xc, Bc, Cc, dt = _split_in(cfg, zxbcdt)
    pre = torch.cat([xc, Bc, Cc], -1)                    # [B,S,conv_dim]
    K = s.d_conv
    if conv_hist is not None:
        full = torch.cat([conv_hist.to(pre.dtype), pre], 1)
    else:
        full = F.pad(pre, (0, 0, K - 1, 0))
    Sx = pre.shape[1]
    if true_len is not None:
        conv_tail = full.index_select(1, true_len.long() + torch.arange(
            K - 1, device=full.device))
    else:
        conv_tail = full[:, Sx:]
    out = sum(full[:, i:i + Sx, :].float() * p["conv_w"][i].float()
              for i in range(K))
    xbc = F.silu(out + p["conv_b"].float()).to(pre.dtype)
    xc, Bc, Cc = torch.split(
        xbc, [d_inner, s.n_groups * s.d_state, s.n_groups * s.d_state], -1)
    B_, S, _ = x.shape
    xh = xc.reshape(B_, S, heads, s.head_dim)
    dt_ = F.softplus(dt.float() + p["dt_bias"])
    if true_len is not None:
        pad_ok = (torch.arange(S, device=x.device) < true_len)[None, :, None]
        dt_ = torch.where(pad_ok, dt_, 0.0)
    A = -torch.exp(p["A_log"].float())
    Bm = Bc.reshape(B_, S, s.n_groups, s.d_state)
    Cm = Cc.reshape(B_, S, s.n_groups, s.d_state)
    y, state = ssd_chunked(xh, dt_, A, Bm, Cm, s.chunk, s0=s0,
                           acc=getattr(torch, s.scan_dtype))
    y = y.float() + xh.float() * p["D"][:, None].float()
    y = y.reshape(B_, S, d_inner)
    y = rmsnorm_apply(p["norm"], y * F.silu(z.float()),
                      cfg.norm_eps).to(x.dtype)
    return linear_apply(p["out_proj"], y, backend), state, conv_tail


def ssm_decode(p, cfg: ModelConfig, x, ssm_state, conv_state,
               backend="einsum", active=None):
    """One-token decode, IN PLACE.  x [B,1,d]; ``ssm_state`` [B,H,N,P]
    fp32 and ``conv_state`` [B,K-1,conv_dim] (the last K-1 pre-conv
    inputs) are updated in place; with ``active`` ([B] bool on the
    device) a row it leaves out keeps both bit for bit.  Returns (y
    [B,1,d], ssm_state, conv_state)."""
    s = cfg.ssm
    d_inner, heads, _ = ssm_dims(cfg)
    B_ = x.shape[0]
    zxbcdt = linear_apply(p["in_proj"], x, backend)
    z, xc, Bc, Cc, dt = _split_in(cfg, zxbcdt)
    xbc_new = torch.cat([xc, Bc, Cc], -1)                # [B,1,conv_dim]
    hist = torch.cat([conv_state, xbc_new], 1)           # [B,K,conv_dim]
    out = (hist.float() * p["conv_w"].float()).sum(1) + p["conv_b"].float()
    xbc = F.silu(out).to(hist.dtype)
    xc, Bc, Cc = torch.split(
        xbc, [d_inner, s.n_groups * s.d_state, s.n_groups * s.d_state], -1)
    xh = xc.reshape(B_, heads, s.head_dim).float()
    dt_ = F.softplus(dt[:, 0].float() + p["dt_bias"])    # [B,H]
    A = -torch.exp(p["A_log"].float())
    rep = heads // s.n_groups
    Bm = _heads(Bc.reshape(B_, s.n_groups, s.d_state), rep).float()
    Cm = _heads(Cc.reshape(B_, s.n_groups, s.d_state), rep).float()
    dA = torch.exp(dt_ * A)                              # [B,H]
    dBx = Bm[..., :, None] * (xh * dt_[..., None])[..., None, :]
    new_state = ssm_state * dA[..., None, None] + dBx
    y = (Cm[..., None, :] @ new_state)[..., 0, :]        # [B,H,P]
    new_conv = hist[:, 1:]
    if active is not None:
        new_state = torch.where(active[:, None, None, None], new_state,
                                ssm_state)
        new_conv = torch.where(active[:, None, None], new_conv, conv_state)
    ssm_state.copy_(new_state)
    conv_state.copy_(new_conv)
    y = y + xh * p["D"][:, None]
    y = y.reshape(B_, 1, d_inner).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y.float() * F.silu(z.float()),
                      cfg.norm_eps).to(x.dtype)
    return linear_apply(p["out_proj"], y, backend), ssm_state, conv_state
