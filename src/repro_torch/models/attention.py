"""Grouped-query attention for the dense decoder, in plain torch.

Every projection routes through ``linear_spec``/``linear_apply``, so the TT
technique applies to q/k/v/o ("attn" family).  Scores and the softmax are
fp32, as in ``repro.models.attention``.

Cache contract: k, v [B, S_max, KV, hd]; decode writes the new position
in place, at a position held on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import linear_apply, linear_spec, rope

NEG_INF = -1e30


def gqa_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"q": linear_spec(d, q_dim, cfg.tt, "attn", dtype),
            "k": linear_spec(d, kv_dim, cfg.tt, "attn", dtype),
            "v": linear_spec(d, kv_dim, cfg.tt, "attn", dtype),
            "o": linear_spec(q_dim, d, cfg.tt, "attn", dtype)}


def _qkv(p, cfg: ModelConfig, x, positions, backend):
    """(q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd]) with RoPE applied."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear_apply(p["q"], x, backend).reshape(B, S, H, hd)
    k = linear_apply(p["k"], x, backend).reshape(B, S, KV, hd)
    v = linear_apply(p["v"], x, backend).reshape(B, S, KV, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _gqa_scores_ctx(q, k, v, mask, scale):
    """q [B,S,H,hd], k/v [B,T,KV,hd], mask broadcastable to [B,KV,G,S,T];
    fp32 scores and softmax, context cast back to q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return ctx.reshape(B, S, H * hd).to(q.dtype)


def gqa_self_attn(p, cfg: ModelConfig, x, positions, *, backend="einsum"):
    """Causal full-sequence self-attention (prefill).  Returns
    (y [B,S,d], (k, v)) with k/v [B,S,KV,hd] for the cache."""
    q, k, v = _qkv(p, cfg, x, positions, backend)
    mask = positions[:, None, :] <= positions[:, :, None]     # [B,S,T]
    ctx = _gqa_scores_ctx(q, k, v, mask[:, None, None],
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), (k, v)


def gqa_decode_attn(p, cfg: ModelConfig, x, cache_k, cache_v,
                    pos: torch.Tensor, *, backend="einsum", active=None):
    """One-token decode against a full cache.

    x [B,1,d]; cache_k/v [B, T, KV, hd]; ``pos`` an integer tensor on the
    cache's device: 0-d, the position shared by the whole batch, or [B],
    one depth per row (the reference's per-slot branch; a row at a
    position ≥ T writes nothing).  ``active`` (optional [B] bool on the
    device, vector position only) gates each row's write: an inactive
    slot of the scheduler's pool keeps its k/v.  The new k/v are written
    into the cache IN PLACE (the reference returns an updated copy).
    Nothing here reads a device value on the host, so the step can be
    captured in a CUDA graph and replayed at every position; a scalar
    position outside the cache is refused by the caller that holds it on
    the host (``serving.engine.generate_fixed``,
    ``models.graph.DecodeGraph``).
    Returns (y [B,1,d], cache_k, cache_v).
    """
    B, T = x.shape[0], cache_k.shape[1]
    per_row = pos.dim() == 1
    if active is not None and not per_row:
        raise ValueError("an active mask needs a per-row position [B]")
    positions = pos[:, None] if per_row else pos.reshape(1, 1).expand(B, 1)
    q, k, v = _qkv(p, cfg, x, positions, backend)
    idx = torch.arange(T, device=x.device)
    if per_row:
        wr = (idx[None, :] == pos[:, None])[:, :, None, None]    # [B,T,1,1]
        if active is not None:
            wr = wr & active[:, None, None, None]
        torch.where(wr, k, cache_k, out=cache_k)
        torch.where(wr, v, cache_v, out=cache_v)
        valid = (idx[None, :] <= pos[:, None])[:, None, None, None, :]
    else:
        at = pos.reshape(1).long()
        cache_k.index_copy_(1, at, k)
        cache_v.index_copy_(1, at, v)
        valid = idx <= pos
    ctx = _gqa_scores_ctx(q, cache_k, cache_v, valid,
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), cache_k, cache_v
