"""Grouped-query attention for the dense decoder, in plain torch.

Every projection routes through ``linear_spec``/``linear_apply``, so the TT
technique applies to q/k/v/o ("attn" family).  Scores and the softmax are
fp32, as in ``repro.models.attention``.

Cache contract: k, v [B, S_max, KV, hd]; decode writes the new position
in place.
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


def gqa_decode_attn(p, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                    backend="einsum"):
    """One-token decode against a full cache at the scalar position
    ``pos`` shared by the whole batch.

    x [B,1,d]; cache_k/v [B, T, KV, hd].  The new k/v are written into the
    cache IN PLACE at ``pos`` (the reference returns an updated copy).
    Returns (y [B,1,d], cache_k, cache_v).
    """
    B, T = x.shape[0], cache_k.shape[1]
    if not 0 <= pos < T:
        raise ValueError(f"decode position {pos} outside the cache of {T}")
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions, backend)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    valid = torch.arange(T, device=x.device) <= pos
    ctx = _gqa_scores_ctx(q, cache_k, cache_v, valid,
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), cache_k, cache_v
