"""Grouped-query attention (qk-norm, sliding windows and the non-causal
encoder included), the decoder's cross-attention over an encoder's
output (no RoPE, every frame attended), and multi-head latent attention
(MLA, deepseek-v2), in plain torch.

Every projection routes through ``linear_spec``/``linear_apply``, so the TT
technique applies to q/k/v/o ("attn" family).  MLA's ``kv_down`` and
``kv_up`` stay dense: MLA is itself a low-rank factorization of the KV
path, so TT composes with it on q/o only.  Scores and the softmax are
fp32, as in ``repro.models.attention``.

Cache contract: full attention keeps k, v [B, S_max, KV, hd] and decode
writes position ``pos``; a sliding-window layer keeps a ring [B, W, KV, hd]
(W = min(window, S_max)) and writes ``pos % W``, slot s holding the latest
absolute position p <= pos with p % W == s.  Decode writes in place, at a
position held on the device.  The block-paged pool (DESIGN.md §7) holds
one arena per layer and leaf, [num_blocks + 1, block, KV, hd], addressed
through per-slot block tables; its last block is the write sentinel, and a
ring uses the low ceil(W / block) entries of its slot's table.  The paged
decode and the resume prefill gather the logical cache ``arena[table]``
and run the dense pool's arithmetic on it.  MLA keeps the latent cache
instead: ckv [B, S_max, kv_lora] and krope [B, S_max, rope_hd] (arenas
[num_blocks + 1, block, kv_lora | rope_hd]), full attention only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .layers import (head_rmsnorm_apply, linear_apply, linear_spec,
                     rmsnorm_apply, rmsnorm_spec, rope)
from .spec import ParamSpec

NEG_INF = -1e30


def gqa_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {"q": linear_spec(d, q_dim, cfg.tt, "attn", dtype),
           "k": linear_spec(d, kv_dim, cfg.tt, "attn", dtype),
           "v": linear_spec(d, kv_dim, cfg.tt, "attn", dtype),
           "o": linear_spec(q_dim, d, cfg.tt, "attn", dtype)}
    if cfg.qk_norm:
        out["q_norm"] = ParamSpec((cfg.head_dim,), "ones", dtype=dtype)
        out["k_norm"] = ParamSpec((cfg.head_dim,), "ones", dtype=dtype)
    return out


def _qkv(p, cfg: ModelConfig, x, positions, theta, backend):
    """(q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd]): qk-norm when the
    config has it, then RoPE at ``theta`` (None: ``cfg.rope_theta``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    theta = cfg.rope_theta if theta is None else theta
    q = linear_apply(p["q"], x, backend).reshape(B, S, H, hd)
    k = linear_apply(p["k"], x, backend).reshape(B, S, KV, hd)
    v = linear_apply(p["v"], x, backend).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = head_rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    return rope(q, positions, theta), rope(k, positions, theta), v


def ring_positions(last: torch.Tensor, W: int) -> torch.Tensor:
    """The absolute position each slot of a ring of ``W`` holds once
    position ``last`` is written: slot s holds the latest p <= last with
    p % W == s, that is last - ((last - s) mod W), negative where there is
    none.  ``last`` 0-d → [W]; [B] → [B, W]."""
    idx = torch.arange(W, dtype=last.dtype, device=last.device)
    p = last[..., None] if last.dim() else last
    return p - torch.remainder(p - idx, W)


def _gqa_scores_ctx(q, k, v, mask, scale):
    """q [B,S,H,hd], k/v [B,T,KV,hd], mask broadcastable to [B,KV,G,S,T]
    (None: every key, the reference's all-ones mask); fp32 scores and
    softmax, context cast back to q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return ctx.reshape(B, S, H * hd).to(q.dtype)


def gqa_self_attn(p, cfg: ModelConfig, x, positions, *, window: int = 0,
                  theta: float | None = None, backend="einsum",
                  causal: bool = True):
    """Full-sequence self-attention (prefill), causal, within the last
    ``window`` positions when it is > 0; with ``causal=False`` every
    position attends to every other (an encoder's).  Returns (y [B,S,d],
    (k, v)) with k/v [B,S,KV,hd] for the cache."""
    q, k, v = _qkv(p, cfg, x, positions, theta, backend)
    mask = None
    if causal:
        i, j = positions[:, :, None], positions[:, None, :]
        mask = j <= i                                         # [B,S,T]
        if window:
            mask = mask & (j > i - window)
        mask = mask[:, None, None]
    ctx = _gqa_scores_ctx(q, k, v, mask, 1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), (k, v)


# ---------------------------------------------------------------------------
# Cross-attention (the decoder of an encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attn_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """q/k/v/o of the decoder's cross-attention, GQA's spec (TT "attn")."""
    return gqa_spec(cfg, dtype)


def cross_kv(p, cfg: ModelConfig, enc_out, backend="einsum"):
    """The encoder output ``enc_out [B,F,d]`` projected to the keys and
    values every decoder step attends to, k/v [B,F,KV,hd], with no RoPE."""
    B, F, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    k = linear_apply(p["k"], enc_out, backend).reshape(B, F, KV, hd)
    v = linear_apply(p["v"], enc_out, backend).reshape(B, F, KV, hd)
    return k, v


def cross_attn(p, cfg: ModelConfig, x, enc_k, enc_v, backend="einsum"):
    """x [B,S,d] attends to the encoder keys and values ``enc_k``/``enc_v``
    [B,F,KV,hd] (``cross_kv``), every frame to every query: q with no
    RoPE, fp32 scores and softmax.  Returns y [B,S,d]."""
    B, S, _ = x.shape
    q = linear_apply(p["q"], x, backend).reshape(B, S, cfg.num_heads,
                                                 cfg.head_dim)
    ctx = _gqa_scores_ctx(q, enc_k, enc_v, None,
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend)


def gqa_decode_attn(p, cfg: ModelConfig, x, cache_k, cache_v,
                    pos: torch.Tensor, *, window: int = 0,
                    theta: float | None = None, backend="einsum",
                    active=None):
    """One-token decode against a full or (``window`` > 0) ring cache.

    x [B,1,d]; cache_k/v [B, T, KV, hd], T the cache length or the ring's
    W; ``pos`` an integer tensor on the cache's device: 0-d, the position
    shared by the whole batch, or [B], one depth per row (the reference's
    per-slot branch; a full-attention row at a position ≥ T writes
    nothing).  A ring writes slot ``pos % W`` and attends to the slots
    that hold a position (``ring_positions``).  ``active`` (optional [B]
    bool on the device, vector position only) gates each row's write: an
    inactive slot of the scheduler's pool keeps its k/v.  The new k/v are written
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
    q, k, v = _qkv(p, cfg, x, positions, theta, backend)
    idx = torch.arange(T, device=x.device)
    slot = torch.remainder(pos, T) if window else pos
    valid = ring_positions(pos, T) >= 0 if window else (
        idx <= (pos[:, None] if per_row else pos))
    if per_row:
        wr = (idx[None, :] == slot[:, None])[:, :, None, None]   # [B,T,1,1]
        if active is not None:
            wr = wr & active[:, None, None, None]
        torch.where(wr, k, cache_k, out=cache_k)
        torch.where(wr, v, cache_v, out=cache_v)
        valid = valid[:, None, None, None, :]
    else:
        at = slot.reshape(1).long()
        cache_k.index_copy_(1, at, k)
        cache_v.index_copy_(1, at, v)
    ctx = _gqa_scores_ctx(q, cache_k, cache_v, valid,
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), cache_k, cache_v


# ---------------------------------------------------------------------------
# Paged decode: block-table gather/scatter against a block arena
# ---------------------------------------------------------------------------
#
# Logical token t of slot b lives at (bt[b, t // block], t % block); the
# last arena block is the write sentinel: inactive slots write there, so a
# retired slot's stale table never touches storage another request reuses.
# What the layers read of the tables is computed once per step
# (``paged_index``): in a captured step each op is a node of the graph.

class PagedIndex(NamedTuple):
    """What every layer's paged decode of one kind reads of the block
    tables, the same for all such layers of a step (``paged_index``): the
    gather index ``table`` [B, blocks read] int64, each row's write address
    ``write`` = (block, offset) [B] int64, and the attention mask ``valid``
    [B,1,1,1,W] over the first W gathered positions."""
    table: torch.Tensor
    write: tuple[torch.Tensor, torch.Tensor]
    valid: torch.Tensor


def paged_index(bt, pos: torch.Tensor, active: torch.Tensor, block: int,
                sentinel: int, window: int = 0) -> PagedIndex:
    """The ``PagedIndex`` of one decode step: bt [B, max_blocks] int32, pos
    [B] int32, active [B] bool, on the cache's device.

    Full attention (``window`` 0): an active row writes at (bt[b, pos //
    block], pos % block), an inactive one into the ``sentinel`` block
    (whatever its position: a row parked past its table clamps to its last
    entry first); every row attends to its logical positions ≤ pos.
    A ring (``window`` > 0, W = min(window, max_blocks · block)): the
    same through the table's low ceil(W / block) entries at the ring slot
    pos % W, attending to the slots that hold a position.
    Computed once per step and kind, and read by every layer of that kind:
    the reference computes it in each layer, to the same values."""
    mb = bt.shape[1]
    W = min(window, mb * block) if window else mb * block
    nblk = -(-W // block)
    table = bt[:, :nblk].long()
    wp = torch.remainder(pos, W) if window else pos
    col = torch.clamp(wp // block, max=nblk - 1).long()
    phys = torch.where(active, table.gather(1, col[:, None])[:, 0], sentinel)
    if window:
        valid = ring_positions(pos, W) >= 0
    else:
        valid = torch.arange(W, device=bt.device)[None, :] <= pos[:, None]
    return PagedIndex(table, (phys, (wp % block).long()),
                      valid[:, None, None, None, :])


def gqa_decode_attn_paged(p, cfg: ModelConfig, x, arena_k, arena_v,
                          pos: torch.Tensor, index: PagedIndex, *,
                          theta: float | None = None, backend="einsum"):
    """One-token decode against a block-paged cache, full attention or a
    ring (as ``index`` was made, ``paged_index``).

    x [B,1,d]; arena_k/v [nb+1, block, KV, hd]; pos [B] int32 on the
    cache's device; ``index`` the step's ``paged_index`` of the block
    tables for this layer's kind.  Each row's new k/v go to its write
    address (an inactive row's to the sentinel block), IN PLACE (the
    reference returns updated arenas); every row then attends over the
    first W positions of its gathered cache ``arena[table[b]]`` with the
    dense pool's mask and arithmetic.  Nothing is read on the host, so the
    step can be captured.  Returns (y [B,1,d], arena_k, arena_v)."""
    B = x.shape[0]
    KV, hd = arena_k.shape[2:]
    W = index.valid.shape[-1]
    q, k, v = _qkv(p, cfg, x, pos[:, None], theta, backend)
    arena_k.index_put_(index.write, k[:, 0])
    arena_v.index_put_(index.write, v[:, 0])
    gk = arena_k[index.table].reshape(B, -1, KV, hd)[:, :W]
    gv = arena_v[index.table].reshape(B, -1, KV, hd)[:, :W]
    ctx = _gqa_scores_ctx(q, gk, gv, index.valid,
                          1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), arena_k, arena_v


# ---------------------------------------------------------------------------
# Resume prefill: suffix attention over gathered prefix blocks (COW write)
# ---------------------------------------------------------------------------
#
# The prefix-reuse admission: the logical cache is gathered densely through
# the *source* table, the suffix k/v are written into that buffer at their
# absolute positions, and the buffer is scattered back through the
# *destination* table.  A destination entry that differs from its source
# entry IS the copy-on-write: content flows old block → dense buffer → new
# block, with the overwritten rows replaced in between.  Identical entries
# rewrite shared blocks with the bits they hold.

def _resume_dense(arena, src_b, S_pad: int):
    """The logical cache [1, max_blocks · block + S_pad, ...] gathered
    through ``src_b`` [max_blocks], with ``S_pad`` scratch rows appended so
    the suffix's write at ``start`` < max_blocks · block stays in range."""
    mb, blk = src_b.shape[0], arena.shape[1]
    dense = arena[src_b].reshape(1, mb * blk, *arena.shape[2:])
    pad = torch.zeros((1, S_pad, *arena.shape[2:]), dtype=arena.dtype,
                      device=arena.device)
    return torch.cat([dense, pad], 1)


def _resume_scatter(arena, dst_b, dense) -> None:
    """Scatter the first max_blocks · block rows of ``dense`` back through
    ``dst_b`` IN PLACE (sentinel-padded entries collapse onto the scratch
    block)."""
    mb, blk = dst_b.shape[0], arena.shape[1]
    blocks = dense[0, :mb * blk].reshape(mb, blk, *arena.shape[2:])
    arena.index_put_((dst_b.long(),), blocks.to(arena.dtype))


def gqa_chunk_attn(p, cfg: ModelConfig, x, dk, dv, start: torch.Tensor, *,
                   theta: float | None = None, backend="einsum"):
    """Chunk or suffix prefill against a *dense logical* cache buffer.

    x [1, S_pad, d] at absolute positions start + t (``start`` a 0-d int32
    tensor on the device); dk/dv [1, T + S_pad, KV, hd], the logical cache
    with S_pad scratch rows.  Writes the chunk's k/v at their absolute
    positions (in place) and attends causally to prefix + itself.  Full
    attention only.  Returns (y, dk, dv)."""
    S_pad = x.shape[1]
    positions = start + torch.arange(S_pad, dtype=torch.int32,
                                     device=x.device)[None, :]  # [1, S_pad]
    q, k, v = _qkv(p, cfg, x, positions, theta, backend)
    rows = positions[0].long()
    dk.index_copy_(1, rows, k.to(dk.dtype))
    dv.index_copy_(1, rows, v.to(dv.dtype))
    j = torch.arange(dk.shape[1], device=x.device)[None, None, :]   # [1,1,T]
    mask = (j <= positions[:, :, None])[:, None, None]    # [1,1,1,S,T]
    ctx = _gqa_scores_ctx(q, dk, dv, mask, 1.0 / np.sqrt(cfg.head_dim))
    return linear_apply(p["o"], ctx, backend), dk, dv


def gqa_resume_attn(p, cfg: ModelConfig, x, arena_k, arena_v, src_b, dst_b,
                    start: torch.Tensor, *, theta: float | None = None,
                    backend="einsum"):
    """Suffix prefill (x [1, S_pad, d] at absolute positions start + t)
    attending to the prefix gathered through ``src_b`` and to itself; the
    updated logical cache goes back into the arenas through ``dst_b``, IN
    PLACE.  Full attention only.  Returns (y, arena_k, arena_v)."""
    S_pad = x.shape[1]
    dk = _resume_dense(arena_k, src_b, S_pad)
    dv = _resume_dense(arena_v, src_b, S_pad)
    y, dk, dv = gqa_chunk_attn(p, cfg, x, dk, dv, start, theta=theta,
                               backend=backend)
    _resume_scatter(arena_k, dst_b, dk)
    _resume_scatter(arena_v, dst_b, dv)
    return y, arena_k, arena_v


def gqa_chunk_attn_ring(p, cfg: ModelConfig, x, ring_k, ring_v,
                        start: torch.Tensor, true_len: torch.Tensor, *,
                        theta: float | None = None, backend="einsum"):
    """Chunk prefill of a sliding-window layer against its ring.

    x [1, C, d] at absolute positions start + t (rows >= ``true_len`` are
    right-padding; ``start``, ``true_len`` 0-d int32 on the device);
    ring_k/v [1, W, KV, hd] hold the state before the chunk: slot w the
    k/v of the latest position p <= start - 1 with p % W == w, zeros where
    there is none.  A chunk may span more than W positions, so the ring is
    not written in place (a key still inside an earlier query's window
    would be overwritten): the history is gathered densely in position
    order, the chunk's keys appended, every query attends over absolute
    positions within the window, and the ring is rebuilt for the state
    after position start + true_len - 1 (from the history where that
    position precedes the chunk, where it equals the old ring entry).
    Returns (y, new ring_k, new ring_v), new tensors."""
    C = x.shape[1]
    W = ring_k.shape[1]
    dev = x.device
    chunk = torch.arange(C, dtype=torch.int32, device=dev)
    positions = start + chunk[None, :]                        # [1, C]
    q, k, v = _qkv(p, cfg, x, positions, theta, backend)
    # history entry i is absolute position start - W + i, held at ring
    # slot (start + i) mod W
    i_idx = torch.arange(W, dtype=torch.int32, device=dev)
    hist = torch.remainder(start + i_idx, W).long()
    ck = torch.cat([ring_k.index_select(1, hist), k.to(ring_k.dtype)], 1)
    cv = torch.cat([ring_v.index_select(1, hist), v.to(ring_v.dtype)], 1)
    key_pos = torch.cat([start - W + i_idx, start + chunk])   # [W + C]
    pq = positions[:, :, None]                                # [1, C, 1]
    j = key_pos[None, None, :]                                # [1, 1, W+C]
    mask = ((j <= pq) & (j > pq - W) & (j >= 0))[:, None, None]
    ctx = _gqa_scores_ctx(q, ck, cv, mask, 1.0 / np.sqrt(cfg.head_dim))
    y = linear_apply(p["o"], ctx, backend)
    # slot w <- the position it holds after start + true_len - 1, at index
    # p - start + W of the combined buffer
    p_w = ring_positions(start + true_len - 1, W)
    src = (p_w - start + W).long()
    ok = (p_w >= 0)[None, :, None, None]
    zero = torch.zeros((), dtype=ring_k.dtype, device=dev)
    return (y, torch.where(ok, ck.index_select(1, src), zero),
            torch.where(ok, cv.index_select(1, src), zero))


# ---------------------------------------------------------------------------
# MLA (deepseek-v2 multi-head latent attention)
# ---------------------------------------------------------------------------
#
# Prefill runs the expanded form: kv_up is applied to every position and
# the scores are nope + rope.  Decode, the paged step, the chunk and the
# resume run the absorbed form: q_nope is folded through kv_up's key half
# and the scores and context are taken in the latent space, so a step
# reads O(T · kv_lora) of cache, not O(T · H · head_dim).  The two forms
# agree to rounding, not bit for bit, as in the reference.

def mla_spec(cfg: ModelConfig, dtype=torch.float32) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_head = m.nope_head_dim + m.rope_head_dim
    return {"q": linear_spec(d, H * qk_head, cfg.tt, "attn", dtype),
            # the low-rank KV path: dense by construction
            "kv_down": linear_spec(d, m.kv_lora + m.rope_head_dim, None,
                                   "mla", dtype),
            "kv_norm": rmsnorm_spec(m.kv_lora, dtype),
            "kv_up": linear_spec(m.kv_lora,
                                 H * (m.nope_head_dim + m.v_head_dim), None,
                                 "mla", dtype),
            "o": linear_spec(H * m.v_head_dim, d, cfg.tt, "attn", dtype)}


def _mla_q(p, cfg: ModelConfig, x, positions, backend):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope_hd] rotated)."""
    m = cfg.mla
    B, S, _ = x.shape
    q = linear_apply(p["q"], x, backend).reshape(
        B, S, cfg.num_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], -1)
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_compress(p, cfg: ModelConfig, x, positions, backend):
    """The latent cache entries of ``x``: (ckv [B,S,kv_lora] normed,
    krope [B,S,rope_hd] rotated, one head shared by all)."""
    m = cfg.mla
    c = linear_apply(p["kv_down"], x, backend)
    ckv, krope = c.split([m.kv_lora, m.rope_head_dim], -1)
    ckv = rmsnorm_apply(p["kv_norm"], ckv, cfg.norm_eps)
    krope = rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, krope


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / np.sqrt(cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)


def mla_self_attn(p, cfg: ModelConfig, x, positions, backend="einsum"):
    """Expanded-form causal MLA over the whole prompt (prefill).  Returns
    (y [B,S,d], (ckv [B,S,kv_lora], krope [B,S,rope_hd])) for the cache."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend)
    ckv, krope = _mla_compress(p, cfg, x, positions, backend)
    kv = linear_apply(p["kv_up"], ckv, backend).reshape(
        B, S, cfg.num_heads, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], -1)
    i, j = positions[:, :, None], positions[:, None, :]
    mask = (j <= i)[:, None]                                  # [B,1,S,T]
    s = (torch.einsum("bshn,bthn->bhst", q_nope.float(), k_nope.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), krope.float())
         ) * _mla_scale(cfg)
    probs = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    ctx = torch.einsum("bhst,bthv->bshv", probs, v.float())
    y = linear_apply(p["o"], ctx.reshape(B, S, -1).to(x.dtype), backend)
    return y, (ckv, krope)


def _mla_absorbed_ctx(p, cfg: ModelConfig, q_nope, q_rope, cache_ckv,
                      cache_krope, valid) -> torch.Tensor:
    """Absorbed-form scores and context over a latent cache: q_nope/q_rope
    [B,S,H,·], cache_ckv [B,T,kv_lora], cache_krope [B,T,rope_hd], valid
    broadcastable to [B,H,S,T].  kv_up's weight is read as [kv_lora, H,
    nope + v] (a view of the dense leaf, split into its key and value
    halves).  Returns the context [B, S, H · v_head_dim] in fp32, before
    the o projection."""
    m = cfg.mla
    B, S = q_nope.shape[:2]
    w_up = p["kv_up"]["w"].view(m.kv_lora, cfg.num_heads,
                                m.nope_head_dim + m.v_head_dim)
    w_uk, w_uv = w_up.split([m.nope_head_dim, m.v_head_dim], -1)
    q_eff = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_uk.float())
    ckv = cache_ckv.float()
    s = (torch.einsum("bshl,btl->bhst", q_eff, ckv)
         + torch.einsum("bshr,btr->bhst", q_rope.float(),
                        cache_krope.float())) * _mla_scale(cfg)
    probs = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    ctx_l = torch.einsum("bhst,btl->bshl", probs, ckv)       # latent context
    ctx = torch.einsum("bshl,lhv->bshv", ctx_l, w_uv.float())
    return ctx.reshape(B, S, -1)


def mla_decode_attn(p, cfg: ModelConfig, x, cache_ckv, cache_krope,
                    pos: torch.Tensor, backend="einsum", active=None):
    """Absorbed-form one-token decode against the dense latent cache.

    x [B,1,d]; cache_ckv [B, T, kv_lora], cache_krope [B, T, rope_hd];
    ``pos`` and ``active`` as in ``gqa_decode_attn`` (0-d, or [B] with an
    optional [B] bool write gate; a row at a position ≥ T writes
    nothing).  The new latent entries are written IN PLACE.  Returns
    (y [B,1,d], cache_ckv, cache_krope)."""
    B, T = x.shape[0], cache_ckv.shape[1]
    per_row = pos.dim() == 1
    if active is not None and not per_row:
        raise ValueError("an active mask needs a per-row position [B]")
    positions = pos[:, None] if per_row else pos.reshape(1, 1).expand(B, 1)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend)
    ckv, krope = _mla_compress(p, cfg, x, positions, backend)
    idx = torch.arange(T, device=x.device)
    if per_row:
        wr = (idx[None, :] == pos[:, None])[:, :, None]         # [B,T,1]
        if active is not None:
            wr = wr & active[:, None, None]
        torch.where(wr, ckv, cache_ckv, out=cache_ckv)
        torch.where(wr, krope, cache_krope, out=cache_krope)
        valid = (idx[None, :] <= pos[:, None])[:, None, None, :]  # [B,1,1,T]
    else:
        at = pos.reshape(1).long()
        cache_ckv.index_copy_(1, at, ckv)
        cache_krope.index_copy_(1, at, krope)
        valid = (idx <= pos)[None, None, None, :]
    ctx = _mla_absorbed_ctx(p, cfg, q_nope, q_rope, cache_ckv, cache_krope,
                            valid)
    return (linear_apply(p["o"], ctx.to(x.dtype), backend), cache_ckv,
            cache_krope)


def mla_decode_attn_paged(p, cfg: ModelConfig, x, arena_ckv, arena_kr,
                          pos: torch.Tensor, index: PagedIndex,
                          backend="einsum"):
    """Absorbed-form one-token decode against block-paged latent arenas
    [nb+1, block, kv_lora | rope_hd], through the step's full-attention
    ``paged_index`` (its table and write address; its mask [B,1,1,1,T]
    read as [B,1,1,T]).  Writes IN PLACE, as
    ``gqa_decode_attn_paged``.  Returns (y [B,1,d], arena_ckv,
    arena_kr)."""
    B = x.shape[0]
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend)
    ckv, krope = _mla_compress(p, cfg, x, positions, backend)
    arena_ckv.index_put_(index.write, ckv[:, 0])
    arena_kr.index_put_(index.write, krope[:, 0])
    gc = arena_ckv[index.table].reshape(B, -1, arena_ckv.shape[2])
    gr = arena_kr[index.table].reshape(B, -1, arena_kr.shape[2])
    ctx = _mla_absorbed_ctx(p, cfg, q_nope, q_rope, gc, gr,
                            index.valid[:, 0])                # [B,1,1,T]
    return (linear_apply(p["o"], ctx.to(x.dtype), backend), arena_ckv,
            arena_kr)


def mla_chunk_attn(p, cfg: ModelConfig, x, dckv, dkr, start: torch.Tensor,
                   backend="einsum"):
    """Absorbed-form chunk or suffix prefill against dense latent buffers
    dckv [1, T + S_pad, kv_lora], dkr [1, T + S_pad, rope_hd] (S_pad
    scratch rows appended), as ``gqa_chunk_attn``: the chunk's entries are
    written at their absolute positions, in place, and it attends causally
    to prefix + itself.  Returns (y, dckv, dkr)."""
    S_pad = x.shape[1]
    positions = start + torch.arange(S_pad, dtype=torch.int32,
                                     device=x.device)[None, :]  # [1, S_pad]
    q_nope, q_rope = _mla_q(p, cfg, x, positions, backend)
    ckv, krope = _mla_compress(p, cfg, x, positions, backend)
    rows = positions[0].long()
    dckv.index_copy_(1, rows, ckv.to(dckv.dtype))
    dkr.index_copy_(1, rows, krope.to(dkr.dtype))
    j = torch.arange(dckv.shape[1], device=x.device)[None, None, :]
    valid = (j <= positions[:, :, None])[:, None]             # [1,1,S,T]
    ctx = _mla_absorbed_ctx(p, cfg, q_nope, q_rope, dckv, dkr, valid)
    return linear_apply(p["o"], ctx.to(x.dtype), backend), dckv, dkr


def mla_resume_attn(p, cfg: ModelConfig, x, arena_ckv, arena_kr, src_b,
                    dst_b, start: torch.Tensor, backend="einsum"):
    """Absorbed-form suffix prefill over the latent arenas gathered through
    ``src_b``, scattered back through ``dst_b`` IN PLACE (copy-on-write
    where they differ), as ``gqa_resume_attn``.  Returns (y, arena_ckv,
    arena_kr)."""
    S_pad = x.shape[1]
    dckv = _resume_dense(arena_ckv, src_b, S_pad)
    dkr = _resume_dense(arena_kr, src_b, S_pad)
    y, dckv, dkr = mla_chunk_attn(p, cfg, x, dckv, dkr, start,
                                  backend=backend)
    _resume_scatter(arena_ckv, dst_b, dckv)
    _resume_scatter(arena_kr, dst_b, dkr)
    return y, arena_ckv, arena_kr
