"""Block assembly for the decoders: full-attention and sliding-window
(ring-cache) GQA blocks, and MLA blocks over a latent cache, with a GLU
MLP (deepseek-v2's wider first-layer ``dense0`` included) or a
mixture-of-experts FFN (``ffn_apply``); and Mamba-2 SSD blocks, whose
cache is a per-slot recurrent state and conv history (``models.ssm``),
with no FFN (mamba2) or with the GLU MLP or the mixture of experts after
the mixer (jamba's hybrid); and an encoder-decoder's blocks: the encoder's
non-causal GQA blocks (``causal=False``, no cache) and the decoder's GQA
blocks that cross-attend to the encoder's output after their
self-attention (``cross=True``), whose projected keys and values ``xk``/
``xv`` [B, F, KV, hd] are 'slot' cache leaves, written by the prefill and
read by every decode step.

A model is a list of groups ``(period, count)``: ``period`` is a tuple of
BlockDefs run in order and repeated ``count`` times.  Parameters of a group
are a list with one dict ``{"b0": ..., "b1": ...}`` per repetition, walked
by a Python loop (the reference stacks them and runs ``lax.scan``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from .attention import (cross_attn, cross_attn_spec, cross_kv,
                        gqa_chunk_attn, gqa_chunk_attn_ring,
                        gqa_decode_attn, gqa_decode_attn_paged,
                        gqa_resume_attn, gqa_self_attn, gqa_spec,
                        mla_chunk_attn, mla_decode_attn,
                        mla_decode_attn_paged, mla_resume_attn,
                        mla_self_attn, mla_spec, ring_positions)
from .layers import mlp_apply, mlp_spec, rmsnorm_apply, rmsnorm_spec
from .moe import moe_apply, moe_spec
from .ssm import ssm_decode, ssm_dims, ssm_forward, ssm_spec


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str = "gqa"        # gqa | mla | ssm
    window: int = 0           # >0 → sliding-window attention (ring cache)
    ffn: str = "mlp"          # mlp | moe | dense0 (the first_dense_ff MLP)
                              # | none (ssm only)
    theta: float | None = None  # RoPE theta; None: the config's
    cross: bool = False       # cross-attention (an enc-dec's decoder)
    causal: bool = True       # False: an encoder's self-attention

    def __post_init__(self):
        attn = self.mixer in ("gqa", "mla") and self.ffn in (
            "mlp", "moe", "dense0") and not (self.mixer == "mla" and
                                             self.window)
        ssm = self.mixer == "ssm" and self.ffn in ("none", "mlp", "moe") \
            and not self.window
        plain = self.causal and not self.cross
        enc_dec = self.mixer == "gqa" and self.ffn == "mlp" and not \
            self.window and not (self.cross and not self.causal)
        if not ((attn or ssm) and plain or enc_dec):
            raise NotImplementedError(
                f"block {self.mixer}+{self.ffn} (window {self.window}, "
                f"cross {self.cross}, causal {self.causal}) is not ported "
                f"yet (ROADMAP.md Queue 1, \"Remaining families\"); gqa "
                f"and full-attention mla with mlp, moe or dense0, ssm with "
                f"no FFN, mlp or moe, and full-attention gqa with mlp, "
                f"non-causal or cross-attending, are")

    @property
    def cache_names(self) -> tuple[str, ...]:
        """The block's cache leaves, in ``block_cache_shape``'s order:
        attention's k/v (MLA's latent ckv/krope), whose kind is 'paged' or
        'ring', or the SSM's 'slot' leaves, its recurrent state and conv
        history (``block_cache_kinds``)."""
        return {"mla": ("ckv", "krope"), "ssm": ("state", "conv")}.get(
            self.mixer, ("k", "v"))

    @property
    def leaf_names(self) -> tuple[str, ...]:
        """Every cache leaf of the block: ``cache_names``, then a
        cross-attending block's encoder keys and values ``xk``/``xv``
        (kind 'slot')."""
        return self.cache_names + (("xk", "xv") if self.cross else ())


Group = tuple[tuple[BlockDef, ...], int]


def block_spec(cfg: ModelConfig, bd: BlockDef, dtype) -> dict:
    """A block's ``ln1`` and mixer (``attn``, or an SSM block's ``ssm``),
    a cross-attending block's ``ln_x`` and ``xattn``, then ``ln2`` and
    ``ffn`` unless the FFN is ``none``, as the reference's."""
    out = {"ln1": rmsnorm_spec(cfg.d_model, dtype)}
    if bd.mixer == "ssm":
        out["ssm"] = ssm_spec(cfg, dtype)
    else:
        out["attn"] = (mla_spec if bd.mixer == "mla" else gqa_spec)(cfg,
                                                                    dtype)
    if bd.cross:
        out["ln_x"] = rmsnorm_spec(cfg.d_model, dtype)
        out["xattn"] = cross_attn_spec(cfg, dtype)
    if bd.ffn == "none":
        return out
    if bd.ffn == "moe":
        ffn = moe_spec(cfg, dtype)
    else:
        ff = cfg.moe.first_dense_ff if (bd.ffn == "dense0" and cfg.moe) \
            else cfg.d_ff
        ffn = mlp_spec(cfg.d_model, ff, cfg.tt, dtype)
    return {**out, "ln2": rmsnorm_spec(cfg.d_model, dtype), "ffn": ffn}


def ffn_apply(p, cfg: ModelConfig, bd: BlockDef, h, plans=None):
    """The block's FFN on ``h [B, S, d]``: the GLU MLP (``dense0`` too),
    or the mixture-of-experts FFN over the B·S tokens of this call (its
    capacity depends on them, so each path passes the reference's token
    set)."""
    if bd.ffn == "moe":
        return moe_apply(p, cfg, h, plans)
    return mlp_apply(p, h, plans)


def _ffn_residual(p, cfg: ModelConfig, bd: BlockDef, x, plans=None):
    """``x`` plus the block's FFN of ``ln2(x)``; ``x`` itself when the
    block has no FFN (mamba2's SSM blocks)."""
    if bd.ffn == "none":
        return x
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + ffn_apply(p["ffn"], cfg, bd, h, plans)


def group_spec(cfg: ModelConfig, group: Group, dtype) -> list:
    period, count = group
    return [{f"b{i}": block_spec(cfg, bd, dtype)
             for i, bd in enumerate(period)} for _ in range(count)]


def block_cache_shape(cfg: ModelConfig, bd: BlockDef, B: int, T: int,
                      dtype, enc_T: int = 0) -> dict:
    """(shape, dtype) of each cache leaf of one block in a dense cache of
    ``B`` rows and ``T`` positions: k/v [B, T, KV, hd], a windowed block
    a ring of min(window, T) positions; MLA the latent ckv [B, T,
    kv_lora] and krope [B, T, rope_hd]; an SSM block its recurrent state
    [B, H, N, P], fp32 whatever ``dtype`` is, and its conv history [B,
    K-1, conv_dim] (no position axis); a cross-attending block also the
    encoder's keys and values xk/xv [B, enc_T, KV, hd]."""
    if bd.mixer == "ssm":
        s = cfg.ssm
        _, heads, conv_dim = ssm_dims(cfg)
        return {"state": ((B, heads, s.d_state, s.head_dim), torch.float32),
                "conv": ((B, s.d_conv - 1, conv_dim), dtype)}
    if bd.mixer == "mla":
        m = cfg.mla
        return {"ckv": ((B, T, m.kv_lora), dtype),
                "krope": ((B, T, m.rope_head_dim), dtype)}
    W = min(bd.window, T) if bd.window else T
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    out = {"k": (shape, dtype), "v": (shape, dtype)}
    if bd.cross:
        xshape = (B, enc_T, cfg.num_kv_heads, cfg.head_dim)
        out.update(xk=(xshape, dtype), xv=(xshape, dtype))
    return out


def block_cache_kinds(bd: BlockDef) -> dict[str, str]:
    """Paging kind of each cache leaf of one block (DESIGN.md §7):
    'paged' — token-indexed, block-pageable and prefix-shareable (full
    attention, MLA's latent leaves); 'ring' — a window ring,
    block-pageable through the low entries of the slot's table but never
    prefix-shared (its contents are overwritten in place); 'slot' — a
    fixed-size state per slot (the SSM's recurrent state and conv
    history, a cross-attending block's encoder keys and values), never
    paged: [num_slots, ...] in both pool layouts, spliced into its slot's
    row and left alone by a block copy."""
    if bd.mixer == "ssm":
        kind = "slot"
    else:
        kind = "ring" if bd.window else "paged"
    return {name: kind if name in bd.cache_names else "slot"
            for name in bd.leaf_names}


def block_paged_cache_shape(cfg: ModelConfig, bd: BlockDef, num_slots: int,
                            num_blocks: int, block: int, dtype,
                            enc_T: int = 0) -> dict:
    """(shape, dtype) of each cache leaf of one block in the paged pool:
    'paged' and 'ring' leaves are arenas [num_blocks + 1, block, ...] (the
    + 1 is the write sentinel) of one position's entry, [KV, hd] or MLA's
    [kv_lora] and [rope_hd]; a 'slot' leaf keeps its dense shape
    [num_slots, ...] (xk/xv [num_slots, enc_T, KV, hd])."""
    kinds = block_cache_kinds(bd)
    dense = block_cache_shape(cfg, bd, num_slots, 1, dtype, enc_T)
    return {name: (shape, dt) if kinds[name] == "slot" else
            ((num_blocks + 1, block) + shape[2:], dt)
            for name, (shape, dt) in dense.items()}


def block_fwd(p, cfg: ModelConfig, bd: BlockDef, x, positions, *,
              want_cache: bool, T_cache: int = 0, plans=None, out=None,
              true_len=None, enc_out=None):
    """Full-sequence block (prefill).  Returns (x, cache or None); the
    cache is written into ``out`` (``block_cache_shape``'s leaves) when it
    is given.  Full attention keeps k/v (MLA: the latent ckv/krope of the
    expanded-form prefill) zero-padded from S to ``T_cache`` positions
    (rows past ``true_len`` are a bucket's padding, beyond the cache
    position, masked by every later step).  A windowed block keeps a
    ring of W = min(window, T_cache) positions built at ``true_len`` (0-d
    int on the device, the prompt's true length): one
    path for every prompt, where the reference rolls or pads an
    exact-length prompt and takes this path for a bucketed one; at the
    true length they agree value for value, and no padding row reaches
    the ring.  An SSM block keeps its final recurrent state (fp32) and the
    conv tail at ``true_len`` (``ssm.ssm_forward``: the padding's steps
    leave the state as it was).  A non-causal block (an encoder's) attends
    to every position.  A cross-attending block then adds ``ln_x`` and the
    cross-attention to the encoder output ``enc_out [B, F, d]``, whose
    projected keys and values it keeps as xk/xv [B, F, KV, hd].  The FFN,
    where the block has one, runs on the B·S tokens."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if bd.mixer == "ssm":
        y, state, tail = ssm_forward(p["ssm"], cfg, h, plans,
                                     true_len=true_len)
        cache = None
        if want_cache:
            shapes = block_cache_shape(cfg, bd, x.shape[0], T_cache,
                                       x.dtype)
            cache = {name: t if out is None else
                     _out_buf(out, name, *shapes[name]).copy_(t)
                     for name, t in (("state", state), ("conv", tail))}
        return _ffn_residual(p, cfg, bd, x + y, plans), cache
    if bd.mixer == "mla":
        y, (k, v) = mla_self_attn(p["attn"], cfg, h, positions,
                                  backend=plans)
    else:
        y, (k, v) = gqa_self_attn(p["attn"], cfg, h, positions,
                                  window=bd.window, theta=bd.theta,
                                  backend=plans, causal=bd.causal)
    cache = None
    if want_cache:
        B, S = k.shape[:2]
        if S > T_cache:
            raise ValueError(f"prompt of {S} tokens exceeds the cache of "
                             f"{T_cache}")
        if bd.window:
            # slot s takes the latest prompt position p with p % W == s
            held = ring_positions(true_len.long() - 1, min(bd.window,
                                                           T_cache))
            take = held.clamp(min=0)
        cache = {}
        for name, t in zip(bd.cache_names, (k, v)):
            shape, _ = block_cache_shape(cfg, bd, B, T_cache, t.dtype)[name]
            if out is None:
                buf = torch.empty(shape, dtype=t.dtype, device=t.device)
            else:
                buf = _out_buf(out, name, shape, t.dtype)
            if bd.window:
                torch.where(held[None, :, None, None] >= 0,
                            t.index_select(1, take), t.new_zeros(()),
                            out=buf)
            else:
                buf[:, :S] = t
                buf[:, S:] = 0
            cache[name] = buf
    x = x + y
    if bd.cross:
        xk, xv = cross_kv(p["xattn"], cfg, enc_out, plans)
        if want_cache:
            for name, t in (("xk", xk), ("xv", xv)):
                cache[name] = t if out is None else _out_buf(
                    out, name, tuple(t.shape), t.dtype).copy_(t)
        x = _cross_residual(p, cfg, x, xk, xv, plans)
    return _ffn_residual(p, cfg, bd, x, plans), cache


def _cross_residual(p, cfg: ModelConfig, x, xk, xv, plans=None):
    """``x`` plus the cross-attention of ``ln_x(x)`` to the encoder's keys
    and values ``xk``/``xv``."""
    h = rmsnorm_apply(p["ln_x"], x, cfg.norm_eps)
    return x + cross_attn(p["xattn"], cfg, h, xk, xv, plans)


def _out_buf(out: dict, name: str, shape: tuple, dtype: torch.dtype
             ) -> torch.Tensor:
    """Leaf ``name`` of the output cache ``out``, which must have the
    prefill's shape and dtype."""
    buf = out[name]
    if tuple(buf.shape) != shape or buf.dtype != dtype:
        raise ValueError(f"the output cache's {name} is {tuple(buf.shape)} "
                         f"{buf.dtype}, the prefill writes {shape} {dtype}")
    return buf


def block_decode(p, cfg: ModelConfig, bd: BlockDef, x, cache: dict,
                 pos: torch.Tensor, plans=None, paged=None, active=None):
    """Single-token block at the device position ``pos`` (0-d or [B],
    with ``active`` [B] gating each row's write; see
    ``attention.gqa_decode_attn``); the cache's k/v are updated in
    place.  ``paged``: None for the dense layout, else the step's
    ``attention.PagedIndex`` of the block tables per window (0: full
    attention), and k/v are block arenas
    (``attention.gqa_decode_attn_paged``).  An MLA block runs the absorbed
    form over its latent ckv/krope the same way
    (``attention.mla_decode_attn[_paged]``).  An SSM block updates its
    recurrent state and conv history in place, the same 'slot' leaves in
    both layouts, and a row ``active`` leaves out keeps both bit for bit
    (``ssm.ssm_decode``).  A cross-attending block then attends to its
    cache's xk/xv, which no step writes.  The FFN runs on the B rows,
    inactive ones included, the reference's token set."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if bd.mixer == "ssm":
        y, st, cv = ssm_decode(p["ssm"], cfg, h, cache["state"],
                               cache["conv"], plans, active=active)
        return _ffn_residual(p, cfg, bd, x + y, plans), {"state": st,
                                                         "conv": cv}
    a, b = bd.cache_names
    if bd.mixer == "mla" and paged is not None:
        y, nk, nv = mla_decode_attn_paged(p["attn"], cfg, h, cache[a],
                                          cache[b], pos, paged[bd.window],
                                          backend=plans)
    elif bd.mixer == "mla":
        y, nk, nv = mla_decode_attn(p["attn"], cfg, h, cache[a], cache[b],
                                    pos, backend=plans, active=active)
    elif paged is not None:
        y, nk, nv = gqa_decode_attn_paged(p["attn"], cfg, h, cache["k"],
                                          cache["v"], pos, paged[bd.window],
                                          theta=bd.theta, backend=plans)
    else:
        y, nk, nv = gqa_decode_attn(p["attn"], cfg, h, cache["k"],
                                    cache["v"], pos, window=bd.window,
                                    theta=bd.theta, backend=plans,
                                    active=active)
    new = {a: nk, b: nv}
    x = x + y
    if bd.cross:
        new.update(xk=cache["xk"], xv=cache["xv"])
        x = _cross_residual(p, cfg, x, cache["xk"], cache["xv"], plans)
    return _ffn_residual(p, cfg, bd, x, plans), new


def group_fwd(params: list, group: Group, cfg: ModelConfig, x, positions,
              *, want_cache: bool, T_cache: int = 0, plans=None, out=None,
              true_len=None, enc_out=None):
    """Run a group's repetitions in order.  Returns (x, per-layer caches),
    written into ``out`` (a cache group's per-layer list) when it is
    given; rings are built at ``true_len``, cross-attention reads
    ``enc_out`` (``block_fwd``)."""
    period, _ = group
    caches = []
    for li, layer in enumerate(params):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_fwd(
                layer[f"b{i}"], cfg, bd, x, positions,
                want_cache=want_cache, T_cache=T_cache, plans=plans,
                out=None if out is None else out[li][f"b{i}"],
                true_len=true_len, enc_out=enc_out)
        caches.append(c)
    return x, (caches if want_cache else None)


def group_decode(params: list, group: Group, cfg: ModelConfig, x,
                 caches: list, pos: torch.Tensor, plans=None, paged=None,
                 active=None):
    period, _ = group
    new = []
    for layer, lc in zip(params, caches):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_decode(layer[f"b{i}"], cfg, bd, x,
                                         lc[f"b{i}"], pos, plans=plans,
                                         paged=paged, active=active)
        new.append(c)
    return x, new


def block_resume(p, cfg: ModelConfig, bd: BlockDef, x, cache: dict, src_b,
                 dst_b, start, plans=None):
    """Suffix prefill of one block against its paged arenas: attends to the
    prefix gathered through ``src_b`` and scatters the updated logical
    cache back through ``dst_b`` (COW where the tables differ), in place.
    Only prefix-shareable mixers get here (``Model.supports_prefix_reuse``:
    full-attention GQA or MLA, not a window ring nor an SSM state, nor a
    cross-attending block).  The MoE runs on the suffix's tokens, the
    reference's token set."""
    if bd.cross:
        raise ValueError("prefix-resume prefill does not support "
                         "cross-attention")
    if bd.window or bd.mixer == "ssm":
        raise ValueError(f"mixer {bd.mixer!r} (window={bd.window}) does not "
                         f"support prefix-resume prefill")
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    a, b = bd.cache_names
    if bd.mixer == "mla":
        y, nk, nv = mla_resume_attn(p["attn"], cfg, h, cache[a], cache[b],
                                    src_b, dst_b, start, backend=plans)
    else:
        y, nk, nv = gqa_resume_attn(p["attn"], cfg, h, cache[a], cache[b],
                                    src_b, dst_b, start, theta=bd.theta,
                                    backend=plans)
    return _ffn_residual(p, cfg, bd, x + y, plans), {a: nk, b: nv}


def group_resume(params: list, group: Group, cfg: ModelConfig, x,
                 caches: list, src_b, dst_b, start, plans=None):
    """Resume prefill over a group's layers, in order (the reference
    scans its stacked layers)."""
    period, _ = group
    new = []
    for layer, lc in zip(params, caches):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_resume(layer[f"b{i}"], cfg, bd, x,
                                         lc[f"b{i}"], src_b, dst_b, start,
                                         plans=plans)
        new.append(c)
    return x, new


# ---------------------------------------------------------------------------
# Chunked prefill: one prompt chunk of one slot, inside the serving pool
# ---------------------------------------------------------------------------

def block_chunk(p, cfg: ModelConfig, bd: BlockDef, x, cache: dict, slot,
                table, start, true_len, active, plans=None):
    """One prefill chunk of one slot through one block, IN PLACE.

    x [1, C, d] at absolute positions start + t, right-padded past the
    chunk's true length ``true_len``; ``slot``, ``start``, ``true_len``
    (0-d int32) and ``active`` (0-d bool) are tensors on the device, so
    nothing is read on the host.  ``table`` [max_blocks] int32 addresses
    the paged arenas (None for the dense pool; the caller makes it all
    sentinel when the lane is inactive).

    Full attention writes the padding's k/v past the row's new position,
    where every later step masks or overwrites it: paged, the gather,
    chunk attention and scatter of ``block_resume`` with the slot's own
    table as source and destination; dense, row ``slot`` of k/v taken with
    C scratch rows appended, attended, and written back as ``where(active,
    new, old)``.  A window ring (``attention.gqa_chunk_attn_ring``) is
    rebuilt from the history: dense, row ``slot``'s ring, written back as
    ``where(active, new, old)``; paged, the table's low ceil(W / block)
    blocks gathered, the ring (their first W rows) rebuilt and the blocks
    scattered back.  An inactive lane writes back the bits it read (dense)
    or only the sentinel block (paged).  MLA takes the full-attention
    paths over its latent leaves, in the absorbed form
    (``attention.mla_chunk_attn``).  An SSM block reads row ``slot`` of
    its state and conv history (zeros when ``start`` is 0: a fresh
    prompt), runs the chunk from them (``ssm.ssm_forward``) and writes
    the row back as ``where(active, new, old)``, in either layout.  The
    FFN runs on the chunk's C tokens.  A cross-attending block raises, as
    the reference's does."""
    if bd.cross:
        raise ValueError("chunked prefill does not support cross-attention")
    C = x.shape[1]
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    idx = slot.reshape(1).long()
    if bd.mixer == "ssm":
        old = {n: cache[n].index_select(0, idx) for n in ("state", "conv")}
        st, cv = (torch.where(start == 0, t.new_zeros(()), t)
                  for t in old.values())
        y, st, tail = ssm_forward(p["ssm"], cfg, h, plans,
                                  true_len=true_len, s0=st, conv_hist=cv)
        for name, new in (("state", st), ("conv", tail)):
            cache[name].index_copy_(0, idx, torch.where(
                active, new.to(old[name].dtype), old[name]))
        return _ffn_residual(p, cfg, bd, x + y, plans), cache
    if bd.window and table is not None:
        blk = cache["k"].shape[1]
        W = min(bd.window, table.shape[0] * blk)
        nblk = -(-W // blk)
        tb = table[:nblk].long()
        g = {n: cache[n][tb].reshape(1, nblk * blk, *cache[n].shape[2:])
             for n in ("k", "v")}
        y, nk, nv = gqa_chunk_attn_ring(p["attn"], cfg, h, g["k"][:, :W],
                                        g["v"][:, :W], start, true_len,
                                        theta=bd.theta, backend=plans)
        for name, ring in (("k", nk), ("v", nv)):
            g[name][:, :W] = ring
            cache[name].index_put_((tb,), g[name][0].reshape(
                nblk, blk, *cache[name].shape[2:]))
    elif bd.window:
        old = {n: cache[n].index_select(0, idx) for n in ("k", "v")}
        y, nk, nv = gqa_chunk_attn_ring(p["attn"], cfg, h, old["k"],
                                        old["v"], start, true_len,
                                        theta=bd.theta, backend=plans)
        for name, new in (("k", nk), ("v", nv)):
            cache[name].index_copy_(0, idx, torch.where(active, new,
                                                        old[name]))
    elif table is not None:
        return block_resume(p, cfg, bd, x, cache, table, table, start,
                            plans=plans)
    else:
        names = bd.cache_names
        old = {n: cache[n].index_select(0, idx) for n in names}
        T = old[names[0]].shape[1]
        dk, dv = (torch.cat([r, r.new_zeros((1, C, *r.shape[2:]))], 1)
                  for r in old.values())
        if bd.mixer == "mla":
            y, dk, dv = mla_chunk_attn(p["attn"], cfg, h, dk, dv, start,
                                       backend=plans)
        else:
            y, dk, dv = gqa_chunk_attn(p["attn"], cfg, h, dk, dv, start,
                                       theta=bd.theta, backend=plans)
        for name, new in zip(names, (dk, dv)):
            cache[name].index_copy_(0, idx, torch.where(active, new[:, :T],
                                                        old[name]))
    return _ffn_residual(p, cfg, bd, x + y, plans), cache


def group_chunk(params: list, group: Group, cfg: ModelConfig, x,
                caches: list, slot, table, start, true_len, active,
                plans=None):
    """One prefill chunk over a group's layers, in order (the reference
    scans its stacked layers)."""
    period, _ = group
    new = []
    for layer, lc in zip(params, caches):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_chunk(layer[f"b{i}"], cfg, bd, x,
                                        lc[f"b{i}"], slot, table, start,
                                        true_len, active, plans=plans)
        new.append(c)
    return x, new
