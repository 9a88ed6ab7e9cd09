"""Block assembly for the dense decoder.

A model is a list of groups ``(period, count)``: ``period`` is a tuple of
BlockDefs run in order and repeated ``count`` times.  Parameters of a group
are a list with one dict ``{"b0": ..., "b1": ...}`` per repetition, walked
by a Python loop (the reference stacks them and runs ``lax.scan``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from .attention import (gqa_chunk_attn, gqa_decode_attn,
                        gqa_decode_attn_paged, gqa_resume_attn,
                        gqa_self_attn, gqa_spec)
from .layers import mlp_apply, mlp_spec, rmsnorm_apply, rmsnorm_spec


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str = "gqa"        # only gqa is ported
    ffn: str = "mlp"          # only mlp is ported

    def __post_init__(self):
        if self.mixer != "gqa" or self.ffn != "mlp":
            raise NotImplementedError(
                f"block {self.mixer}+{self.ffn} is not ported yet (ROADMAP.md "
                f"Queue 1, \"Remaining families\"); only gqa+mlp is")


Group = tuple[tuple[BlockDef, ...], int]


def block_spec(cfg: ModelConfig, bd: BlockDef, dtype) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model, dtype),
            "attn": gqa_spec(cfg, dtype),
            "ln2": rmsnorm_spec(cfg.d_model, dtype),
            "ffn": mlp_spec(cfg.d_model, cfg.d_ff, cfg.tt, dtype)}


def group_spec(cfg: ModelConfig, group: Group, dtype) -> list:
    period, count = group
    return [{f"b{i}": block_spec(cfg, bd, dtype)
             for i, bd in enumerate(period)} for _ in range(count)]


def block_cache_kinds(bd: BlockDef) -> dict[str, str]:
    """Paging kind of each cache leaf of one block (DESIGN.md §7):
    'paged' — token-indexed, block-pageable and prefix-shareable.  The
    ported mixer is full-attention GQA, whose k and v are both 'paged'
    (the reference's 'ring' and 'slot' kinds come with the windowed, SSM
    and cross-attention families)."""
    return {"k": "paged", "v": "paged"}


def block_paged_cache_shape(cfg: ModelConfig, bd: BlockDef, num_blocks: int,
                            block: int, dtype) -> dict:
    """(shape, dtype) of each cache leaf of one block in the paged pool:
    'paged' leaves are arenas [num_blocks + 1, block, KV, hd] (the + 1 is
    the write sentinel)."""
    shape = (num_blocks + 1, block, cfg.num_kv_heads, cfg.head_dim)
    return {name: (shape, dtype)
            for name, kind in block_cache_kinds(bd).items() if kind == "paged"}


def block_fwd(p, cfg: ModelConfig, bd: BlockDef, x, positions, *,
              want_cache: bool, T_cache: int = 0, plans=None, out=None):
    """Full-sequence block (prefill).  Returns (x, cache or None); the
    cache holds k/v zero-padded from S to ``T_cache`` positions, written
    into ``out`` (``{"k", "v"}`` of that shape) when it is given."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, (k, v) = gqa_self_attn(p["attn"], cfg, h, positions, backend=plans)
    cache = None
    if want_cache:
        B, S, KV, hd = k.shape
        if S > T_cache:
            raise ValueError(f"prompt of {S} tokens exceeds the cache of "
                             f"{T_cache}")
        cache = {}
        for name, t in (("k", k), ("v", v)):
            shape = (B, T_cache, KV, hd)
            if out is None:
                buf = torch.empty(shape, dtype=t.dtype, device=t.device)
            else:
                buf = out[name]
                if buf.shape != shape or buf.dtype != t.dtype:
                    raise ValueError(
                        f"the output cache's {name} is {tuple(buf.shape)} "
                        f"{buf.dtype}, the prefill writes {shape} {t.dtype}")
            buf[:, :S] = t
            buf[:, S:] = 0
            cache[name] = buf
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, plans), cache


def block_decode(p, cfg: ModelConfig, bd: BlockDef, x, cache: dict,
                 pos: torch.Tensor, plans=None, paged=None, active=None):
    """Single-token block at the device position ``pos`` (0-d or [B],
    with ``active`` [B] gating each row's write; see
    ``attention.gqa_decode_attn``); the cache's k/v are updated in
    place.  ``paged``: None for the dense layout, else the step's
    ``attention.PagedIndex`` of the block tables, and k/v are block arenas
    (``attention.gqa_decode_attn_paged``)."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if paged is not None:
        y, nk, nv = gqa_decode_attn_paged(p["attn"], cfg, h, cache["k"],
                                          cache["v"], pos, paged,
                                          backend=plans)
    else:
        y, nk, nv = gqa_decode_attn(p["attn"], cfg, h, cache["k"],
                                    cache["v"], pos, backend=plans,
                                    active=active)
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, plans), {"k": nk, "v": nv}


def group_fwd(params: list, group: Group, cfg: ModelConfig, x, positions,
              *, want_cache: bool, T_cache: int = 0, plans=None, out=None):
    """Run a group's repetitions in order.  Returns (x, per-layer caches),
    written into ``out`` (a cache group's per-layer list) when it is
    given."""
    period, _ = group
    caches = []
    for li, layer in enumerate(params):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_fwd(
                layer[f"b{i}"], cfg, bd, x, positions,
                want_cache=want_cache, T_cache=T_cache, plans=plans,
                out=None if out is None else out[li][f"b{i}"])
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
    Only prefix-shareable mixers get here (``Model.supports_prefix_reuse``;
    the ported full-attention GQA is one)."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, nk, nv = gqa_resume_attn(p["attn"], cfg, h, cache["k"], cache["v"],
                                src_b, dst_b, start, backend=plans)
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, plans), {"k": nk, "v": nv}


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
                table, start, active, plans=None):
    """One prefill chunk of one slot through one block, IN PLACE.

    x [1, C, d] at absolute positions start + t (right-padded past the
    chunk's true length: full attention writes the padding's k/v past the
    row's new position, where every later step masks or overwrites it);
    ``slot``, ``start`` (0-d int32) and ``active`` (0-d bool) are tensors
    on the device, so nothing is read on the host.  ``table`` [max_blocks]
    int32 addresses the paged arenas (None for the dense pool; the caller
    makes it all sentinel when the lane is inactive): the gather, chunk
    attention and scatter of ``block_resume`` with the slot's own table as
    source and destination.
    Dense: row ``slot`` of k/v is taken with C scratch rows appended,
    attended, and written back as ``where(active, new, old)``, so an
    inactive lane writes the bits it read.  Full attention only (the
    reference's windowed-ring, MLA and SSM branches come with their
    families)."""
    if bd.mixer != "gqa":
        raise ValueError(f"mixer {bd.mixer!r} has no chunked prefill")
    if table is not None:
        return block_resume(p, cfg, bd, x, cache, table, table, start,
                            plans=plans)
    C = x.shape[1]
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    idx = slot.reshape(1).long()
    old = {n: cache[n].index_select(0, idx) for n in ("k", "v")}
    T = old["k"].shape[1]
    dk, dv = (torch.cat([r, r.new_zeros((1, C, *r.shape[2:]))], 1)
              for r in (old["k"], old["v"]))
    y, dk, dv = gqa_chunk_attn(p["attn"], cfg, h, dk, dv, start,
                               backend=plans)
    for name, new in (("k", dk), ("v", dv)):
        cache[name].index_copy_(0, idx, torch.where(active, new[:, :T],
                                                    old[name]))
    x = x + y
    h = rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, plans), cache


def group_chunk(params: list, group: Group, cfg: ModelConfig, x,
                caches: list, slot, table, start, active, plans=None):
    """One prefill chunk over a group's layers, in order (the reference
    scans its stacked layers)."""
    period, _ = group
    new = []
    for layer, lc in zip(params, caches):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_chunk(layer[f"b{i}"], cfg, bd, x,
                                        lc[f"b{i}"], slot, table, start,
                                        active, plans=plans)
        new.append(c)
    return x, new
