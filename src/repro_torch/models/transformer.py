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
from .attention import gqa_decode_attn, gqa_self_attn, gqa_spec
from .layers import mlp_apply, mlp_spec, rmsnorm_apply, rmsnorm_spec


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str = "gqa"        # only gqa is ported
    ffn: str = "mlp"          # only mlp is ported

    def __post_init__(self):
        if self.mixer != "gqa" or self.ffn != "mlp":
            raise NotImplementedError(
                f"block {self.mixer}+{self.ffn} is not ported yet (ROADMAP.md "
                f"Queue 1 item 10); only gqa+mlp is")


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
                 pos: torch.Tensor, plans=None, active=None):
    """Single-token block at the device position ``pos`` (0-d or [B],
    with ``active`` [B] gating each row's write; see
    ``attention.gqa_decode_attn``); the cache's k/v are updated in
    place."""
    h = rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, nk, nv = gqa_decode_attn(p["attn"], cfg, h, cache["k"], cache["v"],
                                pos, backend=plans, active=active)
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
                 caches: list, pos: torch.Tensor, plans=None, active=None):
    period, _ = group
    new = []
    for layer, lc in zip(params, caches):
        c = {}
        for i, bd in enumerate(period):
            x, c[f"b{i}"] = block_decode(layer[f"b{i}"], cfg, bd, x,
                                         lc[f"b{i}"], pos, plans=plans,
                                         active=active)
        new.append(c)
    return x, new
