"""Model facade: parameter specs and init, ``prefill`` (exact, padded to
a prompt-length bucket, or captured: ``padded_prefill``,
``bucketed_prefill``, ``graphed_prefill``), ``decode_step``,
``splice_cache``, ``graphed_decode_step``, ``init_cache`` and
``quantize_params`` for the dense decoder; and for the block-paged pool
(DESIGN.md §7), ``init_cache(..., paged=True)``, ``splice_cache_paged``
and the prefix-reuse admission ``prefill_resume`` (``resume_prefill``
buckets it and, on a card, replays it captured); and for chunked prefill
(DESIGN.md §15), over either pool, ``chunk_step``, ``mixed_step`` (on a
card replayed as ``models.graph.MixedGraph``) and ``copy_blocks``.

Parameters are a dict tree of tensors: ``embed``, ``final_norm``,
``lm_head`` and one list per layer group ``g{gi}`` holding a dict
``{"b0": block params}`` per layer.  ``convert.from_jax_params`` builds
this tree from the reference's stacked one.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.plan import PlanBook
from .attention import paged_index
from .graph import DecodeGraph, PrefillGraph
from .layers import (embed_apply, embed_spec, linear_apply, linear_spec,
                     quantize_tt_params, rmsnorm_apply, rmsnorm_spec)
from .spec import init_tree, map_tree, tree_leaves
from .transformer import (Group, block_cache_kinds, block_paged_cache_shape,
                          group_chunk, group_decode, group_fwd, group_resume,
                          group_spec)


# captured decode steps a model keeps, and captured prefills (the
# reference's jit_cache_size)
GRAPH_CACHE_SIZE = 8


def bucket_length(S: int, limit: int, floor: int = 16) -> int:
    """Prompt-length bucket: next power of two >= S (min ``floor``),
    clamped to ``limit`` — varied-length traffic compiles O(log limit)
    prefill variants instead of one per distinct length."""
    if S > limit:
        raise ValueError(f"prompt length {S} exceeds cache length {limit}")
    b = max(floor, 1 << max(S - 1, 0).bit_length())
    return min(b, limit)


class Model:
    """One dense decoder.  ``device=None`` means the GPU; pass
    ``device="cpu"`` for the plain path."""

    def __init__(self, cfg: ModelConfig, groups: list[Group],
                 param_dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.groups = groups
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        # full fp32 matmuls on the card: TF32 would change the numbers the
        # port is held to against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._plan_book: PlanBook | None = None
        # captured decode steps per (batch, cache length, masked), least
        # recently used first; the captures made and the TT launches the
        # replays (of decode steps and prefills) made, by kernel name (no
        # wrapper runs on a replay)
        self.decode_graphs: collections.OrderedDict = \
            collections.OrderedDict()
        self.graph_captures = 0
        self.replayed_launches: collections.Counter = collections.Counter()
        # captured prefills per (batch, padded length, cache length), least
        # recently used first; their output caches per (batch, cache
        # length), shared by that pair's buckets; the memory pool of their
        # temporaries, shared by all of them; the eager prefills' keys, in
        # an LRU of their own; and the reference's ``prefill_builds``: new
        # prefill entries, a capture or an eager key seen first
        self.prefill_graphs: collections.OrderedDict = \
            collections.OrderedDict()
        self.prefill_caches: dict = {}
        self.prefill_pool = None
        self.eager_prefills: collections.OrderedDict = \
            collections.OrderedDict()
        self.prefill_builds = 0

    @property
    def plan_book(self) -> PlanBook:
        """Per-model plan registry, primed from the param specs on first
        use, so prefill and decode resolve no plan."""
        if self._plan_book is None:
            book = PlanBook.from_tt_config(self.cfg.tt)
            book.prime(self.param_specs())
            self._plan_book = book
        return self._plan_book

    # ------------------------------------------------------------------ specs
    def param_specs(self) -> dict:
        cfg, dt = self.cfg, self.param_dtype
        specs: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
                       "final_norm": rmsnorm_spec(cfg.d_model, dt),
                       "lm_head": linear_spec(cfg.d_model, cfg.vocab_size,
                                              cfg.tt, "lm_head", dt)}
        for gi, g in enumerate(self.groups):
            specs[f"g{gi}"] = group_spec(cfg, g, dt)
        return specs

    def init(self, seed: int = 0) -> dict:
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_tree(self.param_specs(), gen, self.device)

    def quantize_params(self, params: dict) -> dict:
        """int8-quantize every TT core bundle (a checkpoint transform); the
        result is served by the same entry points through the int8
        kernel."""
        return quantize_tt_params(params)

    # ---------------------------------------------------------------- serving
    def _logits(self, params, x) -> torch.Tensor:
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        return linear_apply(params["lm_head"], x, self.plan_book).float()

    @torch.no_grad()
    def prefill(self, params, batch: dict, out: dict | None = None
                ) -> tuple[torch.Tensor, dict]:
        """Process the prompt ``batch["tokens"] [B,S]``; return
        (last-token logits [B,1,V] fp32, cache).  ``batch["cache_len"]``
        (default S) sizes the cache; ``cache["pos"]`` is a 0-d int32
        tensor on the model's device.

        ``batch["prompt_len"]`` (an int, or a 0-d integer tensor on the
        model's device) marks the true length of a prompt right-padded to
        a bucket (``bucket_length``): ``cache["pos"]`` is then prompt_len,
        not S, and the logits are those of position prompt_len - 1.  The
        padding's k/v rows lie beyond ``pos``, where every decode path
        masks them.  The last position is picked on the device, so the
        prefill reads nothing on the host and can be captured
        (``graphed_prefill``).

        ``out`` (a cache of ``init_cache(B, cache_len)``'s layout) receives
        the result in place: its k/v rows 0..S-1 are the prompt's, the rows
        past S are zeroed, and its ``pos`` is set, bit for bit what a fresh
        cache would hold."""
        tokens = batch["tokens"].to(self.device)
        x = embed_apply(params["embed"], tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        T = batch.get("cache_len", S)
        plen = batch.get("prompt_len", S)
        pos = (torch.empty((), dtype=torch.int32, device=self.device)
               if out is None else out["pos"])
        if isinstance(plen, torch.Tensor):
            pos.copy_(plen)
        elif not 0 < plen <= S:
            raise ValueError(f"prompt_len {plen} outside a prompt of {S}")
        else:
            pos.fill_(plen)
        cache: dict = {"pos": pos}
        for gi, g in enumerate(self.groups):
            x, cache[f"g{gi}"] = group_fwd(
                params[f"g{gi}"], g, self.cfg, x, positions, want_cache=True,
                T_cache=T, plans=self.plan_book,
                out=None if out is None else out[f"g{gi}"])
        last = x.index_select(1, (pos - 1).reshape(1))
        return self._logits(params, last), cache

    @torch.no_grad()
    def padded_prefill(self, params, tokens: torch.Tensor, prompt_len: int,
                       T: int, graph: bool = True
                       ) -> tuple[torch.Tensor, dict]:
        """The prefill of ``tokens [B,S]`` (right-padded past
        ``prompt_len``) into a cache of ``T`` positions, one entry per
        (B, S, T), the reference's ``jitted_prefill``.  On a CUDA model
        with ``graph``, a replay of ``graphed_prefill(B, S, T)``: the
        logits and the cache it returns are the graph's static buffers,
        which the next replay of that graph (logits) or of any prefill
        graph of the same (B, T) (cache) overwrites.  Otherwise the eager
        prefill, whose key counts in ``prefill_builds`` when it is new to
        the LRU of eager keys."""
        key = (*tokens.shape, T)
        if graph and self.device.type == "cuda":
            return self.graphed_prefill(*key)(params, tokens, prompt_len)
        if key not in self.eager_prefills:
            self.prefill_builds += 1
        _lru_put(self.eager_prefills, key, None)
        return self.prefill(params, {"tokens": tokens, "cache_len": T,
                                     "prompt_len": prompt_len})

    def bucketed_prefill(self, T: int, graph: bool = True):
        """Host wrapper around ``padded_prefill`` with prompt-length
        bucketing, the reference's ``jitted_prefill_bucketed``:
        ``call(params, batch)`` right-pads ``batch["tokens"] [B,S]`` with
        0 to ``bucket_length(S, T)`` and passes the true length S, so
        varied-length traffic makes O(log T) prefill entries instead of
        one per prompt length."""
        def call(params, batch: dict) -> tuple[torch.Tensor, dict]:
            tokens = batch["tokens"]
            S = int(tokens.shape[1])
            S_pad = bucket_length(S, T)
            if S_pad != S:
                tokens = F.pad(tokens, (0, S_pad - S))
            return self.padded_prefill(params, tokens, S, T, graph)
        return call

    def graphed_prefill(self, B: int, S: int, T: int) -> PrefillGraph:
        """The prefill of ``B`` prompts padded to ``S`` tokens into a cache
        of ``T`` positions as a CUDA graph (``models.graph.PrefillGraph``),
        captured at its first call and kept for the ``GRAPH_CACHE_SIZE``
        keys used last.  Every prefill graph of one (B, T) writes the same
        output cache (``prefill_caches``), dropped with the last of them."""
        key = (B, S, T)
        graph = self.prefill_graphs.get(key)
        if graph is None:
            graph = PrefillGraph(self, B, S, T)
        for b, _, t in _lru_put(self.prefill_graphs, key, graph):
            if not any(k[::2] == (b, t) for k in self.prefill_graphs):
                del self.prefill_caches[(b, t)]
        return graph

    @torch.no_grad()
    def decode_step(self, params, cache: dict, token: torch.Tensor,
                    active: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """token [B,1] → (logits [B,1,V] fp32, cache at ``pos + active``).

        ``cache["pos"]`` is an int32 tensor on the model's device: 0-d (the
        fixed batch, every row at one depth) or [B] (one depth per row, the
        scheduler's slot pool; a row at a position ≥ the cache length
        writes nothing).  ``active`` ([B] bool on the device, vector
        position only) freezes the rows it leaves out: they write no k/v
        and their position does not advance; without it every row advances
        by one.  The position advances on the device, and the KV tensors of
        ``cache`` are updated in place: the step reads no device value on
        the host, so it can be captured (``graphed_decode_step``).

        A cache carrying ``block_tables`` is the block-paged pool
        (``init_cache(..., paged=True)``): k/v are arenas addressed through
        each row's table, and an inactive row writes to the sentinel block,
        so a retired slot's stale table never touches storage a later
        request reuses."""
        pos = cache["pos"]
        bt = cache.get("block_tables")
        x = embed_apply(params["embed"], token.to(self.device))
        new_cache: dict = {"pos": pos + (1 if active is None
                                         else active.to(pos.dtype))}
        paged = None
        if bt is not None:
            new_cache["block_tables"] = bt
            arena = _kv_leaves(cache)[0]
            paged = paged_index(
                bt, pos, torch.ones(pos.shape, dtype=torch.bool,
                                    device=pos.device)
                if active is None else active, arena.shape[1],
                arena.shape[0] - 1)
        for gi, g in enumerate(self.groups):
            x, new_cache[f"g{gi}"] = group_decode(
                params[f"g{gi}"], g, self.cfg, x, cache[f"g{gi}"], pos,
                plans=self.plan_book, paged=paged, active=active)
        return self._logits(params, x), new_cache

    @torch.no_grad()
    def splice_cache(self, cache: dict, row_cache: dict, slot: int) -> None:
        """Write a one-row prefill cache (``row_cache``, batch 1, the pool's
        cache length) into row ``slot`` of the slot pool ``cache`` IN PLACE,
        and set ``cache["pos"][slot]`` to the prompt length the prefill
        left in ``row_cache["pos"]``: the scheduler's admission, the
        reference's ``splice_cache`` (which returns an updated copy).  The
        batch axis is axis 0 of every KV leaf."""
        pool, rows = _kv_leaves(cache), _kv_leaves(row_cache)
        if cache["pos"].dim() != 1 or [(t.shape[1:], t.dtype)
                                       for t in pool] != [
                (t.shape[1:], t.dtype) for t in rows] or any(
                t.shape[0] != 1 for t in rows):
            raise ValueError("splice_cache takes a one-row cache of the "
                             "pool's layout into a pool with a per-row "
                             "position")
        for dst, src in zip(pool, rows):
            dst[slot].copy_(src[0])
        cache["pos"][slot].copy_(row_cache["pos"])

    @torch.no_grad()
    def splice_cache_paged(self, cache: dict, row_cache: dict, slot: int,
                           blocks: torch.Tensor) -> None:
        """Paged twin of ``splice_cache``: scatter a one-row dense prefill
        cache (at the pool's logical cache length) into the arena blocks
        named by ``blocks`` [max_blocks] int32 (the slot's full table row,
        sentinel-padded past its allocation: the rows scattered there
        collapse onto the scratch block), and set row ``slot``'s table and
        position, IN PLACE (the reference returns an updated copy)."""
        bt = cache["block_tables"]
        if cache["pos"].dim() != 1 or tuple(blocks.shape) != bt.shape[1:]:
            raise ValueError(f"splice_cache_paged takes a table row of "
                             f"{bt.shape[1]} blocks into a paged pool")
        idx = blocks.to(device=bt.device, dtype=torch.long)
        for arena, row in zip(_kv_leaves(cache), _kv_leaves(row_cache)):
            blk = arena.shape[1]
            r = row[0]                                # [T_row, KV, hd]
            nblk = -(-r.shape[0] // blk)
            if nblk * blk != r.shape[0]:
                r = F.pad(r, (0, 0, 0, 0, 0, nblk * blk - r.shape[0]))
            arena.index_put_((idx[:nblk],),
                             r.reshape(nblk, blk, *r.shape[1:]).to(
                                 arena.dtype))
        cache["pos"][slot].copy_(row_cache["pos"])
        bt[slot].copy_(idx)

    @torch.no_grad()
    def prefill_resume(self, params, tokens: torch.Tensor, cache: dict, slot,
                       src_blocks, dst_blocks, start, true_suf
                       ) -> tuple[torch.Tensor, dict]:
        """Prefix-reuse admission (DESIGN.md §7): prefill only the suffix
        ``tokens [1, S_pad]`` (right-padded, ``true_suf`` real) from the
        absolute position ``start``; the covered prefix is gathered from
        the resident arena blocks through ``src_blocks`` [max_blocks] and
        never recomputed, and the updated logical cache is scattered back
        through ``dst_blocks`` (an entry that differs from ``src_blocks`` is
        a copy-on-write block).  Row ``slot`` of the pool gets position
        start + true_suf and table ``dst_blocks``.  The pool ``cache`` is
        updated IN PLACE.  ``slot``, ``start`` and ``true_suf`` are ints or
        0-d integer tensors on the device, the tables int32 tensors there:
        with tensors nothing is read on the host, so the resume can be
        captured (``models.graph.ResumeGraph``); a ``slot`` outside the pool
        updates no row's position or table.  Returns (logits [1,1,V] fp32
        of position start + true_suf - 1, cache)."""
        dev = self.device

        def index(v):
            return torch.as_tensor(v, dtype=torch.int32, device=dev)

        slot, start, true_suf = index(slot), index(start), index(true_suf)
        src, dst = index(src_blocks), index(dst_blocks)
        x = embed_apply(params["embed"], tokens.to(dev))
        for gi, g in enumerate(self.groups):
            x, cache[f"g{gi}"] = group_resume(
                params[f"g{gi}"], g, self.cfg, x, cache[f"g{gi}"], src, dst,
                start, plans=self.plan_book)
        pos, bt = cache["pos"], cache["block_tables"]
        row = torch.arange(pos.shape[0], device=dev) == slot
        pos.copy_(torch.where(row, start + true_suf, pos))
        bt.copy_(torch.where(row[:, None], dst[None, :], bt))
        last = x.index_select(1, (true_suf - 1).reshape(1))
        return self._logits(params, last), cache

    def resume_prefill(self, params, cache: dict, tokens: torch.Tensor,
                       slot: int, src_blocks: torch.Tensor,
                       dst_blocks: torch.Tensor, start: int,
                       graph: DecodeGraph | None = None) -> torch.Tensor:
        """Host wrapper around ``prefill_resume`` with the suffix ``tokens
        [1, S]`` right-padded to ``bucket_length(S, T)`` (T the pool's
        logical length), the reference's ``jitted_prefill_resume``: one
        entry per suffix bucket.  With ``graph`` (the bound paged slot-pool
        ``DecodeGraph`` whose static cache is ``cache``), a replay of its
        captured resume for the bucket (``DecodeGraph.resume``); otherwise
        the eager resume, whose (bucket, T) key counts in
        ``prefill_builds`` when it is new to the LRU of eager keys.
        Returns the logits [1,1,V]; on a replay, the graph's static ones."""
        S = int(tokens.shape[1])
        T = cache["block_tables"].shape[1] * _kv_leaves(cache)[0].shape[1]
        S_pad = bucket_length(S, T)
        tokens = tokens.to(self.device)
        if S_pad != S:
            tokens = F.pad(tokens, (0, S_pad - S))
        if graph is not None:
            return graph.resume(tokens, slot, src_blocks, dst_blocks, start,
                                S)
        key = ("resume", S_pad, T)
        if key not in self.eager_prefills:
            self.prefill_builds += 1
        _lru_put(self.eager_prefills, key, None)
        return self.prefill_resume(params, tokens, cache, slot, src_blocks,
                                   dst_blocks, start, S)[0]

    @torch.no_grad()
    def chunk_step(self, params, cache: dict, tokens: torch.Tensor, slot,
                   start, true_len, active, table=None
                   ) -> tuple[torch.Tensor, dict]:
        """One prefill chunk of one slot, IN PLACE in the serving pool
        (dense slots, or paged with ``table``), the reference's
        ``chunk_step``.

        ``tokens`` [1, C] (rows >= ``true_len`` are right-padding) are the
        prompt slice [start, start + true_len); ``slot``, ``start``,
        ``true_len`` (0-d int32) and ``active`` (0-d bool) are tensors on
        the device, ``table`` [max_blocks] int32 the slot's block table
        (None: the dense pool; all sentinel when ``active`` is False).
        When ``active``, row ``slot``'s position becomes start + true_len
        and, paged, its table ``table``; an inactive lane changes nothing.
        Nothing is read on the host, so the step can be captured
        (``models.graph.MixedGraph``).  Returns (logits [1,1,V] fp32 of
        position start + true_len - 1, picked on the device, cache).  Ints
        are taken too, for an eager call."""
        dev = self.device

        def index(v, dtype=torch.int32):
            return torch.as_tensor(v, dtype=dtype, device=dev)

        slot, start, true_len = index(slot), index(start), index(true_len)
        active = index(active, torch.bool)
        if table is not None:
            table = index(table)
        x = embed_apply(params["embed"], tokens.to(dev))
        for gi, g in enumerate(self.groups):
            x, cache[f"g{gi}"] = group_chunk(
                params[f"g{gi}"], g, self.cfg, x, cache[f"g{gi}"], slot,
                table, start, active, plans=self.plan_book)
        pos = cache["pos"]
        row = (torch.arange(pos.shape[0], device=pos.device) == slot) & \
            active
        pos.copy_(torch.where(row, start + true_len, pos))
        if table is not None:
            bt = cache["block_tables"]
            bt.copy_(torch.where(row[:, None], table[None, :], bt))
        last = x.index_select(1, (true_len - 1).reshape(1))
        return self._logits(params, last), cache

    @torch.no_grad()
    def mixed_step(self, params, cache: dict, token: torch.Tensor,
                   active: torch.Tensor, ck_tokens: torch.Tensor, ck_slot,
                   ck_start, ck_true, ck_active, ck_tables=None
                   ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The chunked-prefill serving step, the reference's
        ``mixed_step``: K prefill-chunk lanes (``chunk_step`` each), then
        the masked decode step (``decode_step`` with ``active``), in this
        order, so a lane that finishes its prompt decodes the next step.

        ck_tokens [K, C], ck_slot/ck_start/ck_true [K] int32, ck_active [K]
        bool and ck_tables [K, max_blocks] int32 (paged pools only; an
        unused lane's row all sentinel) are tensors on the device.  Returns
        (decode logits [B,1,V], chunk logits [K,V] at each lane's last true
        position, the decode step's cache at ``pos + active``)."""
        ck_logits = []
        for j in range(ck_tokens.shape[0]):
            lg, cache = self.chunk_step(
                params, cache, ck_tokens[j:j + 1], ck_slot[j], ck_start[j],
                ck_true[j], ck_active[j],
                None if ck_tables is None else ck_tables[j])
            ck_logits.append(lg[0, 0])
        logits, cache = self.decode_step(params, cache, token, active)
        return logits, torch.stack(ck_logits), cache

    @torch.no_grad()
    def copy_blocks(self, cache: dict, src: int, dst: int) -> None:
        """Copy arena block ``src`` into block ``dst`` in every layer's k
        and v, IN PLACE: the eager copy-on-write of a chunked admission
        whose prefix covers the whole prompt (its last block is about to be
        partly rewritten through the slot's own table); the reference's
        ``copy_blocks``, which returns an updated copy."""
        for arena in _kv_leaves(cache):
            arena[dst].copy_(arena[src])

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill covers the ported mixer, full-attention GQA
        (``transformer.block_chunk``)."""
        return all(bd.mixer == "gqa" for period, _ in self.groups
                   for bd in period)

    @property
    def supports_prefix_reuse(self) -> bool:
        """Prefix blocks are shareable when every cache leaf is a pure
        function of the token prefix and never overwritten in place: true
        of full attention, the ported mixer (the reference also says no
        for window rings, SSM state and frontends, not ported)."""
        return all(kind == "paged" for period, _ in self.groups
                   for bd in period for kind in block_cache_kinds(bd).values())

    def paged_cache_shapes(self, num_slots: int, num_blocks: int,
                           block: int, cache_len: int,
                           dtype: torch.dtype | None = None) -> dict:
        """(shape, dtype) tree of a block-paged pool (DESIGN.md §7): every
        layer's k and v are arenas [num_blocks + 1, block, KV, hd] shared by
        all slots through per-slot block tables; ``pos`` is [num_slots] and
        ``block_tables`` [num_slots, ceil(cache_len / block)], both int32.
        One arena per layer, in the per-layer list (the reference stacks
        them [layers, ...])."""
        dtype = self.param_dtype if dtype is None else dtype
        max_blocks = -(-cache_len // block)
        out: dict = {"pos": ((num_slots,), torch.int32),
                     "block_tables": ((num_slots, max_blocks), torch.int32)}
        for gi, (period, count) in enumerate(self.groups):
            out[f"g{gi}"] = [
                {f"b{i}": block_paged_cache_shape(self.cfg, bd, num_blocks,
                                                  block, dtype)
                 for i, bd in enumerate(period)} for _ in range(count)]
        return out

    def init_cache(self, B: int, T: int, dtype: torch.dtype | None = None,
                   per_row: bool = False, *, paged: bool = False,
                   num_blocks: int | None = None, block: int = 64) -> dict:
        """Zeroed decode cache for ``B`` rows and ``T`` positions, k/v in
        ``dtype`` (default: the parameters', which is what ``prefill``
        writes).  ``per_row`` gives the scheduler's slot pool a position
        per row ([B] int32); otherwise the position is 0-d.  ``paged=True``
        builds the block-paged pool of ``B`` slots instead
        (``paged_cache_shapes``; ``num_blocks`` defaults to B ·
        ceil(T / block)), its block tables filled with the sentinel id
        ``num_blocks``."""
        cfg = self.cfg
        dtype = self.param_dtype if dtype is None else dtype
        if paged:
            if num_blocks is None:
                num_blocks = B * -(-T // block)
            shapes = self.paged_cache_shapes(B, num_blocks, block, T, dtype)
            cache = map_tree(lambda sd: torch.zeros(
                sd[0], dtype=sd[1], device=self.device), shapes)
            cache["block_tables"].fill_(num_blocks)
            return cache
        shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
        cache: dict = {"pos": torch.zeros((B,) if per_row else (),
                                          dtype=torch.int32,
                                          device=self.device)}
        for gi, (period, count) in enumerate(self.groups):
            cache[f"g{gi}"] = [
                {f"b{i}": {n: torch.zeros(shape, dtype=dtype,
                                          device=self.device)
                           for n in ("k", "v")}
                 for i in range(len(period))}
                for _ in range(count)]
        return cache

    def graphed_decode_step(self, B: int, T: int, masked: bool = False,
                            paged: tuple[int, int] | None = None
                            ) -> DecodeGraph:
        """The decode step of a ``B``-row batch over a cache of ``T``
        positions as a CUDA graph (``models.graph.DecodeGraph``), made once
        per model and shape and kept for the ``GRAPH_CACHE_SIZE`` shapes
        used last, as the reference keeps its jitted steps.  ``masked``
        gives the scheduler's slot-pool step (a position and an ``active``
        flag per row), captured when a scheduler first binds it; otherwise
        the fixed-batch step, captured at its first ``load``.  ``paged`` =
        (num_blocks, block) makes the slot pool block-paged
        (``init_cache(..., paged=True)``; masked only).  No two of these
        share an entry."""
        if paged is not None and not masked:
            raise ValueError("a paged pool is the scheduler's: masked only")
        key = (B, T, masked) if paged is None else (B, T, masked, paged)
        graph = self.decode_graphs.get(key)
        if graph is None:
            graph = DecodeGraph(self, B, T, masked, paged)
        _lru_put(self.decode_graphs, key, graph)
        return graph


def _lru_put(lru: collections.OrderedDict, key, value) -> list:
    """Make ``key`` → ``value`` the most recent entry of ``lru``; return
    the keys evicted to keep it within ``GRAPH_CACHE_SIZE``."""
    lru[key] = value
    lru.move_to_end(key)
    evicted = []
    while len(lru) > GRAPH_CACHE_SIZE:
        evicted.append(lru.popitem(last=False)[0])
    return evicted


def _kv_leaves(cache: dict) -> list[torch.Tensor]:
    """A cache's k/v tensors (or arenas) in a fixed order (every leaf but
    ``pos`` and ``block_tables``)."""
    return tree_leaves({k: v for k, v in cache.items()
                        if k not in ("pos", "block_tables")})
