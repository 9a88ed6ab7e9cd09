"""Model facade: parameter specs and init, ``prefill`` (exact, padded to
a prompt-length bucket, or captured: ``padded_prefill``,
``bucketed_prefill``, ``graphed_prefill``), ``decode_step``,
``splice_cache``, ``graphed_decode_step``, ``init_cache`` and
``quantize_params`` for the decoders (gemma3's sliding-window
ring caches and tied, scaled embeddings, mixtral's mixture-of-experts
FFN, deepseek-v2's latent-cache MLA, mamba2's SSD mixer over a
per-slot recurrent state, and jamba's hybrid of the two, included) and
for seamless's encoder-decoder (``_encode`` over the speech frames the
prefill takes as ``batch["speech_embeds"]``, the decoder cross-attending
to the encoder's keys and values, kept per row in the cache), and for
internvl2's vision-language decoder (the image embeddings the prefill
takes as ``batch["image_embeds"]``, projected and prepended to the
prompt's token embeddings: plain k/v rows of its cache); and for the
block-paged pool (DESIGN.md §7), ``init_cache(..., paged=True)``,
``splice_cache_paged`` and the prefix-reuse admission ``prefill_resume``
(``resume_prefill`` buckets it and, on a card, replays it captured); and
for chunked prefill (DESIGN.md §15), over either pool, ``chunk_step``,
``mixed_step`` (on a card replayed as ``models.graph.MixedGraph``) and
``copy_blocks``.

Parameters are a dict tree of tensors: ``embed``, ``final_norm``,
``lm_head`` (none with tied embeddings: the logits are ``x @ embed.T``)
and one list per layer group ``g{gi}`` holding a dict ``{"b0": ..., "b1":
...}`` of block params per layer; an encoder-decoder also ``enc_norm``,
one list per encoder group ``enc_g{gi}`` and the dense ``frontend_proj``
[frontend_dim, d_model] of the speech frames; a vision-language model the
dense ``projector`` [frontend_dim, d_model] of the image embeddings.
``convert.from_jax_params`` builds this tree from the reference's stacked one.
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
from .moe import drop_counter
from .spec import init_tree, map_tree, tree_leaves
from .transformer import (Group, block_cache_kinds, block_cache_shape,
                          block_paged_cache_shape, group_chunk, group_decode,
                          group_fwd, group_resume, group_spec)


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
    """One decoder (GQA full-attention, windowed or local/global, or MLA,
    with a GLU MLP or a mixture-of-experts FFN in each block; Mamba-2 SSD
    blocks with no FFN; or the hybrid of SSD and GQA blocks, each with an
    FFN).  ``device=None`` means the GPU; pass ``device="cpu"`` for
    the plain path.

    Each cache leaf has a kind (``transformer.block_cache_kinds``), and
    each kind its own rule in a paged pool: 'paged' and 'ring' leaves are
    block arenas, scattered through a slot's table and copied by
    ``copy_blocks``; 'slot' leaves (an SSM's state and conv history) keep
    one row per slot, spliced into it and never touched by a block copy.
    A pool with no arena (mamba2) still keeps its tables: the scheduler's
    block accounting runs as the reference's does.  A pool with both
    (jamba: arenas for its GQA layers, 'slot' leaves for its SSD layers)
    takes its geometry from the arenas and keeps each kind to its rule.

    An encoder-decoder (``enc_groups``, seamless) keeps its decoder's
    cross-attention keys and values xk/xv [B, F, KV, hd] as 'slot' leaves:
    every cache, pool and graph of it is sized by a frame count F
    (``enc_T``), which the keys of its captured graphs and prefill caches
    carry as their last element (``enc_key``).

    A vision-language model (``frontend="vit"``, internvl2) prepends its
    prompt's projected image embeddings to the token embeddings: its
    image rows are plain k/v rows at positions 0..S_img-1, so its caches,
    pools and decode graphs are every decoder's, and only the prefill
    counts them: its position, its bucket (``bucketed_prefill``) and the
    key of its captured graph (``embeds_key``)."""

    def __init__(self, cfg: ModelConfig, groups: list[Group],
                 param_dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 enc_groups: list[Group] | None = None):
        self.cfg = cfg
        self.groups = groups
        self.enc_groups = enc_groups
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        # full fp32 matmuls on the card: TF32 would change the numbers the
        # port is held to against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._plan_book: PlanBook | None = None
        # captured decode steps per (batch, cache length, masked[, paged],
        # [frames]), least
        # recently used first; the captures made and the TT launches the
        # replays (of decode steps and prefills) made, by kernel name (no
        # wrapper runs on a replay)
        self.decode_graphs: collections.OrderedDict = \
            collections.OrderedDict()
        self.graph_captures = 0
        self.replayed_launches: collections.Counter = collections.Counter()
        # captured prefills per (batch, padded length, cache length,
        # [frames]), least recently used first; their output caches per
        # (batch, cache length, [frames]), shared by those buckets; the
        # memory pool of their temporaries, shared by all of them; the
        # eager prefills' keys, in an LRU of their own; and the reference's ``prefill_builds``: new
        # prefill entries, a capture or an eager key seen first
        self.prefill_graphs: collections.OrderedDict = \
            collections.OrderedDict()
        self.prefill_caches: dict = {}
        self.prefill_pool = None
        self.eager_prefills: collections.OrderedDict = \
            collections.OrderedDict()
        self.prefill_builds = 0
        # the device's drop counter exists before any capture records it
        if self.has_moe:
            drop_counter(self.device)

    @property
    def has_moe(self) -> bool:
        """Whether a block's FFN is a mixture of experts (its dropped
        assignments are counted on the device, ``moe.read_drops``)."""
        return any(bd.ffn == "moe" for period, _ in self.groups
                   for bd in period)

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
                       "final_norm": rmsnorm_spec(cfg.d_model, dt)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = linear_spec(cfg.d_model, cfg.vocab_size,
                                           cfg.tt, "lm_head", dt)
        for gi, g in enumerate(self.groups):
            specs[f"g{gi}"] = group_spec(cfg, g, dt)
        if self.enc_groups is not None:
            specs["enc_norm"] = rmsnorm_spec(cfg.d_model, dt)
            for gi, g in enumerate(self.enc_groups):
                specs[f"enc_g{gi}"] = group_spec(cfg, g, dt)
        if cfg.frontend == "vit":
            specs["projector"] = linear_spec(cfg.frontend_dim, cfg.d_model,
                                             None, "frontend", dt)
        if cfg.frontend == "speech":
            specs["frontend_proj"] = linear_spec(cfg.frontend_dim,
                                                 cfg.d_model, None,
                                                 "frontend", dt)
        return specs

    def init(self, seed: int = 0) -> dict:
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_tree(self.param_specs(), gen, self.device)

    def quantize_params(self, params: dict) -> dict:
        """int8-quantize every TT core bundle (a checkpoint transform), each
        expert of a stack on its own scales; the result is served by the
        same entry points through the int8 kernel."""
        return quantize_tt_params(params)

    # ---------------------------------------------------------------- serving
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings, scaled by sqrt(d) when they are tied (every
        path that embeds tokens comes here)."""
        cfg = self.cfg
        return embed_apply(params["embed"], tokens.to(self.device),
                           cfg.d_model, scale=cfg.tie_embeddings)

    def _project(self, params, images: torch.Tensor) -> torch.Tensor:
        """The dense ``projector`` of a vision-language model's image
        embeddings ``images [B, S_img, frontend_dim]`` (the reference's
        ``linear_apply`` outside any kernel), in the parameters' dtype: the
        images take it first, as jnp promotes bf16 embeddings under fp32
        parameters (exactly) and keeps them under bf16 ones."""
        w = params["projector"]["w"]
        return linear_apply(params["projector"],
                            images.to(device=self.device, dtype=w.dtype))

    @property
    def front_input(self) -> str | None:
        """The key of the front end's embeddings in a batch or a request's
        inputs: ``"speech_embeds"`` (an encoder-decoder's frames),
        ``"image_embeds"`` (a vision-language model's images) or None."""
        return {"speech": "speech_embeds",
                "vit": "image_embeds"}.get(self.cfg.frontend)

    def front_embeds(self, inputs: dict) -> torch.Tensor | None:
        """The front end's embeddings [B, n, frontend_dim] in ``inputs``,
        None for a model without a front end; a model with one raises
        ValueError without them."""
        key = self.front_input
        if key is None:
            return None
        if key not in inputs:
            raise ValueError(f"{self.cfg.name} prefills its front end's "
                             f"embeddings: {key} [B, n, "
                             f"{self.cfg.frontend_dim}]")
        return inputs[key]

    def image_rows(self, inputs: dict) -> int:
        """The image rows a vision-language model's prompt in ``inputs``
        puts before its tokens (``image_embeds [B, S_img, frontend_dim]``),
        which its cache position, its bucket and every bound on its prompt
        count; 0 for every other model."""
        if self.cfg.frontend != "vit":
            return 0
        return int(self.front_embeds(inputs).shape[1])

    def embeds_key(self, n: int) -> tuple:
        """The front end's part of a captured prefill's key: ``(n,)`` for
        a model with a front end (the frames or images of its embeddings),
        and ``()`` for every other model, which takes none."""
        if self.cfg.frontend is None:
            if n:
                raise ValueError(f"{self.cfg.name} has no front end: {n} "
                                 f"front-end rows")
            return ()
        return (n,)

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the speech frames ``frames [B, F,
        frontend_dim]``: the dense ``frontend_proj``, positions 0..F-1
        through the non-causal encoder groups, ``enc_norm``.  The frames
        take the parameters' dtype first, as jnp promotes bf16 frames
        under fp32 parameters (exactly) and keeps them under bf16 ones."""
        w = params["frontend_proj"]["w"]
        x = linear_apply(params["frontend_proj"],
                         frames.to(device=self.device, dtype=w.dtype))
        B, F, _ = x.shape
        positions = torch.arange(F, device=self.device).expand(B, F)
        for gi, g in enumerate(self.enc_groups):
            x, _ = group_fwd(params[f"enc_g{gi}"], g, self.cfg, x, positions,
                             want_cache=False, plans=self.plan_book)
        return rmsnorm_apply(params["enc_norm"], x, self.cfg.norm_eps)

    def enc_key(self, enc_T: int) -> tuple:
        """The frame count's part of a cache's, a pool's or a graph's key:
        ``(enc_T,)`` for an encoder-decoder, which needs one > 0, and ``()``
        for every other model, which takes none."""
        if self.cfg.enc_dec != (enc_T > 0):
            raise ValueError(
                f"{self.cfg.name}: frame count {enc_T}; an encoder-decoder's "
                f"caches need the frames' count, no other model's take one")
        return (enc_T,) if enc_T else ()

    def _logits(self, params, x) -> torch.Tensor:
        x = rmsnorm_apply(params["final_norm"], x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return (x @ params["embed"]["table"].T).float()
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

        An encoder-decoder first encodes ``batch["speech_embeds"] [B, F,
        frontend_dim]`` (``_encode``, at its own F whatever the tokens'
        padding); its cache keeps the encoder's keys and values of every
        decoder layer, xk/xv [B, F, KV, hd].  A vision-language model
        prepends the projection of ``batch["image_embeds"] [B, S_img,
        frontend_dim]`` (``_project``) to the token embeddings: the prompt
        is S_img + S rows at positions 0..S_img+S-1, and ``prompt_len``
        (default S_img + S) counts the image rows, as the reference's
        does.

        ``out`` (a cache of ``init_cache(B, cache_len, enc_T=F)``'s layout)
        receives the result in place: its full-attention k/v rows 0..S-1
        are the prompt's, the rows past S are zeroed, each window ring
        holds the last positions of the true prompt
        (``transformer.block_fwd``), xk/xv are the frames', and its ``pos``
        is set, bit for bit what a fresh cache would hold."""
        enc_out = None
        if self.cfg.enc_dec:
            if "speech_embeds" not in batch:
                raise ValueError(f"{self.cfg.name} prefills speech frames: "
                                 f"batch['speech_embeds'] [B, F, "
                                 f"{self.cfg.frontend_dim}]")
            enc_out = self._encode(params, batch["speech_embeds"])
        x = self._embed(params, batch["tokens"])
        if self.cfg.frontend == "vit":
            img = self._project(params, self.front_embeds(batch))
            x = torch.cat([img.to(x.dtype), x], 1)
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
                out=None if out is None else out[f"g{gi}"], true_len=pos,
                enc_out=enc_out)
        last = x.index_select(1, (pos - 1).reshape(1))
        return self._logits(params, last), cache

    @torch.no_grad()
    def padded_prefill(self, params, tokens: torch.Tensor, prompt_len: int,
                       T: int, graph: bool = True,
                       embeds: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, dict]:
        """The prefill of ``tokens [B,S]`` (right-padded past
        ``prompt_len``) into a cache of ``T`` positions, one entry per
        (B, S, T) and, for a model with a front end, per row count n of
        its embeddings ``embeds [B, n, frontend_dim]`` (an
        encoder-decoder's speech frames, or a vision-language model's
        images, whose n rows ``prompt_len`` counts): the reference's
        ``jitted_prefill``.  On a CUDA model with ``graph``, a replay of
        ``graphed_prefill(B, S, T, n)``: the logits and the cache it
        returns are the graph's static buffers, which the next replay of
        that graph (logits) or of any prefill graph of the same cache key
        (``prefill_cache_key``) overwrites.  Otherwise the eager prefill,
        whose key counts in ``prefill_builds`` when it is new to the LRU
        of eager keys."""
        n = 0 if embeds is None else int(embeds.shape[1])
        key = (*tokens.shape, T) + self.embeds_key(n)
        if self.front_input is not None and embeds is None:
            raise ValueError(f"{self.cfg.name} prefills its front end's "
                             f"embeddings: {self.front_input}")
        if graph and self.device.type == "cuda":
            return self.graphed_prefill(*key)(params, tokens, prompt_len,
                                              embeds)
        if key not in self.eager_prefills:
            self.prefill_builds += 1
        _lru_put(self.eager_prefills, key, None)
        batch = {"tokens": tokens, "cache_len": T, "prompt_len": prompt_len}
        if embeds is not None:
            batch[self.front_input] = embeds
        return self.prefill(params, batch)

    def bucketed_prefill(self, T: int, graph: bool = True):
        """Host wrapper around ``padded_prefill`` with prompt-length
        bucketing, the reference's ``jitted_prefill_bucketed``:
        ``call(params, batch)`` right-pads ``batch["tokens"] [B,S]`` with
        0 to ``bucket_length(S, T)`` and passes the true length S, so
        varied-length traffic makes O(log T) prefill entries instead of
        one per prompt length.  An encoder-decoder's speech frames
        (``batch["speech_embeds"]``) are not padded: the encoder runs at
        their own count.  Nor are a vision-language model's S_img image
        rows (``batch["image_embeds"]``): the tokens are padded to
        ``bucket_length(S, T - S_img)``, and the true length passed is
        S_img + S, as the reference's."""
        def call(params, batch: dict) -> tuple[torch.Tensor, dict]:
            tokens = batch["tokens"]
            S = int(tokens.shape[1])
            img = self.image_rows(batch)
            S_pad = bucket_length(S, T - img)
            if S_pad != S:
                tokens = F.pad(tokens, (0, S_pad - S))
            return self.padded_prefill(params, tokens, img + S, T, graph,
                                       self.front_embeds(batch))
        return call

    def graphed_prefill(self, B: int, S: int, T: int, n: int = 0
                        ) -> PrefillGraph:
        """The prefill of ``B`` prompts padded to ``S`` tokens into a cache
        of ``T`` positions (with ``n`` rows of the front end's embeddings:
        an encoder-decoder's frames, a vision-language model's images) as
        a CUDA graph (``models.graph.PrefillGraph``), captured at its first
        call and kept for the ``GRAPH_CACHE_SIZE`` keys used last.  Every
        prefill graph of one ``prefill_cache_key`` writes the same output
        cache (``prefill_caches``), dropped with the last of them."""
        key = (B, S, T) + self.embeds_key(n)
        graph = self.prefill_graphs.get(key)
        if graph is None:
            graph = PrefillGraph(self, B, S, T, n)
        for old in _lru_put(self.prefill_graphs, key, graph):
            ck = self.prefill_cache_key(*old)
            if not any(self.prefill_cache_key(*k) == ck
                       for k in self.prefill_graphs):
                del self.prefill_caches[ck]
        return graph

    def prefill_cache_key(self, B: int, S: int, T: int, n: int = 0
                          ) -> tuple:
        """The key of the output cache that the prefill graph of key (B,
        S, T[, n]) writes: (B, T), and an encoder-decoder's frame count,
        which sizes its xk/xv; a vision-language model's image rows lie
        within its T positions."""
        return (B, T) + self.enc_key(n if self.cfg.enc_dec else 0)

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
        request reuses.  One ``attention.PagedIndex`` is built per window
        of the attention blocks (none for a pool with no arena); 'slot'
        leaves are row-indexed in both layouts."""
        pos = cache["pos"]
        bt = cache.get("block_tables")
        x = self._embed(params, token)
        new_cache: dict = {"pos": pos + (1 if active is None
                                         else active.to(pos.dtype))}
        paged = None
        if bt is not None:
            new_cache["block_tables"] = bt
            act = (torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
                   if active is None else active)
            geo = self.arena_geometry(cache) if self.windows else None
            paged = {w: paged_index(bt, pos, act, geo[1], geo[0], w)
                     for w in self.windows}
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
        batch axis is axis 0 of every leaf, of each kind."""
        pool, rows = _cache_leaves(cache), _cache_leaves(row_cache)
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
        position, IN PLACE (the reference returns an updated copy).  A
        'slot' leaf is copied into row ``slot``, as the dense splice does."""
        bt = cache["block_tables"]
        if cache["pos"].dim() != 1 or tuple(blocks.shape) != bt.shape[1:]:
            raise ValueError(f"splice_cache_paged takes a table row of "
                             f"{bt.shape[1]} blocks into a paged pool")
        idx = blocks.to(device=bt.device, dtype=torch.long)
        for dst, src in zip(self.slot_leaves(cache),
                            self.slot_leaves(row_cache)):
            dst[slot].copy_(src[0])
        for arena, row in zip(self.arena_leaves(cache),
                              self.arena_leaves(row_cache)):
            blk = arena.shape[1]
            r = row[0]                          # [T_row, KV, hd] or [T_row, L]
            nblk = -(-r.shape[0] // blk)
            if nblk * blk != r.shape[0]:
                r = F.pad(r, (0, 0) * (r.dim() - 1) +
                          (0, nblk * blk - r.shape[0]))
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
        x = self._embed(params, tokens)
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
        T = cache["block_tables"].shape[1] * self.arena_geometry(cache)[1]
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
        x = self._embed(params, tokens)
        for gi, g in enumerate(self.groups):
            x, cache[f"g{gi}"] = group_chunk(
                params[f"g{gi}"], g, self.cfg, x, cache[f"g{gi}"], slot,
                table, start, true_len, active, plans=self.plan_book)
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
        """Copy arena block ``src`` into block ``dst`` in every layer's
        arenas (rings too, as the reference copies them), IN PLACE: the
        eager copy-on-write of a chunked admission
        whose prefix covers the whole prompt (its last block is about to be
        partly rewritten through the slot's own table); the reference's
        ``copy_blocks``, which returns an updated copy.  'slot' leaves are
        left alone: their index is a slot, not a block."""
        for arena in self.arena_leaves(cache):
            arena[dst].copy_(arena[src])

    def _kind_leaves(self, cache: dict, slot: bool) -> list[torch.Tensor]:
        """The cache's leaves of kind 'slot' (``slot``) or of the pageable
        kinds, in a fixed order, by ``transformer.block_cache_kinds``."""
        out = []
        for gi, (period, _) in enumerate(self.groups):
            kinds = [block_cache_kinds(bd) for bd in period]
            for layer in cache[f"g{gi}"]:
                for i, ks in enumerate(kinds):
                    out += [layer[f"b{i}"][n] for n, kind in ks.items()
                            if (kind == "slot") == slot]
        return out

    def arena_leaves(self, cache: dict) -> list[torch.Tensor]:
        """The 'paged' and 'ring' leaves of ``cache``: block arenas in a
        paged pool, [B, T, ...] tensors in a dense one."""
        return self._kind_leaves(cache, slot=False)

    def slot_leaves(self, cache: dict) -> list[torch.Tensor]:
        """The 'slot' leaves of ``cache``: [B or num_slots, ...] in either
        layout."""
        return self._kind_leaves(cache, slot=True)

    def arena_geometry(self, cache: dict) -> tuple[int, int]:
        """(num_blocks, block) of a paged pool, from its arenas (the write
        sentinel is their last block).  A pool with no arena has none: its
        device side never addresses a block."""
        arenas = self.arena_leaves(cache)
        if not arenas:
            raise ValueError("the paged pool holds no arena")
        return arenas[0].shape[0] - 1, arenas[0].shape[1]

    @property
    def windows(self) -> list[int]:
        """The distinct windows of the attention blocks (0: full attention),
        each with its own ``PagedIndex`` per paged decode step; none for an
        attention-free model."""
        return sorted({bd.window for period, _ in self.groups
                       for bd in period if bd.mixer != "ssm"})

    @property
    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill covers the ported mixers, GQA with full attention
        or a window ring, MLA and the SSM (``transformer.block_chunk``),
        but no model with a front end: an encoder-decoder's
        cross-attention and a vision-language model's image prefix keep
        their admission monolithic, as the reference's."""
        return self.cfg.frontend is None and not self.cfg.enc_dec and all(
            bd.mixer in ("gqa", "mla", "ssm")
            for period, _ in self.groups for bd in period)

    @property
    def supports_prefix_reuse(self) -> bool:
        """Prefix blocks are shareable when every cache leaf is a pure
        function of the token prefix and never overwritten in place: true
        of full attention and of MLA's latent leaves, not of a window ring,
        whose contents cycle, nor of an SSM's 'slot' state, a summary of
        the whole history, nor of an encoder-decoder, whose cache also
        depends on the frames (the reference says no for every front
        end)."""
        return self.cfg.frontend is None and all(
            kind == "paged" for period, _ in self.groups for bd in period
            for kind in block_cache_kinds(bd).values())

    def paged_cache_shapes(self, num_slots: int, num_blocks: int,
                           block: int, cache_len: int,
                           dtype: torch.dtype | None = None,
                           enc_T: int = 0) -> dict:
        """(shape, dtype) tree of a block-paged pool (DESIGN.md §7): every
        layer's k and v are arenas [num_blocks + 1, block, KV, hd] (MLA's
        ckv and krope [num_blocks + 1, block, kv_lora | rope_hd]) shared by
        all slots through per-slot block tables (a window ring through the
        low entries of its slot's table); an SSM layer's state (fp32
        whatever ``dtype`` is) and conv history stay [num_slots, ...], as
        do a cross-attending layer's xk/xv [num_slots, enc_T, KV, hd];
        ``pos`` is [num_slots] and ``block_tables`` [num_slots,
        ceil(cache_len / block)], both int32.  One arena per layer, in the
        per-layer list (the reference stacks them [layers, ...])."""
        dtype = self.param_dtype if dtype is None else dtype
        self.enc_key(enc_T)
        max_blocks = -(-cache_len // block)
        out: dict = {"pos": ((num_slots,), torch.int32),
                     "block_tables": ((num_slots, max_blocks), torch.int32)}
        for gi, (period, count) in enumerate(self.groups):
            out[f"g{gi}"] = [
                {f"b{i}": block_paged_cache_shape(self.cfg, bd, num_slots,
                                                  num_blocks, block, dtype,
                                                  enc_T)
                 for i, bd in enumerate(period)} for _ in range(count)]
        return out

    def init_cache(self, B: int, T: int, dtype: torch.dtype | None = None,
                   per_row: bool = False, *, paged: bool = False,
                   num_blocks: int | None = None, block: int = 64,
                   enc_T: int = 0) -> dict:
        """Zeroed decode cache for ``B`` rows and ``T`` positions, k/v in
        ``dtype`` (default: the parameters', which is what ``prefill``
        writes; an SSM state is fp32 whatever ``dtype`` is).  ``per_row`` gives the scheduler's slot pool a position
        per row ([B] int32); otherwise the position is 0-d.  ``paged=True``
        builds the block-paged pool of ``B`` slots instead
        (``paged_cache_shapes``; ``num_blocks`` defaults to B ·
        ceil(T / block)), its block tables filled with the sentinel id
        ``num_blocks``.  An encoder-decoder's cache holds ``enc_T`` frames'
        keys and values (xk/xv) per row."""
        dtype = self.param_dtype if dtype is None else dtype
        if paged:
            if num_blocks is None:
                num_blocks = B * -(-T // block)
            shapes = self.paged_cache_shapes(B, num_blocks, block, T, dtype,
                                             enc_T)
            cache = map_tree(lambda sd: torch.zeros(
                sd[0], dtype=sd[1], device=self.device), shapes)
            cache["block_tables"].fill_(num_blocks)
            return cache
        cache: dict = {"pos": torch.zeros((B,) if per_row else (),
                                          dtype=torch.int32,
                                          device=self.device)}
        cache.update(map_tree(lambda sd: torch.zeros(
            sd[0], dtype=sd[1], device=self.device),
            self.cache_shapes(B, T, dtype, enc_T)))
        return cache

    def cache_shapes(self, B: int, T: int,
                     dtype: torch.dtype | None = None,
                     enc_T: int = 0) -> dict:
        """(shape, dtype) tree of the leaves of a dense cache of ``B`` rows
        and ``T`` positions (no ``pos``): full attention [B, T, KV, hd], a
        window ring [B, min(window, T), KV, hd], MLA [B, T, kv_lora] and
        [B, T, rope_hd], an SSM state [B, H, N, P] fp32 and conv history
        [B, K-1, conv_dim], a cross-attending layer's xk/xv [B, enc_T, KV,
        hd] (``transformer.block_cache_shape``)."""
        dtype = self.param_dtype if dtype is None else dtype
        self.enc_key(enc_T)
        return {f"g{gi}": [{f"b{i}": block_cache_shape(self.cfg, bd, B, T,
                                                       dtype, enc_T)
                            for i, bd in enumerate(period)}
                           for _ in range(count)]
                for gi, (period, count) in enumerate(self.groups)}

    def graphed_decode_step(self, B: int, T: int, masked: bool = False,
                            paged: tuple[int, int] | None = None,
                            enc_T: int = 0) -> DecodeGraph:
        """The decode step of a ``B``-row batch over a cache of ``T``
        positions as a CUDA graph (``models.graph.DecodeGraph``), made once
        per model and shape and kept for the ``GRAPH_CACHE_SIZE`` shapes
        used last, as the reference keeps its jitted steps.  ``masked``
        gives the scheduler's slot-pool step (a position and an ``active``
        flag per row), captured when a scheduler first binds it; otherwise
        the fixed-batch step, captured at its first ``load``.  ``paged`` =
        (num_blocks, block) makes the slot pool block-paged
        (``init_cache(..., paged=True)``; masked only).  An
        encoder-decoder's step attends to ``enc_T`` frames, the last
        element of its key.  No two of these share an entry."""
        if paged is not None and not masked:
            raise ValueError("a paged pool is the scheduler's: masked only")
        key = (B, T, masked) if paged is None else (B, T, masked, paged)
        key += self.enc_key(enc_T)
        graph = self.decode_graphs.get(key)
        if graph is None:
            graph = DecodeGraph(self, B, T, masked, paged, enc_T)
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


def _cache_leaves(cache: dict) -> list[torch.Tensor]:
    """A cache's leaves of every kind in a fixed order (every leaf but
    ``pos`` and ``block_tables``)."""
    return tree_leaves({k: v for k, v in cache.items()
                        if k not in ("pos", "block_tables")})
