"""The decode step and the prefill captured as CUDA graphs: the port's
analogues of the reference's ``Model.jitted_decode_step`` (fixed batch),
``jitted_decode_step_masked`` (the scheduler's slot pool) and
``jitted_prefill`` (exact or at a prompt-length bucket).

A :class:`DecodeGraph` belongs to one model, one (batch, cache length) and
one mode.  It owns static buffers: the token [B,1], a KV cache with its
position (in slot-pool mode also the ``active`` mask [B]), and the logits
[B,1,V] the captured step writes.  The graph holds one
``Model.decode_step`` on those buffers followed by the position's advance,
so a replay is one launch from the host, and the position moves on the
device.  The step is the eager one, op for op, so a replay gives the eager
step's logits bit for bit.

A slot-pool decode graph may be block-paged (``paged`` = (num_blocks,
block)): its static cache is then the paged pool (per-layer arenas,
``block_tables`` and ``pos``), captured over a zeroed pool whose tables
are all the sentinel, so the warm-up writes only into the sentinel block.
Such a graph also keeps one :class:`ResumeGraph` per suffix bucket, the
prefix-reuse admission captured on the same pool.  Any slot-pool decode
graph, dense or paged, keeps one :class:`MixedGraph` per (lanes, chunk):
the chunked-prefill step (``Model.mixed_step``) captured on its pool, the
analogue of the reference's ``jitted_mixed_step(K, C)``.

An encoder-decoder's graphs also belong to one frame count F: a decode
graph's static cache holds the encoder's keys and values xk/xv [B, F, KV,
hd] of every decoder layer, which its replays read and never write.

A :class:`PrefillGraph` belongs to one model and one (batch, padded
prompt length, cache length[, front-end rows]).  Its static buffers are
the tokens [B,S], the true prompt length (0-d int32), the front end's
embeddings [B, n, frontend_dim] of a model with one (an encoder-decoder's
speech frames, a vision-language model's images; in the parameters'
dtype, as the eager prefill casts them), the logits [B,1,V] and an
output cache that all prefill graphs of the model with the same (batch,
cache length[, frame count]) share (``Model.prefill_cache_key``: a
vision-language model's image rows lie within the cache length); its
temporaries live in one memory pool shared by every prefill graph of
the model (no output lives there, and one replays at a time).

Capture happens at a graph's first use (a decode graph's first ``load``
or ``bind``, a prefill, resume or mixed graph's first call), and again when
``params`` is another tree: the work first runs once eagerly on a side
stream with the same shapes (this builds the kernel library, fills the
launch-geometry memos and the chain's address tables, and opts each
kernel into its shared memory), then it is captured.  A capture or a
replay that fails raises; nothing falls back to eager work.

Kernel wrappers do not run on replay: the TT launches a capture recorded
(``tt_contract.CAPTURE_COUNTS``) are kept per graph and added to the
model's ``replayed_launches`` at every replay.
"""
from __future__ import annotations

import gc
import weakref
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.kernels import tt_contract
from .spec import map_tree, tree_leaves

if TYPE_CHECKING:
    from .model import Model

# eager runs on the side stream before the capture
WARMUP_STEPS = 1


def _capture(model: "Model", run, what: str, pool=None
             ) -> tuple[torch.cuda.CUDAGraph, object, dict[str, int]]:
    """``run()`` ``WARMUP_STEPS`` times eagerly on a side stream, then
    captured once as a CUDA graph whose temporaries live in ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; None: a private pool).  Returns
    (the graph, what the captured call returned, the TT launches it
    recorded by kernel name); raises naming ``what`` when the capture
    fails."""
    dev = model.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            run()
    torch.cuda.current_stream(dev).wait_stream(side)
    # a dropped model and its graphs refer to each other, so only the
    # cyclic collector frees them; if it ran during this capture, the
    # freed graph's memory release would invalidate the capture
    gc.collect()
    before = tt_contract.capture_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = run()
    except Exception as e:
        raise RuntimeError(f"capturing {what} failed") from e
    captured = {k: v - before.get(k, 0)
                for k, v in tt_contract.capture_counts().items()
                if v != before.get(k, 0)}
    return graph, out, captured


def _prefill_pool(model: "Model"):
    """The memory pool of the temporaries of the model's captured prefills
    and resumes, made at the first capture: nothing that outlives a replay
    lives there, and one of them replays at a time."""
    if model.prefill_pool is None:
        model.prefill_pool = torch.cuda.graph_pool_handle()
    return model.prefill_pool


class DecodeGraph:
    """The decode step of ``model`` for ``B`` rows over a cache of ``T``
    positions, captured once and replayed at every position.

    Fixed-batch mode: ``load(params, cache, pos)`` copies a prefill's cache
    into the static buffers (capturing first, or again when ``params`` is
    another tree); each call ``graph(token)`` then decodes one token and
    returns the static logits [B,1,V], which the next replay overwrites.

    Slot-pool mode (``masked``): the graph also owns an ``active`` [B]
    bool buffer, its position is [B] int32, and its static KV cache is the
    pool of the scheduler that holds it.  ``bind(owner, params)`` captures
    (with the pool still empty) or takes over a graph whose holder has no
    active row; ``splice(row_cache, slot, prompt_len)`` writes an admitted
    row into the pool between replays; ``graph(token, active)`` decodes
    one token for the active rows and leaves the others as they were.

    Paged slot-pool mode (``paged`` = (num_blocks, block)): the pool is
    block-paged; ``splice_paged(row_cache, slot, prompt_len, table)``
    scatters an admitted row into its blocks, and ``resume(...)`` replays
    the captured prefix-reuse admission of the suffix's bucket
    (:class:`ResumeGraph`, dropped at a recapture).

    Either slot pool: ``mixed(K, C)`` is the captured chunked-prefill step
    of ``K`` lanes of ``C`` tokens (:class:`MixedGraph`, dropped at a
    recapture).

    A host mirror of the position (an int, or a numpy [B]) refuses a
    replay outside the cache before it runs.
    """

    def __init__(self, model: "Model", B: int, T: int, masked: bool = False,
                 paged: tuple[int, int] | None = None, enc_T: int = 0):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA model, not "
                             f"{model.device}: decode eagerly on the CPU")
        if paged is not None and (not masked or T % paged[1]):
            raise ValueError(f"a paged pool is a slot pool over whole blocks "
                             f"(masked, T={T}, block={paged[1]})")
        self.model, self.B, self.T, self.masked = model, B, T, masked
        self.paged, self.enc_T = paged, enc_T
        # the captured resume prefills of a paged pool, by suffix bucket,
        # and the captured mixed steps, by (lanes, chunk)
        self.resumes: dict[int, ResumeGraph] = {}
        self.mixed_graphs: dict[tuple[int, int], MixedGraph] = {}
        self.graph: torch.cuda.CUDAGraph | None = None
        # the captured step reads these parameters' memory at every replay,
        # so the graph keeps them alive
        self.params = None
        self.cache: dict | None = None
        self.token = torch.zeros((B, 1), dtype=torch.int64,
                                 device=model.device)
        self.active = (torch.zeros((B,), dtype=torch.bool,
                                   device=model.device) if masked else None)
        self.logits: torch.Tensor | None = None
        # host mirror of cache["pos"]
        self.pos: int | np.ndarray = np.zeros(B, np.int64) if masked else 0
        # the scheduler that holds a slot-pool graph (weakly: a dropped
        # scheduler frees it)
        self.owner: weakref.ref | None = None
        # TT launches one replay makes, by kernel name
        self.captured: dict[str, int] = {}

    def _step(self) -> torch.Tensor:
        logits, new = self.model.decode_step(self.params, self.cache,
                                             self.token, self.active)
        self.cache["pos"].copy_(new["pos"])
        return logits

    def _capture(self, params, cache: dict) -> None:
        """Capture the step over the static buffers ``cache`` (fresh zeros
        the graph takes), after an eager warm-up step; in slot-pool mode
        ``active`` is all False, so the warm-up writes no k/v and advances
        no position."""
        self.graph = self.logits = None
        # they address the pool replaced here
        self.resumes.clear()
        self.mixed_graphs.clear()
        self.params, self.cache = params, cache
        try:
            graph, logits, self.captured = _capture(
                self.model, self._step, f"the decode step of {self.B} rows "
                f"over a cache of {self.T}")
        except RuntimeError:
            self.params = self.cache = None
            raise
        self.graph, self.logits = graph, logits
        self.model.graph_captures += 1

    def load(self, params, cache: dict, pos: int) -> None:
        """Copy ``cache`` (a prefill's, at the scalar position whose host
        value is ``pos``) into the static buffers, capturing first when
        there is no graph for ``params`` yet (fixed-batch mode)."""
        if self.masked or cache["pos"].dim() != 0:
            raise ValueError("the fixed-batch graph decodes at one position "
                             "shared by the batch")
        src = tree_leaves(cache)
        layout = [sd[0] for sd in tree_leaves(
            self.model.cache_shapes(self.B, self.T, enc_T=self.enc_T))]
        if [tuple(t.shape) for t in src if t.dim()] != layout or (
                self.cache is not None and
                [(t.shape, t.dtype) for t in tree_leaves(self.cache)] !=
                [(t.shape, t.dtype) for t in src]):
            raise ValueError(f"the cache does not have the graph's shapes: "
                             f"{self.B} rows over {self.T} positions")
        if self.graph is None or params is not self.params:
            self._capture(params, map_tree(torch.zeros_like, cache))
        for d, s in zip(tree_leaves(self.cache), src):
            d.copy_(s)
        self.pos = pos

    def bind(self, owner, params) -> None:
        """Hand the slot-pool graph to the scheduler ``owner`` (anything
        with ``num_active``), capturing first when there is no graph for
        ``params`` yet: the pool is then zeros, before any row is spliced.
        Refused while the scheduler that holds the graph has active rows:
        they live in the pool, which a recapture would zero."""
        if not self.masked:
            raise ValueError("only a slot-pool graph is bound to a scheduler")
        held = self.owner() if self.owner is not None else None
        if held is not None and held.num_active:
            raise RuntimeError(
                f"the decode graph of {self.B} slots over {self.T} positions "
                f"is held by a scheduler with {held.num_active} active rows")
        if self.graph is None or params is not self.params:
            if self.paged is None:
                pool = self.model.init_cache(self.B, self.T, per_row=True,
                                             enc_T=self.enc_T)
            else:
                num_blocks, block = self.paged
                pool = self.model.init_cache(self.B, self.T, paged=True,
                                             num_blocks=num_blocks,
                                             block=block, enc_T=self.enc_T)
            self._capture(params, pool)
            self.pos[:] = 0
        self.owner = weakref.ref(owner)

    def splice(self, row_cache: dict, slot: int, prompt_len: int) -> None:
        """Write a one-row prefill cache at ``prompt_len`` into row ``slot``
        of the pool (``Model.splice_cache``), between replays."""
        if self.graph is None or self.paged is not None:
            raise RuntimeError("bind the dense slot-pool graph before "
                               "splicing into it")
        self.model.splice_cache(self.cache, row_cache, slot)
        self.pos[slot] = prompt_len

    def splice_paged(self, row_cache: dict, slot: int, prompt_len: int,
                     table: torch.Tensor) -> None:
        """Scatter a one-row prefill cache at ``prompt_len`` into the arena
        blocks of ``table`` [max_blocks] int32 and make it row ``slot``'s
        table (``Model.splice_cache_paged``), between replays."""
        if self.graph is None or self.paged is None:
            raise RuntimeError("bind the paged slot-pool graph before "
                               "splicing into it")
        self.model.splice_cache_paged(self.cache, row_cache, slot, table)
        self.pos[slot] = prompt_len

    def resume(self, tokens: torch.Tensor, slot: int, src: torch.Tensor,
               dst: torch.Tensor, start: int, true_suf: int) -> torch.Tensor:
        """The prefix-reuse admission of row ``slot`` (``Model.
        prefill_resume``) as a replay of the resume captured for the
        padded suffix ``tokens [1, S_pad]`` on this graph's pool (captured
        at its bucket's first call), between decode replays; returns its
        static logits [1,1,V]."""
        if self.graph is None or self.paged is None:
            raise RuntimeError("bind the paged slot-pool graph before "
                               "resuming into it")
        if not 0 <= slot < self.B or not 0 < true_suf <= tokens.shape[1] or \
                not 0 <= start < start + true_suf <= self.T:
            raise ValueError(f"resume of {true_suf} tokens from {start} into "
                             f"slot {slot} of {self.B} over {self.T}")
        S_pad = int(tokens.shape[1])
        graph = self.resumes.get(S_pad)
        if graph is None:
            graph = self.resumes[S_pad] = ResumeGraph(self, S_pad)
        logits = graph(tokens, slot, src, dst, start, true_suf)
        self.pos[slot] = start + true_suf
        return logits

    def mixed(self, K: int, C: int) -> "MixedGraph":
        """The chunked-prefill step of ``K`` lanes of ``C`` tokens on this
        slot pool (captured at its first call)."""
        if self.graph is None or not self.masked:
            raise RuntimeError("bind the slot-pool graph before a mixed "
                               "step")
        graph = self.mixed_graphs.get((K, C))
        if graph is None:
            graph = self.mixed_graphs[(K, C)] = MixedGraph(self, K, C)
        return graph

    def _check_rows(self, active: np.ndarray) -> None:
        """Refuse a replay that would decode an active row outside the
        cache."""
        bad = np.flatnonzero(active & (self.pos >= self.T))
        if bad.size:
            raise ValueError(
                f"decode position {int(self.pos[bad[0]])} of row "
                f"{int(bad[0])} outside the cache of {self.T}")

    def __call__(self, token: torch.Tensor,
                 active: np.ndarray | None = None) -> torch.Tensor:
        """Decode ``token [B,1]`` at the loaded position (in slot-pool mode
        for the rows ``active`` [B] bool, a host array, marks); returns the
        static logits [B,1,V]."""
        if self.graph is None:
            raise RuntimeError("load a cache before replaying the graph")
        if self.masked:
            active = np.asarray(active, bool)
            self._check_rows(active)
            self.active.copy_(torch.from_numpy(active))
        elif not 0 <= self.pos < self.T:
            raise ValueError(f"decode position {self.pos} outside the cache "
                             f"of {self.T}")
        self.token.copy_(token)
        self.graph.replay()
        self.pos += active if self.masked else 1
        self.model.replayed_launches.update(self.captured)
        return self.logits


class PrefillGraph:
    """``Model.prefill`` of ``B`` prompts right-padded to ``S`` tokens
    into a cache of ``T`` positions (a model with a front end's with ``n``
    rows of its embeddings: an encoder-decoder's speech frames, or a
    vision-language model's images, prepended to the tokens), captured
    once and replayed for every prompt length up to ``S``
    (``Model.graphed_prefill``).

    ``graph(params, tokens, prompt_len, embeds)`` copies ``tokens [B,S]``,
    the true length (a vision-language model's counts its n image rows)
    and the front end's ``embeds [B, n, frontend_dim]`` into the static
    buffers (capturing first when there is no graph for ``params`` yet)
    and replays: it returns the static logits [B,1,V] of position
    prompt_len - 1 and the static output cache at ``pos`` = prompt_len
    (xk/xv included), which the caller copies out (a splice into the slot
    pool, ``DecodeGraph.load``) before the next replay of a prefill graph
    of the same ``Model.prefill_cache_key``.  The capture touches nothing
    but the graph's own buffers, so it may run while a slot pool holds
    live rows.
    """

    def __init__(self, model: "Model", B: int, S: int, T: int, n: int = 0):
        if model.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA model, not "
                             f"{model.device}: prefill eagerly on the CPU")
        # a vision-language model's image rows come before the tokens
        self.img = n if model.cfg.frontend == "vit" else 0
        if self.img + S > T:
            raise ValueError(f"prompt of {self.img} image rows and {S} "
                             f"tokens exceeds the cache of {T}")
        dev = model.device
        self.model, self.B, self.S, self.T = model, B, S, T
        self.graph: torch.cuda.CUDAGraph | None = None
        # the captured prefill reads these parameters' memory at every
        # replay, so the graph keeps them alive
        self.params = None
        self.tokens = torch.zeros((B, S), dtype=torch.int64, device=dev)
        self.prompt_len = torch.full((), self.img + S, dtype=torch.int32,
                                     device=dev)
        self.embeds = (torch.zeros((B, n, model.cfg.frontend_dim),
                                   dtype=model.param_dtype, device=dev)
                       if model.front_input else None)
        self.logits = torch.empty((B, 1, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        # made by the first prefill graph of its key, outside any capture
        key = model.prefill_cache_key(B, S, T, n)
        if key not in model.prefill_caches:
            model.prefill_caches[key] = model.init_cache(
                B, T, enc_T=n if model.cfg.enc_dec else 0)
        self.cache = model.prefill_caches[key]
        # TT launches one replay makes, by kernel name
        self.captured: dict[str, int] = {}

    def _prefill(self) -> None:
        batch = {"tokens": self.tokens, "cache_len": self.T,
                 "prompt_len": self.prompt_len}
        if self.embeds is not None:
            batch[self.model.front_input] = self.embeds
        logits, _ = self.model.prefill(self.params, batch, out=self.cache)
        self.logits.copy_(logits)

    def _capture(self, params) -> None:
        model = self.model
        self.graph, self.params = None, params
        try:
            self.graph, _, self.captured = _capture(
                model, self._prefill, f"the prefill of {self.B} rows of "
                f"{self.S} tokens into a cache of {self.T}",
                _prefill_pool(model))
        except RuntimeError:
            self.params = None
            raise
        model.prefill_builds += 1

    def __call__(self, params, tokens: torch.Tensor, prompt_len: int,
                 embeds: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict]:
        """Prefill ``tokens [B,S]``, right-padded past ``prompt_len``
        (which counts a vision-language model's image rows), with the
        front end's ``embeds [B, n, frontend_dim]``; returns the static
        (logits [B,1,V], cache)."""
        if tuple(tokens.shape) != (self.B, self.S):
            raise ValueError(f"tokens {tuple(tokens.shape)} for the prefill "
                             f"graph of {self.B} rows of {self.S}")
        if not self.img < prompt_len <= self.img + self.S:
            raise ValueError(f"prompt_len {prompt_len} outside a prompt of "
                             f"{self.img + self.S}")
        want = None if self.embeds is None else tuple(self.embeds.shape)
        got = None if embeds is None else tuple(embeds.shape)
        if got != want:
            raise ValueError(f"front-end embeddings {got} for the prefill "
                             f"graph of {want}")
        if embeds is not None:
            self.embeds.copy_(embeds)
        self.tokens.copy_(tokens)
        self.prompt_len.fill_(prompt_len)
        if self.graph is None or params is not self.params:
            self._capture(params)
        self.graph.replay()
        self.model.replayed_launches.update(self.captured)
        return self.logits, self.cache


class ResumeGraph:
    """``Model.prefill_resume`` of a suffix right-padded to ``S`` tokens on
    the pool of the paged slot-pool ``DecodeGraph`` ``decode``, captured
    once (with the decode graph's parameters) and replayed for every
    prefix hit whose suffix falls in that bucket (``DecodeGraph.resume``).

    Its static inputs are the suffix tokens [1, S], the slot, the source
    and destination tables [max_blocks] and ``start``/``true_suf`` (0-d
    int32); a replay writes the arenas, ``pos[slot]`` and
    ``block_tables[slot]`` on the device and the logits [1,1,V] of
    position start + true_suf - 1 into a static buffer.  The warm-up and
    the capture run with both tables all sentinel and the slot outside
    the pool, so they touch no live row while other slots decode; the
    first replay does the first real work.  Temporaries live in the
    model's prefill pool (one prefill or resume replays at a time)."""

    def __init__(self, decode: DecodeGraph, S: int):
        model, dev = decode.model, decode.model.device
        self.decode, self.model, self.S = decode, model, S
        num_blocks = decode.paged[0]
        mb = decode.cache["block_tables"].shape[1]
        self.tokens = torch.zeros((1, S), dtype=torch.int64, device=dev)
        self.slot = torch.full((), decode.B, dtype=torch.int32, device=dev)
        self.src = torch.full((mb,), num_blocks, dtype=torch.int32,
                              device=dev)
        self.dst = torch.full((mb,), num_blocks, dtype=torch.int32,
                              device=dev)
        self.start = torch.zeros((), dtype=torch.int32, device=dev)
        self.true_suf = torch.ones((), dtype=torch.int32, device=dev)
        self.logits = torch.empty((1, 1, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None
        # TT launches one replay makes, by kernel name
        self.captured: dict[str, int] = {}

    def _resume(self) -> None:
        logits, _ = self.model.prefill_resume(
            self.decode.params, self.tokens, self.decode.cache, self.slot,
            self.src, self.dst, self.start, self.true_suf)
        self.logits.copy_(logits)

    def _capture(self) -> None:
        model = self.model
        self.graph, _, self.captured = _capture(
            model, self._resume, f"the resume prefill of {self.S} tokens "
            f"into the paged pool of {self.decode.B} slots over "
            f"{self.decode.T}", _prefill_pool(model))
        model.prefill_builds += 1

    def __call__(self, tokens: torch.Tensor, slot: int, src: torch.Tensor,
                 dst: torch.Tensor, start: int, true_suf: int
                 ) -> torch.Tensor:
        if tuple(tokens.shape) != (1, self.S):
            raise ValueError(f"tokens {tuple(tokens.shape)} for the resume "
                             f"graph of 1 row of {self.S}")
        if self.graph is None:
            self._capture()
        self.tokens.copy_(tokens)
        self.slot.fill_(slot)
        self.src.copy_(src)
        self.dst.copy_(dst)
        self.start.fill_(start)
        self.true_suf.fill_(true_suf)
        self.graph.replay()
        self.model.replayed_launches.update(self.captured)
        return self.logits


class MixedGraph:
    """``Model.mixed_step`` of ``K`` prefill-chunk lanes of ``C`` tokens
    and the masked decode step on the pool of the slot-pool ``DecodeGraph``
    ``decode`` (dense or paged), captured once (with the decode graph's
    parameters) and replayed at every chunked-prefill step of a scheduler
    with that (lanes, chunk) (``DecodeGraph.mixed``).

    Its static inputs are the lanes' tokens [K, C], slots, starts and true
    lengths [K] int32, active flags [K] bool and, paged, block tables [K,
    max_blocks] int32; the decode pass reads the decode graph's own token
    and ``active`` buffers.  A replay writes the pool (k/v, positions and,
    paged, the lanes' tables) on the device and the decode logits [B,1,V]
    and the lanes' logits [K,V] into static buffers.  The warm-up and the
    capture run with every lane inactive (slot 0, start 0, true length 1,
    tables all sentinel) and no decode row active: a dense lane writes back
    the row it read and a paged one writes only the sentinel block, so the
    capture may run while rows are live.  Temporaries live in the model's
    prefill pool (one prefill, resume or mixed step replays at a time)."""

    def __init__(self, decode: DecodeGraph, K: int, C: int):
        model, dev = decode.model, decode.model.device
        self.decode, self.model, self.K, self.C = decode, model, K, C
        self.ck_tokens = torch.zeros((K, C), dtype=torch.int64, device=dev)
        self.ck_slot = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.ck_start = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.ck_true = torch.ones((K,), dtype=torch.int32, device=dev)
        self.ck_active = torch.zeros((K,), dtype=torch.bool, device=dev)
        self.ck_tables = None
        if decode.paged is not None:
            mb = decode.cache["block_tables"].shape[1]
            self.ck_tables = torch.full((K, mb), decode.paged[0],
                                        dtype=torch.int32, device=dev)
        V = model.cfg.vocab_size
        self.logits = torch.empty((decode.B, 1, V), dtype=torch.float32,
                                  device=dev)
        self.ck_logits = torch.empty((K, V), dtype=torch.float32,
                                     device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None
        # TT launches one replay makes, by kernel name
        self.captured: dict[str, int] = {}

    def _step(self) -> None:
        d = self.decode
        logits, ck_logits, new = self.model.mixed_step(
            d.params, d.cache, d.token, d.active, self.ck_tokens,
            self.ck_slot, self.ck_start, self.ck_true, self.ck_active,
            self.ck_tables)
        d.cache["pos"].copy_(new["pos"])
        self.logits.copy_(logits)
        self.ck_logits.copy_(ck_logits)

    def _capture(self) -> None:
        model, d = self.model, self.decode
        d.active.zero_()
        self.graph, _, self.captured = _capture(
            model, self._step, f"the mixed step of {self.K} lanes of "
            f"{self.C} tokens on the pool of {d.B} slots over {d.T}",
            _prefill_pool(model))
        model.graph_captures += 1

    def __call__(self, token: torch.Tensor, active: np.ndarray,
                 lanes: dict[str, np.ndarray]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """One mixed step: decode ``token [B,1]`` for the rows ``active``
        [B] bool marks (host arrays, as ``DecodeGraph.__call__`` takes
        them) after the chunk lanes ``lanes`` (host arrays ``tokens`` [K,
        C], ``slot``, ``start``, ``true`` [K], ``active`` [K] and, paged,
        ``tables`` [K, max_blocks]).  Returns the static (decode logits
        [B,1,V], lane logits [K,V])."""
        d = self.decode
        active = np.asarray(active, bool)
        lane = np.asarray(lanes["active"], bool)
        slot, start, true = (np.asarray(lanes[k])[lane]
                             for k in ("slot", "start", "true"))
        d._check_rows(active)
        if np.any((slot < 0) | (slot >= d.B) | (true < 1) |
                  (true > self.C) | (start < 0) | (start + true > d.T)) or \
                np.any(active[slot]):
            raise ValueError(f"chunk lanes (slot, start, true length) "
                             f"{list(zip(slot, start, true))} outside the "
                             f"pool of {d.B} slots over {d.T} with chunks "
                             f"of {self.C}, or on a decoding row")
        if self.graph is None:
            self._capture()
        d.token.copy_(token)
        d.active.copy_(torch.from_numpy(active))
        for buf, k in ((self.ck_tokens, "tokens"), (self.ck_slot, "slot"),
                       (self.ck_start, "start"), (self.ck_true, "true"),
                       (self.ck_active, "active")) + (
                ((self.ck_tables, "tables"),)
                if self.ck_tables is not None else ()):
            buf.copy_(torch.from_numpy(np.asarray(lanes[k])))
        self.graph.replay()
        d.pos[slot] = start + true
        d.pos += active
        self.model.replayed_launches.update(self.captured)
        return self.logits, self.ck_logits
