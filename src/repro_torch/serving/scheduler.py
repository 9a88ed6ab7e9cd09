"""Continuous batching over a pool of dense slots or of KV blocks.

The dense-slot and block-paged paths of the reference's
``serving.scheduler``.  Dense (the default): one KV pool
(``Model.init_cache(num_slots, cache_len, per_row=True)``), in which every
slot owns ``cache_len`` positions of every layer and a position of its own.
Paged (``paged=True``, DESIGN.md §7): per-layer arenas of ``num_blocks``
blocks of ``block_size`` positions (+ 1 write sentinel) shared by all
slots through per-slot block tables (``Model.init_cache(..., paged=True)``),
a ``serving.paging.BlockAllocator`` on the host, and admission by memory:
a request is admitted when a slot is free AND its lifetime reservation
(prompt + budget, in blocks) fits.  With ``prefix_cache`` (the default,
for a model that ``supports_prefix_reuse``), the full blocks of a prompt
are published under their chained content hash; a later prompt that
shares them acquires them copy-on-write and prefills only its suffix
(``Model.prefill_resume``), counted in ``prefill_tokens_skipped``.

Chunked prefill (``chunk_prefill=True``, DESIGN.md §15): admission only
reserves the slot (paged: the blocks, with the same prefix lookup,
copy-on-write credit and rollback; a full cover copies its last block
eagerly, ``Model.copy_blocks``) and arms the slot's chunk state; every
step then runs up to ``chunk_lanes`` = max(1, ``prefill_budget`` //
``chunk_size``) prompt chunks of ``chunk_size`` tokens, best rank first,
before the masked decode of the decoding rows, in one
``Model.mixed_step``.  A slot whose last chunk ran publishes its prompt's
blocks and picks its first token from the lane's logits, through its own
generator as an admission would; mid-prefill slots are not decoded and
draw nothing.

Lifecycle of a request:

  submit() ─→ queue ─→ admission into a free slot, best rank first
  (``priority``, then submit time; paged: when its blocks fit, else it
  waits and no request jumps over it): a prefill of the prompt alone into
  a cache of the pool's length, right-padded to its length bucket
  (``bucket_prompts``, the default; ``Model.bucketed_prefill``) or at its
  own length, and a splice of the row into the pool (paged: a scatter
  into its blocks); or, paged on a prefix hit, a resume prefill of the
  suffix into the pool; the first token picked from its logits ─→ masked
  decode steps until EOS or the token budget ─→ retirement frees the slot
  (and drops the slot's block references).

On a CUDA model every admission prefill is one replay of a captured
prefill (``Model.graphed_prefill(1, bucket or prompt length, cache_len)``,
captured the first time its key is met), every resume one replay of the
resume captured for its suffix bucket (``DecodeGraph.resume``), every
chunked-prefill step one replay of the mixed step captured for its
(lanes, chunk) (``DecodeGraph.mixed``), and every decode step one replay
of the slot-pool CUDA graph
``Model.graphed_decode_step(num_slots, cache_len, masked=True, paged=...)``,
whose static cache is the pool; the splice is a device copy (paged: a
scatter) from the prefill graph's output cache into the pool, between
replays.  On the CPU all are eager (``Model.decode_step`` with the
``active`` mask, ``Model.mixed_step``).  ``graph=False`` asks for the
eager prefill, resume, mixed and decode steps on the card, to hold them
against each other.

Sampling parameters ride on the ``Request`` (``temperature``, ``top_k``).
A sampled request draws from its own ``torch.Generator`` on the model's
device (``Request.key``, or one seeded from the scheduler's ``seed`` and
the request's uid, the counterpart of ``fold_in(base_key, uid)``); greedy
requests draw nothing.

A model with window rings (gemma3's local layers) or an SSM state
(mamba2) serves through every pool and admission kind; its prefix blocks
are never shared (``Model.supports_prefix_reuse`` is false, so
``prefix_cache`` is off in a paged pool), as in the reference.  mamba2's
paged pool holds no arena at all, only 'slot' leaves: its block accounting
(reservation, admission by memory, tables, high-water) runs all the same,
so its slots and block ids are the reference's.  jamba's pool mixes both:
its GQA layers' arenas are addressed through the tables, and the blocks a
request reserves are those of its tokens, counted once for those layers;
its SSD layers' state and conv history are one row per slot, outside the
block count.

An encoder-decoder (seamless) takes each request's speech frames
(``inputs["speech_embeds"] [1, F, frontend_dim]``) into its admission
prefill, and its pool, dense or paged, keeps every slot's encoder keys and
values (xk/xv [num_slots, F, KV, hd], 'slot' leaves): the pool and, on a
card, the slot-pool graph are built at the first admission from that
request's F, as the reference builds its pool from the first prefill
(``_ensure_pool``).  One pool serves one F: a request of another F is
refused with a ``ValueError`` at ``submit`` once the pool exists, else at
its admission (the reference fails inside its splice).  Chunked prefill
and prefix reuse are off for it (``Model.supports_chunked_prefill``,
``supports_prefix_reuse``), as in the reference.

A vision-language model (internvl2) takes each request's image
embeddings (``inputs["image_embeds"] [1, S_img, frontend_dim]``) into its
admission prefill, which prepends their projection to the prompt: its
S_img rows are plain k/v rows of the slot, so the prompt length that the
cache bound, the paged block reservation, the bucket and the slot's
position use is S_img + S, as the reference's ``submit`` counts it.
Chunked prefill and prefix reuse are off for it too.

Not ported (ROADMAP.md Queue 1): preemption (mid-prefill included),
deadlines, resize, snapshots (mid-prefill included), the mesh and
``drop``.  The constructor refuses the arguments.  With equal priorities the reference
never preempts, so the two agree at their defaults.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.models.graph import DecodeGraph
from repro_torch.models.model import Model
from repro_torch.models.spec import tree_leaves
from .paging import BlockAllocator, chain_hashes, logical_blocks

NEG_INF = -1e30

# the reference's Scheduler arguments this port leaves out, by the
# ROADMAP.md Queue 1 item that brings them
NOT_PORTED = {"preempt": 6, "clock": 6, "mesh": 10}


@dataclasses.dataclass
class Request:
    """One generation request.  ``inputs`` holds ``tokens [1, S]`` (and an
    encoder-decoder's ``speech_embeds [1, F, frontend_dim]``, a
    vision-language model's ``image_embeds [1, S_img, frontend_dim]``).
    ``temperature`` 0 is greedy (draws nothing), ``top_k`` 0 disables the
    top-k filter; ``key`` is the request's own sampling stream, a
    ``torch.Generator`` on the model's device.  ``priority`` orders
    admission (higher wins; ties go to the older request)."""
    uid: int
    inputs: dict
    max_new_tokens: int
    key: torch.Generator | None = None
    temperature: float = 0.0
    top_k: int = 0
    priority: int = 0


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    tokens: np.ndarray                    # [n_generated] int64
    logprobs: np.ndarray                  # [n_generated] float32
    finish_reason: str                    # "eos" | "length" | "cancelled"
    prompt_len: int
    submit_time: float                    # perf_counter at submit()
    finish_time: float                    # perf_counter at retirement
    first_token_time: float | None = None  # perf_counter at first token


@dataclasses.dataclass
class _Queued:
    req: Request
    prompt_len: int
    submit_time: float


@dataclasses.dataclass
class _Slot:
    uid: int
    max_new: int
    key: torch.Generator | None
    prompt_len: int
    submit_time: float
    temperature: float = 0.0
    top_k: int = 0
    priority: int = 0
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    last_tok: int = 0
    first_token_time: float | None = None
    # the chunk state: ``prefill_pos`` is None once the prompt is
    # prefilled (the slot decodes); while it prefills, the prompt tokens
    # already processed.  ``prefill_toks`` is the prompt, ``prefill_table``
    # the slot's sentinel-padded block table (paged pools).
    prefill_pos: int | None = None
    prefill_toks: np.ndarray | None = dataclasses.field(default=None,
                                                        repr=False)
    prefill_table: np.ndarray | None = dataclasses.field(default=None,
                                                         repr=False)


class Scheduler:
    """Continuous-batching loop: ``submit()`` any time, ``step()`` admits
    queued requests into free slots and advances every active slot by one
    token, ``run()`` drains."""

    def __init__(self, model: Model, params, num_slots: int, cache_len: int,
                 *, eos_id: int | None = None, seed: int = 0,
                 paged: bool = False, block_size: int = 64,
                 num_blocks: int | None = None, prefix_cache: bool = True,
                 bucket_prompts: bool = True, graph: bool = True,
                 chunk_prefill: bool = False, chunk_size: int = 64,
                 prefill_budget: int | None = None, **left_out):
        for name in left_out:
            if name not in NOT_PORTED:
                raise TypeError(f"Scheduler got an unexpected keyword "
                                f"argument {name!r}")
        if left_out:
            raise NotImplementedError(
                f"{sorted(left_out)}: not ported; the scheduler has none of "
                f"them (ROADMAP.md Queue 1 items "
                f"{sorted({NOT_PORTED[n] for n in left_out})})")
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        # chunked prefill: ``prefill_budget`` caps the prompt tokens of a
        # step, so a step runs floor(budget / chunk_size) chunk lanes
        # beside the decode rows, trading the TTFT of admitted requests
        # against the inter-token latency of running ones
        self.chunk_prefill = bool(chunk_prefill)
        self.chunk_size = int(chunk_size)
        self.prefill_budget = (self.chunk_size if prefill_budget is None
                               else int(prefill_budget))
        self.chunk_lanes = max(1, self.prefill_budget //
                               max(1, self.chunk_size))
        if self.chunk_prefill:
            if self.chunk_size < 1:
                raise ValueError("chunk_size must be >= 1")
            if not model.supports_chunked_prefill:
                raise ValueError(
                    "model does not support chunked prefill (encoder-decoder "
                    "and frontend models prefill monolithically)")
        self.model = model
        self.params = params
        # every TT plan is resolved here, so admissions and decode steps
        # resolve none
        model.plan_book
        self.num_slots = num_slots
        self.paged = paged
        if paged:
            self.block = block_size
            self.max_blocks = logical_blocks(cache_len, block_size)
            # the pool's logical length is block-aligned so prefilled rows
            # scatter into whole blocks
            self.cache_len = self.max_blocks * block_size
            self.num_blocks = (num_blocks if num_blocks is not None
                               else num_slots * self.max_blocks)
            self.allocator = BlockAllocator(self.num_blocks, block_size)
            self.prefix_cache = prefix_cache and model.supports_prefix_reuse
            self._slot_blocks: list[list[int] | None] = [None] * num_slots
            self.block_hwm = 0                # live blocks high-water mark
            self.prefix_hit_tokens = 0        # prompt tokens found resident
            self.prefix_prompt_tokens = 0     # prompt tokens seen (paged)
            self.prefill_tokens_skipped = 0   # prefill compute avoided
        else:
            self.cache_len = cache_len
        self.eos_id = eos_id
        self.seed = seed
        self.bucket_prompts = bucket_prompts
        self.graphed = graph
        self.queue: deque[_Queued] = deque()
        self.slots: list[_Slot | None] = [None] * num_slots
        self.finished: list[FinishedRequest] = []
        self.steps_run = 0                # decode steps executed
        self.tokens_out = 0               # total generated tokens
        self.admissions = 0               # admission prefills (or resumes)
        self.admit_s = 0.0                # host seconds in admissions
        self.cancelled = 0                # requests cancelled via cancel()
        self.prefill_chunks = 0           # chunk lanes executed
        self.mixed_steps = 0              # steps through the mixed step
        self.plain_steps = 0              # steps through the decode step
        # on a card, the slot-pool decode step; its static cache is the pool
        self.graph: DecodeGraph | None = None
        self.cache: dict | None = None
        # the frame count of an encoder-decoder's pool, built at the first
        # admission (None until then); 0 for every other model
        self.enc_T: int | None = None
        if not model.cfg.enc_dec:
            self._build_pool(0)

    def _build_pool(self, enc_T: int) -> None:
        """The pool (its xk/xv over ``enc_T`` frames) and, on a card unless
        ``graph=False``, the slot-pool decode graph it is the static cache
        of, bound to this scheduler."""
        model, B = self.model, self.num_slots
        geometry = (self.num_blocks, self.block) if self.paged else None
        if self.graphed and model.device.type == "cuda":
            self.graph = model.graphed_decode_step(
                B, self.cache_len, masked=True, paged=geometry, enc_T=enc_T)
            self.graph.bind(self, self.params)
            self.cache = self.graph.cache
        elif self.paged:
            self.cache = model.init_cache(B, self.cache_len, paged=True,
                                          num_blocks=self.num_blocks,
                                          block=self.block, enc_T=enc_T)
        else:
            self.cache = model.init_cache(B, self.cache_len, per_row=True,
                                          enc_T=enc_T)
        self.enc_T = enc_T

    def _frames_of(self, req: Request) -> int:
        """The frame count of ``req``'s speech frames: 0 for a model that
        takes none, and for an encoder-decoder the pool's once it exists
        (another count raises ValueError)."""
        if not self.model.cfg.enc_dec:
            return 0
        frames = req.inputs.get("speech_embeds")
        if frames is None:
            raise ValueError(f"request uid={req.uid}: {self.model.cfg.name} "
                             f"serves speech frames, inputs['speech_embeds']"
                             f" [1, F, {self.model.cfg.frontend_dim}]")
        F = int(frames.shape[1])
        if self.enc_T is not None and F != self.enc_T:
            raise ValueError(f"request uid={req.uid}: {F} frames, the pool "
                             f"serves {self.enc_T}: one pool, one frame "
                             f"count")
        return F

    # ------------------------------------------------------------- interface
    def submit(self, req: Request, submit_time: float | None = None) -> None:
        """Queue a request.  Raises ValueError here when it could never be
        admitted: prompt and budget must fit the cache, and in a paged pool
        their blocks must fit the pool even when every other request has
        retired.  A vision-language model's prompt is its image rows and
        its tokens; a request of a model with a front end needs the front
        end's embeddings."""
        S = int(req.inputs["tokens"].shape[1]) + self.model.image_rows(
            req.inputs)
        self._frames_of(req)
        if req.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if S + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request uid={req.uid}: prompt ({S}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds cache_len={self.cache_len}")
        if self.paged:
            need = logical_blocks(S + req.max_new_tokens, self.block)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request uid={req.uid} can never be admitted: prompt "
                    f"({S}) + max_new_tokens ({req.max_new_tokens}) needs "
                    f"{need} blocks of {self.block} tokens but the pool "
                    f"has only {self.allocator.capacity}")
        if req.key is not None and req.key.device.type != \
                self.model.device.type:
            raise ValueError(f"request uid={req.uid}: its generator lives on "
                             f"{req.key.device}, the model on "
                             f"{self.model.device}")
        t = time.perf_counter() if submit_time is None else submit_time
        self.queue.append(_Queued(req, S, t))

    def cancel(self, uid: int) -> bool:
        """Cancel a request, queued or in flight: it retires with
        ``finish_reason="cancelled"`` (partial tokens included) and frees
        its slot and blocks.  Returns False for an unknown uid."""
        for qi, q in enumerate(self.queue):
            if q.req.uid == uid:
                del self.queue[qi]
                self.finished.append(FinishedRequest(
                    uid=uid, tokens=np.zeros((0,), np.int64),
                    logprobs=np.zeros((0,), np.float32),
                    finish_reason="cancelled", prompt_len=q.prompt_len,
                    submit_time=q.submit_time,
                    finish_time=time.perf_counter()))
                self.cancelled += 1
                return True
        for i, s in enumerate(self.slots):
            if s is not None and s.uid == uid:
                self.finished.append(self._retire(s, "cancelled"))
                self._free_slot(i)
                self.cancelled += 1
                return True
        return False

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and self.num_active == 0

    def stats(self) -> dict:
        """Pool and paging counters for reporting (``launch.serve``)."""
        out = {"tokens_out": self.tokens_out, "steps_run": self.steps_run,
               "admissions": self.admissions, "admit_s": self.admit_s,
               "kv_pool_bytes": self.kv_pool_bytes(),
               "cancelled": self.cancelled}
        if self.chunk_prefill:
            out.update(chunk_size=self.chunk_size,
                       prefill_budget=self.prefill_budget,
                       chunk_lanes=self.chunk_lanes,
                       prefill_chunks=self.prefill_chunks,
                       mixed_steps=self.mixed_steps,
                       plain_steps=self.plain_steps)
        if self.paged:
            out.update(
                block_size=self.block, num_blocks=self.num_blocks,
                blocks_in_use=self.allocator.in_use,
                block_high_water=self.block_hwm,
                prefix_hit_tokens=self.prefix_hit_tokens,
                prefix_prompt_tokens=self.prefix_prompt_tokens,
                prefill_tokens_skipped=self.prefill_tokens_skipped,
                prefix_hit_rate=(
                    self.prefix_hit_tokens / self.prefix_prompt_tokens
                    if self.prefix_prompt_tokens else 0.0))
        return out

    def kv_pool_bytes(self) -> int:
        """Bytes of the pool: every leaf, arenas and 'slot' leaves (an SSM
        state and conv history, xk/xv) alike, with positions and tables; 0
        before an encoder-decoder's first admission built it."""
        if self.cache is None:
            return 0
        return sum(t.nbytes for t in tree_leaves(self.cache))

    def reset_stats(self) -> None:
        """Zero the reporting counters (after a warm-up request, so set-up
        stays out of steady-state numbers)."""
        self.finished.clear()
        self.tokens_out = self.steps_run = self.admissions = 0
        self.cancelled = self.prefill_chunks = 0
        self.mixed_steps = self.plain_steps = 0
        self.admit_s = 0.0
        if self.paged:
            self.block_hwm = self.allocator.in_use
            self.prefix_hit_tokens = self.prefix_prompt_tokens = 0
            self.prefill_tokens_skipped = 0

    def step(self) -> list[FinishedRequest]:
        """One scheduler tick: admit into free slots best-rank-first, then
        run one masked decode step, or, while a slot is mid-prefill, one
        mixed step (its chunk lanes, then the decode).  Returns the
        requests retired during this call.  A scheduler whose decode graph
        another one has bound since raises."""
        if self.graph is not None and self.graph.owner() is not self:
            raise RuntimeError("the slot-pool decode graph was bound by "
                               "another scheduler")
        done: list[FinishedRequest] = []
        self._admit_phase(done)
        if self.num_active:
            if any(s is not None and s.prefill_pos is not None
                   for s in self.slots):
                self._mixed_once(done)
            else:
                self._decode_once(done)
        self.finished.extend(done)
        return done

    def run(self) -> dict[int, FinishedRequest]:
        """Drain queue and active slots; returns {uid: FinishedRequest}.
        A step that makes no progress while requests are still queued
        raises RuntimeError instead of spinning forever."""
        out = {}
        while not self.idle:
            before = (len(self.queue), self.num_active, self.steps_run,
                      len(self.finished))
            for f in self.step():
                out[f.uid] = f
            after = (len(self.queue), self.num_active, self.steps_run,
                     len(self.finished))
            if before == after and after[1] == 0:
                detail = ""
                if self.paged:
                    q = self.queue[0]
                    need = logical_blocks(
                        q.prompt_len + q.req.max_new_tokens, self.block)
                    detail = (f" (head uid={q.req.uid} needs {need} blocks, "
                              f"{self.allocator.available} available)")
                raise RuntimeError(
                    f"scheduler stalled: {len(self.queue)} queued requests, "
                    f"no active slots, and a step made no progress" + detail)
        return out

    # ------------------------------------------------------------- admission
    @staticmethod
    def _qrank(q: _Queued) -> tuple:
        """Admission order: smaller sorts first (better).  Higher priority
        wins; ties go to the older request."""
        return (-q.req.priority, q.submit_time)

    def _admit_phase(self, done: list[FinishedRequest]) -> None:
        """Admit queued requests best-rank-first while a slot is free (and,
        paged, while the best one's blocks fit); no request jumps over a
        better one, and none is preempted."""
        while self.queue:
            free = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if free is None:
                break
            qi = min(range(len(self.queue)),
                     key=lambda j: self._qrank(self.queue[j]))
            if not self._try_admit(self.queue[qi], free, done):
                break                     # paged: its blocks do not fit yet
            del self.queue[qi]

    def _try_admit(self, q: _Queued, slot_idx: int,
                   done: list[FinishedRequest]) -> bool:
        """Admit ``q`` into ``slot_idx``.  Returns False when the paged
        pool cannot reserve its blocks yet (it stays queued; retirements
        will free blocks).  An encoder-decoder's first admission builds the
        pool from its frame count; a request of another count raises."""
        req = q.req
        F = self._frames_of(req)
        if self.enc_T is None:
            self._build_pool(F)
        if req.max_new_tokens == 0:       # nothing to generate: no prefill
            done.append(FinishedRequest(
                uid=req.uid, tokens=np.zeros((0,), np.int64),
                logprobs=np.zeros((0,), np.float32), finish_reason="length",
                prompt_len=q.prompt_len, submit_time=q.submit_time,
                finish_time=time.perf_counter()))
            return True
        if self.chunk_prefill:
            return self._admit_chunked(q, slot_idx)
        if self.paged:
            return self._admit_paged(q, slot_idx, done)
        self._admit_dense(q, slot_idx, done)
        return True

    def _admit_inputs(self, q: _Queued) -> dict:
        """The prefill's inputs: the prompt (and the front end's
        embeddings, an encoder-decoder's speech frames or a vision-language
        model's images) on the model's device, into a cache of the pool's
        length."""
        dev, inputs = self.model.device, q.req.inputs
        keys = ("tokens",) + ((self.model.front_input,)
                              if self.model.front_input else ())
        return {**{k: inputs[k].to(dev) for k in keys},
                "cache_len": self.cache_len}

    def _row_prefill(self, inputs: dict) -> tuple[torch.Tensor, dict]:
        """The prompt alone, right-padded to its bucket or at its own
        length (``bucket_prompts=False``); a replay on the card unless
        ``graph=False``.  The cache it returns may be a prefill graph's
        static one: spliced before the next admission."""
        self.admissions += 1
        model = self.model
        if self.bucket_prompts:
            return model.bucketed_prefill(
                self.cache_len, self.graphed)(self.params, inputs)
        tokens = inputs["tokens"]
        return model.padded_prefill(
            self.params, tokens, int(tokens.shape[1]) +
            model.image_rows(inputs), self.cache_len, self.graphed,
            model.front_embeds(inputs))

    def _req_key(self, req: Request) -> torch.Generator | None:
        if req.temperature <= 0.0:
            return None                   # greedy: no randomness consumed
        if req.key is not None:
            return req.key
        # one stream per (seed, uid), mixed into every bit of the seed (the
        # CPU generator keeps only the low 32); uids may be negative
        # (warm-up requests)
        mixed = np.random.SeedSequence(
            [self.seed & 0xFFFFFFFF, req.uid & 0xFFFFFFFF]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.model.device).manual_seed(
            int(mixed))

    def _start_slot(self, q: _Queued) -> _Slot:
        req = q.req
        return _Slot(uid=req.uid, max_new=req.max_new_tokens,
                     key=self._req_key(req), prompt_len=q.prompt_len,
                     submit_time=q.submit_time,
                     temperature=float(req.temperature),
                     top_k=int(req.top_k), priority=int(req.priority))

    def _emit(self, slot: _Slot, tok: int, lp: float) -> None:
        """Append one generated token to a slot, stamping the first."""
        slot.tokens.append(tok)
        slot.logprobs.append(lp)
        slot.last_tok = tok
        self.tokens_out += 1
        if slot.first_token_time is None:
            slot.first_token_time = time.perf_counter()

    def _admit_dense(self, q: _Queued, slot_idx: int,
                     done: list[FinishedRequest]) -> None:
        t0 = time.perf_counter()
        logits, row_cache = self._row_prefill(self._admit_inputs(q))
        slot = self._start_slot(q)
        tok, lp = self._pick(logits[:, -1], [slot])
        self._emit(slot, tok[0], lp[0])
        if self._finished_reason(slot):
            done.append(self._retire(slot))
        else:                             # occupies a decode slot
            if self.graph is not None:
                self.graph.splice(row_cache, slot_idx, q.prompt_len)
            else:
                self.model.splice_cache(self.cache, row_cache, slot_idx)
            self.slots[slot_idx] = slot
        self.admit_s += time.perf_counter() - t0

    def _reserve(self, q: _Queued, slot_idx: int, hashes: list[bytes]
                 ) -> tuple[list[int], list[int], int] | None:
        """Reserve ``q``'s lifetime blocks for slot ``slot_idx``, sharing
        the longest chain of resident blocks whose chained hashes are
        ``hashes`` (empty without the prefix cache), and count them:
        (source blocks, destination blocks, the first prompt position to
        compute), or None, holding nothing, when they do not fit yet.  A
        prefill computes >= 1 token for the logits, so full coverage takes
        the last matched block copy on write (the one entry where the
        destination differs) and recomputes its last token."""
        S, alloc = q.prompt_len, self.allocator
        need = logical_blocks(min(S + q.req.max_new_tokens, self.cache_len),
                              self.block)
        shared: list[int] = []
        for h in hashes:
            bid = alloc.acquire(h)
            if bid is None:
                break
            shared.append(bid)
        matched = len(shared)
        covered = matched * self.block
        full_cover = matched > 0 and covered >= S
        start = S - 1 if full_cover else covered
        fresh_needed = need - matched + (1 if full_cover else 0)
        # the COW source's only owner is this admission: its decref returns
        # it to the pool mid-admission, so credit it (or an idle pool could
        # refuse a request that fits)
        credit = (1 if full_cover and alloc.refcount(shared[-1]) == 1
                  else 0)
        if fresh_needed > alloc.available + credit:
            for bid in shared:            # roll back: the request waits
                alloc.decref(bid)
            return None
        src, dst = list(shared), list(shared)
        if full_cover:
            dst[-1] = alloc.cow(shared[-1])
        fresh = [alloc.alloc() for _ in range(need - len(dst))]
        self._slot_blocks[slot_idx] = dst + fresh
        self.prefix_prompt_tokens += S
        self.prefix_hit_tokens += min(covered, S)
        self.prefill_tokens_skipped += start
        self.block_hwm = max(self.block_hwm, alloc.in_use)
        return src + fresh, dst + fresh, start

    def _table(self, blocks: list[int]) -> np.ndarray:
        """A block table row: ``blocks``, then the sentinel."""
        table = np.full(self.max_blocks, self.num_blocks, np.int32)
        table[:len(blocks)] = blocks
        return table

    def _admit_paged(self, q: _Queued, slot_idx: int,
                     done: list[FinishedRequest]) -> bool:
        """Reserve the request's lifetime blocks (``_reserve``), then
        prefill the whole prompt and scatter it into its blocks, or, on a
        prefix hit, prefill only the suffix through the shared blocks
        (``Model.resume_prefill``; a full cover writes its last block's copy
        on write).  Returns False, holding nothing, when the blocks do not
        fit yet."""
        t0 = time.perf_counter()
        req = q.req
        hashes = (chain_hashes(req.inputs["tokens"].cpu().numpy(),
                               self.block) if self.prefix_cache else [])
        reserved = self._reserve(q, slot_idx, hashes)
        if reserved is None:
            return False
        src, dst, start = reserved
        dev = self.model.device
        src_t = torch.from_numpy(self._table(src)).to(dev)
        dst_t = torch.from_numpy(self._table(dst)).to(dev)
        # ---- prefill: the whole prompt (scatter) or the suffix (resume)
        if start == 0:
            logits, row_cache = self._row_prefill(self._admit_inputs(q))
            if self.graph is not None:
                self.graph.splice_paged(row_cache, slot_idx, q.prompt_len,
                                        dst_t)
            else:
                self.model.splice_cache_paged(self.cache, row_cache,
                                              slot_idx, dst_t)
        else:
            self.admissions += 1
            logits = self.model.resume_prefill(
                self.params, self.cache, req.inputs["tokens"][:, start:],
                slot_idx, src_t, dst_t, start, self.graph)
        # ---- publish the prompt's full blocks for later sharing
        for bid, h in zip(dst, hashes):
            self.allocator.publish(bid, h)
        # ---- first token
        slot = self._start_slot(q)
        tok, lp = self._pick(logits[:, -1], [slot])
        self._emit(slot, tok[0], lp[0])
        if self._finished_reason(slot):
            done.append(self._retire(slot))
            self._release_blocks(slot_idx)  # never occupied a decode slot
        else:
            self.slots[slot_idx] = slot
        self.admit_s += time.perf_counter() - t0
        return True

    def _admit_chunked(self, q: _Queued, slot_idx: int) -> bool:
        """Admit under chunked prefill: reserve the slot (paged: its blocks,
        ``_reserve``) and arm its chunk state; no prefill runs here, the
        mixed steps stream the prompt through the chunk lanes.  The chunks
        read and write through the slot's own table, so a full cover's copy
        on write is made here, eagerly (``Model.copy_blocks``).  Returns
        False, holding nothing, when the blocks do not fit yet.  (The
        reference builds its pool here on first use; the port's exists from
        construction.)"""
        t0 = time.perf_counter()
        toks = q.req.inputs["tokens"].cpu().numpy().reshape(-1)
        start, table = 0, None
        if self.paged:
            reserved = self._reserve(
                q, slot_idx,
                chain_hashes(toks, self.block) if self.prefix_cache else [])
            if reserved is None:
                return False
            src, dst, start = reserved
            for a, b in zip(src, dst):
                if a != b:
                    self.model.copy_blocks(self.cache, a, b)
            table = self._table(dst)
        slot = self._start_slot(q)
        slot.prefill_pos, slot.prefill_toks = start, toks
        slot.prefill_table = table
        self.slots[slot_idx] = slot
        self.admit_s += time.perf_counter() - t0
        return True

    def _release_blocks(self, slot_idx: int) -> None:
        blocks = self._slot_blocks[slot_idx]
        if blocks is not None:
            for bid in blocks:
                self.allocator.decref(bid)
            self._slot_blocks[slot_idx] = None

    def _free_slot(self, i: int) -> None:
        """Empty slot ``i`` after its request retired: its blocks' references
        go back to the allocator."""
        if self.paged:
            self._release_blocks(i)
        self.slots[i] = None
    # -------------------------------------------------------------- sampling
    def _pick(self, logits: torch.Tensor, slots: list[_Slot | None]
              ) -> tuple[list[int], list[float]]:
        """logits [n, V] fp32 → (tokens, logprobs) for the n rows: greedy
        argmax, or for a row whose slot samples, a draw from its own
        generator from the softmax of its top-k-filtered logits over its
        temperature.  Greedy and empty rows draw nothing."""
        lp = torch.log_softmax(logits, -1)
        tok = torch.argmax(logits, -1)
        V = logits.shape[-1]
        for i, s in enumerate(slots):
            if s is None or s.temperature <= 0.0:
                continue
            row = logits[i]
            if s.top_k > 0:
                kth = torch.topk(row, min(s.top_k, V)).values[-1]
                row = row.masked_fill(row < kth, NEG_INF)
            probs = torch.softmax(row / s.temperature, -1)
            tok[i] = torch.multinomial(probs, 1, generator=s.key)[0]
        return (tok.tolist(),
                lp.gather(-1, tok[:, None])[:, 0].tolist())

    # ---------------------------------------------------------------- decode
    def _decoding(self) -> list[_Slot | None]:
        """The slots that decode: mid-prefill ones read as empty."""
        return [s if s is not None and s.prefill_pos is None else None
                for s in self.slots]

    def _decode_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Host-side inputs of the masked decode step: each decoding slot's
        last token, and the active mask (a mid-prefill slot is not active:
        the decode leaves its partly built row alone)."""
        toks = np.zeros((self.num_slots, 1), np.int64)
        active = np.zeros((self.num_slots,), bool)
        for i, s in enumerate(self._decoding()):
            if s is not None:
                toks[i, 0] = s.last_tok
                active[i] = True
        return toks, active

    def _finish_decode(self, logits: torch.Tensor,
                       done: list[FinishedRequest]) -> None:
        """Pick, emit and retire for one decode step's logits [B, V];
        mid-prefill slots draw nothing and get no token."""
        decoding = self._decoding()
        tok, lp = self._pick(logits, decoding)
        self.steps_run += 1
        for i, s in enumerate(decoding):
            if s is None:
                continue
            self._emit(s, tok[i], lp[i])
            if self._finished_reason(s):
                done.append(self._retire(s))
                self._free_slot(i)

    def _decode_once(self, done: list[FinishedRequest]) -> None:
        self.plain_steps += 1
        toks, active = self._decode_arrays()
        if self.graph is not None:
            logits = self.graph(torch.from_numpy(toks), active)
        else:
            dev = self.model.device
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, torch.from_numpy(toks).to(dev),
                torch.from_numpy(active).to(dev))
        # the pick reads the graph's static logits before the next replay
        self._finish_decode(logits[:, 0], done)

    def _mixed_once(self, done: list[FinishedRequest]) -> None:
        """One mixed step: up to ``chunk_lanes`` prompt chunks of the
        mid-prefill slots, best rank first (unused lanes inactive: slot 0,
        start 0, true length 1, tables all sentinel), then the masked
        decode of the decoding slots; a replay of ``DecodeGraph.mixed(K,
        C)`` on the card, ``Model.mixed_step`` otherwise."""
        K, C = self.chunk_lanes, self.chunk_size
        toks, active = self._decode_arrays()
        pref = sorted(((-s.priority, s.submit_time), i)
                      for i, s in enumerate(self.slots)
                      if s is not None and s.prefill_pos is not None)
        lanes = {"tokens": np.zeros((K, C), np.int64),
                 "slot": np.zeros((K,), np.int32),
                 "start": np.zeros((K,), np.int32),
                 "true": np.ones((K,), np.int32),
                 "active": np.zeros((K,), bool)}
        if self.paged:
            lanes["tables"] = np.full((K, self.max_blocks), self.num_blocks,
                                      np.int32)
        run = []
        for j, (_, i) in enumerate(pref[:K]):
            s = self.slots[i]
            start = s.prefill_pos
            take = min(C, len(s.prefill_toks) - start)
            lanes["tokens"][j, :take] = s.prefill_toks[start:start + take]
            lanes["slot"][j], lanes["start"][j] = i, start
            lanes["true"][j], lanes["active"][j] = take, True
            if self.paged:
                lanes["tables"][j] = s.prefill_table
            run.append((i, start + take))
        if self.graph is not None:
            logits, ck_logits = self.graph.mixed(K, C)(
                torch.from_numpy(toks), active, lanes)
        else:
            dev = self.model.device
            arrays = {k: torch.from_numpy(v).to(dev)
                      for k, v in lanes.items()}
            logits, ck_logits, self.cache = self.model.mixed_step(
                self.params, self.cache, torch.from_numpy(toks).to(dev),
                torch.from_numpy(active).to(dev), arrays["tokens"],
                arrays["slot"], arrays["start"], arrays["true"],
                arrays["active"], arrays.get("tables"))
        self.mixed_steps += 1
        self.prefill_chunks += len(run)
        # the picks read the graph's static logits before the next replay
        if active.any():
            self._finish_decode(logits[:, 0], done)
        for j, (i, pos) in enumerate(run):
            s = self.slots[i]
            s.prefill_pos = pos
            if pos >= len(s.prefill_toks):
                self._complete_prefill(i, s, ck_logits[j:j + 1], done)

    def _complete_prefill(self, i: int, s: _Slot, logits: torch.Tensor,
                          done: list[FinishedRequest]) -> None:
        """Slot ``i`` ran its last chunk: publish its prompt's full blocks
        for later sharing, pick its first token from the lane's logits
        [1, V] (through its own generator, as an admission picks) and make
        it a decoding slot."""
        if self.paged and self.prefix_cache:
            for bid, h in zip(self._slot_blocks[i],
                              chain_hashes(s.prefill_toks, self.block)):
                self.allocator.publish(bid, h)
        s.prefill_pos = s.prefill_toks = s.prefill_table = None
        tok, lp = self._pick(logits, [s])
        self._emit(s, tok[0], lp[0])
        if self._finished_reason(s):
            done.append(self._retire(s))
            self._free_slot(i)

    def _finished_reason(self, slot: _Slot) -> str | None:
        if self.eos_id is not None and slot.last_tok == self.eos_id:
            return "eos"
        if len(slot.tokens) >= slot.max_new:
            return "length"
        return None

    def _retire(self, slot: _Slot,
                reason: str | None = None) -> FinishedRequest:
        return FinishedRequest(
            uid=slot.uid,
            tokens=np.asarray(slot.tokens, np.int64),
            logprobs=np.asarray(slot.logprobs, np.float32),
            finish_reason=reason or self._finished_reason(slot),
            prompt_len=slot.prompt_len,
            submit_time=slot.submit_time,
            finish_time=time.perf_counter(),
            first_token_time=slot.first_token_time)


def make_requests(batch: dict, max_new_tokens: int,
                  generator: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0) -> list[Request]:
    """Split a batch (``engine.generate``'s contract) into one Request per
    row, every input array of it (the tokens, the front end's embeddings)
    by row; the row index becomes the uid.  With ``generator``,
    each row samples from a generator of its own on the same device,
    seeded by a draw from ``generator`` (the counterpart of ``fold_in(key,
    row)``)."""
    arrays = {k: v for k, v in batch.items() if k != "cache_len"}
    out = []
    for b in range(arrays["tokens"].shape[0]):
        key = None
        if generator is not None:
            key = torch.Generator(device=generator.device)
            key.manual_seed(int(torch.randint(
                0, 2 ** 62, (), generator=generator,
                device=generator.device)))
        out.append(Request(uid=b, inputs={k: v[b:b + 1]
                                          for k, v in arrays.items()},
                           max_new_tokens=max_new_tokens, key=key,
                           temperature=temperature, top_k=top_k))
    return out
