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

Failure paths thread through the same lifecycle (DESIGN.md §11), as in
the reference:

  deadlines: ``Request.deadline_s`` (a TTL from submit, on the
  scheduler's clock, ``clock=``, ``time.perf_counter`` by default) retires
  overdue work at the next ``step()`` with ``finish_reason="deadline"``
  (partial tokens included) and frees its slot and blocks; ``cancel(uid)``
  does the same on demand (``"cancelled"``), ``drop(uid)`` without a
  result (journal replay), and ``hold_admissions`` gates admission.

  preemption (``preempt=True``, the default): when the best queued
  request outranks the least important active slot (``priority``, then
  submit time), the victim is evicted: paged with the prefix cache, its
  full blocks of computed KV are published first (a victim mid-prefill's
  up to its chunk cursor), and it is requeued with its partial tokens,
  logprobs and its own generator (the same object); its re-admission
  prefills the resume prompt (prompt + tokens so far), reacquiring the
  published blocks, so the stream continues where it stopped.  Its
  'slot' leaves (an SSM state and conv history, xk/xv) are rebuilt by that
  prefill.  A victim ranks strictly below its preemptor, so the top
  request always runs to its end (no livelock).

  live resize: ``resize(num_slots=, num_blocks=)`` grows at once and
  shrinks once the excess slots or blocks have drained, never dropping an
  in-flight request.  On a card the pool of the new geometry is the
  static cache of another slot-pool graph (``graphed_decode_step``'s key
  holds the slots and, paged, the blocks; captured over zeros at its
  first bind): the old pool's rows, positions, tables and first blocks are
  copied in and the old graph is released.  Its resume and mixed graphs
  are captured again at their first use.

  snapshots: ``snapshot()`` is the whole serving state on the host (the
  queue, the slots with their partial tokens and generator states, the
  allocator's ledger, the pool's leaves, bf16 ones as torch tensors, the
  counters); ``Scheduler.from_snapshot`` rebuilds it mid-stream, on a card
  by binding the graph of the snapshot's geometry and copying the pool
  into its static cache, so the surviving streams continue bit for bit.
  ``close()`` releases a scheduler's graph: a restart or a recovery binds
  it while the dead scheduler may still hold rows.

Not ported (ROADMAP.md Queue 1 item 10): the mesh.  The constructor
refuses the argument.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.models.graph import DecodeGraph
from repro_torch.models.model import Model
from repro_torch.models.spec import map_tree, tree_leaves
from .paging import BlockAllocator, chain_hashes, logical_blocks

NEG_INF = -1e30

# the reference's Scheduler arguments this port leaves out, by the
# ROADMAP.md Queue 1 item that brings them
NOT_PORTED = {"mesh": 10}


@dataclasses.dataclass
class Request:
    """One generation request.  ``inputs`` holds ``tokens [1, S]`` (and an
    encoder-decoder's ``speech_embeds [1, F, frontend_dim]``, a
    vision-language model's ``image_embeds [1, S_img, frontend_dim]``).
    ``temperature`` 0 is greedy (draws nothing), ``top_k`` 0 disables the
    top-k filter; ``key`` is the request's own sampling stream, a
    ``torch.Generator`` on the model's device.  ``priority`` orders
    admission and preemption (higher wins; ties go to the older request);
    ``deadline_s`` is a TTL from submit after which the request retires
    with ``finish_reason="deadline"``.  ``on_token`` (optional callable
    ``(uid, index, token, logprob)``) streams each generated token as it is
    picked, on the thread that steps the scheduler: the streaming front
    end's hook (``serving.engine.StreamEngine``).  It is host-side state,
    left out of snapshots and journals (a reconnecting client replays the
    engine's buffers instead)."""
    uid: int
    inputs: dict
    max_new_tokens: int
    key: torch.Generator | None = None
    temperature: float = 0.0
    top_k: int = 0
    priority: int = 0
    deadline_s: float | None = None
    on_token: object | None = dataclasses.field(default=None, repr=False,
                                                compare=False)


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    tokens: np.ndarray                    # [n_generated] int64
    logprobs: np.ndarray                  # [n_generated] float32
    finish_reason: str      # "eos" | "length" | "deadline" | "cancelled"
    prompt_len: int
    submit_time: float                    # the clock at submit()
    finish_time: float                    # the clock at retirement
    first_token_time: float | None = None  # the clock at the first token


@dataclasses.dataclass
class _Resume:
    """What a preempted request has generated: enough to continue its
    stream after its re-admission."""
    tokens: list[int]
    logprobs: list[float]
    key: torch.Generator | None           # its stream, the same object
    last_tok: int
    first_token_time: float | None = None


@dataclasses.dataclass
class _Queued:
    req: Request
    prompt_len: int
    submit_time: float
    deadline: float | None = None         # absolute, on the clock
    resume: _Resume | None = None         # set on a preempted requeue


@dataclasses.dataclass
class _Slot:
    uid: int
    req: Request                          # a preemption requeues it
    max_new: int
    key: torch.Generator | None
    prompt_len: int
    submit_time: float
    temperature: float = 0.0
    top_k: int = 0
    priority: int = 0
    deadline: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    last_tok: int = 0
    first_token_time: float | None = None
    # the chunk state: ``prefill_pos`` is None once the prompt is
    # prefilled (the slot decodes); while it prefills, the prompt tokens
    # already processed.  ``prefill_toks`` is the prompt (a resumed
    # request's with its tokens so far), ``prefill_table`` the slot's
    # sentinel-padded block table (paged pools).
    prefill_pos: int | None = None
    prefill_toks: np.ndarray | None = dataclasses.field(default=None,
                                                        repr=False)
    prefill_table: np.ndarray | None = dataclasses.field(default=None,
                                                         repr=False)


def _host(t: torch.Tensor):
    """A copy of ``t`` on the host: numpy, or a CPU tensor for bf16 (which
    numpy has no type for; ``core.durable`` stores both)."""
    if t.dtype == torch.bfloat16:
        return t.detach().to("cpu", copy=True)
    return t.detach().cpu().numpy().copy()


def _gen_state(g: torch.Generator | None) -> np.ndarray | None:
    return None if g is None else g.get_state().numpy().copy()


class Scheduler:
    """Continuous-batching loop: ``submit()`` any time, ``step()`` admits
    queued requests into free slots and advances every active slot by one
    token, ``run()`` drains."""

    def __init__(self, model: Model, params, num_slots: int, cache_len: int,
                 *, eos_id: int | None = None, seed: int = 0,
                 paged: bool = False, block_size: int = 64,
                 num_blocks: int | None = None, prefix_cache: bool = True,
                 bucket_prompts: bool = True, preempt: bool = True,
                 clock=None, graph: bool = True,
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
        self.preempt = preempt
        # the clock of deadlines and time stamps: tests and the fault
        # harness drive a virtual one
        self._now = clock if clock is not None else time.perf_counter
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
        self.preemptions = 0              # slots evicted and requeued
        self.recomputed_tokens = 0        # prompt tokens a resume prefills
        self.cancelled = 0                # requests cancelled via cancel()
        self.expired = 0                  # requests retired past deadline
        self.prefill_chunks = 0           # chunk lanes executed
        self.mixed_steps = 0              # steps through the mixed step
        self.plain_steps = 0              # steps through the decode step
        self._target_slots: int | None = None   # pending slot shrink
        self.hold_admissions = False      # fault/SLO gate: skip admission
        self.closed = False
        # on a card, the slot-pool decode step; its static cache is the pool
        self.graph: DecodeGraph | None = None
        self.cache: dict | None = None
        # the frame count of an encoder-decoder's pool, built at the first
        # admission (None until then); 0 for every other model
        self.enc_T: int | None = None
        if not model.cfg.enc_dec:
            self._build_pool(0)

    def _new_pool(self, B: int, num_blocks: int | None, enc_T: int
                  ) -> tuple[DecodeGraph | None, dict]:
        """(graph, pool) of ``B`` slots (paged: ``num_blocks`` blocks) over
        ``enc_T`` frames: on a card unless ``graph=False``, the slot-pool
        decode graph of that geometry, bound to this scheduler (captured
        over zeros when its key is new), and its static cache; otherwise a
        zeroed pool and None."""
        model, T = self.model, self.cache_len
        geometry = (num_blocks, self.block) if self.paged else None
        if self.graphed and model.device.type == "cuda":
            graph = model.graphed_decode_step(B, T, masked=True,
                                              paged=geometry, enc_T=enc_T)
            graph.bind(self, self.params)
            return graph, graph.cache
        if self.paged:
            return None, model.init_cache(B, T, paged=True,
                                          num_blocks=num_blocks,
                                          block=self.block, enc_T=enc_T)
        return None, model.init_cache(B, T, per_row=True, enc_T=enc_T)

    def _build_pool(self, enc_T: int) -> None:
        """The pool (its xk/xv over ``enc_T`` frames) and, on a card unless
        ``graph=False``, the slot-pool decode graph it is the static cache
        of, bound to this scheduler."""
        self.graph, self.cache = self._new_pool(
            self.num_slots, self.num_blocks if self.paged else None, enc_T)
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
        their blocks must fit the pool (the size a pending shrink leaves)
        even when every other request has retired.  A vision-language
        model's prompt is its image rows and its tokens; a request of a
        model with a front end needs the front end's embeddings."""
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
        t = self._now() if submit_time is None else submit_time
        self.queue.append(_Queued(
            req, S, t,
            deadline=None if req.deadline_s is None else t + req.deadline_s))

    def cancel(self, uid: int) -> bool:
        """Cancel a request, queued or in flight: it retires with
        ``finish_reason="cancelled"`` (partial tokens included) and frees
        its slot and blocks.  Returns False for an unknown uid."""
        for qi, q in enumerate(self.queue):
            if q.req.uid == uid:
                del self.queue[qi]
                self.finished.append(self._finish_queued(q, "cancelled"))
                self.cancelled += 1
                return True
        for i, s in enumerate(self.slots):
            if s is not None and s.uid == uid:
                self.finished.append(self._evict(i, "cancelled"))
                self.cancelled += 1
                return True
        return False

    def drop(self, uid: int) -> bool:
        """Remove a request, queued or in flight, WITHOUT a result: its
        slot and blocks are freed and nothing lands in ``finished``.
        Journal replay uses this where a retire record is authoritative
        (the journaled tokens were acknowledged; the restored live copy
        must vanish).  Returns False for an unknown uid."""
        for qi, q in enumerate(self.queue):
            if q.req.uid == uid:
                del self.queue[qi]
                return True
        for i, s in enumerate(self.slots):
            if s is not None and s.uid == uid:
                self._free_slot(i)
                return True
        return False

    def close(self) -> None:
        """Serve no more steps, and release the slot-pool graph, so that a
        scheduler restored or recovered from this one's state binds it
        whatever rows this one left in it (``DecodeGraph.release``)."""
        self.closed = True
        if self.graph is not None:
            self.graph.release(self)

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
               "preemptions": self.preemptions,
               "recomputed_tokens": self.recomputed_tokens,
               "cancelled": self.cancelled, "expired": self.expired}
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
        self.preemptions = self.recomputed_tokens = 0
        self.cancelled = self.expired = self.prefill_chunks = 0
        self.mixed_steps = self.plain_steps = 0
        self.admit_s = 0.0
        if self.paged:
            self.block_hwm = self.allocator.in_use
            self.prefix_hit_tokens = self.prefix_prompt_tokens = 0
            self.prefill_tokens_skipped = 0

    def step(self) -> list[FinishedRequest]:
        """One scheduler tick: retire overdue work, land a drained resize,
        admit into free slots best-rank-first (paged: when the blocks fit;
        preemption may evict a lower-ranked slot) unless admissions are
        held, then run one masked decode step, or, while a slot is
        mid-prefill, one mixed step (its chunk lanes, then the decode).
        Returns the requests retired during this call.  A closed
        scheduler, or one whose decode graph another scheduler has bound
        since, raises."""
        if self.closed:
            raise RuntimeError("the scheduler was closed")
        if self.graph is not None and self.graph.holder() is not self:
            raise RuntimeError("the slot-pool decode graph was bound by "
                               "another scheduler")
        done: list[FinishedRequest] = []
        self._expire(self._now(), done)
        self._apply_pending_resize()
        if not self.hold_admissions:
            self._admit_phase(done)
        if self.num_active:
            if any(s is not None and s.prefill_pos is not None
                   for s in self.slots):
                self._mixed_once(done)
            else:
                self._decode_once(done)
        # a retirement of this step may have been the last thing a pending
        # shrink waited for: land it now, not one step later
        self._apply_pending_resize()
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

    # ----------------------------------------------------- deadlines, cancels
    def _finish_queued(self, q: _Queued, reason: str) -> FinishedRequest:
        """Retire a request straight out of the queue (cancel, deadline); a
        preempted requeue keeps its partial tokens."""
        r = q.resume
        return FinishedRequest(
            uid=q.req.uid,
            tokens=np.asarray(r.tokens if r else [], np.int64),
            logprobs=np.asarray(r.logprobs if r else [], np.float32),
            finish_reason=reason, prompt_len=q.prompt_len,
            submit_time=q.submit_time, finish_time=self._now(),
            first_token_time=r.first_token_time if r else None)

    def _evict(self, i: int, reason: str) -> FinishedRequest:
        """Retire active slot ``i`` early (cancel, deadline): its partial
        tokens, and the slot and its blocks freed."""
        f = self._retire(self.slots[i], reason)
        self._free_slot(i)
        return f

    def _expire(self, now: float, done: list[FinishedRequest]) -> None:
        """Retire everything past its deadline: queued requests before any
        prefill, active slots with their partial tokens."""
        if any(q.deadline is not None and now >= q.deadline
               for q in self.queue):
            keep: deque[_Queued] = deque()
            for q in self.queue:
                if q.deadline is not None and now >= q.deadline:
                    done.append(self._finish_queued(q, "deadline"))
                    self.expired += 1
                else:
                    keep.append(q)
            self.queue = keep
        for i, s in enumerate(self.slots):
            if s is not None and s.deadline is not None \
                    and now >= s.deadline:
                done.append(self._evict(i, "deadline"))
                self.expired += 1

    # ------------------------------------------------------------- admission
    @staticmethod
    def _rank(priority: int, submit_time: float) -> tuple:
        """Admission and preemption order: smaller sorts first (better).
        Higher priority wins; ties go to the older request."""
        return (-priority, submit_time)

    def _qrank(self, q: _Queued) -> tuple:
        return self._rank(q.req.priority, q.submit_time)

    def _srank(self, s: _Slot) -> tuple:
        return self._rank(s.priority, s.submit_time)

    def _slot_limit(self) -> int:
        """The admissible slots: a pending shrink stops filling the
        draining tail."""
        return (self._target_slots if self._target_slots is not None
                else self.num_slots)

    def _admit_phase(self, done: list[FinishedRequest]) -> None:
        """Admit queued requests best-rank-first.  When the best one cannot
        start (no free slot, or its blocks do not fit), preemption may
        evict a strictly lower-ranked active slot; if it still cannot
        start, admission stops: no request jumps over a better one."""
        while self.queue:
            qi = min(range(len(self.queue)),
                     key=lambda j: self._qrank(self.queue[j]))
            q = self.queue[qi]
            free = next((i for i in range(self._slot_limit())
                         if self.slots[i] is None), None)
            if free is None:
                if not self._preempt_for(q):
                    break
                continue                  # a slot was freed: retry
            if self._try_admit(q, free, done):
                del self.queue[qi]
                continue
            if not self._preempt_for(q):  # paged: its blocks do not fit
                break

    def _preempt_for(self, q: _Queued) -> bool:
        """Evict the worst-ranked active slot if it ranks strictly below
        ``q``.  Returns True iff a victim was preempted."""
        if not self.preempt:
            return False
        cand = [(self._srank(s), i)
                for i, s in enumerate(self.slots) if s is not None]
        if not cand:
            return False
        rank, victim = max(cand)
        if rank <= self._qrank(q):        # never an equal-or-better victim
            return False
        self._preempt(victim)
        return True

    @staticmethod
    def _resume_tokens(req: Request, generated: list[int]) -> np.ndarray:
        """The tokens of a resume prompt (int64): the request's prompt,
        then the tokens it generated so far."""
        orig = req.inputs["tokens"].cpu().numpy().reshape(-1)
        return np.concatenate([orig, np.asarray(generated, orig.dtype)])

    def _preempt(self, i: int) -> None:
        """Evict slot ``i`` and requeue it to resume.  Paged with the
        prefix cache, its full blocks of computed KV are published first,
        so the re-admission reacquires them and recomputes only the tail:
        a decoding slot has KV for its prompt and every token but the last
        (the next decode's input), a slot mid-prefill up to its chunk
        cursor.  The partial tokens, logprobs and generator ride on the
        queue entry."""
        s = self.slots[i]
        if self.paged:
            blocks = self._slot_blocks[i]
            if self.prefix_cache and blocks:
                n_valid = (s.prefill_pos if s.prefill_pos is not None
                           else s.prompt_len + len(s.tokens) - 1)
                n_pub = min(n_valid // self.block, len(blocks))
                if n_pub > 0:
                    toks = self._resume_tokens(s.req, s.tokens)
                    hashes = chain_hashes(toks[:n_pub * self.block],
                                          self.block)
                    for bid, h in zip(blocks[:n_pub], hashes):
                        self.allocator.publish(bid, h)
        self._free_slot(i)
        self.queue.append(_Queued(
            req=s.req, prompt_len=s.prompt_len, submit_time=s.submit_time,
            deadline=s.deadline,
            resume=_Resume(list(s.tokens), list(s.logprobs), s.key,
                           s.last_tok, s.first_token_time)))
        self.preemptions += 1

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
                finish_time=self._now()))
            return True
        if self.chunk_prefill:
            return self._admit_chunked(q, slot_idx)
        if self.paged:
            return self._admit_paged(q, slot_idx, done)
        self._admit_dense(q, slot_idx, done)
        return True

    def _admit_inputs(self, q: _Queued) -> tuple[dict, int]:
        """The prefill's inputs and the prompt's rows: the prompt (and the
        front end's embeddings, an encoder-decoder's speech frames or a
        vision-language model's images) on the model's device, into a cache
        of the pool's length.  A preempted requeue resumes with the prompt
        followed by the tokens it generated: its prefill rebuilds the KV
        and the 'slot' leaves, and its last logits pick the token the
        interrupted decode step would have picked."""
        dev, inputs = self.model.device, q.req.inputs
        keys = ("tokens",) + ((self.model.front_input,)
                              if self.model.front_input else ())
        out = {k: inputs[k].to(dev) for k in keys}
        S = q.prompt_len
        if q.resume is not None:
            toks = out["tokens"]
            out["tokens"] = torch.cat([toks, torch.tensor(
                [q.resume.tokens], dtype=toks.dtype, device=dev)], 1)
            S += len(q.resume.tokens)
        out["cache_len"] = self.cache_len
        return out, S

    def _prompt_tokens(self, q: _Queued) -> np.ndarray:
        """The tokens of ``q``'s prompt on the host, a resume's included."""
        return self._resume_tokens(
            q.req, q.resume.tokens if q.resume is not None else [])

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
        req, r = q.req, q.resume
        s = _Slot(uid=req.uid, req=req, max_new=req.max_new_tokens,
                  key=r.key if r is not None else self._req_key(req),
                  prompt_len=q.prompt_len, submit_time=q.submit_time,
                  temperature=float(req.temperature),
                  top_k=int(req.top_k), priority=int(req.priority),
                  deadline=q.deadline)
        if r is not None:                 # continue the interrupted stream
            s.tokens, s.logprobs = list(r.tokens), list(r.logprobs)
            s.last_tok, s.first_token_time = r.last_tok, r.first_token_time
        return s

    def _emit(self, slot: _Slot, tok: int, lp: float) -> None:
        """Append one generated token to a slot, stamping the first, and
        hand it to the request's ``on_token``.  The single funnel of
        generated tokens: admission first tokens, chunk-completion first
        tokens and decode steps all come through here; a resumed slot
        continues from its requeued tokens, so none is emitted twice."""
        slot.tokens.append(tok)
        slot.logprobs.append(lp)
        slot.last_tok = tok
        self.tokens_out += 1
        if slot.first_token_time is None:
            slot.first_token_time = self._now()
        cb = slot.req.on_token
        if cb is not None:
            cb(slot.uid, len(slot.tokens) - 1, tok, lp)

    def _admit_dense(self, q: _Queued, slot_idx: int,
                     done: list[FinishedRequest]) -> None:
        t0 = time.perf_counter()
        inputs, S = self._admit_inputs(q)
        if q.resume is not None:
            self.recomputed_tokens += S
        logits, row_cache = self._row_prefill(inputs)
        slot = self._start_slot(q)
        tok, lp = self._pick(logits[:, -1], [slot])
        self._emit(slot, tok[0], lp[0])
        if self._finished_reason(slot):
            done.append(self._retire(slot))
        else:                             # occupies a decode slot
            if self.graph is not None:
                self.graph.splice(row_cache, slot_idx, S)
            else:
                self.model.splice_cache(self.cache, row_cache, slot_idx)
            self.slots[slot_idx] = slot
        self.admit_s += time.perf_counter() - t0

    def _reserve(self, q: _Queued, slot_idx: int, hashes: list[bytes],
                 S: int) -> tuple[list[int], list[int], int] | None:
        """Reserve ``q``'s lifetime blocks (its prompt and budget, invariant
        under preemption) for slot ``slot_idx``, sharing the longest chain
        of resident blocks whose chained hashes are ``hashes`` (empty
        without the prefix cache) of its prompt of ``S`` rows (a resume's
        included), and count them: (source blocks, destination blocks, the
        first prompt position to compute), or None, holding nothing, when
        they do not fit yet.  A prefill computes >= 1 token for the
        logits, so full coverage takes the last matched block copy on
        write (the one entry where the destination differs) and recomputes
        its last token."""
        alloc = self.allocator
        need = logical_blocks(min(q.prompt_len + q.req.max_new_tokens,
                                  self.cache_len), self.block)
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
        if q.resume is not None:
            self.recomputed_tokens += S - start
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
        prefix hit (a resumed request's own published blocks included),
        prefill only the suffix through the shared blocks
        (``Model.resume_prefill``; a full cover writes its last block's
        copy on write).  Returns False, holding nothing, when the blocks do
        not fit yet."""
        t0 = time.perf_counter()
        inputs, S = self._admit_inputs(q)
        hashes = (chain_hashes(self._prompt_tokens(q), self.block)
                  if self.prefix_cache else [])
        reserved = self._reserve(q, slot_idx, hashes, S)
        if reserved is None:
            return False
        src, dst, start = reserved
        dev = self.model.device
        src_t = torch.from_numpy(self._table(src)).to(dev)
        dst_t = torch.from_numpy(self._table(dst)).to(dev)
        # ---- prefill: the whole prompt (scatter) or the suffix (resume)
        if start == 0:
            logits, row_cache = self._row_prefill(inputs)
            if self.graph is not None:
                self.graph.splice_paged(row_cache, slot_idx, S, dst_t)
            else:
                self.model.splice_cache_paged(self.cache, row_cache,
                                              slot_idx, dst_t)
        else:
            self.admissions += 1
            logits = self.model.resume_prefill(
                self.params, self.cache, inputs["tokens"][:, start:],
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
        mixed steps stream the prompt (a resume's included) through the
        chunk lanes.  The chunks read and write through the slot's own
        table, so a full cover's copy on write is made here, eagerly
        (``Model.copy_blocks``).  Returns False, holding nothing, when the
        blocks do not fit yet.  (The reference builds its pool here on
        first use; the port's exists from construction.)"""
        t0 = time.perf_counter()
        toks = self._prompt_tokens(q)
        start, table = 0, None
        if self.paged:
            reserved = self._reserve(
                q, slot_idx,
                chain_hashes(toks, self.block) if self.prefix_cache else [],
                len(toks))
            if reserved is None:
                return False
            src, dst, start = reserved
            for a, b in zip(src, dst):
                if a != b:
                    self.model.copy_blocks(self.cache, a, b)
            table = self._table(dst)
        elif q.resume is not None:
            self.recomputed_tokens += len(toks)
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
        """Empty slot ``i`` after its request left: its blocks' references
        go back to the allocator."""
        if self.paged:
            self._release_blocks(i)
        self.slots[i] = None

    # ----------------------------------------------------------------- resize
    def resize(self, num_slots: int | None = None,
               num_blocks: int | None = None) -> dict:
        """Live pool resize, the knob an autoscaler turns.  Growth applies
        at once (new slot rows and arena blocks, new block ids on the free
        list).  A shrink never drops an in-flight request: the slot tail
        stops admitting and the allocator's fence stops handing out high
        ids, and the pool moves at a later ``step()`` once they drained.
        On a card a move binds the slot-pool graph of the new geometry
        (``_move_pool``).  Returns the current and pending geometry."""
        B = self.num_slots
        nb = self.num_blocks if self.paged else None
        if num_slots is not None:
            if num_slots < 1:
                raise ValueError("num_slots must be >= 1")
            if num_slots >= self.num_slots:
                B, self._target_slots = num_slots, None
            else:
                self._target_slots = num_slots
        if num_blocks is not None:
            if not self.paged:
                raise ValueError("num_blocks resize requires paged=True")
            if self.allocator.resize(num_blocks):
                nb = num_blocks
            # else fenced: _apply_pending_resize lands it once drained
        self._apply_pending_resize(B, nb)
        return {"num_slots": self.num_slots,
                "num_blocks": self.num_blocks if self.paged else None,
                "pending_slots": self._target_slots,
                "pending_blocks": (self.allocator.pending_target
                                   if self.paged else None)}

    def _apply_pending_resize(self, B: int | None = None,
                              nb: int | None = None) -> None:
        """Move the pool to ``B`` slots and ``nb`` blocks (default: as they
        are), landing a pending shrink of either whose excess drained."""
        B = self.num_slots if B is None else B
        t = self._target_slots
        if t is not None and all(s is None for s in self.slots[t:]):
            B, self._target_slots = t, None
        if self.paged:
            nb = self.num_blocks if nb is None else nb
            if self.allocator.shrink_ready:
                nb = self.allocator.pending_target
                self.allocator.finalize_shrink()
        if B == self.num_slots and (not self.paged or nb == self.num_blocks):
            return
        self._move_pool(B, nb)
        if B < self.num_slots:
            del self.slots[B:]
        else:
            self.slots.extend([None] * (B - self.num_slots))
        if self.paged:
            if B < self.num_slots:
                del self._slot_blocks[B:]
            else:
                self._slot_blocks.extend([None] * (B - self.num_slots))
            self.num_blocks = nb
        self.num_slots = B

    @torch.no_grad()
    def _move_pool(self, B: int, nb: int | None) -> None:
        """Move the pool to ``B`` slots (paged: ``nb`` blocks): a zeroed
        pool of the new geometry (on a card the static cache of its bound
        slot-pool graph) gets the first min(old, new) rows of every 'slot'
        leaf (dense: of every leaf), of the positions and of the tables
        (fresh rows at the sentinel; any entry at or above the smaller
        block count, a sentinel or a stale id of a retired row, collapses
        onto the new sentinel, as live ids lie below it), and the arenas'
        first blocks: grown, the old blocks and the old sentinel slab (now
        a free block), shrunk, the first ``nb`` (the new sentinel slab
        zero).  The old graph is released.  Nothing to move before an
        encoder-decoder's first admission built the pool."""
        old, old_graph = self.cache, self.graph
        if old is None:
            return
        model = self.model
        graph, new = self._new_pool(B, nb, self.enc_T)
        for t in tree_leaves(new):
            t.zero_()
        n = min(B, self.num_slots)
        new["pos"][:n].copy_(old["pos"][:n])
        if not self.paged:
            for d, s in zip(tree_leaves(new), tree_leaves(old)):
                d[:n].copy_(s[:n])
        else:
            old_nb = self.num_blocks
            keep = old_nb + 1 if nb > old_nb else nb
            bt = new["block_tables"]
            bt.fill_(nb)
            tables = old["block_tables"][:n]
            bt[:n].copy_(torch.where(tables >= min(old_nb, nb),
                                     torch.full_like(tables, nb), tables))
            for d, s in zip(model.slot_leaves(new), model.slot_leaves(old)):
                d[:n].copy_(s[:n])
            for d, s in zip(model.arena_leaves(new),
                            model.arena_leaves(old)):
                d[:keep].copy_(s[:keep])
            for s in self.slots:
                if s is not None and s.prefill_table is not None:
                    s.prefill_table = np.where(
                        s.prefill_table >= min(old_nb, nb), nb,
                        s.prefill_table).astype(np.int32)
        if graph is not None:
            pos = np.zeros(B, np.int64)
            pos[:n] = old_graph.pos[:n]
            graph.pos = pos
        if old_graph is not None and old_graph is not graph:
            old_graph.release(self)
        self.graph, self.cache = graph, new

    # --------------------------------------------------------------- snapshot
    SNAPSHOT_VERSION = 1

    def snapshot(self) -> dict:
        """The whole serving state on the host: queue, slots (partial
        tokens, each generator's state), allocator ledger, the pool's
        leaves (numpy, bf16 ones as CPU tensors) and counters, numpy and
        plain Python otherwise; ``serving.faults.save_snapshot`` persists
        it, and :meth:`from_snapshot` resumes mid-stream with surviving
        streams bit-identical to an uninterrupted run.  The reference's
        layout, with the port's fields: ``seed`` where it has
        ``base_key``, generator states (uint8) where it has PRNG keys, and
        the frame count ``enc_T`` of an encoder-decoder's pool (None
        before its first admission)."""
        def enc_req(req: Request) -> dict:
            return {"uid": req.uid,
                    "inputs": {k: _host(v) for k, v in req.inputs.items()},
                    "max_new_tokens": req.max_new_tokens,
                    "key": _gen_state(req.key),
                    "temperature": req.temperature, "top_k": req.top_k,
                    "priority": req.priority, "deadline_s": req.deadline_s}

        def enc_resume(r: _Resume | None):
            return None if r is None else {
                "tokens": list(r.tokens), "logprobs": list(r.logprobs),
                "key": _gen_state(r.key), "last_tok": r.last_tok,
                "first_token_time": r.first_token_time}

        snap = {
            "version": self.SNAPSHOT_VERSION,
            "now": self._now(),
            "config": {
                "num_slots": self.num_slots, "cache_len": self.cache_len,
                "eos_id": self.eos_id, "paged": self.paged,
                "block_size": self.block if self.paged else None,
                "num_blocks": self.num_blocks if self.paged else None,
                "prefix_cache": (self.prefix_cache if self.paged else True),
                "bucket_prompts": self.bucket_prompts,
                "preempt": self.preempt,
                "chunk_prefill": self.chunk_prefill,
                "chunk_size": self.chunk_size,
                "prefill_budget": self.prefill_budget},
            "seed": self.seed,
            "enc_T": self.enc_T,
            "queue": [{"req": enc_req(q.req), "prompt_len": q.prompt_len,
                       "submit_time": q.submit_time, "deadline": q.deadline,
                       "resume": enc_resume(q.resume)} for q in self.queue],
            "slots": [None if s is None else
                      {"req": enc_req(s.req), "prompt_len": s.prompt_len,
                       "submit_time": s.submit_time, "deadline": s.deadline,
                       "temperature": s.temperature, "top_k": s.top_k,
                       "priority": s.priority, "tokens": list(s.tokens),
                       "logprobs": list(s.logprobs), "last_tok": s.last_tok,
                       "key": _gen_state(s.key),
                       "first_token_time": s.first_token_time,
                       "prefill_pos": s.prefill_pos} for s in self.slots],
            "finished": [{"uid": f.uid, "tokens": np.asarray(f.tokens),
                          "logprobs": np.asarray(f.logprobs),
                          "finish_reason": f.finish_reason,
                          "prompt_len": f.prompt_len,
                          "submit_time": f.submit_time,
                          "finish_time": f.finish_time,
                          "first_token_time": f.first_token_time}
                         for f in self.finished],
            "target_slots": self._target_slots,
            "counters": {"steps_run": self.steps_run,
                         "tokens_out": self.tokens_out,
                         "preemptions": self.preemptions,
                         "cancelled": self.cancelled,
                         "expired": self.expired,
                         "prefill_chunks": self.prefill_chunks,
                         "recomputed_tokens": self.recomputed_tokens},
            "cache": (None if self.cache is None
                      else map_tree(_host, self.cache)),
        }
        if self.paged:
            snap["slot_blocks"] = [None if b is None else list(b)
                                   for b in self._slot_blocks]
            snap["allocator"] = self.allocator.state()
            snap["counters"].update(
                block_hwm=self.block_hwm,
                prefix_hit_tokens=self.prefix_hit_tokens,
                prefix_prompt_tokens=self.prefix_prompt_tokens,
                prefill_tokens_skipped=self.prefill_tokens_skipped)
        return snap

    @classmethod
    def from_snapshot(cls, model: Model, params, snap: dict, *,
                      clock=None, rebase_clock: bool = False,
                      graph: bool = True) -> "Scheduler":
        """Rebuild a scheduler mid-stream from :meth:`snapshot`.  Pass
        ``rebase_clock=True`` when restoring in a new process (another
        clock): pending submit times and deadlines shift so in-flight TTLs
        keep their remaining budget.  On a card (unless ``graph=False``)
        the pool is the static cache of the slot-pool graph of the
        snapshot's geometry, bound here (no capture when the model has it
        for these parameters), which gets the snapshot's pool and, on the
        host, its positions; generators are restored on the model's
        device."""
        if int(snap.get("version", -1)) != cls.SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {snap.get('version')!r} != "
                f"{cls.SNAPSHOT_VERSION}")
        cfg = snap["config"]
        sched = cls(
            model, params, num_slots=int(cfg["num_slots"]),
            cache_len=int(cfg["cache_len"]),
            eos_id=None if cfg["eos_id"] is None else int(cfg["eos_id"]),
            seed=int(snap["seed"]), paged=bool(cfg["paged"]),
            block_size=int(cfg["block_size"] or 64),
            num_blocks=(None if cfg["num_blocks"] is None
                        else int(cfg["num_blocks"])),
            prefix_cache=bool(cfg["prefix_cache"]),
            bucket_prompts=bool(cfg["bucket_prompts"]),
            preempt=bool(cfg["preempt"]), clock=clock, graph=graph,
            chunk_prefill=bool(cfg["chunk_prefill"]),
            chunk_size=int(cfg["chunk_size"]),
            prefill_budget=int(cfg["prefill_budget"]))
        shift = (sched._now() - float(snap["now"])) if rebase_clock else 0.0
        dev = model.device

        def t_of(v):
            return None if v is None else float(v) + shift

        def dec_key(state):
            if state is None:
                return None
            g = torch.Generator(device=dev)
            g.set_state(torch.as_tensor(np.asarray(state, np.uint8)))
            return g

        def dec_req(d: dict) -> Request:
            return Request(
                uid=int(d["uid"]),
                inputs={k: torch.as_tensor(v).to(dev)
                        for k, v in d["inputs"].items()},
                max_new_tokens=int(d["max_new_tokens"]),
                key=dec_key(d["key"]), temperature=float(d["temperature"]),
                top_k=int(d["top_k"]), priority=int(d["priority"]),
                deadline_s=(None if d["deadline_s"] is None
                            else float(d["deadline_s"])))

        def dec_resume(d):
            return None if d is None else _Resume(
                tokens=[int(t) for t in d["tokens"]],
                logprobs=[float(x) for x in d["logprobs"]],
                key=dec_key(d["key"]), last_tok=int(d["last_tok"]),
                first_token_time=t_of(d["first_token_time"]))

        sched.queue = deque(
            _Queued(req=dec_req(d["req"]), prompt_len=int(d["prompt_len"]),
                    submit_time=float(d["submit_time"]) + shift,
                    deadline=t_of(d["deadline"]),
                    resume=dec_resume(d["resume"]))
            for d in snap["queue"])
        slots: list[_Slot | None] = []
        for d in snap["slots"]:
            if d is None:
                slots.append(None)
                continue
            req = dec_req(d["req"])
            slots.append(_Slot(
                uid=req.uid, req=req, max_new=req.max_new_tokens,
                key=dec_key(d["key"]), prompt_len=int(d["prompt_len"]),
                submit_time=float(d["submit_time"]) + shift,
                temperature=float(d["temperature"]), top_k=int(d["top_k"]),
                priority=int(d["priority"]), deadline=t_of(d["deadline"]),
                tokens=[int(t) for t in d["tokens"]],
                logprobs=[float(x) for x in d["logprobs"]],
                last_tok=int(d["last_tok"]),
                first_token_time=t_of(d["first_token_time"]),
                prefill_pos=(None if d["prefill_pos"] is None
                             else int(d["prefill_pos"]))))
        sched.slots = slots
        # a slot mid-prefill rebuilds its prompt on the host: the request's
        # prompt and the tokens it generated before a preemption
        for s in sched.slots:
            if s is not None and s.prefill_pos is not None:
                s.prefill_toks = sched._resume_tokens(s.req, s.tokens)
        sched.finished = [FinishedRequest(
            uid=int(f["uid"]), tokens=np.asarray(f["tokens"], np.int64),
            logprobs=np.asarray(f["logprobs"], np.float32),
            finish_reason=str(f["finish_reason"]),
            prompt_len=int(f["prompt_len"]),
            submit_time=float(f["submit_time"]),
            finish_time=float(f["finish_time"]),
            first_token_time=(None if f["first_token_time"] is None
                              else float(f["first_token_time"])))
            for f in snap["finished"]]
        c = snap["counters"]
        sched.steps_run = int(c["steps_run"])
        sched.tokens_out = int(c["tokens_out"])
        sched.preemptions = int(c["preemptions"])
        sched.cancelled = int(c["cancelled"])
        sched.expired = int(c["expired"])
        sched.prefill_chunks = int(c["prefill_chunks"])
        sched.recomputed_tokens = int(c["recomputed_tokens"])
        sched._target_slots = (None if snap["target_slots"] is None
                               else int(snap["target_slots"]))
        if snap["cache"] is not None:
            if sched.cache is None:       # an encoder-decoder's pool
                sched._build_pool(int(snap["enc_T"]))
            _load_pool(sched.cache, snap["cache"])
            if sched.graph is not None:
                sched.graph.pos = np.asarray(snap["cache"]["pos"], np.int64)
        if sched.paged:
            sched.allocator = BlockAllocator.from_state(snap["allocator"])
            sched._slot_blocks = [
                None if b is None else [int(x) for x in b]
                for b in snap["slot_blocks"]]
            sched.block_hwm = int(c["block_hwm"])
            sched.prefix_hit_tokens = int(c["prefix_hit_tokens"])
            sched.prefix_prompt_tokens = int(c["prefix_prompt_tokens"])
            sched.prefill_tokens_skipped = int(c["prefill_tokens_skipped"])
            for i, s in enumerate(sched.slots):
                if s is not None and s.prefill_pos is not None \
                        and sched._slot_blocks[i] is not None:
                    s.prefill_table = sched._table(sched._slot_blocks[i])
        return sched

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
        pref = sorted((self._srank(s), i) for i, s in enumerate(self.slots)
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
            finish_time=self._now(),
            first_token_time=slot.first_token_time)


def _load_pool(dst, src) -> None:
    """Copy a snapshot's pool ``src`` (host arrays and tensors, the pool's
    tree) into the pool ``dst`` in place, leaf by leaf; raises ValueError
    where the trees or the shapes differ."""
    if isinstance(dst, (dict, list)):
        keys = list(dst) if isinstance(dst, dict) else range(len(dst))
        if sorted(keys) != sorted(src if isinstance(dst, dict)
                                  else range(len(src))):
            raise ValueError("the snapshot's pool is not this pool's tree")
        for k in keys:
            _load_pool(dst[k], src[k])
        return
    t = torch.as_tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"a snapshot leaf of shape {tuple(t.shape)} for a "
                         f"pool leaf of {tuple(dst.shape)}")
    dst.copy_(t)


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
