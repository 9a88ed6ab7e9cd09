"""Continuous batching over a pool of dense slots.

The dense-slot path of the reference's ``serving.scheduler``: one KV pool
(``Model.init_cache(num_slots, cache_len, per_row=True)``), in which every
slot owns ``cache_len`` positions of every layer and a position of its own.

Lifecycle of a request:

  submit() ─→ queue ─→ admission into a free slot, best rank first
  (``priority``, then submit time): a prefill of the prompt alone into a
  cache of the pool's length, right-padded to its length bucket
  (``bucket_prompts``, the default; ``Model.bucketed_prefill``) or at its
  own length, the first token picked from its logits, and a splice of the
  row into the pool ─→ masked decode steps until EOS or the token budget
  ─→ retirement frees the slot.

On a CUDA model every admission prefill is one replay of a captured
prefill (``Model.graphed_prefill(1, bucket or prompt length, cache_len)``,
captured the first time its key is met), and every decode step one replay
of the slot-pool CUDA graph ``Model.graphed_decode_step(num_slots,
cache_len, masked=True)``, whose static cache is the pool; the splice is a
device copy from the prefill graph's output cache into the pool, between
replays.  On the CPU both are eager (``Model.decode_step`` with the
``active`` mask).  ``graph=False`` asks for the eager prefill and step on
the card, to hold the two against each other.

Sampling parameters ride on the ``Request`` (``temperature``, ``top_k``).
A sampled request draws from its own ``torch.Generator`` on the model's
device (``Request.key``, or one seeded from the scheduler's ``seed`` and
the request's uid, the counterpart of ``fold_in(base_key, uid)``); greedy
requests draw nothing.

Not ported (ROADMAP.md Queue 1): paging and the prefix cache, chunked
prefill, preemption, deadlines, resize, snapshots, the mesh and ``drop``.
The constructor refuses their arguments.
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

NEG_INF = -1e30

# the reference's Scheduler arguments this port leaves out, by the
# ROADMAP.md Queue 1 item that brings them
NOT_PORTED = {"paged": 3, "block_size": 3, "num_blocks": 3,
              "prefix_cache": 3, "chunk_prefill": 4,
              "chunk_size": 4, "prefill_budget": 4, "preempt": 6,
              "clock": 6, "mesh": 10}


@dataclasses.dataclass
class Request:
    """One generation request.  ``inputs`` holds ``tokens [1, S]``.
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
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    last_tok: int = 0
    first_token_time: float | None = None


class Scheduler:
    """Continuous-batching loop: ``submit()`` any time, ``step()`` admits
    queued requests into free slots and advances every active slot by one
    token, ``run()`` drains."""

    def __init__(self, model: Model, params, num_slots: int, cache_len: int,
                 *, eos_id: int | None = None, seed: int = 0,
                 bucket_prompts: bool = True, graph: bool = True,
                 **left_out):
        for name in left_out:
            if name not in NOT_PORTED:
                raise TypeError(f"Scheduler got an unexpected keyword "
                                f"argument {name!r}")
        if left_out:
            raise NotImplementedError(
                f"{sorted(left_out)}: not ported; the dense-slot scheduler "
                f"has none of them (ROADMAP.md Queue 1 items "
                f"{sorted({NOT_PORTED[n] for n in left_out})})")
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.model = model
        self.params = params
        # every TT plan is resolved here, so admissions and decode steps
        # resolve none
        model.plan_book
        self.num_slots = num_slots
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
        self.admissions = 0               # admission prefills run
        self.admit_s = 0.0                # host seconds in admissions
        self.cancelled = 0                # requests cancelled via cancel()
        # on a card, the slot-pool decode step; its static cache is the pool
        self.graph: DecodeGraph | None = None
        if graph and model.device.type == "cuda":
            self.graph = model.graphed_decode_step(num_slots, cache_len,
                                                    masked=True)
            self.graph.bind(self, params)
            self.cache = self.graph.cache
        else:
            self.cache = model.init_cache(num_slots, cache_len, per_row=True)

    # ------------------------------------------------------------- interface
    def submit(self, req: Request, submit_time: float | None = None) -> None:
        """Queue a request.  Raises ValueError here when it could never be
        admitted: prompt and budget must fit the cache."""
        S = int(req.inputs["tokens"].shape[1])
        if req.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if S + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request uid={req.uid}: prompt ({S}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds cache_len={self.cache_len}")
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
        its slot.  Returns False for an unknown uid."""
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
                self.slots[i] = None
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
        """Counters for reporting (``launch.serve``)."""
        return {"tokens_out": self.tokens_out, "steps_run": self.steps_run,
                "admissions": self.admissions, "admit_s": self.admit_s,
                "kv_pool_bytes": self.kv_pool_bytes(),
                "cancelled": self.cancelled}

    def kv_pool_bytes(self) -> int:
        return sum(t.nbytes for t in tree_leaves(self.cache))

    def reset_stats(self) -> None:
        """Zero the reporting counters (after a warm-up request, so set-up
        stays out of steady-state numbers)."""
        self.finished.clear()
        self.tokens_out = self.steps_run = self.admissions = 0
        self.cancelled = 0
        self.admit_s = 0.0

    def step(self) -> list[FinishedRequest]:
        """One scheduler tick: admit into free slots best-rank-first, then
        run one masked decode step.  Returns the requests retired during
        this call.  A scheduler whose decode graph another one has bound
        since raises."""
        if self.graph is not None and self.graph.owner() is not self:
            raise RuntimeError("the slot-pool decode graph was bound by "
                               "another scheduler")
        done: list[FinishedRequest] = []
        self._admit_phase(done)
        if self.num_active:
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
                raise RuntimeError(
                    f"scheduler stalled: {len(self.queue)} queued requests, "
                    f"no active slots, and a step made no progress")
        return out

    # ------------------------------------------------------------- admission
    @staticmethod
    def _qrank(q: _Queued) -> tuple:
        """Admission order: smaller sorts first (better).  Higher priority
        wins; ties go to the older request."""
        return (-q.req.priority, q.submit_time)

    def _admit_phase(self, done: list[FinishedRequest]) -> None:
        """Admit queued requests best-rank-first while a slot is free; no
        request jumps over a better one, and none is preempted."""
        while self.queue:
            free = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if free is None:
                break
            qi = min(range(len(self.queue)),
                     key=lambda j: self._qrank(self.queue[j]))
            q = self.queue[qi]
            del self.queue[qi]
            self._try_admit(q, free, done)

    def _try_admit(self, q: _Queued, slot_idx: int,
                   done: list[FinishedRequest]) -> None:
        req = q.req
        if req.max_new_tokens == 0:       # nothing to generate: no prefill
            done.append(FinishedRequest(
                uid=req.uid, tokens=np.zeros((0,), np.int64),
                logprobs=np.zeros((0,), np.float32), finish_reason="length",
                prompt_len=q.prompt_len, submit_time=q.submit_time,
                finish_time=time.perf_counter()))
            return
        self._admit_dense(q, slot_idx, done)

    def _admit_inputs(self, q: _Queued) -> dict:
        """The prefill's inputs: the prompt on the model's device, into a
        cache of the pool's length."""
        return {"tokens": q.req.inputs["tokens"].to(self.model.device),
                "cache_len": self.cache_len}

    def _row_prefill(self, inputs: dict) -> tuple[torch.Tensor, dict]:
        """The prompt alone, right-padded to its bucket or at its own
        length (``bucket_prompts=False``); a replay on the card unless
        ``graph=False``.  The cache it returns may be a prefill graph's
        static one: spliced before the next admission."""
        self.admissions += 1
        if self.bucket_prompts:
            return self.model.bucketed_prefill(
                self.cache_len, self.graphed)(self.params, inputs)
        tokens = inputs["tokens"]
        return self.model.padded_prefill(self.params, tokens,
                                         int(tokens.shape[1]),
                                         self.cache_len, self.graphed)

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
                     top_k=int(req.top_k))

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
    def _decode_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Host-side inputs of the masked decode step: each active slot's
        last token, and the active mask."""
        toks = np.zeros((self.num_slots, 1), np.int64)
        active = np.zeros((self.num_slots,), bool)
        for i, s in enumerate(self.slots):
            if s is not None:
                toks[i, 0] = s.last_tok
                active[i] = True
        return toks, active

    def _finish_decode(self, logits: torch.Tensor,
                       done: list[FinishedRequest]) -> None:
        """Pick, emit and retire for one decode step's logits [B, V]."""
        tok, lp = self._pick(logits, self.slots)
        self.steps_run += 1
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            self._emit(s, tok[i], lp[i])
            if self._finished_reason(s):
                done.append(self._retire(s))
                self.slots[i] = None

    def _decode_once(self, done: list[FinishedRequest]) -> None:
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
    row; the row index becomes the uid.  With ``generator``, each row
    samples from a generator of its own on the same device, seeded by a
    draw from ``generator`` (the counterpart of ``fold_in(key, row)``)."""
    tokens = batch["tokens"]
    out = []
    for b in range(tokens.shape[0]):
        key = None
        if generator is not None:
            key = torch.Generator(device=generator.device)
            key.manual_seed(int(torch.randint(
                0, 2 ** 62, (), generator=generator,
                device=generator.device)))
        out.append(Request(uid=b, inputs={"tokens": tokens[b:b + 1]},
                           max_new_tokens=max_new_tokens, key=key,
                           temperature=temperature, top_k=top_k))
    return out
