"""Batch generation: ``generate`` over the continuous-batching scheduler,
and ``generate_fixed``, the fixed-batch loop with every row in lockstep at
one cache position.  Greedy or temperature sampling; on the card the
prefill and each decode step are replays of captured CUDA graphs.

``StreamEngine`` is the asynchronous serving front end: the scheduler's
step loop runs on one background thread, submissions arrive from any
thread, and every generated token streams out through ``Request.on_token``
into a buffer per request that ``stream()`` replays from any index, the
reconnect contract the SSE server (``serving.server``) is built on."""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.models.model import Model
from .scheduler import FinishedRequest, Request, Scheduler, make_requests


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor       # [B, steps] int64
    logprobs: torch.Tensor     # [B, steps] fp32


@torch.no_grad()
def generate(model: Model, params, batch: dict, steps: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             top_k: int = 0, paged: bool = False, block_size: int = 64,
             num_blocks: int | None = None,
             prefix_cache: bool = True) -> GenerateResult:
    """Decode ``steps`` tokens for every row of ``batch["tokens"] [B,S]``
    (with the front end's embeddings, an encoder-decoder's
    ``batch["speech_embeds"]`` or a vision-language model's
    ``batch["image_embeds"]``, split by row as the tokens are) through the
    scheduler (``B`` slots; the first token comes from each row's prefill
    logits), as the reference's ``engine.generate``.  There
    is no EOS, so the result is rectangular; a ragged one raises.
    ``batch["cache_len"]`` defaults to the prompt's length (a
    vision-language model's S_img image rows and S tokens) + ``steps``.
    ``temperature`` and
    ``top_k`` become every row's sampling parameters; with ``generator``
    each row draws from a generator of its own seeded from it, without it
    from the scheduler's default per-uid streams.  ``paged=True`` serves
    through the block-paged KV pool (``block_size``, ``num_blocks``,
    ``prefix_cache`` as the ``Scheduler`` takes them), token for token
    the dense pool's."""
    B, S = batch["tokens"].shape
    if steps <= 0:
        return GenerateResult(
            torch.zeros((B, 0), dtype=torch.int64, device=model.device),
            torch.zeros((B, 0), dtype=torch.float32, device=model.device))
    S += model.image_rows(batch)
    sched = Scheduler(model, params, num_slots=B,
                      cache_len=batch.get("cache_len", S + steps),
                      paged=paged, block_size=block_size,
                      num_blocks=num_blocks, prefix_cache=prefix_cache)
    for req in make_requests(batch, max_new_tokens=steps,
                             generator=generator, temperature=temperature,
                             top_k=top_k):
        sched.submit(req)
    finished = sched.run()
    short = [b for b in range(B) if len(finished[b].tokens) != steps]
    if short:
        raise RuntimeError(
            f"rows {short} retired early "
            f"({[finished[b].finish_reason for b in short]}): generate() "
            f"returns rectangular batches")
    toks = np.stack([finished[b].tokens for b in range(B)])
    lps = np.stack([finished[b].logprobs for b in range(B)])
    return GenerateResult(torch.from_numpy(toks).to(model.device),
                          torch.from_numpy(lps).to(model.device))


@torch.no_grad()
def generate_fixed(model: Model, params, batch: dict, steps: int,
                   temperature: float = 0.0,
                   generator: torch.Generator | None = None,
                   graph: bool = True) -> GenerateResult:
    """Prefill ``batch["tokens"] [B,S]`` (an encoder-decoder's over
    ``batch["speech_embeds"] [B, F, frontend_dim]``, a vision-language
    model's after the projection of ``batch["image_embeds"] [B, S_img,
    frontend_dim]``: a prompt of S_img + S rows) and decode ``steps``
    tokens per row (the first comes from the prefill logits).
    ``batch["cache_len"]`` defaults to the prompt's rows + ``steps``, as
    the reference's ``generate`` sizes its pool.
    ``temperature == 0``
    is greedy and uses no randomness; otherwise tokens are drawn from
    ``generator``, which must live on the model's device.

    On a CUDA model the prefill is one replay of the model's captured
    prefill for (B, S, ``cache_len``) (``Model.graphed_prefill``, at the
    prompt's own length, as the reference prefills through
    ``jitted_prefill``), and every decode step one replay of its captured
    step for (B, ``cache_len``) (``Model.graphed_decode_step``), as the
    reference decodes through ``jitted_decode_step``; ``graph=False`` asks
    for the eager prefill and step instead, to hold the two against each
    other.  On the CPU both are eager.  Sampling stays outside the
    graphs."""
    B, S = batch["tokens"].shape
    if steps <= 0:
        return GenerateResult(
            torch.zeros((B, 0), dtype=torch.int64, device=model.device),
            torch.zeros((B, 0), dtype=torch.float32, device=model.device))
    if temperature != 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    img = model.image_rows(batch)
    S += img
    T = batch.get("cache_len", S + steps)
    if S + steps - 1 > T:
        raise ValueError(f"a prompt of {S} rows ({img} of them image rows) "
                         f"and {steps} new tokens decode up to position "
                         f"{S + steps - 2}, outside the cache of {T}")
    model.plan_book          # resolve all TT plans before the serving loop
    embeds = model.front_embeds(batch)
    logits, cache = model.padded_prefill(params, batch["tokens"], S, T, graph,
                                         embeds)
    if graph and model.device.type == "cuda":
        step = model.graphed_decode_step(
            B, T, enc_T=int(embeds.shape[1]) if model.cfg.enc_dec else 0)
        step.load(params, cache, S)
        cache = None                 # the graph decodes from its own copy
    else:
        def step(token):
            nonlocal cache
            logits, cache = model.decode_step(params, cache, token)
            return logits

    def pick(logits):
        lg = logits[:, -1, :]
        lp = torch.log_softmax(lg, -1)
        if temperature == 0.0:
            tok = torch.argmax(lg, -1)
        else:
            probs = torch.softmax(lg / temperature, -1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return tok, lp.gather(-1, tok[:, None])[:, 0]

    toks, lps = [], []
    tok, lp = pick(logits)
    toks.append(tok)
    lps.append(lp)
    for _ in range(steps - 1):
        tok, lp = pick(step(tok[:, None]))
        toks.append(tok)
        lps.append(lp)
    return GenerateResult(torch.stack(toks, 1), torch.stack(lps, 1))


class StreamEngine:
    """Asynchronous serving front end over a (Durable)Scheduler.

    The scheduler is single-threaded by design: the engine confines every
    scheduler call to one background loop thread, which runs under
    ``torch.no_grad()`` (grad mode is per thread) and so also owns every
    device call: admissions move a request's inputs to the device, its
    generator is made there, and the graphs met for the first time (a
    prefill bucket, a resume, a mixed step) are captured there.  The
    thread-safe edges touch the host only: ``submit()`` queues a request
    (applied by the loop before its next step), per-token events land in
    per-uid buffers through ``Request.on_token``, and ``stream(uid,
    start)`` replays a buffer from any index, then follows the live tail,
    so a client that reconnects mid-generation resumes exactly where it
    left off.  Built over a recovered ``DurableScheduler``, the buffers are
    seeded from its finished requests, its slots' partial streams and its
    preempted requeues, so reconnect is journal-aware: a token acknowledged
    before a crash is replayable after it.

    Unlike the reference, a failure of the loop thread is not silent: the
    thread keeps the exception, wakes every waiter, and ``stream`` (after
    the tokens it has), ``result``, ``submit`` and ``close`` raise it."""

    def __init__(self, sched, poll_s: float = 0.002,
                 autostart: bool = True):
        self.sched = sched
        self.poll_s = poll_s
        self._cond = threading.Condition()
        self._pending: deque[Request] = deque()
        self._buffers: dict[int, list[tuple[int, float]]] = {}
        self._done: dict[int, str] = {}
        self._results: dict[int, FinishedRequest] = {}
        self._stop = False
        self._drain = True
        self._error: Exception | None = None
        self._thread: threading.Thread | None = None
        inner = getattr(sched, "sched", sched)
        for f in inner.finished:
            self._buffers[f.uid] = list(zip(
                (int(t) for t in np.asarray(f.tokens)),
                (float(x) for x in np.asarray(f.logprobs))))
            self._done[f.uid] = f.finish_reason
            self._results[f.uid] = f
        for s in inner.slots:
            if s is not None:
                self._buffers[s.uid] = list(zip(s.tokens, s.logprobs))
                s.req.on_token = self._on_token
        for q in inner.queue:
            r = q.resume
            self._buffers[q.req.uid] = ([] if r is None else
                                        list(zip(r.tokens, r.logprobs)))
            q.req.on_token = self._on_token
        self._next_uid = 1 + max(self._buffers, default=-1)
        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="stream-engine",
                                            daemon=True)
            self._thread.start()

    def close(self, drain: bool = True, timeout: float | None = None
              ) -> None:
        """Stop the loop thread, after draining in-flight work by default
        (``drain=False``: abandon it, a crash's shape), waiting at most
        ``timeout`` seconds for it (TimeoutError past that), then close
        the scheduler (its slot-pool graph released, a durable one's
        journal closed).  Raises the loop thread's failure, if any."""
        with self._cond:
            self._stop = True
            self._drain = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"the engine's loop did not stop in "
                                   f"{timeout}s")
            self._thread = None
        self.sched.close()
        self._raise_failure()

    def _raise_failure(self) -> None:
        if self._error is not None:
            raise self._error

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                self._serve()
        except Exception as e:            # kept, and raised to every caller
            with self._cond:
                self._error = e
                self._cond.notify_all()

    def _serve(self) -> None:
        while True:
            with self._cond:
                while self._pending:
                    req = self._pending.popleft()
                    try:
                        self.sched.submit(req)
                    except ValueError as e:
                        self._done[req.uid] = f"rejected: {e}"
                        self._cond.notify_all()
                if self._stop and (not self._drain or self.sched.idle):
                    return
                if self.sched.idle:       # woken early by a submit
                    self._cond.wait(self.poll_s)
                    continue
            done = self.sched.step()      # outside the lock: slow
            if done:
                with self._cond:
                    for f in done:
                        self._buffers.setdefault(f.uid, [])
                        self._done[f.uid] = f.finish_reason
                        self._results[f.uid] = f
                    self._cond.notify_all()

    # -------------------------------------------------------------- ingress
    def alloc_uid(self) -> int:
        with self._cond:
            uid = self._next_uid
            self._next_uid += 1
            return uid

    def submit(self, req: Request) -> int:
        """Queue a request for the loop thread; tokens stream into its
        buffer as they are generated.  Its inputs stay where the caller
        put them (a server keeps them on the host); the loop moves them to
        the device at admission.  Returns the uid."""
        with self._cond:
            self._raise_failure()
            if self._stop:
                raise RuntimeError("engine is shutting down")
            req.on_token = self._on_token
            self._buffers.setdefault(req.uid, [])
            self._pending.append(req)
            self._next_uid = max(self._next_uid, req.uid + 1)
            self._cond.notify_all()
        return req.uid

    def _on_token(self, uid: int, idx: int, tok: int, lp: float) -> None:
        # called on the loop thread, mid-step; buffers only ever append
        with self._cond:
            buf = self._buffers.setdefault(uid, [])
            if idx >= len(buf):           # resume replays are already seeded
                buf.append((int(tok), float(lp)))
            self._cond.notify_all()

    # --------------------------------------------------------------- egress
    def stream(self, uid: int, start: int = 0, timeout: float = 60.0):
        """Yield ``{"uid", "i", "token", "lp"}`` events from index
        ``start`` (buffered history first, then live), ending with
        ``{"uid", "done": reason}``.  Unknown uid raises KeyError;
        ``timeout`` bounds the wait for each next token (TimeoutError); a
        failed loop raises its exception after the tokens buffered."""
        i = max(0, int(start))
        with self._cond:
            known = (uid in self._buffers or uid in self._done
                     or any(r.uid == uid for r in self._pending))
        if not known:
            raise KeyError(f"unknown uid {uid}")
        while True:
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: i < len(self._buffers.get(uid, ()))
                    or uid in self._done or self._error is not None,
                    timeout)
                if not ok:
                    raise TimeoutError(f"uid {uid}: no token for "
                                       f"{timeout}s")
                buf = list(self._buffers.get(uid, ()))
                done = self._done.get(uid)
            for j in range(i, len(buf)):
                tok, lp = buf[j]
                yield {"uid": uid, "i": j, "token": tok, "lp": lp}
            i = len(buf)
            if done is not None:
                yield {"uid": uid, "done": done}
                return
            self._raise_failure()

    def result(self, uid: int, timeout: float = 300.0) -> FinishedRequest:
        """Block until ``uid`` finishes; raises on rejection, timeout or a
        failed loop."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: uid in self._done or self._error is not None,
                timeout)
            if not ok:
                raise TimeoutError(f"uid {uid} not finished in {timeout}s")
            if uid not in self._done:
                self._raise_failure()
            if uid not in self._results:
                raise RuntimeError(self._done[uid])
            return self._results[uid]

    def stats(self) -> dict:
        """The scheduler's counters (host values only: safe from any
        thread while the loop steps) and the engine's."""
        out = self.sched.stats()
        with self._cond:
            out["requests_buffered"] = len(self._buffers)
            out["requests_pending"] = len(self._pending)
            out["requests_done"] = len(self._done)
        return out
