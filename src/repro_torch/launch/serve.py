"""Serving CLI for the port: the fixed batch, or Poisson arrivals through
the continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-7b|gemma3-4b|granite-8b|qwen3-32b|mixtral-8x7b|\\
               deepseek-v2-lite-16b|mamba2-2.7b|jamba-v0.1-52b|\\
               seamless-m4t-large-v2|internvl2-2b \\
        --variant full --batch 4 \\
        --prompt-len 64 --steps 32 --tt ffn,attn --tt-rank 16 \\
        --tt-backend auto [--tt-weights int8] [--device cpu] \\
        [--arrival-rate 50 --max-requests 16 --slots 4 --assert-no-replan
         [--paged --block-size 16 [--num-blocks N]]
         [--chunk-prefill [--chunk-size 64] [--prefill-budget 64]]]
        [--prefix-smoke --paged --block-size 16 --prefix-len 48
         [--chunk-prefill ...]]
        [--fault-smoke | --durability-smoke [--snapshot-every 8]]
        [--arrival-rate ... --durable DIR [--restore]
         [--snapshot-every 32]]
        [--serve [--host 127.0.0.1] [--port 8763]
         [--durable DIR [--restore]] | --serve-smoke]
        [--first-token [--compile-cache DIR [--assert-cache-hits]]]

``--tt-backend`` is one of ``kernels.plan.BACKENDS``: ``auto`` (d=2
layers through the fused2 kernel), ``cuda_fused2``, ``cuda_fused`` (the
whole chain in one launch), ``cuda_step`` (one step kernel per core) or
``einsum``.  Builds the model with random weights from ``--seed``, draws
the prompt tokens from a numpy generator seeded with ``--seed``, and runs
``generate_fixed`` twice: a cold run (kernel build, first-call set-up,
the captures of the prefill's and the decode step's CUDA graphs on a card)
and a warm run that is timed and must capture nothing, make no new prefill
entry and resolve no TT plan.  TT launches are those the kernel wrappers
counted plus those the graph replays made (the launches each capture
recorded, times its replays); on a card a warm run's are all replayed.  A
mixture-of-experts model (mixtral-8x7b, deepseek-v2-lite-16b,
jamba-v0.1-52b) also reports the assignments its MoE layers dropped past
their capacity (``models.moe.read_drops``: counted on the device, read
once per run).  mamba2-2.7b has TT only on ``ffn`` (its SSD in/out
projections, 2 launches a layer); ``--tt ffn,attn`` covers the same, it
has no attention.  jamba-v0.1-52b (the attention/SSM hybrid) counts its
SSD in/out projections as ``ffn`` too: with ``--tt ffn,attn`` a pass is
120 ``tt_fused2`` (28 SSD blocks × 2, 4 GQA blocks × 4, 16 GLU MLPs × 3)
and 48 ``tt_fused2_experts`` (16 MoE layers × 3).  Its paged pool mixes
the GQA layers' block arenas with the SSD layers' per-slot state, so
``--prefix-smoke`` refuses it, as it refuses mamba2-2.7b: no prefix is
shared.  seamless-m4t-large-v2 (the encoder-decoder) prefills each
prompt with speech frames of ``--prompt-len`` frames (the reference CLI's
F), drawn as bf16 by the prompts' numpy generator: with ``--tt
ffn,attn`` a pass is 24 encoder layers × 7 ``tt_fused2`` and 24 decoder
layers × 11 (self- and cross-attention, MLP) at a prefill, and 24 × 9 at
a decode step (the cross keys and values are the prefill's); its
scheduler builds its pool at the first admission and serves one frame
count, and refuses ``--chunk-prefill`` and ``--prefix-smoke``.
internvl2-2b (the vision-language model) splits each prompt of
``--prompt-len`` rows as the reference CLI does: S_img = min(1,024,
``--prompt-len`` // 2) image embeddings (bf16, drawn by the prompts' numpy
generator after the tokens; their projection is prepended to the token
embeddings) and ``--prompt-len`` - S_img tokens, so the cache and a
request's reservation count both; with ``--tt ffn,attn`` a pass is 24
layers × 7 ``tt_fused2``; it refuses ``--chunk-prefill`` and
``--prefix-smoke``.

With ``--arrival-rate`` it runs ``simulate`` instead, the reference's
arrival mode: a ``Scheduler`` of ``--slots`` slots over ``--prompt-len`` +
``--steps`` positions serves one warm-up request (uid -1), then
``--max-requests`` requests of ``--prompt-len`` tokens and ``--steps`` new
tokens each, submitted at Poisson arrival times (numpy, ``--seed``) on the
wall clock.  It prints tok/s, per-request latency, time to first token and
inter-token latency (p50/p95), the admissions' share of the wall, the KV
pool's bytes, and the steady state's plan resolutions, decode and prefill
captures and TT launches; ``--assert-no-replan`` fails on a plan
resolution or a capture of either kind there.  The admissions prefill
each prompt right-padded to its length bucket, on a card through the
captured prefill of that bucket.  An interrupt drains the scheduler with
``cancel``.  ``--paged`` serves from the block-paged KV pool (DESIGN.md
§7; ``--block-size`` tokens per block, ``--num-blocks`` blocks, default
enough for every slot's whole length) and also reports the blocks, their
high-water mark and the prefix cache's hits.  ``--chunk-prefill``
(DESIGN.md §15) streams each prompt into the pool ``--chunk-size`` tokens
at a time inside the decode step (``--prefill-budget`` prompt tokens per
step: budget // chunk-size chunk lanes, default one; on a card every
such step is a replay of the captured mixed step) instead of a
monolithic admission prefill, trading TTFT against inter-token latency;
it also reports the chunks run and the mixed and plain steps.

``--prefix-smoke`` (with ``--paged``) is the prefix-reuse check: two
requests whose prompts share a ``--prefix-len``-token prefix, then the
first prompt again after both retired.  The second admission must share
the prefix's blocks and skip their prefill; the third must cover its whole
prompt, copy its last block on write and recompute one token; every
request's greedy tokens and logprobs are held against ``generate_fixed``'s
for that prompt alone, within the repo's tolerance where logits tie
(``check_greedy``), and its smallest top-1/top-2 logit gap is printed.
With
``--chunk-prefill`` each request is stepped until its prefill is done
(its first token), and a hit skips the covered chunks.

``--fault-smoke`` is the reference's fault drill (``serving.faults``):
``--max-requests`` requests of mixed priority (uid 0 with a deadline of 3
steps, the last at priority 9 arriving mid-stream) at Poisson arrival
steps, under ``FaultPlan.random(--seed, resize_to=(slots + 1, None))``:
forced allocation failures, an admission hold, a cancel, a live resize
and a restart; no block may leak, no plan resolve, no request be lost,
and every survivor's tokens must be the uninterrupted run's.
``--durability-smoke`` is its durability drill: a ``kill -9`` at a seeded
step recovered from the journal and the snapshot store (a snapshot
every ``--snapshot-every`` decode steps, 2 by default), the same kill with
the newest generation truncated or bit-flipped first, and the store's
own fallback; it also prints the snapshots' bytes and the host ms of a
snapshot, of its save and of a recovery's stages.  On a card every
scheduler of both, the restored and recovered ones included, replays its
slot-pool graph.  ``--durable DIR`` (arrival mode) journals every submit
and retirement and commits a snapshot every ``--snapshot-every`` decode
steps (32 by default); an interrupt checkpoints the in-flight work, and
``--restore`` recovers it (newest clean snapshot + journal replay) and
drains it.

Streaming (DESIGN.md §15): ``--serve`` starts the stdlib HTTP/SSE server
(``serving.server``) over a ``StreamEngine`` on ``--host``:``--port``:
POST /generate streams per-token events, GET /stream/<uid>?from=N resumes
a dropped stream (journal-aware with ``--durable DIR``, whose ``--restore``
recovers the in-flight work first), GET /stats, and POST /shutdown (or an
interrupt) drains and exits.  ``--serve-smoke`` is its check: an
in-process server, two overlapping streaming requests of ``--steps``
tokens (prompts of ``--prompt-len`` tokens drawn as the arrival mode
draws uid 0's and 1's) whose ordered events interleave, a reconnect that
replays uid 0 from ``--steps`` // 2, /stats and a graceful /shutdown;
``--assert-no-replan`` fails on a plan resolution while serving.  A
model that needs its front end's embeddings (seamless, internvl2) takes
no request from tokens alone and refuses both.

Cold start (DESIGN.md §13): ``--first-token`` serves one request through
the scheduler and prints a ``COLD_START`` JSON line with the seconds from
the process's start (stamped before ``import torch``) to its first token,
and the seconds this process spent in ``nvcc``.  ``--compile-cache DIR``
(or ``$REPRO_COMPILE_CACHE``) builds the kernel library under DIR
(``launch.cache``), so a second process builds nothing;
``--assert-cache-hits`` fails a run that built a library into DIR or
found none there.  Run it twice against one DIR for the cold and the warm
start.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

# stamped before the torch import below, so that --first-token's "process
# start to first token" counts the framework's start-up, the kernel build
# and every capture: the costs a warm build cache and a warm host remove
_PROC_T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import build, get_config  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.kernels import plan as ttplan  # noqa: E402
from repro_torch.kernels import tt_contract  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving.engine import generate_fixed  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402
from .cache import cache_entries, enable_compile_cache  # noqa: E402

# --durability-smoke's snapshot cadence (the reference's), and the arrival
# mode's with --durable, when --snapshot-every is not given
DRILL_SNAPSHOT_EVERY, SNAPSHOT_EVERY = 2, 32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def random_embeds(model, rng: np.random.Generator, B: int, n: int) -> dict:
    """The front end's embeddings of ``B`` prompts, ``n`` rows each, bf16
    standard normal drawn by ``rng`` (the reference CLI's stub inputs),
    under the model's ``front_input`` key: an encoder-decoder's speech
    frames or a vision-language model's images; ``{}`` (nothing drawn) for
    a model without a front end."""
    if model.front_input is None:
        return {}
    embeds = rng.standard_normal((B, n, model.cfg.frontend_dim),
                                 dtype=np.float32)
    return {model.front_input: torch.from_numpy(embeds).to(
        device=model.device, dtype=torch.bfloat16)}


def image_split(model, prompt_len: int) -> int:
    """The image rows of a prompt of ``prompt_len`` rows, the reference
    CLI's split: min(``frontend_tokens``, prompt_len // 2) for a model with
    the vision front end (its tokens are the rest), 0 for every other."""
    if model.cfg.frontend != "vit":
        return 0
    return min(model.cfg.frontend_tokens, prompt_len // 2)


def prompt_inputs(model, rng: np.random.Generator, B: int,
                  prompt_len: int) -> dict:
    """``B`` prompts of ``prompt_len`` rows drawn by ``rng`` on the
    model's device: the tokens, then the front end's embeddings
    (``random_embeds``): an encoder-decoder's speech frames, as many as
    the tokens, or a vision-language model's images, ``image_split``'s
    count, the tokens taking the rest."""
    img = image_split(model, prompt_len)
    n = img if model.cfg.frontend == "vit" else prompt_len
    tokens = rng.integers(0, model.cfg.vocab_size, (B, prompt_len - img),
                          dtype=np.int64)
    return {"tokens": torch.from_numpy(tokens).to(model.device),
            **random_embeds(model, rng, B, n)}


def prompt_batch(model, args) -> dict:
    """``--batch`` prompts of ``--prompt-len`` rows drawn by a numpy
    generator seeded with ``--seed`` (``prompt_inputs``), and the cache
    length they need."""
    rng = np.random.default_rng(args.seed)
    return {**prompt_inputs(model, rng, args.batch, args.prompt_len),
            "cache_len": args.prompt_len + args.steps}


def timed_run(model, params, batch: dict, args, gen=None,
              graph: bool = True):
    """One ``generate_fixed`` run with the serve flags ``args``, timed on
    the host clock to its end on the device: (result, seconds).
    ``graph=False`` decodes eagerly on the card."""
    if gen is not None:
        gen.manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    res = generate_fixed(model, params, batch, steps=args.steps,
                         temperature=args.temperature, generator=gen,
                         graph=graph)
    _sync(model.device)
    return res, time.perf_counter() - t0


def since(before: dict, after: dict) -> dict:
    """The counts that grew from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def tally(model) -> dict:
    """What a run is checked by, so far: TT launches counted by the kernel
    wrappers, TT launches made by replays of the model's captured prefills
    and decode steps, the decode captures, the prefill entries (captures
    on a card), the plan resolutions and the MoE layers' dropped
    assignments (a host read of the device counter; 0 without experts)."""
    return {"counted": tt_contract.launch_counts(),
            "replayed": dict(model.replayed_launches),
            "captures": model.graph_captures,
            "prefills": model.prefill_builds,
            "plans": ttplan.plan_resolutions(),
            "drops": moe.read_drops() if model.has_moe else 0}


def launches_between(a: dict, b: dict) -> dict:
    """TT launches from tally ``a`` to tally ``b``, counted and replayed."""
    out = since(a["counted"], b["counted"])
    for k, v in since(a["replayed"], b["replayed"]).items():
        out[k] = out.get(k, 0) + v
    return out


def fixed(model, params, args) -> dict:
    """Serve the prompts of ``args`` twice: a cold run (kernel build, plan
    and geometry memos, the prefill's and the decode step's captures on a
    card) and a warm run that is timed and must capture nothing, make no
    prefill entry and resolve no TT plan."""
    batch = prompt_batch(model, args)
    gen = None
    if args.temperature:
        gen = torch.Generator(device=model.device)
    cuda = model.device.type == "cuda"

    t0 = tally(model)
    res, cold = timed_run(model, params, batch, args, gen)
    t1 = tally(model)
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    res, warm = timed_run(model, params, batch, args, gen)
    t2 = tally(model)
    replans = t2["plans"] - t1["plans"]
    captures = t2["captures"] - t1["captures"]
    prefills = t2["prefills"] - t1["prefills"]
    launches = launches_between(t1, t2)
    peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
    reserved = torch.cuda.max_memory_reserved(model.device) if cuda else None

    toks = args.batch * args.steps
    print(f"arch={model.cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} decode={args.steps} "
          f"prefill and decode step: {'CUDA graphs' if cuda else 'eager'}")
    print(f"cold run {cold:.3f}s, warm run {warm:.3f}s: {toks} tokens "
          f"({toks / warm:.1f} tok/s incl. prefill)")
    print("sample tokens[0]:", res.tokens[0].tolist())
    drops = t2["drops"] - t1["drops"]
    if model.has_moe:
        print(f"MoE assignments dropped past capacity: {drops} in the warm "
              f"run, {t1['drops'] - t0['drops']} in the cold run")
    print(f"warm run: {replans} plan resolutions (model plans: "
          f"{len(model.plan_book)}), {captures} decode captures and "
          f"{prefills} prefill builds (cold run: "
          f"{t1['captures'] - t0['captures']} and "
          f"{t1['prefills'] - t0['prefills']}); TT launches {launches} "
          f"(counted {since(t1['counted'], t2['counted'])}, by graph "
          f"replays {since(t1['replayed'], t2['replayed'])}); peak device "
          f"memory: " + ("n/a on cpu" if peak is None else
                         f"{peak / 2**30:.3f} GiB allocated, "
                         f"{reserved / 2**30:.3f} GiB reserved"))
    if replans or captures or prefills:
        raise AssertionError(
            f"{replans} TT plan resolutions, {captures} decode captures and "
            f"{prefills} prefill builds during the warm run: serving must "
            f"execute build-time plans and the graphs captured in the cold "
            f"run")
    return {"tokens": res.tokens, "logprobs": res.logprobs,
            "tok_per_s": toks / warm, "warm_s": warm, "cold_s": cold,
            "replans": replans, "captures": captures,
            "prefill_captures": prefills,
            "cold_captures": t1["captures"] - t0["captures"],
            "cold_prefill_captures": t1["prefills"] - t0["prefills"],
            "launches": launches, "cold_launches": launches_between(t0, t1),
            "drops": drops, "cold_drops": t1["drops"] - t0["drops"],
            "counted": since(t1["counted"], t2["counted"]),
            "peak_bytes": peak, "peak_reserved_bytes": reserved}


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def arrival_request(model, args, uid: int, seed: int) -> Request:
    """One request of the arrival mode: a prompt of ``--prompt-len`` rows
    drawn by a numpy generator seeded with ``seed`` (``prompt_inputs``),
    ``--steps`` new tokens."""
    inputs = prompt_inputs(model, np.random.default_rng(seed), 1,
                           args.prompt_len)
    return Request(uid=uid, inputs=inputs,
                   max_new_tokens=args.steps, temperature=args.temperature,
                   top_k=args.top_k)


def scheduler_kwargs(args, cache_len: int) -> dict:
    """The ``Scheduler`` arguments of the serve flags: ``--slots`` slots
    (default ``--batch``) over ``cache_len`` positions, paged with
    ``--paged``, chunked with ``--chunk-prefill``."""
    return dict(num_slots=args.slots or args.batch, cache_len=cache_len,
                eos_id=args.eos_id, seed=args.seed + 1, paged=args.paged,
                block_size=args.block_size, num_blocks=args.num_blocks,
                chunk_prefill=args.chunk_prefill, chunk_size=args.chunk_size,
                prefill_budget=args.prefill_budget)


def make_scheduler(model, params, args, cache_len: int) -> Scheduler:
    """A scheduler of the serve flags (``scheduler_kwargs``)."""
    return Scheduler(model, params, **scheduler_kwargs(args, cache_len))


def print_pool_stats(sched: Scheduler) -> None:
    """The KV pool's bytes and, paged, its blocks, their high-water mark
    and the prefix cache's hits."""
    st = sched.stats()
    line = f"kv pool: {st['kv_pool_bytes'] / 1e6:.2f} MB"
    if sched.paged:
        line += (f" | blocks: {st['num_blocks']}x{st['block_size']} tokens, "
                 f"high-water {st['block_high_water']} | prefix hit rate "
                 f"{st['prefix_hit_rate']:.2f} "
                 f"({st['prefill_tokens_skipped']} prefill tokens skipped)")
    print(line)


def arrival_scheduler(model, params, args) -> tuple[Scheduler, float]:
    """The arrival mode's scheduler after its warm-up request (uid -1),
    which builds the kernels, captures the slot-pool decode step and the
    prefill of the prompts' bucket on a card and fills the launch-geometry
    memos: (scheduler, warm-up seconds)."""
    t0 = time.perf_counter()
    sched = make_scheduler(model, params, args, args.prompt_len + args.steps)
    sched.submit(arrival_request(model, args, -1, args.seed + 999))
    sched.run()
    _sync(model.device)
    sched.reset_stats()
    return sched, time.perf_counter() - t0


def arrivals(sched: Scheduler, args) -> dict:
    """The steady state of the arrival mode: ``--max-requests`` Poisson
    arrivals at ``--arrival-rate`` per second through ``sched``, timed on
    the wall clock, reported, and checked (``--assert-no-replan``) for
    plan resolutions and captures of either kind."""
    model = sched.model
    cuda = model.device.type == "cuda"
    rng = np.random.default_rng(args.seed)
    times = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                      size=args.max_requests))
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    t0 = tally(model)
    start = time.perf_counter()
    # --restore drains the recovered requests only: the synthetic workload
    # would collide with the restored uids
    durable = getattr(sched, "journal", None) is not None
    i = args.max_requests if durable and args.restore else 0
    interrupted = preserved = False
    try:
        while i < args.max_requests or not sched.idle:
            now = time.perf_counter() - start
            while i < args.max_requests and times[i] <= now:
                sched.submit(arrival_request(model, args, i, args.seed + i),
                             submit_time=start + times[i])
                i += 1
            if sched.idle:                # ahead of the arrival process
                time.sleep(max(0.0,
                               times[i] - (time.perf_counter() - start)))
                continue
            sched.step()
    except KeyboardInterrupt:
        interrupted = True
        if durable:
            # a clean stop is a crash's recovery point: checkpoint the live
            # state (a snapshot generation and a journal rotation) and
            # keep the in-flight work for --restore
            gen = sched.checkpoint()
            sched.close()
            preserved = True
            print(f"\ninterrupted: state checkpointed to {args.durable} "
                  f"(generation {gen}, {len(sched.queue)} queued, "
                  f"{sched.num_active} active); resume with --restore")
        else:
            # drain: everything pending retires as cancelled, partial
            # tokens kept, and the report below still prints
            for q in list(sched.queue):
                sched.cancel(q.req.uid)
            for s in list(sched.slots):
                if s is not None:
                    sched.cancel(s.uid)
    if durable and not preserved:
        sched.checkpoint()                # the final snapshot of a drain
        sched.close()
    _sync(model.device)
    wall = time.perf_counter() - start
    t1 = tally(model)
    finished = list(sched.finished)
    st = sched.stats()
    lats = [f.finish_time - f.submit_time for f in finished]
    ttfts = [f.first_token_time - f.submit_time for f in finished
             if f.first_token_time is not None]
    itls = [(f.finish_time - f.first_token_time) / (len(f.tokens) - 1)
            for f in finished
            if f.first_token_time is not None and len(f.tokens) > 1]
    replans = t1["plans"] - t0["plans"]
    captures = t1["captures"] - t0["captures"]
    prefills = t1["prefills"] - t0["prefills"]
    launches = launches_between(t0, t1)
    peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
    out = {"finished": finished, "wall_s": wall,
           "tok_per_s": st["tokens_out"] / wall,
           "p50_s": _percentile(lats, 50), "p95_s": _percentile(lats, 95),
           "ttft_p50_s": _percentile(ttfts, 50),
           "ttft_p95_s": _percentile(ttfts, 95),
           "itl_p50_s": _percentile(itls, 50),
           "itl_p95_s": _percentile(itls, 95),
           "admit_share": st["admit_s"] / wall, "replans": replans,
           "captures": captures, "prefill_captures": prefills,
           "launches": launches, "drops": t1["drops"] - t0["drops"],
           "counted": since(t0["counted"], t1["counted"]),
           "replayed": since(t0["replayed"], t1["replayed"]),
           "peak_bytes": peak, "interrupted": interrupted,
           "preserved": preserved, **st}
    chunked = (f" chunk={sched.chunk_size}x{sched.chunk_lanes}"
               if sched.chunk_prefill else "")
    print(f"arch={model.cfg.name} device={model.device} "
          f"slots={sched.num_slots} arrival_rate={args.arrival_rate}/s "
          f"requests={len(finished)} prompt={args.prompt_len} "
          f"max_new={args.steps} pool={'paged' if sched.paged else 'dense'}"
          f"{chunked} prefill and decode step: "
          f"{'CUDA graphs' if sched.graph is not None else 'eager'}"
          f"{' (PARTIAL: interrupted)' if interrupted else ''}")
    print(f"steady state: {st['tokens_out']} tokens in {wall:.3f}s "
          f"({out['tok_per_s']:.1f} tok/s), decode steps {st['steps_run']}, "
          f"admissions {st['admissions']} ({st['admit_s']:.3f}s, "
          f"{out['admit_share']:.1%} of the wall)")
    print(f"per-request latency: p50={out['p50_s'] * 1e3:.1f}ms "
          f"p95={out['p95_s'] * 1e3:.1f}ms")
    print(f"ttft: p50={out['ttft_p50_s'] * 1e3:.1f}ms "
          f"p95={out['ttft_p95_s'] * 1e3:.1f}ms | inter-token: "
          f"p50={out['itl_p50_s'] * 1e3:.1f}ms "
          f"p95={out['itl_p95_s'] * 1e3:.1f}ms")
    if sched.chunk_prefill:
        print(f"prefill chunks executed: {st['prefill_chunks']} (budget "
              f"{st['prefill_budget']} tok/step); mixed steps "
              f"{st['mixed_steps']}, plain decode steps {st['plain_steps']}")
    print_pool_stats(sched)
    if model.has_moe:
        print(f"MoE assignments dropped past capacity: {out['drops']}")
    print("peak device memory: " + ("n/a on cpu" if peak is None else
                                    f"{peak / 2**30:.3f} GiB allocated"))
    print(f"steady state: {replans} plan resolutions (model plans: "
          f"{len(model.plan_book)}), {captures} decode captures and "
          f"{prefills} prefill builds; TT launches {launches} (counted "
          f"{out['counted']}, by graph replays {out['replayed']})")
    if args.assert_no_replan and (replans or captures or prefills):
        raise AssertionError(
            f"{replans} TT plan resolutions, {captures} decode captures and "
            f"{prefills} prefill builds during the steady state: serving "
            f"must execute build-time plans and the graphs captured at the "
            f"warm-up")
    return out


def simulate(model, params, args) -> dict:
    """The arrival mode: a warm-up request, then the timed arrivals; with
    ``--durable DIR`` through a ``DurableScheduler`` (``--restore``: the
    one recovered from DIR, which drains what it holds; on a card it binds
    the slot-pool graph the warm-up captured)."""
    sched, warm = arrival_scheduler(model, params, args)
    print(f"warm-up request: {warm:.3f}s (excluded below)")
    if args.durable:
        sched = make_durable(sched, model, params, args)
    return dict(arrivals(sched, args), warmup_s=warm, sched=sched)


def make_durable(sched: Scheduler, model, params, args):
    """``sched`` behind the journal of ``--durable DIR`` (a snapshot every
    ``--snapshot-every`` decode steps, ``SNAPSHOT_EVERY`` by default), or
    with ``--restore`` the scheduler recovered from DIR (``sched`` closed
    first, so the recovery binds its slot-pool graph)."""
    from repro_torch.serving.durable import DurableScheduler
    every = args.snapshot_every or SNAPSHOT_EVERY
    if args.restore:
        sched.close()
        return DurableScheduler.recover(
            args.durable, model, params, rebase_clock=True,
            snapshot_every=every, log=print)
    return DurableScheduler(sched, args.durable, snapshot_every=every)


def _how(model, graph: bool) -> str:
    return "graphs" if graph and model.device.type == "cuda" else "eager"


def lifecycle_requests(model, args, priorities: bool) -> tuple[list, list]:
    """The fault drills' ``--max-requests`` requests (uid i: a prompt
    drawn by ``prompt_inputs`` from ``--seed`` + i, ``--steps`` new
    tokens) and their arrival steps, the reference CLI's: with
    ``priorities``, priorities ``integers(0, 3)`` and arrivals at the
    cumulative Poisson(1) draws of a numpy generator seeded with
    ``--seed``, uid 0 with a deadline of 3 steps and the last at priority 9
    (so it preempts); otherwise all at step 0, priority 0."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.max_requests):
        inputs = prompt_inputs(model, np.random.default_rng(args.seed + uid),
                               1, args.prompt_len)
        reqs.append(Request(
            uid=uid, inputs=inputs, max_new_tokens=args.steps,
            temperature=args.temperature, top_k=args.top_k,
            priority=int(rng.integers(0, 3)) if priorities else 0,
            deadline_s=3.0 if priorities and uid == 0 else None))
    if not priorities:
        return reqs, [0] * len(reqs)
    arrive = np.cumsum(rng.poisson(1.0, size=len(reqs))).tolist()
    reqs[-1] = dataclasses.replace(reqs[-1], priority=9, deadline_s=None)
    return reqs, arrive


def fault_smoke(model, params, args, graph: bool = True, check=None,
                baseline: dict | None = None) -> dict:
    """The fault drill (``--fault-smoke``): the requests of
    ``lifecycle_requests`` under ``FaultPlan.random(--seed, horizon=max(4,
    --steps), resize_to=(slots + 1, None))`` (the preemptor never
    cancelled), through ``serving.faults.run_with_faults``: no leaked
    block, no plan resolution, no lost request, every survivor's tokens
    the uninterrupted run's (or, with ``check(uid, got, want)``, as it
    decides; ``baseline``: the uninterrupted run's results, else it runs
    here).  ``graph=False`` runs every scheduler eagerly on a card."""
    from repro_torch.serving.faults import FaultPlan, run_with_faults

    reqs, arrive = lifecycle_requests(model, args, priorities=True)
    slots = args.slots or args.batch
    kw = dict(scheduler_kwargs(args, args.prompt_len + args.steps),
              graph=graph)
    plan = FaultPlan.random(args.seed, horizon=max(4, args.steps),
                            uids=[r.uid for r in reqs[:-1]],
                            resize_to=(slots + 1, None))
    print(f"arch={model.cfg.name} device={model.device} slots={slots} "
          f"requests={len(reqs)} pool={'paged' if args.paged else 'dense'}"
          f"{' chunked' if args.chunk_prefill else ''} "
          f"{_how(model, graph)}")
    print(f"fault plan: alloc_fail@{sorted(plan.alloc_fail_steps)} "
          f"hold@{sorted(plan.hold_steps)} cancels={list(plan.cancels)} "
          f"resizes={list(plan.resizes)} "
          f"restart@{sorted(plan.restart_steps)} arrivals@{arrive}")
    rep = run_with_faults(model, params, reqs, plan, sched_kwargs=kw,
                          arrival_steps=arrive, check=check,
                          baseline=baseline)
    print(f"drained in {rep.steps} steps: restarts={rep.restarts} "
          f"preemptions={rep.preemptions} cancelled={rep.cancelled} "
          f"expired={rep.expired} replans={rep.replans}; resize ms "
          f"{[round(t * 1e3, 3) for t in rep.resize_s]}; prompt tokens "
          f"prefilled again by resumes {rep.recomputed_tokens}; captures by "
          f"the restart {rep.rebuild_captures}")
    print(f"fault-injection smoke OK ({len(rep.survivors)} survivors "
          f"{'held by the check' if check else 'token-identical'} against "
          f"the uninterrupted run)")
    return {"report": rep, "plan": plan, "requests": reqs,
            "arrivals": arrive, "steps": rep.steps,
            "restarts": rep.restarts, "preemptions": rep.preemptions,
            "cancelled": rep.cancelled, "expired": rep.expired,
            "survivors": len(rep.survivors)}


def durability_smoke(model, params, args, graph: bool = True,
                     check=None) -> dict:
    """The durability drill (``--durability-smoke``), the reference's three
    drills: (1) a ``kill -9`` at a seeded step, journal and a snapshot
    every ``--snapshot-every`` decode steps on a clean store, every
    survivor the uninterrupted run's after the recovery, no leaked block,
    no plan resolution; (2) the same kill with the newest committed
    generation truncated or bit-flipped before the recovery, which must
    fall back past it and replay forward; (3) the store alone: a truncated
    newest generation falls back, a fully corrupt store raises.  Prints the
    snapshots' bytes and the host ms of ``snapshot()``, of
    ``save_snapshot`` (fsync included) and of each recovery's stages."""
    import os
    import tempfile

    from repro_torch.core import durable
    from repro_torch.serving.faults import (FaultPlan, load_snapshot,
                                            run_with_faults, save_snapshot)

    reqs, _ = lifecycle_requests(model, args, priorities=False)
    slots = args.slots or args.batch
    kw = dict(scheduler_kwargs(args, args.prompt_len + args.steps),
              graph=graph)
    every = args.snapshot_every or DRILL_SNAPSHOT_EVERY
    plan = FaultPlan.random(args.seed, horizon=max(4, args.steps),
                            n_alloc_fail=0, n_hold=0, n_cancel=0,
                            with_restart=False, with_kill=True)
    print(f"arch={model.cfg.name} device={model.device} slots={slots} "
          f"requests={len(reqs)} pool={'paged' if args.paged else 'dense'} "
          f"{_how(model, graph)} kill@{sorted(plan.kill_steps)} "
          f"snapshot every {every} steps")

    def costs(rep) -> str:
        cp = rep.checkpoints
        rc = rep.recoveries[0]
        return (f"{len(cp)} snapshots of {cp[-1]['bytes']} bytes (largest "
                f"{max(c['bytes'] for c in cp)}); snapshot() ms max "
                f"{max(c['snapshot_s'] for c in cp) * 1e3:.3f}, "
                f"save_snapshot ms max "
                f"{max(c['save_s'] for c in cp) * 1e3:.3f}; recovery of "
                f"generation {rc['generation']} ({rc['records']} journal "
                f"records): load_snapshot {rc['load_s'] * 1e3:.3f} ms, "
                f"from_snapshot {rc['from_snapshot_s'] * 1e3:.3f}, replay "
                f"{rc['replay_s'] * 1e3:.3f}, checkpoint "
                f"{rc['checkpoint_s'] * 1e3:.3f}; captures by the recovery "
                f"{rep.rebuild_captures}")

    with tempfile.TemporaryDirectory() as d:
        rep = run_with_faults(model, params, reqs, plan, sched_kwargs=kw,
                              durable_dir=d, snapshot_every=every,
                              check=check)
    assert rep.kills == 1, rep
    print(f"kill drill OK: drained in {rep.steps} steps, "
          f"{len(rep.survivors)} survivors "
          f"{'held by the check' if check else 'token-identical'} after "
          f"recovery; {costs(rep)}")

    rng = np.random.default_rng(args.seed + 7)
    corruptions: list[str] = []

    def corruptor(root, step):
        gens = durable.committed_generations(root)
        if len(gens) < 2:
            return                        # keep one good generation
        p = os.path.join(root, f"gen_{gens[-1]:08d}", "arrays.bin")
        size = os.path.getsize(p)
        if rng.integers(0, 2) == 0:
            with open(p, "r+b") as f:
                f.truncate(int(rng.integers(0, size)))
            corruptions.append(f"truncate gen {gens[-1]}")
        else:
            off = int(rng.integers(0, size))
            with open(p, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))
            corruptions.append(f"bit-flip gen {gens[-1]}")

    with tempfile.TemporaryDirectory() as d:
        rep2 = run_with_faults(model, params, reqs, plan, sched_kwargs=kw,
                               baseline=rep.baseline, durable_dir=d,
                               snapshot_every=every, corruptor=corruptor,
                               check=check)
    assert rep2.kills == 1, rep2
    print(f"corrupting-kill drill OK ({corruptions or 'nothing to corrupt'})"
          f": recovery fell back past the damage, survivors "
          f"{'held' if check else 'identical'}; {costs(rep2)}")

    with tempfile.TemporaryDirectory() as d:
        save_snapshot(d, {"version": 0, "gen": np.asarray([1], np.int32)})
        save_snapshot(d, {"version": 0, "gen": np.asarray([2], np.int32)})
        with open(os.path.join(d, "gen_00000002", "arrays.bin"),
                  "r+b") as f:
            f.truncate(2)
        assert int(load_snapshot(d)["gen"][0]) == 1   # fell back
        with open(os.path.join(d, "gen_00000001", "arrays.bin"),
                  "r+b") as f:
            f.seek(0)
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 1]))
        try:
            load_snapshot(d)
            raise AssertionError("fully-corrupt store must raise")
        except durable.CorruptGenerationError:
            pass
    print("store drill OK: truncation falls back, full corruption raises "
          "— a torn state is never returned")
    print("durability smoke OK")
    return {"reports": (rep, rep2), "requests": reqs,
            "kills": rep.kills + rep2.kills, "corruptions": corruptions,
            "survivors": len(rep.survivors)}


# --prefix-smoke: each prompt's own tokens after the shared prefix
PREFIX_TAIL = 16


def forced_logits(model, params, tokens: torch.Tensor,
                  forced: np.ndarray, T: int,
                  embeds: torch.Tensor | None = None) -> torch.Tensor:
    """``generate_fixed``'s logits [n, V] (fp32) for the one prompt ``tokens
    [1, S]`` (with the front end's ``embeds [1, n, frontend_dim]``: an
    encoder-decoder's frames, a vision-language model's images before the
    tokens) over a cache of ``T``, fed the ``n`` tokens ``forced`` (picked
    by another path) in place of its own greedy picks: the prefill's, then
    each decode step's, through the same entries (the prefill at the
    prompt's length and, on a card, the fixed-batch decode graph of one
    row)."""
    rows = 0 if embeds is None else int(embeds.shape[1])
    S = int(tokens.shape[1]) + (rows if model.cfg.frontend == "vit" else 0)
    logits, cache = model.padded_prefill(params, tokens, S, T, True, embeds)
    out = [logits[0, -1].clone()]
    step = None
    if model.device.type == "cuda":
        step = model.graphed_decode_step(
            1, T, enc_T=rows if model.cfg.enc_dec else 0)
        step.load(params, cache, S)
    for tok in forced[:-1]:
        tok = torch.tensor([[int(tok)]], device=model.device)
        if step is not None:
            logits = step(tok)
        else:
            logits, cache = model.decode_step(params, cache, tok)
        out.append(logits[0, -1].clone())
    return torch.stack(out)


def greedy_against_fixed(model, params, prompt: torch.Tensor, got,
                         T: int, embeds: torch.Tensor | None = None) -> dict:
    """A served request's greedy tokens and logprobs (``got``, a
    ``FinishedRequest``) against ``generate_fixed`` of its prompt alone
    (with the front end's ``embeds``: speech frames, or images):
    the tokens' identity, the smallest top-1/top-2 logit gap, along the
    served tokens (fed to ``generate_fixed``'s arithmetic,
    ``forced_logits``) the largest slack of a pick below that step's top
    logit and the largest logprob difference, ``check_greedy``'s
    tolerance, and whether the request holds to it (``within``): the
    tokens are ``generate_fixed``'s wherever its gap exceeds the
    tolerance, every pick and every logprob within it.  The tolerance is
    the repo's: 1e-4 with fp32 parameters, 2e-2 × the largest |logit| with
    bf16 ones (whose logits are bf16 values and tie exactly, so another
    batch shape may pick the other of two tied tokens)."""
    toks = np.asarray(got.tokens)
    batch = {"tokens": prompt, "cache_len": T}
    if embeds is not None:
        batch[model.front_input] = embeds
    ref = generate_fixed(model, params, batch,
                         len(toks)).tokens.cpu().numpy()[0]
    lg = forced_logits(model, params, prompt, toks, T, embeds).float()
    tol = (1e-4 if model.param_dtype == torch.float32
           else 2e-2 * float(lg.abs().max()))
    pick = torch.from_numpy(toks).to(lg.device)[:, None]
    top2 = lg.topk(2, -1).values
    slack = float((top2[:, 0] - lg.gather(-1, pick)[:, 0]).max())
    lp = torch.log_softmax(lg, -1).gather(-1, pick)[:, 0].cpu().numpy()
    out = dict(identical=bool(np.array_equal(toks, ref)),
               gap=float((top2[:, 0] - top2[:, 1]).min()), slack=slack,
               logprob_diff=float(np.abs(lp - got.logprobs).max()), tol=tol,
               tokens=toks.tolist(), fixed_tokens=ref.tolist())
    out["within"] = not (slack > tol or out["logprob_diff"] > tol or (
        out["gap"] > tol and not out["identical"]))
    return out


def check_greedy(model, params, prompt: torch.Tensor, got, T: int,
                 embeds: torch.Tensor | None = None) -> dict:
    """``greedy_against_fixed``, raising unless the request holds to the
    tolerance; returns its record."""
    out = greedy_against_fixed(model, params, prompt, got, T, embeds)
    if not out["within"]:
        raise AssertionError(f"request {got.uid}: tokens {out['tokens']} "
                             f"against generate_fixed's "
                             f"{out['fixed_tokens']}: {out}")
    return out


def prefix_prompts(vocab: int, prefix_len: int, seed: int
                   ) -> list[torch.Tensor]:
    """The prefix smoke's two prompts [1, prefix_len + PREFIX_TAIL]: one
    prefix and two tails, drawn by a numpy generator seeded with
    ``seed``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (1, prefix_len), dtype=np.int64)
    return [torch.from_numpy(np.concatenate(
        [prefix, rng.integers(0, vocab, (1, PREFIX_TAIL), dtype=np.int64)],
        1)) for _ in range(2)]


def prefix_smoke(model, params, args) -> dict:
    """The prefix-reuse check (``--prefix-smoke --paged``): a paged
    scheduler over ``--prefix-len`` + ``PREFIX_TAIL`` + ``--steps``
    positions serves two requests whose prompts share a
    ``--prefix-len``-token prefix (the first decodes one step before the
    second arrives), then, after both retired, the first prompt again.
    The second admission must share every full block of the prefix and
    skip its prefill; the third must cover its whole prompt, copy its last
    block on write (a block the first request did not hold) and recompute
    one token; every request's greedy tokens and logprobs are held against
    ``generate_fixed``'s for its prompt alone (``check_greedy``); no block
    may leak.  Prompts are drawn by numpy from ``--seed``.  A
    mixture-of-experts model routes another token set on each side (the
    resume runs the suffix alone), so another capacity: a request is held
    only where neither the scheduler's run nor its ``generate_fixed``
    dropped an assignment, and the drops are printed."""
    P, steps = args.prefix_len, args.steps
    S = P + PREFIX_TAIL
    cache_len = S + steps
    prompts = prefix_prompts(model.cfg.vocab_size, P, args.seed)
    prompts.append(prompts[0])
    sched = make_scheduler(model, params, args, cache_len)
    if not sched.paged or not sched.prefix_cache:
        raise SystemExit("--prefix-smoke needs --paged and a model whose "
                         "prefix blocks can be shared")
    blk = sched.block
    if model.has_moe:
        moe.reset_drops()
    admit_ms, blocks, counters, chunks, out = [], [], [], [], {}
    for uid, toks in enumerate(prompts):
        if uid == 2:                      # after both retired
            out.update(sched.run())
        t0 = time.perf_counter()
        chunks0 = sched.prefill_chunks
        sched.submit(Request(uid=uid, inputs={"tokens": toks},
                             max_new_tokens=steps))
        sched.step()                      # the admission and a decode step
        while any(s is not None and s.uid == uid and s.prefill_pos is not
                  None for s in sched.slots):
            sched.step()                  # chunked: to its first token
        _sync(model.device)
        chunks.append(sched.prefill_chunks - chunks0)
        admit_ms.append((time.perf_counter() - t0) * 1e3)
        slot = next(i for i, s in enumerate(sched.slots)
                    if s is not None and s.uid == uid)
        blocks.append(list(sched._slot_blocks[slot]))
        st = sched.stats()
        counters.append((st["prefix_hit_tokens"],
                         st["prefill_tokens_skipped"]))
    out.update(sched.run())
    for f in sched.finished:
        out[f.uid] = f
    sched.allocator.assert_quiescent()
    drops = moe.read_drops() if model.has_moe else 0
    hits = [counters[0]] + [tuple(b - a for a, b in zip(counters[i - 1],
                                                         counters[i]))
                            for i in (1, 2)]
    shared = [sum(a == b for a, b in zip(blocks[0], blocks[i]))
              for i in (1, 2)]
    cow = blocks[2][S // blk - 1] not in blocks[0]
    print(f"arch={model.cfg.name} prefix={P} tail={PREFIX_TAIL} block={blk} "
          f"cache={cache_len} device={model.device}")
    print(f"admission + first step wall ms: {admit_ms[0]:.1f} (full prompt), "
          f"{admit_ms[1]:.1f} (prefix hit; on a card the resume's capture), "
          f"{admit_ms[2]:.1f} (full cover)")
    print(f"second admission: {shared[0]} shared blocks, {hits[1][1]} prefill "
          f"tokens skipped; resubmission: {hits[2][0]} tokens covered, "
          f"{hits[2][1]} skipped, last prompt block copied on write: {cow}")
    if sched.chunk_prefill:
        print(f"prefill chunks of {sched.chunk_size} per admission: {chunks}")
    print_pool_stats(sched)
    full = S % blk == 0                   # the whole prompt in full blocks
    want = {"shared": (P // blk, shared[0]),
            "skipped": (P // blk * blk, hits[1][1]),
            "resubmission (hit, skipped)": (
                (S, S - 1) if full else (S // blk * blk,) * 2, hits[2]),
            "first admission (hit, skipped)": ((0, 0), hits[0]),
            "copied on write": (full, cow)}
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"prefix reuse: (expected, got) {bad}")
    greedy = {}
    for u in range(3):
        if model.has_moe:
            moe.reset_drops()
        try:
            g = check_greedy(model, params, prompts[u].to(model.device),
                             out[u], cache_len)
        except AssertionError as err:
            if not model.has_moe:
                raise
            g = {"failed": str(err)}
        g["drops"] = moe.read_drops() if model.has_moe else 0
        greedy[u] = g
        if "failed" in g:
            print(f"request {u}: not held against generate_fixed, "
                  f"{drops} drops in the scheduler's run and {g['drops']} "
                  f"in generate_fixed's: {g['failed'][:200]}")
            if drops == g["drops"] == 0:
                raise AssertionError(g["failed"])
            continue
        print(f"request {u}: greedy tokens "
              f"{'identical to' if g['identical'] else 'NOT'} generate_fixed's"
              f"{'' if g['identical'] else ' (a tie within the tolerance)'}; "
              f"picks within {g['slack']:.3g} of its top logit, logprobs "
              f"within {g['logprob_diff']:.3g} (tol {g['tol']:.3g}); "
              f"smallest top-1/top-2 gap {g['gap']:.4g}" + (
                  f"; drops {drops} in the scheduler's run, {g['drops']} in "
                  f"generate_fixed's" if model.has_moe else ""))
    return {"sched": sched, "finished": out, "blocks": blocks,
            "drops": drops,
            "shared_blocks": shared[0], "hits": hits, "cow": cow,
            "admit_ms": admit_ms, "greedy": greedy, "chunks": chunks,
            "prompts": prompts, **sched.stats()}


def first_token(model, params, args) -> dict:
    """The cold-start probe (``--first-token``): one request (uid 0, drawn
    as the arrival mode draws it from ``--seed``) through a scheduler of
    the serve flags, printing a ``COLD_START`` JSON line with the seconds
    from the process's start to its first token (``_PROC_T0``: the
    framework's start-up, the model's build, on a card the kernel build
    and the captures of the slot-pool decode step and the prompt's
    prefill), this process's ``nvcc`` seconds and the build cache's
    libraries.  Run twice against one ``--compile-cache`` DIR: the second
    (warm) run builds nothing."""
    sched = make_scheduler(model, params, args, args.prompt_len + args.steps)
    sched.submit(arrival_request(model, args, 0, args.seed))
    while sched.tokens_out < 1:
        sched.step()
    t_first = time.perf_counter() - _PROC_T0
    sched.run()                           # drain the rest of the budget
    sched.close()
    out = {"arch": model.cfg.name, "device": str(model.device),
           "prompt_len": args.prompt_len, "steps": args.steps,
           "start_to_first_token_s": t_first,
           "nvcc_s": tt_contract.BUILD_SECONDS,
           "compile_cache": args.compile_cache,
           "cache_entries": (cache_entries(args.compile_cache)
                             if args.compile_cache else None)}
    print("COLD_START " + json.dumps(out), flush=True)
    return out


def serve_mode(model, params, args, on_ready=None) -> dict:
    """HTTP/SSE serving (``--serve``, DESIGN.md §15): a ``StreamEngine``
    step loop behind the stdlib SSE front end on ``--host``:``--port``
    (0: an ephemeral port), until POST /shutdown or an interrupt, then the
    engine drains.  ``--durable DIR`` journals every submit and
    retirement (``--restore`` recovers after a crash, its in-flight token
    streams replayable through GET /stream/<uid>?from=N: the journal-aware
    reconnect).  ``on_ready(server)`` is called once the server listens.
    Returns the engine's stats."""
    from repro_torch.serving.engine import StreamEngine
    from repro_torch.serving.server import make_server

    cache_len = args.prompt_len + args.steps
    sched = make_scheduler(model, params, args, cache_len)
    if args.durable:
        sched = make_durable(sched, model, params, args)
    eng = StreamEngine(sched)
    srv = make_server(eng, host=args.host, port=args.port, quiet=False)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}: POST /generate, "
          f"GET /stream/<uid>?from=N, GET /stats, POST /shutdown "
          f"(cache_len={cache_len}, device={model.device}, "
          f"chunked={'on' if args.chunk_prefill else 'off'})", flush=True)
    if on_ready is not None:
        on_ready(srv)
    try:
        srv.serve_forever()
        print("shutdown requested: draining")
    except KeyboardInterrupt:
        print("\ninterrupted: draining")
    finally:
        srv.server_close()
        eng.close()
    st = eng.stats()
    print(f"served {st['requests_done']} requests, "
          f"{st['tokens_out']} tokens")
    return st


# --serve-smoke's bound on every wait: a client's connection, a token, the
# server's and the engine's stops (a card's first captures included)
SMOKE_TIMEOUT = 300.0


def sse_events(resp):
    """The ``data:`` events of an SSE response, decoded, as they arrive."""
    buf = b""
    while True:
        chunk = resp.read1(4096)
        if not chunk:
            return
        buf += chunk
        while b"\n\n" in buf:
            raw, buf = buf.split(b"\n\n", 1)
            for line in raw.split(b"\n"):
                if line.startswith(b"data: "):
                    yield json.loads(line[6:])


def serve_smoke(model, params, args) -> dict:
    """The streaming check (``--serve-smoke``): an in-process SSE server
    over a ``StreamEngine`` on a scheduler of the serve flags, two
    *overlapping* streaming requests of ``--steps`` tokens (uid 1 is sent
    once uid 0's first event arrived; prompts drawn as the arrival mode
    draws uids 0 and 1) whose per-token events must arrive in order, end
    ``"length"``, equal the engine's results and interleave in time; a
    reconnect that replays uid 0 from ``--steps`` // 2; /stats; a graceful
    POST /shutdown; and, with ``--assert-no-replan``, no plan resolution
    while serving.  Every wait is bounded (``SMOKE_TIMEOUT``).  Returns
    each stream's tokens and logprobs as streamed, the results, time to
    first token and inter-token p50 per stream, the replay, the captures
    while serving and the engine's stats."""
    import http.client
    import threading

    from repro_torch.serving.engine import StreamEngine
    from repro_torch.serving.server import make_server

    if model.front_input is not None:
        raise SystemExit(f"--serve-smoke sends token prompts; "
                         f"{model.cfg.name} also needs its front end's "
                         f"{model.front_input}")
    steps = args.steps
    sched = make_scheduler(model, params, args, args.prompt_len + steps)
    eng = StreamEngine(sched)
    t0 = tally(model)
    srv = make_server(eng)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    # the tokens ``arrival_request`` draws for uids 0 and 1, on the host
    prompts = [np.random.default_rng(args.seed + i).integers(
        0, model.cfg.vocab_size, (1, args.prompt_len),
        dtype=np.int64)[0].tolist() for i in range(2)]
    outs: list[list] = [[], []]
    sent = [0.0, 0.0]
    first = threading.Event()

    def client(uid):
        c = http.client.HTTPConnection("127.0.0.1", port,
                                       timeout=SMOKE_TIMEOUT)
        sent[uid] = time.perf_counter()
        c.request("POST", "/generate",
                  json.dumps({"tokens": prompts[uid],
                              "max_new_tokens": steps, "uid": uid}),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 200, r.status
        for ev in sse_events(r):
            outs[uid].append((time.perf_counter(), ev))
            first.set()
            if "done" in ev or "error" in ev:
                break
        c.close()

    try:
        threads = [threading.Thread(target=client, args=(u,), daemon=True)
                   for u in range(2)]
        threads[0].start()
        first.wait(SMOKE_TIMEOUT)
        threads[1].start()
        for t in threads:
            t.join(SMOKE_TIMEOUT)
            assert not t.is_alive(), "streaming client timed out"
        for uid, out in enumerate(outs):
            assert out and out[-1][1].get("done") == "length", out[-1:]
            idx = [ev["i"] for _, ev in out[:-1]]
            assert idx == list(range(steps)), \
                f"uid {uid}: events out of order: {idx}"
        # the two streams overlap in wall time (continuous batching, not
        # serial): each starts before the other finishes
        starts = [out[0][0] for out in outs]
        ends = [out[-1][0] for out in outs]
        assert max(starts) < min(ends), "request streams did not overlap"
        print(f"overlapping streams OK: 2 x {steps} ordered per-token "
              f"events")

        # reconnect mid-stream: replay uid 0 from an arbitrary index
        frm = max(1, steps // 2)
        c = http.client.HTTPConnection("127.0.0.1", port,
                                       timeout=SMOKE_TIMEOUT)
        t_replay = time.perf_counter()
        c.request("GET", f"/stream/0?from={frm}")
        replay = []
        for ev in sse_events(c.getresponse()):
            replay.append(ev)
            if "done" in ev or "error" in ev:
                break
        replay_s = time.perf_counter() - t_replay
        c.close()
        want = [ev["token"] for _, ev in outs[0][frm:-1]]
        got = [ev["token"] for ev in replay[:-1]]
        assert got == want and replay[-1].get("done") == "length", \
            (replay, want)
        print(f"reconnect OK: replayed {len(got)} events from index {frm} "
              f"in {replay_s * 1e3:.1f} ms")

        c = http.client.HTTPConnection("127.0.0.1", port,
                                       timeout=SMOKE_TIMEOUT)
        c.request("GET", "/stats")
        st = json.loads(c.getresponse().read())
        c.close()
        c = http.client.HTTPConnection("127.0.0.1", port,
                                       timeout=SMOKE_TIMEOUT)
        c.request("POST", "/shutdown", "{}")
        assert json.loads(c.getresponse().read())["ok"]
        c.close()
        th.join(SMOKE_TIMEOUT)
        assert not th.is_alive(), "server did not shut down"
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close(timeout=SMOKE_TIMEOUT)
    t1 = tally(model)
    finished = {u: eng.result(u, timeout=0) for u in range(2)}
    streamed = {}
    for uid, out in enumerate(outs):
        toks = np.asarray([ev["token"] for _, ev in out[:-1]], np.int64)
        lps = np.asarray([ev["lp"] for _, ev in out[:-1]], np.float32)
        assert np.array_equal(toks, finished[uid].tokens) and \
            np.array_equal(lps, finished[uid].logprobs), \
            f"uid {uid}: the streamed events are not the engine's result"
        streamed[uid] = (toks, lps)
    ttft = [out[0][0] - sent[u] for u, out in enumerate(outs)]
    itl = [float(np.median(np.diff([t for t, _ in out[:-1]])))
           if steps > 1 else float("nan") for out in outs]
    replans = t1["plans"] - t0["plans"]
    captures = t1["captures"] - t0["captures"]
    prefills = t1["prefills"] - t0["prefills"]
    print(f"arch={model.cfg.name} device={model.device} "
          f"pool={'paged' if sched.paged else 'dense'}"
          f"{' chunked' if sched.chunk_prefill else ''} prompt="
          f"{args.prompt_len} steps={steps}: ttft ms "
          f"{[round(x * 1e3, 3) for x in ttft]}, inter-token p50 ms "
          f"{[round(x * 1e3, 3) for x in itl]}; while serving "
          f"{captures} captures of decode or mixed steps, {prefills} "
          f"prefill or resume builds, TT "
          f"launches {launches_between(t0, t1)}")
    print(f"graceful shutdown OK; plan resolutions during serving: "
          f"{replans}")
    if args.assert_no_replan and replans != 0:
        raise AssertionError(
            f"{replans} TT plan resolutions during streaming serving")
    print("streaming smoke OK")
    return {"requests": 2, "steps": steps, "replans": replans,
            "captures": captures, "prefill_captures": prefills,
            "launches": launches_between(t0, t1), "prompts": prompts,
            "streamed": streamed, "finished": finished, "ttft_s": ttft,
            "itl_p50_s": itl, "replay_from": frm, "replay_events": len(got),
            "replay_s": replay_s, "stats": st}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--tt", default=None,
                    help="comma-separated TT families (ffn,attn,lm_head)")
    ap.add_argument("--tt-rank", type=int, default=16)
    ap.add_argument("--tt-backend", default="einsum",
                    choices=list(ttplan.BACKENDS))
    ap.add_argument("--tt-weights", default="fp32", choices=["fp32", "int8"],
                    help="resident TT core dtype; int8 quantizes the "
                         "checkpoint and serves the int8 kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k sampling filter of the "
                         "arrival mode (0 = off)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrival rate (requests/s); serves through "
                         "the continuous-batching scheduler")
    ap.add_argument("--max-requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=None,
                    help="scheduler slots (default: --batch)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the block-paged KV pool (arrival mode "
                         "and --prefix-smoke)")
    ap.add_argument("--block-size", type=int, default=64,
                    help="tokens per KV block (--paged)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV blocks of the paged pool (default: every "
                         "slot's whole length)")
    ap.add_argument("--chunk-prefill", action="store_true",
                    help="prefill prompts in chunks inside the decode step "
                         "(arrival mode and --prefix-smoke)")
    ap.add_argument("--chunk-size", type=int, default=64,
                    help="prompt tokens per prefill chunk (--chunk-prefill)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens per step: budget // chunk-size "
                         "chunk lanes (default: one lane)")
    ap.add_argument("--prefix-smoke", action="store_true",
                    help="prefix-reuse check: two prompts sharing a "
                         "--prefix-len prefix, then the first again "
                         "(needs --paged)")
    ap.add_argument("--prefix-len", type=int, default=128)
    ap.add_argument("--assert-no-replan", action="store_true",
                    help="fail on a TT plan resolution or a capture (decode "
                         "or prefill) in the arrival mode's steady state")
    ap.add_argument("--fault-smoke", action="store_true",
                    help="fault drill: a seeded FaultPlan (allocation "
                         "failures, a hold, a cancel, a live resize, a "
                         "restart) over mixed priorities; no leaked block, "
                         "no replan, survivors token-identical")
    ap.add_argument("--durability-smoke", action="store_true",
                    help="durability drill: seeded kill -9 recovery (clean "
                         "and corrupted store), truncation and bit-flip "
                         "fallback")
    ap.add_argument("--durable", default=None,
                    help="journal + snapshot dir of the arrival mode: "
                         "submits and retirements journaled, a snapshot "
                         "every --snapshot-every steps; an interrupt keeps "
                         "in-flight work for --restore")
    ap.add_argument("--restore", action="store_true",
                    help="recover the scheduler from --durable (newest "
                         "clean snapshot + journal replay) and drain the "
                         "restored requests")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help=f"decode steps between snapshot generations "
                         f"(--durable: default {SNAPSHOT_EVERY}; "
                         f"--durability-smoke: {DRILL_SNAPSHOT_EVERY})")
    ap.add_argument("--serve", action="store_true",
                    help="start the HTTP/SSE streaming server "
                         "(serving/server.py) over a StreamEngine; stop "
                         "with POST /shutdown or an interrupt")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8763,
                    help="--serve port (0 = ephemeral)")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="streaming check: in-process SSE server, two "
                         "overlapping streaming requests with ordered "
                         "per-token events, a mid-stream reconnect replay "
                         "and a graceful shutdown")
    ap.add_argument("--first-token", action="store_true",
                    help="print a COLD_START line with process start -> "
                         "first token; run twice against one "
                         "--compile-cache dir for cold vs. warm")
    ap.add_argument("--compile-cache", default=None,
                    help="kernel build directory kept across processes "
                         "(also via $REPRO_COMPILE_CACHE): a restarted "
                         "process builds nothing")
    ap.add_argument("--assert-cache-hits", action="store_true",
                    help="fail if this run builds a kernel library into "
                         "--compile-cache, or finds none there (the warm "
                         "start must build nothing)")
    args = ap.parse_args(argv)
    if args.restore and not args.durable:
        ap.error("--restore requires --durable DIR")
    return args


def setup(args):
    """(model, params) for the parsed flags: random weights from
    ``--seed``, int8-quantized cores with ``--tt-weights int8``."""
    tt = None
    if args.tt:
        tt = TTConfig(enabled=True, families=tuple(args.tt.split(",")),
                      rank=args.tt_rank, backend=args.tt_backend,
                      weights=args.tt_weights,
                      min_factor=2 if args.variant == "smoke" else 8)
    cfg = get_config(args.arch, args.variant, tt=tt)
    model = build(cfg, param_dtype=torch.bfloat16 if args.variant == "full"
                  else torch.float32, device=args.device)
    params = model.init(args.seed)
    if args.tt and args.tt_weights == "int8":
        params = model.quantize_params(params)
    return model, params


def main(argv=None) -> dict:
    args = parse_args(argv)
    # before the first kernel load, so the library is built (or found)
    # under the cache
    cache_dir = enable_compile_cache(args.compile_cache)
    args.compile_cache = cache_dir        # resolves $REPRO_COMPILE_CACHE
    n_cache0 = cache_entries(cache_dir)
    model, params = setup(args)
    try:
        if args.prefix_smoke:
            out = prefix_smoke(model, params, args)
        elif args.fault_smoke:
            out = fault_smoke(model, params, args)
        elif args.durability_smoke:
            out = durability_smoke(model, params, args)
        elif args.first_token:
            out = first_token(model, params, args)
        elif args.serve_smoke:
            out = serve_smoke(model, params, args)
        elif args.serve:
            out = serve_mode(model, params, args)
        elif args.arrival_rate or args.restore:
            if not args.arrival_rate:
                args.arrival_rate = 1.0   # --restore drains, no arrivals
            out = simulate(model, params, args)
        else:
            out = fixed(model, params, args)
    except KeyboardInterrupt:
        # the arrival mode and --serve drain on their own; this is the
        # safety net of the other modes: exit 0 without a traceback
        print("\ninterrupted: exiting")
        return {"interrupted": True}
    if cache_dir:
        n1 = cache_entries(cache_dir)
        print(f"build cache {cache_dir}: {n_cache0} -> {n1} kernel "
              f"libraries ({n1 - n_cache0} built by this run, nvcc "
              f"{tt_contract.BUILD_SECONDS:.1f} s)")
        if args.assert_cache_hits and (n1 != n_cache0 or n_cache0 == 0):
            raise AssertionError(
                f"warm start built {n1 - n_cache0} kernel libraries (the "
                f"cache had {n_cache0}): the build cache must make a "
                f"restart build nothing")
    return out


if __name__ == "__main__":
    main()
