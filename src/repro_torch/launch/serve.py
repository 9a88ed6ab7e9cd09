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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import build, get_config
from repro_torch.configs.base import TTConfig
from repro_torch.kernels import plan as ttplan
from repro_torch.kernels import tt_contract
from repro_torch.models import moe
from repro_torch.serving.engine import generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler


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


def make_scheduler(model, params, args, cache_len: int) -> Scheduler:
    """A scheduler of ``--slots`` slots (default ``--batch``) over
    ``cache_len`` positions, paged with ``--paged``, chunked with
    ``--chunk-prefill``."""
    return Scheduler(model, params, num_slots=args.slots or args.batch,
                     cache_len=cache_len, eos_id=args.eos_id,
                     seed=args.seed + 1, paged=args.paged,
                     block_size=args.block_size, num_blocks=args.num_blocks,
                     chunk_prefill=args.chunk_prefill,
                     chunk_size=args.chunk_size,
                     prefill_budget=args.prefill_budget)


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
    i = 0
    interrupted = False
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
        # drain: everything pending retires as cancelled, partial tokens
        # kept, and the report below still prints
        interrupted = True
        for q in list(sched.queue):
            sched.cancel(q.req.uid)
        for s in list(sched.slots):
            if s is not None:
                sched.cancel(s.uid)
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
           "peak_bytes": peak, "interrupted": interrupted, **st}
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
    """The arrival mode: a warm-up request, then the timed arrivals."""
    sched, warm = arrival_scheduler(model, params, args)
    print(f"warm-up request: {warm:.3f}s (excluded below)")
    return dict(arrivals(sched, args), warmup_s=warm, sched=sched)


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
    return ap.parse_args(argv)


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
    model, params = setup(args)
    if args.prefix_smoke:
        return prefix_smoke(model, params, args)
    if args.arrival_rate:
        return simulate(model, params, args)
    return fixed(model, params, args)


if __name__ == "__main__":
    main()
