"""Batch generation: ``generate`` over the continuous-batching scheduler,
and ``generate_fixed``, the fixed-batch loop with every row in lockstep at
one cache position.  Greedy or temperature sampling; on the card the
prefill and each decode step are replays of captured CUDA graphs."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import Model
from .scheduler import Scheduler, make_requests


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
