"""Fixed-batch serving loop: every row in lockstep at one cache position,
greedy or temperature sampling; on the card each decode step is a replay
of a captured CUDA graph."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor       # [B, steps] int64
    logprobs: torch.Tensor     # [B, steps] fp32


@torch.no_grad()
def generate_fixed(model: Model, params, batch: dict, steps: int,
                   temperature: float = 0.0,
                   generator: torch.Generator | None = None,
                   graph: bool = True) -> GenerateResult:
    """Prefill ``batch["tokens"] [B,S]`` and decode ``steps`` tokens per
    row (the first comes from the prefill logits).  ``temperature == 0``
    is greedy and uses no randomness; otherwise tokens are drawn from
    ``generator``, which must live on the model's device.

    On a CUDA model every decode step is one replay of the model's captured
    step for (B, ``cache_len``) (``Model.graphed_decode_step``), as the
    reference decodes through ``jitted_decode_step``; ``graph=False`` asks
    for the eager step instead, to hold the two against each other.  On the
    CPU the step is eager.  Sampling stays outside the graph."""
    B, S = batch["tokens"].shape
    if steps <= 0:
        return GenerateResult(
            torch.zeros((B, 0), dtype=torch.int64, device=model.device),
            torch.zeros((B, 0), dtype=torch.float32, device=model.device))
    if temperature != 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    T = batch.get("cache_len", S)
    if S + steps - 1 > T:
        raise ValueError(f"a prompt of {S} tokens and {steps} new tokens "
                         f"decode up to position {S + steps - 2}, outside "
                         f"the cache of {T}")
    model.plan_book          # resolve all TT plans before the serving loop
    logits, cache = model.prefill(params, batch)
    if graph and model.device.type == "cuda":
        step = model.graphed_decode_step(B, T)
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
