"""Fixed-batch serving CLI for the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --variant full --batch 4 --prompt-len 64 --steps 32 --tt ffn,attn \\
        --tt-rank 16 --tt-backend auto [--tt-weights int8] [--device cpu]

Builds the model with random weights from ``--seed``, draws the prompt
tokens from a numpy generator seeded with ``--seed``, and runs
``generate_fixed`` twice: a cold run (kernel build, first-call set-up)
and a warm run that is timed and must resolve no TT plan.
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
from repro_torch.serving.engine import generate_fixed


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(model, args) -> dict:
    """``--batch`` prompts of ``--prompt-len`` tokens drawn by a numpy
    generator seeded with ``--seed``, and the cache length they need."""
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, model.cfg.vocab_size,
                          (args.batch, args.prompt_len), dtype=np.int64)
    return {"tokens": torch.from_numpy(tokens).to(model.device),
            "cache_len": args.prompt_len + args.steps}


def fixed(model, params, args) -> dict:
    batch = prompt_batch(model, args)
    gen = None
    if args.temperature:
        gen = torch.Generator(device=model.device)

    def run():
        if gen is not None:
            gen.manual_seed(args.seed + 1)
        t0 = time.perf_counter()
        res = generate_fixed(model, params, batch, steps=args.steps,
                             temperature=args.temperature, generator=gen)
        _sync(model.device)
        return res, time.perf_counter() - t0

    res, cold = run()
    plans0 = ttplan.plan_resolutions()
    launches0 = tt_contract.launch_counts()
    if model.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(model.device)
    res, warm = run()
    replans = ttplan.plan_resolutions() - plans0
    launches = {k: v - launches0.get(k, 0)
                for k, v in tt_contract.launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(model.device)
            if model.device.type == "cuda" else None)

    toks = args.batch * args.steps
    print(f"arch={model.cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} decode={args.steps}")
    print(f"cold run {cold:.3f}s, warm run {warm:.3f}s: {toks} tokens "
          f"({toks / warm:.1f} tok/s incl. prefill)")
    print("sample tokens[0]:", res.tokens[0].tolist())
    print(f"plan resolutions during warm run: {replans} "
          f"(model plans: {len(model.plan_book)}); kernel launches during "
          f"warm run: {launches}; peak device memory: "
          f"{'n/a on cpu' if peak is None else f'{peak / 2**30:.3f} GiB'}")
    if replans:
        raise AssertionError(f"{replans} TT plan resolutions during the warm "
                             "run: serving must execute build-time plans only")
    return {"tokens": res.tokens, "logprobs": res.logprobs,
            "tok_per_s": toks / warm, "warm_s": warm, "cold_s": cold,
            "replans": replans, "launches": launches,
            "peak_bytes": peak}


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
    return fixed(model, params, args)


if __name__ == "__main__":
    main()
