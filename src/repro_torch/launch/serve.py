"""Fixed-batch serving CLI for the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
        --variant full --batch 4 --prompt-len 64 --steps 32 --tt ffn,attn \\
        --tt-rank 16 --tt-backend auto [--tt-weights int8] [--device cpu]

``--tt-backend`` is one of ``kernels.plan.BACKENDS``: ``auto`` (d=2
layers through the fused2 kernel), ``cuda_fused2``, ``cuda_fused`` (the
whole chain in one launch), ``cuda_step`` (one step kernel per core) or
``einsum``.  Builds the model with random weights from ``--seed``, draws
the prompt tokens from a numpy generator seeded with ``--seed``, and runs
``generate_fixed`` twice: a cold run (kernel build, first-call set-up,
the capture of the decode step's CUDA graph on a card) and a warm run that
is timed and must capture nothing and resolve no TT plan.  TT launches are
those the kernel wrappers counted plus those the graph replays made (the
launches one capture recorded, times the replays).
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
    wrappers, TT launches made by replays of the model's captured decode
    steps, the captures and the plan resolutions."""
    return {"counted": tt_contract.launch_counts(),
            "replayed": dict(model.replayed_launches),
            "captures": model.graph_captures,
            "plans": ttplan.plan_resolutions()}


def launches_between(a: dict, b: dict) -> dict:
    """TT launches from tally ``a`` to tally ``b``, counted and replayed."""
    out = since(a["counted"], b["counted"])
    for k, v in since(a["replayed"], b["replayed"]).items():
        out[k] = out.get(k, 0) + v
    return out


def fixed(model, params, args) -> dict:
    """Serve the prompts of ``args`` twice: a cold run (kernel build, plan
    and geometry memos, the decode step's capture on a card) and a warm
    run that is timed and must capture nothing and resolve no TT plan."""
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
    launches = launches_between(t1, t2)
    peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
    reserved = torch.cuda.max_memory_reserved(model.device) if cuda else None

    toks = args.batch * args.steps
    print(f"arch={model.cfg.name} device={model.device} batch={args.batch} "
          f"prompt={args.prompt_len} decode={args.steps} "
          f"decode step: {'CUDA graph' if cuda else 'eager'}")
    print(f"cold run {cold:.3f}s, warm run {warm:.3f}s: {toks} tokens "
          f"({toks / warm:.1f} tok/s incl. prefill)")
    print("sample tokens[0]:", res.tokens[0].tolist())
    print(f"warm run: {replans} plan resolutions (model plans: "
          f"{len(model.plan_book)}), {captures} graph captures (cold run: "
          f"{t1['captures'] - t0['captures']}); TT launches {launches} "
          f"(counted {since(t1['counted'], t2['counted'])}, by graph "
          f"replays {since(t1['replayed'], t2['replayed'])}); peak device "
          f"memory: " + ("n/a on cpu" if peak is None else
                         f"{peak / 2**30:.3f} GiB allocated, "
                         f"{reserved / 2**30:.3f} GiB reserved"))
    if replans or captures:
        raise AssertionError(
            f"{replans} TT plan resolutions and {captures} graph captures "
            f"during the warm run: serving must execute build-time plans "
            f"and the decode step captured in the cold run")
    return {"tokens": res.tokens, "logprobs": res.logprobs,
            "tok_per_s": toks / warm, "warm_s": warm, "cold_s": cold,
            "replans": replans, "captures": captures,
            "cold_captures": t1["captures"] - t0["captures"],
            "launches": launches, "cold_launches": launches_between(t0, t1),
            "peak_bytes": peak, "peak_reserved_bytes": reserved}


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
