"""How far a prompt's logits move when its prefill is grouped another way.

    PYTHONPATH=src python -m repro_torch.launch.groupings \\
        [--variant full] [--layers 8,16,32,64] [--tt-rank 16] \\
        [--chunk-size 64] [--lens 256,1024] [--count 6] [--device cpu] \\
        [--out FILE]

A recurrent mixer (Mamba-2's SSD) sums a prompt in chunks whose length
follows the prompt's, so three prefills of one prompt take the same sums in
three orders: the exact prefill of its S tokens (chunks of the largest
divisor of S up to the config's ``chunk``: a prime S gives chunks of 1),
the bucketed one (right-padded to ``bucket_length``, as the schedulers
admit a prompt) and chunked prefill (``Model.chunk_step`` over pieces of
``--chunk-size`` tokens, the state and the conv history carried between
them).  The three are the same math and differ by rounding alone, which
scales with the activation dtype's unit roundoff; a fault in one grouping
does not.

For each depth of ``--layers`` the script builds mamba2-2.7b at
``--variant``'s width with that many layers (random weights from seed 0,
TT on ``ffn`` at ``--tt-rank``): with bf16 parameters through the TT
kernel (``auto``) and through the plain TT version (``einsum``); with the
same weights cast to fp32 through the kernel; and once more in fp32 with
the SSD scan accumulated in fp64 (``SSMConfig.scan_dtype``; the state
carried between chunks stays fp32).  For each it prints, over the
prompts, the largest |Δ log-softmax| over the vocabulary of the bucketed
and of the chunked prefill's last-token logits against the exact
prefill's, the largest |logit|, and, with bf16 parameters, each
grouping's largest |Δ log-softmax| against the exact fp32 prefill (the
same weights, the fp32 scan).  The prompt lengths are the first draw of
a numpy generator seeded with 0 (``--count`` lengths uniform in
``--lens``: those of ``chip_smoke.py``'s staggered mamba2-2.7b run), the
tokens the next.  Every prefill is eager.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import build, get_config
from repro_torch.configs.base import TTConfig
from repro_torch.models.model import bucket_length
from repro_torch.models.spec import map_tree

ARCH, SEED = "mamba2-2.7b", 0
GROUPINGS = ("exact", "bucketed", "chunked")
# (parameter dtype, TT backend, SSD scan dtype) of each build
BUILDS = ((torch.bfloat16, "auto", "float32"),
          (torch.bfloat16, "einsum", "float32"),
          (torch.float32, "auto", "float32"),
          (torch.float32, "auto", "float64"))


def draw_prompts(vocab: int, lens: tuple[int, int], count: int,
                 seed: int) -> list[torch.Tensor]:
    """``count`` prompts [1, S], S uniform within ``lens``."""
    rng = np.random.default_rng(seed)
    n = rng.integers(lens[0], lens[1] + 1, count)
    return [torch.from_numpy(rng.integers(0, vocab, (1, k), dtype=np.int64))
            for k in n]


@torch.no_grad()
def grouped_logits(model, params, tokens: torch.Tensor, T: int,
                   chunk: int) -> dict[str, torch.Tensor]:
    """The last-token logits [V] (fp32) of the prompt ``tokens [1, S]``
    under each of ``GROUPINGS``, over a cache of ``T`` positions."""
    tokens = tokens.to(model.device)
    S = int(tokens.shape[1])
    exact, _ = model.prefill(params, {"tokens": tokens, "cache_len": T})
    pad = bucket_length(S, T) - S
    bucketed, _ = model.prefill(params, {
        "tokens": F.pad(tokens, (0, pad)), "cache_len": T, "prompt_len": S})
    cache = model.init_cache(1, T, per_row=True)
    for start in range(0, S, chunk):
        n = min(chunk, S - start)
        piece = F.pad(tokens[:, start:start + n], (0, chunk - n))
        chunked, cache = model.chunk_step(params, cache, piece, 0, start, n,
                                          True)
    return {g: lg[0, -1].float()
            for g, lg in zip(GROUPINGS, (exact, bucketed, chunked))}


def max_diff(a: list[torch.Tensor], b: list[torch.Tensor]) -> float:
    """The largest |a - b| over prompts and vocabulary."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def depth_row(cfg, layers: int, prompts, T: int, chunk: int,
              device) -> list[dict]:
    """One record per ``BUILDS`` entry at ``layers`` layers."""
    cfg = dataclasses.replace(cfg, num_layers=layers)
    params = None
    lps, rows = {}, []
    for dtype, backend, scan in BUILDS:
        model = build(dataclasses.replace(
            cfg, tt=dataclasses.replace(cfg.tt, backend=backend),
            ssm=dataclasses.replace(cfg.ssm, scan_dtype=scan)),
            param_dtype=dtype, device=device)
        if params is None:
            params = model.init(SEED)
        p = map_tree(lambda t: t.to(dtype), params)
        got = [grouped_logits(model, p, t, T, chunk) for t in prompts]
        lp = {g: [torch.log_softmax(x[g], -1) for x in got]
              for g in GROUPINGS}
        lps[dtype, backend, scan] = lp
        rows.append(dict(
            layers=layers, dtype=str(dtype).removeprefix("torch."),
            backend=backend, scan=scan,
            bucketed=max_diff(lp["bucketed"], lp["exact"]),
            chunked=max_diff(lp["chunked"], lp["exact"]),
            max_logit=max(float(x["exact"].abs().max()) for x in got)))
        del model
    ref = lps[torch.float32, "auto", "float32"]["exact"]
    for row, key in zip(rows, BUILDS):
        if key[0] != torch.float32:
            row.update({f"{g}_vs_fp32": max_diff(lps[key][g], ref)
                        for g in GROUPINGS})
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="full", choices=["smoke", "full"])
    ap.add_argument("--layers", default="8,16,32,64")
    ap.add_argument("--tt-rank", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--lens", default="256,1024")
    ap.add_argument("--count", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None, help="write the records as JSON")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    full = args.variant == "full"
    cfg = get_config(ARCH, args.variant, tt=TTConfig(
        enabled=True, families=("ffn",), rank=args.tt_rank,
        min_factor=8 if full else 2))
    lens = tuple(int(v) for v in args.lens.split(","))
    prompts = draw_prompts(cfg.vocab_size, lens, args.count, SEED)
    T = lens[1] + args.chunk_size
    rows = []
    for layers in (int(v) for v in args.layers.split(",")):
        for r in depth_row(cfg, layers, prompts, T, args.chunk_size,
                           args.device):
            print(json.dumps(r), flush=True)
            rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lens": [int(t.shape[1]) for t in prompts],
                       "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
