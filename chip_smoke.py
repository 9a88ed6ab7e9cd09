#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build the hand-written kernels from
     ``src/repro_torch/kernels/csrc`` into ``build/`` and time the build;
  2. hold every kernel against its plain PyTorch version at the main
     path's full-width shapes (256 and 4 rows; fp32, bf16, int8 cores);
  3. time each kernel beside its plain version, one dense ``torch.matmul``
     computing the same layer, and the least time the card could take;
  4. check the port on a small input: the deepseek-7b SMOKE model on the
     card against the same weights on the CPU (plain versions);
  5. the main path: full-width deepseek-7b (bf16, TT on ffn+attn at rank
     16, backend auto) serves 4 rows × 32 tokens through
     ``launch.serve``, with fp and then int8 cores, and every TT
     projection must have gone through the kernel.
The last three lines are ``{"kernels": [...]}``, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": {...}}``.
Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import build, get_config  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.core.packing import pack_core  # noqa: E402
from repro_torch.core.quant import dequantize_cores, quantize_core  # noqa: E402
from repro_torch.core.tt import tt_reconstruct  # noqa: E402
from repro_torch.kernels import ref, tt_contract  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.spec import map_tree  # noqa: E402

# (n1, n2, m1, m2, r1) of deepseek-7b's TT projections at rank 16, and how
# many of each one decoder layer runs
SHAPES = {
    "attn q/k/v/o 4096->4096": ((8, 512, 512, 8, 16), 4),
    "ffn gate/up 4096->11008": ((8, 512, 1376, 8, 16), 2),
    "ffn down 11008->4096": ((8, 1376, 512, 8, 16), 1),
}
ROWS = (256, 4)          # prefill (batch 4 × prompt 64) and decode (batch 4)
LAYERS, PASSES = 30, 32  # full depth; 1 prefill + 31 decode forward passes
# (kernel, activation dtype); the main path runs bf16 activations
CASES = (("tt_fused2", torch.float32), ("tt_fused2", torch.bfloat16),
         ("tt_fused2_int8", torch.float32), ("tt_fused2_int8", torch.bfloat16))
# max |kernel − plain| / max |plain|: fp32 differs only in summation order;
# a bf16 output is rounded to 8 significant bits on both sides
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
REPLACES = {"tt_fused2": "src/repro/kernels/tt_contract.py:287",
            "tt_fused2_int8": "src/repro/kernels/tt_contract.py:310"}
SOURCE = "src/repro_torch/kernels/csrc/tt_fused2.cu"
SERVE_ARGS = ["--arch", "deepseek-7b", "--variant", "full", "--batch", "4",
              "--prompt-len", "64", "--steps", str(PASSES), "--tt",
              "ffn,attn", "--tt-rank", "16", "--tt-backend", "auto",
              "--seed", "0"]
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def cuda_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_inputs(dims, rows, kernel, act, gen):
    """x and packed cores at one shape, the kernel and plain callables, and
    the dense weight a dense layer would use."""
    n1, n2, m1, m2, r1 = dims
    # the model's TT init: the implied dense W has std sqrt(2/(M+N))
    sigma = (2.0 / (m1 * m2 + n1 * n2) / r1) ** 0.25
    dev = "cuda"
    G1 = torch.randn((1, n1, m1, r1), generator=gen, device=dev) * sigma
    G2 = torch.randn((r1, n2, m2, 1), generator=gen, device=dev) * sigma
    x = torch.randn((rows, n1 * n2), generator=gen, device=dev).to(act)
    if kernel == "tt_fused2_int8":
        (q1, s1), (q2, s2) = quantize_core(G1), quantize_core(G2)
        p2, p1 = pack_core(q2), pack_core(q1)
        scales = torch.stack([s2, s1]).float()
        dense = tt_reconstruct(dequantize_cores([q1, q2], [s1, s2],
                                                torch.float32))
        run = lambda: tt_contract.tt_fused2_int8(x, p2, p1, scales, dims)  # noqa: E731
        plain = lambda: ref.tt_fused2_ref(x, p2, p1, dims, scales)  # noqa: E731
        weight_bytes = p2.numel() + p1.numel() + scales.numel() * 4
    else:
        G1, G2 = G1.to(act), G2.to(act)
        p2, p1 = pack_core(G2), pack_core(G1)
        dense = tt_reconstruct([G1.float(), G2.float()])
        run = lambda: tt_contract.tt_fused2(x, p2, p1, dims)  # noqa: E731
        plain = lambda: ref.tt_fused2_ref(x, p2, p1, dims)  # noqa: E731
        weight_bytes = (p2.numel() + p1.numel()) * p2.element_size()
    w_dense = dense.T.contiguous().to(act)                   # [N, M]
    library = lambda: torch.matmul(x, w_dense)  # noqa: E731
    moved = (x.numel() * x.element_size() + weight_bytes
             + rows * m1 * m2 * x.element_size())
    flops = 2 * rows * (n1 * n2 * m2 * r1 + m2 * n1 * r1 * m1)
    return run, plain, library, moved, flops


def check_and_time(gen) -> list[dict]:
    """Phases 2 and 3: one record per (shape, rows, kernel, dtype)."""
    spec = hw.device_spec(torch.device("cuda"))
    recs = []
    for label, (dims, per_layer) in SHAPES.items():
        for rows in ROWS:
            for kernel, act in CASES:
                run, plain, library, moved, flops = layer_inputs(
                    dims, rows, kernel, act, gen)
                y, y_ref = run(), plain()
                torch.cuda.synchronize()
                assert y.shape == y_ref.shape and y.dtype == y_ref.dtype
                err = float((y.float() - y_ref.float()).abs().max())
                scale = float(y_ref.float().abs().max())
                rel = err / scale
                ok = bool(torch.isfinite(y).all()) and rel <= TOL[act]
                bound_s, bound_by = hw.bound_seconds(moved, flops,
                                                     DT_NAME[act], spec)
                rec = dict(label=label, rows=rows, kernel=kernel,
                           act=DT_NAME[act], per_layer=per_layer,
                           max_abs_err=err, max_rel_err=rel, tol=TOL[act],
                           ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(library),
                           bound_ms=bound_s * 1e3, bound_by=bound_by,
                           bytes=moved, flops=flops)
                recs.append(rec)
                print(f"{kernel:15s} {DT_NAME[act]:8s} {label:24s} "
                      f"rows={rows:3d} max_abs={err:.3e} rel={rel:.3e} "
                      f"(tol {TOL[act]:g}) kernel={rec['ms']:.4f}ms "
                      f"plain={rec['plain_ms']:.4f}ms "
                      f"dense_matmul={rec['library_ms']:.4f}ms "
                      f"bound={rec['bound_ms']:.5f}ms ({bound_by})",
                      flush=True)
                if not ok:
                    raise AssertionError(
                        f"{kernel} {DT_NAME[act]} {label} rows={rows}: "
                        f"max relative error {rel:.3e} > {TOL[act]:g}")
    return recs


def small_input_check() -> None:
    """Phase 4: SMOKE deepseek-7b through the kernels on the card against
    the plain versions on the CPU, same weights, teacher-forced, in fp32
    and int8; logits within 1e-4 (summation order)."""
    for weights in ("fp32", "int8"):
        cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
            enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
            backend="auto", weights=weights))
        gpu, cpu = build(cfg, device="cuda"), build(cfg, device="cpu")
        p_gpu = gpu.init(0)
        if weights == "int8":
            p_gpu = gpu.quantize_params(p_gpu)
        p_cpu = map_tree(lambda t: t.cpu(), p_gpu)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16), dtype=np.int64))
        batch = {"tokens": tokens, "cache_len": 16 + 8}
        lg, cg = gpu.prefill(p_gpu, batch)
        lc, cc = cpu.prefill(p_cpu, batch)
        worst = float((lg.cpu() - lc).abs().max())
        for _ in range(8):
            tok = lc[:, -1].argmax(-1, keepdim=True)
            lg, cg = gpu.decode_step(p_gpu, cg, tok)
            lc, cc = cpu.decode_step(p_cpu, cc, tok)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
        print(f"small input ({weights}): SMOKE logits card vs cpu max abs "
              f"diff {worst:.3e} (tol 1e-4)", flush=True)
        if not worst <= 1e-4:
            raise AssertionError(f"SMOKE {weights}: card and cpu logits "
                                 f"differ by {worst:.3e}")


def main_path(weights: str) -> tuple[dict, int]:
    """Phase 5 for one weight mode; returns serve's result and the
    kernel's launch count over the whole call (cold + warm run)."""
    kernel = "tt_fused2_int8" if weights == "int8" else "tt_fused2"
    tt_contract.reset_launch_counts()
    out = serve.main(SERVE_ARGS + ["--tt-weights", weights])
    counts = tt_contract.launch_counts()
    per_run = 7 * LAYERS * PASSES
    print(f"main path ({weights}): launches {counts}; peak memory "
          f"{out['peak_bytes'] / 2**30:.3f} GiB; {out['tok_per_s']:.1f} "
          f"tok/s", flush=True)
    if counts.get(kernel, 0) != 2 * per_run or out["launches"].get(
            kernel) != per_run or len(counts) != 1:
        raise AssertionError(
            f"expected {per_run} {kernel} launches per run (7 projections × "
            f"{LAYERS} layers × {PASSES} passes), cold + warm; got {counts}, "
            f"warm run {out['launches']}")
    toks = out["tokens"]
    if tuple(toks.shape) != (4, PASSES) or int(toks.min()) < 0 or \
            int(toks.max()) >= 102400 or \
            not bool(torch.isfinite(out["logprobs"]).all()):
        raise AssertionError(f"bad generation: {tuple(toks.shape)}")
    return out, counts[kernel]


def kernel_line(recs, launches) -> dict:
    """One entry per kernel: one decoder layer's launches of it (7
    projections, summed) at the decode batch in bf16, the main path's
    dominant case; errors are the worst over every compared case."""
    out = []
    for kernel in ("tt_fused2", "tt_fused2_int8"):
        mine = [r for r in recs if r["kernel"] == kernel]
        main = [r for r in mine if r["rows"] == 4 and r["act"] == "bfloat16"]
        tot = {k: sum(r[k] * r["per_layer"] for r in main)
               for k in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
        bound_s, bound_by = hw.bound_seconds(
            tot["bytes"], tot["flops"], "bfloat16",
            hw.device_spec(torch.device("cuda")))
        out.append(dict(
            name=kernel, route="cuda", source=SOURCE,
            replaces=REPLACES[kernel], launches=launches[kernel],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound_s * 1e3,
            bound_by=bound_by, library_ms=tot["library_ms"],
            measured_at="one layer's 7 projections, 4 rows, bf16"))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib, log = tt_contract.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s -> "
          f"{os.path.relpath(lib, ROOT)}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = check_and_time(gen)
    small_input_check()
    launches = {}
    for weights in ("fp32", "int8"):
        _, launches["tt_fused2_int8" if weights == "int8"
                    else "tt_fused2"] = main_path(weights)

    print(json.dumps(kernel_line(recs, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
