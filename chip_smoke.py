#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build the hand-written kernels from
     ``src/repro_torch/kernels/csrc`` into ``build/`` (one ``nvcc`` per
     source, all started together) and time the build;
  2. hold every kernel against its plain PyTorch version at the
     full-width deepseek-7b shapes its main path gives it (256 and 4 rows,
     and untimed at 16, 32 and 64 rows, the admission buckets; fp32, bf16,
     int8 cores): fused2 at the length-2 shapes, the fused chain at the
     length-3 shapes, the step kernel on every step of both;
  3. time each kernel beside its plain version, one PyTorch call computing
     the same function (``library_ms``) and the least time the card could
     take; fused2, the fused chain and the length-2 steps also with L2
     evicted before each call (``cold_ms``); the fused chain's launch
     geometry per shape and row count; per decoder layer, each whole-layer
     kernel's device, cold-L2 and eager times and each step's own time;
  4. check the port on a small input: the deepseek-7b SMOKE model on the
     card against the same weights on the CPU (plain versions), at length 2
     (fused2), at length 3 (fused chain) and at length 3 through the step
     kernel, fp32 and int8 cores over fp32 parameters, eagerly and through
     the captured prefill and decode step (``Model.graphed_prefill``,
     ``Model.graphed_decode_step``), and at length 2 with bf16 parameters
     as the full-width paths run; then the default (bucketed)
     continuous-batching scheduler on a staggered schedule (2 slots, 3
     requests), card (captured prefill, slot-pool graph) against CPU, at
     lengths 2 and 3 with fp32 cores and at length 2 with int8 cores;
  5. the main paths: full-width deepseek-7b (bf16, TT on ffn+attn at rank
     16) serves 4 rows × 32 tokens through ``launch.serve.fixed``, with
     fp and then int8 cores, at length 2 with backend auto (fused2, built
     from the CLI flags as ``launch.serve.main`` builds it), at length 3
     with backend auto (fused chain, built through ``get_config``/``build``:
     the CLI has no length flag) and at length 2 with ``--tt-backend
     cuda_step``; the prefill and each decode step are replays of the
     graphs captured in the cold run, and every TT projection must have
     gone through its kernel (the launches the wrappers counted, plus each
     capture's for each of its replays; none counted in the warm run);
     beside each path one eager warm run (tok/s, decode step ms and peak
     memory, graph against eager; the prefill's logits and cache and the
     first decode step's logits bit for bit, and the greedy tokens) and
     one more traced warm run of the graphs (``launch.profile_serve``:
     device busy share, kernels per pass, the TT kernels in the trace
     against the launches expected), then the decode step's and the
     prefill's replays traced alone; then continuous batching at length 2,
     auto, fp cores on one slot-pool graph of 4 slots × 96 positions, each
     admission a replay of its bucket's captured prefill: the arrival mode
     through ``launch.serve.simulate`` (16 requests at 50/s; 0 captures of
     either kind and 0 plan resolutions in the steady state, ``tt_fused2``
     replayed 210 times per admission and per decode step), a
     step-indexed staggered run of 12 requests (prompts of 16 to 64
     tokens) through the graphs and eagerly (bit-identical; one prefill
     capture per new bucket), each bucket's prefill replays traced alone
     (busy ms and host-clock ms against the eager prefill's), and a traced
     arrival run (``launch.profile_serve.profile_arrivals``: device busy
     share, the admissions' share of the wall, the per-row KV writes).
Kernel, plain and library times are device times of 50 calls enqueued
while a spin kernel holds the stream (no host time between the calls),
after two seconds of dense products have brought the card's clocks up;
the eager back-to-back time of each kernel is recorded beside them.  Every
record of phases 2, 3 and 5 is also written to ``build/chip_smoke.json``;
the kernel line's ``tt_fused2`` launches are those of the fixed-batch and
the arrival-mode calls together.
The last three lines are ``{"kernels": [...]}``, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device":
{...}}``.  Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import build, get_config  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.core.packing import (chain_state_sizes,  # noqa: E402
                                      chain_weight_elems, pack_core)
from repro_torch.core.quant import dequantize_cores, quantize_core  # noqa: E402
from repro_torch.core.tt import tt_reconstruct  # noqa: E402
from repro_torch.kernels import ref, tt_contract  # noqa: E402
from repro_torch.launch import profile_serve, serve  # noqa: E402
from repro_torch.models.graph import WARMUP_STEPS  # noqa: E402
from repro_torch.models.model import bucket_length  # noqa: E402
from repro_torch.models.spec import map_tree, tree_leaves  # noqa: E402
from repro_torch.serving.engine import generate_fixed  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

# (ns, ms, ranks) of deepseek-7b's TT projections at rank 16, and how many
# of each one decoder layer runs; length 2 (fused2, step) and length 3
# (fused chain, step)
SHAPES2 = {
    "attn q/k/v/o 4096->4096": (((8, 512), (512, 8), (1, 16, 1)), 4),
    "ffn gate/up 4096->11008": (((8, 512), (1376, 8), (1, 16, 1)), 2),
    "ffn down 11008->4096": (((8, 1376), (512, 8), (1, 16, 1)), 1),
}
SHAPES3 = {
    "attn q/k/v/o 4096->4096": (((8, 8, 64), (64, 8, 8), (1, 16, 16, 1)), 4),
    "ffn gate/up 4096->11008": (((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)),
                                2),
    "ffn down 11008->4096": (((8, 8, 172), (64, 8, 8), (1, 16, 16, 1)), 1),
}
ROWS = (256, 4)          # prefill (batch 4 × prompt 64) and decode (batch 4)
# the scheduler's one-row admission prefills at the buckets of a cache of
# 96 (bucket_length): checked against the plain versions, not timed
BUCKET_ROWS = (16, 32, 64)
LAYERS, PASSES = 30, 32  # full depth; 1 prefill + 31 decode forward passes
REPLAYS = 8              # decode steps traced alone
PROJ = 7                 # TT projections per decoder layer
# (int8 cores, activation dtype); the main path runs bf16 activations
CASES = ((False, torch.float32), (False, torch.bfloat16),
         (True, torch.float32), (True, torch.bfloat16))
# max |kernel − plain| / max |plain|: fp32 differs only in summation order;
# a bf16 output is rounded to 8 significant bits on both sides.  The step
# kernel's output is fp32 for every input dtype.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# SMOKE logits, card against cpu: with fp32 parameters only the summation
# order differs (absolute); with bf16 parameters the two sides round to
# bf16 at other places (cuBLAS against the CPU's kernels, the fused2 kernel
# against its plain version), so a few bf16 ulps: relative to the largest
# |logit|, as in tests/test_torch_model_bf16.py
SMOKE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bytes written between two cold-L2 calls: 2.5× the H100's 50 MB L2
FLUSH_BYTES = 128 * 2 ** 20
TT_FILE = "src/repro/kernels/tt_contract.py"
KERNELS = {   # name → (source, TPU kernel it replaces)
    "tt_fused2": ("tt_fused2.cu", 287),
    "tt_fused2_int8": ("tt_fused2.cu", 310),
    "tt_fused_chain": ("tt_chain.cu", 446),
    "tt_fused_chain_int8": ("tt_chain.cu", 478),
    "tt_step": ("tt_step.cu", 178),
    "tt_step_int8": ("tt_step.cu", 193),
}
SERVE_ARGS = ["--arch", "deepseek-7b", "--variant", "full", "--batch", "4",
              "--prompt-len", "64", "--steps", str(PASSES), "--tt",
              "ffn,attn", "--tt-rank", "16", "--seed", "0"]
# the arrival mode on the slot pool's graph (4 slots × 96 positions): 16
# requests at 50/s saturate the pool, so requests queue and slots are reused
ARRIVAL_ARGS = SERVE_ARGS + ["--tt-backend", "auto", "--slots", "4",
                             "--max-requests", "16", "--arrival-rate", "50",
                             "--assert-no-replan"]
# the step-indexed staggered run: requests, prompt lengths, budgets
STAGGER_N, STAGGER_LENS, STAGGER_BUDGETS = 12, (16, 64), (8, 32)
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def cuda_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Mean milliseconds per call from CUDA events over back-to-back eager
    calls, after warm-up: the device time, or the host's when launching
    takes longer than the work."""
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


def device_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds per call: a spin kernel holds the stream
    while the host enqueues ``iters`` calls, which then run back to back
    with no host time between them.  The hold grows until it outlasts the
    enqueueing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    while True:
        hold, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        hold.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if hold.elapsed_time(start) > enqueue_ms:
            return start.elapsed_time(end) / iters
        if cycles > 10 ** 11:
            raise RuntimeError("the host never got ahead of the device")
        cycles *= 4


def cold_device_ms(fn, flush, iters: int = 50) -> float:
    """Device milliseconds per call of ``fn`` with L2 evicted before each
    call: ``flush`` (a write of ``FLUSH_BYTES``) then ``fn``, back to back,
    less ``flush`` timed alone."""
    both = device_ms(lambda: (flush(), fn()), iters)
    return both - device_ms(flush, iters)


def random_cores(dims, act, int8, gen):
    """The model's TT init (the implied dense W has std sqrt(2/(M+N))):
    (cores in ``act`` or int8, their scales or None, the dense W [M, N])."""
    ns, ms, ranks = dims
    d = len(ns)
    rank_prod = int(np.prod(ranks[1:-1]))
    sigma = (2.0 / (np.prod(ms) + np.prod(ns)) / rank_prod) ** (1 / (2 * d))
    cores = [torch.randn((ranks[t], ns[t], ms[t], ranks[t + 1]),
                         generator=gen, device="cuda") * sigma
             for t in range(d)]
    if int8:
        qs = [quantize_core(G) for G in cores]
        q, s = [a for a, _ in qs], [b for _, b in qs]
        return q, s, tt_reconstruct(dequantize_cores(q, s, torch.float32))
    cores = [G.to(act) for G in cores]
    return cores, None, tt_reconstruct([G.float() for G in cores])


def chain_geometry(dims, rows, int8, act, spec) -> dict:
    """The fused chain's launch geometry (``tt_contract.chain_geometry``)
    at one shape, printed."""
    act_bytes = torch.finfo(act).bits // 8
    geo = tt_contract.chain_geometry(rows, dims, act_bytes,
                                     1 if int8 else act_bytes, spec.sm_count,
                                     spec.smem_per_block)
    out = dict(bb=geo.bb, g=geo.g, g2=geo.g2, ncc=geo.ncc, stages=geo.stages,
               smem=geo.smem, grid=list(geo.grid))
    print(f"  tt_fused_chain geometry rows={rows:3d} {DT_NAME[act]:8s} "
          f"{'int8' if int8 else 'fp'}: {out}", flush=True)
    return out


def layer_cases(dims, rows, int8, act, gen):
    """Whole-layer kernels at one shape: (kernel, run, plain, library,
    bytes, flops) for fused2 (d=2) or the fused chain (d=3), with the dense
    ``torch.matmul`` of the layer it replaces as the library call."""
    ns, ms, ranks = dims
    cores, scales, dense = random_cores(dims, act, int8, gen)
    x = torch.randn((rows, int(np.prod(ns))), generator=gen,
                    device="cuda").to(act)
    packed = [pack_core(G) for G in reversed(cores)]
    if len(ns) == 2:
        kernel = "tt_fused2"
        d2 = (ns[0], ns[1], ms[0], ms[1], ranks[1])
        if int8:
            s = torch.stack([scales[1], scales[0]]).float()
            run = lambda: tt_contract.tt_fused2_int8(x, *packed, s, d2)  # noqa: E731
            plain = lambda: ref.tt_fused2_ref(x, *packed, d2, s)  # noqa: E731
        else:
            run = lambda: tt_contract.tt_fused2(x, *packed, d2)  # noqa: E731
            plain = lambda: ref.tt_fused2_ref(x, *packed, d2)  # noqa: E731
    else:
        kernel = "tt_fused_chain"
        if int8:
            s = torch.stack(scales[::-1]).float()
            run = lambda: tt_contract.tt_fused_chain_int8(x, packed, s, dims)  # noqa: E731
            plain = lambda: ref.tt_fused_chain_ref(x, packed, dims, s)  # noqa: E731
        else:
            run = lambda: tt_contract.tt_fused_chain(x, packed, dims)  # noqa: E731
            plain = lambda: ref.tt_fused_chain_ref(x, packed, dims)  # noqa: E731
    w_dense = dense.T.contiguous().to(act)                   # [N, M]
    library = lambda: torch.matmul(x, w_dense)  # noqa: E731
    weight_bytes = chain_weight_elems(ns, ms, ranks) * (
        packed[0].element_size()) + (4 * len(ns) if int8 else 0)
    sizes = chain_state_sizes(ns, ms, ranks)
    macs = sum(sizes[j] * ms[t] * ranks[t] for j, t in
               enumerate(range(len(ns) - 1, -1, -1)))
    moved = (x.numel() + rows * sizes[-1]) * x.element_size() + weight_bytes
    return (kernel + ("_int8" if int8 else ""), run, plain, library, moved,
            2 * rows * macs, x, cores, scales)


def step_cases(x, cores, scales, int8, act):
    """The step kernel on every step of a chain, each on the state the
    plain steps before it produced (cast to ``act`` between steps, as the
    executor does).  The library call is one ``torch.matmul`` of
    ``X [b, n·r1]`` by the packed core (dequantized for int8 cores)."""
    out = []
    state = x.reshape(-1)
    for t in range(len(cores) - 1, -1, -1):
        G = cores[t]
        r0, n, m, r1 = G.shape
        X = state.reshape(-1, n, r1)
        if int8:
            s = scales[t].reshape(1).float()
            run = lambda G=G, X=X, s=s: tt_contract.tt_step_int8(G, X, s)  # noqa: E731
            plain = lambda G=G, X=X, s=s: ref.tt_step_ref(G, X, s)  # noqa: E731
            P = pack_core(G.float() * s).to(act)
        else:
            run = lambda G=G, X=X: tt_contract.tt_step(G, X)  # noqa: E731
            plain = lambda G=G, X=X: ref.tt_step_ref(G, X)  # noqa: E731
            P = pack_core(G)
        X2 = X.reshape(X.shape[0], n * r1)
        library = lambda X2=X2, P=P: torch.matmul(X2, P)  # noqa: E731
        b = X.shape[0]
        moved = (G.numel() * G.element_size() + X.numel() * X.element_size()
                 + m * b * r0 * 4 + (4 if int8 else 0))
        out.append((f"step {len(cores) - t}/{len(cores)}", run, plain,
                    library, moved, 2 * m * b * r0 * n * r1))
        state = plain().reshape(-1).to(act)
    return out


def check(kernel, label, rows, act, run, plain, tol) -> dict:
    """Compare one kernel call with its plain version (no timing); fails
    when the error exceeds ``tol``."""
    y, y_ref = run(), plain()
    torch.cuda.synchronize()
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype
    err = float((y.float() - y_ref.float()).abs().max())
    rel = err / float(y_ref.float().abs().max())
    if not (bool(torch.isfinite(y).all()) and rel <= tol):
        raise AssertionError(f"{kernel} {DT_NAME[act]} {label} rows={rows}: "
                             f"max relative error {rel:.3e} > {tol:g}")
    return dict(label=label, rows=rows, kernel=kernel, act=DT_NAME[act],
                max_abs_err=err, max_rel_err=rel, tol=tol)


def measure(kernel, label, rows, act, per_layer, run, plain, library,
            moved, flops, tol, spec, flush=None) -> dict:
    """Compare one kernel call with its plain version (``check``), then
    time kernel, plain and library, and with ``flush`` the kernel with L2
    evicted before each call."""
    rec = check(kernel, label, rows, act, run, plain, tol)
    bound_s, bound_by = hw.bound_seconds(moved, flops, DT_NAME[act], spec)
    rec.update(per_layer=per_layer, eager_ms=cuda_ms(run), ms=device_ms(run),
               plain_ms=device_ms(plain), library_ms=device_ms(library),
               bound_ms=bound_s * 1e3, bound_by=bound_by, bytes=moved,
               flops=flops)
    cold = ""
    if flush is not None:
        rec["cold_ms"] = cold_device_ms(run, flush)
        cold = f" cold-L2 {rec['cold_ms']:.4f}"
    print(f"{kernel:19s} {DT_NAME[act]:8s} {label:36s} rows={rows:3d} "
          f"abs={rec['max_abs_err']:.2e} rel={rec['max_rel_err']:.2e} (tol "
          f"{tol:g}) kernel={rec['ms']:.4f}{cold} (eager "
          f"{rec['eager_ms']:.4f}) plain={rec['plain_ms']:.4f} "
          f"library={rec['library_ms']:.4f} bound={rec['bound_ms']:.5f} ms "
          f"({bound_by})", flush=True)
    return rec


def warm_card(seconds: float = 2.0) -> None:
    """Hold the card busy with dense bf16 products for ``seconds`` of wall
    time, so that the first records timed do not run at idle clocks."""
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            torch.matmul(a, a)
        torch.cuda.synchronize()


def check_buckets(gen) -> list[dict]:
    """Phase 2 at the admission buckets' row counts (``BUCKET_ROWS``):
    every kernel against its plain version at every shape, case and step
    of both lengths, untimed."""
    recs = []
    for length, shapes in ((2, SHAPES2), (3, SHAPES3)):
        for label, (dims, _) in shapes.items():
            for rows in BUCKET_ROWS:
                for int8, act in CASES:
                    kernel, run, plain, _, _, _, x, cores, scales = \
                        layer_cases(dims, rows, int8, act, gen)
                    batch = [check(kernel, label, rows, act, run, plain,
                                   TOL[act])]
                    for step, run, plain, *_ in step_cases(
                            x, cores, scales, int8, act):
                        batch.append(check(
                            "tt_step_int8" if int8 else "tt_step",
                            f"{label} d={length} {step}", rows, act, run,
                            plain, TOL[torch.float32]))
                    for rec in batch:
                        rec["length"] = length
                    recs += batch
    worst = {}
    for r in recs:
        worst[r["kernel"]] = max(worst.get(r["kernel"], 0.0),
                                 r["max_rel_err"])
    print(f"kernels at {BUCKET_ROWS} rows: {len(recs)} calls within "
          f"tolerance; worst relative error by kernel "
          f"{ {k: f'{v:.2e}' for k, v in worst.items()} }", flush=True)
    return recs


def check_and_time(gen) -> list[dict]:
    """Phases 2 and 3: one record per (kernel, shape, step, rows, case).
    Steps are checked and timed at both lengths; the kernel line reports
    them at length 2, their main path.  The card is warmed first."""
    spec = hw.device_spec(torch.device("cuda"))
    warm_card()
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush = buf.zero_
    recs = []
    for length, shapes in ((2, SHAPES2), (3, SHAPES3)):
        for label, (dims, per_layer) in shapes.items():
            for rows in ROWS:
                for int8, act in CASES:
                    kernel, run, plain, library, moved, flops, x, cores, \
                        scales = layer_cases(dims, rows, int8, act, gen)
                    batch = [measure(kernel, label, rows, act, per_layer,
                                     run, plain, library, moved, flops,
                                     TOL[act], spec, flush)]
                    if length == 3:
                        batch[0]["geometry"] = chain_geometry(
                            dims, rows, int8, act, spec)
                    for step, *rest in step_cases(x, cores, scales, int8,
                                                  act):
                        batch.append(measure(
                            "tt_step_int8" if int8 else "tt_step",
                            f"{label} d={length} {step}", rows, act,
                            per_layer, *rest, TOL[torch.float32], spec,
                            flush if length == 2 else None))
                        batch[-1]["step"] = step
                    for rec in batch:
                        rec["length"] = length
                    recs += batch
    return recs


def layer_summary(recs) -> list[dict]:
    """Each whole-layer kernel's times summed over one decoder layer's
    projections (bf16 activations), per row count: device, cold-L2, eager
    (back-to-back calls, the host's time where it is longer), plain,
    ``torch.matmul`` and the bound."""
    out = []
    for kernel in ("tt_fused2", "tt_fused2_int8", "tt_fused_chain",
                   "tt_fused_chain_int8"):
        for rows in ROWS:
            rs = [r for r in recs if r["kernel"] == kernel and
                  r["rows"] == rows and r["act"] == "bfloat16"]
            row = dict(kernel=kernel, rows=rows)
            for key in ("ms", "cold_ms", "eager_ms", "plain_ms",
                        "library_ms", "bound_ms"):
                row[key] = sum(r[key] * r["per_layer"] for r in rs)
            out.append(row)
            print(f"{kernel:19s} rows={rows:3d} per layer: device "
                  f"{row['ms']:.4f} cold-L2 {row['cold_ms']:.4f} eager "
                  f"{row['eager_ms']:.4f} plain {row['plain_ms']:.4f} "
                  f"matmul {row['library_ms']:.4f} bound "
                  f"{row['bound_ms']:.5f} ms", flush=True)
    return out


def step_breakdown(recs) -> list[dict]:
    """Each step's own device time, summed over one decoder layer's
    projections (bf16 activations), per step kernel, length and row count:
    which step of the chain leads."""
    out = []
    for kernel in ("tt_step", "tt_step_int8"):
        for length in (2, 3):
            for rows in ROWS:
                mine = [r for r in recs if r["kernel"] == kernel and
                        r["length"] == length and r["rows"] == rows and
                        r["act"] == "bfloat16"]
                for step in sorted({r["step"] for r in mine}):
                    rs = [r for r in mine if r["step"] == step]
                    row = dict(kernel=kernel, length=length, rows=rows,
                               step=step)
                    for key in ("ms", "cold_ms", "library_ms", "bound_ms"):
                        if all(key in r for r in rs):
                            row[key] = sum(r[key] * r["per_layer"]
                                           for r in rs)
                    out.append(row)
                    cold = (f" cold-L2 {row['cold_ms']:.4f}"
                            if "cold_ms" in row else "")
                    print(f"{kernel:12s} length {length} rows={rows:3d} "
                          f"{step}: {row['ms']:.4f} ms per layer{cold} "
                          f"(matmul {row['library_ms']:.4f}, bound "
                          f"{row['bound_ms']:.5f})", flush=True)
    return out


def small_input_check() -> None:
    """Phase 4: SMOKE deepseek-7b through the kernels on the card against
    the plain versions on the CPU, same weights, teacher-forced: fp32 and
    int8 cores over fp32 parameters at each (length, backend) of the main
    paths, logits within 1e-4 (summation order), decoded eagerly and then
    through the captured decode step (``Model.graphed_decode_step``), whose
    greedy tokens through ``generate_fixed`` must be the CPU's; and length 2
    with bf16 parameters, as the full-width paths run, within
    ``SMOKE_TOL``, eagerly.  Each run must launch only its kernel."""
    cases = [(length, backend, kernel, weights, torch.float32)
             for length, backend, kernel in ((2, "auto", "tt_fused2"),
                                             (3, "auto", "tt_fused_chain"),
                                             (3, "cuda_step", "tt_step"))
             for weights in ("fp32", "int8")]
    cases.append((2, "auto", "tt_fused2", "fp32", torch.bfloat16))
    for length, backend, kernel, weights, pdt in cases:
        cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
            enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
            length=length, backend=backend, weights=weights))
        gpu = build(cfg, param_dtype=pdt, device="cuda")
        cpu = build(cfg, param_dtype=pdt, device="cpu")
        p_gpu = gpu.init(0)
        if weights == "int8":
            p_gpu = gpu.quantize_params(p_gpu)
        p_cpu = map_tree(lambda t: t.cpu(), p_gpu)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 16), dtype=np.int64))
        batch = {"tokens": tokens, "cache_len": 16 + 8}
        # the CPU's teacher-forced logits: prefill, then 8 decode steps fed
        # the CPU's own greedy tokens
        lc, cc = cpu.prefill(p_cpu, batch)
        want, forced = [lc], []
        for _ in range(8):
            forced.append(want[-1][:, -1].argmax(-1, keepdim=True))
            lc, cc = cpu.decode_step(p_cpu, cc, forced[-1])
            want.append(lc)
        top = max(float(w.float().abs().max()) for w in want)
        tol = SMOKE_TOL[pdt] * (top if pdt == torch.bfloat16 else 1.0)
        runs = ("eager", "graph") if pdt == torch.float32 else ("eager",)
        for how in runs:
            tt_contract.reset_launch_counts()
            captured0 = tt_contract.capture_counts()
            if how == "graph":
                lg, cg = gpu.graphed_prefill(2, 16, 16 + 8)(
                    p_gpu, tokens, 16)
                step = gpu.graphed_decode_step(2, 16 + 8)
                step.load(p_gpu, cg, 16)
            else:
                lg, cg = gpu.prefill(p_gpu, batch)
            got = [lg.clone()]
            for tok in forced:
                if how == "graph":
                    got.append(step(tok.cuda()).clone())
                else:
                    lg, cg = gpu.decode_step(p_gpu, cg, tok)
                    got.append(lg)
            worst = max(float((g.cpu().float() - w.float()).abs().max())
                        for g, w in zip(got, want))
            counts = set(tt_contract.launch_counts()) | set(
                k for k, v in tt_contract.capture_counts().items()
                if v != captured0.get(k, 0))
            wanted = kernel + ("_int8" if weights == "int8" else "")
            print(f"small input (length {length}, {backend}, {weights} "
                  f"cores, {DT_NAME[pdt]} params, {how} decode): SMOKE "
                  f"logits card vs cpu max abs diff {worst:.3e} (tol "
                  f"{tol:.3e}, max |logit| {top:.3f}); kernels {counts}",
                  flush=True)
            if not worst <= tol:
                raise AssertionError(
                    f"SMOKE {weights} {DT_NAME[pdt]} length {length} {how}: "
                    f"card and cpu logits differ by {worst:.3e} > {tol:.3e}")
            if counts != {wanted}:
                raise AssertionError(f"SMOKE length {length} {backend} "
                                     f"{how}: expected only {wanted}, got "
                                     f"{counts}")
        if pdt == torch.float32:
            g_toks = generate_fixed(gpu, p_gpu, batch, 8).tokens.cpu()
            c_toks = generate_fixed(cpu, p_cpu, batch, 8).tokens
            print(f"small input (length {length}, {backend}, {weights} "
                  f"cores): greedy tokens through the graphs on the card "
                  f"{'=' if torch.equal(g_toks, c_toks) else '!='} the "
                  f"cpu's; {gpu.graph_captures} decode and "
                  f"{gpu.prefill_builds} prefill capture", flush=True)
            if not torch.equal(g_toks, c_toks) or (
                    gpu.graph_captures, gpu.prefill_builds) != (1, 1):
                raise AssertionError(
                    f"SMOKE length {length} {backend} {weights}: greedy "
                    f"tokens card {g_toks.tolist()} cpu {c_toks.tolist()}, "
                    f"{gpu.graph_captures} decode and {gpu.prefill_builds} "
                    f"prefill captures")


def staggered_smoke(model, params, prompts) -> dict:
    """The staggered schedule of ``tests/test_torch_scheduler.py``: 2 slots
    over 16 positions; r0 (budget 6) is admitted and decodes one step, r1
    (3) joins, r2 (5) queues until a slot frees.  {uid: FinishedRequest}."""
    sched = Scheduler(model, params, num_slots=2, cache_len=16)
    for uid, budget in enumerate((6, 3, 5)):
        sched.submit(Request(uid=uid, inputs={"tokens": prompts[uid:uid + 1]},
                             max_new_tokens=budget))
        if uid < 2:
            sched.step()
    sched.run()
    return {f.uid: f for f in sched.finished}, sched


def small_scheduler_check() -> None:
    """Phase 4, the scheduler: the staggered schedule on SMOKE through the
    default (bucketed) scheduler on the card (every admission a replay of
    the captured prefill of the bucket of 16, every decode step a replay of
    the slot-pool graph) and on the CPU (plain versions, eager padded
    prefills), same weights: at length 2 and 3 ``auto`` with fp32 cores and
    at length 2 with int8 cores.  Greedy tokens identical, logprobs within
    1e-4; the card launches only the path's kernel, per pass at the two
    captures' warm-ups (counted) and at each admission and decode step
    (replayed)."""
    for length, kernel, weights in ((2, "tt_fused2", "fp32"),
                                    (3, "tt_fused_chain", "fp32"),
                                    (2, "tt_fused2", "int8")):
        cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
            enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
            length=length, backend="auto", weights=weights))
        gpu = build(cfg, device="cuda")
        cpu = build(cfg, device="cpu")
        p_gpu = gpu.init(0)
        if weights == "int8":
            p_gpu = gpu.quantize_params(p_gpu)
        p_cpu = map_tree(lambda t: t.cpu(), p_gpu)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (3, 8), dtype=np.int64))
        want, _ = staggered_smoke(cpu, p_cpu, prompts)
        tt_contract.reset_launch_counts()
        got, sched = staggered_smoke(gpu, p_gpu, prompts)
        name = kernel + ("_int8" if weights == "int8" else "")
        per_pass = sched.graph.captured.get(name, 0)
        prefill = gpu.prefill_graphs[(1, 16, 16)].captured
        counted = tt_contract.launch_counts()
        replayed = dict(gpu.replayed_launches)
        same = all(np.array_equal(got[u].tokens, want[u].tokens)
                   for u in want)
        worst = max(float(np.abs(got[u].logprobs - want[u].logprobs).max())
                    for u in want)
        print(f"small input, scheduler (length {length}, auto, {weights} "
              f"cores): greedy tokens card {'=' if same else '!='} cpu, "
              f"logprobs max abs diff {worst:.3e} (tol 1e-4); "
              f"{sched.admissions} admissions, {sched.steps_run} steps, "
              f"{gpu.graph_captures} decode and {gpu.prefill_builds} prefill "
              f"capture; launches counted {counted}, replayed {replayed} "
              f"({per_pass} per pass)", flush=True)
        want_counts = ({name: per_pass * 2 * WARMUP_STEPS},
                       {name: per_pass * (sched.steps_run + sched.admissions)},
                       {name: per_pass}, (1, 1))
        got_counts = (counted, replayed, prefill,
                      (gpu.graph_captures, gpu.prefill_builds))
        if not same or not worst <= 1e-4 or per_pass == 0 or \
                got_counts != want_counts:
            raise AssertionError(
                f"SMOKE scheduler length {length} {weights}: tokens same "
                f"{same}, logprobs {worst:.3e}; (counted, replayed, prefill "
                f"capture, captures) {got_counts} != {want_counts}")


def drive(label: str, kernel: str, per_pass: int, model, params,
          args) -> tuple[dict, int]:
    """One main path: launch counts set to 0 just before
    ``launch.serve.fixed`` serves ``model`` (a cold run that captures the
    prefill and the decode step, and a warm run of replays) and read just
    after.  Each capture must record ``per_pass`` launches of ``kernel``
    and nothing else; the warm run must make ``per_pass`` × ``PASSES`` of
    them, all replayed (none counted), capture nothing and resolve no
    plan.  Returns serve's result and the kernel's launches over the whole
    call, counted and replayed."""
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    out = serve.fixed(model, params, args)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    T = args.prompt_len + args.steps
    graph = model.decode_graphs[(args.batch, T, False)]
    prefill = model.prefill_graphs[(args.batch, args.prompt_len, T)]
    per_run = per_pass * PASSES
    print(f"main path ({label}): launches counted {counted}, by graph "
          f"replays {replayed} (one capture of the decode step: "
          f"{graph.captured}, of the prefill: {prefill.captured}); peak "
          f"memory {out['peak_bytes'] / 2**30:.3f} GiB allocated, "
          f"{out['peak_reserved_bytes'] / 2**30:.3f} GiB reserved; "
          f"{out['tok_per_s']:.1f} tok/s; warm run {out['warm_s']:.3f} s",
          flush=True)
    want = {
        "decode capture": ({kernel: per_pass}, graph.captured),
        "prefill capture": ({kernel: per_pass}, prefill.captured),
        "warm run": ({kernel: per_run}, out["launches"]),
        "warm run counted": ({}, out["counted"]),
        "cold run": ({kernel: per_run + 2 * WARMUP_STEPS * per_pass},
                     out["cold_launches"]),
        "counted": ({kernel: 2 * WARMUP_STEPS * per_pass}, counted),
        "replayed": ({kernel: 2 * PASSES * per_pass}, replayed),
        "decode captures cold, warm": ((1, 0), (out["cold_captures"],
                                                out["captures"])),
        "prefill captures cold, warm": ((1, 0), (
            out["cold_prefill_captures"], out["prefill_captures"])),
        "plan resolutions": (0, out["replans"]),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"{label}: (expected, got) {bad}")
    toks = out["tokens"]
    if tuple(toks.shape) != (4, PASSES) or int(toks.min()) < 0 or \
            int(toks.max()) >= 102400 or \
            not bool(torch.isfinite(out["logprobs"]).all()):
        raise AssertionError(f"bad generation: {tuple(toks.shape)}")
    return out, counted[kernel] + replayed[kernel]


def decode_steps(model, params, batch, graph: bool, n: int = 16):
    """Prefill ``batch`` (a replay of its captured prefill, or eagerly),
    then 1 + ``n`` greedy decode steps, replayed or eager: (the prefill's
    logits and cache, copied; the first step's logits; the mean host-clock
    ms of the ``n`` later steps, each with its greedy pick, to the device's
    end)."""
    B, S = batch["tokens"].shape
    logits, cache = model.padded_prefill(params, batch["tokens"], S,
                                         batch["cache_len"], graph)
    prefilled = (logits.clone(), map_tree(torch.clone, cache))
    if graph:
        step = model.graphed_decode_step(B, batch["cache_len"])
        step.load(params, cache, S)
    else:
        def step(tok):
            nonlocal cache
            out, cache = model.decode_step(params, cache, tok)
            return out
    first = step(logits[:, -1].argmax(-1, keepdim=True)).clone()
    tok = first[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tok = step(tok)[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return prefilled, first, (time.perf_counter() - t0) * 1e3 / n


def eager_runs(model, params, args) -> dict:
    """Before the graph exists: a cold and a warm eager run of the served
    prompts; the warm one's tok/s, peak memory and tokens."""
    batch = serve.prompt_batch(model, args)
    serve.timed_run(model, params, batch, args, graph=False)
    torch.cuda.reset_peak_memory_stats()
    res, warm = serve.timed_run(model, params, batch, args, graph=False)
    out = dict(tok_per_s=args.batch * args.steps / warm, warm_s=warm,
               peak_bytes=torch.cuda.max_memory_allocated(),
               peak_reserved_bytes=torch.cuda.max_memory_reserved(),
               tokens=res.tokens)
    # the graph's pool is measured on its own
    torch.cuda.empty_cache()
    return out


def graph_against_eager(label: str, model, params, args, out: dict,
                        eager: dict, smi: str) -> dict:
    """Phase 5 beside each served path: the graph's warm run (``out``)
    against the eager one (``eager``): tok/s, peak memory, greedy tokens
    identical; then the captured prefill's logits and cache against the
    eager prefill's and the first decode step's logits, graph against
    eager, bit for bit, and each decode step's time."""
    batch = serve.prompt_batch(model, args)
    captures = (model.graph_captures, model.prefill_builds)
    g_pre, g_first, g_ms = decode_steps(model, params, batch, graph=True)
    e_pre, e_first, e_ms = decode_steps(model, params, batch, graph=False)
    diff = float((g_first - e_first).abs().max())
    prefill_same = torch.equal(g_pre[0], e_pre[0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_pre[1]),
                                          tree_leaves(e_pre[1])))
    same_tokens = torch.equal(eager["tokens"], out["tokens"])
    rec = dict(graph_tok_per_s=out["tok_per_s"],
               eager_tok_per_s=eager["tok_per_s"],
               graph_step_ms=g_ms, eager_step_ms=e_ms,
               graph_peak_bytes=out["peak_bytes"],
               graph_reserved_bytes=out["peak_reserved_bytes"],
               eager_peak_bytes=eager["peak_bytes"],
               eager_reserved_bytes=eager["peak_reserved_bytes"],
               first_step_max_abs_diff=diff, tokens_identical=same_tokens,
               prefill_identical=prefill_same)
    gib = 2 ** 30
    print(f"graph vs eager ({label}; {smi}): {rec['graph_tok_per_s']:.1f} "
          f"vs {rec['eager_tok_per_s']:.1f} tok/s (warm run, prefill "
          f"included); decode step {g_ms:.3f} vs {e_ms:.3f} ms; peak "
          f"allocated {out['peak_bytes'] / gib:.3f} vs "
          f"{eager['peak_bytes'] / gib:.3f} GiB (reserved "
          f"{out['peak_reserved_bytes'] / gib:.3f} vs "
          f"{eager['peak_reserved_bytes'] / gib:.3f}); prefill logits and "
          f"cache {'bit-identical' if prefill_same else 'DIFFER'}; first "
          f"decode step's logits max abs diff {diff:.3e}; greedy tokens "
          f"{'identical' if same_tokens else 'DIFFER'}", flush=True)
    now = (model.graph_captures, model.prefill_builds)
    if diff != 0 or not same_tokens or not prefill_same or now != captures:
        raise AssertionError(f"{label}: graph and eager differ (prefill "
                             f"identical {prefill_same}, first step "
                             f"{diff:.3e}, tokens identical {same_tokens}, "
                             f"captures and prefill builds {captures} -> "
                             f"{now})")
    return rec


def traced(label: str, kernel: str, per_pass: int, model, params,
           args) -> dict:
    """Trace one more warm run (``launch.profile_serve``): the TT kernels
    found in the device trace must be the launches expected, the
    prefill's and ``per_pass`` for each replay; then ``REPLAYS`` replays
    alone (device kernels, busy and wall time per replay)."""
    print(f"profile ({label}):", flush=True)
    prof = profile_serve.profile_fixed(model, params, args)
    source = {"tt_fused2": "tt_fused2_kernel",
              "tt_fused_chain": "tt_chain_kernel",
              "tt_step": "tt_step_kernel"}[kernel.removesuffix("_int8")]
    tt = prof["tt_kernels"].get(source, {"found": 0, "expected": None})
    per_replay = (tt["found"] - per_pass) / (PASSES - 1)
    print(f"profile ({label}): {source} in the trace {tt['found']} of "
          f"{tt['expected']} expected; {per_replay:g} per replay of "
          f"{per_pass}", flush=True)
    if tt["found"] != tt["expected"] or tt["found"] != per_pass * PASSES:
        raise AssertionError(f"{label}: {tt} {source} kernels in the trace, "
                             f"expected {per_pass * PASSES}")
    # replays alone, after a prefill outside the trace
    batch = serve.prompt_batch(model, args)
    logits, cache = model.prefill(params, batch)
    step = model.graphed_decode_step(args.batch, batch["cache_len"])
    step.load(params, cache, args.prompt_len)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    alone = replays_alone(lambda: step(tok), source)
    pre = prefill_replays(model, params, batch["tokens"], args.prompt_len,
                          batch["cache_len"], source)
    rec = dict(busy_s=prof["busy_s"], wall_s=prof["wall_s"],
               busy_share=prof["busy_s"] / prof["wall_s"],
               kernels_per_pass=prof["launches"] / PASSES,
               tt_found=tt["found"], tt_expected=tt["expected"],
               tt_per_replay=per_replay,
               **{f"replay_{k}": v for k, v in alone.items()},
               **{f"prefill_{k}": v for k, v in pre.items()})
    print(f"profile ({label}): {REPLAYS} replays alone: "
          f"{rec['replay_kernels']:g} device kernels, {rec['replay_tt']:g} "
          f"{source}, {rec['replay_busy_ms']:.3f} ms busy, "
          f"{rec['replay_wall_ms']:.3f} ms wall per replay", flush=True)
    print(f"profile ({label}): prefill of {args.batch} x {args.prompt_len} "
          f"tokens: {pre_line(pre, source)}", flush=True)
    if rec["replay_tt"] != per_pass or rec["prefill_tt"] != per_pass:
        raise AssertionError(f"{label}: {rec['replay_tt']} and "
                             f"{rec['prefill_tt']} {source} per decode and "
                             f"prefill replay traced alone, expected "
                             f"{per_pass}")
    return rec


def replays_alone(replay, source: str) -> dict:
    """``REPLAYS`` calls of ``replay`` traced alone (device kernels only,
    the trace opened by the pre-roll): per call, the device kernels, those
    of ``source``, the device busy ms and the host-clock wall ms (the
    profiler's host cost included)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profile_serve.preroll()
        t0 = time.perf_counter()
        for _ in range(REPLAYS):
            replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(profile_serve.RECORDS_S)
    ks = profile_serve.device_kernels(prof)
    return dict(kernels=sum(e.count for e in ks) / REPLAYS,
                tt=sum(e.count for e in ks if source in e.key) / REPLAYS,
                busy_ms=sum(e.self_device_time_total for e in ks) / 1e3
                / REPLAYS,
                wall_ms=wall * 1e3 / REPLAYS)


def host_ms(fn, n: int = REPLAYS) -> float:
    """Mean host-clock ms of ``n`` calls of ``fn``, each to the device's
    end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def prefill_replays(model, params, tokens, prompt_len: int, T: int,
                    source: str) -> dict:
    """The captured prefill of ``tokens [B, S]`` (right-padded past
    ``prompt_len``) into a cache of ``T``: its replays traced alone
    (``replays_alone``), and the host-clock ms of a replay (the copy of the
    tokens in, to the device's end) against the eager prefill's at the same
    shape, untraced."""
    B, S = tokens.shape
    graph = model.graphed_prefill(B, S, T)
    out = replays_alone(lambda: graph(params, tokens, prompt_len), source)
    out.update(host_ms=host_ms(lambda: graph(params, tokens, prompt_len)),
               eager_host_ms=host_ms(lambda: model.prefill(params, {
                   "tokens": tokens, "cache_len": T,
                   "prompt_len": prompt_len})))
    return out


def pre_line(pre: dict, source: str) -> str:
    return (f"replay {pre['host_ms']:.3f} ms host clock (eager "
            f"{pre['eager_host_ms']:.3f}); traced alone {pre['kernels']:g} "
            f"device kernels, {pre['tt']:g} {source}, {pre['busy_ms']:.3f} "
            f"ms busy, {pre['wall_ms']:.3f} ms wall per replay")


def cli_model(argv):
    """(model, params, serve flags) as ``launch.serve.main`` builds them
    before it calls ``serve.fixed``."""
    args = serve.parse_args(argv)
    return (*serve.setup(args), args)


def length3_model(weights: str):
    """(model, params, serve flags) of full-width deepseek-7b at TT length
    3, backend auto, built through ``get_config``/``build``/``init`` with
    the flags of the other main paths (the CLI has no length flag)."""
    args = serve.parse_args(SERVE_ARGS + ["--tt-weights", weights])
    cfg = get_config("deepseek-7b", "full", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=16, length=3,
        min_factor=8, backend="auto", weights=weights))
    model = build(cfg, param_dtype=torch.bfloat16)
    params = model.init(args.seed)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params, args


def main_paths(smi: str) -> tuple[dict[str, int], list[dict]]:
    """Phase 5: every main path with fp then int8 cores, each decoding
    through its captured graph; returns each kernel's launches over its
    path's call, and per path the graph against an eager warm run (made
    before the capture, so that each has its own peak memory) and the
    trace of one more warm run of the graph, after the launches were
    read."""
    per_pass = PROJ * LAYERS
    launches, recs = {}, []
    for weights in ("fp32", "int8"):
        sfx = "_int8" if weights == "int8" else ""
        cli = {b: SERVE_ARGS + ["--tt-backend", b, "--tt-weights", weights]
               for b in ("auto", "cuda_step")}
        paths = (
            ("length 2, auto", "tt_fused2", per_pass,
             lambda: cli_model(cli["auto"])),
            ("length 3, auto", "tt_fused_chain", per_pass,
             lambda: length3_model(weights)),
            ("length 2, cuda_step", "tt_step", 2 * per_pass,
             lambda: cli_model(cli["cuda_step"])),
        )
        for label, kernel, n, built in paths:
            model, params, args = built()
            label = f"{label}, {weights}"
            eager = eager_runs(model, params, args)
            out, launches[kernel + sfx] = drive(label, kernel + sfx, n,
                                                model, params, args)
            rec = dict(path=label, kernel=kernel + sfx,
                       launches=launches[kernel + sfx], card=smi)
            rec.update(graph_against_eager(label, model, params, args, out,
                                           eager, smi))
            rec.update(traced(label, kernel + sfx, n, model, params, args))
            recs.append(rec)
            # the model and its graphs refer to each other
            del model, params, out
            gc.collect()
            torch.cuda.empty_cache()
    return launches, recs


def staggered_full(model, params, graph: bool) -> tuple[dict, dict]:
    """The step-indexed staggered run at full width: ``STAGGER_N`` requests
    with prompt lengths and budgets drawn by numpy from seed 0 through a
    4-slot pool over prompt + steps positions; four are submitted before
    the first ``step()``, then one before every third.  ({uid: finished},
    the scheduler's stats with the wall seconds)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(STAGGER_LENS[0], STAGGER_LENS[1] + 1, STAGGER_N)
    budgets = rng.integers(STAGGER_BUDGETS[0], STAGGER_BUDGETS[1] + 1,
                           STAGGER_N)
    prompts = [torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, n),
                                             dtype=np.int64)) for n in lens]
    sched = Scheduler(model, params, num_slots=4, cache_len=64 + PASSES,
                      graph=graph)

    def submit(i):
        sched.submit(Request(uid=i, inputs={"tokens": prompts[i]},
                             max_new_tokens=int(budgets[i])))

    t0 = time.perf_counter()
    for i in range(4):
        submit(i)
    nxt, k = 4, 0
    while nxt < STAGGER_N or not sched.idle:
        if nxt < STAGGER_N and k and k % 3 == 0:
            submit(nxt)
            nxt += 1
        sched.step()
        k += 1
    torch.cuda.synchronize()
    stats = dict(sched.stats(), wall_s=time.perf_counter() - t0)
    return {f.uid: f for f in sched.finished}, stats


def scheduler_path(smi: str) -> tuple[int, dict]:
    """Phase 5, continuous batching: full-width deepseek-7b at length 2
    ``auto`` (fp cores, bf16 params) built from the serve flags, on one
    slot-pool graph of 4 slots × 96 positions, admissions bucketed (the
    default) and each a replay of the captured prefill of its bucket.  The
    arrival mode through ``launch.serve.simulate`` (launch counts set to 0
    just before, read just after): 0 captures of either kind and 0 plan
    resolutions in the steady state, and ``tt_fused2`` launched 210 times
    per admission prefill plus 210 per decode step, all replayed (none
    counted).  Then the step-indexed staggered run (prompts of 16 to 64
    tokens) through the graphs and eagerly (``graph=False``), both
    bucketed: every token and logprob bit for bit, one prefill capture per
    bucket met that the arrival run had not met, no decode capture.  Then
    each bucket's prefill replays traced alone, and a trace of one more
    arrival run (``launch.profile_serve.profile_arrivals``): device busy
    share, admissions' share of the wall, the per-row ``torch.where`` KV
    writes.  Returns ``tt_fused2``'s launches over the ``simulate`` call
    and the record."""
    per_pass = PROJ * LAYERS
    args = serve.parse_args(ARRIVAL_ARGS)
    model, params = serve.setup(args)
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    out = serve.simulate(model, params, args)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches = counted.get("tt_fused2", 0) + replayed.get("tt_fused2", 0)
    T = 64 + PASSES
    graph = model.decode_graphs[(4, T, True)]
    prefill = model.prefill_graphs[(1, 64, T)]
    fin = out["finished"]
    print(f"main path (continuous batching, arrival mode; {smi}): "
          f"{len(fin)} requests, {out['tokens_out']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tok_per_s']:.1f} tok/s; ttft "
          f"p50/p95 {out['ttft_p50_s'] * 1e3:.1f}/"
          f"{out['ttft_p95_s'] * 1e3:.1f} ms; inter-token p50/p95 "
          f"{out['itl_p50_s'] * 1e3:.2f}/{out['itl_p95_s'] * 1e3:.2f} ms; "
          f"latency p50/p95 {out['p50_s'] * 1e3:.1f}/"
          f"{out['p95_s'] * 1e3:.1f} ms; {out['admissions']} admissions "
          f"({out['admit_share']:.1%} of the wall), {out['steps_run']} "
          f"decode steps; pool {out['kv_pool_bytes'] / 2**20:.1f} MiB, peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB allocated; launches over the "
          f"call counted {counted}, replayed {replayed} (one capture of the "
          f"decode step: {graph.captured}, of the prefill: "
          f"{prefill.captured}); prefill graphs {list(model.prefill_graphs)}",
          flush=True)
    want = {
        "steady launches": ({"tt_fused2": per_pass * (
            out["admissions"] + out["steps_run"])}, out["launches"]),
        "steady counted": ({}, out["counted"]),
        "steady replayed": ({"tt_fused2": per_pass * (
            out["admissions"] + out["steps_run"])}, out["replayed"]),
        "decode capture": ({"tt_fused2": per_pass}, graph.captured),
        "prefill capture": ({"tt_fused2": per_pass}, prefill.captured),
        "steady captures, prefill captures, plans": ((0, 0, 0), (
            out["captures"], out["prefill_captures"], out["replans"])),
        "captures, prefill captures of the model": (
            (1, 1), (model.graph_captures, model.prefill_builds)),
        "prefill graphs": ([(1, 64, T)], list(model.prefill_graphs)),
        "requests": (list(range(16)), sorted(f.uid for f in fin)),
        "admissions": (16, out["admissions"]),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad or any(len(f.tokens) != PASSES or f.finish_reason != "length" or
                  int(f.tokens.min()) < 0 or int(f.tokens.max()) >= 102400
                  or not np.isfinite(f.logprobs).all() for f in fin):
        raise AssertionError(f"continuous batching: (expected, got) {bad}")
    rec = {k: v for k, v in out.items() if k != "finished"}
    rec.update(card=smi, launches_total=launches,
               latency_s=[f.finish_time - f.submit_time for f in fin])

    builds = model.prefill_builds
    g_done, g_stats = staggered_full(model, params, graph=True)
    captured = model.prefill_builds - builds
    e_done, e_stats = staggered_full(model, params, graph=False)
    same = sorted(g_done) == sorted(e_done) == list(range(STAGGER_N)) and all(
        np.array_equal(g_done[u].tokens, e_done[u].tokens) and
        np.array_equal(g_done[u].logprobs, e_done[u].logprobs)
        for u in g_done)
    met = sorted({bucket_length(f.prompt_len, T) for f in g_done.values()})
    graphs = sorted(S for _, S, _ in model.prefill_graphs)
    print(f"staggered run ({STAGGER_N} requests, {g_stats['admissions']} "
          f"admissions, {g_stats['steps_run']} steps; {smi}): graph "
          f"{g_stats['wall_s']:.3f} s ({g_stats['tokens_out']} tokens) vs "
          f"eager {e_stats['wall_s']:.3f} s; tokens and logprobs "
          f"{'bit-identical' if same else 'DIFFER'}; buckets met {met}, "
          f"prefill graphs {graphs} ({captured} captured in the run); decode "
          f"captures {model.graph_captures}", flush=True)
    if not same or model.graph_captures != 1 or \
            g_stats["steps_run"] != e_stats["steps_run"] or \
            graphs != sorted(set(met) | {64}) or \
            captured != len(set(met) - {64}):
        raise AssertionError(f"staggered run: graph and eager differ ({same})"
                             f", {model.graph_captures} decode captures, "
                             f"prefill graphs {graphs} for buckets {met}, "
                             f"{captured} captured")
    rec.update(stagger_graph=g_stats, stagger_eager=e_stats,
               stagger_buckets=met, stagger_prefill_captures=captured)

    # each bucket's prefill: a 1-row prompt of the bucket's length
    rng = np.random.default_rng(1)
    buckets = {}
    for S in met:
        tokens = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (1, S), dtype=np.int64)).cuda()
        buckets[S] = prefill_replays(model, params, tokens, S, T,
                                     "tt_fused2_kernel")
        print(f"prefill bucket {S} (1 row, cache {T}; {smi}): "
              f"{pre_line(buckets[S], 'tt_fused2_kernel')}", flush=True)
        if buckets[S]["tt"] != per_pass:
            raise AssertionError(f"prefill bucket {S}: {buckets[S]['tt']} "
                                 f"tt_fused2_kernel per replay")
    rec.update(prefill_buckets=buckets)

    print("profile (continuous batching, arrival mode):", flush=True)
    prof = profile_serve.profile_arrivals(model, params, args)
    tt = prof["tt_kernels"].get("tt_fused2_kernel",
                                {"found": 0, "expected": None})
    rec.update(traced=dict(
        wall_s=prof["wall_s"], busy_s=prof["busy_s"],
        busy_share=prof["busy_s"] / prof["wall_s"],
        admit_share=prof["admit_share"], where_s=prof["where_s"],
        where_count=prof["where_count"], steps_run=prof["steps_run"],
        admissions=prof["admissions"], tt=tt))
    print(f"profile (continuous batching; {smi}): device busy "
          f"{prof['busy_s'] / prof['wall_s']:.1%} of {prof['wall_s']:.3f} s; "
          f"admissions {prof['admit_share']:.1%} of the wall; per-row KV "
          f"writes {prof['where_count']} kernels ({2 * LAYERS} per step "
          f"expected: {2 * LAYERS * prof['steps_run']}), "
          f"{prof['where_s'] * 1e3:.3f} ms; tt_fused2_kernel {tt}",
          flush=True)
    if tt["found"] != tt["expected"] or model.graph_captures != 1 or \
            prof["prefill_captures"] or prof["counted"]:
        raise AssertionError(f"traced arrival run: {tt} tt_fused2_kernel, "
                             f"{model.graph_captures} decode captures, "
                             f"{prof['prefill_captures']} prefill captures, "
                             f"counted {prof['counted']}")
    del model, params, graph
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def kernel_line(recs, launches) -> dict:
    """One entry per kernel: one decoder layer's launches of it (7
    projections, summed) at the decode batch in bf16, the main path's
    dominant case, at the length of its main path (fused chain: 3; fused2
    and step: 2); errors are the worst over every compared case."""
    spec = hw.device_spec(torch.device("cuda"))
    out = []
    for kernel, (source, line) in KERNELS.items():
        length = 3 if kernel.startswith("tt_fused_chain") else 2
        mine = [r for r in recs if r["kernel"] == kernel]
        main = [r for r in mine if r["rows"] == 4 and r["act"] == "bfloat16"
                and r["length"] == length]
        keys = ["ms", "eager_ms", "plain_ms", "library_ms", "bytes", "flops"]
        if all("cold_ms" in r for r in main):
            keys.append("cold_ms")
        tot = {k: sum(r[k] * r["per_layer"] for r in main) for k in keys}
        bound_s, bound_by = hw.bound_seconds(tot["bytes"], tot["flops"],
                                             "bfloat16", spec)
        out.append(dict(
            name=kernel, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"{TT_FILE}:{line}", launches=launches[kernel],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound_s * 1e3,
            bound_by=bound_by, library_ms=tot["library_ms"],
            eager_ms=tot["eager_ms"],
            **({"cold_ms": tot["cold_ms"]} if "cold_ms" in tot else {}),
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

    t_start = t0 = time.perf_counter()
    lib, log = tt_contract.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s -> "
          f"{os.path.relpath(lib, ROOT)}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = check_and_time(gen)
    layers = layer_summary(recs)
    steps = step_breakdown(recs)
    recs += check_buckets(gen)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "records": recs, "layers": layers,
                   "steps": steps}, f, indent=1)
    small_input_check()
    small_scheduler_check()
    launches, graph_recs = main_paths(smi)
    fused2, sched_rec = scheduler_path(smi)
    launches["tt_fused2"] += fused2
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "records": recs, "layers": layers,
                   "steps": steps, "graph": graph_recs,
                   "scheduler": sched_rec}, f, indent=1)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f}s",
          flush=True)

    print(json.dumps(kernel_line(recs, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
