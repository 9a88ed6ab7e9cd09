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
     length-3 shapes, the step kernel on every step of both; and fused2
     (fp and int8 cores) at gemma3-4b's five projection shapes, at 256 and
     4 rows and untimed at 1,024 (``gemma3_kernels``, timed as in 3); and
     at mixtral-8x7b's shapes (``mixtral_kernels``): the expert-batched
     fused2 (``tt_fused2_experts[_int8]``, one launch across 8 experts) at
     its three expert projections, at C = 640, 128 and 8 rows an expert
     and untimed at 20 and 1, and fused2 at the k/v projection at 2,048 and
     4 rows, timed as in 3 (the library call of the expert kernel is one
     ``torch.bmm`` over the dense expert stacks); at deepseek-v2-lite-16b's
     (``dsv2_kernels``): fused2 at its six plain shapes (q, o, the shared
     experts, the dense first layer's ragged 1,368 modes) at 256 and 4
     rows, and the expert kernel across 64 experts at C = 256, 128 and 8,
     untimed at 1 and 20; fused2 at qwen3-32b's five shapes at 256 and
     4 rows (``qwen3_kernels``); and fused2 at mamba2-2.7b's in_proj (m1
     = 1,322: P1 rows 16-byte aligned in no dtype) and out_proj at 4, 256
     and 4,096 rows (``mamba2_kernels``); and at jamba-v0.1-52b's, bf16
     activations only (``jamba_kernels``): fused2 at its SSD in_proj (m1
     = 2,068) and out_proj at 4, 256 and 4,096 rows, and the expert kernel
     across 16 experts at C = 640, 128 and 8; and at seamless-m4t-large-v2's
     three shapes (q/k/v/o of self- and cross-attention 1,024 → 1,024,
     gate/up, down), bf16 activations, at 4, 256 and 4,096 rows
     (``seamless_kernels``); and at internvl2-2b's four shapes (q/o, k/v,
     gate/up, down), bf16 activations, at 4, 256 and 8,192 rows
     (``internvl2_kernels``);
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
     lengths 2 and 3 with fp32 cores and at length 2 with int8 cores; and
     the paged scheduler (block 4) on that schedule and on a shared-prefix
     pair followed by a resubmitted prompt (full coverage, a copy on
     write), card (the paged slot-pool graph, the captured resume) against
     CPU at lengths 2 and 3: tokens, logprobs, block ids per slot after
     every step, prefix counters, no leaked block; and the chunked-prefill
     scheduler (chunks of 4 over 2 lanes, a prefix hit and a full cover),
     dense and paged, card (the mixed step captured per (lanes, chunk))
     against CPU on all six kernel paths: tokens, logprobs, slots, prompt
     positions and block ids after every step, counters, launches; and
     gemma3 SMOKE (window 16) on the card against the CPU, fp32 and int8
     cores: the fixed batch at prompts of 24 and 40 through the captured
     prefill and decode, and the dense, paged and chunked (chunks of 8
     and of 24) schedulers through the graphs, drop counts included, and
     the same for mixtral SMOKE (window 32, 4 experts top-2), also eagerly
     (``small_ring_check``), and for deepseek-v2-lite SMOKE (MLA, a dense
     first layer, 4 experts top-2 with a shared one), with its paged
     shared-prefix pair and full cover (resumes, a copy on write) card
     against CPU, prefix counters and drops (0) included
     (``small_prefix_check``); and mamba2 SMOKE (2 SSD blocks) through
     ``small_ring_check`` with ``SSM_MODES``: the fixed batch, and the
     dense, paged (no arena) and chunked schedulers at chunks of 1, 5 and
     40, both pools; and jamba SMOKE (3 SSD blocks and a GQA block, MLPs
     and 4 experts top-2) the same way, its paged pool mixing the GQA
     block's arenas with the SSD blocks' slot state; and seamless SMOKE (2
     non-causal encoder blocks, 2 cross-attending decoder blocks, 12
     speech frames a prompt) the same way over the dense and paged pools,
     chunked prefill refused; and internvl2 SMOKE (2 GQA blocks, image
     embeddings of width 32 projected and prepended to every prompt, 3 to
     16 rows) the same way, chunked prefill refused;
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
     auto, fp cores, at ``CUT_LAYERS`` layers, on one slot-pool graph of 4
     slots × 96 positions, each
     admission a replay of its bucket's captured prefill: the arrival mode
     through ``launch.serve.simulate`` (16 requests at 50/s; 0 captures of
     either kind and 0 plan resolutions in the steady state, ``tt_fused2``
     replayed 70 times per admission and per decode step), a
     step-indexed staggered run of 12 requests (prompts of 16 to 64
     tokens) through the graphs and eagerly (bit-identical; one prefill
     capture per new bucket), each bucket's prefill replays traced alone
     (busy ms and host-clock ms against the eager prefill's), and a traced
     arrival run (``launch.profile_serve.profile_arrivals``: device busy
     share, the admissions' share of the wall, the per-row KV writes);
     then chunked prefill on that model: the arrival mode with
     ``--chunk-prefill`` (chunks of 64, one lane) over the dense and the
     paged pool beside the monolithic runs (0 captures and plan
     resolutions steady, 16 chunks, ``tt_fused2`` replayed 140 times per
     mixed step and 70 per plain step), the staggered run at chunks of 16
     over 2 lanes, both pools, graph and eager (bit-identical; held
     against ``generate_fixed`` by ``serve.check_greedy``), serve's prefix
     smoke chunked, and the mixed replays traced alone; then full-width
     gemma3-4b (``gemma3_path``: bf16, TT on ffn+attn at rank 16, tied
     lm_head, 238 ``tt_fused2`` a pass): 4 × 1,152 + 64 tokens through
     ``launch.serve.fixed`` with fp and int8 cores beside an eager warm
     run (bit for bit), Poisson arrivals of 16 requests of 960 + 128
     tokens on 4 slots, and a staggered run of 12 requests (prompts of
     600–1,000), dense, paged and chunked, graph against eager and paged
     against dense bit for bit, held against ``generate_fixed``; then
     full-width mixtral-8x7b (``moe_path``: bf16, TT on ffn+attn at
     rank 16, per pass 128 ``tt_fused2`` and 96 ``tt_fused2_experts``):
     4 × (512 + 64) tokens through ``launch.serve.fixed`` with fp and int8
     cores beside an eager warm run (bit for bit), the decode replay, the
     prefill replay (busy ms and the expert kernel's share) and one MoE
     layer traced alone, Poisson arrivals of 16 requests of 256 +
     64 tokens on 4 slots over the dense, paged and chunked pools, and a
     staggered run of 12 requests (prompts of 64–256): dense graph ≡ eager
     ≡ paged and chunked graph ≡ eager ≡ paged bit for bit, chunked ≡
     monolithic and each request ≡ ``generate_fixed`` where neither side
     dropped an assignment, every path's MoE drops printed; then the same
     for full-width deepseek-v2-lite-16b (``moe_path``; per pass 135
     ``tt_fused2`` and 78 ``tt_fused2_experts`` across 64 experts), with
     one layer's MLA decode attention traced alone and serve's prefix
     smoke on the paged pool (hits, skipped prefill tokens, drops); then
     full-width qwen3-32b (``qwen3_path``: 448 ``tt_fused2`` a pass), 4 ×
     (256 + 32) through ``launch.serve.fixed``, fp and int8 cores, beside
     an eager warm run (bit for bit); then full-width mamba2-2.7b
     (``mamba2_path``: TT on ffn, 128 ``tt_fused2`` a pass), 4 × (1,024 +
     64) through ``launch.serve.fixed`` with fp and int8 cores beside an
     eager warm run (bit for bit, the fp32 state included), the decode
     replay, the prefill replay and one SSD mixer (plain and masked)
     traced alone, and at ``MAMBA2_CUT_LAYERS`` layers a staggered run of
     6 requests (prompts of 256–1,024), dense, paged and chunked at 64:
     dense graph ≡ eager ≡
     paged and chunked graph ≡ eager ≡ paged bit for bit, the chunked
     run against ``generate_fixed`` measured; then the dense and chunked
     runs again with the weights in fp32 and the scan in fp64, each
     request held against ``generate_fixed`` within 1e-4; and, between
     deepseek-v2-lite-16b and qwen3-32b,
     full-width jamba-v0.1-52b (``moe_path``: per pass 120 ``tt_fused2``
     and 48 ``tt_fused2_experts`` across 16 experts), 4 × (1,024 + 64)
     with fp and int8 cores as mixtral, one SSD mixer traced alone beside
     the MoE layer, no arrival run, and the staggered run with the prefix
     counters 0 and each request against ``generate_fixed`` measured, then
     its dense and chunked runs again in fp32 with the scan in fp64 and
     the experts dropless (``fp64_scan_witness``), every request held
     against ``generate_fixed`` within 1e-4; and
     full-width seamless-m4t-large-v2 (``seamless_path``: 216
     ``tt_fused2`` a decode pass, 432 a prefill pass), 4 × (1,024 + 64)
     with 1,024 speech frames a row through ``fixed_family`` (as qwen3-32b
     and mamba2-2.7b: fp and int8 cores, an eager warm run beside the fp
     one, the decode and prefill replays traced alone) with the encoder
     traced alone, and at ``SEAMLESS_CUT_LAYERS`` encoder and decoder
     layers the staggered run of 12 requests (256
     frames each), dense and paged, graph and eager (``staggered_block``):
     bit for bit, the prefix counters 0, every request held against
     ``generate_fixed`` (asserted); and, last, full-width internvl2-2b
     (``internvl2_path``: 168 ``tt_fused2`` a decode and a prefill pass),
     4 × (1,024 image embeddings + 1,024 tokens + 64) through
     ``fixed_family`` with the image prefix's share of the prefill replay
     (``image_prefix``: the projector alone, and a prefill of one image
     row and 2,047 tokens), and at ``INTERNVL2_CUT_LAYERS`` layers the
     staggered run with 64 and 128 image rows by turns, dense and paged,
     graph and eager: bit for bit, the prefix counters 0, every request
     held against ``generate_fixed`` (asserted).
     deepseek-7b's length-3 and ``cuda_step`` fixed-batch paths and its
     continuous-batching paths run at ``CUT_LAYERS`` of its 30 layers;
     mixtral-8x7b's, deepseek-v2-lite-16b's and jamba-v0.1-52b's
     continuous-batching paths at ``MOE_CUT_LAYERS``, gemma3-4b's at
     ``GEMMA3_CUT_LAYERS``.
Every fixed batch compares the greedy picks of 16 decode steps, graph
against eager (``graph_against_eager``); beside it an eager warm run
(eager tok/s and peak memory, its tokens against the graph's warm run)
is made on deepseek-7b's paths with fp and int8 cores and on the other
families' with fp cores only: their int8 eager warm runs would add a
minute of host-bound steps to the script's wall.
Kernel, plain and library times are device times of 50 calls enqueued
while a spin kernel holds the stream (no host time between the calls),
after two seconds of dense products have brought the card's clocks up;
the eager back-to-back time of each kernel is recorded beside them.  Every
record of phases 2, 3 and 5 is also written to ``build/chip_smoke.json``;
the kernel line's ``tt_fused2`` launches are those of the fixed-batch
calls, the dense arrival-mode call, the paged runs and the chunked runs
together, gemma3-4b's, mixtral-8x7b's, deepseek-v2-lite-16b's,
jamba-v0.1-52b's, qwen3-32b's, mamba2-2.7b's, seamless-m4t-large-v2's
and internvl2-2b's included (``tt_fused2_int8``: their int8 fixed batches too; the expert kernels:
mixtral's, deepseek-v2's and jamba's); its times are
deepseek-7b's layer, and for the expert-batched kernels mixtral-8x7b's (3
expert projections, 8 experts × 8 rows).
The last three lines are ``{"kernels": [...]}``, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device":
{...}}``.  Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.models import moe  # noqa: E402
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
# a family's prefill replays traced alone: each is 100–500 ms of device
# time, so two give its mean, and a trace's host cost grows with its
# kernels (eight took ~5 s of the script's wall each)
PREFILL_REPLAYS = 2
# decode steps of the cold eager run before each path's warm one (of
# ``--steps`` until mixtral-8x7b's phases joined the script)
COLD_STEPS = 4
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
    # the Pallas fused2 kernels under ``vmap`` over a MoE layer's experts
    "tt_fused2_experts": ("tt_fused2.cu", 287),
    "tt_fused2_experts_int8": ("tt_fused2.cu", 310),
}
SERVE_ARGS = ["--arch", "deepseek-7b", "--variant", "full", "--batch", "4",
              "--prompt-len", "64", "--steps", str(PASSES), "--tt",
              "ffn,attn", "--tt-rank", "16", "--seed", "0"]
# the arrival mode on the slot pool's graph (4 slots × 96 positions): 16
# requests at 50/s saturate the pool, so requests queue and slots are reused
ARRIVAL_ARGS = SERVE_ARGS + ["--tt-backend", "auto", "--slots", "4",
                             "--max-requests", "16", "--arrival-rate", "50",
                             "--assert-no-replan"]
# the step-indexed staggered run: requests, prompt lengths, budgets (of
# 8–32 until mixtral-8x7b's phases joined the script, cut to keep it near
# 750 s)
STAGGER_N, STAGGER_LENS, STAGGER_BUDGETS = 12, (16, 64), (8, 16)
# the paged pool of phase 5: blocks of 16 positions, 6 per slot, 24 + 1
# sentinel by default, 12 in the memory-limited run
PAGED_ARGS = ["--paged", "--block-size", "16"]
PAGED_BLOCK, SMALL_POOL = 16, 12
# the prefix-reuse check: prompts of 48 shared + 16 own tokens from seed
# 0.  No seed gives a top-1/top-2 gap over the bf16 tolerance here (bf16
# logits tie exactly: seeds 0-7 all have a gap of 0 within 32 steps), so
# serve's ``check_greedy`` holds each pick to the top logit within it
PREFIX_LEN, PREFIX_SEED = 48, 0
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# gemma3-4b (34 layers: 29 local with a window of 1,024, 5 global; tied
# embeddings of 262,144 × 2,560): its TT projections at rank 16, length 2,
# and how many of each one decoder layer runs (7 per layer, 238 a pass);
# timed at ROWS, checked untimed at the 1,024-row admission bucket
GEMMA3_SHAPES = {
    "gemma3 attn q 2560->2048": (((8, 320), (256, 8), (1, 16, 1)), 1),
    "gemma3 attn k/v 2560->1024": (((8, 320), (128, 8), (1, 16, 1)), 2),
    "gemma3 attn o 2048->2560": (((8, 256), (320, 8), (1, 16, 1)), 1),
    "gemma3 ffn gate/up 2560->10240": (((8, 320), (1280, 8), (1, 16, 1)),
                                       2),
    "gemma3 ffn down 10240->2560": (((8, 1280), (320, 8), (1, 16, 1)), 1),
}
GEMMA3_BUCKET_ROWS = (1024,)
GEMMA3_LAYERS = 34
# phase 5 at full width: a fixed batch of 4 prompts of 1,152 tokens (over
# the window: the prefill's rings keep the last 1,024 positions) and 64
# new tokens, cache 1,280; Poisson arrivals of 16 requests of 960 + 128
# tokens at 50/s on 4 slots × 1,088 (each admission pads 960 to the 1,024
# bucket; every ring wraps at 1,024); the staggered run of 12 requests,
# prompts of 600–1,000 tokens, budgets of 8–32 (of 32–128 the eager runs
# alone took 103 s; 16–64 until mixtral-8x7b's phases joined the script),
# on 4 × 1,152, dense, paged (blocks of 64) and chunked (chunks of 256
# over 2 lanes)
GEMMA3_ARGS = ["--arch", "gemma3-4b", "--variant", "full", "--tt",
               "ffn,attn", "--tt-rank", "16", "--seed", "0",
               "--tt-backend", "auto"]
GEMMA3_FIXED = ["--batch", "4", "--prompt-len", "1152", "--steps", "64"]
GEMMA3_ARRIVAL = ["--prompt-len", "960", "--steps", "128", "--slots", "4",
                  "--max-requests", "16", "--arrival-rate", "50",
                  "--assert-no-replan"]
GEMMA3_STAGGER, GEMMA3_T = ((600, 1000), (8, 32)), 1152
GEMMA3_BLOCK, GEMMA3_CHUNK = 64, dict(chunk_prefill=True, chunk_size=256,
                                      prefill_budget=512)
# phase 5's traffic that several families share, named by its shape: the
# fixed batch of 4 prompts of 1,024 tokens and 64 new ones (mamba2-2.7b,
# jamba-v0.1-52b, seamless-m4t-large-v2); the staggered run of 12
# requests, prompts of 64–256 tokens, budgets of 16–32, on 4 × 320
# (mixtral-8x7b, deepseek-v2-lite-16b, jamba-v0.1-52b,
# seamless-m4t-large-v2); the paged pools' blocks of 16 and the chunking
# at 64 of every full-width staggered run but gemma3-4b's
FIXED_1024 = ["--batch", "4", "--prompt-len", "1024", "--steps", "64"]
STAGGER_64_256, STAGGER_64_256_T = ((64, 256), (16, 32)), 320
STAGGER_BLOCK, STAGGER_CHUNK = 16, dict(chunk_prefill=True, chunk_size=64)
# mixtral-8x7b (32 layers of GQA with a window of 4,096, 8 KV heads; a
# mixture of 8 experts, top-2, expert_ff 14,336, capacity factor 1.25):
# its expert stacks' TT projections at rank 16, length 2 (one launch of
# ``tt_fused2_experts`` across the 8 experts each) and the one attention
# shape deepseek-7b does not have (k/v; q and o are deepseek's
# 4096→4096), with how many of each one decoder layer runs (3 expert
# launches and 4 attention ones: 224 a pass)
MIXTRAL_EXPERT_SHAPES = {
    "mixtral experts gate/up 4096->14336": (((8, 512), (1792, 8),
                                             (1, 16, 1)), 2),
    "mixtral experts down 14336->4096": (((8, 1792), (512, 8), (1, 16, 1)),
                                         1),
}
MIXTRAL_ATTN_SHAPES = {
    "mixtral attn k/v 4096->1024": (((8, 512), (128, 8), (1, 16, 1)), 2),
}
MIXTRAL_E, MIXTRAL_LAYERS = 8, 32
# rows an expert takes (the capacity C): the 4 × 512 prefill, an
# admission at the 256 bucket and decode, timed; a 64-token chunk and one
# row, checked untimed.  The attention shape at the prefill's and decode's
# rows
MIXTRAL_C, MIXTRAL_C_CHECKED, MIXTRAL_ROWS = (640, 128, 8), (20, 1), \
    (2048, 4)
# phase 5 at full width: the fixed batch of 4 prompts of 512 tokens and 64
# new ones (rings of 4,096 do not wrap here: gemma3's phase covers the
# wrap); Poisson arrivals of 16 requests of 256 + 64 tokens at 50/s on 4
# slots, over the dense pool, the paged one (blocks of 16) and chunked at
# 64 (one lane); the staggered run ``STAGGER_64_256``
MIXTRAL_ARGS = ["--arch", "mixtral-8x7b", "--variant", "full", "--tt",
                "ffn,attn", "--tt-rank", "16", "--seed", "0",
                "--tt-backend", "auto"]
MIXTRAL_FIXED = ["--batch", "4", "--prompt-len", "512", "--steps", "64"]
MIXTRAL_ARRIVAL = ["--prompt-len", "256", "--steps", "64", "--slots", "4",
                   "--max-requests", "16", "--arrival-rate", "50",
                   "--assert-no-replan"]
# deepseek-v2-lite-16b (27 layers of MLA: q/o through TT, kv_down/kv_up
# dense; layer 0 a dense GLU MLP of 10,944, layers 1–26 a mixture of 64
# experts, top-6, expert_ff 1,408, and 2 shared experts of 1,408): its TT
# projections at rank 16, length 2, with how many of each one pass runs
# (135 ``tt_fused2`` = 27 × 2 + 3 + 26 × 3, 78 ``tt_fused2_experts`` =
# 26 × 3).  dense0's m1 and n2 of 1,368 are the first modes on the card
# that are no multiple of 16
DSV2_SHAPES = {
    "dsv2 attn q 2048->3072": (((8, 256), (384, 8), (1, 16, 1)), 27),
    "dsv2 attn o 2048->2048": (((8, 256), (256, 8), (1, 16, 1)), 27),
    "dsv2 shared gate/up 2048->2816": (((8, 256), (352, 8), (1, 16, 1)),
                                       52),
    "dsv2 shared down 2816->2048": (((8, 352), (256, 8), (1, 16, 1)), 26),
    "dsv2 dense0 gate/up 2048->10944": (((8, 256), (1368, 8), (1, 16, 1)),
                                        2),
    "dsv2 dense0 down 10944->2048": (((8, 1368), (256, 8), (1, 16, 1)), 1),
}
DSV2_EXPERT_SHAPES = {
    "dsv2 experts gate/up 2048->1408": (((8, 256), (176, 8), (1, 16, 1)),
                                        52),
    "dsv2 experts down 1408->2048": (((8, 176), (256, 8), (1, 16, 1)), 26),
}
DSV2_E, DSV2_LAYERS, DSV2_MOE_LAYERS = 64, 27, 26
# rows an expert takes: the 4 × 512 prefill (C = 256), an admission at the
# 256 bucket (128) and decode (8; a 64-token chunk's too), timed; one row
# and 20, checked untimed
DSV2_C, DSV2_C_CHECKED = (256, 128, 8), (1, 20)
# phase 5 at full width: the fixed batch of 4 prompts of 512 tokens and 64
# new ones; Poisson arrivals of 16 requests of 256 + 64 tokens at 50/s on
# 4 slots over the dense pool, the paged one (blocks of 16) and chunked at
# 64 (one lane); serve's prefix smoke on the paged pool; the staggered run
# of 12 requests, prompts of 64–256 tokens, budgets of 16–32, on 4 × 320
DSV2_ARGS = ["--arch", "deepseek-v2-lite-16b", "--variant", "full", "--tt",
             "ffn,attn", "--tt-rank", "16", "--seed", "0", "--tt-backend",
             "auto"]
DSV2_PREFIX = ["--prefix-smoke", "--paged", "--block-size", "16",
               "--prefix-len", "48", "--steps", "32"]
# qwen3-32b (64 layers of GQA with qk-norm, 8 KV heads, d_ff 25,600): its
# five TT shapes at rank 16, length 2, 7 launches a layer (448 a pass);
# phase 5 serves 4 × (256 + 32), fp and int8 cores
QWEN3_SHAPES = {
    "qwen3 attn q 5120->8192": (((8, 640), (1024, 8), (1, 16, 1)), 1),
    "qwen3 attn k/v 5120->1024": (((8, 640), (128, 8), (1, 16, 1)), 2),
    "qwen3 attn o 8192->5120": (((8, 1024), (640, 8), (1, 16, 1)), 1),
    "qwen3 ffn gate/up 5120->25600": (((8, 640), (3200, 8), (1, 16, 1)),
                                      2),
    "qwen3 ffn down 25600->5120": (((8, 3200), (640, 8), (1, 16, 1)), 1),
}
QWEN3_LAYERS = 64
QWEN3_ARGS = ["--arch", "qwen3-32b", "--variant", "full", "--tt",
              "ffn,attn", "--tt-rank", "16", "--seed", "0", "--tt-backend",
              "auto", "--batch", "4", "--prompt-len", "256", "--steps", "32"]
# mamba2-2.7b (64 attention-free layers, each a Mamba-2 SSD mixer with no
# FFN; d_inner 5,120, 80 heads of 64, d_state 128, chunk 256): its two TT
# projections at rank 16, length 2, one launch each a layer (128 a pass);
# in_proj's m1 of 1,322 gives P1 rows 16-byte aligned in no dtype.  Timed
# at decode (4 rows), an admission (256) and the 4 × 1,024 prefill (4,096)
MAMBA2_SHAPES = {
    "mamba2 in_proj 2560->10576": (((8, 320), (1322, 8), (1, 16, 1)), 64),
    "mamba2 out_proj 5120->2560": (((8, 640), (320, 8), (1, 16, 1)), 64),
}
MAMBA2_ROWS, MAMBA2_LAYERS = (4, 256, 4096), 64
# phase 5 at full width: the fixed batch of 4 prompts of 1,024 tokens (4
# chunks of 256: the inter-chunk scan runs) and 64 new ones; the staggered
# run of 6 requests, prompts of 256–1,024 tokens, budgets of 8–16, on 4 ×
# 1,040, dense, paged (blocks of 16, no arena) and chunked at 64 (of 8
# requests the phase took 176.3 s); the dense and chunked runs again with
# the weights in fp32 and the scan in fp64
MAMBA2_ARGS = ["--arch", "mamba2-2.7b", "--variant", "full", "--tt", "ffn",
               "--tt-rank", "16", "--seed", "0", "--tt-backend", "auto"]
MAMBA2_STAGGER, MAMBA2_T, MAMBA2_N = ((256, 1024), (8, 16)), 1040, 6
# jamba-v0.1-52b (32 layers in 4 periods of 8: Mamba-2 SSD blocks at 0–3
# and 5–7, d_inner 8,192, 128 heads of 64, d_state 16; GQA with 8 KV heads
# at 4; a mixture of 16 experts, top-2, expert_ff 14,336, at 1, 3, 5 and 7,
# a GLU MLP of 14,336 elsewhere): its two new TT shapes at rank 16, length
# 2, and its 16-expert stacks at mixtral's expert shapes, with how many of
# each one pass runs (120 ``tt_fused2`` = 28 SSD blocks × 2 + 4 GQA blocks
# × 4 + 16 MLPs × 3; 48 ``tt_fused2_experts`` = 16 MoE layers × 3).
# in_proj's m1 of 2,068 gives P1 rows 16-byte aligned in fp32 only.  Timed
# with bf16 activations, fp and int8 cores: in/out proj at decode (4 rows),
# an admission (256) and the 4 × 1,024 prefill (4,096); the experts at C =
# 640 (that prefill: ceil(2 · 4,096 / 16 · 1.25)), 128 (an admission at
# the 256 bucket) and 8 (decode)
JAMBA_SHAPES = {
    "jamba in_proj 4096->16544": (((8, 512), (2068, 8), (1, 16, 1)), 28),
    "jamba out_proj 8192->4096": (((8, 1024), (512, 8), (1, 16, 1)), 28),
}
JAMBA_EXPERT_SHAPES = {
    "jamba experts gate/up 4096->14336": (((8, 512), (1792, 8), (1, 16, 1)),
                                          32),
    "jamba experts down 14336->4096": (((8, 1792), (512, 8), (1, 16, 1)),
                                       16),
}
JAMBA_E, JAMBA_LAYERS, JAMBA_MOE_LAYERS, JAMBA_SSM_LAYERS = 16, 32, 16, 28
JAMBA_ROWS, JAMBA_C = (4, 256, 4096), (640, 128, 8)
BF16_CASES = ((False, torch.bfloat16), (True, torch.bfloat16))
# phase 5 at full width: the fixed batch of 4 prompts of 1,024 tokens (4
# SSD chunks of 256 a prompt: the inter-chunk scan runs; C = 640) and 64
# new ones; at one period the staggered run of mixtral's traffic, dense,
# paged (blocks of 16: the GQA layer's arenas beside the SSD layers' slot
# state) and chunked at 64.  No arrival run: the staggered run drives the
# mixed pool
JAMBA_ARGS = ["--arch", "jamba-v0.1-52b", "--variant", "full", "--tt",
              "ffn,attn", "--tt-rank", "16", "--seed", "0", "--tt-backend",
              "auto"]
# seamless-m4t-large-v2 (24 non-causal encoder layers over frames of width
# 1,024, 24 decoder layers that cross-attend to them; d 1,024, 16 heads of
# 64, d_ff 8,192, vocab 256,206): its three TT shapes at rank 16, length
# 2 (self- and cross-attention q/k/v/o, gate/up, down), with how many of
# each a decode pass runs (24 × 9 = 216 ``tt_fused2``: the cross keys and
# values are the prefill's) and a prefill pass (the encoder's 24 × 7, the
# decoder's 24 × 11: 432).  Timed with bf16 activations, fp and int8
# cores, at decode (4 rows, a decode pass's launches) and at an admission
# (256) and one encoder pass of 4 × 1,024 frames (4,096; a prefill
# pass's)
SEAMLESS_DIMS = {
    "seamless attn q/k/v/o 1024->1024": (((8, 128), (128, 8), (1, 16, 1)),
                                         (24 * 6, 24 * 4 + 24 * 8)),
    "seamless ffn gate/up 1024->8192": (((8, 128), (1024, 8), (1, 16, 1)),
                                        (2 * 24, 2 * 48)),
    "seamless ffn down 8192->1024": (((8, 1024), (128, 8), (1, 16, 1)),
                                     (24, 48)),
}
SEAMLESS_ROWS, SEAMLESS_LAYERS = ((4,), (256, 4096)), 24
SEAMLESS_PER_PASS = {"tt_fused2": 9 * SEAMLESS_LAYERS}
SEAMLESS_PREFILL_PER_PASS = {"tt_fused2": (7 + 11) * SEAMLESS_LAYERS}
# phase 5 at full width: the fixed batch of 4 prompts of 1,024 tokens with
# 1,024 frames each (F = the prompt length, as the reference CLI draws
# them) and 64 new tokens; at ``SEAMLESS_CUT_LAYERS`` encoder and as
# many decoder layers the staggered run ``STAGGER_64_256``, 256 frames a
# request, dense and paged, graph and eager
SEAMLESS_ARGS = ["--arch", "seamless-m4t-large-v2", "--variant", "full",
                 "--tt", "ffn,attn", "--tt-rank", "16", "--seed", "0",
                 "--tt-backend", "auto"]
SEAMLESS_FRAMES, SEAMLESS_CUT_LAYERS = 256, 8
# internvl2-2b (24 layers of GQA with 8 KV heads, d 2,048, d_ff 8,192,
# vocab 92,553; the dense projector of image embeddings of width 1,024,
# prepended to the prompt): its four TT shapes at rank 16, length 2, with
# how many of each a pass runs (7 a layer, 168 a pass, decode and prefill
# alike: the image rows are plain rows of the decoder).  Timed with bf16
# activations, fp and int8 cores, at decode (4 rows), an admission (256)
# and the prefill of 4 × 2,048 rows (8,192)
INTERNVL2_SHAPES = {
    "internvl2 attn q/o 2048->2048": (((8, 256), (256, 8), (1, 16, 1)), 48),
    "internvl2 attn k/v 2048->1024": (((8, 256), (128, 8), (1, 16, 1)), 48),
    "internvl2 ffn gate/up 2048->8192": (((8, 256), (1024, 8), (1, 16, 1)),
                                         48),
    "internvl2 ffn down 8192->2048": (((8, 1024), (256, 8), (1, 16, 1)),
                                      24),
}
INTERNVL2_ROWS, INTERNVL2_LAYERS = (4, 256, 8192), 24
# phase 5 at full width: the fixed batch of 4 prompts of 2,048 rows, 1,024
# image embeddings and 1,024 tokens each (the reference CLI's split), and
# 64 new tokens; at ``INTERNVL2_CUT_LAYERS`` layers the staggered run
# ``STAGGER_64_256`` with 64 and 128 image rows by turns (the captured
# prefills' key carries the count), on 4 × 416 (128 + 256 + 32), dense and
# paged, graph and eager
INTERNVL2_ARGS = ["--arch", "internvl2-2b", "--variant", "full", "--tt",
                  "ffn,attn", "--tt-rank", "16", "--seed", "0",
                  "--tt-backend", "auto"]
INTERNVL2_FIXED = ["--batch", "4", "--prompt-len", "2048", "--steps", "64"]
INTERNVL2_IMAGES, INTERNVL2_T, INTERNVL2_CUT_LAYERS = (64, 128), 416, 8
# deepseek-7b's length-3 and ``cuda_step`` fixed-batch paths and its
# continuous-batching paths (dense, paged, chunked) run at this depth (of
# 30), to keep the script within its time on a slower host with the two
# families above (806.7 s on one host, 1,055.0 on another, before the
# continuous-batching paths were cut)
CUT_LAYERS = 10
# mixtral-8x7b's and deepseek-v2-lite-16b's continuous-batching paths
# (arrivals, prefix smoke, staggered runs) run at this depth (of 32 and
# 27), to keep the script within its time with mamba2-2.7b's phases (the
# whole script took 860.1 s before they joined; the two families' phase 5
# 175.4 and 175.8 s, most of it in their eager staggered runs)
MOE_CUT_LAYERS = 8
# gemma3-4b's continuous-batching paths (arrivals, staggered runs) run at
# this depth (of 34): one period of five local layers and a global one
# (the script took 980.0 s on a slow host before, gemma3's phase 5 147.4 s)
GEMMA3_CUT_LAYERS = 6
# mamba2-2.7b's staggered runs (bf16: dense, paged, chunked; the fp32
# witness) run at this depth (of 64; its fixed batch at full depth), to
# keep the script within its time with internvl2-2b's phases (the whole
# script took 886.3 s before they joined, mamba2's phase 5 130.9 s of it)
MAMBA2_CUT_LAYERS = 16


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
    moved = (x.numel() + rows * chain_state_sizes(ns, ms, ranks)[-1]) * \
        x.element_size() + weight_bytes
    return (kernel + ("_int8" if int8 else ""), run, plain, library, moved,
            2 * rows * chain_macs(dims), x, cores, scales)


def chain_macs(dims) -> int:
    """Multiply-adds of one row through the TT chain ``dims``."""
    ns, ms, ranks = dims
    sizes = chain_state_sizes(ns, ms, ranks)
    return sum(sizes[j] * ms[t] * ranks[t] for j, t in
               enumerate(range(len(ns) - 1, -1, -1)))


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
            moved, flops, tol, spec, flush=None, plain_iters: int = 50
            ) -> dict:
    """Compare one kernel call with its plain version (``check``), then
    time kernel, plain and library, and with ``flush`` the kernel with L2
    evicted before each call.  ``plain_iters`` calls of a plain version
    that launches many kernels keep the device's launch queue from filling
    behind the spin kernel (which would block the host)."""
    rec = check(kernel, label, rows, act, run, plain, tol)
    bound_s, bound_by = hw.bound_seconds(moved, flops, DT_NAME[act], spec)
    rec.update(per_layer=per_layer, eager_ms=cuda_ms(run), ms=device_ms(run),
               plain_ms=device_ms(plain, plain_iters),
               library_ms=device_ms(library),
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


def layer_summary(recs, kernels=("tt_fused2", "tt_fused2_int8",
                                  "tt_fused_chain", "tt_fused_chain_int8"),
                  model: str = "deepseek-7b", rows_of=ROWS,
                  per: str = "layer") -> list[dict]:
    """Each whole-layer kernel's times summed over one decoder layer's
    projections (bf16 activations) of ``model`` (``per="pass"``: over one
    pass, where the records count the launches of a pass), per row count
    of ``rows_of``: device, cold-L2, eager (back-to-back calls, the host's
    time where it is longer), plain, the library call and the bound."""
    out = []
    for kernel in kernels:
        for rows in rows_of:
            rs = [r for r in recs if r["kernel"] == kernel and
                  r["rows"] == rows and r["act"] == "bfloat16" and
                  r.get("model", "deepseek-7b") == model]
            row = dict(kernel=kernel, rows=rows, model=model, per=per)
            for key in ("ms", "cold_ms", "eager_ms", "plain_ms",
                        "library_ms", "bound_ms"):
                row[key] = sum(r[key] * r["per_layer"] for r in rs)
            out.append(row)
            print(f"{model} {kernel:19s} rows={rows:3d} per {per}: device "
                  f"{row['ms']:.4f} cold-L2 {row['cold_ms']:.4f} eager "
                  f"{row['eager_ms']:.4f} plain {row['plain_ms']:.4f} "
                  f"library {row['library_ms']:.4f} bound "
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


def paged_smoke(model, params, prompts) -> dict:
    """Phase 4's paged schedules on SMOKE (block 4): the staggered schedule
    of ``staggered_smoke`` through a paged pool (2 slots over 16
    positions), then a pool of 2 slots over 24 positions: a 16-token
    prompt, after one step a prompt sharing its first 12 tokens (3 shared
    blocks), and after both retired the first again (full coverage: a copy
    on write and one token recomputed).  The slots' block ids are read after
    every step, and no block may leak.  {"done": {(run, uid): finished},
    "blocks": [...], "stats": [...], "steps": n, "admissions": n}."""
    out = {"done": {}, "blocks": [], "stats": [], "steps": 0,
           "admissions": 0}
    first = prompts[3:4]
    second = torch.cat([first[:, :12], prompts[4:5, :4]], 1)
    # (run, cache length, [(prompt, budget, steps after its submission or
    # "drain")])
    for run, T, schedule in (
            ("staggered", 16, [(prompts[0:1, :8], 6, 1),
                               (prompts[1:2, :8], 3, 1),
                               (prompts[2:3, :8], 5, 0)]),
            ("prefix", 24, [(first, 5, 1), (second, 5, "drain"),
                            (first, 4, 0)])):
        sched = Scheduler(model, params, num_slots=2, cache_len=T,
                          paged=True, block_size=4)

        def step():
            sched.step()
            out["blocks"].append([None if b is None else list(b)
                                  for b in sched._slot_blocks])

        for uid, (tokens, budget, after) in enumerate(schedule):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=budget))
            if after == "drain":
                while not sched.idle:
                    step()
            for _ in range(0 if after == "drain" else after):
                step()
        while not sched.idle:
            step()
        sched.allocator.assert_quiescent()
        st = sched.stats()
        out["stats"].append({k: st[k] for k in (
            "prefix_hit_tokens", "prefill_tokens_skipped",
            "block_high_water", "blocks_in_use")})
        out["steps"] += st["steps_run"]
        out["admissions"] += st["admissions"]
        out["done"].update({(run, f.uid): f for f in sched.finished})
    return out


def small_paged_check() -> None:
    """Phase 4, the paged pool: ``paged_smoke`` on SMOKE at lengths 2 and 3
    ``auto`` with fp32 cores, on the card (the paged slot-pool graph, the
    bucket's captured prefill, the captured resume) and on the CPU (eager),
    same weights: greedy tokens identical, logprobs within 1e-4, the same
    block ids per slot after every step and the same prefix hits, tokens
    skipped and block high-water; the card launches only the path's kernel,
    per pass at each capture's warm-up (counted) and at each admission and
    decode step (replayed)."""
    for length, name in ((2, "tt_fused2"), (3, "tt_fused_chain")):
        cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
            enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
            length=length, backend="auto"))
        gpu = build(cfg, device="cuda")
        cpu = build(cfg, device="cpu")
        p_gpu = gpu.init(0)
        p_cpu = map_tree(lambda t: t.cpu(), p_gpu)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (5, 16), dtype=np.int64))
        want = paged_smoke(cpu, p_cpu, prompts)
        tt_contract.reset_launch_counts()
        got = paged_smoke(gpu, p_gpu, prompts)
        counted = tt_contract.launch_counts()
        replayed = dict(gpu.replayed_launches)
        captures = gpu.graph_captures + gpu.prefill_builds
        per_pass = next(iter(gpu.decode_graphs.values())).captured.get(
            name, 0)
        same = sorted(got["done"]) == sorted(want["done"]) and all(
            np.array_equal(got["done"][u].tokens, want["done"][u].tokens)
            for u in want["done"])
        worst = max(float(np.abs(got["done"][u].logprobs -
                                 want["done"][u].logprobs).max())
                    for u in want["done"])
        print(f"small input, paged scheduler (length {length}, auto, fp32 "
              f"cores, block 4): greedy tokens card {'=' if same else '!='} "
              f"cpu, logprobs max abs diff {worst:.3e} (tol 1e-4); block ids "
              f"{'same' if got['blocks'] == want['blocks'] else 'DIFFER'}; "
              f"counters card {got['stats']} cpu {want['stats']}; "
              f"{got['admissions']} admissions, {got['steps']} steps, "
              f"{gpu.graph_captures} decode and {gpu.prefill_builds} prefill "
              f"or resume captures; launches counted {counted}, replayed "
              f"{replayed} ({per_pass} per pass)", flush=True)
        want_counts = ({name: per_pass * captures * WARMUP_STEPS},
                       {name: per_pass * (got["steps"] + got["admissions"])})
        if not same or not worst <= 1e-4 or per_pass == 0 or \
                got["blocks"] != want["blocks"] or \
                got["stats"] != want["stats"] or \
                (counted, replayed) != want_counts:
            raise AssertionError(
                f"SMOKE paged scheduler length {length}: tokens same {same}, "
                f"logprobs {worst:.3e}, blocks same "
                f"{got['blocks'] == want['blocks']}, counters {got['stats']} "
                f"!= {want['stats']}, (counted, replayed) "
                f"{(counted, replayed)} != {want_counts}")


def drive(label: str, kernel: str, per_pass: int, model, params,
          args, also: dict | None = None,
          prefill_per: dict | None = None) -> tuple[dict, int]:
    """One main path: launch counts set to 0 just before
    ``launch.serve.fixed`` serves ``model`` (a cold run that captures the
    prefill and the decode step, and a warm run of replays) and read just
    after.  The decode step's capture must record ``per_pass`` launches of
    ``kernel`` (and ``also``'s launches per pass of its kernels) and
    nothing else, the prefill's the same or, where it runs other layers
    (an encoder-decoder's encoder and cross keys), ``prefill_per``'s; the
    warm run must make one prefill and ``--steps`` - 1 decode steps of
    them, all replayed (none counted), capture nothing and resolve no
    plan.  Returns serve's result (with every kernel's launches over the
    call in ``path_launches``) and ``kernel``'s launches over the whole
    call, counted and replayed."""
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    per = {kernel: per_pass, **(also or {})}
    pre = per if prefill_per is None else prefill_per
    out = serve.fixed(model, params, args)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    T = args.prompt_len + args.steps
    enc = model.enc_key(args.prompt_len if model.cfg.enc_dec else 0)
    graph = model.decode_graphs[(args.batch, T, False) + enc]
    prefill = model.prefill_graphs[prefill_key(model, args)]
    passes = args.steps
    print(f"main path ({label}): launches counted {counted}, by graph "
          f"replays {replayed} (one capture of the decode step: "
          f"{graph.captured}, of the prefill: {prefill.captured}); peak "
          f"memory {out['peak_bytes'] / 2**30:.3f} GiB allocated, "
          f"{out['peak_reserved_bytes'] / 2**30:.3f} GiB reserved; "
          f"{out['tok_per_s']:.1f} tok/s; warm run {out['warm_s']:.3f} s",
          flush=True)
    def times(prefills: int, steps: int) -> dict:
        return {k: prefills * pre.get(k, 0) + steps * per.get(k, 0)
                for k in set(per) | set(pre)}

    want = {
        "decode capture": (per, graph.captured),
        "prefill capture": (pre, prefill.captured),
        "warm run": (times(1, passes - 1), out["launches"]),
        "warm run counted": ({}, out["counted"]),
        "cold run": (times(1 + WARMUP_STEPS, passes - 1 + WARMUP_STEPS),
                     out["cold_launches"]),
        "counted": (times(WARMUP_STEPS, WARMUP_STEPS), counted),
        "replayed": (times(2, 2 * (passes - 1)), replayed),
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
    if tuple(toks.shape) != (args.batch, passes) or int(toks.min()) < 0 \
            or int(toks.max()) >= model.cfg.vocab_size or \
            not bool(torch.isfinite(out["logprobs"]).all()):
        raise AssertionError(f"bad generation: {tuple(toks.shape)}")
    out["path_launches"] = {k: counted.get(k, 0) + replayed.get(k, 0)
                            for k in set(per) | set(pre)}
    return out, counted[kernel] + replayed[kernel]


def prefill_key(model, args) -> tuple:
    """The key of the captured prefill of the serve flags' fixed batch
    (``serve.prompt_batch``): (batch, tokens, cache length) and the front
    end's rows, an encoder-decoder's frames (as many as the tokens) or a
    vision-language model's images (``serve.image_split``)."""
    img = serve.image_split(model, args.prompt_len)
    n = img or (args.prompt_len if model.cfg.enc_dec else 0)
    return (args.batch, args.prompt_len - img,
            args.prompt_len + args.steps) + model.embeds_key(n)


def decode_steps(model, params, batch, graph: bool, n: int = 16):
    """Prefill ``batch`` (a replay of its captured prefill, or eagerly),
    then 1 + ``n`` greedy decode steps, replayed or eager: (the prefill's
    logits and cache, copied; the first step's logits; the mean host-clock
    ms of the ``n`` later steps, each with its greedy pick, to the device's
    end; the greedy picks [B, n])."""
    B, S = batch["tokens"].shape
    S += model.image_rows(batch)
    logits, cache = model.padded_prefill(params, batch["tokens"], S,
                                         batch["cache_len"], graph,
                                         model.front_embeds(batch))
    prefilled = (logits.clone(), map_tree(torch.clone, cache))
    if graph:
        step = model.graphed_decode_step(B, batch["cache_len"],
                                         enc_T=frames_of(batch))
        step.load(params, cache, S)
    else:
        def step(tok):
            nonlocal cache
            out, cache = model.decode_step(params, cache, tok)
            return out
    first = step(logits[:, -1].argmax(-1, keepdim=True)).clone()
    tok = first[:, -1].argmax(-1, keepdim=True)
    picks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tok = step(tok)[:, -1].argmax(-1, keepdim=True)
        picks.append(tok)
    torch.cuda.synchronize()
    return (prefilled, first, (time.perf_counter() - t0) * 1e3 / n,
            torch.cat(picks, 1))


def frames_of(batch: dict) -> int:
    """The speech frames' count of an encoder-decoder's batch, else 0."""
    frames = batch.get("speech_embeds")
    return 0 if frames is None else int(frames.shape[1])


def eager_runs(model, params, args) -> dict:
    """Before the graph exists: a cold eager run of the served prompts
    (their prefill and ``COLD_STEPS`` decode steps: the set-up a first
    call makes) and a warm one of ``--steps``; the warm one's tok/s, peak
    memory and tokens."""
    batch = serve.prompt_batch(model, args)
    serve.timed_run(model, params, batch, argparse.Namespace(
        **dict(vars(args), steps=min(args.steps, COLD_STEPS))), graph=False)
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
                        eager: dict | None, smi: str) -> dict:
    """Phase 5 beside each served path: the captured prefill's logits and
    cache against the eager prefill's, the first decode step's logits and
    the greedy picks of the 16 steps after it, graph against eager, bit for
    bit, and each decode step's time; beside the graph's warm run
    (``out``) the eager one (``eager``, None where none was made: its
    numbers not measured): tok/s, peak memory, and its greedy tokens
    against the graph's."""
    batch = serve.prompt_batch(model, args)
    captures = (model.graph_captures, model.prefill_builds)
    g_pre, g_first, g_ms, g_picks = decode_steps(model, params, batch,
                                                 graph=True)
    # the graph side captures nothing; the eager side's prefill key counts
    # in ``prefill_builds`` where no eager warm run met it first
    now = (model.graph_captures, model.prefill_builds)
    e_pre, e_first, e_ms, e_picks = decode_steps(model, params, batch,
                                                 graph=False)
    diff = float((g_first - e_first).abs().max())
    prefill_same = torch.equal(g_pre[0], e_pre[0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g_pre[1]),
                                          tree_leaves(e_pre[1])))
    same_tokens = torch.equal(g_picks, e_picks) and (
        eager is None or torch.equal(eager["tokens"], out["tokens"]))
    ev = {k: None if eager is None else eager[k]
          for k in ("tok_per_s", "peak_bytes", "peak_reserved_bytes")}
    rec = dict(graph_tok_per_s=out["tok_per_s"],
               eager_tok_per_s=ev["tok_per_s"],
               graph_step_ms=g_ms, eager_step_ms=e_ms,
               graph_peak_bytes=out["peak_bytes"],
               graph_reserved_bytes=out["peak_reserved_bytes"],
               eager_peak_bytes=ev["peak_bytes"],
               eager_reserved_bytes=ev["peak_reserved_bytes"],
               first_step_max_abs_diff=diff, tokens_identical=same_tokens,
               prefill_identical=prefill_same)
    gib = 2 ** 30

    def num(v, scale=1.0, fmt=".1f"):
        return "not measured" if v is None else f"{v / scale:{fmt}}"
    print(f"graph vs eager ({label}; {smi}): {out['tok_per_s']:.1f} vs "
          f"{num(ev['tok_per_s'])} tok/s (warm run, prefill included); "
          f"decode step {g_ms:.3f} vs {e_ms:.3f} ms; peak allocated "
          f"{out['peak_bytes'] / gib:.3f} vs "
          f"{num(ev['peak_bytes'], gib, '.3f')} GiB (reserved "
          f"{out['peak_reserved_bytes'] / gib:.3f} vs "
          f"{num(ev['peak_reserved_bytes'], gib, '.3f')}); prefill logits "
          f"and cache {'bit-identical' if prefill_same else 'DIFFER'}; "
          f"first decode step's logits max abs diff {diff:.3e}; greedy "
          f"tokens (16 steps{'' if eager is None else ' and the warm run'})"
          f" {'identical' if same_tokens else 'DIFFER'}", flush=True)
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


def replays_alone(replay, source: str, top: int = 0, also=(),
                  n: int = REPLAYS) -> dict:
    """``n`` calls of ``replay`` traced alone (device kernels only,
    the trace opened by the pre-roll): per call, the device kernels, those
    of ``source``, the device busy ms and the host-clock wall ms (the
    profiler's host cost included), and the device ms of ``source``'s
    kernels; with ``top``, the ``top`` kernels by device time, each (name,
    ms, launches) per call; ``also``: other kernel names, each (launches,
    device ms) per call."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profile_serve.preroll()
        t0 = time.perf_counter()
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(profile_serve.RECORDS_S)
    ks = profile_serve.device_kernels(prof)
    out = dict(kernels=sum(e.count for e in ks) / n,
               tt=sum(e.count for e in ks if source in e.key) / n,
               busy_ms=sum(e.self_device_time_total for e in ks) / 1e3 / n,
               tt_ms=sum(e.self_device_time_total for e in ks
                         if source in e.key) / 1e3 / n,
               wall_ms=wall * 1e3 / n)
    if also:
        out["also"] = {name: (
            sum(e.count for e in ks if name in e.key) / n,
            sum(e.self_device_time_total for e in ks if name in e.key)
            / 1e3 / n) for name in also}
    if top:
        ks = sorted(ks, key=lambda e: -e.self_device_time_total)[:top]
        out["top"] = [(e.key[:80], e.self_device_time_total / 1e3 / n,
                       e.count / n) for e in ks]
    return out


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


def cut_model(argv, length: int = 2, layers: int = CUT_LAYERS):
    """(model, params, serve flags) of the serve flags' architecture
    (deepseek-7b by default) at full width and ``layers`` layers, at TT
    ``length``, built as ``launch.serve.setup`` builds it from the serve
    flags ``argv`` (families, backend, weights), through
    ``get_config``/``build``/``init`` (the CLI has no length or depth
    flag)."""
    args = serve.parse_args(argv)
    cfg = get_config(args.arch, "full", tt=TTConfig(
        enabled=True, families=tuple(args.tt.split(",")),
        rank=args.tt_rank, length=length, min_factor=8,
        backend=args.tt_backend, weights=args.tt_weights))
    cfg = dataclasses.replace(cfg, num_layers=layers, num_enc_layers=(
        layers if cfg.enc_dec else 0))
    model = build(cfg, param_dtype=torch.bfloat16)
    params = model.init(args.seed)
    if args.tt_weights == "int8":
        params = model.quantize_params(params)
    return model, params, args


def main_paths(smi: str) -> tuple[dict[str, int], list[dict]]:
    """Phase 5: every main path with fp then int8 cores, each decoding
    through its captured graph; returns each kernel's launches over its
    path's call, and per path the graph against an eager warm run (made
    before the capture, so that each has its own peak memory) and the
    trace of one more warm run of the graph, after the launches were
    read.  Length 2 ``auto`` serves all 30 layers; length 3 and
    ``cuda_step`` serve ``CUT_LAYERS``."""
    per_pass, cut = PROJ * LAYERS, PROJ * CUT_LAYERS
    launches, recs = {}, []
    for weights in ("fp32", "int8"):
        sfx = "_int8" if weights == "int8" else ""
        cli = {b: SERVE_ARGS + ["--tt-backend", b, "--tt-weights", weights]
               for b in ("auto", "cuda_step")}
        paths = (
            ("length 2, auto", "tt_fused2", per_pass,
             lambda: cli_model(cli["auto"])),
            (f"length 3, auto, {CUT_LAYERS} layers", "tt_fused_chain", cut,
             lambda: cut_model(cli["auto"], 3)),
            (f"length 2, cuda_step, {CUT_LAYERS} layers", "tt_step", 2 * cut,
             lambda: cut_model(cli["cuda_step"])),
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


def stagger_requests(vocab: int, lens=STAGGER_LENS, budgets=STAGGER_BUDGETS,
                     count: int = STAGGER_N) -> tuple[list, np.ndarray]:
    """The staggered run's ``count`` prompts [1, S] and budgets, their
    lengths and budgets uniform within ``lens`` and ``budgets``, drawn by
    numpy from seed 0."""
    rng = np.random.default_rng(0)
    n = rng.integers(lens[0], lens[1] + 1, count)
    b = rng.integers(budgets[0], budgets[1] + 1, count)
    return [torch.from_numpy(rng.integers(0, vocab, (1, k), dtype=np.int64))
            for k in n], b


def stagger_embeds(model, count: int, rows) -> list[dict]:
    """The staggered run's front-end inputs, one dict a request, drawn by
    numpy from seed 1 (``serve.random_embeds``): ``rows`` rows each (an
    encoder-decoder's speech frames), or a tuple's counts by turns (a
    vision-language model's images); empty for a model without a front
    end."""
    rng = np.random.default_rng(1)
    counts = rows if isinstance(rows, tuple) else (rows,)
    return [serve.random_embeds(model, rng, 1, counts[i % len(counts)])
            for i in range(count)]


def staggered_full(model, params, graph: bool, check=None,
                   stagger=(STAGGER_LENS, STAGGER_BUDGETS),
                   cache_len: int = 64 + PASSES, count: int = STAGGER_N,
                   rows=0, **paged) -> tuple[dict, dict]:
    """The step-indexed staggered run at full width: ``count`` requests
    (``stagger_requests`` of the (lengths, budgets) ``stagger``, with the
    front end's inputs of ``rows``, ``stagger_embeds``) through a 4-slot
    pool over ``cache_len`` positions
    (``paged``: the paged pool's and chunked prefill's ``Scheduler``
    arguments); four are submitted before the first ``step()``, then one
    before every third; ``check(sched)`` after every step.  A paged pool
    must leak no block.  ({uid: finished}, the scheduler's stats with the
    wall seconds and the MoE assignments dropped in the run)."""
    prompts, budgets = stagger_requests(model.cfg.vocab_size, *stagger,
                                        count)
    embeds = stagger_embeds(model, count, rows)
    sched = Scheduler(model, params, num_slots=4, cache_len=cache_len,
                      graph=graph, **paged)

    def submit(i):
        inputs = {"tokens": prompts[i], **embeds[i]}
        sched.submit(Request(uid=i, inputs=inputs,
                             max_new_tokens=int(budgets[i])))

    moe.reset_drops()
    t0 = time.perf_counter()
    for i in range(4):
        submit(i)
    nxt, k = 4, 0
    while nxt < count or not sched.idle:
        if nxt < count and k and k % 3 == 0:
            submit(nxt)
            nxt += 1
        sched.step()
        if check is not None:
            check(sched)
        k += 1
    torch.cuda.synchronize()
    stats = dict(sched.stats(), wall_s=time.perf_counter() - t0,
                 drops=moe.read_drops())
    if sched.paged:
        sched.allocator.assert_quiescent()
    return {f.uid: f for f in sched.finished}, stats


def scheduler_path(smi: str) -> tuple[int, dict]:
    """Phase 5, continuous batching: deepseek-7b at full width and
    ``CUT_LAYERS`` layers, length 2 ``auto`` (fp cores, bf16 params)
    built from the serve flags (``cut_model``), on one
    slot-pool graph of 4 slots × 96 positions, admissions bucketed (the
    default) and each a replay of the captured prefill of its bucket.  The
    arrival mode through ``launch.serve.simulate`` (launch counts set to 0
    just before, read just after): 0 captures of either kind and 0 plan
    resolutions in the steady state, and ``tt_fused2`` launched 70 times
    per admission prefill plus 70 per decode step, all replayed (none
    counted).  Then the step-indexed staggered run (prompts of 16 to 64
    tokens) through the graphs and eagerly (``graph=False``), both
    bucketed: every token and logprob bit for bit, one prefill capture per
    bucket met that the arrival run had not met, no decode capture.  Then
    each bucket's prefill replays traced alone, and a trace of one more
    arrival run (``launch.profile_serve.profile_arrivals``): device busy
    share, admissions' share of the wall, the per-row ``torch.where`` KV
    writes.  Returns ``tt_fused2``'s launches over the ``simulate`` call
    and the record."""
    per_pass = PROJ * CUT_LAYERS
    model, params, args = cut_model(ARRIVAL_ARGS)
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
    rec = {k: v for k, v in out.items() if k not in ("finished", "sched")}
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
          f"writes {prof['where_count']} kernels ({2 * CUT_LAYERS} per step "
          f"expected: {2 * CUT_LAYERS * prof['steps_run']}), "
          f"{prof['where_s'] * 1e3:.3f} ms; tt_fused2_kernel {tt}",
          flush=True)
    if tt["found"] != tt["expected"] or model.graph_captures != 1 or \
            prof["prefill_captures"] or prof["counted"]:
        raise AssertionError(f"traced arrival run: {tt} tt_fused2_kernel, "
                             f"{model.graph_captures} decode captures, "
                             f"{prof['prefill_captures']} prefill captures, "
                             f"counted {prof['counted']}")
    paged_launches, rec["paged"] = paged_path(
        smi, model, params, args, out, g_done, buckets[64])
    chunk_launches, rec["chunked"] = chunked_path(
        smi, model, params, out, rec["paged"], g_done, buckets[64])
    del model, params, graph
    gc.collect()
    torch.cuda.empty_cache()
    return launches + paged_launches + chunk_launches, rec


def same_runs(a: dict, b: dict) -> bool:
    """Two staggered runs' requests, tokens and logprobs bit for bit."""
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[u].tokens, b[u].tokens) and
        np.array_equal(a[u].logprobs, b[u].logprobs) for u in a)


def paged_path(smi: str, model, params, args, dense: dict, dense_done: dict,
               prefill64: dict) -> tuple[int, dict]:
    """Phase 5, the block-paged pool (blocks of 16, 6 per slot), on the
    model of ``scheduler_path``, whose dense runs are ``dense`` (arrival
    mode) and ``dense_done`` (staggered, graphs): the arrival mode with
    ``--paged`` (0 captures and plan resolutions in the steady state,
    ``tt_fused2`` replayed 70 × (admissions + steps), no leaked block);
    the staggered run paged through the graphs against the dense one and
    against paged eager, bit for bit; the staggered run over 12 blocks
    (admission by memory: live blocks within the pool after every step, a
    request held back while a slot is free, tokens the dense run's,
    logprobs within the bf16 tolerance); serve's ``--prefix-smoke`` (3
    shared blocks and 48 tokens skipped, then full coverage: 63 skipped and
    one block copied on write; greedy tokens and logprobs held against
    ``generate_fixed``'s by ``serve.check_greedy``); the
    captured resume against the eager one (bit for bit) and the full
    prefill (within 2e-2 × max |logit|), with its replay's times beside the
    bucket-64 prefill replay's ``prefill64``; and a traced paged arrival
    run.  Returns ``tt_fused2``'s launches over the paged runs (all but the
    timing and the trace) and the record."""
    per_pass = PROJ * CUT_LAYERS
    T = 64 + PASSES
    key = (4, T, True, (4 * T // PAGED_BLOCK, PAGED_BLOCK))
    pargs = serve.parse_args(ARRIVAL_ARGS + PAGED_ARGS)
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    captures0 = model.graph_captures
    out = serve.simulate(model, params, pargs)
    out.pop("sched").allocator.assert_quiescent()
    graph = model.decode_graphs[key]
    fin = out["finished"]
    rows = [("tok/s", "tok_per_s", 1), ("ttft p50 ms", "ttft_p50_s", 1e3),
            ("ttft p95 ms", "ttft_p95_s", 1e3),
            ("inter-token p50 ms", "itl_p50_s", 1e3),
            ("inter-token p95 ms", "itl_p95_s", 1e3),
            ("admissions share", "admit_share", 1),
            ("kv_pool_bytes", "kv_pool_bytes", 1)]
    print(f"main path (paged arrival mode, block {PAGED_BLOCK}, "
          f"{out['num_blocks']} blocks; {smi}): {len(fin)} requests, "
          f"{out['tokens_out']} tokens in {out['wall_s']:.3f} s; paged vs "
          f"dense: " + "; ".join(
              f"{name} {out[k] * f:.4g} vs {dense[k] * f:.4g}"
              for name, k, f in rows) +
          f"; block high-water {out['block_high_water']}; "
          f"{out['admissions']} admissions, {out['steps_run']} steps; one "
          f"capture of the paged step: {graph.captured}", flush=True)
    want = {
        "steady launches": ({"tt_fused2": per_pass * (
            out["admissions"] + out["steps_run"])}, out["launches"]),
        "steady counted": ({}, out["counted"]),
        "paged step capture": ({"tt_fused2": per_pass}, graph.captured),
        "steady captures, prefill captures, plans": ((0, 0, 0), (
            out["captures"], out["prefill_captures"], out["replans"])),
        "decode captures in the call": (1, model.graph_captures - captures0),
        "requests": (list(range(16)), sorted(f.uid for f in fin)),
        "blocks in use after the drain": (0, out["blocks_in_use"]),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad or any(len(f.tokens) != PASSES or f.finish_reason != "length"
                  or not np.isfinite(f.logprobs).all() for f in fin):
        raise AssertionError(f"paged arrival mode: (expected, got) {bad}")
    rec = {k: v for k, v in out.items() if k != "finished"}
    rec.update(card=smi, dense_tok_per_s=dense["tok_per_s"],
               dense_kv_pool_bytes=dense["kv_pool_bytes"])

    paged = dict(paged=True, block_size=PAGED_BLOCK)
    p_done, p_stats = staggered_full(model, params, graph=True, **paged)
    e_done, e_stats = staggered_full(model, params, graph=False, **paged)
    vs_dense, vs_eager = same_runs(p_done, dense_done), same_runs(p_done,
                                                                 e_done)
    print(f"paged staggered run ({smi}): graph {p_stats['wall_s']:.3f} s, "
          f"eager {e_stats['wall_s']:.3f} s, block high-water "
          f"{p_stats['block_high_water']}; tokens and logprobs against the "
          f"dense graphs {'bit-identical' if vs_dense else 'DIFFER'}, "
          f"against paged eager {'bit-identical' if vs_eager else 'DIFFER'}",
          flush=True)
    if not (vs_dense and vs_eager):
        raise AssertionError(f"paged staggered run: against dense {vs_dense}"
                             f", against eager {vs_eager}")

    seen = {"rows": [], "held": 0}

    def memory(sched):
        reserved = sum(len(b) for b in sched._slot_blocks if b)
        if sched.allocator.in_use > SMALL_POOL or \
                reserved != sched.allocator.in_use:
            raise AssertionError(f"{sched.allocator.in_use} blocks live, "
                                 f"{reserved} reserved, pool {SMALL_POOL}")
        seen["rows"].append(sched.num_active)
        seen["held"] += bool(sched.queue) and sched.num_active < 4

    m_done, m_stats = staggered_full(model, params, graph=True, check=memory,
                                     num_blocks=SMALL_POOL, **paged)
    same_tokens = sorted(m_done) == sorted(dense_done) and all(
        np.array_equal(m_done[u].tokens, dense_done[u].tokens)
        for u in m_done)
    scale = max(float(np.abs(f.logprobs).max()) for f in dense_done.values())
    worst = max(float(np.abs(m_done[u].logprobs -
                             dense_done[u].logprobs).max()) for u in m_done)
    print(f"paged staggered run over {SMALL_POOL} blocks ({smi}): at most "
          f"{max(seen['rows'])} rows live (mean "
          f"{np.mean(seen['rows']):.2f}), a request held back with a slot "
          f"free after {seen['held']} of {len(seen['rows'])} steps, "
          f"{m_stats['steps_run']} steps against {p_stats['steps_run']} on "
          f"24 blocks; tokens {'identical' if same_tokens else 'DIFFER'}, "
          f"logprobs max abs diff {worst:.3e} (tol {2e-2 * scale:.3e}), "
          f"{'' if same_runs(m_done, dense_done) else 'not '}bit-identical "
          f"to the dense run", flush=True)
    if not same_tokens or worst > 2e-2 * scale or not seen["held"]:
        raise AssertionError(f"memory-limited run: tokens same {same_tokens},"
                             f" logprobs {worst:.3e}, held {seen['held']}")
    rec.update(stagger_graph=p_stats, stagger_eager=e_stats,
               small_pool=dict(m_stats, max_rows=max(seen["rows"]),
                               held_steps=seen["held"], max_abs_err=worst,
                               bit_identical=same_runs(m_done, dense_done)))

    sargs = serve.parse_args(
        SERVE_ARGS + ["--tt-backend", "auto", "--slots", "4",
                      "--prefix-smoke", "--prefix-len", str(PREFIX_LEN),
                      "--seed", str(PREFIX_SEED)] + PAGED_ARGS)
    smoke = serve.prefix_smoke(model, params, sargs)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches = counted.get("tt_fused2", 0) + replayed.get("tt_fused2", 0)
    rec.update(prefix=dict(hits=smoke["hits"], blocks=smoke["blocks"],
                           admit_ms=smoke["admit_ms"],
                           greedy=smoke["greedy"],
                           high_water=smoke["block_high_water"]),
               launches_total=launches)
    rec["resume"] = resume_checks(smi, model, params, smoke, prefill64)

    print("profile (paged arrival mode):", flush=True)
    prof = profile_serve.profile_arrivals(model, params, pargs)
    prof.pop("sched", None)
    tt = prof["tt_kernels"].get("tt_fused2_kernel",
                                {"found": 0, "expected": None})
    passes = prof["steps_run"] + prof["admissions"]
    rec.update(traced=dict(
        wall_s=prof["wall_s"], busy_s=prof["busy_s"],
        busy_share=prof["busy_s"] / prof["wall_s"],
        admit_share=prof["admit_share"], scatter_s=prof["scatter_s"],
        scatter_count=prof["scatter_count"], gather_s=prof["gather_s"],
        gather_count=prof["gather_count"], where_s=prof["where_s"],
        where_count=prof["where_count"],
        steps_run=prof["steps_run"], admissions=prof["admissions"], tt=tt))
    print(f"profile (paged arrival mode; {smi}): device busy "
          f"{prof['busy_s'] / prof['wall_s']:.1%} of {prof['wall_s']:.3f} s; "
          f"admissions {prof['admit_share']:.1%} of the wall; block-table "
          f"scatters {prof['scatter_count']} kernels, "
          f"{prof['scatter_s'] * 1e3:.3f} ms ({2 * CUT_LAYERS} per step and "
          f"per admission expected: {2 * CUT_LAYERS * passes}); gathers with "
          f"the "
          f"embedding lookups {prof['gather_count']} kernels, "
          f"{prof['gather_s'] * 1e3:.3f} ms ({2 * CUT_LAYERS} per step and one"
          f" "
          f"per pass expected: {2 * CUT_LAYERS * prof['steps_run'] + passes}); "
          f"torch.where {prof['where_count']} kernels, "
          f"{prof['where_s'] * 1e3:.3f} ms; tt_fused2_kernel {tt}",
          flush=True)
    if tt["found"] != tt["expected"] or prof["prefill_captures"] or \
            prof["captures"] or prof["counted"]:
        raise AssertionError(f"traced paged arrival run: {tt} "
                             f"tt_fused2_kernel, {prof['captures']} decode "
                             f"and {prof['prefill_captures']} prefill "
                             f"captures, counted {prof['counted']}")
    return launches, rec


def resume_checks(smi: str, model, params, smoke: dict,
                  prefill64: dict) -> dict:
    """On the drained pool of serve's prefix smoke: a new prompt sharing its
    ``PREFIX_LEN``-token prefix takes the 3 resident blocks and 3 fresh
    ones, and its suffix of 16 is resumed into slot 0 through the captured
    resume (bucket 16) and eagerly: logits and written blocks bit for bit;
    its logits within 2e-2 × max |logit| of the bucket-64 prefill of the
    whole prompt; the replay's host ms and its busy ms traced alone beside
    the bucket-64 prefill replay's (``prefill64``).  The blocks go back to
    the allocator, which must be quiescent."""
    from repro_torch.serving.paging import chain_hashes
    sched = smoke["sched"]
    alloc, T = sched.allocator, sched.cache_len
    prefix = smoke["prompts"][0][:, :PREFIX_LEN]
    tail = np.random.default_rng(PREFIX_SEED + 1000).integers(
        0, model.cfg.vocab_size, (1, 64 - PREFIX_LEN), dtype=np.int64)
    prompt = torch.cat([prefix, torch.from_numpy(tail)], 1).to(model.device)
    hashes = chain_hashes(prompt.cpu().numpy(), PAGED_BLOCK)
    shared = [alloc.acquire(h) for h in hashes[:PREFIX_LEN // PAGED_BLOCK]]
    assert None not in shared and alloc.acquire(hashes[-1]) is None
    blocks = shared + [alloc.alloc() for _ in range(6 - len(shared))]
    table = torch.tensor(blocks, dtype=torch.int32, device=model.device)
    suffix = prompt[:, PREFIX_LEN:]
    fresh = torch.tensor(blocks[len(shared):], device=model.device)

    def written():
        return [a[fresh].clone() for a in tree_leaves(sched.cache["g0"])]

    def resume(graph):
        return model.resume_prefill(params, sched.cache, suffix, 0, table,
                                    table, PREFIX_LEN, graph)

    g_logits = resume(sched.graph).clone()
    g_blocks = written()
    e_logits = resume(None)
    same = torch.equal(g_logits, e_logits) and all(
        torch.equal(a, b) for a, b in zip(g_blocks, written()))
    full, _ = model.bucketed_prefill(T)(params, {"tokens": prompt})
    diff = float((g_logits - full).abs().max())
    scale = float(full.abs().max())
    host = host_ms(lambda: resume(sched.graph))
    alone = replays_alone(lambda: resume(sched.graph), "tt_fused2_kernel")
    for b in blocks:
        alloc.decref(b)
    alloc.assert_quiescent()
    rec = dict(bit_identical=same, max_abs_diff_full=diff,
               tol=2e-2 * scale, host_ms=host, **{f"replay_{k}": v
                                                  for k, v in alone.items()},
               prefill64_host_ms=prefill64["host_ms"],
               prefill64_busy_ms=prefill64["busy_ms"])
    print(f"resume (suffix of {64 - PREFIX_LEN} after {PREFIX_LEN} shared, "
          f"bucket 16; {smi}): replay against eager "
          f"{'bit-identical' if same else 'DIFFER'}; first-token logits "
          f"against the full prefill max abs diff {diff:.3e} (tol "
          f"{2e-2 * scale:.3e}); replay {host:.3f} ms host clock, traced "
          f"alone {alone['busy_ms']:.3f} ms busy, {alone['kernels']:g} "
          f"kernels, {alone['tt']:g} tt_fused2_kernel; the bucket-64 prefill "
          f"replay {prefill64['host_ms']:.3f} ms host, "
          f"{prefill64['busy_ms']:.3f} ms busy", flush=True)
    if not same or diff > 2e-2 * scale or alone["tt"] != PROJ * CUT_LAYERS:
        raise AssertionError(f"resume: bit-identical {same}, {diff:.3e} "
                             f"from the full prefill, {alone['tt']} "
                             f"tt_fused2_kernel per replay")
    return rec


def chunked_smoke(model, params, prompts, paged: bool) -> dict:
    """The chunked schedule of ``tests/test_torch_chunked.py`` on SMOKE: 2
    slots over 32 positions, chunks of 4 over 2 lanes (budget 8), dense or
    paged (block 4): r0 (13 tokens) prefills over 4 steps, then r1
    (sharing its first 8 tokens) and r2 (queued) are submitted and the
    pool drained, then r0's first 12 tokens (paged: a full cover, the
    last block copied on write).  The slots' (uid, prompt tokens
    processed, blocks) after every step; no block may leak.  {"done":
    {uid: finished}, "history": [...], "stats": {...}, "sched": ...}."""
    kw = dict(num_slots=2, cache_len=32, chunk_prefill=True, chunk_size=4,
              prefill_budget=8)
    if paged:
        kw.update(paged=True, block_size=4)
    sched = Scheduler(model, params, **kw)
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid, budget):
        sched.submit(Request(uid=uid, inputs={"tokens": prompts[uid]},
                             max_new_tokens=budget))

    submit(0, 6)
    for _ in range(4):
        step()
    submit(1, 3)
    submit(2, 5)
    while not sched.idle:
        step()
    submit(3, 4)
    while not sched.idle:
        step()
    if paged:
        sched.allocator.assert_quiescent()
    st = sched.stats()
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "stats": {k: v for k, v in st.items()
                      if k not in ("admit_s", "kv_pool_bytes")},
            "sched": sched}


def small_chunked_check() -> None:
    """Phase 4, chunked prefill: ``chunked_smoke`` on SMOKE over the dense
    and the paged pool, on all six kernel paths (lengths 2 and 3 ``auto``
    and length 2 ``cuda_step``, fp32 and int8 cores, fp32 parameters), on
    the card (the slot-pool graph and the mixed step captured for 2 lanes
    of 4) and on the CPU (eager), same weights: greedy tokens identical,
    logprobs within 1e-4, the same slots, prompt positions and block ids
    after every step and the same counters; the mixed capture records
    three times the decode step's launches of the path's kernel and
    nothing else; the card launches them per pass at the captures'
    warm-ups (counted) and at each replay (replayed)."""
    for length, backend, kernel in ((2, "auto", "tt_fused2"),
                                    (3, "auto", "tt_fused_chain"),
                                    (2, "cuda_step", "tt_step")):
        for weights in ("fp32", "int8"):
            cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
                enabled=True, families=("ffn", "attn"), rank=4,
                min_factor=2, length=length, backend=backend,
                weights=weights))
            gpu = build(cfg, device="cuda")
            cpu = build(cfg, device="cpu")
            p_gpu = gpu.init(0)
            if weights == "int8":
                p_gpu = gpu.quantize_params(p_gpu)
            p_cpu = map_tree(lambda t: t.cpu(), p_gpu)
            rng = np.random.default_rng(80)
            prompts = [torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, 13), dtype=np.int64))
                for _ in range(3)]
            prompts[1][:, :8] = prompts[0][:, :8]
            prompts.append(prompts[0][:, :12])
            name = kernel + ("_int8" if weights == "int8" else "")
            for paged in (False, True):
                want = chunked_smoke(cpu, p_cpu, prompts, paged)
                tt_contract.reset_launch_counts()
                replayed0 = dict(gpu.replayed_launches)
                got = chunked_smoke(gpu, p_gpu, prompts, paged)
                counted = tt_contract.launch_counts()
                replayed = serve.since(replayed0, gpu.replayed_launches)
                graph = got["sched"].graph
                per_pass = graph.captured.get(name, 0)
                mixed = graph.mixed_graphs[(2, 4)].captured
                st = got["stats"]
                same = sorted(got["done"]) == sorted(want["done"]) == \
                    [0, 1, 2, 3] and all(
                        np.array_equal(got["done"][u].tokens,
                                       want["done"][u].tokens)
                        for u in want["done"])
                worst = max(float(np.abs(got["done"][u].logprobs -
                                         want["done"][u].logprobs).max())
                            for u in want["done"])
                counts = {
                    "history": (want["history"], got["history"]),
                    "stats": (want["stats"], st),
                    "mixed capture": ({name: 3 * per_pass}, mixed),
                    "counted": ({name: (per_pass + mixed.get(name, 0)) *
                                 WARMUP_STEPS}, counted),
                    "replayed": ({name: per_pass * st["plain_steps"] +
                                  mixed.get(name, 0) * st["mixed_steps"]},
                                 replayed)}
                bad = {k: v for k, v in counts.items() if v[0] != v[1]}
                print(f"small input, chunked scheduler (length {length}, "
                      f"{backend}, {weights} cores, "
                      f"{'paged' if paged else 'dense'}): greedy tokens card "
                      f"{'=' if same else '!='} cpu, logprobs max abs diff "
                      f"{worst:.3e} (tol 1e-4); {st['prefill_chunks']} "
                      f"chunks, {st['mixed_steps']} mixed and "
                      f"{st['plain_steps']} plain steps; slots and counters "
                      f"{'same' if not bad else 'DIFFER'}; launches counted "
                      f"{counted}, replayed {replayed} ({per_pass} per decode "
                      f"replay, {mixed} per mixed replay)", flush=True)
                if not same or not worst <= 1e-4 or per_pass == 0 or bad:
                    raise AssertionError(
                        f"SMOKE chunked scheduler length {length} {backend} "
                        f"{weights} paged={paged}: tokens same {same}, "
                        f"logprobs {worst:.3e}, (expected, got) {bad}")


def chunked_path(smi: str, model, params, dense: dict, paged: dict,
                 dense_done: dict, prefill64: dict) -> tuple[int, dict]:
    """Phase 5, chunked prefill inside the decode step, on the model of
    ``scheduler_path`` (length 2 ``auto``, fp cores), whose monolithic
    arrival runs are ``dense`` and ``paged`` and whose monolithic staggered
    run is ``dense_done``: the arrival mode with ``--chunk-prefill`` at
    the reference's defaults (chunks of 64, one lane) over the dense and
    the paged pool (0 captures and plan resolutions in the steady state,
    16 chunks, ``tt_fused2`` replayed 140 times per mixed step and 70 per
    plain step, none counted, no leaked block), beside the monolithic run;
    the staggered run at chunks of 16 over 2 lanes (budget 32) over both
    pools, through the graphs and eagerly: graph ≡ eager and paged ≡ dense
    bit for bit, and every request held against ``generate_fixed`` by
    ``serve.check_greedy``; serve's prefix smoke with ``--chunk-prefill
    --chunk-size 16`` (4 chunks, then 1 for the hit and 1 for the full
    cover, its last block copied on write); and the mixed replays' host ms
    and busy ms traced alone, idle (the same kernels), beside the decode
    replay's and the bucket-64 prefill replay's ``prefill64``.  Returns
    ``tt_fused2``'s launches over the chunked runs (all but the timing)
    and the record."""
    per_pass = PROJ * CUT_LAYERS
    T = 64 + PASSES
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    rec = {"card": smi}
    rows = [("tok/s", "tok_per_s", 1), ("ttft p50 ms", "ttft_p50_s", 1e3),
            ("ttft p95 ms", "ttft_p95_s", 1e3),
            ("inter-token p50 ms", "itl_p50_s", 1e3),
            ("inter-token p95 ms", "itl_p95_s", 1e3)]
    for pool, extra, mono in (("dense", [], dense),
                              ("paged", PAGED_ARGS, paged)):
        cargs = serve.parse_args(ARRIVAL_ARGS + extra + ["--chunk-prefill"])
        captures0 = model.graph_captures
        out = serve.simulate(model, params, cargs)
        sched = out.pop("sched")
        if sched.paged:
            sched.allocator.assert_quiescent()
        mixed = sched.graph.mixed_graphs[(1, 64)].captured
        fin = out["finished"]
        expect = {"tt_fused2": per_pass * (2 * out["mixed_steps"] +
                                           out["plain_steps"])}
        print(f"main path (chunked arrival mode, {pool} pool, chunks of 64, "
              f"one lane; {smi}): {len(fin)} requests, {out['tokens_out']} "
              f"tokens in {out['wall_s']:.3f} s; chunked vs monolithic: " +
              "; ".join(f"{name} {out[k] * f:.4g} vs {mono[k] * f:.4g}"
                        for name, k, f in rows) +
              f"; {out['prefill_chunks']} chunks, {out['mixed_steps']} mixed "
              f"and {out['plain_steps']} plain steps (monolithic: "
              f"{mono['admissions']} admissions, {mono['steps_run']} steps); "
              f"launches {out['launches']}; one capture of the mixed step: "
              f"{mixed}", flush=True)
        want = {
            "steady launches": (expect, out["launches"]),
            "steady replayed": (expect, out["replayed"]),
            "steady counted": ({}, out["counted"]),
            "mixed capture": ({"tt_fused2": 2 * per_pass}, mixed),
            "steady captures, prefill captures, plans": ((0, 0, 0), (
                out["captures"], out["prefill_captures"], out["replans"])),
            "mixed captures in the call": (1, model.graph_captures -
                                           captures0),
            "chunks, admissions": ((16, 0), (out["prefill_chunks"],
                                             out["admissions"])),
            "requests": (list(range(16)), sorted(f.uid for f in fin)),
        }
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad or any(len(f.tokens) != PASSES or f.finish_reason != "length"
                      or not np.isfinite(f.logprobs).all() for f in fin):
            raise AssertionError(f"chunked arrival mode ({pool}): (expected, "
                                 f"got) {bad}")
        rec[f"arrival_{pool}"] = dict(
            {k: v for k, v in out.items() if k != "finished"},
            mono={k: mono[k] for _, k, _ in rows})

    ck = dict(chunk_prefill=True, chunk_size=16, prefill_budget=32)
    runs = {}
    for label, graph, kw in (("dense graph", True, {}),
                             ("dense eager", False, {}),
                             ("paged graph", True, dict(
                                 paged=True, block_size=PAGED_BLOCK)),
                             ("paged eager", False, dict(
                                 paged=True, block_size=PAGED_BLOCK))):
        runs[label] = staggered_full(model, params, graph=graph, **kw, **ck)
    done = {k: v[0] for k, v in runs.items()}
    checks = {"dense graph = eager": same_runs(done["dense graph"],
                                               done["dense eager"]),
              "paged graph = eager": same_runs(done["paged graph"],
                                               done["paged eager"]),
              "paged = dense": same_runs(done["paged graph"],
                                         done["dense graph"])}
    prompts, _ = stagger_requests(model.cfg.vocab_size)
    greedy = {u: serve.check_greedy(model, params,
                                    prompts[u].to(model.device), f, T)
              for u, f in done["dense graph"].items()}
    as_mono = sum(np.array_equal(f.tokens, dense_done[u].tokens)
                  for u, f in done["dense graph"].items())
    st = runs["dense graph"][1]
    print(f"chunked staggered run (chunks of 16, 2 lanes; {smi}): "
          f"{st['prefill_chunks']} chunks, {st['mixed_steps']} mixed and "
          f"{st['plain_steps']} plain steps; wall graph "
          f"{st['wall_s']:.3f} s dense, {runs['paged graph'][1]['wall_s']:.3f}"
          f" s paged, eager {runs['dense eager'][1]['wall_s']:.3f} and "
          f"{runs['paged eager'][1]['wall_s']:.3f} s; " +
          ", ".join(f"{k} {'bit-identical' if v else 'DIFFER'}"
                    for k, v in checks.items()) +
          f"; against generate_fixed: "
          f"{sum(g['identical'] for g in greedy.values())} of "
          f"{len(greedy)} identical, picks within "
          f"{max(g['slack'] for g in greedy.values()):.3g} of the top logit, "
          f"logprobs within "
          f"{max(g['logprob_diff'] for g in greedy.values()):.3g} (tol "
          f"{max(g['tol'] for g in greedy.values()):.3g}); {as_mono} of "
          f"{len(greedy)} requests token-identical to the monolithic "
          f"staggered run", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"chunked staggered run: {checks}")
    rec["staggered"] = dict({k: v[1] for k, v in runs.items()},
                            checks=checks, as_monolithic=int(as_mono),
                            greedy=greedy)

    sargs = serve.parse_args(
        SERVE_ARGS + ["--tt-backend", "auto", "--slots", "4",
                      "--prefix-smoke", "--prefix-len", str(PREFIX_LEN),
                      "--seed", str(PREFIX_SEED), "--chunk-prefill",
                      "--chunk-size", "16"] + PAGED_ARGS)
    smoke = serve.prefix_smoke(model, params, sargs)
    if smoke["chunks"] != [4, 1, 1]:
        raise AssertionError(f"chunked prefix smoke: chunks per admission "
                             f"{smoke['chunks']}, expected [4, 1, 1]")
    rec["prefix"] = dict(hits=smoke["hits"], chunks=smoke["chunks"],
                         cow=smoke["cow"], admit_ms=smoke["admit_ms"],
                         greedy=smoke["greedy"])
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches = counted.get("tt_fused2", 0) + replayed.get("tt_fused2", 0)

    # the replays, idle (every lane inactive, no row decoding: the same
    # kernels on the same shapes, and nothing changes)
    graph = model.decode_graphs[(4, T, True)]
    tok = torch.zeros((4, 1), dtype=torch.int64, device=model.device)
    idle = np.zeros(4, bool)
    timing = {"decode": dict(host_ms=host_ms(lambda: graph(tok, idle)),
                             **replays_alone(lambda: graph(tok, idle),
                                             "tt_fused2_kernel"))}
    for K, C in ((1, 64), (2, 16)):
        mixed = graph.mixed(K, C)
        lanes = {"tokens": np.zeros((K, C), np.int64),
                 "slot": np.zeros(K, np.int32),
                 "start": np.zeros(K, np.int32),
                 "true": np.ones(K, np.int32), "active": np.zeros(K, bool)}

        def replay():
            mixed(tok, idle, lanes)

        timing[f"mixed {K}x{C}"] = dict(host_ms=host_ms(replay),
                                        **replays_alone(replay,
                                                        "tt_fused2_kernel"))
    timing["prefill 64"] = {k: prefill64[k] for k in (
        "host_ms", "busy_ms", "kernels", "tt")}
    print(f"replays alone, idle ({smi}): " + "; ".join(
        f"{k} {v['host_ms']:.3f} ms host, {v['busy_ms']:.3f} ms busy, "
        f"{v['kernels']:g} kernels, {v['tt']:g} tt_fused2_kernel"
        for k, v in timing.items()), flush=True)
    if [timing[k]["tt"] for k in ("decode", "mixed 1x64", "mixed 2x16")] != \
            [per_pass, 2 * per_pass, 3 * per_pass]:
        raise AssertionError(f"mixed replays traced alone: {timing}")
    rec["replays"] = timing
    return launches, rec


def fused2_kernels(gen, shapes: dict, model: str, rows_of=ROWS,
                   checked=(), cases=CASES) -> list[dict]:
    """Phases 2 and 3 at one model's fused2 shapes (``shapes``: label →
    (dims, launches per layer or pass)): ``tt_fused2`` and
    ``tt_fused2_int8`` against their plain versions and timed beside them,
    ``torch.matmul`` of the dense layer and the bound, at ``rows_of``
    (cold-L2 too), every case of ``cases``; then checked untimed at
    ``checked`` rows.  One record per (kernel, shape, rows, case), marked
    ``model``."""
    spec = hw.device_spec(torch.device("cuda"))
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    recs = []
    for label, (dims, per_layer) in shapes.items():
        for rows in tuple(rows_of) + tuple(checked):
            for int8, act in cases:
                kernel, run, plain, library, moved, flops, *_ = \
                    layer_cases(dims, rows, int8, act, gen)
                if rows in rows_of:
                    rec = measure(kernel, label, rows, act, per_layer, run,
                                  plain, library, moved, flops, TOL[act],
                                  spec, buf.zero_)
                else:
                    rec = check(kernel, label, rows, act, run, plain,
                                TOL[act])
                rec.update(length=2, model=model)
                recs.append(rec)
    if checked:
        worst = max(r["max_rel_err"] for r in recs if r["rows"] in checked)
        print(f"{model} fused2 shapes at {checked} rows: "
              f"{sum(r['rows'] in checked for r in recs)} calls within "
              f"tolerance, worst relative error {worst:.2e}", flush=True)
    return recs


def gemma3_kernels(gen) -> list[dict]:
    """``fused2_kernels`` at gemma3-4b's five shapes, at ``ROWS`` and
    untimed at ``GEMMA3_BUCKET_ROWS``."""
    return fused2_kernels(gen, GEMMA3_SHAPES, "gemma3-4b", ROWS,
                          GEMMA3_BUCKET_ROWS)


def smoke_models(weights: str = "fp32", arch: str = "gemma3-4b"):
    """SMOKE of ``arch`` (gemma3: window 16; mixtral: window 32, 4
    experts top-2, dropless; deepseek-v2-lite: MLA, 4 experts top-2 and a
    shared one, dropless) at length 2 ``auto``, TT on ffn+attn: (card
    model, its params, cpu model, the same params there)."""
    cfg = get_config(arch, "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    gpu = build(cfg, device="cuda")
    cpu = build(cfg, device="cpu")
    p_gpu = gpu.init(0)
    if weights == "int8":
        p_gpu = gpu.quantize_params(p_gpu)
    return gpu, p_gpu, cpu, map_tree(lambda t: t.cpu(), p_gpu)


def smoke_schedule(model, params, prompts, **kw) -> dict:
    """The schedule of ``tests/test_torch_gemma3.py`` and
    ``tests/test_torch_mixtral.py`` on SMOKE: 2 slots over 48 positions
    (``kw``: pool and chunking); r0 (40 tokens, the rings wrap) is
    admitted and steps once, r1 (24) and r2 (8) follow, r2 queues; after
    the drain r3 (20).  The slots' (uid, prompt position, blocks) after
    every step, and the counters with the MoE assignments dropped; no
    block may leak."""
    sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw)
    moe.reset_drops()
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if sched.paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid):
        p = prompts[uid]
        sched.submit(Request(uid=uid, inputs=p if isinstance(p, dict) else
                             {"tokens": p}, max_new_tokens=(5, 6, 4, 3)[uid]))

    submit(0)
    step()
    submit(1)
    submit(2)
    while not sched.idle:
        step()
    submit(3)
    while not sched.idle:
        step()
    if sched.paged:
        sched.allocator.assert_quiescent()
    st = sched.stats()
    st["drops"] = moe.read_drops()
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "stats": {k: v for k, v in st.items()
                      if k not in ("admit_s", "kv_pool_bytes")}}


# phase 4's scheduler modes: the pools and chunkings ``small_ring_check``
# runs by default, and mamba2's (chunks of 1, 5 and the whole longest
# prompt, both pools)
RING_MODES = {"dense": {}, "paged": dict(paged=True, block_size=4),
              "chunk8 dense": dict(chunk_prefill=True, chunk_size=8,
                                   prefill_budget=16),
              "chunk8 paged": dict(chunk_prefill=True, chunk_size=8,
                                   prefill_budget=16, paged=True,
                                   block_size=4),
              "chunk24 dense": dict(chunk_prefill=True, chunk_size=24),
              "chunk24 paged": dict(chunk_prefill=True, chunk_size=24,
                                    paged=True, block_size=8)}
SSM_MODES = {"dense": {}, "paged": dict(paged=True, block_size=4)}
# seamless's and internvl2's: no chunked prefill (refused), so the two
# pools
SEAMLESS_MODES = {"dense": {}, "paged": dict(paged=True, block_size=4)}
# internvl2 SMOKE's image rows: the fixed batch's prompts of 24 and 40
# tokens (16 decode steps fill each cache), and the scheduler's four
# requests (the first fills its cache of 48)
SMOKE_IMAGES, SMOKE_SCHED_IMAGES = (8, 5), (3, 16, 8, 5)
for _c in (1, 5, 40):
    SSM_MODES[f"chunk{_c} dense"] = dict(chunk_prefill=True, chunk_size=_c,
                                         prefill_budget=2 * _c)
    SSM_MODES[f"chunk{_c} paged"] = dict(SSM_MODES[f"chunk{_c} dense"],
                                         paged=True, block_size=4)


def small_ring_check(arch: str = "gemma3-4b", modes: dict = RING_MODES
                     ) -> None:
    """Phase 4, SMOKE of a ring-cache, MoE or SSM model (gemma3: window 16;
    mixtral: window 32 and 4 experts top-2, dropless; deepseek-v2-lite:
    MLA over latent caches, 4 experts top-2 and a shared one, dropless;
    mamba2: 2 SSD blocks, d_state 16, with ``SSM_MODES``; jamba: one
    period of 3 SSD blocks and a GQA block, MLPs and 4 experts top-2,
    dropless, with ``SSM_MODES``: its paged pool mixes the GQA block's
    arenas with the SSD blocks' slot state; seamless: 2 non-causal encoder
    blocks and 2 cross-attending decoder blocks, every prompt with 12
    speech frames, with ``SEAMLESS_MODES``, and chunked prefill refused;
    internvl2: 2 GQA blocks after image embeddings of width 32 projected
    and prepended to every prompt, ``SMOKE_IMAGES`` and
    ``SMOKE_SCHED_IMAGES`` rows, with ``SEAMLESS_MODES``, chunked prefill
    refused; the staggered prompts share no prefix) on the card against
    the CPU,
    same weights, fp32 and int8 cores: the fixed batch (prompts of 24 and
    40 into caches of 48 and 64; gemma3's rings wrap): the prefill and 16
    decode steps fed the CPU's greedy tokens, eagerly and through the
    captured prefill and decode, logits within 1e-4, and
    ``generate_fixed``'s greedy tokens identical; then the schedulers of
    ``smoke_schedule``, dense, paged (block 4) and chunked (chunks of 8
    over 2 lanes and of 24, both pools; ``modes``), through the graphs:
    tokens identical, logprobs within 1e-4, slots (block ids included),
    counters and drop counts equal, the prefix counters 0 (the paged pools
    ask for the prefix cache).  Only the path's fused2 kernels run (the
    experts through ``tt_fused2_experts``), none of the prefix cache's
    hits."""
    for weights in ("fp32", "int8"):
        gpu, p_gpu, cpu, p_cpu = smoke_models(weights, arch)
        sfx = "_int8" if weights == "int8" else ""
        names = {"tt_fused2" + sfx} | (
            {"tt_fused2_experts" + sfx} if gpu.has_moe else set())
        tt_contract.reset_launch_counts()
        replayed0 = dict(gpu.replayed_launches)
        F = 12 if gpu.cfg.enc_dec else 0
        if gpu.cfg.frontend:
            try:
                Scheduler(gpu, p_gpu, num_slots=2, cache_len=48,
                          chunk_prefill=True)
            except ValueError as err:
                print(f"small input, {arch}: chunked prefill refused "
                      f"({err})", flush=True)
            else:
                raise AssertionError(f"{arch}: chunked prefill was not "
                                     f"refused")
        for (S, T), n in zip(((24, 48), (40, 64)), SMOKE_IMAGES):
            rng = np.random.default_rng(S)
            tokens = torch.from_numpy(rng.integers(0, 256, (2, S),
                                                   dtype=np.int64))
            speech = serve.random_embeds(cpu, rng, 2, F or n)
            frames = cpu.front_embeds(speech)
            rows = 0 if frames is None else int(frames.shape[1])
            plen = S + cpu.image_rows(speech)
            lc, cc = cpu.prefill(p_cpu, {"tokens": tokens, "cache_len": T,
                                         **speech})
            want, forced = [lc], []
            for _ in range(16):
                forced.append(want[-1][:, -1].argmax(-1, keepdim=True))
                lc, cc = cpu.decode_step(p_cpu, cc, forced[-1])
                want.append(lc)
            lg, cg = gpu.graphed_prefill(2, S, T, rows)(
                p_gpu, tokens.cuda(), plen,
                None if frames is None else frames.cuda())
            step = gpu.graphed_decode_step(2, T, enc_T=F)
            step.load(p_gpu, cg, plen)
            got = [lg.clone()] + [step(t.cuda()).clone() for t in forced]
            worst = max(float((g.cpu() - w).abs().max())
                        for g, w in zip(got, want))
            batch = {"tokens": tokens, "cache_len": T, **speech}
            lg, cg = gpu.prefill(p_gpu, batch)
            eager = [lg]
            for t in forced:
                lg, cg = gpu.decode_step(p_gpu, cg, t.cuda())
                eager.append(lg)
            worst_eager = max(float((g.cpu() - w).abs().max())
                              for g, w in zip(eager, want))
            same = torch.equal(generate_fixed(gpu, p_gpu, batch,
                                              16).tokens.cpu(),
                               generate_fixed(cpu, p_cpu, batch, 16).tokens)
            print(f"small input, {arch} fixed batch ({weights} cores, prompt "
                  f"{S}{f' after {plen - S} image rows' if plen > S else ''}, "
                  f"cache {T}, windows {gpu.windows}): logits card "
                  f"vs cpu max abs diff {worst:.3e} through the captured "
                  f"prefill and decode, {worst_eager:.3e} eager (tol 1e-4); "
                  f"greedy tokens {'=' if same else '!='} cpu", flush=True)
            if not max(worst, worst_eager) <= 1e-4 or not same:
                raise AssertionError(f"{arch} SMOKE fixed batch {weights} "
                                     f"prompt {S}: {worst:.3e}, eager "
                                     f"{worst_eager:.3e}, tokens same "
                                     f"{same}")
        rng = np.random.default_rng(90)
        prompts = [torch.from_numpy(rng.integers(0, 256, (1, n),
                                                 dtype=np.int64))
                   for n in (40, 24, 8, 20)]
        if gpu.cfg.frontend:
            prompts = [{"tokens": p,
                        **serve.random_embeds(cpu, rng, 1, F or n)}
                       for p, n in zip(prompts, SMOKE_SCHED_IMAGES)]
        for mode, kw in modes.items():
            want = smoke_schedule(cpu, p_cpu, prompts, **kw)
            got = smoke_schedule(gpu, p_gpu, prompts, **kw)
            same = sorted(got["done"]) == sorted(want["done"]) == \
                [0, 1, 2, 3] and all(
                    np.array_equal(got["done"][u].tokens,
                                   want["done"][u].tokens)
                    for u in want["done"])
            worst = max(float(np.abs(got["done"][u].logprobs -
                                     want["done"][u].logprobs).max())
                        for u in want["done"])
            st = got["stats"]
            slots = got["history"] == want["history"]
            print(f"small input, {arch} scheduler ({weights} cores, {mode}):"
                  f" greedy tokens card {'=' if same else '!='} cpu, "
                  f"logprobs max abs diff {worst:.3e} (tol 1e-4); slots "
                  f"{'same' if slots else 'DIFFER'}, counters "
                  f"{'same' if st == want['stats'] else 'DIFFER'};"
                  f" {st['steps_run']} steps, {st.get('prefill_chunks', 0)} "
                  f"chunks, prefix hits {st.get('prefix_hit_tokens', 0)}, "
                  f"drops {st['drops']} (cpu {want['stats']['drops']})",
                  flush=True)
            if not same or not worst <= 1e-4 or not slots or \
                    st != want["stats"] or st.get("prefix_hit_tokens", 0):
                raise AssertionError(f"{arch} SMOKE scheduler {weights} "
                                     f"{mode}: tokens same {same}, logprobs "
                                     f"{worst:.3e}, stats {st} vs "
                                     f"{want['stats']}")
        kernels = set(tt_contract.launch_counts()) | set(serve.since(
            replayed0, gpu.replayed_launches))
        if kernels != names:
            raise AssertionError(f"{arch} SMOKE {weights}: kernels "
                                 f"{kernels}, expected only {names}")
        del gpu, p_gpu
        gc.collect()
        torch.cuda.empty_cache()


def small_prefix_check(arch: str = "deepseek-v2-lite-16b") -> None:
    """Phase 4, prefix reuse through a mixture of experts: ``paged_smoke``
    (the staggered schedule, then a shared-prefix pair and a full cover:
    resumes, the second with a copy on write) on SMOKE of ``arch`` (MLA,
    whose latent cache is shared; 4 experts top-2, dropless), fp32 and
    int8 cores, on the card (the paged slot-pool graph, the captured
    prefills and resumes) against the CPU, same weights: greedy tokens
    identical, logprobs within 1e-4, block ids per step, prefix counters
    and block high-water equal, prefix hits, and no drop on either
    side."""
    for weights in ("fp32", "int8"):
        gpu, p_gpu, cpu, p_cpu = smoke_models(weights, arch)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, gpu.cfg.vocab_size, (5, 16), dtype=np.int64))
        moe.reset_drops()
        want = paged_smoke(cpu, p_cpu, prompts)
        want_drops = moe.read_drops()
        moe.reset_drops()
        got = paged_smoke(gpu, p_gpu, prompts)
        got_drops = moe.read_drops()
        same = sorted(got["done"]) == sorted(want["done"]) and all(
            np.array_equal(got["done"][u].tokens, want["done"][u].tokens)
            for u in want["done"])
        worst = max(float(np.abs(got["done"][u].logprobs -
                                 want["done"][u].logprobs).max())
                    for u in want["done"])
        hits = got["stats"][1]["prefix_hit_tokens"]
        print(f"small input, {arch} paged prefix reuse ({weights} cores, "
              f"block 4): greedy tokens card {'=' if same else '!='} cpu, "
              f"logprobs max abs diff {worst:.3e} (tol 1e-4); block ids "
              f"{'same' if got['blocks'] == want['blocks'] else 'DIFFER'}; "
              f"counters card {got['stats']} cpu {want['stats']}; drops "
              f"card {got_drops} cpu {want_drops}", flush=True)
        if not same or not worst <= 1e-4 or got["blocks"] != want["blocks"] \
                or got["stats"] != want["stats"] or not hits or got_drops \
                or want_drops:
            raise AssertionError(
                f"{arch} SMOKE prefix reuse {weights}: tokens same {same}, "
                f"logprobs {worst:.3e}, counters {got['stats']} != "
                f"{want['stats']}, drops {got_drops} / {want_drops}")
        del gpu, p_gpu
        gc.collect()
        torch.cuda.empty_cache()


def gemma3_path(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 5, full-width gemma3-4b (bf16 params from seed 0, TT on
    ffn+attn at rank 16, ``auto``: ``tt_fused2``, 238 a pass; lm_head tied).

    The fixed batch (``GEMMA3_FIXED``) through ``fixed_family``, fp then
    int8 cores (every projection replayed through its kernel, 0 captures
    and 0 plan resolutions warm; graph ≡ eager bit for bit; the decode and
    prefill replays traced alone).  Then on one fp model at
    ``GEMMA3_CUT_LAYERS`` layers (``cut_model``): Poisson arrivals
    (``GEMMA3_ARRIVAL`` through ``launch.serve.simulate``: 0 captures of
    either kind and 0 plan resolutions steady, 7 ``tt_fused2`` a layer per
    admission and per step, all replayed), and the staggered run
    (``GEMMA3_STAGGER``): dense graph ≡ dense eager ≡ paged (blocks of
    64) bit for bit, chunked (chunks of 256 over 2 lanes) graph ≡ eager
    and paged ≡ dense bit for bit, and every request of the dense run held
    against ``generate_fixed`` (``staggered_block``).  Returns each
    kernel's launches over the fixed-batch calls and the arrival and
    staggered runs (the checks against ``generate_fixed`` aside), and the
    record."""
    t_phase = time.perf_counter()
    launches, fixed = fixed_family(smi, "gemma3-4b",
                                   GEMMA3_ARGS + GEMMA3_FIXED,
                                   {"tt_fused2": PROJ * GEMMA3_LAYERS})
    rec = {"card": smi, "fixed": fixed}

    model, params, args = cut_model(GEMMA3_ARGS + GEMMA3_ARRIVAL,
                                    layers=GEMMA3_CUT_LAYERS)
    per_pass = PROJ * GEMMA3_CUT_LAYERS
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    out = serve.simulate(model, params, args)
    out.pop("sched")
    fin = out["finished"]
    T = 960 + 128
    print(f"main path (gemma3-4b at {GEMMA3_CUT_LAYERS} layers, arrival "
          f"mode, 4 slots x {T}; {smi}): "
          f"{len(fin)} requests, {out['tokens_out']} tokens in "
          f"{out['wall_s']:.3f} s = {out['tok_per_s']:.1f} tok/s; ttft "
          f"p50/p95 {out['ttft_p50_s'] * 1e3:.1f}/"
          f"{out['ttft_p95_s'] * 1e3:.1f} ms; inter-token p50/p95 "
          f"{out['itl_p50_s'] * 1e3:.2f}/{out['itl_p95_s'] * 1e3:.2f} ms; "
          f"{out['admissions']} admissions ({out['admit_share']:.1%} of the "
          f"wall), {out['steps_run']} steps; pool "
          f"{out['kv_pool_bytes'] / 2**20:.1f} MiB, peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB; launches {out['launches']}; "
          f"prefill graphs {list(model.prefill_graphs)}", flush=True)
    want = {
        "steady launches": ({"tt_fused2": per_pass * (
            out["admissions"] + out["steps_run"])}, out["launches"]),
        "steady counted": ({}, out["counted"]),
        "steady captures, prefill captures, plans": ((0, 0, 0), (
            out["captures"], out["prefill_captures"], out["replans"])),
        "prefill graphs": ([(1, 1024, T)], list(model.prefill_graphs)),
        "requests": (list(range(16)), sorted(f.uid for f in fin)),
    }
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad or any(len(f.tokens) != 128 or f.finish_reason != "length" or
                  int(f.tokens.max()) >= model.cfg.vocab_size or
                  not np.isfinite(f.logprobs).all() for f in fin):
        raise AssertionError(f"gemma3 arrival mode: (expected, got) {bad}")
    rec["arrival"] = {k: v for k, v in out.items() if k != "finished"}

    paged = dict(paged=True, block_size=GEMMA3_BLOCK)
    done, rec["staggered"] = staggered_block(
        smi, f"gemma3-4b at {GEMMA3_CUT_LAYERS} layers", model, params,
        GEMMA3_STAGGER, GEMMA3_T, STAGGER_N,
        {"dense graph": (True, {}), "dense eager": (False, {}),
         "paged graph": (True, paged),
         "chunked graph": (True, GEMMA3_CHUNK),
         "chunked eager": (False, GEMMA3_CHUNK),
         "chunked paged graph": (True, dict(GEMMA3_CHUNK, **paged))},
        [("dense graph", "dense eager"), ("paged graph", "dense graph"),
         ("chunked graph", "chunked eager"),
         ("chunked paged graph", "chunked graph")], ("dense graph",))
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches["tt_fused2"] += counted.get("tt_fused2", 0) + replayed.get(
        "tt_fused2", 0)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"gemma3-4b phase 5: {rec['wall_s']:.1f} s", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec

def expert_cases(dims, C, int8, act, gen, E):
    """The expert-batched fused2 kernel at one expert shape: ``E`` experts
    with the model's TT init, ``C`` rows each.  (kernel, run, plain,
    library, bytes, flops): the library call is one ``torch.bmm`` over the
    dense expert stacks ``[E, N, M]`` (dequantized for int8 cores) in the
    activation dtype."""
    ns, ms, ranks = dims
    made = [random_cores(dims, act, int8, gen) for _ in range(E)]
    p2 = pack_core(torch.stack([c[1] for c, _, _ in made]))
    p1 = pack_core(torch.stack([c[0] for c, _, _ in made]))
    x = torch.randn((E, C, int(np.prod(ns))), generator=gen,
                    device="cuda").to(act)
    d2 = (ns[0], ns[1], ms[0], ms[1], ranks[1])
    if int8:
        s = torch.stack([torch.stack([sc[1], sc[0]]) for _, sc, _ in made]
                        ).float().contiguous()
        run = lambda: tt_contract.tt_fused2_experts_int8(x, p2, p1, s, d2)  # noqa: E731
        plain = lambda: ref.tt_fused2_experts_ref(x, p2, p1, d2, s)  # noqa: E731
    else:
        run = lambda: tt_contract.tt_fused2_experts(x, p2, p1, d2)  # noqa: E731
        plain = lambda: ref.tt_fused2_experts_ref(x, p2, p1, d2)  # noqa: E731
    w = torch.stack([dense.T for _, _, dense in made]).contiguous().to(act)
    library = lambda: torch.bmm(x, w)  # noqa: E731
    weight_bytes = E * (chain_weight_elems(ns, ms, ranks) *
                        p2.element_size() + (8 if int8 else 0))
    moved = (x.numel() + E * C * int(np.prod(ms))) * \
        x.element_size() + weight_bytes
    return ("tt_fused2_experts" + ("_int8" if int8 else ""), run, plain,
            library, moved, 2 * E * C * chain_macs(dims))


def expert_kernels(gen, shapes: dict, E: int, timed, checked, model: str,
                   cases=CASES) -> list[dict]:
    """Phases 2 and 3 at one model's expert shapes: ``tt_fused2_experts
    [_int8]`` (one launch across ``E`` experts) against its plain version
    and timed beside it (cold-L2 too), with ``torch.bmm`` over the dense
    expert stacks and the bound, at ``timed`` rows an expert, every case
    of ``cases``, and checked untimed at ``checked``.  One record per
    (kernel, shape, rows, case), marked ``model`` and ``experts``."""
    spec = hw.device_spec(torch.device("cuda"))
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    recs = []
    for label, (dims, per_layer) in shapes.items():
        for C in tuple(timed) + tuple(checked):
            for int8, act in cases:
                kernel, run, plain, library, moved, flops = expert_cases(
                    dims, C, int8, act, gen, E)
                if C in timed:
                    # the plain version loops over the experts, ~10
                    # kernels each: few calls fit the device's queue
                    rec = measure(kernel, label, C, act, per_layer, run,
                                  plain, library, moved, flops, TOL[act],
                                  spec, buf.zero_,
                                  plain_iters=max(1, 80 // E))
                else:
                    rec = check(kernel, label, C, act, run, plain, TOL[act])
                rec.update(length=2, model=model, experts=E)
                recs.append(rec)
    return recs


def mixtral_kernels(gen) -> list[dict]:
    """Phases 2 and 3 at mixtral-8x7b's shapes: ``tt_fused2_experts[_int8]``
    at the three expert projections (8 experts, one launch across them)
    against its plain version and timed beside it (cold-L2 too), with
    ``torch.bmm`` over the dense expert stacks and the bound, at C = 640
    (the 4 × 512 prefill), 128 (an admission at the 256 bucket) and 8
    (decode), every case of ``CASES``, and checked untimed at C = 20 and 1;
    then ``tt_fused2[_int8]`` at the k/v projection at 2,048 and 4 rows.
    One record per (kernel, shape, rows, case), marked ``model:
    mixtral-8x7b``."""
    return (expert_kernels(gen, MIXTRAL_EXPERT_SHAPES, MIXTRAL_E, MIXTRAL_C,
                           MIXTRAL_C_CHECKED, "mixtral-8x7b") +
            fused2_kernels(gen, MIXTRAL_ATTN_SHAPES, "mixtral-8x7b",
                           MIXTRAL_ROWS))


def dsv2_kernels(gen) -> list[dict]:
    """Phases 2 and 3 at deepseek-v2-lite-16b's shapes: ``tt_fused2
    [_int8]`` at its six plain shapes (the ragged 1,368 modes of the dense
    first layer included) at ``ROWS``, and ``tt_fused2_experts[_int8]``
    across 64 experts at C = 256, 128 and 8, checked untimed at C = 1 and
    20.  ``per_layer`` of these records is the launches of one pass."""
    return (fused2_kernels(gen, DSV2_SHAPES, "deepseek-v2-lite-16b") +
            expert_kernels(gen, DSV2_EXPERT_SHAPES, DSV2_E, DSV2_C,
                           DSV2_C_CHECKED, "deepseek-v2-lite-16b"))


def qwen3_kernels(gen) -> list[dict]:
    """``fused2_kernels`` at qwen3-32b's five shapes, at ``ROWS``."""
    return fused2_kernels(gen, QWEN3_SHAPES, "qwen3-32b")


def moe_layer_alone(model, params, args) -> dict:
    """The first MoE layer's ``moe_apply`` at the decode's tokens ([batch,
    1] rows of the model's width), eager, traced alone
    (``replays_alone``): its device kernels, the expert kernel's launches
    and the busy ms per call."""
    gi, bi = next((gi, bi) for gi, (period, _) in enumerate(model.groups)
                  for bi, bd in enumerate(period) if bd.ffn == "moe")
    p = params[f"g{gi}"][0][f"b{bi}"]["ffn"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    h = torch.randn((args.batch, 1, model.cfg.d_model), generator=gen,
                    device="cuda").to(model.param_dtype)
    return replays_alone(lambda: moe.moe_apply(p, model.cfg, h,
                                               model.plan_book),
                         "tt_fused2_experts_kernel", top=6)


def mla_alone(model, params, args) -> dict:
    """The first layer's absorbed-form MLA decode (``mla_decode_attn``: the
    projections, the fp32 casts of ``kv_up`` and of the latent cache, the
    latent scores and context) at the decode's batch over a cache of
    prompt + steps positions at the prompt's length, eager, traced alone
    (``replays_alone``; its q/o ``tt_fused2`` launches counted)."""
    from repro_torch.models.attention import mla_decode_attn
    p = params["g0"][0]["b0"]["attn"]
    m = model.cfg.mla
    T = args.prompt_len + args.steps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dt = model.param_dtype
    h = torch.randn((args.batch, 1, model.cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    ckv = torch.randn((args.batch, T, m.kv_lora), generator=gen,
                      device="cuda").to(dt)
    kr = torch.randn((args.batch, T, m.rope_head_dim), generator=gen,
                     device="cuda").to(dt)
    pos = torch.tensor(args.prompt_len, dtype=torch.int32, device="cuda")
    return replays_alone(lambda: mla_decode_attn(p, model.cfg, h, ckv, kr,
                                                 pos, model.plan_book),
                         "tt_fused2_kernel", top=6)


# phase 5 of each mixture-of-experts family: its serve flags, the fixed
# batch, the arrival mode (None: no arrival run), the staggered run
# (prompt lengths, budgets; cache), the paged block and the chunking, its
# decoder layers, MoE layers and SSD layers, and its ``tt_fused2`` and
# ``tt_fused2_experts`` launches a pass, at full depth and at
# ``MOE_CUT_LAYERS``; deepseek-v2 adds the MLA trace and serve's prefix
# smoke, jamba the SSD mixer's trace
MOE_PATHS = {
    "mixtral-8x7b": dict(
        args=MIXTRAL_ARGS, fixed=MIXTRAL_FIXED, arrival=MIXTRAL_ARRIVAL,
        stagger=STAGGER_64_256, T=STAGGER_64_256_T, block=STAGGER_BLOCK,
        chunk=STAGGER_CHUNK, layers=MIXTRAL_LAYERS,
        moe_layers=MIXTRAL_LAYERS, prefix=None,
        per_pass=(4 * MIXTRAL_LAYERS, 3 * MIXTRAL_LAYERS),
        cut_per_pass=(4 * MOE_CUT_LAYERS, 3 * MOE_CUT_LAYERS)),
    "deepseek-v2-lite-16b": dict(
        args=DSV2_ARGS, fixed=MIXTRAL_FIXED, arrival=MIXTRAL_ARRIVAL,
        stagger=STAGGER_64_256, T=STAGGER_64_256_T, block=STAGGER_BLOCK,
        chunk=STAGGER_CHUNK, layers=DSV2_LAYERS, moe_layers=DSV2_MOE_LAYERS,
        prefix=DSV2_PREFIX,
        per_pass=(sum(n for _, n in DSV2_SHAPES.values()),
                  sum(n for _, n in DSV2_EXPERT_SHAPES.values())),
        # q, o and the dense MLP in layer 0; q, o and the shared experts'
        # 3 in each MoE layer; the experts' 3 in each MoE layer
        cut_per_pass=(5 + 5 * (MOE_CUT_LAYERS - 1),
                      3 * (MOE_CUT_LAYERS - 1))),
    "jamba-v0.1-52b": dict(
        args=JAMBA_ARGS, fixed=FIXED_1024, arrival=None,
        stagger=STAGGER_64_256, T=STAGGER_64_256_T, block=STAGGER_BLOCK,
        chunk=STAGGER_CHUNK, layers=JAMBA_LAYERS,
        moe_layers=JAMBA_MOE_LAYERS, ssm_layers=JAMBA_SSM_LAYERS,
        prefix=None,
        # SSD blocks × 2, GQA blocks × 4, MLPs × 3; MoE layers × 3: 28, 4,
        # 16 and 16 of them, one period 7, 1, 4 and 4
        per_pass=(2 * 28 + 4 * 4 + 3 * 16, 3 * 16),
        cut_per_pass=(2 * 7 + 4 + 3 * 4, 3 * 4)),
}


def moe_prefix_smoke(smi: str, arch: str, model, params, argv) -> dict:
    """serve's prefix smoke (``--prefix-smoke --paged``) on a full-width
    MoE model whose cache is shareable: the second admission shares the
    prefix's blocks and skips their prefill (a resume), the third covers
    its prompt (a copy on write); each request held against
    ``generate_fixed`` where neither side dropped an assignment (the
    resume routes the suffix alone: another capacity), the drops
    printed."""
    sargs = serve.parse_args(argv)
    smoke = serve.prefix_smoke(model, params, sargs)
    smoke.pop("sched")
    greedy = smoke["greedy"]
    held = [u for u, g in greedy.items() if "failed" not in g]
    print(f"{arch} prefix smoke ({smi}): hits (tokens, prefill skipped) "
          f"{smoke['hits']}, {smoke['shared_blocks']} shared blocks, copy "
          f"on write {smoke['cow']}; drops {smoke['drops']} in the "
          f"scheduler's run, " + ", ".join(
              f"request {u} {g['drops']}" for u, g in greedy.items()) +
          f" in generate_fixed's; requests held against generate_fixed "
          f"{held}", flush=True)
    if not smoke["hits"][1][1] or not smoke["hits"][2][0]:
        raise AssertionError(f"{arch} prefix smoke: no hit {smoke['hits']}")
    return {k: smoke[k] for k in ("hits", "blocks", "shared_blocks", "cow",
                                  "admit_ms", "greedy", "drops")}


def moe_path(smi: str, arch: str) -> tuple[dict[str, int], dict]:
    """Phase 5, a full-width mixture-of-experts family (bf16 params from
    seed 0, nothing cut, TT on ffn+attn at rank 16, ``auto``): mixtral-8x7b
    (per pass 128 ``tt_fused2`` for the attention and 96
    ``tt_fused2_experts``, one launch across the 8 experts for each expert
    projection), deepseek-v2-lite-16b (135 ``tt_fused2``: q/o, the dense
    first layer and the shared experts; 78 ``tt_fused2_experts`` across
    64 experts) or jamba-v0.1-52b (120 ``tt_fused2``: the SSD in/out
    projections, the GQA layers' and the MLPs'; 48 ``tt_fused2_experts``
    across 16 experts), with the flags of ``MOE_PATHS[arch]``.

    The fixed batch through ``fixed_family``, fp then int8 cores (every
    projection replayed through its kernel, 0 captures and 0 plan
    resolutions warm; graph ≡ eager bit for bit; the decode and prefill
    replays traced alone, each TT kernel's share), one MoE layer traced
    alone (the MoE's share of a replay), with MLA one layer's decode
    attention alone (its share), and with SSD blocks one SSD mixer's
    decode alone (its share).  Then on one
    fp model at ``MOE_CUT_LAYERS`` layers (``cut_model``) the arrivals
    over the dense pool, the paged one and chunked at 64 (0 captures and
    plan resolutions steady, every TT launch per admission, per decode
    step and per pass of a mixed step replayed; not for jamba), serve's
    prefix smoke where the cache is shareable (hits and skipped prefill
    tokens, drops printed), and the staggered run (``staggered_block``):
    dense graph ≡ eager ≡ paged and chunked graph ≡ eager ≡ paged, bit for
    bit, the prefix counters 0 where the cache is not shareable; chunked ≡
    monolithic and scheduler ≡ ``generate_fixed`` (other token groupings:
    another capacity) asserted where both sides dropped nothing (with SSD
    blocks measured only: the state carries a grouping's bf16 rounding),
    the drops printed either way; with SSD blocks then
    ``fp64_scan_witness``: the dense and chunked runs in fp32 with the
    scan in fp64 and the experts dropless, every request asserted.
    Returns each kernel's launches over the fixed-batch calls and the
    arrival and staggered runs, and the record."""
    cfg = MOE_PATHS[arch]
    t_phase = time.perf_counter()

    def probes(model, params, args, r):
        rp = r["replay"]
        lay = r["moe_layer"] = moe_layer_alone(model, params, args)
        r["moe_share"] = lay["busy_ms"] * cfg["moe_layers"] / rp["busy_ms"]
        line = (f"; one MoE layer alone (eager, {args.batch} tokens): "
                f"{lay['kernels']:g} kernels, {lay['busy_ms']:.4f} ms busy, x "
                f"{cfg['moe_layers']} layers = {r['moe_share']:.1%} of the "
                f"replay; top: " + "; ".join(
                    f"{k} {ms:.4f} ms x{n:g}" for k, ms, n in lay["top"]))
        if model.cfg.ssm is not None:
            lay = r["ssm_layer"] = ssm_alone(model, params, args)
            r["ssm_share"] = lay["busy_ms"] * cfg["ssm_layers"] / \
                rp["busy_ms"]
            line += (f"; one SSD mixer's decode alone (eager, {args.batch} "
                     f"rows): {lay['kernels']:g} kernels, "
                     f"{lay['busy_ms']:.4f} ms busy, of which tt_fused2 "
                     f"{lay['tt_ms']:.4f}, x {cfg['ssm_layers']} = "
                     f"{r['ssm_share']:.1%} of the replay; top: " +
                     "; ".join(f"{k} {ms:.4f} ms x{n:g}"
                               for k, ms, n in lay["top"]))
        if model.cfg.mla is not None:
            lay = r["mla_layer"] = mla_alone(model, params, args)
            r["mla_share"] = lay["busy_ms"] * cfg["layers"] / rp["busy_ms"]
            line += (f"; one layer's MLA decode attention alone: "
                     f"{lay['kernels']:g} kernels, {lay['busy_ms']:.4f} ms "
                     f"busy, x {cfg['layers']} = {r['mla_share']:.1%} of the "
                     f"replay; top: " + "; ".join(
                         f"{k} {ms:.4f} ms x{n:g}" for k, ms, n in lay["top"]))
        return line
    attn, experts = cfg["per_pass"]
    launches, fixed = fixed_family(
        smi, arch, cfg["args"] + cfg["fixed"],
        {"tt_fused2": attn, "tt_fused2_experts": experts}, probes=probes)
    rec = {"card": smi, "fixed": fixed}

    model, params, args = cut_model(cfg["args"] + (cfg["arrival"] or []),
                                    layers=MOE_CUT_LAYERS)
    attn, experts = cfg["cut_per_pass"]
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    T = args.prompt_len + args.steps
    rec["arrival"] = {}
    for pool, extra in (("dense", []), ("paged", PAGED_ARGS),
                        ("chunked", ["--chunk-prefill", "--chunk-size",
                                     "64"])) if cfg["arrival"] else ():
        aargs = serve.parse_args(cfg["args"] + cfg["arrival"] + extra)
        out = serve.simulate(model, params, aargs)
        sched = out.pop("sched")
        if sched.paged:
            sched.allocator.assert_quiescent()
        fin = out["finished"]
        # a mixed step runs its lane's chunk and the decode: two passes
        passes = out["admissions"] + (
            2 * out["mixed_steps"] + out["plain_steps"] if pool == "chunked"
            else out["steps_run"])
        print(f"main path ({arch} at {MOE_CUT_LAYERS} layers, arrival mode, "
              f"{pool} pool, 4 slots x {T}; {smi}): {len(fin)} requests, "
              f"{out['tokens_out']} tokens "
              f"in {out['wall_s']:.3f} s = {out['tok_per_s']:.1f} tok/s; ttft "
              f"p50/p95 {out['ttft_p50_s'] * 1e3:.1f}/"
              f"{out['ttft_p95_s'] * 1e3:.1f} ms; inter-token p50/p95 "
              f"{out['itl_p50_s'] * 1e3:.2f}/{out['itl_p95_s'] * 1e3:.2f} ms; "
              f"drops {out['drops']}; "
              f"{out['admissions']} admissions ({out['admit_share']:.1%} of "
              f"the wall), {out['steps_run']} steps"
              + (f" ({out['mixed_steps']} mixed, {out['prefill_chunks']} "
                 f"chunks)" if pool == "chunked" else "") +
              f"; pool {out['kv_pool_bytes'] / 2**20:.1f} MiB, peak "
              f"{out['peak_bytes'] / 2**30:.3f} GiB; launches "
              f"{out['launches']}", flush=True)
        want = {
            "steady launches": ({"tt_fused2": attn * passes,
                                 "tt_fused2_experts": experts * passes},
                                out["launches"]),
            "steady counted": ({}, out["counted"]),
            "steady captures, prefill captures, plans": ((0, 0, 0), (
                out["captures"], out["prefill_captures"], out["replans"])),
            "requests": (list(range(16)), sorted(f.uid for f in fin)),
        }
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad or any(len(f.tokens) != 64 or f.finish_reason != "length" or
                      int(f.tokens.max()) >= model.cfg.vocab_size or
                      not np.isfinite(f.logprobs).all() for f in fin):
            raise AssertionError(f"{arch} arrival mode ({pool}): (expected,"
                                 f" got) {bad}")
        rec["arrival"][pool] = {k: v for k, v in out.items()
                                if k != "finished"}
    if cfg["prefix"]:
        rec["prefix"] = moe_prefix_smoke(smi, arch, model, params,
                                         cfg["args"] + cfg["prefix"])

    chunk, paged = dict(cfg["chunk"]), dict(paged=True,
                                            block_size=cfg["block"])
    # scheduler ≡ generate_fixed asserted where neither side dropped an
    # assignment (other token groupings: another capacity); with SSD blocks
    # measured only, the state carrying a grouping's bf16 rounding to every
    # later token, and held by ``fp64_scan_witness`` below
    done, rec["staggered"] = staggered_block(
        smi, f"{arch} at {MOE_CUT_LAYERS} layers", model, params,
        cfg["stagger"], cfg["T"], STAGGER_N,
        {"dense graph": (True, {}), "dense eager": (False, {}),
         "paged graph": (True, paged), "chunked graph": (True, chunk),
         "chunked eager": (False, chunk),
         "chunked paged graph": (True, dict(chunk, **paged))},
        [("dense graph", "dense eager"), ("paged graph", "dense graph"),
         ("chunked graph", "chunked eager"),
         ("chunked paged graph", "chunked graph")], ("dense graph",),
        hold=model.cfg.ssm is None)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    for k in ("tt_fused2", "tt_fused2_experts"):
        launches[k] += counted.get(k, 0) + replayed.get(k, 0)
    # chunked ≡ monolithic (another grouping): asserted only where neither
    # run dropped
    drops = {k: rec["staggered"][k]["drops"]
             for k in ("chunked graph", "dense graph")}
    as_mono = rec["staggered"]["chunked_as_monolithic"] = same_runs(
        done["chunked graph"], done["dense graph"])
    print(f"{arch} staggered run: chunked {'=' if as_mono else '!='} "
          f"monolithic (drops {drops['chunked graph']} / "
          f"{drops['dense graph']})", flush=True)
    if not any(drops.values()) and not as_mono:
        raise AssertionError(f"{arch} staggered run: chunked != monolithic "
                             f"without a drop")
    if model.cfg.ssm is not None:
        rec["fp32"] = fp64_scan_witness(
            smi, f"{arch} at {MOE_CUT_LAYERS} layers", model, params,
            cfg["stagger"], cfg["T"], STAGGER_N, cfg["chunk"])
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"{arch} phase 5: {rec['wall_s']:.1f} s", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def fp64_scan_witness(smi: str, name: str, model, params, stagger, T: int,
                      count: int, chunk: dict) -> dict:
    """The scheduler ≡ ``generate_fixed`` witness of a model with SSD
    blocks: its weights cast to fp32 with the SSD scan accumulated in fp64
    (``SSMConfig.scan_dtype``; with bf16 weights, or the reference's fp32
    scan, whose decays are differences of cumulative log-decays, the
    groupings' logprobs end up apart: ``launch.groupings``, PERF.md §7)
    and a mixture of experts made dropless (capacity factor E / top-k:
    every expert takes every token of a call, so no grouping drops an
    assignment), the staggered run dense (bucketed prefill) and chunked at
    ``chunk`` through the graphs (``staggered_block``), every request of
    both held against ``generate_fixed`` within 1e-4 by
    ``serve.check_greedy``'s rule, asserted, and no assignment dropped on
    either side."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, ssm=dataclasses.replace(
        model.cfg.ssm, scan_dtype="float64"))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    m32 = build(cfg, param_dtype=torch.float32)
    p32 = map_tree(lambda t: t.float(), params)
    runs = ("dense graph", "chunked graph")
    _, rec = staggered_block(
        smi, f"{name} in fp32, the scan in fp64"
        f"{', dropless' if cfg.moe else ''} (the same weights)", m32, p32,
        stagger, T, count,
        {"dense graph": (True, {}), "chunked graph": (True, chunk)}, [],
        runs)
    held = {r: sum(not g["drops"] for g in rec["greedy"][r].values())
            for r in runs}
    if any(rec[r]["drops"] for r in runs) or any(
            n != count for n in held.values()):
        raise AssertionError(f"{name} witness: drops "
                             f"{ {r: rec[r]['drops'] for r in runs} }, "
                             f"requests held {held} of {count}")
    rec["wall_s"] = time.perf_counter() - t0
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def qwen3_path(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 5, full-width qwen3-32b (bf16 params from seed 0, nothing cut,
    TT on ffn+attn at rank 16, ``auto``: 448 ``tt_fused2`` a pass): 4 ×
    (256 + 32) through ``fixed_family``, fp then int8 cores.  Returns the
    launches over the fixed-batch calls and the record."""
    t_phase = time.perf_counter()
    launches, fixed = fixed_family(smi, "qwen3-32b", QWEN3_ARGS,
                                   {"tt_fused2": PROJ * QWEN3_LAYERS})
    rec = {"card": smi, "fixed": fixed,
           "wall_s": time.perf_counter() - t_phase}
    print(f"qwen3-32b phase 5: {rec['wall_s']:.1f} s", flush=True)
    return launches, rec


def jamba_kernels(gen) -> list[dict]:
    """Phases 2 and 3 at jamba-v0.1-52b's new shapes, bf16 activations, fp
    and int8 cores: ``tt_fused2[_int8]`` at the SSD in/out projections at
    ``JAMBA_ROWS`` and ``tt_fused2_experts[_int8]`` across 16 experts at
    ``JAMBA_C``, each against its plain version and timed beside it
    (cold-L2 too), with ``torch.matmul`` / ``torch.bmm`` and the bound.
    The records' ``per_layer`` is launches a pass."""
    return (fused2_kernels(gen, JAMBA_SHAPES, "jamba-v0.1-52b", JAMBA_ROWS,
                           cases=BF16_CASES) +
            expert_kernels(gen, JAMBA_EXPERT_SHAPES, JAMBA_E, JAMBA_C, (),
                           "jamba-v0.1-52b", cases=BF16_CASES))


def seamless_kernels(gen) -> list[dict]:
    """``fused2_kernels`` at seamless-m4t-large-v2's three shapes, bf16
    activations, every one timed: at the decode's 4 rows (the records'
    ``per_layer`` is launches a decode pass) and at 256 and 4,096 (a
    prefill pass's)."""
    return [r for i, rows in enumerate(SEAMLESS_ROWS)
            for r in fused2_kernels(
                gen, {k: (dims, n[i]) for k, (dims, n) in
                      SEAMLESS_DIMS.items()}, "seamless-m4t-large-v2", rows,
                cases=BF16_CASES)]


def mamba2_kernels(gen) -> list[dict]:
    """``fused2_kernels`` at mamba2-2.7b's two shapes, at ``MAMBA2_ROWS``,
    every one timed (the records' ``per_layer`` is launches a pass)."""
    return fused2_kernels(gen, MAMBA2_SHAPES, "mamba2-2.7b", MAMBA2_ROWS)


def ssm_alone(model, params, args, masked: bool = False) -> dict:
    """The first layer's SSD mixer decode (``ssm.ssm_decode``: the in/out
    projections' ``tt_fused2``, the conv, the recurrent update of the
    [B, H, N, P] fp32 state: mamba2's [B, 80, 128, 64], jamba's [B, 128,
    16, 64]) at the decode's batch from a random state
    and conv history, eager, traced alone (``replays_alone``); ``masked``
    gates the state and conv writes by an ``active`` mask (the slot pool's
    step; the rows alternate), whose ``torch.where`` kernels are counted
    in ``where`` / ``where_ms``."""
    from repro_torch.models.ssm import ssm_decode
    p = params["g0"][0]["b0"]["ssm"]
    shapes = model.cache_shapes(args.batch, 1)["g0"][0]["b0"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    h = torch.randn((args.batch, 1, model.cfg.d_model), generator=gen,
                    device="cuda").to(model.param_dtype)
    st, cv = (torch.randn(shape, generator=gen, device="cuda").to(dt)
              for shape, dt in (shapes["state"], shapes["conv"]))
    active = (torch.arange(args.batch, device="cuda") % 2 == 0) if masked \
        else None

    def call():
        return ssm_decode(p, model.cfg, h, st, cv, model.plan_book,
                          active=active)
    out = replays_alone(call, "tt_fused2_kernel", top=8)
    if masked:
        w = replays_alone(call, "where_kernel")
        out.update(where=w["tt"], where_ms=w["tt_ms"])
    return out


def mamba2_path(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 5, full-width mamba2-2.7b (bf16 params from seed 0, nothing
    cut, TT on ffn at rank 16, ``auto``: ``tt_fused2`` on each SSD block's
    in/out projections, 128 a pass).

    The fixed batch (``FIXED_1024``: 4 prompts of 1,024 tokens, 4 chunks
    of 256 each) through ``fixed_family``, fp then int8 cores (every
    projection replayed through its kernel, 0 captures and 0 plan
    resolutions warm; graph ≡ eager, the fp32 state included, bit for
    bit; the decode and prefill replays traced alone), and one SSD mixer's
    decode (``ssm_alone``, plain and masked) traced alone: the SSM's plain
    ops' share of a replay.  Then on one fp model the staggered run
    (``MAMBA2_STAGGER``, ``MAMBA2_N`` requests): dense graph ≡ eager ≡
    paged (blocks of 16; the pool holds no arena) and chunked (64) graph ≡
    eager ≡ paged, bit for bit, the prefix counters 0 though the paged
    pools ask for the prefix cache, and the chunked run's requests against
    ``generate_fixed`` measured (bf16: the random weights' rounding is
    carried through 64 layers past the bf16 tolerance,
    ``launch.groupings``, ``PERF.md`` §7).  Then ``fp64_scan_witness``:
    the same weights cast to fp32 with the SSD scan accumulated in fp64,
    the staggered dense (bucketed prefill) and chunked runs through the
    graphs, every request held against ``generate_fixed`` within 1e-4.
    Returns ``tt_fused2``'s and ``tt_fused2_int8``'s launches over the
    fixed-batch calls and the bf16 staggered runs, and the record."""
    t_phase = time.perf_counter()

    def probes(model, params, args, r):
        lay = r["ssm_layer"] = ssm_alone(model, params, args)
        m = r["ssm_layer_masked"] = ssm_alone(model, params, args,
                                              masked=True)
        r["ssm_plain_share"] = (lay["busy_ms"] - lay["tt_ms"]) * \
            MAMBA2_LAYERS / r["replay"]["busy_ms"]
        if lay["tt"] != 2:
            raise AssertionError(f"{lay['tt']} tt_fused2_kernel per SSD "
                                 f"mixer, expected 2")
        return (f"; one SSD mixer's decode alone (eager, {args.batch} "
                f"rows): {lay['kernels']:g} kernels, {lay['busy_ms']:.4f} ms"
                f" busy, of which tt_fused2 {lay['tt_ms']:.4f}; its plain "
                f"ops x {MAMBA2_LAYERS} layers = {r['ssm_plain_share']:.1%} "
                f"of the replay; top: " + "; ".join(
                    f"{k} {ms:.4f} ms x{n:g}" for k, ms, n in lay["top"]) +
                f"; masked by active: {m['kernels']:g} kernels, "
                f"{m['busy_ms']:.4f} ms busy, torch.where {m['where']:g} "
                f"kernels {m['where_ms']:.4f} ms")
    launches, fixed = fixed_family(smi, "mamba2-2.7b",
                                   MAMBA2_ARGS + FIXED_1024,
                                   {"tt_fused2": 2 * MAMBA2_LAYERS},
                                   probes=probes)
    rec = {"card": smi, "fixed": fixed}

    model, params, _ = cut_model(MAMBA2_ARGS, layers=MAMBA2_CUT_LAYERS)
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    paged = dict(paged=True, block_size=STAGGER_BLOCK)
    done, rec["staggered"] = staggered_block(
        smi, f"mamba2-2.7b at {MAMBA2_CUT_LAYERS} layers", model, params,
        MAMBA2_STAGGER, MAMBA2_T,
        MAMBA2_N,
        {"dense graph": (True, {}), "dense eager": (False, {}),
         "paged graph": (True, paged),
         "chunked graph": (True, STAGGER_CHUNK),
         "chunked eager": (False, STAGGER_CHUNK),
         "chunked paged graph": (True, dict(STAGGER_CHUNK, **paged))},
        [("dense graph", "dense eager"), ("paged graph", "dense graph"),
         ("chunked graph", "chunked eager"),
         ("chunked paged graph", "chunked graph")], ("chunked graph",),
        hold=False)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches["tt_fused2"] += counted.get("tt_fused2", 0) + replayed.get(
        "tt_fused2", 0)
    st = rec["staggered"]
    as_mono = rec["staggered"]["chunked_as_monolithic"] = same_runs(
        done["chunked graph"], done["dense graph"])
    print(f"mamba2-2.7b staggered run: paged pool "
          f"{st['paged graph']['kv_pool_bytes'] / 2**20:.1f} MiB, block "
          f"high-water {st['paged graph']['block_high_water']}; chunked: "
          f"{st['chunked graph']['prefill_chunks']} chunks, "
          f"{'=' if as_mono else '!='} monolithic bit for bit", flush=True)

    # the same weights in fp32, the scan in fp64 (with the reference's fp32
    # scan the groupings' logprobs end up to 5.2e-4 apart at 64 layers;
    # with the scan in fp64, 0 and 8.2e-5: PERF.md §7)
    rec["fp32"] = fp64_scan_witness(smi, "mamba2-2.7b", model, params,
                                    MAMBA2_STAGGER, MAMBA2_T, MAMBA2_N,
                                    STAGGER_CHUNK)
    del model, params
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"mamba2-2.7b phase 5: {rec['wall_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def fixed_family(smi: str, name: str, argv: list, per: dict,
                 prefill_per: dict | None = None, probes=None
                 ) -> tuple[dict[str, int], list[dict]]:
    """Phase 5's fixed batch of one full-width family, served from the
    serve flags ``argv`` with fp then int8 cores: ``launch.serve.fixed``
    through ``drive`` (``per``: kernel → its launches a decode pass,
    ``prefill_per`` a prefill pass's where they differ; every one replayed
    through its kernel, 0 captures and 0 plan resolutions warm), beside
    one eager warm run with fp cores (``graph_against_eager``: the
    prefill's logits and cache and the first step's logits bit for bit;
    tok/s, decode step ms, peak memory); then the decode replay and the
    prefill replay traced
    alone (busy ms, each TT kernel's launches and ms, their share, the top
    kernels; each TT kernel's launches must be the pass's); then
    ``probes(model, params, args, rec)``, the family's own layers traced
    alone, which adds its numbers to ``rec`` and returns a line to print.
    Returns each kernel's launches over the calls and the records."""
    launches, recs = {}, []
    for weights in ("fp32", "int8"):
        sfx = "_int8" if weights == "int8" else ""
        model, params, args = cli_model(argv + ["--tt-weights", weights])
        label = (f"{name}, {args.batch} x {args.prompt_len} + "
                 f"{args.steps}, {weights}")
        dec = {k + sfx: v for k, v in per.items()}
        pre = dec if prefill_per is None else {
            k + sfx: v for k, v in prefill_per.items()}
        kernel = next(iter(dec))
        # the eager warm run with fp cores only: int8's would add a minute
        # of host-bound steps over the families to the script's wall
        eager = eager_runs(model, params, args) if not sfx else None
        out, _ = drive(label, kernel, dec[kernel], model, params, args,
                       also={k: v for k, v in dec.items() if k != kernel},
                       prefill_per=pre)
        for k, v in out["path_launches"].items():
            launches[k] = launches.get(k, 0) + v
        r = dict(path=label, launches=out["path_launches"],
                 tok_per_s=out["tok_per_s"], warm_s=out["warm_s"],
                 peak_bytes=out["peak_bytes"], drops=out["drops"],
                 cold_drops=out["cold_drops"],
                 peak_reserved_bytes=out["peak_reserved_bytes"])
        r.update(graph_against_eager(label, model, params, args, out, eager,
                                     smi))
        # each TT kernel of the pass by its device name; tt_fused2's leads
        names = {k: k.removesuffix("_int8") + "_kernel"
                 for k in set(dec) | set(pre)}
        also = sorted(set(names.values()) - {"tt_fused2_kernel"})
        batch = serve.prompt_batch(model, args)
        embeds = model.front_embeds(batch)
        T, tokens = batch["cache_len"], batch["tokens"]
        logits, cache = model.prefill(params, batch)
        step = model.graphed_decode_step(args.batch, T,
                                         enc_T=frames_of(batch))
        step.load(params, cache, args.prompt_len)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        rp = r["replay"] = replays_alone(lambda: step(tok),
                                         "tt_fused2_kernel", top=8,
                                         also=also)
        pre_graph = model.graphed_prefill(*prefill_key(model, args))
        pre_graph(params, tokens, args.prompt_len, embeds)  # cold run's
        torch.cuda.synchronize()
        pp = r["prefill_replay"] = replays_alone(
            lambda: pre_graph(params, tokens, args.prompt_len, embeds),
            "tt_fused2_kernel", top=8, also=also, n=PREFILL_REPLAYS)

        def tt(rep):
            """(launches, ms) of each TT kernel in a replay traced alone."""
            return {n: (rep["tt"], rep["tt_ms"]) if n == "tt_fused2_kernel"
                    else rep["also"][n] for n in set(names.values())}
        r["replay_tt"], r["prefill_tt"] = tt(rp), tt(pp)
        r["tt_share"] = sum(ms for _, ms in r["replay_tt"].values()) / \
            rp["busy_ms"]
        r["prefill_tt_share"] = sum(
            ms for _, ms in r["prefill_tt"].values()) / pp["busy_ms"]
        extra = probes(model, params, args, r) if probes else ""
        def tt_line(counts):
            return ", ".join(f"{n:g} {k} {ms:.3f} ms"
                             for k, (n, ms) in sorted(counts.items()))
        print(f"profile ({label}; {smi}): {REPLAYS} decode replays alone: "
              f"{rp['kernels']:g} device kernels, {tt_line(r['replay_tt'])}"
              f" (TT {r['tt_share']:.1%}), {rp['busy_ms']:.3f} ms busy, "
              f"{rp['wall_ms']:.3f} ms wall per replay; top: " +
              "; ".join(f"{k} {ms:.3f} ms x{n:g}" for k, ms, n in rp["top"])
              + f"; prefill replay of {args.batch} x {args.prompt_len} "
              f"alone ({PREFILL_REPLAYS} replays): {pp['kernels']:g} device "
              f"kernels, "
              f"{pp['busy_ms']:.3f} ms busy, {tt_line(r['prefill_tt'])} (TT "
              f"{r['prefill_tt_share']:.1%}), {pp['wall_ms']:.3f} ms wall; "
              f"top: " + "; ".join(
                  f"{k} {ms:.3f} ms x{n:g}" for k, ms, n in pp["top"]) +
              extra + (f"; MoE drops warm {out['drops']}, cold "
                       f"{out['cold_drops']}" if model.has_moe else ""),
              flush=True)
        want = tuple({names[k]: v for k, v in d.items()} for d in (dec, pre))
        got = tuple({k: n for k, (n, _) in counts.items() if n}
                    for counts in (r["replay_tt"], r["prefill_tt"]))
        if got != want:
            raise AssertionError(f"{label}: TT kernels per decode and "
                                 f"prefill replay {got}, expected {want}")
        recs.append(r)
        del model, params, out, step, cache, pre_graph
        gc.collect()
        torch.cuda.empty_cache()
    return launches, recs


def staggered_block(smi: str, name: str, model, params, stagger, T: int,
                    count: int, modes: dict, same: list, greedy_runs=(),
                    hold: bool = True, rows=0) -> tuple[dict, dict]:
    """Phase 5's staggered run of one family: each of ``modes`` (label →
    (graph, the pool's and chunking's ``Scheduler`` arguments)) through
    ``staggered_full`` over ``count`` requests of ``stagger`` on 4 × ``T``
    (with the front end's inputs of ``rows``, ``stagger_embeds``); the
    runs of each
    pair of ``same`` bit for bit, and the prefix counters 0 where the
    cache is not shareable.  Each request of each of ``greedy_runs``
    (none if the run dropped an MoE assignment) is held against
    ``generate_fixed``
    of its prompt alone (``serve.greedy_against_fixed``), asserted with
    ``hold`` where ``generate_fixed`` dropped none either, measured
    otherwise.  Returns ({label: {uid: finished}}, the record)."""
    runs = {label: staggered_full(model, params, graph, None, stagger, T,
                                  count, rows=rows, **kw)
            for label, (graph, kw) in modes.items()}
    # the captured prefills the runs left, before the checks below add theirs
    prefill_keys = sorted(model.prefill_graphs)
    done = {k: v[0] for k, v in runs.items()}
    st = {k: v[1] for k, v in runs.items()}
    checks = {f"{a} = {b}": same_runs(done[a], done[b]) for a, b in same}
    if not model.supports_prefix_reuse:
        checks["no prefix hit"] = all(
            v.get("prefix_hit_tokens", 0) == v.get(
                "prefill_tokens_skipped", 0) == 0 for v in st.values())
    prompts, _ = stagger_requests(model.cfg.vocab_size, *stagger, count)
    embeds = stagger_embeds(model, count, rows)
    greedy, t0 = {}, time.perf_counter()
    for run in greedy_runs:
        greedy[run] = {}
        for u, f in done[run].items() if not st[run]["drops"] else ():
            moe.reset_drops()
            g = serve.greedy_against_fixed(
                model, params, prompts[u].to(model.device), f, T,
                model.front_embeds(embeds[u]))
            greedy[run][u] = dict(g, drops=moe.read_drops())
    t_greedy = time.perf_counter() - t0

    def held(g):
        return not g["drops"]

    def worst(gs, key):
        return max((g[key] for g in gs.values()), default=0.0)
    summary = "; ".join(
        f"{run} against generate_fixed: {sum(map(held, gs.values()))} of "
        f"{count} requests without a drop on either side, "
        f"{sum(g['identical'] for g in gs.values() if held(g))} of them "
        f"identical, {sum(not g['within'] for g in gs.values() if held(g))}"
        f" outside the tolerance (tol {worst(gs, 'tol'):.3g}), picks within "
        f"{worst(gs, 'slack'):.3g} of the top logit, logprobs within "
        f"{worst(gs, 'logprob_diff'):.3g} over the {len(gs)} measured"
        for run, gs in greedy.items())
    print(f"{name} staggered run ({count} requests, prompts {stagger[0]}, "
          f"budgets {stagger[1]}, 4 x {T}" +
          (f", {rows} {'frames' if model.cfg.enc_dec else 'image rows'}"
           f" each" if rows else "") + f"; {smi}): " +
          ", ".join(f"{k} {v['wall_s']:.3f} s ({v['steps_run']} steps, "
                    f"{v['drops']} drops)" for k, v in st.items()) + "; " +
          ", ".join(f"{k} {'holds' if v else 'FAILS'}"
                    for k, v in checks.items()) +
          (f"; {summary} ({'asserted' if hold else 'measured'}, "
           f"{t_greedy:.1f} s)" if greedy else ""), flush=True)
    if not all(checks.values()) or any(
            len(f.tokens) == 0 for d in done.values() for f in d.values()) \
            or (hold and any(not g["within"] for gs in greedy.values()
                             for g in gs.values() if held(g))):
        raise AssertionError(f"{name} staggered run: {checks}, drops "
                             f"{ {k: v['drops'] for k, v in st.items()} }, "
                             f"greedy {greedy}")
    return done, dict(st, checks=checks, greedy=greedy,
                      prefill_keys=prefill_keys)


def encoder_alone(model, params, args) -> dict:
    """The encoder of the fixed batch's frames (``Model._encode``: the
    dense frontend projection, the non-causal layers, ``enc_norm``),
    eager, traced alone (``replays_alone``): its kernels, busy ms and
    ``tt_fused2``'s."""
    frames = serve.prompt_batch(model, args)["speech_embeds"]
    with torch.no_grad():
        return replays_alone(lambda: model._encode(params, frames),
                             "tt_fused2_kernel", top=6, n=PREFILL_REPLAYS)


def seamless_path(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 5, full-width seamless-m4t-large-v2 (bf16 params from seed 0,
    nothing cut, TT on ffn+attn at rank 16, ``auto``: ``tt_fused2``, 216 a
    decode pass and 432 a prefill pass).

    The fixed batch (``FIXED_1024``: 4 prompts of 1,024 tokens, each with
    1,024 speech frames) through ``fixed_family``, fp then int8 cores, the
    encoder traced alone (``encoder_alone``: its share of the prefill
    replay).  Then at 8 encoder and 8 decoder layers (``cut_model``) the
    staggered run (``STAGGER_64_256``, 256 frames a request) dense and
    paged (blocks of 16; the cross keys and values 'slot' leaves), graph
    and eager (``staggered_block``): dense graph ≡ eager ≡ paged bit for
    bit, prefix counters 0, and every request held against
    ``generate_fixed`` by ``serve.check_greedy``'s rule, asserted (no MoE,
    no SSD state).  Returns ``tt_fused2``'s and ``tt_fused2_int8``'s
    launches over the fixed-batch calls and the staggered runs, and the
    record."""
    t_phase = time.perf_counter()

    def probes(model, params, args, r):
        enc = r["encoder"] = encoder_alone(model, params, args)
        r["encoder_share"] = enc["busy_ms"] / r["prefill_replay"]["busy_ms"]
        if enc["tt"] != 7 * SEAMLESS_LAYERS:
            raise AssertionError(f"{enc['tt']} tt_fused2_kernel in the "
                                 f"encoder, expected {7 * SEAMLESS_LAYERS}")
        return (f"; the encoder alone (eager): {enc['kernels']:g} kernels, "
                f"{enc['busy_ms']:.3f} ms busy ({r['encoder_share']:.1%} of "
                f"the prefill replay), tt_fused2 {enc['tt_ms']:.3f} ms; top: "
                + "; ".join(f"{k} {ms:.3f} ms x{n:g}"
                            for k, ms, n in enc["top"]))
    launches, fixed = fixed_family(
        smi, "seamless-m4t-large-v2", SEAMLESS_ARGS + FIXED_1024,
        SEAMLESS_PER_PASS, SEAMLESS_PREFILL_PER_PASS, probes)
    rec = {"card": smi, "fixed": fixed}
    model, params, args = cut_model(SEAMLESS_ARGS, layers=SEAMLESS_CUT_LAYERS)
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    paged = dict(paged=True, block_size=STAGGER_BLOCK)
    _, rec["staggered"] = staggered_block(
        smi, f"seamless-m4t-large-v2 at {SEAMLESS_CUT_LAYERS} + "
        f"{SEAMLESS_CUT_LAYERS} "
        f"layers", model, params, STAGGER_64_256, STAGGER_64_256_T, STAGGER_N,
        {"dense graph": (True, {}), "dense eager": (False, {}),
         "paged graph": (True, paged), "paged eager": (False, paged)},
        [("dense graph", "dense eager"), ("paged graph", "dense graph"),
         ("paged eager", "paged graph")], ("dense graph",),
        rows=SEAMLESS_FRAMES)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches["tt_fused2"] += counted.get("tt_fused2", 0) + replayed.get(
        "tt_fused2", 0)
    del model, params
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"seamless-m4t-large-v2 phase 5: {rec['wall_s']:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def internvl2_kernels(gen) -> list[dict]:
    """``fused2_kernels`` at internvl2-2b's four shapes, bf16 activations,
    fp and int8 cores, every one timed at ``INTERNVL2_ROWS`` (the records'
    ``per_layer`` is launches a pass)."""
    return fused2_kernels(gen, INTERNVL2_SHAPES, "internvl2-2b",
                          INTERNVL2_ROWS, cases=BF16_CASES)


def image_prefix(model, params, args, r) -> str:
    """internvl2-2b's probe of ``fixed_family``, the image prefix's share
    of the prefill replay: the projector of the fixed batch's image
    embeddings (``Model._project``, eager) traced alone, and the captured
    prefill of as many rows with the least image prefix a prompt takes
    (one image row, the rest tokens) traced alone beside the fixed
    batch's; adds them to ``r`` and returns a line to print."""
    batch = serve.prompt_batch(model, args)
    images, T = batch["image_embeds"], batch["cache_len"]
    with torch.no_grad():
        proj = r["projector"] = replays_alone(
            lambda: model._project(params, images), "tt_fused2_kernel",
            top=3)
    B, S = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (B, S - 1), dtype=np.int64)).to(
        model.device)
    one = serve.random_embeds(model, rng, B, 1)["image_embeds"]
    graph = model.graphed_prefill(B, S - 1, T, 1)
    graph(params, tokens, S, one)                       # its capture
    torch.cuda.synchronize()
    text = r["text_prefill_replay"] = replays_alone(
        lambda: graph(params, tokens, S, one), "tt_fused2_kernel",
        n=PREFILL_REPLAYS)
    full = r["prefill_replay"]["busy_ms"]
    r["projector_share"] = proj["busy_ms"] / full
    r["image_prefill_ratio"] = full / text["busy_ms"]
    if proj["tt"] or text["tt"] != PROJ * model.cfg.num_layers:
        raise AssertionError(f"{proj['tt']} tt_fused2_kernel in the "
                             f"projector, {text['tt']} in the prefill of one "
                             f"image row")
    return (f"; the projector of {B} x {images.shape[1]} image rows alone "
            f"(eager): {proj['kernels']:g} kernels, {proj['busy_ms']:.3f} "
            f"ms busy ({r['projector_share']:.2%} of the prefill replay); "
            f"the prefill replay of 1 image row and {S - 1} tokens alone: "
            f"{text['kernels']:g} kernels, {text['busy_ms']:.3f} ms busy "
            f"(the fixed batch's {r['image_prefill_ratio']:.4f} x it)")


def internvl2_path(smi: str) -> tuple[dict[str, int], dict]:
    """Phase 5, full-width internvl2-2b (bf16 params from seed 0, nothing
    cut, TT on ffn+attn at rank 16, ``auto``: 168 ``tt_fused2`` a decode
    and a prefill pass).

    The fixed batch (``INTERNVL2_FIXED``: 4 prompts of 1,024 image
    embeddings and 1,024 tokens, 64 new tokens) through ``fixed_family``,
    fp then int8 cores, with the image prefix's share of the prefill
    replay (``image_prefix``).  Then at ``INTERNVL2_CUT_LAYERS`` layers
    (``cut_model``) the staggered run (``STAGGER_64_256``, 64 and 128
    image rows by turns, on 4 × ``INTERNVL2_T``) dense and paged (blocks
    of 16), graph and eager (``staggered_block``): dense graph ≡ eager ≡
    paged bit for bit, prefix counters 0, the captured prefills keyed by
    both image counts, and every request held against ``generate_fixed``
    by ``serve.check_greedy``'s rule, asserted (no MoE, no SSD state).
    Returns ``tt_fused2``'s and ``tt_fused2_int8``'s launches over the
    fixed-batch calls and the staggered runs, and the record."""
    t_phase = time.perf_counter()
    launches, fixed = fixed_family(
        smi, "internvl2-2b", INTERNVL2_ARGS + INTERNVL2_FIXED,
        {"tt_fused2": PROJ * INTERNVL2_LAYERS}, probes=image_prefix)
    rec = {"card": smi, "fixed": fixed}
    model, params, _ = cut_model(INTERNVL2_ARGS, layers=INTERNVL2_CUT_LAYERS)
    tt_contract.reset_launch_counts()
    replayed0 = dict(model.replayed_launches)
    paged = dict(paged=True, block_size=STAGGER_BLOCK)
    _, rec["staggered"] = staggered_block(
        smi, f"internvl2-2b at {INTERNVL2_CUT_LAYERS} layers", model, params,
        STAGGER_64_256, INTERNVL2_T, STAGGER_N,
        {"dense graph": (True, {}), "dense eager": (False, {}),
         "paged graph": (True, paged), "paged eager": (False, paged)},
        [("dense graph", "dense eager"), ("paged graph", "dense graph"),
         ("paged eager", "paged graph")], ("dense graph",),
        rows=INTERNVL2_IMAGES)
    counted = tt_contract.launch_counts()
    replayed = serve.since(replayed0, model.replayed_launches)
    launches["tt_fused2"] += counted.get("tt_fused2", 0) + replayed.get(
        "tt_fused2", 0)
    # each admission's bucket leaves room for its image rows
    prompts, _ = stagger_requests(model.cfg.vocab_size, *STAGGER_64_256,
                                  STAGGER_N)
    imgs = [INTERNVL2_IMAGES[i % len(INTERNVL2_IMAGES)]
            for i in range(STAGGER_N)]
    want = sorted({(1, bucket_length(int(p.shape[1]), INTERNVL2_T - n),
                    INTERNVL2_T, n) for p, n in zip(prompts, imgs)})
    keys = rec["staggered"]["prefill_keys"]
    print(f"internvl2-2b staggered run: captured prefills (batch, tokens, "
          f"cache, image rows) {keys}", flush=True)
    if keys != want:
        raise AssertionError(f"internvl2-2b staggered run: prefill graphs "
                             f"{keys}, expected {want}")
    del model, params
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"internvl2-2b phase 5: {rec['wall_s']:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def kernel_line(recs, launches) -> dict:
    """One entry per kernel: one decoder layer's launches of it (7
    projections, summed) at the decode batch in bf16, the main path's
    dominant case, at the length of its main path (fused chain: 3; fused2
    and step: 2), deepseek-7b's layer; for the expert-batched fused2,
    mixtral-8x7b's layer (3 expert projections at 8 rows an expert); errors
    are the worst over every compared case."""
    spec = hw.device_spec(torch.device("cuda"))
    out = []
    for kernel, (source, line) in KERNELS.items():
        length = 3 if kernel.startswith("tt_fused_chain") else 2
        experts = kernel.startswith("tt_fused2_experts")
        mine = [r for r in recs if r["kernel"] == kernel]
        main = [r for r in mine if r["rows"] == (8 if experts else 4) and
                r["act"] == "bfloat16" and r["length"] == length and
                r.get("model", "deepseek-7b") == (
                    "mixtral-8x7b" if experts else "deepseek-7b")]
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
            measured_at=(
                "mixtral-8x7b: one layer's 3 expert projections, 8 experts "
                "x 8 rows (decode), bf16; library: torch.bmm over the "
                "dense expert stacks" if experts else
                "one layer's 7 projections, 4 rows, bf16")))
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

    walls = {"build": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = timed("kernels deepseek", check_and_time, gen)
    layers = layer_summary(recs)
    steps = step_breakdown(recs)
    recs += timed("kernels buckets", check_buckets, gen)
    g_recs = timed("kernels gemma3", gemma3_kernels, gen)
    layers += layer_summary(g_recs, ("tt_fused2", "tt_fused2_int8"),
                            "gemma3-4b")
    recs += g_recs
    m_recs = timed("kernels mixtral", mixtral_kernels, gen)
    layers += layer_summary(m_recs, ("tt_fused2_experts",
                                     "tt_fused2_experts_int8"),
                            "mixtral-8x7b", MIXTRAL_C)
    recs += m_recs
    d_recs = timed("kernels deepseek-v2", dsv2_kernels, gen)
    layers += layer_summary(d_recs, ("tt_fused2", "tt_fused2_int8"),
                            "deepseek-v2-lite-16b", per="pass")
    layers += layer_summary(d_recs, ("tt_fused2_experts",
                                     "tt_fused2_experts_int8"),
                            "deepseek-v2-lite-16b", DSV2_C, per="pass")
    recs += d_recs
    q_recs = timed("kernels qwen3", qwen3_kernels, gen)
    layers += layer_summary(q_recs, ("tt_fused2", "tt_fused2_int8"),
                            "qwen3-32b")
    recs += q_recs
    s_recs = timed("kernels mamba2", mamba2_kernels, gen)
    layers += layer_summary(s_recs, ("tt_fused2", "tt_fused2_int8"),
                            "mamba2-2.7b", MAMBA2_ROWS, per="pass")
    recs += s_recs
    j_recs = timed("kernels jamba", jamba_kernels, gen)
    layers += layer_summary(j_recs, ("tt_fused2", "tt_fused2_int8"),
                            "jamba-v0.1-52b", JAMBA_ROWS, per="pass")
    layers += layer_summary(j_recs, ("tt_fused2_experts",
                                     "tt_fused2_experts_int8"),
                            "jamba-v0.1-52b", JAMBA_C, per="pass")
    recs += j_recs
    e_recs = timed("kernels seamless", seamless_kernels, gen)
    layers += layer_summary(e_recs, ("tt_fused2", "tt_fused2_int8"),
                            "seamless-m4t-large-v2", (4, 256, 4096),
                            per="pass")
    recs += e_recs
    v_recs = timed("kernels internvl2", internvl2_kernels, gen)
    layers += layer_summary(v_recs, ("tt_fused2", "tt_fused2_int8"),
                            "internvl2-2b", INTERNVL2_ROWS, per="pass")
    recs += v_recs
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "records": recs, "layers": layers,
                   "steps": steps}, f, indent=1)
    timed("smoke deepseek", small_input_check)
    timed("smoke scheduler", small_scheduler_check)
    timed("smoke paged", small_paged_check)
    timed("smoke chunked", small_chunked_check)
    timed("smoke gemma3", small_ring_check, "gemma3-4b")
    timed("smoke mixtral", small_ring_check, "mixtral-8x7b")
    timed("smoke deepseek-v2", small_ring_check, "deepseek-v2-lite-16b")
    timed("smoke deepseek-v2 prefix", small_prefix_check,
          "deepseek-v2-lite-16b")
    timed("smoke mamba2", small_ring_check, "mamba2-2.7b", SSM_MODES)
    timed("smoke jamba", small_ring_check, "jamba-v0.1-52b", SSM_MODES)
    timed("smoke seamless", small_ring_check, "seamless-m4t-large-v2",
          SEAMLESS_MODES)
    timed("smoke internvl2", small_ring_check, "internvl2-2b",
          SEAMLESS_MODES)
    launches, graph_recs = timed("deepseek fixed batch", main_paths, smi)
    fused2, sched_rec = timed("deepseek scheduler", scheduler_path, smi)
    launches["tt_fused2"] += fused2
    g_launches, gemma3_rec = timed("gemma3", gemma3_path, smi)
    for k, v in g_launches.items():
        launches[k] += v
    moe_recs = {}
    for arch in MOE_PATHS:
        m_launches, moe_recs[arch] = timed(arch, moe_path, smi, arch)
        for k, v in m_launches.items():
            launches[k] = launches.get(k, 0) + v
    q_launches, qwen3_rec = timed("qwen3-32b", qwen3_path, smi)
    for k, v in q_launches.items():
        launches[k] += v
    s_launches, mamba2_rec = timed("mamba2-2.7b", mamba2_path, smi)
    for k, v in s_launches.items():
        launches[k] += v
    e_launches, seamless_rec = timed("seamless-m4t-large-v2", seamless_path,
                                     smi)
    for k, v in e_launches.items():
        launches[k] += v
    v_launches, internvl2_rec = timed("internvl2-2b", internvl2_path, smi)
    for k, v in v_launches.items():
        launches[k] += v
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "records": recs, "layers": layers,
                   "steps": steps, "graph": graph_recs,
                   "scheduler": sched_rec, "gemma3": gemma3_rec,
                   **moe_recs, "qwen3-32b": qwen3_rec,
                   "mamba2-2.7b": mamba2_rec,
                   "seamless-m4t-large-v2": seamless_rec,
                   "internvl2-2b": internvl2_rec, "walls": walls}, f,
                  indent=1, default=str)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f}s; by "
          f"phase: " + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items()),
          flush=True)

    print(json.dumps(kernel_line(recs, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
