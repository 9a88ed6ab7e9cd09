"""jamba-v0.1-52b (the attention/SSM hybrid: periods of Mamba-2 SSD blocks
around one GQA block, each block with a GLU MLP or, every other layer, a
mixture-of-experts FFN) on the CPU against the reference.

SMOKE (4 layers: SSD+MLP, SSD+MoE, GQA+MLP, SSD+MoE; 4 experts top-2 at a
capacity factor of 16, dropless) through both packages, the inputs drawn
with numpy from a seed; the reference's Pallas kernels run in interpret
mode.  The fp32 weights are the port's ``init(0)`` stacked into the
reference's layout (the reference's own init is slow on a CPU), and
carried back into the port by ``convert.from_jax_params``.  TT on ``ffn``
(the SSD in/out projections, the MLPs and the experts) at rank 4,
``auto`` backend.  The reference and port models
are built once per module and variant.

- The registry: FULL is one group of 4 periods (SSD+MLP, SSD+MoE, SSD+MLP,
  SSD+MoE, GQA+MLP, SSD+MoE, SSD+MLP, SSD+MoE), prefix reuse off, chunked
  prefill on, one attention window (full); the paged pool holds arenas
  for the GQA blocks and [num_slots, ...] state for the SSD blocks, as the
  reference's ``test_init_cache_paged_layout``; FULL's converted spec
  shapes against the reference's ``abstract_params`` on meta tensors.
- int8: the reference's quantized tree and the port's quantizer over the
  converted fp32 tree give the same codes and scales, bit for bit.
- Prefill (exact and bucketed, and at an SSD chunk of 4 so the
  inter-chunk scan runs; fp32 and int8 cores) and greedy decode: logits
  within 1e-4, caches within 1e-5, tokens identical, and
  ``generate_fixed``'s greedy tokens the reference's.  With bf16
  parameters each block's prefill output is held within 2e-2 × its
  largest |output|, every token of the dense blocks and, in a MoE block,
  every token whose router margin (its k-th against its (k+1)-th logit) is
  over 2e-2 × the largest |router logit|: below it bf16 rounding decides
  the expert, in either package.  The whole model is not held in bf16: a
  token routed to another expert changes the SSD state every later token
  reads, so neither package's bf16 logits stay within 2e-2 of the
  other's.
- The schedulers, dense, paged (block 4) and chunked over both pools,
  against the reference's ``Scheduler``: tokens identical, logprobs within
  1e-4, slots and block ids after every step and the counters equal, the
  prefix counters 0 with ``prefix_cache`` asked for; within the port
  paged ≡ dense bit for bit and chunked ≡ monolithic.
- A mixed step leaves an inactive row's and a mid-prefill row's SSD state
  and conv history bit for bit (the latter as its chunk alone left them);
  ``copy_blocks`` and the paged splice leave 'slot' leaves alone and write
  the arenas through the table.
- The serve CLI on ``--device cpu``: fixed, arrival over the paged pool
  with chunked prefill, and ``--prefix-smoke`` refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.models import transformer as jtr
from repro.serving.engine import generate_fixed as jgenerate_fixed
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING, PORTED
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import rmsnorm_apply
from repro_torch.models.spec import tree_leaves
from repro_torch.models.ssm import ssm_forward
from repro_torch.serving.engine import generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # cache leaves (fp32)
TOL_BF16 = 2e-2     # × the largest |output|, bf16 parameters
ARCH = "jamba_v0_1_52b"
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}
PERIOD = (("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
          ("gqa", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"))


def _tt(cls, weights="fp32", rank=4, min_factor=2, fams=("ffn",)):
    return cls(enabled=True, families=fams, rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


def _with_chunk(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


_built: dict = {}


def _stacked(params: dict) -> dict:
    """The port's parameter tree in the reference's layout: each group's
    per-layer dicts stacked on a leading layer axis."""
    def leaf(*ts):
        return jnp.asarray(np.stack([t.numpy() for t in ts]))
    return {k: jax.tree.map(leaf, *v) if isinstance(v, list) else
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
            for k, v in params.items()}


def _models(variant="fp32", chunk=256):
    """(reference model, its params, port model, its params) of SMOKE at
    SSD ``chunk``; the fp32 parameters are drawn once, int8 quantizes them,
    bf16 rounds them."""
    key = (variant, chunk)
    if key not in _built:
        weights, dtype = VARIANTS[variant]
        jm = jbuild(_with_chunk(jget_config(ARCH, "smoke", tt=_tt(
            JTTConfig, weights)), chunk), param_dtype=getattr(jnp, dtype))
        if chunk != 256:
            jp = _models(variant)[1]
        elif variant == "fp32":
            jp = _stacked(tbuild(tget_config(ARCH, "smoke", tt=_tt(
                TTTConfig)), device="cpu").init(0))
        elif weights == "int8":
            jp = jm.quantize_params(_models("fp32")[1])
        else:
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                              _models("fp32")[1])
        tm = tbuild(_with_chunk(tget_config(ARCH, "smoke", tt=_tt(
            TTTConfig, weights)), chunk), param_dtype=getattr(torch, dtype),
            device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[key] = (jm, jp, tm, tp)
    return _built[key]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int64)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _to_port(jcache, tm) -> dict:
    """A reference dense cache (stacked layers) in the port's layout."""
    out = {"pos": torch.from_numpy(np.array(jcache["pos"]))}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in bd.cache_names}
            for i, bd in enumerate(period)} for layer in range(count)]
    return out


def _close_caches(mine, jcache, tm, what, tol=TOL_CACHE):
    want = _to_port(jcache, tm)
    assert torch.equal(mine["pos"], want["pos"]), what
    got = tree_leaves({k: v for k, v in mine.items() if k.startswith("g")})
    ref = tree_leaves({k: v for k, v in want.items() if k.startswith("g")})
    assert [t.shape for t in got] == [t.shape for t in ref], what
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=tol,
                                   atol=tol, err_msg=what)


def _close_logits(tl, jl, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=what)


# --------------------------------------------------------------------------
# The registry, the layer plan and the converter
# --------------------------------------------------------------------------

def test_full_is_four_periods_of_seven_ssd_blocks_and_one_gqa():
    cfg = tget_config("jamba-v0.1-52b", "full")
    assert ARCH in PORTED and ARCH not in PENDING
    assert PENDING == ()
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.attn_every,
            cfg.attn_index, cfg.rope_theta) == (32, 4096, 65536, 8, 4, 1e4)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_ff,
            cfg.moe.every_n_layers) == (16, 2, 14336, 2)
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    assert [(tuple((bd.mixer, bd.ffn) for bd in period), n)
            for period, n in tm.groups] == [(PERIOD, 4)]
    assert not tm.supports_prefix_reuse and tm.supports_chunked_prefill
    assert tm.windows == [0] and tm.has_moe
    spec = tm.param_specs()["g0"][0]
    for i, (mixer, ffn) in enumerate(PERIOD):
        assert set(spec[f"b{i}"]) == {"ln1", "attn" if mixer == "gqa"
                                      else "ssm", "ln2", "ffn"}
        assert ("experts" in spec[f"b{i}"]["ffn"]) == (ffn == "moe")
    assert spec["b0"]["ssm"]["in_proj"]["w"].shape == (4096, 16544)
    assert spec["b1"]["ffn"]["router"].shape == (4096, 16)
    dense = tm.cache_shapes(4, 1088)["g0"][3]
    assert dense["b0"] == {"state": ((4, 128, 16, 64), torch.float32),
                           "conv": ((4, 3, 8224), torch.bfloat16)}
    assert dense["b4"]["k"] == ((4, 1088, 8, 128), torch.bfloat16)
    paged = tm.paged_cache_shapes(4, 68, 16, 1088)["g0"][0]
    assert paged["b0"] == dense["b0"]
    assert paged["b4"]["v"] == ((69, 16, 8, 128), torch.bfloat16)


def test_smoke_plan_and_paged_layout_are_the_references():
    """SMOKE's period (attention at index 2, MoE at 1 and 3) and the paged
    pool of the reference's ``test_init_cache_paged_layout``: 2 slots of
    16 positions in 6 blocks of 4, the tables sentinel, the SSD leaves
    slot-indexed and the attention block's arenas 6 + 1 blocks; the
    arenas give the pool's geometry."""
    jm, _, tm, _ = _models()
    assert [(tuple((bd.mixer, bd.ffn) for bd in period), n)
            for period, n in tm.groups] == [((("ssm", "mlp"), ("ssm", "moe"),
                                              ("gqa", "mlp"), ("ssm", "moe")),
                                             1)]
    ref = jm.init_cache(2, 16, paged=True, block=4, num_blocks=6)
    mine = tm.init_cache(2, 16, paged=True, block=4, num_blocks=6)
    assert torch.equal(mine["block_tables"], torch.full((2, 4), 6,
                                                        dtype=torch.int32))
    for i in range(4):
        for name, leaf in ref["g0"][f"b{i}"].items():
            assert tuple(mine["g0"][0][f"b{i}"][name].shape) == \
                leaf.shape[1:], (i, name)
    assert mine["g0"][0]["b0"]["state"].shape[0] == 2
    assert mine["g0"][0]["b2"]["k"].shape[:2] == (7, 4)
    assert tm.arena_geometry(mine) == (6, 4)
    assert len(tm.arena_leaves(mine)) == 2 and len(tm.slot_leaves(mine)) == 6


def _cores(v):
    c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
    return tuple(c0[-3:-1]) + tuple(c1[-3:-1])


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """FULL with TT on ffn+attn at rank 16, length 2, min_factor 8: the
    reference's abstract params through ``from_jax_params`` into meta
    tensors, every key and shape checked, nothing allocated; the SSD
    in_proj at (n1, m1, n2, m2) = (8, 2068, 512, 8), out_proj (8, 512,
    1024, 8), the 16-expert stacks at mixtral's shapes."""
    fams = ("ffn", "attn")
    jm = jbuild(jget_config(ARCH, "full", tt=_tt(
        JTTConfig, rank=16, min_factor=8, fams=fams)),
        param_dtype=jnp.bfloat16)
    tm = tbuild(tget_config(ARCH, "full", tt=_tt(
        TTTConfig, rank=16, min_factor=8, fams=fams)),
        param_dtype=torch.bfloat16, device="cpu")
    abstract = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jm.abstract_params())
    monkeypatch.setattr(convert, "_tensor", lambda arr, dtype, device:
                        torch.empty(arr.shape, dtype=dtype, device="meta"))
    got = from_jax_params(abstract, tm)
    assert len(got["g0"]) == 4
    layer = got["g0"][3]
    ssm = layer["b7"]["ssm"]
    assert _cores(ssm["in_proj"]) == (8, 2068, 512, 8)
    assert _cores(ssm["out_proj"]) == (8, 512, 1024, 8)
    assert ssm["conv_w"].shape == (4, 8224) and ssm["D"].shape == (128,)
    experts = layer["b7"]["ffn"]["experts"]
    assert experts["gate"]["tt"]["c0"].shape[0] == 16
    assert _cores(experts["gate"]) == (8, 1792, 512, 8)
    assert _cores(experts["down"]) == (8, 512, 1792, 8)
    assert _cores(layer["b4"]["attn"]["k"]) == (8, 128, 512, 8)
    assert _cores(layer["b6"]["ffn"]["up"]) == (8, 1792, 512, 8)


def test_int8_codes_and_scales_are_the_references():
    """The port's quantizer over the converted fp32 tree and the
    reference's int8 tree, converted: every leaf equal bit for bit (codes,
    per-core scales and each expert's own scales); only TT cores are
    quantized."""
    _, _, tm, tp = _models("fp32")
    _, _, _, tp8 = _models("int8")
    mine = tm.quantize_params(tp)
    a, b = tree_leaves(mine), tree_leaves(tp8)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    layer = mine["g0"][0]
    assert layer["b1"]["ffn"]["experts"]["gate"]["tt"]["scales"].shape == \
        (4, 2)
    assert layer["b0"]["ssm"]["in_proj"]["tt"]["c0"].dtype == torch.int8
    assert layer["b0"]["ssm"]["conv_w"] is tp["g0"][0]["b0"]["ssm"]["conv_w"]


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------

PREFILLS = [("fp32", 256, 24, False), ("fp32", 256, 13, True),
            ("int8", 256, 24, False), ("fp32", 4, 13, True)]


@pytest.mark.parametrize("variant,chunk,S,bucketed", PREFILLS,
                         ids=[f"{v}-chunk{c}-{S}{'-in-16' if b else ''}"
                              for v, c, S, b in PREFILLS])
def test_prefill_matches_the_reference(variant, chunk, S, bucketed):
    """Logits within 1e-4 and every cache leaf (k/v, fp32 state, conv)
    within 1e-5 into a cache of 48; 13 tokens bucketed to 16 route the
    padding through the experts too (the reference's token set); nothing
    dropped."""
    jm, jp, tm, tp = _models(variant, chunk)
    tokens = _tokens(1 if bucketed else 2, S, S + chunk)
    arrays = {"tokens": jnp.asarray(tokens, jnp.int32)}
    moe.reset_drops()
    if bucketed:
        jl, jc = jm.jitted_prefill_bucketed(48)(jp, arrays)
        tl, tc = tm.bucketed_prefill(48)(tp, {"tokens":
                                              torch.from_numpy(tokens)})
    else:
        jl, jc = jm.jitted_prefill(48)(jp, arrays)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                 "cache_len": 48})
    assert moe.read_drops() == 0
    _close_logits(tl, jl, "prefill")
    assert int(tc["pos"]) == S
    assert tc["g0"][0]["b1"]["state"].dtype == torch.float32
    _close_caches(tc, jc, tm, "prefill")


@pytest.mark.parametrize("i", range(3), ids=["ssm-mlp", "ssm-moe",
                                             "gqa-mlp"])
def test_bf16_block_prefill_matches_the_reference(i):
    """Block ``b{i}`` of SMOKE with bf16 parameters on the same bf16 input
    [2, 12, 64] through each package's ``block_fwd`` (the reference's
    jitted, as its prefill runs it): within 2e-2 × the
    largest |output| at every token of a dense block, and of a MoE block
    at every token the port's router does not hold at a near-tie (no more
    than a quarter of them are)."""
    jm, jp, tm, tp = _models("bf16")
    bd, p = tm.groups[0][0][i], tp["g0"][0][f"b{i}"]
    x = np.random.default_rng(i).standard_normal((2, 12, 64)).astype(
        np.float32)
    xb = torch.from_numpy(x).bfloat16()
    jy = jax.jit(lambda p_, x_: jtr.block_fwd(
        p_, jm.cfg, jm.groups[0][0][i], x_,
        jnp.broadcast_to(jnp.arange(12), (2, 12)), want_cache=False,
        plans=jm.plan_book)[0])(jax.tree.map(lambda a: a[0],
                                             jp["g0"][f"b{i}"]),
                                jnp.asarray(x, jnp.bfloat16))
    ty, _ = ttr.block_fwd(p, tm.cfg, bd, xb, torch.arange(12).expand(2, 12),
                          want_cache=False, plans=tm.plan_book,
                          true_len=torch.tensor(12))
    ref = _f32(jy)
    diff = np.abs(ty.float().numpy() - ref).max(-1)            # [2, 12]
    held = np.ones_like(diff, dtype=bool)
    if bd.ffn == "moe":
        y, _, _ = ssm_forward(p["ssm"], tm.cfg, rmsnorm_apply(
            p["ln1"], xb, tm.cfg.norm_eps), tm.plan_book)
        logits = (rmsnorm_apply(p["ln2"], xb + y, tm.cfg.norm_eps)
                  @ p["ffn"]["router"]).float()
        top = logits.sort(-1, descending=True).values
        k = tm.cfg.moe.top_k
        held = ((top[..., k - 1] - top[..., k]) >
                TOL_BF16 * logits.abs().max()).numpy()
        assert held.mean() >= 0.75, held
    assert diff[held].max() <= TOL_BF16 * np.abs(ref).max(), diff


def test_decode_matches_the_reference():
    """A prompt of 12 into a cache of 32, then 8 greedy steps fed the
    reference's picks: logits within 1e-4, the picks identical (the
    reference's top-1/top-2 gap over ten times the tolerance, asserted),
    the cache within 1e-5 at the end."""
    jm, jp, tm, tp = _models()
    tokens = _tokens(2, 12, 3)
    jl, jc = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 32})
    step = jm.jitted_decode_step()
    moe.reset_drops()
    for t in range(8):
        ref = _f32(jl)[:, -1]
        tok = ref.argmax(-1)[:, None]
        picks = tl.float().numpy()[:, -1].argmax(-1)
        top2 = np.sort(ref.astype(np.float64), -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * TOL, top2
        np.testing.assert_array_equal(picks, tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, f"step {t}")
    assert moe.read_drops() == 0
    _close_caches(tc, jc, tm, "decode")


def test_generate_fixed_is_the_references():
    """``generate_fixed``'s greedy tokens over 10 steps identical to the
    reference engine's, and its logprobs within 1e-4 (the decode test's
    prompt length and cache, whose compiled reference steps it reuses)."""
    jm, jp, tm, tp = _models()
    tokens = _tokens(2, 12, 7)
    ref = jgenerate_fixed(jm, jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                                   "cache_len": 32}, 10)
    got = generate_fixed(tm, tp, {"tokens": torch.from_numpy(tokens),
                                  "cache_len": 32}, 10)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(ref.logprobs),
                               rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

SCHED_T = 48
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks", "chunk_lanes",
              "blocks_in_use", "block_high_water", "prefix_hit_tokens",
              "prefix_prompt_tokens", "prefill_tokens_skipped")
PROMPT_LENS, BUDGETS = (40, 24, 8, 20), (5, 6, 4, 3)
CHUNKS = (5, 13)


def _modes():
    out = {"dense": {}, "paged": dict(paged=True, block_size=4)}
    for c in CHUNKS:
        out[f"chunk{c}-dense"] = dict(chunk_prefill=True, chunk_size=c,
                                      prefill_budget=2 * c)
        out[f"chunk{c}-paged"] = dict(out[f"chunk{c}-dense"], paged=True,
                                      block_size=4)
    return out


MODES = _modes()
# against the reference: each pool, monolithic and in chunks of 13 (which
# split a prompt across the attention block's arena blocks of 4); chunks of
# 5 (two lanes a step) within the port
REF_MODES = ["dense", "paged", "chunk13-dense", "chunk13-paged"]


def _serve(sched, req_cls, to_tokens) -> dict:
    """r0 (40 tokens) is admitted and steps once, then r1 (24) and r2 (8),
    which queues; after the drain r3 (20).  The slots (uid, prompt
    position, blocks) after every step, and the counters."""
    rows = [_tokens(1, n, 90 + i) for i, n in enumerate(PROMPT_LENS)]
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if sched.paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid):
        sched.submit(req_cls(uid=uid, inputs={"tokens": to_tokens(rows[uid])},
                             max_new_tokens=BUDGETS[uid]))

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
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "stats": {k: st[k] for k in STAT_NAMES if k in st},
            "prefix_cache": getattr(sched, "prefix_cache", None)}


_port_runs: dict = {}


def _port_run(mode):
    if mode not in _port_runs:
        _, _, tm, tp = _models()
        moe.reset_drops()
        run = _serve(Scheduler(tm, tp, num_slots=2, cache_len=SCHED_T,
                               **MODES[mode]), Request, torch.from_numpy)
        run["drops"] = moe.read_drops()
        _port_runs[mode] = run
    return _port_runs[mode]


@pytest.mark.parametrize("mode", REF_MODES)
def test_scheduler_is_the_references(mode):
    """Tokens identical, logprobs within 1e-4, the slots (uid, prompt
    position, block ids) after every step and the counters equal; no
    drop; the prefix cache is off though asked for, its counters 0."""
    jm, jp, _, _ = _models()
    mine = _port_run(mode)
    ref = _serve(JScheduler(jm, jp, num_slots=2, cache_len=SCHED_T,
                            **MODES[mode]), JRequest,
                 lambda r: jnp.asarray(r, jnp.int32))
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    assert mine["drops"] == 0
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
    if MODES[mode].get("paged"):
        assert mine["prefix_cache"] is False
        assert mine["stats"]["prefix_hit_tokens"] == 0
        assert mine["stats"]["prefill_tokens_skipped"] == 0


AGREE = [("paged", "dense")] + [
    (f"chunk{c}-paged", f"chunk{c}-dense") for c in CHUNKS] + [
    (f"chunk{c}-{pool}", "dense") for c in CHUNKS
    for pool in ("dense", "paged")]


@pytest.mark.parametrize("run,base", AGREE, ids=[f"{a}={b}"
                                                 for a, b in AGREE])
def test_paths_agree_within_the_port(run, base):
    """Paged ≡ dense: the same calls on the same tokens, bit for bit.
    Chunked ≡ monolithic: other groupings of the prompt, so the sums run
    in another order: tokens identical, logprobs within 1e-5."""
    a, b = _port_run(run), _port_run(base)
    assert sorted(a["done"]) == sorted(b["done"]) == [0, 1, 2, 3]
    for uid, f in a["done"].items():
        np.testing.assert_array_equal(f.tokens, b["done"][uid].tokens)
        if run.startswith("chunk") == base.startswith("chunk"):
            assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        else:
            np.testing.assert_allclose(f.logprobs, b["done"][uid].logprobs,
                                       rtol=TOL_CACHE, atol=TOL_CACHE)


# --------------------------------------------------------------------------
# The mixed pool: 'slot' leaves of other rows stay bit for bit
# --------------------------------------------------------------------------

def _random_pool(tm, paged: bool):
    pool = (tm.init_cache(3, 16, paged=True, block=4) if paged
            else tm.init_cache(3, 16, per_row=True))
    gen = torch.Generator().manual_seed(5)
    for leaf in tm.slot_leaves(pool) + tm.arena_leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    if paged:
        pool["block_tables"].copy_(torch.arange(12, dtype=torch.int32)
                                   .reshape(3, 4))
    return pool


def _clone(pool):
    return {k: ([{b: {n: t.clone() for n, t in leaves.items()}
                  for b, leaves in layer.items()} for layer in v]
                if k.startswith("g") else v.clone())
            for k, v in pool.items()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_step_keeps_inactive_and_mid_prefill_rows(paged):
    """A mixed step on a 3-row pool: row 0 decodes, row 1 takes a chunk of
    4 (mid-prefill, inactive in the decode pass), row 2 is inactive.  Row
    1's state, conv and k/v are bit for bit what its chunk alone leaves;
    row 2's are untouched; row 0's state moved."""
    _, _, tm, tp = _models()
    pool = _random_pool(tm, paged)
    pool["pos"].copy_(torch.tensor([6, 4, 9], dtype=torch.int32))
    chunk = torch.from_numpy(_tokens(1, 4, 70))
    table = pool["block_tables"][1].clone() if paged else None
    alone = _clone(pool)
    tm.chunk_step(tp, alone, chunk, 1, 4, 4, True, table=table)
    before = _clone(pool)
    _, _, pool = tm.mixed_step(tp, pool, torch.tensor([[3], [0], [0]]),
                               torch.tensor([True, False, False]), chunk,
                               torch.tensor([1], dtype=torch.int32),
                               torch.tensor([4], dtype=torch.int32),
                               torch.tensor([4], dtype=torch.int32),
                               torch.tensor([True]),
                               None if table is None else table[None])
    assert pool["pos"].tolist() == [7, 8, 9]
    for got, solo, old in zip(tm.slot_leaves(pool), tm.slot_leaves(alone),
                              tm.slot_leaves(before)):
        assert torch.equal(got[1], solo[1])
        assert torch.equal(got[2], old[2])
        assert not torch.equal(got[0], old[0])
    if paged:
        # row 1's blocks 4..7 (its chunk wrote block 5), row 2's 8..11
        for got, solo, old in zip(tm.arena_leaves(pool),
                                  tm.arena_leaves(alone),
                                  tm.arena_leaves(before)):
            assert torch.equal(got[4:8], solo[4:8])
            assert torch.equal(got[8:12], old[8:12])
    else:
        for got, solo, old in zip(tm.arena_leaves(pool),
                                  tm.arena_leaves(alone),
                                  tm.arena_leaves(before)):
            assert torch.equal(got[1], solo[1])
            assert torch.equal(got[2], old[2])


def test_copy_blocks_and_paged_splice_keep_slot_leaves_apart():
    """``copy_blocks`` copies the attention arenas' block and touches no
    'slot' leaf; ``splice_cache_paged`` writes row ``slot``'s state and
    conv, and the prefill's k/v into the arena blocks its table names,
    with the row's table and position."""
    _, _, tm, tp = _models()
    pool = _random_pool(tm, paged=True)
    before = [t.clone() for t in tm.slot_leaves(pool)]
    tm.copy_blocks(pool, 0, 2)
    for got, old in zip(tm.slot_leaves(pool), before):
        assert torch.equal(got, old)
    for arena in tm.arena_leaves(pool):
        assert torch.equal(arena[2], arena[0])
    _, row = tm.prefill(tp, {"tokens": torch.from_numpy(_tokens(1, 9, 60)),
                             "cache_len": 16})
    table = torch.tensor([4, 5, 6, 12], dtype=torch.int32)
    tm.splice_cache_paged(pool, row, 1, table)
    for got, old, new in zip(tm.slot_leaves(pool), before,
                             tm.slot_leaves(row)):
        assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
        assert torch.equal(got[1], new[0])
    for arena, dense in zip(tm.arena_leaves(pool), tm.arena_leaves(row)):
        assert torch.equal(arena[4:7].reshape(12, *arena.shape[2:]),
                           dense[0, :12])
    assert int(pool["pos"][1]) == 9
    assert torch.equal(pool["block_tables"][1], table)


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

CLI = ["--arch", "jamba-v0.1-52b", "--variant", "smoke", "--tt", "ffn",
       "--tt-rank", "4", "--tt-backend", "auto", "--batch", "2",
       "--prompt-len", "12", "--steps", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [], ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
         "--assert-no-replan", "--paged", "--block-size", "4",
         "--chunk-prefill", "--chunk-size", "5", "--prefill-budget", "10"]],
    ids=["fixed", "arrival-paged-chunked"])
def test_serve_cli_runs_jamba_on_cpu(extra):
    out = serve.main(CLI + extra)
    assert out["drops"] == 0
    if extra:
        assert sorted(f.uid for f in out["finished"]) == [0, 1, 2]
        assert out["prefill_chunks"] > 0 and out["replans"] == 0
    else:
        assert tuple(out["tokens"].shape) == (2, 4)
        assert out["replans"] == out["captures"] == 0


def test_serve_cli_prefix_smoke_refuses_jamba():
    """The SSD blocks' state summarizes the whole history: no prefix is
    shared, and the prefix smoke says so."""
    with pytest.raises(SystemExit, match="prefix blocks can be shared"):
        serve.main(CLI + ["--prefix-smoke", "--paged", "--block-size", "4",
                          "--prefix-len", "8"])
