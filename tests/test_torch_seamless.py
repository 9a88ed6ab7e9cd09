"""seamless-m4t-large-v2 (the encoder-decoder: a non-causal GQA encoder
over speech-frame embeddings, a GQA decoder whose every layer
cross-attends to the encoder's output) on the CPU against the reference.

SMOKE (2 encoder and 2 decoder layers, d 64, frames of width 32) through
both packages with TT on ffn+attn at rank 4, ``auto`` backend, so the
self- and cross-attention projections are TT; the reference's Pallas
kernels run in interpret mode.  The fp32 weights are the reference's
``init(PRNGKey(0))``, carried into the port by
``convert.from_jax_params``; int8 quantizes them, bf16 rounds them.  The
tokens and the speech frames are drawn with numpy from a seed; the frames
are bf16, the reference's own input dtype, under fp32 parameters too.
The models are built once per module and variant.

- The registry: FULL's config and layer plan (24 non-causal encoder
  blocks, 24 cross-attending decoder blocks) against the reference's,
  chunked prefill and prefix reuse off, the cache and paged pool with
  xk/xv [.., F, KV, hd] of kind 'slot'; FULL's converted spec shapes
  against the reference's ``abstract_params`` on meta tensors.
- The non-causal self-attention, ``cross_kv``/``cross_attn`` and the
  encoder alone within 1e-5.
- Prefill (exact and bucketed; fp32 and int8 cores) and four greedy decode
  steps: logits within 1e-4, every cache leaf (k, v, xk, xv) within 1e-5,
  tokens identical; ``generate_fixed``'s greedy tokens the reference's;
  int8 codes and scales bit for bit; bf16 parameters within 2e-2 × the
  largest |logit|.
- The dense and paged schedulers (one frame count) against the
  reference's ``Scheduler`` and the port's ``generate_fixed``; paged ≡
  dense bit for bit; chunked prefill refused; a request of another frame
  count refused, at ``submit`` once the pool exists, else at admission;
  an admission reads only the prefill's inputs of a request.
- The serve CLI on ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs import make_layer_plan as jmake_layer_plan
from repro.configs.base import TTConfig as JTTConfig
from repro.models import attention as jattn
from repro.serving.engine import generate_fixed as jgenerate_fixed
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING, PORTED, make_enc_layer_plan
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs import make_layer_plan
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.engine import generate, generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # cache leaves, attention alone, the encoder (fp32)
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
ARCH = "seamless_m4t_large_v2"
FAMS = ("ffn", "attn")
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}


def _tt(cls, weights="fp32", rank=4, min_factor=2):
    return cls(enabled=True, families=FAMS, rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


_built: dict = {}


def _models(variant="fp32"):
    """(reference model, its params, port model, its params) of SMOKE with
    TT on ffn+attn."""
    if variant not in _built:
        weights, dtype = VARIANTS[variant]
        jm = jbuild(jget_config(ARCH, "smoke", tt=_tt(JTTConfig, weights)),
                    param_dtype=getattr(jnp, dtype))
        if variant == "fp32":
            jp = jm.init(jax.random.PRNGKey(0))
        elif weights == "int8":
            jp = jm.quantize_params(_models("fp32")[1])
        else:
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                              _models("fp32")[1])
        tm = tbuild(tget_config(ARCH, "smoke", tt=_tt(TTTConfig, weights)),
                    param_dtype=getattr(torch, dtype), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[variant] = (jm, jp, tm, tp)
    return _built[variant]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int64)


def _frames(B, F, seed, dim=32) -> np.ndarray:
    """Speech frames [B, F, dim], standard normal, as fp32 (each package
    rounds them to bf16 itself: ``_jin``/``_tin``)."""
    return np.random.default_rng(seed + 1000).standard_normal(
        (B, F, dim)).astype(np.float32)


def _jin(tokens, frames) -> dict:
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            "speech_embeds": jnp.asarray(frames, jnp.bfloat16)}


def _tin(tokens, frames) -> dict:
    return {"tokens": torch.from_numpy(tokens),
            "speech_embeds": torch.from_numpy(frames).bfloat16()}


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _layer(tree, i=0):
    """Layer ``i`` of a reference stacked subtree."""
    return jax.tree.map(lambda a: a[i], tree)


def _to_port(jcache, tm) -> dict:
    """A reference dense cache (stacked layers) in the port's layout."""
    out = {"pos": torch.from_numpy(np.array(jcache["pos"]))}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in bd.leaf_names}
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


def _close_logits(tl, jl, what, tol=TOL):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# The registry, the layer plan and the converter
# --------------------------------------------------------------------------

def test_full_config_and_plan_are_the_references():
    cfg, ref = tget_config("seamless-m4t-large-v2", "full"), \
        jget_config(ARCH, "full")
    assert ARCH in PORTED and ARCH not in PENDING
    for f in dataclasses.fields(cfg):
        if f.name not in ("tt", "ssm", "mla", "moe"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert (cfg.num_layers, cfg.num_enc_layers, cfg.d_model, cfg.d_ff,
            cfg.vocab_size, cfg.frontend, cfg.frontend_dim) == (
        24, 24, 1024, 8192, 256206, "speech", 1024)
    dec, enc = jmake_layer_plan(ref)
    for got, want in ((make_layer_plan(cfg), dec),
                      (make_enc_layer_plan(cfg), enc)):
        assert [(tuple((bd.mixer, bd.ffn, bd.cross, bd.causal, bd.window)
                       for bd in p), n) for p, n in got] == [
            (tuple((bd.mixer, bd.ffn, bd.cross, bd.causal, bd.window)
                   for bd in p), n) for p, n in want]
    assert make_enc_layer_plan(tget_config("deepseek-7b", "full")) is None
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    assert not tm.supports_chunked_prefill and not tm.supports_prefix_reuse
    assert tm.windows == [0] and not tm.has_moe
    spec = tm.param_specs()
    assert set(spec["g0"][0]["b0"]) == {"ln1", "attn", "ln_x", "xattn",
                                        "ln2", "ffn"}
    assert set(spec["enc_g0"][0]["b0"]) == {"ln1", "attn", "ln2", "ffn"}
    assert len(spec["enc_g0"]) == 24 and len(spec["g0"]) == 24
    assert spec["frontend_proj"]["w"].shape == (1024, 1024)
    dense = tm.cache_shapes(4, 1088, enc_T=1024)["g0"][23]["b0"]
    assert dense == {"k": ((4, 1088, 16, 64), torch.bfloat16),
                     "v": ((4, 1088, 16, 64), torch.bfloat16),
                     "xk": ((4, 1024, 16, 64), torch.bfloat16),
                     "xv": ((4, 1024, 16, 64), torch.bfloat16)}
    paged = tm.paged_cache_shapes(4, 68, 16, 1088, enc_T=256)["g0"][0]["b0"]
    assert paged["k"] == ((69, 16, 16, 64), torch.bfloat16)
    assert paged["xk"] == ((4, 256, 16, 64), torch.bfloat16)
    assert ttr.block_cache_kinds(tm.groups[0][0][0]) == {
        "k": "paged", "v": "paged", "xk": "slot", "xv": "slot"}
    with pytest.raises(ValueError, match="frame count"):
        tm.cache_shapes(4, 1088)
    with pytest.raises(ValueError, match="frame count"):
        tbuild(tget_config("deepseek-7b", "smoke"),
               device="cpu").cache_shapes(1, 8, enc_T=4)


def _cores(v):
    c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
    return tuple(c0[-3:-1]) + tuple(c1[-3:-1])


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """FULL with TT on ffn+attn at rank 16, length 2, min_factor 8: the
    reference's abstract params through ``from_jax_params`` into meta
    tensors, every key and shape checked, nothing allocated; the three
    fused2 shapes (n1, m1, n2, m2) of the H100 run: q/k/v/o of self- and
    cross-attention (8, 128, 128, 8), gate/up (8, 1024, 128, 8), down (8,
    128, 1024, 8); ``frontend_proj`` and ``lm_head`` dense."""
    jm = jbuild(jget_config(ARCH, "full", tt=_tt(JTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=jnp.bfloat16)
    tm = tbuild(tget_config(ARCH, "full", tt=_tt(TTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=torch.bfloat16, device="cpu")
    abstract = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jm.abstract_params())
    monkeypatch.setattr(convert, "_tensor", lambda arr, dtype, device:
                        torch.empty(arr.shape, dtype=dtype, device="meta"))
    got = from_jax_params(abstract, tm)
    assert len(got["g0"]) == len(got["enc_g0"]) == 24
    dec, enc = got["g0"][23]["b0"], got["enc_g0"][0]["b0"]
    for p in (dec["attn"], dec["xattn"], enc["attn"]):
        for name in "qkvo":
            assert _cores(p[name]) == (8, 128, 128, 8), name
    for p in (dec["ffn"], enc["ffn"]):
        assert _cores(p["gate"]) == _cores(p["up"]) == (8, 1024, 128, 8)
        assert _cores(p["down"]) == (8, 128, 1024, 8)
    assert got["frontend_proj"]["w"].shape == (1024, 1024)
    assert got["lm_head"]["w"].shape == (1024, 256206)
    assert got["enc_norm"]["scale"].shape == dec["ln_x"]["scale"].shape == \
        (1024,)


def test_int8_codes_and_scales_are_the_references():
    """The port's quantizer over the converted fp32 tree and the
    reference's int8 tree, converted: every leaf equal bit for bit (the
    encoder's and the cross-attention's cores included); the frontend
    projection stays dense fp32."""
    _, _, tm, tp = _models("fp32")
    _, _, _, tp8 = _models("int8")
    mine = tm.quantize_params(tp)
    a, b = tree_leaves(mine), tree_leaves(tp8)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert mine["g0"][0]["b0"]["xattn"]["q"]["tt"]["c0"].dtype == torch.int8
    assert mine["enc_g0"][1]["b0"]["attn"]["o"]["tt"]["scales"].shape == (2,)
    assert mine["frontend_proj"]["w"] is tp["frontend_proj"]["w"]


# --------------------------------------------------------------------------
# The encoder and the cross-attention alone
# --------------------------------------------------------------------------

def test_non_causal_self_attention_is_the_references():
    """An encoder block's attention (non-causal, RoPE) on the same fp32
    input [2, 12, 64]: within 1e-5, k/v too; the causal one differs."""
    jm, jp, tm, tp = _models()
    x = np.random.default_rng(1).standard_normal((2, 12, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jy, (jk, jv) = jattn.gqa_self_attn(
        _layer(jp["enc_g0"]["b0"]["attn"]), jm.cfg, jnp.asarray(x),
        jnp.asarray(pos), backend=jm.plan_book, causal=False)
    p = tp["enc_g0"][0]["b0"]["attn"]
    ty, (tk, tv) = tattn.gqa_self_attn(p, tm.cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()),
                                       backend=tm.plan_book, causal=False)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                                   atol=TOL_CACHE)
    causal, _ = tattn.gqa_self_attn(p, tm.cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()),
                                    backend=tm.plan_book)
    assert torch.equal(causal[:, -1], ty[:, -1])
    assert not torch.allclose(causal[:, 0], ty[:, 0], atol=1e-3)


def test_cross_attention_is_the_references():
    """``cross_kv`` of an encoder output [2, 9, 64] and ``cross_attn`` of a
    decoder input [2, 5, 64] to it (no RoPE, every frame): within 1e-5;
    a query's output does not depend on its position."""
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 9, 64)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jpx = _layer(jp["g0"]["b0"]["xattn"])
    jk, jv = jattn.cross_kv(jpx, jm.cfg, jnp.asarray(enc),
                            backend=jm.plan_book)
    jy = jattn.cross_attn(jpx, jm.cfg, jnp.asarray(x), jk, jv,
                          backend=jm.plan_book)
    p = tp["g0"][0]["b0"]["xattn"]
    tk, tv = tattn.cross_kv(p, tm.cfg, torch.from_numpy(enc), tm.plan_book)
    ty = tattn.cross_attn(p, tm.cfg, torch.from_numpy(x), tk, tv,
                          tm.plan_book)
    assert tuple(tk.shape) == (2, 9, 4, 16)
    for got, want in ((tk, jk), (tv, jv), (ty, jy)):
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                                   atol=TOL_CACHE)
    flipped = tattn.cross_attn(p, tm.cfg, torch.from_numpy(x[:, ::-1].copy()),
                               tk, tv, tm.plan_book)
    torch.testing.assert_close(flipped, ty.flip(1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("F", [7, 16])
def test_encoder_is_the_references(F):
    """``Model._encode`` of bf16 frames [2, F, 32] under fp32 parameters:
    within 1e-5 of the reference's; the frames take the parameters' dtype
    exactly, so fp32 frames of the same values give the same bits."""
    jm, jp, tm, tp = _models()
    frames = _frames(2, F, F)
    want = jm._encode(jp, {"speech_embeds": jnp.asarray(frames,
                                                        jnp.bfloat16)})
    bf16 = torch.from_numpy(frames).bfloat16()
    got = tm._encode(tp, bf16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, F, 64)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                               atol=TOL_CACHE)
    assert torch.equal(tm._encode(tp, bf16.float()), got)


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------

PREFILLS = [("fp32", 12, 10, False), ("fp32", 13, 6, True),
            ("int8", 12, 10, False), ("int8", 13, 6, True)]


@pytest.mark.parametrize("variant,S,F,bucketed", PREFILLS,
                         ids=[f"{v}-{S}-frames{F}{'-in-16' if b else ''}"
                              for v, S, F, b in PREFILLS])
def test_prefill_matches_the_reference(variant, S, F, bucketed):
    """Logits within 1e-4 and every cache leaf (k, v and the cross
    attention's xk/xv over the F frames) within 1e-5 into a cache of 32;
    13 tokens bucketed to 16: the encoder still runs at its F."""
    jm, jp, tm, tp = _models(variant)
    tokens, frames = _tokens(2, S, S), _frames(2, F, S)
    if bucketed:
        jl, jc = jm.jitted_prefill_bucketed(32)(jp, _jin(tokens, frames))
        tl, tc = tm.bucketed_prefill(32)(tp, _tin(tokens, frames))
    else:
        jl, jc = jm.jitted_prefill(32)(jp, _jin(tokens, frames))
        tl, tc = tm.prefill(tp, dict(_tin(tokens, frames), cache_len=32))
    _close_logits(tl, jl, "prefill")
    assert int(tc["pos"]) == S
    assert tuple(tc["g0"][1]["b0"]["xk"].shape) == (2, F, 4, 16)
    _close_caches(tc, jc, tm, "prefill")


@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_decode_matches_the_reference(variant):
    """A prompt of 12 with 10 frames into a cache of 24, then 4 greedy
    steps fed the reference's picks: logits within 1e-4, the picks
    identical (the reference's top-1/top-2 gap over ten times the
    tolerance, asserted), the cache within 1e-5 at the end, xk/xv as the
    prefill left them."""
    jm, jp, tm, tp = _models(variant)
    tokens, frames = _tokens(2, 12, 3), _frames(2, 10, 3)
    jl, jc = jm.jitted_prefill(24)(jp, _jin(tokens, frames))
    tl, tc = tm.prefill(tp, dict(_tin(tokens, frames), cache_len=24))
    xk = tc["g0"][0]["b0"]["xk"].clone()
    step = jm.jitted_decode_step()
    for t in range(4):
        ref = _f32(jl)[:, -1]
        tok = ref.argmax(-1)[:, None]
        top2 = np.sort(ref.astype(np.float64), -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * TOL, top2
        np.testing.assert_array_equal(tl.float().numpy()[:, -1].argmax(-1),
                                      tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, f"step {t}")
    _close_caches(tc, jc, tm, "decode")
    assert torch.equal(tc["g0"][0]["b0"]["xk"], xk)


def test_generate_fixed_is_the_references():
    """``generate_fixed``'s greedy tokens over 6 steps identical to the
    reference engine's, logprobs within 1e-4; the scheduler-backed
    ``generate`` (which splits the frames by row) gives the same tokens."""
    jm, jp, tm, tp = _models()
    tokens, frames = _tokens(2, 12, 7), _frames(2, 8, 7)
    ref = jgenerate_fixed(jm, jp, dict(_jin(tokens, frames), cache_len=24),
                          6)
    batch = dict(_tin(tokens, frames), cache_len=24)
    got = generate_fixed(tm, tp, batch, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(ref.logprobs),
                               rtol=TOL, atol=TOL)
    via = generate(tm, tp, batch, 6)
    np.testing.assert_array_equal(via.tokens.numpy(), got.tokens.numpy())
    np.testing.assert_allclose(via.logprobs.numpy(), got.logprobs.numpy(),
                               rtol=0, atol=1e-5)


def test_bf16_prefill_matches_the_reference():
    """bf16 parameters: the prefill's logits within 2e-2 × the largest
    |logit| of the reference's, on bf16 frames (no MoE here, so the whole
    model is held)."""
    jm, jp, tm, tp = _models("bf16")
    tokens, frames = _tokens(2, 12, 11), _frames(2, 10, 11)
    jl, _ = jm.jitted_prefill(16)(jp, _jin(tokens, frames))
    tl, tc = tm.prefill(tp, dict(_tin(tokens, frames), cache_len=16))
    ref = _f32(jl)
    assert tc["g0"][0]["b0"]["xk"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                               atol=TOL_BF16 * np.abs(ref).max())


def test_prefill_needs_the_frames():
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="speech_embeds"):
        tm.prefill(tp, {"tokens": torch.from_numpy(_tokens(1, 4, 0))})


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

SCHED_T, SCHED_F = 48, 12
STAT_NAMES = ("tokens_out", "steps_run", "blocks_in_use", "block_high_water",
              "prefix_hit_tokens", "prefix_prompt_tokens",
              "prefill_tokens_skipped")
PROMPT_LENS, BUDGETS = (40, 24, 8, 20), (5, 6, 4, 3)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=4)}


def _serve(sched, req_cls, to_inputs) -> dict:
    """r0 (40 tokens) is admitted and steps once, then r1 (24) and r2 (8),
    which queues; after the drain r3 (20); every request with 12 frames.
    The slots (uid, blocks) after every step, and the counters."""
    rows = [(_tokens(1, n, 90 + i), _frames(1, SCHED_F, 90 + i))
            for i, n in enumerate(PROMPT_LENS)]
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, list(sched._slot_blocks[i]) if sched.paged else None)
            for i, s in enumerate(sched.slots)])

    def submit(uid):
        sched.submit(req_cls(uid=uid, inputs=to_inputs(*rows[uid]),
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
            "prefix_cache": getattr(sched, "prefix_cache", None),
            "pool": sched.cache}


_port_runs: dict = {}


def _port_run(mode):
    if mode not in _port_runs:
        _, _, tm, tp = _models()
        _port_runs[mode] = _serve(Scheduler(tm, tp, num_slots=2,
                                            cache_len=SCHED_T,
                                            **MODES[mode]), Request, _tin)
    return _port_runs[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_is_the_references(mode):
    """Tokens identical, logprobs within 1e-4, the slots (block ids
    included) after every step and the counters equal; the prefix cache
    is off though asked for, its counters 0; the pool's xk/xv hold 12
    frames a slot."""
    jm, jp, tm, _ = _models()
    mine = _port_run(mode)
    ref = _serve(JScheduler(jm, jp, num_slots=2, cache_len=SCHED_T,
                            **MODES[mode]), JRequest, _jin)
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
    for leaf in tm.slot_leaves(mine["pool"]):
        assert tuple(leaf.shape) == (2, SCHED_F, 4, 16)
    if MODES[mode]:
        assert mine["prefix_cache"] is False
        assert mine["stats"]["prefix_hit_tokens"] == 0


def test_paged_scheduler_is_the_dense_one_and_generate_fixed():
    """Paged ≡ dense bit for bit, and every request's greedy tokens and
    logprobs ``generate_fixed``'s for its prompt and frames alone
    (``serve.check_greedy``)."""
    _, _, tm, tp = _models()
    a, b = _port_run("paged"), _port_run("dense")
    for uid, f in a["done"].items():
        assert np.array_equal(f.tokens, b["done"][uid].tokens)
        assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        tokens, frames = _tokens(1, PROMPT_LENS[uid], 90 + uid), \
            _frames(1, SCHED_F, 90 + uid)
        g = serve.check_greedy(tm, tp, torch.from_numpy(tokens), f,
                               SCHED_T, torch.from_numpy(frames).bfloat16())
        assert g["identical"], g


def test_chunked_prefill_is_refused():
    """As the reference's (``tests/test_chunked.py``): no chunked
    admission path over cross-attention caches, in either package; the
    port's chunk and resume blocks raise on a cross-attending block."""
    jm, jp, tm, tp = _models()
    assert not jm.supports_chunked_prefill and not tm.supports_chunked_prefill
    assert not tm.supports_prefix_reuse
    for sched, model, params in ((JScheduler, jm, jp), (Scheduler, tm, tp)):
        for kw in ({}, dict(paged=True, block_size=4)):
            with pytest.raises(ValueError, match="chunked prefill"):
                sched(model, params, num_slots=1, cache_len=32,
                      chunk_prefill=True, chunk_size=4, **kw)
    bd = tm.groups[0][0][0]
    pool = tm.init_cache(1, 16, per_row=True, enc_T=4)
    x = torch.zeros((1, 4, 64))
    t = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunked prefill"):
        ttr.block_chunk(tp["g0"][0]["b0"], tm.cfg, bd, x,
                        pool["g0"][0]["b0"], t, None, t, t + 4,
                        torch.tensor(True), tm.plan_book)
    with pytest.raises(ValueError, match="prefix-resume"):
        ttr.block_resume(tp["g0"][0]["b0"], tm.cfg, bd, x,
                         pool["g0"][0]["b0"], None, None, t, tm.plan_book)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_request_of_another_frame_count_is_refused(paged):
    """The pool is built at the first admission from its frame count: a
    request of another count queued before it is refused at its admission
    (holding no block), one submitted after at ``submit``; a request
    without frames at ``submit``."""
    _, _, tm, tp = _models()
    kw = dict(paged=True, block_size=4) if paged else {}
    sched = Scheduler(tm, tp, num_slots=2, cache_len=24, **kw)
    assert sched.cache is None and sched.kv_pool_bytes() == 0

    def req(uid, F):
        return Request(uid=uid, inputs=_tin(_tokens(1, 6, uid),
                                            _frames(1, F, uid)),
                       max_new_tokens=3)

    with pytest.raises(ValueError, match="speech_embeds"):
        sched.submit(Request(uid=9, inputs={"tokens": torch.from_numpy(
            _tokens(1, 6, 9))}, max_new_tokens=3))
    sched.submit(req(0, 5))
    sched.submit(req(1, 7))
    with pytest.raises(ValueError, match="7 frames, the pool serves 5"):
        sched.step()
    assert sched.enc_T == 5 and sched.num_active == 1
    if paged:
        assert sched.allocator.in_use == len(sched._slot_blocks[0])
    with pytest.raises(ValueError, match="one frame count"):
        sched.submit(req(2, 6))
    sched.queue.clear()
    done = sched.run()
    assert list(done) == [0] and len(done[0].tokens) == 3


def test_admission_takes_the_prefill_inputs_alone():
    """A request's inputs may carry more than the prefill reads (a batch
    row with its ``cache_len``): the admission takes the tokens and the
    frames, into a cache of the pool's length."""
    _, _, tm, tp = _models()
    inputs = dict(_tin(_tokens(1, 6, 4), _frames(1, 5, 4)), cache_len=8)
    sched = Scheduler(tm, tp, num_slots=1, cache_len=24)
    sched.submit(Request(uid=0, inputs=inputs, max_new_tokens=3))
    got = sched.run()[0]
    want = generate_fixed(tm, tp, dict(inputs, cache_len=24), 3)
    np.testing.assert_array_equal(got.tokens, want.tokens.numpy()[0])


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

CLI = ["--arch", "seamless-m4t-large-v2", "--variant", "smoke", "--tt",
       "ffn,attn", "--tt-rank", "4", "--tt-backend", "auto", "--batch", "2",
       "--prompt-len", "12", "--steps", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [], ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
         "--assert-no-replan"],
    ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
     "--assert-no-replan", "--paged", "--block-size", "4"]],
    ids=["fixed", "arrival-dense", "arrival-paged"])
def test_serve_cli_runs_seamless_on_cpu(extra):
    out = serve.main(CLI + extra)
    if extra:
        assert sorted(f.uid for f in out["finished"]) == [0, 1, 2]
        assert out["replans"] == 0 and out["kv_pool_bytes"] > 0
    else:
        assert tuple(out["tokens"].shape) == (2, 4)
        assert out["replans"] == out["captures"] == 0


def test_serve_cli_prompts_carry_frames():
    """The CLI's batch and arrival requests carry bf16 frames of
    ``--prompt-len`` frames from the prompts' generator."""
    _, _, tm, _ = _models()
    args = serve.parse_args(CLI)
    batch = serve.prompt_batch(tm, args)
    assert batch["speech_embeds"].dtype == torch.bfloat16
    assert tuple(batch["speech_embeds"].shape) == (2, 12, 32)
    req = serve.arrival_request(tm, args, 0, 5)
    assert tuple(req.inputs["speech_embeds"].shape) == (1, 12, 32)
    assert "speech_embeds" not in serve.prompt_batch(
        tbuild(tget_config("deepseek-7b", "smoke"), device="cpu"), args)


@pytest.mark.parametrize("extra", [
    ["--prefix-smoke", "--paged", "--block-size", "4", "--prefix-len", "8"],
    ["--arrival-rate", "100", "--slots", "2", "--max-requests", "2",
     "--chunk-prefill", "--chunk-size", "4"]],
    ids=["prefix-smoke", "chunk-prefill"])
def test_serve_cli_refuses_prefix_smoke_and_chunks(extra):
    with pytest.raises((SystemExit, ValueError)):
        serve.main(CLI + extra)
