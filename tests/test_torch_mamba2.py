"""mamba2-2.7b (attention-free, every layer a Mamba-2 SSD mixer with no
FFN) on the CPU against the reference.

SMOKE through both packages, the reference's weights carried into the
port by ``convert.from_jax_params`` and the inputs drawn with numpy from a
seed; the reference's Pallas kernels run in interpret mode.  TT on
``ffn`` (the in/out projections) at rank 4, ``auto`` backend.  SMOKE's
``chunk`` of 256 holds every test prompt in one chunk, so the inter-chunk
scan is also run with ``chunk`` replaced by 4 on both sides.

- The registry: FULL's 64 SSM blocks, prefix reuse off and chunked
  prefill on, no attention window; the fp32 state and the 'slot' leaves
  of a paged pool with no arena; FULL's converted spec shapes against the
  reference's ``abstract_params`` (meta tensors), in/out proj at
  n (8, 320) m (1322, 8) and n (8, 640) m (320, 8); the int8 quantizer
  touches only the TT cores.
- ``ssd_chunked`` (chunk ≥ S, chunk 4, a prime S, a given ``s0``, two
  groups), ``ssm_forward`` (bucketed ``true_len``, resumed with
  ``conv_hist`` and ``s0``) and ``ssm_decode`` (with and without
  ``active``) against the reference's within 1e-5; an inactive row's
  state and conv bit for bit.  ``softplus`` differs in form (torch returns
  x past 20, JAX ``logaddexp(x, 0)``): they agree within fp32 rounding,
  inside the 1e-5.
- SMOKE prefill (exact and bucketed) and 16 greedy decode steps, fp32,
  int8 and bf16 params, at chunk 256 and 4: logits within 1e-4 (bf16:
  2e-2 × the largest |logit|), tokens identical, state and conv within
  1e-5; the bucketed prefill against the unpadded one.
- The schedulers, dense, paged and chunked (chunks 1, 3, 4, 5 and 13 over
  both pools), on a staggered schedule against the reference's
  ``Scheduler``: tokens identical, logprobs within 1e-4, the slots and
  block ids after every step and the counters equal, prefix counters 0
  with ``prefix_cache`` asked for; within the port paged ≡ dense bit for
  bit and chunked ≡ monolithic (tokens identical, logprobs within 1e-5).
- Masked decode, an inactive chunk lane, ``copy_blocks`` and
  ``splice_cache_paged`` leave other slots' 'slot' leaves bit for bit.
- ``launch.groupings`` (the exact, bucketed and chunked prefills of one
  prompt against each other, by depth and dtype) on SMOKE: in fp32 the
  three groupings within 1e-5 of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.models import ssm as jssm
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING, PORTED
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import groupings, serve
from repro_torch.models import ssm as tssm
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_SSM = 1e-5      # one SSM function's outputs, state and conv (fp32)
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
ARCH = "mamba2_2p7b"
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}


def _tt(cls, weights="fp32", rank=4, min_factor=2):
    return cls(enabled=True, families=("ffn",), rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


def _with_chunk(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


_built: dict = {}


def _models(variant="fp32", chunk=256):
    """(reference model, its params, port model, its params) of SMOKE at
    ``chunk``; the fp32 parameters are drawn once, int8 quantizes them,
    bf16 rounds them."""
    key = (variant, chunk)
    if key not in _built:
        weights, dtype = VARIANTS[variant]
        jm = jbuild(_with_chunk(jget_config(ARCH, "smoke", tt=_tt(
            JTTConfig, weights)), chunk), param_dtype=getattr(jnp, dtype))
        if chunk != 256:
            jp = _models(variant)[1]
        elif variant == "fp32":
            jp = jm.init(jax.random.PRNGKey(0))
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


def _close(a, b, what, tol=TOL_SSM):
    got = np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                     else a, dtype=np.float32)
    ref = _f32(b)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


def _to_port(jcache, tm) -> dict:
    """A reference cache (stacked layers) in the port's layout."""
    out = {k: torch.from_numpy(np.array(jcache[k]))
           for k in ("pos", "block_tables") if k in jcache}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in bd.cache_names}
            for i, bd in enumerate(period)} for layer in range(count)]
    return out


def _close_caches(mine, jcache, tm, what, tol=TOL_SSM):
    want = _to_port(jcache, tm)
    assert torch.equal(mine["pos"], want["pos"]), what
    got = tree_leaves({k: v for k, v in mine.items() if k.startswith("g")})
    ref = tree_leaves({k: v for k, v in want.items() if k.startswith("g")})
    assert [t.shape for t in got] == [t.shape for t in ref], what
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=tol,
                                   atol=tol, err_msg=what)


def _close_logits(tl, jl, variant, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    tol = TOL_BF16 * np.abs(ref).max() if variant == "bf16" else TOL
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _gap_ok(logits: np.ndarray, tol: float = TOL) -> None:
    top2 = np.sort(logits.astype(np.float64), -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]).min()
    assert gap > 10 * tol, gap


# --------------------------------------------------------------------------
# The registry and the converter
# --------------------------------------------------------------------------

def test_full_is_64_ssm_blocks_with_slot_state():
    cfg = tget_config("mamba2-2.7b", "full")
    assert "mamba2_2p7b" in PORTED and "mamba2_2p7b" not in PENDING
    s = cfg.ssm
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size,
            cfg.tie_embeddings) == (64, 2560, 50280, False)
    assert (s.d_state, s.d_conv, s.expand, s.head_dim, s.n_groups,
            s.chunk) == (128, 4, 2, 64, 1, 256)
    assert tssm.ssm_dims(cfg) == (5120, 80, 5376)
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    assert [(tuple((bd.mixer, bd.ffn) for bd in period), n)
            for period, n in tm.groups] == [((("ssm", "none"),), 64)]
    assert not tm.supports_prefix_reuse and tm.supports_chunked_prefill
    assert tm.windows == [] and not tm.has_moe
    assert tm.cache_shapes(4, 1088)["g0"][63]["b0"] == {
        "state": ((4, 80, 128, 64), torch.float32),
        "conv": ((4, 3, 5376), torch.bfloat16)}
    paged = tm.paged_cache_shapes(4, 68, 16, 1088)
    assert paged["g0"][0]["b0"] == {
        "state": ((4, 80, 128, 64), torch.float32),
        "conv": ((4, 3, 5376), torch.bfloat16)}
    assert paged["block_tables"] == ((4, 68), torch.int32)
    spec = tm.param_specs()
    block = spec["g0"][0]["b0"]
    assert set(block) == {"ln1", "ssm"}
    assert block["ssm"]["in_proj"]["w"].shape == (2560, 10576)
    assert block["ssm"]["out_proj"]["w"].shape == (5120, 2560)
    assert block["ssm"]["conv_w"].shape == (4, 5376)
    assert block["ssm"]["norm"]["scale"].shape == (5120,)
    assert spec["lm_head"]["w"].shape == (2560, 50280)


@pytest.mark.parametrize("arch", ["internvl2-2b"])
def test_other_families_still_raise(arch):
    """The last family resolves now: no architecture raises."""
    assert tget_config(arch).frontend == "vit"


def _cores(v):
    c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
    return tuple(c0[-3:-1]) + tuple(c1[-3:-1])


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """FULL with TT on ffn at rank 16, length 2, min_factor 8: the
    reference's abstract params through ``from_jax_params`` into meta
    tensors, every key and shape checked, nothing allocated; in/out proj
    are the two fused2 shapes of the H100 run, (n1, m1, n2, m2)."""
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
    assert len(got["g0"]) == 64
    ssm = got["g0"][63]["b0"]["ssm"]
    assert _cores(ssm["in_proj"]) == (8, 1322, 320, 8)
    assert _cores(ssm["out_proj"]) == (8, 320, 640, 8)
    assert ssm["conv_w"].shape == (4, 5376) and ssm["D"].shape == (80,)


def test_int8_quantizes_only_the_projections():
    """int8 cores: in/out proj quantized, ``conv_w``, ``conv_b``,
    ``A_log``, ``D``, ``dt_bias`` and ``norm`` the very leaves of the
    fp32 tree; the reference's int8 tree converts to the same layout."""
    _, _, tm, tp = _models("fp32")
    q = tm.quantize_params(tp)
    for layer in range(2):
        a, b = tp["g0"][layer]["b0"]["ssm"], q["g0"][layer]["b0"]["ssm"]
        for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
            assert b[name] is a[name]
        assert b["norm"]["scale"] is a["norm"]["scale"]
        for proj in ("in_proj", "out_proj"):
            assert b[proj]["tt"]["c0"].dtype == torch.int8
            assert b[proj]["tt"]["scales"].shape == (2,)
    _, _, _, tp8 = _models("int8")
    assert tp8["g0"][1]["b0"]["ssm"]["in_proj"]["tt"]["c1"].dtype == \
        torch.int8


# --------------------------------------------------------------------------
# The SSM functions against the reference's
# --------------------------------------------------------------------------

SSD_CASES = [  # (B, S, H, P, G, N, chunk, s0)
    (2, 12, 4, 8, 1, 6, 256, False), (2, 12, 4, 8, 1, 6, 4, False),
    (1, 13, 4, 8, 1, 6, 4, False), (2, 16, 6, 4, 2, 5, 5, True),
    (2, 12, 4, 8, 1, 6, 4, True)]


@pytest.mark.parametrize("acc", [torch.float32, torch.float64],
                         ids=["fp32-scan", "fp64-scan"])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,s0", SSD_CASES, ids=[
    "one-chunk", "chunk4", "prime13-L1", "groups2-chunk5-s0", "chunk4-s0"])
def test_ssd_chunked_is_the_references(B, S, H, P, G, N, chunk, s0, acc):
    """Within 1e-5 of the reference's fp32 scan, accumulated in fp32 (its
    arithmetic) or in fp64 (``SSMConfig.scan_dtype``); y in x's dtype and
    the state in fp32 either way."""
    rng = np.random.default_rng(S * 7 + chunk)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    st = rng.standard_normal((B, H, N, P)).astype(np.float32) if s0 \
        else None
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                              s0=None if st is None else jnp.asarray(st))
    ty, ts = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                              chunk, s0=None if st is None else
                              torch.from_numpy(st), acc=acc)
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy, "y")
    _close(ts, js, "state")


def _ssm_layer(layer=0, variant="fp32"):
    jm, jp, tm, tp = _models(variant)
    jl = jax.tree.map(lambda a: a[layer], jp["g0"]["b0"]["ssm"])
    return jm, jl, tm, tp["g0"][layer]["b0"]["ssm"]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_ssm_forward_bucketed_is_the_references():
    """A prompt of 11 right-padded to 16 with ``true_len`` 11: output (the
    true rows), state and conv tail within 1e-5 of the reference's, and
    of the port's own unpadded pass."""
    jm, jl, tm, tl = _ssm_layer()
    x = _x((2, 16, 64), 20)
    jy, js, jc = jssm.ssm_forward(jl, jm.cfg, jnp.asarray(x), jm.plan_book,
                                  true_len=jnp.int32(11))
    ty, ts, tc = tssm.ssm_forward(tl, tm.cfg, torch.from_numpy(x),
                                  tm.plan_book,
                                  true_len=torch.tensor(11,
                                                        dtype=torch.int32))
    _close(ty[:, :11], jy[:, :11], "y")
    _close(ts, js, "state")
    _close(tc, jc, "conv tail")
    uy, us, uc = tssm.ssm_forward(tl, tm.cfg, torch.from_numpy(x[:, :11]),
                                  tm.plan_book)
    for a, b, what in ((ty[:, :11], uy, "y"), (ts, us, "state"),
                       (tc, uc, "conv tail")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL_SSM,
                                   atol=TOL_SSM, err_msg=what)


@pytest.mark.parametrize("true_len", [2, 5], ids=["short", "full"])
def test_ssm_forward_resumed_is_the_references(true_len):
    """A chunk of 5 (``true_len`` of them real) resumed from a carried
    state and conv history; 2 real rows takes part of the tail from the
    history."""
    jm, jl, tm, tl = _ssm_layer(1)
    x = _x((1, 5, 64), 21)
    s0, hist = _x((1, 8, 16, 16), 22), _x((1, 3, 160), 23)
    jy, js, jc = jssm.ssm_forward(jl, jm.cfg, jnp.asarray(x), jm.plan_book,
                                  true_len=jnp.int32(true_len),
                                  s0=jnp.asarray(s0),
                                  conv_hist=jnp.asarray(hist))
    ty, ts, tc = tssm.ssm_forward(
        tl, tm.cfg, torch.from_numpy(x), tm.plan_book,
        true_len=torch.tensor(true_len, dtype=torch.int32),
        s0=torch.from_numpy(s0), conv_hist=torch.from_numpy(hist))
    _close(ty[:, :true_len], jy[:, :true_len], "y")
    _close(ts, js, "state")
    _close(tc, jc, "conv tail")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
def test_ssm_decode_is_the_references(masked):
    """One step from a random state and conv history, in place; with
    ``active`` = [True, False, True] the second row keeps both bit for
    bit (the reference's ``block_decode`` mask)."""
    jm, jl, tm, tl = _ssm_layer()
    x = _x((3, 1, 64), 30)
    st, cv = _x((3, 8, 16, 16), 31), _x((3, 3, 160), 32)
    jy, js, jc = jssm.ssm_decode(jl, jm.cfg, jnp.asarray(x), jnp.asarray(st),
                                 jnp.asarray(cv), jm.plan_book)
    active = np.array([True, False, True])
    if masked:
        a = jnp.asarray(active)
        js = jnp.where(a[:, None, None, None], js, st)
        jc = jnp.where(a[:, None, None], jc, cv)
    tst, tcv = torch.from_numpy(st.copy()), torch.from_numpy(cv.copy())
    ty, s2, c2 = tssm.ssm_decode(tl, tm.cfg, torch.from_numpy(x), tst, tcv,
                                 tm.plan_book,
                                 active=torch.from_numpy(active) if masked
                                 else None)
    assert s2 is tst and c2 is tcv
    _close(ty, jy, "y")
    _close(tst, js, "state")
    _close(tcv, jc, "conv")
    if masked:
        assert np.array_equal(tst[1].numpy(), st[1])
        assert np.array_equal(tcv[1].numpy(), cv[1])


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------

PREFILLS = [(v, c, S, b) for c in (256, 4) for v, S, b in (
    ("fp32", 24, False), ("fp32", 13, True), ("int8", 24, False),
    ("int8", 13, True), ("bf16", 24, False), ("bf16", 13, True))]


@pytest.mark.parametrize("variant,chunk,S,bucketed", PREFILLS,
                         ids=[f"{v}-chunk{c}-{S}{'-in-16' if b else ''}"
                              for v, c, S, b in PREFILLS])
def test_prefill_matches_the_reference(variant, chunk, S, bucketed):
    """Logits, state and conv into a cache of 48; 13 tokens bucketed to 16
    (at chunk 4 a chunk length of 4 over 4 chunks, where the exact 13 would
    take 1)."""
    jm, jp, tm, tp = _models(variant, chunk)
    tokens = _tokens(1 if bucketed else 2, S, S + chunk)
    arrays = {"tokens": jnp.asarray(tokens, jnp.int32)}
    if bucketed:
        jl, jc = jm.jitted_prefill_bucketed(48)(jp, arrays)
        tl, tc = tm.bucketed_prefill(48)(tp, {"tokens":
                                              torch.from_numpy(tokens)})
    else:
        jl, jc = jm.jitted_prefill(48)(jp, arrays)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                 "cache_len": 48})
    _close_logits(tl, jl, variant, "prefill")
    assert int(tc["pos"]) == S
    assert tc["g0"][0]["b0"]["state"].dtype == torch.float32
    if variant == "bf16":
        top = max(float(t.abs().max()) for t in tree_leaves(
            _to_port(jc, tm)))
        _close_caches(tc, jc, tm, "prefill", tol=TOL_BF16 * top)
    else:
        _close_caches(tc, jc, tm, "prefill")


@pytest.mark.parametrize("chunk", [256, 4])
def test_bucketed_prefill_is_the_unpadded_one(chunk):
    """13 tokens padded to 16 against the exact 13 (another chunk length
    at chunk 4): logits within 1e-5, state and conv within 1e-5, the
    greedy pick identical."""
    _, _, tm, tp = _models("fp32", chunk)
    tokens = torch.from_numpy(_tokens(1, 13, 40))
    bl, bc = tm.bucketed_prefill(48)(tp, {"tokens": tokens})
    ul, uc = tm.prefill(tp, {"tokens": tokens, "cache_len": 48})
    np.testing.assert_allclose(bl.numpy(), ul.numpy(), rtol=0, atol=TOL_SSM)
    assert int(bl.argmax()) == int(ul.argmax())
    for a, b in zip(tree_leaves(bc), tree_leaves(uc)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=TOL_SSM, atol=TOL_SSM)


DECODE_SEED, STEPS = 3, 16
DECODES = [("fp32", 256), ("int8", 256), ("fp32", 4), ("int8", 4),
           ("bf16", 256), ("bf16", 4)]


@pytest.mark.parametrize("variant,chunk", DECODES,
                         ids=[f"{v}-chunk{c}" for v, c in DECODES])
def test_decode_matches_the_reference(variant, chunk):
    """A prompt of 12 into a cache of 32, then 16 greedy steps fed the
    reference's picks: logits within 1e-4 and tokens identical (the
    reference's top-1/top-2 gap over ten times the tolerance), the state
    and conv within 1e-5 at the end.  bf16 parameters: 8 steps (as
    ``tests/test_torch_model_bf16.py`` runs them; both sides round at other
    places, and the recurrent state carries the difference on), logits
    within 2e-2 × the largest |logit|, and the pick identical at every
    step whose gap is over that tolerance (bf16 logits tie)."""
    jm, jp, tm, tp = _models(variant, chunk)
    tokens = _tokens(2, 12, DECODE_SEED)
    jl, jc = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 32})
    _close_logits(tl, jl, variant, "prefill")
    step = jm.jitted_decode_step()
    for t in range(STEPS // 2 if variant == "bf16" else STEPS):
        ref = _f32(jl)[:, -1]
        tok = ref.argmax(-1)[:, None]
        picks = tl.float().numpy()[:, -1].argmax(-1)
        if variant == "bf16":
            top2 = np.sort(ref, -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > TOL_BF16 * np.abs(ref).max()
            np.testing.assert_array_equal(picks[clear], tok[clear, 0])
        else:
            _gap_ok(ref)
            np.testing.assert_array_equal(picks, tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, variant, f"step {t}")
    if variant != "bf16":
        _close_caches(tc, jc, tm, "decode")


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

SCHED_T = 48
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks", "chunk_lanes",
              "blocks_in_use", "block_high_water", "prefix_hit_tokens",
              "prefix_prompt_tokens", "prefill_tokens_skipped")
PROMPT_LENS, BUDGETS = (40, 24, 8, 20), (5, 6, 4, 3)


def _modes():
    out = {"dense": {}, "paged": dict(paged=True, block_size=4)}
    for c in (1, 3, 4, 5, 13):
        out[f"chunk{c}-dense"] = dict(chunk_prefill=True, chunk_size=c,
                                      prefill_budget=2 * c)
        out[f"chunk{c}-paged"] = dict(out[f"chunk{c}-dense"], paged=True,
                                      block_size=4)
    return out


MODES = _modes()
# against the reference: each pool, and every chunk size in one of them
REF_MODES = ["dense", "paged", "chunk1-dense", "chunk3-paged",
             "chunk4-dense", "chunk5-paged", "chunk13-dense"]


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
        _port_runs[mode] = _serve(Scheduler(tm, tp, num_slots=2,
                                            cache_len=SCHED_T,
                                            **MODES[mode]),
                                  Request, torch.from_numpy)
    return _port_runs[mode]


@pytest.mark.parametrize("mode", REF_MODES)
def test_scheduler_is_the_references(mode):
    """Tokens identical, logprobs within 1e-4, the slots (uid, prompt
    position, block ids: the paged pool holds no arena, its accounting is
    the reference's) after every step and the counters equal; the prefix
    cache is off though asked for, and its counters stay 0."""
    jm, jp, _, _ = _models()
    mine = _port_run(mode)
    ref = _serve(JScheduler(jm, jp, num_slots=2, cache_len=SCHED_T,
                            **MODES[mode]), JRequest,
                 lambda r: jnp.asarray(r, jnp.int32))
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
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
    (f"chunk{c}-paged", f"chunk{c}-dense") for c in (1, 3, 4, 5, 13)] + [
    (f"chunk{c}-{pool}", "dense") for c in (1, 3, 4, 5, 13)
    for pool in ("dense", "paged")]


@pytest.mark.parametrize("run,base", AGREE, ids=[f"{a}={b}"
                                                 for a, b in AGREE])
def test_paths_agree_within_the_port(run, base):
    """Paged ≡ dense: the same calls on the same tokens, bit for bit.
    Chunked ≡ monolithic: other chunk lengths, so the sums run in another
    order: tokens identical, logprobs within 1e-5."""
    a, b = _port_run(run), _port_run(base)
    for uid, f in a["done"].items():
        np.testing.assert_array_equal(f.tokens, b["done"][uid].tokens)
        if run.startswith("chunk") == base.startswith("chunk"):
            assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        else:
            np.testing.assert_allclose(f.logprobs, b["done"][uid].logprobs,
                                       rtol=TOL_SSM, atol=TOL_SSM)


@pytest.mark.parametrize("C", [1, 5, 13])
def test_chunk_steps_are_the_monolithic_prefill(C):
    """A prompt of 13 fed to ``chunk_step`` in chunks of ``C`` (the last
    one right-padded) into row 1 of a 2-slot pool: the last chunk's logits
    within 1e-5 of the monolithic prefill's, row 1's state and conv
    within 1e-5 of its cache, row 0 bit for bit as it was."""
    _, _, tm, tp = _models()
    tokens = torch.from_numpy(_tokens(1, 13, 50))
    want_l, want_c = tm.prefill(tp, {"tokens": tokens, "cache_len": 32})
    pool = tm.init_cache(2, 32, per_row=True)
    for leaf in tm.slot_leaves(pool):
        leaf[0].copy_(torch.randn(leaf.shape[1:], generator=torch.Generator()
                                  .manual_seed(leaf.numel())))
    row0 = [t[0].clone() for t in tm.slot_leaves(pool)]
    for start in range(0, 13, C):
        n = min(C, 13 - start)
        chunk = torch.zeros((1, C), dtype=torch.int64)
        chunk[0, :n] = tokens[0, start:start + n]
        lg, pool = tm.chunk_step(tp, pool, chunk, 1, start, n, True)
    np.testing.assert_allclose(lg.numpy(), want_l.numpy(), rtol=0,
                               atol=TOL_SSM)
    assert int(pool["pos"][1]) == 13
    for got, want in zip(tm.slot_leaves(pool), tm.slot_leaves(want_c)):
        np.testing.assert_allclose(got[1].numpy(), want[0].numpy(),
                                   rtol=TOL_SSM, atol=TOL_SSM)
    for got, before in zip(tm.slot_leaves(pool), row0):
        assert torch.equal(got[0], before)


# --------------------------------------------------------------------------
# The 'slot' leaves of the other rows stay bit for bit
# --------------------------------------------------------------------------

def _random_pool(tm, paged: bool):
    pool = (tm.init_cache(3, 16, paged=True, block=4) if paged
            else tm.init_cache(3, 16, per_row=True))
    gen = torch.Generator().manual_seed(5)
    for leaf in tm.slot_leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return pool


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_inactive_rows_keep_their_state(paged):
    """A masked decode step with row 1 inactive, then an inactive chunk
    lane on row 2: both rows' state and conv bit for bit; the paged pool
    holds no arena (every leaf is a 'slot' leaf)."""
    _, _, tm, tp = _models()
    pool = _random_pool(tm, paged)
    if paged:
        assert tm.arena_leaves(pool) == [] and tm.windows == []
        assert len(tm.slot_leaves(pool)) == len(tree_leaves(
            {k: v for k, v in pool.items() if k.startswith("g")}))
    before = [t.clone() for t in tm.slot_leaves(pool)]
    pool["pos"].copy_(torch.tensor([3, 5, 7], dtype=torch.int32))
    active = torch.tensor([True, False, True])
    tm.decode_step(tp, pool, torch.tensor([[1], [2], [3]]), active)
    for got, old in zip(tm.slot_leaves(pool), before):
        assert torch.equal(got[1], old[1])
        assert not torch.equal(got[0], old[0])
    mid = [t.clone() for t in tm.slot_leaves(pool)]
    tm.chunk_step(tp, pool, torch.ones((1, 4), dtype=torch.int64), 2, 7, 4,
                  False, table=pool["block_tables"][2] if paged else None)
    for got, old in zip(tm.slot_leaves(pool), mid):
        assert torch.equal(got, old)


def test_copy_blocks_and_paged_splice_leave_slot_leaves_alone():
    """``copy_blocks`` touches no 'slot' leaf (its index is a slot, not a
    block); ``splice_cache_paged`` writes only row ``slot``'s, with the
    row's table and position."""
    _, _, tm, tp = _models()
    pool = _random_pool(tm, paged=True)
    before = [t.clone() for t in tm.slot_leaves(pool)]
    tm.copy_blocks(pool, 0, 2)
    for got, old in zip(tm.slot_leaves(pool), before):
        assert torch.equal(got, old)
    _, row = tm.prefill(tp, {"tokens": torch.from_numpy(_tokens(1, 9, 60)),
                             "cache_len": 16})
    table = torch.tensor([4, 5, 6, 12], dtype=torch.int32)
    tm.splice_cache_paged(pool, row, 1, table)
    for got, old, new in zip(tm.slot_leaves(pool), before,
                             tm.slot_leaves(row)):
        assert torch.equal(got[0], old[0]) and torch.equal(got[2], old[2])
        assert torch.equal(got[1], new[0])
    assert int(pool["pos"][1]) == 9
    assert torch.equal(pool["block_tables"][1], table)


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    [], ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
         "--assert-no-replan", "--paged", "--block-size", "4",
         "--chunk-prefill", "--chunk-size", "5", "--prefill-budget", "10"]],
    ids=["fixed", "arrival-paged-chunked"])
def test_serve_cli_runs_mamba2_on_cpu(extra):
    out = serve.main(["--arch", "mamba2-2.7b", "--variant", "smoke", "--tt",
                      "ffn", "--tt-rank", "4", "--tt-backend", "auto",
                      "--batch", "2", "--prompt-len", "12", "--steps", "4",
                      "--device", "cpu"] + extra)
    if extra:
        assert sorted(f.uid for f in out["finished"]) == [0, 1, 2]
        assert out["prefill_chunks"] > 0 and out["replans"] == 0
    else:
        assert tuple(out["tokens"].shape) == (2, 4)
        assert out["replans"] == out["captures"] == 0


@pytest.mark.parametrize("layers", [1, 2])
def test_groupings_agree_in_fp32(layers):
    """The witness of three groupings of a prompt (prefill of the exact
    length, bucketed, chunked at 4) on SMOKE: with fp32 parameters, the
    scan in fp32 or fp64, every last-token log-softmax within 1e-5 of the
    exact prefill's; with bf16
    parameters, through the kernel's plain version and through einsum,
    every grouping's within 2e-2 × the largest |logit| of the fp32 one."""
    rows = groupings.main(["--variant", "smoke", "--layers", str(layers),
                           "--tt-rank", "4", "--lens", "5,40", "--count",
                           "3", "--chunk-size", "4", "--device", "cpu"])
    assert [(r["dtype"], r["backend"], r["scan"]) for r in rows] == [
        ("bfloat16", "auto", "float32"), ("bfloat16", "einsum", "float32"),
        ("float32", "auto", "float32"), ("float32", "auto", "float64")]
    for r in rows[2:]:
        assert r["bucketed"] < 1e-5 and r["chunked"] < 1e-5
    for r in rows[:2]:
        assert all(r[f"{g}_vs_fp32"] < 2e-2 * r["max_logit"]
                   for g in groupings.GROUPINGS)
