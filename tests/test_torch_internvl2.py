"""internvl2-2b (the vision-language model: projected image embeddings
prepended to the prompt's token embeddings, an InternLM2 GQA decoder
with the GLU MLP) on the CPU against the reference.

SMOKE (2 layers, d 64, image embeddings of width 32) through both
packages with TT on ffn+attn at rank 4, ``auto`` backend; the reference's
Pallas kernels run in interpret mode.  The fp32 weights are the
reference's ``init(PRNGKey(0))``, carried into the port by
``convert.from_jax_params``; int8 quantizes them, bf16 rounds them.  The
tokens and the image embeddings are drawn with numpy from a seed; the
images are bf16, the reference CLI's input dtype, under fp32 parameters
too.  The models are built once per module and variant.

- The registry: FULL's config and layer plan (24 GQA blocks with the GLU
  MLP) against the reference's, chunked prefill and prefix reuse off;
  FULL's converted spec shapes (the dense ``projector`` included) against
  the reference's ``abstract_params`` on meta tensors; int8 codes and
  scales bit for bit.
- The projector alone within 1e-5.
- Prefill (exact and bucketed, image counts that are and are not a power
  of two; fp32 and int8 cores) and four greedy decode steps: logits
  within 1e-4, every k/v leaf within 1e-5, ``pos`` = S_img + S, tokens
  identical; ``generate_fixed``'s greedy tokens the reference's; bf16
  parameters within 2e-2 × the largest |logit|.
- Everything that depends on the prompt's length counts the image rows:
  the bucket (``T - S_img``), ``generate_fixed``'s bound and default cache
  length, the scheduler's ``submit`` and its paged block need.
- The dense and paged schedulers (image counts that differ by request)
  against the reference's ``Scheduler`` and the port's
  ``generate_fixed``; paged ≡ dense bit for bit; chunked prefill refused;
  a request without images refused at ``submit``.
- The serve CLI on ``--device cpu``, its prompts split as the
  reference's ``concrete_batch`` splits them.
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
from repro.configs.shapes import concrete_batch
from repro.models.model import bucket_length as jbucket_length
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
from repro_torch.models.model import bucket_length
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.engine import generate, generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # cache leaves, the projector alone (fp32)
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
ARCH = "internvl2_2b"
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


def _images(B, n, seed, dim=32) -> np.ndarray:
    """Image embeddings [B, n, dim], standard normal, as fp32 (each
    package rounds them to bf16 itself: ``_jin``/``_tin``)."""
    return np.random.default_rng(seed + 1000).standard_normal(
        (B, n, dim)).astype(np.float32)


def _jin(tokens, images) -> dict:
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            "image_embeds": jnp.asarray(images, jnp.bfloat16)}


def _tin(tokens, images) -> dict:
    return {"tokens": torch.from_numpy(tokens),
            "image_embeds": torch.from_numpy(images).bfloat16()}


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


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
    cfg, ref = tget_config("internvl2-2b", "full"), jget_config(ARCH, "full")
    assert ARCH in PORTED and ARCH not in PENDING
    for f in dataclasses.fields(cfg):
        if f.name not in ("tt", "ssm", "mla", "moe"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.rope_theta, cfg.frontend,
            cfg.frontend_dim, cfg.frontend_tokens, cfg.tie_embeddings) == (
        24, 2048, 16, 8, 8192, 92553, 1e6, "vit", 1024, 1024, False)
    dec, enc = jmake_layer_plan(ref)
    assert enc is None and make_enc_layer_plan(cfg) is None
    assert [(tuple((bd.mixer, bd.ffn, bd.cross, bd.causal, bd.window)
                   for bd in p), n) for p, n in make_layer_plan(cfg)] == [
        (tuple((bd.mixer, bd.ffn, bd.cross, bd.causal, bd.window)
               for bd in p), n) for p, n in dec] == [
        ((("gqa", "mlp", False, True, 0),), 24)]
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    assert not tm.supports_chunked_prefill and not tm.supports_prefix_reuse
    assert tm.windows == [0] and not tm.has_moe
    assert tm.front_input == "image_embeds"
    spec = tm.param_specs()
    assert set(spec) == {"embed", "final_norm", "lm_head", "g0", "projector"}
    assert spec["projector"]["w"].shape == (1024, 2048)
    # the image rows are plain k/v rows: every cache is a decoder's
    assert tm.cache_shapes(4, 2112)["g0"][23]["b0"] == {
        "k": ((4, 2112, 8, 128), torch.bfloat16),
        "v": ((4, 2112, 8, 128), torch.bfloat16)}
    assert tm.embeds_key(1024) == (1024,)
    with pytest.raises(ValueError, match="no front end"):
        tbuild(tget_config("deepseek-7b", "smoke"),
               device="cpu").embeds_key(4)
    with pytest.raises(ValueError, match="frame count"):
        tm.cache_shapes(4, 64, enc_T=8)


def test_every_architecture_of_the_reference_is_ported():
    assert PENDING == ()
    assert tget_config("internvl2-2b", "smoke").name == "internvl2-2b-smoke"


def _cores(v):
    c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
    return tuple(c0[-3:-1]) + tuple(c1[-3:-1])


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """FULL with TT on ffn+attn at rank 16, length 2, min_factor 8: the
    reference's abstract params through ``from_jax_params`` into meta
    tensors, every key and shape checked, nothing allocated; the four
    fused2 shapes (n1, m1, n2, m2) of the H100 run: q/o (8, 256, 256, 8),
    k/v (8, 128, 256, 8), gate/up (8, 1024, 256, 8), down (8, 256, 1024,
    8); ``projector`` and ``lm_head`` dense."""
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
    assert len(got["g0"]) == 24
    b = got["g0"][23]["b0"]
    assert _cores(b["attn"]["q"]) == _cores(b["attn"]["o"]) == \
        (8, 256, 256, 8)
    assert _cores(b["attn"]["k"]) == _cores(b["attn"]["v"]) == \
        (8, 128, 256, 8)
    assert _cores(b["ffn"]["gate"]) == _cores(b["ffn"]["up"]) == \
        (8, 1024, 256, 8)
    assert _cores(b["ffn"]["down"]) == (8, 256, 1024, 8)
    assert got["projector"]["w"].shape == (1024, 2048)
    assert got["lm_head"]["w"].shape == (2048, 92553)
    assert got["projector"]["w"].dtype == torch.bfloat16


def test_int8_codes_and_scales_are_the_references():
    """The port's quantizer over the converted fp32 tree and the
    reference's int8 tree, converted: every leaf equal bit for bit; the
    projector stays dense fp32."""
    _, _, tm, tp = _models("fp32")
    _, _, _, tp8 = _models("int8")
    mine = tm.quantize_params(tp)
    a, b = tree_leaves(mine), tree_leaves(tp8)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert mine["g0"][1]["b0"]["attn"]["k"]["tt"]["c0"].dtype == torch.int8
    assert mine["projector"]["w"] is tp["projector"]["w"]


# --------------------------------------------------------------------------
# The projector, the prefill and the decode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 16])
def test_projector_is_the_references(n):
    """``Model._project`` of bf16 image embeddings [2, n, 32] under fp32
    parameters within 1e-5 of the reference's ``linear_apply``; the images
    take the parameters' dtype exactly, so fp32 images of the same values
    give the same bits."""
    from repro.models.layers import linear_apply as jlinear_apply
    jm, jp, tm, tp = _models()
    images = _images(2, n, n)
    want = jlinear_apply(jp["projector"], jnp.asarray(images, jnp.bfloat16))
    bf16 = torch.from_numpy(images).bfloat16()
    got = tm._project(tp, bf16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, n, 64)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                               atol=TOL_CACHE)
    assert torch.equal(tm._project(tp, bf16.float()), got)


PREFILLS = [("fp32", 12, 8, False), ("fp32", 13, 6, True),
            ("int8", 12, 8, False), ("int8", 13, 6, True),
            ("fp32", 9, 16, True)]


@pytest.mark.parametrize("variant,S,n,bucketed", PREFILLS,
                         ids=[f"{v}-{S}-images{n}{'-bucketed' if b else ''}"
                              for v, S, n, b in PREFILLS])
def test_prefill_matches_the_reference(variant, S, n, bucketed):
    """Logits within 1e-4 and every k/v leaf within 1e-5 into a cache of
    40; the image rows are the cache's first n, ``pos`` = n + S; bucketed,
    the tokens alone are padded (13 to 16 in 40 - 6, 9 to 16 in 40 -
    16)."""
    jm, jp, tm, tp = _models(variant)
    tokens, images = _tokens(2, S, S), _images(2, n, S)
    if bucketed:
        jl, jc = jm.jitted_prefill_bucketed(40)(jp, _jin(tokens, images))
        tl, tc = tm.bucketed_prefill(40)(tp, _tin(tokens, images))
        assert (2, bucket_length(S, 40 - n), 40, n) in tm.eager_prefills
    else:
        jl, jc = jm.jitted_prefill(40)(jp, _jin(tokens, images))
        tl, tc = tm.prefill(tp, dict(_tin(tokens, images), cache_len=40))
    _close_logits(tl, jl, "prefill")
    assert int(tc["pos"]) == n + S
    _close_caches(tc, jc, tm, "prefill")


def test_bucket_counts_the_image_rows():
    """13 tokens after 26 image rows in a cache of 40: the bucket is
    ``bucket_length(13, 40 - 26)`` = 14, not 16 (which would overflow the
    cache), as the reference pads; 13 tokens after 28 rows fit no bucket
    and raise in both."""
    jm, jp, tm, tp = _models()
    tokens, images = _tokens(1, 13, 2), _images(1, 26, 2)
    assert bucket_length(13, 40 - 26) == jbucket_length(13, 40 - 26) == 14
    jl, jc = jm.jitted_prefill_bucketed(40)(jp, _jin(tokens, images))
    tl, tc = tm.bucketed_prefill(40)(tp, _tin(tokens, images))
    assert (1, 14, 40, 26) in tm.eager_prefills
    _close_logits(tl, jl, "bucketed at the cache's end")
    assert int(tc["pos"]) == 39
    _close_caches(tc, jc, tm, "bucketed at the cache's end")
    with pytest.raises(ValueError, match="exceeds cache length"):
        tm.bucketed_prefill(40)(tp, _tin(tokens, _images(1, 28, 2)))


@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_decode_matches_the_reference(variant):
    """A prompt of 8 image rows and 12 tokens into a cache of 28, then 4
    greedy steps fed the reference's picks: logits within 1e-4, the picks
    identical (the reference's top-1/top-2 gap over ten times the
    tolerance, asserted), the cache within 1e-5 at the end."""
    jm, jp, tm, tp = _models(variant)
    tokens, images = _tokens(2, 12, 3), _images(2, 8, 3)
    jl, jc = jm.jitted_prefill(28)(jp, _jin(tokens, images))
    tl, tc = tm.prefill(tp, dict(_tin(tokens, images), cache_len=28))
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
    assert int(tc["pos"]) == 24
    _close_caches(tc, jc, tm, "decode")


def test_generate_fixed_is_the_references():
    """``generate_fixed``'s greedy tokens over 6 steps identical to the
    reference engine's, logprobs within 1e-4; the scheduler-backed
    ``generate`` (which splits the images by row) gives the same tokens;
    without ``cache_len`` both size the cache to the images, the tokens
    and the steps."""
    jm, jp, tm, tp = _models()
    tokens, images = _tokens(2, 12, 7), _images(2, 10, 7)
    ref = jgenerate_fixed(jm, jp, dict(_jin(tokens, images), cache_len=28),
                          6)
    batch = dict(_tin(tokens, images), cache_len=28)
    got = generate_fixed(tm, tp, batch, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(ref.logprobs),
                               rtol=TOL, atol=TOL)
    for run in (generate, generate_fixed):
        via = run(tm, tp, _tin(tokens, images), 6)
        np.testing.assert_array_equal(via.tokens.numpy(), got.tokens.numpy())
        np.testing.assert_allclose(via.logprobs.numpy(),
                                   got.logprobs.numpy(), rtol=0, atol=1e-5)


def test_generate_fixed_bound_counts_the_image_rows():
    """10 image rows, 12 tokens and 6 steps decode up to position 26: a
    cache of 27 holds them, one of 26 does not, though the tokens alone
    fit; without images a vit model's prefill raises."""
    _, _, tm, tp = _models()
    batch = _tin(_tokens(1, 12, 7), _images(1, 10, 7))
    assert tuple(generate_fixed(tm, tp, dict(batch, cache_len=27),
                                6).tokens.shape) == (1, 6)
    with pytest.raises(ValueError, match="10 of them image rows"):
        generate_fixed(tm, tp, dict(batch, cache_len=26), 6)
    with pytest.raises(ValueError, match="image_embeds"):
        tm.prefill(tp, {"tokens": batch["tokens"]})
    with pytest.raises(ValueError, match="image_embeds"):
        generate_fixed(tm, tp, {"tokens": batch["tokens"]}, 2)


def test_bf16_prefill_matches_the_reference():
    """bf16 parameters: the prefill's logits within 2e-2 × the largest
    |logit| of the reference's, on bf16 images (no MoE here, so the whole
    model is held)."""
    jm, jp, tm, tp = _models("bf16")
    tokens, images = _tokens(2, 12, 11), _images(2, 10, 11)
    jl, _ = jm.jitted_prefill(24)(jp, _jin(tokens, images))
    tl, tc = tm.prefill(tp, dict(_tin(tokens, images), cache_len=24))
    ref = _f32(jl)
    assert tc["g0"][0]["b0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                               atol=TOL_BF16 * np.abs(ref).max())


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

SCHED_T = 64
STAT_NAMES = ("tokens_out", "steps_run", "blocks_in_use", "block_high_water",
              "prefix_hit_tokens", "prefix_prompt_tokens",
              "prefill_tokens_skipped")
# tokens, image rows and budgets a request: r0 needs 40 + 8 + 5 = 53
# positions, r2 16 image rows before 8 tokens
PROMPT_LENS, IMAGES, BUDGETS = (40, 24, 8, 20), (8, 5, 16, 3), (5, 6, 4, 3)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=4)}


def _request_arrays(uid):
    return (_tokens(1, PROMPT_LENS[uid], 90 + uid),
            _images(1, IMAGES[uid], 90 + uid))


def _serve(sched, req_cls, to_inputs) -> dict:
    """r0 is admitted and steps once, then r1 and r2, which queues; after
    the drain r3.  The slots (uid, blocks) after every step, and the
    counters."""
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, list(sched._slot_blocks[i]) if sched.paged else None)
            for i, s in enumerate(sched.slots)])

    def submit(uid):
        sched.submit(req_cls(uid=uid, inputs=to_inputs(*_request_arrays(uid)),
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
                                            **MODES[mode]), Request, _tin)
    return _port_runs[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_is_the_references(mode):
    """Tokens identical, logprobs within 1e-4, the slots (block ids
    included) after every step and the counters equal; every request's
    prompt length and the paged pool's high-water mark count its image
    rows; the prefix cache is off though asked for."""
    jm, jp, _, _ = _models()
    mine = _port_run(mode)
    ref = _serve(JScheduler(jm, jp, num_slots=2, cache_len=SCHED_T,
                            **MODES[mode]), JRequest, _jin)
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        assert f.prompt_len == want.prompt_len == \
            PROMPT_LENS[uid] + IMAGES[uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
    if MODES[mode]:
        assert mine["prefix_cache"] is False
        assert mine["stats"]["prefix_hit_tokens"] == 0
        # r0 and r1 hold ceil(53 / 4) + ceil(35 / 4) blocks together
        assert mine["stats"]["block_high_water"] == 14 + 9


def test_paged_scheduler_is_the_dense_one_and_generate_fixed():
    """Paged ≡ dense bit for bit, and every request's greedy tokens and
    logprobs ``generate_fixed``'s for its images and prompt alone
    (``serve.check_greedy``)."""
    _, _, tm, tp = _models()
    a, b = _port_run("paged"), _port_run("dense")
    for uid, f in a["done"].items():
        assert np.array_equal(f.tokens, b["done"][uid].tokens)
        assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        tokens, images = _request_arrays(uid)
        g = serve.check_greedy(tm, tp, torch.from_numpy(tokens), f,
                               SCHED_T, torch.from_numpy(images).bfloat16())
        assert g["identical"], g


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_submit_counts_the_image_rows(paged):
    """A request whose 10 tokens and 8 new ones fit a cache of 24 but whose
    8 image rows do not is refused at ``submit``, by the cache bound or,
    paged over 5 blocks of 4, by its block need (ceil(26 / 4) = 7 > 5) as
    well; one of 6 image rows fits (paged: 6 blocks, so 24 positions in
    the 5 blocks refuse it); a request without images is refused."""
    _, _, tm, tp = _models()
    kw = dict(paged=True, block_size=4, num_blocks=5) if paged else {}
    sched = Scheduler(tm, tp, num_slots=1, cache_len=24, **kw)

    def req(uid, n, budget=8):
        return Request(uid=uid, inputs=_tin(_tokens(1, 10, uid),
                                            _images(1, n, uid)),
                       max_new_tokens=budget)

    with pytest.raises(ValueError, match=r"prompt \(18\)"):
        sched.submit(req(0, 8))
    if paged:
        with pytest.raises(ValueError, match="needs 6 blocks"):
            sched.submit(req(1, 6))
        sched.submit(req(2, 6, budget=4))       # 20 positions: 5 blocks
    else:
        sched.submit(req(2, 6))
    with pytest.raises(ValueError, match="image_embeds"):
        sched.submit(Request(uid=9, inputs={"tokens": torch.from_numpy(
            _tokens(1, 6, 9))}, max_new_tokens=3))
    done = sched.run()
    assert list(done) == [2] and done[2].prompt_len == 16


def test_chunked_prefill_is_refused():
    """As the reference's: no chunked admission of a front-end model's
    prompt, in either package and over either pool."""
    jm, jp, tm, tp = _models()
    assert not jm.supports_chunked_prefill and not tm.supports_chunked_prefill
    for sched, model, params in ((JScheduler, jm, jp), (Scheduler, tm, tp)):
        for kw in ({}, dict(paged=True, block_size=4)):
            with pytest.raises(ValueError, match="chunked prefill"):
                sched(model, params, num_slots=1, cache_len=32,
                      chunk_prefill=True, chunk_size=4, **kw)


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

CLI = ["--arch", "internvl2-2b", "--variant", "smoke", "--tt", "ffn,attn",
       "--tt-rank", "4", "--tt-backend", "auto", "--batch", "2",
       "--prompt-len", "12", "--steps", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [], ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
         "--assert-no-replan"],
    ["--arrival-rate", "100", "--slots", "2", "--max-requests", "3",
     "--assert-no-replan", "--paged", "--block-size", "4"]],
    ids=["fixed", "arrival-dense", "arrival-paged"])
def test_serve_cli_runs_internvl2_on_cpu(extra):
    out = serve.main(CLI + extra)
    if extra:
        assert sorted(f.uid for f in out["finished"]) == [0, 1, 2]
        assert all(f.prompt_len == 12 for f in out["finished"])
        assert out["replans"] == 0 and out["kv_pool_bytes"] > 0
    else:
        assert tuple(out["tokens"].shape) == (2, 4)
        assert out["replans"] == out["captures"] == 0


@pytest.mark.parametrize("S", [12, 40])
def test_serve_cli_splits_the_prompt_as_the_reference(S):
    """The CLI's batch and arrival requests split a prompt of S rows as the
    reference's ``concrete_batch``: min(16, S // 2) bf16 image embeddings
    (SMOKE's ``frontend_tokens``) and the rest tokens, the cache S +
    steps."""
    _, _, tm, _ = _models()
    args = serve.parse_args(CLI[:-5] + [str(S), "--steps", "4", "--device",
                                        "cpu"])
    batch = serve.prompt_batch(tm, args)
    ref = concrete_batch(jget_config(ARCH, "smoke"), 2, S)
    for k in ("tokens", "image_embeds"):
        assert tuple(batch[k].shape) == tuple(ref[k].shape), k
    assert batch["image_embeds"].dtype == torch.bfloat16
    assert batch["image_embeds"].shape[1] == min(16, S // 2)
    assert batch["cache_len"] == S + 4
    req = serve.arrival_request(tm, args, 0, 5)
    assert tuple(req.inputs["image_embeds"].shape) == (1, min(16, S // 2),
                                                       32)
    assert "image_embeds" not in serve.prompt_batch(
        tbuild(tget_config("deepseek-7b", "smoke"), device="cpu"), args)


@pytest.mark.parametrize("extra", [
    ["--prefix-smoke", "--paged", "--block-size", "4", "--prefix-len", "8"],
    ["--arrival-rate", "100", "--slots", "2", "--max-requests", "2",
     "--chunk-prefill", "--chunk-size", "4"]],
    ids=["prefix-smoke", "chunk-prefill"])
def test_serve_cli_refuses_prefix_smoke_and_chunks(extra):
    with pytest.raises((SystemExit, ValueError)):
        serve.main(CLI + extra)
