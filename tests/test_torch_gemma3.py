"""gemma3-4b, the port's second family, on the CPU against the reference:
sliding-window ring caches on five of every six layers, local (theta
10,000) and global RoPE, qk-norm, and tied embeddings scaled by sqrt(d).

gemma3 SMOKE (7 layers: two periods of 2 local + 1 global, then 1 local;
window 16) with TT on ffn+attn at rank 4, ``auto`` backend, through both
packages, the reference's weights carried into the port by
``convert.from_jax_params`` and the tokens drawn with numpy from a seed;
the reference's Pallas kernels run in interpret mode.  Three variants:
fp32 cores, int8 cores (both over fp32 parameters) and bf16 parameters.

- The registry: FULL's two groups, ring leaves of min(1,024, T) rows, no
  ``lm_head``, prefix reuse off and chunked prefill on; every
  architecture of the reference registry resolves in the port (none is
  pending).  FULL's converted spec shapes against the
  reference's ``abstract_params`` (meta tensors: nothing is allocated).
- ``embed_apply`` at d = 2560 in bf16 bit for bit (sqrt(d) is rounded to
  bf16 before the product, as the reference rounds it).
- Prefill at prompts of 8, 16, 24 and 40 (below, at and over the window,
  wrapping twice) and bucketed (20 padded to 32): logits within 1e-4 and
  caches (rings included) within 1e-5; bf16 parameters within 2e-2 × the
  largest |logit| (``tests/test_torch_model_bf16.py``'s rule).
- Decode for 24 steps across the window, the scalar position and per-row
  positions with ``active``: greedy tokens identical, logits within 1e-4,
  caches within 1e-5; the reference's top-1/top-2 gap exceeds ten times the
  tolerance at every step, asserted.
- The paged ring: splice and decode against the reference's
  ``splice_cache_paged`` and paged ``decode_step``, at a cache length of
  30 (blocks of 4: the pool rounds it up to 32, as the schedulers do;
  blocks of 6: 5 blocks, the ring's 16 rows in 3).
- The schedulers, dense, paged and chunked (chunks of 8 over 2 lanes,
  dense; of 24, longer than the window, both pools), against the
  reference's:
  tokens identical, logprobs within 1e-4, slots, prompt positions and
  block ids after every step and the counters equal; the prefix cache,
  asked for, makes no hit on either side.

Captured against eager for the ring paths needs a card:
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.models.layers import embed_apply as jembed_apply
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.models.layers import embed_apply
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # caches, port against the reference
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
W = 16              # SMOKE's window
# variant → (TT core weights, parameter dtype)
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}


def _tt(cls, weights="fp32", rank=4, min_factor=2):
    return cls(enabled=True, families=("ffn", "attn"), rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


_built: dict = {}


def _models(variant="fp32"):
    """(reference model, its params, port model, its params) of SMOKE; the
    fp32 parameters are drawn once, the int8 variant quantizes them and
    the bf16 one rounds them."""
    if variant not in _built:
        weights, dtype = VARIANTS[variant]
        jm = jbuild(jget_config("gemma3_4b", "smoke",
                                tt=_tt(JTTConfig, weights)),
                    param_dtype=getattr(jnp, dtype))
        if variant == "fp32":
            jp = jm.init(jax.random.PRNGKey(0))
        else:
            jp = _models("fp32")[1]
        if weights == "int8":
            jp = jm.quantize_params(jp)
        if dtype == "bfloat16":
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tm = tbuild(tget_config("gemma3_4b", "smoke",
                                tt=_tt(TTTConfig, weights)),
                    param_dtype=getattr(torch, dtype), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[variant] = (jm, jp, tm, tp)
    return _built[variant]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int64)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _to_port(jcache, tm) -> dict:
    """A reference cache (stacked layers; dense or paged) in the port's
    layout."""
    out = {k: torch.from_numpy(np.array(jcache[k]))
           for k in ("pos", "block_tables") if k in jcache}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in ("k", "v")}
            for i in range(len(period))} for layer in range(count)]
    return out


def _close_caches(mine, jcache, tm, what, tol=TOL_CACHE, skip=None):
    """Every k/v leaf within ``tol``, positions and tables equal; ``skip``
    drops an arena's sentinel block."""
    want = _to_port(jcache, tm)
    for k in ("pos", "block_tables"):
        if k in want:
            assert torch.equal(mine[k], want[k]), (what, k)
    mine = {k: v for k, v in mine.items() if k.startswith("g")}
    want = {k: v for k, v in want.items() if k.startswith("g")}
    got, ref = tree_leaves(mine), tree_leaves(want)
    assert [t.shape for t in got] == [t.shape for t in ref], what
    for a, b in zip(got, ref):
        a = a.float()[:skip] if skip else a.float()
        b = b[:skip] if skip else b
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol,
                                   err_msg=what)


def _close_logits(tl, jl, variant, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    tol = TOL_BF16 * np.abs(ref).max() if variant == "bf16" else TOL
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# The registry, the converter and the embedding
# --------------------------------------------------------------------------

def test_full_config_builds_two_groups_of_rings():
    cfg = tget_config("gemma3-4b", "full")
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    (period, n0), (tail, n1) = tm.groups
    assert (len(period), n0, len(tail), n1) == (6, 5, 1, 4)
    assert [bd.window for bd in period] == [1024] * 5 + [0]
    assert [bd.theta for bd in period] == [10_000.0] * 5 + [1e6]
    assert tail[0].window == 1024 and tail[0].theta == 10_000.0
    assert sum(len(p) * n for p, n in tm.groups) == cfg.num_layers == 34
    for T, ring in ((1280, 1024), (600, 600)):
        shapes = tm.cache_shapes(4, T)
        assert shapes["g0"][0]["b0"]["k"][0] == (4, ring, 4, 256)
        assert shapes["g0"][0]["b5"]["v"][0] == (4, T, 4, 256)
        assert shapes["g1"][3]["b0"]["k"][0] == (4, ring, 4, 256)
    assert "lm_head" not in tm.param_specs()
    assert not tm.supports_prefix_reuse and tm.supports_chunked_prefill
    assert tm.windows == [0, 1024]


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_every_other_pending_family_still_raises(arch):
    """One case a reference architecture: none is pending, each resolves
    in the port under its external id, as the reference's."""
    assert PENDING == ()
    cfg = tget_config(arch.replace("_", "-"))
    assert cfg.name == jget_config(arch).name


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """FULL with TT on ffn+attn at rank 16: the reference's abstract
    params (stacked, zero-stride numpy views) through
    ``from_jax_params`` into meta tensors: every key, layer axis and shape
    checked, nothing allocated."""
    jm = jbuild(jget_config("gemma3_4b", "full",
                            tt=_tt(JTTConfig, rank=16, min_factor=8)),
                param_dtype=jnp.bfloat16)
    tm = tbuild(tget_config("gemma3_4b", "full",
                            tt=_tt(TTTConfig, rank=16, min_factor=8)),
                param_dtype=torch.bfloat16, device="cpu")
    abstract = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jm.abstract_params())
    monkeypatch.setattr(convert, "_tensor", lambda arr, dtype, device:
                        torch.empty(arr.shape, dtype=dtype, device="meta"))
    got = from_jax_params(abstract, tm)
    assert "lm_head" not in got and "lm_head" not in abstract
    attn = got["g0"][0]["b5"]["attn"]
    assert attn["q_norm"].shape == attn["k_norm"].shape == (256,)
    assert (len(got["g0"]), len(got["g1"])) == (5, 4)
    assert got["embed"]["table"].shape == (262_144, 2560)
    cores = {k: tuple(v["tt"]["c0"].shape[1:3]) + tuple(
        v["tt"]["c1"].shape[1:3]) for k, v in attn.items()
        if isinstance(v, dict)}
    cores.update({k: tuple(v["tt"]["c0"].shape[1:3]) + tuple(
        v["tt"]["c1"].shape[1:3]) for k, v in got["g1"][0]["b0"][
        "ffn"].items()})
    # (n1, m1, n2, m2) of each projection's two cores: the five fused2
    # shapes of the H100 run
    assert cores == {"q": (8, 256, 320, 8), "k": (8, 128, 320, 8),
                     "v": (8, 128, 320, 8), "o": (8, 320, 256, 8),
                     "gate": (8, 1280, 320, 8), "up": (8, 1280, 320, 8),
                     "down": (8, 320, 1280, 8)}


def test_embed_scale_is_the_references_at_full_width_in_bf16():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((300, 2560)).astype(np.float32)
    tokens = rng.integers(0, 300, (2, 9))
    want = _f32(jembed_apply({"table": jnp.asarray(table, jnp.bfloat16)},
                             jnp.asarray(tokens), 2560, scale=True))
    tt = torch.from_numpy(table).to(torch.bfloat16)
    got = embed_apply({"table": tt}, torch.from_numpy(tokens), 2560,
                      scale=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # sqrt(2560) = 50.596 unrounded gives other bits
    assert not np.array_equal(
        (tt[torch.from_numpy(tokens)] * float(np.sqrt(2560))).float().numpy(),
        want)


# --------------------------------------------------------------------------
# Prefill and decode
# --------------------------------------------------------------------------

# (variant, prompt length, bucketed): fp32 cores at every length, int8
# cores and bf16 parameters at the wrapping and the bucketed prompts
PREFILLS = [("fp32", S, False) for S in (8, 16, 24, 40)] + [
    ("fp32", 20, True), ("int8", 40, False), ("int8", 20, True),
    ("bf16", 40, False), ("bf16", 20, True)]


@pytest.mark.parametrize("variant,S,bucketed", PREFILLS,
                         ids=[f"{v}-{S}{'-in-32' if b else ''}"
                              for v, S, b in PREFILLS])
def test_prefill_matches_the_reference(variant, S, bucketed):
    """Logits and every cache leaf (the rings of the local layers, the
    global layers' full k/v) against the reference's, into a cache of 48."""
    jm, jp, tm, tp = _models(variant)
    tokens = _tokens(1 if bucketed else 2, S, S)
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
    ring = tc["g0"][0]["b0"]["k"]
    assert ring.shape == (tokens.shape[0], W, 2, 16)
    assert int(tc["pos"]) == S
    if variant == "bf16":
        ref = _to_port(jc, tm)
        top = max(float(t.abs().max()) for t in tree_leaves(ref))
        _close_caches(tc, jc, tm, "prefill", tol=TOL_BF16 * top)
    else:
        _close_caches(tc, jc, tm, "prefill")
    if S < W:                      # slots past the prompt hold nothing
        assert not ring[:, S:].any()


def _gap_ok(logits: np.ndarray) -> None:
    top2 = np.sort(logits.astype(np.float64), -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]).min()
    assert gap > 10 * TOL, gap


DECODE_SEED, STEPS = 3, 24


@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_scalar_decode_across_the_window(variant):
    """A prompt of 8 into a cache of 32, then 24 greedy steps (the ring
    wraps at 16): tokens identical, logits and caches close."""
    jm, jp, tm, tp = _models(variant)
    tokens = _tokens(2, 8, DECODE_SEED)
    jl, jc = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 32})
    step = jm.jitted_decode_step()
    for t in range(STEPS):
        ref = np.asarray(jl)[:, -1]
        _gap_ok(ref)
        tok = ref.argmax(-1)[:, None]
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, variant, f"step {t}")
    _close_caches(tc, jc, tm, "decode")
    assert int(tc["pos"]) == 8 + STEPS


def test_per_row_decode_with_active_across_the_window():
    """A pool of 3 rows at their own depths (prompts of 6, 13 and 20,
    spliced), 24 masked steps with row 1 inactive every third step and row
    2 never active: logits of the active rows and the whole pool against
    the reference's; the inactive row keeps its ring bit for bit."""
    jm, jp, tm, tp = _models("fp32")
    T = 48
    jpool = dict(jm.init_cache(3, T, dtype=jnp.float32),
                 pos=jnp.zeros((3,), jnp.int32))
    mine = tm.init_cache(3, T, per_row=True)
    first = []
    for slot, (S, seed) in enumerate(((6, 11), (13, 12), (20, 13))):
        tokens = _tokens(1, S, seed)
        jl, jrow = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(
            tokens, jnp.int32)})
        jpool = jm.splice_cache(jpool, jrow, slot)
        tm.splice_cache(mine, _to_port(jrow, tm), slot)
        first.append(int(np.asarray(jl)[0, -1].argmax()))
    _close_caches(mine, jpool, tm, "splice")
    frozen = [t.clone() for t in tree_leaves(
        {k: v for k, v in mine.items() if k.startswith("g")})]
    step = jax.jit(jm.decode_step)
    tok = np.array(first)[:, None]
    for t in range(STEPS):
        act = np.array([True, t % 3 != 2, False])
        jl, jpool = step(jp, jpool, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(act))
        tl, mine = tm.decode_step(tp, mine, torch.from_numpy(tok),
                                  torch.from_numpy(act))
        ref = np.asarray(jl)[act, -1]
        _gap_ok(ref)
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   rtol=TOL, atol=TOL, err_msg=f"step {t}")
        tok = np.where(act, np.asarray(jl)[:, -1].argmax(-1), tok[:, 0])
        tok = tok[:, None]
        np.testing.assert_array_equal(
            tl.numpy()[act, -1].argmax(-1), tok[act, 0])
    _close_caches(mine, jpool, tm, "masked decode")
    assert mine["pos"].tolist() == [6 + STEPS, 13 + 16, 20]
    for old, new in zip(frozen, tree_leaves(
            {k: v for k, v in mine.items() if k.startswith("g")})):
        assert torch.equal(old[2], new[2])


# --------------------------------------------------------------------------
# The paged ring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block", [4, 6])
def test_paged_ring_splice_and_decode_match_the_reference(block):
    """A pool of 2 slots over 30 positions (the schedulers' rounding: 32
    with blocks of 4, 30 with blocks of 6): two prompts (18 and 9 tokens,
    prefilled at the pool's logical length) spliced into their blocks,
    then 12 paged steps with slot 1 inactive every other step: logits,
    arenas (sentinel block aside), positions and tables against the
    reference's."""
    jm, jp, tm, tp = _models("fp32")
    mb = -(-30 // block)
    T = mb * block
    nb = 2 * mb
    jpool = jm.init_cache(2, T, dtype=jnp.float32, paged=True,
                          num_blocks=nb, block=block)
    mine = tm.init_cache(2, T, paged=True, num_blocks=nb, block=block)
    rng = np.random.default_rng(5)
    ids = rng.permutation(nb)
    first = []
    for slot, (S, seed) in enumerate(((18, 21), (9, 22))):
        tokens = _tokens(1, S, seed)
        jl, jrow = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(
            tokens, jnp.int32)})
        held = -(-(S + 12) // block)
        table = np.full(mb, nb, np.int32)
        table[:held] = ids[slot * mb:slot * mb + held]
        jpool = jm.splice_cache_paged(jpool, jrow, slot, jnp.asarray(table))
        tm.splice_cache_paged(mine, _to_port(jrow, tm), slot,
                              torch.from_numpy(table))
        first.append(int(np.asarray(jl)[0, -1].argmax()))
    _close_caches(mine, jpool, tm, "paged splice", skip=nb)
    step = jax.jit(jm.decode_step)
    tok = np.array(first)[:, None]
    for t in range(12):
        act = np.array([True, t % 2 == 0])
        jl, jpool = step(jp, jpool, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(act))
        tl, mine = tm.decode_step(tp, mine, torch.from_numpy(tok),
                                  torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   rtol=TOL, atol=TOL, err_msg=f"step {t}")
        _gap_ok(np.asarray(jl)[act, -1])
        tok = np.where(act, np.asarray(jl)[:, -1].argmax(-1), tok[:, 0])
        tok = tok[:, None]
    _close_caches(mine, jpool, tm, "paged decode", skip=nb)


# --------------------------------------------------------------------------
# The schedulers against the reference's
# --------------------------------------------------------------------------

# r0 (40 tokens: the ring wraps twice) is admitted and runs one step, then
# r1 (24) and r2 (8, below the window) are submitted, r2 queues for a slot;
# after the drain r3 (20, a bucket of 32)
SCHED_LENS, SCHED_BUDGETS, SCHED_SEED, SCHED_T = (40, 24, 8, 20), \
    (5, 6, 4, 3), 90, 48
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks",
              "chunk_lanes", "blocks_in_use", "block_high_water",
              "prefix_hit_tokens", "prefix_prompt_tokens",
              "prefill_tokens_skipped")
# mode → Scheduler arguments beside 2 slots over 48 positions: chunks of
# 8 over 2 lanes (dense) and of 24, longer than the window (both pools)
MODES = {
    "dense": {},
    "paged": dict(paged=True, block_size=4),
    "chunk8-dense": dict(chunk_prefill=True, chunk_size=8,
                         prefill_budget=16),
    "chunk24-dense": dict(chunk_prefill=True, chunk_size=24),
    "chunk24-paged": dict(chunk_prefill=True, chunk_size=24, paged=True,
                          block_size=8),
}


def _sched_prompts():
    return [_tokens(1, n, SCHED_SEED + i) for i, n in enumerate(SCHED_LENS)]


def _gaps(tm, tp, tokens, steps):
    """Assert the top-1/top-2 logit gap of ``tokens [1, S]`` decoded
    greedily alone exceeds ten times the tolerance at every step (the
    port's ``generate_fixed``: within 1e-4 of the reference's logits, as
    the tests above hold it, so the reference's gap exceeds eight times
    the tolerance)."""
    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                    "cache_len": SCHED_T})
    for t in range(steps):
        lg = logits[0, -1].numpy()
        _gap_ok(lg)
        logits, cache = tm.decode_step(tp, cache,
                                       torch.tensor([[int(lg.argmax())]]))


def _serve(sched, req_cls, rows, to_tokens) -> dict:
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if sched.paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid):
        sched.submit(req_cls(uid=uid, inputs={"tokens": to_tokens(rows[uid])},
                             max_new_tokens=SCHED_BUDGETS[uid]))

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
            "stats": {k: st[k] for k in STAT_NAMES if k in st}}


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_is_the_reference(mode):
    """Every pool and admission kind against the reference's ``Scheduler``
    on one schedule, the prefix cache asked for (paged): tokens identical,
    logprobs within 1e-4, the slots (uid, prompt position, blocks) after
    every step and the counters equal, and no prefix hit on either side
    (a window ring is never shared)."""
    jm, jp, tm, tp = _models("fp32")
    rows = _sched_prompts()
    kw = dict(MODES[mode], num_slots=2, cache_len=SCHED_T)
    mine = _serve(Scheduler(tm, tp, **kw), Request, rows, torch.from_numpy)
    ref = _serve(JScheduler(jm, jp, **kw), JRequest, rows,
                 lambda r: jnp.asarray(r, jnp.int32))
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
        assert f.finish_reason == want.finish_reason == "length"
        if mode == "dense":
            _gaps(tm, tp, rows[uid], len(f.tokens))
    if "paged" in mode:
        assert mine["stats"]["prefix_hit_tokens"] == 0
        assert mine["stats"]["prefill_tokens_skipped"] == 0
    if "chunk" in mode:
        size = MODES[mode]["chunk_size"]
        assert mine["stats"]["prefill_chunks"] == sum(
            -(-n // size) for n in SCHED_LENS)


# --------------------------------------------------------------------------
# Within the port: what a capture needs of the ring paths
# --------------------------------------------------------------------------

def _live_pool(tm, tp, paged):
    """A 2-slot pool over 48 positions with a 40-token prompt in slot 0
    (its rings wrapped): (pool, table of slot 1 or None)."""
    kw = dict(paged=True, num_blocks=24, block=4) if paged else \
        dict(per_row=True)
    pool = tm.init_cache(2, SCHED_T, **kw)
    _, row = tm.prefill(tp, {"tokens": torch.from_numpy(_tokens(1, 40, 7)),
                             "cache_len": SCHED_T})
    if paged:
        tm.splice_cache_paged(pool, row, 0, torch.arange(12,
                                                         dtype=torch.int32))
        return pool, torch.arange(12, 24, dtype=torch.int32)
    tm.splice_cache(pool, row, 0)
    return pool, None


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ring_mixed_steps_dispatch_the_same_ops_and_idle_lanes_write_nothing(
        paged):
    """The body of the captured mixed step on a ring model: two mixed
    steps with other lane values (a chunk of 24 into slot 1 from 0 and
    from 24) dispatch identical ops and read nothing on the host; a step
    whose lanes are all inactive (the capture's) leaves every k/v row
    (paged: every block but the sentinel), position and table as it was,
    bit for bit."""
    from test_torch_paging import _OpLog, _no_host_read
    _, _, tm, tp = _models("fp32")
    pool, table = _live_pool(tm, tp, paged)
    prompt = torch.from_numpy(_tokens(1, 48, 8))
    sentinel = torch.full((1, 12), 24, dtype=torch.int32)
    logs = []
    for start, true, act in ((0, 24, True), (24, 10, True),
                             (0, 1, False)):
        before = [t.clone() for t in tree_leaves(pool)]
        args = [torch.zeros((2, 1), dtype=torch.int64),
                torch.zeros(2, dtype=torch.bool),
                prompt[:, start:start + 24].contiguous()] + [
            torch.tensor([v], dtype=torch.int32) for v in (1, start, true)]
        args += [torch.tensor([act]), None if not paged else (
            table[None] if act else sentinel).contiguous()]
        with _OpLog() as log:
            tm.mixed_step(tp, pool, *args)
        logs.append(log.ops)
    for a, b in zip(tree_leaves(pool), before):
        if paged and a.dim() == 4:
            a, b = a[:-1], b[:-1]
        assert torch.equal(a, b)
    assert len(logs[0]) > 100 and logs[0] == logs[1] == logs[2]
    _no_host_read(logs[0])
    assert pool["pos"].tolist() == [40, 34]


def test_ring_prefill_and_decode_read_nothing_on_the_host():
    """The bodies of the captured prefill (bucketed: the ring built at a
    device length) and of the masked, paged decode step."""
    from test_torch_paging import _OpLog, _no_host_read
    _, _, tm, tp = _models("fp32")
    with _OpLog() as log:
        tm.prefill(tp, {"tokens": torch.zeros((1, 32), dtype=torch.int64),
                        "cache_len": SCHED_T,
                        "prompt_len": torch.tensor(20, dtype=torch.int32)})
    _no_host_read(log.ops)
    pool, _ = _live_pool(tm, tp, paged=True)
    with _OpLog() as log:
        tm.decode_step(tp, pool, torch.zeros((2, 1), dtype=torch.int64),
                       torch.tensor([True, False]))
    _no_host_read(log.ops)
    assert pool["pos"].tolist() == [40, 0]
