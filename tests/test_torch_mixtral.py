"""mixtral-8x7b (a mixture-of-experts FFN behind windowed GQA) and
granite-8b (a llama-shaped dense decoder) on the CPU against the
reference.

Both SMOKE models with TT on ffn+attn at rank 4, ``auto`` backend (the
experts' projections through the expert-batched fused2 plain path, one
call per projection across the experts), through both packages, the
reference's weights carried into the port by ``convert.from_jax_params``
and the tokens drawn with numpy from a seed; the reference's Pallas
kernels run in interpret mode.  mixtral SMOKE keeps the reference's
capacity factor of 16 (dropless), so every identity is asserted with no
condition; the drop counter must read 0.

- The registry: mixtral FULL is one group of 32 windowed GQA blocks with
  8-expert stacks, no prefix reuse (its caches are rings), chunked
  prefill on; granite FULL is 36 dense blocks; FULL's converted spec
  shapes against the reference's ``abstract_params`` (meta tensors).
- Prefill at prompts of 8, 24 and 40 (over the window of 32) and bucketed
  (20 padded to 32): logits within 1e-4 and caches within 1e-5, fp32 and
  int8 cores; bf16 parameters within 2e-2 × the largest |logit|.
- Decode for 24 steps (the rings wrap): greedy tokens identical, logits
  within 1e-4, fp32 and int8 cores; the reference's top-1/top-2 gap over
  ten times the tolerance at every step, asserted.
- The schedulers, dense, paged and chunked (chunks of 8 over 2 lanes, and
  of 24 on both pools), against the reference's: tokens identical,
  logprobs within 1e-4, slots and counters equal; within the port, paged
  ≡ dense and chunked ≡ monolithic, no drop, and a second run resolves no
  plan.
- granite SMOKE: prefill and 16 decode steps, fp32 and int8 cores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING, PORTED
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import plan as tplan
from repro_torch.models import moe
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # caches
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
W = 32              # mixtral SMOKE's window
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}


def _tt(cls, weights="fp32", rank=4, min_factor=2):
    return cls(enabled=True, families=("ffn", "attn"), rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


_built: dict = {}


def _models(arch="mixtral_8x7b", variant="fp32"):
    """(reference model, its params, port model, its params) of SMOKE; the
    fp32 parameters are drawn once, int8 quantizes them, bf16 rounds
    them."""
    key = (arch, variant)
    if key not in _built:
        weights, dtype = VARIANTS[variant]
        jm = jbuild(jget_config(arch, "smoke", tt=_tt(JTTConfig, weights)),
                    param_dtype=getattr(jnp, dtype))
        if variant == "fp32":
            jp = jm.init(jax.random.PRNGKey(0))
        else:
            jp = _models(arch, "fp32")[1]
        if weights == "int8":
            jp = jm.quantize_params(jp)
        if dtype == "bfloat16":
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tm = tbuild(tget_config(arch, "smoke", tt=_tt(TTTConfig, weights)),
                    param_dtype=getattr(torch, dtype), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[key] = (jm, jp, tm, tp)
    return _built[key]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int64)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _to_port(jcache, tm) -> dict:
    out = {k: torch.from_numpy(np.array(jcache[k]))
           for k in ("pos", "block_tables") if k in jcache}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in ("k", "v")}
            for i in range(len(period))} for layer in range(count)]
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


def _close_logits(tl, jl, variant, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    tol = TOL_BF16 * np.abs(ref).max() if variant == "bf16" else TOL
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _gap_ok(logits: np.ndarray) -> None:
    top2 = np.sort(logits.astype(np.float64), -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]).min()
    assert gap > 10 * TOL, gap


# --------------------------------------------------------------------------
# The registry and the converter
# --------------------------------------------------------------------------

def test_mixtral_full_is_one_group_of_windowed_expert_blocks():
    cfg = tget_config("mixtral-8x7b", "full")
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    (period, n), = tm.groups
    assert n == 32 and len(period) == 1
    assert (period[0].mixer, period[0].window, period[0].ffn) == (
        "gqa", 4096, "moe")
    assert cfg.moe.num_experts == 8 and cfg.moe.top_k == 2
    assert cfg.moe.expert_ff == 14336 and cfg.moe.capacity_factor == 1.25
    assert tm.has_moe and not tm.supports_prefix_reuse
    assert tm.supports_chunked_prefill and tm.windows == [4096]
    # below the window the ring holds the whole cache
    assert tm.cache_shapes(4, 576)["g0"][0]["b0"]["k"][0] == (4, 576, 8, 128)
    spec = tm.param_specs()["g0"][0]["b0"]["ffn"]
    assert spec["router"].shape == (4096, 8)
    assert spec["experts"]["gate"]["w"].shape == (8, 4096, 14336)


def test_granite_full_is_a_dense_decoder():
    cfg = tget_config("granite-8b", "full")
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    (period, n), = tm.groups
    assert n == 36 and (period[0].window, period[0].ffn) == (0, "mlp")
    assert not tm.has_moe and tm.supports_prefix_reuse


def test_registry_moves_mixtral_and_granite_to_ported():
    for arch in ("mixtral_8x7b", "granite_8b"):
        assert arch in PORTED and arch not in PENDING
    for arch in ("qwen3_32b", "deepseek_v2_lite_16b"):
        assert arch in PORTED and arch not in PENDING


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "granite_8b"])
def test_converted_full_spec_shapes_are_the_references(arch, monkeypatch):
    """FULL with TT on ffn+attn at rank 16, length 2: the reference's
    abstract params through ``from_jax_params`` into meta tensors; every
    key, layer axis, expert axis and shape checked, nothing allocated.
    The (n1, m1, n2, m2) of the cores are the fused2 shapes of the H100
    run (expert stacks with a leading 8)."""
    jm = jbuild(jget_config(arch, "full", tt=_tt(JTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=jnp.bfloat16)
    tm = tbuild(tget_config(arch, "full", tt=_tt(TTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=torch.bfloat16, device="cpu")
    abstract = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jm.abstract_params())
    monkeypatch.setattr(convert, "_tensor", lambda arr, dtype, device:
                        torch.empty(arr.shape, dtype=dtype, device="meta"))
    got = from_jax_params(abstract, tm)
    block = got["g0"][0]["b0"]
    ffn = block["ffn"]["experts"] if arch == "mixtral_8x7b" else block["ffn"]
    lead = (8,) if arch == "mixtral_8x7b" else ()

    def shape(v, stack):
        c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
        assert c0[:-4] == c1[:-4] == stack
        return tuple(c0[-3:-1]) + tuple(c1[-3:-1])

    cores = {k: shape(v, ()) for k, v in block["attn"].items()}
    cores.update({k: shape(v, lead) for k, v in ffn.items()})
    assert cores == {"q": (8, 512, 512, 8), "k": (8, 128, 512, 8),
                     "v": (8, 128, 512, 8), "o": (8, 512, 512, 8),
                     "gate": (8, 1792, 512, 8), "up": (8, 1792, 512, 8),
                     "down": (8, 512, 1792, 8)}
    assert len(got["g0"]) == (32 if arch == "mixtral_8x7b" else 36)
    if arch == "mixtral_8x7b":
        assert block["ffn"]["router"].shape == (4096, 8)


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------

PREFILLS = [("fp32", S, False) for S in (8, 24, 40)] + [
    ("fp32", 20, True), ("int8", 40, False), ("int8", 20, True),
    ("bf16", 40, False), ("bf16", 20, True)]


@pytest.mark.parametrize("variant,S,bucketed", PREFILLS,
                         ids=[f"{v}-{S}{'-in-32' if b else ''}"
                              for v, S, b in PREFILLS])
def test_mixtral_prefill_matches_the_reference(variant, S, bucketed):
    """Logits and every cache leaf into a cache of 48: the bucket's
    padding routes through the experts too (the reference's token set),
    and nothing is dropped."""
    jm, jp, tm, tp = _models("mixtral_8x7b", variant)
    tokens = _tokens(1 if bucketed else 2, S, S)
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
    _close_logits(tl, jl, variant, "prefill")
    assert int(tc["pos"]) == S
    if variant == "bf16":
        ref = _to_port(jc, tm)
        top = max(float(t.abs().max()) for t in tree_leaves(ref))
        _close_caches(tc, jc, tm, "prefill", tol=TOL_BF16 * top)
    else:
        _close_caches(tc, jc, tm, "prefill")


DECODE_SEED, STEPS = 3, 24


@pytest.mark.parametrize("arch,steps", [("mixtral_8x7b", STEPS),
                                        ("granite_8b", 16)])
@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_decode_matches_the_reference(arch, steps, variant):
    """A prompt of 12 into a cache of 40, then greedy steps (mixtral's
    rings wrap at 32): tokens identical, logits and caches close."""
    jm, jp, tm, tp = _models(arch, variant)
    tokens = _tokens(2, 12, DECODE_SEED)
    jl, jc = jm.jitted_prefill(40)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 40})
    _close_logits(tl, jl, variant, "prefill")
    step = jm.jitted_decode_step()
    for t in range(steps):
        ref = np.asarray(jl)[:, -1]
        _gap_ok(ref)
        tok = ref.argmax(-1)[:, None]
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, variant, f"step {t}")
    _close_caches(tc, jc, tm, "decode")


@pytest.mark.parametrize("variant", ["fp32", "bf16"])
def test_granite_prefill_matches_the_reference(variant):
    jm, jp, tm, tp = _models("granite_8b", variant)
    tokens = _tokens(2, 24, 5)
    jl, _ = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                              jnp.int32)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                            "cache_len": 32})
    _close_logits(tl, jl, variant, "granite prefill")


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

# r0 (40 tokens: the rings wrap) is admitted and runs one step, then r1
# (24) and r2 (8) are submitted, r2 queues; after the drain r3 (20)
SCHED_LENS, SCHED_BUDGETS, SCHED_SEED, SCHED_T = (40, 24, 8, 20), \
    (5, 6, 4, 3), 90, 48
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks",
              "chunk_lanes", "blocks_in_use", "block_high_water",
              "prefix_hit_tokens", "prefix_prompt_tokens",
              "prefill_tokens_skipped")
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


_port_runs: dict = {}


def _port_run(mode):
    """The port's scheduler on the schedule (cached per mode), with the
    drops and the plan resolutions of a second run on a new scheduler."""
    if mode not in _port_runs:
        _, _, tm, tp = _models("mixtral_8x7b", "fp32")
        rows = _sched_prompts()
        kw = dict(MODES[mode], num_slots=2, cache_len=SCHED_T)
        moe.reset_drops()
        out = _serve(Scheduler(tm, tp, **kw), Request, rows,
                     torch.from_numpy)
        drops = moe.read_drops()
        plans = tplan.plan_resolutions()
        again = _serve(Scheduler(tm, tp, **kw), Request, rows,
                       torch.from_numpy)
        _port_runs[mode] = (out, drops, tplan.plan_resolutions() - plans,
                            again)
    return _port_runs[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_mixtral_scheduler_is_the_references(mode):
    """Every pool and admission kind against the reference's ``Scheduler``:
    tokens identical, logprobs within 1e-4, the slots (uid, prompt
    position, blocks) after every step and the counters equal, no prefix
    hit (rings are never shared), no drop, and a second run on a new
    scheduler resolves no plan and gives the same bits."""
    jm, jp, _, _ = _models("mixtral_8x7b", "fp32")
    rows = _sched_prompts()
    kw = dict(MODES[mode], num_slots=2, cache_len=SCHED_T)
    mine, drops, replans, again = _port_run(mode)
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
        assert np.array_equal(again["done"][uid].logprobs, f.logprobs)
    assert drops == 0 and replans == 0
    if "paged" in mode:
        assert mine["stats"]["prefix_hit_tokens"] == 0


@pytest.mark.parametrize("mode,base", [
    ("paged", "dense"), ("chunk24-paged", "chunk24-dense"),
    ("chunk8-dense", "dense"), ("chunk24-dense", "dense")])
def test_mixtral_paths_agree_within_the_port(mode, base):
    """Paged ≡ dense (the same calls on the same tokens: bit for bit) and
    chunked ≡ monolithic (other token groupings, dropless here: tokens
    identical, logprobs within 1e-4)."""
    a, b = _port_run(mode)[0], _port_run(base)[0]
    for uid, f in a["done"].items():
        np.testing.assert_array_equal(f.tokens, b["done"][uid].tokens)
        if mode.startswith("chunk") == base.startswith("chunk"):
            assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        else:
            np.testing.assert_allclose(f.logprobs, b["done"][uid].logprobs,
                                       rtol=TOL, atol=TOL)
