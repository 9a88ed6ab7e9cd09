"""Continuous batching over dense slots, the port's ``serving.scheduler``,
on the CPU against the reference.

deepseek-7b SMOKE (TT on ffn+attn, rank 4, fp32 cores) through both
packages, the reference's weights carried into the port by
``convert.from_jax_params`` and the prompts drawn with numpy from a seed.
Each test mirrors one of the reference's (``tests/test_serving.py``):

- Staggered admissions through a 2-slot pool give every request the tokens
  of the port's own ``generate_fixed`` of that prompt alone, and of the
  reference ``Scheduler`` fed the same schedule, both with
  ``bucket_prompts=False`` (the bucketed default is held against the
  reference's in ``tests/test_torch_prefill_graph.py``); logprobs within 1e-4 of the reference's (XLA and torch sum in
  other orders) and 1e-5 of the port's fixed loop.  At every checked step
  the reference's top-1/top-2 logit gap exceeds ten times 1e-4, which the
  tests assert.  On the three main paths: length 2 ``auto`` (fused2),
  length 3 ``auto`` (fused chain), length 2 ``cuda_step`` (step kernel),
  through the plain versions on the CPU.
- EOS frees a slot for a queued request; a single slot and a zero budget;
  ``engine.generate`` against ``generate_fixed`` and the reference's
  ``generate``, fp32 and int8 cores.
- The masked step: an inactive row keeps its position and k/v bit for
  bit, and the logits are the reference's; ``splice_cache`` writes what
  the reference's writes.
- Sampling: a seed gives the same tokens, alone in the pool or beside
  other requests; greedy requests draw nothing.
- The serve CLI's arrival mode.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.serving.engine import generate as jgenerate
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import plan as tplan
from repro_torch.serving.engine import generate, generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # port against the reference (logits, logprobs)
TOL_PORT = 1e-5     # scheduler against generate_fixed, inside the port
S, T = 8, 16
BUDGETS = [6, 3, 5]
# (TT length, port backend, reference backend, weight seed, prompt seed)
PATHS = {"len2-auto": (2, "auto", "auto", 0, 0),
         "len3-auto": (3, "auto", "auto", 1, 0),
         "len2-cuda_step": (2, "cuda_step", "pallas_step", 0, 0)}


def _tt(cls, length, backend, weights="fp32"):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend, weights=weights)


def _models(path, weights="fp32"):
    length, backend, jbackend, wseed, pseed = PATHS[path]
    jm = jbuild(jget_config("deepseek_7b", "smoke",
                            tt=_tt(JTTConfig, length, jbackend, weights)))
    jp = jm.init(jax.random.PRNGKey(wseed))
    tm = tbuild(tget_config("deepseek_7b", "smoke",
                            tt=_tt(TTTConfig, length, backend, weights)),
                device="cpu")
    if weights == "int8":
        jp = jm.quantize_params(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    prompts = np.random.default_rng(pseed).integers(
        0, jm.cfg.vocab_size, (3, S), dtype=np.int64)
    return jm, jp, tm, tp, prompts


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def pair2():
    return _models("len2-auto")


def _ref_greedy(jm, jp, tokens, steps, cache_len=T):
    """The reference's fixed-batch greedy decode of ``tokens [B, S]``,
    asserting the top-1/top-2 gap at every step: (tokens, logprobs)."""
    lg, cache = jm.jitted_prefill(cache_len)(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    step = jm.jitted_decode_step()
    toks, lps = [], []
    for t in range(steps):
        lg = np.asarray(lg)[:, -1].astype(np.float64)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 10 * TOL), (t, top2)
        tok = lg.argmax(-1)
        lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1))
        toks.append(tok)
        lps.append(lg[np.arange(len(tok)), tok] - lg.max(-1) - lse)
        if t + 1 < steps:
            lg, cache = step(jp, cache, jnp.asarray(tok[:, None], jnp.int32))
    return np.stack(toks, 1), np.stack(lps, 1)


def _port_alone(tm, tp, row, steps, cache_len=T):
    res = generate_fixed(tm, tp, {"tokens": torch.from_numpy(row[None]),
                                  "cache_len": cache_len}, steps)
    return res.tokens.numpy()[0], res.logprobs.numpy()[0]


def _staggered(sched, req_cls, rows):
    """r0 is admitted and decodes one step, r1 joins, r2 queues until a
    slot frees (2 slots)."""
    sched.submit(req_cls(uid=0, inputs={"tokens": rows[0:1]},
                         max_new_tokens=BUDGETS[0]))
    sched.step()
    sched.submit(req_cls(uid=1, inputs={"tokens": rows[1:2]},
                         max_new_tokens=BUDGETS[1]))
    sched.step()
    sched.submit(req_cls(uid=2, inputs={"tokens": rows[2:3]},
                         max_new_tokens=BUDGETS[2]))
    out = dict(sched.run())
    for f in sched.finished:
        out[f.uid] = f
    return out


def test_staggered_equals_sequential(pair):
    jm, jp, tm, tp, prompts = pair
    sched = Scheduler(tm, tp, num_slots=2, cache_len=T, bucket_prompts=False)
    plans0 = tplan.plan_resolutions()
    mine = _staggered(sched, Request, torch.from_numpy(prompts))
    assert tplan.plan_resolutions() == plans0
    assert tm.decode_graphs == {} and tm.graph_captures == 0   # eager
    ref = _staggered(JScheduler(jm, jp, num_slots=2, cache_len=T,
                                bucket_prompts=False), JRequest,
                     jnp.asarray(prompts, jnp.int32))
    assert sorted(mine) == sorted(ref) == [0, 1, 2]
    for uid, steps in enumerate(BUDGETS):
        ref_toks, ref_lps = _ref_greedy(jm, jp, prompts[uid:uid + 1], steps)
        alone_toks, alone_lps = _port_alone(tm, tp, prompts[uid], steps)
        np.testing.assert_array_equal(mine[uid].tokens, alone_toks)
        np.testing.assert_array_equal(mine[uid].tokens, ref[uid].tokens)
        np.testing.assert_array_equal(mine[uid].tokens, ref_toks[0])
        np.testing.assert_allclose(mine[uid].logprobs, ref[uid].logprobs,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(mine[uid].logprobs, alone_lps,
                                   rtol=TOL_PORT, atol=TOL_PORT)
        assert mine[uid].finish_reason == "length"
        assert mine[uid].prompt_len == S
        assert mine[uid].first_token_time is not None


def test_slot_reuse_after_eos(pair2):
    jm, jp, tm, tp, prompts = pair2
    steps = 6
    seq = {uid: _port_alone(tm, tp, prompts[uid], steps)[0]
           for uid in range(3)}
    for uid in range(3):
        np.testing.assert_array_equal(
            seq[uid], _ref_greedy(jm, jp, prompts[uid:uid + 1], steps)[0][0])
    eos = int(seq[0][1])
    sched = Scheduler(tm, tp, num_slots=1, cache_len=T, eos_id=eos)
    for uid in range(3):
        sched.submit(Request(uid=uid, inputs={
            "tokens": torch.from_numpy(prompts[uid:uid + 1])},
            max_new_tokens=steps))
    out = sched.run()
    assert sorted(out) == [0, 1, 2]
    cut = list(seq[0]).index(eos) + 1
    np.testing.assert_array_equal(out[0].tokens, seq[0][:cut])
    assert out[0].finish_reason == "eos"
    for uid in (1, 2):
        ref = list(seq[uid])
        stop = ref.index(eos) + 1 if eos in ref else steps
        np.testing.assert_array_equal(out[uid].tokens, ref[:stop])


def test_single_slot_and_zero_budget(pair2):
    _, _, tm, tp, prompts = pair2
    cache_len = S + 6
    rows = torch.from_numpy(prompts)
    sched = Scheduler(tm, tp, num_slots=1, cache_len=cache_len)
    sched.submit(Request(uid=0, inputs={"tokens": rows[0:1]},
                         max_new_tokens=0))
    sched.submit(Request(uid=1, inputs={"tokens": rows[1:2]},
                         max_new_tokens=4))
    out = sched.run()
    assert out[0].tokens.shape == (0,)
    assert out[0].finish_reason == "length"
    assert sched.admissions == 1                  # no prefill for uid 0
    np.testing.assert_array_equal(
        out[1].tokens, _port_alone(tm, tp, prompts[1], 4, cache_len)[0])
    with pytest.raises(ValueError, match="exceeds cache_len"):
        sched.submit(Request(uid=9, inputs={"tokens": rows[0:1]},
                             max_new_tokens=cache_len))


def test_cancel_frees_the_slot_and_keeps_partial_tokens(pair2):
    _, _, tm, tp, prompts = pair2
    rows = torch.from_numpy(prompts)
    sched = Scheduler(tm, tp, num_slots=1, cache_len=T)
    for uid in range(3):
        sched.submit(Request(uid=uid, inputs={"tokens": rows[uid:uid + 1]},
                             max_new_tokens=5))
    sched.step()                                  # uid 0: 2 tokens
    assert sched.cancel(0) and sched.cancel(2) and not sched.cancel(7)
    assert sched.num_active == 0 and sched.cancelled == 2
    out = sched.run()
    done = {f.uid: f for f in sched.finished}
    assert done[0].finish_reason == done[2].finish_reason == "cancelled"
    np.testing.assert_array_equal(
        done[0].tokens, _port_alone(tm, tp, prompts[0], 2)[0])
    assert done[2].tokens.shape == (0,)
    np.testing.assert_array_equal(out[1].tokens,
                                  _port_alone(tm, tp, prompts[1], 5)[0])


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_generate_matches_generate_fixed_and_the_reference(weights):
    jm, jp, tm, tp, prompts = _models("len2-auto", weights)
    steps, cache_len = 4, S + 5
    ref_toks, _ = _ref_greedy(jm, jp, prompts, steps, cache_len)
    jres = jgenerate(jm, jp, {"tokens": jnp.asarray(prompts, jnp.int32),
                              "cache_len": cache_len}, steps=steps)
    batch = {"tokens": torch.from_numpy(prompts), "cache_len": cache_len}
    res = generate(tm, tp, batch, steps)
    fixed = generate_fixed(tm, tp, batch, steps)
    assert tuple(res.tokens.shape) == (3, steps)
    np.testing.assert_array_equal(res.tokens.numpy(), fixed.tokens.numpy())
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(res.tokens.numpy(), ref_toks)
    np.testing.assert_allclose(res.logprobs.numpy(), np.asarray(jres.logprobs),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.logprobs.numpy(), fixed.logprobs.numpy(),
                               rtol=TOL_PORT, atol=TOL_PORT)


def _kv(cache, name):
    """The port's k or v of every layer, stacked [L, B, T, KV, hd]."""
    return torch.stack([layer["b0"][name] for layer in cache["g0"]])


def test_masked_step_matches_the_reference(pair):
    """Rows at depths S, S - 3 and S - 1; the middle one inactive: it keeps
    its position and every k/v entry bit for bit."""
    jm, jp, tm, tp, prompts = pair
    jl, jc = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(prompts,
                                                             jnp.int32)})
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts),
                            "cache_len": T})
    pos = np.array([S, S - 3, S - 1], np.int32)
    active = np.array([True, False, True])
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"] = torch.from_numpy(pos)
    frozen = [_kv(tc, n)[:, 1].clone() for n in ("k", "v")]
    step = jax.jit(jm.decode_step)
    forced = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, (3, 3),
                                               dtype=np.int64)
    for t in range(3):
        tok = forced[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(active))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      pos + (t + 1) * active)
    for name in ("k", "v"):
        np.testing.assert_allclose(_kv(tc, name).numpy(),
                                   np.asarray(jc["g0"]["b0"][name]),
                                   rtol=TOL, atol=TOL)
    for old, name in zip(frozen, ("k", "v")):
        assert torch.equal(_kv(tc, name)[:, 1], old)


def test_active_mask_needs_a_per_row_position(pair2):
    _, _, tm, tp, prompts = pair2
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts),
                            "cache_len": T})
    with pytest.raises(ValueError, match="per-row position"):
        tm.decode_step(tp, tc, torch.zeros((3, 1), dtype=torch.int64),
                       torch.ones(3, dtype=torch.bool))


def _to_port(jcache, tm) -> dict:
    """A reference cache (stacked layers) in the port's layout."""
    out = {"pos": torch.from_numpy(np.array(jcache["pos"]))}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [
            {f"b{i}": {n: torch.from_numpy(np.array(g[f"b{i}"][n][layer]))
                       for n in ("k", "v")} for i in range(len(period))}
            for layer in range(count)]
    return out


def test_splice_cache_writes_what_the_reference_writes(pair2):
    jm, jp, tm, tp, prompts = pair2
    _, pool = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(prompts,
                                                              jnp.int32)})
    pool = dict(pool, pos=jnp.asarray([S, S - 2, S + 1], jnp.int32))
    _, row = jm.jitted_prefill(T)(
        jp, {"tokens": jnp.asarray(prompts[2:3, :S - 3], jnp.int32)})
    want = jm.splice_cache(pool, row, 1)
    mine = _to_port(pool, tm)
    tm.splice_cache(mine, _to_port(row, tm), 1)
    got, ref = _to_port(want, tm), mine
    assert torch.equal(ref["pos"], got["pos"])
    assert int(ref["pos"][1]) == S - 3
    for name in ("k", "v"):
        assert torch.equal(_kv(ref, name), _kv(got, name))
    # and the port's own prefill row, into its own pool
    tpool = tm.init_cache(3, T, per_row=True)
    _, trow = tm.prefill(tp, {"tokens": torch.from_numpy(prompts[:1]),
                              "cache_len": T})
    tm.splice_cache(tpool, trow, 2)
    assert tpool["pos"].tolist() == [0, 0, S]
    for name in ("k", "v"):
        assert torch.equal(_kv(tpool, name)[:, 2], _kv(trow, name)[:, 0])
        assert not _kv(tpool, name)[:, :2].any()
    with pytest.raises(ValueError, match="one-row cache"):
        tm.splice_cache(tpool, tm.init_cache(2, T), 0)


def test_scheduler_refuses_what_is_not_ported(pair2):
    _, _, tm, tp, _ = pair2
    with pytest.raises(NotImplementedError, match="chunk_prefill"):
        Scheduler(tm, tp, num_slots=2, cache_len=T, chunk_prefill=True)
    with pytest.raises(TypeError, match="unexpected keyword"):
        Scheduler(tm, tp, num_slots=2, cache_len=T, bogus=1)
    with pytest.raises(ValueError, match="num_slots"):
        Scheduler(tm, tp, num_slots=0, cache_len=T)


def _sampled(tm, tp, rows, seed, others=()):
    """uid 0 sampled (temperature 0.8, top-k 20) from a generator seeded
    with ``seed``, beside the requests ``others``; its tokens."""
    gen = torch.Generator().manual_seed(seed)
    sched = Scheduler(tm, tp, num_slots=2, cache_len=T)
    for r in others:
        sched.submit(r)
    sched.submit(Request(uid=0, inputs={"tokens": rows[0:1]},
                         max_new_tokens=6, key=gen, temperature=0.8,
                         top_k=20))
    return sched.run()[0].tokens


def test_sampling_is_per_request_and_greedy_draws_nothing(pair2):
    _, _, tm, tp, prompts = pair2
    rows = torch.from_numpy(prompts)
    alone = _sampled(tm, tp, rows, 123)
    np.testing.assert_array_equal(alone, _sampled(tm, tp, rows, 123))
    greedy_gen = torch.Generator().manual_seed(7)
    state = greedy_gen.get_state().clone()
    beside = _sampled(tm, tp, rows, 123, others=[
        Request(uid=1, inputs={"tokens": rows[1:2]}, max_new_tokens=4,
                key=greedy_gen),
        Request(uid=2, inputs={"tokens": rows[2:3]}, max_new_tokens=3,
                temperature=1.0)])
    np.testing.assert_array_equal(alone, beside)
    assert torch.equal(greedy_gen.get_state(), state)
    assert not np.array_equal(alone, _sampled(tm, tp, rows, 124))
    # the default streams: one per uid, seeded from the scheduler's seed
    outs = []
    for seed in (0, 0, 1):
        sched = Scheduler(tm, tp, num_slots=2, cache_len=T, seed=seed)
        sched.submit(Request(uid=3, inputs={"tokens": rows[0:1]},
                             max_new_tokens=6, temperature=1.0))
        outs.append(sched.run()[3].tokens)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator lives on"):
        Scheduler(tm, tp, num_slots=2, cache_len=T).submit(Request(
            uid=4, inputs={"tokens": rows[0:1]}, max_new_tokens=2,
            key=types.SimpleNamespace(device=torch.device("cuda")),
            temperature=1.0))


def test_serve_cli_arrival_mode_runs_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--variant", "smoke", "--device", "cpu", "--slots", "2",
                      "--max-requests", "4", "--arrival-rate", "1000",
                      "--prompt-len", "8", "--steps", "4", "--tt",
                      "ffn,attn", "--tt-rank", "4", "--tt-backend", "auto",
                      "--assert-no-replan"])
    assert sorted(f.uid for f in out["finished"]) == [0, 1, 2, 3]
    assert all(len(f.tokens) == 4 and f.finish_reason == "length"
               for f in out["finished"])
    assert out["tokens_out"] == 16 and out["admissions"] == 4
    assert out["steps_run"] >= 6 and out["replans"] == out["captures"] == 0
    assert out["launches"] == {}                  # plain versions
    assert 0 < out["admit_share"] < 1 and out["kv_pool_bytes"] > 0
