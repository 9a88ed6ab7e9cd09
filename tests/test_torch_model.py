"""deepseek-7b SMOKE (TT on ffn+attn, rank 4, backend auto) through both
packages on the CPU, fp32 and int8 cores, with the reference's weights
carried into the port by ``convert.from_jax_params``.

Tolerance 1e-4 on logits: XLA and torch sum in different orders on the
CPU.  Greedy tokens must be identical; the seed is one whose top-1/top-2
logit gap exceeds that tolerance at every step, which the test asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import plan as tplan
from repro_torch.serving.engine import generate_fixed

SEED = 0
B, S, STEPS = 2, 8, 8
TOL = 1e-4


def _tt(cls, weights):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               backend="auto", weights=weights)


@pytest.fixture(scope="module", params=["fp32", "int8"])
def pair(request):
    weights = request.param
    jm = jbuild(jget_config("deepseek_7b", "smoke", tt=_tt(JTTConfig,
                                                           weights)))
    jp = jm.init(jax.random.PRNGKey(SEED))
    tm = tbuild(tget_config("deepseek_7b", "smoke", tt=_tt(TTTConfig,
                                                           weights)),
                device="cpu")
    if weights == "int8":
        jp = jm.quantize_params(jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, jm.cfg.vocab_size, (B, S), dtype=np.int64)
    forced = rng.integers(0, jm.cfg.vocab_size, (B, STEPS), dtype=np.int64)
    return jm, jp, tm, tp, tokens, forced


def _prefill(pair):
    jm, jp, tm, tp, tokens, _ = pair
    jl, jc = jm.jitted_prefill(S + STEPS)(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": S + STEPS})
    return jl, jc, tl, tc


def test_tt_layers_route_to_fused2_with_stored_cores(pair):
    _, _, tm, tp, _, _ = pair
    book = tm.plan_book
    assert len(book) == 3
    assert {p.backend for p in book._plans.values()} == {"cuda_fused2"}
    bundle = tp["g0"][0]["b0"]["ffn"]["up"]["tt"]
    if tm.cfg.tt.weights == "int8":
        assert bundle["c0"].dtype == torch.int8
        assert bundle["scales"].shape == (2,)
    else:
        assert bundle["c0"].dtype == torch.float32


def test_prefill_logits_match(pair):
    jl, _, tl, _ = _prefill(pair)
    assert tl.shape == (B, 1, pair[0].cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_teacher_forced_decode_logits_match(pair):
    jm, jp, tm, tp, _, forced = pair
    _, jc, _, tc = _prefill(pair)
    step = jm.jitted_decode_step()
    plans0 = tplan.plan_resolutions()
    for t in range(STEPS):
        tok = forced[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
    assert tplan.plan_resolutions() == plans0


def test_greedy_tokens_identical(pair):
    jm, jp, tm, tp, tokens, _ = pair
    jl, jc, _, _ = _prefill(pair)
    step = jm.jitted_decode_step()
    ref_tokens = []
    for t in range(STEPS):
        lg = np.asarray(jl)[:, -1]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 10 * TOL), (t, top2)
        tok = lg.argmax(-1)
        ref_tokens.append(tok)
        if t + 1 < STEPS:
            jl, jc = step(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
    ref_tokens = np.stack(ref_tokens, 1)

    tm.plan_book
    plans0 = tplan.plan_resolutions()
    res = generate_fixed(tm, tp, {"tokens": torch.from_numpy(tokens),
                                  "cache_len": S + STEPS}, STEPS)
    assert tplan.plan_resolutions() == plans0
    np.testing.assert_array_equal(res.tokens.numpy(), ref_tokens)


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_serve_cli_runs_on_cpu(weights):
    from repro_torch.launch import serve
    out = serve.main(["--variant", "smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--steps", "4", "--tt",
                      "ffn,attn", "--tt-rank", "4", "--tt-backend", "auto",
                      "--tt-weights", weights])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["replans"] == 0 and out["launches"] == {}   # plain path
    assert bool(torch.isfinite(out["logprobs"]).all())


def test_profile_cli_runs_on_cpu():
    from repro_torch.launch import profile_serve
    out = profile_serve.main(["--variant", "smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8", "--steps",
                              "2", "--tt", "ffn,attn", "--tt-rank", "4",
                              "--tt-backend", "auto"])
    assert out["wall_s"] > 0 and out["busy_s"] is None
