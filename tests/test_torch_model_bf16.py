"""deepseek-7b SMOKE with bf16 parameters (TT on ffn+attn, rank 4) through
both packages on the CPU, as the full-width main paths run: length 2 with
``auto`` (fused2), length 3 with ``auto`` (the fused chain) and with
``cuda_step``, the reference built with ``param_dtype=jnp.bfloat16`` and its
weights carried into the port by ``convert.from_jax_params``.

Tolerance: ``TOL`` × the largest |reference logit|.  Both sides compute in
bf16 but round at different places (every matmul, norm and residual add;
XLA fuses some of them in fp32), so logits differ by a few bf16 ulps:
2e-2 is twice the bf16 kernel tolerance, about 5 ulps at the largest
logit.  Greedy tokens must be identical over ``GREEDY_STEPS``; the token
seed of each case is one whose reference top-1/top-2 gap exceeds twice that
tolerance at every step, which the test asserts.
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

WEIGHT_SEED = 0
B, S, STEPS, GREEDY_STEPS = 2, 8, 8, 4
TOL = 2e-2
# (length, port backend) → (reference backend, the port's resolved
# backend, token seed)
CASES = {(2, "auto"): ("auto", "cuda_fused2", 205),
         (3, "auto"): ("auto", "cuda_fused", 182),
         (3, "cuda_step"): ("pallas_step", "cuda_step", 182)}


def _tt(cls, length, backend):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", params=list(CASES),
                ids=lambda p: f"length{p[0]}-{p[1]}")
def pair(request):
    length, backend = request.param
    jbackend, resolved, seed = CASES[request.param]
    jm = jbuild(jget_config("deepseek_7b", "smoke", tt=_tt(
        JTTConfig, length, jbackend)), param_dtype=jnp.bfloat16)
    jp = jm.init(jax.random.PRNGKey(WEIGHT_SEED))
    tm = tbuild(tget_config("deepseek_7b", "smoke", tt=_tt(
        TTTConfig, length, backend)), param_dtype=torch.bfloat16,
        device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jm.cfg.vocab_size, (B, S), dtype=np.int64)
    forced = rng.integers(0, jm.cfg.vocab_size, (B, STEPS), dtype=np.int64)
    return jm, jp, tm, tp, tokens, forced, resolved


def _prefill(pair, cache_len=S + STEPS):
    jm, jp, tm, tp, tokens = pair[:5]
    jl, jc = jm.jitted_prefill(cache_len)(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": cache_len})
    return jl, jc, tl, tc


def _close(tl, jl, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), (what, err, np.abs(ref).max())


def test_bf16_params_route_as_configured(pair):
    _, _, tm, tp, _, _, resolved = pair
    plans = tm.plan_book._plans.values()
    assert {p.backend for p in plans} == {resolved}
    bundle = tp["g0"][0]["b0"]["ffn"]["up"]["tt"]
    assert bundle["c0"].dtype == torch.bfloat16


def test_bf16_prefill_and_teacher_forced_decode_logits_match(pair):
    jm, jp, tm, tp, _, forced, _ = pair
    jl, jc, tl, tc = _prefill(pair)
    _close(tl, jl, "prefill")
    step = jm.jitted_decode_step()
    plans0 = tplan.plan_resolutions()
    for t in range(STEPS):
        tok = forced[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close(tl, jl, f"step {t}")
    assert tplan.plan_resolutions() == plans0


def test_bf16_greedy_tokens_identical(pair):
    jm, jp, tm, tp, tokens, _, _ = pair
    jl, jc, _, _ = _prefill(pair, S + GREEDY_STEPS)
    step = jm.jitted_decode_step()
    ref_tokens = []
    for t in range(GREEDY_STEPS):
        lg = _f32(jl)[:, -1]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] >
                      2 * TOL * np.abs(lg).max()), (t, top2)
        tok = lg.argmax(-1)
        ref_tokens.append(tok)
        if t + 1 < GREEDY_STEPS:
            jl, jc = step(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
    res = generate_fixed(tm, tp, {"tokens": torch.from_numpy(tokens),
                                  "cache_len": S + GREEDY_STEPS},
                         GREEDY_STEPS)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.stack(ref_tokens, 1))
