"""The port's TT math, DSE picks and int8 quantization against the JAX
reference, on the CPU.  Inputs are drawn with numpy from a seed and handed
to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import tt as jtt
from repro.models import layers as jlayers
from repro_torch.core import quant as tquant
from repro_torch.core import tt as ttt
from repro_torch.models import layers as tlayers

# (M, N, rank, min_factor): the SMOKE widths of deepseek-7b (rank 4,
# min_factor 2) and the three full-width projections (rank 16, min_factor 8)
PLAN_CASES = [
    (128, 64, 4, 2), (64, 128, 4, 2), (64, 64, 4, 2),
    (11008, 4096, 16, 8), (4096, 11008, 16, 8), (4096, 4096, 16, 8),
]


@pytest.mark.parametrize("M,N,rank,min_factor", PLAN_CASES)
def test_plan_for_matches_reference(M, N, rank, min_factor):
    ref = jlayers.plan_for(M, N, rank, 2, min_factor)
    got = tlayers.plan_for(M, N, rank, 2, min_factor)
    assert (got.ms, got.ns, got.ranks) == (ref.ms, ref.ns, ref.ranks)


def test_full_width_plans_are_the_deployed_shapes():
    want = {(11008, 4096): ((1376, 8), (8, 512)),
            (4096, 11008): ((512, 8), (8, 1376)),
            (4096, 4096): ((512, 8), (8, 512))}
    for (M, N), (ms, ns) in want.items():
        p = tlayers.plan_for(M, N, 16, 2, 8)
        assert (p.ms, p.ns, p.ranks) == (ms, ns, (1, 16, 1))


def _cores(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]


@pytest.mark.parametrize("ms,ns,rank,B", [
    ((4, 3), (2, 5), 3, 7),
    ((32, 2), (2, 32), 4, 5),
    ((4, 2, 3), (3, 2, 2), 2, 4),       # d=3 chain math
    ((6,), (10,), 1, 3),                # d=1
])
def test_tt_apply_matches_reference(ms, ns, rank, B):
    rng = np.random.default_rng(0)
    plan = jtt.make_plan(ms, ns, rank)
    cores = _cores(rng, plan.core_shapes)
    x = rng.standard_normal((B, plan.N)).astype(np.float32)
    ref = np.asarray(jtt.tt_apply([jnp.asarray(c) for c in cores],
                                  jnp.asarray(x)))
    got = ttt.tt_apply([torch.from_numpy(c) for c in cores],
                       torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    dense = np.asarray(jtt.tt_reconstruct([jnp.asarray(c) for c in cores]))
    np.testing.assert_allclose(
        ttt.tt_reconstruct([torch.from_numpy(c) for c in cores]).numpy(),
        dense, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,scale", [
    ((1, 8, 16, 4), 1.0), ((4, 32, 2, 1), 0.05), ((2, 3, 5, 2), 300.0)])
def test_int8_codes_and_scales_bit_identical(shape, scale):
    rng = np.random.default_rng(1)
    G = (rng.standard_normal(shape) * scale).astype(np.float32)
    # exact half-way points exercise round-half-to-even on both sides
    G.flat[:4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32) * (
        np.abs(G).max() / 127.0)
    q_ref, s_ref = jquant.quantize_core(jnp.asarray(G))
    q, s = tquant.quantize_core(torch.from_numpy(G))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.numpy().tobytes() == np.asarray(s_ref, np.float32).tobytes()


def test_zero_core_quantizes_to_zero_with_unit_scale():
    q, s = tquant.quantize_core(torch.zeros(1, 2, 3, 1))
    assert float(s) == 1.0 and int(q.abs().max()) == 0
