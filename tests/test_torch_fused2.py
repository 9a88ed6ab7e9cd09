"""The port's fused d=2 TT layer (the plain version a CPU tensor gets)
against the reference's Pallas kernels in interpret mode, plus the
wrapper's argument checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_core as jpack
from repro.core.quant import pack_core_int8
from repro.kernels.tt_contract import tt_fused2_int8_pallas, tt_fused2_pallas
from repro_torch.core.packing import pack_core
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import tt_contract

# (n1, n2, m1, m2, r1, B): n2 = 2·43 and m1 = 43 are not powers of two, and
# B = 13 / 37 is not a multiple of any tile
CASES = [
    (2, 8, 4, 2, 3, 5),
    (2, 86, 43, 2, 4, 13),
    (4, 16, 8, 4, 16, 37),
]


def _inputs(n1, n2, m1, m2, r1, B, seed=0):
    rng = np.random.default_rng(seed)
    G1 = rng.standard_normal((1, n1, m1, r1)).astype(np.float32) * 0.3
    G2 = rng.standard_normal((r1, n2, m2, 1)).astype(np.float32) * 0.3
    x = rng.standard_normal((B, n1 * n2)).astype(np.float32)
    return G1, G2, x


@pytest.mark.parametrize("n1,n2,m1,m2,r1,B", CASES)
def test_fused2_plain_matches_pallas_fp32(n1, n2, m1, m2, r1, B):
    G1, G2, x = _inputs(n1, n2, m1, m2, r1, B)
    dims = (n1, n2, m1, m2, r1)
    ref = np.asarray(tt_fused2_pallas(
        jnp.asarray(x), jpack(jnp.asarray(G2)), jpack(jnp.asarray(G1)),
        dims, interpret=True))
    got = tt_contract.tt_fused2(
        torch.from_numpy(x), pack_core(torch.from_numpy(G2)),
        pack_core(torch.from_numpy(G1)), dims)
    assert got.dtype == torch.float32 and got.shape == (B, m1 * m2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n1,n2,m1,m2,r1,B", CASES)
def test_fused2_plain_matches_pallas_bf16(n1, n2, m1, m2, r1, B):
    """bf16 in and out, fp32 inside on both sides; 1e-2 relative because
    the output is rounded to bf16 (8 significant bits)."""
    G1, G2, x = _inputs(n1, n2, m1, m2, r1, B, seed=1)
    dims = (n1, n2, m1, m2, r1)
    bf = jnp.bfloat16
    ref = np.asarray(tt_fused2_pallas(
        jnp.asarray(x).astype(bf), jpack(jnp.asarray(G2).astype(bf)),
        jpack(jnp.asarray(G1).astype(bf)), dims, interpret=True
    ).astype(jnp.float32))
    tb = torch.bfloat16
    got = tt_contract.tt_fused2(
        torch.from_numpy(x).to(tb), pack_core(torch.from_numpy(G2).to(tb)),
        pack_core(torch.from_numpy(G1).to(tb)), dims)
    assert got.dtype == tb
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("n1,n2,m1,m2,r1,B", CASES)
def test_fused2_int8_plain_matches_pallas(n1, n2, m1, m2, r1, B):
    G1, G2, x = _inputs(n1, n2, m1, m2, r1, B, seed=2)
    dims = (n1, n2, m1, m2, r1)
    p2q, s2 = pack_core_int8(jnp.asarray(G2))
    p1q, s1 = pack_core_int8(jnp.asarray(G1))
    ref = np.asarray(tt_fused2_int8_pallas(
        jnp.asarray(x), p2q, p1q, [s2, s1], dims, interpret=True))
    got = tt_contract.tt_fused2_int8(
        torch.from_numpy(x), torch.from_numpy(np.array(p2q)),
        torch.from_numpy(np.array(p1q)),
        torch.tensor([float(s2), float(s1)], dtype=torch.float32), dims)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _valid(dtype=torch.float32, wdtype=None):
    n1, n2, m1, m2, r1 = dims = (2, 8, 4, 2, 3)
    wdtype = wdtype or dtype
    x = torch.zeros(3, n1 * n2, dtype=dtype)
    p2 = torch.zeros(n2, m2 * r1, dtype=wdtype)
    p1 = torch.zeros(n1 * r1, m1, dtype=wdtype)
    return x, p2, p1, dims


def test_wrapper_rejects_bad_arguments():
    x, p2, p1, dims = _valid()
    with pytest.raises(TypeError):                       # activation dtype
        tt_contract.tt_fused2(x.double(), p2.double(), p1.double(), dims)
    with pytest.raises(TypeError):                       # core dtype
        tt_contract.tt_fused2(x, p2.to(torch.bfloat16), p1, dims)
    with pytest.raises(ValueError):                      # core shape
        tt_contract.tt_fused2(x, p2[:, :-1].contiguous(), p1, dims)
    with pytest.raises(ValueError):                      # x width
        tt_contract.tt_fused2(x[:, :-1].contiguous(), p2, p1, dims)
    with pytest.raises(ValueError):                      # contiguity
        tt_contract.tt_fused2(x, p2, p1.t().contiguous().t(), dims)
    with pytest.raises(ValueError):
        tt_contract.tt_fused2(x.t().contiguous().t(), p2, p1, dims)
    xq, p2q, p1q, dims = _valid(wdtype=torch.int8)
    s = torch.ones(2)
    with pytest.raises(TypeError):                       # fp cores on int8
        tt_contract.tt_fused2_int8(x, p2, p1, s, dims)
    with pytest.raises(ValueError):                      # scales shape
        tt_contract.tt_fused2_int8(xq, p2q, p1q, torch.ones(3), dims)
    with pytest.raises(ValueError):                      # scales dtype
        tt_contract.tt_fused2_int8(xq, p2q, p1q, s.double(), dims)
    with pytest.raises(ValueError):                      # not a device
        tt_contract.tt_fused2(x.to("meta"), p2.to("meta"), p1.to("meta"),
                              dims)


def test_plan_routes_d2_to_fused2_and_rejects_oversized_intermediate():
    p = tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1))
    assert p.backend == "cuda_fused2" and p.weights == "fp"
    assert tplan.plan_tt_forward((6,), (4,), (1, 1)).backend == "einsum"
    tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1), smem_bytes=4096)
    with pytest.raises(ValueError, match="shared memory"):
        tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1),
                              smem_bytes=4095)
    # d≥3 chains go to the fused chain (tests/test_torch_plan_chain.py)
    assert tplan.plan_tt_forward((2, 2, 2), (2, 2, 2),
                                 (1, 2, 2, 1)).backend == "cuda_fused"


@pytest.mark.parametrize("smem,want", [
    (232_448, 32),             # H100: 32 rows · 4 KB ≤ 227 KB, the cap
    (65_536, 16),              # 16 rows · 4 KB
    (4_096, 1),                # exactly one row
])
def test_fused2_batch_tile_is_what_shared_memory_holds(smem, want):
    assert tt_contract.fused2_batch_tile(8, 8, 16, smem) == want


def test_fused2_batch_tile_rejects_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.fused2_batch_tile(8, 8, 16, 4_095)


def test_int8_plan_refuses_float_cores():
    """int8 serving takes cores stored by ``Model.quantize_params``; float
    cores are never quantized per call."""
    from repro_torch.kernels.ops import tt_forward
    G1, G2, x = _inputs(2, 8, 4, 2, 3, 5)
    cores = [torch.from_numpy(G1), torch.from_numpy(G2)]
    plan = tplan.plan_tt_forward((2, 8), (4, 2), (1, 3, 1), weights="int8")
    with pytest.raises(ValueError, match="quantize_params"):
        tt_forward(cores, torch.from_numpy(x), plan=plan)


@pytest.mark.parametrize("B,m1,want", [
    (4, 1376, (1, 33)),        # decode: 4 row tiles, columns split
    (256, 1376, (2, 1)),       # prefill: 128 row tiles fill the SMs
    (4, 40, (1, 2)),           # at least 32 columns per block
    (10_000, 512, (32, 1)),    # shared memory caps the rows per block
])
def test_launch_geometry(B, m1, want):
    assert tt_contract.launch_geometry(B, m1, 32, 132) == want
