"""The port's fused-chain and step kernels (the plain versions a CPU tensor
gets) against the reference's Pallas kernels in interpret mode, the
executor's ``cuda_fused``/``cuda_step``/``auto`` backends against the
reference's ``pallas_fused``/``pallas_step``/``auto`` at d=3, and the
wrappers' argument checks.

Tolerances: 1e-5 in fp32 (summation order); 1e-2 relative in bf16 (the
output is rounded to bf16, and the step chain rounds its state to bf16
between steps on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import BlockPlan
from repro.core.packing import pack_core as jpack
from repro.core.quant import pack_core_int8
from repro.core.quant import quantize_cores as jquantize
from repro.kernels import ops as jops
from repro.kernels.tt_contract import (tt_fused_chain_int8_pallas,
                                       tt_fused_chain_pallas,
                                       tt_step_int8_pallas, tt_step_pallas)
from repro_torch.core.packing import pack_core
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tt_contract

# (ns, ms, ranks, B): d = 2, 3, 4; modes 43 and 86 = 2·43 are not powers of
# two; B = 13 / 9 / 7 is not a multiple of the reference's 8-row tile
CHAIN_CASES = [
    ((2, 86), (43, 2), (1, 4, 1), 13),
    ((2, 3, 43), (5, 2, 3), (1, 3, 4, 1), 13),
    ((2, 2, 16), (32, 2, 2), (1, 4, 4, 1), 9),
    ((2, 2, 3, 2), (3, 2, 2, 2), (1, 2, 3, 2, 1), 7),
]
TILE = 8              # the reference's batch tile: B is ragged against it
BF = jnp.bfloat16


def _cores(ns, ms, ranks, B, seed=0):
    rng = np.random.default_rng(seed)
    cores = [rng.standard_normal((ranks[t], ns[t], ms[t], ranks[t + 1]))
             .astype(np.float32) * 0.5 for t in range(len(ns))]
    x = rng.standard_normal((B, int(np.prod(ns)))).astype(np.float32)
    return cores, x


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_fused_chain_plain_matches_pallas_fp32(ns, ms, ranks, B):
    cores, x = _cores(ns, ms, ranks, B)
    dims = (ns, ms, ranks)
    want = tt_fused_chain_pallas(
        jnp.asarray(x), [jpack(jnp.asarray(G)) for G in reversed(cores)],
        dims, block_b=TILE, interpret=True)
    got = tt_contract.tt_fused_chain(
        torch.from_numpy(x),
        [pack_core(torch.from_numpy(G)) for G in reversed(cores)], dims)
    assert got.dtype == torch.float32 and got.shape == (B, np.prod(ms))
    _close(got.numpy(), want)


@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_fused_chain_plain_matches_pallas_bf16(ns, ms, ranks, B):
    """bf16 in and out, an fp32 state inside on both sides."""
    cores, x = _cores(ns, ms, ranks, B, seed=1)
    dims = (ns, ms, ranks)
    want = tt_fused_chain_pallas(
        jnp.asarray(x).astype(BF),
        [jpack(jnp.asarray(G).astype(BF)) for G in reversed(cores)], dims,
        block_b=TILE, interpret=True).astype(jnp.float32)
    tb = torch.bfloat16
    got = tt_contract.tt_fused_chain(
        torch.from_numpy(x).to(tb),
        [pack_core(torch.from_numpy(G).to(tb)) for G in reversed(cores)],
        dims)
    assert got.dtype == tb
    _close(got.float().numpy(), want, 1e-2)


@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_fused_chain_int8_plain_matches_pallas(ns, ms, ranks, B):
    cores, x = _cores(ns, ms, ranks, B, seed=2)
    dims = (ns, ms, ranks)
    q = [pack_core_int8(jnp.asarray(G)) for G in reversed(cores)]
    want = tt_fused_chain_int8_pallas(
        jnp.asarray(x), [p for p, _ in q], [s for _, s in q], dims,
        block_b=TILE, interpret=True)
    got = tt_contract.tt_fused_chain_int8(
        torch.from_numpy(x), [torch.from_numpy(np.array(p)) for p, _ in q],
        torch.tensor([float(s) for _, s in q], dtype=torch.float32), dims)
    _close(got.numpy(), want)


def _step_inputs(ns, ms, ranks, B, seed):
    """(G, X) of every step of the chain, X the reference chain's state."""
    cores, x = _cores(ns, ms, ranks, B, seed)
    out, state = [], x.reshape(-1)
    for t in range(len(ns) - 1, -1, -1):
        G = cores[t]
        X = state.reshape(-1, G.shape[1], G.shape[3])
        out.append((G, X))
        state = np.einsum("rnmk,bnk->mbr", G, X).reshape(-1)
    return out


@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_step_plain_matches_pallas(ns, ms, ranks, B):
    """Block plans smaller than every extent, so the reference pads m and b
    and accumulates over several n blocks."""
    plan = BlockPlan(bm=2, bb=8, bn=2, traffic_bytes=0, vmem_bytes=0)
    for G, X in _step_inputs(ns, ms, ranks, B, seed=3):
        want = tt_step_pallas(jnp.asarray(G), jnp.asarray(X), plan,
                              interpret=True)
        got = tt_contract.tt_step(torch.from_numpy(G), torch.from_numpy(X))
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got.numpy(), want)


@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_step_int8_plain_matches_pallas(ns, ms, ranks, B):
    plan = BlockPlan(bm=2, bb=8, bn=2, traffic_bytes=0, vmem_bytes=0)
    for G, X in _step_inputs(ns, ms, ranks, B, seed=4):
        (qG,), (s,) = jquantize([jnp.asarray(G)])
        want = tt_step_int8_pallas(qG, s, jnp.asarray(X), plan,
                                   interpret=True)
        got = tt_contract.tt_step_int8(
            torch.from_numpy(np.array(qG)), torch.from_numpy(X),
            torch.tensor([float(s)], dtype=torch.float32))
        _close(got.numpy(), want)


# port backend → reference backend
PAIRS = [("cuda_fused", "pallas_fused"), ("cuda_step", "pallas_step"),
         ("auto", "auto")]
D3 = CHAIN_CASES[1][:3] + (6,)      # rows: not a multiple of any tile


@pytest.mark.parametrize("mine,theirs", PAIRS)
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_tt_forward_d3_matches_reference(mine, theirs, weights):
    ns, ms, ranks, B = D3
    cores, x = _cores(ns, ms, ranks, B, seed=5)
    jcores = [jnp.asarray(G) for G in cores]
    kw = {}
    if weights == "int8":
        jcores, jscales = jquantize(jcores)
        kw = {"weights": "int8", "scales": jscales}
        tcores = [torch.from_numpy(np.array(q)) for q in jcores]
        tscales = torch.tensor([float(s) for s in jscales])
    else:
        tcores, tscales = [torch.from_numpy(G) for G in cores], None
    bias = np.linspace(-1, 1, int(np.prod(ms)), dtype=np.float32)
    want = jops.tt_forward(jcores, jnp.asarray(x).reshape(2, 3, -1),
                           jnp.asarray(bias), backend=theirs,
                           interpret=True, **kw)
    got = tops.tt_forward(tcores, torch.from_numpy(x).reshape(2, 3, -1),
                          torch.from_numpy(bias), backend=mine,
                          scales=tscales)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)


@pytest.mark.parametrize("mine,theirs", PAIRS)
def test_tt_forward_d3_bf16_matches_reference(mine, theirs):
    """bf16 activations and cores; the step chain rounds its state to bf16
    between steps on both sides, the fused chain keeps it fp32."""
    ns, ms, ranks, B = D3
    cores, x = _cores(ns, ms, ranks, B, seed=6)
    want = jops.tt_forward([jnp.asarray(G).astype(BF) for G in cores],
                           jnp.asarray(x).astype(BF), backend=theirs,
                           interpret=True)
    tb = torch.bfloat16
    got = tops.tt_forward([torch.from_numpy(G).to(tb) for G in cores],
                          torch.from_numpy(x).to(tb), backend=mine)
    assert got.dtype == tb
    _close(got.float().numpy(), want.astype(jnp.float32), 1e-2)


def test_step_chain_rounds_its_state_between_steps():
    """In bf16 the step chain and the fused chain differ by the rounding of
    the intermediate state, as in the reference."""
    ns, ms, ranks, B = D3
    cores, x = _cores(ns, ms, ranks, B, seed=6)
    tb = torch.bfloat16
    tc = [torch.from_numpy(G).to(tb) for G in cores]
    xb = torch.from_numpy(x).to(tb)
    step = tops.tt_forward(tc, xb, backend="cuda_step")
    fused = tops.tt_forward(tc, xb, backend="cuda_fused")
    assert not torch.equal(step, fused)
    _close(step.float().numpy(), fused.float().numpy(), 1e-1)


def _chain_args(dtype=torch.float32, wdtype=None):
    ns, ms, ranks, B = D3
    wdtype = wdtype or dtype
    x = torch.zeros(B, int(np.prod(ns)), dtype=dtype)
    packed = [torch.zeros(ns[t] * ranks[t + 1], ms[t] * ranks[t],
                          dtype=wdtype) for t in reversed(range(len(ns)))]
    return x, packed, (ns, ms, ranks)


def test_chain_wrapper_rejects_bad_arguments():
    x, packed, dims = _chain_args()
    with pytest.raises(TypeError):                       # activation dtype
        tt_contract.tt_fused_chain(x.double(), [p.double() for p in packed],
                                   dims)
    with pytest.raises(TypeError):                       # core dtype
        tt_contract.tt_fused_chain(
            x, [packed[0].to(torch.bfloat16)] + packed[1:], dims)
    with pytest.raises(ValueError):                      # core shape
        tt_contract.tt_fused_chain(
            x, [packed[0][:, :-1].contiguous()] + packed[1:], dims)
    with pytest.raises(ValueError):                      # x width
        tt_contract.tt_fused_chain(x[:, :-1].contiguous(), packed, dims)
    with pytest.raises(ValueError):                      # core count
        tt_contract.tt_fused_chain(x, packed[:2], dims)
    with pytest.raises(ValueError):                      # contiguity
        tt_contract.tt_fused_chain(
            x, packed[:2] + [packed[2].t().contiguous().t()], dims)
    with pytest.raises(ValueError):
        tt_contract.tt_fused_chain(x.t().contiguous().t(), packed, dims)
    with pytest.raises(ValueError):                      # not a device
        tt_contract.tt_fused_chain(x.to("meta"),
                                   [p.to("meta") for p in packed], dims)
    xq, pq, dims = _chain_args(wdtype=torch.int8)
    with pytest.raises(TypeError):                       # fp cores on int8
        tt_contract.tt_fused_chain_int8(x, packed, torch.ones(3), dims)
    with pytest.raises(ValueError):                      # scales count
        tt_contract.tt_fused_chain_int8(xq, pq, torch.ones(2), dims)
    with pytest.raises(ValueError):                      # scales dtype
        tt_contract.tt_fused_chain_int8(xq, pq, torch.ones(3).double(), dims)


def test_step_wrapper_rejects_bad_arguments():
    G = torch.zeros(4, 3, 2, 5)
    X = torch.zeros(7, 3, 5)
    with pytest.raises(TypeError):                       # activation dtype
        tt_contract.tt_step(G.double(), X.double())
    with pytest.raises(TypeError):                       # core dtype
        tt_contract.tt_step(G.to(torch.bfloat16), X)
    with pytest.raises(ValueError):                      # n mismatch
        tt_contract.tt_step(G, torch.zeros(7, 4, 5))
    with pytest.raises(ValueError):                      # r1 mismatch
        tt_contract.tt_step(G, torch.zeros(7, 3, 4))
    with pytest.raises(ValueError):                      # contiguity
        tt_contract.tt_step(G, X.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):                      # not a device
        tt_contract.tt_step(G.to("meta"), X.to("meta"))
    Gq = G.to(torch.int8)
    with pytest.raises(TypeError):                       # fp core on int8
        tt_contract.tt_step_int8(G, X, torch.ones(1))
    with pytest.raises(ValueError):                      # one scale
        tt_contract.tt_step_int8(Gq, X, torch.ones(2))
    with pytest.raises(ValueError):                      # scale dtype
        tt_contract.tt_step_int8(Gq, X, torch.ones(1).double())


def test_int8_chain_backends_need_the_scales():
    """int8 cores run only with their per-core scales."""
    ns, ms, ranks, B = D3
    cores, x = _cores(ns, ms, ranks, B)
    for backend in ("cuda_fused", "cuda_step"):
        with pytest.raises(ValueError, match="scales"):
            tops.tt_forward([torch.from_numpy(G).to(torch.int8)
                             for G in cores], torch.from_numpy(x),
                            backend=backend)
