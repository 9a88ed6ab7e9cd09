"""The port's fused d=2 TT layer (the plain version a CPU tensor gets)
against the reference's Pallas kernels in interpret mode, plus the
wrapper's argument checks, the launch's tiles and shared-memory rule
(``tt_contract.fused2_geometry``, ``fused2_smem_bytes``) and the arguments
the launch passes, recorded by a stand-in library, at deepseek-7b's,
gemma3-4b's and mixtral-8x7b's shapes, and for the expert-batched entries
(``tt_fused2_experts[_int8]``, the experts folded into the grid)."""
import contextlib

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
    # one row's block at the smallest chunks, fp32 activations and cores
    # (the largest): 39,168 bytes (test_fused2_smem_bytes_of_one_row)
    tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1),
                          smem_bytes=39_168)
    with pytest.raises(ValueError, match="shared memory"):
        tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1),
                              smem_bytes=39_167)
    # d≥3 chains go to the fused chain (tests/test_torch_plan_chain.py)
    assert tplan.plan_tt_forward((2, 2, 2), (2, 2, 2),
                                 (1, 2, 2, 1)).backend == "cuda_fused"


@pytest.mark.parametrize("smem,want", [
    (232_448, 16),             # H100: the 128 stage-1 rows of n1 = 8, the cap
    (65_536, 12),              # 96 rows of x in the stage-1 ring
    (39_168, 2),               # one row's block; two fill the same tiles
])
def test_fused2_batch_tile_is_what_shared_memory_holds(smem, want):
    assert tt_contract.fused2_batch_tile(8, 8, 16, smem) == want


def test_fused2_batch_tile_rejects_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.fused2_batch_tile(8, 8, 16, 39_167)


def test_fused2_smem_bytes_of_one_row():
    """bb = 1, g = 1, 16-value chunks, fp32 activations and cores: A
    [16, 128 + 4] fp32 (8,448 B), two P1 chunks [128, 16 + 4] fp32
    (20,480 B), four (x, P2) chunks of [16, 16 + 4] fp32 each (10,240 B)."""
    assert tt_contract.fused2_smem_bytes(8, 16, 1, 1, 16, 16, 4, 4) == \
        8_448 + 20_480 + 10_240


@pytest.mark.parametrize("w_bytes,want", [
    # A hi + lo [16, 136] bf16 8,704; two P1 chunks [128, 264] bf16
    # 135,168; four (x [16, 72], P2 [64, 136]) bf16 chunks 78,848
    (2, 8_704 + 135_168 + 78_848),
    # int8 cores: P1 chunks [128, 272] int8 69,632 + their bf16 widening
    # [128, 264] 67,584; (x, P2 [64, 144] int8) chunks 46,080 + the P2
    # widening [64, 136] bf16 17,408
    (1, 8_704 + 69_632 + 67_584 + 46_080 + 17_408),
])
def test_fused2_smem_bytes_at_prefill(w_bytes, want):
    """The 256-row block: 2 rows, all 8 i2, 64-value chunks of n2,
    256-column chunks of m1, bf16 activations on the tensor cores."""
    assert tt_contract.fused2_smem_bytes(8, 16, 2, 8, 64, 256, 2,
                                         w_bytes) == want


def test_int8_plan_refuses_float_cores():
    """int8 serving takes cores stored by ``Model.quantize_params``; float
    cores are never quantized per call."""
    from repro_torch.kernels.ops import tt_forward
    G1, G2, x = _inputs(2, 8, 4, 2, 3, 5)
    cores = [torch.from_numpy(G1), torch.from_numpy(G2)]
    plan = tplan.plan_tt_forward((2, 8), (4, 2), (1, 3, 1), weights="int8")
    with pytest.raises(ValueError, match="quantize_params"):
        tt_forward(cores, torch.from_numpy(x), plan=plan)


ATTN, GATE_UP, DOWN = ((8, 512, 512, 8, 16), (8, 512, 1376, 8, 16),
                       (8, 1376, 512, 8, 16))


@pytest.mark.parametrize("B,dims,want", [
    # decode: one row tile × 8 i2 groups, m1 cut into 15–16 slices; the
    # three chunks issued before the first wait cover n2
    (4, GATE_UP, (4, 1, 96, 176, 96, (1, 8, 15))),
    # prefill: all 8 i2 per block, 2 rows each: 128 blocks, no slices
    (256, GATE_UP, (2, 8, 1376, 64, 256, (128, 1, 1))),
    # decode at n2 = 1376: the stage-1 ring's budget caps the chunk
    (4, DOWN, (4, 1, 32, 208, 32, (1, 8, 16))),
    (10_000, ATTN, (2, 8, 512, 64, 256, (5000, 1, 1))),
    # too few rows for whole-m2 blocks: 16-row tiles, m1 cut in 5 or 2
    (37, DOWN, (16, 1, 112, 64, 112, (3, 8, 5))),
    (128, GATE_UP, (16, 1, 688, 64, 256, (8, 8, 2))),
])
def test_launch_geometry(B, dims, want):
    geo = tt_contract.fused2_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448


@pytest.mark.parametrize("B", [4, 37, 256])
@pytest.mark.parametrize("dims", [ATTN, GATE_UP, DOWN, (2, 86, 43, 2, 4),
                                  (2, 8, 4, 2, 3)])
def test_fp32_tiles_give_each_thread_one_column(dims, B):
    """fp32 activations: stage tiles are powers of two wide (stage 1's
    width from ``fused2_smem_bytes``'s rule, stage 2's chunk) and hold at
    most 512 threads × 8 outputs."""
    n1, n2, m1, m2, r1 = dims
    geo = tt_contract.fused2_geometry(B, dims, 4, 4, 132, 232_448)
    n1p = tt_contract._stage1_width(geo.g, r1, 4)
    for width in (n1p, geo.nct):
        assert width >= 16 and width & (width - 1) == 0
    assert -(-geo.bb * n1 // 16) * 16 * n1p <= 4096
    assert -(-geo.g * geo.bb // 16) * 16 * geo.nct <= 4096
    assert geo.smem <= 232_448


@pytest.mark.parametrize("r1,m2,want", [(16, 8, 1), (4, 8, 4), (3, 8, 6),
                                        (3, 2, 2), (32, 8, 1)])
def test_fused2_group_fills_one_tensor_core_tile(r1, m2, want):
    assert tt_contract.fused2_group(m2, r1) == want


@pytest.mark.parametrize("B,dims,want", [
    # decode, ffn gate/up at length 3: m_2 in pairs, 4 × 8 × 4 blocks
    (4, ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)), (1, 1, 2, 176, (4, 8, 4))),
    # prefill: whole modes, 2 rows a block, 128 blocks
    (256, ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)),
     (2, 8, 8, 96, (128, 1, 1))),
    # d = 2 through the chain, ffn gate/up at length 2: one m2 value and a
    # quarter of m1 = 1376 a block, 4 × 8 × 4 blocks
    (4, ((8, 512), (1376, 8), (1, 16, 1)), (1, 1, 344, 352, (4, 8, 4))),
    # shared memory caps the rows per block (and cuts the cores' columns)
    (10_000, ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1)),
     (3, 8, 8, 16, (3334, 1, 1))),
])
def test_chain_launch_geometry(B, dims, want):
    """The fused chain's (rows, m_{d-1} group, m_{d-2} group, column chunk,
    grid) in bf16."""
    geo = tt_contract.chain_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.g2, geo.ncc, geo.grid) == want
    assert geo.smem == tt_contract.chain_smem_bytes(
        *dims, geo.bb, geo.g, geo.g2, geo.ncc, geo.stages, 2, 2) <= 232_448


class _FakeLib:
    """Records the arguments of one entry point instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_launch(monkeypatch):
    """The launch glue without a card: the library, stream and device guard
    are stand-ins, the tensors stay on the CPU."""
    lib = _FakeLib()
    monkeypatch.setattr(tt_contract, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield lib
    tt_contract.reset_launch_counts()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [4, 37, 256])
@pytest.mark.parametrize("dims", [ATTN, GATE_UP, DOWN],
                         ids=["attn", "gate_up", "down"])
def test_fused2_launch_passes_its_geometry(fake_launch, dims, B, int8):
    n1, n2, m1, m2, r1 = dims
    wd = torch.int8 if int8 else torch.bfloat16
    x = torch.zeros(B, n1 * n2, dtype=torch.bfloat16)
    p2 = torch.zeros(n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(n1 * r1, m1, dtype=wd)
    scales = torch.ones(2) if int8 else None
    name = "tt_fused2_int8" if int8 else "tt_fused2"
    y = tt_contract._launch_fused2(name, x, p2, p1, scales, dims)
    assert y.shape == (B, m1 * m2) and y.dtype == torch.bfloat16
    (fn, args), = fake_launch.calls
    assert fn == name + "_bf16"
    ptrs = [x.data_ptr(), p2.data_ptr(), p1.data_ptr()] + (
        [scales.data_ptr()] if int8 else []) + [y.data_ptr()]
    k = len(ptrs)
    assert list(args[:k]) == ptrs
    assert args[k:k + 6] == (B, n1, n2, m1, m2, r1)
    geo = tt_contract.fused2_geometry(B, dims, 2, 2 - int8, 132, 232_448)
    assert args[k + 6:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    # no stage-1 recompute across i2; the grid covers every row and column
    assert geo.g * geo.grid[1] >= m2 and geo.bb * geo.grid[0] >= B
    assert geo.nc * geo.grid[2] >= m1 and geo.nc % 16 == 0
    if B <= 37:   # decode-sized batches: the blocks cover most SMs
        assert 120 <= geo.grid[0] * geo.grid[1] * geo.grid[2] <= 132
    assert tt_contract.launch_counts() == {name: 1}


# gemma3-4b's projections at rank 16, length 2 (``plan_for``): q
# 2560→2048, k/v 2560→1024, o 2048→2560, gate/up 2560→10240, down
# 10240→2560
GEMMA3 = {"q": (8, 320, 256, 8, 16), "kv": (8, 320, 128, 8, 16),
          "o": (8, 256, 320, 8, 16), "gate_up": (8, 320, 1280, 8, 16),
          "down": (8, 1280, 320, 8, 16)}


@pytest.mark.parametrize("B,name,want", [
    # decode: one row tile × 8 i2 groups, m1 cut into slices of 16–80
    # columns (m1 of 128 or 320 leaves 64 or 80 blocks)
    (4, "q", (4, 1, 16, 112, 16, (1, 8, 16))),
    (4, "kv", (4, 1, 16, 112, 16, (1, 8, 8))),
    (4, "o", (4, 1, 32, 96, 32, (1, 8, 10))),
    (4, "gate_up", (4, 1, 80, 112, 80, (1, 8, 16))),
    (4, "down", (4, 1, 32, 208, 32, (1, 8, 10))),
    # prefill and the 1,024-token admission bucket: whole-m2 blocks of 2
    # rows, no slices
    (256, "q", (2, 8, 256, 64, 256, (128, 1, 1))),
    (256, "kv", (2, 8, 128, 64, 128, (128, 1, 1))),
    (256, "o", (2, 8, 320, 64, 256, (128, 1, 1))),
    (256, "gate_up", (2, 8, 1280, 64, 256, (128, 1, 1))),
    (256, "down", (2, 8, 320, 64, 256, (128, 1, 1))),
    (1024, "q", (2, 8, 256, 64, 256, (512, 1, 1))),
    (1024, "kv", (2, 8, 128, 64, 128, (512, 1, 1))),
    (1024, "o", (2, 8, 320, 64, 256, (512, 1, 1))),
    (1024, "gate_up", (2, 8, 1280, 64, 256, (512, 1, 1))),
    (1024, "down", (2, 8, 320, 64, 256, (512, 1, 1))),
])
def test_launch_geometry_at_gemma3_shapes(B, name, want):
    dims = GEMMA3[name]
    geo = tt_contract.fused2_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("B", [4, 256, 1024])
@pytest.mark.parametrize("name", list(GEMMA3))
def test_fused2_launch_covers_gemma3_shapes(fake_launch, name, B, act_bytes,
                                            w_bytes):
    """Every activation and core dtype at gemma3's shapes: the arguments
    the launch passes are its geometry, the grid covers every row and
    output column without recomputing stage 1 across i2, the block fits
    shared memory, and an fp32 stage tile gives each thread one column."""
    n1, n2, m1, m2, r1 = dims = GEMMA3[name]
    act = torch.bfloat16 if act_bytes == 2 else torch.float32
    wd = torch.int8 if w_bytes == 1 else act
    int8 = w_bytes == 1
    x = torch.zeros(B, n1 * n2, dtype=act)
    p2 = torch.zeros(n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(n1 * r1, m1, dtype=wd)
    kernel = "tt_fused2_int8" if int8 else "tt_fused2"
    y = tt_contract._launch_fused2(kernel, x, p2, p1,
                                   torch.ones(2) if int8 else None, dims)
    assert y.shape == (B, m1 * m2) and y.dtype == act
    (fn, args), = fake_launch.calls
    geo = tt_contract.fused2_geometry(B, dims, act_bytes, w_bytes, 132,
                                      232_448)
    k = 5 if int8 else 4
    assert args[k:k + 6] == (B, n1, n2, m1, m2, r1)
    assert args[k + 6:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.g * geo.grid[1] >= m2 and geo.bb * geo.grid[0] >= B
    assert geo.nc * geo.grid[2] >= m1 and geo.nc % 16 == 0
    assert geo.smem <= 232_448
    if act_bytes == 4:
        n1p = tt_contract._stage1_width(geo.g, r1, 4)
        for width in (n1p, geo.nct):
            assert width >= 16 and width & (width - 1) == 0
        assert -(-geo.g * geo.bb // 16) * 16 * geo.nct <= 4096
    assert tt_contract.launch_counts() == {kernel: 1}


# mixtral-8x7b's projections at rank 16, length 2 (``plan_for``; granite-8b
# has the same): q and o 4096→4096, k/v 4096→1024, and the experts' gate/up
# 4096→14336 and down 14336→4096
MIXTRAL = {"q": (8, 512, 512, 8, 16), "kv": (8, 512, 128, 8, 16),
           "o": (8, 512, 512, 8, 16), "gate_up": (8, 512, 1792, 8, 16),
           "down": (8, 1792, 512, 8, 16)}


@pytest.mark.parametrize("B,name,want", [
    # decode: one row tile × 8 i2 groups, m1 cut into 8–16 slices
    (4, "q", (4, 1, 32, 176, 32, (1, 8, 16))),
    (4, "kv", (4, 1, 16, 176, 16, (1, 8, 8))),
    (4, "o", (4, 1, 32, 176, 32, (1, 8, 16))),
    (4, "gate_up", (4, 1, 112, 176, 112, (1, 8, 16))),
    (4, "down", (4, 1, 32, 208, 32, (1, 8, 16))),
    # the 4 × 512 prefill: whole-m2 blocks of 2 rows, no slices
    (2048, "q", (2, 8, 512, 64, 256, (1024, 1, 1))),
    (2048, "kv", (2, 8, 128, 64, 128, (1024, 1, 1))),
    (2048, "o", (2, 8, 512, 64, 256, (1024, 1, 1))),
    (2048, "gate_up", (2, 8, 1792, 64, 256, (1024, 1, 1))),
    (2048, "down", (2, 8, 512, 64, 256, (1024, 1, 1))),
])
def test_launch_geometry_at_mixtral_shapes(B, name, want):
    dims = MIXTRAL[name]
    geo = tt_contract.fused2_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448


@pytest.mark.parametrize("C,name,want,alone", [
    # one row: 128 blocks, m1 cut to fill the SMs
    (1, "gate_up", (1, 4, 224, 176, 32, (8, 2, 8)), (1, 8, 16)),
    (1, "down", (1, 1, 256, 464, 32, (8, 8, 2)), (1, 8, 16)),
    # decode (4 tokens, C = 8 rows an expert): 4 i2 a block and 8 m1
    # slices for gate/up (184 KB staged a block: x 64, P2 64, P1 56), 4
    # rows and 2 i2 for down (x 112 KB, P2 112, P1 64); 128 blocks
    (8, "gate_up", (8, 4, 224, 128, 32, (8, 2, 8)), (1, 8, 16)),
    (8, "down", (4, 2, 256, 256, 32, (16, 4, 2)), (1, 8, 16)),
    # a 64-token chunk (C = 20): even row tiles, 128 blocks
    (20, "gate_up", (10, 4, 448, 112, 32, (16, 2, 4)), (2, 8, 8)),
    (20, "down", (5, 2, 512, 208, 32, (32, 4, 1)), (2, 8, 8)),
    # an admission at the 256 bucket (C = 128): gate/up 128-row tiles with
    # m1 cut in 2, down 64-row tiles of 8 rows and every i2
    (128, "gate_up", (16, 8, 896, 64, 32, (64, 1, 2)), (8, 8, 2)),
    (128, "down", (8, 8, 512, 80, 32, (128, 1, 1)), (8, 8, 2)),
    # the 4 × 512 prefill (C = 640): 14 rows and every i2, one 112-row
    # tile in both stages, 368 blocks: the 3 waves 16-row tiles take
    (640, "gate_up", (14, 8, 1792, 64, 32, (368, 1, 1)), (320, 1, 1)),
    (640, "down", (14, 8, 512, 64, 32, (368, 1, 1)), (320, 1, 1)),
])
def test_expert_launch_geometry_counts_every_experts_blocks(C, name, want,
                                                            alone):
    """``fused2_expert_geometry`` in bf16 (the tall body): the experts fold
    into the first grid axis (8 × row tiles) and the m1 split counts all
    their blocks, so every capacity gives 90% of the 132 SMs a block."""
    dims = MIXTRAL[name]
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, 2, 132, 232_448, 8)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert tt_contract.fused2_geometry(C, dims, 2, 2, 132,
                                       232_448).grid == alone
    assert geo.smem == tt_contract.fused2_tall_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2) <= 232_448
    assert geo.grid[0] * geo.grid[1] * geo.grid[2] >= 118


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("B", [4, 2048])
@pytest.mark.parametrize("name", list(MIXTRAL))
def test_fused2_launch_covers_mixtral_shapes(fake_launch, name, B, act_bytes,
                                             w_bytes):
    """Every activation and core dtype at mixtral's (and granite's) shapes
    through the plain entry: the arguments are the geometry, the grid
    covers every row and column, the block fits shared memory."""
    n1, n2, m1, m2, r1 = dims = MIXTRAL[name]
    act = torch.bfloat16 if act_bytes == 2 else torch.float32
    int8 = w_bytes == 1
    wd = torch.int8 if int8 else act
    x = torch.zeros(B, n1 * n2, dtype=act)
    p2 = torch.zeros(n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(n1 * r1, m1, dtype=wd)
    kernel = "tt_fused2_int8" if int8 else "tt_fused2"
    y = tt_contract._launch_fused2(kernel, x, p2, p1,
                                   torch.ones(2) if int8 else None, dims)
    assert y.shape == (B, m1 * m2) and y.dtype == act
    (fn, args), = fake_launch.calls
    geo = tt_contract.fused2_geometry(B, dims, act_bytes, w_bytes, 132,
                                      232_448)
    k = 5 if int8 else 4
    assert args[k:k + 6] == (B, n1, n2, m1, m2, r1)
    assert args[k + 6:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.g * geo.grid[1] >= m2 and geo.bb * geo.grid[0] >= B
    assert geo.nc * geo.grid[2] >= m1 and geo.smem <= 232_448
    assert tt_contract.launch_counts() == {kernel: 1}


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("C", [1, 8, 20, 128, 640])
@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_expert_launch_passes_its_geometry(fake_launch, name, C, act_bytes,
                                           w_bytes):
    """One launch across the 8 experts: the entry ``tt_fused2_experts[_int8]
    _<act>`` gets the pointers, E = 8 before the rows per expert, the dims
    and ``fused2_expert_geometry`` (the tall body's tiles in bf16, the
    plain body's ``fused2_geometry(..., experts=8)`` in fp32); the grid
    covers every expert's rows and columns."""
    n1, n2, m1, m2, r1 = dims = MIXTRAL[name]
    E = 8
    act = torch.bfloat16 if act_bytes == 2 else torch.float32
    int8 = w_bytes == 1
    wd = torch.int8 if int8 else act
    x = torch.zeros(E, C, n1 * n2, dtype=act)
    p2 = torch.zeros(E, n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(E, n1 * r1, m1, dtype=wd)
    scales = torch.ones(E, 2) if int8 else None
    kernel = "tt_fused2_experts" + ("_int8" if int8 else "")
    y = tt_contract._launch_fused2(kernel, x, p2, p1, scales, dims)
    assert y.shape == (E, C, m1 * m2) and y.dtype == act
    (fn, args), = fake_launch.calls
    assert fn == f"{kernel}_{'bf16' if act_bytes == 2 else 'f32'}"
    ptrs = [x.data_ptr(), p2.data_ptr(), p1.data_ptr()] + (
        [scales.data_ptr()] if int8 else []) + [y.data_ptr()]
    k = len(ptrs)
    assert list(args[:k]) == ptrs
    assert args[k:k + 7] == (E, C, n1, n2, m1, m2, r1)
    geo = tt_contract.fused2_expert_geometry(C, dims, act_bytes, w_bytes,
                                             132, 232_448, E)
    if act_bytes == 4:
        assert geo == tt_contract.fused2_geometry(C, dims, 4, w_bytes, 132,
                                                  232_448, E)
    assert args[k + 7:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.grid[0] % E == 0 and geo.bb * geo.grid[0] // E >= C
    assert geo.g * geo.grid[1] >= m2 and geo.nc * geo.grid[2] >= m1
    assert geo.smem <= 232_448
    assert tt_contract.launch_counts() == {kernel: 1}


# ---------------------------------------------------------------------------
# the tall body of the expert-batched launch (bf16 activations)
# ---------------------------------------------------------------------------

# the plain entry's tiles (bb, g, nc, kc, nct, grid) at one row count of
# each family's shapes in bf16: the tall body must leave them as they are
PLAIN_TILES = [
    (4, GATE_UP, (4, 1, 96, 176, 96, (1, 8, 15))),
    (256, DOWN, (2, 8, 512, 64, 256, (128, 1, 1))),
    (4, GEMMA3["down"], (4, 1, 32, 208, 32, (1, 8, 10))),
    (1024, GEMMA3["gate_up"], (2, 8, 1280, 64, 256, (512, 1, 1))),
    (4, MIXTRAL["kv"], (4, 1, 16, 176, 16, (1, 8, 8))),
    (2048, MIXTRAL["gate_up"], (2, 8, 1792, 64, 256, (1024, 1, 1))),
]
RAGGED_EXPERT = (2, 86, 43, 2, 3)


def _tall_mirror(x, p2, p1, scales, dims, geo):
    """The tall body's blocks on the CPU, in the kernel's order: per (expert,
    row tile, i2 group, m1 slice) stage 1 in fp32 times s2, A with rows (i2,
    b) as a bf16 high and a low part, stage 2 of both parts per column
    chunk times s1, rounded to bf16 and written to the block's outputs.
    Returns y and how many blocks wrote each output."""
    n1, n2, m1, m2, r1 = dims
    E, C, _ = x.shape
    y = torch.zeros(E, C, m1 * m2, dtype=x.dtype)
    writes = torch.zeros(E, C, m1 * m2, dtype=torch.int32)
    f32 = torch.float32
    tiles = geo.grid[0] // E
    assert tiles == -(-C // geo.bb)
    for e in range(E):
        s2, s1 = (1.0, 1.0) if scales is None else scales[e].tolist()
        for tile in range(tiles):
            row0 = tile * geo.bb
            rows = min(geo.bb, C - row0)
            xt = x[e, row0:row0 + rows].reshape(rows * n1, n2).to(f32)
            for grp in range(geo.grid[1]):
                i20 = grp * geo.g
                gn = min(geo.g, m2 - i20)
                S = xt @ p2[e, :, i20 * r1:(i20 + gn) * r1].to(f32) * s2
                A = S.reshape(rows, n1, gn, r1).permute(2, 0, 1, 3).reshape(
                    gn * rows, n1 * r1)
                hi = A.to(torch.bfloat16).to(f32)
                lo = (A - hi).to(torch.bfloat16).to(f32)
                for sl in range(geo.grid[2]):
                    cbeg = sl * geo.nc
                    ncols = min(m1, cbeg + geo.nc) - cbeg
                    for c0 in range(0, ncols, geo.nct):
                        cn = min(geo.nct, ncols - c0)
                        P = p1[e, :, cbeg + c0:cbeg + c0 + cn].to(f32)
                        O = ((hi @ P + lo @ P) * s1).to(x.dtype)
                        O = O.reshape(gn, rows, cn).permute(1, 2, 0)
                        cols = ((cbeg + c0 + torch.arange(cn))[:, None] * m2
                                + i20 + torch.arange(gn)).reshape(-1)
                        y[e, row0:row0 + rows, cols] = O.reshape(rows, -1)
                        writes[e, row0:row0 + rows, cols] += 1
    return y, writes


def _expert_inputs(E, C, dims, int8, seed=0):
    n1, n2, m1, m2, r1 = dims
    rng = np.random.default_rng(seed)
    G1 = rng.standard_normal((E, 1, n1, m1, r1)).astype(np.float32) * 0.3
    G2 = rng.standard_normal((E, r1, n2, m2, 1)).astype(np.float32) * 0.3
    x = torch.from_numpy(rng.standard_normal((E, C, n1 * n2)).astype(
        np.float32)).to(torch.bfloat16)
    if int8:
        q = [[pack_core_int8(jnp.asarray(G[e])) for e in range(E)]
             for G in (G2, G1)]
        p2, p1 = (torch.from_numpy(np.stack([np.array(c) for c, _ in qs]))
                  for qs in q)
        scales = torch.tensor([[float(q[0][e][1]), float(q[1][e][1])]
                               for e in range(E)], dtype=torch.float32)
        return x, p2, p1, scales, G1, G2
    p2 = pack_core(torch.from_numpy(G2).to(torch.bfloat16))
    p1 = pack_core(torch.from_numpy(G1).to(torch.bfloat16))
    return x, p2, p1, None, G1, G2


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("E,C,dims", [
    (3, 5, (2, 8, 4, 2, 3)), (2, 13, RAGGED_EXPERT), (2, 37, RAGGED_EXPERT),
    (3, 20, (4, 16, 32, 4, 4)), (2, 1, (2, 86, 43, 2, 4))])
def test_tall_blocks_match_pallas(E, C, dims, int8):
    """The tall blocks of ``fused2_expert_geometry`` on the CPU cover every
    output of every expert once and agree with the reference's Pallas
    kernel (interpret mode) run on each expert: bf16 in and out, 1e-2 of
    the largest |y| (the output rounds to bf16)."""
    x, p2, p1, scales, G1, G2 = _expert_inputs(E, C, dims, int8)
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, 1 if int8 else 2,
                                             132, 232_448, E)
    got, writes = _tall_mirror(x, p2, p1, scales, dims, geo)
    assert bool((writes == 1).all())
    xf = np.asarray(x.float().numpy())
    bf = jnp.bfloat16
    for e in range(E):
        if int8:
            want = tt_fused2_int8_pallas(
                jnp.asarray(xf[e]).astype(bf), jnp.asarray(p2[e].numpy()),
                jnp.asarray(p1[e].numpy()), [scales[e, 0], scales[e, 1]],
                dims, interpret=True)
        else:
            want = tt_fused2_pallas(
                jnp.asarray(xf[e]).astype(bf),
                jpack(jnp.asarray(G2[e]).astype(bf)),
                jpack(jnp.asarray(G1[e]).astype(bf)), dims, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got[e].float().numpy(), want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("C", [1, 8, 20])
@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_tall_blocks_cover_mixtral_experts(name, C):
    """At mixtral's expert shapes and the small capacities (one row,
    decode, a 64-token chunk) the tall blocks write every output of the 8
    experts once and agree with the plain version."""
    from repro_torch.kernels.ref import tt_fused2_experts_ref
    dims = MIXTRAL[name]
    x, p2, p1, _, _, _ = _expert_inputs(8, C, dims, False, seed=3)
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, 2, 132, 232_448, 8)
    got, writes = _tall_mirror(x, p2, p1, None, dims, geo)
    assert bool((writes == 1).all())
    want = tt_fused2_experts_ref(x, p2, p1, dims).float()
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("w_bytes", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("C", [1, 8, 20, 128, 640])
@pytest.mark.parametrize("name", ["gate_up", "down", "ragged"])
def test_expert_tall_geometry_covers_and_fits(name, C, w_bytes):
    """``fused2_expert_geometry`` in bf16 at every capacity the paths run:
    the grid covers every expert's rows, i2 values and m1 columns; the
    block's shared memory (``fused2_tall_smem_bytes``) fits 232,448 bytes;
    each stage's tile is at most ``FUSED2_TALL_ROWS`` rows (one 32×32 tile
    per warp); at least 90% of the SMs get a block where the rows allow;
    and the plain entry's tiles are unchanged."""
    n1, n2, m1, m2, r1 = dims = (RAGGED_EXPERT if name == "ragged"
                                 else MIXTRAL[name])
    E = 8
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, w_bytes, 132,
                                             232_448, E)
    tiles = geo.grid[0] // E
    assert geo.grid[0] == E * tiles and geo.bb * tiles >= C > \
        geo.bb * (tiles - 1)
    assert geo.g * geo.grid[1] >= m2 and m2 % geo.g == 0
    assert geo.nc * geo.grid[2] >= m1 > geo.nc * (geo.grid[2] - 1)
    assert geo.nc % 16 == 0 and geo.nct % 16 == 0 and geo.kc % 16 == 0
    # stage 2's chunks: at most 32 columns, one for each group where the
    # slice has 64 columns
    assert geo.nct <= min(geo.nc, 32)
    assert -(-geo.nc // geo.nct) >= min(4, geo.nc // 16)
    assert geo.smem == tt_contract.fused2_tall_smem_bytes(
        n1, r1, geo.bb, geo.g, geo.kc, geo.nct, w_bytes) <= 232_448
    most = tt_contract.FUSED2_TALL_ROWS
    assert -(-geo.bb * n1 // 16) * 16 <= most        # stage 1 rows
    assert -(-geo.g * r1 // 16) * 16 <= most         # stage 1 columns
    assert -(-geo.g * geo.bb // 16) * 16 <= most     # stage 2 rows
    blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
    assert blocks >= 118 or blocks == E * C * m2 * -(-m1 // 16)
    for B, plain_dims, want in PLAIN_TILES:
        plain = tt_contract.fused2_geometry(B, plain_dims, 2, 2, 132,
                                            232_448, 1)
        assert (plain.bb, plain.g, plain.nc, plain.kc, plain.nct,
                plain.grid) == want


@pytest.mark.parametrize("w_bytes,nct,want", [
    # bf16 cores: four groups' rings of two P1 chunks [128, 40] bf16
    # 81,920; then the larger of A hi + lo [128, 136] bf16 69,632 with the
    # fp32 partial sums [128, 132] 67,584 (the groups' staging 4 × [128,
    # 40] bf16, 40,960, fits in them), and four (x [128, 72], P2 [64, 136])
    # bf16 chunks 143,360
    (2, 32, 81_920 + 143_360),
    # int8 cores, stage 2 on mma.sync: four groups' rings of two P1 chunks
    # [128, 48] int8 49,152 and their widening [128, 40] bf16 40,960; A and
    # the partial sums 137,216 (more than the four (x, P2 [64, 144] int8)
    # chunks 110,592 and the P2 widening [64, 136] bf16 17,408)
    (1, 32, 49_152 + 40_960 + 69_632 + 67_584),
])
def test_fused2_tall_smem_bytes_at_prefill(w_bytes, nct, want):
    """The tall block of 16 rows, all 8 i2 (128-row tiles in both stages)
    and 64-value chunks of n2."""
    assert tt_contract.fused2_tall_smem_bytes(8, 16, 16, 8, 64, nct,
                                              w_bytes) == want


def test_expert_geometry_keeps_the_plain_body_for_fp32():
    """fp32 activations take the plain entry's body and its tiles."""
    for C in (8, 640):
        for w in (4, 1):
            assert tt_contract.fused2_expert_geometry(
                C, MIXTRAL["gate_up"], 4, w, 132, 232_448, 8) == \
                tt_contract.fused2_geometry(C, MIXTRAL["gate_up"], 4, w, 132,
                                            232_448, 8)


@pytest.mark.parametrize("w_bytes", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("C", [333, 640, 2048])
@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_expert_geometry_fills_the_last_wave_with_rows(name, C, w_bytes):
    """From prefill sizes on, every i2 in one block and no m1 split: the
    row tiles are the shortest that keep the waves of 16-row tiles, so the
    last wave is filled by rows and x is staged once."""
    dims = MIXTRAL[name]
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, w_bytes, 132,
                                             232_448, 8)
    assert (geo.g, geo.grid[1], geo.grid[2]) == (8, 1, 1)
    waves = -(-8 * -(-C // 16) // 132)
    assert -(-geo.grid[0] // 132) == waves
    assert 8 * -(-C // (geo.bb - 1)) > waves * 132


# deepseek-v2-lite-16b's projections at rank 16, length 2 (``plan_for``):
# q 2048→3072, o 2048→2048, the shared experts' gate/up 2048→2816 and down
# 2816→2048, the dense first layer's gate/up 2048→10944 and down
# 10944→2048 (m1 and n2 of 1,368: no multiple of 16), and the 64 experts'
# gate/up 2048→1408 and down 1408→2048
DSV2 = {"q": (8, 256, 384, 8, 16), "o": (8, 256, 256, 8, 16),
        "shared_gate_up": (8, 256, 352, 8, 16),
        "shared_down": (8, 352, 256, 8, 16),
        "dense0_gate_up": (8, 256, 1368, 8, 16),
        "dense0_down": (8, 1368, 256, 8, 16),
        "experts_gate_up": (8, 256, 176, 8, 16),
        "experts_down": (8, 176, 256, 8, 16)}
# qwen3-32b's: q 5120→8192, k/v 5120→1024, o 8192→5120, gate/up
# 5120→25600, down 25600→5120
QWEN3 = {"q": (8, 640, 1024, 8, 16), "kv": (8, 640, 128, 8, 16),
         "o": (8, 1024, 640, 8, 16), "gate_up": (8, 640, 3200, 8, 16),
         "down": (8, 3200, 640, 8, 16)}
PLAIN_DSV2 = [k for k in DSV2 if not k.startswith("experts")]


@pytest.mark.parametrize("B,shapes,name,want", [
    # decode: one row tile × 8 i2 groups, m1 cut into 11–16 slices; the
    # dense0 gate/up's 1,368 columns in 15 slices of 96 (the last 24 wide)
    (4, DSV2, "q", (4, 1, 32, 96, 32, (1, 8, 12))),
    (4, DSV2, "o", (4, 1, 16, 96, 16, (1, 8, 16))),
    (4, DSV2, "shared_gate_up", (4, 1, 32, 96, 32, (1, 8, 11))),
    (4, DSV2, "shared_down", (4, 1, 16, 128, 16, (1, 8, 16))),
    (4, DSV2, "dense0_gate_up", (4, 1, 96, 96, 96, (1, 8, 15))),
    (4, DSV2, "dense0_down", (4, 1, 16, 208, 16, (1, 8, 16))),
    # prefill (4 × 64) and the 4 × 512 fixed batch: whole-m2 blocks of 2
    # rows, no slices; dense0's 1,368 columns in one slice of 1,376
    (256, DSV2, "q", (2, 8, 384, 64, 256, (128, 1, 1))),
    (256, DSV2, "dense0_gate_up", (2, 8, 1376, 64, 256, (128, 1, 1))),
    (2048, DSV2, "dense0_gate_up", (2, 8, 1376, 64, 256, (1024, 1, 1))),
    (2048, DSV2, "dense0_down", (2, 8, 256, 64, 256, (1024, 1, 1))),
    (2048, DSV2, "shared_down", (2, 8, 256, 64, 256, (1024, 1, 1))),
    (4, QWEN3, "q", (4, 1, 64, 208, 64, (1, 8, 16))),
    (4, QWEN3, "kv", (4, 1, 16, 208, 16, (1, 8, 8))),
    (4, QWEN3, "o", (4, 1, 48, 208, 48, (1, 8, 14))),
    (4, QWEN3, "gate_up", (4, 1, 208, 208, 208, (1, 8, 16))),
    (4, QWEN3, "down", (4, 1, 48, 208, 48, (1, 8, 14))),
    (256, QWEN3, "q", (2, 8, 1024, 64, 256, (128, 1, 1))),
    (256, QWEN3, "kv", (2, 8, 128, 64, 128, (128, 1, 1))),
    (256, QWEN3, "o", (2, 8, 640, 64, 256, (128, 1, 1))),
    (256, QWEN3, "gate_up", (2, 8, 3200, 64, 256, (128, 1, 1))),
    (1024, QWEN3, "down", (2, 8, 640, 64, 256, (512, 1, 1))),
], ids=lambda v: v if isinstance(v, (str, int)) else None)
def test_launch_geometry_at_deepseek_v2_and_qwen3_shapes(B, shapes, name,
                                                         want):
    """The plain entry's tiles at the new shapes, unchanged rules: decode
    fills 96–128 SMs, prefill takes whole-m2 blocks of 2 rows."""
    dims = shapes[name]
    geo = tt_contract.fused2_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("B", [4, 256])
@pytest.mark.parametrize("name", [f"dsv2-{k}" for k in PLAIN_DSV2] +
                         [f"qwen3-{k}" for k in QWEN3])
def test_fused2_launch_covers_deepseek_v2_and_qwen3_shapes(
        fake_launch, name, B, act_bytes, w_bytes):
    """Every activation and core dtype through the plain entry: the
    arguments are the geometry, the grid covers every row and column (the
    ragged 1,368 included) without recomputing stage 1 across i2, the
    block fits shared memory."""
    model, key = name.split("-", 1)
    n1, n2, m1, m2, r1 = dims = (DSV2 if model == "dsv2" else QWEN3)[key]
    act = torch.bfloat16 if act_bytes == 2 else torch.float32
    int8 = w_bytes == 1
    wd = torch.int8 if int8 else act
    x = torch.zeros(B, n1 * n2, dtype=act)
    p2 = torch.zeros(n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(n1 * r1, m1, dtype=wd)
    kernel = "tt_fused2_int8" if int8 else "tt_fused2"
    y = tt_contract._launch_fused2(kernel, x, p2, p1,
                                   torch.ones(2) if int8 else None, dims)
    assert y.shape == (B, m1 * m2) and y.dtype == act
    (fn, args), = fake_launch.calls
    geo = tt_contract.fused2_geometry(B, dims, act_bytes, w_bytes, 132,
                                      232_448)
    k = 5 if int8 else 4
    assert args[k:k + 6] == (B, n1, n2, m1, m2, r1)
    assert args[k + 6:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.g * geo.grid[1] >= m2 and geo.bb * geo.grid[0] >= B
    assert geo.nc * geo.grid[2] >= m1 > geo.nc * (geo.grid[2] - 1)
    assert geo.smem <= 232_448
    assert tt_contract.launch_counts() == {kernel: 1}


@pytest.mark.parametrize("C,name,want", [
    # one row and decode (4 tokens × 6 of 64 experts: C = 8): 128 blocks,
    # gate/up 4 i2 a block and its 176 columns whole, down every i2 and
    # m1 in 2 slices
    (1, "experts_gate_up", (1, 4, 176, 96, 32, (64, 2, 1))),
    (1, "experts_down", (1, 8, 128, 64, 32, (64, 1, 2))),
    (8, "experts_gate_up", (8, 4, 176, 96, 32, (64, 2, 1))),
    (8, "experts_down", (8, 8, 128, 64, 32, (64, 1, 2))),
    # a 64-token chunk (C = 8 too) and 20 rows: 2 tiles of 10 rows
    (20, "experts_gate_up", (10, 8, 176, 80, 32, (128, 1, 1))),
    (20, "experts_down", (10, 8, 256, 64, 32, (128, 1, 1))),
    # an admission at the 256 bucket (C = 128) and the 4 × 512 prefill
    # (C = 256): 16-row tiles, every i2, 4 and 8 waves of 128 blocks
    (128, "experts_gate_up", (16, 8, 176, 64, 32, (512, 1, 1))),
    (128, "experts_down", (16, 8, 256, 64, 32, (512, 1, 1))),
    (256, "experts_gate_up", (16, 8, 176, 64, 32, (1024, 1, 1))),
    (256, "experts_down", (16, 8, 256, 64, 32, (1024, 1, 1))),
])
def test_expert_geometry_at_64_experts(C, name, want):
    """``fused2_expert_geometry`` in bf16 (the tall body) across 64
    experts: the experts fold into the first grid axis and every capacity
    gives 90% of the 132 SMs a block."""
    dims = DSV2[name]
    for w_bytes in (2, 1):
        geo = tt_contract.fused2_expert_geometry(C, dims, 2, w_bytes, 132,
                                                 232_448, 64)
        assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
        assert geo.smem == tt_contract.fused2_tall_smem_bytes(
            dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct,
            w_bytes) <= 232_448
        assert geo.grid[0] * geo.grid[1] * geo.grid[2] >= 118
        tiles = geo.grid[0] // 64
        assert geo.grid[0] == 64 * tiles and geo.bb * tiles >= C


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("name", ["experts_gate_up", "experts_down"])
def test_tall_blocks_cover_64_experts(name, C):
    """At deepseek-v2's expert shapes and the decode capacities the tall
    blocks write every output of the 64 experts once and agree with the
    plain version."""
    from repro_torch.kernels.ref import tt_fused2_experts_ref
    dims = DSV2[name]
    x, p2, p1, _, _, _ = _expert_inputs(64, C, dims, False, seed=5)
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, 2, 132, 232_448,
                                             64)
    got, writes = _tall_mirror(x, p2, p1, None, dims, geo)
    assert bool((writes == 1).all())
    want = tt_fused2_experts_ref(x, p2, p1, dims).float()
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max())


# mamba2-2.7b's SSD projections at rank 16, length 2 (``plan_for``): in_proj
# 2560→10576 and out_proj 5120→2560.  in_proj's m1 of 1,322 = 2·661 is no
# multiple of 8: its P1 rows (2,644 bytes in bf16, 5,288 in fp32, 1,322 in
# int8) are 16-byte aligned in no dtype, so every block stages P1 through
# the scalar loop, and every slice width leaves a ragged last slice
MAMBA2 = {"in_proj": (8, 320, 1322, 8, 16), "out_proj": (8, 640, 320, 8, 16)}


@pytest.mark.parametrize("B,name,want", [
    # decode: one row tile × 8 i2 groups; in_proj's 1,322 columns in 14
    # slices of 96 (the last 74 wide), out_proj's 320 in 10 of 32
    (4, "in_proj", (4, 1, 96, 112, 96, (1, 8, 14))),
    (4, "out_proj", (4, 1, 32, 208, 32, (1, 8, 10))),
    # an admission at the 256 bucket and the 4 × 1,024 prefill: whole-m2
    # blocks of 2 rows, m1 in one slice (1,328 for 1,322)
    (256, "in_proj", (2, 8, 1328, 64, 256, (128, 1, 1))),
    (256, "out_proj", (2, 8, 320, 64, 256, (128, 1, 1))),
    (4096, "in_proj", (2, 8, 1328, 64, 256, (2048, 1, 1))),
    (4096, "out_proj", (2, 8, 320, 64, 256, (2048, 1, 1))),
])
def test_launch_geometry_at_mamba2_shapes(B, name, want):
    """The plain entry's tiles at mamba2's shapes in bf16, unchanged
    rules; the block fits shared memory."""
    dims = MAMBA2[name]
    geo = tt_contract.fused2_geometry(B, dims, 2, 2, 132, 232_448)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448


def test_mamba2_in_proj_p1_rows_are_unaligned_in_every_dtype():
    """The kernel stages P1 with 16-byte copies only when a row of m1
    elements is a whole number of 16-byte words (``vec_p1`` in
    ``csrc/tt_fused2.cu``): never at in_proj's m1, always at out_proj's;
    and 1,322 leaves a ragged last m1 slice at every row count."""
    m1_in, m1_out = MAMBA2["in_proj"][2], MAMBA2["out_proj"][2]
    for w_bytes in (4, 2, 1):
        assert (m1_in * w_bytes) % 16 != 0
        assert (m1_out * w_bytes) % 16 == 0
    for B in (4, 256, 4096):
        for act_bytes, w_bytes in ((2, 2), (2, 1), (4, 4), (4, 1)):
            geo = tt_contract.fused2_geometry(B, MAMBA2["in_proj"],
                                              act_bytes, w_bytes, 132,
                                              232_448)
            assert m1_in % geo.nc != 0


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("B", [4, 256, 4096])
@pytest.mark.parametrize("name", list(MAMBA2))
def test_fused2_launch_covers_mamba2_shapes(fake_launch, name, B, act_bytes,
                                            w_bytes):
    """Every activation and core dtype through the plain entry at mamba2's
    shapes: the arguments are the geometry, the grid covers every row and
    column (in_proj's ragged 1,322 included), the block fits shared
    memory."""
    _plain_entry_covers(fake_launch, MAMBA2[name], B, act_bytes, w_bytes)


def _plain_entry_covers(fake_launch, dims, B, act_bytes, w_bytes):
    """One call of the plain entry at ``dims`` through the stand-in
    library: its arguments are ``fused2_geometry``'s, its grid covers
    every row and column, its block fits shared memory."""
    n1, n2, m1, m2, r1 = dims
    act = torch.bfloat16 if act_bytes == 2 else torch.float32
    int8 = w_bytes == 1
    wd = torch.int8 if int8 else act
    x = torch.zeros(B, n1 * n2, dtype=act)
    p2 = torch.zeros(n2, m2 * r1, dtype=wd)
    p1 = torch.zeros(n1 * r1, m1, dtype=wd)
    kernel = "tt_fused2_int8" if int8 else "tt_fused2"
    y = tt_contract._launch_fused2(kernel, x, p2, p1,
                                   torch.ones(2) if int8 else None, dims)
    assert y.shape == (B, m1 * m2) and y.dtype == act
    (fn, args), = fake_launch.calls
    geo = tt_contract.fused2_geometry(B, dims, act_bytes, w_bytes, 132,
                                      232_448)
    k = 5 if int8 else 4
    assert args[k:k + 6] == (B, n1, n2, m1, m2, r1)
    assert args[k + 6:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.g * geo.grid[1] >= m2 and geo.bb * geo.grid[0] >= B
    assert geo.nc * geo.grid[2] >= m1 > geo.nc * (geo.grid[2] - 1)
    assert geo.smem <= 232_448
    assert tt_contract.launch_counts() == {kernel: 1}


# jamba-v0.1-52b's SSD projections at rank 16, length 2 (``plan_for``):
# in_proj 4096→16544 (m1 = 2,068 = 4·11·47: P1 rows of 4,136 bytes in
# bf16 and 2,068 in int8 take the scalar staging loop, 8,272 in fp32 are
# aligned) and out_proj 8192→4096 (n2 = 1,024); its 16 experts at
# mixtral's expert shapes
JAMBA = {"in_proj": (8, 512, 2068, 8, 16), "out_proj": (8, 1024, 512, 8, 16)}


def test_jamba_in_proj_p1_rows_are_aligned_in_fp32_only():
    """``vec_p1`` holds for in_proj's m1 in fp32 cores only, and for
    out_proj's in every dtype."""
    m1_in, m1_out = JAMBA["in_proj"][2], JAMBA["out_proj"][2]
    assert [(m1_in * w) % 16 == 0 for w in (4, 2, 1)] == [True, False, False]
    assert all((m1_out * w) % 16 == 0 for w in (4, 2, 1))


@pytest.mark.parametrize("act_bytes,w_bytes", [(2, 2), (2, 1), (4, 4),
                                               (4, 1)],
                         ids=["bf16", "bf16-int8", "fp32", "fp32-int8"])
@pytest.mark.parametrize("B", [4, 256, 4096])
@pytest.mark.parametrize("name", list(JAMBA))
def test_fused2_launch_covers_jamba_shapes(fake_launch, name, B, act_bytes,
                                           w_bytes):
    """Every activation and core dtype through the plain entry at jamba's
    SSD shapes, at decode, an admission and the 4 × 1,024 prefill."""
    _plain_entry_covers(fake_launch, JAMBA[name], B, act_bytes, w_bytes)


@pytest.mark.parametrize("w_bytes", [2, 1], ids=["bf16", "int8"])
@pytest.mark.parametrize("C", [1, 8, 128, 640])
@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_expert_geometry_at_16_experts(name, C, w_bytes):
    """``fused2_expert_geometry`` in bf16 (the tall body) across jamba's 16
    experts at every capacity its paths run (one row, decode, an admission
    at the 256 bucket, the 4 × 1,024 prefill): the grid covers every
    expert's rows, i2 values and m1 columns, the block fits shared memory,
    each stage's tile is at most ``FUSED2_TALL_ROWS`` rows, and at least
    90% of the SMs get a block where the rows allow."""
    n1, n2, m1, m2, r1 = dims = MIXTRAL[name]
    E = 16
    geo = tt_contract.fused2_expert_geometry(C, dims, 2, w_bytes, 132,
                                             232_448, E)
    tiles = geo.grid[0] // E
    assert geo.grid[0] == E * tiles and geo.bb * tiles >= C > \
        geo.bb * (tiles - 1)
    assert geo.g * geo.grid[1] >= m2 and m2 % geo.g == 0
    assert geo.nc * geo.grid[2] >= m1 > geo.nc * (geo.grid[2] - 1)
    assert geo.smem == tt_contract.fused2_tall_smem_bytes(
        n1, r1, geo.bb, geo.g, geo.kc, geo.nct, w_bytes) <= 232_448
    most = tt_contract.FUSED2_TALL_ROWS
    assert -(-geo.bb * n1 // 16) * 16 <= most
    assert -(-geo.g * geo.bb // 16) * 16 <= most
    blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
    assert blocks >= 118 or blocks == E * C * m2 * -(-m1 // 16)


@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_tall_blocks_cover_16_experts(name):
    """At jamba's decode capacity (C = 8) the tall blocks write every
    output of the 16 experts once and agree with the plain version."""
    from repro_torch.kernels.ref import tt_fused2_experts_ref
    dims = MIXTRAL[name]
    x, p2, p1, _, _, _ = _expert_inputs(16, 8, dims, False, seed=7)
    geo = tt_contract.fused2_expert_geometry(8, dims, 2, 2, 132, 232_448, 16)
    got, writes = _tall_mirror(x, p2, p1, None, dims, geo)
    assert bool((writes == 1).all())
    want = tt_fused2_experts_ref(x, p2, p1, dims).float()
    err = float((got.float() - want).abs().max())
    assert err <= 1e-2 * float(want.abs().max())
