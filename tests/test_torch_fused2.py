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
    # decode (4 tokens, C = 8 rows an expert): 8 experts × 8 i2 groups
    # already give 64 blocks, so m1 is cut in 2, not in the 16 slices one
    # problem of 8 rows would take
    (8, "gate_up", (8, 1, 896, 112, 256, (8, 8, 2)), (1, 8, 16)),
    (8, "down", (8, 1, 256, 112, 256, (8, 8, 2)), (1, 8, 16)),
    # a 64-token chunk (C = 20): two 16-row tiles an expert, no slices
    (20, "gate_up", (16, 1, 1792, 64, 256, (16, 8, 1)), (2, 8, 8)),
    (20, "down", (16, 1, 512, 64, 256, (16, 8, 1)), (2, 8, 8)),
    # the 4 × 512 prefill (C = 640): whole-m2 blocks of 2 rows
    (640, "gate_up", (2, 8, 1792, 64, 256, (2560, 1, 1)), (320, 1, 1)),
    (640, "down", (2, 8, 512, 64, 256, (2560, 1, 1)), (320, 1, 1)),
])
def test_expert_launch_geometry_counts_every_experts_blocks(C, name, want,
                                                            alone):
    """``fused2_geometry(..., experts=8)``: the experts fold into the first
    grid axis (8 × row tiles) and the m1 split counts all their blocks."""
    dims = MIXTRAL[name]
    geo = tt_contract.fused2_geometry(C, dims, 2, 2, 132, 232_448, 8)
    assert (geo.bb, geo.g, geo.nc, geo.kc, geo.nct, geo.grid) == want
    assert tt_contract.fused2_geometry(C, dims, 2, 2, 132,
                                       232_448).grid == alone
    assert geo.smem == tt_contract.fused2_smem_bytes(
        dims[0], dims[4], geo.bb, geo.g, geo.kc, geo.nct, 2, 2) <= 232_448
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
@pytest.mark.parametrize("C", [8, 20, 128, 640])
@pytest.mark.parametrize("name", ["gate_up", "down"])
def test_expert_launch_passes_its_geometry(fake_launch, name, C, act_bytes,
                                           w_bytes):
    """One launch across the 8 experts: the entry ``tt_fused2_experts[_int8]
    _<act>`` gets the pointers, E = 8 before the rows per expert, the dims
    and ``fused2_geometry(..., experts=8)``; the grid covers every expert's
    rows and columns."""
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
    geo = tt_contract.fused2_geometry(C, dims, act_bytes, w_bytes, 132,
                                      232_448, E)
    assert args[k + 7:] == (geo.bb, geo.g, geo.nc, geo.kc, geo.nct,
                            geo.smem, 7)
    assert geo.grid[0] % E == 0 and geo.bb * geo.grid[0] // E >= C
    assert geo.g * geo.grid[1] >= m2 and geo.nc * geo.grid[2] >= m1
    assert geo.smem <= 232_448
    assert tt_contract.launch_counts() == {kernel: 1}
