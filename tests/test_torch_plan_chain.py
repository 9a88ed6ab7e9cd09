"""The port's planner at TT length 3: the DSE picks the reference's shapes,
``auto`` routes d≥3 chains to the fused chain or, when one row of its state
does not fit a block's shared memory, to the step kernel; and the fused
chain's launch takes its tiles from ``chain_geometry``."""
import contextlib
import ctypes
import dataclasses

import pytest
import torch

from repro.models.layers import plan_for as jplan_for
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.core.packing import chain_state_sizes, chain_weight_elems
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import tt_contract
from repro_torch.models.layers import plan_for as tplan_for

SMOKE = get_config("deepseek-7b", "smoke")
# [N → M] of every projection of deepseek-7b SMOKE, and of the full width
SMOKE_SHAPES = sorted({(SMOKE.d_model, SMOKE.q_dim), (SMOKE.d_model,
                       SMOKE.kv_dim), (SMOKE.q_dim, SMOKE.d_model),
                       (SMOKE.d_model, SMOKE.d_ff), (SMOKE.d_ff,
                                                     SMOKE.d_model)})
FULL = {  # [N → M]: (ns, ms, ranks) at rank 16, length 3
    (4096, 11008): ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)),
    (11008, 4096): ((8, 8, 172), (64, 8, 8), (1, 16, 16, 1)),
    (4096, 4096): ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1)),
}
GATE_UP = FULL[(4096, 11008)]
ROW = 2 * 8192 * 4                 # s1 + s2 of one full-width row, fp32


@pytest.mark.parametrize("N,M", SMOKE_SHAPES)
def test_plan_for_length3_matches_reference_at_smoke(N, M):
    mine = tplan_for(M, N, 4, 3, 2)
    theirs = jplan_for(M, N, 4, 3, 2)
    assert mine.d == 3
    assert (mine.ns, mine.ms, mine.ranks) == (theirs.ns, theirs.ms,
                                              theirs.ranks)


@pytest.mark.parametrize("NM", sorted(FULL))
def test_plan_for_length3_full_width_shapes(NM):
    N, M = NM
    mine = tplan_for(M, N, 16, 3, 8)
    theirs = jplan_for(M, N, 16, 3, 8)
    assert (mine.ns, mine.ms, mine.ranks) == FULL[NM] == (
        theirs.ns, theirs.ms, theirs.ranks)


def test_chain_state_sizes_at_full_width():
    assert chain_state_sizes(*GATE_UP) == [4096, 8192, 8192, 11008]
    assert chain_weight_elems(*GATE_UP) == 46_592
    assert tt_contract.chain_row_bytes(*GATE_UP) == ROW


@pytest.mark.parametrize("dims", sorted(FULL.values()))
def test_auto_routes_d3_to_the_fused_chain_on_the_h100(dims):
    assert hw.device_spec("cpu") is hw.H100_SXM
    p = tplan.plan_tt_forward(*dims)
    assert p.backend == "cuda_fused" and p.weights == "fp"
    assert tplan.plan_tt_forward(*dims, weights="int8").backend == \
        "cuda_fused"


def test_auto_routes_to_the_step_kernel_when_a_row_does_not_fit():
    assert tplan.plan_tt_forward(*GATE_UP, smem_bytes=ROW).backend == \
        "cuda_fused"
    assert tplan.plan_tt_forward(*GATE_UP, smem_bytes=ROW - 1).backend == \
        "cuda_step"
    # d=2 keeps fused2 and d=1 the einsum chain
    assert tplan.plan_tt_forward((8, 512), (1376, 8),
                                 (1, 16, 1)).backend == "cuda_fused2"
    assert tplan.plan_tt_forward((6,), (4,), (1, 1)).backend == "einsum"


def test_explicit_backends_that_cannot_run_raise():
    with pytest.raises(ValueError, match="shared memory"):
        tplan.plan_tt_forward(*GATE_UP, backend="cuda_fused",
                              smem_bytes=ROW - 1)
    with pytest.raises(ValueError, match="d >= 2"):
        tplan.plan_tt_forward((6,), (4,), (1, 1), backend="cuda_fused")
    with pytest.raises(ValueError, match="length-2"):
        tplan.plan_tt_forward(*GATE_UP, backend="cuda_fused2")
    # the step kernel takes any chain; the fused chain d = 2 as well
    assert tplan.plan_tt_forward(*GATE_UP, backend="cuda_step",
                                 smem_bytes=1).backend == "cuda_step"
    assert tplan.plan_tt_forward((8, 512), (1376, 8), (1, 16, 1),
                                 backend="cuda_fused").backend == "cuda_fused"


@pytest.mark.parametrize("smem,want", [
    (232_448, (3, 8, 8)),      # H100: whole modes, 3 rows a block
    (ROW, (1, 4, 8)),          # one row's states: half of m_3 a block
    (10 * ROW, (9, 8, 8)),
    (100 * ROW, (32, 8, 8)),   # the cap
])
def test_chain_geometry_fits_what_shared_memory_holds(smem, want):
    """With many rows in fp32 the chain's block takes as many rows, then
    as much of m_3, as fit ``smem`` bytes."""
    geo = tt_contract.chain_geometry(10_000, GATE_UP, 4, 4, 132, smem)
    assert (geo.bb, geo.g, geo.g2) == want
    assert geo.smem <= smem


def test_chain_row_bytes_prices_one_buffer_at_d2():
    # d=2 keeps only s1 = n1·m2·r1 = 8·8·16 floats
    assert tt_contract.chain_row_bytes((8, 512), (1376, 8), (1, 16, 1)) == \
        8 * 8 * 16 * 4
    with pytest.raises(ValueError, match="d >= 2"):
        tt_contract.chain_row_bytes((6,), (4,), (1, 1))
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.check_chain_fits(*GATE_UP, ROW - 1)
    tt_contract.check_chain_fits(*GATE_UP, ROW)


def test_the_plan_carries_no_tile():
    fields = {f.name for f in dataclasses.fields(tplan.TTExecutionPlan)}
    assert fields == {"ns", "ms", "ranks", "backend", "weights"}


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
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [4, 256])
def test_the_launch_passes_chain_geometrys_tiles(fake_launch, B, int8):
    ns, ms, ranks = GATE_UP
    wd = torch.int8 if int8 else torch.bfloat16
    x = torch.zeros(B, 4096, dtype=torch.bfloat16)
    packed = [torch.zeros(ns[t] * ranks[t + 1], ms[t] * ranks[t], dtype=wd)
              for t in (2, 1, 0)]
    scales = torch.ones(3) if int8 else None
    name = "tt_fused_chain_int8" if int8 else "tt_fused_chain"
    y = tt_contract._launch_chain(name, x, packed, scales, GATE_UP)
    assert y.shape == (B, 11008) and y.dtype == torch.bfloat16
    (fn, args), = fake_launch.calls
    assert fn == name + "_bf16"
    d = ctypes.cast(args[1], ctypes.POINTER(ctypes.c_void_p))
    assert args[0] == x.data_ptr()
    assert [d[j] for j in range(3)] == [p.data_ptr() for p in packed]
    ints = [ctypes.cast(a, ctypes.POINTER(ctypes.c_int)) for a in args[2:5]]
    assert [[a[t] for t in range(n)] for a, n in zip(ints, (3, 3, 4))] == [
        list(ns), list(ms), list(ranks)]
    assert args[5] == 3
    rest = args[6:]
    if int8:
        assert rest[0] == scales.data_ptr()
        rest = rest[1:]
    geo = tt_contract.chain_geometry(B, GATE_UP, 2, 2 - int8,
                                     hw.H100_SXM.sm_count,
                                     hw.H100_SXM.smem_per_block)
    # the address tables: built once per geometry, on x's device
    tables = tt_contract._chain_tables_on(x.device, GATE_UP, geo, 2)
    assert rest[0] == tables.data_ptr() and tables.dtype == torch.int32
    assert tables.tolist() == tt_contract.chain_tables(GATE_UP, geo.bb,
                                                       geo.g, geo.g2, 2)
    assert rest[1:] == (y.data_ptr(), B, geo.bb, geo.g, geo.g2, geo.ncc,
                        geo.stages, geo.smem, 0)
    # the C arrays of the dims are the memoized geometry's, built once
    assert args[2:5] == geo.c_dims
    if B == 4:   # decode: one row, one m_3 value, two m_2 values a block
        assert (geo.bb, geo.g, geo.g2, geo.grid) == (1, 1, 2, (4, 8, 4))
    tt_contract.reset_launch_counts()


def test_the_step_launch_geometry(fake_launch):
    G = torch.zeros(1, 8, 1376, 16, dtype=torch.bfloat16)
    X = torch.zeros(32, 8, 16, dtype=torch.bfloat16)
    out = tt_contract._launch_step("tt_step", G, X, None)
    assert out.shape == (1376, 32, 1) and out.dtype == torch.float32
    (name, args), = fake_launch.calls
    assert name == "tt_step_bf16"
    assert args[:3] == (G.data_ptr(), X.data_ptr(), out.data_ptr())
    # decode, step 2/2 of ffn gate/up: 4 rows by 64 m values per block
    # (8 × 22 = 176 blocks), all 8 n values in one chunk, 8 r1 values per
    # shared load
    geo = tt_contract.step_geometry(1, 8, 1376, 16, 32, 2, 2,
                                    hw.H100_SXM.sm_count,
                                    hw.H100_SXM.smem_per_block)
    assert args[3:-1] == (1, 8, 1376, 16, 32, 4, 64, 1, 8, 8, geo.smem)
    assert geo.grid == (22, 8)
    tt_contract.reset_launch_counts()


def test_the_int8_step_launch_passes_the_scale(fake_launch):
    G = torch.zeros(16, 512, 8, 1, dtype=torch.int8)
    X = torch.zeros(32, 512, 1, dtype=torch.float32)
    s = torch.ones(1)
    tt_contract._launch_step("tt_step_int8", G, X, s)
    (name, args), = fake_launch.calls
    assert name == "tt_step_int8_f32"
    assert args[2] == s.data_ptr()
    # decode, step 1/2: 4 rows by all 8 m values of one r0 per block
    # (16 × 8 = 128 blocks); r1 = 1: two n values per load of X
    assert args[4:13] == (16, 512, 8, 1, 32, 4, 8, 1, 512)
    assert args[13] == 2
    tt_contract.reset_launch_counts()


@pytest.mark.parametrize("r0,n,m,r1,b,want", [
    (16, 512, 8, 1, 32, (4, 8, 1, 512, 2)),      # d=2 step 1 at decode
    (1, 8, 512, 16, 2048, (64, 64, 1, 8, 8)),    # d=2 step 2 at prefill
    (300, 4, 3, 2, 10, (8, 3, 5, 4, 1)),         # r0 above a block's tile
])
def test_step_geometry(r0, n, m, r1, b, want):
    geo = tt_contract.step_geometry(r0, n, m, r1, b, 2, 2, 132, 232_448)
    assert (geo.tb, geo.tm, geo.tr, geo.nc, geo.kv) == want
    assert geo.tb % tt_contract.STEP_RB == 0
    assert geo.smem == tt_contract.step_smem_bytes(
        n, r1, geo.tb, geo.tm, geo.tr, geo.nc, geo.kv, 2, 2) <= 232_448
    # when one n value of the chosen tile does not fit, it raises
    least = tt_contract.step_smem_bytes(n, r1, geo.tb, geo.tm, geo.tr, 1,
                                        geo.kv, 2, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.step_geometry(r0, n, m, r1, b, 2, 2, 132, least - 1)


def test_step_launch_needs_shapes_the_grid_holds(fake_launch):
    # 64 rows per block at most: one row more than 65535 tiles of 64
    G = torch.zeros(1, 1, 1, 1)
    X = torch.zeros(64 * 65535 + 1, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        tt_contract._launch_step("tt_step", G, X, None)
