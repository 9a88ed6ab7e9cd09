"""The port's planner at TT length 3: the DSE picks the reference's shapes,
``auto`` routes d≥3 chains to the fused chain or, when one row of its state
does not fit a block's shared memory, to the step kernel; and the fused
chain's row tile is chosen in one place, ``fused_chain_batch_tile``."""
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
    (232_448, 3),              # H100: 3 rows of 64 KB
    (ROW, 1),                  # exactly one row
    (10 * ROW, 10),
    (100 * ROW, 32),           # the cap
])
def test_fused_chain_batch_tile_is_what_shared_memory_holds(smem, want):
    assert tt_contract.fused_chain_batch_tile(*GATE_UP, smem) == want


def test_fused_chain_batch_tile_prices_one_buffer_at_d2():
    # d=2 keeps only s1 = n1·m2·r1 = 8·8·16 floats
    assert tt_contract.chain_row_bytes((8, 512), (1376, 8), (1, 16, 1)) == \
        8 * 8 * 16 * 4
    with pytest.raises(ValueError, match="d >= 2"):
        tt_contract.chain_row_bytes((6,), (4,), (1, 1))
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.fused_chain_batch_tile(*GATE_UP, ROW - 1)


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


def test_the_launch_takes_its_tile_from_fused_chain_batch_tile(
        fake_launch, monkeypatch):
    seen = []
    real = tt_contract.fused_chain_batch_tile

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(tt_contract, "fused_chain_batch_tile", spy)
    ns, ms, ranks = GATE_UP
    x = torch.zeros(4, 4096, dtype=torch.bfloat16)
    packed = [torch.zeros(ns[t] * ranks[t + 1], ms[t] * ranks[t],
                          dtype=torch.bfloat16) for t in (2, 1, 0)]
    y = tt_contract._launch_chain("tt_fused_chain", x, packed, None,
                                  GATE_UP)
    assert y.shape == (4, 11008) and y.dtype == torch.bfloat16
    assert seen == [(ns, ms, ranks, hw.H100_SXM.smem_per_block)]
    (name, args), = fake_launch.calls
    assert name == "tt_fused_chain_bf16"
    d = ctypes.cast(args[1], ctypes.POINTER(ctypes.c_void_p))
    assert [d[j] for j in range(3)] == [p.data_ptr() for p in packed]
    ints = [ctypes.cast(a, ctypes.POINTER(ctypes.c_int)) for a in args[2:5]]
    assert [[a[t] for t in range(n)] for a, n in zip(ints, (3, 3, 4))] == [
        list(ns), list(ms), list(ranks)]
    # decode: one row per block, the last step's 172 columns in 6 splits
    assert args[5] == 3 and args[7:10] == (4, 1, 6)
    tt_contract.reset_launch_counts()


def test_the_step_launch_geometry(fake_launch):
    G = torch.zeros(1, 8, 1376, 16, dtype=torch.bfloat16)
    X = torch.zeros(32, 8, 16, dtype=torch.bfloat16)
    out = tt_contract._launch_step("tt_step", G, X, None)
    assert out.shape == (1376, 32, 1) and out.dtype == torch.float32
    (name, args), = fake_launch.calls
    assert name == "tt_step_bf16"
    # r0 = 1: 32 b rows per block (all of b), 8 n-values (all of n)
    assert args[3:-1] == (1, 8, 1376, 16, 32, 32, 1, 8)
    tt_contract.reset_launch_counts()


@pytest.mark.parametrize("r0,n,r1,b,want", [
    (16, 512, 1, 32, (16, 16, 84)),      # d=2 step 1 at decode
    (1, 8, 16, 2048, (256, 1, 2)),       # d=2 step 2 at prefill
    (300, 4, 2, 10, (1, 256, 2)),        # r0 above one block's threads
])
def test_step_geometry(r0, n, r1, b, want):
    tb, rc, nc = tt_contract.step_geometry(r0, n, r1, b, 232_448)
    assert (tb, rc, nc) == want
    assert tb * rc <= tt_contract.STEP_THREADS
    need = (tb + tt_contract.STEP_M_TILE * rc) * ((nc * r1) | 1) * 4
    assert need <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.step_geometry(r0, n, r1, b, need - 1)


def test_step_launch_needs_shapes_the_grid_holds(fake_launch):
    G = torch.zeros(1, 1, 8 * 65536, 1)
    X = torch.zeros(2, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        tt_contract._launch_step("tt_step", G, X, None)
