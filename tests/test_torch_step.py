"""The step kernel's launch geometry (``tt_contract.step_geometry``) at
every full-width deepseek-7b step shape: enough blocks at decode for the
H100's SMs, shared memory and threads within a block's limits, and one
memoized answer per shape.  The kernel itself runs only on a card
(``tests/test_torch_gpu.py``)."""
import pytest

from repro_torch.core import hw
from repro_torch.kernels import tt_contract

SM = hw.H100_SXM.sm_count
SMEM = hw.H100_SXM.smem_per_block
# (r0, n, m, r1) of every step of deepseek-7b's TT projections at rank 16,
# and how many b rows one row of x gives that step: length 2 (attn and
# gate/up step 1, down step 1; attn and down step 2, gate/up step 2) and
# length 3 (step 1 of attn/gate-up and of down, step 2, step 3 of
# attn/down and of gate/up)
FULL_WIDTH_STEPS = [
    ((16, 512, 8, 1), 8), ((16, 1376, 8, 1), 8),
    ((1, 8, 512, 16), 8), ((1, 8, 1376, 16), 8),
    ((16, 64, 8, 1), 64), ((16, 172, 8, 1), 64), ((16, 8, 8, 16), 64),
    ((1, 8, 64, 16), 64), ((1, 8, 172, 16), 64),
]
# (activation bytes, core bytes): fp32, bf16, int8 cores under either
TYPES = [(4, 4), (2, 2), (4, 1), (2, 1)]


def _ids(case):
    (r0, n, m, r1), per_row = case
    return f"r0={r0},n={n},m={m},r1={r1},b={per_row}B"


@pytest.mark.parametrize("types", TYPES, ids=lambda t: f"a{t[0]}w{t[1]}")
@pytest.mark.parametrize("rows", [4, 256])
@pytest.mark.parametrize("case", FULL_WIDTH_STEPS, ids=_ids)
def test_full_width_step_geometry(case, rows, types):
    (r0, n, m, r1), per_row = case
    b = rows * per_row
    a, w = types
    geo = tt_contract.step_geometry(r0, n, m, r1, b, a, w, SM, SMEM)
    blocks = geo.grid[0] * geo.grid[1]
    if rows == 4:       # decode: 90% of the SMs get a block
        assert blocks >= SM * 9 // 10 == 118
    assert geo.grid == (-(-m // geo.tm) * -(-r0 // geo.tr), -(-b // geo.tb))
    assert geo.grid[1] <= 65535
    # the block tile is whole register tiles of 4 rows, at most 256 of them
    assert geo.tb % tt_contract.STEP_RB == 0
    tiles = (geo.tb // tt_contract.STEP_RB) * -(
        -geo.tm * geo.tr // tt_contract.STEP_RJ)
    assert tiles <= tt_contract.STEP_THREADS
    assert geo.smem == tt_contract.step_smem_bytes(
        n, r1, geo.tb, geo.tm, geo.tr, geo.nc, geo.kv, a, w) <= SMEM
    assert geo.nc == n or geo.nc % 16 == 0
    # r1 = 16 takes one 16-byte vector of activations per shared load;
    # r1 = 1 two n values of X and four m values of G
    assert geo.kv == (16 // a if r1 == 16 else 2)
    if rows == 256:     # prefill: each staged value feeds several FMAs
        assert geo.tb >= 32 and geo.tm * geo.tr >= 64


def test_step_geometry_is_memoized():
    args = (16, 512, 8, 1, 32, 2, 2, SM, SMEM)
    assert tt_contract.step_geometry(*args) is \
        tt_contract.step_geometry(*args)


def test_step_slot_holds_all_of_n_at_decode():
    # step 1/2 of ffn down at 4 rows: one chunk of all 1376 n values
    # (G[r0, :, :, 0] one run of 1376·8 values per block), so the block
    # waits for its staging once
    geo = tt_contract.step_geometry(16, 1376, 8, 1, 32, 2, 2, SM, SMEM)
    assert (geo.tb, geo.tm, geo.tr, geo.nc) == (4, 8, 1, 1376)


def test_step_tiles_shrink_to_fill_the_card():
    # fewer SMs: larger tiles suffice; a card with many: the smallest tiles
    big = tt_contract.step_geometry(1, 8, 512, 16, 32, 2, 2, 8, SMEM)
    small = tt_contract.step_geometry(1, 8, 512, 16, 32, 2, 2, SM, SMEM)
    assert big.tb * big.tm > small.tb * small.tm
    most = tt_contract.step_geometry(1, 8, 512, 16, 32, 2, 2, 10_000, SMEM)
    assert (most.tb, most.tm) == (4, 4)
