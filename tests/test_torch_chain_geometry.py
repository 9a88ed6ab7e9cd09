"""The fused chain's launch geometry (``tt_contract.chain_geometry``) at
every full-width deepseek-7b length-3 shape, and a CPU mirror of the
kernel's block decomposition (``csrc/tt_chain.cu``): per block (row tile,
group of m_{d-1} values, group of m_{d-2} values, the first step
recomputed), its local states in the kernel's operand layout and its
writes in the kernel's order, held against the plain version and the
reference's Pallas kernel in interpret mode.  The kernel itself runs only
on a card (``tests/test_torch_gpu.py``).

Tolerance: 1e-5 relative in fp32 (the mirror sums in another order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_core as jpack
from repro.core.quant import pack_core_int8
from repro.kernels.tt_contract import (tt_fused_chain_int8_pallas,
                                       tt_fused_chain_pallas)
from repro_torch.configs import get_config
from repro_torch.core import hw
from repro_torch.core.packing import pack_core
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import ref, tt_contract
from repro_torch.models.layers import plan_for

SM = hw.H100_SXM.sm_count
SMEM = hw.H100_SXM.smem_per_block
# (ns, ms, ranks) of deepseek-7b's length-3 TT projections at rank 16
FULL3 = {
    "attn": ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1)),
    "gate_up": ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)),
    "down": ((8, 8, 172), (64, 8, 8), (1, 16, 16, 1)),
}
# (activation bytes, core bytes): fp32, bf16, int8 cores under either
TYPES = [(4, 4), (2, 2), (4, 1), (2, 1)]
# the fused-chain shapes of tests/test_torch_gpu.py and test_torch_chain.py:
# d = 2, 3, 4, modes 43 and 172 = 4·43, ranks no multiple of 8
CHAIN_CASES = [
    ((2, 86), (43, 2), (1, 4, 1), 5),
    ((2, 3, 43), (5, 2, 3), (1, 3, 4, 1), 13),
    ((2, 2, 16), (32, 2, 2), (1, 4, 4, 1), 9),
    ((2, 2, 3, 2), (3, 2, 2, 2), (1, 2, 3, 2, 1), 7),
    ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1), 4),
    ((8, 8, 172), (64, 8, 8), (1, 16, 16, 1), 37),
    ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1), 4),
]


def _blocks(geo) -> int:
    return geo.grid[0] * geo.grid[1] * geo.grid[2]


@pytest.mark.parametrize("types", TYPES, ids=lambda t: f"a{t[0]}w{t[1]}")
@pytest.mark.parametrize("rows", [1, 4, 256])
@pytest.mark.parametrize("name", sorted(FULL3))
def test_full_width_chain_geometry(name, rows, types):
    ns, ms, ranks = dims = FULL3[name]
    a, w = types
    geo = tt_contract.chain_geometry(rows, dims, a, w, SM, SMEM)
    assert geo.smem == tt_contract.chain_smem_bytes(
        ns, ms, ranks, geo.bb, geo.g, geo.g2, geo.ncc, geo.stages, a,
        w) <= SMEM
    assert geo.stages == 2
    assert geo.grid == (-(-rows // geo.bb), -(-ms[-1] // geo.g),
                        -(-ms[-2] // geo.g2))
    assert geo.ncc % 16 == 0 and geo.bb <= tt_contract.MAX_CHAIN_TILE
    if rows == 4:       # decode: 90% of the SMs get a block
        assert _blocks(geo) >= SM * 9 // 10 == 118
        assert geo.bb == 1
    if rows == 256:     # prefill: no split of m_{d-1} or m_{d-2}
        assert (geo.g, geo.g2) == (ms[-1], ms[-2])
        assert _blocks(geo) >= 118
    if rows == 1:       # one row: every (m_{d-1}, m_{d-2}) pair a block
        assert (geo.bb, geo.g, geo.g2) == (1, 1, 1) and _blocks(geo) == 64


def test_chain_geometry_is_memoized():
    args = (4, FULL3["gate_up"], 2, 2, SM, SMEM)
    geo = tt_contract.chain_geometry(*args)
    assert tt_contract.chain_geometry(*args) is geo
    ns, ms, ranks = FULL3["gate_up"]
    assert [list(a[:n]) for a, n in zip(geo.c_dims, (3, 3, 4))] == [
        list(ns), list(ms), list(ranks)]


@pytest.mark.parametrize("B,want", [
    (4, (1, 1, 2)),         # decode: m_{d-2} in pairs, 4 × 8 × 4 blocks
    (37, (1, 2, 8)),        # g groups alone reach 148 blocks
    (256, (2, 8, 8)),       # prefill: whole modes, 2 rows a block
    (10_000, (3, 8, 8)),    # shared memory caps the rows
])
def test_chain_geometry_prefers_no_recompute(B, want):
    geo = tt_contract.chain_geometry(B, FULL3["attn"], 2, 2, SM, SMEM)
    assert (geo.bb, geo.g, geo.g2) == want


def test_chain_geometry_raises_when_one_row_does_not_fit():
    ns, ms, ranks = FULL3["attn"]
    least = tt_contract.chain_smem_bytes(ns, ms, ranks, 1, 1, 1, 16, 1, 2,
                                         2)
    assert tt_contract.chain_geometry(4, FULL3["attn"], 2, 2, SM,
                                      least).smem == least
    with pytest.raises(ValueError, match="shared memory"):
        tt_contract.chain_geometry(4, FULL3["attn"], 2, 2, SM, least - 1)


def test_a_core_too_tall_for_two_slots_gets_one():
    """ffn down at length 2 through the chain: its first core is 1376 rows
    tall, so in fp32 even two 16-column chunks of it overflow a block."""
    dims = ((8, 1376), (512, 8), (1, 16, 1))
    geo = tt_contract.chain_geometry(4, dims, 4, 4, SM, SMEM)
    assert geo.stages == 1 and geo.smem <= SMEM
    assert tt_contract.chain_smem_bytes(*dims, 1, 1, 1, 16, 2, 4, 4) > SMEM
    assert tt_contract.chain_geometry(4, dims, 2, 2, SM, SMEM).stages == 2


def _config_chains():
    """(ns, ms, ranks) of every TT projection of deepseek-7b SMOKE and FULL
    at lengths 2, 3 and 4, and of the test shapes."""
    out = {c[:3] for c in CHAIN_CASES}
    for variant, rank, min_factor in (("smoke", 4, 2), ("full", 16, 8)):
        cfg = get_config("deepseek-7b", variant)
        shapes = {(cfg.d_model, cfg.q_dim), (cfg.d_model, cfg.kv_dim),
                  (cfg.q_dim, cfg.d_model), (cfg.d_model, cfg.d_ff),
                  (cfg.d_ff, cfg.d_model)}
        for N, M in shapes:
            for length in (2, 3, 4):
                p = plan_for(M, N, rank, length, min_factor)
                out.add((p.ns, p.ms, p.ranks))
    return sorted(out)


@pytest.mark.parametrize("rows", [1, 4, 37, 256])
def test_every_chain_the_plan_admits_gets_a_geometry(rows):
    admitted = 0
    for ns, ms, ranks in _config_chains():
        if len(ns) < 2:
            continue
        plan = tplan.plan_tt_forward(ns, ms, ranks)
        explicit = tplan.plan_tt_forward(ns, ms, ranks, backend="cuda_fused")
        assert explicit.backend == "cuda_fused"
        if plan.backend != "cuda_fused" and len(ns) >= 3:
            continue
        admitted += 1
        for a, w in TYPES:
            geo = tt_contract.chain_geometry(rows, (ns, ms, ranks), a, w,
                                             SM, SMEM)
            assert geo.smem <= SMEM
    assert admitted >= 10


# ---------------------------------------------------------------------------
# the block decomposition, mirrored on the CPU
# ---------------------------------------------------------------------------

def _up(a, b):
    return -(-a // b) * b


def mirror_chain(x, packed, dims, tiles, scales=None, act_bytes=4):
    """The kernel's blocks one after another in fp32: per block its rows,
    its g group of m_{d-1} and g2 group of m_{d-2}, the first step
    recomputed, each step's core columns in chunks of at most ``ncc``,
    its states in the kernel's padded operand layout (unwritten cells NaN,
    padding columns zero), and its outputs scattered through its variant
    of the host's address tables (``tt_contract.chain_tables``), y from
    the block's first output.  Returns y and how often each of its
    elements was written."""
    bb, g, g2, ncc = tiles
    ns, ms, ranks = dims
    d = len(ns)
    B, N = x.shape
    M = math.prod(ms)
    nan = float("nan")
    steps = [(ns[t] * ranks[t + 1], ranks[t], ns[t - 1] if t else 1)
             for t in range(d - 1, -1, -1)]
    Kp = [_up(K, 16) for K, _, _ in steps]
    ldA = [k + (8 if act_bytes == 2 else 4) for k in Kp]
    mfull = [g, g2] + [ms[d - 1 - j] for j in range(2, d)]
    cc = [min(_up(mfull[j] * R, 16), ncc) for j, (_, R, _) in
          enumerate(steps)]
    # table offsets: per step a row table then a column table
    tabs = torch.tensor(tt_contract.chain_tables(dims, bb, g, g2, act_bytes))
    offs, at, bl = [], 0, N // ns[-1]
    for j, (_, R, nn) in enumerate(steps):
        offs.append((at, at + _up(bb * bl, 16)))
        at += _up(bb * bl, 16) + _up(mfull[j] * R, 16)
        bl = mfull[j] * bl // nn
    assert tabs.numel() == 4 * at
    y = torch.full((B * M,), nan)
    writes = torch.zeros(B * M, dtype=torch.int64)
    xs = x.float()
    for bx in range(-(-B // bb)):
        for by in range(-(-ms[-1] // g)):
            for bz in range(-(-ms[-2] // g2)):
                row0, gs, g2s = bx * bb, by * g, bz * g2
                rows = min(bb, B - row0)
                gn, g2n = min(g, ms[-1] - gs), min(g2, ms[-2] - g2s)
                base = ((gn < g) + 2 * (g2n < g2)) * at
                ybase = row0 * M + (gs + g2s * ms[1] if d == 2
                                    else g2s * ms[-1] + gs)
                mloc = [gn, g2n] + mfull[2:]
                bl = [N // ns[-1]]
                for j, (_, _, nn) in enumerate(steps):
                    bl.append(mloc[j] * bl[j] // nn)
                A = torch.zeros(_up(rows * bl[0], 16), ldA[0])
                A[:rows * bl[0], :steps[0][0]] = xs[row0:row0 + rows] \
                    .reshape(rows * bl[0], steps[0][0])
                for j, (K, R, nn) in enumerate(steps):
                    last = j == d - 1
                    Mv = rows * bl[j]
                    col0 = (gs if j == 0 else g2s if j == 1 else 0) * R
                    cw = mloc[j] * R
                    ro = tabs[base + offs[j][0]:][:Mv]
                    colT = tabs[base + offs[j][1]:]
                    if not last:
                        nxt = torch.full((_up(rows * bl[j + 1], 16),
                                          ldA[j + 1]), nan)
                        nxt[:, steps[j + 1][0]:Kp[j + 1]] = 0
                        flat = nxt.view(-1)
                        seen = torch.zeros(flat.numel(), dtype=torch.int64)
                    P = packed[j].float()
                    for c0 in range(0, cw, cc[j]):
                        cv = min(cc[j], cw - c0)
                        Bt = torch.zeros(Kp[j], cc[j])
                        Bt[:K, :cv] = P[:, col0 + c0:col0 + c0 + cv]
                        out = A[:, :Kp[j]] @ Bt
                        if scales is not None:
                            out = out * scales[j]
                        co = colT[c0:c0 + cv]
                        idx = (ro[:, None] + co[None, :]).reshape(-1)
                        vals = out[:Mv, :cv].reshape(-1)
                        if last:
                            y[idx + ybase] = vals
                            writes.index_add_(0, idx + ybase,
                                              torch.ones_like(idx))
                        else:
                            flat[idx] = vals
                            seen.index_add_(0, idx, torch.ones_like(idx))
                    if not last:
                        # every cell of the next state written exactly once
                        valid = nxt[:rows * bl[j + 1], :steps[j + 1][0]]
                        assert bool(torch.isfinite(valid).all())
                        assert int(seen.max()) == 1
                        A = nxt
    return y.view(B, M), writes.view(B, M)


def _case(ns, ms, ranks, B, int8, seed=0):
    rng = np.random.default_rng(seed)
    cores = [rng.standard_normal((ranks[t], ns[t], ms[t], ranks[t + 1]))
             .astype(np.float32) * 0.5 for t in range(len(ns))]
    x = rng.standard_normal((B, math.prod(ns))).astype(np.float32)
    if int8:
        q = [pack_core_int8(jnp.asarray(G)) for G in reversed(cores)]
        packed = [torch.from_numpy(np.array(p)) for p, _ in q]
        scales = torch.tensor([float(s) for _, s in q], dtype=torch.float32)
        jax_y = tt_fused_chain_int8_pallas(
            jnp.asarray(x), [p for p, _ in q], [s for _, s in q],
            (ns, ms, ranks), block_b=8, interpret=True)
    else:
        packed = [pack_core(torch.from_numpy(G)) for G in reversed(cores)]
        scales = None
        jax_y = tt_fused_chain_pallas(
            jnp.asarray(x), [jpack(jnp.asarray(G)) for G in reversed(cores)],
            (ns, ms, ranks), block_b=8, interpret=True)
    return torch.from_numpy(x), packed, scales, np.asarray(jax_y)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _forced_tiles(ms):
    """A tile that cuts both grouped modes raggedly where they allow it,
    two rows a block, one 16-column chunk at a time."""
    return 2, min(ms[-1], 3), min(ms[-2], 5), 16


def _mirror_case(ns, ms, ranks, B, int8, act_bytes):
    x, packed, scales, jax_y = _case(ns, ms, ranks, B, int8)
    dims = (ns, ms, ranks)
    want = ref.tt_fused_chain_ref(x, packed, dims, scales)
    _close(want.numpy(), jax_y)
    geo = tt_contract.chain_geometry(B, dims, act_bytes, 1 if int8 else
                                     act_bytes, SM, SMEM)
    for tiles in ((geo.bb, geo.g, geo.g2, geo.ncc), _forced_tiles(ms)):
        y, writes = mirror_chain(x, packed, dims, tiles, scales, act_bytes)
        assert bool((writes == 1).all()), tiles   # each output once
        _close(y.numpy(), want.numpy())
        _close(y.numpy(), jax_y)


@pytest.mark.parametrize("act_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_block_mirror_matches_plain_and_pallas(ns, ms, ranks, B, int8,
                                               act_bytes):
    """The mirror's layouts follow x's type (bf16 operands are padded by 8
    elements, fp32 by 4); its arithmetic is fp32 either way."""
    _mirror_case(ns, ms, ranks, B, int8, act_bytes)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", sorted(FULL3))
def test_block_mirror_at_full_width_with_two_rows(name, int8):
    _mirror_case(*FULL3[name], 2, int8, 2)
