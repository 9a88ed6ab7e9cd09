"""The port's hand-written kernels on a CUDA card against their plain
versions, at small shapes with modes that are not powers of two and row
counts that are not a multiple of any tile.

This file imports neither JAX nor the reference package, so it runs on a
card without them; ``tests/conftest.py`` imports JAX, hence::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import build, get_config
from repro_torch.configs.base import TTConfig
from repro_torch.core.packing import pack_core
from repro_torch.core.quant import quantize_core
from repro_torch.kernels import ref, tt_contract
from repro_torch.kernels.ops import tt_forward
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.engine import generate_fixed

pytestmark = pytest.mark.gpu

# (n1, n2, m1, m2, r1, B): n2 = 2·43 and m1 = 43 are not powers of two
CASES = [
    (2, 8, 4, 2, 3, 5),
    (2, 86, 43, 2, 4, 13),
    (8, 512, 1376, 8, 16, 37),
]
# every full-width deepseek-7b length-2 shape at rank 16 (attn q/k/v/o,
# ffn gate/up, ffn down) at the decode and prefill row counts
FULL_WIDTH = [(8, 512, 512, 8, 16, B) for B in (4, 256)] + [
    (8, 512, 1376, 8, 16, B) for B in (4, 256)] + [
    (8, 1376, 512, 8, 16, B) for B in (4, 256)]
# deepseek-v2-lite's dense first layer: m1 and n2 of 1,368, no multiple of
# 16 (ragged m1 slices, a stage-1 depth that is no multiple of mma's k16,
# int8 P1 rows of 1,368 bytes that take the scalar staging loop)
DSV2_DENSE0 = [(8, 256, 1368, 8, 16, B) for B in (4, 256)] + [
    (8, 1368, 256, 8, 16, B) for B in (4, 256)]
# max |kernel − plain| / max |plain|: fp32 differs only in summation order;
# a bf16 output is rounded to 8 significant bits on both sides
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dims, B, act, int8, device, seed=0):
    n1, n2, m1, m2, r1 = dims
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G1 = torch.randn((1, n1, m1, r1), generator=gen, device=device) * 0.3
    G2 = torch.randn((r1, n2, m2, 1), generator=gen, device=device) * 0.3
    x = torch.randn((B, n1 * n2), generator=gen, device=device).to(act)
    if int8:
        (q1, s1), (q2, s2) = quantize_core(G1), quantize_core(G2)
        return x, pack_core(q2), pack_core(q1), torch.stack([s2, s1]).float()
    return x, pack_core(G2.to(act)), pack_core(G1.to(act)), None


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2,m1,m2,r1,B", CASES + FULL_WIDTH +
                         DSV2_DENSE0)
def test_fused2_kernel_matches_plain(cuda, n1, n2, m1, m2, r1, B, act,
                                     int8):
    dims = (n1, n2, m1, m2, r1)
    x, p2, p1, scales = _inputs(dims, B, act, int8, cuda)
    name = "tt_fused2_int8" if int8 else "tt_fused2"
    before = tt_contract.launch_counts().get(name, 0)
    if int8:
        y = tt_contract.tt_fused2_int8(x, p2, p1, scales, dims)
    else:
        y = tt_contract.tt_fused2(x, p2, p1, dims)
    want = ref.tt_fused2_ref(x, p2, p1, dims, scales)
    assert tt_contract.launch_counts()[name] == before + 1
    assert y.shape == want.shape and y.dtype == want.dtype == act
    assert bool(torch.isfinite(y).all())
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[act] * float(want.float().abs().max())


def test_fused2_kernel_rejects_cores_on_another_device(cuda):
    x, p2, p1, _ = _inputs((2, 8, 4, 2, 3), 5, torch.float32, False, cuda)
    with pytest.raises(ValueError, match="is on"):
        tt_contract.tt_fused2(x, p2.cpu(), p1, (2, 8, 4, 2, 3))


# (ns, ms, ranks, B) of fused chains: d = 2, 3, 4; modes 43 and 172 = 4·43;
# the three full-width deepseek-7b length-3 shapes; row counts that are not
# a multiple of any tile
CHAIN_CASES = [
    ((2, 86), (43, 2), (1, 4, 1), 5),
    ((2, 3, 43), (5, 2, 3), (1, 3, 4, 1), 13),
    ((2, 2, 3, 2), (3, 2, 2, 2), (1, 2, 3, 2, 1), 7),
    ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1), 4),
    ((8, 8, 172), (64, 8, 8), (1, 16, 16, 1), 37),
    ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1), 3),
    # d = 2, ffn down at length 2: in fp32 one ring slot, no chunk ahead
    ((8, 1376), (512, 8), (1, 16, 1), 4),
]
# the full-width length-3 shapes (attn q/k/v/o, ffn gate/up, ffn down)
FULL_WIDTH_CHAINS = [((8, 8, 64), (64, 8, 8), (1, 16, 16, 1)),
                     ((8, 8, 64), (172, 8, 8), (1, 16, 16, 1)),
                     ((8, 8, 172), (64, 8, 8), (1, 16, 16, 1))]


def _chain_inputs(ns, ms, ranks, B, act, int8, device, seed=0, offset=0):
    """x (a view ``offset`` elements into its buffer), the cores and, for
    int8 cores, their scales in core order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cores = [torch.randn((ranks[t], ns[t], ms[t], ranks[t + 1]),
                         generator=gen, device=device) * 0.3
             for t in range(len(ns))]
    N = math.prod(ns)
    buf = torch.randn(offset + B * N, generator=gen, device=device).to(act)
    x = buf[offset:].view(B, N)
    if int8:
        qs = [quantize_core(G) for G in cores]
        return x, [q for q, _ in qs], torch.stack([s for _, s in qs]).float()
    return x, [G.to(act) for G in cores], None


def _close(y, want, act):
    assert y.shape == want.shape and y.dtype == want.dtype
    assert bool(torch.isfinite(y).all())
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[act] * float(want.float().abs().max())


def _chain(x, cores, scales, dims):
    """(kernel, plain) outputs of the fused chain on x."""
    packed = [pack_core(G) for G in reversed(cores)]
    if scales is None:
        return (tt_contract.tt_fused_chain(x, packed, dims),
                ref.tt_fused_chain_ref(x, packed, dims))
    s = scales.flip(0).contiguous()
    return (tt_contract.tt_fused_chain_int8(x, packed, s, dims),
            ref.tt_fused_chain_ref(x, packed, dims, s))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_fused_chain_kernel_matches_plain(cuda, ns, ms, ranks, B, act,
                                          int8):
    x, cores, scales = _chain_inputs(ns, ms, ranks, B, act, int8, cuda)
    name = "tt_fused_chain_int8" if int8 else "tt_fused_chain"
    before = tt_contract.launch_counts().get(name, 0)
    y, want = _chain(x, cores, scales, (ns, ms, ranks))
    assert tt_contract.launch_counts()[name] == before + 1
    _close(y, want, act)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [4, 256])
@pytest.mark.parametrize("dims", FULL_WIDTH_CHAINS, ids=["attn", "gate_up",
                                                         "down"])
def test_fused_chain_kernel_at_full_width(cuda, dims, rows, act, int8):
    x, cores, scales = _chain_inputs(*dims, rows, act, int8, cuda)
    y, want = _chain(x, cores, scales, dims)
    _close(y, want, act)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dims,B", [(CHAIN_CASES[1][:3], 13),
                                    (FULL_WIDTH_CHAINS[2], 4),
                                    (FULL_WIDTH_CHAINS[1], 256)])
def test_fused_chain_kernel_takes_x_at_an_odd_offset(cuda, dims, B, act,
                                                     int8):
    """x one element into its buffer is not 16-byte aligned: staged by
    narrower copies (fp32) or the kernel's scalar loop (bf16)."""
    x, cores, scales = _chain_inputs(*dims, B, act, int8, cuda, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y, want = _chain(x, cores, scales, dims)
    _close(y, want, act)


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_chain_kernel_with_many_rows(cuda, act):
    """2,050 rows: shared memory caps the rows per block (3 in bf16), the
    cores are staged in narrow column chunks, the last row tile is
    ragged."""
    x, cores, scales = _chain_inputs(*FULL_WIDTH_CHAINS[1], 2050, act, False,
                                     cuda)
    y, want = _chain(x, cores, scales, FULL_WIDTH_CHAINS[1])
    _close(y, want, act)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("rows", [4, 256])
def test_fused_chain_kernel_is_deterministic(cuda, rows, int8):
    x, cores, scales = _chain_inputs(*FULL_WIDTH_CHAINS[1], rows,
                                     torch.bfloat16, int8, cuda)
    y1, _ = _chain(x, cores, scales, FULL_WIDTH_CHAINS[1])
    y2, _ = _chain(x, cores, scales, FULL_WIDTH_CHAINS[1])
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ns,ms,ranks,B", CHAIN_CASES)
def test_step_kernel_matches_plain(cuda, ns, ms, ranks, B, act, int8):
    """Every step of the chain, each on the state the plain steps before
    it produced."""
    x, cores, scales = _chain_inputs(ns, ms, ranks, B, act, int8, cuda)
    name = "tt_step_int8" if int8 else "tt_step"
    state = x.reshape(-1)
    for t in range(len(cores) - 1, -1, -1):
        G = cores[t]
        st = state.reshape(-1, G.shape[1], G.shape[3])
        before = tt_contract.launch_counts().get(name, 0)
        if int8:
            s = scales[t].reshape(1)
            y = tt_contract.tt_step_int8(G, st, s)
            want = ref.tt_step_ref(G, st, s)
        else:
            y = tt_contract.tt_step(G, st)
            want = ref.tt_step_ref(G, st)
        assert tt_contract.launch_counts()[name] == before + 1
        _close(y, want, torch.float32)
        state = want.reshape(-1).to(act)


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda_step"])
def test_tt_forward_d3_on_the_card_matches_the_cpu(cuda, backend):
    ns, ms, ranks, B = CHAIN_CASES[1]
    x, cores, _ = _chain_inputs(ns, ms, ranks, B, torch.float32, False, cuda)
    y = tt_forward(cores, x, backend=backend)
    want = tt_forward([G.cpu() for G in cores], x.cpu(), backend=backend)
    _close(y.cpu(), want, torch.float32)


def test_chain_and_step_kernels_reject_cores_on_another_device(cuda):
    ns, ms, ranks, B = CHAIN_CASES[1]
    x, cores, _ = _chain_inputs(ns, ms, ranks, B, torch.float32, False, cuda)
    packed = [pack_core(G) for G in reversed(cores)]
    packed[1] = packed[1].cpu()
    with pytest.raises(ValueError, match="is on"):
        tt_contract.tt_fused_chain(x, packed, (ns, ms, ranks))
    G = cores[-1]
    with pytest.raises(ValueError, match="is on"):
        tt_contract.tt_step(G.cpu(), x.reshape(-1, G.shape[1], G.shape[3]))


# (r0, n, m, r1) of every step of deepseek-7b's TT projections at rank 16
# and the b rows one row of x gives it: length 2, then length 3
FULL_WIDTH_STEPS = [
    ((16, 512, 8, 1), 8), ((16, 1376, 8, 1), 8),
    ((1, 8, 512, 16), 8), ((1, 8, 1376, 16), 8),
    ((16, 64, 8, 1), 64), ((16, 172, 8, 1), 64), ((16, 8, 8, 16), 64),
    ((1, 8, 64, 16), 64), ((1, 8, 172, 16), 64),
]


def _step_inputs(shape, b, act, int8, device, seed=0, offset=0):
    """G, X (a view ``offset`` elements into its buffer) and the scale."""
    r0, n, m, r1 = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G = torch.randn((r0, n, m, r1), generator=gen, device=device) * 0.3
    buf = torch.randn(offset + b * n * r1, generator=gen,
                      device=device).to(act)
    X = buf[offset:].view(b, n, r1)
    if int8:
        q, s = quantize_core(G)
        return q, X, s.reshape(1).float()
    return G.to(act), X, None


def _step(G, X, s):
    if s is None:
        return tt_contract.tt_step(G, X), ref.tt_step_ref(G, X)
    return tt_contract.tt_step_int8(G, X, s), ref.tt_step_ref(G, X, s)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [4, 256])
@pytest.mark.parametrize("shape,per_row", FULL_WIDTH_STEPS,
                         ids=lambda v: str(v))
def test_step_kernel_at_full_width(cuda, shape, per_row, rows, act, int8):
    G, X, s = _step_inputs(shape, rows * per_row, act, int8, cuda)
    name = "tt_step_int8" if int8 else "tt_step"
    before = tt_contract.launch_counts().get(name, 0)
    y, want = _step(G, X, s)
    assert tt_contract.launch_counts()[name] == before + 1
    # fp32 output, fp32 sums on both sides: only the order differs
    _close(y, want, torch.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,b", [((16, 512, 8, 1), 32),
                                     ((1, 8, 512, 16), 2048),
                                     ((16, 8, 8, 16), 37)])
def test_step_kernel_takes_x_at_an_odd_offset(cuda, shape, b, act, int8):
    """X one element into its buffer is not 16-byte aligned: staged by the
    kernel's scalar loop."""
    G, X, s = _step_inputs(shape, b, act, int8, cuda, offset=1)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    y, want = _step(G, X, s)
    _close(y, want, torch.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("shape,b", [((16, 1376, 8, 1), 32),
                                     ((1, 8, 1376, 16), 2048)])
def test_step_kernel_is_deterministic(cuda, shape, b, int8):
    G, X, s = _step_inputs(shape, b, torch.bfloat16, int8, cuda)
    y1, _ = _step(G, X, s)
    y2, _ = _step(G, X, s)
    assert torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# The decode step captured as a CUDA graph (models.graph), on deepseek-7b
# SMOKE through each main path's kernel: a replay must give the eager step's
# logits bit for bit (the same ops on the same inputs).
# ---------------------------------------------------------------------------

# path → (TT length, backend, the kernel it launches)
GRAPH_PATHS = {"fused2": (2, "auto", "tt_fused2"),
               "chain": (3, "auto", "tt_fused_chain"),
               "step": (2, "cuda_step", "tt_step")}


def _smoke(path, weights, device):
    length, backend, _ = GRAPH_PATHS[path]
    cfg = get_config("deepseek-7b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        length=length, backend=backend, weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


def _prompt(model, seed, B=2, S=8, T=16):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S), generator=gen)
    return {"tokens": tokens.to(model.device), "cache_len": T}


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_graph_replays_the_eager_step_bit_for_bit(cuda, path, weights):
    model, params = _smoke(path, weights, cuda)
    name = GRAPH_PATHS[path][2] + ("_int8" if weights == "int8" else "")
    batch = _prompt(model, 0)
    logits, eager_cache = model.prefill(params, batch)
    _, graph_cache = model.prefill(params, batch)
    step = model.graphed_decode_step(2, 16)
    step.load(params, graph_cache, 8)
    assert model.graph_captures == 1
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for t in range(4):
        before = tt_contract.launch_counts()
        want, eager_cache = model.decode_step(params, eager_cache, tok)
        eager = {k: v - before.get(k, 0)
                 for k, v in tt_contract.launch_counts().items()
                 if v != before.get(k, 0)}
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert step.captured == eager and set(eager) == {name}
    assert model.replayed_launches == {name: 4 * eager[name]}
    assert int(eager_cache["pos"]) == int(step.cache["pos"]) == step.pos == 12


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_second_generate_captures_nothing_and_gives_eager_tokens(cuda, path):
    model, params = _smoke(path, "fp32", cuda)
    for seed in (0, 1):
        batch = _prompt(model, seed)
        graph = generate_fixed(model, params, batch, 8)
        eager = generate_fixed(model, params, batch, 8, graph=False)
        assert torch.equal(graph.tokens, eager.tokens)
        assert torch.equal(graph.logprobs, eager.logprobs)
        assert model.graph_captures == 1 and len(model.decode_graphs) == 1


def test_replay_outside_the_cache_raises(cuda):
    model, params = _smoke("fused2", "fp32", cuda)
    logits, cache = model.prefill(params, _prompt(model, 0, T=10))
    step = model.graphed_decode_step(2, 10)
    step.load(params, cache, 8)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step(tok)
    step(tok)
    with pytest.raises(ValueError, match="position 10 outside the cache"):
        step(tok)
    with pytest.raises(ValueError, match="outside the cache of 10"):
        generate_fixed(model, params, _prompt(model, 0, T=10), 4)


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A stand-in library that refuses every launch under capture (CUDA's
    error for an operation a capture does not permit): the capture raises,
    nothing is cached as captured, and no eager step stands in."""
    model, params = _smoke("fused2", "fp32", cuda)
    real = tt_contract._lib()

    class NoCapture:
        def __getattr__(self, name):
            fn = getattr(real, name)

            def call(*args):
                if torch.cuda.is_current_stream_capturing():
                    return 900            # cudaErrorStreamCaptureUnsupported
                return fn(*args)
            return call

    monkeypatch.setattr(tt_contract, "_lib", NoCapture)
    # generate_fixed captures its prefill first
    with pytest.raises(RuntimeError, match="capturing the prefill"):
        generate_fixed(model, params, _prompt(model, 0), 4)
    assert model.prefill_builds == 0
    assert model.prefill_graphs[(2, 8, 16)].graph is None
    _, cache = model.prefill(params, _prompt(model, 0))
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        model.graphed_decode_step(2, 16).load(params, cache, 8)
    assert model.graph_captures == 0
    assert model.decode_graphs[(2, 16, False)].graph is None
    from repro_torch.serving.scheduler import Scheduler
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        Scheduler(model, params, num_slots=2, cache_len=16)
    assert model.graph_captures == 0
    assert model.decode_graphs[(2, 16, True)].graph is None


def test_a_model_keeps_the_graphs_of_its_last_shapes(cuda):
    from repro_torch.models.model import GRAPH_CACHE_SIZE
    model, _ = _smoke("fused2", "fp32", cuda)
    first = model.graphed_decode_step(2, 16)
    for T in range(17, 17 + GRAPH_CACHE_SIZE - 1):
        model.graphed_decode_step(2, T)
    assert model.graphed_decode_step(2, 16) is first      # used last now
    model.graphed_decode_step(2, 99)
    assert len(model.decode_graphs) == GRAPH_CACHE_SIZE
    assert (2, 17, False) not in model.decode_graphs
    assert (2, 16, False) in model.decode_graphs
    # a slot-pool graph of the same shape is another entry
    pool = model.graphed_decode_step(2, 16, masked=True)
    assert pool is not first and pool.masked and not first.masked


# ---------------------------------------------------------------------------
# The scheduler's slot-pool step (models.graph.DecodeGraph, masked): a
# position and an ``active`` flag per row, the pool as the graph's static
# cache, one scheduler at a time.
# ---------------------------------------------------------------------------

class _Owner:
    """A stand-in scheduler holding a slot-pool graph."""
    num_active = 0


def _rows(model, params, n, T=16):
    """Prefill caches of ``n`` one-row prompts of lengths 8, 6, 7, ...:
    (first greedy token [1,1], cache, prompt length) each."""
    out = []
    for i in range(n):
        S = (8, 6, 7, 5)[i % 4]
        batch = _prompt(model, 10 + i, B=1, S=S, T=T)
        logits, cache = model.prefill(params, batch)
        out.append((logits[:, -1].argmax(-1, keepdim=True), cache, S))
    return out


def _masked_pair(model, params, rows, slots, T=16):
    """The bound slot-pool graph and an eager pool, each with ``rows``
    spliced into ``slots``."""
    graph = model.graphed_decode_step(3, T, masked=True)
    owner = _Owner()
    graph.bind(owner, params)
    eager = model.init_cache(3, T, per_row=True)
    for (_, cache, S), slot in zip(rows, slots):
        graph.splice(cache, slot, S)
        model.splice_cache(eager, cache, slot)
    return graph, owner, eager


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_slot_pool_replay_is_the_eager_masked_step_bit_for_bit(cuda, path):
    model, params = _smoke(path, "fp32", cuda)
    rows = _rows(model, params, 2)
    graph, _, eager = _masked_pair(model, params, rows, (0, 2))
    assert model.graph_captures == 1
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    tok[0], tok[2] = rows[0][0][0], rows[1][0][0]
    active = np.array([True, False, True])
    for t in range(4):
        want, eager = model.decode_step(params, eager, tok,
                                        torch.from_numpy(active).to(cuda))
        got = graph(tok, active)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert torch.equal(graph.cache["pos"], eager["pos"])
    assert graph.cache["pos"].tolist() == [12, 0, 10]
    assert graph.pos.tolist() == [12, 0, 10]
    for a, b in zip(tree_leaves(graph.cache), tree_leaves(eager)):
        assert torch.equal(a, b)


def test_a_splice_between_replays_is_seen_by_the_next(cuda):
    model, params = _smoke("fused2", "fp32", cuda)
    rows = _rows(model, params, 3)
    graph, _, eager = _masked_pair(model, params, rows[:2], (0, 2))
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    tok[0], tok[2] = rows[0][0][0], rows[1][0][0]
    active = np.array([True, False, True])
    for t in range(5):
        if t == 2:                        # a third request takes slot 1
            graph.splice(rows[2][1], 1, rows[2][2])
            model.splice_cache(eager, rows[2][1], 1)
            tok[1] = rows[2][0][0]
            active[1] = True
        want, eager = model.decode_step(params, eager, tok,
                                        torch.from_numpy(active).to(cuda))
        got = graph(tok, active)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert graph.pos.tolist() == graph.cache["pos"].tolist() == [13, 10, 11]


def test_slot_pool_replay_past_the_cache_raises(cuda):
    model, params = _smoke("fused2", "fp32", cuda)
    rows = _rows(model, params, 1, T=10)
    graph = model.graphed_decode_step(3, 10, masked=True)
    graph.bind(_Owner(), params)
    graph.splice(rows[0][1], 1, 8)
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    active = np.array([False, True, False])
    graph(tok, active)
    graph(tok, active)
    with pytest.raises(ValueError, match="position 10 of row 1 outside"):
        graph(tok, active)
    graph(tok, np.zeros(3, bool))         # an inactive row may sit there
    with pytest.raises(ValueError, match="one position shared"):
        graph.load(params, rows[0][1], 8)


def test_a_second_live_scheduler_on_a_held_graph_raises(cuda):
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    first = Scheduler(model, params, num_slots=2, cache_len=16)
    first.submit(Request(uid=0, inputs=_prompt(model, 0, B=1),
                         max_new_tokens=4))
    first.step()
    assert first.num_active == 1
    with pytest.raises(RuntimeError, match="held by a scheduler with 1"):
        Scheduler(model, params, num_slots=2, cache_len=16)
    other = model.init(1)               # a recapture would zero the pool
    with pytest.raises(RuntimeError, match="held by a scheduler with 1"):
        Scheduler(model, other, num_slots=2, cache_len=16)
    assert first.run()[0].finish_reason == "length"
    assert model.graph_captures == 1


def test_a_new_scheduler_after_a_drain_makes_no_capture(cuda):
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _smoke("fused2", "fp32", cuda)

    def req(uid):
        return Request(uid=uid, inputs=_prompt(model, uid, B=1),
                       max_new_tokens=5)

    first = Scheduler(model, params, num_slots=2, cache_len=16)
    first.submit(req(0))
    a = first.run()[0]
    first.submit(req(1))                  # queued when the graph moves on
    second = Scheduler(model, params, num_slots=2, cache_len=16)
    second.submit(req(0))
    b = second.run()[0]
    assert model.graph_captures == 1
    assert np.array_equal(a.tokens, b.tokens)
    assert np.array_equal(a.logprobs, b.logprobs)
    with pytest.raises(RuntimeError, match="bound by another scheduler"):
        first.step()
    eager = Scheduler(model, params, num_slots=2, cache_len=16, graph=False)
    eager.submit(req(0))
    c = eager.run()[0]
    assert np.array_equal(a.tokens, c.tokens)
    assert np.array_equal(a.logprobs, c.logprobs)


# ---------------------------------------------------------------------------
# The prefill captured as a CUDA graph (models.graph.PrefillGraph), per
# (batch, padded length, cache length): a replay must give the eager
# prefill at the same padded shape bit for bit, logits and cache.
# ---------------------------------------------------------------------------

def _padded(model, seed, L, S, B=1):
    """``B`` prompts of ``L`` tokens right-padded with 0 to ``S``."""
    tokens = _prompt(model, seed, B=B, S=L)["tokens"]
    return torch.nn.functional.pad(tokens, (0, S - L))


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_captured_prefill_is_the_eager_prefill_bit_for_bit(cuda, path,
                                                           weights):
    """Two lengths in the bucket of 16 through one capture, then the
    bucket's full length, each against the eager padded prefill."""
    model, params = _smoke(path, weights, cuda)
    name = GRAPH_PATHS[path][2] + ("_int8" if weights == "int8" else "")
    graph = model.graphed_prefill(2, 16, 32)
    for L in (9, 13, 16):
        tokens = _padded(model, L, L, 16, B=2)
        before = tt_contract.launch_counts()
        want_l, want = model.prefill(params, {
            "tokens": tokens, "cache_len": 32, "prompt_len": L})
        eager = {k: v - before.get(k, 0)
                 for k, v in tt_contract.launch_counts().items()
                 if v != before.get(k, 0)}
        got_l, got = graph(params, tokens, L)
        torch.cuda.synchronize()
        assert torch.equal(got_l, want_l), L
        assert int(got["pos"]) == L
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b), L
    assert model.prefill_builds == 1 and graph.captured == eager
    assert set(eager) == {name}
    assert model.replayed_launches == {name: 3 * eager[name]}


def test_bucketed_prefill_replays_one_graph_per_bucket(cuda):
    """Lengths 3..40 at a cache of 64: three captures (buckets 16, 32 and
    64), every one's logits and cache the eager padded prefill's; the
    buckets of one (batch, cache length) share one output cache."""
    model, params = _smoke("fused2", "fp32", cuda)
    graphed, eager = model.bucketed_prefill(64), model.bucketed_prefill(
        64, graph=False)
    for L in range(3, 41):
        batch = {"tokens": _prompt(model, L, B=1, S=L)["tokens"]}
        want_l, want = eager(params, batch)
        got_l, got = graphed(params, batch)
        assert torch.equal(got_l, want_l), L
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b), L
    keys = [k for k in model.prefill_graphs]
    assert keys == [(1, 16, 64), (1, 32, 64), (1, 64, 64)]
    caches = {id(g.cache) for g in model.prefill_graphs.values()}
    assert len(caches) == 1 and list(model.prefill_caches) == [(1, 64)]
    # 3 captures; the eager entries count on their first key too
    assert model.prefill_builds == 3 + 3
    assert model.graph_captures == 0


def test_prefill_graphs_keep_their_last_keys_and_drop_unused_caches(cuda):
    from repro_torch.models.model import GRAPH_CACHE_SIZE
    model, _ = _smoke("fused2", "fp32", cuda)
    first = model.graphed_prefill(1, 16, 32)
    for T in range(33, 33 + GRAPH_CACHE_SIZE - 1):
        model.graphed_prefill(1, 16, T)
    assert model.graphed_prefill(1, 16, 32) is first     # used last now
    model.graphed_prefill(1, 32, 32)                    # evicts (1, 16, 33)
    assert len(model.prefill_graphs) == GRAPH_CACHE_SIZE
    assert (1, 33) not in model.prefill_caches
    assert model.prefill_graphs[(1, 32, 32)].cache is first.cache
    with pytest.raises(ValueError, match="exceeds the cache"):
        model.graphed_prefill(1, 64, 32)
    with pytest.raises(ValueError, match="prompt_len 17 outside"):
        first(None, torch.zeros((1, 16), dtype=torch.int64), 17)


def test_bucketed_scheduler_captures_while_rows_are_live(cuda):
    """Prompts of 5, 20, 12 and 30 tokens at a cache of 48: a capture per
    bucket (16, 32), the second while the first request decodes; tokens
    and logprobs the eager scheduler's (``graph=False``) bit for bit."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _smoke("fused2", "fp32", cuda)

    def run(graph):
        sched = Scheduler(model, params, num_slots=2, cache_len=48,
                          graph=graph)
        for uid, L in enumerate((5, 20, 12, 30)):
            sched.submit(Request(uid=uid, inputs={"tokens": _prompt(
                model, 20 + uid, B=1, S=L)["tokens"]}, max_new_tokens=6))
            sched.step()
        return sched.run() | {f.uid: f for f in sched.finished}

    builds = model.prefill_builds
    got = run(True)
    assert model.prefill_builds - builds == 2
    assert sorted(model.prefill_graphs) == [(1, 16, 48), (1, 32, 48)]
    want = run(False)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for uid in got:
        assert np.array_equal(got[uid].tokens, want[uid].tokens)
        assert np.array_equal(got[uid].logprobs, want[uid].logprobs)
    assert model.graph_captures == 1
    exact = Scheduler(model, params, num_slots=2, cache_len=48,
                      bucket_prompts=False)
    exact.submit(Request(uid=0, inputs={"tokens": _prompt(
        model, 20, B=1, S=5)["tokens"]}, max_new_tokens=6))
    exact.run()
    assert (1, 5, 48) in model.prefill_graphs


# ---------------------------------------------------------------------------
# The block-paged pool (DESIGN.md §7): the paged slot-pool step and the
# resume prefill captured as CUDA graphs, each against its eager form bit
# for bit; their warm-ups and captures write nowhere but the sentinel block.
# ---------------------------------------------------------------------------

PAGED = dict(num_blocks=12, block=4)      # 3 slots over 24 positions
SENTINEL = PAGED["num_blocks"]


def _paged_rows(model, params, T=24):
    """Prefill caches of two one-row prompts of 16 tokens, the second
    sharing the first's 12 first: (first greedy token [1,1], cache) each."""
    first = _prompt(model, 30, B=1, S=16, T=T)
    second = dict(first, tokens=torch.cat(
        [first["tokens"][:, :12], _prompt(model, 31, B=1, S=4)["tokens"]], 1))
    out = []
    for batch in (first, second):
        logits, cache = model.prefill(params, batch)
        out.append((logits[:, -1].argmax(-1, keepdim=True), cache,
                    batch["tokens"]))
    return out


def _table(*blocks):
    t = torch.full((6,), SENTINEL, dtype=torch.int32)
    t[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    return t.cuda()


def _same_pool(a, b):
    """Positions, tables and every arena block but the sentinel equal."""
    return all(torch.equal(x, y) for x, y in (
        (a["pos"], b["pos"]), (a["block_tables"], b["block_tables"]))) and \
        all(torch.equal(x[:SENTINEL], y[:SENTINEL])
            for x, y in zip(tree_leaves(a["g0"]), tree_leaves(b["g0"])))


def _clone_pool(cache):
    from repro_torch.models.spec import map_tree
    return map_tree(torch.clone, cache)


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_paged_replay_is_the_eager_paged_step_and_the_dense_one(cuda, path):
    """Rows spliced into slots 0 (blocks 0-3, 9) and 2 (blocks 4-8), slot 1
    empty: four replays against the eager paged step and the eager dense
    masked step, logits bit for bit, pools equal."""
    model, params = _smoke(path, "fp32", cuda)
    rows = _paged_rows(model, params)
    graph = model.graphed_decode_step(3, 24, masked=True,
                                      paged=(PAGED["num_blocks"],
                                             PAGED["block"]))
    graph.bind(_Owner(), params)
    assert model.graph_captures == 1
    eager = model.init_cache(3, 24, paged=True, **PAGED)
    dense = model.init_cache(3, 24, per_row=True)
    for (_, cache, _), slot, table in zip(rows, (0, 2), (
            _table(0, 1, 2, 3, 9), _table(4, 5, 6, 7, 8))):
        graph.splice_paged(cache, slot, 16, table)
        model.splice_cache_paged(eager, cache, slot, table)
        model.splice_cache(dense, cache, slot)
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    tok[0], tok[2] = rows[0][0][0], rows[1][0][0]
    active = np.array([True, False, True])
    act = torch.from_numpy(active).to(cuda)
    for t in range(4):
        want, eager = model.decode_step(params, eager, tok, act)
        flat, dense = model.decode_step(params, dense, tok, act)
        got = graph(tok, active)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        assert torch.equal(want[[0, 2]], flat[[0, 2]]), f"dense, step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert graph.pos.tolist() == graph.cache["pos"].tolist() == [20, 0, 20]
    assert _same_pool(graph.cache, eager)


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_resume_replay_is_the_eager_resume_bit_for_bit(cuda, path):
    """Slot 0 holds a prompt in blocks 0-3 and decodes; slot 1 resumes the
    prompt sharing its 12 first tokens (blocks 0-2 shared, from 12), then,
    after a decode replay, slot 2 resumes the first prompt fully covered
    (block 3 copied on write to 9, from 15): one capture for the bucket of
    16, each replay's logits and pool the eager resume's bit for bit, and
    the decode replays after them the eager steps'."""
    model, params = _smoke(path, "fp32", cuda)
    rows = _paged_rows(model, params)
    graph = model.graphed_decode_step(3, 24, masked=True,
                                      paged=(PAGED["num_blocks"],
                                             PAGED["block"]))
    graph.bind(_Owner(), params)
    eager = model.init_cache(3, 24, paged=True, **PAGED)
    first = _table(0, 1, 2, 3, 4, 5)
    graph.splice_paged(rows[0][1], 0, 16, first)
    model.splice_cache_paged(eager, rows[0][1], 0, first)
    builds = model.prefill_builds
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    tok[0] = rows[0][0][0]
    active = np.array([True, False, False])
    for slot, suffix, src, dst, start in (
            (1, rows[1][2][:, 12:], _table(0, 1, 2, 6, 7, 8),
             _table(0, 1, 2, 6, 7, 8), 12),
            (2, rows[0][2][:, 15:], _table(0, 1, 2, 3, 10, 11),
             _table(0, 1, 2, 9, 10, 11), 15)):
        got = model.resume_prefill(params, graph.cache, suffix, slot, src,
                                   dst, start, graph).clone()
        want = model.resume_prefill(params, eager, suffix, slot, src, dst,
                                    start)
        torch.cuda.synchronize()
        assert torch.equal(got, want), slot
        assert _same_pool(graph.cache, eager), slot
        assert graph.pos[slot] == start + suffix.shape[1]
        tok[slot] = got[:, -1].argmax(-1)
        active[slot] = True
        act = torch.from_numpy(active).to(cuda)
        logits, eager = model.decode_step(params, eager, tok, act)
        assert torch.equal(graph(tok, active), logits), slot
        tok = logits[:, -1].argmax(-1, keepdim=True)
    assert list(graph.resumes) == [16]
    # one capture; the eager key (bucket 16) counted once too
    assert model.prefill_builds - builds == 2
    assert model.graph_captures == 1
    assert _same_pool(graph.cache, eager)


def test_resume_capture_writes_only_the_sentinel_block(cuda):
    """A resume's warm-up and capture (at its bucket's first call) run while
    a row is live: positions, tables and every arena block but the
    sentinel stay as they were; a recapture of the decode graph drops the
    resume graphs."""
    from repro_torch.models.graph import ResumeGraph
    model, params = _smoke("fused2", "fp32", cuda)
    rows = _paged_rows(model, params)
    graph = model.graphed_decode_step(3, 24, masked=True,
                                      paged=(PAGED["num_blocks"],
                                             PAGED["block"]))
    owner = _Owner()
    graph.bind(owner, params)
    graph.splice_paged(rows[0][1], 0, 16, _table(0, 1, 2, 3, 4, 5))
    before = _clone_pool(graph.cache)
    resume = graph.resumes[32] = ResumeGraph(graph, 32)
    resume._capture()
    torch.cuda.synchronize()
    assert _same_pool(graph.cache, before)
    assert resume.captured and model.prefill_builds == 1
    with pytest.raises(ValueError, match="resume of 4 tokens from 22"):
        graph.resume(torch.zeros((1, 16), dtype=torch.int64, device=cuda), 1,
                     _table(), _table(), 22, 4)
    graph.bind(owner, model.init(1))       # other parameters: a recapture
    assert graph.resumes == {} and model.graph_captures == 2


def test_paged_scheduler_graph_is_eager_and_dense_bit_for_bit(cuda):
    """Prompts of 16 (two sharing 12 tokens, one resubmitted) and 9 tokens
    through a paged scheduler of 2 slots over 32 positions, block 4, on the
    graphs and eagerly, and through the dense scheduler: every token and
    logprob bit for bit; one resume capture (bucket 16), no block
    leaked."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    rows = _paged_rows(model, params)
    prompts = [rows[0][2], rows[1][2], _prompt(model, 32, B=1, S=9)["tokens"],
               rows[0][2]]

    def run(**kw):
        sched = Scheduler(model, params, num_slots=2, cache_len=32, **kw)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=8 - uid))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
        return {f.uid: f for f in sched.finished}, sched

    builds = model.prefill_builds
    got, sched = run(paged=True, block_size=4)
    assert sched.stats()["prefix_hit_tokens"] == 12 + 16
    assert list(sched.graph.resumes) == [16]
    captured = model.prefill_builds - builds
    assert captured == 2                    # the prompts' bucket and a resume
    for want, _ in (run(paged=True, block_size=4, graph=False), run()):
        assert sorted(got) == sorted(want) == [0, 1, 2, 3]
        for uid in got:
            assert np.array_equal(got[uid].tokens, want[uid].tokens), uid
            assert np.array_equal(got[uid].logprobs, want[uid].logprobs), uid


# ---------------------------------------------------------------------------
# Chunked prefill (DESIGN.md §15): the mixed step captured as a CUDA graph
# per (lanes, chunk) on a live slot pool, dense or paged, against the eager
# mixed step bit for bit; its capture changes no live row.
# ---------------------------------------------------------------------------

def _mixed_pools(model, params, paged):
    """A bound slot-pool graph of 3 slots over 24 positions (paged: 12
    blocks of 4) and an eager pool of the same layout, slot 0 holding a
    16-token prompt (blocks 0-3 and 9) in both: (graph, eager pool, the
    prompt's first greedy token)."""
    first, cache, _ = _paged_rows(model, params)[0]
    table = _table(0, 1, 2, 3, 9)
    if paged:
        graph = model.graphed_decode_step(3, 24, masked=True,
                                          paged=(PAGED["num_blocks"],
                                                 PAGED["block"]))
        eager = model.init_cache(3, 24, paged=True, **PAGED)
    else:
        graph = model.graphed_decode_step(3, 24, masked=True)
        eager = model.init_cache(3, 24, per_row=True)
    graph.bind(_Owner(), params)
    if paged:
        graph.splice_paged(cache, 0, 16, table)
        model.splice_cache_paged(eager, cache, 0, table)
    else:
        graph.splice(cache, 0, 16)
        model.splice_cache(eager, cache, 0)
    return graph, eager, first


def _chunk_lanes(model, rows, paged, K=2, C=4):
    """Host lane arrays for (slot, prompt [1, S], start, true length,
    blocks) rows, the lanes past them inactive."""
    lanes = {"tokens": np.zeros((K, C), np.int64),
             "slot": np.zeros((K,), np.int32),
             "start": np.zeros((K,), np.int32),
             "true": np.ones((K,), np.int32),
             "active": np.zeros((K,), bool)}
    if paged:
        lanes["tables"] = np.full((K, 6), SENTINEL, np.int32)
    for j, (slot, prompt, start, n, blocks) in enumerate(rows):
        lanes["tokens"][j, :n] = prompt[0, start:start + n].cpu().numpy()
        lanes["slot"][j], lanes["start"][j] = slot, start
        lanes["true"][j], lanes["active"][j] = n, True
        if paged:
            lanes["tables"][j, :len(blocks)] = blocks
    return lanes


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_mixed_replay_is_the_eager_mixed_step_bit_for_bit(cuda, path, paged):
    """Slot 0 decodes while slots 1 and 2 prefill 7 and 6 tokens in chunks
    of 4 over two lanes (one lane unused in the last step): three replays
    of the mixed graph against the eager mixed step, decode and chunk
    logits bit for bit, pools equal, one capture, the host mirror of the
    positions the device's."""
    model, params = _smoke(path, "fp32", cuda)
    graph, eager, first = _mixed_pools(model, params, paged)
    p1 = _prompt(model, 40, B=1, S=7)["tokens"]
    p2 = _prompt(model, 41, B=1, S=6)["tokens"]
    tok = torch.zeros((3, 1), dtype=torch.int64, device=cuda)
    tok[0] = first[0]
    captures = model.graph_captures
    for step, (rows, active) in enumerate((
            ([(1, p1, 0, 4, [4, 5]), (2, p2, 0, 4, [6, 7])],
             [True, False, False]),
            ([(1, p1, 4, 3, [4, 5]), (2, p2, 4, 2, [6, 7])],
             [True, False, False]),
            ([], [True, True, True]))):
        if step == 2:
            tok[1] = want_ck[0].argmax()
            tok[2] = want_ck[1].argmax()
        lanes = _chunk_lanes(model, rows, paged)
        active = np.array(active)
        got, got_ck = graph.mixed(2, 4)(tok, active, lanes)
        dev = {k: torch.from_numpy(v).to(cuda) for k, v in lanes.items()}
        want, want_ck, eager = model.mixed_step(
            params, eager, tok, torch.from_numpy(active).to(cuda),
            dev["tokens"], dev["slot"], dev["start"], dev["true"],
            dev["active"], dev.get("tables"))
        torch.cuda.synchronize()
        assert torch.equal(got, want), step
        assert torch.equal(got_ck, want_ck), step
        if paged:
            assert _same_pool(graph.cache, eager), step
        else:
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(graph.cache), tree_leaves(eager))), step
        assert graph.pos.tolist() == graph.cache["pos"].tolist(), step
        tok[0] = want[0, -1].argmax()
    assert graph.pos.tolist() == [19, 8, 7]
    assert model.graph_captures - captures == 1
    assert list(graph.mixed_graphs) == [(2, 4)]
    assert graph.mixed_graphs[(2, 4)].captured


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_capture_leaves_live_rows_untouched(cuda, paged):
    """The mixed step's warm-up and capture run while slot 0 is live (the
    row every inactive lane points at): positions, tables, every k/v row
    (paged: every block but the sentinel) stay as they were, bit for bit;
    a lane outside the pool is refused; a recapture of the decode graph
    drops the mixed graphs."""
    from repro_torch.models.graph import MixedGraph
    model, params = _smoke("fused2", "fp32", cuda)
    graph, _, _ = _mixed_pools(model, params, paged)
    before = _clone_pool(graph.cache)
    mixed = graph.mixed_graphs[(2, 8)] = MixedGraph(graph, 2, 8)
    mixed._capture()
    torch.cuda.synchronize()
    if paged:
        assert _same_pool(graph.cache, before)
    else:
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(graph.cache), tree_leaves(before)))
    assert mixed.captured and graph.pos.tolist() == [16, 0, 0]
    lanes = _chunk_lanes(model, [(1, torch.zeros((1, 28), dtype=torch.int64),
                                  20, 8, [4, 5])], paged, C=8)
    with pytest.raises(ValueError, match="chunk lanes"):
        mixed(torch.zeros((3, 1), dtype=torch.int64, device=cuda),
              np.zeros(3, bool), lanes)
    graph.bind(_Owner(), model.init(1))     # other parameters: a recapture
    assert graph.mixed_graphs == {}


def test_chunked_scheduler_paged_is_dense_is_eager(cuda):
    """Prompts of 13, 9 and 16 tokens (the last sharing the first's 12
    first) through a chunked scheduler of 2 slots over 32 positions, chunks
    of 4 over 2 lanes: paged through the graphs, paged eager and dense
    through the graphs give every token and logprob bit for bit, one mixed
    capture each, and the monolithic scheduler's tokens; no block
    leaked."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    first = _prompt(model, 50, B=1, S=13)["tokens"]
    prompts = [first, _prompt(model, 51, B=1, S=9)["tokens"],
               torch.cat([first[:, :12],
                          _prompt(model, 52, B=1, S=4)["tokens"]], 1)]

    def run(**kw):
        sched = Scheduler(model, params, num_slots=2, cache_len=32, **kw)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=8 - uid))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
        return {f.uid: f for f in sched.finished}, sched

    chunked = dict(chunk_prefill=True, chunk_size=4, prefill_budget=8)
    captures = model.graph_captures
    got, sched = run(paged=True, block_size=4, **chunked)
    assert list(sched.graph.mixed_graphs) == [(2, 4)]
    assert sched.stats()["prefix_hit_tokens"] == 12
    assert model.graph_captures - captures == 2    # the step and the mixed
    for kw in (dict(paged=True, block_size=4, graph=False, **chunked),
               chunked):
        want, _ = run(**kw)
        assert sorted(got) == sorted(want) == [0, 1, 2]
        for uid in got:
            assert np.array_equal(got[uid].tokens, want[uid].tokens), uid
            assert np.array_equal(got[uid].logprobs, want[uid].logprobs), uid
    mono, _ = run()
    for uid in got:
        assert np.array_equal(got[uid].tokens, mono[uid].tokens), uid


# --------------------------------------------------------------------------
# gemma3: the ring paths captured against eager
# --------------------------------------------------------------------------

def _gemma3(device, weights="fp32"):
    """gemma3 SMOKE (window 16), TT on ffn+attn at rank 4, ``auto``."""
    cfg = get_config("gemma3-4b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_gemma3_prefill_and_decode_replays_are_eager(cuda, weights):
    """The captured prefill of prompts of 20 (bucket 32) and 40 into a
    cache of 64 against the eager prefill (logits, rings and full caches
    bit for bit), then the fixed-batch decode graph over 24 steps, the
    rings wrapping, against the eager step bit for bit."""
    model, params = _gemma3(cuda, weights)
    for S, S_pad in ((20, 32), (40, 40)):
        batch = _prompt(model, S, B=2, S=S, T=64)
        tokens = torch.nn.functional.pad(batch["tokens"], (0, S_pad - S))
        g_logits, g_cache = model.graphed_prefill(2, S_pad, 64)(
            params, tokens, S)
        e_logits, e_cache = model.prefill(params, {
            "tokens": tokens, "cache_len": 64, "prompt_len": S})
        assert torch.equal(g_logits, e_logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                     tree_leaves(e_cache)))
        assert g_cache["g0"][0]["b0"]["k"].shape[1] == 16
    step = model.graphed_decode_step(2, 64)
    step.load(params, g_cache, 40)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(24):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(step.cache),
                                                 tree_leaves(e_cache)))


@pytest.mark.parametrize("kw", [
    {}, dict(chunk_prefill=True, chunk_size=8, prefill_budget=16),
    dict(chunk_prefill=True, chunk_size=24)],
    ids=["monolithic", "chunk8x2", "chunk24"])
def test_gemma3_scheduler_graph_is_eager_and_paged_is_dense(cuda, kw):
    """Prompts of 40, 24, 8 and 20 through 2 slots over 48 positions: the
    dense pool through the graphs (masked decode, admissions or mixed
    steps) against eager, and the paged pool (blocks of 4) through the
    graphs, all bit for bit; no prefix hit, no block leaked."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _gemma3(cuda)
    prompts = [_prompt(model, 60 + i, B=1, S=n)["tokens"]
               for i, n in enumerate((40, 24, 8, 20))]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw,
                          **extra)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=6 - uid))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
            assert sched.stats()["prefix_hit_tokens"] == 0
        return {f.uid: f for f in sched.finished}

    got = run()
    for extra in (dict(graph=False), dict(paged=True, block_size=4),
                  dict(paged=True, block_size=4, graph=False)):
        want = run(**extra)
        assert sorted(got) == sorted(want) == [0, 1, 2, 3]
        for uid in got:
            assert np.array_equal(got[uid].tokens, want[uid].tokens), uid
            assert np.array_equal(got[uid].logprobs, want[uid].logprobs), uid


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gemma3_mixed_capture_leaves_live_rings_untouched(cuda, paged):
    """A mixed step captured on a live pool (slot 0 holds a 40-token
    prompt, its rings wrapped; every inactive lane points at it): every
    ring and full k/v row (paged: every block but the sentinel), position
    and table stays as it was, bit for bit."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _gemma3(cuda)
    kw = dict(paged=True, block_size=4) if paged else {}
    sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw)
    sched.submit(Request(uid=0, inputs={"tokens": _prompt(
        model, 70, B=1, S=40)["tokens"]}, max_new_tokens=4))
    sched.step()
    graph = sched.graph
    pool = graph.cache
    before = [t.clone() for t in tree_leaves(pool)]
    graph.mixed(2, 8)._capture()
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(pool), before):
        if paged and a.dim() == 4:
            a, b = a[:-1], b[:-1]              # the sentinel block
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# mixtral: the expert-batched fused2 kernel and the MoE paths captured
# --------------------------------------------------------------------------

# (E, C, n1, n2, m1, m2, r1): small ragged stacks, then mixtral-8x7b's
# expert projections at every capacity its paths run: one row, decode (C =
# 8), a 64-token chunk (20), an admission at the 256 bucket (128) and the
# 4 × 512 prefill (640)
MIXTRAL_EXPERTS = ((8, 512, 1792, 8, 16), (8, 1792, 512, 8, 16))
EXPERT_CASES = [(3, 5, 2, 8, 4, 2, 3), (4, 13, 2, 86, 43, 2, 4),
                (4, 37, 2, 86, 43, 2, 3)] + [
    (8, C, *dims) for C in (1, 8, 20, 128, 640) for dims in MIXTRAL_EXPERTS]
# deepseek-v2-lite's 64 experts (gate/up 2048→1408, down 1408→2048)
DSV2_EXPERTS = ((8, 256, 176, 8, 16), (8, 176, 256, 8, 16))
EXPERT_CASES += [(64, C, *dims) for C in (1, 8, 20, 128, 256)
                 for dims in DSV2_EXPERTS]


def _expert_inputs(E, C, dims, act, int8, device, seed=0):
    n1, n2, m1, m2, r1 = dims
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G1 = torch.randn((E, 1, n1, m1, r1), generator=gen, device=device) * 0.3
    G2 = torch.randn((E, r1, n2, m2, 1), generator=gen, device=device) * 0.05
    x = torch.randn((E, C, n1 * n2), generator=gen, device=device).to(act)
    if int8:
        (q1, s1), (q2, s2) = quantize_core(G1), quantize_core(G2)
        return x, pack_core(q2), pack_core(q1), torch.stack(
            [s2, s1], -1).float().contiguous()
    return x, pack_core(G2.to(act)), pack_core(G1.to(act)), None


def _experts(x, p2, p1, scales, dims):
    if scales is None:
        return tt_contract.tt_fused2_experts(x, p2, p1, dims)
    return tt_contract.tt_fused2_experts_int8(x, p2, p1, scales, dims)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,n1,n2,m1,m2,r1", EXPERT_CASES)
def test_expert_fused2_kernel_matches_plain(cuda, E, C, n1, n2, m1, m2, r1,
                                            act, int8):
    """One launch across the stack, each expert within the tolerance of
    its plain version, and the same bits on a second call."""
    dims = (n1, n2, m1, m2, r1)
    x, p2, p1, scales = _expert_inputs(E, C, dims, act, int8, cuda)
    name = "tt_fused2_experts" + ("_int8" if int8 else "")
    before = tt_contract.launch_counts().get(name, 0)
    y = _experts(x, p2, p1, scales, dims)
    assert tt_contract.launch_counts()[name] == before + 1
    want = ref.tt_fused2_experts_ref(x, p2, p1, dims, scales)
    torch.cuda.synchronize()
    assert y.shape == want.shape == (E, C, m1 * m2) and y.dtype == act
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[act] * float(want.float().abs().max()), err
    assert torch.equal(_experts(x, p2, p1, scales, dims), y)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("C", [8, 128])
def test_expert_fused2_kernel_replays_as_captured(cuda, C, int8):
    """The launch captured into a CUDA graph (nothing read on the host):
    one recorded launch, and a replay on new inputs gives the eager call's
    bits."""
    dims = MIXTRAL_EXPERTS[0]
    x, p2, p1, scales = _expert_inputs(8, C, dims, torch.bfloat16, int8,
                                       cuda)
    name = "tt_fused2_experts" + ("_int8" if int8 else "")
    _experts(x, p2, p1, scales, dims)            # build and opt in first
    torch.cuda.synchronize()
    before = tt_contract.capture_counts().get(name, 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = _experts(x, p2, p1, scales, dims)
    assert tt_contract.capture_counts()[name] == before + 1
    x.copy_(torch.randn(x.shape, device=cuda).to(x.dtype))
    graph.replay()
    want = _experts(x, p2, p1, scales, dims)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def _mixtral(device, weights="fp32", **moe_kw):
    """mixtral SMOKE (window 32, 4 experts top-2), TT on ffn+attn at rank
    4, ``auto``; ``moe_kw`` replaces MoEConfig fields."""
    import dataclasses
    cfg = get_config("mixtral-8x7b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **moe_kw))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("cf", [16.0, 0.25], ids=["dropless", "drops"])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_mixtral_prefill_and_decode_replays_are_eager(cuda, weights, cf):
    """The captured prefill (prompts of 20 in the 32 bucket and of 40 into
    a cache of 64) and 24 decode replays against the eager prefill and
    steps, bit for bit, with the experts' launches inside the graphs; at a
    capacity factor of 0.25 the replays drop what the eager calls drop,
    counted on the device."""
    from repro_torch.models import moe
    model, params = _mixtral(cuda, weights, capacity_factor=cf)
    for S, S_pad in ((20, 32), (40, 40)):
        batch = _prompt(model, S, B=2, S=S, T=64)
        tokens = torch.nn.functional.pad(batch["tokens"], (0, S_pad - S))
        graph = model.graphed_prefill(2, S_pad, 64)
        graph(params, tokens, S)                    # the capture
        moe.reset_drops()
        g_logits, g_cache = graph(params, tokens, S)
        g_drops = moe.read_drops()
        moe.reset_drops()
        e_logits, e_cache = model.prefill(params, {
            "tokens": tokens, "cache_len": 64, "prompt_len": S})
        assert moe.read_drops() == g_drops and (g_drops > 0) == (cf < 1)
        assert torch.equal(g_logits, e_logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                     tree_leaves(e_cache)))
    step = model.graphed_decode_step(2, 64)
    step.load(params, g_cache, 40)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(24):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    name = "tt_fused2_experts" + ("_int8" if weights == "int8" else "")
    assert step.captured.get(name) == 3 * 2          # 3 a layer, 2 layers


@pytest.mark.parametrize("kw", [
    {}, dict(chunk_prefill=True, chunk_size=8, prefill_budget=16),
    dict(chunk_prefill=True, chunk_size=24)],
    ids=["monolithic", "chunk8x2", "chunk24"])
def test_mixtral_scheduler_graph_is_eager_and_paged_is_dense(cuda, kw):
    """Prompts of 40, 24, 8 and 20 through 2 slots over 48 positions: the
    dense pool through the graphs against eager, and the paged pool
    (blocks of 4) through the graphs and eagerly, all bit for bit, with
    the same drop counts (none: SMOKE is dropless)."""
    from repro_torch.models import moe
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _mixtral(cuda)
    prompts = [_prompt(model, 80 + i, B=1, S=n)["tokens"]
               for i, n in enumerate((40, 24, 8, 20))]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw,
                          **extra)
        moe.reset_drops()
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=6 - uid))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
        assert moe.read_drops() == 0
        return {f.uid: f for f in sched.finished}

    got = run()
    for extra in (dict(graph=False), dict(paged=True, block_size=4),
                  dict(paged=True, block_size=4, graph=False)):
        want = run(**extra)
        assert sorted(got) == sorted(want) == [0, 1, 2, 3]
        for uid in got:
            assert np.array_equal(got[uid].tokens, want[uid].tokens), uid
            assert np.array_equal(got[uid].logprobs, want[uid].logprobs), uid


def _deepseek_v2(device, weights="fp32"):
    """deepseek-v2-lite SMOKE (MLA, a dense first layer, 4 experts top-2
    with a shared one, dropless), TT on ffn+attn at rank 4, ``auto``."""
    cfg = get_config("deepseek-v2-lite-16b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_deepseek_v2_prefill_and_decode_replays_are_eager(cuda, weights):
    """The captured prefill (a prompt of 20 in the 32 bucket) and 16
    absorbed-form decode replays against the eager prefill and steps, bit
    for bit, with both TT kernels inside the graphs."""
    model, params = _deepseek_v2(cuda, weights)
    batch = _prompt(model, 5, B=2, S=20, T=48)
    tokens = torch.nn.functional.pad(batch["tokens"], (0, 12))
    graph = model.graphed_prefill(2, 32, 48)
    graph(params, tokens, 20)                       # the capture
    g_logits, g_cache = graph(params, tokens, 20)
    e_logits, e_cache = model.prefill(params, {
        "tokens": tokens, "cache_len": 48, "prompt_len": 20})
    assert torch.equal(g_logits, e_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                 tree_leaves(e_cache)))
    step = model.graphed_decode_step(2, 48)
    step.load(params, g_cache, 20)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(16):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    sfx = "_int8" if weights == "int8" else ""
    # q, o and the dense MLP's 3 in layer 0; q, o, the shared MLP's 3 and
    # the experts' 3 in each of the 2 MoE layers
    assert step.captured.get("tt_fused2" + sfx) == 5 + 2 * 5
    assert step.captured.get("tt_fused2_experts" + sfx) == 2 * 3


@pytest.mark.parametrize("kw", [
    {}, dict(chunk_prefill=True, chunk_size=8, prefill_budget=16)],
    ids=["monolithic", "chunk8x2"])
def test_deepseek_v2_scheduler_graph_is_eager_and_paged_is_dense(cuda, kw):
    """Prompts of 20, 24 (sharing the first 16 tokens) and the first again
    through 2 slots over 48 positions: the dense pool through the graphs
    against eager, and the paged pool (blocks of 4, prefix reuse on: the
    resume and its copy on write) through the graphs and eagerly, the
    tokens identical and the logprobs bit for bit where the two runs take
    the same form (dense against paged prefix hits: the absorbed resume
    against the expanded prefill, within 1e-4)."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _deepseek_v2(cuda)
    first = _prompt(model, 90, B=1, S=20)["tokens"]
    second = torch.cat([first[:, :16],
                        _prompt(model, 91, B=1, S=8)["tokens"]], 1)
    prompts = [first, second, first]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw,
                          **extra)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=5))
            sched.step()
            if uid == 1:
                sched.run()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
        return {f.uid: f for f in sched.finished}, sched.stats()

    dense, _ = run()
    runs = {k: run(**extra) for k, extra in (
        ("dense eager", dict(graph=False)),
        ("paged", dict(paged=True, block_size=4)),
        ("paged eager", dict(paged=True, block_size=4, graph=False)))}
    assert runs["paged"][1]["prefix_hit_tokens"] > 0
    for k, (got, _) in runs.items():
        assert sorted(got) == sorted(dense) == [0, 1, 2]
        for uid in got:
            assert np.array_equal(got[uid].tokens, dense[uid].tokens), k
            if k == "dense eager":
                assert np.array_equal(got[uid].logprobs,
                                      dense[uid].logprobs), k
            else:
                np.testing.assert_allclose(got[uid].logprobs,
                                           dense[uid].logprobs, atol=1e-4)
    paged, eager = runs["paged"][0], runs["paged eager"][0]
    for uid in paged:
        assert np.array_equal(paged[uid].logprobs, eager[uid].logprobs)


# mamba2-2.7b's SSD projections at rank 16: in_proj (m1 = 1,322, whose P1
# rows are 16-byte aligned in no dtype: the scalar staging loop, ragged m1
# slices) and out_proj, at decode, admission and the 4 × 1,024 prefill
MAMBA2_SHAPES = ((8, 320, 1322, 8, 16), (8, 640, 320, 8, 16))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4, 256, 4096])
@pytest.mark.parametrize("dims", MAMBA2_SHAPES, ids=["in_proj", "out_proj"])
def test_fused2_kernel_at_mamba2_shapes(cuda, dims, B, act, int8):
    x, p2, p1, scales = _inputs(dims, B, act, int8, cuda, seed=B)
    if int8:
        y = tt_contract.tt_fused2_int8(x, p2, p1, scales, dims)
    else:
        y = tt_contract.tt_fused2(x, p2, p1, dims)
    want = ref.tt_fused2_ref(x, p2, p1, dims, scales)
    assert y.shape == want.shape and bool(torch.isfinite(y).all())
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[act] * float(want.float().abs().max())


def _mamba2(device, variant="smoke", weights="fp32"):
    """mamba2 SMOKE (TT on ffn at rank 4) or FULL (bf16, rank 16), ``auto``
    backend: the in/out projections through ``tt_fused2``."""
    smoke = variant == "smoke"
    cfg = get_config("mamba2-2.7b", variant, tt=TTConfig(
        enabled=True, families=("ffn",), rank=4 if smoke else 16,
        min_factor=2 if smoke else 8, backend="auto", weights=weights))
    model = build(cfg, param_dtype=torch.float32 if smoke
                  else torch.bfloat16, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("variant,weights", [("smoke", "fp32"),
                                             ("smoke", "int8"),
                                             ("full", "fp32")])
def test_mamba2_prefill_and_decode_replays_are_eager(cuda, variant, weights):
    """The captured prefill (a prompt of 20 in the 32 bucket: padded steps
    leave the state alone) and 8 decode replays against the eager prefill
    and steps, bit for bit: the state (fp32) and conv history updated in
    place inside the graph; FULL at full width, 64 layers."""
    model, params = _mamba2(cuda, variant, weights)
    batch = _prompt(model, 5, B=2, S=20, T=48)
    tokens = torch.nn.functional.pad(batch["tokens"], (0, 12))
    graph = model.graphed_prefill(2, 32, 48)
    graph(params, tokens, 20)                       # the capture
    g_logits, g_cache = graph(params, tokens, 20)
    e_logits, e_cache = model.prefill(params, {
        "tokens": tokens, "cache_len": 48, "prompt_len": 20})
    assert torch.equal(g_logits, e_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                 tree_leaves(e_cache)))
    assert g_cache["g0"][0]["b0"]["state"].dtype == torch.float32
    step = model.graphed_decode_step(2, 48)
    step.load(params, g_cache, 20)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(8):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    sfx = "_int8" if weights == "int8" else ""
    assert step.captured.get("tt_fused2" + sfx) == \
        2 * model.cfg.num_layers


@pytest.mark.parametrize("kw", [
    {}, dict(chunk_prefill=True, chunk_size=5, prefill_budget=10)],
    ids=["monolithic", "chunk5x2"])
def test_mamba2_scheduler_graph_is_eager_and_paged_is_dense(cuda, kw):
    """Prompts of 20, 13 and 24 through 2 slots over 48 positions: the
    dense pool through the graphs against eager, and the paged pool (no
    arena; blocks of 4 accounted) through the graphs and eagerly, tokens
    and logprobs bit for bit; the prefix cache stays off."""
    _slot_state_pools_agree(*_mamba2(cuda), kw)


def _slot_state_pools_agree(model, params, kw):
    """Prompts of 20, 13 and 24 through 2 slots over 48 positions (``kw``:
    the chunking): the dense pool through the graphs, eagerly, and the
    paged pool (blocks of 4) through the graphs and eagerly, tokens and
    logprobs bit for bit; no paged pool turns the prefix cache on."""
    from repro_torch.serving.scheduler import Request, Scheduler
    prompts = [_prompt(model, 90 + i, B=1, S=n)["tokens"]
               for i, n in enumerate((20, 13, 24))]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=48, **kw,
                          **extra)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=5))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
            assert not sched.prefix_cache
        return {f.uid: f for f in sched.finished}

    dense = run()
    for extra in (dict(graph=False), dict(paged=True, block_size=4),
                  dict(paged=True, block_size=4, graph=False)):
        got = run(**extra)
        assert sorted(got) == sorted(dense) == [0, 1, 2]
        for uid in got:
            assert np.array_equal(got[uid].tokens, dense[uid].tokens)
            assert np.array_equal(got[uid].logprobs, dense[uid].logprobs)


# jamba-v0.1-52b's SSD projections at rank 16: in_proj (m1 = 2,068, whose
# P1 rows are 16-byte aligned in bf16 and int8 only through the scalar
# staging loop) and out_proj (n2 = 1,024), at decode, admission and the
# 4 × 1,024 prefill; its 16-expert stacks at mixtral's expert shapes
JAMBA_SHAPES = ((8, 512, 2068, 8, 16), (8, 1024, 512, 8, 16))
EXPERT_CASES_16 = [(16, C, *dims) for C in (8, 128, 640)
                   for dims in MIXTRAL_EXPERTS]


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4, 256, 4096])
@pytest.mark.parametrize("dims", JAMBA_SHAPES, ids=["in_proj", "out_proj"])
def test_fused2_kernel_at_jamba_shapes(cuda, dims, B, act, int8):
    test_fused2_kernel_at_mamba2_shapes(cuda, dims, B, act, int8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,n1,n2,m1,m2,r1", EXPERT_CASES_16)
def test_expert_fused2_kernel_over_16_experts(cuda, E, C, n1, n2, m1, m2,
                                              r1, act, int8):
    test_expert_fused2_kernel_matches_plain(cuda, E, C, n1, n2, m1, m2, r1,
                                            act, int8)


def _jamba(device, weights="fp32"):
    """jamba SMOKE (one period: SSD+MLP, SSD+MoE, GQA+MLP, SSD+MoE; 4
    experts top-2, dropless), TT on ffn+attn at rank 4, ``auto``."""
    cfg = get_config("jamba-v0.1-52b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_jamba_prefill_and_decode_replays_are_eager(cuda, weights):
    """The captured prefill (a prompt of 20 in the 32 bucket) and 8 decode
    replays against the eager prefill and steps, bit for bit: k/v, the
    fp32 state and the conv history; each pass records 16 ``tt_fused2``
    (3 SSD blocks × 2, the GQA block's 4, 2 MLPs × 3) and 6
    ``tt_fused2_experts``."""
    model, params = _jamba(cuda, weights)
    batch = _prompt(model, 5, B=2, S=20, T=48)
    tokens = torch.nn.functional.pad(batch["tokens"], (0, 12))
    graph = model.graphed_prefill(2, 32, 48)
    graph(params, tokens, 20)                       # the capture
    g_logits, g_cache = graph(params, tokens, 20)
    e_logits, e_cache = model.prefill(params, {
        "tokens": tokens, "cache_len": 48, "prompt_len": 20})
    assert torch.equal(g_logits, e_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                 tree_leaves(e_cache)))
    step = model.graphed_decode_step(2, 48)
    step.load(params, g_cache, 20)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(8):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    sfx = "_int8" if weights == "int8" else ""
    assert step.captured == {"tt_fused2" + sfx: 16,
                             "tt_fused2_experts" + sfx: 6}


@pytest.mark.parametrize("kw", [
    {}, dict(chunk_prefill=True, chunk_size=5, prefill_budget=10)],
    ids=["monolithic", "chunk5x2"])
def test_jamba_scheduler_graph_is_eager_and_paged_is_dense(cuda, kw):
    """Prompts of 20, 13 and 24 through 2 slots over 48 positions: the
    dense pool through the graphs against eager, and the paged pool (the
    GQA block's arenas, the SSD blocks' per-slot state) through the graphs
    and eagerly, tokens and logprobs bit for bit; the prefix cache stays
    off."""
    _slot_state_pools_agree(*_jamba(cuda), kw)


# seamless-m4t-large-v2's three fused2 shapes at rank 16 (self- and
# cross-attention q/k/v/o, gate/up, down), at decode, admission and one
# encoder pass of 4 × 1,024 frames
SEAMLESS_SHAPES = ((8, 128, 128, 8, 16), (8, 128, 1024, 8, 16),
                   (8, 1024, 128, 8, 16))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4, 256, 4096])
@pytest.mark.parametrize("dims", SEAMLESS_SHAPES,
                         ids=["attn", "gate_up", "down"])
def test_fused2_kernel_at_seamless_shapes(cuda, dims, B, act, int8):
    test_fused2_kernel_at_mamba2_shapes(cuda, dims, B, act, int8)


def _seamless(device, weights="fp32"):
    """seamless SMOKE (2 non-causal encoder blocks, 2 cross-attending
    decoder blocks, frames of width 32), TT on ffn+attn at rank 4,
    ``auto``."""
    cfg = get_config("seamless-m4t-large-v2", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


def _speech(model, seed, B, F):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randn((B, F, model.cfg.frontend_dim), generator=gen).to(
        device=model.device, dtype=torch.bfloat16)


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_seamless_prefill_and_decode_replays_are_eager(cuda, weights):
    """The captured prefill (a prompt of 20 in the 32 bucket, 12 frames)
    and 8 decode replays against the eager prefill and steps, bit for
    bit: k/v and the cross-attention's xk/xv; the prefill records 14 + 22
    ``tt_fused2`` (the encoder's 2 × 7, the decoder's 2 × 11), each decode
    step 18 (2 × 9)."""
    model, params = _seamless(cuda, weights)
    batch = _prompt(model, 5, B=2, S=20, T=48)
    frames = _speech(model, 6, 2, 12)
    tokens = torch.nn.functional.pad(batch["tokens"], (0, 12))
    graph = model.graphed_prefill(2, 32, 48, 12)
    graph(params, tokens, 20, frames)                  # the capture
    g_logits, g_cache = graph(params, tokens, 20, frames)
    e_logits, e_cache = model.prefill(params, {
        "tokens": tokens, "cache_len": 48, "prompt_len": 20,
        "speech_embeds": frames})
    assert torch.equal(g_logits, e_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                 tree_leaves(e_cache)))
    step = model.graphed_decode_step(2, 48, enc_T=12)
    step.load(params, g_cache, 20)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(8):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    sfx = "_int8" if weights == "int8" else ""
    assert graph.captured == {"tt_fused2" + sfx: 36}
    assert step.captured == {"tt_fused2" + sfx: 18}
    assert (2, 32, 48, 12) in model.prefill_graphs
    assert (2, 48, False, 12) in model.decode_graphs


def test_seamless_scheduler_graph_is_eager_and_paged_is_dense(cuda):
    """Prompts of 20, 13 and 24 with 12 frames each through 2 slots over 48
    positions: the dense pool through the graphs (built at the first
    admission) against eager, and the paged pool through the graphs and
    eagerly, tokens and logprobs bit for bit; another frame count is
    refused at ``submit``."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _seamless(cuda)
    prompts = [(_prompt(model, 90 + i, B=1, S=n)["tokens"],
                _speech(model, 90 + i, 1, 12))
               for i, n in enumerate((20, 13, 24))]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=48, **extra)
        for uid, (tokens, frames) in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={
                "tokens": tokens, "speech_embeds": frames},
                max_new_tokens=5))
            sched.step()
        with pytest.raises(ValueError, match="one frame count"):
            sched.submit(Request(uid=9, inputs={
                "tokens": prompts[0][0],
                "speech_embeds": _speech(model, 1, 1, 7)},
                max_new_tokens=5))
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
            assert not sched.prefix_cache
        return {f.uid: f for f in sched.finished}

    dense = run()
    for extra in (dict(graph=False), dict(paged=True, block_size=4),
                  dict(paged=True, block_size=4, graph=False)):
        got = run(**extra)
        assert sorted(got) == sorted(dense) == [0, 1, 2]
        for uid in got:
            assert np.array_equal(got[uid].tokens, dense[uid].tokens)
            assert np.array_equal(got[uid].logprobs, dense[uid].logprobs)


# internvl2-2b's four fused2 shapes at rank 16 (q/o, k/v, gate/up, down),
# at decode, an admission and the prefill of 4 × 2,048 rows
INTERNVL2_SHAPES = ((8, 256, 256, 8, 16), (8, 256, 128, 8, 16),
                    (8, 256, 1024, 8, 16), (8, 1024, 256, 8, 16))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [4, 256, 8192])
@pytest.mark.parametrize("dims", INTERNVL2_SHAPES,
                         ids=["q_o", "k_v", "gate_up", "down"])
def test_fused2_kernel_at_internvl2_shapes(cuda, dims, B, act, int8):
    test_fused2_kernel_at_mamba2_shapes(cuda, dims, B, act, int8)


def _internvl2(device, weights="fp32"):
    """internvl2 SMOKE (2 GQA blocks, image embeddings of width 32), TT on
    ffn+attn at rank 4, ``auto``."""
    cfg = get_config("internvl2-2b", "smoke", tt=TTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        backend="auto", weights=weights))
    model = build(cfg, device=device)
    params = model.init(0)
    if weights == "int8":
        params = model.quantize_params(params)
    return model, params


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_internvl2_prefill_and_decode_replays_are_eager(cuda, weights, n):
    """The captured prefill (``n`` image rows, then a prompt of 20 tokens
    in the 32 bucket) and 8 decode replays against the eager prefill and
    steps, bit for bit; the prefill's key carries the image rows, its
    cache is at n + 20, and each pass records 14 ``tt_fused2`` (2 × 7)."""
    model, params = _internvl2(cuda, weights)
    T = 176
    batch = _prompt(model, 5, B=2, S=20, T=T)
    images = _speech(model, 6, 2, n)
    tokens = torch.nn.functional.pad(batch["tokens"], (0, 12))
    graph = model.graphed_prefill(2, 32, T, n)
    graph(params, tokens, n + 20, images)              # the capture
    g_logits, g_cache = graph(params, tokens, n + 20, images)
    e_logits, e_cache = model.prefill(params, {
        "tokens": tokens, "cache_len": T, "prompt_len": n + 20,
        "image_embeds": images})
    assert torch.equal(g_logits, e_logits)
    assert int(g_cache["pos"]) == n + 20
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                                 tree_leaves(e_cache)))
    step = model.graphed_decode_step(2, T)
    step.load(params, g_cache, n + 20)
    tok = e_logits[:, -1].argmax(-1, keepdim=True)
    for t in range(8):
        want, e_cache = model.decode_step(params, e_cache, tok)
        got = step(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {t}"
        tok = want[:, -1].argmax(-1, keepdim=True)
    sfx = "_int8" if weights == "int8" else ""
    assert graph.captured == step.captured == {"tt_fused2" + sfx: 14}
    assert (2, 32, T, n) in model.prefill_graphs
    assert list(model.prefill_caches) == [(2, T)]


def test_internvl2_scheduler_graph_is_eager_and_paged_is_dense(cuda):
    """Prompts of 20, 13 and 24 tokens after 8, 5 and 16 image rows
    through 2 slots over 56 positions: the dense pool through the graphs
    against eager, and the paged pool through the graphs and eagerly,
    tokens and logprobs bit for bit; every request's prompt length counts
    its image rows."""
    from repro_torch.serving.scheduler import Request, Scheduler
    model, params = _internvl2(cuda)
    prompts = [(_prompt(model, 90 + i, B=1, S=s)["tokens"],
                _speech(model, 90 + i, 1, n))
               for i, (s, n) in enumerate(((20, 8), (13, 5), (24, 16)))]

    def run(**extra):
        sched = Scheduler(model, params, num_slots=2, cache_len=56, **extra)
        for uid, (tokens, images) in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={
                "tokens": tokens, "image_embeds": images},
                max_new_tokens=5))
            sched.step()
        sched.run()
        if sched.paged:
            sched.allocator.assert_quiescent()
            assert not sched.prefix_cache
        return {f.uid: f for f in sched.finished}

    dense = run()
    assert [dense[u].prompt_len for u in range(3)] == [28, 18, 40]
    for extra in (dict(graph=False), dict(paged=True, block_size=4),
                  dict(paged=True, block_size=4, graph=False)):
        got = run(**extra)
        assert sorted(got) == sorted(dense) == [0, 1, 2]
        for uid in got:
            assert np.array_equal(got[uid].tokens, dense[uid].tokens)
            assert np.array_equal(got[uid].logprobs, dense[uid].logprobs)


# ------------------------------------------------------------- the lifecycle
def _life_requests(model, n=4, S=8, steps=6):
    from repro_torch.serving.scheduler import Request
    return [Request(uid=u, inputs={"tokens": _prompt(
        model, 120 + u, B=1, S=S)["tokens"]}, max_new_tokens=steps)
        for u in range(n)]


def test_bind_refuses_a_live_holder_until_it_closes(cuda):
    """A scheduler with active rows holds its slot-pool graph: a second
    scheduler of the same geometry cannot bind it; once the first closes
    (``Scheduler.close``, a dead holder's release) it can, and the closed
    one steps no more."""
    from repro_torch.serving.scheduler import Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    a = Scheduler(model, params, num_slots=2, cache_len=16)
    a.submit(_life_requests(model, 1)[0])
    a.step()
    assert a.num_active == 1 and a.graph.holder() is a
    with pytest.raises(RuntimeError, match="1 active rows"):
        Scheduler(model, params, num_slots=2, cache_len=16)
    a.close()
    b = Scheduler(model, params, num_slots=2, cache_len=16)
    assert b.graph is a.graph and b.graph.holder() is b
    assert model.graph_captures == 1                 # taken over, no capture
    with pytest.raises(RuntimeError, match="closed"):
        a.step()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_resize_binds_the_new_geometry_and_matches_eager(cuda, paged):
    """A grow (2 → 3 slots; paged also 8 → 12 blocks) mid-stream binds
    the slot-pool graph of the new key (one capture over zeros), copies the
    pool into it and releases the old one; a shrink back lands once the
    tail drained, binding the first graph again (no capture).  Every token
    and logprob is the eager scheduler's, bit for bit."""
    from repro_torch.serving.scheduler import Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    kw = dict(paged=True, block_size=4, num_blocks=8) if paged else {}
    out = {}
    for graph in (True, False):
        sched = Scheduler(model, params, num_slots=2, cache_len=16,
                          graph=graph, **kw)
        reqs = _life_requests(model, 4)
        sched.submit(reqs[0])
        sched.step()
        first = sched.graph
        sched.resize(3, 12 if paged else None)
        if graph:
            assert sched.graph is not first and first.holder() is None
            assert sched.graph.B == 3 and model.graph_captures == 2
        for r in reqs[1:]:
            sched.submit(r)
        sched.step()
        sched.resize(2, 8 if paged else None)    # lands once drained
        sched.run()
        assert sched.num_slots == 2
        if graph:
            assert sched.graph is first and model.graph_captures == 2
        if paged:
            sched.allocator.assert_quiescent()
        out[graph] = {f.uid: f for f in sched.finished}
        sched.close()
    assert sorted(out[True]) == sorted(out[False]) == [0, 1, 2, 3]
    for u, f in out[True].items():
        assert np.array_equal(f.tokens, out[False][u].tokens)
        assert np.array_equal(f.logprobs, out[False][u].logprobs)


def test_from_snapshot_binds_without_capture_and_continues(cuda):
    """A snapshot mid-stream (paged, generators of sampled requests
    included), the scheduler closed, ``from_snapshot`` on the card: it
    binds the same graph (no capture), restores the pool and the host
    positions, and the streams end as an uninterrupted run's, bit for
    bit."""
    import dataclasses
    from repro_torch.serving import faults
    from repro_torch.serving.scheduler import Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    reqs = [dataclasses.replace(r, temperature=0.8)
            for r in _life_requests(model, 3)]
    kw = dict(num_slots=2, cache_len=16, paged=True, block_size=4, seed=5)
    ref = Scheduler(model, params, **kw)
    for r in reqs:
        ref.submit(r)
    want = ref.run()
    ref.close()
    clk = {"t": 0.0}
    sched = Scheduler(model, params, clock=faults.step_clock(clk), **kw)
    for r in reqs:
        sched.submit(r)
    for _ in range(3):
        clk["t"] += 1
        sched.step()
    snap = sched.snapshot()
    sched.close()
    captures = model.graph_captures
    back = Scheduler.from_snapshot(model, params, snap,
                                   clock=faults.step_clock(clk))
    assert back.graph is sched.graph and model.graph_captures == captures
    assert back.graph.pos.tolist() == snap["cache"]["pos"].tolist()
    got = back.run()
    got.update({f.uid: f for f in back.finished})
    for u, f in want.items():
        assert np.array_equal(got[u].tokens, f.tokens)
        assert np.array_equal(got[u].logprobs, f.logprobs)
    back.allocator.assert_quiescent()


def test_bound_graph_evicted_from_the_lru_stays_alive(cuda):
    """``GRAPH_CACHE_SIZE`` decode graphs of other keys push the bound
    slot-pool graph out of the model's LRU; the scheduler still holds it
    and keeps replaying it."""
    from repro_torch.models.model import GRAPH_CACHE_SIZE
    from repro_torch.serving.scheduler import Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    sched = Scheduler(model, params, num_slots=2, cache_len=16)
    reqs = _life_requests(model, 2)
    sched.submit(reqs[0])
    sched.step()
    graph = sched.graph
    for B in range(3, 3 + GRAPH_CACHE_SIZE):
        model.graphed_decode_step(B, 16, masked=True)
    assert graph not in model.decode_graphs.values()
    sched.submit(reqs[1])
    out = sched.run()
    assert sched.graph is graph and graph.holder() is sched
    assert sorted(out) == [0, 1] and all(len(f.tokens) == 6
                                         for f in out.values())


@pytest.mark.parametrize("pool", ["dense", "paged", "chunked"])
def test_fault_drill_graph_is_eager_bit_for_bit(cuda, pool):
    """``serve.fault_smoke`` on SMOKE (seed 5: a preemption in every pool)
    through the graphs and eagerly: the same finished requests, tokens
    and logprobs; survivors identical to the uninterrupted run (asserted
    inside); the restart captures nothing."""
    from repro_torch.launch import serve
    argv = ["--variant", "smoke", "--tt", "ffn,attn", "--tt-rank", "4",
            "--tt-backend", "auto", "--slots", "2", "--max-requests", "6",
            "--prompt-len", "8", "--steps", "6", "--seed", "5"] + {
        "dense": [], "paged": ["--paged", "--block-size", "4"],
        "chunked": ["--paged", "--block-size", "4", "--chunk-prefill",
                    "--chunk-size", "3"]}[pool]
    args = serve.parse_args(argv)
    model, params = serve.setup(args)
    g = serve.fault_smoke(model, params, args)["report"]
    e = serve.fault_smoke(model, params, args, graph=False)["report"]
    assert g.rebuild_captures == 0 and g.restarts == 1
    assert g.preemptions >= 1 and len(g.resize_s) == 1
    assert sorted(g.finished) == sorted(e.finished)
    for u, f in g.finished.items():
        assert f.finish_reason == e.finished[u].finish_reason
        assert np.array_equal(f.tokens, e.finished[u].tokens)
        assert np.array_equal(f.logprobs, e.finished[u].logprobs)


# ---------------------------------------------------------- the streaming
STREAM_POOLS = {"dense": {}, "paged": dict(paged=True, block_size=4),
                "chunked": dict(paged=True, block_size=4,
                                chunk_prefill=True, chunk_size=3)}


def _host_requests(model, n, S=8, steps=6):
    """``_life_requests`` with the prompts on the host, as a server hands
    them to ``StreamEngine.submit``."""
    from repro_torch.serving.scheduler import Request
    return [Request(uid=u, inputs={"tokens": _prompt(
        model, 120 + u, B=1, S=S)["tokens"].cpu()}, max_new_tokens=steps)
        for u in range(n)]


@pytest.mark.parametrize("pool", list(STREAM_POOLS))
def test_stream_engine_over_graphs_is_the_scheduler(cuda, pool):
    """``StreamEngine`` over the captured graphs (its loop thread binds
    and replays them, the admissions move host prompts to the card) gives
    the synchronous scheduler's tokens and logprobs over the same graphs,
    bit for bit, and its events are those results."""
    from repro_torch.serving.engine import StreamEngine
    from repro_torch.serving.scheduler import Scheduler
    model, params = _smoke("fused2", "fp32", cuda)
    kw = dict(num_slots=2, cache_len=16, **STREAM_POOLS[pool])
    sync = Scheduler(model, params, **kw)
    for r in _host_requests(model, 4):
        sync.submit(r)
    want = sync.run()
    sync.close()
    captures = model.graph_captures
    eng = StreamEngine(Scheduler(model, params, **kw))
    try:
        for r in _host_requests(model, 4):
            eng.submit(r)
        for u, f in want.items():
            got = eng.result(u, timeout=120)
            assert np.array_equal(got.tokens, f.tokens)
            assert np.array_equal(got.logprobs, f.logprobs)
            evs = list(eng.stream(u, timeout=120))[:-1]
            assert [e["token"] for e in evs] == f.tokens.tolist()
    finally:
        eng.close(timeout=120)
    assert model.graph_captures == captures       # the same decode graph


def test_capture_while_a_client_streams(cuda):
    """A prompt of a new bucket arrives while another request streams over
    HTTP: the loop thread captures its prefill while the first handler
    thread writes events, the capture succeeds, and both streams are the
    synchronous scheduler's."""
    import http.client
    import json
    import threading
    from repro_torch.launch.serve import sse_events
    from repro_torch.serving.engine import StreamEngine
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.serving.server import make_server
    model, params = _smoke("fused2", "fp32", cuda)
    kw = dict(num_slots=2, cache_len=32)
    long = _prompt(model, 7, B=1, S=8)["tokens"].cpu()
    other = _prompt(model, 8, B=1, S=13)["tokens"].cpu()   # bucket 16
    eng = StreamEngine(Scheduler(model, params, **kw))
    srv = make_server(eng)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    outs = {0: [], 1: []}
    started = threading.Event()

    def client(uid, toks, steps):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/generate", json.dumps(
            {"tokens": toks.tolist(), "max_new_tokens": steps, "uid": uid}))
        for ev in sse_events(c.getresponse()):
            outs[uid].append(ev)
            started.set()
            if "done" in ev or "error" in ev:
                break
        c.close()

    try:
        builds = model.prefill_builds
        a = threading.Thread(target=client, args=(0, long, 20))
        a.start()
        assert started.wait(120)
        b = threading.Thread(target=client, args=(1, other, 6))
        b.start()
        # /stats from a handler thread while the loop may be capturing
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("GET", "/stats")
        assert json.loads(c.getresponse().read())["kv_pool_bytes"] > 0
        c.close()
        for t in (a, b):
            t.join(120)
            assert not t.is_alive()
        assert model.prefill_builds > builds     # the new bucket captured
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close(timeout=120)
    sync = Scheduler(model, params, **kw)
    for uid, toks, steps in ((0, long, 20), (1, other, 6)):
        sync.submit(Request(uid=uid, inputs={"tokens": toks},
                            max_new_tokens=steps))
    want = sync.run()
    sync.close()
    for uid, evs in outs.items():
        assert evs[-1].get("done") == "length", evs[-1]
        assert [e["token"] for e in evs[:-1]] == want[uid].tokens.tolist()
