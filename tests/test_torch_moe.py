"""The port's mixture-of-experts FFN (``models/moe.py``) and its stacked
expert projections on the CPU against the reference (``repro.models.moe``,
``repro.models.layers``), and the expert-batched fused2 kernel's plain
version and launch.

- ``dispatch_positions``: the integers bit for bit, with and without
  overflow; ``capacity`` at the token counts the serving paths give it.
- ``moe_apply`` on mixtral SMOKE's first expert layer (TT experts at rank
  4, the reference's weights through ``convert.from_jax_params``): the
  routing identical first (tokens drawn where every k-th and (k+1)-th
  router probabilities lie more than 10× the tolerance apart), then the
  output within 1e-5 in fp32, dropless (SMOKE's capacity factor of 16),
  with drops (capacity factor 0.25: the same assignments dropped, counted
  on the device), with int8 experts and with a shared expert; einsum
  and the fused2 plain path agree.
- A router whose columns tie exactly picks the reference's experts (the
  lower index first, ``jax.lax.top_k``'s order).
- The combine gives identical bits over repeated calls.
- The expert-batched fused2 plain version against per-expert
  ``tt_fused2_ref`` (bit for bit) and the reference's Pallas kernels under
  ``vmap`` in interpret mode (fp32 within 1e-5), fp and int8; the
  wrapper's argument checks (the launch's arguments and geometry are in
  ``tests/test_torch_fused2.py``).
- ``quantize_tt_params`` on stacked ``[E, ...]`` cores: codes and scales
  bit for bit, each expert on its own scales; ``convert`` takes the
  reference's ``[L, E, d]`` scales.
- ``tt_forward`` over an experts axis: einsum and fused2 agree, and the
  chain and step backends raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.core.packing import pack_core as jpack
from repro.kernels.tt_contract import tt_fused2_int8_pallas, tt_fused2_pallas
from repro.models import moe as jmoe
from repro.models.layers import quantize_tt_params as jquantize
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.packing import pack_core
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import ref, tt_contract
from repro_torch.kernels.ops import tt_forward
from repro_torch.models import moe
from repro_torch.models.layers import quantize_tt_params

TOL = 1e-5


def _tt(cls, weights="fp32"):
    return cls(enabled=True, families=("ffn", "attn"), rank=4,
               min_factor=2, backend="auto", weights=weights)


_built: dict = {}


def _layer(weights="fp32", **moe_kw):
    """(reference cfg, its first MoE block's params, port cfg, its params)
    of mixtral SMOKE with the MoEConfig fields ``moe_kw`` replaced."""
    key = (weights, tuple(sorted(moe_kw.items())))
    if key not in _built:
        cfgs = []
        for get, cls in ((jget_config, JTTConfig), (tget_config, TTTConfig)):
            cfg = get("mixtral_8x7b", "smoke", tt=_tt(cls, weights))
            cfgs.append(dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe_kw)))
        jm = jbuild(cfgs[0])
        jp = jm.init(jax.random.PRNGKey(0))
        if weights == "int8":
            jp = jm.quantize_params(jp)
        tm = tbuild(cfgs[1], device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[key] = (cfgs[0], jm, jax.tree.map(lambda a: a[0],
                                                 jp["g0"]["b0"]["ffn"]),
                       cfgs[1], tm, tp["g0"][0]["b0"]["ffn"])
    return _built[key]


def _x(B, S, seed, d=64):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _ref_routing(jp, jcfg, x):
    """The reference's router on ``x``: (probs [T, E], expert ids [T, k])."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), -1)
    _, eidx = jax.lax.top_k(probs, jcfg.moe.top_k)
    return np.asarray(probs), np.asarray(eidx)


def _assert_clear_routing(probs, k):
    """Every token's k-th and (k+1)-th probabilities more than 10× the
    tolerance apart, so summation order cannot flip a choice."""
    top = np.sort(probs.astype(np.float64), -1)[:, ::-1]
    gap = (top[:, k - 1] - top[:, k]).min()
    assert gap > 10 * TOL, gap


# --------------------------------------------------------------------------
# Dispatch and capacity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Tk,E,seed", [(1, 4, 0), (16, 8, 1), (64, 4, 2),
                                       (1024, 8, 3), (4096, 8, 4)])
def test_dispatch_positions_are_the_references(Tk, E, seed):
    e = np.random.default_rng(seed).integers(0, E, Tk).astype(np.int32)
    want = np.asarray(jmoe.dispatch_positions(jnp.asarray(e), E))
    got = moe.dispatch_positions(torch.from_numpy(e).long(), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_positions_of_one_crowded_expert():
    """Every assignment on expert 2: positions 0 .. Tk-1 in flat order."""
    e = torch.full((37,), 2)
    assert moe.dispatch_positions(e, 4).tolist() == list(range(37))


@pytest.mark.parametrize("T,cf,want", [
    (4, 1.25, 8),          # full-width decode: 4 tokens
    (64, 1.25, 20),        # a 64-token chunk: 16 expected per expert
    (2048, 1.25, 640),     # the 4 × 512 prefill, a multiple of 128
    (256, 1.25, 128),      # a one-row admission at the 256 bucket
    (127, 1.25, 40),       # below 128 tokens: no rounding to 128
    (24, 16.0, 192),       # SMOKE (4 experts)
])
def test_capacity_is_the_references_rule(T, cf, want):
    E = 4 if cf == 16.0 else 8
    m = dataclasses.replace(tget_config("mixtral_8x7b", "full").moe,
                            capacity_factor=cf, num_experts=E)
    assert moe.capacity(m, T) == want
    C = int(np.ceil(m.top_k * T / m.num_experts * m.capacity_factor))
    assert want == (max(-(-C // 128) * 128, 8) if T >= 128 else max(C, 8))


# --------------------------------------------------------------------------
# moe_apply against the reference's
# --------------------------------------------------------------------------

# (label, weights, MoEConfig fields, (B, S), seed): seeds chosen so that
# every token's routing is clear of ties (asserted)
APPLY = [
    ("dropless", "fp32", {}, (2, 12), 0),
    ("dropless-one-row", "fp32", {}, (1, 40), 1),
    ("drops", "fp32", {"capacity_factor": 0.25}, (2, 12), 0),
    ("drops-long", "fp32", {"capacity_factor": 0.25}, (1, 100), 3),
    ("int8", "int8", {}, (2, 12), 0),
    ("int8-drops", "int8", {"capacity_factor": 0.25}, (2, 12), 0),
    ("shared", "fp32", {"num_shared": 1, "shared_ff": 96}, (2, 12), 0),
]


@pytest.mark.parametrize("label,weights,moe_kw,shape,seed", APPLY,
                         ids=[a[0] for a in APPLY])
def test_moe_apply_is_the_references(label, weights, moe_kw, shape, seed):
    jcfg, jm, jp, tcfg, tm, tp = _layer(weights, **moe_kw)
    x = _x(*shape, seed)
    probs, eidx = _ref_routing(jp, jcfg, x)
    _assert_clear_routing(probs, jcfg.moe.top_k)
    gate, got_idx = moe.route(tp, tcfg, torch.from_numpy(x).reshape(
        -1, x.shape[-1]))
    np.testing.assert_array_equal(got_idx.numpy(), eidx)
    want = np.asarray(jmoe.moe_apply(jp, jcfg, jnp.asarray(x), jm.plan_book))
    T, k = shape[0] * shape[1], jcfg.moe.top_k
    pos = np.asarray(jmoe.dispatch_positions(jnp.asarray(eidx.reshape(-1)),
                                             jcfg.moe.num_experts))
    dropped = int((pos >= moe.capacity(tcfg.moe, T)).sum())
    assert (dropped > 0) == ("drops" in label), dropped
    moe.reset_drops()
    for plans in (tm.plan_book, "einsum"):
        got = moe.moe_apply(tp, tcfg, torch.from_numpy(x), plans)
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=str(plans))
    assert moe.read_drops() == 2 * dropped
    assert tm.plan_book.backend == "auto"


def test_dropped_tokens_keep_only_their_other_experts():
    """With a capacity of 8 and every token on experts 0 and 1 (the router
    favours them), tokens past the 8th get nothing from either: their
    output is exactly zero (no shared expert)."""
    jcfg, jm, jp, tcfg, tm, tp = _layer("fp32", capacity_factor=0.25)
    p = dict(tp)
    router = torch.zeros_like(tp["router"])
    router[:, 0], router[:, 1] = 1.0, 0.5
    p["router"] = router
    x = torch.from_numpy(np.abs(_x(1, 12, 5)))
    y = moe.moe_apply(p, tcfg, x, tm.plan_book)[0]
    assert moe.capacity(tcfg.moe, 12) == 8
    assert y[:8].abs().sum(-1).min() > 0
    assert torch.equal(y[8:], torch.zeros_like(y[8:]))
    jy = np.asarray(jmoe.moe_apply(dict(jp, router=jnp.asarray(
        router.numpy())), jcfg, jnp.asarray(x.numpy()), jm.plan_book))[0]
    np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)


def test_tied_router_picks_the_references_experts():
    """Router columns 1, 2 and 3 equal (exact ties among them): the stable
    descending sort takes the lower index, as ``jax.lax.top_k`` does, and
    the whole layer then matches the reference's."""
    jcfg, jm, jp, tcfg, tm, tp = _layer("fp32")
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 3] = router[:, 1]
    x = _x(2, 12, 7)
    probs, eidx = _ref_routing(dict(jp, router=jnp.asarray(router)), jcfg, x)
    assert (probs[:, 1] == probs[:, 2]).all()
    p = dict(tp, router=torch.from_numpy(router))
    _, got = moe.route(p, tcfg, torch.from_numpy(x).reshape(-1, 64))
    np.testing.assert_array_equal(got.numpy(), eidx)
    # ties are real here: some token's two picks are among 1, 2, 3
    assert ((eidx >= 1).all(-1)).any()
    want = np.asarray(jmoe.moe_apply(dict(jp, router=jnp.asarray(router)),
                                     jcfg, jnp.asarray(x), jm.plan_book))
    got = moe.moe_apply(p, tcfg, torch.from_numpy(x), tm.plan_book)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("probs", [
    [[0.25, 0.25, 0.25, 0.25]],
    [[0.1, 0.3, 0.3, 0.3], [0.3, 0.3, 0.1, 0.3]],
    [[0.5, 0.2, 0.2, 0.1]],
])
def test_top_k_orders_ties_as_jax_does(probs):
    p = np.asarray(probs, np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(p), 2)
    gv, gi = moe.top_k(torch.from_numpy(p), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("moe_kw", [{}, {"capacity_factor": 0.25}],
                         ids=["dropless", "drops"])
def test_combine_gives_identical_bits_every_call(moe_kw):
    _, _, _, tcfg, tm, tp = _layer("fp32", **moe_kw)
    x = torch.from_numpy(_x(2, 12, 0))
    first = moe.moe_apply(tp, tcfg, x, tm.plan_book)
    for _ in range(3):
        assert torch.equal(moe.moe_apply(tp, tcfg, x, tm.plan_book), first)


def test_bf16_moe_apply_is_close_to_the_references():
    """bf16 parameters and activations: within 2e-2 of the largest |y|."""
    jcfg, jm, jp, tcfg, tm, tp = _layer("fp32")
    x = _x(2, 12, 0)
    jpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    want = np.asarray(jmoe.moe_apply(jpb, jcfg, jnp.asarray(
        x, jnp.bfloat16), jm.plan_book).astype(jnp.float32))
    tpb = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)
                                                  ).to(torch.bfloat16), jpb)
    got = moe.moe_apply(tpb, tcfg, torch.from_numpy(x).to(torch.bfloat16),
                        tm.plan_book)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


# --------------------------------------------------------------------------
# The expert-batched fused2 kernel's plain version and launch
# --------------------------------------------------------------------------

def _expert_inputs(E, C, dims, seed):
    n1, n2, m1, m2, r1 = dims
    rng = np.random.default_rng(seed)
    G1 = rng.standard_normal((E, 1, n1, m1, r1)).astype(np.float32) * 0.3
    G2 = rng.standard_normal((E, r1, n2, m2, 1)).astype(np.float32) * 0.3
    x = rng.standard_normal((E, C, n1 * n2)).astype(np.float32)
    return G1, G2, x


EXPERT_CASES = [(4, 8, (2, 8, 4, 2, 3)), (8, 5, (2, 86, 43, 2, 4)),
                (3, 37, (4, 16, 8, 4, 16))]


@pytest.mark.parametrize("E,C,dims", EXPERT_CASES)
def test_expert_fused2_plain_is_per_expert_fused2(E, C, dims):
    G1, G2, x = _expert_inputs(E, C, dims, 0)
    p2, p1 = pack_core(torch.from_numpy(G2)), pack_core(torch.from_numpy(G1))
    got = tt_contract.tt_fused2_experts(torch.from_numpy(x), p2, p1, dims)
    assert got.shape == (E, C, dims[2] * dims[3])
    for e in range(E):
        assert torch.equal(got[e], ref.tt_fused2_ref(
            torch.from_numpy(x[e]), p2[e], p1[e], dims))
    assert tt_contract.launch_counts() == {}           # the CPU counts none


@pytest.mark.parametrize("E,C,dims", EXPERT_CASES)
def test_expert_fused2_plain_matches_vmapped_pallas(E, C, dims):
    G1, G2, x = _expert_inputs(E, C, dims, 1)
    pallas = jax.vmap(lambda xe, a, b: tt_fused2_pallas(
        xe, a, b, dims=dims, interpret=True))
    want = np.asarray(pallas(jnp.asarray(x), jax.vmap(jpack)(jnp.asarray(
        G2)), jax.vmap(jpack)(jnp.asarray(G1))))
    got = tt_contract.tt_fused2_experts(
        torch.from_numpy(x), pack_core(torch.from_numpy(G2)),
        pack_core(torch.from_numpy(G1)), dims)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("E,C,dims", EXPERT_CASES)
def test_expert_fused2_int8_plain_matches_vmapped_pallas(E, C, dims):
    G1, G2, x = _expert_inputs(E, C, dims, 2)
    q1, s1 = quantize_tt_params({"tt": {"c0": torch.from_numpy(G1)}})[
        "tt"].values()
    q2, s2 = quantize_tt_params({"tt": {"c0": torch.from_numpy(G2)}})[
        "tt"].values()
    p2, p1 = pack_core(q2), pack_core(q1)
    scales = torch.stack([s2[:, 0], s1[:, 0]], -1).contiguous()
    pallas = jax.vmap(lambda xe, a, b, s: tt_fused2_int8_pallas(
        xe, a, b, [s[0], s[1]], dims, interpret=True))
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(p2.numpy()),
                             jnp.asarray(p1.numpy()),
                             jnp.asarray(scales.numpy())))
    got = tt_contract.tt_fused2_experts_int8(torch.from_numpy(x), p2, p1,
                                             scales, dims)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for e in range(E):
        assert torch.equal(got[e], ref.tt_fused2_ref(
            torch.from_numpy(x[e]), p2[e], p1[e], dims, scales[e]))


def test_expert_wrapper_rejects_bad_arguments():
    dims = (2, 8, 4, 2, 3)
    x = torch.zeros(4, 3, 16)
    p2, p1 = torch.zeros(4, 8, 6), torch.zeros(4, 6, 4)
    with pytest.raises(ValueError):                      # 2-D x
        tt_contract.tt_fused2_experts(x[0], p2, p1, dims)
    with pytest.raises(ValueError):                      # expert count
        tt_contract.tt_fused2_experts(x, p2[:3].contiguous(), p1, dims)
    with pytest.raises(ValueError):                      # a plain core
        tt_contract.tt_fused2_experts(x, p2[0], p1, dims)
    with pytest.raises(TypeError):                       # core dtype
        tt_contract.tt_fused2_experts(x, p2.to(torch.bfloat16), p1, dims)
    q2, q1 = p2.to(torch.int8), p1.to(torch.int8)
    with pytest.raises(ValueError):                      # one scale pair
        tt_contract.tt_fused2_experts_int8(x, q2, q1, torch.ones(2), dims)
    with pytest.raises(ValueError):                      # [2, E]
        tt_contract.tt_fused2_experts_int8(x, q2, q1, torch.ones(2, 4),
                                           dims)
    with pytest.raises(ValueError):                      # the plain wrapper
        tt_contract.tt_fused2(x, p2, p1, dims)
    assert tt_contract.tt_fused2_experts_int8(
        x, q2, q1, torch.ones(4, 2), dims).shape == (4, 3, 8)


# --------------------------------------------------------------------------
# Quantization, conversion and tt_forward over an experts axis
# --------------------------------------------------------------------------

def test_quantize_stacked_cores_is_the_references():
    """Codes and scales ``[E, d]`` of a stacked expert bundle bit for bit,
    each expert on its own scale (one expert all zero: scale 1)."""
    rng = np.random.default_rng(4)
    cores = {"c0": rng.standard_normal((4, 1, 2, 8, 3)).astype(np.float32),
             "c1": rng.standard_normal((4, 3, 8, 2, 1)).astype(np.float32)}
    cores["c1"][2] = 0.0
    want = jquantize({"w": {"tt": jax.tree.map(jnp.asarray, cores)}})["w"][
        "tt"]
    got = quantize_tt_params({"w": {"tt": {k: torch.from_numpy(v)
                                           for k, v in cores.items()}}})[
        "w"]["tt"]
    assert set(got) == set(want) == {"c0", "c1", "scales"}
    assert got["scales"].shape == (4, 2) and got["c0"].dtype == torch.int8
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert float(got["scales"][2, 1]) == 1.0


def test_converted_int8_experts_carry_layer_and_expert_scales():
    """mixtral SMOKE quantized by the reference: every expert bundle's
    scales arrive as ``[E, d]`` per layer, the router as ``[d, E]``, and
    the codes bit for bit."""
    _, jm, _, _, tm, _ = _layer("int8")
    jp = jm.quantize_params(jm.init(jax.random.PRNGKey(0)))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    gate = tp["g0"][1]["b0"]["ffn"]["experts"]["gate"]["tt"]
    assert gate["scales"].shape == (4, 2)
    assert gate["c0"].shape[0] == 4 and gate["c0"].dtype == torch.int8
    np.testing.assert_array_equal(
        gate["scales"].numpy(),
        np.asarray(jp["g0"]["b0"]["ffn"]["experts"]["gate"]["tt"][
            "scales"][1]))
    assert tp["g0"][0]["b0"]["ffn"]["router"].shape == (64, 4)


def test_expert_plans_key_on_the_trailing_core_shape():
    """Priming resolves one plan per distinct trailing [r0, n, m, r1]
    chain: the expert stacks add nothing beyond their per-expert shapes,
    and a lookup of a stacked core list is a dict hit."""
    _, _, _, _, tm, tp = _layer("fp32")
    book = tm.plan_book
    before = tplan.plan_resolutions()
    cores = [tp["experts"]["gate"]["tt"][f"c{t}"] for t in range(2)]
    plan = book.plan_for_cores(cores)
    assert plan.backend == "cuda_fused2"
    assert plan is book.plan_for_cores([c[0] for c in cores])
    assert tplan.plan_resolutions() == before


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_tt_forward_over_experts_einsum_and_fused2_agree(weights):
    _, _, _, _, tm, tp = _layer(weights)
    bundle = tp["experts"]["down"]["tt"]
    cores = [bundle["c0"], bundle["c1"]]
    scales = bundle.get("scales")
    x = torch.from_numpy(_x(4, 6, 9, d=128))
    ns, ms, ranks = tplan.chain_signature([c.shape for c in cores])
    w = "int8" if weights == "int8" else None
    a = tt_forward(cores, x, plan=tplan.resolve_plan(
        ns, ms, ranks, backend="einsum", weights=w), scales=scales)
    b = tt_forward(cores, x, plan=tplan.resolve_plan(
        ns, ms, ranks, backend="cuda_fused2", weights=w), scales=scales)
    assert a.shape == b.shape == (4, 6, 64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    for e in range(4):                 # expert e through its own cores
        one = tt_forward([c[e] for c in cores], x[e], plan=tplan.resolve_plan(
            ns, ms, ranks, backend="einsum", weights=w),
            scales=None if scales is None else scales[e])
        np.testing.assert_allclose(a[e].numpy(), one.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda_step"])
def test_chain_and_step_backends_refuse_an_experts_axis(backend):
    _, _, _, _, tm, tp = _layer("fp32")
    cores = [tp["experts"]["up"]["tt"][f"c{t}"] for t in range(2)]
    ns, ms, ranks = tplan.chain_signature([c.shape for c in cores])
    plan = tplan.resolve_plan(ns, ms, ranks, backend=backend)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tt_forward(cores, torch.zeros(4, 3, 64), plan=plan)
