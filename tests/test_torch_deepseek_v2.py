"""deepseek-v2-lite-16b (multi-head latent attention, a dense first layer,
then a mixture of experts with shared experts) and qwen3-32b (a dense
qk-norm decoder) on the CPU against the reference.

SMOKE through both packages, the reference's weights carried into the
port by ``convert.from_jax_params`` and the tokens drawn with numpy from a
seed; the reference's Pallas kernels run in interpret mode.  deepseek-v2
SMOKE runs with TT on ``ffn`` (the reference's SMOKE) and on ``ffn,attn``
(q and o through TT; ``kv_down``/``kv_up`` stay dense), ``auto`` backend.
Its capacity factor of 16 keeps it dropless, so every identity is
asserted with no condition; the drop counter must read 0.

- The registry: FULL is two groups, one MLA block with the dense
  ``first_dense_ff`` MLP and 26 MLA blocks with 64 experts top-6 and 2
  shared; prefix reuse and chunked prefill on; latent caches and arenas
  of [.., kv_lora] and [.., rope_hd]; FULL's converted spec shapes
  against the reference's ``abstract_params`` (meta tensors), and
  qwen3-32b's.
- Each MLA function against the reference's on SMOKE's first layer:
  the expanded prefill, the absorbed decode at a scalar and a per-row
  position with an active mask, the paged decode, the chunk and the
  resume (copy on write): outputs and latent caches within 1e-5.
- Prefill exact and bucketed (logits within 1e-4, latent caches within
  1e-5) and 16 greedy decode steps (tokens identical, the reference's
  top-1/top-2 gap over ten times the tolerance), fp32 and int8 cores,
  bf16 parameters within 2e-2 × the largest |logit| (prefill; one prompt
  row whose routing is clear at bf16's resolution).  Before any output is
  compared, every MoE call's routing on the port's hidden states is the
  reference router's, with the k-th and (k+1)-th probabilities more than
  ten times the tolerance apart (bf16: twice 2^-9).
- The schedulers, dense, paged and chunked, on a staggered schedule and
  on shared-prefix and full-cover schedules (prefix hits, a copy on
  write) against the reference's ``Scheduler``: tokens identical,
  logprobs within 1e-4, slots, block ids and counters equal, no drop;
  within the port paged ≡ dense bit for bit, chunked ≡ monolithic and
  prefix hit ≡ fresh prefill to the tolerance (the absorbed form against
  the expanded one).
- qwen3-32b SMOKE: prefill and 16 decode steps, fp32 and int8 cores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.models import attention as jattn
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.configs import PENDING, PORTED
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import moe
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.engine import generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logits and logprobs, port against the reference
TOL_CACHE = 1e-5    # latent caches, and one attention call's output
TOL_ROUTE = 1e-5    # router probabilities
TOL_BF16 = 2e-2     # × the largest |logit|, bf16 parameters
# bf16 parameters: router probabilities round to 2^-9 near 0.5, so a
# routing decision is clear at twice that; one prompt row, drawn from a
# seed per TT coverage where every token's is at both lengths (top-2 of 4
# experts over 24 or 20 tokens: most seeds have a pair within 2^-9, where
# the two packages' bf16 roundings can pick different experts)
TOL_ROUTE_BF16 = 2 ** -9
BF16_SEED = {"ffn": 4, "ffn,attn": 33}
ARCH = "deepseek_v2_lite_16b"
VARIANTS = {"fp32": ("fp32", "float32"), "int8": ("int8", "float32"),
            "bf16": ("fp32", "bfloat16")}
FAMILIES = {"ffn": ("ffn",), "ffn,attn": ("ffn", "attn")}


def _tt(cls, weights="fp32", families=("ffn", "attn"), rank=4,
        min_factor=2):
    return cls(enabled=True, families=families, rank=rank,
               min_factor=min_factor, backend="auto", weights=weights)


_built: dict = {}


def _models(arch=ARCH, variant="fp32", fams="ffn,attn"):
    """(reference model, its params, port model, its params) of SMOKE; the
    fp32 parameters are drawn once, int8 quantizes them, bf16 rounds
    them."""
    key = (arch, variant, fams)
    if key not in _built:
        weights, dtype = VARIANTS[variant]
        families = FAMILIES[fams]
        jm = jbuild(jget_config(arch, "smoke", tt=_tt(JTTConfig, weights,
                                                      families)),
                    param_dtype=getattr(jnp, dtype))
        if variant == "fp32":
            jp = jm.init(jax.random.PRNGKey(0))
        else:
            jp = _models(arch, "fp32", fams)[1]
        if weights == "int8":
            jp = jm.quantize_params(jp)
        if dtype == "bfloat16":
            jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tm = tbuild(tget_config(arch, "smoke", tt=_tt(TTTConfig, weights,
                                                      families)),
                    param_dtype=getattr(torch, dtype), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[key] = (jm, jp, tm, tp)
    return _built[key]


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int64)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _to_port(jcache, tm) -> dict:
    """A reference cache (stacked layers; dense or paged) in the port's
    layout."""
    out = {k: torch.from_numpy(np.array(jcache[k]))
           for k in ("pos", "block_tables") if k in jcache}
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: torch.from_numpy(_f32(
            g[f"b{i}"][n][layer])) for n in bd.cache_names}
            for i, bd in enumerate(period)} for layer in range(count)]
    return out


def _close_caches(mine, jcache, tm, what, tol=TOL_CACHE):
    want = _to_port(jcache, tm)
    assert torch.equal(mine["pos"], want["pos"]), what
    got = tree_leaves({k: v for k, v in mine.items() if k.startswith("g")})
    ref = tree_leaves({k: v for k, v in want.items() if k.startswith("g")})
    assert [t.shape for t in got] == [t.shape for t in ref], what
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=tol,
                                   atol=tol, err_msg=what)


def _close_logits(tl, jl, variant, what):
    ref = _f32(jl)
    got = tl.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    tol = TOL_BF16 * np.abs(ref).max() if variant == "bf16" else TOL
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _gap_ok(logits: np.ndarray) -> None:
    top2 = np.sort(logits.astype(np.float64), -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]).min()
    assert gap > 10 * TOL, gap


class _Routes:
    """Records every port MoE call's router input, probabilities and picks
    (``moe.route`` patched), then holds the picks against the reference's
    router on the same inputs (its logits in the parameters' dtype): the
    same expert ids, and each token's k-th and (k+1)-th probabilities more
    than ``gap`` apart."""

    def __init__(self, monkeypatch):
        self.calls = []
        route = moe.route

        def recording(p, cfg, xt):
            gate, eidx = route(p, cfg, xt)
            probs = torch.softmax((xt @ p["router"]).float(), -1)
            self.calls.append((p["router"], xt.float().numpy().copy(),
                               probs.numpy().copy(), eidx.numpy().copy()))
            return gate, eidx
        monkeypatch.setattr(moe, "route", recording)

    def check(self, k: int, gap: float = 10 * TOL_ROUTE) -> None:
        assert self.calls
        for router, xt, probs, eidx in self.calls:
            dt = jnp.bfloat16 if router.dtype == torch.bfloat16 else \
                jnp.float32               # the logits in the params' dtype
            w = jnp.asarray(router.float().numpy()).astype(dt)
            want = jax.nn.softmax(
                (jnp.asarray(xt).astype(dt) @ w).astype(jnp.float32), -1)
            np.testing.assert_array_equal(
                eidx, np.asarray(jax.lax.top_k(want, k)[1]))
            top = np.sort(probs.astype(np.float64), -1)[:, ::-1]
            assert (top[:, k - 1] - top[:, k]).min() > gap
        self.calls.clear()


# --------------------------------------------------------------------------
# The registry and the converter
# --------------------------------------------------------------------------

def test_full_is_a_dense0_block_then_26_expert_blocks_over_mla():
    cfg = tget_config("deepseek-v2-lite-16b", "full")
    tm = tbuild(cfg, param_dtype=torch.bfloat16, device="cpu")
    assert [(tuple((bd.mixer, bd.window, bd.ffn) for bd in period), n)
            for period, n in tm.groups] == [
        ((("mla", 0, "dense0"),), 1), ((("mla", 0, "moe"),), 26)]
    m, e = cfg.mla, cfg.moe
    assert (m.kv_lora, m.rope_head_dim, m.nope_head_dim, m.v_head_dim) == \
        (512, 64, 128, 128)
    assert (e.num_experts, e.top_k, e.expert_ff, e.num_shared, e.shared_ff,
            e.first_dense_ff, e.capacity_factor) == (64, 6, 1408, 2, 1408,
                                                     10944, 1.25)
    assert tm.has_moe and tm.supports_prefix_reuse
    assert tm.supports_chunked_prefill and tm.windows == [0]
    shapes = tm.cache_shapes(4, 576)
    assert shapes["g0"][0]["b0"] == {"ckv": ((4, 576, 512), torch.bfloat16),
                                     "krope": ((4, 576, 64), torch.bfloat16)}
    paged = tm.paged_cache_shapes(4, 144, 16, 576)
    assert paged["g1"][25]["b0"] == {
        "ckv": ((145, 16, 512), torch.bfloat16),
        "krope": ((145, 16, 64), torch.bfloat16)}
    assert paged["block_tables"] == ((4, 36), torch.int32)
    spec = tm.param_specs()
    assert spec["g0"][0]["b0"]["ffn"]["gate"]["w"].shape == (2048, 10944)
    ffn = spec["g1"][0]["b0"]["ffn"]
    assert ffn["router"].shape == (2048, 64)
    assert ffn["experts"]["gate"]["w"].shape == (64, 2048, 1408)
    assert ffn["shared"]["down"]["w"].shape == (2816, 2048)
    attn = spec["g0"][0]["b0"]["attn"]
    assert {k: v["w"].shape for k, v in attn.items() if "w" in v} == {
        "q": (2048, 3072), "kv_down": (2048, 576), "kv_up": (512, 4096),
        "o": (2048, 2048)}
    assert attn["kv_norm"]["scale"].shape == (512,)


def test_registry_moves_qwen3_and_deepseek_v2_to_ported():
    for arch in ("qwen3_32b", "deepseek_v2_lite_16b"):
        assert arch in PORTED and arch not in PENDING
    q = tget_config("qwen3-32b", "full")
    assert (q.num_layers, q.d_model, q.num_heads, q.num_kv_heads, q.d_ff,
            q.head_dim, q.qk_norm) == (64, 5120, 64, 8, 25600, 128, True)
    tm = tbuild(q, param_dtype=torch.bfloat16, device="cpu")
    (period, n), = tm.groups
    assert n == 64 and (period[0].mixer, period[0].ffn) == ("gqa", "mlp")
    assert tm.supports_prefix_reuse and not tm.has_moe


def _cores(v, stack=()):
    c0, c1 = v["tt"]["c0"].shape, v["tt"]["c1"].shape
    assert c0[:-4] == c1[:-4] == stack
    return tuple(c0[-3:-1]) + tuple(c1[-3:-1])


def _abstract_port(arch, monkeypatch):
    """FULL with TT on ffn+attn at rank 16, length 2: the reference's
    abstract params through ``from_jax_params`` into meta tensors."""
    jm = jbuild(jget_config(arch, "full", tt=_tt(JTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=jnp.bfloat16)
    tm = tbuild(tget_config(arch, "full", tt=_tt(TTTConfig, rank=16,
                                                 min_factor=8)),
                param_dtype=torch.bfloat16, device="cpu")
    abstract = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        jm.abstract_params())
    monkeypatch.setattr(convert, "_tensor", lambda arr, dtype, device:
                        torch.empty(arr.shape, dtype=dtype, device="meta"))
    return from_jax_params(abstract, tm)


def test_converted_full_spec_shapes_are_the_references(monkeypatch):
    """deepseek-v2-lite FULL: every key, layer axis, expert axis and shape
    checked, nothing allocated.  The (n1, m1, n2, m2) of the cores are the
    fused2 shapes of the H100 run: q and o through TT, ``kv_down`` and
    ``kv_up`` dense, the dense0 MLP's ragged 1,368 modes, the shared
    experts' and the 64 experts' stacks."""
    got = _abstract_port(ARCH, monkeypatch)
    assert len(got["g0"]) == 1 and len(got["g1"]) == 26
    b0, b1 = got["g0"][0]["b0"], got["g1"][25]["b0"]
    for block in (b0, b1):
        attn = block["attn"]
        assert (_cores(attn["q"]), _cores(attn["o"])) == (
            (8, 384, 256, 8), (8, 256, 256, 8))
        assert attn["kv_down"]["w"].shape == (2048, 576)
        assert attn["kv_up"]["w"].shape == (512, 4096)
    assert {k: _cores(v) for k, v in b0["ffn"].items()} == {
        "gate": (8, 1368, 256, 8), "up": (8, 1368, 256, 8),
        "down": (8, 256, 1368, 8)}
    ffn = b1["ffn"]
    assert {k: _cores(v, (64,)) for k, v in ffn["experts"].items()} == {
        "gate": (8, 176, 256, 8), "up": (8, 176, 256, 8),
        "down": (8, 256, 176, 8)}
    assert {k: _cores(v) for k, v in ffn["shared"].items()} == {
        "gate": (8, 352, 256, 8), "up": (8, 352, 256, 8),
        "down": (8, 256, 352, 8)}
    assert ffn["router"].shape == (2048, 64)


def test_converted_qwen3_full_spec_shapes_are_the_references(monkeypatch):
    got = _abstract_port("qwen3_32b", monkeypatch)
    assert len(got["g0"]) == 64
    block = got["g0"][63]["b0"]
    cores = {k: _cores(v) for k, v in block["attn"].items()
             if isinstance(v, dict)}
    cores.update({k: _cores(v) for k, v in block["ffn"].items()})
    assert cores == {"q": (8, 1024, 640, 8), "k": (8, 128, 640, 8),
                     "v": (8, 128, 640, 8), "o": (8, 640, 1024, 8),
                     "gate": (8, 3200, 640, 8), "up": (8, 3200, 640, 8),
                     "down": (8, 640, 3200, 8)}
    assert block["attn"]["q_norm"].shape == (128,)


def test_int8_leaves_the_dense_latent_path_alone():
    """int8 cores: q/o and every FFN projection quantized (the experts on
    ``[E, d]`` scales a layer, carried from the reference's ``[L, E, d]``),
    ``kv_down``/``kv_up`` kept in the parameters' dtype, the very leaves
    of the fp32 tree."""
    _, _, tm, tp = _models(variant="fp32")
    q = tm.quantize_params(tp)
    for gi in ("g0", "g1"):
        attn, qattn = tp[gi][0]["b0"]["attn"], q[gi][0]["b0"]["attn"]
        for name in ("kv_down", "kv_up"):
            assert qattn[name]["w"] is attn[name]["w"]
        assert qattn["q"]["tt"]["c0"].dtype == torch.int8
    _, _, tm8, tp8 = _models(variant="int8")
    experts = tp8["g1"][1]["b0"]["ffn"]["experts"]["gate"]["tt"]
    assert experts["scales"].shape == (4, 2)
    assert tp8["g1"][1]["b0"]["attn"]["kv_up"]["w"].dtype == torch.float32


# --------------------------------------------------------------------------
# The MLA functions against the reference's
# --------------------------------------------------------------------------

def _layer(seed_x, S):
    """SMOKE's first layer (q/o through TT): the reference's attention
    params, the port's, both configs and backends, and x [2, S, 64]."""
    jm, jp, tm, tp = _models()
    jl = jax.tree.map(lambda a: a[0], jp["g0"]["b0"]["attn"])
    x = np.random.default_rng(seed_x).standard_normal(
        (2, S, 64)).astype(np.float32)
    return (jm, jl, tm, tp["g0"][0]["b0"]["attn"], x)


def _close(a, b, what, tol=TOL_CACHE):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(
        a, torch.Tensor) else a, dtype=np.float32), _f32(b), rtol=tol,
        atol=tol, err_msg=what)


def test_mla_self_attn_is_the_references():
    jm, jl, tm, tl, x = _layer(0, 12)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jy, (jc, jk) = jattn.mla_self_attn(jl, jm.cfg, jnp.asarray(x),
                                       jnp.asarray(pos), jm.plan_book)
    ty, (tc, tk) = tattn.mla_self_attn(tl, tm.cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()),
                                       tm.plan_book)
    for a, b, what in ((ty, jy, "y"), (tc, jc, "ckv"), (tk, jk, "krope")):
        assert tuple(a.shape) == tuple(b.shape), what
        _close(a, b, what)


def _latent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_mla_decode_attn_is_the_references(per_row):
    """The absorbed decode into latent caches of 16 positions: at position
    9 for the batch, or rows at 3 and 15 with the second inactive (its
    entry not written), outputs and both caches within 1e-5."""
    jm, jl, tm, tl, x = _layer(1, 1)
    ckv, kr = _latent((2, 16, 32), 2), _latent((2, 16, 8), 3)
    if per_row:
        pos, active = np.array([3, 15], np.int32), np.array([True, False])
        jargs = dict(active=jnp.asarray(active))
        targs = dict(active=torch.from_numpy(active))
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jargs, targs = {}, {}
        jpos, tpos = 9, torch.tensor(9, dtype=torch.int32)
    jy, jc, jk = jattn.mla_decode_attn(jl, jm.cfg, jnp.asarray(x),
                                       jnp.asarray(ckv), jnp.asarray(kr),
                                       jpos, jm.plan_book, **jargs)
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    ty, c2, k2 = tattn.mla_decode_attn(tl, tm.cfg, torch.from_numpy(x), tc,
                                       tk, tpos, tm.plan_book, **targs)
    assert c2 is tc and k2 is tk          # written in place
    for a, b, what in ((ty, jy, "y"), (tc, jc, "ckv"), (tk, jk, "krope")):
        _close(a, b, what)
    if per_row:
        assert np.array_equal(tc[1].numpy(), ckv[1])


def test_mla_decode_attn_paged_is_the_references():
    """Absorbed decode over arenas of 9 + 1 blocks of 4: row 0 at position
    6 through blocks [2, 5, 9, 9], row 1 inactive (its entry goes to the
    sentinel block 9); one ``paged_index`` reshaped to MLA's mask."""
    jm, jl, tm, tl, x = _layer(4, 1)
    ac, ak = _latent((10, 4, 32), 5), _latent((10, 4, 8), 6)
    bt = np.array([[2, 5, 9, 9], [7, 9, 9, 9]], np.int32)
    pos, active = np.array([6, 2], np.int32), np.array([True, False])
    jy, jc, jk = jattn.mla_decode_attn_paged(
        jl, jm.cfg, jnp.asarray(x), jnp.asarray(ac), jnp.asarray(ak),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(active),
        jm.plan_book)
    tc, tk = torch.from_numpy(ac.copy()), torch.from_numpy(ak.copy())
    tpos = torch.from_numpy(pos)
    index = tattn.paged_index(torch.from_numpy(bt), tpos,
                              torch.from_numpy(active), 4, 9)
    ty, _, _ = tattn.mla_decode_attn_paged(tl, tm.cfg, torch.from_numpy(x),
                                           tc, tk, tpos, index, tm.plan_book)
    for a, b, what in ((ty[:1], jy[:1], "y"), (tc[:9], jc[:9], "ckv"),
                       (tk[:9], jk[:9], "krope")):
        _close(a, b, what)
    changed = np.argwhere((tc.numpy() != ac).any(-1))
    assert sorted(map(tuple, changed.tolist())) == [(5, 2), (9, 2)]


def test_mla_chunk_attn_is_the_references():
    """A chunk of 8 at position 5 against a dense latent buffer of 16 + 8
    rows: output and both buffers within 1e-5."""
    jm, jl, tm, tl, x = _layer(7, 8)
    x = x[:1]
    dc, dk = _latent((1, 24, 32), 8), _latent((1, 24, 8), 9)
    jy, jc, jk = jattn.mla_chunk_attn(jl, jm.cfg, jnp.asarray(x),
                                      jnp.asarray(dc), jnp.asarray(dk), 5,
                                      jm.plan_book)
    tc, tk = torch.from_numpy(dc.copy()), torch.from_numpy(dk.copy())
    ty, _, _ = tattn.mla_chunk_attn(tl, tm.cfg, torch.from_numpy(x), tc, tk,
                                    torch.tensor(5, dtype=torch.int32),
                                    tm.plan_book)
    for a, b, what in ((ty, jy, "y"), (tc, jc, "ckv"), (tk, jk, "krope")):
        _close(a, b, what)


def test_mla_resume_attn_is_the_references():
    """A suffix of 4 (padded to 8) from position 6 gathered through blocks
    [1, 3, 9, 9] and scattered through [1, 4, 9, 9]: block 3 copied on
    write to block 4, block 3 left as it was; the arenas outside the
    sentinel within 1e-5."""
    jm, jl, tm, tl, x = _layer(10, 8)
    x = x[:1]
    ac, ak = _latent((10, 4, 32), 11), _latent((10, 4, 8), 12)
    src, dst = np.array([1, 3, 9, 9], np.int32), np.array([1, 4, 9, 9],
                                                          np.int32)
    jy, jc, jk = jattn.mla_resume_attn(
        jl, jm.cfg, jnp.asarray(x), jnp.asarray(ac), jnp.asarray(ak),
        jnp.asarray(src), jnp.asarray(dst), 6, jm.plan_book)
    tc, tk = torch.from_numpy(ac.copy()), torch.from_numpy(ak.copy())
    ty, _, _ = tattn.mla_resume_attn(
        tl, tm.cfg, torch.from_numpy(x), tc, tk, torch.from_numpy(src),
        torch.from_numpy(dst), torch.tensor(6, dtype=torch.int32),
        tm.plan_book)
    for a, b, what in ((ty, jy, "y"), (tc[:9], jc[:9], "ckv"),
                       (tk[:9], jk[:9], "krope")):
        _close(a, b, what)
    assert np.array_equal(tc[3].numpy(), ac[3])
    assert np.array_equal(tc[4, :2].numpy(), ac[3, :2])


# --------------------------------------------------------------------------
# Prefill and decode against the reference
# --------------------------------------------------------------------------

PREFILLS = [(v, f, S, b) for f in FAMILIES for v, S, b in (
    ("fp32", 24, False), ("fp32", 20, True), ("int8", 24, False),
    ("int8", 20, True), ("bf16", 24, False), ("bf16", 20, True))]


@pytest.mark.parametrize("variant,fams,S,bucketed", PREFILLS,
                         ids=[f"{f}-{v}-{S}{'-in-32' if b else ''}"
                              for v, f, S, b in PREFILLS])
def test_prefill_matches_the_reference(variant, fams, S, bucketed,
                                       monkeypatch):
    """Logits and every latent cache leaf into a cache of 48 (the expanded
    form's ckv/krope, zero past the prompt): the bucket's padding routes
    through the experts too (the reference's token set), and nothing is
    dropped."""
    jm, jp, tm, tp = _models(ARCH, variant, fams)
    tokens = (_tokens(1, S, BF16_SEED[fams]) if variant == "bf16"
              else _tokens(1 if bucketed else 2, S, S))
    arrays = {"tokens": jnp.asarray(tokens, jnp.int32)}
    routes = _Routes(monkeypatch)
    moe.reset_drops()
    if bucketed:
        jl, jc = jm.jitted_prefill_bucketed(48)(jp, arrays)
        tl, tc = tm.bucketed_prefill(48)(tp, {"tokens":
                                              torch.from_numpy(tokens)})
    else:
        jl, jc = jm.jitted_prefill(48)(jp, arrays)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                                 "cache_len": 48})
    assert moe.read_drops() == 0
    routes.check(tm.cfg.moe.top_k, 2 * TOL_ROUTE_BF16 if variant == "bf16"
                 else 10 * TOL_ROUTE)
    _close_logits(tl, jl, variant, "prefill")
    assert int(tc["pos"]) == S
    if variant == "bf16":
        ref = _to_port(jc, tm)
        top = max(float(t.abs().max()) for t in tree_leaves(ref))
        _close_caches(tc, jc, tm, "prefill", tol=TOL_BF16 * top)
    else:
        _close_caches(tc, jc, tm, "prefill")


DECODE_SEED, STEPS = 3, 16


@pytest.mark.parametrize("fams", list(FAMILIES))
@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_decode_matches_the_reference(variant, fams, monkeypatch):
    """A prompt of 12 into a cache of 32, then 16 greedy absorbed-form
    steps: routing identical, tokens identical, logits within 1e-4,
    latent caches within 1e-5."""
    jm, jp, tm, tp = _models(ARCH, variant, fams)
    tokens = _tokens(2, 12, DECODE_SEED)
    routes = _Routes(monkeypatch)
    moe.reset_drops()
    jl, jc = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 32})
    routes.check(tm.cfg.moe.top_k)
    _close_logits(tl, jl, variant, "prefill")
    step = jm.jitted_decode_step()
    for t in range(STEPS):
        ref = np.asarray(jl)[:, -1]
        _gap_ok(ref)
        tok = ref.argmax(-1)[:, None]
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        routes.check(tm.cfg.moe.top_k)
        _close_logits(tl, jl, variant, f"step {t}")
    assert moe.read_drops() == 0
    _close_caches(tc, jc, tm, "decode")


# --------------------------------------------------------------------------
# The schedulers
# --------------------------------------------------------------------------

SCHED_T = 48
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks", "chunk_lanes",
              "blocks_in_use", "block_high_water", "prefix_hit_tokens",
              "prefix_prompt_tokens", "prefill_tokens_skipped")


def _staggered(submit, step):
    """r0 (40 tokens) is admitted and steps once, then r1 (24) and r2 (8),
    which queues; after the drain r3 (20)."""
    submit(0, 0, 5)
    step()
    submit(1, 1, 6)
    submit(2, 2, 4)
    return [3]


def _prefix(submit, step):
    """r1 shares r0's first 16 tokens (4 blocks of 4) and joins while r0
    runs; once both retired, r2 is r0's prompt again: it covers the whole
    prompt, copies its last block on write and recomputes one token."""
    submit(0, 0, 5)
    step()
    submit(1, 1, 5)
    return [2]


# name → (driver, prompt lengths, prompts sharing r0's first 16 tokens,
# the uid of each request's prompt)
SCHEDULES = {"staggered": (_staggered, (40, 24, 8, 20), (), (0, 1, 2, 3)),
             "prefix": (_prefix, (20, 24), (1,), (0, 1, 0))}
MODES = {
    "dense": {},
    "paged": dict(paged=True, block_size=4),
    "chunk8-dense": dict(chunk_prefill=True, chunk_size=8,
                         prefill_budget=16),
    "chunk8-paged": dict(chunk_prefill=True, chunk_size=8,
                         prefill_budget=16, paged=True, block_size=4),
    "chunk24-dense": dict(chunk_prefill=True, chunk_size=24),
}
RUNS = [("staggered", m) for m in MODES] + [
    ("prefix", "paged"), ("prefix", "chunk8-paged")]


def _sched_prompts(schedule):
    _, lens, sharing, _ = SCHEDULES[schedule]
    rows = [_tokens(1, n, 90 + i) for i, n in enumerate(lens)]
    for i in sharing:
        rows[i] = np.concatenate([rows[0][:, :16], rows[i][:, 16:]], 1)
    return rows


def _serve(sched, req_cls, schedule, to_tokens) -> dict:
    driver, _, _, rows_of = SCHEDULES[schedule]
    rows = _sched_prompts(schedule)
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if sched.paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid, row, budget):
        sched.submit(req_cls(uid=uid, inputs={"tokens": to_tokens(rows[row])},
                             max_new_tokens=budget))

    later = driver(submit, step)
    while not sched.idle:
        step()
    for uid in later:
        submit(uid, rows_of[uid], 3)
        while not sched.idle:
            step()
    if sched.paged:
        sched.allocator.assert_quiescent()
    st = sched.stats()
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "stats": {k: st[k] for k in STAT_NAMES if k in st}}


_port_runs: dict = {}


def _port_run(schedule, mode):
    """The port's scheduler (cached per run) and the MoE drops it made."""
    key = (schedule, mode)
    if key not in _port_runs:
        _, _, tm, tp = _models()
        moe.reset_drops()
        out = _serve(Scheduler(tm, tp, num_slots=2, cache_len=SCHED_T,
                               **MODES[mode]), Request, schedule,
                     torch.from_numpy)
        _port_runs[key] = (out, moe.read_drops())
    return _port_runs[key]


@pytest.mark.parametrize("schedule,mode", RUNS,
                         ids=[f"{s}-{m}" for s, m in RUNS])
def test_scheduler_is_the_references(schedule, mode):
    """Every pool and admission kind against the reference's ``Scheduler``:
    tokens identical, logprobs within 1e-4, the slots (uid, prompt
    position, blocks) after every step and the counters equal, no drop;
    the prefix schedule hits 16 tokens for r1 and all 20 of r2's (chunked:
    r1 arrives while r0's prompt is still streaming in, so only r2 hits)."""
    jm, jp, _, _ = _models()
    mine, drops = _port_run(schedule, mode)
    ref = _serve(JScheduler(jm, jp, num_slots=2, cache_len=SCHED_T,
                            **MODES[mode]), JRequest, schedule,
                 lambda r: jnp.asarray(r, jnp.int32))
    uids = list(range(len(SCHEDULES[schedule][3])))
    assert sorted(mine["done"]) == sorted(ref["done"]) == uids
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
    assert drops == 0
    if (schedule, mode) == ("prefix", "paged"):
        assert mine["stats"]["prefix_hit_tokens"] == 36
        assert mine["stats"]["prefix_prompt_tokens"] == 64
    elif schedule == "prefix":       # chunked: r1 arrives mid-prefill
        assert mine["stats"]["prefix_hit_tokens"] == 20


@pytest.mark.parametrize("run,base", [
    (("staggered", "paged"), ("staggered", "dense")),
    (("staggered", "chunk8-paged"), ("staggered", "chunk8-dense")),
    (("staggered", "chunk8-dense"), ("staggered", "dense")),
    (("staggered", "chunk24-dense"), ("staggered", "dense")),
    (("prefix", "chunk8-paged"), ("prefix", "paged"))],
    ids=["paged=dense", "chunk-paged=chunk-dense", "chunk8=monolithic",
         "chunk24=monolithic", "prefix-chunked=prefix-monolithic"])
def test_paths_agree_within_the_port(run, base):
    """Paged ≡ dense: the same calls on the same tokens, bit for bit.
    Chunked ≡ monolithic: the absorbed form against the expanded one and
    other token groupings (dropless here): tokens identical, logprobs
    within 1e-4."""
    a, b = _port_run(*run)[0], _port_run(*base)[0]
    same_form = run[1].startswith("chunk") == base[1].startswith("chunk")
    for uid, f in a["done"].items():
        np.testing.assert_array_equal(f.tokens, b["done"][uid].tokens)
        if same_form and run[0] == "staggered":
            assert np.array_equal(f.logprobs, b["done"][uid].logprobs)
        else:
            np.testing.assert_allclose(f.logprobs, b["done"][uid].logprobs,
                                       rtol=TOL, atol=TOL)


def test_prefix_hits_are_fresh_prefills():
    """Each request of the prefix schedule, whose admissions resumed from
    shared blocks (the absorbed form), against ``generate_fixed`` of its
    prompt alone (the expanded prefill): tokens identical, logprobs within
    1e-4."""
    _, _, tm, tp = _models()
    mine, _ = _port_run("prefix", "paged")
    rows = _sched_prompts("prefix")
    for uid, f in mine["done"].items():
        row = rows[SCHEDULES["prefix"][3][uid]]
        fresh = generate_fixed(tm, tp, {"tokens": torch.from_numpy(row),
                                        "cache_len": SCHED_T},
                               len(f.tokens))
        np.testing.assert_array_equal(f.tokens, fresh.tokens[0].numpy())
        np.testing.assert_allclose(f.logprobs, fresh.logprobs[0].numpy(),
                                   rtol=TOL, atol=TOL)


def test_serve_cli_prefix_smoke_runs_on_cpu():
    """serve's prefix-reuse check on deepseek-v2 SMOKE (an MoE model whose
    latent cache is shared): hits and skipped prefill tokens, every
    request held against ``generate_fixed``."""
    out = serve.main(["--arch", "deepseek-v2-lite-16b", "--variant",
                      "smoke", "--tt", "ffn,attn", "--tt-rank", "4",
                      "--tt-backend", "auto", "--device", "cpu",
                      "--prefix-smoke", "--paged", "--block-size", "4",
                      "--prefix-len", "12", "--steps", "4"])
    assert out["shared_blocks"] == 3
    assert out["hits"] == [(0, 0), (12, 12), (28, 27)]
    assert out["cow"] and out["blocks_in_use"] == 0
    assert sorted(out["finished"]) == [0, 1, 2]
    assert all(g["identical"] for g in out["greedy"].values())


# --------------------------------------------------------------------------
# qwen3-32b SMOKE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_qwen3_prefill_and_decode_match_the_reference(variant):
    jm, jp, tm, tp = _models("qwen3_32b", variant, "ffn,attn")
    tokens = _tokens(2, 12, 6)
    jl, jc = jm.jitted_prefill(32)(jp, {"tokens": jnp.asarray(tokens,
                                                               jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": 32})
    _close_logits(tl, jl, variant, "qwen3 prefill")
    step = jm.jitted_decode_step()
    for t in range(16):
        ref = np.asarray(jl)[:, -1]
        _gap_ok(ref)
        tok = ref.argmax(-1)[:, None]
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), tok[:, 0])
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close_logits(tl, jl, variant, f"qwen3 step {t}")
