"""The decode step with its position on the device, the port's analogue of
the reference's ``jitted_decode_step``, on the CPU against the reference.

deepseek-7b SMOKE (TT on ffn+attn, rank 4, fp32 cores) through both
packages on each main path: length 2 ``auto`` (fused2), length 3 ``auto``
(fused chain) and length 2 ``cuda_step`` (the step kernel), with the
reference's weights carried into the port by ``convert.from_jax_params``.

- A scalar position (a 0-d int32 tensor, as the reference's) and a vector
  position [B] with rows at different depths give the reference's logits
  within 1e-4 (XLA and torch sum in different orders on the CPU); a row at
  a position ≥ the cache length writes nothing.  Greedy tokens are
  identical; the seed is one whose top-1/top-2 logit gap exceeds ten times
  that tolerance at every step, which the test asserts.
- Two consecutive steps dispatch the same ops with the same non-tensor
  arguments and read no device value on the host, so a CUDA graph captured
  at one step replays the next (a position frozen into the capture shows
  here on the CPU); so do two masked steps of the scheduler's slot pool
  with other positions and another ``active`` mask.
- A position outside the cache raises before a step runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import hw
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import tt_contract
from repro_torch.serving.engine import generate_fixed

B, S, STEPS = 3, 8, 8
T = S + STEPS
TOL = 1e-4
# (TT length, port backend, reference backend, seed)
PATHS = {"len2-auto": (2, "auto", "auto", 0),
         "len3-auto": (3, "auto", "auto", 1),
         "len2-cuda_step": (2, "cuda_step", "pallas_step", 0)}


def _tt(cls, length, backend):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend, weights="fp32")


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request):
    length, backend, jbackend, seed = PATHS[request.param]
    jm = jbuild(jget_config("deepseek_7b", "smoke",
                            tt=_tt(JTTConfig, length, jbackend)))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tget_config("deepseek_7b", "smoke",
                            tt=_tt(TTTConfig, length, backend)),
                device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jm.cfg.vocab_size, (B, S), dtype=np.int64)
    forced = rng.integers(0, jm.cfg.vocab_size, (B, STEPS), dtype=np.int64)
    return jm, jp, tm, tp, tokens, forced


def _prefill(pair):
    jm, jp, tm, tp, tokens = pair[:5]
    jl, jc = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(tokens,
                                                              jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "cache_len": T})
    return jl, jc, tl, tc


def _kv(cache, name):
    """The port's k or v of every layer, stacked [L, B, T, KV, hd]."""
    return torch.stack([layer["b0"][name] for layer in cache["g0"]])


def _jkv(cache, name):
    """The reference's, stacked the same way by its scan."""
    return np.asarray(cache["g0"]["b0"][name])


def test_scalar_device_position_matches_jitted_decode_step(pair):
    jm, jp, tm, tp, _, forced = pair
    _, jc, _, tc = _prefill(pair)
    assert tc["pos"].dtype == torch.int32 and tc["pos"].dim() == 0
    assert int(tc["pos"]) == int(jc["pos"]) == S
    step = jm.jitted_decode_step()
    plans0 = tplan.plan_resolutions()
    for t in range(STEPS):
        tok = forced[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
        assert tc["pos"].dim() == 0 and int(tc["pos"]) == S + t + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_kv(tc, name).numpy(), _jkv(jc, name),
                                   rtol=TOL, atol=TOL)
    assert tplan.plan_resolutions() == plans0


def test_greedy_tokens_through_generate_fixed(pair):
    jm, jp, tm, tp, tokens, _ = pair
    jl, jc, _, _ = _prefill(pair)
    step = jm.jitted_decode_step()
    ref_tokens = []
    for t in range(STEPS):
        lg = np.asarray(jl)[:, -1]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 10 * TOL), (t, top2)
        tok = lg.argmax(-1)
        ref_tokens.append(tok)
        if t + 1 < STEPS:
            jl, jc = step(jp, jc, jnp.asarray(tok[:, None], jnp.int32))
    res = generate_fixed(tm, tp, {"tokens": torch.from_numpy(tokens),
                                  "cache_len": T}, STEPS)
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(ref_tokens, 1))
    # on the CPU the step stays eager: no graph is made
    assert tm.decode_graphs == {} and tm.graph_captures == 0


def test_vector_position_matches_reference_decode_step(pair):
    """Rows at depths S, S - 3 and T (outside the cache, which it must not
    write), through the reference's per-slot branch."""
    jm, jp, tm, tp, _, forced = pair
    _, jc, _, tc = _prefill(pair)
    pos = np.array([S, S - 3, T], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"] = torch.from_numpy(pos)
    kv2 = [_kv(tc, n)[:, 2] for n in ("k", "v")]
    step = jax.jit(jm.decode_step)
    for t in range(3):
        tok = forced[:, t:t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
        np.testing.assert_array_equal(tc["pos"].numpy(), pos + t + 1)
        for name in ("k", "v"):
            np.testing.assert_allclose(_kv(tc, name).numpy(),
                                       _jkv(jc, name), rtol=TOL, atol=TOL)
    for old, name in zip(kv2, ("k", "v")):
        assert torch.equal(_kv(tc, name)[:, 2], old)


class _OpLog(TorchDispatchMode):
    """Every op dispatched, with its non-tensor arguments (tensors as their
    shape and dtype)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        self.ops.append((str(func), tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
            for a in flat)))
        return func(*args, **kwargs)


def test_two_steps_dispatch_the_same_ops_and_read_nothing(pair):
    _, _, tm, tp, _, forced = pair
    _, _, _, tc = _prefill(pair)
    logs = []
    for t in range(2):
        with _OpLog() as log:
            _, tc = tm.decode_step(tp, tc, torch.from_numpy(
                forced[:, t:t + 1]))
        logs.append(log.ops)
    assert int(tc["pos"]) == S + 2
    assert len(logs[0]) > 100
    assert logs[0] == logs[1]
    names = {op for op, _ in logs[0]}
    assert not any("_local_scalar_dense" in n or "aten.item" in n
                   for n in names), sorted(names)


def test_two_masked_steps_dispatch_the_same_ops_and_read_nothing(pair):
    """The scheduler's slot-pool step: a position per row and an ``active``
    mask, both changing between the steps, dispatch the same ops with the
    same non-tensor arguments and read nothing on the host."""
    _, _, tm, tp, _, forced = pair
    _, _, _, tc = _prefill(pair)
    tc["pos"] = torch.tensor([S, S - 3, S - 1], dtype=torch.int32)
    masks = ([True, False, True], [False, True, True])
    logs = []
    for t, mask in enumerate(masks):
        active = torch.tensor(mask)
        with _OpLog() as log:
            _, tc = tm.decode_step(tp, tc, torch.from_numpy(
                forced[:, t:t + 1]), active)
        logs.append(log.ops)
    assert tc["pos"].tolist() == [S + 1, S - 2, S + 1]
    assert len(logs[0]) > 100
    assert logs[0] == logs[1]
    names = {op for op, _ in logs[0]}
    assert not any("_local_scalar_dense" in n or "aten.item" in n
                   for n in names), sorted(names)


def test_position_outside_the_cache_raises_before_a_step(monkeypatch):
    class Ran(Exception):
        pass

    def ran(*args):
        raise Ran

    tm = tbuild(tget_config("deepseek_7b", "smoke"), device="cpu")
    monkeypatch.setattr(tm, "prefill", ran)
    monkeypatch.setattr(tm, "decode_step", ran)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
             "cache_len": T}
    with pytest.raises(ValueError, match="outside the cache of 16"):
        generate_fixed(tm, None, batch, T - S + 2)
    # one token fewer decodes up to the cache's last position: it runs
    with pytest.raises(Ran):
        generate_fixed(tm, None, batch, T - S + 1)


def test_decode_step_outside_the_cache_writes_nothing(pair):
    _, _, tm, tp, _, forced = pair
    _, _, _, tc = _prefill(pair)
    tc["pos"] = torch.tensor(T, dtype=torch.int32)
    before = [_kv(tc, n) for n in ("k", "v")]
    with pytest.raises(IndexError):
        tm.decode_step(tp, tc, torch.from_numpy(forced[:, :1]))
    for old, name in zip(before, ("k", "v")):
        assert torch.equal(_kv(tc, name), old)


def test_graph_needs_a_cuda_model():
    tm = tbuild(tget_config("deepseek_7b", "smoke"), device="cpu")
    with pytest.raises(ValueError, match="CUDA model"):
        tm.graphed_decode_step(B, T)
    with pytest.raises(ValueError, match="CUDA model"):
        tm.graphed_decode_step(B, T, masked=True)


def test_chain_tables_are_made_once_per_geometry(monkeypatch):
    """The fused chain's address tables are built on a geometry miss only
    (a host-to-device copy, which a capture does not permit), so a warm-up
    at the capture's batch leaves the capture nothing to build."""
    made = []
    real = tt_contract.chain_tables

    def counting(*a):
        made.append(a)
        return real(*a)

    monkeypatch.setattr(tt_contract, "chain_tables", counting)
    monkeypatch.setattr(tt_contract, "_CHAIN_TABLES", {})
    dims = ((8, 8, 64), (64, 8, 8), (1, 16, 16, 1))
    spec = hw.H100_SXM
    cpu = torch.device("cpu")
    geos = {b: tt_contract.chain_geometry(b, dims, 2, 2, spec.sm_count,
                                          spec.smem_per_block)
            for b in (4, 256)}
    first = tt_contract._chain_tables_on(cpu, dims, geos[4], 2)
    assert tt_contract._chain_tables_on(cpu, dims, geos[4], 2) is first
    assert len(made) == 1 and first.dtype == torch.int32
    other = tt_contract._chain_tables_on(cpu, dims, geos[256], 2)
    assert len(made) == 2 and other is not first
    assert tt_contract._chain_tables_on(cpu, dims, geos[256], 2) is other
    assert len(made) == 2
