"""The padded and bucketed prefill, the port's analogue of the reference's
``bucket_length``, ``Model.prefill``'s ``prompt_len``,
``jitted_prefill_bucketed`` and the scheduler's default
``bucket_prompts=True``, on the CPU against the reference.

deepseek-7b SMOKE (TT on ffn+attn, rank 4) through both packages on each
main path: length 2 ``auto`` (fused2), length 3 ``auto`` (fused chain),
length 2 ``cuda_step`` (the step kernel), and length 2 with int8 cores,
the reference's weights carried into the port by
``convert.from_jax_params`` and the prompts drawn with numpy from a seed.

- ``bucket_length`` is the reference's, error included.
- The port's ``bucketed_prefill`` gives the reference's logits within 1e-4
  (XLA and torch sum in other orders) and cache, ``pos`` at the true
  length, and makes at most 3 prefill entries for lengths 3..40 at a
  cache of 64 (the port of the reference's
  ``test_bucketed_prefill_bounds_compiles``).
- A prefill with a device ``prompt_len`` reads nothing on the host, and
  two lengths in one bucket dispatch the same ops, so one captured prefill
  serves the bucket; an ``out`` cache receives what a fresh one holds.
- The default (bucketed) ``Scheduler`` gives the reference's default
  ``Scheduler``'s greedy tokens, logprobs within 1e-4, and as many prefill
  entries, on a staggered schedule whose prompts fall in two buckets.

The captured prefill against the eager one, bit for bit, needs a card:
``tests/test_torch_gpu.py``.
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
from repro.models.model import bucket_length as jbucket_length
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.models.model import GRAPH_CACHE_SIZE, bucket_length
from repro_torch.models.spec import tree_leaves
from repro_torch.serving.engine import generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4
CACHE_LEN = 64
LENGTHS = range(3, 41)
# (TT length, port backend, reference backend, weights, weight seed)
PATHS = {"len2-auto": (2, "auto", "auto", "fp32", 0),
         "len3-auto": (3, "auto", "auto", "fp32", 1),
         "len2-cuda_step": (2, "cuda_step", "pallas_step", "fp32", 0),
         "len2-auto-int8": (2, "auto", "auto", "int8", 0)}


def _tt(cls, length, backend, weights):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend, weights=weights)


def _models(path):
    length, backend, jbackend, weights, seed = PATHS[path]
    jm = jbuild(jget_config("deepseek_7b", "smoke",
                            tt=_tt(JTTConfig, length, jbackend, weights)))
    jp = jm.init(jax.random.PRNGKey(seed))
    if weights == "int8":
        jp = jm.quantize_params(jp)
    tm = tbuild(tget_config("deepseek_7b", "smoke",
                            tt=_tt(TTTConfig, length, backend, weights)),
                device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=list(PATHS))
def pair(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def pair2():
    return _models("len2-auto")


def _prompt(vocab, L, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, L),
                                                dtype=np.int64)


def _kv(cache, name):
    """The port's k or v of every layer, stacked [L, B, T, KV, hd]."""
    return torch.stack([layer["b0"][name] for layer in cache["g0"]])


@pytest.mark.parametrize("limit", [1, 5, 16, 17, 40, 64, 100])
def test_bucket_length_is_the_reference(limit):
    for floor in (16, 1, 8):
        for S in range(0, limit + 1):
            assert bucket_length(S, limit, floor) == \
                jbucket_length(S, limit, floor), (S, floor)
    with pytest.raises(ValueError, match="exceeds cache length"):
        bucket_length(limit + 1, limit)
    with pytest.raises(ValueError, match="exceeds cache length"):
        jbucket_length(limit + 1, limit)


def test_bucketed_prefill_matches_the_reference(pair):
    """Lengths 3..40 at a cache of 64: the logits and the whole cache
    within 1e-4, ``pos`` the true length, and the prefill entries bounded
    by the buckets {16, 32, 64} on both sides."""
    jm, jp, tm, tp = pair
    jfn = jm.jitted_prefill_bucketed(CACHE_LEN)
    tfn = tm.bucketed_prefill(CACHE_LEN)
    jbuilds, tbuilds = jm.prefill_builds, tm.prefill_builds
    for L in LENGTHS:
        tokens = _prompt(jm.cfg.vocab_size, L, L)
        jl, jc = jfn(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
        tl, tc = tfn(tp, {"tokens": torch.from_numpy(tokens)})
        assert tc["pos"].dtype == torch.int32 and tc["pos"].dim() == 0
        assert int(tc["pos"]) == int(jc["pos"]) == L
        assert tl.shape == (1, 1, jm.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"L={L}")
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _kv(tc, name).numpy(), np.asarray(jc["g0"]["b0"][name]),
                rtol=TOL, atol=TOL, err_msg=f"L={L} {name}")
    assert tm.prefill_builds - tbuilds == 3
    assert jm.prefill_builds - jbuilds <= 3
    assert list(tm.eager_prefills)[-3:] == [(1, 16, CACHE_LEN),
                                            (1, 32, CACHE_LEN),
                                            (1, 64, CACHE_LEN)]


def test_padded_prefill_is_the_exact_one_on_the_true_rows(pair2):
    """Padding changes nothing the decode reads: the true rows' k/v and
    the logits agree with the exact prefill (the kernels see another row
    count, so within 1e-5), ``pos`` is the true length either way."""
    _, _, tm, tp = pair2
    tokens = torch.from_numpy(_prompt(tm.cfg.vocab_size, 11, 0))
    exact_l, exact = tm.prefill(tp, {"tokens": tokens, "cache_len": 40})
    pad_l, pad = tm.bucketed_prefill(40)(tp, {"tokens": tokens})
    assert int(exact["pos"]) == int(pad["pos"]) == 11
    torch.testing.assert_close(pad_l, exact_l, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(_kv(pad, name)[:, :, :11],
                                   _kv(exact, name)[:, :, :11],
                                   rtol=1e-5, atol=1e-5)
        assert not _kv(pad, name)[:, :, 16:].any()       # past the bucket
        assert not _kv(exact, name)[:, :, 11:].any()


def test_prefill_into_an_out_cache_is_a_fresh_one_bit_for_bit(pair2):
    _, _, tm, tp = pair2
    tokens = torch.from_numpy(np.pad(_prompt(tm.cfg.vocab_size, 9, 3),
                                     ((0, 0), (0, 7))))
    batch = {"tokens": tokens, "cache_len": 24, "prompt_len": 9}
    want_l, want = tm.prefill(tp, batch)
    out = tm.init_cache(1, 24)
    for t in tree_leaves(out):
        t.fill_(7)
    got_l, got = tm.prefill(tp, dict(batch, prompt_len=torch.tensor(9)),
                            out=out)
    assert torch.equal(got_l, want_l)
    assert all(a is b for a, b in zip(tree_leaves(got), tree_leaves(out)))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="output cache's k"):
        tm.prefill(tp, batch, out=tm.init_cache(1, 23))
    with pytest.raises(ValueError, match="prompt_len 17 outside"):
        tm.prefill(tp, dict(batch, prompt_len=17))


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


def test_two_lengths_in_a_bucket_dispatch_the_same_ops_and_read_nothing(
        pair):
    """The captured prefill's body: prompts of 9 and 14 tokens padded to
    the bucket of 16, their lengths as device tensors, into one output
    cache."""
    _, _, tm, tp = pair
    out = tm.init_cache(1, 40)
    logs = []
    for L in (9, 14):
        tokens = np.pad(_prompt(tm.cfg.vocab_size, L, L),
                        ((0, 0), (0, 16 - L)))
        plen = torch.tensor(L, dtype=torch.int32)
        with _OpLog() as log:
            tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                            "cache_len": 40, "prompt_len": plen}, out=out)
        logs.append(log.ops)
        assert int(out["pos"]) == L
    assert len(logs[0]) > 100
    assert logs[0] == logs[1]
    names = {op for op, _ in logs[0]}
    assert not any("_local_scalar_dense" in n or "aten.item" in n
                   for n in names), sorted(names)


def test_prefill_entries_are_counted_in_an_lru(pair2):
    """On the CPU a prefill entry is an eager key (batch, padded length,
    cache length): a key counts in ``prefill_builds`` when it is new to
    the LRU of the last ``GRAPH_CACHE_SIZE`` keys, as the reference's
    jitted entries do; ``generate_fixed`` prefills at the exact length."""
    _, _, tm, tp = pair2
    tm.eager_prefills.clear()
    builds = tm.prefill_builds
    fn = tm.bucketed_prefill(CACHE_LEN)
    for L in (3, 16, 5, 17, 33):
        fn(tp, {"tokens": torch.from_numpy(_prompt(tm.cfg.vocab_size, L, L))})
    assert tm.prefill_builds - builds == 3
    batch = {"tokens": torch.from_numpy(_prompt(tm.cfg.vocab_size, 7, 0)),
             "cache_len": 12}
    generate_fixed(tm, tp, batch, 2)
    generate_fixed(tm, tp, batch, 2)
    assert tm.prefill_builds - builds == 4
    assert list(tm.eager_prefills)[-1] == (1, 7, 12)
    for T in range(20, 20 + GRAPH_CACHE_SIZE):
        tm.bucketed_prefill(T)(tp, {"tokens": batch["tokens"]})
    assert len(tm.eager_prefills) == GRAPH_CACHE_SIZE
    assert tm.prefill_builds - builds == 4 + GRAPH_CACHE_SIZE
    fn(tp, {"tokens": batch["tokens"]})           # evicted: a new entry
    assert tm.prefill_builds - builds == 5 + GRAPH_CACHE_SIZE
    assert tm.decode_graphs == {} and tm.prefill_graphs == {}


def test_graphed_prefill_needs_a_cuda_model():
    tm = tbuild(tget_config("deepseek_7b", "smoke"), device="cpu")
    with pytest.raises(ValueError, match="CUDA model"):
        tm.graphed_prefill(1, 16, 32)


# --------------------------------------------------------------------------
# The scheduler's default: bucketed admissions
# --------------------------------------------------------------------------

# prompt lengths (buckets 16, 32, 16 at a cache of 40) and budgets
STAGGER_LENS, STAGGER_BUDGETS, STAGGER_T = (5, 20, 12), (6, 3, 5), 40


def _staggered(sched, req_cls, rows):
    """r0 is admitted and decodes one step, r1 joins (a new bucket while r0
    is live), r2 queues until a slot frees (2 slots)."""
    for uid, budget in enumerate(STAGGER_BUDGETS):
        sched.submit(req_cls(uid=uid, inputs={"tokens": rows[uid]},
                             max_new_tokens=budget))
        if uid < 2:
            sched.step()
    out = dict(sched.run())
    for f in sched.finished:
        out[f.uid] = f
    return out


def _ref_greedy_gap(jm, jp, tokens, steps):
    """The reference's greedy decode of ``tokens [1, S]`` alone, asserting
    a top-1/top-2 logit gap over ten times the tolerance at every step."""
    lg, cache = jm.jitted_prefill(STAGGER_T)(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    step = jm.jitted_decode_step()
    toks = []
    for t in range(steps):
        lg = np.asarray(lg)[:, -1].astype(np.float64)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 10 * TOL), (t, top2)
        toks.append(int(lg.argmax(-1)[0]))
        if t + 1 < steps:
            lg, cache = step(jp, cache, jnp.asarray([[toks[-1]]], jnp.int32))
    return np.asarray(toks)


@pytest.mark.parametrize("path", ["len2-auto", "len3-auto",
                                  "len2-cuda_step"])
def test_default_scheduler_buckets_as_the_reference(path):
    jm, jp, tm, tp = _models(path)
    prompts = [_prompt(jm.cfg.vocab_size, L, 100 + i)
               for i, L in enumerate(STAGGER_LENS)]
    jbuilds, tbuilds = jm.prefill_builds, tm.prefill_builds
    ref = _staggered(JScheduler(jm, jp, num_slots=2, cache_len=STAGGER_T),
                     JRequest, [jnp.asarray(p, jnp.int32) for p in prompts])
    sched = Scheduler(tm, tp, num_slots=2, cache_len=STAGGER_T)
    assert sched.bucket_prompts
    mine = _staggered(sched, Request, [torch.from_numpy(p) for p in prompts])
    # one entry per bucket met, on both sides
    assert tm.prefill_builds - tbuilds == jm.prefill_builds - jbuilds == 2
    assert sorted(mine) == sorted(ref) == [0, 1, 2]
    for uid, steps in enumerate(STAGGER_BUDGETS):
        np.testing.assert_array_equal(
            mine[uid].tokens, _ref_greedy_gap(jm, jp, prompts[uid], steps))
        np.testing.assert_array_equal(mine[uid].tokens,
                                      np.asarray(ref[uid].tokens))
        np.testing.assert_allclose(mine[uid].logprobs,
                                   np.asarray(ref[uid].logprobs),
                                   rtol=TOL, atol=TOL)
        assert mine[uid].prompt_len == STAGGER_LENS[uid]
        assert mine[uid].finish_reason == "length"
    assert sched.admissions == 3 and tm.prefill_graphs == {}
