"""The block-paged KV pool with copy-on-write prefix reuse, the port's
``serving.paging``, paged decode, resume prefill and paged ``Scheduler``,
on the CPU against the reference (as the reference's
``tests/test_paging.py``, block 4).

deepseek-7b SMOKE (TT on ffn+attn, rank 4, fp32 cores) through both
packages, the reference's weights carried into the port by
``convert.from_jax_params`` and the prompts drawn with numpy from a seed.

- ``BlockAllocator``: port and reference driven by one seeded random walk
  of alloc/incref/decref/publish/acquire/cow/resize/finalize_shrink, the
  same results and errors and ``state()`` equal after every op;
  ``chain_hashes`` and ``logical_blocks`` equal.
- ``gqa_decode_attn_paged`` within 1e-5 of the reference's (output and
  arenas), ``prefill_resume`` within 1e-4 (logits and arenas outside the
  sentinel and the free blocks; positions and tables equal),
  ``splice_cache_paged`` equal bit for bit.
- The paged ``Scheduler`` against the reference's on the reference's own
  schedules (staggered, a shared 12-token prefix with refcounts [2, 2, 2],
  full-coverage COW, memory-limited queueing): tokens identical, logprobs
  within 1e-4, the same block ids per slot after every step, the same
  counters, no leaked block after the drain; an oversized request refused
  at ``submit`` on both sides.  At every step the reference's top-1/top-2
  gap of each request alone exceeds ten times 1e-4, asserted.
- ``engine.generate(paged=True)`` gives ``generate_fixed``'s tokens and
  the reference's paged ``generate``'s.
- Within the port: paged against dense bit for bit with no plan
  resolution; two paged masked steps and two resume prefills of one
  bucket dispatch identical ops and read nothing on the host.
- The serve CLI's ``--paged`` arrival mode and ``--prefix-smoke``.

The captured paged step and resume against their eager forms need a card:
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
from repro.models import attention as jattention
from repro.serving import paging as jpaging
from repro.serving.engine import generate as jgenerate
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import plan as tplan
from repro_torch.models import attention as tattention
from repro_torch.serving import paging as tpaging
from repro_torch.serving.engine import generate, generate_fixed
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # port against the reference (logits, logprobs)
TOL_ATTN = 1e-5     # one attention call
BLOCK = 4
# (TT length, port backend, reference backend, weight seed)
PATHS = {"len2-auto": (2, "auto", "auto", 0),
         "len3-auto": (3, "auto", "auto", 1),
         "len2-cuda_step": (2, "cuda_step", "pallas_step", 0)}


def _tt(cls, length, backend):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend)


def _models(path):
    length, backend, jbackend, seed = PATHS[path]
    jm = jbuild(jget_config("deepseek_7b", "smoke",
                            tt=_tt(JTTConfig, length, jbackend)))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tget_config("deepseek_7b", "smoke",
                            tt=_tt(TTTConfig, length, backend)), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair2():
    return _models("len2-auto")


def _prompt(vocab, L, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, L),
                                                dtype=np.int64)


def _stack(cache, name):
    """The port's per-layer k or v arenas, stacked [L, nb+1, block, KV, hd]
    as the reference keeps them."""
    return torch.stack([layer["b0"][name] for layer in cache["g0"]])


def _to_port(jcache, tm) -> dict:
    """A reference cache (stacked layers; dense or paged) in the port's
    layout."""
    out = {k: torch.from_numpy(np.array(jcache[k]))
           for k in ("pos", "block_tables") if k in jcache}
    count = tm.groups[0][1]
    g = jcache["g0"]["b0"]
    out["g0"] = [{"b0": {n: torch.from_numpy(np.array(g[n][layer]))
                         for n in ("k", "v")}} for layer in range(count)]
    return out


# --------------------------------------------------------------------------
# The host side: allocator and hashes
# --------------------------------------------------------------------------

def _call(fn, *args):
    """``fn(*args)``'s result, or the type and message of what it raised."""
    try:
        return ("ok", fn(*args))
    except (RuntimeError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_allocator_walk_is_the_reference(seed):
    """One seeded walk of 400 ops on both allocators (ids drawn past the
    pool too, so the refusals are walked as well): the same results or
    errors, and ``state()`` equal after every op."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(2, 9))
    mine, ref = tpaging.BlockAllocator(nb, BLOCK), \
        jpaging.BlockAllocator(nb, BLOCK)
    for i in range(400):
        op = int(rng.integers(0, 8))
        bid = int(rng.integers(0, mine.num_blocks + 1))
        h = b"h%d" % int(rng.integers(0, 6))
        name, args = {0: ("alloc", ()), 1: ("incref", (bid,)),
                      2: ("decref", (bid,)), 3: ("publish", (bid, h)),
                      4: ("acquire", (h,)), 5: ("cow", (bid,)),
                      6: ("resize", (int(rng.integers(1, 11)),)),
                      7: ("finalize_shrink", ())}[op]
        got = _call(getattr(mine, name), *args)
        want = _call(getattr(ref, name), *args)
        assert got == want, (i, name, args)
        assert mine.state() == ref.state(), (i, name, args)
        assert (mine.available, mine.in_use, mine.capacity,
                mine.shrink_ready) == (ref.available, ref.in_use,
                                       ref.capacity, ref.shrink_ready)
    st = mine.state()
    assert tpaging.BlockAllocator.from_state(st).state() == \
        jpaging.BlockAllocator.from_state(st).state() == st


def test_chain_hashes_and_logical_blocks_are_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 3, 4, 15, 16, 33):
        toks = rng.integers(0, 1000, n)
        for block in (1, 4, 16):
            assert tpaging.chain_hashes(toks, block) == \
                jpaging.chain_hashes(toks.astype(np.int32), block)
            assert tpaging.logical_blocks(n, block) == \
                jpaging.logical_blocks(n, block)
    with pytest.raises(ValueError, match="n_tokens"):
        tpaging.logical_blocks(-1, 4)


# --------------------------------------------------------------------------
# The device side: paged decode, splice and resume
# --------------------------------------------------------------------------

def test_paged_decode_attention_matches_the_reference(pair2):
    """Layer 0's attention over random arenas of 9 + 1 blocks, tables with
    sentinel entries, rows at depths 6, 13 and 2, the middle one
    inactive."""
    jm, jp, tm, tp = pair2
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    arenas = [rng.standard_normal((10, BLOCK, cfg.num_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2)]
    bt = np.array([[0, 1, 9, 9], [2, 3, 4, 5], [6, 9, 9, 9]], np.int32)
    pos = np.array([6, 13, 2], np.int32)
    active = np.array([True, False, True])
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["g0"]["b0"]["attn"])
    jy, jk, jv = jattention.gqa_decode_attn_paged(
        jattn, jm.cfg, jnp.asarray(x), jnp.asarray(arenas[0]),
        jnp.asarray(arenas[1]), jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(active), backend=jm.plan_book)
    tk, tv = (torch.from_numpy(a.copy()) for a in arenas)
    index = tattention.paged_index(torch.from_numpy(bt), torch.from_numpy(pos),
                                   torch.from_numpy(active), BLOCK, 9)
    ty, tk2, tv2 = tattention.gqa_decode_attn_paged(
        tp["g0"][0]["b0"]["attn"], cfg, torch.from_numpy(x), tk, tv,
        torch.from_numpy(pos), index, backend=tm.plan_book)
    assert tk2 is tk and tv2 is tv                   # in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL_ATTN,
                               atol=TOL_ATTN)
    for got, want, old in ((tk, jk, arenas[0]), (tv, jv, arenas[1])):
        np.testing.assert_allclose(got[:9].numpy(), np.asarray(want)[:9],
                                   rtol=TOL_ATTN, atol=TOL_ATTN)
        # only (block 1, row 2) and (block 6, row 2) were written
        changed = np.argwhere((got.numpy() != old).any(axis=(2, 3)))
        assert sorted(map(tuple, changed.tolist())) == [(1, 2), (6, 2),
                                                        (9, 1)]


def test_splice_and_resume_match_the_reference(pair2):
    """A 16-token prompt spliced into slot 0's blocks 0–3 (the reference's
    row cache on both sides: bit for bit), then into slot 1 a prompt
    sharing its first 12 tokens resumed from position 12 through blocks
    [0, 1, 2, 6, 7, 8], then the first prompt again, fully covered:
    resumed from 15 with block 3 copied on write to 9.  Logits within
    1e-4, arenas within 1e-4 outside the sentinel and the free blocks,
    positions and tables equal."""
    jm, jp, tm, tp = pair2
    nb, T, S = 12, 24, 16
    sentinel = nb
    t0 = _prompt(jm.cfg.vocab_size, S, 7)
    t1 = np.concatenate([t0[:, :12], _prompt(jm.cfg.vocab_size, 4, 8)], 1)
    jpool = jm.init_cache(2, T, dtype=jnp.float32, paged=True, num_blocks=nb,
                          block=BLOCK)
    _, jrow = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(t0, jnp.int32)})
    table = np.array([0, 1, 2, 3, sentinel, sentinel], np.int32)
    jpool = jm.splice_cache_paged(jpool, jrow, 0, jnp.asarray(table))
    mine = tm.init_cache(2, T, paged=True, num_blocks=nb, block=BLOCK)
    assert mine["block_tables"].tolist() == [[sentinel] * 6] * 2
    tm.splice_cache_paged(mine, _to_port(jrow, tm), 0, torch.from_numpy(table))
    want = _to_port(jpool, tm)
    assert torch.equal(mine["pos"], want["pos"])
    assert torch.equal(mine["block_tables"], want["block_tables"])
    for name in ("k", "v"):
        assert torch.equal(_stack(mine, name)[:, :nb],
                           _stack(want, name)[:, :nb])
    live = {0, 1, 2, 3}
    for suffix, src, dst, start in (
            (t1[:, 12:], [0, 1, 2, 6, 7, 8], [0, 1, 2, 6, 7, 8], 12),
            (t0[:, 15:], [0, 1, 2, 3, sentinel, sentinel],
             [0, 1, 2, 9, sentinel, sentinel], 15)):
        live |= set(dst) - {sentinel}
        true_suf = suffix.shape[1]
        padded = np.pad(suffix, ((0, 0), (0, 16 - true_suf)))
        jl, jpool = jm.prefill_resume(
            jp, {"tokens": jnp.asarray(padded, jnp.int32)}, jpool, 1,
            jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32), start,
            true_suf)
        tl, got = tm.prefill_resume(
            tp, torch.from_numpy(padded), mine, 1,
            torch.tensor(src, dtype=torch.int32),
            torch.tensor(dst, dtype=torch.int32), start, true_suf)
        assert got is mine
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"start {start}")
        want = _to_port(jpool, tm)
        assert mine["pos"].tolist() == want["pos"].tolist() == \
            [S, start + true_suf]
        assert torch.equal(mine["block_tables"], want["block_tables"])
        assert mine["block_tables"][1].tolist() == dst
        for name in ("k", "v"):
            ids = sorted(live)
            np.testing.assert_allclose(
                _stack(mine, name)[:, ids].numpy(),
                _stack(want, name)[:, ids].numpy(), rtol=TOL, atol=TOL,
                err_msg=f"start {start} {name}")
    # the copy on write left block 3, the first prompt's, as it was
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            _stack(mine, name)[:, 3].numpy(),
            np.asarray(jrow["g0"]["b0"][name])[:, 0, 12:16])
    with pytest.raises(ValueError, match="table row of 6 blocks"):
        tm.splice_cache_paged(mine, _to_port(jrow, tm), 0,
                              torch.zeros(5, dtype=torch.int32))


def test_init_cache_paged_layout(pair2):
    _, _, tm, _ = pair2
    cache = tm.init_cache(2, 16, paged=True, block=BLOCK, num_blocks=6)
    cfg = tm.cfg
    assert cache["pos"].shape == (2,) and cache["pos"].dtype == torch.int32
    assert cache["block_tables"].tolist() == [[6] * 4] * 2
    for layer in cache["g0"]:
        for name in ("k", "v"):
            assert layer["b0"][name].shape == (7, BLOCK, cfg.num_kv_heads,
                                               cfg.head_dim)
            assert not layer["b0"][name].any()
    default = tm.init_cache(3, 10, paged=True, block=BLOCK)
    assert default["g0"][0]["b0"]["k"].shape[0] == 3 * 3 + 1
    assert tm.supports_prefix_reuse
    with pytest.raises(ValueError, match="masked only"):
        tm.graphed_decode_step(2, 16, paged=(6, BLOCK))


# --------------------------------------------------------------------------
# The paged scheduler against the reference's
# --------------------------------------------------------------------------

def _ref_gaps(jm, jp, tokens, steps, cache_len):
    """Assert the reference's top-1/top-2 logit gap of ``tokens [1, S]``
    decoded greedily alone exceeds ten times the tolerance at every step."""
    lg, cache = jm.jitted_prefill(cache_len)(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    step = jm.jitted_decode_step()
    for t in range(steps):
        lg = np.asarray(lg)[0, -1].astype(np.float64)
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] > 10 * TOL, (t, top2)
        if t + 1 < steps:
            lg, cache = step(jp, cache, jnp.asarray([[lg.argmax()]],
                                                    jnp.int32))


def _staggered(submit, step):
    """r0 (budget 6) is admitted and decodes one step, r1 (3) joins, r2 (5)
    queues until a slot frees (2 slots)."""
    for uid, budget in enumerate((6, 3, 5)):
        submit(uid, uid, budget)
        if uid < 2:
            step()


def _shared_prefix(submit, step):
    """r1 shares r0's first 12 tokens (3 blocks): refcount 2 on each while
    both live, the fourth block diverges."""
    submit(0, 0, 5)
    step()
    submit(1, 1, 5)
    step()


def _full_cover(submit, step):
    """The same 16-token prompt twice through one slot: the second covers
    all of it, copies its last block on write and recomputes one token."""
    submit(0, 0, 4)
    submit(1, 0, 4)


def _memory(submit, step):
    """Two slots, blocks for one request: the second waits in the queue
    until the first retires."""
    submit(0, 0, 4)
    submit(1, 1, 4)
    step()


# name → (driver, prompt lengths, prompts sharing r0's first 12 tokens,
# scheduler arguments, the counters expected)
SCHEDULES = {
    "staggered": (_staggered, (8, 8, 8), (), dict(num_slots=2, cache_len=16),
                  dict(prefix_hit_tokens=0, prefill_tokens_skipped=0)),
    "shared_prefix": (_shared_prefix, (16, 16), (1,),
                      dict(num_slots=2, cache_len=24),
                      dict(prefix_hit_tokens=12, prefill_tokens_skipped=12)),
    "full_cover": (_full_cover, (16,), (), dict(num_slots=1, cache_len=24),
                   dict(prefix_hit_tokens=16, prefill_tokens_skipped=15)),
    "memory": (_memory, (8, 8), (), dict(num_slots=2, cache_len=16,
                                         num_blocks=3, prefix_cache=False),
               dict(prefix_hit_tokens=0, block_high_water=3)),
}


def _prompts(vocab, lens, sharing, seed=40):
    rows = [_prompt(vocab, L, seed + i) for i, L in enumerate(lens)]
    for i in sharing:
        rows[i] = np.concatenate([rows[0][:, :12], rows[i][:, 12:]], 1)
    return rows


def _serve(sched, req_cls, rows, driver, to_tokens) -> dict:
    """Drive ``sched`` through ``driver`` then to the drain, step by step:
    the finished requests by uid, the slots' block ids after every step,
    the refcounts of slot 0's first 3 blocks and the queue's length after
    the driver, and the counters after the drain."""
    history = []

    def step():
        sched.step()
        history.append([None if b is None else list(b)
                        for b in sched._slot_blocks])

    def submit(uid, row, budget):
        sched.submit(req_cls(uid=uid, inputs={"tokens": to_tokens(rows[row])},
                             max_new_tokens=budget))

    driver(submit, step)
    held = [sched.allocator.refcount(b)
            for b in (sched._slot_blocks[0] or [])[:3]]
    queued = len(sched.queue)
    while not sched.idle:
        step()
    sched.allocator.assert_quiescent()
    st = sched.stats()
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "held": held, "queued": queued,
            "stats": {k: st[k] for k in STAT_NAMES}}


STAT_NAMES = ("blocks_in_use", "block_high_water", "prefix_hit_tokens",
              "prefix_prompt_tokens", "prefill_tokens_skipped", "num_blocks",
              "tokens_out", "steps_run")


@pytest.mark.parametrize("path,schedule", [
    ("len2-auto", "staggered"), ("len3-auto", "staggered"),
    ("len2-auto", "shared_prefix"), ("len2-auto", "full_cover"),
    ("len2-auto", "memory")])
def test_paged_scheduler_is_the_reference(path, schedule, pair2):
    jm, jp, tm, tp = pair2 if path == "len2-auto" else _models(path)
    driver, lens, sharing, kw, counters = SCHEDULES[schedule]
    rows = _prompts(jm.cfg.vocab_size, lens, sharing)
    sched = Scheduler(tm, tp, paged=True, block_size=BLOCK, **kw)
    plans0 = tplan.plan_resolutions()        # the constructor resolves all
    mine = _serve(sched, Request, rows, driver, torch.from_numpy)
    assert tplan.plan_resolutions() == plans0
    ref = _serve(JScheduler(jm, jp, paged=True, block_size=BLOCK, **kw),
                 JRequest, rows, driver, lambda r: jnp.asarray(r, jnp.int32))
    assert sorted(mine["done"]) == sorted(ref["done"])
    for key in ("history", "held", "queued", "stats"):
        assert mine[key] == ref[key], key
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
        assert f.finish_reason == want.finish_reason == "length"
        row = rows[0] if schedule == "full_cover" else rows[uid]
        _ref_gaps(jm, jp, row, len(f.tokens), kw["cache_len"])
    for k, v in counters.items():
        assert mine["stats"][k] == v, k
    if schedule == "shared_prefix":
        first, second = mine["history"][1][:2]
        assert mine["held"] == [2, 2, 2]
        assert first[:3] == second[:3] and first[3] != second[3]
    if schedule == "memory":
        assert mine["queued"] == 1 and mine["history"][0][1] is None


def test_oversized_request_refused_at_submit(pair2):
    jm, jp, tm, tp = pair2
    rows = _prompt(jm.cfg.vocab_size, 8, 0)
    sched = Scheduler(tm, tp, num_slots=1, cache_len=16, paged=True,
                      block_size=BLOCK, num_blocks=2)
    jsched = JScheduler(jm, jp, num_slots=1, cache_len=16, paged=True,
                        block_size=BLOCK, num_blocks=2)
    with pytest.raises(ValueError, match="needs 4 blocks of 4 tokens but "
                                         "the pool has only 2"):
        sched.submit(Request(uid=0, inputs={"tokens": torch.from_numpy(
            rows)}, max_new_tokens=8))
    with pytest.raises(ValueError, match="needs 4 blocks"):
        jsched.submit(JRequest(uid=0, inputs={"tokens": jnp.asarray(
            rows, jnp.int32)}, max_new_tokens=8))
    assert not sched.queue and not jsched.queue


def test_paged_generate_is_generate_fixed_and_the_reference(pair2):
    jm, jp, tm, tp = pair2
    prompts = np.concatenate([_prompt(jm.cfg.vocab_size, 8, 60 + i)
                              for i in range(3)])
    batch = {"tokens": torch.from_numpy(prompts), "cache_len": 16}
    res = generate(tm, tp, batch, 5, paged=True, block_size=BLOCK)
    fixed = generate_fixed(tm, tp, batch, 5)
    np.testing.assert_array_equal(res.tokens.numpy(), fixed.tokens.numpy())
    jres = jgenerate(jm, jp, {"tokens": jnp.asarray(prompts, jnp.int32),
                              "cache_len": 16}, steps=5, paged=True,
                     block_size=BLOCK)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_allclose(res.logprobs.numpy(), np.asarray(jres.logprobs),
                               rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# Within the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
def test_paged_is_dense_bit_for_bit(path, pair2):
    """The staggered schedule and a shared-prefix pair at a block-aligned
    cache, dense and paged (prefix hit included): every token and logprob
    bit for bit, no plan resolution."""
    _, _, tm, tp = pair2 if path == "len2-auto" else _models(path)
    rows = _prompts(tm.cfg.vocab_size, (8, 8, 8), ())
    rows += _prompts(tm.cfg.vocab_size, (16, 16), (1,), seed=50)
    tm.plan_book
    plans0 = tplan.plan_resolutions()
    outs = []
    for kw in ({}, {"paged": True, "block_size": BLOCK}):
        sched = Scheduler(tm, tp, num_slots=2, cache_len=24, **kw)
        for uid, row in enumerate(rows):
            sched.submit(Request(uid=uid, inputs={
                "tokens": torch.from_numpy(row)}, max_new_tokens=6 - uid))
            if uid % 2 == 0:
                sched.step()
        sched.run()
        outs.append({f.uid: f for f in sched.finished})
    assert sched.stats()["prefix_hit_tokens"] == 12
    assert tplan.plan_resolutions() == plans0
    dense, paged = outs
    assert sorted(dense) == sorted(paged) == list(range(5))
    for uid in dense:
        np.testing.assert_array_equal(paged[uid].tokens, dense[uid].tokens)
        np.testing.assert_array_equal(paged[uid].logprobs,
                                      dense[uid].logprobs)


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


def _no_host_read(ops):
    names = {op for op, _ in ops}
    assert not any("_local_scalar_dense" in n or "aten.item" in n
                   for n in names), sorted(names)


def test_paged_steps_and_resumes_dispatch_the_same_ops(pair2):
    """The bodies of the captured paged step and resume: two masked steps
    over a paged pool (rows at other depths and tables), and two resumes
    of one bucket (suffixes of 3 and 9 tokens from other starts, other
    slots and tables, device arguments) dispatch identical ops and read
    nothing on the host."""
    _, _, tm, tp = pair2
    pool = tm.init_cache(3, 24, paged=True, num_blocks=12, block=BLOCK)
    pool["block_tables"].copy_(torch.tensor(
        [[0, 1, 2, 12, 12, 12], [3, 4, 5, 6, 12, 12], [7, 12, 12, 12, 12, 12]],
        dtype=torch.int32))
    logs = []
    for pos, active in (([5, 13, 2], [True, True, False]),
                        ([6, 14, 2], [True, False, True])):
        pool["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
        with _OpLog() as log:
            tm.decode_step(tp, pool, torch.tensor([[3], [4], [5]]),
                           torch.tensor(active))
        logs.append(log.ops)
    assert len(logs[0]) > 100 and logs[0] == logs[1]
    _no_host_read(logs[0])
    logs = []
    for slot, start, true_suf, table in (
            (0, 8, 3, [0, 1, 2, 9, 12, 12]),
            (2, 12, 9, [7, 8, 10, 11, 6, 12])):
        tokens = torch.from_numpy(np.pad(
            _prompt(tm.cfg.vocab_size, true_suf, start),
            ((0, 0), (0, 16 - true_suf))))
        args = [torch.tensor(v, dtype=torch.int32)
                for v in (slot, table, table, start, true_suf)]
        with _OpLog() as log:
            tm.prefill_resume(tp, tokens, pool, args[0], args[1], args[2],
                              args[3], args[4])
        logs.append(log.ops)
        assert pool["pos"][slot] == start + true_suf
        assert pool["block_tables"][slot].tolist() == table
    assert len(logs[0]) > 100 and logs[0] == logs[1]
    _no_host_read(logs[0])


def test_resume_prefill_buckets_and_counts_its_entries(pair2):
    """``Model.resume_prefill`` pads the suffix to its bucket; on the CPU
    each (bucket, cache length) key is a prefill entry once."""
    _, _, tm, tp = pair2
    pool = tm.init_cache(1, 40, paged=True, num_blocks=10, block=BLOCK)
    table = torch.arange(10, dtype=torch.int32)
    builds = tm.prefill_builds
    for L in (3, 9, 16, 17):
        tokens = torch.from_numpy(_prompt(tm.cfg.vocab_size, L, L))
        logits = tm.resume_prefill(tp, pool, tokens, 0, table, table, 4)
        assert logits.shape == (1, 1, tm.cfg.vocab_size)
        assert int(pool["pos"][0]) == 4 + L
    assert tm.prefill_builds - builds == 2
    assert list(tm.eager_prefills)[-2:] == [("resume", 16, 40),
                                            ("resume", 32, 40)]


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

SMOKE_FLAGS = ["--variant", "smoke", "--device", "cpu", "--tt", "ffn,attn",
               "--tt-rank", "4", "--tt-backend", "auto", "--paged",
               "--block-size", str(BLOCK)]


def test_serve_cli_paged_arrival_mode_runs_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(SMOKE_FLAGS + ["--slots", "2", "--max-requests", "4",
                                    "--arrival-rate", "1000",
                                    "--prompt-len", "8", "--steps", "4",
                                    "--num-blocks", "5",
                                    "--assert-no-replan"])
    assert sorted(f.uid for f in out["finished"]) == [0, 1, 2, 3]
    assert all(len(f.tokens) == 4 and f.finish_reason == "length"
               for f in out["finished"])
    assert out["tokens_out"] == 16 and out["admissions"] == 4
    assert out["replans"] == out["captures"] == out["prefill_captures"] == 0
    assert out["num_blocks"] == 5 and out["block_size"] == BLOCK
    assert out["blocks_in_use"] == 0 and out["block_high_water"] <= 5
    assert out["kv_pool_bytes"] > 0


def test_serve_cli_prefix_smoke_runs_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(SMOKE_FLAGS + ["--prefix-smoke", "--prefix-len", "12",
                                    "--steps", "4"])
    assert out["shared_blocks"] == 3
    assert out["hits"] == [(0, 0), (12, 12), (28, 27)]
    assert out["cow"] and out["blocks_in_use"] == 0
    assert out["blocks"][2][:6] == out["blocks"][0][:6]
    assert out["blocks"][2][6] != out["blocks"][0][6]
    assert sorted(out["finished"]) == [0, 1, 2]
    np.testing.assert_array_equal(out["finished"][0].tokens,
                                  out["finished"][2].tokens)
    assert all(g["identical"] and g["gap"] > g["tol"]
               for g in out["greedy"].values())
    with pytest.raises(SystemExit, match="needs --paged"):
        serve.main(SMOKE_FLAGS[:-3] + ["--prefix-smoke", "--steps", "2"])
