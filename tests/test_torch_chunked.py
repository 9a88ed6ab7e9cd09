"""Chunked prefill inside the decode step, the port's ``Model.chunk_step``,
``mixed_step`` and ``copy_blocks`` and the ``Scheduler``'s chunk state
machine, on the CPU against the reference (as the reference's
``tests/test_chunked.py``, block 4).

deepseek-7b SMOKE (TT on ffn+attn, rank 4, fp32 cores and parameters)
through both packages, the reference's weights carried into the port by
``convert.from_jax_params`` and the prompts drawn with numpy from a seed;
the reference's Pallas kernels run in interpret mode.

- ``chunk_step`` and ``mixed_step`` against the reference's, dense and
  paged: logits within 1e-4, caches within 1e-5, positions and tables
  equal; an inactive lane leaves its row as it was; ``copy_blocks`` bit
  for bit.
- The chunked ``Scheduler`` against the reference's on the three paths,
  both pools, on a schedule with a prefix hit and a full cover: tokens
  identical, logprobs within 1e-4, the same block ids per slot after
  every step and the same counters.  At every step the reference's
  top-1/top-2 gap of each request alone exceeds ten times 1e-4, asserted.
- Within the port: chunked ≡ monolithic token for token at chunk sizes
  {1, block − 1, block, prompt}, under seeded sampling, with two lanes,
  with prefix reuse and a full-cover copy on write; a cancel mid-prefill
  leaks nothing; submit-time refusals; no plan resolution.
- Two mixed steps with other lane values dispatch identical ops and read
  nothing on the host (the body of the captured ``MixedGraph``).
- The serve CLI's ``--chunk-prefill`` arrival mode and prefix smoke.

The captured mixed step against the eager one needs a card:
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import plan as tplan
from repro_torch.serving.scheduler import Request, Scheduler
from test_torch_paging import _OpLog, _no_host_read, _stack, _to_port

TOL = 1e-4          # port against the reference (logits, logprobs)
TOL_CACHE = 1e-5    # caches, port against the reference
BLOCK = 4
PROMPT = 13         # not a multiple of the block
# (TT length, port backend, reference backend, weight seed)
PATHS = {"len2-auto": (2, "auto", "auto", 0),
         "len3-auto": (3, "auto", "auto", 1),
         "len2-cuda_step": (2, "cuda_step", "pallas_step", 0)}


def _tt(cls, length, backend):
    return cls(enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
               length=length, backend=backend)


_built: dict = {}


def _models(path):
    if path not in _built:
        length, backend, jbackend, seed = PATHS[path]
        jm = jbuild(jget_config("deepseek_7b", "smoke",
                                tt=_tt(JTTConfig, length, jbackend)))
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = tbuild(tget_config("deepseek_7b", "smoke",
                                tt=_tt(TTTConfig, length, backend)),
                    device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[path] = (jm, jp, tm, tp)
    return _built[path]


def _prompt(vocab, L, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, L),
                                                dtype=np.int64)


def _dense_to_port(jcache, tm) -> dict:
    """A reference dense pool (stacked layers) in the port's layout."""
    out = {"pos": torch.from_numpy(np.array(jcache["pos"]))}
    g = jcache["g0"]["b0"]
    out["g0"] = [{"b0": {n: torch.from_numpy(np.array(g[n][layer]))
                         for n in ("k", "v")}}
                 for layer in range(tm.groups[0][1])]
    return out


# --------------------------------------------------------------------------
# The model: chunk_step, mixed_step, copy_blocks
# --------------------------------------------------------------------------

NB, T = 12, 24
SENTINEL = NB


def _pools(jm, jp, tm, paged):
    """Both sides' 3-slot pools over 24 positions with an 8-token prompt in
    slot 0 (blocks 0, 1 when paged), the reference's row spliced on both
    sides: (reference pool, port pool, slot 0's first token)."""
    row_toks = _prompt(jm.cfg.vocab_size, 8, 70)
    lg, jrow = jm.jitted_prefill(T)(jp, {"tokens": jnp.asarray(row_toks,
                                                               jnp.int32)})
    if paged:
        jpool = jm.init_cache(3, T, dtype=jnp.float32, paged=True,
                              num_blocks=NB, block=BLOCK)
        table = np.array([0, 1, 2, 3, SENTINEL, SENTINEL], np.int32)
        jpool = jm.splice_cache_paged(jpool, jrow, 0, jnp.asarray(table))
        mine = tm.init_cache(3, T, paged=True, num_blocks=NB, block=BLOCK)
        tm.splice_cache_paged(mine, _to_port(jrow, tm), 0,
                              torch.from_numpy(table))
    else:
        jpool = jm.init_cache(3, T, dtype=jnp.float32)
        jpool = dict(jpool, pos=jnp.zeros((3,), jnp.int32))
        jpool = jm.splice_cache(jpool, jrow, 0)
        mine = tm.init_cache(3, T, per_row=True)
        tm.splice_cache(mine, _dense_to_port(jrow, tm), 0)
    return jpool, mine, int(np.asarray(lg)[0, -1].argmax())


def _same_caches(tm, mine, jpool, paged, what):
    want = (_to_port if paged else _dense_to_port)(jpool, tm)
    assert torch.equal(mine["pos"], want["pos"]), what
    if paged:
        assert torch.equal(mine["block_tables"], want["block_tables"]), what
    for name in ("k", "v"):
        got, ref = _stack(mine, name), _stack(want, name)
        if paged:
            got, ref = got[:, :SENTINEL], ref[:, :SENTINEL]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL_CACHE,
                                   atol=TOL_CACHE, err_msg=f"{what} {name}")


def _lanes(rows, paged, K=2, C=BLOCK):
    """Lane arrays for (slot, prompt, start, true length, table) rows; the
    lanes past them inactive (slot 0, start 0, true length 1, tables all
    sentinel)."""
    tok = np.zeros((K, C), np.int64)
    slot = np.zeros((K,), np.int32)
    start = np.zeros((K,), np.int32)
    true = np.ones((K,), np.int32)
    active = np.zeros((K,), bool)
    tables = np.full((K, T // BLOCK), SENTINEL, np.int32)
    for j, (s, prompt, st, n, table) in enumerate(rows):
        tok[j, :n] = prompt[0, st:st + n]
        slot[j], start[j], true[j], active[j] = s, st, n, True
        tables[j, :len(table)] = table
    return tok, slot, start, true, active, (tables if paged else None)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunk_and_mixed_steps_match_the_reference(paged):
    """Slot 0 holds an 8-token prompt and decodes; a chunk of 4 of a
    7-token prompt into slot 1 (``chunk_step``); then a mixed step of two
    lanes (slot 1's last 3 tokens, padded, and slot 2's first chunk) with
    slot 0's decode; then one with slot 2's rest, an inactive lane, and
    slots 0 and 1 decoding.  Logits within 1e-4, caches within 1e-5, an
    inactive lane changes nothing (paged: its sentinel table)."""
    jm, jp, tm, tp = _models("len2-auto")
    jpool, mine, first = _pools(jm, jp, tm, paged)
    p1 = _prompt(jm.cfg.vocab_size, 7, 71)
    p2 = _prompt(jm.cfg.vocab_size, 6, 72)
    t1, t2 = [4, 5], [6, 7]
    # chunk_step alone: slot 1, tokens 0-3
    tok, slot, start, true, active, tables = _lanes(
        [(1, p1, 0, 4, t1)], paged, K=1)
    jt = None if tables is None else jnp.asarray(tables[0])
    jl, jpool = jm.chunk_step(jp, jpool, jnp.asarray(tok, jnp.int32), 1, 0, 4,
                              jnp.asarray(True), table=jt)
    tl, got = tm.chunk_step(tp, mine, torch.from_numpy(tok), 1, 0, 4, True,
                            None if tables is None
                            else torch.from_numpy(tables[0]))
    assert got is mine
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _same_caches(tm, mine, jpool, paged, "chunk_step")
    assert int(mine["pos"][1]) == 4
    # two mixed steps
    decode_tok = np.array([[first], [0], [0]], np.int64)
    for step, (lanes, act) in enumerate((
            ([(1, p1, 4, 3, t1), (2, p2, 0, 4, t2)], [True, False, False]),
            ([(2, p2, 4, 2, t2)], [True, True, False]))):
        arrays = _lanes(lanes, paged)
        act = np.array(act)
        jargs = [jnp.asarray(a, jnp.int32 if a.dtype != bool else bool)
                 for a in arrays[:5]]
        if paged:
            jargs.append(jnp.asarray(arrays[5]))
        jdl, jcl, jpool = jm.mixed_step(
            jp, jpool, jnp.asarray(decode_tok, jnp.int32), jnp.asarray(act),
            *jargs)
        before = [_stack(mine, n)[:, 0].clone() for n in ("k", "v")]
        tdl, tcl, mine = tm.mixed_step(
            tp, mine, torch.from_numpy(decode_tok), torch.from_numpy(act),
            *[None if a is None else torch.from_numpy(a) for a in arrays])
        np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), rtol=TOL,
                                   atol=TOL, err_msg=f"decode {step}")
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), rtol=TOL,
                                   atol=TOL, err_msg=f"chunks {step}")
        assert tcl.shape == (2, jm.cfg.vocab_size)
        _same_caches(tm, mine, jpool, paged, f"mixed step {step}")
        if not paged:
            # slot 0 decodes at position 8 + step; nothing else in its row
            # moved (the inactive lane of step 1 points at it too)
            for old, n in zip(before, ("k", "v")):
                new = _stack(mine, n)[:, 0]
                keep = torch.ones(T, dtype=torch.bool)
                keep[8 + step] = False
                assert torch.equal(new[:, keep], old[:, keep]), n
        decode_tok = tdl[:, -1].argmax(-1, keepdim=True).numpy()
    assert mine["pos"].tolist() == [10, 8, 6]


def test_copy_blocks_is_the_reference():
    jm, jp, tm, tp = _models("len2-auto")
    jpool, mine, _ = _pools(jm, jp, tm, paged=True)
    want = jm.copy_blocks(jpool, jnp.asarray(1, jnp.int32),
                          jnp.asarray(9, jnp.int32))
    tm.copy_blocks(mine, 1, 9)
    ref = _to_port(want, tm)
    for name in ("k", "v"):
        assert torch.equal(_stack(mine, name), _stack(ref, name))
        assert torch.equal(_stack(mine, name)[:, 9], _stack(mine, name)[:, 1])
    assert tm.supports_chunked_prefill


# --------------------------------------------------------------------------
# The chunked scheduler against the reference's
# --------------------------------------------------------------------------

def _ref_gaps(jm, jp, tokens, steps, cache_len):
    """Assert the reference's top-1/top-2 logit gap of ``tokens [1, S]``
    decoded greedily alone exceeds ten times the tolerance at every
    step."""
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


# r0 (13 tokens), after its prefill r1 (sharing its first 8) and r2, which
# queues (2 slots); after the drain r0's first 12 tokens (paged: a full
# cover of 3 blocks, the last copied on write)
SCHED_SEED = 80
BUDGETS = (6, 3, 5, 4)
STAT_NAMES = ("tokens_out", "steps_run", "prefill_chunks", "chunk_lanes",
              "blocks_in_use", "block_high_water", "prefix_hit_tokens",
              "prefix_prompt_tokens", "prefill_tokens_skipped")


def _sched_prompts(vocab):
    rows = [_prompt(vocab, PROMPT, SCHED_SEED + i) for i in range(3)]
    rows[1][:, :8] = rows[0][:, :8]
    return rows + [rows[0][:, :12]]


def _serve(sched, req_cls, rows, to_tokens) -> dict:
    history = []

    def step():
        sched.step()
        history.append([None if s is None else (
            s.uid, s.prefill_pos, list(sched._slot_blocks[i])
            if sched.paged else None) for i, s in enumerate(sched.slots)])

    def submit(uid):
        sched.submit(req_cls(uid=uid, inputs={"tokens": to_tokens(rows[uid])},
                             max_new_tokens=BUDGETS[uid]))

    submit(0)
    for _ in range(4):                     # 13 tokens in chunks of 4
        step()
    submit(1)
    submit(2)
    while not sched.idle:
        step()
    submit(3)
    while not sched.idle:
        step()
    if sched.paged:
        sched.allocator.assert_quiescent()
    st = sched.stats()
    return {"done": {f.uid: f for f in sched.finished}, "history": history,
            "stats": {k: st[k] for k in STAT_NAMES if k in st}}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("path", list(PATHS))
def test_chunked_scheduler_is_the_reference(path, paged):
    jm, jp, tm, tp = _models(path)
    rows = _sched_prompts(jm.cfg.vocab_size)
    kw = dict(num_slots=2, cache_len=32, chunk_prefill=True,
              chunk_size=BLOCK, prefill_budget=2 * BLOCK)
    if paged:
        kw.update(paged=True, block_size=BLOCK)
    sched = Scheduler(tm, tp, **kw)
    plans0 = tplan.plan_resolutions()
    mine = _serve(sched, Request, rows, torch.from_numpy)
    assert tplan.plan_resolutions() == plans0
    ref = _serve(JScheduler(jm, jp, **kw), JRequest, rows,
                 lambda r: jnp.asarray(r, jnp.int32))
    assert sorted(mine["done"]) == sorted(ref["done"]) == [0, 1, 2, 3]
    assert mine["history"] == ref["history"]
    assert mine["stats"] == ref["stats"]
    for uid, f in mine["done"].items():
        want = ref["done"][uid]
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)
        assert f.finish_reason == want.finish_reason == "length"
        _ref_gaps(jm, jp, rows[uid], len(f.tokens), 32)
    assert mine["stats"]["chunk_lanes"] == 2
    if paged:
        # r1's 8 shared tokens and r3's full cover (11 of 12 skipped)
        assert mine["stats"]["prefix_hit_tokens"] == 8 + 12
        assert mine["stats"]["prefill_tokens_skipped"] == 8 + 11


# --------------------------------------------------------------------------
# Within the port
# --------------------------------------------------------------------------

def _run(tm, tp, prompts, *, budgets=None, temperature=0.0, top_k=0,
         **kw):
    sched = Scheduler(tm, tp, num_slots=3, cache_len=32, **kw)
    for uid, tokens in enumerate(prompts):
        sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                             max_new_tokens=6 if budgets is None
                             else budgets[uid],
                             temperature=temperature, top_k=top_k))
    out = sched.run()
    if sched.paged:
        sched.allocator.assert_quiescent()
    return out, sched


def _three(vocab):
    return [torch.from_numpy(_prompt(vocab, PROMPT, 90 + i))
            for i in range(3)]


def _same_tokens(a, b):
    assert sorted(a) == sorted(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid].tokens, b[uid].tokens,
                                      err_msg=f"uid {uid}")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("chunk", [1, BLOCK - 1, BLOCK, PROMPT])
def test_chunked_is_monolithic(chunk, paged):
    """Chunk sizes {1, block - 1, block, prompt}: every token the
    monolithic admission's, no plan resolution, one chunk lane per
    step."""
    _, _, tm, tp = _models("len2-auto")
    prompts = _three(tm.cfg.vocab_size)
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    ref, _ = _run(tm, tp, prompts, **kw)
    plans0 = tplan.plan_resolutions()
    got, sched = _run(tm, tp, prompts, chunk_prefill=True, chunk_size=chunk,
                      **kw)
    assert tplan.plan_resolutions() == plans0
    _same_tokens(ref, got)
    st = sched.stats()
    assert st["prefill_chunks"] == 3 * -(-PROMPT // chunk)
    assert st["chunk_lanes"] == 1 and st["mixed_steps"] == 3 * -(-PROMPT //
                                                                  chunk)
    assert st["admissions"] == 0
    assert all(f.first_token_time is not None for f in got.values())


@pytest.mark.parametrize("weights", ["fp32", "int8"])
@pytest.mark.parametrize("path", list(PATHS))
def test_chunked_is_monolithic_on_every_path(path, weights):
    """The three TT paths with fp32 and int8 cores, two lanes of a block
    over the paged pool: every token the monolithic admission's."""
    length, backend, _, seed = PATHS[path]
    tm = tbuild(tget_config("deepseek_7b", "smoke", tt=TTTConfig(
        enabled=True, families=("ffn", "attn"), rank=4, min_factor=2,
        length=length, backend=backend, weights=weights)), device="cpu")
    tp = tm.init(seed)
    if weights == "int8":
        tp = tm.quantize_params(tp)
    prompts = _three(tm.cfg.vocab_size)
    kw = dict(paged=True, block_size=BLOCK)
    ref, _ = _run(tm, tp, prompts, **kw)
    got, sched = _run(tm, tp, prompts, chunk_prefill=True, chunk_size=BLOCK,
                      prefill_budget=2 * BLOCK, **kw)
    _same_tokens(ref, got)
    assert sched.stats()["prefill_chunks"] == 3 * 4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_seeded_sampling_is_monolithic(paged):
    """Temperature 0.8, top-k 5, each request drawing from its own stream:
    the chunk completion draws once, as the admission does, and slots
    mid-prefill draw nothing, so the tokens are the monolithic run's."""
    _, _, tm, tp = _models("len2-auto")
    prompts = _three(tm.cfg.vocab_size)
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    ref, _ = _run(tm, tp, prompts, temperature=0.8, top_k=5, **kw)
    got, _ = _run(tm, tp, prompts, temperature=0.8, top_k=5,
                  chunk_prefill=True, chunk_size=BLOCK, **kw)
    _same_tokens(ref, got)
    greedy, _ = _run(tm, tp, prompts, **kw)
    assert any(not np.array_equal(greedy[u].tokens, got[u].tokens)
               for u in got)


@pytest.mark.parametrize("budget,lanes", [(3, 1), (4, 1), (8, 2), (12, 3)])
def test_prefill_budget_sets_the_lanes(budget, lanes):
    """``chunk_lanes`` = max(1, budget // chunk); more lanes prefill the
    three prompts in fewer mixed steps, token for token the same."""
    _, _, tm, tp = _models("len2-auto")
    prompts = _three(tm.cfg.vocab_size)
    ref, _ = _run(tm, tp, prompts)
    got, sched = _run(tm, tp, prompts, chunk_prefill=True, chunk_size=BLOCK,
                      prefill_budget=budget, paged=True, block_size=BLOCK)
    _same_tokens(ref, got)
    st = sched.stats()
    assert st["chunk_lanes"] == lanes and st["prefill_budget"] == budget
    assert st["prefill_chunks"] == 3 * 4
    assert st["mixed_steps"] == -(-3 // lanes) * 4


def test_chunked_prefix_reuse_and_full_cover(monkeypatch):
    """One slot: a 12-token prompt, the same prompt again (a full cover:
    its last block copied on write, eagerly, and one token recomputed),
    then one sharing its first 8 tokens; tokens and prefix counters the
    monolithic paged run's, the covered chunks skipped, no block
    leaked."""
    _, _, tm, tp = _models("len2-auto")
    first = _prompt(tm.cfg.vocab_size, 12, 95)
    third = first.copy()
    third[0, 8:] = _prompt(tm.cfg.vocab_size, 4, 96)
    prompts = [torch.from_numpy(p) for p in (first, first, third)]
    copies = []
    real = type(tm).copy_blocks

    def spy(self, cache, src, dst):
        copies.append((src, dst))
        return real(self, cache, src, dst)

    monkeypatch.setattr(type(tm), "copy_blocks", spy)
    kw = dict(paged=True, block_size=BLOCK, prefix_cache=True)
    outs = []
    for chunked in (False, True):
        sched = Scheduler(tm, tp, num_slots=1, cache_len=32,
                          chunk_prefill=chunked, chunk_size=BLOCK, **kw)
        for uid, tokens in enumerate(prompts):
            sched.submit(Request(uid=uid, inputs={"tokens": tokens},
                                 max_new_tokens=5))
        outs.append((sched.run(), sched.stats()))
        sched.allocator.assert_quiescent()
    (ref, ref_st), (got, st) = outs
    _same_tokens(ref, got)
    for k in ("prefix_hit_tokens", "prefix_prompt_tokens",
              "prefill_tokens_skipped"):
        assert st[k] == ref_st[k], k
    assert st["prefix_hit_tokens"] == 12 + 8
    assert st["prefill_tokens_skipped"] == 11 + 8
    # 3 chunks, then 1 (the recomputed token), then 1 (tokens 8-11)
    assert st["prefill_chunks"] == 3 + 1 + 1
    assert len(copies) == 1 and copies[0][0] != copies[0][1]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cancel_mid_prefill_frees_the_slot_and_blocks(paged):
    _, _, tm, tp = _models("len2-auto")
    prompts = _three(tm.cfg.vocab_size)
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    sched = Scheduler(tm, tp, num_slots=1, cache_len=32, chunk_prefill=True,
                      chunk_size=BLOCK, **kw)
    sched.submit(Request(uid=0, inputs={"tokens": prompts[0]},
                         max_new_tokens=6))
    sched.step()
    assert sched.slots[0].prefill_pos == BLOCK
    if paged:
        assert sched.allocator.in_use == 5
    assert sched.cancel(0)
    assert sched.slots == [None] and sched.finished[-1].finish_reason == \
        "cancelled" and len(sched.finished[-1].tokens) == 0
    if paged:
        sched.allocator.assert_quiescent()
    sched.submit(Request(uid=1, inputs={"tokens": prompts[1]},
                         max_new_tokens=6))
    got = sched.run()
    ref, _ = _run(tm, tp, prompts[1:2], **kw)
    np.testing.assert_array_equal(got[1].tokens, ref[0].tokens)
    assert sched.stats()["prefill_chunks"] == 1 + 4


def test_chunked_submit_and_constructor_refusals(monkeypatch):
    _, _, tm, tp = _models("len2-auto")
    prompt = torch.from_numpy(_prompt(tm.cfg.vocab_size, 12, 0))
    for kw in ({}, {"paged": True, "block_size": BLOCK}):
        sched = Scheduler(tm, tp, num_slots=1, cache_len=16,
                          chunk_prefill=True, chunk_size=BLOCK, **kw)
        with pytest.raises(ValueError, match="cache_len"):
            sched.submit(Request(uid=0, inputs={"tokens": prompt},
                                 max_new_tokens=5))
        with pytest.raises(ValueError, match="max_new_tokens"):
            sched.submit(Request(uid=0, inputs={"tokens": prompt},
                                 max_new_tokens=-1))
        sched.submit(Request(uid=1, inputs={"tokens": prompt},
                             max_new_tokens=4))
        assert len(sched.run()[1].tokens) == 4
    sched = Scheduler(tm, tp, num_slots=1, cache_len=64, paged=True,
                      block_size=BLOCK, num_blocks=4, chunk_prefill=True,
                      chunk_size=BLOCK)
    with pytest.raises(ValueError, match="blocks"):
        sched.submit(Request(uid=0, inputs={"tokens": prompt},
                             max_new_tokens=8))
    with pytest.raises(ValueError, match="chunk_size"):
        Scheduler(tm, tp, num_slots=1, cache_len=16, chunk_prefill=True,
                  chunk_size=0)
    monkeypatch.setattr(type(tm), "supports_chunked_prefill",
                        property(lambda self: False))
    with pytest.raises(ValueError, match="chunked prefill"):
        Scheduler(tm, tp, num_slots=1, cache_len=16, chunk_prefill=True)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_steps_dispatch_the_same_ops(paged):
    """The body of the captured mixed step: two mixed steps (two lanes of 4
    over other slots, starts, lengths and tables, one lane inactive in the
    second; other decode rows) dispatch identical ops and read nothing on
    the host."""
    _, _, tm, tp = _models("len2-auto")
    pool = (tm.init_cache(3, T, paged=True, num_blocks=NB, block=BLOCK)
            if paged else tm.init_cache(3, T, per_row=True))
    pool["pos"].copy_(torch.tensor([9, 0, 0], dtype=torch.int32))
    p = _prompt(tm.cfg.vocab_size, 8, 3)
    logs = []
    for lanes, act in (([(1, p, 0, 4, [4, 5]), (2, p, 0, 3, [6, 7])],
                        [True, False, False]),
                       ([(2, p, 3, 4, [6, 7])], [False, True, False])):
        arrays = [None if a is None else torch.from_numpy(a)
                  for a in _lanes(lanes, paged)]
        with _OpLog() as log:
            _, _, pool = tm.mixed_step(tp, pool, torch.tensor([[3], [4], [5]]),
                                       torch.tensor(act), *arrays)
        logs.append(log.ops)
    assert len(logs[0]) > 100 and logs[0] == logs[1]
    _no_host_read(logs[0])
    assert pool["pos"].tolist() == [10, 5, 7]


# --------------------------------------------------------------------------
# The serve CLI
# --------------------------------------------------------------------------

SMOKE_FLAGS = ["--variant", "smoke", "--device", "cpu", "--tt", "ffn,attn",
               "--tt-rank", "4", "--tt-backend", "auto", "--chunk-prefill"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serve_cli_chunked_arrival_mode_runs_on_cpu(paged):
    from repro_torch.launch import serve
    flags = ["--paged", "--block-size", str(BLOCK)] if paged else []
    out = serve.main(SMOKE_FLAGS + flags + [
        "--slots", "2", "--max-requests", "4", "--arrival-rate", "1000",
        "--prompt-len", "8", "--steps", "4", "--chunk-size", "4",
        "--prefill-budget", "8", "--assert-no-replan"])
    assert sorted(f.uid for f in out["finished"]) == [0, 1, 2, 3]
    assert all(len(f.tokens) == 4 for f in out["finished"])
    assert out["prefill_chunks"] == 4 * 2 and out["chunk_lanes"] == 2
    assert out["admissions"] == 0 and out["mixed_steps"] > 0
    assert out["replans"] == out["captures"] == out["prefill_captures"] == 0
    if paged:
        assert out["blocks_in_use"] == 0


def test_serve_cli_chunked_prefix_smoke_runs_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(SMOKE_FLAGS + ["--paged", "--block-size", str(BLOCK),
                                    "--prefix-smoke", "--prefix-len", "12",
                                    "--steps", "4", "--chunk-size", "8"])
    assert out["shared_blocks"] == 3
    assert out["hits"] == [(0, 0), (12, 12), (28, 27)]
    # 28 tokens in chunks of 8: 4 chunks; the hit 16 tokens, 2; the full
    # cover 1 token, 1
    assert out["chunks"] == [4, 2, 1]
    assert out["cow"] and out["blocks_in_use"] == 0
    assert all(g["identical"] for g in out["greedy"].values())
