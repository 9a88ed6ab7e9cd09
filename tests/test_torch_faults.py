"""The request lifecycle of the port's scheduler (``serving.scheduler``:
preemption, deadlines, live resize, snapshots) and its fault harness
(``serving.faults``) on the CPU against the reference.

SMOKE models through both packages, the reference's weights carried into
the port by ``convert.from_jax_params`` (jamba's: the port's ``init(0)``
stacked into the reference's layout, its own init being slow), each
built once per module; TT at rank 4, ``auto`` backend (deepseek-7b and
qwen3-32b on ffn+attn, mamba2-2.7b and jamba-v0.1-52b on ffn).  Greedy
requests (prompts of 8 tokens drawn with numpy from a seed, 6 new
tokens, the last at priority 2), the same explicit ``FaultPlan`` and the
same arrival steps on the step clock in both packages:

- ``run_with_faults`` under allocation failures, a hold, a cancel, a live
  resize (2 → 3 slots, paged 10 → 14 blocks), a restart, a deadline of 3
  steps on uid 0 and a late high-priority arrival that preempts (two
  victims paged):
  deepseek-7b over the dense, paged and chunked pools (chunks of 2, one
  lane, a victim preempted mid-prefill), qwen3-32b, mamba2-2.7b and
  jamba-v0.1-52b paged (the reference's ``PAGED_ARCHS`` that the port
  serves with a paged pool of arenas or 'slot' leaves).  The same finished
  uids, finish reasons and tokens (a deadline's partial ones included),
  logprobs within 1e-4, the same steps, restarts, preemptions, cancels
  and expiries; inside each package the survivors equal its
  uninterrupted run, no block leaks, no plan resolves.
- A snapshot at step 4 (paged, and chunked mid-prefill): queue, slots
  (tokens, positions, chunk cursors), block ids, the allocator's
  ``state()`` and the counters equal the reference's, every pool leaf
  within 1e-5 of it after conversion; restored from memory and from disk
  (through ``save_snapshot``/``load_snapshot``) the streams continue to the
  reference's tokens.
- A ``kill -9`` at step 3 recovered from the durable store (a snapshot
  every 2 steps, journal replay), deepseek-7b and jamba paged: the
  reference's survivors, tokens and counters.
- Preemption never livelocks: equal priorities never preempt.
- A resize moves the pool bit for bit: grow and drained shrink of slots
  and blocks against the reference's pool, stale table ids collapsed on
  the new sentinel; ``close`` releases a bound graph, and ``bind`` still
  refuses a live holder with active rows.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.serving import faults as jfaults
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.models.graph import DecodeGraph
from repro_torch.models.spec import tree_leaves
from repro_torch.serving import faults
from repro_torch.serving.scheduler import Request, Scheduler

TOL = 1e-4          # logprobs, port against the reference
TOL_CACHE = 1e-5    # pool leaves (fp32)
S, STEPS, BLOCK = 8, 6, 4
CACHE = S + STEPS + 2
ARRIVALS = [0, 0, 1, 2, 4]
FAMS = {"deepseek_7b": ("ffn", "attn"), "qwen3_32b": ("ffn", "attn"),
        "mamba2_2p7b": ("ffn",), "jamba_v0_1_52b": ("ffn",)}
# the reference's PAGED_ARCHS (tests/test_faults.py) that the port serves
PLAN = dict(alloc_fail_steps=frozenset({2, 5}), hold_steps=frozenset({4}),
            cancels=((3, 1),), restart_steps=frozenset({6}))
# each pool's scheduler flags and its resize (step, slots, blocks), after
# the late arrival (step 4), which finds every slot busy and preempts
MODES = {"dense": dict(paged=False, resize=(6, 3, None)),
         "paged": dict(paged=True, resize=(6, 3, 14)),
         "chunked": dict(paged=True, chunk_prefill=True, chunk_size=2,
                         resize=(6, 3, 14))}
CASES = [("deepseek_7b", m) for m in MODES] + [
    (a, "paged") for a in ("qwen3_32b", "mamba2_2p7b", "jamba_v0_1_52b")]

_built: dict = {}


def _stacked(params: dict) -> dict:
    """The port's parameter tree in the reference's layout: each group's
    per-layer dicts stacked on a leading layer axis."""
    def leaf(*ts):
        return jnp.asarray(np.stack([t.numpy() for t in ts]))
    return {k: jax.tree.map(leaf, *v) if isinstance(v, list) else
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
            for k, v in params.items()}


def _models(arch):
    """(reference model, its params, port model, its params)."""
    if arch not in _built:
        def tt(cls):
            return cls(enabled=True, families=FAMS[arch], rank=4,
                       min_factor=2, backend="auto")
        jm = jbuild(jget_config(arch, "smoke", tt=tt(JTTConfig)))
        tm = tbuild(tget_config(arch, "smoke", tt=tt(TTTConfig)),
                    device="cpu")
        if arch == "jamba_v0_1_52b":
            jp = _stacked(tm.init(0))
        else:
            jp = jm.init(jax.random.PRNGKey(0))
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[arch] = (jm, jp, tm, tp)
    return _built[arch]


def _prompts(n=5, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, S),
                                                dtype=np.int64)


def _requests(n=5, deadline=True):
    """(port requests, reference requests): greedy, the last at priority
    2, uid 0 with a TTL of 3 steps."""
    rows = _prompts(n)
    mine, ref = [], []
    for u in range(n):
        kw = dict(uid=u, max_new_tokens=STEPS,
                  priority=2 if u == n - 1 else 0,
                  deadline_s=3.0 if deadline and u == 0 else None)
        mine.append(Request(inputs={"tokens": torch.from_numpy(
            rows[u:u + 1])}, **kw))
        ref.append(JRequest(inputs={"tokens": jnp.asarray(
            rows[u:u + 1], jnp.int32)}, **kw))
    return mine, ref


def _kw(mode, **over):
    m = dict(MODES[mode])
    m.pop("resize")
    kw = dict(num_slots=2, cache_len=CACHE, block_size=BLOCK,
              num_blocks=10, **m)
    if not kw["paged"]:
        del kw["num_blocks"]
    kw.update(over)
    return kw


def _same_outcomes(mine: dict, ref: dict) -> None:
    assert sorted(mine) == sorted(ref)
    for u, f in mine.items():
        want = ref[u]
        assert f.finish_reason == want.finish_reason, u
        np.testing.assert_array_equal(f.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(f.logprobs, np.asarray(want.logprobs),
                                   rtol=TOL, atol=TOL)


@pytest.fixture
def victims(monkeypatch):
    """Every preempted slot of the port's schedulers: (uid, its chunk
    cursor, None once it decodes)."""
    seen = []
    real = Scheduler._preempt

    def spy(self, i):
        seen.append((self.slots[i].uid, self.slots[i].prefill_pos))
        return real(self, i)
    monkeypatch.setattr(Scheduler, "_preempt", spy)
    return seen


@pytest.mark.parametrize("arch,mode", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_fault_plan_matches_the_reference(arch, mode, victims):
    """The reference's fault gate, run by both packages on the same plan:
    the same outcomes, counters and survivors."""
    jm, jp, tm, tp = _models(arch)
    mine_reqs, ref_reqs = _requests()
    plan = dict(PLAN, resizes=(MODES[mode]["resize"],))
    mine = faults.run_with_faults(tm, tp, mine_reqs,
                                  faults.FaultPlan(**plan),
                                  sched_kwargs=_kw(mode, seed=7),
                                  arrival_steps=ARRIVALS)
    ref = jfaults.run_with_faults(
        jm, jp, ref_reqs, jfaults.FaultPlan(**plan),
        sched_kwargs=_kw(mode, key=jax.random.PRNGKey(7)),
        arrival_steps=ARRIVALS)
    _same_outcomes(mine.finished, ref.finished)
    _same_outcomes(mine.baseline, ref.baseline)
    got = (mine.steps, mine.restarts, mine.preemptions, mine.cancelled,
           mine.expired, sorted(mine.survivors))
    assert got == (ref.steps, ref.restarts, ref.preemptions, ref.cancelled,
                   ref.expired, sorted(ref.survivors))
    assert mine.replans == 0 and mine.restarts == 1 and mine.cancelled == 1
    assert mine.expired == 1 and mine.preemptions >= 1
    assert mine.rebuild_captures == 0 and len(mine.resize_s) == 1
    # the deadline retired uid 0 with the tokens it had (chunked: none, it
    # was still prefilling)
    f0 = mine.finished[0]
    assert f0.finish_reason == "deadline" and len(f0.tokens) < STEPS
    assert (len(f0.tokens) == 0) == (mode == "chunked")
    np.testing.assert_array_equal(
        f0.tokens, mine.baseline[0].tokens[:len(f0.tokens)])
    if mode == "chunked":
        assert any(pos is not None for _, pos in victims), victims
    assert mine.recomputed_tokens > 0


def _snapshot_pair(mode, k=4):
    """The port's and the reference's schedulers after ``k`` steps of the
    staggered requests, on step clocks."""
    jm, jp, tm, tp = _models("deepseek_7b")
    mine_reqs, ref_reqs = _requests(deadline=False)
    out = []
    for cls, model, params, reqs, kw in (
            (Scheduler, tm, tp, mine_reqs, _kw(mode, seed=7)),
            (JScheduler, jm, jp, ref_reqs,
             _kw(mode, key=jax.random.PRNGKey(7)))):
        clk = {"t": 0.0}
        sched = cls(model, params, clock=faults.step_clock(clk), **kw)
        for step in range(k):
            for r, at in zip(reqs, ARRIVALS):
                if at == step:
                    sched.submit(r)
            clk["t"] += 1
            sched.step()
        out.append((sched, clk))
    return out


def _ref_pool(jcache, tm, paged: bool) -> dict:
    """A reference pool (layers stacked) in the port's layout, fp32."""
    out = {"pos": np.asarray(jcache["pos"])}
    if paged:
        out["block_tables"] = np.asarray(jcache["block_tables"])
    for gi, (period, count) in enumerate(tm.groups):
        g = jcache[f"g{gi}"]
        out[f"g{gi}"] = [{f"b{i}": {n: np.asarray(
            g[f"b{i}"][n][layer], np.float32)
            for n in g[f"b{i}"]} for i in range(len(period))}
            for layer in range(count)]
    return out


def _drain(sched, clk) -> dict:
    while not sched.idle:
        clk["t"] += 1
        sched.step()
    if sched.paged:
        sched.allocator.assert_quiescent()
    return {f.uid: f for f in sched.finished}


@pytest.mark.parametrize("mode", ["paged", "chunked"])
def test_snapshot_is_the_references_and_restores(mode, tmp_path):
    (mine, clk), (ref, rclk) = _snapshot_pair(mode)
    tm = mine.model
    snap, rsnap = mine.snapshot(), ref.snapshot()
    assert snap["version"] == rsnap["version"] == 1
    assert snap["seed"] == 7 and snap["enc_T"] == 0
    assert {k: v for k, v in snap["config"].items()} == rsnap["config"]
    assert snap["allocator"] == rsnap["allocator"]
    assert snap["slot_blocks"] == rsnap["slot_blocks"]
    assert snap["target_slots"] == rsnap["target_slots"]
    assert {k: snap["counters"][k] for k in rsnap["counters"]} == \
        rsnap["counters"]

    def slot_view(s):
        return None if s is None else (
            s["req"]["uid"], s["prompt_len"], s["tokens"], s["last_tok"],
            s["prefill_pos"], s["submit_time"], s["priority"])
    assert [slot_view(s) for s in snap["slots"]] == [
        slot_view(s) for s in rsnap["slots"]]
    for a, b in zip(snap["slots"], rsnap["slots"]):
        if a is not None:
            np.testing.assert_allclose(a["logprobs"], b["logprobs"],
                                       rtol=TOL, atol=TOL)
    assert [(q["req"]["uid"], q["prompt_len"], q["submit_time"])
            for q in snap["queue"]] == [
        (q["req"]["uid"], q["prompt_len"], q["submit_time"])
        for q in rsnap["queue"]]
    mid = [s for s in snap["slots"] if s and s["prefill_pos"] is not None]
    assert bool(mid) == (mode == "chunked")
    want = _ref_pool(rsnap["cache"], tm, paged=True)
    got = snap["cache"]
    np.testing.assert_array_equal(got["pos"], want["pos"])
    np.testing.assert_array_equal(got["block_tables"], want["block_tables"])
    for a, b in zip(tree_leaves({k: v for k, v in got.items()
                                 if k.startswith("g")}),
                    tree_leaves({k: v for k, v in want.items()
                                 if k.startswith("g")})):
        np.testing.assert_allclose(a, b, rtol=TOL_CACHE, atol=TOL_CACHE)
    # the rest of the run: the reference's, restored from memory or disk
    ref_out = _drain(ref, rclk)
    loaded = faults.load_snapshot(faults.save_snapshot(
        str(tmp_path / "snap"), snap))
    mine.close()
    for source in (snap, loaded):
        c = {"t": clk["t"]}
        s2 = Scheduler.from_snapshot(tm, mine.params, source,
                                     clock=faults.step_clock(c))
        _same_outcomes(_drain(s2, c), ref_out)
        s2.close()


@pytest.mark.parametrize("arch", ["deepseek_7b", "jamba_v0_1_52b"])
def test_kill_recovery_matches_the_reference(arch, tmp_path):
    jm, jp, tm, tp = _models(arch)
    mine_reqs, ref_reqs = _requests(4, deadline=False)
    plan = dict(kill_steps=frozenset({3}))
    kw = dict(arrival_steps=[0, 0, 1, 2], snapshot_every=2)
    mine = faults.run_with_faults(
        tm, tp, mine_reqs, faults.FaultPlan(**plan),
        sched_kwargs=_kw("paged", seed=7),
        durable_dir=str(tmp_path / "mine"), **kw)
    ref = jfaults.run_with_faults(
        jm, jp, ref_reqs, jfaults.FaultPlan(**plan),
        sched_kwargs=_kw("paged", key=jax.random.PRNGKey(7)),
        durable_dir=str(tmp_path / "ref"), **kw)
    assert mine.kills == ref.kills == 1 and mine.replans == 0
    _same_outcomes(mine.finished, ref.finished)
    assert (mine.steps, mine.preemptions, sorted(mine.survivors)) == (
        ref.steps, ref.preemptions, sorted(ref.survivors))
    rec = mine.recoveries[0]
    assert rec["records"] > 0 and mine.rebuild_captures == 0
    assert all(c["bytes"] > 0 for c in mine.checkpoints)


def test_preemption_no_livelock():
    """Equal priorities never preempt: three requests contending for one
    slot drain in submit order with no preemption and no leaked block."""
    _, _, tm, tp = _models("qwen3_32b")
    reqs, _ = _requests(4, deadline=False)
    sched = Scheduler(tm, tp, **_kw("paged", num_slots=1, num_blocks=4))
    for r in reqs[:3]:
        sched.submit(dataclasses.replace(r, priority=0))
    out = sched.run()
    assert sched.preemptions == 0 and len(out) == 3
    sched.allocator.assert_quiescent()
    # a strictly better arrival preempts, and the victim still finishes
    sched.submit(dataclasses.replace(reqs[0], uid=10))
    sched.step()
    sched.submit(dataclasses.replace(reqs[3], uid=11))
    out = sched.run()
    assert sched.preemptions == 1 and sorted(out) == [10, 11]
    assert [f.uid for f in sched.finished[-2:]] == [11, 10]
    sched.allocator.assert_quiescent()


@pytest.mark.parametrize("moves", [((3, 14), (2, 9)), ((1, 6), (2, 10))],
                         ids=["grow-shrink", "shrink-grow"])
def test_resize_moves_the_pool_as_the_reference(moves):
    """Two resizes with a live request (paged): the port's pool after
    each is the reference's, leaf for leaf, positions and tables too."""
    jm, jp, tm, tp = _models("deepseek_7b")
    mine_reqs, ref_reqs = _requests(2, deadline=False)
    mine = Scheduler(tm, tp, **_kw("paged", seed=7))
    ref = JScheduler(jm, jp, **_kw("paged", key=jax.random.PRNGKey(7)))
    for sched, reqs in ((mine, mine_reqs), (ref, ref_reqs)):
        sched.submit(reqs[0])
        sched.step()
        sched.step()
    for slots, blocks in moves:
        assert mine.resize(slots, blocks) == ref.resize(slots, blocks)
        for sched in (mine, ref):
            sched.step()
        want = _ref_pool(ref.cache, tm, paged=True)
        got = mine.cache
        assert got["pos"].tolist() == want["pos"].tolist()
        assert got["block_tables"].tolist() == want["block_tables"].tolist()
        for a, b in zip(tree_leaves({k: v for k, v in got.items()
                                     if k.startswith("g")}),
                        tree_leaves({k: v for k, v in want.items()
                                     if k.startswith("g")})):
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL_CACHE,
                                       atol=TOL_CACHE)
        assert (mine.num_slots, mine.num_blocks) == (ref.num_slots,
                                                    ref.num_blocks)
    _same_outcomes(mine.run(), ref.run())


class _Holder:
    def __init__(self, n):
        self.num_active = n


def test_bind_refuses_a_live_holder_and_close_releases():
    """``DecodeGraph.bind``'s rule, without a card: another holder with
    active rows is refused, its own holder and a holder with none are
    not; ``release`` (``Scheduler.close``) lets a new scheduler bind a
    graph whose dead holder left rows in it."""
    graph = DecodeGraph.__new__(DecodeGraph)
    graph.masked, graph.B, graph.T = True, 2, 16
    params = object()
    graph.graph, graph.params, graph.owner = object(), params, None
    live, other = _Holder(2), _Holder(0)
    graph.bind(live, params)
    assert graph.holder() is live
    with pytest.raises(RuntimeError, match="2 active rows"):
        graph.bind(other, params)
    graph.bind(live, params)              # its own holder
    graph.release(other)                  # not the holder: no effect
    assert graph.holder() is live
    graph.release(live)
    graph.bind(other, params)
    assert graph.holder() is other
    _, _, tm, tp = _models("deepseek_7b")
    s = Scheduler(tm, tp, num_slots=2, cache_len=CACHE)
    s.graph = graph
    graph.owner = weakref.ref(s)
    s.slots[0] = object()                 # a live row
    with pytest.raises(RuntimeError, match="1 active rows"):
        graph.bind(other, params)
    s.close()
    assert s.closed and graph.holder() is None
    graph.bind(other, params)
    with pytest.raises(RuntimeError, match="closed"):
        s.step()
