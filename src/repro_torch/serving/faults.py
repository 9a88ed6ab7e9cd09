"""Deterministic fault-injection harness for the serving stack (DESIGN.md
§11), the reference's ``serving.faults``.

A :class:`FaultPlan` is a seeded, fully precomputed schedule of faults
keyed by scheduler step index: forced allocation failures, admission
holds, mid-decode cancellations, live pool resizes, simulated process
restarts (snapshot → tear down → :meth:`Scheduler.from_snapshot`) and
hard kills (recovered from the durable store alone).  The plan is data,
not wall-clock races, and its numpy draws are the reference's, so one
seed gives the same plan in both packages and every scenario replays
exactly.  :func:`run_with_faults` then asserts:

  * no leaked block (``BlockAllocator.assert_quiescent``)
  * no TT plan resolution (``kernels.plan.plan_resolutions``)
  * no lost request
  * every *surviving* request (not cancelled or expired) finishes with
    the tokens of an uninterrupted run of the same requests (bit for bit
    by default; ``check=`` takes another comparator, such as
    ``launch.serve.check_greedy`` at full width in bf16)

The scheduler runs on a virtual step clock (one unit per tick), so
deadlines fire at fixed steps and restarts keep the remaining TTLs.  On a
card every scheduler of the run, the restored and recovered ones
included, replays the slot-pool graph of its geometry: the old scheduler
is closed (``Scheduler.close``) before the new one binds it.

Persistence (:func:`save_snapshot` / :func:`load_snapshot`) rides the
generation store (``core.durable``, DESIGN.md §13): each save commits a
new checksummed generation (chunked ``arrays.bin`` + JSON manifest, temp +
fsync + atomic rename), and each load verifies every array's checksum,
falling back to the newest clean generation.  The reference's older
single-directory layout (``arrays.npz``) is not read: the port never
wrote it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import durable
from repro_torch.kernels import plan as ttplan
from .scheduler import Request, Scheduler


# ----------------------------------------------------------------- fault plan
@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults, keyed by scheduler step index.

    ``alloc_fail_steps``: steps during which the allocator refuses fresh
    allocations (``refuse_fresh``): admissions defer exactly as under pool
    exhaustion, nothing mid-admission to roll back.
    ``hold_steps``: steps during which admission is gated entirely
    (``hold_admissions``), an external backpressure signal.
    ``cancels``: ``(step, uid)`` pairs: ``cancel(uid)`` fires before the
    step runs (a no-op if the request already finished).
    ``resizes``: ``(step, num_slots, num_blocks)`` triples (either may be
    None to leave that axis alone).
    ``restart_steps``: before each of these steps the scheduler is
    snapshotted, closed, and rebuilt by ``Scheduler.from_snapshot`` (a
    graceful restart: the in-memory state is captured first).
    ``kill_steps``: ``kill -9`` at these steps: the scheduler is closed
    with NO snapshot taken, and recovery comes from the durable store
    alone (the last committed generation + journal replay,
    ``serving.durable.DurableScheduler.recover``); needs
    ``run_with_faults(durable_dir=...)``.
    """
    alloc_fail_steps: frozenset = frozenset()
    hold_steps: frozenset = frozenset()
    cancels: tuple = ()                   # ((step, uid), ...)
    resizes: tuple = ()                   # ((step, slots|None, blocks|None),)
    restart_steps: frozenset = frozenset()
    kill_steps: frozenset = frozenset()

    @classmethod
    def random(cls, seed: int, *, horizon: int, uids=(),
               n_alloc_fail: int = 2, n_hold: int = 1, n_cancel: int = 1,
               resize_to: tuple | None = None,
               with_restart: bool = True,
               with_kill: bool = False) -> "FaultPlan":
        """Sample a plan from a seeded numpy generator, draw for draw the
        reference's.  ``horizon`` bounds the step indices faults land on
        (keep it well under the expected drain length so every fault
        fires)."""
        rng = np.random.default_rng(seed)
        steps = lambda n: frozenset(
            int(s) for s in rng.choice(horizon, size=min(n, horizon),
                                       replace=False))
        cancels = ()
        if n_cancel and len(uids):
            picked = rng.choice(len(uids), size=min(n_cancel, len(uids)),
                                replace=False)
            cancels = tuple(
                (int(rng.integers(1, horizon)), int(uids[i]))
                for i in picked)
        resizes = ()
        if resize_to is not None:
            resizes = ((int(rng.integers(1, horizon)),
                        resize_to[0], resize_to[1]),)
        return cls(
            alloc_fail_steps=steps(n_alloc_fail),
            hold_steps=steps(n_hold),
            cancels=cancels, resizes=resizes,
            restart_steps=(frozenset({int(rng.integers(1, horizon))})
                           if with_restart else frozenset()),
            kill_steps=(frozenset({int(rng.integers(1, horizon))})
                        if with_kill else frozenset()))


# -------------------------------------------------------------------- harness
@dataclasses.dataclass
class FaultReport:
    finished: dict                        # uid -> FinishedRequest
    baseline: dict                        # uid -> FinishedRequest (no faults)
    survivors: list                       # uids checked against it
    steps: int
    restarts: int
    preemptions: int
    cancelled: int
    expired: int
    replans: int
    kills: int = 0                        # hard kills recovered from disk
    # the port's measurements: graph captures and prefill builds made by
    # the restarts' and recoveries' rebuilds; host seconds of each resize
    # call (on a card to its end on the device) and of each restart's
    # ``snapshot()`` and ``from_snapshot``; each recovery's and durable
    # checkpoint's record (``DurableScheduler.recovery``,
    # ``.checkpoints``); prompt tokens the resumes of preempted requests
    # prefilled again
    rebuild_captures: int = 0
    resize_s: list = dataclasses.field(default_factory=list)
    restart_s: list = dataclasses.field(default_factory=list)
    recoveries: list = dataclasses.field(default_factory=list)
    checkpoints: list = dataclasses.field(default_factory=list)
    recomputed_tokens: int = 0


def step_clock(state: dict):
    """A virtual clock for Scheduler(clock=...): one unit per tick."""
    return lambda: float(state["t"])


def _builds(model) -> int:
    return model.graph_captures + model.prefill_builds


def _sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def run_with_faults(model, params, requests: list[Request], plan: FaultPlan,
                    *, sched_kwargs: dict, max_steps: int = 2000,
                    arrival_steps: list[int] | None = None,
                    baseline: dict | None = None,
                    check_identity: bool = True, check=None,
                    durable_dir: str | None = None,
                    snapshot_every: int | None = None,
                    corruptor=None) -> FaultReport:
    """Drive a scheduler through ``plan`` on a virtual step clock, then
    assert the invariant suite.  ``sched_kwargs`` configures both the
    faulted scheduler and (unless ``baseline`` results are passed in) an
    uninterrupted run of the same requests (its ``graph`` flag also the
    restored and recovered schedulers).

    ``arrival_steps`` (aligned with ``requests``, default all 0) staggers
    submissions across steps: a late high-priority arrival is how the
    preemption path gets exercised.  Token streams are arrival-invariant
    (per-request streams), so the baseline submits everything up front.

    ``durable_dir`` wraps the scheduler in a
    ``serving.durable.DurableScheduler`` (journal + a snapshot every
    ``snapshot_every`` decode steps), which makes ``plan.kill_steps``
    possible.  ``corruptor(durable_dir, step)``, if given, runs between
    each kill and its recovery (truncating a committed ``arrays.bin``,
    flipping a bit) to exercise the checksummed fallback.

    Surviving requests, everything not retired as "cancelled" or
    "deadline", must match the baseline: with ``check_identity`` (the
    default) token for token, or, when ``check`` is given, as
    ``check(uid, got, want)`` decides (it raises on a miss)."""
    if plan.kill_steps and durable_dir is None:
        raise ValueError("plan.kill_steps require durable_dir (a hard "
                         "kill recovers from the durable store only)")
    graph = sched_kwargs.get("graph", True)
    if baseline is None:
        ref = Scheduler(model, params, **sched_kwargs)
        for r in requests:
            # the uninterrupted run expires nothing: its TTLs are stripped
            # so faulted slowdowns (holds, restarts) don't change it
            ref.submit(dataclasses.replace(r, deadline_s=None))
        baseline = ref.run()
        if ref.paged:
            ref.allocator.assert_quiescent()
        ref.close()
        del ref

    plans_warm = ttplan.plan_resolutions()
    clk = {"t": 0.0}
    sched = Scheduler(model, params, clock=step_clock(clk), **sched_kwargs)
    if durable_dir is not None:
        from .durable import DurableScheduler
        sched = DurableScheduler(sched, durable_dir,
                                 snapshot_every=snapshot_every)
    pending = sorted(
        zip(arrival_steps or [0] * len(requests), requests),
        key=lambda p: p[0])

    due_cancels = [(int(s), int(uid)) for s, uid in plan.cancels]
    resizes_by_step: dict[int, tuple] = {
        int(s): (slots, blocks) for s, slots, blocks in plan.resizes}

    step = restarts = kills = rebuilds = recomputed = 0
    resize_s: list[float] = []
    restart_s: list[tuple[float, float]] = []
    recoveries: list[dict] = []
    checkpoints: list[dict] = []
    while pending or not sched.idle:
        if step >= max_steps:
            raise RuntimeError(
                f"fault run did not drain within {max_steps} steps "
                f"(queue={len(sched.queue)}, active={sched.num_active})")
        if step in plan.kill_steps:
            # kill -9: NOTHING in memory survives, no snapshot is taken;
            # recovery = newest clean snapshot generation + journal replay
            from .durable import DurableScheduler
            recomputed += sched.recomputed_tokens
            checkpoints += sched.checkpoints
            sched.close()                 # the OS would flush fds anyway
            del sched
            if corruptor is not None:
                corruptor(durable_dir, step)
            b0 = _builds(model)
            sched = DurableScheduler.recover(
                durable_dir, model, params, clock=step_clock(clk),
                snapshot_every=snapshot_every, graph=graph)
            rebuilds += _builds(model) - b0
            recoveries.append(sched.recovery)
            # the recovered counter restarts from the snapshot's value
            recomputed -= sched.recomputed_tokens
            kills += 1
        if step in plan.restart_steps:
            t0 = time.perf_counter()
            snap = sched.snapshot()
            t1 = time.perf_counter()
            carry = (sched.preemptions, sched.cancelled, sched.expired)
            if durable_dir is not None:
                checkpoints += sched.checkpoints
            sched.close()
            del sched
            b0 = _builds(model)
            t2 = time.perf_counter()
            sched = Scheduler.from_snapshot(model, params, snap,
                                            clock=step_clock(clk),
                                            graph=graph)
            _sync(model)
            restart_s.append((t1 - t0, time.perf_counter() - t2))
            rebuilds += _builds(model) - b0
            if durable_dir is not None:
                from .durable import DurableScheduler
                sched = DurableScheduler(sched, durable_dir,
                                         snapshot_every=snapshot_every)
            assert (sched.preemptions, sched.cancelled,
                    sched.expired) == carry
            restarts += 1
        while pending and pending[0][0] <= step:
            sched.submit(pending.pop(0)[1])
        still_due = []
        for s, uid in due_cancels:
            if s > step:
                still_due.append((s, uid))
            elif not sched.cancel(uid) and any(
                    r.uid == uid for _, r in pending):
                still_due.append((s, uid))    # not arrived yet: retry later
        due_cancels = still_due
        if step in resizes_by_step:
            slots, blocks = resizes_by_step[step]
            t0 = time.perf_counter()
            sched.resize(num_slots=slots, num_blocks=blocks)
            _sync(model)
            resize_s.append(time.perf_counter() - t0)
        if sched.paged:
            sched.allocator.refuse_fresh = step in plan.alloc_fail_steps
        sched.hold_admissions = step in plan.hold_steps
        clk["t"] += 1.0
        sched.step()
        step += 1

    # ------------------------------------------------------------ invariants
    if sched.paged:
        sched.allocator.refuse_fresh = False
        sched.allocator.assert_quiescent()
    replans = ttplan.plan_resolutions() - plans_warm
    if replans:
        raise AssertionError(
            f"{replans} TT plan re-resolutions during the fault run — "
            f"faulted paths must reuse the primed PlanBook")
    finished = {f.uid: f for f in sched.finished}
    missing = {r.uid for r in requests} - set(finished)
    if missing:
        raise AssertionError(f"requests lost by the fault run: "
                             f"{sorted(missing)}")
    survivors = [u for u, f in finished.items()
                 if f.finish_reason not in ("cancelled", "deadline")]
    for u in survivors:
        got, ref_f = finished[u], baseline[u]
        if check is not None:
            check(u, got, ref_f)
        elif check_identity and not np.array_equal(got.tokens,
                                                   ref_f.tokens):
            raise AssertionError(
                f"survivor uid={u} tokens diverged from the "
                f"uninterrupted run: {got.tokens.tolist()} != "
                f"{ref_f.tokens.tolist()}")
    report = FaultReport(
        finished=finished, baseline=baseline, survivors=survivors,
        steps=step, restarts=restarts, preemptions=sched.preemptions,
        cancelled=sched.cancelled, expired=sched.expired, replans=replans,
        kills=kills, rebuild_captures=rebuilds, resize_s=resize_s,
        restart_s=restart_s, recoveries=recoveries,
        checkpoints=checkpoints + getattr(sched, "checkpoints", []),
        recomputed_tokens=recomputed + sched.recomputed_tokens)
    sched.close()
    return report


# ------------------------------------------------------------------- on disk
_ARR = "__arr__"


def _split_arrays(obj, arrays: dict, path: str):
    """Recursively replace array leaves (numpy arrays, torch tensors) with
    ``{"__arr__": key}`` markers, collecting the arrays keyed by their
    tree path; numpy scalars, ``np.bool_`` included, become Python's."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arrays[path] = obj
        return {_ARR: path}
    if isinstance(obj, dict):
        return {k: _split_arrays(v, arrays, f"{path}/{k}")
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_split_arrays(v, arrays, f"{path}/{i}")
                for i, v in enumerate(obj)]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _join_arrays(obj, arrays: dict):
    if isinstance(obj, dict):
        if set(obj) == {_ARR}:
            return arrays[obj[_ARR]]
        return {k: _join_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_join_arrays(v, arrays) for v in obj]
    return obj


def _array_refs(tree, out: set) -> set:
    """Array keys referenced by ``{"__arr__": key}`` markers in ``tree``."""
    if isinstance(tree, dict):
        if set(tree) == {_ARR}:
            out.add(tree[_ARR])
        else:
            for v in tree.values():
                _array_refs(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _array_refs(v, out)
    return out


def _validate_snapshot(path: str, tree, arrays: dict) -> None:
    """The manifest tree and the array payload must reference exactly the
    same key set: a mismatch (partial write, mixed-up files, manual
    edits) fails HERE with the offending keys, not as a ``KeyError`` deep
    inside ``_join_arrays``."""
    if not isinstance(tree, dict) or "version" not in tree:
        raise RuntimeError(
            f"snapshot at {path}: manifest tree is not a scheduler "
            f"snapshot (no 'version' field) — wrong or corrupted file")
    refs = _array_refs(tree, set())
    missing = sorted(refs - set(arrays))
    extra = sorted(set(arrays) - refs)
    if missing or extra:
        raise RuntimeError(
            f"snapshot at {path}: manifest/array mismatch — "
            f"{len(missing)} referenced arrays missing from the payload "
            f"({missing[:5]}{'…' if len(missing) > 5 else ''}), "
            f"{len(extra)} unreferenced arrays present "
            f"({extra[:5]}{'…' if len(extra) > 5 else ''})")


def save_snapshot(path: str, snap: dict) -> str:
    """Persist a ``Scheduler.snapshot()`` durably: commits the next
    checksummed generation under ``path`` (``core.durable``).  Returns
    ``path``; :func:`load_snapshot` reads the newest clean generation
    back from it."""
    arrays: dict = {}
    tree = _split_arrays(snap, arrays, "snap")
    durable.write_generation(path, tree, arrays)
    return path


def load_snapshot(path: str, generation: int | None = None) -> dict:
    """Load a persisted snapshot.  Default: the newest generation under
    ``path`` that passes every array checksum: torn or bit-flipped
    generations are skipped (never returned), falling back to the last
    fully-committed one.  ``generation`` pins one generation exactly (no
    fallback)."""
    if generation is not None:
        tree, arrays, _manifest = durable.load_generation(path, generation)
    else:
        _gen, tree, arrays, _manifest, _skipped = \
            durable.load_latest_good(path)
    _validate_snapshot(path, tree, arrays)
    return _join_arrays(tree, arrays)
