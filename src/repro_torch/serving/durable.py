"""Write-ahead request journal and durable restart (DESIGN.md §13), the
reference's ``serving.durable``.

The scheduler's snapshot (``serving.faults.save_snapshot``, a committed
generation of the ``core.durable`` store) is a *periodic* capture; the
journal makes the window between snapshots durable.  Every lifecycle
transition is appended, fsynced by default, as it happens:

    submit  — the full request: its inputs as arrays, and its generator's
              state at submit, so a re-submitted request restarts the
              same stream (a submit is acknowledged once
              ``DurableScheduler.submit`` returns, i.e. after the fsync)
    retire  — the full :class:`FinishedRequest` (tokens, logprobs,
              finish_reason): EOS and length retirements, cancels,
              deadline expiries and ``max_new_tokens=0`` short-circuits
    cancel  — informational (the retire record the cancel produced is
              the authoritative outcome)

Records are JSON lines with a crc32; replay stops at the first torn or
corrupt record (an unacknowledged tail, the shape of a crash mid-append)
and recovery truncates the file there before appending.

Recovery (:meth:`DurableScheduler.recover`) =

    load the newest *clean* snapshot generation (checksummed; corrupt
    generations fall back, ``core.durable.load_latest_good``)
  + replay every journal segment at or after that generation, in order:
      - submits of unknown uids re-enter the queue (same inputs,
        generator state, priority, submit time),
      - retire records are authoritative: the journaled result is kept
        verbatim, and any live copy of the request is dropped (blocks
        freed) rather than recomputed,
  + commit a fresh snapshot generation so the next crash replays only
    its own window.

A clean shutdown (``launch.serve``'s Ctrl-C with ``--durable``) writes
the same snapshot and journal checkpoint, so a crash and a clean stop
share one recovery entry point (``--restore``).  On a card the recovered
scheduler binds the slot-pool graph of the snapshot's geometry
(``Scheduler.from_snapshot``): nothing is captured again for a model that
has it.
"""
from __future__ import annotations

import base64
import json
import os
import time
import zlib

import numpy as np
import torch

from repro_torch.core import durable
from .faults import load_snapshot, save_snapshot
from .scheduler import FinishedRequest, Request, Scheduler

JOURNAL_PREFIX = "journal"


# ------------------------------------------------------------- serialization
def _enc_arr(a) -> dict:
    """An array (numpy, or a torch tensor, bf16 included) as JSON: its
    manifest dtype name (``core.durable``), shape and base64 bytes."""
    raw, name = durable.raw_array(a)
    return {"dtype": name, "shape": list(raw.shape),
            "b64": base64.b64encode(
                np.ascontiguousarray(raw).tobytes()).decode("ascii")}


def _dec_arr(d):
    raw = np.frombuffer(base64.b64decode(d["b64"]),
                        dtype=durable.resolve_dtype(d["dtype"]))
    return durable.host_array(raw.reshape(tuple(d["shape"])).copy(),
                              d["dtype"])


def encode_request(req: Request) -> dict:
    """``req`` as JSON: its inputs as arrays and its generator's state
    now (call it at submit, before any draw)."""
    return {"uid": req.uid,
            "inputs": {k: _enc_arr(v) for k, v in req.inputs.items()},
            "max_new_tokens": req.max_new_tokens,
            "key": (None if req.key is None
                    else _enc_arr(req.key.get_state())),
            "temperature": req.temperature, "top_k": req.top_k,
            "priority": req.priority, "deadline_s": req.deadline_s}


def decode_request(d: dict, device: torch.device | str = "cpu") -> Request:
    """The request of :func:`encode_request`, its inputs and its generator
    (in the encoded state) on ``device``."""
    key = None
    if d["key"] is not None:
        key = torch.Generator(device=device)
        key.set_state(torch.from_numpy(_dec_arr(d["key"])))
    return Request(
        uid=int(d["uid"]),
        inputs={k: torch.as_tensor(_dec_arr(v)).to(device)
                for k, v in d["inputs"].items()},
        max_new_tokens=int(d["max_new_tokens"]), key=key,
        temperature=float(d["temperature"]), top_k=int(d["top_k"]),
        priority=int(d["priority"]),
        deadline_s=(None if d["deadline_s"] is None
                    else float(d["deadline_s"])))


def encode_finished(f: FinishedRequest) -> dict:
    return {"uid": f.uid, "tokens": np.asarray(f.tokens).tolist(),
            "logprobs": [float(x) for x in np.asarray(f.logprobs)],
            "finish_reason": f.finish_reason, "prompt_len": f.prompt_len,
            "submit_time": f.submit_time, "finish_time": f.finish_time,
            "first_token_time": f.first_token_time}


def decode_finished(d: dict) -> FinishedRequest:
    return FinishedRequest(
        uid=int(d["uid"]), tokens=np.asarray(d["tokens"], np.int64),
        logprobs=np.asarray(d["logprobs"], np.float32),
        finish_reason=str(d["finish_reason"]),
        prompt_len=int(d["prompt_len"]),
        submit_time=float(d["submit_time"]),
        finish_time=float(d["finish_time"]),
        first_token_time=(None if d.get("first_token_time") is None
                          else float(d["first_token_time"])))


# ------------------------------------------------------------------ journal
class RequestJournal:
    """Append-only crc-checked JSON-lines journal.  ``fsync=True`` makes
    every append durable before it returns (the acknowledgement point);
    tests and benchmarks may turn it off."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "ab")
        self._seq = 0

    def append(self, rec: dict) -> None:
        rec = dict(rec, seq=self._seq)
        body = json.dumps(rec, sort_keys=True)
        rec["crc"] = zlib.crc32(body.encode())
        self._f.write((json.dumps(rec, sort_keys=True) + "\n").encode())
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._seq += 1

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay(path: str) -> tuple[list[dict], int]:
        """Read records until the first torn or corrupt line.  Returns
        (records, good_offset): everything at or past ``good_offset`` is
        an unacknowledged tail, truncated before appending."""
        records: list[dict] = []
        offset = 0
        if not os.path.exists(path):
            return records, offset
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break                 # torn tail: crash mid-append
                try:
                    rec = json.loads(line)
                    crc = rec.pop("crc")
                    body = json.dumps(rec, sort_keys=True)
                    if crc != zlib.crc32(body.encode()):
                        break
                except (json.JSONDecodeError, KeyError, TypeError,
                        AttributeError, UnicodeDecodeError):
                    break
                records.append(rec)
                offset += len(line)
        return records, offset


# ---------------------------------------------------------- durable wrapper
class DurableScheduler:
    """A :class:`Scheduler` with a durable shadow: submits and retires are
    journaled as they happen, snapshots committed every ``snapshot_every``
    decode steps (and at :meth:`checkpoint`), and :meth:`recover` rebuilds
    the whole serving state after a ``kill -9``.  Everything not
    overridden here delegates to the wrapped scheduler."""

    def __init__(self, sched: Scheduler, root: str, *,
                 snapshot_every: int | None = None, fsync: bool = True,
                 keep_generations: int = 3):
        self.sched = sched
        self.root = root
        self.snapshot_every = snapshot_every
        self.fsync = fsync
        self.keep_generations = keep_generations
        # per checkpoint: its generation, the bytes of its arrays, the host
        # seconds of ``snapshot()`` and of ``save_snapshot`` (fsync
        # included); per recovery (``recover``), its seconds by stage
        self.checkpoints: list[dict] = []
        self.recovery: dict | None = None
        os.makedirs(root, exist_ok=True)
        self._fin_mark = len(sched.finished)
        gens = durable.committed_generations(root)
        if gens:
            # attach to an existing store (an in-memory restart, or a
            # recovery): continue the newest generation's journal segment
            self.generation = gens[-1]
            self.journal = RequestJournal(
                self._journal_path(self.generation), fsync)
            self._snap_steps = sched.steps_run
        else:
            # first boot: commit generation 1 now so recovery always has
            # a snapshot to anchor journal replay
            self.generation = 0
            self.journal = None
            self.checkpoint()

    def _journal_path(self, gen: int) -> str:
        return os.path.join(self.root, f"{JOURNAL_PREFIX}_{gen:08d}.log")

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request, submit_time: float | None = None) -> None:
        """Validate and enqueue, then journal.  Once this returns, the
        request survives a crash (an fsynced submit record)."""
        self.sched.submit(req, submit_time)
        q = self.sched.queue[-1]
        self.journal.append({"type": "submit", "req": encode_request(req),
                             "submit_time": q.submit_time})

    def cancel(self, uid: int) -> bool:
        ok = self.sched.cancel(uid)
        if ok:
            self.journal.append({"type": "cancel", "uid": int(uid)})
        self._sync_finished()
        return ok

    def step(self):
        done = self.sched.step()
        self._sync_finished()
        if self.snapshot_every is not None and \
                self.sched.steps_run - self._snap_steps >= self.snapshot_every:
            self.checkpoint()
        return done

    def run(self) -> dict[int, FinishedRequest]:
        """Drain (the stall guard of ``Scheduler.run``), journaling every
        retirement and keeping the snapshot cadence."""
        out: dict[int, FinishedRequest] = {}
        while not self.sched.idle:
            before = (len(self.sched.queue), self.sched.num_active,
                      self.sched.steps_run, len(self.sched.finished))
            for f in self.step():
                out[f.uid] = f
            after = (len(self.sched.queue), self.sched.num_active,
                     self.sched.steps_run, len(self.sched.finished))
            if before == after and after[1] == 0:
                raise RuntimeError(
                    f"scheduler stalled: {len(self.sched.queue)} queued "
                    f"requests, no active slots, and a step made no "
                    f"progress")
        return out

    def _sync_finished(self) -> None:
        for f in self.sched.finished[self._fin_mark:]:
            self.journal.append({"type": "retire",
                                 "fin": encode_finished(f)})
        self._fin_mark = len(self.sched.finished)

    # ----------------------------------------------------------- durability
    def checkpoint(self) -> int:
        """Commit a snapshot generation and rotate the journal: records
        before this point are superseded (older segments stay on disk so
        a corrupt generation can still fall back and replay forward)."""
        if self.journal is not None:
            self._sync_finished()
            self.journal.close()
        t0 = time.perf_counter()
        snap = self.sched.snapshot()
        t1 = time.perf_counter()
        save_snapshot(self.root, snap)
        t2 = time.perf_counter()
        self.generation = durable.committed_generations(self.root)[-1]
        self.checkpoints.append({
            "generation": self.generation, "snapshot_s": t1 - t0,
            "save_s": t2 - t1, "bytes": os.path.getsize(os.path.join(
                self.root, f"gen_{self.generation:08d}", "arrays.bin"))})
        self.journal = RequestJournal(
            self._journal_path(self.generation), self.fsync)
        self._snap_steps = self.sched.steps_run
        if self.keep_generations:
            durable.prune_generations(self.root,
                                      keep=self.keep_generations)
            self._prune_journals()
        return self.generation

    def _prune_journals(self) -> None:
        live = set(durable.committed_generations(self.root))
        live.add(self.generation)
        for name in os.listdir(self.root):
            if not name.startswith(JOURNAL_PREFIX + "_"):
                continue
            g = int(name[len(JOURNAL_PREFIX) + 1:].split(".")[0])
            if g < min(live):
                os.unlink(os.path.join(self.root, name))

    def close(self) -> None:
        """Close the journal (its retirements synced first) and the
        wrapped scheduler (``Scheduler.close``: its graph released)."""
        if self.journal is not None:
            self._sync_finished()
            self.journal.close()
            self.journal = None
        self.sched.close()

    @classmethod
    def recover(cls, root: str, model, params, *, clock=None,
                rebase_clock: bool = False,
                snapshot_every: int | None = None, fsync: bool = True,
                graph: bool = True, log=None) -> "DurableScheduler":
        """Rebuild after a crash (or a clean stop): the newest clean
        snapshot generation + the ordered replay of every journal segment
        at or after it, then a fresh checkpoint.  Corrupt generations are
        skipped (the checksummed fallback); a torn journal tail is
        truncated.  ``graph`` as ``Scheduler.from_snapshot``'s."""
        t0 = time.perf_counter()
        gen, snap = _load_good_snapshot(root, log)
        t1 = time.perf_counter()
        sched = Scheduler.from_snapshot(model, params, snap, clock=clock,
                                        rebase_clock=rebase_clock,
                                        graph=graph)
        t2 = time.perf_counter()
        segments = sorted(
            (int(n[len(JOURNAL_PREFIX) + 1:].split(".")[0]),
             os.path.join(root, n))
            for n in os.listdir(root)
            if n.startswith(JOURNAL_PREFIX + "_") and n.endswith(".log"))
        replayed = 0
        for g, path in segments:
            if g < gen:
                continue
            records, good = RequestJournal.replay(path)
            size = os.path.getsize(path)
            if good < size:               # torn tail: unacknowledged bytes
                with open(path, "r+b") as f:
                    f.truncate(good)
                if log:
                    log(f"journal {path}: truncated torn tail "
                        f"({size - good} bytes)")
            for rec in records:
                _apply_record(sched, rec)
                replayed += 1
        if log:
            log(f"recovered from {root}: generation {gen}, "
                f"{replayed} journal records replayed "
                f"({len(sched.queue)} queued, {sched.num_active} active, "
                f"{len(sched.finished)} finished)")
        t3 = time.perf_counter()
        ds = cls(sched, root, snapshot_every=snapshot_every, fsync=fsync)
        ds.checkpoint()                   # bound the next crash's replay
        ds.recovery = {"generation": gen, "records": replayed,
                       "load_s": t1 - t0, "from_snapshot_s": t2 - t1,
                       "replay_s": t3 - t2,
                       "checkpoint_s": time.perf_counter() - t3}
        return ds

    # everything else (stats, resize, snapshot, idle, queue, allocator,
    # counters) reads and acts straight through to the wrapped scheduler
    def __getattr__(self, name):
        return getattr(self.sched, name)

    @property
    def hold_admissions(self) -> bool:
        return self.sched.hold_admissions

    @hold_admissions.setter
    def hold_admissions(self, v: bool) -> None:
        self.sched.hold_admissions = v


def _load_good_snapshot(root: str, log=None) -> tuple[int, dict]:
    gen, _tree, _arrays, _manifest, skipped = durable.load_latest_good(root)
    if skipped and log:
        for msg in skipped:
            log(f"skipped corrupt generation: {msg}")
    return gen, load_snapshot(root, generation=gen)


def _known_uids(sched: Scheduler) -> set[int]:
    uids = {f.uid for f in sched.finished}
    uids.update(q.req.uid for q in sched.queue)
    uids.update(s.uid for s in sched.slots if s is not None)
    return uids


def _apply_record(sched: Scheduler, rec: dict) -> None:
    t = rec.get("type")
    if t == "submit":
        req = decode_request(rec["req"], sched.model.device)
        if req.uid not in _known_uids(sched):
            sched.submit(req, submit_time=float(rec["submit_time"]))
    elif t == "retire":
        fin = decode_finished(rec["fin"])
        if any(f.uid == fin.uid for f in sched.finished):
            return
        # the journaled result is authoritative (it was acknowledged):
        # drop any live copy instead of recomputing it
        sched.drop(fin.uid)
        sched.finished.append(fin)
        if fin.finish_reason == "cancelled":
            sched.cancelled += 1
        elif fin.finish_reason == "deadline":
            sched.expired += 1
    # "cancel" records are informational: the retire record that the
    # cancel produced carries the acknowledged outcome
