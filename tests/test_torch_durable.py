"""The port's durability stack on the CPU: the generation store
(``core.durable``), the snapshot files (``serving.faults.save_snapshot``
/ ``load_snapshot``), the request journal and recovery
(``serving.durable``), and the serve CLI's drills.

- The store: a generation written by the reference's ``core.durable``
  reads back in the port's, and the reverse, byte for byte, a bf16 leaf
  included (the port's is a ``torch.bfloat16`` tensor written as its
  2-byte payload under the reference's dtype name, with no ``ml_dtypes``);
  awkward leaves (int8, 0-d, empty, a leaf spanning chunks) round-trip;
  a truncated or bit-flipped newest generation falls back, a fully
  corrupt store raises ``CorruptGenerationError``, an empty one
  ``FileNotFoundError``; ``.tmp`` leftovers stay invisible, another schema
  is refused, pruning keeps the newest.
- Snapshot files: ``np.True_`` and the other numpy scalars round-trip
  through ``save_snapshot``/``load_snapshot`` (the reference's
  ``_split_arrays`` misses ``np.bool_``); a manifest that names arrays the
  payload lacks, or a tree that is no snapshot, is refused clearly.
- The journal: replay stops at a torn tail or a corrupt record, and
  appending continues after the truncation; a request round-trips with its
  generator's state and bf16 inputs.
- ``DurableScheduler``: a submit acknowledged before any step survives an
  immediate kill (the reference's tokens after the recovery); recovering
  a drained store duplicates nothing; sampled requests (temperature 0.8,
  their generators in the snapshot and the journal) survive a kill with
  the streams of the uninterrupted run.
- The serve CLI on ``--device cpu``: ``--fault-smoke`` (dense, paged,
  chunked) and ``--durability-smoke`` print their OK lines; the arrival
  mode with ``--durable DIR`` and then ``--restore``.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.core import durable as jdurable
from repro.serving.durable import DurableScheduler as JDurableScheduler
from repro.serving.faults import step_clock as jstep_clock
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import durable
from repro_torch.launch import serve
from repro_torch.serving import faults
from repro_torch.serving.durable import (DurableScheduler, RequestJournal,
                                         decode_request, encode_request)
from repro_torch.serving.scheduler import Request, Scheduler

S, STEPS, BLOCK = 8, 4, 4
CLI = ["--variant", "smoke", "--device", "cpu", "--tt", "ffn,attn",
       "--tt-rank", "4", "--tt-backend", "auto", "--slots", "2",
       "--max-requests", "5", "--prompt-len", "8", "--steps", "6"]

_built: dict = {}


def _models():
    """deepseek-7b SMOKE, TT on ffn+attn at rank 4, in both packages."""
    if not _built:
        def tt(cls):
            return cls(enabled=True, families=("ffn", "attn"), rank=4,
                       min_factor=2, backend="auto")
        jm = jbuild(jget_config("deepseek_7b", "smoke", tt=tt(JTTConfig)))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(tget_config("deepseek_7b", "smoke", tt=tt(TTTConfig)),
                    device="cpu")
        _built["m"] = (jm, jp, tm, from_jax_params(
            jax.tree.map(np.asarray, jp), tm))
    return _built["m"]


# ---------------------------------------------------------------- the store
def _awkward():
    """(the port's arrays, the reference's): a bf16 leaf, int8, 0-d, an
    empty table and a leaf spanning chunks of 1 KiB."""
    bf = torch.arange(6, dtype=torch.float32).reshape(2, 3).div(7).to(
        torch.bfloat16)
    rest = {"int8": (np.arange(7) - 3).astype(np.int8),
            "zero_d": np.asarray(2.5, np.float32),
            "empty_table": np.zeros((0, 4), np.int32),
            "big": np.arange(70_000, dtype=np.float32)}
    ref_bf = np.asarray(bf.float().numpy()).astype(ml_dtypes.bfloat16)
    return {"bf16": bf, **rest}, {"bf16": ref_bf, **rest}


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_generations_cross_read_between_the_packages(writer, tmp_path):
    mine, ref = _awkward()
    root = str(tmp_path)
    if writer == "port":
        durable.write_generation(root, {"t": 1}, mine, chunk_bytes=1024)
        _, tree, back, manifest, _ = jdurable.load_latest_good(root)
        want = ref
    else:
        jdurable.write_generation(root, {"t": 1}, ref, chunk_bytes=1024)
        _, tree, back, manifest, _ = durable.load_latest_good(root)
        want = mine
    assert tree == {"t": 1}
    assert manifest["arrays"]["bf16"]["dtype"] == "bfloat16"
    assert set(back) == set(want)
    for k, a in want.items():
        b = back[k]
        if k == "bf16":
            assert isinstance(b, torch.Tensor) == (writer == "reference")
            assert (b.dtype == torch.bfloat16 if writer == "reference"
                    else b.dtype == ml_dtypes.bfloat16)
        else:
            assert b.dtype == a.dtype
        assert tuple(b.shape) == tuple(a.shape)
        assert _bytes(b) == _bytes(a)
    # and the bytes on disk are the same file
    other = str(tmp_path / "other")
    (jdurable if writer == "port" else durable).write_generation(
        other, {"t": 1}, ref if writer == "port" else mine, chunk_bytes=1024)
    assert open(os.path.join(root, "gen_00000001", "arrays.bin"),
                "rb").read() == open(os.path.join(
                    other, "gen_00000001", "arrays.bin"), "rb").read()


def test_awkward_leaves_round_trip(tmp_path):
    mine, _ = _awkward()
    index = durable.write_arrays(str(tmp_path), mine, chunk_bytes=1024)
    back = durable.read_arrays(str(tmp_path / "arrays.bin"), index,
                               chunk_bytes=1024)
    assert set(back) == set(mine)
    for k, a in mine.items():
        assert _bytes(back[k]) == _bytes(a) and back[k].dtype == a.dtype


def test_generation_fallback_on_truncation_and_bitflip(tmp_path):
    root = str(tmp_path)
    for i in range(3):
        durable.write_generation(root, {"i": i}, {"a": np.arange(100) + i})
    assert durable.committed_generations(root) == [1, 2, 3]
    with open(os.path.join(root, "gen_00000003", "arrays.bin"), "r+b") as f:
        f.truncate(37)
    gen, tree, arrays, _m, skipped = durable.load_latest_good(root)
    assert gen == 2 and tree == {"i": 1} and len(skipped) == 1
    assert "truncated" in skipped[0]
    p = os.path.join(root, "gen_00000002", "arrays.bin")
    b = bytearray(open(p, "rb").read())
    b[11] ^= 0x10
    open(p, "wb").write(bytes(b))
    gen, tree, *_ = durable.load_latest_good(root)
    assert gen == 1 and tree == {"i": 0}
    with open(os.path.join(root, "gen_00000001", "arrays.bin"), "r+b") as f:
        f.truncate(3)
    with pytest.raises(durable.CorruptGenerationError,
                       match="every generation .* corrupt"):
        durable.load_latest_good(root)
    with pytest.raises(FileNotFoundError):
        durable.load_latest_good(str(tmp_path / "empty"))


def test_tmp_dirs_schema_and_pruning(tmp_path):
    root = str(tmp_path)
    durable.write_generation(root, {"ok": True}, {"a": np.arange(4)})
    torn = os.path.join(root, "gen_00000002.tmp.999")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"schema": durable.DURABLE_SCHEMA}, f)
    assert durable.committed_generations(root) == [1]
    mp = os.path.join(root, "gen_00000001", "manifest.json")
    m = json.load(open(mp))
    m["schema"] = durable.DURABLE_SCHEMA + 1
    json.dump(m, open(mp, "w"))
    with pytest.raises(durable.CorruptGenerationError, match="schema"):
        durable.load_generation(root, 1)
    for i in range(4):
        durable.write_generation(root, {"i": i}, {"a": np.arange(3)})
    durable.prune_generations(root, keep=2)
    assert durable.committed_generations(root) == [4, 5]


# ----------------------------------------------------------- snapshot files
def test_numpy_scalars_round_trip_through_snapshot_files(tmp_path):
    snap = {"version": 1, "flag": np.True_, "off": np.False_,
            "n": np.int64(3), "x": np.float32(0.5),
            "arr": np.asarray([True, False]),
            "bf": torch.ones(3, dtype=torch.bfloat16),
            "nested": [np.bool_(True), {"k": np.int32(-2)}]}
    back = faults.load_snapshot(faults.save_snapshot(str(tmp_path), snap))
    assert back["flag"] is True and back["off"] is False
    assert back["n"] == 3 and back["x"] == 0.5
    assert back["nested"] == [True, {"k": -2}]
    np.testing.assert_array_equal(back["arr"], [True, False])
    assert back["bf"].dtype == torch.bfloat16 and back["bf"].sum() == 3
    assert faults._split_arrays(np.True_, {}, "p") is True


def test_load_snapshot_refuses_mismatched_or_foreign_trees(tmp_path):
    root = str(tmp_path / "a")
    tree = {"version": 1,
            "a": {"__arr__": "snap/a"}, "b": {"__arr__": "snap/b"}}
    durable.write_generation(root, tree, {"snap/a": np.arange(3),
                                          "snap/zzz": np.arange(2)})
    with pytest.raises(RuntimeError) as ei:
        faults.load_snapshot(root)
    assert "snap/b" in str(ei.value) and "snap/zzz" in str(ei.value)
    root = str(tmp_path / "b")
    durable.write_generation(root, {"not_a": "snapshot"}, {})
    with pytest.raises(RuntimeError, match="version"):
        faults.load_snapshot(root)
    faults.save_snapshot(root, {"version": 1, "n": np.asarray([1])})
    faults.save_snapshot(root, {"version": 1, "n": np.asarray([2])})
    assert int(faults.load_snapshot(root)["n"][0]) == 2
    assert int(faults.load_snapshot(root, generation=2)["n"][0]) == 1


# ------------------------------------------------------------------ journal
def test_journal_torn_tail_and_corrupt_record(tmp_path):
    path = str(tmp_path / "j.log")
    j = RequestJournal(path, fsync=False)
    for i in range(3):
        j.append({"type": "submit", "uid": i})
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"type": "submit", "uid": 3, "se')
    records, good = RequestJournal.replay(path)
    assert [r["uid"] for r in records] == [0, 1, 2]
    assert good < os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(good)
    j2 = RequestJournal(path, fsync=False)
    j2.append({"type": "submit", "uid": 3})
    j2.close()
    records, good = RequestJournal.replay(path)
    assert [r["uid"] for r in records] == [0, 1, 2, 3]
    assert good == os.path.getsize(path)
    lines = open(path, "rb").read().splitlines(keepends=True)
    lines[1] = lines[1].replace(b'"uid": 1', b'"uid": 9')  # crc now wrong
    open(path, "wb").write(b"".join(lines))
    records, good = RequestJournal.replay(path)
    assert [r["uid"] for r in records] == [0] and good == len(lines[0])


def test_request_round_trips_with_its_generator_state():
    g = torch.Generator().manual_seed(5)
    torch.rand(3, generator=g)            # a stream already under way
    req = Request(uid=4, inputs={"tokens": torch.arange(5)[None],
                                 "image_embeds": torch.ones(
                                     1, 2, 3, dtype=torch.bfloat16)},
                  max_new_tokens=3, key=g, temperature=0.7, top_k=5,
                  priority=2, deadline_s=1.5)
    back = decode_request(json.loads(json.dumps(encode_request(req))))
    assert torch.equal(back.inputs["tokens"], req.inputs["tokens"])
    assert back.inputs["image_embeds"].dtype == torch.bfloat16
    assert torch.equal(back.inputs["image_embeds"],
                       req.inputs["image_embeds"])
    assert (back.uid, back.max_new_tokens, back.temperature, back.top_k,
            back.priority, back.deadline_s) == (4, 3, 0.7, 5, 2, 1.5)
    assert torch.equal(torch.rand(4, generator=back.key),
                       torch.rand(4, generator=g))


# -------------------------------------------------------- DurableScheduler
def _requests(n, temperature=0.0):
    rows = np.random.default_rng(11).integers(0, 256, (n, S),
                                              dtype=np.int64)
    mine = [Request(uid=u, inputs={"tokens": torch.from_numpy(
        rows[u:u + 1])}, max_new_tokens=STEPS, temperature=temperature)
        for u in range(n)]
    ref = [JRequest(uid=u, inputs={"tokens": jnp.asarray(
        rows[u:u + 1], jnp.int32)}, max_new_tokens=STEPS)
        for u in range(n)]
    return mine, ref


def _kw(**over):
    return dict(num_slots=2, cache_len=S + STEPS + 2, paged=True,
                block_size=BLOCK, num_blocks=10, **over)


def test_acknowledged_submit_survives_an_immediate_kill(tmp_path):
    jm, jp, tm, tp = _models()
    mine_reqs, ref_reqs = _requests(3)
    outs = []
    for pkg, model, params, reqs, sched_cls, ds_cls, clock, kw in (
            ("port", tm, tp, mine_reqs, Scheduler, DurableScheduler,
             faults.step_clock, _kw(seed=7)),
            ("ref", jm, jp, ref_reqs, JScheduler, JDurableScheduler,
             jstep_clock, _kw(key=jax.random.PRNGKey(7)))):
        root = str(tmp_path / pkg)
        clk = {"t": 0.0}
        ds = ds_cls(sched_cls(model, params, clock=clock(clk), **kw), root)
        for r in reqs:
            ds.submit(r)
        ds.close()                        # kill -9: no step, no snapshot
        del ds
        rec = ds_cls.recover(root, model, params, clock=clock(clk))
        assert len(rec.queue) == 3
        while not rec.idle:
            clk["t"] += 1
            rec.step()
        rec.allocator.assert_quiescent()
        outs.append({f.uid: np.asarray(f.tokens).tolist()
                     for f in rec.finished})
        rec.close()
    assert outs[0] == outs[1] and sorted(outs[0]) == [0, 1, 2]


def test_recovery_after_a_drain_duplicates_nothing(tmp_path):
    _, _, tm, tp = _models()
    reqs, _ = _requests(3, temperature=0.5)
    root = str(tmp_path / "store")
    clk = {"t": 0.0}
    ds = DurableScheduler(Scheduler(tm, tp, clock=faults.step_clock(clk),
                                    **_kw()), root, snapshot_every=2)
    for r in reqs:
        ds.submit(r)
    while not ds.idle:
        clk["t"] += 1
        ds.step()
    first = {f.uid: f.tokens.tolist() for f in ds.finished}
    assert len(ds.checkpoints) >= 2
    ds.close()
    rec = DurableScheduler.recover(root, tm, tp,
                                   clock=faults.step_clock(clk))
    assert rec.idle and len(rec.finished) == 3
    assert {f.uid: f.tokens.tolist() for f in rec.finished} == first
    rec.close()


@pytest.mark.parametrize("kill", [2, 5])
def test_sampled_streams_survive_a_kill(kill, tmp_path):
    """Per-request generators ride in the snapshot (mid-stream slots) and
    in the journal (submits after it): the sampled streams of an
    uninterrupted run, bit for bit."""
    _, _, tm, tp = _models()
    reqs, _ = _requests(4, temperature=0.8)
    rep = faults.run_with_faults(
        tm, tp, reqs, faults.FaultPlan(kill_steps=frozenset({kill})),
        sched_kwargs=_kw(seed=3), arrival_steps=[0, 0, 1, 3],
        durable_dir=str(tmp_path / "store"), snapshot_every=2)
    assert rep.kills == 1 and sorted(rep.survivors) == [0, 1, 2, 3]


# ---------------------------------------------------------------- the CLI
@pytest.mark.parametrize("extra", [[], ["--paged", "--block-size", "4"],
                                   ["--chunk-prefill", "--chunk-size", "3",
                                    "--paged", "--block-size", "4"]],
                         ids=["dense", "paged", "chunked"])
def test_serve_cli_fault_smoke_on_cpu(extra, capsys):
    out = serve.main(CLI + ["--fault-smoke"] + extra)
    assert "fault-injection smoke OK" in capsys.readouterr().out
    rep = out["report"]
    assert rep.restarts == 1 and rep.replans == 0 and rep.cancelled == 1
    assert len(rep.resize_s) == 1 and rep.rebuild_captures == 0


def test_serve_cli_durability_smoke_on_cpu(capsys):
    out = serve.main(CLI + ["--durability-smoke", "--paged",
                            "--block-size", "4"])
    text = capsys.readouterr().out
    assert "durability smoke OK" in text and "kill drill OK" in text
    assert out["kills"] == 2


def test_serve_cli_durable_arrivals_then_restore(tmp_path, capsys):
    d = str(tmp_path / "store")
    args = CLI + ["--arrival-rate", "1000", "--durable", d,
                  "--snapshot-every", "3"]
    out = serve.main(args)
    assert sorted(f.uid for f in out["finished"]) == [0, 1, 2, 3, 4]
    assert not out["interrupted"] and not out["preserved"]
    back = serve.main(args + ["--restore"])
    assert "recovered from" in capsys.readouterr().out
    assert sorted(f.uid for f in back["finished"]) == [0, 1, 2, 3, 4]
    assert [f.tokens.tolist() for f in sorted(back["finished"],
                                              key=lambda f: f.uid)] == [
        f.tokens.tolist() for f in sorted(out["finished"],
                                          key=lambda f: f.uid)]
