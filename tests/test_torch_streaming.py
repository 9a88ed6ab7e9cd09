"""The port's streaming front end on the CPU against the reference's:
``Request.on_token``, ``serving.engine.StreamEngine``, the SSE server
(``serving.server``), journal-aware reconnect, the build cache
(``launch.cache``) and serve's ``--serve``, ``--serve-smoke`` and
``--first-token``.

Models: qwen3-32b SMOKE on a paged, chunked pool (2 slots over 32
positions, blocks of 4, chunks of 4: the reference test's setup) and
deepseek-7b SMOKE with TT on ffn+attn at rank 4, length 2 ``auto``, fp32
and int8 cores, on a dense pool; the reference's weights carried into the
port by ``convert.from_jax_params``, prompts drawn with numpy from a seed,
each model built once per module.

- ``StreamEngine``: the port's greedy tokens are the reference
  ``StreamEngine``'s, logprobs within 1e-4 (XLA and torch sum in other
  orders); events arrive in index order, a replay from an offset gives
  the tail, and every result is a synchronous port ``Scheduler.run``'s of
  the same requests, bit for bit.
- ``on_token``: the ``(uid, index, token)`` sequence a schedule that
  preempts one request emits is the reference's, and no index is emitted
  twice (the resume continues from the requeued tokens).
- A request the scheduler refuses (a prompt and budget over the cache, a
  token-only request to a model that needs image embeddings) ends
  ``"rejected: …"``.
- The SSE server end to end: two overlapping clients, a reconnect from an
  index, a non-streaming request, /stats, 400, 404, /shutdown.
- Journal-aware reconnect: a ``DurableScheduler`` (a snapshot every
  step) whose engine stops with ``close(drain=False)`` after 3 tokens;
  after ``recover`` a new engine replays the stream from index 2 and from
  0, the reference's crash-free tokens.
- A loop-thread failure is raised from ``stream`` (after the buffered
  tokens), ``result``, ``submit`` and ``close``, never a timeout.
- ``on_token`` is left out of snapshots and journals.
- ``enable_compile_cache`` moves the kernel build directory and
  ``cache_entries`` counts its libraries (no ``nvcc`` here).
- serve's ``--serve-smoke``, ``--first-token`` (with the cache check) and
  ``--serve --durable DIR [--restore]`` on ``--device cpu``.

Every wait is bounded: thread joins, HTTP connections, ``stream`` and
``result`` take timeouts, and servers bind port 0.
"""
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build as jbuild, get_config as jget_config
from repro.configs.base import TTConfig as JTTConfig
from repro.serving.engine import StreamEngine as JStreamEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs import build as tbuild, get_config as tget_config
from repro_torch.configs.base import TTConfig as TTTConfig
from repro_torch.convert import from_jax_params
from repro_torch.kernels import tt_contract
from repro_torch.launch import cache, serve
from repro_torch.serving.durable import DurableScheduler, encode_request
from repro_torch.serving.engine import StreamEngine
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.server import make_server

TOL = 1e-4          # port against the reference (logprobs)
WAIT = 60.0         # the bound of every wait
S, STEPS = 10, 6
# the reference test's pool; deepseek's dense pool
PAGED = dict(num_slots=2, cache_len=32, paged=True, block_size=4,
             chunk_prefill=True, chunk_size=4)
DENSE = dict(num_slots=2, cache_len=32)
SETUPS = {"qwen3-paged-chunked": ("qwen3_32b", "fp32", PAGED),
          "deepseek-fp": ("deepseek_7b", "fp32", DENSE),
          "deepseek-int8": ("deepseek_7b", "int8", DENSE)}
SMOKE_CLI = ["--variant", "smoke", "--device", "cpu", "--tt", "ffn,attn",
             "--tt-rank", "4", "--tt-backend", "auto", "--slots", "2",
             "--prompt-len", "8", "--steps", "6"]

_built: dict = {}


def _models(arch, weights="fp32"):
    """(reference model, its params, port model, its params): qwen3 SMOKE
    without TT, deepseek-7b SMOKE with TT on ffn+attn at rank 4."""
    if (arch, weights) not in _built:
        tt = {}
        if arch == "deepseek_7b":
            def make(cls):
                return cls(enabled=True, families=("ffn", "attn"), rank=4,
                           min_factor=2, backend="auto", weights=weights)
            tt = {"j": make(JTTConfig), "t": make(TTTConfig)}
        jm = jbuild(jget_config(arch, "smoke", tt=tt.get("j")))
        jp = jm.init(jax.random.PRNGKey(0))
        if weights == "int8":
            jp = jm.quantize_params(jp)
        tm = tbuild(tget_config(arch, "smoke", tt=tt.get("t")), device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm)
        _built[arch, weights] = (jm, jp, tm, tp)
    return _built[arch, weights]


def _prompts(vocab, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, S),
                                                dtype=np.int64)


def _reqs(rows, steps=STEPS, cls=Request):
    return [cls(uid=i, inputs={"tokens": torch.from_numpy(rows[i:i + 1])},
                max_new_tokens=steps) for i in range(len(rows))]


def _jreqs(rows, steps=STEPS):
    return [JRequest(uid=i, inputs={"tokens": jnp.asarray(rows[i:i + 1],
                                                          jnp.int32)},
                     max_new_tokens=steps) for i in range(len(rows))]


def _sync(tm, tp, pool, reqs):
    sched = Scheduler(tm, tp, **pool)
    for r in reqs:
        sched.submit(r)
    out = sched.run()
    sched.close()
    return out


_reference: dict = {}


def _reference_run(setup):
    """The reference ``StreamEngine``'s results for the setup's two
    prompts: {uid: (tokens, logprobs)}."""
    if setup not in _reference:
        arch, weights, pool = SETUPS[setup]
        jm, jp, _, _ = _models(arch, weights)
        rows = _prompts(jm.cfg.vocab_size)
        eng = JStreamEngine(JScheduler(jm, jp, **pool))
        try:
            for r in _jreqs(rows):
                eng.submit(r)
            res = {u: eng.result(u, timeout=WAIT) for u in (0, 1)}
        finally:
            eng.close()
        _reference[setup] = {u: (np.asarray(f.tokens), np.asarray(
            f.logprobs)) for u, f in res.items()}
    return _reference[setup]


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)


def _call(port, method, path, body=None):
    """One request: (status, the whole response's bytes); the connection
    closed."""
    c = _conn(port)
    try:
        c.request(method, path, None if body is None else json.dumps(body))
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _parse(data: bytes) -> list[dict]:
    """The ``data:`` events of a whole SSE body."""
    return [json.loads(line[6:]) for line in data.split(b"\n")
            if line.startswith(b"data: ")]


# ------------------------------------------------------------ StreamEngine
@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_streams_the_reference_tokens(setup):
    arch, weights, pool = SETUPS[setup]
    _, _, tm, tp = _models(arch, weights)
    rows = _prompts(tm.cfg.vocab_size)
    want = _reference_run(setup)
    sync = _sync(tm, tp, pool, _reqs(rows))
    eng = StreamEngine(Scheduler(tm, tp, **pool))
    try:
        for r in _reqs(rows):
            eng.submit(r)
        for uid in (0, 1):
            f = eng.result(uid, timeout=WAIT)
            np.testing.assert_array_equal(f.tokens, want[uid][0])
            np.testing.assert_allclose(f.logprobs, want[uid][1], atol=TOL)
            assert np.array_equal(f.tokens, sync[uid].tokens)
            assert np.array_equal(f.logprobs, sync[uid].logprobs)
            evs = list(eng.stream(uid, timeout=WAIT))
            assert evs[-1] == {"uid": uid, "done": "length"}
            assert [e["i"] for e in evs[:-1]] == list(range(STEPS))
            assert [e["token"] for e in evs[:-1]] == f.tokens.tolist()
            assert np.array_equal(np.float32([e["lp"] for e in evs[:-1]]),
                                  f.logprobs)
            tail = list(eng.stream(uid, start=4, timeout=WAIT))
            assert [e["i"] for e in tail[:-1]] == [4, 5]
        assert eng.stats()["requests_done"] == 2
    finally:
        eng.close(timeout=WAIT)
    with pytest.raises(KeyError):
        list(eng.stream(999, timeout=WAIT))
    with pytest.raises(RuntimeError, match="shutting down"):
        eng.submit(_reqs(rows)[0])


def test_concurrent_clients_under_a_short_switch_interval():
    """Sixteen threads (more than the sandbox's cores) each allocate a uid
    and submit the same prompt while the loop steps, with the interpreter
    switching threads every microsecond: every uid is distinct, every
    stream holds its indices once and in order, and every request gets the
    synchronous scheduler's tokens for that prompt."""
    _, _, tm, tp = _models("deepseek_7b")
    row = _prompts(tm.cfg.vocab_size, n=1)[:, :4]
    want = _sync(tm, tp, DENSE, _reqs(row, steps=3))[0].tokens.tolist()
    eng = StreamEngine(Scheduler(tm, tp, **DENSE))
    uids, streams = [], {}
    lock = threading.Lock()

    def client():
        uid = eng.alloc_uid()
        eng.submit(Request(uid=uid, inputs={"tokens": torch.from_numpy(row)},
                           max_new_tokens=3))
        evs = list(eng.stream(uid, timeout=WAIT))
        with lock:
            uids.append(uid)
            streams[uid] = evs

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=client) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.close(timeout=WAIT)
    assert sorted(uids) == list(range(16))
    for uid, evs in streams.items():
        assert [e.get("i") for e in evs] == [0, 1, 2, None]
        assert [e["token"] for e in evs[:-1]] == want
        assert evs[-1] == {"uid": uid, "done": "length"}


# --------------------------------------------------------------- on_token
def _preempting_schedule(sched, reqs, log):
    """Two requests fill both slots; after two steps a request of priority
    9 arrives and preempts the younger one, which resumes once a slot
    frees.  Every ``on_token`` call is logged."""
    for r in reqs:
        r.on_token = lambda *a: log.append(a)
    sched.submit(reqs[0], submit_time=0.0)
    sched.submit(reqs[1], submit_time=1.0)
    sched.step()
    sched.step()
    sched.submit(reqs[2], submit_time=2.0)
    sched.run()
    return sched


def test_on_token_sequence_is_the_reference_under_preemption():
    jm, jp, tm, tp = _models("deepseek_7b")
    rows = _prompts(tm.cfg.vocab_size, n=3, seed=3)
    jlog, tlog = [], []
    jreqs = [dataclasses.replace(r, priority=9 if r.uid == 2 else 0)
             for r in _jreqs(rows)]
    treqs = [dataclasses.replace(r, priority=9 if r.uid == 2 else 0)
             for r in _reqs(rows)]
    js = _preempting_schedule(JScheduler(jm, jp, **DENSE), jreqs, jlog)
    ts = _preempting_schedule(Scheduler(tm, tp, **DENSE), treqs, tlog)
    ts.close()
    assert js.preemptions == ts.preemptions == 1
    assert [(u, i, int(t)) for u, i, t, _ in tlog] == \
        [(u, i, int(t)) for u, i, t, _ in jlog]
    np.testing.assert_allclose([lp for *_, lp in tlog],
                               [float(lp) for *_, lp in jlog], atol=TOL)
    # each index once, in order, per request; the log is the results
    fin = {f.uid: f for f in ts.finished}
    for uid in range(3):
        mine = [(i, t, lp) for u, i, t, lp in tlog if u == uid]
        assert [i for i, _, _ in mine] == list(range(STEPS))
        assert [t for _, t, _ in mine] == fin[uid].tokens.tolist()
        assert np.array_equal(np.float32([lp for *_, lp in mine]),
                              fin[uid].logprobs)


@pytest.mark.parametrize("case", ["over the cache", "no image embeddings"])
def test_a_refused_request_ends_rejected(case):
    rows = None
    if case == "over the cache":
        _, _, tm, tp = _models("qwen3_32b")
        pool, steps, extra = PAGED, 999, {}
    else:
        tm = tbuild(tget_config("internvl2_2b", "smoke"), device="cpu")
        tp, pool, steps = tm.init(0), DENSE, 4
        extra = {"image_embeds": torch.from_numpy(
            np.random.default_rng(1).standard_normal(
                (1, 4, tm.cfg.frontend_dim), dtype=np.float32))}
    rows = _prompts(tm.cfg.vocab_size, n=2)
    eng = StreamEngine(Scheduler(tm, tp, **pool))
    try:
        eng.submit(_reqs(rows[:1], steps=steps)[0])
        evs = list(eng.stream(0, timeout=WAIT))
        assert evs[-1]["done"].startswith("rejected:")
        with pytest.raises(RuntimeError, match="rejected"):
            eng.result(0, timeout=WAIT)
        # the loop lives on: the next request, whole, is served
        ok = _reqs(rows, steps=2)[1]
        ok.inputs.update(extra)
        eng.submit(ok)
        assert len(eng.result(1, timeout=WAIT).tokens) == 2
    finally:
        eng.close(timeout=WAIT)


# --------------------------------------------------------------- the server
def test_sse_server_end_to_end():
    _, _, tm, tp = _models("qwen3_32b")
    rows = _prompts(tm.cfg.vocab_size)
    want = _reference_run("qwen3-paged-chunked")
    eng = StreamEngine(Scheduler(tm, tp, **PAGED))
    srv = make_server(eng)
    port = srv.server_address[1]
    srv_t = threading.Thread(target=srv.serve_forever, daemon=True)
    srv_t.start()
    try:
        outs = {0: [], 1: []}
        stamps = {0: [], 1: []}

        def client(uid):
            c = _conn(port)
            c.request("POST", "/generate", json.dumps(
                {"tokens": rows[uid].tolist(), "max_new_tokens": STEPS,
                 "uid": uid}), {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            for ev in serve.sse_events(r):
                outs[uid].append(ev)
                stamps[uid].append(time.perf_counter())
                if "done" in ev or "error" in ev:
                    break
            c.close()

        ts = [threading.Thread(target=client, args=(u,)) for u in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
            assert not t.is_alive()
        for uid, o in outs.items():
            assert o[-1].get("done") == "length"
            assert [e["i"] for e in o[:-1]] == list(range(STEPS))
            assert [e["token"] for e in o[:-1]] == want[uid][0].tolist()
        assert max(s[0] for s in stamps.values()) < \
            min(s[-1] for s in stamps.values()), "streams did not overlap"

        # reconnect: replay uid 0 from index 3, same tokens in order
        code, data = _call(port, "GET", "/stream/0?from=3")
        evs = _parse(data)
        assert code == 200 and evs[-1] == {"uid": 0, "done": "length"}
        assert [e["i"] for e in evs[:-1]] == [3, 4, 5]
        assert [e["token"] for e in evs[:-1]] == \
            [e["token"] for e in outs[0][3:-1]]

        # non-streaming: one JSON result, the same greedy tokens
        code, data = _call(port, "POST", "/generate", {
            "tokens": rows[0].tolist(), "max_new_tokens": 4,
            "stream": False})
        res = json.loads(data)
        assert res["finish_reason"] == "length" and res["uid"] == 2
        assert res["tokens"] == [e["token"] for e in outs[0][:4]]

        for method, path, body, want_code in (
                ("POST", "/generate", {"tokens": [[1, 2]]}, 400),
                ("POST", "/generate", {"tokens": "x",
                                       "max_new_tokens": 2}, 400),
                ("GET", "/stream/abc", None, 400),
                ("GET", "/nowhere", None, 404),
                ("POST", "/nowhere", {}, 404)):
            code, data = _call(port, method, path, body)
            assert code == want_code, (method, path, code)
            assert "error" in json.loads(data)

        # an unknown uid's stream ends with an error event
        code, data = _call(port, "GET", "/stream/77")
        assert "error" in _parse(data)[0]

        code, data = _call(port, "GET", "/stats")
        st = json.loads(data)
        assert st["prefill_chunks"] > 0 and st["requests_done"] == 3
        assert st["tokens_out"] == 2 * STEPS + 4

        code, data = _call(port, "POST", "/shutdown", {})
        assert json.loads(data)["ok"]
        srv_t.join(WAIT)
        assert not srv_t.is_alive()
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close(timeout=WAIT)


# ------------------------------------------------- journal-aware reconnect
def test_journal_aware_reconnect(tmp_path):
    jm, jp, tm, tp = _models("qwen3_32b")
    rows = _prompts(tm.cfg.vocab_size, n=1)
    req = _reqs(rows, steps=8)[0]
    jeng = JStreamEngine(JScheduler(jm, jp, **PAGED))
    try:
        jeng.submit(_jreqs(rows, steps=8)[0])
        ref = jeng.result(0, timeout=WAIT).tokens.tolist()
    finally:
        jeng.close()

    root = str(tmp_path / "durable")
    ds = DurableScheduler(Scheduler(tm, tp, **PAGED), root, snapshot_every=1)
    step = ds.step

    def held():
        """Past 3 tokens the loop steps no more until the engine stops,
        so the crash below finds the request mid-stream."""
        deadline = time.perf_counter() + WAIT
        while ds.sched.tokens_out >= 3 and not eng._stop and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        return [] if ds.sched.tokens_out >= 3 else step()

    ds.step = held
    eng = StreamEngine(ds)
    eng.submit(dataclasses.replace(req))
    seen = []
    for ev in eng.stream(0, timeout=WAIT):
        seen.append(ev)
        if len(seen) >= 3:
            break
    eng.close(drain=False, timeout=WAIT)   # crash: in-flight work abandoned
    assert ds.closed and ds.journal is None

    ds2 = DurableScheduler.recover(root, tm, tp)
    assert not ds2.finished and ds2.num_active == 1
    eng2 = StreamEngine(ds2)
    try:
        assert 1 <= len(eng2._buffers[0]) <= 3, \
            "the acknowledged tokens are lost"
        evs = list(eng2.stream(0, start=2, timeout=WAIT))
        assert evs[-1] == {"uid": 0, "done": "length"}
        assert [e["i"] for e in evs[:-1]] == list(range(2, 8))
        assert [e["token"] for e in evs[:-1]] == ref[2:]
        full = list(eng2.stream(0, timeout=WAIT))
        assert [e["token"] for e in full[:-1]] == ref
        assert [e["token"] for e in seen] == ref[:3]
    finally:
        eng2.close(timeout=WAIT)


# ------------------------------------------------------- a failing loop
def test_a_loop_failure_is_raised_not_timed_out():
    _, _, tm, tp = _models("qwen3_32b")
    sched = Scheduler(tm, tp, **PAGED)
    step = sched.step

    def failing():
        if sched.tokens_out >= 2:
            raise ValueError("the device went away")
        return step()

    sched.step = failing
    eng = StreamEngine(sched)
    eng.submit(_reqs(_prompts(tm.cfg.vocab_size, n=1))[0])
    got = []
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="device went away"):
        for ev in eng.stream(0, timeout=WAIT):
            got.append(ev)
    assert [e["i"] for e in got] == [0, 1]      # the buffered tokens first
    with pytest.raises(ValueError, match="device went away"):
        eng.result(0, timeout=WAIT)
    with pytest.raises(ValueError, match="device went away"):
        eng.submit(_reqs(_prompts(tm.cfg.vocab_size, n=2))[1])
    with pytest.raises(ValueError, match="device went away"):
        eng.close(timeout=WAIT)
    assert time.perf_counter() - t0 < WAIT / 2
    assert sched.closed                           # its graph released


# ------------------------------------------------- snapshots and journals
def test_on_token_is_left_out_of_snapshots_and_journals():
    _, _, tm, tp = _models("deepseek_7b")
    rows = _prompts(tm.cfg.vocab_size, n=3)
    sched = Scheduler(tm, tp, **DENSE)
    calls = []
    for r in _reqs(rows):
        r.on_token = lambda *a: calls.append(a)
        assert "on_token" not in encode_request(r)
        assert "on_token" not in repr(r)
        sched.submit(r)
    sched.step()
    sched.step()
    assert calls and sched.queue            # two slots, one queued

    def keys(tree):
        if isinstance(tree, dict):
            return set(tree) | {k for v in tree.values() for k in keys(v)}
        if isinstance(tree, (list, tuple)):
            return {k for v in tree for k in keys(v)}
        return set()

    snap = sched.snapshot()
    assert "on_token" not in keys(snap)
    sched.close()
    back = Scheduler.from_snapshot(tm, tp, snap)
    live = [s.req for s in back.slots if s is not None] + \
        [q.req for q in back.queue]
    assert len(live) == 3 and all(r.on_token is None for r in live)
    # equality ignores the callback
    r = _reqs(rows)[0]
    assert dataclasses.replace(r, on_token=print) == r
    # an engine over the restored scheduler hooks them again
    eng = StreamEngine(back)
    try:
        assert all(r.on_token == eng._on_token for r in live)
        partial = {s["req"]["uid"]: len(s["tokens"])
                   for s in snap["slots"]}
        assert [len(eng._buffers[u]) for u in range(3)] == \
            [partial[0], partial[1], 0]
        for u in range(3):
            assert len(eng.result(u, timeout=WAIT).tokens) == STEPS
            assert [e.get("i") for e in eng.stream(u, timeout=WAIT)] == \
                list(range(STEPS)) + [None]
    finally:
        eng.close(timeout=WAIT)


# ----------------------------------------------------------- build cache
def test_compile_cache_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tt_contract, "BUILD_DIR", tt_contract.BUILD_DIR)
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.enable_compile_cache(None) is None
    d = tmp_path / "kernels"
    assert cache.cache_entries(str(d)) == 0
    assert cache.enable_compile_cache(str(d)) == str(d)
    assert tt_contract.BUILD_DIR == d and d.is_dir()
    # a library already built there is what build() returns: no nvcc
    lib = d / tt_contract.source_hash() / tt_contract.LIBRARY_NAME
    lib.parent.mkdir()
    lib.write_bytes(b"")
    assert tt_contract.build()[0] == lib
    (d / "stale").mkdir()
    (d / "stale" / tt_contract.LIBRARY_NAME).write_bytes(b"")
    (d / "notes").mkdir()
    assert cache.cache_entries(str(d)) == 2
    # the environment names it when the flag does not
    other = tmp_path / "env"
    monkeypatch.setenv(cache.ENV_VAR, str(other))
    assert cache.enable_compile_cache() == str(other)
    assert tt_contract.BUILD_DIR == other
    # a loaded library pins its directory
    monkeypatch.setattr(tt_contract, "_LIB", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        cache.enable_compile_cache(str(d))
    assert cache.enable_compile_cache(str(other)) == str(other)


# -------------------------------------------------------------- serve CLI
@pytest.mark.parametrize("pool", ["dense", "paged-chunked"])
def test_serve_smoke_on_the_cpu(pool, capsys):
    extra = [] if pool == "dense" else [
        "--paged", "--block-size", "4", "--chunk-prefill", "--chunk-size",
        "4"]
    out = serve.main(SMOKE_CLI + ["--serve-smoke", "--assert-no-replan"] +
                     extra)
    text = capsys.readouterr().out
    assert "overlapping streams OK" in text and "reconnect OK" in text
    assert "streaming smoke OK" in text
    assert out["replans"] == 0 and out["replay_from"] == 3
    assert out["replay_events"] == 3 and out["stats"]["requests_done"] == 2
    for uid in (0, 1):
        assert np.array_equal(out["streamed"][uid][0],
                              out["finished"][uid].tokens)
    # the streams are those of the synchronous scheduler, bit for bit
    args = serve.parse_args(SMOKE_CLI + extra)
    model, params = serve.setup(args)
    sync = _sync(model, params, serve.scheduler_kwargs(args, 8 + 6),
                 [serve.arrival_request(model, args, u, args.seed + u)
                  for u in (0, 1)])
    for uid in (0, 1):
        assert np.array_equal(out["streamed"][uid][0], sync[uid].tokens)
        assert np.array_equal(out["streamed"][uid][1], sync[uid].logprobs)


def test_first_token_and_the_cache_check(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tt_contract, "BUILD_DIR", tt_contract.BUILD_DIR)
    d = str(tmp_path / "cc")
    out = serve.main(SMOKE_CLI + ["--first-token", "--compile-cache", d])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("COLD_START ")]
    assert len(line) == 1
    rec = json.loads(line[0][len("COLD_START "):])
    assert rec == json.loads(json.dumps(out))
    assert rec["start_to_first_token_s"] > 0 and rec["cache_entries"] == 0
    assert rec["compile_cache"] == d and rec["device"] == "cpu"
    # nothing built on the CPU, so an empty cache is no warm start
    with pytest.raises(AssertionError, match="build nothing"):
        serve.main(SMOKE_CLI + ["--first-token", "--compile-cache", d,
                                "--assert-cache-hits"])
    lib = tmp_path / "cc" / tt_contract.source_hash() / \
        tt_contract.LIBRARY_NAME
    lib.parent.mkdir()
    lib.write_bytes(b"")
    out = serve.main(SMOKE_CLI + ["--first-token", "--compile-cache", d,
                                  "--assert-cache-hits"])
    assert out["cache_entries"] == 1


def test_serve_mode_journals_and_restores(tmp_path):
    """``--serve --durable DIR``: a non-streaming request served, then
    /shutdown; ``--restore`` over DIR serves its stream again through
    GET /stream/0 (seeded from the journal) and a new request."""
    root = str(tmp_path / "durable")
    cli = SMOKE_CLI + ["--serve", "--port", "0", "--durable", root]
    first = serve.parse_args(cli)
    model, params = serve.setup(first)
    prompt = _prompts(model.cfg.vocab_size, n=1)[0].tolist()
    got = {}

    def drive(calls):
        def on_ready(srv):
            def run():
                port = srv.server_address[1]
                for method, path, body in calls:
                    _, data = _call(port, method, path, body)
                    got.setdefault(path, []).append(
                        _parse(data) if path.startswith("/stream")
                        else json.loads(data))
            threading.Thread(target=run, daemon=True).start()
        return on_ready

    st = serve.serve_mode(model, params, first, on_ready=drive([
        ("POST", "/generate", {"tokens": prompt, "max_new_tokens": 4,
                               "stream": False}),
        ("POST", "/shutdown", {})]))
    assert st["requests_done"] == 1
    tokens = got["/generate"][0]["tokens"]
    assert len(tokens) == 4
    again = serve.parse_args(cli + ["--restore"])
    st = serve.serve_mode(model, params, again, on_ready=drive([
        ("GET", "/stream/0?from=1", None),
        ("POST", "/generate", {"tokens": prompt, "max_new_tokens": 2,
                               "stream": False}),
        ("POST", "/shutdown", {})]))
    replay = got["/stream/0?from=1"][0]
    assert [e["token"] for e in replay[:-1]] == tokens[1:]
    assert replay[-1] == {"uid": 0, "done": "length"}
    assert got["/generate"][1]["uid"] == 1
    assert got["/generate"][1]["tokens"] == tokens[:2]
    assert st["requests_done"] == 2


def test_an_interrupt_exits_cleanly(monkeypatch, capsys):
    def interrupted(*a, **k):
        raise KeyboardInterrupt
    monkeypatch.setattr(serve, "first_token", interrupted)
    assert serve.main(SMOKE_CLI + ["--first-token"]) == {"interrupted": True}
    assert "interrupted" in capsys.readouterr().out


def test_the_serve_module_stamps_its_start_before_torch():
    code = ("import sys, repro_torch, repro_torch.launch\n"
            "assert 'torch' not in sys.modules\n"
            "import repro_torch.launch.serve as s\n"
            "assert 'torch' in sys.modules and s._PROC_T0 > 0\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=WAIT)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
