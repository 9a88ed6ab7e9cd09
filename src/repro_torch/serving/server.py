"""Minimal HTTP/SSE serving front end over :class:`StreamEngine`, the
reference's ``serving.server``.

Stdlib only (``http.server``).  Protocol (DESIGN.md §15):

    POST /generate   JSON {"tokens": [...], "max_new_tokens": N,
                           "temperature"?, "top_k"?, "priority"?,
                           "deadline_s"?, "uid"?, "stream"? (default true)}
                     → SSE stream of per-token events
                       ``data: {"uid", "i", "token", "lp"}`` ending with
                       ``data: {"uid", "done": reason}``; or, with
                       ``"stream": false``, one JSON result object.
    GET /stream/<uid>?from=N
                     → SSE replay of the request's events from index N,
                       then the live tail: the *reconnect* endpoint.  A
                       client that lost its connection (or its server:
                       buffers recovered from the durable journal replay
                       the same way) resumes the token stream exactly
                       where it left off.
    GET /stats       → scheduler + engine counters as JSON.
    POST /shutdown   → acknowledge, then stop the HTTP loop; the caller
                       drains the engine.

Events carry explicit indices rather than relying on SSE ``id:`` /
``Last-Event-ID``, so reconnect works through any plain HTTP client.

Handler threads never touch the device: a request's tokens become a CPU
``torch.int64`` tensor, which the engine's loop thread moves to the model's
device at admission (on a card, a capture on the loop thread must not meet
a CUDA call from another thread), and ``/stats`` reads host counters only.
Requests carry tokens only: a model that needs its front end's embeddings
(speech frames, images) refuses them at the scheduler's ``submit``, and
the stream ends ``"rejected: …"``.  A stream whose engine failed ends with
an ``{"uid", "error"}`` event.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .engine import StreamEngine
from .scheduler import Request


def _sse(event: dict) -> bytes:
    return f"data: {json.dumps(event)}\n\n".encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    engine: StreamEngine = None           # injected by make_server
    quiet: bool = True

    def log_message(self, fmt, *args):    # pragma: no cover - noise control
        if not self.quiet:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------- plumbing
    def _json_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def _send_json(self, obj: dict, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_sse_events(self, uid: int, start: int) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for ev in self.engine.stream(uid, start=start):
                self.wfile.write(_sse(ev))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass                          # client went away: buffers keep
                                          # the stream replayable
        except Exception as e:            # unknown uid, timeout, failed loop
            self.wfile.write(_sse({"uid": uid, "error": str(e)}))

    # ------------------------------------------------------------ endpoints
    def do_POST(self):                    # noqa: N802 (http.server API)
        path = urlparse(self.path).path
        if path == "/generate":
            try:
                body = self._json_body()
                toks = np.asarray(body["tokens"], np.int64)
                if toks.ndim == 1:
                    toks = toks[None]
                uid = (int(body["uid"]) if "uid" in body
                       else self.engine.alloc_uid())
                req = Request(
                    uid=uid, inputs={"tokens": torch.from_numpy(toks)},
                    max_new_tokens=int(body["max_new_tokens"]),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    priority=int(body.get("priority", 0)),
                    deadline_s=(None if body.get("deadline_s") is None
                                else float(body["deadline_s"])))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._send_json({"error": str(e)}, code=400)
                return
            try:
                self.engine.submit(req)
            except Exception as e:        # shutting down, or a failed loop
                self._send_json({"uid": uid, "error": str(e)}, code=503)
                return
            if body.get("stream", True):
                self._send_sse_events(uid, start=0)
                return
            try:
                f = self.engine.result(uid)
            except Exception as e:        # rejected, timed out, failed loop
                self._send_json({"uid": uid, "error": str(e)}, code=500)
                return
            self._send_json({
                "uid": uid, "tokens": [int(t) for t in f.tokens],
                "logprobs": [float(x) for x in f.logprobs],
                "finish_reason": f.finish_reason})
            return
        if path == "/shutdown":
            self._send_json({"ok": True})
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return
        self._send_json({"error": f"unknown path {path}"}, code=404)

    def do_GET(self):                     # noqa: N802 (http.server API)
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        if parsed.path == "/stats":
            self._send_json(self.engine.stats())
            return
        if len(parts) == 2 and parts[0] == "stream":
            try:
                uid = int(parts[1])
                start = int(parse_qs(parsed.query).get("from", ["0"])[0])
            except ValueError:
                self._send_json({"error": "uid and from must be ints"},
                                code=400)
                return
            self._send_sse_events(uid, start=start)
            return
        self._send_json({"error": f"unknown path {parsed.path}"}, code=404)


def make_server(engine: StreamEngine, host: str = "127.0.0.1",
                port: int = 0, quiet: bool = True) -> ThreadingHTTPServer:
    """Build (not start) the SSE server; ``port=0`` picks an ephemeral
    port (``server.server_address[1]`` has the real one).  Run with
    ``server.serve_forever()``; stop via POST /shutdown or
    ``server.shutdown()``."""
    handler = type("Handler", (_Handler,), {"engine": engine,
                                            "quiet": quiet})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    return srv
