"""HTTP front end for the continuous-batching engine (counterpart of
``desta25_audio_tpu/serve/http.py``).

Stdlib only (``http.server`` and threads): the server moves requests into
the engine and results out; the work is the engine's on the device.

API (JSON in and out):

  GET  /v1/health            -> {"status": "ok", "slots": N, "active",
                                 "queued"}
  POST /v1/generate          body: {"messages": [...] (generate()'s
                             schema), "max_new_tokens", "temperature",
                             "top_p", "do_sample", "deadline_s", "stop",
                             "stop_token_ids", "stream": false}
                             -> {"id", "text", "tokens", "finish_reason",
                                 "truncated", "prompt_tokens"}
       With "stream": true the response is text/event-stream; each
       accepted token arrives as `data: {"token": id, "text": piece}` and
       the last event is `data: {"done": true, "finish_reason": ...,
       "truncated": ..., "text": ...}` (tokens arrive a tick at a time:
       the engine reads the device once a tick).
  DELETE /v1/requests/<id>   -> {"cancelled": true|false}
  GET  /v1/models            -> an OpenAI-style model list
  POST /v1/chat/completions  the OpenAI chat schema (string content or
                             typed parts; audio as {"type":
                             "input_audio", "input_audio": {"data":
                             <base64>, "format": "wav", "transcription":
                             ...}} or {"type": "audio", "audio": <server
                             path>}); max_tokens / max_completion_tokens,
                             temperature (> 0 samples, default 1.0),
                             top_p, stop, stream (SSE
                             chat.completion.chunk deltas, then [DONE]).
                             The engine's own finish reason rides along as
                             choices[0].desta_finish_reason / truncated.

Concurrency: one engine thread steps the engine in a loop that sleeps only
when idle; every engine call (submit, step, cancel, results) runs under
one lock, and after each one every request the engine has finished is
signalled, whichever call finished it: ``results()`` and ``cancel()``
consume the in-flight pipelined tick too, and the requests that tick ends
are not in ``step()``'s list (the JAX server signals only that list, so a
handler reading a result while a tick is in flight can leave the others
waiting forever).  The engine makes its own device, stream and mesh current in
each call, so the engine thread and the handler threads
(``ThreadingHTTPServer``, each blocked on its request's event) share the
engine's stream, whose order its kept graphs rely on.  N concurrent
clients batch into the engine's slots.

Audio: a request names a server-visible audio path ({"audio": path}), or
carries a base64 WAV inline ({"audio_b64": ...}), written to a temporary
file for the request and removed after its submit.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class EngineServer:
    """The engine thread and each request's plumbing (its result event and,
    streaming, its token queue)."""

    def __init__(self, engine, idle_sleep_s: float = 0.005):
        self.engine = engine
        self._lock = threading.Lock()
        self._events: Dict[int, threading.Event] = {}
        self._streams: Dict[int, "queue.Queue"] = {}
        self._open_streams: set = set()   # no sentinel put yet
        self._idle_sleep_s = idle_sleep_s
        self._stop = threading.Event()
        engine.on_token = self._on_token
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- engine thread -----------------------------------------------------

    def _on_token(self, rid: int, tok: int):
        q = self._streams.get(rid)
        if q is not None:
            q.put(tok)

    def _signal_finished(self):
        """Wake the waiter and end the stream of every request the engine
        has finished (call under the lock, after any engine call)."""
        done = self.engine.finished_info
        for rid in [r for r in self._events if r in done]:
            self._events.pop(rid).set()
        for rid in [r for r in self._open_streams if r in done]:
            self._open_streams.discard(rid)
            self._streams[rid].put(None)  # stream sentinel

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                busy = (bool(self.engine.queue)
                        or any(r is not None for r in self.engine.slot_req))
                if busy:
                    self.engine.step()
                self._signal_finished()
            # between ticks a handler waiting on the lock (a submit, a
            # cancel) takes it: without the yield this thread takes the
            # lock straight back and starves them while the engine is busy
            time.sleep(0 if busy else self._idle_sleep_s)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- request plumbing ----------------------------------------------------

    def submit(self, messages, *, stream: bool = False,
               **kw) -> int:
        ev = threading.Event()
        with self._lock:
            rid = self.engine.submit(messages, **kw)
            self._events[rid] = ev
            if stream:
                self._streams[rid] = queue.Queue()
                self._open_streams.add(rid)
            self._signal_finished()
        return rid

    def wait(self, rid: int, timeout: Optional[float] = None
             ) -> Dict[str, Any]:
        ev = self._events.get(rid)
        if ev is not None and not ev.wait(timeout):
            raise TimeoutError(f"request {rid} still running")
        with self._lock:
            res = self.engine.results()[rid]
            self._signal_finished()
        return res

    def result_now(self, rid: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            res = self.engine.results().get(rid)
            self._signal_finished()
        return res

    def cancel(self, rid: int) -> bool:
        with self._lock:
            ok = self.engine.cancel(rid)
            self._signal_finished()
        return ok

    def stream_tokens(self, rid: int):
        """Yield token ids until the request finishes (None sentinel)."""
        q = self._streams[rid]
        try:
            while True:
                tok = q.get()
                if tok is None:
                    return
                yield tok
        finally:
            with self._lock:
                self._streams.pop(rid, None)
                self._open_streams.discard(rid)


def _decode_inline_audio(messages: List[Dict[str, Any]],
                         scratch: List[str]) -> List[Dict[str, Any]]:
    """Replace {"audio_b64": ...} entries with temp wav files."""
    out = []
    for m in messages:
        m = dict(m)
        if m.get("audios"):
            auds = []
            for a in m["audios"]:
                a = dict(a)
                if "audio_b64" in a:
                    f = tempfile.NamedTemporaryFile(
                        suffix=".wav", delete=False)
                    f.write(base64.b64decode(a.pop("audio_b64")))
                    f.close()
                    a["audio"] = f.name
                    scratch.append(f.name)
                auds.append(a)
            m["audios"] = auds
        out.append(m)
    return out


def _oai_to_messages(oai_messages: List[Dict[str, Any]],
                     scratch: List[str]) -> List[Dict[str, Any]]:
    """OpenAI chat schema -> generate() message schema.

    ``content`` may be a plain string or a list of parts; audio parts
    become ``<|AUDIO|>`` placeholders + ``audios`` entries:

      {"type": "text", "text": ...}
      {"type": "input_audio", "input_audio": {"data": <b64 wav>,
          "format": "wav", "transcription": <optional hint>}}
      {"type": "audio", "audio": <server-visible path>,
          "transcription": <optional>}          (extension)

    Audio parts without a transcription run ASR-in-loop downstream
    (reference semantics, modeling_desta25.py:1484-1568)."""
    msgs = []
    for m in oai_messages:
        content = m.get("content", "")
        audios: List[Dict[str, Any]] = []
        if isinstance(content, list):
            text_parts = []
            for part in content:
                t = part.get("type")
                if t == "text":
                    text_parts.append(part["text"])
                elif t == "input_audio":
                    ia = part["input_audio"]
                    fmt = ia.get("format", "wav")
                    f = tempfile.NamedTemporaryFile(
                        suffix=f".{fmt}", delete=False)
                    f.write(base64.b64decode(ia["data"]))
                    f.close()
                    scratch.append(f.name)
                    text_parts.append("<|AUDIO|>")
                    a: Dict[str, Any] = {"audio": f.name}
                    if ia.get("transcription") is not None:
                        a["text"] = ia["transcription"]
                    audios.append(a)
                elif t == "audio":
                    text_parts.append("<|AUDIO|>")
                    a = {"audio": part["audio"]}
                    if part.get("transcription") is not None:
                        a["text"] = part["transcription"]
                    audios.append(a)
                else:
                    raise ValueError(
                        f"unsupported content part type: {t!r}")
            content = "".join(text_parts)
        msg: Dict[str, Any] = {"role": m["role"], "content": content}
        if audios:
            msg["audios"] = audios
        msgs.append(msg)
    return msgs


def _oai_finish(reason: str) -> str:
    """Engine finish_reason -> OpenAI finish_reason (native reason is
    also surfaced as ``desta_finish_reason``)."""
    return "stop" if reason in ("eos", "stop") else "length"


def make_handler(server: EngineServer, tokenizer):
    model_name = getattr(getattr(server.engine, "model", None), "config",
                         None)
    model_name = getattr(model_name, "llm_model_id", "desta25-audio-tpu")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; use logging
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                eng = server.engine
                self._json(200, {
                    "status": "ok",
                    "slots": eng.n_slots,
                    "active": sum(r is not None for r in eng.slot_req),
                    "queued": len(eng.queue),
                })
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": model_name, "object": "model",
                    "owned_by": "desta25_audio_tpu"}]})
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            if self.path.startswith("/v1/requests/"):
                try:
                    rid = int(self.path.rsplit("/", 1)[1])
                except ValueError:
                    self._json(400, {"error": "bad request id"})
                    return
                self._json(200, {"cancelled": server.cancel(rid)})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/v1/generate":
                self._post_generate(req)
            elif self.path == "/v1/chat/completions":
                self._post_chat(req)
            else:
                self._json(404, {"error": "not found"})

        # -- native API ---------------------------------------------------

        def _submit(self, req, messages, kw) -> Optional[int]:
            """Decode inline audio, submit; returns rid or None (a 400
            has been sent)."""
            scratch: List[str] = []
            try:
                messages = _decode_inline_audio(messages, scratch)
                stream = bool(req.get("stream", False))
                return server.submit(messages, stream=stream, **kw)
            except Exception as e:  # noqa: BLE001 (bad audio, overflow)
                self._json(400, {"error": str(e)})
                return None
            finally:
                for p in scratch:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

        def _sse_begin(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse_emit(self, payload: str):
            data = f"data: {payload}\n\n".encode()
            chunk = f"{len(data):x}\r\n".encode() + data + b"\r\n"
            self.wfile.write(chunk)
            self.wfile.flush()

        def _post_generate(self, req):
            try:
                messages = req["messages"]
            except KeyError as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            kw = {}
            for k in ("max_new_tokens", "temperature", "top_p",
                      "do_sample", "deadline_s", "stop",
                      "stop_token_ids"):
                if k in req:
                    kw[k] = req[k]
            if isinstance(kw.get("stop"), str):
                kw["stop"] = [kw["stop"]]
            rid = self._submit(req, messages, kw)
            if rid is None:
                return
            if not req.get("stream", False):
                info = server.wait(rid)
                self._json(200, {"id": rid, **info})
                return
            self._sse_begin()
            try:
                for tok in server.stream_tokens(rid):
                    self._sse_emit(json.dumps(
                        {"token": int(tok),
                         "text": tokenizer.decode(
                             [tok], skip_special_tokens=True)}))
                info = server.result_now(rid) or {}
                self._sse_emit(json.dumps(
                    {"done": True,
                     "finish_reason": info.get("finish_reason", ""),
                     "truncated": info.get("truncated", False),
                     "text": info.get("text", "")}))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                server.cancel(rid)  # client went away: free the slot

        # -- OpenAI-compatible API -----------------------------------------

        def _post_chat(self, req):
            """POST /v1/chat/completions — OpenAI chat schema over the
            engine.  temperature>0 samples (OpenAI semantics; default
            1.0); temperature==0 decodes greedily."""
            try:
                oai_messages = req["messages"]
                scratch: List[str] = []
                messages = _oai_to_messages(oai_messages, scratch)
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": {
                    "message": f"bad request: {e}", "type":
                    "invalid_request_error"}})
                return
            temp = float(req.get("temperature", 1.0))
            kw = {"temperature": temp, "do_sample": temp > 0.0,
                  "top_p": float(req.get("top_p", 1.0))}
            mnt = req.get("max_completion_tokens", req.get("max_tokens"))
            if mnt is not None:
                kw["max_new_tokens"] = int(mnt)
            stop = req.get("stop")
            if stop is not None:
                kw["stop"] = [stop] if isinstance(stop, str) else stop
            try:
                rid = self._submit(req, messages, kw)
            finally:
                for p in scratch:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            if rid is None:
                return
            cid = f"chatcmpl-{rid}"
            created = int(time.time())
            if not req.get("stream", False):
                info = server.wait(rid)
                n_out = len(info.get("tokens", []))
                n_in = int(info.get("prompt_tokens", 0))
                self._json(200, {
                    "id": cid, "object": "chat.completion",
                    "created": created, "model": model_name,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant",
                                    "content": info.get("text", "")},
                        "finish_reason":
                            _oai_finish(info.get("finish_reason", "")),
                        "desta_finish_reason":
                            info.get("finish_reason", ""),
                        "truncated": info.get("truncated", False),
                    }],
                    "usage": {"prompt_tokens": n_in,
                              "completion_tokens": n_out,
                              "total_tokens": n_in + n_out}})
                return
            self._sse_begin()

            def chunk(delta, finish=None):
                return json.dumps({
                    "id": cid, "object": "chat.completion.chunk",
                    "created": created, "model": model_name,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]})

            try:
                self._sse_emit(chunk({"role": "assistant",
                                      "content": ""}))
                for tok in server.stream_tokens(rid):
                    self._sse_emit(chunk({"content": tokenizer.decode(
                        [tok], skip_special_tokens=True)}))
                info = server.result_now(rid) or {}
                self._sse_emit(chunk(
                    {}, _oai_finish(info.get("finish_reason", ""))))
                self._sse_emit("[DONE]")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                server.cancel(rid)

    return Handler


def serve_http(engine, host: str = "127.0.0.1", port: int = 8000):
    """Blocking server entry.  Returns (httpd, engine_server) when used
    programmatically via ``start_http`` instead."""
    httpd, es = start_http(engine, host, port)
    try:
        httpd.serve_forever()
    finally:
        es.close()


def start_http(engine, host: str = "127.0.0.1", port: int = 0):
    """Non-blocking: start the engine thread + HTTP server thread;
    returns (httpd, engine_server).  port=0 picks an ephemeral port
    (httpd.server_address[1])."""
    es = EngineServer(engine)
    handler = make_handler(es, engine.model.tokenizer)
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, es
