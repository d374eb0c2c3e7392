"""The port's HTTP front end (``serve/http.py``) on a real localhost
``ThreadingHTTPServer`` with the nano f32 model of tests/test_http_serving.py
(the JAX package's params carried across by the bridge): the 9 cases of
that file against the port's own one-shot ``generate()`` (JSON generate,
inline base64 audio, SSE, health with a deadline and a cancel, bad
requests, chat completions, chat SSE, a stop sequence, models and errors),
and one generate body and one chat body against the JAX server's on the
same weights (equal but for the chat body's ``created`` clock)."""

import base64
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu import DeSTA25Config as JaxConfig
from desta25_audio_tpu.serve.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from desta25_audio_tpu.serve.http import start_http as jax_start_http
from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params
from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
from desta25_audio_tpu_torch.serve.http import start_http

MAX_NEW = 6
NANO = dict(llm_model_id="test/llama-nano",
            encoder_model_id="test/whisper-nano", prompt_size=8,
            qformer_num_hidden_layers=2, dtype="float32")
ENGINE = dict(n_slots=2, max_ctx=128, max_new_tokens=MAX_NEW, ctx_bucket=128)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(**NANO), seed=0)
    cfg = DeSTA25Config(**NANO)
    params = from_jax_params(jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    return jm, DeSTA25AudioModel(cfg, device="cpu", params=params)


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("http")
    t = np.arange(12000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    p = str(d / "w.wav")
    write_wav(p, sig)
    return p


def _msgs(path):
    return [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio": path, "text": "a tone"}]}]


def _serve(engine, starter):
    httpd, es = starter(engine, port=0)
    return httpd, es, httpd.server_address[1]


@pytest.fixture(scope="module")
def served(model):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    httpd, es, port = _serve(ContinuousBatchingEngine(model, **ENGINE),
                             start_http)
    yield port
    httpd.shutdown()
    es.close()
    torch.set_num_threads(n)


def _post(port, path, obj, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, body=json.dumps(obj),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if stream:
        return resp, conn
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _one_shot(model, msgs):
    return model.generate(msgs, max_new_tokens=MAX_NEW, do_sample=False)


def test_http_generate_matches_one_shot(model, wav_path, served):
    expected = _one_shot(model, _msgs(wav_path)).text[0]
    status, body = _post(served, "/v1/generate",
                         {"messages": _msgs(wav_path),
                          "max_new_tokens": MAX_NEW})
    assert status == 200
    assert body["text"] == expected
    assert body["finish_reason"] in ("eos", "length")
    assert body["truncated"] is False
    assert body["prompt_tokens"] > 0 and 0 < len(body["tokens"]) <= MAX_NEW


def test_http_inline_base64_audio(model, wav_path, served):
    expected = _one_shot(model, _msgs(wav_path)).text[0]
    with open(wav_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    msgs = [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio_b64": b64, "text": "a tone"}]}]
    status, body = _post(served, "/v1/generate",
                         {"messages": msgs, "max_new_tokens": MAX_NEW})
    assert status == 200
    assert body["text"] == expected


def test_http_streaming_sse(model, wav_path, served):
    expected = _one_shot(model, _msgs(wav_path))
    resp, conn = _post(served, "/v1/generate",
                       {"messages": _msgs(wav_path),
                        "max_new_tokens": MAX_NEW, "stream": True},
                       stream=True)
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = [json.loads(c[len("data: "):])
              for c in resp.read().decode().split("\n\n")
              if c.startswith("data: ")]
    conn.close()
    toks = [e["token"] for e in events if "token" in e]
    final = events[-1]
    assert final.get("done") is True
    assert final["text"] == expected.text[0]
    exp_ids = [int(t) for t in np.asarray(expected.generated_ids)[0]
               if int(t) != model.tokenizer.pad_token_id][:len(toks)]
    assert toks == exp_ids and len(toks) >= 1


def test_http_health_cancel_deadline(wav_path, served):
    conn = http.client.HTTPConnection("127.0.0.1", served, timeout=60)
    conn.request("GET", "/v1/health")
    h = json.loads(conn.getresponse().read())
    assert h["status"] == "ok" and h["slots"] == 2
    assert h["active"] == 0 and h["queued"] == 0
    status, body = _post(served, "/v1/generate",
                         {"messages": _msgs(wav_path), "deadline_s": 0.0})
    assert status == 200 and body["finish_reason"] == "deadline"
    assert body["tokens"] == []
    conn.request("DELETE", "/v1/requests/999999")
    assert json.loads(conn.getresponse().read())["cancelled"] is False
    conn.request("DELETE", "/v1/requests/not-an-id")
    resp = conn.getresponse()
    assert resp.status == 400 and "error" in json.loads(resp.read())
    conn.close()


def test_http_bad_requests(served):
    status, body = _post(served, "/v1/generate", {"nope": 1})
    assert status == 400 and "error" in body
    status, body = _post(served, "/v1/nothing", {})
    assert status == 404
    long = [{"role": "user", "content": "word " * 200}]
    status, body = _post(served, "/v1/generate", {"messages": long})
    assert status == 400 and "max_ctx" in body["error"]


def _chat_body(wav_path):
    with open(wav_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return {"messages": [{"role": "user", "content": [
                {"type": "text", "text": "Describe: "},
                {"type": "input_audio",
                 "input_audio": {"data": b64, "format": "wav",
                                 "transcription": "a tone"}}]}],
            "max_tokens": MAX_NEW, "temperature": 0}


def test_openai_chat_completions(model, wav_path, served):
    expected = _one_shot(model, _msgs(wav_path)).text[0]
    status, body = _post(served, "/v1/chat/completions",
                         _chat_body(wav_path))
    assert status == 200
    assert body["object"] == "chat.completion"
    ch = body["choices"][0]
    assert ch["message"]["role"] == "assistant"
    assert ch["message"]["content"] == expected
    assert ch["finish_reason"] in ("stop", "length")
    u = body["usage"]
    assert 0 < u["completion_tokens"] <= MAX_NEW
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert u["prompt_tokens"] > 0


def test_openai_chat_streaming(model, wav_path, served):
    expected = _one_shot(model, _msgs(wav_path)).text[0]
    oai = {"messages": [{"role": "user", "content": [
               {"type": "text", "text": "Describe: "},
               {"type": "audio", "audio": wav_path,
                "transcription": "a tone"}]}],
           "max_tokens": MAX_NEW, "temperature": 0, "stream": True}
    resp, conn = _post(served, "/v1/chat/completions", oai, stream=True)
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = [c[len("data: "):] for c in resp.read().decode().split("\n\n")
              if c.startswith("data: ")]
    conn.close()
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == expected
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_openai_stop_sequence(model, served):
    base = model.generate([{"role": "user", "content": "Say hello."}],
                          max_new_tokens=MAX_NEW, do_sample=False).text[0]
    assert len(base) >= 3
    stop = base[1:3]
    status, body = _post(served, "/v1/chat/completions",
                         {"messages": [{"role": "user",
                                        "content": "Say hello."}],
                          "max_tokens": MAX_NEW, "temperature": 0,
                          "stop": stop})
    assert status == 200
    ch = body["choices"][0]
    assert ch["finish_reason"] == "stop"
    assert ch["desta_finish_reason"] == "stop"
    assert stop not in ch["message"]["content"]
    assert base.startswith(ch["message"]["content"])


def test_openai_models_and_errors(model, served):
    conn = http.client.HTTPConnection("127.0.0.1", served, timeout=60)
    conn.request("GET", "/v1/models")
    m = json.loads(conn.getresponse().read())
    conn.close()
    assert m["object"] == "list" and m["data"][0]["object"] == "model"
    assert m["data"][0]["id"] == model.config.llm_model_id
    status, body = _post(served, "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": [
                             {"type": "bogus"}]}]})
    assert status == 400 and "error" in body
    assert body["error"]["type"] == "invalid_request_error"


# -- against the JAX server ---------------------------------------------------

@pytest.fixture(scope="module")
def both_servers(models):
    """A fresh JAX server and a fresh port server on the same weights (their
    request ids count from 0 alike)."""
    jm, tm = models
    out, stop = [], []
    for engine, starter in ((JaxEngine(jm, **ENGINE), jax_start_http),
                            (ContinuousBatchingEngine(tm, **ENGINE),
                             start_http)):
        httpd, es, port = _serve(engine, starter)
        out.append(port)
        stop.append((httpd, es))
    yield out
    for httpd, es in stop:
        httpd.shutdown()
        es.close()


@pytest.mark.parametrize("route", ["generate", "chat"])
def test_http_bodies_match_jax_server(both_servers, wav_path, route):
    if route == "generate":
        path, req = "/v1/generate", {"messages": _msgs(wav_path),
                                     "max_new_tokens": MAX_NEW}
    else:
        path, req = "/v1/chat/completions", _chat_body(wav_path)
    bodies = []
    for port in both_servers:
        status, body = _post(port, path, req)
        assert status == 200
        body.pop("created", None)
        bodies.append(body)
    assert bodies[0] == bodies[1]
    assert bodies[1]["id"] in (0, 1, "chatcmpl-0", "chatcmpl-1")


def test_http_cancel_running_request(model, wav_path):
    """A running streaming request cancelled by its id: the engine thread
    yields its lock between ticks, so the DELETE lands while the request
    still decodes (one step a tick, 64 new tokens); the stream ends with
    finish_reason "cancelled" and fewer than 64 tokens."""
    import threading
    eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                   max_new_tokens=64, ctx_bucket=128,
                                   steps_per_tick=1)
    httpd, es, port = _serve(eng, start_http)
    try:
        resp, conn = _post(port, "/v1/generate",
                           {"messages": _msgs(wav_path), "stream": True},
                           stream=True)
        events, started = [], threading.Event()

        def read():   # the raw chunked stream, one data line at a time
            for line in iter(resp.fp.readline, b""):
                if line.startswith(b"data: "):
                    events.append(json.loads(line[len(b"data: "):]))
                    started.set()
                    if events[-1].get("done"):
                        return

        t = threading.Thread(target=read)
        t.start()
        assert started.wait(60)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("DELETE", "/v1/requests/0")   # a fresh engine's first id
        cancelled = json.loads(c.getresponse().read())["cancelled"]
        c.close()
        t.join(60)
        conn.close()
        assert cancelled is True
        assert events[-1]["done"] is True
        assert events[-1]["finish_reason"] == "cancelled"
        assert 1 <= len([e for e in events if "token" in e]) < 64
    finally:
        httpd.shutdown()
        es.close()


class _FlushingEngine:
    """An engine stub whose ``results()`` finishes every submitted request,
    as the pipelined engine's flush of its in-flight tick can: none of them
    is in any ``step()``'s list of finished ids."""

    def __init__(self):
        self.queue, self.slot_req, self.on_token = [], [None], None
        self.finished_info, self._submitted = {}, []

    def submit(self, messages, **kw):
        self._submitted.append(len(self._submitted))
        return self._submitted[-1]

    def step(self):
        return []

    def results(self):
        for rid in self._submitted:
            self.finished_info.setdefault(
                rid, {"tokens": [], "finish_reason": "length"})
        return dict(self.finished_info)

    def cancel(self, rid):
        return False


def test_requests_finished_outside_step_are_signalled():
    """A result read that consumes the in-flight tick (``results()``)
    finishes other requests too: their waiters wake and their streams
    end (the JAX server signals only ``step()``'s list, and they waited
    forever)."""
    from desta25_audio_tpu_torch.serve.http import EngineServer
    es = EngineServer(_FlushingEngine())
    try:
        waiting = es.submit([], stream=False)
        streaming = es.submit([], stream=True)
        reader = es.submit([], stream=False)
        assert es.result_now(reader)["finish_reason"] == "length"
        assert es.wait(waiting, timeout=5)["finish_reason"] == "length"
        assert list(es.stream_tokens(streaming)) == []
    finally:
        es.close()


def test_concurrent_clients_all_answered(model, wav_path):
    """Eight concurrent clients on a pipelined engine, two streaming, the
    streams' handlers reading their results while the engine's tick is in
    flight: every client gets its answer."""
    import concurrent.futures
    eng = ContinuousBatchingEngine(model, n_slots=8, max_ctx=128,
                                   max_new_tokens=MAX_NEW, ctx_bucket=128,
                                   steps_per_tick=2)
    httpd, es, port = _serve(eng, start_http)

    def client(i):
        req = {"messages": _msgs(wav_path), "max_new_tokens": MAX_NEW,
               "stream": i < 2}
        if i >= 2:
            status, body = _post(port, "/v1/generate", req)
            return status == 200 and body["finish_reason"] in ("eos", "length")
        resp, conn = _post(port, "/v1/generate", req, stream=True)
        done = '"done": true' in resp.read().decode()
        conn.close()
        return done

    try:
        for _ in range(3):
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                futs = [ex.submit(client, i) for i in range(8)]
                assert all(f.result(timeout=120) for f in futs)
    finally:
        httpd.shutdown()
        es.close()
