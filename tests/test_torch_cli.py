"""The port's CLIs on the CPU (``--device cpu``), mirroring by name the JAX
package's tests/test_cli.py cases ``test_warm_start_from_pretrained_weights``,
``test_cli_generate_smoke`` and ``test_cli_serve_smoke``, and the evaluate
CLI over a nano checkpoint."""

import http.client
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt.synthetic import count_differing

NANO = dict(llm_model_id="test/llama-nano", encoder_model_id="test/whisper-nano",
            prompt_size=4, qformer_num_hidden_layers=2, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(path, secs=0.75, f0=300.0):
    """An amplitude-gated tone: energy VAD hears speech, so a supplied
    transcription is kept."""
    t = np.arange(int(secs * 16000)) / 16000.0
    write_wav(path, (0.5 * np.sin(2 * np.pi * f0 * t)
                     * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32))
    return path


def test_warm_start_from_pretrained_weights(tmp_path):
    """init_from_pretrained_weights loads the donor's trainable params into
    the fresh model (train_desta.py:73-83) and is refused beside resume."""
    from desta25_audio_tpu_torch.cli.train import build_from_config
    donor = DeSTA25AudioModel(DeSTA25Config(**{**NANO, "prompt_size": 8}),
                              "cpu", seed=5)
    donor.save_pretrained(str(tmp_path / "warm"))
    root = tmp_path / "data"
    os.makedirs(root)
    _tone(str(root / "c.wav"), 0.5, 440.0)
    manifest = root / "m.jsonl"
    manifest.write_text(json.dumps({"id": "c.wav", "dataset": "syn",
                                    "prompt": "S? <|AUDIO|>",
                                    "response": "tone"}) + "\n")
    cfg = yaml.safe_load(open("configs/desta25_debug.yaml"))
    cfg["exp_dir"] = str(tmp_path / "exp")
    cfg["dataset"]["manifest_filepaths"] = [str(manifest)]
    cfg["dataset"]["data_root"] = str(root)
    cfg["init_from_pretrained_weights"] = str(tmp_path / "warm")
    model, _ = build_from_config(cfg, device="cpu")
    assert count_differing(model.params["connector"],
                      donor.params["connector"]) == 0
    fresh, _ = build_from_config({**cfg, "init_from_pretrained_weights": None},
                                 device="cpu")
    assert count_differing(fresh.params["connector"],
                      donor.params["connector"]) > 0
    cfg["resume_from_checkpoint"] = "somewhere"
    with pytest.raises(ValueError, match="Cannot provide both"):
        build_from_config(cfg, device="cpu")


def test_cli_generate_smoke(tmp_path, capsys):
    """cli.generate end to end: a nano checkpoint, the CLI on a synthetic
    WAV with a known transcription, its JSON output; the ids are those of
    ``from_pretrained`` + ``generate()`` on the same checkpoint."""
    from desta25_audio_tpu_torch.cli.generate import main
    ck = str(tmp_path / "ck")
    DeSTA25AudioModel(DeSTA25Config(**NANO), "cpu", seed=0).save_pretrained(ck)
    wav = _tone(str(tmp_path / "c.wav"))
    main(["--model", ck, "--audio", wav, "--transcription", "a tone",
          "--prompt", "Describe:", "--max-new-tokens", "3", "--json",
          "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(out["text"][0], str)
    assert out["audios"][0][1] == "a tone"
    want = DeSTA25AudioModel.from_pretrained(ck, "cpu").generate(
        [{"role": "user", "content": "Describe: <|AUDIO|>",
          "audios": [{"audio": wav, "text": "a tone"}]}],
        max_new_tokens=3, do_sample=False)
    assert out["generated_ids"] == want.generated_ids


def test_cli_serve_smoke(tmp_path):
    """cli.serve end to end: a nano checkpoint, the HTTP server on an
    ephemeral port (serve_http patched to return), a text-only
    /v1/generate and a /v1/chat/completions request, then shut down."""
    from desta25_audio_tpu_torch.cli import serve as cli_serve
    from desta25_audio_tpu_torch.serve import http as http_mod
    ck = str(tmp_path / "ck")
    DeSTA25AudioModel(DeSTA25Config(**NANO), "cpu", seed=0).save_pretrained(ck)
    captured = {}

    def fake_serve(engine, host, port):
        captured["httpd"], captured["es"] = http_mod.start_http(engine, host,
                                                                0)
        captured["engine"] = engine

    with mock.patch.object(http_mod, "serve_http", side_effect=fake_serve):
        cli_serve.main(["--model", ck, "--slots", "2", "--max-ctx", "128",
                        "--max-new-tokens", "4", "--device", "cpu"])
    assert captured["engine"].n_slots == 2
    port = captured["httpd"].server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        for path, body in (
                ("/v1/generate", {"messages": [{"role": "user",
                                                "content": "hi"}],
                                  "max_new_tokens": 3}),
                ("/v1/chat/completions", {"messages": [
                    {"role": "user", "content": "hello"}],
                    "max_tokens": 3})):
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            assert resp.status == 200, out
            text = (out["text"] if path == "/v1/generate"
                    else out["choices"][0]["message"]["content"])
            assert isinstance(text, str)
        conn.close()
    finally:
        captured["httpd"].shutdown()
        captured["es"].close()


def test_cli_evaluate_smoke(tmp_path, capsys):
    """cli.evaluate over a nano checkpoint: a local JSONL of two MMAU items
    (audio paths under --data-root), --limit, --override, --out; a URL
    manifest is refused."""
    from desta25_audio_tpu_torch.cli.evaluate import load_items, main
    ck = str(tmp_path / "ck")
    DeSTA25AudioModel(DeSTA25Config(**NANO), "cpu", seed=0).save_pretrained(ck)
    root = tmp_path / "clips"
    os.makedirs(root)
    items = []
    for i in range(3):
        _tone(str(root / f"{i}.wav"), 0.5, 300.0 + 50 * i)
        items.append({"question": "Which?", "choices": ["a dog", "a cat"],
                      "answer": "a dog", "audio": f"{i}.wav",
                      "task": "sound"})
    data = tmp_path / "items.jsonl"
    data.write_text("".join(json.dumps(it) + "\n" for it in items))
    assert load_items(str(data), str(root))[0]["audio"] == str(root / "0.wav")
    with pytest.raises(NotImplementedError, match="remote"):
        load_items("https://example.invalid/items.jsonl")
    out = str(tmp_path / "report.json")
    main(["--benchmark", "mmau", "--model", ck, "--data", str(data),
          "--data-root", str(root), "--limit", "2", "--max-new-tokens", "3",
          "--override", "encoder_quant=none", "--out", out,
          "--device", "cpu"])
    report = json.load(open(out))["report"]
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == report
    assert report["n_items"] == 2
    assert set(report["task"]) == {"sound"}
    with pytest.raises(SystemExit, match="judge"):
        main(["--benchmark", "sakura", "--model", ck, "--data", str(data),
              "--data-root", str(root), "--device", "cpu"])
