"""``from_pretrained`` / ``save_pretrained`` and HF staging in the port,
against the JAX package on the CPU.

Mirrors, by name, the JAX package's ``test_match_preset_whisper``,
``test_match_preset_llm`` and ``test_stage_and_from_pretrained_nano``
(tests/test_hf_convert_cli.py), ``test_save_load_roundtrip``
(tests/test_generate_e2e.py), ``test_orca_checkpoint_roundtrip``
(tests/test_orca.py), ``test_all_layers_ckpt_loads_into_selected_config``
(tests/test_layer_alignment.py), ``test_from_pretrained_config_overrides``
(tests/test_quant.py) and ``test_from_pretrained_orca_xattn_quant``
(tests/test_fused_inject.py); then the whole slice: one nano checkpoint
directory and one weights root staged by both packages from one HF-layout
snapshot, loaded by both packages' ``from_pretrained``, give equal trees
through ``ckpt/bridge.py`` and identical greedy ``generate()`` ids, for the
Q-Former with a bf16 and an int8 LLM and for ORCA with the int8 stack.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.ckpt import hf_convert as thf
from desta25_audio_tpu_torch.ckpt.synthetic import (
    count_differing,
    fill_state,
    hf_llm_shapes,
    hf_whisper_shapes,
    write_snapshot,
)
from desta25_audio_tpu_torch.config import llm_config_for, whisper_config_for
from desta25_audio_tpu_torch.ops.quant import is_quantized

NANO = dict(llm_model_id="test/llama-nano", encoder_model_id="test/whisper-nano",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")
ORCA = dict(NANO, connector_mode="orca_hybrid", orca_global_num_tokens=4,
            orca_local_downsample=4, orca_local_kernel_size=5,
            orca_audio_position_scale=2.5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapshot(root, kind, cfg, seed, dtype, shards=1):
    rng = np.random.default_rng(seed)

    def make(shape, k):
        x = rng.standard_normal(shape).astype(np.float32) * 0.05
        return torch.from_numpy(x + (k == "n")).to(dtype)
    shapes = (hf_whisper_shapes if kind == "whisper" else hf_llm_shapes)(cfg)
    path = os.path.join(root, cfg.model_id)
    write_snapshot(path, kind, cfg, fill_state(shapes, make), shards)
    return path


def _same(a, b) -> None:
    assert count_differing(a, b) == 0


# -- presets ----------------------------------------------------------------------

def test_match_preset_whisper():
    cfg = whisper_config_for("openai/whisper-large-v3")
    hf = dict(model_type="whisper", num_mel_bins=cfg.num_mel_bins,
              d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
              encoder_attention_heads=cfg.encoder_attention_heads,
              encoder_ffn_dim=cfg.encoder_ffn_dim,
              decoder_layers=cfg.decoder_layers, vocab_size=cfg.vocab_size,
              max_source_positions=cfg.max_source_positions)
    kind, mid, _ = thf.match_preset(hf)
    assert (kind, mid) == ("whisper", "openai/whisper-large-v3")
    hf["d_model"] = 999
    with pytest.raises(SystemExit):
        thf.match_preset(hf)


def test_match_preset_llm():
    """Qwen3-0.6B by its dims; every preset picks what the JAX package
    picks (the two Llama-3.1-8B ids share their dims: one match, the
    first, as JAX dedups them)."""
    from desta25_audio_tpu_torch.ckpt.synthetic import hf_config_json
    from desta25_audio_tpu.ckpt.hf_convert import match_preset as jmatch
    from desta25_audio_tpu_torch.config import _LLM_PRESETS
    cfg = llm_config_for("Qwen/Qwen3-0.6B")
    kind, mid, _ = thf.match_preset(hf_config_json("llm", cfg))
    assert (kind, mid) == ("llm", "Qwen/Qwen3-0.6B")
    for m in _LLM_PRESETS:
        if m.startswith("test/"):
            continue
        hf = hf_config_json("llm", llm_config_for(m))
        try:
            want = jmatch(hf)[:2]
        except SystemExit:
            with pytest.raises(SystemExit):
                thf.match_preset(hf)
            continue
        assert thf.match_preset(hf)[:2] == want
    llama = thf.match_preset(hf_config_json(
        "llm", llm_config_for("DeSTA-ntu/Llama-3.1-8B-Instruct")))
    assert llama[1] == "meta-llama/Llama-3.1-8B-Instruct"


# -- staging -------------------------------------------------------------------

def test_stage_and_from_pretrained_nano(tmp_path):
    """Stage a nano LLM with the port's CLI (bf16 + int8), load it through
    from_pretrained with llm_quant=int8 and without; the JAX package's
    staged files of the same snapshot load into the port to the same
    trees; a missing tower keeps its random draw."""
    from desta25_audio_tpu.ckpt.hf_convert import stage_checkpoint as jstage
    cfg = llm_config_for("test/llama-nano")
    src = _snapshot(str(tmp_path / "snap"), "llm", cfg, 0, torch.bfloat16)
    root = str(tmp_path / "weights")
    thf._cli([src, root, "--model-id", "test/llama-nano", "--int8"])
    d = os.path.join(root, "test/llama-nano")
    assert sorted(f for f in os.listdir(d) if f.endswith(".safetensors")) == [
        thf.STAGED, thf.STAGED_INT8]
    jroot = str(tmp_path / "jax_weights")
    jstage(src, jroot, model_id="test/llama-nano", int8=True)

    mdir = str(tmp_path / "model")
    models = {}
    for quant in ("int8", "none"):
        mcfg = DeSTA25Config(**{**NANO, "llm_quant": quant})
        DeSTA25AudioModel(mcfg, "cpu", seed=0).save_pretrained(mdir)
        for r in (root, jroot):
            models[quant, r] = DeSTA25AudioModel.from_pretrained(
                mdir, "cpu", weights_root=r)
    m = models["int8", root]
    assert is_quantized(m.params["llm"]["layers"]["wqkv"])
    assert m.params["llm"]["lm_head"]["q"].shape[0] % 2560 == 0
    out = m.generate([{"role": "user", "content": "ab"}], max_new_tokens=4,
                     do_sample=False)
    assert isinstance(out.text[0], str)
    bf = models["none", root]
    assert bf.params["llm"]["layers"]["wqkv"].dtype == torch.float32
    for quant in ("int8", "none"):
        _same(models[quant, jroot].params["llm"], models[quant, root].params["llm"])
    want = thf.convert_llm_state(thf.load_safetensors_state(src), cfg,
                                 torch.float32)
    _same(bf.params["llm"], want)
    # the whisper tower has no weights under this root: a random draw
    fresh = DeSTA25AudioModel(DeSTA25Config(**NANO), "cpu", seed=0)
    _same(bf.params["whisper"]["decoder"], fresh.params["whisper"]["decoder"])


def test_stage_int8_writes_the_clis_int8_file(tmp_path):
    """``stage_int8`` writes only the int8 file (and ``config.json``),
    byte for byte the one ``stage_checkpoint(..., int8=True)`` writes; a
    Whisper snapshot is refused, as the CLI's ``--int8`` refuses it."""
    src = _snapshot(str(tmp_path / "snap"), "llm",
                    llm_config_for("test/llama-nano"), 0, torch.bfloat16)
    both, only = str(tmp_path / "both"), str(tmp_path / "only")
    thf.stage_checkpoint(src, both, model_id="test/llama-nano", int8=True)
    assert thf.stage_int8(src, only, "test/llama-nano") == "test/llama-nano"
    d = os.path.join(only, "test/llama-nano")
    assert sorted(os.listdir(d)) == ["config.json", thf.STAGED_INT8]
    with open(os.path.join(d, thf.STAGED_INT8), "rb") as f, open(
            os.path.join(both, "test/llama-nano", thf.STAGED_INT8), "rb") as g:
        assert f.read() == g.read()
    wsrc = _snapshot(str(tmp_path / "snap"), "whisper",
                     whisper_config_for("test/whisper-nano"), 0, torch.float16)
    with pytest.raises(SystemExit, match="--int8"):
        thf.stage_int8(wsrc, only, "test/whisper-nano")


# -- round trips ---------------------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    model = DeSTA25AudioModel(DeSTA25Config(**NANO), "cpu", seed=2)
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d)
    assert os.path.exists(os.path.join(d, "config.json"))
    assert os.path.exists(os.path.join(d, "model.safetensors"))
    loaded = DeSTA25AudioModel.from_pretrained(d, "cpu")
    _same(loaded.params["connector"], model.params["connector"])
    assert loaded.config == dataclasses.replace(model.config)


def test_orca_checkpoint_roundtrip(tmp_path):
    model = DeSTA25AudioModel(DeSTA25Config(**ORCA), "cpu", seed=0)
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d)
    loaded = DeSTA25AudioModel.from_pretrained(d, "cpu", seed=9)
    for key in ("connector", "orca_cross_attns"):
        _same(loaded.params[key], model.params[key])


def test_all_layers_ckpt_loads_into_selected_config(tmp_path):
    """A checkpoint that tapped every encoder layer, under a config.json
    that claims the selected taps: the connector is rebuilt with
    ``orca_use_all_layers`` and loads."""
    cfg = DeSTA25Config(**{**ORCA, "encoder_model_id": "test/whisper-nano6",
                           "orca_use_all_layers": True})
    src = DeSTA25AudioModel(cfg, "cpu", seed=0)
    assert src.params["connector"]["global_queries"].shape[0] == \
        src.enc_cfg.encoder_layers
    d = str(tmp_path / "ckpt")
    src.save_pretrained(d)
    cfg_path = os.path.join(d, "config.json")
    cfg_d = json.load(open(cfg_path))
    cfg_d["orca_use_all_layers"] = False
    json.dump(cfg_d, open(cfg_path, "w"))
    loaded = DeSTA25AudioModel.from_pretrained(d, "cpu")
    assert loaded.config.orca_use_all_layers is True
    _same(loaded.params["connector"], src.params["connector"])


def test_from_pretrained_config_overrides(tmp_path):
    """``encoder_quant="auto"`` gives the int8 encoder on load, as JAX's;
    ``config_overrides`` (and the evaluate CLI's --override) opt back onto
    the bf16 encoder without editing config.json."""
    from desta25_audio_tpu_torch.cli.evaluate import parse_overrides
    assert parse_overrides(["encoder_quant=none", "audio_locator=<x>"]) == {
        "encoder_quant": "none", "audio_locator": "<x>"}
    with pytest.raises(SystemExit):
        parse_overrides(["encoder_quant"])
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano")
    d = str(tmp_path / "ck")
    DeSTA25AudioModel(cfg, "cpu", seed=0).save_pretrained(d)
    auto = DeSTA25AudioModel.from_pretrained(d, "cpu")
    assert "q" in auto.params["whisper"]["encoder"]["layers"]["fc1"]
    loaded = DeSTA25AudioModel.from_pretrained(
        d, "cpu", config_overrides=parse_overrides(["encoder_quant=none"]))
    assert loaded.config.encoder_quant == "none"
    assert "w" in loaded.params["whisper"]["encoder"]["layers"]["fc1"]
    # a LoRA config whose checkpoint holds no adapters keeps the fresh
    # draw: A random, B zero, so the model computes the base model
    lora = dataclasses.replace(cfg, use_lora=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(lora.to_json())
    m = DeSTA25AudioModel.from_pretrained(d, "cpu")
    assert m.config.use_lora
    for ab in m.params["lora"]["layers"].values():
        assert float(ab["a"].abs().max()) > 0
        assert float(ab["b"].abs().max()) == 0


def test_from_pretrained_orca_xattn_quant(tmp_path):
    from desta25_audio_tpu_torch.ops.fused_decode import fused_inject_limits
    cfg = DeSTA25Config(**{**ORCA, "llm_model_id": "test/llama-nano128",
                           "dtype": "bfloat16", "orca_xattn_quant": "int8"})
    m = DeSTA25AudioModel(cfg, "cpu", seed=1)
    assert not is_quantized(m.params["orca_cross_attns"]["layers"]["q"])
    ck = str(tmp_path / "ck")
    m.save_pretrained(ck)
    m2 = DeSTA25AudioModel.from_pretrained(ck, "cpu")
    assert is_quantized(m2.params["orca_cross_attns"]["layers"]["q"])
    assert fused_inject_limits(m2.params["orca_cross_attns"], m2.llm_cfg,
                               m2.llm_cfg.num_attention_heads, 16) == []
    out = m2.generate([{"role": "user", "content": "Hi."}],
                      max_new_tokens=3, do_sample=False).text[0]
    assert isinstance(out, str)


# -- the whole slice against JAX ------------------------------------------------

SLICE = dict(NANO, llm_model_id="test/llama-nano128", dtype="bfloat16")
CASES = {"qformer_bf16": SLICE,
         "qformer_int8": dict(SLICE, llm_quant="int8"),
         "orca_int8": dict(SLICE, **{k: v for k, v in ORCA.items()
                                     if k.startswith("orca")},
                           connector_mode="orca_hybrid", llm_quant="int8",
                           orca_xattn_quant="int8")}


@pytest.fixture(scope="module")
def weights_root(tmp_path_factory):
    """One HF-layout snapshot (whisper-nano in f16, llama-nano128 in bf16,
    two shards), staged by both packages into one root (the port's
    ``desta_torch*`` beside JAX's ``desta_tpu*``, each with --int8 for the
    LLM)."""
    from desta25_audio_tpu.ckpt.hf_convert import stage_checkpoint as jstage
    tmp = tmp_path_factory.mktemp("slice")
    root = str(tmp / "weights")
    snaps = {"whisper": _snapshot(str(tmp / "snap"), "whisper",
                                  whisper_config_for("test/whisper-nano"), 1,
                                  torch.float16),
             "llm": _snapshot(str(tmp / "snap"), "llm",
                              llm_config_for("test/llama-nano128"), 2,
                              torch.bfloat16, shards=2)}
    for kind, src in snaps.items():
        mid = os.path.relpath(src, str(tmp / "snap"))
        thf.stage_checkpoint(src, root, model_id=mid, int8=kind == "llm")
        jstage(src, root, model_id=mid, int8=kind == "llm")
    wav = str(tmp / "tone.wav")
    t = np.arange(16000) / 16000.0
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 440 * t)
                    * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32))
    return root, wav


def _jax_loads(JaxModel, ck, root):
    """JAX's ``from_pretrained`` as it stands ("auto": the int8 encoder)
    and on the bf16 encoder, in that order of the list [(overrides, model)],
    each with an int8 ORCA stack as JAX's eager quantizer gives it.  JAX's
    load quantizes the stack under ``jax.jit``, where XLA turns the scale's
    ``max / 127`` into ``max * fl(1/127)``: a last-bit difference from its
    own eager quantizer (the semantics its source states and the port
    keeps: ``ops/quant.quantize_weight``) in a few per cent of rows, which
    ``_check_reciprocal_rows`` pins on the first load."""
    from desta25_audio_tpu.ops import quant as jq
    quant = json.load(open(os.path.join(ck, "config.json")))[
        "orca_xattn_quant"] == "int8"
    bf16 = {"encoder_quant": "none"}
    jm = JaxModel.from_pretrained(ck, weights_root=root, config_overrides={
        **bf16, **({"orca_xattn_quant": "none"} if quant else {})})
    auto = JaxModel.from_pretrained(ck, weights_root=root)
    if quant:
        floats = jm.params["orca_cross_attns"]
        eager = jq.quantize_orca_cross_attns(floats)
        _check_reciprocal_rows(floats, eager, auto.params["orca_cross_attns"])
        jm.params["orca_cross_attns"] = auto.params["orca_cross_attns"] = eager
        jm.config = dataclasses.replace(jm.config, orca_xattn_quant="int8")
    return [(None, auto), (bf16, jm)]


def _check_reciprocal_rows(floats, eager, loaded) -> None:
    """JAX's loaded int8 ORCA stack against its eager quantizer (the port's
    semantics) on the same float stack: the eager scales are ``max / 127``
    and the loaded ones ``max * fl(1/127)`` (numpy f32), so the two differ
    in exactly the output columns where those two round apart, and their
    q nowhere else; there is at least one such column."""
    inv, parted = np.float32(1) / np.float32(127), 0
    for k in ("q", "k", "v", "o", "gate1"):
        w = np.asarray(floats["layers"][k]["w"]).astype(np.float32)
        amax = np.abs(w).max(1)                          # [L, out]
        div = np.maximum(amax / np.float32(127), np.float32(1e-8))
        rec = np.maximum(amax * inv, np.float32(1e-8))
        se = np.asarray(eager["layers"][k]["s"])
        sl = np.asarray(loaded["layers"][k]["s"])
        assert np.array_equal(se, div) and np.array_equal(sl, rec), k
        apart = div != rec
        assert np.array_equal(se != sl, apart), k
        qd = (np.asarray(eager["layers"][k]["q"])
              != np.asarray(loaded["layers"][k]["q"])).any(1)
        assert not (qd & ~apart).any(), k
        parted += int(apart.sum())
    assert parted > 0


@pytest.mark.parametrize("case", list(CASES))
def test_whole_slice_from_pretrained_matches_jax(case, weights_root,
                                                 tmp_path, monkeypatch):
    """Both packages' ``from_pretrained`` on one checkpoint and weights
    root give equal trees through the bridge (JAX's ORCA stack as its eager
    quantizer gives it: its load's own stack differs from that in exactly
    the columns ``_check_reciprocal_rows`` pins) and identical greedy ids
    on the bf16 encoder."""
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    from desta25_audio_tpu import DeSTA25Config as JaxConfig
    from test_torch_int8_llm import jax_tpu_dispatch
    root, wav = weights_root
    kw = CASES[case]
    ck = str(tmp_path / "ck")
    JaxModel(JaxConfig(**kw), seed=4).save_pretrained(ck)
    if kw.get("llm_quant") == "int8":
        jax_tpu_dispatch(monkeypatch)
    try:
        for over, jm in _jax_loads(JaxModel, ck, root):
            tm = DeSTA25AudioModel.from_pretrained(
                ck, "cpu", weights_root=root, config_overrides=over)
            assert tm.config == DeSTA25Config(**dataclasses.asdict(
                jm.config))
            want = bridge.from_jax_params(jax.tree.map(np.asarray, jm.params),
                                          tm.config, "cpu")
            _same(tm.params, want)
            assert is_quantized(tm.params["whisper"]["encoder"]["layers"][
                "fc1"]) == (over is None)
        # the ids on the bf16 encoder: the int8 encoder's plain version
        # matches JAX's kernels within 2e-2 of the output scale, not to the
        # bit (tests/test_torch_w8a8.py), so a near-tie may part there
        msgs = [[{"role": "user", "content": "What is it? <|AUDIO|>",
                  "audios": [{"audio": wav, "text": "a tone"}]}],
                [{"role": "user", "content": "Name <|AUDIO|> in one word.",
                  "audios": [{"audio": wav, "text": "the same tone"}]}]]
        got = tm.generate(msgs, max_new_tokens=5, do_sample=False)
        ref = jm.generate(msgs, max_new_tokens=5, do_sample=False)
        assert got.generated_ids == ref.generated_ids
    finally:
        jax.clear_caches()


def test_train_checkpoint_loads_with_from_pretrained(tmp_path):
    """``save_train_state`` with a config also writes ``config.json`` and
    the reference-format ``model.safetensors``: the checkpoint directory
    loads with the port's and the JAX package's ``from_pretrained``."""
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    from desta25_audio_tpu_torch.ckpt.checkpoint import save_train_state
    model = DeSTA25AudioModel(DeSTA25Config(**ORCA), "cpu", seed=7)
    trainable, _ = model.split_params()
    path = save_train_state(str(tmp_path), 3, trainable, {}, model.config)
    for name in ("state.pt", "config.json", "model.safetensors"):
        assert os.path.exists(os.path.join(path, name)), name
    loaded = DeSTA25AudioModel.from_pretrained(path, "cpu", seed=1)
    _same({k: loaded.params[k] for k in trainable}, trainable)
    jm = JaxModel.from_pretrained(path)
    want = bridge.orca_cross_attns_from_jax(
        jax.tree.map(np.asarray, jm.params["orca_cross_attns"]), "cpu")
    _same(want, trainable["orca_cross_attns"])

