"""The port's checkpoint formats against the JAX package's, on the CPU.

- ``ops/quant.quantize_weight`` divides (rows whose max / 127 differs from
  max * fl(1/127) get numpy's f32 quotient);
- the safetensors codec (``ckpt/flat_io.py``): files the ``safetensors``
  package writes read back equal, files the port writes load with it, a
  sharded directory streams, flat trees round-trip both ways with the JAX
  package's;
- the HF converters (``ckpt/hf_convert.py``) for Llama, Qwen3, Whisper and
  the BERT Q-Former equal the JAX package's converters carried through
  ``ckpt/bridge.py``, element for element and dtype for dtype, from random
  HF-layout state dicts (f32, f16 and bf16) and from tiny HF modules;
- the reference's trainable-only ``model.safetensors``
  (``ckpt/desta_io.py``, ``ckpt/orca_io.py``): the export matches the
  published-format manifests at flagship dims (meta tensors, nothing
  allocated), and files round-trip between the two packages for the
  Q-Former and ORCA, legacy ``ocar_`` keys included.
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.ckpt import flat_io as tio
from desta25_audio_tpu_torch.ckpt import hf_convert as thf
from desta25_audio_tpu_torch.ckpt.synthetic import (
    fill_state,
    hf_llm_shapes,
    hf_whisper_shapes,
    reciprocal_rows,
)
from desta25_audio_tpu_torch.config import (
    DeSTA25Config,
    llm_config_for,
    whisper_config_for,
)
from desta25_audio_tpu_torch.ops.quant import quantize_weight

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def _np_maker(seed, dtype):
    rng = np.random.default_rng(seed)

    def make(shape, kind):
        x = rng.standard_normal(shape).astype(np.float32) * 0.02
        if kind == "n":
            x += 1.0
        return torch.from_numpy(x).to(dtype)
    return make


def _jax_view(state):
    """The same state dict as the JAX converters take it: f32 and f16 as
    numpy, bf16 as torch tensors (its ``_np`` reads them)."""
    return {k: (v if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in state.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- §0: the weight scale is a division -------------------------------------------

def test_quantize_weight_scales_divide():
    w, amax = reciprocal_rows(256, 96)
    inv = np.float32(1) / np.float32(127)
    want_s = np.maximum(amax / np.float32(127), np.float32(1e-8))
    assert (want_s != np.maximum(amax * inv, np.float32(1e-8))).all()
    leaf = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(leaf["s"].numpy(), want_s)
    want_q = np.clip(np.rint(w / want_s[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(leaf["q"].numpy(), want_q)
    from desta25_audio_tpu.ops.quant import quantize_weight as jq
    j = jq(w.T)
    np.testing.assert_array_equal(np.asarray(j["s"]), want_s)
    np.testing.assert_array_equal(np.asarray(j["q"]).T, want_q)


# -- the codec ---------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(1)
    bf = rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16)
    return {"f16": rng.standard_normal((2, 5)).astype(np.float16),
            "f32": rng.standard_normal(7).astype(np.float32),
            "i8": np.arange(-5, 6, dtype=np.int8),
            "i32": np.arange(9, dtype=np.int32).reshape(3, 3),
            "i64": np.array([2 ** 40, -3], np.int64),
            "bf": bf.view(np.uint16),
            "scalar": np.array(2.5, np.float32)}, bf


def test_codec_reads_safetensors_files(tmp_path):
    from safetensors.numpy import save_file
    arrs, bf = _arrays()
    p = str(tmp_path / "a.safetensors")
    save_file(arrs, p, metadata={"desta_dtypes": json.dumps({"bf": "bfloat16"}),
                                 "note": "x"})
    assert tio.SafetensorsFile(p).metadata["note"] == "x"
    tree = tio.load_tree_safetensors(p)
    for k, a in arrs.items():
        if k == "bf":
            assert tree[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tree[k].float().numpy(), bf.astype(np.float32))
        else:
            np.testing.assert_array_equal(tree[k].numpy(), a)
            assert tree[k].numpy().dtype == a.dtype
    raw = tio.load_safetensors(p)           # without the tree's metadata
    assert raw["bf"].dtype == torch.uint16


def test_codec_files_load_with_safetensors(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file
    arrs, bf = _arrays()
    tree = {k: torch.from_numpy(v) for k, v in arrs.items() if k != "bf"}
    tree["sub"] = {"bf": torch.from_numpy(bf.astype(np.float32)).bfloat16(),
                   "b": torch.tensor([True, False, True])}
    p = str(tmp_path / "t.safetensors")
    tio.save_tree_safetensors(tree, p)
    back = load_file(p)
    for k, v in tio.flatten_tree(tree).items():
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(back[k], bf.view(np.uint16))
        else:
            np.testing.assert_array_equal(back[k], v.numpy())
    with safe_open(p, framework="np") as f:
        assert json.loads(f.metadata()["desta_dtypes"]) == {"sub/bf":
                                                            "bfloat16"}
    # a native BF16 / F16 file, as HF snapshots hold them
    w = {"w": torch.randn(5, 3).bfloat16(), "h": torch.randn(4).half(),
         "e": torch.zeros(0, 3)}
    q = str(tmp_path / "n.safetensors")
    tio.save_safetensors(w, q, metadata={"format": "pt"})
    with safe_open(q, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        for k in w:
            assert torch.equal(f.get_tensor(k), w[k])
    for k, v in tio.load_safetensors(q).items():
        assert v.dtype == w[k].dtype and torch.equal(v, w[k])


def test_sharded_directory_loads(tmp_path):
    d = tmp_path / "snap"
    os.makedirs(d)
    a = {f"l.{i}": torch.full((3, i + 1), float(i)) for i in range(4)}
    tio.save_safetensors(dict(list(a.items())[:2]),
                         str(d / "model-00001-of-00002.safetensors"))
    tio.save_safetensors(dict(list(a.items())[2:]),
                         str(d / "model-00002-of-00002.safetensors"))
    tio.save_safetensors({"junk": torch.zeros(2)},
                         str(d / thf.STAGED))   # a staged file is no shard
    sd = tio.load_safetensors_state(str(d), exclude=thf.STAGED_NAMES)
    assert sorted(sd) == sorted(a) and len(sd) == 4
    assert sd.nbytes() == sum(t.numel() * 4 for t in a.values())
    for k, v in a.items():
        assert torch.equal(sd[k], v)
    sd.close()
    one = tio.load_safetensors_state(str(d / "model-00002-of-00002"
                                         ".safetensors"))
    assert sorted(one) == ["l.2", "l.3"]


def test_flat_roundtrip(tmp_path):
    """The JAX package's ``test_flat_roundtrip`` on the port's codec, and
    its files in both directions."""
    from desta25_audio_tpu.ckpt import flat_io as jio
    tree = {
        "layers": {"wq": {"q": torch.arange(12, dtype=torch.int8)
                          .reshape(3, 4), "s": torch.ones(4)}},
        "embed": torch.ones(5, 3).bfloat16(),
        "norm": {"scale": torch.full((3,), 2.0)},
    }
    flat = tio.flatten_tree(tree)
    assert set(flat) == {"layers/wq/q", "layers/wq/s", "embed", "norm/scale"}
    assert tio.unflatten_tree(flat)["layers"]["wq"]["q"].shape == (3, 4)
    p = str(tmp_path / "t.safetensors")
    tio.save_tree_safetensors(tree, p)
    assert_trees_equal(tio.load_tree_safetensors(p), tree)
    j = jio.load_tree_safetensors(p)                # the port's file in JAX
    assert j["embed"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(j["layers"]["wq"]["q"],
                                  tree["layers"]["wq"]["q"].numpy())
    q = str(tmp_path / "j.safetensors")
    jio.save_tree_safetensors(j, q)                 # and back
    assert_trees_equal(tio.load_tree_safetensors(q), tree)


# -- the HF converters against JAX's + the bridge -------------------------------

def _whisper_from_jax(t):
    return {"encoder": bridge.whisper_encoder_from_jax(t["encoder"], "cpu"),
            "decoder": bridge.whisper_decoder_from_jax(t["decoder"], "cpu")}


@pytest.mark.parametrize("src,dst", [(torch.float16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float16, torch.float32)])
def test_convert_whisper_matches_jax(src, dst):
    import jax.numpy as jnp
    from desta25_audio_tpu.ckpt.hf_convert import convert_whisper_state
    cfg = whisper_config_for("test/whisper-nano")
    sd = fill_state(hf_whisper_shapes(cfg), _np_maker(0, src))
    got = thf.convert_whisper_state(sd, cfg, dst)
    jdt = jnp.bfloat16 if dst == torch.bfloat16 else jnp.float32
    want = _whisper_from_jax(_np_tree(convert_whisper_state(
        _jax_view(sd), cfg, dtype=jdt)))
    assert_trees_equal(got, want)
    assert "b" not in got["encoder"]["layers"]["attn"]["k"]


@pytest.mark.parametrize("model_id", ["test/llama-nano", "test/qwen3-nano"])
@pytest.mark.parametrize("src", [torch.bfloat16, torch.float32])
def test_convert_llm_matches_jax(model_id, src):
    from desta25_audio_tpu.ckpt.hf_convert import convert_llm_state
    cfg = llm_config_for(model_id)
    sd = fill_state(hf_llm_shapes(cfg), _np_maker(1, src))
    got = thf.convert_llm_state(sd, cfg)
    want = bridge.llm_from_jax(_np_tree(convert_llm_state(_jax_view(sd), cfg)),
                               "cpu")
    assert_trees_equal(got, want)
    assert ("lm_head" in got) != cfg.tie_word_embeddings
    assert ("q_norm" in got["layers"]) == cfg.qk_norm
    if not cfg.tie_word_embeddings:     # an untied snapshot without a head
        del sd["lm_head.weight"]
        assert torch.equal(thf.convert_llm_state(sd, cfg)["lm_head"],
                           got["embed"])


def _bert_state(n_layers, d, inter, seed):
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def lin(p, o, i):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(o, i), t(o)

    def ln(p):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(d), t(d)

    for i in range(n_layers):
        p = f"layer.{i}"
        for blk in ("attention", "crossattention"):
            for n in ("self.query", "self.key", "self.value", "output.dense"):
                lin(f"{p}.{blk}.{n}", d, d)
            ln(f"{p}.{blk}.output.LayerNorm")
        lin(f"{p}.intermediate.dense", inter, d)
        lin(f"{p}.output.dense", d, inter)
        ln(f"{p}.output.LayerNorm")
    return sd


def test_convert_bert_matches_jax():
    from desta25_audio_tpu.ckpt.hf_convert import convert_bert_encoder_state
    sd = _bert_state(2, 64, 96, 2)
    got = thf.convert_bert_encoder_state(sd, 2)
    want = bridge._bert_encoder(_np_tree(convert_bert_encoder_state(
        _jax_view(sd), 2)), "cpu")
    assert_trees_equal(got, want)
    pre = {f"qformer.{k}": v for k, v in sd.items()}
    assert_trees_equal(thf.convert_bert_encoder_state(pre, 2, "qformer."),
                       got)


def test_convert_tiny_hf_modules_matches_jax():
    """``state_dict()`` of tiny HF modules (Whisper, Llama, Qwen3 and the
    BERT encoder with cross-attention), through ``convert_from_torch_module``
    of both packages."""
    transformers = pytest.importorskip("transformers")
    from desta25_audio_tpu.ckpt import hf_convert as jhf
    torch.manual_seed(0)
    wcfg = whisper_config_for("test/whisper-nano")
    whisper = transformers.WhisperForConditionalGeneration(
        transformers.WhisperConfig(
            vocab_size=wcfg.vocab_size, num_mel_bins=wcfg.num_mel_bins,
            d_model=wcfg.d_model, encoder_layers=wcfg.encoder_layers,
            encoder_attention_heads=wcfg.encoder_attention_heads,
            encoder_ffn_dim=wcfg.encoder_ffn_dim,
            decoder_layers=wcfg.decoder_layers,
            decoder_attention_heads=wcfg.decoder_attention_heads,
            decoder_ffn_dim=wcfg.decoder_ffn_dim,
            max_source_positions=wcfg.max_source_positions,
            max_target_positions=wcfg.max_target_positions,
            pad_token_id=0, bos_token_id=0, eos_token_id=251,
            decoder_start_token_id=250)).eval()
    assert_trees_equal(
        thf.convert_from_torch_module(whisper, thf.convert_whisper_state,
                                      wcfg),
        _whisper_from_jax(_np_tree(jhf.convert_from_torch_module(
            whisper, jhf.convert_whisper_state, wcfg))))
    for mid, cls, hcls in (
            ("test/llama-nano", "LlamaForCausalLM", "LlamaConfig"),
            ("test/qwen3-nano", "Qwen3ForCausalLM", "Qwen3Config")):
        c = llm_config_for(mid)
        hf = getattr(transformers, cls)(getattr(transformers, hcls)(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            intermediate_size=c.intermediate_size,
            num_hidden_layers=c.num_hidden_layers,
            num_attention_heads=c.num_attention_heads,
            num_key_value_heads=c.num_key_value_heads, head_dim=c.head_dim,
            tie_word_embeddings=c.tie_word_embeddings)).eval()
        assert_trees_equal(
            thf.convert_from_torch_module(hf, thf.convert_llm_state, c,
                                          torch.bfloat16),
            bridge.llm_from_jax(_np_tree(jhf.convert_from_torch_module(
                hf, jhf.convert_llm_state, c, dtype=jax.numpy.bfloat16)),
                "cpu"))
    from transformers.models.bert.modeling_bert import BertEncoder
    bcfg = transformers.BertConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=96, is_decoder=True, add_cross_attention=True)
    bcfg._attn_implementation = "eager"
    bert = BertEncoder(bcfg).eval()
    sd = bert.state_dict()
    assert_trees_equal(
        thf.convert_bert_encoder_state(sd, 2),
        bridge._bert_encoder(_np_tree(jhf.convert_bert_encoder_state(
            {k: v for k, v in sd.items()}, 2)), "cpu"))


# -- the reference format ------------------------------------------------------------

FLAGSHIP = dict(llm_model_id="DeSTA-ntu/Llama-3.1-8B-Instruct",
                encoder_model_id="openai/whisper-large-v3",
                qformer_num_hidden_layers=6, prompt_size=64,
                dtype="float32")


@pytest.mark.parametrize("mode,manifest", [
    ("qformer_1", "ckpt_manifest_qformer6l_llama8b.json"),
    ("orca_hybrid", "ckpt_manifest_orca6l_llama8b.json")])
def test_export_matches_published_format(mode, manifest):
    """Keys and shapes of the export at flagship dims, from meta tensors
    (the ORCA flagship's f32 stack alone is ~9 GB)."""
    from desta25_audio_tpu_torch.ckpt.desta_io import trainable_state_dict
    from desta25_audio_tpu_torch.models.orca import (
        init_orca_connector,
        init_orca_cross_attns,
    )
    from desta25_audio_tpu_torch.models.qformer import init_qformer_connector
    cfg = DeSTA25Config(connector_mode=mode, orca_global_num_tokens=4,
                        **FLAGSHIP)
    if mode == "qformer_1":
        tree = {"connector": init_qformer_connector(cfg, torch.float32,
                                                    "meta", None)}
    else:
        tree = {"connector": init_orca_connector(cfg, torch.float32, "meta",
                                                 None),
                "orca_cross_attns": init_orca_cross_attns(
                    cfg, torch.float32, "meta", None)}
    sd = trainable_state_dict(tree, cfg)
    assert all(v.device.type == "meta" for v in sd.values())
    want = json.load(open(os.path.join(FIXTURES, manifest)))
    got = {k: list(v.shape) for k, v in sd.items()}
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: v for k, v in got.items() if v != want[k]} == {}


NANO = dict(llm_model_id="test/llama-nano", encoder_model_id="test/whisper-nano",
            qformer_num_hidden_layers=2, prompt_size=8, dtype="float32")
ORCA = dict(NANO, connector_mode="orca_hybrid", orca_global_num_tokens=4,
            orca_local_downsample=4, orca_local_kernel_size=5)


def _trainable_from_jax(jm, cfg):
    t = _np_tree(jm.params)
    conn = (bridge.connector_from_jax if cfg.connector_mode == "qformer_1"
            else bridge.orca_connector_from_jax)(t["connector"], "cpu")
    out = {"connector": conn}
    if "orca_cross_attns" in t:
        out["orca_cross_attns"] = bridge.orca_cross_attns_from_jax(
            t["orca_cross_attns"], "cpu")
    return out


@pytest.mark.parametrize("kw", [NANO, ORCA], ids=["qformer", "orca"])
def test_model_safetensors_roundtrip_with_jax(kw, tmp_path):
    """The port's export loads into the JAX model and equals the source;
    the JAX export loads into the port and equals the JAX tree; a legacy
    ``ocar_``-keyed file loads the same."""
    from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
    from desta25_audio_tpu import DeSTA25Config as JaxConfig
    from desta25_audio_tpu.ckpt import desta_io as jdio
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.ckpt import desta_io as tdio
    cfg, jcfg = DeSTA25Config(**kw), JaxConfig(**kw)
    tm = DeSTA25AudioModel(cfg, device="cpu", seed=3)
    trainable, _ = tm.split_params()
    p = str(tmp_path / "port.safetensors")
    tdio.save_trainable_safetensors(trainable, cfg, p)
    jm = JaxModel(jcfg, seed=5)
    jm.params = jdio.load_trainable_safetensors(jm.params, jcfg, p)
    assert_trees_equal(_trainable_from_jax(jm, cfg), trainable)

    jm2 = JaxModel(jcfg, seed=6)
    q = str(tmp_path / "jax.safetensors")
    jdio.save_trainable_safetensors(jm2.split_params()[0], jcfg, q)
    want = _trainable_from_jax(jm2, cfg)
    got = tdio.load_trainable_safetensors(tm.params, cfg, q)
    assert_trees_equal({k: got[k] for k in want}, want)
    assert got["llm"] is tm.params["llm"]          # the towers are shared

    if cfg.connector_mode == "orca_hybrid":
        sd = tio.load_safetensors(q)
        legacy = {k.replace("orca_", "ocar_"): v for k, v in sd.items()}
        assert any(k.startswith("ocar_cross_attns") for k in legacy)
        r = str(tmp_path / "legacy.safetensors")
        tio.save_safetensors(legacy, r)
        got = tdio.load_trainable_safetensors(tm.params, cfg, r)
        assert_trees_equal({k: got[k] for k in want}, want)
