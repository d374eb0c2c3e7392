"""The models' kernel predicates and the torch paths they choose where a
kernel cannot take the shape (the JAX package's dispatch: each Pallas kernel
runs only under its predicate, XLA otherwise).

- Each predicate says "no" exactly where its wrapper refuses: the wrappers
  are called on ``meta`` tensors, which take their kernel path (not the
  plain CPU one) and stop at the first refusal, a shape rule or, for a
  shape the kernel takes, the device check.
- The shipped ``configs/desta25_debug.yaml`` (whisper-nano Dh 32,
  llama-nano Dh 16, float32) runs ``generate()`` on the predicate-false
  paths, with greedy ids identical to the JAX package's XLA path.
- A bf16 decode step whose head dim is not 128 takes the layer loop and
  matches JAX's XLA step per layer (each layer's written cache rows) and in
  its logits.
- ``kernel_limits`` plans the decode attention's key ranges at the SM count
  it is given; the skinny GEMM's planner reads the weight's shape only.
- ``fused_inject_limits`` says "no" exactly where the decode / verify step
  refuses the in-kernel ORCA injection, and the injection attention's
  wrapper refuses no shape the limits take.
- ``quant_matmul_limits`` says "no" exactly where the wrapper its rows pick
  (K7 below 128 rows, x cast to bf16; the W8A8 GEMM from there) refuses,
  and ``quant_matmul`` then runs that regime's plain version, counted as a
  fallback, and otherwise reaches the wrapper.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu import DeSTA25AudioModel as JaxModel
from desta25_audio_tpu.config import config_from_yaml_model_section as jcfg
from desta25_audio_tpu.config import llm_config_for as j_llm_cfg
from desta25_audio_tpu_torch import DeSTA25AudioModel
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.ckpt.bridge import from_jax_params
from desta25_audio_tpu_torch.config import config_from_yaml_file
from desta25_audio_tpu_torch.config import llm_config_for as t_llm_cfg
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import skinny_gemm as sg
from desta25_audio_tpu_torch.ops.attention import flash_attention, flash_limits
from desta25_audio_tpu_torch.ops.enc_attention import (
    enc_attention_supported,
    packed_encoder_attention,
)
from desta25_audio_tpu_torch.ops.enc_ffn import (
    enc_ffn_supported,
    enc_ffn_w8a8_supported,
    encoder_ffn,
    encoder_ffn_w8a8,
)
from desta25_audio_tpu_torch.ops.fused_decode import (
    FusedStep,
    KVCache,
    fused_decode_limits,
    fused_inject_limits,
    inject_attention,
    kernel_limits,
)
from desta25_audio_tpu_torch.ops.qmm import (
    W8A8_MIN_ROWS,
    qmm,
    quant_matmul,
    quant_matmul_limits,
    w8a8_matmul,
)
from desta25_audio_tpu_torch.ops.w8a8_proj import proj_w8a8, w8a8_proj_supported

DEBUG_YAML = "configs/desta25_debug.yaml"
META = dict(device="meta")


def _refusal(fn) -> str:
    """The wrapper's first refusal on meta tensors ("" when only the device
    check refused: the kernel takes the shape)."""
    with pytest.raises(ValueError) as e:
        fn()
    msg = str(e.value)
    return "" if "expected the CUDA device" in msg else msg


@pytest.mark.parametrize("d_model,heads", [(1280, 20), (64, 2), (512, 4),
                                           (768, 12), (100, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_enc_attention_predicate(d_model, heads, dtype):
    q = torch.empty(1, 8, d_model, dtype=dtype, **META)
    why = _refusal(lambda: packed_encoder_attention(q, q, q, heads))
    assert enc_attention_supported(heads, d_model, dtype) == (why == "")


@pytest.mark.parametrize("D,F", [(1280, 5120), (64, 128), (384, 640),
                                 (1280, 1300)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_enc_ffn_predicates(D, F, dtype):
    x = torch.empty(1, 4, D, dtype=dtype, **META)
    w1 = torch.empty(F, D, dtype=dtype, **META)
    w2 = torch.empty(D, F, dtype=dtype, **META)
    b1, b2 = (torch.empty(n, dtype=dtype, **META) for n in (F, D))
    why = _refusal(lambda: encoder_ffn(x, w1, b1, w2, b2))
    assert enc_ffn_supported(D, F, dtype) == (why == "")
    q1 = torch.empty(F, D, dtype=torch.int8, **META)
    q2 = torch.empty(D, F, dtype=torch.int8, **META)
    s1, s2 = (torch.empty(n, **META) for n in (F, D))
    why = _refusal(lambda: encoder_ffn_w8a8(x, q1, s1, b1, q2, s2, b2))
    assert enc_ffn_w8a8_supported(D, F, dtype) == (why == "")
    leaf = {"q": q1, "s": s1, "b": b1}
    why = _refusal(lambda: proj_w8a8(x, leaf))
    # the projections check x's dtype after the leaves' placement
    assert w8a8_proj_supported(D, F, torch.bfloat16) == (why == "")
    assert not w8a8_proj_supported(D, F, torch.float32)


@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (4, 2, 16), (12, 12, 64),
                                     (6, 4, 64)])
def test_flash_predicate(H, Hkv, D):
    q = torch.empty(1, 512, H, D, dtype=torch.bfloat16, **META)
    kv = torch.empty(1, 512, Hkv, D, dtype=torch.bfloat16, **META)
    seg = torch.empty(1, 512, dtype=torch.int32, **META)
    why = _refusal(lambda: flash_attention(q, kv, kv, seg))
    assert (not flash_limits(H, Hkv, D, torch.bfloat16)) == (why == "")
    assert flash_limits(H, Hkv, D, torch.float32)


def _meta_tower(cfg, int8: bool):
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    shapes = {"wqkv": ((H + 2 * Hkv) * Dh, D), "wo": (D, H * Dh),
              "w_gu": (2 * I, D), "w_down": (D, I)}

    def leaf(shp):
        if int8:
            return {"q": torch.empty(L, *shp, dtype=torch.int8, **META),
                    "s": torch.empty(L, shp[0], **META)}
        return torch.empty(L, *shp, dtype=torch.bfloat16, **META)
    norm = {"scale": torch.empty(L, D, dtype=torch.bfloat16, **META)}
    layers = {k: leaf(s) for k, s in shapes.items()}
    layers.update(ln1=norm, ln2=norm)
    return {"layers": layers}


LLAMA8B = "meta-llama/Llama-3.1-8B-Instruct"


@pytest.mark.parametrize("model_id,B,kd,S", [
    (LLAMA8B, 2, 1, 256), (LLAMA8B, 9, 1, 12416), (LLAMA8B, 8, 1, 12416),
    (LLAMA8B, 2, 4, 256), (LLAMA8B, 2, 9, 256), ("test/llama-nano", 2, 1, 128),
    ("test/llama-nano128", 3, 1, 384)])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_predicate(model_id, B, kd, S, int8):
    """fused_decode_limits is empty exactly where FusedStep takes the step
    (its refusals before the device check), at the SM count it is given."""
    cfg = t_llm_cfg(model_id)
    cfg = dataclasses.replace(cfg, num_hidden_layers=1)
    params = _meta_tower(cfg, int8)
    KVD = cfg.num_key_value_heads * cfg.head_dim
    cache = KVCache(*(torch.empty(1, B, S, KVD, dtype=torch.bfloat16, **META)
                      for _ in range(2)))
    x = torch.empty(B, kd, cfg.hidden_size, dtype=torch.bfloat16, **META)
    pos = torch.zeros(B, kd, dtype=torch.long)
    mask = torch.ones(B, S, dtype=torch.int32)
    why = _refusal(lambda: FusedStep(params, cfg, x, mask, pos, cache, 0,
                                     "step"))
    bad = fused_decode_limits(params, cfg, torch.bfloat16, B, kd, S)
    assert (not bad) == (why == "")
    assert fused_decode_limits(params, cfg, torch.float32, B, kd, S)


def _meta_inject(cfg, B: int, ta: int, heads: int):
    """An int8 cross-attention stack and audio K/V [L, B, ta, D] on meta
    tensors: the in-kernel injection spec of ops/fused_decode.py."""
    L, D = cfg.num_hidden_layers, cfg.hidden_size

    def leaf(n):
        return {"q": torch.empty(L, n, D, dtype=torch.int8, **META),
                "s": torch.empty(L, n, **META), "b": torch.empty(L, n, **META)}
    stack = {"q": leaf(D), "o": leaf(D), "gate1": leaf(D // 4),
             "gate2": {"w": torch.empty(L, 1, D // 4, **META),
                       "b": torch.empty(L, 1, **META)},
             "ln": {"scale": torch.empty(L, D, **META),
                    "bias": torch.empty(L, D, **META)}}
    kv = torch.empty(L, B, ta, D, dtype=torch.bfloat16, **META)
    return dict(params={"layers": stack}, k=kv, v=kv, ta_real=ta,
                heads=heads, on=torch.empty(B, **META))


@pytest.mark.parametrize("model_id,B,kd,ta,heads", [
    (LLAMA8B, 2, 1, 375, 32), (LLAMA8B, 1, 4, 375, 32),
    (LLAMA8B, 4, 8, 375, 32), (LLAMA8B, 2, 1, 37, 32),
    ("Qwen/Qwen3-4B", 2, 1, 375, 32), (LLAMA8B, 2, 1, 375, 12),
    (LLAMA8B, 2, 1, 375, 8), (LLAMA8B, 1, 1, 60000, 32),
    (LLAMA8B, 1, 8, 6000, 32), ("test/llama-nano128", 2, 1, 56000, 4),
    ("test/llama-nano128", 2, 4, 8, 32)])
def test_inject_predicate(model_id, B, kd, ta, heads):
    """fused_inject_limits is empty exactly where FusedStep takes the
    injection (its refusals before the device check), on an int8 tower the
    step takes; where the limits take the shape, the injection attention's
    wrapper refuses nothing but the device."""
    cfg = dataclasses.replace(t_llm_cfg(model_id), num_hidden_layers=1)
    params = _meta_tower(cfg, True)
    S = 128
    KVD = cfg.num_key_value_heads * cfg.head_dim
    cache = KVCache(*(torch.empty(1, B, S, KVD, dtype=torch.bfloat16, **META)
                      for _ in range(2)))
    x = torch.empty(B, kd, cfg.hidden_size, dtype=torch.bfloat16, **META)
    pos = torch.zeros(B, kd, dtype=torch.long)
    mask = torch.ones(B, S, dtype=torch.int32)
    spec = _meta_inject(cfg, B, ta, heads)
    assert not fused_decode_limits(params, cfg, torch.bfloat16, B, kd, S)
    why = _refusal(lambda: FusedStep(params, cfg, x, mask, pos, cache, 0,
                                     "step", inject=spec))
    bad = fused_inject_limits(spec["params"], cfg, heads, ta, kd)
    assert (not bad) == (why == "")
    if not bad:
        iq = torch.empty(B * kd, cfg.hidden_size, dtype=torch.bfloat16,
                         **META)
        assert _refusal(lambda: inject_attention(iq, spec["k"][0],
                                                 spec["v"][0], ta,
                                                 heads)) == ""


def test_kernel_limits_at_an_sm_count():
    """At Llama-3.1-8B's heads, B * Hkv = 72 clusters: one key range on a
    132-SM card, whose shared memory holds some 12,100 keys; a card of twice
    the SMs splits the cache in three."""
    cfg = t_llm_cfg(LLAMA8B)
    assert not kernel_limits(cfg, 9, 1, 12000, True, n_sm=132)
    bad = kernel_limits(cfg, 9, 1, 12416, True, n_sm=132)
    assert len(bad) == 1 and "one key range of 12416 keys" in bad[0]
    assert not kernel_limits(cfg, 9, 1, 12416, True, n_sm=264)
    assert not kernel_limits(cfg, 8, 1, 12416, True, n_sm=132)  # 64: 2 ranges
    assert kernel_limits(cfg, 2, 1, 256, True) == kernel_limits(
        cfg, 2, 1, 256, True, n_sm=132)


# x rows, leaf [N, K], x dtype: the nano towers' N = 64 wo / down at W8A8
# rows, a K = 32 mesh shard at K7 rows, f32 x on both sides of the
# crossover, and Llama-3.1-8B's layer and head shapes (all taken)
QMM_CASES = [
    (128, 64, 64, torch.bfloat16), (296, 64, 128, torch.bfloat16),
    (2, 64, 32, torch.bfloat16), (100, 64, 32, torch.bfloat16),
    (2, 4096, 4096, torch.float32), (100, 4096, 4096, torch.float32),
    (128, 4096, 4096, torch.float32),
    *[(M, N, K, torch.bfloat16) for M in (2, 121, 296)
      for N, K in ((6144, 4096), (4096, 4096), (28672, 4096),
                   (4096, 14336), (130560, 4096))],
]


@pytest.mark.parametrize("M,N,K,dtype", QMM_CASES)
def test_quant_matmul_predicate(M, N, K, dtype):
    x = torch.empty(M, K, dtype=dtype, **META)
    leaf = {"q": torch.empty(N, K, dtype=torch.int8, **META),
            "s": torch.empty(N, **META)}
    if M < W8A8_MIN_ROWS:
        why = _refusal(lambda: qmm(x.to(torch.bfloat16), leaf["q"],
                                   leaf["s"], torch.float32))
    else:
        why = _refusal(lambda: w8a8_matmul(x, leaf["q"], leaf["s"],
                                           torch.float32))
    bad = quant_matmul_limits(M, N, K, dtype)
    assert (bad == []) == (why == "")
    _build.reset_launch_counts()
    if bad:
        y = quant_matmul(x, leaf)
        assert y.shape == (M, N) and y.dtype == dtype
        assert _build.fallback_counts() == {
            "quant_matmul" if M < W8A8_MIN_ROWS else "w8a8_matmul": 1}
    else:
        with pytest.raises(ValueError, match="expected the CUDA device"):
            quant_matmul(x, leaf)
        assert _build.fallback_counts() == {}
    assert _build.launch_counts() == {}


def test_skinny_gemm_plan_reads_the_weight_only():
    """One plan for any number of token rows (the decode step's and the
    verify step's rows sum alike); whole ranks, at most 8, covering K."""
    for rows, K, int8 in ((6144, 4096, True), (4096, 4096, True),
                          (28672, 4096, False), (4096, 14336, True),
                          (130560, 4096, True), (1024, 4096, True),
                          (5120, 9728, False), (200, 1072, True), (8, 16, True)):
        for n_sm in (132, 114, 78):
            p = sg.plan_skinny_gemm(rows, K, int8, n_sm)
            assert 1 <= p.ns <= sg.SPLITS_MAX
            assert (p.ns - 1) * p.tps < p.nkt <= p.ns * p.tps
            assert p.nkt * sg.ROW_BYTES >= K * (1 if int8 else 2)
            assert p.tiles * sg.TILE_ROWS >= rows
    assert sg.plan_skinny_gemm(4096, 14336, True) == (5, 23, 112, 64)
    assert sg.plan_skinny_gemm(6144, 4096, True) == (3, 11, 32, 96)
    assert sg.plan_skinny_gemm(130560, 4096, True).ns == 1
    assert sg.passes(2) == sg.passes(8) == sg.passes(16) == 1
    assert sg.passes(17) == 2


@pytest.mark.parametrize("R", [1, 3, 17])
@pytest.mark.parametrize("epi", range(7))
def test_skinny_gemm_plain_on_cpu(R, epi):
    """On CPU tensors the wrapper is its plain version; the plain version's
    rounding points are the kernel's (checked here against a float64
    recomputation of the same formula)."""
    rng = np.random.default_rng(epi * 31 + R)
    N, K = 24, 48
    nw = 2 if epi == sg.EPI_SWIGLU else 1
    x = torch.from_numpy(rng.standard_normal((R, K))).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (N * nw, K))).to(torch.int8)
    s = torch.from_numpy(rng.random(N * nw) * 0.01 + 1e-3).float()
    bias = (torch.from_numpy(rng.standard_normal(N)).float()
            if epi in (sg.EPI_BIAS, sg.EPI_BIAS_GELU) else None)
    out = None
    if epi == sg.EPI_RESID:
        out = torch.from_numpy(rng.standard_normal((R, N))).bfloat16()
    elif epi == sg.EPI_ADD_F32:
        out = torch.from_numpy(rng.standard_normal((R, N))).float()
    got = sg.skinny_gemm(x, q, s, epi, out, bias)
    v = (x.float() @ q.float().t()) * s
    bf = torch.bfloat16
    want = {sg.EPI_STORE: lambda: v.to(bf),
            sg.EPI_STORE_F32: lambda: v,
            sg.EPI_ADD_F32: lambda: out + v,
            sg.EPI_RESID: lambda: (out.float() + v.to(bf).float()).to(bf),
            sg.EPI_BIAS: lambda: (v + bias).to(bf)}
    if epi in want:
        assert torch.equal(got, want[epi]())
    else:
        assert got.shape == (R, N) and got.dtype == bf
        assert bool(got.float().isfinite().all())


@pytest.fixture(scope="module")
def debug_models():
    import yaml
    with open(DEBUG_YAML) as f:
        section = yaml.safe_load(f)["model"]
    jm = JaxModel(jcfg(section), seed=0)
    cfg = config_from_yaml_file(DEBUG_YAML)
    assert cfg.dtype == "float32"
    params = from_jax_params(jax.tree.map(np.asarray, jm.params), cfg, "cpu")
    return jm, DeSTA25AudioModel(cfg, device="cpu", params=params)


def test_debug_config_generate_matches_jax_xla(debug_models, tmp_path):
    """The debug config's encoder (Dh 32, 150 frames), Q-Former and LLM
    (Dh 16) in float32: no kernel's predicate holds, the torch paths run
    (and are counted), and the greedy ids are the JAX package's."""
    jm, tm = debug_models
    paths = []
    for i, n in enumerate((16000, 24000)):
        t = np.arange(n) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * (300.0 + 140 * i) * t)
               ).astype(np.float32)
        paths.append(str(tmp_path / f"tone{i}.wav"))
        write_wav(paths[-1], sig)
    msgs = [[{"role": "user", "content": "What do you hear? <|AUDIO|>",
              "audios": [{"audio": paths[0], "text": "a tone"}]}],
            [{"role": "user", "content": "And here? <|AUDIO|>",
              "audios": [{"audio": paths[1], "text": "a lower tone"}]}]]
    _build.reset_launch_counts()
    got = tm.generate(msgs, max_new_tokens=8, do_sample=False)
    taken = _build.fallback_counts()
    assert _build.launch_counts() == {}
    assert taken["packed_encoder_attention"] > 0      # encoder and Q-Former
    assert taken["encoder_ffn"] > 0
    assert taken["fused_decode_layers"] > 0
    want = jm.generate(msgs, max_new_tokens=8, do_sample=False)
    assert got.generated_ids == want.generated_ids


def test_decode_step_off_the_kernel_matches_jax_per_layer():
    """llama-nano in bf16 (Dh 16): the decode step's predicate fails, the
    layer loop runs, and every layer's written k/v rows and the logits agree
    with the JAX XLA step (bf16 on both sides: within 3e-2 of the scale)."""
    from desta25_audio_tpu.models import llm as jl
    from desta25_audio_tpu_torch.models import llm as tl
    cfg = j_llm_cfg("test/llama-nano")
    jp = jl.init_llm(jax.random.PRNGKey(3), cfg, dtype=jnp.bfloat16)
    tp = bridge.llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = t_llm_cfg("test/llama-nano")
    rng = np.random.default_rng(7)
    B, T, S = 2, 10, 128
    ids = rng.integers(3, cfg.vocab_size, size=(B, T))
    full = np.zeros((B, S), np.int32)
    full[:, :T] = 1
    full[1, :2] = 0
    pos = np.maximum(np.cumsum(full[:, :T], 1) - 1, 0)
    jcache = jl.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    tcache = tl.init_kv_cache(tcfg, B, S, dtype=torch.bfloat16, device="cpu")
    _, jcache, _ = jl.llm_apply(
        jp, cfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(full),
        positions=jnp.asarray(pos), cache=jcache, cache_index=0)
    _, tcache = tl.llm_apply(
        tp, tcfg, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(full),
        positions=torch.from_numpy(pos), cache=tcache, cache_index=0)
    full[:, T] = 1
    nxt = rng.integers(3, cfg.vocab_size, size=(B, 1))
    step_pos = pos[:, -1:] + 1
    want, jcache, _ = jl.llm_apply(
        jp, cfg, input_ids=jnp.asarray(nxt), attention_mask=jnp.asarray(full),
        positions=jnp.asarray(step_pos), cache=jcache, cache_index=T)
    _build.reset_launch_counts()
    got, tcache = tl.llm_apply(
        tp, tcfg, input_ids=torch.from_numpy(nxt),
        attention_mask=torch.from_numpy(full),
        positions=torch.from_numpy(step_pos), cache=tcache, cache_index=T)
    assert _build.fallback_counts() == {"fused_decode_layers": 1}

    def close(a, b, tol=3e-2):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b, np.float32)
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-6) < tol

    for l in range(cfg.num_hidden_layers):
        close(tcache.k[l, :, T], jcache.k[l, :, T])
        close(tcache.v[l, :, T], jcache.v[l, :, T])
    close(got, want)


@pytest.mark.parametrize("mode", ["int8", "dual"])
def test_int8_nano_encoder_off_the_kernels_matches_jax(mode):
    """The int8 encoder at nano (150 frames, Dh 32, F 128): no W8A8 kernel
    takes it, so the port runs the JAX package's XLA path: an int8 leaf
    without ``w`` through ``int8_act_matmul``'s formula, a "dual" leaf
    through its float ``w``, the FFN on dequantized weights.  Taps and
    output within 1e-4 of the JAX encoder's (its XLA path on the CPU; f32
    sums in another order), in f32; the torch paths are counted."""
    from desta25_audio_tpu.config import whisper_config_for as j_wcfg
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.ops import quant as jq
    from desta25_audio_tpu_torch.config import whisper_config_for as t_wcfg
    from desta25_audio_tpu_torch.models import whisper as tw
    jcfg, tcfg = j_wcfg("test/whisper-nano"), t_wcfg("test/whisper-nano")
    jenc = jq.quantize_encoder_params(
        jw.init_whisper_encoder(jax.random.PRNGKey(2), jcfg, jnp.float32),
        attention=mode)
    tenc = bridge.whisper_encoder_from_jax(jax.tree.map(np.asarray, jenc),
                                           "cpu")
    mel = np.random.default_rng(4).standard_normal(
        (2, jcfg.expected_mel_frames, jcfg.num_mel_bins)).astype(np.float32)
    jf, jt = jw.whisper_encoder_apply(jenc, jnp.asarray(mel), jcfg, (1, 3))
    _build.reset_launch_counts()
    tf_, tt = tw.whisper_encoder_apply(tenc, torch.from_numpy(mel), tcfg,
                                       (1, 3))
    L = tcfg.encoder_layers
    assert _build.fallback_counts() == {"packed_encoder_attention": L,
                                        "encoder_ffn_w8a8": L}
    for got, want in ((tt, jt), (tf_, jf)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4
