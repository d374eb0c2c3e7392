"""The port's CUDA kernels against their plain versions on the card, at odd
shapes the flagship run does not reach (ragged tiles, one row, 3/5/9 decode
rows, grouped-query ratios, qk-norm, a K4 hidden of one, two and three
1280-wide chunks, and one whose chunks differ 64x in scale, and a width
K4 refuses; the Hopper GEMM of K3-K6 at the encoder's widths and
1-3000 rows, K4-K6 bit for bit, K3 beside a dropped-k-tile control; K7 on
both of its paths with a ragged last column tile, its wgmma path at
Llama-3.1-8B's four layer shapes and 17-127 rows (two launches' bits, a
dropped-k-range control) and its plan against the C twin, the LLM's W8A8 GEMM at
ragged M and, bit for bit, at Llama-3.1-8B's split-K shapes,
``quant_matmul``'s dispatch (f32 x through K7, the shapes neither kernel
takes on their counted plain versions) and the debug config's int8 LLM in
bf16 and f32 against the same model on the CPU, the int8
decode step, the verify step at 2/4/8 draft tokens with the block ending
at the cache's end, the ORCA injection K8i at injection head dims 128 and
80, 1, 4 or 8 tokens per row, 1, 2 or 4 batch rows and 37 or 375 audio
tokens, with a row that does not inject, the verify step's token 0 against
the decode step, its attention alone at head dims 20-256 and a range read
from global memory, its gate alone, and the requests it refuses; the flash attention K11, forward and backward, at
the training shape, at a T
that is not a multiple of its tile, bidirectional, with left and right
padding; the log-mel frontend K1 at 3000, a ragged 300, 37 and 2 frames and clips
not a multiple of 4 samples long, two launches' bits;
the per-layer decode pair K9's halves at 1, 3 and 17 rows, at a p = 2
shard's shapes, its layer loop with a hook between layers, and the requests it
refuses; K10 at 2 and 4 virtual ranks, decode and verify, K9's pair under a
mesh, and an all-reduce whose producers never run timing out; a nano ORCA
train step (its aux terms relative to the CPU's, beside a faulty Q-Former
that must break them) and a nano int8-tower train step against the same
model's step on the CPU, and training's int8 products at 128-256 rows;
Whisper ASR: a 2-layer f32 copy of whisper-large-v3's decoder, its cached
steps against the full forward beside a cache written one slot late, and
``generate()`` with ASR on whisper-large-v3 and a nano LLM, whose K1 and
encoder-kernel launches are those of the call with transcriptions plus one
more mel and encoder pass, then a feature-cache hit that launches none);
the serving engine's kept decode graph on a nano int8 tower: captured once
while requests come and go, its tokens equal the eager engine's, beside a
control that places admissions into a new cache tensor and must part;
checkpoints: int8 weights quantized on the card bit-identical to the CPU's
on rows where the reciprocal product rounds apart, a bf16 file read
straight onto the card, and a nano ``from_pretrained(device="cuda")`` whose
tree and greedy ids equal the CPU's load; LoRA: the merge and the int8
quantizer after it on the card bit-identical to the CPU's, at Llama-3.1-8B's
width and through ``merge_lora_for_serving(quantize=True)``).
Marked ``cuda``: each test skips
where torch.cuda.is_available() is False.  On a GPU machine (no jax needed):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import contextlib
import ctypes
import dataclasses
import types

import pytest
import torch

from desta25_audio_tpu_torch.config import llm_config_for
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.models import qformer as tqformer
from desta25_audio_tpu_torch.models.orca import init_orca_cross_attns
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.enc_attention import (
    packed_encoder_attention,
    packed_encoder_attention_plain,
    plan_key_splits,
)
from desta25_audio_tpu_torch.ops.enc_ffn import (
    encoder_ffn,
    encoder_ffn_plain,
    encoder_ffn_w8a8,
    encoder_ffn_w8a8_plain,
)
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_decode_layers,
    fused_decode_layers_plain,
    fused_inject_limits,
    fused_verify_layers,
    inject_attention,
    inject_attention_plain,
    inject_attention_smem,
    inject_gate,
    inject_gate_plain,
    plan_inject_splits,
)
from desta25_audio_tpu_torch.ops.gemm import cluster_ctas
from desta25_audio_tpu_torch.ops.qmm import (
    QMM_K_BYTES,
    plan_qmm,
    qmm,
    qmm_plain,
    quant_matmul,
    w8a8_matmul,
    w8a8_matmul_plain,
)
from desta25_audio_tpu_torch.ops.quant import (
    quantize_linear,
    quantize_llm_params,
    quantize_orca_cross_attns,
    quantize_weight,
)
from desta25_audio_tpu_torch.ops.w8a8_proj import (
    proj_w8a8,
    proj_w8a8_plain,
    qkv_w8a8,
    qkv_w8a8_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    return torch.Generator("cuda").manual_seed(0)


def _rel(got, want):
    got, want = got.float(), want.float()
    assert bool(got.isfinite().all())
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,Tq,Tkv,H,peak", [
    (1, 70, 70, 2, False), (3, 5, 130, 4, False), (2, 64, 1, 1, False),
    # the 128-key tile's edges, self-attention
    *((1, t, t, 2, False) for t in (1, 63, 64, 65, 127, 128, 129, 1500)),
    (8, 64, 1500, 20, False),   # the cross shape: keys split across blocks
    (2, 64, 1500, 2, True),     # split, the last range's maxima far above
])
def test_enc_attention_kernel(gen, B, Tq, Tkv, H, peak):
    mk = lambda t: torch.randn(B, t, H * 64, generator=gen,  # noqa: E731
                               device="cuda").bfloat16()
    q, k, v = mk(Tq), mk(Tkv), mk(Tkv)
    if peak:
        q = (6 * q.float()).bfloat16()
        k[:, 1152:] = (3 * k[:, 1152:].float()).bfloat16()
    splits = len(plan_key_splits(B, H, Tq, Tkv, torch.cuda
                                 .get_device_properties(0)
                                 .multi_processor_count)) - 1
    _build.reset_launch_counts()
    got = packed_encoder_attention(q, k, v, H)
    # a split adds the launch that combines the key ranges
    assert _build.launch_counts() == {
        "packed_encoder_attention": 1 if splits == 1 else 2}
    assert _rel(got, packed_encoder_attention_plain(q, k, v, H)) < 2e-2


@pytest.mark.parametrize("M,D,F", [(1, 128, 256), (130, 128, 384)])
def test_enc_ffn_kernel(gen, M, D, F):
    bf = torch.bfloat16
    x = torch.randn(1, M, D, generator=gen, device="cuda").to(bf)
    w1 = (torch.randn(F, D, generator=gen, device="cuda") / D ** .5).to(bf)
    b1 = torch.randn(F, generator=gen, device="cuda").to(bf)
    w2 = (torch.randn(D, F, generator=gen, device="cuda") / F ** .5).to(bf)
    b2 = torch.randn(D, generator=gen, device="cuda").to(bf)
    got = encoder_ffn(x, w1, b1, w2, b2)
    assert _rel(got, encoder_ffn_plain(x, w1, b1, w2, b2)) < 2e-2


# K4-K6 against their plain versions: the int32 sums are exact and the f32
# epilogues run in the plain version's order (bit-identical on the H100), so
# only an erff-vs-erf step (~1e-4 of the output scale) may show; a K4 hidden
# quantized per row instead of per 1280-column chunk lands at ~1.5e-2
TOL_W8A8 = 1e-3


def _int8_leaf(gen, n, k, bias=True, mult=1.0):
    p = {"w": (torch.randn(n, k, generator=gen, device="cuda")
               / k ** .5 * mult).bfloat16()}
    if bias:
        p["b"] = (0.1 * torch.randn(n, generator=gen, device="cuda")
                  ).bfloat16()
    return quantize_linear(p)


@pytest.mark.parametrize("B,T,D,N", [(1, 1, 128, 128), (1, 130, 256, 384),
                                     (2, 75, 128, 256)])
def test_w8a8_proj_kernels(gen, B, T, D, N):
    x = torch.randn(B, T, D, generator=gen, device="cuda").bfloat16()
    lq, lk, lv = (_int8_leaf(gen, N, D, bias=b) for b in (True, False, True))
    _build.reset_launch_counts()
    got = qkv_w8a8(x, lq, lk, lv)
    one = proj_w8a8(x, lq)
    # one row quantisation and one GEMM launch for each wrapper call
    assert _build.launch_counts() == {"qkv_w8a8": 2, "proj_w8a8": 2}
    for g, w in zip(got + (one,), qkv_w8a8_plain(x, lq, lk, lv) + (
            proj_w8a8_plain(x, lq),)):
        assert g.shape == (B, T, N) and g.is_contiguous()
        assert _rel(g, w) < TOL_W8A8


@pytest.mark.parametrize("M,D,F,skew", [
    (1, 128, 1280, False), (130, 128, 1280, False), (257, 256, 2560, False),
    (257, 256, 3840, False),   # three chunks: clusters in three groups
    (130, 128, 2560, True),    # chunk 1 64x below chunk 0, fc2 64x above
])
def test_encoder_ffn_w8a8_kernel(gen, M, D, F, skew):
    x = torch.randn(1, M, D, generator=gen, device="cuda").bfloat16()
    mult = torch.ones(F, device="cuda")
    if skew:
        mult[1280:] = 1 / 64
    l1 = _int8_leaf(gen, F, D, mult=mult[:, None])
    l2 = _int8_leaf(gen, D, F, mult=1 / mult[None, :])
    args = (x, l1["q"], l1["s"], l1["b"], l2["q"], l2["s"], l2["b"])
    _build.reset_launch_counts()
    got = encoder_ffn_w8a8(*args)
    # quantise x, fc1 + GELU + the hidden's quantisation per 1280 columns
    # (across a cluster), fc2
    assert _build.launch_counts() == {"encoder_ffn_w8a8": 3}
    assert got.shape == (1, M, D)
    assert _rel(got, encoder_ffn_w8a8_plain(*args)) < TOL_W8A8


# the Hopper GEMM (csrc/gemm_sm90.cuh) at the whisper encoder's widths and
# the planner's ragged row counts: one row tile, 256 x 128 tiles with a
# ragged last tile, and the encoder's b1 / b2 rows
GEMM_ROWS = (1, 127, 129, 250, 1500, 3000)


@pytest.mark.parametrize("M", GEMM_ROWS)
def test_enc_ffn_gemm_rows(gen, M):
    """K3 within 2e-2 (TOL_ENC) of its plain version; the control, the
    plain version with fc2's last k-tile (64 columns of F) dropped, as a
    ring that lost a stage would compute, reads above it."""
    D, F = 1280, 5120
    bf = torch.bfloat16
    x = torch.randn(1, M, D, generator=gen, device="cuda").to(bf)
    w1 = (torch.randn(F, D, generator=gen, device="cuda") / D ** .5).to(bf)
    b1 = (0.1 * torch.randn(F, generator=gen, device="cuda")).to(bf)
    w2 = (torch.randn(D, F, generator=gen, device="cuda") / F ** .5).to(bf)
    b2 = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf)
    want = encoder_ffn_plain(x, w1, b1, w2, b2)
    assert _rel(encoder_ffn(x, w1, b1, w2, b2), want) < 2e-2
    w2c = w2.clone()
    w2c[:, -64:] = 0
    assert _rel(encoder_ffn_plain(x, w1, b1, w2c, b2), want) > 2e-2


@pytest.mark.parametrize("M", GEMM_ROWS)
@pytest.mark.parametrize("skew", [False, True])
def test_w8a8_gemm_rows_bit_identical(gen, M, skew):
    """K5, K6 and K4 equal their plain versions bit for bit (exact int32
    sums, the plain version's rounding points), K4 also on weights whose
    GELU chunks differ 64x in scale."""
    D, F = 1280, 5120
    x = torch.randn(1, M, D, generator=gen, device="cuda").bfloat16()
    lq, lk, lv, lo = (_int8_leaf(gen, D, D, bias=b)
                      for b in (True, False, True, True))
    mult = torch.ones(F, device="cuda")
    if skew:
        mult[1280:] = 1 / 64
    l1 = _int8_leaf(gen, F, D, mult=mult[:, None])
    l2 = _int8_leaf(gen, D, F, mult=1 / mult[None, :])
    ffn = (l1["q"], l1["s"], l1["b"], l2["q"], l2["s"], l2["b"])
    assert torch.equal(encoder_ffn_w8a8(x, *ffn),
                       encoder_ffn_w8a8_plain(x, *ffn))
    if not skew:
        for g, w in zip(qkv_w8a8(x, lq, lk, lv),
                        qkv_w8a8_plain(x, lq, lk, lv)):
            assert torch.equal(g, w)
        assert torch.equal(proj_w8a8(x, lo), proj_w8a8_plain(x, lo))


@pytest.mark.parametrize("M", [128, 129, 250, 257])
@pytest.mark.parametrize("N,K", [(4096, 4096), (6144, 4096), (4096, 14336)])
def test_w8a8_llm_gemm_bit_identical(gen, M, N, K):
    """The LLM's W8A8 prefill at Llama-3.1-8B's wqkv / wo / down, whose
    plans at M <= 256 split K across a cluster (int32 partials summed
    through distributed shared memory), bit for bit its plain version."""
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    leaf = quantize_weight(torch.randn(N, K, generator=gen, device="cuda")
                           / K ** .5)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(w8a8_matmul(x, leaf["q"], leaf["s"], dt),
                           w8a8_matmul_plain(x, leaf["q"], leaf["s"], dt))


@pytest.mark.parametrize("B,qk_norm,heads", [
    (1, False, (4, 2)), (3, True, (4, 2)), (5, False, (8, 1)),
    (9, True, (16, 2)),
])
def test_fused_decode_kernel(gen, B, qk_norm, heads):
    H, Hkv = heads
    cfg = dataclasses.replace(
        llm_config_for("test/llama-nano128"), num_attention_heads=H,
        num_key_value_heads=Hkv, qk_norm=qk_norm)
    params = tllm.init_llm(cfg, torch.bfloat16, "cuda", gen)
    S = 256
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.randint(1, S, (B,), generator=gen, device="cuda")
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    mask[torch.arange(B, device="cuda"), ci] = 1
    pos = ci[:, None]
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, 1), generator=gen, device="cuda"))
    ck = KVCache(cache0.k.clone(), cache0.v.clone())
    cp = KVCache(cache0.k.clone(), cache0.v.clone())
    hk, _ = fused_decode_layers(params, cfg, x, mask, pos, ck, ci)
    hp, _ = fused_decode_layers_plain(params, cfg, x, mask, pos, cp, ci)
    assert _rel(hk, hp) < 3e-2
    rows = (slice(None), torch.arange(B, device="cuda"), ci)
    assert _rel(ck.k[rows], cp.k[rows]) < 3e-2
    assert _rel(ck.v[rows], cp.v[rows]) < 3e-2  # bf16 of f32 sums
    changed = (ck.k != cache0.k).any(-1)
    expect = torch.zeros_like(changed)
    expect[rows] = True
    assert torch.equal(changed, expect)


def test_wrappers_raise_on_what_they_do_not_take(gen):
    q = torch.randn(1, 8, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        packed_encoder_attention(q, q, q, 2)            # f32 on the card
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="Dh=64"):
        packed_encoder_attention(qb, qb, qb, 4)          # Dh = 32
    w = torch.randn(256, 128, device="cuda").bfloat16()
    b = torch.zeros(256, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        encoder_ffn(qb, w, b, w.t(), b[:128])
    leaf = quantize_linear({"w": w, "b": b})
    with pytest.raises(ValueError, match="bfloat16"):
        qkv_w8a8(q, leaf, leaf, leaf)                    # f32 on the card
    with pytest.raises(ValueError, match="N % 128"):
        proj_w8a8(torch.zeros(1, 8, 256, device="cuda").bfloat16(),
                  quantize_linear({"w": w.t()[:96].contiguous()}))
    l1 = quantize_linear({"w": w, "b": b})                # F = 256
    l2 = quantize_linear({"w": w.t().contiguous(), "b": b[:128]})
    with pytest.raises(ValueError, match="F % 1280"):
        encoder_ffn_w8a8(qb, l1["q"], l1["s"], l1["b"], l2["q"], l2["s"],
                         l2["b"])


# K7 and the LLM's W8A8 GEMM against their plain versions, within 1e-3 of the
# output scale: W8A8's int32 sums are exact and its epilogue runs in the plain
# version's order; K7's f32 sums differ from the plain version's only in
# order (~1e-6), so it is compared in f32, where a bf16 rounding flip cannot
# hide behind the tolerance
TOL_QMM = 1e-3


@pytest.mark.parametrize("M", [1, 3, 9, 17, 64, 100, 127])
def test_qmm_kernel(gen, M):
    N, K = 1000, 512                      # N: a ragged last 128-column tile
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    leaf = quantize_weight(torch.randn(N, K, generator=gen, device="cuda")
                           / K ** .5)
    _build.reset_launch_counts()
    got = qmm(x, leaf["q"], leaf["s"], torch.float32)
    got_bf = qmm(x, leaf["q"], leaf["s"], torch.bfloat16)
    assert _build.launch_counts() == {"quant_matmul": 2}
    path = "skinny_gemm" if M <= 16 else "quant_matmul_prefill"
    assert _build.kernel_counts() == {path: 2}
    assert got.shape == (M, N) and got_bf.dtype == torch.bfloat16
    want = qmm_plain(x, leaf["q"], leaf["s"], torch.float32)
    assert _rel(got, want) < TOL_QMM
    assert _rel(got_bf, want) < 1e-2      # one bf16 rounding


# quant_matmul's dispatch (x rows, leaf [N, K], x dtype): K7 for f32 x cast
# to bf16 below 128 rows; the plain version of the row regime, counted,
# where neither kernel takes the call (a nano tower's N = 64 at W8A8 rows,
# a K = 32 shard at K7 rows, f32 x at W8A8 rows)
@pytest.mark.parametrize("M,N,K,dtype,path", [
    (2, 512, 64, torch.float32, "quant_matmul"),
    (100, 1000, 512, torch.float32, "quant_matmul"),
    (128, 64, 64, torch.bfloat16, "fallback w8a8_matmul"),
    (296, 64, 128, torch.bfloat16, "fallback w8a8_matmul"),
    (2, 64, 32, torch.bfloat16, "fallback quant_matmul"),
    (128, 512, 64, torch.float32, "fallback w8a8_matmul")])
def test_quant_matmul_dispatch(gen, M, N, K, dtype, path):
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    leaf = quantize_weight(torch.randn(N, K, generator=gen, device="cuda")
                           / K ** .5)
    _build.reset_launch_counts()
    got = quant_matmul(x, leaf, torch.float32)
    assert got.shape == (M, N)
    if path.startswith("fallback"):
        name = path.split()[1]
        assert _build.fallback_counts() == {name: 1}
        assert _build.launch_counts() == {}
        plain = qmm_plain if name == "quant_matmul" else w8a8_matmul_plain
        assert torch.equal(got, plain(x, leaf["q"], leaf["s"],
                                      torch.float32))
    else:
        assert _build.launch_counts() == {"quant_matmul": 1}
        assert _build.fallback_counts() == {}
        want = qmm_plain(x, leaf["q"], leaf["s"], torch.float32)
        assert _rel(got, want) < TOL_QMM
        assert torch.equal(got, qmm(x.bfloat16(), leaf["q"], leaf["s"],
                                    torch.float32))


# training's dispatch (w8a8=False) at 128-256 rows, where the TPU runs K7:
# K7's math as one library product, counted; against qmm_plain in f32 and
# the straight-through dx against the same rule on the CPU
@pytest.mark.parametrize("M", [128, 200, 256])
def test_quant_matmul_training_band(gen, M):
    N, K = 1000, 512
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    leaf = quantize_weight(torch.randn(N, K, generator=gen, device="cuda")
                           / K ** .5)
    g = torch.randn(M, N, generator=gen, device="cuda")
    _build.reset_launch_counts()
    x.requires_grad_(True)
    got = quant_matmul(x, leaf, torch.float32, w8a8=False)
    (dx,) = torch.autograd.grad(got, x, g)
    assert _build.fallback_counts() == {"quant_matmul_dequant": 1}
    assert _build.launch_counts() == {}
    want = qmm_plain(x.detach(), leaf["q"], leaf["s"], torch.float32)
    assert _rel(got.detach(), want) < TOL_QMM
    xc = x.detach().cpu().requires_grad_(True)
    cl = {k: v.cpu() for k, v in leaf.items()}
    (dxc,) = torch.autograd.grad(quant_matmul(xc, cl, torch.float32,
                                              w8a8=False), xc, g.cpu())
    assert dx.dtype == torch.bfloat16 and _rel(dx, dxc.cuda()) < 2 ** -8


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_debug_config_generate_matches_cpu(gen, tmp_path, dtype):
    """The debug config's towers with the LLM quantized, in bf16 and in
    float32, greedy generate() at b2 with B * T >= 128 prompt rows: the
    ids of the same model on the CPU; the refused W8A8 products counted;
    K7 launched for each decode step's products and head at M = B."""
    import numpy as np
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.audio.io import write_wav
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    paths = []
    for i, secs in enumerate((3.0, 5.5)):
        t = np.arange(int(secs * 16000)) / 16000.0
        paths.append(str(tmp_path / f"tone{i}.wav"))
        write_wav(paths[-1], (0.5 * np.sin(2 * np.pi * (300 + 140 * i) * t)
                              ).astype(np.float32))
    msgs = [[{"role": "user", "content": "Describe the sound in detail. "
              "<|AUDIO|>", "audios": [{"audio": p, "text": "a tone"}]}]
            for p in paths]
    cfg = dataclasses.replace(
        config_from_yaml_file("configs/desta25_debug.yaml"), dtype=dtype)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0)
    model.apply_llm_quant()
    _build.reset_launch_counts()
    got = model.generate(msgs, do_sample=False, max_new_tokens=8)
    counts, taken = _build.launch_counts(), _build.fallback_counts()
    steps = model.last_timings["decode_steps"]

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()
    cpu = DeSTA25AudioModel(cfg, device="cpu", params=to_cpu(model.params),
                            tokenizer=model.tokenizer)
    want = cpu.generate(msgs, do_sample=False, max_new_tokens=8)
    assert got.generated_ids == want.generated_ids
    assert taken.get("w8a8_matmul", 0) > 0
    L = model.llm_cfg.num_hidden_layers
    assert counts["quant_matmul"] == (4 * L + 1) * steps


LLAMA_K7 = (("wqkv", 6144, 4096), ("wo", 4096, 4096),
            ("gate/up", 28672, 4096), ("down", 4096, 14336))


@pytest.fixture(scope="module")
def llama_leaves():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    g = torch.Generator("cuda").manual_seed(3)
    return {name: quantize_weight(torch.randn(N, K, generator=g,
                                              device="cuda") / K ** .5)
            for name, N, K in LLAMA_K7}


@pytest.mark.parametrize("M", [17, 33, 64, 65, 100, 121, 127])
@pytest.mark.parametrize("name", [n for n, _, _ in LLAMA_K7])
def test_qmm_wgmma_llama(gen, llama_leaves, name, M):
    """K7's wgmma path at Llama-3.1-8B's layer shapes: f32 within TOL_QMM
    of the plain version, bf16 the same sum rounded once, two launches
    bit-identical (the ranks meet in a fixed order), and the control, the
    plain version with rank 0's k-range dropped, above the gate."""
    leaf = llama_leaves[name]
    N, K = leaf["q"].shape
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    got = qmm(x, leaf["q"], leaf["s"], torch.float32)
    again = qmm(x, leaf["q"], leaf["s"], torch.float32)
    got_bf = qmm(x, leaf["q"], leaf["s"], torch.bfloat16)
    want = qmm_plain(x, leaf["q"], leaf["s"], torch.float32)
    assert _rel(got, want) < TOL_QMM
    assert torch.equal(got, again)
    assert torch.equal(got_bf, got.bfloat16())
    plan = plan_qmm(M, N, K, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    dropped = x.clone()
    dropped[:, :plan.tps * QMM_K_BYTES] = 0
    assert _rel(qmm_plain(dropped, leaf["q"], leaf["s"], torch.float32),
                want) > TOL_QMM


def test_qmm_plan_matches_the_kernel(gen):
    """plan_qmm against its C twin (desta_qmm_plan) on this card and at
    the H100's 132 SMs, and the cluster table against the occupancy the
    runtime reports for the kernel."""
    lib = _build.library()
    out = (ctypes.c_int * 5)()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M in (17, 64, 65, 121, 128):
        for N, K in ((1000, 512), (200, 4160), (64, 64), (130560, 4096),
                     *((N, K) for _, N, K in LLAMA_K7)):
            for n_sm in (0, 132):
                _build.check(lib.desta_qmm_plan(M, N, K, n_sm, out), "plan")
                want = plan_qmm(M, N, K, n_sm or sms)
                assert tuple(out) == (want.nx, want.splits, want.tps,
                                      want.nkt, want.tiles)
    if sms == 132:
        one = (ctypes.c_int * 1)()
        for nx in (64, 128):
            for s in range(1, 9):
                _build.check(lib.desta_qmm_max_clusters(nx, s, one), "occ")
                assert one[0] * s == cluster_ctas(s, sms)


@pytest.mark.parametrize("M", [128, 130, 257])
def test_w8a8_llm_kernel(gen, M):
    N, K = 384, 256
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    x[3] = 0                              # the 1e-8 scale floor
    leaf = quantize_weight(torch.randn(N, K, generator=gen, device="cuda"))
    _build.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        got = w8a8_matmul(x, leaf["q"], leaf["s"], dt)
        want = w8a8_matmul_plain(x, leaf["q"], leaf["s"], dt)
        assert got.dtype == dt and got.shape == (M, N)
        assert _rel(got, want) < TOL_QMM
    # row quantisation + GEMM for each call
    assert _build.launch_counts() == {"w8a8_matmul": 4}


def _tower(gen, cfg, int8):
    params = tllm.init_llm(cfg, torch.bfloat16, "cuda", gen)
    return quantize_llm_params(params) if int8 else params


@pytest.mark.parametrize("B,qk_norm,heads", [
    (1, False, (4, 4)), (3, True, (4, 1)), (5, True, (8, 2)),
])
def test_fused_decode_int8_kernel(gen, B, qk_norm, heads):
    H, Hkv = heads
    cfg = dataclasses.replace(
        llm_config_for("test/llama-nano128"), num_attention_heads=H,
        num_key_value_heads=Hkv, qk_norm=qk_norm)
    params = _tower(gen, cfg, int8=True)
    S = 256
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.randint(1, S, (B,), generator=gen, device="cuda")
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, 1), generator=gen, device="cuda"))
    ck = KVCache(cache0.k.clone(), cache0.v.clone())
    cp = KVCache(cache0.k.clone(), cache0.v.clone())
    _build.reset_launch_counts()
    hk, _ = fused_decode_layers(params, cfg, x, mask, ci[:, None], ck, ci)
    assert _build.launch_counts() == {
        "fused_decode_layers_int8": 7 * cfg.num_hidden_layers}
    hp, _ = fused_decode_layers_plain(params, cfg, x, mask, ci[:, None], cp,
                                      ci)
    assert _rel(hk, hp) < 3e-2
    rows = (slice(None), torch.arange(B, device="cuda"), ci)
    assert _rel(ck.k[rows], cp.k[rows]) < 3e-2
    changed = (ck.k != cache0.k).any(-1)
    expect = torch.zeros_like(changed)
    expect[rows] = True
    assert torch.equal(changed, expect)


@pytest.mark.parametrize("kd,B,int8", [
    (2, 1, True), (4, 3, True), (8, 3, False), (8, 1, True), (4, 1, False),
])
def test_fused_verify_kernel(gen, kd, B, int8):
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              qk_norm=True)
    params = _tower(gen, cfg, int8)
    S = 128
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.full((B,), S - kd, device="cuda")   # the block ends at S
    if B > 1:
        ci[0] = S // 3
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, kd), generator=gen, device="cuda"))
    pos = ci[:, None] + torch.arange(kd, device="cuda")[None, :]
    ck = KVCache(cache0.k.clone(), cache0.v.clone())
    cp = KVCache(cache0.k.clone(), cache0.v.clone())
    _build.reset_launch_counts()
    hk, _ = fused_verify_layers(params, cfg, x, mask, pos, ck, ci)
    assert _build.launch_counts() == {
        "fused_verify_layers": 7 * cfg.num_hidden_layers}
    hp, _ = fused_decode_layers_plain(params, cfg, x, mask, pos, cp, ci)
    assert hk.shape == (B, kd, cfg.hidden_size)
    assert _rel(hk, hp) < 3e-2
    changed = (ck.k != cache0.k).any(-1)
    expect = torch.zeros_like(changed)
    for b in range(B):
        new = slice(int(ci[b]), int(ci[b]) + kd)
        expect[:, b, new] = True
        assert _rel(ck.k[:, b, new], cp.k[:, b, new]) < 3e-2
        assert _rel(ck.v[:, b, new], cp.v[:, b, new]) < 3e-2
    assert torch.equal(changed, expect)
    # token 0 of the verify step is the decode step on the same cache
    c1 = KVCache(cache0.k.clone(), cache0.v.clone())
    h1, _ = fused_decode_layers(params, cfg, x[:, :1], mask, pos[:, :1], c1,
                                ci)
    assert _rel(hk[:, :1], h1) < 3e-2


def test_llm_wrappers_raise_on_what_they_do_not_take(gen):
    leaf = quantize_weight(torch.randn(256, 96, device="cuda"))
    x = torch.randn(4, 96, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="K % 64"):
        qmm(x, leaf["q"], leaf["s"], torch.float32)        # K = 96
    leaf = quantize_weight(torch.randn(200, 128, device="cuda"))
    with pytest.raises(ValueError, match="bfloat16"):
        qmm(torch.randn(4, 128, device="cuda"), leaf["q"], leaf["s"],
            torch.float32)                                  # f32 x
    with pytest.raises(ValueError, match="M < 128"):
        qmm(torch.randn(130, 128, device="cuda").bfloat16(), leaf["q"],
            leaf["s"], torch.float32)
    with pytest.raises(ValueError, match="N % 128"):
        w8a8_matmul(torch.randn(130, 128, device="cuda").bfloat16(),
                    leaf["q"], leaf["s"], torch.float32)    # N = 200
    cfg = llm_config_for("test/llama-nano128")
    params = _tower(gen, cfg, int8=True)
    cache = tllm.init_kv_cache(cfg, 1, 128, torch.bfloat16, "cuda")
    x = torch.zeros(1, 9, cfg.hidden_size, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="tokens per row"):
        fused_verify_layers(params, cfg, x, torch.ones(1, 128, device="cuda"),
                            torch.zeros(1, 9, device="cuda").long(), cache, 0)
    # the attention's shared memory holds one key range's scores (of 8
    # ranges here): 262144 keys need more than 227 KB a range
    big = tllm.init_kv_cache(cfg, 1, 262144, torch.bfloat16, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fused_decode_layers(params, cfg, x[:, :1],
                            torch.ones(1, 262144, device="cuda"),
                            torch.zeros(1, 1, device="cuda").long(), big, 0)


def _attn_inputs(gen, B, S, H, Hkv, kd, ci, qk_norm=False, Dh=128):
    """The standalone decode attention's inputs: random bf16 qkv rows and
    cache, RoPE tables of random angles, a mask with holes, ci [B]."""
    R = B * kd
    qkv = torch.randn(R, (H + 2 * Hkv) * Dh, generator=gen,
                      device="cuda").bfloat16()
    kc, vc = torch.randn(2, B, S, Hkv * Dh, generator=gen,
                         device="cuda").bfloat16()
    ang = 6.2832 * torch.rand(R, Dh // 2, generator=gen, device="cuda")
    cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    norms = ((1 + 0.1 * torch.randn(2, Dh, generator=gen, device="cuda"))
             .bfloat16().unbind(0) if qk_norm else (None, None))
    ci = torch.tensor(ci, dtype=torch.int32, device="cuda")
    return qkv, kc, vc, cos, sin, mask, ci, *norms


# the decode attention alone (csrc/decode_attention.cuh: keys split across a
# cluster, TMA tiles) against its plain version within the decode steps'
# 3e-2: a row with ci = 0 (its draft block alone), the draft block ending at
# S, ci at S (nothing written), ranges wholly past ci (a long cache), one
# range (B = 33: the clusters fill the card), G = 1 and 8, qk-norm, Kd = 8,
# a range ragged at S, the serving engine's verify step at 16 slots (one
# range of 384 keys at Kd = 4: 48,544 bytes of shared memory, past the
# launch's default limit); the written rows within 3e-2, no other row
# changed, and two launches bit for bit
@pytest.mark.parametrize("B,S,H,Hkv,kd,ci,qk_norm", [
    (2, 256, 32, 8, 1, (0, 200), False),
    (16, 384, 32, 8, 4, tuple((64 + 16 * i) % 256 for i in range(16)),
     False),
    (2, 256, 32, 8, 4, (0, 252), False),
    (2, 256, 8, 8, 1, (256, 17), True),
    (2, 4096, 32, 8, 1, (40, 300), False),
    (33, 96, 16, 4, 1, tuple(range(1, 100, 3)), False),
    (1, 300, 64, 8, 8, (292,), True),
    (3, 1000, 16, 2, 2, (999 - 1, 500, 31), False),
])
def test_decode_attention_kernel(gen, B, S, H, Hkv, kd, ci, qk_norm):
    from desta25_audio_tpu_torch.ops.fused_decode import (
        decode_attention, decode_attention_plain)
    qkv, kc, vc, cos, sin, mask, ci_t, qn, kn = _attn_inputs(
        gen, B, S, H, Hkv, kd, ci, qk_norm)
    args = (cos, sin, mask, ci_t, qn, kn, H, Hkv, 1e-6, 128 ** -0.5)
    ck, cp = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
    _build.reset_launch_counts()
    got = decode_attention(qkv, *ck, *args)
    again = decode_attention(qkv, kc.clone(), vc.clone(), *args)
    assert _build.launch_counts() == {"decode_attention": 2}
    want = decode_attention_plain(qkv, *cp, *args)
    assert got.shape == (B * kd, H * 128) and got.dtype == torch.bfloat16
    assert _rel(got, want) < 3e-2
    assert torch.equal(got, again)
    expect = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    for b in range(B):
        expect[b, ci[b]:min(ci[b] + kd, S)] = True
    for k, p, c0 in zip(ck, cp, (kc, vc)):
        assert torch.equal((k != c0).any(-1), expect)
        if bool(expect.any()):
            assert _rel(k[expect], p[expect]) < 3e-2


def test_decode_attention_raises_on_what_it_does_not_take(gen):
    from desta25_audio_tpu_torch.ops.fused_decode import (
        decode_attention, decode_attention_plain)
    qkv, kc, vc, cos, sin, mask, ci, qn, kn = _attn_inputs(
        gen, 2, 64, 4, 2, 1, (10, 20))
    args = (cos, sin, mask, ci, qn, kn, 4, 2, 1e-6, 128 ** -0.5)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(qkv, kc, vc, cos, sin, mask.float(), ci, qn, kn, 4,
                         2, 1e-6, 128 ** -0.5)
    with pytest.raises(ValueError, match="qkv"):
        decode_attention(qkv[:, :-8], kc, vc, *args)
    # head dim 64: the entry point refuses it with an error status
    q64, k64, v64, c64, s64, m64, ci64, _, _ = _attn_inputs(
        gen, 2, 64, 4, 2, 1, (10, 20), Dh=64)
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_attention(q64, k64, v64, c64, s64, m64, ci64, None, None, 4, 2,
                         1e-6, 0.125)
    # a cache whose key range overflows shared memory: refused too
    big = torch.zeros(2, 1, 262144, 256, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_attention(qkv[:1], big[0], big[1], cos[:1], sin[:1],
                         torch.ones(1, 262144, dtype=torch.int32,
                                    device="cuda"), ci[:1], qn, kn, 4, 2,
                         1e-6, 128 ** -0.5)
    # the refusals leave no error behind for the next, good, launch
    got = decode_attention(qkv, kc.clone(), vc.clone(), *args)
    torch.cuda.synchronize()
    assert _rel(got, decode_attention_plain(qkv, kc.clone(), vc.clone(),
                                            *args)) < 3e-2


def _inject_spec(gen, cfg, B, ta, on, int8=True):
    """A random cross-attention stack (gate2 weight non-zero, so the gate
    path shows) and audio K/V [L, B, ta, D] for the in-kernel injection."""
    stack = init_orca_cross_attns(
        types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
        torch.bfloat16, "cuda", gen)
    stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
    if int8:
        stack = quantize_orca_cross_attns(stack)
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    kv = torch.randn(2, L, B, ta, D, generator=gen, device="cuda").bfloat16()
    return dict(params=stack, k=kv[0], v=kv[1], ta_real=ta,
                heads=cfg.num_attention_heads,
                on=torch.tensor(on, dtype=torch.float32, device="cuda"))


# K8i against its plain version at the TPU kernel's rounding points, within
# the decode steps' 3e-2: head dim 128 (Llama-shaped) and 80 (Qwen3-4B's
# D / H), Ta = 37 (not a multiple of 8) and 375 (ORCA's), 1, 2 or 4 batch
# rows (1, 3 or 5 key ranges a head), 1, 4 or 8 tokens a row, one row that
# does not inject
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("ta", [37, 375])
@pytest.mark.parametrize("kd", [1, 4, 8])
@pytest.mark.parametrize("D,H", [(512, 4), (640, 8)])
def test_fused_inject_kernel(gen, kd, D, H, ta, B):
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              hidden_size=D, num_attention_heads=H,
                              num_key_value_heads=2, qk_norm=True)
    params = _tower(gen, cfg, int8=True)
    S = 128
    on = [1.0, 0.0, 1.0, 1.0][:B]
    spec = _inject_spec(gen, cfg, B, ta, on)
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.tensor([40, S - kd, 7, 100][:B], device="cuda")
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, kd), generator=gen, device="cuda"))
    pos = ci[:, None] + torch.arange(kd, device="cuda")[None, :]
    fn = fused_decode_layers if kd == 1 else fused_verify_layers
    tower = "fused_decode_layers_int8" if kd == 1 else "fused_verify_layers"
    fresh = lambda: KVCache(cache0.k.clone(), cache0.v.clone())  # noqa
    _build.reset_launch_counts()
    hk, ck = fn(params, cfg, x, mask, pos, fresh(), ci, inject=spec)
    L = cfg.num_hidden_layers
    assert _build.launch_counts() == {tower: 7 * L,
                                      "fused_decode_inject": 5 * L}
    kc = _build.kernel_counts()
    assert kc["inject_attention"] == kc["inject_gate"] == L
    hp, cp = fused_decode_layers_plain(params, cfg, x, mask, pos, fresh(),
                                       ci, inject=spec)
    assert _rel(hk, hp) < 3e-2
    # every cache element outside positions ci .. ci + kd - 1 of each row
    # keeps its old bits in both versions; the written ones agree with the
    # plain version's within the step's tolerance
    w = torch.zeros(B, S, dtype=torch.bool, device="cuda")
    for b in range(B):
        w[b, int(ci[b]):int(ci[b]) + kd] = True
    for c in (ck, cp):
        assert torch.equal(c.k[:, ~w], cache0.k[:, ~w])
        assert torch.equal(c.v[:, ~w], cache0.v[:, ~w])
    assert _rel(ck.k[:, w], cp.k[:, w]) < 3e-2
    assert _rel(ck.v[:, w], cp.v[:, w]) < 3e-2
    # two launches give the same bits
    assert torch.equal(fn(params, cfg, x, mask, pos, fresh(), ci,
                          inject=spec)[0], hk)
    if B > 1:
        # the row with on = 0 is the injection-free step, bit for bit
        h0, _ = fn(params, cfg, x, mask, pos, fresh(), ci)
        assert torch.equal(hk[1], h0[1])
        assert not torch.equal(hk[0], h0[0])


@pytest.mark.parametrize("kd", [4, 8])
@pytest.mark.parametrize("B", [1, 2])
def test_fused_verify_inject_token0_is_the_decode_step(gen, kd, B):
    """The verify step's token 0 with injection is the K8i decode step's
    bit for bit: both attentions take a plan that does not read Kd, and
    the GEMMs and norms work row by row."""
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              hidden_size=512, num_attention_heads=4,
                              num_key_value_heads=2, qk_norm=True)
    params = _tower(gen, cfg, int8=True)
    S = 128
    spec = _inject_spec(gen, cfg, B, 375, [1.0] * B)
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.tensor([40, 100][:B], device="cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, kd), generator=gen, device="cuda"))
    pos = ci[:, None] + torch.arange(kd, device="cuda")[None, :]
    hv, _ = fused_verify_layers(params, cfg, x, mask, pos,
                                KVCache(cache0.k.clone(), cache0.v.clone()),
                                ci, inject=spec)
    hd, _ = fused_decode_layers(params, cfg, x[:, :1], mask, pos[:, :1],
                                KVCache(cache0.k.clone(), cache0.v.clone()),
                                ci, inject=spec)
    assert torch.equal(hv[:, :1], hd)


def _inject_attention_inputs(gen, B, kd, Ta, D):
    iq = (torch.randn(B * kd, D, generator=gen, device="cuda")
          * 2).bfloat16()
    kv = torch.randn(2, B, Ta, D, generator=gen, device="cuda").bfloat16()
    return iq, kv[0], kv[1]


# The attention alone against inject_attention_plain.  Its bf16 outputs are
# f32 sums over at most 375 keys of P rounded to bf16; the kernel folds the
# ranges' (max, sum) pairs, so a P may round one bf16 ulp apart: within
# 1e-2 of the output scale.  Head dims 128, 80 (TMA), 20 (8-byte cp.async),
# 256 (two 4-dim chunks a lane); a range past the shared-memory budget
# (B=4, Ta=3000: keys read from global memory); ta_real below Ta.
@pytest.mark.parametrize("B,kd,Ta,ta_real,D,H", [
    (2, 1, 375, 375, 4096, 32), (1, 1, 375, 375, 4096, 32),
    (2, 4, 375, 375, 4096, 32), (4, 8, 375, 375, 4096, 32),
    (2, 1, 375, 375, 2560, 32), (1, 8, 37, 37, 2560, 32),
    (2, 1, 40, 37, 640, 32), (3, 4, 100, 61, 640, 32),
    (2, 1, 375, 375, 4096, 16), (1, 8, 200, 199, 4096, 16),
    (4, 1, 3000, 3000, 4096, 32), (2, 4, 5, 5, 512, 4),
])
def test_inject_attention_kernel(gen, B, kd, Ta, ta_real, D, H):
    iq, ka, va = _inject_attention_inputs(gen, B, kd, Ta, D)
    _build.reset_launch_counts()
    got = inject_attention(iq, ka, va, ta_real, H)
    assert _build.launch_counts() == {"inject_attention": 1}
    want = inject_attention_plain(iq, ka[:, :ta_real], va[:, :ta_real], H,
                                  kd)
    assert _rel(got, want) < 1e-2
    assert torch.equal(inject_attention(iq, ka, va, ta_real, H), got)
    if kd > 1:   # token 0 of each row: the decode step's bits
        one = inject_attention(iq.reshape(B, kd, D)[:, 0].contiguous(), ka,
                               va, ta_real, H)
        assert torch.equal(got.reshape(B, kd, D)[:, 0], one)


@pytest.mark.parametrize("B,kd,ta,D,H", [
    (2, 1, 375, 4096, 32), (1, 4, 375, 4096, 32), (4, 8, 375, 2560, 32),
    (2, 1, 37, 640, 32), (4, 1, 3000, 4096, 32), (1, 1, 5, 512, 4),
    (16, 1, 375, 4096, 32)])
def test_inject_attention_plan(gen, B, kd, ta, D, H):
    """The C side's plan is plan_inject_splits at the card's SM count, its
    shared memory inject_attention_smem."""
    out = torch.zeros(4, dtype=torch.int32)
    _build.check(_build.library().desta_inject_attention_plan(
        B, kd, ta, D, H, out.data_ptr()), "plan")
    bounds = plan_inject_splits(B, H, ta, D // H,
                                _build.sm_count(torch.device("cuda")))
    ns, keys, smem, resident = out.tolist()
    tile = 8   # a range's keys in whole tiles (one range: Ta rounded up)
    assert (ns, keys) == (len(bounds) - 1,
                          -(-(bounds[1] - bounds[0]) // tile) * tile)
    assert smem == inject_attention_smem(kd, D // H, keys, bool(resident))


def _gate_inputs(gen, R, D):
    Dg = D // 4
    f = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa
    return (f(R, D).bfloat16(), (f(R, Dg) * 0.5).bfloat16(),
            (f(R, D) * 3 + 1).bfloat16(), f(Dg) * 0.2, f(1) * 0.1,
            1 + 0.1 * f(D), 0.1 * f(D))


# The gate alone against inject_gate_plain, on the term it adds to h: its
# LayerNorm statistics are f32 sums in another order than torch's, so a
# bf16 rounding of the gated term may flip: within 1e-2 of that term's
# scale.  The row with on = 0 keeps h's bits.
@pytest.mark.parametrize("R,kd,D", [(2, 1, 4096), (8, 4, 4096), (1, 1, 2560),
                                    (16, 8, 2560), (3, 1, 640),
                                    (2, 1, 32768)])
def test_inject_gate_kernel(gen, R, kd, D):
    h, ig, iao, wg2, bg2, lns, lnb = _gate_inputs(gen, R, D)
    on = torch.ones(R // kd, device="cuda")
    off = R // kd > 1    # a batch row that does not inject, where one is left
    if off:
        on[0] = 0.0
    _build.reset_launch_counts()
    got = inject_gate(h, ig, iao, wg2, bg2, lns, lnb, on, kd)
    assert _build.launch_counts() == {"inject_gate": 1}
    want = inject_gate_plain(h, ig, iao, wg2, bg2, lns, lnb, on, kd)
    assert _rel(got.float() - h.float(), want.float() - h.float()) < 1e-2
    if off:
        assert torch.equal(got[:kd], h[:kd])
    assert torch.equal(inject_gate(h, ig, iao, wg2, bg2, lns, lnb, on, kd),
                       got)


def test_fused_inject_raises_on_what_it_does_not_take(gen):
    cfg = llm_config_for("test/llama-nano128")
    params = _tower(gen, cfg, int8=True)
    cache = tllm.init_kv_cache(cfg, 1, 128, torch.bfloat16, "cuda")
    x = torch.zeros(1, 1, cfg.hidden_size, device="cuda").bfloat16()
    args = (cfg, x, torch.ones(1, 128, device="cuda"),
            torch.zeros(1, 1, device="cuda").long(), cache, 0)
    spec = _inject_spec(gen, cfg, 1, 16, [1.0])
    with pytest.raises(ValueError, match="int8 tower"):
        fused_decode_layers(_tower(gen, cfg, int8=False), *args, inject=spec)
    with pytest.raises(ValueError, match="int8 leaf"):
        fused_decode_layers(params, *args,
                            inject=_inject_spec(gen, cfg, 1, 16, [1.0],
                                                int8=False))
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_decode_layers(params, *args, inject={**spec, "heads": 256})
    with pytest.raises(ValueError, match="shared memory"):
        big = _inject_spec(gen, cfg, 1, 60000, [1.0])
        fused_decode_layers(params, *args, inject=big)
    # the longest audio the limits take runs (its key ranges read from
    # global memory) and matches the plain step
    ta = 60000
    while fused_inject_limits(spec["params"], cfg, cfg.num_attention_heads,
                              ta):
        ta -= 8
    edge = _inject_spec(gen, cfg, 1, ta, [1.0])
    x = tllm.embed_tokens(params, torch.tensor([[3]], device="cuda"))
    args = (cfg, x, torch.ones(1, 128, device="cuda"),
            torch.zeros(1, 1, device="cuda").long())
    hk, _ = fused_decode_layers(params, *args, tllm.init_kv_cache(
        cfg, 1, 128, torch.bfloat16, "cuda"), 0, inject=edge)
    hp, _ = fused_decode_layers_plain(params, *args, tllm.init_kv_cache(
        cfg, 1, 128, torch.bfloat16, "cuda"), 0, inject=edge)
    assert _rel(hk, hp) < 3e-2


# -- K11: flash attention forward and backward ---------------------------------

@pytest.mark.parametrize("B,T,H,Hkv,Dh,causal,pad", [
    (4, 512, 32, 8, 128, True, "right"),    # the training shape
    (4, 520, 32, 8, 128, True, "left"),     # T not a multiple of the tile
    (2, 77, 4, 4, 64, False, "left"),       # MHA, bidirectional, one tile
    (1, 200, 6, 2, 128, True, "none"),
    # the tiles' edges (64 and 128 rows), GQA groups of 1 and 4, both head
    # dims, both masks; row 0 all padding, row 1 left-padded
    *((2, T, 2 * G, 2, Dh, causal, "full")
      for T in (64, 127, 128, 300, 520) for G in (1, 4) for Dh in (64, 128)
      for causal in (True, False)),
])
def test_flash_attention_kernel(gen, B, T, H, Hkv, Dh, causal, pad):
    from desta25_audio_tpu_torch.ops.attention import (
        flash_attention, flash_attention_plain)
    mk = lambda h, s=1.0: (s * torch.randn(  # noqa: E731
        B, T, h, Dh, generator=gen, device="cuda")).bfloat16()
    q, k, v, do = mk(H, 2.0), mk(Hkv), mk(Hkv), mk(H)
    seg = torch.ones(B, T, dtype=torch.int32, device="cuda")
    if pad == "right":
        seg[-1, T - 112:] = 0
    elif pad == "left":
        seg[0, :37] = 0
    elif pad == "full":
        seg[0] = 0
        seg[1, :T // 3] = 0

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves, seg, causal, Dh ** -0.5)
        return (o.detach(), *torch.autograd.grad(o, leaves, do))

    _build.reset_launch_counts()
    got = run(flash_attention)
    assert _build.launch_counts() == {"flash_attention": 1,
                                      "flash_attention_bwd": 3}
    for g, w in zip(got, run(flash_attention_plain)):
        assert _rel(g, w) < 2e-2


def test_flash_attention_backward_is_deterministic(gen):
    """No atomics: two backward runs on the same inputs give the same bits."""
    from desta25_audio_tpu_torch.ops.attention import flash_attention
    B, T, H, Hkv, Dh = 2, 520, 8, 2, 128
    mk = lambda h: torch.randn(B, T, h, Dh, generator=gen,  # noqa: E731
                               device="cuda").bfloat16()
    q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
    seg = torch.ones(B, T, dtype=torch.int32, device="cuda")
    seg[1, 400:] = 0
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, seg, True, Dh ** -0.5)
    one = torch.autograd.grad(o, leaves, do, retain_graph=True)
    two = torch.autograd.grad(o, leaves, do)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_flash_attention_raises_on_what_it_does_not_take(gen):
    from desta25_audio_tpu_torch.ops.attention import flash_attention
    q = torch.zeros(1, 64, 4, 80, device="cuda").bfloat16()
    seg = torch.ones(1, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="Dh in"):
        flash_attention(q, q, q, seg)
    q = torch.zeros(1, 64, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q, seg)


# -- K1: the log-mel frontend ----------------------------------------------------

# within 1e-4 after the clamp (tests/test_mel_pallas.py's bound), on noise
# plus a tone: one clip of 3000 frames, a ragged 300 (not a multiple of the
# 8-frame tile), 37 frames over three clips, the 2-frame minimum, and 37
# frames of clips 3 samples longer (rows not 16-byte aligned: no vector
# staging), each pair of launches bit-identical
@pytest.mark.parametrize("B,frames,n_mels,extra", [
    (2, 3000, 128, 0), (1, 300, 80, 0), (3, 37, 128, 0), (1, 2, 80, 0),
    (3, 37, 80, 3)])
def test_log_mel_kernel(gen, B, frames, n_mels, extra):
    from desta25_audio_tpu_torch.audio.mel import log_mel, normalize_log_spec
    from desta25_audio_tpu_torch.ops.mel import (log_mel_spec,
                                                 log_mel_spec_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    n = frames * 160 + extra
    t = torch.arange(n, device="cuda") / 16000.0
    audio = 0.3 * torch.randn(B, n, generator=gen, device="cuda")
    audio[0] += 0.5 * torch.sin(2 * torch.pi * 523.0 * t)
    _build.reset_launch_counts()
    got = log_mel(audio, n_mels)
    assert _build.launch_counts() == {"log_mel": 1}
    assert got.shape == (B, frames, n_mels)
    want = normalize_log_spec(log_mel_spec_plain(audio, n_mels))
    assert float((got - want).abs().max()) < 1e-4
    pre = log_mel_spec(audio, n_mels)
    assert _rel(pre, log_mel_spec_plain(audio, n_mels)) < 1e-4
    assert torch.equal(log_mel_spec(audio, n_mels), pre)


# a contiguous view one float into its storage (not 16-byte aligned, which
# the kernels' argument check refuses): the wrapper copies it, one launch,
# the bits of an aligned copy
@pytest.mark.parametrize("B,frames,n_mels", [(2, 300, 128), (1, 37, 80)])
def test_log_mel_kernel_misaligned_rows(gen, B, frames, n_mels):
    from desta25_audio_tpu_torch.ops.mel import (log_mel_spec,
                                                 log_mel_spec_plain)
    n = frames * 160
    flat = 0.3 * torch.randn(B * n + 1, generator=gen, device="cuda")
    audio = flat[1:].view(B, n)
    assert audio.is_contiguous() and audio.data_ptr() % 16 == 4
    _build.reset_launch_counts()
    got = log_mel_spec(audio, n_mels)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"log_mel": 1}
    want = log_mel_spec_plain(audio, n_mels)
    assert _rel(got, want) < 1e-4
    assert torch.equal(got, log_mel_spec(audio.clone(), n_mels))


def test_log_mel_raises_on_what_it_does_not_take(gen):
    from desta25_audio_tpu_torch.ops.mel import log_mel_spec
    with pytest.raises(ValueError, match="mels"):
        log_mel_spec(torch.zeros(1, 1600, device="cuda"), 129)
    with pytest.raises(ValueError, match="samples"):
        log_mel_spec(torch.zeros(1, 160, device="cuda"), 80)


# -- K9: the per-layer decode pair ------------------------------------------------

def _k9_inputs(gen, cfg, B, S=256):
    from desta25_audio_tpu_torch.ops.fused_decode_tp import (
        decode_step_inputs)
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.randint(1, S, (B,), generator=gen, device="cuda")
    ci[0] = S - 1
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.2).int()
    step = decode_step_inputs(cfg, mask, ci[:, None], ci, B)
    h = torch.randn(B, cfg.hidden_size, generator=gen, device="cuda")
    return cache0, ci, mask, step, h


# each half against its plain version within the decode steps' 3e-2: one
# row, three, and 17 (two passes of the fused-norm GEMV), grouped-query
# ratios 2, 8 and 4, qk-norm, and a p = 2 shard's shapes
@pytest.mark.parametrize("B,qk_norm,heads,p", [
    (1, False, (4, 2), 1), (3, True, (8, 1), 1), (17, True, (16, 4), 1),
    (3, False, (8, 4), 2),
])
def test_fused_tp_halves_kernel(gen, B, qk_norm, heads, p):
    from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
    H, Hkv = heads
    cfg = dataclasses.replace(
        llm_config_for("test/llama-nano128"), num_attention_heads=H,
        num_key_value_heads=Hkv, qk_norm=qk_norm)
    params = _tower(gen, cfg, int8=True)
    cache0, ci, mask, step, h = _k9_inputs(gen, cfg, B)
    if p > 1:                                # rank 1 of p
        cache0 = ttp.shard_cache(cache0, cfg, p, 1)
        params, cfg = ttp.shard_layers(params, cfg, p, 1)
    for l in range(cfg.num_hidden_layers):
        ck = KVCache(cache0.k.clone(), cache0.v.clone())
        cp = KVCache(cache0.k.clone(), cache0.v.clone())
        _build.reset_launch_counts()
        ak = ttp.attn_half(params, cfg, h, step, ck, l)
        mk = ttp.mlp_half(params, cfg, h, l)
        assert _build.launch_counts() == {"fused_decode_tp_attn": 4,
                                          "fused_decode_tp_mlp": 3}
        assert ak.dtype == mk.dtype == torch.float32
        assert _rel(ak, ttp.attn_half_plain(params, cfg, h, step, cp, l)) \
            < 3e-2
        assert _rel(mk, ttp.mlp_half_plain(params, cfg, h, l)) < 3e-2
        rows = (l, torch.arange(B, device="cuda"), ci)
        assert _rel(ck.k[rows], cp.k[rows]) < 3e-2
        assert _rel(ck.v[rows], cp.v[rows]) < 3e-2     # bf16 of f32 sums
        changed = (ck.k != cache0.k).any(-1)
        expect = torch.zeros_like(changed)
        expect[rows] = True
        assert torch.equal(changed, expect)


def test_fused_decode_layers_perlayer_kernel(gen):
    from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              qk_norm=True)
    params = _tower(gen, cfg, int8=True)
    B = 3
    cache0, ci, mask, _, _ = _k9_inputs(gen, cfg, B)
    x = tllm.embed_tokens(params, torch.randint(
        0, 512, (B, 1), generator=gen, device="cuda"))

    def hook(l, hb):
        return hb + (0.05 * (1 + l) * torch.tanh(hb.float())).to(hb.dtype)
    ck = KVCache(cache0.k.clone(), cache0.v.clone())
    cp = KVCache(cache0.k.clone(), cache0.v.clone())
    _build.reset_launch_counts()
    hk, _ = ttp.fused_decode_layers_perlayer(params, cfg, x, mask,
                                             ci[:, None], ck, ci, hook)
    L = cfg.num_hidden_layers
    assert _build.launch_counts() == {"fused_decode_tp_attn": 4 * L,
                                      "fused_decode_tp_mlp": 3 * L}
    hp, _ = ttp.fused_decode_layers_perlayer_plain(params, cfg, x, mask,
                                                   ci[:, None], cp, ci, hook)
    assert hk.shape == (B, 1, cfg.hidden_size) and hk.dtype == torch.bfloat16
    assert _rel(hk, hp) < 3e-2
    assert torch.equal(ck.k != cache0.k, cp.k != cache0.k)


def test_fused_tp_raises_on_what_it_does_not_take(gen):
    from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
    cfg = llm_config_for("test/llama-nano128")
    params = _tower(gen, cfg, int8=True)
    cache0, ci, mask, step, h = _k9_inputs(gen, cfg, 2)
    with pytest.raises(ValueError, match="float32"):
        ttp.attn_half(params, cfg, h.bfloat16(), step, cache0, 0)
    with pytest.raises(ValueError, match="not int8"):
        ttp.mlp_half(_tower(gen, cfg, int8=False), cfg, h, 0)
    big = tllm.init_kv_cache(cfg, 2, 262144, torch.bfloat16, "cuda")
    bstep = ttp.decode_step_inputs(
        cfg, torch.ones(2, 262144, dtype=torch.int32, device="cuda"),
        ci[:, None], ci, 2)
    # the dispatch predicate refuses it; called anyway, the kernel's entry
    # point refuses it with an error status
    assert any("shared memory" in r
               for r in ttp.perlayer_limits(params, cfg, big, 2))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ttp.attn_half(params, cfg, h, bstep, big, 0)
    # the refusal leaves no error behind for the next, good, launch
    ttp.attn_half(params, cfg, h, step, cache0, 0)
    torch.cuda.synchronize()


# K9's ln1 / ln2: the step's norm kernel on f32 rows, the bits of the norm
# of the rows cast to bf16, and the plain version's within one bf16 ulp of
# the output scale (the sum of squares in another order); D of Llama-3.1-8B
# and Qwen3-4B, one to 33 rows
@pytest.mark.parametrize("R,D", [(1, 4096), (2, 4096), (17, 4096),
                                 (33, 4096), (2, 2560), (3, 32768)])
def test_rms_norm_f32_kernel(gen, R, D):
    from desta25_audio_tpu_torch.ops.fused_decode import (decode_rms_norm,
                                                           rms_plain)
    h = torch.randn(R, D, generator=gen, device="cuda") * 3
    w = (1 + 0.2 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    _build.reset_launch_counts()
    got = decode_rms_norm(h, w, 1e-5)
    assert _build.launch_counts() == {"rms_norm": 1}
    assert got.dtype == torch.bfloat16 and got.shape == (R, D)
    assert torch.equal(got, decode_rms_norm(h.bfloat16(), w, 1e-5))
    assert _rel(got, rms_plain(h.bfloat16(), w, 1e-5, torch.bfloat16)) \
        < 1e-2


# -- K10 and its all-reduce on virtual ranks of the card -------------------------

@pytest.mark.parametrize("p,B,kd", [(2, 3, 1), (4, 2, 1), (2, 2, 3)])
def test_mesh_step_kernel(gen, p, B, kd):
    """K10 against its plain version at p virtual ranks: every rank's
    residual equal bit for bit, a stream per rank equal to one stream, the
    ranks' cache slices as the plain version writes them."""
    from desta25_audio_tpu_torch.ops import fused_decode_mesh as fdm
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (
        apply_llm_sharding, gather_cache, shard_kv_cache)
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              num_key_value_heads=4)
    params = _tower(gen, cfg, int8=True)
    S = 256
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.randint(1, S - kd, (B,), generator=gen, device="cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    pos = ci[:, None] + torch.arange(kd, device="cuda")[None, :]
    x = tllm.embed_tokens(params, torch.randint(0, 512, (B, kd),
                                                generator=gen, device="cuda"))
    mesh = make_mesh(n_model=p, devices=["cuda:0"] * p)
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
        ck, cs, cp = (shard_kv_cache(cache0, cfg, mesh) for _ in range(3))
        _build.reset_launch_counts()
        hs = fdm.mesh_step_ranks(sp, cfg, x, mask, pos, ck, ci)[0]
        L = cfg.num_hidden_layers
        name = ("fused_decode_layers_mesh" if kd == 1
                else "fused_verify_layers_mesh")
        # a rank's layer: qkv, attention, wo, gate/up, down, the two
        # all-reduces (each writing the next half's norm), and layer 0's
        # own first norm
        assert _build.launch_counts() == {name: (5 * L + 1) * p,
                                          "tp_allreduce": 2 * L * p}
        step = (fdm.fused_decode_layers_mesh if kd == 1
                else fdm.fused_verify_layers_mesh)
        hser, _ = step(sp, cfg, x, mask, pos, cs, ci, serial=True)
        hp, _ = fdm.fused_decode_layers_mesh_plain(sp, cfg, x, mask, pos, cp,
                                                   ci)
    assert all(torch.equal(h, hs[0]) for h in hs[1:])
    assert torch.equal(hser, hs[0])
    assert _rel(hs[0], hp) < 3e-2
    got, want = gather_cache(ck), gather_cache(cp)
    assert torch.equal((got.k != cache0.k).any(-1),
                       (want.k != cache0.k).any(-1))
    assert _rel(got.k, want.k) < 3e-2


def test_mesh_step_kernel_data_axis(gen):
    """K10 on a (2, 2) mesh of virtual ranks, one batch row a model group
    (the second group's operands start past row 0): every group's ranks
    equal bit for bit, the rows as the plain version gives them."""
    from desta25_audio_tpu_torch.ops import fused_decode_mesh as fdm
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (
        apply_llm_sharding, gather_cache, shard_kv_cache)
    cfg = dataclasses.replace(llm_config_for("test/llama-nano128"),
                              num_key_value_heads=4)
    params = _tower(gen, cfg, int8=True)
    B, S = 2, 256
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    ci = torch.tensor([100, 200], device="cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    x = tllm.embed_tokens(params, torch.randint(0, 512, (B, 1),
                                                generator=gen, device="cuda"))
    mesh = make_mesh(n_data=2, n_model=2, devices=["cuda:0"] * 4)
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
        ck, cp = (shard_kv_cache(cache0, cfg, mesh) for _ in range(2))
        groups = fdm.mesh_step_ranks(sp, cfg, x, mask, ci[:, None], ck, ci)
        hp, _ = fdm.fused_decode_layers_mesh_plain(sp, cfg, x, mask,
                                                   ci[:, None], cp, ci)
    assert all(torch.equal(h, hs[0]) for hs in groups for h in hs[1:])
    assert _rel(torch.cat([hs[0] for hs in groups]), hp) < 3e-2
    assert _rel(gather_cache(ck).k, gather_cache(cp).k) < 3e-2


def test_tp_pair_under_mesh_kernel(gen):
    """K9's pair under a (1, 2) mesh of virtual ranks against its plain
    version: the halves' partials all-reduced into the f32 residual."""
    from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (
        apply_llm_sharding, shard_kv_cache)
    cfg = llm_config_for("test/llama-nano128")
    params = _tower(gen, cfg, int8=True)
    B, S = 3, 256
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    ci = torch.randint(1, S, (B,), generator=gen, device="cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    x = tllm.embed_tokens(params, torch.randint(0, 512, (B, 1),
                                                generator=gen, device="cuda"))
    mesh = make_mesh(n_model=2, devices=["cuda:0"] * 2)
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
        ck, cp = (shard_kv_cache(cache0, cfg, mesh) for _ in range(2))
        assert ttp.fused_tp_supported(sp, cfg, ck)
        _build.reset_launch_counts()
        hk, _ = ttp.fused_decode_layers_tp(sp, cfg, x, mask, ci[:, None], ck,
                                           ci)
        L = cfg.num_hidden_layers
        assert _build.launch_counts() == {
            "fused_decode_tp_attn": 4 * L * 2, "fused_decode_tp_mlp": 3 * L * 2,
            "tp_allreduce": 2 * L * 2}
        hp, _ = ttp.fused_decode_layers_tp_plain(sp, cfg, x, mask,
                                                 ci[:, None], cp, ci)
    assert _rel(hk, hp) < 3e-2


def test_tp_allreduce_times_out(gen):
    """A round whose producers never run: the bounded spin gives up, the
    residual is left as it was, and the wrapper raises."""
    from desta25_audio_tpu_torch.ops.tp_allreduce import MeshBuffers
    bufs = MeshBuffers([torch.device("cuda", 0)] * 2, 2, 256)
    h = torch.randn(2, 256, generator=gen, device="cuda").bfloat16()
    h0 = h.clone()
    stream = torch.cuda.current_stream().cuda_stream
    bufs.begin(1)
    bufs.reduce(0, 0, 1, h, stream)
    with pytest.raises(RuntimeError, match="timed out"):
        bufs.check_timeouts("tp_allreduce")
    assert torch.equal(h, h0)
    assert int(bufs.err[0].item()) == 0           # cleared for the next step


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("R", [2, 8, 19])
@pytest.mark.parametrize("f32", [False, True])
def test_tp_allreduce_fused_norm(gen, p, R, f32):
    """The consumer at p virtual ranks: every rank's residual bit-identical
    to allreduce_plain's, its norm of the new residual bit-identical to
    the step's norm kernel (bf16) and within 3e-2 of rms_plain; R = 19 takes
    two rows a block past the grid's 16; a set error word skips the wait
    (a second round whose producers never run returns at once)."""
    import time
    from desta25_audio_tpu_torch.ops.fused_decode import (decode_rms_norm,
                                                          rms_plain)
    from desta25_audio_tpu_torch.ops.tp_allreduce import (
        MeshBuffers, allreduce_rmsnorm_plain)
    from desta25_audio_tpu_torch.ops.quant import quantize_weight
    D, K = 4096, 4096 // p
    bufs = MeshBuffers([torch.device("cuda", 0)] * p, R, D)
    stream = torch.cuda.current_stream().cuda_stream
    dt = torch.float32 if f32 else torch.bfloat16
    h0 = (torch.randn(R, D, generator=gen, device="cuda") * 3).to(dt)
    hs = [h0.clone() for _ in range(p)]
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    xns = [torch.empty(R, D, dtype=torch.bfloat16, device="cuda")
           for _ in range(p)]
    base = bufs.begin(1)
    for m in range(p):
        leaf = quantize_weight(torch.randn(D, K, generator=gen,
                                           device="cuda") / K ** 0.5)
        x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
        bufs.store(m, 1, 1, x, leaf["q"], leaf["s"], "peer", stream)
    for m in range(p):
        bufs.reduce(m, 1, 1, hs[m], stream, w, xns[m], 1e-5)
    bufs.check_timeouts("tp_allreduce")
    assert bufs.flags[0][1].tolist() == [base + 1] * p
    (want,), (want_xn,) = allreduce_rmsnorm_plain(list(bufs.rbuf[0][1]),
                                                  [h0], w, 1e-5)
    for m in range(p):
        assert torch.equal(hs[m], want)
        assert torch.equal(xns[m], xns[0])
        assert _rel(xns[m], want_xn) < 3e-2
    if not f32:
        assert torch.equal(xns[0], decode_rms_norm(want, w, 1e-5))
    assert torch.equal(want_xn, rms_plain(want, w, 1e-5, torch.bfloat16))
    bufs.err[0].fill_(1)                       # a round already lost
    bufs.begin(1)
    t0 = time.perf_counter()
    bufs.reduce(0, 0, 1, hs[0], stream, w, xns[0], 1e-5)
    with pytest.raises(RuntimeError, match="timed out"):
        bufs.check_timeouts("tp_allreduce")
    assert time.perf_counter() - t0 < 1.0
    assert torch.equal(hs[0], want)


# The skinny weight-streaming GEMM (csrc/skinny_gemm.cuh) alone, against
# skinny_gemm_plain: f32 outputs within TOL_QMM (the sums differ in order
# only), bf16 outputs within 3e-2, the decode step's gate (one rounding of
# an f32 sum that differs in order)
SKINNY_RS = (1, 2, 3, 8, 16, 17)


def _skinny_operands(gen, R, N, K, epi, int8):
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    nw = 2 if epi == sg.EPI_SWIGLU else 1
    x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
    wf = torch.randn(N * nw, K, generator=gen, device="cuda") / K ** 0.5
    if int8:
        leaf = quantize_weight(wf)
        w, scale = leaf["q"], leaf["s"]
    else:
        w, scale = wf.bfloat16(), None
    bias = (torch.randn(N, generator=gen, device="cuda")
            if epi in (sg.EPI_BIAS, sg.EPI_BIAS_GELU) else None)
    out = None
    if epi == sg.EPI_RESID:
        out = torch.randn(R, N, generator=gen, device="cuda").bfloat16()
    elif epi == sg.EPI_ADD_F32:
        out = torch.randn(R, N, generator=gen, device="cuda")
    return x, w, scale, bias, out


def _skinny_check(x, w, scale, epi, out, bias):
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    want = sg.skinny_gemm_plain(x, w, scale, epi, out, bias)
    got = sg.skinny_gemm(x, w, scale, epi,
                         None if out is None else out.clone(), bias)
    tol = TOL_QMM if epi in sg.F32_OUT else 3e-2
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) < tol


@pytest.mark.parametrize("R", SKINNY_RS)
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("epi", range(7))
def test_skinny_gemm_kernel(gen, epi, int8, R):
    """Every epilogue and both weight types at a ragged N (200 outputs: a
    partial last tile of 64 rows) and a K that is not a whole number of
    128-byte k-tiles, at 1..17 rows (17: two passes)."""
    K = 1072 if int8 else 1064
    x, w, scale, bias, out = _skinny_operands(gen, R, 200, K, epi, int8)
    _skinny_check(x, w, scale, epi, out, bias)


@pytest.mark.parametrize("N,K", [
    (1024, 4096), (4096, 1024), (4096, 3584),  # K9's p = 4 shards
    (6144, 2560), (2560, 9728), (9728, 2560),  # Qwen3-4B qkv, down, gate/up
    (4096, 14336), (130560, 4096),             # Llama-3.1-8B down, K7 head
    (8, 16)])                                  # one partial tile, one k-tile
@pytest.mark.parametrize("R", [2, 8])
@pytest.mark.parametrize("int8", [True, False])
def test_skinny_gemm_shapes(gen, N, K, R, int8):
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    if not int8 and K % 8:
        pytest.skip("bf16 rows need K % 8 == 0")
    for epi in (sg.EPI_STORE, sg.EPI_RESID) + (
            (sg.EPI_SWIGLU,) if N == 9728 else ()):
        x, w, scale, bias, out = _skinny_operands(gen, R, N, K, epi, int8)
        _skinny_check(x, w, scale, epi, out, bias)


def test_skinny_gemm_plan_and_bits(gen):
    """The C side's plan is plan_skinny_gemm's at the card's SM count; two
    launches give the same bits; the decode step's rows (R = 2) and the
    verify step's (R = 8, token 0 of each batch row) sum alike."""
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    n_sm = _build.sm_count(torch.device("cuda"))
    for rows, K, int8 in ((6144, 4096, True), (4096, 14336, True),
                          (28672, 4096, False), (130560, 4096, True),
                          (200, 1072, True)):
        assert sg.kernel_plan(rows, K, int8) == sg.plan_skinny_gemm(
            rows, K, int8, n_sm)
    x, w, scale, _, _ = _skinny_operands(gen, 16, 4096, 14336, 0, True)
    a = sg.skinny_gemm(x, w, scale, sg.EPI_STORE_F32)
    b = sg.skinny_gemm(x, w, scale, sg.EPI_STORE_F32)
    assert torch.equal(a, b)
    for step in (4, 8):   # 8 rows (one n8 tile) and 2 rows vs 16 (two)
        sub = sg.skinny_gemm(x[0::step].contiguous(), w, scale,
                             sg.EPI_STORE_F32)
        assert torch.equal(sub, a[0::step])


@pytest.mark.parametrize("R", [2, 17])
@pytest.mark.parametrize("int8", [True, False])
def test_skinny_gemm_peer_store(gen, R, int8):
    """PEER_F32 at p = 2 virtual ranks: each rank's product lands in its
    slot of both ranks' receive buffers, the flags hold the round's epoch
    after every CTA of every pass arrived, and the arrival counter is back
    at 0 for the next round (two rounds)."""
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    from desta25_audio_tpu_torch.ops.tp_allreduce import MeshBuffers
    D, K = 4096, 1024
    bufs = MeshBuffers([torch.device("cuda", 0)] * 2, R, D)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        epoch = bufs.begin(1) + 1
        want = []
        for rank in range(2):
            x, w, scale, _, _ = _skinny_operands(gen, R, D, K, 0, int8)
            bufs.store(rank, 1, 1, x, w, scale, "peer", stream)
            want.append(sg.skinny_gemm_plain(x, w, scale, sg.EPI_STORE_F32))
        torch.cuda.synchronize()
        for d in range(2):
            for rank in range(2):
                assert _rel(bufs.rbuf[d][1, rank], want[rank]) < TOL_QMM
            assert bufs.flags[d][1].tolist() == [epoch, epoch]
            assert bufs.flags[d][0].tolist() == [0, 0]
            assert bufs.counter[d].tolist() == [0, 0]


# -- the decode step as one CUDA graph, its RMSNorm, programmatic dependent
# launch (generate/graph.py, csrc/fused_decode.cu, csrc/common.cuh) ---------

def _llama_2layers():
    return dataclasses.replace(
        llm_config_for("meta-llama/Llama-3.1-8B-Instruct"),
        num_hidden_layers=2)


def _generate_both_ways(monkeypatch, params, cfg, emb, amask, new, **kw):
    """llm_generate eagerly and through its graph, greedy: for each, the
    ids, every sampled step's logits (copied as sample_token sees them),
    the launch and kernel counts and the timings."""
    from desta25_audio_tpu_torch.generate import decode as tdecode
    real, runs = tdecode.sample_token, {}
    for graph in (False, True):
        seen = []
        monkeypatch.setattr(
            tdecode, "sample_token",
            lambda lg, *a: seen.append(lg.clone()) or real(lg, *a))
        _build.reset_launch_counts()
        timings = {}
        ids, _ = tdecode.llm_generate(
            params, cfg, emb, amask, torch.Generator("cuda").manual_seed(0),
            max_new_tokens=new, timings=timings, decode_graph=graph, **kw)
        torch.cuda.synchronize()
        runs[graph] = (ids, seen, _build.launch_counts(),
                       _build.kernel_counts(), timings)
    return runs


@pytest.mark.parametrize("kind", ["bf16", "int8", "k8i", "k9"])
def test_decode_graph_matches_eager(gen, monkeypatch, kind):
    """Two layers at Llama-3.1-8B's width, B = 2 (a row left-padded), 8 new
    tokens: the graph's ids and every step's logits bit-identical to the
    eager step's, the launch and kernel counts equal, one decode_graph
    replay for each decode step after the first; bf16 K8, K8-int8, K8i
    with an int8 ORCA stack, and K9 (the per-layer opt-in) with a bf16
    stack's injection in PyTorch between its layers."""
    cfg = _llama_2layers()
    params = _tower(gen, cfg, int8=kind != "bf16")
    B, T, NEW = 2, 24, 8
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                        device="cuda")
    amask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    amask[0, :5] = 0
    kw = {}
    if kind in ("k8i", "k9"):
        stack = init_orca_cross_attns(
            types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
            torch.bfloat16, "cuda", gen)
        stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
        if kind == "k9":
            from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
            monkeypatch.setattr(ttp, "FUSED_PERLAYER", True)
        else:
            stack = quantize_orca_cross_attns(stack)
        kw = dict(inject_params=stack,
                  inject_tokens=torch.randn(B, 40, cfg.hidden_size,
                                            generator=gen,
                                            device="cuda").bfloat16(),
                  inject_heads=cfg.num_attention_heads)
    runs = _generate_both_ways(monkeypatch, params, cfg,
                               tllm.embed_tokens(params, ids), amask, NEW,
                               **kw)
    (e_ids, e_lg, e_n, e_k, e_t), (g_ids, g_lg, g_n, g_k, g_t) = (
        runs[False], runs[True])
    assert torch.equal(g_ids, e_ids)
    assert len(g_lg) == len(e_lg) == NEW
    for a, b in zip(g_lg, e_lg):
        assert torch.equal(a, b)
    steps = g_t["decode_steps"]
    assert steps == NEW - 1 and g_t["graph_capture_ms"] > 0
    assert g_n.pop("decode_graph") == steps - 1
    assert g_n == e_n and g_k == e_k
    L = cfg.num_hidden_layers
    if kind == "k9":
        assert e_n["fused_decode_tp_attn"] == 4 * L * steps
        assert e_n["fused_decode_tp_mlp"] == 3 * L * steps
    else:
        tower = ("fused_decode_layers" if kind == "bf16"
                 else "fused_decode_layers_int8")
        assert e_n[tower] == 7 * L * steps
    assert e_k["rms_norm"] == 2 * L * steps
    if kind == "k8i":
        assert e_n["fused_decode_inject"] == 5 * cfg.num_hidden_layers * steps
        assert (e_k["inject_attention"] == e_k["inject_gate"]
                == cfg.num_hidden_layers * steps)
    assert _build.fallback_counts() == {}


def _teacher_forced(params, cfg, emb, amask, ids, **kw):
    """llm_generate's sampled logits with its ids fed back through
    ``llm_apply``, step by step (its cache length and positions): the
    prefill's last position, then one decode step for each id but the
    last.  ``kw``: llm_generate's injection arguments."""
    from desta25_audio_tpu_torch.generate.decode import build_injection
    B, T, _ = emb.shape
    new = ids.shape[1]
    S = -(-(T + new) // 128) * 128
    extra = spec = None
    if kw:
        extra, spec = build_injection(cfg, kw["inject_params"],
                                      kw["inject_tokens"], 2.5,
                                      kw["inject_heads"])
    cache = tllm.init_kv_cache(cfg, B, S, emb.dtype, emb.device)
    mask = torch.zeros(B, S, dtype=torch.int32, device=emb.device)
    mask[:, :T] = amask
    pos = torch.clamp(torch.cumsum(mask[:, :T], 1) - 1, min=0)
    lg, cache = tllm.llm_apply(params, cfg, inputs_embeds=emb,
                               attention_mask=mask, positions=pos,
                               cache=cache, cache_index=0,
                               extra_layer_fn=extra)
    out, nxt = [lg[:, -1]], pos[:, -1:] + 1
    for t in range(new - 1):
        mask[:, T + t] = 1
        lg, cache = tllm.llm_apply(params, cfg, input_ids=ids[:, t:t + 1],
                                   attention_mask=mask, positions=nxt + t,
                                   cache=cache, cache_index=T + t,
                                   extra_layer_fn=extra,
                                   fused_injection=spec)
        out.append(lg[:, -1])
    return out


# generate() under a mesh, teacher-forced logits vs the unsharded LLM's
# (chip_smoke.py's TOL_MESH_GEN): the ranks' partial sums reassociate
# every wo / down product of the prefill
TOL_MESH_GEN = 2.5e-1


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("inject", [False, True])
def test_mesh_decode_graph_matches_eager(gen, monkeypatch, shape, inject):
    """K10 under an (n_data, p) mesh of virtual ranks in generate(): the
    decode steps as replays of one CUDA graph (MeshStep, the ranks'
    streams forked and joined inside the capture; on the (2, 2) mesh two
    model groups of one batch row each in the one card's graph, their
    logits gathered after it) give the eager steps' ids and logits bit for
    bit and the same launch counts, one decode_graph launch a step after
    the first; every step's logits, teacher-forced through the unsharded
    LLM, within TOL_MESH_GEN; with an int8 ORCA stack, K8i inside every
    rank's step."""
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import apply_llm_sharding
    n_data, p = shape
    cfg = _llama_2layers()
    params = _tower(gen, cfg, int8=True)
    B, T, NEW = 2, 24, 8
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                        device="cuda")
    amask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    amask[0, :5] = 0
    kw = {}
    if inject:
        stack = init_orca_cross_attns(
            types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
            torch.bfloat16, "cuda", gen)
        stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
        kw = dict(inject_params=quantize_orca_cross_attns(stack),
                  inject_tokens=torch.randn(B, 40, cfg.hidden_size,
                                            generator=gen,
                                            device="cuda").bfloat16(),
                  inject_heads=cfg.num_attention_heads)
    emb = tllm.embed_tokens(params, ids)
    mesh = make_mesh(n_data=n_data, n_model=p,
                     devices=["cuda:0"] * (n_data * p))
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
        runs = _generate_both_ways(monkeypatch, sp, cfg, emb, amask, NEW,
                                   **kw)
    (e_ids, e_lg, e_n, e_k, e_t), (g_ids, g_lg, g_n, g_k, g_t) = (
        runs[False], runs[True])
    assert torch.equal(g_ids, e_ids)
    assert len(g_lg) == len(e_lg) == NEW
    for a, b in zip(g_lg, e_lg):
        assert torch.equal(a, b)
    ref = _teacher_forced(params, cfg, emb, amask, g_ids, **kw)
    assert max(_rel(a, b) for a, b in zip(g_lg, ref)) < TOL_MESH_GEN
    steps = g_t["decode_steps"]
    assert steps == NEW - 1 and g_t["graph_capture_ms"] > 0
    assert g_n.pop("decode_graph") == steps - 1
    assert g_n == e_n and g_k == e_k
    L, ranks = cfg.num_hidden_layers, n_data * p
    # an injection changes the residual after the MLP's all-reduce: every
    # attention then launches its own norm
    per_rank = 5 * L + 1 if not inject else 6 * L
    assert e_n["fused_decode_layers_mesh"] == per_rank * ranks * steps
    assert e_n.get("fused_decode_inject", 0) == 5 * L * ranks * steps * inject
    assert e_n["tp_allreduce"] == 2 * L * ranks * steps
    assert "fused_decode_layers_int8" not in e_n


@pytest.mark.parametrize("R,D", [
    (2, 4096), (1, 2560), (9, 4096), (3, 5120), (2, 520), (4, 8),
    (1, 32768)])
def test_rms_norm_kernel(gen, R, D):
    """The step's norm alone against rms_plain (512 threads x 8 at 4096,
    320 at Qwen3-4B's 2560, a second vector a thread at 5120, a ragged
    warp at 520), rows of scales 1 to 100, within the decode step's gate;
    two launches bit-identical."""
    from desta25_audio_tpu_torch.ops.fused_decode import (
        decode_rms_norm, rms_plain)
    scales = torch.logspace(0, 2, R, device="cuda")[:, None]
    x = (torch.randn(R, D, generator=gen, device="cuda") * scales).bfloat16()
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    _build.reset_launch_counts()
    got = decode_rms_norm(x, w, 1e-5)
    assert _build.launch_counts() == {"rms_norm": 1}
    want = rms_plain(x, w, 1e-5, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and _rel(got, want) < 3e-2
    assert torch.equal(decode_rms_norm(x, w, 1e-5), got)


def test_rms_norm_raises_on_what_it_does_not_take(gen):
    from desta25_audio_tpu_torch.ops.fused_decode import decode_rms_norm
    x = torch.randn(2, 12, generator=gen, device="cuda").bfloat16()
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_rms_norm(x, x[0], 1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_rms_norm(torch.ones(2, 16, device="cuda"),
                        torch.ones(16, device="cuda"), 1e-5)
    assert _build.launch_counts().get("rms_norm", 0) == 0


@pytest.mark.parametrize("int8", [True, False])
def test_pdl_chain_keeps_stream_order(gen, int8):
    """Norm, then the skinny GEMM adding into the residual, eight times
    back to back, each launch reading the one before's output (both take
    programmatic dependent launch): against the same chain in plain
    PyTorch within the decode step's gate, and captured in a CUDA graph and
    replayed, bit-identical to the eager chain."""
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    from desta25_audio_tpu_torch.ops.fused_decode import (
        decode_rms_norm, rms_plain)
    R, D = 2, 4096
    h0 = torch.randn(R, D, generator=gen, device="cuda").bfloat16()
    nw = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).bfloat16()
    wf = torch.randn(D, D, generator=gen, device="cuda") / D ** 0.5
    if int8:
        leaf = quantize_weight(wf)
        w, scale = leaf["q"], leaf["s"]
    else:
        w, scale = wf.bfloat16(), None

    def chain(h, norm, gemm):
        for _ in range(8):   # the kernel adds into h in place
            h = gemm(norm(h, nw, 1e-5), w, scale, sg.EPI_RESID, h)
        return h

    want = chain(h0.clone(), lambda h, nw, eps: rms_plain(
        h, nw, eps, torch.bfloat16), sg.skinny_gemm_plain)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = chain(h0.clone(), decode_rms_norm, sg.skinny_gemm)
    torch.cuda.current_stream().wait_stream(side)
    assert _rel(eager, want) < 3e-2
    hg = h0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(hg, decode_rms_norm, sg.skinny_gemm)
    assert torch.equal(hg, h0)      # captured, not run
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(hg, eager)


# -- training: ORCA and the int8 tower on the card against the CPU ----------------

# a train step's loss terms, bf16 towers on the card (K11, the card's GEMMs)
# against the CPU's plain versions: loss and lm_loss within the bound of the
# bf16 nano step against the JAX package (tests/test_torch_train.py);
# grad_norm relative
TOL_TRAIN = 2e-2
TOL_TRAIN_GNORM = 5e-2
# ORCA's f32 aux terms, relative to the CPU's value: read 6.0e-5
# (L_ortho_diversity) and 9.8e-5 (L_align_layerwise) on an H100; the
# global-local term is a mean of squared cosines near 0 (5.8e-6 here), so
# its cancellation reads 2.7e-3 and it gets its own bound
TOL_TRAIN_AUX = 1e-3
TOL_TRAIN_AUX_LOCAL = 1e-2


def _nano_train_pair(devices=("cuda", "cpu"), fault=None, **kw):
    """One train step (remat, lr 0) of a bf16 nano model on the card and of
    the same parameters on the CPU, on one batch: B=2, T=512 (K11 on the
    card), 3 transcription positions a row.  ``fault``: a context manager
    the card's step runs inside (the controls).  Returns {device:
    metrics}."""
    import numpy as np
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.train.optimizer import (
        OptimizerConfig, flatten_tree, make_optimizer)
    from desta25_audio_tpu_torch.train.step import (TrainLayout,
                                                    make_train_step)
    cfg = DeSTA25Config(**dict(dict(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano", qformer_num_hidden_layers=2,
        dtype="bfloat16"), **kw))
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    B, L, K, n = 2, 512, cfg.audio_token_size, 3
    ids = rng.integers(0, 500, size=(B, L))
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind, aidx, pos = (np.zeros((B, L), np.int64) for _ in range(3))
    kind[:, 2:2 + K] = 1
    kind[:, 2 + K:2 + K + n] = 2
    aidx[:, 2:2 + K + n] = np.arange(B)[:, None]
    pos[:, 2:2 + K] = np.arange(K)
    pos[:, 2 + K:2 + K + n] = np.arange(n)
    batch = {"input_ids": ids, "attention_mask": np.ones((B, L), np.int64),
             "labels": labels, "kind": kind, "aidx": aidx, "pos": pos,
             "audio": (0.1 * rng.standard_normal((B, 16000))).astype(
                 np.float32),
             "trans_ids": rng.integers(10, 200, size=(B, 8)),
             "trans_mask": np.ones((B, 8), np.int64)}

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.detach().to(dev).clone()

    out = {}
    for dev in devices:
        params = to(model.params, dev)
        tr = {k: params[k] for k in model.trainable_keys()}
        fr = {k: v for k, v in params.items() if k not in tr}
        leaves = flatten_tree(tr)
        for t in leaves.values():
            t.requires_grad_(True)
        tx = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10))
        step = make_train_step(model.config, tx, remat=True)
        _build.reset_launch_counts()
        with (fault or contextlib.nullcontext)() if dev == "cuda" else (
                contextlib.nullcontext()):
            _, _, m = step(tr, TrainLayout(None, fr, model.config),
                           tx.init(leaves), {
                k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[dev] = {k: float(v) for k, v in m.items()}
        if dev == "cuda":
            out["launches"] = _build.launch_counts()
            out["fallbacks"] = _build.fallback_counts()
    return out


def _aux_bound(key):
    return TOL_TRAIN_AUX_LOCAL if key == "L_ortho_qformer_local" else (
        TOL_TRAIN_AUX)


def _aux_err(got, want, key):
    return abs(got[key] - want[key]) / abs(want[key])


def _check_train_pair(out, keys):
    import math
    got, want = out["cuda"], out["cpu"]
    assert sorted(got) == sorted(want)
    for k in keys:
        assert math.isfinite(got[k]), (k, got[k])
        if k in ("loss", "lm_loss"):
            assert abs(got[k] - want[k]) <= TOL_TRAIN, (k, got[k], want[k])
        else:
            print(f"{k}: card {got[k]:.6e} cpu {want[k]:.6e} rel "
                  f"{_aux_err(got, want, k):.3e} (tol {_aux_bound(k)})")
            assert _aux_err(got, want, k) <= _aux_bound(k), (
                k, got[k], want[k])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        TOL_TRAIN_GNORM * want["grad_norm"]), (got, want)
    assert out["launches"].get("flash_attention", 0) > 0
    assert out["launches"].get("flash_attention_bwd", 0) > 0


@contextlib.contextmanager
def _qformer_head_fault():
    """The global Q-Former's attention with one head's output in the place
    of another's (a wrong head index), on the card's step only."""
    real = tqformer.mha

    def mha(*args, **kw):
        out = real(*args, **kw)
        return torch.cat([out[..., 1:2, :], out[..., 1:, :]], dim=-2)

    tqformer.mha = mha
    try:
        yield
    finally:
        tqformer.mha = real


def test_nano_orca_train_step_matches_cpu(gen):
    orca = dict(connector_mode="orca_hybrid", orca_global_num_tokens=4,
                orca_local_downsample=4, orca_local_kernel_size=5)
    aux = ("L_ortho_diversity", "L_ortho_qformer_local", "L_align_layerwise")
    out = _nano_train_pair(**orca)
    _check_train_pair(out, ("loss", "lm_loss") + aux)
    assert out["cuda"]["L_align_layerwise"] > 0
    # control: the faulty Q-Former moves loss and lm_loss by less than
    # TOL_TRAIN (read 7.3e-4 and 6.6e-5), and every aux term past its bound
    # (read 1.4e-2, 13.6 and 1.6e-2)
    bad = _nano_train_pair(devices=("cuda",), fault=_qformer_head_fault,
                           **orca)["cuda"]
    want = out["cpu"]
    assert all(abs(bad[k] - want[k]) <= TOL_TRAIN for k in ("loss",
                                                            "lm_loss"))
    for k in aux:
        print(f"control {k}: rel {_aux_err(bad, want, k):.3e}")
        assert _aux_err(bad, want, k) > _aux_bound(k), (k, bad[k], want[k])


def test_nano_int8_tower_train_step_matches_cpu(gen):
    out = _nano_train_pair(connector_mode="qformer_1", prompt_size=8,
                           llm_quant="int8")
    _check_train_pair(out, ("loss", "lm_loss"))
    # M = 1024 rows a product, 128 a CE chunk: the dequant dot, the band
    # counted; no activation quantized
    assert out["fallbacks"].get("quant_matmul_dequant", 0) > 0
    assert not out["launches"].get("w8a8_matmul", 0)


# -- Whisper ASR ----------------------------------------------------------------

TOL_ASR_CACHE = 1e-4   # f32: the cached and the full forward differ in
                       # summation order only


def _asr_cached_vs_full(gen, late: bool):
    """A 2-layer f32 decoder at whisper-large-v3's widths on a random
    encoder output [2, 1500, 1280]: the worst relative difference of the
    cached decode's logits, step by step, from the full forward over the
    prefix and the emitted ids.  ``late``: every cached call writes its keys
    one slot past their position (the control)."""
    from desta25_audio_tpu_torch.config import whisper_config_for
    from desta25_audio_tpu_torch.generate import decode as tdecode
    from desta25_audio_tpu_torch.models import whisper as tw
    cfg = dataclasses.replace(whisper_config_for("openai/whisper-large-v3"),
                              decoder_layers=2)
    dec = tw.init_whisper_decoder(cfg, torch.float32, "cuda", gen)
    enc = torch.randn(2, 1500, cfg.d_model, device="cuda", generator=gen)
    real = tw.whisper_decoder_apply

    def late_apply(*a, cache=None, cache_index=0, **k):
        return real(*a, cache=cache, cache_index=cache_index + (
            cache is not None), **k)
    steps = []
    lang = cfg.first_language_token_id
    tw.whisper_decoder_apply = late_apply if late else real
    try:
        ids, _ = tdecode.asr_decode(dec, cfg, enc, max_new_tokens=24,
                                    language_token=lang, step_logits=steps)
    finally:
        tw.whisper_decoder_apply = real
    ckv = tw.whisper_cross_kv(dec, enc, cfg)
    prefix = torch.tensor([[cfg.decoder_start_token_id, lang,
                            cfg.transcribe_token_id,
                            cfg.no_timestamps_token_id]] * 2, device="cuda")
    n = len(steps)
    full, _ = real(dec, torch.cat([prefix, ids[:, :n - 1]], 1), ckv, cfg)
    return max(_rel(steps[j], full[:, 3 + j]) for j in range(n))


def test_asr_cached_decode_matches_full_forward(gen):
    err = _asr_cached_vs_full(gen, late=False)
    control = _asr_cached_vs_full(torch.Generator("cuda").manual_seed(0),
                                  late=True)
    assert err < TOL_ASR_CACHE < control, (err, control)


@pytest.fixture(scope="module")
def asr_model(tmp_path_factory):
    """whisper-large-v3 (bf16, its kernels) with a nano LLM and two WAVs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    import numpy as np
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.audio.io import write_wav
    from desta25_audio_tpu_torch.models.desta import _CharASR
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="openai/whisper-large-v3",
                        connector_mode="qformer_1",
                        qformer_num_hidden_layers=2, prompt_size=8,
                        dtype="bfloat16")
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0)
    model._whisper_tokenizer = _CharASR()
    d = tmp_path_factory.mktemp("asr")
    paths = []
    for i, secs in enumerate((2.0, 3.5)):
        t = np.arange(int(secs * 16000)) / 16000.0
        paths.append(str(d / f"clip{i}.wav"))
        write_wav(paths[-1], (0.5 * np.sin(2 * np.pi * (300 + 140 * i) * t)
                              * (np.sin(2 * np.pi * 3 * t) > 0)
                              ).astype(np.float32))
    return model, paths


def _asr_msgs(paths, text):
    return [[{"role": "user", "content": "What is said? <|AUDIO|>",
              "audios": [{"audio": p, "text": text}]}] for p in paths]


ENC_KERNELS = ("log_mel", "packed_encoder_attention", "encoder_ffn")


def test_asr_generate_runs_the_encoder_kernels_twice(asr_model):
    import numpy as np
    from desta25_audio_tpu_torch.models import whisper as tw
    model, paths = asr_model
    counts = {}
    for text in ("a tone", None):
        model.generate(_asr_msgs(paths, text), do_sample=False,
                       max_new_tokens=2)       # warm-up
        _build.reset_launch_counts()
        model.generate(_asr_msgs(paths, text), do_sample=False,
                       max_new_tokens=4)
        counts[text] = _build.launch_counts()
    assert model.last_timings["asr_steps"] >= 1
    # one encoder pass and one mel alone, at the same batch
    _build.reset_launch_counts()
    mel = model._mel(np.zeros((2, 480000), np.float32))
    tw.whisper_encoder_apply(model.params["whisper"]["encoder"], mel,
                             model.enc_cfg)
    one = _build.launch_counts()
    for name in ENC_KERNELS:
        assert one.get(name, 0) > 0, name
        assert counts[None].get(name, 0) == counts["a tone"].get(name, 0) \
            + one[name], (name, counts, one)
    assert counts[None]["log_mel"] == 2 * counts["a tone"]["log_mel"]
    assert counts[None]["encoder_ffn"] == 2 * counts["a tone"]["encoder_ffn"]


def test_asr_feature_cache_hit_launches_no_perception_kernel(asr_model):
    model, paths = asr_model
    model.enable_audio_cache(8)
    try:
        first = model.generate(_asr_msgs(paths, None), do_sample=False,
                               max_new_tokens=4)
        _build.reset_launch_counts()
        second = model.generate(_asr_msgs(paths, None), do_sample=False,
                                max_new_tokens=4)
        counts = _build.launch_counts()
    finally:
        model.audio_cache = None
    assert not any(counts.get(k, 0) for k in ENC_KERNELS), counts
    assert "asr_steps" not in model.last_timings
    assert second.generated_ids == first.generated_ids
    assert second.audios == first.audios


# -- the serving engine's kept decode graph (serve/engine.py) ----------------

def _engine_run(model, graph: bool, engine_cls=None, pipeline=True, **kw):
    """Six requests of 4-12 new tokens through 3 slots, 3 steps a tick, two
    of them submitted mid-run: the slot set changes across ticks.  Returns
    (each request's tokens, the engine, the launch counts)."""
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    cls = engine_cls or ContinuousBatchingEngine
    eng = cls(model, n_slots=3, max_ctx=128, max_new_tokens=12,
              ctx_bucket=64, steps_per_tick=3, decode_graph=graph,
              pipeline_ticks=pipeline, **kw)
    texts = [f"Tell me about the number {i}." for i in range(6)]
    _build.reset_launch_counts()
    rids = [eng.submit([{"role": "user", "content": t}],
                       max_new_tokens=4 + 2 * i)
            for i, t in enumerate(texts[:4])]
    eng.step()
    eng.step()
    rids += [eng.submit([{"role": "user", "content": t}]) for t in texts[4:]]
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    return [info[r]["tokens"] for r in rids], eng, counts


@pytest.fixture(scope="module")
def engine_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    cfg = DeSTA25Config(llm_model_id="test/llama-nano128",
                        encoder_model_id="test/whisper-nano",
                        qformer_num_hidden_layers=2, prompt_size=8,
                        dtype="bfloat16", llm_quant="int8")
    return DeSTA25AudioModel(cfg, device="cuda", seed=3)


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_graph_captures_once_and_matches_eager(engine_model,
                                                      pipeline):
    """The engine's decode steps as replays of the one graph it keeps:
    captured once while requests come and go, one decode_graph replay for
    each step but the first, the K8-int8 launches every step's; the
    tokens equal the same engine's with every step eager."""
    eager, e_eng, e_n = _engine_run(engine_model, graph=False,
                                    pipeline=pipeline)
    got, g_eng, g_n = _engine_run(engine_model, graph=True,
                                  pipeline=pipeline)
    steps = g_eng._n_plain_ticks * g_eng.steps_per_tick
    L = g_eng.cfg.num_hidden_layers
    assert g_eng.graph.captures == 1 and g_eng.graph.capture_ms > 0
    assert e_eng.graph.captures == 0
    assert g_n.pop("decode_graph") == steps - 1
    assert g_n["fused_decode_layers_int8"] == 7 * L * steps
    assert g_n == e_n
    assert got == eager
    assert all(len(t) >= 1 for t in got)
    g_eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        g_eng.step()


def test_engine_graph_check_binds_on_a_rebound_cache(engine_model):
    """Control: an engine that places each admission's K/V into a new
    cache tensor (out of place, as a functional update would) leaves its
    graph reading the old one: its replayed tokens part from the eager
    engine's (which places them in place), so the equality of the test
    above binds."""
    from desta25_audio_tpu_torch.ops.fused_decode import KVCache
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

    class Rebinding(ContinuousBatchingEngine):
        def _place(self, sl, pcache, inj_k, inj_v):
            R = sl.shape[0]
            self.cache = KVCache(
                self.cache.k.index_copy(1, sl, pcache.k[:, :R]),
                self.cache.v.index_copy(1, sl, pcache.v[:, :R]))

    eager, _, _ = _engine_run(engine_model, graph=False)
    got, eng, _ = _engine_run(engine_model, graph=True, engine_cls=Rebinding)
    assert eng.graph.captures == 1
    assert got != eager


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_verify_graph_captures_once_and_matches_eager(engine_model,
                                                             pipeline):
    """The spec engine (speculative_k=4, every tick speculative): its
    verify steps are replays of the one verify graph it keeps, captured
    once while requests come and go (one decode_graph replay a verify step
    but the first, K8v's launches every step's, K8-int8 none); its tokens
    equal the same engine's with every step eager."""
    kw = dict(speculative_k=4, adaptive_spec=False)
    eager, e_eng, e_n = _engine_run(engine_model, graph=False,
                                    pipeline=pipeline, **kw)
    got, g_eng, g_n = _engine_run(engine_model, graph=True,
                                  pipeline=pipeline, **kw)
    steps = g_eng._n_spec_ticks * g_eng.steps_per_tick
    L = g_eng.cfg.num_hidden_layers
    assert g_eng.speculative_k == 4 and g_eng._n_plain_ticks == 0
    assert g_eng.vgraph.captures == 1 and g_eng.graph.captures == 0
    assert g_n.pop("decode_graph") == steps - 1
    assert g_n["fused_verify_layers"] == 7 * L * steps
    assert "fused_decode_layers_int8" not in g_n
    assert g_n == e_n
    assert got == eager
    assert _build.fallback_counts() == {}
    g_eng.close()


def test_verify_graph_logits_match_eager(engine_model, gen):
    """A kept verify graph (kd = 4, 3 rows at their own cache indices, one
    at the cache's end): three steps, eager, captured then replayed, each
    step's logits [B, 4, V] and written cache rows bit-equal to the same
    steps run eagerly on a copy of the cache."""
    from desta25_audio_tpu_torch.generate.graph import DecodeGraph
    llm, cfg = engine_model.params["llm"], engine_model.llm_cfg
    B, S, kd = 3, 256, 4
    base = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    base.k.normal_(generator=gen)
    base.v.normal_(generator=gen)
    mask = (torch.rand(B, S, generator=gen, device="cuda") > 0.1).int()
    ci0 = torch.tensor([40, 130, S - kd], dtype=torch.int32, device="cuda")
    runs = []
    for capture in (True, False):
        cache = tllm.KVCache(base.k.clone(), base.v.clone())
        g = DecodeGraph(llm, cfg, mask, cache, None, capture=capture, kd=kd)
        draw = torch.Generator("cuda").manual_seed(1)
        out = []
        for s in range(3):
            toks = torch.randint(0, cfg.vocab_size, (B, kd), generator=draw,
                                 device="cuda")
            ci = torch.clamp(ci0 + s, max=S - kd)
            pos = ci.long()[:, None] + torch.arange(kd, device="cuda")
            out.append(g.step(toks, pos, ci).clone())
        torch.cuda.synchronize()
        runs.append((out, cache, g.captures))
        g.close()
    (got, gc_, n), (want, wc, _) = runs
    assert n == 1
    for a, b in zip(got, want):
        assert a.shape == (B, kd, cfg.vocab_size) and a.dtype == torch.float32
        assert torch.equal(a, b)
    assert torch.equal(gc_.k, wc.k) and torch.equal(gc_.v, wc.v)
    assert not torch.equal(gc_.k, base.k)


@pytest.mark.parametrize("spec", [False, True])
def test_mesh_engine_graph_matches_eager(engine_model, spec):
    """The engine under a (1, 2) mesh of virtual ranks on the card, plain
    ticks or every tick speculative (speculative_k=4): its steps are
    replays of one graph for the card (K10 or its verify step), captured
    once, the all-reduce's error words read once a tick; its tokens equal
    the same engine's with every step eager."""
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    model = DeSTA25AudioModel(engine_model.config, device="cuda", seed=3)
    mesh = make_mesh(1, 2, ["cuda:0"] * 2)
    model.apply_llm_sharding(mesh)
    kw = dict(speculative_k=4, adaptive_spec=False) if spec else {}
    runs = []
    for graph in (False, True):
        with use_mesh(mesh):
            got, eng, counts = _engine_run(model, graph=graph, **kw)
        runs.append((got, eng, counts))
    (eager, _, e_n), (got, g_eng, g_n) = runs
    name = "fused_verify_layers_mesh" if spec else "fused_decode_layers_mesh"
    g = g_eng.vgraph if spec else g_eng.graph
    steps = (g_eng._n_spec_ticks if spec else g_eng._n_plain_ticks) * 3
    assert g.captures == 1
    assert g_n.pop("decode_graph") == steps - 1
    assert g_n[name] > 0 and g_n["tp_allreduce"] > 0
    assert "fused_decode_layers_int8" not in g_n
    assert g_n == e_n
    assert got == eager
    g_eng.close()
    mesh.buffers.clear()


def test_mesh_engine_orca_copies_follow_the_slots(tmp_path):
    """The ORCA engine (int8 stack and tower, K8i inside K10) under a (2, 2)
    mesh of virtual ranks: a data row's ranks read copies of the slots'
    audio K/V and ``on`` flags, which must follow every admission and tick
    (``MeshStep.sync_inject`` and ``fill``): after the run every rank's
    copies equal the engine's rows, and every request finishes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    import numpy as np
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.audio.io import write_wav
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import data_rows
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    cfg = DeSTA25Config(llm_model_id="test/llama-nano128",
                        encoder_model_id="test/whisper-nano",
                        qformer_num_hidden_layers=2, prompt_size=8,
                        dtype="bfloat16", llm_quant="int8",
                        connector_mode="orca_hybrid",
                        orca_global_num_tokens=4, orca_local_downsample=4,
                        orca_local_kernel_size=5,
                        orca_audio_position_scale=2.5)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=4)
    model.apply_orca_xattn_quant()
    mesh = make_mesh(2, 2, ["cuda:0"] * 4)
    model.apply_llm_sharding(mesh)
    t = np.arange(12000) / 16000.0
    msgs = []
    for i in range(3):
        path = str(tmp_path / f"w{i}.wav")
        write_wav(path, (0.5 * np.sin(2 * np.pi * (300 + 80 * i) * t))
                  .astype(np.float32))
        msgs.append([{"role": "user", "content": f"Sound {i}: <|AUDIO|>",
                      "audios": [{"audio": path, "text": f"tone {i}"}]}])
    msgs.append([{"role": "user", "content": "Say hello."}])
    with use_mesh(mesh):
        eng = ContinuousBatchingEngine(model, n_slots=2, max_ctx=128,
                                       max_new_tokens=6, ctx_bucket=64,
                                       steps_per_tick=2)
        assert eng._fspec is not None and eng.graph is not None
        rids = [eng.submit(m) for m in msgs]
        eng.run_until_done()
        info = eng.results()
    torch.cuda.synchronize()
    assert all(info[r]["finish_reason"] in ("eos", "length") for r in rids)
    step = eng.graph.stepper
    on = torch.as_tensor(eng._on)
    for g, rows, ins, steps, bufs in step.groups:
        assert rows == data_rows(mesh, 2, g)
        for st in steps:
            assert torch.equal(st.inj["k"], eng.inject_k[:, rows])
            assert torch.equal(st.inj["v"], eng.inject_v[:, rows])
            assert torch.equal(st.inj["on"], on[rows])
    eng.close()
    mesh.buffers.clear()


def test_quantize_on_the_card_equals_the_cpu(gen):
    """The int8 weight quantiser on the card against the CPU, bit for bit:
    rows whose ``max / 127`` and ``max * fl(1/127)`` round apart (every row
    parted before ``quantize_weight`` divided by a tensor), then one
    Llama-3.1-8B layer at full width and its head (chip_smoke phase 27)."""
    from desta25_audio_tpu_torch.ckpt.synthetic import quantize_card_vs_cpu
    r = quantize_card_vs_cpu(gen)
    assert (r["scales"], r["q_rows"], r["leaves"]) == (0, 0, 0), r


def test_merge_lora_for_serving_on_the_card_equals_the_cpu(gen):
    """LoRA merged into two Llama-3.1-8B layers at full width (r = 16, B
    moved off zero) and quantized, on the card and on the CPU: the merged
    bf16 weights and every int8 leaf and scale bit for bit (the merge sums
    the rank one term at a time; the quantizer divides), then
    ``merge_lora_for_serving(quantize=True)`` on a nano model on the card
    against the same on the CPU (chip_smoke phase 30c runs the first part
    at the flagship)."""
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.ckpt.synthetic import (count_differing,
                                                        merge_card_vs_cpu)
    cfg = dataclasses.replace(
        llm_config_for("meta-llama/Llama-3.1-8B-Instruct"),
        num_hidden_layers=2)
    llm = tllm.init_llm(cfg, torch.bfloat16, "cuda", gen)
    lora = tllm.init_lora(cfg, 16, "cuda", gen)
    for ab in lora["layers"].values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    r = merge_card_vs_cpu(llm, lora, 1.0)
    assert (r["merged"], r["leaves"]) == (0, 0), r
    ncfg = DeSTA25Config(llm_model_id="test/llama-nano128",
                         encoder_model_id="test/whisper-nano",
                         qformer_num_hidden_layers=2, prompt_size=8,
                         dtype="bfloat16", use_lora=True, lora_rank=4)
    host = DeSTA25AudioModel(ncfg, "cpu", seed=0)
    for ab in host.params["lora"]["layers"].values():
        ab["b"].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    card = DeSTA25AudioModel(ncfg, "cuda", params=_tree_to(host.params,
                                                           "cuda"))
    host.merge_lora_for_serving(quantize=True)
    card.merge_lora_for_serving(quantize=True)
    assert "lora" not in card.params and card.config.llm_quant == "int8"
    assert count_differing(card.params["llm"], host.params["llm"]) == 0


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_codec_reads_bf16_onto_the_card(gen, tmp_path):
    """A bf16 file (native BF16, and a flat tree's U16 + desta_dtypes) read
    straight onto the card, equal to the tensors written."""
    from desta25_audio_tpu_torch.ckpt import flat_io
    w = {"w": torch.randn(300, 7, generator=gen, device="cuda").bfloat16(),
         "q": torch.randint(-127, 128, (5, 9), generator=gen, device="cuda",
                            dtype=torch.int8)}
    p = str(tmp_path / "a.safetensors")
    flat_io.save_safetensors(w, p)
    got = flat_io.load_safetensors(p, device="cuda")
    for k, v in w.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v)
    q = str(tmp_path / "t.safetensors")
    flat_io.save_tree_safetensors({"a": w}, q)
    got = flat_io.load_tree_safetensors(q, device="cuda")["a"]
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w["w"])


def test_from_pretrained_on_the_card_matches_cpu(tmp_path):
    """A nano checkpoint and a weights root staged from a nano HF snapshot
    (whisper f16, Llama bf16): ``from_pretrained(device="cuda")`` builds
    every tower on the card, equal to the CPU's load leaf for leaf (the
    int8 LLM too: the card quantizes the raw shards as the CPU does), and
    greedy ids equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    import numpy as np
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu_torch.audio.io import write_wav
    from desta25_audio_tpu_torch.ckpt.synthetic import (
        count_differing,
        fill_state,
        hf_llm_shapes,
        hf_whisper_shapes,
        write_snapshot,
    )
    rng = np.random.default_rng(0)

    def make(dtype):
        def f(shape, kind):
            x = rng.standard_normal(shape).astype(np.float32) * 0.05
            return torch.from_numpy(x + (kind == "n")).to(dtype)
        return f
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        qformer_num_hidden_layers=2, prompt_size=8,
                        dtype="float32", llm_quant="int8")
    root = tmp_path / "w"
    write_snapshot(str(root / cfg.encoder_model_id), "whisper",
                   cfg.encoder_config,
                   fill_state(hf_whisper_shapes(cfg.encoder_config),
                              make(torch.float16)))
    write_snapshot(str(root / cfg.llm_model_id), "llm", cfg.llm_config,
                   fill_state(hf_llm_shapes(cfg.llm_config),
                              make(torch.bfloat16)), shards=2)
    DeSTA25AudioModel(cfg, "cpu", seed=3).save_pretrained(str(tmp_path / "ck"))
    t = np.arange(16000) / 16000.0
    wav = str(tmp_path / "a.wav")
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 440 * t)
                    * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32))
    msgs = [[{"role": "user", "content": "What is it? <|AUDIO|>",
              "audios": [{"audio": wav, "text": "a tone"}]}],
            [{"role": "user", "content": "Say hi."}]]
    out = {}
    for dev in ("cuda", "cpu"):
        m = DeSTA25AudioModel.from_pretrained(str(tmp_path / "ck"), dev,
                                              weights_root=str(root))
        assert m.params["llm"]["layers"]["wqkv"]["q"].device.type == dev
        out[dev] = m, m.generate(msgs, do_sample=False, max_new_tokens=6)
    assert count_differing(out["cuda"][0].params, out["cpu"][0].params) == 0
    assert out["cuda"][1].generated_ids == out["cpu"][1].generated_ids


@pytest.mark.parametrize("mode", ["qformer_1", "orca_hybrid"])
def test_flagship_train_setup_on_the_card(mode, monkeypatch):
    """``build_flagship_train_setup(device="cuda")`` at the flagship's
    widths with its LLM cut to 2 layers (B=12, T=300, the int8 tower at
    random, the ORCA stack in bf16): one step with a finite loss and
    gradient norm, and ``hbm_analysis`` with all three keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written Hopper kernels)")
    from desta25_audio_tpu_torch import config as tconfig
    from desta25_audio_tpu_torch.train import bench_utils as tbu
    real = tbu.flagship_config

    def two_layers(m="qformer_1"):
        cfg = real(m)
        cut = cfg.llm_model_id + "@2L"
        monkeypatch.setitem(tconfig._LLM_PRESETS, cut, dict(
            tconfig._LLM_PRESETS[cfg.llm_model_id], num_hidden_layers=2))
        return dataclasses.replace(cfg, llm_model_id=cut)
    monkeypatch.setattr(tbu, "flagship_config", two_layers)
    cfg, step, tr, layout, st, batch = tbu.build_flagship_train_setup(
        connector_mode=mode)
    assert cfg.llm_config.num_hidden_layers == 2
    assert batch["input_ids"].shape == (12, 300)
    assert layout.devices[0].type == "cuda"
    hbm = tbu.hbm_analysis(step, tr, layout, st, batch)
    assert set(hbm) == {"argument_gb", "temp_gb", "output_gb"}
    assert all(v > 0 for v in hbm.values()), hbm
    _build.reset_launch_counts()
    tr, st, m = step(tr, layout, st, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m["lm_loss"])) and float(m["grad_norm"]) > 0
    assert bool(torch.isfinite(m["grad_norm"]))
    counts = _build.launch_counts()
    for name in ("log_mel", "packed_encoder_attention", "encoder_ffn"):
        assert counts.get(name, 0) > 0, (name, counts)
    assert not _build.fallback_counts()
