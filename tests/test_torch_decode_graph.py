"""The decode step as one unit on the CPU, at nano scale: the shared step
function ``models/llm.decode_step`` (what ``generate/graph.DecodeGraph``
captures on the card) against ``llm_apply``'s decode step, bit for bit, on
the bf16 tower, the int8 tower and with the in-kernel ORCA injection
(plain K8i); ``llm_generate``'s greedy ids through the new path against the
JAX package's (its fused decode kernel in interpret mode); the launch
counts a graph records and replays; and K8's RMSNorm: ``rms_plain`` at
Llama-3.1-8B's and Qwen3-4B's widths against the JAX package's norm and
against an f32 emulation of the kernel's sum order (csrc/fused_decode.cu).
The graph itself, the kernels and programmatic dependent launch run on the
card only: tests/test_torch_cuda.py and chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import LLMConfig as JLLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.core import rms_norm as j_rms
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import LLMConfig as TLLMConfig
from desta25_audio_tpu_torch.config import llm_config_for
from desta25_audio_tpu_torch.generate import graph as tgraph
from desta25_audio_tpu_torch.generate.decode import llm_generate
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.models.orca import init_orca_cross_attns
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_inject_supported,
    rms_plain,
)
from desta25_audio_tpu_torch.ops.quant import (
    quantize_llm_params,
    quantize_orca_cross_attns,
)

from test_torch_int8_llm import jax_tpu_dispatch

TOL_DECODE = 3e-2   # the decode step's bound (tests/test_fused_decode.py:77)


def _tower(kind: str, gen):
    """llama-nano128 (Dh = 128: the fused step takes it) in bf16, its int8
    quantization, or the int8 tower with an int8 ORCA stack and random
    audio K/V for two rows (the in-kernel injection spec)."""
    cfg = llm_config_for("test/llama-nano128")
    params = tllm.init_llm(cfg, torch.bfloat16, "cpu", gen)
    if kind == "bf16":
        return cfg, params, None
    params = quantize_llm_params(params)
    if kind == "int8":
        return cfg, params, None
    stack = init_orca_cross_attns(
        types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
        torch.bfloat16, "cpu", gen)
    stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
    stack = quantize_orca_cross_attns(stack)
    L, D, ta = cfg.num_hidden_layers, cfg.hidden_size, 21
    kv = torch.randn(2, L, 2, ta, D, generator=gen).bfloat16()
    spec = dict(params=stack, k=kv[0], v=kv[1], ta_real=ta,
                heads=cfg.num_attention_heads,
                on=torch.tensor([1.0, 0.0]))
    assert fused_inject_supported(params, cfg, stack, spec["heads"], ta)
    return cfg, params, spec


@pytest.mark.parametrize("kind", ["bf16", "int8", "orca"])
def test_decode_step_matches_llm_apply_bit_for_bit(kind):
    """decode_step on device-style inputs (ids and positions [B] int64,
    ci [B] int32) gives llm_apply's decode-step logits and cache writes bit
    for bit (llm_apply takes the int cache index generate() used to pass);
    a row with on = 0 takes no injection."""
    gen = torch.Generator().manual_seed(3)
    cfg, params, spec = _tower(kind, gen)
    B, S, ci = 2, 128, 40
    shape = (cfg.num_hidden_layers, B, S,
             cfg.num_key_value_heads * cfg.head_dim)
    cache0 = KVCache(torch.randn(shape, generator=gen).bfloat16(),
                     torch.randn(shape, generator=gen).bfloat16())
    mask = (torch.rand(B, S, generator=gen) > 0.2).int()
    mask[:, ci] = 1
    ids = torch.randint(2, cfg.vocab_size, (B,), generator=gen)
    pos = torch.tensor([ci, ci - 3])
    fresh = lambda: KVCache(cache0.k.clone(), cache0.v.clone())  # noqa
    ca, cb = fresh(), fresh()
    got = tllm.decode_step(params, cfg, ids, pos,
                           torch.full((B,), ci, dtype=torch.int32), mask, ca,
                           spec)
    want, _ = tllm.llm_apply(params, cfg, input_ids=ids[:, None],
                             attention_mask=mask, positions=pos[:, None],
                             cache=cb, cache_index=ci, fused_injection=spec)
    assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
    assert torch.equal(got, want[:, 0])
    assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)
    assert not torch.equal(ca.k, cache0.k)
    if spec is not None:
        plain = tllm.decode_step(params, cfg, ids, pos,
                                 torch.full((B,), ci, dtype=torch.int32),
                                 mask, fresh(), None)
        assert torch.equal(got[1], plain[1])
        assert not torch.equal(got[0], plain[0])


@pytest.mark.parametrize("kind", ["int8", "orca"])
def test_graph_step_with_row_write_positions_matches_llm_apply(kind):
    """DecodeGraph.step with a [B] int32 write-position tensor (the serving
    engine's kept step: rows at 40, 90, the cache's last position and one
    past it, which is not written) equals llm_apply's step with
    cache_index=[B], logits and cache bit for bit, on the step's own mask
    and cache buffers across two steps."""
    gen = torch.Generator().manual_seed(5)
    cfg, params, spec = _tower(kind, gen)
    B, S = 4, 128
    if spec is not None:
        kv = torch.randn(2, cfg.num_hidden_layers, B, 24, cfg.hidden_size,
                         generator=gen).bfloat16()
        spec = dict(spec, k=kv[0], v=kv[1], ta_real=21,
                    on=torch.tensor([1.0, 0.0, 1.0, 1.0]))
    shape = (cfg.num_hidden_layers, B, S,
             cfg.num_key_value_heads * cfg.head_dim)
    cache0 = KVCache(torch.randn(shape, generator=gen).bfloat16(),
                     torch.randn(shape, generator=gen).bfloat16())
    mask = (torch.rand(B, S, generator=gen) > 0.2).int()
    ca = KVCache(cache0.k.clone(), cache0.v.clone())
    cb = KVCache(cache0.k.clone(), cache0.v.clone())
    graph = tgraph.DecodeGraph(params, cfg, mask, ca, spec, capture=True)
    ci = torch.tensor([40, 90, S - 1, S], dtype=torch.int32)
    for step in range(2):
        ids = torch.randint(2, cfg.vocab_size, (B,), generator=gen)
        pos = ci.long() + 3
        got = graph.step(ids, pos, ci)
        want, _ = tllm.llm_apply(params, cfg, input_ids=ids[:, None],
                                 attention_mask=mask, positions=pos[:, None],
                                 cache=cb, cache_index=ci,
                                 fused_injection=spec)
        assert torch.equal(got, want[:, 0])
        assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)
        ci = ci + 1
    assert graph.captures == 0            # the CPU runs the step eagerly
    assert torch.equal(ca.k[:, :, S - 1:], cb.k[:, :, S - 1:])
    assert torch.equal(ca.k[:, 3], cache0.k[:, 3])   # past the end: kept
    assert not torch.equal(ca.k[:, 0], cache0.k[:, 0])


def _nano_cfgs():
    kw = dict(model_id="test/graph-nano", vocab_size=512, hidden_size=512,
              intermediate_size=768, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=128,
              rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
              tie_word_embeddings=False, qk_norm=False, bos_token_id=0,
              eos_token_id=1)
    return JLLMConfig(**kw), TLLMConfig(**kw)


@pytest.mark.parametrize("int8", [True, False])
def test_generate_through_the_step_matches_jax(int8, monkeypatch):
    """llm_generate, greedy, on a bf16 or int8 nano tower with left-padded
    rows: every decode step goes through DecodeGraph.step (eager on the
    CPU: no graph, no counted launch), and the ids equal the JAX package's
    llm_generate on its TPU dispatch (the fused decode kernel in interpret
    mode)."""
    from desta25_audio_tpu.generate.decode import llm_generate as j_generate
    jcfg, tcfg = _nano_cfgs()
    jp = tree_cast(jllm.init_llm(jax.random.PRNGKey(7), jcfg,
                                 dtype=jnp.float32), jnp.bfloat16)
    if int8:
        jp = jq.quantize_llm_params(jp)
    tp = bridge.llm_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    B, T, NEW = 2, 12, 6
    ids = np.random.default_rng(11).integers(2, 500, size=(B, T))
    amask = np.ones((B, T), np.int32)
    amask[1, :3] = 0
    jax_tpu_dispatch(monkeypatch)
    try:
        want, _ = j_generate(jp, jcfg, jp["embed"][jnp.asarray(ids)],
                             jnp.asarray(amask), jax.random.PRNGKey(0),
                             max_new_tokens=NEW, do_sample=False, eos_ids=(),
                             pad_id=0)
        want = np.asarray(want)
    finally:
        jax.clear_caches()
    steps = []
    real = tgraph.DecodeGraph.step
    monkeypatch.setattr(tgraph.DecodeGraph, "step",
                        lambda self, *a: steps.append(1) or real(self, *a))
    emb = tllm.embed_tokens(tp, torch.from_numpy(ids))
    gen = torch.Generator().manual_seed(0)
    _build.reset_launch_counts()
    got, _ = llm_generate(tp, tcfg, emb, torch.from_numpy(amask), gen,
                          max_new_tokens=NEW)
    assert len(steps) == NEW - 1
    assert _build.launch_counts() == {} and _build.fallback_counts() == {}
    assert got.tolist() == want.tolist()


def test_counts_taken_from_a_capture_and_replayed():
    """What a capture counted is taken back out of the counters, and each
    replay adds exactly that again."""
    _build.reset_launch_counts()
    _build.count_launch("step")
    _build.count_kernel("gemm", 2)
    before = _build.count_snapshot()
    _build.count_launch("step", 14)
    _build.count_launch("head")
    _build.count_kernel("gemm", 9)
    _build.count_kernel("attention", 2)
    taken = _build.take_counts(before)
    assert taken == _build.Counts({"step": 14, "head": 1},
                                  {"gemm": 9, "attention": 2})
    assert _build.launch_counts() == {"step": 1}
    assert _build.kernel_counts() == {"gemm": 2}
    for _ in range(3):
        _build.add_counts(taken)
    assert _build.launch_counts() == {"step": 43, "head": 3}
    assert _build.kernel_counts() == {"gemm": 29, "attention": 6}
    _build.reset_launch_counts()


def _rms_kernel_order(x: np.ndarray, w: np.ndarray, eps: float):
    """csrc/fused_decode.cu rms_norm_kernel's arithmetic in f32 numpy: a
    block of min(512, D/8 rounded up to a warp) threads, thread t summing
    the squares of its 8-value vectors t, t + threads, ... in order, the
    warps' xor-shuffle trees, the warps' sums in warp order; then
    bf16(x * rsqrt(ss / D + eps) * w)."""
    rows, D = x.shape
    nvec = D // 8
    threads = min(512, -(-nvec // 32) * 32)
    out = np.empty((rows, D), np.float32)
    for r in range(rows):
        part = np.zeros(threads, np.float32)
        vec = x[r].reshape(nvec, 8)
        for v in range(nvec):
            t = v % threads
            for e in range(8):
                part[t] = np.float32(part[t] + vec[v, e] * vec[v, e])
        warps = part.reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            lanes = np.arange(32)
            warps = (warps + warps[:, lanes ^ o]).astype(np.float32)
        ss = np.float32(0)
        for s in warps[:, 0]:
            ss = np.float32(ss + s)
        inv = np.float32(1) / np.sqrt(np.float32(ss / np.float32(D)
                                                 + np.float32(eps)))
        out[r] = (x[r] * inv).astype(np.float32) * w
    return torch.from_numpy(out).bfloat16()


@pytest.mark.parametrize("D", [2560, 4096])
def test_rms_plain_at_the_step_widths(D):
    """K8's norm (ln1 / ln2) at Qwen3-4B's and Llama-3.1-8B's widths on
    bf16 rows of mixed scale: rms_plain against the JAX package's rms_norm
    and against the new kernel's sum order, within the decode step's
    tolerance, each agreeing on nearly every element."""
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((2, D)) * np.array([[1.0], [40.0]])
         ).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).bfloat16()
    got = rms_plain(xt, wt, 1e-5, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, D)
    want = torch.from_numpy(np.array(
        j_rms({"scale": wj}, xj, 1e-5).astype(jnp.float32)))
    emu = _rms_kernel_order(xt.float().numpy(), wt.float().numpy(), 1e-5)
    for ref in (want, emu.float()):
        err = float((got.float() - ref).abs().max() / ref.abs().max())
        assert err < TOL_DECODE
        assert float((got.float() != ref).float().mean()) < 0.02
