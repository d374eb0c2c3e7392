"""The tensor-parallel decode of the port (``parallel/``,
``ops/fused_decode_mesh.py`` K10, ``ops/tp_allreduce.py``, the mesh
dispatch of ``models/llm.py``) against the JAX package on the CPU,
mirroring tests/test_fused_mesh.py.

The port's mesh is ``["cpu"] * n`` (its plain versions); the JAX side runs
``fused_decode_layers_mesh`` / ``fused_verify_layers_mesh`` in interpret
mode (``DESTA_FUSED_INTERPRET=1``) on virtual CPU devices, its int8 products
on the TPU dispatch (``test_torch_int8_llm.jax_tpu_dispatch``: K7 below 128
rows, as the port's head and short prefills).  Bounds, those of
tests/test_torch_int8_llm.py::test_fused_decode_int8_plain_matches_pallas:
logits within 3e-2 of their scale (the f32 sums run in another order on
the two sides, then through bf16 roundings), the same argmax, the written
cache rows within 0.05 absolute (bf16 values of unit scale, one bf16 ulp of
the largest is 1.6e-2).  Each rank's slice of layer 0's cache equals the
matching columns of the unsharded plain step's exactly: the shard's k/v
rows are the same dot products of the same input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from desta25_audio_tpu.config import LLMConfig as JLLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops import fused_decode_mesh as jmesh
from desta25_audio_tpu.ops import fused_decode_tp as jtp
from desta25_audio_tpu.ops import quant as jq
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.ops.fused_decode import pad_audio_kv
from desta25_audio_tpu.parallel import mesh as jpm
from desta25_audio_tpu.parallel.sharding import (
    apply_sharding,
    llm_partition_specs,
)
from desta25_audio_tpu_torch.ckpt import bridge
from desta25_audio_tpu_torch.config import LLMConfig as TLLMConfig
from desta25_audio_tpu_torch.config import llm_config_for
from desta25_audio_tpu_torch.generate import graph as tgraph
from desta25_audio_tpu_torch.generate.decode import llm_generate
from desta25_audio_tpu_torch.generate.speculative import llm_generate_spec
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.ops import fused_decode_mesh as tmesh
from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
from desta25_audio_tpu_torch.ops.core import rms_norm as t_rms
from desta25_audio_tpu_torch.ops.fused_decode import (
    KVCache,
    fused_decode_layers_plain,
    fused_verify_layers,
)
from desta25_audio_tpu_torch.ops.tp_allreduce import allreduce_plain
from desta25_audio_tpu_torch.parallel import mesh as tpm
from desta25_audio_tpu_torch.parallel.sharding import (
    ShardedCache,
    apply_llm_sharding,
    data_rows,
    gather_cache,
    shard_kv_cache,
)
from test_torch_int8_llm import jax_tpu_dispatch
from test_torch_orca import _jax_stack

S, L, KVD = 128, 2, 256
TOL, ROW_TOL = 3e-2, 0.05


def _cfgs(Hkv=2):
    # tests/test_fused_mesh.py:30-38 (I stays a multiple of 256 per shard)
    kw = dict(model_id="test/fused-mesh-nano", vocab_size=512,
              hidden_size=512, intermediate_size=1024, num_hidden_layers=L,
              num_attention_heads=4, num_key_value_heads=Hkv, head_dim=128,
              rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
              tie_word_embeddings=False, qk_norm=False, bos_token_id=0,
              eos_token_id=1)
    return JLLMConfig(**kw), TLLMConfig(**kw)


@pytest.fixture(scope="module")
def towers():
    """The JAX int8 tower of tests/test_fused_mesh.py and its bridge."""
    jcfg, tcfg = _cfgs()
    qp = jq.quantize_llm_params(tree_cast(
        jllm.init_llm(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32),
        jnp.bfloat16))
    return jcfg, tcfg, qp, bridge.llm_from_jax(jax.tree.map(np.asarray, qp),
                                                "cpu")


def _meshes(n_data, n_model):
    n = n_data * n_model
    return (jpm.make_mesh(n_data=n_data, n_model=n_model,
                          devices=jax.devices()[:n]),
            tpm.make_mesh(n_data, n_model, ["cpu"] * n))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding identical values."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_logits(qp, cfg, h):
    return _np(jllm._head_logits(qp, cfg, jllm.rms_norm(qp["norm"], h,
                                                        cfg.rms_norm_eps)))


def _port_logits(tp, cfg, h):
    return _np(tllm.head_logits(tp, t_rms(tp["norm"], h, cfg.rms_norm_eps)))


def _step_inputs(B, kd, ci, seed):
    """A random bf16 cache on both sides, row b left-padded by b, kd ids a
    row at ci..ci+kd-1 (ci: an int or one per row)."""
    rng = np.random.default_rng(seed)
    jk, tk = _bf16(rng.standard_normal((L, B, S, KVD)))
    jv, tv = _bf16(rng.standard_normal((L, B, S, KVD)))
    cir = np.array(np.broadcast_to(np.asarray(ci, np.int32), (B,)))
    pad = np.arange(B)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, pad[b]:cir[b] + kd] = 1
    pos = ((cir - pad)[:, None] + np.arange(kd)[None, :]).astype(np.int32)
    ids = rng.integers(2, 500, size=(B, kd))
    return (jk, jv), (tk, tv), mask, pos, ids, cir


def _compare_step(towers, n_data, n_model, B, kd, ci, seed, inject=None):
    """One decode (kd = 1) or verify step: JAX K10 in interpret mode against
    the port's plain K10, both on an (n_data, n_model) mesh."""
    jcfg, tcfg, qp, tp = towers
    (jk, jv), (tk, tv), mask, pos, ids, cir = _step_inputs(B, kd, ci, seed)
    jspec, tspec = inject if inject is not None else (None, None)
    jmesh_, tmesh_ = _meshes(n_data, n_model)
    jfn = (jmesh.fused_decode_layers_mesh if kd == 1
           else jmesh.fused_verify_layers_mesh)
    tfn = (tmesh.fused_decode_layers_mesh if kd == 1
           else tmesh.fused_verify_layers_mesh)
    inj_kw = ({} if jspec is None else
              dict(inject_params=jspec["params"],
                   ta_padded=jspec["k"].shape[2]))
    with jpm.use_mesh(jmesh_):
        sh = apply_sharding(qp, llm_partition_specs(qp))
        jcache = jllm.KVCache(jk, jv)
        assert jmesh.fused_mesh_supported(sh, jcfg, jcache, kd=kd, **inj_kw)
        jh, jcache = jfn(sh, jcfg, sh["embed"][jnp.asarray(ids)],
                         jnp.asarray(mask), jnp.asarray(pos), jcache,
                         jnp.asarray(ci), inject=jspec)
    want = _jax_logits(qp, jcfg, jh)
    x = tllm.embed_tokens(tp, torch.from_numpy(ids))
    args = (torch.from_numpy(mask), torch.from_numpy(pos))
    tci = torch.as_tensor(np.asarray(ci))
    _build.reset_launch_counts()
    with tpm.use_mesh(tmesh_):
        sp = apply_llm_sharding(tp, tcfg, tmesh_)
        cache = shard_kv_cache(KVCache(tk, tv), tcfg, tmesh_)
        t_inj = ({} if tspec is None else
                 dict(inject_params=tspec["params"], ta=tspec["ta_real"],
                      heads=tspec["heads"]))
        assert tmesh.fused_mesh_supported(sp, tcfg, cache, kd, **t_inj)
        th, cache = tfn(sp, tcfg, x, *args, cache, tci, inject=tspec)
    assert _build.launch_counts() == {}          # the CPU runs plain
    got = _port_logits(tp, tcfg, th)
    assert got.shape == want.shape == (B, kd, jcfg.vocab_size)
    assert np.abs(got - want).max() / np.abs(want).max() < TOL
    assert (got.argmax(-1) == want.argmax(-1)).all()
    full = gather_cache(cache)
    ref_h, ref = fused_decode_layers_plain(
        tp, tcfg, x, *args, KVCache(tk.clone(), tv.clone()), tci,
        inject=tspec)
    for side, jc, old in (("k", jcache.k, tk), ("v", jcache.v, tv)):
        new, jc = _np(getattr(full, side)), _np(jc)
        for b in range(B):
            rows = slice(cir[b], cir[b] + kd)
            np.testing.assert_allclose(new[:, b, rows], jc[:, b, rows],
                                       rtol=ROW_TOL, atol=ROW_TOL)
            assert np.abs(new[:, b, rows]).max() > 0
        keep = np.ones((L, B, S), bool)
        for b in range(B):
            keep[:, b, cir[b]:cir[b] + kd] = False
        np.testing.assert_array_equal(new[keep], _np(old)[keep])
        # each rank's slice of layer 0 is the unsharded step's columns
        for g, row in enumerate(cache.shards):
            rows = data_rows(tmesh_, B, g)
            kvd = KVD // n_model
            for m, c in enumerate(row):
                assert torch.equal(
                    getattr(c, side)[0],
                    getattr(ref, side)[0, rows, :, m * kvd:(m + 1) * kvd])
    # the tensor-parallel step against the unsharded one: reassociation
    assert np.abs(_np(th) - _np(ref_h)).max() / np.abs(_np(ref_h)).max() < TOL


@pytest.mark.parametrize("n_data,n_model,B", [(1, 2, 2), (2, 2, 4)],
                         ids=["tp2", "dp2xtp2"])
def test_mesh_decode_matches_jax(towers, monkeypatch, n_data, n_model, B):
    jax_tpu_dispatch(monkeypatch)
    try:
        _compare_step(towers, n_data, n_model, B, 1, 16, seed=n_data)
    finally:
        jax.clear_caches()


def test_mesh_verify_matches_jax(towers, monkeypatch):
    jax_tpu_dispatch(monkeypatch)
    try:
        _compare_step(towers, 1, 2, 2, 4, np.array([16, 40], np.int32),
                      seed=5)
    finally:
        jax.clear_caches()


def test_mesh_per_row_cache_indices(towers, monkeypatch):
    jax_tpu_dispatch(monkeypatch)
    try:
        _compare_step(towers, 1, 2, 2, 1, np.array([33, 57], np.int32),
                      seed=7)
    finally:
        jax.clear_caches()


def test_mesh_injection_matches_jax(towers, monkeypatch):
    """ORCA's injection inside the step, replicated on every rank; row 1
    has it off."""
    jax_tpu_dispatch(monkeypatch)
    jcfg = towers[0]
    jx8 = jq.quantize_orca_cross_attns(_jax_stack(jax.random.PRNGKey(6),
                                                  jcfg))
    tx8 = bridge.orca_cross_attns_from_jax(jax.tree.map(np.asarray, jx8),
                                           "cpu")
    rng = np.random.default_rng(11)
    ta, on = 24, np.asarray([1.0, 0.0], np.float32)
    jka, tka = _bf16(rng.standard_normal((L, 2, ta, 512)))
    jva, tva = _bf16(rng.standard_normal((L, 2, ta, 512)))
    jspec = dict(params=jx8, k=pad_audio_kv(jka), v=pad_audio_kv(jva),
                 ta_real=ta, heads=4, on=jnp.asarray(on))
    tspec = dict(params=tx8, k=tka, v=tva, ta_real=ta, heads=4,
                 on=torch.from_numpy(on))
    try:
        _compare_step(towers, 1, 2, 2, 1, np.array([20, 30], np.int32),
                      seed=9, inject=(jspec, tspec))
    finally:
        jax.clear_caches()


def test_mesh_predicate_refusals(towers):
    """No mesh, a model axis of 1, and p = 4 over Hkv = 2 are refused on
    both sides; the K9 pair and pick_verify_fn follow."""
    jcfg, tcfg, qp, tp = towers
    jcache = jllm.init_kv_cache(jcfg, 2, S, dtype=jnp.bfloat16)
    tcache = tllm.init_kv_cache(tcfg, 2, S, torch.bfloat16, "cpu")
    assert not jmesh.fused_mesh_supported(qp, jcfg, jcache)
    assert not tmesh.fused_mesh_supported(tp, tcfg, tcache)
    assert "no mesh" in tmesh.fused_mesh_limits(tp, tcfg, 2, S)[0]
    assert tmesh.pick_verify_fn(tp, tcfg, tcache, 4) is fused_verify_layers
    for n_data, n_model, why in ((2, 1, "no mesh with a model axis"),
                                 (1, 4, "do not split 4 ways")):
        jm, tm = _meshes(n_data, n_model)
        with jpm.use_mesh(jm):
            assert not jmesh.fused_mesh_supported(qp, jcfg, jcache)
        with tpm.use_mesh(tm):
            assert not tmesh.fused_mesh_supported(tp, tcfg, tcache)
            assert any(why in r for r in tmesh.fused_mesh_limits(
                tp, tcfg, 2, S))
            assert not ttp.fused_tp_supported(tp, tcfg, tcache)
            assert tmesh.pick_verify_fn(tp, tcfg, tcache, 4) is None
    jm, tm = _meshes(1, 2)
    with tpm.use_mesh(tm):
        sp = apply_llm_sharding(tp, tcfg, tm)
        cache = tllm.init_kv_cache(tcfg, 2, S, torch.bfloat16, "cpu")
        assert isinstance(cache, ShardedCache)
        assert cache.shape == (L, 2, S, KVD)
        assert tmesh.fused_mesh_supported(sp, tcfg, cache)
        assert tmesh.pick_verify_fn(sp, tcfg, cache, 4) is \
            tmesh.fused_verify_layers_mesh
        assert ttp.fused_tp_supported(sp, tcfg, cache)
        # a bf16 cache only; a float32 tower falls to the layer loop
        assert not tmesh.fused_mesh_supported(
            sp, tcfg, tllm.init_kv_cache(tcfg, 2, S, torch.float32, "cpu"))
        f32 = tllm.init_llm(tcfg, torch.float32, "cpu",
                            torch.Generator().manual_seed(0))
        assert "neither int8 nor bf16" in tmesh.fused_mesh_limits(
            f32, tcfg, 2, S)[0]
    with pytest.raises(ValueError, match="split 4 ways"):
        apply_llm_sharding(tp, tcfg, _meshes(1, 4)[1])


@pytest.mark.parametrize("p", [2, 4])
def test_allreduce_replicates_the_residual(p):
    """The plain all-reduce leaves every rank's residual equal bit for bit,
    at p = 2 in the JAX kernel's order (own partial first) and at p = 4 in
    rank 0's JAX order."""
    rng = np.random.default_rng(p)
    parts = [torch.from_numpy(rng.standard_normal((3, 64)).astype(
        np.float32) * 10.0 ** rng.integers(-3, 3)) for _ in range(p)]
    h = torch.from_numpy(rng.standard_normal((3, 64)).astype(
        np.float32)).bfloat16()
    out = allreduce_plain(parts, [h] * p)
    for r in range(1, p):
        assert torch.equal(out[r].view(torch.int16), out[0].view(torch.int16))

    def jax_order(my):     # fused_decode.py:690-693: pres + sum_d rbuf[d]
        tot = parts[my]
        for d in range(p):
            tot = tot + (torch.zeros_like(parts[d]) if d == my else parts[d])
        return (h.float() + tot.bfloat16().float()).bfloat16()
    assert torch.equal(out[0], jax_order(0))
    if p == 2:
        assert torch.equal(out[1], jax_order(1))
    f32 = allreduce_plain(parts, [h.float()] * p)       # K9's f32 residual
    assert torch.equal(f32[0], h.float() + sum(parts[1:], parts[0]))


def test_jax_order_parts_ranks_at_p4():
    """Why the port sums in rank order: at p = 4 the JAX kernel's order
    (own partial first) gives rank 2 ((p2 + p0) + p1) + p3 and rank 0
    ((p0 + p1) + p2) + p3, which can differ; the ranks' residuals then
    part.  Rank order gives every rank rank 0's value."""
    parts = [torch.tensor([v]) for v in (1.0, -1.0, 2.0 ** -30, 0.0)]
    h = torch.zeros(1).bfloat16()

    def own_first(my):
        tot = parts[my]
        for d in range(4):
            if d != my:
                tot = tot + parts[d]
        return (h.float() + tot.bfloat16().float()).bfloat16()
    assert not torch.equal(own_first(0), own_first(2))
    out = allreduce_plain(parts, [h] * 4)
    assert all(torch.equal(o, own_first(0)) for o in out)


def test_tp_pair_under_mesh_matches_jax(towers, monkeypatch):
    """The per-layer pair K9 under a (1, 2) mesh: the port's plain pair,
    called directly (the port's dispatch takes K10 for every step the pair
    could take), against JAX ``fused_decode_layers_tp`` in interpret mode,
    reached through the JAX dispatch with DESTA_FUSED_MESH off."""
    jax_tpu_dispatch(monkeypatch)
    monkeypatch.setenv("DESTA_FUSED_MESH", "0")
    jcfg, tcfg, qp, tp = towers
    (jk, jv), (tk, tv), mask, pos, ids, cir = _step_inputs(
        2, 1, np.array([33, 57], np.int32), 13)
    jm, tm = _meshes(1, 2)
    try:
        with jpm.use_mesh(jm):
            sh = apply_sharding(qp, llm_partition_specs(qp))
            assert not jmesh.fused_mesh_supported(sh, jcfg, jllm.KVCache(
                jk, jv))
            assert jtp.fused_tp_supported(sh, jcfg, jllm.KVCache(jk, jv))
            jl, jcache, _ = jllm.llm_apply(
                sh, jcfg, input_ids=jnp.asarray(ids),
                attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos),
                cache=jllm.KVCache(jk, jv), cache_index=jnp.asarray(cir))
        with tpm.use_mesh(tm):
            sp = apply_llm_sharding(tp, tcfg, tm)
            cache = shard_kv_cache(KVCache(tk, tv), tcfg, tm)
            assert ttp.fused_tp_supported(sp, tcfg, cache)
            assert tmesh.fused_mesh_supported(sp, tcfg, cache)
            th, cache = ttp.fused_decode_layers_tp(
                sp, tcfg, tllm.embed_tokens(tp, torch.from_numpy(ids)),
                torch.from_numpy(mask), torch.from_numpy(pos), cache,
                torch.from_numpy(cir))
    finally:
        jax.clear_caches()
    want, got = _np(jl), _port_logits(tp, tcfg, th)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < TOL
    assert (got.argmax(-1) == want.argmax(-1)).all()
    full = gather_cache(cache)
    for b in range(2):
        np.testing.assert_allclose(_np(full.k)[:, b, cir[b]],
                                   _np(jcache.k)[:, b, cir[b]],
                                   rtol=ROW_TOL, atol=ROW_TOL)


def _generate_k10(towers, monkeypatch, inject: bool):
    """llm_generate under a (1, 2) mesh, greedy, on the JAX package's TPU
    dispatch (K7 below 128 rows, K10 at every decode step, in interpret
    mode) and on the port (its plain versions, every decode step through
    the graph object with capture off, ``generate/graph.DecodeGraph`` over
    ``ops/fused_decode_mesh.MeshStep``), and the port's unsharded run; with
    ``inject`` ORCA's int8 stack inside every step on both sides.  Returns
    (JAX ids, mesh ids, unsharded ids, JAX K10 calls, the port's graph
    steps)."""
    jcfg, tcfg, qp, tp = towers
    jax_tpu_dispatch(monkeypatch)
    B, T, NEW = 2, 12, 6
    rng = np.random.default_rng(21)
    ids = rng.integers(2, 500, size=(B, T))
    amask = np.ones((B, T), np.int32)
    jkw, tkw = {}, {}
    if inject:
        jx8 = jq.quantize_orca_cross_attns(_jax_stack(jax.random.PRNGKey(6),
                                                      jcfg))
        tx8 = bridge.orca_cross_attns_from_jax(jax.tree.map(np.asarray, jx8),
                                               "cpu")
        jtok, ttok = _bf16(rng.standard_normal((B, 24, 512)))
        jkw = dict(inject_params=jx8, inject_tokens=jtok, inject_heads=4)
        tkw = dict(inject_params=tx8, inject_tokens=ttok, inject_heads=4)
    counts = {"jax": 0, "graph": 0}
    jreal = jmesh.fused_decode_layers_mesh

    def jcounted(*a, **k):
        counts["jax"] += 1
        return jreal(*a, **k)
    monkeypatch.setattr(jmesh, "fused_decode_layers_mesh", jcounted)
    greal = tgraph.DecodeGraph.step

    def gcounted(self, *a, **k):
        if isinstance(self.stepper, tmesh.MeshStep):
            counts["graph"] += 1
            assert not self.capture
        return greal(self, *a, **k)
    monkeypatch.setattr(tgraph.DecodeGraph, "step", gcounted)
    from desta25_audio_tpu.generate.decode import llm_generate as j_generate
    jm, tm = _meshes(1, 2)
    try:
        with jpm.use_mesh(jm):
            sh = apply_sharding(qp, llm_partition_specs(qp))
            want, _ = j_generate(sh, jcfg, sh["embed"][jnp.asarray(ids)],
                                 jnp.asarray(amask), jax.random.PRNGKey(0),
                                 max_new_tokens=NEW, do_sample=False,
                                 eos_ids=(), pad_id=0, **jkw)
        want = np.asarray(want)
    finally:
        jax.clear_caches()
    emb = tllm.embed_tokens(tp, torch.from_numpy(ids))
    gen = torch.Generator().manual_seed(0)
    ref, _ = llm_generate(tp, tcfg, emb, torch.from_numpy(amask), gen,
                          max_new_tokens=NEW, **tkw)
    steps_unsharded = counts["graph"]
    with tpm.use_mesh(tm):
        got, _ = llm_generate(apply_llm_sharding(tp, tcfg, tm), tcfg, emb,
                              torch.from_numpy(amask), gen,
                              max_new_tokens=NEW, **tkw)
    assert steps_unsharded == 0
    return want, got, ref, counts["jax"], counts["graph"]


def test_int8_generate_matches_jax_k10(towers, monkeypatch):
    """llm_generate under a (1, 2) mesh, greedy: the JAX package on its
    TPU dispatch (K7 below 128 rows, K10 at every decode step, in interpret
    mode) and the port (its plain versions) give the same ids, equal to the
    port's unsharded run; both sides' decode steps took K10, the port's
    through the decode graph object (capture off on the CPU)."""
    want, got, ref, n_jax, n_graph = _generate_k10(towers, monkeypatch,
                                                   inject=False)
    assert n_jax >= 1 and n_graph == 5
    assert got.tolist() == want.tolist()
    assert got.tolist() == ref.tolist()


def test_int8_generate_with_injection_matches_jax_k10(towers, monkeypatch):
    """The same with ORCA's int8 cross-attention stack injected in every
    layer, inside K10's step on both sides: the same ids as JAX's and as
    the port's unsharded run."""
    want, got, ref, n_jax, n_graph = _generate_k10(towers, monkeypatch,
                                                   inject=True)
    assert n_jax >= 1 and n_graph == 5
    assert got.tolist() == want.tolist()
    assert got.tolist() == ref.tolist()


def test_epoch_schedule_never_repeats():
    """The all-reduce's epochs as the steps reserve them
    (``MeshBuffers.begin`` + ``layer_round``) over two generate() calls of
    4 decode steps each, a speculative call's verify step (Kd = 3) after
    each decode step: the verify step's rounds go to the group's buffers
    at its own row count (``group_buffers``), and on each buffer no epoch
    repeats, each slot's epochs strictly grow in launch order, and every
    rank's base word holds the step's base."""
    from desta25_audio_tpu_torch.ops.tp_allreduce import (
        ATTN_SLOT, MLP_SLOT, group_buffers, layer_round)
    L, B, Kd, D = 3, 2, 3, 8
    tm = tpm.make_mesh(1, 2, ["cpu"] * 2)
    decode = group_buffers(tm, 0, B, D)
    verify = group_buffers(tm, 0, B * Kd, D)
    assert decode is not verify and group_buffers(tm, 0, B, D) is decode
    seen = {id(decode): set(), id(verify): set()}
    last = {(id(b), s): 0 for b in (decode, verify)
            for s in (ATTN_SLOT, MLP_SLOT)}
    for call in range(2):
        for step in range(4):
            for bufs in (decode, verify):
                base = bufs.begin(2 * L)
                assert [int(b) for b in bufs.base] == [base, base]
                for l in range(L):
                    for slot in (ATTN_SLOT, MLP_SLOT):
                        epoch = base + layer_round(l, slot)
                        key = (id(bufs), slot)
                        assert epoch not in seen[id(bufs)]
                        assert epoch > last[key] >= 0
                        assert base < epoch <= base + 2 * L
                        seen[id(bufs)].add(epoch)
                        last[key] = epoch
    for bufs in (decode, verify):
        assert sorted(seen[id(bufs)]) == list(range(1, 2 * 4 * 2 * L + 1))
        assert bufs.rounds == 2 * 4 * 2 * L


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fused_consumer_plain_is_reduce_then_norm(p, dtype):
    """The fused consumer's plain version against the JAX package's
    reduce-then-norm in jnp, bit for bit: the partial sums in rank order
    added into K10's bf16 residual at the TPU kernel's rounding point
    (``h += tot.astype(bfloat16)``, ``ops/fused_decode.py``'s
    ``allreduce_into_h``) or into K9's f32 residual, then the next half's
    RMSNorm (``ops/fused_decode_tp._rmsn``); every rank's residual and
    norm equal.  A bf16 residual rounded once, ``bf16(h + tot)``, differs
    on these inputs, so the case sees the rounding point.  Without a weight
    it writes no norm."""
    from desta25_audio_tpu_torch.ops.tp_allreduce import (
        allreduce_rmsnorm_plain)
    rng = np.random.default_rng(10 + p)
    parts = [(rng.standard_normal((3, 256))
              * 10.0 ** rng.integers(-2, 2)).astype(np.float32)
             for _ in range(p)]
    h = torch.from_numpy(rng.standard_normal((3, 256)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(256).astype(
        np.float32)).bfloat16()
    hs, xns = allreduce_rmsnorm_plain([torch.from_numpy(x) for x in parts],
                                      [h.clone() for _ in range(p)], w, 1e-5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tot = jnp.asarray(parts[0])
    for x in parts[1:]:
        tot = tot + jnp.asarray(x)
    jh = jnp.asarray(h.float().numpy()).astype(jdt) + tot.astype(jdt)
    jxn = jtp._rmsn(jh, jnp.asarray(w.float().numpy()).astype(
        jnp.bfloat16)[None], 1e-5)
    want_h = np.asarray(jh.astype(jnp.float32))
    for r in range(p):
        assert hs[r].dtype == dtype and xns[r].dtype == torch.bfloat16
        np.testing.assert_array_equal(hs[r].float().numpy(), want_h)
        np.testing.assert_array_equal(xns[r].float().numpy(),
                                      np.asarray(jxn.astype(jnp.float32)))
        assert torch.equal(hs[r], hs[0]) and torch.equal(xns[r], xns[0])
    once = (h.float() + torch.from_numpy(np.array(tot))).to(dtype)
    assert torch.equal(once, hs[0]) == (dtype == torch.float32)
    bare, none = allreduce_rmsnorm_plain([torch.from_numpy(x) for x in parts],
                                         [h] * p)
    assert none is None and torch.equal(bare[0], hs[0])


def test_mesh_spec_trajectory_matches_jax(towers, monkeypatch):
    """Speculative greedy decode under a (1, 2) mesh through the
    tensor-parallel verify step (pick_verify_fn on both sides): the same
    ids as JAX's, and as the port's unsharded plain greedy run."""
    from desta25_audio_tpu.generate.speculative import (
        llm_generate_spec as j_spec,
    )
    jcfg, tcfg, qp, tp = towers
    jax_tpu_dispatch(monkeypatch)
    B, T, NEW, Kd = 2, 12, 8, 3
    ids = np.random.default_rng(21).integers(2, 500, size=(B, T))
    amask = np.ones((B, T), np.int32)
    jm, tm = _meshes(1, 2)
    try:
        with jpm.use_mesh(jm):
            sh = apply_sharding(qp, llm_partition_specs(qp))
            want, want_n = j_spec(
                sh, jcfg, sh["embed"][jnp.asarray(ids)], jnp.asarray(amask),
                max_new_tokens=NEW, eos_ids=(), pad_id=0, speculative_k=Kd,
                prompt_ids=jnp.asarray(ids),
                prompt_lens=jnp.full((B,), T, jnp.int32))
        want = np.asarray(want)
    finally:
        jax.clear_caches()
    emb = tllm.embed_tokens(tp, torch.from_numpy(ids))
    gen = torch.Generator().manual_seed(0)
    plain, _ = llm_generate(tp, tcfg, emb, torch.from_numpy(amask), gen,
                            max_new_tokens=NEW)
    calls = []
    real = tmesh.fused_verify_layers_mesh
    monkeypatch.setattr(tmesh, "fused_verify_layers_mesh",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with tpm.use_mesh(tm):
        got, _ = llm_generate_spec(
            apply_llm_sharding(tp, tcfg, tm), tcfg, emb,
            torch.from_numpy(amask), gen, max_new_tokens=NEW,
            speculative_k=Kd, prompt_ids=torch.from_numpy(ids))
    assert calls
    assert got.tolist() == want.tolist() == plain.tolist()


def test_dryrun_f32_generate_on_a_2x2_mesh():
    """tests/test_sharded_generate.py:24-46 for the port: the f32
    test/llama-dryrun LLM under a (2, 2) mesh (its layer loop: the fused
    steps take int8 or bf16 towers) gives the unsharded ids."""
    cfg = llm_config_for("test/llama-dryrun")
    tp = tllm.init_llm(cfg, torch.float32, "cpu",
                       torch.Generator().manual_seed(0))
    ids = np.random.default_rng(0).integers(5, cfg.vocab_size - 5,
                                            size=(2, 8))
    emb = tllm.embed_tokens(tp, torch.from_numpy(ids))
    amask = torch.ones(2, 8, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    ref, _ = llm_generate(tp, cfg, emb, amask, gen, max_new_tokens=6)
    tm = tpm.make_mesh(2, 2, ["cpu"] * 4)
    with tpm.use_mesh(tm):
        sp = apply_llm_sharding(tp, cfg, tm)
        assert "neither int8 nor bf16" in tmesh.fused_mesh_limits(
            sp, cfg, 2, 128)[0]
        got, _ = llm_generate(sp, cfg, emb, amask, gen, max_new_tokens=6)
    assert got.tolist() == ref.tolist()


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from desta25_audio_tpu_torch.audio.io import write_wav
    t = np.arange(16000) / 16000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "tone.wav")
    write_wav(path, sig)
    return path


def test_model_generate_under_a_mesh(wav):
    """DeSTA25AudioModel.apply_llm_sharding, then generate() under the
    mesh, plain and speculative: the unsharded model's greedy ids; the
    cut LLM is kept, and a second cut for the mesh is a no-op."""
    from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
    from test_torch_int8_llm import NANO
    cfg = DeSTA25Config(**dict(NANO, llm_model_id="test/llama-nano128"))
    model = DeSTA25AudioModel(cfg, device="cpu", seed=0)
    msgs = [[{"role": "user", "content": "What is it? <|AUDIO|>",
              "audios": [{"audio": wav, "text": "a tone"}]}]] * 2
    want = model.generate(msgs, max_new_tokens=5, do_sample=False)
    tm = tpm.make_mesh(1, 2, ["cpu"] * 2)
    model.apply_llm_sharding(tm)
    cut = model.params["llm"]
    model.apply_llm_sharding(tm)
    assert model.params["llm"] is cut and cut.mesh is tm
    with tpm.use_mesh(tm):
        got = model.generate(msgs, max_new_tokens=5, do_sample=False)
        spec = model.generate(msgs, max_new_tokens=5, do_sample=False,
                              speculative_k=3)
    assert got.generated_ids == want.generated_ids
    assert spec.generated_ids == want.generated_ids
    assert model.last_spec_fallback == []
    bf = DeSTA25AudioModel(dataclasses.replace(cfg, llm_quant="none"),
                           device="cpu", seed=0)
    bf.apply_llm_sharding(tm)
    with pytest.raises(ValueError, match="apply_llm_quant before"):
        bf.apply_llm_quant()


@pytest.mark.parametrize("T,tol", [(40, TOL), (100, 1e-4)],
                         ids=["k7-rows", "w8a8-rows"])
def test_mesh_prefill_matches_unsharded(towers, T, tol):
    """The prefill under a (1, 2) mesh (the per-rank layer loop) against the
    unsharded one, int8 tower.  At B*T = 80 rows, K7: the ranks' f32 sums
    reassociate the unsharded sum, and the bf16 roundings after them can
    flip (TOL).  At 200 rows, the W8A8 GEMM: exact int32 sums, and the wo /
    down inputs quantized with each row's amax over both ranks' columns, as
    XLA does for the JAX package's sharded prefill: within 1e-4 of the
    logit scale (a rank-local amax lands at 2.8e-2)."""
    _, tcfg, _, tp = towers
    ids = torch.from_numpy(np.random.default_rng(T).integers(
        2, 500, size=(2, T)))

    def logits(params):
        cache = tllm.init_kv_cache(tcfg, 2, 256, torch.bfloat16, "cpu")
        return tllm.llm_apply(params, tcfg, input_ids=ids,
                              attention_mask=torch.ones(2, 256,
                                                        dtype=torch.int32),
                              cache=cache, cache_index=0)[0]
    want = logits(tp)
    tm = _meshes(1, 2)[1]
    with tpm.use_mesh(tm):
        got = logits(apply_llm_sharding(tp, tcfg, tm))
    assert float((got - want).abs().max() / want.abs().max()) < tol
