"""The port's serving engine under a mesh (``serve/engine.py`` with the
model's LLM cut by ``apply_llm_sharding``) on the CPU: the counterpart of
tests/test_serving.py's tensor-parallel case, which the JAX package skips
without 8 devices.  The nano int8 model of the speculative cases
(``test/llama-nano128``, bf16) on meshes of CPU ranks, (1, 2) and (2, 2):
greedy ``results()`` equal the unsharded engine's, pipelined and
sequential, with speculative ticks under the (1, 2) mesh, and for the ORCA
nano model with its int8 stack (the injection inside the tensor-parallel
step).  The decode steps are ``MeshStep``'s plain version on the CPU, the
prefill the sharded layer loop; the admissions' rows are copied into their
slots' shards across data rows.

Equality is exact where the rows' greedy ids sit clear of a near-tie.  The
ranks' f32 partial sums and the CPU's products at a data row's smaller
batch reassociate the unsharded sums, so a row may part from the
unsharded engine's at a position whose two candidates lie within TOL_TIE
of each other in the unsharded model's teacher-forced forward over the
shared prefix; past that point the two rows decode different contexts and
are not compared.  A control that places each admission into the other
slot's shards must fail that check.
"""

import numpy as np
import pytest
import torch

from desta25_audio_tpu_torch import DeSTA25AudioModel, DeSTA25Config
from desta25_audio_tpu_torch.audio.io import write_wav
from desta25_audio_tpu_torch.models import llm as tllm
from desta25_audio_tpu_torch.ops import _build
from desta25_audio_tpu_torch.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu_torch.parallel.sharding import ShardedCache
from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

SPEC = dict(llm_model_id="test/llama-nano128",
            encoder_model_id="test/whisper-nano", prompt_size=8,
            qformer_num_hidden_layers=2, dtype="bfloat16", llm_quant="int8")
ORCA = dict(SPEC, connector_mode="orca_hybrid", orca_global_num_tokens=4,
            orca_local_downsample=4, orca_local_kernel_size=5,
            orca_audio_position_scale=2.5)
MAX_NEW = 6
# a near-tie: the two candidates' logits within 2 % of a nano logit's scale
# (~1.5) in the unsharded forward
TOL_TIE = 0.03


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    paths = []
    for i in range(3):
        t = np.arange(12000) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * (300 + 80 * i) * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        p = str(d / f"w{i}.wav")
        write_wav(p, sig)
        paths.append(p)
    return paths


def _msgs(path, i):
    return [{"role": "user",
             "content": f"Describe sound number {i}: <|AUDIO|>",
             "audios": [{"audio": path, "text": f"tone {i}"}]}]


def _model(kw, seed=0):
    m = DeSTA25AudioModel(DeSTA25Config(**kw), device="cpu", seed=seed)
    if "orca_hybrid" in kw.values():
        m.apply_orca_xattn_quant()
    return m


def _run(model, reqs, mesh=None, **kw):
    """Five requests through 2 slots (slot reuse, an admission of one row
    and of two); returns (results, engine)."""
    args = dict(n_slots=2, max_ctx=64, max_new_tokens=MAX_NEW,
                ctx_bucket=64, steps_per_tick=2, **kw)
    if mesh is None:
        eng = ContinuousBatchingEngine(model, **args)
    else:
        with use_mesh(mesh):
            eng = ContinuousBatchingEngine(model, **args)
    rids = [eng.submit(q) for q in reqs]
    eng.run_until_done()
    res = eng.results()
    return [res[r] for r in rids], eng


def tie_gap(model, msgs, prefix, a: int, b: int) -> float:
    """|logit a - logit b| of the unsharded model's greedy forward after the
    request's bucketed prompt (64 positions) and the ids ``prefix``: the
    prompt in one call, the ids in a second on the same cache."""
    llm, cfg = model.params["llm"], model.llm_cfg
    emb, am, _, _ = model._prepare_generation_inputs([msgs])
    T = 64
    emb = torch.nn.functional.pad(emb, (0, 0, T - emb.shape[1], 0))
    am = torch.nn.functional.pad(am, (T - am.shape[1], 0))
    S = 128
    mask = torch.zeros(1, S, dtype=torch.int32)
    mask[0, :T] = am[0]
    mask[0, T:T + len(prefix)] = 1
    pos = torch.clamp(torch.cumsum(mask[:, :T], 1) - 1, min=0)
    cache = tllm.init_kv_cache(cfg, 1, S, torch.bfloat16, "cpu")
    lg, cache = tllm.llm_apply(llm, cfg, inputs_embeds=emb,
                               attention_mask=mask, positions=pos,
                               cache=cache, cache_index=0)
    lg = lg[0, -1]
    if prefix:
        lg = tllm.llm_apply(
            llm, cfg, input_ids=torch.tensor([prefix]), attention_mask=mask,
            positions=int(pos[0, -1]) + 1 + torch.arange(len(prefix))[None],
            cache=cache, cache_index=T)[0][0, -1]
    return float((lg[a] - lg[b]).abs())


def check_rows(ref_model, reqs, got, want) -> int:
    """Every row equals the unsharded engine's, or parts from it at a
    near-tie (module docstring); returns the count of rows that part (a
    row that parts finishes at another tick, which changes the batches the
    later rows are admitted and decoded in)."""
    parted = 0
    for msgs, g, w in zip(reqs, got, want):
        if g == w:
            continue
        gt, wt = g["tokens"], w["tokens"]
        j = next((i for i, (x, y) in enumerate(zip(gt, wt)) if x != y),
                 None)
        assert j is not None, (g, w)   # a row may not stop at a prefix
        gap = tie_gap(ref_model, msgs, wt[:j], gt[j], wt[j])
        assert gap < TOL_TIE, (j, gt, wt, gap)
        parted += 1
    return parted


@pytest.fixture(scope="module")
def ref_model():
    return _model(SPEC)


@pytest.fixture(scope="module")
def reqs(wavs):
    return [_msgs(wavs[j % 3], j) for j in range(5)]


@pytest.fixture(scope="module")
def unsharded(ref_model, reqs):
    """The unsharded engine's greedy results, pipelined and not."""
    return {p: _run(ref_model, reqs, pipeline_ticks=p)[0]
            for p in (True, False)}


@pytest.fixture(scope="module")
def cut_models():
    """One model a mesh shape, its LLM cut for it."""
    out = {}
    for shape in ((1, 2), (2, 2)):
        mesh = make_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))
        m = _model(SPEC)
        m.apply_llm_sharding(mesh)
        out[shape] = (m, mesh)
    return out


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mesh_engine_matches_unsharded(cut_models, ref_model, reqs,
                                       unsharded, shape, pipeline):
    model, mesh = cut_models[shape]
    _build.reset_launch_counts()
    got, eng = _run(model, reqs, mesh, pipeline_ticks=pipeline)
    assert check_rows(ref_model, reqs, got, unsharded[pipeline]) <= 2
    assert isinstance(eng.cache, ShardedCache) and eng.mesh is mesh
    assert eng.cache.shape[1:3] == (2, eng.t_max)
    assert len(eng.cache.shards) == shape[0]
    assert eng.graph is not None          # K10's step, the plain version
    assert _build.fallback_counts().get("fused_decode_layers", 0) == 0


def test_mesh_engine_speculative_matches_unsharded(cut_models, ref_model,
                                                   reqs, unsharded):
    model, mesh = cut_models[(1, 2)]
    got, eng = _run(model, reqs, mesh, speculative_k=3, adaptive_spec=False)
    assert eng.speculative_k == 3 and eng.vgraph is not None
    assert eng.vgraph.stepper.name == "fused_verify_layers_mesh"
    assert eng._n_spec_ticks > 0 and eng._n_plain_ticks == 0
    assert check_rows(ref_model, reqs, got, unsharded[True]) <= 2


def test_mesh_engine_gate_control(cut_models, ref_model, reqs, unsharded,
                                  monkeypatch):
    """Control: admissions copied into the other data row's slot (the
    slots reversed in the shards' copy) must fail the rows' check."""
    model, mesh = cut_models[(2, 2)]
    place = ContinuousBatchingEngine._place_sharded

    def swapped(self, slots, sl, pcache, inj_k, inj_v):
        return place(self, [self.n_slots - 1 - s for s in slots], sl,
                     pcache, inj_k, inj_v)

    monkeypatch.setattr(ContinuousBatchingEngine, "_place_sharded", swapped)
    got, _ = _run(model, reqs, mesh)
    with pytest.raises(AssertionError):
        check_rows(ref_model, reqs, got, unsharded[True])


def test_mesh_engine_orca_matches_unsharded(wavs):
    """The ORCA nano model with its int8 stack under a (1, 2) mesh: the
    injection inside the tensor-parallel step, per slot."""
    orca = [_msgs(wavs[j % 3], j) for j in range(3)]
    orca.append([{"role": "user", "content": "Say hello."}])
    want, ref = _run(_model(ORCA, seed=4), orca)
    assert ref._fspec is not None
    mesh = make_mesh(1, 2, ["cpu"] * 2)
    m = _model(ORCA, seed=4)
    m.apply_llm_sharding(mesh)
    got, eng = _run(m, orca, mesh)
    assert eng._fspec is not None and eng.graph is not None
    assert got == want


def test_mesh_engine_refusals(cut_models):
    model, mesh = cut_models[(2, 2)]
    with use_mesh(mesh):
        with pytest.raises(ValueError, match="split"):
            ContinuousBatchingEngine(model, n_slots=3, max_ctx=64,
                                     max_new_tokens=4)
        with pytest.raises(ValueError, match="cut for it"):
            ContinuousBatchingEngine(_model(SPEC), n_slots=2, max_ctx=64,
                                     max_new_tokens=4)
