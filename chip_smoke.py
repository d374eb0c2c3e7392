#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. print the environment (GPU name and power limit from nvidia-smi, torch
   and CUDA versions, nvcc version, whether triton imports);
2. require CUDA (no CPU fallback);
3. build the hand-written kernels from ``desta25_audio_tpu_torch/csrc`` with
   nvcc for sm_90a;
4. hold each kernel against its plain PyTorch version on the card at the
   shapes of the flagship path, with CUDA-event times of both:
   K1 log_mel (a real FFT and a sparse filterbank; after the clip-wide
   clamp: B=2 x 3000 frames x 128 mels and B=1 x 300 x 80 of noise plus a
   tone within TOL_MEL, the two synthetic WAVs of phase 6, written first,
   zero-padded to 30 s within TOL_MEL_WAV; two launches bit-identical; its
   times queued at B=1, 2, 4 x 3000 x 128 beside ``torch.stft`` + the
   filterbank + log10 (information); both versions' times at B=1, 2, 4 for
   mel's share of perception after phase 11), K2 packed_encoder_attention
   (self: B=2, T=1500, H=20, Dh=64; cross:
   4 taps x B=2, Tq=64, Tkv=1500, its keys split across blocks; each with
   its achieved TFLOP/s and share of the bound beside
   ``scaled_dot_product_attention``'s time; K2's and K11's times also
   printed, as information, taken behind a sleep kernel (``queued``), so
   that they are the card's and not the Python launch path's; the kernels
   line keeps the back-to-back event times of every kernel), K3
   encoder_ffn (D=1280, F=5120 at M=1500, 3000, 6000 and a ragged 257,
   beside a control, fc2's last k-tile dropped, that must read above
   TOL_ENC), K8 fused_decode_layers (Llama-3.1-8B, B=2, S=256 cache with
   random contents and a different cache index per row), and the W8A8
   kernels K5 qkv_w8a8, K6 proj_w8a8 and K4 encoder_ffn_w8a8 at the same
   rows (D=1280, F=5120), plus K4 on weights whose GELU chunks differ 64x
   in scale (the per-1280-column quantisation), each bit-identical to its
   plain version; K3-K6 on the Hopper GEMM of csrc/gemm_sm90.cuh, their
   times back-to-back and queued;
5. build the flagship model (configs/desta25_llama31-8B_Qformer6L.yaml:
   Llama-3.1-8B + whisper-large-v3 + 6-layer Q-Former, bf16) on the card
   with random weights from a seed, with the hub-free CharTokenizer;
6. write two synthetic 16 kHz WAVs of different lengths;
7. with the bf16 encoder, after one short warm-up call, ``generate()`` a
   batch of 2 conversations (transcriptions supplied, greedy, 32 new
   tokens), then a batch of 1;
8. require that K1, K2, K3 and K8's launch counters moved during
   ``generate()`` and that no model shape took a torch path
   (``_build.fallback_counts()`` empty, as in 11 and 15), that the
   generated ids are well formed, and that the
   spliced embeddings, the prefill logits and one decode step's logits of
   the batch-2 input, computed step by step, are finite and give
   ``generate()``'s first two tokens;
9. print per-phase times (host clock, device synchronised);
9b. ``generate()`` at b2 once more both ways: eagerly
    (``llm_generate(decode_graph=False)``) and through the decode step's
    CUDA graph (the default, ``generate/graph.py``, which every
    ``generate()`` of 7, 11, 15 and 19 takes: each must count one
    ``decode_graph`` replay for each decode step after the first): the ids
    identical, every sampled step's logits bit-identical, the other launch
    counts equal; ms a step both ways, the capture time, and the device
    time of a step (the graph's replays and the eager step, queued);
10. switch the same model to the JAX package's inference encoder
    (``apply_inference_encoder_quant()``: int8 FFN, "dual" attention
    leaves); hold encoder layers 0 and 31 through the kernels against the
    plain versions; print the int8-vs-bf16 taps difference (information)
    and the encoder forward times of both attention arms at B=1, 2, 4; K1
    must launch in every generate() and train step from here on;
11. ``generate()`` at b2 and b1 (int8 attention arm: K5, K2, K6 and K4
    launch, K3 does not) and at b4 (bf16 attention arm: K2 and K4 launch,
    K5 and K6 do not), K4 three launches a call; the b2 path step by step
    as in 8;
12. print the int8 encoder's per-phase times;
12a. Whisper ASR in ``generate()`` (the flagship's decoder, 32 layers,
    drawn with the model; a character detokenizer, ids below 128, in place
    of the BPE files the repo lacks): b2 and b1 without transcriptions on
    the int8 encoder and b2 on the bf16 encoder (kept from phase 9 and
    swapped in for the call), greedy, 32 new tokens, each beside the same
    call with transcriptions: every encoder kernel (K1, K2, K3 or K4-K6)
    launches as often as there plus one mel and encoder pass at the same
    batch (K1 and the encoder-only kernels twice), no shape takes a torch
    path, at least one decoder step runs; transcripts and the phases'
    times printed, ``asr_ms``, ``asr_steps`` and ms a decoder step among
    them, with the time to the first token; a silent clip takes " "
    without ASR;
12b. the decoder's cached steps against its full forward over the prefix
    and the emitted ids: a 2-layer f32 copy on the encoder's output within
    TOL_ASR_CACHE, beside a control (every cached call writing its keys
    one slot late) that must read above it; the 32-layer bf16 decoder's
    emitted ids against the teacher-forced argmax (information, with the
    top-2 margins where they part);
12c. the fallback cascade at b2 (``asr_fallback``, temperatures 0.0 and
    0.6): the rows retried printed, two calls identical;
12d. the feature cache (``enable_audio_cache()``): the same b2 call twice;
    the second launches no perception kernel, runs no ASR step and gives
    the first's ids;
12e. a 65 s clip without a transcription, ``auto_chunk_long_audio=True``:
    three clips, their temporary WAVs removed;
12f. the serving engine (``serve/engine.ContinuousBatchingEngine``) on
    the bf16 tower: 4 slots, 8 steps a tick, 4 greedy requests of 32 new
    tokens: the decode steps are replays of one graph captured once (K8's
    launches those of every step, one ``decode_graph`` replay for each
    step but the first), no torch path, and the teacher-forced gate: each
    emitted id is the argmax of a forward over the request's own bucketed
    prompt and its emitted ids (fed back one at a time through the layer
    loop, none of the engine's decode kernels), or within
    TOL_ENGINE_MARGIN of it, the
    margins printed, beside a control (each row's ids on the next row's
    prompt) that must fail it; the model's feature cache, which the engine
    turns on, is turned off again after each engine phase;
13. the int8 LLM's kernels against their plain versions, on the model's LLM
    quantized into a second tree (``quantize_llm_params``): K7
    quant_matmul at M=2 on the head (N=130560, the skinny GEMM) and its
    wgmma path (``quant_matmul_prefill``) at M=125, 17, 33, 64, 65, 100,
    121 and 127 on each layer shape (f32 within TOL_QMM, bf16 the f32 sum
    rounded once, two launches bit-identical, the plain version with one
    rank's k-range dropped above the gate; its plan equal to the C twin's
    and its cluster waves to the card's occupancy; the M=121 times over
    the 32 layers' weights, so each call finds its weight out of the L2,
    beside ``torch._weight_int8pack_mm``'s), the W8A8 prefill GEMM at
    M=250 on each layer shape and the head
    and at M=129 and 1500 on each layer shape (both in f32, gated at
    TOL_QMM; W8A8 bit-identical), K8 with the int8 stream (32 layers,
    B=2, S=256, per-row ci) and the verify step K8v (Kd=4, B=2, one row's
    block ending at S) on the bf16 and the int8 tower, gated as K8; K9, the
    per-layer decode pair, on the int8 tower (32 layers, B=2, S=256, ci=
    (100, 200)): each layer's attention and MLP half against plain, 2- and
    32-layer logits through its layer loop, gated as K8, and layer 0 at the
    p=2 and p=4 shard shapes (each rank against plain, the ranks' partials
    summed against p=1), the halves' and the step's queued times; its q/k/v
    and gate/up products (the norm kernel on f32 rows, then the skinny
    GEMM) at B=1, 2, 3, 8, 16 and 32 against plain, the norm bit-identical
    to that of the rows cast to bf16; the K8 family's attention launch alone
    (``decode_attention``, csrc/decode_attention.cuh: keys split across a
    thread-block cluster, TMA tiles) against ``decode_attention_plain`` at
    Llama-3.1-8B's heads: B=2, S=256, ci=(100, 200) at Kd=1 and 4, B=2,
    S=4096, ci=(3000, 4095), B=8, S=1024, G=8 and qk-norm, gated at
    TOL_DECODE beside a control (the first key range dropped) that must
    read above it, two launches bit-identical, the C side's plan equal to
    ``plan_decode_splits``; its times back-to-back and queued behind a
    sleep kernel, the bound and SDPA over the cached keys alone
    (information);
14. quantize the model's own LLM in place (``apply_llm_quant``);
15. ``generate()`` with the int8 LLM (and the int8 encoder) at b2 and b1
    (the 121-token conversation), greedy, 32 new tokens: W8A8 (b2
    prefill, M = 296), K7 (b1 prefill at M = 121, every decode step's
    head) and K8-int8 must launch, the bf16 K8 must not, the decode
    attention once for each 7 K8-int8 launches (its kernel count, the
    JSON line's launches); the b2 path step by step as in 8; 15b. the
    b2 call both ways, as in 9b;
16. ``generate(speculative_k=4)`` at b2 on the int8 tower: K8v must
    launch; the first verify step's position-0 logits against one K8-int8
    step on the same cache, within TOL_DECODE; verify steps, tokens per
    step, ms per emitted token and the agreement with 15's greedy ids are
    printed (information);
16a. the engine on the int8 encoder and LLM: 16 slots, 8 steps a tick,
    ``max_ctx`` 256 and 64 new tokens (a 384-position cache), 24 requests
    (12 through one ``submit_many``, 12 submitted while the first decode;
    every other one sampled at 0.7 / 0.9; two text-only): replays of one
    graph as in 12f with K8-int8 inside and not the bf16 K8, every request
    finished with ``length`` or ``eos``, the greedy rows through the gate
    (and, as information, through two other references: the ids in one
    call, and one at a time through the fused step); ticks, tokens/s and the time to the first token (p50, p90, submit to
    first token) printed;
16b. 8 greedy requests of 24 tokens: the same ids with pipelining off,
    with one step a tick, and through ``submit`` instead of
    ``submit_many``, each engine capturing once;
16c. 4 slots under pipelining: a running request cancelled (its tokens so
    far kept), a newcomer admitted into its slot and through the gate;
    then a slot forced to ``t_max - 3`` ends ``cache_full`` with no device
    error;
16d. the engine's decode tick alone at 8, 16 and 32 busy slots
    (``bench_serving.serving_ticks``): ms a tick, tokens/s, device time a
    tick and idle share, the step's kernels against the sampling and glue,
    the graph's replay alone, the step's byte bound;
16e. the spec engine (``speculative_k=4``, ``adaptive_spec=False``) at 4
    and 16 slots, 32 greedy tokens a request: its verify steps replays of
    one verify graph captured once, K8v at B = n_slots and its launches
    those of every verify step, K8-int8 not launched, no torch path; the
    gate per row; ms a tick, tokens a verify step and tokens/s beside the
    plain engine's; at 4 slots a drafter that proposes the plain engine's
    own ids must accept more than one token a step (mean > 1.5, max 4),
    its rows through the gate; then the spec tick alone beside the plain
    one (``bench_serving.spec_ticks``: T_spec / T_plain, the verify
    replay, the byte bound);
16f. 16a's arrival run on the adaptive spec engine (the defaults,
    ``speculative_k=4``): the tick mix, the controller's tick-duration
    EMAs, each graph captured at most once, the greedy rows through the
    gate;
16g. the HTTP front end (``serve/http.start_http``) on the int8 engine at
    8 slots: 8 concurrent clients (4 on /v1/generate, 4 on
    /v1/chat/completions, inline base64 WAVs, 2 streaming), health during
    them, then a streaming request cancelled by its id
    (``DELETE /v1/requests/<id>``); every answer an engine result, every
    row through the gate; the time to the first SSE token and to the
    whole answer, p50 / p90;
17. K8i, the decode / verify step with the ORCA injection inside, against
    its plain version: the 32-layer int8 Llama-3.1-8B tower with a random
    int8 cross-attention stack, B=2, S=256, per-row ci, Ta=375 audio
    tokens, on=[1, 1], at Kd=1 and Kd=4 (injection head dim 128), and a
    2-layer Qwen3-4B tower (D=2560, H=32, qk-norm: head dim 80) at Kd=1 and
    Kd=4, gated as K8; the K8-int8 step time without injection beside;
    then K8i's two kernels alone (csrc/fused_inject.cu): the attention
    (keys split across a thread-block cluster) against
    ``inject_attention_plain`` at Ta=375, Llama-3.1-8B's heads at b2, b1
    and the b2 verify (Kd=4), Qwen3-4B's at b2 and its verify, its C-side
    plan the planner's, a control (one tile of 8 keys dropped, the last of
    the first range) above the gate, two launches and the verify rows'
    token 0 bit-identical to the decode launch; the gate's added term
    (out - h) against ``inject_gate_plain``'s at R=2 and 8 of D=4096 and 2
    of 2560, a row with on=0 keeping h's bits; both within TOL_INJECT,
    their times back to back and queued, the plain versions', the bound,
    and SDPA beside the attention;
18. the ORCA model (configs/desta25_llama31-8B_ORCAHybrid.yaml: 2-layer
    global Q-Former, 64 global tokens, local branch, injection in all 32
    layers), sharing the model's int8 encoder and int8 LLM, connector and
    f32 stack random from a seed: ``generate()`` at b2 with the float stack
    (injection in PyTorch: K8i must not launch); again with the per-layer
    opt-in (``ops/fused_decode_tp.FUSED_PERLAYER``): K9's halves must launch
    and K8i / K8-int8 must not, one ``decode_graph`` replay for each decode
    step after the first (``generate/graph.PerLayerStep``), the path step
    by step as in 8, ms/step beside the layer loop's, and the call both
    ways as in 9b (ids and every step's logits bit-identical to
    ``decode_graph=False``'s, decode wall and device ms a step); then
    ``speculative_k=4`` on the float stack must fall back to that loop (no
    verify launch, the same ids); then ``apply_orca_xattn_quant()``;
19. ``generate()`` at b2 and b1, greedy, 32 new tokens: K8i (its
    attention and gate counted by their own names), K8-int8, K7, W8A8, K2
    and K4 must launch, no shape may take a torch path (as in 11 and 15,
    K8i included); the b2 path step by step as in 8 (the
    prefill through the PyTorch injection hook, the decode step through
    K8i); the b2 call both ways, as in 9b, K8i inside the graph; 19b. one
    b2 call with ASR, K8i launched, its times as in 12a;
20. ``generate(speculative_k=4)`` at b2: the verify step with injection
    must launch; its first step's position-0 logits against one K8i decode
    step on the same cache, within TOL_DECODE, the hidden states bit for
    bit;
20d. the engine on the ORCA model (int8 stack and LLM): 4 slots, 3 audio
    requests (one ``submit_many``) and a text-only one (``on`` = 0): K8i
    inside the graph's replays (its launches and its attention's those of
    every step), the gate per row with the injection through the PyTorch
    hook; 20e. the same with ``speculative_k=4`` on every tick: K8i inside
    the verify graph's replays, the gate per row;
20a. the all-reduce of tensor-parallel partial sums (``tp_allreduce``,
    ``csrc/tp_allreduce.cu``: the consumer adds the ranks' sum into the
    residual and writes the next half's RMSNorm) alone, at p = 2 and 4
    virtual ranks of the card, R = 2 and 8 rows of D = 4096, bf16 and f32
    residuals: every rank's int8 peer-store GEMM (the wo shape at p) into
    every rank's buffer, then every rank's consumer; every rank's residual
    bit-identical to ``allreduce_rmsnorm_plain``'s and its norm to the step's
    norm kernel's on that residual (bf16; within TOL_DECODE of
    ``rms_plain``), 10 rounds on one stream and 200 with a stream per rank;
    then 60 rounds replayed from one CUDA graph per card (the epochs on the
    device advance: the flags at each replay's new epochs, the results bit
    for bit), and a control, a replay whose producer is skipped, which sets
    the error words and raises at the end instead of hanging; the
    consumer's time (queued beside the consumer without the norm plus the
    norm kernel), the plain version's, the bound, NCCL's all-reduce of the
    same partials on cards;
20b. the prefill under a (1, 2) mesh against the unsharded one: layer 0's
    wo / down products at M = 296 (W8A8) and M = 100 (K7) within
    TOL_MESH_QMM, each beside a control (a rank-local amax, a dropped
    partial) that must read above it; where the 2-layer prefills part
    (layer 0's q/k/v, heads, wo output; information); the 2-layer logits
    within TOL_MESH_PREFILL; then K10 (``fused_decode_layers_mesh``) against its
    plain version on the model's int8 LLM at p = 2 and 4: 2 layers within
    TOL_MESH (the control, a dropped partial, above it), the written cache
    rows, every rank's residual equal bit for bit, one stream and a stream
    per rank equal, and at p = 2 against the unsharded K8-int8 step; 32
    layers as information (error, ms/step eagerly both ways and as the
    replay of one CUDA graph per card of ``MeshStep``, the replay's hidden
    bit-identical to the eager step's, plain, bound); Kd = 4
    verify, K8i with a random int8 ORCA stack, a random 2-layer bf16 tower
    at p = 2, and a (2, 2) mesh (a "data" axis), gated alike;
20c. the model's int8 LLM cut for a (1, 2) mesh of virtual ranks
    (``apply_llm_sharding``): ``generate()`` b2 under ``use_mesh``, greedy,
    32 new tokens: K10, ``tp_allreduce`` and ``decode_graph`` (one graph a
    card a step after the first) launch, K8-int8 does not; the same call
    with every step eager: ids and every step's logits bit-identical to the
    graph's, the same launch counts, ms/step both ways and the step's
    device time; the teacher-forced per-step logits against the unsharded
    LLM's within TOL_MESH_GEN (the control, a dropped partial, above it);
    ms/step beside an unsharded run's (virtual ranks share one card: no
    tensor-parallel speed); ``speculative_k=4`` under the mesh
    launches the tensor-parallel verify step; 20f. the serving engine
    under the mesh at 4 slots, plain ticks and then every tick
    speculative: one graph a card of K10 (then of its verify step)
    captured once, ``tp_allreduce`` launched, the unsharded kernels not,
    the error words read once a tick, each engine's rows through the gate
    on the unsharded LLM beside the one-card engine's ms a tick; the cut
    copy is freed;
21. K11, the flash attention of the training forward, forward and backward
    against ``flash_attention_plain`` (output and dq/dk/dv, all rows, tol
    TOL_FLASH) at B=4, T=512, H=32, Hkv=8, Dh=128, causal, one row
    right-padded from 400, and at T=520; CUDA-event times of the forward,
    the backward, the plain version's and ``scaled_dot_product_attention``'s
    (unpadded, ``enable_gqa``), the bound, each kernel's achieved TFLOP/s
    and share of the bound, and the same times queued behind a sleep
    kernel (information, as in 4); the backward must give the same bits on two
    runs; then, as information, K11 forward and forward+backward against
    the masked path (``ops/core.mha``) at the flagship train shape B=12,
    T=300 (where the dispatch takes the masked path);
22. free the serving models; build the flagship training model fresh in
    bf16 (random weights, seed 3) and write a synthetic corpus (12 WAVs and
    a jsonl manifest of the reference schema);
23. ``DeSTA25Trainer.train()`` for 3 steps at B=4, ``max_seq_length=512``
    with ``gradient_checkpointing`` (remat) on, Adafactor with a 2-step
    warm-up, then ``evaluate()`` on one batch: K11 forward and backward, K2
    and K3 launch on every step, K8 during eval generation; losses and
    ``grad_norm`` finite, ``grad_norm`` > 0; the trainable tree unchanged
    by step 1 (lr 0) and changed by step 3; no frozen leaf requires or holds
    a gradient;
24. two train steps at the flagship config's own shape, B=12, T=300: K11
    must not launch (the JAX dispatch takes it at T >= 512 only);
24b. the same model's tower quantized in place (``apply_llm_quant()``),
    the params split again, two train steps at B=12, T=300 (the JAX
    package's train setting): K1, K2 and K3 launch, the W8A8 GEMM does not
    (training's ``w8a8=False``), the loss finite, ``grad_norm`` > 0 and
    finite, the trainable tree moved; the torch paths taken are printed
    (K7's math as one library product at 128-256 rows counts as
    ``quant_matmul_dequant``).
    23, 24 and 24b print ms/step, tokens/s and the peak device memory
    beside the card's name and power limit;
25. the shipped configs/desta25_debug.yaml (whisper-nano Dh 32, llama-nano
    Dh 16, float32, random weights from a seed): greedy ``generate()`` at b2
    and one train step; no decode, encoder or Q-Former kernel takes these
    shapes, so the counted torch paths (``_build.fallback_counts``) must
    show the encoder's attention and FFN and the decode step, and those
    kernels must not launch; 25b. a decode step at Llama-3.1-8B's heads, a
    2-layer nano width, B=9 and a 12416-position cache (B*Hkv = 72 clusters
    of one key range each, past what one range holds in shared memory): the
    predicate refuses it, the layer loop runs and agrees with the plain
    decode step within TOL_DECODE; 25c. the debug config's towers with the
    LLM quantized (``apply_llm_quant``), in bf16 and in float32: greedy
    ``generate()`` at b2 with B * T >= 128 prompt rows, ids equal to the
    same model's on the CPU, the products the W8A8 GEMM refuses (llama-
    nano's N = 64, f32 x) counted in ``fallback_counts()`` as
    ``w8a8_matmul``, K7 launched for every decode step's products and its
    head at M = B (f32 x cast to bf16);
26. ORCA training at full width: free the Q-Former model, build
    configs/desta25_llama31-8B_ORCAHybrid.yaml fresh (bf16 towers, the f32
    cross-attention stack, random weights from a seed); (a)
    ``DeSTA25Trainer.train()`` for 3 steps at B=4, T=512 on phase 22's
    corpus with remat and a checkpoint: K11 forward and backward, K2, K1
    and K3 launch every step, ``grad_norm`` finite (so every gradient is)
    and > 0, ``L_ortho_diversity`` and ``L_ortho_qformer_local`` > 0,
    ``L_align_layerwise`` == 0 (prompt-only batches), the tree unchanged
    at lr 0 and changed by step 3, no frozen leaf with a gradient; (b) one
    step at B=4, T=512 on a batch with 8 transcription positions a row:
    ``L_align_layerwise`` > 0 and finite; (c) two steps at the config's
    own B=12, T=300: K11 does not launch.  Each prints ms/step, tokens/s
    and the peak device memory.
27. int8 weights quantized on the card against the CPU, bit for bit
    (``ops/quant.quantize_weight``'s scale is an IEEE division): 4096 rows
    whose max / 127 and max * fl(1/127) round apart, then one
    Llama-3.1-8B layer and its head through ``quantize_llm_params``;
28. checkpoints, Qwen3-0.6B whole and full size
    (configs/desta25_qwen3-0.6b_Qformer6L.yaml): (a) a seeded HF-layout
    snapshot written by the port's codec (whisper-large-v3 in f16, 2
    shards; Qwen3-0.6B in bf16, tied); (b) staged through
    ``python -m desta25_audio_tpu_torch.ckpt.hf_convert`` in a subprocess,
    the whisper tower plain and Qwen3 with --int8 (preset found by dims);
    (c) the in-memory model converted from the same state dicts, its
    checkpoint written by ``save_pretrained``; (d) ``from_pretrained`` on
    the card from the raw shards and from the staged bf16 file, then
    with ``llm_quant="int8"`` from the staged int8 file (quantized on the
    CPU) and from the raw shards (quantized on the card): each tree
    bit-identical to the in-memory model's (bf16, then quantized on the
    card) and its greedy ids at b2 equal; (e) ``cli.generate --json``
    with ``$DESTA_TPU_WEIGHTS``, its ids those of ``generate()``; (f)
    ``cli.serve`` through ``start_http`` on an ephemeral port, one
    /v1/chat/completions request; (g) the ORCA config with the int8
    stack and LLM (K8i) loaded from the raw shards, the staged bf16 file
    alone and the staged int8 file, each equal to its in-memory model.
    The CLIs build CharTokenizers (the repo holds no BPE files, and the
    script needs no ``transformers``);
29. the flagship's Llama-3.1-8B full size: the free disk space of the
    work dir; a 4-shard bf16 snapshot (8.03 B params, 16.06 GB), staged
    int8 on the host CPU (the CLI's --int8 conversion in a subprocess,
    writing its 8.6 GB int8 file but not its 16 GB bf16 one, which would
    take the script's disk writes past 45 GiB), then ``from_pretrained`` of
    configs/desta25_llama31-8B_Qformer6L.yaml with ``llm_quant="int8"``
    from the staged int8 file and from the raw shards: every leaf
    bit-identical (the 32 layers and the head quantized on the CPU and on
    the card) and equal greedy ids.  Each load of 28-29 prints its wall
    time, the bytes of its files and their read rate alone onto the card
    (page cache warm), its peak device memory and the time to the first
    token after it; each step of 28-29 its wall time.
30. the native decoders, the prefetching loader and LoRA.  30a: the
    port's native libraries built by g++ (``native/build.py``; the FFmpeg
    codec only where the libavformat headers exist, else said and the WAV
    path alone runs), a 2 s 22.05 kHz stereo clip as 24-bit WAV (decoded
    exactly), FLAC (lossless to 16-bit quantization), MP3 and OGG (a
    correlation above 0.95 with the WAV's decode), each through
    ``AudioSegment.from_file``, with the host ms a clip.  30b: the
    flagship with LoRA (r 16, alpha 16, dropout 0.1, the reference's peft
    setting) trained by DeSTA25Trainer for 3 steps at B=4 T=512 with
    ``num_workers`` 0 and then 2 over phase 22's corpus as FLAC clips: K11
    forward and backward, K1, K2 and K3 in every step, ms a step, the
    host's wait for each batch and peak memory, the adapters' B off zero;
    evaluate() with the adapters.  30c: the adapters' B moved further (N(0,
    0.02)), generate() b2 through the layer loop (no fused kernel, no
    graph; K1, K2, K3 launched); 30d: the engine at 4 slots under LoRA
    (plain layer-loop ticks; ``speculative_k=4`` refused), its greedy ids
    against generate()'s of the same four requests at b4 (equal, or
    parted where generate()'s own top-2 margin is within
    TOL_ENGINE_MARGIN: the prompts are padded apart) and the
    teacher-forced gate; then
    (30c) the merge and quantizer on the card against the CPU over two
    full-width layers and 4096 head rows, bit for bit,
    ``merge_lora_for_serving(quantize=True)``, the merged int8 model's
    first-step logits beside the adapter model's (margins), and generate()
    b2 through the K8-int8 graph.  Prints the phase's seconds.

31. training on a mesh and across processes (run inside phase 22-24's
    block, on its bf16 model, after 24 and before 24b quantizes the
    tower): (a) ``DeSTA25Trainer`` with ``mesh="on"`` for 3 steps at B=4
    T=512 on phase 23's batches from phase 22's trainable values, on a
    (2, 1) mesh of virtual ranks of the card with ``fsdp`` and on a (1, 2)
    mesh (the LLM cut 2 ways): each step's lm_loss and grad_norm against
    phase 23's within TOL_TRAIN_MESH_LOSS / _GN beside the control (phase
    23's next batch), K11 forward and backward launched once a rank for
    each of phase 23's launches at H/p heads, every leaf fsdp cuts still
    cut after the steps, ms a step and peak memory; (b) two processes on
    the card over gloo (``--train-worker``), each a 1 x 1 mesh at B=2, one
    step, against the one-process (2, 1) step on their batches
    concatenated within TOL_TRAIN_PROC; (c) the ORCA yaml of Qwen3-0.6B
    (full width, D=1024, L=28) for 2 steps on one device, then 2 with
    ``fsdp`` on a (2, 1) virtual mesh, held alike.
32. GPipe pipelining and sequence parallelism (run beside 31a, on the same
    model, batches and one-device rows): (a) ``DeSTA25Trainer`` with
    ``mesh_pipe=2`` on two virtual ranks of the card (the LLM's 32 layers
    in 2 stages of views), 3 steps at ``pipeline_microbatches`` 2, then 2
    at 4: each step's lm_loss and grad_norm against phase 23's within
    TOL_TRAIN_MESH_LOSS / _GN beside the control, K11 launched M times
    each of phase 23's launches (64 M forward, 96 M backward a step, at
    B / M rows), ms a step and peak memory; (b) a (1, 2, 2) mesh
    (tensor-parallel 2 x pipe 2) on four virtual ranks, 2 steps, held
    alike, K11 at H/2 heads; (c) 31a's (1, 2) steps again with
    ``sequence_parallel=True``: lm_loss and grad_norm equal to 31a's
    (TOL_TRAIN_SP) beside the control, both runs' peaks; no torch path
    taken (``_build.fallback_counts()``); the phase's seconds.
33. the flagship training setup and Qwen3-4B-Instruct-2507 at full depth.
    33a: ``train/bench_utils.build_flagship_train_setup()`` (the int8
    Llama-3.1-8B tower and the bf16 encoder at random, the f32 Q-Former,
    B=12 T=300, remat, Adafactor): ``hbm_analysis`` (one step on clones,
    all three keys), then three steps: lm_loss and grad_norm finite, step
    2's loss equal to step 1's (lr 0 at count 0), step 3's not, every
    trainable part moved by steps 2-3, K1, K2 and K3 launched, K11 not
    (T=300), no torch path taken; ms a step and peaks beside
    ``hbm_analysis``' sum.  33b: the same with ``connector_mode=
    "orca_hybrid"``: Qwen3-4B at all 36 layers, the int8 tower, the stack in
    bf16, its aux terms.  33c: ``generate()`` on
    configs/desta25_qwen3-4B_Qformer6L.yaml (36 layers, random weights from
    a seed, ``CharTokenizer("qwen3")``, the int8 encoder) with the bf16 LLM
    (K8), then after ``apply_llm_quant()`` (K8-int8, K7 on the tied int8
    head of 153,600 rows), then configs/desta25_qwen3-4b_ORCAHybrid.yaml on
    that encoder and LLM with ``apply_orca_xattn_quant()`` (K8i at
    injection head dim 80): b2 and b1, greedy, 32 new tokens, each run's
    decode through its graph, its kernels launched and no torch path
    taken, the first two ids against a step-by-step run and every id
    against the layer loop teacher-forced (TOL_ENGINE_MARGIN, the b2 run
    beside a control), ms a step and peak memory; the phase's seconds.

Phase 4 first holds the GEMM planner's wave (``ops/gemm.cluster_ctas``)
against the card: the clusters of 1..8 CTAs of the int8 GEMM it runs at
once (``cudaOccupancyMaxActiveClusters``), equal on a 132-SM card.

Phase 13 also holds the skinny weight-streaming GEMM
(``csrc/skinny_gemm.cuh``, the GEMM of K7 at M <= 16, K8, K8-int8, K8v,
K8i, K9 and K10) alone against ``skinny_gemm_plain`` (13b): Llama-3.1-8B's
qkv, wo, gate/up (SWIGLU), down and head shapes, int8 and bf16, R = 1, 2, 8
and 16, every epilogue, PEER_F32 at p = 2, within TOL_DECODE (bf16 outputs)
or TOL_QMM (f32); two launches bit-identical; its plan equal to
``plan_skinny_gemm``; queued times and TB/s at R = 2 and 8; and the
decode step's RMSNorm alone (``decode_rms_norm``, csrc/fused_decode.cu)
against ``rms_plain`` at R = 2 and 8 rows of D = 4096 and 2 of 2560 within
TOL_DECODE, two launches bit-identical, its times beside the plain
version's and ``torch.nn.functional.rms_norm``'s.  The K8 family's
steps (phases 4 and 13: K8, K8-int8, K8v, K8i, K9), K7 and K10 on one
card's stream are also timed queued behind the sleep kernel, printed beside
the default reading, and the decode steps (K8, K8-int8, K8v, K8i) also as
the replays of one CUDA graph of the step.

Every kernel's entry in the JSON line carries its bound (the larger of its
bytes over 3.35 TB/s and its operations over 989 TFLOP/s bf16, 1,979 TOP/s
int8 or 67 TFLOP/s f32 outside the tensor cores (K1, whose bytes are the
audio, the log-mels and its kernel's ~8 KB of tables and whose operations
are a real FFT's and the nonzero filterbank entries', as its kernel
computes: ``bench_mel.mel_work``), counted from this run's inputs) and, where one PyTorch call
computes the same function, that call's time (``library_ms``; K2 and K11
against ``scaled_dot_product_attention``; the decode attention against SDPA
over its cached keys alone, K8i's attention against SDPA over the same q
and audio K/V, both as information), else null.

Each printed row of greedy ids carries, per id, the margin of its top
logit over the runner-up (``add_margins``: an untimed rerun of the same
generate() after the timed run's numbers were read): an id that differs
between two builds of the kernels at a small margin is a near-tie that a
last-bit change upstream flipped.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --mesh-only

runs phases 1-3 and 20a-20c alone, on the flagship model built with the
int8 LLM (work on the tensor-parallel path); ``--mesh-only --cards`` puts
the ranks on distinct cards (p = 2 and 4: four cards, peer access over
NVLink) instead of virtual ranks of the first.

    python3 chip_smoke.py --phase30-only

runs phases 1-3 and 30 alone (work on the decoders, the loader and LoRA).

    python3 chip_smoke.py --train-mesh-only [--cards]

runs phases 1-3, 31 and 32 alone on a fresh flagship training model (its
one-device reference run first); with ``--cards`` (four cards) the flagship
Q-Former at (4, 1) with fsdp and at (2, 2) over the cards, four processes
one a card over NCCL, phase 32 with its stages and ranks on distinct cards
(GPipe over cards 0-1, (1, 2, 2) over the four, sequence parallelism over
cards 0-1 beside the same (1, 2) run without it), and the flagship ORCA
step with fsdp over the four cards beside its one-card run, each with each
card's peak memory.

    python3 chip_smoke.py --phase33-only

runs phases 1-3 and 33 alone (work on the training setup and Qwen3-4B).

    python3 chip_smoke.py --http-rounds N

runs phases 1-3, then phase 16g N times on the flagship model with its
int8 encoder and LLM (work on the HTTP front end: each round's 8 clients,
its cancel and its gate; a round that hangs 120 s dumps every thread's
stack and exits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

# stated tolerances (max |kernel - plain| / max |plain|)
TOL_ENC = 2e-2       # K2, K3 and the int8 encoder layers: bf16 outputs of
                     # f32 sums
TOL_W8A8 = 1e-3      # K4-K6 alone: the int32 sums are exact and the f32
                     # epilogues run in the plain version's order, so only
                     # an erff-vs-erf step (~1e-4) may show; a K4 hidden
                     # quantized per row instead of per 1280-column chunk
                     # lands at ~1.5e-2 (~2e-1 on the skewed case)
TOL_DECODE = 3e-2    # K8, K8-int8, K8v: the bound of
                     # tests/test_fused_decode.py:77
TOL_INJECT = 1e-2    # K8i's attention and gate alone: bf16 outputs of f32
                     # sums in another order than torch's (the attention
                     # folds its key ranges' (max, sum) pairs), so a bf16
                     # rounding of P or of the gated term may flip; the
                     # attention read <= 8.7e-4, the gate's term 0, and
                     # the attention without one tile of 8 keys reads
                     # above it
TOL_QMM = 1e-3       # K7 and the LLM's W8A8 GEMM, both in f32: W8A8's int32
                     # sums are exact and its epilogue runs in the plain
                     # version's order; K7's f32 sums differ only in order
TOL_FLASH = 2e-2     # K11 forward and backward: bf16 outputs of f32 sums;
                     # the forward rounds the unnormalised weights to bf16
                     # where the plain version rounds the normalised ones
TOL_MEL = 1e-4       # K1, max |kernel - plain| after the clip-wide clamp
                     # (absolute), on noise plus a tone: the bound of
                     # tests/test_mel_pallas.py:40
TOL_MESH = 2e-2      # K10 vs its plain version, 2-layer logits: at p = 2
                     # K10 equals the unsharded K8 step bit for bit, so the
                     # spread is K8's own kernel-vs-plain one (readings
                     # <= 9.5e-3, bf16 tower); each check also prints its
                     # control, the plain version with one rank's partial
                     # dropped, which must read above the gate
TOL_MESH_QMM = 1e-4  # the prefill's wo / down products under a mesh vs the
                     # unsharded product, f32 (W8A8 at M = 296, K7 at
                     # M = 100): exact int32 sums resp. f32 sums in another
                     # order; controls: a rank-local amax, a dropped partial
TOL_MESH_PREFILL = 1e-1  # the 2-layer prefill under a mesh vs the
                     # unsharded one: layer 0's q/k/v and heads equal bit for
                     # bit at W8A8 (K7 splits K by its column count, so its
                     # shards round otherwise), the wo / down sums flip a
                     # few bf16 roundings, and W8A8 turns a flip across an
                     # int8 code into a whole step: readings <= 2.5e-2, the
                     # unsharded prefill with its input moved one ulp at the
                     # flipped elements alike; control, a dropped partial,
                     # ~1.2 (the rank-local amax: TOL_MESH_QMM's leg)
TOL_MESH_GEN = 2.5e-1  # generate() under a mesh, teacher-forced logits vs
                     # the unsharded LLM's through 32 random layers: the
                     # ranks' partial sums reassociate every wo / down
                     # product, and 32 random layers amplify one input ulp
                     # alone to ~4.5e-2; readings <= 1.36e-1 (the prefill
                     # position); the control, the prefill with one rank's
                     # partial dropped, must read above the gate
TOL_MEL_WAV = 1e-3   # K1 on the synthetic WAVs zero-padded to 30 s: a bin
                     # near the clamp floor keeps an absolute f32 error of
                     # ~eps * sum|terms| in its DFT sum, which log10 turns
                     # into up to ~1e-4 after / 4; the frames that straddle
                     # the zero padding are where such bins live
TOL_ASR_CACHE = 1e-4  # the Whisper decoder's cached steps vs its full
                     # forward over the prefix and the emitted ids, a 2-layer
                     # f32 copy of whisper-large-v3's: summation order only
                     # (1.2e-6 on the CPU); the control, every cached call
                     # writing its keys one slot late, read 0.21 there

TOL_ENGINE_MARGIN = 0.25  # the serving engine's greedy ids against a
                     # forward over each request's own prompt (as the
                     # engine's prefill runs it) and its emitted ids (one at
                     # a time, in the decode step's order, through the layer
                     # loop: the torch attention and weight-only products,
                     # none of the engine's decode kernels; with ORCA the
                     # PyTorch injection): where the reference's argmax is
                     # not the emitted id, its top logit less the emitted
                     # id's, in logit units (random
                     # weights: logits of ~1.3 std, top-2 gaps of a few
                     # tenths; the bf16 tower read <= 0.089); the control,
                     # each row's ids on another row's prompt, read 7.5-8.9.
                     # A reference with the prompt too in weight-only int8
                     # (the engine's prefill quantizes activations, W8A8)
                     # read 0.47 on the int8 tower; 16a prints two other
                     # references beside it (the ids in one call, and one at
                     # a time through the fused step), which differ from it
                     # by up to ~0.3 in a logit.  Phase 33c holds generate()'s
                     # ids to it alike (the reference, generate()'s own
                     # prefill, then the ids through the layer loop); its
                     # control, each id + 1, must exceed it
TOL_TRAIN_MESH_LOSS = 3e-3  # phase 31: a train step's lm_loss on a mesh
                     # vs the one-device trainer's on the same batch
                     # (relative), Llama-3.1-8B's 32 random layers: bf16
                     # products over another split of the rows (cuBLAS
                     # picks its kernel by shape) or of the heads (the rank
                     # sums in f32, rounded once) flip bf16 roundings, which
                     # the random layers amplify; the first two steps run
                     # on equal parameters (lr 0 at step 1), the third after
                     # an update that Adafactor's sign-like first steps
                     # spread.  The H100 read <= 7.3e-4 at equal
                     # parameters, 1.4e-3 at step 3; the control, the
                     # one-device run's next batch at equal parameters,
                     # read 6.0e-3 (grad_norm 7.9e-2).  Each cell's best
                     # control must read 10x its gate: here the gradients'
                     # (TOL_TRAIN_MESH_G), with fsdp the update's too
TOL_TRAIN_MESH_GN = 3e-2  # the same step's grad_norm (relative): read
                     # <= 2.5e-3 at equal parameters, 1.6e-2 at step 3
TOL_TRAIN_MESH_ORCA = (3e-3, 1e-2, 1e-1)  # the same for the flagship ORCA
                     # model on four cards (--cards): its next batch's loss at
                     # equal parameters reads only 2.3e-4 (random weights
                     # and the injection flatten the loss across batches;
                     # grad_norm's 2.6e-2), so the update's control (fsdp)
                     # carries the cell; four H100s read <= 1.1e-3 / 1.9e-3
                     # / 4.6e-2 (gradients: control 0.50)
TOL_TRAIN_MESH_SMALL = (5e-4, 5e-3, 1e-2)  # the same for 31c's Qwen3-0.6B
                     # ORCA model (28 layers of D=1024, f32 stack): read
                     # <= 7.6e-5 / 4.9e-4 / 5.1e-3; controls 1.7e-3 /
                     # 4.3e-5 / 6.8e-2
TOL_TRAIN_MESH_G = 5e-2  # phase 31: the gradients' sampled elements of a
                     # flagship mesh step at equal parameters (steps 1-2)
                     # against the one-device step's, the L2 norm of the
                     # difference over that of the one-device gradients,
                     # every leaf together (chip_smoke.rel_l2): the H100 read
                     # 3.4e-2 - 4.0e-2 at (2, 1) and (1, 2), four read
                     # 3.6e-2 - 4.5e-2 at (4, 1) and (2, 2) (32 random bf16
                     # layers amplify another split's roundings, as in the
                     # loss); the control, the one-device gradients of the
                     # next batch, 0.56
TOL_TRAIN_MESH_U = 1e-5  # phase 31: a step's update of the leaves fsdp cuts
                     # against Adafactor's on whole tensors from the same
                     # gradients on the host (chip_smoke.UpdateReplay; sums
                     # in another order): read 1.1e-7 - 1.4e-7; its
                     # control, the rule on each shard alone, 8.7e-3 - 0.14
                     # (0 where no cut leaf is factored and the block RMS
                     # clips nothing, as at nano widths).  The trained
                     # leaves against the one-device run's are printed, not
                     # gated: Adafactor scales each update to about lr
                     # whatever the gradient's size, so leaves whose
                     # gradient is rounding noise at equal parameters move
                     # apart by ~lr an element
TOL_TRAIN_SP = 0.0  # phase 32c: a train step's lm_loss and grad_norm with
                     # sequence parallelism against the same (1, 2) step
                     # without it (relative): RMSNorm is per row and each
                     # slice of the reduce-scatter sums the ranks' f32
                     # products in the order the whole sum does, and the
                     # backward sums the same two terms a tensor, so the
                     # numbers are the same bit for bit
TOL_TRAIN_PIPE = 0.0  # phase 32a / 32b: a GPipe step's lm_loss, grad_norm
                       # and gradient samples (relative) against the same
                       # step without a pipe (32a: phase 23's one device;
                       # 32b: the (1, 2) step): a stage runs the same layer
                       # on each microbatch's rows that one device runs on
                       # the batch (K11 and the products are per row), so
                       # the numbers are the same bit for bit; a race
                       # between the stages' streams would show here
TOL_TRAIN_PROC = 1e-5  # phase 31b: processes, each a 1 x 1 mesh, vs one
                     # process's (n, 1) mesh on their batches: the same
                     # rows on the same shapes a device, the gradients of
                     # two terms summed in either order; the loss's parts
                     # divide before they add (a few f32 ulps).  The
                     # H100 read 0 (bit for bit); control, the next
                     # batches, 2.5e-3

CONFIG = "configs/desta25_llama31-8B_Qformer6L.yaml"
ORCA_CONFIG = "configs/desta25_llama31-8B_ORCAHybrid.yaml"
# the H100 SXM's published peaks (NVIDIA's H100 datasheet: dense tensor-core
# bf16 and int8; "f32" is FP32 outside the tensor cores, the rate of the
# f32 FFT kernel K1; K9's int8-weight x bf16 products are held to bf16, as
# K8-int8's are)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SOURCES = {
    "packed_encoder_attention": (
        "desta25_audio_tpu_torch/csrc/enc_attention.cu",
        "desta25_audio_tpu/ops/enc_attention.py:39"),
    "encoder_ffn": (
        "desta25_audio_tpu_torch/csrc/gemm_sm90.cuh",
        "desta25_audio_tpu/ops/enc_ffn.py:54"),
    "fused_decode_layers": (
        "desta25_audio_tpu_torch/csrc/fused_decode.cu",
        "desta25_audio_tpu/ops/fused_decode.py:235"),
    "encoder_ffn_w8a8": (
        "desta25_audio_tpu_torch/csrc/w8a8.cu",
        "desta25_audio_tpu/ops/enc_ffn.py:169"),
    "qkv_w8a8": (
        "desta25_audio_tpu_torch/csrc/w8a8.cu",
        "desta25_audio_tpu/ops/w8a8_proj.py:44"),
    "proj_w8a8": (
        "desta25_audio_tpu_torch/csrc/w8a8.cu",
        "desta25_audio_tpu/ops/w8a8_proj.py:56"),
    "quant_matmul": (
        "desta25_audio_tpu_torch/csrc/qmm.cu",
        "desta25_audio_tpu/ops/quant.py:63"),
    # K7's wgmma path (16 < M < 128: the b1 prefill's four layer GEMMs;
    # launches: its kernel count in phase 15's int8 generate() runs)
    "quant_matmul_prefill": (
        "desta25_audio_tpu_torch/csrc/qmm.cu",
        "desta25_audio_tpu/ops/quant.py:63"),
    # the int8 LLM's prefill at M >= 128: XLA on the TPU, not Pallas
    "w8a8_matmul": (
        "desta25_audio_tpu_torch/csrc/w8a8.cu",
        "desta25_audio_tpu/ops/quant.py:123"),
    "fused_decode_layers_int8": (
        "desta25_audio_tpu_torch/csrc/fused_decode.cu",
        "desta25_audio_tpu/ops/fused_decode.py:423"),
    "fused_verify_layers": (
        "desta25_audio_tpu_torch/csrc/fused_decode.cu",
        "desta25_audio_tpu/ops/fused_decode.py:1159"),
    "fused_decode_inject": (
        "desta25_audio_tpu_torch/csrc/fused_inject.cu",
        "desta25_audio_tpu/ops/fused_decode.py:731"),
    # K8i's two kernels of csrc/fused_inject.cu (launches: their kernel
    # counts in the ORCA runs of phases 19-20)
    "inject_attention": (
        "desta25_audio_tpu_torch/csrc/fused_inject.cu",
        "desta25_audio_tpu/ops/fused_decode.py:755"),
    "inject_gate": (
        "desta25_audio_tpu_torch/csrc/fused_inject.cu",
        "desta25_audio_tpu/ops/fused_decode.py:805"),
    "flash_attention": (
        "desta25_audio_tpu_torch/csrc/flash_attention.cu",
        "desta25_audio_tpu/ops/attention.py:60"),
    "flash_attention_bwd": (
        "desta25_audio_tpu_torch/csrc/flash_attention.cu",
        "desta25_audio_tpu/ops/attention.py:60"),
    "log_mel": (
        "desta25_audio_tpu_torch/csrc/mel.cu",
        "desta25_audio_tpu/ops/mel_pallas.py:41"),
    "fused_decode_tp_attn": (
        "desta25_audio_tpu_torch/csrc/fused_decode_tp.cu",
        "desta25_audio_tpu/ops/fused_decode_tp.py:209"),
    "fused_decode_tp_mlp": (
        "desta25_audio_tpu_torch/csrc/fused_decode_tp.cu",
        "desta25_audio_tpu/ops/fused_decode_tp.py:467"),
    # K10: K8's kernels per shard, wo / down through the peer-store GEMM
    "fused_decode_layers_mesh": (
        "desta25_audio_tpu_torch/csrc/fused_decode.cu",
        "desta25_audio_tpu/ops/fused_decode_mesh.py:162"),
    "tp_allreduce": (
        "desta25_audio_tpu_torch/csrc/tp_allreduce.cu",
        "desta25_audio_tpu/ops/fused_decode.py:673"),
    # the attention launch of K8, K8-int8, K8v, K8i and K9 (launches: the
    # kernel count of the int8 generate() runs of phase 15)
    "decode_attention": (
        "desta25_audio_tpu_torch/csrc/decode_attention.cuh",
        "desta25_audio_tpu/ops/fused_decode.py:504"),
    # the weight-streaming GEMM of K7 (M <= 16), K8, K8-int8, K8v, K8i, K9
    # and K10 (launches: its kernel count in phase 15's int8 generate()
    # runs); it stands for the TPU kernel's weight ring
    "skinny_gemm": (
        "desta25_audio_tpu_torch/csrc/skinny_gemm.cuh",
        "desta25_audio_tpu/ops/fused_decode.py:405"),
    # the norm launch of K8, K8-int8, K8v and K8i (launches: its kernel
    # count in phase 15's int8 generate() runs): the kernel's rmsn
    "rms_norm": (
        "desta25_audio_tpu_torch/csrc/fused_decode.cu",
        "desta25_audio_tpu/ops/fused_decode.py:385"),
}
# the kernels of the bf16 generate() path and of the int8 encoder's
BF16_PATH = ("log_mel", "packed_encoder_attention", "encoder_ffn",
             "fused_decode_layers")
W8A8_KERNELS = ("encoder_ffn_w8a8", "qkv_w8a8", "proj_w8a8")
INT8_LLM_KERNELS = ("quant_matmul", "quant_matmul_prefill", "w8a8_matmul",
                    "fused_decode_layers_int8")
# what ORCA generate() with the int8 stack must launch (phase 19)
ORCA_PATH = ("fused_decode_inject", "fused_decode_layers_int8",
             "quant_matmul", "w8a8_matmul", "packed_encoder_attention",
             "encoder_ffn_w8a8", "log_mel")
# K8i's attention and gate, counted by their own names (phases 19-20)
INJECT_KERNELS = ("inject_attention", "inject_gate")
# the per-layer pair K9 (phase 18, opt-in float-stack ORCA decode)
K9_HALVES = ("fused_decode_tp_attn", "fused_decode_tp_mlp")
# what generate() under a (1, 2) mesh must launch (phase 20c)
MESH_PATH = ("fused_decode_layers_mesh", "tp_allreduce", "decode_graph",
             "quant_matmul", "w8a8_matmul", "log_mel")


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def llm_step_work(params, cfg, B: int, kd: int, ci, inject=None):
    """(bytes, operations) one decode / verify step needs: every layer
    weight, scale and norm read once; per row the cached keys and values
    below its ci read once and kd new rows written; x in, h out.  With
    ``inject``: the stack's q / o / gate1 / gate2 / LayerNorm leaves read
    once, each row's ta audio keys and values read once; operations 2 per
    weight per token row, 4*Dh per (query head, key) pair, 4*D per (token
    row, audio token)."""
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    KVD = cfg.num_key_value_heads * Dh
    R = B * kd
    lay = params["layers"]
    nb = tree_bytes(lay)
    weights = sum((w["q"] if isinstance(w, dict) else w).numel()
                  for k, w in lay.items()
                  if k in ("wqkv", "wo", "w_gu", "w_down"))
    nb += L * sum(int(c) for c in ci) * KVD * 2 * 2 + L * R * KVD * 2 * 2
    nb += 2 * R * D * 2
    ops = 2 * R * weights + L * 4 * H * Dh * sum(
        kd * int(c) + kd * (kd + 1) // 2 for c in ci)
    if inject is not None:
        il = inject["params"]["layers"]
        nb += sum(tree_bytes(il[k]) for k in ("q", "o", "gate1", "gate2",
                                              "ln"))
        ta = int(inject["ta_real"])
        nb += 2 * L * B * ta * D * 2
        ops += 2 * R * sum(il[k]["q"].numel() for k in ("q", "o", "gate1"))
        ops += L * R * 4 * ta * D
    return nb, ops


def add_margins(model, msgs, out) -> None:
    """Information: generate() of ``msgs`` once more, untimed and after its
    run's counts and times were read (greedy, 32 new tokens, as every
    printed run), recording at each step sampled through
    ``generate/decode.sample_token`` each row's top logit less its
    runner-up.  Stores them on ``out`` as ``margins`` [B, steps] (numpy),
    with ``margins_same`` (whether the rerun's ids equal ``out``'s), so
    that a greedy id that flips between two builds shows whether it was a
    near-tie."""
    import torch
    from desta25_audio_tpu_torch.generate import decode as tdecode
    real_sample, steps = tdecode.sample_token, []

    def sample(logits, *args):
        steps.append(logits.topk(2, dim=-1).values)
        return real_sample(logits, *args)

    tdecode.sample_token = sample
    try:
        again = model.generate(msgs, do_sample=False, max_new_tokens=32)
    finally:
        tdecode.sample_token = real_sample
    top = torch.stack(steps).float()
    out.margins = (top[..., 0] - top[..., 1]).T.cpu().numpy()
    out.margins_same = again.generated_ids == out.generated_ids


def shown(out, row: int) -> str:
    """A row's first 8 greedy ids and, where recorded, their margins."""
    ids = out.generated_ids[row][:8]
    m = getattr(out, "margins", None)
    if m is None:
        return str(ids)
    rerun = ("an untimed rerun's" if out.margins_same else
             "an untimed rerun's, whose ids differ")
    return (f"{ids} ({rerun} margins "
            f"{[round(float(v), 3) for v in m[row][:8]]})")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, queued: bool = False) -> float:
    """Mean device time of fn() over iters runs (after one warm-up).  With
    ``queued`` the runs wait on the card behind a 20 ms sleep kernel while
    the host enqueues them, so a kernel that runs faster than its Python
    launch path (K2, K11) is timed on the card, not at the host's pace:
    printed beside the default reading as information; the kernels line
    keeps the default.  Not for work on other streams (the mesh's ranks), which the sleep on
    the current stream would not hold back."""
    import torch
    fn()
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)  # ~20 ms at the H100's 1.98 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want):
    got, want = got.float(), want.float()
    if not (bool(got.isfinite().all()) and bool(want.isfinite().all())):
        raise AssertionError("non-finite values in a kernel comparison")
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-6)


def check_enc_attention(gen):
    import torch
    from desta25_audio_tpu_torch.ops.enc_attention import (
        packed_encoder_attention, packed_encoder_attention_plain)
    rows = []
    for label, n, tq, tkv in (("self", 2, 1500, 1500),
                              ("cross", 4 * 2, 64, 1500)):
        mk = lambda t: torch.randn(n, t, 1280, generator=gen,  # noqa: E731
                                   device="cuda").to(torch.bfloat16)
        q, k, v = mk(tq), mk(tkv), mk(tkv)
        got = packed_encoder_attention(q, k, v, 20)
        want = packed_encoder_attention_plain(q, k, v, 20)
        err, rel = rel_err(got, want)
        # back-to-back event times (the kernels line) and, as information,
        # the same runs queued behind a sleep kernel
        kern = lambda: packed_encoder_attention(q, k, v, 20)  # noqa: E731
        plain = lambda: packed_encoder_attention_plain(q, k, v, 20)  # noqa
        # the library yardstick: one scaled_dot_product_attention call on
        # the same tensors viewed [n, H, T, Dh]
        heads = lambda t: t.view(n, t.shape[1], 20, 64).transpose(1, 2)  # noqa
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            heads(q), heads(k), heads(v))
        ms, plain_ms, lib_ms = (cuda_time_ms(f) for f in (kern, plain, lib))
        q_ms, q_plain, q_lib = (cuda_time_ms(f, queued=True)
                                for f in (kern, plain, lib))
        nbytes = 2 * n * 1280 * (2 * tq + 2 * tkv)
        ops = 4 * n * tq * tkv * 1280
        b_ms, b_by = bound(nbytes, ops, "bf16")
        print(f"K2 packed_encoder_attention[{label}] B={n} Tq={tq} "
              f"Tkv={tkv} H=20 Dh=64: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_ENC}) kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
              f"bound), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms "
              f"({ops / lib_ms / 1e9:.1f} TFLOP/s), bound {b_ms:.4f} ms "
              f"({b_by}); queued: kernel {q_ms:.4f} ms "
              f"({ops / q_ms / 1e9:.1f} TFLOP/s, {b_ms / q_ms:.3f} of the "
              f"bound), plain {q_plain:.4f} ms, scaled_dot_product_attention "
              f"{q_lib:.4f} ms", flush=True)
        if rel > TOL_ENC:
            raise AssertionError(f"K2 {label} disagrees: rel {rel}")
        rows.append((err, ms, plain_ms, b_ms, b_by, lib_ms))
    return rows


# the rows the encoder GEMMs are checked at: the int8 encoder's b1, b2
# and b4 (M = B * 1500) and a ragged count (one 256-row tile and a row)
GEMM_ROWS = (1500, 3000, 6000, 257)


def require_kernel_paths(tag: str) -> None:
    """No flagship shape left its kernel in the generate() just run: the
    counted torch paths (``_build.fallback_counts()``) are none."""
    from desta25_audio_tpu_torch.ops import _build
    taken = _build.fallback_counts()
    print(f"{tag}: torch paths taken {json.dumps(taken)}", flush=True)
    if taken:
        raise AssertionError(f"{tag}: a kernel's predicate refused a "
                             f"flagship shape: {taken}")


def check_gemm_clusters() -> None:
    """The planner's wave (ops/gemm.cluster_ctas) against the card: the
    clusters of 1..8 CTAs of the int8 GEMM it runs at once
    (cudaOccupancyMaxActiveClusters), equal on a 132-SM card."""
    import ctypes
    from desta25_audio_tpu_torch.ops import _build, gemm
    lib = _build.library()
    n_sm = _build.sm_count("cuda")
    got = {}
    for s in range(1, gemm.SPLITS_MAX + 1):
        c = ctypes.c_int(-1)
        _build.check(lib.desta_gemm_max_clusters(256, 128, s,
                                                 ctypes.addressof(c)),
                     "desta_gemm_max_clusters")
        got[s] = c.value * s
    want = {s: gemm.cluster_ctas(s, n_sm) for s in got}
    print(f"GEMM CTAs in flight by cluster size ({n_sm} SMs): {got}; the "
          f"planner's {want}", flush=True)
    if n_sm == 132 and got != want:
        raise AssertionError(f"the planner's waves {want}, the card's {got}")


def check_enc_ffn(gen):
    """K3 against its plain version at GEMM_ROWS within TOL_ENC, beside a
    control that must read above the gate (the plain version with fc2's
    last k-tile, 64 columns of F, dropped: what a ring that lost a stage
    computes); back-to-back and queued times.  Returns the kernels line's
    row: the worst error, the M=3000 times and bound."""
    import torch
    from desta25_audio_tpu_torch.ops.enc_ffn import (encoder_ffn,
                                                     encoder_ffn_plain)
    D, Fd = 1280, 5120
    bf = torch.bfloat16
    w1 = (torch.randn(Fd, D, generator=gen, device="cuda") / D ** 0.5).to(bf)
    b1 = (0.1 * torch.randn(Fd, generator=gen, device="cuda")).to(bf)
    w2 = (torch.randn(D, Fd, generator=gen, device="cuda") / Fd ** 0.5).to(bf)
    b2 = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf)
    w2c = w2.clone()
    w2c[:, -64:] = 0
    worst, row = 0.0, None
    for M in GEMM_ROWS:
        x = torch.randn(1, M, D, generator=gen, device="cuda").to(bf)
        want = encoder_ffn_plain(x, w1, b1, w2, b2)
        err, rel = rel_err(encoder_ffn(x, w1, b1, w2, b2), want)
        _, ctl = rel_err(encoder_ffn_plain(x, w1, b1, w2c, b2), want)
        ms = cuda_time_ms(lambda: encoder_ffn(x, w1, b1, w2, b2))
        q_ms = cuda_time_ms(lambda: encoder_ffn(x, w1, b1, w2, b2),
                            queued=True)
        plain_ms = cuda_time_ms(lambda: encoder_ffn_plain(x, w1, b1, w2, b2))
        b_ms, b_by = bound(2 * (2 * M * D + 2 * D * Fd + Fd + D),
                           4 * M * D * Fd, "bf16")
        print(f"K3 encoder_ffn M={M} D={D} F={Fd}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_ENC}; control, fc2's last k-tile "
              f"dropped: {ctl:.3e}) kernel {ms:.4f} ms ({q_ms:.4f} queued, "
              f"{4 * M * D * Fd / q_ms / 1e9:.1f} TFLOP/s, {b_ms / q_ms:.3f} "
              f"of the bound), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        if rel > TOL_ENC:
            raise AssertionError(f"K3 disagrees at M={M}: rel {rel}")
        if ctl <= TOL_ENC:
            raise AssertionError(f"K3's control reads {ctl} at M={M}")
        worst = max(worst, err)
        if M == 3000:
            row = (ms, plain_ms, b_ms, b_by)
    return (worst,) + row


def _backward_ms(out, inputs, grad, queued: bool = False) -> float:
    """Device time of the backward of ``out`` alone (its graph kept)."""
    import torch
    return cuda_time_ms(lambda: torch.autograd.grad(
        out, inputs, grad, retain_graph=True), queued=queued)


def check_flash(gen):
    """21. K11 forward and backward against flash_attention_plain at the
    training shape (B=4, T=512, H=32, Hkv=8, Dh=128, causal, row 1
    right-padded from 400) and at T=520 (not a multiple of the tile):
    output and dq/dk/dv on all rows, gated at TOL_FLASH.  Returns the
    T=512 rows of the two JSON entries."""
    import torch
    from desta25_audio_tpu_torch.ops.attention import (
        flash_attention, flash_attention_plain)
    B, H, Hkv, Dh = 4, 32, 8, 128
    scale = Dh ** -0.5
    out = {}
    for T in (512, 520):
        mk = lambda h, s=1.0: (s * torch.randn(  # noqa: E731
            B, T, h, Dh, generator=gen, device="cuda")).to(torch.bfloat16)
        q, k, v, do = mk(H, 2.0), mk(Hkv), mk(Hkv), mk(H)
        seg = torch.ones(B, T, dtype=torch.int32, device="cuda")
        seg[1, 400:] = 0

        def run(fn):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, seg, True, scale)
            grads = torch.autograd.grad(o, leaves, do, retain_graph=True)
            return (o.detach(), *grads), o, leaves

        got, o_k, in_k = run(flash_attention)
        # no atomics in the backward: a second run gives the same bits
        again = torch.autograd.grad(o_k, in_k, do, retain_graph=True)
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again)):
            raise AssertionError(f"K11 T={T}: two backward runs differ")
        want, o_p, in_p = run(flash_attention_plain)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        names = ("o", "dq", "dk", "dv")
        print(f"K11 flash_attention B={B} T={T} H={H} Hkv={Hkv} Dh={Dh} "
              f"causal, row 1 padded from 400: " + ", ".join(
                  f"{n} max_abs_err={e:.3e} rel={r:.3e}"
                  for n, (e, r) in zip(names, errs))
              + f" (tol {TOL_FLASH}); backward bit-identical on two runs",
              flush=True)
        for n, (_, r) in zip(names, errs):
            if r > TOL_FLASH:
                raise AssertionError(f"K11 T={T} {n} disagrees: rel {r}")
        if T != 512:
            continue
        # the library yardstick on the unpadded case: SDPA [B, H, T, Dh]
        heads = lambda t: t.transpose(1, 2).detach()  # noqa: E731
        lq, lk, lv = (heads(t).requires_grad_() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            lq, lk, lv, is_causal=True, enable_gqa=True)
        o_l = sdpa()
        fwds = (lambda: flash_attention(q, k, v, seg, True, scale),
                lambda: flash_attention_plain(q, k, v, seg, True, scale),
                sdpa)
        bwds = ((o_k, in_k, do), (o_p, in_p, do), (o_l, (lq, lk, lv),
                                                   heads(do)))
        # back-to-back event times (the kernels line) and, as information,
        # the same runs queued behind a sleep kernel: (kernel, plain, SDPA)
        times = {}
        for queued in (False, True):
            with torch.no_grad():
                f = [cuda_time_ms(fn, queued=queued) for fn in fwds]
            b = [_backward_ms(*a, queued=queued) for a in bwds]
            times[queued] = (f, b)
        (fwd_ms, plain_fwd_ms, lib_fwd), (bwd_ms, plain_bwd_ms, lib_bwd) = \
            times[False]
        (q_fwd, q_plain_fwd, q_lib_fwd), (q_bwd, q_plain_bwd, q_lib_bwd) = \
            times[True]
        # work this run's data needs: the (query, key) pairs the causal and
        # segment rules allow, 4*Dh operations a pair a head forward
        # (q.k and p.v), 10*Dh backward (s, dp, dv, dk, dq)
        allowed = ((seg[:, :, None] == seg[:, None, :])
                   & torch.ones(T, T, dtype=torch.bool,
                                device="cuda").tril())
        pairs = int(allowed.sum())
        bq, bkv, blse = 2 * B * T * H * Dh, 2 * B * T * Hkv * Dh, 4 * B * H * T
        fwd_bound = bound(bq + 2 * bkv + bq + blse + 4 * B * T,
                          4 * Dh * H * pairs, "bf16")
        bwd_bound = bound(3 * bq + 2 * bkv + blse + 4 * B * T  # q,o,dO,lse
                          + bq + 2 * bkv,                     # dq, dk, dv
                          10 * Dh * H * pairs, "bf16")
        fwd_ops, bwd_ops = 4 * Dh * H * pairs, 10 * Dh * H * pairs
        print(f"K11 times ({gpu_line()}): forward {fwd_ms:.4f} ms "
              f"({fwd_ops / fwd_ms / 1e9:.1f} TFLOP/s, "
              f"{fwd_bound[0] / fwd_ms:.3f} of the bound), backward "
              f"{bwd_ms:.4f} ms ({bwd_ops / bwd_ms / 1e9:.1f} TFLOP/s, "
              f"{bwd_bound[0] / bwd_ms:.3f} of the bound) (forward+backward "
              f"{fwd_ms + bwd_ms:.4f}); plain {plain_fwd_ms:.4f} + "
              f"{plain_bwd_ms:.4f} ms; scaled_dot_product_attention "
              f"{lib_fwd:.4f} + {lib_bwd:.4f} ms ({fwd_ops / lib_fwd / 1e9:.1f}"
              f" + {bwd_ops / lib_bwd / 1e9:.1f} TFLOP/s); bound "
              f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}) + {bwd_bound[0]:.4f} "
              f"ms ({bwd_bound[1]}); {pairs} allowed (query, key) pairs per "
              f"head; queued: forward {q_fwd:.4f} ms "
              f"({fwd_ops / q_fwd / 1e9:.1f} TFLOP/s, "
              f"{fwd_bound[0] / q_fwd:.3f} of the bound), backward "
              f"{q_bwd:.4f} ms ({bwd_ops / q_bwd / 1e9:.1f} TFLOP/s, "
              f"{bwd_bound[0] / q_bwd:.3f} of the bound); plain "
              f"{q_plain_fwd:.4f} + {q_plain_bwd:.4f} ms; "
              f"scaled_dot_product_attention {q_lib_fwd:.4f} + "
              f"{q_lib_bwd:.4f} ms", flush=True)
        out = {
            "flash_attention": (errs[0][0], fwd_ms,
                                plain_fwd_ms, *fwd_bound, lib_fwd),
            "flash_attention_bwd": (max(e[0] for e in errs[1:]), bwd_ms,
                                    plain_bwd_ms, *bwd_bound, lib_bwd),
        }
    flash_vs_masked(gen)
    return out


def flash_vs_masked(gen) -> None:
    """Information: K11 forward and forward+backward against the masked
    path (``ops/attention.mha`` below FLASH_MIN_T: ``ops/core.mha``) at the
    flagship train shape B=12, T=300, H=32, Hkv=8, Dh=128, causal, where
    the dispatch takes the masked path; one row padded from 250."""
    import torch
    from desta25_audio_tpu_torch.ops.attention import (FLASH_MIN_T, mha,
                                                       flash_attention)
    B, T, H, Hkv, Dh = 12, 300, 32, 8, 128
    mk = lambda h: torch.randn(B, T, h, Dh, generator=gen,  # noqa: E731
                               device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
    seg = torch.ones(B, T, dtype=torch.int32, device="cuda")
    seg[1, 250:] = 0
    paths = {"K11": lambda *a: flash_attention(*a, seg, True),
             "masked": lambda *a: mha(*a, attention_mask=seg, causal=True)}
    times, outs = {}, {}
    for name, fn in paths.items():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            fwd = cuda_time_ms(lambda: fn(q, k, v), queued=True)

        def step():
            o = fn(*leaves)
            torch.autograd.grad(o, leaves, do)
        times[name] = (fwd, cuda_time_ms(step, queued=True))
        outs[name] = fn(q, k, v)
    err, rel = rel_err(outs["K11"][:, :250], outs["masked"][:, :250])
    print(f"K11 vs the masked path at B={B} T={T} H={H} Hkv={Hkv} Dh={Dh} "
          f"causal (information; the dispatch takes K11 from T={FLASH_MIN_T}"
          f", {gpu_line()}): forward {times['K11'][0]:.4f} vs "
          f"{times['masked'][0]:.4f} ms, forward+backward "
          f"{times['K11'][1]:.4f} vs {times['masked'][1]:.4f} ms; outputs "
          f"agree to rel {rel:.3e} on the unpadded rows", flush=True)


def check_mel(gen, signals):
    """4 (K1). The log-mel frontend against its plain version, after the
    clip-wide clamp (what the model reads): B=2 x 3000 frames x 128 mels of
    noise plus a tone and B=1 x 300 frames x 80 mels (a ragged tile), within
    TOL_MEL; the two synthetic WAVs zero-padded to 30 s, within TOL_MEL_WAV;
    two launches bit-identical on each.  CUDA-event times of both versions
    and the bound at B=2 x 3000 x 128 (back to back: the kernels line); the
    kernel queued behind a sleep kernel (the card's time) at B=1, 2 and 4
    x 3000 x 128 beside its bound and, as information, ``torch.stft``
    (cuFFT) + the dense filterbank + log10 on the same audio
    (``bench_mel.queued_ms``, the sweep ``bench_mel`` records: three calls,
    so ``library_ms`` stays null); both versions' times at B=1, 2 and 4 on the WAVs (the perception
    share after phase 11).  Returns (JSON row, {B: (kernel ms, plain
    ms)})."""
    import torch
    from desta25_audio_tpu_torch.audio.mel import (mel_filter_bank,
                                                   normalize_log_spec)
    from desta25_audio_tpu_torch.bench_mel import mel_work, queued_ms, signal
    from desta25_audio_tpu_torch.ops.mel import (log_mel_spec,
                                                 log_mel_spec_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    wav = np.zeros((2, 480000), np.float32)
    for j, sig in enumerate(signals):
        wav[j, :min(sig.size, 480000)] = sig[:480000]
    wav = torch.from_numpy(wav).cuda()
    worst = 0.0
    for label, B, frames, n_mels, tol in (
            ("noise + tone", 2, 3000, 128, TOL_MEL),
            ("noise + tone", 1, 300, 80, TOL_MEL),
            ("synthetic WAVs, zero-padded", 2, 3000, 128, TOL_MEL_WAV)):
        audio = signal(B, frames, gen) if label.startswith("noise") else wav
        pre_k = log_mel_spec(audio, n_mels)
        pre_p = log_mel_spec_plain(audio, n_mels)
        err = float((normalize_log_spec(pre_k)
                     - normalize_log_spec(pre_p)).abs().max())
        live = pre_p > pre_p.amax(dim=(1, 2), keepdim=True) - 8.0
        pre_err = float((pre_k - pre_p).abs()[live].max())
        same = torch.equal(log_mel_spec(audio, n_mels), pre_k)
        print(f"K1 log_mel B={B} frames={frames} mels={n_mels} ({label}): "
              f"max_abs_err={err:.3e} after the clamp (tol {tol}); before "
              f"it {pre_err:.3e} over the bins above the clamp; two "
              f"launches bit-identical: {same}", flush=True)
        if not err <= tol:
            raise AssertionError(f"K1 disagrees ({label}, B={B}): {err}")
        if not same:
            raise AssertionError(f"K1's two launches differ ({label})")
        worst = max(worst, err)
        if B == 2 and label.startswith("noise"):
            ms = cuda_time_ms(lambda: log_mel_spec(audio, n_mels))
            plain_ms = cuda_time_ms(lambda: log_mel_spec_plain(audio,
                                                               n_mels))
            b_ms, b_by = bound(*mel_work(B, frames, n_mels), "f32")
    fb = torch.as_tensor(mel_filter_bank(128), device="cuda")
    window = torch.hann_window(400, periodic=True, device="cuda")
    queued = []
    for B in (1, 2, 4):
        audio = signal(B, 3000, gen)
        k_ms, s_ms = queued_ms(log_mel_spec, audio, fb, window)
        bq = bound(*mel_work(B, 3000, 128), "f32")[0]
        queued.append(f"B={B} {k_ms:.4f} ms (bound {bq:.4f}, "
                      f"{bq / k_ms:.3f} of it; torch.stft + filterbank + "
                      f"log10 {s_ms:.4f})")
    by_batch = {}
    for B in (1, 2, 4):
        a = wav[:1] if B == 1 else wav if B == 2 else torch.cat([wav, wav])
        by_batch[B] = (cuda_time_ms(lambda: log_mel_spec(a, 128)),
                       cuda_time_ms(lambda: log_mel_spec_plain(a, 128)))
    print(f"K1 times ({gpu_line()}): B=2 x 3000 x 128 kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); queued "
          f"x 3000 x 128: " + "; ".join(queued) + "; on the WAVs at B=1, "
          f"2, 4 kernel / plain: " + ", ".join(
              f"{k:.4f} / {p:.4f} ms" for k, p in by_batch.values()),
          flush=True)
    return (worst, ms, plain_ms, b_ms, b_by), by_batch


def decode_inputs(params, cfg, gen, kd: int, ci):
    """The inputs of the decode-step checks: B=2 rows, a random bf16 cache
    [L, 2, 256, Hkv*Dh], row 0 left-padded by 10, kd tokens a row written
    at ci..ci+kd-1, their random ids' embeddings.  Returns (ci, cache0,
    mask, positions, x)."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    B, S = 2, 256
    ci = torch.tensor(ci, device="cuda")
    cache0 = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache0.k.normal_(generator=gen)
    cache0.v.normal_(generator=gen)
    mask = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    mask[0, 10:] = 1             # row 0: left padding of 10
    mask[1, :] = 1
    steps = torch.arange(kd, device="cuda")[None, :]
    positions = (ci - torch.tensor([10, 0], device="cuda"))[:, None] + steps
    ids = torch.randint(0, 512, (B, kd), generator=gen, device="cuda")
    return ci, cache0, mask, positions, tllm.embed_tokens(params, ids)


def fresh_cache(cache0, lo: int, hi: int):
    from desta25_audio_tpu_torch.ops.fused_decode import KVCache
    return KVCache(cache0.k[lo:hi].clone(), cache0.v[lo:hi].clone())


def check_written_rows(cache, cache0, ci, kd: int, tag: str) -> None:
    """The cache must change at the rows ci..ci+kd-1 and nowhere else."""
    import torch
    changed = (cache.k != cache0.k).any(-1) | (cache.v != cache0.v).any(-1)
    expect = torch.zeros_like(changed)
    for b in range(ci.shape[0]):
        expect[:, b, int(ci[b]):int(ci[b]) + kd] = True
    if not bool((changed == expect).all()):
        raise AssertionError(f"{tag} wrote cache rows other than ci..ci+kd-1")


def logit_checks(kernel, plain, params, cfg, inputs, extra=lambda lo, hi: {}):
    """Logits through the first two layers, kernel against plain (the
    setting of tests/test_fused_decode.py), and through the whole stack,
    beside the plain version's own change when one input element moves by
    one bf16 ulp (random layers amplify rounding: information).  extra(lo,
    hi): the step's keyword arguments for layers lo..hi-1.  Returns (2-layer
    max_abs_err, its rel, whole-stack rel, the ulp rel)."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.core import rms_norm
    ci, cache0, mask, positions, x = inputs
    L = cfg.num_hidden_layers

    def logits(fn, lo, hi, xin=x):
        p = _layer_slice(params, lo, hi)
        h, _ = fn(p, cfg, xin, mask, positions, fresh_cache(cache0, lo, hi),
                  ci, **extra(lo, hi))
        return tllm.head_logits(p, rms_norm(p["norm"], h, cfg.rms_norm_eps))
    err2, rel2 = rel_err(logits(kernel, 0, 2), logits(plain, 0, 2))
    want = logits(plain, 0, L)
    _, rel_all = rel_err(logits(kernel, 0, L), want)
    x_ulp = x.clone()
    x_ulp.view(torch.int16)[0, 0, 0] += 1
    _, rel_ulp = rel_err(logits(plain, 0, L, x_ulp), want)
    return err2, rel2, rel_all, rel_ulp


def check_fused_tp(params, cfg, gen, ci=(100, 200)):
    """13 (K9). The per-layer decode pair on the int8 Llama-3.1-8B tower
    (full width, all 32 layers), B=2, S=256, per-row ci, row 0 left-padded
    by 10, gated at TOL_DECODE: (1) each layer's attention and MLP half,
    kernel against plain, fed the same f32 residual (the plain trajectory),
    with the written k/v rows and no other cache row changed; (2) logits
    through two layers of its layer loop; (3) logits through all 32
    layers, beside the plain loop's own change for a one-ulp input move
    (information).  Then layer 0 at the p=2 and p=4 shard shapes: each
    rank's halves, kernel against plain, and the ranks' kernel partials
    summed against the unsharded plain half.  Then K9's q/k/v and gate/up
    products alone (the step's norm kernel on the f32 residual, then the
    skinny GEMM) on layer 0's weights at B = 1, 2, 3, 8, 16 and 32 rows of
    a random f32 residual: the norm bit-identical to the norm of the rows
    cast to bf16, the products against their plain versions within
    TOL_DECODE, two runs bit-identical.  Returns the JSON rows of the two
    halves (worst error; layer 0's times and bound), and the step's
    time."""
    import torch
    from desta25_audio_tpu_torch.ops import fused_decode_tp as ttp
    from desta25_audio_tpu_torch.ops.fused_decode import KVCache
    B, S, L, D = 2, 256, cfg.num_hidden_layers, cfg.hidden_size
    inputs = decode_inputs(params, cfg, gen, 1, ci)
    ci, cache0, mask, positions, x = inputs
    step = ttp.decode_step_inputs(cfg, mask, positions, ci, B)

    def fresh(lo=0, hi=L):
        return fresh_cache(cache0, lo, hi)

    # (1) each half of each layer on the plain trajectory
    ck, cp = fresh(), fresh()
    h = x.reshape(B, D).to(torch.bfloat16).float()
    errs = {"attn": 0.0, "mlp": 0.0}
    worst = {"attn": 0.0, "mlp": 0.0, "k row": 0.0, "v row": 0.0}
    for l in range(L):
        pl_ = _layer_slice(params, l, l + 1)
        kc, pc = (KVCache(c.k[l:l + 1], c.v[l:l + 1]) for c in (ck, cp))
        got = ttp.attn_half(pl_, cfg, h, step, kc, 0)
        want = ttp.attn_half_plain(pl_, cfg, h, step, pc, 0)
        e, r = rel_err(got, want)
        errs["attn"], worst["attn"] = max(errs["attn"], e), max(worst["attn"],
                                                                r)
        for b in range(B):
            for side in ("k", "v"):
                worst[f"{side} row"] = max(worst[f"{side} row"], rel_err(
                    getattr(kc, side)[0, b, int(ci[b])],
                    getattr(pc, side)[0, b, int(ci[b])])[1])
        h = h + want
        got, want = (ttp.mlp_half(pl_, cfg, h, 0),
                     ttp.mlp_half_plain(pl_, cfg, h, 0))
        e, r = rel_err(got, want)
        errs["mlp"], worst["mlp"] = max(errs["mlp"], e), max(worst["mlp"], r)
        h = h + want
    check_written_rows(ck, cache0, ci, 1, "K9")
    kern, plain = (ttp.fused_decode_layers_perlayer,
                   ttp.fused_decode_layers_perlayer_plain)
    err2, rel2, rel_all, rel_ulp = logit_checks(kern, plain, params, cfg,
                                                inputs)
    step_ms = cuda_time_ms(lambda: kern(params, cfg, x, mask, positions, ck,
                                        ci), iters=5)
    q_step_ms = cuda_time_ms(lambda: kern(params, cfg, x, mask, positions,
                                          ck, ci), iters=3, queued=True)
    plain_step_ms = cuda_time_ms(lambda: plain(params, cfg, x, mask,
                                               positions, cp, ci), iters=3)
    step_bound = bound(*llm_step_work(params, cfg, B, 1, ci.tolist()), "bf16")
    print(f"K9 fused_decode_layers_perlayer L={L} B={B} S={S} ci="
          f"{ci.tolist()}: per-layer rel attention half {worst['attn']:.3e}, "
          f"MLP half {worst['mlp']:.3e}, written k / v rows {worst['k row']:.3e}"
          f" / {worst['v row']:.3e}; 2-layer logits max_abs_err={err2:.3e} "
          f"rel={rel2:.3e} (tol {TOL_DECODE} each); cache rows at ci only; "
          f"{L}-layer logits rel={rel_all:.3e} (plain vs plain with one input "
          f"ulp moved: {rel_ulp:.3e}); kernels {step_ms:.4f} ms/step "
          f"({q_step_ms:.4f} queued), plain "
          f"{plain_step_ms:.4f} ms/step, bound {step_bound[0]:.4f} ms "
          f"({step_bound[1]})", flush=True)
    if max(*worst.values(), rel2) > TOL_DECODE:
        raise AssertionError(f"K9 disagrees: {worst}, logits {rel2}")

    # layer 0's halves alone: times and bounds
    p0 = _layer_slice(params, 0, 1)
    c0 = fresh(0, 1)
    h0 = x.reshape(B, D).to(torch.bfloat16).float()
    lay = p0["layers"]
    KVD = cfg.num_key_value_heads * cfg.head_dim
    H, Dh = cfg.num_attention_heads, cfg.head_dim

    def leaf_bytes(*keys):
        return sum(tree_bytes(lay[k]) for k in keys)
    attn_nb = (leaf_bytes("wqkv", "wo", "ln1") + 2 * 2 * KVD * (
        int(ci.sum()) + B) + 2 * B * D * 4)
    attn_ops = (2 * B * (lay["wqkv"]["q"].numel() + lay["wo"]["q"].numel())
                + 4 * H * Dh * int((ci + 1).sum()))
    mlp_nb = leaf_bytes("w_gu", "w_down", "ln2") + 2 * B * D * 4
    mlp_ops = 2 * B * (lay["w_gu"]["q"].numel() + lay["w_down"]["q"].numel())
    rows = {}
    for name, kfn, pfn, work in (
            ("fused_decode_tp_attn",
             lambda: ttp.attn_half(p0, cfg, h0, step, c0, 0),
             lambda: ttp.attn_half_plain(p0, cfg, h0, step, c0, 0),
             (attn_nb, attn_ops)),
            ("fused_decode_tp_mlp", lambda: ttp.mlp_half(p0, cfg, h0, 0),
             lambda: ttp.mlp_half_plain(p0, cfg, h0, 0), (mlp_nb, mlp_ops))):
        ms, plain_ms = cuda_time_ms(kfn), cuda_time_ms(pfn)
        q_ms = cuda_time_ms(kfn, queued=True)
        b_ms, b_by = bound(*work, "bf16")    # as K8-int8's same stream
        half = "attn" if name.endswith("attn") else "mlp"
        rows[name] = (errs[half], ms, plain_ms, b_ms, b_by)
        print(f"K9 {name} (layer 0, B={B}, {gpu_line()}): kernels {ms:.4f} "
              f"ms ({q_ms:.4f} queued), plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)

    # layer 0 at the shard shapes of p = 2 and 4
    want_a = ttp.attn_half_plain(p0, cfg, h0, step, fresh(0, 1), 0)
    want_m = ttp.mlp_half_plain(p0, cfg, h0, 0)
    for p in (2, 4):
        parts_a, parts_m, rank_worst = [], [], 0.0
        for r in range(p):
            sp, sc = ttp.shard_layers(p0, cfg, p, r)
            kc = ttp.shard_cache(fresh(0, 1), cfg, p, r)
            pc = KVCache(kc.k.clone(), kc.v.clone())
            ga = ttp.attn_half(sp, sc, h0, step, kc, 0)
            gm = ttp.mlp_half(sp, sc, h0, 0)
            rank_worst = max(
                rank_worst,
                rel_err(ga, ttp.attn_half_plain(sp, sc, h0, step, pc, 0))[1],
                rel_err(gm, ttp.mlp_half_plain(sp, sc, h0, 0))[1],
                rel_err(kc.k, pc.k)[1])
            parts_a.append(ga)
            parts_m.append(gm)
        sum_a = rel_err(sum(parts_a), want_a)[1]
        sum_m = rel_err(sum(parts_m), want_m)[1]
        print(f"K9 layer 0 at p={p} ({sc.num_attention_heads} heads, "
              f"{sc.num_key_value_heads} kv heads, I/p="
              f"{sc.intermediate_size} a rank): each rank kernels vs plain "
              f"rel <= {rank_worst:.3e}; summed kernel partials vs the p=1 "
              f"plain half: attention {sum_a:.3e}, MLP {sum_m:.3e} (tol "
              f"{TOL_DECODE})", flush=True)
        if max(rank_worst, sum_a, sum_m) > TOL_DECODE:
            raise AssertionError(f"K9 at p={p} disagrees")
    check_k9_products(p0, cfg)
    return rows, step_ms


def check_k9_products(p0, cfg) -> None:
    """13 (K9's q/k/v and gate/up products): check_fused_tp's last part."""
    import torch
    from desta25_audio_tpu_torch.ops import skinny_gemm as tsg
    from desta25_audio_tpu_torch.ops.fused_decode import decode_rms_norm
    gen = torch.Generator("cuda").manual_seed(11)
    lay, D, eps = p0["layers"], cfg.hidden_size, float(cfg.rms_norm_eps)
    products = (("q/k/v", lay["wqkv"], lay["ln1"], tsg.EPI_STORE),
                ("gate/up", lay["w_gu"], lay["ln2"], tsg.EPI_SWIGLU))
    worst = 0.0
    for label, leaf, ln, epi in products:
        w, s, lw = leaf["q"][0], leaf["s"][0], ln["scale"][0]

        def product(h):
            return tsg.skinny_gemm(decode_rms_norm(h, lw, eps), w, s, epi)
        errs = []
        for B in (1, 2, 3, 8, 16, 32):
            h = torch.randn(B, D, generator=gen, device="cuda") * 3
            xn = decode_rms_norm(h, lw, eps)
            if not torch.equal(xn, decode_rms_norm(h.bfloat16(), lw, eps)):
                raise AssertionError(f"K9 {label} B={B}: the norm of the "
                                     "f32 rows is not that of their bf16")
            got = product(h)
            want = tsg.skinny_gemm_plain(
                decode_rms_norm(h.cpu(), lw.cpu(), eps).cuda(), w, s, epi)
            errs.append(rel_err(got, want)[1])
            if not torch.equal(got, product(h)):
                raise AssertionError(f"K9 {label} B={B}: two runs differ")
        worst = max(worst, *errs)
        print(f"K9 {label} (the norm kernel on f32 rows, then the skinny "
              f"GEMM; {leaf['q'].shape[1]} x {D}): rel vs plain at "
              f"B=1/2/3/8/16/32 {' / '.join(f'{e:.3e}' for e in errs)} (tol "
              f"{TOL_DECODE}); the norm bit-identical to the bf16 rows'; two "
              f"runs bit-identical", flush=True)
    if worst > TOL_DECODE:
        raise AssertionError(f"K9's products disagree: {worst}")


def _int8_leaf(gen, n: int, k: int, bias: bool = True, mult=1.0):
    from desta25_audio_tpu_torch.ops.quant import quantize_linear
    import torch
    p = {"w": (torch.randn(n, k, generator=gen, device="cuda")
               / k ** 0.5 * mult).to(torch.bfloat16)}
    if bias:
        p["b"] = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(
            torch.bfloat16)
    return quantize_linear(p)


def check_w8a8(gen):
    """K5 qkv_w8a8, K6 proj_w8a8 and K4 encoder_ffn_w8a8 against their
    plain versions at the int8 encoder's shapes, D=1280, F=5120, M in
    GEMM_ROWS: bit-identical (exact int32 sums, the plain versions'
    rounding points) and so within TOL_W8A8.  Then K4 at M=1500 on weights
    that make hidden chunks 1-3 64x smaller than chunk 0 (fc2 makes up for
    it), so that a quantisation over the whole hidden row fails.  Back-to-
    back and queued times.  Returns {name: (worst err, ms, plain_ms, bound
    ms, bound by)}, the times at M=3000."""
    import torch
    from desta25_audio_tpu_torch.ops.enc_ffn import (encoder_ffn_w8a8,
                                                     encoder_ffn_w8a8_plain)
    from desta25_audio_tpu_torch.ops.w8a8_proj import (
        proj_w8a8, proj_w8a8_plain, qkv_w8a8, qkv_w8a8_plain)
    D, Fd = 1280, 5120
    lq, lk, lv, lo = (_int8_leaf(gen, D, D, bias=b)
                      for b in (True, False, True, True))
    l1, l2 = _int8_leaf(gen, Fd, D), _int8_leaf(gen, D, Fd)
    ffn = (l1["q"], l1["s"], l1["b"], l2["q"], l2["s"], l2["b"])
    cases = {
        "qkv_w8a8": ("K5", lambda x: qkv_w8a8(x, lq, lk, lv),
                     lambda x: qkv_w8a8_plain(x, lq, lk, lv)),
        "proj_w8a8": ("K6", lambda x: (proj_w8a8(x, lo),),
                      lambda x: (proj_w8a8_plain(x, lo),)),
        "encoder_ffn_w8a8": ("K4", lambda x: (encoder_ffn_w8a8(x, *ffn),),
                             lambda x: (encoder_ffn_w8a8_plain(x, *ffn),)),
    }
    rows = {}
    for M in GEMM_ROWS:
        x = torch.randn(1, M, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        for name, (tag, kern, plain) in cases.items():
            err, rel, same = 0.0, 0.0, True
            for g, w in zip(kern(x), plain(x)):
                e, r = rel_err(g, w)
                err, rel = max(err, e), max(rel, r)
                same = same and torch.equal(g, w)
            ms = cuda_time_ms(lambda: kern(x))
            q_ms = cuda_time_ms(lambda: kern(x), queued=True)
            plain_ms = cuda_time_ms(lambda: plain(x))
            print(f"{tag} {name} M={M} D={D}"
                  + (f" F={Fd}" if tag == "K4" else f" N={D}")
                  + f": max_abs_err={err:.3e} rel={rel:.3e} (tol "
                  f"{TOL_W8A8}), bit-identical {same}; kernel {ms:.4f} ms "
                  f"({q_ms:.4f} queued), plain {plain_ms:.4f} ms",
                  flush=True)
            if rel > TOL_W8A8 or not same:
                raise AssertionError(f"{tag} disagrees at M={M}: rel {rel}")
            prev = rows.get(name, (0.0, 0.0, 0.0))
            rows[name] = ((max(prev[0], err), ms, plain_ms) if M == 3000
                          else (max(prev[0], err),) + prev[1:])
    mult = torch.where(torch.arange(Fd, device="cuda") >= 1280, 1 / 64, 1.0)
    s1, s2 = (_int8_leaf(gen, Fd, D, mult=mult[:, None]),
              _int8_leaf(gen, D, Fd, mult=1 / mult[None, :]))
    skew = (s1["q"], s1["s"], s1["b"], s2["q"], s2["s"], s2["b"])
    x = torch.randn(1, 1500, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    got, want = encoder_ffn_w8a8(x, *skew), encoder_ffn_w8a8_plain(x, *skew)
    err, rel = rel_err(got, want)
    same = torch.equal(got, want)
    print(f"K4 encoder_ffn_w8a8 M=1500 D={D} F={Fd}, GELU chunks 64x apart"
          f": max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL_W8A8}), "
          f"bit-identical {same}", flush=True)
    if rel > TOL_W8A8 or not same:
        raise AssertionError(f"K4 disagrees on skewed chunks: rel {rel}")
    prev = rows["encoder_ffn_w8a8"]
    rows["encoder_ffn_w8a8"] = (max(prev[0], err),) + prev[1:]
    # bounds at M = 3000 (the times' shape): bf16 x in and out, int8
    # weights with f32 scales and bf16 biases, int8 operations
    M, io = 3000, 2 * 3000 * D * 2
    work = {"qkv_w8a8": (io + 2 * 3000 * D * 2 + 3 * D * (D + 6),
                         6 * M * D * D),
            "proj_w8a8": (io + D * (D + 6), 2 * M * D * D),
            "encoder_ffn_w8a8": (io + 2 * D * Fd + 6 * (Fd + D),
                                 4 * M * D * Fd)}
    for name, (nb, ops) in work.items():
        rows[name] = rows[name] + bound(nb, ops, "int8")
    return rows


def _slice(tree, lo: int, hi: int):
    """Layers lo..hi-1 of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _layer_slice(params, lo: int, hi: int):
    """Layers lo..hi-1 of a stacked LLM param tree."""
    return {**params, "layers": _slice(params["layers"], lo, hi)}


def _inject_slice(inject, lo: int, hi: int):
    """Layers lo..hi-1 of an injection spec (stack and audio K/V)."""
    if inject is None:
        return None
    return {**inject, "params": {"layers": _slice(
        inject["params"]["layers"], lo, hi)},
        "k": inject["k"][lo:hi], "v": inject["v"][lo:hi]}


def _attention_case(gen, B, S, H, Hkv, kd, ci, qk_norm=False):
    """Inputs of the standalone decode attention: random bf16 qkv rows
    [B*kd, (H+2*Hkv)*128] and cache [B, S, Hkv*128], RoPE tables of random
    angles, row 0 left-padded by 10, ci [B], the qk-norm weights or None."""
    import torch
    Dh, R = 128, B * kd
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device="cuda")
    qkv = rnd(R, (H + 2 * Hkv) * Dh).to(torch.bfloat16)
    kc = rnd(B, S, Hkv * Dh).to(torch.bfloat16)
    vc = rnd(B, S, Hkv * Dh).to(torch.bfloat16)
    ang = 6.2832 * torch.rand(R, Dh // 2, generator=gen, device="cuda")
    cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
    sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    mask[0, :10] = 0
    norms = ((1 + 0.1 * rnd(Dh)).to(torch.bfloat16),
             (1 + 0.1 * rnd(Dh)).to(torch.bfloat16)) if qk_norm else (None,
                                                                      None)
    ci = torch.as_tensor(ci, dtype=torch.int32, device="cuda")
    return qkv, kc, vc, cos, sin, mask, ci, *norms


def check_decode_attention(gen):
    """13 (the K8 family's attention launch). The standalone
    ``decode_attention`` (csrc/decode_attention.cuh: keys split across a
    thread-block cluster, TMA tiles) against ``decode_attention_plain`` at
    Llama-3.1-8B's heads (H=32, Hkv=8, Dh=128): B=2, S=256, ci=(100, 200)
    at Kd=1 and (100, 252) at Kd=4; B=2, S=4096, ci=(3000, 4095); B=8,
    S=1024, per-row ci from the seed; G=8 (Hkv=4) and a qk-norm case.  The
    output and the written k / v rows within TOL_DECODE, no other cache row
    changed, two launches' bits equal; a control, the plain version with the
    first key range dropped, must read above the gate.  The C side's plan
    must be the planner's.  Times at the b2 decode, b2 verify and long-cache
    shapes: kernel, plain, bound, and ``scaled_dot_product_attention`` over
    the cached keys alone (information), back-to-back CUDA events (the
    kernels line) and, as information, queued behind a sleep kernel (the
    card's time, not the Python launch path's).  Returns the JSON row of
    the b2 decode shape, (err, ms, plain_ms, bound_ms, bound_by,
    library_ms)."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.fused_decode import (
        decode_attention, decode_attention_plain, decode_attention_smem,
        plan_decode_splits)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    H, Dh = 32, 128
    gen_ci = torch.randint(64, 1024, (8,), generator=gen, device="cuda")
    cases = [  # label, B, S, Hkv, kd, ci, qk_norm
        ("b2 decode", 2, 256, 8, 1, (100, 200), False),
        ("b2 verify", 2, 256, 8, 4, (100, 252), False),
        ("long cache", 2, 4096, 8, 1, (3000, 4095), False),
        ("b8", 8, 1024, 8, 1, tuple(gen_ci.tolist()), False),
        ("G=8", 2, 256, 4, 1, (100, 200), False),
        ("qk-norm", 2, 256, 8, 1, (37, 256), True),
    ]
    lib = _build.library()
    row = None
    for label, B, S, Hkv, kd, ci, qk_norm in cases:
        G = H // Hkv
        bounds = plan_decode_splits(B, Hkv, S, n_sm)
        plan = (ctypes.c_int * 3)()
        _build.check(lib.desta_decode_attention_plan(B, Hkv, kd, S, H,
                                                     ctypes.addressof(plan)),
                     "desta_decode_attention_plan")
        want_plan = (len(bounds) - 1, -(-(bounds[1] - bounds[0]) // 32) * 32,
                     decode_attention_smem(G, kd, bounds[1] - bounds[0]))
        if tuple(plan) != want_plan:
            raise AssertionError(f"decode attention plan {tuple(plan)} vs "
                                 f"the planner's {want_plan} at {label}")
        qkv, kc, vc, cos, sin, mask, ci_t, qn, kn = _attention_case(
            gen, B, S, H, Hkv, kd, ci, qk_norm)
        eps, scale = 1e-5, Dh ** -0.5
        args = (cos, sin, mask, ci_t, qn, kn, H, Hkv, eps, scale)
        ck, cp = (kc.clone(), vc.clone()), (kc.clone(), vc.clone())
        _build.reset_launch_counts()
        got = decode_attention(qkv, *ck, *args)
        again = decode_attention(qkv, kc.clone(), vc.clone(), *args)
        torch.cuda.synchronize()
        if _build.launch_counts() != {"decode_attention": 2}:
            raise AssertionError(f"decode_attention launches "
                                 f"{_build.launch_counts()}")
        want = decode_attention_plain(qkv, *cp, *args)
        err, rel = rel_err(got, want)
        rows_rel = 0.0
        expect = torch.zeros(B, S, dtype=torch.bool, device="cuda")
        for b in range(B):
            w = slice(ci[b], min(ci[b] + kd, S))
            expect[b, w] = True
            if w.stop > w.start:
                rows_rel = max(rows_rel, rel_err(ck[0][b, w], cp[0][b, w])[1],
                               rel_err(ck[1][b, w], cp[1][b, w])[1])
        changed = (ck[0] != kc).any(-1) | (ck[1] != vc).any(-1)
        # control: the plain version without the first key range
        holed = mask.clone()
        holed[:, :bounds[1]] = 0
        _, ctrl = rel_err(decode_attention_plain(
            qkv, kc.clone(), vc.clone(), cos, sin, holed, ci_t, qn, kn, H,
            Hkv, eps, scale), want)
        bits = torch.equal(got, again)
        print(f"decode_attention [{label}] B={B} S={S} H={H} Hkv={Hkv} "
              f"Kd={kd} ci={list(ci)}{' qk-norm' if qk_norm else ''}: "
              f"{len(bounds) - 1} key ranges of {bounds[1] - bounds[0]}, "
              f"{B * Hkv * kd * (len(bounds) - 1)} CTAs; max_abs_err="
              f"{err:.3e} rel={rel:.3e}, written k / v rows rel="
              f"{rows_rel:.3e} (tol {TOL_DECODE}); control, first range "
              f"dropped: rel={ctrl:.3e} (must exceed {TOL_DECODE}); two "
              f"launches bit-identical: {bits}", flush=True)
        if max(rel, rows_rel) > TOL_DECODE:
            raise AssertionError(f"decode_attention [{label}] disagrees: "
                                 f"{rel}, rows {rows_rel}")
        if not torch.equal(changed, expect):
            raise AssertionError(f"decode_attention [{label}] wrote cache "
                                 "rows other than ci..ci+kd-1")
        if not ctrl > TOL_DECODE:
            raise AssertionError(f"decode_attention [{label}]: the control "
                                 f"reads {ctrl}, within the gate")
        if not bits:
            raise AssertionError(f"decode_attention [{label}]: two launches "
                                 "differ")
        if label not in ("b2 decode", "long cache", "b2 verify"):
            continue
        # times: the kernel on its cache (rewriting the same rows), the
        # plain version, SDPA over the cached keys alone (no RoPE, no draft
        # block, no cache write), q [B, H, kd, Dh] against [B, Hkv, S, Dh]
        # with the keys below ci that the mask allows
        kern = lambda: decode_attention(qkv, *ck, *args)  # noqa: E731
        plain = lambda: decode_attention_plain(qkv, *cp, *args)  # noqa: E731
        nk = torch.clamp(ci_t.long(), max=S)
        allow = ((mask[:, :S] > 0)
                 & (torch.arange(S, device="cuda")[None] < nk[:, None]))
        q4 = qkv[:, :H * Dh].reshape(B, kd, H, Dh).transpose(1, 2)
        k4 = kc.view(B, S, Hkv, Dh).transpose(1, 2)
        v4 = vc.view(B, S, Hkv, Dh).transpose(1, 2)
        am = allow[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=am, enable_gqa=True)
        # back-to-back event times (the kernels line, as for every kernel)
        # and, as information, the same runs queued behind a sleep kernel:
        # the card's time, where the back-to-back reading is the Python
        # launch path's
        ms, plain_ms, lib_ms = (cuda_time_ms(f) for f in (kern, plain, sdpa))
        q_ms, q_plain, q_lib = (cuda_time_ms(f, iters=n, queued=True)
                                for f, n in ((kern, 50), (plain, 10),
                                             (sdpa, 50)))
        KVD = Hkv * Dh
        keys = int(nk.sum())
        written = int(expect.sum())
        nbytes = (keys * KVD * 2 * 2 + keys * 4            # K, V, mask rows
                  + qkv.numel() * 2 + 2 * cos.numel() * 4  # qkv, cos, sin
                  + B * kd * H * Dh * 2 + written * KVD * 2 * 2)
        pairs = int(allow.sum()) * kd + B * kd * (kd + 1) // 2
        b_ms, b_by = bound(nbytes, 4 * Dh * H * pairs, "f32")
        print(f"decode_attention [{label}] times ({gpu_line()}): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention over the cached keys alone "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} "
              f"bytes); queued: kernel {q_ms:.4f} ms ({nbytes / q_ms / 1e6:.1f}"
              f" GB/s, {b_ms / q_ms:.3f} of the bound), plain {q_plain:.4f} "
              f"ms, scaled_dot_product_attention {q_lib:.4f} ms", flush=True)
        if label == "b2 decode":
            row = (err, ms, plain_ms, b_ms, b_by, lib_ms)
    return row


def check_fused_decode(params, cfg, gen, kd=1, ci=(100, 200), tag="K8",
                       inject=None):
    """A decode step (kd = 1: K8, or K8-int8 on an int8 tree) or a verify
    step (kd > 1: K8v) on the flagship LLM params (full width, all 32
    layers), kd tokens per row written at ci..ci+kd-1; with ``inject``
    (K8i) the ORCA injection runs inside the step.

    Checked three ways: (1) every layer alone, both versions fed the same
    input (the plain trajectory), hidden and written k rows within
    TOL_DECODE; (2) logits through the first two layers within TOL_DECODE,
    the setting of tests/test_fused_decode.py; (3) logits through all 32
    layers, printed beside the plain version's own change when one input
    element moves by one bf16 ulp: with random weights small rounding
    differences grow through the stack, so (3) is informative.  The cache
    must change at the rows ci..ci+kd-1 and nowhere else."""
    import torch
    from desta25_audio_tpu_torch.ops.fused_decode import (
        KVCache, fused_decode_layers, fused_decode_layers_plain,
        fused_verify_layers)
    kernel = fused_decode_layers if kd == 1 else fused_verify_layers
    B, S, L = 2, 256, cfg.num_hidden_layers
    inputs = decode_inputs(params, cfg, gen, kd, ci)
    ci, cache0, mask, positions, x = inputs

    # (1) layer by layer on the plain trajectory
    ck, cp = fresh_cache(cache0, 0, L), fresh_cache(cache0, 0, L)
    h, worst, worst_row = x, 0.0, 0.0
    for l in range(L):
        pl_, il_ = _layer_slice(params, l, l + 1), _inject_slice(inject, l,
                                                                l + 1)
        hk, _ = kernel(pl_, cfg, h, mask, positions,
                       KVCache(ck.k[l:l + 1], ck.v[l:l + 1]), ci, inject=il_)
        hp, _ = fused_decode_layers_plain(
            pl_, cfg, h, mask, positions,
            KVCache(cp.k[l:l + 1], cp.v[l:l + 1]), ci, inject=il_)
        worst = max(worst, rel_err(hk, hp)[1])
        for b in range(B):
            rows = slice(int(ci[b]), int(ci[b]) + kd)
            worst_row = max(worst_row, rel_err(ck.k[l, b, rows],
                                               cp.k[l, b, rows])[1])
        h = hp
    check_written_rows(ck, cache0, ci, kd, tag)
    # (2), (3)
    err2, rel2, rel_all, rel_ulp = logit_checks(
        kernel, fused_decode_layers_plain, params, cfg, inputs,
        lambda lo, hi: {"inject": _inject_slice(inject, lo, hi)})
    ms = cuda_time_ms(lambda: kernel(
        params, cfg, x, mask, positions, ck, ci, inject=inject), iters=5)
    # the same steps queued behind the sleep kernel (3 steps: their ~224
    # launches each are issued well inside the sleep)
    q_ms = cuda_time_ms(lambda: kernel(
        params, cfg, x, mask, positions, ck, ci, inject=inject), iters=3,
        queued=True)
    # the step captured as one CUDA graph (what generate() replays), its
    # replays queued: the device's time a step
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernel(params, cfg, x, mask, positions, ck, ci, inject=inject)
    g_ms = cuda_time_ms(graph.replay, iters=10, queued=True)
    del graph
    plain_ms = cuda_time_ms(lambda: fused_decode_layers_plain(
        params, cfg, x, mask, positions, cp, ci, inject=inject), iters=5)
    b_ms, b_by = bound(*llm_step_work(params, cfg, B, kd, ci.tolist(),
                                      inject), "bf16")
    extra = ""
    if inject is not None:
        no_inj = cuda_time_ms(lambda: kernel(
            params, cfg, x, mask, positions, ck, ci), iters=5)
        extra = (f", the same step without injection {no_inj:.4f} ms/step "
                 f"(Ta={inject['ta_real']}, injection head dim "
                 f"{cfg.hidden_size // inject['heads']})")
    print(f"{tag} {kernel.__name__} L={L} B={B} Kd={kd} S={S} "
          f"ci={ci.tolist()}: per-layer hidden rel={worst:.3e}, written "
          f"k-row rel={worst_row:.3e}, 2-layer logits max_abs_err="
          f"{err2:.3e} rel={rel2:.3e} (tol {TOL_DECODE} each); cache rows at "
          f"ci..ci+{kd - 1} only; {L}-layer logits rel={rel_all:.3e} (plain "
          f"vs plain with one input ulp moved: {rel_ulp:.3e}); kernel "
          f"{ms:.4f} ms/step ({q_ms:.4f} queued, {g_ms:.4f} as a CUDA "
          f"graph's replay), plain {plain_ms:.4f} ms/step, bound "
          f"{b_ms:.4f} ms ({b_by}){extra}", flush=True)
    if max(worst, worst_row, rel2) > TOL_DECODE:
        raise AssertionError(f"{tag} disagrees: layer {worst} k-row "
                             f"{worst_row} logits {rel2}")
    return err2, ms, plain_ms, b_ms, b_by


# the step norm's check shapes: the b2 decode and b2 x Kd=4 verify rows at
# Llama-3.1-8B's width, the b2 decode at Qwen3-4B's
RMS_SHAPES = (("b2 decode", 2, 4096), ("b2 verify", 8, 4096),
              ("qwen3-4b b2", 2, 2560))


def check_rms_norm(gen):
    """The decode step's RMSNorm (``decode_rms_norm``, csrc/fused_decode.cu)
    against ``rms_plain`` at RMS_SHAPES on rows of scale 1 and 100, within
    TOL_DECODE, two launches bit-identical; times at the b2 decode shape
    back-to-back (the kernels line) and queued, beside the plain version,
    ``torch.nn.functional.rms_norm`` and the bound (x and w read once, the
    output written once; 4 operations an element)."""
    import torch
    import torch.nn.functional as F
    from desta25_audio_tpu_torch.ops.fused_decode import (decode_rms_norm,
                                                          rms_plain)
    worst, row = 0.0, None
    for label, R, D in RMS_SHAPES:
        scales = torch.logspace(0, 2, R, device="cuda")[:, None]
        x = (torch.randn(R, D, generator=gen, device="cuda")
             * scales).bfloat16()
        w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
             ).bfloat16()
        got = decode_rms_norm(x, w, 1e-5)
        err, rel = rel_err(got, rms_plain(x, w, 1e-5, torch.bfloat16))
        bits = torch.equal(decode_rms_norm(x, w, 1e-5), got)
        worst = max(worst, err)
        print(f"rms_norm [{label}] R={R} D={D}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol {TOL_DECODE}); two launches "
              f"bit-identical: {bits}", flush=True)
        if rel > TOL_DECODE or not bits:
            raise AssertionError(f"rms_norm [{label}]: rel {rel}, bits {bits}")
        if label != "b2 decode":
            continue
        kern = lambda: decode_rms_norm(x, w, 1e-5)  # noqa: E731
        plain = lambda: rms_plain(x, w, 1e-5, torch.bfloat16)  # noqa: E731
        lib = lambda: F.rms_norm(x, (D,), w, 1e-5)  # noqa: E731
        ms, plain_ms, lib_ms = (cuda_time_ms(f, iters=50)
                                for f in (kern, plain, lib))
        q_ms, q_plain, q_lib = (cuda_time_ms(f, iters=50, queued=True)
                                for f in (kern, plain, lib))
        b_ms, b_by = bound(2 * R * D * 2 + D * 2, 4 * R * D, "f32")
        print(f"rms_norm [{label}] times ({gpu_line()}): kernel {ms:.5f} "
              f"ms, plain {plain_ms:.5f} ms, F.rms_norm {lib_ms:.5f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}); queued: kernel {q_ms:.5f} ms, "
              f"plain {q_plain:.5f} ms, F.rms_norm {q_lib:.5f} ms",
              flush=True)
        row = [0.0, ms, plain_ms, b_ms, b_by, lib_ms]
    row[0] = worst
    return tuple(row)


def check_decode_graph(model, msgs, tag: str, gpu: str,
                       orca: bool = False, graphs: int = 1,
                       hook: bool = False) -> None:
    """generate() of ``msgs`` (greedy, 32 new tokens) eagerly
    (``llm_generate(decode_graph=False)``) and through the decode step's
    CUDA graph (the default): the ids identical, every sampled step's
    logits bit-identical, one ``decode_graph`` replay for each decode step
    after the first and the other launch counts equal; prints both ms a
    step (host clock, the capture inside the graph's), the capture time, and
    the device time of a step: the graph's replays and the eager step's
    launches, both queued behind a sleep kernel on a fresh cache (``orca``:
    with the call's in-kernel injection spec; ``hook``: K9's step with the
    call's PyTorch injection between layers, the float stack's opt-in).
    ``graphs``: the graphs a step replays (under a mesh, one a card)."""
    import torch
    from desta25_audio_tpu_torch.generate import decode as tdecode
    from desta25_audio_tpu_torch.generate.graph import DecodeGraph
    from desta25_audio_tpu_torch.models import desta as tdesta
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops import _build
    real_gen, real_sample = tdesta.llm_generate, tdecode.sample_token
    runs = {}
    for graph in (False, True):
        seen = []
        tdecode.sample_token = (
            lambda lg, *a: seen.append(lg.clone()) or real_sample(lg, *a))
        tdesta.llm_generate = functools.partial(real_gen, decode_graph=graph)
        try:
            _build.reset_launch_counts()
            out = model.generate(msgs, do_sample=False, max_new_tokens=32)
            torch.cuda.synchronize()
        finally:
            tdecode.sample_token, tdesta.llm_generate = real_sample, real_gen
        runs[graph] = (out.generated_ids, seen, _build.launch_counts(),
                       _build.kernel_counts(), dict(model.last_timings))
    (e_ids, e_lg, e_n, e_k, e_t), (g_ids, g_lg, g_n, g_k, g_t) = (
        runs[False], runs[True])
    steps = int(g_t["decode_steps"])
    replays = g_n.pop("decode_graph", 0)
    same = len(g_lg) == len(e_lg) and all(
        torch.equal(a, b) for a, b in zip(g_lg, e_lg))
    # the step's device time on a fresh cache of the b2 calls' length (256),
    # every row writing at 150, with the call's injection spec if any
    llm, cfg = model.params["llm"], model.llm_cfg
    B, S, ci = len(g_ids), 256, 150
    cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    cur = torch.zeros(B, dtype=torch.long, device="cuda")
    spec = extra = None
    if orca or hook:
        extra, spec = orca_injection(
            model, model._run_generation_phases(msgs, {})[2])
        if hook:
            spec = None
        else:
            extra = None
    dev_ms = {}
    for capture, iters in ((False, 3), (True, 10)):
        dg = DecodeGraph(llm, cfg, mask, cache, spec, capture=capture,
                         extra_layer_fn=extra)
        for _ in range(2):   # the eager first step, then the capture
            dg.step(cur, cur + ci, ci)
        dev_ms[capture] = cuda_time_ms(lambda: dg.step(cur, cur + ci, ci),
                                       iters=iters, queued=True)
        dg.close()
    del cache
    print(f"{tag} decode graph b{B}: ids identical {g_ids == e_ids}, "
          f"{len(g_lg)} sampled steps' logits bit-identical {same}, "
          f"decode_graph replays {replays} for {steps} decode steps; decode "
          f"{g_t['decode_ms'] / max(steps, 1):.3f} ms/step through the graph "
          f"(capture {g_t.get('graph_capture_ms', 0.0):.1f} ms inside), "
          f"{e_t['decode_ms'] / max(steps, 1):.3f} ms/step eager; device "
          f"time a "
          f"step (queued, S={S}): graph {dev_ms[True]:.4f} ms, eager "
          f"{dev_ms[False]:.4f} ms ({gpu})", flush=True)
    if g_ids != e_ids or not same:
        raise AssertionError(f"{tag}: the graph's ids or logits differ from "
                             "the eager step's")
    if replays != graphs * max(steps - 1, 0) or g_n != e_n or g_k != e_k:
        raise AssertionError(f"{tag}: graph counts {g_n} {g_k} (replays "
                             f"{replays}) vs eager {e_n} {e_k}")


def require_graph_replays(tag: str, counts, timings, graphs: int = 1
                          ) -> None:
    """generate()'s decode ran through the graph: ``graphs`` replays (one a
    card) for each decode step after the first."""
    steps = int(timings["decode_steps"])
    if counts.get("decode_graph", 0) != graphs * max(steps - 1, 0):
        raise AssertionError(f"{tag}: {counts.get('decode_graph', 0)} "
                             f"decode_graph replays for {steps} steps")


# the skinny GEMM's check shapes: Llama-3.1-8B's four layer GEMMs and the
# head (output columns, K, epilogue), as bench_skinny_gemm.py times them
SKINNY_SHAPES = (("qkv", 6144, 4096, 0), ("wo", 4096, 4096, 1),
                 ("gate/up", 14336, 4096, 2), ("down", 4096, 14336, 1),
                 ("head", 130560, 4096, 0))


def check_skinny_gemm(gen):
    """Phase 13b: the skinny weight-streaming GEMM (csrc/skinny_gemm.cuh:
    tensor cores, a TMA / bulk-copy ring, K split across a cluster) through
    ops/skinny_gemm.skinny_gemm against skinny_gemm_plain, at Llama-3.1-8B's
    shapes with their epilogues (qkv STORE, wo and down RESID, gate/up
    SWIGLU, the head STORE), int8 and bf16 weights, R = 1, 2, 8 and 16 rows;
    every other epilogue (STORE_F32, ADD_F32, BIAS, BIAS_GELU) at the wo
    shape, and PEER_F32 at p = 2 virtual ranks.  bf16 outputs within
    TOL_DECODE, f32 outputs within TOL_QMM; two launches bit-identical; the
    C side's plan equal to plan_skinny_gemm.  The kernels line's entry: the
    worst error, bf16 down at R = 2 (back-to-back events; queued printed
    beside), its plain version and F.linear, the bound."""
    import torch
    import torch.nn.functional as F
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops import skinny_gemm as sg
    from desta25_audio_tpu_torch.ops.quant import quantize_weight
    from desta25_audio_tpu_torch.ops.tp_allreduce import MeshBuffers
    n_sm = _build.sm_count(torch.device("cuda"))
    worst, row = 0.0, None

    def weight(N, K, int8):
        wf = torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5
        if not int8:
            return wf.bfloat16(), None
        leaf = quantize_weight(wf)
        return leaf["q"], leaf["s"]

    def check(tag, x, w, s, epi, out=None, bias=None):
        nonlocal worst
        want = sg.skinny_gemm_plain(x, w, s, epi, out, bias)
        got = sg.skinny_gemm(x, w, s, epi,
                             None if out is None else out.clone(), bias)
        tol = TOL_QMM if epi in sg.F32_OUT else TOL_DECODE
        err, rel = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"skinny GEMM {tag}: rel {rel} > {tol}")
        worst = max(worst, err)
        return err, rel

    for int8 in (True, False):
        kind = "int8" if int8 else "bf16"
        for label, N, K, epi in SKINNY_SHAPES:
            nw = 2 if epi == sg.EPI_SWIGLU else 1
            w, s = weight(N * nw, K, int8)
            plan = sg.kernel_plan(N * nw, K, int8)
            if plan != sg.plan_skinny_gemm(N * nw, K, int8, n_sm):
                raise AssertionError(f"skinny GEMM plan {plan} vs Python's")
            rels = []
            for R in (1, 2, 8, 16):
                x = torch.randn(R, K, generator=gen,
                                device="cuda").bfloat16()
                out = (torch.randn(R, N, generator=gen,
                                   device="cuda").bfloat16()
                       if epi == sg.EPI_RESID else None)
                rels.append(check(f"{label} {kind} R={R}", x, w, s, epi,
                                  out)[1])
                if R == 16:
                    a = sg.skinny_gemm(x, w, s, sg.EPI_STORE_F32
                                       if nw == 1 else epi)
                    b = sg.skinny_gemm(x, w, s, sg.EPI_STORE_F32
                                       if nw == 1 else epi)
                    if not torch.equal(a, b):
                        raise AssertionError(f"skinny GEMM {label} {kind}: "
                                             "two launches differ")
            x2 = torch.randn(2, K, generator=gen, device="cuda").bfloat16()
            x8 = torch.randn(8, K, generator=gen, device="cuda").bfloat16()
            q2 = cuda_time_ms(lambda: sg.skinny_gemm(x2, w, s, sg.EPI_STORE
                                                     if nw == 1 else epi),
                              iters=20, queued=True)
            q8 = cuda_time_ms(lambda: sg.skinny_gemm(x8, w, s, sg.EPI_STORE
                                                     if nw == 1 else epi),
                              iters=20, queued=True)
            wbytes = w.numel() * w.element_size()
            print(f"skinny GEMM {label} {kind} {N}x{K} (plan {tuple(plan)}): "
                  f"rel at R=1/2/8/16 "
                  f"{'/'.join(f'{r:.2e}' for r in rels)}; queued "
                  f"{q2:.4f} ms at R=2 ({wbytes / q2 / 1e9:.3f} TB/s), "
                  f"{q8:.4f} ms at R=8, bound "
                  f"{wbytes / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
            if label == "down" and not int8:
                ms = cuda_time_ms(lambda: sg.skinny_gemm(x2, w))
                plain_ms = cuda_time_ms(lambda: sg.skinny_gemm_plain(x2, w),
                                        iters=3)
                lib_ms = cuda_time_ms(lambda: F.linear(x2, w))
                nbytes = wbytes + x2.numel() * 2 + 2 * N * 2
                row = (ms, plain_ms) + bound(nbytes, 2 * 2 * N * K, "bf16") \
                    + (lib_ms,)
                print(f"skinny GEMM down bf16 R=2 (the kernels line): "
                      f"{ms:.4f} ms back-to-back, {q2:.4f} ms queued, plain "
                      f"{plain_ms:.4f} ms, F.linear {lib_ms:.4f} ms, bound "
                      f"{row[2]:.4f} ms", flush=True)
            del w, s
        # every other epilogue at the wo shape, R = 3 and 17 (two passes)
        w, s = weight(4096, 4096, int8)
        bias = torch.randn(4096, generator=gen, device="cuda")
        for R in (3, 17):
            x = torch.randn(R, 4096, generator=gen, device="cuda").bfloat16()
            acc = torch.randn(R, 4096, generator=gen, device="cuda")
            for epi, out, b in ((sg.EPI_STORE_F32, None, None),
                                (sg.EPI_ADD_F32, acc, None),
                                (sg.EPI_BIAS, None, bias),
                                (sg.EPI_BIAS_GELU, None, bias)):
                check(f"wo {kind} epilogue {epi} R={R}", x, w, s, epi, out, b)
        # PEER_F32: two virtual ranks store into both receive buffers
        bufs = MeshBuffers([torch.device("cuda", 0)] * 2, 2, 4096)
        stream = torch.cuda.current_stream().cuda_stream
        epoch = bufs.begin(1) + 1
        xs = [torch.randn(2, 4096, generator=gen, device="cuda").bfloat16()
              for _ in range(2)]
        for rank in range(2):
            bufs.store(rank, 0, 1, xs[rank], w, s, "peer", stream)
        torch.cuda.synchronize()
        for rank in range(2):
            want = sg.skinny_gemm_plain(xs[rank], w, s, sg.EPI_STORE_F32)
            for d in range(2):
                rel = rel_err(bufs.rbuf[d][0, rank], want)[1]
                if rel > TOL_QMM:
                    raise AssertionError(f"PEER_F32 rank {rank} buffer {d}: "
                                         f"{rel}")
        if (bufs.flags[0][0].tolist() != [epoch, epoch]
                or bufs.counter[0].tolist() != [0, 0]):
            raise AssertionError("PEER_F32: flags or arrival counter wrong")
        del w, s, bufs
        torch.cuda.empty_cache()
    print(f"skinny GEMM: every shape and epilogue within TOL_DECODE / TOL_QMM,"
          f" worst max_abs_err {worst:.3e}", flush=True)
    return (worst,) + row


DEBUG_CONFIG = "configs/desta25_debug.yaml"


def check_long_cache(gen):
    """Phase 25b: a decode step that no kernel takes at flagship geometry:
    Llama-3.1-8B's heads (H=32, Hkv=8, Dh=128) at a nano width (2 layers,
    D=512) and B=9, so B*Hkv = 72 clusters get one key range each on this
    card, and a cache of 12416 positions, past what one range's scores fit
    in shared memory.  The predicate must refuse it, llm_apply must take its
    layer loop (counted, no decode kernel launched), and the logits must
    agree with the plain decode step (fused_decode_layers_plain, final norm,
    head) within TOL_DECODE."""
    import torch
    from desta25_audio_tpu_torch.config import llm_config_for
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.core import rms_norm
    from desta25_audio_tpu_torch.ops.fused_decode import (
        KVCache, fused_decode_layers_plain, kernel_limits)
    cfg = dataclasses.replace(
        llm_config_for("meta-llama/Llama-3.1-8B-Instruct"),
        num_hidden_layers=2, hidden_size=512, intermediate_size=1024)
    B, S = 9, 12416
    why = kernel_limits(cfg, B, 1, S, False,
                        _build.sm_count(torch.device("cuda")))
    if not why:
        raise AssertionError("the long-cache step fits this card's kernels")
    params = tllm.init_llm(cfg, torch.bfloat16, "cuda", gen)
    cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    ci = torch.tensor([S - 1 - 1000 * i for i in range(B)], device="cuda")
    mask = torch.ones(B, S, dtype=torch.int32, device="cuda")
    mask[0, :40] = 0
    positions = ci[:, None].clone()
    ids = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device="cuda")
    plain_cache = KVCache(cache.k.clone(), cache.v.clone())
    _build.reset_launch_counts()
    logits, cache = tllm.llm_apply(params, cfg, input_ids=ids,
                                   attention_mask=mask, positions=positions,
                                   cache=cache, cache_index=ci)
    torch.cuda.synchronize()
    taken, counts = _build.fallback_counts(), _build.launch_counts()
    h, _ = fused_decode_layers_plain(params, cfg,
                                     tllm.embed_tokens(params, ids), mask,
                                     positions, plain_cache, ci)
    want = tllm.head_logits(params, rms_norm(params["norm"], h,
                                             cfg.rms_norm_eps))
    err, rel = rel_err(logits, want)
    krel = rel_err(cache.k, plain_cache.k)[1]
    print(f"long cache B={B} S={S} (Llama-3.1-8B heads, D=512, 2 layers): "
          f"kernel limits refuse it ({why[0]}); torch paths taken "
          f"{json.dumps(taken)}, launches {json.dumps(counts)}; logits vs "
          f"the plain decode step max_abs_err={err:.3e} rel={rel:.3e}, "
          f"written cache rel={krel:.3e} (tol {TOL_DECODE})", flush=True)
    if taken.get("fused_decode_layers") != 1 or counts.get(
            "fused_decode_layers"):
        raise AssertionError("the long-cache step did not take the layer "
                             "loop")
    if max(rel, krel) > TOL_DECODE:
        raise AssertionError(f"long-cache layer loop disagrees: {rel} {krel}")


def _to_device(tree, device):
    """A param tree's tensors copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def check_int8_fallbacks(gpu: str, wavs) -> None:
    """Phase 25c (the int8 LLM's products on shapes its kernels refuse):
    the debug config's towers with the LLM quantized
    (``apply_llm_quant``), greedy ``generate()`` at b2 with prompts of
    B * T >= 128 rows, in bf16 (llama-nano's wo and down have N = 64, which
    the W8A8 GEMM refuses) and in the config's own float32 (the W8A8 GEMM
    takes bf16 x only; K7 takes f32 x cast to bf16, the Pallas kernel's
    rounding).  Each run's ids must equal the same model's on the CPU (the
    params copied there: every product on its plain version), the refused
    products must show in ``fallback_counts()`` (``w8a8_matmul``), and K7
    must launch for each decode step's 4 products a layer and its head at
    M = B (``quant_matmul``; the f32 head cast to bf16)."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.ops import _build
    cfg0 = config_from_yaml_file(DEBUG_CONFIG)
    msgs = [[{"role": "user", "content": "Describe the sound in detail. "
              "<|AUDIO|>", "audios": [{"audio": w, "text": "a tone"}]}]
            for w in wavs]
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg0, dtype=dtype)
        model = DeSTA25AudioModel(cfg, device="cuda", seed=0)
        model.apply_llm_quant()
        rows = model._run_generation_phases(msgs, {})[0].shape[:2]
        _build.reset_launch_counts()
        out = model.generate(msgs, do_sample=False, max_new_tokens=8)
        torch.cuda.synchronize()
        counts, taken = _build.launch_counts(), _build.fallback_counts()
        steps = model.last_timings["decode_steps"]
        ids = np.asarray(out.generated_ids)
        cpu = DeSTA25AudioModel(cfg, device="cpu",
                                params=_to_device(model.params, "cpu"),
                                tokenizer=model.tokenizer)
        want = np.asarray(cpu.generate(msgs, do_sample=False,
                                       max_new_tokens=8).generated_ids)
        k7 = (4 * model.llm_cfg.num_hidden_layers + 1) * steps
        print(f"int8 debug-config LLM in {dtype}, b2, prompt rows "
              f"{rows[0]} x {rows[1]} ({gpu}): ids {ids.tolist()}, the CPU "
              f"run's {want.tolist()}; torch paths taken {json.dumps(taken)}"
              f"; quant_matmul launches {counts.get('quant_matmul', 0)} "
              f"(expected {k7}: {steps} decode steps), w8a8_matmul "
              f"{counts.get('w8a8_matmul', 0)}", flush=True)
        if rows[0] * rows[1] < 128:
            raise AssertionError(f"int8 {dtype}: {rows} prompt rows, under "
                                 "the W8A8 crossover")
        if not np.array_equal(ids, want):
            raise AssertionError(f"int8 {dtype}: ids differ from the CPU "
                                 f"run's: {ids.tolist()} {want.tolist()}")
        if taken.get("w8a8_matmul", 0) <= 0:
            raise AssertionError(f"int8 {dtype}: no W8A8 product took its "
                                 "plain version")
        if counts.get("quant_matmul", 0) != k7:
            raise AssertionError(f"int8 {dtype}: K7 launched "
                                 f"{counts.get('quant_matmul', 0)} times, "
                                 f"expected {k7}")
        del model, cpu
        gc.collect()
        torch.cuda.empty_cache()


def run_debug_config(gpu: str, tmpdir: str):
    """Phase 25: the shipped configs/desta25_debug.yaml (whisper-nano Dh 32,
    llama-nano Dh 16, a 2-layer Q-Former, float32) on the card, random
    weights from a seed: greedy generate() at b2 and one train step.  No
    decode, encoder or Q-Former kernel takes its shapes, so the models take
    their torch paths: the counted fallbacks must show the encoder's
    attention and FFN and the decode step, and no kernel of those may
    launch (K1, which takes any shape, does).  Then 25b and 25c."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    cfg = config_from_yaml_file(DEBUG_CONFIG)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=0)
    wavs, _ = write_wavs(tmpdir)
    msgs = [[{"role": "user", "content": "What do you hear? <|AUDIO|>",
              "audios": [{"audio": w, "text": "a tone"}]}] for w in wavs]
    model.generate(msgs, do_sample=False, max_new_tokens=2)   # warm-up
    _build.reset_launch_counts()
    out = model.generate(msgs, do_sample=False, max_new_tokens=8)
    torch.cuda.synchronize()
    counts, taken = _build.launch_counts(), _build.fallback_counts()
    ids = np.asarray(out.generated_ids)
    print(f"debug config generate() b2 ({cfg.dtype}, {gpu}): ids "
          f"{ids.tolist()}; kernels launched {json.dumps(counts)}; torch "
          f"paths taken {json.dumps(taken)}", flush=True)
    if ids.shape != (2, 8) or not ((ids >= 0)
                                   & (ids < model.llm_cfg.vocab_size)).all():
        raise AssertionError(f"debug config generate(): ids {ids}")
    for name in ("packed_encoder_attention", "encoder_ffn",
                 "fused_decode_layers"):
        if taken.get(name, 0) <= 0 or counts.get(name, 0):
            raise AssertionError(f"debug config: {name} did not take its "
                                 "torch path")
    if counts.get("log_mel", 0) <= 0:
        raise AssertionError("debug config: log_mel was not launched")

    manifest = write_corpus(os.path.join(tmpdir, "debug"), n=4)
    dcfg = DataConfig(manifest_filepaths=[manifest],
                      data_root=os.path.join(tmpdir, "debug"), batch_size=4,
                      max_seq_length=96)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(exp_dir=os.path.join(tmpdir, "debug", "exp"),
                         max_steps=1, log_every_n_steps=1,
                         eval_before_train=False, val_check_interval=1e9,
                         eval_max_batches=1, eval_max_new_tokens=4,
                         keep_checkpoints=1)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    trainer = DeSTA25Trainer(model, ds, ds, CollateFn(cfg, dcfg,
                                                      model.tokenizer),
                             ocfg, tcfg)
    trainable, _ = model.split_params()
    probe = StepProbe(trainer, {k: v.detach().clone() for k, v in
                                flatten_tree(trainable).items()})
    _build.reset_launch_counts()
    trainer.train()
    torch.cuda.synchronize()
    print_steps("debug-config train", probe.rows, gpu)
    print(f"debug config train step: torch paths taken "
          f"{json.dumps(_build.fallback_counts())}", flush=True)
    if len(probe.rows) != 1 or not (
            np.isfinite(probe.rows[0]["metrics"]["loss"])
            and np.isfinite(probe.rows[0]["metrics"]["grad_norm"])):
        raise AssertionError(f"debug config train step: {probe.rows}")
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        check_long_cache(torch.Generator("cuda").manual_seed(9))
    check_int8_fallbacks(gpu, wavs)


def write_wavs(d: str):
    from desta25_audio_tpu_torch.audio.io import write_wav
    rng = np.random.default_rng(0)
    paths, signals = [], []
    for i, (secs, f0) in enumerate(((3.0, 440.0), (5.5, 300.0))):
        t = np.arange(int(secs * 16000)) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * f0 * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        sig += 0.01 * rng.standard_normal(t.size).astype(np.float32)
        paths.append(os.path.join(d, f"clip{i}.wav"))
        write_wav(paths[-1], sig)
        signals.append(sig)
    return paths, signals


def conversations(wavs):
    """Four conversations, one clip each: b2 = the first two, b1 = the
    second, b4 = all four (an encoder batch of 4, above the int8
    attention arm's limit of 2).  With the CharTokenizer their prompts are
    148, 141, 121 and 135 tokens long: the int8 LLM's b1 run takes the
    third, whose prefill (M = 121 rows) goes through K7, while b2's
    (M = 2 * 148) goes through the W8A8 GEMM."""
    wav_a, wav_b = wavs
    conv_a = [{"role": "system", "content": "Focus on the audio."},
              {"role": "user", "content": "What do you hear? <|AUDIO|>",
               "audios": [{"audio": wav_a, "text": "a test tone"}]}]
    conv_b = [{"role": "user",
               "content": "Describe this clip: <|AUDIO|> in one line.",
               "audios": [{"audio": wav_b, "text": "a longer lower tone"}]}]
    conv_c = [{"role": "user", "content": "Is <|AUDIO|> speech or music?",
               "audios": [{"audio": wav_b, "text": "a lower tone"}]}]
    conv_d = [{"role": "system", "content": "Answer briefly."},
              {"role": "user", "content": "<|AUDIO|> How loud is it?",
               "audios": [{"audio": wav_a, "text": "tone"}]}]
    return [conv_a, conv_b, conv_c, conv_d]


def check_outputs(model, outs) -> None:
    V = model.llm_cfg.vocab_size
    for out, b in outs:
        ids = np.asarray(out.generated_ids)
        if ids.shape != (b, 32) or ids.min() < 0 or ids.max() >= V:
            raise AssertionError(f"bad generated_ids shape/range {ids.shape}")
        if len(out.text) != b:
            raise AssertionError("one text per conversation expected")


def orca_injection(model, aux):
    """generate()'s ORCA injection for perception's aux: (extra_layer_fn,
    the in-kernel spec, or None where the model does not inject or the
    dispatch keeps the injection in PyTorch)."""
    from desta25_audio_tpu_torch.generate.decode import build_injection
    from desta25_audio_tpu_torch.ops.fused_decode import (
        fused_inject_supported)
    tokens = model._orca_inject_tokens(aux)
    if tokens is None:
        return None, None
    xa = model.params["orca_cross_attns"]
    heads = model.llm_cfg.num_attention_heads
    extra, spec = build_injection(model.llm_cfg, xa, tokens,
                                  model.config.orca_audio_position_scale,
                                  heads)
    if not fused_inject_supported(model.params["llm"], model.llm_cfg, xa,
                                  heads, spec["ta_real"]):
        spec = None
    return extra, spec


def check_step_by_step(model, convs, out) -> None:
    """The batch's path once more, step by step (the cache length of
    llm_generate): the spliced embeddings, the prefill logits and one fused
    decode step's logits must be finite and give generate()'s first two
    greedy tokens (rows that stopped at the first token are skipped).  An
    ORCA model injects as generate() does: the prefill through the PyTorch
    hook, the decode step inside the kernel (int8 stack) or through the
    hook."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    with torch.no_grad():
        embeds, mask, aux, _, _ = model._run_generation_phases(convs, {})
        extra, spec = orca_injection(model, aux)
        B, T, _ = embeds.shape
        S = -(-(T + 32) // 128) * 128
        cache = tllm.init_kv_cache(model.llm_cfg, B, S, embeds.dtype,
                                   embeds.device)
        full = torch.zeros(B, S, dtype=torch.int32, device=embeds.device)
        full[:, :T + 1] = 1
        full[:, :T] = mask
        pos = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
        logits, cache = tllm.llm_apply(
            model.params["llm"], model.llm_cfg, inputs_embeds=embeds,
            attention_mask=full, positions=pos, cache=cache, cache_index=0,
            extra_layer_fn=extra)
        step, _ = tllm.llm_apply(
            model.params["llm"], model.llm_cfg,
            input_ids=logits[:, -1].argmax(-1)[:, None],
            attention_mask=full, positions=pos[:, -1:] + 1, cache=cache,
            cache_index=T, extra_layer_fn=extra, fused_injection=spec)
    V = model.llm_cfg.vocab_size
    if (embeds.shape[-1] != model.llm_cfg.hidden_size
            or logits.shape != (B, T, V) or step.shape != (B, 1, V)
            or not all(bool(t.float().isfinite().all())
                       for t in (embeds, logits, step))):
        raise AssertionError("non-finite or misshaped embeddings/logits")
    ids = np.asarray(out.generated_ids)
    first = logits[:, -1].argmax(-1).cpu().numpy()
    second = step[:, 0].argmax(-1).cpu().numpy()
    live = ~np.isin(ids[:, 0], model._terminators())
    if (first != ids[:, 0]).any() or (second != ids[:, 1])[live].any():
        raise AssertionError(f"step-by-step tokens {first} {second} differ "
                             f"from generate()'s {ids[:, :2].tolist()}")


def print_times(label, runs, gpu) -> None:
    for b, t in runs:
        steps = max(int(t["decode_steps"]), 1)
        kv = t.get("inject_kv_ms")
        perc = (f"{t['perception_ms']:.1f} ms" if kv is None else
                f"{t['perception_ms'] + kv:.1f} ms (incl. the audio K/V "
                f"precompute {kv:.1f} ms)")
        print(f"{label} batch {b}: host {t['host_ms']:.1f} ms, perception "
              f"{perc}, prefill {t['prefill_ms']:.1f} "
              f"ms, decode {t['decode_ms'] / steps:.2f} ms/step over "
              f"{t['decode_steps']} steps ({gpu})", flush=True)


@contextlib.contextmanager
def plain_kernels():
    """Route models/whisper.py's kernel calls to their plain versions."""
    from desta25_audio_tpu_torch.models import whisper as tw
    from desta25_audio_tpu_torch.ops.enc_attention import (
        packed_encoder_attention_plain)
    from desta25_audio_tpu_torch.ops.enc_ffn import (encoder_ffn_plain,
                                                     encoder_ffn_w8a8_plain)
    from desta25_audio_tpu_torch.ops.w8a8_proj import (proj_w8a8_plain,
                                                       qkv_w8a8_plain)
    swap = {"packed_encoder_attention": packed_encoder_attention_plain,
            "encoder_ffn": encoder_ffn_plain,
            "encoder_ffn_w8a8": encoder_ffn_w8a8_plain,
            "qkv_w8a8": qkv_w8a8_plain, "proj_w8a8": proj_w8a8_plain}
    saved = {k: getattr(tw, k) for k in swap}
    for k, v in swap.items():
        setattr(tw, k, v)
    yield  # an exception ends the script: nothing to restore then
    for k, v in saved.items():
        setattr(tw, k, v)


def encoder_ms(model, mel, maxb=None) -> float:
    """Device time of the encoder forward (taps) on mel; maxb, if given,
    stands in for models/whisper.py's INT8_ATTN_MAXB during the call (which
    attention arm "dual" leaves take)."""
    from desta25_audio_tpu_torch.models import whisper as tw
    old = tw.INT8_ATTN_MAXB
    if maxb is not None:
        tw.INT8_ATTN_MAXB = maxb
    ms = cuda_time_ms(lambda: tw.whisper_encoder_apply(
        model.params["whisper"]["encoder"], mel, model.enc_cfg,
        model.config.target_layer_ids), iters=3)
    tw.INT8_ATTN_MAXB = old
    return ms


def check_int8_layers(model, mel) -> None:
    """Encoder layers 0 and 31 of the int8 tree through the kernels against
    the plain versions, both fed the same bf16 input (the kernels'
    trajectory up to that layer), within TOL_ENC."""
    from desta25_audio_tpu_torch.models import whisper as tw
    from desta25_audio_tpu_torch.ops.core import index_tree
    cfg = model.enc_cfg
    H, L = cfg.encoder_attention_heads, cfg.encoder_layers
    enc = model.params["whisper"]["encoder"]
    x = tw.encoder_stem(enc, mel, cfg)
    for layer in range(L):
        p = index_tree(enc["layers"], layer)
        got = tw._enc_layer_apply(p, x, H)
        if layer in (0, L - 1):
            with plain_kernels():
                want = tw._enc_layer_apply(p, x, H)
            err, rel = rel_err(got, want)
            print(f"int8 encoder layer {layer} B={mel.shape[0]} (int8 "
                  f"attention arm: {tw.int8_attention(p['attn'], mel.shape[0])}"
                  f"): kernels vs plain max_abs_err={err:.3e} rel={rel:.3e} "
                  f"(tol {TOL_ENC})", flush=True)
            if rel > TOL_ENC:
                raise AssertionError(f"int8 layer {layer} disagrees: {rel}")
        x = got


def check_int8_encoder(model, signals, convs, gpu):
    """Phases 10-12: the JAX package's inference encoder on the same model.

    10. the bf16 encoder's taps and forward times at B=1, 2, 4; then
        apply_inference_encoder_quant() ("dual": int8 FFN, attention
        leaves with int8 q/s beside the bf16 w); layers 0 and 31 against
        the plain versions; the int8-vs-bf16 taps difference (information:
        random deep stacks amplify rounding); the encoder forward at
        B=1, 2, 4 with each attention arm forced (the crossover);
    11. generate() at b2 and b1 (int8 attention arm: K5, K2, K6, K4 launch,
        K3 does not) and b4 (bf16 arm: K2 and K4 launch, K5/K6 do not),
        after a warm-up call; the b2 path step by step;
    12. phase times per batch.
    Returns (the launch counts summed over the three generate() runs, each
    run's timings by batch)."""
    import torch
    from desta25_audio_tpu_torch.models import whisper as tw
    from desta25_audio_tpu_torch.ops import _build
    cfg = model.enc_cfg
    batch = np.zeros((2, cfg.expected_mel_frames * 160), np.float32)
    for j, sig in enumerate(signals):
        n = min(sig.size, batch.shape[1])
        batch[j, :n] = sig[:n]
    mel2 = model._mel(batch)
    mels = {1: mel2[1:], 2: mel2, 4: torch.cat([mel2, mel2])}
    taps_ids = model.config.target_layer_ids
    enc = model.params["whisper"]["encoder"]
    _, taps_bf16 = tw.whisper_encoder_apply(enc, mel2, cfg, taps_ids)
    bf16_ms = {b: encoder_ms(model, m) for b, m in mels.items()}

    model.apply_inference_encoder_quant()
    enc = model.params["whisper"]["encoder"]
    if (set(enc["layers"]["fc1"]) != {"q", "s", "b"}
            or set(enc["layers"]["attn"]["q"]) != {"w", "q", "s", "b"}):
        raise AssertionError("apply_inference_encoder_quant: not the dual tree")
    check_int8_layers(model, mel2)
    _, taps_int8 = tw.whisper_encoder_apply(enc, mel2, cfg, taps_ids)
    for i, layer in enumerate(taps_ids):
        err, rel = rel_err(taps_int8[i], taps_bf16[i])
        print(f"int8 vs bf16 encoder tap {layer} (B=2, information): "
              f"max_abs_err={err:.3e} rel={rel:.3e}", flush=True)
    for b, m in mels.items():
        print(f"encoder forward B={b} ({gpu}): bf16 {bf16_ms[b]:.3f} ms; "
              f"int8 FFN + bf16 attention {encoder_ms(model, m, 0):.3f} ms;"
              f" int8 FFN + int8 attention {encoder_ms(model, m, 1 << 20):.3f}"
              f" ms", flush=True)

    runs = {2: convs[:2], 1: convs[1], 4: convs}
    model.generate(runs[2], do_sample=False, max_new_tokens=2)  # warm-up
    outs, times, total = {}, {}, {}
    for b, msgs in runs.items():
        _build.reset_launch_counts()
        outs[b] = model.generate(msgs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        times[b] = dict(model.last_timings)
        require_graph_replays(f"int8 encoder b{b}", counts, times[b])
        print(f"int8 encoder: launches during generate() b{b}: "
              f"{json.dumps(counts)}", flush=True)
        require_kernel_paths(f"int8 encoder b{b}")
        arm = ("qkv_w8a8", "proj_w8a8")
        must = ("log_mel", "packed_encoder_attention", "encoder_ffn_w8a8",
                "fused_decode_layers") + (arm if b <= 2 else ())
        never = ("encoder_ffn",) + (() if b <= 2 else arm)
        for name in must:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"b{b}: {name} was not launched")
        for name in never:
            if counts.get(name, 0):
                raise AssertionError(f"b{b}: {name} was launched")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    check_outputs(model, [(outs[b], b) for b in runs])
    check_step_by_step(model, runs[2], outs[2])
    add_margins(model, runs[2], outs[2])
    add_margins(model, runs[4], outs[4])
    print(f"int8 encoder generated ids b2 row0[:8]={shown(outs[2], 0)} b4 "
          f"row3[:8]={shown(outs[4], 3)}", flush=True)
    print_times("int8 encoder", sorted(times.items()), gpu)
    return total, times


# the encoder's kernels: one ASR call adds one more mel and encoder pass
ENC_KERNELS = ("log_mel", "packed_encoder_attention", "encoder_ffn",
               "encoder_ffn_w8a8", "qkv_w8a8", "proj_w8a8")


def texts(out) -> str:
    """generate()'s transcripts, each cut to 40 characters."""
    return repr([a[1][:40] for a in out.audios])


def without_text(msgs):
    """A conversation (or a batch of them) with every clip's transcription
    left to ASR."""
    if isinstance(msgs[0], list):
        return [without_text(m) for m in msgs]
    return [{**m, "audios": [{**a, "text": None} for a in m["audios"]]}
            if "audios" in m else m for m in msgs]


def ttft_ms(t) -> float:
    """generate()'s time to its first token from its timings: host (phases
    A+B without the ASR), ASR, perception (with ORCA's audio K/V
    precompute), prefill."""
    return (t["host_ms"] + t.get("asr_ms", 0.0) + t["perception_ms"]
            + t.get("inject_kv_ms", 0.0) + t["prefill_ms"])


def print_asr_times(label, t, gpu) -> None:
    """One ASR generate()'s phases and the time to its first token."""
    steps = int(t.get("asr_steps", 0))
    kv = t.get("inject_kv_ms", 0.0)
    asr = (f"ASR {t['asr_ms']:.1f} ms ({steps} decoder steps, "
           f"{t['asr_decode_ms'] / max(steps, 1):.3f} ms a step)"
           if steps else "no ASR")
    print(f"{label}: host {t['host_ms']:.1f} ms, {asr}, perception "
          f"{t['perception_ms'] + kv:.1f} ms, prefill {t['prefill_ms']:.1f} "
          f"ms; time to the first token {ttft_ms(t):.1f} ms ({gpu})",
          flush=True)


def asr_generate(model, msgs, tag: str):
    """generate() of msgs, greedy, 32 new tokens: (output, launch counts,
    timings); no flagship shape may take a torch path."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    _build.reset_launch_counts()
    out = model.generate(msgs, do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    require_kernel_paths(tag)
    require_graph_replays(tag, counts, model.last_timings)
    return out, counts, dict(model.last_timings)


def encoder_pass_counts(model, n: int):
    """The launches of one mel and one encoder pass at a batch of n."""
    import torch
    from desta25_audio_tpu_torch.models import whisper as tw
    from desta25_audio_tpu_torch.ops import _build
    _build.reset_launch_counts()
    mel = model._mel(np.zeros((n, model.enc_cfg.expected_mel_frames * 160),
                              np.float32))
    tw.whisper_encoder_apply(model.params["whisper"]["encoder"], mel,
                             model.enc_cfg)
    torch.cuda.synchronize()
    return _build.launch_counts()


def check_asr_launches(tag: str, supplied, asr, one) -> None:
    """The ASR call launched each encoder kernel as often as the same call
    with transcriptions plus one mel and encoder pass (``one``): K1 and
    the encoder-only kernels twice; K2 twice less the Q-Former's share."""
    rows = []
    for name in ENC_KERNELS:
        s_n, a_n, e_n = (supplied.get(name, 0), asr.get(name, 0),
                         one.get(name, 0))
        rows.append(f"{name} {s_n} -> {a_n} (one pass {e_n})")
        if a_n != s_n + e_n or (name != "packed_encoder_attention"
                                and a_n != 2 * s_n):
            raise AssertionError(f"{tag}: {name} launched {a_n} times with "
                                 f"ASR, {s_n} without, {e_n} in one pass")
    if not one.get("log_mel") or not one.get("packed_encoder_attention"):
        raise AssertionError(f"{tag}: the encoder pass ran no kernel: {one}")
    print(f"{tag}: launches without -> with ASR: " + "; ".join(rows),
          flush=True)


def check_asr_generate(model, bf16_enc, convs, silent, gpu):
    """12a.  generate() with ASR at b2 and b1 on the int8 encoder, b2 on
    the bf16 encoder (swapped back in for the call), and a silent clip
    that takes " " without ASR.  Returns the int8 b2 call's timings."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    runs = {"int8 encoder b2": convs[:2], "int8 encoder b1": convs[1]}
    model.generate(without_text(runs["int8 encoder b2"]), do_sample=False,
                   max_new_tokens=2)          # warm-up, ASR included
    times = {}
    int8_enc = model.params["whisper"]["encoder"]
    for tag, msgs in (*runs.items(), ("bf16 encoder b2", convs[:2])):
        if tag.startswith("bf16"):
            model.params["whisper"]["encoder"] = bf16_enc
        n = len(msgs) if isinstance(msgs[0], list) else 1
        try:
            _, supplied, _ = asr_generate(model, msgs, f"{tag}, supplied")
            out, counts, t = asr_generate(model, without_text(msgs),
                                          f"ASR {tag}")
            one = encoder_pass_counts(model, n)
        finally:
            model.params["whisper"]["encoder"] = int8_enc
        check_asr_launches(f"ASR {tag}", supplied, counts, one)
        if t.get("asr_steps", 0) < 1:
            raise AssertionError(f"ASR {tag}: no decoder step ran")
        check_outputs(model, [(out, n)])
        print(f"ASR {tag}: transcripts {texts(out)}, "
              f"generated ids row0[:8]={shown(out, 0)}", flush=True)
        print_asr_times(f"ASR {tag}", t, gpu)
        times[tag] = t
    msg = [{"role": "user", "content": "Anything in <|AUDIO|>?",
            "audios": [{"audio": silent, "text": None}]}]
    out, _, t = asr_generate(model, msg, "ASR silent clip")
    if "asr_steps" in t or out.audios[0][1] != " ":
        raise AssertionError(f"the silent clip: {out.audios}, {t}")
    print(f"ASR silent clip: transcription {out.audios[0][1]!r}, no ASR "
          f"step; the torch paths taken {_build.fallback_counts()}",
          flush=True)
    torch.cuda.synchronize()
    return times["int8 encoder b2"]


def asr_cached_vs_full(dec, cfg, enc_out, late: bool, n_new: int = 32):
    """asr_decode on enc_out with the language given (the prefix known):
    (emitted ids, each position's cached-path logits, the full forward's
    logits over the prefix and the ids, the worst relative difference of
    the two).  ``late``: every cached call writes its keys one slot past
    their position (the control)."""
    import torch
    from desta25_audio_tpu_torch.generate import decode as tdecode
    from desta25_audio_tpu_torch.models import whisper as tw
    real = tw.whisper_decoder_apply

    def late_apply(*a, cache=None, cache_index=0, **k):
        return real(*a, cache=cache,
                    cache_index=cache_index + (cache is not None), **k)
    steps, lang = [], cfg.first_language_token_id
    tw.whisper_decoder_apply = late_apply if late else real
    try:
        ids, _ = tdecode.asr_decode(dec, cfg, enc_out, max_new_tokens=n_new,
                                    language_token=lang, step_logits=steps)
    finally:
        tw.whisper_decoder_apply = real
    B, n = ids.shape[0], len(steps)
    prefix = torch.tensor([[cfg.decoder_start_token_id, lang,
                            cfg.transcribe_token_id,
                            cfg.no_timestamps_token_id]] * B,
                          device=enc_out.device)
    full, _ = real(dec, torch.cat([prefix, ids[:, :n - 1]], 1),
                   tw.whisper_cross_kv(dec, enc_out, cfg), cfg)
    full = full[:, 3:3 + n]
    cached = torch.stack(steps, 1)
    return ids[:, :n], cached, full, rel_err(cached, full)[1]


def check_asr_decoder(model, signals, gpu):
    """12b.  The cached decode against the full forward: a 2-layer f32
    copy of the model's decoder on its encoder's output (f32) within
    TOL_ASR_CACHE, its control above it; then the 32-layer bf16 decoder's
    emitted ids against the teacher-forced argmax (information: where they
    part, the full forward's top-2 margin)."""
    import torch
    from desta25_audio_tpu_torch.models import whisper as tw
    cfg = model.enc_cfg
    batch = np.zeros((2, cfg.expected_mel_frames * 160), np.float32)
    for j, sig in enumerate(signals):
        batch[j, :min(sig.size, batch.shape[1])] = sig[:batch.shape[1]]
    enc_out, _ = tw.whisper_encoder_apply(model.params["whisper"]["encoder"],
                                          model._mel(batch), cfg)
    dec = model.params["whisper"]["decoder"]
    two = _map(lambda t: t.float(),
               {**dec, "layers": _slice(dec["layers"], 0, 2)})
    cfg2 = dataclasses.replace(cfg, decoder_layers=2)
    errs = {late: asr_cached_vs_full(two, cfg2, enc_out.float(), late)[3]
            for late in (False, True)}
    print(f"ASR decoder, 2 layers f32 ({cfg.model_id} widths), cached "
          f"steps vs the full forward: rel {errs[False]:.3e} (tol "
          f"{TOL_ASR_CACHE}); control, the cache written one slot late: rel "
          f"{errs[True]:.3e}", flush=True)
    if not errs[False] < TOL_ASR_CACHE < errs[True]:
        raise AssertionError(f"ASR cached decode {errs[False]} / control "
                             f"{errs[True]} against {TOL_ASR_CACHE}")
    ids, cached, full, rel = asr_cached_vs_full(dec, cfg, enc_out, False)
    top = full.float().topk(2, dim=-1)
    forced = top.indices[..., 0]
    part = (forced != ids).nonzero().tolist()
    margins = [round(float(top.values[b, j, 0] - top.values[b, j, 1]), 4)
               for b, j in part]
    print(f"ASR decoder, {cfg.decoder_layers} layers "
          f"{str(dec['embed_tokens'].dtype)[6:]}: emitted ids equal the "
          f"teacher-forced argmax at {int((forced == ids).sum())} of "
          f"{ids.numel()} positions; where they part (row, step) {part[:8]} "
          f"the full forward's top-2 margins {margins[:8]}; cached vs full "
          f"rel {rel:.3e} (information)", flush=True)
    del enc_out
    torch.cuda.empty_cache()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def run_asr(model, bf16_enc, convs, signals, gpu, tmpdir):
    """12a-12e: Whisper ASR in generate() at full width (module
    docstring)."""
    import torch
    from desta25_audio_tpu_torch.audio.io import write_wav
    from desta25_audio_tpu_torch.ops import _build
    silent = os.path.join(tmpdir, "silent.wav")
    write_wav(silent, np.zeros(32000, np.float32))
    with torch.no_grad():
        t2 = check_asr_generate(model, bf16_enc, convs, silent, gpu)
        check_asr_decoder(model, signals, gpu)

    # -- 12c. the fallback cascade -----------------------------------------
    b2 = without_text(convs[:2])
    model.asr_fallback = dict(temperatures=(0.0, 0.6))
    try:
        outs = []
        for _ in range(2):
            out, _, t = asr_generate(model, b2, "ASR fallback")
            outs.append((out, list(model.last_asr_retried), t))
    finally:
        model.asr_fallback = None
    (o1, r1, t1), (o2, r2, _) = outs
    print(f"ASR fallback (0.0, 0.6) b2: rows retried at 0.6 {r1}; "
          f"transcripts {texts(o1)}; {t1['asr_steps']} "
          f"decoder steps over both tiers; the second call's identical "
          f"{o2.audios == o1.audios and r2 == r1}", flush=True)
    if o2.audios != o1.audios or r2 != r1 \
            or o2.generated_ids != o1.generated_ids:
        raise AssertionError("the fallback cascade's two calls differ")

    # -- 12d. the feature cache ----------------------------------------------
    model.enable_audio_cache()
    try:
        first, _, tf = asr_generate(model, b2, "ASR cache miss")
        second, counts, ts = asr_generate(model, b2, "ASR cache hit")
    finally:
        model.audio_cache = None
    ran = {k: counts[k] for k in ENC_KERNELS if counts.get(k)}
    print(f"feature cache b2: the hit launched {ran or 'no'} perception "
          f"kernel, ASR steps {ts.get('asr_steps', 0)}, ids equal the miss's "
          f"{second.generated_ids == first.generated_ids}; perception "
          f"{tf['perception_ms']:.1f} -> {ts['perception_ms']:.1f} ms, time "
          f"to the first token {ttft_ms(tf):.1f} -> {ttft_ms(ts):.1f} ms "
          f"({gpu})", flush=True)
    if ran or "asr_steps" in ts or second.generated_ids \
            != first.generated_ids or second.audios != first.audios:
        raise AssertionError("the feature cache's hit ran perception or ASR "
                             "or changed the ids")

    # -- 12e. a 65 s clip, chunked -------------------------------------------
    long_path = os.path.join(tmpdir, "long.wav")
    t = np.arange(65 * 16000) / 16000.0
    write_wav(long_path, (0.5 * np.sin(2 * np.pi * 350 * t)
                          * (np.sin(2 * np.pi * 3 * t) > 0)
                          ).astype(np.float32))
    msg = [{"role": "user", "content": "Summarise <|AUDIO|> in a line.",
            "audios": [{"audio": long_path, "text": None}]}]
    _build.reset_launch_counts()
    out = model.generate(msg, do_sample=False, max_new_tokens=32,
                         auto_chunk_long_audio=True)
    torch.cuda.synchronize()
    require_kernel_paths("ASR chunked 65 s")
    tc = dict(model.last_timings)
    print(f"chunked 65 s clip: {len(out.audios)} clips, transcripts "
          f"{texts(out)}, ids row0[:8]="
          f"{out.generated_ids[0][:8]}", flush=True)
    print_asr_times("ASR chunked 65 s b1 (3 clips)", tc, gpu)
    if len(out.audios) != 3 or any(os.path.exists(a[0])
                                   for a in out.audios):
        raise AssertionError(f"chunking: {out.audios}")
    return t2


def check_qmm_plan() -> None:
    """K7's wgmma plan: ``plan_qmm`` equal to the C twin's
    (``desta_qmm_plan``) on this card and at 132 SMs, and its cluster
    waves (``gemm.cluster_ctas``) to the clusters of 1..8 CTAs of the
    kernel the card runs at once, on a 132-SM card."""
    import ctypes
    from desta25_audio_tpu_torch.ops import _build, gemm
    from desta25_audio_tpu_torch.ops.qmm import QMM_SPLITS_MAX, plan_qmm
    lib = _build.library()
    n_sm = _build.sm_count("cuda")
    out = (ctypes.c_int * 5)()
    for M in (17, 64, 65, 121, 128):
        for N, K in ((6144, 4096), (4096, 4096), (28672, 4096),
                     (4096, 14336), (130560, 4096), (1000, 512)):
            for sms in (0, 132):
                _build.check(lib.desta_qmm_plan(M, N, K, sms, out),
                             "desta_qmm_plan")
                p = plan_qmm(M, N, K, sms or n_sm)
                if tuple(out) != (p.nx, p.splits, p.tps, p.nkt, p.tiles):
                    raise AssertionError(f"plan_qmm {M, N, K} at {sms} SMs: "
                                         f"{p}, the card's {tuple(out)}")
    got = {}
    for nx in (64, 128):
        for s in range(1, QMM_SPLITS_MAX + 1):
            c = ctypes.c_int(-1)
            _build.check(lib.desta_qmm_max_clusters(nx, s,
                                                    ctypes.addressof(c)),
                         "desta_qmm_max_clusters")
            got[nx, s] = c.value * s
    want = {k: gemm.cluster_ctas(k[1], n_sm) for k in got}
    print(f"K7 wgmma plan equal to the C twin's; CTAs in flight by (x "
          f"width, cluster) ({n_sm} SMs): {got}", flush=True)
    if n_sm == 132 and got != want:
        raise AssertionError(f"K7's waves {want}, the card's {got}")


def check_int8_matmuls(qllm, gen):
    """Phase 13a: K7 (quant_matmul) at M=2 on the int8 head (the skinny
    GEMM) and on its wgmma path at M=125, and at M=17, 33, 64, 65, 100,
    121 and 127 (inputs from a generator of their own), on layer 0's four
    weight shapes, and the W8A8 prefill GEMM at M=250 on
    the same shapes and the head, and at a ragged M=129 (one 256-row tile,
    K split across a cluster) and M=1500 (a long prompt's 128-row tiles)
    on the four layer shapes, each against its plain version in f32 within
    TOL_QMM, W8A8 bit-identical; K7's wgmma path also in bf16 (the f32 sum
    rounded once), two launches bit-identical, beside the control (the
    plain version with rank 0's k-range dropped, which must read above
    TOL_QMM).  Returns {name: (worst err, ms, plain_ms, bound_ms, bound_by,
    library_ms)}: K7's times are the M=2 head's (every decode step runs
    it), its wgmma path's the sum over the four shapes at M=121 (one layer
    of the b1 prefill), each over the 32 layers' weights in turn, W8A8's
    the sum over one layer's four shapes at M=250 (one layer of the b2
    prefill)."""
    import torch
    from desta25_audio_tpu_torch.ops.qmm import (QMM_K_BYTES, plan_qmm, qmm,
                                                 qmm_plain, w8a8_matmul,
                                                 w8a8_matmul_plain)
    from desta25_audio_tpu_torch.bench_enc_gemm import library_k7
    check_qmm_plan()
    lib_k7, note = library_k7()
    print(f"torch._weight_int8pack_mm: {note}", flush=True)
    lay = qllm["layers"]
    names = ("wqkv", "wo", "w_gu", "w_down")
    leaves = {k: {"q": lay[k]["q"][0], "s": lay[k]["s"][0]} for k in names}
    leaves["head"] = qllm["lm_head"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(tag, kern, plain, M, name):
        leaf = leaves[name]
        N, K = leaf["q"].shape
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)

        def call(fn):
            return fn(x, leaf["q"], leaf["s"], torch.float32)
        got, want = call(kern), call(plain)
        err, rel = rel_err(got, want)
        same = torch.equal(got, want)
        ms = cuda_time_ms(lambda: call(kern))
        q_ms = cuda_time_ms(lambda: call(kern), queued=True)
        plain_ms = cuda_time_ms(lambda: call(plain), iters=3)
        lib_ms = None
        if tag == "K7" and lib_k7 is not None:
            lib_ms = cuda_time_ms(lambda: lib_k7(x, leaf["q"], leaf["s"]),
                                  iters=3)
        print(f"{tag} {kern.__name__} {name} M={M} N={N} K={K}: max_abs_err="
              f"{err:.3e} rel={rel:.3e} (tol {TOL_QMM})"
              + (f", bit-identical {same}" if tag == "W8A8" else "")
              + f"; kernel {ms:.4f} ms ({q_ms:.4f} queued), plain "
              f"{plain_ms:.4f} ms"
              + (f", torch._weight_int8pack_mm {lib_ms:.4f} ms"
                 if lib_ms is not None else ""), flush=True)
        if rel > TOL_QMM or (tag == "W8A8" and not same):
            raise AssertionError(f"{tag} disagrees on {name} M={M}: {rel}")
        # bf16 x, int8 weight and f32 scales read, f32 out written
        return err, ms, plain_ms, M * K * 2 + N * K + N * 4 + M * N * 4, \
            2 * M * N * K, lib_ms

    # the wgmma path's own inputs: gen's draws stay those of the checks
    # before this path existed, so the K8 family's inputs after them do too
    gen_w = torch.Generator("cuda").manual_seed(11)

    def run_wgmma(M, name):
        """The wgmma path at M rows: correctness on layer 0's weight."""
        leaf = leaves[name]
        N, K = leaf["q"].shape
        x = torch.randn(M, K, generator=gen_w, device="cuda").to(
            torch.bfloat16)
        got = qmm(x, leaf["q"], leaf["s"], torch.float32)
        again = qmm(x, leaf["q"], leaf["s"], torch.float32)
        got_bf = qmm(x, leaf["q"], leaf["s"], torch.bfloat16)
        want = qmm_plain(x, leaf["q"], leaf["s"], torch.float32)
        err, rel = rel_err(got, want)
        bits = torch.equal(got, again)
        rounded = torch.equal(got_bf, got.to(torch.bfloat16))
        p = plan_qmm(M, N, K, n_sm)
        dropped = x.clone()
        dropped[:, :p.tps * QMM_K_BYTES] = 0
        ctl = rel_err(qmm_plain(dropped, leaf["q"], leaf["s"], torch.float32),
                      want)[1]
        if M in (17, 121):
            print(f"K7 wgmma {name} M={M} N={N} K={K} (nx {p.nx}, splits "
                  f"{p.splits} of {p.tps} k-tiles): max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (tol {TOL_QMM}); two launches "
                  f"bit-identical {bits}; bf16 = the f32 sum rounded "
                  f"{rounded}; control, rank 0's k-range dropped: {ctl:.3e}",
                  flush=True)
        if rel > TOL_QMM or not bits or not rounded:
            raise AssertionError(f"K7 wgmma disagrees on {name} M={M}: rel "
                                 f"{rel}, bits {bits}, bf16 {rounded}")
        if ctl <= TOL_QMM:
            raise AssertionError(f"K7 wgmma {name} M={M}: the gate cannot "
                                 f"see a dropped k-range: {ctl}")
        return err

    def time_wgmma(M, name):
        """(ms, plain ms, library ms or None, bytes, operations) at M rows
        over the 32 layers' weights in turn (each call's weight out of the
        L2, as in the prefill)."""
        L = lay[name]["q"].shape[0]
        N, K = lay[name]["q"].shape[1:]
        x = torch.randn(M, K, generator=gen_w, device="cuda").to(
            torch.bfloat16)
        state = [0]

        def cycled(fn):
            def call():
                i = state[0] % L
                state[0] += 1
                return fn(x, lay[name]["q"][i], lay[name]["s"][i])
            return call
        ms = cuda_time_ms(cycled(lambda x, q, s: qmm(x, q, s,
                                                     torch.bfloat16)),
                          iters=L)
        q_ms = cuda_time_ms(cycled(lambda x, q, s: qmm(x, q, s,
                                                       torch.bfloat16)),
                            iters=L, queued=True)
        plain_ms = cuda_time_ms(cycled(lambda x, q, s: qmm_plain(
            x, q, s, torch.bfloat16)), iters=3)
        lib_ms = (cuda_time_ms(cycled(lib_k7), iters=3)
                  if lib_k7 is not None else None)
        print(f"K7 wgmma {name} M={M} N={N} K={K} over {L} layers' weights: "
              f"kernel {ms:.4f} ms ({q_ms:.4f} queued), plain {plain_ms:.4f}"
              f" ms, torch._weight_int8pack_mm "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"),
              flush=True)
        # bf16 x, int8 weight and f32 scales read, bf16 out written
        return (ms, plain_ms, lib_ms, M * K * 2 + N * K + N * 4 + M * N * 2,
                2 * M * N * K)

    k7 = [run("K7", qmm, qmm_plain, 2, "head")]
    k7 += [run("K7", qmm, qmm_plain, 125, n) for n in names]
    errs = [run_wgmma(M, n) for M in (17, 33, 64, 65, 100, 121, 127)
            for n in names]
    pre = [time_wgmma(121, n) for n in names]
    w8 = [run("W8A8", w8a8_matmul, w8a8_matmul_plain, 250, n) for n in leaves]
    w8 += [run("W8A8", w8a8_matmul, w8a8_matmul_plain, M, n)
           for M in (129, 1500) for n in names]
    pre_lib = (None if lib_k7 is None else sum(r[2] for r in pre))
    print(f"K7 wgmma: every layer shape at M=17..127 within TOL_QMM, bits "
          f"stable; one b1 prefill layer (M=121) {sum(r[0] for r in pre):.4f}"
          f" ms", flush=True)
    # K7's bounds: its operations are bf16 x int8 products in f32, the
    # bf16 rate; the head's at M=2, the wgmma path's over one layer's four
    # shapes at M=121; W8A8's over one layer's four shapes (int8)
    return {"quant_matmul": (max(r[0] for r in k7), k7[0][1], k7[0][2])
            + bound(k7[0][3], k7[0][4], "bf16") + (k7[0][5],),
            "quant_matmul_prefill": (max(errs + [r[0] for r in k7[1:]]),
                                     sum(r[0] for r in pre),
                                     sum(r[1] for r in pre))
            + bound(sum(r[3] for r in pre), sum(r[4] for r in pre), "bf16")
            + (pre_lib,),
            "w8a8_matmul": (max(r[0] for r in w8),
                            sum(r[1] for r in w8[:4]),
                            sum(r[2] for r in w8[:4]))
            + bound(sum(r[3] for r in w8[:4]), sum(r[4] for r in w8[:4]),
                    "int8")}


def check_verify_position0(model, convs, drafts) -> float:
    """Phase 16's (and 20's) check: after the b2 prefill, the first verify
    step's position-0 logits (token 0 = the first greedy token, then the
    drafts) against one K8-int8 (K8i with ORCA) decode step of that token on
    a copy of the same cache, within TOL_DECODE (same math: the draft block
    of token 0 is the token itself)."""
    import torch
    from desta25_audio_tpu_torch.generate.speculative import spec_cache_len
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.core import rms_norm
    from desta25_audio_tpu_torch.ops.fused_decode import (
        KVCache, fused_decode_layers, fused_verify_layers)
    llm, cfg = model.params["llm"], model.llm_cfg
    embeds, mask, aux, _, _ = model._run_generation_phases(convs, {})
    extra, spec = orca_injection(model, aux)
    B, T, _ = embeds.shape
    kd = 1 + drafts.shape[1]
    S = spec_cache_len(T, 32, kd)
    cache = tllm.init_kv_cache(cfg, B, S, embeds.dtype, embeds.device)
    full = torch.zeros(B, S, dtype=torch.int32, device=embeds.device)
    full[:, :T] = mask
    pos = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    logits, cache = tllm.llm_apply(llm, cfg, inputs_embeds=embeds,
                                   attention_mask=full, positions=pos,
                                   cache=cache, cache_index=0,
                                   extra_layer_fn=extra)
    full[:, T:] = 1
    tok0 = logits[:, -1].argmax(-1)
    toks = torch.cat([tok0[:, None], drafts], 1)
    steps = torch.arange(kd, device=embeds.device)[None, :]
    cv = KVCache(cache.k.clone(), cache.v.clone())
    hv, _ = fused_verify_layers(llm, cfg, tllm.embed_tokens(llm, toks), full,
                                pos[:, -1:] + 1 + steps, cv, T, inject=spec)
    hd, _ = fused_decode_layers(llm, cfg, tllm.embed_tokens(llm, toks[:, :1]),
                                full, pos[:, -1:] + 1, cache, T, inject=spec)

    def head(h):
        return tllm.head_logits(llm, rms_norm(llm["norm"], h,
                                              cfg.rms_norm_eps))
    err, rel = rel_err(head(hv[:, :1]), head(hd))
    bits = torch.equal(hv[:, :1], hd)
    what = "K8v" if spec is None else "K8v with K8i"
    print(f"{what} position 0 vs one {'K8-int8' if spec is None else 'K8i'} "
          f"step on the same cache (b2, T={T}, Kd={kd}): max_abs_err="
          f"{err:.3e} rel={rel:.3e} (tol {TOL_DECODE}); hidden states "
          f"bit-identical: {bits}", flush=True)
    if rel > TOL_DECODE:
        raise AssertionError(f"{what} position 0 disagrees with the decode "
                             f"step: {rel}")
    if spec is not None and not bits:
        raise AssertionError(f"{what} position 0 is not the decode step's "
                             "bits (the attention plans must not read Kd)")
    return err


def run_int8_llm(model, convs, gpu):
    """Phases 14-16 on the flagship model (int8 encoder already applied).
    Returns (launch counts summed over the int8 generate() runs, launch
    counts of the speculative run, the position-0 error, the decode
    attention's launches inside the int8 generate() runs' decode steps)."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.quant import is_quantized
    # -- 14. quantize the model's LLM in place -------------------------------
    t0 = time.perf_counter()
    model.apply_llm_quant()
    torch.cuda.synchronize()
    llm = model.params["llm"]
    if not (is_quantized(llm["layers"]["w_gu"])
            and llm["lm_head"]["q"].shape[0] % 2560 == 0):
        raise AssertionError("apply_llm_quant: not the int8 tree")
    torch.cuda.empty_cache()
    print(f"LLM quantized in place in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)

    # -- 15. int8 generate() at b2 and b1 ------------------------------------
    L = model.llm_cfg.num_hidden_layers
    runs = {2: convs[:2], 1: convs[2]}
    model.generate(runs[2], do_sample=False, max_new_tokens=2)   # warm-up
    outs, times, total, attn = {}, {}, {}, {}
    for b, msgs in runs.items():
        _build.reset_launch_counts()
        outs[b] = model.generate(msgs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        kcounts = _build.kernel_counts()
        times[b] = dict(model.last_timings)
        require_graph_replays(f"int8 LLM b{b}", counts, times[b])
        print(f"int8 LLM: launches during generate() b{b}: "
              f"{json.dumps(counts)}; kernels launched inside them: "
              f"{json.dumps(kcounts)}", flush=True)
        require_kernel_paths(f"int8 LLM b{b}")
        # one attention launch of the 7 a decode step's layer takes
        if kcounts.get("decode_attention", 0) * 7 != counts.get(
                "fused_decode_layers_int8", 0) or not kcounts:
            raise AssertionError(f"int8 LLM b{b}: decode_attention launches "
                                 f"{kcounts} for the step's {counts}")
        if kcounts.get("skinny_gemm", 0) < 4 * kcounts["decode_attention"]:
            raise AssertionError(f"int8 LLM b{b}: skinny_gemm launches "
                                 f"{kcounts} for the step's {counts}")
        for name in ("decode_attention", "skinny_gemm", "rms_norm"):
            attn[name] = attn.get(name, 0) + kcounts[name]
        if b == 1 and kcounts.get("quant_matmul_prefill", 0) < 4 * L:
            raise AssertionError(f"int8 LLM b1: the prefill's layer GEMMs "
                                 f"did not take K7's wgmma path: {kcounts}")
        total["quant_matmul_prefill"] = (total.get("quant_matmul_prefill", 0)
                                         + kcounts.get("quant_matmul_prefill",
                                                       0))
        must = ("log_mel", "quant_matmul", "fused_decode_layers_int8") + (
            ("w8a8_matmul",) if b == 2 else ())
        for name in must:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"int8 LLM b{b}: {name} not launched")
        if counts.get("fused_decode_layers", 0):
            raise AssertionError("int8 LLM: the bf16 K8 was launched")
        if b == 1 and (counts.get("w8a8_matmul", 0)
                       or counts["quant_matmul"] < 4 * L + 1):
            raise AssertionError("int8 LLM b1: the prefill did not take K7")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    check_outputs(model, [(outs[b], b) for b in runs])
    check_step_by_step(model, runs[2], outs[2])
    add_margins(model, runs[2], outs[2])
    add_margins(model, runs[1], outs[1])
    print(f"int8 LLM generated ids b2 row0[:8]={shown(outs[2], 0)} "
          f"b1[:8]={shown(outs[1], 0)}", flush=True)
    print_times("int8 LLM + int8 encoder", sorted(times.items()), gpu)
    # -- 15b. the b2 decode through the graph against the eager step --------
    check_decode_graph(model, runs[2], "int8 LLM", gpu)

    # -- 16. speculative generate() at b2 ------------------------------------
    model.generate(runs[2], do_sample=False, max_new_tokens=4,
                   speculative_k=4)                              # warm-up
    _build.reset_launch_counts()
    spec = model.generate(runs[2], do_sample=False, max_new_tokens=32,
                          speculative_k=4)
    torch.cuda.synchronize()
    spec_counts = _build.launch_counts()
    t = dict(model.last_timings)
    print(f"speculative b2: launches during generate(): "
          f"{json.dumps(spec_counts)}", flush=True)
    for name in ("fused_verify_layers", "log_mel"):
        if spec_counts.get(name, 0) <= 0:
            raise AssertionError(f"speculative b2: {name} was not launched")
    check_outputs(model, [(spec, 2)])
    err0 = check_verify_position0(
        model, runs[2],
        torch.tensor(spec.generated_ids, device=model.device)[:, 1:4])
    steps, emitted = int(t["decode_steps"]), int(t["spec_tokens"])
    plain = times[2]
    plain_tokens = sum(len(r) - 1 for r in outs[2].generated_ids)
    agree = [next((i for i, (a, c) in enumerate(zip(r, p)) if a != c),
                  len(r)) for r, p in zip(spec.generated_ids,
                                          outs[2].generated_ids)]
    print(f"speculative b2 (k=4) ({gpu}): prefill {t['prefill_ms']:.1f} ms, "
          f"{steps} verify steps for {emitted} tokens after the first "
          f"({emitted / max(steps, 1):.2f} tokens/step for the batch), decode"
          f" {t['decode_ms'] / max(emitted, 1):.3f} ms per emitted token "
          f"(plain greedy: {plain['decode_ms'] / max(plain_tokens, 1):.3f});"
          f" leading ids equal to the plain greedy run (information): "
          f"{agree} of 32", flush=True)
    return total, spec_counts, err0, attn


def inject_spec(cfg, gen, B: int, ta: int):
    """A random int8 cross-attention stack for cfg (its gate2 weight made
    non-zero, so the gate path shows) and random audio K/V [L, B, ta, D]:
    an in-kernel injection spec with on = 1 for every row."""
    import torch
    from desta25_audio_tpu_torch.models.orca import init_orca_cross_attns
    from desta25_audio_tpu_torch.ops.quant import quantize_orca_cross_attns
    stack = init_orca_cross_attns(
        types.SimpleNamespace(llm_config=cfg, orca_gate_init=0.1),
        torch.bfloat16, "cuda", gen)
    stack["layers"]["gate2"]["w"].normal_(0.0, 0.2, generator=gen)
    stack = quantize_orca_cross_attns(stack)
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    kv = torch.randn(2, L, B, ta, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    return dict(params=stack, k=kv[0], v=kv[1], ta_real=ta,
                heads=cfg.num_attention_heads,
                on=torch.ones(B, dtype=torch.float32, device="cuda"))


def check_inject_kernels(gen):
    """17 (K8i's two kernels alone).  The injection attention
    (``inject_attention``, csrc/fused_inject.cu: keys split across a
    thread-block cluster, the range's K and V loaded before the PDL wait)
    against ``inject_attention_plain`` at Ta=375: Llama-3.1-8B's 32 heads of
    128 at b2 and b1 decode and the b2 verify (Kd=4), Qwen3-4B's 32 heads
    of 80 at b2 decode and verify; the gate (``inject_gate``) against
    ``inject_gate_plain`` at R = 2 and 8 rows of D = 4096 and 2 of 2560, on
    the term it adds to h (out - h).  Each within TOL_INJECT, two
    launches' bits equal; the attention beside a control (the plain
    version without one tile of 8 keys, the last of the first range) that
    must read above the gate, its verify rows' token 0 the decode launch's
    bits, its C-side plan the planner's.  Times at the b2 decode shape (R = 2):
    back-to-back CUDA events (the kernels line) and queued behind a sleep
    kernel, the plain versions', the bound and, for the attention,
    ``scaled_dot_product_attention`` over the same q and audio K/V (no
    bf16 product rounding: a yardstick only).  Returns the JSON rows (err, ms, plain_ms, bound_ms, bound_by,
    library_ms) of the attention and the gate."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.fused_decode import (
        inject_attention, inject_attention_plain, inject_attention_smem,
        inject_gate, inject_gate_plain, plan_inject_splits)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.library()
    rows, errs = {}, {"inject_attention": [], "inject_gate": []}
    Ta = 375
    for label, B, kd, D, H in (("b2 decode", 2, 1, 4096, 32),
                               ("b1 decode", 1, 1, 4096, 32),
                               ("b2 verify", 2, 4, 4096, 32),
                               ("Qwen3-4B b2 decode", 2, 1, 2560, 32),
                               ("Qwen3-4B b2 verify", 2, 4, 2560, 32)):
        dh = D // H
        bounds = plan_inject_splits(B, H, Ta, dh, n_sm)
        plan = (ctypes.c_int * 4)()
        _build.check(lib.desta_inject_attention_plan(
            B, kd, Ta, D, H, ctypes.addressof(plan)),
            "desta_inject_attention_plan")
        keys = -(-(bounds[1] - bounds[0]) // 8) * 8     # whole tiles
        want_plan = (len(bounds) - 1, keys)
        if (tuple(plan)[:2] != want_plan or plan[2] != inject_attention_smem(
                kd, dh, keys, bool(plan[3]))):
            raise AssertionError(f"injection attention plan {tuple(plan)} "
                                 f"vs the planner's {want_plan} at {label}")
        iq = (torch.randn(B * kd, D, generator=gen, device="cuda") * 2
              ).to(torch.bfloat16)
        kv = torch.randn(2, B, Ta, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        ka, va = kv[0], kv[1]
        _build.reset_launch_counts()
        got = inject_attention(iq, ka, va, Ta, H)
        again = inject_attention(iq, ka, va, Ta, H)
        torch.cuda.synchronize()
        if _build.launch_counts() != {"inject_attention": 2}:
            raise AssertionError(f"inject_attention launches "
                                 f"{_build.launch_counts()}")
        want = inject_attention_plain(iq, ka, va, H, kd)
        err, rel = rel_err(got, want)
        keep = torch.cat([torch.arange(bounds[1] - 8, device="cuda"),
                          torch.arange(bounds[1], Ta, device="cuda")])
        _, ctrl = rel_err(inject_attention_plain(
            iq, ka[:, keep], va[:, keep], H, kd), want)
        bits = torch.equal(got, again)
        tok0 = True
        if kd > 1:
            one = inject_attention(iq.view(B, kd, D)[:, 0].contiguous(), ka,
                                   va, Ta, H)
            tok0 = torch.equal(got.view(B, kd, D)[:, 0], one)
        print(f"inject_attention [{label}] B={B} Kd={kd} Ta={Ta} heads={H} "
              f"dh={dh}: {len(bounds) - 1} key ranges of {keys} "
              f"({'in shared memory' if plan[3] else 'from global memory'}),"
              f" {B * H * (len(bounds) - 1)} CTAs, {plan[2]} bytes of shared"
              f" memory; max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{TOL_INJECT}); control, keys {bounds[1] - 8}-"
              f"{bounds[1] - 1} dropped: rel={ctrl:.3e} "
              f"(must exceed {TOL_INJECT}); two launches bit-identical: "
              f"{bits}; token 0 the decode launch's bits: {tok0}",
              flush=True)
        if rel > TOL_INJECT or not ctrl > TOL_INJECT or not bits or not tok0:
            raise AssertionError(f"inject_attention [{label}] failed its "
                                 "gates")
        errs["inject_attention"].append(err)
        if label != "b2 decode":
            continue
        q4 = iq.view(B, kd, H, dh).transpose(1, 2)
        k4 = ka.view(B, Ta, H, dh).transpose(1, 2)
        v4 = va.view(B, Ta, H, dh).transpose(1, 2)
        kern = lambda: inject_attention(iq, ka, va, Ta, H)  # noqa: E731
        plain = lambda: inject_attention_plain(  # noqa: E731
            iq, ka, va, H, kd)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4)
        ms, plain_ms, lib_ms = (cuda_time_ms(f) for f in (kern, plain, sdpa))
        q_ms, q_plain, q_lib = (cuda_time_ms(f, iters=n, queued=True)
                                for f, n in ((kern, 50), (plain, 10),
                                             (sdpa, 50)))
        nbytes = 2 * B * Ta * D * 2 + 2 * B * kd * D * 2
        b_ms, b_by = bound(nbytes, 4 * Ta * D * B * kd, "f32")
        print(f"inject_attention [{label}] times ({gpu_line()}): kernel "
              f"{ms:.4f} ms back to back, {q_ms:.4f} queued "
              f"({nbytes / q_ms / 1e6:.1f} GB/s, {b_ms / q_ms:.3f} of the "
              f"bound); plain {plain_ms:.4f} ({q_plain:.4f} queued); "
              f"scaled_dot_product_attention {lib_ms:.4f} ({q_lib:.4f} "
              f"queued); bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes)",
              flush=True)
        rows["inject_attention"] = (err, ms, plain_ms, b_ms, b_by, lib_ms)

    for label, R, kd, D in (("b2 decode", 2, 1, 4096),
                            ("b2 verify", 8, 4, 4096),
                            ("Qwen3-4B b2 decode", 2, 1, 2560)):
        Dg = D // 4
        f = lambda *sh: torch.randn(*sh, generator=gen,  # noqa: E731
                                    device="cuda")
        h, ig = f(R, D).to(torch.bfloat16), (f(R, Dg) * 0.5).to(
            torch.bfloat16)
        iao = (f(R, D) * 3 + 1).to(torch.bfloat16)
        wg2, bg2, lns, lnb = f(Dg) * 0.2, f(1) * 0.1, 1 + 0.1 * f(D), \
            0.1 * f(D)
        on = torch.ones(R // kd, device="cuda")
        on[-1] = 0.0
        args = (ig, iao, wg2, bg2, lns, lnb, on, kd)
        _build.reset_launch_counts()
        got, again = (inject_gate(h, *args) for _ in range(2))
        torch.cuda.synchronize()
        if _build.launch_counts() != {"inject_gate": 2}:
            raise AssertionError(f"inject_gate launches "
                                 f"{_build.launch_counts()}")
        want = inject_gate_plain(h, *args)
        err, rel = rel_err(got.float() - h.float(), want.float() - h.float())
        bits = torch.equal(got, again)
        off = torch.equal(got[-kd:], h[-kd:])
        print(f"inject_gate [{label}] R={R} Kd={kd} D={D} Dg={Dg}: "
              f"the added term's max_abs_err={err:.3e} rel={rel:.3e} (tol "
              f"{TOL_INJECT}); two "
              f"launches bit-identical: {bits}; the on = 0 row keeps h's "
              f"bits: {off}", flush=True)
        if rel > TOL_INJECT or not bits or not off:
            raise AssertionError(f"inject_gate [{label}] failed its gates")
        errs["inject_gate"].append(err)
        if label != "b2 decode":
            continue
        kern = lambda: inject_gate(h, *args)  # noqa: E731
        plain = lambda: inject_gate_plain(h, *args)  # noqa: E731
        ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
        q_ms = cuda_time_ms(kern, iters=50, queued=True)
        q_plain = cuda_time_ms(plain, iters=10, queued=True)
        nbytes = (R * Dg * 2 + R * D * 2 + 2 * R * D * 2 + Dg * 4 + 4
                  + 2 * D * 4 + (R // kd) * 4)
        b_ms, b_by = bound(nbytes, R * (2 * Dg + 10 * D), "f32")
        print(f"inject_gate [{label}] times ({gpu_line()}): kernel "
              f"{ms:.4f} ms back to back, {q_ms:.4f} queued; "
              f"plain {plain_ms:.4f} ({q_plain:.4f} queued); bound "
              f"{b_ms:.6f} ms ({b_by}: {nbytes} bytes)", flush=True)
        rows["inject_gate"] = (err, ms, plain_ms, b_ms, b_by, None)
    return tuple((max(errs[k]),) + rows[k][1:] for k in errs)


def check_fused_inject(model, gen):
    """Phase 17: K8i against its plain version, gated as K8, on the model's
    int8 Llama-3.1-8B tower (32 layers, injection head dim 128) and on a
    2-layer int8 Qwen3-4B tower (D=2560, H=32: head dim 80), each at Kd=1
    and Kd=4 with Ta=375 audio tokens; then its two kernels alone
    (:func:`check_inject_kernels`).  Returns the JSON rows of K8i (worst
    error of the four, then the Llama Kd=1 step's ms, plain_ms, bound_ms,
    bound_by), of its attention and of its gate."""
    import torch
    from desta25_audio_tpu_torch.config import llm_config_for
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.quant import quantize_llm_params
    cfg = model.llm_cfg
    spec = inject_spec(cfg, gen, 2, 375)
    llama = [check_fused_decode(model.params["llm"], cfg, gen, tag="K8i",
                                inject=spec),
             check_fused_decode(model.params["llm"], cfg, gen, kd=4,
                                ci=(100, 252), tag="K8i", inject=spec)]
    del spec
    cfg4 = dataclasses.replace(llm_config_for("Qwen/Qwen3-4B"),
                               num_hidden_layers=2)
    q4 = quantize_llm_params(tllm.init_llm(cfg4, torch.bfloat16, "cuda",
                                           gen))
    spec4 = inject_spec(cfg4, gen, 2, 375)
    qwen = [check_fused_decode(q4, cfg4, gen, tag="K8i Qwen3-4B",
                               inject=spec4),
            check_fused_decode(q4, cfg4, gen, kd=4, ci=(100, 252),
                               tag="K8i Qwen3-4B", inject=spec4)]
    del q4, spec4
    torch.cuda.empty_cache()
    return ((max(r[0] for r in llama + qwen),) + llama[0][1:],
            *check_inject_kernels(gen))


def run_orca(model, convs, gpu):
    """Phases 18-20: the ORCA model on the card, sharing the model's int8
    encoder and int8 LLM.  Returns (K8i's launches over phases 19-20, its
    two kernels' counts there, the launch and kernel counts of phase 18's
    opt-in K9 run)."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.ops import fused_decode_tp
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.models.orca import (init_orca_connector,
                                                     init_orca_cross_attns)
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.quant import is_quantized
    # -- 18. the ORCA model, float stack -------------------------------------
    ocfg = dataclasses.replace(config_from_yaml_file(ORCA_CONFIG),
                               llm_quant="int8")
    t0 = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(3)
    params = {"whisper": model.params["whisper"], "llm": model.params["llm"],
              "connector": init_orca_connector(ocfg, torch.float32, "cuda",
                                               g),
              "orca_cross_attns": init_orca_cross_attns(
                  ocfg, getattr(torch, ocfg.orca_xattn_dtype), "cuda", g)}
    orca = DeSTA25AudioModel(ocfg, device="cuda", params=params,
                             tokenizer=model.tokenizer)
    torch.cuda.synchronize()
    print(f"ORCA model ({ORCA_CONFIG}: {ocfg.qformer_num_hidden_layers}-layer"
          f" global Q-Former, {ocfg.orca_global_num_tokens} global tokens, "
          f"{orca.config.orca_xattn_dtype} stack in "
          f"{orca.llm_cfg.num_hidden_layers} layers) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, sharing the int8 encoder and "
          f"LLM ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)
    runs = {2: convs[:2], 1: convs[2]}
    inj_kernels = dict.fromkeys(INJECT_KERNELS, 0)

    def add_kernels(counts):
        for name in INJECT_KERNELS:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"ORCA: {name} was not launched")
            inj_kernels[name] += counts[name]
    _, _, aux, _, _ = orca._run_generation_phases(runs[2], {})
    D = orca.llm_cfg.hidden_size
    if (tuple(aux[0].shape) != (2, ocfg.orca_global_num_tokens, D)
            or tuple(aux[1].shape) != (2, 375, D)):
        raise AssertionError(f"ORCA tokens {tuple(aux[0].shape)} / "
                             f"{tuple(aux[1].shape)}")
    orca.generate(runs[2], do_sample=False, max_new_tokens=2)   # warm-up
    _build.reset_launch_counts()
    fout = orca.generate(runs[2], do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"ORCA float stack: launches during generate() b2: "
          f"{json.dumps(counts)}", flush=True)
    if (counts.get("fused_decode_inject", 0)
            or counts.get("fused_decode_layers_int8", 0)
            or any(counts.get(k, 0) for k in K9_HALVES)
            or counts.get("log_mel", 0) <= 0):
        raise AssertionError("ORCA float stack: a fused decode step ran, or "
                             "K1 did not")
    check_outputs(orca, [(fout, 2)])
    check_step_by_step(orca, runs[2], fout)
    loop_t = dict(orca.last_timings)
    add_margins(orca, runs[2], fout)
    print_times("ORCA float stack (injection in PyTorch)", [(2, loop_t)],
                gpu)

    # -- 18, opt-in: the same decode through the per-layer pair K9 ----------
    fused_decode_tp.FUSED_PERLAYER = True
    orca.generate(runs[2], do_sample=False, max_new_tokens=2)   # warm-up
    _build.reset_launch_counts()
    k9out = orca.generate(runs[2], do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    k9_counts = {**_build.launch_counts(), **_build.kernel_counts()}
    k9_t = dict(orca.last_timings)
    print(f"ORCA float stack, DESTA_FUSED_PERLAYER on: launches during "
          f"generate() b2: {json.dumps(k9_counts)}", flush=True)
    require_graph_replays("ORCA float stack, K9", k9_counts, k9_t)
    for name in K9_HALVES + ("rms_norm", "skinny_gemm", "log_mel"):
        if k9_counts.get(name, 0) <= 0:
            raise AssertionError(f"ORCA opt-in: {name} was not launched")
    for name in ("fused_decode_inject", "fused_decode_layers_int8"):
        if k9_counts.get(name, 0):
            raise AssertionError(f"ORCA opt-in: {name} was launched")
    check_outputs(orca, [(k9out, 2)])
    check_step_by_step(orca, runs[2], k9out)
    steps = lambda t: max(int(t["decode_steps"]), 1)  # noqa: E731
    print(f"ORCA float stack b2 decode ({gpu}): per-layer pair K9 "
          f"{k9_t['decode_ms'] / steps(k9_t):.2f} ms/step through its graph, "
          f"layer loop {loop_t['decode_ms'] / steps(loop_t):.2f} ms/step; "
          f"ids equal to the layer loop's (information): "
          f"{k9out.generated_ids == fout.generated_ids}", flush=True)
    check_decode_graph(orca, runs[2], "ORCA float stack (K9)", gpu,
                       hook=True)
    # a float stack falls back from speculation to the plain loop (K9 here)
    _build.reset_launch_counts()
    sout = orca.generate(runs[2], do_sample=False, max_new_tokens=32,
                         speculative_k=4)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"ORCA float stack, speculative_k=4: launches {json.dumps(counts)};"
          f" fallback reasons {orca.last_spec_fallback}", flush=True)
    if (counts.get("fused_verify_layers", 0) or not orca.last_spec_fallback
            or sout.generated_ids != k9out.generated_ids):
        raise AssertionError("ORCA float stack, speculative_k=4: the verify "
                             "step ran or the ids differ from the plain loop")
    fused_decode_tp.FUSED_PERLAYER = False
    t0 = time.perf_counter()
    orca.apply_orca_xattn_quant()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if not (is_quantized(orca.params["orca_cross_attns"]["layers"]["o"])
            and orca.config.orca_xattn_quant == "int8"):
        raise AssertionError("apply_orca_xattn_quant: not the int8 stack")
    print(f"ORCA stack quantized in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)

    # -- 19. generate() with the int8 stack at b2 and b1 ---------------------
    orca.generate(runs[2], do_sample=False, max_new_tokens=2)   # warm-up
    outs, times, launched = {}, {}, 0
    for b, msgs in runs.items():
        _build.reset_launch_counts()
        outs[b] = orca.generate(msgs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        times[b] = dict(orca.last_timings)
        require_graph_replays(f"ORCA b{b}", counts, times[b])
        print(f"ORCA int8 stack: launches during generate() b{b}: "
              f"{json.dumps(counts)}", flush=True)
        for name in ORCA_PATH:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"ORCA b{b}: {name} was not launched")
        if counts.get("fused_decode_layers", 0):
            raise AssertionError("ORCA: the bf16 K8 was launched")
        require_kernel_paths(f"ORCA b{b}")
        launched += counts["fused_decode_inject"]
        add_kernels(_build.kernel_counts())
    check_outputs(orca, [(outs[b], b) for b in runs])
    check_step_by_step(orca, runs[2], outs[2])
    add_margins(orca, runs[2], outs[2])
    add_margins(orca, runs[1], outs[1])
    print(f"ORCA generated ids b2 row0[:8]={shown(outs[2], 0)} "
          f"b1[:8]={shown(outs[1], 0)}; float-stack b2 row0[:8]="
          f"{shown(fout, 0)} (information)", flush=True)
    print_times("ORCA int8 stack (K8i)", sorted(times.items()), gpu)
    check_decode_graph(orca, runs[2], "ORCA int8 stack (K8i)", gpu,
                       orca=True)
    # -- 19b. one b2 call with ASR (the model's character detokenizer) ------
    orca._whisper_tokenizer = model.whisper_tokenizer
    aout, acounts, at = asr_generate(orca, without_text(runs[2]),
                                     "ORCA ASR b2")
    if at.get("asr_steps", 0) < 1 or acounts.get("fused_decode_inject",
                                                  0) <= 0:
        raise AssertionError(f"ORCA ASR b2: {at}, {acounts}")
    check_outputs(orca, [(aout, 2)])
    print(f"ORCA ASR b2: transcripts {texts(aout)}, ids "
          f"row0[:8]={aout.generated_ids[0][:8]}", flush=True)
    print_asr_times("ORCA int8 stack ASR b2", at, gpu)

    # -- 20. speculative generate() at b2 ------------------------------------
    orca.generate(runs[2], do_sample=False, max_new_tokens=4,
                  speculative_k=4)                               # warm-up
    _build.reset_launch_counts()
    spec = orca.generate(runs[2], do_sample=False, max_new_tokens=32,
                         speculative_k=4)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    t = dict(orca.last_timings)
    print(f"ORCA speculative b2: launches during generate(): "
          f"{json.dumps(counts)}", flush=True)
    for name in ("fused_verify_layers", "fused_decode_inject", "log_mel"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"ORCA speculative b2: {name} not launched")
    require_kernel_paths("ORCA speculative b2")
    launched += counts["fused_decode_inject"]
    add_kernels(_build.kernel_counts())
    check_outputs(orca, [(spec, 2)])
    check_verify_position0(
        orca, runs[2],
        torch.tensor(spec.generated_ids, device=orca.device)[:, 1:4])
    steps, emitted = int(t["decode_steps"]), int(t["spec_tokens"])
    plain_tokens = sum(len(r) - 1 for r in outs[2].generated_ids)
    agree = [next((i for i, (a, c) in enumerate(zip(r, p)) if a != c),
                  len(r)) for r, p in zip(spec.generated_ids,
                                          outs[2].generated_ids)]
    print(f"ORCA speculative b2 (k=4) ({gpu}): prefill {t['prefill_ms']:.1f}"
          f" ms, {steps} verify steps for {emitted} tokens after the first "
          f"({emitted / max(steps, 1):.2f} tokens/step for the batch), decode"
          f" {t['decode_ms'] / max(emitted, 1):.3f} ms per emitted token "
          f"(plain greedy: {times[2]['decode_ms'] / max(plain_tokens, 1):.3f}"
          f"); leading ids equal to the plain greedy run (information): "
          f"{agree} of 32", flush=True)
    # -- 20d. the serving engine on the ORCA model ----------------------------
    run_engine_orca(orca, convs, gpu)
    # -- 20e. the spec engine on the ORCA model -------------------------------
    run_engine_orca_spec(orca, convs, gpu)
    return launched, inj_kernels, k9_counts


def phase_mesh(p: int, cards: bool, n_data: int = 1):
    """An (n_data, p) mesh: n_data * p virtual ranks on the first card, or
    with ``cards`` one rank on each of the first n_data * p cards."""
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh
    n = n_data * p
    return make_mesh(n_data=n_data, n_model=p,
                     devices=[f"cuda:{i}" for i in range(n)]
                     if cards else ["cuda:0"] * n)


def _nccl_allreduce_ms(devs, R: int, D: int, iters: int = 20):
    """Information: one PyTorch call that sums the same [R, D] f32
    partials over the p cards ``devs`` (``torch.cuda.nccl.all_reduce``, the
    library's collective; never on the port's path), host clock around
    ``iters`` calls with every card synchronised; None where the ranks do
    not sit on distinct cards (NCCL takes one rank a card)."""
    import torch
    if len(set(devs)) < len(devs):
        return None
    import torch.cuda.nccl as nccl
    xs = [torch.randn(R, D, device=d) for d in devs]
    nccl.all_reduce(xs)
    for d in devs:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        nccl.all_reduce(xs)
    for d in devs:
        torch.cuda.synchronize(d)
    return (time.perf_counter() - t0) * 1e3 / iters


def check_tp_allreduce(gen, cards: bool, rounds: int = 200,
                       replays: int = 30):
    """Phase 20a: the all-reduce alone (``MeshBuffers.store`` /
    ``reduce``: the peer-store GEMM, then the fused consumer, which adds the
    ranks' sum into the residual and writes the next half's RMSNorm), at
    p = 2 and 4 ranks (virtual ranks of the card, or with ``cards`` one a
    card), R = 2 and 8 rows, D = 4096, bf16 and f32 residuals.  Each round:
    ``begin(1)`` fills the ranks' epoch base words, every rank's producer
    (the int8 peer-store GEMM of x [R, 4096/p] with its own weight shard,
    the wo shape of Llama-3.1-8B) stores its partial into every rank's
    buffer, then every rank's consumer.  Checked: every rank's buffer holds
    the same partials, each partial within TOL_QMM of the plain product;
    every rank's residual bit-identical to ``allreduce_rmsnorm_plain``'s;
    its norm bit-identical to the step's own norm kernel on that residual
    (``decode_rms_norm``, bf16 residual) and within TOL_DECODE of
    ``rms_plain`` (both residuals; torch sums the squares in another
    order).  10 rounds on the caller's stream (serial), then ``rounds``
    rounds with each rank on its own stream, inputs fresh every round, the
    slot alternating.  Then ``replays`` replays of one CUDA graph per card
    of two rounds (slot 0, then slot 1, at p = 2 and 4, R = 2, bf16): fresh
    inputs and a new base before each, the flags at the new epochs after
    it, the residual and norm bit for bit as above (a frozen epoch would
    let a consumer read last replay's partials).  The control: a graph
    whose second round skips the last rank's producer must set the error
    words, finish within a few spins' timeouts and raise at
    ``check_timeouts``.  Returns the JSON row of the p=2, R=2 bf16 consumer
    (the generate() shape): error, its time, the plain version's, the bound
    (p partials read, h read and written, the weight read, the norm
    written), NCCL's all-reduce of the same partials across cards."""
    import torch
    from desta25_audio_tpu_torch.generate.graph import CardGraphs
    from desta25_audio_tpu_torch.ops.fused_decode import decode_rms_norm
    from desta25_audio_tpu_torch.ops.qmm import qmm_plain
    from desta25_audio_tpu_torch.ops.tp_allreduce import (
        MeshBuffers, allreduce_plain, allreduce_rmsnorm_plain)
    from desta25_audio_tpu_torch.parallel.mesh import on_device
    D, row, eps = 4096, None, 1e-5

    def launch(bufs, devs, streams, xs, ws, hs, wn, xns, slot, rnd,
               skip=None, only=None):
        """One round: every producer, then every consumer (not rank
        ``skip``'s producer; with ``only``, the ranks on that device
        alone)."""
        ranks = [m for m, d in enumerate(devs)
                 if only is None or torch.device(d) == torch.device(only)]
        for m in ranks:
            if m != skip:
                with on_device(devs[m]):
                    bufs.store(m, slot, rnd, xs[m], ws[m]["q"], ws[m]["s"],
                               "tp_allreduce_store", streams[m].cuda_stream)
        for m in ranks:
            with on_device(devs[m]):
                bufs.reduce(m, slot, rnd, hs[m], streams[m].cuda_stream,
                            wn[m], xns[m], eps)

    def fork(streams, curs):
        for st, c in zip(streams, curs):
            if st != c:
                st.wait_stream(c)

    def join(streams, curs):
        for st, c in zip(streams, curs):
            if st != c:
                c.wait_stream(st)

    def check_round(tag, bufs, devs, slot, h_in, hs, wn, xns):
        """The residuals and norms after a round of slot ``slot`` on
        residual h_in; returns (worst h err, worst norm rel vs rms_plain)."""
        dev0 = devs[0]
        parts = list(bufs.rbuf[0][slot])
        for r in range(1, len(devs)):
            if not torch.equal(bufs.rbuf[r][slot].to(dev0),
                               bufs.rbuf[0][slot]):
                raise AssertionError(f"{tag}: rank {r} received other "
                                     "partials than rank 0")
        (want,), (want_xn,) = allreduce_rmsnorm_plain(parts, [h_in], wn[0],
                                                      eps)
        kern_xn = (decode_rms_norm(want, wn[0], eps)
                   if want.dtype == torch.bfloat16 else None)
        w_h, w_n = 0.0, 0.0
        for m in range(len(devs)):
            got, got_xn = hs[m].to(dev0), xns[m].to(dev0)
            w_h = max(w_h, rel_err(got, want)[0])
            w_n = max(w_n, rel_err(got_xn, want_xn)[1])
            if not torch.equal(got, want):
                raise AssertionError(f"{tag}: rank {m}'s residual is not "
                                     "bit-identical to the plain reduce")
            if not torch.equal(got_xn, xns[0].to(dev0)) or (
                    kern_xn is not None and not torch.equal(got_xn,
                                                            kern_xn)):
                raise AssertionError(f"{tag}: rank {m}'s norm is not the "
                                     "norm kernel's bits on the residual")
        if w_n > TOL_DECODE:
            raise AssertionError(f"{tag}: norm vs rms_plain rel {w_n}")
        return w_h, w_n

    for p in (2, 4):
        mesh = phase_mesh(p, cards)
        mesh.enable_peer_access()
        devs = mesh.devices[0]
        dev0, cur = devs[0], torch.cuda.current_stream(devs[0])
        curs = [torch.cuda.current_stream(d) for d in devs]
        K = 4096 // p
        ws = [{k: v.to(d) for k, v in _int8_leaf(gen, D, K,
                                                  bias=False).items()}
              for d in devs]
        w0 = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
              ).bfloat16()
        wn = [w0.to(d) for d in devs]
        for R in (2, 8):
            for dtype in (torch.bfloat16, torch.float32):
                kind = "bf16" if dtype == torch.bfloat16 else "f32"
                bufs = MeshBuffers(devs, R, D)
                xns = [torch.empty(R, D, dtype=torch.bfloat16, device=d)
                       for d in devs]
                worst_part, worst_h, worst_n, n_checked = 0.0, 0.0, 0.0, 0
                for mode, n in (("serial", 10), ("concurrent", rounds)):
                    streams = curs if mode == "serial" else mesh.streams()[0]
                    for i in range(n):
                        slot = i % 2
                        xs = [torch.randn(R, K, generator=gen,
                                          device="cuda").to(d, torch.bfloat16)
                              for d in devs]
                        h0 = (torch.randn(R, D, generator=gen, device="cuda")
                              * 4).to(dev0, dtype)
                        hs = [h0.to(d, copy=True) for d in devs]
                        bufs.begin(1)
                        fork(streams, curs)
                        launch(bufs, devs, streams, xs, ws, hs, wn, xns,
                               slot, 1)
                        join(streams, curs)
                        bufs.check_timeouts("tp_allreduce")
                        e_h, e_n = check_round(
                            f"tp_allreduce p={p} R={R} {kind} {mode} round "
                            f"{i}", bufs, devs, slot, h0, hs, wn, xns)
                        worst_h, worst_n = max(worst_h, e_h), max(worst_n,
                                                                  e_n)
                        if i == 0:
                            for m in range(p):
                                worst_part = max(worst_part, rel_err(
                                    bufs.rbuf[0][slot][m], qmm_plain(
                                        xs[m], ws[m]["q"], ws[m]["s"],
                                        torch.float32).to(dev0))[1])
                        n_checked += 1
                if worst_part > TOL_QMM:
                    raise AssertionError(f"tp_allreduce p={p} R={R}: a "
                                         f"partial disagrees with plain: "
                                         f"{worst_part}")
                line = (f"tp_allreduce p={p} R={R} D={D} {kind} residual on "
                        f"{mesh} ({gpu_line()}): {n_checked} rounds (10 "
                        f"serial, {rounds} concurrent on {p} streams), every "
                        f"rank's residual bit-identical to the plain reduce "
                        f"(max_abs_err {worst_h:.3e}), its norm "
                        + ("bit-identical to decode_rms_norm's, "
                           if dtype == torch.bfloat16 else "")
                        + f"vs rms_plain rel <= {worst_n:.3e} (tol "
                        f"{TOL_DECODE}), partials vs plain rel <= "
                        f"{worst_part:.3e} (tol {TOL_QMM})")
                if R == 2 and dtype == torch.bfloat16:
                    # one rank's consumer on published flags (no wait),
                    # beside the plain version's, the same consumer without
                    # the norm followed by the step's norm kernel, and
                    # NCCL's sum of the same partials across cards
                    h, xn = hs[0].clone(), xns[0]
                    parts = list(bufs.rbuf[0][slot])
                    cons = lambda: bufs.reduce(  # noqa: E731
                        0, slot, 1, h, cur.cuda_stream, wn[0], xn, eps)
                    pair = lambda: (  # noqa: E731
                        bufs.reduce(0, slot, 1, h, cur.cuda_stream),
                        decode_rms_norm(h, wn[0], eps))
                    plain = lambda: allreduce_rmsnorm_plain(  # noqa: E731
                        parts, [h], wn[0], eps)
                    ms = cuda_time_ms(cons, iters=20)
                    plain_ms = cuda_time_ms(plain, iters=20)
                    q_ms = cuda_time_ms(cons, iters=50, queued=True)
                    q_pair = cuda_time_ms(pair, iters=50, queued=True)
                    nccl_ms = _nccl_allreduce_ms(devs, R, D)
                    b_ms, b_by = bound(p * R * D * 4 + 3 * R * D * 2 + D * 2,
                                       (p + 4) * R * D, "f32")
                    line += (f"; consumer {ms:.4f} ms back to back, "
                             f"{q_ms:.5f} ms queued (the consumer without "
                             f"the norm + decode_rms_norm {q_pair:.5f} ms "
                             f"queued), plain {plain_ms:.4f} ms, bound "
                             f"{b_ms:.6f} ms ({b_by}), NCCL all_reduce "
                             + ("n/a (virtual ranks)" if nccl_ms is None
                                else f"{nccl_ms:.4f} ms") + " (information)")
                    if p == 2:
                        row = (worst_h, ms, plain_ms, b_ms, b_by, nccl_ms)
                print(line, flush=True)
                del bufs
        # rounds replayed from one captured graph per card: the epochs
        # advance on the device
        bufs = MeshBuffers(devs, 2, D)
        streams = mesh.streams()[0]
        xs = [torch.zeros(2, K, dtype=torch.bfloat16, device=d) for d in devs]
        hs = [torch.zeros(2, D, dtype=torch.bfloat16, device=d)
              for d in devs]
        xns = [torch.empty(2, D, dtype=torch.bfloat16, device=d)
               for d in devs]

        def two_rounds(skip=None, only=None):
            mine = [m for m, d in enumerate(devs)
                    if only is None or torch.device(d) == torch.device(only)]
            sts = [streams[m] for m in mine]
            curs_ = [torch.cuda.current_stream(devs[m]) for m in mine]
            fork(sts, curs_)
            launch(bufs, devs, streams, xs, ws, hs, wn, xns, 0, 1, None, only)
            launch(bufs, devs, streams, xs, ws, hs, wn, xns, 1, 2, skip, only)
            join(sts, curs_)

        cg = CardGraphs(devs)
        bufs.begin(2)
        cg.run(two_rounds)                 # first use, eagerly
        torch.cuda.synchronize()
        cg.capture(two_rounds)
        worst = 0.0
        for i in range(replays):
            h0 = torch.randn(2, D, generator=gen, device="cuda").bfloat16()
            x0 = torch.randn(2, K, generator=gen, device="cuda").bfloat16()
            for m, d in enumerate(devs):
                hs[m].copy_(h0.to(d))
                xs[m].copy_((x0 * (m + 1)).to(d))
            base = bufs.begin(2)
            cg.replay()
            for d in set(devs):
                torch.cuda.synchronize(d)
            bufs.check_timeouts("tp_allreduce graph")
            flags = [f.tolist() for f in bufs.flags]
            if any(fl != [[base + 1] * p, [base + 2] * p] for fl in flags):
                raise AssertionError(f"tp_allreduce graph p={p} replay {i}: "
                                     f"flags {flags}, base {base}")
            parts0 = list(bufs.rbuf[0][0])
            h1 = allreduce_plain(parts0, [h0])[0]
            worst = max(worst, check_round(
                f"tp_allreduce graph p={p} replay {i}", bufs, devs, 1, h1,
                hs, wn, xns)[0])
        cg.reset()
        # the control: the second round's last producer skipped
        ctl = MeshBuffers(devs, 2, D)
        bufs = ctl
        cg = CardGraphs(devs)
        ctl.begin(2)
        cg.capture(lambda only=None: two_rounds(skip=p - 1, only=only))
        ctl.begin(2)
        t0 = time.perf_counter()
        cg.replay()
        for d in set(devs):
            torch.cuda.synchronize(d)
        waited = time.perf_counter() - t0
        try:
            ctl.check_timeouts("tp_allreduce control")
        except RuntimeError as e:
            raised = str(e)
        else:
            raise AssertionError(f"tp_allreduce p={p}: a skipped producer "
                                 "did not set the error words")
        cg.reset()
        print(f"tp_allreduce p={p} on {mesh}: {2 * replays} rounds replayed "
              f"from one graph per card, flags at base + 1, base + 2 after "
              f"every replay, residuals and norms bit-identical (max_abs_err "
              f"{worst:.3e}); control, a replay whose second round skips "
              f"rank {p - 1}'s producer: finished in {waited:.2f} s and "
              f"raised ({raised})", flush=True)
        if waited > 20:
            raise AssertionError(f"tp_allreduce p={p}: the control took "
                                 f"{waited:.1f} s")
        del bufs, ctl
    return row


def _mesh_logits(params, cfg, h):
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.core import rms_norm
    return tllm.head_logits(params, rms_norm(params["norm"], h,
                                             cfg.rms_norm_eps))


def _drop_last_partial(parts, hs):
    """A control: ``allreduce_plain`` with the last rank's partial left
    out."""
    import torch
    from desta25_audio_tpu_torch.ops.tp_allreduce import allreduce_plain
    return allreduce_plain([*parts[:-1], torch.zeros_like(parts[-1])], hs)


def control_rank_sum(fault: str):
    """``models/llm._rank_sum`` with one fault, for the gates' controls:
    "drop" leaves the last rank's partial out; "local_amax" quantizes each
    rank's W8A8 rows with the amax of its own columns (the fault that the
    ``row_amax`` argument prevents)."""
    import torch
    from desta25_audio_tpu_torch.ops.core import matmul_f32
    from desta25_audio_tpu_torch.ops.qmm import W8A8_MIN_ROWS, quant_matmul
    from desta25_audio_tpu_torch.ops.quant import is_quantized
    from desta25_audio_tpu_torch.parallel.mesh import on_device

    def rank_sum(ws, xs, l, device):
        amax = None
        if (fault != "local_amax" and is_quantized(ws[0])
                and xs[0][..., :1].numel() >= W8A8_MIN_ROWS):
            amax = torch.stack([x.float().abs().amax(-1, keepdim=True).to(
                device) for x in xs]).amax(0)
        n = len(ws) - 1 if fault == "drop" else len(ws)
        tot = None
        for w, x in list(zip(ws, xs))[:n]:
            with on_device(x.device):
                if is_quantized(w):
                    part = quant_matmul(
                        x, {"q": w["q"][l], "s": w["s"][l]}, torch.float32,
                        row_amax=None if amax is None else amax.to(x.device))
                else:
                    part = matmul_f32(x, w[l].t())
            tot = part.to(device) if tot is None else tot + part.to(device)
        return tot
    return rank_sum


def check_mesh_step(params, cfg, gen, p: int, cards: bool, kd: int = 1,
                    ci=(100, 200), tag="K10", inject=None, vs_k8=False,
                    n_data: int = 1):
    """One K10 decode (kd = 1) or verify step on ``params`` (its layer count
    taken from the tree) on an (n_data, p) mesh, B=2, S=256, per-row ci,
    row 0 left-padded, against its plain version: logits within TOL_MESH
    (and the control, the plain version with one rank's partial dropped,
    above it), the written cache rows within TOL_DECODE of the plain
    version's and no other row changed, every rank's residual equal bit for
    bit to its group's first, the serial launch order's residual equal to
    the concurrent one's; with ``vs_k8`` the logits also against one K8
    step (p = 1) on the unsharded tree within TOL_DECODE.  Returns
    (max_abs_err, rel, the unsharded K8 rel or None, the control's rel)."""
    import torch
    from unittest import mock
    from desta25_audio_tpu_torch.ops import fused_decode_mesh as fdm
    from desta25_audio_tpu_torch.ops.fused_decode import (fused_decode_layers,
                                                         fused_verify_layers)
    from desta25_audio_tpu_torch.parallel.mesh import use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (
        apply_llm_sharding, gather_cache, shard_kv_cache)
    L = params["layers"]["ln1"]["scale"].shape[0]
    inputs = decode_inputs(params, cfg, gen, kd, ci)
    ci, cache0, mask, positions, x = inputs
    cache0 = fresh_cache(cache0, 0, L)
    mesh = phase_mesh(p, cards, n_data)
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
        caches = [shard_kv_cache(cache0, cfg, mesh) for _ in range(4)]
        groups = fdm.mesh_step_ranks(sp, cfg, x, mask, positions, caches[0],
                                     ci, inject=inject)
        kern = (fdm.fused_decode_layers_mesh if kd == 1
                else fdm.fused_verify_layers_mesh)
        hser, _ = kern(sp, cfg, x, mask, positions, caches[1], ci,
                       inject=inject, serial=True)
        plain = functools.partial(fdm.fused_decode_layers_mesh_plain, sp,
                                  cfg, x, mask, positions)
        hp, _ = plain(caches[2], ci, inject=inject)
        with mock.patch.object(fdm, "allreduce_plain", _drop_last_partial):
            hc, _ = plain(caches[3], ci, inject=inject)
    for g, hs in enumerate(groups):
        for m, h in enumerate(hs[1:], 1):
            if not torch.equal(h.to(hs[0].device), hs[0]):
                raise AssertionError(f"{tag} p={p}: rank ({g}, {m})'s "
                                     "residual differs from its group's "
                                     "first")
    h0 = torch.cat([hs[0].to(x.device) for hs in groups])
    if not torch.equal(hser, h0):
        raise AssertionError(f"{tag} p={p}: the serial and concurrent launch "
                             "orders disagree")
    want = _mesh_logits(params, cfg, hp)
    err, rel = rel_err(_mesh_logits(params, cfg, h0), want)
    ctl = rel_err(_mesh_logits(params, cfg, hc), want)[1]
    got, ref = gather_cache(caches[0]), gather_cache(caches[2])
    check_written_rows(got, cache0, ci, kd, tag)
    row_rel = max(rel_err(getattr(got, side)[:, b, int(ci[b]):int(ci[b]) + kd],
                          getattr(ref, side)[:, b, int(ci[b]):int(ci[b]) + kd]
                          )[1] for b in range(2) for side in ("k", "v"))
    k8 = None
    if vs_k8:
        fn = fused_decode_layers if kd == 1 else fused_verify_layers
        h8, _ = fn(params, cfg, x, mask, positions, fresh_cache(cache0, 0, L),
                   ci, inject=inject)
        k8 = rel_err(_mesh_logits(params, cfg, h0),
                     _mesh_logits(params, cfg, h8))[1]
    print(f"{tag} ({n_data}, {p}) mesh L={L} B=2 Kd={kd} S=256 "
          f"ci={ci.tolist()}: logits vs plain max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {TOL_MESH}; control, one rank's partial "
          f"dropped: {ctl:.3e}); written k/v rows rel={row_rel:.3e} (tol "
          f"{TOL_DECODE}), no other row changed; every group's ranks' "
          f"residuals bit-identical; serial == concurrent"
          + ("" if k8 is None else f"; vs the unsharded K8 step rel="
             f"{k8:.3e} (tol {TOL_DECODE})"), flush=True)
    if rel > TOL_MESH or max(row_rel, k8 or 0.0) > TOL_DECODE:
        raise AssertionError(f"{tag} p={p} disagrees: logits {rel}, rows "
                             f"{row_rel}, vs K8 {k8}")
    if ctl <= TOL_MESH:
        raise AssertionError(f"{tag} p={p}: the gate cannot see a dropped "
                             f"partial ({ctl})")
    del sp, caches
    return err, rel, k8, ctl


def _prefill_layer0(tree, cfg, ids, mask, mesh=None):
    """Layer 0 of the prefill of ``ids`` on ``tree`` (unsharded, or cut for
    ``mesh``), the intermediates ``models/llm.py`` computes: the q/k/v
    projection and the attention heads (per rank, put back in the unsharded
    column order), the wo output rounded to bf16 and the residual after
    the attention."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.core import index_tree, rms_norm
    from desta25_audio_tpu_torch.ops.rope import llm_rope_cos_sin
    from desta25_audio_tpu_torch.parallel.mesh import on_device, use_mesh
    B, T = ids.shape
    S = mask.shape[1]
    ci = torch.zeros(B, dtype=torch.long, device=ids.device)
    q_pos = torch.arange(T, device=ids.device)[None, :].expand(B, T)
    amask = ((torch.arange(S, device=ids.device)[None, None, :]
              <= q_pos[:, :, None]) & (mask[:, None, :] > 0))[:, None]
    cos, sin = llm_rope_cos_sin(cfg, q_pos)
    x = tllm.embed_tokens(tree, ids)
    xn = rms_norm(index_tree(tree["layers"]["ln1"], 0), x, cfg.rms_norm_eps)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(use_mesh(mesh))
        cache = tllm.init_kv_cache(cfg, B, S, torch.bfloat16, "cuda")
        if mesh is None:
            lays, caches, lcfg = [tree["layers"]], [cache], cfg
            devs = [x.device]
        else:
            lays = [r["layers"] for r in tree.ranks[0]]
            caches, lcfg = cache.shards[0], tree.local_cfg
            devs = mesh.devices[0]
        qkv, heads = [], []
        for lp, c, dev in zip(lays, caches, devs):
            with on_device(dev):
                xd = xn.to(dev)
                qkv.append(tllm._linear(lp["wqkv"], xd, 0).to(x.device))
                heads.append(tllm._attention_heads(
                    lp, xd, cos.to(dev), sin.to(dev), amask.to(dev), lcfg, 0,
                    c, ci.to(dev), mask.to(dev)))
        if mesh is None:
            out = tllm._linear(lays[0]["wo"], heads[0], 0)
        else:
            out = tllm._rank_sum([lp["wo"] for lp in lays], heads, 0,
                                 x.device).to(x.dtype)
    heads = [h.to(x.device) for h in heads]
    HD = lcfg.num_attention_heads * lcfg.head_dim
    KVD = lcfg.num_key_value_heads * lcfg.head_dim
    split = [(t[..., :HD], t[..., HD:HD + KVD], t[..., HD + KVD:])
             for t in qkv]
    qkv = torch.cat([torch.cat([s[i] for s in split], -1) for i in range(3)],
                    -1)
    return qkv, torch.cat(heads, -1), out, x + out


def _ndiff(a, b) -> str:
    """How many elements of two bf16 tensors differ, and by how much."""
    n = int((a != b).sum())
    d = (a.float() - b.float()).abs().max().item()
    return f"{n} of {a.numel()} differ (max {d:.3e})"


def check_mesh_prefill(params, cfg, gen, cards: bool, p: int = 2):
    """The prefill under a mesh (``models/llm.py``'s per-rank layer loop)
    against the unsharded one on ``params``, in three legs.  (1) The wo and
    down products of layer 0 through ``_rank_sum`` against the unsharded
    product, both f32, at M = 296 (W8A8, each row quantized with the
    amax of the whole row) and M = 100 (K7): within TOL_MESH_QMM, with
    their controls (a rank-local amax, a dropped partial) above it.  (2)
    Where the two prefills part: layer 0's q/k/v, heads and wo output,
    and the residual after it, element by element (information).  (3) B=2
    rows of T=148 and T=50 random ids through 2 layers, logits at every
    position within TOL_MESH_PREFILL, and the control (one rank's partial
    dropped) above it, beside the unsharded prefill with its input moved
    by one ulp where layer 0's residual differs.  Returns the worse rel of
    (3)."""
    import torch
    from unittest import mock
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.qmm import quant_matmul
    from desta25_audio_tpu_torch.parallel.mesh import use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import apply_llm_sharding
    cfg = dataclasses.replace(
        cfg, num_hidden_layers=params["layers"]["ln1"]["scale"].shape[0])
    mesh = phase_mesh(p, cards)
    with use_mesh(mesh):
        sp = apply_llm_sharding(params, cfg, mesh)
    ranks = [r["layers"] for r in sp.ranks[0]]
    for key in ("wo", "w_down"):
        w = params["layers"][key]
        K = w["q"].shape[-1]
        for M in (296, 100):
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            xs = list(x.chunk(p, -1))
            ws = [r[key] for r in ranks]
            want = quant_matmul(x, {"q": w["q"][0], "s": w["s"][0]},
                                torch.float32)
            rel = rel_err(tllm._rank_sum(ws, xs, 0, x.device), want)[1]
            fault = "local_amax" if M == 296 else "drop"
            ctl = rel_err(control_rank_sum(fault)(ws, xs, 0, x.device),
                          want)[1]
            leg = "W8A8" if M == 296 else "K7"
            print(f"prefill {key} under a (1, {p}) mesh, {leg} M={M} K={K}: "
                  f"the ranks' f32 sum vs the unsharded product rel="
                  f"{rel:.3e} (tol {TOL_MESH_QMM}); control, "
                  f"{fault.replace('_', ' ')}: {ctl:.3e}", flush=True)
            if rel > TOL_MESH_QMM:
                raise AssertionError(f"prefill {key} {leg} under a mesh "
                                     f"disagrees: {rel}")
            if ctl <= TOL_MESH_QMM:
                raise AssertionError(f"prefill {key} {leg}: the gate cannot "
                                     f"see a {fault}: {ctl}")
    worst = 0.0
    for T in (148, 50):
        ids = torch.randint(0, cfg.vocab_size, (2, T), generator=gen,
                            device="cuda")
        mask = torch.ones(2, 256, dtype=torch.int32, device="cuda")
        mask[0, :10] = 0                      # row 0: left padding of 10
        a = _prefill_layer0(params, cfg, ids, mask)
        b = _prefill_layer0(sp, cfg, ids, mask, mesh)
        print(f"prefill under a (1, {p}) mesh, layer 0, B=2 T={T} "
              f"({'W8A8' if T == 148 else 'K7'}) against the unsharded: "
              f"q/k/v {_ndiff(b[0], a[0])}; heads {_ndiff(b[1], a[1])}; wo "
              f"output {_ndiff(b[2], a[2])}; residual {_ndiff(b[3], a[3])} "
              f"(information)", flush=True)

        def logits(tree, emb=None):
            cache = tllm.init_kv_cache(cfg, 2, 256, torch.bfloat16, "cuda")
            return tllm.llm_apply(
                tree, cfg, inputs_embeds=tllm.embed_tokens(tree, ids)
                if emb is None else emb, attention_mask=mask, cache=cache,
                cache_index=0)[0]
        want = logits(params)
        # how far one-ulp flips move these logits: the unsharded prefill
        # with its input moved by one bf16 ulp where layer 0's residual
        # differs under the mesh
        emb = tllm.embed_tokens(params, ids).clone()
        emb.view(torch.int16)[b[3] != a[3]] += 1
        ulp = rel_err(logits(params, emb)[:, 10:], want[:, 10:])[1]
        with use_mesh(mesh):
            got = logits(sp)
            with mock.patch.object(tllm, "_rank_sum",
                                   control_rank_sum("drop")):
                bad = logits(sp)
        rel = rel_err(got[:, 10:], want[:, 10:])[1]
        ctl = rel_err(bad[:, 10:], want[:, 10:])[1]
        worst = max(worst, rel)
        print(f"prefill under a (1, {p}) mesh, 2 layers, B=2 T={T} "
              f"({'W8A8' if T == 148 else 'K7'}): logits vs the unsharded "
              f"prefill rel={rel:.3e} (tol {TOL_MESH_PREFILL}; control, one rank's "
              f"partial dropped: {ctl:.3e}; the unsharded prefill with its "
              f"input moved by one ulp at those {int((b[3] != a[3]).sum())} "
              f"residual elements: {ulp:.3e})", flush=True)
        if ctl <= TOL_MESH_PREFILL:
            raise AssertionError(f"the prefill check cannot see a dropped "
                                 f"partial: {ctl}")
    if worst > TOL_MESH_PREFILL:
        raise AssertionError(f"the prefill under a mesh disagrees: {worst}")
    return worst


def check_fused_mesh(qllm, cfg, gen, cards: bool):
    """Phase 20b: the prefill under a (1, 2) mesh against the unsharded one
    (check_mesh_prefill); K10 against its plain version on the int8
    Llama-3.1-8B tower at p = 2 and 4 virtual ranks: 2 layers gated
    (check_mesh_step,
    and at p = 2 against the unsharded K8-int8 step), then all 32 layers as
    information (the error, the step times with each rank on its own stream
    and with every rank on one, the plain version's, the bound of the
    unsharded step's work); Kd = 4 verify at p = 2, K8i with a random int8
    ORCA stack (Ta = 375) at p = 2, a random 2-layer bf16 tower at p = 2,
    and the int8 tower on a (2, 2) mesh (two model groups, one batch row
    each), each gated as the 2-layer decode.  Returns the JSON row of K10
    (the worst 2-layer error, the p=2 32-layer times)."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops import fused_decode_mesh as fdm
    from desta25_audio_tpu_torch.parallel.mesh import use_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (apply_llm_sharding,
                                                           shard_kv_cache)
    two = _layer_slice(qllm, 0, 2)
    check_mesh_prefill(two, cfg, gen, cards)
    errs = [check_mesh_step(two, cfg, gen, p, cards, vs_k8=(p == 2))
            for p in (2, 4)]
    errs.append(check_mesh_step(two, cfg, gen, 2, cards, kd=4,
                                ci=(100, 252), tag="K10 verify"))
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    spec = inject_spec(cfg2, gen, 2, 375)
    errs.append(check_mesh_step(two, cfg, gen, 2, cards, tag="K10 with K8i",
                                inject=spec, vs_k8=True))
    del spec
    bf = tllm.init_llm(cfg2, torch.bfloat16, "cuda", gen)
    errs.append(check_mesh_step(bf, cfg, gen, 2, cards,
                                tag="K10 bf16 tower", vs_k8=True))
    del bf
    errs.append(check_mesh_step(two, cfg, gen, 2, cards, tag="K10 data axis",
                                n_data=2))
    torch.cuda.empty_cache()
    row = None
    B, L = 2, cfg.num_hidden_layers
    for p in (2, 4):
        inputs = decode_inputs(qllm, cfg, gen, 1, (100, 200))
        ci, cache0, mask, positions, x = inputs
        mesh = phase_mesh(p, cards)
        with use_mesh(mesh):
            sp = apply_llm_sharding(qllm, cfg, mesh)
            ck, cp = (shard_kv_cache(cache0, cfg, mesh) for _ in range(2))
            step = fdm.fused_decode_layers_mesh
            _, rel = rel_err(
                _mesh_logits(qllm, cfg, step(sp, cfg, x, mask, positions, ck,
                                             ci)[0]),
                _mesh_logits(qllm, cfg, fdm.fused_decode_layers_mesh_plain(
                    sp, cfg, x, mask, positions, cp, ci)[0]))
            ms = cuda_time_ms(lambda: step(sp, cfg, x, mask, positions, ck,
                                           ci), iters=5)
            ser_ms = cuda_time_ms(lambda: step(sp, cfg, x, mask, positions,
                                               ck, ci, serial=True), iters=5)
            # queued: the ranks on the current stream only (serial), and
            # only where that stream is the one card's
            q_ser = (None if cards else cuda_time_ms(lambda: step(
                sp, cfg, x, mask, positions, ck, ci, serial=True), iters=2,
                queued=True))
            plain_ms = cuda_time_ms(lambda: fdm.fused_decode_layers_mesh_plain(
                sp, cfg, x, mask, positions, cp, ci), iters=2)
            replay = mesh_step_replay_ms(sp, cfg, mask, ck, cards)
        b_ms, b_by = bound(*llm_step_work(qllm, cfg, B, 1, ci.tolist()),
                           "bf16")
        where = (f"{p} cards" if cards else
                 f"{p} virtual ranks of one card (they share its HBM: no "
                 "tensor-parallel speed)")
        print(f"K10 fused_decode_layers_mesh on {where}, L={L} B={B} S=256 "
              f"({gpu_line()}): {L}-layer logits vs plain rel={rel:.3e} "
              f"(information); eager {ms:.4f} ms/step with a stream per "
              f"rank, {ser_ms:.4f} ms/step on each card's current stream"
              + ("" if q_ser is None else f" ({q_ser:.4f} queued)")
              + "; the step (MeshStep: fill, layers) as one graph per "
              f"card's replay {replay[0]:.4f} ms/step"
              + ("" if replay[1] is None else f" ({replay[1]:.4f} queued)")
              + f", replays bit-identical to the eager MeshStep; plain "
              f"{plain_ms:.4f} ms/step, bound {b_ms:.4f} ms ({b_by}; per "
              f"card at {p} cards {b_ms / p:.4f} ms)", flush=True)
        if p == 2:
            row = (max(e[0] for e in errs), ms, plain_ms, b_ms, b_by, None)
        del sp, ck, cp, cache0
        torch.cuda.empty_cache()
    return row


def mesh_step_replay_ms(sp, cfg, mask, cache, cards: bool):
    """K10's decode step of ``generate()`` (``MeshStep``: the per-call
    state and the layers, no head; its embeddings gathered and filled as
    ``DecodeGraph.step`` does) on ``sp`` and its ShardedCache, every row
    writing at 150: once eagerly, then captured as one CUDA graph per card
    and replayed; the replay's hidden must equal the eager step's bit for
    bit.  Returns (ms/step back to back, ms/step queued behind a sleep
    kernel or None on cards, whose other cards the sleep would not
    hold)."""
    import torch
    from desta25_audio_tpu_torch.generate.graph import CardGraphs
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops.fused_decode_mesh import MeshStep
    B = mask.shape[0]
    cur = torch.zeros(B, 1, dtype=torch.long, device=mask.device)
    mask = mask.clone()
    mask[:, 150] = 1
    step = MeshStep(sp, cfg, mask, cache)
    cg = CardGraphs(step.cards)

    def fill():
        step.fill(tllm.embed_tokens(sp, cur), cur + 150, 150)
    fill()
    eager = [h.clone() for h in cg.run(step.run)]
    outs = cg.capture(step.run)

    def once():
        fill()
        cg.replay()
    once()
    torch.cuda.synchronize()
    step.check()
    if not all(torch.equal(a, b) for a, b in zip(eager, outs)):
        raise AssertionError("K10 graph: the replay's hidden differs from "
                             "the eager step's")
    ms = cuda_time_ms(once, iters=10)
    q_ms = None if cards else cuda_time_ms(once, iters=10, queued=True)
    step.check()
    cg.reset()
    return ms, q_ms


def teacher_forced_logits(model, convs, ids, loop: bool = False):
    """generate()'s path for ``convs`` with ``ids`` [B, n] fed back: the
    prefill's last position, then n - 1 decode steps (generate()'s cache
    length and positions), [n, B, V] f32; under a mesh through its
    dispatch.  With ``loop`` a per-layer hook (ORCA's injection, else the
    identity) joins every call, which keeps each one-token call in the
    layer loop, off the fused decode step, with weight-only products;
    raises if a fused kernel launched."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops import _build
    llm, cfg = model.params["llm"], model.llm_cfg
    embeds, mask, aux, _, _ = model._run_generation_phases(convs, {})
    hook = {}
    if loop:
        extra, _ = orca_injection(model, aux)
        hook = {"extra_layer_fn": extra or (lambda l, h: h)}

    def fused():
        return {k: v for k, v in _build.launch_counts().items()
                if k.startswith("fused_")}
    before = fused()
    B, T, _ = embeds.shape
    n = ids.shape[1]
    S = -(-(T + n) // 128) * 128
    cache = tllm.init_kv_cache(cfg, B, S, embeds.dtype, embeds.device)
    full = torch.zeros(B, S, dtype=torch.int32, device=embeds.device)
    full[:, :T] = mask
    pos = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    logits, cache = tllm.llm_apply(llm, cfg, inputs_embeds=embeds,
                                   attention_mask=full, positions=pos,
                                   cache=cache, cache_index=0, **hook)
    out = [logits[:, -1]]
    nxt = pos[:, -1:] + 1
    if loop:
        hook["w8a8"] = False
    for t in range(n - 1):
        full[:, T + t] = 1
        logits, cache = tllm.llm_apply(llm, cfg, input_ids=ids[:, t:t + 1],
                                       attention_mask=full, positions=nxt + t,
                                       cache=cache, cache_index=T + t, **hook)
        out.append(logits[:, 0])
    if loop and fused() != before:
        raise AssertionError("the layer-loop reference ran a fused step")
    return torch.stack(out)


def run_mesh_generate(model, convs, gpu, cards: bool):
    """Phase 20c: the model's int8 LLM cut for a (1, 2) mesh of virtual
    ranks on the one card (``apply_llm_sharding``), ``generate()`` b2 under
    ``use_mesh``, greedy, 32 new tokens: K10 and the all-reduce must launch,
    K8-int8 must not; the per-step logits with its ids fed back, against the
    unsharded LLM's on the same ids, within TOL_MESH_GEN, and the same with
    the prefill's partial sums faulted (one rank's dropped: above the gate;
    a rank-local amax: information); ms/step beside an unsharded run's.  Then ``speculative_k=4`` under the mesh: the
    tensor-parallel verify step must launch.  The unsharded LLM is the
    model's again at the end and the cut copy is freed.  Returns the launch
    counts of the b2 run."""
    import torch
    from unittest import mock
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.parallel.mesh import use_mesh
    full = model.params["llm"]
    mesh = phase_mesh(2, cards)
    t0 = time.perf_counter()
    model.apply_llm_sharding(mesh)
    sharded = model.params["llm"]
    torch.cuda.synchronize()
    print(f"LLM cut for {mesh} in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, the "
          f"unsharded LLM kept for the comparison)", flush=True)
    runs = convs[:2]
    with use_mesh(mesh):
        model.generate(runs, do_sample=False, max_new_tokens=2)   # warm-up
        _build.reset_launch_counts()
        out = model.generate(runs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        t_mesh = dict(model.last_timings)
        print(f"mesh (1, 2): launches during generate() b2: "
              f"{json.dumps(counts)}", flush=True)
        for name in MESH_PATH:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"mesh generate(): {name} not launched")
        if counts.get("fused_decode_layers_int8", 0):
            raise AssertionError("mesh generate(): K8-int8 was launched")
        n_cards = len({d for row in mesh.devices for d in row})
        require_graph_replays("mesh generate()", counts, t_mesh, n_cards)
        # the decode graph against the eager step: ids, every step's
        # logits bit for bit, the counts; ms/step both ways
        check_decode_graph(model, runs, "mesh (1, 2)", gpu, graphs=n_cards)
        check_outputs(model, [(out, 2)])
        ids = torch.tensor(out.generated_ids, device=model.device)
        tf_mesh = teacher_forced_logits(model, runs, ids)
        tf_ctl = {}
        for fault in ("drop", "local_amax"):      # the gate's controls
            with mock.patch.object(tllm, "_rank_sum",
                                   control_rank_sum(fault)):
                tf_ctl[fault] = teacher_forced_logits(model, runs, ids)
        model.generate(runs, do_sample=False, max_new_tokens=4,
                       speculative_k=4)                            # warm-up
        _build.reset_launch_counts()
        spec = model.generate(runs, do_sample=False, max_new_tokens=32,
                              speculative_k=4)
        torch.cuda.synchronize()
        spec_counts = _build.launch_counts()
        t_spec = dict(model.last_timings)
        add_margins(model, runs, out)
        # -- 20f. the serving engine under the mesh ---------------------------
        tag = "mesh (1, 2)" + (" on 2 cards" if cards else "")
        mesh_engine = run_mesh_engine(model, convs, gpu, mesh, tag)
    print(f"mesh (1, 2) speculative_k=4: launches {json.dumps(spec_counts)}",
          flush=True)
    if spec_counts.get("fused_verify_layers_mesh", 0) <= 0 or spec_counts.get(
            "fused_verify_layers", 0):
        raise AssertionError("mesh speculative: the tensor-parallel verify "
                             "step did not run, or the unsharded one did")
    check_outputs(model, [(spec, 2)])
    model.params["llm"] = full
    gate_mesh_engine(model, convs, gpu, mesh_engine, tag)
    tf_ref = teacher_forced_logits(model, runs, ids)
    model.generate(runs, do_sample=False, max_new_tokens=2)        # warm-up
    ref = model.generate(runs, do_sample=False, max_new_tokens=32)
    t_ref = dict(model.last_timings)
    add_margins(model, runs, ref)
    per_step = [rel_err(a, b)[1] for a, b in zip(tf_mesh, tf_ref)]
    ctl = {f: max(rel_err(a, b)[1] for a, b in zip(t, tf_ref))
           for f, t in tf_ctl.items()}
    steps = lambda t: max(int(t["decode_steps"]), 1)  # noqa: E731
    print(f"mesh (1, 2) generate() b2 ({gpu}): teacher-forced logits vs the "
          f"unsharded LLM rel: prefill {per_step[0]:.3e}, decode steps max "
          f"{max(per_step[1:]):.3e} (tol {TOL_MESH_GEN}; controls, the "
          f"prefill with one rank's partial dropped: {ctl['drop']:.3e}, with "
          f"a rank-local amax: {ctl['local_amax']:.3e}); ids row0[:8]="
          f"{shown(out, 0)}, unsharded {shown(ref, 0)}, "
          f"equal {out.generated_ids == ref.generated_ids} (information); "
          f"decode {t_mesh['decode_ms'] / steps(t_mesh):.2f} ms/step on "
          + ("2 cards" if cards else "2 virtual ranks of one card (they "
             "share its HBM: no tensor-parallel speed)")
          + f", unsharded on one card {t_ref['decode_ms'] / steps(t_ref):.2f} "
          f"ms/step; speculative {t_spec['decode_steps']} verify steps for "
          f"{t_spec['spec_tokens']} tokens", flush=True)
    if max(per_step) > TOL_MESH_GEN:
        raise AssertionError(f"mesh generate(): teacher-forced logits differ "
                             f"from the unsharded LLM's: {per_step}")
    if ctl["drop"] <= TOL_MESH_GEN:
        raise AssertionError(f"mesh generate(): the gate cannot see a "
                             f"dropped partial: {ctl['drop']}")
    del sharded, tf_mesh, tf_ref, tf_ctl
    mesh.buffers.clear()
    torch.cuda.empty_cache()
    return counts


def run_mesh(model, convs, gpu, cards: bool = False):
    """Phases 20a-20c on the model with its int8 LLM, on virtual ranks of
    the first card or, with ``cards``, on the first p cards.  Returns (the
    JSON rows of tp_allreduce and K10, the launch counts of 20c's b2
    run)."""
    import torch
    gen = torch.Generator("cuda").manual_seed(7)
    rows = {"tp_allreduce": check_tp_allreduce(gen, cards),
            "fused_decode_layers_mesh": check_fused_mesh(
                model.params["llm"], model.llm_cfg, gen, cards)}
    torch.cuda.empty_cache()
    return rows, run_mesh_generate(model, convs, gpu, cards)


def write_corpus(d: str, n: int = 12, fmt: str = "wav") -> str:
    """A synthetic training corpus: n gated tones at 16 kHz (1.5-4.25 s) as
    WAVs, or as ``fmt`` files through the native FFmpeg codec (phase 30b:
    "flac"), and a jsonl manifest of the reference schema (id, dataset,
    prompt with the audio locator, response)."""
    from desta25_audio_tpu_torch import native
    from desta25_audio_tpu_torch.audio.io import write_wav
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(d, "clips"), exist_ok=True)
    rows = []
    for i in range(n):
        t = np.arange(int((1.5 + 0.25 * i) * 16000)) / 16000.0
        sig = (0.5 * np.sin(2 * np.pi * (200 + 40 * i) * t)
               * (np.sin(2 * np.pi * 3 * t) > 0)).astype(np.float32)
        sig += 0.01 * rng.standard_normal(t.size).astype(np.float32)
        rel = f"clips/tone{i}.{fmt}"
        if fmt == "wav":
            write_wav(os.path.join(d, rel), sig)
        else:
            native.ff_encode(os.path.join(d, rel), sig, 16000)
        rows.append({"id": rel, "dataset": f"synthetic{i % 2}",
                     "prompt": f"Describe sound {i}. <|AUDIO|>",
                     "response": f"A gated tone at {200 + 40 * i} hertz."})
    manifest = os.path.join(d, f"train_{fmt}.jsonl")
    with open(manifest, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return manifest


def sampled(v):
    """Every 509th element of a leaf: a tree's movement is read on these
    (a copy of the whole 9 GB ORCA stack would count in the step's peak)."""
    return v.detach().reshape(-1)[::509].clone()


@contextlib.contextmanager
def update_tap(optimizer, params: bool = False):
    """Inside, ``optimizer.update`` keeps its call's gradients and updates
    in the yielded dict (references, no copies: nothing is added to the
    step's time or memory); with ``params`` also the parameters it was
    given, whole on the host (a copy inside the step: its first only)."""
    from desta25_audio_tpu_torch.parallel.sharding import gather_leaf
    real = optimizer.update
    got: dict = {}

    def update(grads, state, params_):
        if params:
            got["params"] = {k: gather_leaf(p, "cpu")
                             for k, p in params_.items()}
        updates, new = real(grads, state, params_)
        got.update(grads=grads, updates=updates)
        return updates, new
    optimizer.update = update
    try:
        yield got
    finally:
        del optimizer.update


class StepProbe:
    """Wraps a trainer's train step: per step, the launches it made, its
    host-clock time (device synchronised), its peak device memory, its
    metrics, and how far the trainable tree has moved from its start, read
    through ``view`` (``start`` holds each leaf's view); with ``keep`` the
    ``sampled`` elements of the gradients and of the trained leaves after
    the step too (read after the step's time and peak)."""

    def __init__(self, trainer, start, view=lambda v: v.detach(),
                 keep: bool = False):
        self.trainer, self.start, self.rows = trainer, start, []
        self.view, self.keep = view, keep
        self.real = trainer.train_step
        trainer.train_step = self
        self.t_end = None

    def __call__(self, trainable, layout, opt_state, batch):
        import torch
        from desta25_audio_tpu_torch.ops import _build
        from desta25_audio_tpu_torch.train.optimizer import flatten_tree
        # the host's wait for this step's batch since the last step ended
        wait = (None if self.t_end is None
                else (time.perf_counter() - self.t_end) * 1e3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _build.launch_counts()
        with (update_tap(self.trainer.optimizer) if self.keep
              else contextlib.nullcontext({})) as tap:
            t0 = time.perf_counter()
            out = self.real(trainable, layout, opt_state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        after = _build.launch_counts()
        moved = max(float((self.view(v) - self.start[k]).abs().max())
                    for k, v in flatten_tree(out[0]).items())
        self.rows.append({
            "ms": ms, "moved": moved, "shape": tuple(batch["input_ids"].shape),
            "peak_gib": peak / 2 ** 30,
            "launches": {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)},
            "metrics": {k: float(v) for k, v in out[2].items()},
            "wait_ms": wait})
        if self.keep:
            self.rows[-1].update(
                sample={k: sampled(v).float().cpu()
                        for k, v in flatten_tree(out[0]).items()},
                grads={k: sampled(g).float().cpu()
                       for k, g in tap["grads"].items()})
        self.t_end = time.perf_counter()
        return out


def print_steps(label: str, rows, gpu: str) -> None:
    for i, r in enumerate(rows):
        B, T = r["shape"]
        m = r["metrics"]
        print(f"{label} step {i + 1} B={B} T={T} ({gpu}): {r['ms']:.1f} ms, "
              f"{B * T / r['ms'] * 1e3:.0f} tokens/s, peak "
              f"{r['peak_gib']:.2f} GiB allocated; lm_loss "
              f"{m['lm_loss']:.4f} grad_norm {m['grad_norm']:.4f}; trainable "
              f"moved {r['moved']:.3e}; launches {json.dumps(r['launches'])}",
              flush=True)


def run_training(gpu: str, tmpdir: str):
    """22-24.  Returns K11's launches in phase 23's trainer run."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)

    # -- 22. the flagship training model, fresh in bf16; the corpus ----------
    cfg = config_from_yaml_file(CONFIG)
    t0 = time.perf_counter()
    model = DeSTA25AudioModel(cfg, device="cuda", seed=3,
                              tokenizer=CharTokenizer("llama3"))
    torch.cuda.synchronize()
    manifest = write_corpus(tmpdir)
    print(f"training model built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); corpus "
          f"{manifest}", flush=True)
    trainable, frozen = model.split_params()
    start = {k: v.detach().clone()
             for k, v in flatten_tree(trainable).items()}

    # -- 23. DeSTA25Trainer.train(), 3 steps at B=4 T=512, then evaluate() ---
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                      batch_size=4, max_seq_length=512)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    collate = CollateFn(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(exp_dir=os.path.join(tmpdir, "exp"), max_steps=3,
                         log_every_n_steps=1, remat=True,
                         eval_before_train=False, val_check_interval=1e9,
                         eval_max_batches=1, eval_max_new_tokens=16,
                         keep_checkpoints=1)
    # warm-up 2 steps: the first update has lr 0, the third lr 1e-4
    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    trainer = DeSTA25Trainer(model, ds, ds, collate, ocfg, tcfg)
    probe = StepProbe(trainer, start, keep=True)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = _build.launch_counts()
    _build.reset_launch_counts()
    report = trainer.evaluate(tag="smoke")
    torch.cuda.synchronize()
    eval_counts = _build.launch_counts()
    print_steps("flagship-train (23)", probe.rows, gpu)
    print(f"train() {train_s:.1f} s for 3 steps and a checkpoint; launches "
          f"{json.dumps(train_counts)}; evaluate(): loss {report['loss']:.4f}"
          f", accuracy {report['accuracy']:.3f} on {report['n_samples']} "
          f"samples, launches {json.dumps(eval_counts)}", flush=True)
    if len(probe.rows) != 3:
        raise AssertionError(f"train() ran {len(probe.rows)} steps, not 3")
    for i, r in enumerate(probe.rows):
        check_train_row(f"train step {i + 1}", r, (
            "flash_attention", "flash_attention_bwd",
            "packed_encoder_attention", "encoder_ffn", "log_mel"))
    if probe.rows[0]["moved"] != 0.0:
        raise AssertionError("the trainable tree moved at step 1 (lr 0)")
    if not probe.rows[2]["moved"] > 0.0:
        raise AssertionError("the trainable tree did not move by step 3")
    if any(t.requires_grad or t.grad is not None
           for t in flatten_tree(frozen).values()):
        raise AssertionError("a frozen leaf requires or holds a gradient")
    for name in ("fused_decode_layers", "log_mel"):
        if eval_counts.get(name, 0) <= 0:
            raise AssertionError(f"evaluate(): {name} not launched")
    if not (np.isfinite(report["loss"]) and os.path.exists(os.path.join(
            tcfg.exp_dir, "val@smoke-report.json"))):
        raise AssertionError(f"evaluate() report: {report}")

    # -- 24. one train step at the flagship's own shape, B=12 T=300 ----------
    dcfg24 = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                        batch_size=12, max_seq_length=300)
    batch = trainer._device_batch(CollateFn(cfg, dcfg24, model.tokenizer)(
        list(ds.iter_valid())[:12]))
    probe24 = StepProbe(trainer, start)
    state = trainer.opt_state
    for _ in range(2):       # the second step is the one without warm-up
        trainable, state, _ = trainer.train_step(trainable, trainer.layout,
                                                 state, batch)
    print_steps("flagship-train (24)", probe24.rows, gpu)
    for r in probe24.rows:
        if r["launches"].get("flash_attention", 0) \
                or r["launches"].get("flash_attention_bwd", 0):
            raise AssertionError("K11 launched at T=300 (the JAX dispatch "
                                 "takes it at T >= 512 only)")
        if not np.isfinite(r["metrics"]["loss"]):
            raise AssertionError(f"B=12 step: metrics {r['metrics']}")
        if r["launches"].get("log_mel", 0) <= 0:
            raise AssertionError("B=12 step: log_mel was not launched")

    # -- 31. training on a mesh and across processes: here, on this bf16
    # model and phase 23's rows, before 24b quantizes its tower -------------
    run_train_mesh(gpu, tmpdir, model, start, {
        "rows": probe.rows,
        "start": {k: sampled(v).float().cpu() for k, v in start.items()}},
        manifest)

    # -- 24b. the int8 tower, the JAX package's train setting ----------------
    from desta25_audio_tpu_torch.train.step import TrainLayout, make_train_step
    t0 = time.perf_counter()
    # the trainer's layout holds the bf16 tower: dropped before it is
    # quantized, and the step takes a layout of the int8 tower
    trainer.layout = trainer.eval_step = None
    model.apply_llm_quant()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trainable, frozen = model.split_params()
    start = {k: v.detach().clone()
             for k, v in flatten_tree(trainable).items()}
    print(f"tower quantized in place in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)", flush=True)
    box = types.SimpleNamespace(train_step=make_train_step(
        model.config, trainer.optimizer, remat=True))
    probe24b = StepProbe(box, start)
    _build.reset_launch_counts()
    layout = TrainLayout(None, frozen, model.config)
    for _ in range(2):
        trainable, state, _ = box.train_step(trainable, layout, state, batch)
    print_steps("flagship-train int8 tower (24b)", probe24b.rows, gpu)
    print(f"int8-tower steps: torch paths taken "
          f"{json.dumps(_build.fallback_counts())}", flush=True)
    for i, r in enumerate(probe24b.rows):
        check_train_row(f"int8-tower step {i + 1}", r,
                        ("packed_encoder_attention", "encoder_ffn",
                         "log_mel"))
        if r["launches"].get("w8a8_matmul", 0):
            raise AssertionError("int8-tower step: the W8A8 GEMM launched "
                                 "(training keeps the weight-only forward)")
        if not r["moved"] > 0.0:
            raise AssertionError("int8-tower step: the trainable tree did "
                                 "not move")
    return {k: train_counts.get(k, 0)
            for k in ("flash_attention", "flash_attention_bwd")}


def check_train_row(tag: str, r, kernels) -> None:
    """A StepProbe row: each of ``kernels`` launched, the loss finite and
    ``grad_norm`` finite and > 0 (a finite global norm: every gradient
    finite)."""
    for name in kernels:
        if r["launches"].get(name, 0) <= 0:
            raise AssertionError(f"{tag}: {name} not launched")
    m = r["metrics"]
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            and m["grad_norm"] > 0):
        raise AssertionError(f"{tag}: metrics {m}")


def with_transcriptions(batch, n: int, vocab: int, gen):
    """Phase 26b's batch: ``n`` positions after each row's audio tokens
    hold transcription embeddings (kind 2, ids below ``vocab`` drawn from
    ``gen``), which prompt-only training never has."""
    import torch
    b = {k: v.clone() for k, v in batch.items()}
    N = b["trans_ids"].shape[0]
    b["trans_ids"][:, :n] = torch.randint(10, vocab, (N, n), generator=gen,
                                          device=gen.device)
    b["trans_mask"][:, :n] = 1
    for r in range(b["kind"].shape[0]):
        last = int(torch.nonzero(b["kind"][r] == 1).max())
        b["kind"][r, last + 1:last + 1 + n] = 2
        b["aidx"][r, last + 1:last + 1 + n] = b["aidx"][r, last]
        b["pos"][r, last + 1:last + 1 + n] = torch.arange(
            n, device=b["pos"].device)
    return b


def run_orca_training(gpu: str, tmpdir: str) -> None:
    """26.  ORCA training at full width: the trainer at B=4 T=512 (a), one
    step with transcription positions (b), two at B=12 T=300 (c)."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)

    cfg = config_from_yaml_file(ORCA_CONFIG)
    t0 = time.perf_counter()
    model = DeSTA25AudioModel(cfg, device="cuda", seed=5,
                              tokenizer=CharTokenizer("llama3"))
    torch.cuda.synchronize()
    trainable, frozen = model.split_params()
    n_stack = sum(v.numel() for v in flatten_tree(
        trainable["orca_cross_attns"]).values())
    print(f"ORCA training model built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB; the f32 "
          f"cross-attention stack {n_stack / 1e9:.3f} B parameters)",
          flush=True)
    start = {k: sampled(v) for k, v in flatten_tree(trainable).items()}
    manifest = os.path.join(tmpdir, "train_wav.jsonl")

    # -- 26a. DeSTA25Trainer.train(), 3 steps at B=4 T=512, remat ------------
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                      batch_size=4, max_seq_length=512)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(exp_dir=os.path.join(tmpdir, "exp_orca"),
                         max_steps=3, log_every_n_steps=1, remat=True,
                         eval_before_train=False, val_check_interval=1e9,
                         keep_checkpoints=1)
    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    trainer = DeSTA25Trainer(model, ds, None,
                             CollateFn(cfg, dcfg, model.tokenizer), ocfg,
                             tcfg)
    probe = StepProbe(trainer, start, sampled)
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print_steps("orca-train (26a)", probe.rows, gpu)
    ckpt = os.path.realpath(os.path.join(tcfg.exp_dir, "checkpoint-latest"))
    ck_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
    print(f"ORCA train() {train_s:.1f} s for 3 steps and a checkpoint of "
          f"{ck_bytes / 2**30:.2f} GiB (state.pt and model.safetensors); aux "
          f"losses {json.dumps([{k: v for k, v in r['metrics'].items() if k.startswith('L_')} for r in probe.rows])}",
          flush=True)
    if len(probe.rows) != 3:
        raise AssertionError(f"ORCA train() ran {len(probe.rows)} steps")
    for i, r in enumerate(probe.rows):
        check_train_row(f"ORCA train step {i + 1}", r, (
            "flash_attention", "flash_attention_bwd",
            "packed_encoder_attention", "encoder_ffn", "log_mel"))
        m = r["metrics"]
        if not (m["L_ortho_diversity"] > 0 and m["L_ortho_qformer_local"] > 0
                and m["L_align_layerwise"] == 0.0):
            raise AssertionError(f"ORCA train step {i + 1}: aux {m}")
    if probe.rows[0]["moved"] != 0.0:
        raise AssertionError("ORCA: the trainable tree moved at step 1 "
                             "(lr 0)")
    if not probe.rows[2]["moved"] > 0.0:
        raise AssertionError("ORCA: the trainable tree did not move by "
                             "step 3")
    if any(t.requires_grad or t.grad is not None
           for t in flatten_tree(frozen).values()):
        raise AssertionError("ORCA: a frozen leaf requires or holds a "
                             "gradient")
    shutil.rmtree(tcfg.exp_dir)

    # -- 26b. one step with 8 transcription positions a row ------------------
    trainable, _ = model.split_params()
    batch = with_transcriptions(
        trainer._device_batch(trainer.collate_fn(list(ds.iter_valid())[:4])),
        8, model.llm_cfg.vocab_size, torch.Generator("cuda").manual_seed(6))
    probe26b = StepProbe(types.SimpleNamespace(train_step=probe.real), start,
                         sampled)
    state = trainer.opt_state
    trainable, state, _ = probe26b(trainable, trainer.layout, state, batch)
    print_steps("orca-train with transcriptions (26b)", probe26b.rows, gpu)
    r = probe26b.rows[0]
    check_train_row("ORCA step with transcriptions", r,
                    ("flash_attention", "flash_attention_bwd"))
    align = r["metrics"]["L_align_layerwise"]
    print(f"L_align_layerwise {align:.6f} over 8 transcription positions a "
          f"row", flush=True)
    if not (np.isfinite(align) and align > 0):
        raise AssertionError(f"ORCA: L_align_layerwise {align} with "
                             "transcription positions")

    # -- 26c. two steps at the config's own shape, B=12 T=300 ----------------
    dcfg26 = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                        batch_size=12, max_seq_length=300)
    batch = trainer._device_batch(CollateFn(cfg, dcfg26, model.tokenizer)(
        list(ds.iter_valid())[:12]))
    probe26c = StepProbe(types.SimpleNamespace(train_step=probe.real), start,
                         sampled)
    for _ in range(2):
        trainable, state, _ = probe26c(trainable, trainer.layout, state,
                                       batch)
    print_steps("orca-train (26c)", probe26c.rows, gpu)
    for i, r in enumerate(probe26c.rows):
        check_train_row(f"ORCA B=12 step {i + 1}", r, (
            "packed_encoder_attention", "encoder_ffn", "log_mel"))
        if r["launches"].get("flash_attention", 0) \
                or r["launches"].get("flash_attention_bwd", 0):
            raise AssertionError("ORCA: K11 launched at T=300")
    del trainer, model, trainable, frozen, start, state, batch
    gc.collect()
    torch.cuda.empty_cache()


def mesh_only(kind: str, count: int, gpu: str, cards: bool) -> int:
    """``--mesh-only``: phases 20a-20c and 20f alone, on the flagship model
    built with the int8 LLM (bf16 encoder), for work on the tensor-parallel
    path; with ``--cards`` the ranks are distinct cards (p = 2 and 4: run
    on four cards; 20f also on a (1, 4) mesh of four cards where there are
    four).  Prints the two kernels' JSON rows and the last line."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.parallel.mesh import use_mesh
    tmp = tempfile.TemporaryDirectory()
    wavs, _ = write_wavs(tmp.name)
    cfg = dataclasses.replace(config_from_yaml_file(CONFIG), llm_quant="int8")
    with torch.no_grad():
        model = DeSTA25AudioModel(cfg, device="cuda", seed=0,
                                  tokenizer=CharTokenizer("llama3"))
        convs = conversations(wavs)
        rows, launches = run_mesh(model, convs, gpu, cards)
        if cards and count >= 4:
            full, mesh = model.params["llm"], phase_mesh(4, True)
            tag = "mesh (1, 4) on 4 cards"
            model.apply_llm_sharding(mesh)
            with use_mesh(mesh):
                runs = run_mesh_engine(model, convs, gpu, mesh, tag)
            model.params["llm"] = full
            gate_mesh_engine(model, convs, gpu, runs, tag)
            mesh.buffers.clear()
    tmp.cleanup()
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": launches[n],
         "max_abs_err": r[0], "ms": r[1], "plain_ms": r[2], "bound_ms": r[3],
         "bound_by": r[4], "library_ms": r[5]} for n, r in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


# -- the serving engine (phases 12f, 16a-16g, 20d-20f) ----------------------

def engine_convs(wavs, n: int, text_only=()):
    """n conversations for the engine: phase 6's four with their prompt and
    transcription varied by index, text-only at the indices ``text_only``."""
    import copy
    base = conversations(wavs)
    out = []
    for i in range(n):
        if i in text_only:
            out.append([{"role": "user", "content":
                         f"Name {i % 7 + 2} colours of the rainbow."}])
            continue
        conv = copy.deepcopy(base[i % 4])
        conv[-1]["content"] += f" (request {i})"
        for a in conv[-1]["audios"]:
            a["text"] = f"{a['text']} number {i}"
        out.append(conv)
    return out


def submit_all(eng, convs, many: bool = True, **kw):
    """Submit ``convs`` (one submit_many, or one submit each); returns the
    ids and {rid: the engine's queued request} (its embeddings and ORCA
    tokens, kept for the gate)."""
    n0 = len(eng.queue)
    rids = (eng.submit_many(convs, **kw) if many
            else [eng.submit(c, **kw) for c in convs])
    return rids, {r.rid: r for r in eng.queue[n0:]}


def reference_logits(model, req, ids, how: str = "loop"):
    """A forward over one engine request's own prefix on one cache: its
    bucketed prompt (left padding masked, positions from 0) in one call as
    the engine's prefill runs it (the int8 tower's products through W8A8
    from 128 rows), then every emitted id but the last; with ORCA the
    injection through the PyTorch hook on the request's RoPE'd audio
    tokens.  ``how`` feeds the ids back:

    - "loop", the gate's reference: one at a time, in the decode step's
      order, through the layer loop (a per-layer hook keeps each T == 1
      call off the fused decode step: the torch attention over the cache
      and weight-only products, K7 at one row on an int8 tower; from the
      second id on replayed as one CUDA graph, without ORCA), so it runs
      none of the decode kernels the engine runs; raises if a fused kernel
      launched;
    - "fused": one at a time through the fused decode step, the kernel the
      engine runs (without ORCA; information only);
    - "one_call": all in one call, weight-only products (K7's ``wgmma``
      path) and the masked torch attention over the rows at once
      (information only).

    Returns (f32 logits [n, V] predicting each emitted id, the ids [n])."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    from desta25_audio_tpu_torch.models.orca import (
        gated_cross_attention_apply, precompute_cross_kv)
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.ops.core import index_tree
    llm, cfg = model.params["llm"], model.llm_cfg
    e = req.embeds
    dev, Tb = e.device, e.shape[1]
    y = torch.tensor(ids, dtype=torch.long, device=dev)
    n = y.shape[0]
    S = -(-(Tb + n) // 128) * 128
    cache = tllm.init_kv_cache(cfg, 1, S, e.dtype, dev)
    mask = torch.zeros(1, S, dtype=torch.int32, device=dev)
    mask[0, Tb - req.ctx_len:Tb] = 1

    def extra(l, h):
        return h
    if req.inject is not None:
        xa = model.params["orca_cross_attns"]
        k, v = precompute_cross_kv(xa, req.inject)
        k, v = k.to(e.dtype), v.to(e.dtype)

        def extra(l, h):
            return gated_cross_attention_apply(
                index_tree(xa["layers"], l), h, None,
                cfg.num_attention_heads, cached_kv=(k[l], v[l]))
    elif how != "loop":
        extra = None

    def fused():
        return sum(v for k, v in _build.launch_counts().items()
                   if k.startswith("fused_"))
    before = fused()
    pos = torch.clamp(torch.cumsum(mask[:, :Tb], 1) - 1, min=0)
    # a LoRA model's adapters join every call (phase 30d)
    lora = dict(lora=model.params.get("lora"),
                lora_scale=model.config.lora_scale)
    lg, cache = tllm.llm_apply(llm, cfg, inputs_embeds=e,
                               attention_mask=mask, positions=pos,
                               cache=cache, cache_index=0,
                               extra_layer_fn=extra, **lora)
    lg = [lg[0, -1:]]
    if how == "one_call" and n > 1:
        mask[0, Tb:Tb + n - 1] = 1
        step, _ = tllm.llm_apply(
            llm, cfg, input_ids=y[None, :-1], attention_mask=mask,
            positions=req.ctx_len + torch.arange(n - 1, device=dev)[None],
            cache=cache, cache_index=Tb, extra_layer_fn=extra, w8a8=False,
            **lora)
        lg.append(step[0])
    elif how != "one_call":
        # the step's inputs in place, so that from its second call the
        # layer loop replays as one CUDA graph (its ~1,000 small launches a
        # token at 32 layers are host-bound eagerly; the first call warms
        # up); ORCA's few rows stay eager
        tok = torch.zeros(1, 1, dtype=torch.long, device=dev)
        at = torch.zeros(1, 1, dtype=torch.long, device=dev)
        ci = torch.zeros((), dtype=torch.long, device=dev)
        graph = out = None

        def step():
            return tllm.llm_apply(
                llm, cfg, input_ids=tok, attention_mask=mask, positions=at,
                cache=cache, cache_index=ci, extra_layer_fn=extra,
                w8a8=False, **lora)[0][0]
        for t in range(n - 1):
            mask[0, Tb + t] = 1
            tok.copy_(y[None, t:t + 1])
            at.fill_(req.ctx_len + t)
            ci.fill_(Tb + t)
            if t == 1 and how == "loop" and req.inject is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = step()
            if graph is None:
                lg.append(step())
            else:
                graph.replay()
                lg.append(out.clone())
    if how == "loop" and fused() != before:
        raise AssertionError("the gate's reference ran a fused decode step")
    return torch.cat(lg).float(), y


def top_less(lg, y):
    """Per row of logits lg [n, V], its top logit less that of the id in y
    [n] (0 where the id is the argmax)."""
    return lg.max(-1).values - lg.gather(-1, y[:, None])[:, 0]


def reference_margins(model, req, ids):
    """The gate's margins for one request: ``top_less`` of its
    ``reference_logits``, numpy [n]."""
    return top_less(*reference_logits(model, req, ids)).cpu().numpy()


def engine_gate(tag: str, model, rows, others: bool = False) -> float:
    """The teacher-forced gate of an engine's greedy rows ``rows`` [(the
    queued request, its emitted ids)]: every emitted id is the reference
    forward's argmax at its own prefix (``reference_margins``, the layer
    loop) or within TOL_ENGINE_MARGIN of it;
    the margins are printed.  The control, each row's ids checked against
    the next row's prompt, must fail the gate.  With ``others`` the
    one-call and fused-step references (``reference_logits``) are read on
    the same rows and printed beside it, as information: their worst
    margins and their largest logit difference from the gate's reference.
    Returns the largest margin."""
    import torch
    worst, parted = 0.0, []
    other = {h: [0.0, 0.0] for h in (("one_call", "fused") if others
                                      else ())}
    with torch.no_grad():
        for req, ids in rows:
            lg, y = reference_logits(model, req, ids)
            m = top_less(lg, y).cpu().numpy()
            worst = max(worst, float(m.max()))
            parted += [round(float(v), 4) for v in m if v > 0]
            for h, w in other.items():
                lo, _ = reference_logits(model, req, ids, h)
                w[0] = max(w[0], float(top_less(lo, y).max()))
                w[1] = max(w[1], float((lo - lg).abs().max()))
        ctl = 0.0
        for (_, ia), (rb, ib) in zip(rows, rows[1:] + rows[:1]):
            n = min(len(ia), len(ib))
            ctl = max(ctl, float(reference_margins(model, rb, ia[:n]).max()))
    n_ids = sum(len(ids) for _, ids in rows)
    print(f"{tag}: teacher-forced gate over {len(rows)} greedy rows, {n_ids}"
          f" ids: {n_ids - len(parted)} the reference's argmax, the others at "
          f"margins {sorted(parted, reverse=True)[:24]} (worst {worst:.4f}, "
          f"tol {TOL_ENGINE_MARGIN}); control (each row's ids on the next "
          f"row's prompt) "
          f"{ctl:.4f}", flush=True)
    if other:
        print(f"{tag}: other references on the same rows (information, not "
              f"gated): " + "; ".join(
                  f"{h} worst margin {w[0]:.4f}, largest logit difference "
                  f"from the gate's reference {w[1]:.4f}"
                  for h, w in other.items()), flush=True)
    if worst > TOL_ENGINE_MARGIN:
        raise AssertionError(f"{tag}: an engine greedy id is {worst} below "
                             "the reference forward's argmax")
    if ctl <= TOL_ENGINE_MARGIN:
        raise AssertionError(f"{tag}: the gate passes another row's ids "
                             f"({ctl})")
    return worst


def require_engine_replays(tag: str, eng, counts, tower: str,
                           inject: bool = False) -> int:
    """The engine's decode ran as replays of its one graph: captured once,
    one ``decode_graph`` replay for each decode step but the first, the
    tower's launches (7 a layer a step; K8i's 5 more) those of every step,
    so none ran eagerly after the first; no torch path.  Returns the step
    count."""
    from desta25_audio_tpu_torch.ops import _build
    L = eng.cfg.num_hidden_layers
    steps = eng._n_plain_ticks * eng.steps_per_tick
    want = {"decode_graph": steps - 1, tower: 7 * L * steps}
    if inject:
        want["fused_decode_inject"] = 5 * L * steps
    got = {k: counts.get(k, 0) for k in want}
    if eng.graph.captures != 1 or got != want:
        raise AssertionError(f"{tag}: {eng.graph.captures} captures, "
                             f"launches {got} for {steps} steps ({want})")
    if _build.fallback_counts():
        raise AssertionError(f"{tag}: torch paths taken: "
                             f"{_build.fallback_counts()}")
    return steps


def check_finished(tag: str, model, info, rids, reasons=("eos", "length")):
    V = model.llm_cfg.vocab_size
    for rid in rids:
        r = info[rid]
        if (r["finish_reason"] not in reasons or not r["tokens"]
                or min(r["tokens"]) < 0 or max(r["tokens"]) >= V):
            raise AssertionError(f"{tag}: request {rid}: {r['finish_reason']}"
                                 f", {len(r['tokens'])} tokens")


def run_engine_bf16(model, wavs, gpu) -> None:
    """Phase 12f: the engine on the bf16 tower: 4 slots, K = 8, 4 greedy
    requests of 32 new tokens; K8 runs as the replays of one graph, and the
    gate holds."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rids, reqs = submit_all(eng, engine_convs(wavs, 4))
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    steps = require_engine_replays("bf16 engine", eng, counts,
                                   "fused_decode_layers")
    check_finished("bf16 engine", model, info, rids)
    print(f"bf16 engine ({gpu}): 4 requests in {eng._n_plain_ticks} ticks "
          f"({steps} steps, capture {eng.graph.capture_ms:.1f} ms), "
          f"{wall * 1e3:.1f} ms; launches {json.dumps(counts)}", flush=True)
    engine_gate("bf16 engine", model,
                [(reqs[r], info[r]["tokens"]) for r in rids])
    eng.close()
    # the engine turned on the model's feature cache (as the JAX engine
    # does); the phases after it count perception launches
    model.enable_audio_cache(0)


def run_engine(model, wavs, gpu) -> None:
    """Phases 16a-16g on the model's int8 encoder and int8 LLM."""
    import torch
    from desta25_audio_tpu_torch.bench_serving import serving_ticks
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    sampled = dict(temperature=0.7, top_p=0.9, do_sample=True)
    convs = engine_convs(wavs, 24, text_only=(6, 18))
    # -- 16a. 24 requests into 16 slots, half of them arriving mid-run -------
    eng, rids, reqs, info, wall, counts = arrival_run(model, convs, sampled)
    kcounts = _build.kernel_counts()
    steps = require_engine_replays("int8 engine", eng, counts,
                                   "fused_decode_layers_int8")
    if counts.get("fused_decode_layers", 0):
        raise AssertionError("int8 engine: the bf16 K8 was launched")
    check_finished("int8 engine", model, info, rids)
    greedy = [r for r in rids if not reqs[r].do_sample]
    ttft = np.asarray([eng.first_token_s[r] * 1e3 for r in rids])
    n_tok = sum(len(info[r]["tokens"]) for r in rids)
    print(f"int8 engine, 16 slots, K = 8, 24 requests (12 submit_many, 12 "
          f"while decoding, every other sampled 0.7 / 0.9, 2 text-only) "
          f"({gpu}): {eng._n_plain_ticks} ticks ({steps} steps, one capture "
          f"of {eng.graph.capture_ms:.1f} ms), {n_tok} tokens in "
          f"{wall * 1e3:.1f} ms = {n_tok / wall:.1f} tokens/s; time to the "
          f"first token p50 {np.percentile(ttft, 50):.1f} ms, p90 "
          f"{np.percentile(ttft, 90):.1f} ms (submit to first token, host "
          f"clock); finish reasons "
          f"{sorted(info[r]['finish_reason'] for r in rids)}; launches "
          f"{json.dumps(counts)}; kernels {json.dumps(kcounts)}", flush=True)
    engine_gate("int8 engine", model,
                [(reqs[r], info[r]["tokens"]) for r in greedy], others=True)
    eng.close()

    # -- 16b. equal trajectories within one engine configuration -------------
    eight = [c for i, c in enumerate(convs) if i % 2 == 0][:8]

    def trajectory(pipeline, k, many=True):
        e = ContinuousBatchingEngine(model, n_slots=16, max_ctx=256,
                                     max_new_tokens=24, ctx_bucket=64,
                                     steps_per_tick=k,
                                     pipeline_ticks=pipeline)
        ids, _ = submit_all(e, eight, many)
        e.run_until_done()
        out = e.results()
        if e.graph.captures != 1:
            raise AssertionError(f"engine {pipeline, k}: "
                                 f"{e.graph.captures} captures")
        e.close()
        return [out[r]["tokens"] for r in ids]

    base = trajectory(True, 8)
    runs = {"pipeline_ticks=False": trajectory(False, 8),
            "steps_per_tick=1": trajectory(True, 1),
            "submit": trajectory(True, 8, many=False)}
    for name, ids in runs.items():
        if ids != base:
            raise AssertionError(f"engine trajectories differ under {name}")
    print(f"int8 engine: 8 greedy requests x 24 tokens identical with "
          f"pipelining on / off, 8 / 1 steps a tick, submit_many / submit",
          flush=True)

    # -- 16c. slot reuse under pipelining, then a slot at the cache's end ----
    eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=256,
                                   max_new_tokens=64, ctx_bucket=64,
                                   steps_per_tick=8)
    rids, reqs = submit_all(eng, eight[:4])
    for _ in range(3):
        eng.step()
    victim = rids[1]
    slot = reqs[victim].slot
    if not eng.cancel(victim):
        raise AssertionError("engine: cancel of a running request failed")
    r, q = submit_all(eng, [eight[4]])
    rids += r
    reqs.update(q)
    eng.run_until_done()
    info = eng.results()
    kept = len(info[victim]["tokens"])
    if (info[victim]["finish_reason"] != "cancelled" or not 0 < kept < 64
            or reqs[r[0]].slot != slot):
        raise AssertionError(f"engine cancel: {info[victim]['finish_reason']}"
                             f", {kept} tokens, newcomer in slot "
                             f"{reqs[r[0]].slot} (freed {slot})")
    check_finished("engine slot reuse", model, info,
                   [x for x in rids if x != victim])
    engine_gate("engine slot reuse", model,
                [(reqs[x], info[x]["tokens"]) for x in rids if x != victim])
    r, q = submit_all(eng, [eight[5]])
    eng.step()
    eng.slot_pos[q[r[0]].slot] = eng.t_max - 3
    eng.step()
    info = eng.results()
    torch.cuda.synchronize()
    if info[r[0]]["finish_reason"] != "cache_full" or not info[r[0]][
            "truncated"]:
        raise AssertionError(f"engine: a slot at t_max - 3 ended "
                             f"{info[r[0]]['finish_reason']}")
    print(f"int8 engine slot reuse: the cancelled request kept {kept} "
          f"tokens, the newcomer took its slot {slot}; a slot forced to "
          f"t_max - 3 ended cache_full with {len(info[r[0]]['tokens'])} "
          f"tokens", flush=True)
    eng.close()

    # -- 16d. decode-only ticks with every slot busy --------------------------
    with torch.no_grad():
        plain_ticks = {b: serving_ticks(model.params["llm"], model.llm_cfg, b,
                                        gpu=gpu) for b in (8, 16, 32)}
    model.enable_audio_cache(0)
    # -- 16e. the spec engine at 4 and 16 slots -------------------------------
    t0 = time.perf_counter()
    run_engine_spec(model, wavs, gpu, plain_ticks)
    # -- 16f. the adaptive spec engine on 16a's arrivals ----------------------
    run_engine_adaptive(model, wavs, gpu)
    # -- 16g. HTTP on the int8 engine -----------------------------------------
    run_http(model, wavs, gpu)
    print(f"phases 16e-16g took {time.perf_counter() - t0:.1f} s", flush=True)


def run_engine_orca(orca, convs, gpu) -> None:
    """Phase 20d: the engine on the ORCA model with its int8 stack and int8
    LLM: 4 slots, 3 audio requests (one submit_many) and a text-only one
    (on = 0); K8i inside the graph's replays; the gate per row."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(orca, n_slots=4, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64)
    if eng._fspec is None:
        raise AssertionError("ORCA engine: the decode step does not inject "
                             "inside its kernels (K8i)")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rids, reqs = submit_all(eng, convs[:3])
    r, q = submit_all(eng, [[{"role": "user",
                              "content": "Name three rivers."}]])
    rids += r
    reqs.update(q)
    eng.step()
    on = {x.rid: float(eng.inject_on[s])
          for s, x in enumerate(eng.slot_req) if x is not None}
    if on != {rids[0]: 1.0, rids[1]: 1.0, rids[2]: 1.0, rids[3]: 0.0}:
        raise AssertionError(f"ORCA engine on flags {on}")
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    kcounts = _build.kernel_counts()
    steps = require_engine_replays("ORCA engine", eng, counts,
                                   "fused_decode_layers_int8", inject=True)
    L = eng.cfg.num_hidden_layers
    if kcounts.get("inject_attention", 0) != L * steps:
        raise AssertionError(f"ORCA engine: K8i kernels {kcounts}")
    check_finished("ORCA engine", orca, info, rids)
    print(f"ORCA engine (int8 stack, K8i; Ta {eng._inject_len} audio tokens "
          f"a slot, buffers padded to {eng.inject_k.shape[2]}) ({gpu}): 3 "
          f"audio + 1 text-only "
          f"requests, {eng._n_plain_ticks} ticks ({steps} steps, capture "
          f"{eng.graph.capture_ms:.1f} ms), {wall * 1e3:.1f} ms; launches "
          f"{json.dumps(counts)}", flush=True)
    engine_gate("ORCA engine", orca,
                [(reqs[x], info[x]["tokens"]) for x in rids])
    eng.close()


def require_spec_replays(tag: str, eng, counts, inject: bool = False) -> int:
    """A spec engine's steps ran as replays of its two kept graphs: each
    captured once if it took two steps or more, one ``decode_graph``
    replay for each of a graph's steps but its first, K8v's launches (7 a
    layer) those of every verify step and K8-int8's those of every plain
    step (K8i's 5 more on both with ``inject``), K8v at B = n_slots; no
    torch path.  Returns the verify steps."""
    from desta25_audio_tpu_torch.ops import _build
    L, K = eng.cfg.num_hidden_layers, eng.steps_per_tick
    vs, ps = eng._n_spec_ticks * K, eng._n_plain_ticks * K
    want = {"decode_graph": max(vs - 1, 0) + max(ps - 1, 0),
            "fused_verify_layers": 7 * L * vs,
            "fused_decode_layers_int8": 7 * L * ps}
    if inject:
        want["fused_decode_inject"] = 5 * L * (vs + ps)
    got = {k: counts.get(k, 0) for k in want}
    caps = (eng.graph.captures, eng.vgraph.captures)
    rows = tuple(eng.vgraph.stepper.x.shape[:2])
    if (got != want or caps != (int(ps >= 2), int(vs >= 2))
            or rows != (eng.n_slots, eng.speculative_k)):
        raise AssertionError(f"{tag}: captures {caps}, verify rows {rows}, "
                             f"launches {got} for {vs} verify and {ps} plain "
                             f"steps ({want})")
    if _build.fallback_counts():
        raise AssertionError(f"{tag}: torch paths taken: "
                             f"{_build.fallback_counts()}")
    return vs


def accept_spy(eng):
    """Wrap the engine's spec-tick consume: the accepted counts of every
    verify step of every live row (m > 0) land in the list returned."""
    seen = []
    consume = eng._consume_spec_tick
    B, Kd = eng.n_slots, eng.speculative_k

    def spy(slot_reqs, outs, write_pos):
        ms = outs.numpy()[:, B * Kd:]
        live = {s for s, r in slot_reqs if not r.done}
        seen.extend(int(m) for row in ms for s, m in enumerate(row)
                    if s in live and m > 0)
        return consume(slot_reqs, outs, write_pos)

    eng._consume_spec_tick = spy
    return seen


def drive(eng, convs, **kw):
    """Submit ``convs`` in one submit_many, run the engine dry: (ids,
    {rid: queued request}, results, wall s, launch counts, ms a tick: the
    median host time of the steps after the first, which admitted)."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rids, reqs = submit_all(eng, convs, **kw)
    durs = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        t1 = time.perf_counter()
        eng.step()
        durs.append(time.perf_counter() - t1)
    info = eng.results()
    torch.cuda.synchronize()
    return (rids, reqs, info, time.perf_counter() - t0,
            _build.launch_counts(), float(np.median(durs[1:] or durs)) * 1e3)


def oracle_drafter(eng, want):
    """A drafter for ``eng`` that proposes, for a row whose request has
    generated a prefix of ``want[rid]``, the next ids of it (one host read
    of the histories a verify step; elsewhere the n-gram drafts)."""
    import torch
    from desta25_audio_tpu_torch.generate.speculative import ngram_propose

    def propose(hist, hlen, k):
        out = ngram_propose(hist, hlen, k).cpu()
        h, n = hist.cpu(), hlen.cpu()
        for b, req in enumerate(eng.slot_req):
            if req is None or req.rid not in want:
                continue
            s = len(req.prompt_ids)
            gen_ids = h[b, s:int(n[b])].tolist()
            ids = want[req.rid]
            if gen_ids == ids[:len(gen_ids)]:
                nxt = (ids + [ids[-1]] * k)[len(gen_ids):len(gen_ids) + k]
                out[b] = torch.tensor(nxt)
        return out.to(hist.device)

    return propose


def run_engine_spec(model, wavs, gpu, plain_ticks) -> None:
    """Phases 16e-16f on the model's int8 encoder and LLM; ``plain_ticks``:
    16d's readings by slot count."""
    import torch
    from unittest import mock
    from desta25_audio_tpu_torch.bench_serving import (serving_ticks,
                                                       spec_ticks)
    from desta25_audio_tpu_torch.serve import engine as tengine
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    convs = engine_convs(wavs, 16, text_only=(6,))
    args = dict(max_ctx=256, max_new_tokens=32, ctx_bucket=64,
                steps_per_tick=8)
    # -- 16e. the spec engine at 4 and 16 slots, every tick speculative ------
    for B in (4, 16):
        plain = ContinuousBatchingEngine(model, n_slots=B, **args)
        p_rids, _, p_info, p_wall, _, p_ms = drive(plain, convs[:B])
        plain.close()
        eng = ContinuousBatchingEngine(model, n_slots=B, speculative_k=4,
                                       adaptive_spec=False, **args)
        if eng.speculative_k != 4:
            raise AssertionError(f"spec engine b{B}: not eligible")
        seen = accept_spy(eng)
        rids, reqs, info, wall, counts, ms = drive(eng, convs[:B])
        vs = require_spec_replays(f"spec engine b{B}", eng, counts)
        check_finished(f"spec engine b{B}", model, info, rids)
        n_tok = sum(len(info[r]["tokens"]) for r in rids)
        p_tok = sum(len(p_info[r]["tokens"]) for r in p_rids)
        same = sum(info[a]["tokens"] == p_info[b]["tokens"]
                   for a, b in zip(rids, p_rids))
        print(f"spec engine b{B}, Kd = 4, K = 8 ({gpu}): {B} requests of "
              f"32 tokens in {eng._n_spec_ticks} spec ticks ({vs} verify "
              f"steps, one capture of {eng.vgraph.capture_ms:.1f} ms), "
              f"{ms:.2f} ms a tick (the median step() after the first), "
              f"{np.mean(seen):.3f} tokens a verify step of a live row, "
              f"{n_tok / wall:.1f} tokens/s over the whole run; the plain "
              f"engine {plain._n_plain_ticks} ticks, {p_ms:.2f} ms a tick, "
              f"{p_tok / p_wall:.1f} tokens/s; rows equal to the plain "
              f"engine's {same} of {B} (information); launches "
              f"{json.dumps(counts)}", flush=True)
        engine_gate(f"spec engine b{B}", model,
                    [(reqs[r], info[r]["tokens"]) for r in rids])
        eng.close()
        if B == 4:
            # an oracle drafter: the plain engine's own ids (a fresh engine
            # numbers its requests from 0 as the plain one did); a row's
            # drafts stop matching where its verify step's argmax parts
            # from the plain step's at a near-tie (the draft positions
            # attend each other through the f32 draft block)
            want = {r: p_info[r]["tokens"] for r in p_rids}
            eng = ContinuousBatchingEngine(model, n_slots=B, speculative_k=4,
                                           adaptive_spec=False, **args)
            seen = accept_spy(eng)
            with mock.patch.object(tengine, "ngram_propose",
                                   oracle_drafter(eng, want)):
                o_rids, o_reqs, o_info, _, _, _ = drive(eng, convs[:B])
            lead = [next((i for i, (a, c) in enumerate(zip(
                o_info[r]["tokens"], want[r])) if a != c), len(want[r]))
                for r in o_rids]
            multi = sum(m > 1 for m in seen)
            print(f"spec engine b4, oracle drafts ({gpu}): {multi} verify "
                  f"steps of a live row accepted 2-4 tokens (max "
                  f"{max(seen)}; mean {np.mean(seen):.3f} over "
                  f"{len(seen)}), {eng._n_spec_ticks} ticks; each row's ids "
                  f"equal to the plain engine's for its first {lead} of 32",
                  flush=True)
            if max(seen) != 4 or multi < 4:
                raise AssertionError(f"spec engine oracle: accepted {seen}")
            engine_gate("spec engine b4 oracle", model,
                        [(o_reqs[r], o_info[r]["tokens"]) for r in o_rids])
            eng.close()
        # the ticks alone: the spec tick beside the plain one
        with torch.no_grad():
            pl = plain_ticks.get(B) or serving_ticks(
                model.params["llm"], model.llm_cfg, B, gpu=gpu)
            spec_ticks(model.params["llm"], model.llm_cfg, B, 4, gpu=gpu,
                       plain=pl)
    model.enable_audio_cache(0)


def arrival_run(model, convs, sampled, **kw):
    """16a's arrival run: 24 requests into 16 slots (12 through one
    submit_many, every other one sampled, then 12 while the first decode).
    Returns (engine, ids, {rid: request}, results, wall s, launch
    counts)."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, n_slots=16, max_ctx=256,
                                   max_new_tokens=64, ctx_bucket=64,
                                   steps_per_tick=8, **kw)
    if eng.t_max != 384:
        raise AssertionError(f"engine t_max {eng.t_max}")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rids, reqs = submit_all(eng, convs[:12])
    for i, rid in enumerate(rids):
        if i % 2:   # every other request sampled (one submit_many: set here)
            for k, v in sampled.items():
                setattr(reqs[rid], k, v)
    eng.step()
    eng.step()
    for j, conv in enumerate(convs[12:]):
        r, q = submit_all(eng, [conv], **(sampled if j % 2 else {}))
        rids += r
        reqs.update(q)
        if j % 2:
            eng.step()
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    return (eng, rids, reqs, info, time.perf_counter() - t0,
            _build.launch_counts())


def run_engine_adaptive(model, wavs, gpu) -> None:
    """Phase 16f: 16a's arrival run on an adaptive spec engine (the
    defaults, ``speculative_k=4``)."""
    sampled = dict(temperature=0.7, top_p=0.9, do_sample=True)
    convs = engine_convs(wavs, 24, text_only=(6, 18))
    eng, rids, reqs, info, wall, counts = arrival_run(model, convs, sampled,
                                                      speculative_k=4)
    if not eng.adaptive_spec or eng.speculative_k != 4:
        raise AssertionError("adaptive engine: speculation refused")
    require_spec_replays("adaptive engine", eng, counts)
    check_finished("adaptive engine", model, info, rids)
    n_tok = sum(len(info[r]["tokens"]) for r in rids)
    ema = {k: (None if v is None else round(v * 1e3, 3))
           for k, v in eng._dur_ema.items()}
    print(f"adaptive engine, 16 slots, Kd = 4, 16a's 24 arrivals ({gpu}): "
          f"{eng._n_spec_ticks} spec and {eng._n_plain_ticks} plain ticks, "
          f"tick durations (ms, the controller's EMAs) {ema}, probe "
          f"backoff {eng._reprobe_backoff}, live {eng._spec_live}; "
          f"{n_tok} tokens in {wall * 1e3:.1f} ms = {n_tok / wall:.1f} "
          f"tokens/s; launches {json.dumps(counts)}", flush=True)
    engine_gate("adaptive engine", model,
                [(reqs[r], info[r]["tokens"]) for r in rids
                 if not reqs[r].do_sample])
    eng.close()
    model.enable_audio_cache(0)


def http_json(port, method, path, obj=None, timeout=300):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if obj is None else json.dumps(obj),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def sse_events(port, path, obj, t0, first):
    """POST ``obj`` and read its event stream: the events, with the host
    seconds from ``t0`` to the first event that carries a token stored in
    ``first``."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, body=json.dumps(obj),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"HTTP {path}: {resp.status}")
    events = []
    while True:
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        ev = line[len("data: "):]
        if ev == "[DONE]":
            events.append(ev)
            break
        ev = json.loads(ev)
        events.append(ev)
        carries = ("token" in ev or ev.get("choices", [{}])[0].get(
            "delta", {}).get("content"))
        if carries and not first:
            first.append(time.perf_counter() - t0)
        if ev.get("done"):
            break
    while line and line.strip() != "0":   # the chunked body's last chunk
        line = resp.fp.readline().decode()
    resp.fp.readline()
    conn.close()
    return events


def run_http(model, wavs, gpu) -> None:
    """Phase 16g: the HTTP front end on the int8 engine (8 slots, K = 8):
    8 concurrent clients, two of them streaming, on /v1/generate and
    /v1/chat/completions with inline base64 WAVs, then health and a
    cancel; every greedy answer through the gate."""
    import base64
    import threading
    import torch
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    from desta25_audio_tpu_torch.serve.http import start_http
    eng = ContinuousBatchingEngine(model, n_slots=8, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64,
                                   steps_per_tick=8)
    queued = {}
    submit_many = eng.submit_many

    def record(messages_list, **kw):
        n0 = len(eng.queue)
        out = submit_many(messages_list, **kw)
        queued.update({r.rid: r for r in eng.queue[n0:]})
        return out

    eng.submit_many = record
    httpd, es = start_http(eng, port=0)
    port = httpd.server_address[1]
    convs = engine_convs(wavs, 8)
    results, firsts, done_s, errors = {}, {}, {}, []

    def b64(path):
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    def client(i):
        try:
            conv = convs[i]
            stream = i < 2
            t0 = time.perf_counter()
            if i % 2 == 0:
                msgs = [{**m, "audios": [{"audio_b64": b64(a["audio"]),
                                          "text": a["text"]}
                                         for a in m["audios"]]}
                        if m.get("audios") else m for m in conv]
                req = {"messages": msgs, "max_new_tokens": 32,
                       "stream": stream}
                path = "/v1/generate"
            else:
                parts = [{"type": "text", "text": conv[-1]["content"]
                          .replace("<|AUDIO|>", "")}]
                parts += [{"type": "input_audio", "input_audio": {
                    "data": b64(a["audio"]), "format": "wav",
                    "transcription": a["text"]}}
                    for a in conv[-1].get("audios", [])]
                req = {"messages": [{"role": "user", "content": parts}],
                       "max_tokens": 32, "temperature": 0, "stream": stream}
                path = "/v1/chat/completions"
            if stream:
                first = []
                results[i] = sse_events(port, path, req, t0, first)
                firsts[i] = first[0]
            else:
                status, body = http_json(port, "POST", path, req)
                if status != 200:
                    raise AssertionError(f"client {i}: HTTP {status}")
                results[i] = body
            done_s[i] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 (raised below, in order)
            errors.append((i, e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    status, health = http_json(port, "GET", "/v1/health")
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"HTTP clients failed: {errors}")
    if status != 200 or health["status"] != "ok" or health["slots"] != 8:
        raise AssertionError(f"HTTP health: {status} {health}")
    # a cancel: a streaming request cancelled by its id once its first
    # token has streamed (31 more, about 4 ticks, are to come)
    holder, started = {}, []
    th = threading.Thread(target=lambda: holder.update(events=sse_events(
        port, "/v1/generate", {"messages": convs[0], "max_new_tokens": 32,
                               "stream": True}, time.perf_counter(),
        started)))
    th.start()
    while not started and th.is_alive():
        time.sleep(0.001)
    rid = max(queued)
    status, c = http_json(port, "DELETE", f"/v1/requests/{rid}")
    th.join()
    last = holder["events"][-1]
    if status != 200 or not c["cancelled"] or last.get(
            "finish_reason") != "cancelled":
        raise AssertionError(f"HTTP cancel: {status} {c} {last}")
    info = {r: es.result_now(r) for r in queued}
    httpd.shutdown()
    es.close()
    torch.cuda.synchronize()
    # every answer is its engine result; the streamed ids and text too
    by_text = {}
    for r, inf in info.items():
        by_text.setdefault(inf["text"], []).append(r)
    for i in range(8):
        res = results[i]
        if i < 2:
            text = (res[-1]["text"] if i == 0 else "".join(
                e["choices"][0]["delta"].get("content", "")
                for e in res[:-1]))
        else:
            text = (res["text"] if i % 2 == 0
                    else res["choices"][0]["message"]["content"])
        if text not in by_text:
            raise AssertionError(f"HTTP client {i}: an answer no request "
                                 f"of the engine gave: {text!r}")
    rows = [(queued[r], info[r]["tokens"]) for r in sorted(queued)
            if r != rid]
    ft = np.asarray(list(firsts.values())) * 1e3
    dn = np.asarray(list(done_s.values())) * 1e3
    print(f"HTTP, int8 engine, 8 slots ({gpu}): 8 concurrent clients (4 "
          f"/v1/generate, 4 /v1/chat/completions, 2 streaming, inline WAV) in"
          f" {wall * 1e3:.1f} ms, {eng._n_plain_ticks} ticks; time to the "
          f"first SSE token event p50 {np.percentile(ft, 50):.1f} ms, p90 "
          f"{np.percentile(ft, 90):.1f} ms; a client's whole answer p50 "
          f"{np.percentile(dn, 50):.1f} ms, p90 {np.percentile(dn, 90):.1f} "
          f"ms (host clock); health {health}; request {rid} cancelled with "
          f"{len(info[rid]['tokens'])} tokens", flush=True)
    engine_gate("HTTP engine", model, rows)
    eng.close()
    model.enable_audio_cache(0)


def http_rounds(gpu: str, n: int) -> None:
    """``--http-rounds``: phase 16g ``n`` times on the flagship model
    with its int8 encoder and LLM, each round under a 120 s watchdog that
    dumps every thread's stack and exits."""
    import faulthandler
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.models.desta import _CharASR
    model = DeSTA25AudioModel(config_from_yaml_file(CONFIG), device="cuda",
                              seed=0, tokenizer=CharTokenizer("llama3"))
    model._whisper_tokenizer = _CharASR()
    model.apply_inference_encoder_quant()
    model.apply_llm_quant()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        wavs = write_wavs(d)[0]
        for i in range(n):
            faulthandler.dump_traceback_later(120, exit=True)
            t0 = time.perf_counter()
            run_http(model, wavs, gpu)
            faulthandler.cancel_dump_traceback_later()
            print(f"HTTP round {i}: {time.perf_counter() - t0:.1f} s",
                  flush=True)


def run_engine_orca_spec(orca, convs, gpu) -> None:
    """Phase 20e: the spec engine on the ORCA model (int8 stack and LLM):
    4 slots, ``speculative_k=4``, every tick speculative, 3 audio requests
    and a text-only one: K8i inside the verify graph's replays, the gate
    per row."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(orca, n_slots=4, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64,
                                   speculative_k=4, adaptive_spec=False)
    if eng._fspec is None or eng.speculative_k != 4:
        raise AssertionError("ORCA spec engine: no K8i in the verify step")
    seen = accept_spy(eng)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    # ORCA's audio requests go in one submit_many, the text-only apart
    rids, reqs = submit_all(eng, convs[:3])
    r, q = submit_all(eng, [[{"role": "user",
                              "content": "Name three rivers."}]])
    rids += r
    reqs.update(q)
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    kcounts = _build.kernel_counts()
    vs = require_spec_replays("ORCA spec engine", eng, counts, inject=True)
    L = eng.cfg.num_hidden_layers
    if kcounts.get("inject_attention", 0) != L * vs:
        raise AssertionError(f"ORCA spec engine: K8i kernels {kcounts}")
    check_finished("ORCA spec engine", orca, info, rids)
    print(f"ORCA spec engine (int8 stack, K8v + K8i; Kd = 4) ({gpu}): 3 "
          f"audio + 1 text-only requests, {eng._n_spec_ticks} spec ticks "
          f"({vs} verify steps, capture {eng.vgraph.capture_ms:.1f} ms), "
          f"{wall * 1e3:.1f} ms, {np.mean(seen):.3f} tokens a verify step "
          f"of a live row; launches {json.dumps(counts)}", flush=True)
    engine_gate("ORCA spec engine", orca,
                [(reqs[x], info[x]["tokens"]) for x in rids])
    eng.close()
    orca.enable_audio_cache(0)


def run_mesh_engine(model, convs, gpu, mesh, tag: str):
    """Phase 20f, under ``use_mesh(mesh)`` with the model's LLM cut for it:
    the engine (4 slots, K = 8, 4 greedy requests of 32 tokens), plain
    ticks, then ``speculative_k=4`` with every tick speculative: one graph
    a card for each kind, captured once; K10 and ``tp_allreduce`` launch
    (the verify step's ``fused_verify_layers_mesh`` with speculation), the
    unsharded kernels do not; the all-reduce's error words read once a
    tick.  Returns [(rows for the gate, engine ms a tick)] of both runs
    (the gate runs on the unsharded LLM, after the mesh)."""
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    n_cards = len({d for row in mesh.devices for d in row})
    out = []
    for kw in ({}, {"speculative_k": 4, "adaptive_spec": False}):
        eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=256,
                                       max_new_tokens=32, ctx_bucket=64,
                                       **kw)
        reads = []
        check = eng._check_error_words
        eng._check_error_words = lambda errs: (reads.append(len(errs)),
                                               check(errs))
        rids, reqs, info, wall, counts, ms = drive(eng, convs[:4])
        spec = bool(kw)
        name = "fused_verify_layers_mesh" if spec else \
            "fused_decode_layers_mesh"
        g = eng.vgraph if spec else eng.graph
        steps = (eng._n_spec_ticks if spec else eng._n_plain_ticks) * \
            eng.steps_per_tick
        ticks = eng._n_spec_ticks + eng._n_plain_ticks
        if (counts.get(name, 0) <= 0 or counts.get("tp_allreduce", 0) <= 0
                or counts.get("fused_decode_layers_int8", 0)
                or counts.get("fused_verify_layers", 0)
                or g.captures != 1
                or counts.get("decode_graph", 0) != n_cards * (steps - 1)
                or len(reads) != ticks or min(reads) <= 0):
            raise AssertionError(f"{tag} engine {kw}: captures {g.captures},"
                                 f" error-word reads {reads} for {ticks} "
                                 f"ticks, launches {counts}")
        check_finished(f"{tag} engine", model, info, rids)
        print(f"{tag} engine {kw or 'plain'} ({gpu}): {ticks} ticks "
              f"({steps} steps, one graph a card, capture "
              f"{g.capture_ms:.1f} ms), {ms:.2f} ms a tick (the median "
              f"step() after the first), error words read {len(reads)} "
              f"times; launches {json.dumps(counts)}", flush=True)
        out.append(([(reqs[r], info[r]["tokens"]) for r in rids], ms))
        eng.close()
    model.enable_audio_cache(0)
    return out


def gate_mesh_engine(model, convs, gpu, runs, tag: str) -> None:
    """Phase 20f's gate, on the unsharded LLM: the mesh engines' greedy rows
    through the teacher-forced gate, beside the one-card engine's run of
    the same requests (its ms a tick; rows equal, information)."""
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64)
    rids, _, info, _, _, ms = drive(eng, convs[:4])
    ref = [info[r]["tokens"] for r in rids]
    eng.close()
    model.enable_audio_cache(0)
    for kind, (rows, tick_ms) in zip(("plain", "spec"), runs):
        same = sum(ids == r for (_, ids), r in zip(rows, ref))
        print(f"{tag} engine, {kind} ticks ({gpu}): {tick_ms:.2f} ms a tick "
              f"against the one-card engine's {ms:.2f}; rows equal to the "
              f"one-card engine's {same} of 4 (information)", flush=True)
        engine_gate(f"{tag} engine ({kind})", model, rows)


# -- 27. int8 weight scales quantized on the card against the CPU -----------

def check_quant_on_card(gen) -> None:
    """Phase 27: ``ckpt/synthetic.quantize_card_vs_cpu``, bit for bit, on
    one Llama-3.1-8B layer and the head; raises on any differing scale or
    q."""
    from desta25_audio_tpu_torch.ckpt.synthetic import quantize_card_vs_cpu
    r = quantize_card_vs_cpu(gen)
    print(f"27. quantize_weight on 4096 chosen rows: {r['scales']} scales "
          f"and {r['q_rows']} rows of q differ card vs CPU", flush=True)
    print(f"27. quantize_llm_params, 1 meta-llama/Llama-3.1-8B-Instruct "
          f"layer(s) and the head ({r['weights'] / 1e9:.3f} B weights): "
          f"{r['leaves']} leaves differ card vs CPU (card {r['card_s']:.2f} "
          f"s, CPU {r['cpu_s']:.2f} s)", flush=True)
    if r["scales"] or r["q_rows"] or r["leaves"]:
        raise AssertionError("int8 quantization on the card differs from "
                             "the CPU's")


# -- 28-29. checkpoints: staging and from_pretrained at full size ------------

QWEN_CONFIG = "configs/desta25_qwen3-0.6b_Qformer6L.yaml"
QWEN_ORCA_CONFIG = "configs/desta25_qwen3-0.6b_ORCAHybrid.yaml"


@contextlib.contextmanager
def char_tokenizers(template: str):
    """The entry points build their tokenizer from the model id (HF
    ``AutoTokenizer``); the repo holds no BPE files and the script needs no
    ``transformers``, so for the CLI runs the hub-free CharTokenizer of
    ``template`` stands in."""
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.models import desta as tdesta
    real = tdesta.build_tokenizer
    tdesta.build_tokenizer = lambda *a, **k: CharTokenizer(template)
    try:
        yield
    finally:
        tdesta.build_tokenizer = real


def card_maker(gen):
    """``make(shape, kind)`` for ``fill_state``: N(0, 0.02) weights and
    biases, 1 + N(0, 0.02) norm scales, drawn on the card from ``gen``."""
    import torch

    def make(dtype):
        def f(shape, kind):
            x = torch.randn(*shape, generator=gen, device="cuda") * 0.02
            return (x + 1.0 if kind == "n" else x).to(dtype)
        return f
    return make


def host_run(cmd, label: str) -> float:
    """``cmd`` in a subprocess on the host CPU; its last line of output and
    wall time printed; the wall time in seconds.  Raises on a failure."""
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    print(f"  {label}: {last} ({secs:.1f} s)", flush=True)
    if out.returncode:
        raise AssertionError(f"{label} failed ({out.returncode}):\n"
                             f"{out.stderr[-3000:]}")
    return secs


def stage(src: str, root: str, *extra) -> float:
    """``python -m desta25_audio_tpu_torch.ckpt.hf_convert SRC ROOT ...``, the
    CLI as a user runs it."""
    return host_run([sys.executable, "-m",
                     "desta25_audio_tpu_torch.ckpt.hf_convert", src, root,
                     *extra],
                    f"stage {os.path.basename(src)} {' '.join(extra)}")


def stage_int8_only(src: str, root: str, model_id: str) -> float:
    """The flagship's staging: ``hf_convert.stage_int8``, the int8 half of
    the CLI's ``--int8`` staging alone, without its 16 GB bf16 file (it
    would take the script's disk writes past 45 GiB: the flagship's
    snapshot and int8 file are 24.6 GB of them)."""
    return host_run([sys.executable, "-c",
                     "import sys; from desta25_audio_tpu_torch.ckpt."
                     "hf_convert import stage_int8; stage_int8(*sys.argv[1:])",
                     src, root, model_id],
                    f"stage {os.path.basename(src)} --int8 (the int8 file "
                    "only)")


def read_rate(files) -> float:
    """GB/s of reading ``files``' tensors alone onto the card through the
    port's codec (the page cache warm, as the load found it)."""
    import torch
    from desta25_audio_tpu_torch.ckpt.flat_io import SafetensorsState
    sd = SafetensorsState(files, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in sd:
        t = sd[k]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del t
    n = sd.nbytes()
    sd.close()
    return n / secs / 1e9


def tower_files(root: str, cfg, quant: str):
    """The files a load under ``root`` reads (as ``load_frozen_tower``
    picks them)."""
    from desta25_audio_tpu_torch.ckpt.flat_io import shard_files
    from desta25_audio_tpu_torch.ckpt.hf_convert import (
        STAGED,
        STAGED_INT8,
        STAGED_NAMES,
    )
    files = []
    for mid, tower in ((cfg.encoder_model_id, "whisper"),
                       (cfg.llm_model_id, "llm")):
        d = os.path.join(root, mid)
        for name in ((STAGED_INT8, STAGED) if tower == "llm"
                     and quant == "int8" else (STAGED,)):
            if os.path.exists(os.path.join(d, name)):
                files.append(os.path.join(d, name))
                break
        else:
            files += shard_files(d, exclude=STAGED_NAMES)
    return files


def timed_load(label: str, ck: str, root: str, gpu: str, template: str,
               msgs, **over):
    """``from_pretrained(ck, "cuda", weights_root=root)``; prints the
    load's wall time, the bytes of the files it read and their
    read rate alone, its peak device memory above what was resident, and
    the time to the first token after it (a 1-token ``generate()`` of
    ``msgs``)."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = DeSTA25AudioModel.from_pretrained(
        ck, "cuda", weights_root=root, tokenizer=CharTokenizer(template),
        config_overrides=over or None)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    t0 = time.perf_counter()
    m.generate(msgs, do_sample=False, max_new_tokens=1)
    torch.cuda.synchronize()
    ttft = (time.perf_counter() - t0) * 1e3
    files = tower_files(root, m.config, m.config.llm_quant)
    nbytes = sum(os.path.getsize(f) for f in files)
    rate = read_rate(files)
    print(f"  load [{label}]: {load_s:.2f} s for {nbytes / 1e9:.3f} GB of "
          f"files (those bytes alone onto the card: {rate:.2f} GB/s, page "
          f"cache warm), peak device memory of the load {peak:.2f} GiB above "
          f"the resident {base / 2**30:.2f} GiB, first token {ttft:.1f} ms "
          f"after the load ({gpu})", flush=True)
    return m


def check_loaded(tag: str, m, want, msgs, want_out, gpu: str, launch=()):
    """A model from ``from_pretrained``: its params bit-identical to
    ``want``'s and its greedy ids those of ``want_out``; the kernels in
    ``launch`` launched; the torch paths taken printed."""
    import torch
    from desta25_audio_tpu_torch.ckpt.synthetic import count_differing
    from desta25_audio_tpu_torch.ops import _build
    bad = count_differing(m.params, want.params)
    _build.reset_launch_counts()
    out = m.generate(msgs, do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    counts, taken = _build.launch_counts(), _build.fallback_counts()
    t = m.last_timings
    print(f"  {tag}: {bad} leaves differ from the in-memory model; ids "
          f"{'equal' if out.generated_ids == want_out.generated_ids else 'DIFFER'}"
          f" (row0[:8] {out.generated_ids[0][:8]}); decode "
          f"{t['decode_ms'] / max(t['decode_steps'], 1):.3f} ms/step over "
          f"{t['decode_steps']} steps, prefill {t['prefill_ms']:.1f} ms "
          f"({gpu}); launches {json.dumps(counts)}; torch paths taken "
          f"{json.dumps(taken)}", flush=True)
    if bad or out.generated_ids != want_out.generated_ids:
        raise AssertionError(f"{tag}: the loaded model is not the one "
                             "whose weights were written")
    for name in launch:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{tag}: {name} did not launch")
    return counts


def run_cli_generate(ck: str, root: str, wav: str, want) -> None:
    """``cli.generate`` on the card (``$DESTA_TPU_WEIGHTS`` = the staged
    root): its JSON ids are ``want``'s."""
    import io
    from desta25_audio_tpu_torch.cli import generate as cli_generate
    buf = io.StringIO()
    os.environ["DESTA_TPU_WEIGHTS"] = root
    try:
        t0 = time.perf_counter()
        with char_tokenizers("qwen3"), contextlib.redirect_stdout(buf):
            cli_generate.main(["--model", ck, "--audio", wav,
                               "--transcription", "a test tone",
                               "--prompt", "What do you hear?",
                               "--max-new-tokens", "32", "--json"])
        secs = time.perf_counter() - t0
    finally:
        del os.environ["DESTA_TPU_WEIGHTS"]
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"28e. cli.generate --json on the card: {secs:.1f} s with the load;"
          f" ids row0[:8] {out['generated_ids'][0][:8]}, "
          f"{'equal to' if out['generated_ids'] == want.generated_ids else 'DIFFERENT from'}"
          f" from_pretrained + generate()", flush=True)
    if out["generated_ids"] != want.generated_ids:
        raise AssertionError("cli.generate's ids differ")


def run_cli_serve(ck: str, root: str) -> None:
    """``cli.serve`` on the card with ``serve_http`` swapped for the
    non-blocking ``start_http`` on an ephemeral port: one
    /v1/chat/completions request, then the server and the engine shut."""
    from desta25_audio_tpu_torch.cli import serve as cli_serve
    from desta25_audio_tpu_torch.serve import http as http_mod
    started = {}

    def serve(engine, host, port):
        started["httpd"], started["es"] = http_mod.start_http(engine, host, 0)

    real = http_mod.serve_http
    http_mod.serve_http = serve
    os.environ["DESTA_TPU_WEIGHTS"] = root
    try:
        with char_tokenizers("qwen3"):
            cli_serve.main(["--model", ck, "--slots", "2", "--max-ctx",
                            "256", "--max-new-tokens", "16"])
    finally:
        http_mod.serve_http = real
        del os.environ["DESTA_TPU_WEIGHTS"]
    httpd, es = started["httpd"], started["es"]
    try:
        t0 = time.perf_counter()
        status, body = http_json(httpd.server_address[1], "POST",
                                 "/v1/chat/completions", {
                                     "messages": [{"role": "user",
                                                   "content": "Say hello."}],
                                     "max_tokens": 16})
        secs = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        es.close()
    print(f"28f. cli.serve on the card: /v1/chat/completions -> {status} in "
          f"{secs * 1e3:.0f} ms, {body.get('usage')}", flush=True)
    if status != 200 or not isinstance(
            body["choices"][0]["message"]["content"], str):
        raise AssertionError(f"cli.serve: {status} {body}")


def run_checkpoints_qwen3(gpu: str, work: str, wavs) -> None:
    """Phase 28: Qwen3-0.6B whole and full size, from disk."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.ckpt.hf_convert import (
        STAGED,
        convert_llm_state,
        convert_whisper_state,
    )
    from desta25_audio_tpu_torch.ckpt.synthetic import (
        fill_state,
        hf_llm_shapes,
        hf_whisper_shapes,
        write_snapshot,
    )
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.ops import _build
    cfg = config_from_yaml_file(QWEN_CONFIG)
    ecfg, lcfg = cfg.encoder_config, cfg.llm_config
    raw, staged = os.path.join(work, "raw"), os.path.join(work, "staged")
    make = card_maker(torch.Generator("cuda").manual_seed(28))
    # -- 28a. a seeded HF-layout snapshot, written by the port's codec -----
    t0 = time.perf_counter()
    sw = fill_state(hf_whisper_shapes(ecfg), make(torch.float16))
    sl = fill_state(hf_llm_shapes(lcfg), make(torch.bfloat16))
    nw = write_snapshot(os.path.join(raw, ecfg.model_id), "whisper", ecfg,
                        sw, shards=2)
    nl = write_snapshot(os.path.join(raw, lcfg.model_id), "llm", lcfg, sl)
    print(f"28a. HF snapshot written: {ecfg.model_id} f16 {nw / 1e9:.3f} GB "
          f"({sum(t.numel() for t in sw.values()) / 1e9:.3f} B params, 2 "
          f"shards), {lcfg.model_id} bf16 {nl / 1e9:.3f} GB "
          f"({sum(t.numel() for t in sl.values()) / 1e9:.3f} B params, tied)"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    # -- 28b. staged through the CLI, plain and --int8 ----------------------
    stage(os.path.join(raw, ecfg.model_id), staged)
    stage(os.path.join(raw, lcfg.model_id), staged, "--int8")
    # -- 28c. the in-memory model whose weights were written ----------------
    tok = CharTokenizer("qwen3")
    with torch.no_grad():
        mem = DeSTA25AudioModel(cfg, "cuda", seed=0, tokenizer=tok)
        mem.params["whisper"] = convert_whisper_state(sw, ecfg, mem.dtype,
                                                      "cuda")
        mem.params["llm"] = convert_llm_state(sl, lcfg, mem.dtype, "cuda")
        mem.apply_inference_encoder_quant()
    del sw, sl
    ck = os.path.join(work, "ck_qwen3_qformer")
    mem.save_pretrained(ck)
    msgs = conversations(wavs)[:2]
    _build.reset_launch_counts()
    want = mem.generate(msgs, do_sample=False, max_new_tokens=32)
    print(f"28c. in-memory {QWEN_CONFIG} (int8 encoder, bf16 LLM): ids "
          f"row0[:8] {want.generated_ids[0][:8]}; torch paths taken "
          f"{json.dumps(_build.fallback_counts())}", flush=True)
    # -- 28d. from_pretrained: raw shards, staged bf16, then int8 ----------
    for label, root in (("Q-Former, raw shards", raw),
                        ("Q-Former, staged bf16", staged)):
        m = timed_load(label, ck, root, gpu, "qwen3", msgs)
        check_loaded(label, m, mem, msgs, want, gpu,
                     launch=("fused_decode_layers", "log_mel"))
        del m
    # 28e: cli.generate, compared with the bf16 in-memory model
    one = [{"role": "user", "content": "What do you hear? <|AUDIO|>",
            "audios": [{"audio": wavs[0], "text": "a test tone"}]}]
    run_cli_generate(ck, staged, wavs[0], mem.generate(
        one, do_sample=False, max_new_tokens=32))
    run_cli_serve(ck, staged)
    with torch.no_grad():
        mem.apply_llm_quant()             # on the card
    want8 = mem.generate(msgs, do_sample=False, max_new_tokens=32)
    for label, root in (("Q-Former, staged int8 (quantized on the CPU)",
                         staged),
                        ("Q-Former, raw shards, int8 (quantized on the "
                         "card)", raw)):
        m = timed_load(label, ck, root, gpu, "qwen3", msgs,
                       llm_quant="int8")
        check_loaded(label, m, mem, msgs, want8, gpu,
                     launch=("fused_decode_layers_int8", "quant_matmul"))
        del m
    # -- 28g. the ORCA config, the int8 stack and LLM: K8i -------------------
    ocfg = dataclasses.replace(config_from_yaml_file(QWEN_ORCA_CONFIG),
                               llm_quant="int8", orca_xattn_quant="int8")
    with torch.no_grad():
        orca = DeSTA25AudioModel(ocfg, "cuda", seed=0, tokenizer=tok)
        orca.params["whisper"] = mem.params["whisper"]
        orca.params["llm"] = mem.params["llm"]
    cko = os.path.join(work, "ck_qwen3_orca")
    orca.save_pretrained(cko)             # the float stack, as it trains
    orca.apply_orca_xattn_quant()
    wanto = orca.generate(msgs, do_sample=False, max_new_tokens=32)
    # a root with the staged bf16 files alone: its LLM is quantized on
    # the card as it loads
    bf16_root = os.path.join(work, "staged_bf16")
    for mid in (ecfg.model_id, lcfg.model_id):
        os.makedirs(os.path.join(bf16_root, mid))
        os.symlink(os.path.join(staged, mid, STAGED),
                   os.path.join(bf16_root, mid, STAGED))
    for label, root in (("ORCA, raw shards (int8 on the card)", raw),
                        ("ORCA, staged bf16 (int8 on the card)", bf16_root),
                        ("ORCA, staged int8 (int8 on the CPU)", staged)):
        m = timed_load(label, cko, root, gpu, "qwen3", msgs)
        check_loaded(label, m, orca, msgs, wanto, gpu,
                     launch=("fused_decode_inject",))
        del m
    del mem, orca
    # the flagship keeps the whisper tower's files only
    for d in (os.path.join(raw, lcfg.model_id), os.path.join(staged,
              lcfg.model_id), bf16_root, ck, cko):
        shutil.rmtree(d)


def run_checkpoints_flagship(gpu: str, work: str, wavs) -> None:
    """Phase 29: the flagship's Llama-3.1-8B, full size, from disk."""
    import torch
    from desta25_audio_tpu_torch.ckpt.desta_io import (
        save_trainable_safetensors,
    )
    from desta25_audio_tpu_torch.ckpt.synthetic import (
        count_differing,
        fill_state,
        hf_llm_shapes,
        write_snapshot,
    )
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.models.qformer import init_qformer_connector
    cfg = dataclasses.replace(config_from_yaml_file(CONFIG), llm_quant="int8")
    lcfg = cfg.llm_config
    raw, staged = os.path.join(work, "raw"), os.path.join(work, "staged")
    src = os.path.join(raw, lcfg.model_id)
    du = shutil.disk_usage(work)
    print(f"29. {work}: {du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} "
          f"GB before the flagship's files", flush=True)
    # -- 29a. a 4-shard bf16 snapshot ---------------------------------------
    t0 = time.perf_counter()
    make = card_maker(torch.Generator("cuda").manual_seed(29))
    state = fill_state(hf_llm_shapes(lcfg), make(torch.bfloat16))
    n = write_snapshot(src, "llm", lcfg, state, shards=4)
    n_params = sum(t.numel() for t in state.values())
    del state
    torch.cuda.empty_cache()
    print(f"29a. {lcfg.model_id} HF snapshot: {n_params / 1e9:.3f} B params,"
          f" {n / 1e9:.2f} GB bf16 in 4 shards, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # -- 29b. staged int8 (host CPU) -----------------------------------------
    stage_int8_only(src, staged, lcfg.model_id)
    for name in sorted(os.listdir(os.path.join(staged, lcfg.model_id))):
        print(f"  {name}: {os.path.getsize(os.path.join(staged, lcfg.model_id, name)) / 1e9:.3f} GB",
              flush=True)
    # the checkpoint dir: config.json and a seeded Q-Former's
    # model.safetensors (the towers come from the weights roots)
    ck = os.path.join(work, "ck_flagship")
    os.makedirs(ck)
    with open(os.path.join(ck, "config.json"), "w") as f:
        f.write(cfg.to_json())
    with torch.no_grad():
        conn = init_qformer_connector(
            cfg, torch.float32, "cuda", torch.Generator("cuda").manual_seed(0))
    save_trainable_safetensors({"connector": conn}, cfg,
                               os.path.join(ck, "model.safetensors"))
    del conn
    msgs = conversations(wavs)[:2]
    # -- 29c. from the staged int8 file, then from the raw shards ----------
    models = [timed_load(label, ck, root, gpu, "llama3", msgs)
              for label, root in (
                  ("flagship, staged int8 (quantized on the CPU)", staged),
                  ("flagship, raw shards (quantized on the card)", raw))]
    a, b = models
    bad = count_differing(a.params, b.params)
    outs = [m.generate(msgs, do_sample=False, max_new_tokens=32)
            for m in models]
    t = b.last_timings
    print(f"29d. the two flagship loads: {bad} leaves differ (the 32 layers "
          f"and the head quantized on the CPU vs on the card); greedy ids "
          f"{'equal' if outs[0].generated_ids == outs[1].generated_ids else 'DIFFER'}"
          f" (row0[:8] {outs[0].generated_ids[0][:8]}); decode "
          f"{t['decode_ms'] / max(t['decode_steps'], 1):.3f} ms/step ({gpu})",
          flush=True)
    if bad or outs[0].generated_ids != outs[1].generated_ids:
        raise AssertionError("the flagship's staged int8 load differs from "
                             "its load from the raw shards")


def run_checkpoints(gpu: str, tmpdir: str, wavs) -> None:
    """Phases 28-29 in one work dir under the run's temporary directory
    (~35 GB written in all: the snapshots, staged files and checkpoints),
    removed at the end."""
    work = tempfile.mkdtemp(prefix="ckpt", dir=tmpdir)
    try:
        t0 = time.perf_counter()
        run_checkpoints_qwen3(gpu, work, wavs)
        gc.collect()
        t1 = time.perf_counter()
        run_checkpoints_flagship(gpu, work, wavs)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"checkpoint phases: 28 took {t1 - t0:.1f} s, 29 {t2 - t1:.1f} s",
          flush=True)


# -- phase 30: the native decoders, the prefetching loader and LoRA ----------

LORA = dict(use_lora=True, lora_rank=16, lora_alpha=16.0, lora_dropout=0.1)
# the reference's peft setting (r 16, alpha 16, dropout 0.1 on q/k/v)


def _corr(a, b) -> float:
    n = min(len(a), len(b))
    a, b = a[:n] - a[:n].mean(), b[:n] - b[:n].mean()
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                 + 1e-12))


def run_decoders(gpu: str, tmpdir: str) -> str:
    """30a.  The port's native libraries built (g++, under their lock), a
    22.05 kHz stereo clip as 24-bit WAV and, where the FFmpeg codec is
    built, FLAC, MP3 and OGG, each decoded through
    ``AudioSegment.from_file``: the WAV's 24-bit samples exact, FLAC
    lossless to 16-bit quantization, MP3 and OGG correlated with the WAV's
    decode above 0.95 at the best lag.  Returns the corpus format of 30b:
    "flac" with the codec, else "wav"."""
    from desta25_audio_tpu_torch import native
    from desta25_audio_tpu_torch.audio.io import (AudioSegment, read_wav,
                                                  write_wav)
    from desta25_audio_tpu_torch.native import build as nbuild
    t0 = time.perf_counter()
    built = [nbuild.build_library("audio").name]
    ff = nbuild.have_ffmpeg_headers()
    if ff:
        built.append(nbuild.build_library("ffmpeg").name)
    print(f"30a: native libraries {built} built or found in "
          f"{time.perf_counter() - t0:.1f} s ({nbuild.compiler_version()})",
          flush=True)
    if not ff:
        print("30a: the libavformat headers are not installed on this "
              "machine: the FFmpeg codec is not built, FLAC/MP3/OGG do not "
              "decode here; the WAV path runs", flush=True)
    sr = 22050
    d = os.path.join(tmpdir, "decoders")
    os.makedirs(d, exist_ok=True)
    t = np.arange(2 * sr) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                  0.3 * np.sin(2 * np.pi * 660 * t)], 1).astype(np.float32)
    clips = {"wav24": os.path.join(d, "clip.wav")}
    write_wav(clips["wav24"], x, sr, bits=24)
    raw, rate = read_wav(clips["wav24"])
    err24 = float(np.abs(raw - np.round(x.astype(np.float64) * (2 ** 23 - 1))
                         / 2 ** 23).max())
    if rate != sr or err24 > 0:
        raise AssertionError(f"30a: 24-bit WAV decoded at {rate} Hz, error "
                             f"{err24}")
    if ff:
        for fmt, rate_bits in (("flac", 128000), ("mp3", 128000),
                               ("ogg", 64000)):
            clips[fmt] = os.path.join(d, f"clip.{fmt}")
            native.ff_encode(clips[fmt], x, sr, bit_rate=rate_bits)
    # the WAV through the Python path (scipy's resampler): the reference
    ref = AudioSegment.from_file(clips["wav24"], duration=10.0).samples
    rows = []
    for name, p in clips.items():
        ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            seg = AudioSegment.from_file(p)
            ms.append((time.perf_counter() - t1) * 1e3)
        if seg.sample_rate != 16000 or not np.isfinite(seg.samples).all():
            raise AssertionError(f"30a: {name}: {seg.sample_rate} Hz")
        if name == "wav24":
            # the native fast path's resampler against scipy's (<= 5e-3)
            check = float(np.abs(seg.samples[:len(ref)]
                                 - ref[:seg.num_samples]).max())
            ok = check <= 5e-3
        elif name == "flac":
            got, _ = native.ff_decode_raw(p)
            q = np.round(x * 32767.0) / 32768.0
            check = float(np.abs(got[:len(q)] - q[:len(got)]).max())
            ok = got.shape == x.shape and check <= 2 ** -15
        else:
            check = max(_corr(seg.samples[lag:lag + 16000], ref[:16000])
                        for lag in range(0, 2400, 8))
            ok = check > 0.95
        rows.append(f"{name} {seg.num_samples} samples, median "
                    f"{sorted(ms)[1]:.2f} ms, check {check:.3g}")
        if not ok:
            raise AssertionError(f"30a: {name}: check {check}")
    print(f"30a: AudioSegment.from_file of a 2 s 22.05 kHz stereo clip, host "
          f"ms a clip ({gpu} host): " + "; ".join(rows), flush=True)
    return "flac" if ff else "wav"


def run_lora_training(gpu: str, tmpdir: str, fmt: str):
    """30b.  The flagship with LoRA (r 16, alpha 16, dropout 0.1):
    DeSTA25Trainer 3 steps at B=4 T=512 with ``num_workers`` 0, then 2,
    over phase 22's corpus as ``fmt`` clips; K11 forward and backward in
    every step; the adapters' B moves from zero; evaluate() generates with
    the adapters (the layer loop).  Returns the model, its adapters frozen
    again."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    cfg = dataclasses.replace(config_from_yaml_file(CONFIG), **LORA)
    t0 = time.perf_counter()
    model = DeSTA25AudioModel(cfg, device="cuda", seed=30,
                              tokenizer=CharTokenizer("llama3"))
    torch.cuda.synchronize()
    d = os.path.join(tmpdir, "lora")
    manifest = write_corpus(d, fmt=fmt)
    n_lora = sum(v.numel() for v in flatten_tree(
        model.params["lora"]).values())
    print(f"30b: LoRA model built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB; adapters "
          f"{n_lora / 1e6:.2f} M parameters); corpus of {fmt} clips",
          flush=True)
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=d,
                      batch_size=4, max_seq_length=512)
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    collate = CollateFn(cfg, dcfg, model.tokenizer)
    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    kernels = ("flash_attention", "flash_attention_bwd",
               "packed_encoder_attention", "encoder_ffn", "log_mel")
    for workers in (0, 2):
        trainable, _ = model.split_params()
        start = {k: v.detach().clone()
                 for k, v in flatten_tree(trainable).items()}
        tcfg = TrainerConfig(exp_dir=os.path.join(d, f"exp{workers}"),
                             max_steps=3, log_every_n_steps=1, remat=True,
                             eval_before_train=False, val_check_interval=1e9,
                             eval_max_batches=1, eval_max_new_tokens=8,
                             keep_checkpoints=1, num_workers=workers)
        trainer = DeSTA25Trainer(model, ds, ds, collate, ocfg, tcfg)
        probe = StepProbe(trainer, start)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        print_steps(f"30b LoRA train num_workers={workers}", probe.rows, gpu)
        waits = [r["wait_ms"] for r in probe.rows[1:]]
        print(f"30b num_workers={workers} ({gpu}): train() {train_s:.1f} s "
              f"for 3 steps and a checkpoint; steps "
              f"{[round(r['ms'], 1) for r in probe.rows]} ms; the host's "
              f"wait for steps 2-3's batches {[round(w, 1) for w in waits]} "
              f"ms; peak {max(r['peak_gib'] for r in probe.rows):.2f} GiB",
              flush=True)
        if len(probe.rows) != 3:
            raise AssertionError(f"30b: {len(probe.rows)} steps, not 3")
        for i, r in enumerate(probe.rows):
            check_train_row(f"30b step {i + 1} (num_workers={workers})", r,
                            kernels)
        b = max(float(v["b"].detach().abs().max())
                for v in model.params["lora"]["layers"].values())
        if workers == 0 and not b > 0:
            raise AssertionError("30b: the adapters' B did not move from 0")
    print(f"30b: the adapters' B reached max |B| {b:.3e}", flush=True)
    _build.reset_launch_counts()
    report = trainer.evaluate(tag="lora")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"30b: evaluate() with the adapters: loss {report['loss']:.4f}, "
          f"launches {json.dumps(counts)}", flush=True)
    if counts.get("log_mel", 0) <= 0 or any(k.startswith("fused_")
                                            for k in counts):
        raise AssertionError(f"30b: evaluate() launches {counts}")
    for t in flatten_tree(model.params).values():
        t.requires_grad_(False)
    del trainer, probe
    return model


def first_step_logits(model, convs):
    """The prefill's last-position f32 logits [B, V] of a greedy
    generate() of ``convs`` (with the model's adapters, if any)."""
    import torch
    from desta25_audio_tpu_torch.models import llm as tllm
    with torch.no_grad():
        embeds, mask = model._run_generation_phases(convs, {})[:2]
        B, T = mask.shape
        S = -(-(T + 1) // 128) * 128
        full = torch.zeros(B, S, dtype=torch.int32, device=embeds.device)
        full[:, :T] = mask
        cache = tllm.init_kv_cache(model.llm_cfg, B, S, embeds.dtype,
                                   embeds.device)
        pos = torch.clamp(torch.cumsum(full[:, :T], 1) - 1, min=0)
        lg, _ = tllm.llm_apply(
            model.params["llm"], model.llm_cfg, inputs_embeds=embeds,
            attention_mask=full, positions=pos, cache=cache, cache_index=0,
            lora=model.params.get("lora"),
            lora_scale=model.config.lora_scale)
    return lg[:, -1].float()


def run_lora_serving(model, wavs, gpu: str) -> None:
    """30c-30d.  The adapters' B moved off zero; generate() b2 through the
    layer loop (no fused kernel, K1 and the encoder's kernels); the engine
    at 4 slots under LoRA (layer-loop ticks, speculation refused) whose
    greedy ids equal generate()'s; then the merge on the card against the
    CPU's, ``merge_lora_for_serving(quantize=True)`` and generate() b2
    through the K8-int8 graph, with the merged model's first-step logits
    beside the adapter model's."""
    import torch
    from desta25_audio_tpu_torch.ckpt.synthetic import merge_card_vs_cpu
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    g = torch.Generator("cuda").manual_seed(31)
    with torch.no_grad():
        for ab in model.params["lora"]["layers"].values():
            ab["b"].add_(torch.randn(ab["b"].shape, generator=g,
                                     device="cuda") * 0.02)
    convs = conversations(wavs)
    # -- 30c. generate() b2 with the adapters: the layer loop ---------------
    model.generate(convs[:2], do_sample=False, max_new_tokens=2)
    _build.reset_launch_counts()
    out = model.generate(convs[:2], do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    t = model.last_timings
    print(f"30c LoRA generate() b2 ({gpu}): prefill {t['prefill_ms']:.1f} ms,"
          f" decode {t['decode_ms'] / max(t['decode_steps'], 1):.2f} ms a "
          f"step (the layer loop, eager); launches {json.dumps(counts)}",
          flush=True)
    require_kernel_paths("30c LoRA b2")
    if any(k.startswith("fused_") or k == "decode_graph" for k in counts):
        raise AssertionError(f"30c: a fused step ran under LoRA: {counts}")
    for name in ("log_mel", "packed_encoder_attention", "encoder_ffn"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"30c: {name} was not launched")
    check_outputs(model, ((out, 2),))
    add_margins(model, convs[:2], out)
    print(f"30c LoRA b2 row0[:8]={shown(out, 0)}", flush=True)

    # -- 30d. the engine at 4 slots under LoRA --------------------------------
    eng_convs = engine_convs(wavs, 4)
    eng = ContinuousBatchingEngine(model, n_slots=4, max_ctx=256,
                                   max_new_tokens=32, ctx_bucket=64,
                                   speculative_k=4)
    if eng.graph is not None or eng.speculative_k != 0:
        raise AssertionError("30d: the engine kept a graph or speculates "
                             "under LoRA")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rids, reqs = submit_all(eng, eng_convs)
    eng.run_until_done()
    info = eng.results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    check_finished("30d LoRA engine", model, info, rids)
    if any(k.startswith("fused_") for k in counts) or _build.fallback_counts():
        raise AssertionError(f"30d: launches {counts}, torch paths "
                             f"{_build.fallback_counts()}")
    eng.close()
    model.enable_audio_cache(0)
    # generate() of the same four requests at b4, each step's top-2 margin
    # recorded: where a row parts from the engine's (their prompts are
    # padded apart, so the products' bits may differ), generate()'s own
    # margin there says whether the step was a near-tie
    from desta25_audio_tpu_torch.generate import decode as tdecode
    real_sample, tops = tdecode.sample_token, []

    def sample(logits, *args):
        tops.append(logits.topk(2, dim=-1).values.float())
        return real_sample(logits, *args)

    tdecode.sample_token = sample
    try:
        gen = model.generate(eng_convs, do_sample=False, max_new_tokens=32)
    finally:
        tdecode.sample_token = real_sample
    top = torch.stack(tops)
    margins = (top[..., 0] - top[..., 1]).T.cpu().numpy()     # [B, steps]
    parted = []
    for i, r in enumerate(rids):
        got, want = info[r]["tokens"], gen.generated_ids[i]
        p = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if p is not None:
            parted.append((i, p, round(float(margins[i][p]), 4)))
    print(f"30d LoRA engine ({gpu}): 4 requests in {eng._n_plain_ticks} "
          f"plain ticks, {wall * 1e3:.1f} ms; greedy ids equal generate()'s "
          f"b4 in {4 - len(parted)} of 4 rows; the others part at (row, "
          f"position, generate()'s top-2 margin there) {parted}; launches "
          f"{json.dumps(counts)}", flush=True)
    engine_gate("30d LoRA engine", model,
                [(reqs[r], info[r]["tokens"]) for r in rids])
    bad = [p for p in parted if p[2] > TOL_ENGINE_MARGIN]
    if bad:
        raise AssertionError(f"30d: engine ids part from generate()'s away "
                             f"from a near-tie: {bad}")

    # -- 30c (cont.). merge on the card, then the K8-int8 graph --------------
    adapter_first = first_step_logits(model, convs[:2])
    with torch.no_grad():
        r = merge_card_vs_cpu(model.params["llm"], model.params["lora"],
                              model.config.lora_scale)
    print(f"30c: merge_lora + quantize_llm_params on the card against the "
          f"CPU over 2 full-width layers and 4096 head rows: {r['merged']} "
          f"merged bf16 weights and {r['leaves']} int8 leaves differ of "
          f"{r['weights']} weights (card {r['card_s']:.2f} s, CPU "
          f"{r['cpu_s']:.2f} s)", flush=True)
    if r["merged"] or r["leaves"]:
        raise AssertionError(f"30c: the card's merge differs: {r}")
    t0 = time.perf_counter()
    model.merge_lora_for_serving(quantize=True)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    merged_first = first_step_logits(model, convs[:2])
    top2 = adapter_first.topk(2, -1).values
    a_id = adapter_first.argmax(-1)
    below = merged_first.max(-1).values - merged_first.gather(
        -1, a_id[:, None])[:, 0]
    print(f"30c: merged + int8 against the adapter model, first step: "
          f"adapter top-2 margins {(top2[:, 0] - top2[:, 1]).tolist()}, the "
          f"adapter's argmax below the merged model's top by "
          f"{below.tolist()}, largest logit difference "
          f"{float((merged_first - adapter_first).abs().max()):.4f} "
          f"(merge and quantize {merge_s:.1f} s on the card)", flush=True)
    model.generate(convs[:2], do_sample=False, max_new_tokens=2)
    _build.reset_launch_counts()
    out8 = model.generate(convs[:2], do_sample=False, max_new_tokens=32)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    require_kernel_paths("30c merged int8 b2")
    require_graph_replays("30c merged int8 b2", counts, model.last_timings)
    if counts.get("fused_decode_layers_int8", 0) <= 0:
        raise AssertionError(f"30c: K8-int8 did not run: {counts}")
    check_outputs(model, ((out8, 2),))
    t = model.last_timings
    print(f"30c merged int8 generate() b2 ({gpu}): decode "
          f"{t['decode_ms'] / max(t['decode_steps'], 1):.2f} ms a step "
          f"through the K8-int8 graph; row0[:8]="
          f"{out8.generated_ids[0][:8]}; launches {json.dumps(counts)}",
          flush=True)


def run_phase30(gpu: str, tmpdir: str, wavs) -> None:
    """Phase 30 (30a-30d)."""
    import torch
    t0 = time.perf_counter()
    fmt = run_decoders(gpu, tmpdir)
    model = run_lora_training(gpu, tmpdir, fmt)
    gc.collect()
    torch.cuda.empty_cache()
    run_lora_serving(model, wavs, gpu)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 30 took {time.perf_counter() - t0:.1f} s ({gpu})",
          flush=True)



# -- phase 31: training on a mesh, and across processes -----------------------

def restore_trainable(model, start) -> None:
    """The model's trainable leaves back to ``start`` (phase 22's clones)."""
    import torch
    from desta25_audio_tpu_torch.train.optimizer import flatten_tree
    with torch.no_grad():
        for k, v in flatten_tree(model.split_params()[0]).items():
            v.copy_(start[k])


@contextlib.contextmanager
def flash_heads_spy():
    """Record the heads of every K11 forward call (``ops/attention.mha``'s
    flash path): a rank of a ``1 x p`` group passes H/p of them."""
    from desta25_audio_tpu_torch.ops import attention as tatt
    real = tatt.flash_attention
    heads = []

    def spy(q, *args):
        heads.append(int(q.shape[2]))
        return real(q, *args)

    tatt.flash_attention = spy
    try:
        yield heads
    finally:
        tatt.flash_attention = real


class MeshStepProbe:
    """A mesh trainer's train step, per step: host ms (every card of the
    mesh synchronised), the peak memory of each card, the launches, the
    K11 heads a forward call, the metrics, and, gathered on the host after
    the step's time and peak are read, the ``sampled`` elements of the
    gradients and of the trained leaves and, where fsdp cut leaves, the
    error of the step's update (:class:`UpdateReplay`)."""

    def __init__(self, trainer):
        import torch
        trainer._layout()
        self.trainer, self.rows = trainer, []
        self.replay = None
        self.cards = sorted({d for d in trainer.mesh.all_devices()
                             if d.type == "cuda"}, key=str)
        self.real = trainer.train_step
        trainer.train_step = self
        self.torch = torch

    def __call__(self, trainable, layout, opt_state, batch):
        from desta25_audio_tpu_torch.ops import _build
        torch = self.torch
        for c in self.cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        before = _build.launch_counts()
        with flash_heads_spy() as heads, \
                update_tap(self.trainer.optimizer,
                           self.trainer.tcfg.fsdp and not self.rows) as tap:
            t0 = time.perf_counter()
            out = self.real(trainable, layout, opt_state, batch)
            for c in self.cards:
                torch.cuda.synchronize(c)
            ms = (time.perf_counter() - t0) * 1e3
        after = _build.launch_counts()
        from desta25_audio_tpu_torch.parallel.sharding import (Shards,
                                                               gather_leaf)
        from desta25_audio_tpu_torch.train.optimizer import flatten_tree
        cuts = {k: (len(g.parts), g.dim) for k, g in tap["grads"].items()
                if isinstance(g, Shards)}
        grads = {k: gather_leaf(g, "cpu") for k, g in tap["grads"].items()}
        updates = {k: gather_leaf(u, "cpu")
                   for k, u in tap["updates"].items()}
        if cuts and self.replay is None:
            self.replay = UpdateReplay(self.trainer.optimizer,
                                       tap["params"], cuts)
        tap.clear()
        self.rows.append({
            "ms": ms, "shape": tuple(batch["input_ids"].shape),
            "peaks_gib": [torch.cuda.max_memory_allocated(c) / 2 ** 30
                          for c in self.cards],
            "launches": {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)},
            "heads": sorted(set(heads)),
            "metrics": {k: float(v) for k, v in out[2].items()},
            "sample": {k: sampled(gather_leaf(v, "cpu")).float()
                       for k, v in flatten_tree(out[0]).items()},
            "grads": {k: sampled(g).float() for k, g in grads.items()},
            "update": (None if self.replay is None
                       else self.replay(grads, updates))})
        return out


class UpdateReplay:
    """Adafactor on the owners fsdp cut, held against the rule on whole
    tensors: each step's update (gathered on the host) against the update
    the optimizer makes on the host from the same gradients, whole, and
    against the one it makes from each data row's part of every cut leaf
    alone (the control: Adafactor with its factored means and block RMS
    per shard).  ``__call__`` -> (the error, the control): L2 norms of the
    differences over that of the whole update, all leaves together; None
    where the update is 0 (lr 0 at step 1)."""

    def __init__(self, optimizer, params, cuts):
        self.opt, self.cuts = optimizer, cuts
        # copies: a CPU owner gathers to itself
        self.whole = {k: v.clone() for k, v in params.items()}
        self.naive = {k: v.clone() for k, v in self.split(params).items()}
        self.states = (self.opt.init(self.whole), self.opt.init(self.naive))

    def split(self, flat):
        import torch
        out = {}
        for k, v in flat.items():
            if k in self.cuts:
                n, dim = self.cuts[k]
                for e, c in enumerate(torch.chunk(v, n, dim)):
                    out[f"{k}#{e}"] = c.contiguous()
            else:
                out[k] = v
        return out

    def __call__(self, grads, updates):
        import torch
        from desta25_audio_tpu_torch.train.optimizer import apply_updates
        ws, ns = self.states
        want, ws = self.opt.update(grads, ws, self.whole)
        naive, ns = self.opt.update(self.split(grads), ns, self.naive)
        self.states = (ws, ns)
        apply_updates(self.whole, want)
        apply_updates(self.naive, naive)
        naive = {k: torch.cat([naive[f"{k}#{e}"]
                               for e in range(self.cuts[k][0])],
                              self.cuts[k][1]) if k in self.cuts
                 else naive[k] for k in want}
        keys = sorted(want)

        def norm(a, b=None):
            return float(torch.cat([
                (a[k] if b is None else a[k] - b[k]).double().reshape(-1)
                for k in keys]).norm())
        size = norm(want)
        if size == 0.0:
            return None
        return norm(updates, want) / size, norm(naive, want) / size


def mesh_train_run(label: str, model, ds, collate, ocfg, exp: str,
                   steps: int, ref, gpu: str,
                   tol=(TOL_TRAIN_MESH_LOSS, TOL_TRAIN_MESH_GN,
                        TOL_TRAIN_MESH_G), **mesh_kw):
    """``DeSTA25Trainer.train()`` for ``steps`` steps on a mesh
    (``mesh_kw``: mesh_model, fsdp, mesh_devices), each step held against
    ``ref`` (``rows``: the one-device run's StepProbe rows on the same
    batches, with their samples; ``start``: the samples before): lm_loss
    and grad_norm within ``tol``'s first two (TOL_TRAIN_MESH_LOSS / _GN)
    beside the control (the one-device run's next batch at equal
    parameters); at the first two steps (equal parameters: lr 0 at step 1)
    the gradients' samples within its third (TOL_TRAIN_MESH_G) beside the
    control (the one-device gradients of the next batch); where fsdp cut
    leaves each update within TOL_TRAIN_MESH_U of the whole rule's beside
    the rule per shard (:class:`UpdateReplay`).  One of these controls
    must read at least 10x its gate.  The trained leaves against the
    one-device run's are printed, not gated (:func:`trained_err`); K11
    forward and
    backward launched once a rank for each of the one-device step's
    launches (on a pipe mesh with ``pipeline_microbatches`` M, M times: a
    stage runs its layers once a microbatch at B / M rows), at H /
    mesh_model heads; under fsdp every leaf ``fsdp_partition_specs`` cuts
    still cut after the steps.  Prints a line a step.  Returns the probe's
    rows."""
    import torch
    from desta25_audio_tpu_torch.parallel.sharding import (
        Shards, fsdp_partition_specs)
    from desta25_audio_tpu_torch.train.optimizer import flatten_tree
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    tcfg = TrainerConfig(exp_dir=exp, max_steps=steps, log_every_n_steps=1,
                         remat=True, eval_before_train=False,
                         val_check_interval=1e9, keep_checkpoints=1,
                         mesh="on", **mesh_kw)
    trainer = DeSTA25Trainer(model, ds, None, collate, ocfg, tcfg)
    mesh = trainer.mesh
    ranks = mesh.n_data * mesh.n_model
    micro = (max(trainer.tcfg.pipeline_microbatches, 1) if mesh.n_pipe > 1
             else 1)
    t0 = time.perf_counter()
    probe = MeshStepProbe(trainer)
    layout_s = time.perf_counter() - t0
    trainer.train()
    if len(probe.rows) != steps:
        raise AssertionError(f"{label}: train() ran {len(probe.rows)} steps")
    H = model.config.llm_config.num_attention_heads
    ref_rows, start = ref["rows"], ref["start"]
    ctl_g = rel_l2(ref_rows[1]["grads"], ref_rows[0]["grads"])
    ctl_loss = abs(ref_rows[1]["metrics"]["lm_loss"]
                   - ref_rows[0]["metrics"]["lm_loss"]
                   ) / abs(ref_rows[0]["metrics"]["lm_loss"])
    ctl_gn = abs(ref_rows[1]["metrics"]["grad_norm"]
                 - ref_rows[0]["metrics"]["grad_norm"]) / ref_rows[0][
                     "metrics"]["grad_norm"]
    for i, (r, w) in enumerate(zip(probe.rows, ref_rows)):
        m, wm = r["metrics"], w["metrics"]
        err_loss = abs(m["lm_loss"] - wm["lm_loss"]) / abs(wm["lm_loss"])
        err_gn = abs(m["grad_norm"] - wm["grad_norm"]) / wm["grad_norm"]
        before = start if i == 0 else ref_rows[i - 1]["sample"]
        err_w, worst, ctl_w = trained_err(r["sample"], w["sample"], start,
                                          before)
        err_g = rel_l2(r["grads"], w["grads"])
        err_u, ctl_u = r["update"] or (None, None)
        fw = r["launches"].get("flash_attention", 0)
        bw = r["launches"].get("flash_attention_bwd", 0)
        B, T = r["shape"]
        shape = f"{mesh.n_data}x{mesh.n_model}" + (
            f"x{mesh.n_pipe}, M={micro}" if mesh.n_pipe > 1 else "") + (
            ", sp" if trainer.tcfg.sequence_parallel else "")
        print(f"{label} ({shape}, "
              f"fsdp={trainer.tcfg.fsdp}) step {i + 1} B={B} T={T} ({gpu}): "
              f"{r['ms']:.1f} ms (one device {w['ms']:.1f}), peak "
              f"{' / '.join(f'{p:.2f}' for p in r['peaks_gib'])} GiB "
              f"(one device {w['peak_gib']:.2f}); lm_loss {m['lm_loss']:.6f} "
              f"(one device {wm['lm_loss']:.6f}, rel {err_loss:.2e}), "
              f"grad_norm {m['grad_norm']:.6f} ({wm['grad_norm']:.6f}, rel "
              f"{err_gn:.2e}); gate {tol[0]:.0e} / "
              f"{tol[1]:.0e}, control (the next batch) "
              f"{ctl_loss:.2e} / {ctl_gn:.2e}; gradients {err_g:.2e} (gate "
              f"{tol[2]:.0e} at equal parameters, control, the "
              f"next batch, {ctl_g:.2e}); update "
              f"{'-' if err_u is None else f'{err_u:.2e}'} against the "
              f"whole rule (gate {TOL_TRAIN_MESH_U:.0e}, control, the rule "
              f"per shard, {'-' if ctl_u is None else f'{ctl_u:.2e}'}); "
              f"trained leaves {err_w:.2e} (worst leaf {worst[1]:.2e}, "
              f"{worst[0]}; not gated), one update behind "
              f"{'-' if ctl_w is None else f'{ctl_w:.2e}'}; K11 "
              f"{fw:g} forward, {bw:g} backward ({fw / ranks:g} / "
              f"{bw / ranks:g} a rank) at {r['heads']} heads "
              f"(one device {w['launches'].get('flash_attention', 0)}, "
              f"{w['launches'].get('flash_attention_bwd', 0)})", flush=True)
        if not (err_loss <= tol[0] and err_gn <= tol[1]):
            raise AssertionError(f"{label} step {i + 1}: the mesh's loss / "
                                 f"grad_norm part from one device's: "
                                 f"{err_loss:.3e} / {err_gn:.3e}")
        if i < 2 and not err_g <= tol[2]:
            raise AssertionError(f"{label} step {i + 1}: the gradients part "
                                 f"from one device's: {err_g:.3e}")
        if i == 0 and err_w != 0.0:
            raise AssertionError(f"{label}: the trained leaves moved at "
                                 f"step 1 (lr 0) or part from one device's")
        if err_u is not None and not err_u <= TOL_TRAIN_MESH_U:
            raise AssertionError(f"{label} step {i + 1}: the update part "
                                 f"from the whole rule's: {err_u:.3e}")
        if fw != ranks * micro * w["launches"].get("flash_attention", -1) \
                or bw != ranks * micro * w["launches"].get(
                    "flash_attention_bwd", -1) \
                or r["heads"] != [H // mesh.n_model]:
            raise AssertionError(f"{label} step {i + 1}: K11 launches "
                                 f"{fw} / {bw} at heads {r['heads']}")
        for name in ("packed_encoder_attention", "encoder_ffn", "log_mel"):
            if r["launches"].get(name, 0) <= 0:
                raise AssertionError(f"{label}: {name} not launched")
    # each control over its gate; the best must read 10 or more
    ratios = {"loss": ctl_loss / tol[0], "grad_norm": ctl_gn / tol[1],
              "gradients": ctl_g / tol[2]}
    if trainer.tcfg.fsdp:
        if not any(r["update"] for r in probe.rows):
            raise AssertionError(f"{label}: no fsdp update was replayed")
        ratios["update"] = max(r["update"][1] for r in probe.rows
                               if r["update"]) / TOL_TRAIN_MESH_U
    print(f"{label}: each control over its gate: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ratios.items()), flush=True)
    if not max(ratios.values()) >= 10.0:
        raise AssertionError(f"{label}: no control reads 10x its gate")
    if trainer.tcfg.fsdp:
        flat = flatten_tree(model.split_params()[0])
        want = {k for k, d in fsdp_partition_specs(flat, mesh.n_data).items()
                if d is not None}
        got = {k for k, v in trainer._owners.items()
               if isinstance(v, Shards)}
        if not want or got != want:
            raise AssertionError(f"{label}: {len(got)} leaves cut after the "
                                 f"steps, fsdp cuts {len(want)}")
        n_cut = sum(flat[k].numel() for k in want)
        print(f"{label}: {len(want)} of {len(flat)} trainable leaves "
              f"({n_cut / 1e6:.1f} M of "
              f"{sum(v.numel() for v in flat.values()) / 1e6:.1f} M "
              f"parameters) cut over {mesh.n_data} data rows after the "
              f"steps; the layout set up in {layout_s:.1f} s", flush=True)
    rows = probe.rows
    del trainer, probe
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def rel_l2(got, want) -> float:
    """The L2 norm of ``got - want`` over that of ``want``, every leaf's
    samples together."""
    import torch
    keys = sorted(want)
    diff = torch.cat([(got[k] - want[k]).double().reshape(-1) for k in keys])
    whole = torch.cat([want[k].double().reshape(-1) for k in keys])
    return float(diff.norm()) / float(whole.norm())


def trained_err(got, want, start, before):
    """The trained leaves' ``sampled`` elements after a mesh step (``got``)
    against the one-device run's (``want``), all leaves together: the L2
    norm of the difference over that of the one-device run's movement from
    ``start``, or, where it has not moved (lr 0 at step 1), the largest
    difference itself, which must then be 0.  -> (that, (the worst leaf of
    64 samples or more, its own ratio), the control: the same ratio for
    ``before``, the one-device values one update behind, None where nothing
    moved)."""
    import torch
    keys = sorted(want)

    def vec(a, b):
        return torch.cat([(a[k] - b[k]).reshape(-1).double() for k in keys])
    moved = float(vec(want, start).norm())
    if moved == 0.0:
        return float(vec(got, want).abs().max()), ("-", 0.0), None
    worst = max(((k, float((got[k] - want[k]).double().norm())
                  / max(float((want[k] - start[k]).double().norm()), 1e-30))
                 for k in keys if want[k].numel() >= 64),
                key=lambda kv: kv[1], default=("-", 0.0))
    return (float(vec(got, want).norm()) / moved, worst,
            float(vec(before, want).norm()) / moved)


def train_worker(path: str) -> int:
    """``--train-worker SPEC``: one process of phase 31b / the four-card
    run (spawned by :func:`run_processes`): joins the process group from
    its environment (torchrun's variables), trains ``steps`` steps of the
    spec's config on its own rows (``rows[rank::world]``) at its batch
    size on a ``1 x 1`` mesh of its card, and writes its metrics, its
    rows, a sample of the trained leaves, ms and peak memory."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.parallel import distributed as pdist
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    with open(path) as f:
        spec = json.load(f)
    if not torch.cuda.is_available():
        raise SystemExit("train worker: no GPU")
    if not pdist.maybe_initialize(spec["backend"], "cuda"):
        raise SystemExit("train worker: no process group in the environment")
    rank, world = pdist.world()
    dev = pdist.local_device(spec["device"])
    torch.cuda.set_device(dev)
    _build.library()
    cfg = config_from_yaml_file(spec["config"])
    model = DeSTA25AudioModel(cfg, device=dev, seed=spec["seed"],
                              tokenizer=CharTokenizer("llama3"))
    dcfg = DataConfig(manifest_filepaths=[spec["manifest"]],
                      data_root=spec["root"], batch_size=spec["batch_size"],
                      max_seq_length=spec["max_seq_length"])
    ds = AudioTextDataset(cfg, dcfg, model.tokenizer)
    tcfg = TrainerConfig(exp_dir=spec["exp"], max_steps=spec["steps"],
                         log_every_n_steps=1, remat=True,
                         eval_before_train=False, val_check_interval=1e9,
                         keep_checkpoints=1, mesh="auto",
                         mesh_devices=[str(dev)])
    trainer = DeSTA25Trainer(model, ds, None,
                             CollateFn(cfg, dcfg, model.tokenizer),
                             OptimizerConfig(**spec["opt"]), tcfg)
    probe = MeshStepProbe(trainer)
    trainer.train()
    trained = flatten_tree(model.split_params()[0])
    out = {"rank": rank, "world": world, "device": str(dev),
           "rows": [r["id"] for r in ds.rows],
           "steps": [{k: r[k] for k in ("ms", "peaks_gib", "metrics",
                                        "launches")} for r in probe.rows],
           "sampled": {k: sampled(v).float().cpu().tolist()
                       for k, v in trained.items()}}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    pdist.barrier()
    return 0


def run_processes(label: str, n: int, tmpdir: str, manifest: str, gpu: str,
                  backend: str, cards: bool, model, start, ocfg_kw,
                  batch_size: int = 2) -> None:
    """n processes (``--train-worker``), each one step at ``batch_size`` on
    a 1 x 1 mesh over ``backend`` (on one card: virtual, every process on
    cuda:0; with ``cards``: one a card, cuda:LOCAL_RANK), against the one-
    process (n, 1) step of ``model`` (from ``start``) on their first
    batches concatenated: lm_loss, grad_norm and every sampled trained
    element within TOL_TRAIN_PROC; the control is the one-process run's
    next step (other batches at equal parameters: lr 0 at step 1)."""
    import socket
    import torch
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    from desta25_audio_tpu_torch.parallel.mesh import make_mesh
    from desta25_audio_tpu_torch.parallel.sharding import (
        gather_trainable, shard_trainable)
    from desta25_audio_tpu_torch.train import step as tstep
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree,
                                                         make_optimizer)
    out = os.path.join(tmpdir, f"procs_{label}")
    os.makedirs(out, exist_ok=True)
    spec = {"config": CONFIG, "seed": 3, "manifest": manifest,
            "root": tmpdir, "batch_size": batch_size, "max_seq_length": 512,
            "steps": 1, "backend": backend, "opt": ocfg_kw,
            "device": "cuda" if cards else "cuda:0",
            "exp": os.path.join(out, "exp"), "out": out}
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.update(WORLD_SIZE=str(n), MASTER_ADDR="localhost",
               MASTER_PORT=str(port),
               LOCAL_WORLD_SIZE=str(n if cards else 1))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-worker",
         spec_path], env=dict(env, RANK=str(r),
                              LOCAL_RANK=str(r if cards else 0)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=420)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        for r, log in enumerate(logs):
            print(f"--- worker {r} (rc {procs[r].returncode}) ---\n"
                  f"{log[-3000:]}", flush=True)
        raise AssertionError(f"{label}: a worker failed")
    runs = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            runs.append(json.load(f))

    # the one-process (n, 1) step on the concatenated first batches
    restore_trainable(model, start)
    cfg = model.config
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                      batch_size=batch_size, max_seq_length=512)
    items, nxt = [], []
    for r, run in enumerate(runs):
        ds = AudioTextDataset(cfg, dcfg, model.tokenizer,
                              shard_by_process=False)
        ds.rows = ds.rows[r::n]
        if [row["id"] for row in ds.rows] != run["rows"]:
            raise AssertionError(f"{label}: process {r}'s rows differ")
        valid = list(ds.iter_valid(0))
        items += valid[:batch_size]
        nxt += valid[batch_size:2 * batch_size]
    collate = CollateFn(cfg, dcfg, model.tokenizer)
    devices = ([f"cuda:{r}" for r in range(n)] if cards
               else ["cuda:0"] * n)
    mesh = make_mesh(n, 1, devices)
    layout = tstep.TrainLayout(mesh, model.split_params()[1], cfg)
    optimizer = make_optimizer(OptimizerConfig(**ocfg_kw))
    owners = shard_trainable({k: v.detach().clone() for k, v in flatten_tree(
        model.split_params()[0]).items()}, mesh)
    state = optimizer.init(owners)
    step = tstep.make_train_step(cfg, optimizer, remat=True)
    ms = []
    metrics = []
    for its in (items, nxt):
        batch = {k: torch.as_tensor(v) if v.dtype.kind == "f"
                 else torch.as_tensor(v).long()
                 for k, v in collate(its).items()
                 if isinstance(v, np.ndarray)}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        owners, state, m = step(owners, layout, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if len(metrics) == 1:
            want = {k: sampled(v).float().cpu() for k, v in
                    gather_trainable(owners).items()}
    del layout, owners, state, step
    gc.collect()
    torch.cuda.empty_cache()
    got = runs[0]["steps"][0]["metrics"]
    errs = {k: abs(got[k] - metrics[0][k]) / abs(metrics[0][k])
            for k in ("lm_loss", "grad_norm")}
    err_w = max(float((torch.tensor(run["sampled"][k]) - w).abs().max())
                / (float(w.abs().max()) + 1e-30)
                for run in runs for k, w in want.items())
    ctl = abs(metrics[1]["lm_loss"] - metrics[0]["lm_loss"]) / abs(
        metrics[0]["lm_loss"])
    print(f"{label}: {n} processes over {backend} "
          f"({'one a card' if cards else 'on one card'}), B={batch_size} "
          f"each, wall {wall:.1f} s with start-up ({gpu}): the step "
          f"{', '.join(f'{r['steps'][0]['ms']:.1f}' for r in runs)} ms, "
          f"peak {', '.join(f'{max(r['steps'][0]['peaks_gib'], default=0):.2f}' for r in runs)}"
          f" GiB; lm_loss {got['lm_loss']:.6f} against the one-process "
          f"({n}, 1) step's {metrics[0]['lm_loss']:.6f} ({ms[0]:.1f} ms): "
          f"rel {errs['lm_loss']:.2e}, grad_norm rel {errs['grad_norm']:.2e}"
          f", trained elements {err_w:.2e}; gate {TOL_TRAIN_PROC:.0e}, "
          f"control (the next batches) {ctl:.2e}; K11 a process "
          f"{runs[0]['steps'][0]['launches'].get('flash_attention', 0)} "
          f"forward, "
          f"{runs[0]['steps'][0]['launches'].get('flash_attention_bwd', 0)}"
          f" backward", flush=True)
    if max(max(errs.values()), err_w) > TOL_TRAIN_PROC:
        raise AssertionError(f"{label}: the processes part from one "
                             f"process: {errs}, {err_w:.3e}")
    if not ctl > TOL_TRAIN_PROC:
        raise AssertionError(f"{label}: the control reads within the gate")
    for run in runs:
        if run["steps"][0]["launches"].get("flash_attention_bwd", 0) <= 0:
            raise AssertionError(f"{label}: K11 backward not launched in "
                                 f"process {run['rank']}")


def train_data(cfg, model, tmpdir: str, manifest: str, batch_size: int = 4):
    from desta25_audio_tpu_torch.data.dataset import (AudioTextDataset,
                                                      CollateFn, DataConfig)
    dcfg = DataConfig(manifest_filepaths=[manifest], data_root=tmpdir,
                      batch_size=batch_size, max_seq_length=512)
    return (AudioTextDataset(cfg, dcfg, model.tokenizer),
            CollateFn(cfg, dcfg, model.tokenizer))


def one_device_run(label: str, model, ds, collate, ocfg, exp: str,
                   steps: int, gpu: str, start):
    """The one-device trainer's run, the reference of phase 31's mesh runs:
    ``rows`` (its StepProbe rows, with the trained samples) and ``start``
    (the samples before), the trainable restored to ``start`` first (None:
    the model is fresh)."""
    import torch
    from desta25_audio_tpu_torch.train.optimizer import flatten_tree
    from desta25_audio_tpu_torch.train.trainer import (DeSTA25Trainer,
                                                       TrainerConfig)
    if start is not None:
        restore_trainable(model, start)
    trainer = DeSTA25Trainer(model, ds, None, collate, ocfg, TrainerConfig(
        exp_dir=exp, max_steps=steps, log_every_n_steps=1, remat=True,
        eval_before_train=False, val_check_interval=1e9, keep_checkpoints=1))
    probe = StepProbe(trainer, {k: sampled(v) for k, v in flatten_tree(
        model.split_params()[0]).items()}, sampled, keep=True)
    trainer.train()
    print_steps(label, probe.rows, gpu)
    ref = {"rows": probe.rows,
           "start": {k: v.float().cpu() for k, v in probe.start.items()}}
    del trainer, probe
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def run_orca_qwen_mesh(gpu: str, tmpdir: str) -> None:
    """31c.  The ORCA yaml of Qwen3-0.6B at full width (D=1024, L=28, the
    f32 cross-attention stack): 2 steps on one device, then 2 with fsdp on
    a (2, 1) mesh of virtual ranks of the card, on the same batches."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    cfg = config_from_yaml_file(QWEN_ORCA_CONFIG)
    model = DeSTA25AudioModel(cfg, device="cuda", seed=7,
                              tokenizer=CharTokenizer("qwen3"))
    start = {k: v.detach().clone()
             for k, v in flatten_tree(model.split_params()[0]).items()}
    ds, collate = train_data(cfg, model, tmpdir,
                             os.path.join(tmpdir, "train_wav.jsonl"))
    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=2, total_steps=100)
    ref = one_device_run("orca-qwen3 one device (31c)", model, ds, collate,
                         ocfg, os.path.join(tmpdir, "exp31c0"), 2, gpu,
                         start)
    restore_trainable(model, start)
    rows = mesh_train_run("orca-qwen3 (31c)", model, ds, collate, ocfg,
                          os.path.join(tmpdir, "exp31c"), 2, ref, gpu,
                          tol=TOL_TRAIN_MESH_SMALL, fsdp=True,
                          mesh_devices=["cuda:0"] * 2)
    for r in rows:
        m = r["metrics"]
        if not (m["L_ortho_diversity"] > 0 and m["L_ortho_qformer_local"] > 0):
            raise AssertionError(f"31c: aux {m}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def run_train_mesh(gpu: str, tmpdir: str, model, start, ref,
                   manifest: str) -> None:
    """31a-31c on one card: the flagship Q-Former model (from ``start``)
    at B=4 T=512 on a (2, 1) mesh of virtual ranks with fsdp and on a
    (1, 2) mesh, each held step by step against the one-device rows
    ``ref``; 31b two processes over gloo; 31c ORCA Qwen3-0.6B."""
    from desta25_audio_tpu_torch.train.optimizer import OptimizerConfig
    t0 = time.perf_counter()
    ocfg_kw = dict(lr=1e-4, warmup_steps=2, total_steps=100)
    ds, collate = train_data(model.config, model, tmpdir, manifest)
    for n_data, n_model, fsdp in ((2, 1, True), (1, 2, False)):
        restore_trainable(model, start)
        rows = mesh_train_run("flagship-train-mesh (31a)", model, ds, collate,
                              OptimizerConfig(**ocfg_kw),
                              os.path.join(tmpdir, f"exp31a{n_data}{n_model}"),
                              3, ref, gpu, mesh_model=n_model, fsdp=fsdp,
                              mesh_devices=["cuda:0"] * (n_data * n_model))
    t1 = time.perf_counter()
    # 32: GPipe and sequence parallelism, beside 31a's (1, 2) rows
    run_pipeline_sp(gpu, tmpdir, model, start, ref, ds, collate,
                    ["cuda:0"] * 4, rows)
    t2 = time.perf_counter()
    run_processes("flagship-train-processes (31b)", 2, tmpdir, manifest, gpu,
                  "gloo", False, model, start, ocfg_kw)
    t3 = time.perf_counter()
    run_orca_qwen_mesh(gpu, tmpdir)
    print(f"phase 31 took {time.perf_counter() - t0 - (t2 - t1):.1f} s (31a "
          f"{t1 - t0:.1f}, 31b {t3 - t2:.1f}, 31c "
          f"{time.perf_counter() - t3:.1f}) ({gpu})", flush=True)


def run_pipeline_sp(gpu: str, tmpdir: str, model, start, ref, ds, collate,
                    devices, tp_rows=None) -> None:
    """32.  The flagship Q-Former model (from ``start``) at B=4 T=512 on
    phase 23's batches, each step held against the one-device rows ``ref``
    by :func:`mesh_train_run` (lm_loss, grad_norm, the gradients at equal
    parameters, K11 M launches a one-device launch a rank) and against the
    same step without the option (:func:`same_steps`): (a) GPipe over a
    pipe of 2 stages (``devices[:2]``), 3 steps at ``pipeline_microbatches``
    2, then 2 at 4, against ``ref`` itself within TOL_TRAIN_PIPE (0: bit for
    bit); (b) dp x tp x pp on a (1, 2, 2) mesh of ``devices[:4]``, 2 steps
    at M = 2 (K11 at H/2 heads), against the (1, 2) steps without a pipe
    (``tp_rows``: phase 31a's; None: run here on ``devices[:2]``) within
    TOL_TRAIN_PIPE; (c) sequence parallelism on a (1, 2) mesh of
    ``devices[:2]``, 3 steps, against the same (1, 2) steps within
    TOL_TRAIN_SP (0), and both runs' peaks.  No torch path
    (``_build.fallback_counts()``) is taken.  ``devices``: ``["cuda:0"] *
    4`` (virtual ranks of one card), or four cards.  Prints the phase's
    seconds and what it left allocated on each card: PyTorch keeps a cuBLAS
    workspace for every stream that ran a GEMM, here each stage's, so the
    phase then frees those (``torch._C._cuda_clearCublasWorkspaces``) to
    leave the later phases' peaks as they were without it."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.optimizer import OptimizerConfig
    t0 = time.perf_counter()
    taken = _build.fallback_counts()
    cards = sorted({torch.device(d) for d in devices}, key=str)
    held = [torch.cuda.memory_allocated(c) for c in cards]
    ocfg_kw = dict(lr=1e-4, warmup_steps=2, total_steps=100)
    one = ref["rows"]
    ctl = abs(one[1]["metrics"]["lm_loss"] - one[0]["metrics"]["lm_loss"]
              ) / abs(one[0]["metrics"]["lm_loss"])

    def run(tag: str, steps: int, **kw):
        restore_trainable(model, start)
        return mesh_train_run(
            f"flagship-train-pipe ({tag})", model, ds, collate,
            OptimizerConfig(**ocfg_kw),
            os.path.join(tmpdir, f"exp{tag}_{len(kw)}"), steps, ref, gpu,
            **kw)

    def peaks(row) -> str:        # a mesh run's per card, one device's
        return " / ".join(f"{p:.2f}" for p in row.get("peaks_gib")
                          or [row["peak_gib"]])

    def same_steps(tag: str, rows, want, what: str, gate: float):
        for i, (r, w) in enumerate(zip(rows, want)):
            m, wm = r["metrics"], w["metrics"]
            errs = [abs(m[k] - wm[k]) / abs(wm[k]) for k in ("lm_loss",
                                                              "grad_norm")]
            errs.append(rel_l2(r["grads"], w["grads"]))
            print(f"flagship-train-pipe ({tag}) step {i + 1} ({gpu}): "
                  f"lm_loss {m['lm_loss']!r} grad_norm {m['grad_norm']!r}, "
                  f"{what} {wm['lm_loss']!r} / {wm['grad_norm']!r}: rel "
                  f"{errs[0]:.2e} / {errs[1]:.2e}, gradients {errs[2]:.2e} "
                  f"(gate {gate:g}; control, the one-device run's next "
                  f"batch, {ctl:.2e}); {r['ms']:.1f} ms against "
                  f"{w['ms']:.1f}, peak {peaks(r)} GiB against {peaks(w)}",
                  flush=True)
            if max(errs) > gate:
                raise AssertionError(f"{tag} step {i + 1}: parts from "
                                     f"{what}: {errs}")
    for M, steps in ((2, 3), (4, 2)):
        same_steps(f"32a, M={M}", run("32a", steps, mesh_pipe=2,
                                      pipeline_microbatches=M,
                                      mesh_devices=devices[:2]),
                   one, "one device", TOL_TRAIN_PIPE)
    if tp_rows is None:
        tp_rows = run("32c without sp", 3, mesh_model=2,
                      mesh_devices=devices[:2])
    same_steps("32b", run("32b", 2, mesh_model=2, mesh_pipe=2,
                          pipeline_microbatches=2, mesh_devices=devices[:4]),
               tp_rows, "the (1, 2) step", TOL_TRAIN_PIPE)
    same_steps("32c", run("32c", 3, mesh_model=2, sequence_parallel=True,
                          mesh_devices=devices[:2]),
               tp_rows, "without sequence parallelism", TOL_TRAIN_SP)
    if not ctl > 0.0:
        raise AssertionError("32: the control reads 0")
    new = {k: v - taken.get(k, 0) for k, v in _build.fallback_counts().items()
           if v != taken.get(k, 0)}
    if new:
        raise AssertionError(f"phase 32 took torch paths: {new}")
    left = [torch.cuda.memory_allocated(c) for c in cards]
    torch._C._cuda_clearCublasWorkspaces()
    after = [torch.cuda.memory_allocated(c) for c in cards]

    def gib(xs):
        return " / ".join(f"{(x - h) / 2 ** 30:+.3f}"
                          for x, h in zip(xs, held))
    print(f"phase 32 took {time.perf_counter() - t0:.1f} s, no torch path "
          f"taken; left allocated beyond what it found {gib(left)} GiB, "
          f"{gib(after)} once the cuBLAS workspaces are freed ({gpu})",
          flush=True)


def train_mesh_only(kind: str, count: int, gpu: str, cards: bool) -> int:
    """``--train-mesh-only``: phases 31 and 32 alone on a fresh flagship
    training model and corpus (its one-device reference run first);
    ``--cards``: on four cards instead, the flagship Q-Former at (4, 1) with
    fsdp and at (2, 2), four processes one a card over NCCL, phase 32 over
    the cards, and the flagship ORCA step with fsdp over the four cards
    beside its one-card run."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.train.optimizer import (OptimizerConfig,
                                                         flatten_tree)
    if cards and count < 4:
        raise SystemExit(f"--train-mesh-only --cards needs 4 cards, {count}")
    with tempfile.TemporaryDirectory() as d:
        manifest = write_corpus(d)
        cfg = config_from_yaml_file(CONFIG)
        model = DeSTA25AudioModel(cfg, device="cuda", seed=3,
                                  tokenizer=CharTokenizer("llama3"))
        start = {k: v.detach().clone()
                 for k, v in flatten_tree(model.split_params()[0]).items()}
        ds, collate = train_data(cfg, model, d, manifest)
        ocfg_kw = dict(lr=1e-4, warmup_steps=2, total_steps=100)
        ref = one_device_run("flagship-train one device", model, ds, collate,
                             OptimizerConfig(**ocfg_kw),
                             os.path.join(d, "exp0"), 3, gpu, start)
        if not cards:
            run_train_mesh(gpu, d, model, start, ref, manifest)
        else:
            cards4 = [f"cuda:{i}" for i in range(4)]
            for n_data, n_model, fsdp in ((4, 1, True), (2, 2, False)):
                restore_trainable(model, start)
                mesh_train_run("flagship-train-cards", model, ds, collate,
                               OptimizerConfig(**ocfg_kw),
                               os.path.join(d, f"exp{n_data}{n_model}"), 3,
                               ref, gpu, mesh_model=n_model, fsdp=fsdp,
                               mesh_devices=cards4)
            run_processes("flagship-train-processes-cards", 4, d, manifest,
                          gpu, "nccl", True, model, start, ocfg_kw,
                          batch_size=1)
            run_pipeline_sp(gpu, d, model, start, ref, ds, collate, cards4)
            del model, start
            gc.collect()
            torch.cuda.empty_cache()
            ocfg = config_from_yaml_file(ORCA_CONFIG)
            # the 9 GB f32 stack is not copied: the mesh run's model is
            # drawn again from the same seed
            orca = DeSTA25AudioModel(ocfg, device="cuda", seed=5,
                                     tokenizer=CharTokenizer("llama3"))
            ds, collate = train_data(ocfg, orca, d, manifest)
            oref = one_device_run("orca-train one card", orca, ds, collate,
                                  OptimizerConfig(**ocfg_kw),
                                  os.path.join(d, "expo0"), 2, gpu, None)
            del orca
            gc.collect()
            torch.cuda.empty_cache()
            orca = DeSTA25AudioModel(ocfg, device="cuda", seed=5,
                                     tokenizer=CharTokenizer("llama3"))
            mesh_train_run("orca-train-cards", orca, ds, collate,
                           OptimizerConfig(**ocfg_kw),
                           os.path.join(d, "expo4"), 2, oref, gpu,
                           tol=TOL_TRAIN_MESH_ORCA, fsdp=True,
                           mesh_devices=cards4)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


# -- phase 33: the flagship training setup, Qwen3-4B at full depth ----------

QWEN4B_CONFIG = "configs/desta25_qwen3-4B_Qformer6L.yaml"
QWEN4B_ORCA_CONFIG = "configs/desta25_qwen3-4b_ORCAHybrid.yaml"


def run_flagship_setups(gpu: str) -> None:
    """33a-33b: ``train/bench_utils.build_flagship_train_setup`` as a
    benchmark would call it (B=12, T=300, the int8 tower at random, remat,
    Adafactor): ``hbm_analysis``, then three steps, each gated."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    from desta25_audio_tpu_torch.train.bench_utils import (
        build_flagship_train_setup, hbm_analysis)
    from desta25_audio_tpu_torch.train.optimizer import flatten_tree
    for tag, mode in (("33a", "qformer_1"), ("33b", "orca_hybrid")):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, step, tr, layout, st, batch = build_flagship_train_setup(
            connector_mode=mode)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        lcfg = cfg.llm_config
        leaves = flatten_tree(tr)
        kinds = sorted({str(t.dtype).replace("torch.", "")
                        for t in leaves.values()})
        print(f"{tag}. build_flagship_train_setup(connector_mode={mode!r}): "
              f"{cfg.llm_model_id} int8, {lcfg.num_hidden_layers} layers, "
              f"D={lcfg.hidden_size}; whisper-large-v3 bf16; trainable "
              f"{sum(t.numel() for t in leaves.values()) / 1e9:.3f} B "
              f"parameters in {kinds}; batch "
              f"{tuple(batch['input_ids'].shape)}; built in {built:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
              f"({gpu})", flush=True)
        torch.cuda.reset_peak_memory_stats()
        hbm = hbm_analysis(step, tr, layout, st, batch)
        hbm_peak = torch.cuda.max_memory_allocated() / 2**30
        if set(hbm) != {"argument_gb", "temp_gb", "output_gb"} or not all(
                v > 0 for v in hbm.values()):
            raise AssertionError(f"{tag}: hbm_analysis {hbm}")
        start = {k: t.detach().to("cpu", copy=True)
                 for k, t in leaves.items()}
        rows = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            tr, st, m = step(tr, layout, st, batch)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "launches": _build.launch_counts(),
                         "taken": _build.fallback_counts(),
                         "metrics": {k: float(v) for k, v in m.items()}})
        for i, r in enumerate(rows):
            print(f"{tag} step {i + 1} ({gpu}): {r['ms']:.1f} ms, peak "
                  f"{r['peak_gib']:.2f} GiB allocated; metrics "
                  f"{json.dumps(r['metrics'])}; launches "
                  f"{json.dumps(r['launches'])}; torch paths taken "
                  f"{json.dumps(r['taken'])}", flush=True)
            check_train_row(f"{tag} step {i + 1}", r, (
                "log_mel", "packed_encoder_attention", "encoder_ffn"))
            if not np.isfinite(r["metrics"]["lm_loss"]):
                raise AssertionError(f"{tag}: lm_loss {r['metrics']}")
            if r["launches"].get("flash_attention", 0) \
                    or r["launches"].get("flash_attention_bwd", 0):
                raise AssertionError(f"{tag}: K11 launched at T=300")
            if r["taken"]:
                raise AssertionError(f"{tag}: torch paths taken {r['taken']}")
            if mode == "orca_hybrid" and not (
                    r["metrics"]["L_ortho_diversity"] > 0
                    and r["metrics"]["L_align_layerwise"] == 0.0):
                raise AssertionError(f"{tag}: aux terms {r['metrics']}")
        if rows[1]["metrics"]["loss"] != rows[0]["metrics"]["loss"]:
            raise AssertionError(f"{tag}: step 2's loss differs from step 1's"
                                 " (lr 0 at count 0)")
        # step 2 updated the trainable tree (lr 1e-6 at count 1 of a
        # 100-step warmup): step 3 reads it, and each part moved
        if rows[2]["metrics"]["loss"] == rows[1]["metrics"]["loss"]:
            raise AssertionError(f"{tag}: step 3's loss equals step 2's")
        moved = {}
        for k, t in flatten_tree(tr).items():
            part = k.split("/")[0]
            n = moved.setdefault(part, [0, 0])
            n[0] += int((t != start[k].to(t.device)).sum())
            n[1] += t.numel()
        shares = {p: n[0] / n[1] for p, n in moved.items()}
        print(f"{tag}: the share of each part's elements that steps 2-3 "
              f"moved {json.dumps(shares)}; loss {rows[1]['metrics']['loss']}"
              f" -> {rows[2]['metrics']['loss']}", flush=True)
        if not all(v > 0 for v in shares.values()):
            raise AssertionError(f"{tag}: a trainable part did not move "
                                 f"{shares}")
        total = sum(hbm.values())
        print(f"{tag}: hbm_analysis {json.dumps(hbm)}, sum {total:.2f} GiB, "
              f"beside the peak of its step {hbm_peak:.2f} GiB (its clones of"
              f" the trainable tree and state included) and the timed steps' "
              f"peaks {[round(r['peak_gib'], 2) for r in rows]} GiB; ms a "
              f"step after the first {rows[1]['ms']:.1f}, {rows[2]['ms']:.1f}"
              f" ({gpu})", flush=True)
        del cfg, step, tr, layout, st, batch, leaves, m, start
    gc.collect()
    torch.cuda.empty_cache()


def generate_gate(tag: str, model, convs, out, control: bool) -> float:
    """``out``'s greedy ids, each up to its row's first terminator, the
    layer loop's argmax teacher-forced (:func:`teacher_forced_logits` with
    ``loop``) or within TOL_ENGINE_MARGIN of it (``top_less``); with
    ``control`` the ids moved to the next id of the vocabulary must not
    be.  Returns the worst margin."""
    import torch
    ids = np.asarray(out.generated_ids)
    live = np.ones(ids.shape, bool)
    for r, row in enumerate(ids):
        ends = np.flatnonzero(np.isin(row, model._terminators()))
        if ends.size:
            live[r, ends[0] + 1:] = False
    if isinstance(convs[0], dict):
        convs = [convs]                                # one conversation

    def margins(y):
        y = torch.as_tensor(y, dtype=torch.long, device=model.device)
        with torch.no_grad():
            lg = teacher_forced_logits(model, convs, y, loop=True)
        m = top_less(lg.reshape(-1, lg.shape[-1]), y.T.reshape(-1))
        return m.reshape(y.shape[1], -1).T.cpu().numpy()[live]
    m = margins(ids)
    worst = float(m.max())
    parted = sorted((round(float(v), 4) for v in m if v > 0), reverse=True)
    msg = (f"{tag}: teacher-forced gate over {int(live.sum())} ids: "
           f"{int(live.sum()) - len(parted)} the layer loop's argmax, the "
           f"others at margins {parted[:16]} (worst {worst:.4f}, tol "
           f"{TOL_ENGINE_MARGIN})")
    if control:
        ctl = float(margins((ids + 1) % model.llm_cfg.vocab_size).max())
        msg += f"; control (each id + 1) {ctl:.4f}"
        if ctl <= TOL_ENGINE_MARGIN:
            raise AssertionError(f"{tag}: the gate passes the control")
    print(msg, flush=True)
    if worst > TOL_ENGINE_MARGIN:
        raise AssertionError(f"{tag}: a greedy id is {worst} below the "
                             "layer-loop reference's argmax")
    return worst


def run_generate_qwen4b(gpu: str, label: str, model, convs, must,
                        must_not=()):
    """33c, one tower: generate() b2 and b1, greedy, 32 new tokens, after a
    warm-up: the decode through its graph, ``must`` launched and
    ``must_not`` not in each run, no torch path taken; the ids checked
    (shape and range, the first two against a step-by-step run, all of
    them by the teacher-forced gate, the b2 run beside its control); ms a
    step and peak memory printed.  Returns the launch counts summed over
    the two runs."""
    import torch
    from desta25_audio_tpu_torch.ops import _build
    runs = {2: convs[:2], 1: convs[2]}
    model.generate(runs[2], do_sample=False, max_new_tokens=2)   # warm-up
    outs, times, total = {}, {}, {}
    for b, msgs in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        outs[b] = model.generate(msgs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {**_build.launch_counts(), **_build.kernel_counts()}
        times[b] = dict(model.last_timings)
        print(f"{label} b{b}: launches during generate() "
              f"{json.dumps(counts)}; peak {peak:.2f} GiB allocated ({gpu})",
              flush=True)
        require_graph_replays(f"{label} b{b}", counts, times[b])
        require_kernel_paths(f"{label} b{b}")
        for name in must:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{label} b{b}: {name} not launched")
        for name in must_not:
            if counts.get(name, 0):
                raise AssertionError(f"{label} b{b}: {name} launched")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    check_outputs(model, [(outs[b], b) for b in runs])
    check_step_by_step(model, runs[2], outs[2])
    for b, msgs in runs.items():
        generate_gate(f"{label} b{b}", model, msgs, outs[b], control=b == 2)
        add_margins(model, msgs, outs[b])
    print(f"{label} generated ids b2 row0[:8]={shown(outs[2], 0)} "
          f"b1[:8]={shown(outs[1], 0)}", flush=True)
    print_times(label, sorted(times.items()), gpu)
    return total


def run_qwen4b_generate(gpu: str, wavs) -> dict:
    """33c: both Qwen3-4B yamls at all 36 layers, random weights from a
    seed, the int8 encoder: the Q-Former config with the bf16 LLM (K8),
    then the same model after ``apply_llm_quant()`` (K8-int8, K7 on the
    tied int8 head), then the ORCA config on that encoder and int8 LLM
    with ``apply_orca_xattn_quant()`` (K8i at injection head dim 80).
    Returns each tower's launch counts."""
    import torch
    from desta25_audio_tpu_torch import DeSTA25AudioModel
    from desta25_audio_tpu_torch.config import config_from_yaml_file
    from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
    from desta25_audio_tpu_torch.models.orca import (init_orca_connector,
                                                     init_orca_cross_attns)
    from desta25_audio_tpu_torch.ops.fused_decode import fused_decode_limits
    from desta25_audio_tpu_torch.ops.quant import is_quantized
    cfg = config_from_yaml_file(QWEN4B_CONFIG)
    tok = CharTokenizer("qwen3")
    t0 = time.perf_counter()
    with torch.no_grad():
        model = DeSTA25AudioModel(cfg, device="cuda", seed=33, tokenizer=tok)
        model.apply_inference_encoder_quant()
    torch.cuda.synchronize()
    lcfg = model.llm_cfg
    print(f"33c. {QWEN4B_CONFIG}: {lcfg.model_id}, {lcfg.num_hidden_layers} "
          f"layers, D={lcfg.hidden_size}, {lcfg.num_attention_heads} q / "
          f"{lcfg.num_key_value_heads} kv heads of {lcfg.head_dim}, "
          f"F={lcfg.intermediate_size}, tied vocabulary {lcfg.vocab_size}; "
          f"built on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)
    for b in (1, 2):
        bad = fused_decode_limits(model.params["llm"], lcfg, torch.bfloat16,
                                  b, 1, 256)
        if bad:
            raise AssertionError(f"fused_decode_limits refuses Qwen3-4B "
                                 f"b{b}: {bad}")
    convs = conversations(wavs)
    counts = {}
    counts["bf16"] = run_generate_qwen4b(
        gpu, "Qwen3-4B bf16 LLM", model, convs,
        ("log_mel", "encoder_ffn_w8a8", "fused_decode_layers"),
        ("fused_decode_layers_int8",))
    t0 = time.perf_counter()
    with torch.no_grad():
        model.apply_llm_quant()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    head = model.params["llm"]["lm_head"]
    if not (is_quantized(model.params["llm"]["layers"]["w_gu"])
            and head["q"].shape[0] == 153600):
        raise AssertionError(f"apply_llm_quant: head {head['q'].shape}")
    print(f"Qwen3-4B LLM quantized in place in {time.perf_counter() - t0:.1f}"
          f" s (the tied head int8, {head['q'].shape[0]} rows; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)
    counts["int8"] = run_generate_qwen4b(
        gpu, "Qwen3-4B int8 LLM", model, convs,
        ("log_mel", "encoder_ffn_w8a8", "fused_decode_layers_int8",
         "quant_matmul"), ("fused_decode_layers",))
    ocfg = dataclasses.replace(config_from_yaml_file(QWEN4B_ORCA_CONFIG),
                               llm_quant="int8")
    t0 = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(34)
    with torch.no_grad():
        params = {"whisper": model.params["whisper"],
                  "llm": model.params["llm"],
                  "connector": init_orca_connector(ocfg, torch.float32,
                                                   "cuda", g),
                  "orca_cross_attns": init_orca_cross_attns(
                      ocfg, getattr(torch, ocfg.orca_xattn_dtype), "cuda",
                      g)}
        orca = DeSTA25AudioModel(ocfg, device="cuda", params=params,
                                 tokenizer=tok)
        del model, params
        orca.apply_orca_xattn_quant()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{QWEN4B_ORCA_CONFIG}: the ORCA model on that encoder and int8 "
          f"LLM, its {orca.config.orca_xattn_dtype} stack quantized to int8 "
          f"(injection head dim {lcfg.hidden_size // lcfg.num_attention_heads}"
          f"), in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)",
          flush=True)
    counts["orca"] = run_generate_qwen4b(
        gpu, "Qwen3-4B ORCA int8 stack", orca, convs,
        ("log_mel", "encoder_ffn_w8a8", "fused_decode_inject",
         "fused_decode_layers_int8", "quant_matmul") + INJECT_KERNELS,
        ("fused_decode_layers",))
    del orca
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def run_phase33(gpu: str, wavs) -> None:
    """Phase 33 (33a-33c)."""
    t0 = time.perf_counter()
    run_flagship_setups(gpu)
    counts = run_qwen4b_generate(gpu, wavs)
    keys = ("fused_decode_layers", "fused_decode_layers_int8",
            "fused_decode_inject", "quant_matmul", "decode_graph")
    print("33c: launches over b2 + b1 (" + gpu + "): " + "; ".join(
        f"{label} {json.dumps({k: c.get(k, 0) for k in keys})}"
        for label, c in counts.items()), flush=True)
    print(f"phase 33 took {time.perf_counter() - t0:.1f} s ({gpu})",
          flush=True)


def main() -> int:
    if "--train-worker" in sys.argv[1:]:
        return train_worker(sys.argv[sys.argv.index("--train-worker") + 1])
    t_start = time.perf_counter()
    # -- 1. environment ------------------------------------------------------
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    import torch
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # -- 2. the card is required --------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a GPU")
    from desta25_audio_tpu_torch.ops import _build
    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc}: {ver[-1]}", flush=True)
    print(f"triton importable: "
          f"{importlib.util.find_spec('triton') is not None}", flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}", flush=True)

    # -- 3. build -----------------------------------------------------------
    path, secs = _build.build()
    _build.library()
    print(f"kernels built in {secs:.1f} s: {path}", flush=True)
    if "--mesh-only" in sys.argv[1:]:
        return mesh_only(kind, count, gpu, "--cards" in sys.argv[1:])
    if "--train-mesh-only" in sys.argv[1:]:
        return train_mesh_only(kind, count, gpu, "--cards" in sys.argv[1:])
    if "--phase30-only" in sys.argv[1:]:
        # phase 30 alone, for work on the decoders, the loader and LoRA
        with tempfile.TemporaryDirectory() as d:
            run_phase30(gpu, d, write_wavs(d)[0])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if "--phase33-only" in sys.argv[1:]:
        # phase 33 alone, for work on the training setup and Qwen3-4B
        with tempfile.TemporaryDirectory() as d:
            run_phase33(gpu, write_wavs(d)[0])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if "--http-rounds" in sys.argv[1:]:
        n = int(sys.argv[sys.argv.index("--http-rounds") + 1])
        http_rounds(gpu, n)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": count}}))
        return 0

    # -- 4. kernels vs plain at the slice shapes -----------------------------
    # (the synthetic WAVs of phase 6 are written first: K1 reads them)
    tmp = tempfile.TemporaryDirectory()
    wavs, signals = write_wavs(tmp.name)
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        # its own generator: the other kernels' inputs stay as they were
        k1, mel_ms = check_mel(torch.Generator("cuda").manual_seed(6),
                               signals)
        k2 = check_enc_attention(gen)
        # each its own generator, so that gen's draws for K8 below do not
        # depend on the rows the GEMMs are checked at
        check_gemm_clusters()
        k3 = check_enc_ffn(torch.Generator("cuda").manual_seed(9))
        w8 = check_w8a8(torch.Generator("cuda").manual_seed(1))

        # -- 5. flagship model, random weights ------------------------------
        from desta25_audio_tpu_torch import DeSTA25AudioModel
        from desta25_audio_tpu_torch.config import config_from_yaml_file
        from desta25_audio_tpu_torch.data.tokenizer import CharTokenizer
        from desta25_audio_tpu_torch.models.desta import _CharASR
        cfg = config_from_yaml_file(CONFIG)
        t0 = time.perf_counter()
        model = DeSTA25AudioModel(cfg, device="cuda", seed=0,
                                  tokenizer=CharTokenizer("llama3"))
        # ASR's detokenizer: whisper-large-v3's BPE files are not in the
        # repo, so ids below 128 read as characters (the test/ encoders' rule)
        model._whisper_tokenizer = _CharASR()
        torch.cuda.synchronize()
        print(f"flagship model built on the card in "
              f"{time.perf_counter() - t0:.1f} s "
              f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)",
              flush=True)
        k8 = check_fused_decode(model.params["llm"], model.llm_cfg, gen)

    # -- 6-9. bf16 generate() through the kernels ---------------------------
    convs = conversations(wavs)
    # one short warm-up call: the first generate() pays one-time CUDA
    # library set-up (cuBLAS/cuDNN handles, convolution algorithm)
    model.generate(convs[:2], do_sample=False, max_new_tokens=2)
    launches = {}
    for b, msgs in ((2, convs[:2]), (1, convs[1])):
        _build.reset_launch_counts()
        out = model.generate(msgs, do_sample=False, max_new_tokens=32)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        print(f"launches during generate() b{b}: {json.dumps(counts)}",
              flush=True)
        require_kernel_paths(f"bf16 b{b}")
        require_graph_replays(f"bf16 b{b}", counts, model.last_timings)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        if b == 2:
            out2, t2 = out, dict(model.last_timings)
        else:
            out1, t1 = out, dict(model.last_timings)
    for name in BF16_PATH:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched by generate()")
    check_outputs(model, ((out2, 2), (out1, 1)))
    check_step_by_step(model, convs[:2], out2)
    add_margins(model, convs[:2], out2)
    add_margins(model, convs[1], out1)
    print(f"generated ids b2 row0[:8]={shown(out2, 0)} "
          f"b1[:8]={shown(out1, 0)}", flush=True)
    print_times("bf16 encoder", ((2, t2), (1, t1)), gpu)
    # -- 9b. the b2 decode through the graph against the eager step ---------
    with torch.no_grad():
        check_decode_graph(model, convs[:2], "bf16 LLM", gpu)

    # -- 10-12. the int8 (W8A8) inference encoder ----------------------------
    # (the bf16 encoder is kept for 12a's bf16 ASR call)
    bf16_enc = model.params["whisper"]["encoder"]
    with torch.no_grad():
        int8_launches, enc_times = check_int8_encoder(model, signals, convs,
                                                      gpu)
    for b, (k_ms, p_ms) in mel_ms.items():
        perc = enc_times[b]["perception_ms"]
        print(f"K1 share of perception_ms at b{b} (int8 encoder, {gpu}): "
              f"{k_ms / perc:.4f} with the kernel ({k_ms:.4f} of {perc:.1f} "
              f"ms), {p_ms / (perc - k_ms + p_ms):.4f} with the plain "
              f"version ({p_ms:.4f} ms in its place)", flush=True)

    # -- 12a-12e. Whisper ASR in generate() -----------------------------------
    t_asr = time.perf_counter()
    run_asr(model, bf16_enc, convs, signals, gpu, tmp.name)
    del bf16_enc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ASR phases 12a-12e took {time.perf_counter() - t_asr:.1f} s",
          flush=True)

    # -- 12f. the serving engine on the bf16 tower ----------------------------
    t_eng = time.perf_counter()
    run_engine_bf16(model, wavs, gpu)
    engine_s = time.perf_counter() - t_eng

    # -- 13. the int8 LLM's kernels vs plain, on a quantized copy ------------
    from desta25_audio_tpu_torch.ops.quant import quantize_llm_params
    with torch.no_grad():
        gen8 = torch.Generator("cuda").manual_seed(2)
        k8v_bf16 = check_fused_decode(model.params["llm"], model.llm_cfg,
                                      gen8, kd=4, ci=(100, 252), tag="K8v")
        qllm = quantize_llm_params(model.params["llm"])
        llm8 = check_int8_matmuls(qllm, gen8)
        llm8["fused_decode_layers_int8"] = check_fused_decode(
            qllm, model.llm_cfg, gen8, tag="K8-int8")
        k8v = check_fused_decode(qllm, model.llm_cfg, gen8, kd=4,
                                 ci=(100, 252), tag="K8v")
        llm8["fused_verify_layers"] = (max(k8v[0], k8v_bf16[0]),) + k8v[1:]
        k9, _ = check_fused_tp(qllm, model.llm_cfg, gen8)
        del qllm
        k8_attn = check_decode_attention(
            torch.Generator("cuda").manual_seed(7))
        k_gemm = check_skinny_gemm(torch.Generator("cuda").manual_seed(8))
        k_rms = check_rms_norm(torch.Generator("cuda").manual_seed(10))

        # -- 14-16. the int8 LLM in generate(), plain and speculative -------
        llm_launches, spec_launches, _, attn_launches = run_int8_llm(
            model, convs, gpu)

    # -- 16a-16g. the serving engine on the int8 encoder and LLM -------------
    t_eng = time.perf_counter()
    run_engine(model, wavs, gpu)
    engine_s += time.perf_counter() - t_eng
    with torch.no_grad():

        # -- 17. K8i vs plain; 18-20. ORCA generate() ------------------------
        k8i, k8i_attn, k8i_gate = check_fused_inject(
            model, torch.Generator("cuda").manual_seed(4))
        inject_launches, inject_kernels, k9_launches = run_orca(model, convs,
                                                               gpu)

        # -- 20a-20c. tensor-parallel decode on virtual ranks of the card ----
        mesh_rows, mesh_launches = run_mesh(model, convs, gpu)

    # -- 21. K11 vs plain at the training shape ------------------------------
    k11 = check_flash(torch.Generator("cuda").manual_seed(5))

    # -- 22-24. training, after the serving models are freed -----------------
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = run_training(gpu, tmp.name)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 25. the debug config and a long cache: the torch paths -------------
    run_debug_config(gpu, tmp.name)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 26. ORCA training at full width --------------------------------------
    run_orca_training(gpu, tmp.name)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 27. int8 weights quantized on the card against the CPU -------------
    with torch.no_grad():
        check_quant_on_card(torch.Generator("cuda").manual_seed(27))

    # -- 28-29. checkpoints: HF snapshots staged and loaded at full size -----
    run_checkpoints(gpu, tmp.name, wavs)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 30. native decoders, the prefetching loader, LoRA -------------------
    run_phase30(gpu, tmp.name, wavs)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 33. the flagship training setup; Qwen3-4B at full depth -------------
    run_phase33(gpu, wavs)
    tmp.cleanup()
    print(f"total {time.perf_counter() - t_start:.1f} s (the serving engine's "
          f"phases 12f and 16a-16g: {engine_s:.1f} s)", flush=True)

    # K2's entry: the worse error of its two shapes, the times, bound and
    # scaled_dot_product_attention time of the self-attention shape; K8's:
    # the 2-layer logits error, the 32-layer step times; K4-K6: the worse
    # error of M=1500/3000, the M=3000 times; K7: the worst error of the
    # M=2 head and the M=125 layer shapes, the head's times (library_ms:
    # torch._weight_int8pack_mm on the same operands); its wgmma path
    # (quant_matmul_prefill): the worst error of its 32 checks, one layer's
    # four shapes at M=121 over the 32 layers' weights
    # (library_ms alike, its launches the kernel count of phase 15's int8
    # generate() runs); W8A8 (LLM): the worst error, one layer's four shapes at
    # M=250; K8-int8 and K8v (int8 tower; error the worse of both towers):
    # as K8; K8i: the worst of its four checks, the Llama Kd=1 step times;
    # its attention and gate: the worst error of their shapes, the b2
    # decode times (the attention's library_ms: SDPA over the same q and
    # audio K/V), their kernel counts in the ORCA runs of phases 19-20.
    # Launches: K2, K3, K8 from the bf16 generate() run, K4-K6 from the
    # int8-encoder runs, K7, W8A8 and K8-int8 from the int8-LLM runs, K8v
    # from the speculative run, K8i from the ORCA runs of phases 19-20; K11
    # (forward and backward: the worse error of the output, resp. dq/dk/dv,
    # at T=512, the T=512 times, bound and SDPA time) from the trainer run
    # of phase 23; K1 (the worst of its three checks, the B=2 x 3000 x 128
    # times) from the bf16 generate() runs; K9's halves (the worst per-layer
    # error, layer 0's times at B=2) from phase 18's opt-in float-stack run;
    # K10 (the worst 2-layer error of phase 20b, the p=2 32-layer times,
    # library_ms null: NCCL cannot put two ranks on one card) and
    # tp_allreduce (phase 20a: the worst error, the p=2 R=2 reduce's times)
    # from phase 20c's generate() under the mesh.
    # Each tuple: (err, ms, plain_ms, bound_ms, bound_by[, library_ms]).
    measured = {"packed_encoder_attention":
                (max(k2[0][0], k2[1][0]),) + k2[0][1:],
                "encoder_ffn": k3, "fused_decode_layers": k8, **w8, **llm8,
                "fused_decode_inject": k8i, "inject_attention": k8i_attn,
                "inject_gate": k8i_gate, **k11, "log_mel": k1, **k9,
                **mesh_rows, "decode_attention": k8_attn,
                "skinny_gemm": k_gemm, "rms_norm": k_rms}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        row = measured[name]
        counts = (int8_launches if name in W8A8_KERNELS
                  else llm_launches if name in INT8_LLM_KERNELS
                  else spec_launches if name == "fused_verify_layers"
                  else {name: inject_launches}
                  if name == "fused_decode_inject"
                  else inject_kernels if name in INJECT_KERNELS
                  else train_launches if name in train_launches
                  else k9_launches if name in K9_HALVES
                  else mesh_launches if name in mesh_rows
                  else attn_launches if name in ("decode_attention",
                                                 "skinny_gemm", "rms_norm")
                  else launches)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": row[0], "ms": row[1],
                        "plain_ms": row[2], "bound_ms": row[3],
                        "bound_by": row[4],
                        "library_ms": row[5] if len(row) > 5 else None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
