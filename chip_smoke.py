#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                       # on the card, full width
    python3 chip_smoke.py --device cpu --tiny   # rehearsal with plain versions
                                                # (llama32_1b.smoke() for the LLM)

Phases, each of which raises on failure (nothing is caught):

1. Card and build: the card's name, capability (must be 9.0) and power
   limit; the kernels built from ``src/repro_torch/csrc/*.cu`` with nvcc,
   with ptxas' register / shared-memory / spill lines per kernel (K1's, K4's
   and K11's bf16 body's registers and spills by name).
2. The launch floor (a CUDA graph of one-element ``zero_()`` calls, timed as
   the kernels are), then every kernel against its plain PyTorch version on
   the same CUDA tensors at the shapes the main path gives it, with its
   time, its bound and the plain version's time; then the kernels' general
   paths (K != 8, ragged tiles, rows without candidates) and the fused and
   candidate-matrix kernels' (K5/K6, K2/K3) bit-invariance across row and
   candidate buckets. K1 must equal its plain version bit for bit also on a
   ragged last block, rows 0 and V-1, 2-D indices, rows of 40 and 15 codes
   and codes off alignment; K4 must agree with its plain version on
   ``test_kernels.py``'s sweep and at F = 64, K = 16 in f32 and bf16 (that
   test's tolerances), and give D == D^T bit for bit at the main shape.
   K5/K6 must give the same bits through unaligned strided views (their
   scalar path) as through the aligned ones, and agree with their plain
   versions at Fc = 64, F = 128 (past their register slots); the digest of
   their main-bucket outputs is printed, to compare builds run by run.
   The wire-quantization kernels K7-K9
   run over the whole DeepFFM weight space (~50.6 M weights) and must match
   exactly (min/max, codes and floats bit for bit); then again over
   llama3.2-1b's weight space (1,237,387,264 weights: f32 byte offsets past
   2^32, the codes' past 2^31; the grid's bounds and tie points at both
   ends), bit for bit, timed in ``WIRE_BIG_ITERS`` eager calls, records
   under the main records' ``"llama"``. K10, the §4.3 block-skip
   weight gradient, runs at the trainer's two hidden-layer shapes (one
   microbatch's pair of launches) and on ``test_kernels.py``'s sweep plus
   B = 129 / 1000 / 100 at both layer widths (rtol 1e-4, atol 1e-4), gives
   exact zeros for an all-zero gradient (also where x is NaN: a skipped
   block adds nothing, in the first block and in rows 256-383 of a 512
   batch), and is bit-identical from launch
   to launch; ``torch.matmul(x.T, g)`` is timed beside it, per layer. K11, flash
   attention, runs at one prefill layer's shape (B=4, S=1024, 32 query and
   8 KV heads, D=64, causal) in bf16 (the TMA + wgmma body; 3e-2, and
   within bf16's roundoff bounds per element and per row) and f32 (the
   CUDA-core body; 2e-5), then on ``FLASH_SWEEP`` in both dtypes
   (``test_kernels.py``'s sweep, D=128, ragged tiles, S below one tile,
   windows); ``scaled_dot_product_attention`` is timed beside it as the
   library yardstick, never used on the path, and K11's time is printed as
   a multiple of it. Phase 1 prints the bf16 body's ptxas registers and
   spills per head dim. The other families' prefill layers at D = 128 run
   the same way in bf16 (B=4, S=1024; 32 / 8 heads, phi3.5-moe and
   granite-8b, and 16 / 2, qwen2.5-3b), the 8:1 one also in f32; their
   records ride on the main shape's (``"d128"``). seamless-m4t's attention
   (16 / 16 heads of 64, B=4) runs in bf16 and f32 at ``FLASH_SEAMLESS``'
   shapes: unmasked Sq = Sk = 1024 (the encoder), Sq = 256 and Sq = 1
   against Sk = 1024 (the cross-attention of the forward and of a decode
   step), and Sq != Sk under the causal mask aligned at position 0; each
   timed beside scaled_dot_product_attention with its bound, records under
   the main record's ``"seamless"``. zamba2-7b's shared attention block
   (32 / 32 heads of 112, B=4, S=1024, causal) runs the D = 112 instance in
   bf16 and f32 (records under ``"d112"``), and beside it the route not
   taken: q, k and v zero-padded to D = 128 on the host, K11 at 128 with
   scale 112^-1/2, the output sliced back, held to the plain version and
   timed with its pads. deepseek-v2-236b's MLA prefill (128 / 128 heads,
   qk / v head dims 192 / 128, B=4, S=1024, causal, v at its own width)
   runs the (192, 128) instance in bf16 and f32, and the smoke config's
   (48, 32) runs on a small shape (B=2, S=256, 4 / 4 heads), each timed
   beside SDPA (which takes v at its own width too), records under
   ``"mla"``; both pairs also join the sweep (``FLASH_MLA_SWEEP``). Every
   K11 record also has the kernel timed alone (``kernel_ms``: calls queued
   behind a device spin, so the launch path drops out), and SDPA's the
   same way. Then flash attention's backward, K13 (dQ) and K12 (dK, dV),
   the port's own kernels, at ``FLASH_BWD``'s shapes in bf16 and f32
   (llama3.2-1b's train step, the main record; D = 128; D = 112;
   deepseek-v2's (192, 128) at (4, 1024, 128 / 128); (48, 32); seamless'
   unmasked Sq = 256 against Sk = 1024; a window; (16, 16) and (32, 32), so
   every pair of ``ops.HEAD_DIMS`` runs): K11's log-sum-exp
   output first, against the plain one within ``LSE_TOL`` (1 + |lse|);
   then the gradients against the plain backward on K11's output and
   log-sum-exp (f32 within ``BWD_REL`` of each gradient's largest |value|;
   bf16, whose wgmma bodies round P and dS to bf16 before their products,
   per element within 2u (A + |g|) + ``BWD_REL`` max |g|, A the same
   products on absolute values, ``ref.flash_attention_bwd_abs_ref``), a
   repeat call bit-identical, the body that ran named (``ops.BWD_BODIES``);
   each kernel timed alone beside its bound, the plain backward and the
   backward alone of autograd through ``scaled_dot_product_attention`` (the
   yardstick, never on the path). Phase 1 prints both bodies' ptxas
   registers and spills per pair and their shared memory. K11's training
   instance (the log-sum-exp written) is timed at llama's shape beside its
   bound (the lse's bytes counted), the plain version with lse and
   scaled_dot_product_attention's forward under grad (record "lse" on the
   main K11 record).
3. The LLM families first, while the card's memory is free, at full width
   with bf16 weights from the seed, one server at a time, each freed before
   the next:
   - granite-8b, yi-6b, qwen2.5-3b and chameleon-34b at full depth (the
     run fails if a model's weights, cache and ``FAMILY_MARGIN_BYTES`` do
     not fit the free memory; every depth is printed as "n of N layers"):
     ``LLMServer.generate`` on
     4 prompts of 1024 tokens, 16 new, after one warm-up call; K11 exactly
     once per layer; tokens in range and equal to the warm-up's; prefill
     ms, decode ms per step and peak allocation printed.
   - phi3.5-moe at 16 of 32 layers (the full 83.8 GB does not fit):
     ``generate`` on 4 prompts of 128 tokens by the stepwise warm-up, K11
     never; then ``transformer.prefill`` on the same prompts, K11 once per
     layer.
   - The f32 oracle of each of the five at 2 layers (B=2, P=64): the
     prefill's last logits and cache (through K11) against stepwise
     ``decode_step``s (never through K11), rel < ``ORACLE_REL``. For phi
     the routers are watched on both paths: the smallest gap between the
     k-th and (k+1)-th probability and the tokens whose chosen experts
     differ are printed; such a token fails where the gap exceeds
     ``ROUTER_TIE``.
   - The int8 cache on a 2-layer qwen2.5-3b: ``generate`` by the stepwise
     warm-up (K11 never); k / v int8; the last logits of stepwise decode
     over 4 x 128 prompt tokens within ``INT8_REL`` of the native cache's.
   - seamless-m4t-large-v2 (``encdec``) at full width in bf16, 24 + 24
     layers uncut: ``encdec.prefill_cross`` on 4 x 1024 seeded stub frames,
     then 32 greedy steps through ``make_serve_step`` (after one warm-up of
     both; the tokens must equal the warm-up's), then a teacher-forced
     ``forward`` at S_tgt = 256; K11 exactly 24 / 24 a step / 72 times
     (once per encoder layer; once per decoder layer and step, Sq = 1; the
     encoder, the decoder's causal self-attention and its cross-attention,
     Sq = 256 against Sk = 1024); prefill_cross ms and its TFLOP/s, ms per
     decode step, peak allocation. Its f32 oracle at 2 + 2 layers (B=2,
     S_src=64, S_tgt=32): decode after ``prefill_cross`` against the
     forward at every position, and the run through K11 against the same
     run with ``attention.flash_attention``'s kernel call swapped for its
     plain version (which must launch nothing), each rel < ``ORACLE_REL``.
   - mamba2-130m (``ssm``, 24 layers) and zamba2-7b (``hybrid``, 81
     positions: 13 super-blocks of 5 Mamba2 blocks and the shared attention
     block, then 3 tail blocks; 5.78 G parameters) at full width in bf16,
     uncut, one at a time (the run fails if the weights, the SSD scan's
     f32 blocks and ``FAMILY_MARGIN_BYTES`` do not fit the free memory):
     ``registry.forward`` on 4 x 1024 tokens (after one warm-up call), K11
     exactly once per super-block (13 for zamba2, each call at (4, 1024,
     32, 112) causal; none for mamba2); ``LLMServer.generate`` on 4 prompts
     of 16 tokens, 16 new, by the stepwise warm-up (K11 never), the tokens
     equal to the warm-up's; forward ms, warm-up and decode ms per step,
     peak allocation; one forward and one decode step under the profiler
     (kernels per step). Their f32 oracle at full width and reduced depth
     (mamba2 2 layers, zamba2 one super-block and one tail block; B=2,
     S=320, two SSD chunks): decode against the forward at every position
     within ``DECODE_REL``, and the run through K11 against the run with
     ``attention.flash_attention``'s kernel call swapped for its plain
     version within ``ORACLE_REL``.
   - deepseek-v2-236b (``moe`` with MLA and two shared experts) at full
     width in bf16, as deep as the card's free memory holds beside the
     forward's transient (measured on one layer first; printed as "n of 60
     layers"; the run fails if the weights, the latent cache, the
     transient and ``FAMILY_MARGIN_BYTES`` do not fit):
     ``registry.forward`` on 4 x 1024 tokens (after one warm-up call), K11
     exactly once per layer, each call at (4, 1024, 128, 128, 192 / 128)
     causal with v unpadded; ``LLMServer.generate`` on 4 prompts of 16
     tokens, 16 new, by the stepwise warm-up and the absorbed decode (K11
     never), the tokens equal to the warm-up's; forward ms and its
     ``model_flops`` rate, warm-up and decode ms per step, peak
     allocation; one forward and one decode step under the profiler. Its
     f32 oracle at full width and one layer (B=2, S=64, the bf16 weights
     freed first): the absorbed decode against the expanded forward at
     every position within ``DECODE_REL``, the forward through K11 against
     the same forward with the plain flash within ``ORACLE_REL``, and the
     routers' flips printed and held to ``ROUTER_TIE`` as phi's are.
   - The expert-parallel MoE, on a one-rank world (NCCL) and its 1 x 1
     mesh, opened here and destroyed after the dry run: one
     full-width phi3.5-moe MoE layer (bf16 weights from the seed) on 4 x
     1024 tokens skewed toward expert 0. ``moe_expert_parallel`` at
     capacity factor ``EP_NO_DROP_CF`` (no drop) against ``moe_dense``, and
     at the config's 1.25 against a reference built apart: ``_expert_ffn``
     on every token, combined with the router's weights, the dropped
     copies' zeroed by the stable-sort rule run in numpy on the host; in
     bf16 (per row within ``EP_BF16_ROW`` of its norm) and f32 (within
     ``ORACLE_REL``); aux against the dense one; the dropped share, EP's
     and the dense layer's ms. Then phi's forward at 16 of 32 layers
     through ``transformer.forward`` with the mesh (``"auto"`` takes EP in
     every layer, counted) and without, each timed after a warm-up, K11
     once per layer.
   - qwen2.5-3b's train step in the same world, while the card's memory is
     still free (its step peaks at 69 GiB): full width and full depth (36
     layers, 3.09 G weights, bf16, its config's remat under ``"dots"``),
     the sharded ZeRO-1 Adam step on the 1 x 1 mesh, 3 steps on one 4 x
     1024 batch: the loss finite and falling, K11 72 and K13 / K12 36 a
     step; ms per step, tokens/s, TFLOP/s and the peak; each step's rise
     of ``max_memory_allocated`` after the first within
     ``DRYRUN_PEAK_RTOL`` of ``dryrun_lib.measure``'s meta count of the
     same step at (1, 1) (the dry run's subprocess, after the card's
     steps), and the count with ``remat=False`` printed beside it, reckoned
     and not run.
   Every batched prefill prints its bf16 TFLOP/s as
   ``counting.model_flops(cfg, B·S, "forward")`` over its time.
   Then the FFM main paths at full width (``FFMConfig()``, V = 2^18, random
   weights from a seed), all driven by the same microbatches (4 of 8
   requests with 16-64 candidates each):
   - staged: an int8 and an f32 DeepFFM ``InferenceEngine`` with
     ``backend="cuda"`` answer the microbatches, then
     ``score_uncached(use_backend=True)`` runs on every request. Every score
     must match ``score_uncached(use_backend=False)`` within rtol 2e-4,
     atol 2e-5.
   - fused: an int8 and an f32 ``"ffm"`` engine with ``fused=True`` answer
     them, each within ``quantization.fused_logit_tolerance`` of its staged
     ``"ffm"`` twin on the same params; each microbatch must launch the
     fused kernel once and neither candidate-matrix kernel; a second pass
     over the last microbatch's contexts must hit the cache at full depth.
   - update: an int8 DeepFFM engine takes three trainer frames from a
     ``Sender`` (full, then a row delta after touching 1% of the rows, LR
     entries and every dense leaf, eight weights pushed outside the grid,
     through ``apply_update``; then a patch
     through ``submit_update`` while the main thread keeps scoring across
     the ingest and the publish, which is held until a pass of microbatches
     has been scored). After each frame the decoded weights must lie within
     the wire grid's error bound of the weights given to ``make_update``
     (exactly equal outside the grid), the engine's int8 tables must equal
     a full requantize of them byte for byte, its scores the uncached
     oracle's; every batch scored during the ingest must match exactly one
     generation, and both must be seen; K7 and K8 launch once per
     ``make_update``, K9 once per decode. Frame bytes per kind, the stage
     times and the scorers' p50 / p99 during the ingest are printed.
   - training: a ``TrainingPipeline(FFMConfig(), "deepffm")`` on the card
     runs 3 rounds of 8 microbatches of 512 from ``CTRStream(seed)`` (the
     row-sparse AdaGrad step, its two hidden layers' weight gradients on
     K10), and an int8 staged DeepFFM engine applies each round's frame
     (full, then row deltas). After each frame the update phase's checks
     hold (decoded weights within the grid's bound of ``pipe.params``,
     tables equal to a full requantize, scores against the oracle); K10
     launches exactly twice per microbatch; ``touched_rows`` is the number
     of unique indices, and every untouched row of ``ffm/emb`` and ``lr/w``
     and of their accumulators is byte-identical to before the round.
     Round 1, re-run from a clone of the starting state, gives
     byte-identical params and frame bytes; two microbatches through the
     dense ``make_round_step`` and ``make_sparse_round_step`` from the same
     start agree within rtol 2e-4, atol 1e-6 (scores rtol 1e-4). Both
     steps take dW from K10, so one more trainer microbatch at the trained
     weights holds K10 to plain autograd: its MLP weight gradients through
     the §4.3 backward and through autograd (cuBLAS) agree within 1e-4 of
     the gradient's largest magnitude. Per round it prints examples/s, the
     step / ``make_update`` split, mean loss, progressive AUC, skip stats,
     touched rows and frame bytes, and the fetch-stall fraction of the
     round's batches fed through a ``Prefetcher`` (``PrefetchStats``).
   - DCNv2 (paper §2.2) at ``FFMConfig()``'s width (F = 24, V = 2^18, 8
     wide embeddings, 3 cross layers, MLP (64, 32)), stock torch: its
     forward on the card within 1e-5 of the CPU's on the same weights,
     then ``test_dcnv2_trains``' 30 SGD steps of 512 from
     ``CTRStream(seed=8)`` at lr 0.05, the loss falling; examples/s.
   - servers: an ``FFMServer`` (f32 tables, ``backend="cuda"``) ingests one
     full frame from a ``Sender`` of the phase's weights, and a
     ``CachedServer`` serves the same frame as a receiver decodes it; both
     answer the microbatches (``serve_batch`` and ``serve``; the
     ``CachedServer`` request by request), every probability and logit
     within rtol 2e-4, atol 2e-5 of the plain ``score_uncached``; K2
     (``ffm_candidate_matrices``) must launch on each; p50 / p99 per call.
   - span pipeline: an int8-fused ``"ffm"`` engine and int8 and f32
     staged DeepFFM engines on the main path's weights at ``parallel`` = 1,
     2 and 4 (spans prepared on ``ScoringPool`` threads) answer the
     microbatches, bit-identical for every worker count.
   - host pre-gather, at ``FFMConfig()`` and the (8, 64) buckets: the
     auto policy (``host_gather=None``, ``fused=None``) must pick the
     device gather and the staged path on the card. Four
     ``host_gather=True`` engines (int8 and f32 staged DeepFFM, int8 and
     f32 fused ``"ffm"``) against their device-gather twins on the same
     weights and microbatches: every uploaded block (codes or rows, and
     the grids on real slots) equals the twin's device gather byte for
     byte; scores within rtol 1e-6, atol 1e-7 (JAX's host vs in-trace
     contract) and bit for bit (the LR terms are summed on the device by
     the twin's reduction); launches equal the
     twin's, K2 / K3 / K5 / K6 once per microbatch; no op of the host
     engine's deployed forward reads a gather table (the twin's do). p50
     and p99 per microbatch beside the twin's over ``HOST_TIMED_PASSES``
     bare passes (nothing of the measuring code in them), with the host
     gather + upload's share (timed in one pass before them) and the
     upload's alone. Spans
     at ``parallel`` 1 / 2 / 4 bit-identical (int8, f32, int8-fused, host
     gathers into the pool's pinned buffers). A hot swap: an int8 host
     engine takes a full frame, then a delta (1% of rows, the bias + 1)
     through ``submit_update`` while scoring, the publish held until one
     pass was scored: the host mirror is built once per publish (its ms
     printed), every batch scored meanwhile matches one generation (the
     new one: a device-gather engine fed the same frames), both seen.
     Then ``serving_roofline`` on all eight engines at (8, 64): device
     and host bytes and operations a prediction, the device copy's
     bandwidth (below the sheet's 3.35 TB/s) and the host's, the bound
     and its fraction (each <= 1.05); the card's count of each forward
     equals the CPU count of the same forward.
   - fleet: an entry's partial terms (int8 and f32) bit-equal at buckets 8
     and 64; ``ShardRouter`` at N = 1, 2 and 4 shards (M = 2 replicas at 2
     and 4), int8 and f32, on the main path's weights, answers the
     microbatches: scores bit-identical across N and within 1e-5
     (``ROUTER_ATOL``, the reference's router tolerance) of the single
     staged engine of phase 3; K1 exactly one launch per owning shard of
     each context-tail gather and of each microbatch's candidate entries
     (predicted from the gathers the assembled view was asked for), none
     on f32 fleets; p50 / p99 per microbatch over 5 more passes. Then three
     ``TrainingPipeline``s from one seed (``shard_ranges`` for N = 4 and
     N = 2, and a full-space one) run 2 rounds of 2 x 512 (a full frame,
     then row deltas), fanned out by ``submit_updates`` / ``flush_updates``
     to an N = 4, an N = 2 and a drill N = 4 fleet (M = 2) and applied to an
     int8 engine: K7 and K8 3 and K10 12 per round, K9 once per replica per
     decoded frame (21, then 19); the drill fleet's copy of shard 1's delta
     is bit-flipped (``FaultPlan.corrupt_frame``), NACKed
     (``frame_errors``) and healed by ``resync_shard`` (K9 2); every
     replica's int8 tables equal the engine's slice byte for byte, siblings
     byte-identical, and the fleets' scores bit-identical across N. A
     ``FaultPlan`` kills a replica mid-traffic (scores bit-identical to
     the healthy fleet, no failover, not degraded), then both replicas of
     slice 2 die (the response flagged degraded, not raised).
   - quickstart: ``repro_torch.quickstart.main()`` on the card (3 rounds of
     30 x 512, ``Sender`` patches into an engine, scoring); the weights
     version must reach 3 and the served model's AUC exceed 0.5.
   - serve_llm: ``repro_torch.serve_llm.run`` on llama3.2-1b at full width
     in bf16 (weights from the seed; B = 4 requests sharing a prefix of
     128 tokens, 32 new each): one full frame (its exact length checked)
     through a ``Sender`` and a ``Receiver`` on the card, K7 / K8 / K9 once
     each and K11 never; the served tree the trainer's in structure, dtype
     and shape, each weight within the wire grid's bound of the sent one
     (plus the bf16 cast's 2u |w|); the prefix decoded once at batch 1,
     fanned out and continued, against each request decoding the prefix
     alone (tokens equal, or a flip at a top-2 gap within
     ``serve_llm.GAP_TOL``); both routes' ms and new tokens/s, the smallest
     gap, the host's peak RSS and the card's peak allocation.
   - train_ctr_100m: ``repro_torch.train_ctr_100m.run`` at the example's
     config (2^20 hashes x 24 fields x k = 4: 101,732,332 weights), 200
     steps of 512 on the dense route, then on the Hogwild route at 4
     threads, each with its checkpoint in a temporary directory: K10
     exactly twice a step, K7 / K8 twice (two ``make_update``s), K9 never;
     AUC above 0.5, the losses finite; ``store.load`` of the checkpoint
     equal bit for bit; the drifted weights' patch frame smaller than the
     raw f32 file. Examples/s, the GB a Hogwild step moves by its copies,
     the frames' bytes and the steps' device memory peak.
   - local SGD: ``TrainingPipeline(..., "local_sgd", local_sgd_workers=W)``
     at W = 2, then 4: 2 rounds of W x 4 microbatches of 512 into an int8
     engine, with the training phase's frame checks (full, then delta);
     K10 launched 2 x W x 4 times a round; untouched rows of params and
     accumulators byte-identical; each worker, as its steps leave it before
     the merge, equal bit for bit to the ``jit`` backend's round on its
     batches from the same start, and the pairwise merge of those rounds to
     the pipeline's; round 1 re-run from a clone bit-identical.
   - Hogwild: ``TrainingPipeline(..., "hogwild", hogwild_threads=4)``, 2
     rounds of 16 microbatches of 512 into an int8 engine with the same
     frame checks; K10 launched exactly 2 x 16 times a round; untouched
     rows byte-identical; a finite loss; then a 1-thread ``HogwildTrainer``
     round twice from the same start, bit for bit. Examples/s per round at
     4 threads and per run at 1.
   - LLM serving: ``LLMServer(llama32_1b.config(), random bf16 weights from
     the seed).generate`` on 4 prompts of 1024 tokens, 32 new tokens (one
     warm-up call first): K11 must launch exactly once per layer (16) and
     never in decode; the tokens are in range and equal the warm-up's;
     prefill ms, decode ms per step, tokens/s and the card's peak
     allocation are printed. The oracle, in f32 at the same widths (B=2,
     P=256): the prefill's last logits and cache (through K11) against 256
     stepwise ``decode_step``s over the prompt (never through K11), rel <
     1e-4 (``ORACLE_REL``).
   - LLM training: ``make_train_step`` (Adam, lr 1e-3) on full-width
     llama3.2-1b in bf16 (weights from the seed, uncut) with its config's
     activation rematerialization (``remat``, ``"dots"``), 3 steps on one
     batch of 4 x 1024 ``lm_batches`` tokens: the loss finite and falling,
     K11 (with its log-sum-exp) exactly twice per layer (32: the forward
     and the backward's recompute), K13 and K12 once per layer (16) each
     step; ms per step after the first, tokens/s, TFLOP/s
     (``model_flops``' 6 N T plus attention), peak allocation. Then its
     ``remat=False`` twin on the same seed and batch: losses and final
     params bit for bit the remat run's, K11 16 a step, both routes' ms,
     tokens/s and peaks printed. The f32 oracle at full width and 2
     layers (B=2, S=256, remat): every leaf's gradient
     of ``loss_fn`` through K11 / K13 / K12 against the same loss's
     gradients with ``attention.flash_attention``'s kernel call swapped for
     autograd through the plain flash (which launches nothing), rel <
     ``ORACLE_REL``. Then every other arch id's smoke config trains 3 steps
     on the card, the loss finite and falling.
   - The sharded train step on the 1 x 1 mesh: ``make_train_step(cfg,
     adam, rt)`` on the same full-width llama3.2-1b, seed and batch, 3
     steps: each leaf sharded by ``param_shardings`` and gathered whole
     before the forward, the gradients all-reduced and sliced back, Adam
     shard-local. Losses and final params bit for bit the unsharded
     phase's; K11 twice and K13 / K12 once per layer a step; ms per step
     beside the unsharded phase's, the gather copies' bytes, the peak.
   - The dry run, last in the one-rank world: (a) the same full-width
     llama3.2-1b sharded step (ZeRO-1 state, 4 x 1024, bf16, remat) under an
     ``op_analysis.Counter``; (b) ``dryrun_lib.measure`` (what
     ``run_one`` reports) at ``mesh_shape=(1, 1)`` on the same shape in a
     subprocess (meta tensors, a fake world), after the card's steps: its
     FLOPs, collective bytes and kernel bookings must equal (a)'s, and its
     bytes too or each differing op is printed; (c) the step's measured
     time (median of ``DRYRUN_TIMED`` steps without the counter) must be
     at least the report's ``step_time_bound`` (at H100 spec-sheet peaks):
     a card beating it would mean the count holds work the card did not
     do; and what the counted step added to ``max_memory_allocated`` over
     ``memory_allocated`` just before it must be within
     ``DRYRUN_PEAK_RTOL`` of the meta count's peak less its argument bytes
     (the storages the step creates while they live). The bound's share of
     the time is printed.
   Every kernel's launch counter must have risen during these runs.
   (d) of the dry run comes after phase 4, when nothing is timed any more:
   ``python -m repro_torch.launch.dryrun --all`` and ``--all --multi-pod``
   and ``python -m repro_torch.launch.dryrun_ffm``, run together as
   subprocesses (the host's CPU only), must each exit 0 with every
   combination ``ok`` and only seamless at ``long_500k`` skipped; every
   summary line, each combination's peak per rank and each command's
   seconds are printed.
4. Where the time goes: one more microbatch per engine (and per staged
   ``"ffm"`` twin) and on the N = 4 fleet, one training microbatch, 8
   Hogwild microbatches at 1 and at 4 threads, one LLM prefill and one
   decode step (and, in the families phase while their weights are on the
   card, one granite-8b prefill and one phi3.5-moe decode step; in the
   encoder-decoder phase one seamless ``prefill_cross`` and one decode
   step; in the SSM phase one forward and one decode step of each model;
   in the MLA phase one deepseek forward and one decode step), one more
   LLM train step under torch.profiler (kernels launched, device-busy time
   against wall time, top kernels; for training K10's share, for the
   prefills and seamless' decode step K11's, for the LLM train step K11's,
   K13's and K12's).

The second-to-last lines are the kernels' JSON record and the nvidia-smi
line; the last line is ``{"ok": true, "device": {...}}``. Without a card (or
run from a directory without ``src/repro_torch``) it exits non-zero and
prints no result; the CPU rehearsal ends with exit code 3 for the same
reason.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores — the K=8 dots of these kernels are plain FMA
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the same data sheet's dense bf16 tensor-core peak: the least time of
# attention's bf16 work on this card, whatever K11 itself runs on
PEAK_BF16_TENSOR_FLOPS = 989e12

TIMING_ITERS = 200
WIRE_BIG_ITERS = 20  # eager calls a timing of K7-K9 at llama's 1.24 G weights
# the card's spin (torch.cuda._sleep) that hides the launch path when
# kernel_ms times short kernels back to back: ~25 ms at 1.98 GHz, far more
# than queuing 20 calls takes
SPIN_CYCLES = 50_000_000
# K10's batch rows per block (kBK in csrc/sparse_mlp.cu; a block holds 16
# floats of x and 16 of g per row)
K10_BLOCK = 128
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-5  # staged scores vs the uncached oracle
# the fleet phase: the reference's router tolerance against a single engine
# (test_sharded_serving.py), its (shards, replicas) fleets, training
# microbatches per fan-out round and timed passes over the microbatches
ROUTER_ATOL = 1e-5
FLEET_SHAPES = ((1, 1), (2, 2), (4, 2))
FLEET_MICRO = 2
FLEET_TIMED_PASSES = 5
TRAIN_BATCH = 512  # examples per training microbatch (examples/train_ctr_100m.py)
LOCAL_STEPS = 4     # local-SGD steps per worker and round
HOGWILD_MICRO = 16  # microbatches per Hogwild round
# K10's weight gradients in a training step vs plain autograd's, as a share
# of the gradient's largest magnitude (two f32 sums of 512 products, in
# different orders)
GRAD_RTOL = 1e-4
# the LLM phase: served batch, prompt length, new tokens; the f32 oracle's
# batch and prompt length (llama32_1b.config(); the rehearsal's smoke())
# the serve_llm example: B requests sharing a prefix, new tokens each
SERVE_LLM_FULL = {"batch": 4, "prefix": 128, "gen": 32}
SERVE_LLM_TINY = {"batch": 2, "prefix": 4, "gen": 3}
# the train_ctr_100m example: its config (None: the example's 100.7 M-weight
# FFMConfig), steps of batch on each route, Hogwild threads
CTR_FULL = {"cfg": None, "steps": 200, "batch": 512, "threads": 4}
CTR_TINY = {"cfg": {"n_fields": 24, "context_fields": 16, "hash_space": 2**14,
                    "k": 4, "mlp_hidden": (64, 32)},
            "steps": 100, "batch": 256, "threads": 4}
LLM_FULL = {"batch": 4, "prompt": 1024, "gen": 32, "oracle": (2, 256)}
LLM_TINY = {"batch": 2, "prompt": 16, "gen": 4, "oracle": (2, 12)}
# K11 against its plain version (test_kernels.py's flash tolerances; bf16
# launches are held to the roundoff bounds of flash_bf16_errors as well)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# K11's sweep, each case in f32 and bf16: (B, S, H, Kv, D, causal, window).
# test_kernels.py's four, D = 128, an unmasked window; then the edges of the
# bf16 body's 128 x 128 tiles: the main path's GQA 4:1 with S ragged to both
# 64 and 128, D = 128 ragged, S below one tile, and a window whose first
# live tile is wholly masked for some rows
FLASH_SWEEP = ((2, 64, 4, 4, 16, True, 0), (2, 100, 8, 2, 32, True, 0),
               (2, 128, 4, 4, 16, True, 48), (2, 96, 4, 2, 64, False, 0),
               (2, 200, 4, 2, 128, True, 0), (2, 70, 4, 1, 64, False, 33),
               (1, 1000, 32, 8, 64, True, 0), (2, 300, 8, 2, 128, True, 0),
               (2, 40, 4, 4, 64, True, 0), (2, 257, 4, 1, 32, True, 100))
# K11 at the other families' prefill shapes (B and S of the LLM phase,
# D = 128): (query heads, KV heads) of phi3.5-moe / granite-8b (4:1) and of
# qwen2.5-3b (8:1)
FLASH_D128_HEADS = ((32, 8), (16, 2))
# K11 at seamless-m4t-large-v2's attention (B and the frames' S of the LLM
# phase, 16 query and 16 KV heads of 64): (Sq, Sk, causal) of the encoder,
# the teacher-forced forward's cross-attention and a decode step's, then
# Sq != Sk under the causal mask
FLASH_SEAMLESS = ((1024, 1024, False), (256, 1024, False), (1, 1024, False),
                  (256, 1024, True), (1024, 256, True), (1, 1024, True))
FLASH_SEAMLESS_HEADS, FLASH_SEAMLESS_D = 16, 64
# K11 at zamba2-7b's shared attention block (B and S of the LLM phase, 32
# query and 32 KV heads of 3584 / 32 = 112, causal)
FLASH_D112 = (32, 32, 112)
# K11 at deepseek-v2-236b's MLA prefill (B and S of the LLM phase, 128
# query and 128 KV heads, qk / v head dims 192 / 128, causal, v at its own
# width): (H, Kv, D, Dv); and at the smoke config's (48, 32) on a small
# shape: (B, S, H, Kv, D, Dv)
FLASH_MLA = (128, 128, 192, 128)
FLASH_MLA_SMALL = (2, 256, 4, 4, 48, 32)
# the MLA pairs at the edges of the bf16 body's 128 x 128 tiles, each in
# f32 and bf16: (B, S, H, Kv, D, causal, window, Dv)
FLASH_MLA_SWEEP = ((2, 200, 4, 2, 192, True, 0, 128),
                   (2, 300, 4, 4, 192, False, 0, 128),
                   (2, 257, 4, 1, 192, True, 100, 128),
                   (2, 70, 4, 4, 48, True, 0, 32),
                   (2, 130, 4, 2, 48, False, 33, 32))
# K13 / K12 (flash attention's backward) against the plain backward on the
# same K11 output and log-sum-exp: f32 within BWD_REL of each gradient's
# largest |value| (f32 sums in other orders); bf16 per element within
# 2u (A + |g|) + BWD_REL max |g|: the wgmma bodies round P and dS to bf16
# before their products (K12 forms dS from the rounded P: at most 2u of each
# term, so 2u A, A = ref.flash_attention_bwd_abs_ref's sum of the terms'
# magnitudes) and both sides round the f32 gradient once (2u |g|), beside
# the f32 bound. K11's log-sum-exp against the plain one within LSE_TOL
# (1 + |lse|): f32 the CUDA-core body's expf and sums, bf16 the wgmma body's
# ex2.approx (2 ulp) and its log2(e) fold
BWD_REL = 1e-4
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
# the backward's shapes, each in bf16 and f32: (B, Sq, Sk, H, Kv, D, Dv,
# causal, window, timed calls): llama3.2-1b's train step (the main record),
# D = 128 (phi3.5-moe / granite-8b heads), zamba2's D = 112, deepseek-v2's
# MLA (192, 128) (few timed calls: tens of ms a backward), the smoke
# config's (48, 32), seamless' unmasked cross-attention (Sq != Sk), a window
# with S ragged to the 64-row tiles; then the two smallest pairs of
# ops.HEAD_DIMS, (16, 16) causal and (32, 32) under a window with S ragged
FLASH_BWD = ((4, 1024, 1024, 32, 8, 64, 64, True, 0, 20),
             (4, 1024, 1024, 32, 8, 128, 128, True, 0, 10),
             (4, 1024, 1024, 32, 32, 112, 112, True, 0, 5),
             (4, 1024, 1024, 128, 128, 192, 128, True, 0, 2),
             (2, 256, 256, 4, 4, 48, 32, True, 0, 10),
             (4, 256, 1024, 16, 16, 64, 64, False, 0, 10),
             (2, 1000, 1000, 8, 2, 64, 64, True, 200, 10),
             (2, 256, 256, 8, 2, 16, 16, True, 0, 10),
             (2, 200, 200, 4, 1, 32, 32, True, 64, 10))
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
BWD_REPLACES = ("none: the port's own (the JAX package differentiates its jnp "
                "flash, src/repro/models/attention.py:36)")
# K4 against its plain version: test_kernels.py::test_ffm_interaction_sweep's
# shapes and tolerances (rtol, atol), then F = 64, K = 16, whose (F, F, K)
# f32 block would not fit in one CTA's shared memory (262,400 > 232,448 B)
K4_SWEEP = ((4, 4, 2), (32, 24, 8), (100, 24, 8), (7, 10, 16), (1, 6, 4),
            (3, 64, 16))
K4_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-1)}
# the f32 oracle: prefill through K11 vs stepwise decode, rel of max |ref|.
# Both are f32 sums in different orders (2.9e-6 on an H100); a bf16 or TF32
# rounding anywhere on the f32 path gives ~1e-3, so the bound sits between
# (test_archs.py's decode-vs-forward bound, 5e-3, covers every family)
ORACLE_REL = 1e-4
# the LLM families phase: served batch, prompt length and new tokens of
# granite-8b, yi-6b, qwen2.5-3b and chameleon-34b (full width, bf16 weights
# from the seed); phi3.5-moe's prompt length and depth (16 of its 32 layers:
# the full 83.8 GB of bf16 weights exceed the card's 80 GB); the f32
# oracles' batch, prompt length and depth; the int8 cache's batch and prompt
# length on a 2-layer qwen2.5-3b. The rehearsal runs each smoke() config
FAMILIES_FULL = {"batch": 4, "prompt": 1024, "gen": 16, "phi_prompt": 128,
                 "phi_layers": 16, "oracle": (2, 64), "oracle_layers": 2,
                 "int8": (4, 128)}
FAMILIES_TINY = {"batch": 2, "prompt": 16, "gen": 4, "phi_prompt": 8,
                 "phi_layers": 2, "oracle": (2, 12), "oracle_layers": 2,
                 "int8": (2, 12)}
PHI = "phi3.5-moe-42b-a6.6b"
FAMILY_ARCHS = ("granite-8b", "yi-6b", "qwen2.5-3b", "chameleon-34b", PHI)
# a router flip between the oracle's two paths fails where the k-th and
# (k+1)-th probability differ by more than this (a near tie is printed)
ROUTER_TIE = 1e-5
# the int8 cache's last logits against the native cache's
# (test_archs.py::test_int8_kv_cache_decode), as a share of max |logit|
INT8_REL = 0.05
# room kept free beside a family's weights and cache (the prefill's
# activations, cuBLAS' workspaces)
FAMILY_MARGIN_BYTES = 3 * 2**30
# the encoder-decoder phase (seamless-m4t-large-v2 at full width, bf16
# weights from the seed, uncut): batch, stub frames, greedy new tokens, the
# teacher-forced forward's target length; the f32 oracle's batch, frames
# and target length, at oracle_layers encoder and decoder layers
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_FULL = {"batch": 4, "src": 1024, "gen": 32, "tgt": 256,
                 "oracle": (2, 64, 32), "oracle_layers": 2}
SEAMLESS_TINY = {"batch": 2, "src": 16, "gen": 4, "tgt": 8,
                 "oracle": (2, 12, 8), "oracle_layers": 2}
# the SSM phase (mamba2-130m and zamba2-7b at full width, bf16 weights from
# the seed, uncut): the forward's batch and length; generate's batch,
# prompt and new tokens; the f32 oracle's batch and length (two SSD chunks,
# the second ragged) at reduced depth: mamba2 at 2 layers, zamba2 at one
# super-block and one tail block
SSM_ARCHS = ("mamba2-130m", "zamba2-7b")
SSM_FULL = {"batch": 4, "seq": 1024, "prompt": 16, "gen": 16,
            "oracle": (2, 320)}
SSM_TINY = {"batch": 2, "seq": 20, "prompt": 8, "gen": 4, "oracle": (2, 20)}
# decode against the chunked forward (test_archs.py::
# test_decode_matches_forward's bound): the SSD scan and the recurrence sum
# in different orders; MLA's absorbed decode and its expanded forward too
DECODE_REL = 5e-3
# the MLA phase (deepseek-v2-236b at full width, bf16 weights from the
# seed, as deep as the card's free memory holds beside the forward's
# measured transient): the forward's batch and length; generate's batch,
# prompt and new tokens; the f32 oracle's batch and length, at
# MLA_ORACLE_LAYERS layers
DEEPSEEK = "deepseek-v2-236b"
MLA_FULL = {"batch": 4, "seq": 1024, "prompt": 16, "gen": 16,
            "oracle": (2, 64)}
MLA_TINY = {"batch": 2, "seq": 20, "prompt": 8, "gen": 4, "oracle": (2, 12)}
MLA_ORACLE_LAYERS = 1
# DCNv2 (paper §2.2) at the main path's FFMConfig: test_dcnv2_trains' SGD
# steps, learning rate and stream seed, at the trainer's microbatch; its
# forward on the card against the CPU's within rtol and atol of max |logit|
DCN_STEPS, DCN_LR, DCN_SEED, DCN_TOL = 30, 0.05, 8, 1e-5
# the LLM training phase (llama3.2-1b at full width, bf16 weights from the
# seed, uncut): one batch of lm_batches, Adam at lr, steps on it; the f32
# oracle's batch and length at oracle_layers layers; every other arch id's
# smoke config trains steps on a (B, S) batch
LLM_TRAIN_FULL = {"batch": 4, "seq": 1024, "steps": 3, "lr": 1e-3,
                  "oracle": (2, 256), "oracle_layers": 2, "smoke": (2, 64)}
LLM_TRAIN_TINY = {"batch": 2, "seq": 16, "steps": 3, "lr": 1e-3,
                  "oracle": (2, 12), "oracle_layers": 2, "smoke": (2, 16)}
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv")
# qwen2.5-3b's train step at full width and depth (36 layers, bf16, its
# config's remat under "dots"): Adam at lr, steps on one (batch, seq) batch
# of lm_batches, sharded on the 1 x 1 mesh as the dry run counts it; the
# rehearsal trains the smoke config with remat on
QWEN_TRAIN_FULL = {"batch": 4, "seq": 1024, "steps": 3, "lr": 1e-3}
QWEN_TRAIN_TINY = {"batch": 2, "seq": 16, "steps": 3, "lr": 1e-3}
# the expert-parallel MoE on a 1 x 1 mesh (a one-rank NCCL world): one
# full-width phi3.5-moe MoE layer (bf16 weights from the seed, router f32)
# on (batch, seq) tokens at capacity factor EP_NO_DROP_CF (no copy dropped)
# and at the config's 1.25, then the forward of phi at `layers` layers with
# and without the mesh. x has a mean along expert 0's router column (scaled
# EP_SKEW), so that expert is over-subscribed as skewed traffic makes it
# and copies drop at 1.25. EP is held per row against its reference within
# EP_BF16_ROW of the row's norm in bf16 (the combine's roundings, about 3u,
# and the experts' products in other GEMM shapes) and within ORACLE_REL in
# f32
EP_FULL = {"batch": 4, "seq": 1024, "layers": 16}
EP_TINY = {"batch": 2, "seq": 16, "layers": 2}
EP_NO_DROP_CF = 8.0
EP_SKEW = 0.5
EP_BF16_ROW = 8 * 2.0 ** -8
# bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(bytes_moved: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """Least time (ms) the card needs for the work, and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_smem_bytes(d: int, dv: int, bf16: bool, stages=None):
    """K11's dynamic shared memory per block at qk / v head dims (d, dv)
    (csrc/flash_attention.cu) and its K / V ring depth. The bf16 body
    (Tile<D, Dv>): a 128-row Q tile, ``stages`` stages of 128-key K and V
    tiles (each width above 32 rounded up to whole 64-column boxes: 112 ->
    128 and 48 -> 64, TMA zero-filling the rest), 2 + 3 ``stages``
    mbarriers and 1024 B of alignment slack; ``stages`` None is the
    kernel's choice, 3 where they fit the 232,448 B a block may use, else 2.
    The f32 body (smem_floats): 64-row Q and K tiles with rows of D + 4
    floats, the Dv-wide V tile, the 64 x 68 P tile (no ring: 0 stages).
    Returns (bytes, stages)."""
    if not bf16:
        return (64 * (d + 4) * 2 + 64 * dv + 64 * 68) * 4, 0

    def width(w):
        return w if w <= 32 else -(-w // 64) * 64

    def total(n):
        return (128 * width(d) * 2 + n * 128 * (width(d) + width(dv)) * 2
                + (2 + 3 * n) * 8 + 1024)

    if stages is None:
        stages = 3 if total(3) <= 232448 else 2
    return total(stages), stages


def bwd_bf16_share(got, want, terms) -> float:
    """The largest share, over the elements of one gradient, of K13 / K12's
    bf16 bound |got - want| <= 2u (A + |want|) + BWD_REL max |want|, A =
    ``terms`` (that gradient's ``ref.flash_attention_bwd_abs_ref``); the
    bound holds where it is at most 1."""
    w = want.float()
    lim = 2 * BF16_U * (terms + w.abs()) + BWD_REL * float(w.abs().max())
    return float(((got.float() - w).abs() / lim.clamp_min(1e-30)).max())


def flash_bwd_smem_bytes(d: int, dv: int, bf16: bool):
    """K13's and K12's dynamic shared memory per block at qk / v head dims
    (d, dv) (csrc/flash_attention_bwd.cu). The bf16 bodies (DqTile /
    DkdvTile, widths above 32 rounded up to whole 64-column boxes as K11's):
    K13 a 128-row Q and dO, 3 stages of a 64-key K and V, 1 + 2 x 3
    mbarriers; K12 a 64-key K and V, 3 stages of a 64-row Q and dO, two
    8192 B buffers of P^T, 1024 B of lse / Delta buffers, 1 + 2 x 3 + 4
    mbarriers; each with 1024 B of alignment slack. The f32 bodies:
    64-row tiles of f32 rows W + 4 floats wide; K13 Q, dO, K, V and dS; K12
    the same and P^T, 128 floats of lse and Delta. Returns (K13, K12)."""
    if not bf16:
        tiles = 2 * 64 * (d + 4) + 2 * 64 * (dv + 4)
        return (tiles + 64 * 68) * 4, (tiles + 2 * 64 * 68 + 128) * 4

    def width(w):
        return w if w <= 32 else -(-w // 64) * 64

    row = (width(d) + width(dv)) * 2  # one row of Q and dO, or of K and V
    return (128 * row + 3 * 64 * row + 7 * 8 + 1024,
            64 * row + 3 * 64 * row + 2 * 8192 + 1024 + 11 * 8 + 1024)


# template arguments as the mangled names spell them
MANGLED_TYPES = {"f": "float", "13__nv_bfloat16": "bf16", "a": "int8_t"}


def ptxas_usage(log: str, needle: str):
    """(kernel, registers, spill line) for each entry function of the build
    log whose name contains ``needle``, named with its template arguments
    (a type, then ints, as ``needle<float, 8>`` or ``needle<192, 128>``)."""
    found, name = [], None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            m = re.search(re.escape(needle) + r"I(f|13__nv_bfloat16|a)?"
                          r"((?:Li\d+E)*)", line)
            targs = [MANGLED_TYPES[m.group(1)]] if m and m.group(1) else []
            targs += re.findall(r"Li(\d+)E", m.group(2)) if m else []
            # a longer name that starts with the needle is another kernel
            name = (f"{needle}<{', '.join(targs)}>" if targs
                    else needle if re.search(re.escape(needle) + "(?!_)",
                                             line) else None)
        elif name and "spill" in line:
            spill = line
        elif name and "Used" in line and "registers" in line:
            found.append((name, int(line.split("Used")[1].split()[0]), spill))
            name = None
    return found


def rel(a, ref) -> float:
    """Largest |a - ref| as a share of the largest |ref| (the oracles'
    measure)."""
    return float((a - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)


def train_launches(cfg) -> dict:
    """K11, K13 and K12 launches in one train step of ``cfg`` on the card:
    K11 once per layer in the forward and, with ``cfg.remat``, once more in
    the backward's recompute; K13 and K12 once per layer."""
    n = cfg.n_layers
    return {"flash_attention": 2 * n if cfg.remat else n,
            "flash_attention_bwd_dq": n, "flash_attention_bwd_dkdv": n}


def train_step_flops(cfg, b: int, s: int) -> tuple:
    """(FLOPs, attention's share) of one causal LM train step on (b, s)
    tokens: ``model_flops``' 6 N T plus attention's forward (scores and PV,
    2 x 2 D per pair) and backward (5 x 2 D per pair). The recompute of a
    remat step is not counted: the rate is of the model's work."""
    from repro_torch.common import counting

    hd = cfg.resolved_head_dim
    attn = ((2 * (hd * 2) + 2 * (5 * hd)) * b * cfg.n_heads
            * attention_pairs(s, s, True, 0) * cfg.n_layers)
    return counting.model_flops(cfg, b * s, "train") + attn, attn


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (row, column) pairs attention's mask keeps: the score and PV work
    a call needs (2 D + 2 Dv operations each)."""
    n = 0
    for r in range(sq):
        hi = min(r, sk - 1) if causal else sk - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def attention_elements(q, k, v, causal: bool) -> int:
    """Elements attention must move: q read and the output (Dv wide)
    written, and the k and v rows some query can see (under the causal
    mask, aligned at position 0, none past key Sq - 1)."""
    b, sq, h, _ = q.shape
    sk, kv, d = k.shape[1:]
    dv = v.shape[-1]
    live = min(sk, sq) if causal else sk
    return q.numel() + b * sq * h * dv + b * live * kv * (d + dv)


def make_slate(cfg, rng, n):
    """(cand_idx, cand_val) of n candidates: the last two candidate fields
    are numeric (log-transformed values), the rest categorical."""
    import numpy as np

    fcand = cfg.n_fields - cfg.context_fields
    ki = rng.integers(0, cfg.hash_space, (n, fcand)).astype(np.int32)
    kv = np.ones((n, fcand), np.float32)
    kv[:, -2:] = np.log1p(rng.lognormal(0.0, 1.0, (n, 2)))
    return ki, kv


def make_traffic(cfg, rng, n_batches=4, per_batch=8, lo=16, hi=64):
    """Microbatches of (ctx_idx, ctx_val, cand_idx, cand_val) requests.

    Contexts come from three base contexts with a varied tail (so the prefix
    cache hits at checkpoint depths and, across batches, at full depth);
    every fourth request repeats the previous request's context and half of
    its slate (so dedup fires). Slates come from :func:`make_slate`."""
    import numpy as np

    fc = cfg.context_fields
    v = cfg.hash_space
    bases = [rng.integers(0, v, fc).astype(np.int32) for _ in range(3)]
    cuts = [fc] + [d for d in (12, 8, 4) if d < fc]

    def slate(n):
        return make_slate(cfg, rng, n)

    batches = []
    for _ in range(n_batches):
        reqs = []
        for j in range(per_batch):
            n = int(rng.integers(lo, hi + 1))
            if j % 4 == 3:
                ci, cv, pki, pkv = reqs[-1]
                take = min(n // 2, pki.shape[0])
                ki, kv = slate(n - take)
                reqs.append((ci, cv, np.concatenate([pki[:take], ki]),
                             np.concatenate([pkv[:take], kv])))
                continue
            ci = bases[int(rng.integers(0, 3))].copy()
            cut = cuts[int(rng.integers(0, len(cuts)))]
            ci[cut:] = rng.integers(0, v, fc - cut)
            reqs.append((ci, np.ones(fc, np.float32), *slate(n)))
        batches.append(reqs)
    return batches


def where_the_time_goes(name, fn, smi, top=6, share_of=None):
    """One more call of ``fn`` (a microbatch) under torch.profiler: the
    card's kernel time against the call's wall time (profiler included), the
    number of kernels the call launched, the kernels with the most device
    time, and the share of device time of kernels whose names hold
    ``share_of`` (one substring, or each of a tuple)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if not kern:
        print(f"time {name}: device time not measured (the profiler saw no "
              f"kernel); wall {wall_ms:.3f} ms | {smi}")
        return None
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"time {name}: one call under the profiler: wall "
          f"{wall_ms:.3f} ms, kernels {len(kern)}, device busy {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f}% of wall) | {smi}")
    for kname, (n, t) in ranked:
        print(f"  {t:.4f} ms in {n} launches: {kname[:90]}")
    for part in (share_of,) if isinstance(share_of, str) else share_of or ():
        hits = [v for k, v in by_name.items() if part in k]
        n, t = sum(c for c, _ in hits), sum(ms for _, ms in hits)
        print(f"  {part}: {n} launches, {t:.4f} ms = "
              f"{100 * t / dev_ms:.1f}% of device busy time")
    return len(kern)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="small config for the CPU rehearsal")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; no result", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import layout
    from repro_torch.common import device as device_mod
    from repro_torch.common.config import FFMConfig
    from repro_torch.configs import llama32_1b
    from repro_torch.core import deepffm
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import _build
    from repro_torch.kernels.ffm_interaction import ops as fi_ops
    from repro_torch.kernels.ffm_interaction import ref as fi_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize import ref as q_ref
    from repro_torch.kernels.row_gather import ops as rg_ops
    from repro_torch.kernels.row_gather import ref as rg_ref
    from repro_torch.kernels.sparse_mlp import ops as sk_ops
    from repro_torch.kernels.sparse_mlp import ref as sk_ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry as llm_registry
    from repro_torch.serving.engine import InferenceEngine

    # results are held to f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    cfg = (FFMConfig(n_fields=8, context_fields=5, hash_space=2**10, k=4,
                     mlp_hidden=(16, 8)) if args.tiny else FFMConfig())
    llm_cfg = llama32_1b.smoke() if args.tiny else llama32_1b.config()
    llm = LLM_TINY if args.tiny else LLM_FULL

    # -- phase 1: card and build -------------------------------------------
    smi = "not measured (no card)"
    if on_card:
        info = device_mod.describe(dev)
        smi = info["nvidia_smi"]
        print(f"card: {info['name']} | capability {info['capability']} | "
              f"count {info['count']} | name, power limit: {smi}")
        check(tuple(info["capability"]) == (9, 0),
              f"need compute capability 9.0, got {info['capability']}")
        lib = _build.load()
        print(f"build: {lib.build_seconds:.2f} s (one nvcc per csrc/*.cu, "
              f"all started together, then a link) -> {lib.path.name}")
        for line in lib.log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print("  " + line.strip())
        # the kernels' shared memory is dynamic (ptxas reports static only)
        f_, fc_, k_ = cfg.n_fields, cfg.context_fields, cfg.k
        print("  dynamic shared memory per block at main-path shapes: "
              "gather_dequant_rows_q8 0 B, ffm_candidate_matrices(_q8) 0 B "
              f"(the direct body; the staged body, off the main path, "
              f"{(fc_ * (f_ - fc_) * k_ + fc_) * 4} B), "
              "ffm_interaction_matrix 0 B, "
              "ffm_fused_logits_(q8|rows) 0 B (16 B static: the tail's "
              "four warp sums), minmax / "
              "quantize_codes / dequantize_codes 0 B, sparse_weight_grad "
              f"{K10_BLOCK * 32 * 4} B per {K10_BLOCK}-row block held (B = "
              f"{TRAIN_BATCH}: 4; 8 KiB static), flash_attention bf16 / "
              "f32 at (D, Dv) "
              + ", ".join(
                  f"({d}, {dv}) {flash_smem_bytes(d, dv, True)[0]} B in "
                  f"{flash_smem_bytes(d, dv, True)[1]} stages / "
                  f"{flash_smem_bytes(d, dv, False)[0]} B"
                  for d, dv in fa_ops.BODIES[torch.bfloat16][1])
              + " (a 3-stage ring at (192, 128) would need "
              f"{flash_smem_bytes(192, 128, True, 3)[0]} B of the 232448 a "
              "block may use)")
        for name, regs, spill in ptxas_usage(lib.log,
                                             "flash_attention_kernel_wgmma"):
            print(f"  K11 bf16 body {name}: {regs} registers per thread at "
                  f"entry (setmaxnreg: consumers 232, producer 40); {spill} "
                  "(with the lse write: one instance serves training, which "
                  "passes an lse pointer, and serving, which passes null)")
        for kid, needle, nreg in (
                ("K13", "flash_attention_bwd_dq_kernel_wgmma", "232 / 40"),
                ("K12", "flash_attention_bwd_dkdv_kernel_wgmma", "240 / 24")):
            for name, regs, spill in ptxas_usage(lib.log, needle):
                print(f"  {kid} bf16 body {name}: {regs} registers per "
                      f"thread at entry (setmaxnreg: consumers / producer "
                      f"{nreg}); {spill}")
        for kid, needle in (("K13", "flash_attention_bwd_dq_kernel"),
                            ("K12", "flash_attention_bwd_dkdv_kernel")):
            for name, regs, spill in ptxas_usage(lib.log, needle):
                print(f"  {kid} f32 body {name}: {regs} registers per "
                      f"thread; {spill}")
        print("  dynamic shared memory per block of K13 / K12 at (D, Dv), "
              "bf16 | f32: "
              + ", ".join(f"({d}, {dv}) "
                          + " | ".join(" / ".join(
                              str(x) for x in flash_bwd_smem_bytes(d, dv, bf))
                              for bf in (True, False)) + " B"
                          for d, dv in fa_ops.HEAD_DIMS))
        for kid, needle in (("K1", "gather_dequant_rows_q8_kernel"),
                            ("K4", "ffm_interaction_matrix_kernel"),
                            ("K5/K6", "ffm_fused_logits_kernel")):
            for name, regs, spill in ptxas_usage(lib.log, needle):
                print(f"  {kid} {name}: {regs} registers per thread; {spill}")
    else:
        print("card: none (CPU rehearsal: plain versions, no timings)")

    # -- phase 2: each kernel against its plain version ----------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def device_ms(fn):
        """Mean device time (ms) of one ``fn()``: TIMING_ITERS calls captured
        in a CUDA graph and replayed, timed with CUDA events (no Python
        launch overhead in the number)."""
        if not on_card:
            return None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(TIMING_ITERS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / TIMING_ITERS

    def call_ms(fn, n=TIMING_ITERS, warm=10):
        """Mean time (ms) of one eager ``fn()`` call, Python wrapper
        included: CUDA events around ``n`` back-to-back calls after ``warm``
        warm-up calls."""
        if not on_card:
            return None
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    def kernel_ms(fn, n=20):
        """Device time (ms) of one ``fn()`` without its launch path: the
        card first spins (``torch.cuda._sleep``) while the host queues ``n``
        calls behind the spin, so CUDA events around them time the kernels
        back to back (an eager timing of a call shorter than its launch
        path reads the host instead). None if the host took longer to queue
        the calls than the card spun."""
        if not on_card:
            return None
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms >= ev[0].elapsed_time(ev[1]):
            return None
        return ev[1].elapsed_time(ev[2]) / n

    def ms_text(ms, bound_ms=None):
        if ms is None:
            return "not measured (the calls outran the spin)"
        share = "" if bound_ms is None else (
            f", {100 * bound_ms / ms:.1f}% of the bound")
        return f"{ms:.4f} ms{share}"

    def max_err(got, want):
        if isinstance(got, tuple):
            return max(max_err(g, w) for g, w in zip(got, want))
        return float((got.float() - want.float()).abs().max())

    def allclose(got, want, rtol, atol):
        if isinstance(got, tuple):
            return all(allclose(g, w, rtol, atol) for g, w in zip(got, want))
        return bool(torch.allclose(got.float(), want.float(), rtol=rtol,
                                   atol=atol))

    def flash_bf16_errors(got, want, q, k, v, causal=True, window=0):
        """K11's bf16 output against the plain version's, in units of two
        roundoff bounds. Both sum f32 products; K11 rounds P to bf16 (at
        most u * A per element, A = sum_j p_j |v_j| >= |o|: the plain version
        on |v| in f32) and both round the output (at most u |o| each). So
        per element |got - want| <= 2u (A + |want|), with u A to spare; per
        row (b, s, h) the output roundings give at most 2u of the row's
        norm, and rows are held to 4u. Returns the worst element's and the
        worst row's share of its bound; each must stay below 1."""
        a = fa_ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                       causal=causal, window=window)
        w = want.float()
        e = (got.float() - w).abs()
        elem = float((e / (2 * BF16_U * (a + w.abs()))).max())
        rows = (torch.linalg.vector_norm(e, dim=-1)
                / torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-30))
        return elem, float(rows.max()) / (4 * BF16_U)

    def check_flash_bf16(got, want, q, k, v, what, causal=True, window=0):
        elem, row = flash_bf16_errors(got, want, q, k, v, causal, window)
        check(elem < 1 and row < 1,
              f"{what}: bf16 error {elem:.3f} of the element bound, {row:.3f}"
              " of the row bound")
        return elem, row

    r_rows, n_cand = 8, 64  # warmup(max_requests=8, max_candidates=64)
    f, fc, k = cfg.n_fields, cfg.context_fields, cfg.k
    fcand = f - fc
    v = cfg.hash_space
    kernels = []

    def kernel_case(name, source, replaces, fn, plain, tol, bytes_moved,
                    flops, shape, library=None, eager=False,
                    peak_flops=PEAK_F32_FLOPS, into=None, iters=TIMING_ITERS):
        """Appends the kernel's record to ``into`` (``kernels`` by default)
        and returns it. ``eager``: time eager calls (for kernels long next
        to a launch, whose plain versions would fill a captured graph's
        memory pool), ``iters`` of them a timing."""
        def eager_ms(f):
            return call_ms(f, n=iters)

        timed = eager_ms if eager else device_ms
        got, want = fn(), plain()
        if on_card:
            torch.cuda.synchronize()
        err = max_err(got, want)
        if tol == "exact":
            ok = all(torch.equal(g, w) for g, w in
                     zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)))
        else:
            ok = allclose(got, want, *tol)
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(max abs err {err:.3e}, tolerance {tol})")
        b_ms, b_by = bound(bytes_moved, flops, peak_flops)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": err,
               "ms": timed(fn), "plain_ms": timed(plain),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timed(library) if library else None,
               "call_ms": eager_ms(fn), "plain_call_ms": eager_ms(plain),
               "bytes": bytes_moved, "shape": shape, "tolerance": tol}
        (kernels if into is None else into).append(rec)
        rate = ("not measured" if rec["ms"] is None
                else f"{bytes_moved / rec['ms'] / 1e6:.1f} GB/s")
        print(f"kernel {name} {shape}: max abs err {err:.3e} (tol {tol}) | "
              f"device {rec['ms']} ms, per call {rec['call_ms']} ms | plain "
              f"{rec['plain_ms']} ms | {bytes_moved} bytes ({rate}) | bound "
              f"{b_ms:.3e} ms ({b_by})")
        return rec

    # the launch floor: a CUDA graph node that does no work worth the name
    # (zero_() of one f32), timed as device_ms times a kernel. A yardstick
    # for the small kernels below, as library_ms is; the port never calls it
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(one.zero_)
    print("launch floor: "
          + ("not measured (no card)" if floor_ms is None else
             f"{floor_ms} ms per zero_() of one f32, {TIMING_ITERS} in a CUDA "
             f"graph | {smi}"))

    def idx_in(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # K1: the gather of score_uncached's (N, F) feature block (context tails
    # gather up to Fc rows through the same kernel)
    tbl = (codes(v, f, k), uniform(1e-4, 1e-2, v), randn(v, scale=0.05))
    idx = idx_in(v, n_cand, f)
    m, rowlen = idx.numel(), f * k
    kernel_case(
        "gather_dequant_rows_q8", "src/repro_torch/csrc/row_gather.cu",
        "src/repro/kernels/row_gather/row_gather.py:40",
        lambda: rg_ops.gather_dequant_rows_q8(*tbl, idx),
        lambda: rg_ref.gather_dequant_rows_q8_ref(*tbl, idx), "exact",
        *reversed(rg_ops.k1_work(m, rowlen)),
        [list(tbl[0].shape), list(idx.shape)])
    # K1 bit for bit off the main shape: a ragged last block, the table's
    # first and last rows, 2-D indices, rows of 40 codes (8-code pieces
    # that are no multiple of 16 bytes), rows of 15 codes and codes one byte
    # off alignment (both one code per thread)
    def grid_of(n):
        return uniform(1e-3, 1e-2, n), randn(n, scale=0.05)

    tbl40 = (codes(1000, 5, 8), *grid_of(1000))
    tbl15 = (codes(50, 3, 5), *grid_of(50))
    flat = codes(1000 * 40 + 1)
    tbl_off = (flat[1:].view(1000, 5, 8), *tbl40[1:])
    ends = torch.tensor([[0, v - 1, 0], [v - 1, 7, v - 1]], dtype=torch.int32,
                        device=dev)
    for what, t_, i_ in (("1537 rows", tbl, idx_in(v, 1537)),
                         ("rows 0 and V-1", tbl, ends),
                         ("(3, 7) indices", tbl, idx_in(v, 3, 7)),
                         ("rows of 40 codes", tbl40, idx_in(1000, 300)),
                         ("rows of 15 codes", tbl15, idx_in(50, 7, 3)),
                         ("codes off alignment", tbl_off, idx_in(1000, 300))):
        check(torch.equal(rg_ops.gather_dequant_rows_q8(*t_, i_),
                          rg_ref.gather_dequant_rows_q8_ref(*t_, i_)),
              f"gather_dequant_rows_q8 ({what}) disagrees")
    print("kernel gather_dequant_rows_q8: 1537 rows, rows 0 and V-1, (3, 7) "
          "indices, rows of 40 and 15 codes and codes off alignment equal "
          "the plain version bit for bit")

    # K2/K3: one (rb=8, nb=64) bucket of the candidate forward; context and
    # candidate column halves are views of one block, as the engine passes them
    emb_ctx = randn(r_rows, fc, f, k, scale=0.1)
    val_ctx = uniform(0.5, 1.5, r_rows, fc)
    vcand = uniform(0.5, 1.5, r_rows, n_cand, fcand)
    ec = randn(r_rows, n_cand, fcand, f, k, scale=0.1)
    qc = codes(r_rows, n_cand, fcand, f, k)
    qs = uniform(1e-4, 1e-3, r_rows, n_cand, fcand)
    qz = randn(r_rows, n_cand, fcand, scale=0.01)
    # bytes and operations of K2-K6 (and K1, K4): the wrappers' bookings
    # (kernels/*/ops.py:k*_work), every input read once, every output
    # written once
    bucket = (r_rows, n_cand, fc, fcand, k)
    args_f32 = (emb_ctx[:, :, fc:], val_ctx, ec[..., :fc, :], ec[..., fc:, :],
                vcand)
    kernel_case(
        "ffm_candidate_matrices", "src/repro_torch/csrc/ffm_interaction.cu",
        "src/repro/kernels/ffm_interaction/ffm_interaction.py:75",
        lambda: fi_ops.ffm_candidate_matrices(*args_f32),
        lambda: fi_ref.ffm_candidate_matrices_ref(*args_f32), (1e-5, 1e-6),
        *reversed(fi_ops.k2_work(*bucket)), [r_rows, n_cand, fc, fcand, k])
    args_q8 = (emb_ctx[:, :, fc:], val_ctx, qc[..., :fc, :], qc[..., fc:, :],
               qs, qz, vcand)
    kernel_case(
        "ffm_candidate_matrices_q8", "src/repro_torch/csrc/ffm_interaction.cu",
        "src/repro/kernels/ffm_interaction/ffm_interaction.py:339",
        lambda: fi_ops.ffm_candidate_matrices_q8(*args_q8),
        lambda: fi_ref.ffm_candidate_matrices_q8_ref(*args_q8), (1e-5, 1e-6),
        *reversed(fi_ops.k3_work(*bucket)), [r_rows, n_cand, fc, fcand, k])

    # K4: score_uncached(use_backend=True) over one request's N candidates,
    # f32 as the engine runs it; bf16 checked as the JAX sweep exercises it
    e4 = randn(n_cand, f, f, k, scale=0.3)
    v4 = uniform(0.5, 1.5, n_cand, f)
    e4h, v4h = e4.to(torch.bfloat16), v4.to(torch.bfloat16)
    got = fi_ops.ffm_interaction_matrix(e4h, v4h)
    want = fi_ref.ffm_interaction_matrix_ref(e4h, v4h)
    check(allclose(got, want, 5e-2, 5e-2),
          f"ffm_interaction_matrix bf16: max abs err {max_err(got, want):.3e}")
    print(f"kernel ffm_interaction_matrix bf16 {[n_cand, f, k]}: max abs err "
          f"{max_err(got, want):.3e} (tol 5e-2)")
    kernel_case(
        "ffm_interaction_matrix", "src/repro_torch/csrc/ffm_interaction.cu",
        "src/repro/kernels/ffm_interaction/ffm_interaction.py:35",
        lambda: fi_ops.ffm_interaction_matrix(e4, v4),
        lambda: fi_ref.ffm_interaction_matrix_ref(e4, v4), (1e-5, 1e-4),
        *reversed(fi_ops.k4_work(n_cand, f, k)), [n_cand, f, k],
        library=lambda: torch.einsum("bijk,bjik,bi,bj->bij", e4, e4, v4, v4))
    # K4 on test_kernels.py's sweep and at F = 64, K = 16, in f32 and bf16;
    # D symmetric bit for bit at the main shape (the CPU rehearsal's einsum
    # may order its sums by position, so it is held to 1e-6 there)
    for dtype, (rt, at) in K4_TOL.items():
        dt = getattr(torch, dtype)
        for bb, ff, kk in K4_SWEEP:
            e_, v_ = randn(bb, ff, ff, kk).to(dt), randn(bb, ff).to(dt)
            got = fi_ops.ffm_interaction_matrix(e_, v_)
            want = fi_ref.ffm_interaction_matrix_ref(e_, v_)
            check(got.dtype == dt and allclose(got, want, rt, at),
                  f"ffm_interaction_matrix {dtype} {[bb, ff, kk]}: max abs "
                  f"err {max_err(got, want):.3e} (rtol {rt}, atol {at})")
        d = fi_ops.ffm_interaction_matrix(e4.to(dt), v4.to(dt))
        check(torch.equal(d, d.transpose(1, 2)) if on_card
              else allclose(d, d.transpose(1, 2), 1e-6, 1e-6),
              f"ffm_interaction_matrix {dtype} {[n_cand, f, k]}: D is not "
              "symmetric")
    print(f"kernel ffm_interaction_matrix: {len(K4_SWEEP)} shapes "
          "(test_kernels.py's sweep, F = 64 and K = 16) agree with the plain "
          "version in f32 (1e-5, 1e-4) and bf16 (5e-2, 5e-1); D == D^T at "
          f"{[n_cand, f, k]} in both"
          + (" bit for bit" if on_card else " (plain version, 1e-6)"))

    # K5/K6: one (rb=8, nb=64) bucket of the fused forward with mixed cached
    # prefix depths (0 and Fc among them); the context and candidate column
    # halves are views of one gathered block, as the engine passes them.
    # Ops (k5_work / k6_work): the ctx pair matrix once per row, per
    # candidate the ctx x cand and ic < jc cand x cand terms (int8 dot and
    # code-sum ops counted as f32 operations, so the bound is if anything
    # high)
    depth = torch.randint(0, fc + 1, (r_rows,), generator=gen, device=dev,
                          dtype=torch.int32)
    depth[0], depth[1] = 0, fc
    base = randn(r_rows, n_cand, scale=0.5)

    args_k5 = (emb_ctx, val_ctx, depth, base, qc[..., :fc, :],
               qc[..., fc:, :], qs, qz, vcand)
    kernel_case(
        "ffm_fused_logits_q8", "src/repro_torch/csrc/ffm_fused_logits.cu",
        "src/repro/kernels/ffm_interaction/ffm_interaction.py:268",
        lambda: fi_ops.ffm_fused_logits_q8(*args_k5),
        lambda: fi_ref.ffm_fused_logits_q8_ref(*args_k5), (1e-5, 1e-5),
        *reversed(fi_ops.k5_work(*bucket)), [r_rows, n_cand, fc, fcand, k])
    args_k6 = (emb_ctx, val_ctx, depth, base, ec[..., :fc, :],
               ec[..., fc:, :], vcand)
    kernel_case(
        "ffm_fused_logits_rows", "src/repro_torch/csrc/ffm_fused_logits.cu",
        "src/repro/kernels/ffm_interaction/ffm_interaction.py:307",
        lambda: fi_ops.ffm_fused_logits_rows(*args_k6),
        lambda: fi_ref.ffm_fused_logits_rows_ref(*args_k6), (1e-5, 1e-5),
        *reversed(fi_ops.k6_work(*bucket)), [r_rows, n_cand, fc, fcand, k])

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    # the outputs' bits, for comparing builds of the kernels run by run:
    # ctx_dots, the first tile's logits (candidates 0-3), all logits
    def digests(logits, dots):
        return "/".join((digest(dots), digest(logits[:, :4]), digest(logits)))

    print("kernels ffm_fused_logits_(q8|rows) "
          f"{[r_rows, n_cand, fc, fcand, k]}: sha256 of ctx_dots / tile-0 "
          f"logits / logits: q8 {digests(*fi_ops.ffm_fused_logits_q8(*args_k5))}"
          f" rows {digests(*fi_ops.ffm_fused_logits_rows(*args_k6))}")
    # a row's logits depend on neither the row bucket nor the candidate
    # bucket (fixed-order sums, no atomics): fewer rows, fewer candidates
    # and the full bucket agree bit for bit
    def first_candidates(x, n):
        # candidate blocks stay strided views; the wrapper wants the
        # per-candidate scalars contiguous
        return x[:, :n] if x.dim() == 5 else x[:, :n].contiguous()

    # (the plain versions' CPU reductions may reorder with the shape, so the
    # rehearsal holds them to 1e-6 instead)
    same = (torch.equal if on_card
            else lambda x, y: allclose(x, y, 1e-6, 1e-6))
    for fn, a in ((fi_ops.ffm_fused_logits_q8, args_k5),
                  (fi_ops.ffm_fused_logits_rows, args_k6)):
        # args: three per-row tensors, then base and the candidate blocks
        full, full_d = fn(*a)
        rows, rows_d = fn(*[x[:3] for x in a])
        cut, cut_d = fn(*a[:3], *[first_candidates(x, 37) for x in a[3:]])
        check(same(rows, full[:3]) and same(rows_d, full_d[:3])
              and same(cut, full[:, :37]) and same(cut_d, full_d),
              f"{fn.__name__}: logits change with the row or candidate bucket")
    # every tile of a row adds the same tail: with the base and the
    # candidates' values zeroed, each logit is the tail its tile added (at
    # depth 0: all Fc (Fc - 1) / 2 context pairs), so a row's logits must be
    # one value
    for fn, a in ((fi_ops.ffm_fused_logits_q8, args_k5),
                  (fi_ops.ffm_fused_logits_rows, args_k6)):
        lg, _ = fn(a[0], a[1], torch.zeros_like(a[2]), torch.zeros_like(a[3]),
                   *a[4:-1], torch.zeros_like(a[-1]))
        check(same(lg, lg[:, :1].expand_as(lg)),
              f"{fn.__name__}: the tiles of a row add different tails")
    # K2/K3 likewise: an output depends on its own (row, candidate) only.
    # At the main-path bucket the direct body takes them (it has no tiles);
    # Fcand = 5 sends K = 8 rows through the staged body's vector loads,
    # four candidates per CTA, where 37 cuts a tile
    def candidate_args(r, n, fc_, f_, k_, q8, pad=0):
        """K2 or K3 arguments as the engine passes them: the context and
        candidate column halves are views of one gathered block. pad > 0
        reads each K-row at an offset of `pad` elements in rows of
        K + pad (unaligned, strided views)."""
        fcand_ = f_ - fc_
        ctx = randn(r, fc_, f_, k_)
        blk = (codes(r, n, fcand_, f_, k_ + pad) if q8
               else randn(r, n, fcand_, f_, k_ + pad))[..., pad:]
        grids = ((uniform(1e-3, 1e-2, r, n, fcand_),
                  randn(r, n, fcand_, scale=0.05)) if q8 else ())
        return (ctx[:, :, fc_:], uniform(0.5, 1.5, r, fc_),
                blk[..., :fc_, :], blk[..., fc_:, :], *grids,
                uniform(0.5, 1.5, r, n, fcand_))

    cand_fns = ((fi_ops.ffm_candidate_matrices,
                 fi_ref.ffm_candidate_matrices_ref, False),
                (fi_ops.ffm_candidate_matrices_q8,
                 fi_ref.ffm_candidate_matrices_q8_ref, True))
    for fn, plain, q8 in cand_fns:
        for a in ((args_q8 if q8 else args_f32),
                  candidate_args(4, 40, 6, 11, 8, q8)):
            # args: two per-row tensors, then the candidate blocks and scalars
            full = fn(*a)
            rows = fn(*[x[:3] for x in a])
            cut = fn(*a[:2], *[first_candidates(x, 37) for x in a[2:]])
            check(allclose(full, plain(*a), 1e-5, 1e-6),
                  f"{fn.__name__} {list(a[2].shape)}: max abs err "
                  f"{max_err(full, plain(*a)):.3e}")
            check(all(same(r_, m[:3]) and same(c_, m[:, :37])
                      for r_, c_, m in zip(rows, cut, full)),
                  f"{fn.__name__} {list(a[2].shape)}: outputs change with "
                  "the row or candidate bucket")
    print("kernels ffm_fused_logits_(q8|rows), ffm_candidate_matrices(_q8) "
          "(direct body at the bucket, staged at Fcand=5): rows [:3] and "
          "candidates [:37] agree with the full bucket's, and K5/K6's tiles "
          "of a row add one tail"
          + (" bit for bit" if on_card else " (plain versions, 1e-6)"))

    # the kernels' general paths, off the main path's shapes: K != 8
    # (K2/K3/K4/K5/K6's runtime-K loop, with a ragged candidate tile)
    ke, fce, fe = 4, 5, 9
    ctx_e, val_e = randn(2, fce, fe, ke), uniform(0.5, 1.5, 2, fce)
    ec_e, vc_e = randn(2, 7, fe - fce, fe, ke), uniform(0.5, 1.5, 2, 7, fe - fce)
    qc_e = codes(2, 7, fe - fce, fe, ke)
    qg_e = (uniform(1e-3, 1e-2, 2, 7, fe - fce), randn(2, 7, fe - fce, scale=0.05))
    depth_e = torch.tensor([fce, 2], dtype=torch.int32, device=dev)
    base_e = randn(2, 7)
    for fn, plain, a in (
            (fi_ops.ffm_candidate_matrices, fi_ref.ffm_candidate_matrices_ref,
             (ctx_e[:, :, fce:], val_e, ec_e[..., :fce, :], ec_e[..., fce:, :],
              vc_e)),
            (fi_ops.ffm_candidate_matrices_q8,
             fi_ref.ffm_candidate_matrices_q8_ref,
             (ctx_e[:, :, fce:], val_e, qc_e[..., :fce, :], qc_e[..., fce:, :],
              *qg_e, vc_e)),
            (fi_ops.ffm_interaction_matrix, fi_ref.ffm_interaction_matrix_ref,
             (randn(5, fe, fe, ke), uniform(0.5, 1.5, 5, fe))),
            (fi_ops.ffm_fused_logits_q8, fi_ref.ffm_fused_logits_q8_ref,
             (ctx_e, val_e, depth_e, base_e, qc_e[..., :fce, :],
              qc_e[..., fce:, :], *qg_e, vc_e)),
            (fi_ops.ffm_fused_logits_rows, fi_ref.ffm_fused_logits_rows_ref,
             (ctx_e, val_e, depth_e, base_e, ec_e[..., :fce, :],
              ec_e[..., fce:, :], vc_e))):
        check(allclose(fn(*a), plain(*a), 1e-5, 1e-5),
              f"{fn.__name__} (K={ke}) disagrees: {max_err(fn(*a), plain(*a))}")
    # K2/K3's staged body: byte-sized int8 rows (K = 3), unaligned strided
    # views at K = 8 (neither vector loads nor the direct body), and a
    # context block past the default 48 KiB of shared memory (Fc = 40,
    # Fcand = 41: 52,640 B)
    for fn, plain, q8 in cand_fns:
        for shape, pad in (((2, 7, 5, 9, 3), 0), ((2, 7, 5, 13, 8), 1),
                           ((2, 5, 40, 81, 8), 0)):
            a = candidate_args(*shape, q8, pad)
            check(allclose(fn(*a), plain(*a), 1e-5, 1e-6),
                  f"{fn.__name__} {list(shape)} pad {pad} disagrees: "
                  f"{max_err(fn(*a), plain(*a)):.3e}")
    # rows without candidates still get their ctx pair matrix
    no_cand = (ctx_e, val_e, depth_e, base_e[:, :0], qc_e[:, :0, :, :fce],
               qc_e[:, :0, :, fce:], qg_e[0][:, :0], qg_e[1][:, :0],
               vc_e[:, :0])
    got, want = (fi_ops.ffm_fused_logits_q8(*no_cand),
                 fi_ref.ffm_fused_logits_q8_ref(*no_cand))
    check(got[0].shape == (2, 0) and allclose(got[1], want[1], 1e-5, 1e-5),
          f"ffm_fused_logits_q8 (N=0): ctx_dots max abs err "
          f"{max_err(got[1], want[1])}")
    print("kernels' general paths (K=4, ragged tiles, N=0; K2/K3 "
          "K=3, unaligned K=8 views, 52,640 B of shared memory): agree with "
          "plain versions")
    # K5/K6 at the main bucket on the same values through unaligned strided
    # views (K-rows one element into rows of K + 1: the scalar runtime-K
    # loads) give the vector path's bits; and a width past the register
    # slots (R=2, N=7, Fc=64, F=128, K=8, depths 0 and 37), where the
    # parent's context staging would not fit in shared memory
    def unaligned(x):
        y = torch.empty((*x.shape[:-1], x.shape[-1] + 1), dtype=x.dtype,
                        device=dev)[..., 1:]
        return y.copy_(x)

    qc_u, ec_u = unaligned(qc), unaligned(ec)
    ctx_u = unaligned(emb_ctx)
    for fn, a, a_u in (
            (fi_ops.ffm_fused_logits_q8, args_k5,
             (ctx_u, *args_k5[1:4], qc_u[..., :fc, :], qc_u[..., fc:, :],
              *args_k5[6:])),
            (fi_ops.ffm_fused_logits_rows, args_k6,
             (ctx_u, *args_k6[1:4], ec_u[..., :fc, :], ec_u[..., fc:, :],
              *args_k6[6:]))):
        check(all(same(g_, w_) for g_, w_ in zip(fn(*a_u), fn(*a))),
              f"{fn.__name__}: unaligned views disagree with the vector path")
    wr, wn, wfc, wf, wk = 2, 7, 64, 128, 8
    wq = codes(wr, wn, wf - wfc, wf, wk)
    we = randn(wr, wn, wf - wfc, wf, wk, scale=0.1)
    wide = (randn(wr, wfc, wf, wk, scale=0.1), uniform(0.5, 1.5, wr, wfc),
            torch.tensor([0, 37], dtype=torch.int32, device=dev),
            randn(wr, wn, scale=0.5))
    wvc = uniform(0.5, 1.5, wr, wn, wf - wfc)
    wide_errs = []
    for fn, plain, a in (
            (fi_ops.ffm_fused_logits_q8, fi_ref.ffm_fused_logits_q8_ref,
             (*wide, wq[..., :wfc, :], wq[..., wfc:, :],
              uniform(1e-4, 1e-3, wr, wn, wf - wfc),
              randn(wr, wn, wf - wfc, scale=0.01), wvc)),
            (fi_ops.ffm_fused_logits_rows, fi_ref.ffm_fused_logits_rows_ref,
             (*wide, we[..., :wfc, :], we[..., wfc:, :], wvc))):
        got, want = fn(*a), plain(*a)
        wide_errs.append(max_err(got, want))
        check(allclose(got, want, 1e-5, 1e-5),
              f"{fn.__name__} {[wr, wn, wfc, wf - wfc, wk]}: max abs err "
              f"{wide_errs[-1]:.3e} (tol (1e-5, 1e-5))")
    print(f"kernels ffm_fused_logits_(q8|rows): unaligned strided views at "
          f"{[r_rows, n_cand, fc, fcand, k]} (the scalar path) equal the "
          "vector path" + (" bit for bit" if on_card else
                           " (plain versions, 1e-6)")
          + f"; {[wr, wn, wfc, wf - wfc, wk]} with depths 0 and 37 within "
          f"(1e-5, 1e-5) of the plain versions (max abs err q8 "
          f"{wide_errs[0]:.3e}, rows {wide_errs[1]:.3e})")

    # K7-K9: the wire quantizer over the whole DeepFFM weight space, as
    # Sender.make_update and the receiver's decode run it, with weights on
    # the rounded grid's bounds and on code tie points
    n_w = sum(math.prod(spec.shape) for _, spec in
              layout.leaves(deepffm.param_specs(cfg, "deepffm")))
    src = "src/repro_torch/csrc/quantize.cu"
    kq = "src/repro/kernels/quantize/quantize.py"

    def wire_weights(n, scale, tails):
        """n seeded f32 weights, with the grid's bounds and code tie points
        at the start (and, with ``tails``, at the end too)."""
        w = randn(n, scale=scale)
        w_min, w_max, bucket = Q.compute_bounds(w)
        ties = torch.arange(1, 9, device=dev, dtype=torch.float32) * 7001.0
        marks = torch.cat([torch.tensor([w_min, w_max], device=dev),
                           w_min + ties * bucket,
                           w_min + (ties + 0.5) * bucket])
        w[:18] = marks
        if tails:
            w[-18:] = marks
        return w, w_min, bucket

    def wire_cases(w, w_min, bucket, into=None, iters=TIMING_ITERS):
        n = w.numel()
        qw = q_ops.quantize_codes(w, w_min, bucket)
        recs = [
            kernel_case("minmax", src, f"{kq}:57", lambda: q_ops.minmax(w),
                        lambda: q_ref.minmax_ref(w), "exact", 4 * n, 2 * n,
                        [n], library=lambda: torch.aminmax(w), eager=True,
                        into=into, iters=iters),
            kernel_case("quantize_codes", src, f"{kq}:83",
                        lambda: q_ops.quantize_codes(w, w_min, bucket),
                        lambda: q_ref.quantize_codes_ref(w, w_min, bucket),
                        "exact", 6 * n, 4 * n, [n], eager=True, into=into,
                        iters=iters),
            kernel_case("dequantize_codes", src, f"{kq}:106",
                        lambda: q_ops.dequantize_codes(qw, w_min, bucket),
                        lambda: q_ref.dequantize_codes_ref(qw, w_min, bucket),
                        "exact", 6 * n, 2 * n, [n], eager=True, into=into,
                        iters=iters)]
        return recs, qw

    w, w_min, bucket = wire_weights(n_w, 0.1, tails=False)
    wire_main, qw = wire_cases(w, w_min, bucket)
    # general paths: a length that is no multiple of 4 and unaligned views
    # (the scalar loops), and NaN propagating through the min/max
    odd = w[1:10_004]
    check(torch.equal(q_ops.minmax(odd), q_ref.minmax_ref(odd))
          and torch.equal(q_ops.quantize_codes(odd, w_min, bucket),
                          q_ref.quantize_codes_ref(odd, w_min, bucket))
          and torch.equal(q_ops.dequantize_codes(qw[1:10_004], w_min, bucket),
                          q_ref.dequantize_codes_ref(qw[1:10_004], w_min,
                                                     bucket)),
          "wire kernels (unaligned, ragged length) disagree")
    nan_w = w[:1000].clone()
    nan_w[500] = float("nan")
    check(bool(torch.isnan(q_ops.minmax(nan_w)).all()),
          "minmax does not propagate NaN")
    print("wire kernels' general paths (unaligned, ragged length, NaN): agree "
          "with plain versions")
    del w, qw, nan_w, odd
    # K7-K9 again over llama3.2-1b's whole weight space, as serve_llm ships
    # it (~1.24 G weights: f32 byte offsets past 2^32, the codes' past 2^31),
    # tie points at both ends; records under the main records' "llama"
    n_l = sum(math.prod(spec.shape) for _, spec in
              layout.leaves(llm_registry.param_specs(llm_cfg)))
    w, w_min, bucket = wire_weights(n_l, 0.02, tails=True)
    llama_recs = []
    _, qw = wire_cases(w, w_min, bucket, into=llama_recs, iters=WIRE_BIG_ITERS)
    for main, rec in zip(wire_main, llama_recs):
        main["llama"] = rec
    print(f"wire kernels at llama3.2-1b's n = {n_l:,} ({2 * n_l:,} code bytes,"
          f" {4 * n_l:,} f32 bytes): min/max, codes and floats equal their "
          "plain versions bit for bit | " + ", ".join(
              f"{r['name']} {r['ms']} ms (bound {r['bound_ms']:.4f} ms, "
              f"plain {r['plain_ms']} ms)" for r in llama_recs))
    del w, qw
    if on_card:
        torch.cuda.empty_cache()

    # K10: one training microbatch's pair of launches, the weight gradients
    # of the two hidden layers (x: MergeNorm output / first hidden layer's
    # activations; g: the ReLU-masked gradient, about half of it zero)
    dims = (cfg.n_pairs + 1,) + tuple(cfg.mlp_hidden)
    pairs = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        pairs.append((randn(TRAIN_BATCH, d_in),
                      randn(TRAIN_BATCH, d_out)
                      * (uniform(0, 1, TRAIN_BATCH, d_out) < 0.5)))
    k10_bytes = sum((x.numel() + g.numel() + x.shape[1] * g.shape[1]) * 4
                    for x, g in pairs)
    # the products the data needs: each nonzero g[b, j] meets the I values
    # of x[b] (a skipped block's would be zeros)
    k10_flops = sum(2 * x.shape[1] * int((g != 0).sum()) for x, g in pairs)
    kernel_case(
        "sparse_weight_grad", "src/repro_torch/csrc/sparse_mlp.cu",
        "src/repro/kernels/sparse_mlp/sparse_mlp.py:40",
        lambda: tuple(sk_ops.sparse_weight_grad(x, g) for x, g in pairs),
        lambda: tuple(sk_ref.sparse_weight_grad_ref(x, g) for x, g in pairs),
        (1e-4, 1e-4), k10_bytes, k10_flops,
        [[TRAIN_BATCH, x.shape[1], g.shape[1]] for x, g in pairs],
        library=lambda: tuple(torch.matmul(x.T, g) for x, g in pairs))
    for x, g in pairs:
        b_ms, _ = bound((x.numel() + g.numel() + x.shape[1] * g.shape[1]) * 4,
                        2 * x.shape[1] * int((g != 0).sum()))
        print(f"kernel sparse_weight_grad {list(x.shape)} x {list(g.shape)}: "
              f"device {device_ms(lambda: sk_ops.sparse_weight_grad(x, g))} "
              f"ms | torch.matmul {device_ms(lambda: torch.matmul(x.T, g))} "
              f"ms | bound {b_ms:.3e} ms")
    # test_kernels.py's sweep; an all-zero g gives exact zeros, even where
    # x is NaN (a skipped block adds nothing; the plain einsum gives NaN);
    # a dead 128-row batch block (K10's block) is skipped whatever x holds
    # (B = 129, 1000 and 100 cross the edges of the batch blocks: a last
    # block of one row, eight blocks in two shared-memory stages of four,
    # one ragged block)
    for (bb, ii, jj), sparsity in ((shape, sp) for shape in (
            (16, 8, 8), (64, 32, 48), (200, 130, 260), (128, 128, 128),
            (33, 257, 65), (129, 277, 64), (1000, 277, 64), (100, 277, 64),
            (129, 64, 32), (1000, 64, 32), (100, 64, 32))
            for sp in (0.0, 0.5, 1.0)):
        x = randn(bb, ii)
        g = randn(bb, jj) * (uniform(0, 1, bb, jj) >= sparsity)
        got, want = sk_ops.sparse_weight_grad(x, g), sk_ref.sparse_weight_grad_ref(x, g)
        check(allclose(got, want, 1e-4, 1e-4) and
              (sparsity < 1.0 or bool((got == 0).all())),
              f"sparse_weight_grad {[bb, ii, jj]} sparsity {sparsity}: max "
              f"abs err {max_err(got, want):.3e}")
    if on_card:
        # the first block, then rows 256-383 of a 512 batch (the third
        # block of those a CTA holds at once) at both layer widths
        for bb, ii, jj, dead in ((300, 40, 24, slice(0, 128)),
                                 (512, 64, 32, slice(256, 384)),
                                 (512, 277, 64, slice(256, 384))):
            x, g = randn(bb, ii), randn(bb, jj)
            g[dead] = 0
            x[dead] = float("nan")
            clean = x.clone()
            clean[dead] = 0
            check(torch.equal(sk_ops.sparse_weight_grad(x, torch.zeros_like(g)),
                              torch.zeros(ii, jj, device=dev))
                  and allclose(sk_ops.sparse_weight_grad(x, g),
                               sk_ref.sparse_weight_grad_ref(clean, g), 1e-4,
                               1e-4),
                  f"sparse_weight_grad {[bb, ii, jj]}: a skipped block (rows "
                  f"{dead.start}-{dead.stop - 1}) changed the result")
    x, g = pairs[0]
    check(torch.equal(sk_ops.sparse_weight_grad(x, g),
                      sk_ops.sparse_weight_grad(x, g)),
          "sparse_weight_grad differs between two launches")
    print("kernel sparse_weight_grad: test_kernels.py sweep and B = 129 / "
          "1000 / 100 at (277, 64) and (64, 32) within 1e-4, all-zero g "
          "exact zeros, "
          + ("NaN x in skipped blocks (rows 0-127, 256-383) ignored, "
             if on_card else "")
          + "two launches bit-identical")
    del pairs

    # K11: one prefill layer's attention (B prompts of P tokens, the
    # config's heads, causal) in bf16 as served, then in f32, then
    # test_kernels.py's sweep and the kernel's other instances (D = 128,
    # ragged tiles, a window whose first live tile is wholly masked for
    # some rows, no mask)
    fa_b, fa_s = llm["batch"], llm["prompt"]
    fa_h, fa_kv = llm_cfg.n_heads, llm_cfg.n_kv_heads
    fa_d = llm_cfg.resolved_head_dim

    def qkv(b, s_, h, kv_, d, dtype, sk=None, dv=None):
        sk = s_ if sk is None else sk
        dv = d if dv is None else dv
        return (randn(b, s_, h, d).to(dtype), randn(b, sk, kv_, d).to(dtype),
                randn(b, sk, kv_, dv).to(dtype))

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_of(q_, k_, v_, causal):
        """The library yardstick: PyTorch's fused attention on (B, H, S, D)
        copies made outside the timed region (its causal mask is aligned at
        position 0 too; it takes MLA's v at its own width, as K11 does)."""
        h, kv_ = q_.shape[2], k_.shape[2]
        lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q_, k_, v_))
        if "enable_gqa" in (sdpa.__doc__ or ""):
            def library():
                return sdpa(lq, lk, lv, is_causal=causal, enable_gqa=True)
        else:
            lk, lv = (t.repeat_interleave(h // kv_, dim=1) for t in (lk, lv))

            def library():
                return sdpa(lq, lk, lv, is_causal=causal)
        return library

    def flash_bf16_case(b_, s_, h, kv_, d, into=None, sk=None, causal=True,
                        dv=None):
        """K11's bf16 body at one layer's shape (Sq = ``s_``, Sk = ``sk``,
        ``s_`` unless given; v ``dv`` wide, ``d`` unless given), timed
        beside scaled_dot_product_attention, held to 3e-2 and to the
        roundoff bounds; its record goes to ``into`` as :func:`kernel_case`
        puts it."""
        sk = s_ if sk is None else sk
        dv = d if dv is None else dv
        fq, fk, fv = qkv(b_, s_, h, kv_, d, torch.bfloat16, sk, dv)
        fa_io = 2 * attention_elements(fq, fk, fv, causal)
        fa_flops = 2 * (d + dv) * b_ * h * attention_pairs(s_, sk, causal, 0)
        library = sdpa_of(fq, fk, fv, causal)
        dims = [d] if dv == d else [d, dv]
        shape = [b_, s_, h, kv_, *dims] if sk == s_ and causal else [
            b_, s_, sk, h, kv_, *dims, "causal" if causal else "unmasked"]

        def fn():
            return fa_ops.flash_attention(fq, fk, fv, causal=causal)

        rec = kernel_case(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:85", fn,
            lambda: fa_ref.flash_attention_ref(fq, fk, fv, causal=causal),
            (FLASH_TOL["bfloat16"],) * 2, fa_io, fa_flops, shape,
            library=library, eager=True, peak_flops=PEAK_BF16_TENSOR_FLOPS,
            into=into)
        rec["kernel_ms"], rec["library_kernel_ms"] = (kernel_ms(fn),
                                                      kernel_ms(library))
        if on_card:
            print(f"kernel flash_attention bf16 {shape}: {rec['ms']:.4f} ms "
                  "against scaled_dot_product_attention's "
                  f"{rec['library_ms']:.4f} ms in this run: "
                  f"{rec['ms'] / rec['library_ms']:.2f}x its time | "
                  f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound "
                  f"({rec['bound_by']}) | kernels alone (behind a spin) "
                  f"{ms_text(rec['kernel_ms'], rec['bound_ms'])} against "
                  f"{ms_text(rec['library_kernel_ms'])} | {smi}")
        fa_want = fa_ref.flash_attention_ref(fq, fk, fv, causal=causal)
        elem, row = check_flash_bf16(
            fa_ops.flash_attention(fq, fk, fv, causal=causal), fa_want, fq,
            fk, fv, f"flash_attention bf16 {shape}", causal)
        lib = flash_bf16_errors(library().transpose(1, 2), fa_want, fq, fk,
                                fv, causal)
        print(f"kernel flash_attention bf16 {shape}: worst element "
              f"{elem:.3f} of 2u(A + |o|), worst row {row:.3f} of 4u |o| (u ="
              " 2^-8); scaled_dot_product_attention vs the plain version: "
              f"max abs err {max_err(library().transpose(1, 2), fa_want):.3e}"
              f", {lib[0]:.3f} / {lib[1]:.3f} of the same bounds (the "
              "yardstick, not checked)")
        return rec

    def flash_f32_case(b_, s_, h, kv_, d, into=None, sk=None, causal=True,
                       dv=None):
        """K11's f32 body at one layer's shape, within 2e-5 (max abs
        error). With ``into`` its record (time, bound, plain and
        scaled_dot_product_attention times) goes there; else it prints its
        error, time and bound."""
        sk = s_ if sk is None else sk
        dv = d if dv is None else dv
        fq, fk, fv = qkv(b_, s_, h, kv_, d, torch.float32, sk, dv)
        f32_io = 4 * attention_elements(fq, fk, fv, causal)
        f32_flops = 2 * (d + dv) * b_ * h * attention_pairs(s_, sk, causal, 0)
        if into is not None:
            shape = [b_, s_, sk, h, kv_, *([d] if dv == d else [d, dv]),
                     "f32", "causal" if causal else "unmasked"]

            def fn():
                return fa_ops.flash_attention(fq, fk, fv, causal=causal)

            library = sdpa_of(fq, fk, fv, causal)
            rec = kernel_case(
                "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:85", fn,
                lambda: fa_ref.flash_attention_ref(fq, fk, fv, causal=causal),
                (0.0, FLASH_TOL["float32"]), f32_io, f32_flops, shape,
                library=library, eager=True, into=into)
            rec["kernel_ms"], rec["library_kernel_ms"] = (kernel_ms(fn),
                                                          kernel_ms(library))
            if on_card:
                print(f"kernel flash_attention f32 {shape}: {rec['ms']:.4f} "
                      "ms against scaled_dot_product_attention's "
                      f"{rec['library_ms']:.4f} ms (f32, TF32 off) | "
                      f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the "
                      f"bound ({rec['bound_by']}, f32 peak) | kernels alone "
                      f"(behind a spin) "
                      f"{ms_text(rec['kernel_ms'], rec['bound_ms'])}"
                      f" against {ms_text(rec['library_kernel_ms'])} | {smi}")
            return rec
        shape = [b_, s_, h, kv_, d]
        got = fa_ops.flash_attention(fq, fk, fv)
        err = max_err(got, fa_ref.flash_attention_ref(fq, fk, fv))
        check(err <= FLASH_TOL["float32"],
              f"flash_attention f32 {shape}: max abs err {err:.3e} > "
              f"{FLASH_TOL['float32']}")
        f32_bound, f32_by = bound(f32_io, f32_flops)
        print(f"kernel flash_attention f32 {shape}: max abs err {err:.3e} "
              f"(tol {FLASH_TOL['float32']}) | device "
              f"{call_ms(lambda: fa_ops.flash_attention(fq, fk, fv))} ms | "
              f"bound {f32_bound:.3e} ms ({f32_by}, f32 peak)")

    def flash_padded_route(b_, s_, h, kv_, d, kept):
        """The route not taken for a head dim between the instances: q, k
        and v zero-padded to the next instance's width on the host, K11 at
        that width with scale d^-1/2, the output sliced back (pads and slice
        timed with it). Held to the plain version (3e-2); its time beside
        ``kept``'s (the in-kernel route's record) and SDPA's. Card only."""
        if not on_card:
            print(f"kernel flash_attention padded route D = {d}: not "
                  "measured (no card)")
            return None
        dp = min(x for x, xv in fa_ops.BODIES[torch.bfloat16][1]
                 if x == xv and x > d)
        fq, fk, fv = qkv(b_, s_, h, kv_, d, torch.bfloat16)

        def padded():
            qp, kp, vp = (torch.nn.functional.pad(t, (0, dp - d))
                          for t in (fq, fk, fv))
            out = torch.empty_like(qp)
            _build.launch("flash_attention", qp.data_ptr(), kp.data_ptr(),
                          vp.data_ptr(), out.data_ptr(), None, b_, s_, s_, h,
                          kv_, dp, dp, 1, 0, 1, float(np.float32(d ** -0.5)))
            return out[..., :d].contiguous()

        got = padded()
        want = fa_ref.flash_attention_ref(fq, fk, fv)
        err = max_err(got, want)
        check(allclose(got, want, *(FLASH_TOL["bfloat16"],) * 2),
              f"flash_attention padded route D = {d}: max abs err {err:.3e}")
        rec = {"ms": call_ms(padded), "kernel_ms": kernel_ms(padded),
               "max_abs_err": err, "width": dp}
        faster = "in-kernel" if kept["ms"] <= rec["ms"] else "padded"
        print(f"kernel flash_attention bf16 D = {d} routes {[b_, s_, h, kv_]}"
              f": in-kernel (TMA zero-fills columns {d}-{dp - 1}) "
              f"{kept['ms']:.4f} ms per call, alone "
              f"{ms_text(kept['kernel_ms'])}; padded on the host to {dp} "
              f"{rec['ms']:.4f} ms per call, alone {ms_text(rec['kernel_ms'])}"
              f"; SDPA {kept['library_ms']:.4f} ms; faster here: {faster} | "
              f"{smi}")
        return rec

    flash_rec = flash_bf16_case(fa_b, fa_s, fa_h, fa_kv, fa_d)
    flash_f32_case(fa_b, fa_s, fa_h, fa_kv, fa_d)
    # the other families' prefill layers at D = 128: GQA 4:1 (phi3.5-moe,
    # granite-8b) and 8:1 (qwen2.5-3b), each in bf16 as served, the 8:1
    # one also in f32; their records ride on the main shape's (launches are
    # counted on the main record only)
    flash_rec["d128"] = []
    for h, kv_ in FLASH_D128_HEADS:
        flash_bf16_case(fa_b, fa_s, h, kv_, 128, into=flash_rec["d128"])
    flash_f32_case(fa_b, fa_s, *FLASH_D128_HEADS[-1], 128)
    # seamless-m4t's attention (16 / 16 heads of 64, B = 4, 1024 frames):
    # the encoder (unmasked, Sq = Sk), the forward's cross-attention (256
    # target positions against 1024 frames) and a decode step's (Sq = 1),
    # then Sq != Sk under the causal mask, aligned at position 0; each in
    # bf16 and in f32, their records under the main record's "seamless"
    flash_rec["seamless"] = []
    for sq, sk, causal in FLASH_SEAMLESS:
        # the rehearsal's S scales the shapes down
        sq, sk = (max(1, n * fa_s // FLASH_SEAMLESS[0][0]) for n in (sq, sk))
        for case in (flash_bf16_case, flash_f32_case):
            case(fa_b, sq, FLASH_SEAMLESS_HEADS, FLASH_SEAMLESS_HEADS,
                 FLASH_SEAMLESS_D, into=flash_rec["seamless"], sk=sk,
                 causal=causal)
    # zamba2-7b's shared attention block (32 / 32 heads of 112, B = 4, S =
    # 1024, causal): the D = 112 instance in bf16 as served and in f32 as the
    # oracle runs it, records under the main record's "d112"; then the route
    # it was chosen over, timed in the same place
    flash_rec["d112"] = []
    rec112 = flash_bf16_case(fa_b, fa_s, *FLASH_D112, into=flash_rec["d112"])
    flash_f32_case(fa_b, fa_s, *FLASH_D112, into=flash_rec["d112"])
    rec112["padded_route"] = flash_padded_route(fa_b, fa_s, *FLASH_D112,
                                                rec112)
    # deepseek-v2's MLA prefill (qk / v 192 / 128, v unpadded) in bf16 as
    # served and in f32 as the oracle runs it, then the smoke config's
    # (48, 32) on a small shape; records under the main record's "mla"
    flash_rec["mla"] = []
    h, kv_, d, dv = FLASH_MLA
    flash_bf16_case(fa_b, fa_s, h, kv_, d, into=flash_rec["mla"], dv=dv)
    flash_f32_case(fa_b, fa_s, h, kv_, d, into=flash_rec["mla"], dv=dv)
    b_, s_, h, kv_, d, dv = FLASH_MLA_SMALL
    for case in (flash_bf16_case, flash_f32_case):
        case(b_, s_, h, kv_, d, into=flash_rec["mla"], dv=dv)
    worst = [0.0, 0.0]
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dtype).removeprefix("torch.")]
        for case in FLASH_SWEEP + FLASH_MLA_SWEEP:
            b_, s_, h, kv_, d, causal, window, *dv = case
            q_, k_, v_ = qkv(b_, s_, h, kv_, d, dtype, dv=(dv or [d])[0])
            got = fa_ops.flash_attention(q_, k_, v_, causal=causal,
                                         window=window)
            want = fa_ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                              window=window)
            what = (f"flash_attention {dtype} {[b_, s_, h, kv_, d, *dv]} "
                    f"causal {causal} window {window}")
            check(allclose(got, want, tol, tol),
                  f"{what}: max abs err {max_err(got, want):.3e} > {tol}")
            if dtype == torch.bfloat16:
                worst = [max(w, x) for w, x in zip(worst, check_flash_bf16(
                    got, want, q_, k_, v_, what, causal, window))]
    print(f"kernel flash_attention: {len(FLASH_SWEEP + FLASH_MLA_SWEEP)} "
          "sweep cases (test_kernels.py's, D = 128, ragged tiles, S below "
          "one tile, windows past the first tile, MLA's (192, 128) and "
          "(48, 32)) agree with the plain "
          f"version in f32 (2e-5) and bf16 (3e-2; worst element {worst[0]:.3f}"
          f" and row {worst[1]:.3f} of the roundoff bounds)")

    # K13 (dQ) and K12 (dK, dV), flash attention's backward: the port's own
    # kernels (the JAX package differentiates its jnp flash), held to the
    # plain backward on K11's output and log-sum-exp, which K11 is held to
    # first; each kernel timed alone beside its bound, the plain backward
    # and the backward alone of autograd through scaled_dot_product_attention
    def sdpa_bwd_of(q_, k_, v_, do_, causal):
        """The library yardstick: the backward alone (dq, dk, dv) of autograd
        through scaled_dot_product_attention on (B, H, S, D) copies, its
        forward run once outside the timed region."""
        h, kv_ = q_.shape[2], k_.shape[2]
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q_, k_, v_))
        gout = do_.transpose(1, 2).contiguous()
        if "enable_gqa" in (sdpa.__doc__ or ""):
            out = sdpa(lq, lk, lv, is_causal=causal, enable_gqa=True)
        else:
            out = sdpa(lq, lk.repeat_interleave(h // kv_, dim=1),
                       lv.repeat_interleave(h // kv_, dim=1), is_causal=causal)

        def library():
            return torch.autograd.grad(out, (lq, lk, lv), gout,
                                       retain_graph=True)
        return library

    def flash_lse_case(b_, s_, h, kv_, d):
        """K11's training instance (each row's log-sum-exp written, f32 (B,
        H, Sq)) in bf16 at one causal shape: held to the plain version with
        its lse, timed beside its bound (the lse's bytes counted), the plain
        version and scaled_dot_product_attention's forward under grad (which
        saves its log-sum-exp too); the record goes under K11's main record
        as "lse"."""
        q_, k_, v_ = qkv(b_, s_, h, kv_, d, torch.bfloat16)

        def fn():
            return fa_ops.flash_attention_fwd(q_, k_, v_, causal=True)

        def plain():
            return fa_ref.flash_attention_ref(q_, k_, v_, causal=True,
                                              return_lse=True)

        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q_, k_, v_))
        if "enable_gqa" in (sdpa.__doc__ or ""):
            def library():
                with torch.enable_grad():
                    return sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)
        else:
            def library():
                with torch.enable_grad():
                    return sdpa(lq, lk.repeat_interleave(h // kv_, dim=1),
                                lv.repeat_interleave(h // kv_, dim=1),
                                is_causal=True)
        (o_, lse_), (o_ref, lse_ref) = fn(), plain()
        lse_share = float(((lse_ - lse_ref).abs() / (1 + lse_ref.abs()))
                          .max()) / LSE_TOL["bfloat16"]
        elem, row = check_flash_bf16(o_, o_ref, q_, k_, v_,
                                     f"flash_attention with lse {[b_, s_]}")
        check(lse_share <= 1, f"flash_attention with lse: lse at "
              f"{lse_share:.3f} of its bound")
        io = 2 * attention_elements(q_, k_, v_, True) + 4 * b_ * h * s_
        flops = 2 * (2 * d) * b_ * h * attention_pairs(s_, s_, True, 0)
        b_ms, b_by = bound(io, flops, PEAK_BF16_TENSOR_FLOPS)
        rec = {"shape": [b_, s_, h, kv_, d, "bfloat16", "causal", "lse"],
               "ms": call_ms(fn), "kernel_ms": kernel_ms(fn),
               "plain_ms": call_ms(plain, 10, 1), "bound_ms": b_ms,
               "bound_by": b_by, "bytes": io,
               "library_ms": call_ms(library),
               "library_kernel_ms": kernel_ms(library),
               "max_abs_err": max_err(o_, o_ref), "lse_share": lse_share}
        flash_rec["lse"] = rec
        timing = "not measured (no card)"
        if on_card:
            timing = (f"{rec['ms']:.4f} ms per call, alone "
                      f"{ms_text(rec['kernel_ms'], b_ms)} | bound {b_ms:.4f} "
                      f"ms ({b_by}; {io} bytes, the lse's {4 * b_ * h * s_}) |"
                      f" plain {rec['plain_ms']:.4f} ms | "
                      "scaled_dot_product_attention's forward under grad "
                      f"{rec['library_ms']:.4f} ms, alone "
                      f"{ms_text(rec['library_kernel_ms'])} | {smi}")
        print(f"kernel flash_attention with lse (the training instance) "
              f"{rec['shape']}: out at {elem:.3f} / {row:.3f} of the element"
              f" / row bounds, lse at {lse_share:.3f} of its bound | "
              + timing)

    def flash_bwd_case(b_, sq, sk, h, kv_, d, dv, causal, window, n_timed,
                       dtype):
        """K11's log-sum-exp, then K13 and K12 against the plain backward at
        one shape; returns their two records (K13's, K12's)."""
        bf16 = dtype == torch.bfloat16
        tname = str(dtype).removeprefix("torch.")
        q_, k_, v_ = qkv(b_, sq, h, kv_, d, dtype, sk, dv)
        do_ = randn(b_, sq, h, dv).to(dtype)
        o_, lse_ = fa_ops.flash_attention_fwd(q_, k_, v_, causal=causal,
                                              window=window)
        o_ref, lse_ref = fa_ref.flash_attention_ref(
            q_, k_, v_, causal=causal, window=window, return_lse=True)
        lse_share = float(((lse_ - lse_ref).abs() / (1 + lse_ref.abs()))
                          .max()) / LSE_TOL[tname]
        what = (f"flash backward {tname} {[b_, sq, sk, h, kv_, d, dv]} "
                f"causal {causal} window {window}")
        check(allclose(o_, o_ref, FLASH_TOL[tname], FLASH_TOL[tname])
              and lse_share <= 1,
              f"{what}: K11 with lse: out err {max_err(o_, o_ref):.3e}, lse "
              f"{lse_share:.3f} of its bound")
        got = fa_ops.flash_attention_bwd(q_, k_, v_, o_, lse_, do_,
                                         causal=causal, window=window)
        want = fa_ref.flash_attention_bwd_ref(q_, k_, v_, o_, lse_, do_,
                                              causal=causal, window=window)
        again = fa_ops.flash_attention_bwd(q_, k_, v_, o_, lse_, do_,
                                           causal=causal, window=window)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"{what}: two backward calls differ")
        body = fa_ops.BWD_BODIES[dtype][0]
        # bf16: each gradient's terms on absolute values (A), the scale of
        # the roundings of P and dS
        terms = (fa_ref.flash_attention_bwd_abs_ref(
            q_, k_, v_, o_, lse_, do_, causal=causal, window=window)
            if bf16 else (None,) * 3)
        shares = {}
        for gname, g, w, a in zip(("dq", "dk", "dv"), got, want, terms):
            if bf16:
                shares[gname] = bwd_bf16_share(g, w, a)
            else:
                w = w.float()
                shares[gname] = (float((g.float() - w).abs().max())
                                 / max(BWD_REL * float(w.abs().max()), 1e-30))
            check(shares[gname] <= 1, f"{what}: {gname} at "
                  f"{shares[gname]:.3f} of its bound")
        # each kernel alone, on outputs allocated once (K13 first: it
        # writes the rowsum(dO o O) that K12 reads)
        dq_, dk_, dv_ = (torch.empty_like(t) for t in (q_, k_, v_))
        delta_ = torch.empty((b_, h, sq), dtype=torch.float32, device=dev)
        sizes = (b_, sq, sk, h, kv_, d, dv, int(causal), window, int(bf16),
                 float(np.float32(d ** -0.5)))

        def k13():
            _build.launch("flash_attention_bwd_dq", q_.data_ptr(),
                          k_.data_ptr(), v_.data_ptr(), o_.data_ptr(),
                          lse_.data_ptr(), do_.data_ptr(), dq_.data_ptr(),
                          delta_.data_ptr(), *sizes)

        def k12():
            _build.launch("flash_attention_bwd_dkdv", q_.data_ptr(),
                          k_.data_ptr(), v_.data_ptr(), do_.data_ptr(),
                          lse_.data_ptr(), delta_.data_ptr(), dk_.data_ptr(),
                          dv_.data_ptr(), *sizes)

        def plain():
            return fa_ref.flash_attention_bwd_ref(
                q_, k_, v_, o_, lse_, do_, causal=causal, window=window)

        library = sdpa_bwd_of(q_, k_, v_, do_, causal) if not window else None
        # calls long next to a launch: few of them, one warm-up
        times = {"k13": call_ms(k13, n_timed, 1),
                 "k12": call_ms(k12, n_timed, 1),
                 "plain": call_ms(plain, max(1, n_timed // 5), 1),
                 "library": call_ms(library, n_timed, 1) if library else None}
        # the work each kernel's function needs, from this call's shapes
        esz = 2 if bf16 else 4
        n_pairs = b_ * h * attention_pairs(sq, sk, causal, window)
        live = min(sk, sq) if causal else sk
        q_el, o_el, rows = b_ * sq * h * d, b_ * sq * h * dv, b_ * h * sq
        peak = PEAK_BF16_TENSOR_FLOPS if bf16 else PEAK_F32_FLOPS
        work = {  # (bytes, operations): K13 reads q, the k / v rows some
            # query sees, o, dO and lse and writes dq and Delta; K12 reads q,
            # dO, k, v, lse and Delta and writes dk and dv
            "k13": (esz * (2 * q_el + b_ * live * kv_ * (d + dv) + 2 * o_el)
                    + 8 * rows, 2 * (2 * d + dv) * n_pairs),
            "k12": (esz * (q_el + o_el + 2 * b_ * sk * kv_ * (d + dv))
                    + 8 * rows, 2 * (2 * d + 2 * dv) * n_pairs)}
        recs = []
        for key, name, err in (
                ("k13", "flash_attention_bwd_dq", max_err(got[0], want[0])),
                ("k12", "flash_attention_bwd_dkdv",
                 max(max_err(got[1], want[1]), max_err(got[2], want[2])))):
            b_ms, b_by = bound(*work[key], peak)
            recs.append({
                "name": name, "route": "cuda", "source": BWD_SOURCE,
                "replaces": BWD_REPLACES, "max_abs_err": err,
                "ms": times[key], "plain_ms": times["plain"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": times["library"], "bytes": work[key][0],
                "shape": [b_, sq, sk, h, kv_, d, dv, tname,
                          "causal" if causal else "unmasked", window],
                "tolerance": ("2u(A + |g|) + " if bf16 else "")
                + f"{BWD_REL} max|g|", "body": body,
                "bound_shares": shares, "lse_share": lse_share})
        # the backward as a whole: q, k, v, o, dO and lse read once, dq, dk
        # and dv written once; 2 (3 D + 2 Dv) operations per kept pair
        whole = bound(esz * (2 * q_el + 2 * o_el + b_ * (live + sk) * kv_
                             * (d + dv)) + 4 * rows,
                      2 * (3 * d + 2 * dv) * n_pairs, peak)
        if on_card:
            pair = times["k13"] + times["k12"]
            yard = ("not timed (SDPA has no window)" if library is None
                    else f"{times['library']:.4f} ms: the pair "
                    f"{pair / times['library']:.2f}x its time")
            timing = (
                f"K13 {ms_text(times['k13'], recs[0]['bound_ms'])}, K12 "
                f"{ms_text(times['k12'], recs[1]['bound_ms'])}; the pair "
                f"{pair:.4f} ms against the backward's bound {whole[0]:.4f}"
                f" ms ({whole[1]}) | plain {times['plain']:.4f} ms | "
                f"scaled_dot_product_attention's backward {yard} | {smi}")
        else:
            timing = "not measured (no card)"
        print(f"kernel {what}: {body} bodies; K11 lse at {lse_share:.3f} of "
              "its bound; dq / dk / dv at "
              + " / ".join(f"{v:.3f}" for v in shares.values())
              + " of their bounds (" + recs[0]["tolerance"]
              + "), a repeat bit-identical | " + timing)
        return recs

    b_, sq, _, h, kv_, d = FLASH_BWD[0][:6]
    flash_lse_case(2 if args.tiny else b_, max(1, sq * fa_s // 1024)
                   if args.tiny else sq, h, kv_, d)
    bwd_main = None
    for case in FLASH_BWD:
        b_, sq, sk, h, kv_, d, dv, causal, window, n_timed = case
        if args.tiny:  # the rehearsal scales S down, as for seamless
            b_, sq, sk = 2, max(1, sq * fa_s // 1024), max(1, sk * fa_s // 1024)
            window = window * fa_s // 1024
        for dtype in (torch.bfloat16, torch.float32):
            recs = flash_bwd_case(b_, sq, sk, h, kv_, d, dv, causal, window,
                                  n_timed, dtype)
            if bwd_main is None:
                bwd_main = recs
                for rec in recs:
                    rec["shapes"] = []
                kernels.extend(recs)
            else:
                for main, rec in zip(bwd_main, recs):
                    main["shapes"].append(rec)

    # -- phase 3: the main paths -------------------------------------------
    main_launches = dict.fromkeys(_build.launches, 0)
    phase_launches = {}

    def run_phase(label, fn):
        _build.reset_launches()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        phase_launches[label] = dict(_build.launches)
        for name, c in _build.launches.items():
            main_launches[name] += c
        return out

    # the LLM families first, while the card's memory is free for
    # chameleon-34b's 68.6 GB of weights
    llm_families_path(FAMILIES_TINY if args.tiny else FAMILIES_FULL, args,
                      dev, on_card, smi, run_phase, phase_launches)
    seamless_path(SEAMLESS_TINY if args.tiny else SEAMLESS_FULL, args, dev,
                  on_card, smi, run_phase, phase_launches)
    ssm_path(SSM_TINY if args.tiny else SSM_FULL, args, dev, on_card, smi,
             run_phase, phase_launches)
    mla_path(MLA_TINY if args.tiny else MLA_FULL, args, dev, on_card, smi,
             run_phase, phase_launches)
    # a one-rank world (NCCL on the card) and its 1 x 1 mesh for the
    # expert-parallel MoE and qwen2.5-3b's train step here, while the
    # card's memory is free, and the sharded llama train step after the
    # unsharded one; destroyed after them
    world = contextlib.ExitStack()
    world.enter_context(mesh_lib.world(dev))
    rt = mesh_lib.make_runtime(mesh_lib.make_smoke_mesh(1, 1))
    moe_ep_path(EP_TINY if args.tiny else EP_FULL, args, dev, on_card, smi,
                run_phase, phase_launches, rt)
    qwen_train_path(QWEN_TRAIN_TINY if args.tiny else QWEN_TRAIN_FULL, args,
                    dev, on_card, smi, run_phase, phase_launches, rt)

    # the FFM main path at full width
    t0 = time.perf_counter()
    params = deepffm.init_params(cfg, args.seed, "deepffm", dev)
    last = f"w{len(cfg.mlp_hidden)}"
    params["mlp"][last] = randn(*params["mlp"][last].shape, scale=0.5)
    params["lr"]["w"] = randn(v, scale=0.1)
    engines = {
        "int8": InferenceEngine(cfg, "deepffm", backend="cuda", params=params,
                                device=dev, quantized=True),
        "f32": InferenceEngine(cfg, "deepffm", backend="cuda", params=params,
                               device=dev),
    }
    for eng in engines.values():
        eng.warmup(max_requests=r_rows, max_candidates=n_cand)
    print(f"main path: config {cfg} | engines built and warmed in "
          f"{time.perf_counter() - t0:.1f} s | resident bytes "
          + ", ".join(f"{n} {e.resident_weight_bytes}"
                      for n, e in engines.items()))

    batches = make_traffic(cfg, np.random.default_rng(args.seed))
    scores, uncached = {}, {}
    for name, eng in engines.items():
        scores[name] = run_phase(
            f"{name} score_batch x{len(batches)}",
            lambda eng=eng: [eng.score_batch(mb) for mb in batches])
        uncached[name] = run_phase(
            f"{name} score_uncached(use_backend=True)",
            lambda eng=eng: [eng.score_uncached(*req, use_backend=True)
                             for mb in batches for req in mb])
    for label, counts in phase_launches.items():
        if not label.startswith("llm"):
            print(f"launches {label}: {counts}")

    # oracle: the same engine's plain full forward on the same (quantized)
    # tables; these launches are not part of the main-path counts
    rtol, atol = 2e-4, 2e-5
    for name, eng in engines.items():
        worst_batch = worst_unc = 0.0
        reqs = [req for mb in batches for req in mb]
        got_batch = [s for mb_scores in scores[name] for s in mb_scores]
        for req, got, unc in zip(reqs, got_batch, uncached[name]):
            oracle = eng.score_uncached(*req).cpu().numpy()
            unc = unc.cpu().numpy()
            check(got.shape == (req[2].shape[0],) and np.isfinite(got).all(),
                  f"{name}: bad scores shape {got.shape} or non-finite")
            check(np.allclose(got, oracle, rtol=rtol, atol=atol),
                  f"{name}: score_batch vs score_uncached max abs err "
                  f"{np.abs(got - oracle).max():.3e}")
            check(np.allclose(unc, oracle, rtol=rtol, atol=atol),
                  f"{name}: score_uncached(use_backend=True) vs plain max "
                  f"abs err {np.abs(unc - oracle).max():.3e}")
            worst_batch = max(worst_batch, float(np.abs(got - oracle).max()))
            worst_unc = max(worst_unc, float(np.abs(unc - oracle).max()))
        st = eng.stats
        check(eng.hits > 0 and eng.misses > 0,
              f"{name}: cache hits {eng.hits}, misses {eng.misses}")
        check(st.dedup_saved > 0, f"{name}: dedup saved no rows")
        print(f"engine {name}: {st.requests} requests, {st.candidates} "
              f"candidates, {st.rows_scored} rows scored (dedup saved "
              f"{st.dedup_saved}), hits {eng.hits} misses {eng.misses}, "
              f"max abs err vs oracle: score_batch {worst_batch:.3e}, "
              f"uncached kernel path {worst_unc:.3e} (rtol {rtol}, atol {atol})")
        if on_card:
            print(f"engine {name}: p50 {st.p50_ms:.3f} ms per microbatch, "
                  f"p99 {st.p99_ms:.3f} ms, {st.predictions_per_s:.0f} "
                  f"predictions/s | {smi}")

    # -- phase 3, fused path: "ffm" engines with fused=True beside their
    # staged twins on the same params (the oracle: their launches are not
    # part of the main-path counts) --------------------------------------
    t0 = time.perf_counter()
    fparams = deepffm.init_params(cfg, args.seed + 1, "ffm", dev)
    fparams["lr"]["w"] = randn(v, scale=0.1)
    fused = {}
    for name, quant in (("int8-fused", True), ("f32-fused", False)):
        fused[name] = (
            InferenceEngine(cfg, "ffm", params=fparams, device=dev,
                            quantized=quant, fused=True),
            InferenceEngine(cfg, "ffm", backend="cuda", params=fparams,
                            device=dev, quantized=quant))
        for eng in fused[name]:
            eng.warmup(max_requests=r_rows, max_candidates=n_cand)
    print(f"fused path: \"ffm\" engines and staged twins built and warmed in "
          f"{time.perf_counter() - t0:.1f} s")
    absmax = float(fparams["ffm"]["emb"].abs().max())
    # the second pass: the last microbatch's contexts again, fresh slates
    last_ctxs = list({(ci.tobytes(), cv.tobytes()): (ci, cv)
                      for ci, cv, _, _ in batches[-1]}.values())
    slate_rng = np.random.default_rng(args.seed + 1)
    second = [(ci, cv, *make_slate(cfg, slate_rng, 24)) for ci, cv in last_ctxs]
    for name, (eng, twin) in fused.items():
        kname = ("ffm_fused_logits_q8" if eng.quantized
                 else "ffm_fused_logits_rows")
        first_label = f"{name} score_batch x{len(batches)}"
        second_label = f"{name} second pass"
        got = run_phase(first_label,
                        lambda eng=eng: [eng.score_batch(mb) for mb in batches])
        eng.prefix_hit_depths.clear()
        got.append(run_phase(second_label,
                             lambda eng=eng: eng.score_batch(second)))
        hit = dict(eng.prefix_hit_depths)
        check(hit == {fc: len(last_ctxs)},
              f"{name}: second pass hit depths {hit}, want "
              f"{{{fc}: {len(last_ctxs)}}}")
        for label, n_mb in ((first_label, len(batches)), (second_label, 1)):
            counts = phase_launches[label]
            print(f"launches {label}: {counts}")
            if on_card:
                check(counts[kname] == n_mb,
                      f"{label}: {kname} launched {counts[kname]} times, "
                      f"want one per microbatch ({n_mb})")
                check(counts["ffm_candidate_matrices"] == 0
                      and counts["ffm_candidate_matrices_q8"] == 0,
                      f"{label}: the fused path launched a staged kernel")
        want = [twin.score_batch(mb) for mb in batches]
        want.append(twin.score_batch(second))
        eps = Q.row_max_error(eng.params["ffm"]["emb"]) if eng.quantized else 0.0
        worst = worst_share = 0.0
        for reqs, g_mb, w_mb in zip(batches + [second], got, want):
            vmax = float(max(max(np.abs(r[1]).max(), np.abs(r[3]).max())
                             for r in reqs))
            tol = Q.fused_logit_tolerance(cfg, absmax, eps, vmax=vmax)
            for req, g, w in zip(reqs, g_mb, w_mb):
                check(g.shape == (req[2].shape[0],) and np.isfinite(g).all(),
                      f"{name}: bad scores shape {g.shape} or non-finite")
                dev_abs = float(np.abs(g - w).max())
                check(dev_abs <= tol,
                      f"{name}: fused vs staged twin max abs err "
                      f"{dev_abs:.3e} > fused_logit_tolerance {tol:.3e}")
                worst = max(worst, dev_abs)
                worst_share = max(worst_share, dev_abs / tol)
        st = eng.stats
        check(eng.hits > 0 and eng.misses > 0 and st.dedup_saved > 0,
              f"{name}: hits {eng.hits}, misses {eng.misses}, dedup saved "
              f"{st.dedup_saved}")
        print(f"engine {name}: {st.requests} requests, {st.candidates} "
              f"candidates, {st.rows_scored} rows scored, hits {eng.hits} "
              f"misses {eng.misses}, second pass hit depths {hit}, max abs "
              f"err vs staged twin {worst:.3e} ({100 * worst_share:.3f}% of "
              f"fused_logit_tolerance)")
        if on_card:
            for label, e in ((name, eng), (f"{name} staged twin", twin)):
                print(f"engine {label}: p50 {e.stats.p50_ms:.3f} ms per "
                      f"microbatch, p99 {e.stats.p99_ms:.3f} ms, "
                      f"{e.stats.predictions_per_s:.0f} predictions/s | {smi}")

    update_path(cfg, args, dev, on_card, smi, batches, run_phase,
                phase_launches, randn, r_rows, n_cand)
    train_step = training_path(cfg, args, dev, on_card, smi, batches,
                               run_phase, phase_launches, r_rows, n_cand)
    dcnv2_path(cfg, args, dev, on_card, smi, run_phase)
    server_path(cfg, args, dev, on_card, smi, batches, run_phase,
                phase_launches, params, r_rows, n_cand)
    span_path(cfg, dev, on_card, smi, batches, run_phase, phase_launches,
              params, r_rows, n_cand)
    host_gather_path(cfg, args, dev, on_card, smi, batches, run_phase,
                     phase_launches, params, fparams, randn, r_rows, n_cand)
    fleet_score, fleet_close = fleet_path(
        cfg, args, dev, on_card, smi, batches, run_phase, phase_launches,
        params, engines, r_rows, n_cand)
    quickstart_path(on_card, smi, run_phase, phase_launches)
    serve_llm_path(llm_cfg, SERVE_LLM_TINY if args.tiny else SERVE_LLM_FULL,
                   args, dev, on_card, smi, run_phase, phase_launches)
    train_ctr_path(CTR_TINY if args.tiny else CTR_FULL, args, dev, on_card,
                   smi, run_phase, phase_launches)
    local_sgd_path(cfg, args, dev, on_card, smi, batches, run_phase,
                   phase_launches, r_rows, n_cand)
    hogwild_train = hogwild_path(cfg, args, dev, on_card, smi, batches,
                                 run_phase, phase_launches, r_rows, n_cand)
    llm_prefill, llm_decode = llm_path(llm_cfg, llm, args, dev, on_card, smi,
                                       run_phase, phase_launches)
    llm_tr = LLM_TRAIN_TINY if args.tiny else LLM_TRAIN_FULL
    # the training phases take the config's remat (the smoke config, in
    # the rehearsal, turns it off: set it there too)
    train_cfg = llm_cfg.replace(remat=True)
    llm_train, unsharded = llm_train_path(train_cfg, llm_tr, args, dev,
                                          on_card, smi, run_phase,
                                          phase_launches)
    mesh_train_path(train_cfg, llm_tr, args, dev, on_card, smi, run_phase,
                    phase_launches, rt, unsharded)
    del unsharded
    dryrun_path(train_cfg, DRYRUN_TINY if args.tiny else DRYRUN_FULL, args,
                dev, on_card, smi, run_phase, phase_launches, rt)
    world.close()

    if on_card:
        for name, c in main_launches.items():
            check(c > 0, f"kernel {name} was not launched on the main path")
        for name, eng in engines.items():
            where_the_time_goes(name, lambda eng=eng: eng.score_batch(
                batches[-1]), smi)
        for name, (eng, twin) in fused.items():
            n_fused = where_the_time_goes(
                name, lambda eng=eng: eng.score_batch(batches[-1]), smi)
            n_staged = where_the_time_goes(
                f"{name} staged twin",
                lambda twin=twin: twin.score_batch(batches[-1]), smi)
            print(f"launches per microbatch: {name} {n_fused}, its staged "
                  f"\"ffm\" twin {n_staged}")
        where_the_time_goes("fleet int8 N=4 M=2, one microbatch",
                            fleet_score, smi, top=8,
                            share_of="gather_dequant_rows")
        where_the_time_goes("training microbatch (row-sparse step, B="
                            f"{TRAIN_BATCH})", train_step, smi, top=8,
                            share_of="sparse_weight_grad")
        for n in (1, 4):
            where_the_time_goes(f"hogwild {n} thread(s), 8 microbatches (B="
                                f"{TRAIN_BATCH})", lambda n=n: hogwild_train(n),
                                smi, top=8, share_of="sparse_weight_grad")
        where_the_time_goes(
            f"LLM prefill ({llm_cfg.arch_id}, B={llm['batch']}, P="
            f"{llm['prompt']})", llm_prefill, smi, top=8,
            share_of="flash_attention_kernel")
        where_the_time_goes(
            f"LLM decode step ({llm_cfg.arch_id}, B={llm['batch']}, after the "
            "prefill)", llm_decode, smi, top=8)
        where_the_time_goes(
            f"LLM train step ({llm_cfg.arch_id}, B={LLM_TRAIN_FULL['batch']}, "
            f"S={LLM_TRAIN_FULL['seq']}, Adam, remat)", llm_train, smi, top=8,
            share_of=("flash_attention_kernel", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkdv"))
    fleet_close()
    # the dry run's (d): CPU-only commands, after every timed phase
    finish_dryruns(start_dryruns(args.tiny), 900.0)
    for rec in kernels:
        rec["launches"] = main_launches[rec["name"]]

    print(json.dumps({"kernels": kernels}))
    print(smi)
    if not on_card:
        print("chip_smoke: CPU rehearsal passed; no device result",
              file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_decoded_frame(label, frame, p, eng, wire, sender, batches):
    """``frame``, decoded by ``wire`` (a receiver on the card), against
    ``p``, the weights given to ``sender.make_update``: within the wire
    grid's error bound, and exact where ``p`` lies outside the grid (the
    outlier sidecar). Then ``eng`` (an int8 engine that has applied the
    frame): its int8 tables byte-identical to a full requantize of the
    decoded weights and its dense leaves equal to them, and its scores of
    ``batches`` within the slice-1 tolerance of the uncached oracle.
    Returns the scores and each microbatch's wall time (ms)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import layout
    from repro_torch.core import quantization as Q

    wire.apply_update(frame)
    f32 = wire.materialize(manifest=sender.manifest, like=p)
    meta = sender._last_meta
    lo, hi = meta.w_min, meta.w_min + meta.bucket_size * (Q.B_MAX - 1)
    # half a bucket, plus the f32 roundings of the encode's difference
    # and quotient and the decode's product and sum (under 8 ulps of the
    # grid's largest magnitude)
    w_tol = Q.max_error(meta) + 8 * torch.finfo(torch.float32).eps * max(
        abs(lo), abs(hi))
    decoded = dict(layout.flatten_with_paths(f32))
    w_err, n_out = 0.0, 0
    for path, want in layout.flatten_with_paths(p):
        got = decoded[path]
        out = (want < lo) | (want > hi)  # f32 against the f32 bounds
        n_out += int(out.sum())
        check(torch.equal(got[out], want[out]),
              f"{label}: {path} weights outside the grid were not "
              "carried exactly")
        err = float((got - want).abs().max())
        check(err <= w_tol, f"{label}: {path} decoded max abs err "
              f"{err:.3e} > the grid's bound {w_tol:.3e}")
        w_err = max(w_err, err)
    check(n_out == meta.n_outliers,
          f"{label}: {n_out} weights outside the grid, the sender "
          f"counted {meta.n_outliers}")
    want = Q.quantize_params_rows(f32)
    for path, leaf in layout.leaves(want):
        got = eng.params
        for key in path:
            got = got[key]
        check(torch.equal(got, leaf) if isinstance(leaf, torch.Tensor)
              else got == leaf,
              f"{label}: engine leaf {layout.path_str(path)} "
              "differs from a full requantize of the decoded frame")
    got, ms = [], []  # the microbatches' scores and wall times (ms)
    for mb in batches:
        t0 = time.perf_counter()
        got.append(eng.score_batch(mb))
        ms.append((time.perf_counter() - t0) * 1e3)
    worst = 0.0
    for mb, g_mb in zip(batches, got):
        for req, g in zip(mb, g_mb):
            oracle = eng.score_uncached(*req).cpu().numpy()
            check(g.shape == (req[2].shape[0],) and np.isfinite(g).all()
                  and np.allclose(g, oracle, rtol=SCORE_RTOL, atol=SCORE_ATOL),
                  f"{label}: scores vs the uncached oracle max "
                  f"abs err {np.abs(g - oracle).max():.3e}")
            worst = max(worst, float(np.abs(g - oracle).max()))
    print(f"{label}: decoded weights within {w_err:.3e} of the "
          f"sent ones (bound {w_tol:.3e}; {n_out} outside the grid, "
          f"exact); engine tables and dense leaves equal a full "
          f"requantize of them; scores vs oracle max abs err {worst:.3e} "
          f"(rtol {SCORE_RTOL}, atol {SCORE_ATOL})")
    return got, ms


def update_path(cfg, args, dev, on_card, smi, batches, run_phase,
                phase_launches, randn, r_rows, n_cand):
    """Phase 3, update path: ``Sender.make_update`` -> an int8 DeepFFM
    engine's ``apply_update`` / ``submit_update`` at full width; see the
    module docstring."""
    import threading

    import numpy as np
    import torch

    from repro_torch.checkpoint import transfer as T
    from repro_torch.core import deepffm
    from repro_torch.core import quantization as Q
    from repro_torch.serving.engine import InferenceEngine

    v = cfg.hash_space
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    params = deepffm.init_params(cfg, args.seed + 2, "deepffm", dev)
    last = f"w{len(cfg.mlp_hidden)}"
    params["mlp"][last] = randn(*params["mlp"][last].shape, scale=0.5)
    params["lr"]["w"] = randn(v, scale=0.1)
    sender = T.Sender(device=dev)
    eng = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                          quantized=True)
    wire = T.Receiver(device=dev)  # decodes the same frames for the check
    raw_bytes = None
    rtol, atol = 2e-4, 2e-5

    def perturbed(p, rows, row_scale, dense_scale, bias_shift=0.0):
        """A copy of ``p`` with ``rows`` of ffm/emb and lr/w and every dense
        leaf moved by seeded noise (and lr/b by ``bias_shift``)."""
        def noise(shape, scale):
            return torch.randn(shape, generator=gen, device=dev) * scale

        def walk(node, path=()):
            if isinstance(node, dict):
                return {k: walk(x, path + (k,)) for k, x in node.items()}
            if path in (("ffm", "emb"), ("lr", "w")):
                node = node.clone()
                node[rows] += noise(node[rows].shape, row_scale)
                return node
            node = node + noise(node.shape, dense_scale)
            return node + bias_shift if path == ("lr", "b") else node

        return walk(p)

    def matches(got_mb, want_mb):
        return all(np.allclose(g, w, rtol=rtol, atol=atol)
                   for g, w in zip(got_mb, want_mb))

    def check_frame(label, frame, p):
        return check_decoded_frame(f"update {label}", frame, p, eng, wire,
                                   sender, batches)

    def frame_launches(label, want):
        if not on_card:
            return
        counts = phase_launches[label]
        got = {k: counts[k] for k in want}
        check(got == want, f"{label}: launches {got}, want {want}")

    def report(kind_name, frame, make_ms, apply_ms, st0, st1,
               how="apply_update"):
        share = 100.0 * len(frame) / raw_bytes
        stage = {k: (getattr(st1, k) - getattr(st0, k)) * 1e3 for k in
                 ("frame_seconds", "dequant_seconds", "quantize_seconds",
                  "decode_seconds")}
        publish = apply_ms - stage["decode_seconds"]
        print(f"update {kind_name} frame: {len(frame)} bytes = {share:.3f}% "
              f"of the raw f32 file ({raw_bytes} bytes) | make_update "
              f"{make_ms:.1f} ms | {how} {apply_ms:.1f} ms: frame "
              f"{stage['frame_seconds']:.1f} + dequant "
              f"{stage['dequant_seconds']:.1f} + requantize "
              f"{stage['quantize_seconds']:.1f} + publish/prewarm/rest "
              f"{publish:.1f} ms | {smi}")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    k7, k8, k9 = "minmax", "quantize_codes", "dequantize_codes"
    # round 0: a full frame through apply_update
    frame, make_ms = timed(lambda: run_phase(
        "update make_update full", lambda: sender.make_update(params)))
    raw_bytes = sum(e["nbytes"] for e in sender.manifest)
    check(T.unframe(frame).kind == T.KIND_FULL, "round 0 is not a full frame")
    st0 = eng.update_pipe().stats.__class__(**vars(eng.update_pipe().stats))
    _, apply_ms = timed(lambda: run_phase(
        "update apply_update full",
        lambda: eng.apply_update(frame, sender.manifest, params)))
    report("full", frame, make_ms, apply_ms, st0, eng.update_pipe().stats)
    frame_launches("update make_update full", {k7: 1, k8: 1, k9: 0})
    frame_launches("update apply_update full", {k7: 0, k8: 0, k9: 1})
    eng.warmup(max_requests=r_rows, max_candidates=n_cand)
    check_frame("full", frame, params)

    # round 1: 1% of the rows and LR entries plus every dense leaf; the grid
    # holds by hysteresis, so the frame is a row delta
    n_touch = v // 100
    rows = torch.randperm(v, generator=gen, device=dev)[:n_touch]
    p1 = perturbed(params, rows, 1e-3, 1e-3)
    # eight touched weights pushed outside the grid: hysteresis keeps the
    # grid and the delta's sidecar must carry them exactly
    grid = sender._last_meta
    p1["ffm"]["emb"][rows[:4], 0, 0] = (
        grid.w_min + grid.bucket_size * (Q.B_MAX - 1) + 1.0)
    p1["ffm"]["emb"][rows[4:8], 0, 0] = grid.w_min - 1.0
    touched = {"ffm/emb": rows, "lr/w": rows}
    frame, make_ms = timed(lambda: run_phase(
        "update make_update delta",
        lambda: sender.make_update(p1, touched=touched)))
    check(T.unframe(frame).kind == T.KIND_DELTA,
          f"round 1 frame kind {T.unframe(frame).kind}, want a delta")
    st0 = eng.update_pipe().stats.__class__(**vars(eng.update_pipe().stats))
    _, apply_ms = timed(lambda: run_phase(
        "update apply_update delta", lambda: eng.apply_update(frame)))
    st1 = eng.update_pipe().stats
    report("delta", frame, make_ms, apply_ms, st0, st1)
    frame_launches("update make_update delta", {k7: 1, k8: 1, k9: 0})
    frame_launches("update apply_update delta", {k7: 0, k8: 0, k9: 1})
    requantized = st1.rows_requantized - st0.rows_requantized
    check(requantized == n_touch,
          f"delta requantized {requantized} rows, touched {n_touch}")
    print(f"update delta: {requantized} rows and "
          f"{st1.blocks_requantized - st0.blocks_requantized} LR blocks "
          f"requantized ({n_touch} rows touched of {v})")
    before, ms_before = check_frame("delta", frame, p1)

    # round 2: a patch frame (no touched rows) through submit_update. The
    # main thread scores while the pipe ingests it and after the publish,
    # until flush() would return at once. The publish is held until a full
    # pass of microbatches has been scored against the old generation, so
    # both generations are seen whatever the ingest's speed.
    rows = torch.randperm(v, generator=gen, device=dev)[:v // 20]
    p2 = perturbed(p1, rows, 1e-2, 1e-3, bias_shift=1.0)
    frame, make_ms = timed(lambda: run_phase(
        "update make_update patch", lambda: sender.make_update(p2)))
    check(T.unframe(frame).kind == T.KIND_PATCH,
          f"round 2 frame kind {T.unframe(frame).kind}, want a patch")
    pipe = eng.update_pipe()
    st0 = pipe.stats.__class__(**vars(pipe.stats))
    during, during_ms = [], []
    release = threading.Event()
    publish = eng._publish

    def held_publish(params, version, nbytes):
        check(release.wait(600), "update: the held publish was never released")
        return publish(params, version, nbytes)

    def ingest_while_scoring():
        eng._publish = held_publish
        try:
            assert eng.submit_update(frame)
            after_publish, deadline = 0, time.perf_counter() + 600
            while after_publish < len(batches):
                check(time.perf_counter() < deadline and pipe.stats.frames_failed
                      == st0.frames_failed == 0,
                      f"update: the patch was not published: {pipe.stats}")
                if pipe.stats.published != st0.published:
                    after_publish += 1
                t0 = time.perf_counter()
                during.append(eng.score_batch(batches[len(during)
                                                      % len(batches)]))
                during_ms.append((time.perf_counter() - t0) * 1e3)
                if len(during) == len(batches):
                    release.set()
        finally:
            release.set()
            del eng._publish
        check(pipe.flush(timeout=600), "update pipe did not drain")

    _, apply_ms = timed(lambda: run_phase("update submit_update patch",
                                          ingest_while_scoring))
    report("patch", frame, make_ms, apply_ms, st0, pipe.stats,
           how="submit_update..flush (scoring meanwhile)")
    frame_launches("update make_update patch", {k7: 1, k8: 1, k9: 0})
    frame_launches("update submit_update patch", {k7: 0, k8: 0, k9: 1})
    after, ms_after = check_frame("patch", frame, p2)
    n_old = n_new = 0
    for i, got in enumerate(during):
        old = matches(got, before[i % len(batches)])
        new = matches(got, after[i % len(batches)])
        check(old != new, f"update patch: microbatch {i} scored during the "
              f"ingest matches {'both' if old else 'neither'} generation")
        n_old, n_new = n_old + old, n_new + new
    check(n_old >= len(batches) and n_new >= len(batches),
          f"update patch: {n_old} microbatches on the old generation and "
          f"{n_new} on the new, want at least {len(batches)} of each")
    check(eng.generation == 3 and eng.weights_version == sender.version
          and eng.stats.updates_applied == 3,
          f"update: generation {eng.generation}, weights_version "
          f"{eng.weights_version}, updates_applied {eng.stats.updates_applied}")
    print(f"update patch: {len(during)} microbatches scored across the "
          f"ingest and the publish, {n_old} on the old generation and "
          f"{n_new} on the new (none mixed); contexts prewarmed "
          f"{pipe.stats.contexts_refreshed}")
    if on_card:
        print(f"update: p50 per microbatch {np.median(ms_before):.3f} ms "
              f"before the patch swap, {np.median(ms_after):.3f} ms after "
              f"(the 4 microbatches, first pass after each swap); while the "
              f"patch was ingested p50 {np.median(during_ms):.3f} ms, p99 "
              f"{np.percentile(during_ms, 99):.3f} ms over {len(during_ms)} "
              f"microbatches | {smi}")
    pipe.close(timeout=60)


def training_path(cfg, args, dev, on_card, smi, batches, run_phase,
                  phase_launches, r_rows, n_cand):
    """Phase 3, training: ``TrainingPipeline.run_round`` -> an int8 DeepFFM
    engine's ``apply_update`` at full width; see the module docstring.
    Returns a callable that runs one more training microbatch (phase 4)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import layout
    from repro_torch.checkpoint import transfer as T
    from repro_torch.core import deepffm
    from repro_torch.data.prefetch import Prefetcher, fetch_stall_fraction
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.train.pipeline import (TrainingPipeline, make_round_step,
                                            make_sparse_round_step)

    n_rounds, n_micro = 3, 8
    stream = CTRStream(cfg, seed=args.seed)
    rounds = [[stream.sample(TRAIN_BATCH) for _ in range(n_micro)]
              for _ in range(n_rounds)]
    pipe = TrainingPipeline(cfg, "deepffm", seed=args.seed, device=dev)
    start = clone_tree(pipe.params), clone_tree(pipe.opt_state)
    eng = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                          quantized=True)
    wire = T.Receiver(device=dev)

    k10 = "sparse_weight_grad"
    for r, round_batches in enumerate(rounds, 1):
        before = {t: x.clone() for t, x in row_tables(pipe).items()}
        label = f"train round {r}"
        # the round's batches come through a prefetcher whose consumer is
        # the pipeline's own: its wait is the round's fetch stall
        source = Prefetcher(iter(round_batches), depth=4)
        t0 = time.perf_counter()
        frame = run_phase(label, lambda: pipe.run_round(source))
        round_s = time.perf_counter() - t0
        check(source.stats.batches == n_micro,
              f"{label}: the prefetcher gave {source.stats.batches} batches")
        stall = fetch_stall_fraction(round_s, source.stats)
        print(f"{label}: fetch stall {stall:.4f} of {round_s * 1e3:.1f} ms (consumer wait "
              f"{source.stats.consumer_wait_s * 1e3:.2f} ms, producer "
              f"{source.stats.producer_time_s * 1e3:.2f} ms; batches made "
              f"before the round)")
        rep = pipe.reports[-1]
        want_kind = T.KIND_FULL if r == 1 else T.KIND_DELTA
        check(T.unframe(frame).kind == want_kind and rep.round == r,
              f"{label}: frame kind {T.unframe(frame).kind} (want "
              f"{want_kind}), report round {rep.round}")
        if on_card:
            n = phase_launches[label][k10]
            check(n == 2 * n_micro, f"{label}: {k10} launched {n} times, "
                  f"want 2 per microbatch ({2 * n_micro})")
        rows = np.unique(np.concatenate([b["idx"].ravel()
                                         for b in round_batches]))
        check(rep.touched_rows == rows.size,
              f"{label}: touched_rows {rep.touched_rows}, unique indices "
              f"{rows.size}")
        check_untouched(label, cfg, dev, before, pipe, round_batches)
        del before
        if r == 1:
            # the same round again from a clone of the starting state
            twin = TrainingPipeline(cfg, "deepffm", seed=args.seed, device=dev)
            twin.params = clone_tree(start[0])
            twin.opt_state = clone_tree(start[1])
            twin_frame = twin.run_round(iter(round_batches))
            check(same_tree(twin.params, pipe.params)
                  and same_tree(twin.opt_state, pipe.opt_state)
                  and twin_frame == frame,
                  f"{label}: a re-run from the same start differs")
            del twin
        t0 = time.perf_counter()
        run_phase(f"{label} apply_update", lambda: eng.apply_update(
            frame, pipe.sender.manifest, pipe.params) if r == 1
            else eng.apply_update(frame))
        apply_ms = (time.perf_counter() - t0) * 1e3
        if r == 1:
            eng.warmup(max_requests=r_rows, max_candidates=n_cand)
        check_decoded_frame(label, frame, pipe.params, eng, wire, pipe.sender,
                            batches)
        step_s = rep.seconds - rep.update_seconds
        print(f"{label}: {rep.examples} examples, "
              f"{rep.examples_per_s:.0f} examples/s | {rep.seconds * 1e3:.1f} "
              f"ms = step {step_s * 1e3:.1f} ms ({rep.examples / step_s:.0f} "
              f"examples/s) + make_update {rep.update_seconds * 1e3:.1f} ms | "
              f"apply_update {apply_ms:.1f} ms | mean loss "
              f"{rep.mean_loss:.5f}, progressive AUC {rep.progressive_auc:.5f}"
              f" | skip {rep.skip_stats} | touched rows {rep.touched_rows} | "
              f"{rep.update_kind} frame {rep.update_bytes} bytes | "
              f"launches {phase_launches[label]} | {smi}")
        check(np.isfinite(rep.mean_loss) and 0.0 <= rep.progressive_auc <= 1.0,
              f"{label}: mean loss {rep.mean_loss}, AUC {rep.progressive_auc}")
    check(eng.generation == n_rounds and eng.weights_version == n_rounds,
          f"train: engine generation {eng.generation}, weights_version "
          f"{eng.weights_version}")

    # the dense reference step against the row-sparse one, two microbatches
    # from the same start (their launches are not part of the main path).
    # On the CPU both run on one host thread: PyTorch's multi-threaded CPU
    # sums change their order from run to run, and AdaGrad's first step on
    # a fresh row magnifies a last-bit difference past the bound
    stacked = {k: np.stack([b[k] for b in rounds[0][:2]])
               for k in rounds[0][0]}
    out = {}
    threads = torch.get_num_threads()
    if not on_card:
        torch.set_num_threads(1)
    try:
        for name, maker in (("dense", make_round_step),
                            ("sparse", make_sparse_round_step)):
            p, st = clone_tree(start[0]), clone_tree(start[1])
            out[name] = maker(cfg, "deepffm", pipe.opt)(p, st, 0, stacked)
    finally:
        torch.set_num_threads(threads)
    worst = 0.0
    for (path, d), (_, sp) in zip(
            layout.flatten_with_paths({"p": out["dense"][0],
                                       "s": out["dense"][1]}),
            layout.flatten_with_paths({"p": out["sparse"][0],
                                       "s": out["sparse"][1]})):
        check(torch.allclose(sp, d, rtol=2e-4, atol=1e-6),
              f"train: dense and sparse steps differ at {path} (max abs err "
              f"{float((sp - d).abs().max()):.3e})")
        worst = max(worst, float((sp - d).abs().max()))
    scores = (out["sparse"][3]["scores"], out["dense"][3]["scores"])
    check(torch.allclose(*scores, rtol=1e-4, atol=1e-6),
          "train: dense and sparse steps' scores differ")
    print(f"train: dense and row-sparse steps agree over 2 microbatches "
          f"(params and accumulators max abs err {worst:.3e}, rtol 2e-4, "
          f"atol 1e-6; scores max abs err "
          f"{float((scores[0] - scores[1]).abs().max()):.3e}); round 1 re-run "
          "from a clone: byte-identical params and frame")
    del out, start

    # K10 inside the step, held to something independent of it: one more
    # trainer microbatch at the trained weights (tiny gradients, some units
    # dead), its MLP weight gradients through the §4.3 backward (dW on K10
    # on the card) and through plain autograd (dW by cuBLAS)
    mb = {k: torch.as_tensor(v).to(dev) for k, v in
          stream.sample(TRAIN_BATCH).items()}
    mb["idx"] = mb["idx"].to(torch.int64)
    names = sorted(pipe.params["mlp"])
    grads = {}
    for sparse in (True, False):
        var = dict(pipe.params)
        var["mlp"] = {n: pipe.params["mlp"][n].detach().requires_grad_()
                      for n in names}
        _build.reset_launches()
        loss = deepffm.loss_fn(cfg, var, mb, "deepffm", sparse_backward=sparse)
        grads[sparse] = dict(zip(names, torch.autograd.grad(
            loss, [var["mlp"][n] for n in names])))
        if on_card:
            n = _build.launches[k10]
            want = len(cfg.mlp_hidden) if sparse else 0
            check(n == want, f"train gradient check: {k10} launched {n} "
                  f"times, want {want}")
    with torch.no_grad():
        _, masks = deepffm.forward(cfg, pipe.params, mb["idx"], mb["val"],
                                   "deepffm", with_masks=True)
    dead = [float((~m.any(dim=0)).float().mean()) for m in masks]
    errs = []
    for n in names:
        got, want = grads[True][n], grads[False][n]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= GRAD_RTOL * scale,
              f"train gradient check: mlp/{n} through K10 differs from plain "
              f"autograd by {err:.3e} (limit {GRAD_RTOL} x max |g| "
              f"{scale:.3e})")
        errs.append(f"{n} {err:.3e} of max |g| {scale:.3e}")
    print(f"train gradient check: one trainer microbatch's MLP weight "
          f"gradients, §4.3 backward vs plain autograd, max abs err "
          f"{'; '.join(errs)} (limit {GRAD_RTOL} x max |g|); dead hidden "
          f"units {', '.join(f'{100 * d:.1f}%' for d in dead)}")
    del grads
    eng.update_pipe().close(timeout=60)

    step = make_sparse_round_step(cfg, "deepffm", pipe.opt)
    one = {k: v[None] for k, v in rounds[-1][0].items()}
    return lambda: step(pipe.params, pipe.opt_state, 0, one)


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def same_tree(a, b):
    """Every leaf of ``a`` equal to ``b``'s bit for bit."""
    import torch

    from repro_torch.checkpoint import layout

    fa, fb = layout.flatten_with_paths(a), layout.flatten_with_paths(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


# the row tables of a trainer (params and AdaGrad accumulators) that a
# round may change only at the rows its batches touch
ROW_TABLES = (("params", "ffm/emb"), ("params", "lr/w"), ("acc", "ffm/emb"),
              ("acc", "lr/w"))


def row_tables(pipe):
    out = {}
    for which, path in ROW_TABLES:
        tree = pipe.params if which == "params" else pipe.acc
        for key in path.split("/"):
            tree = tree[key]
        out[(which, path)] = tree
    return out


def check_untouched(label, cfg, dev, before, pipe, round_batches):
    """Rows no batch of the round touched are byte-identical in the
    trainer's row tables to ``before`` (a clone of them)."""
    import numpy as np
    import torch

    rows = np.unique(np.concatenate([b["idx"].ravel() for b in round_batches]))
    untouched = torch.ones(cfg.hash_space, dtype=torch.bool, device=dev)
    untouched[torch.from_numpy(rows).to(dev)] = False
    for t, now in row_tables(pipe).items():
        check(torch.equal(now[untouched], before[t][untouched]),
              f"{label}: an untouched row of {t[0]} {t[1]} changed")
    return int(untouched.sum())


def server_path(cfg, args, dev, on_card, smi, batches, run_phase,
                phase_launches, params, r_rows, n_cand):
    """Phase 3, servers: ``FFMServer`` and ``CachedServer`` on the card, fed
    one full frame, answering the microbatches; see the module
    docstring."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import transfer as T
    from repro_torch.serving.context_cache import CachedServer
    from repro_torch.serving.server import FFMServer

    snd = T.Sender(device=dev)
    srv = FFMServer(cfg, device=dev)

    def ingest():
        frame = snd.make_update(params)
        srv.apply_update(frame, snd.manifest, params)
        return frame

    frame = run_phase("servers ingest", ingest)
    wire = T.Receiver(device=dev)
    wire.apply_update(frame)
    cached = CachedServer(cfg, wire.materialize(manifest=snd.manifest,
                                                like=params), device=dev)
    srv.engine.warmup(max_requests=r_rows, max_candidates=n_cand)
    cached.engine.warmup(max_requests=r_rows, max_candidates=n_cand)
    label_b = f"FFMServer serve_batch x{len(batches)}"
    probs = run_phase(label_b, lambda: [srv.serve_batch(mb) for mb in batches])
    reqs = [req for mb in batches for req in mb]
    label_s = f"FFMServer serve x{len(reqs)}"
    single = run_phase(label_s, lambda: [srv.serve(*req) for req in reqs])
    label_c = f"CachedServer serve x{len(reqs)}"
    t0 = time.perf_counter()
    logits = run_phase(label_c, lambda: [cached.serve(*req) for req in reqs])
    cached_ms = (time.perf_counter() - t0) * 1e3 / len(reqs)
    worst = [0.0, 0.0, 0.0]
    for req, p_b, p_s, lg in zip(reqs, [p for mb in probs for p in mb],
                                 single, logits):
        oracle = srv.engine.score_uncached(*req)
        want_p = torch.sigmoid(oracle).cpu().numpy()
        want_l = cached.serve_uncached(*req).cpu().numpy()
        for i, (got, want) in enumerate(((p_b, want_p), (p_s, want_p),
                                         (lg, want_l))):
            check(got.shape == (req[2].shape[0],) and np.isfinite(got).all()
                  and np.allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL),
                  f"servers: {('serve_batch', 'serve', 'CachedServer')[i]} vs "
                  f"score_uncached max abs err {np.abs(got - want).max():.3e}")
            worst[i] = max(worst[i], float(np.abs(got - want).max()))
    st = srv.stats
    check(st.updates_applied == 1 and srv.cache_hit_rate > 0
          and cached.hits > 0 and cached.misses > 0,
          f"servers: updates {st.updates_applied}, hit rate "
          f"{srv.cache_hit_rate}, CachedServer hits {cached.hits} misses "
          f"{cached.misses}")
    for label in ("servers ingest", label_b, label_s, label_c):
        print(f"launches {label}: {phase_launches[label]}")
    if on_card:
        for label in (label_b, label_s, label_c):
            n = phase_launches[label]["ffm_candidate_matrices"]
            check(n > 0, f"{label}: ffm_candidate_matrices launched {n} times")
    print(f"servers: FFMServer {st.requests} requests, hit rate "
          f"{srv.cache_hit_rate:.3f}; CachedServer hits {cached.hits} misses "
          f"{cached.misses}; max abs err vs score_uncached: serve_batch "
          f"{worst[0]:.3e}, serve {worst[1]:.3e} (probabilities), "
          f"CachedServer {worst[2]:.3e} (logits) (rtol {SCORE_RTOL}, atol "
          f"{SCORE_ATOL})")
    if on_card:
        print(f"servers: FFMServer p50 {st.p50_ms:.3f} ms per call, p99 "
              f"{st.p99_ms:.3f} ms over {len(batches)} microbatches and "
              f"{len(reqs)} single requests, {st.predictions_per_s:.0f} "
              f"predictions/s; CachedServer {cached_ms:.3f} ms per request "
              f"(host clock) | {smi}")
    srv.engine.update_pipe().close(timeout=60)


def span_path(cfg, dev, on_card, smi, batches, run_phase, phase_launches,
              params, r_rows, n_cand):
    """Phase 3, span pipeline: engines with ``parallel`` = 1, 2 and 4 on the
    microbatches, bit for bit; see the module docstring."""
    import numpy as np

    from repro_torch.serving.engine import InferenceEngine

    ffm_params = {"lr": params["lr"], "ffm": params["ffm"]}
    arms = (("int8-fused ffm", "ffm", ffm_params, True, True),
            ("int8 staged deepffm", "deepffm", params, True, None),
            ("f32 staged deepffm", "deepffm", params, False, None))
    for name, model, p, quant, fused in arms:
        base = None
        for workers in (1, 2, 4):
            eng = InferenceEngine(cfg, model, params=p, device=dev,
                                  quantized=quant, fused=fused,
                                  parallel=workers)
            eng.warmup(max_requests=r_rows, max_candidates=n_cand)
            label = f"spans {name} parallel={workers} x{len(batches)}"
            got = run_phase(label, lambda: [o for mb in batches
                                            for o in eng.score_batch(mb)])
            eng.close()
            if base is None:
                base = got
            check(len(got) == len(base) and all(
                np.array_equal(g, b) for g, b in zip(got, base)),
                f"{label}: scores differ in bits from parallel=1")
            print(f"launches {label}: {phase_launches[label]}")
    print(f"span pipeline: parallel 2 and 4 bit-identical to 1 on "
          f"{', '.join(a[0] for a in arms)} ({len(batches)} microbatches)")


HOST_TIMED_PASSES = 5  # timed passes over the microbatches per engine pair


def host_gather_path(cfg, args, dev, on_card, smi, batches, run_phase,
                     phase_launches, params, fparams, randn, r_rows, n_cand):
    """Phase 3, the host pre-gather: four ``host_gather=True`` engines
    against their device-gather twins, spans, a hot swap and the serving
    roofline of all eight; see the module docstring."""
    import threading

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.checkpoint import transfer as T
    from repro_torch.convert import to_device
    from repro_torch.launch import op_analysis
    from repro_torch.launch import roofline as RL
    from repro_torch.serving.engine import InferenceEngine, ServeStats

    rtol, atol = 1e-6, 1e-7  # JAX's host vs in-trace contract
    # name: (model, params, quantized, fused, candidate kernel)
    specs = {
        "int8": ("deepffm", params, True, False, "ffm_candidate_matrices_q8"),
        "f32": ("deepffm", params, False, False, "ffm_candidate_matrices"),
        "int8-fused": ("ffm", fparams, True, True, "ffm_fused_logits_q8"),
        "f32-fused": ("ffm", fparams, False, True, "ffm_fused_logits_rows"),
    }

    def make(name, host, **kw):
        model, p, quant, fused, _ = specs[name]
        eng = InferenceEngine(cfg, model, backend="cuda", params=p,
                              device=dev, quantized=quant, fused=fused,
                              host_gather=host, **kw)
        eng.warmup(max_requests=r_rows, max_candidates=n_cand)
        return eng

    # the auto policy on this device: the card keeps the device gather, and
    # a quantized "ffm" engine stays staged
    auto = InferenceEngine(cfg, "ffm", params=fparams, device=dev,
                           quantized=True)
    if on_card:
        check(not auto.host_gather and not auto.fused,
              f"host gather: the auto policy picked host_gather "
              f"{auto.host_gather}, fused {auto.fused} on the card")
    print(f"host gather: InferenceEngine(host_gather=None, fused=None) on "
          f"{dev.type} at V = {cfg.hash_space}: host_gather "
          f"{auto.host_gather}, fused {auto.fused}")
    del auto

    t0 = time.perf_counter()
    pairs = {name: (make(name, True), make(name, False)) for name in specs}
    for name, (host, twin) in pairs.items():
        check(host.host_gather and not twin.host_gather
              and host.fused == twin.fused == specs[name][3],
              f"host gather {name}: host_gather {host.host_gather} / "
              f"{twin.host_gather}, fused {host.fused} / {twin.fused}")
    print(f"host gather: 4 engines and their device-gather twins built and "
          f"warmed in {time.perf_counter() - t0:.1f} s; host mirrors "
          + ", ".join(f"{n} {h.host_mirror_ms:.1f} ms"
                      for n, (h, _) in pairs.items()))

    def spy(eng, blocks=None, seconds=None):
        """Wrap the engine's argument builder: record each block's indices,
        values and (copied) arguments, and its time."""
        real = eng._forward_args

        def wrapped(*a, **kw):
            t = time.perf_counter()
            fn, fargs = real(*a, **kw)
            if seconds is not None:
                seconds.append(time.perf_counter() - t)
            if blocks is not None:
                blocks.append((a[2].copy(), a[3].copy(), [
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in fargs]))
            return fn, fargs

        eng._forward_args = wrapped

    class TableWatch(TorchDispatchMode):
        """Counts the ops that read the given tables' storage."""

        def __init__(self, tables):
            super().__init__()
            self.ptrs = {t.untyped_storage().data_ptr() for t in tables}
            self.reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(x, torch.Tensor)
                   and x.untyped_storage().data_ptr() in self.ptrs
                   for x in tree_flatten((args, kwargs))[0]):
                self.reads += 1
            return func(*args, **kwargs)

    def table_reads(eng):
        """Ops of the deployed forward at (8, 64) that read the gather
        tables (emb and LR) on the device."""
        fn, fargs = eng.lower_candidates_forward(r_rows, n_cand)
        tables = [t for leaf in (eng.params["ffm"]["emb"],
                                 eng.params["lr"]["w"])
                  for t in (leaf.values() if isinstance(leaf, dict)
                            else (leaf,)) if isinstance(t, torch.Tensor)]
        with TableWatch(tables) as w:
            fn(*fargs)
        return w.reads

    # -- the twins agree: blocks byte for byte, scores, launches ----------
    last_block = {}
    for name, (host, twin) in pairs.items():
        kname = specs[name][4]
        blocks = []
        spy(host, blocks)
        host_label = f"host gather {name} score_batch x{len(batches)}"
        twin_label = f"host gather {name} twin score_batch x{len(batches)}"
        try:
            got = run_phase(host_label,
                            lambda: [host.score_batch(mb) for mb in batches])
        finally:
            del host._forward_args
        want = run_phase(twin_label,
                         lambda: [twin.score_batch(mb) for mb in batches])
        last_block[name] = blocks[-1][2]
        emb = twin.params["ffm"]["emb"]
        q8 = isinstance(emb, dict)
        for ki_b, kv_b, fargs in blocks:
            ki = torch.from_numpy(ki_b).to(dev)
            real = torch.from_numpy((kv_b != 0).any(-1)).to(dev)
            tensors = [x for x in fargs if isinstance(x, torch.Tensor)]
            i = next(j for j, x in enumerate(tensors) if x.dim() == 5)
            block = tensors[i]
            check(torch.equal(block, emb["codes"][ki] if q8 else emb[ki]),
                  f"host gather {name}: an uploaded block differs from the "
                  "twin's device gather")
            if q8:
                for g, key in zip(tensors[i + 1:i + 3], ("scale", "zero")):
                    check(torch.equal(g[real], emb[key][ki][real]),
                          f"host gather {name}: uploaded {key} grids differ "
                          "from the twin's device gather on real slots")
        n_req = n_bits = 0
        worst = 0.0
        for g_mb, w_mb in zip(got, want):
            for g, w in zip(g_mb, w_mb):
                check(g.shape == w.shape and np.isfinite(g).all(),
                      f"host gather {name}: bad scores {g.shape}")
                check(np.allclose(g, w, rtol=rtol, atol=atol),
                      f"host gather {name}: host vs device gather max abs "
                      f"err {np.abs(g - w).max():.3e} (rtol {rtol}, atol "
                      f"{atol})")
                n_req += 1
                n_bits += g.tobytes() == w.tobytes()
                if g.size:
                    worst = max(worst, float(np.abs(g - w).max()))
        # the LR terms are summed on the device by the twin's reduction: the
        # kernels and the head get the same bits
        check(n_bits == n_req, f"host gather {name}: {n_req - n_bits} of "
              f"{n_req} requests differ in bits from the device twin")
        hc, tc = phase_launches[host_label], phase_launches[twin_label]
        if on_card:
            check(hc == tc and hc[kname] == len(batches),
                  f"host gather {name}: launches {hc}, twin {tc}, want equal "
                  f"and {kname} once per microbatch")
        reads = (table_reads(host), table_reads(twin))
        check(reads[0] == 0 and reads[1] > 0,
              f"host gather {name}: ops reading the gather tables in the "
              f"forward: host {reads[0]}, twin {reads[1]}")
        what = "codes, grids on real slots" if q8 else "rows"
        print(f"host gather {name}: {len(blocks)} uploaded blocks equal the "
              f"twin's device gather byte for byte ({what}); {n_bits} of "
              f"{n_req} requests bit-identical, max abs err {worst:.3e} "
              f"(rtol {rtol}, atol {atol}); {kname} {hc[kname]} launches, "
              f"twin {tc[kname]}; ops reading the tables in the forward: "
              f"host {reads[0]}, twin {reads[1]}")
        print(f"launches {host_label}: {hc}")

    # -- timed passes: p50 beside the twin's, the host gather's share ------
    # One pass times the argument builder (host gather + upload) alone;
    # then the stats are reset and the timed passes run bare.
    shares = {}
    for name, (host, twin) in pairs.items():
        seconds = []
        spy(host, seconds=seconds)
        try:
            for mb in batches:
                host.score_batch(mb)
        finally:
            del host._forward_args
        for e in (host, twin):
            with e._lock:
                e.stats = ServeStats()
        for _ in range(HOST_TIMED_PASSES):
            for e in (host, twin):
                for mb in batches:
                    e.score_batch(mb)
        # the upload alone: one microbatch's host blocks (from the checked
        # pass), pageable as the single-span path uploads them
        host_blocks = [x.cpu().numpy() for x in last_block[name]
                       if isinstance(x, torch.Tensor) and x.dim() >= 2]
        up = []
        for _ in range(20):
            t = time.perf_counter()
            for b in host_blocks:
                torch.from_numpy(b).to(dev, non_blocking=True)
            if on_card:
                torch.cuda.synchronize()
            up.append(time.perf_counter() - t)
        fa_ms = float(np.median(seconds)) * 1e3
        up_ms = float(np.median(up)) * 1e3
        shares[name] = (fa_ms, up_ms, sum(b.nbytes for b in host_blocks))
        if on_card:
            p50, twin_p50 = host.stats.p50_ms, twin.stats.p50_ms
            print(f"host gather {name}: p50 {p50:.3f} ms per microbatch, "
                  f"twin {twin_p50:.3f} ms ({100 * (p50 / twin_p50 - 1):+.1f}"
                  f"%); p99 {host.stats.latency_ms(99):.3f} ms, twin "
                  f"{twin.stats.latency_ms(99):.3f} ms; "
                  f"{host.stats.predictions_per_s:.0f} predictions/s, twin "
                  f"{twin.stats.predictions_per_s:.0f} "
                  f"({HOST_TIMED_PASSES} x {len(batches)} microbatches each, "
                  f"bare); host gather + upload {fa_ms:.3f} ms a call "
                  f"({100 * fa_ms / p50:.1f}% of p50), the upload alone "
                  f"{up_ms:.3f} ms for {shares[name][2]} bytes "
                  f"({100 * up_ms / p50:.1f}%) | {smi}")

    # -- spans: parallel 1 / 2 / 4 with the host gather, bit for bit -------
    for name in ("int8", "f32", "int8-fused"):
        base = None
        for workers in (1, 2, 4):
            eng = make(name, True, parallel=workers)
            label = f"host gather spans {name} parallel={workers}"
            got = run_phase(label, lambda: [o for mb in batches
                                            for o in eng.score_batch(mb)])
            eng.close()
            if base is None:
                base = got
            check(all(g.tobytes() == b.tobytes() for g, b in zip(got, base)),
                  f"{label}: scores differ in bits from parallel=1")
    print("host gather spans: parallel 2 and 4 bit-identical to 1 on int8, "
          f"f32 and int8-fused ({len(batches)} microbatches, the host gathers "
          "into the pool's buffers)")

    # -- hot swap: the mirror rebuilt once per publish, no torn score ------
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    p0 = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    sender = T.Sender(device=dev)
    swap = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                           quantized=True, host_gather=True)
    ref = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                          quantized=True)
    frame = sender.make_update(p0)
    for e in (swap, ref):
        e.apply_update(frame, sender.manifest, p0)
    full_ms = swap.host_mirror_ms
    check(swap.host_mirror_builds == 1,
          f"host gather swap: {swap.host_mirror_builds} mirror builds after "
          "the full frame, want 1")
    for e in (swap, ref):
        e.warmup(max_requests=r_rows, max_candidates=n_cand)
    before = [swap.score_batch(mb) for mb in batches]
    # a delta: 1% of the rows, and the bias moved by 1, so every score moves
    v = cfg.hash_space
    rows = torch.randperm(v, generator=gen, device=dev)[:v // 100]
    p1 = {k: dict(x) if isinstance(x, dict) else x for k, x in p0.items()}
    p1["ffm"]["emb"] = p0["ffm"]["emb"].clone()
    p1["lr"]["w"] = p0["lr"]["w"].clone()
    p1["lr"]["b"] = p0["lr"]["b"] + 1.0
    p1["ffm"]["emb"][rows] += 1e-3 * torch.randn(
        p1["ffm"]["emb"][rows].shape, generator=gen, device=dev)
    p1["lr"]["w"][rows] += 1e-3 * torch.randn(rows.shape, generator=gen,
                                              device=dev)
    frame = sender.make_update(p1, touched={"ffm/emb": rows, "lr/w": rows})
    check(T.unframe(frame).kind == T.KIND_DELTA, "host gather swap: the "
          f"frame is kind {T.unframe(frame).kind}, want a delta")
    ref.apply_update(frame)
    after = [ref.score_batch(mb) for mb in batches]
    pipe = swap.update_pipe()
    during = []
    release = threading.Event()
    publish = swap._publish

    def held_publish(p, version, nbytes):
        check(release.wait(600), "host gather swap: the publish was held")
        return publish(p, version, nbytes)

    swap._publish = held_publish
    try:
        check(swap.submit_update(frame), "host gather swap: not queued")
        published, deadline = pipe.stats.published, time.perf_counter() + 600
        n_after = 0
        while n_after < len(batches):
            check(time.perf_counter() < deadline, "host gather swap: the "
                  "delta was not published")
            if pipe.stats.published != published:
                n_after += 1
            during.append(swap.score_batch(batches[len(during)
                                                   % len(batches)]))
            if len(during) == len(batches):
                release.set()
    finally:
        release.set()
        del swap._publish
    check(pipe.flush(timeout=600), "host gather swap: the pipe did not drain")
    check(swap.host_mirror_builds == 2,
          f"host gather swap: {swap.host_mirror_builds} mirror builds after "
          "two publishes, want 2")

    def matches(got_mb, want_mb):
        return all(np.allclose(g, w, rtol=rtol, atol=atol)
                   for g, w in zip(got_mb, want_mb))

    n_old = n_new = 0
    for i, got in enumerate(during):
        old = matches(got, before[i % len(batches)])
        new = matches(got, after[i % len(batches)])
        check(old != new, f"host gather swap: microbatch {i} matches "
              f"{'both' if old else 'neither'} generation")
        n_old, n_new = n_old + old, n_new + new
    check(n_old >= len(batches) and n_new >= len(batches),
          f"host gather swap: {n_old} old and {n_new} new microbatches")
    check(all(matches(swap.score_batch(mb), w) for mb, w in zip(batches,
                                                                after)),
          "host gather swap: after the publish the scores are not the new "
          "generation's")
    print(f"host gather swap: mirror built once per publish (full frame "
          f"{full_ms:.1f} ms, delta {swap.host_mirror_ms:.1f} ms, "
          f"{swap.resident_weight_bytes} resident bytes); {len(during)} "
          f"microbatches across the ingest, {n_old} old and {n_new} new "
          f"generation, none torn | {smi}")
    pipe.close(timeout=60)
    del swap, ref

    # -- the serving roofline of all eight engines at (8, 64) --------------
    host_bw = RL.measure_cpu_bandwidth()
    dev_bw = RL.measure_device_bandwidth(dev) if on_card else host_bw
    if on_card:
        check(dev_bw < PEAK_BYTES_PER_S,
              f"device copy bandwidth {dev_bw:.4e} B/s above the sheet's "
              f"{PEAK_BYTES_PER_S:.4e}")
    print(f"roofline bandwidths: device copy {dev_bw / 1e9:.1f} GB/s, host "
          f"copy {host_bw / 1e9:.2f} GB/s | {smi}")
    for name, pair in pairs.items():
        model, p, quant, fused, _ = specs[name]
        for label, e in ((name, pair[0]), (f"{name} twin", pair[1])):
            roof = RL.serving_roofline(
                e, rb=r_rows, nb=n_cand, scenario=label,
                measured_preds_per_s=e.stats.predictions_per_s,
                bandwidth_bytes_per_s=dev_bw,
                host_bandwidth_bytes_per_s=host_bw if on_card else None)
            check(roof.fraction_of_bound <= 1.05,
                  f"roofline {label}: fraction of bound "
                  f"{roof.fraction_of_bound:.4f} > 1.05")
            n = roof.predictions_per_call
            count = ""
            if on_card:
                # the same forward counted on the CPU
                cpu = InferenceEngine(cfg, model, backend="cuda",
                                      params=to_device(p, torch.device("cpu")),
                                      device="cpu", quantized=quant,
                                      fused=fused, host_gather=e.host_gather)
                fn, fargs = cpu.lower_candidates_forward(r_rows, n_cand)
                fn(*fargs)  # the index vectors' first upload
                with op_analysis.Counter() as c:
                    fn(*fargs)
                check((c.flops, c.bytes) == (roof.counted_flops_per_call,
                                             roof.counted_bytes_per_call),
                      f"roofline {label}: card count "
                      f"{roof.counted_flops_per_call}, "
                      f"{roof.counted_bytes_per_call} vs CPU {c.flops}, "
                      f"{c.bytes}")
                count = "; the CPU count of the same forward equal"
                del cpu
            print(f"roofline {label}: {roof.counted_bytes_per_call / n:.1f} "
                  f"device + {roof.host_bytes_per_call / n:.1f} host bytes "
                  f"and {roof.counted_flops_per_call / n:.1f} operations a "
                  f"prediction | measured {roof.measured_preds_per_s:.0f} "
                  f"predictions/s, bound {roof.bound_preds_per_s:.4e}, "
                  f"fraction {roof.fraction_of_bound:.3e}{count} | {smi}")
    for host, twin in pairs.values():
        host.close()
        twin.close()


def fleet_path(cfg, args, dev, on_card, smi, batches, run_phase,
               phase_launches, params, engines, r_rows, n_cand):
    """Phase 3, fleet: ``ShardRouter`` at N = 1 / 2 / 4 shards (M = 2
    replicas at 2 and 4), ``TrainingPipeline(shard_ranges=)`` frames fanned
    out through ``submit_updates`` / ``flush_updates``, and the fault drills;
    see the module docstring. Returns a callable scoring one microbatch on
    the N = 4, M = 2 fleet (phase 4) and one that closes the fleets."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import transfer as T
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.launch import topology
    from repro_torch.serving import shard_router as sr
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.faults import FRAME_BITFLIP, FaultPlan
    from repro_torch.train.pipeline import TrainingPipeline

    k1, k10 = "gather_dequant_rows_q8", "sparse_weight_grad"
    # the row sets the assembled int8 views gather: K1's predicted count is
    # one launch per owning shard per gather (context tails), plus one per
    # owning shard of each microbatch's candidate entries for the partials
    # (the candidate block's padded slots hold row 0, owned by shard 0)
    gathered = []
    real_gather = sr.ShardedRows.gather_view

    def recording(view, idx):
        if any(isinstance(p, dict) for p in view.parts):
            gathered.append(view.owner_of(sr._host_index(idx).reshape(-1)))
        return real_gather(view, idx)

    def predicted_k1(n):
        tails = sum(np.unique(o).size for o in gathered)
        ranges = topology.shard_ranges(cfg.hash_space, n)
        parts = sum(
            np.union1d(topology.owner_of(ranges, np.concatenate(
                [r[2].ravel() for r in mb])), [0]).size for mb in batches)
        return tails, parts

    def router(n, m, **kw):
        return sr.ShardRouter(cfg, "deepffm", n_shards=n, replicas=m,
                              device=dev, hedge_ms=10_000, **kw)

    # an entry's partial terms and rows: the same bits at buckets 8 and 64
    from repro_torch.core import quantization as Q

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    m, fc, k = 5, cfg.context_fields, cfg.k
    local = torch.randint(0, cfg.hash_space, (m,), device=dev,
                          dtype=torch.int32, generator=gen)
    a_ctx = torch.randn((m, fc, k), device=dev, generator=gen)
    vc = torch.randn((m, fc), device=dev, generator=gen)
    vm = torch.randn((m,), device=dev, generator=gen)
    table = Q.quantize_params_rows(params)["ffm"]["emb"]
    by_bucket = []
    for mb in (8, 64):
        def pad(x):
            return torch.cat([x, x.new_zeros((mb - m,) + tuple(x.shape[1:]))])

        q_buf = torch.empty((mb, cfg.n_fields, k), device=dev)
        terms_q, rows_q = sr._shard_partial_q8(cfg, pad(a_ctx), pad(vc),
                                               pad(vm), table, local, q_buf)
        f_buf = torch.zeros((mb, cfg.n_fields, k), device=dev)
        f_buf[:m] = params["ffm"]["emb"][local.long()]
        terms_f, rows_f = sr._shard_partial_rows(cfg, pad(a_ctx), pad(vc),
                                                 pad(vm), f_buf)
        by_bucket.append([t[:m].clone() for t in (terms_q, rows_q, terms_f,
                                                   rows_f)])
    check(all(torch.equal(a, b) for a, b in zip(*by_bucket)),
          "fleet: an entry's partial terms differ between buckets 8 and 64")
    print("fleet partials: int8 and f32 terms and rows of 5 entries equal at "
          "buckets 8 and 64, bit for bit")

    sr.ShardedRows.gather_view = recording
    try:
        # -- scores across N -------------------------------------------------
        for quant, name in ((True, "int8"), (False, "f32")):
            want = [engines[name].score_batch(mb) for mb in batches]
            base = None
            for n, m in FLEET_SHAPES:
                t0 = time.perf_counter()
                fleet = router(n, m, params=params, quantized=quant)
                fleet.warmup(max_requests=r_rows, max_candidates=n_cand)
                build_s = time.perf_counter() - t0
                label = f"fleet {name} N={n} M={m} score_batch x{len(batches)}"
                gathered.clear()
                got = run_phase(label, lambda: [fleet.score_batch(mb)
                                                for mb in batches])
                counts = phase_launches[label]
                tails, parts = predicted_k1(n)
                if on_card:
                    want_k1 = tails + parts if quant else 0
                    check(counts[k1] == want_k1,
                          f"{label}: {k1} launched {counts[k1]} times, want "
                          f"{want_k1} ({tails} for context tails + {parts} "
                          "for the partials)")
                worst = 0.0
                for g_mb, w_mb, reqs in zip(got, want, batches):
                    for g, w, req in zip(g_mb, w_mb, reqs):
                        check(g.shape == (req[2].shape[0],)
                              and np.isfinite(g).all(),
                              f"{label}: bad scores shape {g.shape}")
                        worst = max(worst, float(np.abs(g - w).max()))
                check(worst <= ROUTER_ATOL,
                      f"{label}: vs the single {name} engine max abs err "
                      f"{worst:.3e} > {ROUTER_ATOL}")
                if base is None:
                    base = got
                check(all(np.array_equal(g, b) for g_mb, b_mb in
                          zip(got, base) for g, b in zip(g_mb, b_mb)),
                      f"{label}: scores differ in bits from N=1")
                for _ in range(FLEET_TIMED_PASSES):
                    for mb in batches:
                        fleet.score_batch(mb)
                st = fleet.stats
                print(f"launches {label}: {counts}")
                print(f"fleet {name} N={n} M={m}: built and warmed in "
                      f"{build_s:.1f} s, {fleet.resident_weight_bytes} "
                      f"resident bytes; max abs err vs the single engine "
                      f"{worst:.3e} (atol {ROUTER_ATOL}), bit-identical to "
                      "N=1" + (f"; {k1} predicted {tails} (context tails) + "
                               f"{parts} (partials)" if quant else ""))
                if on_card:
                    print(f"fleet {name} N={n} M={m}: p50 {st.p50_ms:.3f} ms "
                          f"per microbatch, p99 {st.p99_ms:.3f} ms over "
                          f"{(1 + FLEET_TIMED_PASSES) * len(batches)} "
                          f"microbatches, {st.predictions_per_s:.0f} "
                          f"predictions/s | {smi}")
                fleet.close()

        # -- fan-out frames ----------------------------------------------------
        stream = CTRStream(cfg, seed=args.seed + 7)
        rounds = [[stream.sample(TRAIN_BATCH) for _ in range(FLEET_MICRO)]
                  for _ in range(2)]
        ranges = {n: topology.shard_ranges(cfg.hash_space, n) for n in (2, 4)}
        pipes = {n: TrainingPipeline(cfg, "deepffm", seed=args.seed,
                                     device=dev, shard_ranges=ranges[n])
                 for n in (2, 4)}
        pipes["full"] = TrainingPipeline(cfg, "deepffm", seed=args.seed,
                                         device=dev)
        like = pipes["full"].params
        fleets = {"N=4": router(4, 2), "N=4 drills": router(4, 2),
                  "N=2": router(2, 2)}
        for key, fleet in fleets.items():
            fleet.configure_fanout(pipes[fleet.n_shards].sender.manifests,
                                   like)
        single = InferenceEngine(cfg, "deepffm", device=dev, quantized=True)
        # the drill fleet's copy of shard 1's second frame is bit-flipped on
        # the wire, as ShardedSender(faults=plan) would send it
        plan = FaultPlan(seed=args.seed, frame_faults={(1, 1): FRAME_BITFLIP})
        for r, round_batches in enumerate(rounds, 1):
            label = f"fleet fan-out round {r}"
            frames = run_phase(label, lambda: {
                k: p.run_round(iter(round_batches)) for k, p in pipes.items()})
            want_kind = T.KIND_FULL if r == 1 else T.KIND_DELTA
            kinds = {T.unframe(f).kind for f in frames[2] + frames[4]
                     + [frames["full"]]}
            check(kinds == {want_kind}, f"{label}: frame kinds {kinds}, want "
                  f"{want_kind}")
            counts = phase_launches[label]
            if on_card:
                for kname, want in (("minmax", 3), ("quantize_codes", 3),
                                    (k10, 3 * 2 * FLEET_MICRO)):
                    check(counts[kname] == want,
                          f"{label}: {kname} launched {counts[kname]} times, "
                          f"want {want}")
            bad = [plan.corrupt_frame(s, f) for s, f in enumerate(frames[4])]

            def ingest():
                n_ok = (fleets["N=4"].submit_updates(frames[4]),
                        fleets["N=4 drills"].submit_updates(bad),
                        fleets["N=2"].submit_updates(frames[2]))
                if r == 1:
                    single.apply_update(frames["full"],
                                        pipes["full"].sender.manifest, like)
                else:
                    single.apply_update(frames["full"])
                for fleet in fleets.values():
                    fleet.flush_updates(timeout=120)
                return n_ok

            ingest_label = f"fleet fan-out ingest round {r}"
            n_ok = run_phase(ingest_label, ingest)
            check(n_ok == (4, 4, 2), f"{ingest_label}: slices accepting the "
                  f"frames {n_ok}, want (4, 4, 2)")
            # one K9 per replica per decoded frame: 8 + 8 + 4 + 1, less the
            # two replicas of the drill fleet's slice 1 that NACK round 2
            want_k9 = 21 if r == 1 else 19
            counts = phase_launches[ingest_label]
            if on_card:
                check(counts["dequantize_codes"] == want_k9,
                      f"{ingest_label}: dequantize_codes launched "
                      f"{counts['dequantize_codes']} times, want {want_k9}")
            print(f"{label}: frame bytes full-space "
                  f"{len(frames['full'])}, N=2 {[len(f) for f in frames[2]]}, "
                  f"N=4 {[len(f) for f in frames[4]]}; launches {label} "
                  f"{phase_launches[label]}, {ingest_label} {counts}")
        drills = fleets["N=4 drills"]
        errs = drills.frame_errors()
        check(errs[1] is not None and all(e is None for i, e in
                                          enumerate(errs) if i != 1),
              f"fleet bit-flip drill: NACK latches {errs}")
        check([g[1] for g in drills.fleet_generations()] == [2, 1, 2, 2],
              f"fleet bit-flip drill: versions "
              f"{drills.fleet_generations()}")
        n_resync = run_phase("fleet resync", lambda: (
            drills.resync_shard(1, pipes[4].sender),
            drills.flush_updates(timeout=120))[0])
        check(n_resync == 2 and drills.frame_errors() == [None] * 4,
              f"fleet resync: accepted on {n_resync} replicas, latches "
              f"{drills.frame_errors()}")
        if on_card:
            n9 = phase_launches["fleet resync"]["dequantize_codes"]
            check(n9 == 2, f"fleet resync: dequantize_codes launched {n9} "
                  "times, want 2")
        print(f"fleet bit-flip drill: shard 1 NACKed {errs[1][:40]!r}..., "
              f"resync accepted on {n_resync} replicas; launches "
              f"{phase_launches['fleet resync']}")
        # every replica's int8 tables: the single engine's slice, bytes
        sp = single.params
        b = sp["lr"]["w"]["block"]
        for key, fleet in fleets.items():
            for s, row in enumerate(fleet._fleet):
                lo, hi = fleet.topology.ranges[s]
                for rep, eng in enumerate(row):
                    e, w = eng.params["ffm"]["emb"], eng.params["lr"]["w"]
                    same = all(torch.equal(e[c], sp["ffm"]["emb"][c][lo:hi])
                               for c in ("codes", "scale", "zero"))
                    same &= torch.equal(w["codes"], sp["lr"]["w"]["codes"][lo:hi])
                    same &= all(torch.equal(w[c],
                                            sp["lr"]["w"][c][lo // b:-(-hi // b)])
                                for c in ("scale", "zero"))
                    check(same, f"fleet {key}: shard {s} replica {rep}'s int8 "
                          "tables are not the single engine's slice")
                check(all(same_tree(eng.params, row[0].params) for eng in row),
                      f"fleet {key}: shard {s}'s replicas differ")
        print("fleet fan-out: every replica's int8 tables equal the single "
              "engine's slice byte for byte (N=4, N=4 after the resync, N=2); "
              "sibling replicas byte-identical")

        # bits across N on the ingested weights, then the kill drill
        ref = [fleets["N=4"].score_batch(mb) for mb in batches]
        for key in ("N=2", "N=4 drills"):
            got = [fleets[key].score_batch(mb) for mb in batches]
            check(all(np.array_equal(g, w) for g_mb, w_mb in zip(got, ref)
                      for g, w in zip(g_mb, w_mb)),
                  f"fleet {key}: ingested scores differ in bits from N=4")
        drills.faults = FaultPlan(seed=args.seed, kill_at={(0, 0): 2})
        got = run_phase("fleet kill drill", lambda: [
            drills.score_batch(mb) for mb in batches])
        check(all(np.array_equal(g, w) for g_mb, w_mb in zip(got, ref)
                  for g, w in zip(g_mb, w_mb)),
              "fleet kill drill: scores moved after the replica kill")
        st = drills.stats
        check(drills.replica_generations()[0][0] is None
              and not drills.degraded and st.failovers == 0
              and not st.last_degraded,
              f"fleet kill drill: replicas {drills.replica_generations()[0]}, "
              f"degraded {drills.degraded}, failovers {st.failovers}")
        drills.faults = None
        drills.kill_shard(2, 0)
        drills.kill_shard(2, 1)
        dead = run_phase("fleet all-dead drill",
                         lambda: drills.score_batch(batches[0]))
        check(drills.degraded and drills.stats.last_degraded
              and all(np.isfinite(d).all() for d in dead)
              and not all(np.array_equal(d, w) for d, w in zip(dead, ref[0])),
              "fleet all-dead drill: the response was not flagged degraded "
              "(or not zero-filled)")
        print(f"fleet drills: replica (0, 0) killed at round 2, {len(batches)} "
              "microbatches bit-identical to the healthy fleet; slice 2 with "
              f"both replicas dead: degraded responses "
              f"{drills.stats.degraded_responses}, last_degraded "
              f"{drills.stats.last_degraded}; {k1} launches: kill drill "
              f"{phase_launches['fleet kill drill'][k1]}, all-dead drill "
              f"{phase_launches['fleet all-dead drill'][k1]} (each kill "
              "republishes the view, so the cached contexts recompute)")
    finally:
        sr.ShardedRows.gather_view = real_gather

    def close():
        for fleet in fleets.values():
            fleet.close()
        single.update_pipe().close(timeout=60)

    return (lambda: fleets["N=4"].score_batch(batches[-1])), close


def quickstart_path(on_card, smi, run_phase, phase_launches):
    """Phase 3, quickstart: ``repro_torch.quickstart.main`` on the device."""
    from repro_torch import quickstart

    out = run_phase("quickstart", lambda: quickstart.main(
        None if on_card else "cpu"))
    check(out["weights_version"] == quickstart.ROUNDS and out["auc"] > 0.5,
          f"quickstart: weights v{out['weights_version']}, AUC {out['auc']}")
    print(f"launches quickstart: {phase_launches['quickstart']}")
    print(f"quickstart: weights v{out['weights_version']}, served-model AUC "
          f"{out['auc']:.4f}, update bytes "
          f"{[r['update_bytes'] for r in out['rounds']]}, p50 "
          f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms per call | {smi}")


def serve_llm_path(cfg, sl, args, dev, on_card, smi, run_phase,
                   phase_launches):
    """Phase 3, the serve_llm example: ``repro_torch.serve_llm.run`` on
    ``cfg`` (full-width llama3.2-1b in bf16 on the card) with the trainer's
    weights from the seed; see the module docstring."""
    import resource

    import torch

    from repro_torch import serve_llm
    from repro_torch.checkpoint import layout
    from repro_torch.core import quantization as Q
    from repro_torch.models import registry

    b, p, g = sl["batch"], sl["prefix"], sl["gen"]
    trainer = registry.init_params(cfg, args.seed, dev)
    n = sum(t.numel() for _, t in layout.flatten_with_paths(trainer))
    gen = torch.Generator().manual_seed(args.seed)
    prefix = torch.randint(0, cfg.vocab_size, (p,), generator=gen)
    first = torch.randint(0, cfg.vocab_size, (b,), generator=gen)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    label = f"serve_llm {cfg.arch_id}"
    out = run_phase(label, lambda: serve_llm.run(cfg, trainer, prefix, first,
                                                 g, dev))
    launches = phase_launches[label]
    if on_card:
        for name, want in (("minmax", 1), ("quantize_codes", 1),
                           ("dequantize_codes", 1), ("flash_attention", 0)):
            check(launches[name] == want, f"{label}: {name} launched "
                  f"{launches[name]} times, want {want}")
    # the full frame: its header (magic, kind, mode length, version, base
    # version: 11 bytes), the mode, the CRC, the sidecar's length, the wire
    # header and two bytes a weight
    want_bytes = 11 + len("patch+quant") + 4 + 8 + Q.HEADER_SIZE + 2 * n
    check(out["frame_bytes"] == want_bytes, f"{label}: frame of "
          f"{out['frame_bytes']} bytes, want {want_bytes}")
    # the served weights: the trainer's structure, dtypes and shapes, each
    # within the wire grid's bound of the trainer's (half a bucket and the
    # f32 roundings of encode and decode, under 8 ulps of the grid's largest
    # magnitude) plus the cast back to a bf16 leaf (2u |w| covers its
    # rounding, u = 2^-8)
    sent = layout.flatten_with_paths(trainer)
    got = dict(layout.flatten_with_paths(out["params"]))
    check(sorted(got) == [k for k, _ in sent], f"{label}: served tree differs")
    mn = min(float(t.min()) for _, t in sent)
    mx = max(float(t.max()) for _, t in sent)
    lo, hi, bucket = Q.compute_bounds(torch.tensor([mn, mx]))
    w_tol = 0.5 * bucket + 8 * torch.finfo(torch.float32).eps * max(
        abs(lo), abs(hi))
    worst = 0.0
    for path, w in sent:
        m = got[path]
        check(m.dtype == w.dtype and m.shape == w.shape and m.device == w.device,
              f"{label}: {path} served as {m.dtype} {tuple(m.shape)}, sent "
              f"{w.dtype} {tuple(w.shape)}")
        u = BF16_U if w.dtype == torch.bfloat16 else 0.0
        err = (m.float() - w.float()).abs()
        share = float((err / (w_tol + 2 * u * m.float().abs())).max())
        check(share <= 1, f"{label}: {path} served weights off by "
              f"{float(err.max()):.3e}, {share:.3f} of the grid's bound")
        worst = max(worst, share)
    del got, sent
    toks = out["tokens"]
    check(toks.shape == (b, 1 + g) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.padded_vocab,
          f"{label}: tokens {tuple(toks.shape)} out of range")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if on_card else "not measured (no card)")
    print(f"launches {label}: {launches}")
    print(f"{label}: {n:,} weights ({cfg.param_dtype}) in a frame of "
          f"{out['frame_bytes']:,} bytes ({out['frame_bytes'] / out['raw_bytes']:.2%} "
          f"of the trainer tree's {out['raw_bytes']:,}), sent and decoded in "
          f"{sum(out['transfer_s'].values()):.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in out["transfer_s"].items())
          + f"); served weights at "
          f"most {worst:.3f} of the grid's bound (bucket {bucket:.3e}) | B={b}, "
          f"prefix {p}, {g} new: shared route {out['shared_s'] * 1e3:.1f} ms "
          f"(prefix once {out['prefix_s'] * 1e3:.1f} ms, continuation "
          f"{out['continue_s'] * 1e3:.1f} ms; {out['shared_tok_s']:.1f} new "
          f"tok/s), per-request route {out['alone_s'] * 1e3:.1f} ms "
          f"({out['alone_tok_s']:.1f} new tok/s), "
          f"{out['alone_s'] / out['shared_s']:.2f}x the shared route | smallest "
          f"top-2 gap {out['min_gap']:.4e}, flips {out['flips'] or 'none'} | "
          f"host peak RSS {rss:.2f} GiB ({rss_before:.2f} before the phase),"
          f" card peak {peak} | {smi}")
    del out, trainer
    if on_card:
        torch.cuda.empty_cache()


def train_ctr_path(tc, args, dev, on_card, smi, run_phase, phase_launches):
    """Phase 3, the train_ctr_100m example: ``repro_torch.train_ctr_100m.run``
    on both routes (the dense loop, then Hogwild at 4 threads), the
    checkpoint in a temporary directory; see the module docstring."""
    import os
    import tempfile

    import torch

    from repro_torch import train_ctr_100m as TC
    from repro_torch.checkpoint import store
    from repro_torch.common.config import FFMConfig
    from repro_torch.train.pipeline import _flat

    cfg = FFMConfig(**tc["cfg"]) if tc["cfg"] else TC.CFG
    steps, batch, threads = tc["steps"], tc["batch"], tc["threads"]
    for route in ("dense", "hogwild"):
        label = f"train_ctr_100m {route}"
        with tempfile.TemporaryDirectory() as ckpt:
            out = run_phase(label, lambda: TC.run(
                cfg, steps, batch, hogwild=route == "hogwild",
                threads=threads, ckpt=ckpt, device=dev))
            launches = phase_launches[label]
            if on_card:
                for name, want in (("sparse_weight_grad", 2 * steps),
                                   ("minmax", 2), ("quantize_codes", 2),
                                   ("dequantize_codes", 0)):
                    check(launches[name] == want, f"{label}: {name} launched "
                          f"{launches[name]} times, want {want}")
            check(out["examples"] == steps * batch and out["auc"] > 0.5
                  and all(math.isfinite(x) for x in out["losses"]),
                  f"{label}: {out['examples']} examples, AUC {out['auc']}")
            back, _ = store.load(ckpt, like_params=out["params"], device=dev)
            check(same_tree(back, out["params"]),
                  f"{label}: the checkpoint does not read back bit for bit")
            raw = os.path.getsize(os.path.join(ckpt, "weights.bin"))
        full, patch = (len(f) for f in out["frames"])
        check(patch < raw, f"{label}: patch frame {patch} bytes, raw f32 "
              f"file {raw}")
        # the Hogwild step's traffic (train/hogwild.py:104-131), P the f32
        # weights: the snapshot, then _apply's copies of the buffers and
        # the accumulator (read P, write P each); the two deltas (read 2P,
        # write P each) and the two in-place adds (read 2P, write P each)
        p_bytes = 4 * sum(t.numel() for t in _flat(out["params"]))
        moved = 18 * p_bytes
        hog = (f"; {moved / 1e9:.2f} GB moved a step per thread by the "
               f"copies and the delta apply (18 x {p_bytes / 1e6:.1f} MB), "
               f"{moved * steps / out['train_s'] / 1e9:.1f} GB/s over the "
               f"run" if route == "hogwild" else "")
        peak = ("not measured (no card)" if out["peak_bytes"] is None
                else f"{out['peak_bytes'] / 2**30:.2f} GiB")
        print(f"launches {label}: {launches}")
        print(f"{label}: {out['n_params']:,} weights, {steps} steps of "
              f"{batch}{f' on {threads} threads' if route == 'hogwild' else ''}"
              f": {out['examples_per_s']:.0f} examples/s ({out['train_s']:.2f}"
              f" s){hog} | loss {out['losses'][0]:.4f} -> "
              f"{out['losses'][-1]:.4f}, test AUC {out['auc']:.4f} | "
              f"checkpoint {raw:,} bytes read back bit for bit | frames: full "
              f"{full:,}, patch {patch:,} bytes ({patch / raw:.3%} of the raw "
              f"f32 file) in {out['patch_s'] * 1e3:.1f} ms | steps' device "
              f"memory peak {peak} | {smi}")
        del out, back
        if on_card:
            torch.cuda.empty_cache()


def local_sgd_path(cfg, args, dev, on_card, smi, batches, run_phase,
                   phase_launches, r_rows, n_cand):
    """Phase 3, local SGD: ``TrainingPipeline(backend="local_sgd")`` at
    W = 2 and 4 into an int8 engine; see the module docstring."""
    import numpy as np

    from repro_torch.checkpoint import transfer as T
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.optim import make_optimizer
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.train import hogwild
    from repro_torch.train.pipeline import JitBackend, TrainingPipeline

    k10, k, n_rounds = "sparse_weight_grad", LOCAL_STEPS, 2
    # each worker's state as its steps leave it, before the merge
    seen = []
    real = hogwild.make_sparse_round_step

    def recording(*a):
        step = real(*a)

        def rec(*b):
            out = step(*b)
            seen.append((out[0], out[1]))
            return out
        return rec

    for w in (2, 4):
        stream = CTRStream(cfg, seed=args.seed + w)
        rounds = [[stream.sample(TRAIN_BATCH) for _ in range(w * k)]
                  for _ in range(n_rounds)]
        hogwild.make_sparse_round_step = recording
        try:
            pipe = TrainingPipeline(cfg, "deepffm", "local_sgd",
                                    local_sgd_workers=w, seed=args.seed,
                                    device=dev)
        finally:
            hogwild.make_sparse_round_step = real
        eng = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                              quantized=True)
        wire = T.Receiver(device=dev)
        for r, round_batches in enumerate(rounds, 1):
            label = f"local_sgd W={w} round {r}"
            start = clone_tree(pipe.params), clone_tree(pipe.opt_state)
            before = {t: x.clone() for t, x in row_tables(pipe).items()}
            seen.clear()
            frame = run_phase(label, lambda: pipe.run_round(iter(round_batches)))
            rep = pipe.reports[-1]
            want_kind = T.KIND_FULL if r == 1 else T.KIND_DELTA
            check(T.unframe(frame).kind == want_kind and rep.round == r,
                  f"{label}: frame kind {T.unframe(frame).kind} (want "
                  f"{want_kind}), report round {rep.round}")
            check(np.isfinite(rep.mean_loss), f"{label}: loss {rep.mean_loss}")
            if on_card:
                n = phase_launches[label][k10]
                check(n == 2 * w * k, f"{label}: {k10} launched {n} times, "
                      f"want 2 per worker step ({2 * w * k})")
            n_keep = check_untouched(label, cfg, dev, before, pipe,
                                     round_batches)
            del before
            # each worker before the merge against the jit backend's round on
            # its batches from the same start
            check(len(seen) == w, f"{label}: {len(seen)} workers seen")
            jit = []
            for i, (wp, ws) in enumerate(seen):
                jp, js, _ = JitBackend(cfg, "deepffm", make_optimizer(
                    "adagrad", lr=pipe.lr)).run(
                        clone_tree(start[0]), clone_tree(start[1]),
                        round_batches[i * k:(i + 1) * k])
                check(same_tree(wp, jp) and same_tree(ws, js),
                      f"{label}: worker {i} differs from the jit round on "
                      "its batches")
                jit.append((jp, js["acc"]))
            seen.clear()
            check(same_tree(pipe.params, hogwild._merge([j[0] for j in jit]))
                  and same_tree(pipe.acc, hogwild._merge([j[1] for j in jit])),
                  f"{label}: the merge of the jit rounds differs")
            del jit
            if r == 1:
                twin = TrainingPipeline(cfg, "deepffm", "local_sgd",
                                        local_sgd_workers=w, seed=args.seed,
                                        device=dev)
                twin.params, twin.opt_state = start
                twin_frame = twin.run_round(iter(round_batches))
                check(same_tree(twin.params, pipe.params)
                      and same_tree(twin.opt_state, pipe.opt_state)
                      and twin_frame == frame,
                      f"{label}: a re-run from the same start differs")
                del twin
            del start
            eng.apply_update(frame, pipe.sender.manifest, pipe.params)
            if r == 1:
                eng.warmup(max_requests=r_rows, max_candidates=n_cand)
            check_decoded_frame(label, frame, pipe.params, eng, wire,
                                pipe.sender, batches)
            step_s = rep.seconds - rep.update_seconds
            print(f"{label}: {rep.examples} examples ({w} workers x {k} x "
                  f"{TRAIN_BATCH}), {rep.examples_per_s:.0f} examples/s | "
                  f"{rep.seconds * 1e3:.1f} ms = workers + merge "
                  f"{step_s * 1e3:.1f} ms ({rep.examples / step_s:.0f} "
                  f"examples/s) + make_update {rep.update_seconds * 1e3:.1f} "
                  f"ms | mean loss {rep.mean_loss:.5f}, progressive AUC "
                  f"{rep.progressive_auc:.5f} | {rep.update_kind} frame "
                  f"{rep.update_bytes} bytes | untouched rows {n_keep} "
                  f"byte-stable; workers equal the jit rounds bit for bit"
                  f"{'; re-run bit-identical' if r == 1 else ''} | launches "
                  f"{phase_launches[label]} | {smi}")
        eng.update_pipe().close(timeout=60)


def hogwild_path(cfg, args, dev, on_card, smi, batches, run_phase,
                 phase_launches, r_rows, n_cand):
    """Phase 3, Hogwild: ``TrainingPipeline(backend="hogwild")`` at 4
    threads into an int8 engine, and a 1-thread round twice; see the module
    docstring."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import transfer as T
    from repro_torch.data.synthetic import CTRStream
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.train.hogwild import HogwildTrainer
    from repro_torch.train.pipeline import TrainingPipeline

    k10, n_micro, n_rounds = "sparse_weight_grad", HOGWILD_MICRO, 2
    stream = CTRStream(cfg, seed=args.seed + 8)
    rounds = [[stream.sample(TRAIN_BATCH) for _ in range(n_micro)]
              for _ in range(n_rounds)]
    pipe = TrainingPipeline(cfg, "deepffm", "hogwild", hogwild_threads=4,
                            seed=args.seed, device=dev)
    start = clone_tree(pipe.params)
    eng = InferenceEngine(cfg, "deepffm", backend="cuda", device=dev,
                          quantized=True)
    wire = T.Receiver(device=dev)
    for r, round_batches in enumerate(rounds, 1):
        label = f"hogwild 4 threads round {r}"
        before = {t: x.clone() for t, x in row_tables(pipe).items()}
        frame = run_phase(label, lambda: pipe.run_round(iter(round_batches)))
        rep = pipe.reports[-1]
        want_kind = T.KIND_FULL if r == 1 else T.KIND_DELTA
        check(T.unframe(frame).kind == want_kind and rep.round == r,
              f"{label}: frame kind {T.unframe(frame).kind} (want "
              f"{want_kind}), report round {rep.round}")
        check(np.isfinite(rep.mean_loss) and rep.examples == n_micro
              * TRAIN_BATCH, f"{label}: loss {rep.mean_loss}, examples "
              f"{rep.examples}")
        if on_card:
            n = phase_launches[label][k10]
            check(n == 2 * n_micro, f"{label}: {k10} launched {n} times, "
                  f"want 2 per microbatch ({2 * n_micro})")
        n_keep = check_untouched(label, cfg, dev, before, pipe, round_batches)
        del before
        eng.apply_update(frame, pipe.sender.manifest, pipe.params)
        if r == 1:
            eng.warmup(max_requests=r_rows, max_candidates=n_cand)
        check_decoded_frame(label, frame, pipe.params, eng, wire, pipe.sender,
                            batches)
        step_s = rep.seconds - rep.update_seconds
        print(f"{label}: {rep.examples} examples, {rep.examples_per_s:.0f} "
              f"examples/s | {rep.seconds * 1e3:.1f} ms = threads "
              f"{step_s * 1e3:.1f} ms ({rep.examples / step_s:.0f} "
              f"examples/s) + make_update {rep.update_seconds * 1e3:.1f} ms | "
              f"mean loss {rep.mean_loss:.5f}, progressive AUC "
              f"{rep.progressive_auc:.5f} | {rep.update_kind} frame "
              f"{rep.update_bytes} bytes | untouched rows {n_keep} "
              f"byte-stable | launches {phase_launches[label]} | {smi}")
    eng.update_pipe().close(timeout=60)
    # one thread: the same round twice from the same start, bit for bit (on
    # the CPU with one host thread, as the training phase's dense-vs-sparse
    # check: PyTorch's multi-threaded CPU sums change their order run to run)
    runs = []
    threads = torch.get_num_threads()
    if not on_card:
        torch.set_num_threads(1)
    try:
        for i in range(2):
            tr = HogwildTrainer(cfg, lr=pipe.lr, params=start, device=dev)
            stats = run_phase(f"hogwild 1 thread run {i + 1}",
                              lambda: tr.train(iter(rounds[0]), n_threads=1))
            runs.append((tr, stats))
    finally:
        torch.set_num_threads(threads)
    (a, sa), (b, sb) = runs
    check(same_tree(a.params(), b.params())
          and same_tree(a.opt_state(), b.opt_state()) and sa.losses == sb.losses,
          "hogwild: two 1-thread runs from the same start differ")
    if on_card:
        n = phase_launches["hogwild 1 thread run 1"][k10]
        check(n == 2 * n_micro, f"hogwild 1 thread: {k10} launched {n} "
              f"times, want {2 * n_micro}")
    print(f"hogwild 1 thread: {sa.examples} examples, "
          f"{sa.examples_per_s:.0f} / {sb.examples_per_s:.0f} examples/s (two "
          f"runs), mean loss {np.mean(sa.losses):.5f}; the runs equal bit for "
          f"bit | {smi}")
    return lambda n_threads: a.train(iter(rounds[1][:8]), n_threads=n_threads)


def llm_path(cfg, llm, args, dev, on_card, smi, run_phase, phase_launches):
    """Phase 3, LLM serving: ``LLMServer.generate`` (batched prefill, K11
    once per layer, then greedy decode) on the config's bf16 weights, and
    the f32 oracle (the prefill's last logits and cache against stepwise
    decode over the prompt, which never reaches K11). Returns callables
    that run one more prefill and one greedy decode step after it (phase
    4)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import registry, transformer
    from repro_torch.serving.server import LLMServer
    from repro_torch.train.steps import make_serve_step

    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    b, p_len, n_new = llm["batch"], llm["prompt"], llm["gen"]
    t0 = time.perf_counter()
    server = LLMServer(cfg, registry.init_params(cfg, args.seed, dev),
                       device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=gen,
                            device=dev, dtype=torch.int32)
    first = server.generate(prompts, n_new)  # first calls (cuBLAS, build)
    print(f"llm: {cfg.arch_id} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.dtype}) built and warmed in "
          f"{time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    label = f"llm generate B={b} P={p_len} new={n_new}"
    out = run_phase(label, lambda: server.generate(prompts, n_new))
    n_k11 = phase_launches[label]["flash_attention"]
    print(f"launches {label}: {phase_launches[label]}")
    if on_card:
        check(n_k11 == cfg.n_layers,
              f"{label}: flash_attention launched {n_k11} times, want one "
              f"per layer of the one prefill ({cfg.n_layers}) and none in "
              "decode")
    check(out.shape == (b, n_new) and out.dtype == torch.int32
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{label}: tokens {tuple(out.shape)} {out.dtype} out of range")
    check(torch.equal(out, first), f"{label}: a second generate differs")
    pre_ms, dec_s = server.last_prefill_s * 1e3, server.last_decode_s
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if on_card else "not measured (no card)")
    rate = prefill_rate(cfg, b * p_len, server.last_prefill_s, on_card)
    print(f"llm generate: prefill {pre_ms:.2f} ms ({b * p_len / pre_ms * 1e3:.0f}"
          f" prompt tokens/s, {rate}) | decode "
          f"{dec_s / n_new * 1e3:.3f} ms per step "
          f"({b * n_new / dec_s:.0f} tokens/s) | end to end "
          f"{b * n_new / (server.last_prefill_s + dec_s):.0f} new tokens/s | "
          f"peak allocated {peak} | {smi}")

    def prefill():
        with torch.inference_mode():
            state = registry.init_decode_state(cfg, b, p_len + 1, device=dev)
            return transformer.prefill(cfg, server.params, prompts, state)

    serve_step = make_serve_step(cfg)
    lg, dec_state = prefill()

    def decode():
        with torch.inference_mode():
            return serve_step(server.params, dec_state,
                              torch.argmax(lg, dim=-1).to(torch.int32))

    # the oracle, in f32 at the config's widths
    ob, op = llm["oracle"]
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = registry.init_params(cfg32, args.seed, dev)
    toks = torch.randint(0, cfg.vocab_size, (ob, op), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        _build.reset_launches()
        lg_pre, st_pre = transformer.prefill(
            cfg32, p32, toks, registry.init_decode_state(cfg32, ob, op,
                                                         device=dev))
        n_pre = _build.launches["flash_attention"]
        st = registry.init_decode_state(cfg32, ob, op, device=dev)
        for i in range(op):
            lg_dec, st = registry.decode_step(cfg32, p32, st, toks[:, i])
        n_dec = _build.launches["flash_attention"] - n_pre
    if on_card:
        torch.cuda.synchronize()
        check(n_pre == cfg.n_layers and n_dec == 0,
              f"llm oracle: flash_attention launched {n_pre} times in the "
              f"prefill, {n_dec} in stepwise decode")

    rels = {"logits": rel(lg_pre, lg_dec)}
    for name in ("k", "v"):
        rels[f"cache {name}"] = rel(st_pre["cache"][name],
                                    st["cache"][name])
    check(bool(torch.isfinite(lg_pre).all()) and lg_pre.shape ==
          (ob, cfg.padded_vocab), "llm oracle: prefill logits")
    for name, r in rels.items():
        check(r < ORACLE_REL, f"llm oracle: prefill {name} vs {op} stepwise "
              f"decode steps rel {r:.3e} >= {ORACLE_REL}")
    print(f"llm oracle (f32, B={ob}, P={op}): prefill through "
          f"flash_attention vs {op} decode steps without it: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in rels.items())
          + f" (bound {ORACLE_REL})")
    del p32, st_pre, st
    return prefill, decode


def llm_train_path(cfg, tr, args, dev, on_card, smi, run_phase,
                   phase_launches):
    """Phase 3, LLM training: ``make_train_step`` (Adam) on full-width
    llama3.2-1b in bf16 with its config's remat (``"dots"``),
    ``tr["steps"]`` steps on one batch of ``lm_batches``: the loss finite
    and falling, K11 twice per layer a step (:func:`train_launches`: the
    forward and the backward's recompute), K13 and K12 once; ms per step
    after the first, tokens/s, TFLOP/s (:func:`train_step_flops`), peak
    allocation. Then its ``remat=False`` twin from the same seed on the same
    batch: its losses and final params bit for bit the remat run's, K11 once
    per layer, both routes' ms, tokens/s and peaks printed. Then the f32
    oracle at full width and reduced depth (remat as the config): the
    gradients of ``loss_fn`` through K11 / K13 / K12 against the same
    gradients through the plain versions (``attention.flash_attention``'s
    kernel call swapped for autograd through ``flash_attention_ref``, which
    must launch nothing), per leaf rel < ``ORACLE_REL``. Then every other
    arch id's smoke config trains ``tr["steps"]`` steps, finite and falling.
    Returns a callable that runs one more full-width step (phase 4), and
    the unsharded run's losses, params after its steps and ms a step."""
    import torch

    from repro_torch.checkpoint import layout
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import loss_and_grads, make_train_step

    def batch_of(c, b, s, seed):
        out = {k: torch.from_numpy(v).to(dev) for k, v in
               next(lm_batches(c.vocab_size, b, s, 1, seed=seed)).items()}
        if c.family == "encdec":
            gen = torch.Generator(device=dev).manual_seed(seed)
            out["frames"] = torch.randn((b, s, c.d_model), generator=gen,
                                        device=dev)
        return out

    b, s = tr["batch"], tr["seq"]
    opt = make_optimizer("adam", lr=tr["lr"])
    batch = batch_of(cfg, b, s, args.seed)
    flops, attn = train_step_flops(cfg, b, s)

    def train(c, what):
        """``tr["steps"]`` steps of ``c`` from the seed's weights: (the
        run's state and one-step callable, loss tensors, seconds a step,
        the peak allocation after the first step and its rise over what
        was allocated before the run's weights were built)."""
        if on_card:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        run = {"params": registry.init_params(c, args.seed, dev), "step": 0}
        run["opt"] = opt.init(run["params"])
        step_fn = make_train_step(c, opt)

        def one_step():
            run["params"], run["opt"], run["step"], m = step_fn(
                run["params"], run["opt"], run["step"], batch)
            return m

        print(f"llm train{what}: {c.arch_id} ({c.n_layers} layers, d_model "
              f"{c.d_model}, {c.dtype}, remat {c.remat} "
              f"({c.remat_policy}), Adam lr {tr['lr']}) weights and state "
              f"built in {time.perf_counter() - t0:.1f} s")
        want = train_launches(c)
        losses, secs = [], []
        for i in range(tr["steps"]):
            if on_card and i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            label = f"llm train{what} step {i} B={b} S={s}"
            t0 = time.perf_counter()
            m = run_phase(label, one_step)
            secs.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            counts = phase_launches[label]
            print(f"launches {label}: "
                  + ", ".join(f"{k} {counts[k]}" for k in FLASH_KERNELS))
            if on_card:
                for name in FLASH_KERNELS:
                    check(counts[name] == want[name],
                          f"{label}: {name} launched {counts[name]} times, "
                          f"want {want[name]} ({c.n_layers} layers, remat "
                          f"{c.remat})")
        peak = (torch.cuda.max_memory_allocated(dev), base) if on_card \
            else None
        return run, one_step, losses, secs, peak

    def report(what, losses, secs, peak):
        ms = 1e3 * sum(secs[1:]) / len(secs[1:])
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if on_card
                else "TFLOP/s not measured (no card)")
        mem = (f"{peak[0] / 2**30:.2f} GiB ({(peak[0] - peak[1]) / 2**30:.2f}"
               " GiB above what was allocated before the run's weights)"
               if on_card else "not measured (no card)")
        print(f"llm train{what}: losses "
              f"{', '.join(f'{float(x):.4f}' for x in losses)} | {ms:.2f} ms "
              f"per step after the first (first {1e3 * secs[0]:.2f} ms) | "
              f"{b * s / ms * 1e3:.0f} tokens/s | {rate} ({flops:.4e} FLOP a "
              f"step: model_flops' 6 N T {flops - attn:.4e} + attention "
              f"{attn:.4e}) | peak allocated {mem} | {smi}")
        return ms

    run, one_step, loss_tensors, secs, peak = train(cfg, "")
    losses = [float(x) for x in loss_tensors]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"llm train: losses {losses} not finite and falling")
    ms = report("", loss_tensors, secs, peak)
    # for the 1 x 1 mesh phase: its steps must give these bits
    unsharded = {"losses": loss_tensors, "params": clone_tree(run["params"]),
                 "ms": ms, "step": one_step}

    # the twin without remat: the same bits, another memory and time
    twin, _, twin_losses, twin_secs, twin_peak = train(
        cfg.replace(remat=False), " remat=False twin")
    check(all(torch.equal(a, w) for a, w in zip(twin_losses, loss_tensors)),
          f"llm train: the remat=False twin's losses "
          f"{[float(x) for x in twin_losses]} differ from the remat run's "
          f"{losses}")
    twin_leaves = dict(layout.flatten_with_paths(twin["params"]))
    differ = [path for path, w in layout.flatten_with_paths(
        unsharded["params"]) if not torch.equal(twin_leaves[path], w)]
    check(not differ, f"llm train: the remat=False twin's params differ from "
          f"the remat run's at {differ[:5]}")
    twin_ms = report(" remat=False twin", twin_losses, twin_secs, twin_peak)
    print(f"llm train: remat ({cfg.remat_policy}) against the remat=False "
          f"twin: losses and every leaf after {tr['steps']} steps bit for "
          f"bit; {ms:.2f} / {twin_ms:.2f} ms a step "
          f"({100 * (ms / twin_ms - 1):+.1f}%)"
          + (f"; peak above the run's start "
             f"{(peak[0] - peak[1]) / 2**30:.2f} / "
             f"{(twin_peak[0] - twin_peak[1]) / 2**30:.2f} GiB"
             if on_card else "") + f" | {smi}")
    del twin
    adam_slices_check(cfg, opt, run, batch, on_card, smi)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the f32 oracle: K11 / K13 / K12 against autograd through the plain
    # flash, per leaf
    ob, os_ = tr["oracle"]
    cfg32 = cfg.replace(n_layers=tr["oracle_layers"], dtype="float32",
                        param_dtype="float32")
    p32 = registry.init_params(cfg32, args.seed, dev)
    b32 = batch_of(cfg32, ob, os_, args.seed + 1)

    def oracle_run():
        _build.reset_launches()
        loss, _, grads = loss_and_grads(cfg32, p32, b32)
        if on_card:
            torch.cuda.synchronize()
        return loss, grads, dict(_build.launches)

    kern_loss, kern_g, n_kern = oracle_run()
    kernel_call = fa_ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0):
        return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)

    fa_ops.flash_attention = plain
    try:
        plain_loss, plain_g, n_plain = oracle_run()
    finally:
        fa_ops.flash_attention = kernel_call
    if on_card:
        want32 = train_launches(cfg32)
        check(all(n_kern[k] == want32[k] for k in FLASH_KERNELS)
              and not any(n_plain[k] for k in FLASH_KERNELS),
              f"llm train oracle: launches {n_kern} through the kernels, "
              f"{n_plain} in the plain run")
    rels = {}

    def walk(kg, pg, name=""):
        if isinstance(kg, dict):
            for key in kg:
                walk(kg[key], pg[key], f"{name}/{key}")
        else:
            rels[name] = rel(kg, pg)

    walk(kern_g, plain_g)
    worst = max(rels, key=rels.get)
    check(all(math.isfinite(r) and r < ORACLE_REL for r in rels.values())
          and rel(kern_loss, plain_loss) < ORACLE_REL,
          f"llm train oracle: gradient {worst} rel {rels[worst]:.3e} >= "
          f"{ORACLE_REL}")
    print(f"llm train oracle (f32, {cfg32.n_layers} of {cfg.n_layers} "
          f"layers, remat {cfg32.remat}, B={ob}, S={os_}): loss rel "
          f"{rel(kern_loss, plain_loss):.3e}; {len(rels)} leaves' gradients "
          f"through K11 / K13 / K12 vs the plain flash, worst {worst} rel "
          f"{rels[worst]:.3e} (bound {ORACLE_REL})")
    del p32, kern_g, plain_g

    # every other arch id's smoke config, on the card
    sb, ss = tr["smoke"]
    for arch in registry.ARCH_IDS:
        if arch == cfg.arch_id:
            continue
        c = registry.get_config(arch, smoke=True)
        sopt = make_optimizer("adam", lr=tr["lr"])
        sp = registry.init_params(c, args.seed, dev)
        sst, sstep, sbatch = sopt.init(sp), 0, batch_of(c, sb, ss, args.seed)
        sstep_fn = make_train_step(c, sopt)
        slosses = []

        def smoke_steps():
            nonlocal sp, sst, sstep
            for _ in range(tr["steps"]):
                sp, sst, sstep, m = sstep_fn(sp, sst, sstep, sbatch)
                slosses.append(float(m["loss"]))

        label = f"llm train smoke {arch}"
        run_phase(label, smoke_steps)
        check(all(math.isfinite(x) for x in slosses)
              and slosses[-1] < slosses[0],
              f"{label}: losses {slosses} not finite and falling")
        counts = phase_launches[label]
        print(f"{label} ({c.family}, {sb}x{ss} tokens, {c.dtype}): losses "
              f"{', '.join(f'{x:.4f}' for x in slosses)} | launches "
              + ", ".join(f"{k} {counts[k]}" for k in FLASH_KERNELS))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return one_step, unsharded


def moe_ep_path(ep, args, dev, on_card, smi, run_phase, phase_launches, rt):
    """Phase 3, the expert-parallel MoE on a 1 x 1 mesh (``rt``, a one-rank
    world): ``moe.moe_expert_parallel`` on one full-width phi3.5-moe MoE
    layer (bf16, d 4096, 16 experts of 6400, top-2) and ``ep["batch"]`` x
    ``ep["seq"]`` tokens. At ``EP_NO_DROP_CF`` no copy drops and EP is held
    to ``moe_dense``; at the config's capacity factor it is held to a
    reference built apart from it: ``moe_dense``'s per-expert outputs
    (``_expert_ffn`` on every token) combined with the router's weights,
    the dropped copies' zeroed, the drops found on the host in numpy by the
    stable-sort rule. Each in bf16 (per row within ``EP_BF16_ROW``) and in
    f32 (within ``ORACLE_REL``); aux against ``moe_dense``'s; the dropped
    share, EP's and the dense layer's ms. Then phi's forward at
    ``ep["layers"]`` layers through ``transformer.forward`` with ``rt``
    (``"auto"`` takes EP in every layer, counted) and without (dense),
    each timed after a warm-up; K11 once per layer in each."""
    import numpy as np
    import torch

    from repro_torch.common import pspec
    from repro_torch.models import moe, registry, transformer

    full = registry.get_config(PHI, smoke=args.tiny).replace(moe_impl="auto")
    b, s = ep["batch"], ep["seq"]
    t, d = b * s, full.d_model
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    p16 = pspec.materialize(moe.moe_specs(full), args.seed, dev)
    col = p16["router"][:, 0]
    x32 = (torch.randn((b, s, d), generator=gen, device=dev)
           + EP_SKEW * col / col.norm() * math.sqrt(d) / 4)

    def events_ms(fn, n=10):
        if not on_card:
            return None
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def kept(ids, cap):
        """The copies within capacity, by the stable-sort rule, on the host:
        a copy's position is its rank among same-expert copies in copy
        order (one device: all tokens)."""
        flat = ids.reshape(-1).cpu().numpy()
        pos = np.empty_like(flat)
        for e in np.unique(flat):
            where = np.flatnonzero(flat == e)  # copy order
            pos[where] = np.arange(where.size)
        return torch.from_numpy(pos < cap).to(dev).reshape(ids.shape)

    def row_rel(y, ref):
        y, ref = y.reshape(-1, d).float(), ref.reshape(-1, d).float()
        return float((torch.linalg.vector_norm(y - ref, dim=-1)
                      / torch.linalg.vector_norm(ref, dim=-1).clamp_min(
                          1e-30)).max())

    n_copies = t * full.top_k
    for cf in (EP_NO_DROP_CF, full.capacity_factor):
        cfg = full.replace(capacity_factor=cf)
        cap = moe._capacity(cfg, t)
        for dtype in (torch.bfloat16, torch.float32):
            p = {k: v.to(dtype) if k != "router" else v
                 for k, v in p16.items()}
            x = x32.to(dtype)
            tname = str(dtype).removeprefix("torch.")
            label = f"moe expert_parallel {PHI} 1x1 cf {cf} {tname}"
            with torch.no_grad():
                y, aux = run_phase(
                    label, lambda: moe.moe_expert_parallel(cfg, p, x, rt))
                xt = x.reshape(t, d)
                w, ids, _ = moe._router(cfg, p["router"], xt)
                keep = kept(ids, cap)
                y_all = moe._expert_ffn(cfg, p, xt)  # (E, T, d)
                picked = y_all[ids, torch.arange(t, device=dev)[:, None]]
                ref = (picked.float() * (w * keep)[..., None]).sum(1)
                dense, dense_aux = moe.moe_dense(cfg, p, x)
                del y_all, picked
            n_drop = n_copies - int(keep.sum())
            if cf == EP_NO_DROP_CF:
                check(n_drop == 0, f"{label}: {n_drop} copies dropped")
            err = {"reference": row_rel(y, ref), "moe_dense": row_rel(y, dense)}
            tol = EP_BF16_ROW if dtype == torch.bfloat16 else ORACLE_REL
            held = "moe_dense" if cf == EP_NO_DROP_CF else "reference"
            check(err[held] <= tol and math.isfinite(float(aux))
                  and abs(float(aux) - float(dense_aux))
                  <= 1e-5 * abs(float(dense_aux)),
                  f"{label}: rows {err} of their norm against {held} (bound "
                  f"{tol}); aux {float(aux)} vs dense {float(dense_aux)}")
            times = ""
            if dtype == torch.bfloat16:
                ep_ms = events_ms(lambda: moe.moe_expert_parallel(
                    cfg, p, x, rt))
                dense_ms = events_ms(lambda: moe.moe_dense(cfg, p, x))
                if on_card:
                    times = (f" | EP {ep_ms:.3f} ms, moe_dense {dense_ms:.3f}"
                             f" ms per layer ({dense_ms / ep_ms:.2f}x; expert "
                             f"slots {full.n_experts * cap} against "
                             f"{full.n_experts * t} token-expert pairs, "
                             f"{full.n_experts * t / (full.n_experts * cap):.2f}"
                             "x fewer)")
            print(f"{label}: capacity {cap} a device and expert, dropped "
                  f"{n_drop} of {n_copies} copies ({100 * n_drop / n_copies:.2f}"
                  f"%) | rows against the reference {err['reference']:.3e}, "
                  f"against moe_dense {err['moe_dense']:.3e} of their norm "
                  f"(held: {held}, bound {tol:.3e}) | aux {float(aux):.6f}"
                  f" (dense {float(dense_aux):.6f}){times} | {smi}")
            del p, x, y, ref, dense
    del p16
    if on_card:
        torch.cuda.empty_cache()

    # phi's forward at ep["layers"] layers: "auto" takes EP on the mesh
    cfg = full.replace(n_layers=ep["layers"])
    if on_card:
        need = spec_bytes(registry.param_specs(cfg)) + FAMILY_MARGIN_BYTES
        free_bytes = torch.cuda.mem_get_info(dev)[0]
        check(need <= free_bytes, f"phi at {cfg.n_layers} layers needs {need}"
              f" bytes, the card has {free_bytes} free")
    params = registry.init_params(cfg, args.seed, dev)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    calls = {"n": 0}
    ep_call = moe.moe_expert_parallel

    def counted(*a, **kw):
        calls["n"] += 1
        return ep_call(*a, **kw)

    outs, ms = {}, {}
    for name, r in (("expert_parallel", rt), ("dense", None)):
        def fwd(r=r):
            with torch.inference_mode():
                return transformer.forward(cfg, params, tokens, r)

        fwd()  # warm-up
        label = (f"moe {PHI} forward {cfg.n_layers} of {full.n_layers} "
                 f"layers B={b} S={s} {name}")
        moe.moe_expert_parallel = counted
        calls["n"] = 0
        try:
            outs[name] = run_phase(label, fwd)
        finally:
            moe.moe_expert_parallel = ep_call
        lg, aux = outs[name]
        want = cfg.n_layers if name == "expert_parallel" else 0
        n_k11 = phase_launches[label]["flash_attention"]
        check(calls["n"] == want and lg.shape == (b, s, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()) and math.isfinite(float(aux)),
              f"{label}: {calls['n']} expert-parallel layers (want {want}), "
              f"logits {tuple(lg.shape)} finite or not, aux {float(aux)}")
        if on_card:
            check(n_k11 == cfg.n_layers, f"{label}: flash_attention launched "
                  f"{n_k11} times, want {cfg.n_layers}")
        ms[name] = events_ms(fwd, n=3)
        timing = ("not measured (no card)" if ms[name] is None else
                  f"{ms[name]:.2f} ms a call (CUDA events, 3 calls)")
        print(f"{label}: {timing} | {calls['n']} layers through "
              f"moe_expert_parallel, K11 {n_k11} | aux {float(aux):.6f} | "
              f"{smi}")
        if on_card:
            where_the_time_goes(label, fwd, smi, top=8)
    if on_card:
        print(f"moe {PHI} forward: expert-parallel "
              f"{ms['expert_parallel']:.2f} ms against dense "
              f"{ms['dense']:.2f} ms ({ms['dense'] / ms['expert_parallel']:.2f}"
              "x) | logits rel "
              f"{rel(outs['expert_parallel'][0].float(), outs['dense'][0].float()):.3e}"
              " (copies dropped at capacity factor 1.25: not held) | " + smi)
    del params, outs
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def mesh_train_path(cfg, tr, args, dev, on_card, smi, run_phase,
                    phase_launches, rt, unsharded):
    """Phase 3, the sharded train step on a 1 x 1 mesh (``rt``, a one-rank
    world): ``make_train_step(cfg, adam, rt)`` on full-width llama3.2-1b in
    bf16 from the LLM training phase's seed, ``tr["steps"]`` steps on its
    batch. Every leaf is sharded by ``param_shardings`` (on a 1 x 1 mesh
    each rank's shard is the whole leaf) and gathered before the forward
    (copies on a one-rank NCCL world), the gradients all-reduced and sliced
    back, Adam shard-local. Losses and the final params must equal the
    unsharded phase's bit for bit (``unsharded``: its losses, params after
    its steps and ms a step); K11 twice (with remat) and K13 / K12 once
    per layer a step (:func:`train_launches`). ms per step after the
    first, the gather copies' bytes a step, the peak allocation."""
    import torch

    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import sharding
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import make_train_step

    b, s = tr["batch"], tr["seq"]
    full = registry.init_params(cfg, args.seed, dev)
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg), full,
                                     rt.mesh)
    gathered = 0

    def count(t, spec):  # the leaves that shard over some axis
        nonlocal gathered
        if isinstance(t, dict):
            for k in t:
                count(t[k], spec[k])
        elif any(e is not None for e in spec):
            gathered += t.numel() * t.element_size()

    count(full, specs)
    params = sharding.local_tree(full, specs, rt)
    del full
    opt = make_optimizer("adam", lr=tr["lr"])
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, rt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             next(lm_batches(cfg.vocab_size, b, s, 1, seed=args.seed)).items()}
    losses, secs = [], []
    for i in range(tr["steps"]):
        if on_card and i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        label = f"mesh train {cfg.arch_id} 1x1 step {i} B={b} S={s}"
        t0 = time.perf_counter()
        params, state, _, m = run_phase(
            label, lambda: step_fn(params, state, i, batch))
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        counts = phase_launches[label]
        print(f"launches {label}: "
              + ", ".join(f"{k} {counts[k]}" for k in FLASH_KERNELS))
        if on_card:
            want = train_launches(cfg)
            for name in FLASH_KERNELS:
                check(counts[name] == want[name],
                      f"{label}: {name} launched {counts[name]} times, want "
                      f"{want[name]} ({cfg.n_layers} layers, remat "
                      f"{cfg.remat})")
    check(all(torch.equal(a, w) for a, w in zip(losses, unsharded["losses"])),
          f"mesh train: losses {[float(x) for x in losses]} differ from the "
          f"unsharded {[float(x) for x in unsharded['losses']]}")
    differ = []

    def same(a, w, path=""):
        if isinstance(a, dict):
            for k in a:
                same(a[k], w[k], f"{path}/{k}")
        elif not torch.equal(a, w):
            differ.append(path)

    same(params, unsharded["params"])
    check(not differ, f"mesh train: params differ from the unsharded "
          f"phase's at {differ[:5]}")
    ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if on_card else "not measured (no card)")
    turns = ""
    if on_card:
        # more steps in turns, unsharded / sharded / sharded / unsharded
        # twice (the sharded steps' results dropped), each on the host
        # clock, then one sharded step under the profiler
        def clocked(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        took = {"unsharded": [], "sharded": []}
        for who in ("unsharded", "sharded", "sharded", "unsharded") * 2:
            took[who].append(clocked(
                unsharded["step"] if who == "unsharded" else
                lambda: step_fn(params, state, tr["steps"], batch)))
        med = {k: sorted(v)[len(v) // 2] for k, v in took.items()}
        turns = (f" | in turns: unsharded "
                 f"{', '.join(f'{x:.2f}' for x in took['unsharded'])} ms, "
                 f"sharded {', '.join(f'{x:.2f}' for x in took['sharded'])}"
                 f" ms (medians {med['unsharded']:.2f} / "
                 f"{med['sharded']:.2f}, "
                 f"{100 * (med['sharded'] / med['unsharded'] - 1):+.1f}%)")
        where_the_time_goes(
            f"mesh train step ({cfg.arch_id} 1x1, B={b}, S={s}, Adam)",
            lambda: step_fn(params, state, tr["steps"], batch), smi, top=10,
            share_of=("nccl", "Memcpy", "copy", "flash_attention"))
    print(f"mesh train {cfg.arch_id} 1x1 (one-rank "
          f"{'NCCL' if on_card else 'gloo'} world): losses "
          f"{', '.join(f'{float(x):.4f}' for x in losses)} and every leaf "
          f"after {tr['steps']} steps bit for bit the unsharded phase's | "
          f"{ms:.2f} ms per step after the first (unsharded "
          f"{unsharded['ms']:.2f} ms in this run; first {1e3 * secs[0]:.2f} "
          f"ms){turns} | gather copies {gathered} bytes a step | peak "
          f"allocated {peak} | {smi}")
    del params, state
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


DRYRUN_FULL = {"batch": 4, "seq": 1024}
DRYRUN_TINY = {"batch": 2, "seq": 16}
DRYRUN_TIMED = 3
# what the counted step adds to the allocator's peak against the meta
# count's peak: the allocator rounds each block up to 512 bytes and holds
# what the counter cannot see (cuBLAS workspaces made at a first call)
DRYRUN_PEAK_RTOL = 0.02
# the dry run's step in a subprocess (a fake world of one rank cannot open
# beside this process's NCCL world), once per config override: the report,
# the per-op counts and, when asked, the counted peak of the forward and
# backward alone (``steps.loss_and_grads``, unsharded)
DRYRUN_CHILD = """
import dataclasses, json, sys
from repro_torch.common.config import InputShape
from repro_torch.launch import dryrun_lib, op_analysis, specs
from repro_torch.models import registry
from repro_torch.train import steps
arch, fields, smoke, overrides, alone = json.loads(sys.argv[1])
base = (dataclasses.asdict(registry.get_config(arch, smoke=True)) if smoke
        else {})
shape = InputShape(*fields)
for over in overrides:
    over = {**base, **over}
    res, counter = dryrun_lib.measure(arch, shape, mesh_shape=(1, 1),
                                      overrides=over)
    rec = {"report": res, "totals": counter.totals(), "ops": counter.ops,
           "kernels": counter.kernels}
    if alone:
        cfg = registry.get_config(arch).replace(**over)
        with op_analysis.Counter() as grads:
            steps.loss_and_grads(cfg, registry.abstract_params(cfg),
                                 specs.batch_specs(cfg, shape))
        rec["grads_peak"] = grads.peak_bytes
    print("DRYRUN" + json.dumps(rec, default=str), flush=True)
"""


def dryrun_child(arch: str, fields, tiny: bool, overrides,
                 alone: bool = False):
    """:data:`DRYRUN_CHILD` on ``arch`` at ``fields`` (an ``InputShape``'s),
    the smoke config in the rehearsal, once per dict of ``overrides``: one
    record each, with ``"grads_peak"``, the counted peak of the forward and
    backward alone, when ``alone``."""
    import subprocess

    child = subprocess.run(
        [sys.executable, "-c", DRYRUN_CHILD, json.dumps(
            [arch, list(fields), bool(tiny), list(overrides), alone])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_child_env(), timeout=600)
    out = [json.loads(ln[len("DRYRUN"):]) for ln in child.stdout.splitlines()
           if ln.startswith("DRYRUN")]
    check(child.returncode == 0 and len(out) == len(overrides),
          f"the dry run's subprocess failed:\n{child.stdout[-4000:]}")
    return out


def _child_env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    return env


def start_dryruns(tiny: bool):
    """The dry run's commands (``launch/dryrun.py`` on both production
    meshes, ``launch/dryrun_ffm.py``), started together as subprocesses
    writing into a temporary directory: ``(label, process, log path, out
    dir, start)`` each. The CPU rehearsal runs one combination per mesh."""
    import atexit
    import subprocess
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    picks = (["--arch", "llama3.2-1b", "--shape", "long_500k"] if tiny
             else ["--all"])
    cmds = [("dryrun " + " ".join(picks), ["-m", "repro_torch.launch.dryrun",
                                           *picks]),
            ("dryrun " + " ".join(picks) + " --multi-pod",
             ["-m", "repro_torch.launch.dryrun", *picks, "--multi-pod"]),
            ("dryrun_ffm", ["-m", "repro_torch.launch.dryrun_ffm"])]
    out = []
    for i, (label, argv) in enumerate(cmds):
        log = tmp / f"cmd{i}.log"
        out_dir = tmp / f"out{i}"
        if argv[1].endswith(".dryrun"):
            argv = argv + ["--out", str(out_dir)]
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, *argv], stdout=f,
                                    stderr=subprocess.STDOUT, env=_child_env(),
                                    cwd=str(tmp))
        out.append((label, proc, log, out_dir, time.time()))

    def stop():  # a phase failed before finish_dryruns: end them all
        for _, proc, _, _, _ in out:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return out


def finish_dryruns(dryruns, timeout_s: float):
    """Wait for :func:`start_dryruns`' commands (killing any still running
    at ``timeout_s``), print their summary lines, each combination's peak
    per rank and each command's seconds; raise unless each exited 0 with
    every combination ``ok`` and only seamless at ``long_500k`` skipped."""
    import shutil

    try:
        end = time.perf_counter() + timeout_s
        for label, proc, log, out_dir, t0 in dryruns:
            try:
                rc = proc.wait(timeout=max(1.0, end - time.perf_counter()))
            except Exception:
                proc.kill()
                proc.wait()
                raise
            secs = log.stat().st_mtime - t0  # the log's last write
            text = log.read_text()
            lines = [ln for ln in text.splitlines() if ln.strip()]
            for ln in lines:
                print(f"{label}: {ln}")
            check(rc == 0, f"{label} exited {rc}:\n{text[-4000:]}")
            skips = [ln for ln in lines if "SKIP:" in ln]
            check(all(ln.split()[:2] == ["seamless-m4t-large-v2",
                                         "long_500k"] for ln in skips),
                  f"{label}: unexpected skips {skips}")
            check("FAILED" not in text, f"{label}: a combination failed")
            for js in sorted(out_dir.glob("*.json")):
                rep = json.loads(js.read_text())
                mem = rep.get("memory_per_device") or {}
                print(f"{label}: {js.stem}: peak per rank "
                      f"{mem.get('peak_bytes', 0) / 1e9:.2f} GB (arguments "
                      f"{mem.get('argument_bytes', 0) / 1e9:.2f} GB), bound "
                      f"{rep['step_time_bound'] * 1e3:.3f} ms "
                      f"{rep['bottleneck']}, useful "
                      f"{rep['useful_flops_ratio']:.4f}")
            print(f"{label}: exit 0 after {secs:.1f} s (meta-device dry run "
                  "at H100 SXM5 spec-sheet peaks, not measured)")
    finally:
        for _, proc, log, _, _ in dryruns:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if dryruns:
            shutil.rmtree(dryruns[0][2].parent, ignore_errors=True)


def dryrun_path(cfg, dr, args, dev, on_card, smi, run_phase, phase_launches,
                rt):
    """Phase 3, the dry run (see the module's docstring, (a)-(c)), on the
    one-rank world ``rt``: full-width llama3.2-1b (its smoke config in the
    rehearsal), its config's remat on. The meta count runs in a subprocess
    after the card's steps, so that nothing else loads the host while they
    are timed."""
    import torch

    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import op_analysis, sharding
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import steps

    b, s = dr["batch"], dr["seq"]
    fields = ("chip_smoke_train", s, b, "train")
    full = registry.init_params(cfg, args.seed, dev)
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg), full,
                                     rt.mesh)
    params = sharding.local_tree(full, specs, rt)
    del full
    opt = make_optimizer("adam", lr=1e-3)
    state = steps.init_opt_state(cfg, opt, params, rt)
    step_fn = steps.make_train_step(cfg, opt, rt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        lm_batches(cfg.vocab_size, b, s, 1, seed=args.seed)).items()}
    label = f"dryrun {cfg.arch_id} 1x1 counted step B={b} S={s}"
    step_fn(params, state, 0, batch)  # warm-up
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with op_analysis.Counter() as counter:
        run_phase(label, lambda: step_fn(params, state, 1, batch))
    step_peak = (torch.cuda.max_memory_allocated(dev) - before if on_card
                 else None)
    took = []
    for i in range(DRYRUN_TIMED):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, state, 2 + i, batch)
        if on_card:
            torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    meta, = dryrun_child(cfg.arch_id, fields, args.tiny, [
        {"remat": cfg.remat, "remat_policy": cfg.remat_policy}])
    rep, want = meta["report"], meta["totals"]
    got = counter.totals()
    counts = phase_launches[label]
    print(f"launches {label}: " + ", ".join(f"{k} {counts[k]}"
                                            for k in FLASH_KERNELS))
    check(got["flops"] == want["flops"],
          f"dry run: the card's step counts {got['flops']} FLOPs, the meta "
          f"step {want['flops']}")
    for key in want:
        if key.endswith("_bytes") or key.endswith("_count"):
            check(got[key] == want[key], f"dry run: {key} {got[key]} on the "
                  f"card, {want[key]} on meta")
    booked = {k: list(v) for k, v in counter.kernels.items()}
    check(booked == meta["kernels"], f"dry run: bookings {booked} on the "
          f"card, {meta['kernels']} on meta")
    differ = {k: (counter.ops.get(k), meta["ops"].get(k))
              for k in set(counter.ops) | set(meta["ops"])
              if list(counter.ops.get(k, [0, 0, 0]))
              != list(meta["ops"].get(k, [0, 0, 0]))}
    if got["bytes"] != want["bytes"]:
        print(f"dry run: bytes {got['bytes']} on the card against "
              f"{want['bytes']} on meta ({got['bytes'] - want['bytes']:+d}); "
              "the ops that differ ([calls, FLOPs, bytes] card / meta):")
        for k, (c, m) in sorted(differ.items()):
            print(f"  {k}: {c} / {m}")
    else:
        print("dry run: bytes equal on the card and on meta")
    ms = 1e3 * sorted(took)[len(took) // 2]
    bound_ms = 1e3 * rep["step_time_bound"]
    if on_card:
        check(ms >= bound_ms, f"dry run: the step took {ms:.3f} ms, under "
              f"its bound {bound_ms:.3f} ms: the count holds work the card "
              "did not do")
    mem = rep["memory_per_device"]
    counted = int(mem["peak_bytes"] - mem["argument_bytes"])
    if on_card:
        check(abs(step_peak - counted) <= DRYRUN_PEAK_RTOL * counted,
              f"dry run: the counted step added {step_peak} bytes to the "
              f"allocator's peak, the meta count's peak less its arguments "
              f"is {counted} (rtol {DRYRUN_PEAK_RTOL})")
        card = (f"{step_peak} B ({step_peak / 2**30:.2f} GiB; "
                f"{100 * (step_peak / counted - 1):+.2f}%, rtol "
                f"{DRYRUN_PEAK_RTOL}) over memory_allocated "
                f"{before / 2**30:.2f} GiB just before it")
    else:
        card = "not measured (no card)"
    print(f"dry run {cfg.arch_id} 1x1 (B={b}, S={s}, ZeRO-1 Adam): counted "
          f"{got['flops']} FLOPs, {got['bytes']} bytes, collective "
          f"{got['total_bytes']} bytes (one-rank groups count 0), meta "
          f"{want['flops']} / {want['bytes']} / {want['total_bytes']}; "
          f"bound {bound_ms:.3f} ms ({rep['bottleneck']}: compute "
          f"{1e3 * rep['t_compute']:.3f}, memory {1e3 * rep['t_memory']:.3f}"
          f" ms at H100 SXM5 spec-sheet peaks) against "
          f"{'measured' if on_card else 'CPU-clocked'} "
          f"{', '.join(f'{1e3 * t:.3f}' for t in took)} ms (median "
          f"{ms:.3f}: the bound is {100 * bound_ms / ms:.1f}% of it); "
          f"useful {rep['useful_flops_ratio']:.4f}; counted peak "
          f"{mem['peak_bytes'] / 2**30:.2f} GiB = arguments "
          f"{mem['argument_bytes'] / 2**30:.2f} + the step's storages "
          f"{counted} B ({counted / 2**30:.2f} GiB), against the step's "
          f"rise of max_memory_allocated {card} | {smi}")
    del params, state
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def adam_slices_check(cfg, opt, run, batch, on_card, smi):
    """One Adam update of the LLM training run's state (its gradients at
    its params): updated in slices of ``optimizers.ADAM_CHUNK`` weights, as
    every step updates, against the same update with ``ADAM_CHUNK`` above
    the largest leaf, so that each leaf is one slice; every new param and
    moment bit for bit. On the card a leaf must be past ``ADAM_CHUNK``."""
    import torch

    from repro_torch.checkpoint import layout
    from repro_torch.optim import optimizers
    from repro_torch.train.steps import loss_and_grads

    _, _, grads = loss_and_grads(cfg, run["params"], batch)
    numels = [p.numel() for _, p in layout.flatten_with_paths(run["params"])]
    chunk = optimizers.ADAM_CHUNK
    sliced = opt.update(grads, run["opt"], run["params"], run["step"])
    optimizers.ADAM_CHUNK = max(numels) + 1
    try:
        whole = opt.update(grads, run["opt"], run["params"], run["step"])
    finally:
        optimizers.ADAM_CHUNK = chunk
    past = sum(n > chunk for n in numels)
    if on_card:
        check(past > 0, f"llm train Adam: no leaf past ADAM_CHUNK {chunk} "
              f"(largest {max(numels)})")
    check(same_tree({"p": sliced[0], "s": sliced[1]},
                    {"p": whole[0], "s": whole[1]}),
          "llm train Adam: the update in slices of ADAM_CHUNK differs from "
          "the update with every leaf in one slice")
    print(f"llm train Adam: {len(numels)} leaves, {past} past ADAM_CHUNK "
          f"{chunk} (largest {max(numels)} weights) updated in slices; new "
          f"params and moments bit for bit the update with every leaf in "
          f"one slice | {smi}")
    del grads, sliced, whole
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def qwen_train_path(tr, args, dev, on_card, smi, run_phase, phase_launches,
                    rt):
    """Phase 3, qwen2.5-3b's train step at full width and depth (36
    layers, bf16, its config as it stands: remat under ``"dots"``; the
    smoke config with remat on in the rehearsal): the sharded ZeRO-1 step
    (``make_train_step(cfg, adam, rt)``) on the one-rank world ``rt``, as
    the dry run counts it, ``tr["steps"]`` steps on one batch of
    ``lm_batches``. The loss finite and falling; K11 twice per layer a
    step, K13 and K12 once (:func:`train_launches`); ms per step after the
    first, tokens/s, TFLOP/s (:func:`train_step_flops`), peak allocation.
    Each step's rise of ``max_memory_allocated`` over ``memory_allocated``
    just before it must be within ``DRYRUN_PEAK_RTOL`` of
    ``dryrun_lib.measure``'s meta count of the same step at (1, 1) less its
    arguments (counted in :data:`DRYRUN_CHILD` after the card's steps).
    The count with ``remat=False`` is printed beside it, reckoned and not
    run, with both counts' peaks of the forward and backward alone."""
    import torch

    from repro_torch.configs import qwen25_3b
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import sharding
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import steps

    cfg = (qwen25_3b.smoke().replace(remat=True) if args.tiny
           else qwen25_3b.config())
    b, s = tr["batch"], tr["seq"]
    fields = ("chip_smoke_qwen_train", s, b, "train")
    start = (f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB" if on_card
             else "not measured (no card)")
    t0 = time.perf_counter()
    full = registry.init_params(cfg, args.seed, dev)
    specs = sharding.param_shardings(cfg, registry.param_axes(cfg), full,
                                     rt.mesh)
    params = sharding.local_tree(full, specs, rt)
    del full
    opt = make_optimizer("adam", lr=tr["lr"])
    state = steps.init_opt_state(cfg, opt, params, rt)
    step_fn = steps.make_train_step(cfg, opt, rt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        lm_batches(cfg.vocab_size, b, s, 1, seed=args.seed)).items()}
    print(f"qwen train: {cfg.arch_id} ({cfg.n_layers} of "
          f"{qwen25_3b.config().n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} G weights, {cfg.dtype}, remat "
          f"{cfg.remat} ({cfg.remat_policy}), ZeRO-1 Adam lr {tr['lr']} on "
          f"the 1 x 1 mesh) weights and state built in "
          f"{time.perf_counter() - t0:.1f} s; memory_allocated before them "
          f"{start}")
    want = train_launches(cfg)
    losses, secs, rises = [], [], []
    for i in range(tr["steps"]):
        if on_card:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        label = f"qwen train {cfg.arch_id} step {i} B={b} S={s}"
        t0 = time.perf_counter()
        params, state, _, m = run_phase(
            label, lambda: step_fn(params, state, i, batch))
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if on_card:
            rises.append((torch.cuda.max_memory_allocated(dev) - before,
                          torch.cuda.max_memory_allocated(dev)))
        counts = phase_launches[label]
        print(f"launches {label}: "
              + ", ".join(f"{k} {counts[k]}" for k in FLASH_KERNELS))
        if on_card:
            for name in FLASH_KERNELS:
                check(counts[name] == want[name],
                      f"{label}: {name} launched {counts[name]} times, want "
                      f"{want[name]} ({cfg.n_layers} layers, remat "
                      f"{cfg.remat})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"qwen train: losses {losses} not finite and falling")
    del params, state
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    remat, plain = dryrun_child(cfg.arch_id, fields, args.tiny, [
        {"remat": True, "remat_policy": cfg.remat_policy},
        {"remat": False}], alone=True)

    def counted(rec):  # (peak, arguments, the step's storages) in bytes
        mem = rec["report"]["memory_per_device"]
        return (int(mem["peak_bytes"]), int(mem["argument_bytes"]),
                int(mem["peak_bytes"] - mem["argument_bytes"]))

    peak, args_b, step_b = counted(remat)
    plain_peak, _, _ = counted(plain)
    check(remat["kernels"]["flash_attention"][0] == want["flash_attention"],
          f"qwen train: the meta count books K11 "
          f"{remat['kernels']['flash_attention'][0]} times, want "
          f"{want['flash_attention']}")
    ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    flops, attn = train_step_flops(cfg, b, s)
    if on_card:
        for i, (rise, _) in enumerate(rises[1:], 1):
            check(abs(rise - step_b) <= DRYRUN_PEAK_RTOL * step_b,
                  f"qwen train step {i}: the step added {rise} bytes to the "
                  f"allocator's peak, the meta count's peak less its "
                  f"arguments is {step_b} (rtol {DRYRUN_PEAK_RTOL})")
        total = torch.cuda.get_device_properties(dev).total_memory
        off = ", ".join(f"{100 * (r / step_b - 1):+.2f}%"
                        for r, _ in rises[1:])
        card = (f"{flops / ms / 1e9:.1f} TFLOP/s | peak allocated "
                f"{max(p for _, p in rises) / 2**30:.2f} GiB of the card's "
                f"{total / 2**30:.2f} GiB; each step's rise over "
                f"memory_allocated before it "
                f"{', '.join(f'{r / 2**30:.3f}' for r, _ in rises)} GiB "
                f"against the count's {step_b / 2**30:.3f} GiB "
                f"({off} after the first; rtol {DRYRUN_PEAK_RTOL})")
    else:
        card = "TFLOP/s and peak not measured (no card)"
    gb = 1e9
    print(f"qwen train: losses {', '.join(f'{x:.4f}' for x in losses)} | "
          f"{ms:.2f} ms per step after the first (first {1e3 * secs[0]:.2f} "
          f"ms) | {b * s / ms * 1e3:.0f} tokens/s | {card} | meta count at "
          f"(1, 1): peak {peak / gb:.2f} GB = arguments {args_b / gb:.2f} + "
          f"the step's {step_b / gb:.2f}, forward and backward alone "
          f"{(args_b + remat['grads_peak']) / gb:.2f} GB; remat=False "
          f"(reckoned, not run): peak {plain_peak / gb:.2f} GB, forward and "
          f"backward alone {(args_b + plain['grads_peak']) / gb:.2f} GB | "
          f"{smi}")


def spec_bytes(specs) -> int:
    """Bytes of the weights a spec tree describes (no memory allocated)."""
    import torch

    if hasattr(specs, "shape"):
        return math.prod(specs.shape) * torch.empty(
            (), dtype=specs.dtype).element_size()
    return sum(spec_bytes(v) for v in specs.values())


def llm_families_path(fam, args, dev, on_card, smi, run_phase,
                      phase_launches):
    """Phase 3, LLM families: ``LLMServer.generate`` on granite-8b, yi-6b,
    qwen2.5-3b and chameleon-34b (batched prefill, K11 once per layer) and on
    phi3.5-moe (the stepwise warm-up, K11 never), then ``transformer.
    prefill`` on phi's prompts (K11 once per layer); an f32 oracle per
    family; the int8 cache on qwen2.5-3b. One server at a time, each freed
    before the next. Phase 4's granite prefill and phi decode step run here,
    while their weights are on the card."""
    import torch

    from repro_torch.common import pspec
    from repro_torch.kernels import _build
    from repro_torch.models import moe, registry, transformer
    from repro_torch.serving.server import LLMServer
    from repro_torch.train.steps import make_serve_step

    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    b, n_new = fam["batch"], fam["gen"]  # b: granite, yi, qwen, chameleon, phi

    def free():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    free()  # phase 2's cached blocks back to the card before fits() reads it

    def tokens(cfg, shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    def fits(cfg, batch, length):
        """Fails unless the weights, the KV cache and
        :data:`FAMILY_MARGIN_BYTES` fit the card's free memory."""
        if not on_card:
            return
        free_bytes = torch.cuda.mem_get_info(dev)[0]
        need = (spec_bytes(registry.param_specs(cfg)) + 2 * cfg.n_layers
                * batch * length * cfg.n_kv_heads * cfg.resolved_head_dim * 2
                + FAMILY_MARGIN_BYTES)
        check(need <= free_bytes, f"{cfg.arch_id} at {cfg.n_layers} layers "
              f"needs {need} bytes, the card has {free_bytes} free")

    def build(arch, n_layers, p_len):
        full = registry.get_config(arch, smoke=args.tiny)
        n = n_layers or full.n_layers
        cfg = full.replace(n_layers=n)
        fits(cfg, b, p_len + n_new + 1)
        t0 = time.perf_counter()
        params = registry.init_params(cfg, args.seed, dev)
        ffn = (f"MoE {cfg.n_experts} experts of {cfg.d_ff_expert}, top-"
               f"{cfg.top_k}" if cfg.is_moe else f"d_ff {cfg.d_ff}")
        print(f"llm family {arch}: {n} of {full.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, vocab {cfg.padded_vocab}, {ffn}"
              f", qkv_bias {cfg.qkv_bias}, qk_norm {cfg.qk_norm}, tied "
              f"{cfg.tie_embeddings}; {spec_bytes(registry.param_specs(cfg))}"
              f" bytes of {cfg.param_dtype} weights made in "
              f"{time.perf_counter() - t0:.1f} s")
        return cfg, LLMServer(cfg, params, device=dev)

    def served(cfg, server, prompts, want_k11, what):
        """One warm-up generate, then one counted; the checks and timings."""
        t0 = time.perf_counter()
        first = server.generate(prompts, n_new)
        warm_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        b, p_len = prompts.shape
        kv = "" if cfg.kv_cache_dtype == "native" else " int8 cache"
        label = (f"llm {cfg.arch_id}{kv} generate B={b} P={p_len} "
                 f"new={n_new}")
        out = run_phase(label, lambda: server.generate(prompts, n_new))
        n_k11 = phase_launches[label]["flash_attention"]
        print(f"launches {label}: {phase_launches[label]}")
        if on_card:
            check(n_k11 == want_k11,
                  f"{label}: flash_attention launched {n_k11} times, want "
                  f"{want_k11} ({what})")
        check(out.shape == (b, n_new) and out.dtype == torch.int32
              and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
              f"{label}: tokens {tuple(out.shape)} {out.dtype} out of range")
        check(torch.equal(out, first), f"{label}: a second generate differs")
        pre_ms, dec_s = server.last_prefill_s * 1e3, server.last_decode_s
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if on_card else "not measured (no card)")
        rate = (", " + prefill_rate(cfg, b * p_len, server.last_prefill_s,
                                     on_card) if want_k11 else "")
        print(f"llm {cfg.arch_id}{kv} generate (K11: {what}): warm-up call "
              f"{warm_s:.2f} s | {'prefill' if want_k11 else 'stepwise warm-up'}"
              f" {pre_ms:.2f} ms ({b * p_len / pre_ms * 1e3:.0f} prompt "
              f"tokens/s{rate}) | decode {dec_s / n_new * 1e3:.3f} ms per "
              f"step ({b * n_new / dec_s:.0f} tokens/s) | peak allocated "
              f"{peak} | {smi}")
        return out

    def prefill_fn(cfg, params, prompts):
        def prefill():
            with torch.inference_mode():
                state = registry.init_decode_state(
                    cfg, prompts.shape[0], prompts.shape[1] + 1, device=dev)
                return transformer.prefill(cfg, params, prompts, state)
        return prefill

    # granite, yi, qwen, chameleon: batched prefill, K11 once per layer
    for arch in FAMILY_ARCHS[:-1]:
        cfg, server = build(arch, None, fam["prompt"])
        prompts = tokens(cfg, (b, fam["prompt"]))
        served(cfg, server, prompts, cfg.n_layers,
               "one per layer of the prefill, none in decode")
        if on_card and arch == "granite-8b":
            where_the_time_goes(
                f"LLM prefill ({arch}, B={b}, P={fam['prompt']})",
                prefill_fn(cfg, server.params, prompts), smi, top=8,
                share_of="flash_attention_kernel")
        del server
        free()

    # phi3.5-moe: the stepwise warm-up (K11 never), then transformer.prefill
    # on the same prompts (K11 once per layer)
    cfg, server = build(PHI, fam["phi_layers"], fam["phi_prompt"])
    prompts = tokens(cfg, (b, fam["phi_prompt"]))
    out = served(cfg, server, prompts, 0, "the stepwise warm-up: none")
    label = f"llm {PHI} transformer.prefill B={b} P={fam['phi_prompt']}"
    t0 = time.perf_counter()
    lg, state = run_phase(label, prefill_fn(cfg, server.params, prompts))
    pre_s = time.perf_counter() - t0
    n_k11 = phase_launches[label]["flash_attention"]
    print(f"launches {label}: {phase_launches[label]}")
    rate = prefill_rate(cfg, prompts.numel(), pre_s, on_card)
    print(f"llm {PHI} transformer.prefill: {pre_s * 1e3:.2f} ms (the first "
          f"call at its shapes), {rate} (N counts the top-{cfg.top_k} "
          f"experts; the dense combine runs all {cfg.n_experts}) | {smi}")
    if on_card:
        check(n_k11 == cfg.n_layers,
              f"{label}: flash_attention launched {n_k11} times, want one "
              f"per layer ({cfg.n_layers})")
    check(lg.shape == (b, cfg.padded_vocab) and bool(torch.isfinite(lg).all()),
          f"{label}: logits {tuple(lg.shape)} or not finite")
    same = int((torch.argmax(lg, -1).to(torch.int32) == out[:, 0]).sum())
    print(f"llm {PHI}: the batched prefill's first token equals the stepwise "
          f"warm-up's in {same} of {b} rows (bf16; not checked)")
    if on_card:
        serve_step = make_serve_step(cfg)
        tok = torch.argmax(lg, -1).to(torch.int32)

        def decode():
            with torch.inference_mode():
                return serve_step(server.params, state, tok)

        where_the_time_goes(
            f"LLM decode step ({PHI}, {cfg.n_layers} layers, B={b}, after "
            "the prefill)", decode, smi, top=8)
    del server, lg, state
    free()

    # the f32 oracles: the prefill through K11 against stepwise decode,
    # which never reaches K11, at full width and oracle_layers layers
    ob, op = fam["oracle"]
    for arch in FAMILY_ARCHS:
        full = registry.get_config(arch, smoke=args.tiny)
        cfg32 = full.replace(n_layers=fam["oracle_layers"], dtype="float32",
                             param_dtype="float32")
        p32 = registry.init_params(cfg32, args.seed, dev)
        toks = tokens(cfg32, (ob, op))
        # the routers' choices on both paths, seen through a wrapper
        routed = []
        router = moe._router

        def recording(*a):
            routed.append(router(*a))
            return routed[-1]

        moe._router = recording
        try:
            with torch.inference_mode():
                _build.reset_launches()
                lg_pre, st_pre = prefill_fn(cfg32, p32, toks)()
                n_pre = _build.launches["flash_attention"]
                st = registry.init_decode_state(cfg32, ob, op + 1, device=dev)
                for i in range(op):
                    lg_dec, st = registry.decode_step(cfg32, p32, st,
                                                      toks[:, i])
                n_dec = _build.launches["flash_attention"] - n_pre
        finally:
            moe._router = router
        if on_card:
            torch.cuda.synchronize()
            check(n_pre == cfg32.n_layers and n_dec == 0,
                  f"llm {arch} oracle: flash_attention launched {n_pre} "
                  f"times in the prefill (want {cfg32.n_layers}), {n_dec} in "
                  "stepwise decode")

        rels = {"logits": rel(lg_pre, lg_dec)}
        for name in ("k", "v"):
            rels[f"cache {name}"] = rel(st_pre["cache"][name][:, :, :op],
                                        st["cache"][name][:, :, :op])
        check(bool(torch.isfinite(lg_pre).all()) and lg_pre.shape ==
              (ob, cfg32.padded_vocab), f"llm {arch} oracle: prefill logits")
        note = ""
        if cfg32.is_moe:
            note = "; " + router_flips(cfg32, routed, ob, op)
        for name, r in rels.items():
            check(r < ORACLE_REL, f"llm {arch} oracle: prefill {name} vs "
                  f"{op} stepwise decode steps rel {r:.3e} >= {ORACLE_REL}"
                  + note)
        print(f"llm {arch} oracle (f32, {cfg32.n_layers} of {full.n_layers} "
              f"layers, B={ob}, P={op}): prefill through flash_attention vs "
              f"{op} decode steps without it: "
              + ", ".join(f"{k} rel {v:.3e}" for k, v in rels.items())
              + f" (bound {ORACLE_REL})" + note)
        del p32, st_pre, st, lg_pre, lg_dec
        free()

    # the int8 cache on qwen2.5-3b: generate by the stepwise warm-up (K11
    # never); its last logits against the native cache's, stepwise both
    full = registry.get_config("qwen2.5-3b", smoke=args.tiny)
    cfg = full.replace(n_layers=fam["oracle_layers"])
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    params = registry.init_params(cfg, args.seed, dev)
    ib, ip = fam["int8"]
    prompts = tokens(cfg, (ib, ip))
    print(f"llm family qwen2.5-3b int8 cache: {cfg.n_layers} of "
          f"{full.n_layers} layers, B={ib}, P={ip}")
    served(cfg8, LLMServer(cfg8, params, device=dev), prompts, 0,
           "the stepwise warm-up of the int8 cache: none")
    last = {}
    with torch.inference_mode():
        for c in (cfg, cfg8):
            state = registry.init_decode_state(c, ib, ip, device=dev)
            for i in range(ip):
                lg, state = registry.decode_step(c, params, state,
                                                 prompts[:, i])
            last[c.kv_cache_dtype] = lg.float()
            kinds = {state["cache"][n].dtype for n in ("k", "v")}
            check(kinds == {torch.int8 if c is cfg8 else
                            pspec.torch_dtype(c.dtype)},
                  f"llm qwen2.5-3b {c.kv_cache_dtype} cache holds {kinds}")
    r = float((last["int8"] - last["native"]).abs().max()) / (
        float(last["native"].abs().max()) + 1e-9)
    check(r < INT8_REL, f"llm qwen2.5-3b int8 cache: last logits rel {r:.3e} "
          f"of the native cache's >= {INT8_REL}")
    print(f"llm qwen2.5-3b int8 cache: k / v int8, last logits after {ip} "
          f"stepwise steps rel {r:.3e} of the native cache's (bound "
          f"{INT8_REL}); argmax equal in "
          f"{int((last['int8'].argmax(-1) == last['native'].argmax(-1)).sum())}"
          f" of {ib} rows")
    del params, last, state
    free()


def prefill_rate(cfg, n_tokens: int, seconds: float, on_card: bool) -> str:
    """A prefill's achieved bf16 rate on the card:
    ``counting.model_flops(cfg, tokens, "forward")`` (2 N D, N the active
    parameters) over its time."""
    from repro_torch.common import counting

    flops = counting.model_flops(cfg, n_tokens, "forward")
    rate = (f"{flops / seconds / 1e12:.1f} TFLOP/s" if on_card
            else "TFLOP/s not measured (no card)")
    return f"{rate} by model_flops ({flops:.4e} FLOP for {n_tokens} tokens)"


def encdec_prefill_flops(cfg, b: int, s: int) -> int:
    """The matmul and attention FLOPs ``encdec.prefill_cross`` does on (b,
    s) frames: each encoder layer's q / k / v / o projections, unmasked
    attention and ReLU FFN, then each decoder layer's cross k / v."""
    t, d, hd = b * s, cfg.d_model, cfg.resolved_head_dim
    qo, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    enc = (2 * t * d * (2 * qo + 2 * kv) + 4 * hd * cfg.n_heads * b * s * s
           + 2 * t * d * cfg.d_ff * 2)
    return cfg.n_enc_layers * enc + cfg.n_layers * 2 * t * d * 2 * kv


def seamless_path(fam, args, dev, on_card, smi, run_phase, phase_launches):
    """Phase 3, the encoder-decoder family: seamless-m4t-large-v2 at full
    width in bf16 (24 + 24 layers, uncut): ``encdec.prefill_cross`` on B x
    S_src stub frames (K11 once per encoder layer), greedy decode through
    ``make_serve_step`` (K11 once per decoder layer and step, Sq = 1), and
    a teacher-forced ``forward`` (K11 once per encoder layer and twice per
    decoder layer); phase 4's prefill_cross and decode step under the
    profiler. Then the f32 oracle at ``oracle_layers`` layers: decode after
    ``prefill_cross`` against the forward at every position, and the run
    through K11 against the same run with ``attention.flash_attention``'s
    kernel call swapped for its plain version."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import encdec, registry
    from repro_torch.train.steps import make_serve_step

    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    b, s_src, n_new, s_tgt = (fam[k] for k in ("batch", "src", "gen", "tgt"))
    cfg = registry.get_config(SEAMLESS, smoke=args.tiny)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, args.seed, dev)
    print(f"llm {SEAMLESS}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers (uncut), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff} ({cfg.act}), {cfg.norm}, vocab "
          f"{cfg.padded_vocab}, tied {cfg.tie_embeddings}; "
          f"{cfg.param_count()} parameters (param_count), "
          f"{spec_bytes(registry.param_specs(cfg))} bytes of "
          f"{cfg.param_dtype} weights made in "
          f"{time.perf_counter() - t0:.1f} s | {smi}")
    frames = torch.randn((b, s_src, cfg.d_model), generator=gen, device=dev)
    serve = make_serve_step(cfg)

    def prefill():
        with torch.inference_mode():
            state = registry.init_decode_state(cfg, b, n_new + 1,
                                               src_len=s_src, device=dev)
            return encdec.prefill_cross(cfg, params, state, frames)

    def decode(state):
        """n_new greedy steps from token 0 -> (tokens (B, n_new), state)."""
        tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        outs = []
        with torch.inference_mode():
            for _ in range(n_new):
                tok, state = serve(params, state, tok)
                outs.append(tok)
        return torch.stack(outs, 1), state

    first, _ = decode(prefill())  # first calls (cuBLAS' choices)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    def k11(label):
        return phase_launches[label]["flash_attention"]

    def clock(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    label_p = f"llm {SEAMLESS} prefill_cross B={b} S_src={s_src}"
    state, pre_s = clock(lambda: run_phase(label_p, prefill))
    label_d = f"llm {SEAMLESS} decode {n_new} steps B={b}"
    (out, _), dec_s = clock(lambda: run_phase(label_d, lambda: decode(state)))
    toks = torch.randint(0, cfg.vocab_size, (b, s_tgt), generator=gen,
                         device=dev, dtype=torch.int32)
    label_f = f"llm {SEAMLESS} forward B={b} S_src={s_src} S_tgt={s_tgt}"

    def forward():
        with torch.inference_mode():
            return registry.forward(cfg, params, {"frames": frames,
                                                  "tokens": toks})

    (lg, aux), fwd_s = clock(lambda: run_phase(label_f, forward))
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if on_card else "not measured (no card)")
    for label in (label_p, label_d, label_f):
        print(f"launches {label}: {phase_launches[label]} | {smi}")
    if on_card:
        want = {label_p: cfg.n_enc_layers, label_d: cfg.n_layers * n_new,
                label_f: cfg.n_enc_layers + 2 * cfg.n_layers}
        for label, n in want.items():
            check(k11(label) == n, f"{label}: flash_attention launched "
                  f"{k11(label)} times, want {n}")
    check(out.shape == (b, n_new) and out.dtype == torch.int32
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{label_d}: tokens {tuple(out.shape)} {out.dtype} out of range")
    check(torch.equal(out, first), f"{label_d}: differs from the warm-up's")
    check(lg.shape == (b, s_tgt, cfg.padded_vocab)
          and bool(torch.isfinite(lg).all()) and float(aux) == 0.0,
          f"{label_f}: logits {tuple(lg.shape)}, finite "
          f"{bool(torch.isfinite(lg).all())}, aux {float(aux)}")
    del lg
    enc_flops = encdec_prefill_flops(cfg, b, s_src)
    enc_rate = (f"{enc_flops / pre_s / 1e12:.1f} TFLOP/s" if on_card
                else "not measured")
    print(f"llm {SEAMLESS}: prefill_cross {pre_s * 1e3:.2f} ms ("
          f"{prefill_rate(cfg, b * s_src, pre_s, on_card)}, which counts "
          f"the decoder and the embeddings too; {enc_rate} over the "
          f"{enc_flops:.4e} FLOP prefill_cross does) | decode "
          f"{dec_s / n_new * 1e3:.3f} ms per step ({b * n_new / dec_s:.0f} "
          f"tokens/s) | forward S_tgt={s_tgt} {fwd_s * 1e3:.2f} ms (first "
          f"call at its shapes) | K11 {k11(label_p)} / "
          f"{k11(label_d)} / {k11(label_f)} | peak allocated {peak} | {smi}")
    if on_card:
        one = prefill()
        tok0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        where_the_time_goes(
            f"encdec prefill_cross ({SEAMLESS}, B={b}, S_src={s_src})",
            prefill, smi, top=8, share_of="flash_attention_kernel")

        def step():
            with torch.inference_mode():
                return serve(params, one, tok0)

        where_the_time_goes(
            f"encdec decode step ({SEAMLESS}, B={b}, after prefill_cross)",
            step, smi, top=8, share_of="flash_attention_kernel")
        del one
    del params, state, frames

    # the f32 oracle: the kernel run (K11 throughout) against itself
    # (decode vs forward) and against the plain run
    ob, os_, ot = fam["oracle"]
    n = fam["oracle_layers"]
    cfg32 = cfg.replace(n_layers=n, n_enc_layers=n, dtype="float32",
                        param_dtype="float32")
    p32 = registry.init_params(cfg32, args.seed, dev)
    fr = torch.randn((ob, os_, cfg.d_model), generator=gen, device=dev)
    tk = torch.randint(0, cfg.vocab_size, (ob, ot), generator=gen,
                       device=dev, dtype=torch.int32)

    def oracle_run():
        """(forward logits, stepwise decode logits), each (ob, ot, V), and
        the K11 launches of the run."""
        _build.reset_launches()
        with torch.inference_mode():
            full, _ = registry.forward(cfg32, p32, {"frames": fr,
                                                    "tokens": tk})
            st = registry.init_decode_state(cfg32, ob, ot, src_len=os_,
                                            device=dev)
            st = encdec.prefill_cross(cfg32, p32, st, fr)
            outs = []
            for i in range(ot):
                lg_i, st = registry.decode_step(cfg32, p32, st, tk[:, i])
                outs.append(lg_i)
        if on_card:
            torch.cuda.synchronize()
        return full, torch.stack(outs, 1), _build.launches["flash_attention"]

    kern_full, kern_dec, n_kern = oracle_run()
    kernel_call = fa_ops.flash_attention

    def plain(q, k, v, *, causal=True, window=0):
        return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)

    fa_ops.flash_attention = plain
    try:
        plain_full, plain_dec, n_plain = oracle_run()
    finally:
        fa_ops.flash_attention = kernel_call
    if on_card:
        want = 3 * n + n + n * ot  # forward, prefill_cross, decode steps
        check(n_kern == want and n_plain == 0,
              f"{SEAMLESS} oracle: flash_attention launched {n_kern} times "
              f"through the kernels (want {want}), {n_plain} in the plain run")

    rels = {"kernels: decode vs forward": rel(kern_dec, kern_full),
            "plain: decode vs forward": rel(plain_dec, plain_full),
            "forward: kernels vs plain": rel(kern_full, plain_full),
            "decode: kernels vs plain": rel(kern_dec, plain_dec)}
    check(bool(torch.isfinite(kern_full).all()) and kern_full.shape ==
          (ob, ot, cfg32.padded_vocab), f"{SEAMLESS} oracle: forward logits")
    for name, r in rels.items():
        check(r < ORACLE_REL, f"{SEAMLESS} oracle: {name} rel {r:.3e} >= "
              f"{ORACLE_REL}")
    print(f"llm {SEAMLESS} oracle (f32, {n} + {n} of {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, B={ob}, S_src={os_}, S_tgt={ot}; K11 "
          f"{n_kern} launches through the kernels): "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in rels.items())
          + f" (bound {ORACLE_REL}) | {smi}")
    del p32
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def ssm_path(fam, args, dev, on_card, smi, run_phase, phase_launches):
    """Phase 3, the SSM and hybrid families: mamba2-130m and zamba2-7b at
    full width in bf16, uncut, one at a time, each freed before the next:
    ``registry.forward`` on B x S tokens (zamba2: K11 once per super-block,
    each launch at (B, S, 32, 112) causal; mamba2: never), then
    ``LLMServer.generate`` (the stepwise warm-up, K11 never); one forward
    and one decode step under the profiler. Then the f32 oracle of each at
    reduced depth and full width: decode against the forward at every
    position (:data:`DECODE_REL`), and the run through K11 against the same
    run with ``attention.flash_attention``'s kernel call swapped for its
    plain version (:data:`ORACLE_REL`)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import hybrid, registry
    from repro_torch.serving.server import LLMServer

    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    b, s, p_len, n_new = (fam[k] for k in ("batch", "seq", "prompt", "gen"))

    def free():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def tokens(cfg, shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    def n_k11(cfg):
        """K11 launches of one forward: one per super-block's shared block."""
        return hybrid._n_super(cfg) if cfg.family == "hybrid" else 0

    def fits(cfg):
        """Fails unless the weights, the SSD scan's four (B, S, H, chunk)
        f32 blocks and :data:`FAMILY_MARGIN_BYTES` fit the free memory."""
        if not on_card:
            return
        q = min(cfg.ssm_chunk, s)
        ssd = 4 * 4 * b * (-(-s // q) * q) * q * cfg.n_ssm_heads
        need = spec_bytes(registry.param_specs(cfg)) + ssd + FAMILY_MARGIN_BYTES
        free_bytes = torch.cuda.mem_get_info(dev)[0]
        check(need <= free_bytes, f"{cfg.arch_id} needs {need} bytes, the "
              f"card has {free_bytes} free")

    kernel_call = fa_ops.flash_attention
    for arch in SSM_ARCHS:
        free()
        cfg = registry.get_config(arch, smoke=args.tiny)
        fits(cfg)
        t0 = time.perf_counter()
        params = registry.init_params(cfg, args.seed, dev)
        if on_card:
            torch.cuda.synchronize()
        attn = (f"; the shared block every {cfg.attn_period} positions "
                f"({hybrid._n_super(cfg)} uses, LoRA rank {cfg.lora_rank}), "
                f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
                if cfg.family == "hybrid" else "; no attention")
        print(f"llm {arch}: {cfg.n_layers} layers (uncut), d_model "
              f"{cfg.d_model}, {cfg.n_ssm_heads} SSD heads of "
              f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
              f"{cfg.ssm_chunk}{attn}, vocab {cfg.padded_vocab}; "
              f"{cfg.param_count()} parameters (param_count), "
              f"{spec_bytes(registry.param_specs(cfg))} bytes of "
              f"{cfg.param_dtype} weights made in "
              f"{time.perf_counter() - t0:.1f} s | {smi}")
        toks = tokens(cfg, (b, s))

        def forward():
            with torch.inference_mode():
                return registry.forward(cfg, params, {"tokens": toks})

        forward()  # first call (cuBLAS' choices)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        seen = []

        def recording(q, k, v, **kw):
            seen.append((tuple(q.shape), tuple(k.shape), kw.get("causal"),
                         kw.get("window")))
            return kernel_call(q, k, v, **kw)

        label_f = f"llm {arch} forward B={b} S={s}"
        fa_ops.flash_attention = recording
        try:
            t0 = time.perf_counter()
            lg, aux = run_phase(label_f, forward)
            fwd_s = time.perf_counter() - t0
        finally:
            fa_ops.flash_attention = kernel_call
        check(lg.shape == (b, s, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()) and float(aux) == 0.0,
              f"{label_f}: logits {tuple(lg.shape)}, finite "
              f"{bool(torch.isfinite(lg).all())}, aux {float(aux)}")
        del lg
        hd = cfg.resolved_head_dim if cfg.n_heads else 0
        want_call = ((b, s, cfg.n_heads, hd), (b, s, cfg.n_kv_heads, hd),
                     True, cfg.sliding_window)
        check(len(seen) == n_k11(cfg) and all(c == want_call for c in seen),
              f"{label_f}: flash_attention called {len(seen)} times "
              f"(want {n_k11(cfg)}, each {want_call}): {seen[:2]}")
        fwd_peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                    if on_card else "not measured (no card)")

        server = LLMServer(cfg, params, device=dev)
        prompts = tokens(cfg, (b, p_len))
        first = server.generate(prompts, n_new)  # warm-up
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        label_g = f"llm {arch} generate B={b} P={p_len} new={n_new}"
        out = run_phase(label_g, lambda: server.generate(prompts, n_new))
        gen_peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                    if on_card else "not measured (no card)")
        check(out.shape == (b, n_new) and out.dtype == torch.int32
              and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
              f"{label_g}: tokens {tuple(out.shape)} {out.dtype} out of range")
        check(torch.equal(out, first), f"{label_g}: differs from the "
              "warm-up's")
        if on_card:
            for label, n in ((label_f, n_k11(cfg)), (label_g, 0)):
                got = phase_launches[label]["flash_attention"]
                check(got == n, f"{label}: flash_attention launched {got} "
                      f"times, want {n}")
        for label in (label_f, label_g):
            print(f"launches {label}: {phase_launches[label]} | {smi}")
        warm, dec = server.last_prefill_s, server.last_decode_s
        print(f"llm {arch}: forward of {b} x {s} tokens {fwd_s * 1e3:.2f} ms "
              f"({prefill_rate(cfg, b * s, fwd_s, on_card)}), peak allocated "
              f"{fwd_peak} | generate: stepwise warm-up {warm * 1e3:.2f} ms "
              f"({warm / p_len * 1e3:.3f} ms a prompt token), decode "
              f"{dec / n_new * 1e3:.3f} ms per step ({b * n_new / dec:.0f} "
              f"tokens/s), peak allocated {gen_peak} | K11 "
              f"{phase_launches[label_f]['flash_attention']} / "
              f"{phase_launches[label_g]['flash_attention']} | {smi}")
        if on_card:
            where_the_time_goes(f"{cfg.family} forward ({arch}, B={b}, S={s})",
                                forward, smi, top=8,
                                share_of="flash_attention_kernel")
            state = registry.init_decode_state(cfg, b, 2, device=dev)
            tok0 = torch.zeros((b,), dtype=torch.int32, device=dev)

            def step():
                with torch.inference_mode():
                    return registry.decode_step(cfg, params, state, tok0)

            step()
            where_the_time_goes(f"{cfg.family} decode step ({arch}, B={b})",
                                step, smi, top=8)
            del state
        del params, server

    # the f32 oracle at reduced depth and full width
    ob, os_ = fam["oracle"]
    for arch in SSM_ARCHS:
        free()
        full = registry.get_config(arch, smoke=args.tiny)
        n = full.attn_period + 1 if full.family == "hybrid" else 2
        cfg32 = full.replace(n_layers=n, dtype="float32",
                             param_dtype="float32")
        p32 = registry.init_params(cfg32, args.seed, dev)
        tk = tokens(cfg32, (ob, os_))

        def oracle_run():
            """(forward logits, stepwise decode logits), each (ob, os_, V),
            and the K11 launches of the run."""
            _build.reset_launches()
            with torch.inference_mode():
                full_lg, _ = registry.forward(cfg32, p32, {"tokens": tk})
                st = registry.init_decode_state(cfg32, ob, os_, device=dev)
                outs = []
                for i in range(os_):
                    lg_i, st = registry.decode_step(cfg32, p32, st, tk[:, i])
                    outs.append(lg_i)
            if on_card:
                torch.cuda.synchronize()
            return (full_lg, torch.stack(outs, 1),
                    _build.launches["flash_attention"])

        kern_full, kern_dec, n_kern = oracle_run()

        def plain(q, k, v, *, causal=True, window=0):
            return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                              window=window)

        fa_ops.flash_attention = plain
        try:
            plain_full, plain_dec, n_plain = oracle_run()
        finally:
            fa_ops.flash_attention = kernel_call
        if on_card:
            check(n_kern == n_k11(cfg32) and n_plain == 0,
                  f"{arch} oracle: flash_attention launched {n_kern} times "
                  f"through the kernels (want {n_k11(cfg32)}), {n_plain} in "
                  "the plain run")
        check(bool(torch.isfinite(kern_full).all()) and kern_full.shape ==
              (ob, os_, cfg32.padded_vocab), f"{arch} oracle: forward logits")
        rels = {"kernels: decode vs forward": (rel(kern_dec, kern_full),
                                               DECODE_REL),
                "plain: decode vs forward": (rel(plain_dec, plain_full),
                                             DECODE_REL),
                "forward: kernels vs plain": (rel(kern_full, plain_full),
                                              ORACLE_REL),
                "decode: kernels vs plain": (rel(kern_dec, plain_dec),
                                             ORACLE_REL)}
        for name, (r, bound_) in rels.items():
            check(r < bound_, f"{arch} oracle: {name} rel {r:.3e} >= "
                  f"{bound_}")
        print(f"llm {arch} oracle (f32, {n} of {full.n_layers} layers, "
              f"B={ob}, S={os_}, chunk {cfg32.ssm_chunk}; K11 {n_kern} "
              "launches through the kernels): "
              + ", ".join(f"{k} rel {r:.3e} (bound {bd})"
                          for k, (r, bd) in rels.items()) + f" | {smi}")
        del p32
    free()


def mla_path(fam, args, dev, on_card, smi, run_phase, phase_launches):
    """Phase 3, deepseek-v2-236b (MLA and the shared experts) at full width
    in bf16, as deep as the card's free memory holds beside the forward's
    transient (measured on one layer; printed as "n of 60 layers"):
    ``registry.forward`` on B x S tokens (K11 exactly once per layer, each
    at (B, S, 128, 128, 192 / 128) causal, v unpadded), then
    ``LLMServer.generate`` (the stepwise warm-up and the absorbed decode,
    K11 never); one forward and one decode step under the profiler. Then
    the f32 oracle at full width and :data:`MLA_ORACLE_LAYERS` layer, the
    bf16 weights freed first: the absorbed decode against the expanded
    forward at every position (:data:`DECODE_REL`), and the forward through
    K11 against the same forward with ``attention.flash_attention``'s
    kernel call swapped for its plain version (:data:`ORACLE_REL`); the
    routers' choices on the two paths are watched as phi's are."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import moe, registry
    from repro_torch.serving.server import LLMServer

    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    b, s, p_len, n_new = (fam[k] for k in ("batch", "seq", "prompt", "gen"))

    def free():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def tokens(cfg, shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    def cache_bytes(cfg, batch, length):
        """MLA's latent cache: ``ckv`` and the rope key per layer and
        position (not ``n_kv_heads * head_dim``)."""
        return (cfg.n_layers * batch * length
                * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                * torch.empty((), dtype=getattr(torch, cfg.dtype)
                              ).element_size())

    def fits(cfg, transient):
        """Fails unless the weights, the latent cache, ``transient`` (the
        forward's, with the allocator's room around it) and
        :data:`FAMILY_MARGIN_BYTES` fit the free memory."""
        if not on_card:
            return
        need = (spec_bytes(registry.param_specs(cfg)) + transient
                + cache_bytes(cfg, b, p_len + n_new + 1) + FAMILY_MARGIN_BYTES)
        free_bytes = torch.cuda.mem_get_info(dev)[0]
        check(need <= free_bytes, f"{cfg.arch_id} at {cfg.n_layers} layers "
              f"needs {need} bytes, the card has {free_bytes} free")

    free()
    full = registry.get_config(DEEPSEEK, smoke=args.tiny)
    kernel_call = fa_ops.flash_attention
    n, transient = full.n_layers, 0
    if on_card:
        # the forward's transient on one layer (moe_dense's every-expert
        # blocks: y_all alone is E x B·S x d_model; the logits), then as
        # many layers as the free memory holds beside it, the transient
        # counted twice: the caching allocator strands about as much again
        # in segments that the weights' stacks share with freed draws (on
        # an H100 at 8 layers: 8.0 GiB reserved but unallocated beside 4.7
        # GiB free when the forward asked for one 6.25 GiB block)
        cfg1 = full.replace(n_layers=1)
        p1 = registry.init_params(cfg1, args.seed, dev)
        t1 = tokens(cfg1, (b, s))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            registry.forward(cfg1, p1, {"tokens": t1})
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated(dev) - base
        del p1, t1
        free()
        one = spec_bytes(registry.param_specs(cfg1))
        layer = spec_bytes(registry.param_specs(full.replace(n_layers=2))) - one
        per_layer = layer + cache_bytes(cfg1, b, p_len + n_new + 1)
        room = (torch.cuda.mem_get_info(dev)[0] - (one - layer)
                - 2 * transient - FAMILY_MARGIN_BYTES)
        n = min(full.n_layers, room // per_layer)
        check(n >= 1, f"{DEEPSEEK}: one layer ({per_layer} bytes) does not "
              f"fit beside the forward's transient of {transient} bytes")
        print(f"llm {DEEPSEEK}: one layer {layer} bytes of bf16 weights, "
              f"the embeddings and final norm {one - layer}; the forward's "
              f"transient at B={b}, S={s} {transient} bytes (measured on one "
              f"layer, counted twice); {n} layers fit | {smi}")
    cfg = full.replace(n_layers=int(n))
    fits(cfg, 2 * transient)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, args.seed, dev)
    free()  # the per-layer f32 draws' blocks back to the card
    qk, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    print(f"llm {DEEPSEEK}: {cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, MLA {cfg.n_heads} heads, qk / v head dims {qk} / "
          f"{vd}, q / kv latent ranks {cfg.q_lora_rank} / "
          f"{cfg.kv_lora_rank}; MoE {cfg.n_experts} experts of "
          f"{cfg.d_ff_expert}, top-{cfg.top_k}, {cfg.n_shared_experts} "
          f"shared; vocab {cfg.padded_vocab}; {cfg.param_count()} parameters "
          f"(param_count; {full.param_count()} at {full.n_layers} layers), "
          f"{spec_bytes(registry.param_specs(cfg))} bytes of "
          f"{cfg.param_dtype} weights made in {time.perf_counter() - t0:.1f} s"
          f" | {smi}")
    toks = tokens(cfg, (b, s))

    def forward():
        with torch.inference_mode():
            return registry.forward(cfg, params, {"tokens": toks})

    forward()  # first call (cuBLAS' choices)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    seen = []

    def recording(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw.get("causal"), kw.get("window")))
        return kernel_call(q, k, v, **kw)

    label_f = f"llm {DEEPSEEK} forward B={b} S={s}"
    fa_ops.flash_attention = recording
    try:
        t0 = time.perf_counter()
        lg, aux = run_phase(label_f, forward)
        fwd_s = time.perf_counter() - t0
    finally:
        fa_ops.flash_attention = kernel_call
    check(lg.shape == (b, s, cfg.padded_vocab)
          and bool(torch.isfinite(lg).all()) and bool(torch.isfinite(aux))
          and float(aux) > 0,
          f"{label_f}: logits {tuple(lg.shape)}, finite "
          f"{bool(torch.isfinite(lg).all())}, aux {float(aux)}")
    del lg
    h = cfg.n_heads
    want_call = ((b, s, h, qk), (b, s, h, qk), (b, s, h, vd), True, 0)
    check(len(seen) == cfg.n_layers and all(c == want_call for c in seen),
          f"{label_f}: flash_attention called {len(seen)} times (want "
          f"{cfg.n_layers}, each {want_call}): {seen[:2]}")
    fwd_peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if on_card else "not measured (no card)")
    # one more call: at this depth the counted one may also pay the caching
    # allocator's release and re-allocation of blocks
    t0 = time.perf_counter()
    forward()
    if on_card:
        torch.cuda.synchronize()
    fwd2_s = time.perf_counter() - t0

    server = LLMServer(cfg, params, device=dev)
    prompts = tokens(cfg, (b, p_len))
    first = server.generate(prompts, n_new)  # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    label_g = f"llm {DEEPSEEK} generate B={b} P={p_len} new={n_new}"
    out = run_phase(label_g, lambda: server.generate(prompts, n_new))
    gen_peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if on_card else "not measured (no card)")
    check(out.shape == (b, n_new) and out.dtype == torch.int32
          and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{label_g}: tokens {tuple(out.shape)} {out.dtype} out of range")
    check(torch.equal(out, first), f"{label_g}: differs from the warm-up's")
    if on_card:
        for label, want in ((label_f, cfg.n_layers), (label_g, 0)):
            got = phase_launches[label]["flash_attention"]
            check(got == want, f"{label}: flash_attention launched {got} "
                  f"times, want {want}")
    for label in (label_f, label_g):
        print(f"launches {label}: {phase_launches[label]} | {smi}")
    warm, dec = server.last_prefill_s, server.last_decode_s
    print(f"llm {DEEPSEEK} ({cfg.n_layers} of {full.n_layers} layers): "
          f"forward of {b} x {s} tokens {fwd_s * 1e3:.2f} ms the counted "
          f"call, {fwd2_s * 1e3:.2f} ms the next "
          f"({prefill_rate(cfg, b * s, fwd2_s, on_card)}; N counts the "
          f"top-{cfg.top_k} and {cfg.n_shared_experts} shared experts, the "
          f"dense combine runs all {cfg.n_experts}), peak allocated "
          f"{fwd_peak} | generate: stepwise warm-up {warm * 1e3:.2f} ms "
          f"({warm / p_len * 1e3:.3f} ms a prompt token), decode "
          f"{dec / n_new * 1e3:.3f} ms per step ({b * n_new / dec:.0f} "
          f"tokens/s), peak allocated {gen_peak} | K11 "
          f"{phase_launches[label_f]['flash_attention']} / "
          f"{phase_launches[label_g]['flash_attention']} | {smi}")
    if on_card:
        where_the_time_goes(f"moe forward ({DEEPSEEK}, {cfg.n_layers} layers,"
                            f" B={b}, S={s})", forward, smi, top=8,
                            share_of="flash_attention_kernel")
        state = registry.init_decode_state(cfg, b, 2, device=dev)
        tok0 = torch.zeros((b,), dtype=torch.int32, device=dev)

        def step():
            with torch.inference_mode():
                return registry.decode_step(cfg, params, state, tok0)

        step()
        where_the_time_goes(f"moe decode step ({DEEPSEEK}, {cfg.n_layers} "
                            f"layers, B={b}, absorbed MLA)", step, smi, top=8)
        del state
    del params, server
    free()

    # the f32 oracle at full width and MLA_ORACLE_LAYERS layers
    ob, os_ = fam["oracle"]
    cfg32 = full.replace(n_layers=MLA_ORACLE_LAYERS, dtype="float32",
                         param_dtype="float32")
    p32 = registry.init_params(cfg32, args.seed, dev)
    tk = tokens(cfg32, (ob, os_))
    routed = []
    router = moe._router

    def recording_router(*a):
        routed.append(router(*a))
        return routed[-1]

    moe._router = recording_router
    try:
        with torch.inference_mode():
            _build.reset_launches()
            kern_full, _ = registry.forward(cfg32, p32, {"tokens": tk})
            n_kern = _build.launches["flash_attention"]
            st = registry.init_decode_state(cfg32, ob, os_, device=dev)
            outs = []
            for i in range(os_):
                lg_i, st = registry.decode_step(cfg32, p32, st, tk[:, i])
                outs.append(lg_i)
            kern_dec = torch.stack(outs, 1)
            n_dec = _build.launches["flash_attention"] - n_kern
    finally:
        moe._router = router

    def plain(q, k, v, *, causal=True, window=0):
        return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)

    fa_ops.flash_attention = plain
    try:
        with torch.inference_mode():
            _build.reset_launches()
            plain_full, _ = registry.forward(cfg32, p32, {"tokens": tk})
            n_plain = _build.launches["flash_attention"]
    finally:
        fa_ops.flash_attention = kernel_call
    if on_card:
        torch.cuda.synchronize()
        check(n_kern == cfg32.n_layers and n_dec == 0 and n_plain == 0,
              f"{DEEPSEEK} oracle: flash_attention launched {n_kern} times "
              f"in the forward (want {cfg32.n_layers}), {n_dec} in decode, "
              f"{n_plain} in the plain run")
    check(bool(torch.isfinite(kern_full).all()) and kern_full.shape ==
          (ob, os_, cfg32.padded_vocab), f"{DEEPSEEK} oracle: forward logits")
    note = router_flips(cfg32, routed, ob, os_)
    rels = {"absorbed decode vs expanded forward": (rel(kern_dec, kern_full),
                                                    DECODE_REL),
            "forward: K11 vs plain flash": (rel(kern_full, plain_full),
                                            ORACLE_REL)}
    for name, (r, bound_) in rels.items():
        check(r < bound_, f"{DEEPSEEK} oracle: {name} rel {r:.3e} >= "
              f"{bound_}; {note}")
    print(f"llm {DEEPSEEK} oracle (f32, {cfg32.n_layers} of {full.n_layers} "
          f"layers, B={ob}, S={os_}; K11 {n_kern} launches in the forward, "
          f"{n_dec} in decode): "
          + ", ".join(f"{k} rel {r:.3e} (bound {bd})"
                      for k, (r, bd) in rels.items()) + f"; {note} | {smi}")
    del p32, st, kern_full, kern_dec, plain_full
    free()


def dcnv2_path(cfg, args, dev, on_card, smi, run_phase):
    """Phase 3, DCNv2 (paper §2.2) at the main path's config: its forward
    on the card against the CPU's on the same weights, then
    ``test_dcnv2_trains``' SGD run (DCN_STEPS microbatches of TRAIN_BATCH
    from ``CTRStream(seed=DCN_SEED)``, lr DCN_LR) on the card, after two
    warm-up steps on a copy of the weights; the loss must fall."""
    import numpy as np
    import torch

    from repro_torch.core import dcnv2
    from repro_torch.data.synthetic import CTRStream

    params = dcnv2.init_params(cfg, args.seed, dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in CTRStream(cfg, seed=DCN_SEED).batches(TRAIN_BATCH,
                                                              DCN_STEPS)]
    with torch.no_grad():
        got = dcnv2.forward(cfg, params, batches[0]["idx"],
                            batches[0]["val"]).cpu()
        want = dcnv2.forward(cfg, {k: v.cpu() for k, v in params.items()},
                             batches[0]["idx"].cpu(), batches[0]["val"].cpu())
    err = float((got - want).abs().max())
    check(got.shape == (TRAIN_BATCH,) and bool(torch.allclose(
        got, want, rtol=DCN_TOL, atol=DCN_TOL * float(want.abs().max()))),
        f"dcnv2: forward on {dev} vs the CPU max abs err {err:.3e}")

    def train(p, steps):
        for v in p.values():
            v.requires_grad_(True)
        losses = []
        for b in batches[:steps]:
            loss = dcnv2.loss_fn(cfg, p, b)
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                for v, g in zip(p.values(), grads):
                    v -= DCN_LR * g
            losses.append(loss.detach())
        return torch.stack(losses).cpu().numpy()

    train({k: v.clone() for k, v in params.items()}, 2)  # first calls
    t0 = time.perf_counter()
    losses = run_phase(f"dcnv2 train {DCN_STEPS} x {TRAIN_BATCH}",
                       lambda: train(params, DCN_STEPS))
    dt = time.perf_counter() - t0
    check(bool(np.isfinite(losses).all())
          and losses[-5:].mean() < losses[:5].mean(),
          f"dcnv2: the loss did not fall: {losses}")
    print(f"dcnv2 (F={cfg.n_fields}, V={cfg.hash_space}, d0="
          f"{cfg.n_fields * dcnv2.K_DENSE}, 3 cross layers, MLP (64, 32)): "
          f"forward on {dev} vs the CPU max abs err {err:.3e} (rtol and atol "
          f"{DCN_TOL} of max |logit|) | {DCN_STEPS} SGD steps of "
          f"{TRAIN_BATCH} at lr {DCN_LR}: loss {losses[:5].mean():.4f} -> "
          f"{losses[-5:].mean():.4f} (means of the first and last five), "
          f"{DCN_STEPS * TRAIN_BATCH / dt:.0f} examples/s | {smi}")


def router_flips(cfg, routed, ob, op) -> str:
    """The oracle's two paths' router choices: ``routed`` holds the
    prefill's (ids, probs) per layer, then the decode's per step and layer.
    Fails on a token whose chosen experts differ where the k-th and (k+1)-th
    probability stand more than ROUTER_TIE apart; returns a summary."""
    import torch

    n = cfg.n_layers
    pre, dec = routed[:n], routed[n:]
    check(len(dec) == op * n, f"router calls: {len(routed)}")
    flips = near = 0
    min_gap = float("inf")
    for layer in range(n):
        _, ids_p, probs_p = pre[layer]
        ids_d = torch.stack([dec[i * n + layer][1] for i in range(op)], 1)
        probs_d = torch.stack([dec[i * n + layer][2] for i in range(op)], 1)
        ids_p = ids_p.reshape(ob, op, -1)
        probs_p = probs_p.reshape(ob, op, -1)
        gaps = []
        for probs in (probs_p, probs_d):
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            gaps.append(top[..., cfg.top_k - 1] - top[..., cfg.top_k])
        gap = torch.minimum(*gaps)
        min_gap = min(min_gap, float(gap.min()))
        diff = (torch.sort(ids_p, -1).values
                != torch.sort(ids_d, -1).values).any(-1)
        flips += int(diff.sum())
        near += int((diff & (gap <= ROUTER_TIE)).sum())
        wide = diff & (gap > ROUTER_TIE)
        check(not bool(wide.any()),
              f"router: {int(wide.sum())} tokens of layer {layer} chose "
              f"other experts with the top-{cfg.top_k} gap above {ROUTER_TIE}")
    return (f"router: smallest gap between the k-th and (k+1)-th "
            f"probability (k = {cfg.top_k}) {min_gap:.3e} over {ob * op} "
            f"tokens x {n} layers; {flips} tokens chose other experts in the "
            f"two paths ({near} of them near ties, gap <= {ROUTER_TIE})")


if __name__ == "__main__":
    sys.exit(main())
