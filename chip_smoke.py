#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build  -- compile every CUDA kernel of the serving and training
   paths from paddle_tpu_torch/csrc (one nvcc per source, all at once).
2. kernels -- hold each kernel against its plain PyTorch version on the
   card, case by case, and time both (CUDA events around device work
   only, L2 flushed before every call, as a serving step finds it
   cold), beside the least time the card could take (`bound_ms`) and,
   for flash attention,
   `torch.nn.functional.scaled_dot_product_attention` as a yardstick.
   A: flash attention forward; B and C: the ragged walk over float
   arenas (B) and over int8 (s8, scale) arenas, dequant fused (C), both
   split over pages across blocks (the plan, `walk_plan`: splits, keys
   per split and blocks, and the device launches per call -- the walk,
   and the combine of the splits' partials where there are several,
   which must be 1 or 2 -- are printed per case; each case must repeat
   its output bit for bit on a second call; B's and C's cases add rows
   that reach max_len (pos0 = 255) and inactive rows whose mean of V
   spans every split). The build's step prints each walk
   instantiation's shared memory, registers, spills and blocks resident
   per SM, which must let 2 x SMs blocks of the plan be resident.
   Tolerances: float32 1e-4, bfloat16 2e-2, on outputs of unit scale.
   A runs its products on the tensor cores (bf16 mma.sync; f32 as
   3xTF32): the count of HMMA instructions in each flash_fwd_kernel
   instantiation, read from `cuobjdump --dump-sass` of the built library,
   must be above 0. A's cases: the main prefill, key_lens, causal T=2048,
   a sliding window, head_dim 128 and rows with no valid key, in f32 and
   bf16; a window of 128 keys with key_lens in [1, 128) at T=256 (the
   ring pool's prefill), f32 and bf16; causal T=8192, B=4, H=8 in bf16 and f32, and in a window of
   1024 keys in f32 and bf16 beside SDPA with a boolean band mask, whose
   output must agree with A's at the dtype's tolerance
   (bench_transformer_lm's shape; the LM train phase feeds it f32, its f32 biases promoting the
   activations; held against the plain version one batch row at a time:
   its scores take 2 GB a row; the bf16 output's tolerance holds each
   row's max abs error over that row's max |plain|, since a long row's
   |o| falls to bf16's absolute tolerance, the f32 one its max abs
   error); and f32 scores of std 3 (q scaled by 3)
   at f32's tolerance. A's f32 bound counts its products at the 3xTF32
   rate (495 / 3 TFLOP/s); the time loops' f32 bounds at the CUDA
   cores' 67 TFLOP/s.
   D and E: the fused LSTM time loop, forward and backward, at
   bench_lstm's shape (T=100, B=64, H=512) with full, ragged ([50, 100])
   and reversed ragged lengths and nonzero h0/c0, at H=256 B=128 and
   H=1280 B=64, and with bf16 x_proj and w_hh; E gets random
   cotangents. D runs on the forward loop of time_loop.cuh (a memset of
   its barrier counters and one cooperative launch: 2 device operations
   per call, printed with its us per step) and must repeat hs and cs
   bit for bit. Error: max abs error over max |plain| (dW sums T*B
   terms), same tolerances. cuDNN's torch.nn.LSTM is the yardstick,
   its input projection timed beside it. E runs in three phases (the
   gates of every step as one tiled product; the serial loop, one
   cooperative launch over row groups x unit groups with only the
   carry's product in it; dW_hh as a split tiled product summed in a
   fixed order): every E case must repeat all its outputs bit for bit
   on a second call, and at the main shape the device time of each
   phase is printed (CUDA events the wrapper records between its
   launches).
   F and G: the fused GRU time loop (csrc/fused_gru.cu; F on the
   forward loop of time_loop.cuh, a memset of its barrier counters and
   one cooperative launch, repeating hs bit for bit), forward and
   backward, at the seq2seq encoder's shape (T=30, B=64, H=512) with
   full, ragged ([15, 30]) and reversed ragged lengths, nonzero h0, and
   bf16 x_proj and w_hh; H and I: the fused tanh-RNN time loop
   (csrc/fused_rnn.cu; H on the same forward loop with a one-gate cell,
   a memset and one cooperative launch, repeating hs bit for bit) at
   T=100, B=64, H=512, full, ragged ([50, 100]), reversed, nonzero h0
   and bf16 with nonzero h0. F and H must make 2 device operations per
   call and print their us per step. The backward kernels get random
   cotangents; the
   error measure and tolerances are D/E's. G has E's three phases and I
   two (the serial loop on the shared backward loop after a memset of
   its barrier counters, dW_hh): their cases
   repeat bit for bit, and their main cases print the phase split.
   E, G, I, F, D and H then run alone at their loop's other grids
   (`WIDE_CASES`: w_hh's rows read through L2 at H >= 1536 (I and H
   from H=2816), 2, 4 or 8 pairs per thread at wide H or B; I at B=64,
   H=2048, F at B=64, H >= 1536 and H at B=64, H >= 2816, which their
   one-launch designs refused; D at B=64, H=1536 and 2048 from L2, in
   f32 and bf16, and at B=256, H=1024; H at B=64 H=2048 (f32, bf16),
   B=256 H=1024 and B=100 H=2560, the shape only H's one-gate tile
   bounds take), ragged with nonzero initial state, against their
   plain versions and bit for bit on a second call.
   Yardsticks: cuDNN's
   torch.nn.GRU(256, 512) with b_hn zeroed (the port's n gate) and
   torch.nn.RNN(512, 512, tanh), their input projections timed beside
   them. Bounds count live (row, step) pairs.
3. serve  -- the transformer LM at the serving benchmark's width (vocab
   32000, dim 512, 8 layers, 8 heads, f32) with seeded random weights
   through DecodeEngine(slots=8, max_len=256, page_size=16). Each path
   below runs with every launch count set to 0 just before it, and
   each kernel it should use must have launched; the same requests
   then go through the plain path (dense attention, the ragged walk's
   plain version) and the greedy tokens must agree -- where they
   differ, the plain path's top-2 logit gap at the first differing step
   must be <= 1e-3 (a near tie, not a fault).
   - float KV: 32 requests (128-token prompts, half sharing a 64-token
     prefix, 128 new tokens) launch A and B (TQ=1 and TQ>1). Four
     sampled requests must repeat their tokens under the same seeds,
     and the plain engine must match generate() on two requests.
   - int8 KV (kv_cache_dtype="int8"): the same 32 requests launch A and
     C (TQ=1 and TQ>1).
   - int8 weights (serve.quant.quantize_params), float KV: 4 requests.
   - speculative (serve(speculative=True), NGramProposer, 4 drafts), on
     the float and the int8 pool: 8 requests, half repeating a
     16-token motif; tokens agree with the same engine's one-token
     decode, and every verify round read the cache through B or C with
     TQ=5 (at least rounds x layers TQ>1 launches).
3b. server -- the serving stack over the same weights and requests
   (each run with every launch count set to 0 just before it; tokens
   against the plain path's by the gap rule above):
   - ServingServer over the kernel engine, float KV then int8 KV, the 32
     requests with max_queue 64, buckets (128,), a ManualClock one decode
     step advances by 1 ms, a FaultPlan with a prefill fault (the 4th
     call) and a decode fault (the 21st step), and two requests whose
     60 ms deadline expires mid-decode: reconcile() holds, those two
     expire with partial tokens, the rest complete, 9 requeues, A and B
     (A and C for int8) launched. Float KV then runs the first 8
     requests clean, timed in turns against the bare engine's serve()
     on the same engine (bare, server, server, bare); int8 prints its
     faulted run's tokens/s beside serve_phase's bare run; the
     server's counters are printed.
   - ServingRouter over two replicas (8 slots each, on the one card),
     each run on the first ROUTER_REQ (24) requests: the prefix-affinity
     hit rate and tokens/s against one replica; replica 0 killed at its
     41st decode step (every request ends once, the dead replica's
     redistributed); replica 0 retired at its 10th step (its queue
     moves, its 8 in-flight requests finish in place, one prefill a
     request).
   - Disaggregation: one role="prefill" replica, two role="decode",
     every request routed to the prefill tier and in waves the decode
     tier can take: float and int8 KV, inline and over a ShmArena data
     plane (each run the first DISAGG_REQ (4) requests). Every request
     crosses by export_request/
     import_request; its tokens equal the unified replica's (else the
     gap rule); the decode tier's TQ=1 walk launches equal its steps x
     layers (it reads the imported pages); no data-plane fallback; in
     the float inline run the first import into decode replica 1 dies
     (router_kill_import_at) and the same payload lands on replica 2.
     ms per migrated slot (export + import, synchronized) and the bytes
     exported are printed.
   - The ring pool at bench_decode's swa row (window 128, RING_REQ (4) prompts, 128
     new tokens, cut from 1024): A launches once per layer per request,
     each with the window and the key bound, no B or C; tokens against
     the plain rolling generate() by the gap rule; tokens/s against the
     paged pool's.
   - `python -m paddle_tpu_torch serve --replicas 2 --max-queue 64
     --metrics-out` in a child process at this width on the first
     CLI_REQ (8) requests: its lines equal the in-process router's
     tokens (else the gap rule), every request completed, the metrics
     file parses.
3c. artifact -- the serving artifacts (serve.artifact, torch.export),
   A, B and C running as registered operators inside the exported
   programs. The exports (both bundles, the decoder, merge-model) trace
   on the host and launch no kernel, so a child process
   (`export_artifacts`) writes them while the serving phases run, and
   the phase waits for it, then loads and checks them:
   - an engine bundle (buckets (128,), sampled=False; no speculative
     width, so no verify programs) of the float-KV engine and of the
     int8-KV engine,
     saved, loaded into a fresh engine and bound: the first
     ART_BUNDLE_REQ (8) requests of serve_phase must come out bit for
     bit equal to an eager engine's serve of them, with
     artifact_fallbacks 0, one "step" program call per decode step, the
     128-wide from-zero chunk program serving the prefills (a prefix
     hit's 64-wide remainder is an expected miss, served eagerly), and
     A, B and C launched exactly as often as in the eager serve (A 40,
     B or C 1024 + 24 calls, 2096 device launches, for 8 requests).
     Cold start (an engine from its weights, the bundle
     loaded and bound, one prefill, its first token on the host) and
     tokens/s are printed beside the eager engine's.
   - a bundle whose manifest names another PyTorch version: refused at
     ServingServer boot with the field named, counted once with a
     flight event, and the 8 requests served after it (16 new tokens
     each) equal the eager tokens.
   - export_decoder at bench_decode's width (B=8, a 128-token prompt,
     4 steps unrolled: the bench's 128 cut for export time): its tokens
     equal generate()'s, A launched once per layer in its prefill.
   - `merge-model` over a parameters tar and `infer` of ResNet-50 at
     bench_image's width, batch 64, f32 eval: within 1e-4 of the eager
     forward.
4. train  -- the bench_lstm classifier (benchmarks/suite.py:144: vocab
   10000, embedding = hidden = 512, 2 x nn.LSTM, mean over time,
   Dense(2), adam 1e-3; B=64, T=100) with seeded random weights through
   the port's Trainer for 10 steps over 4 seeded batches, launch counts
   set to 0 just before: exactly 2 D and 2 E launches per step, each D
   call making 2 device operations and each E call at least three
   device launches (its phases, counted by the wrapper as it launches
   them). The
   same weights then train on the plain path (nn.LSTM(impl="torch")):
   first-step gradients agree to 1e-4 relative, every loss to 1e-3.
   Then text_lstm at the same width (max pool) on lengths uniform in
   [50, 100]: one forward and backward launches D and E twice each, and
   its gradients agree with the plain path's to 1e-4 relative.
4b. resilient -- the same classifier as a config script (the synthetic
   text classification reader over vocab 10000, padded to 100, an f32
   weight of 1.0 per sample, loss mean(w * CE)) through `python -m
   paddle_tpu_torch train --checkpoint-dir ... --checkpoint-every 8
   --save-dir ...` over 32 batches, in child processes that print their
   D and E launches as they exit (2 of each per step): uninterrupted,
   and beside it one sent SIGTERM once it has logged batch 13 (drain
   save, exit 143), then a rerun that resumes from the drain save: its
   params.tar
   must be byte-identical to the uninterrupted one's. In process on the
   card, over 12 batches: NaN at batch 5 under bad_step_policy "skip"
   (bit for bit a clean run without batch 5, at the same step indices)
   and "rollback" with lr_backoff 0.5 (recorded, every parameter
   finite); a checkpoint write error on the 2nd save lands in
   save_errors and training goes on. On one batch: accum_steps=4
   against 1 (loss within 1e-5 relative, each gradient leaf within 1e-4,
   floored as seq2seq's), remat's gradients bit for bit the plain ones;
   each of the 12 optimizers, chain (clips and decay) and with_pruning:
   two updates on the card against the same on CPU copies (1e-5; 1e-4
   for L-BFGS, OWL-QN and chain's global-norm clip), each update timed;
   evaluate() with ClassificationError, Auc and PrecisionRecall on 512
   held-out rows from the uninterrupted run's params.tar, kernels
   against impl="torch" (predictions equal but at a logit gap <= 1e-3,
   AUC within 1e-3); check_gradients in float64 on impl="scan" (the
   path that computes in float64; D and E and their plain versions run
   f32) at most 1e-5, and the kernel path refusing float64. Times,
   1 + 10 steps ending in a sync: Trainer.train, ResilientTrainer.run
   (its guard reads every loss), accum_steps=4, remat, with D and E
   launches per step.
5. seq2seq -- seq2seq_attn at bench_seq2seq's width
   (benchmarks/suite.py:188: vocab 30000, embed 256, hidden 512, B=64,
   source and target length 30, lengths uniform in [15, 30], adam 1e-3)
   with seeded random weights, 10 hand-rolled steps (gradients, then
   adam's update) over 4 seeded batches, launch counts set to 0 just
   before: exactly 2 F and 2 G launches per step (the bidirectional
   encoder; two device launches per F call, at least three per G
   call), no H or I. The same weights then train on the plain path
   (impl="torch", none of F-I launches): first-step gradients agree to
   1e-4 relative (each leaf on its own scale, floored at 1e-6 of the
   largest gradient), every loss to 1e-3. Target tokens/s is
   sum(tgt_lens) over the steps / wall time, the bench's definition.
6. generation -- generate(beam_size=4, max_len=30) and greedy_generate
   on 16 source rows with the trained weights, on the kernels (2 F
   launches per call, 4 device launches, no G) and on the plain path:
   tokens and lengths
   equal, except at a near tie (greedy: the plain path's top-2 logit
   gap at the first differing step <= 1e-3; beam: the plain search's
   smallest gap among its K+1 best candidates or final scores <= 1e-3);
   beam scores within 1e-4 relative.
7. simple_rnn -- ops.rnn.simple_rnn at T=100, B=64, H=512 on lengths
   uniform in [50, 100]: one forward and backward launches H and I once
   each (H 2 device launches, I at least three), and its gradients
   agree with the plain path's to 1e-4 relative.
7b. rnn_family -- the rest of the RNN family. SRL's depth-8 db-LSTM +
   CRF at the label_semantic_roles book chapter's widths (word_dim 32,
   mark_dim 5, LSTM state 128, the CoNLL-05 dictionaries' sizes 44068 /
   3162 / 59, B=10 rows of the conll05 surrogate's own lengths 5-29),
   the quick_start bidi_lstm and db_lstm (depth 8; embed = hidden = 128,
   B=128 imdb surrogate rows of lengths 8-119, vocab 2000): for each, the
   first step's loss (1e-3) and gradients (1e-4 per leaf, floored as
   seq2seq's, and, as the image phase does, only where the model is
   well conditioned in f32: where the CPU's f32 gradient lies within
   1e-5 of a float64 run of the step on the CPU; the rest are printed
   beside their float64 errors: db_lstm's levels 0-5 at random init) on
   the card against the same step on CPU tensors through the plain
   versions; then 1 + 5 adam(1e-3) steps on D and E, counts
   set to 0 just before: one D and one E launch per LSTM layer and step
   (SRL and db_lstm 8, half over time-flipped inputs; bidi_lstm 2), each
   D call 2 device operations and each E call at least three; the same
   steps on their plain versions (impl="torch") launch none and their
   losses agree to 1e-3; ms per step on both. SRL then Viterbi-decodes a
   held-out batch with the trained weights: its tags equal the plain
   path's on the CPU, or a differing row's path scores within 1e-3 of
   the best. D and E alone at the first SRL batch's shape (T=its
   longest, B=10, H=128) and the first quick_start batch's (B=128,
   H=128), reversed, with those batches' lengths, beside cuDNN's
   nn.LSTM(128, 128) and their bound; an SRL step under torch.profiler
   (wall, device busy, kernels, D's and E's share) beside the CRF's
   forward and backward alone. The
   kernel-free parts card against CPU: text_cnn (context 3, hidden 512)
   and bow_lr (count vectors and token rows) at B=128, BiLSTM-CRF (embed
   32, hidden 64; Viterbi tags as SRL's, scores 1e-5), md_lstm on a [8,
   16, 16, 32] grid, hidden 64, from each corner (in float64 on both
   devices: its f32 state sums every lattice path, and f32 runs land
   ~1e-4 from float64; their errors are printed), and
   cross_entropy_over_beam (E=8, B=128, K=4, gold pruned in a third of
   the rows): outputs 1e-5 relative, losses and gradients 1e-4.
7c. pserver_ctr -- the parameter-server tier and CTR serving at
   bench_ctr_sparse's table (benchmarks/suite.py:267, sizes at :811-815:
   vocab 1,000,000, dim 64, 32 slots, f32, row lr 0.05; seeded), on the
   host except the cache's arena, the rows PServerEmbedding hands out and
   the CTR tower, which live on the card. It launches none of A-I.
   1. The native library (recordio, task queue; g++) built from
      paddle_tpu_torch/native/src into paddle_tpu_torch/_build, its
      seconds printed; PServerGroup(1,000,000, 64, n_shards=2,
      replicated) (128 MiB a shard, 512 MiB with the backups), a seeded
      table loaded through PServerEmbedding(device="cuda").init:
      fetch_table equals the drawn table bit for bit.
   2. StreamingTrainer over a TaskQueue of PS_TASKS (4) JSON tasks of
      bench_ctr_sparse's batch (4096 x 32 ids: 131072 rows pulled and
      pushed a task), its lookups landing on the card; a twin tier with
      the same table streams the same tasks with shard 0's primary
      killed on its 4th push (FaultPlan(pserver_kill_push_at=3)): the
      final tables equal bit for bit, the kill fired once, the client
      failed over. s/task, rows/s and the failover's seconds (the push
      that met the dead primary against a clean push) are printed.
   3. TieredEmbedCache(hot_rows=131072, host_rows=524288,
      max_staleness=0) (a 32 MiB arena) and CtrServer(init_tower(0, 64),
      slots=32, max_batch=256) over 200 requests of 256 x 32 ids drawn
      Zipf(1.1) over the vocab (a seeded permutation spreads the hot ids
      over both shards; 5% -1 pads), shard 1's primary killed before
      request 100. Gates: (a) every score within 1e-6 of the same tower
      on CPU tensors over rows read straight from the shards; (c) the
      cache invalidated on the failover and (a) holds past it; (b) a
      second trainer pushes into 64 hot rows with its ACKs fed to the
      cache (bind_push_feed): the next request refills them, scores them
      as updated, and the cache's rows equal the shards'; (d) two
      all-hit lookups back to back, no sync between them, each return
      their own rows (each slot vector crosses from a fresh pinned
      buffer); (e) a steady-state all-hit request under torch.profiler
      copies two vectors to the card (the slot vector and the mask, 32
      KiB each) and one back (the scores); this gate runs in a fresh
      process, the same cache and server over the same shards, because
      the profiler records no device activity at all in the smoke's own
      process once lm_train has run. requests/s, examples/s, p50 and p99
      ms per request, the cache's counters, the arena's MiB and the
      kernels per all-hit request are printed.
   4. Kernels A-I's launch counts, set to 0 at the phase's start, are
      printed (in the phase's JSON line) and must all be 0.
   The phase alone: `python3 -c "import torch;
   torch.backends.cuda.matmul.allow_tf32 = False; import chip_smoke as
   S; S.pserver_ctr_phase()"` (it builds no CUDA kernel).
7d. fleet -- the wire-based serving fleet at bench_engine's width (the
   serve phase's model, seed and requests), its replicas in processes of
   their own, each with a CUDA context on the card
   (`serve.fleet.FleetSupervisor`; every child builds its server with
   `chip_smoke:fleet_server`, imported by name, whose counters() carry
   the child's A/B/C launches and the digests of the KV pages it moved;
   the compute mode is printed beside the card's name and must allow
   several contexts):
   1. Three unified replica processes (float KV) behind
      `serve.http_edge.HttpEdge`; serve_phase's 32 requests streamed over
      sockets by 16 concurrent clients (`testing.traffic.stream_generate`,
      128 new tokens); once every replica holds live work,
      FaultPlan(fleet_sigkill_at=0) SIGKILLs replica 1 and the supervisor
      repairs the floor with a new process. Gates: every stream ends in
      exactly one completed outcome; its tokens equal the serve phase's
      kernel-path tokens by the gap rule; the fleet's, the router's and
      the edge's books balance (32 completed, none failed or shed, one
      replica lost, its work redistributed); every live child launched A
      and B; no child outlives the drain. Printed: requests/s, tokens/s,
      p50/p99 time to first token and inter-token gap, the boot (spawn to
      ready, three at once), the repair (kill to the new child's ready),
      RPC frames per sweep and rpc_frames_coalesced, each child's
      launches, and tokens/s beside that of the serve phase's one engine
      in this process on the same 32 requests.
   2. A prefill process and a decode process over the supervisor's
      shared-memory arena, int8 KV, the first 8 requests: every request
      crosses (card -> host -> arena -> the other child's card). Gates:
      tokens equal the int8 serve's by the gap rule; the decode child
      launched C (TQ=1) on the imported pages, the prefill child none;
      no data-plane fallback; the pages the decode child copies on the
      card after each import are bit for bit the ones the prefill child
      exported (CRC32 sums equal, 8 each; both children take them in the
      reconcile RPC after the run, outside the timed ones). Printed: ms
      per migrated slot (the export and import RPCs) and bytes per
      slot.
   The phase alone: `python3 -c "import torch;
   torch.backends.cuda.matmul.allow_tf32 = False; import chip_smoke as
   S; from paddle_tpu_torch.ops import _cuda; _cuda.build_all(
   ['flash_attention', 'ragged_paged_attention']); S.fleet_phase()"` (it
   serves its float and int8 references first when serve_phase has not
   run).
7e. zoo -- the five remaining zoo models and the leaf ops, on torch ops
   alone (no kernel of A-I lies on this path), within ~30 s. Each model
   at its own widths, trained through its entry points on the card:
   word2vec (the imikolov surrogate's 1000 words, embed 32, hidden 256,
   context 4; softmax `loss`, and `loss_nce` over 16 log-uniform
   negatives a row), recommender (`RecommenderConfig` defaults, the
   movielens surrogate's users, movies and 18 categories, ragged
   category lists and titles), traffic (24 terms, 24 horizons, emb 16, 4
   classes; the class follows the mean speed) at B=256; GANTrainer
   (mlp_generator(784), mlp_discriminator(), both adam(2e-4, beta1=0.5))
   on the MNIST surrogate and VAE(784) on its binarised images at B=128.
   For each: the first step on the card against the same step on CPU
   tensors from the same weights and injected noise (word2vec's
   negatives, the VAE's eps, the GAN's two latent batches): loss 1e-3,
   each leaf's gradient 1e-4 (the GAN: both losses, and the gradients
   each adam update received), on the leaves where f32 is well
   conditioned (the CPU's f32 within 1e-5 of a float64 run on the CPU;
   the rest printed); then 1 + 5 steps on the card on one batch (adam
   1e-3; NCE negatives, the VAE's eps and the GAN's latents drawn on the
   card), every loss finite and the last below the first (the GAN's
   discriminator loss), ms per step printed (ending in a sync). Then
   every function of the leaf ops (losses, linalg, sampling's NCE,
   log-uniform and hsigmoid, the in-graph metrics, misc, the two norms,
   ctc, the rest of conv, detection), 83 cases at the JAX tests' shapes,
   on card tensors against the same call on CPU tensors: ids, masks,
   matches, NMS keep-masks and top-k equal, floats and the gradients of
   seeded cotangents within 1e-4 of their max (an impossible CTC row
   costs ~1e30 on both); the generator-driven draws run on the card.
   Kernels A-I's launch counts, set to 0 at the phase's start, must all
   be 0. The phase alone: `python3 -c "import chip_smoke as S;
   S.zoo_phase()"` (it builds no CUDA kernel).
8. lm_train -- the transformer LM's training path at
   bench_transformer_lm's width (benchmarks/suite.py:331: vocab 32000,
   dim 512, 8 layers, 8 heads, remat, bf16 policy, B=4, T=8192, adam
   1e-3, seeded weights, the same batch every step). First the flash
   backward's cases: flash_attention's gradients on the card (kernel A
   forward, the ported blockwise backward) against torch.autograd
   through the plain version, random cotangents, causal T=2048 in f32
   and bf16, key_lens, a window of 256 at T=2048, head_dim 128, and
   causal T=8192 B=4 bf16 (held one batch row at a time); max abs error
   over max |plain| per gradient within f32 1e-4 / bf16 2e-2. The
   backward alone at T=8192 B=4 is timed beside SDPA's backward and its
   bound (2.5 x the forward's products). Then three variants (full
   causal, attn_window 1024, fused_ce_chunk 2048), a warm-up step and
   LM_STEPS (1)
   timed steps each: ms/step, tokens/s (B x T over the step), the
   step's analytic FLOP count and its share of 989 TFLOP/s (mfu_pct);
   A's launches counted from 0 before the warm-up must be 16 a step (a
   forward and a remat recompute per layer), no dense attention or flash
   plain version may run, every loss finite and the last below the
   first, and the fused CE's first loss within 1e-3 of the unfused one.
   Then parity with the plain path (the flash Function's forward on the
   plain version, which must not launch A) from the same weights at T
   cut to 2048, 3 steps, f32 (first-step gradients per leaf 1e-4, floored
   as seq2seq's, losses 1e-3) and bf16 (2e-2, 1e-2); and a checkpoint
   round trip: CheckpointManager(max_to_keep=2) over 3 steps keeps 2 and
   3, restores them into a fresh template leaf for leaf, one more step
   from both gives the same loss bit for bit, and the parameters tar
   round-trips the params exactly.
8a. distributed -- the distributed layer (paddle_tpu_torch.parallel,
   core.mesh) on torch.distributed. NCCL cannot put two ranks on one
   device, so no number here is a scaling number.
   - World size 1 over NCCL: graft_entry.dryrun_multichip(1) (the toy
     dp x tp ZeRO-placement step with two microbatches, ring attention,
     the sharded embedding's lookups, ResNet-50 and seq2seq
     data-parallel -- the seq2seq step on F and G --, the CTR step, and
     the transformer TP step with the fused CE against the plain CE;
     the engine pool is skipped for the world size); the LM at bench_transformer_lm's width (lm_train's
     weights and tokens, bf16 policy) through
     make_sharded_train_step(param_rules=TP_RULES) on mesh (1, 1, 1) and
     through make_zero_train_step and its zero_update=False oracle arm,
     1 + DIST_STEPS (1) steps each beside the plain step: bit for bit,
     or within the
     LM phase's bf16 tolerance (the run prints which); ZeRO bit for bit
     with its oracle arm; A 16 launches a step, counted from 0 before
     each run; make_context_parallel_loss, ring and Ulysses, at
     T=2048 (loss and every gradient within 1e-4 of the plain loss's);
     generate on TP_RULES parameters at bench_decode's B=8, 128-token
     prompts and DIST_TP_STEPS (16) new tokens, against the unsharded generate by the gap rule, A 8 in
     the prefill.
   - Two ranks sharing cuda:0 over gloo (spawned, joined with a
     timeout, killed on failure): scripts/torch_gloo_cuda_probe.py
     (started with the phase, its ranks reaching the card while the
     world-size-1 part runs) must find exactly GLOO_CUDA (and
     GLOO_CUDA_BF16), the collectives gloo takes on CUDA tensors; then
     the paths of GLOO_PATHS whose
     collectives are all on that list and that GLOO_REFUSED does not
     name (dp and ZeRO; TP's DTensor collectives crash gloo, ring CP
     and the pipeline need point-to-point sends: held on the CPU
     only), at the LM's width in f32 with 2 of the 4 rows a rank,
     sgd 0.1, 1 + 1 steps, against the plain step on the 4 rows
     (losses rtol 1e-5, parameters after the first and the last step
     rtol 1e-4 / atol 1e-5: JAX's DP gate), printing ms/step, A's
     launches, the collectives and bytes a step moves; ZeRO's
     opt_state_bytes_per_replica at two ranks is half of world size
     1's (to within padding).
8b. sparse_elastic -- the rest of the distributed layer, within ~150 s:
   - CTR at bench_ctr_sparse's width (benchmarks/suite.py:267, sizes at
     :811-815: batch 4096, 32 slots, vocab 1,000,000, dim 64, adam 1e-3
     on the MLP, row lr 0.05, f32), world size 1 over NCCL: the first
     step against the port's plain run of the same step on the CPU at
     full width, for the all-to-all and the psum exchange (loss 1e-5,
     MLP 1e-4, touched rows 1e-5, every untouched row bit for bit); 2
     warm-up and 20 timed steps: ms/batch, rows/s, examples/s, the row
     exchange's GB/s and its share of 3.35 TB/s, as the bench reckons
     them (:316-327).
   - HostOffloadEmbedding at the same vocab and dim, the batch's 131072
     ids: one lookup and one apply_row_grads; rows bit for bit
     ShardedEmbedding's; the card's peak memory grows by at most 2x the
     looked-up rows' bytes (the rows alone are 13% of the table's, so
     a tenth of the table cannot bound it) and never by the table; ms
     per lookup and per update.
   - Two gloo ranks on cuda:0 (gloo_rank's "sparse_elastic" job): the
     CTR step with both tables row-sharded over model=2 and the
     all-to-all exchange, 2048 rows a rank, 1 + CTR_GLOO_STEPS steps
     against the one-process steps (losses 1e-5, parameters rtol 1e-4 /
     atol 1e-5), all_to_all_single launches and bytes a step, ms/step;
     then one ZeRO LM step at lm_train's width (f32, adam) saved through
     the ElasticCheckpointManager.
   - That state restored at world size 1 over NCCL: unpadded parameters
     and adam's m and v bit for bit, the manifest's data 2 -> 1,
     reshard_restores 1; one more step from it bit for bit the same step
     from the saved state loaded without resharding; A 16 a step.
   - The DecodeEngine pool over TP_RULES parameters at bench_engine's
     width on a one-rank model axis (B and C dispatched through their
     DTensor rules), float and int8 KV, the serve phase's first 4
     requests: tokens bit for bit and A/B/C launches equal to the
     single-device engine's; tokens/s beside it.
   - A GangSupervisor over two members on cuda:0 (gloo): the resilient
     phase's bench_lstm classifier through `train --elastic`'s builder,
     GANG_STEPS steps, rank 1 SIGKILLed at heartbeat step GANG_KILL_AT:
     one reform at one member, which restores the last committed step
     through the reshard path, runs every later step once and finishes
     with its last loss finite and below its first; the gang epoch,
     steps lost, reform seconds and D/E launches in the members.
   - dryrun_multichip(1) again: it runs the sharded embedding and the
     CTR step and skips only the engine pool, for the world size.
8c. decode -- the LM's decoders at bench_decode's width
   (benchmarks/suite.py:500-668: vocab 32000, dim 512, 8 layers, 8
   heads, f32, seeded weights, B=8 prompts of 128 tokens from
   RandomState(0), DEC_STEPS (16; the bench's 128, cut) new tokens),
   attn_impl "auto" so that kernel A
   runs every prefill: greedy generate, sample (temperature 0.8, top_p
   0.95, Gumbel draws from a seeded card generator injected, so both
   paths draw the same), beam_decode (beam 4), speculative_generate
   (k=4) with draft = target and with the bench's small draft (dim 128,
   2 layers, seed 7, dense attention), speculative_sample with that
   draft at top_k=1 and at the bench's temperature/top_p. Each mode's
   kernel-path call counts A's launches from 0 (8 a prefill, 16 with
   draft = target) and prints new tokens/s; the same calls on the plain
   path (attn_impl "dense") launch no A. Gates: greedy, sample, beam and
   both speculative_generate runs equal the plain path's tokens, and the
   speculative runs and speculative_sample at top_k=1 equal greedy
   generate's, each row or differing first at a step whose plain-path
   margin (top-2 logit gap, teacher-forced; for sample the top-2 gap of
   filtered logits plus the step's draw, or the nucleus boundary's
   distance from top_p) is <= 1e-3; beam rows equal, or the plain
   search's smallest candidate gap <= 1e-3, scores within 1e-4; draft =
   target takes at most ceil(DEC_STEPS / 5) + 2 rounds a row.
8d. moe -- the mixture-of-experts LM at bench_moe_lm's width
   (benchmarks/suite.py:452: vocab 32000, dim 512, 8 layers, 8 heads,
   every other block 8 experts, top-2, capacity 1.25, remat, adam 1e-3,
   f32, B=8, T=2048, seeded weights and tokens; the scatter dispatch).
   The first step on kernel A and on the plain path from the same
   weights: the routing decisions (expert, slot, keep) of every routed
   call are compared first; where all agree the gradients are held leaf
   by leaf at 1e-4 (floored as seq2seq's), else every token whose
   experts moved must sit at a router-logit gap <= 1e-3 and the leaf
   errors are printed; the loss within 1e-3 either way. Then 1 + 5
   top-k steps and 1 + 2 expert-choice steps (ms/step, tokens/s, peak
   memory, each MoE block's dropped fraction and aux loss in the first
   step; A 16 launches a step, losses finite and falling). Then
   DecodeEngine over an MoE model at bench_engine's width (moe_experts
   8) on float and int8 KV, the first MOE_SERVE_REQ (4) of
   serve_phase's requests,
   against the plain path by the gap rule (A and B, or A and C,
   launched).
9. image -- the image models (no kernel of their own: cuDNN convs, torch
   pools, BN as a torch-ops autograd Function). Parity with the port's
   CPU path from the same weights: resnet50 (B=4), googlenet, alexnet,
   vgg19 (B=2, 224x224) and smallnet (32x32): f32 eval logits 1e-4,
   loss 1e-3; f64 on both devices (logits, loss, every gradient and BN
   state) 1e-4; the f32 step op by op (`OpReplay`: every op the card
   runs against the same op on the CPU on the card's inputs, 1e-4,
   max-pool indices equal); its gradients and BN state leaf by leaf at
   1e-4 where the CPU's own one-ulp spread stays under 1e-5 (AlexNet,
   SmallNet; elsewhere an ulp decides near ties or BN batch statistics,
   and the errors are printed); resnet50 also under the bf16 policy
   (eval logits 2e-2, loss 1e-2, op by op 2e-2) and 1 + 1 momentum steps
   in f64 (losses 1e-3; BN state, velocity and each parameter's change
   1e-4). Then
   bench_image's configs (benchmarks/suite.py:112, :765-775; bf16,
   momentum(0.01, mu=0.9) --
   the bench's lr 0.1 diverges on one repeated batch, in JAX as in the
   port --, softmax CE, make_train_step(donate=True), cuDNN benchmark
   mode): resnet50 B=64 and 256, its s2d and both remat variants at 256,
   alexnet 128, googlenet 128, vgg19 64, smallnet 512: 1 + IMAGE_STEPS
   (1) timed step
   (ms_per_batch, imgs_per_sec, mfu_pct, peak memory; every loss finite,
   the last below the first, BN running stats moved). bench_trainer_loop
   (resnet50 B=64 through Trainer.train) beside the raw step, alexnet
   with its dropout through Trainer.train (the masks drawn on the card),
   and graft_entry.entry() (finite [16, 1000] logits).
10. report -- the launch counts of every path (A, B and C also per run of
   the server phase and of the MoE serves, A per decoder and per MoE
   step), the serve, server, train, seq2seq,
   generation, LM train, decode, MoE and image numbers, the wide cases, the card's
   name and power limit, a `phase_seconds` JSON line (each phase's wall
   seconds, the build's and the total; each phase also logs its seconds
   as it ends), a `kernels` JSON line (nine kernels, A-I, in eleven
   entries, each with its launches in the pserver_ctr and zoo phases,
   which must be 0, B's and C's summed over their two entries; A, B and C add
   their launches in the fleet phase's replica processes; A adds its
   HMMA counts and its launches in the LM train phase and the
   sparse_elastic phase's ZeRO steps; B and C their launches in the TP
   engine pool and their
   device launches in the float and int8
   serves and per call and their split plan; D, F and H their device
   launches and whether they repeated bit for bit (D and H also their
   us per step); E, G and I their
   device launches in the main path's run and
   per call, their phase split and whether they repeated bit for bit;
   D and E also their launches in each resilient CLI child and in the
   in-process ResilientTrainer run, in the elastic gang's members, and in the rnn_family phase's SRL,
   db_lstm and bidi_lstm runs with their cases at the SRL and
   quick_start shapes), the resilient and rnn_family phases' numbers, and
   last the device JSON line.

One phase alone, on the card: `python3 -c "import chip_smoke as S;
S.seq2seq_phase()"` (each phase builds what it launches at first use).

TF32 is switched off for matmuls and cuDNN, so float32 means float32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import runpy
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

if __name__ == "__main__":
    # Python compiles every module it imports that has no bytecode
    # cache; where the installation ships none and the environment
    # forbids writing one (PYTHONDONTWRITEBYTECODE), each process -- this
    # one and every child a phase starts -- compiles torch anew (on an
    # H100 host a fleet child took 11.6 s from its spawn to its builder
    # without a cache, 5.7 s with one). Keep the cache in the checkout's
    # build directory; the children inherit it through the environment.
    _PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "paddle_tpu_torch", "_build", "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = _PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = _PYCACHE

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch import data as TDATA
from paddle_tpu_torch import graft_entry as GRAFT
from paddle_tpu_torch import metrics as MET
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.core.pytree import (tree_leaves, tree_map,
                                          tree_map_multi, tree_map_with_name)
from paddle_tpu_torch.models import alexnet as IM_ALEXNET
from paddle_tpu_torch.models import bilstm_crf as TBC
from paddle_tpu_torch.models import googlenet as IM_GOOGLENET
from paddle_tpu_torch.models import resnet as IM_RESNET
from paddle_tpu_torch.models import seq2seq_attn as TS
from paddle_tpu_torch.models import quick_start as TQ
from paddle_tpu_torch.models import smallnet as IM_SMALLNET
from paddle_tpu_torch.models import srl as TSRL
from paddle_tpu_torch.models import text_lstm as TTL
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models import vgg as IM_VGG
from paddle_tpu_torch.models import gan as ZGAN
from paddle_tpu_torch.models import recommender as ZREC
from paddle_tpu_torch.models import traffic as ZTRAFFIC
from paddle_tpu_torch.models import vae as ZVAE
from paddle_tpu_torch.models import word2vec as ZW2V
from paddle_tpu_torch.nn import layers as NL
from paddle_tpu_torch.nn import module as NM
from paddle_tpu_torch.nn import recurrent as NR
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import beam_search as BS
from paddle_tpu_torch.ops import crf as CRF
from paddle_tpu_torch.ops import conv as ZCONV
from paddle_tpu_torch.ops import ctc as ZCTC
from paddle_tpu_torch.ops import detection as ZDET
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import fused_gru as FG
from paddle_tpu_torch.ops import fused_lstm as FL
from paddle_tpu_torch.ops import fused_rnn as FR
from paddle_tpu_torch.ops import linalg as ZLIN
from paddle_tpu_torch.ops import losses as LS
from paddle_tpu_torch.ops import metrics as ZMET
from paddle_tpu_torch.ops import misc as ZMISC
from paddle_tpu_torch.ops import norm as ZNORM
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
from paddle_tpu_torch.ops import rnn as RNN
from paddle_tpu_torch.ops import sampling as SAMP
from paddle_tpu_torch.parallel import moe as PMOE
from paddle_tpu_torch.serve import quant as Q
from paddle_tpu_torch.optim import hooks as HOOKS
from paddle_tpu_torch.optim import optimizers as OPT
from paddle_tpu_torch.testing.faults import FaultPlan
from paddle_tpu_torch.serve.engine import DecodeEngine
from paddle_tpu_torch.train import checkpoint as CK
from paddle_tpu_torch.train import events as EV
from paddle_tpu_torch.train import resilience as RS
from paddle_tpu_torch.train.state import TrainState
from paddle_tpu_torch.train.trainer import (Trainer, loss_and_grads,
                                            make_train_step)

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12,           # f32, CUDA cores
              torch.bfloat16: 989e12}         # bf16, dense tensor cores
# A's f32 products run as 3xTF32 on the tensor cores: three TF32 products
# (dense 495 TFLOP/s) for each f32 one
PEAK_3XTF32 = 495e12 / 3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GAP_LIMIT = 1e-3

SERVE_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8)
SLOTS, MAX_LEN, PAGE = 8, 256, 16
N_REQ, PROMPT, SHARED, MAX_NEW = 32, 128, 64, 128
N_WEIGHT_REQ, N_SPEC_REQ = 4, 8     # cut from 8 and 16 (the fleet phase)
# the server phase: a prefill fault and a decode fault (0-based calls of
# the wrapped engine), two requests whose deadline (ms on a ManualClock
# that one decode step advances by STEP_MS) expires mid-decode
SERVER_PREFILL_FAULT, SERVER_DECODE_FAULT = 3, 20
SERVER_DEADLINE_REQS, SERVER_DEADLINE_MS, STEP_MS = (1, 6), 60.0, 1.0
ROUTER_KILL_AT, ROUTER_RETIRE_AT, IMPORT_KILL_AT = 40, 10, 0
TIMED_REQ = 4           # the clean server-vs-bare turns (cut from 8)
# the router's runs (clean, a kill, a retirement) take the first
# ROUTER_REQ requests (cut from 32: three waves over two replicas of 8
# slots, so replica 0 still holds a queue when it retires), the serve CLI
# the first CLI_REQ of those (cut from 24); each disaggregated run the
# first DISAGG_REQ (cut from 16, then 8; the first import is still
# killed)
ROUTER_REQ, CLI_REQ, DISAGG_REQ = 24, 8, 4
# bench_decode's swa row (benchmarks/suite.py:500, :601-624): batch 8,
# 128-token prompts, window max(steps, 16) = 128, steps * 8 = 1024 new
# tokens, cut to 128 to keep the smoke near 930 s (the ring wraps
# either way: 128 prompt tokens and 128 new past a window of 128)
RING_WINDOW, RING_REQ, RING_NEW = 128, 4, 128   # the row's 8 and 1024, cut
REPO_DIR = os.path.dirname(os.path.abspath(__file__))

# bench_lstm(hidden=512, batch=64, seq_len=100, vocab=10000)
# (benchmarks/suite.py:144, sizes at :778-781)
LSTM_T, LSTM_B, LSTM_H, LSTM_VOCAB = 100, 64, 512, 10000
TRAIN_STEPS, TRAIN_BATCHES = 10, 4
LOSS_RTOL, GRAD_RTOL = 1e-3, 1e-4

# bench_seq2seq(batch=64, src_len=tgt_len=30, hidden=512, embed=256,
# vocab=30000) (benchmarks/suite.py:188, sizes at :803-808)
S2S_VOCAB, S2S_EMBED, S2S_H, S2S_B, S2S_LEN = 30000, 256, 512, 64, 30
GEN_ROWS, GEN_BEAM, GEN_MAX_LEN = 16, 4, 30
SCORE_RTOL = 1e-4
# the tanh RNN at the reference RNN benchmark's shape (bench_lstm's)
RNN_T, RNN_B, RNN_H = 100, 64, 512
# bench_transformer_lm(seq_len=8192, batch=4, dim=512, n_layers=8,
# n_heads=8, vocab=32000) with remat, bf16 policy (benchmarks/suite.py:331,
# sizes at :819-833, policy at :759), also with window 1024 and the fused
# CE over 2048-position chunks (:856-866)
LM_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8, remat=True)
LM_B, LM_T, LM_SEED = 4, 8192, 0
LM_WINDOW, LM_CE_CHUNK, LM_STEPS = 1024, 2048, 1   # steps cut from 10
# parity with the plain path: the sequence cut to 2048, 3 steps;
# (first-step gradient, loss) tolerances per compute dtype
LM_PARITY_T, LM_PARITY_STEPS = 2048, 3
LM_PARITY_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 1e-2)}


def log(*a):
    print(*a, flush=True)


class Fail(RuntimeError):
    pass


# -- timing ------------------------------------------------------------------

_FLUSH = None
# ~5 ms at the H100's clock: while the GPU spins, the host queues the
# whole timed call, so the events bracket device work only
_SPIN_CYCLES = 10_000_000


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` calls. Before each call the
    L2 is flushed (a 64 MB write, as a serving step finds the cache
    cold) and the GPU spins while the host enqueues the call, so host
    launch overhead stays outside the CUDA events around it."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


PHASES = ("gates", "loop", "dw")


def phase_ms(bwd, bargs, names=PHASES, iters=10, warmup=2):
    """Mean device ms of each phase of one call of a redesigned backward
    kernel (E, G: gates, loop, dW; I: loop, dW): the wrapper records four
    CUDA events, before its first launch and after each phase (I's first
    phase is empty). L2 flushed before each call, as in time_ms."""
    time_ms(lambda: bwd(*bargs), iters=1, warmup=warmup)
    sums = [0.0, 0.0, 0.0]
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        _FLUSH.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        bwd(*bargs, events=ev)
        torch.cuda.synchronize()
        for i in range(3):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    return {n: x / iters for n, x in zip(PHASES, sums) if n in names}


def log_phases(kern, phases, ms, steps):
    gates = (f"gates {phases['gates']:.4f}, " if "gates" in phases
             else "")
    log(f"    {kern} phases (device ms, mean of 10 calls): {gates}serial "
        f"loop {phases['loop']:.4f} ({phases['loop'] / steps * 1e3:.2f} us "
        f"per step), dW {phases['dw']:.4f}; sum "
        f"{sum(phases.values()):.4f} vs kernel_ms {ms:.4f}")


def bitwise_repeat(bwd, bargs, first):
    """Does a second call on the same inputs give every output bit for
    bit (dW_hh above all: its split parts are summed in a fixed order)?"""
    again = bwd(*bargs)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, again))


def bound(bytes_, flops, dtype, peak=None):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- kernels B and C: the ragged page-table walk ------------------------------


def ragged_case(name, *, r, tq, h, hkv, dh=64, dtype=torch.float32,
                pos0=None, inactive=0, sentinel_tail=0, seed=0, int8=False):
    """One walk case: kernel B over float arenas, or kernel C (int8=True)
    over (s8, scale) arenas quantized from the same kind of values."""
    rs = np.random.RandomState(seed)
    max_pages = -(-MAX_LEN // PAGE)
    num_pages = max(r, SLOTS) * max_pages
    dev = "cuda"
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(r, tq, h, dh)
    ka = mk(num_pages, PAGE, hkv, dh)
    va = mk(num_pages, PAGE, hkv, dh)
    if int8:
        ka, va = PA.kv_quantize(ka), PA.kv_quantize(va)
    pt = np.stack([rs.permutation(num_pages)[:max_pages]
                   for _ in range(r)]).astype(np.int32)
    if sentinel_tail:
        pt[:, -sentinel_tail:] = num_pages
    if pos0 is None:
        pos0 = rs.randint(PROMPT, MAX_LEN - tq + 1, r)
    pos0 = np.broadcast_to(np.asarray(pos0, np.int32), (r,)).copy()
    active = np.ones(r, bool)
    if inactive:
        active[-inactive:] = False
    args = (q, ka, va, torch.from_numpy(pt).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(active).to(dev))
    kw = dict(page_size=PAGE, max_len=MAX_LEN)
    kind = "int8" if int8 else "float"
    before = RPA.device_launches[kind]
    got = RPA.ragged_kernel(*args, **kw)
    per_call = RPA.device_launches[kind] - before
    ref = RPA.ragged_reference(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    same = bitwise_repeat(lambda *a: (RPA.ragged_kernel(*a, **kw),), args,
                          (got,))
    # the work this data needs: active rows attend keys <= pos0 + i, an
    # inactive row all max_len keys; a key is read once per KV head as
    # Dh values (s8 for C, with its f32 scale) for K and for V
    isz = q.element_size()
    keys_q = np.where(active[:, None],
                      np.minimum(pos0[:, None] + np.arange(tq) + 1, MAX_LEN),
                      MAX_LEN)                                # [R, TQ]
    keys_row = keys_q.max(axis=1)
    key_bytes = dh + 4 if int8 else dh * isz
    bytes_ = (2 * q.numel() * isz + 2 * keys_row.sum() * hkv * key_bytes
              + pt.nbytes + pos0.nbytes + active.nbytes)
    flops = 4 * dh * h * keys_q.sum()
    bound_ms, bound_by = bound(bytes_, flops, dtype)
    k_ms = time_ms(lambda: RPA.ragged_kernel(*args, **kw))
    p_ms = time_ms(lambda: RPA.ragged_reference(*args, **kw))
    # the split plan, and the device launches of one call (the walk, and
    # the combine where there are several splits)
    wp = RPA.walk_plan(r, tq, h, hkv, MAX_LEN, PAGE,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    ok = (err <= TOL[dtype] and same
          and per_call == (1 if wp.splits == 1 else 2))
    log(f"  {'C' if int8 else 'B'} {name:<22} {str(dtype)[6:]:<8} err "
        f"{err:.2e} (tol {TOL[dtype]:.0e}) kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) splits "
        f"{wp.splits} x {wp.span} keys, {wp.blocks(r, hkv)} blocks, "
        f"{per_call} device launches per call, bitwise {same} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                tol=TOL[dtype], splits=wp.splits, span_keys=wp.span,
                blocks=wp.blocks(r, hkv), device_launches_per_call=per_call,
                bitwise=same)


def walk_resources_check():
    """Each instantiation of the split walk (B: float arenas, C: int8;
    f32 and bf16 queries; head_dim 64 and 128): its dynamic shared
    memory, registers, spills and blocks resident per SM, which must let
    2 x SMs blocks -- the plan's aim -- be resident at once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for (kind, dt, dh), (smem, regs, per_sm, spill) in \
            RPA.walk_resources().items():
        kern = "B" if kind == "float" else "C"
        log(f"  {kern} split_walk_kernel {dt} head_dim {dh}: {smem} bytes "
            f"of dynamic shared memory, {regs} registers, {spill} bytes "
            f"of spill, {per_sm} blocks per SM ({per_sm * sms} resident)")
        if per_sm < 2:
            raise Fail(f"{kern} {dt} head_dim {dh}: {per_sm} blocks per SM,"
                       f" fewer than the plan's 2 x {sms}")
        out[f"{kern}_{dt}_{dh}"] = dict(smem=smem, registers=regs,
                                        blocks_per_sm=per_sm, spill=spill)
    return out


# -- kernel A: flash attention forward ---------------------------------------


# above this many bytes of f32 scores the plain version is held against
# the kernel one batch row at a time
ROW_BY_ROW_BYTES = 4 << 30


def flash_case(name, *, b, t, h, d=64, dtype=torch.float32, causal=True,
               lens=None, window=None, seed=0, q_scale=1.0,
               row_relative=False):
    """One flash case: q, k, v N(0, 1) (q times q_scale) against the plain
    version, output within the dtype's tolerance and lse within f32's;
    both timed, beside SDPA where it computes the same function. The
    output's tolerance holds the max abs error, or with `row_relative`
    each output row's max abs error over that row's max |plain|: a long
    causal row averages thousands of values of v, so |o| falls to ~0.02
    there, the size of bf16's absolute tolerance."""
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v = mk(), mk(), mk()
    if q_scale != 1.0:
        q = (q.float() * q_scale).to(dtype)
    lens_np = np.full(b, t) if lens is None else np.asarray(lens)
    lens_t = torch.from_numpy(lens_np.astype(np.int32)).to("cuda")
    kw = dict(causal=causal, window=window)
    o, lse = FA.flash_kernel(q, k, v, lens_t, **kw)
    row_by_row = b * h * t * t * 4 > ROW_BY_ROW_BYTES
    rows = [slice(i, i + 1) for i in range(b)] if row_by_row else [
        slice(0, b)]
    err = lse_err = row_err = 0.0
    lse_scale = 1.0
    for r in rows:
        o_ref, lse_ref = FA.flash_attention_reference(q[r], k[r], v[r],
                                                      lens_t[r], **kw)
        diff = (o[r].float() - o_ref.float()).abs()
        err = max(err, diff.max().item())
        if row_relative:
            scale = o_ref.float().abs().amax(dim=-1, keepdim=True)
            row_err = max(row_err, (diff / scale.clamp_min(1e-30)).max()
                          .item())
        del diff
        live = lse_ref > -1e29
        if live.any():
            lse_err = max(lse_err,
                          (lse[r] - lse_ref)[live].abs().max().item())
            lse_scale = max(lse_scale, lse_ref[live].abs().max().item())
        del o_ref, lse_ref
    torch.cuda.synchronize()
    # valid (query, key) pairs of this data, per batch row
    qpos = np.arange(t)[:, None]
    kpos = np.arange(t)[None, :]
    pairs = 0
    for n in lens_np:
        m = kpos < n
        if causal:
            m = m & (qpos >= kpos)
            if window is not None:
                m = m & (qpos - kpos < window)
        pairs += int(m.sum())
    isz = q.element_size()
    bytes_ = (2 * q.numel() * isz + 2 * int(lens_np.sum()) * h * d * isz
              + lse.numel() * 4 + lens_np.size * 4)
    flops = 4 * d * h * pairs
    bound_ms, bound_by = bound(
        bytes_, flops, dtype,
        PEAK_3XTF32 if dtype == torch.float32 else None)
    k_ms = time_ms(lambda: FA.flash_kernel(q, k, v, lens_t, **kw))
    r = rows[0]
    p_ms = time_ms(lambda: FA.flash_attention_reference(
        q[r], k[r], v[r], lens_t[r], **kw), iters=5 if row_by_row else 20)
    lib_ms = lib_err = None
    tol = TOL[dtype]
    if causal and (lens_np == t).all():
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            lib_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        else:
            # the same function: a boolean band mask (causal, `window`
            # keys), checked against A's output so like is timed with like
            pos = torch.arange(t, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (
                pos[:, None] - pos[None, :] < window)
            lib_out = sdpa(qh, kh, vh, attn_mask=band).transpose(1, 2)
            diff = (lib_out.float() - o.float()).abs()
            if row_relative:
                scale = o.float().abs().amax(dim=-1, keepdim=True)
                diff = diff / scale.clamp_min(1e-30)
            lib_err = diff.max().item()
            del lib_out, diff
            lib_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=band))
    # lse is f32 in both versions: hold it to f32's tolerance, relative
    # to its own scale (log-sum-exps grow with the scores)
    held = row_err if row_relative else err
    ok = held <= tol and lse_err <= 1e-4 * lse_scale and (
        lib_err is None or lib_err <= tol)
    lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
    if lib_err is not None:
        lib += f" (band-mask SDPA vs A: err {lib_err:.2e})"
    plain = f"{p_ms:.4f}" + (f" (1 of {b} rows)" if row_by_row else "")
    rel = f" row_rel_err {row_err:.2e}" if row_relative else ""
    log(f"  A {name:<22} {str(dtype)[6:]:<8} err {err:.2e}{rel} lse_err "
        f"{lse_err:.2e} (tol {tol:.0e}) kernel_ms {k_ms:.4f} plain_ms "
        f"{plain} bound_ms {bound_ms:.4f} ({bound_by}) library_ms {lib} "
        f"{'ok' if ok else 'FAIL'}")
    out = dict(name=name, err=err, ok=ok, ms=k_ms, plain_ms=p_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               tol=tol, lse_err=lse_err)
    if row_relative:
        out["row_rel_err"] = row_err
    if lib_err is not None:
        out["library_err"] = lib_err
    return out


def flash_hmma_counts():
    """{instantiation: HMMA instructions} of each flash_fwd_kernel in the
    built library (`cuobjdump --dump-sass`): tensor-core products. Fails
    if an instantiation has none."""
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", str(_cuda.library_path(
            "flash_attention"))], capture_output=True, text=True,
        timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          fn)
            cur = None if m is None else (
                f"{'float32' if m.group(1) == 'f' else 'bfloat16'}, "
                f"D={m.group(2)}")
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    log(f"  flash_fwd_kernel HMMA instructions (cuobjdump --dump-sass): "
        f"{counts}")
    if len(counts) != 4 or not all(counts.values()):
        raise Fail(f"flash_fwd_kernel: an instantiation without tensor-core "
                   f"products, or missing: {counts}")
    return counts


def kernels_phase():
    f32, bf16 = torch.float32, torch.bfloat16
    log("phase kernels: flash attention forward (A)")
    a = {
        "main_prefill_t128": flash_case("main_prefill_t128", b=1, t=128,
                                        h=8),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        a["key_lens" + sfx] = flash_case(
            "key_lens", b=4, t=128, h=8, dtype=dt, lens=[128, 100, 37, 1])
        a["causal_t2048" + sfx] = flash_case("causal_t2048", b=1, t=2048,
                                             h=8, dtype=dt)
        a["window" + sfx] = flash_case("window64_t512", b=2, t=512, h=8,
                                       dtype=dt, window=64, lens=[512, 300])
        a["hd128" + sfx] = flash_case("head_dim128", b=1, t=256, h=4,
                                      d=128, dtype=dt)
        a["no_valid_key" + sfx] = flash_case(
            "no_valid_key", b=2, t=64, h=2, dtype=dt, causal=False,
            lens=[0, 50])
    # bench_transformer_lm's attention (benchmarks/suite.py:331, bf16
    # policy at :759), and f32 scores of std 3 at f32's tolerance
    a["causal_t8192_bf16"] = flash_case("causal_t8192_b4", b=4, t=8192,
                                        h=8, dtype=bf16, row_relative=True)
    # the same shape in f32, as the LM train path feeds A under the bf16
    # policy (the dense layers' f32 biases promote their outputs), full
    # causal and in the LM's window of 1024 keys (tiles skipped before
    # the band); held row by row, as the bf16 case, at f32's tolerance
    a["causal_t8192_f32"] = flash_case("causal_t8192_b4", b=4, t=8192,
                                       h=8, dtype=f32, row_relative=True)
    a["window1024_t8192_f32"] = flash_case(
        "window1024_t8192_b4", b=4, t=8192, h=8, dtype=f32, window=1024,
        row_relative=True)
    a["window1024_t8192_bf16"] = flash_case(
        "window1024_t8192_b4", b=4, t=8192, h=8, dtype=bf16, window=1024,
        row_relative=True)
    a["scaled_scores_float32"] = flash_case("scores_std3_t512", b=2, t=512,
                                            h=8, q_scale=3.0, seed=1)
    # the ring pool's one-shot prefill: a window and a per-row key bound
    # in one launch (bench_decode's swa window), queries past the bound
    # reading the keys of their band below it
    for dt in (f32, bf16):
        a["window128_lens_" + str(dt)[6:]] = flash_case(
            "window128_key_lens", b=4, t=256, h=8, dtype=dt,
            window=RING_WINDOW, lens=[127, 100, 37, 1], seed=2)
    log("phase kernels: ragged paged-attention walk (B)")
    b = {
        "main_decode": ragged_case("main_decode_r8", r=8, tq=1, h=8, hkv=8),
        "main_chunk": ragged_case("main_prefix_chunk_tq64", r=1, tq=64,
                                  h=8, hkv=8, pos0=SHARED),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        b["decode" + sfx] = ragged_case("decode_r8", r=8, tq=1, h=8, hkv=8,
                                        dtype=dt, seed=1)
        b["chunk" + sfx] = ragged_case("prefix_chunk_tq100", r=1, tq=100,
                                       h=8, hkv=8, dtype=dt, pos0=SHARED)
        b["gqa" + sfx] = ragged_case("gqa_h8_hkv2", r=8, tq=4, h=8, hkv=2,
                                     dtype=dt, seed=2)
        b["sentinel" + sfx] = ragged_case(
            "sentinels_inactive", r=8, tq=3, h=8, hkv=4, dtype=dt,
            inactive=2, sentinel_tail=3, seed=3, pos0=[0, 9, 40, 100, 150,
                                                        170, 200, 250][:8])
        b["hd128" + sfx] = ragged_case("head_dim128", r=4, tq=2, h=4,
                                       hkv=2, dh=128, dtype=dt, seed=4)
        # rows that reach max_len (every split holds live keys), and
        # inactive rows whose uniform mean of V spans every split
        b["max_len" + sfx] = ragged_case("decode_pos0_255", r=8, tq=1, h=8,
                                         hkv=8, dtype=dt, pos0=MAX_LEN - 1,
                                         seed=6)
        b["inactive" + sfx] = ragged_case(
            "decode_inactive_splits", r=8, tq=1, h=8, hkv=8, dtype=dt,
            inactive=4, seed=7, pos0=[3, 17, 40, 255, 100, 130, 64, 200])
    log("phase kernels: ragged paged-attention walk, int8 arenas (C)")
    c = {
        "main_decode": ragged_case("main_decode_r8", r=8, tq=1, h=8, hkv=8,
                                   int8=True),
        "main_chunk": ragged_case("main_prefix_chunk_tq64", r=1, tq=64,
                                  h=8, hkv=8, pos0=SHARED, int8=True),
    }
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        c["verify" + sfx] = ragged_case("verify_window_tq5", r=8, tq=5,
                                        h=8, hkv=8, dtype=dt, seed=5,
                                        int8=True)
        c["gqa" + sfx] = ragged_case("gqa_h8_hkv2", r=8, tq=4, h=8, hkv=2,
                                     dtype=dt, seed=2, int8=True)
        c["sentinel" + sfx] = ragged_case(
            "sentinels_inactive", r=8, tq=3, h=8, hkv=4, dtype=dt,
            inactive=2, sentinel_tail=3, seed=3, pos0=[0, 9, 40, 100, 150,
                                                        170, 200, 250],
            int8=True)
        c["hd128" + sfx] = ragged_case("head_dim128", r=4, tq=2, h=4,
                                       hkv=2, dh=128, dtype=dt, seed=4,
                                       int8=True)
    c["decode_bf16"] = ragged_case("decode_r8", r=8, tq=1, h=8, hkv=8,
                                   dtype=bf16, seed=1, int8=True)
    # rows that reach max_len (every split holds live keys), and inactive
    # rows whose uniform mean of V spans every split
    for dt in (f32, bf16):
        sfx = "_" + str(dt)[6:]
        c["max_len" + sfx] = ragged_case("decode_pos0_255", r=8, tq=1, h=8,
                                         hkv=8, dtype=dt, pos0=MAX_LEN - 1,
                                         seed=6, int8=True)
        c["inactive" + sfx] = ragged_case(
            "decode_inactive_splits", r=8, tq=1, h=8, hkv=8, dtype=dt,
            inactive=4, seed=7, pos0=[3, 17, 40, 255, 100, 130, 64, 200],
            int8=True)
    c["chunk_bf16"] = ragged_case("prefix_chunk_tq100", r=1, tq=100, h=8,
                                  hkv=8, dtype=bf16, pos0=SHARED, int8=True)
    bad = [f"{n}:{k}" for n, d in (("A", a), ("B", b), ("C", c))
           for k, v in d.items() if not v["ok"]]
    if bad:
        raise Fail(f"kernel disagrees with its plain version: {bad}")
    return a, b, c


# -- kernels D and E: the fused LSTM time loop ---------------------------------


def abs_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def rel_err(got, ref):
    """max |got - ref| over max |ref|: the LSTM cases' error measure (dW
    sums T*B terms, so its error is relative to its scale)."""
    return abs_err(got, ref) / max(ref.float().abs().max().item(), 1e-30)


def lstm_case_inputs(*, t, b, h, dtype, lengths, reverse, initial, seed):
    """x_proj [T, B, 4H] N(0, 1), w_hh [H, 4H] uniform(+-1/sqrt(H)) (the
    initializer's), both in `dtype`; h0/c0 zero or N(0, 0.25); bounds
    from lengths uniform in [T/2, T] (or full, or `lengths` itself where
    it is an array: a batch's own lengths)."""
    rs = np.random.RandomState(seed)
    dev = "cuda"
    xp = torch.from_numpy(rs.standard_normal((t, b, 4 * h)).astype(
        np.float32)).to(dev, dtype)
    lim = 1.0 / np.sqrt(h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, 4 * h)).astype(
        np.float32)).to(dev, dtype)
    st = lambda: torch.from_numpy(
        (0.5 * rs.standard_normal((b, h))).astype(np.float32)).to(dev)
    h0, c0 = (st(), st()) if initial else (
        torch.zeros(b, h, device=dev), torch.zeros(b, h, device=dev))
    if isinstance(lengths, np.ndarray):        # a batch's own lengths
        lens = lengths
    else:
        lens = rs.randint(t // 2, t + 1, b) if lengths else np.full(b, t)
    ragged = isinstance(lengths, np.ndarray) or lengths
    bounds = FL.make_bounds(b, t, torch.from_numpy(lens).to(dev) if ragged
                            else None, reverse, device=dev)
    return (xp, w, h0, c0, bounds), lens


def cudnn_ms(rnn, t, b, gates):
    """A cuDNN torch.nn recurrent module (TF32 off) on [T, B, F], full
    lengths: (training forward ms, backward ms, input projection ms).
    cuDNN also does the input projection, which the port leaves to
    torch.matmul: its product [T*B, F] x [F, gates*H] is timed on its
    own."""
    rnn = rnn.cuda()
    f, h = rnn.input_size, rnn.hidden_size
    x = torch.randn(t, b, f, device="cuda", requires_grad=True)
    fwd = time_ms(lambda: rnn(x))
    out, _ = rnn(x)
    g = torch.randn_like(out)
    wrt = [x] + list(rnn.parameters())
    bwd = time_ms(lambda: torch.autograd.grad(out, wrt, g,
                                              retain_graph=True))
    w_ih = torch.randn(f, gates * h, device="cuda")
    proj = time_ms(lambda: x.detach().view(t * b, f) @ w_ih)
    return fwd, bwd, proj


def cudnn_lstm_ms(t, b, h):
    """torch.nn.LSTM(h, h) on [T, B, H]; see cudnn_ms."""
    return cudnn_ms(torch.nn.LSTM(h, h), t, b, 4)


def lstm_case(name, *, t=LSTM_T, b=LSTM_B, h=LSTM_H, dtype=torch.float32,
              lengths=False, reverse=False, initial=False, seed=0,
              library=False):
    """Kernels D and E on one case against their plain versions. E gets
    the plain forward's hs/cs and random cotangents."""
    args, lens = lstm_case_inputs(t=t, b=b, h=h, dtype=dtype,
                                  lengths=lengths, reverse=reverse,
                                  initial=initial, seed=seed)
    xp, w = args[0], args[1]
    rs = np.random.RandomState(seed + 100)
    cot = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    dhs, dhl, dcl = cot(t, b, h).to(dtype), cot(b, h), cot(b, h)
    before = FL.device_launches["fwd"]
    hs, cs = FL.lstm_forward_kernel(*args)
    d_ops = FL.device_launches["fwd"] - before
    hs_r, cs_r = FL.lstm_forward_reference(*args)
    bargs = args + (hs_r, cs_r, dhs, dhl, dcl)
    grads = FL.lstm_backward_kernel(*bargs)
    grads_r = FL.lstm_backward_reference(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(FL.lstm_backward_kernel, bargs, grads)
    d_same = bitwise_repeat(FL.lstm_forward_kernel, args, (hs, cs))
    d_pairs = ((hs, hs_r), (cs, cs_r))
    e_pairs = tuple(zip(grads, grads_r))
    d_err = max(rel_err(a, r) for a, r in d_pairs)
    e_err = max(rel_err(a, r) for a, r in e_pairs)
    d_abs = max(abs_err(a, r) for a, r in d_pairs)
    e_abs = max(abs_err(a, r) for a, r in e_pairs)
    # the work this data needs: products only on live (row, step) pairs;
    # each input read once, each output written once
    live = int(lens.sum())
    xsz, wsz = xp.element_size(), w.element_size()
    seq = t * b * h
    common = 4 * seq * xsz + 4 * h * h * wsz + 2 * b * h * 4 + b * 8
    fwd_bytes = common + seq * xsz + seq * 4                   # hs, cs
    bwd_bytes = (common + 2 * seq * xsz + seq * 4 + 2 * b * h * 4
                 + 4 * seq * xsz + 4 * h * h * 4 + 2 * b * h * 4)
    flops_step = 2 * h * 4 * h
    d_bound, d_by = bound(fwd_bytes, live * flops_step, w.dtype)
    e_bound, e_by = bound(bwd_bytes, 3 * live * flops_step, w.dtype)
    d_ms = time_ms(lambda: FL.lstm_forward_kernel(*args))
    e_ms = time_ms(lambda: FL.lstm_backward_kernel(*bargs))
    dp_ms = time_ms(lambda: FL.lstm_forward_reference(*args), iters=3,
                    warmup=1)
    ep_ms = time_ms(lambda: FL.lstm_backward_reference(*bargs), iters=3,
                    warmup=1)
    lib = cudnn_lstm_ms(t, b, h) if library else (None, None, None)
    phases = phase_ms(FL.lstm_backward_kernel, bargs) if library else None
    tol = TOL[dtype]
    out = {}
    for kern, err, a_err, ms, p_ms, b_ms, by, lib_ms in (
            ("D", d_err, d_abs, d_ms, dp_ms, d_bound, d_by, lib[0]),
            ("E", e_err, e_abs, e_ms, ep_ms, e_bound, e_by, lib[1])):
        ok = err <= tol and (same if kern == "E" else
                             d_same and d_ops == 2)
        lib_s = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {kern} {name:<24} {str(dtype)[6:]:<8} rel_err {err:.2e} "
            f"(tol {tol:.0e}) kernel_ms {ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({by}) library_ms {lib_s} "
            f"{'ok' if ok else 'FAIL'}")
        out[kern] = dict(name=name, err=a_err, rel_err=err, ok=ok, ms=ms,
                         plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, tol=tol)
    out["E"].update(bitwise=same, phases_ms=phases)
    out["D"].update(bitwise=d_same, device_launches_per_call=d_ops,
                    us_per_step=d_ms / t * 1e3)
    log(f"    D: {d_ms / t * 1e3:.2f} us per step, {d_ops} device "
        f"operations per call (counters' memset, loop); a second call is "
        f"bitwise equal (hs, cs): {d_same}")
    log(f"    E: a second call on the same inputs is bitwise equal "
        f"(dxp, dW_hh, dh0, dc0): {same}")
    if phases:
        log_phases("E", phases, e_ms, t)
    if library:
        log(f"    cuDNN torch.nn.LSTM({h}, {h}) T={t} B={b}: forward "
            f"{lib[0]:.4f} ms, backward {lib[1]:.4f} ms; its input "
            f"projection [{t * b}, {h}] x [{h}, {4 * h}] alone "
            f"{lib[2]:.4f} ms")
    return out


def lstm_kernels_phase():
    log("phase kernels: fused LSTM time loop, forward (D) and backward (E); "
        f"T={LSTM_T} B={LSTM_B} H={LSTM_H} unless named")
    cases = {
        "main": lstm_case("main_full_f32", library=True),
        "ragged": lstm_case("ragged_len50-100", lengths=True, seed=1),
        "reverse": lstm_case("reverse_ragged", lengths=True, reverse=True,
                             seed=2),
        "initial": lstm_case("nonzero_h0_c0", initial=True, seed=3),
        "h256": lstm_case("h256_b128", h=256, b=128, seed=4, library=True),
        "h1280": lstm_case("h1280_b64", h=1280, seed=5, library=True),
        "bf16": lstm_case("bf16_xproj_whh_ragged", dtype=torch.bfloat16,
                          lengths=True, seed=6),
    }
    bad = [f"{k}:{c}" for c, d in cases.items() for k, v in d.items()
           if not v["ok"]]
    if bad:
        raise Fail(f"LSTM kernel disagrees with its plain version: {bad}")
    return cases


# -- training the LSTM classifier ----------------------------------------------


def bench_lstm_model(impl):
    """bench_lstm's network: embedding -> 2 x LSTM -> mean over time ->
    fc(2). impl None: kernels D and E; "torch": their plain versions."""
    return NM.Sequential([
        NL.Embedding(LSTM_VOCAB, LSTM_H, name="emb"),
        NR.LSTM(LSTM_H, name="lstm1", impl=impl),
        NR.LSTM(LSTM_H, name="lstm2", impl=impl),
        NL.Lambda(lambda x: x.mean(dim=1), name="pool",
                  out_spec_fn=lambda s: NM.ShapeSpec(
                      (s.shape[0], s.shape[2]), s.dtype)),
        NL.Dense(2, name="fc"),
    ])


def ce_loss(logits, labels):
    return torch.mean(LS.softmax_cross_entropy(logits, labels))


def clone_state(st):
    copy = lambda tree: tree_map(lambda t: t.clone(), tree)
    return TrainState(copy(st.params), copy(st.model_state),
                      copy(st.opt_state), st.step.clone())


def grad_rel_err(ga, gb):
    return max(rel_err(a, b) for a, b in zip(tree_leaves(ga),
                                             tree_leaves(gb)))


def timed_train(trainer, state, batches):
    """TRAIN_STEPS steps through Trainer.train with the launch counts set
    to 0 just before: (state, losses, wall seconds, (D, E) launches, (D,
    E) device launches)."""
    events = []
    torch.cuda.synchronize()
    FL.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(
        state, lambda: (batches[i % len(batches)]
                        for i in range(TRAIN_STEPS)),
        event_handler=events.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = (FL.launch_counts["fwd"], FL.launch_counts["bwd"])
    losses = [e.cost for e in events if isinstance(e, EV.EndIteration)]
    return state, losses, wall, launched, (FL.device_launches["fwd"],
                                           FL.device_launches["bwd"])


def train_phase():
    """The bench_lstm classifier at its width through the port's Trainer,
    on kernels D and E and then on their plain versions from the same
    weights: first-step gradients, every step's loss, launches."""
    log(f"phase train: bench_lstm classifier, vocab {LSTM_VOCAB}, emb = "
        f"hidden = {LSTM_H}, 2 x LSTM, mean pool, Dense(2), adam 1e-3, "
        f"B={LSTM_B} T={LSTM_T}, {TRAIN_STEPS} steps over {TRAIN_BATCHES} "
        f"batches")
    rs = np.random.RandomState(3)
    batches = [(rs.randint(0, LSTM_VOCAB, (LSTM_B, LSTM_T)).astype(np.int32),
                rs.randint(0, 2, LSTM_B).astype(np.int32))
               for _ in range(TRAIN_BATCHES)]
    spec = NM.ShapeSpec((LSTM_B, LSTM_T), torch.int32)
    kern = Trainer(bench_lstm_model(None), ce_loss, OPT.adam(1e-3), seed=0)
    plain = Trainer(bench_lstm_model("torch"), ce_loss, OPT.adam(1e-3),
                    seed=0)
    state0 = kern.init_state(spec)

    x, y = (torch.from_numpy(a).cuda() for a in batches[0])
    _, _, gk, _ = loss_and_grads(kern.model, ce_loss, state0.params, {},
                                 None, (x,), (y,))
    _, _, gp, _ = loss_and_grads(plain.model, ce_loss, state0.params, {},
                                 None, (x,), (y,))
    g_err = grad_rel_err(gk, gp)
    log(f"  first-step gradients, kernel vs plain path: max rel err "
        f"{g_err:.2e} (tol {GRAD_RTOL:.0e})")
    if g_err > GRAD_RTOL:
        raise Fail(f"train: first-step gradients differ: {g_err:.2e}")

    for tr in (kern, plain):     # warm the allocator and cuBLAS
        tr.train(clone_state(state0), lambda: batches[:1])
    _, k_loss, k_wall, k_launch, k_dev = timed_train(
        kern, clone_state(state0), batches)
    _, p_loss, p_wall, p_launch, p_dev = timed_train(
        plain, clone_state(state0), batches)
    tokens = TRAIN_STEPS * LSTM_B * LSTM_T
    out = dict(steps=TRAIN_STEPS, kernel_ms_per_step=1e3 * k_wall /
               TRAIN_STEPS, kernel_tok_s=tokens / k_wall,
               plain_ms_per_step=1e3 * p_wall / TRAIN_STEPS,
               plain_tok_s=tokens / p_wall, grad_rel_err=g_err,
               losses=k_loss, plain_losses=p_loss,
               launches={"D": k_launch[0], "E": k_launch[1]},
               device_launches={"D": k_dev[0], "E": k_dev[1]})
    log(f"  kernel path: {out['kernel_ms_per_step']:.3f} ms/step = "
        f"{out['kernel_tok_s']:.1f} tokens/s; launches D {k_launch[0]} "
        f"({k_dev[0]} device operations), E {k_launch[1]} ({k_dev[1]} "
        f"device launches); losses {['%.6f' % v for v in k_loss]}")
    log(f"  plain path:  {out['plain_ms_per_step']:.3f} ms/step = "
        f"{out['plain_tok_s']:.1f} tokens/s; launches {p_launch}; losses "
        f"{['%.6f' % v for v in p_loss]}")
    want = (2 * TRAIN_STEPS, 2 * TRAIN_STEPS)
    if k_launch != want:
        raise Fail(f"train: (D, E) launched {k_launch} times, want {want} "
                   f"(2 of each per step)")
    if k_dev[0] != 2 * k_launch[0]:
        raise Fail(f"train: {k_launch[0]} D calls made {k_dev[0]} device "
                   f"operations, not 2 each (memset, loop)")
    if k_dev[1] < 3 * k_launch[1]:
        raise Fail(f"train: {k_launch[1]} E calls made {k_dev[1]} device "
                   f"launches, fewer than their three phases")
    if p_launch != (0, 0) or any(p_dev):
        raise Fail(f"train: the plain path launched kernels: {p_launch}, "
                   f"{p_dev} device launches of D and E")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    out["loss_rel_err"] = rel
    log(f"  losses agree to {rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if len(k_loss) != TRAIN_STEPS or not all(np.isfinite(k_loss)) or \
            rel > LOSS_RTOL:
        raise Fail(f"train: kernel and plain losses differ: {rel:.2e}")
    return out


# -- the fault-tolerant train entry point at bench_lstm's width ----------------

# bench_lstm's network and width (benchmarks/suite.py:144-186) fed by the
# synthetic text classification reader over its vocabulary, padded to 100;
# each sample carries an f32 weight of 1.0 and the loss is mean(w * CE),
# bench_lstm's loss, so a NaN-poisoned batch (testing.faults poisons
# float columns) carries a real NaN through D's forward and E's backward
RES_BATCHES, RES_CKPT_EVERY, RES_PREEMPT_AFTER = 32, 8, 13
RES_FAULT_BATCHES, RES_NAN_AT, RES_TIMED = 12, 5, 10
RES_EVAL_BATCHES, RES_CLI_TIMEOUT = 8, 600
ACCUM_LOSS_RTOL, ACCUM_GRAD_RTOL, CHECKGRAD_TOL, AUC_TOL = 1e-5, 1e-4, 1e-5, \
    1e-3

RES_CONFIG = '''
"""bench_lstm's classifier for `python -m paddle_tpu_torch train`: vocab
{vocab}, embedding = hidden = {hidden}, 2 x LSTM, mean over time, Dense(2),
adam 1e-3; synthetic text classification padded to {t} with an f32 weight
of 1.0 per sample and the loss mean(w * CE)."""

import atexit

import numpy as np
import torch

from paddle_tpu_torch.data import datasets
from paddle_tpu_torch.nn import layers, module, recurrent
from paddle_tpu_torch.ops import fused_lstm, losses
from paddle_tpu_torch.optim import optimizers

VOCAB, HIDDEN, T, B, BATCHES = {vocab}, {hidden}, {t}, {b}, {batches}


def reader(n=B * BATCHES, seed=0):
    text = datasets.synthetic_text_classification(
        vocab_size=VOCAB, max_len=T, n=n, seed=seed)

    def samples():
        for tokens, label in text():
            padded = np.zeros(T, np.int32)
            padded[:len(tokens)] = tokens
            yield padded, np.int64(label), np.float32(1.0)

    return samples


def weighted_ce(logits, labels, weights):
    return torch.mean(weights * losses.softmax_cross_entropy(logits, labels))


def model(impl=None):
    return module.Sequential([
        layers.Embedding(VOCAB, HIDDEN, name="emb"),
        recurrent.LSTM(HIDDEN, name="lstm1", impl=impl),
        recurrent.LSTM(HIDDEN, name="lstm2", impl=impl),
        layers.Lambda(lambda x: x.mean(dim=1), name="pool",
                      out_spec_fn=lambda s: module.ShapeSpec(
                          (s.shape[0], s.shape[2]), s.dtype)),
        layers.Dense(2, name="fc"),
    ])


def _report_launches():
    print("kernel launches: D %d E %d" % (fused_lstm.launch_counts["fwd"],
                                         fused_lstm.launch_counts["bwd"]),
          flush=True)


def get_config():
    # the process's launches of D and E, printed as it exits
    atexit.register(_report_launches)
    return {{"model": model(), "input_spec": module.ShapeSpec((B, T),
                                                              torch.int32),
             "loss_fn": weighted_ce, "optimizer": optimizers.adam(1e-3),
             "reader": reader(), "num_passes": 1}}
'''


def res_launches(stdout):
    """(D, E) launches a CLI child printed as it exited."""
    m = re.search(r"kernel launches: D (\d+) E (\d+)", stdout)
    if m is None:
        raise Fail(f"resilient: the CLI child printed no launch counts:\n"
                   f"{stdout[-2000:]}")
    return int(m.group(1)), int(m.group(2))


def res_cli_run(argv, what, want_rc=0, preempt_after=None):
    """Run one `python -m paddle_tpu_torch train` child: (stdout, wall s).
    With preempt_after, SIGTERM it once it has logged that batch."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryFile("w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=root, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        try:
            lines = []
            if preempt_after is not None:
                for line in proc.stdout:
                    lines.append(line)
                    if line.startswith(f"pass 0 batch {preempt_after} "):
                        proc.send_signal(signal.SIGTERM)
                        break
            rest, _ = proc.communicate(timeout=RES_CLI_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        out = "".join(lines) + rest
        if proc.returncode != want_rc:
            err.seek(0)
            raise Fail(f"resilient: {what} exited {proc.returncode}, want "
                       f"{want_rc}:\n{out[-2000:]}\n{err.read()[-3000:]}")
    log(f"  {what}: exit {proc.returncode} in {wall:.1f} s")
    return out, wall


class _Cols(MET.Evaluator):
    """An evaluator over (logits, labels, weights): fn(logits) and the
    labels go to the wrapped one (the weights are the loss's)."""

    def __init__(self, inner, fn=lambda o: o):
        self.inner, self.fn, self.name = inner, fn, inner.name

    def reset(self):
        self.inner.reset()

    def update(self, logits, labels, weights):
        self.inner.update(self.fn(logits), labels)

    def result(self):
        return self.inner.result()


class _Keep(MET.Evaluator):
    name = "outputs"

    def reset(self):
        self.rows = []

    def update(self, logits, labels, weights):
        self.rows.append((logits, labels))

    def result(self):
        return len(self.rows)


def _p1(logits):
    z = logits - logits.max(-1, keepdims=True)
    e = np.exp(z.astype(np.float64))
    return e[:, 1] / e.sum(-1)


def res_evaluate(cfg, params):
    """evaluate() with ClassificationError, Auc and PrecisionRecall on a
    held-out reader, on the kernels and on impl="torch" from the same
    params."""
    feeder = TDATA.DataFeeder(device="cuda")
    held = cfg["reader"](n=LSTM_B * RES_EVAL_BATCHES, seed=1)
    out = {}
    for impl in (None, "torch"):
        tr = Trainer(cfg["model"](impl), cfg["weighted_ce"], OPT.adam(1e-3),
                     device="cuda")
        keep = _Keep()
        evs = [_Cols(MET.ClassificationErrorEvaluator()),
               _Cols(MET.AucEvaluator(), _p1),
               _Cols(MET.PrecisionRecallEvaluator(2)), keep]
        st = TrainState.create(params, {}, tr.optimizer)
        res = tr.evaluate(st, lambda: feeder(TDATA.batch_reader(held,
                                                                LSTM_B)),
                          evaluators=evs)
        out[impl or "kernel"] = (res, np.concatenate([r[0] for r in
                                                      keep.rows]),
                                 np.concatenate([r[1] for r in keep.rows]))
    (rk, lk, y), (rp, lp, _) = out["kernel"], out["torch"]
    gap = np.abs(lp[:, 1] - lp[:, 0])
    differ = lk.argmax(-1) != lp.argmax(-1)
    bad = int((differ & (gap > GAP_LIMIT)).sum())
    wrong_k, wrong_p = int((lk.argmax(-1) != y).sum()), int(
        (lp.argmax(-1) != y).sum())
    auc_k, auc_p = rk.metrics["auc"], rp.metrics["auc"]
    r = dict(rows=int(y.size), wrong_kernel=wrong_k, wrong_plain=wrong_p,
             rows_differing=int(differ.sum()), near_ties=int(
                 (gap <= GAP_LIMIT).sum()), auc_kernel=auc_k,
             auc_plain=auc_p, cost_kernel=rk.cost, cost_plain=rp.cost,
             metrics_kernel=rk.metrics, metrics_plain=rp.metrics)
    log(f"  evaluate on {y.size} held-out rows: errors kernel {wrong_k} "
        f"plain {wrong_p} (rows whose argmax differs {int(differ.sum())}, "
        f"of them past a gap of {GAP_LIMIT:.0e}: {bad}); auc {auc_k:.6f} vs "
        f"{auc_p:.6f}; precision_recall/f1 "
        f"{rk.metrics['precision_recall/f1']:.6f} vs "
        f"{rp.metrics['precision_recall/f1']:.6f}; classification_error "
        f"{rk.metrics['classification_error']:.6f} vs "
        f"{rp.metrics['classification_error']:.6f}")
    if bad or abs(wrong_k - wrong_p) > int(differ.sum()) or \
            abs(auc_k - auc_p) > AUC_TOL:
        raise Fail(f"resilient: evaluate on the kernels and the plain path "
                   f"disagree: {r}")
    return r


def res_capture():
    """An optimizer that applies nothing and keeps each step's gradients
    (the step returns none)."""
    got = []

    def update(grads, opt_state, params, step):
        got.append(grads)
        return params, opt_state

    return OPT.Optimizer(lambda p: (), update), got


def res_options(cfg, state0, batch):
    """accum_steps=4 against 1 and remat against plain on one batch."""
    x, y, w = batch
    out = {}
    grads, losses = {}, {}
    for name, kw in (("plain", {}), ("accum4", dict(accum_steps=4)),
                     ("remat", dict(remat=True))):
        opt, got = res_capture()
        step = make_train_step(cfg["model"](), cfg["weighted_ce"], opt,
                               donate=False, **kw)
        _, loss, _ = step(state0, None, (x,), (y, w))
        grads[name] = tree_leaves(got[0])
        losses[name] = float(loss)
    loss_rel = abs(losses["accum4"] - losses["plain"]) / abs(losses["plain"])
    g_rel, lines = leaf_rel_errs(state0.params, grads["accum4"],
                                 grads["plain"])
    log(f"  accum_steps=4 vs 1 on one batch: loss {losses['accum4']:.7f} vs "
        f"{losses['plain']:.7f} (rel {loss_rel:.2e}, tol "
        f"{ACCUM_LOSS_RTOL:.0e}); gradients max leaf rel {g_rel:.2e} (tol "
        f"{ACCUM_GRAD_RTOL:.0e})")
    for line in lines:
        log(line)
    names = []
    tree_map_with_name(lambda n, _: names.append(n), state0.params)
    remat_diff = [(n, abs_err(a, b)) for n, a, b in zip(
        names, grads["remat"], grads["plain"]) if not torch.equal(a, b)]
    log(f"  remat vs plain gradients: "
        f"{'bit for bit equal' if not remat_diff else remat_diff}; loss "
        f"{losses['remat']:.7f} vs {losses['plain']:.7f}")
    out.update(accum_loss_rel_err=loss_rel, accum_grad_rel_err=g_rel,
               remat_bitwise=not remat_diff, remat_leaves_differing=
               remat_diff, losses=losses)
    if loss_rel > ACCUM_LOSS_RTOL or g_rel > ACCUM_GRAD_RTOL:
        raise Fail(f"resilient: accum_steps=4 disagrees with one step: loss "
                   f"{loss_rel:.2e}, gradients {g_rel:.2e}")
    if remat_diff or losses["remat"] != losses["plain"]:
        raise Fail(f"resilient: remat's gradients differ from the plain "
                   f"step's: {remat_diff}")
    return out


def res_optimizers(params, grads):
    """Each optimizer, chain (clip + decay) and with_pruning: two updates
    (gradients g, then g/2) on the card against the same updates on CPU
    copies; the update's device ms."""
    masks = HOOKS.magnitude_masks(params, 0.5)
    cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
    decay = lambda name: name.endswith("kernel") or name.endswith("w_hh")
    cases = [
        ("sgd", lambda m: OPT.sgd(1e-2), 1e-5),
        ("momentum", lambda m: OPT.momentum(1e-2, mu=0.9), 1e-5),
        ("adagrad", lambda m: OPT.adagrad(1e-2), 1e-5),
        ("decayed_adagrad", lambda m: OPT.decayed_adagrad(1e-2), 1e-5),
        ("adadelta", lambda m: OPT.adadelta(), 1e-5),
        ("rmsprop", lambda m: OPT.rmsprop(1e-3, momentum_mu=0.9), 1e-5),
        ("adam", lambda m: OPT.adam(1e-3), 1e-5),
        ("adamax", lambda m: OPT.adamax(2e-3), 1e-5),
        ("ftrl", lambda m: OPT.ftrl(1e-2, l1=1e-4, l2=1e-4), 1e-5),
        ("lbfgs", lambda m: OPT.lbfgs(1e-2), 1e-4),
        ("owlqn", lambda m: OPT.owlqn(1e-2, l1=1e-4), 1e-4),
        ("proximal_gd", lambda m: OPT.proximal_gd(1e-2, l1=1e-4, l2=1e-4),
         1e-5),
        ("chain(clip+decay)", lambda m: OPT.chain(
            OPT.adam(1e-3), weight_decay=1e-4, clip_global_norm=1.0,
            clip_value=1e-2, decay_mask=decay), 1e-4),
        ("with_pruning", lambda m: HOOKS.with_pruning(
            OPT.momentum(1e-2), m), 1e-5),
    ]
    half = tree_map(lambda g: 0.5 * g, grads)
    out = {}
    for name, make, tol in cases:
        p_card = tree_map(lambda t: t.detach().clone(), params)
        p_cpu = cpu(params)
        o_card, o_cpu = make(masks), make(cpu(masks))
        s_card, s_cpu = o_card.init(p_card), o_cpu.init(p_cpu)
        for k, (g_card, g_cpu) in enumerate(((grads, cpu(grads)),
                                             (half, cpu(half)))):
            o_card.update(g_card, s_card, p_card,
                          torch.tensor(k, dtype=torch.int32, device="cuda"))
            o_cpu.update(g_cpu, s_cpu, p_cpu, torch.tensor(k,
                                                           dtype=torch.int32))
        err = max(rel_err(a.cpu(), b) for a, b in zip(tree_leaves(p_card),
                                                       tree_leaves(p_cpu)))
        step2 = torch.tensor(2, dtype=torch.int32, device="cuda")
        ms = time_ms(lambda: o_card.update(half, s_card, p_card, step2),
                     iters=10, warmup=2)
        out[name] = dict(rel_err=err, tol=tol, update_ms=ms)
        log(f"  {name:<18} two updates, card vs CPU: max rel err {err:.2e} "
            f"(tol {tol:.0e}); update {ms:.4f} ms")
        del s_card, s_cpu, p_card, p_cpu
        if not err <= tol:
            raise Fail(f"resilient: {name}'s update on the card disagrees "
                       f"with the CPU's: {err:.2e}")
    return out


def res_fault_runs(cfg, tmp, state0, factory):
    """NaN under skip and rollback + LR backoff; a checkpoint write error
    on the 2nd save."""
    out = {}
    spec = NM.ShapeSpec((LSTM_B, LSTM_T), torch.int32)
    for policy, kw in (("skip", {}), ("rollback", dict(
            lr_backoff=0.5, checkpoint_every_n_batches=4))):
        tr = Trainer(cfg["model"](), cfg["weighted_ce"], OPT.adam(1e-3),
                     seed=0, device="cuda")
        plan = FaultPlan(nan_batch_at=RES_NAN_AT)
        rt = RS.ResilientTrainer(tr, os.path.join(tmp, policy), max_to_keep=2,
                                 bad_step_policy=policy, **kw)
        t0 = time.perf_counter()
        end = rt.run(clone_state(state0), plan.wrap_batches(factory))
        torch.cuda.synchronize()
        bad = [(b.step, b.action, b.reason) for b in rt.bad_steps]
        finite = all(bool(torch.isfinite(t).all())
                     for t in tree_leaves(end.params))
        log(f"  NaN at batch {RES_NAN_AT}, {policy}"
            f"{' + lr_backoff 0.5' if kw else ''}: bad steps {bad}, final "
            f"step {int(end.step)}, params finite {finite}, lr scale "
            f"{rt.counters()['lr_scale']} ({time.perf_counter() - t0:.1f} s)")
        if bad != [(RES_NAN_AT, policy, "non-finite loss")] or not finite \
                or int(end.step) != RES_FAULT_BATCHES:
            raise Fail(f"resilient: the {policy} run went wrong: {bad}, "
                       f"finite {finite}, step {int(end.step)}")
        out[policy] = dict(bad_steps=bad, finite=finite,
                           lr_scale=rt.counters()["lr_scale"])
        if policy == "skip":
            # the clean run: the same steps over the batches without batch
            # k, each at the step index the skip run gave it
            st = clone_state(state0)
            gen = torch.Generator(device="cuda")
            for gidx, batch in enumerate(factory()):
                if gidx == RES_NAN_AT:
                    st = st._replace(step=st.step + 1)
                    continue
                gen.manual_seed(RS.step_seed(tr.seed, gidx))
                st, _, _ = tr._train_step(st, gen, *tr._split_batch(batch))
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(end.params) + tree_leaves(end.opt_state),
                tree_leaves(st.params) + tree_leaves(st.opt_state)))
            log(f"  skip run vs a clean run without batch {RES_NAN_AT}: "
                f"{'bit for bit equal' if same else 'DIFFER'}")
            out["skip"]["bitwise_clean_run"] = same
            if not same:
                raise Fail("resilient: the skip run differs from a clean run "
                           "without the poisoned batch")
    tr = Trainer(cfg["model"](), cfg["weighted_ce"], OPT.adam(1e-3), seed=0,
                 device="cuda")
    plan = FaultPlan(checkpoint_error_at=1)
    mgr = plan.wrap_checkpoint_manager(
        CK.CheckpointManager(os.path.join(tmp, "flaky"), max_to_keep=2))
    rt = RS.ResilientTrainer(tr, os.path.join(tmp, "flaky"),
                             checkpoint_every_n_batches=4,
                             checkpoint_manager=mgr)
    end = rt.run(clone_state(state0), factory)
    log(f"  checkpoint write error on save #1: save_errors "
        f"{rt.save_errors}, final step {int(end.step)}, latest checkpoint "
        f"{mgr.latest_step()}")
    if len(rt.save_errors) != 1 or int(end.step) != RES_FAULT_BATCHES or \
            mgr.latest_step() != RES_FAULT_BATCHES:
        raise Fail(f"resilient: the checkpoint write error was not absorbed:"
                   f" {rt.save_errors}, step {int(end.step)}")
    out["save_errors"] = list(rt.save_errors)
    return out


def res_times(cfg, tmp, state0, batches):
    """ms/step over 1 + RES_TIMED steps ending in a sync: Trainer.train,
    ResilientTrainer.run (its guard reads the loss every step), the step
    with accum_steps=4 and with remat; D and E launches per step."""
    out = {}

    def timed(name, run, steps):
        torch.cuda.synchronize()
        FL.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        d, e = FL.launch_counts["fwd"], FL.launch_counts["bwd"]
        out[name] = dict(ms_per_step=ms, d_per_step=d / steps,
                         e_per_step=e / steps)
        log(f"  {name:<22} {ms:.3f} ms/step; per step D {d / steps:g}, "
            f"E {e / steps:g}")

    tr = Trainer(cfg["model"](), cfg["weighted_ce"], OPT.adam(1e-3), seed=0,
                 device="cuda")
    warm = tr.train(clone_state(state0), lambda: batches[:1])
    timed("Trainer.train", lambda: tr.train(warm, lambda: batches[1:]),
          RES_TIMED)

    # the resilient run's steps, from the end of its first step (the
    # checkpoint of step 0 is written before it) to the end of its last
    # (the pass-end save comes after): its guard syncs every step
    rt = RS.ResilientTrainer(tr, os.path.join(tmp, "timed"), max_to_keep=1)
    marks = []

    def mark(ev):
        if isinstance(ev, EV.EndIteration):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), FL.launch_counts["fwd"],
                          FL.launch_counts["bwd"]))

    FL.reset_launch_counts()
    rt.run(clone_state(state0), lambda: iter(batches), event_handler=mark)
    (t0, d0, e0), (t1, d1, e1) = marks[0], marks[-1]
    steps = len(marks) - 1
    out["ResilientTrainer.run"] = dict(
        ms_per_step=1e3 * (t1 - t0) / steps, d_per_step=(d1 - d0) / steps,
        e_per_step=(e1 - e0) / steps, launches_in_run=dict(D=d1, E=e1),
        steps=len(marks))
    log(f"  {'ResilientTrainer.run':<22} "
        f"{out['ResilientTrainer.run']['ms_per_step']:.3f} ms/step; per "
        f"step D {(d1 - d0) / steps:g}, E {(e1 - e0) / steps:g}; the run "
        f"launched D {d1} and E {e1} times in {len(marks)} steps")

    for name, kw in (("accum_steps=4", dict(accum_steps=4)),
                     ("remat", dict(remat=True))):
        step = make_train_step(cfg["model"](), cfg["weighted_ce"],
                               OPT.adam(1e-3), **kw)
        s = clone_state(state0)
        x, y, w = batches[0]
        s, _, _ = step(s, None, (x,), (y, w))
        holder = [s]

        def run(step=step, holder=holder):
            for x, y, w in batches[1:]:
                holder[0], _, _ = step(holder[0], None, (x,), (y, w))

        timed(name, run, RES_TIMED)
    return out


def resilient_phase():
    """The training stack's options and the fault-tolerant `train` entry
    point at bench_lstm's width, on kernels D and E."""
    log(f"phase resilient: bench_lstm classifier (vocab {LSTM_VOCAB}, "
        f"hidden {LSTM_H}, 2 x LSTM, B={LSTM_B} T={LSTM_T}, adam 1e-3) "
        f"through `python -m paddle_tpu_torch train`, ResilientTrainer, "
        f"the step's options, the optimizers and the evaluators")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cfg.py")
        with open(cfg_path, "w") as f:
            f.write(RES_CONFIG.format(vocab=LSTM_VOCAB, hidden=LSTM_H,
                                      t=LSTM_T, b=LSTM_B,
                                      batches=RES_BATCHES))
        cfg = runpy.run_path(cfg_path)

        def cli(name):
            return [sys.executable, "-u", "-m", "paddle_tpu_torch", "train",
                    "--config", cfg_path, "--batch-size", str(LSTM_B),
                    "--checkpoint-dir", os.path.join(tmp, name),
                    "--checkpoint-every", str(RES_CKPT_EVERY), "--save-dir",
                    os.path.join(tmp, "save_" + name), "--log-period", "1"]

        # 1. uninterrupted, beside 2. SIGTERM after batch 13, drain, exit
        # 143 (two processes on the card at once); the rerun resumes from
        # the drain save
        with ThreadPoolExecutor(1) as pool:
            ref_run = pool.submit(res_cli_run, cli("A"), f"uninterrupted "
                                  f"CLI run ({RES_BATCHES} batches)")
            pre_out, pre_wall = res_cli_run(
                cli("B"), f"CLI run, SIGTERM after batch "
                f"{RES_PREEMPT_AFTER}", want_rc=143,
                preempt_after=RES_PREEMPT_AFTER)
            ref_out, ref_wall = ref_run.result()
        m = re.search(r"checkpoint saved at step (\d+)", pre_out)
        if m is None:
            raise Fail(f"resilient: the preempted child did not report its "
                       f"drain save:\n{pre_out[-2000:]}")
        drained = int(m.group(1))
        res_out, res_wall = res_cli_run(cli("B"), f"resumed CLI run (from "
                                        f"step {drained})")
        launches = {"uninterrupted": res_launches(ref_out),
                    "preempted": res_launches(pre_out),
                    "resumed": res_launches(res_out)}
        want = {"uninterrupted": 2 * RES_BATCHES, "preempted": 2 * drained,
                "resumed": 2 * (RES_BATCHES - drained)}
        log(f"  drained at step {drained}; (D, E) launches per child "
            f"{launches}, want 2 of each per step {want}")
        for k, (d, e) in launches.items():
            if d != want[k] or e != want[k]:
                raise Fail(f"resilient: the {k} CLI child launched D {d}, E "
                           f"{e} times, want {want[k]} of each")
        with open(os.path.join(tmp, "save_A", "params.tar"), "rb") as f:
            tar_a = f.read()
        with open(os.path.join(tmp, "save_B", "params.tar"), "rb") as f:
            tar_b = f.read()
        same = tar_a == tar_b
        spec = NM.ShapeSpec((LSTM_B, LSTM_T), torch.int32)
        template = cfg["model"]().init(0, spec, device="cuda")[0]
        trained = CK.load_parameters_tar(template, os.path.join(
            tmp, "save_A", "params.tar"))
        log(f"  params.tar of the preempted and resumed run vs the "
            f"uninterrupted one: {len(tar_b)} vs {len(tar_a)} bytes, "
            f"{'byte-identical' if same else 'DIFFERENT'}")
        if not same:
            other = CK.load_parameters_tar(template, os.path.join(
                tmp, "save_B", "params.tar"))
            names = []
            tree_map_with_name(lambda n, _: names.append(n), trained)
            for n, a, b in zip(names, tree_leaves(trained),
                               tree_leaves(other)):
                log(f"    {n:<16} max abs diff {abs_err(a, b):.3e}")
            raise Fail("resilient: the resumed run's params.tar differs "
                       "from the uninterrupted run's")
        out["cli"] = dict(drained_step=drained, byte_identical=same,
                          tar_bytes=len(tar_a), launches=launches,
                          wall_s=dict(uninterrupted=ref_wall,
                                      preempted=pre_wall, resumed=res_wall))

        # 3. faults in process, on the card
        feeder = TDATA.DataFeeder(device="cuda")
        fault_reader = cfg["reader"](n=LSTM_B * RES_FAULT_BATCHES)
        device_batches = list(feeder(TDATA.batch_reader(fault_reader,
                                                        LSTM_B)))
        factory = lambda: iter(device_batches)
        tr0 = Trainer(cfg["model"](), cfg["weighted_ce"], OPT.adam(1e-3),
                      seed=0, device="cuda")
        state0 = tr0.init_state(spec)
        out["faults"] = res_fault_runs(cfg, tmp, state0, factory)

        # 4. the options, the optimizers, evaluate, check_gradients
        x, y, w = device_batches[0]
        out["options"] = res_options(cfg, state0, (x, y, w))
        _, _, grads, _ = loss_and_grads(tr0.model, cfg["weighted_ce"],
                                        state0.params, {}, None, (x,),
                                        (y, w))
        out["optimizers"] = res_optimizers(state0.params, grads)
        del grads
        out["evaluate"] = res_evaluate(cfg, trained)
        gc_state = TrainState.create(trained, {}, tr0.optimizer)
        batch = tuple(t.cpu().numpy() for t in device_batches[0])
        worst = Trainer(cfg["model"]("scan"), cfg["weighted_ce"],
                        OPT.sgd(), device="cuda").check_gradients(gc_state,
                                                                  batch)
        try:
            Trainer(cfg["model"](), cfg["weighted_ce"], OPT.sgd(),
                    device="cuda").check_gradients(gc_state, batch)
            refused = None
        except ValueError as e:
            refused = str(e)
        log(f"  check_gradients in float64 (impl='scan', the f64-capable "
            f"path): worst rel err {worst:.3e} (tol {CHECKGRAD_TOL:.0e}); "
            f"on the kernels (impl None): {refused}")
        out["check_gradients"] = dict(worst_rel_err=worst,
                                      kernel_path_refused=refused)
        if not worst <= CHECKGRAD_TOL or refused is None or \
                "float32 or bfloat16" not in refused:
            raise Fail(f"resilient: check_gradients: {worst:.3e}, kernel "
                       f"path: {refused}")

        # 5. times
        out["times"] = res_times(cfg, tmp, state0, device_batches[
            :RES_TIMED + 1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out["card"] = card
    return out


def ragged_phase():
    """text_lstm at the same width (embed 512, hidden 512, max pool) on
    lengths uniform in [50, 100]: one forward and backward on kernels D
    and E, its gradients held against the plain path's."""
    log("phase ragged: text_lstm, embed = hidden = 512, max pool, B=64, "
        "T=100, lengths uniform in [50, 100]")
    rs = np.random.RandomState(4)
    params = TTL.init_params(rs, LSTM_VOCAB, embed_dim=LSTM_H,
                             hidden=LSTM_H, device="cuda")
    tokens = torch.from_numpy(rs.randint(0, LSTM_VOCAB, (LSTM_B, LSTM_T))
                              .astype(np.int32)).cuda()
    lens = torch.from_numpy(rs.randint(LSTM_T // 2, LSTM_T + 1,
                                      LSTM_B)).cuda()
    labels = torch.from_numpy(rs.randint(0, 2, LSTM_B)).cuda()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(impl):
        logits = TTL.apply(params, tokens, lens, pool="max", impl=impl)
        loss = ce_loss(logits, labels)
        return loss.item(), torch.autograd.grad(loss, leaves)

    torch.cuda.synchronize()
    FL.reset_launch_counts()
    k_loss, gk = grads(None)
    launched = (FL.launch_counts["fwd"], FL.launch_counts["bwd"])
    p_loss, gp = grads("torch")
    err = grad_rel_err(gk, gp)
    log(f"  loss kernel {k_loss:.6f} plain {p_loss:.6f}; gradients max rel "
        f"err {err:.2e} (tol {GRAD_RTOL:.0e}); launches D {launched[0]}, "
        f"E {launched[1]}")
    if launched != (2, 2):
        raise Fail(f"ragged: (D, E) launched {launched} times, want (2, 2)")
    if err > GRAD_RTOL or abs(k_loss - p_loss) > LOSS_RTOL * abs(p_loss):
        raise Fail(f"ragged: kernel and plain paths differ: grads {err:.2e}")
    return dict(loss=k_loss, plain_loss=p_loss, grad_rel_err=err,
                launches={"D": launched[0], "E": launched[1]})


# -- kernels F, G (GRU) and H, I (tanh RNN): the other fused time loops -------

# (forward, plain forward, backward, plain backward, gates, products per
# live step in the backward, does the backward read x_proj, the
# backward's phases, the wrappers' device-operation counts)
GRU_LOOP = (FG.gru_forward_kernel, FG.gru_forward_reference,
            FG.gru_backward_kernel, FG.gru_backward_reference, 3, 3, True,
            PHASES, FG.device_launches)
RNN_LOOP = (FR.rnn_forward_kernel, FR.rnn_forward_reference,
            FR.rnn_backward_kernel, FR.rnn_backward_reference, 1, 2, False,
            ("loop", "dw"), FR.device_launches)


def time_loop_case(loop, names, name, *, t, b, h, dtype=torch.float32,
                   lengths=False, reverse=False, initial=False, seed=0,
                   library=None):
    """One GRU or RNN time-loop case: the forward and backward kernels
    against their plain versions, the backward on the plain forward's hs
    and random cotangents. x_proj [T, B, gates*H] N(0, 1) and w_hh
    uniform(+-1/sqrt(H)) in `dtype`, h0 zero or N(0, 0.25), lengths
    uniform in [T/2, T] (or full). `library` is (cuDNN module, its input
    width), timed with cudnn_ms. The phased backward (G: three phases,
    I: two) must also repeat its outputs bit for bit, and its phases are
    timed beside cuDNN. The forward (F, H: the forward loop of
    time_loop.cuh) must repeat hs bit for bit and make 2 device
    operations per call (its counters' memset, the loop)."""
    (fwd_k, fwd_r, bwd_k, bwd_r, gates, bwd_products, bwd_xp, phase_set,
     device) = loop
    rs = np.random.RandomState(seed)
    dev = "cuda"
    xp = torch.from_numpy(rs.standard_normal((t, b, gates * h)).astype(
        np.float32)).to(dev, dtype)
    lim = 1.0 / np.sqrt(h)
    w = torch.from_numpy(rs.uniform(-lim, lim, (h, gates * h)).astype(
        np.float32)).to(dev, dtype)
    h0 = (torch.from_numpy((0.5 * rs.standard_normal((b, h))).astype(
        np.float32)).to(dev) if initial else torch.zeros(b, h, device=dev))
    lens = rs.randint(t // 2, t + 1, b) if lengths else np.full(b, t)
    bounds = FG.make_bounds(b, t, torch.from_numpy(lens).to(dev)
                            if lengths else None, reverse, device=dev)
    args = (xp, w, h0, bounds)
    cot = np.random.RandomState(seed + 100)
    dhs = torch.from_numpy(cot.standard_normal((t, b, h)).astype(
        np.float32)).to(dev)
    dhl = torch.from_numpy(cot.standard_normal((b, h)).astype(
        np.float32)).to(dev)
    before = device["fwd"]
    hs = fwd_k(*args)
    d_ops = device["fwd"] - before
    hs_r = fwd_r(*args)
    bargs = args + (hs_r, dhs, dhl)
    grads = bwd_k(*bargs)
    grads_r = bwd_r(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(bwd_k, bargs, grads)
    # the forward too (F and H, on the forward loop, must repeat)
    fwd_same = bitwise_repeat(lambda *a: (fwd_k(*a),), args, (hs,))
    pairs = {names[0]: ((hs, hs_r),), names[1]: tuple(zip(grads, grads_r))}
    # the work this data needs: products only on live (row, step) pairs;
    # each input read once, each output written once
    live = int(lens.sum())
    xsz, wsz = xp.element_size(), w.element_size()
    seq, state = t * b * h, b * h * 4
    common = gates * h * h * wsz + state + b * 8          # w_hh, h0, bounds
    fwd_bytes = common + gates * seq * xsz + seq * 4      # x_proj; hs
    bwd_bytes = (common + (gates * seq * xsz if bwd_xp else 0)
                 + 2 * seq * 4 + state                    # hs, dhs, dh_last
                 + gates * seq * xsz + gates * h * h * 4 + state)
    flops = live * 2 * h * gates * h
    bounds_ms = {names[0]: bound(fwd_bytes, flops, w.dtype),
                 names[1]: bound(bwd_bytes, bwd_products * flops, w.dtype)}
    ms = {names[0]: time_ms(lambda: fwd_k(*args)),
          names[1]: time_ms(lambda: bwd_k(*bargs))}
    plain = {names[0]: time_ms(lambda: fwd_r(*args), iters=3, warmup=1),
             names[1]: time_ms(lambda: bwd_r(*bargs), iters=3, warmup=1)}
    lib = (None, None, None)
    if library is not None:
        module, width = library
        lib = cudnn_ms(module, t, b, gates)
    phases = (phase_ms(bwd_k, bargs, phase_set) if library is not None
              else None)
    tol = TOL[dtype]
    out = {}
    for kern, lib_ms in zip(names, lib[:2]):
        err = max(rel_err(a, r) for a, r in pairs[kern])
        ok = err <= tol and (same if kern == names[1] else
                             fwd_same and d_ops == 2)
        b_ms, by = bounds_ms[kern]
        lib_s = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {kern} {name:<24} {str(dtype)[6:]:<8} rel_err {err:.2e} "
            f"(tol {tol:.0e}) kernel_ms {ms[kern]:.4f} plain_ms "
            f"{plain[kern]:.4f} bound_ms {b_ms:.4f} ({by}) library_ms "
            f"{lib_s} {'ok' if ok else 'FAIL'}")
        out[kern] = dict(name=name, err=max(abs_err(a, r)
                                            for a, r in pairs[kern]),
                         rel_err=err, ok=ok, ms=ms[kern],
                         plain_ms=plain[kern], bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, tol=tol)
    out[names[1]].update(bitwise=same, phases_ms=phases)
    out[names[0]].update(bitwise=fwd_same, device_launches_per_call=d_ops,
                         us_per_step=ms[names[0]] / t * 1e3)
    log(f"    {names[0]}: {ms[names[0]] / t * 1e3:.2f} us per step, {d_ops} "
        f"device operations per call (counters' memset, loop); a second "
        f"call on the same inputs is bitwise equal (hs): {fwd_same}; "
        f"{names[1]}: (dxp, dW_hh, dh0): {same}")
    if phases:
        log_phases(names[1], phases, ms[names[1]], t)
    if library is not None:
        log(f"    cuDNN {type(module).__name__}({width}, {h}) T={t} B={b}: "
            f"forward {lib[0]:.4f} ms, backward {lib[1]:.4f} ms; its input "
            f"projection [{t * b}, {width}] x [{width}, {gates * h}] alone "
            f"{lib[2]:.4f} ms")
    return out


def cudnn_gru():
    """cuDNN's GRU at the encoder's widths with b_hn = 0: PyTorch's
    n = tanh(xn + r * (h W_hn + b_hn)) is then the port's n, in the same
    r, z, n order."""
    gru = torch.nn.GRU(S2S_EMBED, S2S_H)
    with torch.no_grad():
        gru.bias_hh_l0.zero_()
    return gru, S2S_EMBED


def gru_rnn_kernels_phase():
    bf16 = torch.bfloat16
    log("phase kernels: fused GRU time loop, forward (F) and backward (G); "
        f"T={S2S_LEN} B={S2S_B} H={S2S_H} (the seq2seq encoder's)")
    kw = dict(t=S2S_LEN, b=S2S_B, h=S2S_H)
    gru = {
        "main": time_loop_case(GRU_LOOP, "FG", "main_full_f32",
                               library=cudnn_gru(), **kw),
        "ragged": time_loop_case(GRU_LOOP, "FG", "ragged_len15-30",
                                 lengths=True, seed=1, **kw),
        "reverse": time_loop_case(GRU_LOOP, "FG", "reverse_ragged",
                                  lengths=True, reverse=True, seed=2, **kw),
        "initial": time_loop_case(GRU_LOOP, "FG", "nonzero_h0", initial=True,
                                  seed=3, **kw),
        "bf16": time_loop_case(GRU_LOOP, "FG", "bf16_xproj_whh_ragged",
                               dtype=bf16, lengths=True, seed=4, **kw),
    }
    log("phase kernels: fused tanh-RNN time loop, forward (H) and backward "
        f"(I); T={RNN_T} B={RNN_B} H={RNN_H}")
    kw = dict(t=RNN_T, b=RNN_B, h=RNN_H)
    rnn = {
        "main": time_loop_case(
            RNN_LOOP, "HI", "main_full_f32", library=(torch.nn.RNN(
                RNN_H, RNN_H, nonlinearity="tanh"), RNN_H), **kw),
        "ragged": time_loop_case(RNN_LOOP, "HI", "ragged_len50-100",
                                 lengths=True, seed=5, **kw),
        "reverse": time_loop_case(RNN_LOOP, "HI", "reverse_ragged",
                                  lengths=True, reverse=True, seed=6, **kw),
        "initial": time_loop_case(RNN_LOOP, "HI", "nonzero_h0", initial=True,
                                  seed=8, **kw),
        "bf16": time_loop_case(RNN_LOOP, "HI", "bf16_xproj_whh_ragged",
                               dtype=bf16, lengths=True, initial=True,
                               seed=7, **kw),
    }
    bad = [f"{k}:{c}" for d in (gru, rnn) for c, case in d.items()
           for k, v in case.items() if not v["ok"]]
    if bad:
        raise Fail(f"GRU/RNN kernel disagrees with its plain version: {bad}")
    return gru, rnn


# E, G and I at shapes of their loop's other grids: w_hh's rows read
# from global memory (H >= 1536; I's from H=2816) and several pairs per
# thread (wide H or B); (kernel, name, T, B, H, dtype, w_hh's dtype where
# it differs), T cut to keep the plain versions short
WIDE_CASES = (
    ("E", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("E", "h2048_b64_l2_rows_2pairs", 20, 64, 2048, torch.float32),
    ("E", "h2048_b64_bf16", 20, 64, 2048, torch.bfloat16),
    ("E", "h4096_b64_l2_rows_4pairs", 10, 64, 4096, torch.float32),
    ("E", "b256_h512_2pairs", 40, 256, 512, torch.float32),
    ("E", "b200_h1024_4pairs", 20, 200, 1024, torch.float32),
    ("G", "h2048_b64_l2_rows_2pairs", 20, 64, 2048, torch.float32),
    ("G", "b128_h1024_bf16", 20, 128, 1024, torch.bfloat16),
    ("I", "h2048_b64_2pairs", 20, 64, 2048, torch.float32),
    ("I", "h4096_b64_l2_rows_bf16_xproj", 10, 64, 4096, torch.bfloat16,
     torch.float32),
    # F on the forward loop: gate columns read from w_hh^T through L2
    # (H >= 1536, refused by the one-launch F at B=64), several pairs per
    # thread, and the 32-row tiles of large batches
    ("F", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("F", "h2048_b64_l2_rows_4pairs", 20, 64, 2048, torch.float32),
    ("F", "h2048_b16_bf16", 20, 16, 2048, torch.bfloat16),
    ("F", "b128_h1024_bf16", 20, 128, 1024, torch.bfloat16),
    ("F", "b256_h1024_8pairs", 20, 256, 1024, torch.float32),
    # D on the forward loop: its four gate columns read from w_hh^T
    # through L2 (H >= 1536), in f32 and bf16, and the 32-row tiles of a
    # large batch
    ("D", "h1536_b64_l2_rows", 20, 64, 1536, torch.float32),
    ("D", "h2048_b64_l2_rows_4pairs", 20, 64, 2048, torch.float32),
    ("D", "h2048_b64_l2_rows_bf16", 20, 64, 2048, torch.bfloat16),
    ("D", "b256_h1024_8pairs", 20, 256, 1024, torch.float32),
    # H on the forward loop, one gate column: 4 pairs per thread,
    # w_hh's columns read from w_hh^T through L2 from H=2816 (B=64; the
    # one-launch H refused H >= 2816 there), and B=100, H=2560, which
    # only the one-gate bounds of the 2 x 4 and 1 x 8 tiles take (8
    # pairs a thread, from L2)
    ("H", "h2048_b64_4pairs", 20, 64, 2048, torch.float32),
    ("H", "h4096_b64_l2_rows_4pairs", 10, 64, 4096, torch.float32),
    ("H", "h2816_b64_l2_rows", 20, 64, 2816, torch.float32),
    ("H", "h2048_b64_bf16", 20, 64, 2048, torch.bfloat16),
    ("H", "b256_h1024_4pairs", 20, 256, 1024, torch.float32),
    ("H", "b100_h2560_one_gate_bound", 20, 100, 2560, torch.float32),
)


def wide_case(kern, name, t, b, h, dtype, w_dtype=None, *, seed):
    """E, G or I alone against its plain version on the plain forward's
    outputs, with ragged lengths, nonzero initial state and random
    cotangents (D, F, H: the forward alone on the same inputs); a second
    call must repeat every output bit for bit. Its
    device time (5 calls) is logged beside the grid it ran. x_proj (and
    w_hh, unless w_dtype is given) in `dtype`."""
    rs = np.random.RandomState(seed + 100)
    cot = lambda *sh: torch.from_numpy(
        rs.standard_normal(sh).astype(np.float32)).cuda()
    if kern in "DE":
        args, _ = lstm_case_inputs(t=t, b=b, h=h, dtype=dtype, lengths=True,
                                   reverse=False, initial=True, seed=seed)
        limits = FL.device_limits(args[0].device)
        if kern == "D":
            bargs = args
            bwd_k, bwd_r = FL.lstm_forward_kernel, FL.lstm_forward_reference
            geo = FL.geometry(b, h, *limits)
        else:
            bargs = args + FL.lstm_forward_reference(*args) + (
                cot(t, b, h).to(dtype), cot(b, h), cot(b, h))
            bwd_k, bwd_r = (FL.lstm_backward_kernel,
                            FL.lstm_backward_reference)
            geo = FL.backward_geometry(b, h, *limits)
    else:
        gates = 3 if kern in "FG" else 1
        mod = FG if kern in "FG" else FR
        fwd_k = (FG.gru_forward_kernel if kern in "FG"
                 else FR.rnn_forward_kernel)
        gr = np.random.RandomState(seed)
        lim = 1.0 / np.sqrt(h)
        xp = torch.from_numpy(gr.standard_normal((t, b, gates * h)).astype(
            np.float32)).to("cuda", dtype)
        w = torch.from_numpy(gr.uniform(-lim, lim, (h, gates * h)).astype(
            np.float32)).to("cuda", w_dtype or dtype)
        h0 = torch.from_numpy((0.5 * gr.standard_normal((b, h))).astype(
            np.float32)).cuda()
        lens = torch.from_numpy(gr.randint(t // 2, t + 1, b)).cuda()
        args = (xp, w, h0, FG.make_bounds(b, t, lens, False, device="cuda"))
        fwd_r = (FG.gru_forward_reference if kern in "FG"
                 else FR.rnn_forward_reference)
        if kern in "FH":
            # the forward alone: its call and plain version take args
            bargs = args
            bwd_k, bwd_r = (lambda *a: (fwd_k(*a),),
                            lambda *a: (fwd_r(*a),))
            geo = mod.geometry(b, h, *mod._limits(xp.device))
        else:
            bargs = args + (fwd_r(*args), cot(t, b, h), cot(b, h))
            bwd_k, bwd_r = ((FG.gru_backward_kernel,
                             FG.gru_backward_reference) if kern == "G" else
                            (FR.rnn_backward_kernel,
                             FR.rnn_backward_reference))
            geo = mod.backward_geometry(b, h, *mod._limits(xp.device))
    got = bwd_k(*bargs)
    ref = bwd_r(*bargs)
    torch.cuda.synchronize()
    same = bitwise_repeat(bwd_k, bargs, got)
    err = max(rel_err(a, r) for a, r in zip(got, ref))
    ms = time_ms(lambda: bwd_k(*bargs), iters=5, warmup=1)
    tol = max(TOL[dtype], TOL[w_dtype or dtype])
    ok = err <= tol and same
    label = str(dtype)[6:] + (f"/{str(w_dtype)[6:]}" if w_dtype else "")
    log(f"  {kern} {name:<28} {label:<8} T={t} rel_err {err:.2e} "
        f"(tol {tol:.0e}) bitwise {same} kernel_ms {ms:.4f}; grid "
        f"{geo.row_groups} x {geo.unit_groups}, hb {geo.hb}, br {geo.br}, "
        f"{geo.rep} pairs/thread, w_hh rows "
        f"{'resident' if geo.resident else 'from L2'} "
        f"{'ok' if ok else 'FAIL'}")
    return dict(name=name, kernel=kern, t=t, b=b, h=h, dtype=label,
                rel_err=err, bitwise=same, ms=ms,
                rep=geo.rep, resident=geo.resident, ok=ok)


def wide_phase():
    log("phase kernels: E, G, I, F, D and H on their loops' other grids "
        "(w_hh's rows read from L2, several pairs per thread), ragged, "
        "nonzero initial state")
    cases = [wide_case(*c, seed=20 + i) for i, c in enumerate(WIDE_CASES)]
    bad = [f"{c['kernel']}:{c['name']}" for c in cases if not c["ok"]]
    if bad:
        raise Fail(f"E/G/I/F/D/H disagree with their plain versions: "
                   f"{bad}")
    return cases


# -- training and decoding seq2seq-attention NMT -------------------------------


def time_loop_counts():
    return {"F": FG.launch_counts["fwd"], "G": FG.launch_counts["bwd"],
            "H": FR.launch_counts["fwd"], "I": FR.launch_counts["bwd"]}


def reset_time_loop_counts():
    FG.reset_launch_counts()
    FR.reset_launch_counts()


def trainable(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


LEAF_FLOOR = 1e-6


def leaf_rel_errs(params, ga, gb):
    """(max rel err, one log line per leaf) of two gradient lists in
    tree_leaves(params) order. Each leaf's max abs error is taken over
    its own largest plain magnitude, floored at LEAF_FLOOR x the largest
    plain gradient of any leaf: at random init attention's w_dec has a
    gradient ~1e-9 of the others' (the softmax's shift invariance cancels
    it while tanh is near linear), so on its own scale it measures f32
    cancellation, not the kernels."""
    names = []
    tree_map_with_name(lambda n, _: names.append(n), params)
    top = max(b.abs().max().item() for b in gb)
    worst, lines = 0.0, []
    for n, a, b in zip(names, ga, gb):
        mag = b.abs().max().item()
        err = abs_err(a, b)
        rel = err / max(mag, LEAF_FLOOR * top, 1e-30)
        worst = max(worst, rel)
        lines.append(f"    {n:<16} max|plain| {mag:.3e} max abs err "
                     f"{err:.3e} rel {rel:.2e}")
    return worst, lines


def s2s_grads(params, batch, impl):
    """(loss, gradients in tree_leaves order) of seq2seq_attn.loss."""
    loss = TS.loss(params, *batch, impl=impl)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def s2s_train(params, batches, impl, steps):
    """`steps` hand-rolled steps (the bench's: gradients, then adam's
    update in place) from a copy of params: (params, losses, wall
    seconds, launches of F-I in this run, F's and G's device
    launches)."""
    params = trainable(params)
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    losses = []
    torch.cuda.synchronize()
    reset_time_loop_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        loss, grads = s2s_grads(params, batches[i % len(batches)], impl)
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (params, [v.item() for v in losses], wall, time_loop_counts(),
            {"F": FG.device_launches["fwd"], "G": FG.device_launches["bwd"]})


def seq2seq_phase():
    """seq2seq_attn at bench_seq2seq's width: 10 train steps on kernels F
    and G and then on their plain versions from the same weights; the
    first step's gradients, every loss, the launches."""
    log(f"phase seq2seq: seq2seq_attn, vocab {S2S_VOCAB}, embed {S2S_EMBED}, "
        f"hidden {S2S_H}, B={S2S_B}, src_len = tgt_len = {S2S_LEN}, lengths "
        f"uniform in [{S2S_LEN // 2}, {S2S_LEN}], adam 1e-3, {TRAIN_STEPS} "
        f"steps over {TRAIN_BATCHES} batches")
    rs = np.random.RandomState(5)
    params = TS.init_params(rs, S2S_VOCAB, S2S_VOCAB, embed_dim=S2S_EMBED,
                            hidden=S2S_H, device="cuda")
    cuda = lambda a: torch.from_numpy(a).cuda()
    shape, half = (S2S_B, S2S_LEN), S2S_LEN // 2
    batches = [(cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)),
                cuda(rs.randint(2, S2S_VOCAB, shape).astype(np.int32)),
                cuda(rs.randint(half, S2S_LEN + 1, S2S_B).astype(np.int32)))
               for _ in range(TRAIN_BATCHES)]

    p0 = trainable(params)
    _, gk = s2s_grads(p0, batches[0], None)
    _, gp = s2s_grads(p0, batches[0], "torch")
    g_err, table = leaf_rel_errs(p0, gk, gp)
    for line in table:
        log(line)
    log(f"  first-step gradients ({len(gk)} leaves), kernel vs plain path: "
        f"max rel err {g_err:.2e} (tol {GRAD_RTOL:.0e})")
    if g_err > GRAD_RTOL:
        raise Fail(f"seq2seq: first-step gradients differ: {g_err:.2e}")

    for impl in (None, "torch"):     # warm the allocator and cuBLAS
        s2s_train(params, batches, impl, 1)
    trained, k_loss, k_wall, k_launch, k_dev = s2s_train(
        params, batches, None, TRAIN_STEPS)
    _, p_loss, p_wall, p_launch, p_dev = s2s_train(params, batches, "torch",
                                                   TRAIN_STEPS)
    tokens = sum(int(batches[i % TRAIN_BATCHES][3].sum())
                 for i in range(TRAIN_STEPS))
    out = dict(steps=TRAIN_STEPS, tgt_tokens=tokens,
               kernel_ms_per_step=1e3 * k_wall / TRAIN_STEPS,
               kernel_tgt_tok_s=tokens / k_wall,
               plain_ms_per_step=1e3 * p_wall / TRAIN_STEPS,
               plain_tgt_tok_s=tokens / p_wall, grad_rel_err=g_err,
               losses=k_loss, plain_losses=p_loss, launches=k_launch,
               device_launches=k_dev)
    log(f"  kernel path: {out['kernel_ms_per_step']:.3f} ms/step = "
        f"{out['kernel_tgt_tok_s']:.1f} target tokens/s; launches "
        f"{k_launch} (device launches {k_dev}); losses "
        f"{['%.6f' % v for v in k_loss]}")
    log(f"  plain path:  {out['plain_ms_per_step']:.3f} ms/step = "
        f"{out['plain_tgt_tok_s']:.1f} target tokens/s; launches "
        f"{p_launch}; losses {['%.6f' % v for v in p_loss]}")
    want = dict(F=2 * TRAIN_STEPS, G=2 * TRAIN_STEPS, H=0, I=0)
    if k_launch != want:
        raise Fail(f"seq2seq: launched {k_launch}, want {want} (2 F and 2 G "
                   f"per step)")
    if k_dev["G"] < 3 * k_launch["G"]:
        raise Fail(f"seq2seq: {k_launch['G']} G calls made {k_dev['G']} "
                   f"device launches, fewer than their three phases")
    if k_dev["F"] != 2 * k_launch["F"]:
        raise Fail(f"seq2seq: {k_launch['F']} F calls made {k_dev['F']} "
                   f"device launches, not their counters' memset and loop")
    if any(p_launch.values()) or any(p_dev.values()):
        raise Fail(f"seq2seq: the plain path launched kernels: {p_launch}, "
                   f"device launches {p_dev}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    out["loss_rel_err"] = rel
    log(f"  losses agree to {rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if len(k_loss) != TRAIN_STEPS or not all(np.isfinite(k_loss)) or \
            rel > LOSS_RTOL:
        raise Fail(f"seq2seq: kernel and plain losses differ: {rel:.2e}")
    return out, trained, batches[0]


def beam_gaps(params, src, lens):
    """Per source row, the smallest score gap among the K+1 best
    candidates of any step of the plain path's beam search (and among its
    final scores): where it is <= GAP_LIMIT the kernel path may pick
    another beam at a near tie."""
    k = GEN_BEAM
    enc_out, h0 = TS.encode(params, src, lens, impl="torch")
    mask = torch.arange(src.shape[1], device=src.device)[None] < lens[:, None]
    statics = (enc_out, TS.project_encoder(params, enc_out), mask)
    gaps = torch.full((src.shape[0],), float("inf"), device=src.device)

    def record(step, logits, st):
        b = st.scores.shape[0]
        log_p = torch.log_softmax(logits.float(), -1).reshape(b, k, -1)
        eos_only = torch.full_like(log_p[0, 0], -1e30)
        eos_only[0] = 0.0
        log_p = torch.where(st.finished[:, :, None], eos_only, log_p)
        top = torch.topk((st.scores[:, :, None] + log_p).reshape(b, -1),
                         k + 1).values
        live = top[:, :-1] > -1e29
        gap = torch.where(live, top[:, :-1] - top[:, 1:], float("inf"))
        gaps.copy_(torch.minimum(gaps, gap.min(dim=1).values))
        return logits

    _, scores, _ = TS.decoder_group(h0.shape[-1]).generate(
        params, embed_fn=lambda toks: params["tgt_embed"][toks.long()],
        batch_size=src.shape[0], vocab_size=params["out"]["kernel"].shape[1],
        max_len=GEN_MAX_LEN, bos_id=1, eos_id=0, beam_size=k,
        boots={"h": h0}, statics=statics, modify_logits_fn=record,
        greedy=False)
    final = (scores[:, :-1] - scores[:, 1:]).min(dim=1).values
    return torch.minimum(gaps, final).tolist()


def greedy_gap(params, src, lens, tokens, row, step):
    """The plain path's top-2 logit gap at greedy step `step` of `row`:
    the decoder teacher-forced on the plain path's own tokens."""
    bos = torch.ones_like(tokens[:, :1])
    tgt_in = torch.cat([bos, tokens[:, :-1]], dim=1)
    logits = TS.teacher_forced_logits(params, src, lens, tgt_in,
                                      impl="torch")
    top2 = torch.topk(logits[row, step], 2).values
    return (top2[0] - top2[1]).item()


def generation_phase(params, batch):
    """Beam (K=4) and greedy decoding of GEN_ROWS source rows with the
    trained weights, on the kernels and on the plain path."""
    log(f"phase generation: generate(beam_size={GEN_BEAM}, max_len="
        f"{GEN_MAX_LEN}) and greedy_generate on {GEN_ROWS} source rows of "
        f"the trained weights")
    params = tree_map(lambda t: t.detach(), params)
    src, lens = batch[0][:GEN_ROWS], batch[1][:GEN_ROWS]
    runs, launches, walls = {}, {}, {}
    for label, fn, impl in (
            ("beam", TS.generate, None), ("greedy", TS.greedy_generate, None),
            ("beam_plain", TS.generate, "torch"),
            ("greedy_plain", TS.greedy_generate, "torch")):
        kw = dict(beam_size=GEN_BEAM) if fn is TS.generate else {}
        with torch.no_grad():
            fn(params, src, lens, max_len=GEN_MAX_LEN, impl=impl, **kw)
            torch.cuda.synchronize()
            reset_time_loop_counts()
            t0 = time.perf_counter()
            runs[label] = fn(params, src, lens, max_len=GEN_MAX_LEN,
                             impl=impl, **kw)
            torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = time_loop_counts()
        launches[label]["F_device"] = FG.device_launches["fwd"]
        lengths = runs[label][-1]
        log(f"  {label}: {walls[label] * 1e3:.1f} ms, launches "
            f"{launches[label]}, mean length "
            f"{lengths.float().mean().item():.2f}")
    for label in ("beam", "greedy"):
        if launches[label] != dict(F=2, G=0, H=0, I=0, F_device=4):
            raise Fail(f"generation: {label} launched {launches[label]}, "
                       f"want 2 F (4 device launches) and no other")
        if any(launches[label + "_plain"].values()):
            raise Fail(f"generation: the plain path launched kernels: "
                       f"{launches[label + '_plain']}")
    out = dict(rows=GEN_ROWS, beam=GEN_BEAM, max_len=GEN_MAX_LEN,
               launches={k: launches[k] for k in ("beam", "greedy")},
               ms={k: 1e3 * v for k, v in walls.items()})

    tok, scores, blen = runs["beam"]
    ptok, pscores, plen = runs["beam_plain"]
    same = (tok == ptok).flatten(1).all(dim=1) & (blen == plen).all(dim=1)
    diff = [i for i in range(GEN_ROWS) if not bool(same[i])]
    if diff:
        gaps = beam_gaps(params, src, lens)
        for i in diff:
            log(f"  beam: row {i} differs; the plain search's smallest "
                f"candidate gap {gaps[i]:.3e}")
            if gaps[i] > GAP_LIMIT:
                raise Fail(f"generation: beam row {i} differs away from a "
                           f"near tie (gap {gaps[i]:.3e} > {GAP_LIMIT})")
    keep = same[:, None].expand_as(scores)
    s_err = ((scores - pscores).abs() / pscores.abs().clamp(min=1.0))[keep]
    s_err = s_err.max().item() if s_err.numel() else 0.0
    out.update(beam_rows_equal=GEN_ROWS - len(diff), beam_score_rel_err=s_err)
    log(f"  beam: tokens equal on {GEN_ROWS - len(diff)}/{GEN_ROWS} rows; "
        f"scores agree to {s_err:.2e} relative (tol {SCORE_RTOL:.0e})")
    if s_err > SCORE_RTOL:
        raise Fail(f"generation: beam scores differ: {s_err:.2e}")

    gtok, glen = runs["greedy"]
    pgtok, pglen = runs["greedy_plain"]
    same_g = 0
    for i in range(GEN_ROWS):
        d = (gtok[i] != pgtok[i]).nonzero()
        if not len(d):
            same_g += 1
            continue
        gap = greedy_gap(params, src, lens, pgtok, i, int(d[0]))
        log(f"  greedy: row {i}: first differing step {int(d[0])}, plain "
            f"top-2 logit gap {gap:.3e}")
        if gap > GAP_LIMIT:
            raise Fail(f"generation: greedy row {i} differs at a top-2 gap "
                       f"{gap:.3e} > {GAP_LIMIT}")
    out["greedy_rows_equal"] = same_g
    log(f"  greedy: tokens equal on {same_g}/{GEN_ROWS} rows")
    for t, ln in ((tok, blen), (gtok, glen)):
        if not bool(((t >= 0) & (t < S2S_VOCAB)).all()) or \
                not bool(((ln >= 1) & (ln <= GEN_MAX_LEN)).all()):
            raise Fail("generation: token or length out of range")
    if not bool(torch.isfinite(scores).all()):
        raise Fail("generation: beam scores are not finite")
    return out


def simple_rnn_phase():
    """simple_rnn at T=100, B=64, H=512 on lengths uniform in [50, 100]:
    one forward and backward on kernels H and I and on the plain path."""
    log(f"phase simple_rnn: T={RNN_T} B={RNN_B} F=H={RNN_H}, lengths "
        f"uniform in [{RNN_T // 2}, {RNN_T}]")
    rs = np.random.RandomState(6)
    params = tree_map(lambda t: t.cuda().requires_grad_(True),
                      RNN.init_rnn_params(rs, RNN_H, RNN_H))
    mk = lambda *s: torch.from_numpy(
        rs.standard_normal(s).astype(np.float32)).cuda()
    x = mk(RNN_B, RNN_T, RNN_H).requires_grad_(True)
    w_o, w_h = mk(RNN_B, RNN_T, RNN_H), mk(RNN_B, RNN_H)
    lens = torch.from_numpy(rs.randint(RNN_T // 2, RNN_T + 1, RNN_B)).cuda()
    wrt = [x] + tree_leaves(params)

    def grads(impl):
        out, fin = RNN.simple_rnn(params, x, lens, impl=impl)
        loss = torch.sum(out * w_o) + torch.sum(fin * w_h)
        return loss.item(), torch.autograd.grad(loss, wrt)

    torch.cuda.synchronize()
    reset_time_loop_counts()
    k_loss, gk = grads(None)
    launched = time_loop_counts()
    device = dict(FR.device_launches)
    p_loss, gp = grads("torch")
    plain_launched = time_loop_counts()
    err = max(rel_err(a, b) for a, b in zip(gk, gp))
    log(f"  loss kernel {k_loss:.6f} plain {p_loss:.6f}; gradients max rel "
        f"err {err:.2e} (tol {GRAD_RTOL:.0e}); launches {launched} (device "
        f"launches: H {device['fwd']}, I {device['bwd']})")
    if launched != dict(F=0, G=0, H=1, I=1):
        raise Fail(f"simple_rnn: launched {launched}, want one H and one I")
    if device["fwd"] != 2:
        raise Fail(f"simple_rnn: H made {device['fwd']} device launches, "
                   f"want its counters' memset and the forward loop")
    if device["bwd"] < 3:
        raise Fail(f"simple_rnn: I made {device['bwd']} device launches, "
                   f"want its counters' memset, serial loop and dW_hh")
    if plain_launched != launched or FR.device_launches != device:
        raise Fail("simple_rnn: the plain path launched kernels")
    if err > GRAD_RTOL or abs(k_loss - p_loss) > LOSS_RTOL * abs(p_loss):
        raise Fail(f"simple_rnn: kernel and plain paths differ: grads "
                   f"{err:.2e}")
    return dict(loss=k_loss, plain_loss=p_loss, grad_rel_err=err,
                launches={"H": launched["H"], "I": launched["I"]},
                device_launches={"H": device["fwd"], "I": device["bwd"]})


# -- the rest of the RNN family: SRL, quick_start, BiLSTM-CRF, MD-LSTM ---------

# SRL at the fluid book chapter label_semantic_roles's widths: word_dim 32,
# mark_dim 5, depth 8; its hidden_dim 512 is dynamic_lstm's size, which
# counts four gates, so the LSTM state is 128 wide; the CoNLL-05
# dictionaries' sizes as the chapter prints them (44068 words, 3162
# predicates, 59 labels); its batch of 10 rows, each of the surrogate's own
# length (5-29), padded to its batch's longest
SRL_CFG = dict(word_vocab=44068, pred_vocab=3162, num_labels=59, word_dim=32,
               mark_dim=5, hidden=128, depth=8)
SRL_B = 10
# the quick_start demos (trainer_config.{bidi-lstm,db-lstm,cnn,lr}.py):
# embed 128, hidden 128, db_lstm 8 levels, settings(batch_size=128); the
# imdb surrogate at its default vocabulary of 2000; text_cnn context 3,
# hidden 512
QS_B, QS_VOCAB, QS_EMBED, QS_H, QS_DEPTH = 128, 2000, 128, 128, 8
QS_CNN_H, QS_CTX = 512, 3
# BiLSTM-CRF at the JAX package's defaults over the SRL batch's words and
# labels; MD-LSTM on a [B, 16, 16, 32] grid, hidden 64; the beam cross
# entropy over E expansions of K beams
BC_EMBED, BC_H = 32, 64
MD_SHAPE, MD_H = (8, 16, 16, 32), 64
BEAM_E, BEAM_B, BEAM_K = 8, 128, 4
FAMILY_STEPS = 5                      # timed, after one warm-up step
# the kernel-free parts, card against CPU: the tests' tolerances (values
# 1e-5 relative, losses and gradients 1e-4)
VALUE_RTOL, FREE_LOSS_RTOL = 1e-5, 1e-4


def srl_batches(n, seed=0):
    """n SRL batches (CPU tensors: word windows [B, T, 6], predicate,
    mark, labels [B, T], lengths [B]) from the conll05 surrogate at the
    chapter's dictionary sizes. Each batch is padded to its longest row;
    the 6 word-window columns are shifted copies of the word row (the
    chapter's ctx_n2 .. ctx_p2, as tests/test_book_models.py builds
    them)."""
    rows = list(TDATA.dataset_zoo.conll05(
        n=n * SRL_B, word_vocab=SRL_CFG["word_vocab"],
        verb_vocab=SRL_CFG["pred_vocab"], label_vocab=SRL_CFG["num_labels"],
        seed=seed)())
    out = []
    for i in range(n):
        chunk = rows[i * SRL_B:(i + 1) * SRL_B]
        w, lens = TDATA.pad_sequences([r[0] for r in chunk])
        mark, _ = TDATA.pad_sequences([r[2] for r in chunk])
        labels, _ = TDATA.pad_sequences([r[3] for r in chunk])
        win = np.stack([np.roll(w, s, axis=1) for s in (0, 2, 1, 0, -1, -2)],
                       axis=-1)
        pred = np.broadcast_to(np.asarray([r[1] for r in chunk])[:, None],
                               w.shape)
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         for a in (win, pred, mark, labels, lens)))
    return out


def imdb_batches(n, seed=0):
    """n quick_start batches (CPU tensors: tokens [B, T], lengths [B],
    labels [B]) of QS_B rows from the imdb surrogate (lengths 8-119), each
    padded to its longest row."""
    rows = list(TDATA.dataset_zoo.imdb_train(n=n * QS_B, seed=seed)())
    out = []
    for i in range(n):
        chunk = rows[i * QS_B:(i + 1) * QS_B]
        tokens, lens = TDATA.pad_sequences([r[0] for r in chunk])
        labels = np.asarray([r[1] for r in chunk])
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         for a in (tokens, lens, labels)))
    return out


def qs_loss(model):
    """A quick_start model -> loss(params, tokens, lens, labels, impl):
    the mean softmax cross entropy of its logits."""
    def loss(params, tokens, lens, labels, impl=None):
        kw = {} if impl is None else {"impl": impl}
        return ce_loss(model(params, tokens, lens, **kw), labels.long())
    return loss


def family_grads(loss_fn, params, batch, **kw):
    loss = loss_fn(params, *batch, **kw)
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def family_parity(name, loss_fn, params_cpu, batch, loss_rtol, grad_rtol,
                  output_fn=None, f64_kw=None):
    """One loss and its gradients on the card (impl None: the kernels where
    the model has any) against the same on CPU tensors (the plain
    versions), from the same weights and batch; gradients leaf by leaf,
    floored as the seq2seq phase's. With output_fn(params, *batch), its
    outputs too, at VALUE_RTOL. With `f64_kw` (the loss's keywords for a
    float64 run, {"impl": "scan"} where it has LSTMs), the step also runs
    in float64 on the CPU, and a leaf is gated only where the model is
    well conditioned in f32 there, as the image phase decides it: where
    the CPU's f32 gradient is within grad_rtol / 10 of the float64 one.
    Elsewhere -- deep ReLU stacks at random init, where an ulp decides
    which units pass and a flipped unit moves a small, cancelling
    gradient by 1e-4 or more -- the card's and the CPU's f32 errors
    against float64 are printed. Returns the errors; raises on a miss."""
    pk = trainable(tree_to(params_cpu, "cuda"))
    pp = trainable(params_cpu)
    lk, gk = family_grads(loss_fn, pk, [b.cuda() for b in batch])
    lp, gp = family_grads(loss_fn, pp, batch)
    names = []
    tree_map_with_name(lambda n, _: names.append(n), pp)
    named = lambda g: dict(zip(names, g))
    errs = leaf_errs(named(gk), named(gp))
    vs_f64 = {}
    if f64_kw is not None:
        p64 = trainable(tree_to(params_cpu, "cpu", torch.float64))
        _, g64 = with_policy(F64, family_grads, loss_fn, p64, batch,
                             **f64_kw)
        vs_f64 = {"cuda": leaf_errs(named(gk), named(g64)),
                  "cpu": leaf_errs(named(gp), named(g64))}
    gated = [n for n in names
             if not vs_f64 or vs_f64["cpu"][n] <= grad_rtol / 10]
    g_err = max(errs[n] for n in gated) if gated else float("inf")
    l_err = abs(lk.item() - lp.item()) / abs(lp.item())
    out = dict(loss=lk.item(), plain_loss=lp.item(), loss_rel_err=l_err,
               grad_rel_err=g_err, leaves_gated=len(gated),
               leaves=len(names))
    if vs_f64:
        out["vs_f64"] = {k: max(v.values()) for k, v in vs_f64.items()}
        out["not_gated"] = {n: {"err": errs[n], "cuda_vs_f64":
                                vs_f64["cuda"][n], "cpu_vs_f64":
                                vs_f64["cpu"][n]}
                            for n in names if n not in gated}
    if output_fn is not None:
        with torch.no_grad():
            out["output_rel_err"] = rel_err(
                output_fn(pk, *[b.cuda() for b in batch]).cpu(),
                output_fn(pp, *batch))
    log(f"  {name}: card vs CPU, loss {lk.item():.6f} / {lp.item():.6f} "
        f"(rel {l_err:.2e}, tol {loss_rtol:.0e}); gradients max rel err "
        f"{g_err:.2e} over {len(gated)} of {len(names)} leaves (tol "
        f"{grad_rtol:.0e})" + (
            f"; against float64 on the CPU: card {out['vs_f64']['cuda']:.2e}"
            f", CPU {out['vs_f64']['cpu']:.2e}" if vs_f64 else "") + (
            f"; outputs rel err {out['output_rel_err']:.2e} (tol "
            f"{VALUE_RTOL:.0e})" if output_fn else ""))
    if len(gated) < len(names):
        log(f"    not gated (the CPU's f32 over {grad_rtol / 10:.0e} from "
            f"float64), card vs CPU / card vs f64 / CPU vs f64: " + ", ".join(
                f"{n} {v['err']:.1e}/{v['cuda_vs_f64']:.1e}/"
                f"{v['cpu_vs_f64']:.1e}" for n, v in out["not_gated"].items()))
    if g_err > grad_rtol:
        log("    " + ", ".join(f"{n} {errs[n]:.2e}" for n in gated))
    if (l_err > loss_rtol or g_err > grad_rtol
            or out.get("output_rel_err", 0.0) > VALUE_RTOL):
        raise Fail(f"rnn_family: {name} differs between the card and the "
                   f"CPU: {out}")
    return out


def family_train(loss_fn, params_cpu, batches, impl):
    """1 + FAMILY_STEPS hand-rolled adam(1e-3) steps on the card (the
    seq2seq phase's step) from a copy of the weights, D's and E's counts
    set to 0 just before: (losses, ms per timed step ending in a sync,
    launches {D, E}, device launches {D, E}, trained params)."""
    params = trainable(tree_to(params_cpu, "cuda"))
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    batches = [[b.cuda() for b in batch] for batch in batches]
    losses = []

    def step(i):
        loss, grads = family_grads(loss_fn, params, batches[i], impl=impl)
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))
        losses.append(loss.detach())

    torch.cuda.synchronize()
    FL.reset_launch_counts()
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, FAMILY_STEPS + 1):
        step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FAMILY_STEPS
    return ([v.item() for v in losses], ms,
            {"D": FL.launch_counts["fwd"], "E": FL.launch_counts["bwd"]},
            {"D": FL.device_launches["fwd"], "E": FL.device_launches["bwd"]},
            params)


def family_run(name, loss_fn, params_cpu, batches, layers):
    """A model's parity gate, then its training run on the kernels and on
    their plain versions (impl="torch") on the card: `layers` LSTM layers
    make `layers` D and E launches a step."""
    out = family_parity(name, loss_fn, params_cpu, batches[0], LOSS_RTOL,
                        GRAD_RTOL, f64_kw={"impl": "scan"})
    k_loss, k_ms, launched, device, trained = family_train(
        loss_fn, params_cpu, batches, None)
    p_loss, p_ms, p_launched, _, _ = family_train(loss_fn, params_cpu,
                                                  batches, "torch")
    steps = FAMILY_STEPS + 1
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    log(f"  {name}: {k_ms:.3f} ms/step on D and E ({launched['D']} D, "
        f"{launched['E']} E launches in {steps} steps; {device['D']} and "
        f"{device['E']} device operations), {p_ms:.3f} ms/step on their "
        f"plain versions; losses {['%.6f' % v for v in k_loss]}, plain "
        f"{['%.6f' % v for v in p_loss]} (max rel {rel:.2e})")
    want = {"D": layers * steps, "E": layers * steps}
    if launched != want:
        raise Fail(f"rnn_family: {name} launched {launched}, want {want} "
                   f"({layers} of each a step)")
    if device["D"] != 2 * launched["D"] or device["E"] < 3 * launched["E"]:
        raise Fail(f"rnn_family: {name}'s D and E calls made {device} "
                   f"device operations")
    if p_launched != {"D": 0, "E": 0}:
        raise Fail(f"rnn_family: {name}'s plain path launched {p_launched}")
    if not all(np.isfinite(k_loss)) or rel > LOSS_RTOL:
        raise Fail(f"rnn_family: {name}'s kernel and plain losses differ: "
                   f"{rel:.2e}")
    out.update(ms_per_step=k_ms, plain_ms_per_step=p_ms, losses=k_loss,
               plain_losses=p_loss, loss_trace_rel_err=rel,
               launches=launched, device_launches=device,
               launches_per_step={k: v / steps for k, v in launched.items()})
    return out, trained


def viterbi_gate(name, tags_k, emit_cpu, crf_cpu, lens):
    """The card's tags against the plain path's Viterbi on the CPU's
    emissions: equal, or each differing row's card path scores within
    GAP_LIMIT of the best (a near tie). Returns (rows that differ, largest
    gap)."""
    tags_p, best = CRF.crf_decode(crf_cpu, emit_cpu, lens)
    differ = [r for r in range(tags_p.shape[0])
              if not torch.equal(tags_k[r].cpu(), tags_p[r])]
    gap = 0.0
    for r in differ:
        path = CRF.crf_sequence_score(crf_cpu, emit_cpu[r:r + 1],
                                      tags_k[r:r + 1].cpu(), lens[r:r + 1])
        gap = max(gap, (best[r] - path[0]).item())
    log(f"  {name} Viterbi: {len(differ)} of {tags_p.shape[0]} rows differ "
        f"from the plain path's; largest score gap {gap:.2e} (limit "
        f"{GAP_LIMIT:.0e})")
    if gap > GAP_LIMIT:
        raise Fail(f"rnn_family: {name} decodes other tags than the plain "
                   f"path (gap {gap:.2e})")
    return len(differ), gap


#: kernels D and E launch (csrc/fused_lstm.cu, time_loop.cuh, tile_gemm.cuh)
DE_KERNELS = ("forward_loop_kernel", "lstm_bwd_gates_kernel",
              "backward_loop_kernel", "dw_kernel", "reduce_splits")


def profile_device(fn, reps=3):
    """fn() under torch.profiler, `reps` calls after a warm one: (wall ms
    per call ending in a sync, device-busy ms per call -- the union of
    its kernels' intervals --, kernels per call, busy ms per call of the
    kernels whose names hold one of DE_KERNELS); None where the profiler
    saw no device activity."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    spans = lambda ks: sorted((e.time_range.start, e.time_range.end)
                              for e in ks)

    def union_ms(intervals):
        total, end = 0.0, None
        for a, b in intervals:
            if end is None or a > end:
                total, end = total + b - a, b
            elif b > end:
                total, end = total + b - end, b
        return total / 1e3 / reps

    de = [e for e in kernels if any(k in e.name for k in DE_KERNELS)]
    return wall, union_ms(spans(kernels)), len(kernels) / reps, \
        union_ms(spans(de))


def srl_split(params_cpu, batch):
    """One SRL step (gradients and adam's update) under torch.profiler:
    wall ms, device-busy ms and share, kernels per step and D's and E's
    busy ms; the CRF alone (the log-likelihood's forward and backward on
    fixed emissions) likewise, for its share of the step's device
    time."""
    params = trainable(tree_to(params_cpu, "cuda"))
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    batch = [b.cuda() for b in batch]
    zero = torch.zeros((), dtype=torch.int32, device="cuda")

    def step():
        _, grads = family_grads(TSRL.loss, params, batch)
        it = iter(grads)
        opt.update(tree_map(lambda _: next(it), params), opt_state, params,
                   zero)

    win, pred, mark, labels, lens = batch
    with torch.no_grad():
        emit = TSRL.emissions(params, win, pred, mark, lens)
    emit.requires_grad_(True)
    crf = CRF.CRFParams(**params["crf"])

    def crf_step():
        ll = CRF.crf_log_likelihood(crf, emit, labels, lens)
        torch.autograd.grad(-torch.mean(ll), [emit, *crf])

    prof_step, prof_crf = profile_device(step), profile_device(crf_step)
    if prof_step is None or prof_crf is None:
        log("  SRL step split: the profiler recorded no device activity "
            "(not measured)")
        return dict(measured=False)
    wall, busy, kernels, de = prof_step
    _, c_busy, c_kernels, _ = prof_crf
    out = dict(measured=True, step_wall_ms=wall, step_busy_ms=busy,
               busy_share=busy / wall, kernels_per_step=kernels,
               d_e_busy_ms=de, d_e_share=de / busy, crf_busy_ms=c_busy,
               crf_kernels=c_kernels, crf_share=c_busy / busy,
               rest_busy_ms=busy - de - c_busy)
    log(f"  SRL step under torch.profiler (mean of 3): wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{kernels:.0f} kernels; D and E {de:.3f} ms "
        f"({100 * de / busy:.1f}% of busy), the CRF's forward and backward "
        f"alone {c_busy:.3f} ms in {c_kernels:.0f} kernels "
        f"({100 * out['crf_share']:.1f}%), the rest "
        f"{out['rest_busy_ms']:.3f}")
    return out


def kernel_free_phase(srl_batch):
    """text_cnn, bow_lr, BiLSTM-CRF, md_lstm and cross_entropy_over_beam
    on the card against the same on CPU tensors (no kernel: torch ops on
    both)."""
    rs = np.random.RandomState(21)
    out = {}
    tokens, lens, labels = imdb_batches(1, seed=5)[0]
    cnn = TQ.init_text_cnn(rs, QS_VOCAB, embed_dim=QS_EMBED,
                           context_len=QS_CTX, hidden=QS_CNN_H, device="cpu")
    out["text_cnn"] = family_parity(
        "text_cnn", qs_loss(TQ.text_cnn), cnn, (tokens, lens, labels),
        FREE_LOSS_RTOL, GRAD_RTOL,
        output_fn=lambda p, t, n, _: TQ.text_cnn(p, t, n), f64_kw={})
    bow = TQ.init_bow_lr(rs, QS_VOCAB, device="cpu")
    mask = torch.arange(tokens.shape[1])[None, :] < lens[:, None].long()
    counts = torch.zeros(QS_B, QS_VOCAB).index_put_(
        (torch.arange(QS_B)[:, None].expand_as(tokens)[mask],
         tokens.long()[mask]), torch.ones(int(mask.sum())), accumulate=True)
    out["bow_lr"] = family_parity(
        "bow_lr", lambda p, c, y: ce_loss(TQ.bow_lr(p, c), y.long()), bow,
        (counts, labels), FREE_LOSS_RTOL, GRAD_RTOL,
        output_fn=lambda p, c, _: TQ.bow_lr(p, c))
    out["bow_lr_from_tokens"] = family_parity(
        "bow_lr_from_tokens", qs_loss(TQ.bow_lr_from_tokens), bow,
        (tokens, lens, labels), FREE_LOSS_RTOL, GRAD_RTOL)

    win, _, _, tags, slens = srl_batch
    words = win[..., 0]
    bc = TBC.init_params(rs, SRL_CFG["word_vocab"], SRL_CFG["num_labels"],
                         embed_dim=BC_EMBED, hidden=BC_H, device="cpu")
    out["bilstm_crf"] = family_parity(
        "bilstm_crf", TBC.loss, bc, (words, tags, slens), FREE_LOSS_RTOL,
        GRAD_RTOL, f64_kw={})
    with torch.no_grad():
        tags_k, score_k = TBC.decode(tree_to(bc, "cuda"), words.cuda(),
                                     slens.cuda())
        emit = TBC.emissions(bc, words, slens)
        crf = CRF.CRFParams(**bc["crf"])
        _, score_p = CRF.crf_decode(crf, emit, slens)
    rows, gap = viterbi_gate("bilstm_crf", tags_k, emit, crf, slens)
    s_err = rel_err(score_k.cpu(), score_p)
    out["bilstm_crf"].update(viterbi_rows_differ=rows, viterbi_gap=gap,
                             score_rel_err=s_err)
    if s_err > VALUE_RTOL:
        raise Fail(f"rnn_family: bilstm_crf's Viterbi scores differ: "
                   f"{s_err:.2e}")

    # md_lstm's state sums every lattice path into a cell: with both
    # forget gates near sigmoid(1) it grows ~1.46x a diagonal at random
    # init, so at 16 x 16 its f32 outputs cancel large terms (the CPU's and
    # the card's f32 agree to ~2e-4, each against float64 likewise). Its
    # semantics are held in float64 on both devices at the tests'
    # tolerances, as the image phase holds BN nets'; the f32 errors are
    # printed.
    md = RNN.init_md_lstm_params(rs, MD_SHAPE[-1], MD_H, device="cpu")
    grid = torch.from_numpy(rs.standard_normal(MD_SHAPE).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal(MD_SHAPE[:3] + (MD_H,)).astype(
        np.float32))
    md64 = tree_to(md, "cpu", torch.float64)
    out["md_lstm"] = {}
    for rows, cols in ((False, False), (True, False), (False, True),
                       (True, True)):
        corner = f"rows{'-' if rows else '+'}cols{'-' if cols else '+'}"
        run = lambda p, x, rows=rows, cols=cols: RNN.md_lstm(
            p, x, reverse_rows=rows, reverse_cols=cols)
        case = with_policy(
            F64, family_parity, f"md_lstm {corner} float64",
            lambda p, x, w_, run=run: torch.sum(run(p, x) * w_), md64,
            (grid.double(), w.double()), FREE_LOSS_RTOL, GRAD_RTOL,
            output_fn=lambda p, x, _, run=run: run(p, x))
        with torch.no_grad():
            f32 = {"cuda": run(tree_to(md, "cuda"), grid.cuda()).cpu(),
                   "cpu": run(md, grid)}
            truth = with_policy(F64, run, md64, grid.double())
        case["f32_output_rel_err"] = {
            "cuda_vs_cpu": rel_err(f32["cuda"], f32["cpu"]),
            "cuda_vs_f64": rel_err(f32["cuda"], truth),
            "cpu_vs_f64": rel_err(f32["cpu"], truth)}
        log(f"    f32 outputs: card vs CPU / card vs f64 / CPU vs f64: "
            + " / ".join(f"{v:.2e}" for v in
                         case["f32_output_rel_err"].values()))
        out["md_lstm"][corner] = case

    scores = torch.from_numpy(rs.standard_normal(
        (BEAM_E, BEAM_B, BEAM_K)).astype(np.float32))
    parents = torch.from_numpy(rs.randint(0, BEAM_K, (BEAM_E, BEAM_B,
                                                      BEAM_K)))
    gold = torch.from_numpy(rs.randint(0, BEAM_K, (BEAM_E, BEAM_B)))
    # the gold path falls off the beam in a third of the rows
    drop = rs.randint(1, BEAM_E, BEAM_B)
    for r in range(0, BEAM_B, 3):
        gold[drop[r]:, r] = -1
    xent = lambda p, par, g: BS.cross_entropy_over_beam(p["s"], par, g)
    out["cross_entropy_over_beam"] = family_parity(
        "cross_entropy_over_beam",
        lambda p, par, g: torch.sum(xent(p, par, g)), {"s": scores},
        (parents, gold), FREE_LOSS_RTOL, VALUE_RTOL, output_fn=xent)
    return out


def rnn_family_phase():
    """SRL, bidi_lstm and db_lstm trained on kernels D and E (both scan
    directions) against the plain path; SRL's Viterbi decode; D and E
    timed at the SRL and quick_start shapes beside cuDNN; the SRL step's
    split; the kernel-free models card against CPU."""
    log(f"phase rnn_family: SRL {SRL_CFG} B={SRL_B}; quick_start bidi_lstm "
        f"and db_lstm (depth {QS_DEPTH}) embed {QS_EMBED} hidden {QS_H} "
        f"B={QS_B} vocab {QS_VOCAB}; adam 1e-3, 1 + {FAMILY_STEPS} steps")
    t0 = time.perf_counter()
    rs = np.random.RandomState(13)
    srl_b = srl_batches(FAMILY_STEPS + 2, seed=0)
    qs_b = imdb_batches(FAMILY_STEPS + 1, seed=0)
    log(f"  batches' T: SRL {[int(b[0].shape[1]) for b in srl_b]}, "
        f"quick_start {[int(b[0].shape[1]) for b in qs_b]}")
    srl_p = TSRL.init_params(rs, device="cpu", **SRL_CFG)
    out = {}
    out["srl"], trained = family_run("srl", TSRL.loss, srl_p,
                                     srl_b[:FAMILY_STEPS + 1],
                                     SRL_CFG["depth"])
    win, pred, mark, _, lens = srl_b[-1]
    with torch.no_grad():
        tags_k = TSRL.decode(trained, *[b.cuda() for b in (win, pred, mark,
                                                           lens)])
        p_cpu = tree_to(trained, "cpu")
        emit = TSRL.emissions(p_cpu, win, pred, mark, lens)
    rows, gap = viterbi_gate("srl", tags_k, emit,
                             CRF.CRFParams(**p_cpu["crf"]), lens)
    out["srl"].update(viterbi_rows_differ=rows, viterbi_gap=gap)

    bidi = TQ.init_bidi_lstm(rs, QS_VOCAB, embed_dim=QS_EMBED, hidden=QS_H,
                             device="cpu")
    out["bidi_lstm"], _ = family_run("bidi_lstm", qs_loss(TQ.bidi_lstm),
                                     bidi, qs_b, 2)
    db = TQ.init_db_lstm(rs, QS_VOCAB, embed_dim=QS_EMBED, hidden=QS_H,
                         depth=QS_DEPTH, device="cpu")
    out["db_lstm"], _ = family_run("db_lstm", qs_loss(TQ.db_lstm), db, qs_b,
                                   QS_DEPTH)

    # D and E at the first batches' shapes and lengths, time-flipped as
    # the odd layers run them
    s_t, q_t = int(srl_b[0][0].shape[1]), int(qs_b[0][0].shape[1])
    cases = {
        "srl": lstm_case(f"srl_t{s_t}_b{SRL_B}_h{SRL_CFG['hidden']}",
                         t=s_t, b=SRL_B, h=SRL_CFG["hidden"],
                         lengths=srl_b[0][4].numpy(), reverse=True, seed=11,
                         library=True),
        "quick_start": lstm_case(
            f"quick_start_t{q_t}_b{QS_B}_h{QS_H}", t=q_t, b=QS_B, h=QS_H,
            lengths=qs_b[0][1].numpy(), reverse=True, seed=12,
            library=True),
    }
    bad = [f"{k}:{c}" for c, d in cases.items() for k, v in d.items()
           if not v["ok"]]
    if bad:
        raise Fail(f"rnn_family: D or E disagrees with its plain version: "
                   f"{bad}")
    out["cases"] = cases
    out["srl_split"] = srl_split(srl_p, srl_b[0])
    out["kernel_free"] = kernel_free_phase(srl_b[0])
    out["seconds"] = time.perf_counter() - t0
    log(f"  rnn_family phase took {out['seconds']:.1f} s")
    return out


# -- the transformer LM's training path ----------------------------------------


def flash_bwd_case(name, *, b, t, h, d=64, dtype=torch.float32, causal=True,
                   lens=None, window=None, seed=0):
    """flash_attention's gradients on the card (kernel A forward, the
    ported backward) against torch.autograd through the plain version on
    the same tensors, with random cotangents; max abs error over max
    |plain| per gradient. Above ROW_BY_ROW_BYTES of f32 scores the plain
    gradients are taken one batch row at a time."""
    rs = np.random.RandomState(seed)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v, g = mk(), mk(), mk(), mk()
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
    kw = dict(causal=causal, window=window)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    FA.reset_launch_counts()
    got = torch.autograd.grad(FA.flash_attention(*qkv, key_lens=lens_t, **kw),
                              qkv, g)
    launched = FA.launch_counts["fwd"]
    if lens_t is None:
        lens_t = torch.full((b,), t, dtype=torch.int32, device="cuda")
    rows = ([slice(i, i + 1) for i in range(b)]
            if b * h * t * t * 4 > ROW_BY_ROW_BYTES else [slice(0, b)])
    err, scale = [0.0] * 3, [0.0] * 3
    for r in rows:
        ref_in = [x[r].clone().requires_grad_(True) for x in (q, k, v)]
        o_ref, _ = FA.flash_attention_reference(*ref_in, lens_t[r], **kw)
        ref = torch.autograd.grad(o_ref, ref_in, g[r])
        for i in range(3):
            err[i] = max(err[i], abs_err(got[i][r], ref[i]))
            scale[i] = max(scale[i], ref[i].float().abs().max().item())
        del o_ref, ref, ref_in
    rels = [e / max(s, 1e-30) for e, s in zip(err, scale)]
    tol = TOL[dtype]
    ok = max(rels) <= tol and launched == 1
    log(f"  flash backward {name:<18} {str(dtype)[6:]:<8} rel err dq/dk/dv "
        f"{'/'.join('%.2e' % x for x in rels)} (tol {tol:.0e}; A launched "
        f"{launched}) {'ok' if ok else 'FAIL'}")
    return dict(name=name, dtype=str(dtype)[6:], rel_err=max(rels), ok=ok)


def flash_bwd_timing(dtype):
    """Device ms of the ported backward alone at bench_transformer_lm's
    attention (causal T=8192, B=4, H=8, D=64) beside SDPA's backward on
    the same tensors (its forward run once, its backward timed alone),
    and the backward's bound: 2.5 x the forward's products over valid
    pairs at the bf16 peak, or its bytes (q, k, v, o, g and lse read, dq,
    dk, dv written). The LM path under the bf16 policy feeds attention
    f32 (f32 biases promote the products' bf16 outputs, as in the JAX
    package), so both dtypes are timed."""
    b, t, h = LM_B, LM_T, LM_CFG["n_heads"]
    d = LM_CFG["dim"] // h
    rs = np.random.RandomState(9)
    mk = lambda: torch.from_numpy(rs.standard_normal(
        (b, t, h, d)).astype(np.float32)).to("cuda", dtype)
    q, k, v, g = mk(), mk(), mk(), mk()
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    o, lse = FA.flash_kernel(q, k, v, lens, causal=True)
    ms = time_ms(lambda: FA.flash_backward(q, k, v, lens, o, lse, g,
                                           causal=True), iters=5, warmup=1)
    heads = lambda x: x.transpose(1, 2).contiguous().requires_grad_(True)
    qh, kh, vh = heads(q), heads(k), heads(v)
    out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                           is_causal=True)
    gh = g.transpose(1, 2).contiguous()
    sdpa_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                  retain_graph=True))
    pairs = b * h * t * (t + 1) // 2
    bytes_ = 8 * q.numel() * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = bound(bytes_, 2.5 * 4 * d * pairs, torch.bfloat16)
    log(f"  flash backward alone, causal T={t} B={b} H={h} "
        f"{str(dtype)[6:]}: {ms:.4f} ms (device, L2 flushed, mean of 5) vs "
        f"SDPA backward {sdpa_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}: 2.5 x the forward's products at 989 TFLOP/s)")
    return dict(backward_ms=ms, sdpa_backward_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def lm_step_flops(cfg, b, t):
    """Operations one training step of TT.loss executes on tokens [b, t]
    (n = b x (t-1) positions), by part: the blocks' products (forward,
    the remat recompute, the backward's two), the LM head's (forward,
    backward's two, the fused CE's recompute), A's over valid (query,
    key) pairs (forward and recompute), and the flash backward's five
    f32 products over every query each key block visits."""
    tq, d, dh, h = t - 1, cfg.dim, cfg.head_dim, cfg.n_heads
    n = b * tq
    per_layer = d * (h + 2 * cfg.kv_heads) * dh + d * d + 2 * d * (
        cfg.mlp_ratio * d)
    qpos, kpos = np.arange(tq)[:, None], np.arange(tq)[None, :]
    band = qpos >= kpos
    if cfg.attn_window is not None:
        band = band & (qpos - kpos < cfg.attn_window)
    bk = FA.DEFAULT_BLOCK_K
    rows = tq if cfg.attn_window is None else bk + min(cfg.attn_window,
                                                       tq) - 1
    parts = dict(
        blocks=2 * n * per_layer * cfg.n_layers * 4,
        lm_head=2 * n * d * cfg.vocab * (4 if cfg.fused_ce_chunk else 3),
        attention_fwd=2 * 4 * dh * int(band.sum()) * b * h * cfg.n_layers,
        attention_bwd=(5 * 2 * dh * rows * bk * -(-tq // bk) * b * h
                       * cfg.n_layers))
    return sum(parts.values()), parts


def lm_step(params, cfg, tokens, opt, opt_state, step):
    """The bench's hand-rolled step: loss and gradients, then adam's
    update in place. Returns the loss (a tensor)."""
    loss = TT.loss(params, cfg, tokens)
    it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    opt.update(tree_map(lambda _: next(it), params), opt_state, params,
               step)
    return loss.detach()


def lm_train(params, cfg, tokens, steps, opt_state=None):
    """`steps` steps on one batch from params (updated in place): (losses
    as tensors, the adam state)."""
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params) if opt_state is None else opt_state
    losses = [lm_step(params, cfg, tokens, opt, opt_state,
                      torch.tensor(i, dtype=torch.int32, device="cuda"))
              for i in range(steps)]
    return losses, opt_state


class attention_spy:
    """Counts the calls of the dense attention and of the flash plain
    version while entered (neither may run on the kernel path). With
    plain=True the flash Function's forward takes the plain version on
    CUDA tensors too (the plain path), so kernel A must not launch."""

    def __init__(self, plain=False):
        self.plain, self.calls = plain, {"dense": 0, "flash_plain": 0}

    def __enter__(self):
        self.saved = (TT._dense_attention, FA.flash_attention_reference,
                      FA.flash_kernel)

        def count(key, fn):
            def counted(*a, **kw):
                self.calls[key] += 1
                return fn(*a, **kw)
            return counted

        TT._dense_attention = count("dense", self.saved[0])
        FA.flash_attention_reference = count("flash_plain", self.saved[1])
        if self.plain:
            FA.flash_kernel = FA.flash_attention_reference
        return self

    def __exit__(self, *exc):
        (TT._dense_attention, FA.flash_attention_reference,
         FA.flash_kernel) = self.saved


def lm_variant(name, params0, tokens, **cfg_kw):
    """One full-width variant under the bf16 policy, from a copy of
    params0: a warm-up step, then LM_STEPS timed steps ending in a sync;
    A's launches counted from 0 before the warm-up."""
    cfg = TT.TransformerConfig(**LM_CFG, **cfg_kw)
    params = trainable(params0)
    torch.cuda.synchronize()
    FA.reset_launch_counts()
    with attention_spy() as spy:
        first, opt_state = lm_train(params, cfg, tokens, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest, _ = lm_train(params, cfg, tokens, LM_STEPS, opt_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = FA.launch_counts["fwd"]
    losses = [x.item() for x in first + rest]
    step_s = wall / LM_STEPS
    flops, parts = lm_step_flops(cfg, LM_B, LM_T)
    out = dict(variant=name, ms_per_step=1e3 * step_s,
               tokens_per_s=LM_B * LM_T / step_s, step_flops=flops,
               step_flops_by_part=parts,
               mfu_pct=100 * flops / step_s / PEAK_FLOPS[torch.bfloat16],
               a_launches=launched, a_launches_per_step=launched / (
                   1 + LM_STEPS), losses=losses, attention_calls=spy.calls)
    log(f"  {name:<14} {out['ms_per_step']:.1f} ms/step = "
        f"{out['tokens_per_s']:.0f} tokens/s; {flops / 1e12:.2f} TFLOP a "
        f"step, mfu_pct {out['mfu_pct']:.2f}; A {launched} launches "
        f"({out['a_launches_per_step']:g} per step); dense / flash plain "
        f"calls {spy.calls}; losses {['%.5f' % x for x in losses]}")
    want = 2 * LM_CFG["n_layers"] * (1 + LM_STEPS)
    if launched != want:
        raise Fail(f"lm_train {name}: A launched {launched} times, want "
                   f"{want} (a forward and a remat recompute per layer per "
                   f"step)")
    if any(spy.calls.values()):
        raise Fail(f"lm_train {name}: attention ran off kernel A: "
                   f"{spy.calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"lm_train {name}: losses not finite, or not falling on "
                   f"the memorized batch: {losses}")
    return out


def lm_parity(params0, tokens, dtype, **cfg_kw):
    """LM_PARITY_STEPS steps on kernel A and on the plain path from the
    same weights (remat on, the current policy, cfg_kw such as
    attn_window on both): first-step gradients per leaf and every loss,
    A's launches on each path."""
    grad_tol, loss_tol = LM_PARITY_TOL[dtype]
    cfg = TT.TransformerConfig(**LM_CFG, **cfg_kw, attn_impl="flash")
    runs = {}
    for path in ("kernel", "plain"):
        params = trainable(params0)
        FA.reset_launch_counts()
        with attention_spy(plain=path == "plain") as spy:
            loss = TT.loss(params, cfg, tokens)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            losses, _ = lm_train(params, cfg, tokens, LM_PARITY_STEPS)
        runs[path] = dict(grads=grads, losses=[x.item() for x in losses],
                          launched=FA.launch_counts["fwd"], calls=spy.calls)
        del params
    k, p = runs["kernel"], runs["plain"]
    g_err, _ = leaf_rel_errs(params0, k["grads"], p["grads"])
    l_err = max(abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                    p["losses"]))
    name = str(dtype)[6:] + "".join(f" {k}={v}" for k, v in cfg_kw.items())
    log(f"  parity {name:<8} T={tokens.shape[1]}: first-step gradients max "
        f"rel err {g_err:.2e} (tol {grad_tol:.0e}), losses {l_err:.2e} (tol "
        f"{loss_tol:.0e}); A launches: kernel path {k['launched']}, plain "
        f"path {p['launched']} ({p['calls']['flash_plain']} plain calls); "
        f"losses {['%.6f' % x for x in k['losses']]} vs "
        f"{['%.6f' % x for x in p['losses']]}")
    want = 2 * LM_CFG["n_layers"] * (1 + LM_PARITY_STEPS)
    if k["launched"] != want or any(k["calls"].values()):
        raise Fail(f"lm_train parity {name}: the kernel path launched A "
                   f"{k['launched']} times (want {want}); attention calls "
                   f"off A {k['calls']}")
    if p["launched"] or p["calls"]["dense"] or not p["calls"]["flash_plain"]:
        raise Fail(f"lm_train parity {name}: the plain path launched A "
                   f"{p['launched']} times; attention calls {p['calls']}")
    if g_err > grad_tol or l_err > loss_tol:
        raise Fail(f"lm_train parity {name}: kernel and plain paths "
                   f"differ: gradients {g_err:.2e}, losses {l_err:.2e}")
    return dict(grad_rel_err=g_err, loss_rel_err=l_err, losses=k["losses"],
                plain_losses=p["losses"])


def same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def lm_checkpoint_round_trip(params0, tokens):
    """CheckpointManager(max_to_keep=2) saves 3 kernel-path steps (the
    current policy): steps 2 and 3 remain, the state restored into a
    fresh template equals the live one leaf for leaf, one more step from
    each gives the same loss bit for bit, and the parameters tar
    round-trips the params exactly."""
    cfg = TT.TransformerConfig(**LM_CFG, attn_impl="flash")
    opt = OPT.adam(1e-3)
    state = TrainState.create(trainable(params0), {}, opt)
    template = TrainState.create(
        trainable(TT.init_params(LM_SEED + 1, cfg, device="cuda")), {}, opt)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CK.CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=2)
        for _ in range(3):
            lm_step(state.params, cfg, tokens, opt, state.opt_state,
                    state.step)
            state = state._replace(step=state.step + 1)
            mgr.save(state)
        kept = mgr.all_steps()
        restored = mgr.restore(template)
        equal = all(same_tree(getattr(restored, f), getattr(state, f))
                    for f in ("params", "opt_state", "step"))
        restored = restored._replace(params=trainable(restored.params))
        live = lm_step(state.params, cfg, tokens, opt, state.opt_state,
                       state.step)
        again = lm_step(restored.params, cfg, tokens, opt,
                        restored.opt_state, restored.step)
        tar = os.path.join(tmp, "params.tar")
        CK.save_parameters_tar(state.params, tar)
        tar_exact = same_tree(
            CK.load_parameters_tar(template.params, tar), state.params)
        mgr.close()
    bitwise = bool(torch.equal(live, again))
    log(f"  checkpoints: steps kept {kept} (max_to_keep 2); restored state "
        f"equal {equal}; one more step: loss {live.item():.7f} live, "
        f"{again.item():.7f} restored, bitwise {bitwise}; parameters tar "
        f"round trip exact {tar_exact}")
    if kept != [2, 3] or not (equal and bitwise and tar_exact):
        raise Fail(f"lm_train checkpoints: steps {kept}, restored equal "
                   f"{equal}, losses bitwise {bitwise}, tar exact "
                   f"{tar_exact}")
    return dict(steps_kept=kept, restored_equal=equal, loss_bitwise=bitwise,
                tar_exact=tar_exact)


def lm_train_phase():
    """The transformer LM's training path at bench_transformer_lm's width:
    the flash backward's cases and its time beside SDPA's, three
    full-width variants (bf16 policy, remat), parity with the plain path
    at T=LM_PARITY_T (f32, f32 in the window of LM_WINDOW keys, then
    bf16) and a checkpoint round trip."""
    log(f"phase lm_train: transformer LM {LM_CFG}, B={LM_B} T={LM_T}, adam "
        f"1e-3, the same batch every step")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [flash_bwd_case("causal_t2048", b=1, t=2048, h=8, dtype=dt)
             for dt in (f32, bf16)]
    cases += [
        flash_bwd_case("key_lens", b=4, t=512, h=8, lens=[512, 300, 37, 1],
                       seed=1),
        flash_bwd_case("window256_t2048", b=2, t=2048, h=8, window=256,
                       lens=[2048, 1500], seed=2),
        flash_bwd_case("head_dim128", b=1, t=256, h=4, d=128, seed=3),
        flash_bwd_case("head_dim128", b=1, t=256, h=4, d=128, dtype=bf16,
                       seed=3),
        flash_bwd_case("causal_t8192_b4", b=LM_B, t=LM_T, h=8, dtype=bf16,
                       seed=4),
    ]
    bad = [f"{c['name']}[{c['dtype']}]" for c in cases if not c["ok"]]
    if bad:
        raise Fail(f"lm_train: flash gradients disagree with the plain "
                   f"version: {bad}")
    timing = {str(dt)[6:]: flash_bwd_timing(dt) for dt in (bf16, f32)}
    torch.cuda.empty_cache()

    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, LM_CFG["vocab"], (LM_B, LM_T))
                              .astype(np.int32)).cuda()
    params0 = TT.init_params(LM_SEED, TT.TransformerConfig(**LM_CFG),
                             device="cuda")
    prev = TD.default_policy()
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        variants = [lm_variant("full_causal", params0, tokens),
                    lm_variant("window_1024", params0, tokens,
                               attn_window=LM_WINDOW),
                    lm_variant("fused_ce_2048", params0, tokens,
                               fused_ce_chunk=LM_CE_CHUNK)]
    finally:
        TD.set_default_policy(prev)
    torch.cuda.empty_cache()
    first = [v["losses"][0] for v in variants]
    ce_rel = abs(first[2] - first[0]) / abs(first[0])
    log(f"  fused CE's first loss {first[2]:.6f} vs unfused {first[0]:.6f}: "
        f"{ce_rel:.2e} relative (tol {LOSS_RTOL:.0e})")
    if ce_rel > LOSS_RTOL:
        raise Fail(f"lm_train: the fused CE's first loss differs: "
                   f"{ce_rel:.2e}")

    short = tokens[:, :LM_PARITY_T].contiguous()
    parity = {"float32": lm_parity(params0, short, f32),
              "float32_window_1024": lm_parity(params0, short, f32,
                                               attn_window=LM_WINDOW)}
    ckpt = lm_checkpoint_round_trip(params0, short)
    TD.set_default_policy(TD.bf16_compute_policy())
    try:
        parity["bfloat16"] = lm_parity(params0, short, bf16)
    finally:
        TD.set_default_policy(prev)
    del params0, tokens, short
    torch.cuda.empty_cache()
    return dict(flash_backward_cases=cases, flash_backward_timing=timing,
                variants=variants, fused_ce_first_loss_rel=ce_rel,
                parity=parity, checkpoint=ckpt,
                a_launches=sum(v["a_launches"] for v in variants),
                a_launches_per_step=variants[0]["a_launches_per_step"])


# -- distributed training on torch.distributed ----------------------------------

# NCCL refuses two ranks on one device, so the card runs the distributed
# layer at world size 1 over NCCL, and two ranks sharing cuda:0 over gloo
# for the collectives gloo takes on CUDA tensors. GLOO_CUDA is that list
# (f32 tensors) as scripts/torch_gloo_cuda_probe.py found it on the card
# (torch 2.11), GLOO_CUDA_BF16 those it also takes on bf16 tensors; the
# phase probes again and fails if the answer changed. GLOO_PATHS: the
# two-rank paths, each with the collectives it issues; the phase runs
# exactly those whose collectives are all on GLOO_CUDA, in f32 (the
# default policy), with the optimizer of JAX's DP gate.
GLOO_CUDA = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single")
GLOO_CUDA_BF16 = GLOO_CUDA
GLOO_PATHS = {"dp": ("all_reduce",),
              "zero": ("all_reduce", "reduce_scatter_tensor",
                       "all_gather_into_tensor"),
              "tp": ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor"),
              "cp_ring": ("batch_isend_irecv", "all_reduce"),
              "pipeline": ("batch_isend_irecv", "all_reduce")}
# paths whose collectives are on the list but which gloo cannot run on
# CUDA tensors all the same: DTensor's TP step (its functional, async
# collectives) killed both ranks with SIGSEGV in a gloo thread, in bf16
# and f32 alike (torch 2.11; the probe's synchronous calls pass)
GLOO_REFUSED = {"tp": "SIGSEGV in gloo under DTensor's async collectives"}
DIST_STEPS = 1            # after one warm-up step, world size 1 (cut from 2)
DIST_GLOO_STEPS = 1       # after one warm-up step, two ranks
DIST_GLOO_B = 2           # rows a rank; the two ranks share LM_B = 4 rows
DIST_GLOO_LR = 0.1        # sgd, as JAX's DP gate (tests/test_parallel.py:33)
DIST_TIMEOUT_S = 240      # the two ranks' join timeout
DIST_TP_STEPS = 16        # TP generate's new tokens (bench_decode's 128, cut)
DRYRUN_1_PARTS = ["toy_dp_tp_zero", "ring_attention", "sharded_embedding",
                  "resnet_dp", "ctr_alltoall", "seq2seq_dp",
                  "transformer_tp"]


def gloo_paths(cuda_list=None):
    cuda_list = GLOO_CUDA if cuda_list is None else cuda_list
    return [p for p, need in GLOO_PATHS.items() if p not in GLOO_REFUSED
            and all(c in cuda_list for c in need)]


def tree_diff(a, b):
    """(bitwise, max rel err) of two parameter trees (DTensors read as
    their local shard, which is the whole leaf at world size 1), in
    tree_leaves order, each leaf's error over its own max |b|."""
    same, worst = True, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x = x.to_local() if hasattr(x, "to_local") else x
        y = y.to_local() if hasattr(y, "to_local") else y
        same = same and torch.equal(x, y)
        worst = max(worst, abs_err(x, y) / max(y.abs().max().item(), 1e-30))
    return same, worst


def timed_steps(run_step, n):
    """(losses, ms per step after the first): run_step(i) -> loss."""
    losses = [run_step(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [run_step(i) for i in range(1, n)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(n - 1, 1)
    return [float(x) for x in losses], ms


def dist_parity(label, got, want, loss_got, loss_want, tol):
    """The gate of a distributed run against its reference: bit for bit
    where expected, else within tol (param rel, loss rel)."""
    bitwise, p_err = tree_diff(got, want)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(loss_got, loss_want))
    bitwise = bitwise and loss_got == loss_want
    log(f"  {label}: {'bit for bit' if bitwise else 'NOT bit for bit'}; "
        f"params max rel err {p_err:.2e}, losses {l_err:.2e} (tol "
        f"{tol[0]:.0e}, {tol[1]:.0e}); losses "
        f"{['%.6f' % x for x in loss_got]} vs "
        f"{['%.6f' % x for x in loss_want]}")
    if not bitwise and (p_err > tol[0] or l_err > tol[1]):
        raise Fail(f"distributed {label}: params {p_err:.2e}, losses "
                   f"{l_err:.2e}")
    return dict(bitwise=bitwise, param_rel_err=p_err, loss_rel_err=l_err)


def dist_lm_phase(mesh, params0, tokens):
    """The LM at bench_transformer_lm's width through the sharded step
    (TP_RULES on mesh (1, 1, 1)) and the ZeRO step (and its
    zero_update=False oracle arm) beside lm_train_phase's plain step,
    1 + DIST_STEPS steps each from params0, under the bf16 policy."""
    from paddle_tpu_torch.parallel import train_step as PTS

    cfg = TT.TransformerConfig(**LM_CFG)
    steps = 1 + DIST_STEPS
    tol = LM_PARITY_TOL[torch.bfloat16]
    out = {}
    params = trainable(params0)
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params)
    FA.reset_launch_counts()
    plain_losses, plain_ms = timed_steps(lambda i: lm_step(
        params, cfg, tokens, opt, opt_state,
        torch.tensor(i, dtype=torch.int32, device="cuda")), steps)
    out["plain"] = dict(ms_per_step=plain_ms, losses=plain_losses,
                        a_launches=FA.launch_counts["fwd"])
    plain_params = tree_map(lambda t: t.detach(), params)
    del opt_state
    torch.cuda.empty_cache()

    def run(label, state, step):
        box = [state]

        def one(i):
            box[0], loss, _ = step(box[0], None, (tokens,), ())
            return loss

        FA.reset_launch_counts()
        from torch.distributed.tensor.debug import CommDebugMode
        with CommDebugMode() as comm:
            losses, ms = timed_steps(one, steps)
        launched = FA.launch_counts["fwd"]
        log(f"  {label}: {ms:.1f} ms/step (plain {plain_ms:.1f}); A "
            f"{launched} launches ({launched / steps:g} a step); "
            f"collectives {dict((str(k), v) for k, v in comm.get_comm_counts().items())}")
        want = 2 * LM_CFG["n_layers"] * steps
        if launched != want:
            raise Fail(f"distributed {label}: A launched {launched} times, "
                       f"want {want}")
        return box[0], dict(ms_per_step=ms, losses=losses,
                            a_launches=launched,
                            a_launches_per_step=launched / steps,
                            collectives={str(k): v for k, v in
                                         comm.get_comm_counts().items()})

    state = PTS.shard_train_state(
        TrainState.create(trainable(params0), {}, opt), mesh,
        param_rules=TT.TP_RULES)
    step = PTS.make_sharded_train_step(GRAFT.LMLoss(cfg), GRAFT.identity_loss,
                                       opt, mesh, param_rules=TT.TP_RULES)
    state, out["sharded"] = run("sharded step (TP_RULES)", state, step)
    out["sharded"].update(dist_parity(
        "sharded step vs the plain step", state.params, plain_params,
        out["sharded"]["losses"], plain_losses, tol))
    sharded_params = tree_map(lambda t: t.to_local().detach(), state.params)
    del state, step
    torch.cuda.empty_cache()

    zero = {}
    for arm in ("zero_update", "oracle"):
        st = TrainState.create_zero(trainable(params0), {}, opt, mesh)
        if arm == "zero_update":
            zero["opt_state_bytes_per_replica"] = \
                PTS.opt_state_bytes_per_replica(st.opt_state)
        zstep = PTS.make_zero_train_step(
            GRAFT.LMLoss(cfg), GRAFT.identity_loss, opt, mesh,
            zero_update=arm == "zero_update")
        st, zero[arm] = run(f"ZeRO step ({arm})", st, zstep)
        zero[arm]["params"] = tree_map(lambda t: t.to_local().detach(),
                                       st.params)
        del st, zstep
        torch.cuda.empty_cache()
    z, o = zero["zero_update"], zero["oracle"]
    bitwise, err = tree_diff(z["params"], o["params"])
    log(f"  ZeRO vs its oracle arm: {'bit for bit' if bitwise else 'DIFFER'}"
        f" (params max rel err {err:.2e}); losses {z['losses']} vs "
        f"{o['losses']}")
    if not bitwise or z["losses"] != o["losses"]:
        raise Fail("distributed: ZeRO is not bit for bit its oracle arm")
    out["zero"] = dict(zero_update={k: v for k, v in z.items()
                                    if k != "params"},
                       oracle={k: v for k, v in o.items() if k != "params"},
                       bitwise_vs_oracle=True,
                       opt_state_bytes_per_replica=zero[
                           "opt_state_bytes_per_replica"])
    out["zero"].update(dist_parity("ZeRO step vs the sharded step",
                                   z["params"], sharded_params, z["losses"],
                                   out["sharded"]["losses"], tol))
    return out


def dist_cp_phase(mesh, params0, tokens):
    """make_context_parallel_loss, ring and Ulysses, at the LM's width
    and T=LM_PARITY_T beside the plain loss (kernel A): loss and every
    gradient within 1e-4 (f32 policy)."""
    cfg = TT.TransformerConfig(**LM_CFG)
    short = tokens[:, :LM_PARITY_T].contiguous()
    params = trainable(params0)
    loss = TT.loss(params, cfg, short)
    want = torch.autograd.grad(loss, tree_leaves(params))
    want_loss = loss.item()
    out = {}
    for kind in ("ring", "ulysses"):
        params = trainable(params0)
        fn = TT.make_context_parallel_loss(cfg, mesh, kind=kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fn(params, short)
        got = torch.autograd.grad(loss, tree_leaves(params))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        g_err, _ = leaf_rel_errs(params0, got, want)
        l_err = abs(loss.item() - want_loss) / abs(want_loss)
        log(f"  context parallel ({kind}) T={LM_PARITY_T}: loss "
            f"{loss.item():.6f} vs plain {want_loss:.6f} ({l_err:.2e}); "
            f"gradients max rel err {g_err:.2e} (tol 1e-4); {ms:.1f} ms")
        if l_err > 1e-4 or g_err > 1e-4:
            raise Fail(f"distributed CP {kind}: loss {l_err:.2e}, "
                       f"gradients {g_err:.2e}")
        out[kind] = dict(loss_rel_err=l_err, grad_rel_err=g_err, ms=ms)
    return out


def dist_tp_generate(mesh):
    """TP generate at bench_decode's B=8, 128-token prompts and
    DIST_TP_STEPS new tokens, on TP_RULES parameters (mesh (1, 1, 1)) beside the unsharded generate: tokens
    equal or differing by the gap rule; A runs in the prefill."""
    from paddle_tpu_torch.parallel import sharding as PSH

    cfg = TT.TransformerConfig(**SERVE_CFG)
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    params = TT.init_params(0, cfg, device="cuda")
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (DEC_B, DEC_PROMPT)).astype(np.int32)).cuda()
    sharded = PSH.place(params, PSH.make_param_shardings(params, mesh,
                                                         TT.TP_RULES))
    FA.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = TT.generate(sharded, cfg, PSH.place(prompt, PSH.batch_sharding(
        mesh)), steps=DIST_TP_STEPS)
    toks = toks.full_tensor() if hasattr(toks, "full_tensor") else toks
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t0
    launched = FA.launch_counts["fwd"]
    t0 = time.perf_counter()
    ref = TT.generate(params, cfg, prompt, steps=DIST_TP_STEPS)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    teach = teacher_logits(params, plain_cfg, ref, DEC_PROMPT)

    def gap(row, step):
        top2 = torch.topk(teach[row, step], 2).values
        return (top2[0] - top2[1]).item()

    same = decode_gap_rule("TP generate", toks, ref, DEC_PROMPT, gap)
    log(f"  TP generate: {tp_s:.2f} s vs unsharded {ref_s:.2f} s; A "
        f"{launched} launches (want {cfg.n_layers}, the prefill)")
    if launched != cfg.n_layers:
        raise Fail(f"distributed TP generate: A launched {launched} times")
    return dict(rows_equal=same, s=tp_s, unsharded_s=ref_s,
                a_launches=launched)


def gloo_path_run(path, world, mesh, ref, cfg, params0, tokens):
    """One two-rank path ("dp", "zero" or "tp") at the LM's width, 1 +
    DIST_GLOO_STEPS steps, held against the reference's parameters."""
    from paddle_tpu_torch.core import mesh as MESH
    from paddle_tpu_torch.parallel import collectives as COLL
    from paddle_tpu_torch.parallel import train_step as PTS
    from torch.distributed.tensor.debug import CommDebugMode

    opt = OPT.sgd(DIST_GLOO_LR)
    steps = 1 + DIST_GLOO_STEPS
    COLL.reset_launch_counts()
    FA.reset_launch_counts()
    out = {}
    if path == "dp":
        st = PTS.shard_train_state(TrainState.create(
            trainable(params0), {}, opt), mesh)
        step = PTS.make_sharded_train_step(
            GRAFT.LMLoss(cfg), GRAFT.identity_loss, opt, mesh)
    elif path == "zero":
        # adam's flat moments at two ranks, beside world size 1's (the
        # steps run sgd, whose state is empty)
        adam = TrainState.create_zero(params0, {}, OPT.adam(1e-3), mesh)
        out["zero_bytes"] = PTS.opt_state_bytes_per_replica(adam.opt_state)
        del adam
        st = TrainState.create_zero(trainable(params0), {}, opt, mesh)
        step = PTS.make_zero_train_step(
            GRAFT.LMLoss(cfg), GRAFT.identity_loss, opt, mesh)
    elif path == "tp":
        tmesh = MESH.build_mesh(MESH.MeshConfig(1, world, 1), device="cuda")
        st = PTS.shard_train_state(TrainState.create(
            trainable(params0), {}, opt), tmesh, param_rules=TT.TP_RULES)
        step = PTS.make_sharded_train_step(
            GRAFT.LMLoss(cfg), GRAFT.identity_loss, opt, tmesh,
            param_rules=TT.TP_RULES)
    else:
        raise ValueError(f"no two-rank path {path!r}")
    box, first = [st], []
    full = lambda params: tree_map(lambda t: (
        t.full_tensor() if hasattr(t, "full_tensor") else t).cpu(), params)

    def one(i):
        box[0], loss, _ = step(box[0], None, (tokens,), ())
        if i == 0:
            first.append(full(box[0].params))
        return loss

    with CommDebugMode() as comm:
        losses, ms = timed_steps(one, steps)
    errs, close = [], True
    for got, want in ((first[0], ref["params1"]),
                      (full(box[0].params), ref["params"])):
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        errs.append(max(abs_err(g, w) for g, w in pairs))
        # rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:58-61)
        close = close and all(torch.allclose(g, w, rtol=1e-4, atol=1e-5)
                              for g, w in pairs)
    out.update(
        losses=losses, ms_per_step=ms,
        loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                         zip(losses, ref["losses"])),
        # after step 1 and after the last step
        param_max_abs_err=errs, params_close=close,
        a_launches=FA.launch_counts["fwd"],
        collectives=dict(COLL.launch_counts),
        bytes_moved=dict(COLL.bytes_moved),
        dtensor_collectives={str(k): v for k, v in
                             comm.get_comm_counts().items()})
    return out


def gloo_rank(rank, world, rdv, ref_path, out_path, cuda_list, job="lm"):
    """One of two ranks sharing cuda:0 over gloo: job "lm", the LM paths
    whose collectives are all on the fixed list `cuda_list`; job
    "sparse_elastic", the CTR step over model=2 and the ZeRO LM step
    saved for the elastic restore. Each rank's results are written to
    out_path.<rank> as each path ends (a path that fails records its
    error; one whose peer failed may hang, and the parent's timeout ends
    it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import faulthandler
    import traceback

    faulthandler.enable()   # a crash in a collective names its frame

    import torch.distributed as dist

    from paddle_tpu_torch.core import mesh as MESH
    from paddle_tpu_torch.parallel import distributed as PD

    PD.initialize(f"file://{rdv}", world, rank, device="cuda",
                  backend="gloo")
    ref = torch.load(ref_path)
    if job == "sparse_elastic":
        res = {}
        for name, run in (("ctr", lambda o: ctr_gloo_run(ref, o)),
                          ("zero_save", lambda o: zero_save_run(
                              ref, o, ref["ckpt_dir"]))):
            res[name] = {}
            try:
                run(res[name])
            except Exception:
                res[name] = {"error": traceback.format_exc()[-3000:]}
            torch.cuda.empty_cache()
            with open(f"{out_path}.{rank}", "w") as f:
                json.dump(res, f)
        PD.sync_hosts()
        dist.destroy_process_group()
        return
    cfg = TT.TransformerConfig(**LM_CFG)
    tokens = ref["tokens"].cuda()
    params0 = tree_map(lambda t: t.cuda(), ref["params0"])
    mesh = MESH.build_mesh(MESH.MeshConfig(world, 1, 1), device="cuda")
    res = {}
    for path in gloo_paths(cuda_list):
        try:
            res[path] = gloo_path_run(path, world, mesh, ref, cfg, params0,
                                      tokens)
        except Exception:
            res[path] = {"error": traceback.format_exc()[-3000:]}
        torch.cuda.empty_cache()
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(res, f)
    PD.sync_hosts()
    dist.destroy_process_group()


def start_gloo_probe():
    """scripts/torch_gloo_cuda_probe.py in a child process (each
    collective in a fresh pair of ranks: a refused one may abort its
    process), started while the world-size-1 part runs: its ranks spend
    their time reaching the card."""
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO_DIR, "scripts",
                                      "torch_gloo_cuda_probe.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def gloo_probe(proc):
    """The probe's answer: {collective: True or what happened}."""
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT_S + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [l for l in out.splitlines() if l.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise Fail(f"distributed: the gloo probe exited {proc.returncode}: "
                   f"{err[-2000:]}")
    return json.loads(lines[-1])["gloo_cuda"]


def dist_gloo_phase(params0, tokens, probe_proc):
    """Two ranks sharing cuda:0 over gloo: the probe, which must find
    GLOO_CUDA and GLOO_CUDA_BF16, then the paths of gloo_paths() at the
    LM's width in f32, B=DIST_GLOO_B a rank over LM_B rows, against the
    plain step on all LM_B rows, sgd(DIST_GLOO_LR), 1 + DIST_GLOO_STEPS
    steps: losses rtol 1e-5, the parameters after the first and the
    last step rtol 1e-4 / atol 1e-5 (JAX's DP gate,
    tests/test_parallel.py:58-61; adam's first steps move a parameter
    whose gradient is ~0 by ~lr either way, so the gate keeps JAX's
    sgd)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    probe = gloo_probe(probe_proc)
    log(f"  gloo on cuda:0, each collective in its own two ranks (waited "
        f"{time.perf_counter() - t0:.1f} s for the probe): {probe}")
    found = tuple(k for k, v in probe.items()
                  if v is True or str(v).startswith("f32 only"))
    found_bf16 = tuple(k for k, v in probe.items() if v is True)
    if found != GLOO_CUDA or found_bf16 != GLOO_CUDA_BF16:
        raise Fail(f"distributed: gloo's CUDA collectives changed: found "
                   f"{found} (bf16 {found_bf16}), the fixed lists are "
                   f"{GLOO_CUDA} (bf16 {GLOO_CUDA_BF16})")
    res = {"probe": probe,
           "held_on_cpu_only": {p: GLOO_REFUSED.get(p, "collectives " + str(
               [c for c in need if c not in GLOO_CUDA]))
               for p, need in GLOO_PATHS.items() if p not in gloo_paths()}}
    log(f"  gloo: two-rank paths {gloo_paths()}; held on the CPU only: "
        f"{res['held_on_cpu_only']}")
    if not gloo_paths():
        return res

    cfg = TT.TransformerConfig(**LM_CFG)
    rows = tokens[:DIST_GLOO_B * 2].contiguous()
    params = trainable(params0)
    opt = OPT.sgd(DIST_GLOO_LR)
    opt_state = opt.init(params)
    host = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
    first = []

    def one(i):
        loss = lm_step(params, cfg, rows, opt, opt_state,
                       torch.tensor(i, dtype=torch.int32, device="cuda"))
        if i == 0:
            first.append(host(params))
        return loss

    losses, ms = timed_steps(one, 1 + DIST_GLOO_STEPS)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"tokens": rows.cpu(), "losses": losses,
                    "params0": host(params0), "params1": first[0],
                    "params": host(params)}, ref_path)
        del params, opt_state
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "gloo.json")
        procs = [ctx.Process(target=gloo_rank, args=(
            r, 2, os.path.join(tmp, "rendezvous"), ref_path, out,
            GLOO_CUDA))
            for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        ranks = []
        for r in range(2):
            path = f"{out}.{r}"
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {})
        errors = {f"rank {r} {p}": v["error"] for r, got in
                  enumerate(ranks) for p, v in got.items() if "error" in v}
        res.update(ranks[0])
    res["plain"] = dict(losses=losses, ms_per_step=ms)
    for path in gloo_paths():
        r = res.get(path, {})
        if "losses" not in r:
            continue
        per_step = {k: v // (1 + DIST_GLOO_STEPS)
                    for k, v in r["bytes_moved"].items() if v}
        log(f"  gloo {path}: {r['ms_per_step']:.1f} ms/step (plain one "
            f"process, {2 * DIST_GLOO_B} rows: {ms:.1f}); losses "
            f"{['%.6f' % x for x in r['losses']]} vs "
            f"{['%.6f' % x for x in losses]} ({r['loss_rel_err']:.2e}); "
            f"params close {r['params_close']} (max abs err after step 1 "
            f"and after step {1 + DIST_GLOO_STEPS}: "
            f"{['%.2e' % e for e in r['param_max_abs_err']]}); A "
            f"{r['a_launches']} launches; "
            f"explicit collectives {r['collectives']}, bytes a step "
            f"{per_step}; DTensor's {r['dtensor_collectives']}")
    if alive or any(p.exitcode != 0 for p in procs) or errors \
            or set(ranks[0]) != set(gloo_paths()):
        raise Fail(f"distributed gloo ranks: exit codes "
                   f"{[p.exitcode for p in procs]} ({len(alive)} killed at "
                   f"the {DIST_TIMEOUT_S} s timeout); paths done "
                   f"{sorted(ranks[0])}; errors {errors}")
    for path in gloo_paths():
        r = res[path]
        if r["loss_rel_err"] > 1e-5 or not r["params_close"]:
            raise Fail(f"distributed gloo {path}: losses "
                       f"{r['loss_rel_err']:.2e}, params close "
                       f"{r['params_close']}")
    return res


def distributed_phase():
    """The distributed layer on the card (see the module docstring,
    phase 8a): world size 1 over NCCL, then two ranks over gloo, the
    gloo probe running from the start."""
    from paddle_tpu_torch.core import mesh as MESH

    t_phase = time.perf_counter()
    log(f"phase distributed: NCCL at world size 1, then two ranks on "
        f"cuda:0 over gloo (paths {gloo_paths()})")
    torch.cuda.empty_cache()
    probe = start_gloo_probe()
    try:
        mesh = MESH.build_mesh(MESH.MeshConfig(1, 1, 1))
        out = {}
        t0 = time.perf_counter()
        rep = GRAFT.dryrun_multichip(1)
        out["dryrun"] = dict(rep, s=time.perf_counter() - t0)
        log(f"  dryrun_multichip(1): ran {rep['ran']} in "
            f"{out['dryrun']['s']:.1f} s; losses {rep['losses']}")
        if rep["ran"] != DRYRUN_1_PARTS:
            raise Fail(f"distributed: dryrun_multichip(1) ran {rep['ran']}")
        rs = np.random.RandomState(0)
        tokens = torch.from_numpy(rs.randint(0, LM_CFG["vocab"], (LM_B, LM_T))
                                  .astype(np.int32)).cuda()
        params0 = TT.init_params(LM_SEED, TT.TransformerConfig(**LM_CFG),
                                 device="cuda")
        # the parts timed least closely first, while the probe's ranks start
        out["context_parallel"] = dist_cp_phase(mesh, params0, tokens)
        torch.cuda.empty_cache()
        out["tp_generate"] = dist_tp_generate(mesh)
        torch.cuda.empty_cache()
        prev = TD.default_policy()
        TD.set_default_policy(TD.bf16_compute_policy())
        try:
            out["lm"] = dist_lm_phase(mesh, params0, tokens)
        finally:
            TD.set_default_policy(prev)
        import torch.distributed as dist

        dist.destroy_process_group()
        torch.cuda.empty_cache()
        out["gloo"] = dist_gloo_phase(params0, tokens, probe)
    finally:
        if probe.poll() is None:
            probe.kill()
            probe.wait()
    if "zero" in out["gloo"]:
        one = out["lm"]["zero"]["opt_state_bytes_per_replica"]
        two = out["gloo"]["zero"]["zero_bytes"]
        log(f"  ZeRO opt_state_bytes_per_replica: world 1 {one}, two ranks "
            f"{two}")
        if not one / 2 <= two <= one / 2 + 1024 * len(tree_leaves(params0)):
            raise Fail(f"distributed: ZeRO at 2 ranks holds {two} bytes, "
                       f"world 1 {one}")
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase distributed: {out['s']:.1f} s")
    return out


# -- sparse embeddings, the TP engine pool, the elastic layer ------------------

# bench_ctr_sparse(batch=4096, slots=32, vocab=1_000_000, dim=64, iters=20)
# (benchmarks/suite.py:267, sizes at :811-815): wide & deep over two
# tables of vocab + 1 rows, MLP (64, 32) -> 1, adam 1e-3 on the MLP, row
# SGD at 0.05 on the tables, f32; 2 warm-up steps, 20 timed
CTR_B, CTR_SLOTS, CTR_VOCAB, CTR_DIM = 4096, 32, 1_000_000, 64
CTR_WARMUP, CTR_ITERS, CTR_ROW_LR, CTR_SEED = 2, 20, 0.05, 0
CTR_GLOO_STEPS = 2        # after one warm-up step, two ranks on cuda:0
TP_POOL_REQ = 4           # the serve phase's first 4 of its 32 requests
TP_POOL_NEW = 32          # new tokens a request (the serve phase's 128, cut)
# the elastic gang: the resilient phase's bench_lstm classifier (one
# batch of 64 repeated, 32 rows a member) through `train --elastic`'s
# builder, two members on cuda:0 over gloo, SIGKILL of rank 1 at its
# heartbeat step GANG_KILL_AT
GANG_STEPS, GANG_EVERY, GANG_KILL_AT, GANG_DEADLINE_S = 6, 2, 2, 400
# the resilient phase's config with (input, label) samples and the
# default CE, as `train --elastic`'s builder takes them
GANG_CONFIG = (RES_CONFIG
               .replace("yield padded, np.int64(label), np.float32(1.0)",
                        "yield padded, np.int64(label)")
               .replace('"loss_fn": weighted_ce, ', ""))
assert GANG_CONFIG.count("np.float32(1.0)") == 0 \
    and GANG_CONFIG.count("weighted_ce,") == 0


def ctr_batch():
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, CTR_VOCAB, (CTR_B, CTR_SLOTS))
                           .astype(np.int32))
    labels = torch.from_numpy(rs.randint(0, 2, CTR_B).astype(np.int32))
    return ids, labels


def ctr_model(mesh, exchange="alltoall"):
    from paddle_tpu_torch.models.ctr import CTRModel

    return CTRModel(vocab=CTR_VOCAB, embed_dim=CTR_DIM, mesh=mesh,
                    exchange=exchange)


def ctr_params(model, full):
    """A copy of a full parameter tree (CPU tensors) placed by the model:
    the tables padded to its sharded row count, then row-sharded (the
    steps update in place, so `full` must stay as it is)."""
    pad = lambda t, rows: torch.cat([t, t.new_zeros(
        (rows - t.shape[0],) + tuple(t.shape[1:]))])
    return model.place({"deep": pad(full["deep"], model.table.padded_vocab),
                        "wide": pad(full["wide"], model.wide.padded_vocab),
                        "mlp": tree_map(torch.clone, full["mlp"])})


def ctr_run(model, params, ids, labels, steps, on_step=None):
    """(losses, final params) of `steps` CTR steps from `params` (placed),
    adam(1e-3) on the MLP."""
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params["mlp"])
    step = model.make_train_step(opt, {})
    dev = model.mesh.device
    ids, labels = ids.to(dev), labels.to(dev)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(
            params, opt_state, ids, labels, CTR_ROW_LR,
            torch.tensor(i, dtype=torch.int32, device=dev))
        losses.append(loss)
        if on_step is not None:
            on_step(i)
    return [float(l) for l in losses], params


def host_tree(tree):
    """A tree of (D)Tensors as full CPU tensors (gathered by synchronous
    collectives, which gloo takes on CUDA tensors: `gather_full`)."""
    from paddle_tpu_torch.core.mesh import gather_full

    return tree_map(lambda t: gather_full(t).detach().cpu(), tree)


def ctr_gate(full0, ids, labels, mesh, cpu_mesh):
    """The first CTR step on the card against the port's plain run of the
    same step on the CPU, at full width, per exchange: loss 1e-5
    (relative), MLP 1e-4 and touched rows 1e-5 (max abs error over the
    reference's max |value|), rows no id touched bit for bit unchanged."""
    touched = torch.zeros(CTR_VOCAB + 1, dtype=torch.bool)
    touched[ids.reshape(-1).long()] = True
    out = {}
    for ex in ("alltoall", "psum"):
        card_m, cpu_m = ctr_model(mesh, ex), ctr_model(cpu_mesh, ex)
        (l_card,), p_card = ctr_run(card_m, ctr_params(card_m, full0), ids,
                                    labels, 1)
        (l_cpu,), p_cpu = ctr_run(cpu_m, ctr_params(cpu_m, full0), ids,
                                  labels, 1)
        p_card, p_cpu = host_tree(p_card), host_tree(p_cpu)
        errs = {"loss": abs(l_card - l_cpu) / abs(l_cpu),
                "mlp": max(abs_err(a, b) / b.abs().max().item() for a, b in
                           zip(tree_leaves(p_card["mlp"]),
                               tree_leaves(p_cpu["mlp"])))}
        untouched_same = True
        for k in ("deep", "wide"):
            got, want = p_card[k][:CTR_VOCAB + 1], p_cpu[k][:CTR_VOCAB + 1]
            errs[k] = (abs_err(got[touched], want[touched])
                       / want[touched].abs().max().item())
            untouched_same = untouched_same and torch.equal(
                got[~touched], full0[k][~touched])
        log(f"  CTR first step, {ex}: loss {l_card:.7f} vs CPU "
            f"{l_cpu:.7f} ({errs['loss']:.2e}, tol 1e-5); MLP "
            f"{errs['mlp']:.2e} (1e-4); touched rows deep "
            f"{errs['deep']:.2e} wide {errs['wide']:.2e} (1e-5); "
            f"{int((~touched).sum())} untouched rows bit for bit: "
            f"{untouched_same}")
        if (errs["loss"] > 1e-5 or errs["mlp"] > 1e-4 or errs["deep"] > 1e-5
                or errs["wide"] > 1e-5 or not untouched_same):
            raise Fail(f"CTR {ex}: first step against the CPU {errs}, "
                       f"untouched rows unchanged {untouched_same}")
        out[ex] = dict(errs, untouched_bitwise=untouched_same,
                       loss=l_card, loss_cpu=l_cpu,
                       touched_rows=int(touched.sum()))
    return out


def ctr_timing(full0, ids, labels, mesh):
    """bench_ctr_sparse's measure: CTR_WARMUP steps, then CTR_ITERS steps
    ending in a sync, all-to-all exchange; the bench's reckoning
    (benchmarks/suite.py:316-327): rows moved per step are the deep and
    wide lookups and their pushes, (dim + 1) f32 values each way."""
    model = ctr_model(mesh)
    params = ctr_params(model, full0)
    opt = OPT.adam(1e-3)
    opt_state = opt.init(params["mlp"])
    step = model.make_train_step(opt, {})
    ids, labels = ids.cuda(), labels.cuda()
    i0 = torch.zeros((), dtype=torch.int32, device="cuda")
    for _ in range(CTR_WARMUP):
        params, opt_state, loss = step(params, opt_state, ids, labels,
                                       CTR_ROW_LR, i0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CTR_ITERS):
        params, opt_state, loss = step(params, opt_state, ids, labels,
                                       CTR_ROW_LR, i0)
    loss = float(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / CTR_ITERS
    rows = CTR_B * CTR_SLOTS * 2 * 2
    row_bytes = CTR_B * CTR_SLOTS * 2 * (CTR_DIM + 1) * 4
    out = dict(ms_per_batch=1e3 * dt, rows_per_sec=rows / dt,
               examples_per_sec=CTR_B / dt,
               row_exchange_gbps=row_bytes / dt / 1e9,
               hbm_share=(row_bytes / dt) / HBM_BYTES_PER_S,
               last_loss=loss)
    log(f"  CTR at bench_ctr_sparse's width (B={CTR_B}, {CTR_SLOTS} slots, "
        f"vocab {CTR_VOCAB}, dim {CTR_DIM}, deep table "
        f"{(CTR_VOCAB + 1) * CTR_DIM * 4 / 1e6:.1f} MB): "
        f"{out['ms_per_batch']:.3f} ms/batch, {out['rows_per_sec']:.4g} "
        f"rows/s, {out['examples_per_sec']:.4g} examples/s, row exchange "
        f"{out['row_exchange_gbps']:.2f} GB/s = "
        f"{100 * out['hbm_share']:.3f}% of 3.35 TB/s")
    if not np.isfinite(loss):
        raise Fail(f"CTR timing: loss {loss}")
    return out


def host_offload_gate(full0, ids, mesh):
    """HostOffloadEmbedding at the CTR table's vocab and dim for the
    batch's ids: one lookup and one apply_row_grads. Its rows equal
    ShardedEmbedding's bit for bit; the card's peak memory grows by the
    [K, D] rows the lookup returns (at most 2x their bytes), never by the table; the host table's update equals the
    same row SGD on the card. (A tenth of the table's bytes cannot bound
    the growth: the lookup's own [K, D] output is 13% of the table.)"""
    from paddle_tpu_torch.parallel import sparse as SP

    model = ctr_model(mesh)
    deep = model.table.place(full0["deep"])
    flat = ids.reshape(-1).cuda()
    ref = model.table.lookup(deep, flat)
    emb = SP.HostOffloadEmbedding(CTR_VOCAB + 1, CTR_DIM)
    table = emb.place(full0["deep"].clone())
    grads = torch.randn(ref.shape, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda") * 1e-2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows = emb.lookup(table, flat)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emb.apply_row_grads(table, flat, grads, CTR_ROW_LR)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grown = torch.cuda.max_memory_allocated() - base
    rows_bytes = rows.numel() * rows.element_size()
    table_bytes = table.numel() * table.element_size()
    exact = torch.equal(rows, ref)
    want = full0["deep"].cuda().index_add_(
        0, flat.long(), -CTR_ROW_LR * grads).cpu()
    upd_err = abs_err(table, want)
    out = dict(rows_bitwise=exact, peak_growth_bytes=grown,
               rows_bytes=rows_bytes, table_bytes=table_bytes,
               growth_over_table=grown / table_bytes,
               lookup_ms=1e3 * (t1 - t0), update_ms=1e3 * (t2 - t1),
               update_max_abs_err=upd_err, pinned=table.is_pinned())
    log(f"  HostOffloadEmbedding ({CTR_VOCAB + 1} x {CTR_DIM} on the host, "
        f"pinned {out['pinned']}; {flat.numel()} ids): rows bit for bit "
        f"{exact}; the card's peak grew {grown / 2**20:.1f} MiB "
        f"({100 * grown / table_bytes:.1f}% of the table's "
        f"{table_bytes / 2**20:.1f} MiB; the rows alone "
        f"{rows_bytes / 2**20:.1f} MiB); lookup {out['lookup_ms']:.2f} "
        f"ms, update {out['update_ms']:.2f} ms; update vs the card's "
        f"row SGD {upd_err:.2e}")
    if not exact or grown > 2 * rows_bytes or grown >= table_bytes / 2 \
            or upd_err > 1e-6 or not out["pinned"]:
        raise Fail(f"host offload: {out}")
    return out


def ctr_gloo_run(ref, out):
    """Rank side: the CTR step with both tables row-sharded over model=2,
    the all-to-all exchange, 1 + CTR_GLOO_STEPS steps at full width
    (CTR_B / 2 rows a rank), against the one-process steps: losses 1e-5
    (relative), parameters rtol 1e-4 / atol 1e-5."""
    from paddle_tpu_torch.core import mesh as MESH
    from paddle_tpu_torch.parallel import collectives as COLL

    mesh = MESH.build_mesh(MESH.MeshConfig(1, 2, 1), device="cuda")
    model = ctr_model(mesh)
    params = ctr_params(model, ref["ctr_params0"])
    COLL.reset_launch_counts()
    marks = []

    def on_step(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    losses, params = ctr_run(model, params, ref["ctr_ids"],
                             ref["ctr_labels"], 1 + CTR_GLOO_STEPS, on_step)
    counts, moved = dict(COLL.launch_counts), dict(COLL.bytes_moved)
    got = host_tree(params)
    close, worst = True, 0.0
    for k, want in ref["ctr_params"].items():
        for g, w in zip(tree_leaves(got[k]), tree_leaves(want)):
            g = g[:w.shape[0]]
            worst = max(worst, abs_err(g, w))
            close = close and torch.allclose(g, w, rtol=1e-4, atol=1e-5)
    out.update(
        losses=losses, loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                                        zip(losses, ref["ctr_losses"])),
        params_close=close, param_max_abs_err=worst,
        ms_per_step=1e3 * (marks[-1] - marks[0]) / CTR_GLOO_STEPS,
        all_to_all_per_step=counts["all_to_all"] / (1 + CTR_GLOO_STEPS),
        all_to_all_bytes_per_step=moved["all_to_all"] // (1 + CTR_GLOO_STEPS),
        collectives=counts)


def zero_save_run(ref, out, ckpt_dir):
    """Rank side: one ZeRO LM step at lm_train's width (f32, adam, so the
    moments are not empty) on two ranks, B = DIST_GLOO_B a rank, saved
    through the ElasticCheckpointManager; rank 0 also writes the state's
    full parameters and unpadded moments for the parent's bit-for-bit
    check."""
    from paddle_tpu_torch.core import mesh as MESH
    from paddle_tpu_torch.parallel import train_step as PTS

    cfg = TT.TransformerConfig(**LM_CFG)
    mesh = MESH.build_mesh(MESH.MeshConfig(2, 1, 1), device="cuda")
    params0 = TT.init_params(LM_SEED, cfg, device="cuda")
    opt = OPT.adam(1e-3)
    st = TrainState.create_zero(params0, {}, opt, mesh)
    step = PTS.make_zero_train_step(GRAFT.LMLoss(cfg), GRAFT.identity_loss,
                                    opt, mesh)
    FA.reset_launch_counts()
    st, loss, _ = step(st, None, (ref["lm_tokens"].cuda(),), ())
    out["zero_a_launches"] = FA.launch_counts["fwd"]
    out["zero_loss"] = float(loss)
    CK.ElasticCheckpointManager(ckpt_dir, mesh=mesh).save(st)
    full = {"params": host_tree(st.params), "step": int(st.step),
            "opt": unpadded_moments(st.params, st.opt_state)}
    if mesh.axis_index("data") == 0:
        torch.save(full, os.path.join(ckpt_dir, "saved_state.pt"))


def unpadded_moments(params, opt_state):
    """{keystr: the unpadded CPU vector} of every flat ZeRO moment."""
    from paddle_tpu_torch.core.pytree import flatten_with_keys
    from paddle_tpu_torch.parallel.train_step import zero_true_sizes

    sizes = dict(flatten_with_keys(zero_true_sizes(params, opt_state)))
    return {k: v.reshape(-1)[:sizes[k]] for k, v in
            flatten_with_keys(host_tree(opt_state))}


def elastic_restore_gate(ckpt_dir, tokens):
    """The two-rank ZeRO state restored at world size 1 over NCCL: the
    unpadded parameters and adam's m and v bit for bit the saved ones,
    the manifest's data 2 -> 1, reshard_restores == 1; then one more
    world-size-1 ZeRO step from it is bit for bit the same step from the
    saved state loaded without resharding (built from the saved tensors
    directly: at one rank the flat layout is the unpadded vector)."""
    from paddle_tpu_torch.core import mesh as MESH
    from paddle_tpu_torch.core.pytree import flatten_with_keys, unflatten_like
    from paddle_tpu_torch.parallel import train_step as PTS

    cfg = TT.TransformerConfig(**LM_CFG)
    mesh = MESH.build_mesh(MESH.MeshConfig(1, 1, 1), device="cuda")
    opt = OPT.adam(1e-3)
    template = lambda: TrainState.create_zero(
        TT.init_params(LM_SEED, cfg, device="cuda"), {}, opt, mesh)
    mgr = CK.ElasticCheckpointManager(ckpt_dir, mesh=mesh)
    restored = mgr.restore(template())
    manifest = json.load(open(mgr._manifest_path(mgr.latest_step())))
    saved = torch.load(os.path.join(ckpt_dir, "saved_state.pt"))
    got = unpadded_moments(restored.params, restored.opt_state)
    params_same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(host_tree(restored.params)),
        tree_leaves(saved["params"])))
    moments_same = (sorted(got) == sorted(saved["opt"]) and all(
        torch.equal(got[k], saved["opt"][k]) for k in got))
    # the same state, loaded without resharding
    plain = template()
    plain_opt = unflatten_like(plain.opt_state, [
        MESH.distribute(saved["opt"][k].cuda(), MESH.NamedSharding(
            mesh, MESH.P(*(("data",) if leaf.dim() else ()))))
        for k, leaf in flatten_with_keys(plain.opt_state)])
    plain = TrainState(
        params=tree_map(lambda t: MESH.distribute(
            t.cuda(), MESH.replicated(mesh)), saved["params"]),
        model_state={}, opt_state=plain_opt,
        step=MESH.distribute(torch.tensor(saved["step"], dtype=torch.int32,
                                          device="cuda"),
                             MESH.replicated(mesh)))
    step = PTS.make_zero_train_step(GRAFT.LMLoss(cfg), GRAFT.identity_loss,
                                    opt, mesh)
    FA.reset_launch_counts()
    st_a, loss_a, _ = step(restored, None, (tokens,), ())
    st_b, loss_b, _ = step(plain, None, (tokens,), ())
    a_launches = FA.launch_counts["fwd"]
    next_same = (float(loss_a) == float(loss_b) and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(host_tree(st_a.params)),
            tree_leaves(host_tree(st_b.params)))) and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(host_tree(st_a.opt_state)),
            tree_leaves(host_tree(st_b.opt_state)))))
    out = dict(params_bitwise=params_same, moments_bitwise=moments_same,
               manifest_data_shards=manifest["data_shards"],
               mesh_data=mesh.shape["data"],
               reshard_restores=mgr.reshard_restores,
               next_step_bitwise=next_same, a_launches=a_launches,
               restored_step=int(restored.step))
    log(f"  elastic: a two-rank ZeRO LM state (adam, step "
        f"{out['restored_step']}) restored at world size 1: params bit for "
        f"bit {params_same}, m and v bit for bit {moments_same}, data "
        f"{manifest['data_shards']} -> {mesh.shape['data']}, "
        f"reshard_restores {mgr.reshard_restores}; one more step from it "
        f"and from the state loaded without resharding bit for bit "
        f"{next_same}; A {a_launches} launches in those two steps")
    if not (params_same and moments_same and next_same) \
            or manifest["data_shards"] != 2 or mgr.reshard_restores != 1 \
            or a_launches != 2 * 2 * cfg.n_layers:
        raise Fail(f"elastic restore: {out}")
    return out


def tp_pool_gate(mesh):
    """The DecodeEngine pool over TP_RULES parameters at bench_engine's
    width (SERVE_CFG, slots 8, max_len 256, page 16) on a one-rank
    model axis over NCCL: the parameters and arenas are DTensors, so
    every cached read runs B or C through its DTensor rule. Float and
    int8 KV, the serve phase's first TP_POOL_REQ requests, TP_POOL_NEW
    new tokens each: tokens bit for bit the single-device engine's, and
    A's, B's and C's launches equal to its."""
    from paddle_tpu_torch.parallel import sharding as PSH

    cfg = TT.TransformerConfig(**SERVE_CFG)
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    sharded = PSH.place(params, PSH.make_param_shardings(params, mesh,
                                                         TT.TP_RULES))
    prompts = make_prompts()[:TP_POOL_REQ]
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    out = {}
    for kv, keys in (("compute", ("flash_fwd", "ragged_tq1", "ragged_tqn",
                                  "float_device")),
                     ("int8", ("flash_fwd", "int8_tq1", "int8_tqn",
                               "int8_device"))):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        DecodeEngine(sharded, c, **geom).serve(prompts[:1], max_new=2)
        one, one_s, one_n = timed_serve(DecodeEngine(params, c, **geom),
                                        prompts, TP_POOL_NEW)
        eng = DecodeEngine(sharded, c, **geom)
        tp, tp_s, tp_n = timed_serve(eng, prompts, TP_POOL_NEW)
        arena = eng.init_state().caches[0][0]
        arena = arena[0] if kv == "int8" else arena
        n_tok = sum(len(t) for t in tp)
        same = tp == one
        launches_equal = all(tp_n[k] == one_n[k] for k in keys)
        out[kv] = dict(tokens_equal=same, launches=tp_n,
                       single_launches=one_n, tokens_per_s=n_tok / tp_s,
                       single_tokens_per_s=n_tok / one_s,
                       arena_placements=str(arena.placements))
        log(f"  TP engine pool, {kv} KV ({TP_POOL_REQ} requests, "
            f"{n_tok} tokens, arenas {arena.placements}): "
            f"{n_tok / tp_s:.1f} tokens/s vs single-device "
            f"{n_tok / one_s:.1f}; tokens bit for bit {same}; launches "
            f"{ {k: tp_n[k] for k in keys} } vs "
            f"{ {k: one_n[k] for k in keys} }")
        if not same or not launches_equal or not all(tp_n[k] for k in keys):
            raise Fail(f"TP engine pool {kv}: tokens equal {same}, "
                       f"launches {tp_n} vs {one_n}")
    return out


def gang_gate(tmp):
    """`train --elastic`'s gang: a GangSupervisor over two members on
    cuda:0 (gloo on its CUDA tensors), the resilient phase's bench_lstm
    classifier through `cli._gang_job_from_config`, GANG_STEPS steps, a
    checkpoint every GANG_EVERY, rank 1 SIGKILLed at its heartbeat step
    GANG_KILL_AT. The gang must reform once at one member, which resumes
    from the last committed step through the resharded restore, runs
    every later step once and finishes; its last loss finite and below
    its first. D's and E's launches come from the members' logs (the
    config prints them at exit)."""
    from paddle_tpu_torch.parallel.launch import GangSupervisor

    cfg_path = os.path.join(tmp, "gang_config.py")
    with open(cfg_path, "w") as f:
        f.write(GANG_CONFIG.format(vocab=LSTM_VOCAB, hidden=LSTM_H,
                                   t=LSTM_T, b=LSTM_B, batches=1))
    sup = GangSupervisor(
        "paddle_tpu_torch.cli:_gang_job_from_config",
        {"config": cfg_path, "batch_size": LSTM_B, "learning_rate": 0.01},
        workdir=os.path.join(tmp, "gang"),
        checkpoint_dir=os.path.join(tmp, "gang_ckpt"), num_processes=2,
        total_steps=GANG_STEPS, checkpoint_every=GANG_EVERY, seed=0,
        grace_s=10.0, poll_s=0.1, heartbeat_timeout_s=120.0,
        boot_timeout_s=300.0,
        extra_env={"PYTHONPATH": REPO_DIR})
    plan = FaultPlan(gang_kill_step_at=GANG_KILL_AT, gang_kill_rank=1)
    plan.wrap_gang(sup)
    marks = {}
    faulted_tick, observe = sup._tick, sup._observe_heartbeats

    def tick():
        faulted_tick()
        if plan.count("gangkill") and "kill" not in marks:
            marks["kill"] = time.monotonic()

    def observe_heartbeats(ranks):
        observe(ranks)
        if sup.gang_epoch == 1 and "reformed_step" not in marks and any(
                sup.member_heartbeat(r) for r in ranks):
            marks["reformed_step"] = time.monotonic()

    sup._tick, sup._observe_heartbeats = tick, observe_heartbeats
    t0 = time.perf_counter()
    run = sup.run(deadline_s=GANG_DEADLINE_S)
    wall = time.perf_counter() - t0
    c = sup.counters()
    res = run["results"][0] if run["results"] else {}
    d = e = 0
    for name in sorted(os.listdir(sup.workdir)):
        if name.startswith("log_"):
            m = re.search(r"kernel launches: D (\d+) E (\d+)",
                          open(os.path.join(sup.workdir, name)).read())
            if m:
                d, e = d + int(m.group(1)), e + int(m.group(2))
    r = res.get("restored_step")
    losses = res.get("losses", [])
    killed_at = int(plan.fired[0].split("@")[1]) if plan.fired else None
    out = dict(counters=c, wall_s=wall, restored_step=r,
               final_step=res.get("final_step"), steps=res.get("steps"),
               losses=losses, fired=list(plan.fired),
               member_reshard_restores=res.get("counters", {}).get(
                   "reshard_restores"),
               # steps the dead gang completed past the restored one
               steps_lost=(killed_at + 1 - r if r is not None
                           and killed_at is not None else None),
               reform_s=(marks["reformed_step"] - marks["kill"]
                         if len(marks) == 2 else None),
               d_launches=d, e_launches=e)
    log(f"  gang: epoch {c['gang_epoch']}, reforms {c['reforms']}, members "
        f"lost {c['members_lost']}, fired {plan.fired}; the survivor "
        f"resumed at step {r} (steps lost {out['steps_lost']}, reshard "
        f"restores {out['member_reshard_restores']}), ran {out['steps']} "
        f"to step {out['final_step']}, losses "
        f"{['%.5f' % x for x in losses]}; from the kill to the reformed "
        f"gang's first step {out['reform_s']} s; D {d} E {e} launches in "
        f"the members; {wall:.1f} s in all")
    if (c["reforms"] != 1 or c["members_lost"] != 1 or r is None
            or not 0 < r < GANG_STEPS or out["final_step"] != GANG_STEPS
            or out["steps"] != list(range(r, GANG_STEPS))
            or not out["member_reshard_restores"]
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or not d or not e):
        raise Fail(f"gang: {out}")
    return out


def sparse_elastic_phase():
    """Phase 8b (see the module docstring): the CTR model at
    bench_ctr_sparse's width, the host-offload table, the CTR step on two
    gloo ranks, the TP engine pool, the elastic layer (reshard on
    restore, the gang), dryrun_multichip(1)."""
    import multiprocessing as mp

    import torch.distributed as dist

    from paddle_tpu_torch.core import mesh as MESH

    t_phase = time.perf_counter()
    log(f"phase sparse_elastic: CTR (B={CTR_B}, vocab {CTR_VOCAB}, dim "
        f"{CTR_DIM}), host offload, two gloo ranks, the TP engine pool, "
        f"the elastic layer")
    torch.cuda.empty_cache()
    out, secs = {}, {}
    mesh = MESH.build_mesh(MESH.MeshConfig(1, 1, 1))
    cpu_mesh = MESH.build_mesh(MESH.MeshConfig(1, 1, 1), "cpu")
    ids, labels = ctr_batch()
    with torch.no_grad():
        full0 = host_tree(ctr_model(mesh).init(CTR_SEED, CTR_B,
                                               CTR_SLOTS)[0])

    t0 = time.perf_counter()
    out["ctr_gate"] = ctr_gate(full0, ids, labels, mesh, cpu_mesh)
    out["ctr"] = ctr_timing(full0, ids, labels, mesh)
    out["host_offload"] = host_offload_gate(full0, ids, mesh)
    secs["ctr"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # the two-rank jobs: their reference first, then the ranks
    t0 = time.perf_counter()
    ref_losses, ref_params = ctr_run(ctr_model(mesh), ctr_params(
        ctr_model(mesh), full0), ids, labels, 1 + CTR_GLOO_STEPS)
    rs = np.random.RandomState(0)
    lm_tokens = torch.from_numpy(rs.randint(
        0, LM_CFG["vocab"], (2 * DIST_GLOO_B, LM_T)).astype(np.int32))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"ctr_params0": full0, "ctr_ids": ids,
                    "ctr_labels": labels, "ctr_losses": ref_losses,
                    "ctr_params": host_tree(ref_params),
                    "lm_tokens": lm_tokens,
                    "ckpt_dir": os.path.join(tmp, "zero_ckpt")}, ref_path)
        del ref_params
        torch.cuda.empty_cache()
        res_path = os.path.join(tmp, "ranks.json")
        procs = [ctx.Process(target=gloo_rank, args=(
            r, 2, os.path.join(tmp, "rendezvous"), ref_path, res_path,
            GLOO_CUDA, "sparse_elastic")) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + DIST_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        ranks = [json.load(open(f"{res_path}.{r}"))
                 if os.path.exists(f"{res_path}.{r}") else {}
                 for r in range(2)]
        errors = {f"rank {r} {k}": v["error"] for r, got in enumerate(ranks)
                  for k, v in got.items() if "error" in v}
        if alive or errors or any(p.exitcode != 0 for p in procs) \
                or set(ranks[0]) != {"ctr", "zero_save"}:
            raise Fail(f"sparse_elastic gloo ranks: exit codes "
                       f"{[p.exitcode for p in procs]} ({len(alive)} killed "
                       f"at the {DIST_TIMEOUT_S} s timeout); jobs "
                       f"{sorted(ranks[0])}; errors {errors}")
        g = out["ctr_gloo"] = ranks[0]["ctr"]
        log(f"  CTR on two gloo ranks (model=2, {CTR_B // 2} rows a rank): "
            f"{g['ms_per_step']:.1f} ms/step; losses "
            f"{['%.7f' % x for x in g['losses']]} vs one process "
            f"{['%.7f' % x for x in ref_losses]} ({g['loss_rel_err']:.2e}); "
            f"params close {g['params_close']} (max abs err "
            f"{g['param_max_abs_err']:.2e}); all_to_all_single "
            f"{g['all_to_all_per_step']:.0f} a step, "
            f"{g['all_to_all_bytes_per_step']} bytes a step (rank 0); "
            f"collectives {g['collectives']}")
        if g["loss_rel_err"] > 1e-5 or not g["params_close"] \
                or not g["all_to_all_per_step"] \
                or g["collectives"]["all_gather"]:
            raise Fail(f"CTR on two gloo ranks: {g}")
        secs["gloo"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["zero_save"] = ranks[0]["zero_save"]
        out["elastic_restore"] = elastic_restore_gate(
            os.path.join(tmp, "zero_ckpt"), lm_tokens.cuda())
        secs["elastic_restore"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["tp_pool"] = tp_pool_gate(mesh)
    secs["tp_pool"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["gang"] = gang_gate(tmp)
    secs["gang"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rep = GRAFT.dryrun_multichip(1)
    out["dryrun"] = dict(rep, s=time.perf_counter() - t0)
    log(f"  dryrun_multichip(1): ran {rep['ran']}, skipped "
        f"{rep['skipped']} in {out['dryrun']['s']:.1f} s")
    if rep["ran"] != DRYRUN_1_PARTS or list(rep["skipped"]) != [
            "engine_pool"]:
        raise Fail(f"sparse_elastic: dryrun_multichip(1) ran {rep['ran']}, "
                   f"skipped {rep['skipped']}")
    secs["dryrun"] = out["dryrun"]["s"]
    dist.destroy_process_group()
    out["seconds"] = secs
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase sparse_elastic: {out['s']:.1f} s ({secs})")
    return out


# -- the parameter-server tier and CTR serving at bench_ctr_sparse's table ------

# bench_ctr_sparse's table (benchmarks/suite.py:267, sizes at :811-815):
# vocab 1,000,000, dim 64, 32 slots, batch 4096, row lr 0.05 (CTR_*), on
# a PServerGroup of two replicated shards. The stream: PS_TASKS tasks of
# one batch each (131072 rows pulled and pushed a task); the twin run's
# shard-0 primary is killed on its PS_KILL_PUSH_AT-th push (one push to
# shard 0 a task). Serving: an arena of PS_HOT rows (32 MiB), PS_HOST
# host rows, PS_REQ requests of [PS_REQ_B, CTR_SLOTS] ids drawn
# Zipf(PS_ZIPF) over the vocab with a PS_PAD share of -1 pads, shard 1's
# primary killed before request PS_REQ // 2; PS_FRESH_ROWS hot rows
# pushed by another trainer for the freshness gate
PS_TASKS, PS_KILL_PUSH_AT, PS_SEED = 4, 3, 0    # tasks cut from 8
PS_HOT, PS_HOST = 131072, 524288
PS_REQ, PS_REQ_B, PS_ZIPF, PS_PAD = 200, 256, 1.1, 0.05
PS_FRESH_ROWS, PS_SCORE_TOL = 64, 1e-6
PS_CHUNK = 131072     # rows a frame for the gates' whole-table moves

#: the native library's build (`build_native`): path, seconds, cached
NATIVE_BUILD = {}


def build_native():
    """Build the native library (recordio, the task queue; g++) from
    paddle_tpu_torch/native/src, timed into NATIVE_BUILD. main() runs it
    beside the nvcc builds; the pserver_ctr phase alone runs it first."""
    from paddle_tpu_torch.native import build as NB

    t0 = time.perf_counter()
    NATIVE_BUILD["cached"] = os.path.exists(NB.lib_path())
    NATIVE_BUILD["lib"] = NB.ensure_built()
    NATIVE_BUILD["s"] = time.perf_counter() - t0


def reset_all_counts():
    reset_counts()
    FL.reset_launch_counts()
    reset_time_loop_counts()


def all_counts():
    """Launches of kernels A-I since their counts were last set to 0."""
    c = counts()
    return {"A": c["flash_fwd"], "B": c["ragged_tq1"] + c["ragged_tqn"],
            "C": c["int8_tq1"] + c["int8_tqn"],
            "D": FL.launch_counts["fwd"], "E": FL.launch_counts["bwd"],
            **time_loop_counts()}


def ctr_plain_scores(tower, rows, padded):
    """The CTR tower on CPU tensors: rows [B*S, D] read straight from
    the shards, padded [B, S] ids (-1 pads) -> [B] scores."""
    b, s = padded.shape
    v = torch.from_numpy(rows).reshape(b, s, -1)
    mask = torch.from_numpy((padded >= 0).astype(np.float32))
    pooled = v.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    w = {k: torch.from_numpy(np.asarray(t, np.float32))
         for k, t in tower.items()}
    h = torch.relu(pooled @ w["w1"] + w["b1"])
    return torch.sigmoid(h @ w["w2"] + w["b2"]).numpy()


def ctr_requests(rng):
    """PS_REQ requests of [PS_REQ_B, CTR_SLOTS] ids: Zipf(PS_ZIPF) ranks
    (the tail folded into the vocab) through a seeded permutation, so
    the hot ids spread over both shards; a PS_PAD share of -1 pads.
    Returns (requests, the permutation: perm[r] is the id of rank r)."""
    perm = rng.permutation(CTR_VOCAB)
    n = PS_REQ * PS_REQ_B * CTR_SLOTS
    ids = perm[(rng.zipf(PS_ZIPF, n) - 1) % CTR_VOCAB].astype(np.int64)
    ids[rng.rand(n) < PS_PAD] = -1
    return ids.reshape(PS_REQ, PS_REQ_B, CTR_SLOTS), perm


def score_gate(label, server, plain, tower, reqs, scores):
    """Every score within PS_SCORE_TOL of the plain path over rows read
    straight from the shards now (`plain.get_rows`): the max abs error."""
    err = 0.0
    for req, got in zip(reqs, scores):
        padded = np.full((server.max_batch, server.slots), -1, np.int64)
        padded[:req.shape[0], :req.shape[1]] = req
        want = ctr_plain_scores(tower, plain.get_rows(padded.reshape(-1)),
                                padded)[:req.shape[0]]
        err = max(err, float(np.abs(got - want).max()))
    if not err <= PS_SCORE_TOL:
        raise Fail(f"pserver_ctr {label}: scores {err:.3e} from the plain "
                   f"path (tolerance {PS_SCORE_TOL})")
    return err


def ctr_copy_profile(server, req):
    """One steady-state all-hit request under torch.profiler: the bytes
    of each host-to-device and device-to-host copy (from the exported
    trace) and the names of the kernels it launched."""
    server.score(req)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        server.score(req)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    copies = {"HtoD": [], "DtoH": [], "other": []}
    kernels = []
    for ev in trace.get("traceEvents", []):
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "gpu_memcpy":
            kind = next((k for k in ("HtoD", "DtoH") if k in name), "other")
            copies[kind].append(int(ev.get("args", {}).get("bytes", -1)))
        elif cat == "kernel":
            kernels.append(name)
    return copies, kernels


def start_copy_child(group):
    """ctr_copy_child over `group`'s shards in a fresh process: it
    reaches the card while the phase streams and serves, then waits for
    a line on its standard input (copy_child_result)."""
    specs = [[s.shard_id, s.row_lo, s.row_hi, s.endpoints]
             for s in group.specs]
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as S; "
         f"S.ctr_copy_child({specs!r})"],
        cwd=REPO_DIR, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def copy_child_result(proc):
    """Let the child measure, and read its JSON line."""
    try:
        out, err = proc.communicate("go\n", timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [l for l in out.splitlines() if l.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise Fail(f"pserver_ctr copies: the child exited "
                   f"{proc.returncode}: {err[-2000:]}")
    return json.loads(lines[-1])


def ctr_copy_child(specs):
    """Gate (e)'s measurement, in a process of its own: torch.profiler
    records no device activity in the smoke's process once lm_train has
    run there (scripts/torch_profiler_after_phases.py). The cache and
    server of serve_gates over the shards `specs` ([shard id, row lo,
    row hi, endpoints] each), request 1 scored twice, then
    ctr_copy_profile; prints the copies, the kernels, the cache
    counters' change over the profiled requests and its seconds."""
    from paddle_tpu_torch.native.pserver import ShardSpec
    from paddle_tpu_torch.parallel.pserver_client import (PServerClient,
                                                          PServerEmbedding)
    from paddle_tpu_torch.serve.ctr import CtrServer, init_tower
    from paddle_tpu_torch.serve.embed_cache import TieredEmbedCache

    torch.zeros(1, device="cuda")
    req = ctr_requests(np.random.RandomState(PS_SEED))[0][1]
    # no profiler session before the measured one: after a warm-up
    # session the measured one recorded one of the two copies in
    sys.stdin.readline()
    t0 = time.perf_counter()
    client = PServerClient(
        [ShardSpec(s, lo, hi, [tuple(e) for e in eps])
         for s, lo, hi, eps in specs], CTR_DIM, trainer_id=4,
        backoff_base=0.005, backoff_max=0.1)
    try:
        client.register()
        cache = TieredEmbedCache(
            PServerEmbedding(client, device="cuda"),
            PServerEmbedding.Handle(CTR_VOCAB, CTR_DIM), hot_rows=PS_HOT,
            host_rows=PS_HOST, max_staleness=0, device="cuda")
        server = CtrServer(cache, init_tower(PS_SEED, CTR_DIM),
                           slots=CTR_SLOTS, max_batch=PS_REQ_B,
                           device="cuda")
        for _ in range(2):      # fill, then past any failover refill
            server.score(req)
        before = cache.counters()
        t1 = time.perf_counter()
        copies, kernels = ctr_copy_profile(server, req)
        after = cache.counters()
    finally:
        client.close()
    print(json.dumps(dict(copies=copies, kernels=kernels, counters={
        k: after[k] - before[k] for k in ("hits_device", "hits_host",
                                          "misses", "stale_refills",
                                          "pulls")},
        seconds={"fill": t1 - t0, "profile": time.perf_counter() - t1})),
        flush=True)


def stream_run(group, label, plan=None):
    """PS_TASKS streaming tasks through a fresh client of `group`
    (trainer 7) and a PServerEmbedding on the card: each task's
    seconds, each push's seconds and whether a failover happened in it,
    the client's failover counters and stats."""
    from paddle_tpu_torch.native.taskqueue import TaskQueue
    from paddle_tpu_torch.parallel.pserver_client import (PServerClient,
                                                          PServerEmbedding)
    from paddle_tpu_torch.train.online import StreamingTrainer

    q = TaskQueue()
    for i in range(PS_TASKS):
        q.add_task(json.dumps({"seed": i, "batch": CTR_B,
                               "slots": CTR_SLOTS,
                               "vocab": CTR_VOCAB}).encode())
    client = PServerClient(group.specs, CTR_DIM, trainer_id=7,
                           backoff_base=0.005, backoff_max=0.1)
    try:
        client.register()
        emb = PServerEmbedding(client, device="cuda")
        landed = set()
        lookup = emb.alltoall_lookup

        def on_device_lookup(table, ids, **kw):
            rows = lookup(table, ids, **kw)
            landed.add(rows.device.type)
            return rows

        emb.alltoall_lookup = on_device_lookup
        pushes = []
        push = client.push_row_grads

        def timed_push(*a, **kw):
            before = sum(client.shard_failovers())
            t0 = time.perf_counter()
            push(*a, **kw)
            pushes.append((time.perf_counter() - t0,
                           sum(client.shard_failovers()) > before))

        client.push_row_grads = timed_push
        trainer = StreamingTrainer(q, emb, None, lr=CTR_ROW_LR)
        task_s = []
        for _ in range(PS_TASKS):
            t0 = time.perf_counter()
            if trainer.run(1) != 1:
                raise Fail(f"pserver_ctr {label}: a task was not consumed")
            task_s.append(time.perf_counter() - t0)
        if landed != {"cuda"}:
            raise Fail(f"pserver_ctr {label}: lookups landed on {landed}")
        return dict(task_s=task_s, pushes=pushes,
                    failovers=client.shard_failovers(),
                    stats=dict(client.stats),
                    fired=list(plan.fired) if plan else [])
    finally:
        client.close()
        q.close()


def serve_gates(group, handle, out, secs, child):
    """Section 3 of the phase: CTR serving through the tiered cache
    (gates (a)-(e) of the module docstring); `child`: the
    start_copy_child process that measures gate (e)."""
    from paddle_tpu_torch.parallel.pserver_client import (PServerClient,
                                                          PServerEmbedding)
    from paddle_tpu_torch.serve.ctr import CtrServer, init_tower
    from paddle_tpu_torch.serve.embed_cache import TieredEmbedCache

    read, plain, push = (PServerClient(group.specs, CTR_DIM, trainer_id=t,
                                       backoff_base=0.005, backoff_max=0.1)
                         for t in (1, 2, 3))
    try:
        for c in (read, plain, push):
            c.register()
        cache = TieredEmbedCache(
            PServerEmbedding(read, device="cuda"), handle,
            hot_rows=PS_HOT, host_rows=PS_HOST, max_staleness=0,
            device="cuda")
        tower = init_tower(PS_SEED, CTR_DIM)
        server = CtrServer(cache, tower, slots=CTR_SLOTS,
                           max_batch=PS_REQ_B, device="cuda")
        reqs, perm = ctr_requests(np.random.RandomState(PS_SEED))

        # (a) and (c): the traffic, shard 1's primary killed mid-way
        lat, scores = [], []
        t0 = time.perf_counter()
        for i, req in enumerate(reqs):
            if i == PS_REQ // 2:
                group.primaries[1].kill()
            t1 = time.perf_counter()
            scores.append(server.score(req))
            lat.append(time.perf_counter() - t1)
        secs["serve"] = wall = time.perf_counter() - t0
        c = cache.counters()
        t0 = time.perf_counter()
        err = score_gate("traffic", server, plain, tower, reqs, scores)
        secs["score_gate"] = time.perf_counter() - t0
        lat_ms = np.asarray(lat) * 1e3
        srv = out["serve"] = dict(
            requests_per_s=PS_REQ / wall,
            examples_per_s=PS_REQ * PS_REQ_B / wall,
            p50_ms=float(np.percentile(lat_ms, 50)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            kill_request_ms=float(lat_ms[PS_REQ // 2]),
            score_max_abs_err=err, counters=c,
            rows_per_pull=c["rows_pulled"] / max(c["pulls"], 1),
            arena_mib=cache._arena.numel() * 4 / 2 ** 20,
            read_failovers=read.shard_failovers())
        log(f"  serve: {srv['requests_per_s']:.1f} requests/s, "
            f"{srv['examples_per_s']:.0f} examples/s; p50 "
            f"{srv['p50_ms']:.2f} ms, p99 {srv['p99_ms']:.2f} ms per "
            f"request (request {PS_REQ // 2}, as shard 1's primary died: "
            f"{srv['kill_request_ms']:.2f} ms); scores {err:.2e} from the "
            f"plain path; arena {srv['arena_mib']:.1f} MiB; device hits "
            f"{c['hits_device']}, host hits {c['hits_host']}, misses "
            f"{c['misses']}, stale refills {c['stale_refills']}, "
            f"{srv['rows_per_pull']:.0f} rows per pull ({c['pulls']} "
            f"pulls), evictions device {c['evictions_device']} host "
            f"{c['evictions_host']}, failover invalidations "
            f"{c['invalidations_failover']} (read client failovers "
            f"{srv['read_failovers']}), overflow {c['overflow_lookups']}")
        if c["invalidations_failover"] < 1 or srv["read_failovers"][1] < 1:
            raise Fail(f"pserver_ctr serve: shard 1's primary died and the "
                       f"cache saw no failover: {srv}")

        # (b) freshness: another trainer pushes into hot rows
        t_gates = time.perf_counter()
        hot = perm[:PS_FRESH_ROWS].astype(np.int64)
        cache.lookup(hot)
        cache.bind_push_feed(push)
        before = cache.counters()
        g = np.random.RandomState(1).standard_normal(
            (PS_FRESH_ROWS, CTR_DIM)).astype(np.float32)
        push.push_row_grads(hot, g, CTR_ROW_LR)
        req = reqs[0].copy()
        req[:PS_FRESH_ROWS // CTR_SLOTS] = hot.reshape(-1, CTR_SLOTS)
        fresh = server.score(req)
        ferr = score_gate("freshness", server, plain, tower, [req], [fresh])
        refills = cache.counters()["stale_refills"] - before["stale_refills"]
        rows_ok = bool(np.array_equal(cache.lookup(hot).cpu().numpy(),
                                      plain.get_rows(hot)))
        audit = cache.reconcile(plain.shard_stats())
        fr = out["freshness"] = dict(score_max_abs_err=ferr,
                                     rows_bitwise=rows_ok,
                                     stale_refills=refills, reconcile=audit)
        log(f"  freshness: {PS_FRESH_ROWS} hot rows pushed by trainer 3 "
            f"(its ACKs feed the cache); the next request refilled "
            f"{refills} stale rows, scores {ferr:.2e} from the fresh plain "
            f"path, the pushed rows bit for bit {rows_ok}; reconcile "
            f"{audit}")
        if not rows_ok or refills < PS_FRESH_ROWS \
                or not cache.reconcile()["ok"]:
            raise Fail(f"pserver_ctr freshness: {fr}")

        secs["freshness"] = time.perf_counter() - t_gates
        # (d) two all-hit lookups back to back, no sync between them
        a_ids, b_ids = reqs[1].reshape(-1), reqs[2].reshape(-1)
        cache.lookup(a_ids)
        cache.lookup(b_ids)
        torch.cuda.synchronize()
        pulls = cache.counters()["pulls"]
        ra = cache.lookup(a_ids)
        rb = cache.lookup(b_ids)
        torch.cuda.synchronize()
        st = out["staging"] = dict(
            a_bitwise=bool(np.array_equal(ra.cpu().numpy(),
                                          plain.get_rows(a_ids))),
            b_bitwise=bool(np.array_equal(rb.cpu().numpy(),
                                          plain.get_rows(b_ids))),
            pulls=cache.counters()["pulls"] - pulls,
            device=ra.device.type)
        log(f"  staging: two all-hit lookups back to back, each its own "
            f"rows: {st['a_bitwise']}, {st['b_bitwise']} (pulls "
            f"{st['pulls']}, rows on {st['device']})")
        if not (st["a_bitwise"] and st["b_bitwise"]) or st["pulls"] \
                or st["device"] != "cuda":
            raise Fail(f"pserver_ctr staging: {st}")

        # (e) a steady-state all-hit request's copies and kernels
        t_prof = time.perf_counter()
        slot_bytes = PS_REQ_B * CTR_SLOTS * 4      # int32 slots, padded
        mask_bytes = PS_REQ_B * CTR_SLOTS * 4      # f32 [B, S]
        res = copy_child_result(child)
        copies, kernels, moved = res["copies"], res["kernels"], \
            res["counters"]
        cp = out["copies"] = dict(copies=copies, kernels=len(kernels),
                                  kernel_names=sorted(set(kernels)),
                                  slot_bytes=slot_bytes,
                                  mask_bytes=mask_bytes, counters=moved,
                                  child_s=res["seconds"])
        log(f"  all-hit request under the profiler (a fresh process, the "
            f"same cache and server over the same shards): host-to-device "
            f"copies {copies['HtoD']} bytes (slot vector {slot_bytes}, "
            f"mask {mask_bytes}), device-to-host {copies['DtoH']} bytes, "
            f"other copies {copies['other']}; {len(kernels)} kernels per "
            f"request; its cache's counters over the warm and the profiled "
            f"request {moved}; the child's seconds after its go "
            f"{res['seconds']}")
        if len(copies["HtoD"]) != 2 or len(copies["DtoH"]) != 1 \
                or copies["other"] or moved["hits_device"] < 1 \
                or any(moved[k] for k in ("hits_host", "misses",
                                          "stale_refills", "pulls")) \
                or any(b > max(slot_bytes, mask_bytes)
                       for b in copies["HtoD"]) \
                or copies["DtoH"][0] > PS_REQ_B * 4:
            raise Fail(f"pserver_ctr copies: {cp}")
        secs["profile"] = time.perf_counter() - t_prof
        secs["gates"] = time.perf_counter() - t_gates
    finally:
        for c in (read, plain, push):
            c.close()


def pserver_ctr_phase():
    """Phase 7c (see the module docstring): the pserver tier, streaming
    training through a primary's death, and CTR serving through the
    tiered cache, at bench_ctr_sparse's table."""
    from paddle_tpu_torch.native.pserver import PServerGroup
    from paddle_tpu_torch.parallel.pserver_client import (PServerClient,
                                                          PServerEmbedding)
    from paddle_tpu_torch.parallel.sparse import _normal_table

    t_phase = time.perf_counter()
    reset_all_counts()
    out, secs = {}, {}
    log(f"phase pserver_ctr: PServerGroup({CTR_VOCAB}, {CTR_DIM}, "
        f"n_shards=2, replicated), {PS_TASKS} streaming tasks of "
        f"{CTR_B} x {CTR_SLOTS} ids, CTR serving of {PS_REQ} requests "
        f"[{PS_REQ_B}, {CTR_SLOTS}] through an arena of {PS_HOT} rows")
    where = "in the build phase, beside nvcc"
    if not NATIVE_BUILD:
        build_native()
        where = "here"
    secs["build"] = NATIVE_BUILD["s"]
    log(f"  native library {os.path.relpath(NATIVE_BUILD['lib'], REPO_DIR)}"
        f": {'cached' if NATIVE_BUILD['cached'] else 'built'} {where} in "
        f"{secs['build']:.2f} s")

    groups, child = [], None
    try:
        # 1. the tier and its table
        t0 = time.perf_counter()
        group = PServerGroup(CTR_VOCAB, CTR_DIM, n_shards=2, replicated=True)
        groups.append(group)
        child = start_copy_child(group)
        with PServerClient(group.specs, CTR_DIM, trainer_id=0,
                           backoff_base=0.005, backoff_max=0.1) as client:
            client.register()
            emb = PServerEmbedding(client, device="cuda")
            handle = emb.init(PS_SEED)
            secs["load"] = time.perf_counter() - t0
            drawn = _normal_table(PS_SEED, CTR_VOCAB, CTR_DIM,
                                  emb.init_scale).numpy()
            t0 = time.perf_counter()
            table0 = client.fetch_table(chunk_rows=PS_CHUNK)
            secs["fetch"] = time.perf_counter() - t0
            if not np.array_equal(table0, drawn):
                raise Fail("pserver_ctr: fetch_table differs from the "
                           "drawn table")
            log(f"  tier up, {CTR_VOCAB} x {CTR_DIM} drawn and loaded on "
                f"both replicas in {secs['load']:.2f} s; fetch_table "
                f"{secs['fetch']:.2f} s, bit for bit the drawn table")
            # the twin tier for the faulted stream, the same table
            t0 = time.perf_counter()
            twin = PServerGroup(CTR_VOCAB, CTR_DIM, n_shards=2,
                                replicated=True)
            groups.append(twin)
            with PServerClient(twin.specs, CTR_DIM, trainer_id=0) as tc:
                tc.register()
                tc.load_table(drawn, chunk_rows=PS_CHUNK)
            del drawn
            secs["twin_load"] = time.perf_counter() - t0

            # 2. streaming training, unfaulted and through a primary's
            # death
            t0 = time.perf_counter()
            clean = stream_run(group, "stream")
            plan = FaultPlan(pserver_kill_push_at=PS_KILL_PUSH_AT)
            plan.wrap_pserver_shard(twin.primaries[0])
            faulted = stream_run(twin, "faulted stream", plan)
            secs["stream"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            trained = client.fetch_table(chunk_rows=PS_CHUNK)
        with PServerClient(twin.specs, CTR_DIM, trainer_id=0) as tc:
            same = np.array_equal(trained,
                                  tc.fetch_table(chunk_rows=PS_CHUNK))
        moved = int(np.count_nonzero((trained != table0).any(axis=1)))
        del trained, table0
        twin.stop()
        groups.remove(twin)
        secs["stream_gate"] = time.perf_counter() - t0
        rows_task = CTR_B * CTR_SLOTS
        med = float(np.median(clean["task_s"]))
        kill = PS_KILL_PUSH_AT
        # the push that met the dead primary (connect refused, the chain
        # advanced, re-registered on the backup, the same epoch re-sent)
        # against the median clean push
        hit = [t for t, moved_on in faulted["pushes"] if moved_on]
        push_med = float(np.median([t for t, _ in clean["pushes"]]))
        sm = out["stream"] = dict(
            s_per_task=med, task_s=clean["task_s"],
            faulted_task_s=faulted["task_s"],
            rows_pulled_per_s=rows_task / med,
            rows_pushed_per_s=rows_task / med, push_s=push_med,
            failover_push_s=hit, failover_s=(hit[0] - push_med if hit
                                             else None),
            failovers=faulted["failovers"], fired=faulted["fired"],
            client_stats=faulted["stats"], rows_moved=moved,
            table_bitwise=same)
        log(f"  stream: {med:.3f} s/task (median of {PS_TASKS}), "
            f"{rows_task / med:.3e} rows/s pulled and as many pushed; the "
            f"twin with shard 0's primary killed on push #{kill}: fired "
            f"{faulted['fired']}, client failovers {faulted['failovers']}, "
            f"stats {faulted['stats']}; the push through the failover "
            f"{hit} s against a clean push's {push_med:.4f} s; final tables "
            f"bit for bit {same} ({moved} rows moved)")
        if not same or plan.count("pskill") != 1 or len(hit) != 1 \
                or faulted["failovers"][0] < 1 or moved == 0:
            raise Fail(f"pserver_ctr stream: {sm}")

        # 3. CTR serving through the tiered cache
        t0 = time.perf_counter()
        serve_gates(group, handle, out, secs, child)
        secs["serving_part"] = time.perf_counter() - t0
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        for g in groups:
            g.stop()

    # 4. the phase launches none of the kernels A-I
    out["launches"] = all_counts()
    log(f"  kernels A-I launched in the phase: {out['launches']}")
    if any(out["launches"].values()):
        raise Fail(f"pserver_ctr launched kernels: {out['launches']}")
    out["seconds"] = secs
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase pserver_ctr: {out['s']:.1f} s ({secs})")
    return out


# -- the process fleet: replica processes behind the HTTP edge ----------------

# the fleet phase at bench_engine's width: FLEET_REPLICAS unified replica
# processes behind HttpEdge, serve_phase's 32 requests streamed by
# FLEET_CLIENTS concurrent clients, one replica SIGKILLed mid-burst; then
# a prefill and a decode process over the supervisor's shared-memory
# arena, int8 KV, FLEET_DISAGG_REQ requests
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_DISAGG_REQ = 3, 16, 8
FLEET_KILL_AFTER = 8        # sweeps of the burst before the SIGKILL
FLEET_BOOT_S = 300.0        # a child's boot limit (spawn to ready)
FLEET_STREAM_S = 600.0      # a client's socket limit
FLEET_ARENA_SEGS, FLEET_ARENA_SEG_KB = 32, 1024


def fleet_server(*, kv_cache_dtype="compute", role="unified",
                 data_plane=None, device="cuda"):
    """The fleet phase's replica builder, imported by name in each child
    process (`ReplicaSpec(builder="chip_smoke:fleet_server")`): serve_phase's
    model from the same seed on the card behind a ServingServer, warmed
    by one short serve; its counters() also carry this process's launch
    counts (A, B, C, from 0 after the warm-up) and the CRC32 digests of
    the KV pages it exported and of those it imported, as its arenas
    held them just after each import -- the transport's state block
    brings them to the parent. The timed export and import RPCs only
    keep the pages (the exported host arrays; a copy on the card of
    each imported slot's pages); the digests are taken in the server's
    reconcile(), which the parent calls after the run."""
    import zlib

    from paddle_tpu_torch.serve.server import ServingServer

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TT.TransformerConfig(**SERVE_CFG, kv_cache_dtype=kv_cache_dtype)
    params = TT.init_params(np.random.RandomState(0), cfg, device=device)
    torch.cuda.synchronize()
    t1 = time.time()
    eng = DecodeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PAGE, device=device)
    eng.serve(make_prompts()[:1], max_new=2)
    torch.cuda.synchronize()
    # the boot's parts in this process (epoch ms where the builder
    # starts: the parent subtracts its spawn time for import + start-up)
    digest = {"kv_exports": 0, "kv_export_crc": 0, "kv_imports": 0,
              "kv_import_crc": 0, "boot_builder_at_ms": int(t0 * 1000),
              "boot_weights_ms": int((t1 - t0) * 1000),
              "boot_warmup_ms": int((time.time() - t1) * 1000)}
    kept = {"export": [], "import": []}

    def crc(kv):
        c = 0
        for layer in kv:
            for part in layer:
                for a in (part if isinstance(part, tuple) else (part,)):
                    a = a.cpu().numpy() if torch.is_tensor(a) else a
                    c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
        return c

    export, import_ = eng.export_slot_kv, eng.import_slot_kv

    def export_slot_kv(state, pages):
        kv = export(state, pages)
        kept["export"].append(kv)
        return kv

    def import_slot_kv(state, slot, pages, start_block, kv):
        state = import_(state, slot, pages, start_block, kv)
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=device)
        take = lambda b: (tuple(t.index_select(0, idx) for t in b)
                          if isinstance(b, tuple) else b.index_select(0, idx))
        kept["import"].append([(take(k), take(v)) for k, v in state.caches])
        return state

    eng.export_slot_kv, eng.import_slot_kv = export_slot_kv, import_slot_kv
    srv = ServingServer(eng, role=role, max_queue=64, buckets=(PROMPT,),
                        data_plane=data_plane)
    reset_counts()
    own, reconcile = srv.counters, srv.reconcile

    def digest_kept():
        for kind in ("export", "import"):
            for kv in kept[kind]:
                digest[f"kv_{kind}s"] += 1
                digest[f"kv_{kind}_crc"] = (digest[f"kv_{kind}_crc"]
                                            + crc(kv)) % (1 << 62)
            kept[kind].clear()
        reconcile()

    def counters():
        c = own()
        c.update({f"launch_{k}": v for k, v in counts().items()})
        c.update(digest)
        return c

    srv.counters, srv.reconcile = counters, digest_kept
    return srv


def boot_parts(rep, spawned_at, ready_s):
    """One child's boot from its spawn (epoch seconds) to ready, in
    parts: the interpreter's start and imports up to the builder, the
    weights drawn onto the card (the CUDA context comes up there), the
    warm-up serve, and (with `ready_s`, spawn to ready) the rest: server,
    listener, handshake."""
    c = rep.server.counters()
    start = c["boot_builder_at_ms"] / 1000.0 - spawned_at
    w, warm = c["boot_weights_ms"] / 1000.0, c["boot_warmup_ms"] / 1000.0
    parts = {"to_builder": round(start, 3), "weights": round(w, 3),
             "warmup": round(warm, 3)}
    if ready_s is not None:
        parts["rest"] = round(ready_s - start - w - warm, 3)
    return parts


def child_launches(rep):
    """{kernel: launches} of one replica child, from the last state block
    its transport delivered (a dead child's last one)."""
    c = rep.server.counters()
    return {k[len("launch_"):]: v for k, v in c.items()
            if k.startswith("launch_")}


def proc_gone(pid):
    """True when `pid` has exited (missing, or a zombie awaiting reap)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, ProcessLookupError):
        return True


def fleet_unified(params, prompts, ref):
    """FLEET_REPLICAS replica processes behind HttpEdge: the 32 requests
    streamed over real sockets by FLEET_CLIENTS clients (client j sends
    request j, then request j + FLEET_CLIENTS once the fleet is back at
    its floor), one replica SIGKILLed mid-burst (FaultPlan.wrap_fleet)
    after FLEET_KILL_AFTER sweeps with every replica holding live work;
    gates and numbers as fleet_phase says."""
    from paddle_tpu_torch.serve.fleet import FleetSupervisor, ReplicaSpec
    from paddle_tpu_torch.serve.http_edge import HttpEdge
    from paddle_tpu_torch.testing.traffic import slo_report, stream_generate

    plain_cfg = dataclasses.replace(TT.TransformerConfig(**SERVE_CFG),
                                    attn_impl="dense")
    spec = ReplicaSpec(builder="chip_smoke:fleet_server",
                       io_timeout=120.0, device="cuda")
    sup = FleetSupervisor(spec, min_replicas=FLEET_REPLICAS,
                          max_replicas=FLEET_REPLICAS,
                          boot_timeout_s=FLEET_BOOT_S)
    out, times, pids = {}, {}, set()
    t0, epoch0 = time.perf_counter(), time.time()
    sup.start()
    out["boot_s"] = time.perf_counter() - t0
    out["boot_parts_s"] = [boot_parts(r, epoch0, out["boot_s"])
                           for r in sup.router.replicas]
    pids.update(p.pid for p in sup.procs.values())
    log(f"  {FLEET_REPLICAS} replica processes ready in {out['boot_s']:.1f} "
        f"s, spawned together; each child's parts (s): "
        f"{out['boot_parts_s']}")
    spawn = sup._spawn_member
    repaired = threading.Event()

    def timed_spawn(spec_):
        times["spawn_start"] = time.perf_counter()
        times["spawn_epoch"] = time.time()
        rid = spawn(spec_)
        times["ready"] = time.perf_counter()
        repaired.set()
        return rid

    sup._spawn_member = timed_spawn
    plan = FaultPlan(fleet_sigkill_at=0, fleet_sigkill_replica=1)
    sweeps = [0]
    edge = HttpEdge(sup.router, sweep_fn=lambda: sup.sweep(),
                    submit_fn=sup.submit,
                    drain_fn=lambda why: sup.drain(reason=why)).start()
    results = [None] * len(prompts)
    try:
        inner = sup.sweep

        def counted():
            # the plan's wrapper, installed over this one, kills the
            # victim just before the first sweep after it is armed
            if plan.fired and "kill" not in times:
                times["kill"] = time.perf_counter()
            sweeps[0] += 1
            return inner()

        sup.sweep = counted

        def client(j):
            results[j] = stream_generate(edge.addr, prompts[j], MAX_NEW,
                                         timeout_s=FLEET_STREAM_S)
            # the second request waits for the repair: the new child
            # then meets live traffic (the survivors are still busy)
            if repaired.wait(FLEET_STREAM_S) and "abort" not in times:
                results[j + FLEET_CLIENTS] = stream_generate(
                    edge.addr, prompts[j + FLEET_CLIENTS], MAX_NEW,
                    timeout_s=FLEET_STREAM_S)

        if len(prompts) != 2 * FLEET_CLIENTS:
            raise Fail(f"fleet: {len(prompts)} requests for "
                       f"{FLEET_CLIENTS} clients of two each")
        t_burst = time.perf_counter()
        with ThreadPoolExecutor(FLEET_CLIENTS) as pool:
            base = sweeps[0]
            futures = [pool.submit(client, j) for j in range(FLEET_CLIENTS)]
            # arm the kill mid-burst: FLEET_KILL_AFTER sweeps into it,
            # every replica holding live work
            while (sweeps[0] - base < FLEET_KILL_AFTER
                   or not all(r.pending for r in sup.router.replicas)):
                if (sweeps[0] - base >= FLEET_KILL_AFTER
                        and edge.counters()["active_streams"] == 0):
                    times["abort"] = True
                    repaired.set()      # release the waiting clients
                    done = [(r.status, r.outcome, r.error)
                            for r in results if r]
                    raise Fail(f"fleet: the first wave ended before every "
                               f"replica held work: {done}")
                time.sleep(0.002)
            plan.wrap_fleet(sup)
            for f in futures:
                f.result()
        wall = time.perf_counter() - t_burst
        edge.drain(reason="fleet phase done")
        if not edge.wait_drained(timeout_s=60.0):
            raise Fail("fleet: the edge did not drain")
        sup.reconcile()
        c = sup.router.counters()
        e = edge.counters()
        per_child = {r.rid: child_launches(r) for r in sup.router.replicas}
        served = {r.rid: sum(res.replica == r.rid
                             for res in sup.router.results.values())
                  for r in sup.router.replicas}
        frames = sum(r.server.counters()["rpc_client_frames"]
                     for r in sup.router.replicas)
        coalesced = sum(r.server.counters()["rpc_frames_coalesced"]
                        for r in sup.router.replicas)
        alive = [r.rid for r in sup.router.replicas if r.alive]
        pids.update(p.pid for p in sup.procs.values() if p is not None)
        respawn_parts = boot_parts(sup.router.replicas[-1],
                                   times["spawn_epoch"],
                                   times["ready"] - times["spawn_start"])
    finally:
        edge.close()
        sup.shutdown(drain=False)
    # gates: exactly one completed outcome per stream, equal tokens by the
    # gap rule, balanced books, every live child launched A and B, and no
    # process left behind
    bad = [(i, r.status, r.outcome, r.error) for i, r in enumerate(results)
           if r is None or r.status != 200 or r.outcome != "completed"]
    if bad:
        raise Fail(f"fleet: streams not completed: {bad}")
    if plan.fired != ["fleetkill@0"] or c["replicas_lost"] != 1:
        raise Fail(f"fleet: the kill: fired {plan.fired}, lost "
                   f"{c['replicas_lost']}")
    if not (c["completed"] == len(prompts) == c["fleet_completed"]
            == e["requests"] == e["completed"]) or c["failed"] or c["shed"]:
        raise Fail(f"fleet: books do not balance: router {c}, edge {e}")
    if c["redistributed"] < 1:
        raise Fail("fleet: the killed replica's work was not redistributed")
    toks = [r.tokens for r in results]
    same = check_greedy("fleet over HTTP", toks, ref, prompts, params,
                        plain_cfg)
    idle = [rid for rid in alive if not (per_child[rid]["flash_fwd"]
                                         and per_child[rid]["ragged_tq1"])]
    if idle:
        raise Fail(f"fleet: live children without A and B launches: "
                   f"{ {r: per_child[r] for r in idle} }; requests "
                   f"finished by each replica: {served}")
    orphans = [p for p in pids if not proc_gone(p)]
    if orphans:
        raise Fail(f"fleet: processes outlived the drain: {orphans}")
    slo = slo_report(results, wall)
    n_tok = sum(len(t) for t in toks)
    out.update(
        requests=len(prompts), clients=FLEET_CLIENTS, wall_s=wall,
        requests_per_s=len(prompts) / wall, tokens_per_s=n_tok / wall,
        p50_ttft_s=slo["p50_ttft_s"], p99_ttft_s=slo["p99_ttft_s"],
        p50_itg_s=slo["p50_itg_s"], p99_itg_s=slo["p99_itg_s"],
        same=same, sweeps=sweeps[0], rpc_frames=frames,
        rpc_frames_per_sweep=frames / max(sweeps[0], 1),
        rpc_frames_coalesced=coalesced,
        repair_s=times["ready"] - times["kill"],
        respawn_boot_s=times["ready"] - times["spawn_start"],
        respawn_parts_s=respawn_parts,
        redistributed=c["redistributed"], launches=per_child,
        served=served,
        alive=alive, spawned=sup.stats["spawned"])
    log(f"  fleet over HTTP: {len(prompts)} streams, "
        f"{out['requests_per_s']:.2f} requests/s, {out['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{slo['p50_ttft_s']:.3f} s p99 {slo['p99_ttft_s']:.3f}; gap p50 "
        f"{slo['p50_itg_s'] * 1e3:.2f} ms p99 {slo['p99_itg_s'] * 1e3:.2f}; "
        f"repair {out['repair_s']:.1f} s (the new child's boot "
        f"{out['respawn_boot_s']:.1f}: {respawn_parts}); {frames} frames "
        f"over {sweeps[0]} "
        f"sweeps ({out['rpc_frames_per_sweep']:.2f} a sweep), "
        f"{coalesced} coalesced; requests finished by each replica "
        f"{served}; launches per child {per_child}")
    return out


class FleetPair:
    """The disaggregated pair's supervisor (it owns the shared-memory
    arena) and its two children, started at once -- the fleet phase
    starts them beside the unified trio, so the five boot together."""

    def __init__(self):
        from paddle_tpu_torch.serve.fleet import (FleetSupervisor,
                                                  ReplicaProcess,
                                                  ReplicaSpec)
        from paddle_tpu_torch.serve.transport import (ProcessReplica,
                                                      ReplicaClient)

        pending = []

        def spawn(_spec):
            # the supervisor takes the started children in role order
            proc = pending.pop(0)
            proc.wait_ready(FLEET_BOOT_S)
            return ProcessReplica(ReplicaClient(proc.addr, io_timeout=120.0),
                                  proc=proc, clock=self.sup.clock)

        self.sup = FleetSupervisor(
            ReplicaSpec(builder="chip_smoke:fleet_server"), min_replicas=2,
            max_replicas=2, spawn=spawn, data_plane_segs=FLEET_ARENA_SEGS,
            data_plane_seg_kb=FLEET_ARENA_SEG_KB,
            router_kwargs=dict(policy=prefill_first_policy()))
        if self.sup.arena is None:
            raise Fail("fleet disaggregated: no shared-memory arena")
        self.t0, self.epoch0 = time.perf_counter(), time.time()
        self.procs = [ReplicaProcess(ReplicaSpec(
            builder="chip_smoke:fleet_server", device="cuda",
            kwargs=dict(kv_cache_dtype="int8", role=role,
                        data_plane=self.sup.arena.name))).start()
            for role in ("prefill", "decode")]
        pending.extend(self.procs)

    def close(self):
        self.sup.shutdown(drain=False)
        for p in self.procs:
            p.kill()
            p.reap()


def fleet_disagg(pair, prompts, ref):
    """The pair -- one prefill and one decode process over the
    supervisor's shared-memory arena, int8 KV: every request crosses
    processes (pages card -> host -> arena -> the other child's card);
    gates and numbers as fleet_phase says."""
    cfg8 = TT.TransformerConfig(**SERVE_CFG, kv_cache_dtype="int8")
    params = TT.init_params(np.random.RandomState(0), cfg8, device="cuda")
    sup = pair.sup
    try:
        sup.start()
        boot = time.perf_counter() - pair.t0
        parts = [boot_parts(r, pair.epoch0, None)
                 for r in sup.router.replicas]
        src, dst = (r.server for r in sup.router.replicas)
        ex, im, pages = [], [], []
        timed_calls(src, "export_request", ex)
        timed_calls(dst, "import_request", im)
        export = src.export_request

        def counted(req_id):
            payload = export(req_id)
            pages.append(payload["n_pages"])
            return payload

        src.export_request = counted
        t0 = time.perf_counter()
        ids = [sup.submit(p, max_new=MAX_NEW) for p in prompts]
        res = sup.run()
        wall = time.perf_counter() - t0
        sup.reconcile()
        c = sup.router.counters()
        sc, dc = src.counters(), dst.counters()
        pids = [p.pid for p in pair.procs]
    finally:
        pair.close()
    bad = [r for r in ids if res[r].outcome != "completed"]
    if bad:
        raise Fail(f"fleet disaggregated: not completed: {bad}")
    if c["migrations"] != len(prompts) or c["migration_failed"]:
        raise Fail(f"fleet disaggregated: {c['migrations']} migrations of "
                   f"{len(prompts)}, {c['migration_failed']} failed")
    if c["fleet_data_plane_fallbacks"]:
        raise Fail(f"fleet disaggregated: "
                   f"{c['fleet_data_plane_fallbacks']} data-plane fallbacks")
    if not dc["launch_int8_tq1"] or sc["launch_int8_tq1"]:
        raise Fail(f"fleet disaggregated: C launches: prefill child "
                   f"{sc['launch_int8_tq1']}, decode child "
                   f"{dc['launch_int8_tq1']}")
    if not (sc["kv_exports"] == dc["kv_imports"] == len(prompts)
            and sc["kv_export_crc"] == dc["kv_import_crc"]):
        raise Fail(f"fleet disaggregated: migrated pages differ: exported "
                   f"{sc['kv_exports']} (crc {sc['kv_export_crc']}), "
                   f"imported {dc['kv_imports']} (crc "
                   f"{dc['kv_import_crc']})")
    if any(not proc_gone(p) for p in pids):
        raise Fail(f"fleet disaggregated: processes left: {pids}")
    toks = [res[r].tokens for r in ids]
    same = check_greedy("fleet disaggregated", toks, ref, prompts, params,
                        dataclasses.replace(cfg8, attn_impl="dense"))
    moved = len(ex)
    bytes_out = sum(pages) * page_bytes(cfg8)
    n_tok = sum(len(t) for t in toks)
    launches = {"prefill": {k[len("launch_"):]: v for k, v in sc.items()
                            if k.startswith("launch_")},
                "decode": {k[len("launch_"):]: v for k, v in dc.items()
                           if k.startswith("launch_")}}
    out = dict(
        requests=len(prompts), spawn_to_start_s=boot, boot_parts_s=parts,
        wall_s=wall,
        tokens_per_s=n_tok / wall, migrations=c["migrations"],
        ms_per_migrated_slot=1000.0 * (sum(ex) + sum(im)) / moved,
        export_rpc_ms=1000.0 * sum(ex) / moved,
        import_rpc_ms=1000.0 * sum(im) / moved,
        bytes_per_migrated_slot=bytes_out / moved, pages=sum(pages),
        same=same, launches=launches, kv_crc=sc["kv_export_crc"])
    log(f"  disaggregated pair (int8 KV, shm arena): booted beside the "
        f"trio (each child's parts, s: {parts}); "
        f"{len(prompts)} migrations across processes, pages bit for bit "
        f"(crc {sc['kv_export_crc']}); {out['ms_per_migrated_slot']:.2f} ms "
        f"per migrated slot (export RPC {out['export_rpc_ms']:.2f} + import "
        f"RPC {out['import_rpc_ms']:.2f}), "
        f"{out['bytes_per_migrated_slot']:.0f} bytes a slot; {out['tokens_per_s']:.1f} tokens/s; launches "
        f"{launches}")
    return out


def fleet_phase():
    """The process fleet at bench_engine's width (see the module
    docstring, 7d)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip()
    log(f"phase fleet: {FLEET_REPLICAS} replica processes x {SERVE_CFG}, "
        f"slots={SLOTS} max_len={MAX_LEN} page={PAGE}, {N_REQ} requests "
        f"over HTTP by {FLEET_CLIENTS} clients; card: {card}")
    if "Exclusive" in card:
        raise Fail(f"fleet: the card's compute mode refuses a second "
                   f"context: {card}")
    cfg = TT.TransformerConfig(**SERVE_CFG)
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    prompts = make_prompts()
    refs = serve_refs("float KV", params, cfg, prompts)
    ref = refs["kernel"]
    ref8 = serve_refs("int8 KV", params,
                      dataclasses.replace(cfg, kv_cache_dtype="int8"),
                      prompts)["kernel"]
    # the yardstick: the same requests through one engine in this process
    # (the serve phase's measured run)
    out = {"card": card, "in_process": dict(
        tokens_per_s=sum(len(t) for t in ref) / refs["wall"],
        wall_s=refs["wall"])}
    # the disaggregated pair boots beside the unified trio, then waits
    pair = FleetPair()
    try:
        out["unified"] = fleet_unified(params, prompts, ref)
    except BaseException:
        pair.close()
        raise
    out["http_vs_in_process"] = (out["unified"]["tokens_per_s"]
                                 / out["in_process"]["tokens_per_s"])
    out["disaggregated"] = fleet_disagg(pair, prompts[:FLEET_DISAGG_REQ],
                                        ref8[:FLEET_DISAGG_REQ])
    launched = out["unified"]["launches"]
    out["launches"] = {
        "flash_fwd": (sum(v["flash_fwd"] for v in launched.values())
                      + sum(v["flash_fwd"] for v in
                            out["disaggregated"]["launches"].values())),
        "ragged_tq1": sum(v["ragged_tq1"] for v in launched.values()),
        "ragged_tqn": sum(v["ragged_tqn"] for v in launched.values()),
        "int8_tq1": out["disaggregated"]["launches"]["decode"]["int8_tq1"],
        "int8_tqn": sum(v["int8_tqn"] for v in
                        out["disaggregated"]["launches"].values())}
    log(f"  fleet phase launches, summed over the children: "
        f"{out['launches']}; over HTTP {out['http_vs_in_process']:.3f}x "
        f"the tokens/s of one engine in process "
        f"({out['in_process']['tokens_per_s']:.1f}) on the same requests "
        f"({card})")
    return out


# -- the five remaining zoo models and the leaf ops (no kernel) -----------------

# the zoo phase: each model at its own widths (word2vec at the imikolov
# dictionary's 1000 words, embed 32, hidden 256, context 4 (the book
# chapter's); the recommender at RecommenderConfig's defaults over the
# movielens surrogate's users, movies and categories; traffic at its
# defaults; the GAN's 784-256-256 MLPs and the VAE(784) on the MNIST
# surrogate), at the phase's batches
ZOO_BATCH = {"word2vec": 256, "word2vec_nce": 256, "recommender": 256,
             "traffic": 256, "gan": 128, "vae": 128}
ZOO_STEPS = 5                 # timed, after the parity step
ZOO_LR = 1e-3                 # adam, but the GAN's own adam(2e-4, 0.5)
W2V_CONTEXT, W2V_NOISE = 4, 16
ZOO_LOSS_RTOL, ZOO_GRAD_RTOL, ZOO_OPS_RTOL = 1e-3, 1e-4, 1e-4


def zoo_data():
    """Each model's CPU weights, loss and batch (the numpy surrogates,
    seeded) with its injected noise, and how a training step on the card
    draws that noise there: {name: (init() -> params, loss_fn, args,
    redraw(args, generator) -> args or None)}, and the GAN's real
    batch."""
    zoo, ds = TDATA.dataset_zoo, TDATA.datasets
    rs = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    vocab = len(zoo.imikolov_build_dict())
    b = ZOO_BATCH["word2vec"]
    grams = np.asarray(list(zoo.imikolov(zoo.imikolov_build_dict(),
                                         n=W2V_CONTEXT + 1)())[:b], np.int64)
    ctx, nxt = t(grams[:, :W2V_CONTEXT]), t(grams[:, W2V_CONTEXT])
    w2v_kw = dict(embed_dim=32, hidden=256, context=W2V_CONTEXT)
    noise = SAMP.log_uniform_sample(torch.Generator().manual_seed(1),
                                    W2V_NOISE, vocab, (b,))

    b = ZOO_BATCH["recommender"]
    rows = list(zoo.movielens(n=b, seed=0)())
    u, g, a, j, m, c, score = map(np.asarray, zip(*rows))
    cfg = ZREC.RecommenderConfig(
        n_users=zoo.movielens_max_user_id() + 1,
        n_movies=zoo.movielens_max_movie_id() + 1,
        n_categories=zoo.movielens_movie_categories())
    cats = np.stack([c, (c + 5) % cfg.n_categories,
                     (c + 7) % cfg.n_categories], 1)
    titles = (m[:, None] * 7 + np.arange(6)[None, :] * 13) % cfg.title_vocab
    rec_batch = {k: t(v.astype(np.int64)) for k, v in dict(
        user_id=u, gender_id=g, age_id=a, job_id=j, movie_id=m,
        cat_ids=cats, cat_lengths=rs.randint(1, 4, b),
        title_ids=titles, title_lengths=rs.randint(1, 7, b)).items()}
    rating = t(score.astype(np.float32))

    b = ZOO_BATCH["traffic"]
    speed = rs.rand(b, 24).astype(np.float32)
    # the class of every horizon follows the mean speed (learnable)
    klass = np.clip(speed.mean(1, keepdims=True) * 4, 0, 3.99).astype(
        np.int64).repeat(24, 1)

    images = np.stack([img for img, _ in ds.mnist(synthetic_n=128)()])
    flat = images.reshape(len(images), 784)
    vae_x = t((flat > 0.5).astype(np.float32))
    vae = ZVAE.VAE(784)
    vae_eps = torch.randn((ZOO_BATCH["vae"], 32),
                          generator=torch.Generator().manual_seed(2))
    vae_state = vae.init(0, NM.ShapeSpec((ZOO_BATCH["vae"], 784)),
                         device="cpu")[1]

    def vae_loss(params, x, eps):
        out, _ = vae.apply(params, vae_state, x, training=True, eps=eps)
        return ZVAE.elbo_loss(out, x)

    return {
        "word2vec": (lambda: ZW2V.init_params(0, vocab, device="cpu",
                                              **w2v_kw),
                     ZW2V.loss, (ctx, nxt), None),
        "word2vec_nce": (
            lambda: ZW2V.init_params(0, vocab, device="cpu", **w2v_kw),
            lambda p, c, n, z: ZW2V.loss_nce(p, c, n, num_noise=W2V_NOISE,
                                             noise_ids=z),
            (ctx, nxt, noise),
            lambda a, gen: [a[0], a[1], SAMP.log_uniform_sample(
                gen, W2V_NOISE, vocab, (a[0].shape[0],))]),
        "recommender": (lambda: ZREC.init_params(0, cfg, device="cpu"),
                        ZREC.loss, (rec_batch, rating), None),
        "traffic": (lambda: ZTRAFFIC.init_params(0, device="cpu"),
                    ZTRAFFIC.loss, (t(speed), t(klass)), None),
        "vae": (lambda: vae.init(0, NM.ShapeSpec((ZOO_BATCH["vae"], 784)),
                                 device="cpu")[0],
                vae_loss, (vae_x, vae_eps),
                lambda a, gen: [a[0], torch.randn(a[1].shape, generator=gen,
                                                  device=a[1].device)]),
        "gan": t(flat[:ZOO_BATCH["gan"]]),
    }


def zoo_loss_and_grads(loss_fn, params, args, device, dtype=None):
    """loss_fn(params, *args) and its gradients (params' tree) on
    `device`, every float cast to `dtype` where one is given."""
    cast = lambda x: x.to(device=device, dtype=dtype if (
        dtype is not None and x.is_floating_point()) else x.dtype)
    p = trainable(tree_map(cast, params))
    loss = loss_fn(p, *tree_map(cast, list(args)))
    got = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss.item(), tree_map(lambda _: next(got), p)


def zoo_gate(name, run):
    """The first step on the card against the same step on CPU tensors:
    run(device, dtype) -> (losses, gradient tree). Losses within
    ZOO_LOSS_RTOL; gradients leaf by leaf within ZOO_GRAD_RTOL (floored
    as the seq2seq phase's), on the leaves where f32 is well conditioned:
    where the CPU's f32 gradient is within ZOO_GRAD_RTOL / 10 of a
    float64 run on the CPU (the rest printed beside their float64
    errors)."""
    lk, gk = run("cuda", None)
    lp, gp = run("cpu", None)
    _, g64 = with_policy(F64, run, "cpu", torch.float64)
    errs, cpu64 = leaf_errs(gk, gp), leaf_errs(gp, g64)
    card64 = leaf_errs(gk, g64)
    gated = [n for n in errs if cpu64[n] <= ZOO_GRAD_RTOL / 10]
    l_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lk, lp))
    g_err = max((errs[n] for n in gated), default=0.0)
    out = dict(loss=lk, plain_loss=lp, loss_rel_err=l_err,
               grad_rel_err=g_err, leaves_gated=len(gated),
               leaves=len(errs),
               not_gated={n: {"err": errs[n], "cuda_vs_f64": card64[n],
                              "cpu_vs_f64": cpu64[n]}
                          for n in errs if n not in gated})
    log(f"  {name}: card vs CPU, loss {lk} / {lp} (rel {l_err:.2e}, tol "
        f"{ZOO_LOSS_RTOL:.0e}); gradients max rel err {g_err:.2e} over "
        f"{len(gated)} of {len(errs)} leaves (tol {ZOO_GRAD_RTOL:.0e})")
    if out["not_gated"]:
        log("    not gated (the CPU's f32 over float64's by more than "
            f"{ZOO_GRAD_RTOL / 10:.0e}), card vs CPU / card vs f64 / CPU "
            "vs f64: " + ", ".join(
                f"{n} {v['err']:.1e}/{v['cuda_vs_f64']:.1e}/"
                f"{v['cpu_vs_f64']:.1e}" for n, v in out["not_gated"].items()))
    if l_err > ZOO_LOSS_RTOL or g_err > ZOO_GRAD_RTOL or not gated:
        raise Fail(f"zoo: {name}'s first step differs between the card and "
                   f"the CPU: {out}")
    return out


def zoo_train(name, step, n=ZOO_STEPS):
    """1 + n calls of step(i) -> loss tensor on the card: (losses, ms per
    timed step, ending in a sync). The losses must be finite and the
    last below the first."""
    torch.cuda.synchronize()
    losses = [step(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n + 1):
        losses.append(step(i))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    losses = [v.item() for v in losses]
    log(f"  {name}: {ms:.3f} ms/step over {n} steps; losses "
        f"{['%.6f' % v for v in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"zoo: {name}'s losses do not fall: {losses}")
    return losses, ms


def zoo_model(name, init, loss_fn, args, redraw):
    """A model's parity gate, then 1 + ZOO_STEPS adam steps on the card
    on the same batch, its noise drawn anew each step on the card
    (`redraw`)."""
    params0 = init()

    def run(dev, dtype):
        loss, grads = zoo_loss_and_grads(loss_fn, params0, args, dev, dtype)
        return [loss], grads

    out = zoo_gate(name, run)
    params = tree_to(params0, "cuda")
    dargs = tree_map(lambda x: x.to("cuda"), list(args))
    opt = OPT.adam(ZOO_LR)
    opt_state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def step(i):
        a = dargs if redraw is None else redraw(dargs, gen)
        p = trainable(params)
        loss = loss_fn(p, *a)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
        opt.update(tree_map(lambda _: next(grads), params), opt_state,
                   params, torch.tensor(i, dtype=torch.int32,
                                        device="cuda"))
        return loss.detach()

    out["losses"], out["ms_per_step"] = zoo_train(name, step)
    return out


def recording(opt, seen):
    """`opt`, keeping a copy of the gradients each update receives."""
    def update(grads, state, params, step):
        seen.append(tree_map(lambda g: g.detach().clone(), grads))
        return opt.update(grads, state, params, step)
    return OPT.Optimizer(opt.init, update)


def zoo_gan(real):
    """GANTrainer(mlp_generator(784), mlp_discriminator()): the first
    train_step (a discriminator and a generator update, each adam(2e-4,
    beta1=0.5)) on the card against CPU tensors from the same weights and
    latent batches -- both losses, and the gradients each update
    received --, then 1 + ZOO_STEPS steps on the card with the latents
    drawn there; the discriminator's loss must fall."""
    b = real.shape[0]
    state0 = ZGAN.GANTrainer(ZGAN.mlp_generator(784),
                             ZGAN.mlp_discriminator(), data_dim=784
                             ).init_state(0, b, device="cpu")
    zg = torch.Generator().manual_seed(4)
    z = [torch.randn((b, 64), generator=zg) for _ in range(2)]

    def trainer(seen_d=None, seen_g=None):
        adam = lambda: OPT.adam(2e-4, beta1=0.5)
        rec = lambda seen: recording(adam(), seen) if seen is not None \
            else adam()
        return ZGAN.GANTrainer(ZGAN.mlp_generator(784),
                               ZGAN.mlp_discriminator(), data_dim=784,
                               g_optimizer=rec(seen_g),
                               d_optimizer=rec(seen_d))

    def state_on(tr, dev, dtype=None):
        gp, dp = (tree_to(p, dev, dtype) for p in (state0.g_params,
                                                   state0.d_params))
        return ZGAN.GANState(gp, {}, tr.g_optim.init(gp), dp, {},
                             tr.d_optim.init(dp),
                             torch.zeros((), dtype=torch.int32, device=dev))

    def run(dev, dtype):
        seen_d, seen_g = [], []
        tr = trainer(seen_d, seen_g)
        dt = dtype or torch.float32
        _, d, g = tr.train_step(state_on(tr, dev, dtype),
                                real.to(dev, dt),
                                z=[v.to(dev, dt) for v in z])
        return [d.item(), g.item()], {"d": seen_d[0], "g": seen_g[0]}

    out = zoo_gate("gan", run)
    tr = trainer()
    state = state_on(tr, "cuda")
    dreal = real.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    g_losses = []

    def step(i):
        nonlocal state
        state, d, g = tr.train_step(state, dreal, gen)
        g_losses.append(g)
        return d

    out["d_losses"], out["ms_per_step"] = zoo_train("gan", step)
    out["g_losses"] = [v.item() for v in g_losses]
    if not all(np.isfinite(out["g_losses"])):
        raise Fail(f"zoo: the generator's losses: {out['g_losses']}")
    out["sample_shape"] = list(tr.sample(state, gen, 4).shape)
    return out


# -- the leaf ops (queue 1 item 6.1) on the card against the CPU --------------


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def op_card_vs_cpu(name, fn, args, *, diff=(), exact=False):
    """fn(*args) on card tensors against the same call on CPU tensors
    (numpy args become tensors on each side; keywords go in closures).
    Integer and bool outputs must be equal, floats too where exact;
    other floats within ZOO_OPS_RTOL of their max |CPU value|. `diff`:
    the args whose gradients of sum(out_i * c_i) over the float outputs,
    with seeded cotangents c_i, agree the same way. Returns the worst
    float error."""
    def call(dev):
        t = [torch.from_numpy(np.array(a)).to(dev)
             if isinstance(a, (np.ndarray, np.generic)) else a for a in args]
        for k in diff:
            t[k] = t[k].clone().requires_grad_(True)
        with torch.set_grad_enabled(bool(diff)):
            outs = _flat(fn(*t))
            grads = []
            if diff:
                rs = np.random.RandomState(0)
                s = sum((o * torch.from_numpy(rs.standard_normal(
                    tuple(o.shape)).astype(np.float32)).to(o.device, o.dtype)
                         ).sum() for o in outs if o.is_floating_point())
                grads = torch.autograd.grad(s, [t[k] for k in diff])
        return ([o.detach().cpu() for o in outs], [g.cpu() for g in grads])

    (ok, gk), (op, gp) = call("cuda"), call("cpu")
    worst = 0.0
    for i, (a, b) in enumerate(zip(ok + gk, op + gp)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise Fail(f"zoo ops: {name} output {i}: {a.shape} {a.dtype} on "
                       f"the card, {b.shape} {b.dtype} on the CPU")
        if exact or not b.is_floating_point():
            if not torch.equal(a, b):
                raise Fail(f"zoo ops: {name} output {i} differs between the "
                           f"card and the CPU")
            continue
        err = rel_err(a, b) if b.numel() else 0.0
        worst = max(worst, err)
        if not err <= ZOO_OPS_RTOL:
            raise Fail(f"zoo ops: {name} output {i}: {err:.2e} from the CPU "
                       f"(tol {ZOO_OPS_RTOL:.0e})")
    return worst


def zoo_op_cases():
    """(name, fn, numpy args, keywords of op_card_vs_cpu) for every
    function of the leaf ops, at the JAX tests' shapes (seeded)."""
    rs = np.random.RandomState(0)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)
    bits = lambda *s: (rs.rand(*s) > 0.5).astype(np.float32)
    probs = lambda *s: (lambda z: (z / z.sum(-1, keepdims=True)).astype(
        np.float32))(np.exp(f(*s)))
    tied = lambda: rs.randint(0, 3, (16, 6)).astype(np.float32)
    ids = lambda hi, *s: rs.randint(0, hi, s).astype(np.int64)
    d = dict(diff=(0,))
    cases = []
    add = lambda name, fn, args, **kw: cases.append((name, fn, args, kw))

    # losses
    add("reduce_loss", lambda a, w: LS.reduce_loss(a, w), [f(6), rs.rand(
        6).astype(np.float32)], diff=(0, 1))
    add("softmax_cross_entropy", LS.softmax_cross_entropy,
        [f(4, 6), ids(6, 4)], **d)
    add("soft_label_cross_entropy", LS.soft_label_cross_entropy,
        [f(4, 6), probs(4, 6)], diff=(0, 1))
    add("cross_entropy_with_probs", LS.cross_entropy_with_probs,
        [probs(4, 6), ids(6, 4)], **d)
    add("sigmoid_cross_entropy", LS.sigmoid_cross_entropy,
        [3 * f(4, 6), bits(4, 6)], **d)
    add("multi_binary_label_cross_entropy",
        LS.multi_binary_label_cross_entropy, [3 * f(4, 6), bits(4, 6)], **d)
    add("squared_error", LS.squared_error, [f(4, 3, 2), f(4, 3, 2)],
        diff=(0, 1))
    add("squared_error[rank 1]", LS.squared_error, [f(6), f(6)],
        diff=(0, 1))
    add("huber_regression", lambda a, b: LS.huber_regression(a, b, 0.5),
        [2 * f(5, 4), f(5, 4)], diff=(0, 1))
    add("huber_classification", LS.modified_huber_loss,
        [np.asarray([-3.0, -0.5, 0.2, 2.5, -1.5, 0.9], np.float32),
         np.asarray([1, 1, 0, 1, 0, 0], np.float32)], **d)
    add("smooth_l1", lambda a, b: LS.smooth_l1(a, b, 2.0), [f(5, 4),
                                                          f(5, 4)],
        diff=(0, 1))
    add("hinge_loss", LS.hinge_loss, [2 * f(4, 3), bits(4, 3)], **d)
    add("rank_cost", LS.rank_cost,
        [np.asarray([0.3, -1.0, 25.0, -30.0, 2.0], np.float32),
         np.asarray([0.1, 0.5, -1.0, 0.0, 2.0], np.float32),
         rs.rand(5).astype(np.float32)], diff=(0, 1, 2))
    add("margin_rank_loss", lambda a, b, c: LS.margin_rank_loss(a, b, c,
                                                               0.1),
        [f(6), f(6), np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(
            np.float32)], diff=(0, 1))
    add("lambda_rank_segment", lambda s, r: LS.lambda_rank_segment(
        s, r, ndcg_num=3),
        [np.asarray([0.5, 1.2, 0.5, -0.3, 1.2, 0.0, 0.5, 2.0], np.float32),
         np.asarray([2, 0, 1, 3, 1, 0, 2, 1], np.float32)], **d)
    add("cos_sim", lambda a, b: LS.cos_sim(a, b, scale=5.0),
        [f(4, 8), f(4, 8)], diff=(0, 1))
    add("squared_l2_distance", LS.squared_l2_distance, [f(4, 5), f(4, 5)],
        diff=(0, 1))
    add("l1_norm", LS.l1_norm, [f(4, 5)], **d)
    add("squared_l2_norm", LS.squared_l2_norm, [f(4, 5)], **d)
    # linalg
    add("multiplex", ZLIN.multiplex, [np.asarray([2, 0, 1, 2], np.int64),
                                      f(4, 3), f(4, 3), f(4, 3)],
        diff=(1, 2, 3))
    add("bilinear_tensor_product", ZLIN.bilinear_tensor_product,
        [f(3, 4), f(3, 5), f(2, 4, 5), f(2)], diff=(0, 1, 2, 3))
    add("conv_shift", ZLIN.conv_shift, [f(3, 7), f(3, 3)], diff=(0, 1))
    add("dot_prod", ZLIN.dot_prod, [f(4, 5), f(4, 5)], diff=(0, 1))
    add("out_prod", ZLIN.out_prod, [f(4, 5), f(4, 3)], diff=(0, 1))
    add("convex_comb", ZLIN.convex_comb, [rs.rand(2, 3).astype(np.float32),
                                          f(2, 12)], diff=(0, 1))
    add("selective_fc", ZLIN.selective_fc,
        [f(3, 6), f(6, 20), f(20), np.asarray([[0, 5, 19], [1, 1, 2],
                                               [7, 3, 11]], np.int64)],
        diff=(0, 1, 2))
    # in-graph metrics: ties, where the first maximum wins
    lab = ids(6, 16)
    add("accuracy", ZMET.accuracy, [tied(), lab])
    add("classification_error", ZMET.classification_error, [tied(), lab])
    add("top_k_accuracy", lambda a, b: ZMET.top_k_accuracy(a, b, 3),
        [tied(), lab])
    # misc
    add("power", ZMISC.power, [(rs.rand(3, 4) + 0.5).astype(np.float32),
                               np.asarray([1.0, 2.0, 0.5], np.float32)],
        diff=(0, 1))
    add("slope_intercept", lambda x: ZMISC.slope_intercept(x, 2.0, 1.0),
        [f(3, 4)], **d)
    add("sum_to_one_norm", ZMISC.sum_to_one_norm,
        [(rs.rand(4, 5) + 0.1).astype(np.float32)], **d)
    add("switch_order", lambda a: ZMISC.switch_order(a, (0, 2, 3, 1),
                                                     (2, 60)),
        [f(2, 4, 5, 3)], exact=True)
    add("trans", ZMISC.trans, [f(2, 3, 7)], exact=True)
    add("resize", lambda a: ZMISC.resize(a, 21), [f(3, 7)], exact=True)
    add("maxid", lambda a: ZMISC.maxid(a, beam=3), [tied()], exact=True)
    p = probs(6, 9)
    gumbel = -np.log(-np.log(rs.uniform(1e-6, 1.0, p.shape))).astype(
        np.float32)
    add("sampling_id", lambda q, g: ZMISC.sampling_id(None, q, noise=g),
        [p, gumbel])
    add("scale_shift", ZMISC.scale_shift, [f(3, 4), np.float32(1.5),
                                           np.float32(-0.5)],
        diff=(0, 1, 2))
    add("scale_sub_region", lambda x, b: ZMISC.scale_sub_region(x, b, 10.0),
        [f(2, 4, 4, 3), np.asarray([[1, 1, 2, 3, 2, 4], [2, 3, 1, 4, 1, 1]],
                                   np.int64)], **d)
    x = f(16, 3) * 4 + 2
    stats = {"mean": x.mean(0), "std": x.std(0), "min": x.min(0),
             "max": x.max(0), "decimal_scale": np.asarray(
                 [10.0, 100.0, 10.0], np.float32)}
    keys = sorted(stats)
    add("data_norm", lambda a, *s: ZMISC.data_norm(a, dict(zip(keys, s)),
                                                   mode="min-max"),
        [x] + [stats[k] for k in keys], **d)
    add("row_conv", ZMISC.row_conv, [f(2, 6, 3), f(3, 3),
                                     np.asarray([6, 4], np.int64)],
        diff=(0, 1))
    # norms
    add("cross_channel_norm", ZNORM.cross_channel_norm,
        [f(2, 3, 3, 4), f(4)], diff=(0, 1))
    add("l2_normalize", lambda a: ZNORM.l2_normalize(a, axis=1),
        [f(3, 5, 4)], **d)
    # ctc
    # and a row no alignment fits (three labels, two repeated, in three
    # frames: ~1e30 with finite gradients)
    lp = torch.log_softmax(torch.from_numpy(f(2, 3, 3)), -1).numpy()
    add("ctc_loss", ZCTC.ctc_loss,
        [lp, np.asarray([3, 2], np.int64), np.asarray([[1, 2], [2, 0]],
                                                      np.int64),
         np.asarray([2, 1], np.int64)], **d)
    add("ctc_loss[impossible]", ZCTC.ctc_loss,
        [lp, np.asarray([3, 3], np.int64), np.asarray([[1, 1, 2]] * 2,
                                                      np.int64),
         np.asarray([3, 3], np.int64)], **d)
    lp = torch.log_softmax(torch.from_numpy(f(3, 9, 4)), -1).numpy()
    add("ctc_greedy_decode", ZCTC.ctc_greedy_decode,
        [lp, np.asarray([9, 5, 0], np.int64)], exact=True)
    # sampling
    add("log_uniform_sample", lambda u: SAMP.log_uniform_sample(
        None, 16, 1000, u=u), [rs.rand(64, 16).astype(np.float32)],
        exact=True)
    add("log_uniform_prob", lambda i: SAMP.log_uniform_prob(i, 40),
        [np.arange(40)])
    add("nce_loss", lambda *a: SAMP.nce_loss(*a, noise_probs=SAMP
                                             .log_uniform_prob(
                                                 torch.arange(12, device=a[
                                                     0].device), 12)),
        [0.3 * f(12, 4), 0.1 * f(12), 0.3 * f(3, 4),
         np.asarray([1, 5, 9], np.int64), ids(12, 3, 5)], diff=(0, 1, 2))
    codes = SAMP.build_binary_tree_codes(7)
    add("hsigmoid_loss", SAMP.hsigmoid_loss,
        [0.3 * f(6, 4), 0.1 * f(6), 0.3 * f(3, 4), ids(7, 3), *codes],
        diff=(0, 1, 2))
    add("hsigmoid_predict", SAMP.hsigmoid_predict,
        [0.3 * f(6, 4), 0.1 * f(6), 0.3 * f(3, 4), *codes], diff=(0, 1, 2))
    # conv
    for stride, k, pad in ((1, 3, "SAME"), (2, 4, "SAME"), (2, 3, "VALID"),
                           (2, 3, ((1, 0), (2, 1)))):
        add(f"conv2d_transpose[s{stride} k{k} {pad}]",
            lambda x, w, b, s=stride, p=pad: ZCONV.conv2d_transpose(
                x, w, stride=s, padding=p, bias=b),
            [f(2, 5, 6, 3), f(k, k, 3, 4), f(4)], diff=(0, 1, 2))
    add("depthwise_conv2d", lambda x, w: ZCONV.depthwise_conv2d(
        x, w, stride=2), [f(2, 7, 6, 3), f(3, 3, 1, 6)], diff=(0, 1))
    add("spp", lambda a: ZCONV.spp(a, 3, "max"), [f(2, 7, 9, 3)], **d)
    add("pad", lambda a: ZCONV.pad(a, ((0, 0), (1, 2), (0, 1), (0, 0)), 0.5),
        [f(2, 3, 4, 2)], **d)
    add("crop", lambda a: ZCONV.crop(a, (1, 4, 3, 1), (1, 3, 2, 2)),
        [f(2, 6, 5, 3)], **d)
    add("im2col", lambda a: ZCONV.im2col(a, 3, stride=2, padding="SAME"),
        [f(2, 7, 6, 3)], **d)
    add("roi_pool", lambda a, r: ZCONV.roi_pool(a, r, (3, 2), 0.5),
        [f(2, 8, 8, 3), np.asarray([[0, 0, 0, 7, 7], [1, 1.5, 2.2, 5.1, 6.8],
                                    [1, 3, 3, 3, 3], [0, 6, 6, 14, 12]],
                                   np.float32)], **d)
    add("conv3d", lambda a, w, b: ZCONV.conv3d(a, w, stride=2,
                                               padding="SAME", bias=b),
        [f(2, 5, 6, 7, 3), f(3, 2, 3, 3, 4), f(4)], diff=(0, 1, 2))
    add("max_pool3d", lambda a: ZCONV.max_pool3d(a, 3, stride=2,
                                                 padding="SAME"),
        [f(2, 5, 6, 7, 3)], **d)
    add("avg_pool3d", lambda a: ZCONV.avg_pool3d(a, 3, stride=2,
                                                 padding="SAME"),
        [f(2, 5, 6, 7, 3)], **d)
    add("maxout", lambda a: ZCONV.maxout(a, 2), [f(3, 4, 6)], **d)
    add("block_expand", lambda a: ZCONV.block_expand(a, (3, 2), stride=1),
        [f(2, 6, 7, 3)], **d)
    for hw, out in (((4, 5), (8, 7)), ((8, 8), (3, 5))):
        for ac in (False, True):
            add(f"bilinear_interp[{hw}->{out} align_corners={ac}]",
                lambda a, o=out, c=ac: ZCONV.bilinear_interp(
                    a, o, align_corners=c), [f(2, *hw, 3)], **d)
        add(f"nearest_interp[{hw}->{out}]",
            lambda a, o=out: ZCONV.nearest_interp(a, o), [f(2, *hw, 3)],
            exact=True)
    add("rotate90", lambda a: ZCONV.rotate90(a, reverse=True),
        [f(2, 3, 5, 2)], exact=True)
    add("max_pool2d_with_index", lambda a: ZCONV.max_pool2d_with_index(
        a, 3, stride=2, padding=1),
        [rs.randint(0, 3, (2, 5, 7, 2)).astype(np.float32)], exact=True)
    add("max_unpool2d", lambda a: ZCONV.max_unpool2d(
        *ZCONV.max_pool2d_with_index(a, 2, stride=1), (5, 5)),
        [f(1, 5, 5, 2)], exact=True)
    # detection (prior_boxes and build_binary_tree_codes are host numpy)
    priors = ZDET.prior_boxes((4, 4), (64, 64), [24.0])
    n = priors.shape[0]
    lo = rs.uniform(0.05, 0.55, (n, 2))
    gt = np.concatenate([lo, lo + rs.uniform(0.1, 0.4, (n, 2))],
                        1).astype(np.float32)
    add("encode_boxes", lambda g, p: ZDET.encode_boxes(g, p), [gt, priors],
        **d)
    add("decode_boxes", lambda x, p: ZDET.decode_boxes(x, p),
        [0.5 * f(n, 4), priors], **d)
    add("iou", ZDET.iou, [gt[:5], gt[5:9]], diff=(0, 1))
    add("match_priors", lambda p, g, v: ZDET.match_priors(p, g, v, 0.2),
        [priors, gt[:4], np.asarray([True, True, False, True])],
        exact=True)
    add("multibox_loss", lambda l, c, p, g, y, v: ZDET.multibox_loss(
        l, c, p, g, y, v),
        [0.1 * f(n, 4), f(n, 3), priors, gt[:3], np.asarray([1, 2, 1],
                                                             np.int64),
         np.asarray([True, True, False])], diff=(0, 1))
    boxes = gt[:12]
    add("nms_mask", ZDET.nms_mask, [boxes, (np.round(rs.rand(12) * 3) / 3
                                            ).astype(np.float32)],
        exact=True)
    add("detection_output", lambda l, c, p: ZDET.detection_output(
        l, c, p, num_classes=3, top_k=40, pre_nms_top_k=10),
        [0.3 * f(n, 4), 2 * f(n, 3), priors])
    add("detection_output[ties]", lambda l, c, p: ZDET.detection_output(
        l, c, p, num_classes=3, top_k=50, pre_nms_top_k=12),
        [np.zeros((n, 4), np.float32), np.zeros((n, 3), np.float32),
         priors])
    return cases


def zoo_ops_sweep():
    """Every leaf op on card tensors against CPU tensors; the generator
    paths (sampling_id, log_uniform_sample) drawn on the card."""
    errs = {}
    for name, fn, args, kw in zoo_op_cases():
        errs[name] = op_card_vs_cpu(name, fn, args, **kw)
    gen = torch.Generator(device="cuda").manual_seed(6)
    ids = SAMP.log_uniform_sample(gen, 16, 1000, (64,))
    draw = ZMISC.sampling_id(gen, torch.full((64, 9), 1 / 9,
                                             device="cuda"))
    if (not ids.is_cuda or int(ids.min()) < 0
            or int(ids.max()) >= 1000 or int(draw.max()) >= 9):
        raise Fail(f"zoo ops: draws on the card out of range: {ids}, {draw}")
    worst = max(errs, key=errs.get)
    log(f"  ops: {len(errs)} cases of the leaf ops equal on the card and "
        f"the CPU (ids, masks, matches, top-k exact; floats at most "
        f"{errs[worst]:.2e} of their max, {worst}; tol {ZOO_OPS_RTOL:.0e})")
    return {"cases": len(errs), "worst": worst, "worst_err": errs[worst]}


def zoo_phase():
    """The five remaining zoo models trained on the card, then the leaf
    ops' sweep; kernels A-I must not launch."""
    t_phase = time.perf_counter()
    # float32 means float32 on the card too (main() sets the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_all_counts()
    data = zoo_data()
    log(f"phase zoo: word2vec, recommender, traffic, GAN and VAE at their "
        f"own widths, batches {ZOO_BATCH}, 1 + {ZOO_STEPS} steps each")
    out = {}
    for name in ("word2vec", "word2vec_nce", "recommender", "traffic",
                 "vae"):
        out[name] = zoo_model(name, *data[name])
    out["gan"] = zoo_gan(data["gan"])
    out["ops"] = zoo_ops_sweep()
    out["launches"] = all_counts()
    log(f"  kernels A-I launched in the phase: {out['launches']}")
    if any(out["launches"].values()):
        raise Fail(f"zoo launched kernels: {out['launches']}")
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase zoo: {out['s']:.1f} s")
    return out


# -- the LM's decoders at bench_decode's width ---------------------------------

# bench_decode(batch=8, prompt_len=128, steps=128, dim=512, n_layers=8,
# n_heads=8, vocab=32000) (benchmarks/suite.py:500-668): prompts
# RandomState(0), the target's weights seed 0; its small draft (dim
# max(512 // 4, 16) = 128, 2 layers, seed 7, dense attention: head_dim
# 16, which kernel A is not built for); draft_k 4; sampling at
# temperature 0.8, top_p 0.95; beam 4. The target runs attn_impl "auto"
# (kernel A in every prefill; the bench's "dense" would run no kernel);
# new tokens cut to 32 from the bench's 128
DEC_B, DEC_PROMPT, DEC_STEPS, DEC_K, DEC_BEAM = 8, 128, 16, 4, 4
DEC_DRAFT = dict(vocab=32000, dim=128, n_layers=2, n_heads=8,
                 attn_impl="dense")
DEC_DRAFT_SEED, DEC_TEMP, DEC_TOP_P = 7, 0.8, 0.95


def teacher_logits(params, plain_cfg, seqs, t0):
    """The plain path's logits [B, steps, V] at each generated position
    of seqs [B, t0 + steps] (one dense forward over the whole rows)."""
    with torch.no_grad():
        return TT.apply(params, plain_cfg, seqs)[:, t0 - 1:-1].float()


def sample_score_gap(logits, noise):
    """The sampled decode's margin at one step: the top-2 gap of the
    filtered logits plus the step's Gumbel draw, and the nucleus
    boundary's (the least distance of a sorted position's preceding mass
    from top_p, where an ulp may move a token in or out)."""
    filt = TT._filter_logits(logits[None], DEC_TEMP, None, DEC_TOP_P)[0]
    top2 = torch.topk(filt + noise, 2).values
    desc = torch.sort(logits / DEC_TEMP, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    return min((top2[0] - top2[1]).item(),
               (before - DEC_TOP_P).abs().min().item())


def decode_gap_rule(label, toks, ref, t0, gaps_of):
    """Rows of toks [B, t0+steps] equal to ref's, or differing first at a
    step whose plain-path margin gaps_of(row, step) is <= GAP_LIMIT."""
    same, worst = 0, 0.0
    for i in range(toks.shape[0]):
        d = (toks[i, t0:] != ref[i, t0:]).nonzero()
        if not len(d):
            same += 1
            continue
        d = int(d[0])
        gap = gaps_of(i, d)
        worst = max(worst, gap)
        log(f"  {label}: row {i}: first differing step {d}: "
            f"{int(toks[i, t0 + d])} vs {int(ref[i, t0 + d])}, plain "
            f"margin {gap:.3e}")
    log(f"  {label}: tokens equal on {same}/{toks.shape[0]} rows")
    if worst > GAP_LIMIT:
        raise Fail(f"decode {label}: tokens differ at a margin {worst:.3e} "
                   f"> {GAP_LIMIT}")
    return same


def lm_beam_gaps(params, plain_cfg, prompt, steps):
    """Per row, the smallest score gap among the K+1 best candidates of
    any step of the plain path's beam search, and among its final scores:
    where it is <= GAP_LIMIT the kernel path may keep another beam."""
    b, k = prompt.shape[0], DEC_BEAM
    gaps = torch.full((b,), float("inf"), device=prompt.device)

    def record(step, logits, st):
        log_p = torch.log_softmax(logits.float(), -1).reshape(b, k, -1)
        top = torch.topk((st.scores[:, :, None] + log_p).reshape(b, -1),
                         k + 1).values
        live = top[:, :-1] > -1e29
        gap = torch.where(live, top[:, :-1] - top[:, 1:], float("inf"))
        gaps.copy_(torch.minimum(gaps, gap.min(dim=1).values))
        return logits

    search = BS.beam_search
    BS.beam_search = lambda *a, **kw: search(*a, modify_logits_fn=record,
                                             **kw)
    try:
        _, scores = TT.beam_decode(params, plain_cfg, prompt, steps, k)
    finally:
        BS.beam_search = search
    return torch.minimum(gaps, (scores[:, :-1] - scores[:, 1:]).min(
        dim=1).values).tolist()


def decode_run(label, fn, want_a):
    """One decoder call with A's launch count set to 0 just before; the
    count must be want_a (0 on the plain path). Returns (output, wall s,
    A launches)."""
    torch.cuda.synchronize()
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = FA.launch_counts["fwd"]
    if launched != want_a:
        raise Fail(f"decode {label}: A launched {launched} times, want "
                   f"{want_a}")
    return out, wall, launched


def decode_phase():
    """The LM's decoders at bench_decode's width on kernel A's prefills:
    greedy, sampled (injected Gumbel draws), beam 4, speculative with
    draft = target and with the bench's small draft, and sampled
    speculative; each on the kernel path and the plain path (attention
    dense, no kernel), held by the gap rule."""
    cfg = TT.TransformerConfig(**SERVE_CFG)
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    dcfg = TT.TransformerConfig(**DEC_DRAFT)
    log(f"phase decode: {SERVE_CFG} f32, B={DEC_B} prompt {DEC_PROMPT}, "
        f"{DEC_STEPS} new tokens; draft {DEC_DRAFT} seed {DEC_DRAFT_SEED}, "
        f"k={DEC_K}")
    t_phase = time.perf_counter()
    params = TT.init_params(0, cfg, device="cuda")
    dparams = TT.init_params(DEC_DRAFT_SEED, dcfg, device="cuda")
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (DEC_B, DEC_PROMPT)).astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    noise = SAMP.gumbel_noise((DEC_STEPS, DEC_B, cfg.vocab), generator=gen,
                              device="cuda")

    def noise_feed():
        it = iter(noise)
        return lambda shape: next(it)

    n_l, t0, steps = cfg.n_layers, DEC_PROMPT, DEC_STEPS
    modes = {
        # (kernel-path call, A launches: one per layer per prefill)
        "greedy": (lambda c: TT.generate(params, c, prompt, steps), n_l),
        "sample": (lambda c: TT.sample(params, c, prompt, steps,
                                       temperature=DEC_TEMP,
                                       top_p=DEC_TOP_P, noise=noise_feed()),
                   n_l),
        "beam": (lambda c: TT.beam_decode(params, c, prompt, steps,
                                          DEC_BEAM), n_l),
        "spec_perfect": (lambda c: TT.speculative_generate(
            params, c, params, c, prompt, steps, draft_k=DEC_K,
            return_stats=True), 2 * n_l),
        "spec_small_draft": (lambda c: TT.speculative_generate(
            params, c, dparams, dcfg, prompt, steps, draft_k=DEC_K,
            return_stats=True), n_l),
        "spec_sample_top_k1": (lambda c: TT.speculative_sample(
            params, c, dparams, dcfg, prompt, steps,
            torch.Generator(device="cuda").manual_seed(11), draft_k=DEC_K,
            top_k=1, return_stats=True), n_l),
        "spec_sample": (lambda c: TT.speculative_sample(
            params, c, dparams, dcfg, prompt, steps,
            torch.Generator(device="cuda").manual_seed(11), draft_k=DEC_K,
            temperature=DEC_TEMP, top_p=DEC_TOP_P, return_stats=True),
            n_l),
    }
    # warm the decoders, the allocator and cuBLAS outside the timed calls
    with torch.no_grad():
        TT.generate(params, cfg, prompt, 2)
        TT.beam_decode(params, cfg, prompt, 2, DEC_BEAM)
        TT.speculative_generate(params, cfg, dparams, dcfg, prompt, 2,
                                draft_k=DEC_K)
    runs, plain, out = {}, {}, {}
    for name, (call, want_a) in modes.items():
        runs[name], wall, a = decode_run(name, lambda: call(cfg), want_a)
        rate = DEC_B * steps / wall
        out[name] = dict(wall_s=wall, new_tokens_per_s=rate, a_launches=a)
        extra = ""
        if name.startswith("spec"):
            rounds = runs[name][1]
            out[name]["rounds"] = rounds.tolist()
            extra = (f", rounds per row {rounds.tolist()} (a perfect draft: "
                     f"{-(-steps // (DEC_K + 1))})")
        log(f"  {name:<18} {wall * 1e3:8.1f} ms = {rate:8.1f} new tokens/s; "
            f"A {a} launches{extra}")
        if name in ("greedy", "sample", "beam", "spec_perfect",
                    "spec_small_draft"):
            plain[name], _, _ = decode_run(name + " plain",
                                           lambda: call(plain_cfg), 0)
    seqs = {k: (v[0] if isinstance(v, tuple) else v)
            for k, v in runs.items()}
    for k in ("greedy", "sample", "beam", "spec_perfect", "spec_small_draft",
              "spec_sample_top_k1", "spec_sample"):
        s = seqs[k]
        if not bool(((s >= 0) & (s < cfg.vocab)).all()):
            raise Fail(f"decode {k}: token out of the vocabulary")
    ref = plain["greedy"]
    logits = teacher_logits(params, plain_cfg, ref, t0)
    top2 = lambda i, d: (lambda v: (v[0] - v[1]).item())(
        torch.topk(logits[i, d], 2).values)
    out["greedy"]["rows_equal_plain"] = decode_gap_rule(
        "greedy vs plain", seqs["greedy"], ref, t0, top2)
    for k in ("spec_perfect", "spec_small_draft"):
        out[k]["rows_equal_plain"] = decode_gap_rule(
            f"{k} vs plain", seqs[k], plain[k][0], t0, top2)
        out[k]["rows_equal_generate"] = decode_gap_rule(
            f"{k} vs generate", seqs[k], seqs["greedy"], t0, top2)
        if plain[k][1].tolist() != runs[k][1].tolist():
            log(f"  {k}: rounds {runs[k][1].tolist()}, plain path "
                f"{plain[k][1].tolist()}")
    out["spec_sample_top_k1"]["rows_equal_greedy"] = decode_gap_rule(
        "spec_sample top_k=1 vs greedy", seqs["spec_sample_top_k1"],
        seqs["greedy"], t0, top2)
    if runs["spec_perfect"][1].max().item() > -(-steps // (DEC_K + 1)) + 2:
        raise Fail(f"decode: the perfect draft took "
                   f"{runs['spec_perfect'][1].tolist()} rounds")
    slog = teacher_logits(params, plain_cfg, plain["sample"], t0)
    out["sample"]["rows_equal_plain"] = decode_gap_rule(
        "sample vs plain", seqs["sample"], plain["sample"], t0,
        lambda i, d: sample_score_gap(slog[i, d], noise[d, i]))
    if torch.equal(seqs["sample"], ref):
        raise Fail("decode: sampling gave the greedy tokens")
    (bs, bsc), (pbs, pbsc) = runs["beam"], plain["beam"]
    same = (bs == pbs).flatten(1).all(dim=1)
    diff = [i for i in range(DEC_B) if not bool(same[i])]
    if diff:
        gaps = lm_beam_gaps(params, plain_cfg, prompt, steps)
        for i in diff:
            log(f"  beam: row {i} differs; the plain search's smallest "
                f"candidate gap {gaps[i]:.3e}")
            if gaps[i] > GAP_LIMIT:
                raise Fail(f"decode: beam row {i} differs away from a near "
                           f"tie (gap {gaps[i]:.3e} > {GAP_LIMIT})")
    keep = same[:, None].expand_as(bsc)
    s_err = ((bsc - pbsc).abs() / pbsc.abs().clamp(min=1.0))[keep]
    s_err = s_err.max().item() if s_err.numel() else 0.0
    log(f"  beam: rows equal {DEC_B - len(diff)}/{DEC_B}, scores agree to "
        f"{s_err:.2e} relative (tol {SCORE_RTOL:.0e})")
    if s_err > SCORE_RTOL or not bool(torch.isfinite(bsc).all()):
        raise Fail(f"decode: beam scores differ: {s_err:.2e}")
    out["beam"].update(rows_equal_plain=DEC_B - len(diff),
                       score_rel_err=s_err)
    del params, dparams, noise
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  decode phase: {out['wall_s']:.1f} s")
    return out


# -- mixture-of-experts: the LM trained at bench_moe_lm's width and served ----

# bench_moe_lm(seq_len=2048, batch=8, dim=512, n_layers=8, n_heads=8,
# vocab=32000, experts=8) (benchmarks/suite.py:452): every other block 8
# experts, top-2, capacity 1.25, remat, adam 1e-3, f32, tokens
# RandomState(0), weights seed 0; 1 + 5 steps (the bench times 10), and
# the expert-choice router 1 + 2
MOE_CFG = dict(vocab=32000, dim=512, n_layers=8, n_heads=8, remat=True,
               moe_experts=8)
MOE_B, MOE_T, MOE_STEPS, MOE_EC_STEPS = 8, 2048, 5, 2
#: the MoE engine: bench_engine's width and requests (serve_phase's), cut
#: from 32 to the first 16 (8 share the prefix) to keep the phase short:
#: a 32-request serve takes ~18-24 s on each path (H100 80GB HBM3, 700 W)
MOE_SERVE_REQ = 4       # cut from 32, then 8


class routing_spy:
    """Records every top-k routing's router logits and decisions (and its
    aux loss and dropped fraction) while entered."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = PMOE.top_k_routing

        def spy(logits, *a, **kw):
            r = self.saved(logits, *a, **kw)
            self.calls.append(dict(
                logits=logits.detach(), expert=r.expert, slot=r.slot,
                keep=r.keep, aux=r.aux_loss.detach(),
                dropped=r.dropped.detach()))
            return r

        PMOE.top_k_routing = spy
        return self

    def __exit__(self, *exc):
        PMOE.top_k_routing = self.saved


def routing_diff(kernel, plain, k):
    """Compare the routing decisions of two runs call by call: counts of
    differing expert / slot / keep entries and, for each token whose set
    of chosen experts differs, the plain router's logit gap between its
    k-th and (k+1)-th expert -- the near tie that decided it."""
    n_exp = n_slot = n_keep = 0
    gaps = []
    for a, b in zip(kernel, plain):
        n_exp += int((a["expert"] != b["expert"]).sum())
        n_slot += int((a["slot"] != b["slot"]).sum())
        n_keep += int((a["keep"] != b["keep"]).sum())
        moved = (torch.sort(a["expert"], dim=0).values
                 != torch.sort(b["expert"], dim=0).values).any(dim=0)
        if bool(moved.any()):
            top = torch.topk(b["logits"][moved].float(), k + 1).values
            gaps += (top[:, k - 1] - top[:, k]).tolist()
    return dict(expert=n_exp, slot=n_slot, keep=n_keep,
                tokens_moved=len(gaps),
                largest_deciding_gap=max(gaps) if gaps else None,
                smallest_deciding_gap=min(gaps) if gaps else None)


def moe_parity(params0, tokens):
    """The first step's loss and gradients on kernel A and on the plain
    path (the flash Function's forward on its plain version) from the
    same weights. The routing decisions are compared first; the leaf
    gate (1e-4, floored as seq2seq's) holds only where every decision
    agrees, else each differing token's deciding router-logit gap must
    be a near tie (<= GAP_LIMIT) and the leaf errors are printed."""
    cfg = TT.TransformerConfig(**MOE_CFG, attn_impl="flash")
    runs = {}
    for path in ("kernel", "plain"):
        params = trainable(params0)
        FA.reset_launch_counts()
        with attention_spy(plain=path == "plain"), routing_spy() as rs:
            loss = TT.loss(params, cfg, tokens)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        runs[path] = dict(loss=loss.item(), grads=grads, routing=rs.calls,
                          launched=FA.launch_counts["fwd"])
        del params
    k, p = runs["kernel"], runs["plain"]
    diff = routing_diff(k["routing"], p["routing"], cfg.moe_k)
    l_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    g_err, lines = leaf_rel_errs(params0, k["grads"], p["grads"])
    log(f"  parity: routing over {len(k['routing'])} calls (forward and "
        f"remat recompute): differing expert {diff['expert']}, slot "
        f"{diff['slot']}, keep {diff['keep']}; tokens whose experts moved "
        f"{diff['tokens_moved']} (deciding logit gaps "
        f"{diff['smallest_deciding_gap']} .. {diff['largest_deciding_gap']})")
    log(f"  parity: loss {k['loss']:.7f} vs {p['loss']:.7f} ({l_err:.2e}, "
        f"tol {LOSS_RTOL:.0e}); gradients max rel err {g_err:.2e} (tol "
        f"{GRAD_RTOL:.0e}); A launches kernel {k['launched']}, plain "
        f"{p['launched']}")
    if k["launched"] != 2 * cfg.n_layers or p["launched"]:
        raise Fail(f"moe parity: A launched {k['launched']} (kernel path, "
                   f"want {2 * cfg.n_layers}) and {p['launched']} (plain)")
    if l_err > LOSS_RTOL:
        raise Fail(f"moe parity: losses differ: {l_err:.2e}")
    routed_same = diff["expert"] == diff["slot"] == diff["keep"] == 0
    if routed_same:
        if g_err > GRAD_RTOL:
            for line in lines:
                log(line)
            raise Fail(f"moe parity: gradients differ: {g_err:.2e}")
    else:
        for line in lines:
            log(line)
        if diff["tokens_moved"] == 0 or \
                diff["largest_deciding_gap"] > GAP_LIMIT:
            raise Fail(f"moe parity: routing differs away from a near tie: "
                       f"{diff}")
    return dict(loss_rel_err=l_err, grad_rel_err=g_err, routing=diff,
                leaf_gate_applied=routed_same)


def moe_train(params0, tokens, steps, **cfg_kw):
    """1 + steps adam steps from a copy of params0; A's launches counted
    from 0 before the warm-up; routing statistics from the warm-up step.
    Returns the run's numbers."""
    cfg = TT.TransformerConfig(**MOE_CFG, **cfg_kw)
    params = trainable(params0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    with attention_spy() as spy:
        with routing_spy() as rs:
            first, opt_state = lm_train(params, cfg, tokens, 1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest, _ = lm_train(params, cfg, tokens, steps, opt_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = FA.launch_counts["fwd"]
    losses = [x.item() for x in first + rest]
    step_s = wall / steps
    n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.n_layers))
    fwd = rs.calls[:n_moe]
    out = dict(ms_per_step=1e3 * step_s,
               tokens_per_s=MOE_B * MOE_T / step_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               a_launches=launched,
               a_launches_per_step=launched / (1 + steps), losses=losses,
               attention_calls=spy.calls,
               dropped=[c["dropped"].item() for c in fwd],
               aux=[c["aux"].item() for c in fwd])
    name = cfg_kw.get("moe_router", "topk")
    log(f"  {name:<13} {out['ms_per_step']:.1f} ms/step = "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {out['peak_gib']:.2f} "
        f"GiB; A {launched} launches ({out['a_launches_per_step']:g} per "
        f"step); losses {['%.5f' % x for x in losses]}")
    if fwd:
        log(f"    first step, per MoE block: dropped {['%.4f' % x for x in out['dropped']]}, "
            f"aux {['%.4f' % x for x in out['aux']]}")
    want = 2 * cfg.n_layers * (1 + steps)
    if launched != want or any(spy.calls.values()):
        raise Fail(f"moe_train {name}: A launched {launched} times (want "
                   f"{want}); attention off A: {spy.calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"moe_train {name}: losses not finite or not falling: "
                   f"{losses}")
    del params, opt_state
    return out


def moe_phase():
    """The MoE LM: parity of the first step (routing compared first),
    1 + MOE_STEPS top-k steps and 1 + MOE_EC_STEPS expert-choice steps at
    bench_moe_lm's width; then DecodeEngine over an MoE model at
    bench_engine's width, float and int8 KV, against the plain path."""
    cfg = TT.TransformerConfig(**MOE_CFG)
    t_phase = time.perf_counter()
    log(f"phase moe: {MOE_CFG}, top-{cfg.moe_k} capacity "
        f"{cfg.moe_capacity_factor}, B={MOE_B} T={MOE_T}, adam 1e-3, f32")
    params0 = TT.init_params(0, cfg, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (MOE_B, MOE_T)).astype(np.int32)).cuda()
    t_tok = MOE_B * (MOE_T - 1)
    cap = PMOE.capacity_for(t_tok, cfg.moe_experts, cfg.moe_capacity_factor,
                            cfg.moe_k)
    log(f"  {n_params / 1e6:.1f} M parameters; {t_tok} tokens a step, "
        f"capacity {cap} an expert, dispatch "
        f"{'scatter' if PMOE._use_scatter('auto', t_tok, cfg.moe_experts, cap) else 'einsum'}")
    out = dict(n_params=n_params, capacity=cap,
               parity=moe_parity(params0, tokens))
    torch.cuda.empty_cache()
    out["topk"] = moe_train(params0, tokens, MOE_STEPS)
    torch.cuda.empty_cache()
    out["expert_choice"] = moe_train(params0, tokens, MOE_EC_STEPS,
                                     moe_router="expert_choice")
    del params0, tokens
    torch.cuda.empty_cache()

    # serving: the engine's prefill, decode and verify bodies pass the
    # bucket-pad, inactive-slot and draft-padding masks to the router
    scfg = TT.TransformerConfig(**SERVE_CFG, moe_experts=8)
    log(f"  serve: {SERVE_CFG} moe_experts=8, slots={SLOTS} max_len="
        f"{MAX_LEN} page={PAGE}, {MOE_SERVE_REQ} requests")
    sparams = TT.init_params(np.random.RandomState(0), scfg, device="cuda")
    prompts = make_prompts()[:MOE_SERVE_REQ]
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    serve, launches = {}, {}
    for label, c, need in (
            ("float KV", scfg, ("flash_fwd", "ragged_tq1", "ragged_tqn",
                                "float_device")),
            ("int8 KV", dataclasses.replace(scfg, kv_cache_dtype="int8"),
             ("flash_fwd", "int8_tq1", "int8_tqn", "int8_device"))):
        DecodeEngine(sparams, c, **geom).serve(prompts[:2], max_new=4)
        launches[label], _, serve[label] = kernel_and_plain(
            f"moe {label}", sparams, c, prompts, need)
    out.update(serve=serve, serve_launches=launches)
    del sparams
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  moe phase: {out['wall_s']:.1f} s")
    return out


# -- the image models: training at bench_image's width -------------------------

# bench_image (benchmarks/suite.py:112-141: momentum(0.1, mu=0.9), softmax
# CE, make_train_step(donate=True), bf16 policy, inputs RandomState(0).rand,
# labels RandomState(1)) at the configs of :765-775; resnet50 also at 64
IMAGE_HW, IMAGE_STEPS = 224, 1   # steps cut from 20
IMAGE_PARITY_STEPS = 1           # resnet50's momentum steps: 1 + 1, cut
                                 # from 1 + 2
IMAGE_CONFIGS = (("resnet50", 64), ("resnet50", 256), ("resnet50_s2d", 256),
                 ("resnet50_remat", 256), ("resnet50_remat_full", 256),
                 ("alexnet", 128), ("googlenet", 128), ("vgg19", 64),
                 ("smallnet", 512))
# analytic forward GFLOPs per image at 224x224 (2 x MACs), a copy of
# paddle_tpu/core/hw.py FWD_GFLOPS; mfu_pct = 3 x this x batch over the
# step time over the card's bf16 peak, as benchmarks/suite.py:799-800
FWD_GFLOPS = {"resnet50": 8.2, "resnet50_s2d": 8.2, "resnet50_remat": 8.2,
              "resnet50_remat_full": 8.2, "vgg19": 39.0, "alexnet": 1.4,
              "googlenet": 3.0}
# CUDA against the port's CPU path: (model, batch, side) at f32; resnet50
# also under the bf16 policy and for 1 + 1 momentum steps in f64
IMAGE_PARITY = (("resnet50", 4, IMAGE_HW), ("googlenet", 2, IMAGE_HW),
                ("alexnet", 2, IMAGE_HW), ("vgg19", 2, IMAGE_HW),
                ("smallnet", 2, 32))
# (logits and gradients, losses) per compute dtype
IMAGE_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 1e-2)}
TRAINER_LOOP_B = 64
# the timed runs' learning rate (momentum 0.9): the bench's 0.1 diverges on
# one repeated batch, in the JAX package as in the port
# (tests/test_torch_image_models.py,
# test_bench_recipe_diverges_alike_in_jax_and_the_port)
IMAGE_LR = 0.01
F64 = TD.Policy(torch.float64, torch.float64, torch.float64)


def image_model(name, dropout=True):
    """suite.py:84 _image_model; dropout=False zeroes the dropout rates
    (parity runs: torch's draws never match the plain path's)."""
    drop = {} if dropout else {"dropout": 0.0}
    if name == "alexnet":
        return IM_ALEXNET.alexnet(num_classes=1000, **drop)
    if name == "googlenet":
        return IM_GOOGLENET.googlenet(num_classes=1000, **drop)
    if name == "vgg19":
        return IM_VGG.vgg(19, num_classes=1000, **drop)
    if name == "smallnet":
        return IM_SMALLNET.smallnet(num_classes=10)
    kw = {"resnet50_s2d": dict(s2d_stem=True),
          "resnet50_remat": dict(remat="conv_out"),
          "resnet50_remat_full": dict(remat="full")}.get(name, {})
    return IM_RESNET.resnet(50, num_classes=1000, **kw)


def image_batch(batch, hw, classes, device, seed=0):
    x = np.random.RandomState(seed).rand(batch, hw, hw, 3).astype(np.float32)
    y = np.random.RandomState(seed + 1).randint(0, classes, batch)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def with_policy(policy, fn, *a, **kw):
    prev = TD.default_policy()
    TD.set_default_policy(policy)
    try:
        return fn(*a, **kw)
    finally:
        TD.set_default_policy(prev)


def tree_to(tree, device, dtype=None):
    return tree_map(lambda t: t.detach().to(device=device, dtype=dtype
                                            or t.dtype).clone(), tree)


def rel64(got, ref):
    """max |got - ref| over max |ref|, in float64 (the image phase's
    results are f64 host tensors)."""
    return ((got.double().cpu() - ref.double().cpu()).abs().max().item()
            / max(ref.double().abs().max().item(), 1e-30))


def leaf_errs(got, want):
    """{leaf name: error}: each leaf's max abs error over its max |want|,
    floored at LEAF_FLOOR x the largest |want| of any leaf."""
    names = []
    tree_map_with_name(lambda n, _: names.append(n), want)
    ga, gb = tree_leaves(got), tree_leaves(want)
    top = max((b.abs().max().item() for b in gb), default=0.0)
    return {n: (a.double().cpu() - b.double().cpu()).abs().max().item()
            / max(b.abs().max().item(), LEAF_FLOOR * top, 1e-30)
            for n, a, b in zip(names, ga, gb)}


def tree_err(got, want):
    """(worst leaf, its error) of `leaf_errs`."""
    errs = leaf_errs(got, want)
    if not errs:
        return None, 0.0
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def replay_gate(replay, tol, label):
    """The gate of an OpReplay: every op's error within `tol` and its
    integer or bool outputs equal to the CPU's. Logs the largest errors;
    returns the failing op names and a summary."""
    fails = [n for n, r in replay.ops.items()
             if r["err"] > tol or r["int_diffs"]]
    top = sorted(replay.ops.items(), key=lambda kv: -kv[1]["err"])
    calls = sum(r["calls"] for r in replay.ops.values())
    log(f"    {label}: {calls} op calls of {len(replay.ops)} kinds replayed "
        f"on the CPU (tol {tol:.0e}, integer outputs equal); largest "
        + ", ".join(f"{n} x{r['calls']} {r['err']:.1e}" for n, r in top[:5])
        + f"; failing {fails}")
    return fails, dict(calls=calls, kinds=len(replay.ops), ops=replay.ops)


def ulp_nudge(x):
    """x with half its elements, picked from a seed, moved up by one ulp:
    the same batch as far as its dtype can tell, rounded another way."""
    pick = torch.from_numpy(np.random.RandomState(3).rand(*x.shape) < 0.5)
    return torch.where(pick.to(x.device), torch.nextafter(
        x, torch.full_like(x, float("inf"))), x)


class OpReplay(TorchDispatchMode):
    """Holds every op a step runs on the card against the same op run on
    the CPU on copies of the card's inputs: no error is amplified on the
    way, so each op is held on its own conditioning. Per op name it
    keeps the calls, the largest error of a floating output (max abs
    error over max |CPU|) and the integer or bool outputs (max-pool
    indices) that differ. Views, allocations and scalar reads are not
    replayed."""

    SKIP = ("empty", "new_empty", "empty_like", "empty_strided",
            "_local_scalar_dense", "copy_", "detach", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.ops = {}

    @staticmethod
    def _host(a):
        if isinstance(a, torch.Tensor):
            # NCHW-contiguous on the CPU (see ops/conv.py)
            return a.detach().to("cpu").contiguous()
        if isinstance(a, torch.device):
            return torch.device("cpu")
        return a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if view or name in self.SKIP or not any(
                isinstance(a, torch.Tensor)
                for a in pytree.tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        # the inputs are copied before the op runs: it may write one
        host_args, host_kwargs = pytree.tree_map(self._host, (args, kwargs))
        out = func(*args, **kwargs)
        ref = func(*host_args, **host_kwargs)
        rec = self.ops.setdefault(name, dict(calls=0, err=0.0, int_diffs=0))
        rec["calls"] += 1
        for o, r in zip(pytree.tree_leaves(out), pytree.tree_leaves(ref)):
            if not isinstance(o, torch.Tensor) or not o.numel():
                continue
            o = o.detach().cpu()
            if o.is_floating_point():
                r = r.double()
                rec["err"] = max(rec["err"], (o.double() - r).abs().max()
                                 .item() / max(r.abs().max().item(), 1e-30))
            else:
                rec["int_diffs"] += int((o != r).sum().item())
        return out


def image_run(model, params, mstate, x, y, policy, mode=None):
    """Eval logits and one training forward and backward under `policy`
    (the weights and inputs in its param dtype), inside `mode` (an
    OpReplay) if given: dict of eval logits, loss, train logits, grads
    and the new model state, all on the CPU in float64."""
    dt = policy.param_dtype
    p, s = tree_to(params, x.device, dt), tree_to(mstate, x.device, dt)
    xd = x.to(dt)

    def run():
        with torch.no_grad():
            logits, _ = model.apply(p, s, xd, training=False)
        loss, new_state, grads, met = loss_and_grads(
            model, ce_loss, p, s, None, (xd,), (y,),
            metrics_fn=lambda out, _: {"logits": out})
        return logits, loss, met["logits"], grads, new_state

    if mode is None:
        logits, loss, tlogits, grads, new_state = with_policy(policy, run)
    else:
        with mode:
            logits, loss, tlogits, grads, new_state = with_policy(policy, run)
    host = lambda t: tree_map(lambda a: a.detach().double().cpu(), t)
    return dict(logits=host(logits), loss=loss.item(),
                train_logits=host(tlogits), grads=host(grads),
                state=host(NM.merge_state(s, new_state)))


def image_parity_case(name, batch, hw):
    """The model on the card and on the port's CPU path from the same
    weights (drawn in f32) and batch. Held: f32 eval logits and loss
    directly (well conditioned); f64 on both devices (the semantics:
    every logit, the loss, each gradient and BN state leaf); the f32
    step op by op (OpReplay: each op the card runs, against the same op
    on the CPU on its own inputs); and the f32 step's gradients and BN
    state leaf by leaf at 1e-4 where the model is well conditioned in f32
    there: where moving half the inputs by one ulp moves no CPU leaf by
    more than tol/10. Elsewhere -- a BN net's batch statistics at these
    batches, or GoogLeNet's max pools and ReLUs, where an ulp decides a
    near tie -- the f32 leaves' errors against the CPU f64 run are
    printed for both devices beside the CPU's own one-ulp spread."""
    classes = 10 if name == "smallnet" else 1000
    model = image_model(name, dropout=False)
    params, mstate = model.init(0, NM.ShapeSpec((batch, hw, hw, 3)),
                                device="cpu")
    x, y = image_batch(batch, hw, classes, "cpu", seed=2)
    f32 = TD.Policy()
    t0 = time.perf_counter()
    cpu = {"f32": image_run(model, params, mstate, x, y, f32),
           "nudged": image_run(model, params, mstate, ulp_nudge(x), y, f32),
           "f64": image_run(model, params, mstate, x, y, F64)}
    cpu_s = time.perf_counter() - t0
    xc, yc = x.cuda(), y.cuda()
    replay = OpReplay()
    t0 = time.perf_counter()
    gpu = {"f32": image_run(model, params, mstate, xc, yc, f32, replay)}
    replay_s = time.perf_counter() - t0
    gpu["f64"] = image_run(model, params, mstate, xc, yc, F64)
    tol, loss_tol = IMAGE_TOL[torch.float32]
    truth = cpu["f64"]
    out = dict(model=name, batch=batch, hw=hw, cpu_seconds=cpu_s,
               replay_seconds=replay_s)
    g, c = gpu["f32"], cpu["f32"]
    errs = {
        "f32_eval_logits": rel64(g["logits"], c["logits"]),
        "f32_loss": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
        "f64_eval_logits": rel64(gpu["f64"]["logits"], truth["logits"]),
        "f64_train_logits": rel64(gpu["f64"]["train_logits"],
                                    truth["train_logits"]),
        "f64_loss": abs(gpu["f64"]["loss"] - truth["loss"]) / abs(
            truth["loss"]),
        "f64_grads": tree_err(gpu["f64"]["grads"], truth["grads"]),
        "f64_state": tree_err(gpu["f64"]["state"], truth["state"]),
    }
    bad = [k for k in ("f32_eval_logits", "f64_eval_logits",
                       "f64_train_logits", "f64_loss") if errs[k] > tol]
    bad += ["f32_loss"] if errs["f32_loss"] > loss_tol else []
    bad += [k for k in ("f64_grads", "f64_state") if errs[k][1] > tol]
    log(f"  parity {name} B={batch} {hw}x{hw} (CPU side {cpu_s:.1f} s, the "
        f"card's f32 step with its op replay {replay_s:.1f} s): f32 eval "
        f"logits {errs['f32_eval_logits']:.2e}, loss {errs['f32_loss']:.2e}; "
        f"f64 eval {errs['f64_eval_logits']:.2e}, train logits "
        f"{errs['f64_train_logits']:.2e}, loss {errs['f64_loss']:.2e}, "
        f"grads {errs['f64_grads'][1]:.2e} ({errs['f64_grads'][0]}), state "
        f"{errs['f64_state'][1]:.2e} (tol {tol:.0e} / {loss_tol:.0e})")
    fails, out["op_replay"] = replay_gate(replay, tol, "f32 step op by op")
    bad += [f"f32_op:{n}" for n in fails]
    # the f32 step leaf by leaf: the CPU's own one-ulp spread decides
    # whether a direct gate can hold
    trees = ("train_logits", "grads", "state")
    meas = lambda w, a, b: (("logits", rel64(a[w], b[w])) if w ==
                            "train_logits" else tree_err(a[w], b[w]))
    spread = {w: meas(w, cpu["nudged"], c) for w in trees}
    direct = {w: meas(w, g, c) for w in trees}
    vs_f64 = {w: {"cuda": meas(w, g, truth), "cpu": meas(w, c, truth)}
              for w in trees}
    held = all(v[1] <= tol / 10 for v in spread.values())
    if held:
        bad += [f"f32_{w}_direct" for w, v in direct.items() if v[1] > tol]
    out.update(errs=errs, f32_leaves=dict(
        one_ulp_spread=spread, direct=direct, vs_f64=vs_f64,
        direct_gate=held))
    log(f"    f32 step leaf by leaf: the CPU's own one-ulp spread "
        + ", ".join(f"{w} {v[1]:.2e} ({v[0]})" for w, v in spread.items())
        + (f" -> held directly at {tol:.0e}: " if held else
           " -> no direct gate can hold; printed: ")
        + ", ".join(f"{w} {v[1]:.2e} ({v[0]})" for w, v in direct.items()))
    log("      against the CPU f64 run, card / CPU: " + ", ".join(
        f"{w} {v['cuda'][1]:.2e} / {v['cpu'][1]:.2e}"
        for w, v in vs_f64.items()))
    if name == "resnet50":
        out.update(image_resnet50_extra(model, params, mstate, x, y, truth))
        bad += out.pop("bad")
    out["failing"] = bad
    return out


def image_resnet50_extra(model, params, mstate, x, y, truth):
    """resnet50's bf16-policy step (CUDA vs CPU: eval logits and loss
    directly, the step op by op; the gradients against the CPU f64 run
    printed for both devices) and 1 + IMAGE_PARITY_STEPS momentum steps
    in f64 on both devices, gated: the losses at 1e-3; the BN state, the
    velocity and each parameter's change at 1e-4."""
    bf16 = TD.bf16_compute_policy()
    tol, loss_tol = IMAGE_TOL[torch.bfloat16]
    xc, yc = x.cuda(), y.cuda()
    cpu_b = image_run(model, params, mstate, x, y, bf16)
    replay = OpReplay()
    gpu_b = image_run(model, params, mstate, xc, yc, bf16, replay)
    eval_err = rel64(gpu_b["logits"], cpu_b["logits"])
    loss_err = abs(gpu_b["loss"] - cpu_b["loss"]) / abs(cpu_b["loss"])
    grad_err = {d: tree_err(r["grads"], truth["grads"])
                for d, r in (("cuda", gpu_b), ("cpu", cpu_b))}
    bad = ["bf16_eval_logits"] if eval_err > tol else []
    bad += ["bf16_loss"] if loss_err > loss_tol else []
    log(f"    bf16 policy: eval logits CUDA vs CPU {eval_err:.2e}, loss "
        f"{loss_err:.2e} (tol {tol:.0e} / {loss_tol:.0e}); gradients against "
        f"the CPU f64 run (printed): card {grad_err['cuda'][1]:.2e} "
        f"({grad_err['cuda'][0]}), CPU {grad_err['cpu'][1]:.2e} "
        f"({grad_err['cpu'][0]})")
    fails, op_replay = replay_gate(replay, tol, "bf16 step op by op")
    bad += [f"bf16_op:{n}" for n in fails]
    # 1 + IMAGE_PARITY_STEPS momentum steps in f64 on both devices: the
    # losses and BN state, and after the last update -- the first that
    # reads mu * v -- the velocity and each parameter's change from its
    # start (the losses and BN state are set before that update)
    runs = {}
    host = lambda t: tree_map(lambda a: a.double().cpu(), t)
    for dev, xx, yy in (("cuda", xc, yc), ("cpu", x, y)):
        state, losses, _ = image_steps(model, params, mstate, xx, yy,
                                       policy=F64, steps=IMAGE_PARITY_STEPS)
        runs[dev] = dict(
            losses=[v.item() for v in losses],
            bn_state=host(state.model_state),
            velocity=host(state.opt_state["velocity"]),
            param_change=tree_map_multi(
                lambda a, b: a.double().cpu() - b.double(), state.params,
                params))
    g, c = runs["cuda"], runs["cpu"]
    l_err = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                     c["losses"]))
    errs = {k: tree_err(g[k], c[k])
            for k in ("bn_state", "velocity", "param_change")}
    steps = dict(cuda_losses=g["losses"], cpu_losses=c["losses"],
                 loss_rel_err=l_err, **{f"{k}_err": v
                                        for k, v in errs.items()})
    log(f"    {1 + IMAGE_PARITY_STEPS} momentum steps, f64: losses "
        f"{['%.6f' % v for v in g['losses']]} vs "
        f"{['%.6f' % v for v in c['losses']]}: {l_err:.2e}; "
        + ", ".join(f"{k} {v[1]:.2e} ({v[0]})" for k, v in errs.items()))
    f32_tol, f32_loss_tol = IMAGE_TOL[torch.float32]
    if l_err > f32_loss_tol or any(v[1] > f32_tol for v in errs.values()):
        bad.append("f64_momentum_steps")
    return dict(bad=bad, bf16=dict(eval_logits=eval_err, loss=loss_err,
                                   grads_vs_f64=grad_err, op_replay=op_replay),
                momentum_steps=steps)


def bn_means(state):
    """The first BN's running mean (None for a model without BN)."""
    means = []
    tree_map_with_name(lambda n, t: means.append(t) if n.endswith("mean")
                       else None, state)
    return means[0].clone() if means else None


def image_steps(model, params, mstate, x, y, *, policy=None, gen=None,
                steps=2):
    """1 + `steps` steps of momentum(IMAGE_LR, mu=0.9) through
    make_train_step(donate=True) under `policy` (None: bf16), from copies of params and
    mstate on x's device in the policy's param dtype (dropout masks from
    `gen`, seeded 0 before every step, as the bench's fixed key): (state,
    loss tensors, seconds of the last `steps` steps, ending in a sync)."""
    policy = policy or TD.bf16_compute_policy()
    dt = policy.param_dtype
    opt = OPT.momentum(IMAGE_LR, mu=0.9)
    state = TrainState.create(tree_to(params, x.device, dt),
                              tree_to(mstate, x.device, dt), opt)
    step = make_train_step(model, ce_loss, opt, donate=True)
    xd, losses = x.to(dt), []
    for i in range(1 + steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if gen is not None:
            gen.manual_seed(0)
        state, loss, _ = with_policy(policy, step, state, gen, (xd,), (y,))
        losses.append(loss)
    torch.cuda.synchronize()
    return state, losses, time.perf_counter() - t0


def image_train(name, batch):
    """bench_image's step at its width: 1 warm-up step and IMAGE_STEPS
    timed ones on one batch with momentum(IMAGE_LR, mu=0.9) (the bench's
    lr 0.1 diverges on one repeated batch; a step's time does not depend
    on the lr). Every loss finite, the last below the first (the batch
    is memorized) and the BN running stats moved."""
    hw = 32 if name == "smallnet" else IMAGE_HW
    classes = 10 if name == "smallnet" else 1000
    model = image_model(name)
    params, mstate = model.init(0, NM.ShapeSpec((batch, hw, hw, 3)),
                                device="cuda")
    x, y = image_batch(batch, hw, classes, "cuda")
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs = image_steps(model, params, mstate, x, y, gen=gen,
                                      steps=IMAGE_STEPS)
    step_s = secs / IMAGE_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [v.item() for v in losses]
    mean0, mean1 = bn_means(mstate), bn_means(state.model_state)
    moved = None if mean0 is None else bool(
        (mean1 - mean0).abs().max().item() > 0)
    rec = dict(bench=name, batch=batch, hw=hw, ms_per_batch=1e3 * step_s,
               imgs_per_sec=batch / step_s, peak_memory_bytes=peak,
               lr=IMAGE_LR, losses=losses, bn_stats_moved=moved)
    if name in FWD_GFLOPS:
        rec["mfu_pct"] = 100 * 3 * FWD_GFLOPS[name] * 1e9 * batch / step_s \
            / PEAK_FLOPS[torch.bfloat16]
    log(f"  {name:<20} B={batch:<4} {rec['ms_per_batch']:9.2f} ms/batch "
        f"{rec['imgs_per_sec']:9.1f} imgs/s mfu_pct "
        f"{rec.get('mfu_pct', float('nan')):6.2f} peak "
        f"{peak / 2**30:6.2f} GiB; losses at lr {IMAGE_LR} "
        f"{['%.4f' % v for v in losses]}; BN stats moved {moved}")
    del state, params, mstate, x, y
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise Fail(f"image {name} B={batch}: the losses are not finite or "
                   f"the last is not below the first: {losses}")
    if moved is False:
        raise Fail(f"image {name} B={batch}: BN running stats did not move")
    return rec


def image_trainer_loop():
    """bench_trainer_loop (suite.py:404): resnet50 through Trainer.train
    with a lazy EndIteration handler: 2 warm-up batches, then
    IMAGE_STEPS timed, ending in a sync; the raw step's ms beside it."""
    model = image_model("resnet50")
    opt = OPT.momentum(IMAGE_LR, mu=0.9)
    trainer = Trainer(model, ce_loss, opt)
    state = trainer.init_state(NM.ShapeSpec((TRAINER_LOOP_B, IMAGE_HW,
                                             IMAGE_HW, 3)))
    x, y = image_batch(TRAINER_LOOP_B, IMAGE_HW, 1000, "cuda")
    last = []

    def handler(ev):
        if isinstance(ev, EV.EndIteration) and ev.batch_id == IMAGE_STEPS - 1:
            last.append(ev.cost)

    batches = lambda n: (lambda: ((x, y) for _ in range(n)))
    state = with_policy(TD.bf16_compute_policy(), trainer.train, state,
                        batches(2), event_handler=handler)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = with_policy(TD.bf16_compute_policy(), trainer.train, state,
                        batches(IMAGE_STEPS), event_handler=handler)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / IMAGE_STEPS
    cost = float(last[-1])
    del state
    torch.cuda.empty_cache()
    if not np.isfinite(cost):
        raise Fail(f"image trainer loop: cost {cost}")
    return dict(batch=TRAINER_LOOP_B, ms_per_batch=ms, last_cost=cost)


def image_trainer_dropout(steps=3):
    """AlexNet (its two Dropout(0.5) layers on) at bench_image's batch
    through Trainer.train: the trainer's step generator is on the card,
    so the masks are drawn there (Dropout raises for a generator on
    another device); every cost finite."""
    batch = dict(IMAGE_CONFIGS)["alexnet"]
    trainer = Trainer(image_model("alexnet"), ce_loss,
                      OPT.momentum(IMAGE_LR, mu=0.9))
    state = trainer.init_state(NM.ShapeSpec((batch, IMAGE_HW, IMAGE_HW, 3)))
    x, y = image_batch(batch, IMAGE_HW, 1000, "cuda")
    costs = []
    state = with_policy(
        TD.bf16_compute_policy(), trainer.train, state,
        lambda: ((x, y) for _ in range(steps)),
        event_handler=lambda ev: costs.append(float(ev.cost))
        if isinstance(ev, EV.EndIteration) else None)
    gen_device = str(trainer._rng.device)
    del state
    torch.cuda.empty_cache()
    log(f"  Trainer.train alexnet (dropout 0.5) B={batch}: step generator on "
        f"{gen_device}, costs {['%.4f' % c for c in costs]}")
    if not gen_device.startswith("cuda") or len(costs) != steps or not all(
            np.isfinite(costs)):
        raise Fail(f"image trainer dropout: generator on {gen_device}, "
                   f"costs {costs}")
    return dict(model="alexnet", batch=batch, generator=gen_device,
                costs=costs)


def image_graft_entry():
    """paddle_tpu_torch.graft_entry.entry(): one ResNet-50 bf16 eval
    forward at batch 16, 224x224; finite [16, 1000] logits."""
    prev = TD.default_policy()
    try:
        fn, args = GRAFT.entry()
        out = fn(*args)
        torch.cuda.synchronize()
    finally:
        TD.set_default_policy(prev)
    ok = tuple(out.shape) == (16, 1000) and bool(torch.isfinite(out).all())
    log(f"  graft_entry.entry(): logits {tuple(out.shape)} {out.dtype}, "
        f"finite {ok}")
    if not ok:
        raise Fail(f"graft_entry: logits {tuple(out.shape)}, finite {ok}")
    return dict(shape=list(out.shape), finite=ok)


def image_phase():
    """The image models: CUDA-vs-CPU parity (IMAGE_PARITY), bench_image's
    configs (IMAGE_CONFIGS) under the bf16 policy, bench_trainer_loop and
    graft_entry.entry()."""
    log("phase image: parity with the port's CPU path, then bench_image's "
        f"configs (bf16 policy, momentum {IMAGE_LR}/0.9, softmax CE, "
        "make_train_step(donate=True))")
    t_phase, parts = time.perf_counter(), {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        parts[name] = round(time.perf_counter() - t, 3)
        return r

    parity = [timed(f"parity_{c[0]}", image_parity_case, *c)
              for c in IMAGE_PARITY]
    torch.cuda.empty_cache()
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    log("  torch.backends.cudnn.benchmark = True for the training runs")
    try:
        train = [timed(f"train_{c[0]}_b{c[1]}", image_train, *c)
                 for c in IMAGE_CONFIGS]
        loop = timed("trainer_loop", image_trainer_loop)
        raw = next(r for r in train if r["bench"] == "resnet50"
                   and r["batch"] == TRAINER_LOOP_B)
        log(f"  bench_trainer_loop resnet50 B={TRAINER_LOOP_B}: "
            f"{loop['ms_per_batch']:.2f} ms/batch through Trainer.train vs "
            f"{raw['ms_per_batch']:.2f} raw step")
        dropout = timed("trainer_dropout", image_trainer_dropout)
        entry = timed("graft_entry", image_graft_entry)
    finally:
        torch.backends.cudnn.benchmark = prev
    torch.cuda.empty_cache()
    log(f"  phase image: {time.perf_counter() - t_phase:.1f} s ({parts})")
    # the parity gates are read last, so that one run reads every model
    bad = {p["model"]: p["failing"] for p in parity if p["failing"]}
    if bad:
        raise Fail(f"image parity: {bad}")
    return dict(parity=parity, train=train, trainer_loop=loop,
                trainer_dropout=dropout, graft_entry=entry)


# -- the serving path ---------------------------------------------------------


def make_prompts():
    rs = np.random.RandomState(1)
    prefix = rs.randint(0, SERVE_CFG["vocab"], SHARED)
    prompts = []
    for i in range(N_REQ):
        if i % 2 == 0:
            tail = rs.randint(0, SERVE_CFG["vocab"], PROMPT - SHARED)
            prompts.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            prompts.append(rs.randint(0, SERVE_CFG["vocab"],
                                      PROMPT).astype(np.int32))
    return prompts


def make_spec_prompts(n):
    """Half the prompts repeat a 16-token motif (drafts the n-gram
    proposer gets right), half are random."""
    rs = np.random.RandomState(2)
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            motif = rs.randint(0, SERVE_CFG["vocab"], 16)
            prompts.append(np.tile(motif, PROMPT // 16).astype(np.int32))
        else:
            prompts.append(rs.randint(0, SERVE_CFG["vocab"],
                                      PROMPT).astype(np.int32))
    return prompts


def reset_counts():
    FA.reset_launch_counts()
    RPA.reset_launch_counts()


def counts():
    return {"flash_fwd": FA.launch_counts["fwd"],
            "flash_fwd_window": FA.launch_counts["fwd_window"],
            "ragged_tq1": RPA.launch_counts["tq1"],
            "ragged_tqn": RPA.launch_counts["tqn"],
            "int8_tq1": RPA.launch_counts["int8_tq1"],
            "int8_tqn": RPA.launch_counts["int8_tqn"],
            "float_device": RPA.device_launches["float"],
            "int8_device": RPA.device_launches["int8"]}


def timed_serve(eng, prompts, max_new=None, **kw):
    """Serve (max_new: MAX_NEW unless given) with every launch count set
    to 0 just before; returns (tokens, wall seconds, launch counts of
    this run)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.serve(prompts, max_new=max_new or MAX_NEW, **kw)
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0, counts()


def plain_gap(params, plain_cfg, prompt, step):
    """The plain engine's top-2 logit gap at generated token `step` of
    `prompt`: one slot, prefill then `step` decode steps (each mapping
    the next page, as serve() does), reading the logits its token
    selection sees."""
    eng = DecodeEngine(params, plain_cfg, ragged_impl="torch", slots=1,
                       max_len=MAX_LEN, page_size=PAGE)
    seen, select = [], eng._select

    def spy(logits, *a):
        seen.append(logits[0].float())
        return select(logits, *a)

    eng._select = spy
    state = eng.prefill(eng.init_state(), 0, prompt)
    for _ in range(step):
        state = eng.decode_step(state)[0]
        state = eng.ensure_decode_page(state, 0)
    top2 = torch.topk(seen[step], 2).values
    return (top2[0] - top2[1]).item()


def check_greedy(label, toks, ref, prompts, params, plain_cfg):
    """Greedy tokens equal to the reference's, or differing only where
    the plain path's top-2 logit gap is <= GAP_LIMIT (a near tie)."""
    same, worst = 0, None
    for i, (a, b) in enumerate(zip(toks, ref)):
        if a == b:
            same += 1
            continue
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            raise Fail(f"{label}: request {i} emitted {len(a)} tokens, the "
                       f"reference {len(b)}")
        gap = plain_gap(params, plain_cfg, prompts[i], d)
        worst = gap if worst is None else max(worst, gap)
        log(f"  {label}: request {i}: first differing step {d}: {a[d]} vs "
            f"{b[d]}, plain top-2 logit gap {gap:.3e}")
    log(f"  {label}: greedy tokens equal on {same}/{len(toks)} requests")
    if worst is not None and worst > GAP_LIMIT:
        raise Fail(f"{label}: greedy tokens differ at a top-2 gap "
                   f"{worst:.3e} > {GAP_LIMIT}")
    return same


#: label -> the kernel and plain paths' tokens of a serve_phase run and the
#: kernel path's wall time: the server phase's references
SERVE_REFS = {}


def kernel_and_plain(label, params, cfg, prompts, need):
    """Serve `prompts` on the kernel path and on the plain path (dense
    attention, the walk's plain version); every kernel in `need` must
    have launched in the kernel path's run, none in the plain one's, and
    the greedy tokens must agree."""
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = DecodeEngine(params, cfg, **geom)
    toks, wall, launched = timed_serve(eng, prompts)
    st = eng.last_stats
    n_tok = sum(len(t) for t in toks)
    log(f"  {label} kernel path: {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} generated tokens/s; steps {st.steps}, prefix "
        f"hits {st.prefix_hits}, launches {launched}")
    missing = [k for k in need if launched[k] == 0]
    if missing:
        raise Fail(f"{label}: kernels never launched: {missing}")
    if any(len(t) != MAX_NEW for t in toks):
        raise Fail(f"{label}: a request did not emit max_new tokens")
    if any(not (0 <= x < cfg.vocab) for t in toks for x in t):
        raise Fail(f"{label}: token out of vocabulary range")
    plain = DecodeEngine(params, plain_cfg, ragged_impl="torch", **geom)
    ptoks, pwall, plaunched = timed_serve(plain, prompts)
    if any(plaunched.values()):
        raise Fail(f"{label}: the plain path launched kernels: {plaunched}")
    log(f"  {label} plain path:  {n_tok} tokens in {pwall:.3f} s = "
        f"{n_tok / pwall:.1f} generated tokens/s")
    same = check_greedy(label, toks, ptoks, prompts, params, plain_cfg)
    SERVE_REFS[label] = dict(kernel=toks, plain=ptoks, wall=wall,
                             n_prompts=len(prompts), launched=launched)
    return launched, ptoks, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, plain_wall_s=pwall, plain_tok_s=n_tok / pwall,
        same=same, steps=st.steps, prefix_hits=st.prefix_hits)


def speculative_vs_plain_decode(label, params, cfg, prompts, tqn_key):
    """serve(speculative=True) against the same engine's one-token
    decode on the same prompts: greedy tokens agree, and every verify
    round read the cache through the walk with TQ = K+1."""
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = DecodeEngine(params, cfg, **geom)
    base, bwall, _ = timed_serve(eng, prompts)
    toks, wall, launched = timed_serve(eng, prompts, speculative=True)
    st = eng.last_stats
    n_tok = sum(len(t) for t in toks)
    need = st.spec_rounds * cfg.n_layers
    log(f"  {label}: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
        f"generated tokens/s (one-token decode {n_tok / bwall:.1f}); "
        f"spec_rounds {st.spec_rounds}, draft_proposed "
        f"{st.draft_proposed}, draft_accepted {st.draft_accepted} "
        f"({st.draft_accepted / max(st.draft_proposed, 1):.3f}), "
        f"launches {launched}")
    if launched[tqn_key] < need:
        raise Fail(f"{label}: {launched[tqn_key]} {tqn_key} launches < "
                   f"{need} verify reads ({st.spec_rounds} rounds x "
                   f"{cfg.n_layers} layers)")
    if st.draft_accepted == 0:
        raise Fail(f"{label}: no draft was accepted")
    same = check_greedy(label, toks, base, prompts, params,
                        dataclasses.replace(cfg, attn_impl="dense"))
    return launched, dict(
        requests=len(prompts), tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, decode_tok_s=n_tok / bwall,
        spec_rounds=st.spec_rounds, draft_proposed=st.draft_proposed,
        draft_accepted=st.draft_accepted, same=same)


def serve_phase():
    cfg = TT.TransformerConfig(**SERVE_CFG)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    log(f"phase serve: {SERVE_CFG}, f32, slots={SLOTS} max_len={MAX_LEN} "
        f"page={PAGE}, {N_REQ} requests x {PROMPT}-token prompts "
        f"({N_REQ // 2} share a {SHARED}-token prefix), max_new={MAX_NEW}")
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    qparams = Q.quantize_params(params)
    prompts = make_prompts()
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)

    # warm the kernels and the allocator outside the measured runs
    for c, p in ((cfg, params), (cfg8, params), (cfg, qparams)):
        DecodeEngine(p, c, **geom).serve(prompts[:2], max_new=4)
        DecodeEngine(p, dataclasses.replace(c, attn_impl="dense"),
                     ragged_impl="torch", **geom).serve(prompts[:2],
                                                        max_new=4)
    DecodeEngine(params, cfg, **geom).serve(prompts[:2], max_new=4,
                                            speculative=True)

    out, launches = {}, {}
    launches["float"], ptoks, out["float_kv"] = kernel_and_plain(
        "float KV", params, cfg, prompts,
        ("flash_fwd", "ragged_tq1", "ragged_tqn", "float_device"))
    # sampled requests draw from per-slot CUDA generators: the same
    # seeds must give the same tokens
    samp = [{"temperature": 0.8, "top_k": 50, "seed": i} for i in range(4)]
    drawn = [DecodeEngine(params, cfg, **geom).serve(
        prompts[:4], max_new=16, sampling=samp) for _ in range(2)]
    if drawn[0] != drawn[1]:
        raise Fail("sampled serving is not deterministic per seed")
    log(f"  sampled serving: 4 requests, seed-deterministic, "
        f"{len({t for r in drawn[0] for t in r})} distinct tokens")
    # the engine's consistency contract, against the plain generate()
    for i in (0, 1):
        ref = TT.generate(params, plain_cfg,
                          torch.from_numpy(prompts[i])[None].cuda(),
                          MAX_NEW)[0, PROMPT:].tolist()
        if ref != ptoks[i]:
            raise Fail(f"plain engine differs from generate() on request "
                       f"{i}")

    launches["int8_kv"], _, out["int8_kv"] = kernel_and_plain(
        "int8 KV", params, cfg8, prompts,
        ("flash_fwd", "int8_tq1", "int8_tqn", "int8_device"))
    launches["int8_weights"], _, out["int8_weights"] = kernel_and_plain(
        "int8 weights", qparams, cfg, prompts[:N_WEIGHT_REQ],
        ("flash_fwd", "ragged_tq1", "ragged_tqn", "float_device"))

    spec_prompts = make_spec_prompts(N_SPEC_REQ)
    launches["spec_float"], out["spec_float_kv"] = \
        speculative_vs_plain_decode("speculative, float KV", params, cfg,
                                    spec_prompts, "ragged_tqn")
    launches["spec_int8"], out["spec_int8_kv"] = \
        speculative_vs_plain_decode("speculative, int8 KV", params, cfg8,
                                    spec_prompts, "int8_tqn")
    return launches, out


# -- the serving stack: ServingServer, ServingRouter, ring pools, the CLI -----


def serve_refs(label, params, cfg, prompts):
    """The kernel and plain paths' greedy tokens of `prompts` and the
    kernel path's wall time: serve_phase's run where it ran in this
    process, else served here."""
    ref = SERVE_REFS.get(label)
    if ref is None or ref["n_prompts"] != len(prompts):
        need = (("flash_fwd", "int8_tq1") if cfg.kv_cache_dtype == "int8"
                else ("flash_fwd", "ragged_tq1"))
        kernel_and_plain(label, params, cfg, prompts, need)
        ref = SERVE_REFS[label]
    return ref


def gap_rule(label, toks, ref, prompts, params, plain_cfg):
    """check_greedy over requests that may have stopped early (an
    expired request's partial tokens against the reference's prefix)."""
    return check_greedy(label, toks, [r[:len(t)] for t, r in zip(toks, ref)],
                        prompts, params, plain_cfg)


def need_launched(launched, cfg, label):
    need = (("flash_fwd", "int8_tq1") if cfg.kv_cache_dtype == "int8"
            else ("flash_fwd", "ragged_tq1"))
    missing = [k for k in need if launched[k] == 0]
    if missing:
        raise Fail(f"{label}: kernels never launched: {missing}")


def server_run(label, params, cfg, prompts, geom, ref, turns):
    """ServingServer over the kernel engine under a FaultPlan (one
    prefill fault, one decode fault) with two requests whose deadline
    expires mid-decode; then clean runs of the first TIMED_REQ requests
    timed against the bare engine's serve() on the same engine, in
    `turns` (bare, server, server, bare), or, with no turns, the
    faulted run's tokens/s beside serve_phase's bare run."""
    from paddle_tpu_torch.serve.server import ServingServer
    from paddle_tpu_torch.testing.faults import ManualClock

    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    eng = DecodeEngine(params, cfg, **geom)
    clk = ManualClock()
    plan = FaultPlan(serve_prefill_error_at=SERVER_PREFILL_FAULT,
                     serve_decode_error_at=SERVER_DECODE_FAULT)
    srv = ServingServer(plan.wrap_engine(eng), max_queue=64,
                        buckets=(PROMPT,), clock=clk, max_retries=2)
    srv.on_step.append(lambda _s, _i: clk.advance(STEP_MS / 1000.0))
    ids = [srv.submit(p, max_new=MAX_NEW,
                      deadline_ms=(SERVER_DEADLINE_MS
                                   if i in SERVER_DEADLINE_REQS else None))
           for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    srv.reconcile()
    need_launched(launched, cfg, label)
    outcomes = [res[r].outcome for r in ids]
    want = ["expired" if i in SERVER_DEADLINE_REQS else "completed"
            for i in range(len(prompts))]
    fired = list(plan.fired)
    if outcomes != want or fired != [f"sprefill@{SERVER_PREFILL_FAULT}",
                                     f"sdecode@{SERVER_DECODE_FAULT}"]:
        raise Fail(f"{label} server: outcomes {outcomes}, fired {fired}")
    for i in SERVER_DEADLINE_REQS:
        n = len(res[ids[i]].tokens)
        if not 0 < n < MAX_NEW or "mid-generation" not in res[ids[i]].error:
            raise Fail(f"{label} server: request {i} expired with {n} "
                       f"tokens: {res[ids[i]].error}")
    c = srv.counters()
    if c["retried"] != 1 + SLOTS:
        raise Fail(f"{label} server: retried {c['retried']}, the plan "
                   f"forces 1 prefill + {SLOTS} in-flight requeues")
    toks = [res[r].tokens for r in ids]
    same = gap_rule(f"{label} server", toks, ref["plain"], prompts, params,
                    plain_cfg)
    n_tok = sum(len(t) for t in toks)
    log(f"  {label} server under faults: {n_tok} tokens in {wall:.3f} s, "
        f"fired {fired}, launches {launched}")
    log(f"  {label} server counters: {json.dumps(c)}")
    out = dict(faulted_wall_s=wall, faulted_tokens=n_tok, fired=fired,
               outcomes={o: outcomes.count(o) for o in set(outcomes)},
               same=same, counters=c,
               faulted_tok_s=n_tok / wall,
               bare_run_tok_s=sum(map(len, ref["kernel"])) / ref["wall"])
    if not turns:
        log(f"  {label} server under faults {n_tok / wall:.1f} generated "
            f"tokens/s (recomputing {c['retried']} requeues); the bare "
            f"serve() of the {len(prompts)} requests "
            f"{out['bare_run_tok_s']:.1f}")
        return launched, out
    # the first TIMED_REQ requests without faults or deadlines, timed in
    # turns against the bare engine's serve() on the same engine
    prompts = prompts[:TIMED_REQ]
    kref, pref = ref["kernel"][:TIMED_REQ], ref["plain"][:TIMED_REQ]
    walls = {"bare": [], "server": []}
    equal = True
    for arm in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arm == "bare":
            ctoks = eng.serve(prompts, max_new=MAX_NEW, buckets=(PROMPT,))
        else:
            clean = ServingServer(eng, max_queue=64, buckets=(PROMPT,),
                                  clock=ManualClock())
            cids = [clean.submit(p, max_new=MAX_NEW) for p in prompts]
            cres = clean.run()
            ctoks = [cres[r].tokens for r in cids]
        torch.cuda.synchronize()
        walls[arm].append(time.perf_counter() - t0)
        if arm == "server":
            clean.reconcile()
        if ctoks != kref:
            equal = False
            gap_rule(f"{label} clean {arm}", ctoks, pref, prompts, params,
                     plain_cfg)
    n_clean = sum(len(t) for t in kref)
    tok_s = {a: [n_clean / w for w in ws] for a, ws in walls.items()}
    log(f"  {label} clean runs in turns {list(turns)}: server "
        f"{[round(x, 1) for x in tok_s['server']]} generated tokens/s, "
        f"bare serve() {[round(x, 1) for x in tok_s['bare']]}; server / "
        f"bare {np.mean(tok_s['server']) / np.mean(tok_s['bare']):.3f}")
    return launched, dict(
        out, timed_requests=TIMED_REQ, tok_s=tok_s["server"],
        bare_tok_s=tok_s["bare"], turns=list(turns),
        server_over_bare=float(np.mean(tok_s["server"])
                               / np.mean(tok_s["bare"])),
        clean_equal_kernel_ref=equal)


def make_router(params, cfg, n, *, roles=None, wrap=None, data_plane=None,
                policy=None):
    from paddle_tpu_torch.serve.router import ServingRouter
    from paddle_tpu_torch.serve.server import ServingServer
    from paddle_tpu_torch.testing.faults import ManualClock

    clk = ManualClock()
    roles = roles or ["unified"] * n
    servers = []
    for i, role in enumerate(roles):
        eng = DecodeEngine(params, cfg, slots=SLOTS, max_len=MAX_LEN,
                           page_size=PAGE)
        if wrap and wrap.get(i) is not None:
            eng = wrap[i](eng)
        servers.append(ServingServer(eng, role=role, max_queue=64,
                                     clock=clk, data_plane=data_plane))
    return ServingRouter(servers, clock=clk, policy=policy)


def prefill_first_policy():
    """A routing policy for the migration runs: every request goes to the
    prefill tier (the default routes a prompt whose prefix a migration
    seeded straight to that decode replica, which then serves it
    without crossing)."""
    from paddle_tpu_torch.serve.policy import SchedulerPolicy

    class PrefillFirst(SchedulerPolicy):
        def route_tiered(self, chain, affinity, prefill_cands,
                         decode_cands):
            return self.spill(prefill_cands or decode_cands)

    return PrefillFirst()


def router_run(router, prompts, label, wave=None):
    """Submit `prompts` (in waves of `wave`, each run to idle) and run;
    every request must complete. Returns (ids, results, tokens, wall
    seconds, launch counts of the run)."""
    wave = wave or len(prompts)
    ids = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(0, len(prompts), wave):
        ids += [router.submit(p, max_new=MAX_NEW)
                for p in prompts[i:i + wave]]
        res = router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    router.reconcile()
    bad = [r for r in ids if res[r].outcome != "completed"]
    if bad:
        raise Fail(f"{label}: requests not completed: "
                   f"{[(r, res[r].outcome, res[r].error) for r in bad]}")
    toks = [res[r].tokens for r in ids]
    return ids, res, toks, wall, launched


def timed_calls(server, name, acc):
    """Wrap server.<name> to add its wall time (synchronized) to acc."""
    fn = getattr(server, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)

    setattr(server, name, wrapped)


def page_bytes(cfg):
    """Bytes of one page of every layer's K and V arenas."""
    hkv, dh = cfg.kv_heads, cfg.head_dim
    per = (PAGE * hkv * dh + PAGE * hkv * 4 if cfg.kv_cache_dtype == "int8"
           else PAGE * hkv * dh * 4)
    return cfg.n_layers * 2 * per


def disagg_run(label, params, cfg, prompts, ref, *, shm, kill):
    """One prefill replica and two decode replicas: every request crosses
    by export_request/import_request (inline, or through a ShmArena data
    plane), optionally with the first import into decode replica 1
    killed mid-transfer. Requests go in waves the decode tier's free
    slots can take (16, or 8 once a decode replica is dead): a parked
    request that no decode replica can take is decoded where it was
    prefilled, and would not cross."""
    from paddle_tpu_torch.serve.shm_arena import ShmArena

    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    plan = FaultPlan(router_kill_import_at=IMPORT_KILL_AT) if kill else None
    # one request's pages at a time (the export's ticket is freed on the
    # destination's ACK): 9 pages of 512 KiB in f32
    arena = ShmArena(seg_size=1 << 20, n_segs=12) if shm else None
    try:
        router = make_router(
            params, cfg, 3, roles=["prefill", "decode", "decode"],
            data_plane=arena, policy=prefill_first_policy(),
            wrap={1: plan.wrap_replica_engine} if kill else None)
        ex, im, pages = [], [], []
        src = router.replicas[0].server
        timed_calls(src, "export_request", ex)
        export = src.export_request

        def counted(req_id):
            payload = export(req_id)
            pages.append(payload["n_pages"])
            return payload

        src.export_request = counted
        for rep in router.replicas[1:]:
            timed_calls(rep.server, "import_request", im)
        ids, res, toks, wall, launched = router_run(
            router, prompts, label, wave=SLOTS if kill else 2 * SLOTS)
        c = router.counters()
        decode_steps = sum(r.server.stats.steps
                           for r in router.replicas[1:])
    finally:
        if arena is not None:
            arena.close(destroy=True)
    tq1 = "int8_tq1" if cfg.kv_cache_dtype == "int8" else "ragged_tq1"
    if c["migrations"] != len(prompts) or c["migration_failed"]:
        raise Fail(f"{label}: {c['migrations']} migrations of "
                   f"{len(prompts)}, {c['migration_failed']} failed")
    if c["fleet_data_plane_fallbacks"]:
        raise Fail(f"{label}: {c['fleet_data_plane_fallbacks']} data-plane "
                   f"fallbacks")
    if kill and (plan.fired != [f"importkill@{IMPORT_KILL_AT}"]
                 or c["migration_retargets"] != 1
                 or c["replicas_lost"] != 1):
        raise Fail(f"{label}: import kill: fired {plan.fired}, retargets "
                   f"{c['migration_retargets']}, lost {c['replicas_lost']}")
    if src.stats.steps:
        raise Fail(f"{label}: the prefill replica decoded")
    # every decode step of the decode tier reads its imported pages
    # through the walk, one TQ=1 call per layer
    if launched[tq1] != decode_steps * cfg.n_layers:
        raise Fail(f"{label}: {launched[tq1]} {tq1} launches, the decode "
                   f"tier stepped {decode_steps} x {cfg.n_layers} layers")
    if any(res[r].replica == 0 for r in ids):
        raise Fail(f"{label}: a request finished on the prefill tier")
    equal = sum(t == k for t, k in zip(toks, ref["kernel"]))
    if equal != len(prompts):
        check_greedy(f"{label} vs unified", toks, ref["kernel"], prompts,
                     params, plain_cfg)
    moved = len(ex)
    ms_slot = 1000.0 * (sum(ex) + sum(im)) / moved
    bytes_out = sum(pages) * page_bytes(cfg)
    n_tok = sum(len(t) for t in toks)
    log(f"  {label}: {len(prompts)} migrations, {equal}/{len(prompts)} "
        f"requests bit for bit the unified replica's; "
        f"{ms_slot:.3f} ms per migrated slot (export "
        f"{1000 * sum(ex) / moved:.3f} + import {1000 * sum(im) / moved:.3f}"
        f" over {len(im)} imports), {bytes_out} bytes exported "
        f"({sum(pages)} pages); {n_tok / wall:.1f} tokens/s; launches "
        f"{launched}")
    return launched, dict(
        migrations=c["migrations"], retargets=c["migration_retargets"],
        replicas_lost=c["replicas_lost"], equal_to_unified=equal,
        ms_per_migrated_slot=ms_slot, export_ms=1000 * sum(ex) / moved,
        import_ms=1000 * sum(im) / moved, imports=len(im),
        bytes_exported=bytes_out, pages_exported=sum(pages),
        tok_s=n_tok / wall, decode_steps=decode_steps,
        fired=list(plan.fired) if plan else [])


def ring_run(params, cfg, prompts):
    """The ring pool at bench_decode's swa row: A launched with the
    window and the key bound (one prefill per request, a launch per
    layer), B and C not; greedy tokens against the plain rolling
    generate(), by the gap rule."""
    wcfg = dataclasses.replace(cfg, attn_window=RING_WINDOW)
    plain = dataclasses.replace(wcfg, attn_impl="dense")
    eng = DecodeEngine(params, wcfg, slots=SLOTS, max_len=MAX_LEN)
    eng.serve(prompts[:1], max_new=4, buckets=(PROMPT,))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = eng.serve(prompts, max_new=RING_NEW, buckets=(PROMPT,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    window_launches = launched["flash_fwd_window"]
    want = len(prompts) * cfg.n_layers
    if (launched["flash_fwd"] != want or window_launches != want
            or launched["ragged_tq1"] or launched["ragged_tqn"]
            or launched["int8_tq1"] or launched["int8_tqn"]):
        raise Fail(f"ring pool: launches {launched}, A with a window "
                   f"{window_launches}; want {want} windowed A, no B or C")
    if any(len(t) != RING_NEW for t in toks):
        raise Fail("ring pool: a request did not emit max_new tokens")
    t1 = time.perf_counter()
    ref = TT.generate(params, plain, torch.from_numpy(
        np.stack(prompts)).cuda(), RING_NEW)[:, PROMPT:].tolist()
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t1
    same = check_greedy("ring pool", toks, ref, prompts, params, plain)
    n_tok = sum(len(t) for t in toks)
    log(f"  ring pool (window {RING_WINDOW}, {len(prompts)} x {RING_NEW} "
        f"new): {n_tok / wall:.1f} generated tokens/s ({wall:.3f} s; plain "
        f"rolling generate() {n_tok / ref_wall:.1f}), launches {launched}, "
        f"A with a window {window_launches}")
    return launched, dict(
        tok_s=n_tok / wall, wall_s=wall, plain_generate_tok_s=n_tok
        / ref_wall, same=same, steps=eng.last_stats.steps)


SERVE_CONFIG = """
import numpy as np

from paddle_tpu_torch.models import transformer as TT


def get_serve_config():
    cfg = TT.TransformerConfig(**{cfg!r})
    return {{"cfg": cfg,
            "params": TT.init_params(np.random.RandomState(0), cfg,
                                     device="cuda"),
            "slots": {slots}, "max_len": {max_len}}}
"""


def cli_run(prompts, router_toks, params, plain_cfg):
    """`python -m paddle_tpu_torch serve --replicas 2 --max-queue 64
    --metrics-out` in a child process at this width: its token lines
    equal the in-process router's (the gap rule where they do not), its
    trailer counts every request completed, its metrics file parses."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "serve_cfg.py")
        with open(cfg_path, "w") as f:
            f.write(SERVE_CONFIG.format(cfg=SERVE_CFG, slots=SLOTS,
                                        max_len=MAX_LEN))
        p_path = os.path.join(tmp, "prompts.txt")
        with open(p_path, "w") as f:
            for p in prompts:
                f.write(" ".join(str(int(t)) for t in p) + "\n")
        out_path = os.path.join(tmp, "out.txt")
        m_path = os.path.join(tmp, "metrics.jsonl")
        argv = [sys.executable, "-m", "paddle_tpu_torch", "serve",
                "--config", cfg_path, "--prompts", p_path, "--replicas",
                "2", "--max-queue", "64", "--max-new", str(MAX_NEW),
                "--metrics-out", m_path, "--output", out_path]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO_DIR, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise Fail(f"cli serve: exit {proc.returncode}: "
                       f"{proc.stderr[-2000:]}")
        with open(out_path) as f:
            lines = f.read().splitlines()
        with open(m_path) as f:
            metrics = [json.loads(l) for l in f if l.strip()]
    toks = [[int(t) for t in l.split()] for l in lines[:-1]]
    trailer = lines[-1]
    if len(toks) != len(prompts) or not trailer.startswith("# outcomes "):
        raise Fail(f"cli serve: {len(lines)} output lines")
    if f"completed={len(prompts)}" not in trailer.split():
        raise Fail(f"cli serve: {trailer}")
    series = {m["name"]: m["value"] for m in metrics if "name" in m}
    if series.get("fleet_completed") != len(prompts):
        raise Fail(f"cli serve: metrics fleet_completed "
                   f"{series.get('fleet_completed')}")
    equal = sum(a == b for a, b in zip(toks, router_toks))
    if equal != len(prompts):
        check_greedy("cli serve vs in-process router", toks, router_toks,
                     prompts, params, plain_cfg)
    log(f"  cli serve --replicas 2: {equal}/{len(prompts)} lines equal the "
        f"in-process router's tokens; {len(metrics)} metrics lines; child "
        f"wall {wall:.1f} s")
    return dict(equal=equal, wall_s=wall, metrics_lines=len(metrics))


def server_phase():
    """ServingServer (float and int8 KV), ServingRouter (two replicas:
    affinity, a replica killed mid-burst, retirement; three replicas:
    prefill to decode by KV migration, float and int8, inline and over
    a ShmArena, an import killed mid-way), the ring pool at bench_decode's
    swa row, and `python -m paddle_tpu_torch serve` in a child."""
    t_phase = time.perf_counter()
    cfg = TT.TransformerConfig(**SERVE_CFG)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    log(f"phase server: {SERVE_CFG}, f32, {SLOTS} slots per replica, "
        f"max_len={MAX_LEN}, page={PAGE}, {N_REQ} requests x {PROMPT}-token "
        f"prompts, max_new={MAX_NEW}")
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    prompts = make_prompts()
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    ref = serve_refs("float KV", params, cfg, prompts)
    ref8 = serve_refs("int8 KV", params, cfg8, prompts)
    launches, out = {}, {}
    launches["server_float"], out["server_float"] = server_run(
        "float KV", params, cfg, prompts, geom, ref,
        ("bare", "server", "server", "bare"))
    launches["server_int8"], out["server_int8"] = server_run(
        "int8 KV", params, cfg8, prompts, geom, ref8, ())

    # two replicas on the card, clean: affinity, throughput
    full_prompts, prompts = prompts, prompts[:ROUTER_REQ]
    rplain = ref["plain"][:ROUTER_REQ]
    router = make_router(params, cfg, 2)
    _, res, rtoks, wall, launches["router"] = router_run(
        router, prompts, "router")
    need_launched(launches["router"], cfg, "router")
    gap_rule("router", rtoks, rplain, prompts, params, plain_cfg)
    n_tok = sum(len(t) for t in rtoks)
    one = out["server_float"]["bare_run_tok_s"]
    out["router"] = dict(
        tok_s=n_tok / wall, one_replica_tok_s=one,
        prefix_hit_rate=router.prefix_hit_rate(),
        replicas_used=sorted({r.replica for r in res.values()}),
        equal_to_unified=sum(a == b for a, b in zip(rtoks, ref["kernel"])))
    log(f"  router, 2 replicas: {n_tok / wall:.1f} generated tokens/s "
        f"against one replica's {one:.1f} (the bare serve() of the same "
        f"requests); "
        f"prefix-affinity "
        f"hit rate {router.prefix_hit_rate():.3f}; counters "
        f"{json.dumps(router.counters())}")

    # (a) replica 0 dies at its ROUTER_KILL_AT-th decode step
    plan = FaultPlan(router_kill_decode_at=ROUTER_KILL_AT)
    router = make_router(params, cfg, 2, wrap={0: plan.wrap_replica_engine})
    ids, res, ktoks, _, _ = router_run(router, prompts, "router kill")
    c = router.counters()
    moved = sum(res[r].redistributions > 0 for r in ids)
    if (plan.fired != [f"replicakill@{ROUTER_KILL_AT}"]
            or c["replicas_lost"] != 1 or not moved
            or len(router.results) != len(prompts)):
        raise Fail(f"router kill: fired {plan.fired}, counters {c}")
    gap_rule("router kill", ktoks, rplain, prompts, params, plain_cfg)
    out["router_kill"] = dict(redistributed=c["redistributed"],
                              moved=moved, replicas_lost=c["replicas_lost"])
    log(f"  router, replica 0 killed at decode step {ROUTER_KILL_AT}: "
        f"{moved} requests redistributed, every one completed once")

    # (b) replica 0 retired mid-burst: its queue moves, its slots finish
    router = make_router(params, cfg, 2)
    state = {}

    def retire(srv, step):
        if step == ROUTER_RETIRE_AT and not state:
            state["inflight"] = [r.req_id for r in srv._slot_req
                                 if r is not None]
            state["rr"] = [router.replicas[0].pending[q]
                           for q in state["inflight"]]
            state["queued"] = len(srv.queue)
            router.retire_replica(0, reason="maintenance")

    router.replicas[0].server.on_step.append(retire)
    ids, res, btoks, _, _ = router_run(router, prompts, "router retire")
    c = router.counters()
    stayed = [rr for rr in state.get("rr", []) if res[rr].replica == 0
              and res[rr].redistributions == 0]
    queued = state.get("queued", 0)
    if (len(stayed) != SLOTS or c["fleet_admitted"] != len(prompts)
            or not queued or c["redistributed"] != queued):
        raise Fail(f"router retire: in-flight finished in place "
                   f"{len(stayed)}/{SLOTS}, admitted {c['fleet_admitted']} "
                   f"for {len(prompts)} requests, redistributed "
                   f"{c['redistributed']} of {queued} queued")
    gap_rule("router retire", btoks, rplain, prompts, params, plain_cfg)
    out["router_retire"] = dict(redistributed=c["redistributed"],
                                finished_in_place=len(stayed),
                                admitted=c["fleet_admitted"])
    log(f"  router, replica 0 retired at its step {ROUTER_RETIRE_AT}: "
        f"{c['redistributed']} queued requests moved, {len(stayed)} "
        f"in-flight finished in place, {c['fleet_admitted']} prefills for "
        f"{len(prompts)} requests (nothing recomputed)")

    # (c) disaggregation: one prefill replica, two decode replicas; each
    # run (the float inline one with the import kill) takes the first
    # DISAGG_REQ requests
    for kv, c_, r_ in (("float", cfg, ref), ("int8", cfg8, ref8)):
        for shm in (False, True):
            key = f"disagg_{kv}_{'shm' if shm else 'inline'}"
            n = DISAGG_REQ
            launches[key], out[key] = disagg_run(
                key, params, c_, full_prompts[:n],
                dict(r_, kernel=r_["kernel"][:n], plain=r_["plain"][:n]),
                shm=shm, kill=(kv == "float" and not shm))

    launches["ring"], out["ring"] = ring_run(params, cfg,
                                             full_prompts[:RING_REQ])
    paged_tok_s = out["server_float"]["bare_run_tok_s"]
    log(f"  ring pool {out['ring']['tok_s']:.1f} against the paged pool's "
        f"{paged_tok_s:.1f} generated tokens/s")
    out["cli"] = cli_run(prompts[:CLI_REQ], rtoks[:CLI_REQ], params,
                         plain_cfg)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  server phase: {out['wall_s']:.1f} s")
    return launches, out


# -- serving artifacts: engine bundles, a decoder, merge-model / infer --------

# bench_image's ResNet-50 at batch 64, f32 eval, through merge-model/infer
ART_IMAGE_B = 64
# the exported decoder: bench_decode's batch and prompt; its 128 steps cut
# to 4 (the export unrolls every step: 32 took 184.5 s to export and save
# and 42.4 s to load on the card, 8 took 55.1 s and 10.0 s; PR 16)
ART_DEC_STEPS = 4
# the tampered-manifest server's eager serve after the refusal: SLOTS
# requests, their first ART_TAMPER_NEW tokens (cut from MAX_NEW)
ART_TAMPER_NEW = 16
# each bundle serves the first ART_BUNDLE_REQ requests, one wave of the
# slots (cut from N_REQ), beside an eager engine on the same requests
ART_BUNDLE_REQ = SLOTS
ART_TOL = 1e-4


class counting_programs(dict):
    """An engine's bound programs, each call counted by name."""

    def __init__(self, programs):
        super().__init__()
        self.calls = {k: 0 for k in programs}
        for k, fn in programs.items():
            def counted(*a, _k=k, _fn=fn):
                self.calls[_k] += 1
                return _fn(*a)
            self[k] = counted


def no_verify_policy():
    """The bundle engines' policy: no speculative width, so the bundle
    holds no verify programs (this phase serves greedy one-token decode,
    and saves its bundles with sampled=False; the CPU tests serve the
    verify and sampled programs)."""
    from paddle_tpu_torch.serve.policy import SchedulerPolicy

    pol = SchedulerPolicy()
    pol.spec_draft_max = 0
    return pol


def bundle_path(tmp, cfg):
    return os.path.join(tmp, f"engine_{cfg.kv_cache_dtype}.tar")


def bundle_run(label, params, cfg, prompts, geom, ref, tmp, saved):
    """Load the bundle export_artifacts saved for this engine into a
    fresh engine and serve the first ART_BUNDLE_REQ requests through it
    and through an eager engine: tokens bit for bit the eager serve's,
    no fallback, the eager serve's launches of A, B and C; cold start
    (load to first token) and tokens/s beside the eager engine's."""
    from paddle_tpu_torch.serve import artifact as ART

    path = bundle_path(tmp, cfg)
    prompts = prompts[:ART_BUNDLE_REQ]
    mk = lambda: DecodeEngine(params, cfg, policy=no_verify_policy(), **geom)
    log(f"  {label} bundle: {len(saved['programs'])} programs "
        f"{saved['programs']}, {saved['bytes']} bytes, exported and saved in "
        f"{saved['save_s']:.1f} s (per program: "
        f"{ {k: round(v, 2) for k, v in saved['export_s'].items()} })")

    def first_token(eng, bind):
        # cold start: an engine from its weights, the bundle loaded and
        # bound (or not), one request's prefill, its first token on the
        # host
        torch.cuda.synchronize()
        t = time.perf_counter()
        e = eng()
        if bind:
            progs, m = ART.load_engine_artifact(e, path,
                                                expect_buckets=(PROMPT,))
            e.bind_artifact(progs, m)
        st = e.prefill(e.init_state(), 0, prompts[0])
        tok = int(st.last_tok[0])
        return time.perf_counter() - t, tok, e

    eager_cold, eager_tok, _ = first_token(mk, False)
    cold, tok, eng = first_token(mk, True)
    if tok != eager_tok or tok != ref["kernel"][0][0]:
        raise Fail(f"{label} bundle: first token {tok}, eager {eager_tok}")
    eng._artifact = progs = counting_programs(eng._artifact)
    toks, wall, launched = timed_serve(eng, prompts, buckets=(PROMPT,))
    st = eng.last_stats
    etoks, ewall, elaunched = timed_serve(mk(), prompts)
    n_tok = sum(len(t) for t in toks)
    same = sum(a == b for a, b in zip(toks, etoks))
    log(f"  {label} bundle: {len(prompts)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} generated tokens/s (eager "
        f"{n_tok / ewall:.1f}); cold start {cold:.3f} s (eager engine "
        f"{eager_cold:.3f} s); program calls {progs.calls}; launches "
        f"{launched} (eager {elaunched}); tokens equal on "
        f"{same}/{len(toks)}")
    if same != len(toks):
        raise Fail(f"{label} bundle: tokens differ from the eager serve's "
                   f"on {len(toks) - same} requests")
    if eng.artifact_fallbacks or eng.artifact_loads != 1:
        raise Fail(f"{label} bundle: loads {eng.artifact_loads}, fallbacks "
                   f"{eng.artifact_fallbacks}")
    if progs.calls["step"] != st.steps or progs.calls[
            f"chunk_w{PROMPT}_z1_f1"] == 0:
        raise Fail(f"{label} bundle: program calls {progs.calls}, "
                   f"{st.steps} steps")
    diff = {k: (launched[k], elaunched[k]) for k in launched
            if launched[k] != elaunched[k]}
    if diff:
        raise Fail(f"{label} bundle: launches differ from the eager "
                   f"serve's: {diff}")
    return launched, dict(
        programs=saved["programs"], bundle_bytes=saved["bytes"],
        save_s=saved["save_s"], export_s=saved["export_s"],
        requests=len(prompts), cold_start_s=cold,
        eager_cold_start_s=eager_cold, wall_s=wall, tok_s=n_tok / wall,
        eager_tok_s=n_tok / ewall,
        program_calls=dict(progs.calls), steps=st.steps, same=same)


def tampered_run(params, cfg, prompts, geom, path, ref, tmp):
    """A bundle whose manifest names another PyTorch version: refused at
    boot with the field named, counted once with a flight event, and the
    server then serves the eager engine's tokens."""
    import io
    import tarfile

    from paddle_tpu_torch.obs.flight import FlightRecorder
    from paddle_tpu_torch.serve.server import ServingServer

    bad = os.path.join(tmp, "tampered.tar")
    with tarfile.open(path) as src, tarfile.open(bad, "w") as dst:
        for m in src.getmembers():
            data = src.extractfile(m).read()
            if m.name == "manifest.json":
                man = json.loads(data)
                man["torch_version"] = "0.0.0-other"
                data = json.dumps(man).encode()
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            dst.addfile(info, io.BytesIO(data))
    flight = FlightRecorder()
    eng = DecodeEngine(params, cfg, policy=no_verify_policy(), **geom)
    srv = ServingServer(eng, max_queue=64, buckets=(PROMPT,), flight=flight,
                        artifact_path=bad)
    evs = [e for e in flight.events()
           if e["kind"] == "artifact" and e["name"] == "fallback"]
    c = srv.counters()
    ids = [srv.submit(p, max_new=ART_TAMPER_NEW) for p in prompts[:SLOTS]]
    res = srv.run()
    toks = [res[i].tokens for i in ids]
    log(f"  tampered manifest: artifact_loads {c['artifact_loads']}, "
        f"artifact_fallbacks {c['artifact_fallbacks']}, flight events "
        f"{len(evs)} ({evs[0]['error'][:90] if evs else None}); "
        f"{len(toks)} requests served eagerly")
    if (c["artifact_fallbacks"] != 1 or c["artifact_loads"] != 0
            or len(evs) != 1 or "torch_version" not in evs[0]["error"]):
        raise Fail(f"tampered manifest: counters {c}, events {evs}")
    if toks != [t[:ART_TAMPER_NEW] for t in ref["kernel"][:SLOTS]]:
        raise Fail("tampered manifest: the eager serve after the refusal "
                   "differs from the eager serve's tokens")
    return dict(fallbacks=c["artifact_fallbacks"],
                error=evs[0]["error"][:200])


def decoder_prompt():
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, SERVE_CFG["vocab"], (DEC_B, DEC_PROMPT)).astype(np.int64)).cuda()


def decoder_run(tmp, saved):
    """The decoder export_artifacts saved (bench_decode's width, B=8, a
    128-token prompt, ART_DEC_STEPS steps unrolled): the loaded program's
    tokens equal the eager generate()'s, with kernel A launched once per
    layer in its prefill."""
    from paddle_tpu_torch.serve import artifact as ART

    cfg = TT.TransformerConfig(**SERVE_CFG)
    params = TT.init_params(0, cfg, device="cuda")
    prompt = decoder_prompt()
    path = os.path.join(tmp, "decoder.ptc")
    t0 = time.perf_counter()
    m = ART.load_compiled_model(path)
    load_s = time.perf_counter() - t0
    reset_counts()
    got = m.predict(prompt)
    torch.cuda.synchronize()
    a_art = FA.launch_counts["fwd"]
    reset_counts()
    want = TT.generate(params, cfg, prompt, ART_DEC_STEPS)
    torch.cuda.synchronize()
    a_eager = FA.launch_counts["fwd"]
    same = bool(torch.equal(got, want))
    log(f"  decoder: B={DEC_B} prompt {DEC_PROMPT}, {ART_DEC_STEPS} steps "
        f"(bench_decode's 128 cut), exported in {saved['export_s']:.1f} s, "
        f"{saved['bytes']} bytes, loaded in {load_s:.1f} s; tokens equal "
        f"to generate(): {same}; A launches {a_art} (eager {a_eager})")
    if not same:
        raise Fail("decoder artifact: tokens differ from generate()")
    if a_art != cfg.n_layers or a_eager != cfg.n_layers:
        raise Fail(f"decoder artifact: A launched {a_art} times (eager "
                   f"{a_eager}), not once per layer")
    return dict(steps=ART_DEC_STEPS, export_s=saved["export_s"],
                load_s=load_s, bytes=saved["bytes"], a_launches=a_art,
                eager_a_launches=a_eager)


ART_IMAGE_CONFIG = """
from paddle_tpu_torch.models import resnet
def get_config():
    return dict(model=resnet.resnet(50, num_classes=1000),
                input_spec=({b}, {hw}, {hw}, 3), name="resnet50")
"""


def image_params():
    model = image_model("resnet50")
    spec = (ART_IMAGE_B, IMAGE_HW, IMAGE_HW, 3)
    params, mstate = model.init(1, NM.ShapeSpec(spec), device="cuda")
    return model, params, mstate


def merge_model(tmp):
    """`merge-model` of ResNet-50 at bench_image's width over a
    parameters tar; returns its seconds."""
    from paddle_tpu_torch import cli as CLI

    cfg_path = os.path.join(tmp, "resnet50_cfg.py")
    with open(cfg_path, "w") as f:
        f.write(ART_IMAGE_CONFIG.format(b=ART_IMAGE_B, hw=IMAGE_HW))
    ptar = os.path.join(tmp, "params.tar")
    CK.save_parameters_tar(image_params()[1], ptar)
    t0 = time.perf_counter()
    if CLI.main(["merge-model", "--config", cfg_path, "--params", ptar,
                 "--output", os.path.join(tmp, "resnet50.ptc"),
                 "--device", "cuda"]) != 0:
        raise Fail("merge-model failed")
    return time.perf_counter() - t0


def infer_run(tmp, saved):
    """`infer` of the merged ResNet-50 on a batch of ART_IMAGE_B: the
    output against the eager forward of the same weights, f32 eval."""
    from paddle_tpu_torch import cli as CLI

    x = image_batch(ART_IMAGE_B, IMAGE_HW, 1000, "cpu")[0].numpy()
    xp = os.path.join(tmp, "x.npy")
    np.save(xp, x)
    t0 = time.perf_counter()
    if CLI.main(["infer", "--artifact", os.path.join(tmp, "resnet50.ptc"),
                 "--output-prefix", os.path.join(tmp, "out"), xp]) != 0:
        raise Fail("infer failed")
    infer_s = time.perf_counter() - t0
    got = np.load(os.path.join(tmp, "out0.npy"))
    model, params, mstate = image_params()
    with torch.no_grad():
        want = model.apply(params, mstate, torch.from_numpy(x).cuda(),
                           training=False)[0].cpu().numpy()
    err = float(np.max(np.abs(got - want)))
    log(f"  merge-model/infer resnet50 B={ART_IMAGE_B} f32 eval: merge "
        f"{saved['merge_s']:.1f} s, infer {infer_s:.1f} s, max abs error "
        f"against the eager forward {err:.3e} (tolerance {ART_TOL})")
    if not err <= ART_TOL:
        raise Fail(f"merge-model/infer: error {err:.3e} > {ART_TOL}")
    return dict(batch=ART_IMAGE_B, merge_s=saved["merge_s"],
                infer_s=infer_s, max_abs_err=err)


def export_artifacts(tmp):
    """Write every artifact the artifact phase loads into `tmp`: the
    float-KV and int8-KV engine bundles (buckets (PROMPT,), no verify or
    sampled programs), the decoder and the merged ResNet-50; their
    seconds and sizes go to `tmp`/exports.json. The export traces in
    Python on the host (no kernel launches), so main() runs it in a
    child process beside the serving phases (`ArtifactExports`)."""
    from paddle_tpu_torch.serve import artifact as ART

    cfg = TT.TransformerConfig(**SERVE_CFG)
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    out = {}
    for c in (cfg, dataclasses.replace(cfg, kv_cache_dtype="int8")):
        path = bundle_path(tmp, c)
        t0 = time.perf_counter()
        man = ART.save_engine_artifact(
            DecodeEngine(params, c, policy=no_verify_policy(), **geom), path,
            buckets=(PROMPT,), sampled=False)
        out[c.kv_cache_dtype] = dict(
            programs=man["programs"], export_s=man["export_s"],
            save_s=time.perf_counter() - t0, bytes=os.path.getsize(path))
    dec = os.path.join(tmp, "decoder.ptc")
    meta = ART.export_decoder(TT.init_params(0, cfg, device="cuda"), cfg, dec,
                              batch=DEC_B, prompt_len=DEC_PROMPT,
                              steps=ART_DEC_STEPS)
    out["decoder"] = dict(export_s=meta["export_s"],
                          bytes=os.path.getsize(dec))
    out["merge_s"] = merge_model(tmp)
    with open(os.path.join(tmp, "exports.json"), "w") as f:
        json.dump(out, f)


class ArtifactExports:
    """export_artifacts(tmp) in a child process, started beside the
    serving phases and joined by the artifact phase; stopped (killed) on
    exit if still running."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.log = open(os.path.join(tmp, "exports.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as S; "
             f"S.export_artifacts({tmp!r})"],
            cwd=REPO_DIR, stdout=self.log, stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()

    def join(self):
        """The exports' seconds and sizes, once the child is done."""
        t = time.perf_counter()
        rc = self.proc.wait()
        self.log.seek(0)
        tail = self.log.read()[-4000:]
        log(f"  exports (child process): done {t - self.t0:.1f} s after "
            f"its start, waited {time.perf_counter() - t:.1f} s, rc {rc}")
        if rc != 0:
            raise Fail(f"export_artifacts failed (rc {rc}):\n{tail}")
        with open(os.path.join(self.tmp, "exports.json")) as f:
            return json.load(f)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def artifact_phase(exports=None):
    """Serving artifacts on the card: engine bundles at the serving width
    (float and int8 KV) against serve_phase's eager serves, a tampered
    manifest, a decoder at bench_decode's width, merge-model/infer of
    ResNet-50. `exports`: the ArtifactExports main() started; alone, the
    phase exports in its own process first."""
    t_phase = time.perf_counter()
    cfg = TT.TransformerConfig(**SERVE_CFG)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    log(f"phase artifact: {SERVE_CFG}, f32, slots={SLOTS} max_len={MAX_LEN} "
        f"page={PAGE}, bundles serve {ART_BUNDLE_REQ} requests, buckets "
        f"({PROMPT},)")
    params = TT.init_params(np.random.RandomState(0), cfg, device="cuda")
    prompts = make_prompts()
    geom = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as own:
        if exports is None:
            export_artifacts(own)
            with open(os.path.join(own, "exports.json")) as f:
                saved, tmp = json.load(f), own
        else:
            saved, tmp = exports.join(), exports.tmp
        ref = serve_refs("float KV", params, cfg, prompts)
        launches["float"], out["float_kv"] = bundle_run(
            "float KV", params, cfg, prompts, geom, ref, tmp,
            saved["compute"])
        out["tampered"] = tampered_run(params, cfg, prompts, geom,
                                       bundle_path(tmp, cfg), ref, tmp)
        ref8 = serve_refs("int8 KV", params, cfg8, prompts)
        launches["int8_kv"], out["int8_kv"] = bundle_run(
            "int8 KV", params, cfg8, prompts, geom, ref8, tmp,
            saved["int8"])
        out["decoder"] = decoder_run(tmp, saved["decoder"])
        out["merge_infer"] = infer_run(tmp, saved)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  artifact phase: {out['phase_s']:.1f} s")
    return launches, out


#: each phase's wall seconds, in the order they ran (`run_phase`)
PHASE_S = {}


def run_phase(name, fn, *args):
    """fn(*args), its wall seconds logged as it ends and kept in
    PHASE_S[name]."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name} done: {PHASE_S[name]:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    log("phase build")
    t0 = time.perf_counter()
    def native_build():
        try:
            build_native()
        except Exception as e:      # raised below, after the join
            NATIVE_BUILD["error"] = repr(e)

    native_thread = threading.Thread(target=native_build)
    native_thread.start()
    try:
        built = _cuda.build_all()
    finally:
        native_thread.join()
    if "lib" not in NATIVE_BUILD:
        raise Fail(f"the native library (g++) did not build: "
                   f"{NATIVE_BUILD.get('error')}")
    PHASE_S["build"] = time.perf_counter() - t0
    log(f"  native library built in {NATIVE_BUILD['s']:.1f} s beside nvcc")
    log(f"  built {sorted(built) or 'nothing (cached)'} in "
        f"{PHASE_S['build']:.1f} s")
    for name in _cuda.SOURCES:
        for line in _cuda.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    hmma = run_phase("hmma", flash_hmma_counts)
    walk_res = run_phase("walk_resources", walk_resources_check)
    a, b, c = run_phase("kernels", kernels_phase)
    lstm = run_phase("lstm_kernels", lstm_kernels_phase)
    gru, rnn = run_phase("gru_rnn_kernels", gru_rnn_kernels_phase)
    wide = run_phase("wide", wide_phase)
    # the artifact phase's exports trace on the host in a child process
    # while the serving phases run (they launch no kernel)
    art_tmp = tempfile.TemporaryDirectory()
    exports = ArtifactExports(art_tmp.name)
    try:
        launched, serve = run_phase("serve", serve_phase)
        server_launched, server = run_phase("server", server_phase)
        art_launched, art = run_phase("artifact", artifact_phase, exports)
    finally:
        exports.stop()
        art_tmp.cleanup()
    train = run_phase("train", train_phase)
    resilient = run_phase("resilient", resilient_phase)
    ragged = run_phase("ragged", ragged_phase)
    s2s, trained, batch0 = run_phase("seq2seq", seq2seq_phase)
    gen = run_phase("generation", generation_phase, trained, batch0)
    srnn = run_phase("simple_rnn", simple_rnn_phase)
    family = run_phase("rnn_family", rnn_family_phase)
    pctr = run_phase("pserver_ctr", pserver_ctr_phase)
    fleet = run_phase("fleet", fleet_phase)
    zoo = run_phase("zoo", zoo_phase)
    lm = run_phase("lm_train", lm_train_phase)
    dist_out = run_phase("distributed", distributed_phase)
    sparse = run_phase("sparse_elastic", sparse_elastic_phase)
    dec = run_phase("decode", decode_phase)
    moe_out = run_phase("moe", moe_phase)
    image = run_phase("image", image_phase)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else "nvidia-smi: no output")

    def entry(name, source, replaces, launches, case, **extra):
        # the time loops' (D-I) tolerance holds rel_err: dW sums T*B terms
        held = "rel_err" if "rel_err" in extra else "max_abs_err"
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, **extra,
                "max_abs_err": case["err"], "tolerance": case["tol"],
                "tolerance_holds": held,
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    def redesigned(case, calls, device):
        # E, G and I: the device launches of the main path's run (counted by
        # the wrapper as it launches each phase) and per call, the phase
        # split, and whether a second call repeated every output bit for
        # bit
        return {"device_launches": device,
                "device_launches_per_call": device / calls,
                "phases_ms": case["phases_ms"], "bitwise": case["bitwise"]}

    def resilient_launches(res, kern):
        # D and E in the resilient phase: the launches of each CLI child
        # (printed as it exits) and of the in-process ResilientTrainer run,
        # each counted from 0 in its process or before the run
        i = 0 if kern == "D" else 1
        run = res["times"]["ResilientTrainer.run"]
        return {"resilient_cli_launches": {k: v[i] for k, v in
                                           res["cli"]["launches"].items()},
                "resilient_run_launches": run["launches_in_run"][kern]}

    def family_launches(kern):
        # D and E in the rnn_family phase: each model's launches in its
        # training run (1 + FAMILY_STEPS steps, counted from 0 before it),
        # per step, and the kernel's case at the SRL and quick_start
        # shapes beside cuDNN
        case = lambda c: {f: c[kern][f] for f in (
            "name", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "rel_err")}
        return {**{f"{m}_launches": family[m]["launches"][kern]
                   for m in ("srl", "db_lstm", "bidi_lstm")},
                **{f"{m}_launches_per_step":
                   family[m]["launches_per_step"][kern]
                   for m in ("srl", "db_lstm", "bidi_lstm")},
                "srl_shape": case(family["cases"]["srl"]),
                "quick_start_shape": case(family["cases"]["quick_start"])}

    def server_launches(*keys):
        # launches of each run of the server phase, counted from 0
        # before it
        return {"server_phase_launches": {
            run: {k: n[k] for k in keys} for run, n in
            server_launched.items()}}

    def artifact_launches(*keys):
        # launches of the artifact phase's bundle serves (float and int8
        # KV), counted from 0 before each: equal to the eager serve's
        return {"artifact_launches": {
            run: {k: n[k] for k in keys} for run, n in
            art_launched.items()}}

    def split_plan(case, serve, kind):
        # the walk's device launches in that serve's run, per call at the
        # case's shape, its plan, and whether it repeated bit for bit
        return {"device_launches_in_serve": launched[serve][kind],
                "device_launches_per_call": case["device_launches_per_call"],
                "splits": case["splits"], "span_keys": case["span_keys"],
                "blocks": case["blocks"], "bitwise": case["bitwise"],
                "resources": {k: v for k, v in walk_res.items()
                              if k.startswith("C" if kind == "int8_device"
                                              else "B")}}

    # launches: A and B from the float serve, C from the int8-KV serve,
    # each counted from 0 just before that run
    walk = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    kernels = [
        entry("flash_attention_fwd",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/flash_attention.py:45",
              launched["float"]["flash_fwd"], a["main_prefill_t128"],
              hmma_per_instantiation=hmma,
              **server_launches("flash_fwd", "flash_fwd_window"),
              **artifact_launches("flash_fwd"),
              decoder_artifact_launches=art["decoder"]["a_launches"],
              # the LM train phase's three full-width variants, counted
              # from 0 before each (a forward and a remat recompute per
              # layer per step)
              lm_train_launches=lm["a_launches"],
              lm_train_launches_per_step=lm["a_launches_per_step"],
              # the decode phase's prefills (each mode counted from 0
              # before its kernel-path call) and the MoE LM's steps and
              # serves
              decode_launches={k: v["a_launches"] for k, v in dec.items()
                               if k != "wall_s"},
              # the fleet phase's replica processes (each child's count
              # from its transport's last state block, summed)
              fleet_launches=fleet["launches"]["flash_fwd"],
              moe_train_launches={k: moe_out[k]["a_launches"]
                                  for k in ("topk", "expert_choice")},
              moe_train_launches_per_step=moe_out["topk"][
                  "a_launches_per_step"],
              moe_serve_launches={k: v["flash_fwd"] for k, v in
                                  moe_out["serve_launches"].items()},
              # the distributed phase: the sharded and ZeRO LM steps at
              # world size 1 (1 + DIST_STEPS steps each, counted from 0 before
              # each), TP generate's prefill, and rank 0 of each
              # two-rank gloo path (1 + 1 steps on 2 of the 4 rows)
              distributed_launches={
                  "sharded_step": dist_out["lm"]["sharded"]["a_launches"],
                  "zero_step": dist_out["lm"]["zero"]["zero_update"][
                      "a_launches"],
                  "zero_oracle_step": dist_out["lm"]["zero"]["oracle"][
                      "a_launches"],
                  "tp_generate": dist_out["tp_generate"]["a_launches"],
                  **{f"gloo_{p}_rank0": dist_out["gloo"][p]["a_launches"]
                     for p in gloo_paths()}},
              distributed_launches_per_step=dist_out["lm"]["sharded"][
                  "a_launches_per_step"],
              # the sparse_elastic phase: rank 0's two-rank ZeRO LM step
              # (saved for the elastic restore), and the two steps at
              # world size 1 from the resharded and the unresharded state
              sparse_elastic_launches={
                  "zero_save_rank0": sparse["zero_save"]["zero_a_launches"],
                  "restored_steps": sparse["elastic_restore"]["a_launches"],
                  "tp_pool": {kv: sparse["tp_pool"][kv]["launches"][
                      "flash_fwd"] for kv in ("compute", "int8")}},
              other_shapes={k: {f: a[k][f] for f in (
                  "ms", "library_ms", "bound_ms", "err", "row_rel_err",
                  "library_err") if f in a[k]} for k in (
                  "causal_t2048_float32", "causal_t2048_bfloat16",
                  "causal_t8192_bf16", "causal_t8192_f32",
                  "window1024_t8192_f32", "window1024_t8192_bf16",
                  "hd128_float32",
                  "hd128_bfloat16",
                  "scaled_scores_float32", "window128_lens_float32",
                  "window128_lens_bfloat16")}),
        # B and C: calls of the float and int8-KV serves' runs; their
        # device launches in those runs (the split walk, and the combine
        # where the plan has several splits), per call at the case's
        # shape, and the plan
        entry("ragged_paged_walk[tq=1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["float"]["ragged_tq1"], b["main_decode"],
              **split_plan(b["main_decode"], "float", "float_device"),
              fleet_launches=fleet["launches"]["ragged_tq1"],
              **server_launches("ragged_tq1", "ragged_tqn",
                                "float_device"),
              **artifact_launches("ragged_tq1", "ragged_tqn",
                                  "float_device"),
              moe_serve_launches={k: moe_out["serve_launches"]["float KV"][k]
                                  for k in ("ragged_tq1", "ragged_tqn",
                                            "float_device")},
              # the TP engine pool (through B's DTensor rule), float KV
              tp_pool_launches={k: sparse["tp_pool"]["compute"]["launches"][k]
                                for k in ("ragged_tq1", "ragged_tqn",
                                          "float_device")}),
        entry("ragged_paged_walk[tq>1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:153",
              launched["float"]["ragged_tqn"], b["main_chunk"],
              fleet_launches=fleet["launches"]["ragged_tqn"],
              **split_plan(b["main_chunk"], "float", "float_device")),
        entry("ragged_paged_walk_int8[tq=1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:188",
              launched["int8_kv"]["int8_tq1"], c["main_decode"],
              **split_plan(c["main_decode"], "int8_kv", "int8_device"),
              fleet_launches=fleet["launches"]["int8_tq1"],
              **server_launches("int8_tq1", "int8_tqn", "int8_device"),
              **artifact_launches("int8_tq1", "int8_tqn", "int8_device"),
              moe_serve_launches={k: moe_out["serve_launches"]["int8 KV"][k]
                                  for k in ("int8_tq1", "int8_tqn",
                                            "int8_device")},
              # the TP engine pool (through C's DTensor rule), int8 KV
              tp_pool_launches={k: sparse["tp_pool"]["int8"]["launches"][k]
                                for k in ("int8_tq1", "int8_tqn",
                                          "int8_device")}),
        entry("ragged_paged_walk_int8[tq>1]", walk,
              "paddle_tpu/ops/ragged_paged_attention.py:188",
              launched["int8_kv"]["int8_tqn"], c["main_chunk"],
              fleet_launches=fleet["launches"]["int8_tqn"],
              **split_plan(c["main_chunk"], "int8_kv", "int8_device")),
        # D and E: launches of the train phase's run (2 of each per step)
        # (their tolerance holds rel_err, max abs error over max |plain|)
        entry("lstm_fwd", "paddle_tpu_torch/csrc/fused_lstm.cu",
              "paddle_tpu/ops/pallas_lstm.py:58", train["launches"]["D"],
              lstm["main"]["D"],
              launches_per_train_step=train["launches"]["D"] / TRAIN_STEPS,
              rel_err=lstm["main"]["D"]["rel_err"],
              device_launches=train["device_launches"]["D"],
              device_launches_per_call=(train["device_launches"]["D"]
                                        / train["launches"]["D"]),
              us_per_step=lstm["main"]["D"]["us_per_step"],
              bitwise=lstm["main"]["D"]["bitwise"],
              **resilient_launches(resilient, "D"), **family_launches("D"),
              # the elastic gang's members (each process's count, summed)
              gang_member_launches=sparse["gang"]["d_launches"]),
        entry("lstm_bwd", "paddle_tpu_torch/csrc/fused_lstm.cu",
              "paddle_tpu/ops/pallas_lstm.py:86", train["launches"]["E"],
              lstm["main"]["E"],
              launches_per_train_step=train["launches"]["E"] / TRAIN_STEPS,
              rel_err=lstm["main"]["E"]["rel_err"],
              **redesigned(lstm["main"]["E"], train["launches"]["E"],
                           train["device_launches"]["E"]),
              **resilient_launches(resilient, "E"), **family_launches("E"),
              gang_member_launches=sparse["gang"]["e_launches"]),
        # F and G: launches of the seq2seq phase's run (2 of each per
        # step); H and I: of the simple_rnn phase's forward and backward
        entry("gru_fwd", "paddle_tpu_torch/csrc/fused_gru.cu",
              "paddle_tpu/ops/pallas_gru.py:37", s2s["launches"]["F"],
              gru["main"]["F"],
              launches_per_train_step=s2s["launches"]["F"] / TRAIN_STEPS,
              rel_err=gru["main"]["F"]["rel_err"],
              device_launches=s2s["device_launches"]["F"],
              device_launches_per_call=(s2s["device_launches"]["F"]
                                        / s2s["launches"]["F"]),
              bitwise=gru["main"]["F"]["bitwise"]),
        entry("gru_bwd", "paddle_tpu_torch/csrc/fused_gru.cu",
              "paddle_tpu/ops/pallas_gru.py:59", s2s["launches"]["G"],
              gru["main"]["G"],
              launches_per_train_step=s2s["launches"]["G"] / TRAIN_STEPS,
              rel_err=gru["main"]["G"]["rel_err"],
              **redesigned(gru["main"]["G"], s2s["launches"]["G"],
                           s2s["device_launches"]["G"])),
        entry("rnn_fwd", "paddle_tpu_torch/csrc/fused_rnn.cu",
              "paddle_tpu/ops/pallas_rnn.py:26", srnn["launches"]["H"],
              rnn["main"]["H"], launches_per_train_step=srnn["launches"]["H"],
              rel_err=rnn["main"]["H"]["rel_err"],
              device_launches=srnn["device_launches"]["H"],
              device_launches_per_call=(srnn["device_launches"]["H"]
                                        / srnn["launches"]["H"]),
              us_per_step=rnn["main"]["H"]["us_per_step"],
              bitwise=rnn["main"]["H"]["bitwise"]),
        entry("rnn_bwd", "paddle_tpu_torch/csrc/fused_rnn.cu",
              "paddle_tpu/ops/pallas_rnn.py:44", srnn["launches"]["I"],
              rnn["main"]["I"], launches_per_train_step=srnn["launches"]["I"],
              rel_err=rnn["main"]["I"]["rel_err"],
              **redesigned(rnn["main"]["I"], srnn["launches"]["I"],
                           srnn["device_launches"]["I"])),
    ]
    # the kernel-free phases: each kernel's launches there (B and C summed
    # over their two entries each), which the phases held at 0
    for kern, letter in zip(kernels, "ABBCCDEFGHI"):
        kern["pserver_ctr_launches"] = pctr["launches"][letter]
        kern["zoo_launches"] = zoo["launches"][letter]
    log(json.dumps({"launches": launched}))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"server": server, "server_launches": server_launched,
                    "card": smi.stdout.strip()}))
    log(json.dumps({"artifact": art, "artifact_launches": art_launched,
                    "card": smi.stdout.strip()}))
    log(json.dumps({"train": train, "ragged": ragged}))
    log(json.dumps({"resilient": resilient}))
    log(json.dumps({"seq2seq": s2s, "generation": gen,
                    "simple_rnn": srnn}))
    log(json.dumps({"wide_cases": wide}))
    log(json.dumps({"rnn_family": family, "card": smi.stdout.strip()}))
    log(json.dumps({"lm_train": lm, "card": smi.stdout.strip()}))
    log(json.dumps({"distributed": dist_out, "card": smi.stdout.strip()},
                   default=str))
    log(json.dumps({"decode": dec, "moe": moe_out,
                    "card": smi.stdout.strip()}))
    log(json.dumps({"image": image, "card": smi.stdout.strip()}))
    log(json.dumps({"sparse_elastic": sparse, "card": smi.stdout.strip()},
                   default=str))
    log(json.dumps({"pserver_ctr": pctr, "card": smi.stdout.strip()},
                   default=str))
    log(json.dumps({"fleet": fleet, "card": smi.stdout.strip()},
                   default=str))
    log(json.dumps({"zoo": zoo, "card": smi.stdout.strip()}))
    PHASE_S["total"] = time.perf_counter() - t_main
    log(json.dumps({"phase_seconds": PHASE_S}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Fail as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
