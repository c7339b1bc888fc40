#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # + device time by kernel group in
                                     #   phases 3, 3b, 4, 6, 7, 8, 9, c1, d4,
                                     #   e1, e2 (+ grouped conv share), g2,
                                     #   o1, o2 (+ layout transposes)
    python3 chip_smoke.py --phases 28   # build + chosen phases (any of
                                        #   23456789abcdefghijklmno), no result line

Phases, in order; any failure exits non-zero without the result line:

0. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 is switched off for matmuls and cuDNN so the
   float32 slices are comparable to the CPU parity tests.
1. build: every ``paddle_tpu_torch/kernels/csrc/*.cu`` with nvcc.
2. kernels against their plain PyTorch versions, float32 and bfloat16,
   at the shapes the serving and training paths give them and on edge
   cases; times (CUDA events, median of 21 runs) of the kernel, the
   plain version and one PyTorch library call computing the same
   function, beside the least time the card could take (``bound_ms``).
   Layer norm (K1, K3) also at the two_lane decode's [8, 2048] and
   BERT-large's [4096, 1024], on rows that are not whole 16-byte vectors
   (C = 1, 33, 2050), C = 32768 and an input 4 bytes off its alignment
   (equal to its aligned copy bit for bit); two calls give the same bits
   and a row alone equals its row of the batch; K1's rows print the
   empty launch's time beside them. Its training and BERT rows (K1
   with the stats, K3) are timed over rotating copies of their inputs,
   so that no call finds them in L2, as a training step does not.
   Flash attention (K6-K9) at the gpt3_1p3b and BERT-large shapes, at
   S = 4096, S = 1000, with a fully masked row and with the four bias
   shapes (dbias checked too); SDPA is its yardstick; two backwards must
   give the same bits. The quantized serving kernels at the serving
   step's 128 rows: K11 (int8, int8_block at block 256, fp8) on qkv,
   ffn2, the head and a K of 2000, and its FMA kernel (int8_block at
   block 100) on qkv; the rows of each 128-row call must equal the same
   rows at M = 1 and M = 37 bit for bit. The K11 and flash-backward rows
   print their earlier designs' times (PERF.md) beside the new ones, and
   every bound names the rate it assumes (RATE_NAMES);
   K2q at phase 3's ragged shape over int8 pages; K2 and K2q also at
   that shape with speculative verify rows (7 queries a row starting at
   offsets 10-13 of a page of 16, so that each row crosses into the next
   page); K12 at gpt3_1p3b's
   five LoRA targets (qkv, proj, ffn1, ffn2, the head) with rank buckets
   8 and 16 and a mixed slot vector, on rotated inputs, with the
   wrapper's host time a call; two calls and each lane alone must give
   the batch's bits. K10m (fused
   momentum) bit for bit at [512, 512, 3, 3] and [2048, 1000], float32
   and bfloat16, plain and nesterov, with and without a clip scale;
   K13 (paged decode attention) at the two_lane decode shape and on
   edge cases (length 0, 1, 37, a full table; GQA 4 of 16 heads).
3. serving: ``GPTConfig.gpt3_1p3b()`` at full width (seeded random
   weights made on the card) served by the ragged ``GenerationEngine``
   at its default geometry; 16 requests from 4 client threads. Every
   stream must finish with its 32 tokens and no error; the launch
   counters must show 24 ragged attention and 49 layer-norm launches per
   engine step; two requests are checked token by token against the
   ``Predictor`` (teacher forced). The engine's step is a CUDA graph
   (``runtime/graphs.py``), captured once and replayed once an engine
   step (``graph_replays``); a replay runs no Python, so it adds the
   launches its graph holds to the kernels' counters (the graph's
   kernel nodes counted by name at capture, which must equal what the
   wrappers counted while it was captured), and the exact checks read
   them. Then ten requests of 3..14 new tokens (rows
   join and leave) are recorded step by step, and every recorded step
   is replayed against the eager step on cloned pools: tokens, pools
   (page 0 slot 0 left out) and scale planes equal bit for bit.
   3b: the same weights and prompts served by the two_lane engine
   (``mode="two_lane"``, prefill buckets 16..1024): every stream
   finishes, the oracle holds for two requests, each decode step
   launches 24 K13 and 49 K1 and no K2; the share of tokens equal to
   phase 3's is printed, not gated. The decode step is graphed and
   checked against its eager call as in phase 3; the prefill is eager.
4. training: ``build_gpt_lm(GPTConfig.gpt3_1p3b(), 1024,
   AdamOptimizer(3e-4))`` (24 layers, hidden 2048, dropout 0.1) run by
   the port's ``Executor`` on the card: the startup program, then 10
   steps on one ``synthetic_lm_batch`` of 2 x 1024 tokens; then 5 steps
   with ``use_flash_attention=True``. Losses must be finite and the
   last below the first; every step must launch K1 = K3 = 49,
   K4 = K5 = 1 and K10 = 294 times, and with flash 24 forward and 24
   backward flash launches (each of the backward's 3 kernels 24 times).
   Prints the mean step ms, training tokens/s and peak memory.
5. card against CPU: 2-layer models at full width from the same
   numpy-seeded parameters (``io.load_scope_arrays``), 2 fused-Adam
   steps on CUDA (kernels) and on the CPU (plain versions): GPT
   (op-graph and flash, float32; losses within rtol 1e-3) and BERT
   (flash, bfloat16 AMP; rtol 2e-3), parameters within 2 * lr per step.
   Then one ragged step of a 2-layer full-width GPT with int8 weights,
   int8 KV pages and two adapters on a mixed batch: tokens equal, pools
   within one int8 step. ResNet-50 at full depth and width, batch 4 x
   224^2, 3 fused Momentum + L2Decay steps at lr 0.1 x 4 / 256: the
   first loss within rtol 1e-3, the BN running statistics it wrote
   within 1e-3 of their largest entry, every parameter after the first
   update within 2 * lr (the later losses are reported beside a CPU run
   with the input scaled by 1 + 1e-7: ResNet-50's gradients at
   initialisation are ill-conditioned); the two-bottleneck ResNet of
   the CPU parity tests under bfloat16 AMP, one Adam step (first loss
   within rtol 2e-3, parameters within 2 * lr); a 2-layer
   gpt3_1p3b-width two_lane prefill and 3 decode steps (tokens equal,
   pools within 1e-5); a 2-layer gpt3_1p3b-width GPT whose both FFNs are
   2-expert switch-MoE layers, one step of LookaheadOptimizer(fused Adam,
   alpha 0.5, k 1: the slow weights sync on it) with an
   ExponentialMovingAverage (routing identical, the smallest top-2
   probability gap printed; losses within
   rtol 1e-3; every persistable and apply()'s values within 2 * lr *
   steps; apply() restores the parameters); a While / Switch / cond
   program with a tensor array (card equals CPU); LeNet under the
   QuantizationTransformPass, 3 fused-Adam steps (losses and every
   persistable within rtol 2e-4 / atol 2e-5, the CPU parity tests'
   training tolerance); one Program over a batch of 64 that runs the 19
   new unary ops and gelu through ``fc(act=...)``, the reduce family and
   the tensor ops (every output and x@GRAD within the same tolerance);
   the CI-sized SE-ResNeXt, 2 fused Momentum + L2Decay steps (the same).
6. BERT-large pretraining: ``BertConfig.large()`` at full size, seq 512,
   batch 8 of ``synthetic_batch(min_len=128)``, flash attention with the
   key mask, ``decorate(AdamOptimizer(1e-4), init_loss_scaling=1.0,
   use_dynamic_loss_scaling=False, dest_dtype="bfloat16")``, fused Adam,
   10 steps with exact launches every step; mean step, tokens/s, peak.
7. quantized, multi-adapter serving: gpt3_1p3b with phase 3's weights
   and prompts, quantized at load. 7a: int8 (16 requests), int8_block
   and fp8 (4 each) over float32 pages, and int8_block at block 100 (2
   requests, K11's FMA kernel), teacher-forced oracle, matmul weight
   bytes <= 0.30 of float32. 7b: int8 weights, int8 KV pages, an
   AdapterStore with rank buckets 8 and 16 and four adapters; 12 of the
   16 requests name one; exact K11, K2q, K1 and K12 launches a step,
   the int8 pool at 67584 / 262144 of the float32 one. 7c: the base
   rows equal an engine without adapters, one request of each bucket
   equals a dedicated engine. Every engine replays its graph once a
   step; 7a int8 and 7b check the replays against eager steps.
8. ResNet-50 training: ``build_resnet50(1000, 224,
   MomentumOptimizer(0.025, momentum=0.9, regularization=L2Decay(1e-4)),
   data_format="NCHW")`` (161 parameters, 25.56 M) on the JAX bench's
   batch of 64 synthetic images, float32, fused updates: startup, then
   10 steps; losses finite and falling, exactly 161 K10m, one K4 and one
   K5 launch a step, the BN running statistics move; mean step, images/s,
   peak memory.
9. ResNet-50 under bfloat16 AMP, the JAX bench's own configuration
   (``bench.py:120``, :248-250): batch 64 x 224^2 NCHW, ``decorate(
   AdamOptimizer(1e-4), init_loss_scaling=1.0,
   use_dynamic_loss_scaling=False, dest_dtype="bfloat16")``, fused Adam,
   10 steps: 853 ops (158 casts), losses finite and falling, exactly
   161 K10, one K4 and one K5 launch a step; mean step, images/s, peak
   memory beside phase 8's.
a. speculative decoding and the radix prefix cache: gpt3_1p3b with
   phase 3's weights. Spec: the first 4 of phase 3's 16 prompts (32 new
   tokens, 4
   client threads) with ``spec_tokens=6`` (the JAX bench's ``--spec``)
   and a full-replica ``HostDraft``, a 2-layer one and a draft that
   always proposes token 1: every stream passes the teacher-forced
   oracle, drafts were proposed (the replica's acceptance > 0.5), the
   graph replays once a step with exact K1 / K2 launches (the draft runs
   eagerly outside it, on the card, over the predictor's own tensors),
   and the replica's recorded steps equal their eager steps bit for bit.
   The tokens are held to the spec-off run (phase 3's): the identical
   streams are counted, and a stream that differs must first differ
   where the teacher-forced top-2 gap is within 1e-3 of max|logit|.
   Prints tokens/s, step ms, TTFT, ITL, the draft's ms a propose,
   acceptance and accepted tokens a spec round. Radix: a seed request
   publishes a 512-token prefix (32 pages); 16 prompts of it plus 8-64
   distinct tokens are served warm (``prefix_cache=True``) and cold,
   over float32 pages and int8 ones (K2q): warm tokens equal cold ones,
   at least 15 x 512 prefix tokens hit, ``check_integrity`` holds, and
   after ``drop_trie`` no page is in use. Prints the hit rate, each
   request's TTFT from its own submit (p50 of all and of the first 8
   submitted) and the peak shared and private pages, sampled in an
   untimed second serve of the same requests (same tokens required).
b. saving and serving Programs over HTTP (``serving.ServingServer`` on
   127.0.0.1, a free port). b1: ``build_resnet50(1000, 224)`` cloned for
   test, saved by ``io.save_inference_model`` with its softmax as the
   fetch, loaded by ``create_predictor`` with batch buckets 1..32 and
   served by a ``ServingEngine`` (batches of up to 32 rows, 2 worker
   clones): 16 seeded requests of 1-4 images from 8 client threads, over
   ``/v1/predict`` (JSON nested lists) and in process; every request's
   softmax within 1e-4 of its solo run on the card, two solo runs within
   1e-4 of the CPU's; requests/s, images/s, client latency p50 / p99,
   mean batch rows, padding waste and the bucket hits. b2:
   ``build_lm_program(gpt3_1p3b, 128)`` at 6 of its 24 layers, saved
   as npz, loaded and run as a Program on the card: 2L + 1 = 13 K1
   launches a run, logits within 1e-3 max|logit| of the predictor's
   module over the same tensors; the same directory quantized at load
   (int8): 4L + 1 = 25 K11 launches a run, matmul bytes <= 0.30 of float32, logits held to the
   quantized module likewise. b3: phase 3's engine (its weights and
   geometry, graphed) behind ``/v1/generate``: phase 3's 16 prompts
   streamed as NDJSON from 4 client threads, every stream's tokens
   equal to the same engine's in process and to phase 3's, token for
   token, the first line before the done line; ``stream=false``, a 400
   and a 504 by deadline; tokens/s, client TTFT p50 beside the engine's,
   step ms beside phase 3's. b4: phase 7b's engine (int8 weights and KV
   pages, an AdapterStore): a rank-8 adapter on every layer's proj
   uploaded through ``/v1/admin/adapters`` and the same factors in
   process: slot rows equal bit for bit, tokens equal; 404 for an unknown
   adapter; evict 409 while pinned, 200 after. Then ``swap_base`` of
   every layer's qkv weight (perturbed from a seeded generator) on the
   float32 engine and on the int8 one under live HTTP traffic: no request
   fails, the same graph (no recapture), ``model_swaps == 1``; after the
   swap the tokens equal fresh engines' built on the new weights
   (quantized the same way), and differ from before it. Every engine is
   built, and its graph captured, before any server starts.
c. supervised training with checkpoints. c1: phase 6's BERT-large (full
   size, seq 512, batch 8, flash attention, bfloat16 AMP) under
   ``LambOptimizer(lr, lamb_weight_decay=0.01)`` with the layer norms'
   scales and biases excluded from the decay, and BERT's learning rate
   ``linear_lr_warmup(polynomial_decay(1e-4, 8, 0.0), 2, 0.0, 1e-4)``;
   a ``resilience.Supervisor`` (its steps on the watchdog's worker
   thread) runs 8 steps with one commit, at step 5 (``keep_last=1``, no
   final commit); that commit is resumed by a fresh Executor and scope
   (startup under another seed) through a new Supervisor on the caller's
   thread to step 8, committing nothing. Steps 6-8 (losses and the
   fetched lr) and every persistable at step 8 (parameters, both
   moments, beta powers, ``@LR_DECAY_COUNTER@``) equal the uninterrupted
   run bit for bit; exactly 49 K1, 49 K3, one K4, one K5, 24 K6 and 24
   K8 (each of its three kernels) every step and no fused Adam; the
   commit loads into a fresh scope on the card, and the resumed scope is
   saved asynchronously (values copied off the card, written on a
   background thread) and committed. Prints the step beside phase 6's,
   the checkpoint's bytes, the commit, load and async-save seconds and
   the peak memory. c2: the same recipe at BERT-large width
   with 2 layers in three processes (``chip_smoke.py --c2-child``): a
   reference of 10 steps, a run killed by ``kill@6`` with commits every 3
   steps (exit ``KILL_EXIT_CODE``, latest commit 6) and a run that resumes
   from 6: the 10 losses and lrs equal the reference's bit for bit.
   Checkpoints go to ``chip_smoke_ckpt/`` in the checkout, removed after.
d. the rest of the training path, after freeing what came before (its
   own peak printed). d1: ``build_gpt_lm`` at gpt3_1p3b's widths with 6
   of its 24 layers, flash attention, a switch-MoE FFN (8 experts,
   capacity 1.25) in every second layer, dropout 0.1, on phase 4's batch:
   5 steps of fused Adam(1e-4), then from the same startup 5 steps of
   RecomputeOptimizer(Adam) with a checkpoint at each decoder's output
   (7 segments), in a fresh scope: losses and every parameter within
   rtol 2e-4 / atol 2e-5 of the plain run's, exact launches every step
   (K1 2(2L+1), K3 2L+1, K4 2, K5 1, K6 2L, K8 L, K10 one a parameter
   under recompute; K1 and K6 once, K4 once without), and the memory the
   forward keeps for the backward lower. d3: the same model built
   ``is_test`` over d1's trained parameters: the MoE statistics (dropped
   token share and aux loss by layer), then ``save_inference_model`` and
   ``create_predictor``: its logits equal the Executor's at 1e-5 of
   max|logit|, with exact launches (K1 2L+1, K6 L). d2: the 2-layer dense
   GPT at full width (no dropout), GradientMergeOptimizer(Adam, k 4)
   against Adam over one batch of 8 x 1024 (losses and parameters at rtol
   1e-4 / atol 1e-5), then d1's model under GradientMergeOptimizer(
   RecomputeOptimizer(Adam), k 4) over batch 8 for 3 steps (4x d1's
   forward launches, one K10 a parameter). d4: DeepFM at the DeepFM
   paper's Criteo setting (26 fields over a 2^25-row table, embedding 10,
   13 dense features, hidden 400 x 3), batch 4096: 5 SGD steps with
   ``is_sparse`` equal the dense run's (rtol 1e-6, atol 1e-6 x max|p|);
   5 sparse Adam steps leave every untouched row's parameter and moments
   bit for bit, the last step's touched rows equal a plain per-row update,
   two merges of the gradient give the same bits, K10 only for the dense
   parameters; a dense Adam step for its time.
e. the conv families and quantization, its own peak printed. e1:
   ``models.vision.build_vgg`` depth 16 (batch norm, dropout 0.5) on
   CIFAR-10-sized images, batch 128, 10 fused Adam(1e-3) steps: exactly
   one K4, one K5 and one K10 a parameter every step, the mean of the
   last three losses below the first; then ``save_inference_model`` and
   a ``Predictor`` over the same images, its logits equal to the
   Executor's ``is_test`` forward (rtol 1e-5, atol 1e-6). e3: e1's
   program with ``contrib.slim.QuantizationTransformPass`` after
   ``minimize``, 5 steps: the fake-quantize ops present, losses finite,
   the activation scales moved, e1's launches every step; then
   ``QuantizationFreezePass`` on its forward: two runs equal, no
   persistable changed, the CPU's logits on the same state within 0.05
   of max|logit| (a few int8 levels: the card's last-bit differences
   flip values at rounding boundaries), the unquantized forward's
   distance reported; its step beside e1's. e2: SE-ResNeXt-50's layout
   (``dist_se_resnext.py``: depth 3-4-6-3, filters 128-1024, cardinality
   32, reduction 16) on 32-pixel images, batch 64, 5 fused Momentum
   0.9 + L2Decay 1e-4 steps at lr 0.01: one K10m a parameter, one K4, one
   K5 every step, losses falling; under ``--profile`` the grouped
   convolutions' share of the device time. e4: ``quantize.calibrate``
   over gpt3_1p3b's int8 inference Program (``build_lm_program`` at full
   depth, b2's batch, weights quantized in the scope as the Predictor
   does at load), 8 batches: one finite positive scale for each distinct
   matmul input, no observer state left, K1 2L+1 and K11 4L+1 a batch.
f. the serving host tiers on gpt3_1p3b (phase 3's seeded weights and
   the first 2 of its 16 prompts in f1-f3, default geometry, 32 new
   tokens): f1, a PrefillWorker and a
   DecodeWorker (two engines, two graphs, one card) over one predictor,
   a HostPageStore behind PageStoreServer / PageStoreClient on loopback
   TCP (a cap of ``STORE_MAX_BYTES``), driven by a DisaggService from 4
   client threads, with float32 pools over the raw wire and with int8
   pools (pages verbatim): every stream's 32 tokens, the oracle
   (float32), tokens equal to phase 3's (float32) or to a co-located
   int8 engine's, a stream that differs first differing at a near-tie;
   the decode side's spliced pages equal the store's bit for bit; K2
   (K2q) 24 and K1 49 launches every step of both engines, every step a
   graph replay; 2 handoffs, no store error. f3: the drain spills the
   decode side's trie; a fresh DecodeWorker on that store pulls pages
   and gives the cold split's tokens; warm TTFT against cold printed.
   f2: float32 pools over ``int8_block``: wire bytes <= 0.30 of the
   float32 bytes, decoded pages within ``blockwise_error_bound``, the
   oracle at phase 7's int8 tolerance. f4: decode ITL p50 while 8
   prompts of 1000 tokens flood the prefill tier, against idle and the
   co-located engines (printed, not gated). f5: a ServingServer over the
   split behind a TrafficController (two tenants' token buckets, three
   classes): a quota shed answers 429 with Retry-After, unmeetable
   deadlines shed before any batch slot (submitted + shed = offered
   exactly), a client that stops reading is cancelled and its lane
   freed before its generation would end while a healthy stream
   completes, one /metrics scrape holds every tier's series, /healthz
   both phases, a traceparent request one connected trace across both
   tiers and the page store, /v1/admin/flight/dump its JSON. f6: ResNet-50
   saved for inference and served by a WorkerPool of 1 spawned worker
   on the card over SO_REUSEPORT; clients on 8 threads through a
   rolling restart, its replacement listening before the old worker
   drains (at least 64 requests), none failed, each answer within 1e-4
   of this process's; /metrics/fleet merges the pool and this process
   under worker= labels with the paddle_slo_* gauges. Every engine
   drains with ``check_integrity`` and zero pages in use.
g. the data tiers. g1: phase 8's ResNet-50 recipe at 102 classes trained
   one epoch of ``datasets.flowers.train()`` (1024 synthetic samples, 16
   steps of 64): (a) ``io.batch`` + ``DataFeeder`` + ``exe.run`` a batch,
   (b) ``DataLoader.from_generator(...).set_sample_list_generator`` into
   ``exe.run_pipelined`` (device prefetch on a side stream), each from
   the same startup seed in a fresh scope. Under deterministic cuDNN
   (restored after) the losses, every persistable and the batches that
   reach the step (each held to (a)'s numpy feed) are equal bit for bit;
   a ``resilience.Supervisor`` over the loader commits every 3 steps,
   stops at step 6, and a fresh Executor and scope resume it to step 10
   with the uninterrupted run's losses bit for bit. With the default
   algorithms: images/s of (a) and (b), ``overlap_telemetry()`` over (b)
   and exactly 161 K10m, one K4 and one K5 a step; 3 steps of (b) under
   ``profiler.profiler(profile_path=DIR)``: the chrome trace holds the
   loader's, the feeder's and the step's ranges and 483 K10m kernels.
   g2: DeepFM at phase d4's configuration (sparse Adam): 32 batches of
   Criteo-layout rows from ``--seed`` written as MultiSlot text into 8
   files; the native parser (built with g++ at first use) and the
   Python parser give the same rows; ``InMemoryDataset`` (thread 4)
   ``load_into_memory``, ``local_shuffle(seed)``; ``train_from_dataset``
   at thread 1 equals ``exe.run`` over the same batches bit for bit (one
   K10 a dense parameter a step), at thread 4 (Hogwild) every batch runs
   once and the losses fall. Prints parse MB/s, samples/s at thread 1
   and 4 and, under ``--profile``, the device idle share of each.
h. distribution. h1: phase 4's flash recipe (gpt3_1p3b, 2 x 1024,
   AdamOptimizer(3e-4)) data-parallel at a world of one over NCCL:
   ``fleet.init(UserDefinedRoleMaker(...))`` and
   ``fleet.distributed_optimizer`` with the fp32 bucket planner
   (``collective_bucket_mb`` 25), 3 steps against the plain steps from
   the same seed (equal to phase 4's first three): losses and every
   parameter bit for bit, exact K1 / K3 49, K4 / K5 1, K6 / K8 24, K10
   294 launches a step; then ``collective_quantization="int8"`` (an
   identity at one rank, as the JAX package's). Prints the step beside
   the plain one and phase 4's, the buckets, the bytes a step through
   the comm layer and the wire ratio. h2: a world of 2 on the one card
   (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
   --backend gloo chip_smoke.py --h2-child DIR SEED``, both ranks on
   cuda:0), gpt3_1p3b's widths at 2 layers, flash, no dropout, one row
   of 1024 tokens a rank, against the single-process 2 x 1024 runs this
   process makes first. Adam's first moments hold the gradients, scale
   included, where Adam's parameters move about lr a step whatever the
   gradient's scale: they are held at relative L2 error 1e-4. (a) data
   parallel over the fp32 buckets, 3 steps: losses within rtol 1e-3,
   first moments, parameters within 2 * lr * steps, the ranks'
   parameter bits (fingerprinted) equal every step; (b) ZeRO-1: (a) bit
   for bit, each rank's chunk of every moment too, half the moment
   bytes a rank; (c) d1's MoE layer (8 experts, capacity 1.25), 3 steps:
   ``psum`` at ep 2 (both ranks all rows) against the MoE run (losses,
   first moments, parameters); the world at ep 1 (a row a rank, every
   expert on each) against the rows' gradient merge (its first loss,
   and its first step's moments where the load-balance loss does not
   reach); ``alltoall`` at ep 2 (a row a rank, 4 experts a rank)
   against the world at ep 1 (losses, first moments, parameters);
   (d) DGCMomentumOptimizer at
   sparsity 0.999 from step 1, 5 steps: finite, falling losses, replicas
   equal; (e) a data-parallel Supervisor on a small GPT committing every
   2 steps, ``r1:kill@5``: the launcher restarts the world and the 6
   losses equal an uninterrupted world-2 run's bit for bit
   (``chip_smoke.py --h2-elastic DIR SEED FAULT``, beside h2's world).
   Each rank's
   collective bytes and blocked seconds and the step times are printed.

i. tensor, sequence and pipeline parallelism: a world of 2 on the one
   card (``chip_smoke.py --i-child DIR SEED`` under the launcher, gloo,
   both ranks on cuda:0), gpt3_1p3b's widths at 2 layers (4 for i3),
   flash, no dropout, Adam(3e-4) under ``GradientClipByGlobalNorm(1.0)``,
   held to single-process runs this process makes while the ranks start
   (losses rtol 1e-3, Adam's first moments relative L2 1e-4). i1: tp 2
   over ``apply_gpt_megatron_sharding``'s tags, both ranks 2 x 1024, 3
   steps: the moments gathered with the fused QKV's interleave undone,
   parameters within 2 * lr * steps, both ranks' losses equal bit for
   bit, exact K1 / K3 5, K4 / K5 1, K6 / K8 2 (at 8 local heads), K10 30
   launches a step a rank. i1b: i1's trained Program saved for inference
   and served by ``create_predictor(Config(dir).enable_partitioning(
   mesh_axes={"tp": 2}))``: float32 logits within 1e-4 of max|logit| of
   one process's Predictor, int8 within 1e-3 with 9 K11 launches a run a
   rank. i2: sp 2, ``max_position`` raised to 4096, one row of 4096
   tokens (2048 a rank), ring and Ulysses 3 steps each; Ulysses launches
   K6 / K8 at 8 heads over the whole sequence, the ring none. i3: pp 2
   (``PipelineOptimizer`` cut at dec1's output, 4 microbatches), 4 x 1024,
   GPipe and 1F1B 3 steps each against the plain step on the whole
   batch; each stage's peak memory and stash. i4: dp 2 with
   ``GradientMergeOptimizer(Adam, k_steps=2)``, 2 rows a rank, against
   one process's merge over the 4 rows; one all-reduce of the merged
   gradients a step. Every reading is logged before any gate is held.
j. recurrence and sequences, seeded weights (std 0.02), Adam, TF32
   off. j1: ``models.seq2seq.build_seq2seq`` at rnn_search's widths
   (source vocabulary 17,191, target 7,709, embedding and hidden 512,
   length 50; the book's one attention GRU in place of rnn_search's 2
   LSTM layers) on the copy task: (a) card against CPU at batch 16, 2
   steps: losses rtol 1e-3, parameters 2 * lr * steps, Adam's first
   moments relative L2 1e-4 (a moment under 1e-6 of the largest one's
   norm against that floor), exactly one K4 and one K5 a step and one
   K10 a parameter a step; (b) 10 steps at batch 128 on the card over a
   set of 2 batches, cycled: every loss finite, the mean of the last
   three below the first; target
   tokens/s, ms a step, eager launches a step (one profiled step) and
   peak memory. j2: ``beam_search_infer`` from (b)'s parameters, beam
   10, length 50, end id 1, 8 sources, on the card and the CPU: equal
   sentences, or the CPU step where a source's selection first differs
   has a top gap at most 1e-3 * max|logp|; ms a decode step and
   sentences/s. j3: the book's ``stacked_lstm_net`` (embedding 128,
   hid_dim 512, 3 stacked, 2 classes; vocabulary 5,000, lengths 16-128)
   through ``dynamic_lstm`` and ``sequence_pool`` max: j1 (a)'s gate at
   batch 16, ms a step at batch 128. j4: the book's
   ``label_semantic_roles`` db_lstm (word_dim 32, mark_dim 5, hidden
   512, depth 8; 44,000 words, 3,000 predicates, 60 labels) with
   ``linear_chain_crf``, ``crf_decoding`` and ``chunk_eval``: j1 (a)'s
   gate (no K4 / K5), and the first step's decoded paths equal the
   CPU's on every row whose Viterbi margin is above 1e-4. j5: a
   ``DynamicRNN`` of seq2seq's GRU cell at hidden 512 over 64 rows of
   1-100 steps: outputs and gradients card against CPU within rtol 2e-4
   / atol 2e-5; a finished row emits exact zeros and keeps its last
   output as its final memory, bit for bit.
k. the imperative mode (``paddle_tpu_torch.dygraph``), TF32 off. k4
   first, its world beside k3: a gloo world of 2 on the card
   (``chip_smoke.py --k4-child``) trains the dygraph ResNet-50 twin of
   k1 under ``DataParallel`` (16 rows a rank, 2 Momentum steps:
   ``scale_loss``, ``backward``, ``apply_collective_grads``), held to one
   process that runs the same halves through ``backward()`` with each
   loss scaled by 1/2 and steps (cuDNN's deterministic algorithms in
   both): parameters within 2 * lr * steps, velocities relative L2 1e-4,
   the ranks' parameters equal bit for bit every step (BN running
   statistics not compared). k3: all 19 ``dygraph.nn`` classes forward
   and backward at the CPU tests' shapes, card against CPU from the
   CPU's weights (rtol 1e-4 / atol 1e-5; NCE's cost against JAX's formula
   on its own sampled classes), and ``dg.LayerNorm`` at BERT-large's
   [4096, 1024]: exactly one K1 and one K3, y / dx / dgamma / dbeta
   against the plain version (dgamma, dbeta 2e-5 * sqrt(R)). k1: the
   user's dygraph twin of ``build_resnet50`` (224^2, 1000 classes,
   Momentum 0.9, the loss through ``softmax_with_cross_entropy`` and
   ``layers.mean``) from the Program's startup weights mapped onto its
   keys: (a) at batch 32 against the Program on the card: the first
   loss rtol 1e-5, every gradient relative L2 1e-4 of the Program's
   ``@GRAD``, the BN statistics 1e-3 of their largest, one K4 and one K5
   in both; (b) card against CPU at batch 4, phase 5's ResNet gates;
   (c) reported: ms a step over steps 1-9 against the Program's bound
   step in the same call, images/s, one profiled step of each (kernels,
   device busy, idle share), peak memory. k2: ``TracedLayer`` over the
   model in eval mode at batch 32 (a CUDA graph): on 3 fresh batches
   the replay equals the eager forward bit for bit; ms a forward of
   each.
l. detection, TF32 off. l1: ``models.ssd.build_ssd(image_size=300,
   num_classes=21, max_gt=8)`` (SSD300's input and VOC's 21 classes:
   75^2 and 38^2 feature maps, 4 priors a cell, 28,276 priors; 14
   parameters) under AdamOptimizer(2e-3), fed by
   ``synthetic_det_batch``: (a) card against CPU at batch 4, 2 steps
   from the CPU startup's values: losses rtol 1e-3, parameters 2 * lr *
   steps, Adam's first moments relative L2 1e-4, exactly one K10 a
   parameter a step and no K4 / K5 (``ssd_loss_dense`` takes its own
   log-softmax, as JAX's); the first step's hard negatives are mined
   again on both devices from the fetched confidences, and where they
   differ the gap at the mining boundary must be a near-tie (printed);
   (b) 10 steps at batch 32 on the card over 2 cycled batches: finite
   losses, the mean of the last three below the first; ms a step,
   images/s, kernels a step and idle share (one profiled step) and peak
   memory. l2: ``main.clone(for_test=True)`` of the model built without
   its optimizer, on (b)'s weights, at batch 8 (images (b) trained on)
   on the card, against the CPU on 2 of the images: per image equal
   counts and labels, scores and boxes within rtol 1e-5, or the first
   differing row at a near-tie (a score gap within 1e-6 of the top
   score, or an IoU within 1e-6 of 0.45), printed;
   ``evaluator.DetectionMAP`` a image on the card equal to the CPU's
   within 1e-4 where the detections are equal; the NMS's iterations and
   a batch's decode + NMS ms. l3: the 10 differentiable detection
   lowerings forward and backward at the CPU tests' shapes, card
   against CPU (rtol 1e-4 / atol 1e-5); the proposal chain at Faster
   R-CNN's RPN size: ``anchor_generator`` over a [1, 1024, 50, 68] map
   at stride 16 with 15 anchors, ``generate_proposals`` (pre-NMS 6000,
   post-NMS 1000, NMS 0.7), ``roi_align`` 7 x 7 over the map: equal
   rois or a printed near-tie, pooled features within 1e-4 of the map's
   scale and, against a float64 CPU run on 100 rois, the card's error
   at most twice the float32 CPU's; ms of each op on the card.
m. the rest of the layer surface, TF32 off. m1: the slice's lowerings
   on the card against the CPU at the sweep's rows and the twins' cases
   (``probes/m1_inputs.npz``, written by tests/test_torch_m1_inputs.py):
   outputs and the gradients of the rows' grad slots within rtol 1e-4 /
   atol 1e-5, integer, index and data-movement outputs exact; the random
   ops by their statistics and own draws, the stateful ones (auc,
   precision_recall, mean_iou, center_loss, average_accumulates) over 3
   calls carrying their state, ``py_func`` / ``Print`` / the save and load
   ops through the card's Executor. m2: CycleGAN's ResNet generator at
   its published widths (c7s1-64, d128, d256, 9 x R256, u128, u64,
   c7s1-3; reflection padding, instance norm, 11.38 M parameters) under
   Adam(2e-4, beta1 0.5) with an L1 loss to a seeded target: (a) 128 x
   128, 2 steps card against CPU: losses rtol 1e-3, parameters 2 * lr *
   steps, one K10 a parameter a step; Adam's first moments within
   relative L2 1e-4 on its tanh twin (relu flips at rounding level, the
   CPU against itself printed); (b) 256 x 256, 10 steps over 2 cycled
   images: losses fall; ms a step, images/s, kernels a step, idle share,
   peak memory. m3: the heavy new ops at a user's sizes card against CPU
   (an image of a batched op) and timed with CUDA events.
n. the serving Programs, the fused inference ops and the parameter
   server: n1 gpt3_1p3b's ragged, prefill and decode Programs against the
   step modules on phase 3's weights (exact K1 / K2 / K2q / K6 / K13 /
   K11 / K12 launches), n2 three fused ops against their unfused graphs
   and the CPU, n3 DeepFM at 2^25 rows through 2 pservers on threads, n4
   one ``launch_ps`` job of 2 pservers and 2 trainers
   (``chip_smoke.py --n4-child``).
o. the NCHW -> NHWC pass (``transpiler.auto_nhwc``) on the card, TF32
   off. o1: phase 8's recipe (ResNet-50, batch 64 x 224^2, float32,
   fused Momentum + L2Decay) built NCHW and rewritten by ``auto_nhwc``
   before ``minimize``: at least 108 ops flipped (53 conv, 53 batch norm,
   2 pool) and at most 4 ``transpose2``; one step of the NCHW program and
   one of the NHWC program from the same startup values and batch: the
   first loss within rtol 1e-4, the BN running statistics within 1e-3 of
   their largest entry, every parameter after the first update within
   2 * lr of the NCHW run's, every velocity after it (the gradient K10m
   took, plus the decay) within relative L2 0.1 of the NCHW run's leaf
   by leaf (a zeroed gradient reads about 1; rounding alone moves them
   2-3 %, printed beside as the NCHW step on the input scaled by
   1 + 1e-7); the filter gradients cuDNN returned channels-last,
   counted; then 10 more NHWC steps: losses finite and
   falling, exactly 161 K10m, one K4 and one K5 a step (K10m takes every
   gradient contiguous). o2: phase 9's recipe (bfloat16 AMP, fused Adam)
   through ``auto_nhwc``: 10 steps, finite and falling, exactly 161 K10,
   one K4 and one K5 a step; the op count beside phase 9's 853. Both
   print ms a step, images/s and peak memory beside phases 8 and 9 when
   they ran in the same call; under ``--profile`` the step's convolution
   and layout-transpose device ms. o3: ``install_check.run_check()`` on
   the card: its verdict lines.

Then the seconds each phase took, one JSON line of per-kernel numbers,
the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

LANES, CHUNK, PAGE = 8, 16, 16     # the engine's defaults (generation_*)
TRAIN_BATCH, TRAIN_SEQ = 2, 1024   # phase 4's batch of gpt3_1p3b
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
VOCAB, HIDDEN = 32000, 2048        # gpt3_1p3b's widths
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# peak operations a second by the unit a kernel runs on: the FP32 FMA
# units, bf16 mma, three bf16 products a float32 product (K11's int8
# modes: x split into three bf16 terms) and 3xTF32 (the float32 flash
# backward: three TF32 products a float32 product)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "bf16_x3": 989e12 / 3,
            "tf32_x3": 495e12 / 3}
RATE_NAMES = {"float32": "FP32 FMA, 67 TFLOP/s",
              "bfloat16": "bf16 mma, 989 TFLOP/s",
              "bf16_x3": "3 bf16 mma a product, 989/3 TFLOP/s",
              "tf32_x3": "3xTF32 mma, 495/3 TFLOP/s"}
# the earlier designs' times on an NVIDIA H100 80GB HBM3 at 700 W, from
# PERF.md, printed in the log beside the redesigned kernels' (K11, the
# flash backward and the flash forward on the FP32 FMA units, K13 and K2 /
# K2q with one block per (row, head), K1 and K3 with scalar loads and
# K3's 512 partial rows summed a thread a column, K12's 256-row shrink
# slices summed by every expand thread, timed warm); not on the kernels
# line, which carries only this run's numbers
EARLIER_DESIGN_MS = {
    "quantized_matmul": {"int8_qkv": 0.164726, "int8_ffn2": 0.435523,
                         "int8_head": 0.739203, "int8_block_qkv": 0.274531,
                         "int8_block_ffn2": 0.894579,
                         "int8_block_head": 1.068307, "fp8_qkv": 0.273821,
                         "fp8_ffn2": 0.870918, "fp8_head": 0.996854},
    "flash_attention_bwd": {"gpt3_1p3b": 2.563510, "bert_large": 1.666838,
                            "gpt3_1p3b_bfloat16": 2.780298,
                            "long_bfloat16": 16.983804},
    "flash_attention_fwd": {"gpt3_1p3b": 0.740061, "bert_large": 0.583037,
                            "gpt3_1p3b_bfloat16": 0.737757,
                            "bert_large_bfloat16": 0.571782,
                            "long_bfloat16": 4.529747},
    "paged_attention": {"float32": 0.065568, "bfloat16": 0.131898},
    "ragged_paged_attention": {"float32": 0.214304, "bfloat16": 0.169389},
    "ragged_paged_attention_q": {"float32": 0.205008},
    "layer_norm": {"main": 0.006032, "train": 0.015139,
                   "train_bfloat16": 0.013363},
    "layer_norm_bwd": {"float32": 0.056502, "bfloat16": 0.043882},
    "batched_lora_add_": {"ffn1": 0.029146, "head": 0.030384},
}
SLEEP_CYCLES = 20_000_000          # keeps the card busy while launches queue
ALL_PHASES = "23456789abcdefghijklmno"
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.monotonic()


def log(msg=""):
    """One line of the run's log; a phase's first line carries the
    seconds since the script started, so the log reads as the run's
    time line."""
    if msg.startswith("phase"):
        msg = f"{msg} [{time.monotonic() - _T0:.1f} s]"
    print(msg, flush=True)


# -- phase 0 -------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- timing --------------------------------------------------------------------


def device_ms(torch, fn, reps=21, inner=10) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, between CUDA events. A sleep kernel ahead of
    each run lets the host queue the calls before the card reaches
    them, so a short kernel is timed, not its launch from Python."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# the inputs a rotated timing cycles through pass this many bytes: four
# times the H100's 50 MB L2
ROTATE_BYTES = 200 << 20


def rotated(torch, fn, *inputs):
    """``fn`` on copies of ``inputs`` in turn, enough copies that together
    they pass ROTATE_BYTES: no call finds its inputs in L2, as none does
    in a training step, where other work ran since they were written."""
    n = sum(t.numel() * t.element_size() for t in inputs)
    copies = [[t.clone() for t in inputs]
              for _ in range(max(2, -(-ROTATE_BYTES // n)))]
    turn = iter(range(1 << 30))
    return lambda: fn(*copies[next(turn) % len(copies)])


def bound_ms(nbytes: float, ops: float, rate: str):
    """The least time for the work: the bytes at the HBM rate or the
    operations at the peak of ``rate`` (a PEAK_OPS key), the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dtype, what, atol=None):
    atol, rtol = (TOL[dtype][0] if atol is None else atol), TOL[dtype][1]
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} elements outside atol {atol} / rtol "
            f"{rtol}; max_abs_err {float(err.max()):.3e}")
    return float(err.max())


def fmt(row, dtype):
    out = f"max_err={row['max_abs_err']:.3e} tol={row.get('tol', TOL[dtype])}"
    if "ms" in row:
        out += (f" ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                f"library_ms={row['library_ms']:.6f} "
                f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}; "
                f"{row.get('bound_rate', RATE_NAMES[dtype])})")
    if row.get("earlier_design_ms") is not None:
        out += f" earlier_design_ms={row['earlier_design_ms']:.6f}"
    if row.get("rotated"):
        out += " (rotated inputs)"
    return out


# -- phase 2: layer norm ---------------------------------------------------------


def ln_case(torch, dt, gen, R, C, offset=0):
    """x (centred at 0.5, spread 2) and dy [R, C], gamma and beta [C].
    ``offset`` elements in: x and dy start ``offset * itemsize`` bytes
    past their buffers, off the 16-byte vectors (the kernels' scalar
    path, as a view the ops path may pass)."""
    def rows(scale, shift):
        t = scale * torch.randn(R, C, device=DEVICE, generator=gen) + shift
        buf = torch.empty(R * C + offset, dtype=dt, device=DEVICE)
        out = buf[offset:].view(R, C)
        out.copy_(t)
        require(offset == 0 or out.data_ptr() % 16 != 0,
                "the offset input is 16-byte aligned")
        return out
    x = rows(2.0, 0.5)
    g = (1 + 0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
    b = (0.1 * torch.randn(C, device=DEVICE, generator=gen)).to(dt)
    return x, g, b, rows(1.0, 0.0)


def require_same_bits(torch, what, got, want):
    for i, (u, v) in enumerate(zip(got, want)):
        require(torch.equal(u, v), f"{what}: output {i} differs in its bits")


def sample_rows(R):
    return sorted({0, R // 2, R - 1})


# (R, C) of the layer-norm checks beyond the timed shapes: R not a
# multiple of any block, a narrow row, a row past the TPU kernel's MAX_C,
# one element, rows that are not whole 16-byte vectors (the scalar path),
# and C past the earlier K3's 29056 cap (the looped kernels)
LN_EDGES = ((300, 2048), (37, 96), (5, 8192), (1, 1), (7, 33), (16, 2050),
            (3, 32768))
LN_OFFSET_SHAPE = (300, 2048)


def check_layer_norm(torch, K, dtype_name, gen):
    """K1 against its plain version at the serving shape [lanes * chunk,
    hidden], the two_lane decode's [8, hidden], the training shape and
    BERT-large's [4096, 1024] (those two with the stats, as training runs
    it), the edges of LN_EDGES and an input off its 16-byte alignment
    (equal to its aligned copy bit for bit); two calls give the same bits
    and a row alone equals its row of the batch. The empty launch's time
    is printed beside the timed rows: the floor a serving-size call
    cannot go under. The rows with the stats are timed on rotated inputs
    (``rotated``), the serving rows on one input, which the kernel before
    has just written and L2 holds."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    floor = device_ms(torch, lambda: torch.cuda._sleep(0))
    timed = {(LANES * CHUNK, HIDDEN): ("main", False),
             (LANES, HIDDEN): ("decode", False),
             (TRAIN_ROWS, HIDDEN): ("train", True),
             (BERT_BATCH * BERT_SEQ, 1024): ("bert", True)}
    earlier = EARLIER_DESIGN_MS["layer_norm"]
    results = {}
    for R, C, offset in ([(R, C, 0) for R, C in timed]
                         + [(R, C, 0) for R, C in LN_EDGES]
                         + [(*LN_OFFSET_SHAPE, 32 // torch.finfo(dt).bits)]):
        x, g, b, _ = ln_case(torch, dt, gen, R, C, offset)
        what = f"layer_norm {dtype_name} [{R}x{C}]" + (
            f" at a {offset * x.element_size()}-byte offset" if offset else
            "")
        want = K.layer_norm_fwd_plain(x, g, b, 1e-5)
        got = K.layer_norm_fwd(x, g, b, 1e-5)
        err = compare(torch, got[0], want[0], dtype_name, what)
        for name, i in (("mean", 1), ("rstd", 2)):
            compare(torch, got[i], want[i], "float32", f"{what} {name}")
        y = K.layer_norm(x, g, b, 1e-5)
        require(torch.equal(y, got[0]), f"{what}: y without the stats "
                "differs from y with them")
        require_same_bits(torch, f"{what}, a second call", got,
                          K.layer_norm_fwd(x, g, b, 1e-5))
        for r in sample_rows(R):
            alone = K.layer_norm_fwd(x[r:r + 1].contiguous(), g, b, 1e-5)
            require_same_bits(torch, f"{what}, row {r} alone",
                              [t[0] for t in alone], [t[r] for t in got])
        if offset:
            require_same_bits(torch, f"{what} against its aligned copy",
                              got, K.layer_norm_fwd(x.clone(), g, b, 1e-5))
        row = {"shape": [R, C], "max_abs_err": err}
        if (R, C) in timed and not offset:
            key, stats = timed[(R, C)]
            fwd = K.layer_norm_fwd if stats else K.layer_norm
            item = x.element_size()
            nbytes = (2 * R * C + 2 * C) * item + (2 * R * 4 if stats else 0)
            ops = 8 * R * C      # sum, center, square, sum, scale, shift
            bms, by = bound_ms(nbytes, ops, dtype_name)

            def timed_ms(fn):
                run = rotated(torch, fn, x, g, b) if stats else (
                    lambda: fn(x, g, b))
                return device_ms(torch, run)
            row.update(
                ms=timed_ms(lambda x, g, b: fwd(x, g, b, 1e-5)),
                plain_ms=timed_ms(
                    lambda x, g, b: K.layer_norm_plain(x, g, b, 1e-5)),
                library_ms=timed_ms(
                    lambda x, g, b: F.layer_norm(x, (C,), g, b, 1e-5)),
                bound_ms=bms, bound_by=by, launch_floor_ms=floor,
                stats=stats, rotated=stats, earlier_design_ms=earlier.get(
                    key if dtype_name == "float32" else
                    f"{key}_{dtype_name}"))
            results[key] = row
            what += f" (launch floor {floor:.6f} ms)"
        log(f"  {what}: {fmt(row, dtype_name)}")
    return dict(results["main"], decode_shape=results["decode"],
                train_shape=results["train"], bert_shape=results["bert"])


# -- phase 2: ragged paged attention -------------------------------------------


def ragged_case(torch, np, dtype, gen, *, B, C, H, KVH, D, P, ps, maxp,
                starts, nvalid, seed):
    """Pools full of random data (stale rows everywhere, the junk page
    included), distinct pages per row, tables zero past each chain."""
    rng = np.random.RandomState(seed)
    kp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    q = torch.randn(B, C, H, D, device=DEVICE, generator=gen).to(dtype)
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(DEVICE)  # noqa: E731
    return q, kp, vp, as_dev(starts), as_dev(nvalid), as_dev(tables)


def ragged_bytes_ops(q, kp, starts, nvalid, ps):
    B, C, H, D = q.shape
    KVH = kp.shape[0]
    item = q.element_size()
    pages = sum(-(-(int(s) + int(n)) // ps) for s, n in zip(starts, nvalid)
                if n)
    nbytes = (pages * ps * D * item * 2 * KVH      # K and V pages needed
              + 2 * B * C * H * D * item            # q in, out
              + 4 * (2 * B + pages))                # starts, counts, tables
    keys = sum(int(s) + j + 1 for s, n in zip(starts, nvalid)
               for j in range(int(n)))
    ops = 4 * keys * H * D                          # q.k and p.v
    return nbytes, ops


# phase 3's shape with speculative verify rows: [pending] + 6 drafts
# starting mid-page (offsets 10 to 13 of a page of 16), so that each row's
# 7 queries cross into the next page; the last lane idle
VERIFY_CASE = dict(B=LANES, C=CHUNK, H=16, KVH=16, D=128, P=512, ps=PAGE,
                   maxp=64, starts=[10, 108, 764, 411, 26, 251, 701, 0],
                   nvalid=[7, 7, 7, 7, 7, 7, 7, 0])


def check_ragged(torch, np, K, dtype_name, gen, seed):
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    results = {}
    # the slice's shapes: 8 lanes x chunk 16, 16 heads x 128, 512 pages
    # of 16, 64 pages a sequence; prefill chunks, decode rows deep in
    # long contexts, an idle lane
    main = dict(B=LANES, C=CHUNK, H=16, KVH=16, D=128, P=512, ps=PAGE,
                maxp=64, starts=[0, 100, 767, 400, 16, 250, 700, 0],
                nvalid=[16, 1, 1, 16, 16, 1, 1, 0])
    # the four row kinds of tests/test_ragged.py (prefill from 0, decode
    # over a 6-token prefix, mid-prompt chunk, idle lane) with GQA group
    # 2 and partial last pages holding stale rows
    edge = dict(B=4, C=5, H=8, KVH=4, D=64, P=24, ps=4, maxp=5,
                starts=[0, 6, 9, 0], nvalid=[5, 1, 3, 0])
    for name, case in (("main", main), ("edge", edge),
                       ("verify", VERIFY_CASE)):
        q, kp, vp, st, nv, tb = ragged_case(torch, np, dt, gen, seed=seed,
                                            **case)
        what = (f"ragged_paged_attention {dtype_name} {name} "
                f"B{case['B']} C{case['C']} H{case['H']}/{case['KVH']} "
                f"D{case['D']}")
        out = K.ragged_paged_attention(q, kp, vp, st, nv, tb)
        err = compare(torch, out,
                      K.ragged_paged_attention_plain(q, kp, vp, st, nv, tb),
                      dtype_name, what)
        for b, n in enumerate(case["nvalid"]):
            require(bool((out[b, n:] == 0).all()),
                    f"{what}: rows past num_valid of row {b} are not 0")
        # the splits merge in a fixed order: the same bits twice
        require(torch.equal(out, K.ragged_paged_attention(q, kp, vp, st, nv,
                                                          tb)),
                f"{what}: two calls differ")
        row = {"max_abs_err": err}
        if name == "main":
            nbytes, ops = ragged_bytes_ops(q, kp, case["starts"],
                                           case["nvalid"], case["ps"])
            bms, by = bound_ms(nbytes, ops, dtype_name)
            # library yardstick: one SDPA call over the dense window
            # gathered beforehand (its masked rows are not zeroed)
            B, C, H, D = q.shape
            idx = tb.long()
            KVH = kp.shape[0]     # == H at the slice's shapes
            kd = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            vd = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            kpos = torch.arange(kd.shape[2], device=DEVICE)
            qpos = st.long()[:, None] + torch.arange(C, device=DEVICE)[None]
            mask = (kpos[None, None] <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            row.update(
                ms=device_ms(torch, lambda: K.ragged_paged_attention(
                    q, kp, vp, st, nv, tb)),
                plain_ms=device_ms(torch, lambda: K.ragged_paged_attention_plain(
                    q, kp, vp, st, nv, tb)),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask)),
                bound_ms=bms, bound_by=by,
                earlier_design_ms=EARLIER_DESIGN_MS["ragged_paged_attention"][
                    dtype_name])
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


# -- phase 2: the training kernels ----------------------------------------------


def check_layer_norm_bwd(torch, K, dtype_name, gen):
    """K3 against its plain version on the stats of K1's plain version,
    at the training shape, BERT-large's [4096, 1024], the edges of
    LN_EDGES and an input off its 16-byte alignment (equal to its aligned
    copy bit for bit); two calls give the same bits, dgamma and dbeta
    included, and a row alone gives its row's dx of the batch. Timed on
    rotated inputs (``rotated``): a training step's backward finds
    neither x, saved in the forward, nor all of dy in L2."""
    dt = getattr(torch, dtype_name)
    timed = {(TRAIN_ROWS, HIDDEN): "main", (BERT_BATCH * BERT_SEQ, 1024):
             "bert"}
    results = {}
    for R, C, offset in ([(R, C, 0) for R, C in timed]
                         + [(R, C, 0) for R, C in LN_EDGES]
                         + [(*LN_OFFSET_SHAPE, 32 // torch.finfo(dt).bits)]):
        x, g, b, dy = ln_case(torch, dt, gen, R, C, offset)
        _, mean, rstd = K.layer_norm_fwd_plain(x, g, b, 1e-5)
        got = K.layer_norm_bwd(x, g, dy, mean, rstd)
        want = K.layer_norm_bwd_plain(x, g, dy, mean, rstd)
        what = f"layer_norm_bwd {dtype_name} [{R}x{C}]" + (
            f" at a {offset * x.element_size()}-byte offset" if offset else
            "")
        # dgamma/dbeta sum R rows in another order than torch: a float32
        # sum's error grows with its length, so they get 2e-5 * sqrt(R)
        atols = (None, 2e-5 * R ** 0.5, 2e-5 * R ** 0.5)
        err = max(compare(torch, a, w, dtype_name, f"{what} {n}", atol=t)
                  for n, a, w, t in zip(("dx", "dgamma", "dbeta"), got, want,
                                        atols))
        require_same_bits(torch, f"{what}, a second call", got,
                          K.layer_norm_bwd(x, g, dy, mean, rstd))
        for r in sample_rows(R):
            one = slice(r, r + 1)
            alone = K.layer_norm_bwd(x[one].contiguous(), g,
                                     dy[one].contiguous(),
                                     mean[one].contiguous(),
                                     rstd[one].contiguous())
            require_same_bits(torch, f"{what}, row {r} alone",
                              [alone[0][0]], [got[0][r]])
        if offset:
            require_same_bits(torch, f"{what} against its aligned copy",
                              got, K.layer_norm_bwd(x.clone(), g, dy.clone(),
                                                    mean, rstd))
        row = {"shape": [R, C], "max_abs_err": err}
        if (R, C) in timed and not offset:
            item = x.element_size()
            nbytes = 3 * R * C * item + 3 * C * item + 2 * R * 4
            ops = 14 * R * C
            bms, by = bound_ms(nbytes, ops, dtype_name)
            # the library's own stats, in the dtype its backward takes
            _, m2, r2 = torch.native_layer_norm(x, [C], g, b, 1e-5)
            row.update(
                ms=device_ms(torch, rotated(
                    torch, K.layer_norm_bwd, x, g, dy, mean, rstd)),
                plain_ms=device_ms(torch, rotated(
                    torch, K.layer_norm_bwd_plain, x, g, dy, mean, rstd)),
                library_ms=device_ms(torch, rotated(
                    torch, lambda dy, x, m2, r2, g, b:
                    torch.ops.aten.native_layer_norm_backward(
                        dy, x, [C], m2, r2, g, b, [True, True, True]),
                    dy, x, m2, r2, g, b)),
                bound_ms=bms, bound_by=by, rotated=True,
                earlier_design_ms=EARLIER_DESIGN_MS["layer_norm_bwd"].get(
                    dtype_name if timed[(R, C)] == "main" else None))
            results[timed[(R, C)]] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return dict(results["main"], bert_shape=results["bert"])


def check_softmax_xent(torch, K, dtype_name, gen):
    """K4 and K5 against their plain versions: the training slice's
    [batch * seq, vocab], then rows not a multiple of any block over an
    odd C (the scalar path), and logits of magnitude 1e4; labels at 0 and
    C - 1, and ignore_index rows in the edge cases."""
    import torch.nn.functional as F

    dt = getattr(torch, dtype_name)
    fwd, bwd = {}, {}
    for name, R, C, scale in (("main", TRAIN_ROWS, VOCAB, 1.0),
                              ("odd", 37, 333, 3.0), ("1e4", 64, 4001, 1e4)):
        logits = (scale * torch.randn(R, C, device=DEVICE,
                                      generator=gen)).to(dt)
        labels = torch.randint(0, C, (R,), device=DEVICE, generator=gen)
        labels[0], labels[-1] = 0, C - 1
        if name != "main":
            labels[1::7] = -100
        dloss = torch.rand(R, device=DEVICE, generator=gen) + 0.5
        what = f"softmax_xent {dtype_name} {name} [{R}x{C}]"
        loss, lse = K.softmax_xent_fwd(logits, labels)
        ploss, plse = K.softmax_xent_fwd_plain(logits, labels)
        errf = max(compare(torch, loss, ploss, "float32", f"{what} loss"),
                   compare(torch, lse, plse, "float32", f"{what} lse"))
        if name != "main":
            require(bool((loss[1::7] == 0).all()),
                    f"{what}: ignore_index rows have a non-zero loss")
        ds = K.softmax_xent_bwd(logits, labels, lse, dloss)
        errb = compare(torch, ds, K.softmax_xent_bwd_plain(
            logits, labels, lse, dloss), dtype_name, f"{what} dlogits")
        rowf, rowb = {"max_abs_err": errf}, {"max_abs_err": errb}
        if name == "main":
            item = logits.element_size()
            bf = bound_ms(R * C * item + R * 8 + 2 * R * 4, 4 * R * C,
                          "float32")
            bb = bound_ms(2 * R * C * item + R * 16, 5 * R * C, "float32")
            lg = logits.detach().requires_grad_()
            ce = F.cross_entropy(lg, labels, reduction="none")
            dl = dloss.to(ce.dtype)
            rowf.update(
                ms=device_ms(torch, lambda: K.softmax_xent_fwd(
                    logits, labels)),
                plain_ms=device_ms(torch, lambda: K.softmax_xent_fwd_plain(
                    logits, labels)),
                library_ms=device_ms(torch, lambda: F.cross_entropy(
                    logits, labels, reduction="none")),
                bound_ms=bf[0], bound_by=bf[1])
            rowb.update(
                ms=device_ms(torch, lambda: K.softmax_xent_bwd(
                    logits, labels, lse, dloss)),
                plain_ms=device_ms(torch, lambda: K.softmax_xent_bwd_plain(
                    logits, labels, lse, dloss)),
                library_ms=device_ms(torch, lambda: torch.autograd.grad(
                    ce, lg, dl, retain_graph=True)),
                bound_ms=bb[0], bound_by=bb[1])
            fwd["main"], bwd["main"] = rowf, rowb
        log(f"  {what} fwd: {fmt(rowf, 'float32')}")
        log(f"  {what} bwd: {fmt(rowb, dtype_name)}")
    return fwd["main"], bwd["main"]


def check_fused_adam(torch, K, dtype_name, gen):
    """K10 against its plain version (both in place, on clones): an
    embedding-sized [32000, 2048] parameter, a [2048] bias, an odd size
    with a clip scale and AdamW decay, and a view 4 bytes off 16-byte
    alignment (the scalar path)."""
    dt = getattr(torch, dtype_name)
    f32 = lambda v: torch.tensor([v], device=DEVICE)  # noqa: E731
    lr, b1p, b2p = f32(3e-4), f32(0.9 ** 3), f32(0.999 ** 3)
    results = {}
    for name, n, clip, coeff in (("main", VOCAB * HIDDEN, None, 0.0),
                                 ("bias", HIDDEN, None, 0.0),
                                 ("clip_adamw", 4097, 0.37, 0.01),
                                 ("unaligned", 8191, 2.5, 0.01)):
        off = 1 if name == "unaligned" else 0

        def make(std):
            t = std * torch.randn(n + off, device=DEVICE, generator=gen)
            return t.to(dt)[off:]

        p, g, m = make(1.0), make(0.1), make(0.01)
        v = make(1e-2).square()
        cs = None if clip is None else f32(clip)
        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, clip_scale=cs,
                  weight_decay=coeff)
        got = [t.clone() for t in (p, g, m, v)]
        want = [t.clone() for t in (p, g, m, v)]
        if off:   # keep the clones 4 bytes off alignment too
            got = [torch.cat([t[:1], t])[1:] for t in got]
        K.fused_adam_update(*got, lr, b1p, b2p, **kw)
        K.fused_adam_update_plain(*want, lr, b1p, b2p, **kw)
        what = f"fused_adam {dtype_name} {name} [{n}]"
        err = max(compare(torch, a, w, dtype_name, f"{what} {s}") for s, a, w
                  in zip(("p", "m1", "m2"), (got[0], got[2], got[3]),
                         (want[0], want[2], want[3])))
        row = {"max_abs_err": err}
        if name == "main":
            item = p.element_size()
            bms, by = bound_ms(7 * n * item, 16 * n, "float32")
            step = torch.zeros((), device=DEVICE)
            row.update(
                ms=device_ms(torch, lambda: K.fused_adam_update(
                    *got, lr, b1p, b2p, **kw)),
                plain_ms=device_ms(torch, lambda: K.fused_adam_update_plain(
                    *want, lr, b1p, b2p, **kw)),
                library_ms=device_ms(torch, lambda: torch._fused_adam_(
                    [want[0]], [want[1]], [want[2]], [want[3]], [], [step],
                    lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.0,
                    eps=1e-8, amsgrad=False, maximize=False)),
                bound_ms=bms, bound_by=by)
            results["main"] = row
        log(f"  {what}: {fmt(row, dtype_name)}")
    return results["main"]


# -- phase 2: fused momentum (K10m) ----------------------------------------------

# ResNet-50's largest parameter and an fc-sized one
MOMENTUM_SHAPES = (("conv", (512, 512, 3, 3)), ("fc", (2048, 1000)))


def check_fused_momentum(torch, K, gen):
    """K10m against its plain version (both in place, on clones), bit for
    bit: float32 and bfloat16, plain and nesterov, without a clip scale
    (the ResNet-50 path), with ClipScale 1 and with 0.37. The timed row
    is float32 at [512, 512, 3, 3] without a clip scale."""
    f32 = lambda v: torch.tensor([v], device=DEVICE)  # noqa: E731
    lr = f32(0.025)
    main, n_checked = None, 0
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape_name, shape in MOMENTUM_SHAPES:
            for nesterov in (False, True):
                for clip in (None, 1.0, 0.37):
                    state = [(std * torch.randn(shape, device=DEVICE,
                                                generator=gen)).to(dt)
                             for std in (1.0, 0.1, 0.05)]
                    kw = dict(mu=0.9, use_nesterov=nesterov,
                              clip_scale=None if clip is None else f32(clip))
                    got = [t.clone() for t in state]
                    want = [t.clone() for t in state]
                    K.fused_momentum_update(*got, lr, **kw)
                    K.fused_momentum_update_plain(*want, lr, **kw)
                    what = (f"fused_momentum {dtype_name} {shape_name} "
                            f"{list(shape)} nesterov={nesterov} clip={clip}")
                    for i, slot in ((0, "p"), (2, "vel")):
                        diff = float((got[i].float() - want[i].float())
                                     .abs().max())
                        require(torch.equal(got[i], want[i]),
                                f"{what}: {slot} not bit for bit (max diff "
                                f"{diff:.3e})")
                    n_checked += 1
                    if (dtype_name, shape_name, nesterov, clip) != (
                            "float32", "conv", False, None):
                        continue
                    # timed over copies of (p, g, vel) in turn, so that
                    # L2 holds none of a call's inputs, as in a training
                    # step
                    n = got[0].numel()

                    def rotate(fn):
                        return rotated(torch, fn, *state)

                    bms, by = bound_ms(5 * n * 4, 4 * n, "float32")
                    main = {"max_abs_err": 0.0, "bound_ms": bms,
                            "bound_by": by, "rotated": True,
                            "ms": device_ms(torch, rotate(
                                lambda p, g, v: K.fused_momentum_update(
                                    p, g, v, lr, **kw))),
                            "plain_ms": device_ms(torch, rotate(
                                lambda p, g, v: K.fused_momentum_update_plain(
                                    p, g, v, lr, **kw))),
                            "library_ms": device_ms(torch, rotate(
                                lambda p, g, v: torch._fused_sgd_(
                                    [p], [g], [v], weight_decay=0.0,
                                    momentum=0.9, lr=0.025, dampening=0.0,
                                    nesterov=False, maximize=False,
                                    is_first_step=False)))}
                    log(f"  {what}: {fmt(main, 'float32')}")
    log(f"  fused_momentum: {n_checked} cases equal bit for bit")
    return main


# -- phase 2: paged decode attention (K13) ------------------------------------------


def paged_case(torch, np, dtype, gen, *, B, H, KVH, D, P, ps, maxp, lengths,
               seed):
    """Pools of random data, distinct pages per row, tables zero past
    each row's chain."""
    rng = np.random.RandomState(seed)
    kp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    vp = torch.randn(KVH, P, ps, D, device=DEVICE, generator=gen).to(dtype)
    q = torch.randn(B, H, D, device=DEVICE, generator=gen).to(dtype)
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b, n in enumerate(lengths):
        k = min(-(-n // ps), maxp)
        tables[b, :k] = [free.pop() for _ in range(k)]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(DEVICE)  # noqa: E731
    return q, kp, vp, as_dev(lengths), as_dev(tables)


def paged_bytes_ops(q, kp, lengths, ps, maxp):
    B, H, D = q.shape
    KVH = kp.shape[0]
    item = q.element_size()
    keys = [min(int(n), maxp * ps) for n in lengths]
    pages = sum(-(-k // ps) for k in keys)
    nbytes = (sum(keys) * D * item * 2 * KVH       # the K and V rows attended
              + 2 * B * H * D * item                # q in, out
              + 4 * (B + pages))                    # lengths, table entries
    return nbytes, 4 * sum(keys) * H * D           # q.k and p.v


def check_paged_attention(torch, np, K, gen, seed):
    """K13 against its plain version: the two_lane decode shape (8 lanes,
    q [8, 16, 128] over [16, 512, 16, 128] pools, each lane 16 tokens into
    the decode of one of phase 3's first 8 prompts) and edge cases (GQA
    with 4 kv heads for 16, lengths 0, 1, 37, the split chunk and one
    past it, a full 64-page table and past it; pages of 7 keys, which
    give an odd chunk of 63, at D = 60), float32 and bfloat16; two calls
    and each row run alone give the same bits."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.paged_attention import split_geometry

    prompt_lens = serving_prompts(np, seed, VOCAB)[0][:LANES]
    main = dict(B=LANES, H=16, KVH=16, D=128, P=512, ps=PAGE, maxp=64,
                lengths=[int(n) + 16 for n in prompt_lens])
    chunk, _ = split_geometry(64, PAGE)
    edge = dict(B=7, H=16, KVH=4, D=128, P=160, ps=PAGE, maxp=64,
                lengths=[0, 1, 37, chunk, chunk + 1, 64 * PAGE,
                         64 * PAGE + 5])
    odd = dict(B=7, H=8, KVH=2, D=60, P=96, ps=7, maxp=20,
               lengths=[0, 1, 63, 64, 126, 140, 145])
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for name, case in (("main", main), ("edge", edge), ("odd", odd)):
            q, kp, vp, lens, tb = paged_case(torch, np, dt, gen, seed=seed,
                                             **case)
            what = (f"paged_attention {dtype_name} {name} B{case['B']} "
                    f"H{case['H']}/{case['KVH']} D{case['D']} lengths "
                    f"{case['lengths']}")
            out = K.paged_attention(q, kp, vp, lens, tb)
            err = compare(torch, out, K.paged_attention_plain(q, kp, vp, lens,
                                                              tb),
                          dtype_name, what)
            for b, n in enumerate(case["lengths"]):
                require(n > 0 or bool((out[b] == 0).all()),
                        f"{what}: the length-0 row {b} is not 0")
            # the splits merge in a fixed order: the same bits twice, and
            # a row's bits do not depend on the rows beside it
            require(torch.equal(out, K.paged_attention(q, kp, vp, lens, tb)),
                    f"{what}: two calls differ")
            for b in range(case["B"]):
                alone = K.paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                          lens[b:b + 1].contiguous(),
                                          tb[b:b + 1].contiguous())
                require(torch.equal(alone[0], out[b]),
                        f"{what}: row {b} alone differs from row {b} of the "
                        "batch")
            row = {"max_abs_err": err}
            if name == "main":
                nbytes, ops = paged_bytes_ops(q, kp, case["lengths"],
                                              case["ps"], case["maxp"])
                bms, by = bound_ms(nbytes, ops, dtype_name)
                # library yardstick: one SDPA call over the window
                # gathered beforehand, keys past each length masked
                B, H, D = q.shape
                idx = tb.long()
                kd = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, H, -1, D)
                vd = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, H, -1, D)
                kpos = torch.arange(kd.shape[2], device=DEVICE)
                mask = (kpos[None] < lens.long()[:, None])[:, None, None]
                qs = q[:, :, None]
                row.update(
                    ms=device_ms(torch, lambda: K.paged_attention(
                        q, kp, vp, lens, tb)),
                    plain_ms=device_ms(torch, lambda: K.paged_attention_plain(
                        q, kp, vp, lens, tb)),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        qs, kd, vd, attn_mask=mask)),
                    bound_ms=bms, bound_by=by,
                    earlier_design_ms=EARLIER_DESIGN_MS["paged_attention"][
                        dtype_name])
                results[dtype_name] = row
            log(f"  {what}: {fmt(row, dtype_name)}")
    return results


# -- phase 2: flash attention -----------------------------------------------------

# (name, [B, H, S, D], causal, mask, dtypes, timed): the gpt3_1p3b and
# BERT-large shapes of phases 4 and 6 (phase 6 feeds float32 q, k, v: its
# qkv projection's bfloat16 output meets a float32 bias), the K7/K9
# regime of the TPU (S > 2048), a ragged S, a fully masked row
FLASH_CASES = (
    ("gpt3_1p3b", (2, 16, 1024, 128), True, None,
     ("float32", "bfloat16"), True),
    ("bert_large", (8, 16, 512, 64), False, "batch",
     ("float32", "bfloat16"), True),
    ("long", (1, 16, 4096, 128), True, None, ("bfloat16",), True),
    ("ragged", (2, 8, 1000, 64), False, "random", ("float32",), False),
    ("fully_masked", (2, 4, 256, 64), False, "dead_row", ("float32",), False),
)
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # sums over S keys
FLASH_BIAS = ((2, 4, 384, 64), ((2, 4), (1, 4), (2, 1), (1, 1)))


def flash_bytes_ops(q, causal, bwd):
    """Bytes (q, k, v, o and lse; dO, dq, dk, dv too for the backward)
    and flops (4 B H S^2 D forward, 10 B H S^2 D backward, half causal)."""
    B, H, S, D = q.shape
    item = q.element_size()
    nbytes = (8 if bwd else 4) * B * H * S * D * item + 4 * B * H * S
    ops = (10 if bwd else 4) * B * H * S * S * D
    return nbytes, ops / 2 if causal else ops


def flash_mask(torch, np, kind, B, S, seed):
    if kind is None:
        return None
    if kind == "batch":    # phase 6's padded batch: lengths 128..512
        from paddle_tpu_torch.models.bert import synthetic_batch

        keep = synthetic_batch(np.random.RandomState(seed), B, S, 30522,
                               min_len=128)["input_mask"] > 0.5
    else:
        keep = np.random.RandomState(seed).rand(B, S) > 0.3
        keep[:, 0] = True
        if kind == "dead_row":
            keep[1] = False
    return torch.as_tensor(np.where(keep, 0.0, -1e30).astype(np.float32)
                           ).to(DEVICE)


def check_flash(torch, np, K, gen, seed):
    """K6-K9: the forward and backward kernels against their plain
    versions (o, lse, dq, dk, dv, dbias), timed beside the plain
    versions and SDPA with the same mask or causal setting."""
    import torch.nn.functional as F

    rows = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    for name, shape, causal, mkind, dtypes, timed in FLASH_CASES:
        B, H, S, D = shape
        mask = flash_mask(torch, np, mkind, B, S, seed)
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            q, k, v, do = (torch.randn(*shape, device=DEVICE, generator=gen)
                           .to(dt) for _ in range(4))
            scale = D ** -0.5
            what = f"flash_attention {dt_name} {name} {list(shape)}"
            o, lse = K.flash_attention_fwd(q, k, v, mask, None, scale, causal)
            po, plse = K.flash_attention_fwd_plain(q, k, v, mask, None, scale,
                                                   causal)
            errf = max(compare(torch, o, po, dt_name, f"{what} o"),
                       compare(torch, lse, plse, "float32", f"{what} lse",
                               atol=1e-4))
            # no float atomics: a second forward gives the same bits
            o2, lse2 = K.flash_attention_fwd(q, k, v, mask, None, scale,
                                             causal)
            require(torch.equal(o, o2) and torch.equal(lse, lse2),
                    f"{what}: two forwards differ")
            del o2, lse2
            if mkind == "dead_row":
                mean_v = v[1].float().mean(dim=1, keepdim=True).expand(
                    H, S, D)
                compare(torch, o[1], mean_v, dt_name, f"{what} uniform row")
            got = K.flash_attention_bwd(q, k, v, mask, None, o, lse, do,
                                        scale, causal)
            want = K.flash_attention_bwd_plain(q, k, v, mask, None, o, lse,
                                               do, scale, causal)
            errb = max(compare(torch, a, w, dt_name, f"{what} {n}",
                               atol=FLASH_BWD_TOL[dt_name])
                       for n, a, w in zip(("dq", "dk", "dv"), got, want))
            # no float atomics: a second backward gives the same bits
            again = K.flash_attention_bwd(q, k, v, mask, None, o, lse, do,
                                          scale, causal)
            require(all(torch.equal(a, b) for a, b in zip(got[:3],
                                                           again[:3])),
                    f"{what}: two backwards differ")
            del again
            rowf, rowb = {"max_abs_err": errf}, {"max_abs_err": errb}
            if timed:
                reps = 5 if name == "long" else 21
                am = None if mask is None else mask[:, None, None, :].to(dt)
                lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
                lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=am,
                                                    is_causal=causal)
                for row, bwd, kern, plain, lib in (
                        (rowf, False,
                         lambda: K.flash_attention_fwd(q, k, v, mask, None,
                                                       scale, causal),
                         lambda: K.flash_attention_fwd_plain(
                             q, k, v, mask, None, scale, causal),
                         lambda: F.scaled_dot_product_attention(
                             q, k, v, attn_mask=am, is_causal=causal)),
                        (rowb, True,
                         lambda: K.flash_attention_bwd(
                             q, k, v, mask, None, o, lse, do, scale, causal),
                         lambda: K.flash_attention_bwd_plain(
                             q, k, v, mask, None, o, lse, do, scale, causal),
                         lambda: torch.autograd.grad(
                             lo, (lq, lk, lv), do, retain_graph=True))):
                    # float32: both run 3xTF32 on the tensor cores
                    rate = "tf32_x3" if dt_name == "float32" else dt_name
                    bms, by = bound_ms(*flash_bytes_ops(q, causal, bwd), rate)
                    row.update(ms=device_ms(torch, kern, reps=reps),
                               plain_ms=device_ms(torch, plain, reps=reps),
                               library_ms=device_ms(torch, lib, reps=reps),
                               bound_ms=bms, bound_by=by,
                               bound_rate=RATE_NAMES[rate])
                del lo
                key = name if dt_name == "float32" else f"{name}_{dt_name}"
                for row, kname in ((rowf, "flash_attention_fwd"),
                                   (rowb, "flash_attention_bwd")):
                    row["earlier_design_ms"] = EARLIER_DESIGN_MS[kname].get(
                        key)
                rows["flash_attention_fwd"][key] = rowf
                rows["flash_attention_bwd"][key] = rowb
            log(f"  {what} fwd: {fmt(rowf, dt_name)}")
            log(f"  {what} bwd: {fmt(rowb, dt_name)}")
    # the four bias shapes, each with its dbias (a sum over the
    # broadcast dims: its tolerance grows with their count)
    shape, bshapes = FLASH_BIAS
    B, H, S, D = shape
    q, k, v, do = (torch.randn(*shape, device=DEVICE, generator=gen)
                   for _ in range(4))
    mask = flash_mask(torch, np, "random", B, S, seed)
    for bs in bshapes:
        bias = torch.randn(*bs, S, S, device=DEVICE, generator=gen)
        what = f"flash_attention float32 bias {list(bs) + [S, S]}"
        o, lse = K.flash_attention_fwd(q, k, v, mask, bias, D ** -0.5, False)
        po, _ = K.flash_attention_fwd_plain(q, k, v, mask, bias, D ** -0.5,
                                            False)
        err = compare(torch, o, po, "float32", f"{what} o")
        got = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do,
                                    D ** -0.5, False)
        want = K.flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                                           D ** -0.5, False)
        summed = (B // bs[0]) * (H // bs[1])
        for n, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            require(tuple(a.shape) == tuple(w.shape), f"{what} {n} shape")
            atol = 1e-4 * (summed if n == "dbias" else 1)
            err = max(err, compare(torch, a, w, "float32", f"{what} {n}",
                                   atol=atol))
        log(f"  {what}: max_err={err:.3e} (dbias atol 1e-4 x {summed})")
    return rows


# -- phase 2: the quantized, multi-adapter serving kernels (K11, K2q, K12) ----------


def sum_tol(K, ref):
    """2e-6 * sqrt(K) of the output's scale. fp8: kernel and plain
    version take the same products (bf16 operands, exact in float32) and
    differ by the order of the float32 sums over K. int8 and int8_block:
    the kernel takes the products of q and three bf16 terms of x (each
    exact) and scales the finished sum (int8_block: each block's sum),
    where the plain version scales every weight first; one rounding more
    a product, and sums in another order. K12 (batched LoRA) takes the
    plain version's products in another order."""
    return 2e-6 * K ** 0.5 * max(1.0, float(ref.abs().max()))


QMM_SHAPES = (("qkv", 2048, 3 * HIDDEN), ("ffn2", 8192, HIDDEN),
              ("head", HIDDEN, VOCAB), ("k_tail", 2000, HIDDEN))
ODD_BLOCK = 100    # not a multiple of the mma depth: the FMA kernel


def qmm_row(torch, K, x, qw, qs, mode, block, Kd, N, timed):
    """One K11 case against its plain version; timed rows add the
    kernel, plain and library times and the bound."""
    from paddle_tpu_torch.kernels.quant_matmul import dequantize_weight

    M = x.shape[0]
    out = K.quantized_matmul(x, qw, qs, mode=mode, block=block)
    ref = K.quantized_matmul_plain(x, qw, qs, mode, block)
    tol = sum_tol(Kd, ref)
    what = f"quantized_matmul {mode} block {block} [{M}x{Kd}]x[{Kd}x{N}]"
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite")
    err = float((out - ref).abs().max())
    require(err <= tol, f"{what}: max_abs_err {err:.3e} > {tol:.3e}")
    row = {"shape": [M, Kd, N], "max_abs_err": err, "tol": tol}
    if timed:
        nbytes = M * Kd * 4 + Kd * N + qs.numel() * 4 + M * N * 4
        # the tensor-core kernel's rate: one bf16 product a weight for
        # fp8, three for the int8 modes; the FMA kernel's the FP32 units
        rate = ("float32" if mode == "int8_block" and block % 16
                else "bfloat16" if mode == "fp8" else "bf16_x3")
        bms, by = bound_ms(nbytes, 2 * M * Kd * N, rate)
        # library yardstick: one matmul over the weight dequantized
        # beforehand (bf16 operands for fp8)
        wd = dequantize_weight(qw, qs, mode, block)
        xl = x.bfloat16() if mode == "fp8" else x
        row.update(
            ms=device_ms(torch, lambda: K.quantized_matmul(
                x, qw, qs, mode=mode, block=block)),
            plain_ms=device_ms(torch, lambda: K.quantized_matmul_plain(
                x, qw, qs, mode, block)),
            library_ms=device_ms(torch, lambda: torch.matmul(xl, wd)),
            bound_ms=bms, bound_by=by, bound_rate=RATE_NAMES[rate])
        del wd
    return out, row, what


def check_quant_matmul(torch, K, gen):
    """K11 in its three modes against the plain version at the serving
    step's shapes (128 rows: 8 lanes x chunk 16); int8_block at block
    256, and a K of 2000 (not a multiple of it); the FMA kernel at block
    100 on qkv. Row independence: the rows of the 128-row call equal,
    bit for bit, the same rows computed at M = 1 and M = 37."""
    rows, fma = {}, {}
    M = LANES * CHUNK
    cases = [(mode, 256, name, Kd, N) for mode in ("int8", "int8_block",
                                                    "fp8")
             for name, Kd, N in QMM_SHAPES]
    cases.append(("int8_block", ODD_BLOCK, "qkv", 2048, 3 * HIDDEN))
    for mode, block, name, Kd, N in cases:
        w = 0.02 * torch.randn(Kd, N, device=DEVICE, generator=gen)
        x = torch.randn(M, Kd, device=DEVICE, generator=gen)
        qw, qs = K.quantize_weight(w, mode, block)
        del w
        out, row, what = qmm_row(torch, K, x, qw, qs, mode, block, Kd, N,
                                 timed=name != "k_tail")
        same = all(torch.equal(K.quantized_matmul(
            x[:m], qw, qs, mode=mode, block=block), out[:m]) for m in (1, 37))
        require(same, f"{what}: rows differ from the same rows at M = 1 / 37")
        row["row_independent"] = same
        if block == ODD_BLOCK:
            fma[f"{mode}_b{block}"] = row
        else:
            row["earlier_design_ms"] = EARLIER_DESIGN_MS[
                "quantized_matmul"].get(
                f"{mode}_{name}")
            rows[f"{mode}_{name}"] = row
        log(f"  {what}: {fmt(row, 'float32')} rows independent of M")
    return rows, fma


def check_ragged_q(torch, np, K, gen, seed):
    """K2q against its plain version at phase 3's ragged shape (int8
    pools of random bytes with random per-slot scales) and on the GQA
    edge case."""
    import torch.nn.functional as F

    main = dict(B=LANES, C=CHUNK, H=16, KVH=16, D=128, P=512, ps=PAGE,
                maxp=64, starts=[0, 100, 767, 400, 16, 250, 700, 0],
                nvalid=[16, 1, 1, 16, 16, 1, 1, 0])
    edge = dict(B=4, C=5, H=8, KVH=4, D=64, P=24, ps=4, maxp=5,
                starts=[0, 6, 9, 0], nvalid=[5, 1, 3, 0])
    result = None
    for name, case in (("main", main), ("edge", edge),
                       ("verify", VERIFY_CASE)):
        q, kf, vf, st, nv, tb = ragged_case(torch, np, torch.float32, gen,
                                            seed=seed, **case)
        KVH, P, ps, D = kf.shape
        kp = torch.randint(-127, 128, kf.shape, device=DEVICE, generator=gen,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, kf.shape, device=DEVICE, generator=gen,
                           dtype=torch.int8)
        ks = 0.02 * torch.rand(KVH, P, ps, device=DEVICE, generator=gen)
        vs = 0.02 * torch.rand(KVH, P, ps, device=DEVICE, generator=gen)
        del kf, vf
        what = (f"ragged_paged_attention_q int8 {name} B{case['B']} "
                f"C{case['C']} H{case['H']}/{case['KVH']} D{case['D']}")
        out = K.ragged_paged_attention_q(q, kp, vp, ks, vs, st, nv, tb)
        err = compare(torch, out, K.ragged_paged_attention_plain(
            q, kp, vp, st, nv, tb, None, ks, vs), "float32", what)
        for b, n in enumerate(case["nvalid"]):
            require(bool((out[b, n:] == 0).all()),
                    f"{what}: rows past num_valid of row {b} are not 0")
        require(torch.equal(out, K.ragged_paged_attention_q(
            q, kp, vp, ks, vs, st, nv, tb)), f"{what}: two calls differ")
        row = {"max_abs_err": err}
        if name == "main":
            B, C, H, D = q.shape
            pages = sum(-(-(s + n) // ps) for s, n in
                        zip(case["starts"], case["nvalid"]) if n)
            nbytes = (pages * ps * (D + 4) * 2 * KVH   # int8 rows + scales
                      + 2 * B * C * H * D * 4 + 4 * (2 * B + pages))
            _, ops = ragged_bytes_ops(q, kp, case["starts"], case["nvalid"],
                                      ps)
            bms, by = bound_ms(nbytes, ops, "float32")
            # library yardstick: SDPA over the window gathered and
            # dequantized beforehand, as for K2
            idx = tb.long()
            kd = (kp[:, idx].float() * ks[:, idx][..., None]).permute(
                1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            vd = (vp[:, idx].float() * vs[:, idx][..., None]).permute(
                1, 0, 2, 3, 4).reshape(B, KVH, -1, D)
            kpos = torch.arange(kd.shape[2], device=DEVICE)
            qpos = st.long()[:, None] + torch.arange(C, device=DEVICE)[None]
            mask = (kpos[None, None] <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            row.update(
                ms=device_ms(torch, lambda: K.ragged_paged_attention_q(
                    q, kp, vp, ks, vs, st, nv, tb)),
                plain_ms=device_ms(torch, lambda: K.ragged_paged_attention_plain(
                    q, kp, vp, st, nv, tb, None, ks, vs)),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask)),
                bound_ms=bms, bound_by=by,
                earlier_design_ms=EARLIER_DESIGN_MS[
                    "ragged_paged_attention_q"]["float32"])
            result = row
        log(f"  {what}: {fmt(row, 'float32')}")
    return result


# 8 lanes: slot 0, both buckets, and slots repeated within a bucket
LORA_SLOTS = [[0, 0], [1, 0], [0, 1], [2, 0], [1, 0], [0, 2], [0, 0], [0, 1]]
# gpt3_1p3b's five LoRA targets a layer and the head
LORA_SHAPES = (("qkv", HIDDEN, 3 * HIDDEN), ("proj", HIDDEN, HIDDEN),
               ("ffn1", HIDDEN, 8192), ("ffn2", 8192, HIDDEN),
               ("head", HIDDEN, VOCAB))
HOST_CALLS = 200   # calls whose wall time, unsynchronised, gives host us


def check_lora(torch, K, gen):
    """K12 against its plain version on the serving step's [8 lanes x
    16, K] rows, rank buckets 8 and 16 (3 slots each), at the five LoRA
    targets; rows on slot 0 must stay the base product bit for bit, two
    calls must give the same bits and each adapter lane run alone must
    equal its lane of the batch. Kernel, plain version and the bmm pair
    are timed on rotated inputs (``rotated``: no call finds x, out or
    the pools in L2, as none does in a serving step); the wrapper's host
    time a call is the wall time of HOST_CALLS calls queued without a
    synchronise."""
    rows = {}
    R, rep = LANES, CHUNK
    M = R * rep
    sl = torch.tensor(LORA_SLOTS, dtype=torch.int32, device=DEVICE)
    for name, Kd, N in LORA_SHAPES:
        x = torch.randn(M, Kd, device=DEVICE, generator=gen)
        base = torch.randn(M, N, device=DEVICE, generator=gen)
        pools = ([], [], [])
        for r in (8, 16):
            a = 0.02 * torch.randn(3, Kd, r, device=DEVICE, generator=gen)
            b = 0.02 * torch.randn(3, r, N, device=DEVICE, generator=gen)
            a[0], b[0] = 0.0, 0.0
            for lst, t in zip(pools, (a, b, torch.tensor(
                    [0.0, 2.0, 2.0], device=DEVICE))):
                lst.append(t)
        got = K.batched_lora_add_(base.clone(), x, *pools, sl)
        want = K.batched_lora_add_plain_(base.clone(), x, *pools, sl)
        tol = sum_tol(Kd, want)
        what = f"batched_lora_add_ {name} [{M}x{Kd}] -> {N}, ranks 8/16"
        err = float((got - want).abs().max())
        require(err <= tol, f"{what}: max_abs_err {err:.3e} > {tol:.3e}")
        zero = (sl == 0).all(dim=1).repeat_interleave(rep)
        require(torch.equal(got[zero], base[zero]),
                f"{what}: a slot-0 row is not the base product")
        require(torch.equal(K.batched_lora_add_(base.clone(), x, *pools, sl),
                            got), f"{what}: two calls differ in their bits")
        for lane in range(R):
            if any(LORA_SLOTS[lane]):
                mine = slice(lane * rep, (lane + 1) * rep)
                alone = K.batched_lora_add_(base[mine].clone(),
                                            x[mine].contiguous(), *pools,
                                            sl[lane:lane + 1])
                require(torch.equal(alone, got[mine]),
                        f"{what}: lane {lane} alone differs from the batch")
        row = {"shape": [M, Kd, N], "max_abs_err": err, "tol": tol}
        # bound: each distinct (bucket, slot) factor pair once, and the
        # adapter rows' x read and output read and written
        pairs = {(j, int(s)) for lane in LORA_SLOTS for j, s in
                 enumerate(lane) if s}
        ranks = (8, 16)
        n_rows = rep * sum(1 for lane in LORA_SLOTS if any(lane))
        nbytes = (sum((Kd * ranks[j] + ranks[j] * N) * 4 + 4
                      for j, _ in pairs)
                  + n_rows * (Kd + 2 * N) * 4 + sl.numel() * 4)
        ops = sum(rep * (2 * Kd * ranks[j] + 2 * ranks[j] * N + 2 * N)
                  for lane in LORA_SLOTS for j, s in enumerate(lane) if s)
        bms, by = bound_ms(nbytes, ops, "float32")
        idx = [sl[:, j].long() for j in range(2)]

        def library(out, x, a0, a1, b0, b1, s0, s1):
            # the gathered torch.bmm pair, bucket by bucket
            out = out.reshape(R, rep, N).clone()
            x3 = x.reshape(R, rep, Kd)
            for j, (a, b, sc) in enumerate(((a0, b0, s0), (a1, b1, s1))):
                u = torch.bmm(x3, a[idx[j]])
                out += torch.bmm(u, b[idx[j]]) * sc[idx[j]][:, None, None]
            return out

        def kernel(out, x, a0, a1, b0, b1, s0, s1):
            return K.batched_lora_add_(out, x, [a0, a1], [b0, b1], [s0, s1],
                                       sl)

        def plain(out, x, a0, a1, b0, b1, s0, s1):
            return K.batched_lora_add_plain_(out, x, [a0, a1], [b0, b1],
                                             [s0, s1], sl)

        inputs = (base.clone(), x, *pools[0], *pools[1], *pools[2])
        warm = lambda: kernel(*inputs)  # noqa: E731
        warm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            warm()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        row.update(
            ms=device_ms(torch, rotated(torch, kernel, *inputs)),
            plain_ms=device_ms(torch, rotated(torch, plain, *inputs)),
            library_ms=device_ms(torch, rotated(torch, library, *inputs)),
            bound_ms=bms, bound_by=by, rotated=True, host_us=host_us,
            earlier_design_ms=EARLIER_DESIGN_MS["batched_lora_add_"].get(
                name))
        rows[name] = row
        log(f"  {what}: {fmt(row, 'float32')} host_us={host_us:.3f}")
    return rows


# -- phase 3: the slice ------------------------------------------------------------


def make_params(torch, shapes, std, gen):
    """Seeded weights on the card under the ``__params__.npz`` names:
    Normal(0, std), layer-norm scale 1 and bias 0, fc biases 0."""
    params = {}
    for name, shape in shapes.items():
        if name.endswith(".scale"):
            params[name] = torch.ones(shape, device=DEVICE)
        elif name.endswith((".bias", ".b")):
            params[name] = torch.zeros(shape, device=DEVICE)
        else:
            params[name] = std * torch.randn(shape, device=DEVICE,
                                             generator=gen)
    return params


# (a substring of the lowercased kernel name, group): the first match
# wins. K2 and K2q are one source: their split and merge kernels are told
# apart by the page type, the second template argument, int8 ("signed
# char") for K2q.
KERNEL_GROUPS = (("ragged_split_kernel<float, signed char",
                  "ragged_paged_attention_q (K2q)"),
                 ("ragged_split_kernel<__nv_bfloat16, signed char",
                  "ragged_paged_attention_q (K2q)"),
                 ("ragged_merge_kernel<float, signed char",
                  "ragged_paged_attention_q (K2q)"),
                 ("ragged_merge_kernel<__nv_bfloat16, signed char",
                  "ragged_paged_attention_q (K2q)"),
                 ("quant_matmul", "quantized_matmul (K11)"),
                 ("lora_", "batched_lora_add_ (K12)"),
                 ("ragged_", "ragged_paged_attention (K2)"),
                 ("paged_attention_kernel", "paged_attention (K13)"),
                 ("paged_attention_merge", "paged_attention (K13)"),
                 ("momentum_kernel", "fused_momentum (K10m)"),
                 ("layer_norm_fwd", "layer_norm (K1)"),
                 ("layer_norm_bwd", "layer_norm_bwd (K3)"),
                 ("softmax_xent_fwd", "softmax_xent_fwd (K4)"),
                 ("softmax_xent_bwd", "softmax_xent_bwd (K5)"),
                 ("adam_kernel", "fused_adam (K10)"),
                 ("flash_fwd", "flash_attention_fwd (K6/K7)"),
                 ("flash_d", "flash_attention_bwd (K8/K9)"),
                 ("copy_kernel", "copies and casts"),
                 ("bn_", "batch norm"), ("batch_norm", "batch norm"),
                 ("welford", "batch norm"),
                 ("fprop", "convolution (cuDNN)"),
                 ("dgrad", "convolution (cuDNN)"),
                 ("wgrad", "convolution (cuDNN)"),
                 ("conv", "convolution (cuDNN)"),
                 ("cudnn", "convolution (cuDNN)"),
                 ("pool", "pooling"),
                 ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"),
                 ("index", "index/scatter/gather"),
                 ("scatter", "index/scatter/gather"),
                 ("gather", "index/scatter/gather"),
                 ("reduce", "reduce/argmax/softmax"),
                 ("argmax", "reduce/argmax/softmax"),
                 ("softmax", "reduce/argmax/softmax"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"))


LAYOUT_KEYS = ("nchwtonhwc", "nhwctonchw")


def busy_ms(intervals) -> float:
    """ms covered by the union of (ts, dur) intervals in us."""
    busy, end = 0.0, None
    for ts, dur in sorted(intervals):
        if end is None or ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy / 1e3


def kernel_breakdown(trace_path, wall_s):
    """Device time by kernel group from a torch.profiler chrome trace: a
    group's busy time (the union of its kernels' intervals: K12's expand,
    launched as the shrink's programmatic dependent, overlaps it; for
    every other group the sum of durations), the device's busy time and
    its idle share of the serving wall time."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e for e in events
               if str(e.get("cat", "")).lower() == "kernel" and "dur" in e]
    require(kernels, "the profiler trace holds no device kernel")
    spans, names = {}, {}
    for e in kernels:
        low = e["name"].lower()
        group = next((g for key, g in KERNEL_GROUPS if key in low), "other")
        spans.setdefault(group, []).append((e["ts"], e["dur"]))
        names[e["name"]] = names.get(e["name"], 0.0) + e["dur"] / 1e3
    groups = {g: busy_ms(iv) for g, iv in spans.items()}
    busy = busy_ms((e["ts"], e["dur"]) for e in kernels)
    # cuDNN's own NCHW <-> NHWC layout kernels (counted in the convolution
    # group above too)
    layout = sum(e["dur"] / 1e3 for e in kernels
                 if any(k in e["name"].lower() for k in LAYOUT_KEYS))
    return {"kernels": len(kernels), "kernel_ms_by_group": groups,
            "layout_transpose_ms": layout,
            "top_kernels_ms": dict(sorted(names.items(),
                                          key=lambda kv: -kv[1])[:8]),
            "device_busy_ms": busy, "wall_ms": wall_s * 1e3,
            "device_idle_share": 1.0 - busy / (wall_s * 1e3)}


def trace_breakdown(prof, out_dir, name, wall, steps=None):
    """Export the profiler's chrome trace, parse it into the breakdown
    and delete it (a whole phase's trace is tens of MB; the breakdown
    goes to chip_smoke.json). With ``steps``, the traced window's step
    count, each group's device ms a step too."""
    path = os.path.join(out_dir, f"{name}_trace.json")
    prof.export_chrome_trace(path)
    try:
        out = kernel_breakdown(path, wall)
    finally:
        os.remove(path)
    if steps:
        out["steps"] = steps
        out["kernel_ms_a_step_by_group"] = {
            g: ms / steps for g, ms in out["kernel_ms_by_group"].items()}
    log(f"  profile ({name} times above include the profiler): "
        + json.dumps(out))
    return out


def start_profile(torch):
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def serving_prompts(np, seed, vocab):
    """Phase 3's 16 prompts: lengths 16..768 and tokens from the seed."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(16, 769, size=16)
    return lengths, [rng.randint(0, vocab, size=n).astype(np.int64)
                     for n in lengths]


def run_clients(eng, prompts, max_new, adapters=None, ids=None,
                submitted=None):
    """The requests ``ids`` (all by default) submitted from 4 client
    threads, each waiting for its own; returns the streams (None where
    not submitted) and the wall time. ``submitted``, a dict, receives
    each request's submit time (``time.monotonic``)."""
    ids = list(range(len(prompts))) if ids is None else list(ids)
    streams = [None] * len(prompts)
    errors = []

    def client(mine):
        try:
            for i in mine:
                if submitted is not None:
                    submitted[i] = time.monotonic()
                kw = {} if adapters is None else {"adapter": adapters[i]}
                streams[i] = eng.submit(prompts[i], max_new_tokens=max_new,
                                        **kw)
            for i in mine:
                streams[i].result(timeout=600)
        except Exception as e:  # noqa: BLE001 — recorded, fails the phase below
            errors.append(repr(e))

    t_serve = time.perf_counter()
    threads = [threading.Thread(target=client, args=(ids[c::4],))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t_serve
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(not errors, f"client errors: {errors}")
    return streams, wall


def check_streams(streams, max_new):
    for i, s in enumerate(streams):
        if s is None:
            continue
        require(s.done(), f"request {i} not finished")
        require(s.error is None, f"request {i} ended in error: {s.error!r}")
        require(s.finish_reason == "length" and len(s.tokens) == max_new,
                f"request {i}: {s.finish_reason}, {len(s.tokens)} tokens")


def serving_perf(torch, st, streams, wall, lengths, card, what="served"):
    peak = torch.cuda.max_memory_allocated()
    done = [s for s in streams if s is not None]
    gen_tokens = sum(len(s.tokens) for s in done)
    prompt_tokens = int(sum(int(n) for n, s in zip(lengths, streams)
                            if s is not None))
    perf = {"tokens_per_s": gen_tokens / wall, "wall_s": wall,
            "engine_steps": st["decode_steps_total"],
            "step_ms_mean": st["decode_step_ms"]["mean"],
            "ttft_ms_p50": st["ttft_ms"]["p50"],
            "itl_ms_p50": st["itl_ms"]["p50"],
            "max_memory_allocated_gb": peak / 1e9,
            "prompt_tokens": prompt_tokens, "generated_tokens": gen_tokens,
            "evicted": st["evicted_total"], "card": card,
            "tokens": [None if s is None else list(s.tokens)
                       for s in streams]}
    log(f"  {what} {len(done)} requests ({prompt_tokens} prompt tokens, "
        f"{gen_tokens} generated) in {wall:.3f} s: "
        f"{perf['tokens_per_s']:.2f} tokens/s, {perf['engine_steps']} steps, "
        f"mean step {perf['step_ms_mean']} ms, TTFT p50 "
        f"{perf['ttft_ms_p50']} ms, ITL p50 {perf['itl_ms_p50']} ms, "
        f"max_memory_allocated {peak / 1e9:.2f} GB [{card}]")
    return perf


def require_graphed(st, steps, what):
    """The engine's fixed-shape step was captured once and replayed as a
    CUDA graph once an engine step."""
    require(st["graph_captures"] == 1 and st["graph_replays"] == steps
            and st["bound_step_runs"] == steps,
            f"{what}: {st['graph_replays']} graph replays and "
            f"{st['bound_step_runs']} bound-step runs for {steps} engine "
            f"steps ({st['graph_captures']} captures)")
    log(f"  {what}: the bound step replayed its CUDA graph {steps} times "
        f"(captured once; its kernel nodes a replay "
        f"{st['graph_launches']})")


def same_except_junk(torch, a, b):
    """Pool (or scale plane) equality bit for bit, page 0 slot 0 left
    out: idle rows all write there, in an order neither framework
    defines."""
    return (torch.equal(a[:, 1:], b[:, 1:])
            and torch.equal(a[:, 0, 1:], b[:, 0, 1:]))


GRAPH_CHECK_NEW = (3, 12, 5, 9, 4, 14, 7, 10, 6, 8)   # tokens, per request


def check_graph_vs_eager(torch, np, eng, prompts, adapters=None, what=""):
    """A recorded sequence of real steps, replayed against eager calls.

    Ten requests (prompts cut to 40 tokens, 3 to 14 new tokens) on the
    graphed engine: more requests than lanes, ending at different steps,
    so rows join and leave. Each step's host feeds are recorded. Then,
    the engine closed, every recorded step runs twice from the same
    pools: the graph replay on the engine's pools and the eager step on
    fresh tensors over cloned pools. Tokens, pools (page 0 slot 0 left
    out) and scale planes must be equal bit for bit. The engine is
    closed on return."""
    bound = eng._bound_step
    recorded = []
    run = bound.run

    def recording(**host):
        recorded.append({n: np.array(a, copy=True) for n, a in host.items()})
        return run(**host)

    bound.run = recording
    try:
        streams = [eng.submit(prompts[i][:40], max_new_tokens=m,
                              adapter=None if adapters is None
                              else adapters[i])
                   for i, m in enumerate(GRAPH_CHECK_NEW)]
        for st_ in streams:
            st_.result(timeout=600)
    finally:
        bound.run = run
        eng.close()
    live = [int((h["num_valid"] > 0).sum()) for h in recorded]
    require(any(b < a for a, b in zip(live, live[1:])),
            f"{what}: no step had fewer live rows than the one before: "
            f"{live}")
    for i, host in enumerate(recorded):
        clone = {k: None if v is None else [t.clone() for t in v]
                 for k, v in bound.state.items()}
        got = bound.run(**host)
        want = bound.eager(state=clone, **host).cpu().numpy()
        torch.cuda.synchronize()
        require(np.array_equal(got, want), f"{what}: step {i}: the replay's "
                "tokens differ from the eager step's")
        for k, tensors in bound.state.items():
            if tensors is None:
                continue
            for layer, (a, b) in enumerate(zip(tensors, clone[k])):
                require(same_except_junk(torch, a, b), f"{what}: step {i}: {k} of "
                        f"layer {layer} differs between the replay and the "
                        "eager step")
        del clone
    log(f"  {what}: {len(recorded)} recorded steps (live rows {live}) "
        f"replayed against the eager step on cloned pools: tokens, pools "
        f"and scale planes equal bit for bit")
    return {"steps": len(recorded), "live_rows": live}


def lm_logits(pred, tokens):
    """Teacher-forced logits [B, S, V] (float32 numpy) of the
    predictor's GPT module over int64 tokens [B, S]: the module runs at
    any length, where a saved LM Program runs at its own."""
    import torch

    return pred.lm(torch.as_tensor(tokens)).float().cpu().numpy()


def oracle(np, pred, prompts, streams, ids=(0, 1), rel=1e-3):
    """Teacher-forced oracle: the predictor's logits over prompt +
    generated tokens must rank every generated token at the max, up to
    ``rel`` * max|logit| (1e-3: greedy up to float32 noise, random
    weights have near-ties that exact identity would trip on)."""
    for i in ids:
        toks = list(streams[i].tokens)
        ctx = np.concatenate([prompts[i], np.asarray(toks, np.int64)])
        logits = lm_logits(pred, ctx[None, :-1])
        n = len(prompts[i])
        worst = 0.0
        for k, tok in enumerate(toks):
            row = logits[0, n - 1 + k]
            slack = float(row.max() - row[tok])
            lim = rel * float(np.abs(row).max())
            require(slack <= lim, f"oracle: request {i} token {k} = {tok} is "
                    f"{slack:.3e} below the max (limit {lim:.3e})")
            worst = max(worst, slack / lim if lim else 0.0)
        log(f"  oracle request {i}: {len(toks)} tokens within limit "
            f"(worst slack {worst:.3f} of the limit)")


def gpt3_predictor(torch, seed):
    """gpt3_1p3b with seeded random weights made on the card (phases 3
    and 3b share them)."""
    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    # the parameter table of a model on the meta device names the shapes
    shapes = {n: tuple(p.shape)
              for n, p in GPTLM(cfg, device="meta").jax_params().items()}
    params = make_params(torch, shapes, cfg.initializer_range, gen)
    pred = Predictor(Config().set_params(cfg, params), device=DEVICE)
    del params
    torch.cuda.empty_cache()
    return cfg, pred


def serve(torch, np, seed, card, out_dir, profile=False):
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import GenerationEngine

    t0 = time.perf_counter()
    cfg, pred = gpt3_predictor(torch, seed)
    eng = GenerationEngine(pred, cfg, warmup=True)
    log(f"  model + engine ready in {time.perf_counter() - t0:.1f} s "
        f"(weights {sum(p.numel() for p in pred.lm.parameters()) * 4 / 1e9:.2f}"
        f" GB, KV pool {eng.cache.pool_bytes() / 1e9:.2f} GB)")

    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    max_new = 32
    prof = start_profile(torch) if profile else None
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    streams, wall = run_clients(eng, prompts, max_new)
    if prof is not None:
        prof.__exit__(None, None, None)
    counts = K.launch_counts()
    st = eng.stats()
    check_streams(streams, max_new)
    steps = st["ragged_steps_total"]
    L = cfg.num_layers
    log(f"  engine steps {steps}; launches {counts}")
    require(steps > 0, "no engine step ran")
    require(counts["ragged_paged_attention"] == L * steps,
            f"ragged attention launched {counts['ragged_paged_attention']} "
            f"times, want {L} x {steps}")
    require(counts["layer_norm"] == (2 * L + 1) * steps,
            f"layer_norm launched {counts['layer_norm']} times, want "
            f"{2 * L + 1} x {steps}")
    require_graphed(st, steps, "phase 3")
    perf = serving_perf(torch, st, streams, wall, lengths, card)
    if prof is not None:
        perf["profile"] = trace_breakdown(prof, out_dir, "serve", wall,
                                          steps)
    oracle(np, pred, prompts, streams)
    perf["graph_vs_eager"] = check_graph_vs_eager(torch, np, eng, prompts,
                                                  what="phase 3")
    return counts, perf


# -- phase 3b: the two_lane engine ------------------------------------------------

TWO_LANE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def serve_two_lane(torch, np, seed, card, out_dir, base_tokens=None,
                   profile=False):
    """Phase 3's model, weights and prompts served by the two_lane engine
    (prefill on the bucket ladder, decode through K13): exactly 24 K13
    and 49 K1 launches a decode step and 49 K1 a prefill call, no K2."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import GenerationEngine

    t0 = time.perf_counter()
    cfg, pred = gpt3_predictor(torch, seed)
    eng = GenerationEngine(pred, cfg, mode="two_lane",
                           prefill_buckets=TWO_LANE_BUCKETS, warmup=True)
    log(f"  model + two_lane engine ready in {time.perf_counter() - t0:.1f} s"
        f" (buckets {eng._seq_buckets}, {eng.lanes} lanes)")
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    max_new = 32
    prof = start_profile(torch) if profile else None
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    streams, wall = run_clients(eng, prompts, max_new)
    if prof is not None:
        prof.__exit__(None, None, None)
    counts = K.launch_counts()
    st = eng.stats()
    check_streams(streams, max_new)
    steps, prefills = st["decode_steps_total"], st["prefill_batches_total"]
    L = cfg.num_layers
    log(f"  decode steps {steps}, prefill calls {prefills} "
        f"({st['prefill_rows_total']} rows); launches {counts}")
    require(steps > 0 and prefills > 0, "no decode step or prefill ran")
    require(counts["paged_attention"] == L * steps,
            f"paged_attention launched {counts['paged_attention']} times, "
            f"want {L} x {steps} decode steps")
    require(counts["layer_norm"] == (2 * L + 1) * (steps + prefills),
            f"layer_norm launched {counts['layer_norm']} times, want "
            f"{2 * L + 1} x ({steps} decode steps + {prefills} prefills)")
    require(counts["ragged_paged_attention"] == 0,
            "the two_lane engine launched the ragged kernel")
    require_graphed(st, steps, "phase 3b decode")
    perf = serving_perf(torch, st, streams, wall, lengths, card,
                        what="served (two_lane)")
    perf.update(prefill_calls=prefills, prefill_rows=st["prefill_rows_total"],
                prefill_ms_mean=st["prefill_ms"]["mean"],
                prefill_ms_p50=st["prefill_ms"]["p50"])
    log(f"  prefill: {prefills} calls, mean {perf['prefill_ms_mean']} ms a "
        f"call (p50 {perf['prefill_ms_p50']} ms); mean decode step "
        f"{perf['step_ms_mean']} ms [{card}]")
    if prof is not None:
        perf["profile"] = trace_breakdown(prof, out_dir, "serve_two_lane",
                                          wall)
    oracle(np, pred, prompts, streams)
    perf["graph_vs_eager"] = check_graph_vs_eager(torch, np, eng, prompts,
                                                  what="phase 3b decode")
    if base_tokens is not None:
        same = total = 0
        for mine, theirs in zip(perf["tokens"], base_tokens):
            same += sum(a == b for a, b in zip(mine, theirs))
            total += len(mine)
        perf["ragged_token_agreement"] = same / total
        log(f"  tokens equal to phase 3's ragged run at {same} of {total} "
            f"positions ({same / total:.4f}; reported, not gated)")
    return counts, perf


# -- phase 4: training -------------------------------------------------------------


def run_steps(torch, np, K, exe, main, scope, batch, loss, want, steps,
              tokens, card, out_dir, name, profile=False, unit="tokens"):
    """``steps`` Executor runs of ``main`` on one fixed batch: every step
    must launch exactly ``want`` (per kernel; the flash backward's delta,
    dq and dk/dv kernels each as often as the backward); losses finite
    and falling. ``tokens`` counts the batch in ``unit`` (tokens, or
    images). Returns the path's launch totals and its numbers."""
    totals = {n: 0 for n in K.KERNELS}
    want_bwd = {n: want["flash_attention_bwd"]
                for n in K.flash_attention_bwd.kernel_launches}
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()

    # host-side events a slow step may owe its time to: full (gen 2)
    # Python GC passes and cudaMalloc calls of the caching allocator
    def host_events():
        return (gc.get_stats()[2]["collections"],
                torch.cuda.memory_stats().get("num_device_alloc", 0))

    for s in range(steps):
        K.reset_launch_counts()
        ev0 = host_events()
        t = time.perf_counter()
        (lv,) = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        ev = [b - a for a, b in zip(ev0, host_events())]
        counts = K.launch_counts()
        require(counts == want, f"step {s}: launches {counts}, want {want}")
        bwd = dict(K.flash_attention_bwd.kernel_launches)
        require(bwd == want_bwd, f"step {s}: flash backward kernels {bwd}, "
                f"want {want_bwd}")
        for n, c in counts.items():
            totals[n] += c
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        log(f"  step {s}: loss {losses[-1]:.6f} in {step_ms[-1]:.3f} ms "
            f"(gen-2 GC passes {ev[0]}, cudaMalloc calls {ev[1]})")
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    log(f"  launches, exactly, every step: "
        f"{ {n: c for n, c in want.items() if c} }; flash backward kernels "
        f"{want_bwd}")
    mean_ms = statistics.mean(step_ms[1:])
    perf = {"losses": losses, "step_ms": step_ms, "first_step_ms": step_ms[0],
            "step_ms_mean": mean_ms, f"{unit}_per_s": tokens / (mean_ms / 1e3),
            "max_memory_allocated_gb": peak / 1e9, "steps": steps,
            f"{unit}_per_step": tokens, "launches_per_step": want,
            "card": card}
    log(f"  trained {steps} steps of {tokens} {unit}: mean step "
        f"{mean_ms:.3f} ms over steps 1..{steps - 1} (first "
        f"{step_ms[0]:.3f} ms), {perf[f'{unit}_per_s']:.2f} {unit}/s, "
        f"max_memory_allocated {peak / 1e9:.2f} GB [{card}]")
    if profile:
        prof = start_profile(torch)
        t = time.perf_counter()
        for _ in range(2):
            exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        prof.__exit__(None, None, None)
        perf["profile"] = trace_breakdown(prof, out_dir, name, wall, 2)
    return totals, perf


def startup_on_card(torch, np, fluid, main, startup, seed):
    main.random_seed = startup.random_seed = seed
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    log(f"  {len(main.global_block().ops)} ops, {n_params} parameters; "
        f"startup run in {time.perf_counter() - t0:.1f} s")
    return exe, scope, n_params


def train(torch, np, seed, card, out_dir, profile=False, steps=10,
          flash=False):
    """gpt3_1p3b trained by the port's Executor through the K1, K3, K4,
    K5 and K10 kernels (and K6-K9 with ``flash``); exact launch counts
    every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    cfg = GPTConfig.gpt3_1p3b()
    cfg.use_flash_attention = flash
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(
            cfg, TRAIN_SEQ, fluid.optimizer.AdamOptimizer(3e-4))
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_adam") == 12 * L + 6 and "adam" not in types,
            f"the program holds {types.count('fused_adam')} fused_adam ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = synthetic_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               TRAIN_SEQ, cfg.vocab_size)
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                fused_adam_update=12 * L + 6)
    if flash:
        want.update(flash_attention_fwd=L, flash_attention_bwd=L)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, TRAIN_ROWS, card,
                             out_dir, "train_flash" if flash else "train",
                             profile)
    perf.update(parameters=n_params, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                flash=flash)
    return totals, perf


# -- phase 6: BERT-large pretraining under bfloat16 AMP ------------------------------


BERT_BATCH, BERT_SEQ = 8, 512


def train_bert(torch, np, seed, card, out_dir, profile=False, steps=10):
    """BertConfig.large() at full width and depth, flash attention with
    the padded batch's key mask, bfloat16 AMP as the JAX bench runs it
    (bench.py:248-250), fused Adam; exact launch counts every step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.bert import (BertConfig, build_bert_pretrain,
                                              synthetic_batch)

    cfg = BertConfig.large()
    cfg.use_flash_attention = True
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})
    opt = decorate(fluid.optimizer.AdamOptimizer(1e-4), init_loss_scaling=1.0,
                   use_dynamic_loss_scaling=False, dest_dtype="bfloat16")
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_bert_pretrain(cfg, BERT_SEQ, opt)
    types = [op.type for op in main.global_block().ops]
    n_adam = types.count("fused_adam")
    require(n_adam == len(main.all_parameters()) and "adam" not in types,
            f"{n_adam} fused_adam ops for {len(main.all_parameters())} "
            "parameters")
    require(types.count("flash_attention") == L, "flash ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = synthetic_batch(np.random.RandomState(seed), BERT_BATCH,
                            BERT_SEQ, cfg.vocab_size, min_len=128)
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                fused_adam_update=n_adam, flash_attention_fwd=L,
                flash_attention_bwd=L)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps,
                             BERT_BATCH * BERT_SEQ, card, out_dir, "bert",
                             profile)
    perf.update(parameters=n_params, batch=BERT_BATCH, seq_len=BERT_SEQ,
                real_tokens=int(batch["input_mask"].sum()))
    return totals, perf


# -- phase c: BERT-large under Lamb, checkpointed, killed and resumed ---------------


C_STEPS, C_EVERY = 8, 5          # c1: steps, the one commit's step
C2_STEPS, C2_EVERY, C2_KILL = 10, 3, 6
C2_LAYERS = 2
CKPT_ROOT = "chip_smoke_ckpt"    # in the checkout; removed after phase c


def not_decayed(param) -> bool:
    """Lamb's exclude_from_weight_decay_fn: the layer norms' scales and
    biases (``*.scale``, ``*.bias``); fc biases are ``*.b``."""
    return param.name.endswith((".scale", ".bias"))


def bert_lamb(fluid, cfg, seq, seed):
    """BERT pretraining under bfloat16 AMP with flash attention, as
    phase 6 builds it, with Lamb in place of Adam under BERT's
    warmup-then-linear-decay learning rate (the schedule's counter is a
    persistable, so it rides in the checkpoint)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.bert import build_bert_pretrain

    with fluid.unique_name.guard():
        main, startup, _, fetches = build_bert_pretrain(cfg, seq)
        main.random_seed = seed
        with fluid.program_guard(main, startup):
            lr = fluid.layers.linear_lr_warmup(
                fluid.layers.polynomial_decay(1e-4, decay_steps=C_STEPS,
                                              end_learning_rate=0.0,
                                              power=1.0),
                warmup_steps=2, start_lr=0.0, end_lr=1e-4)
            opt = decorate(fluid.optimizer.LambOptimizer(
                lr, lamb_weight_decay=0.01,
                exclude_from_weight_decay_fn=not_decayed),
                init_loss_scaling=1.0, use_dynamic_loss_scaling=False,
                dest_dtype="bfloat16")
            opt.minimize(fetches["loss"])
    return main, startup, fetches["loss"], lr


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def supervised(fluid, main, startup, loss, lr, batch, ckpt_dir, place,
               startup_seed, steps, every, keep_last, watchdog_s=0.0,
               fault="", on_commit=None, on_loss=None, check=None,
               final_checkpoint=True):
    """``steps`` steps of ``main`` through a ``resilience.Supervisor``
    (``every``-step commits, 0 for none, ``keep_last`` retention, a
    commit at the end unless ``final_checkpoint`` is False, resumed from
    ``ckpt_dir``'s latest commit if any) on a fresh Executor and scope
    whose startup ran under ``startup_seed``. ``check(step)`` reads the
    step's kernel launches (the counts are reset before each step).
    Returns the Executor, the scope, {step: (loss bits, lr bits)}, the
    stats and the times (ms a step, s a commit)."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch import kernels as K

    startup.random_seed = startup_seed
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    out, step_ms, save_s = {}, [], []
    mark = [0.0]

    def on_step(s, fetched):
        step_ms.append((time.perf_counter() - mark[0]) * 1e3)
        out[s] = (fetched[0].tobytes(), fetched[1].tobytes())
        if check is not None:
            check(s)
        if on_loss is not None:
            on_loss(s, fetched)
        K.reset_launch_counts()
        mark[0] = time.perf_counter()

    def on_checkpoint(s, path):
        save_s.append(time.perf_counter() - mark[0])
        if on_commit is not None:
            on_commit(s, path)
        mark[0] = time.perf_counter()

    sup = resilience.Supervisor(
        exe, main, ckpt_dir, feed_fn=lambda s: batch, fetch_list=[loss, lr],
        scope=scope, watchdog_timeout_s=watchdog_s,
        fault_injector=resilience.FaultInjector(fault),
        policy=resilience.CheckpointPolicy(ckpt_dir, every_steps=every,
                                           keep_last=keep_last),
        on_step=on_step, on_checkpoint=on_checkpoint)
    K.reset_launch_counts()
    mark[0] = time.perf_counter()
    stats = sup.run_loop(steps, final_checkpoint=final_checkpoint)
    return exe, scope, out, stats, {"step_ms": step_ms, "save_s": save_s}


def train_bert_lamb(torch, np, seed, card, out_dir, phase6=None,
                    profile=False):
    """c1: BertConfig.large() at full size under AMP + Lamb + warmup /
    decay through the Supervisor (its steps on the watchdog's worker
    thread), 8 steps with one commit, at step 5; then a fresh Executor
    and scope (startup under another seed) resume from it on the
    caller's thread to step 8, committing nothing: losses, lr and every
    persistable equal bit for bit, exact kernel launches every step; the
    commit is loaded into a fresh scope on the card and the resumed scope
    saved asynchronously at step 8, both timed. With
    ``profile``, two more steps of the resumed run are traced. Returns
    the path's launch totals and its numbers."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.bert import BertConfig, synthetic_batch

    cfg = BertConfig.large()
    cfg.use_flash_attention = True
    L = cfg.num_layers
    main, startup, loss, lr = bert_lamb(fluid, cfg, BERT_SEQ, seed)
    types = [op.type for op in main.global_block().ops]
    n_params = len(main.all_parameters())
    require(types.count("lamb") == n_params and "fused_adam" not in types
            and "adam" not in types, f"{types.count('lamb')} lamb ops for "
            f"{n_params} parameters")
    require(types.count("flash_attention") == L, "flash ops")
    wd = {op.inputs["Param"][0]: op.attrs["weight_decay"]
          for op in main.global_block().ops if op.type == "lamb"}
    require(sorted(n for n, w in wd.items() if w == 0.0) ==
            sorted(p.name for p in main.all_parameters() if not_decayed(p))
            and sum(w == 0.0 for w in wd.values()) == 4 * L + 2,
            "Lamb's weight decay is off exactly on the layer norms")
    batch = synthetic_batch(np.random.RandomState(seed), BERT_BATCH,
                            BERT_SEQ, cfg.vocab_size, min_len=128)
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                flash_attention_fwd=L, flash_attention_bwd=L)
    want_bwd = {n: L for n in K.flash_attention_bwd.kernel_launches}
    totals = {n: 0 for n in K.KERNELS}

    def check(s):
        counts = K.launch_counts()
        require(counts == want, f"c1 step {s}: launches {counts}, want "
                f"{want}")
        bwd = dict(K.flash_attention_bwd.kernel_launches)
        require(bwd == want_bwd, f"c1 step {s}: flash backward kernels "
                f"{bwd}")
        for n, c in counts.items():
            totals[n] += c

    root = os.path.abspath(os.path.join(CKPT_ROOT, "c1"))
    place = fluid.CUDAPlace(0)
    torch.cuda.reset_peak_memory_stats()
    _, ref_scope, ref, ref_stats, ref_t = supervised(
        fluid, main, startup, loss, lr, batch, root, place, seed, C_STEPS,
        C_EVERY, 1, watchdog_s=600.0, check=check, final_checkpoint=False)
    require(ref_stats["steps_completed"] == C_STEPS
            and ref_stats["watchdog_fires"] == 0, f"c1 run: {ref_stats}")
    require(io.latest_checkpoint(root) == C_EVERY
            and len(ref_t["save_s"]) == 1, "c1: one commit, at step "
            f"{C_EVERY}")
    exe, scope, got, stats, t = supervised(
        fluid, main, startup, loss, lr, batch, root, place, seed + 1,
        C_STEPS, 0, 1, check=check, final_checkpoint=False)
    peak = torch.cuda.max_memory_allocated()
    require(stats["resumed_from"] == C_EVERY, f"resumed from "
            f"{stats['resumed_from']}")
    require(sorted(got) == list(range(C_EVERY, C_STEPS)), f"resumed steps "
            f"{sorted(got)}")
    diff = [s for s in got if got[s] != ref[s]]
    require(not diff, f"c1: resumed steps {diff} differ from the "
            "uninterrupted run (loss or lr bits)")
    names = sorted(v.name for v in main.list_vars()
                   if v.persistable and not v.is_data)
    for n in names:
        require(torch.equal(scope.find_var(n), ref_scope.find_var(n)),
                f"c1: persistable {n} differs after the resume")
    lrs = [float(np.frombuffer(ref[s][1], np.float32)[0])
           for s in range(C_STEPS)]
    losses = [float(np.frombuffer(ref[s][0], np.float32)[0])
              for s in range(C_STEPS)]
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(float(scope.get_numpy("@LR_DECAY_COUNTER@")[0]) == C_STEPS,
            "the lr counter")
    require(io.latest_checkpoint(root) == C_EVERY and not t["save_s"],
            "c1: the resumed run committed")
    nbytes = dir_bytes(os.path.join(root, str(C_EVERY)))

    # the commit loaded into a fresh scope on the card, then an async
    # save of the resumed scope
    t0 = time.perf_counter()
    loaded = fluid.Scope()
    io.load_checkpoint(root, main, loaded, step=C_EVERY, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(float(loaded.get_numpy("@LR_DECAY_COUNTER@")[0]) == C_EVERY,
            "c1: the loaded commit's lr counter")
    del loaded
    t0 = time.perf_counter()
    handle = io.save_checkpoint(os.path.join(root, "async"), main, scope,
                                step=C_STEPS, async_save=True)
    async_return_s = time.perf_counter() - t0
    handle.wait_until_finished()
    async_s = time.perf_counter() - t0
    require(io.is_committed_checkpoint(
        os.path.join(root, "async", str(C_STEPS))), "the async commit")
    shutil.rmtree(root)
    if profile:
        prof = start_profile(torch)
        t0 = time.perf_counter()
        for _ in range(2):
            exe.run(main, feed=batch, fetch_list=[loss, lr], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        profiled = trace_breakdown(prof, out_dir, "bert_lamb", wall, 2)

    steps_ms = ref_t["step_ms"] + t["step_ms"]
    mean_ms = statistics.mean(ref_t["step_ms"][1:] + t["step_ms"][1:])
    perf = {"losses": losses, "lrs": lrs, "step_ms": steps_ms,
            "step_ms_mean": mean_ms,
            "tokens_per_s": BERT_BATCH * BERT_SEQ / (mean_ms / 1e3),
            "adam_step_ms_mean": (phase6 or {}).get("step_ms_mean"),
            "checkpoint_bytes": nbytes, "save_s": ref_t["save_s"],
            "load_s": load_s, "async_return_s": async_return_s,
            "async_s": async_s, "max_memory_allocated_gb": peak / 1e9,
            "launches_per_step": want, "card": card,
            "resumed_from": stats["resumed_from"]}
    if profile:
        perf["profile"] = profiled
    log(f"  losses {[f'{v:.6f}' for v in losses]}, lr {lrs}")
    log(f"  resumed from step {C_EVERY} on a fresh Executor and scope: "
        f"steps {C_EVERY + 1}-{C_STEPS} (losses, lr) and all {len(names)} "
        "persistables equal the uninterrupted run bit for bit; launches "
        f"exactly {({n: c for n, c in want.items() if c})} every step")
    log(f"  mean step {mean_ms:.3f} ms over both runs' steps after their "
        f"first ({perf['tokens_per_s']:.2f} tokens/s; phase 6's fused-Adam "
        f"step in this run: {perf['adam_step_ms_mean']} ms), max_memory_"
        f"allocated {peak / 1e9:.2f} GB [{card}]")
    log(f"  checkpoint {nbytes} bytes; commit "
        f"{[round(s, 3) for s in perf['save_s']]} s, load {load_s:.3f} s; "
        f"async save returned in {async_return_s:.3f} s and committed in "
        f"{async_s:.3f} s [{card}]")
    return totals, perf


def c2_child(argv) -> int:
    """One process of c2: the c1 recipe at BERT-large width with
    ``C2_LAYERS`` layers, through a Supervisor on the card; each step's
    (loss, lr) bits are appended to ``--out`` as it completes. A
    ``kill@N`` fault ends the process with ``KILL_EXIT_CODE``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fault", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.bert import BertConfig, synthetic_batch

    cfg = BertConfig.large()
    cfg.num_layers = C2_LAYERS
    cfg.use_flash_attention = True
    main, startup, loss, lr = bert_lamb(fluid, cfg, BERT_SEQ, args.seed)
    batch = synthetic_batch(np.random.RandomState(args.seed), BERT_BATCH,
                            BERT_SEQ, cfg.vocab_size, min_len=128)

    def on_loss(s, fetched):
        with open(args.out, "a") as f:
            f.write(json.dumps({"step": s, "loss": fetched[0].tobytes().hex(),
                                "lr": fetched[1].tobytes().hex()}) + "\n")

    torch.cuda.reset_peak_memory_stats()
    _, _, _, stats, t = supervised(
        fluid, main, startup, loss, lr, batch, os.path.abspath(args.ckpt_dir),
        fluid.CUDAPlace(0), args.seed, C2_STEPS, C2_EVERY, 2,
        fault=args.fault, on_loss=on_loss)
    with open(args.out, "a") as f:
        f.write(json.dumps({"stats": {k: v for k, v in stats.items()
                                      if k != "flight_dumps"},
                            "step_ms": t["step_ms"], "save_s": t["save_s"],
                            "peak_gb": torch.cuda.max_memory_allocated()
                            / 1e9}) + "\n")
    return 0


def killed_and_resumed(np, seed, card):
    """c2: three processes of ``c2_child``: the reference (10 steps) and,
    beside it on the card, a run killed by ``kill@6`` (commits every 3
    steps: it must exit with KILL_EXIT_CODE with step 6 committed), then
    one that resumes from 6;
    the killed run's 6 losses and the resumed run's 4 equal the
    reference's 10, bit for bit, and so do the learning rates."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.resilience import KILL_EXIT_CODE

    root = os.path.abspath(os.path.join(CKPT_ROOT, "c2"))
    os.makedirs(root, exist_ok=True)

    def child(name, ckpt, fault=""):
        out = os.path.join(root, f"{name}.jsonl")
        cmd = [sys.executable, os.path.abspath(__file__), "--c2-child",
               "--ckpt-dir", ckpt, "--out", out, "--seed", str(seed)]
        if fault:
            cmd += ["--fault", fault]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t0
        rows = []
        if os.path.exists(out):
            with open(out) as f:
                rows = [json.loads(line) for line in f]
        steps = {r["step"]: (r["loss"], r["lr"]) for r in rows if "step" in r}
        tail = next((r for r in rows if "stats" in r), None)
        log(f"  {name}: exit {proc.returncode} after {wall:.1f} s, steps "
            f"{sorted(steps)}" + (
                f", resumed_from {tail['stats']['resumed_from']}, mean step "
                f"{statistics.mean(tail['step_ms'][1:]):.3f} ms, commits "
                f"{[round(s, 3) for s in tail['save_s']]} s, peak "
                f"{tail['peak_gb']:.2f} GB" if tail else "") + f" [{card}]")
        return proc, steps, tail, wall

    # the reference and the run to be killed are independent: they share
    # the card side by side
    ck = os.path.join(root, "ck")
    side = {}
    t_ref = threading.Thread(target=lambda: side.update(ref=child(
        "reference", os.path.join(root, "ref_ck"))))
    t_ref.start()
    kill_proc, killed, _, kill_wall = child("killed", ck,
                                            fault=f"kill@{C2_KILL}")
    t_ref.join()
    ref_proc, ref, ref_tail, ref_wall = side["ref"]
    require(ref_proc.returncode == 0, "c2 reference failed: "
            f"{ref_proc.stderr[-2000:]}")
    require(sorted(ref) == list(range(C2_STEPS)), f"c2 reference steps "
            f"{sorted(ref)}")
    require(kill_proc.returncode == KILL_EXIT_CODE, f"c2 killed run exited "
            f"{kill_proc.returncode}: {kill_proc.stderr[-2000:]}")
    require(io.latest_checkpoint(ck) == C2_KILL, f"c2: latest checkpoint "
            f"after the kill is {io.latest_checkpoint(ck)}")
    ckpt_bytes = dir_bytes(os.path.join(ck, str(C2_KILL)))
    res_proc, resumed, res_tail, res_wall = child("resumed", ck)
    require(res_proc.returncode == 0, "c2 resumed run failed: "
            f"{res_proc.stderr[-2000:]}")
    require(res_tail["stats"]["resumed_from"] == C2_KILL, "c2 resumed_from "
            f"{res_tail['stats']['resumed_from']}")
    got = dict(killed)
    got.update(resumed)
    require(sorted(killed) == list(range(C2_KILL))
            and sorted(resumed) == list(range(C2_KILL, C2_STEPS)),
            f"c2 steps: killed {sorted(killed)}, resumed {sorted(resumed)}")
    diff = [s for s in range(C2_STEPS) if got[s] != ref[s]]
    require(not diff, f"c2: steps {diff} differ from the reference")
    require(io.latest_checkpoint(ck) == C2_STEPS, "c2 final commit")
    losses = [float(np.frombuffer(bytes.fromhex(ref[s][0]), np.float32)[0])
              for s in range(C2_STEPS)]
    shutil.rmtree(root)
    log(f"  killed at step {C2_KILL} (exit {KILL_EXIT_CODE}), resumed from "
        f"{C2_KILL}: all {C2_STEPS} losses and lrs equal the reference's "
        f"bit for bit; checkpoint {ckpt_bytes} bytes [{card}]")
    return {"losses": losses, "ckpt_bytes": ckpt_bytes,
            "wall_s": {"reference": ref_wall, "killed": kill_wall,
                       "resumed": res_wall},
            "reference": ref_tail, "resumed": res_tail, "card": card}


# -- phase 5: card against CPU -------------------------------------------------------


# card-vs-CPU bound on the losses: float32 differs by summation order
# only (1e-3, as phase 5 has always held it); under bfloat16 AMP cuBLAS
# and the CPU's GEMM round a product to bfloat16 after sums in another
# order, so an activation can be one bfloat16 step (2^-8) apart, and the
# loss, a mean over 256 tokens of such values, gets 2e-3
CARD_VS_CPU_RTOL = {"gpt": 1e-3, "gpt_flash": 1e-3, "bert_amp_flash": 2e-3}


def seeded_arrays(np, main, cpu_scope, std, seed):
    """Every persistable of ``main`` as numpy: parameters from a seeded
    generator (layer-norm scales 1, biases 0 -- the switch-MoE layers'
    ``.b1`` / ``.b2`` too -- the rest normal with ``std``), the other
    state (moments, counters, Lookahead's slow weights, EMA shadows) as
    the CPU's startup made it."""
    from paddle_tpu_torch.core.framework import Parameter

    rng = np.random.default_rng(seed)
    arrays = {}
    for v in main.list_vars():
        if not v.persistable or v.is_data:
            continue
        if not isinstance(v, Parameter):
            arrays[v.name] = cpu_scope.get_numpy(v.name)
        elif v.name.endswith(".scale"):
            arrays[v.name] = np.ones(v.shape, np.float32)
        elif v.name.endswith((".bias", ".b", ".b1", ".b2")):
            arrays[v.name] = np.zeros(v.shape, np.float32)
        else:
            arrays[v.name] = std * rng.standard_normal(v.shape,
                                                       dtype=np.float32)
    return arrays


CARD_VS_CPU_STEPS = 2    # phase 5's 2-layer GPT and BERT, card and CPU


def card_vs_cpu(torch, np, seed, model="gpt", steps=CARD_VS_CPU_STEPS,
                lr=3e-4):
    """A 2-layer model at full width trained from the same numpy-seeded
    parameters on the card (kernels) and on the CPU (plain versions):
    gpt3_1p3b's widths with op-graph or flash attention (float32), or
    BERT-large's widths with flash attention under bfloat16 AMP."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.bert import (BertConfig, build_bert_pretrain,
                                              synthetic_batch)
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    seq = 128
    fluid.set_flags({"optimizer_fuse": "on"})
    opt = fluid.optimizer.AdamOptimizer(lr)
    with fluid.unique_name.guard():
        if model.startswith("gpt"):
            cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                            num_layers=2, num_heads=16, ffn_size=8192,
                            max_position=1024, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            use_flash_attention=model == "gpt_flash")
            main, startup, _, fetches = build_gpt_lm(cfg, seq, opt)
            batch = synthetic_lm_batch(np.random.RandomState(seed), 2, seq,
                                       VOCAB)
        else:
            cfg = BertConfig.large()
            cfg.num_layers, cfg.use_flash_attention = 2, True
            cfg.hidden_dropout = cfg.attention_dropout = 0.0
            opt = decorate(opt, init_loss_scaling=1.0,
                           use_dynamic_loss_scaling=False,
                           dest_dtype="bfloat16")
            main, startup, _, fetches = build_bert_pretrain(cfg, seq, opt)
            batch = synthetic_batch(np.random.RandomState(seed), 2, seq,
                                    cfg.vocab_size, min_len=64)
    n_adam = [op.type for op in main.global_block().ops].count("fused_adam")
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)      # moments, beta pows, lr
    arrays = seeded_arrays(np, main, cpu_scope, cfg.initializer_range, seed)
    gpu, gpu_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    load_scope_arrays(cpu_scope, arrays, main, "cpu")
    load_scope_arrays(gpu_scope, arrays, main, DEVICE)
    losses = {}
    for name, exe, scope in (("cuda", gpu, gpu_scope), ("cpu", cpu, cpu_scope)):
        K.reset_launch_counts()
        t = time.perf_counter()
        losses[name] = [float(np.asarray(exe.run(
            main, feed=batch, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]) for _ in range(steps)]
        log(f"  {name}: losses {losses[name]} in "
            f"{time.perf_counter() - t:.1f} s; launches {K.launch_counts()}")
        if name == "cuda":
            counts = K.launch_counts()
            flash = "flash" in model
            require(counts["fused_adam_update"] == n_adam * steps
                    and counts["flash_attention_bwd"]
                    == (cfg.num_layers * steps if flash else 0),
                    "the card's run did not go through the kernels")
    rtol = CARD_VS_CPU_RTOL[model]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    require(rel <= rtol, f"card vs CPU losses differ by {rel:.3e} > {rtol}")
    limit = 2 * lr * steps
    worst, worst_name = 0.0, ""
    for p in main.all_parameters():
        d = float(np.abs(gpu_scope.get_numpy(p.name)
                         - cpu_scope.get_numpy(p.name)).max())
        if d > worst:
            worst, worst_name = d, p.name
    require(worst <= limit, f"card vs CPU parameter {worst_name} differs by "
            f"{worst:.3e} > 2 * lr * steps = {limit:.1e}")
    log(f"  losses agree within {rel:.3e} (rtol {rtol}); parameters within "
        f"{worst:.3e} ({worst_name}; limit 2 * lr * steps = {limit:.1e})")
    return {"losses": losses, "loss_rel_err": rel, "loss_rtol": rtol,
            "param_max_abs_err": worst, "param_limit": limit}


# -- phase 5: the quantized, multi-adapter step, card against CPU ---------------------


def _np_params(np, cfg, seed):
    """Seeded numpy weights under the ``__params__.npz`` names, as
    ``make_params`` makes them on the card."""
    from paddle_tpu_torch.generation.model import GPTLM

    rng = np.random.default_rng(seed)
    out = {}
    for name, p in GPTLM(cfg, device="meta").jax_params().items():
        if name.endswith(".scale"):
            out[name] = np.ones(p.shape, np.float32)
        elif name.endswith((".bias", ".b")):
            out[name] = np.zeros(p.shape, np.float32)
        else:
            out[name] = cfg.initializer_range * rng.standard_normal(
                p.shape, dtype=np.float32)
    return out


# card vs CPU int8 pools: a value may sit one int8 step apart where a
# float32 summation-order difference in the K/V projection lands it on a
# .5 rounding boundary. The first layer's scales (max|row| / 127) differ
# by that sum's relative error (1e-5); a deeper layer's rows come
# through attention over pools where such a step may differ, so its
# scales are held to half a quantization step of the row (1 / 254)
QKV_INT8_STEP, QKV_SCALE_RTOL = 1, (1e-5, 1 / 254)


def card_vs_cpu_quantized(torch, np, seed):
    """One ragged step of a 2-layer full-width GPT with int8 weights,
    int8 KV pages and two adapters (rank buckets 8 and 16), on the card
    (K11, K2q, K12) and on the CPU (plain versions), on a mixed batch:
    prefill chunks, decode rows, an idle lane, rows on slot 0 and on
    both buckets."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.adapters import (AdapterStore, lora_targets,
                                           rewrite_for_lora)
    from paddle_tpu_torch.generation import CacheGeometry, RaggedStepModel
    from paddle_tpu_torch.generation.model import step_feeds
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2,
                    num_heads=16, ffn_size=8192, max_position=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    L, H, D = cfg.num_layers, cfg.num_heads, HIDDEN // 16
    params = _np_params(np, cfg, seed)
    preds = {}
    for dev in ("cpu", DEVICE):
        c = Config().set_params(cfg, params).enable_weight_quantization("int8")
        preds[dev] = Predictor(c, device=dev)
    # one set of quantized bytes: the card's own quantization is compared,
    # then the CPU's is copied over so both steps read the same weights
    q_diff = 0
    for (_p, _a, dc), (_p2, _a2, dg) in zip(preds["cpu"].lm.dense_layers(),
                                            preds[DEVICE].lm.dense_layers()):
        q_diff = max(q_diff, int((dg.qweight.cpu().int()
                                  - dc.qweight.int()).abs().max()))
        dg.qweight.copy_(dc.qweight)
        dg.scale.copy_(dc.scale)
    log(f"  int8 weights quantized on the card vs the CPU: max |dq| "
        f"{q_diff} (the CPU's are used on both)")
    rng = np.random.RandomState(seed)
    ranks = {"a8": 8, "a16": 16}
    factors = {aid: {t: ((0.02 * rng.randn(k, r)).astype(np.float32),
                         (0.02 * rng.randn(r, n)).astype(np.float32))
                     for t, (k, n, _q) in sorted(
                         lora_targets(preds["cpu"].lm).items())}
               for aid, r in ranks.items()}
    R, C, P, ps, maxp = 6, CHUNK, 40, PAGE, 8
    #       prefill 0  mid chunk  decode  decode  idle  partial chunk
    starts = [0, 16, 40, 30, 0, 32]
    nvalid = [16, 16, 1, 1, 0, 9]
    adapters = [None, "a8", "a16", None, None, "a8"]
    tables = np.zeros((R, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(R):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    tokens = rng.randint(0, VOCAB, (R, C)).astype(np.int64)
    pos_ids = np.asarray(starts)[:, None] + np.arange(C)[None, :]
    kq = [rng.randint(-127, 128, (H, P, ps, D)).astype(np.int8)
          for _ in range(2 * L)]
    ks = [(0.02 * rng.rand(H, P, ps)).astype(np.float32)
          for _ in range(2 * L)]
    out = {}
    for dev, pred in preds.items():
        store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                       slots_per_bucket=2)
        for aid in ("a8", "a16"):
            store.upload(aid, factors[aid], alpha=2.0 * ranks[aid])
        step = RaggedStepModel(pred.lm, CacheGeometry(P, ps, maxp), C)
        rewrite_for_lora(step, store)
        slots = np.stack([store.slots_row(a) for a in adapters])
        pools = [torch.as_tensor(a).to(dev) for a in kq]
        scales = [torch.as_tensor(a).to(dev) for a in ks]
        K.reset_launch_counts()
        toks = step(*step_feeds(tokens, pos_ids, np.asarray(starts),
                                np.asarray(nvalid, np.int32), tables,
                                torch.device(dev)),
                    pools[:L], pools[L:], scales[:L], scales[L:],
                    adapter_slots=torch.as_tensor(slots).to(dev))
        counts = K.launch_counts()
        out[dev] = (toks.cpu().numpy().reshape(R, C),
                    [t.cpu() for t in pools], [t.cpu() for t in scales])
        if dev == DEVICE:
            want = {"quantized_matmul": 4 * L + 1, "batched_lora_add_": 4 * L + 1,
                    "ragged_paged_attention_q": L, "layer_norm": 2 * L + 1,
                    "ragged_paged_attention": 0}
            got = {n: counts[n] for n in want}
            require(got == want, f"the card's step launched {got}, want "
                    f"{want}")
    (tg, pg, sg), (tc, pc, sc) = out[DEVICE], out["cpu"]
    for b in range(R):
        n = nvalid[b]
        require(np.array_equal(tg[b, :n], tc[b, :n]),
                f"row {b}: card tokens {tg[b, :n]} != CPU {tc[b, :n]}")
    dq, ds = 0, 0.0
    for a, c_ in zip(pg, pc):
        # slot 0 of the junk page takes the invalid rows in no defined
        # order on either device: left out
        d = (a.int() - c_.int()).abs()
        d[:, 0, 0] = 0
        dq = max(dq, int(d.max()))
    ds = []
    for i, (a, c_) in enumerate(zip(sg, sc)):
        d = ((a - c_).abs() / c_.abs().clamp_min(1e-30))
        d[:, 0, 0] = 0
        layer = i % L                      # scales are [K of each layer, V ...]
        ds.append(float(d.max()))
        bound = QKV_SCALE_RTOL[min(layer, 1)]
        require(ds[-1] <= bound, f"layer {layer} KV scales differ by "
                f"{ds[-1]:.3e} relative > {bound:.3e}")
    require(dq <= QKV_INT8_STEP, f"int8 pools differ by {dq} steps")
    log(f"  tokens equal on {sum(nvalid)} valid positions; int8 pools within "
        f"{dq} step (bound {QKV_INT8_STEP}); scales (K then V, by layer) "
        f"within {['%.3e' % d for d in ds]} relative (bounds "
        f"{QKV_SCALE_RTOL[0]} first layer, {QKV_SCALE_RTOL[1]:.3e} deeper)")
    return {"tokens_equal": True, "pool_max_step_diff": dq,
            "scale_max_rel_diff": ds, "weight_quantization_max_diff": q_diff}


# -- phase 5: ResNet-50 and the two_lane lanes, card against CPU -------------------

RESNET_BATCH, RESNET_IMAGE = 64, 224      # the JAX bench's ResNet-50 size


def resnet_lr(batch):
    """The reference recipe's learning rate, 0.1 x batch / 256 (the
    linear scaling rule)."""
    return 0.1 * batch / 256


def resnet_optimizer(fluid, batch=RESNET_BATCH):
    """The reference recipe: Momentum 0.9 with L2 weight decay 1e-4."""
    return fluid.optimizer.MomentumOptimizer(
        resnet_lr(batch), momentum=0.9,
        regularization=fluid.regularizer.L2Decay(1e-4))


# card vs CPU ResNet-50: the first loss (a forward through the 53 conv /
# batch-norm pairs) differs by summation order only (cuDNN's and the
# CPU's convolutions, TF32 off); the running statistics the first step
# writes likewise, held relative to each one's largest entry
CARD_VS_CPU_RESNET_RTOL, BN_STATS_RTOL = 1e-3, 1e-3


def card_vs_cpu_resnet(torch, np, seed, steps=3, batch=4):
    """ResNet-50 at full depth and width, batch 4 x 224^2, from the same
    numpy-seeded parameters: fused Momentum + L2Decay steps (lr by the
    recipe's linear scaling, 0.1 x 4 / 256) on the card (K10m, K4, K5,
    cuDNN) and on the CPU (plain versions).

    Gated: the first loss (rtol 1e-3), the BN running statistics that
    first step wrote (1e-3 of each one's largest entry) and every
    parameter after the first update (within 2 x lr). The later losses
    are reported beside a second CPU run whose input is scaled by
    (1 + 1e-7): at initialisation ResNet-50's gradients are
    ill-conditioned (that nudge alone moves them by about 10 % of their
    largest entry), and a few updates carry the difference into the
    loss, so no two float32 implementations agree on the trajectory
    past the first update; the nudged run shows how far it is free to
    go."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.core.framework import Parameter
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    lr = resnet_lr(batch)
    fluid.set_flags({"optimizer_fuse": "on"})
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_resnet50(
            1000, RESNET_IMAGE, resnet_optimizer(fluid, batch))
    cpu = fluid.Executor(fluid.CPUPlace())
    init_scope = fluid.Scope()
    cpu.run(startup, scope=init_scope)    # velocities, running stats, lr
    rng = np.random.default_rng(seed)
    arrays = {}
    for v in main.list_vars():
        if not v.persistable or v.is_data:
            continue
        if not isinstance(v, Parameter):
            arrays[v.name] = init_scope.get_numpy(v.name)
        elif v.name.endswith(".scale"):
            arrays[v.name] = np.ones(v.shape, np.float32)
        elif v.name.endswith((".bias", ".b")):
            arrays[v.name] = np.zeros(v.shape, np.float32)
        else:     # He normal over the fan-in (conv), 1/sqrt(fan-in) (fc)
            conv = len(v.shape) == 4
            fan_in = int(np.prod(v.shape[1:])) if conv else int(v.shape[0])
            std = (2.0 / fan_in) ** 0.5 if conv else fan_in ** -0.5
            arrays[v.name] = std * rng.standard_normal(v.shape,
                                                       dtype=np.float32)
    data = synthetic_image_batch(np.random.RandomState(seed), batch,
                                 RESNET_IMAGE)
    nudged = dict(data, image=data["image"] * np.float32(1 + 1e-7))
    persist = [v for v in main.list_vars() if v.persistable and not v.is_data]
    runs = {}
    for name, place, dev, feed in (
            ("cuda", fluid.CUDAPlace(0), DEVICE, data),
            ("cpu", fluid.CPUPlace(), "cpu", data),
            ("cpu_nudged", fluid.CPUPlace(), "cpu", nudged)):
        exe, scope = fluid.Executor(place), fluid.Scope()
        load_scope_arrays(scope, arrays, main, dev)
        K.reset_launch_counts()
        t = time.perf_counter()
        losses, after_first = [], None
        for s_ in range(steps):
            losses.append(float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[fetches["loss"]],
                scope=scope)[0]).reshape(-1)[0]))
            if s_ == 0:
                after_first = {v.name: scope.get_numpy(v.name)
                               for v in persist}
        runs[name] = (losses, after_first)
        log(f"  {name}: losses {losses} in {time.perf_counter() - t:.1f} s")
        if name == "cuda":
            counts = K.launch_counts()
            require(counts["fused_momentum_update"] == 161 * steps
                    and counts["softmax_xent_fwd"] == steps,
                    f"the card's run did not go through the kernels: {counts}")
    (lg, pg), (lc, pc), (ln, pn) = (runs["cuda"], runs["cpu"],
                                    runs["cpu_nudged"])
    rel = abs(lg[0] - lc[0]) / abs(lc[0])
    require(rel <= CARD_VS_CPU_RESNET_RTOL, f"card vs CPU ResNet-50 first "
            f"loss differs by {rel:.3e} > {CARD_VS_CPU_RESNET_RTOL}")
    bn_worst, bn_name = 0.0, ""
    for v in persist:
        if v.name.endswith((".bn.mean", ".bn.var")):
            c = pc[v.name]
            d = float(np.abs(pg[v.name] - c).max() / np.abs(c).max())
            if d > bn_worst:
                bn_worst, bn_name = d, v.name
    require(bn_worst <= BN_STATS_RTOL, f"card vs CPU running statistic "
            f"{bn_name} differs by {bn_worst:.3e} of its largest entry > "
            f"{BN_STATS_RTOL}")
    def worst_param(a, b):
        return max((float(np.abs(a[v.name] - b[v.name]).max()), v.name)
                   for v in persist if isinstance(v, Parameter))

    worst, worst_name = worst_param(pg, pc)
    nudge, nudge_name = worst_param(pn, pc)
    require(worst <= 2 * lr, f"card vs CPU parameter {worst_name} differs by "
            f"{worst:.3e} after the first update > 2 * lr = {2 * lr:.3e}")
    later = [abs(a - b) / abs(b) for a, b in zip(lg[1:], lc[1:])]
    spread = [abs(a - b) / abs(b) for a, b in zip(ln[1:], lc[1:])]
    log(f"  first loss within {rel:.3e} (rtol {CARD_VS_CPU_RESNET_RTOL}); BN "
        f"running statistics after it within {bn_worst:.3e} of their "
        f"largest entry ({bn_name}; limit {BN_STATS_RTOL}); parameters after "
        f"the first update within {worst:.3e} ({worst_name}; limit 2 * lr "
        f"= {2 * lr:.3e}; the nudged CPU run's within {nudge:.3e})")
    log(f"  reported: later losses card vs CPU {['%.3e' % x for x in later]}"
        f", CPU vs the nudged CPU {['%.3e' % x for x in spread]}")
    return {"losses": {k: v[0] for k, v in runs.items()},
            "first_loss_rel_err": rel, "bn_stats_max_rel_err": bn_worst,
            "param_max_abs_err_first_step": worst, "param_limit": 2 * lr,
            "nudge_param_max_abs_diff_first_step": nudge,
            "later_loss_rel_err": later, "nudge_loss_rel_spread": spread}


def small_resnet(fluid, optimizer, size=16):
    """The two-bottleneck net of the CPU parity tests
    (``tests/test_torch_resnet.py`` ``_small_net``): stem conv-bn
    (stride 2), max pool 3/2/1, a bottleneck with a projection shortcut,
    one with an identity shortcut, a strided one, global average pool,
    fc 5, softmax cross-entropy."""
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("image", [3, size, size])
        label = fluid.layers.data("label", [1], dtype="int64")
        x = resnet._conv_bn(img, 8, 3, stride=2, name="stem")
        x = fluid.layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1)
        x = resnet._bottleneck(x, 4, 1, "a")
        x = resnet._bottleneck(x, 4, 1, "c")
        x = resnet._bottleneck(x, 4, 2, "b")
        pool = fluid.layers.pool2d(x, 2, "avg", global_pooling=True)
        logits = fluid.layers.fc(pool, 5,
                                 param_attr=fluid.ParamAttr(name="head.w"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        optimizer.minimize(loss)
    return main, startup, loss


AMP_SMALL_LR = 1e-3


# the first Adam update card vs CPU: on the entries whose CPU gradient is
# at least 2^-5 of its tensor's largest (eight times the bfloat16
# gradients' card-vs-CPU spread, one bfloat16 step there), Adam moves
# the entry by lr times the gradient's sign on both, so the updates
# agree within a tenth of lr; a skipped update is lr apart, a flipped
# one 2 lr
AMP_UPDATE_GRAD_FLOOR, AMP_UPDATE_RTOL = 2.0 ** -5, 0.1


def adam_update_agreement(np, p0, p_card, p_cpu, g_cpu, lr):
    """The first update p1 - p0 of each parameter, card vs CPU, on the
    entries whose CPU gradient is at least ``AMP_UPDATE_GRAD_FLOOR`` of
    its tensor's largest. Returns (worst difference, its parameter,
    entries held, entries in all, entries whose update's sign differs
    anywhere)."""
    worst, worst_name, held, total, flipped = 0.0, "", 0, 0, 0
    for n in sorted(p0):
        u_card, u_cpu = p_card[n] - p0[n], p_cpu[n] - p0[n]
        g = np.abs(g_cpu[n])
        big = g >= AMP_UPDATE_GRAD_FLOOR * g.max()
        total += g.size
        held += int(big.sum())
        flipped += int((np.sign(u_card) != np.sign(u_cpu)).sum())
        d = float(np.abs(u_card - u_cpu)[big].max(initial=0.0))
        if d > worst:
            worst, worst_name = d, n
    return worst, worst_name, held, total, flipped


def card_vs_cpu_resnet_amp(torch, np, seed, batch=8, size=16):
    """The two-bottleneck net under bfloat16 AMP (``decorate(Adam(1e-3),
    ...)``, the CPU parity test's net and recipe), from the same
    parameters on the card (cuDNN's bfloat16 convolutions, K4, K5, K10)
    and on the CPU: the first loss within rtol 2e-3 (as
    ``CARD_VS_CPU_RTOL["bert_amp_flash"]``: a product one bfloat16 step
    apart); the first update of every parameter entry whose CPU gradient
    stands above the bfloat16 spread (``adam_update_agreement``) within
    a tenth of lr (Adam's first step moves an entry by lr in the
    direction of its gradient's sign, so a skipped update is lr apart
    and a flipped one 2 lr), on at least half of the entries; every
    parameter within 2 x lr."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    fluid.set_flags({"optimizer_fuse": "on"})
    main, startup, loss = small_resnet(fluid, amp_adam(fluid, AMP_SMALL_LR),
                                       size)
    main.random_seed = startup.random_seed = seed
    init_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init_scope)
    persist = [v.name for v in main.list_vars()
               if v.persistable and not v.is_data]
    arrays = {n: init_scope.get_numpy(n) for n in persist}
    params = sorted(p.name for p in main.all_parameters())
    grads = [f"{n}@GRAD" for n in params]
    rng = np.random.RandomState(seed)
    data = {"image": rng.randn(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, 5, (batch, 1)).astype(np.int64)}
    runs = {}
    for name, place, dev in (("cuda", fluid.CUDAPlace(0), DEVICE),
                             ("cpu", fluid.CPUPlace(), "cpu")):
        exe, scope = fluid.Executor(place), fluid.Scope()
        load_scope_arrays(scope, arrays, main, dev)
        K.reset_launch_counts()
        out = exe.run(main, feed=data, fetch_list=[loss] + grads,
                      scope=scope)
        runs[name] = (float(np.asarray(out[0]).reshape(-1)[0]),
                      {n: scope.get_numpy(n) for n in params},
                      {n: np.asarray(g, np.float32)
                       for n, g in zip(params, out[1:])})
        if name == "cuda":
            counts = K.launch_counts()
            require(counts["fused_adam_update"] == len(params)
                    and counts["softmax_xent_fwd"] == 1,
                    f"the card's run did not go through the kernels: {counts}")
    (lg, pg, _), (lc, pc, gc) = runs["cuda"], runs["cpu"]
    rel = abs(lg - lc) / abs(lc)
    limit = CARD_VS_CPU_RTOL["bert_amp_flash"]
    require(rel <= limit, f"card vs CPU AMP two-bottleneck first loss "
            f"differs by {rel:.3e} > {limit}")
    p0 = {n: arrays[n] for n in params}
    upd, upd_name, held, total, flipped = adam_update_agreement(
        np, p0, pg, pc, gc, AMP_SMALL_LR)
    upd_limit = AMP_UPDATE_RTOL * AMP_SMALL_LR
    require(2 * held >= total, f"card vs CPU AMP update: only {held} of "
            f"{total} entries have a gradient above the bfloat16 spread")
    require(upd <= upd_limit, f"card vs CPU AMP first update of "
            f"{upd_name} differs by {upd:.3e} > {AMP_UPDATE_RTOL} * lr = "
            f"{upd_limit:.3e} where the CPU gradient is at least "
            f"{AMP_UPDATE_GRAD_FLOOR} of its largest")
    worst, worst_name = max((float(np.abs(pg[n] - pc[n]).max()), n)
                            for n in params)
    require(worst <= 2 * AMP_SMALL_LR, f"card vs CPU AMP parameter "
            f"{worst_name} differs by {worst:.3e} after the first update > "
            f"2 * lr = {2 * AMP_SMALL_LR:.3e}")
    log(f"  first loss {lg:.6f} (card) vs {lc:.6f} (CPU), within {rel:.3e} "
        f"(rtol {limit}); the first update within {upd:.3e} on {held} of "
        f"{total} entries ({upd_name}; limit {AMP_UPDATE_RTOL} * lr = "
        f"{upd_limit:.3e}), its sign apart at {flipped} entries in all; "
        f"parameters within {worst:.3e} ({worst_name}; limit 2 * lr = "
        f"{2 * AMP_SMALL_LR:.3e})")
    return {"first_loss": {"cuda": lg, "cpu": lc}, "first_loss_rel_err": rel,
            "update_max_abs_err": upd, "update_limit": upd_limit,
            "update_entries_held": held, "update_entries": total,
            "update_sign_apart": flipped,
            "param_max_abs_err_first_step": worst,
            "param_limit": 2 * AMP_SMALL_LR}


def card_vs_cpu_two_lane(torch, np, seed, decode_steps=3):
    """A 2-layer gpt3_1p3b-width GPT through the two_lane lanes on the
    card (K13, K1) and on the CPU (plain versions): one prefill call of
    three prompts (37, 100 and 16 tokens in a 128 window), then three
    decode steps over 4 lanes (one idle). Tokens equal; pools within
    1e-5 (float32 sums in another order)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import (CacheGeometry, DecodeStepModel,
                                             PrefillStepModel)
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2,
                    num_heads=16, ffn_size=8192, max_position=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    L, H, D = cfg.num_layers, cfg.num_heads, HIDDEN // 16
    params = _np_params(np, cfg, seed)
    rng = np.random.RandomState(seed)
    lanes, bucket, P, ps, maxp = 4, 128, 48, PAGE, 64
    lens = [37, 100, 16]
    n = len(lens)
    tokens = np.zeros((n, bucket), np.int64)
    tables = np.zeros((lanes, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b, m in enumerate(lens):
        tokens[b, :m] = rng.randint(0, VOCAB, m)
        k = -(-(m + decode_steps) // ps)
        tables[b, :k] = [free.pop() for _ in range(k)]
    pools0 = [rng.randn(H, P, ps, D).astype(np.float32) for _ in range(2 * L)]
    out = {}
    for dev in ("cpu", DEVICE):
        pred = Predictor(Config().set_params(cfg, params), device=dev)
        geom = CacheGeometry(P, ps, maxp)
        prefill = PrefillStepModel(pred.lm, geom)
        decode = DecodeStepModel(pred.lm, geom)
        pools = [torch.as_tensor(a).to(dev) for a in pools0]
        t = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a)).to(  # noqa: E731
            device=dev, dtype=dt)
        K.reset_launch_counts()
        toks = [prefill(t(tokens, torch.long), t(lens), t(tables[:n]),
                        pools[:L], pools[L:]).cpu().numpy()]
        length = list(lens)
        cur = np.zeros(lanes, np.int64)
        cur[:n] = toks[0]
        for _ in range(decode_steps):
            active = np.array([1] * n + [0] * (lanes - n), np.int32)
            pos = np.array(length + [0] * (lanes - n), np.int32)
            nxt = decode(t(cur, torch.long), t(pos), t(active),
                         t(np.where(active > 0, pos + 1, 0)), t(tables),
                         pools[:L], pools[L:]).cpu().numpy()
            toks.append(nxt[:n])
            cur = nxt
            length = [m + 1 for m in length]
        counts = K.launch_counts()
        out[dev] = (np.stack(toks), [p.cpu() for p in pools])
        if dev == DEVICE:
            want = {"paged_attention": L * decode_steps,
                    "layer_norm": (2 * L + 1) * (1 + decode_steps),
                    "ragged_paged_attention": 0}
            got = {k: counts[k] for k in want}
            require(got == want, f"the card's lanes launched {got}, want "
                    f"{want}")
    (tg, pg), (tc, pc) = out[DEVICE], out["cpu"]
    require(np.array_equal(tg, tc), f"card tokens {tg.tolist()} != CPU "
            f"{tc.tolist()}")
    worst = 0.0
    for a, c in zip(pg, pc):
        d = (a - c).abs()
        d[:, 0, 0] = 0    # the junk slot: idle-lane writes in no set order
        worst = max(worst, float(d.max()))
    require(worst <= 1e-5, f"card vs CPU pools differ by {worst:.3e} > 1e-5")
    log(f"  tokens equal at the prefill and {decode_steps} decode steps "
        f"({tg.size} tokens); pools within {worst:.3e} (limit 1e-5)")
    return {"tokens_equal": True, "pool_max_abs_err": worst,
            "tokens": tg.tolist()}


# -- phase 7: gpt3_1p3b quantized and multi-adapter ---------------------------------


# the teacher-forced oracle's slack, of max|logit|: float32 noise (1e-3,
# phase 3's); fp8 rounds every activation to bfloat16 before its
# product, so the engine's and the predictor's float32 attention
# differences can flip a bfloat16 rounding: one bfloat16 step (2^-8)
ORACLE_REL = {"int8": 1e-3, "int8_block": 1e-3, "fp8": 2.0 ** -8}


def quantized_predictor(torch, seed, cfg, mode):
    """Phase 3's seeded weights, quantized at load (``mode``)."""
    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.inference import Config, Predictor

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shapes = {n: tuple(p.shape)
              for n, p in GPTLM(cfg, device="meta").jax_params().items()}
    params = make_params(torch, shapes, cfg.initializer_range, gen)
    pred = Predictor(Config().set_params(cfg, params)
                     .enable_weight_quantization(mode), device=DEVICE)
    del params
    torch.cuda.empty_cache()
    rep = pred.quantize_report
    qrows = [r for r in rep.rows if r["action"] == "quantized"]
    ratio = (sum(r["bytes_after"] for r in qrows)
             / sum(r["bytes_before"] for r in qrows))
    log(f"  {mode}: quantize_report.summary() {json.dumps(rep.summary())}; "
        f"matmul weights {ratio:.4f} of their float32 bytes")
    require(rep.n_quantized == 4 * cfg.num_layers + 1,
            f"{rep.n_quantized} weights quantized")
    require(ratio <= 0.30, f"matmul weight bytes ratio {ratio:.4f} > 0.30")
    return pred, {"summary": rep.summary(), "matmul_bytes_ratio": ratio}


def require_launches(counts, steps, per_step):
    want = {n: c * steps for n, c in per_step.items()}
    got = {n: counts[n] for n in per_step}
    require(got == want, f"{steps} steps launched {got}, want {want}")


def adapter_factors(torch, store, seed):
    """Four seeded adapters, two per rank bucket; ad2 is partial (the
    ffn targets only)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    names = sorted(store.targets)
    spec = (("ad0", 8, names), ("ad1", 16, names),
            ("ad2", 8, [t for t in names if "_ffn" in t]),
            ("ad3", 16, names))
    out = []
    for aid, r, ts in spec:
        fac = {t: (0.02 * torch.randn(store.targets[t][0], r, device=DEVICE,
                                      generator=gen),
                   0.02 * torch.randn(r, store.targets[t][1], device=DEVICE,
                                      generator=gen))
               for t in ts}
        out.append((aid, fac, 2.0 * r))
    return out


def serve_quantized(torch, np, seed, card, out_dir, base_tokens=None,
                    profile=False):
    """Phase 7: gpt3_1p3b at full width and depth, served (7a) with
    int8, int8_block and fp8 weights over float32 pages, then (7b) with
    int8 weights, int8 pages and four adapters in two rank buckets, and
    (7c) held to the slot-0 and dedicated-engine identities."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.adapters import AdapterStore
    from paddle_tpu_torch.generation import GenerationEngine, PagedKVCache
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    L = cfg.num_layers
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    max_new = 32
    record, paths = {}, {}
    pred_int8 = None
    from paddle_tpu_torch import get_flags, set_flags

    saved_block = get_flags("quantize_block")["quantize_block"]
    # int8_block at a block that is not a multiple of 16 runs the FMA
    # kernel (quantized_matmul_fma) in place of the tensor-core one
    for mode, n_req, block in (("int8", 16, 256), ("int8_block", 4, 256),
                               ("fp8", 4, 256), ("int8_block", 2, 100)):
        key = mode if block == 256 else f"{mode}_b{block}"
        log(f"phase 7a: gpt3_1p3b, {mode} weights (block {block}), float32 "
            f"KV, {n_req} requests")
        set_flags({"quantize_block": block})
        pred, rep = quantized_predictor(torch, seed, cfg, mode)
        eng = GenerationEngine(pred, cfg, warmup=True)
        set_flags({"quantize_block": saved_block})
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        prof = start_profile(torch) if profile and mode == "int8" else None
        streams, wall = run_clients(eng, prompts, max_new, ids=range(n_req))
        if prof is not None:
            prof.__exit__(None, None, None)
        counts = K.launch_counts()
        st = eng.stats()
        check_streams(streams, max_new)
        steps = st["ragged_steps_total"]
        odd = block % 16 != 0
        require_launches(counts, steps, {
            "quantized_matmul": 0 if odd else 4 * L + 1,
            "quantized_matmul_fma": 4 * L + 1 if odd else 0,
            "layer_norm": 2 * L + 1,
            "ragged_paged_attention": L, "ragged_paged_attention_q": 0,
            "batched_lora_add_": 0})
        log(f"  engine steps {steps}; launches {counts}")
        require_graphed(st, steps, f"phase 7a {key}")
        perf = serving_perf(torch, st, streams, wall, lengths, card)
        if mode == "int8":
            perf["graph_vs_eager"] = check_graph_vs_eager(
                torch, np, eng, prompts, what=f"phase 7a {key}")
        eng.close()
        del eng
        oracle(np, pred, prompts, streams, rel=ORACLE_REL[mode])
        perf.update(rep, launches=counts)
        if prof is not None:
            perf["profile"] = trace_breakdown(prof, out_dir, "serve_int8",
                                              wall)
        record[f"7a_{key}"] = perf
        paths[f"serve_{key}"] = counts
        if mode == "int8":
            pred_int8 = pred
        # a stream holds its engine, and so its page pool: drop them
        # before the next run's peak is read
        del pred, streams
        torch.cuda.empty_cache()

    log("phase 7b: gpt3_1p3b, int8 weights, int8 KV, 4 adapters in rank "
        "buckets 8 and 16")
    pred = pred_int8
    store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=4)
    eng = GenerationEngine(pred, cfg, kv_dtype="int8", adapter_store=store,
                           warmup=True)
    ads = adapter_factors(torch, store, seed)
    for aid, fac, alpha in ads:
        store.upload(aid, fac, alpha=alpha)
    # requests 0, 4, 8, 12 are base-only; the other 12 name ad0..ad3
    named = [i for i in range(16) if i % 4]
    adapters = [None] * 16
    for k, i in enumerate(named):
        adapters[i] = f"ad{k % 4}"
    # 67,584 / 262,144 at 16 kv heads x 16 slots x 128
    geom = (eng.cache.num_kv_heads, eng.cache.head_dim, eng.page_size)
    want_ratio = (PagedKVCache.page_bytes(*geom, "int8")
                  / PagedKVCache.page_bytes(*geom, "float32"))
    pool_ratio = eng.cache.pool_bytes() / (
        L * eng.num_pages * PagedKVCache.page_bytes(*geom, "float32"))
    require(pool_ratio == want_ratio and eng.cache.pool_bytes() == L
            * eng.num_pages * 2 * (geom[0] * geom[2] * (geom[1] + 4)),
            f"int8 pool is {pool_ratio} of the float32 pool, want "
            f"{want_ratio}")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    prof = start_profile(torch) if profile else None
    streams, wall = run_clients(eng, prompts, max_new, adapters)
    if prof is not None:
        prof.__exit__(None, None, None)
    counts = K.launch_counts()
    st = eng.stats()
    check_streams(streams, max_new)
    steps = st["ragged_steps_total"]
    require_launches(counts, steps, {
        "quantized_matmul": 4 * L + 1, "layer_norm": 2 * L + 1,
        "ragged_paged_attention_q": L, "batched_lora_add_": 4 * L + 1,
        "ragged_paged_attention": 0})
    require_graphed(st, steps, "phase 7b")
    require(st["cache"]["pages_in_use"] == 0, "pages left in use")
    eng.cache.check_integrity()
    require(all(r["refcount"] == 0 for r in store.resident()),
            "an adapter is still pinned")
    log(f"  engine steps {steps}; launches {counts}; int8 pool "
        f"{eng.cache.pool_bytes()} B = {pool_ratio:.6f} of float32")
    perf = serving_perf(torch, st, streams, wall, lengths, card)
    perf.update(launches=counts, pool_bytes=eng.cache.pool_bytes(),
                pool_ratio=pool_ratio, adapters=adapters,
                residents=store.resident())
    if prof is not None:
        perf["profile"] = trace_breakdown(prof, out_dir, "serve_lora", wall)
    perf["graph_vs_eager"] = check_graph_vs_eager(torch, np, eng, prompts,
                                                  adapters, what="phase 7b")
    del eng, streams
    torch.cuda.empty_cache()
    record["7b"] = perf
    paths["serve_lora"] = counts
    mixed = perf["tokens"]

    log("phase 7c: the identities: base rows vs an engine without a store, "
        "adapter rows vs dedicated engines")
    with GenerationEngine(pred, cfg, kv_dtype="int8") as base_eng:
        K.reset_launch_counts()
        bstreams, _ = run_clients(base_eng, prompts, max_new)
        paths["serve_int8_kv"] = K.launch_counts()
        bst = base_eng.stats()
        require_graphed(bst, bst["ragged_steps_total"], "phase 7c, no store")
    check_streams(bstreams, max_new)
    base = [list(s.tokens) for s in bstreams]
    for i in range(0, 16, 4):
        require(mixed[i] == base[i], f"base row {i} differs from the engine "
                f"without adapters: {mixed[i]} vs {base[i]}")
    changed = [i for i in named if mixed[i] != base[i]]
    require(changed, "no adapter changed any token")
    dedicated = {}
    for bucket_aid in ("ad0", "ad1"):       # one of each rank bucket
        i = adapters.index(bucket_aid)
        aid, fac, alpha = next(a for a in ads if a[0] == bucket_aid)
        solo = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                      slots_per_bucket=4)
        solo.upload(aid, fac, alpha=alpha)
        with GenerationEngine(pred, cfg, kv_dtype="int8",
                              adapter_store=solo) as seng:
            out = seng.generate(prompts[i], max_new_tokens=max_new,
                                adapter=aid, timeout=600)
            sst = seng.stats()
            require_graphed(sst, sst["ragged_steps_total"],
                            f"phase 7c, dedicated {aid}")
        require(out == mixed[i], f"request {i} ({aid}) differs from a "
                f"dedicated engine: {mixed[i]} vs {out}")
        dedicated[aid] = i
    agree = None
    if base_tokens is not None:
        pos = [(a == b) for i in range(0, 16, 4)
               for a, b in zip(mixed[i], base_tokens[i])]
        agree = sum(pos) / len(pos)
    log(f"  base rows equal the store-less engine; {len(changed)} of 12 "
        f"adapter rows differ from their base tokens; requests "
        f"{dedicated} equal dedicated engines; base rows agree with phase "
        f"3's float32 tokens at {agree} of positions (reported, not gated) "
        f"[{card}]")
    record["7c"] = {"adapter_rows_changed": len(changed),
                    "dedicated": dedicated,
                    "base_vs_float32_agreement": agree}
    del pred, pred_int8
    return paths, record


# -- phase 8: ResNet-50 trained by fused Momentum with L2 decay ------------------------


def train_resnet(torch, np, seed, card, out_dir, profile=False, steps=10):
    """ResNet-50 (25.56 M parameters, 161 of them) at the JAX bench's
    batch 64 x 224^2, float32 NCHW, trained by Momentum 0.9 + L2Decay
    1e-4 at lr 0.1 x 64 / 256 with the fused update: K10m 161 times, K4
    and K5 once, every step; the BN running statistics move."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_resnet50(
            1000, RESNET_IMAGE, resnet_optimizer(fluid), data_format="NCHW")
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_momentum") == 161 and "momentum" not in types,
            f"the program holds {types.count('fused_momentum')} "
            "fused_momentum ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    require(n_params == 25_557_032, f"{n_params} parameters")
    batch = synthetic_image_batch(np.random.RandomState(seed), RESNET_BATCH,
                                  RESNET_IMAGE)
    stats = ("stem.bn.mean", "stem.bn.var", "s3b2.b2.bn.mean",
             "s3b2.b2.bn.var")
    before = {n: scope.find_var(n).clone() for n in stats}
    want = {name: 0 for name in K.KERNELS}
    want.update(fused_momentum_update=161, softmax_xent_fwd=1,
                softmax_xent_bwd=1)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, RESNET_BATCH, card,
                             out_dir, "resnet", profile, unit="images")
    moved = {n: float((scope.find_var(n) - before[n]).abs().max())
             for n in stats}
    require(all(v > 0 for v in moved.values()),
            f"BN running statistics did not move: {moved}")
    log(f"  BN running statistics moved (max |change|): {moved}")
    perf.update(parameters=n_params, batch=RESNET_BATCH,
                image_size=RESNET_IMAGE, lr=resnet_lr(RESNET_BATCH),
                bn_stats_moved=moved)
    return totals, perf


# -- phase 9: ResNet-50 trained under bfloat16 AMP ------------------------------------


def amp_adam(fluid, lr):
    """The JAX bench's AMP recipe (bench.py:248-250)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorate

    return decorate(fluid.optimizer.AdamOptimizer(lr), init_loss_scaling=1.0,
                    use_dynamic_loss_scaling=False, dest_dtype="bfloat16")


def train_resnet_amp(torch, np, seed, card, out_dir, profile=False, steps=10,
                     fp32=None):
    """ResNet-50 as the JAX bench trains it (bench.py:120, :248-250):
    batch 64 x 224^2, NCHW, Adam(1e-4) under ``decorate(...,
    dest_dtype="bfloat16")``: the 53 convolutions and the head's mul in
    bfloat16 (158 casts), batch norm, relu, the adds and the pools in
    float32, fused Adam: K10 161 times, K4 and K5 once, every step.
    ``fp32`` is phase 8's record, printed beside."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_resnet50(
            1000, RESNET_IMAGE, amp_adam(fluid, 1e-4), data_format="NCHW")
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_adam") == 161 and "adam" not in types
            and types.count("cast") == 158 and len(types) == 853,
            f"the program holds {len(types)} ops, "
            f"{types.count('fused_adam')} fused_adam, {types.count('cast')} "
            "casts")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    require(n_params == 25_557_032, f"{n_params} parameters")
    batch = synthetic_image_batch(np.random.RandomState(seed), RESNET_BATCH,
                                  RESNET_IMAGE)
    want = {name: 0 for name in K.KERNELS}
    want.update(fused_adam_update=161, softmax_xent_fwd=1,
                softmax_xent_bwd=1)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, RESNET_BATCH, card,
                             out_dir, "resnet_amp", profile, unit="images")
    perf.update(parameters=n_params, batch=RESNET_BATCH,
                image_size=RESNET_IMAGE, lr=1e-4, amp="bfloat16")
    if fp32 is not None:
        log(f"  beside phase 8 (float32, fused Momentum): mean step "
            f"{fp32['step_ms_mean']:.3f} ms, {fp32['images_per_s']:.2f} "
            f"images/s, max_memory_allocated "
            f"{fp32['max_memory_allocated_gb']:.2f} GB; here "
            f"{perf['step_ms_mean']:.3f} ms, {perf['images_per_s']:.2f} "
            f"images/s, {perf['max_memory_allocated_gb']:.2f} GB [{card}]")
    return totals, perf


# -- phase a: speculative decoding and the radix prefix cache ------------------------

SPEC_TOKENS = 6            # the JAX bench's --spec setting
RADIX_PREFIX = 512         # tokens of the shared prefix: 32 full pages


class GarbageDraft:
    """A draft that always proposes token 1: every draft is rejected
    (a stand-in for a draft that silently fails)."""

    def propose(self, contexts, k):
        import numpy as np

        return [np.full(k, 1, np.int64) for _ in contexts]


def timed_propose(draft):
    """Times each ``propose`` call of ``draft`` (ms, host clock; the
    proposals come back as numpy, so the call ends synchronised)."""
    times = []
    inner = draft.propose

    def propose(contexts, k):
        t0 = time.perf_counter()
        out = inner(contexts, k)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    draft.propose = propose
    return times


def first_difference(np, pred, prompt, mine, theirs):
    """Where two greedy continuations of one prompt first differ, the
    teacher-forced logits there (their shared context): (index, top-2
    gap, max|logit|)."""
    k = next(i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b)
    ctx = np.concatenate([prompt, np.asarray(mine[:k], np.int64)])
    logits = lm_logits(pred, ctx[None])
    row = np.sort(logits[0, -1])
    return k, float(row[-1] - row[-2]), float(np.abs(row).max())


def same_or_near_tie(np, pred, prompts, streams, base, what):
    """Streams equal ``base`` token for token; where one differs, it first
    differs where the teacher-forced top-2 gap is within 1e-3 of
    max|logit| (phase a's rule). Returns (identical, first differences)."""
    same, diffs = 0, []
    for i, s in enumerate(streams):
        mine = list(s.tokens) if hasattr(s, "tokens") else list(s)
        if mine == list(base[i]):
            same += 1
            continue
        k, gap, top = first_difference(np, pred, prompts[i], mine,
                                       list(base[i]))
        diffs.append({"request": i, "index": k, "top2_gap": gap,
                      "max_abs_logit": top})
        require(gap <= 1e-3 * top, f"{what}: request {i} leaves the "
                f"reference at token {k}, where the top-2 gap {gap:.3e} is "
                f"past 1e-3 of max|logit| {top:.3e}")
    log(f"  {what}: {same} of {len(streams)} streams identical to the "
        f"reference; first differences {diffs}")
    return same, diffs


SPEC_PROMPTS = 4    # phase a's spec runs: the first 4 of phase 3's prompts


def serve_spec(torch, np, seed, card, out_dir, base_tokens=None):
    """Phase a, spec: phase 3's weights and first ``SPEC_PROMPTS``
    prompts served with
    ``spec_tokens=6`` and a full-replica, a 2-layer and a garbage draft,
    then held to a spec-off run of the same prompts."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import GenerationEngine, HostDraft

    cfg, pred = gpt3_predictor(torch, seed)
    lengths, every_prompt = serving_prompts(np, seed, cfg.vocab_size)
    lengths, prompts = lengths[:SPEC_PROMPTS], every_prompt[:SPEC_PROMPTS]
    if base_tokens is not None:
        base_tokens = base_tokens[:SPEC_PROMPTS]
    max_new, L = 32, cfg.num_layers
    paths, out = {}, {}
    if base_tokens is None:
        eng = GenerationEngine(pred, cfg, warmup=True)
        streams, _ = run_clients(eng, prompts, max_new)
        check_streams(streams, max_new)
        base_tokens = [list(s.tokens) for s in streams]
        eng.close()
        del eng
    drafts = (("replica", lambda: HostDraft.from_predictor(pred, cfg)),
              ("truncated", lambda: HostDraft.from_predictor(
                  pred, cfg, num_layers=2)),
              ("garbage", GarbageDraft))
    for name, make in drafts:
        what = f"phase a spec {name}"
        draft = make()
        if name != "garbage":
            params = list(draft.params.values())
            require(draft.device.type == "cuda"
                    and all(t.is_cuda for t in params),
                    f"{what}: the draft's tensors are not on the card")
            shared = pred.lm.jax_params()
            require(all(draft.params[n].data_ptr() == shared[n].data_ptr()
                        for n in draft.params),
                    f"{what}: the draft copied the predictor's weights")
        t0 = time.perf_counter()
        eng = GenerationEngine(pred, cfg, draft=draft,
                               spec_tokens=SPEC_TOKENS, warmup=True)
        log(f"  {what}: engine ready in {time.perf_counter() - t0:.1f} s "
            f"(chunk {eng.chunk_tokens}, draft rows {getattr(draft, 'min_rows', '-')})")
        times = timed_propose(draft)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        streams, wall = run_clients(eng, prompts, max_new)
        counts = K.launch_counts()
        paths[f"spec_{name}"] = counts
        st = eng.stats()
        check_streams(streams, max_new)
        steps = st["ragged_steps_total"]
        require(counts["ragged_paged_attention"] == L * steps
                and counts["layer_norm"] == (2 * L + 1) * steps,
                f"{what}: {steps} steps launched {counts}")
        require_graphed(st, steps, what)
        require(st["spec_proposed_total"] > 0 and times,
                f"{what}: no drafts were proposed")
        if name == "replica":
            require(st["spec_acceptance_rate"] > 0.5,
                    f"{what}: acceptance {st['spec_acceptance_rate']}")
        perf = serving_perf(torch, st, streams, wall, lengths, card,
                            what=f"served ({what})")
        perf.update(
            spec_rounds=st["spec_rounds_total"],
            spec_proposed=st["spec_proposed_total"],
            spec_accepted=st["spec_accepted_total"],
            acceptance=st["spec_acceptance_rate"],
            accepted_tokens_per_step=st["spec_accepted_tokens_per_step"],
            propose_calls=len(times),
            propose_ms_mean=statistics.mean(times) if times else None,
            propose_ms_p50=statistics.median(times) if times else None,
            draft_share_of_wall=sum(times) / 1e3 / wall)
        log(f"  {what}: acceptance {perf['acceptance']}, accepted tokens a "
            f"spec round {perf['accepted_tokens_per_step']} "
            f"({perf['spec_accepted']} of {perf['spec_proposed']} drafts, "
            f"{perf['spec_rounds']} rounds); the draft: {len(times)} "
            f"proposes, mean {perf['propose_ms_mean']:.3f} ms, p50 "
            f"{perf['propose_ms_p50']:.3f} ms a propose, "
            f"{perf['draft_share_of_wall']:.4f} of the wall time [{card}]")
        oracle(np, pred, prompts, streams, ids=range(len(prompts)))
        same, diffs = same_or_near_tie(np, pred, prompts, streams,
                                       base_tokens, f"{what} (the spec-off "
                                       "run's tokens)")
        perf.update(identical_to_spec_off=same, differences=diffs)
        if name == "replica":
            # ten recorded requests: over every prompt
            perf["graph_vs_eager"] = check_graph_vs_eager(
                torch, np, eng, every_prompt, what=what)
        else:
            eng.close()
        out[name] = perf
        del eng, draft
        torch.cuda.empty_cache()
    return paths, out


def radix_prompts(np, seed, vocab):
    """A 512-token shared prefix, then 16 prompts of it plus distinct
    8..64-token suffixes."""
    rng = np.random.RandomState(seed + 7)
    prefix = rng.randint(0, vocab, size=RADIX_PREFIX).astype(np.int64)
    suffixes = rng.randint(8, 65, size=16)
    return prefix, [np.concatenate([prefix, rng.randint(
        0, vocab, size=n).astype(np.int64)]) for n in suffixes]


def serve_radix(torch, np, seed, card, out_dir):
    """Phase a, radix: a seed request publishes the shared prefix, then
    16 requests over it are served warm (``prefix_cache=True``) and cold,
    over float32 and int8 KV pages."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import GenerationEngine

    cfg, pred = gpt3_predictor(torch, seed)
    prefix, prompts = radix_prompts(np, seed, cfg.vocab_size)
    lengths = [len(p) for p in prompts]
    max_new, L = 32, cfg.num_layers
    paths, out = {}, {}
    for kv in ("float32", "int8"):
        toks = {}
        for warm in (True, False):
            what = f"phase a radix {kv} {'warm' if warm else 'cold'}"
            eng = GenerationEngine(pred, cfg, kv_dtype=kv, prefix_cache=warm,
                                   warmup=True)
            seed_toks = eng.generate(prefix, max_new_tokens=max_new,
                                     timeout=600)
            before = eng.stats()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            submitted = {}
            streams, wall = run_clients(eng, prompts, max_new,
                                        submitted=submitted)
            counts = K.launch_counts()
            paths[f"radix_{kv}_{'warm' if warm else 'cold'}"] = counts
            st = eng.stats()
            perf = serving_perf(torch, st, streams, wall, lengths, card,
                                what=f"served ({what})")
            check_streams(streams, max_new)
            steps = st["ragged_steps_total"] - before["ragged_steps_total"]
            attn = ("ragged_paged_attention_q" if kv == "int8"
                    else "ragged_paged_attention")
            require(counts[attn] == L * steps
                    and counts["layer_norm"] == (2 * L + 1) * steps,
                    f"{what}: {steps} steps launched {counts}")
            require(st["graph_replays"] == st["ragged_steps_total"],
                    f"{what}: {st['graph_replays']} replays for "
                    f"{st['ragged_steps_total']} steps")
            r = st["radix"]
            hit = r["prefix_hit_tokens_total"]
            if warm:
                require(hit >= 15 * RADIX_PREFIX,
                        f"{what}: {hit} prefix hit tokens < 15 x "
                        f"{RADIX_PREFIX}")
            eng.cache.check_integrity()
            # the peak shared / private pages, read by a sampler that
            # takes the cache lock: in a second serve of the same traffic
            # after the timed one, so that it costs the timed run nothing
            eng.cache.drop_trie()
            eng.generate(prefix, max_new_tokens=max_new, timeout=600)
            peak = {"shared_pages": 0, "private_pages": 0}
            stop = threading.Event()

            def sample():
                while not stop.is_set():
                    rs = eng.cache.radix_stats()
                    for key in peak:
                        peak[key] = max(peak[key], rs[key])
                    time.sleep(0.002)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            again, _ = run_clients(eng, prompts, max_new)
            stop.set()
            sampler.join()
            require([list(s.tokens) for s in again]
                    == [list(s.tokens) for s in streams],
                    f"{what}: a second serve of the same requests gave "
                    "other tokens")
            eng.cache.check_integrity()
            eng.close()
            eng.cache.check_integrity()
            eng.cache.drop_trie()
            eng.cache.check_integrity()
            in_use = eng.stats()["cache"]["pages_in_use"]
            require(in_use == 0, f"{what}: {in_use} pages in use after "
                    "drop_trie")
            # each request's TTFT from its own submit (the engine's
            # histogram holds the seed request too); the first wave is
            # the first 8 submitted (one a lane)
            ttft = {i: (s.first_token_at - submitted[i]) * 1e3
                    for i, s in enumerate(streams)}
            wave = sorted(submitted, key=submitted.get)[:eng.lanes]
            perf.update(ttft_ms_requests_p50=statistics.median(
                            ttft.values()),
                        ttft_ms_first_wave_p50=statistics.median(
                            ttft[i] for i in wave),
                        prefix_hit_rate=r["prefix_hit_rate"],
                        prefix_hit_tokens=hit,
                        prefill_tokens=st["prefill_tokens_total"],
                        peak_shared_pages=peak["shared_pages"],
                        peak_private_pages=peak["private_pages"],
                        trie_pages=r["trie_pages"])
            log(f"  {what}: TTFT of the 16 requests p50 "
                f"{perf['ttft_ms_requests_p50']:.3f} ms, of the first "
                f"{eng.lanes} submitted (one a lane) p50 "
                f"{perf['ttft_ms_first_wave_p50']:.3f} ms [{card}]")
            log(f"  {what}: prefix_hit_rate {r['prefix_hit_rate']} ({hit} "
                f"hit tokens, {st['prefill_tokens_total']} prefilled), peak "
                f"shared {peak['shared_pages']} / private "
                f"{peak['private_pages']} pages (in an untimed second "
                f"serve), trie {r['trie_pages']} "
                f"pages; check_integrity holds, 0 pages in use after "
                f"drop_trie [{card}]")
            if kv == "float32" and warm:
                oracle(np, pred, prompts, streams)
            toks[warm] = [seed_toks] + [list(s.tokens) for s in streams]
            out[f"{kv}_{'warm' if warm else 'cold'}"] = perf
            del eng
            torch.cuda.empty_cache()
        require(toks[True] == toks[False],
                f"phase a radix {kv}: warm tokens differ from cold ones in "
                f"{sum(a != b for a, b in zip(toks[True], toks[False]))} "
                "streams")
        w, c = out[kv + "_warm"], out[kv + "_cold"]
        log(f"  phase a radix {kv}: warm tokens equal cold ones in all "
            f"{len(toks[True])} streams; TTFT p50 warm "
            f"{w['ttft_ms_requests_p50']:.3f} ms against cold "
            f"{c['ttft_ms_requests_p50']:.3f} ms (first wave "
            f"{w['ttft_ms_first_wave_p50']:.3f} against "
            f"{c['ttft_ms_first_wave_p50']:.3f}), tokens/s "
            f"{w['tokens_per_s']:.2f} against {c['tokens_per_s']:.2f} "
            f"[{card}]")
    return paths, out


# -- main ---------------------------------------------------------------------------


# -- phase b: save and serve Programs over HTTP ----------------------------------

RESNET_BUCKETS = (1, 2, 4, 8, 16, 32)
RESNET_REQUESTS, RESNET_IMAGE = 16, 224
HTTP_CLIENTS = 8
# a request's outputs against its solo run on the card and against the
# CPU: the same weights, float32 sums in another order (cuDNN picks its
# convolution algorithm by batch size; the CPU has its own), about 1e-6
# relative a layer over 53 convolutions: the softmax within 1e-4 (it is
# <= 1), the logits within 1e-4 of the request's max |logit|
RESNET_PROB_ATOL = RESNET_LOGIT_REL = 1e-4
LM_PROGRAM_SEQ, LM_PROGRAM_BATCH = 128, 2
LM_PROGRAM_LAYERS = 6     # b2's depth, of gpt3_1p3b's 24
SWAP_STD = 0.02


def http_call(conn, method, path, payload=None, headers=None, body=None):
    """One request on a keep-alive connection: (status, JSON body or
    text, response)."""
    if body is None and payload is not None:
        body = json.dumps(payload).encode()
    h = {"Content-Type": "application/json"} if body is not None else {}
    h.update(headers or {})
    conn.request(method, path, body=body, headers=h)
    r = conn.getresponse()
    raw = r.read()
    try:
        data = json.loads(raw)
    except ValueError:
        data = raw.decode(errors="replace")
    return r.status, data, r


def pct(values, q):
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(round(q * (len(vs) - 1))))]


def threaded(n, work):
    """``work(c)`` on ``n`` threads; raises on a hung thread or an error."""
    errors = []

    def run(c):
        try:
            work(c)
        except Exception as e:  # noqa: BLE001 — recorded, fails the phase below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(c,)) for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(not errors, f"client errors: {errors[:3]}")


def serve_resnet_http(torch, np, seed, card, tmp):
    """b1: ResNet-50 saved for inference, loaded with batch bucketing
    and served by a 2-worker ServingEngine, over /v1/predict and in
    process; every request held to its solo run, two to the CPU."""
    import http.client

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.resnet import build_resnet50
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    main, startup, _feeds, _fetches = build_resnet50(1000, RESNET_IMAGE)
    test = main.clone(for_test=True)
    softmax = [op for op in test.global_block().ops if op.type == "softmax"]
    prob, logits = softmax[-1].output("Out")[0], softmax[-1].input("X")[0]
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    d = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["image"], [prob, logits], exe,
                                      test)
    t_save = time.perf_counter() - t0
    del exe, scope
    t0 = time.perf_counter()
    cfg = Config(d)
    cfg.enable_shape_bucketing(batch_buckets=RESNET_BUCKETS)
    pred = create_predictor(cfg)
    t_load = time.perf_counter() - t0
    n_ops = len(pred._program.global_block().ops)
    log(f"  saved {n_params} parameters in {t_save:.2f} s, loaded in "
        f"{t_load:.2f} s: {n_ops} inference ops, batch buckets "
        f"{RESNET_BUCKETS}")
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 5, size=RESNET_REQUESTS)
    images = [rng.randn(int(n), 3, RESNET_IMAGE, RESNET_IMAGE)
              .astype(np.float32) for n in sizes]
    n_images = int(sizes.sum())
    # first calls at each bucket (cuDNN's kernels load lazily) are set-up
    for b in RESNET_BUCKETS:
        pred.run([np.zeros((b, 3, RESNET_IMAGE, RESNET_IMAGE), np.float32)])
    solo = [pred.run([x]) for x in images]
    torch.cuda.synchronize()
    full = np.zeros((RESNET_BUCKETS[-1], 3, RESNET_IMAGE, RESNET_IMAGE),
                    np.float32)
    run_ms = device_ms(torch, lambda: pred.run([full]), reps=5, inner=1)
    # the true output shapes of every batch size the engine can assemble
    # (the plan on meta tensors, once a signature): set-up, as the
    # reference's eval_shape is, timed here
    t0 = time.perf_counter()
    for b in range(1, RESNET_BUCKETS[-1] + 1):
        pred._true_fetch_shapes({"image": full[:b]})
    shape_ms = (time.perf_counter() - t0) * 1e3 / RESNET_BUCKETS[-1]

    def off(outs, want):
        """(max |softmax - want|, max |logits - want| / max |want logits|)"""
        return (float(np.abs(outs[0] - want[0]).max()),
                float(np.abs(outs[1] - want[1]).max()
                      / np.abs(want[1]).max()))

    cpu = create_predictor(Config(d), device="cpu")
    cpu_err = [max(e) for e in zip(*(off(solo[i], cpu.run([images[i]]))
                                     for i in (0, 1)))]
    del cpu
    require(cpu_err[0] <= RESNET_PROB_ATOL and cpu_err[1] <= RESNET_LOGIT_REL,
            f"b1: the card's (softmax, logits) are {cpu_err} from the CPU's "
            f"(limits {RESNET_PROB_ATOL}, {RESNET_LOGIT_REL} of max|logit|)")
    top = np.concatenate([s[0].max(axis=1) for s in solo])
    mag = max(float(np.abs(s[1]).max()) for s in solo)
    t0 = time.perf_counter()
    bodies = [json.dumps({"inputs": {"image": x.tolist()}}).encode()
              for x in images]
    t_encode = time.perf_counter() - t0
    out = {"cpu_err": cpu_err, "save_s": t_save, "load_s": t_load,
           "top_prob_mean": float(top.mean()), "max_abs_logit": mag,
           "predictor_run_ms_at_32": run_ms, "true_shapes_ms": shape_ms,
           "requests": RESNET_REQUESTS, "images": n_images,
           "client_encode_s": t_encode,
           "request_mb": sum(len(b) for b in bodies) / 1e6, "card": card}
    for leg in ("http", "in_process"):
        eng = ServingEngine(pred, max_batch_size=32, num_workers=2)
        srv = ServingServer(eng, host="127.0.0.1", port=0) \
            if leg == "http" else None
        got = [None] * RESNET_REQUESTS
        lat = [0.0] * RESNET_REQUESTS

        def client(c, eng=eng, srv=srv, got=got, lat=lat):
            conn = (http.client.HTTPConnection(srv.host, srv.port,
                                               timeout=600)
                    if srv is not None else None)
            for i in range(c, RESNET_REQUESTS, HTTP_CLIENTS):
                t = time.perf_counter()
                if conn is None:
                    got[i] = eng.predict({"image": images[i]}, timeout=600)
                    lat[i] = time.perf_counter() - t
                else:
                    status, data, _ = http_call(conn, "POST", "/v1/predict",
                                                body=bodies[i])
                    lat[i] = time.perf_counter() - t
                    require(status == 200, f"b1 request {i}: {status} "
                            f"{str(data)[:200]}")
                    got[i] = [np.asarray(data["outputs"][n], np.float32)
                              for n in (prob, logits)]
            if conn is not None:
                conn.close()

        try:
            t0 = time.perf_counter()
            threaded(HTTP_CLIENTS, client)
            wall = time.perf_counter() - t0
            snap = eng.metrics.snapshot()
            pst = eng.predictor_stats()
        finally:
            if srv is not None:
                srv.close()
            eng.close()
        require(all(g[k].shape == s[k].shape for g, s in zip(got, solo)
                    for k in (0, 1)), "b1: an output has the wrong shape")
        err = [max(e) for e in zip(*(off(g, s) for g, s in zip(got, solo)))]
        require(err[0] <= RESNET_PROB_ATOL and err[1] <= RESNET_LOGIT_REL,
                f"b1 {leg}: a request's (softmax, logits) are {err} from its "
                f"solo run (limits {RESNET_PROB_ATOL}, {RESNET_LOGIT_REL} of "
                "max|logit|)")
        rows = n_images / max(snap["batches_total"], 1)
        res = {"wall_s": wall, "requests_per_s": RESNET_REQUESTS / wall,
               "images_per_s": n_images / wall,
               "latency_ms_p50": pct(lat, 0.5) * 1e3,
               "latency_ms_p99": pct(lat, 0.99) * 1e3,
               "batches": snap["batches_total"], "mean_batch_rows": rows,
               "batch_occupancy": snap["batch_occupancy"],
               "engine_latency_ms": snap["latency_ms"],
               "padding_waste": pst["padding_waste"],
               "bucket_hits": pst["bucket_hits"], "err_vs_solo": err}
        out[leg] = res
        log(f"  b1 {leg}: {RESNET_REQUESTS} requests ({n_images} images) in "
            f"{wall:.3f} s: {res['requests_per_s']:.2f} requests/s, "
            f"{res['images_per_s']:.2f} images/s, latency p50 "
            f"{res['latency_ms_p50']:.3f} ms p99 {res['latency_ms_p99']:.3f} "
            f"ms, {snap['batches_total']} batches of {rows:.2f} rows, "
            f"padding waste {pst['padding_waste']}, buckets "
            f"{pst['bucket_hits']}, (softmax, logits) from the solo runs "
            f"{err} [{card}]")
    log(f"  b1: request bodies {out['request_mb']:.1f} MB of JSON (encoded "
        f"by the clients in {t_encode:.2f} s, outside the timed legs); the "
        f"card's (softmax, logits of max|logit|) against the CPU's "
        f"{cpu_err}; the top class's mean probability {top.mean():.4f}, "
        f"max |logit| {mag:.3f}; one predictor run at 32 images "
        f"{run_ms:.3f} ms ({32e3 / run_ms:.1f} images/s); the true shapes "
        f"of a new batch size {shape_ms:.3f} ms on the host (32 evaluated "
        f"before the legs) [{card}]")
    del pred
    return out


def lm_program_on_card(torch, np, seed, card, tmp):
    """b2: build_lm_program at gpt3_1p3b widths and 6 of its 24 layers,
    saved,
    loaded and run as a Program on the card: logits held to the
    predictor's module, with K1's exact launches; then the same
    directory quantized at load (int8) with K11's exact launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import build_lm_program
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers = LM_PROGRAM_LAYERS
    L = cfg.num_layers
    main, startup, _feeds, fetches = build_lm_program(cfg, LM_PROGRAM_SEQ)
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    d = os.path.join(tmp, "gpt3_1p3b_lm")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    t_save = time.perf_counter() - t0
    del exe, scope
    torch.cuda.empty_cache()
    size = os.path.getsize(os.path.join(d, "__params__.npz"))
    tokens = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (LM_PROGRAM_BATCH, LM_PROGRAM_SEQ)).astype(np.int64)
    out = {"save_s": t_save, "params_bytes": size, "layers": L,
           "card": card}
    for mode in ("float32", "int8"):
        t0 = time.perf_counter()
        c = Config(d)
        if mode != "float32":
            c.enable_weight_quantization(mode)
        pred = create_predictor(c)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        (logits,) = pred.run([tokens], return_numpy=False)  # first call
        torch.cuda.synchronize()
        K.reset_launch_counts()
        (logits,) = pred.run([tokens], return_numpy=False)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        want = {"layer_norm": 2 * L + 1,
                "quantized_matmul": 4 * L + 1 if mode == "int8" else 0}
        require({n: counts[n] for n in want} == want
                and sum(counts.values()) == sum(want.values()),
                f"b2 {mode}: a Program run launched {counts}, want {want}")
        ref = pred.lm(torch.as_tensor(tokens))
        err = float((logits - ref).abs().max())
        lim = 1e-3 * float(ref.abs().max())
        require(tuple(logits.shape) == (LM_PROGRAM_BATCH, LM_PROGRAM_SEQ,
                                        cfg.vocab_size),
                f"b2 {mode}: logits {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), f"b2 {mode}: not finite")
        require(err <= lim, f"b2 {mode}: Program logits {err:.3e} from the "
                f"module's (limit {lim:.3e})")
        run_ms = device_ms(torch, lambda: pred.run([tokens],
                                                   return_numpy=False),
                           reps=5, inner=2)
        lm_ms = device_ms(torch, lambda: pred.lm(torch.as_tensor(tokens)),
                          reps=5, inner=2)
        res = {"load_s": t_load, "launches": counts, "max_abs_err": err,
               "limit": lim, "program_ms": run_ms, "module_ms": lm_ms}
        if mode == "int8":
            rep = pred.quantize_report
            qrows = [r for r in rep.rows if r["action"] == "quantized"]
            ratio = (sum(r["bytes_after"] for r in qrows)
                     / sum(r["bytes_before"] for r in qrows))
            require(rep.n_quantized == 4 * L + 1 and ratio <= 0.30,
                    f"b2: {rep.n_quantized} weights quantized, matmul bytes "
                    f"ratio {ratio:.4f}")
            res.update(summary=rep.summary(), matmul_bytes_ratio=ratio,
                       vs_float32_max_abs=float(
                           (logits.cpu() - out["float32"]["logits"])
                           .abs().max()))
        else:
            res["logits"] = logits.cpu()
        out[mode] = res
        log(f"  b2 {mode}: loaded in {t_load:.2f} s; a Program run launched "
            f"{ {n: c for n, c in counts.items() if c} }; logits "
            f"{err:.3e} from the module's (limit {lim:.3e}); a run "
            f"{run_ms:.3f} ms, the module {lm_ms:.3f} ms [{card}]")
        del pred, logits, ref
        torch.cuda.empty_cache()
    out["float32"].pop("logits")
    log(f"  b2: {L} layers, {n_params} parameters, {size / 1e9:.2f} GB of "
        f"npz saved in {t_save:.2f} s; save + float32 load "
        f"{t_save + out['float32']['load_s']:.2f} s; int8 matmul bytes "
        f"{out['int8']['matmul_bytes_ratio']:.4f} of float32, logits "
        f"{out['int8']['vs_float32_max_abs']:.3e} from float32's [{card}]")
    return {"lm_program": out["float32"]["launches"],
            "lm_program_int8": out["int8"]["launches"]}, out


def stream_generate(host, port, payload, headers=None):
    """One streamed /v1/generate: (lines, arrival seconds of each from
    the send)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    conn.request("POST", "/v1/generate", json.dumps(payload), h)
    resp = conn.getresponse()
    require(resp.status == 200, f"/v1/generate answered {resp.status}")
    require(resp.getheader("Content-Type") == "application/x-ndjson",
            f"/v1/generate content type {resp.getheader('Content-Type')}")
    lines, times = [], []
    for raw in resp:
        if raw.strip():
            lines.append(json.loads(raw))
            times.append(time.perf_counter() - t0)
    conn.close()
    return lines, times


def serve_generate_http(torch, np, eng, srv, prompts, base_tokens, card,
                        phase3_step_ms):
    """b3: phase 3's 16 prompts streamed over /v1/generate from 4 client
    threads (each request in turn), held token for token to the same
    engine in process and to phase 3; then one non-streamed request,
    one 400 and one 504."""
    import http.client

    from paddle_tpu_torch import kernels as K

    max_new, L = 32, eng.config.num_layers
    n = len(prompts)
    lines, times = [None] * n, [None] * n
    st0 = eng.stats()
    K.reset_launch_counts()

    def client(c):
        for i in range(c, n, 4):
            lines[i], times[i] = stream_generate(
                srv.host, srv.port, {"tokens": prompts[i].tolist(),
                                     "max_new_tokens": max_new},
                {"X-Request-Id": f"b3-{i}"})

    t0 = time.perf_counter()
    threaded(4, client)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    st = eng.stats()
    steps = st["ragged_steps_total"] - st0["ragged_steps_total"]
    require_launches(counts, steps, {"layer_norm": 2 * L + 1,
                                     "ragged_paged_attention": L})
    require(st["graph_replays"] - st0["graph_replays"] == steps
            and st["graph_captures"] == 1, "b3: the step did not replay its "
            "graph once a step")
    http_tokens = []
    for i, (ls, ts) in enumerate(zip(lines, times)):
        tail = ls[-1]
        require(tail.get("done") and tail["finish_reason"] == "length"
                and tail["n_tokens"] == max_new and len(ls) == max_new + 1,
                f"b3 stream {i}: {tail}")
        require(ls[0].get("index") == 0 and "token" in ls[0]
                and ls[0].get("request_id") == f"b3-{i}"
                and ts[0] < ts[-1], f"b3 stream {i}: the first line "
                f"{ls[0]} did not arrive before the done line")
        http_tokens.append([ln["token"] for ln in ls[:-1]])
    ttft = [ts[0] * 1e3 for ts in times]
    streams, _ = run_clients(eng, prompts, max_new)
    check_streams(streams, max_new)
    local = [list(s.tokens) for s in streams]
    require(http_tokens == local, "b3: streamed tokens differ from the same "
            "engine's in-process tokens")
    same3 = None
    if base_tokens is not None:
        require(http_tokens == base_tokens, "b3: streamed tokens differ from "
                "phase 3's")
        same3 = True
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
    status, data, _ = http_call(conn, "POST", "/v1/generate", {
        "tokens": prompts[0].tolist(), "max_new_tokens": 8, "stream": False})
    require(status == 200 and data["tokens"] == local[0][:8]
            and data["usage"]["prompt_tokens"] == len(prompts[0]),
            f"b3 stream=false: {status} {str(data)[:200]}")
    status, data, _ = http_call(conn, "POST", "/v1/generate", {"tokens": []})
    require(status == 400, f"b3: an empty prompt answered {status}")
    status, data, _ = http_call(conn, "POST", "/v1/generate", {
        "tokens": prompts[1].tolist(), "max_new_tokens": 8, "stream": False,
        "deadline_ms": 0.001})
    require(status == 504 and data.get("kind") == "deadline",
            f"b3: a passed deadline answered {status} {data}")
    conn.close()
    gen = sum(len(t) for t in http_tokens)
    res = {"tokens_per_s": gen / wall, "wall_s": wall, "engine_steps": steps,
           "client_ttft_ms_p50": pct(ttft, 0.5),
           "engine_ttft_ms_p50": st["ttft_ms"]["p50"],
           "step_ms_mean": st["decode_step_ms"]["mean"],
           "phase3_step_ms_mean": phase3_step_ms,
           "equal_to_phase3": same3, "launches": counts, "card": card}
    log(f"  b3: {n} streams ({gen} tokens) over /v1/generate in {wall:.3f} "
        f"s: {res['tokens_per_s']:.2f} tokens/s, {steps} steps, step "
        f"{res['step_ms_mean']} ms (phase 3: {phase3_step_ms}), client TTFT "
        f"p50 {res['client_ttft_ms_p50']:.3f} ms against the engine's "
        f"{res['engine_ttft_ms_p50']} ms; tokens equal in-process"
        f"{' and phase 3' if same3 else ''}; stream=false, 400 and 504 "
        f"answered [{card}]")
    return counts, res, local


def swap_under_traffic(torch, np, eng, srv, new_w, prompts, what,
                       adapter=None):
    """``eng.swap_base(new_w)`` while 4 HTTP clients send short
    non-streamed requests (every other one on ``adapter``): no request
    fails, the step is the same graph (no recapture), one swap."""
    import http.client

    bound = eng._ragged_bound
    replays0 = eng.stats()["graph_replays"]
    failures, done = [], []
    stop = threading.Event()

    def pump(c):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        i = c
        while not stop.is_set():
            payload = {"tokens": prompts[i % len(prompts)][:48].tolist(),
                       "max_new_tokens": 4, "stream": False}
            if adapter is not None and i % 2:
                payload["adapter"] = adapter
            status, data, _ = http_call(conn, "POST", "/v1/generate", payload)
            (done if status == 200 else failures).append(
                (status, str(data)[:200]))
            i += 4
        conn.close()

    threads = [threading.Thread(target=pump, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    try:
        while len(done) < 8 and not failures:
            time.sleep(0.01)
        before = len(done)
        t0 = time.perf_counter()
        label = eng.swap_base(new_w, version="v2")
        swap_s = time.perf_counter() - t0
        while len(done) < before + 8 and not failures:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(600)
    st = eng.stats()
    require(not any(t.is_alive() for t in threads), f"{what}: a pump hung")
    require(not failures, f"{what}: failed requests {failures[:3]}")
    require(label == "v2" and eng.model_swaps == 1
            and st["model_swaps"] == 1, f"{what}: {eng.model_swaps} swaps")
    require(eng._ragged_bound is bound and st["graph_captures"] == 1
            and st["graph_replays"] > replays0,
            f"{what}: the step was rebound or recaptured")
    log(f"  {what}: swap_base of {len(new_w)} weights under live HTTP "
        f"traffic in {swap_s:.3f} s: {len(done)} requests, none failed, the "
        f"same graph (1 capture, {st['graph_replays']} replays), "
        f"model_swaps 1")
    return {"swap_s": swap_s, "requests": len(done), "weights": len(new_w)}


def after_swap_tokens(eng, prompts, adapter=None, n=4, max_new=16):
    out = [eng.generate(p, max_new_tokens=max_new, timeout=600)
           for p in prompts[:n]]
    if adapter is not None:
        out.append(eng.generate(prompts[0], max_new_tokens=max_new,
                                adapter=adapter, timeout=600))
    return out


def proj_factors(np, cfg, seed, rank=8):
    """A rank-8 adapter on every layer's proj weight, as numpy (std
    0.05: large enough that a few proj layers move a greedy token)."""
    rng = np.random.RandomState(seed + 7)
    h = cfg.hidden_size
    return {f"dec{i}_proj.w": ((rng.randn(h, rank) * 0.05).astype(np.float32),
                               (rng.randn(rank, h) * 0.05).astype(np.float32))
            for i in range(cfg.num_layers)}


def serve_http(torch, np, seed, card, out_dir, base_tokens=None,
               phase3_step_ms=None):
    """Phase b: save and serve Programs over HTTP (b1-b4)."""
    import http.client
    import tempfile

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.adapters import AdapterStore
    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.kernels.quant_matmul import (dequantize_weight,
                                                       quantize_weight)
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    record, paths = {}, {}
    with tempfile.TemporaryDirectory(prefix="pt_phase_b_") as tmp:
        log("phase b1: ResNet-50 saved for inference, served over "
            "/v1/predict")
        t0 = time.perf_counter()
        record["b1"] = serve_resnet_http(torch, np, seed, card, tmp)
        record["b1"]["phase_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        log("phase b2: gpt3_1p3b LM Program saved, loaded and run "
            "(float32, then int8 at load)")
        t0 = time.perf_counter()
        p2, record["b2"] = lm_program_on_card(torch, np, seed, card, tmp)
        record["b2"]["phase_s"] = time.perf_counter() - t0
        paths.update(p2)
        gc.collect()
        torch.cuda.empty_cache()

    log("phase b3: phase 3's engine streamed over /v1/generate")
    t0 = time.perf_counter()
    cfg, pred = gpt3_predictor(torch, seed)
    L = cfg.num_layers
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    # every engine, and so every CUDA graph capture, before any server
    eng = GenerationEngine(pred, cfg, warmup=True)
    pred8, _rep = quantized_predictor(torch, seed, cfg, "int8")
    store = AdapterStore.for_model(pred8.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=4)
    eng8 = GenerationEngine(pred8, cfg, kv_dtype="int8", adapter_store=store,
                            warmup=True)
    servers = []
    try:
        srv = ServingServer(ServingEngine(pred, start=False),
                            generation_engine=eng)
        servers.append(srv)
        srv8 = ServingServer(ServingEngine(pred8, start=False),
                             generation_engine=eng8)
        servers.append(srv8)
        paths["http_generate"], record["b3"], before = serve_generate_http(
            torch, np, eng, srv, prompts, base_tokens, card, phase3_step_ms)
        record["b3"]["phase_s"] = time.perf_counter() - t0

        log("phase b4: adapter admin over HTTP and hot base swaps under "
            "live traffic")
        t0 = time.perf_counter()
        fac = proj_factors(np, cfg, seed)
        conn = http.client.HTTPConnection(srv8.host, srv8.port, timeout=600)
        K.reset_launch_counts()
        t_up = time.perf_counter()
        status, data, _ = http_call(conn, "POST", "/v1/admin/adapters", {
            "adapter_id": "http-ad", "alpha": 16.0,
            "factors": {t: {"a": a.tolist(), "b": b.tolist()}
                        for t, (a, b) in fac.items()}})
        t_up = time.perf_counter() - t_up
        require(status == 200, f"b4 upload: {status} {str(data)[:200]}")
        store.upload("local-ad", fac, alpha=16.0)
        rows = {r["id"]: r for r in store.resident()}
        ra, rb = rows["http-ad"], rows["local-ad"]
        require(ra["rank_bucket"] == rb["rank_bucket"] == 8,
                f"b4: buckets {ra} {rb}")
        bi = store.rank_buckets.index(8)
        for t in fac:
            a, b, sc = store.pools(t)
            require(torch.equal(a[bi][ra["slot"]], a[bi][rb["slot"]])
                    and torch.equal(b[bi][ra["slot"]], b[bi][rb["slot"]])
                    and torch.equal(sc[bi][ra["slot"]], sc[bi][rb["slot"]]),
                    f"b4: {t}'s slot rows differ between the uploads")
        outs = {}
        for key, payload, hdr in (
                ("http-ad", {"adapter": "http-ad"}, {}),
                ("local-ad", {"model": "local-ad"}, {}),
                ("header", {}, {"X-Adapter": "local-ad"}),
                ("base", {}, {})):
            status, data, _ = http_call(conn, "POST", "/v1/generate", dict(
                tokens=prompts[2].tolist(), max_new_tokens=16, stream=False,
                **payload), headers=hdr)
            require(status == 200, f"b4 generate {key}: {status} {data}")
            outs[key] = data["tokens"]
        require(outs["http-ad"] == outs["local-ad"] == outs["header"],
                f"b4: the two uploads' tokens differ: {outs}")
        require(outs["http-ad"] != outs["base"],
                "b4: the adapter changed no token")
        status, data, _ = http_call(conn, "POST", "/v1/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 4, "adapter": "ghost"})
        require(status == 404 and data.get("kind") == "adapter",
                f"b4: an unknown adapter answered {status} {data}")
        pinned = eng8.submit(prompts[3], max_new_tokens=32,
                             adapter="http-ad")
        status, data, _ = http_call(conn, "POST", "/v1/admin/adapters/evict",
                                    {"adapter_id": "http-ad"})
        require(status == 409 and data.get("kind") == "in_use",
                f"b4: evicting a pinned adapter answered {status} {data}")
        pinned.result(timeout=600)
        status, data, _ = http_call(conn, "POST", "/v1/admin/adapters/evict",
                                    {"adapter_id": "http-ad"})
        require(status == 200 and data["evicted"]["id"] == "http-ad",
                f"b4: evicting an idle adapter answered {status} {data}")
        conn.close()
        log(f"  b4: an adapter of {len(fac)} targets uploaded over HTTP "
            f"({sum(a.size + b.size for a, b in fac.values())} floats) in "
            f"{t_up:.3f} s: its slot rows equal an in-process upload's bit "
            f"for bit, and its tokens; 404 for an unknown adapter; evict "
            f"409 while pinned, 200 after [{card}]")
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
        with torch.no_grad():
            new_f = {f"dec{i}_qkv.w": lyr.qkv.w + SWAP_STD * torch.randn(
                         lyr.qkv.w.shape, device=DEVICE, generator=gen)
                     for i, lyr in enumerate(pred.lm.layers)}
            new_q = {}
            for i, lyr in enumerate(pred8.lm.layers):
                q = lyr.qkv
                new_q[f"dec{i}_qkv.w"] = dequantize_weight(
                    q.qweight, q.scale, q.mode, q.block) + SWAP_STD * \
                    torch.randn(q.qweight.shape, device=DEVICE, generator=gen)
        swaps = {"float32": swap_under_traffic(
            torch, np, eng, srv, new_f, prompts, "b4 float32")}
        after_f = after_swap_tokens(eng, prompts)
        before_q = after_swap_tokens(eng8, prompts, adapter="local-ad")
        swaps["int8"] = swap_under_traffic(torch, np, eng8, srv8, new_q,
                                           prompts, "b4 int8",
                                           adapter="local-ad")
        after_q = after_swap_tokens(eng8, prompts, adapter="local-ad")
        paths["http_adapters"] = K.launch_counts()
        require(paths["http_adapters"]["batched_lora_add_"] > 0
                and paths["http_adapters"]["quantized_matmul"] > 0
                and paths["http_adapters"]["ragged_paged_attention_q"] > 0,
                f"b4: launches {paths['http_adapters']}")
        require(after_f != [t[:16] for t in before[:4]],
                "b4 float32: the swap changed no token")
        require(after_q != before_q, "b4 int8: the swap changed no token")
    finally:
        for s in servers:
            s.close()
        eng.close()
        eng8.close()
    del eng, eng8, pred, pred8, store
    gc.collect()
    torch.cuda.empty_cache()

    # fresh engines built on the new weights: the float32 ones, and the
    # int8 base quantized as the swap quantized it
    _, fresh = gpt3_predictor(torch, seed)
    with torch.no_grad():
        for i, lyr in enumerate(fresh.lm.layers):
            lyr.qkv.w.copy_(new_f[f"dec{i}_qkv.w"])
    with GenerationEngine(fresh, cfg, warmup=True) as feng:
        fresh_f = after_swap_tokens(feng, prompts)
    del fresh
    torch.cuda.empty_cache()
    fresh8, _ = quantized_predictor(torch, seed, cfg, "int8")
    with torch.no_grad():
        for i, lyr in enumerate(fresh8.lm.layers):
            q = lyr.qkv
            qw, sc = quantize_weight(new_q[f"dec{i}_qkv.w"], q.mode, q.block)
            q.qweight.copy_(qw)
            q.scale.copy_(sc)
    fstore = AdapterStore.for_model(fresh8.lm, rank_buckets=(8, 16),
                                    slots_per_bucket=4)
    fstore.upload("local-ad", fac, alpha=16.0)
    with GenerationEngine(fresh8, cfg, kv_dtype="int8",
                          adapter_store=fstore, warmup=True) as feng8:
        fresh_q = after_swap_tokens(feng8, prompts, adapter="local-ad")
    del fresh8, fstore
    torch.cuda.empty_cache()
    require(after_f == fresh_f, "b4 float32: the swapped engine's tokens "
            "differ from a fresh engine's on the new weights")
    require(after_q == fresh_q, "b4 int8: the swapped engine's tokens "
            "differ from a fresh engine's on the new weights")
    log(f"  b4: after the swaps, {len(after_f)} float32 and {len(after_q)} "
        f"int8 requests (one on the adapter) equal fresh engines' on the "
        f"new weights token for token, and differ from before the swaps "
        f"[{card}]")
    record["b4"] = {"swaps": swaps, "upload_s": t_up,
                    "phase_s": time.perf_counter() - t0,
                    "launches": paths["http_adapters"]}
    return paths, record


# -- phase 5: switch-MoE under Lookahead and EMA, and control flow -------------


def _moe_inputs(main):
    """(X input, AuxLoss output, GateW) names of each switch_moe op."""
    return [(op.input("X")[0], op.output("AuxLoss")[0], op.input("GateW")[0])
            for op in main.global_block().ops if op.type == "switch_moe"]


def routing(torch, x, wg):
    """The experts the switch_moe op routes ``x`` to (its router: the
    argmax of softmax(x @ wg)) and each token's top-2 probability gap."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ wg, dim=-1)
    top = torch.topk(probs, 2, dim=-1).values
    return torch.argmax(probs, dim=-1), top[:, 0] - top[:, 1]


# phase 5's MoE check: 2 experts a layer (8 until phase h came: the CPU
# side's expert parameters were its cost, 109.5 s at one step); what it
# checks is the same
MOE_CHECK_EXPERTS = 2


def card_vs_cpu_moe(torch, np, seed, steps=1, lr=1e-4, k=1):
    """A 2-layer gpt3_1p3b-width GPT whose both FFNs are 2-expert
    switch-MoE layers, trained ``steps`` steps by LookaheadOptimizer(
    fused Adam, alpha 0.5, k) with an ExponentialMovingAverage, from the
    same numpy-seeded parameters on the card and on the CPU: routing
    identical every step, losses within phase 5's rtol, parameters (and
    the Lookahead slow weights, the EMA shadows and apply()'s
    bias-corrected values) within 2 * lr * steps. One step at k 1 syncs
    the slow weights on that step, so it checks what two steps at k 2
    did at half the CPU's time (the check's cost is the CPU side)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    seq = 128
    fluid.set_flags({"optimizer_fuse": "on"})
    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2,
                    num_heads=16, ffn_size=8192, max_position=1024,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    use_flash_attention=True, moe_every=1,
                    moe_experts=MOE_CHECK_EXPERTS)
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(cfg, seq)
        with fluid.program_guard(main, startup):
            fluid.optimizer.LookaheadOptimizer(
                fluid.optimizer.AdamOptimizer(lr), alpha=0.5, k=k).minimize(
                    fetches["loss"])
            ema = fluid.optimizer.ExponentialMovingAverage(0.9)
            ema.update()
    moe = _moe_inputs(main)
    require(len(moe) == 2, f"{len(moe)} switch_moe ops")
    batch = synthetic_lm_batch(np.random.RandomState(seed), 2, seq, VOCAB)
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    arrays = seeded_arrays(np, main, cpu_scope, cfg.initializer_range, seed)
    slows = {v.name: v.name[:v.name.index(".slow")] for v in main.list_vars()
             if ".slow" in v.name}
    for slow, p in slows.items():      # slow weights start as the params
        arrays[slow] = arrays[p]
    gpu, gpu_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    load_scope_arrays(cpu_scope, arrays, main, "cpu")
    load_scope_arrays(gpu_scope, arrays, main, DEVICE)
    fetch = [fetches["loss"]] + [x for x, _, _ in moe]
    losses, gaps = {"cuda": [], "cpu": []}, []
    for s in range(steps):
        experts = {}
        for name, exe, scope in (("cuda", gpu, gpu_scope),
                                 ("cpu", cpu, cpu_scope)):
            gates = [scope.find_var(g).clone() for _, _, g in moe]
            K.reset_launch_counts()
            out = exe.run(main, feed=batch, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            if name == "cuda":
                n_adam = len(main.all_parameters())
                require(K.launch_counts()["fused_adam_update"] == n_adam,
                        "the card's MoE step did not go through K10")
            losses[name].append(float(out[0].reshape(-1)[0]))
            experts[name] = [routing(torch, x, g)
                             for x, g in zip(out[1:], gates)]
        for (ec, gc_), (ep, gp) in zip(experts["cuda"], experts["cpu"]):
            require(torch.equal(ec.cpu(), ep),
                    f"step {s}: routing differs on "
                    f"{int((ec.cpu() != ep).sum())} tokens")
            gaps.append(float(gp.min()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    rtol = CARD_VS_CPU_RTOL["gpt_flash"]
    require(rel <= rtol, f"MoE card vs CPU losses differ by {rel:.3e}")
    limit = 2 * lr * steps

    def worst(names, get_gpu, get_cpu):
        w, wn = 0.0, ""
        for n in names:
            d = float(np.abs(get_gpu(n) - get_cpu(n)).max())
            if d > w:
                w, wn = d, n
        return w, wn

    persist = [v.name for v in main.list_vars()
               if v.persistable and not v.is_data]
    w_state, n_state = worst(persist, gpu_scope.get_numpy,
                             cpu_scope.get_numpy)
    require(w_state <= limit, f"MoE card vs CPU {n_state} differs by "
            f"{w_state:.3e} > {limit:.1e}")
    applied = {}
    for name, scope in (("cuda", gpu_scope), ("cpu", cpu_scope)):
        with fluid.scope_guard(scope):
            before = {p.name: scope.find_var(p.name)
                      for p in main.all_parameters()}
            with ema.apply():
                applied[name] = {n: scope.get_numpy(n) for n in before}
            require(all(scope.find_var(n) is v for n, v in before.items()),
                    "EMA apply() did not restore the parameters")
    w_ema, n_ema = worst(applied["cpu"], lambda n: applied["cuda"][n],
                         lambda n: applied["cpu"][n])
    require(w_ema <= limit, f"EMA apply() values differ by {w_ema:.3e}")
    counter = float(gpu_scope.get_numpy(ema._counter.name)[0])
    require(counter == steps, f"EMA counter {counter}")
    log(f"  losses {losses['cuda']} (CPU {losses['cpu']}), within {rel:.3e} "
        f"(rtol {rtol}); routing identical on {2 * seq} tokens x 2 layers x "
        f"{steps} steps, smallest top-2 probability gap {min(gaps):.3e}; "
        f"every persistable within {w_state:.3e} ({n_state}), EMA apply() "
        f"within {w_ema:.3e} (limit 2 * lr * steps = {limit:.1e})")
    return {"losses": losses, "loss_rel_err": rel, "min_top2_gap": min(gaps),
            "state_max_abs_err": w_state, "ema_apply_max_abs_err": w_ema,
            "limit": limit}


def card_vs_cpu_control_flow(torch, np):
    """A While (sum to ten, squares into a tensor array), a Switch and a
    cond in one program on the card and on the CPU: equal results."""
    import paddle_tpu_torch as fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", [3])
        i = L.fill_constant([1], "int64", 0)
        fi = L.fill_constant([1], "float32", 0.0)
        total = L.fill_constant([1], "float32", 0.0)
        arr = L.create_array("float32", 10, [3])
        limit = L.fill_constant([1], "int64", 10)
        cond = L.less_than(i, limit)
        loop = L.While(cond)
        with loop.block():
            L.increment(fi, 1.0)
            L.assign(L.elementwise_add(total, fi), total)
            L.array_write(L.elementwise_mul(
                L.reduce_sum(x, dim=[0]), L.elementwise_mul(fi, fi)), i,
                array=arr)
            L.increment(i, 1.0)
            L.less_than(i, limit, cond=cond)
        out = L.fill_constant([1], "float32", -1.0)
        sw = L.Switch()
        with sw:
            with sw.case(L.greater_than(total, L.fill_constant(
                    [1], "float32", 100.0))):
                L.assign(L.fill_constant([1], "float32", 1.0), out)
            with sw.case(L.greater_than(total, L.fill_constant(
                    [1], "float32", 50.0))):
                L.assign(L.fill_constant([1], "float32", 2.0), out)
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 3.0), out)
        sel = L.cond(L.greater_than(x, L.fill_constant([1], "float32", 0.0)),
                     lambda: L.scale(x, scale=2.0), lambda: L.scale(x, -1.0))
        fetch = [total, arr, out, sel, L.array_read(arr, L.fill_constant(
            [1], "int64", 9))]
    feed = {"x": np.array([[1.5, -2.0, 0.25], [0.5, 3.0, -1.0]], "float32")}
    got = {}
    for name, place in (("cuda", fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        got[name] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for a, b in zip(got["cuda"], got["cpu"]):
        require(np.allclose(a, b, rtol=1e-6, atol=0),
                f"control flow: card {a} vs CPU {b}")
    require(float(got["cuda"][0][0]) == 55.0 and float(got["cuda"][2][0]) == 2.0,
            f"control flow: total {got['cuda'][0]}, switch {got['cuda'][2]}")
    log(f"  While summed to {float(got['cuda'][0][0])}, wrote 10 array "
        f"rows (last {got['cuda'][4].tolist()}), Switch took case 2, cond "
        "selected per element: card equals CPU")
    return {"total": float(got["cuda"][0][0]), "switch": float(got["cuda"][2][0])}


# -- phase d: switch-MoE pretraining under recompute and gradient merge,
#    served; DeepFM with sparse embeddings ----------------------------------------


MOE_LAYERS = 6           # of gpt3_1p3b's 24: 24 layers with 8 experts in
#                          every second one hold 4.16 B parameters, 66.5 GB
#                          of float32 Adam state; 12 hold 2.15 B, 34.4 GB
MOE_STEPS = 5
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5     # the parity files' training tolerance
MERGE_RTOL, MERGE_ATOL = 1e-4, 1e-5     # tests/test_recompute.py:130-144
MERGE_K, MERGE_BATCH, MERGE_STEPS = 4, 8, 3
CTR = dict(num_fields=26, vocab_size=2 ** 25, embed_dim=10, dense_dim=13,
           hidden=(400, 400, 400))      # Criteo in the DeepFM paper
CTR_BATCH, CTR_STEPS = 4096, 5
SGD_RTOL = 1e-6                         # tests/test_selected_rows.py:97


def moe_config(layers=MOE_LAYERS):
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers, cfg.use_flash_attention, cfg.moe_every = layers, True, 2
    return cfg


def decoder_outputs(main, layers):
    """Each decoder's output: the input of the next decoder's first layer
    norm, and the last one's of the final layer norm."""
    x_of = {op.input("Scale")[0]: op.input("X")[0]
            for op in main.global_block().ops if op.type == "layer_norm"}
    return ([x_of[f"dec{i}_ln1.scale"] for i in range(1, layers)]
            + [x_of["gpt_lnf.scale"]])


def build_moe(fluid, cfg, make_opt):
    """build_gpt_lm's program (phase 4's sequence) under
    ``make_opt(checkpoints)``."""
    from paddle_tpu_torch.models.gpt import build_gpt_lm

    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(cfg, TRAIN_SEQ)
        with fluid.program_guard(main, startup):
            make_opt(decoder_outputs(main, cfg.num_layers)).minimize(
                fetches["loss"])
    return main, startup, fetches


def recompute_adam(fluid, lr=1e-4, recompute=True):
    def make(ckpts):
        adam = fluid.optimizer.AdamOptimizer(lr)
        if not recompute:
            return adam
        opt = fluid.optimizer.RecomputeOptimizer(adam)
        opt._set_checkpoints(ckpts)
        return opt
    return make


def moe_launches(K, layers, n_params, recompute, micro=1):
    """Each kernel's launches in one step: every segment's forward runs
    twice under recompute (the loss's last segment too), each microbatch
    of a merged step runs the forward and the backward, the optimizer
    runs once."""
    f = 2 if recompute else 1
    want = {n: 0 for n in K.KERNELS}
    want.update(layer_norm=micro * f * (2 * layers + 1),
                layer_norm_bwd=micro * (2 * layers + 1),
                softmax_xent_fwd=micro * f, softmax_xent_bwd=micro,
                flash_attention_fwd=micro * f * layers,
                flash_attention_bwd=micro * layers,
                fused_adam_update=n_params)
    return want


class HeldAtBackward:
    """The memory the forward keeps for the backward: what is allocated
    when the loss gradient's seed op runs, above the resting memory when
    the block is entered (parameters, moments and whatever else stays
    between steps). A wrapper on the seed's lowering while the block is
    entered."""

    def __init__(self, torch):
        from paddle_tpu_torch.core.framework import OpRole
        from paddle_tpu_torch.core.registry import get_op_def

        self.torch, self.role = torch, OpRole.Loss
        self.opdef = get_op_def("fill_constant")
        self.rest = self.bytes = 0

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.rest = self.torch.cuda.memory_allocated()
        orig = self.orig = self.opdef.lower

        def lower(ctx, op, ins):
            if int(op.attrs.get("op_role", 0)) & self.role:
                self.bytes = max(self.bytes, self.torch.cuda.memory_allocated()
                                 - self.rest)
            return orig(ctx, op, ins)

        self.opdef.lower = lower
        return self

    def __exit__(self, *exc):
        self.opdef.lower = self.orig


def train_moe(torch, np, seed, card, out_dir):
    """d1: the MoE model trained 5 steps by plain Adam, then from the same
    startup by RecomputeOptimizer(Adam) in a fresh scope: losses and every
    parameter equal at the training tolerance, exact launches every step,
    and the memory the forward keeps for the backward lower. Returns the
    paths' launches, the numbers and the recompute run's scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch

    cfg = moe_config()
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})     # on: a CUDA device
    batch = synthetic_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               TRAIN_SEQ, cfg.vocab_size)
    paths, out, ref = {}, {"card": card, "layers": L}, None
    for name, recompute in (("moe", False), ("moe_recompute", True)):
        main, startup, fetches = build_moe(
            fluid, cfg, recompute_adam(fluid, recompute=recompute))
        types = [op.type for op in main.global_block().ops]
        n_params = len(main.all_parameters())
        require(types.count("fused_adam") == n_params and "adam" not in types,
                f"{name}: {types.count('fused_adam')} fused_adam ops for "
                f"{n_params} parameters")
        require(types.count("recompute_segment_grad")
                == (L + 1 if recompute else 0)
                and types.count("switch_moe") == L // 2,
                f"{name}: {types.count('recompute_segment_grad')} segment "
                f"grads, {types.count('switch_moe')} switch_moe ops")
        exe, scope, n = startup_on_card(torch, np, fluid, main, startup, seed)
        want = moe_launches(K, L, n_params, recompute)
        with HeldAtBackward(torch) as held:
            paths[name], perf = run_steps(
                torch, np, K, exe, main, scope, batch, fetches["loss"], want,
                MOE_STEPS, TRAIN_ROWS, card, out_dir, name)
        perf.update(parameters=n, held_at_backward_gb=held.bytes / 1e9,
                    rest_gb=held.rest / 1e9,
                    peak_above_rest_gb=perf["max_memory_allocated_gb"]
                    - held.rest / 1e9)
        log(f"  {name}: {n} parameters; at rest {held.rest / 1e9:.2f} GB, "
            f"the forward keeps {held.bytes / 1e9:.2f} GB more when the "
            f"backward starts, the peak is {perf['peak_above_rest_gb']:.2f} "
            f"GB above rest [{card}]")
        out[name] = perf
        params = {p.name: scope.find_var(p.name) for p in main.all_parameters()}
        if ref is None:
            ref = params
            del exe, scope, params
            gc.collect()
            torch.cuda.empty_cache()
            continue
        worst, worst_name, equal = 0.0, "", 0
        for p, a in params.items():
            b = ref[p]
            d = float((a - b).abs().max())
            if d > worst:
                worst, worst_name = d, p
            equal += int(torch.equal(a, b))
            require(bool(torch.allclose(a, b, rtol=TRAIN_RTOL,
                                        atol=TRAIN_ATOL)),
                    f"recompute {p} differs from plain Adam's by {d:.3e}")
        la, lb = perf["losses"], out["moe"]["losses"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        require(all(abs(x - y) <= TRAIN_ATOL + TRAIN_RTOL * abs(y)
                    for x, y in zip(la, lb)),
                f"recompute losses {la} vs plain {lb}")
        plain, rc = out["moe"], perf
        require(rc["held_at_backward_gb"] < plain["held_at_backward_gb"],
                "recompute keeps no less for the backward")
        out.update(param_max_abs_err=worst, param_max_name=worst_name,
                   params_bit_equal=equal, loss_rel_err=rel)
        log(f"  d1: recompute vs plain Adam: losses within {rel:.3e}, "
            f"{equal} of {len(params)} parameters bit-equal, the largest "
            f"difference {worst:.3e} ({worst_name}; rtol {TRAIN_RTOL}, atol "
            f"{TRAIN_ATOL}); step {plain['step_ms_mean']:.3f} -> "
            f"{rc['step_ms_mean']:.3f} ms, {plain['tokens_per_s']:.1f} -> "
            f"{rc['tokens_per_s']:.1f} tokens/s; above rest (the recompute "
            f"run's rest holds the plain run's parameters too) the peak "
            f"{plain['peak_above_rest_gb']:.2f} -> "
            f"{rc['peak_above_rest_gb']:.2f} GB, kept for the backward "
            f"{plain['held_at_backward_gb']:.2f} -> "
            f"{rc['held_at_backward_gb']:.2f} GB [{card}]")
        # keep the trained parameters (d3 serves them), not the moments
        keep = set(params)
        for n in list(scope.vars):
            if n not in keep:
                scope.erase(n)
        del ref, params, exe
        gc.collect()
        torch.cuda.empty_cache()
        return paths, out, scope, cfg


def serve_moe(torch, np, seed, card, scope, cfg, tmp):
    """d3: d1's model as an ``is_test`` Program over d1's trained
    parameters: the Executor's logits and the MoE statistics, then
    ``save_inference_model`` and the Predictor's logits, equal at 1e-5 of
    max|logit|."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.gpt import build_gpt_lm, synthetic_lm_batch
    from paddle_tpu_torch.ops.moe import moe_capacity, route

    L = cfg.num_layers
    with fluid.unique_name.guard():
        main, _, _, fetches = build_gpt_lm(cfg, TRAIN_SEQ, is_test=True)
    batch = synthetic_lm_batch(np.random.RandomState(seed + 1), TRAIN_BATCH,
                               TRAIN_SEQ, cfg.vocab_size)
    moe = _moe_inputs(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    outs = exe.run(main, feed=batch, fetch_list=[fetches["logits"]]
                   + [a for _, a, _ in moe] + [x for x, _, _ in moe],
                   scope=scope, return_numpy=False)
    want = outs[0]
    cap = moe_capacity(TRAIN_ROWS, cfg.moe_capacity, cfg.moe_experts)
    dropped, aux = [], [float(a.reshape(-1)[0]) for a in outs[1:1 + len(moe)]]
    for x, (_, _, g) in zip(outs[1 + len(moe):], moe):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ scope.find_var(g),
                              -1)
        _, keep, _, _ = route(probs, cap)
        dropped.append(1.0 - float(keep.float().mean()))
    log(f"  MoE statistics of d1's trained model on a 2 x 1024 batch (is_test, "
        f"capacity {cap} a layer): dropped token share by layer "
        f"{[round(d, 6) for d in dropped]}, aux loss by layer "
        f"{[round(a, 6) for a in aux]}")
    d = os.path.join(tmp, "moe_gpt")
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    t_save = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    t0 = time.perf_counter()
    pred = create_predictor(Config(d))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    require(pred.lm is None and pred.gpt_config.moe_every == cfg.moe_every,
            f"the predictor read moe_every {pred.gpt_config.moe_every}")
    pred.run([batch["tokens"]], return_numpy=False)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    (got,) = pred.run([batch["tokens"]], return_numpy=False)
    torch.cuda.synchronize()
    counts = {n: c for n, c in K.launch_counts().items() if c}
    require(counts == {"layer_norm": 2 * L + 1, "flash_attention_fwd": L},
            f"d3: a Predictor run launched {counts}")
    err = float((got - want).abs().max())
    lim = 1e-5 * float(want.abs().max())
    require(tuple(got.shape) == (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
            and bool(torch.isfinite(got).all()), "d3: logits")
    require(err <= lim, f"d3: Predictor logits {err:.3e} from the "
            f"Executor's (limit {lim:.3e})")
    log(f"  d3: {size / 1e9:.3f} GB saved in {t_save:.2f} s, loaded in "
        f"{t_load:.2f} s; a Predictor run launched {counts}; logits "
        f"{err:.3e} from the Executor's (limit {lim:.3e}) [{card}]")
    del pred, got, want, outs
    shutil.rmtree(d, ignore_errors=True)
    return {"moe_serve": K.launch_counts()}, {
        "save_s": t_save, "load_s": t_load, "saved_bytes": size,
        "max_abs_err": err, "limit": lim, "capacity": cap,
        "dropped_share": dropped, "aux_loss": aux, "launches": counts,
        "card": card}


def gradient_merge(torch, np, seed, card, out_dir):
    """d2: GradientMergeOptimizer(Adam, k 4) over batch 8 against plain
    Adam over the same batch on the 2-layer dense GPT at full width (no
    dropout): losses and parameters at JAX's merge tolerance; then the
    MoE model under GradientMergeOptimizer(RecomputeOptimizer(Adam), k 4)
    over batch 8, with exact launches (the forward kernels 4x d1's)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.gpt import GPTConfig, synthetic_lm_batch

    cfg = GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2,
                    num_heads=16, ffn_size=8192, max_position=1024,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    use_flash_attention=True)
    batch = synthetic_lm_batch(np.random.RandomState(seed), MERGE_BATCH,
                               TRAIN_SEQ, VOCAB)
    runs = {}
    for name, k in (("full", 1), ("merged", MERGE_K)):
        def make(ckpts, k=k):
            adam = fluid.optimizer.AdamOptimizer(1e-4)
            return (fluid.optimizer.GradientMergeOptimizer(adam, k_steps=k)
                    if k > 1 else adam)
        main, startup, fetches = build_moe(fluid, cfg, make)
        exe, scope, _ = startup_on_card(torch, np, fluid, main, startup, seed)
        t = time.perf_counter()
        losses = [float(exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                                scope=scope)[0]) for _ in range(MERGE_STEPS)]
        torch.cuda.synchronize()
        runs[name] = (losses, {p.name: scope.find_var(p.name)
                               for p in main.all_parameters()},
                      (time.perf_counter() - t) / MERGE_STEPS * 1e3)
        del exe, scope
    (fl, fp, fms), (ml, mp, mms) = runs["full"], runs["merged"]
    require(all(abs(a - b) <= MERGE_ATOL + MERGE_RTOL * abs(b)
                for a, b in zip(ml, fl)), f"merged losses {ml} vs full {fl}")
    worst, worst_name = 0.0, ""
    for n, b in fp.items():
        a = mp[n]
        d = float((a - b).abs().max())
        if d > worst:
            worst, worst_name = d, n
        require(bool(torch.allclose(a, b, rtol=MERGE_RTOL, atol=MERGE_ATOL)),
                f"merged {n} differs from the full batch's by {d:.3e}")
    log(f"  d2: 2-layer dense GPT, batch {MERGE_BATCH}: merged k={MERGE_K} "
        f"losses {ml} vs full {fl}; parameters within {worst:.3e} "
        f"({worst_name}; rtol {MERGE_RTOL}, atol {MERGE_ATOL}); "
        f"{fms:.1f} vs {mms:.1f} ms a step [{card}]")
    out = {"dense_losses_full": fl, "dense_losses_merged": ml,
           "dense_param_max_abs_err": worst, "card": card}
    del runs, fp, mp
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = moe_config()

    def make_moe(ckpts):
        return fluid.optimizer.GradientMergeOptimizer(
            recompute_adam(fluid)(ckpts), k_steps=MERGE_K)

    main, startup, fetches = build_moe(fluid, mcfg, make_moe)
    n_params = len(main.all_parameters())
    exe, scope, _ = startup_on_card(torch, np, fluid, main, startup, seed)
    batch = synthetic_lm_batch(np.random.RandomState(seed), MERGE_BATCH,
                               TRAIN_SEQ, mcfg.vocab_size)
    want = moe_launches(K, mcfg.num_layers, n_params, True, micro=MERGE_K)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, MERGE_STEPS,
                             MERGE_BATCH * TRAIN_SEQ, card, out_dir,
                             "moe_merged")
    out["moe_merged"] = perf
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe_merged": totals}, out


def profile_ctr(torch, exe, main, batches, loss, scope, out_dir, name):
    """Two traced steps: device time by kernel group and the idle share."""
    prof = start_profile(torch)
    t = time.perf_counter()
    for b in batches:
        exe.run(main, feed=b, fetch_list=[loss], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof.__exit__(None, None, None)
    return trace_breakdown(prof, out_dir, name, wall, len(batches))


def ctr_step(torch, exe, main, feed, fetch, scope):
    t = time.perf_counter()
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=False)
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t) * 1e3


def train_deepfm(torch, np, seed, card, out_dir, profile=False):
    """d4: DeepFM at Criteo's setting of the DeepFM paper (26 sparse
    fields over a 2^25-row hashed table, embedding 10, 13 dense features,
    hidden 400 x 3), batch 4096. SGD sparse against dense; Adam sparse:
    untouched rows keep their parameter and both moments bit for bit, the
    touched rows of the last step equal a plain per-row update on the
    card, and two merges of its gradient give the same bits; a dense Adam
    step for its time."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.models.ctr import build_deepfm, synthetic_ctr_batch

    fluid.set_flags({"optimizer_fuse": "auto"})
    rng = np.random.RandomState(seed)
    batches = [synthetic_ctr_batch(rng, CTR_BATCH, CTR["num_fields"],
                                   CTR["vocab_size"], CTR["dense_dim"])
               for _ in range(CTR_STEPS)]
    H, D = CTR["vocab_size"], CTR["embed_dim"]

    def build(opt, sparse):
        main, startup, _, fetches = build_deepfm(optimizer=opt,
                                                 is_sparse=sparse, **CTR)
        main.random_seed = startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        return main, exe, scope, fetches["loss"]

    out, paths = {"card": card}, {}
    sgd = {}
    for sparse in (True, False):
        main, exe, scope, loss = build(fluid.optimizer.SGD(0.1), sparse)
        ms = [ctr_step(torch, exe, main, b, [loss], scope)[1] for b in batches]
        sgd[sparse] = ({p.name: scope.find_var(p.name)
                        for p in main.all_parameters()}, ms)
        del exe, scope
    worst, worst_name = 0.0, ""
    for n, b in sgd[False][0].items():
        a = sgd[True][0][n]
        d = float((a - b).abs().max())
        if d > worst:
            worst, worst_name = d, n
        tol = SGD_RTOL * float(b.abs().max())
        require(bool(torch.allclose(a, b, rtol=SGD_RTOL, atol=tol)),
                f"d4 SGD: sparse {n} differs from dense by {d:.3e}")
    out.update(sgd_param_max_abs_err=worst,
               sgd_step_ms={"sparse": statistics.mean(sgd[True][1][1:]),
                            "dense": statistics.mean(sgd[False][1][1:])})
    log(f"  d4 SGD: sparse equals dense after {CTR_STEPS} steps within "
        f"{worst:.3e} ({worst_name}; rtol {SGD_RTOL}, atol {SGD_RTOL} x "
        f"max|p|); step {out['sgd_step_ms']['sparse']:.3f} ms sparse, "
        f"{out['sgd_step_ms']['dense']:.3f} ms dense [{card}]")
    del sgd
    gc.collect()
    torch.cuda.empty_cache()

    main, exe, scope, loss = build(fluid.optimizer.AdamOptimizer(1e-3), True)
    n_dense = len(main.all_parameters()) - 2          # fm_w1 and fm_v
    tables = ("fm_w1", "fm_v")

    def state_of(t, kind):
        return next(v.name for v in main.list_vars()
                    if getattr(v, "accumulator_owner", None) == t
                    and kind in v.name)

    acc = {t: [state_of(t, "moment1"), state_of(t, "moment2")]
           for t in tables}
    p0 = {t: scope.find_var(t).clone() for t in tables}
    ms, losses = [], []
    K.reset_launch_counts()
    for s, b in enumerate(batches):
        last = s == CTR_STEPS - 1
        if last:
            ids = torch.as_tensor(b["sparse_ids"].reshape(-1), device=DEVICE)
            rows = torch.unique(ids)
            before = {k: scope.find_var(n)[rows].clone() for k, n in
                      (("fm_v", "fm_v"), ("moment1", acc["fm_v"][0]),
                       ("moment2", acc["fm_v"][1]))}
            pows = {k: float(scope.get_numpy(state_of("fm_v", k))[0])
                    for k in ("beta1_pow", "beta2_pow")}
        outs, t = ctr_step(torch, exe, main, b,
                           [loss] + (["fm_v@GRAD"] if last else []), scope)
        ms.append(t)
        losses.append(float(outs[0].reshape(-1)[0]))
    counts = K.launch_counts()
    require(counts["fused_adam_update"] == n_dense * CTR_STEPS
            and sum(counts.values()) == counts["fused_adam_update"],
            f"d4 Adam: launches {counts}, want {n_dense} K10 a step")
    paths["deepfm_adam_sparse"] = counts
    touched = torch.zeros(H, dtype=torch.bool, device=DEVICE)
    for b in batches:
        touched[torch.as_tensor(b["sparse_ids"].reshape(-1),
                                device=DEVICE)] = True
    for t in tables:
        require(torch.equal(scope.find_var(t)[~touched], p0[t][~touched]),
                f"d4: untouched rows of {t} moved")
        for m in acc[t]:
            require(bool((scope.find_var(m)[~touched] == 0).all()),
                    f"d4: untouched rows of {m} moved")
    grad = outs[1]
    require(isinstance(grad, SelectedRows)
            and grad.values.shape == (CTR_BATCH * CTR["num_fields"], D),
            f"d4: fm_v's gradient is {type(grad).__name__}")
    m1, m2 = grad.merge(), grad.merge()
    require(torch.equal(m1.rows, m2.rows) and torch.equal(m1.values, m2.values),
            "d4: two merges of the sparse gradient differ")
    # the plain per-row update of the last step, on the card: each row's
    # slices summed in their order on the host
    inv = torch.searchsorted(rows, grad.rows)
    g = torch.from_numpy(_ordered_row_sums(np, inv.cpu().numpy(),
                                           grad.values.cpu().numpy(),
                                           rows.numel())).to(DEVICE)
    lr, beta1, beta2, eps = 1e-3, 0.9, 0.999, 1e-8
    b1p, b2p = pows["beta1_pow"], pows["beta2_pow"]
    p_b, m1_b, m2_b = before["fm_v"], before["moment1"], before["moment2"]
    m1n = beta1 * m1_b + (1 - beta1) * g
    m2n = beta2 * m2_b + (1 - beta2) * torch.square(g)
    lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
    want = p_b - lr_t * m1n / (torch.sqrt(m2n) + eps)
    got = scope.find_var("fm_v")[rows]
    err = float((got - want).abs().max())
    require(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-9)),
            f"d4: the last step's touched rows differ from a plain per-row "
            f"update by {err:.3e}")
    out.update(adam_losses=losses, adam_sparse_step_ms=statistics.mean(ms[1:]),
               touched_rows=int(touched.sum()), per_row_max_abs_err=err)
    if profile:
        out["adam_sparse_profile"] = profile_ctr(
            torch, exe, main, batches[:2], loss, scope, out_dir,
            "deepfm_adam_sparse")
    del exe, scope, p0, before, grad, m1, m2, g, got, want
    gc.collect()
    torch.cuda.empty_cache()
    main, exe, scope, loss = build(fluid.optimizer.AdamOptimizer(1e-3), False)
    K.reset_launch_counts()
    dms = [ctr_step(torch, exe, main, b, [loss], scope)[1]
           for b in batches[:3]]
    counts = K.launch_counts()
    require(counts["fused_adam_update"] == (n_dense + 2) * 3,
            f"d4 dense Adam: launches {counts}")
    paths["deepfm_adam_dense"] = counts
    out["adam_dense_step_ms"] = statistics.mean(dms[1:])
    if profile:
        out["adam_dense_profile"] = profile_ctr(
            torch, exe, main, batches[:2], loss, scope, out_dir,
            "deepfm_adam_dense")
    log(f"  d4 Adam: losses {losses}; {out['touched_rows']} of {H} rows "
        f"touched in {CTR_STEPS} steps, the others' parameters and moments "
        f"unchanged bit for bit; the last step's rows within {err:.3e} of a "
        f"plain per-row update; two merges bit-equal; step "
        f"{out['adam_sparse_step_ms']:.3f} ms sparse, "
        f"{out['adam_dense_step_ms']:.3f} ms dense (it rewrites "
        f"{H * D * 4 / 1e9:.2f} GB of table and {2 * H * D * 4 / 1e9:.2f} GB "
        f"of moments) [{card}]")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    return paths, out


def _ordered_row_sums(np, inv, values, n):
    """Each row's slices summed in their order (float32 numpy)."""
    out = np.zeros((n, values.shape[1]), np.float32)
    np.add.at(out, inv, values)
    return out


def phase_d(torch, np, seed, card, out_dir, profile=False):
    """Phase d in the order d1, d3 (it serves d1's parameters), d2, d4;
    its own peak."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record = {}
    log(f"phase d1: gpt3_1p3b widths, {MOE_LAYERS} layers, switch-MoE every 2nd, plain "
        "Adam then RecomputeOptimizer(Adam)")
    paths, record["d1"], scope, cfg = train_moe(torch, np, seed, card, out_dir)
    log("phase d3: d1's model saved as an is_test Program and served by the "
        "Predictor")
    with tempfile.TemporaryDirectory(prefix="pt_phase_d_") as tmp:
        p3, record["d3"] = serve_moe(torch, np, seed, card, scope, cfg, tmp)
    paths.update(p3)
    del scope
    gc.collect()
    torch.cuda.empty_cache()
    log("phase d2: GradientMergeOptimizer (k 4) on the dense and the MoE GPT")
    p2, record["d2"] = gradient_merge(torch, np, seed, card, out_dir)
    paths.update(p2)
    log("phase d4: DeepFM over a 2^25-row table with sparse embeddings")
    p4, record["d4"] = train_deepfm(torch, np, seed, card, out_dir, profile)
    paths.update(p4)
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  phase d peak: {record['peak_gb']:.2f} GB allocated [{card}]")
    return paths, record


# -- phase e: VGG-16 and SE-ResNeXt-50 trained, QAT, calibrate ------------------


VGG_BATCH, VGG_IMAGE, VGG_STEPS = 128, 32, 10   # CIFAR-10-sized images
SEX_BATCH, SEX_IMAGE, SEX_STEPS = 64, 32, 5
SEX_LAYOUT = dict(depth=(3, 4, 6, 3), filters=(128, 256, 512, 1024),
                  cardinality=32, reduction=16)  # dist_se_resnext.py's
# phase 8's Momentum 0.9 + L2Decay 1e-4 at lr 0.01: over 5 steps on one
# batch of 64 the recipe's linear-scaled 0.025 overshoots and the loss
# climbs back above its first value (on the card and on the CPU)
SEX_LR = 0.01
QAT_STEPS = 5
CALIB_BATCHES = 8
# a Predictor run of e1's saved Program against the Executor's is_test
# forward of the same Program on the same card
PREDICTOR_RTOL, PREDICTOR_ATOL = 1e-5, 1e-6
# e3's frozen logits, card against CPU, as a share of max|logit|: int8
# rounding turns last-bit differences into whole levels (1 / 127 of a
# scale), so this is a bound of a few levels, not a float tolerance
QAT_CARD_VS_CPU = 0.05


def logits_of(main):
    """The logits var of a ``models.vision`` / ``models.mnist`` program:
    the input of its ``softmax`` (the accuracy's)."""
    return next(op.inputs["X"][0] for op in main.global_block().ops
                if op.type == "softmax")


def image_batch(np, seed, batch, size, classes=10):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, 3, size, size).astype("float32"),
            "label": rng.randint(0, classes, (batch, 1)).astype("int64")}


def forward_program(fluid, main, logits):
    """``main`` cloned ``for_test`` and pruned to what ``logits`` needs:
    no backward, no update."""
    return fluid.io._prune_program(main.clone(for_test=True), ["image"],
                                   [logits])


def image_path_want(K, n_params, update):
    want = {name: 0 for name in K.KERNELS}
    want.update(softmax_xent_fwd=1, softmax_xent_bwd=1)
    want[update] = n_params
    return want


def vgg_program(fluid, qat=False):
    """e1's VGG-16 with batch norm under Adam(1e-3); with ``qat`` the
    QuantizationTransformPass applied after ``minimize``."""
    from paddle_tpu_torch.contrib.slim import QuantizationTransformPass
    from paddle_tpu_torch.models.vision import build_vgg

    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_vgg(
            10, VGG_IMAGE, fluid.optimizer.AdamOptimizer(1e-3), depth=16)
        if qat:
            QuantizationTransformPass(startup_program=startup).apply(main)
    types = [op.type for op in main.global_block().ops]
    n = types.count("fused_adam")
    require(n == len(main.all_parameters()) and "adam" not in types,
            f"VGG-16: {n} fused_adam ops for {len(main.all_parameters())} "
            "parameters")
    return main, startup, fetches, n


def train_vgg(torch, np, seed, card, out_dir, profile=False):
    """e1: VGG-16 (batch norm, dropout 0.5) on CIFAR-10-sized images,
    batch 128, 10 fused-Adam steps: K4 and K5 once and K10 once a
    parameter every step; the mean of the last three losses below the
    first. Then ``save_inference_model`` and a ``Predictor`` over the
    same images: its logits equal the Executor's ``is_test`` forward."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Config, create_predictor

    main, startup, fetches, n = vgg_program(fluid)
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = image_batch(np, seed, VGG_BATCH, VGG_IMAGE)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"],
                             image_path_want(K, n, "fused_adam_update"),
                             VGG_STEPS, VGG_BATCH, card, out_dir, "vgg",
                             profile, unit="images")
    losses = perf["losses"]
    require(statistics.mean(losses[-3:]) < losses[0],
            f"e1: the mean of the last three losses is not below the first: "
            f"{losses}")
    logits = logits_of(main)
    test = forward_program(fluid, main, logits)
    (want,) = exe.run(test, feed={"image": batch["image"]},
                      fetch_list=[logits], scope=scope, return_numpy=False)
    with tempfile.TemporaryDirectory(prefix="pt_phase_e_") as d:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["image"], [logits], exe, test)
        pred = create_predictor(Config(d))
        (got,) = pred.run([batch["image"]], return_numpy=False)
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    lim = PREDICTOR_ATOL + PREDICTOR_RTOL * float(want.abs().max())
    require(tuple(got.shape) == (VGG_BATCH, 10) and err <= lim,
            f"e1: Predictor logits {tuple(got.shape)} {err:.3e} from the "
            f"Executor's is_test forward (limit {lim:.3e})")
    log(f"  e1: {n_params} parameters in {n} tensors; Predictor logits "
        f"{err:.3e} from the Executor's is_test forward (limit {lim:.3e}) "
        f"[{card}]")
    perf.update(parameters=n_params, tensors=n, batch=VGG_BATCH,
                image_size=VGG_IMAGE, predictor_max_abs_err=err,
                predictor_limit=lim)
    return totals, perf


def grouped_conv_share(torch, exe, main, scope, batch, loss, cardinality,
                       steps=2):
    """Device time of the grouped 3x3 convolutions (forward and
    backward, found by their filters [C, C / cardinality, 3, 3]) over
    all the device time of ``steps`` traced steps."""
    from torch.profiler import ProfilerActivity, profile

    def dev(e, attr):
        return float(getattr(e, attr, None)
                     or getattr(e, attr.replace("device", "cuda"), 0.0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
    grouped = total = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        # the device's own rows (kernels, copies) sum to its busy time;
        # a CPU op's self device time repeats the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CPU:
            total += dev(e, "self_device_time_total")
        if e.key not in ("aten::cudnn_convolution",
                         "aten::convolution_backward"):
            continue
        if any(len(s) == 4 and s[2] == s[3] == 3 and s[1] * cardinality == s[0]
               for s in (e.input_shapes or []) if isinstance(s, list)):
            grouped += dev(e, "device_time_total")
    require(total > 0, "the profiler saw no device time")
    return {"grouped_conv_ms_a_step": grouped / 1e3 / steps,
            "device_ms_a_step": total / 1e3 / steps,
            "grouped_conv_share": grouped / total}


def train_se_resnext(torch, np, seed, card, out_dir, profile=False):
    """e2: SE-ResNeXt-50's layout (depth 3-4-6-3, filters 128-1024,
    cardinality 32, reduction 16) on 32-pixel images, batch 64, 5 fused
    Momentum + L2Decay steps at lr ``SEX_LR``: K10m once a parameter,
    K4 and K5 once, every step; losses finite and falling. Under
    ``--profile``, the grouped convolutions' share of the device time."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.vision import build_se_resnext

    fluid.set_flags({"optimizer_fuse": "auto"})
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_se_resnext(
            10, SEX_IMAGE, fluid.optimizer.MomentumOptimizer(
                SEX_LR, momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4)),
            **SEX_LAYOUT)
    types = [op.type for op in main.global_block().ops]
    n = types.count("fused_momentum")
    require(n == len(main.all_parameters()) and "momentum" not in types,
            f"SE-ResNeXt-50: {n} fused_momentum ops")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = image_batch(np, seed, SEX_BATCH, SEX_IMAGE)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"],
                             image_path_want(K, n, "fused_momentum_update"),
                             SEX_STEPS, SEX_BATCH, card, out_dir,
                             "se_resnext", profile, unit="images")
    perf.update(parameters=n_params, tensors=n, batch=SEX_BATCH,
                image_size=SEX_IMAGE, **{k: list(v) if isinstance(v, tuple)
                                         else v for k, v in SEX_LAYOUT.items()})
    if profile:
        share = grouped_conv_share(torch, exe, main, scope, batch,
                                   fetches["loss"], SEX_LAYOUT["cardinality"])
        perf["grouped_conv"] = share
        log(f"  e2 grouped 3x3 convolutions: "
            f"{share['grouped_conv_ms_a_step']:.3f} ms a step of "
            f"{share['device_ms_a_step']:.3f} device ms "
            f"({100 * share['grouped_conv_share']:.1f} %; times include "
            f"the profiler) [{card}]")
    return totals, perf


def train_vgg_qat(torch, np, seed, card, out_dir, vgg=None):
    """e3: e1's program with the QuantizationTransformPass after
    ``minimize``, 5 steps: the fake-quantize ops are there, losses
    finite, the activation scales move, and a step launches K4, K5 and
    K10 as e1's does. Then QuantizationFreezePass on the trained
    program's forward: two ``is_test`` runs give the same logits and
    leave every persistable as it was, and the CPU's logits on the same
    state are within a few int8 levels (``QAT_CARD_VS_CPU``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.slim import QuantizationFreezePass

    main, startup, fetches, n = vgg_program(fluid, qat=True)
    types = {op.type for op in main.global_block().ops}
    require({"fake_quantize_abs_max",
             "fake_quantize_dequantize_moving_average_abs_max"} <= types,
            f"e3: no fake-quantize ops in {sorted(types)}")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    scales = sorted(v.name for v in main.list_vars()
                    if v.persistable and ".q_scale" in v.name)
    before = {s: scope.get_numpy(s) for s in scales}
    batch = image_batch(np, seed, VGG_BATCH, VGG_IMAGE)
    want = image_path_want(K, n, "fused_adam_update")
    losses, step_ms = [], []
    totals = {name: 0 for name in K.KERNELS}
    for s in range(QAT_STEPS):
        K.reset_launch_counts()
        t = time.perf_counter()
        (lv,) = exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                        scope=scope)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts = K.launch_counts()
        require(counts == want, f"e3 step {s}: launches {counts}, want {want}")
        for k, c in counts.items():
            totals[k] += c
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        log(f"  e3 step {s}: loss {losses[-1]:.6f} in {step_ms[-1]:.3f} ms")
    require(all(np.isfinite(losses)), f"e3: non-finite loss {losses}")
    moved = [s for s in scales
             if not np.array_equal(scope.get_numpy(s), before[s])]
    require(moved, "e3: no activation scale moved")
    # the frozen forward: is_test fake quantization by the learned scales
    logits = logits_of(main)
    frozen = main.clone(for_test=True)
    QuantizationFreezePass(scope, fluid.CUDAPlace(0)).apply(frozen)
    frozen = fluid.io._prune_program(frozen, ["image"], [logits])
    require(all(op.attrs.get("is_test") for op in frozen.global_block().ops
                if op.type.startswith("fake_quantize")),
            "e3: a fake-quantize op of the frozen program is not is_test")
    state = {v.name: scope.get_numpy(v.name) for v in frozen.list_vars()
             if v.persistable and not v.is_data}
    feed = {"image": batch["image"][:16]}
    a = exe.run(frozen, feed=feed, fetch_list=[logits], scope=scope)[0]
    b = exe.run(frozen, feed=feed, fetch_list=[logits], scope=scope)[0]
    require(np.array_equal(a, b), "e3: two frozen forwards differ")
    same = all(np.array_equal(scope.get_numpy(k), v)
               for k, v in state.items())
    require(same, "e3: a frozen forward changed a persistable")
    cpu_scope = fluid.Scope()
    fluid.io.load_scope_arrays(cpu_scope, state, frozen, "cpu")
    c = fluid.Executor(fluid.CPUPlace()).run(frozen, feed=feed,
                                             fetch_list=[logits],
                                             scope=cpu_scope)[0]
    # the card's float32 sums differ from the CPU's in the last bits, and
    # a value at a rounding boundary then lands one int8 level apart (1 /
    # 127 of its scale) and carries that through the later layers: the
    # bits cannot agree, the logits must stay within a few levels
    err = float(np.abs(a - c).max())
    lim = QAT_CARD_VS_CPU * float(np.abs(c).max())
    require(err <= lim, f"e3: frozen logits card vs CPU {err:.3e} > {lim:.3e}")
    # against the same trained weights without quantization: what int8
    # costs the logits (reported)
    float_main, _, _, _ = vgg_program(fluid)
    (f,) = exe.run(forward_program(fluid, float_main, logits_of(float_main)),
                   feed=feed, fetch_list=[logits_of(float_main)], scope=scope)
    vs_float = float(np.abs(a - f).max() / np.abs(f).max())
    mean_ms = statistics.mean(step_ms[1:])
    e1_ms = (vgg or {}).get("step_ms_mean")
    log(f"  e3: {len(scales)} activation scales, {len(moved)} moved; "
        f"losses {losses}; QAT step {mean_ms:.3f} ms"
        + (f" against e1's {e1_ms:.3f} ms ({mean_ms / e1_ms:.2f}x)"
           if e1_ms else "")
        + f"; frozen logits card vs CPU {err:.3e} (limit {lim:.3e}), "
        f"{vs_float:.3e} of max|logit| from the unquantized forward's "
        f"[{card}]")
    return totals, {"losses": losses, "step_ms": step_ms,
                    "step_ms_mean": mean_ms, "e1_step_ms_mean": e1_ms,
                    "activation_scales": len(scales),
                    "scales_moved": len(moved), "frozen_card_vs_cpu": err,
                    "frozen_limit": lim, "frozen_vs_float_rel": vs_float,
                    "launches_per_step": want,
                    "card": card}


def calibrate_lm(torch, np, seed, card):
    """e4: ``quantize.calibrate`` over gpt3_1p3b's int8 inference
    Program (``build_lm_program`` at full depth, b2's batch and length,
    its weights quantized in the scope as the Predictor does at load),
    ``max_batches`` 8: one finite positive scale for each distinct
    matmul input, no observer state left in the scope, and every batch
    launches K1 and K11 as b2's int8 forward does."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import quantize
    from paddle_tpu_torch.generation import build_lm_program
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    L = cfg.num_layers
    main, startup, _feeds, _fetches = build_lm_program(cfg, LM_PROGRAM_SEQ)
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    rep = quantize.rewrite_for_inference(main, scope, "int8")
    require(rep.n_quantized == 4 * L + 1,
            f"e4: {rep.n_quantized} weights quantized")
    inputs = {op.inputs["X"][0] for op in main.global_block().ops
              if op.type in ("mul", "matmul", "matmul_v2", "quantized_fc",
                             "quantized_matmul")}
    rng = np.random.RandomState(seed)
    feeds = [{"tokens": rng.randint(0, cfg.vocab_size, (
        LM_PROGRAM_BATCH, LM_PROGRAM_SEQ)).astype(np.int64)}
        for _ in range(CALIB_BATCHES + 2)]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    scales = quantize.calibrate(main, feeds, scope=scope, executor=exe,
                                max_batches=CALIB_BATCHES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = K.launch_counts()
    want = {n: 0 for n in K.KERNELS}
    want.update(layer_norm=(2 * L + 1) * CALIB_BATCHES,
                quantized_matmul=(4 * L + 1) * CALIB_BATCHES)
    require(counts == want, f"e4: {CALIB_BATCHES} batches launched {counts}, "
            f"want {want}")
    require(set(scales) == inputs,
            f"e4: {len(scales)} scales for {len(inputs)} matmul inputs")
    bad = {k: v for k, v in scales.items() if not (np.isfinite(v) and v > 0)}
    require(not bad, f"e4: scales not finite and positive: {bad}")
    left = [n for n in scope.local_var_names()
            if n.endswith((".act_accum", ".act_state"))]
    require(not left, f"e4: observer state left in the scope: {left[:4]}")
    vals = sorted(scales.values())
    log(f"  e4: {len(scales)} activation scales (min {vals[0]:.4f}, median "
        f"{vals[len(vals) // 2]:.4f}, max {vals[-1]:.4f}) over "
        f"{CALIB_BATCHES} batches of {LM_PROGRAM_BATCH} x {LM_PROGRAM_SEQ} "
        f"tokens in {secs:.3f} s, {secs / CALIB_BATCHES:.4f} s a batch "
        f"(first run included) [{card}]")
    return {"calibrate": counts}, {
        "scales": len(scales), "batches": CALIB_BATCHES,
        "seconds": secs, "seconds_per_batch": secs / CALIB_BATCHES,
        "scale_min": vals[0], "scale_max": vals[-1],
        "parameters": n_params, "card": card}


def phase_e(torch, np, seed, card, out_dir, profile=False):
    """Phase e in the order e1, e3 (it compares its step with e1's), e2,
    e4; its own peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record, paths = {}, {}
    log("phase e1: VGG-16 with batch norm on CIFAR-10-sized images, batch "
        f"{VGG_BATCH}, fused Adam")
    paths["vgg"], record["e1"] = train_vgg(torch, np, seed, card, out_dir,
                                           profile)
    torch.cuda.empty_cache()
    log("phase e3: VGG-16 under quantization-aware training")
    paths["vgg_qat"], record["e3"] = train_vgg_qat(torch, np, seed, card,
                                                   out_dir, record["e1"])
    torch.cuda.empty_cache()
    log("phase e2: SE-ResNeXt-50's layout, batch "
        f"{SEX_BATCH} x {SEX_IMAGE}^2, fused Momentum + L2Decay")
    paths["se_resnext"], record["e2"] = train_se_resnext(
        torch, np, seed, card, out_dir, profile)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase e4: calibrate over gpt3_1p3b's int8 inference Program")
    p4, record["e4"] = calibrate_lm(torch, np, seed, card)
    paths.update(p4)
    record["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  phase e peak: {record['peak_gb']:.2f} GB allocated [{card}]")
    return paths, record


# -- phase 5: the everyday layers and QAT, card against CPU ----------------------


def card_vs_cpu_runs(np, fluid, main, startup, feeds, fetch, seed, std=None):
    """``main`` run over ``feeds`` on the card and on the CPU from the
    same state (the CPU startup's, or seeded normal parameters with
    ``std``): each run's fetched values by step and the final
    persistables."""
    from paddle_tpu_torch.io import load_scope_arrays

    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    persist = sorted(v.name for v in main.list_vars()
                     if v.persistable and not v.is_data)
    arrays = (seeded_arrays(np, main, cpu_scope, std, seed) if std
              else {n: cpu_scope.get_numpy(n) for n in persist})
    out = {}
    for name, place, dev in (("cuda", fluid.CUDAPlace(0), DEVICE),
                             ("cpu", fluid.CPUPlace(), "cpu")):
        exe, scope = fluid.Executor(place), fluid.Scope()
        load_scope_arrays(scope, arrays, main, dev)
        vals = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                fetch_list=fetch,
                                                scope=scope)]
                for f in feeds]
        out[name] = (vals, {n: scope.get_numpy(n) for n in persist})
    return out


def held(np, what, card, cpu, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    card, cpu = np.asarray(card), np.asarray(cpu)
    require(card.shape == cpu.shape, f"{what}: shape {card.shape} vs "
            f"{cpu.shape}")
    err = float(np.abs(card.astype(np.float64) - cpu).max()) if card.size \
        else 0.0
    ok = np.allclose(card, cpu, rtol=rtol, atol=atol, equal_nan=True)
    require(ok, f"{what}: card vs CPU {err:.3e} beyond rtol {rtol} / atol "
            f"{atol}")
    return err


def card_vs_cpu_lenet_qat(torch, np, seed, steps=3):
    """LeNet under the QuantizationTransformPass, fused Adam(1e-3), on
    MNIST-shaped batches: losses and every persistable (weights, moments,
    activation scale state) card vs CPU within the CPU tests' training
    tolerance; the card's steps launch K4, K5 and K10."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.contrib.slim import QuantizationTransformPass
    from paddle_tpu_torch.models.mnist import (build_lenet,
                                               synthetic_mnist_batch)

    fluid.set_flags({"optimizer_fuse": "on"})
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_lenet(
            fluid.optimizer.AdamOptimizer(1e-3))
        QuantizationTransformPass(startup_program=startup).apply(main)
    rng = np.random.RandomState(seed)
    feeds = [synthetic_mnist_batch(rng, 32) for _ in range(steps)]
    K.reset_launch_counts()
    runs = card_vs_cpu_runs(np, fluid, main, startup, feeds,
                            [fetches["loss"]], seed)
    n = len(main.all_parameters())
    counts = K.launch_counts()
    require(counts["softmax_xent_fwd"] == steps
            and counts["fused_adam_update"] == n * steps,
            f"LeNet QAT: the card's steps launched {counts}")
    (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
    loss_err = held(np, "LeNet QAT losses", [v[0] for v in lg],
                    [v[0] for v in lc])
    worst = max((held(np, f"LeNet QAT {k}", pg[k], pc[k]), k) for k in pc)
    log(f"  losses {[float(v[0]) for v in lg]}, within {loss_err:.3e} of the "
        f"CPU's; persistables within {worst[0]:.3e} ({worst[1]}; rtol "
        f"{TRAIN_RTOL} / atol {TRAIN_ATOL})")
    return {"losses_card": [float(v[0]) for v in lg],
            "losses_cpu": [float(v[0]) for v in lc],
            "loss_max_abs_err": loss_err, "state_max_abs_err": worst[0]}


UNARY_ACTS = ("tanh", "rsqrt", "log", "round", "softplus", "softsign",
              "relu6", "leaky_relu", "elu", "swish", "hard_sigmoid",
              "hard_swish", "logsigmoid", "sin", "erf", "stanh",
              "thresholded_relu", "hard_shrink", "soft_relu", "gelu")


def card_vs_cpu_everyday_ops(torch, np, seed):
    """One Program over a batch of 64: ``fc(act=a)`` for each of the 19
    new unary ops and gelu, the reduce family over their outputs, and
    the tensor ops (flatten, slice, strided_slice, stack / unstack,
    expand, gather, gather_nd, scatter, pad, cumsum, argsort, argmax,
    one_hot, shape), one loss; every output and X@GRAD card vs CPU
    within the CPU tests' training tolerance."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.initializer import ConstantInitializer

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data("x", [16], stop_gradient=False)
        ids = L.data("ids", [6], dtype="int64")
        outs, terms = {}, []
        for a in UNARY_ACTS:
            bias = (fluid.ParamAttr(initializer=ConstantInitializer(4.0))
                    if a in ("log", "rsqrt") else None)
            outs[a] = h = L.fc(x, 12, act=a, bias_attr=bias)
            terms.append(L.reduce_mean(h))
        h = L.reshape(L.stack([outs["tanh"], outs["elu"]], axis=1),
                      [-1, 2, 3, 4])
        outs["reduce_max"] = L.reduce_max(h, dim=[2, 3])
        outs["reduce_min"] = L.reduce_min(h, dim=1, keep_dim=True)
        outs["reduce_prod"] = L.reduce_prod(L.scale(h, bias=1.5), dim=3)
        outs["flatten"] = L.flatten(h, axis=2)
        outs["slice"] = L.slice(h, axes=[2, 3], starts=[1, 0], ends=[3, 3])
        outs["strided_slice"] = L.strided_slice(h, [3], [3], [0], [-2])
        a0, a1 = L.unstack(h, axis=1)
        outs["unstack"] = L.elementwise_sub(a0, a1)
        outs["expand"] = L.expand(h, [1, 1, 2, 1])
        outs["gather"] = L.gather(L.transpose(outs["swish"], [1, 0]),
                                  L.reshape(ids, [-1]))
        outs["gather_nd"] = L.gather_nd(h, L.cast(L.reshape(
            L.slice(ids, axes=[1], starts=[0], ends=[2]), [-1, 1, 2]),
            "int32"))
        outs["scatter"] = L.scatter(
            L.transpose(outs["gelu"], [1, 0]),
            L.fill_constant([3], "int64", 1),
            L.slice(L.transpose(outs["sin"], [1, 0]), axes=[0], starts=[0],
                    ends=[3]))
        outs["pad"] = L.pad(h, [0, 0, 1, 0, 0, 2, 1, 1], pad_value=0.5)
        outs["cumsum"] = L.cumsum(h, axis=3, exclusive=True, reverse=True)
        outs["sort"], outs["sort_idx"] = L.argsort(outs["tanh"], axis=1,
                                                   descending=True)
        outs["argmax"] = L.argmax(outs["relu6"], axis=1)
        outs["one_hot"] = L.one_hot(L.reshape(L.slice(
            ids, axes=[1], starts=[0], ends=[1]), [-1, 1]), 12)
        outs["shape"] = L.shape(h)
        for k in ("reduce_max", "reduce_min", "reduce_prod", "flatten",
                  "slice", "strided_slice", "unstack", "expand", "gather",
                  "gather_nd", "scatter", "pad", "cumsum", "sort"):
            terms.append(L.reduce_mean(outs[k]))
        loss = L.sums(terms)
        fluid.append_backward(loss)
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(64, 16).astype(np.float32),
            "ids": rng.randint(0, 2, (64, 6)).astype(np.int64)}
    keys = sorted(outs)
    runs = card_vs_cpu_runs(np, fluid, main, startup, [feed],
                            [outs[k] for k in keys] + [loss, "x@GRAD"], seed)
    card, cpu = runs["cuda"][0][0], runs["cpu"][0][0]
    worst = (0.0, "")
    for k, a, b in zip(keys + ["loss", "x@GRAD"], card, cpu):
        worst = max(worst, (held(np, f"everyday ops {k}", a, b), k))
    log(f"  {len(UNARY_ACTS)} activations through fc, {len(keys) - len(UNARY_ACTS)}"
        f" reduce / tensor outputs, the loss and x@GRAD: within "
        f"{worst[0]:.3e} ({worst[1]}; rtol {TRAIN_RTOL} / atol {TRAIN_ATOL})")
    return {"outputs": len(keys) + 2, "max_abs_err": worst[0],
            "worst": worst[1]}


def card_vs_cpu_se_resnext(torch, np, seed, steps=2):
    """The CI-sized SE-ResNeXt (depth 1-1-1, cardinality 8) on 16-pixel
    images, batch 4, fused Momentum + L2Decay: losses and every
    persistable card vs CPU within the CPU tests' training tolerance."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.vision import build_se_resnext

    fluid.set_flags({"optimizer_fuse": "on"})
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_se_resnext(
            10, 16, fluid.optimizer.MomentumOptimizer(
                0.05, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)))
    rng = np.random.RandomState(seed)
    feeds = [image_batch(np, seed + s, 4, 16) for s in range(steps)]
    K.reset_launch_counts()
    runs = card_vs_cpu_runs(np, fluid, main, startup, feeds,
                            [fetches["loss"]], seed)
    n = len(main.all_parameters())
    counts = K.launch_counts()
    require(counts["fused_momentum_update"] == n * steps
            and counts["softmax_xent_bwd"] == steps,
            f"SE-ResNeXt: the card's steps launched {counts}")
    (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
    loss_err = held(np, "SE-ResNeXt losses", [v[0] for v in lg],
                    [v[0] for v in lc])
    worst = max((held(np, f"SE-ResNeXt {k}", pg[k], pc[k]), k) for k in pc)
    del rng
    log(f"  losses {[float(v[0]) for v in lg]}, within {loss_err:.3e} of the "
        f"CPU's; persistables within {worst[0]:.3e} ({worst[1]})")
    return {"losses_card": [float(v[0]) for v in lg],
            "loss_max_abs_err": loss_err, "state_max_abs_err": worst[0]}


# -- phase f: the serving host tiers ------------------------------------------

# the page store's byte cap in phase f: phase 3's 16 prompts (7,551 tokens,
# 464 full pages) are 2.92 GB as raw float32 pages of 6,291,456 bytes (24
# layers x 2 x 16 heads x 16 slots x 128 x 4 bytes), and the flood of f4
# adds 496 pages of about 1.6 MB as int8_block; the flag's default of
# 256 MiB would hold about 40 raw pages
STORE_MAX_BYTES = 8 * 2 ** 30
# f4's flood: 8 prompts as long as gpt3_1p3b's 1024 positions allow with
# a token to generate
FLOOD_TOKENS = 1000
SPLIT_KEYS = ("requests_total", "responses_total", "handoffs_total",
              "handoff_failures_total", "cancelled_total",
              "pages_shipped_total", "pages_pulled_total",
              "store_lookups_total", "store_hits_total", "store_hit_rate",
              "store_pages", "wire_bytes_total", "fp32_bytes_total",
              "wire_ratio")


def split_service(pred, cfg, store_srv, kv_dtype):
    """One PrefillWorker and one DecodeWorker over one predictor (the
    weights shared), each with its own PageStoreClient to the store's
    loopback server, driven by a DisaggService; default geometry."""
    from paddle_tpu_torch.disagg import (DecodeWorker, DisaggService,
                                         PageStoreClient, PrefillWorker)

    def client():
        return PageStoreClient(store_srv.host, store_srv.port,
                               page_size=16, timeout_s=60.0)

    pf = PrefillWorker(pred, cfg, client(), kv_dtype=kv_dtype, warmup=True)
    dw = DecodeWorker(pred, cfg, client(), kv_dtype=kv_dtype, warmup=True)
    return DisaggService(prefill=[pf], decode=[dw])


def drain_checked(closable, engines, what):
    """``closable`` closes with a drain (each engine's trie spills to its
    store and is dropped); every engine keeps its invariants and holds
    zero pages in use."""
    closable.close(drain=True)
    for eng in engines:
        eng.cache.check_integrity()
        used = eng.stats()["cache"]["pages_in_use"]
        require(used == 0, f"{what}: {used} pages in use after the drain")


def split_launches(K, counts, svc, L, attn, what):
    """Both engines' steps launched exactly L attention kernels (``attn``)
    and 2L + 1 layer norms each, every step a graph replay."""
    steps = 0
    for w in svc._prefill + svc._decode:
        st = w.engine.stats()
        require_graphed(st, st["ragged_steps_total"],
                        f"{what} {w.engine.phase}")
        steps += st["ragged_steps_total"]
    other = ("ragged_paged_attention_q" if attn == "ragged_paged_attention"
             else "ragged_paged_attention")
    require(counts[attn] == L * steps and counts["layer_norm"]
            == (2 * L + 1) * steps and counts[other] == 0,
            f"{what}: {steps} steps of both engines launched {counts}")
    log(f"  {what}: {steps} engine steps (prefill + decode), {attn} "
        f"{counts[attn]} = {L} x {steps}, layer_norm {counts['layer_norm']}"
        f" = {2 * L + 1} x {steps}")
    return steps


def split_run(torch, np, K, pred, cfg, prompts, lengths, card, *, kv_dtype,
              encoding, base, tie_gate=True):
    """f1 / f2: phase 3's first ``F_PROMPTS`` prompts through the split
    over a TCP page store. Returns (launch counts, record, service, store server) with
    the service still open (f3 and f4 go on from it)."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.disagg import PageStoreServer, run_for_pool

    what = f"f {kv_dtype} pools, {encoding} wire"
    set_flags({"disagg_wire_encoding": encoding})
    store_srv = PageStoreServer(page_size=16, max_bytes=STORE_MAX_BYTES)
    t0 = time.perf_counter()
    svc = split_service(pred, cfg, store_srv, kv_dtype)
    boot = time.perf_counter() - t0
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    streams, wall = run_clients(svc, prompts, max_new)
    counts = K.launch_counts()
    check_streams(streams, max_new)
    L = cfg.num_layers
    attn = ("ragged_paged_attention_q" if kv_dtype == "int8"
            else "ragged_paged_attention")
    steps = split_launches(K, counts, svc, L, attn, what)
    sn = svc.stats_numeric()
    pf, dw = svc._prefill[0].engine, svc._decode[0].engine
    errs = [pf.store_errors_total, dw.store_errors_total]
    require(sn["handoffs_total"] == len(prompts)
            and sn["handoff_failures_total"] == 0 and errs == [0, 0],
            f"{what}: handoffs {sn['handoffs_total']}, failures "
            f"{sn['handoff_failures_total']}, store errors {errs}")
    require(sn["pages_pulled_total"] > 0 and sn["pages_shipped_total"] > 0,
            f"{what}: pages shipped {sn['pages_shipped_total']}, pulled "
            f"{sn['pages_pulled_total']}")
    # the decode side's spliced pages against the store's: bit for bit for
    # raw and int8 pages, within the blockwise bound for int8_block; and
    # the prefill side's exported pages against what the store holds
    from paddle_tpu_torch.kernels.quant import blockwise_error_bound

    checked, worst, bounded = 0, 0.0, 0
    for i, p in enumerate(prompts):
        # the pages the decode side pulled (one token is always left to
        # prefill, so a page-aligned prompt's last page is its own)
        n, k_run, v_run, ks, vs = dw.cache.export_run(
            p, max_pages=(len(p) - 1) // 16)
        if not n:
            continue
        got = run_for_pool(store_srv.store.match(p)[:n], kv_dtype)
        lossy = encoding == "int8_block" and kv_dtype == "float32"
        # raw and int8 pages: bit for bit (a page that an ingest under
        # pool pressure left to the decode side's own prefill is
        # computed as the prefill side computed it). f2's float32 pages
        # are held to the store's decoded pages within the bound below
        same = (np.array_equal(k_run, got[1])
                and np.array_equal(v_run, got[2])
                and (ks is None or (np.array_equal(ks, got[3])
                                    and np.array_equal(vs, got[4]))))
        require(lossy or same, f"{what}: request {i}: the spliced pages "
                "differ from the store's")
        if lossy and bounded < 2:
            # f2, two requests: the prefill pool's and the decode pool's
            # float32 pages against the decoded wire
            bounded += 1
            m, pk, pv, _, _ = pf.cache.export_run(p, max_pages=n)
            for a, b in ((pk[:m], got[1][:m]), (pv[:m], got[2][:m]),
                         (k_run, got[1]), (v_run, got[2])):
                for j in range(m):
                    bound = blockwise_error_bound(
                        a[j].reshape(-1, a.shape[-1]), a.shape[-1])
                    err = float(np.abs(a[j] - b[j]).max())
                    require(err <= bound + 1e-6, f"{what}: request {i} page "
                            f"{j}: decoded error {err} past the bound "
                            f"{bound}")
                    worst = max(worst, err / bound if bound else 0.0)
        checked += n
    require(checked > 0, f"{what}: no spliced page left to check")
    perf = serving_perf(torch, dw.stats(), streams, wall, lengths, card,
                        what=f"served ({what})")
    ms = svc.metrics.snapshot()
    st = store_srv.store.stats()
    perf.update(
        boot_s=boot, engine_steps_both=steps,
        prefill_steps=pf.stats()["ragged_steps_total"],
        service_ttft_ms_p50=ms["ttft_ms"]["p50"],
        handoff_ms_p50=ms["handoff_ms"]["p50"],
        handoff_ms_mean=ms["handoff_ms"]["mean"],
        prefill_ms_p50=ms["prefill_ms"]["p50"],
        split=dict((k, sn.get(k)) for k in SPLIT_KEYS),
        store_bytes=st["bytes"], store_max_bytes=st["max_bytes"],
        store_evictions=st["evictions_total"],
        wire_bytes_a_page=(st["wire_bytes_total"]
                           / max(1, st["put_pages_total"])),
        spliced_pages_checked=checked,
        worst_error_of_bound=(worst if encoding == "int8_block"
                              and kv_dtype == "float32" else None))
    log(f"  {what}: {sn['handoffs_total']} handoffs, handoff p50 "
        f"{perf['handoff_ms_p50']} ms (mean {perf['handoff_ms_mean']}), "
        f"prefill phase p50 {perf['prefill_ms_p50']} ms, service TTFT p50 "
        f"{perf['service_ttft_ms_p50']} ms; {sn['pages_shipped_total']} pages "
        f"shipped, {sn['pages_pulled_total']} pulled, wire "
        f"{st['wire_bytes_total']} bytes for {st['fp32_bytes_total']} "
        f"float32 bytes (ratio {st['wire_ratio']}), {checked} spliced pages "
        f"checked; store {st['bytes']} of {st['max_bytes']} bytes; engines "
        f"built in {boot:.1f} s [{card}]")
    if kv_dtype == "float32":
        oracle(np, pred, prompts, streams,
               rel=1e-3 if encoding == "raw" else ORACLE_REL["int8_block"])
    if tie_gate:
        perf["identical"], perf["differences"] = same_or_near_tie(
            np, pred, prompts, streams, base, what)
    else:
        perf["identical"] = sum(list(s.tokens) == list(b)
                                for s, b in zip(streams, base))
        log(f"  {what}: {perf['identical']} of {len(streams)} streams "
            "identical to phase 3's float32 tokens (reported, not gated)")
    return counts, perf, svc, store_srv


def warm_start(torch, np, K, pred, cfg, prompts, store_srv, cold, card):
    """f3: a fresh DecodeWorker on the store the drain spilled into serves
    f1's prompts warm; its tokens equal the cold split's."""
    from paddle_tpu_torch.disagg import DecodeWorker, PageStoreClient

    dw = DecodeWorker(pred, cfg, PageStoreClient(
        store_srv.host, store_srv.port, page_size=16, timeout_s=60.0),
        warmup=True)
    eng = dw.engine
    K.reset_launch_counts()
    streams, wall = run_clients(dw, prompts, 32)
    counts = K.launch_counts()
    check_streams(streams, 32)
    st = eng.stats()
    steps = st["ragged_steps_total"]
    require_graphed(st, steps, "f3 warm decode worker")
    require(counts["ragged_paged_attention"] == cfg.num_layers * steps,
            f"f3: {steps} steps launched {counts}")
    pulled = st["store"]["pages_pulled_total"]
    require(pulled > 0 and st["store"]["errors_total"] == 0,
            f"f3: {pulled} pages pulled, {st['store']['errors_total']} "
            "store errors")
    ttft = st["ttft_ms"]["p50"]
    perf = {"pages_pulled": pulled, "ttft_ms_p50": ttft,
            "cold_service_ttft_ms_p50": cold["service_ttft_ms_p50"],
            "warm_over_cold": ttft / cold["service_ttft_ms_p50"],
            "jax_cpu_gate": 0.5, "tokens_per_s": 32 * len(prompts) / wall,
            "wall_s": wall, "prefill_tokens": st["prefill_tokens_total"],
            "card": card}
    log(f"  f3: a fresh decode worker pulled {pulled} pages and prefilled "
        f"{st['prefill_tokens_total']} tokens; TTFT p50 warm {ttft} ms "
        f"against the cold split's {cold['service_ttft_ms_p50']} ms "
        f"(ratio {perf['warm_over_cold']:.3f}; the JAX bench's CPU gate "
        f"is 0.5, printed, not gated) [{card}]")
    perf["identical"], perf["differences"] = same_or_near_tie(
        np, pred, prompts, streams, cold["tokens"], "f3 warm against cold")
    drain_checked(dw, [eng], "f3")
    return counts, perf


def prefill_flood(torch, np, svc, cfg, seed, card, colocated):
    """f4: decode ITL while long prompts saturate the prefill tier,
    against the same decode worker idle. Reported, not gated: both tiers
    share the card's SMs."""
    rng = np.random.RandomState(seed + 4)
    pf = svc._prefill[0]

    def decode_wave(flood):
        stamps = [[] for _ in range(4)]
        short = [rng.randint(0, cfg.vocab_size, size=16).astype(np.int64)
                 for _ in range(4)]
        streams = [svc.submit(p, max_new_tokens=96,
                              on_token=lambda _t, i=i: stamps[i].append(
                                  time.perf_counter()))
                   for i, p in enumerate(short)]
        t_end = time.monotonic() + 300
        while any(len(s) < 2 for s in stamps) and time.monotonic() < t_end:
            time.sleep(0.005)
        t_flood = time.perf_counter()
        floods, errors = [], []

        def prefill(p):
            try:
                pf.prefill(p, timeout=600)
            except Exception as e:  # noqa: BLE001 — fails the phase below
                errors.append(repr(e))

        if flood:
            longs = [rng.randint(0, cfg.vocab_size, size=FLOOD_TOKENS)
                     .astype(np.int64) for _ in range(8)]
            floods = [threading.Thread(target=prefill, args=(p,))
                      for p in longs]
            for t in floods:
                t.start()
        for s in streams:
            s.result(timeout=600)
        t_done = time.perf_counter()
        for t in floods:
            t.join(600)
        require(not errors and not any(t.is_alive() for t in floods),
                f"f4: the flood's prefills failed: {errors[:2]}")
        gaps = [(b - a) * 1e3 for st in stamps for a, b in zip(st, st[1:])
                if a >= t_flood]
        return statistics.median(gaps), len(gaps), t_done - t_flood

    idle, n_idle, _ = decode_wave(False)
    busy, n_busy, window = decode_wave(True)
    pst = pf.engine.stats()
    perf = {"itl_ms_p50_idle": idle, "itl_ms_p50_flood": busy,
            "flood_over_idle": busy / idle, "gaps_idle": n_idle,
            "gaps_flood": n_busy, "flood_window_s": window,
            "colocated_ragged_itl_ms_p50": colocated.get("ragged"),
            "colocated_two_lane_itl_ms_p50": colocated.get("two_lane"),
            "jax_cpu_gate": 1.3, "prefill_steps": pst["ragged_steps_total"],
            "card": card}
    log(f"  f4: decode ITL p50 {busy:.3f} ms under a flood of 8 prompts of "
        f"{FLOOD_TOKENS} tokens on the prefill tier ({n_busy} gaps in {window:.2f} s), "
        f"{idle:.3f} ms idle (ratio {busy / idle:.3f}; the JAX bench's CPU "
        f"gate 1.3 is printed, not gated); co-located ragged "
        f"{colocated.get('ragged')} ms, two_lane {colocated.get('two_lane')} "
        f"ms (phases 3, 3b) [{card}]")
    return perf


def stalled_generate(host, port, payload):
    """A /v1/generate client that reads the head of its stream and stops
    reading (a tiny receive buffer): returns the socket, kept open."""
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
    s.settimeout(60)
    s.connect((host, port))
    body = json.dumps(payload).encode()
    s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    s.recv(256)
    return s


def traffic_http(torch, np, pred, svc, cfg, seed, card):
    """f5: the split behind the traffic tier over HTTP: quotas, a deadline
    shed before any batch slot, a stalled client's cancel, the unified
    /metrics, /healthz's phases, one trace across both tiers and the
    flight dump."""
    import http.client

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch.traffic import (TenantSpec, TrafficConfig,
                                          TrafficController)

    rng = np.random.RandomState(seed + 5)
    eng = ServingEngine(pred, start=False)
    ctl = TrafficController(eng, generation_engine=svc, config=TrafficConfig(
        queue_capacity=64, tenants={
            "alice": TenantSpec("alice", rate=100.0, burst=100.0),
            "bob": TenantSpec("bob", rate=0.01, burst=1.0)}))
    srv = ServingServer(eng, generation_engine=svc, traffic=ctl,
                        stream_write_timeout_s=0.5, sndbuf=1024)
    dw = svc._decode[0].engine
    rec = {}
    offered = 0
    sub0 = svc.metrics.snapshot()["requests_total"]
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
    try:
        def gen(tenant, cls, n=8, **extra):
            nonlocal offered
            offered += 1
            body = {"tokens": rng.randint(0, cfg.vocab_size, size=24)
                    .tolist(), "max_new_tokens": n, "stream": False}
            body.update(extra)
            return http_call(conn, "POST", "/v1/generate", body,
                             headers={"X-Tenant": tenant,
                                      "X-Priority": cls})

        t0 = time.perf_counter()
        for cls in ("interactive", "batch", "best_effort"):
            for _ in range(2):
                status, body, _ = gen("alice", cls)
                require(status == 200 and len(body["tokens"]) == 8,
                        f"f5: alice {cls}: {status} {body}")
        rec["six_requests_s"] = time.perf_counter() - t0
        status, body, _ = gen("bob", "interactive")
        require(status == 200, f"f5: bob's first request: {status} {body}")
        status, body, r = gen("bob", "interactive")
        require(status == 429 and int(r.getheader("Retry-After")) >= 1
                and body["kind"] == "shed:quota",
                f"f5: bob's second request: {status} {body}")
        rec["quota_shed"] = {"status": status,
                             "retry_after": r.getheader("Retry-After"),
                             "retry_after_s": body["retry_after_s"]}
        for _ in range(4):
            status, body, _ = gen("alice", "batch", deadline_ms=1.0)
            require(status == 503 and body["kind"] == "shed:infeasible",
                    f"f5: an unmeetable deadline answered {status} {body}")
        # a stalled client beside a healthy stream
        pages0 = dw.cache.stats()["active_seqs"]
        max_new = 1000          # 16 + 1000 of gpt3_1p3b's 1024 positions
        offered += 1
        t_stall = time.perf_counter()
        sock = stalled_generate(srv.host, srv.port, {
            "tokens": rng.randint(0, cfg.vocab_size, size=16).tolist(),
            "max_new_tokens": max_new, "eos_id": None})
        healthy = rng.randint(0, cfg.vocab_size, size=24).tolist()
        offered += 1
        lines, _ = stream_generate(srv.host, srv.port,
                                   {"tokens": healthy, "max_new_tokens": 16,
                                    "eos_id": None},
                                   headers={"X-Tenant": "alice"})
        require(lines[-1].get("done") and lines[-1]["n_tokens"] == 16,
                f"f5: the healthy stream ended {lines[-1]}")
        t_end = time.monotonic() + 120
        while time.monotonic() < t_end:
            st = dw.stats()
            if st["cancelled_total"] >= 1 and st["active_seqs"] == pages0:
                break
            time.sleep(0.02)
        freed_s = time.perf_counter() - t_stall
        st = dw.stats()
        sock.close()
        itl = st["itl_ms"]["p50"] / 1e3
        require(st["cancelled_total"] >= 1 and st["active_seqs"] == pages0,
                f"f5: the stalled stream was not cancelled: {st}")
        require(freed_s < max_new * itl,
                f"f5: the stalled stream's lane freed after {freed_s:.2f} s, "
                f"past its generation's {max_new * itl:.2f} s")
        rec["stall"] = {"freed_s": freed_s,
                        "generation_would_take_s": max_new * itl,
                        "decoded_total": st["decode_tokens_total"]}
        # the shed accounting, exact
        tst = ctl.stats()
        shed = sum(tst["shed"].values())
        submitted = svc.metrics.snapshot()["requests_total"] - sub0
        require(submitted + shed == offered,
                f"f5: {submitted} submitted to the service + {shed} shed != "
                f"{offered} offered ({tst['shed']})")
        rec["accounting"] = {"offered": offered, "engine_submitted":
                             submitted, "shed": tst["shed"]}
        # one scrape holds every tier
        status, text, _ = http_call(conn, "GET", "/metrics")
        for fam in ("paddle_traffic_", "paddle_disagg_",
                    "paddle_generation_", "paddle_serving_"):
            require(status == 200 and f"\n{fam}" in text,
                    f"f5: /metrics has no {fam}* series")
        rec["metrics_lines"] = text.count("\n")
        status, health, _ = http_call(conn, "GET", "/healthz")
        phases = sorted({w["phase"] for w in health.get("phases", [])})
        require(status == 200 and phases == ["decode", "prefill"]
                and health.get("phase") == "disagg" and "traffic" in health,
                f"f5: /healthz {status} {health}")
        # one trace across both tiers and the page store
        set_flags({"observability_tracing": True,
                   "observability_flight_capacity": 8192})
        try:
            from paddle_tpu_torch.observability import propagate, tracing

            client = tracing.SpanContext(tracing._new_id(),
                                         tracing._new_id())
            lines, _ = stream_generate(
                srv.host, srv.port,
                {"tokens": rng.randint(0, cfg.vocab_size, size=40).tolist(),
                 "max_new_tokens": 4, "eos_id": None},
                headers=propagate.inject(client))
            offered += 1
            require(lines[0].get("trace_id") == client.trace_id,
                    f"f5: the stream's first line {lines[0]}")
            status, trace, _ = http_call(
                conn, "GET", f"/v1/admin/trace/{client.trace_id}")
        finally:
            set_flags({"observability_tracing": False,
                       "observability_flight_capacity": 512})
        names = sorted({s["name"] for s in trace.get("spans", [])})
        require(status == 200 and {"serving/http_generate", "disagg/handoff",
                                   "disagg/prefill_phase",
                                   "disagg/decode_submit"} <= set(names)
                and "generation/submit" in names
                and any(n.startswith("pagestore/") for n in names)
                and propagate.orphan_spans(
                    trace["spans"], known_parents=(client.span_id,)) == [],
                f"f5: trace {status} {names}")
        rec["trace_spans"] = names
        status, dump, _ = http_call(conn, "POST", "/v1/admin/flight/dump",
                                    {})
        require(status == 200 and os.path.isfile(dump["path"]),
                f"f5: flight dump {status} {dump}")
        with open(dump["path"]) as f:
            payload = json.load(f)
        require(payload["reason"].startswith("admin:")
                and "paddle_disagg_handoffs_total"
                in payload["metrics"]["collected"],
                "f5: the flight dump lacks the registry's disagg series")
        os.remove(dump["path"])
        rec["flight_dump_entries"] = len(payload["entries"])
        rec["traffic"] = {k: tst[k] for k in ("admitted", "shed", "goodput",
                                              "deadline_miss")}
        log(f"  f5: quota shed 429 Retry-After {rec['quota_shed']}; "
            f"{offered} offered = {submitted} submitted + {shed} shed; the "
            f"stalled stream's lane freed {freed_s:.2f} s after its send "
            f"(its generation would take {max_new * itl:.1f} s); /metrics "
            f"{rec['metrics_lines']} lines with every tier; /healthz phases "
            f"{phases}; trace spans {names}; flight dump of "
            f"{rec['flight_dump_entries']} entries [{card}]")
    finally:
        conn.close()
        srv.close()
        ctl.close(drain=True)
        eng.close()
    return rec


# f6's pool: one worker, so the rolling restart boots one replacement
F6_WORKERS = 1


def worker_pool(torch, np, seed, card, tmp):
    """f6: ResNet-50 saved for inference, served by ``F6_WORKERS``
    spawned workers on the card behind SO_REUSEPORT; requests from 8
    threads run through a rolling restart with none failed; the fleet
    view merges the pool's and this process's exposition under worker=
    labels with the SLO gauges."""
    import http.client
    import re

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.resnet import build_resnet50
    from paddle_tpu_torch.observability import FleetAggregator, SLOMonitor
    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch.traffic import WorkerPool

    main, startup, _feeds, _fetches = build_resnet50(1000, RESNET_IMAGE)
    test = main.clone(for_test=True)
    softmax = [op for op in test.global_block().ops if op.type == "softmax"]
    prob = softmax[-1].output("Out")[0]
    exe, scope, _ = startup_on_card(torch, np, fluid, main, startup, seed)
    d = os.path.join(tmp, "resnet50")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["image"], [prob], exe, test)
    del exe, scope
    cfg = Config(d)
    cfg.enable_shape_bucketing(batch_buckets=(1,))
    pred = create_predictor(cfg, device=DEVICE)
    rng = np.random.RandomState(seed + 6)
    images = [rng.randn(1, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)
              for _ in range(4)]
    want = [pred.run([x])[0] for x in images]
    bodies = [json.dumps({"inputs": {"image": x.tolist()}}).encode()
              for x in images]
    t0 = time.perf_counter()
    # batch 1 requests, served one a batch: a worker warms one shape
    pool = WorkerPool(d, num_workers=F6_WORKERS, use_reuseport=True,
                      device=DEVICE,
                      batch_buckets=[1],
                      warmup_shapes={"image": [1, 3, RESNET_IMAGE,
                                               RESNET_IMAGE]},
                      engine_kwargs={"max_batch_size": 1, "num_workers": 1},
                      ready_timeout_s=300.0)
    boot = time.perf_counter() - t0
    results, errors = [], []
    restarting = threading.Event()
    restarting.set()

    retries = []

    def client(c):
        n = 0
        while restarting.is_set() or n < 8:
            i = (c + n) % len(images)
            # a fresh connection a request; one that a closing listener's
            # backlog held dies before any response byte, and is retried
            # as a load balancer does (the JAX harness's rule,
            # tools/traffic_replay.py:1190); a request that got a status
            # line and then failed is a failure
            for _attempt in range(5):
                conn = http.client.HTTPConnection(pool.host, pool.port,
                                                  timeout=120)
                try:
                    conn.request("POST", "/v1/predict", bodies[i],
                                 {"Content-Type": "application/json",
                                  "Connection": "close"})
                    r = conn.getresponse()
                except OSError as e:
                    conn.close()
                    retries.append(repr(e))
                    time.sleep(0.02)
                    continue
                try:
                    body = json.loads(r.read())
                    if r.status != 200:
                        errors.append((r.status, body))
                    else:
                        got = np.asarray(next(iter(
                            body["outputs"].values())), np.float32)
                        results.append(float(np.abs(got - want[i]).max()))
                except Exception as e:  # noqa: BLE001 — severed mid-response
                    errors.append(repr(e))
                conn.close()
                break
            else:
                errors.append(f"no response in 5 connections: {retries[-1]}")
            n += 1
            time.sleep(0.5)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    try:
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        report = pool.rolling_restart()
        restart_s = time.perf_counter() - t0
        restarting.clear()
        for t in threads:
            t.join(600)
        require(not any(t.is_alive() for t in threads), "f6: a client hung")
        require(errors == [], f"f6: {len(errors)} failed requests: "
                f"{errors[:3]}")
        require(len(results) >= 64, f"f6: only {len(results)} requests")
        require(max(results) <= RESNET_PROB_ATOL,
                f"f6: a worker's softmax is {max(results)} off this "
                "process's")
        require(all(not d_.get("forced") for d_ in report["drained"]),
                f"f6: a drain was forced: {report['drained']}")
        agg = FleetAggregator(slo=SLOMonitor(), timeout_s=10.0)
        agg.watch_pool(pool)
        own = ServingEngine(pred, start=False)
        front = ServingServer(own, fleet=agg)
        agg.add_endpoint(front.address, worker="driver", phase="both")
        try:
            conn = http.client.HTTPConnection(front.host, front.port,
                                              timeout=60)
            status, text, _ = http_call(conn, "GET", "/metrics/fleet")
            conn.close()
        finally:
            front.close()
            own.close()
        workers = sorted(set(re.findall(r'worker="([^"]+)"', text)))
        require(status == 200 and workers == ["driver", "pool"]
                and "paddle_slo_deadline_miss_ratio" in text
                and re.search(r'paddle_serving_requests_total\{[^}]*'
                              r'worker="pool"', text),
                f"f6: /metrics/fleet {status}, workers {workers}")
        served = [d_.get("responses_total") for d_ in report["drained"]]
        rec = {"requests": len(results), "failed": len(errors),
               "connect_retries": len(retries),
               "max_abs_diff": max(results), "boot_s": boot,
               "restart_s": restart_s,
               "worker_boot_s": [w.get("boot_s") for w in report["cold"]
                                 + report["replacements"]],
               "worker_warmup_ms": [w.get("warmup_ms") for w in
                                    report["cold"] + report["replacements"]],
               "served_by_drained_workers": served,
               "fleet_workers": workers, "card": card}
        log(f"  f6: {len(results)} requests through a rolling restart of "
            f"{F6_WORKERS} worker(s) ({restart_s:.1f} s), none failed ({len(retries)} "
            f"connections reset before a response, retried), softmax within "
            f"{max(results):.2e} of this process's; workers booted in "
            f"{rec['worker_boot_s']} s (pool up in {boot:.1f} s), the drained "
            f"ones served {served}; /metrics/fleet merges workers {workers} "
            f"with the paddle_slo_* gauges [{card}]")
    finally:
        restarting.clear()
        pool.close()
    return rec


F_PROMPTS = 2    # f1-f3: the first 2 of phase 3's 16 prompts


def phase_f(torch, np, seed, card, out_dir, record):
    """Phase f: gpt3_1p3b served split (f1-f4), behind the traffic tier
    over HTTP (f5), and a spawned worker pool (f6)."""
    import tempfile

    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.generation import GenerationEngine

    t_phase = time.perf_counter()
    out, paths = {}, {}
    cfg, pred = gpt3_predictor(torch, seed)
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    base = record.get("serve", {}).get("tokens")
    if base is None:
        log("  phase 3 did not run: its co-located float32 run is made here")
        with GenerationEngine(pred, cfg, warmup=True) as eng:
            streams, _ = run_clients(eng, prompts[:F_PROMPTS], 32)
        base = [list(s.tokens) for s in streams]
    # f1-f3 serve the first F_PROMPTS of phase 3's prompts (every gate
    # kept, half the tokens and the store traffic)
    lengths, prompts, base = (lengths[:F_PROMPTS], prompts[:F_PROMPTS],
                              base[:F_PROMPTS])
    log(f"  f1-f3 on the first {F_PROMPTS} of phase 3's 16 prompts")

    log("phase f1: the split over a TCP page store, float32 pools, raw wire")
    paths["split_f32"], out["f1_f32"], svc, store_srv = split_run(
        torch, np, K, pred, cfg, prompts, lengths, card, kv_dtype="float32",
        encoding="raw", base=base)
    drain_checked(svc, [w.engine for w in svc._prefill + svc._decode], "f1")
    log("phase f3: a fresh decode worker on the store the drain spilled into")
    paths["warm_start"], out["f3"] = warm_start(
        torch, np, K, pred, cfg, prompts, store_srv, out["f1_f32"], card)
    store_srv.close()
    del svc
    gc.collect()
    torch.cuda.empty_cache()

    log("phase f1: int8 pools, pages shipped verbatim; the co-located int8 "
        "engine first")
    K.reset_launch_counts()
    with GenerationEngine(pred, cfg, kv_dtype="int8", prefix_cache=True,
                          warmup=True) as eng8:
        streams8, _ = run_clients(eng8, prompts, 32)
    check_streams(streams8, 32)
    base8 = [list(s.tokens) for s in streams8]
    paths["split_int8"], out["f1_int8"], svc, store_srv = split_run(
        torch, np, K, pred, cfg, prompts, lengths, card, kv_dtype="int8",
        encoding="int8_block", base=base8)
    drain_checked(svc, [w.engine for w in svc._prefill + svc._decode],
                  "f1 int8")
    store_srv.close()
    del svc, eng8
    gc.collect()
    torch.cuda.empty_cache()

    log("phase f2: float32 pools over the int8_block wire")
    paths["split_wire"], out["f2"], svc, store_srv = split_run(
        torch, np, K, pred, cfg, prompts, lengths, card, kv_dtype="float32",
        encoding="int8_block", base=base, tie_gate=False)
    ratio = out["f2"]["split"]["wire_ratio"]
    require(ratio <= 0.30, f"f2: wire bytes {ratio} of the float32 bytes")
    try:
        log("phase f4: decode ITL under a prefill flood")
        K.reset_launch_counts()
        out["f4"] = prefill_flood(torch, np, svc, cfg, seed, card, {
            "ragged": record.get("serve", {}).get("itl_ms_p50"),
            "two_lane": record.get("serve_two_lane", {}).get("itl_ms_p50")})
        paths["flood"] = K.launch_counts()
        log("phase f5: the split behind the traffic tier over HTTP")
        K.reset_launch_counts()
        out["f5"] = traffic_http(torch, np, pred, svc, cfg, seed, card)
        paths["traffic_http"] = K.launch_counts()
    finally:
        set_flags({"disagg_wire_encoding": "int8_block"})
    drain_checked(svc, [w.engine for w in svc._prefill + svc._decode],
                  "f2-f5")
    store_srv.close()
    del svc, pred
    gc.collect()
    torch.cuda.empty_cache()

    log("phase f6: ResNet-50 served by a worker pool through a rolling "
        "restart")
    with tempfile.TemporaryDirectory(prefix="pt_phase_f_") as tmp:
        out["f6"] = worker_pool(torch, np, seed, card, tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase f: {out['phase_s']:.1f} s [{card}]")
    return paths, out


# -- phase g: the data tiers -----------------------------------------------------


FLOWERS_BATCH, FLOWERS_CLASSES = 64, 102   # phase 8's batch, Oxford-102
FLOWERS_PROFILE_STEPS = 3
G1_STOP, G1_RESUME_TO, G1_EVERY = 6, 10, 3
MS_FILES, MS_BATCHES, MS_THREADS = 8, 32, 4


def flowers_program(fluid):
    """phase 8's ResNet-50 recipe at 102 classes."""
    from paddle_tpu_torch.models.resnet import build_resnet50

    with fluid.unique_name.guard():
        main, startup, feeds, fetches = build_resnet50(
            FLOWERS_CLASSES, RESNET_IMAGE, resnet_optimizer(fluid),
            data_format="NCHW")
    return main, startup, [feeds["image"], feeds["label"]], fetches["loss"]


def flowers_loader(fluid, feed_vars, reader):
    loader = fluid.DataLoader.from_generator(feed_vars, capacity=8)
    return loader.set_sample_list_generator(reader,
                                            places=[fluid.CUDAPlace(0)])


def checked_batches(torch, loader, host_feeds, seen):
    """The loader's batches as they reach the step, each held to the
    numpy feed the plain run made of the same rows: equal bit for bit."""
    for i, b in enumerate(loader):
        for name, arr in host_feeds[i].items():
            require(torch.equal(b[name].cpu(), torch.from_numpy(arr)),
                    f"g1: batch {i}'s {name} differs from the plain feed")
        seen.append(i)
        yield b


def flowers_epoch(torch, fluid, exe, main, scope, feed_vars, loss, reader,
                  mode, host_feeds=None):
    """One epoch of ``reader``: ``plain`` (DataFeeder + exe.run a batch;
    ``host_feeds`` collects the numpy feeds) or ``pipelined`` (the
    DataLoader into run_pipelined; with ``host_feeds`` every batch is
    held to them). Returns the losses and the epoch's wall seconds."""
    losses = []
    t = time.perf_counter()
    if mode == "plain":
        feeder = fluid.DataFeeder(feed_vars, fluid.CUDAPlace(0))
        for rows in reader():
            feed = feeder.feed(rows)
            if host_feeds is not None:
                host_feeds.append(feed)
            losses.append(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])
    else:
        loader = flowers_loader(fluid, feed_vars, reader)
        seen = []
        src = (loader if host_feeds is None
               else checked_batches(torch, loader, host_feeds, seen))
        for (lv,) in exe.run_pipelined(main, src, [loss], scope=scope):
            losses.append(lv)
        if host_feeds is not None:
            require(seen == list(range(len(host_feeds))),
                    f"g1: {len(seen)} loader batches checked")
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t


def same_state(torch, main, a, b):
    """Every persistable of ``main`` in scopes a and b, equal bit for
    bit (the first name that differs, or None)."""
    for v in main.list_vars():
        if v.persistable and not v.is_data and a.find_var(v.name) is not None:
            if not torch.equal(a.find_var(v.name), b.find_var(v.name)):
                return v.name
    return None


def device_trace_names(path):
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e["name"] for e in events
               if str(e.get("cat", "")).lower() == "kernel"]
    return {e.get("name") for e in events}, kernels


def phase_g1(torch, np, seed, card, out_dir):
    """ResNet-50 fed by the flowers reader: plain against pipelined bit
    for bit (deterministic cuDNN), images/s of both, the overlap, a
    profiled window and a Supervisor resume over the loader."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import datasets, profiler, resilience
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.observability import overlap_telemetry

    fluid.set_flags({"optimizer_fuse": "auto"})
    main, startup, feed_vars, loss = flowers_program(fluid)
    reader = fluid.io.batch(datasets.flowers.train(), FLOWERS_BATCH,
                            drop_last=True)
    steps = datasets.flowers.TRAIN_SIZE // FLOWERS_BATCH
    out = {"card": card, "steps_an_epoch": steps}

    def fresh(startup_seed=seed):
        startup.random_seed = startup_seed
        main.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        return exe, scope

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host_feeds = []
        exe_a, scope_a = fresh()
        la, _ = flowers_epoch(torch, fluid, exe_a, main, scope_a, feed_vars,
                              loss, reader, "plain", host_feeds)
        exe_b, scope_b = fresh()
        lb, _ = flowers_epoch(torch, fluid, exe_b, main, scope_b, feed_vars,
                              loss, reader, "pipelined", host_feeds)
        require(len(la) == len(lb) == steps, f"g1: {len(la)} / {len(lb)} steps")
        require([a.tobytes() for a in la] == [b.tobytes() for b in lb],
                f"g1: pipelined losses {lb} differ from plain {la}")
        bad = same_state(torch, main, scope_a, scope_b)
        require(bad is None, f"g1: {bad} differs after the epoch")
        ref = [float(v.reshape(-1)[0]) for v in la]
        require(all(np.isfinite(ref)), f"g1: non-finite loss {ref}")
        log(f"  g1: {steps} steps of {FLOWERS_BATCH} flowers images, plain "
            f"and pipelined equal bit for bit (losses, every persistable, "
            f"the batches at the step); losses {ref}")
        del exe_b, scope_b, host_feeds
        gc.collect()

        log("phase g1: a Supervisor over the loader, stopped at step "
            f"{G1_STOP} and resumed")
        root = os.path.abspath(os.path.join(CKPT_ROOT, "g1"))
        shutil.rmtree(root, ignore_errors=True)
        got = {}
        for run, (startup_seed, upto) in enumerate(((seed, G1_STOP),
                                                    (seed + 1, G1_RESUME_TO))):
            exe, scope = fresh(startup_seed)
            sup = resilience.Supervisor(
                exe, main, root, data=flowers_loader(fluid, feed_vars, reader),
                fetch_list=[loss], scope=scope,
                policy=resilience.CheckpointPolicy(root, every_steps=G1_EVERY,
                                                   keep_last=2),
                on_step=lambda s, f: got.__setitem__(s, f[0].tobytes()))
            stats = sup.run_loop(upto)
            if run == 1:
                require(stats["resumed_from"] == G1_STOP,
                        f"g1: resumed from {stats['resumed_from']}")
            del exe, scope, sup
            gc.collect()
        shutil.rmtree(root, ignore_errors=True)
        want = {s: la[s].tobytes() for s in range(G1_RESUME_TO)}
        require(got == want, "g1: the supervised and resumed losses differ "
                "from the uninterrupted run's at steps "
                f"{sorted(s for s in want if got.get(s) != want[s])}")
        out["resume"] = {"stopped_at": G1_STOP, "resumed_to": G1_RESUME_TO,
                         "bitwise": True}
        log(f"  g1: steps 0-{G1_STOP - 1}, then a fresh Executor and scope "
            f"(startup seed {seed + 1}) resumed at {G1_STOP} to "
            f"{G1_RESUME_TO}: every loss equals the uninterrupted run's")
    finally:
        torch.backends.cudnn.deterministic = det

    # the producer alone (reader + DataFeeder, no step): what a batch
    # costs the host before any copy
    feeder = fluid.DataFeeder(feed_vars, fluid.CUDAPlace(0))
    t = time.perf_counter()
    for rows in reader():
        feeder.feed(rows)
    out["producer_ms_a_batch"] = (time.perf_counter() - t) * 1e3 / steps
    # images/s with the default cuDNN algorithms, each run in a fresh scope
    exe, scope = fresh()
    K.reset_launch_counts()
    _, wall_a = flowers_epoch(torch, fluid, exe, main, scope, feed_vars, loss,
                              reader, "plain")
    exe, scope = fresh()
    tel0 = overlap_telemetry().snapshot()
    K.reset_launch_counts()
    lp, wall_b = flowers_epoch(torch, fluid, exe, main, scope, feed_vars,
                               loss, reader, "pipelined")
    counts = K.launch_counts()
    tel1 = overlap_telemetry().snapshot()
    want = {n: 0 for n in K.KERNELS}
    want.update(fused_momentum_update=161 * steps, softmax_xent_fwd=steps,
                softmax_xent_bwd=steps)
    require(counts == want, f"g1: pipelined epoch launches {counts}")
    feed_ms = tel1["feed_ms_sum"] - tel0["feed_ms_sum"]
    wait_ms = tel1["wait_ms_sum"] - tel0["wait_ms_sum"]
    overlap = {"steps": tel1["steps"] - tel0["steps"], "feed_ms_sum": feed_ms,
               "wait_ms_sum": wait_ms,
               "hidden_fraction": (1.0 - min(wait_ms, feed_ms) / feed_ms
                                   if feed_ms > 0 else 0.0)}
    n = steps * FLOWERS_BATCH
    out.update(plain_images_per_s=n / wall_a, pipelined_images_per_s=n / wall_b,
               plain_epoch_s=wall_a, pipelined_epoch_s=wall_b,
               overlap=overlap, launches=counts)
    log(f"  g1: the producer alone {out['producer_ms_a_batch']:.3f} ms a "
        f"batch; plain {n / wall_a:.2f} images/s ({wall_a:.3f} s an epoch), "
        f"pipelined {n / wall_b:.2f} images/s ({wall_b:.3f} s); overlap "
        f"{json.dumps(overlap)}; exactly 161 K10m, one K4, one K5 a step "
        f"[{card}]")

    log(f"phase g1: {FLOWERS_PROFILE_STEPS} pipelined steps under "
        "profiler.profiler()")
    few = fluid.io.batch(datasets.common.firstn(
        datasets.flowers.train(), FLOWERS_PROFILE_STEPS * FLOWERS_BATCH),
        FLOWERS_BATCH)
    logdir = os.path.join(out_dir, "g1_profile")
    shutil.rmtree(logdir, ignore_errors=True)
    os.makedirs(logdir)
    t = time.perf_counter()
    with profiler.profiler(profile_path=logdir):
        flowers_epoch(torch, fluid, exe, main, scope, feed_vars, loss, few,
                      "pipelined")
    wall = time.perf_counter() - t
    trace = os.path.join(logdir, profiler.TRACE_FILE)
    names, kernels = device_trace_names(trace)
    host = {e["name"] for e in profiler.host_events()}
    momentum = sum(1 for k in kernels if "momentum_kernel" in k)
    spans = {"reader/prefetch", "dispatch/feed", "dispatch/step"}
    require(spans <= names, f"g1: the device trace lacks {spans - names}")
    require(spans <= host, f"g1: the host events lack {spans - host}")
    require(momentum == 161 * FLOWERS_PROFILE_STEPS,
            f"g1: {momentum} K10m kernels in the trace")
    out["profile"] = {"wall_s": wall, "kernels": len(kernels),
                      "k10m_kernels": momentum, "spans": sorted(spans),
                      "trace_mb": os.path.getsize(trace) / 1e6}
    shutil.rmtree(logdir, ignore_errors=True)
    log(f"  g1: the chrome trace holds {sorted(spans)} and {momentum} K10m "
        f"kernels of {len(kernels)} ({out['profile']['trace_mb']:.1f} MB)")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    return {"g1_flowers": counts}, out


def write_multislot(np, seed, out_dir):
    """MS_BATCHES batches of Criteo-layout DeepFM rows (26 ids, 13 dense
    floats, a label) from ``seed``, as MultiSlot lines in MS_FILES files.
    Floats are written as the shortest decimal of their float32 value,
    so both parsers read the same bits back."""
    from paddle_tpu_torch.models.ctr import synthetic_ctr_batch

    rng = np.random.RandomState(seed)
    F, D = CTR["num_fields"], CTR["dense_dim"]
    batches = [synthetic_ctr_batch(rng, CTR_BATCH, F, CTR["vocab_size"], D)
               for _ in range(MS_BATCHES)]
    per = MS_BATCHES // MS_FILES
    paths = []
    for f in range(MS_FILES):
        lines = []
        for b in batches[f * per:(f + 1) * per]:
            ids, dense = b["sparse_ids"].tolist(), b["dense_x"].tolist()
            lab = b["label"].reshape(-1).tolist()
            for i in range(CTR_BATCH):
                lines.append(f"{F} " + " ".join(map(str, ids[i]))
                             + f" {D} " + " ".join(map(repr, dense[i]))
                             + f" 1 {lab[i]!r}\n")
        path = os.path.join(out_dir, f"part-{f:05d}")
        with open(path, "w") as fh:
            fh.write("".join(lines))
        paths.append(path)
    return paths


def recorded(run, log_to, lock):
    """``run`` that appends (batch key, loss) of each call to ``log_to``."""
    def wrapped(*a, **kw):
        out = run(*a, **kw)
        key = kw["feed"]["sparse_ids"][:4].tobytes()
        with lock:
            log_to.append((key, out[0].tobytes()))
        return out
    return wrapped


def phase_g2(torch, np, seed, card, out_dir, profile=False):
    """DeepFM (d4's configuration, sparse Adam) from MultiSlot files:
    native against Python parses, InMemoryDataset with 4 threads and a
    local shuffle, train_from_dataset at thread 1 (equal to exe.run bit
    for bit) and 4 (Hogwild: every batch once, losses falling)."""
    import tempfile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dataset as ds_mod
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.ctr import build_deepfm
    from paddle_tpu_torch.native import datafeed

    fluid.set_flags({"optimizer_fuse": "auto"})
    out = {"card": card}
    main, startup, feeds, fetches = build_deepfm(
        optimizer=fluid.optimizer.AdamOptimizer(1e-3), is_sparse=True, **CTR)
    main.random_seed = startup.random_seed = seed
    loss = fetches["loss"]
    use = [main.global_block().var(feeds[k])
           for k in ("ids", "dense", "label")]
    with tempfile.TemporaryDirectory(prefix="pt_phase_g_") as tmp:
        t = time.perf_counter()
        paths = write_multislot(np, seed, tmp)
        nbytes = sum(os.path.getsize(p) for p in paths)
        out["write_s"] = time.perf_counter() - t

        require(datafeed.available(), "g2: the native parser did not build")
        ds = ds_mod.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_batch_size(CTR_BATCH)
        ds.set_thread(MS_THREADS)
        ds.set_filelist(paths)
        ds.set_use_var(use)
        dtypes = [ds._var_dtypes[n] for n in ds._use_var_names]
        t = time.perf_counter()
        native = [r for p in paths
                  for r in datafeed.parse_file(p, len(use), dtypes)]
        native_s = time.perf_counter() - t
        t = time.perf_counter()
        python = [r for p in paths for r in ds._parse_file_py(p)]
        python_s = time.perf_counter() - t
        require(len(native) == len(python) == MS_BATCHES * CTR_BATCH,
                f"g2: {len(native)} native / {len(python)} Python rows")
        for i, (a, b) in enumerate(zip(native, python)):
            if not all(x.dtype == y.dtype and np.array_equal(x, y)
                       for x, y in zip(a, b)):
                raise SmokeFailure(f"g2: row {i} differs between parsers")
        del native, python
        t = time.perf_counter()
        ds.load_into_memory()
        load_s = time.perf_counter() - t
    ds.local_shuffle(seed)
    batches = list(ds._iter_batches())
    require(len(batches) == MS_BATCHES, f"g2: {len(batches)} batches")
    mb = nbytes / 1e6
    out.update(files=MS_FILES, rows=MS_BATCHES * CTR_BATCH, mb=mb,
               native_parse_mb_per_s=mb / native_s,
               python_parse_mb_per_s=mb / python_s,
               load_into_memory_s=load_s)
    log(f"  g2: {MS_FILES} files, {mb:.1f} MB of {MS_BATCHES * CTR_BATCH} "
        f"rows written in {out['write_s']:.2f} s; native parse "
        f"{mb / native_s:.1f} MB/s, Python {mb / python_s:.1f} MB/s (rows "
        f"equal); load_into_memory ({MS_THREADS} threads) {load_s:.2f} s")

    def fresh():
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        return exe, scope

    exe, scope = fresh()
    ref = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0].tobytes()
           for b in batches]
    keys = sorted(b["sparse_ids"][:4].tobytes() for b in batches)
    del exe, scope
    gc.collect()

    runs = {}
    for thread in (1, MS_THREADS):
        exe, scope = fresh()
        lock, seen = threading.Lock(), []
        if thread == 1:
            exe.run = recorded(exe.run, seen, lock)
        else:
            exe._hogwild_exe = fluid.Executor(fluid.CUDAPlace(0))
            exe._hogwild_exe.run = recorded(exe._hogwild_exe.run, seen, lock)
        K.reset_launch_counts()
        prof = start_profile(torch) if profile else None
        t = time.perf_counter()
        exe.train_from_dataset(main, ds, scope, thread=thread,
                               fetch_list=[loss], print_period=10 ** 9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = K.launch_counts()
        run = {"wall_s": wall,
               "samples_per_s": MS_BATCHES * CTR_BATCH / wall,
               "launches": counts}
        if prof is not None:
            prof.__exit__(None, None, None)
            run["profile"] = trace_breakdown(prof, out_dir,
                                             f"g2_thread{thread}", wall,
                                             MS_BATCHES)
        require(sorted(k for k, _ in seen) == keys,
                f"g2 thread {thread}: the batches run are not each batch "
                "once")
        losses = [float(np.frombuffer(v, np.float32)[0]) for _, v in seen]
        require(all(np.isfinite(losses)), f"g2 thread {thread}: {losses}")
        half = len(losses) // 2
        first, last = np.mean(losses[:half]), np.mean(losses[half:])
        require(last < first, f"g2 thread {thread}: losses did not fall "
                f"(first half {first:.6f}, second {last:.6f})")
        if thread == 1:
            require([v for _, v in seen] == ref,
                    "g2: train_from_dataset(thread=1) losses differ from "
                    "exe.run over the same batches")
            n_dense = len(main.all_parameters()) - 2
            require(counts["fused_adam_update"] == n_dense * MS_BATCHES
                    and sum(counts.values()) == counts["fused_adam_update"],
                    f"g2: launches {counts}")
        run.update(losses=losses, first_half=first, second_half=last)
        runs[thread] = run
        log(f"  g2 thread {thread}: {MS_BATCHES} batches in {wall:.3f} s, "
            f"{run['samples_per_s']:.1f} samples/s, mean loss {first:.6f} -> "
            f"{last:.6f}" + (" (equal to exe.run bit for bit)" if thread == 1
                             else ", every batch once")
            + (f", device idle {run['profile']['device_idle_share']:.3f}"
               if prof is not None else "") + f" [{card}]")
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    out["thread1"], out[f"thread{MS_THREADS}"] = runs[1], runs[MS_THREADS]
    return {"g2_deepfm": runs[1]["launches"]}, out


def phase_g(torch, np, seed, card, out_dir, profile=False):
    t_phase = time.perf_counter()
    log("phase g1: ResNet-50 trained from the flowers reader, plain and "
        "through the DataLoader into run_pipelined")
    paths, out = {}, {}
    try:
        p1, out["g1"] = phase_g1(torch, np, seed, card, out_dir)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    paths.update(p1)
    log("phase g2: DeepFM from MultiSlot files through InMemoryDataset and "
        "train_from_dataset")
    p2, out["g2"] = phase_g2(torch, np, seed, card, out_dir, profile)
    paths.update(p2)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase g: {out['phase_s']:.1f} s [{card}]")
    return paths, out


# -- phase h: distribution -------------------------------------------------------


H_STEPS = 3                 # h1 and h2 (a), (b)
H2_LAYERS, H2_LR = 2, 3e-4  # h2: gpt3_1p3b's widths at 2 layers
H2_MOE_STEPS = 3
# the relative L2 error of a gradient Adam took in (its first moment,
# 0.1 of the step's gradient after one step), against the reference's;
# a gradient zeroed, of the wrong sign or without its 1/n reads 0.5-2
H2_GRAD_RTOL = 1e-4
H2_DGC_STEPS, H2_DGC_LR = 5, 0.1
H2_ELASTIC_STEPS = 6
H_BUCKET_MB = "25"          # the fp32 bucket cap of h1 and h2 (MB)
H2_TIMEOUT_S = 600


def h_train_want(K, L, flash=True):
    want = {name: 0 for name in K.KERNELS}
    want.update(layer_norm=2 * L + 1, layer_norm_bwd=2 * L + 1,
                softmax_xent_fwd=1, softmax_xent_bwd=1,
                fused_adam_update=12 * L + 6)
    if flash:
        want.update(flash_attention_fwd=L, flash_attention_bwd=L)
    return want


def build_dp_lm(fluid, cfg, seq, lr, fleet_opt=None, bucket_mb="0",
                quant="none", make_opt=None):
    """``build_gpt_lm``'s program (the optimizer appended inside the
    same name guard, as ``build_gpt_lm(cfg, seq, AdamOptimizer(lr))``
    does), minimized plainly or through ``fleet_opt(optimizer)``; the
    ``collective_*`` flags are set around the minimize, which plans the
    gradient buckets."""
    from paddle_tpu_torch.models.gpt import build_gpt_lm

    fluid.set_flags({"collective_bucket_mb": bucket_mb,
                     "collective_quantization": quant})
    try:
        with fluid.unique_name.guard():
            main, startup, _, fetches = build_gpt_lm(cfg, seq)
            with fluid.program_guard(main, startup):
                opt = (make_opt(fluid) if make_opt
                       else fluid.optimizer.AdamOptimizer(lr))
                (fleet_opt(opt) if fleet_opt else opt).minimize(
                    fetches["loss"])
    finally:
        fluid.set_flags({"collective_bucket_mb": "0",
                         "collective_quantization": "none"})
    return main, startup, fetches


def phase_h1(torch, np, seed, card, out_dir, phase4=None):
    """h1: gpt3_1p3b data-parallel at a world of one over NCCL, phase 4's
    flash recipe through ``fleet.distributed_optimizer`` with the fp32
    bucket planner: 3 steps whose losses and every parameter equal the
    plain flash step's from the same seed bit for bit, exact launches;
    then the int8 planner (an identity at one rank, as the JAX
    package's)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.gpt import GPTConfig, synthetic_lm_batch
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    from paddle_tpu_torch.parallel.env import (init_parallel_env,
                                               shutdown_parallel_env,
                                               world_backend)

    cfg = GPTConfig.gpt3_1p3b()
    cfg.use_flash_attention = True
    L = cfg.num_layers
    fluid.set_flags({"optimizer_fuse": "auto"})
    batch = synthetic_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               TRAIN_SEQ, cfg.vocab_size)
    want = h_train_want(K, L)
    out = {}

    log("  h1 reference: phase 4's flash recipe, plain")
    main, startup, fetches = build_dp_lm(fluid, cfg, TRAIN_SEQ, 3e-4)
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    _, ref = run_steps(torch, np, K, exe, main, scope, batch,
                       fetches["loss"], want, H_STEPS, TRAIN_ROWS, card,
                       out_dir, "h1_ref")
    ref_params = {p.name: scope.find_var(p.name).cpu()
                  for p in main.all_parameters()}
    if phase4 is not None:
        require(ref["losses"] == phase4["losses"][:H_STEPS],
                f"h1's plain steps {ref['losses']} are not phase 4's "
                f"{phase4['losses'][:H_STEPS]}")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()

    init_parallel_env(backend="nccl", world_size=1, rank=0)
    try:
        require(world_backend() == "nccl", "no NCCL world")
        paths = {}
        for quant in ("none", "int8"):
            fleet = fleet_mod.fleet
            fleet.init(fleet_mod.UserDefinedRoleMaker(current_id=0,
                                                      worker_num=1))
            strategy = fleet_mod.DistributedStrategy()
            main, startup, fetches = build_dp_lm(
                fluid, cfg, TRAIN_SEQ, 3e-4, bucket_mb=H_BUCKET_MB, quant=quant,
                fleet_opt=lambda o: fleet.distributed_optimizer(o, strategy))
            prog = fleet.main_program
            plan = main._collective_plan
            require(plan is not None and prog._mesh.shape == {"dp": 1},
                    "fleet did not plan and compile the program")
            exe, scope, _ = startup_on_card(torch, np, fluid, main, startup,
                                            seed)
            before = comm.STATS.snapshot()
            log(f"  h1 fleet data-parallel, world 1 over NCCL, "
                f"collective_quantization={quant}")
            totals, perf = run_steps(
                torch, np, K, exe, prog, scope, batch, fetches["loss"], want,
                H_STEPS, TRAIN_ROWS, card, out_dir, f"h1_{quant}")
            after = comm.STATS.snapshot()
            snap = plan.snapshot()
            wire = (snap["wire_bytes_saved_ratio"] if snap["dp"] > 1
                    else 1.0)
            nccl_bytes = (after["comm_bytes_total"]
                          - before["comm_bytes_total"]) / H_STEPS
            if quant == "none":
                require(perf["losses"] == ref["losses"],
                        f"h1 losses {perf['losses']} != plain "
                        f"{ref['losses']}")
                diff = [n for n, t in ref_params.items()
                        if not torch.equal(scope.find_var(n).cpu(), t)]
                require(not diff, f"h1 parameters differ from the plain "
                        f"run's: {diff[:4]}")
                require(nccl_bytes >= 4 * n_params,
                        f"h1 handed {nccl_bytes} bytes a step to NCCL")
                paths["dp_fleet"] = totals
            else:
                rel = max(abs(a - b) / max(abs(b), 1e-9)
                          for a, b in zip(perf["losses"], ref["losses"]))
                require(rel < 0.02, f"int8 losses diverged by {rel:.3e}")
                paths["dp_fleet_int8"] = totals
                perf["loss_rel_vs_fp32"] = rel
            perf.update(buckets=snap["buckets"],
                        bucket_bytes_max=snap["bucket_bytes_max"],
                        grads=snap["grads_total"], wire_ratio=wire,
                        collective_bytes_per_step=nccl_bytes)
            log(f"  {snap['buckets']} buckets over {snap['grads_total']} "
                f"gradients (largest {snap['bucket_bytes_max'] / 2**20:.1f} "
                f"MiB), {nccl_bytes / 1e9:.3f} GB a step through the comm "
                f"layer, wire ratio {wire:.3f}; mean step "
                f"{perf['step_ms_mean']:.3f} ms beside the plain "
                f"{ref['step_ms_mean']:.3f} ms"
                + (f" and phase 4's {phase4['step_ms_mean']:.3f} ms"
                   if phase4 else "") + f" [{card}]")
            out[quant] = perf
            del exe, scope
            gc.collect()
            torch.cuda.empty_cache()
        log(f"  h1: {H_STEPS} fleet steps equal the plain flash steps bit "
            f"for bit (losses {ref['losses']}, all {len(ref_params)} "
            "parameters); int8 at one rank is the identity")
    finally:
        shutdown_parallel_env()
    out["reference"] = ref
    return paths, out


def h2_config(moe=False):
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers = H2_LAYERS
    cfg.use_flash_attention = True
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    if moe:
        cfg.moe_every = 2     # d1's: a switch-MoE FFN in every second layer
    return cfg


def h2_batch(np, seed, cfg):
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch

    return synthetic_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                              TRAIN_SEQ, cfg.vocab_size)


def first_moments(main, scope):
    """{parameter name: Adam's first moment as the scope holds it}."""
    return {v.accumulator_owner: scope.find_var(v.name)
            for v in main.global_block().vars.values()
            if getattr(v, "is_accumulator", False) and "moment1" in v.name}


def rel_l2(got, want):
    """||got - want|| / ||want|| (the plain norm where want is 0)."""
    d = float((got.double() - want.double()).norm())
    w = float(want.double().norm())
    return d / w if w else d


def h2_reference(torch, np, seed, card, ref_path):
    """The single-process references of h2, on the card, saved for the
    world's ranks to hold themselves to: ``dense``, the 2-layer model 3
    steps over the 2 x 1024 batch ((a), (b)), and ``moe``, the MoE model
    the same ((c) psum, whose ranks route the whole batch), each with
    its losses, its parameters and Adam's first moments after the last
    step; ``moe_merge``, the MoE model through
    ``GradientMergeOptimizer(Adam, k_steps=2)``, each row routed alone at
    a row's capacity and the two rows' gradients averaged, as the ranks
    of (c)'s world at ep 1 do, one step. Its load-balance loss is a
    row's where the world's sums both rows' statistics, so only its loss
    and the moments of the parameters that loss does not reach (the
    experts, the final layer norm and the head) are the world's."""
    import paddle_tpu_torch as fluid

    fluid.set_flags({"optimizer_fuse": "auto"})
    merge = lambda fl: fl.optimizer.GradientMergeOptimizer(  # noqa: E731
        fl.optimizer.AdamOptimizer(H2_LR), k_steps=TRAIN_BATCH, avg=True)
    ref = {}
    for name, moe, steps, make_opt in (
            ("dense", False, H_STEPS, None),
            ("moe", True, H2_MOE_STEPS, None),
            ("moe_merge", True, 1, merge)):
        cfg = h2_config(moe)
        batch = h2_batch(np, seed, cfg)
        main, startup, fetches = build_dp_lm(fluid, cfg, TRAIN_SEQ, H2_LR,
                                             make_opt=make_opt)
        exe, scope, _ = startup_on_card(torch, np, fluid, main, startup,
                                        seed)
        losses = [float(np.asarray(exe.run(
            main, feed=batch, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]) for _ in range(steps)]
        ref[name] = {"losses": losses, "m1": {
            k: v.cpu() for k, v in first_moments(main, scope).items()}}
        if make_opt is None:
            ref[name]["params"] = {p.name: scope.find_var(p.name).cpu()
                                   for p in main.all_parameters()}
        log(f"  h2 reference {name}: losses {losses}")
        del exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.save(ref, ref_path + ".part")
    os.replace(ref_path + ".part", ref_path)
    log(f"  h2 references saved: {os.path.getsize(ref_path) / 1e9:.2f} GB "
        f"in {time.perf_counter() - t0:.1f} s")
    return {k: {"losses": v["losses"]} for k, v in ref.items()}


def _bit_sums(torch, params):
    """Two sums of every parameter's int32 words (plain and squared,
    wrapping), a cheap fingerprint of its bits that the ranks compare
    every step."""
    out = []
    for t in params:
        w = t.detach().contiguous().view(torch.int32).to(torch.int64)
        out.append(torch.stack([w.sum(), (w * w).sum()]))
    return torch.stack(out).cpu()


def aux_reach(main):
    """The parameters the switch-MoE load-balance loss reaches: the
    router weight and every parameter upstream of the MoE layer's input
    (a walk back over the forward ops)."""
    from paddle_tpu_torch.core.framework import OpRole

    fwd = [op for op in main.global_block().ops
           if not int(op.attrs.get("op_role", 0))
           & (OpRole.Backward | OpRole.Optimize)]
    need = set()
    for op in fwd:
        if op.type == "switch_moe":
            need.update(op.inputs["X"] + op.inputs["GateW"])
    for op in reversed(fwd):
        if any(o in need for outs in op.outputs.values() for o in outs):
            need.update(i for ins in op.inputs.values() for i in ins)
    return {p.name for p in main.all_parameters() if p.name in need}


def h2_child(argv) -> int:
    """One rank of h2's world of 2 on one card (gloo): (a) data
    parallel, (b) ZeRO-1, (c) the MoE at ep 2 under psum and alltoall,
    (d) DGC; results to ``<dir>/h2.rank<r>.json``."""
    out_dir, seed = argv[0], int(argv[1])
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.sharding import (layout,
                                                    shard_optimizer_states)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    fluid.set_flags({"optimizer_fuse": "auto"})
    # written by the launching process while the ranks started; read
    # lazily: a rank touches its own experts' slices only
    wait_for_file(os.path.join(out_dir, "h2_ref.pt"), H2_TIMEOUT_S)
    ref = torch.load(os.path.join(out_dir, "h2_ref.pt"), mmap=True)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}

    def same_across_ranks(sums):
        parts = [torch.zeros_like(sums) for _ in range(n)]
        torch.distributed.all_gather(parts, sums)
        return all(torch.equal(parts[0], p) for p in parts[1:])

    def run(cfg, make_prog, steps, rows, make_opt=None, fetch_enc=None,
            bucket_mb="0", keep_first=False):
        """``steps`` steps of ``make_prog``'s program on ``rows`` of the
        batch: (numbers, main, scope, the first moments after the first
        step when ``keep_first``)."""
        batch = h2_batch(np, seed, cfg)
        feed = {k: v[rows] for k, v in batch.items()}
        main, startup, fetches = build_dp_lm(fluid, cfg, TRAIN_SEQ, H2_LR,
                                             make_opt=make_opt,
                                             bucket_mb=bucket_mb)
        prog = make_prog(main, fetches["loss"])
        main.random_seed = startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        # the replicated parameters (each rank holds its own experts)
        params = [p for p in main.all_parameters()
                  if not getattr(p, "_moe_expert_param", False)]
        fetch = [fetches["loss"]] + ([fetch_enc(main)] if fetch_enc else [])
        losses, ms, same, spars = [], [], [], []
        m1_first = None
        K.reset_launch_counts()
        s0 = comm.STATS.snapshot()
        for step in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            o = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(o[0].reshape(-1)[0]))
            if fetch_enc:
                spars.append(float((o[1] == 0).float().mean()))
            same.append(same_across_ranks(_bit_sums(
                torch, [scope.find_var(p.name) for p in params])))
            if keep_first and step == 0:
                m1_first = {k: v.clone()
                            for k, v in first_moments(main, scope).items()}
        s1 = comm.STATS.snapshot()
        moments = sum(scope.find_var(v.name).numel() * 4
                      for v in main.global_block().vars.values()
                      if getattr(v, "is_accumulator", False))
        res = {"losses": losses, "step_ms": ms,
               "step_ms_mean": statistics.mean(ms[1:]),
               "replicas_same_each_step": same, "moment_bytes": moments,
               "launches": K.launch_counts(),
               "comm": {k: s1[k] - s0[k] for k in s1}}
        if spars:
            res["enc_zero_share"] = spars
        return res, main, scope, m1_first

    def local(want, got):
        """The reference's value as this rank holds it: its E/ep experts
        of an expert parameter (rank r holds [r * E/ep, (r + 1) * E/ep)),
        on the card."""
        if got.shape != want.shape:
            e = got.shape[0]
            want = want[rank * e:(rank + 1) * e]
        return want.to(got.device)

    def held_to(res, main, scope, r, m1):
        """The parameters' largest gap to the reference ``r`` (when it
        holds them), and the first moments' relative L2 error, the
        largest among the parameters the load-balance loss reaches and
        among the rest."""
        if "params" in r:
            worst, wn = 0.0, ""
            for p in main.all_parameters():
                got = scope.find_var(p.name)
                d = float((got - local(r["params"][p.name], got)).abs().max())
                if d > worst:
                    worst, wn = d, p.name
            res["param_max_abs_err"], res["param_worst"] = worst, wn
        reach = aux_reach(main)
        for part, names in (("exact", [k for k in m1 if k not in reach]),
                            ("aux", [k for k in m1 if k in reach])):
            rels = {k: rel_l2(m1[k], local(r["m1"][k], m1[k]))
                    for k in names}
            k = max(rels, key=rels.get) if rels else ""
            res[f"grad_rel_{part}"] = rels.get(k, 0.0)
            res[f"grad_worst_{part}"] = k

    cfg = h2_config()
    # (a) data parallel over the fp32 buckets: one row a rank
    dp = lambda main, loss: fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    res, main, scope, _ = run(cfg, dp, H_STEPS, slice(rank, rank + 1),
                              bucket_mb=H_BUCKET_MB)
    res["buckets"] = len(main._collective_plan.buckets) \
        if getattr(main, "_collective_plan", None) else 0
    held_to(res, main, scope, ref["dense"], first_moments(main, scope))
    kept = {v.name: scope.find_var(v.name).clone()
            for v in main.global_block().vars.values()
            if v.persistable and (getattr(v, "is_accumulator", False)
                                  or v.name in {p.name for p in
                                                main.all_parameters()})}
    out["dp"] = res
    del scope
    # (b) ZeRO-1: the same steps with the moments cut in two; its
    # parameters, and its chunk of every moment, equal to (a)'s
    zero = lambda main, loss: (shard_optimizer_states(main, n),
                               dp(main, loss))[1]
    res, main, scope, _ = run(cfg, zero, H_STEPS, slice(rank, rank + 1),
                              bucket_mb=H_BUCKET_MB)
    chunks = layout(scope)
    res["moments_sharded"] = sum(
        1 for k in kept if k in chunks)
    res["equal_to_dp"] = (res["losses"] == out["dp"]["losses"] and all(
        torch.equal(scope.find_var(k),
                    chunks[k].take(v) if k in chunks else v)
        for k, v in kept.items()))
    out["zero1"] = res
    del scope, kept
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the MoE. psum at ep 2: both ranks route all rows, held to the
    # single-process run. alltoall at ep 2, a row a rank: held to the
    # same world at ep 1 (dp 2: each rank all 8 experts, a row's
    # capacity and the load-balance loss over both rows, as alltoall's,
    # without the dispatch), whose first step is held to the gradient
    # merge of the rows where the load-balance loss does not reach
    mcfg = h2_config(moe=True)
    row = slice(rank, rank + 1)

    def ep(e, d):
        return lambda main, loss: fluid.CompiledProgram(
            main).with_expert_parallel(ep=e, dp=n // e, dispatch=d)

    for key, make, rows in (
            ("moe_psum", ep(n, "psum"), slice(0, TRAIN_BATCH)),
            ("moe_dp", ep(1, "alltoall"), row),
            ("moe_alltoall", ep(n, "alltoall"), row)):
        res, main, scope, m1_first = run(mcfg, make, H2_MOE_STEPS, rows,
                                         keep_first=key == "moe_dp")
        m1 = first_moments(main, scope)
        if key == "moe_psum":
            held_to(res, main, scope, ref["moe"], m1)
        elif key == "moe_dp":
            held_to(res, main, scope, ref["moe_merge"], m1_first)
            kept = {"m1": {k: v.clone() for k, v in m1.items()},
                    "params": {p.name: scope.find_var(p.name).clone()
                               for p in main.all_parameters()}}
        else:
            held_to(res, main, scope, kept, m1)
            del kept
        res["experts_held"] = [int(scope.find_var(p.name).shape[0])
                               for p in main.all_parameters()
                               if getattr(p, "_moe_expert_param", False)]
        out[key] = res
        del scope, m1, m1_first
        gc.collect()
        torch.cuda.empty_cache()
    # (d) DGC at sparsity 0.999, rampup from step 1
    dgc_opt = lambda fl: fl.optimizer.DGCMomentumOptimizer(
        H2_DGC_LR, momentum=0.9, rampup_begin_step=1, rampup_step=1,
        sparsity=[0.999])
    enc = lambda main: next(n_ for n_ in main.global_block().vars
                            if n_.startswith("dec0_ffn1.w")
                            and ".dgc_enc" in n_)
    res, main, scope, _ = run(cfg, dp, H2_DGC_STEPS, slice(rank, rank + 1),
                              make_opt=dgc_opt, fetch_enc=enc)
    out["dgc"] = res
    del scope
    # (e)'s uninterrupted run, in this world
    clean = os.path.join(out_dir, "clean")
    os.makedirs(clean, exist_ok=True)
    t0 = time.perf_counter()
    elastic_run(clean, seed, "")
    out["elastic_clean_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"h2.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def h2_elastic_child(argv) -> int:
    """One rank of h2 (e) in a world of its own: ``elastic_run`` with
    ``argv[2]`` the fault spec of generation 0."""
    elastic_run(argv[0], int(argv[1]), argv[2] if len(argv) > 2 else "")
    return 0


def elastic_run(out_dir, seed, fault):
    """h2 (e): a data-parallel Supervisor run (a small GPT, commits
    every 2 steps) whose losses go to ``<dir>/loss.g<gen>.r<rank>``;
    ``fault`` fires in generation 0 only."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.distributed import coordinator
    from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                             synthetic_lm_batch)

    c = coordinator.initialize()
    fluid.set_flags({"resilience_fault_spec": fault if c.restart_count == 0
                     else ""})
    cfg = GPTConfig.tiny()
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(
            cfg, 64, fluid.optimizer.AdamOptimizer(1e-3))
    main.random_seed = startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=fetches["loss"].name)

    def feed(step):
        b = synthetic_lm_batch(np.random.RandomState(seed + step), 2 * 4,
                               64, cfg.vocab_size)
        return {k: v[c.rank * 4:(c.rank + 1) * 4] for k, v in b.items()}

    log_path = os.path.join(out_dir, f"loss.g{c.restart_count}.r{c.rank}")

    def on_step(step, fetched):
        with open(log_path, "a") as f:
            f.write(json.dumps([step, float(np.asarray(fetched[0])
                                            .reshape(-1)[0])]) + "\n")

    ck = os.path.join(out_dir, "ck")
    resilience.Supervisor(
        exe, prog, ck, feed_fn=feed, fetch_list=[fetches["loss"]],
        scope=scope, policy=resilience.CheckpointPolicy(
            ck, every_steps=2, keep_last=3),
        on_step=on_step).run_loop(H2_ELASTIC_STEPS)


def launch_world(args, out_dir, timeout, restarts=0, meanwhile=None):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
    --backend gloo chip_smoke.py <args>`` from the checkout, with
    ``meanwhile()`` run in this process while the ranks start; returns
    (exit code, stderr, seconds, what ``meanwhile`` returned). If
    ``meanwhile`` raises, the launcher is told to stop the world."""
    from paddle_tpu_torch.parallel.env import free_port

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--backend=gloo",
         f"--started_port={free_port()}", f"--max_restarts={restarts}",
         "--kill_grace_s=10", f"--run_dir={os.path.join(out_dir, 'run')}",
         os.path.abspath(__file__)] + list(args),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root)
    try:
        got = meanwhile() if meanwhile else None
        _, err = proc.communicate(timeout=timeout)
    except BaseException:
        # the launcher escalates SIGTERM to its ranks
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise
    return proc.returncode, err, time.perf_counter() - t0, got


def wait_for_file(path, timeout_s):
    """Wait until ``path`` exists (written elsewhere, then renamed into
    place)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.2)


def elastic_losses(out_dir, rank):
    losses = {}
    for gen in range(3):
        p = os.path.join(out_dir, f"loss.g{gen}.r{rank}")
        if os.path.exists(p):
            for line in open(p):
                step, val = json.loads(line)
                losses[step] = val
    return [losses[s] for s in sorted(losses)]


def phase_h2(torch, np, seed, card, out_dir):
    """h2: a world of 2 on the one card (gloo, both ranks on cuda:0)
    through the launcher; this process runs the single-process
    references and holds the ranks' results to them."""
    h2_dir = os.path.abspath(os.path.join(out_dir, "h2"))
    shutil.rmtree(h2_dir, ignore_errors=True)
    os.makedirs(h2_dir)
    try:
        # (e)'s killed world runs beside the main one, once the
        # references are made (both are gloo worlds of 2 on the card)
        d = os.path.join(h2_dir, "killed")
        os.makedirs(d)
        elastic = {}

        def killed_world():
            elastic["res"] = launch_world(
                ["--h2-elastic", d, str(seed), "r1:kill@5"], d, 300, 1)

        t_el = threading.Thread(target=killed_world)

        def references():
            t0 = time.perf_counter()
            ref = h2_reference(torch, np, seed, card,
                               os.path.join(h2_dir, "h2_ref.pt"))
            t_el.start()
            return ref, time.perf_counter() - t0

        # the ranks start while this process makes the references
        try:
            code, err, secs, (ref, ref_s) = launch_world(
                ["--h2-child", h2_dir, str(seed)], h2_dir, H2_TIMEOUT_S,
                meanwhile=references)
        finally:
            if t_el.is_alive() or t_el.ident is not None:
                t_el.join()
        require(code == 0, f"h2's world exited {code}: {err[-3000:]}")
        ranks = [json.load(open(os.path.join(h2_dir, f"h2.rank{r}.json")))
                 for r in range(2)]
        r0, r1 = ranks
        rtol = CARD_VS_CPU_RTOL["gpt_flash"]

        def rel(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        for rk in ranks:
            require(rk["backend"] == "gloo", "h2 world not over gloo")
            for key in ("dp", "zero1", "moe_psum", "moe_dp", "moe_alltoall",
                        "dgc"):
                require(all(rk[key]["replicas_same_each_step"]),
                        f"h2 {key}: the replicas differ")
        # every reading of (a)-(c) is logged before any is held
        holds = []

        def hold(cond, msg):
            holds.append((cond, msg))

        a, b = r0["dp"], r0["zero1"]
        e_dp = rel(a["losses"], ref["dense"]["losses"])
        limit = 2 * H2_LR * H_STEPS
        log(f"  (a) dp: losses {a['losses']} vs single {ref['dense']['losses']}"
            f" (rel {e_dp:.3e}, rtol {rtol}); first moments within "
            f"{a['grad_rel_exact']:.3e} ({a['grad_worst_exact']}; "
            f"{H2_GRAD_RTOL:.0e}); params within {a['param_max_abs_err']:.3e}"
            f" (2 * lr * steps = {limit:.1e}); {a['buckets']} buckets; mean "
            f"of steps 2-{H_STEPS} {a['step_ms_mean']:.1f} ms; comm "
            f"{a['comm']} [{card}]")
        hold(e_dp <= rtol, f"h2 (a) losses {a['losses']} vs single "
             f"{ref['dense']['losses']}: {e_dp:.3e}")
        hold(a["grad_rel_exact"] <= H2_GRAD_RTOL,
             f"h2 (a) {a['grad_worst_exact']}'s first moment off by "
             f"{a['grad_rel_exact']:.3e}")
        hold(a["param_max_abs_err"] <= limit,
             f"h2 (a) {a['param_worst']} off by {a['param_max_abs_err']}")
        hold(a["buckets"] >= 2, f"h2 (a) {a['buckets']} buckets")
        log(f"  (b) zero1: losses, parameters and each rank's chunk of "
            f"every moment ({b['moments_sharded']} sharded) equal to (a)'s "
            f"bit for bit; moments a rank {b['moment_bytes'] / 1e9:.3f} GB "
            f"against {a['moment_bytes'] / 1e9:.3f} GB; mean of steps "
            f"2-{H_STEPS} {b['step_ms_mean']:.1f} ms; comm {b['comm']} "
            f"[{card}]")
        hold(all(rk["zero1"]["equal_to_dp"] for rk in ranks),
             "h2 (b) ZeRO-1 is not (a) bit for bit")
        hold(b["moments_sharded"] > 0 and
             2 * b["moment_bytes"] <= a["moment_bytes"] + 2 ** 20,
             f"h2 (b) a rank holds {b['moment_bytes']} moment bytes "
             f"against {a['moment_bytes']}")
        lim_c = 2 * H2_LR * H2_MOE_STEPS
        for key, what, want in (
                ("moe_psum", "the single-process run", ref["moe"]["losses"]),
                ("moe_dp", "the rows' gradient merge",
                 ref["moe_merge"]["losses"]),
                ("moe_alltoall", "the world at ep 1", r0["moe_dp"]["losses"])):
            ms = [rk[key] for rk in ranks]
            m = ms[0]
            e = rel(m["losses"][:len(want)], want)
            g_exact = max(x["grad_rel_exact"] for x in ms)
            g_aux = max(x["grad_rel_aux"] for x in ms)
            # the merge's load-balance loss is a row's (h2_reference):
            # the world at ep 1 is held to its first loss and to its
            # first moments where that loss does not reach
            g = g_exact if key == "moe_dp" else max(g_exact, g_aux)
            held = ([x == 8 for rk in ms for x in rk["experts_held"]]
                    if key == "moe_dp" else
                    [x == 4 for rk in ms for x in rk["experts_held"]])
            log(f"  (c) {key}: losses {m['losses']} vs {what}'s {want} "
                f"(rel {e:.3e}); first moments after the "
                + ("first" if key == "moe_dp" else "last")
                + f" step within {g_exact:.3e} where the load-balance loss "
                f"does not reach ({m['grad_worst_exact']}) and {g_aux:.3e} "
                f"where it does ({m['grad_worst_aux']})"
                + ("" if key == "moe_dp" else
                   f"; params within {m['param_max_abs_err']:.3e} "
                   f"({lim_c:.1e})")
                + f"; experts a rank {m['experts_held'][0]} of 8; mean of "
                f"steps 2-{H2_MOE_STEPS} {m['step_ms_mean']:.1f} ms; comm "
                f"{m['comm']} [{card}]")
            hold(e <= rtol, f"h2 (c) {key}: losses {m['losses']} vs "
                 f"{want}: {e:.3e}")
            hold(g <= H2_GRAD_RTOL,
                 f"h2 (c) {key}: first moments off by {g:.3e}")
            if key != "moe_dp":
                hold(m["param_max_abs_err"] <= lim_c,
                     f"h2 (c) {key}: {m['param_worst']} off by "
                     f"{m['param_max_abs_err']}")
            hold(all(held), f"h2 (c) {key}: experts held "
                 f"{m['experts_held']}")
        for cond, msg in holds:
            require(cond, msg)
        g = r0["dgc"]
        require(all(np.isfinite(g["losses"])) and
                g["losses"][-1] < g["losses"][0],
                f"h2 (d) DGC losses {g['losses']}")
        log(f"  (d) dgc: losses {g['losses']}, dec0_ffn1.w's encoded zeros "
            f"{g['enc_zero_share']}; replicas equal every step; mean of "
            f"steps 2-{H2_DGC_STEPS} {g['step_ms_mean']:.1f} ms [{card}]")
        # (e) elastic: the world above ran it uninterrupted; a world of
        # its own, beside it, was killed on rank 1 at step 5 and restarted
        require("res" in elastic, "h2 (e): the killed world did not run")
        code, err, esecs, _ = elastic["res"]
        require(code == 0, f"h2 (e) exited {code}: {err[-3000:]}")
        require("world completed after 1 restart(s)" in err,
                "h2 (e): the launcher did not restart the world")
        for r in range(2):
            clean = elastic_losses(os.path.join(h2_dir, "clean"), r)
            killed = elastic_losses(d, r)
            require(len(clean) == len(killed) == H2_ELASTIC_STEPS
                    and clean == killed,
                    f"h2 (e) rank {r}: {killed} != {clean}")
        log(f"  (e) elastic: r1:kill@5, commits every 2 steps, the launcher "
            f"restarted the world; {H2_ELASTIC_STEPS} losses equal the "
            f"uninterrupted run's bit for bit ({r0['elastic_clean_s']:.1f} s "
            f"uninterrupted, {esecs:.1f} s killed and resumed)")
        log(f"  h2: references {ref_s:.1f} s, world {secs:.1f} s [{card}]")
        paths = {"h2_dp": r0["dp"]["launches"],
                 "h2_zero1": r0["zero1"]["launches"],
                 "h2_moe_psum": r0["moe_psum"]["launches"],
                 "h2_moe_dp": r0["moe_dp"]["launches"],
                 "h2_moe_alltoall": r0["moe_alltoall"]["launches"],
                 "h2_dgc": r0["dgc"]["launches"]}
        return paths, {"ranks": ranks, "reference": ref,
                       "world_s": secs, "reference_s": ref_s,
                       "elastic_killed_s": esecs}
    finally:
        shutil.rmtree(h2_dir, ignore_errors=True)


def phase_h(torch, np, seed, card, out_dir, record):
    t0 = time.perf_counter()
    log("phase h1: gpt3_1p3b data-parallel through fleet, a world of 1 "
        "over NCCL")
    paths, out = {}, {}
    p1, out["h1"] = phase_h1(torch, np, seed, card, out_dir,
                             record.get("train_flash"))
    paths.update(p1)
    torch.cuda.empty_cache()
    log("phase h2: a world of 2 on one card over gloo")
    p2, out["h2"] = phase_h2(torch, np, seed, card, out_dir)
    paths.update(p2)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase h took {out['seconds']:.1f} s")
    return paths, out


# -- phase i: tensor, sequence and pipeline parallelism ------------------------


I_LAYERS, I_PP_LAYERS = 2, 4     # gpt3_1p3b's widths, depth cut (h2's)
I_STEPS, I_LR, I_CLIP = 3, 3e-4, 1.0
I_SP_SEQ = 4096                  # i2: one row of 4096 tokens, 2048 a rank
I_MICRO, I_PP_ROWS = 4, 4        # i3: 4 microbatches of one row
I_MERGE_K, I_MERGE_ROWS = 2, 4   # i4: 2 rows a rank, a microbatch a row
I_TIMEOUT_S = 900
I_PRED_ROWS = 2                  # i1b: the Predictor's batch (i1's rows)


def i_config(layers=I_LAYERS, max_position=None, flash=True):
    """gpt3_1p3b's widths at ``layers`` layers, flash attention (the
    op-graph attention with ``flash`` False), no dropout;
    ``max_position`` raised for i2's 4096-token row."""
    cfg = h2_config()
    cfg.num_layers = layers
    cfg.use_flash_attention = flash
    if max_position:
        cfg.max_position = max_position
    return cfg


def i_build(fluid, cfg, seq, kind="plain", is_test=False):
    """``build_gpt_lm``'s program under Adam(3e-4) with the global-norm
    clip (``kind`` "plain"); "gpipe" / "1f1b" wrap it in
    ``PipelineOptimizer`` cut at dec1's output; "merge" is
    ``GradientMergeOptimizer(Adam, k_steps=2)``."""
    from paddle_tpu_torch.models.gpt import build_gpt_lm

    with fluid.unique_name.guard():
        main, startup, _, fetches = build_gpt_lm(cfg, seq, is_test=is_test)
        if is_test:
            return main, startup, fetches
        with fluid.program_guard(main, startup):
            if kind == "merge":
                opt = fluid.optimizer.GradientMergeOptimizer(
                    fluid.optimizer.AdamOptimizer(I_LR), k_steps=I_MERGE_K)
            else:
                opt = fluid.optimizer.AdamOptimizer(
                    I_LR, grad_clip=fluid.clip.GradientClipByGlobalNorm(
                        I_CLIP))
            if kind in ("gpipe", "1f1b"):
                cut = decoder_outputs(main, cfg.num_layers)[1]
                opt = fluid.optimizer.PipelineOptimizer(
                    opt, cut_list=[cut], num_microbatches=I_MICRO,
                    schedule=kind)
            opt.minimize(fetches["loss"])
    return main, startup, fetches


def i_batch(np, seed, cfg, rows, seq):
    from paddle_tpu_torch.models.gpt import synthetic_lm_batch

    return synthetic_lm_batch(np.random.RandomState(seed), rows, seq,
                              cfg.vocab_size)


def i_arms():
    """(key, config, batch rows, sequence, program kind) of each
    single-process reference."""
    # "sp_exact": i2's model with the op-graph attention (float32
    # matmuls and softmax, as the ring computes its blocks), the ring's
    # reference; "sp" runs the flash kernels (3xTF32), as Ulysses does
    return (("tp", i_config(), TRAIN_BATCH, TRAIN_SEQ, "plain"),
            ("sp", i_config(max_position=I_SP_SEQ), 1, I_SP_SEQ, "plain"),
            ("sp_exact", i_config(max_position=I_SP_SEQ, flash=False), 1,
             I_SP_SEQ, "plain"),
            ("pp", i_config(I_PP_LAYERS), I_PP_ROWS, TRAIN_SEQ, "plain"),
            ("merge", i_config(), I_MERGE_ROWS, TRAIN_SEQ, "merge"))


def i_place(fluid):
    return fluid.CUDAPlace(0) if DEVICE == "cuda" else fluid.CPUPlace()


def i_sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def i_reference(torch, np, seed, ref_path):
    """The single-process runs phase i's ranks are held to, on the card
    while the world starts: each arm's model 3 steps over its whole
    batch, with its losses, mean step ms, Adam's first moments after the
    last step and (tp) its parameters, saved for the ranks."""
    import paddle_tpu_torch as fluid

    fluid.set_flags({"optimizer_fuse": "auto"})
    ref = {}
    for key, cfg, rows, seq, kind in i_arms():
        batch = i_batch(np, seed, cfg, rows, seq)
        main, startup, fetches = i_build(fluid, cfg, seq, kind)
        main.random_seed = startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(i_place(fluid))
        exe.run(startup, scope=scope)
        losses, ms = [], []
        for _ in range(I_STEPS):
            i_sync(torch)
            t0 = time.perf_counter()
            losses.append(float(np.asarray(exe.run(
                main, feed=batch, fetch_list=[fetches["loss"]],
                scope=scope)[0]).reshape(-1)[0]))
            i_sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
        ref[key] = {"losses": losses, "step_ms_mean": statistics.mean(ms[1:]),
                    "m1": {k: v.cpu() for k, v in
                           first_moments(main, scope).items()}}
        if key == "tp":
            ref[key]["params"] = {p.name: scope.find_var(p.name).cpu()
                                  for p in main.all_parameters()}
        log(f"  i reference {key}: losses {losses}, mean of steps "
            f"2-{I_STEPS} {ref[key]['step_ms_mean']:.1f} ms")
        del exe, scope
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    torch.save(ref, ref_path + ".part")
    os.replace(ref_path + ".part", ref_path)
    return {k: {"losses": v["losses"], "step_ms_mean": v["step_ms_mean"]}
            for k, v in ref.items()}


def i_child(argv) -> int:
    """One rank of phase i's world of 2 on one card (gloo): i1 tensor
    parallel training, i1b the tensor-parallel Predictor, i2 ring and
    Ulysses, i3 GPipe and 1F1B, i4 gradient merge in a data-parallel
    world; results to ``<dir>/i.rank<r>.json``."""
    out_dir, seed = argv[0], int(argv[1])
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.core.pipeline_program import sync_stage_state
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.gpt import apply_gpt_megatron_sharding
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.sharding import layout
    from paddle_tpu_torch.runtime.tp_plan import unshard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    world = torch.distributed.group.WORLD
    fluid.set_flags({"optimizer_fuse": "auto"})
    wait_for_file(os.path.join(out_dir, "i_ref.pt"), I_TIMEOUT_S)
    ref = torch.load(os.path.join(out_dir, "i_ref.pt"), mmap=True)
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "arm_s": {}}
    t_arm = [time.perf_counter()]

    def arm_done(name):
        now = time.perf_counter()
        out["arm_s"][name] = round(now - t_arm[0], 1)
        t_arm[0] = now

    # the flash module (the package's ``flash_attention`` is the function)
    TF = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    heads_seen = []
    fwd = TF._FlashFunction.forward

    def spy(ctx, q, *a):
        # the q a training step's flash forward (K6 / K7) is launched on
        heads_seen.append(list(q.shape))
        return fwd(ctx, q, *a)

    def watch(on):
        TF._FlashFunction.forward = staticmethod(spy if on else fwd)

    def whole(scope, name, full_shape):
        """The whole value of a var a rank holds as a tp chunk (the fused
        QKV's interleave undone), else the rank's own."""
        t = scope.find_var(name)
        sh = layout(scope).get(name)
        if sh is None or tuple(t.shape) == tuple(full_shape):
            return t
        return unshard(t, sh.dim, sh.parts, world, sh.groups)

    def held(res, main, scope, r, names=None, params=False):
        """First moments' relative L2 error to the reference ``r`` (over
        ``names``, every parameter when None) and the parameters' largest
        gap (``params``)."""
        m1 = {v.accumulator_owner: v.name
              for v in main.global_block().vars.values()
              if getattr(v, "is_accumulator", False)
              and "moment1" in v.name}
        names = sorted(m1) if names is None else sorted(names)
        rels = {k: rel_l2(whole(scope, m1[k], r["m1"][k].shape).cpu(),
                          r["m1"][k]) for k in names}
        worst = max(rels, key=rels.get)
        res["m1_rel_l2"], res["m1_worst"] = rels[worst], worst
        res["m1_checked"] = len(rels)
        if params:
            gaps = {p.name: float((whole(scope, p.name, r["params"][
                p.name].shape).cpu() - r["params"][p.name]).abs().max())
                for p in main.all_parameters()}
            pw = max(gaps, key=gaps.get)
            res["param_max_abs_err"], res["param_worst"] = gaps[pw], pw

    def steps(exe, prog, feed, fetch, scope, count=I_STEPS):
        losses, ms = [], []
        K.reset_launch_counts()
        s0 = comm.STATS.snapshot()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(count):
            i_sync(torch)
            t0 = time.perf_counter()
            o = exe.run(prog, feed=feed, fetch_list=[fetch], scope=scope)
            i_sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(o[0]).reshape(-1)[0]))
        s1 = comm.STATS.snapshot()
        return {"losses": losses, "step_ms": ms,
                "step_ms_mean": statistics.mean(ms[1:]),
                "launches": K.launch_counts(),
                "comm": {k: s1[k] - s0[k] for k in s1},
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if DEVICE == "cuda" else 0.0)}

    def fresh(cfg, seq, kind):
        main, startup, fetches = i_build(fluid, cfg, seq, kind)
        main.random_seed = startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(i_place(fluid))
        exe.run(startup, scope=scope)
        return main, fetches, scope, exe

    def same_everywhere(values):
        t = torch.tensor(values, dtype=torch.float64)
        parts = [torch.zeros_like(t) for _ in range(n)]
        torch.distributed.all_gather(parts, t)
        return all(torch.equal(parts[0], p) for p in parts[1:])

    def collect():
        """Return the memory of what the caller just deleted."""
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

    # i1: tp 2 over apply_gpt_megatron_sharding's tags, both ranks the
    # same 2 x 1024 rows
    cfg = i_config()
    batch = i_batch(np, seed, cfg, TRAIN_BATCH, TRAIN_SEQ)
    main, fetches, scope, exe = fresh(cfg, TRAIN_SEQ, "plain")
    apply_gpt_megatron_sharding(main, mp_axis="tp")
    prog = fluid.CompiledProgram(main).with_partitioning(mesh_axes={"tp": 2})
    watch(True)
    res = steps(exe, prog, batch, fetches["loss"], scope)
    watch(False)
    res["flash_shapes"] = heads_seen[:1]
    heads_seen.clear()
    res["losses_equal_across_ranks"] = same_everywhere(res["losses"])
    res["local_qkv"] = list(scope.find_var("dec0_qkv.w").shape)
    held(res, main, scope, ref["tp"], params=True)
    out["i1"] = res
    arm_done("i1")
    # i1b: i1's trained Program saved for inference (rank 0 writes the
    # whole weights, gathered), served by a tp Predictor on both ranks
    params = {p.name: whole(scope, p.name, ref["tp"]["params"][p.name].shape)
              for p in main.all_parameters()}
    pred_dir = os.path.join(out_dir, "i1b_model")
    if rank == 0:
        test, test_start, tf = i_build(fluid, cfg, TRAIN_SEQ, is_test=True)
        ts = fluid.Scope()
        texe = fluid.Executor(i_place(fluid))
        texe.run(test_start, scope=ts)
        for k, v in params.items():
            ts.set_var(k, v.clone())
        apply_gpt_megatron_sharding(test, mp_axis="tp")
        with fluid.scope_guard(ts):
            fluid.io.save_inference_model(pred_dir, ["tokens"],
                                          [tf["logits"]], texe, test)
        del ts, texe
        collect()
    del scope, exe, params
    collect()
    torch.distributed.barrier()
    toks = batch["tokens"][:I_PRED_ROWS]
    dev = "cuda" if DEVICE == "cuda" else "cpu"
    pred_out = {}
    for mode in ("off", "int8"):
        if rank == 0:
            one = create_predictor(Config(pred_dir)
                                   .enable_weight_quantization(mode),
                                   device=dev).run([toks])[0]
        p = create_predictor(Config(pred_dir).enable_weight_quantization(mode)
                             .enable_partitioning(mesh_axes={"tp": 2}),
                             device=dev)
        p.run([toks])
        K.reset_launch_counts()
        got = p.run([toks])[0]
        counts = K.launch_counts()
        r = {"launches": counts, "same_across_ranks": same_everywhere(
            [float(got.sum()), float(np.abs(got).max())])}
        qkv = [k for k in p._scope.vars if k.startswith("dec0_qkv.w")]
        r["local_qkv"] = [list(p._scope.find_var(k).shape) for k in qkv]
        if rank == 0:
            r["err"] = float(np.abs(got - one).max())
            r["max_logit"] = float(np.abs(one).max())
        pred_out[mode] = r
        del p
        collect()
    out["i1b"] = pred_out
    torch.distributed.barrier()
    arm_done("i1b")

    # i2: sp 2, a row of 4096 tokens, 2048 a rank; ring, then Ulysses
    scfg = i_config(max_position=I_SP_SEQ)
    sbatch = i_batch(np, seed, scfg, 1, I_SP_SEQ)
    half = I_SP_SEQ // n
    local = {k: v[:, rank * half:(rank + 1) * half] for k, v in sbatch.items()}
    for mode in ("ring", "ulysses"):
        main, fetches, scope, exe = fresh(scfg, I_SP_SEQ, "plain")
        prog = fluid.CompiledProgram(main).with_sequence_parallel(sp=n,
                                                                  mode=mode)
        watch(True)
        res = steps(exe, prog, local, fetches["loss"], scope)
        watch(False)
        res["flash_shapes"] = heads_seen[:1]
        heads_seen.clear()
        held(res, main, scope, ref["sp"])
        if mode == "ring":
            exact = {}
            held(exact, main, scope, ref["sp_exact"])
            res["m1_rel_l2_flash_ref"] = res["m1_rel_l2"]
            res["m1_rel_l2"], res["m1_worst"] = (exact["m1_rel_l2"],
                                                 exact["m1_worst"])
        out[f"i2_{mode}"] = res
        del scope, exe
        collect()
        arm_done(f"i2_{mode}")

    # i3: pp 2 (2 layers a stage), 4 x 1024 rows in 4 microbatches
    pcfg = i_config(I_PP_LAYERS)
    pbatch = i_batch(np, seed, pcfg, I_PP_ROWS, TRAIN_SEQ)
    for sched in ("gpipe", "1f1b"):
        main, fetches, scope, exe = fresh(pcfg, TRAIN_SEQ, sched)
        prog = fluid.CompiledProgram(main).with_pipeline()
        res = steps(exe, prog, pbatch, fetches["loss"], scope)
        # the bound step's pipeline stage (the executor's bind cache)
        pipe = next(b.pipe for b in exe._bound.values()
                    if b.pipe is not None)
        res["peak_stash"] = pipe.peak_stash
        held(res, main, scope, ref["pp"], names=pipe.own)
        sync_stage_state(main, scope, prog)
        out[f"i3_{sched}"] = res
        del scope, exe, pipe
        collect()
        arm_done(f"i3_{sched}")

    # i4: dp 2 with GradientMergeOptimizer(Adam, k 2), rows 2r and 2r + 1
    main, fetches, scope, exe = fresh(cfg, TRAIN_SEQ, "merge")
    mbatch = i_batch(np, seed, cfg, I_MERGE_ROWS, TRAIN_SEQ)
    rows = I_MERGE_ROWS // n
    prog = fluid.CompiledProgram(main).with_data_parallel()
    res = steps(exe, prog, {k: v[rank * rows:(rank + 1) * rows]
                            for k, v in mbatch.items()},
                fetches["loss"], scope)
    held(res, main, scope, ref["merge"])
    out["i4"] = res
    del scope, exe
    collect()
    arm_done("i4")
    with open(os.path.join(out_dir, f"i.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def i_train_want(K, L, flash=True, micro=1, lm_head=True, first=True):
    """Launches a training step of an L-layer stage over ``micro``
    microbatches: h_train_want's, a pipeline stage's share of it."""
    want = {name: 0 for name in K.KERNELS}
    ln = 2 * L + (1 if lm_head else 0)
    n_params = 12 * L + (2 if first else 0) + (4 if lm_head else 0)
    want.update(layer_norm=ln * micro, layer_norm_bwd=ln * micro,
                softmax_xent_fwd=micro if lm_head else 0,
                softmax_xent_bwd=micro if lm_head else 0,
                fused_adam_update=n_params)
    if flash:
        want.update(flash_attention_fwd=L * micro,
                    flash_attention_bwd=L * micro)
    return want


def phase_i(torch, np, seed, card, out_dir):
    """Phase i: a world of 2 on the one card (gloo, both ranks on cuda:0)
    through the launcher; this process runs the single-process references
    while the ranks start and holds the ranks' results to them."""
    from paddle_tpu_torch import kernels as K

    t_phase = time.perf_counter()
    i_dir = os.path.abspath(os.path.join(out_dir, "i"))
    shutil.rmtree(i_dir, ignore_errors=True)
    os.makedirs(i_dir)
    try:
        def references():
            t0 = time.perf_counter()
            r = i_reference(torch, np, seed, os.path.join(i_dir, "i_ref.pt"))
            return r, time.perf_counter() - t0

        log(f"  the 2-layer models (4 for i3) at gpt3_1p3b's widths; i2's "
            f"max_position raised from 1024 to {I_SP_SEQ} (a context past "
            "the preset's, which sequence parallelism exists for)")
        code, err, secs, (ref, ref_s) = launch_world(
            ["--i-child", i_dir, str(seed)], i_dir, I_TIMEOUT_S,
            meanwhile=references)
        require(code == 0, f"phase i's world exited {code}: {err[-3000:]}")
        ranks = [json.load(open(os.path.join(i_dir, f"i.rank{r}.json")))
                 for r in range(2)]
        r0 = ranks[0]
        rtol = CARD_VS_CPU_RTOL["gpt_flash"]
        holds = []

        def hold(cond, msg):
            holds.append((cond, msg))

        def rel(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        # every reading first
        a = r0["i1"]
        lim = 2 * I_LR * I_STEPS
        want1 = i_train_want(K, I_LAYERS)
        log(f"  i1 tp 2: losses {a['losses']} vs one process "
            f"{ref['tp']['losses']} (rel {rel(a['losses'], ref['tp']['losses']):.3e}"
            f", rtol {rtol}); equal on both ranks: "
            f"{all(rk['i1']['losses_equal_across_ranks'] for rk in ranks)}; "
            f"first moments (gathered, the qkv interleave undone) within "
            f"{max(rk['i1']['m1_rel_l2'] for rk in ranks):.3e} "
            f"({a['m1_worst']}; {H2_GRAD_RTOL:.0e}); params within "
            f"{a['param_max_abs_err']:.3e} (2 * lr * steps = {lim:.1e}); "
            f"local qkv {a['local_qkv']}; flash q {a['flash_shapes']}; "
            f"step {a['step_ms_mean']:.1f} ms against one process's "
            f"{ref['tp']['step_ms_mean']:.1f} ms; comm a step "
            f"{ {k: v / I_STEPS for k, v in a['comm'].items()} }; peak "
            f"{[rk['i1']['peak_gb'] for rk in ranks]} GB a rank [{card}]")
        for rk in ranks:
            x = rk["i1"]
            hold(rel(x["losses"], ref["tp"]["losses"]) <= rtol,
                 f"i1 losses {x['losses']} vs {ref['tp']['losses']}")
            hold(x["losses_equal_across_ranks"], "i1: the ranks' losses differ")
            hold(x["m1_rel_l2"] <= H2_GRAD_RTOL,
                 f"i1 {x['m1_worst']}'s first moment off by {x['m1_rel_l2']}")
            hold(x["param_max_abs_err"] <= lim,
                 f"i1 {x['param_worst']} off by {x['param_max_abs_err']}")
            got = {k: x["launches"][k] for k in want1}
            hold(got == {k: c * I_STEPS for k, c in want1.items()},
                 f"i1 launches {got}, want {want1} a step")
            hold(x["flash_shapes"][0][1] == 8, f"i1 flash heads "
                 f"{x['flash_shapes']}")
        for mode, tol in (("off", 1e-4), ("int8", 1e-3)):
            b = r0["i1b"][mode]
            log(f"  i1b tp Predictor ({'float32' if mode == 'off' else mode}):"
                f" logits within {b['err']:.3e} of one process's (max |logit|"
                f" {b['max_logit']:.3f}, limit {tol} x max); local qkv "
                f"{b['local_qkv']}; launches a run {dict((k, v) for k, v in b['launches'].items() if v)} [{card}]")
            hold(b["err"] <= tol * b["max_logit"],
                 f"i1b {mode}: logits {b['err']} off")
            for rk in ranks:
                c = rk["i1b"][mode]["launches"]
                hold(rk["i1b"][mode]["same_across_ranks"],
                     f"i1b {mode}: the ranks' logits differ")
                if mode == "int8":
                    hold(c["quantized_matmul"] == 4 * I_LAYERS + 1,
                         f"i1b int8: {c['quantized_matmul']} K11 launches a "
                         "run")
                else:
                    hold(c["layer_norm"] == 2 * I_LAYERS + 1 and
                         c["flash_attention_fwd"] == I_LAYERS,
                         f"i1b: launches {c}")
        for mode in ("ring", "ulysses"):
            s = r0[f"i2_{mode}"]
            # the ring's blocks are float32 matmuls: its reference is the
            # one-process run with the op-graph attention; Ulysses runs
            # the flash kernels, as the flash reference does
            rk_ = "sp_exact" if mode == "ring" else "sp"
            also = (f" (against the flash run "
                    f"{max(rk['i2_ring']['m1_rel_l2_flash_ref'] for rk in ranks):.3e})"
                    if mode == "ring" else "")
            log(f"  i2 sp 2 {mode}: losses {s['losses']} vs one process at S "
                f"{I_SP_SEQ} ({'op-graph' if mode == 'ring' else 'flash'}) "
                f"{ref[rk_]['losses']} (rel "
                f"{rel(s['losses'], ref[rk_]['losses']):.3e}); first moments"
                f" within {max(rk[f'i2_{mode}']['m1_rel_l2'] for rk in ranks):.3e}"
                f" ({s['m1_worst']}){also}; flash q {s['flash_shapes']}, launches "
                f"fwd {s['launches']['flash_attention_fwd']} bwd "
                f"{s['launches']['flash_attention_bwd']}; step "
                f"{s['step_ms_mean']:.1f} ms against "
                f"{ref[rk_]['step_ms_mean']:.1f}; comm a step "
                f"{ {k: v / I_STEPS for k, v in s['comm'].items()} }; peak "
                f"{[rk[f'i2_{mode}']['peak_gb'] for rk in ranks]} GB [{card}]")
            wantf = I_LAYERS * I_STEPS if mode == "ulysses" else 0
            for rk in ranks:
                x = rk[f"i2_{mode}"]
                hold(rel(x["losses"], ref[rk_]["losses"]) <= rtol,
                     f"i2 {mode} losses {x['losses']}")
                hold(x["m1_rel_l2"] <= H2_GRAD_RTOL,
                     f"i2 {mode} {x['m1_worst']} off by {x['m1_rel_l2']}")
                hold(x["launches"]["flash_attention_fwd"] == wantf and
                     x["launches"]["flash_attention_bwd"] == wantf,
                     f"i2 {mode}: flash launches {x['launches']}")
                if mode == "ulysses":
                    hold(x["flash_shapes"][0][1:3] == [8, I_SP_SEQ],
                         f"i2 ulysses flash q {x['flash_shapes']}")
        for sched in ("gpipe", "1f1b"):
            p = [rk[f"i3_{sched}"] for rk in ranks]
            log(f"  i3 pp 2 {sched}: losses {p[0]['losses']} vs the plain "
                f"step on the whole batch {ref['pp']['losses']} (rel "
                f"{rel(p[-1]['losses'], ref['pp']['losses']):.3e}); first "
                f"moments within {[x['m1_rel_l2'] for x in p]} (a stage's "
                f"own {[x['m1_checked'] for x in p]}); peak "
                f"{[x['peak_gb'] for x in p]} GB a stage, stash "
                f"{[x['peak_stash'] for x in p]} microbatches; step "
                f"{p[0]['step_ms_mean']:.1f} ms against "
                f"{ref['pp']['step_ms_mean']:.1f}; comm a step "
                f"{ {k: v / I_STEPS for k, v in p[0]['comm'].items()} } "
                f"[{card}]")
            half = I_PP_LAYERS // 2
            for s_, x in enumerate(p):
                hold(rel(x["losses"], ref["pp"]["losses"]) <= rtol,
                     f"i3 {sched} losses {x['losses']}")
                hold(x["m1_rel_l2"] <= H2_GRAD_RTOL,
                     f"i3 {sched} stage {s_} {x['m1_worst']} off by "
                     f"{x['m1_rel_l2']}")
                want = i_train_want(K, half, micro=I_MICRO,
                                    lm_head=s_ == 1, first=s_ == 0)
                got = {k: x["launches"][k] for k in want}
                hold(got == {k: c * I_STEPS for k, c in want.items()},
                     f"i3 {sched} stage {s_}: launches {got}, want {want} "
                     "a step")
        g = r0["i4"]
        calls = g["comm"]["comm_calls_total"] / I_STEPS
        log(f"  i4 dp 2 + merge k {I_MERGE_K}: losses {g['losses']} vs one "
            f"process's merge {ref['merge']['losses']} (rel "
            f"{rel(g['losses'], ref['merge']['losses']):.3e}); first moments "
            f"within {g['m1_rel_l2']:.3e}; {calls} collectives a step (the "
            f"merged gradients' one all-reduce and the loss's mean), "
            f"{g['comm']['comm_bytes_total'] / I_STEPS / 1e9:.3f} GB a step; "
            f"step {g['step_ms_mean']:.1f} ms against "
            f"{ref['merge']['step_ms_mean']:.1f} [{card}]")
        for rk in ranks:
            x = rk["i4"]
            hold(rel(x["losses"], ref["merge"]["losses"]) <= rtol,
                 f"i4 losses {x['losses']}")
            hold(x["m1_rel_l2"] <= H2_GRAD_RTOL,
                 f"i4 {x['m1_worst']} off by {x['m1_rel_l2']}")
            hold(x["comm"]["comm_calls_total"] == 2 * I_STEPS,
                 f"i4: {x['comm']['comm_calls_total']} collectives in "
                 f"{I_STEPS} steps")
        for cond, msg in holds:
            require(cond, msg)
        seconds = time.perf_counter() - t_phase
        log(f"  phase i: references {ref_s:.1f} s, world {secs:.1f} s "
            f"(rank 0's arms {r0['arm_s']} s, after waiting for the "
            f"references), phase {seconds:.1f} s [{card}]")
        paths = {"i1_tp": r0["i1"]["launches"],
                 "i1b_tp_int8": r0["i1b"]["int8"]["launches"],
                 "i2_ring": r0["i2_ring"]["launches"],
                 "i2_ulysses": r0["i2_ulysses"]["launches"],
                 "i3_gpipe_s0": ranks[0]["i3_gpipe"]["launches"],
                 "i3_gpipe_s1": ranks[1]["i3_gpipe"]["launches"],
                 "i3_1f1b_s0": ranks[0]["i3_1f1b"]["launches"],
                 "i3_1f1b_s1": ranks[1]["i3_1f1b"]["launches"],
                 "i4_merge": r0["i4"]["launches"]}
        return paths, {"ranks": ranks, "reference": ref, "world_s": secs,
                       "reference_s": ref_s, "seconds": seconds}
    finally:
        shutil.rmtree(i_dir, ignore_errors=True)


# -- phase j: recurrence and sequences (A11b) -----------------------------------------

# rnn_search's IWSLT'15 en-vi widths (PaddlePaddle's Fluid-1.x models,
# PaddleNLP machine_translation/rnn_search), taken by name: the model is
# the book's one-layer attention GRU (models/seq2seq.py), so rnn_search's
# 2 LSTM layers are reduced to it
J_SRC_VOCAB, J_TGT_VOCAB, J_EMB, J_HIDDEN, J_SEQ = 17191, 7709, 512, 512, 50
J_GATE_BATCH, J_GATE_STEPS = 16, 2      # j1 (a), j3, j4: card against CPU
J_TRAIN_BATCH, J_TRAIN_STEPS = 128, 10  # j1 (b), on the card
J_BEAM, J_SOURCES, J_BOS, J_EOS = 10, 8, 0, 1
J_LR, J_STD = 2e-3, 0.02
# j3: the book's stacked_lstm_net (understand_sentiment); its dynamic_lstm
# size is 4H in the reference's LoD API, so H = hid_dim / 4 in the dense one
J3 = dict(vocab=5000, emb=128, hid=512, stacked=3, classes=2, batch=128,
          min_len=16, max_len=128)
# j4: the book's label_semantic_roles db_lstm (the same 4H convention)
J4 = dict(words=44000, preds=3000, labels=60, marks=2, word_dim=32,
          mark_dim=5, hidden=512, depth=8, max_len=40)
# j5: a DynamicRNN of models/seq2seq.py's GRU cell
J5 = dict(rows=64, max_len=100, hidden=512)
J_VITERBI_MARGIN = 1e-4
J_BEAM_GAP = 1e-3                        # of max|logp|: the serving oracle's rule


def j_require_launches(counts, want, what):
    """Each kernel of ``want`` launched exactly so often in the run."""
    for name, n in want.items():
        require(counts.get(name, 0) == n,
                f"{what}: {name} launched {counts.get(name, 0)} times, not {n}")


def j_copy_batch(np, rng, n, seq=None):
    """rnn_search's copy task, as the JAX test's: the target is the source
    shifted by BOS; tokens in both vocabularies."""
    seq = seq or J_SEQ
    src = rng.randint(2, min(J_SRC_VOCAB, J_TGT_VOCAB), (n, seq)).astype(
        np.int64)
    tgt_in = np.concatenate([np.full((n, 1), J_BOS, np.int64), src[:, :-1]],
                            1)
    return {"src": src, "tgt_in": tgt_in, "tgt_out": src}


J_MOMENT_FLOOR = 1e-6


def j_moment_gap(main, gpu_scope, cpu_scope):
    """The largest relative L2 error of an Adam first moment, card
    against CPU, and its parameter. A moment whose norm is below
    ``J_MOMENT_FLOOR`` of the largest one's is held against that floor:
    at these seeded weights the seq2seq attention is all but invariant
    to its query (a shift common to every position), so ``s2s_att_q.w``
    gets a gradient of rounding size (1e-14 where the head's is 5e-6),
    whose relative error says nothing."""
    gm, cm = first_moments(main, gpu_scope), first_moments(main, cpu_scope)
    norms = {n: float(cm[n].double().norm()) for n in cm}
    floor = J_MOMENT_FLOOR * max(norms.values())
    gaps = {n: float((gm[n].cpu().double() - cm[n].double()).norm())
            / max(norms[n], floor) for n in cm}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def j_card_vs_cpu(torch, np, seed, built, batches, what, n_xent,
                  fetch_extra=()):
    """Train ``built`` = (main, startup, loss) from the same seeded
    weights on the card and on the CPU: losses within rtol 1e-3,
    parameters within 2 * lr * steps, Adam's first moments within
    relative L2 1e-4, exact K4 / K5 (``n_xent`` a step) and one K10 a
    parameter a step. Returns (record, {device: fetched extras a step},
    the seeded arrays)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    main, startup, loss = built
    params = main.all_parameters()
    n_adam = [op.type for op in main.global_block().ops].count("fused_adam")
    require(n_adam == len(params),
            f"{what}: {n_adam} fused_adam ops for {len(params)} parameters")
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    arrays = seeded_arrays(np, main, cpu_scope, J_STD, seed)
    gpu, gpu_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gpu_scope)
    load_scope_arrays(cpu_scope, arrays, main, "cpu")
    load_scope_arrays(gpu_scope, arrays, main, DEVICE)
    fetch = [loss] + list(fetch_extra)
    losses, extras, secs = {}, {}, {}
    for name, exe, scope in (("cuda", gpu, gpu_scope),
                             ("cpu", cpu, cpu_scope)):
        K.reset_launch_counts()
        t = time.perf_counter()
        runs = [exe.run(main, feed=b, fetch_list=fetch, scope=scope)
                for b in batches]
        secs[name] = time.perf_counter() - t
        losses[name] = [float(np.asarray(r[0]).reshape(-1)[0]) for r in runs]
        extras[name] = [[np.asarray(v) for v in r[1:]] for r in runs]
        if name == "cuda":
            counts = K.launch_counts()
    steps = len(batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    worst, worst_name = 0.0, ""
    for p in params:
        d = float(np.abs(gpu_scope.get_numpy(p.name)
                         - cpu_scope.get_numpy(p.name)).max())
        if d > worst:
            worst, worst_name = d, p.name
    m1, m1_name = j_moment_gap(main, gpu_scope, cpu_scope)
    log(f"  {what}: card {losses['cuda']} ({secs['cuda']:.1f} s), CPU "
        f"{losses['cpu']} ({secs['cpu']:.1f} s); losses within {rel:.3e}, "
        f"parameters {worst:.3e} ({worst_name}), first moments {m1:.3e} "
        f"({m1_name}, relative L2); launches "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    j_require_launches(counts, {"softmax_xent_fwd": n_xent * steps,
                                "softmax_xent_bwd": n_xent * steps,
                                "fused_adam_update": n_adam * steps}, what)
    require(rel <= 1e-3, f"{what}: card vs CPU losses differ by {rel:.3e}")
    limit = 2 * J_LR * steps
    require(worst <= limit, f"{what}: parameter {worst_name} differs by "
            f"{worst:.3e} > 2 * lr * steps = {limit:.1e}")
    require(m1 <= 1e-4, f"{what}: first moments differ by {m1:.3e} "
            "(relative L2) > 1e-4")
    return ({"losses": losses, "loss_rel_err": rel, "param_max_abs_err": worst,
             "param_limit": limit, "moment_rel_l2": m1,
             "launches": {k: v for k, v in counts.items() if v},
             "card_s": secs["cuda"], "cpu_s": secs["cpu"]},
            extras, arrays)


def j_seq2seq(fluid, optimizer=None):
    from paddle_tpu_torch.models.seq2seq import build_seq2seq

    with fluid.unique_name.guard():
        return build_seq2seq(J_SRC_VOCAB, J_TGT_VOCAB, J_SEQ, emb_dim=J_EMB,
                             hidden=J_HIDDEN, optimizer=optimizer)


def j1_train(torch, np, seed, card, out_dir):
    """j1: (a) card against CPU at batch 16; (b) 10 steps at batch 128 on
    the card. Returns (launches of (b), record, (b)'s trained
    persistables as numpy)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    fluid.set_flags({"optimizer_fuse": "on"})
    main, startup, _, fetches = j_seq2seq(
        fluid, fluid.optimizer.AdamOptimizer(J_LR))
    rng = np.random.RandomState(seed)
    gate, _, _ = j_card_vs_cpu(
        torch, np, seed, (main, startup, fetches["loss"]),
        [j_copy_batch(np, rng, J_GATE_BATCH) for _ in range(J_GATE_STEPS)],
        f"j1 (a) batch {J_GATE_BATCH}", n_xent=1)

    main, startup, _, fetches = j_seq2seq(
        fluid, fluid.optimizer.AdamOptimizer(J_LR))
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    arrays = seeded_arrays(np, main, cpu_scope, J_STD, seed)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    load_scope_arrays(scope, arrays, main, DEVICE)
    # a dataset of 2 batches, cycled: from weights of std 0.02 the loss
    # sits at ln(7709) for fresh random batches well past 10 steps, and a
    # fixed set shows the training move within them
    data = [j_copy_batch(np, rng, J_TRAIN_BATCH) for _ in range(2)]
    batches = [data[i % 2] for i in range(J_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        t = time.perf_counter()
        losses.append(float(np.asarray(exe.run(
            main, feed=b, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = start_profile(torch)
    t = time.perf_counter()
    exe.run(main, feed=batches[0], fetch_list=[fetches["loss"]], scope=scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof.__exit__(None, None, None)
    breakdown = trace_breakdown(prof, out_dir, "j1b", wall, steps=1)
    step_ms = 1e3 * statistics.mean(times[1:])
    tokens_s = J_TRAIN_BATCH * J_SEQ / (step_ms / 1e3)
    n_params = len(main.all_parameters())
    log(f"  j1 (b) batch {J_TRAIN_BATCH} x {J_SEQ}, {J_TRAIN_STEPS} steps: "
        f"losses {losses}; {step_ms:.3f} ms a step (steps 2-10; first "
        f"{1e3 * times[0]:.1f}), {tokens_s:.2f} target tokens/s, "
        f"{breakdown['kernels']} eager launches a step (profiled), device "
        f"idle {breakdown['device_idle_share']:.3f}, peak {peak:.2f} GB "
        f"[{card}]")
    require(all(np.isfinite(losses)), f"j1 (b): a loss is not finite: {losses}")
    require(np.mean(losses[-3:]) < losses[0],
            f"j1 (b): the last three losses do not fall below the first: "
            f"{losses}")
    j_require_launches(counts, {"softmax_xent_fwd": J_TRAIN_STEPS,
                                "softmax_xent_bwd": J_TRAIN_STEPS,
                                "fused_adam_update": n_params * J_TRAIN_STEPS},
                       "j1 (b)")
    return counts, {"gate": gate, "losses": losses, "step_ms": step_ms,
                    "first_step_ms": 1e3 * times[0],
                    "target_tokens_s": tokens_s,
                    "eager_launches_a_step": breakdown["kernels"],
                    "device_idle_share": breakdown["device_idle_share"],
                    "peak_gb": peak}, {
        v.name: scope.get_numpy(v.name) for v in main.list_vars()
        if v.persistable}


def j_decode(np, fluid, place, trained, src, record):
    """``beam_search_infer`` of ``src`` on ``place`` from the ``trained``
    arrays; ``record`` (a list) gets each step's (logp, acc, ids,
    parents). Returns (sentences, scores, seconds)."""
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.seq2seq import (beam_search_infer,
                                                 build_decoder_step)

    main, startup, _, fetches = j_seq2seq(fluid)
    with fluid.unique_name.guard():
        step, _, _, step_fetches = build_decoder_step(
            J_SRC_VOCAB, J_TGT_VOCAB, J_SEQ, emb_dim=J_EMB, hidden=J_HIDDEN)
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    dev = "cpu" if isinstance(place, fluid.CPUPlace) else DEVICE
    load_scope_arrays(scope, {n: v for n, v in trained.items()
                              if main.global_block().has_var(n)}, main, dev)
    t = time.perf_counter()
    enc, = exe.run(main, feed={"src": src, "tgt_in": src, "tgt_out": src},
                   fetch_list=[fetches["encoder"]], scope=scope)

    def on_step(t_, logp, acc, ids, parents):
        record.append((np.asarray(logp), np.asarray(acc), np.asarray(ids),
                       np.asarray(parents)))

    sent, scores = beam_search_infer(
        exe, scope, np.asarray(enc), step, step_fetches, J_BEAM, J_BOS,
        J_EOS, J_SEQ, J_HIDDEN, on_step=on_step)
    return np.asarray(sent), np.asarray(scores), time.perf_counter() - t


def j2_beam(torch, np, seed, card, trained):
    """j2: beam 10, max length 50, end id 1, 8 sources from j1 (b)'s
    trained parameters, on the card and on the CPU."""
    import paddle_tpu_torch as fluid

    src = j_copy_batch(np, np.random.RandomState(seed + 2), J_SOURCES)["src"]
    card_steps, cpu_steps = [], []
    sent, scores, secs = j_decode(np, fluid, fluid.CUDAPlace(0), trained, src,
                                  card_steps)
    csent, cscores, csecs = j_decode(np, fluid, fluid.CPUPlace(), trained,
                                     src, cpu_steps)
    differ = []
    for b in range(J_SOURCES):
        if np.array_equal(sent[b], csent[b]):
            continue
        t0 = next(t for t in range(J_SEQ)
                  if not (np.array_equal(card_steps[t][2][b],
                                         cpu_steps[t][2][b])
                          and np.array_equal(card_steps[t][3][b],
                                             cpu_steps[t][3][b])))
        logp, acc = cpu_steps[t0][0], cpu_steps[t0][1]
        top = np.sort(acc[b].reshape(-1))[::-1][:J_BEAM + 1]
        gap = float(np.min(top[:-1] - top[1:]))
        scale = float(np.abs(logp.reshape(J_SOURCES, J_BEAM, -1)[b]).max())
        differ.append({"source": b, "step": t0, "gap": gap,
                       "limit": J_BEAM_GAP * scale})
    ms = 1e3 * secs / J_SEQ
    log(f"  j2 beam {J_BEAM}, {J_SOURCES} sources, {J_SEQ} steps: card "
        f"{ms:.3f} ms a decode step ({J_SOURCES / secs:.2f} sentences/s; "
        f"CPU {1e3 * csecs / J_SEQ:.3f}); {J_SOURCES - len(differ)} of "
        f"{J_SOURCES} sources give the CPU's sentences; differing {differ} "
        f"[{card}]")
    for d in differ:
        require(d["gap"] <= d["limit"],
                f"j2: source {d['source']} first differs at step {d['step']} "
                f"with a top gap {d['gap']:.3e} > {d['limit']:.3e}")
    require(np.all(np.isfinite(scores)), "j2: a sentence score is not finite")
    return {"ms_a_decode_step": ms, "sentences_s": J_SOURCES / secs,
            "cpu_ms_a_decode_step": 1e3 * csecs / J_SEQ,
            "equal_sources": J_SOURCES - len(differ), "differ": differ}


def j_stacked_lstm_net(fluid, T, lr):
    """The book's stacked_lstm_net (understand_sentiment), dense: ragged
    rows through ``length``; the softmax and cross entropy as one
    ``softmax_with_cross_entropy`` over the logits."""
    c = J3
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = L.data("words", [T, 1], dtype="int64")
        length = L.data("length", [1], dtype="int32")
        label = L.data("label", [1], dtype="int64")
        emb = L.embedding(words, size=[c["vocab"], c["emb"]])
        fc1 = L.fc(emb, c["hid"], num_flatten_dims=2)
        lstm1, _ = L.dynamic_lstm(fc1, c["hid"] // 4, length=length)
        inputs = [fc1, lstm1]
        for i in range(2, c["stacked"] + 1):
            fc = L.fc(inputs, c["hid"], num_flatten_dims=2)
            lstm, _ = L.dynamic_lstm(fc, c["hid"] // 4,
                                     is_reverse=(i % 2) == 0, length=length)
            inputs = [fc, lstm]
        pooled = [L.sequence_pool(v, "max", length=length) for v in inputs]
        logits = L.fc(pooled, c["classes"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


def j3_batch(np, rng, n, T):
    lengths = rng.randint(J3["min_len"], J3["max_len"] + 1, n)
    words = rng.randint(0, J3["vocab"], (n, T, 1)).astype(np.int64)
    words[np.arange(T)[None, :] >= lengths[:, None]] = 0
    label = (words[:, :, 0] < J3["vocab"] // 2).sum(1) * 2 > lengths
    return {"words": words, "length": lengths.astype(np.int32)[:, None],
            "label": label.astype(np.int64)[:, None]}


def j3_sentiment(torch, np, seed, card):
    import paddle_tpu_torch as fluid

    fluid.set_flags({"optimizer_fuse": "on"})
    T = J3["max_len"]
    rng = np.random.RandomState(seed + 3)
    gate, _, _ = j_card_vs_cpu(
        torch, np, seed, j_stacked_lstm_net(fluid, T, J_LR),
        [j3_batch(np, rng, J_GATE_BATCH, T) for _ in range(J_GATE_STEPS)],
        f"j3 stacked_lstm_net batch {J_GATE_BATCH}", n_xent=1)
    main, startup, loss = j_stacked_lstm_net(fluid, T, J_LR)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    times, losses = [], []
    for _ in range(4):
        b = j3_batch(np, rng, J3["batch"], T)
        t = time.perf_counter()
        losses.append(float(np.asarray(exe.run(
            main, feed=b, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    ms = 1e3 * statistics.mean(times[1:])
    log(f"  j3 batch {J3['batch']}, lengths {J3['min_len']}-{J3['max_len']}: "
        f"{ms:.3f} ms a step (steps 2-4), losses {losses} [{card}]")
    require(all(np.isfinite(losses)), f"j3: a loss is not finite: {losses}")
    return {"gate": gate, "step_ms": ms, "losses": losses}


def j_db_lstm(fluid, T, lr):
    """The book's label_semantic_roles db_lstm: eight embeddings (six word
    windows sharing ``emb``, the predicate's ``vemb``, the mark), their
    fc's summed, ``depth`` LSTMs alternating direction, the tag scores,
    ``linear_chain_crf`` (``crfw``), ``crf_decoding`` and ``chunk_eval``.
    The dense LSTM keeps its sigmoid / tanh (the book asks relu
    candidates of the reference's LoD op)."""
    c = J4
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        names = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2"]
        words = [L.data(n, [T, 1], dtype="int64") for n in names]
        pred = L.data("verb", [T, 1], dtype="int64")
        mark = L.data("mark", [T, 1], dtype="int64")
        target = L.data("target", [T], dtype="int64")
        length = L.data("length", [1], dtype="int32")
        embs = [L.embedding(w, size=[c["words"], c["word_dim"]],
                            param_attr=fluid.ParamAttr(name="emb"))
                for w in words]
        embs.append(L.embedding(pred, size=[c["preds"], c["word_dim"]],
                                param_attr=fluid.ParamAttr(name="vemb")))
        embs.append(L.embedding(mark, size=[c["marks"], c["mark_dim"]]))
        hidden = L.sums([L.fc(e, c["hidden"], num_flatten_dims=2)
                         for e in embs])
        lstm, _ = L.dynamic_lstm(hidden, c["hidden"] // 4, length=length)
        tmp = [hidden, lstm]
        for i in range(1, c["depth"]):
            mix = L.sums([L.fc(v, c["hidden"], num_flatten_dims=2)
                          for v in tmp])
            lstm, _ = L.dynamic_lstm(mix, c["hidden"] // 4,
                                     is_reverse=(i % 2) == 1, length=length)
            tmp = [mix, lstm]
        feature = L.sums([L.fc(v, c["labels"], act="tanh",
                               num_flatten_dims=2) for v in tmp])
        crfw = L.create_parameter([c["labels"] + 2, c["labels"]], "float32",
                                  name="crfw")
        *_, nll = L.linear_chain_crf(feature, target, crfw, length=length)
        loss = L.mean(nll)
        path = L.crf_decoding(feature, crfw, length=length)
        chunk = L.chunk_eval(path, target, seq_length=length,
                             chunk_scheme="IOB",
                             num_chunk_types=(c["labels"] - 1) // 2)
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return (main, startup, loss), [feature, path, chunk[2]]


def j4_batch(np, rng, n, T):
    c = J4
    lengths = rng.randint(T // 4, T + 1, n)
    feed = {k: rng.randint(0, c["words"], (n, T, 1)).astype(np.int64)
            for k in ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
                      "ctx_p2")}
    feed["verb"] = rng.randint(0, c["preds"], (n, T, 1)).astype(np.int64)
    feed["mark"] = rng.randint(0, c["marks"], (n, T, 1)).astype(np.int64)
    feed["target"] = rng.randint(0, c["labels"], (n, T)).astype(np.int64)
    feed["length"] = lengths.astype(np.int32)[:, None]
    return feed


def viterbi_margin(np, em, tr, n):
    """The Viterbi path of one row (float64) and its margin: the least gap
    between the best and the second-best choice over the final argmax and
    every back-pointer the path takes."""
    start, stop, pair = tr[0], tr[1], tr[2:]
    score = start + em[0]
    backs, gaps = [], []
    for t in range(1, n):
        cand = score[:, None] + pair
        order = np.sort(cand, axis=0)
        backs.append((np.argmax(cand, axis=0), order[-1] - order[-2]))
        score = order[-1] + em[t]
    final = score + stop
    f = np.sort(final)
    cur = int(np.argmax(final))
    gaps.append(f[-1] - f[-2])
    path = [cur]
    for back, gap in reversed(backs):
        gaps.append(gap[cur])
        cur = int(back[cur])
        path.append(cur)
    return path[::-1], float(min(gaps))


def j4_srl(torch, np, seed, card):
    import paddle_tpu_torch as fluid

    fluid.set_flags({"optimizer_fuse": "on"})
    T = J4["max_len"]
    rng = np.random.RandomState(seed + 4)
    built, extra = j_db_lstm(fluid, T, J_LR)
    batches = [j4_batch(np, rng, J_GATE_BATCH, T) for _ in range(J_GATE_STEPS)]
    gate, extras, arrays = j_card_vs_cpu(
        torch, np, seed, built, batches, f"j4 db_lstm batch {J_GATE_BATCH}",
        n_xent=0, fetch_extra=extra)
    checked = equal = 0
    lengths = batches[0]["length"][:, 0]
    feat_cpu, path_cpu = extras["cpu"][0][0], extras["cpu"][0][1]
    path_card = extras["cuda"][0][1]
    # the first step's paths, both from the seeded weights: the margin on
    # the CPU's scores and the seeded transition
    tr = np.asarray(arrays["crfw"], np.float64)
    for b, n in enumerate(lengths):
        path, margin = viterbi_margin(np, feat_cpu[b, :n].astype(np.float64),
                                      tr, int(n))
        require(list(path_cpu[b, :n]) == path or margin <= J_VITERBI_MARGIN,
                f"j4: the CPU's Viterbi path of row {b} is not the float64 one")
        if margin > J_VITERBI_MARGIN:
            checked += 1
            equal += int(np.array_equal(path_card[b, :n], path_cpu[b, :n]))
    log(f"  j4 crf_decoding: {equal} of {checked} rows with a Viterbi margin "
        f"above {J_VITERBI_MARGIN} equal the CPU's paths "
        f"({J_GATE_BATCH - checked} rows at a smaller margin); chunk F1 "
        f"card {float(extras['cuda'][-1][2]):.4f}, CPU "
        f"{float(extras['cpu'][-1][2]):.4f} [{card}]")
    require(checked > 0 and equal == checked,
            f"j4: {checked - equal} decoded paths differ from the CPU's")
    return {"gate": gate, "paths_checked": checked, "paths_equal": equal}


def j5_dynamic_gru(torch, np, seed, card):
    """j5: a DynamicRNN of seq2seq's GRU cell at hidden 512 over 64 ragged
    rows of up to 100 steps, forward and gradients on the card against
    the CPU (phase 5's float32 training tolerance); a finished row's
    outputs are exact zeros and its final memory its last output, bit
    for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.seq2seq import _gru_step

    B, T, Hd = J5["rows"], J5["max_len"], J5["hidden"]
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        blk = main.global_block()
        x = blk.create_var(name="x", shape=(B, T, Hd), dtype="float32",
                           is_data=True, stop_gradient=False)
        ln = blk.create_var(name="len", shape=(B,), dtype="int32",
                            is_data=True)
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, length=ln)
            prev = drnn.memory(shape=[Hd], value=0.0)
            h = _gru_step((word, prev), Hd, "j5")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()
        loss = L.reduce_sum(L.elementwise_mul(out, out))
        fluid.append_backward(loss)
    rec = [o for o in main.global_block().ops if o.type == "recurrent"][0]
    params = [p.name for p in main.all_parameters()]
    fetch = [out.name, rec.outputs["FinalMemories"][0], "x@GRAD"] + [
        p + "@GRAD" for p in params]
    rng = np.random.RandomState(seed + 5)
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    lens[:2] = (T, 1)
    feed = {"x": rng.randn(B, T, Hd).astype(np.float32), "len": lens}
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    arrays = seeded_arrays(np, main, cpu_scope, J_STD, seed)
    got, secs = {}, {}
    for name, place, dev in (("cuda", fluid.CUDAPlace(0), DEVICE),
                             ("cpu", fluid.CPUPlace(), "cpu")):
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, arrays, main, dev)
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)   # warm
        t = time.perf_counter()
        got[name] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        secs[name] = time.perf_counter() - t
    worst = 0.0
    for n, a, b in zip(fetch, got["cuda"], got["cpu"]):
        d = np.abs(a - b) - (TRAIN_ATOL + TRAIN_RTOL * np.abs(b))
        worst = max(worst, float(np.max(np.abs(a - b))))
        require(np.all(d <= 0), f"j5: {n} card vs CPU beyond rtol "
                f"{TRAIN_RTOL} / atol {TRAIN_ATOL}: {float(d.max()):.3e}")
    o, m = got["cuda"][0], got["cuda"][1]
    for b, n in enumerate(lens):
        require(np.all(o[b, n:] == 0.0), f"j5: row {b} emits past its length")
        require(np.array_equal(m[b], o[b, n - 1]),
                f"j5: row {b}'s final memory is not its last output")
    log(f"  j5 DynamicRNN GRU, {B} rows of 1-{T} steps at hidden {Hd}: "
        f"outputs and {len(fetch) - 2} gradients card vs CPU within "
        f"{worst:.3e} (max abs), frozen rows exact; forward + backward "
        f"{1e3 * secs['cuda']:.1f} ms on the card, {1e3 * secs['cpu']:.1f} "
        f"on the CPU [{card}]")
    return {"max_abs_err": worst, "card_ms": 1e3 * secs["cuda"],
            "cpu_ms": 1e3 * secs["cpu"]}


def phase_j(torch, np, seed, card, out_dir):
    """Phase j: recurrence and sequences. Returns (paths, record)."""
    t = time.perf_counter()
    log(f"  j1 seq2seq at rnn_search's widths: source vocabulary "
        f"{J_SRC_VOCAB}, target {J_TGT_VOCAB}, embedding {J_EMB}, hidden "
        f"{J_HIDDEN}, length {J_SEQ} (rnn_search's 2 LSTM layers reduced to "
        "the book's one attention GRU)")
    counts, rec1, trained = j1_train(torch, np, seed, card, out_dir)
    rec = {"j1": rec1, "j2": j2_beam(torch, np, seed, card, trained)}
    del trained
    torch.cuda.empty_cache()
    rec["j3"] = j3_sentiment(torch, np, seed, card)
    rec["j4"] = j4_srl(torch, np, seed, card)
    rec["j5"] = j5_dynamic_gru(torch, np, seed, card)
    rec["seconds"] = time.perf_counter() - t
    return {"seq2seq_train": counts}, rec


# -- phase k: the imperative mode ----------------------------------------------

K_BATCH = 32              # k1 (a), (c), k2: images a step
K_CPU_BATCH = 4           # k1 (b): phase 5's ResNet-50 card-vs-CPU batch
K_STEPS = 10              # k1 (c): steps 1..9 timed
K_LOSS_RTOL = 1e-5        # k1 (a): dygraph against Program, first loss
K_GRAD_RTOL = 1e-4        # k1 (a): each gradient's relative L2 error;
                          # k4: Momentum's velocities
K_REPLAYS = 3             # k2: fresh batches replayed
K_NN_RTOL, K_NN_ATOL = 1e-4, 1e-5   # k3: the CPU tests' gradient tolerance
K_LN_ROWS = 8 * 512       # k3: BERT-large's layer-norm rows (batch x seq)
K4_ROWS, K4_STEPS = 16, 2  # k4: rows a rank, steps
K4_TIMEOUT_S = 420
K_LEAF = {"conv.w": "conv.weight", "bn.scale": "bn.weight",
          "bn.bias": "bn.bias", "bn.mean": "bn._mean",
          "bn.var": "bn._variance"}


def k_resnet50(dg, classes=1000):
    """The user's dygraph twin of ``models/resnet.py`` ``build_resnet50``:
    ``Conv2D(bias_attr=False)`` + ``BatchNorm(act=...)`` pairs, the
    bottlenecks' VarBase ``+`` and relu, ``Pool2D``, ``Linear``. Its
    sublayer names follow the Program's parameter names (``k_key``)."""
    from paddle_tpu_torch.dygraph.base import _trace
    from paddle_tpu_torch.layers import reshape

    class ConvBN(dg.Layer):
        def __init__(self, cin, cout, k, stride=1, act="relu"):
            super().__init__()
            self.conv = dg.Conv2D(cin, cout, k, stride=stride,
                                  padding=(k - 1) // 2, bias_attr=False)
            self.bn = dg.BatchNorm(cout, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(dg.Layer):
        def __init__(self, cin, f, stride):
            super().__init__()
            self.b0 = ConvBN(cin, f, 1)
            self.b1 = ConvBN(f, f, 3, stride)
            self.b2 = ConvBN(f, 4 * f, 1, act=None)
            self.sc = (ConvBN(cin, 4 * f, 1, stride, act=None)
                       if stride != 1 or cin != 4 * f else None)

        def forward(self, x):
            short = x if self.sc is None else self.sc(x)
            return _trace("relu", {"X": [short + self.b2(self.b1(self.b0(x)))]},
                          ["Out"], {})[0]

    class ResNet50(dg.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, 64, 7, 2)
            self.pool = dg.Pool2D(3, "max", 2, 1)
            self.blocks, cin = [], 64
            for stage, (d, f) in enumerate(zip((3, 4, 6, 3),
                                               (64, 128, 256, 512))):
                for blk in range(d):
                    self.blocks.append(self.add_sublayer(
                        f"s{stage}b{blk}",
                        Bottleneck(cin, f, 2 if blk == 0 and stage else 1)))
                    cin = 4 * f
            self.gap = dg.Pool2D(7, "avg", global_pooling=True)
            self.head = dg.Linear(2048, classes)

        def forward(self, x):
            x = self.pool(self.stem(x))
            for b in self.blocks:
                x = b(x)
            return self.head(reshape(self.gap(x), [-1, 2048]))

    return ResNet50()


def k_key(name, head_bias):
    """The dygraph twin's state_dict key of a Program parameter:
    ``stem.conv.w`` -> ``stem.conv.weight``, ``s0b0.b1.bn.scale`` ->
    ``s0b0.b1.bn.weight``, ``.bn.mean`` / ``.bn.var`` -> ``._mean`` /
    ``._variance``, ``head.w`` and the fc's bias -> ``head.*``."""
    if name == "head.w":
        return "head.weight"
    if name == head_bias:
        return "head.bias"
    for a, b in K_LEAF.items():
        if name.endswith("." + a):
            return name[: -len(a)] + b
    return None


def k_step(fluid, dg, model, opt, image, label):
    """One dygraph step: forward, K4's loss, backward, the update. Returns
    (loss, {key: gradient}) with the gradients read before the update."""
    from paddle_tpu_torch.dygraph.base import _trace

    logits = model(dg.to_variable(image))
    _, per_row = _trace("softmax_with_cross_entropy",
                        {"Logits": [logits], "Label": [dg.to_variable(label)]},
                        ["Softmax", "Loss"], {})
    loss = fluid.layers.mean(per_row)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    opt.minimize(loss, parameter_list=model.parameters())
    model.clear_gradients()
    return loss, grads


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def rel_l2_t(torch, got, want):
    d = float(torch.linalg.vector_norm((got.float() - want.float())))
    n = float(torch.linalg.vector_norm(want.float()))
    return d / n if n else d


def k_bn_gap(np, got, want):
    """The largest BN running-statistic gap over the largest entry."""
    worst, where = 0.0, ""
    for k, w in want.items():
        if k.endswith(("._mean", "._variance")):
            d = float(np.abs(got[k] - w).max() / np.abs(w).max())
            if d > worst:
                worst, where = d, k
    return worst, where


def k1_dygraph(torch, np, seed, card, out_dir):
    """k1: the dygraph ResNet-50 twin. (a) against the Program on the card
    at batch 32, (b) card against CPU at batch 4, (c) timed at batch 32
    beside the Program's bound step. Returns (launches of (c), record,
    the trained model)."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.core.framework import Parameter
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    rec = {}
    lr = resnet_lr(K_BATCH)
    fluid.set_flags({"optimizer_fuse": "auto"})
    with fluid.unique_name.guard():
        main, startup, _, fetches = build_resnet50(
            1000, RESNET_IMAGE,
            fluid.optimizer.MomentumOptimizer(lr, momentum=0.9))
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    params = [v for v in main.list_vars() if isinstance(v, Parameter)]
    persist = [v.name for v in main.list_vars()
               if v.persistable and not v.is_data]
    head_bias = [p.name for p in params if k_key(p.name, None) is None]
    require(len(head_bias) == 1, f"unmapped parameters {head_bias}")
    keymap = {n: k_key(n, head_bias[0]) for n in persist}
    keymap = {n: k for n, k in keymap.items() if k is not None}
    init = {keymap[n]: scope.get_numpy(n) for n in keymap}
    log(f"  the Program's {len(keymap)} parameters and statistics mapped "
        f"onto the twin's keys ({len(params)} parameters, {n_params} "
        "values)")
    data = synthetic_image_batch(np.random.RandomState(seed), K_BATCH,
                                 RESNET_IMAGE)

    # (a) dygraph against the Program, on the card
    K.reset_launch_counts()
    outs = exe.run(main, feed=data, fetch_list=[fetches["loss"]] + [
        p.name + "@GRAD" for p in params], scope=scope)
    torch.cuda.synchronize()
    prog_counts = K.launch_counts()
    prog_loss = float(np.asarray(outs[0]).reshape(-1)[0])
    prog_grads = {keymap[p.name]: torch.as_tensor(np.asarray(g))
                  for p, g in zip(params, outs[1:])}
    prog_stats = {keymap[n]: scope.get_numpy(n) for n in keymap
                  if n.endswith((".bn.mean", ".bn.var"))}
    with dg.guard(fluid.CUDAPlace(0)):
        model = k_resnet50(dg)
        model.set_dict(init)
        opt = fluid.optimizer.MomentumOptimizer(lr, momentum=0.9)
        K.reset_launch_counts()
        loss, grads = k_step(fluid, dg, model, opt, data["image"],
                             data["label"])
        torch.cuda.synchronize()
        dy_counts = K.launch_counts()
        dy_loss = float(loss.numpy())
        dy_stats = {k: v for k, v in model.state_dict().items()
                    if k in prog_stats}
    rel = abs(dy_loss - prog_loss) / abs(prog_loss)
    require(set(grads) == set(prog_grads),
            f"gradient keys differ: {sorted(set(grads) ^ set(prog_grads))}")
    grad_err = {k: rel_l2_t(torch, grads[k].cpu(), prog_grads[k])
                for k in grads}
    worst = max(grad_err, key=grad_err.get)
    bn, bn_where = k_bn_gap(np, dy_stats, prog_stats)
    log(f"  (a) dygraph against the Program at batch {K_BATCH}: first loss "
        f"{dy_loss:.7f} against {prog_loss:.7f} (rel {rel:.3e}, limit "
        f"{K_LOSS_RTOL}); the worst gradient {worst} at relative L2 "
        f"{grad_err[worst]:.3e} (limit {K_GRAD_RTOL}); BN running "
        f"statistics within {bn:.3e} of their largest ({bn_where}; limit "
        f"{BN_STATS_RTOL}); launches dygraph {nonzero(dy_counts)}, Program "
        f"{nonzero(prog_counts)}")
    require(rel <= K_LOSS_RTOL, f"k1 (a): first loss rel {rel:.3e}")
    require(grad_err[worst] <= K_GRAD_RTOL,
            f"k1 (a): gradient {worst} rel L2 {grad_err[worst]:.3e}")
    require(bn <= BN_STATS_RTOL, f"k1 (a): BN statistic {bn_where} {bn:.3e}")
    for what, c in (("dygraph", dy_counts), ("Program", prog_counts)):
        require(c["softmax_xent_fwd"] == 1 and c["softmax_xent_bwd"] == 1,
                f"k1 (a): the {what} step launched K4 / K5 "
                f"{c['softmax_xent_fwd']} / {c['softmax_xent_bwd']} times")
    rec["a"] = {"first_loss": dy_loss, "program_first_loss": prog_loss,
                "loss_rel_err": rel, "grad_rel_l2_worst": grad_err[worst],
                "grad_worst": worst, "bn_stats_rel_err": bn,
                "launches_dygraph": nonzero(dy_counts),
                "launches_program": nonzero(prog_counts)}
    del grads, prog_grads, outs

    # (b) card against CPU, batch 4, phase 5's gates
    lr4 = resnet_lr(K_CPU_BATCH)
    small = synthetic_image_batch(np.random.RandomState(seed + 1),
                                  K_CPU_BATCH, RESNET_IMAGE)
    runs = {}
    for name, place in (("cuda", fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        t = time.perf_counter()
        with dg.guard(place):
            m = k_resnet50(dg)
            m.set_dict(init)
            loss, _ = k_step(fluid, dg, m,
                             fluid.optimizer.MomentumOptimizer(lr4, 0.9),
                             small["image"], small["label"])
            runs[name] = (float(loss.numpy()), m.state_dict())
        log(f"  (b) {name}: first loss {runs[name][0]:.7f} in "
            f"{time.perf_counter() - t:.1f} s")
    (lg, sg), (lc, sc) = runs["cuda"], runs["cpu"]
    rel_b = abs(lg - lc) / abs(lc)
    bn_b, bn_b_where = k_bn_gap(np, sg, sc)
    pworst, pwhere = max((float(np.abs(sg[k] - sc[k]).max()), k)
                         for k in sc if not k.endswith(("._mean",
                                                        "._variance")))
    log(f"  (b) card against CPU at batch {K_CPU_BATCH}: first loss rel "
        f"{rel_b:.3e} (limit {CARD_VS_CPU_RESNET_RTOL}); parameters after "
        f"the update within {pworst:.3e} ({pwhere}; limit 2 * lr = "
        f"{2 * lr4:.3e}); BN running statistics within {bn_b:.3e} of their "
        f"largest ({bn_b_where}; limit {BN_STATS_RTOL})")
    require(rel_b <= CARD_VS_CPU_RESNET_RTOL, f"k1 (b): first loss {rel_b:.3e}")
    require(pworst <= 2 * lr4, f"k1 (b): parameter {pwhere} {pworst:.3e}")
    require(bn_b <= BN_STATS_RTOL, f"k1 (b): BN statistic {bn_b_where}")
    rec["b"] = {"first_loss_rel_err": rel_b, "param_max_abs_err": pworst,
                "param_limit": 2 * lr4, "bn_stats_rel_err": bn_b}
    del runs, sg, sc

    # (c) timed: dygraph steps against the Program's bound step
    totals = {n: 0 for n in K.KERNELS}
    step_ms, losses = [], []
    with dg.guard(fluid.CUDAPlace(0)):
        torch.cuda.reset_peak_memory_stats()
        for s in range(K_STEPS):
            K.reset_launch_counts()
            t = time.perf_counter()
            loss, _ = k_step(fluid, dg, model, opt, data["image"],
                             data["label"])
            losses.append(float(loss.numpy()))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            for n, c in K.launch_counts().items():
                totals[n] += c
        peak = torch.cuda.max_memory_allocated()
        prof = start_profile(torch)
        t = time.perf_counter()
        k_step(fluid, dg, model, opt, data["image"], data["label"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        prof.__exit__(None, None, None)
        breakdown = trace_breakdown(prof, out_dir, "k1_dygraph", wall, 1)
    require(all(np.isfinite(losses)), f"k1 (c): non-finite loss {losses}")
    require(totals["softmax_xent_fwd"] == K_STEPS
            and totals["softmax_xent_bwd"] == K_STEPS,
            f"k1 (c): K4 / K5 launches {nonzero(totals)} over {K_STEPS} steps")
    prog_ms = []
    for s in range(K_STEPS):
        t = time.perf_counter()
        exe.run(main, feed=data, fetch_list=[fetches["loss"]], scope=scope)
        torch.cuda.synchronize()
        prog_ms.append((time.perf_counter() - t) * 1e3)
    prof = start_profile(torch)
    t = time.perf_counter()
    exe.run(main, feed=data, fetch_list=[fetches["loss"]], scope=scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof.__exit__(None, None, None)
    prog_breakdown = trace_breakdown(prof, out_dir, "k1_program", wall, 1)
    dy_mean, prog_mean = (statistics.mean(step_ms[1:]),
                          statistics.mean(prog_ms[1:]))
    rec["c"] = {"step_ms": step_ms, "step_ms_mean": dy_mean,
                "program_step_ms": prog_ms, "program_step_ms_mean": prog_mean,
                "ratio_to_program": dy_mean / prog_mean,
                "images_per_s": K_BATCH / (dy_mean / 1e3),
                "program_images_per_s": K_BATCH / (prog_mean / 1e3),
                "eager_launches_a_step": breakdown["kernels"],
                "device_idle_share": breakdown["device_idle_share"],
                "device_busy_ms": breakdown["device_busy_ms"],
                "program_launches_a_step": prog_breakdown["kernels"],
                "program_device_idle_share":
                    prog_breakdown["device_idle_share"],
                "program_device_busy_ms": prog_breakdown["device_busy_ms"],
                "max_memory_allocated_gb": peak / 1e9, "losses": losses,
                "card": card}
    log(f"  (c) reported: dygraph {dy_mean:.3f} ms a step over steps 1..9 "
        f"({K_BATCH / (dy_mean / 1e3):.1f} images/s), the Program's bound "
        f"step {prog_mean:.3f} ms ({K_BATCH / (prog_mean / 1e3):.1f} "
        f"images/s), ratio {dy_mean / prog_mean:.3f}; one profiled step: "
        f"dygraph {breakdown['kernels']} kernels, device busy "
        f"{breakdown['device_busy_ms']:.3f} ms, idle share "
        f"{breakdown['device_idle_share']:.3f}; Program "
        f"{prog_breakdown['kernels']} kernels, busy "
        f"{prog_breakdown['device_busy_ms']:.3f} ms, idle share "
        f"{prog_breakdown['device_idle_share']:.3f}; peak "
        f"{peak / 1e9:.2f} GB; losses {['%.4f' % x for x in losses]} [{card}]")
    del exe, scope
    return totals, rec, model


def k2_traced(torch, np, seed, card, model):
    """k2: ``TracedLayer`` over k1's model in eval mode at batch 32: on
    fresh batches the replay equals the eager forward bit for bit."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.models.resnet import synthetic_image_batch

    rng = np.random.RandomState(seed + 2)
    with dg.guard(fluid.CUDAPlace(0)):
        model.eval()
        first = synthetic_image_batch(rng, K_BATCH, RESNET_IMAGE)["image"]
        t = time.perf_counter()
        _, traced = dg.TracedLayer.trace(model, [first])
        torch.cuda.synchronize()
        trace_s = time.perf_counter() - t
        eager_ms, replay_ms = [], []
        for i in range(K_REPLAYS):
            x = dg.to_variable(
                synthetic_image_batch(rng, K_BATCH, RESNET_IMAGE)["image"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            with dg.no_grad():
                want = model(x).value
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            got = traced([x])[0].value
            torch.cuda.synchronize()
            replay_ms.append((time.perf_counter() - t) * 1e3)
            require(torch.equal(got, want),
                    f"k2: batch {i}: the replay differs from the eager "
                    f"forward by {float((got - want).abs().max()):.3e}")
        model.train()
    rec = {"trace_s": trace_s, "eager_ms": eager_ms, "replay_ms": replay_ms,
           "card": card}
    log(f"  k2: TracedLayer captured in {trace_s:.2f} s; {K_REPLAYS} fresh "
        f"batches of {K_BATCH}, replay equal to the eager forward bit for "
        f"bit; ms a forward eager {['%.3f' % x for x in eager_ms]}, replay "
        f"{['%.3f' % x for x in replay_ms]} [{card}]")
    return rec


def k3_cases(np):
    """Every dygraph.nn class at the CPU tests' shapes:
    name -> (build(dg), inputs, mode)."""
    r = np.random.RandomState(4)

    def f(*s):
        return r.randn(*s).astype("float32")

    return {
        "Linear": (lambda dg: dg.Linear(3, 2, act="relu"), [f(2, 3)]),
        "Conv2D": (lambda dg: dg.Conv2D(3, 4, 3, padding=1, act="relu"),
                   [f(2, 3, 5, 5)]),
        "Pool2D": (lambda dg: dg.Pool2D(2, "max", 2), [f(2, 3, 4, 4)]),
        "BatchNorm": (lambda dg: dg.BatchNorm(3, act="relu"),
                      [f(4, 3, 5, 5)]),
        "Embedding": (lambda dg: dg.nn.Embedding([10, 4]),
                      [r.randint(0, 10, (2, 3)).astype("int64")]),
        "LayerNorm": (lambda dg: dg.LayerNorm(4), [f(2, 3, 4)]),
        "Dropout": (lambda dg: dg.Dropout(p=0.0), [f(2, 5)]),
        "Conv2DTranspose": (lambda dg: dg.nn.Conv2DTranspose(3, 5, 3),
                            [f(2, 3, 6, 6)]),
        "Conv3D": (lambda dg: dg.nn.Conv3D(2, 4, 3, padding=1),
                   [f(1, 2, 5, 5, 5)]),
        "Conv3DTranspose": (lambda dg: dg.nn.Conv3DTranspose(2, 3, 1),
                            [f(1, 2, 4, 4, 4)]),
        "GRUUnit": (lambda dg: dg.nn.GRUUnit(12), [f(2, 12), f(2, 4)]),
        "PRelu": (lambda dg: dg.nn.PRelu(mode="channel", channel=3),
                  [f(2, 3, 4, 4)]),
        "BilinearTensorProduct": (
            lambda dg: dg.nn.BilinearTensorProduct(3, 4, 5), [f(2, 3),
                                                              f(2, 4)]),
        "SequenceConv": (lambda dg: dg.nn.SequenceConv(
            num_filters=6, filter_size=3, input_dim=4), [f(2, 5, 4)]),
        "RowConv": (lambda dg: dg.nn.RowConv(4, future_context_size=2),
                    [f(2, 6, 4)]),
        "GroupNorm": (lambda dg: dg.nn.GroupNorm(4, groups=2),
                      [f(2, 4, 3, 3)]),
        "SpectralNorm": (lambda dg: dg.nn.SpectralNorm([6, 4],
                                                       power_iters=2),
                         [f(6, 4)]),
        "TreeConv": (lambda dg: dg.nn.TreeConv(4, 5),
                     [f(1, 3, 4), np.array([[[0, 1], [0, 2]]], "int32")]),
        "NCE": (lambda dg: dg.nn.NCE(num_total_classes=20, dim=6,
                                     num_neg_samples=4),
                [f(3, 6), r.randint(0, 20, (3, 1)).astype("int64")]),
    }


def k3_run(torch, np, fluid, dg, place, build, inputs, state=None):
    """(outputs, {name: gradient}, state_dict) of one class's forward and
    the backward of the mean of its first output; NCE also returns its
    sampled classes."""
    from paddle_tpu_torch.dygraph.base import _trace

    with dg.guard(place):
        layer = build(dg)
        xs = [dg.to_variable(a) for a in inputs]
        for x in xs:
            if x.value.is_floating_point():
                x.stop_gradient = False
        if isinstance(layer, dg.nn.NCE):
            # NCE's classes: traced as the layer does, with the sampled
            # classes kept
            if state is None:
                layer(xs[0], xs[1])   # the layer itself runs too
            else:
                layer.set_dict(state)
            ins = {"Input": [xs[0]], "Label": [xs[1]],
                   "Weight": [layer.weight], "Bias": [layer.bias]}
            outs = _trace("nce", ins, ["Cost", "SampleLogits",
                                       "SampleLabels"], dict(layer._attrs))
        else:
            if state is not None:
                layer.set_dict(state)
            out = layer(*xs)
            outs = list(out) if isinstance(out, tuple) else [out]
        loss = outs[0]
        while loss.shape:
            loss = fluid.layers.mean(loss)
        loss.backward()
        grads = {k: p.gradient for k, p in layer.named_parameters()}
        grads.update({f"x{i}": x.gradient for i, x in enumerate(xs)
                      if x.gradient is not None})
        return [o.numpy() for o in outs], grads, layer.state_dict()


def k3_nce_cost(np, x, w, b, cls):
    """JAX's nce formula on given sampled classes (the CPU test's)."""
    logits = np.einsum("bd,bkd->bk", x, w[cls]) + b.reshape(-1)[cls]
    labels = np.zeros_like(logits)
    labels[:, 0] = 1
    return (np.logaddexp(logits, 0) - labels * logits).sum(1, keepdims=True)


def k3_classes(torch, np, card):
    """k3: each dygraph.nn class forward and backward on the card against
    the CPU from the CPU's weights; dg.LayerNorm at BERT-large's rows
    through exactly 1 K1 and 1 K3 against its plain version."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch import kernels as K

    K.reset_launch_counts()
    worst = {}
    for name, (build, inputs) in k3_cases(np).items():
        c_outs, c_grads, state = k3_run(torch, np, fluid, dg,
                                        fluid.CPUPlace(), build, inputs)
        g_outs, g_grads, _ = k3_run(torch, np, fluid, dg, fluid.CUDAPlace(0),
                                    build, inputs, state)
        if name == "NCE":
            x = inputs[0]
            w, b = state["weight"], state["bias"]
            for what, outs in (("CPU", c_outs), ("card", g_outs)):
                cls = outs[2]
                require(cls.min() >= 0 and cls.max() < 20
                        and (cls[:, 0] == inputs[1].reshape(-1)).all(),
                        f"k3 NCE on the {what}: classes {cls}")
                got, want = outs[0], k3_nce_cost(np, x, w, b, cls)
                require(np.allclose(got, want, rtol=1e-5, atol=1e-6),
                        f"k3 NCE on the {what}: cost {got} against {want}")
            worst[name] = 0.0
            continue
        err = 0.0
        pairs = [(f"out{i}", a, b) for i, (a, b) in
                 enumerate(zip(g_outs, c_outs))]
        require(set(g_grads) == set(c_grads), f"k3 {name}: gradient keys")
        pairs += [(k, g_grads[k], c_grads[k]) for k in c_grads
                  if c_grads[k] is not None]
        for what, a, b in pairs:
            require(a.shape == b.shape, f"k3 {name} {what}: shapes")
            if a.dtype.kind in "biu":
                require((a == b).all(), f"k3 {name} {what}: differs")
                continue
            require(np.allclose(a, b, rtol=K_NN_RTOL, atol=K_NN_ATOL),
                    f"k3 {name} {what}: max abs diff "
                    f"{float(np.abs(a - b).max()):.3e}")
            err = max(err, float(np.abs(a - b).max()))
        worst[name] = err
    small_counts = K.launch_counts()
    log(f"  k3: {len(worst)} dygraph.nn classes, card against CPU within "
        f"rtol {K_NN_RTOL} / atol {K_NN_ATOL}: max abs diff by class "
        + json.dumps({k: float('%.3e' % v) for k, v in worst.items()}))

    # dg.LayerNorm at BERT-large's [8 * 512, 1024]
    R, C = K_LN_ROWS, 1024
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x0 = torch.randn(R, C, device=DEVICE, generator=gen)
    dy = torch.randn(R, C, device=DEVICE, generator=gen)
    with dg.guard(fluid.CUDAPlace(0)):
        ln = dg.LayerNorm(C)
        ln.set_dict({"weight": (1 + 0.1 * torch.randn(
            C, device=DEVICE, generator=gen)).cpu().numpy(),
            "bias": (0.1 * torch.randn(C, device=DEVICE,
                                       generator=gen)).cpu().numpy()})
        x = dg.to_variable(x0)
        x.stop_gradient = False
        before = K.launch_counts()
        y = ln(x)
        y.value.backward(dy)
        torch.cuda.synchronize()
        after = K.launch_counts()
        got = [y.value.detach(), x.grad, ln.weight.grad, ln.bias.grad]
    ln_launches = {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}
    require(ln_launches == {"layer_norm": 1, "layer_norm_bwd": 1},
            f"k3: dg.LayerNorm launched {ln_launches}, not one K1 and one K3")
    xp = x0.clone().requires_grad_(True)
    gp = ln.weight.value.detach().clone().requires_grad_(True)
    bp = ln.bias.value.detach().clone().requires_grad_(True)
    yp = torch.nn.functional.layer_norm(xp, [C], gp, bp, 1e-5)
    yp.backward(dy)
    errs = [compare(torch, g, w, "float32", f"k3 dg.LayerNorm [{R}x{C}] {n}",
                    atol=t)
            for n, g, w, t in zip(("y", "dx", "dgamma", "dbeta"), got,
                                  [yp.detach(), xp.grad, gp.grad, bp.grad],
                                  (None, None, 2e-5 * R ** 0.5,
                                   2e-5 * R ** 0.5))]
    log(f"  k3: dg.LayerNorm at [{R}x{C}] launched one K1 and one K3; y, dx, "
        f"dgamma, dbeta against the plain version max abs err "
        f"{['%.3e' % e for e in errs]} (dgamma / dbeta limit 2e-5 * sqrt(R) "
        f"= {2e-5 * R ** 0.5:.3e})")
    counts = K.launch_counts()
    return counts, {"max_abs_diff_by_class": worst,
                    "small_shape_launches": nonzero(small_counts),
                    "layer_norm_errs": errs}


def k4_batches(np, seed):
    rng = np.random.RandomState(seed + 3)
    from paddle_tpu_torch.models.resnet import synthetic_image_batch

    return [synthetic_image_batch(rng, 2 * K4_ROWS, RESNET_IMAGE)
            for _ in range(K4_STEPS)]


def k4_velocities(opt, model):
    states = opt._eager_states
    return {k: states[id(p)]["velocity"].detach().cpu()
            for k, p in model.named_parameters() if id(p) in states}


def k4_child(argv) -> int:
    """One rank of k4's gloo world of 2 on one card: the k1 model under
    ``DataParallel``, its half of each batch; results to
    ``<dir>/k4.rank<r>.pt``."""
    out_dir, seed = argv[0], int(argv[1])
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True    # as k4_reference
    env = dg.prepare_context()
    rank, n = env.rank, env.nranks
    init = dict(np.load(os.path.join(out_dir, "k4_init.npz")))
    sums = []
    with dg.guard(fluid.CUDAPlace(0)):
        model = k_resnet50(dg)
        model.set_dict(init)
        dp = dg.DataParallel(model)
        opt = fluid.optimizer.MomentumOptimizer(resnet_lr(2 * K4_ROWS), 0.9)
        from paddle_tpu_torch.dygraph.base import _trace

        for batch in k4_batches(np, seed):
            rows = slice(rank * K4_ROWS, (rank + 1) * K4_ROWS)
            logits = dp(dg.to_variable(batch["image"][rows]))
            _, per_row = _trace(
                "softmax_with_cross_entropy",
                {"Logits": [logits],
                 "Label": [dg.to_variable(batch["label"][rows])]},
                ["Softmax", "Loss"], {})
            loss = dp.scale_loss(fluid.layers.mean(per_row))
            loss.backward()
            dp.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            mine = _bit_sums(torch, [p.value for p in model.parameters()
                                     if not p.stop_gradient])
            parts = [torch.zeros_like(mine) for _ in range(n)]
            torch.distributed.all_gather(parts, mine)
            sums.append(all(torch.equal(parts[0], p) for p in parts[1:]))
        torch.save({"params": {k: torch.as_tensor(v) for k, v in
                               model.state_dict().items()},
                    "velocities": k4_velocities(opt, model),
                    "same_each_step": sums},
                   os.path.join(out_dir, f"k4.rank{rank}.pt.tmp"))
    os.replace(os.path.join(out_dir, f"k4.rank{rank}.pt.tmp"),
               os.path.join(out_dir, f"k4.rank{rank}.pt"))
    return 0


def k4_reference(torch, np, fluid, dg, init, seed):
    """One process: each step's two halves through ``backward()`` with
    each loss scaled by 1/2, the gradients accumulated, then one step.
    cuDNN's deterministic algorithms here and in the ranks: at
    initialisation ResNet-50 turns a last-bit difference in one step's
    weight gradients into percents of the next step's (PERF.md §6)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _k4_reference(torch, np, fluid, dg, init, seed)
    finally:
        torch.backends.cudnn.deterministic = saved


def _k4_reference(torch, np, fluid, dg, init, seed):
    from paddle_tpu_torch.dygraph.base import _trace

    with dg.guard(fluid.CUDAPlace(0)):
        model = k_resnet50(dg)
        model.set_dict(init)
        opt = fluid.optimizer.MomentumOptimizer(resnet_lr(2 * K4_ROWS), 0.9)
        for batch in k4_batches(np, seed):
            last = None
            for half in range(2):
                rows = slice(half * K4_ROWS, (half + 1) * K4_ROWS)
                logits = model(dg.to_variable(batch["image"][rows]))
                _, per_row = _trace(
                    "softmax_with_cross_entropy",
                    {"Logits": [logits],
                     "Label": [dg.to_variable(batch["label"][rows])]},
                    ["Softmax", "Loss"], {})
                last = fluid.layers.mean(per_row) * 0.5
                last.backward()
            opt.minimize(last, parameter_list=model.parameters())
            model.clear_gradients()
        return ({k: torch.as_tensor(v) for k, v in model.state_dict().items()},
                k4_velocities(opt, model))


def phase_k(torch, np, seed, card, out_dir):
    """Phase k: the imperative mode. Returns (paths, record)."""
    t0 = time.perf_counter()
    rec = {}
    # the world's files (the initial weights, 100 MB, and the ranks'
    # results) stay out of ``out_dir``
    kdir = tempfile.mkdtemp(prefix="chip_smoke_k4_")
    try:
        return _phase_k(torch, np, seed, card, out_dir, kdir, t0, rec)
    finally:
        shutil.rmtree(kdir, ignore_errors=True)


def _phase_k(torch, np, seed, card, out_dir, kdir, t0, rec):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg

    with dg.guard(fluid.CUDAPlace(0)):
        fluid.default_startup_program().random_seed = seed
        init = k_resnet50(dg).state_dict()
    np.savez(os.path.join(kdir, "k4_init.npz"), **init)
    log(f"  k4: a gloo world of 2 on the card started beside k3 (the "
        f"twin, {K4_ROWS} rows a rank, {K4_STEPS} Momentum steps)")

    def meanwhile():
        ref = k4_reference(torch, np, fluid, dg, init, seed)
        counts = k3_classes(torch, np, card)
        return ref, counts

    rc, err, secs, (ref, (k3_counts, rec["k3"])) = launch_world(
        ["--k4-child", kdir, str(seed)], kdir, K4_TIMEOUT_S,
        meanwhile=meanwhile)
    require(rc == 0, f"k4's world exited {rc}: {err[-3000:]}")
    ranks = [torch.load(os.path.join(kdir, f"k4.rank{r}.pt"))
             for r in range(2)]
    ref_params, ref_vel = ref
    lr = resnet_lr(2 * K4_ROWS)
    pworst, pwhere = max(
        (float((ranks[0]["params"][k] - ref_params[k]).abs().max()), k)
        for k in ref_params if not k.endswith(("._mean", "._variance")))
    verr = {k: rel_l2_t(torch, ranks[0]["velocities"][k], ref_vel[k])
            for k in ref_vel}
    vworst = max(verr, key=verr.get)
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ref_params if not k.endswith(("._mean",
                                                      "._variance")))
    log(f"  k4: the world took {secs:.1f} s; parameters against the "
        f"accumulated halves within {pworst:.3e} ({pwhere}; limit 2 * lr * "
        f"steps = {2 * lr * K4_STEPS:.3e}); velocities at relative L2 "
        f"{verr[vworst]:.3e} ({vworst}; limit {K_GRAD_RTOL}); the ranks' "
        f"parameters equal bit for bit every step "
        f"{ranks[0]['same_each_step']}, at the end {same}. BN running "
        "statistics are not compared: each rank updates them from its own "
        "half")
    require(pworst <= 2 * lr * K4_STEPS, f"k4: parameter {pwhere} {pworst}")
    require(verr[vworst] <= K_GRAD_RTOL, f"k4: velocity {vworst} "
            f"{verr[vworst]:.3e}")
    require(same and all(ranks[0]["same_each_step"])
            and all(ranks[1]["same_each_step"]),
            "k4: the ranks' parameters differ")
    rec["k4"] = {"world_s": secs, "param_max_abs_err": pworst,
                 "velocity_rel_l2_worst": verr[vworst], "ranks_equal": same}
    torch.cuda.empty_cache()
    log("  k1: the dygraph ResNet-50 twin at 224^2, 1000 classes")
    k1_counts, rec["k1"], model = k1_dygraph(torch, np, seed, card, out_dir)
    rec["k2"] = k2_traced(torch, np, seed, card, model)
    del model
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return {"dygraph_resnet": k1_counts, "dygraph_layers": k3_counts}, rec


# -- phase l: detection ----------------------------------------------------------

L_SIZE, L_CLASSES, L_MAX_GT = 300, 21, 8   # SSD300's input, VOC's classes
L_LR = 2e-3                 # tests/test_models_ssd.py's Adam
L_GATE_BATCH, L_GATE_STEPS = 4, 2
L_TRAIN_BATCH, L_TRAIN_STEPS = 32, 10
L_DET_BATCH, L_DET_CPU = 8, 2
L_NMS_IOU = 0.45            # detection_output's nms_threshold
L_TIE = 1e-6                # a near-tie: a score gap or an IoU this close
L_RPN = {"feat": (1, 1024, 50, 68), "stride": 16.0,
         "sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
         "ratios": [0.5, 1.0, 2.0], "pre": 6000, "post": 1000, "nms": 0.7,
         "im_info": [800.0, 1088.0, 1.0], "pooled": 7}


def l_ssd(fluid, optimizer=None):
    from paddle_tpu_torch.models.ssd import build_ssd

    return build_ssd(image_size=L_SIZE, num_classes=L_CLASSES,
                     optimizer=optimizer, max_gt=L_MAX_GT)


def l_batches(np, rng, n, batch):
    from paddle_tpu_torch.models.ssd import synthetic_det_batch

    return [synthetic_det_batch(rng, batch, image_size=L_SIZE,
                                num_classes=L_CLASSES, max_gt=L_MAX_GT)
            for _ in range(n)]


def l_mining(torch, conf, feed, prior):
    """The hard negatives ``ssd_loss_dense`` mines from ``conf`` (its
    own ``match_and_mine``) and, an image, the gap between the last
    mined loss and the next: [B, P] mask, [B] gaps."""
    from paddle_tpu_torch.models.ssd import match_and_mine

    dev = conf.device
    pos, _, loss, mined = match_and_mine(
        conf, torch.as_tensor(feed["gt_box"], device=dev),
        torch.as_tensor(feed["gt_label"], device=dev), prior.to(dev))
    neg = torch.where(pos, torch.full_like(loss, -float("inf")), loss)
    srt = torch.sort(neg, dim=1, descending=True, stable=True).values
    k = mined.sum(1, keepdim=True).clamp(min=1)
    gaps = (torch.gather(srt, 1, k - 1) - torch.gather(srt, 1, k))[:, 0]
    return mined, gaps


def l1_gate(torch, np, seed, card):
    """l1 (a): 2 Adam steps at batch 4 from the same startup values on
    the card and the CPU. Returns (record, the startup values)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    fluid.set_flags({"optimizer_fuse": "on"})
    main, startup, _, fetches = l_ssd(fluid, fluid.optimizer.AdamOptimizer(
        L_LR))
    main.random_seed = startup.random_seed = seed
    params = main.all_parameters()
    n_adam = [op.type for op in main.global_block().ops].count("fused_adam")
    log(f"  l1: build_ssd({L_SIZE}, {L_CLASSES} classes, max_gt {L_MAX_GT}):"
        f" {len(params)} parameters "
        f"({sum(int(np.prod(p.shape)) for p in params)} values), "
        f"{n_adam} fused_adam ops")
    require(n_adam == len(params) == 14,
            f"l1: {n_adam} fused_adam ops for {len(params)} parameters, "
            "not 14")
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    init = {v.name: np.array(cpu_scope.get_numpy(v.name))
            for v in main.list_vars() if v.persistable and not v.is_data}
    gpu, gpu_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gpu_scope)
    load_scope_arrays(gpu_scope, init, main, DEVICE)
    batches = l_batches(np, np.random.RandomState(seed), L_GATE_STEPS,
                        L_GATE_BATCH)
    loss_op = next(op for op in main.global_block().ops
                   if op.type == "ssd_loss_dense")
    conf_name, prior_name = loss_op.input("Conf")[0], loss_op.input("Prior")[0]
    losses, confs, secs = {}, {}, {}
    for name, exe, scope in (("cuda", gpu, gpu_scope),
                             ("cpu", cpu, cpu_scope)):
        K.reset_launch_counts()
        t = time.perf_counter()
        runs = [exe.run(main, feed=b, fetch_list=[fetches["loss"],
                                                  conf_name, prior_name],
                        scope=scope) for b in batches]
        secs[name] = time.perf_counter() - t
        losses[name] = [float(np.asarray(r[0]).reshape(-1)[0]) for r in runs]
        dev = DEVICE if name == "cuda" else "cpu"
        confs[name] = (torch.as_tensor(np.asarray(runs[0][1]), device=dev),
                       torch.as_tensor(np.asarray(runs[0][2]), device=dev))
        if name == "cuda":
            counts = K.launch_counts()
    # the first step's mining on both devices: where the card and the
    # CPU mine other negatives, the last mined and the next loss must
    # sit at a near-tie
    mined, gaps = {}, {}
    for name in ("cuda", "cpu"):
        conf, prior = confs[name]
        mined[name], gaps[name] = l_mining(torch, conf, batches[0], prior)
    same_mining = bool(torch.equal(mined["cuda"].cpu(), mined["cpu"]))
    min_gap = float(gaps["cpu"].min())
    steps = len(batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    worst, worst_name = 0.0, ""
    for p in params:
        d = float(np.abs(gpu_scope.get_numpy(p.name)
                         - cpu_scope.get_numpy(p.name)).max())
        if d > worst:
            worst, worst_name = d, p.name
    m1, m1_name = j_moment_gap(main, gpu_scope, cpu_scope)
    log(f"  l1 (a) batch {L_GATE_BATCH}: card {losses['cuda']} "
        f"({secs['cuda']:.1f} s), CPU {losses['cpu']} ({secs['cpu']:.1f} s);"
        f" losses within {rel:.3e}, parameters {worst:.3e} ({worst_name}), "
        f"first moments {m1:.3e} ({m1_name}, relative L2); the first step's "
        f"hard negatives equal: {same_mining} (smallest gap at the mining "
        f"boundary {min_gap:.3e}); launches "
        f"{dict((k, v) for k, v in counts.items() if v)}")
    if not same_mining:
        diff = (mined["cuda"].cpu() != mined["cpu"]).nonzero().tolist()
        log(f"  l1 (a): priors mined on one device only (image, prior): "
            f"{diff[:8]}; boundary gaps {gaps['cpu'].tolist()}")
        require(min_gap <= L_TIE * float(confs["cpu"][0].abs().max()),
                f"l1 (a): the card and the CPU mine other negatives away "
                f"from a near-tie (gap {min_gap:.3e})")
    j_require_launches(counts, {"fused_adam_update": n_adam * steps,
                                "softmax_xent_fwd": 0,
                                "softmax_xent_bwd": 0}, "l1 (a)")
    require(rel <= 1e-3, f"l1 (a): card vs CPU losses differ by {rel:.3e}")
    limit = 2 * L_LR * steps
    require(worst <= limit, f"l1 (a): parameter {worst_name} differs by "
            f"{worst:.3e} > 2 * lr * steps = {limit:.1e}")
    require(m1 <= 1e-4, f"l1 (a): first moments differ by {m1:.3e} "
            "(relative L2) > 1e-4")
    return ({"losses": losses, "loss_rel_err": rel, "param_max_abs_err": worst,
             "param_limit": limit, "moment_rel_l2": m1,
             "same_hard_negatives": same_mining, "mining_gap_min": min_gap,
             "n_parameters": len(params),
             "launches": {k: v for k, v in counts.items() if v},
             "card_s": secs["cuda"], "cpu_s": secs["cpu"]}, init)


def l1_train(torch, np, seed, card, out_dir, init):
    """l1 (b): 10 steps at batch 32 on the card over 2 cycled batches.
    Returns (launches, record, the trained scope, its first batch)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    main, startup, _, fetches = l_ssd(fluid, fluid.optimizer.AdamOptimizer(
        L_LR))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    load_scope_arrays(scope, init, main, DEVICE)
    data = l_batches(np, np.random.RandomState(seed + 1), 2, L_TRAIN_BATCH)
    batches = [data[i % 2] for i in range(L_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for b in batches:
        t = time.perf_counter()
        losses.append(float(np.asarray(exe.run(
            main, feed=b, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    # one more step profiled, on a copy of the state, so the trained
    # weights stay those of the 10 steps
    snap = {v.name: scope.find_var(v.name).clone() for v in main.list_vars()
            if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}
    prof = start_profile(torch)
    t = time.perf_counter()
    exe.run(main, feed=batches[0], fetch_list=[fetches["loss"]], scope=scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof.__exit__(None, None, None)
    for n, v in snap.items():
        scope.set_var(n, v)
    breakdown = trace_breakdown(prof, out_dir, "l1b", wall, steps=1)
    step_ms = 1e3 * statistics.mean(times[1:])
    images_s = L_TRAIN_BATCH / (step_ms / 1e3)
    n_params = len(main.all_parameters())
    log(f"  l1 (b) batch {L_TRAIN_BATCH} x {L_SIZE}^2, {L_TRAIN_STEPS} steps:"
        f" losses {losses}; {step_ms:.3f} ms a step (steps 2-10; first "
        f"{1e3 * times[0]:.1f}), {images_s:.2f} images/s, "
        f"{breakdown['kernels']} kernels a step (profiled), device idle "
        f"{breakdown['device_idle_share']:.3f}, peak {peak:.2f} GB [{card}]")
    require(all(np.isfinite(losses)), f"l1 (b): a loss is not finite: "
            f"{losses}")
    require(np.mean(losses[-3:]) < losses[0],
            f"l1 (b): the last three losses do not fall below the first: "
            f"{losses}")
    j_require_launches(counts, {"fused_adam_update": n_params * L_TRAIN_STEPS},
                       "l1 (b)")
    return counts, {"losses": losses, "step_ms": step_ms,
                    "first_step_ms": 1e3 * times[0], "images_s": images_s,
                    "kernels_a_step": breakdown["kernels"],
                    "device_idle_share": breakdown["device_idle_share"],
                    "device_busy_ms": breakdown["device_busy_ms"],
                    "peak_gb": peak}, scope, data[0]


def l_rows_alike(np, a, b, n_a, n_b):
    """Whether two images' detection rows agree: counts and labels
    exactly, scores and boxes within rtol 1e-5."""
    return (n_a == n_b and np.array_equal(a[:, 0], b[:, 0])
            and np.allclose(a[:, 1:], b[:, 1:], rtol=1e-5, atol=1e-6))


def l_iou(np, a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / max(union, 1e-10)


def l_near_tie(np, mine, theirs, thr):
    """The first row where two detection lists differ, and whether it
    sits at a near-tie: the two rows' scores within ``L_TIE`` of the top
    score (the order of equal scores), or a box that one list keeps at
    an IoU within ``L_TIE`` of ``thr`` from an earlier box of its class
    in the other (its suppression). Returns (row, gap, tie)."""
    r = next((i for i in range(len(mine))
              if mine[i, 0] != theirs[i, 0]
              or not np.allclose(mine[i, 1:], theirs[i, 1:], rtol=1e-5,
                                 atol=1e-6)), None)
    if r is None:
        return None, 0.0, True
    top = max(abs(float(mine[0, 1])), abs(float(theirs[0, 1])), 1e-30)
    gap = abs(float(mine[r, 1]) - float(theirs[r, 1]))
    if gap <= L_TIE * top:
        return r, gap, True
    for row, other in ((mine[r], theirs), (theirs[r], mine)):
        for k in range(r):
            if other[k, 0] == row[0] and row[0] >= 0:
                d = abs(l_iou(np, row[2:], other[k, 2:]) - thr)
                if d <= L_TIE:
                    return r, d, True
    return r, gap, False


def l_map(np, fluid, place, dets, batch):
    """``evaluator.DetectionMAP`` over each image's rows on ``place``:
    (its eval, the per-image mAPs)."""
    main, startup = fluid.Program(), fluid.Program()
    K_, G = dets.shape[1], batch["gt_box"].shape[1]
    with fluid.program_guard(main, startup):
        det = fluid.layers.data("det", [K_, 6], append_batch_size=False)
        lab = fluid.layers.data("lab", [G, 1], append_batch_size=False)
        box = fluid.layers.data("box", [G, 4], append_batch_size=False)
        ev = fluid.evaluator.DetectionMAP(det, lab, box,
                                          class_num=L_CLASSES)
    scope, maps = fluid.Scope(), []
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place)
        exe.run(startup)
        for i in range(dets.shape[0]):
            (v,) = exe.run(main, feed={
                "det": dets[i],
                "lab": batch["gt_label"][i][:, None].astype(np.float32),
                "box": batch["gt_box"][i]}, fetch_list=[ev.cur_map])
            maps.append(float(np.asarray(v).reshape(-1)[0]))
        return float(ev.eval(exe)), maps


def l2_detect(torch, np, seed, card, scope, seen):
    """l2: the for_test clone's detections at batch 8 on the card against
    the CPU on 2 of the images, DetectionMAP on both; the NMS's
    iterations and a batch's decode + NMS ms. The images are the first
    8 of a batch l1 (b) trained on (``seen``): after 10 steps the model
    finds boxes there, and on fresh images it finds none."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.ssd import detection_output
    from paddle_tpu_torch.ops.detection import multiclass_nms_rows

    # the trained state through a clone of the model built without its
    # optimizer (a clone of the training Program would step Adam)
    main, _, _, fetches = l_ssd(fluid)
    infer = main.clone(for_test=True)
    batch = {k: v[:L_DET_BATCH] for k, v in seen.items()}
    ops = {op.type: op for op in infer.global_block().ops}
    nms_op, loss_op, coder = (ops["multiclass_nms"], ops["ssd_loss_dense"],
                              ops["box_coder"])
    fetch = [fetches["detections"], fetches["det_nums"],
             loss_op.input("Loc")[0], loss_op.input("Conf")[0],
             coder.input("PriorBox")[0], coder.input("PriorBoxVar")[0]]
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    out = gpu.run(infer, feed=batch, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    dets, nums = np.asarray(out[0]), np.asarray(out[1])
    loc, conf, prior, pvar = (np.asarray(v) for v in out[2:])
    # the CPU on the first images, from the card's trained state
    cpu_scope = fluid.Scope()
    cpu = fluid.Executor(fluid.CPUPlace())
    state = {v.name: scope.get_numpy(v.name) for v in infer.list_vars()
             if v.persistable and not v.is_data}
    load_scope_arrays(cpu_scope, state, infer, "cpu")
    small = {k: v[:L_DET_CPU] for k, v in batch.items()}
    t = time.perf_counter()
    cdets, cnums = (np.asarray(v) for v in cpu.run(
        infer, feed=small, fetch_list=fetch[:2], scope=cpu_scope))
    cpu_s = time.perf_counter() - t
    alike, ties = [], []
    for i in range(L_DET_CPU):
        ok = l_rows_alike(np, dets[i], cdets[i], int(nums[i]), int(cnums[i]))
        alike.append(ok)
        if not ok:
            r, gap, tie = l_near_tie(np, dets[i], cdets[i], L_NMS_IOU)
            ties.append({"image": i, "row": r, "gap": gap, "tie": tie})
            log(f"  l2: image {i} first differs at row {r}: card "
                f"{dets[i][r].tolist()}, CPU {cdets[i][r].tolist()}, gap "
                f"{gap:.3e} (near-tie: {tie})")
    # DetectionMAP on both devices over the images they share
    map_card, maps_card = l_map(np, fluid, fluid.CUDAPlace(0),
                                dets[:L_DET_CPU], small)
    map_cpu, maps_cpu = l_map(np, fluid, fluid.CPUPlace(), cdets, small)
    map_all, _ = l_map(np, fluid, fluid.CUDAPlace(0), dets, batch)
    # a batch's decode + NMS alone, timed, and the NMS's iterations
    dmain, dstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(dmain, dstart):
        v = [fluid.layers.data(n, list(a.shape), append_batch_size=False)
             for n, a in (("loc", loc), ("conf", conf), ("prior", prior),
                          ("pvar", pvar))]
        d_out, d_nums = detection_output(*v)
    d_op = next(op for op in dmain.global_block().ops
                if op.type == "multiclass_nms")
    dfeed = {"loc": loc, "conf": conf, "prior": prior, "pvar": pvar}
    dfetch = [d_out, d_nums, d_op.input("BBoxes")[0],
              d_op.input("Scores")[0]]
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = gpu.run(dmain, feed=dfeed, fetch_list=dfetch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    decode_ms = 1e3 * statistics.median(times[1:])
    stats = {}
    bx = torch.as_tensor(np.asarray(r[2]), device=DEVICE)
    sc = torch.as_tensor(np.asarray(r[3]), device=DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows, _, rnum = multiclass_nms_rows(nms_op, bx, sc, stats=stats)
    torch.cuda.synchronize()
    nms_ms = 1e3 * (time.perf_counter() - t)
    require(np.array_equal(np.asarray(r[0]), dets)
            and np.array_equal(rows.cpu().numpy(), dets),
            "l2: the decode program or the NMS alone gave other rows than "
            "the clone's")
    n_cand = int((sc[:, 1:] >= float(nms_op.attrs["score_threshold"]))
                 .sum())
    log(f"  l2 batch {L_DET_BATCH}: detections an image {nums.tolist()} "
        f"(CPU {cnums.tolist()} on the first {L_DET_CPU}); rows alike "
        f"{alike}; DetectionMAP card {map_card:.4f} / CPU {map_cpu:.4f} "
        f"({maps_card} / {maps_cpu}), all {L_DET_BATCH} images "
        f"{map_all:.4f}; decode + NMS {decode_ms:.3f} ms a batch, the NMS "
        f"alone {nms_ms:.3f} ms over {stats['nms_iterations']} iterations "
        f"({n_cand} candidates above the score threshold; JAX's loop would "
        f"run {prior.shape[0]}), the clone's forward on the CPU "
        f"{cpu_s:.1f} s [{card}]")
    require(nums.sum() > 0, "l2: no detection on the card")
    for t_ in ties:
        require(t_["tie"], f"l2: image {t_['image']}'s detections differ "
                f"at row {t_['row']} away from a near-tie (gap "
                f"{t_['gap']:.3e})")
    for i, ok in enumerate(alike):
        if ok:
            require(abs(maps_card[i] - maps_cpu[i]) <= 1e-4,
                    f"l2: image {i}'s mAP {maps_card[i]} on the card, "
                    f"{maps_cpu[i]} on the CPU")
    return {"detections_an_image": nums.tolist(), "rows_alike": alike,
            "near_ties": ties, "map_card": map_card, "map_cpu": map_cpu,
            "maps_card": maps_card, "maps_cpu": maps_cpu,
            "map_all_images": map_all, "decode_nms_ms": decode_ms,
            "nms_ms": nms_ms, "nms_iterations": stats["nms_iterations"],
            "nms_candidates": n_cand, "cpu_forward_s": cpu_s}


HOLD_RTOL, HOLD_ATOL = 1e-4, 1e-5   # a lowering on the card against the CPU


class _LOp:
    """An op for a direct lowering call: its type, attrs and ident."""

    def __init__(self, type, attrs):
        self.type, self.attrs = type, dict(attrs, op_ident=1)
        self.inputs, self.outputs = {}, {}


def l3_cases(np):
    """The differentiable detection lowerings at the CPU tests' shapes
    (tests/test_torch_detection.py): (op, inputs, attrs, grad slots)."""
    rng = np.random.RandomState(3)

    def f(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    def u(*s):
        return rng.rand(*s).astype(np.float32)

    rois = np.array([[0, 0, 5, 5], [1, 2, 7, 6], [2.5, 1, 4, 7.5]],
                    np.float32)
    two_one = np.array([2, 1], np.int32)
    xy = rng.rand(24, 2) * 0.7
    prior = np.concatenate([xy, xy + rng.rand(24, 2) * 0.3 + 0.05],
                           1).astype(np.float32)
    return [
        ("roi_align", {"X": f(2, 3, 8, 8), "ROIs": rois, "RoisNum": two_one},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
         ("X",)),
        ("roi_pool", {"X": np.concatenate([f(2, 2, 8, 8),
                                           np.ones((2, 1, 8, 8), np.float32)],
                                          1),
                      "ROIs": rois, "RoisNum": two_one},
         {"pooled_height": 2, "pooled_width": 2}, ("X",)),
        ("sigmoid_focal_loss", {"X": f(6, 3),
                                "Label": rng.randint(0, 4, (6, 1)).astype(
                                    np.int32),
                                "FgNum": np.array([3], np.int32)}, {},
         ("X",)),
        ("yolov3_loss", {"X": f(1, 16, 4, 4, scale=0.1),
                         "GTBox": np.array([[[0.5, 0.5, 0.3, 0.4],
                                             [0.2, 0.2, 0.1, 0.1]]],
                                           np.float32),
                         "GTLabel": np.array([[1, 2]], np.int32),
                         "GTScore": np.ones((1, 2), np.float32)},
         {"anchors": [10, 13, 16, 30], "anchor_mask": [0, 1], "class_num": 3,
          "ignore_thresh": 0.7, "downsample_ratio": 32}, ("X",)),
        ("deformable_conv", {"Input": f(2, 4, 5, 5),
                             "Offset": f(2, 36, 5, 5, scale=0.7),
                             "Mask": u(2, 18, 5, 5), "Filter": f(6, 2, 3, 3)},
         {"paddings": [1, 1], "groups": 2, "deformable_groups": 2},
         ("Input", "Offset", "Mask", "Filter")),
        ("deformable_conv_v1", {"Input": f(1, 3, 7, 6),
                                "Offset": f(1, 18, 3, 1, scale=0.6),
                                "Filter": f(4, 3, 3, 3)},
         {"strides": [2, 2], "dilations": [1, 2]},
         ("Input", "Offset", "Filter")),
        ("psroi_pool", {"X": f(2, 8, 6, 6), "ROIs": rois * 2,
                        "RoisNum": two_one},
         {"output_channels": 2, "spatial_scale": 0.5, "pooled_height": 2,
          "pooled_width": 2}, ("X",)),
        ("prroi_pool", {"X": f(2, 3, 6, 6), "ROIs": rois,
                        "BatchRoINums": np.array([1, 2], np.int32)},
         {"spatial_scale": 0.8, "pooled_height": 2, "pooled_width": 3},
         ("X",)),
        ("deformable_psroi_pooling", {"Input": f(2, 8, 6, 6), "ROIs": rois,
                                      "Trans": f(3, 2, 2, 2),
                                      "RoisNum": two_one},
         {"output_dim": 2, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 0.9, "trans_std": 0.2}, ("Input", "Trans")),
        ("ssd_loss_dense", {"Loc": f(2, 24, 4, scale=0.5), "Conf": f(2, 24, 4),
                            "GtBox": np.array(
                                [[[0.1, 0.1, 0.5, 0.6], [0.4, 0.3, 0.9, 0.8],
                                  [0, 0, 0, 0]],
                                 [[0.2, 0.5, 0.6, 0.95], [0, 0, 0, 0],
                                  [0, 0, 0, 0]]], np.float32),
                            "GtLabel": np.array([[1, 3, 0], [2, 0, 0]],
                                                np.int64),
                            "Prior": prior,
                            "PVar": np.tile(np.array([0.1, 0.1, 0.2, 0.2],
                                                     np.float32), (24, 1))},
         {"overlap_threshold": 0.3, "neg_pos_ratio": 2.0}, ("Loc", "Conf")),
    ]


def lower_op(torch, op_type, attrs, ins, dev, grads=(), seed=0, ident=1,
            per_image=False):
    """One lowering on ``dev`` over ``ins`` ({slot: [arrays or tensors]}):
    its tensor outputs and, for the ``grads`` slots, the gradients of a
    seeded weighted sum of its float outputs (weights drawn on the CPU;
    with ``per_image`` one weight array an output's image, the same for
    every image, so that an image's gradient does not depend on the
    batch it is in)."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    tins, leaves = {}, []
    for slot, arrs in ins.items():
        tins[slot] = []
        for a in arrs:
            t = torch.as_tensor(a, device=dev)
            if slot in grads and t.is_floating_point():
                t = t.clone().requires_grad_()
                leaves.append((slot, len(tins[slot]), t))
            tins[slot].append(t)
    op = _LOp(op_type, attrs)
    op.attrs["op_ident"] = ident
    with torch.enable_grad():
        outs = get_op_def(op_type).lower(LoweringContext(dev, seed=seed), op,
                                         tins)
        flat = [(s, k, v) for s, vs in sorted(outs.items())
                for k, v in enumerate(vs) if isinstance(v, torch.Tensor)]
        res = {f"{s}_{k}": v.detach().cpu() for s, k, v in flat}
        if leaves:
            g = torch.Generator().manual_seed(seed)
            terms = [(v * torch.randn(v.shape[1:] if per_image else v.shape,
                                      generator=g).to(
                device=dev, dtype=v.dtype)).sum()
                for _, _, v in flat if v.is_floating_point()
                and v.requires_grad]
            gs = torch.autograd.grad(sum(terms), [t for *_, t in leaves],
                                     allow_unused=True)
            for (slot, k, t), gr in zip(leaves, gs):
                res[f"{slot}@GRAD_{k}"] = (gr if gr is not None
                                           else torch.zeros_like(t)).cpu()
    return res


def hold_to_cpu(torch, what, got, want, exact=False):
    """Card against CPU: integer and bool outputs and (``exact``) every
    forward output bit for bit, the rest within HOLD_RTOL / HOLD_ATOL.
    Returns the largest float error."""
    require(sorted(got) == sorted(want), f"{what}: outputs {sorted(got)} "
            f"on the card, {sorted(want)} on the CPU")
    worst = 0.0
    for k in want:
        a, b = got[k], want[k]
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{what} {k}: {a.dtype}{tuple(a.shape)} on the card, "
                f"{b.dtype}{tuple(b.shape)} on the CPU")
        if not b.is_floating_point() or (exact and "@GRAD" not in k):
            require(torch.equal(a, b), f"{what} {k}: differs from the CPU")
            continue
        fin = torch.isfinite(b)
        require(torch.equal(fin, torch.isfinite(a)),
                f"{what} {k}: non-finite values differ")
        a, b = a.double()[fin], b.double()[fin]
        if a.numel() == 0:
            continue
        err = (a - b).abs()
        bad = err > HOLD_ATOL + HOLD_RTOL * b.abs()
        require(not bool(bad.any()), f"{what} {k}: {int(bad.sum())} values "
                f"outside rtol {HOLD_RTOL} / atol {HOLD_ATOL}; max_abs_err "
                f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst


def l3_ops(torch, np, card):
    """l3: the differentiable lowerings card against CPU, and the
    proposal chain at Faster R-CNN's RPN size."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def
    from paddle_tpu_torch.ops.detection import generate_proposals

    worst = {}
    for op_type, ins, attrs, grads in l3_cases(np):
        ins = {s: [a] for s, a in ins.items()}
        worst[op_type] = hold_to_cpu(
            torch, f"l3 {op_type}",
            lower_op(torch, op_type, attrs, ins, DEVICE, grads),
            lower_op(torch, op_type, attrs, ins, "cpu", grads))
    log(f"  l3: the 10 differentiable detection lowerings, forward and "
        f"backward card vs CPU, max abs error {worst}")

    cfg = L_RPN
    rng = np.random.RandomState(5)
    N, Cf, H, W = cfg["feat"]
    A = len(cfg["sizes"]) * len(cfg["ratios"])
    feat = rng.randn(N, Cf, H, W).astype(np.float32)
    scores = rng.rand(N, A, H, W).astype(np.float32)
    deltas = (rng.randn(N, 4 * A, H, W) * 0.1).astype(np.float32)
    im_info = np.array([cfg["im_info"]], np.float32)
    ag_attrs = {"anchor_sizes": cfg["sizes"], "aspect_ratios": cfg["ratios"],
                "stride": [cfg["stride"]] * 2}
    gp_attrs = {"pre_nms_topN": cfg["pre"], "post_nms_topN": cfg["post"],
                "nms_thresh": cfg["nms"], "min_size": 0.1}
    ra_attrs = {"pooled_height": cfg["pooled"], "pooled_width": cfg["pooled"],
                "spatial_scale": 1.0 / cfg["stride"]}
    res, ms, stats = {}, {}, {}
    for where, dev in (("cpu", "cpu"), ("card", DEVICE)):
        on_card = where == "card"

        def timed(name, fn):
            torch.cuda.synchronize() if on_card else None
            t = time.perf_counter()
            out = fn()
            if on_card:
                torch.cuda.synchronize()
                ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t)
            return out

        ctx = LoweringContext(dev)
        tfeat = torch.as_tensor(feat, device=dev)
        # on the card twice: the second pass is timed (its first builds
        # and warms up) and the first counts the NMS's iterations
        for rep in range(2 if on_card else 1):
            ms.clear()
            anc = timed("anchor_generator", lambda: get_op_def(
                "anchor_generator").lower(ctx, _LOp("anchor_generator",
                                                    ag_attrs),
                                          {"Input": [tfeat]}))
            props = timed("generate_proposals", lambda: generate_proposals(
                _LOp("generate_proposals", gp_attrs),
                {"Scores": [torch.as_tensor(scores, device=dev)],
                 "BboxDeltas": [torch.as_tensor(deltas, device=dev)],
                 "ImInfo": [torch.as_tensor(im_info, device=dev)],
                 "Anchors": anc["Anchors"], "Variances": anc["Variances"]},
                stats=stats if on_card and not rep else {}))
            rois = props["RpnRois"][0][0]
            res[where] = {"rois": rois.cpu().numpy(),
                          "probs": props["RpnRoiProbs"][0][0, :, 0].cpu()
                          .numpy(), "num": int(props["RpnRoisNum"][0][0])}
        if on_card:
            # roi_align over the card's rois, timed warm
            for _ in range(2):
                ms.pop("roi_align", None)
                pooled = timed("roi_align", lambda: get_op_def(
                    "roi_align").lower(ctx, _LOp("roi_align", ra_attrs),
                                       {"X": [tfeat], "ROIs": [rois]})[
                    "Out"][0])
            res[where]["pooled"] = pooled.cpu()
    t = time.perf_counter()
    cpu_pooled = get_op_def("roi_align").lower(
        LoweringContext("cpu"), _LOp("roi_align", ra_attrs),
        {"X": [torch.as_tensor(feat)],
         "ROIs": [torch.as_tensor(res["card"]["rois"])]})["Out"][0]
    cpu_align_s = time.perf_counter() - t
    a, b = res["cpu"], res["card"]
    same = (a["num"] == b["num"]
            and np.allclose(b["rois"], a["rois"], rtol=1e-5, atol=1e-4)
            and np.allclose(b["probs"], a["probs"], rtol=1e-6))
    tie = None
    if not same:
        mine = np.concatenate([b["probs"][:, None], b["rois"]], 1)
        theirs = np.concatenate([a["probs"][:, None], a["rois"]], 1)
        r = next(i for i in range(len(mine))
                 if not np.allclose(mine[i], theirs[i], rtol=1e-5, atol=1e-4))
        top = float(a["probs"][0])
        gap = abs(float(mine[r, 0]) - float(theirs[r, 0]))
        off = lambda p, q: l_iou(np, p + np.array([0, 0, 1, 1]),   # noqa: E731
                                 q + np.array([0, 0, 1, 1]))
        near_iou = min((abs(off(row[1:], other[k, 1:]) - cfg["nms"])
                        for row, other in ((mine[r], theirs),
                                           (theirs[r], mine))
                        for k in range(r)), default=1.0)
        tie = {"row": r, "score_gap": gap, "iou_gap": near_iou,
               "tie": gap <= L_TIE * top or near_iou <= L_TIE}
        log(f"  l3: the proposals first differ at row {r}: card "
            f"{mine[r].tolist()}, CPU {theirs[r].tolist()} ({tie})")
    # float32 rounds a sample's coordinate (about 4e-6 at 50 pixels) and
    # the randn map's slope reaches 6 a pixel, so a pooled value moves by
    # 2e-5 where it may be near 0: the features are held relative to the
    # map's scale, and the card's float32 error against a float64 CPU
    # run must be the CPU float32's own
    scale = float(cpu_pooled.abs().max())
    diff = float((b["pooled"].double() - cpu_pooled.double()).abs().max())
    n64 = min(100, b["num"])
    ref64 = get_op_def("roi_align").lower(
        LoweringContext("cpu"), _LOp("roi_align", ra_attrs),
        {"X": [torch.as_tensor(feat).double()],
         "ROIs": [torch.as_tensor(res["card"]["rois"][:n64]).double()]})[
        "Out"][0]
    err_card = float((b["pooled"][:n64].double() - ref64).abs().max())
    err_cpu = float((cpu_pooled[:n64].double() - ref64).abs().max())
    log(f"  l3 proposal chain: anchor_generator over {list(cfg['feat'])} at "
        f"stride {cfg['stride']:.0f}, {A} anchors a cell ({A * H * W}); "
        f"generate_proposals pre {cfg['pre']} / post {cfg['post']} / NMS "
        f"{cfg['nms']}: {b['num']} rois (CPU {a['num']}), equal {same}, "
        f"{stats.get('nms_iterations')} NMS iterations; roi_align "
        f"{cfg['pooled']}x{cfg['pooled']} over the map: card vs CPU "
        f"{diff:.3e} of a scale {scale:.3f}, against float64 on {n64} rois "
        f"card {err_card:.3e} / CPU {err_cpu:.3e} (CPU {cpu_align_s:.1f} s);"
        f" ms on the card "
        f"{ {k: round(v, 3) for k, v in ms.items()} } [{card}]")
    require(same or tie["tie"], f"l3: the proposals differ away from a "
            f"near-tie: {tie}")
    require(diff <= 1e-4 * scale, f"l3: roi_align card vs CPU {diff:.3e} "
            f"> 1e-4 of the features' scale {scale:.3f}")
    require(err_card <= 2 * err_cpu + 1e-7, f"l3: roi_align on the card "
            f"{err_card:.3e} from float64, the CPU {err_cpu:.3e}")
    return {"max_abs_err": worst, "rois": b["num"], "rois_equal": same,
            "near_tie": tie, "nms_iterations": stats.get("nms_iterations"),
            "ms": ms, "roi_align_max_abs_diff": diff,
            "roi_align_scale": scale, "roi_align_err64_card": err_card,
            "roi_align_err64_cpu": err_cpu, "cpu_roi_align_s": cpu_align_s}


def phase_l(torch, np, seed, card, out_dir):
    """Phase l: detection. Returns (paths, record)."""
    t = time.perf_counter()
    gate, init = l1_gate(torch, np, seed, card)
    counts, rec1, scope, seen = l1_train(torch, np, seed, card, out_dir,
                                         init)
    rec = {"l1": dict(rec1, gate=gate),
           "l2": l2_detect(torch, np, seed, card, scope, seen)}
    del scope
    torch.cuda.empty_cache()
    rec["l3"] = l3_ops(torch, np, card)
    rec["seconds"] = time.perf_counter() - t
    log(f"  phase l took {rec['seconds']:.1f} s")
    return {"ssd_train": counts}, rec


# -- phase m: the rest of the layer surface --------------------------------------

M_INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes",
                        "m1_inputs.npz")
# data movement and selection: the card's forward outputs equal the CPU's
M_EXACT = {"reshape", "transpose", "tile", "top_k_v2", "pad2d", "reverse",
           "crop", "crop_tensor", "multiplex", "partial_concat", "diag",
           "eye", "fill", "fill_any_like", "pad_constant_like", "squeeze",
           "unsqueeze", "maxout", "pool_with_index", "pixel_shuffle",
           "space_to_depth", "temporal_shift", "unfold", "shuffle_channel",
           "nearest_interp", "interp_nearest", "similarity_focus",
           "filter_by_instag", "expand_pred_like", "logical_print_stub",
           "print", "brelu", "fill_zeros_like2"}
M_LR, M_BETA1 = 2e-4, 0.5           # CycleGAN's Adam
M_NGF, M_BLOCKS = 64, 9             # c7s1-64, d128, d256, 9 x R256, u128,
                                    # u64, c7s1-3
M_GATE_SIZE, M_GATE_STEPS = 128, 2
M_RUN_SIZE, M_RUN_STEPS = 256, 10


def m_generator(fluid, size, batch=1, ngf=M_NGF, n_blocks=M_BLOCKS,
                lr=M_LR, act="relu"):
    """CycleGAN's ResNet generator (Zhu et al. 2017, appendix) as a Program
    of layers both packages export: c7s1-ngf (reflection pad 3, 7 x 7
    convolution, instance norm, relu), two stride-2 3 x 3 downsamplings,
    ``n_blocks`` residual blocks of two reflection-padded 3 x 3
    convolutions, two stride-2 3 x 3 transposed convolutions to twice the
    size, c7s1-3 and tanh; an L1 loss to a target image, Adam(lr, beta1
    0.5). A convolution an instance norm follows has no bias (the norm
    takes out any constant; its gradient would be rounding noise, which
    Adam scales to a full step). ``act`` names the activation layer
    (relu, as published; m2 (a)'s smooth twin takes tanh). Returns (main,
    startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        shape = [batch, 3, size, size]
        x = L.data("image", shape, append_batch_size=False)
        target = L.data("target", shape, append_batch_size=False)

        activation = getattr(L, act)

        def block(h, nf, k, stride, pad, reflect, relu=True):
            if reflect:
                h = L.pad2d(h, [pad] * 4, mode="reflect")
            h = L.conv2d(h, nf, k, stride=stride,
                         padding=0 if reflect else pad, bias_attr=False)
            h = L.instance_norm(h)
            return activation(h) if relu else h

        h = block(x, ngf, 7, 1, 3, True)
        h = block(h, ngf * 2, 3, 2, 1, False)
        h = block(h, ngf * 4, 3, 2, 1, False)
        for _ in range(n_blocks):
            r = block(h, ngf * 4, 3, 1, 1, True)
            h = L.elementwise_add(h, block(r, ngf * 4, 3, 1, 1, True,
                                           relu=False))
        for nf in (ngf * 2, ngf):
            up = 2 * int(h.shape[2])
            h = L.conv2d_transpose(h, nf, output_size=[up, up], filter_size=3,
                                   stride=2, padding=1, bias_attr=False)
            h = activation(L.instance_norm(h))
        h = L.pad2d(h, [3] * 4, mode="reflect")
        out = L.tanh(L.conv2d(h, 3, 7))
        loss = L.reduce_mean(L.abs(L.elementwise_sub(out, target)))
        fluid.optimizer.AdamOptimizer(lr, beta1=M_BETA1).minimize(loss)
    return main, startup, loss


def m_images(np, seed, n, size, batch=1):
    """``n`` (image, target) feeds: a seeded image in [-1, 1] and its
    target, a smooth seeded pattern in [-0.9, 0.9]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    feeds = []
    for _ in range(n):
        img = rng.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32)
        f = rng.uniform(1, 4, (batch, 3, 1, 1))
        ph = rng.uniform(0, np.pi, (batch, 3, 1, 1))
        tgt = 0.9 * np.sin(f * np.pi * (xx + yy)[None, None] + ph)
        feeds.append({"image": img, "target": tgt.astype(np.float32)})
    return feeds


def m_cases(np):
    """{case: (op, {slot: [arrays]}, attrs, grad slots)} of
    ``probes/m1_inputs.npz``: the sweep rows and the twins' cases
    (tests/test_torch_m1_inputs.py writes it)."""
    require(os.path.exists(M_INPUTS), f"m1: {M_INPUTS} is missing")
    out = {}
    with np.load(M_INPUTS) as z:
        for case, c in json.loads(str(z["__cases__"])).items():
            ins = {s: [z[f"{case}/{s}/{i}"] for i in range(n)]
                   for s, n in c["inputs"].items()}
            out[case] = (c["op"], ins, c["attrs"], c["grads"])
    return out


def m1_lowerings(torch, np, seed):
    """m1: every lowering of the slice on the card against the CPU."""
    cases = m_cases(np)
    worst, ops = {}, set()
    for case, (op, ins, attrs, grads) in sorted(cases.items()):
        got = lower_op(torch, op, attrs, ins, DEVICE, grads, seed)
        want = lower_op(torch, op, attrs, ins, "cpu", grads, seed)
        worst[case] = hold_to_cpu(torch, f"m1 {case}", got, want,
                             exact=op in M_EXACT)
        ops.add(op)
    torch.cuda.synchronize()
    rec = {"cases": len(cases), "ops": len(ops),
           "max_abs_err": max(worst.values()),
           "worst_case": max(worst, key=worst.get)}
    rec["random"] = m1_random(torch, np, seed)
    rec["stateful"] = m1_stateful(torch, np, seed)
    rec["host"] = m1_host(torch, np, seed)
    log(f"  m1: {len(cases)} cases over {len(ops)} lowerings card against "
        f"CPU (rtol {HOLD_RTOL} / atol {HOLD_ATOL}, integer and data-movement "
        f"outputs exact): max_abs_err {rec['max_abs_err']:.3e} "
        f"({rec['worst_case']})")
    return rec


def m1_random(torch, np, seed):
    """The random lowerings on the card, by their statistics and their
    own draws."""
    rng = np.random.RandomState(seed)
    out = {}

    def run(op, ins, attrs, ident):
        return lower_op(torch, op, attrs, ins, DEVICE, seed=seed, ident=ident)

    x = rng.randn(64, 5).astype(np.float32)
    r = run("shuffle_batch", {"X": [x]}, {}, 11)
    perm = r["ShuffleIdx_0"].numpy()
    require(sorted(perm.tolist()) == list(range(64))
            and np.array_equal(r["Out_0"].numpy(), x[perm]),
            "m1 shuffle_batch: the rows are not a permutation of X")
    x = np.arange(2 * 3 * 9 * 8, dtype=np.float32).reshape(2, 3, 9, 8)
    c = run("random_crop", {"X": [x]}, {"shape": [4, 5]}, 12)["Out_0"]
    require(any(np.array_equal(c.numpy(), x[:, :, i:i + 4, j:j + 5])
                for i in range(6) for j in range(4)),
            "m1 random_crop: the output is not a window of X")
    r = run("randint", {}, {"shape": [100, 50], "low": 2, "high": 7},
            13)["Out_0"].numpy()
    require(r.min() >= 2 and r.max() < 7 and len(np.unique(r)) == 5,
            "m1 randint: values outside [2, 7) or missing")
    t = run("truncated_gaussian_random", {}, {"shape": [400, 250]},
            14)["Out_0"].numpy()
    out["truncated_std"] = float(t.std())
    require(np.abs(t).max() <= 2.0 and abs(t.mean()) < 0.02
            and abs(t.std() - 0.8796) < 0.02,
            f"m1 truncated_gaussian_random: max {np.abs(t).max():.3f}, "
            f"mean {t.mean():.4f}, std {t.std():.4f} (0.8796 at +-2)")
    u = run("uniform_random_batch_size_like",
            {"Input": [rng.randn(50, 2).astype(np.float32)]},
            {"shape": [1, 400], "min": -1.0, "max": 1.0}, 15)["Out_0"].numpy()
    g = run("gaussian_random_batch_size_like",
            {"Input": [rng.randn(64, 3).astype(np.float32)]},
            {"shape": [0, 512], "mean": 1.0, "std": 2.0}, 16)["Out_0"].numpy()
    require(u.shape == (50, 400) and u.min() >= -1 and u.max() <= 1
            and abs(u.mean()) < 0.05 and g.shape == (64, 512)
            and abs(g.mean() - 1) < 0.05 and abs(g.std() - 2) < 0.05,
            "m1 *_batch_size_like: shape or moments off")
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    ids = run("sampling_id", {"X": [np.tile(p, (20000, 1))]}, {},
              17)["Out_0"].numpy()
    freq = np.bincount(ids, minlength=4) / 20000.0
    require(np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / 20000)
                   + 1e-9) and freq[1] == 0,
            f"m1 sampling_id: frequencies {freq} for {p}")
    out["sampling_id_freq"] = freq.tolist()
    logits = rng.randn(6, 12).astype(np.float32)
    labels = rng.randint(0, 12, (6, 2)).astype(np.int64)
    r = run("sample_logits", {"Logits": [logits], "Labels": [labels]},
            {"num_samples": 5}, 18)
    samples = r["Samples_0"].numpy()
    want = np.take_along_axis(logits, samples, 1)
    hit = (samples[:, None, 2:] == labels[:, :, None]).any(1)
    want[:, 2:][hit] = -1e20
    require(np.array_equal(samples[:, :2], labels)
            and np.array_equal(r["SampledLogits_0"].numpy(), want),
            "m1 sample_logits: not recomputed from its own samples")
    return out


def m1_stateful(torch, np, seed):
    """The stateful lowerings over 3 calls, each device carrying its own
    state: every call card against CPU."""
    rng = np.random.RandomState(seed + 1)
    specs = {
        "auc": ({"StatPos": np.zeros((1, 4096), np.float32),
                 "StatNeg": np.zeros((1, 4096), np.float32)},
                lambda: {"Predict": rng.rand(500, 2).astype(np.float32),
                         "Label": rng.randint(0, 2, (500, 1))},
                {"num_thresholds": 4095},
                {"StatPosOut": "StatPos", "StatNegOut": "StatNeg"}),
        "precision_recall": (
            {"StatesInfo": np.zeros((5, 4), np.float32)},
            lambda: {"MaxProbs": rng.rand(40, 1).astype(np.float32),
                     "Indices": rng.randint(0, 5, (40, 1)),
                     "Labels": rng.randint(0, 5, (40, 1)),
                     "Weights": np.ones((40, 1), np.float32)},
            {"class_number": 5}, {"AccumStatesInfo": "StatesInfo"}),
        "mean_iou": ({"InWrongs": np.zeros(6, np.float32),
                      "InCorrects": np.zeros(6, np.float32)},
                     lambda: {"Predictions": rng.randint(0, 6, 64),
                              "Labels": rng.randint(0, 6, 64)},
                     {"num_classes": 6},
                     {"OutWrong": "InWrongs", "OutCorrect": "InCorrects"}),
        "center_loss": ({"Centers": rng.randn(4, 8).astype(np.float32)},
                        lambda: {"X": rng.randn(16, 8).astype(np.float32),
                                 "Label": rng.randint(0, 4, (16, 1)),
                                 "CenterUpdateRate": np.full(1, 0.5,
                                                             np.float32)},
                        {"need_update": True}, {"CentersOut": "Centers"}),
        "average_accumulates": (
            {"in_sum_1": np.zeros(64, np.float32),
             "in_sum_2": np.zeros(64, np.float32),
             "in_sum_3": np.zeros(64, np.float32),
             "in_num_accumulates": np.zeros(1, np.int64),
             "in_old_num_accumulates": np.zeros(1, np.int64),
             "in_num_updates": np.zeros(1, np.int64)},
            lambda: {"param": rng.randn(64).astype(np.float32)},
            {"average_window": 1.0, "max_average_window": 2,
             "min_average_window": 1},
            {f"out_{s}": f"in_{s}" for s in (
                "sum_1", "sum_2", "sum_3", "num_accumulates",
                "old_num_accumulates", "num_updates")}),
    }
    worst = {}
    for op, (state0, feed, attrs, carry) in specs.items():
        state = {d: dict(state0) for d in (DEVICE, "cpu")}
        worst[op] = 0.0
        for call in range(3):
            f = feed()
            res = {}
            for dev in (DEVICE, "cpu"):
                ins = {s: [np.asarray(v)] for s, v in dict(f, **state[dev])
                       .items()}
                res[dev] = lower_op(torch, op, attrs, ins, dev, seed=seed)
                for o, i in carry.items():
                    state[dev][i] = res[dev][f"{o}_0"].numpy()
            worst[op] = max(worst[op], hold_to_cpu(
                torch, f"m1 {op} call {call + 1}", res[DEVICE], res["cpu"]))
    return worst


def m1_host(torch, np, seed):
    """``py_func`` (forward and its backward_func), ``Print`` and the
    in-Program ``save`` / ``load`` / ``save_combine`` / ``load_combine``
    run by the card's Executor."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(seed + 2)
    xv = rng.randn(4, 3).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        x = L.data("x", [4, 3], append_batch_size=False, stop_gradient=False)
        out = main.global_block().create_var(name="pf_out", shape=(4, 3),
                                             dtype="float32",
                                             stop_gradient=False)
        L.py_func(lambda a: np.tanh(a) * 2.0, x, out,
                  backward_func=lambda a, g: 2.0 * (1 - np.tanh(a) ** 2) * g)
        shown = L.Print(out, message="m1 Print of the py_func output:")
        loss = L.reduce_sum(shown)
        gx, = fluid.gradients(loss, [x])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    y, g = exe.run(main, feed={"x": xv}, fetch_list=[out, gx],
                   scope=fluid.Scope())
    require(np.allclose(y, np.tanh(xv) * 2, rtol=1e-6, atol=1e-6)
            and np.allclose(g, 2 * (1 - np.tanh(xv) ** 2), rtol=1e-6,
                            atol=1e-6), "m1 py_func: forward or backward off")
    d = tempfile.mkdtemp(prefix="m1_persist_")
    try:
        a = rng.randn(3, 5).astype(np.float32)
        b = rng.randint(0, 9, (7,)).astype(np.int64)
        main = fluid.Program()
        with fluid.program_guard(main):
            blk = main.global_block()
            av = blk.create_var(name="a", shape=(3, 5), dtype="float32",
                                is_data=True)
            bv = blk.create_var(name="b", shape=(7,), dtype="int64",
                                is_data=True)
            blk.append_op(type="save", inputs={"X": [av]}, outputs={},
                          attrs={"file_path": os.path.join(d, "a")})
            blk.append_op(type="save_combine", inputs={"X": [av, bv]},
                          outputs={}, attrs={"file_path": os.path.join(
                              d, "ab")})
        exe.run(main, feed={"a": a, "b": b}, fetch_list=[])
        main = fluid.Program()
        with fluid.program_guard(main):
            blk = main.global_block()
            r1 = blk.create_var(name="r1")
            blk.append_op(type="load", inputs={}, outputs={"Out": [r1]},
                          attrs={"file_path": os.path.join(d, "a"),
                                 "shape": [3, 5], "dtype": "float32"})
            ra, rb = blk.create_var(name="a"), blk.create_var(name="b")
            blk.append_op(type="load_combine", inputs={},
                          outputs={"Out": [ra, rb]},
                          attrs={"file_path": os.path.join(d, "ab"),
                                 "shape": [[3, 5], [7]],
                                 "dtype": ["float32", "int64"]})
        got = exe.run(main, feed={}, fetch_list=[r1, ra, rb])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    require(np.array_equal(got[0], a) and np.array_equal(got[1], a)
            and np.array_equal(got[2], b) and got[2].dtype == np.int64,
            "m1 save / load: the round trip changed the values")
    return {"py_func": True, "persist": True}


def m2_pair(torch, np, seed, act, perturb=False):
    """The generator at 128 x 128 (activation ``act``), 2 Adam steps from
    the CPU startup's values on the card and on the CPU, and with
    ``perturb`` a second CPU run from those values times (1 + 1e-7 x a
    seeded normal): the CPU against itself at float32 rounding. Returns
    (record, startup values)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    main, startup, loss = m_generator(fluid, M_GATE_SIZE, act=act)
    main.random_seed = startup.random_seed = seed
    params = main.all_parameters()
    n_adam = [op.type for op in main.global_block().ops].count("fused_adam")
    require(n_adam == len(params), f"m2: {n_adam} fused_adam ops for "
            f"{len(params)} parameters")
    cpu = fluid.Executor(fluid.CPUPlace())
    scopes = {"cpu": fluid.Scope()}
    cpu.run(startup, scope=scopes["cpu"])
    init = {v.name: np.array(scopes["cpu"].get_numpy(v.name))
            for v in main.list_vars() if v.persistable and not v.is_data}
    gpu = fluid.Executor(fluid.CUDAPlace(0))
    scopes["cuda"] = fluid.Scope()
    gpu.run(startup, scope=scopes["cuda"])
    load_scope_arrays(scopes["cuda"], init, main, DEVICE)
    runs = [("cuda", gpu), ("cpu", cpu)]
    if perturb:
        rng = np.random.RandomState(seed)
        names = {p.name for p in params}
        scopes["cpu_perturbed"] = fluid.Scope()
        cpu.run(startup, scope=scopes["cpu_perturbed"])
        load_scope_arrays(scopes["cpu_perturbed"], {
            n: (v * (1 + 1e-7 * rng.randn(*v.shape))).astype(v.dtype)
            if n in names else v for n, v in init.items()}, main, "cpu")
        runs.append(("cpu_perturbed", cpu))
    feeds = m_images(np, seed, M_GATE_STEPS, M_GATE_SIZE)
    losses, secs = {}, {}
    for name, exe in runs:
        K.reset_launch_counts()
        t = time.perf_counter()
        losses[name] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scopes[name])[0])
            .reshape(-1)[0]) for f in feeds]
        secs[name] = time.perf_counter() - t
        if name == "cuda":
            counts = K.launch_counts()

    def gaps(a, b):
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b]))
        worst = max((float(np.abs(scopes[a].get_numpy(p.name)
                                  - scopes[b].get_numpy(p.name)).max()),
                     p.name) for p in params)
        return rel, worst, j_moment_gap(main, scopes[a], scopes[b])

    rel, (worst, worst_name), (m1, m1_name) = gaps("cuda", "cpu")
    rec = {"losses": losses, "loss_rel_err": rel, "param_max_abs_err": worst,
           "param_limit": 2 * M_LR * M_GATE_STEPS, "moment_rel_l2": m1,
           "moment_worst": m1_name, "n_parameters": len(params),
           "n_values": sum(int(np.prod(p.shape)) for p in params),
           "launches": {k: v for k, v in counts.items() if v},
           "card_s": secs["cuda"], "cpu_s": secs["cpu"]}
    msg = (f"  m2 (a) {act}, {M_GATE_SIZE}^2, {M_GATE_STEPS} steps: card "
           f"{losses['cuda']} ({secs['cuda']:.1f} s), CPU {losses['cpu']} "
           f"({secs['cpu']:.1f} s); losses within {rel:.3e}, parameters "
           f"{worst:.3e} ({worst_name}), first moments {m1:.3e} ({m1_name},"
           f" relative L2)")
    if perturb:
        prel, (pworst, _), (pm1, pm1_name) = gaps("cpu_perturbed", "cpu")
        rec["cpu_perturbed"] = {"loss_rel_err": prel,
                                "param_max_abs_err": pworst,
                                "moment_rel_l2": pm1, "moment_worst": pm1_name}
        msg += (f"; the CPU against itself from a start 1e-7 off: losses "
                f"{prel:.3e}, parameters {pworst:.3e}, first moments "
                f"{pm1:.3e} ({pm1_name})")
    log(msg + f"; launches {rec['launches']}")
    j_require_launches(counts, {"fused_adam_update": n_adam * M_GATE_STEPS},
                       f"m2 (a) {act}")
    require(rel <= 1e-3, f"m2 (a) {act}: card vs CPU losses differ by "
            f"{rel:.3e}")
    require(worst <= rec["param_limit"], f"m2 (a) {act}: parameter "
            f"{worst_name} differs by {worst:.3e} > 2 * lr * steps = "
            f"{rec['param_limit']:.1e}")
    return rec, init


def m2_gate(torch, np, seed, card):
    """m2 (a): the generator at 128 x 128, 2 Adam steps card against CPU:
    losses within rtol 1e-3, parameters within 2 lr steps, exactly one
    K10 a parameter a step. Adam's first moments within relative L2 1e-4
    are held on the smooth twin (tanh where the published network has
    relu): with relu a rounding-level change flips a few activations at
    their kink, and each flip moves a 32 x 32 map's weight gradient by
    about 1/32 of its norm, so the CPU differs from itself by 1e-3 to 1e-2
    (printed beside the card's) and no device can be held closer.
    Returns (record, the relu generator's startup values)."""
    import paddle_tpu_torch as fluid

    fluid.set_flags({"optimizer_fuse": "on"})
    rec, init = m2_pair(torch, np, seed, "relu", perturb=True)
    log(f"  m2: CycleGAN ResNet generator, ngf {M_NGF}, {M_BLOCKS} residual "
        f"blocks: {rec['n_parameters']} parameters ({rec['n_values']} "
        f"values)")
    smooth, _ = m2_pair(torch, np, seed, "tanh")
    require(smooth["moment_rel_l2"] <= 1e-4,
            f"m2 (a) tanh: first moments differ by "
            f"{smooth['moment_rel_l2']:.3e} (relative L2) > 1e-4")
    rec["smooth_twin"] = smooth
    return rec, init


def m2_train(torch, np, seed, card, out_dir, init):
    """m2 (b): 256 x 256, 10 steps over 2 cycled seeded images on the card
    from the gate's startup values (the size-free parameters)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.io import load_scope_arrays

    main, startup, loss = m_generator(fluid, M_RUN_SIZE)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    load_scope_arrays(scope, init, main, DEVICE)
    data = m_images(np, seed + 1, 2, M_RUN_SIZE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times = [], []
    for i in range(M_RUN_STEPS):
        t = time.perf_counter()
        losses.append(float(np.asarray(exe.run(
            main, feed=data[i % 2], fetch_list=[loss],
            scope=scope)[0]).reshape(-1)[0]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    snap = {v.name: scope.find_var(v.name).clone() for v in main.list_vars()
            if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}
    prof = start_profile(torch)
    t = time.perf_counter()
    exe.run(main, feed=data[0], fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof.__exit__(None, None, None)
    for n, v in snap.items():
        scope.set_var(n, v)
    breakdown = trace_breakdown(prof, out_dir, "m2b", wall, steps=1)
    step_ms = 1e3 * statistics.mean(times[1:])
    n_params = len(main.all_parameters())
    log(f"  m2 (b) {M_RUN_SIZE}^2, batch 1, {M_RUN_STEPS} steps: losses "
        f"{losses}; {step_ms:.3f} ms a step (steps 2-10; first "
        f"{1e3 * times[0]:.1f}), {1e3 / step_ms:.2f} images/s, "
        f"{breakdown['kernels']} kernels a step (profiled), device idle "
        f"{breakdown['device_idle_share']:.3f}, peak {peak:.2f} GB [{card}]")
    require(all(np.isfinite(losses)), f"m2 (b): a loss is not finite: "
            f"{losses}")
    require(np.mean(losses[-3:]) < losses[0],
            f"m2 (b): the last three losses do not fall below the first: "
            f"{losses}")
    j_require_launches(counts, {"fused_adam_update": n_params * M_RUN_STEPS},
                       "m2 (b)")
    return counts, {"losses": losses, "step_ms": step_ms,
                    "first_step_ms": 1e3 * times[0],
                    "images_s": 1e3 / step_ms,
                    "kernels_a_step": breakdown["kernels"],
                    "device_idle_share": breakdown["device_idle_share"],
                    "device_busy_ms": breakdown["device_busy_ms"],
                    "peak_gb": peak}


def m3_heavy(torch, np, seed, card):
    """m3: the heavy new lowerings at a user's sizes, card against CPU
    (forward, and the gradient of a seeded weighted sum where the op is
    differentiable; a batched op on its first image, which the others do
    not touch), timed on the card with CUDA events (median of 21)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    ids = torch.randint(0, 65536, (1 << 20,), generator=gen, device=DEVICE)
    theta = (torch.tensor([[0.9, -0.2, 0.05], [0.15, 1.1, -0.1]],
                          device=DEVICE) + 0.05 * randn(8, 2, 3))
    grid_ins = {"Theta": [theta.cpu().numpy()]}
    grid = lower_op(torch, "affine_grid", {"output_shape": [8, 64, 64, 64]},
                   grid_ins, DEVICE)["Output_0"]
    cases = [
        ("bilinear_interp", {"X": randn(8, 256, 64, 64)},
         {"out_h": 256, "out_w": 256}, ("X",), True),
        ("nearest_interp", {"X": randn(8, 256, 64, 64)},
         {"out_h": 256, "out_w": 256}, ("X",), True),
        ("affine_grid", {"Theta": theta}, {"output_shape": [8, 64, 64, 64]},
         ("Theta",), True),
        ("grid_sampler", {"X": randn(8, 64, 64, 64), "Grid": grid.to(DEVICE)},
         {}, ("X",), True),
        ("lrn", {"X": randn(32, 96, 55, 55)},
         {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, ("X",), True),
        ("pixel_shuffle", {"X": randn(8, 256, 64, 64)},
         {"upscale_factor": 2}, ("X",), True),
        ("unfold", {"X": randn(8, 64, 56, 56)},
         {"kernel_sizes": [3, 3], "paddings": [1, 1, 1, 1]}, ("X",), True),
        ("instance_norm", {"X": randn(1, 256, 64, 64),
                           "Scale": 1 + 0.1 * randn(256),
                           "Bias": 0.1 * randn(256)},
         {"epsilon": 1e-5}, ("X", "Scale", "Bias"), False),
        ("hierarchical_sigmoid",
         {"X": randn(256, 128), "W": 0.1 * randn(9999, 128),
          "Label": torch.randint(0, 10000, (256, 1), generator=gen,
                                 device=DEVICE),
          "Bias": 0.1 * randn(9999)},
         {"num_classes": 10000}, ("X", "W", "Bias"), False),
        ("unique_with_counts", {"X": ids}, {}, (), False),
        ("hash", {"X": ids[:, None]}, {"num_hash": 4, "mod_by": 1000003},
         (), False),
        ("auc", {"Predict": torch.rand(100000, 2, generator=gen,
                                       device=DEVICE),
                 "Label": torch.randint(0, 2, (100000, 1), generator=gen,
                                        device=DEVICE),
                 "StatPos": torch.zeros(1, 4096, device=DEVICE),
                 "StatNeg": torch.zeros(1, 4096, device=DEVICE)},
         {"num_thresholds": 4095}, (), False),
    ]
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    rec = {}
    for op, ins, attrs, grads, batched in cases:
        host = {s: [(t[:1] if batched else t).cpu()] for s, t in ins.items()}
        got = lower_op(torch, op, attrs, {s: [t] for s, t in ins.items()},
                      DEVICE, grads, seed, per_image=batched)
        want = lower_op(torch, op, attrs, host, "cpu", grads, seed,
                       per_image=batched)
        if batched:
            got = {k: v[:1] for k, v in got.items()}
        err = hold_to_cpu(torch, f"m3 {op}", got, want,
                     exact=op in ("nearest_interp", "pixel_shuffle",
                                  "unfold"))
        lop = _LOp(op, attrs)
        tins = {s: [t] for s, t in ins.items()}
        lower = get_op_def(op).lower
        ctx = LoweringContext(DEVICE)
        with torch.no_grad():
            ms = device_ms(torch, lambda: lower(ctx, lop, tins))
        rec[op] = {"ms": ms, "max_abs_err": err,
                   "shapes": {s: list(t.shape) for s, t in ins.items()}}
        log(f"  m3 {op} {rec[op]['shapes']}: {ms:.4f} ms on the card, card "
            f"vs CPU max_abs_err {err:.3e} [{card}]")
    return rec


def phase_m(torch, np, seed, card, out_dir):
    """Phase m: the rest of the layer surface. Returns (paths, record)."""
    t0 = time.perf_counter()
    rec = {"m1": m1_lowerings(torch, np, seed)}
    rec["m1_seconds"] = time.perf_counter() - t0
    t = time.perf_counter()
    gate, init = m2_gate(torch, np, seed, card)
    counts, rec2 = m2_train(torch, np, seed, card, out_dir, init)
    rec["m2"] = dict(rec2, gate=gate)
    rec["m2_seconds"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["m3"] = m3_heavy(torch, np, seed, card)
    rec["m3_seconds"] = time.perf_counter() - t
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase m took {rec['seconds']:.1f} s (m1 {rec['m1_seconds']:.1f},"
        f" m2 {rec['m2_seconds']:.1f}, m3 {rec['m3_seconds']:.1f})")
    return {"cyclegan_train": counts}, rec


# -- phase n: the serving Programs, the fused ops, the parameter server ---------

N_PAGES = 512                       # phase 3's pool: 512 pages of PAGE
N1_PREFILL_ROWS, N1_PREFILL_SEQ, N1_DECODE_STEPS = 8, 128, 3
N1_POOL_RTOL = 1e-5                 # of each pool's largest value
N1_TIE = 1e-3                       # top-2 gap / max|logit|: a near-tie
N4_VOCAB, N4_STEPS, N4_RTOL = 2 ** 20, 3, 1e-5
N4_GEO_STEPS, N4_GEO_PUSH = 6, 3
N4_TIMEOUT_S = 300


def _free_ports(n):
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _logits_name(prog):
    """The logits a step Program's argmax reads (through its reshape)."""
    ops = prog.global_block().ops
    src = [op for op in ops if op.type == "arg_max"][-1].inputs["X"][0]
    for op in ops:
        if op.type in ("reshape", "reshape2") and src in op.outputs.get(
                "Out", ()):
            return op.inputs["X"][0]
    return src


def _tokens_or_ties(np, got, want, logits, valid, what):
    """``got`` equals ``want`` wherever ``valid``, except at a near-tie
    of ``logits`` (the repo's rule: top-2 gap <= 1e-3 * max|logit|).
    Returns the positions that differ."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    logits = np.asarray(logits).reshape(got.shape[0], -1)
    diff = [i for i in range(got.shape[0]) if valid[i] and got[i] != want[i]]
    for i in diff:
        top = np.sort(logits[i])[::-1]
        gap, bound = top[0] - top[1], N1_TIE * np.abs(logits[i]).max()
        require(gap <= bound, f"{what}: position {i} gives {got[i]} against "
                f"{want[i]} at a top-2 gap {gap:.3e} > {bound:.3e}")
    return diff


def _pools_close(torch, got, want, what):
    """Pools within N1_POOL_RTOL of their largest value (int8 pools: one
    step), page 0 slot 0 (the invalid rows' junk slot) left out."""
    worst = 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        d[:, 0, 0] = 0
        top = float(w.float().abs().max())
        err = float(d.max())
        bound = 1.0 if w.dtype == torch.int8 else N1_POOL_RTOL * top
        require(err <= bound, f"{what}: pools differ by {err:.3e} > "
                f"{bound:.3e}")
        worst = max(worst, err / (1.0 if w.dtype == torch.int8 else top))
    return worst


def _n1_mixed_feed(torch, np, seed, cfg, kv):
    """One mixed ragged step on phase 3's prompts: two prefill chunks,
    four decode rows, a partial chunk and an idle lane, over seeded
    pools."""
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads
    maxp = cfg.max_position // PAGE
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    starts = [0, 32, int(lengths[2]), int(lengths[3]), int(lengths[4]),
              int(lengths[5]), 48, 0]
    nvalid = [CHUNK, CHUNK, 1, 1, 1, 1, 9, 0]
    rng = np.random.RandomState(seed + 11)
    free = list(rng.permutation(np.arange(1, N_PAGES)))
    tables = np.zeros((LANES, maxp), np.int32)
    tokens = np.zeros((LANES, CHUNK), np.int64)
    for b in range(LANES):
        if nvalid[b]:
            n = -(-(starts[b] + nvalid[b]) // PAGE)
            tables[b, :n] = [free.pop() for _ in range(n)]
        src = prompts[b % len(prompts)]
        for j in range(nvalid[b]):
            tokens[b, j] = src[(starts[b] + j) % len(src)]
    pos_ids = np.asarray(starts)[:, None] + np.arange(CHUNK)[None, :]
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 12)
    shape = (H, N_PAGES, PAGE, D)
    feed = {"gen_tokens": tokens, "gen_pos_ids": pos_ids,
            "gen_positions": np.asarray(starts, np.int64),
            "gen_num_valid": np.asarray(nvalid, np.int32),
            "gen_block_tables": tables}
    for i in range(L):
        for s in "kv":
            if kv == "int8":
                feed[f"gen_{s}_pages_{i}"] = torch.randint(
                    -127, 128, shape, generator=gen, device=DEVICE,
                    dtype=torch.int8)
                feed[f"gen_{s}_scales_{i}"] = 0.02 * torch.rand(
                    shape[:3], generator=gen, device=DEVICE)
            else:
                feed[f"gen_{s}_pages_{i}"] = torch.randn(
                    shape, generator=gen, device=DEVICE)
    valid = [j < nvalid[b] for b in range(LANES) for j in range(CHUNK)]
    return feed, valid


def _run_program(torch, exe, prog, feed, fetches, scope, extra=()):
    from paddle_tpu_torch import kernels as K

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = exe.run(prog, feed=feed, fetch_list=list(fetches) + list(extra),
                   scope=scope, return_numpy=False)
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t) * 1e3, K.launch_counts()


def n1_ragged(torch, np, seed, card, exe, scope, lm, cfg, kv):
    """(a) / (b): one mixed ragged step through the Program, against
    ``RaggedStepModel`` on clones of the pools."""
    from paddle_tpu_torch.generation import (CacheGeometry, RaggedStepModel,
                                             build_ragged_step_program)
    from paddle_tpu_torch.generation.model import step_feeds

    L = cfg.num_layers
    geom = CacheGeometry(N_PAGES, PAGE, cfg.max_position // PAGE)
    prog, fetches = build_ragged_step_program(cfg, geom, CHUNK, kv)
    feed, valid = _n1_mixed_feed(torch, np, seed, cfg, kv)
    kernel = "ragged_paged_attention_q" if kv == "int8" else \
        "ragged_paged_attention"
    # the fed pools before the step: the module's (in place) and the
    # proof that the Program's functional write leaves the feed alone
    pools = {k: v.clone() for k, v in feed.items() if torch.is_tensor(v)}
    exe.run(prog, feed=feed, fetch_list=fetches, scope=scope,
            return_numpy=False)                         # plan and warm up
    outs, ms, counts = _run_program(torch, exe, prog, feed, fetches, scope,
                                    [_logits_name(prog)])
    for k, v in pools.items():
        require(torch.equal(feed[k], v), f"n1 {kv}: the Program wrote the "
                f"fed {k}")
    require(counts[kernel] == L, f"n1 {kv}: {kernel} launched "
            f"{counts[kernel]} times in the step, want {L}")
    require(counts["layer_norm"] == 2 * L + 1, f"n1 {kv}: layer_norm "
            f"launched {counts['layer_norm']} times, want {2 * L + 1}")
    step = RaggedStepModel(lm, geom, CHUNK)
    kp = [pools[f"gen_k_pages_{i}"] for i in range(L)]
    vp = [pools[f"gen_v_pages_{i}"] for i in range(L)]
    sc = {}
    if kv == "int8":
        sc = dict(k_scales=[pools[f"gen_k_scales_{i}"] for i in range(L)],
                  v_scales=[pools[f"gen_v_scales_{i}"] for i in range(L)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    tok = step(*step_feeds(feed["gen_tokens"], feed["gen_pos_ids"],
                           feed["gen_positions"], feed["gen_num_valid"],
                           feed["gen_block_tables"], torch.device(DEVICE)),
               kp, vp, **sc)
    torch.cuda.synchronize()
    module_ms = (time.perf_counter() - t) * 1e3
    diff = _tokens_or_ties(np, outs[0].cpu().numpy(), tok.cpu().numpy(),
                           outs[-1].cpu().numpy(), valid, f"n1 {kv}")
    pool_err = _pools_close(torch, kp + vp, outs[1:1 + 2 * L], f"n1 {kv}")
    scale_err = [0.0, 0.0]         # the first layer's, the deeper ones'
    if kv == "int8":
        # phase 5's rule (QKV_SCALE_RTOL): a deeper layer's rows come
        # through attention over int8 pools where a value may sit a step
        # apart
        for i, (g, w) in enumerate(zip(sc["k_scales"] + sc["v_scales"],
                                       outs[1 + 2 * L:-1])):
            d = ((g - w).abs() / w.abs().clamp_min(1e-30))
            d[:, 0, 0] = 0
            deep = min(i % L, 1)
            scale_err[deep] = max(scale_err[deep], float(d.max()))
            require(float(d.max()) <= QKV_SCALE_RTOL[deep],
                    f"n1 int8: layer {i % L}'s scale planes differ by "
                    f"{float(d.max()):.3e} relative > {QKV_SCALE_RTOL[deep]}")
    log(f"  n1 ({'b' if kv == 'int8' else 'a'}) {kv} pools: Program step "
        f"{ms:.3f} ms against the module's {module_ms:.3f} ms; tokens "
        f"equal on {sum(valid) - len(diff)} of {sum(valid)} positions "
        f"(the rest near-ties); pools within {pool_err:.3e} of their "
        f"largest (int8: steps); scales {scale_err[0]:.3e} first layer, "
        f"{scale_err[1]:.3e} deeper; {kernel} {counts[kernel]}, "
        f"layer_norm {counts['layer_norm']} [{card}]")
    return counts, {"step_ms": ms, "module_step_ms": module_ms,
                    "tokens_differ_at_ties": len(diff),
                    "pool_max_rel_err": pool_err,
                    "scale_max_rel_err": scale_err}


def n1_two_lane(torch, np, seed, card, exe, scope, lm, cfg):
    """(c): the prefill Program (flash: K6) on a window of phase 3's
    prompts, then decode Program steps (K13) over its pools, against
    ``PrefillStepModel`` / ``DecodeStepModel`` on clones."""
    import dataclasses

    from paddle_tpu_torch.generation import (CacheGeometry, DecodeStepModel,
                                             PrefillStepModel,
                                             build_decode_program,
                                             build_prefill_program)

    L, H, D = cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    maxp = cfg.max_position // PAGE
    geom = CacheGeometry(N_PAGES, PAGE, maxp)
    n, S = N1_PREFILL_ROWS, N1_PREFILL_SEQ
    lengths, prompts = serving_prompts(np, seed, cfg.vocab_size)
    lens = np.minimum(lengths[:n], S).astype(np.int32)
    tokens = np.zeros((n, S), np.int64)
    for b in range(n):
        tokens[b, :lens[b]] = prompts[b][:lens[b]]
    tables = np.zeros((n, maxp), np.int32)
    per = -(-(S + N1_DECODE_STEPS) // PAGE)
    for b in range(n):
        tables[b, :per] = 1 + b * per + np.arange(per)
    zeros = {f"gen_{s}_pages_{i}": torch.zeros((H, N_PAGES, PAGE, D),
                                               device=DEVICE)
             for i in range(L) for s in "kv"}
    feed = dict(zeros, gen_tokens=tokens,
                gen_positions=np.zeros(n, np.int64), gen_num_valid=lens,
                gen_last_index=(lens - 1).astype(np.int64),
                gen_block_tables=tables)
    prog, fetches = build_prefill_program(fcfg, S, geom)
    outs, pre_ms, pre_counts = _run_program(torch, exe, prog, feed, fetches,
                                            scope, [_logits_name(prog)])
    require(pre_counts["flash_attention_fwd"] == L,
            f"n1 (c) prefill: flash launched "
            f"{pre_counts['flash_attention_fwd']} times, want {L}")
    kp = [zeros[f"gen_k_pages_{i}"].clone() for i in range(L)]
    vp = [zeros[f"gen_v_pages_{i}"].clone() for i in range(L)]
    mtok = PrefillStepModel(lm, geom, use_flash=True)(
        torch.as_tensor(tokens, device=DEVICE),
        torch.as_tensor(lens, device=DEVICE),
        torch.as_tensor(tables, device=DEVICE), kp, vp)
    diffs = len(_tokens_or_ties(np, outs[0].cpu().numpy(),
                                mtok.cpu().numpy(), outs[-1].cpu().numpy(),
                                [True] * n, "n1 (c) prefill"))
    pool_err = _pools_close(torch, kp + vp, outs[1:1 + 2 * L],
                            "n1 (c) prefill")
    dprog, dfetch = build_decode_program(cfg, geom)
    step = DecodeStepModel(lm, geom)
    pages = {f"gen_{s}_pages_{i}": outs[1 + i + (L if s == "v" else 0)]
             for i in range(L) for s in "kv"}
    kp = [pages[f"gen_k_pages_{i}"].clone() for i in range(L)]
    vp = [pages[f"gen_v_pages_{i}"].clone() for i in range(L)]
    nxt = outs[0].cpu().numpy().astype(np.int64)
    pos = lens.astype(np.int64)
    dec_ms, dec_counts = [], {}
    for s in range(N1_DECODE_STEPS):
        dfeed = dict(pages, gen_tokens=nxt[:, None],
                     gen_positions=pos, gen_num_valid=np.ones(n, np.int32),
                     gen_attend_lens=(pos + 1).astype(np.int32),
                     gen_block_tables=tables)
        douts, ms, counts = _run_program(torch, exe, dprog, dfeed, dfetch,
                                         scope, [_logits_name(dprog)])
        require(counts["paged_attention"] == L, f"n1 (c) decode: K13 "
                f"launched {counts['paged_attention']} times, want {L}")
        dec_ms.append(ms)
        for k, v in counts.items():
            dec_counts[k] = dec_counts.get(k, 0) + v
        mtok = step(torch.as_tensor(nxt, device=DEVICE),
                    torch.as_tensor(pos, device=DEVICE, dtype=torch.int32),
                    torch.ones(n, dtype=torch.int32, device=DEVICE),
                    torch.as_tensor(pos + 1, device=DEVICE,
                                    dtype=torch.int32),
                    torch.as_tensor(tables, device=DEVICE), kp, vp)
        diffs += len(_tokens_or_ties(np, douts[0].cpu().numpy(),
                                     mtok.cpu().numpy(),
                                     douts[-1].cpu().numpy(), [True] * n,
                                     f"n1 (c) decode {s}"))
        pool_err = max(pool_err, _pools_close(
            torch, kp + vp, douts[1:1 + 2 * L], f"n1 (c) decode {s}"))
        pages = {f"gen_{s_}_pages_{i}": douts[1 + i + (L if s_ == "v" else 0)]
                 for i in range(L) for s_ in "kv"}
        nxt = douts[0].cpu().numpy().astype(np.int64)
        pos = pos + 1
    log(f"  n1 (c) two_lane: prefill Program {pre_ms:.3f} ms ({n} x {S}, "
        f"flash {pre_counts['flash_attention_fwd']}), decode Program "
        f"{statistics.mean(dec_ms):.3f} ms a step (K13 {L} a step); tokens "
        f"equal but {diffs} near-ties; pools within {pool_err:.3e} [{card}]")
    return pre_counts, dec_counts, {
        "prefill_ms": pre_ms, "decode_ms": dec_ms,
        "tokens_differ_at_ties": diffs, "pool_max_rel_err": pool_err}


def n1_lora(torch, np, seed, card, exe, scope, cfg):
    """(d): int8 weights, then ``rewrite_for_lora(program, store)`` over
    the ragged Program with two of phase 7b's adapters (ranks 8, 16)."""
    from paddle_tpu_torch.adapters import AdapterStore, rewrite_for_lora
    from paddle_tpu_torch.generation import (CacheGeometry,
                                             build_ragged_step_program)
    from paddle_tpu_torch.quantize import rewrite_for_inference

    L = cfg.num_layers
    geom = CacheGeometry(N_PAGES, PAGE, cfg.max_position // PAGE)
    feed, valid = _n1_mixed_feed(torch, np, seed, cfg, "float32")
    rows = [None, "ad0", "ad1", None, "ad0", "ad1", "ad0", None]

    # the unrewritten int8 Program (its quantization converts the scope's
    # weights; later Programs over the scope repoint onto them)
    base, bfetch = build_ragged_step_program(cfg, geom, CHUNK)
    rewrite_for_inference(base, scope, "int8")
    exe.run(base, feed=feed, fetch_list=bfetch, scope=scope,
            return_numpy=False)
    bout, base_ms, _c = _run_program(torch, exe, base, feed, bfetch, scope,
                                     [_logits_name(base)])
    child = scope.new_scope()
    prog, fetches = build_ragged_step_program(cfg, geom, CHUNK)
    rewrite_for_inference(prog, scope, "int8")
    store = AdapterStore.for_program(prog, rank_buckets=(8, 16),
                                     slots_per_bucket=2, device=DEVICE)
    rep = rewrite_for_lora(prog, store)
    require(rep.n_repointed == 4 * L + 1 and {r["base_kind"] for r in
                                              rep.rows} == {"int8"},
            f"n1 (d): the rewrite repointed {rep.summary()}")
    before = [(op.type, dict(op.inputs), dict(op.attrs))
              for op in prog.global_block().ops]
    again = rewrite_for_lora(prog, store)
    require(again.n_repointed == 0 and before == [
        (op.type, dict(op.inputs), dict(op.attrs))
        for op in prog.global_block().ops],
        "n1 (d): a second rewrite changed the Program")
    store.attach(child)
    ads = adapter_factors(torch, store, seed)[:2]
    for aid, fac, alpha in ads:
        store.upload(aid, fac, alpha=alpha)
    slots = np.stack([store.slots_row(a) for a in rows]).astype(np.int32)
    lfeed = dict(feed, gen_adapter_slots=slots)
    exe.run(prog, feed=lfeed, fetch_list=fetches, scope=child,
            return_numpy=False)
    outs, ms, counts = _run_program(torch, exe, prog, lfeed, fetches, child,
                                    [_logits_name(prog)])
    for k in ("quantized_matmul", "batched_lora_add_"):
        require(counts[k] == 4 * L + 1, f"n1 (d): {k} launched {counts[k]} "
                f"times, want {4 * L + 1}")
    got = outs[0].cpu().numpy().reshape(LANES, CHUNK)
    want = bout[0].cpu().numpy().reshape(LANES, CHUNK)
    base_rows = [b for b, a in enumerate(rows) if a is None]
    vmask = np.asarray(valid).reshape(LANES, CHUNK)
    logits = outs[-1].cpu().numpy().reshape(LANES, CHUNK, -1)
    ties = 0
    for b in base_rows:
        ties += len(_tokens_or_ties(np, got[b], want[b], logits[b], vmask[b],
                                    f"n1 (d) base row {b}"))
    moved = 0
    for aid, fac, alpha in ads:
        one = AdapterStore.for_program(prog, rank_buckets=(8, 16),
                                       slots_per_bucket=2, device=DEVICE)
        own = scope.new_scope()
        dprog, dfetch = build_ragged_step_program(cfg, geom, CHUNK)
        rewrite_for_inference(dprog, scope, "int8")
        rewrite_for_lora(dprog, one)
        one.attach(own)
        one.upload(aid, fac, alpha=alpha)
        dslots = np.stack([one.slots_row(aid if a == aid else None)
                           for a in rows]).astype(np.int32)
        douts = exe.run(dprog, feed=dict(feed, gen_adapter_slots=dslots),
                        fetch_list=dfetch, scope=own, return_numpy=False)
        dtok = douts[0].cpu().numpy().reshape(LANES, CHUNK)
        for b, a in enumerate(rows):
            if a == aid:
                ties += len(_tokens_or_ties(np, got[b], dtok[b], logits[b],
                                            vmask[b], f"n1 (d) {aid} row {b}"))
                moved += int((got[b][vmask[b]] != want[b][vmask[b]]).sum())
        del one, own, douts
    log(f"  n1 (d) LoRA over int8: {rep.n_repointed} ops repointed, a second "
        f"rewrite none; step {ms:.3f} ms against the unrewritten int8 "
        f"Program's {base_ms:.3f} ms; base rows equal the unrewritten "
        f"Program's, adapter rows a dedicated Program's ({ties} near-ties; "
        f"{moved} adapter-row tokens differ from the base); K11 "
        f"{counts['quantized_matmul']}, K12 {counts['batched_lora_add_']} "
        f"[{card}]")
    return counts, {"step_ms": ms, "base_step_ms": base_ms,
                    "ops_repointed": rep.n_repointed, "near_ties": ties,
                    "adapter_tokens_moved": moved}


def phase_n1(torch, np, seed, card):
    """n1: the serving Programs at gpt3_1p3b's full width."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.generation import share_params
    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.gpt3_1p3b()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shapes = {n: tuple(p.shape)
              for n, p in GPTLM(cfg, device="meta").jax_params().items()}
    params = make_params(torch, shapes, cfg.initializer_range, gen)
    scope = fluid.Scope()
    for n, t in params.items():
        scope.set_var(n, t)
    lm = GPTLM(cfg, device="meta")
    share_params(lm, params)         # the module reads the scope's tensors
    del params
    exe = fluid.Executor(fluid.CUDAPlace(0))
    paths, rec = {}, {}
    paths["program_ragged"], rec["a"] = n1_ragged(
        torch, np, seed, card, exe, scope, lm, cfg, "float32")
    paths["program_ragged_int8"], rec["b"] = n1_ragged(
        torch, np, seed, card, exe, scope, lm, cfg, "int8")
    paths["program_prefill"], paths["program_decode"], rec["c"] = \
        n1_two_lane(torch, np, seed, card, exe, scope, lm, cfg)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    paths["program_lora"], rec["d"] = n1_lora(torch, np, seed, card, exe,
                                              scope, cfg)
    del scope, exe
    gc.collect()
    torch.cuda.empty_cache()
    return paths, rec


def _lower(torch, type_, ins, attrs, dev=DEVICE):
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    op = _LOp(type_, attrs)
    return get_op_def(type_).lower(
        LoweringContext(dev), op,
        {k: (v if isinstance(v, list) else [v]) for k, v in ins.items()})


def _n2_cases(torch, np, seed):
    """(op, inputs as numpy, attrs, output slot, the unfused graph over
    torch tensors on a device, tolerance (atol of max|ref|, rtol), the
    op's bytes and flops)."""
    rng = np.random.RandomState(seed + 21)

    def f(*s, scale=1.0):
        return (rng.randn(*s) * scale).astype(np.float32)

    B, S, N, Hd = 8, 128, 12, 64
    D = N * Hd
    mask = np.zeros((B, 1, 1, S), np.float32)
    for b in range(B):
        mask[b, ..., S - 16 * (b % 4):] = -1e4
    mh = {"Input": f(B, S, D), "W": f(D, 3, N, Hd, scale=0.02),
          "Bias": f(3, N, Hd, scale=0.02), "BiasQK": mask}
    alpha = 1.0 / np.sqrt(Hd)

    def mh_unfused(t):
        w, b = t["W"], t["Bias"]
        heads = []
        for c in range(3):
            h = _lower(torch, "matmul", {"X": t["Input"], "Y": w[:, c].reshape(
                D, D)}, {}, t["Input"].device)["Out"][0]
            h = _lower(torch, "elementwise_add", {"X": h, "Y": b[c].reshape(
                D)}, {"axis": -1}, h.device)["Out"][0]
            h = _lower(torch, "reshape2", {"X": h}, {"shape": [B, S, N, Hd]},
                       h.device)["Out"][0]
            heads.append(_lower(torch, "transpose2", {"X": h},
                                {"axis": [0, 2, 1, 3]}, h.device)["Out"][0])
        q, k, v = heads
        s = _lower(torch, "matmul", {"X": q, "Y": k},
                   {"transpose_Y": True, "alpha": alpha}, q.device)["Out"][0]
        s = _lower(torch, "elementwise_add", {"X": s, "Y": t["BiasQK"]},
                   {"axis": -1}, s.device)["Out"][0]
        p = _lower(torch, "softmax", {"X": s}, {"axis": -1}, s.device)["Out"][0]
        o = _lower(torch, "matmul", {"X": p, "Y": v}, {}, p.device)["Out"][0]
        o = _lower(torch, "transpose2", {"X": o}, {"axis": [0, 2, 1, 3]},
                   o.device)["Out"][0]
        return _lower(torch, "reshape2", {"X": o}, {"shape": [B, S, D]},
                      o.device)["Out"][0]

    R, E = 8 * 128, 768
    fe = {"X": f(R, E), "W": f(E, E, scale=0.03), "Bias0": f(E, scale=0.02),
          "Y": f(R, E), "Scale": 1 + f(E, scale=0.1),
          "Bias1": f(E, scale=0.1)}

    def fe_unfused(t):
        h = _lower(torch, "mul", {"X": t["X"], "Y": t["W"]}, {},
                   t["X"].device)["Out"][0]
        h = _lower(torch, "elementwise_add", {"X": h, "Y": t["Bias0"]},
                   {"axis": 1}, h.device)["Out"][0]
        h = _lower(torch, "elementwise_add", {"X": h, "Y": t["Y"]}, {},
                   h.device)["Out"][0]
        return _lower(torch, "layer_norm", {"X": h, "Scale": t["Scale"],
                                            "Bias": t["Bias1"]},
                      {"begin_norm_axis": 1, "epsilon": 1e-5},
                      h.device)["Y"][0]

    Bc, C, HW = 32, 256, 14        # ResNet-50's conv4_x 3 x 3 at batch 32
    cv = {"Input": f(Bc, C, HW, HW), "Filter": f(C, C, 3, 3, scale=0.02),
          "Bias": f(C, scale=0.1), "ResidualData": f(Bc, C, HW, HW)}
    cattrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
              "groups": 1, "activation": "relu"}

    def cv_unfused(t):
        h = _lower(torch, "conv2d", {"Input": t["Input"],
                                     "Filter": t["Filter"]}, cattrs,
                   t["Input"].device)["Output"][0]
        h = _lower(torch, "elementwise_add", {"X": h, "Y": t["Bias"]},
                   {"axis": 1}, h.device)["Out"][0]
        h = _lower(torch, "elementwise_add", {"X": h,
                                              "Y": t["ResidualData"]}, {},
                   h.device)["Out"][0]
        return _lower(torch, "relu", {"X": h}, {}, h.device)["Out"][0]

    def nbytes(ins, out_elems):
        return 4 * (sum(a.size for a in ins.values()) + out_elems)

    return [
        ("multihead_matmul", mh, {"alpha": alpha}, "Out", mh_unfused,
         (1e-5, 1e-4), nbytes(mh, B * S * D),
         2 * B * S * D * 3 * D + 2 * 2 * B * N * S * S * Hd),
        ("fused_fc_elementwise_layernorm", fe,
         {"begin_norm_axis": 1, "epsilon": 1e-5, "x_num_col_dims": 1},
         "Out", fe_unfused, (1e-5, 1e-4), nbytes(fe, R * E + 2 * R),
         2 * R * E * E),
        ("conv2d_fusion", cv, cattrs, "Output", cv_unfused, (1e-5, 1e-4),
         nbytes(cv, Bc * C * HW * HW), 2 * Bc * C * HW * HW * C * 9),
    ]


def phase_n2(torch, np, seed, card):
    """n2: three fused inference ops at their users' widths, on the card
    against their unfused op graphs on the card and against the port's
    CPU path."""
    out = {}
    for op, ins, attrs, slot, unfused, (atol, rtol), nb, flops in _n2_cases(
            torch, np, seed):
        dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in ins.items()}
        cpu = {k: torch.as_tensor(v) for k, v in ins.items()}
        with torch.no_grad():
            got = _lower(torch, op, dev, attrs)[slot][0]
            ref = unfused(dev)
            host = _lower(torch, op, cpu, attrs, "cpu")[slot][0]
            top = float(host.abs().max())
            err_unfused = float((got - ref).abs().max())
            err_cpu = float((got.cpu() - host).abs().max())
            bound = atol * top + rtol * top
            require(err_unfused <= bound and err_cpu <= bound,
                    f"n2 {op}: card against unfused {err_unfused:.3e}, "
                    f"against CPU {err_cpu:.3e} > {bound:.3e}")
            ms = device_ms(torch, lambda: _lower(torch, op, dev, attrs))
            un_ms = device_ms(torch, lambda: unfused(dev))
        b_ms, by = bound_ms(nb, flops, "float32")
        out[op] = {"ms": ms, "unfused_ms": un_ms, "bound_ms": b_ms,
                   "bound_by": by, "err_vs_unfused": err_unfused,
                   "err_vs_cpu": err_cpu, "max_abs_ref": top}
        log(f"  n2 {op}: {ms:.4f} ms, unfused graph {un_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by}); max err against the unfused graph "
            f"{err_unfused:.3e}, the CPU {err_cpu:.3e} (bound {bound:.3e} ="
            f" ({atol} + {rtol}) x max|out| {top:.3e}) [{card}]")
    return out


def _ps_job(torch, np, fluid, seed, opt, batches, eps):
    """DeepFM at d4's configuration through DistributeTranspiler in
    pserver mode: the trainer on the card, the servers on threads."""
    from paddle_tpu_torch.models.ctr import build_deepfm
    from paddle_tpu_torch.ps.transpile import PSTrainer, launch_pservers
    from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                             DistributeTranspilerConfig)

    main, startup, _, fetches = build_deepfm(optimizer=opt, is_sparse=True,
                                             **CTR)
    main.random_seed = startup.random_seed = seed
    cfg = DistributeTranspilerConfig()
    cfg.mode = "pserver"
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=",".join(eps), trainers=1,
                sync_mode=True, startup_program=startup)
    art = t._ps_artifacts
    require(set(art.sparse_params) == {"fm_v", "fm_w1"},
            f"n3: sparse tables {sorted(art.sparse_params)}, want fm_v and "
            "fm_w1 (a dense pull of the table would hide the prefetch path)")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {n: scope.find_var(n).detach().cpu().numpy().copy()
            for n in ("fm_v", "fm_w1")}
    servers = launch_pservers(art, scope)
    trainer = PSTrainer(art, exe, scope)
    pushes = []
    push = trainer.client.push_sparse

    def record(shard_map, name, rows, grad):
        pushes.append((name, rows.copy(), grad.copy()))
        return push(shard_map, name, rows, grad)

    trainer.client.push_sparse = record
    losses, ms, bytes_ = [], [], []
    for b in batches:
        s0 = dict(trainer.client.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (l,) = trainer.run_step(b, [fetches["loss"]])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(l).reshape(-1)[0]))
        bytes_.append({k: trainer.client.stats[k] - s0[k] for k in s0})
    return dict(art=art, scope=scope, exe=exe, trainer=trainer,
                servers=servers, losses=losses, ms=ms, bytes=bytes_,
                init=init, pushes=pushes, loss=fetches["loss"])


def _server_rows(job, name, rows):
    return job["trainer"].client.prefetch_rows(job["art"].shard_map, name,
                                               rows)


def phase_n3(torch, np, seed, card, out_dir):
    """n3: DeepFM at d4's configuration through the parameter server."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.ctr import build_deepfm, synthetic_ctr_batch

    fluid.set_flags({"optimizer_fuse": "auto"})
    rng = np.random.RandomState(seed)
    batches = [synthetic_ctr_batch(rng, CTR_BATCH, CTR["num_fields"],
                                   CTR["vocab_size"], CTR["dense_dim"])
               for _ in range(CTR_STEPS)]
    touched = np.unique(np.concatenate([b["sparse_ids"].reshape(-1)
                                        for b in batches]))
    rec = {}
    # the one-process sparse SGD run on the card
    main, startup, _, fetches = build_deepfm(
        optimizer=fluid.optimizer.SGD(0.1), is_sparse=True, **CTR)
    main.random_seed = startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    ref_losses = [float(ctr_step(torch, exe, main, b, [fetches["loss"]],
                                 scope)[0][0].reshape(-1)[0])
                  for b in batches]
    ref = {p.name: scope.find_var(p.name) for p in main.all_parameters()}
    del exe, scope
    job = _ps_job(torch, np, fluid, seed, fluid.optimizer.SGD(0.1), batches,
                  [f"127.0.0.1:{p}" for p in _free_ports(2)])
    try:
        np.testing.assert_allclose(job["losses"], ref_losses, rtol=SGD_RTOL)
    except AssertionError as e:
        raise SmokeFailure(f"n3 SGD: losses {job['losses']} against one "
                           f"process's {ref_losses}: {e}") from None
    worst = 0.0
    for name in ("fm_v", "fm_w1"):
        got = _server_rows(job, name, touched)
        want = ref[name][torch.as_tensor(touched, device=DEVICE)].cpu().numpy()
        tol = SGD_RTOL * float(np.abs(want).max())
        d = float(np.abs(got - want).max())
        worst = max(worst, d)
        require(np.allclose(got, want, rtol=SGD_RTOL, atol=tol),
                f"n3 SGD: touched rows of {name} differ by {d:.3e}")
        untouched = np.setdiff1d(rng.randint(0, CTR["vocab_size"], 20000),
                                 touched)
        require(np.array_equal(_server_rows(job, name, untouched),
                               job["init"][name][untouched]),
                f"n3 SGD: untouched rows of {name} moved")
    for name, want in ref.items():
        if name in ("fm_v", "fm_w1"):
            continue
        got = job["scope"].find_var(name)
        d = float((got - want).abs().max())
        worst = max(worst, d)
        require(bool(torch.allclose(got, want, rtol=SGD_RTOL,
                                    atol=SGD_RTOL * float(want.abs().max()))),
                f"n3 SGD: dense {name} differs by {d:.3e}")
    # the card's idle share over one more step, traced
    prof = start_profile(torch)
    t0 = time.perf_counter()
    job["trainer"].run_step(batches[0], [job["loss"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    trace = trace_breakdown(prof, out_dir, "ps_step", wall, 1)
    job["trainer"].client.shutdown_servers()
    steady = job["ms"][1:]
    per = job["bytes"][1]
    rec["sgd"] = {"losses": job["losses"], "step_ms": job["ms"],
                  "bytes_a_step": per, "max_abs_err": worst,
                  "idle_share": trace["device_idle_share"],
                  "kernels_a_step": trace["kernels"]}
    log(f"  n3 SGD through 2 pservers: losses {job['losses']} equal one "
        f"process's within rtol {SGD_RTOL}, parameters within {worst:.3e};"
        f" untouched rows keep their bits; {statistics.mean(steady):.3f} ms "
        f"a step (first {job['ms'][0]:.3f}), {per['bytes_pushed']} bytes "
        f"pushed and {per['bytes_pulled']} pulled a step, idle share "
        f"{trace['device_idle_share']:.3f} over a traced step [{card}]")
    del job, ref
    gc.collect()
    torch.cuda.empty_cache()

    job = _ps_job(torch, np, fluid, seed, fluid.optimizer.AdamOptimizer(1e-3),
                  batches, [f"127.0.0.1:{p}" for p in _free_ports(2)])
    try:
        losses = job["losses"]
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"n3 Adam: losses {losses} not finite and falling")
        spec = next(s for n, s in job["art"].optimizer_specs.items()
                    if n == "fm_v")
        b1, b2 = spec.get("beta1", 0.9), spec.get("beta2", 0.999)
        eps_ = spec.get("epsilon", 1e-8)
        lr = float(job["scope"].find_var(spec["lr_var"]).reshape(-1)[0])
        # a numpy lazy Adam over the merged gradients the trainer pushed
        v = job["init"]["fm_v"][touched].copy()
        m1, m2 = np.zeros_like(v), np.zeros_like(v)
        p1, p2 = b1, b2
        for name, rows, grad in job["pushes"]:
            if name != "fm_v":
                continue
            loc = np.searchsorted(touched, rows)     # touched is sorted
            m1[loc] = b1 * m1[loc] + (1 - b1) * grad
            m2[loc] = b2 * m2[loc] + (1 - b2) * grad * grad
            lr_t = lr * np.sqrt(1 - p2) / (1 - p1)
            v[loc] -= (lr_t * m1[loc] / (np.sqrt(m2[loc]) + eps_)).astype(
                np.float32)
            p1, p2 = p1 * b1, p2 * b2
        got = _server_rows(job, "fm_v", touched)
        d = float(np.abs(got - v).max())
        require(np.allclose(got, v, rtol=1e-6, atol=1e-7),
                f"n3 Adam: touched rows differ from a numpy lazy Adam by "
                f"{d:.3e}")
    finally:
        job["trainer"].client.shutdown_servers()
    rec["adam"] = {"losses": losses, "step_ms": job["ms"],
                   "touched_rows_max_abs_err": d}
    log(f"  n3 Adam on the servers: losses {losses}; the {touched.size} "
        f"touched rows of fm_v equal a numpy lazy Adam within {d:.3e}; "
        f"{statistics.mean(job['ms'][1:]):.3f} ms a step [{card}]")
    del job
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _n4_model(fluid, seed, opt):
    from paddle_tpu_torch.models.ctr import build_deepfm

    main, startup, _, fetches = build_deepfm(
        optimizer=opt, is_sparse=True, **dict(CTR, vocab_size=N4_VOCAB))
    main.random_seed = startup.random_seed = seed
    return main, startup, fetches["loss"]


def _n4_batch(np, seed, step, tid):
    from paddle_tpu_torch.models.ctr import synthetic_ctr_batch

    b = synthetic_ctr_batch(np.random.RandomState(seed * 1000 + step),
                            CTR_BATCH, CTR["num_fields"], N4_VOCAB,
                            CTR["dense_dim"])
    half = CTR_BATCH // 2
    if tid is None:
        return b
    return {k: v[tid * half:(tid + 1) * half] for k, v in b.items()}


def n4_child(argv) -> int:
    """A process of phase n4's parameter-server job, started by ``python
    -m paddle_tpu_torch.distributed.launch_ps``: ``argv`` is (out dir,
    seed). Both runs share the processes: a pserver serves the sync
    SGD run's shards on its endpoint and the geo run's on its endpoint's
    port + the server count (a thread); a trainer trains on the card,
    sync first, then geo. Everything starts from the parent's
    ``init.npz``."""
    import numpy as np
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import fleet as F
    from paddle_tpu_torch.ps.client import PSClient, wait_server_ready
    from paddle_tpu_torch.ps.server import ParameterServer
    from paddle_tpu_torch.ps.transpile import server_shards
    from paddle_tpu_torch.transpiler import GeoSgdTranspiler

    t0 = time.perf_counter()
    out_dir, seed = argv[0], int(argv[1])
    role = F.PaddleCloudRoleMaker(is_collective=False)
    F.fleet.init(role)
    server = F.fleet.is_server()
    dev = "cpu" if server else DEVICE
    exe = fluid.Executor(fluid.CPUPlace() if server else fluid.CUDAPlace(0))
    init = np.load(os.path.join(out_dir, "init.npz"))
    eps = role.get_pserver_endpoints()
    geo_eps = [f"{h}:{int(p) + len(eps)}"
               for h, p in (e.rsplit(":", 1) for e in eps)]

    def scope_of(startup):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n in init.files:
            scope.set_var(n, torch.from_numpy(init[n]).to(dev))
        return scope

    main, startup, loss = _n4_model(fluid, seed, None)
    strategy = F.DistributedStrategy()
    strategy.mode = "pserver"
    with fluid.program_guard(main, startup):
        F.fleet.distributed_optimizer(fluid.optimizer.SGD(0.1),
                                      strategy).minimize(loss)
    scope = scope_of(startup)
    gmain, gstartup, gloss = _n4_model(fluid, seed, fluid.optimizer.SGD(0.1))
    geo = GeoSgdTranspiler()
    geo.transpile(0 if server else role.worker_index(), program=gmain,
                  pservers=",".join(geo_eps), trainers=role.worker_num(),
                  startup_program=gstartup)
    gart = geo._ps_artifacts
    gscope = scope_of(gstartup)
    if server:
        gep = geo_eps[eps.index(role.get_current_endpoint())]
        shards, specs = server_shards(gart, gscope, gep)
        geo_thread = ParameterServer(gep, shards, specs, gart.trainers,
                                     gart.sync_mode).start_background()
        print(f"PSERVER_READY {time.perf_counter() - t0:.1f} s", flush=True)
        F.fleet.run_server(scope=scope)     # until the sync run's end
        geo_thread.join()                   # until the geo run's end
        return 0
    tid = role.worker_index()
    params = [p.name for p in main.all_parameters()]
    trainer = F.fleet.init_worker(executor=exe, scope=scope)
    t_ready = time.perf_counter() - t0
    losses = [float(np.asarray(trainer.run_step(
        _n4_batch(np, seed, s, tid), [loss])[0]).reshape(-1)[0])
        for s in range(N4_STEPS)]
    trainer._refresh_sparse_rows({n: np.arange(N4_VOCAB) for n in
                                  trainer.art.sparse_params.values()})
    out = {n: scope.get_numpy(n) for n in params}
    F.fleet.stop_worker()
    t_sync = time.perf_counter() - t0
    wait_server_ready(gart.endpoints)
    comm = geo.get_communicator(gscope, need_push_nums=N4_GEO_PUSH)
    geo_losses = []
    for s in range(N4_GEO_STEPS):
        # two batches cycled: the losses of the same batch fall
        (l,) = exe.run(gmain, feed=_n4_batch(np, seed, s % 2, tid),
                       fetch_list=[gloss], scope=gscope)
        geo_losses.append(float(np.asarray(l).reshape(-1)[0]))
        for g in gart.grad_to_param:
            comm.send(g, None)
    client = PSClient(gart.endpoints, tid)
    client.barrier()                # both trainers pushed their last delta
    for n in gart.shard_map:
        gscope.set_var(n, torch.from_numpy(
            client.get_param(gart.shard_map, n)).to(DEVICE))
    client.barrier()                # both pulled: the servers may stop
    if tid == 0:
        client.shutdown_servers()
    client.close()
    out.update({f"geo/{n}": gscope.get_numpy(n) for n in params})
    np.savez(os.path.join(out_dir, f"trainer{tid}.npz"),
             losses=np.asarray(losses), geo_losses=np.asarray(geo_losses),
             seconds=np.asarray([t_ready, t_sync,
                                 time.perf_counter() - t0]), **out)
    return 0


def phase_n4(torch, np, seed, card, out_dir):
    """n4: two pservers and two trainers as processes through
    ``launch_ps``: sync SGD against one process over both trainers'
    batches, then GeoSgdTranspiler over the same processes."""
    import paddle_tpu_torch as fluid

    # the checkout holding the package (the launcher's working directory)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(fluid.__file__)))
    root = tempfile.mkdtemp(prefix="n4_", dir=out_dir)
    try:
        main, startup, loss = _n4_model(fluid, seed,
                                        fluid.optimizer.SGD(0.1))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        np.savez(os.path.join(root, "init.npz"),
                 **{n: scope.get_numpy(n) for n in params})
        logs = os.path.join(root, "logs")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_ps",
             "--server_num", "2", "--worker_num", "2", "--started_port",
             str(_free_ports(1)[0]), "--log_dir", logs,
             os.path.abspath(__file__), "--n4-child", root, str(seed)],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        # the one-process reference meanwhile: SGD on the full batches
        for s in range(N4_STEPS):
            exe.run(main, feed=_n4_batch(np, seed, s, None),
                    fetch_list=[loss], scope=scope)
        want = {n: scope.get_numpy(n) for n in params}
        try:
            text, _ = proc.communicate(timeout=N4_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        wall = time.perf_counter() - t0
        texts = {}
        for f in (sorted(os.listdir(logs)) if os.path.isdir(logs) else []):
            with open(os.path.join(logs, f)) as fh:
                texts[f] = fh.read()
        require(proc.returncode == 0, f"n4: launch_ps exited "
                f"{proc.returncode}: {text[-2000:]}\n" + "\n".join(
                    f"--- {f}\n{t[-3000:]}" for f, t in texts.items()))
        ready = []
        for i in (0, 1):
            # the log may hold other lines first: the marker's own line
            line = next((ln for ln in texts.get(f"pserver.{i}.log",
                                                "").splitlines()
                         if ln.startswith("PSERVER_READY")), None)
            require(line is not None, f"n4: pserver {i} never said "
                    "PSERVER_READY")
            ready.append(line.split()[1])
        outs = [np.load(os.path.join(root, f"trainer{t}.npz"))
                for t in (0, 1)]
        worst = 0.0
        for t in outs:
            for n in params:
                top = float(np.abs(want[n]).max())
                d = float(np.abs(t[n] - want[n]).max())
                worst = max(worst, d / max(top, 1e-30))
                require(np.allclose(t[n], want[n], rtol=N4_RTOL,
                                    atol=N4_RTOL * top),
                        f"n4 sync: {n} differs from one process by {d:.3e}")
        for n in params:
            require(np.array_equal(outs[0][f"geo/{n}"], outs[1][f"geo/{n}"]),
                    f"n4 geo: the trainers' {n} differ after the final "
                    "sync")
        geo_losses = [list(map(float, t["geo_losses"])) for t in outs]
        require(all(sum(gl[-2:]) < sum(gl[:2]) for gl in geo_losses),
                f"n4 geo: losses {geo_losses} do not fall (the last two "
                "against the first two, the same two batches)")
        sync_losses = [list(map(float, t["losses"])) for t in outs]
        seconds = [list(map(float, t["seconds"])) for t in outs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  n4 launch_ps, 2 pservers + 2 trainers (vocabulary cut to "
        f"{N4_VOCAB} rows): after {N4_STEPS} sync SGD steps both trainers' "
        f"parameters equal one process over both batches within "
        f"{worst:.3e} of each one's largest (rtol {N4_RTOL}); losses "
        f"{sync_losses}; geo over the same processes ({N4_GEO_STEPS} "
        f"steps, a push every {N4_GEO_PUSH}, 2 batches cycled): losses "
        f"{geo_losses}, the trainers equal after the final sync; the job "
        f"{wall:.1f} s (pservers ready at {ready} s, trainers ready / sync "
        f"done / geo done at {seconds} s of their own) [{card}]")
    return {"sync_losses": sync_losses, "sync_max_rel_err": worst,
            "geo_losses": geo_losses, "seconds": wall,
            "trainer_seconds": seconds}


def phase_n(torch, np, seed, card, out_dir):
    """Phase n: the serving Programs, the fused ops, the parameter
    server. Returns (paths, record)."""
    t0 = time.perf_counter()
    rec = {}
    paths, rec["n1"] = phase_n1(torch, np, seed, card)
    rec["n1_seconds"] = time.perf_counter() - t0
    t = time.perf_counter()
    rec["n2"] = phase_n2(torch, np, seed, card)
    rec["n2_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["n3"] = phase_n3(torch, np, seed, card, out_dir)
    rec["n3_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["n4"] = phase_n4(torch, np, seed, card, out_dir)
    rec["n4_seconds"] = time.perf_counter() - t
    rec["seconds"] = time.perf_counter() - t0
    log(f"  phase n took {rec['seconds']:.1f} s (n1 {rec['n1_seconds']:.1f},"
        f" n2 {rec['n2_seconds']:.1f}, n3 {rec['n3_seconds']:.1f}, n4 "
        f"{rec['n4_seconds']:.1f})")
    return paths, rec


# -- phase o: the NCHW -> NHWC pass on the card -----------------------------------

NHWC_LOSS_RTOL = 1e-4
# o1's velocities, leaf by leaf (relative L2): ResNet-50's first-step
# gradients move 2-3 % under a 1e-7 nudge of the input, while a zeroed
# gradient reads about 1 and a lost 1/n 0.5
NHWC_VELOCITY_RTOL = 1e-1


def nhwc_resnet(fluid, optimizer):
    """Phase 8's ResNet-50 built NCHW, rewritten by ``auto_nhwc`` before
    ``optimizer`` minimizes it (the pass's contract: the forward
    program); the names are those of the NCHW build under the same
    unique-name scope. Returns main, startup, fetches and the count of
    flipped ops."""
    from paddle_tpu_torch.models.resnet import build_resnet50
    from paddle_tpu_torch.transpiler import auto_nhwc

    with fluid.unique_name.guard():
        main, startup, _, fetches = build_resnet50(1000, RESNET_IMAGE,
                                                   data_format="NCHW")
        with fluid.program_guard(main, startup):
            flipped = auto_nhwc(main)
            optimizer.minimize(fetches["loss"])
    ops = main.global_block().ops
    transposes = sum(op.type == "transpose2" for op in ops)
    require(flipped >= 108 and transposes <= 4, f"auto_nhwc flipped "
            f"{flipped} ops (want >= 108) with {transposes} transpose2 "
            "(want <= 4)")
    return main, startup, fetches, flipped, transposes


def _beside(perf, other, name, card):
    if other is None:
        log(f"  ({name} did not run in this call)")
        return
    log(f"  beside {name} (NCHW): mean step {other['step_ms_mean']:.3f} ms, "
        f"{other['images_per_s']:.2f} images/s, max_memory_allocated "
        f"{other['max_memory_allocated_gb']:.2f} GB; NHWC here "
        f"{perf['step_ms_mean']:.3f} ms, {perf['images_per_s']:.2f} "
        f"images/s, {perf['max_memory_allocated_gb']:.2f} GB [{card}]")


def nhwc_momentum(torch, np, seed, card, out_dir, phase8=None,
                  profile=False, steps=10):
    """o1: phase 8's recipe through ``auto_nhwc``, held to the NCHW
    program's first step from the same values, then trained."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.core.framework import Parameter
    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    with fluid.unique_name.guard():
        ref_main, ref_startup, _, ref_fetches = build_resnet50(
            1000, RESNET_IMAGE, resnet_optimizer(fluid), data_format="NCHW")
    main, startup, fetches, flipped, transposes = nhwc_resnet(
        fluid, resnet_optimizer(fluid))
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_momentum") == 161, "fused_momentum ops")
    ref_exe, ref_scope, n_params = startup_on_card(torch, np, fluid,
                                                   ref_main, ref_startup,
                                                   seed)
    persist = [v for v in ref_main.list_vars()
               if v.persistable and not v.is_data]
    require({v.name for v in persist} == {
        v.name for v in main.list_vars() if v.persistable and not v.is_data},
        "the NHWC program's persistables differ from the NCHW one's")
    scope, nudge_scope = fluid.Scope(), fluid.Scope()
    for v in persist:
        scope.set_var(v.name, ref_scope.find_var(v.name).clone())
        nudge_scope.set_var(v.name, ref_scope.find_var(v.name).clone())
    exe = fluid.Executor(fluid.CUDAPlace(0))
    batch = synthetic_image_batch(np.random.RandomState(seed), RESNET_BATCH,
                                  RESNET_IMAGE)
    (ref_loss,) = ref_exe.run(ref_main, feed=batch,
                              fetch_list=[ref_fetches["loss"]],
                              scope=ref_scope)
    # the NCHW step again on the input scaled by 1 + 1e-7: how far
    # rounding alone moves the first step's gradients (phase 5's nudge)
    ref_exe.run(ref_main, feed=dict(batch, image=batch["image"]
                                    * np.float32(1 + 1e-7)),
                fetch_list=[ref_fetches["loss"]], scope=nudge_scope)
    # the first NHWC step, watching the gradients that reach the fused
    # update: cuDNN returns filter gradients channels-last
    opdef = get_op_def("fused_momentum")
    lower, channels_last = opdef.lower, []

    def watch(ctx, op, ins):
        g = ins["Grad"][0]
        if not g.is_contiguous():
            channels_last.append(op.inputs["Grad"][0])
        return lower(ctx, op, ins)

    opdef.lower = watch
    try:
        K.reset_launch_counts()
        (loss0,) = exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                           scope=scope)
        torch.cuda.synchronize()
        first = K.launch_counts()
    finally:
        opdef.lower = lower
    want = {name: 0 for name in K.KERNELS}
    want.update(fused_momentum_update=161, softmax_xent_fwd=1,
                softmax_xent_bwd=1)
    require(first == want, f"o1: the first NHWC step launched {first}, "
            f"want {want}")
    a = float(np.asarray(ref_loss).reshape(-1)[0])
    b = float(np.asarray(loss0).reshape(-1)[0])
    rel = abs(a - b) / abs(a)
    require(rel <= NHWC_LOSS_RTOL, f"o1: the NHWC first loss {b} differs "
            f"from NCHW's {a} by {rel:.3e} > {NHWC_LOSS_RTOL}")
    lr = resnet_lr(RESNET_BATCH)
    bn = {}     # running statistic -> its difference / its largest entry
    p_worst, p_name = -1.0, ""
    for v in persist:
        nchw = ref_scope.find_var(v.name).float()
        d = float((scope.find_var(v.name).float() - nchw).abs().max())
        if v.name.endswith((".bn.mean", ".bn.var")):
            bn[v.name] = d / float(nchw.abs().max())
        elif isinstance(v, Parameter) and d > p_worst:
            p_worst, p_name = d, v.name
    require(len(bn) == 106, f"o1: {len(bn)} running statistics, want 106")
    bn_name = max(bn, key=bn.get)
    bn_worst = bn[bn_name]
    require(bn_worst <= BN_STATS_RTOL, f"o1: running statistic {bn_name} "
            f"differs by {bn_worst:.3e} of its largest entry")
    # the velocities after the first step are the gradients K10m took
    # (plus the L2 decay): held leaf by leaf, as the 2 * lr rule cannot
    vel, vel_nudge = {}, {}
    for v in persist:
        if getattr(v, "is_accumulator", False) and "velocity" in v.name:
            nchw = ref_scope.find_var(v.name).float()
            norm = nchw.norm().clamp_min(1e-30)
            vel[v.name] = float((scope.find_var(v.name).float() - nchw)
                                .norm() / norm)
            vel_nudge[v.name] = float(
                (nudge_scope.find_var(v.name).float() - nchw).norm() / norm)
    require(len(vel) == 161, f"o1: {len(vel)} velocities, want 161")
    v_name = max(vel, key=vel.get)
    v_worst = vel[v_name]
    n_name = max(vel_nudge, key=vel_nudge.get)
    fc = [n for n in vel if n.startswith("fc")]
    log(f"  {flipped} ops flipped, {transposes} transpose2, {len(types)} "
        f"ops; first loss NHWC {b:.6f} against NCHW {a:.6f} (rel "
        f"{rel:.3e}, limit {NHWC_LOSS_RTOL}); BN running statistics within "
        f"{bn_worst:.3e} of their largest ({bn_name}); parameters after the "
        f"first update within {p_worst:.3e} ({p_name}; limit 2 * lr = "
        f"{2 * lr:.3e}); velocities at relative L2 {v_worst:.3e} at worst "
        f"({v_name}; median {statistics.median(vel.values()):.3e}, least "
        f"{min(vel.values()):.3e}, {fc} {[f'{vel[n]:.3e}' for n in fc]}; "
        f"limit {NHWC_VELOCITY_RTOL}), the NCHW step on the nudged input's "
        f"{vel_nudge[n_name]:.3e} at worst ({n_name}; median "
        f"{statistics.median(vel_nudge.values()):.3e}, least "
        f"{min(vel_nudge.values()):.3e}, fc "
        f"{[f'{vel_nudge[n]:.3e}' for n in fc]}); {len(channels_last)} of "
        f"161 gradients "
        f"reached the update channels-last, e.g. {channels_last[:3]} "
        f"[{card}]")
    require(p_worst <= 2 * lr, f"o1: parameter {p_name} differs by "
            f"{p_worst:.3e} after the first update > 2 * lr = {2 * lr:.3e}")
    require(v_worst <= NHWC_VELOCITY_RTOL, f"o1: velocity {v_name} differs "
            f"by {v_worst:.3e} (relative L2) > {NHWC_VELOCITY_RTOL}")
    del ref_exe, ref_scope, nudge_scope
    torch.cuda.empty_cache()
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, RESNET_BATCH, card,
                             out_dir, "resnet_nhwc", profile, unit="images")
    for n, c in first.items():
        totals[n] += c
    perf.update(parameters=n_params, flipped=flipped, transposes=transposes,
                ops=len(types), first_loss_nchw=a, first_loss_nhwc=b,
                first_loss_rel_err=rel, bn_stats_max_rel_err=bn_worst,
                param_max_abs_err_first_step=p_worst, param_limit=2 * lr,
                velocity_rel_l2_worst=v_worst,
                velocity_rel_l2_median=statistics.median(vel.values()),
                nudge_velocity_rel_l2_worst=vel_nudge[n_name],
                nudge_velocity_rel_l2_median=statistics.median(
                    vel_nudge.values()),
                velocity_rel_l2_limit=NHWC_VELOCITY_RTOL,
                channels_last_grads=len(channels_last))
    _beside(perf, phase8, "phase 8", card)
    return totals, perf


def nhwc_amp(torch, np, seed, card, out_dir, phase9=None, profile=False,
             steps=10):
    """o2: phase 9's recipe (bfloat16 AMP, fused Adam) through
    ``auto_nhwc``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models.resnet import synthetic_image_batch

    fluid.set_flags({"optimizer_fuse": "auto"})   # on: a CUDA device exists
    main, startup, fetches, flipped, transposes = nhwc_resnet(
        fluid, amp_adam(fluid, 1e-4))
    types = [op.type for op in main.global_block().ops]
    require(types.count("fused_adam") == 161 and "adam" not in types,
            f"{types.count('fused_adam')} fused_adam ops")
    log(f"  {flipped} ops flipped, {transposes} transpose2; {len(types)} ops "
        f"({types.count('cast')} casts) beside phase 9's 853 (158 casts)")
    exe, scope, n_params = startup_on_card(torch, np, fluid, main, startup,
                                           seed)
    batch = synthetic_image_batch(np.random.RandomState(seed), RESNET_BATCH,
                                  RESNET_IMAGE)
    want = {name: 0 for name in K.KERNELS}
    want.update(fused_adam_update=161, softmax_xent_fwd=1,
                softmax_xent_bwd=1)
    totals, perf = run_steps(torch, np, K, exe, main, scope, batch,
                             fetches["loss"], want, steps, RESNET_BATCH, card,
                             out_dir, "resnet_nhwc_amp", profile,
                             unit="images")
    perf.update(parameters=n_params, flipped=flipped, transposes=transposes,
                ops=len(types), casts=types.count("cast"), amp="bfloat16")
    if profile:
        groups = perf["profile"]["kernel_ms_a_step_by_group"]
        log(f"  a step's convolution device ms "
            f"{groups.get('convolution (cuDNN)', 0.0):.3f} (phase 9, NCHW: "
            f"6.84, of which cuDNN's layout transposes about 2.5; PERF.md "
            f"section 5), layout transposes "
            f"{perf['profile']['layout_transpose_ms'] / 2:.3f}, copies and "
            f"casts {groups.get('copies and casts', 0.0):.3f} [{card}]")
    _beside(perf, phase9, "phase 9", card)
    return totals, perf


def run_check_on_card(card):
    """o3: ``install_check.run_check()`` on the card: its verdict lines."""
    import contextlib
    import io as _io

    import paddle_tpu_torch as fluid

    buf = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        fluid.install_check.run_check()
    lines = buf.getvalue().splitlines()
    require(lines[-1] == "install check passed."
            and lines[-2].startswith("Your paddle_tpu_torch works well on"),
            f"o3: run_check printed {lines}")
    log(f"  run_check in {time.perf_counter() - t0:.1f} s: {lines} [{card}]")
    return {"lines": lines}


def phase_o(torch, np, seed, card, out_dir, record, profile=False):
    paths, out = {}, {}
    log("phase o1: ResNet-50 through auto_nhwc, float32, fused Momentum")
    paths["resnet_nhwc"], out["o1"] = nhwc_momentum(
        torch, np, seed, card, out_dir, record.get("resnet"), profile)
    torch.cuda.empty_cache()
    log("phase o2: ResNet-50 through auto_nhwc under bfloat16 AMP, fused "
        "Adam")
    paths["resnet_nhwc_amp"], out["o2"] = nhwc_amp(
        torch, np, seed, card, out_dir, record.get("resnet_amp"), profile)
    torch.cuda.empty_cache()
    log("phase o3: install_check.run_check() on the card")
    out["o3"] = run_check_on_card(card)
    return paths, out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the build log and chip_smoke.json")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serving runs (phases 3, 3b, 7a int8, "
                    "7b), two training steps (phases 4, 6, 8, 9, c1, d4, "
                    "e1, e2; e2's grouped convolutions' share too) and g2's "
                    "train_from_dataset epochs with torch.profiler and "
                    "print device time by kernel group and the idle share")
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="phases to run after the build (a debugging aid: "
                    "only a run of all of them prints the result line)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    log("phase 0: environment")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    log("phase 1: build")
    _build.build(verbose=True)
    info = _build.last_build()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_build.log"), "w") as f:
        f.write(str(info["log"]))
    _build.library()
    log(f"  built {os.path.basename(str(info['path']))} in "
        f"{info['seconds']:.2f} s (log in {args.out}/kernel_build.log)")

    record = {"card": card}
    log(f"  depths: phase 5's 2-layer GPT and BERT {CARD_VS_CPU_STEPS} steps, "
        f"phase a's spec runs {SPEC_PROMPTS} prompts, b1 {RESNET_REQUESTS} "
        f"requests, b2 {LM_PROGRAM_LAYERS} layers, d {MOE_LAYERS} layers, "
        f"f1-f3 {F_PROMPTS} prompts; c2's reference and h2 (e)'s killed "
        "world run beside the other run")
    # the seconds each phase took (since the previous mark)
    phase_s, t_mark = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    rows = {}
    if "2" in args.phases:
        log("phase 2: kernels vs plain")
        gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
        checks = (("layer_norm", check_layer_norm),
                  ("ragged_paged_attention",
                   lambda torch_, K_, dt_, gen_: check_ragged(
                       torch_, np, K_, dt_, gen_, args.seed)),
                  ("layer_norm_bwd", check_layer_norm_bwd),
                  ("softmax_xent", check_softmax_xent),
                  ("fused_adam_update", check_fused_adam))
        for dt in ("float32", "bfloat16"):
            for name, check in checks:
                out = check(torch, K, dt, gen)
                if name == "softmax_xent":
                    rows.setdefault("softmax_xent_fwd", {})[dt] = out[0]
                    rows.setdefault("softmax_xent_bwd", {})[dt] = out[1]
                else:
                    rows.setdefault(name, {})[dt] = out
        rows.update(check_flash(torch, np, K, gen, args.seed))
        qmm, rows["quantized_matmul_fma"] = check_quant_matmul(torch, K, gen)
        rows["quantized_matmul"] = {m: qmm[f"{m}_qkv"] for m in
                                    ("int8", "int8_block", "fp8")}
        rows["ragged_paged_attention_q"] = {
            "float32": check_ragged_q(torch, np, K, gen, args.seed)}
        rows["batched_lora_add_"] = check_lora(torch, K, gen)
        rows["fused_momentum_update"] = {
            "float32": check_fused_momentum(torch, K, gen)}
        rows["paged_attention"] = check_paged_attention(torch, np, K, gen,
                                                        args.seed)
        record["kernels"] = rows
        record["quantized_matmul_all_shapes"] = qmm
    # launches of each kernel on the main paths, read just after each
    paths = {}
    mark("2")
    if "3" in args.phases:
        log("phase 3: gpt3_1p3b served by the ragged engine")
        paths["serve"], record["serve"] = serve(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
        log("phase 3b: gpt3_1p3b served by the two_lane engine")
        paths["serve_two_lane"], record["serve_two_lane"] = serve_two_lane(
            torch, np, args.seed, card, args.out, record["serve"]["tokens"],
            profile=args.profile)
        torch.cuda.empty_cache()
    mark("3")
    if "4" in args.phases:
        log("phase 4: gpt3_1p3b trained by the Executor")
        paths["train"], record["train"] = train(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
        log("phase 4: gpt3_1p3b with flash attention trained by the Executor")
        paths["train_flash"], record["train_flash"] = train(
            torch, np, args.seed, card, args.out, profile=args.profile,
            steps=5, flash=True)
        torch.cuda.empty_cache()
    mark("4")
    if "5" in args.phases:
        record["card_vs_cpu"] = {}
        for model, what in (("gpt", "gpt3_1p3b-width GPT"),
                            ("gpt_flash", "gpt3_1p3b-width GPT, flash"),
                            ("bert_amp_flash",
                             "BERT-large-width BERT, flash, bfloat16 AMP")):
            log(f"phase 5: a 2-layer {what}, card against CPU")
            record["card_vs_cpu"][model] = card_vs_cpu(torch, np, args.seed,
                                                       model)
        log("phase 5: a 2-layer gpt3_1p3b-width GPT, int8 weights, int8 KV, "
            "two adapters: one ragged step, card against CPU")
        record["card_vs_cpu"]["quantized_adapters"] = card_vs_cpu_quantized(
            torch, np, args.seed)
        torch.cuda.empty_cache()
        log("phase 5: ResNet-50 at full depth and width, batch 4, 3 Momentum "
            "+ L2Decay steps, card against CPU")
        record["card_vs_cpu"]["resnet50"] = card_vs_cpu_resnet(torch, np,
                                                               args.seed)
        torch.cuda.empty_cache()
        log("phase 5: the two-bottleneck ResNet under bfloat16 AMP, one Adam "
            "step, card against CPU")
        record["card_vs_cpu"]["resnet_amp"] = card_vs_cpu_resnet_amp(
            torch, np, args.seed)
        torch.cuda.empty_cache()
        log("phase 5: a 2-layer gpt3_1p3b-width GPT, two_lane prefill and 3 "
            "decode steps, card against CPU")
        record["card_vs_cpu"]["two_lane"] = card_vs_cpu_two_lane(torch, np,
                                                                 args.seed)
        torch.cuda.empty_cache()
        log(f"phase 5: a 2-layer gpt3_1p3b-width switch-MoE GPT "
            f"({MOE_CHECK_EXPERTS} experts a layer), one Lookahead(Adam) "
            "step at k 1 with an EMA, card against CPU")
        record["card_vs_cpu"]["moe_lookahead_ema"] = card_vs_cpu_moe(
            torch, np, args.seed)
        torch.cuda.empty_cache()
        log("phase 5: While, Switch and cond, card against CPU")
        record["card_vs_cpu"]["control_flow"] = card_vs_cpu_control_flow(
            torch, np)
        log("phase 5: LeNet under quantization-aware training, 3 fused Adam "
            "steps, card against CPU")
        record["card_vs_cpu"]["lenet_qat"] = card_vs_cpu_lenet_qat(
            torch, np, args.seed)
        log("phase 5: the new unary ops through fc(act=...), the reduce "
            "family and the tensor ops, forward and x@GRAD, card against CPU")
        record["card_vs_cpu"]["everyday_ops"] = card_vs_cpu_everyday_ops(
            torch, np, args.seed)
        log("phase 5: the CI-sized SE-ResNeXt, 2 fused Momentum steps, card "
            "against CPU")
        record["card_vs_cpu"]["se_resnext"] = card_vs_cpu_se_resnext(
            torch, np, args.seed)
        torch.cuda.empty_cache()
    mark("5")
    if "6" in args.phases:
        log("phase 6: BERT-large pretrained under bfloat16 AMP with flash "
            "attention")
        paths["bert"], record["bert"] = train_bert(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
    mark("6")
    if "7" in args.phases:
        base = record.get("serve", {}).get("tokens")
        qpaths, record["serve_quantized"] = serve_quantized(
            torch, np, args.seed, card, args.out, base, profile=args.profile)
        paths.update(qpaths)
        torch.cuda.empty_cache()
    mark("7")
    if "8" in args.phases:
        log("phase 8: ResNet-50 trained by fused Momentum with L2 decay, "
            "batch 64 x 224^2")
        paths["resnet"], record["resnet"] = train_resnet(
            torch, np, args.seed, card, args.out, profile=args.profile)
        torch.cuda.empty_cache()
    mark("8")
    if "9" in args.phases:
        log("phase 9: ResNet-50 trained under bfloat16 AMP by fused Adam, "
            "batch 64 x 224^2")
        paths["resnet_amp"], record["resnet_amp"] = train_resnet_amp(
            torch, np, args.seed, card, args.out, profile=args.profile,
            fp32=record.get("resnet"))
        torch.cuda.empty_cache()
    mark("9")
    if "a" in args.phases:
        log("phase a: gpt3_1p3b served with speculative decoding")
        spaths, record["spec"] = serve_spec(
            torch, np, args.seed, card, args.out,
            record.get("serve", {}).get("tokens"))
        paths.update(spaths)
        torch.cuda.empty_cache()
        log("phase a: gpt3_1p3b served over the radix prefix cache")
        rpaths, record["radix"] = serve_radix(torch, np, args.seed, card,
                                              args.out)
        paths.update(rpaths)
        torch.cuda.empty_cache()
    mark("a")
    if "b" in args.phases:
        log("phase b: Programs saved and served over HTTP")
        bpaths, record["http"] = serve_http(
            torch, np, args.seed, card, args.out,
            record.get("serve", {}).get("tokens"),
            record.get("serve", {}).get("step_ms_mean"))
        paths.update(bpaths)
        torch.cuda.empty_cache()
    mark("b")
    if "c" in args.phases:
        try:
            log("phase c1: BERT-large under AMP + Lamb + warmup/decay, "
                "supervised, checkpointed and resumed in process")
            paths["bert_lamb"], record["bert_lamb"] = train_bert_lamb(
                torch, np, args.seed, card, args.out, record.get("bert"),
                profile=args.profile)
            torch.cuda.empty_cache()
            log(f"phase c2: {C2_LAYERS}-layer BERT-large width, killed at "
                f"step {C2_KILL} and resumed across processes")
            record["killed_resumed"] = killed_and_resumed(np, args.seed,
                                                          card)
        finally:
            shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    mark("c")
    if "d" in args.phases:
        dpaths, record["phase_d"] = phase_d(torch, np, args.seed, card,
                                            args.out, args.profile)
        paths.update(dpaths)
        torch.cuda.empty_cache()
    mark("d")
    if "e" in args.phases:
        epaths, record["phase_e"] = phase_e(torch, np, args.seed, card,
                                            args.out, args.profile)
        paths.update(epaths)
        torch.cuda.empty_cache()
    mark("e")
    if "f" in args.phases:
        log("phase f: gpt3_1p3b served split through a page store, behind "
            "the traffic tier, and a worker pool")
        fpaths, record["phase_f"] = phase_f(torch, np, args.seed, card,
                                            args.out, record)
        paths.update(fpaths)
        torch.cuda.empty_cache()
    mark("f")
    if "g" in args.phases:
        log("phase g: the data tiers")
        gpaths, record["phase_g"] = phase_g(torch, np, args.seed, card,
                                            args.out, args.profile)
        paths.update(gpaths)
        torch.cuda.empty_cache()
    mark("g")
    if "h" in args.phases:
        hpaths, record["phase_h"] = phase_h(torch, np, args.seed, card,
                                            args.out, record)
        paths.update(hpaths)
        torch.cuda.empty_cache()
    mark("h")
    if "i" in args.phases:
        log("phase i: tensor, sequence and pipeline parallelism, a world of "
            "2 on one card over gloo")
        ipaths, record["phase_i"] = phase_i(torch, np, args.seed, card,
                                            args.out)
        paths.update(ipaths)
        torch.cuda.empty_cache()
    mark("i")
    if "j" in args.phases:
        log("phase j: recurrence and sequences (seq2seq trained and "
            "beam-decoded, the book's LSTM and CRF models, DynamicRNN)")
        jpaths, record["phase_j"] = phase_j(torch, np, args.seed, card,
                                            args.out)
        paths.update(jpaths)
        torch.cuda.empty_cache()
    mark("j")
    if "k" in args.phases:
        log("phase k: the imperative mode (the dygraph ResNet-50 twin, "
            "TracedLayer, every dygraph.nn class, DataParallel)")
        kpaths, record["phase_k"] = phase_k(torch, np, args.seed, card,
                                            args.out)
        paths.update(kpaths)
        torch.cuda.empty_cache()
    mark("k")
    if "l" in args.phases:
        log("phase l: detection (SSD300 at 21 classes trained and decoded, "
            "DetectionMAP, the detection lowerings and the proposal chain)")
        lpaths, record["phase_l"] = phase_l(torch, np, args.seed, card,
                                            args.out)
        paths.update(lpaths)
        torch.cuda.empty_cache()
    mark("l")
    if "m" in args.phases:
        log("phase m: the rest of the layer surface (the new lowerings card "
            "against CPU, a CycleGAN ResNet generator trained, the heavy "
            "ops timed)")
        mpaths, record["phase_m"] = phase_m(torch, np, args.seed, card,
                                            args.out)
        paths.update(mpaths)
        torch.cuda.empty_cache()
    mark("m")
    if "n" in args.phases:
        log("phase n: the serving Programs at gpt3_1p3b's width, the fused "
            "inference ops, the parameter server (DeepFM at 2^25 rows, "
            "launch_ps processes)")
        npaths, record["phase_n"] = phase_n(torch, np, args.seed, card,
                                            args.out)
        paths.update(npaths)
        torch.cuda.empty_cache()
    mark("n")
    if "o" in args.phases:
        log("phase o: ResNet-50 through the NCHW -> NHWC pass (auto_nhwc), "
            "float32 and bfloat16 AMP; install_check on the card")
        opaths, record["phase_o"] = phase_o(torch, np, args.seed, card,
                                            args.out, record, args.profile)
        paths.update(opaths)
        torch.cuda.empty_cache()
    mark("o")
    record["phase_seconds"] = phase_s
    log(f"seconds a phase: {phase_s} [{card}]")
    launches = {name: {p: c.get(name, 0) for p, c in paths.items()}
                for name in K.KERNELS}
    record["launches"] = launches
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)

    log("summary: kernels at the main paths' shapes (launches: phases 3, "
        "3b, 4, 6, 7, 8, 9, a, b, c1, d, e, f, g, h, i, j, k, l, m, n and "
        "o)")
    for name, by_dt in rows.items():
        for key, row in by_dt.items():
            dt = "bfloat16" if "bfloat16" in key else "float32"
            log(f"  {name} {key}: {fmt(row, dt)} launches={launches[name]} "
                f"[{card}]")
    if args.phases != ALL_PHASES:
        log(f"phases {args.phases} only: no result line")
        return 0

    def entry(name, src, replaces, key="float32", label=None, path=None):
        row = rows[name][key]
        return {"name": label or name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": (launches[name][path] if path else
                             sum(launches[name].values())),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bound_rate": row.get("bound_rate", RATE_NAMES[
                    "bfloat16" if "bfloat16" in key else "float32"]),
                "library_ms": row["library_ms"]}

    csrc = "paddle_tpu_torch/kernels/csrc/"
    kernels = [
        entry("layer_norm", csrc + "layer_norm.cu",
              "paddle_tpu/kernels/layer_norm.py:117"),
        entry("ragged_paged_attention", csrc + "ragged_paged_attention.cu",
              "paddle_tpu/kernels/ragged_paged_attention.py:184"),
        entry("layer_norm_bwd", csrc + "layer_norm.cu",
              "paddle_tpu/kernels/layer_norm.py:155"),
        entry("softmax_xent_fwd", csrc + "softmax_xent.cu",
              "paddle_tpu/kernels/softmax_xent.py:94"),
        entry("softmax_xent_bwd", csrc + "softmax_xent.cu",
              "paddle_tpu/kernels/softmax_xent.py:127"),
        entry("fused_adam_update", csrc + "fused_optim.cu",
              "paddle_tpu/kernels/fused_optim.py:134"),
        # the gpt3_1p3b float32 row (phase 4's shape); the BERT-large row
        # and the bfloat16 rows are in chip_smoke.json and the log
        entry("flash_attention_fwd", csrc + "flash_attention.cu",
              "paddle_tpu/kernels/flash_attention.py:169", "gpt3_1p3b"),
        entry("flash_attention_bwd", csrc + "flash_attention.cu",
              "paddle_tpu/kernels/flash_attention.py:641", "gpt3_1p3b"),
        # K11 at the qkv shape [128, 2048] x [2048, 6144], one row per
        # mode with the launches of that mode's phase 7a run (int8: every
        # phase 7 path); the other shapes are in chip_smoke.json
        entry("quantized_matmul", csrc + "quant_matmul.cu",
              "paddle_tpu/kernels/quant_matmul.py:231", "int8"),
        entry("quantized_matmul", csrc + "quant_matmul.cu",
              "paddle_tpu/kernels/quant_matmul.py:231", "int8_block",
              "quantized_matmul_int8_block", "serve_int8_block"),
        entry("quantized_matmul", csrc + "quant_matmul.cu",
              "paddle_tpu/kernels/quant_matmul.py:231", "fp8",
              "quantized_matmul_fp8", "serve_fp8"),
        # the FMA kernel for an int8_block block that is not a multiple
        # of 16, at qkv and block 100, launches of its phase 7a run
        entry("quantized_matmul_fma", csrc + "quant_matmul.cu",
              "paddle_tpu/kernels/quant_matmul.py:231",
              f"int8_block_b{ODD_BLOCK}", path=f"serve_int8_block_b{ODD_BLOCK}"),
        entry("ragged_paged_attention_q", csrc + "ragged_paged_attention.cu",
              "paddle_tpu/kernels/ragged_paged_attention.py:184"),
        # K12 at ffn1 [128, 2048] -> 8192, ranks 8 and 16, rotated inputs
        # (the other targets' rows are in chip_smoke.json)
        entry("batched_lora_add_", csrc + "lora.cu",
              "paddle_tpu/kernels/lora.py:168", "ffn1"),
        # K10m at ResNet-50's largest parameter [512, 512, 3, 3], launches
        # of phase 8
        entry("fused_momentum_update", csrc + "fused_optim.cu",
              "paddle_tpu/kernels/fused_optim.py:117", path="resnet"),
        # K13 at the two_lane decode shape, float32, launches of phase 3b
        entry("paged_attention", csrc + "paged_attention.cu",
              "paddle_tpu/kernels/paged_attention.py:104",
              path="serve_two_lane"),
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on a main path")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--c2-child"]:
            sys.exit(c2_child(sys.argv[2:]))
        if sys.argv[1:2] == ["--h2-child"]:
            sys.exit(h2_child(sys.argv[2:]))
        if sys.argv[1:2] == ["--h2-elastic"]:
            sys.exit(h2_elastic_child(sys.argv[2:]))
        if sys.argv[1:2] == ["--i-child"]:
            sys.exit(i_child(sys.argv[2:]))
        if sys.argv[1:2] == ["--k4-child"]:
            sys.exit(k4_child(sys.argv[2:]))
        if sys.argv[1:2] == ["--n4-child"]:
            sys.exit(n4_child(sys.argv[2:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
