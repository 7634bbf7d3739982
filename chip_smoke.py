#!/usr/bin/env python3
"""The quickest proof that the PyTorch port (bigdl_tpu_torch) runs on an
NVIDIA GPU. Run from the root of a checkout, with one card:

    python3 chip_smoke.py

1. Setup: prints the card, its power limit, the torch and CUDA versions,
   and builds every CUDA kernel of the port from ``bigdl_tpu_torch/ops/
   csrc`` into ``build/`` (nvcc, one process per source, in parallel).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it, with device times
   (CUDA-graph replays, so no host launch overhead): the kernel, the plain
   version, the library call that computes the same function (a yardstick
   the port never calls) and the bound (the least time the card could
   take: bytes over 3.35 TB/s or operations over the peak rate of their
   type, whichever is larger, over the score entries the causal mask and
   the segments leave live). The forward at 15 shapes (ragged s, s_q <
   s_k, d = 64 and 128, ``segments`` from ``packed_segments``, s = 4096,
   non-causal at the training shape, 16 x 16 heads of 512),
   each row naming the kernel the shape rule of ``csrc/flash_fwd.cu``
   picks; the backward pair (``flash_dq``, ``flash_dkv``) and the forward
   with ``segments`` at 6, with ``_delta`` (plain PyTorch) timed beside
   the pair: the library's backward computes its own delta, so pair plus
   delta is the like-for-like figure. At the training step's shape the forward
   and the pair each run twice and must give the same bits. ptxas's
   registers and spills of the Hopper kernels (forward and backward) print
   after the build.
3. Training at full width through ``cli.perf.run``:
   ``transformer_lm_1k_hd128`` in bf16, batch 8, 2 warm-up and 5 timed
   SGD steps on one resident batch: the loss is finite and falls, and each
   step launches exactly 12 ``flash_fwd``, 12 ``flash_dq`` and 12
   ``flash_dkv`` (24 ``flash_fwd`` with ``remat="full"``, a second run).
4. One step's parameter gradients through the kernels against the same
   step with each layer's attention swapped for a Function of the plain
   versions: bf16 at full width, f32 at 2 layers.
5. ``cli.transformerlm train --flash --bf16`` at full width on a Zipf
   corpus written here from a seed, once plain and once ``--packed``: the
   ``Train ... Loss is`` lines, a finite held-out NLL (its exp, the
   perplexity, overflows at this width after a few steps), and
   backward-kernel launches (with segments in the packed run).
6. The serving path at full width: ``transformer_lm_1k_hd128`` (12 layers
   of 1024, 8 heads of 128, 2 KV heads, RoPE, 32000 tokens), random
   weights from a seed, built by ``cli.serve.build_app`` and served over
   HTTP from a thread, once in f32 and once with ``--bf16``: four
   concurrent greedy ``/generate`` requests, one ``/predict``,
   ``/healthz``, ``/readyz`` and ``/metrics``; the decode step, every
   prefill bucket and every ``/predict`` (batch, length) bucket replay
   CUDA graphs captured at start-up. Checked: every answer is 200; the
   prefill logits through the kernel match those through the plain
   version on the card; the kernel's launch count over the traffic
   (replays credited) is at least 12 x (prefills + /predict batches); a
   ``/predict`` of 40-token rows (padded to 64) adds no graph to the 3 x 7
   captured; in f32, each ``/generate`` equals the offline
   ``TransformerLM.generate`` and each ``/predict`` the offline forward.
7. The four BN kernels (``bn_stats``, ``bn_bwd_stats``, ``bn_fwd_apply``,
   ``bn_bwd_fused``) against their plain versions at ResNet-50's batch-128
   shapes (the stem's 1605632 x 64 rows x channels, 401408 x 256, 100352 x
   512, 6272 x 2048) and a ragged 1000 x 100, bf16 and f32, ReLU on and off
   for the fused pair: max|d|/max|ref| of every output, kernel, plain and
   library ms (``torch.batch_norm_stats``, ``batch_norm_backward_reduce``,
   ``batch_norm`` and ``native_batch_norm_backward`` on the channels_last
   4-D view; the port never calls them) and the bound (the bytes each
   must move over 3.35 TB/s). Each kernel is one cooperative launch
   (``bn_coop_kernel`` in four modes) and must also give the same bits on
   a second call and on a CUDA-graph replay of the call, at every shape;
   ptxas's registers, shared memory and spills of every instance print
   after the build.
8. ResNet-50 training at full width through ``cli.perf.run``, bf16, batch
   128, random images from ``RandomState(0)``, 2 warm-up and 5 timed
   SGD(0.01, momentum 0.9) steps, once each as ``resnet50_fba``,
   ``resnet50_fbn`` and ``resnet50``: finite losses, images/s, and exactly
   53 ``bn_fwd_apply`` + 53 ``bn_bwd_fused`` a step (``_fba``), 53
   ``bn_stats`` + 53 ``bn_bwd_stats`` (``_fbn``), none (``resnet50``).
9. One training step through the BN kernels against the same step
   through their plain versions, both fused modes: ``resnet_cifar(20)``
   f32 (loss, every parameter gradient, running statistics), and
   ResNet-50 bf16 at batch 32 (the loss, and each of its 53 BNs on the
   input and gradient it met in the step: y, dx, dγ, dβ, running
   statistics). ResNet-50's whole-step gradients are printed beside the
   same step with the plain versions' BN sums taken in f64, a yardstick
   of how far rounding alone moves them.
10. ``cli.resnet train --dataset cifar10 --fusedBN apply
   --stepsPerDispatch 4 --checkpoint DIR`` on CIFAR-10 binary files
   written here from a seed: the ``Train ... Loss is`` lines, a ``top1
   accuracy`` line, 19 launches of each fused kernel an iteration (graph
   replays included), and ``cli.resnet test --model DIR`` printing the
   same top-1 line as the training run's last validation.
11. ``cli.perf`` with ``inner_steps`` = 4 (each iteration one replay of a
   CUDA graph of 4 steps on the resident batch): ResNet-50 ``_fba`` and
   ``_fbn`` (bf16, batch 128) and ``transformer_lm_1k_hd128`` (bf16, batch
   8, remat off and ``full``): images/s or tokens/s, finite falling
   losses, and each kernel's launches exactly per-step x steps.
12. The training loop (``Optimizer``) eager twice and graphed once
   (``steps_per_dispatch=4``): ResNet-50 ``_fba`` with bf16
   ``compute_dtype`` at batch 128 over 8 seeded batches for 16 steps, and
   ``resnet_cifar(20)`` f32 ``--fusedBN apply`` over 10 batches for 20
   steps (dispatch groups, ragged tails, an epoch boundary); SGD(0.01,
   momentum 0.9) with a Poly schedule. Every step's loss (written on the
   device by the criterion, so graph replays record theirs), images/s and
   BN launches (exactly the BNs x steps). cuDNN runs its deterministic
   algorithms in this phase and the next, so the two eager runs agree bit
   for bit, and the graphed losses may differ from the eager ones by no
   more than that.
13. Checkpoint and resume on the card, graphed: for ``resnet_cifar(20)``
   f32 and ResNet-50 ``_fba`` bf16, a run of 16 steps; a run stopped at 4
   that checkpoints every 4 (keep_last=1); a second ``Optimizer`` that
   resumes from that directory (its graph captured after the load) and
   runs to 16. Its losses must be the uninterrupted run's, bit for bit.

14. Paged serving at full width, f32 and bf16, after phase 6: ``cli.serve
   --slots 16 --kvPageTokens 128 --prefixCache`` over HTTP, graphed; a
   primer request leaves a 256-token prefix in the cache, then 16
   concurrent ``/generate`` (prompts of 8 to 700 tokens, half of them
   that prefix plus under a page, every other one sampled at temperature
   0.8, top_k 40, top_p 0.9 with its own seed) and one ``/predict``.
   Checked: 8 prefix hits; ``flash_fwd`` launches, replays included, at
   least 12 x (full prefills + /predict batches); ``kv_pages_in_use`` back
   to the prefix cache's pages once traffic ends; sampled requests sent
   again draw the same tokens; the same traffic through a ``DecodeEngine``
   of the server's route gives the server's tokens, graphed and eager;
   each prefix hit's first logits equal its miss's within ``LOGIT_TOL``
   of max|logit| (the prefill check's bound); against a dense engine
   (every prefill a miss), and in f32 against the offline ``generate``,
   a token may differ only at a prefix hit, and only where the decision
   taken again from each route's measured logits (warped and noised when
   sampled) differs between the two routes (printed). Then the decode
   step at 16
   slots, dense and paged, eager and graphed (``tools/profile_decode``'s
   rows): host-clock ms, generated tokens/s, device ms, busy share and
   kernels a step, with the card's name and power limit.

15. The input pipeline on the card. (a) The native library (the port's
   copy of ``bigdl_native.cpp``) built with ``g++`` into ``build/native/``,
   its flavour printed (with or without libjpeg). (b) ``cli.resnet train
   --dataset cifar10 --fusedBN apply --stepsPerDispatch 4`` for 2 epochs
   (20 steps) on the seeded CIFAR files of phase 10, augmented by the
   native pipeline, with ``--stage off``, ``host`` and ``device`` each at
   ``--dataWorkers 0`` and ``4``: with cuDNN deterministic every run's 20
   losses are the first run's, bit for bit, and each fused BN kernel
   launches exactly 19 times a step. (c) ResNet-50 ``_fba`` in bf16 at
   batch 128 through ``Optimizer(steps_per_dispatch=4)``, graphed, fed by
   ``NativePrefetchDataSet`` over 1024 seeded uint8 images of 256 x 256 x
   3 (random crop 224, flip, ``IMAGENET_MEAN/STD``, 8 threads) wrapped
   with ``--stage host`` and ``device``, for 3 epochs of 8 batches (6
   before phase 25 pushed the script past 1000 s): the
   feed's own images/s (no model, after a warm-up epoch; native alone and
   behind each staging mode), the loop's images/s over epochs 2-3 (one sync, at the end: the
   loop runs ahead across epochs) and its data_wait, h2d and h2d_staged
   seconds per mode, beside the same loop over 8 batches
   already on the card and ``cli.perf``'s graphed step on a resident
   batch (``--innerSteps 4``), all in cuDNN's default mode (the resident
   step also in its deterministic mode, phase 12's); finite losses and
   exactly 53 launches of each fused BN kernel a step. (d) The record
   path: seeded JPEG shards (512 images of 256 x 256, written with PIL
   where there is PIL, else the phase is reported as waiting) through
   ``cli.perf -m resnet50_fba --data record:DIR --dataWorkers 8 --stage
   device``: the executor's workers decode (libjpeg where the library has
   it, else PIL) and augment, the staging thread copies to the card;
   images/s, finite losses, 53 launches of each fused kernel a step.

16. Speculative and quantized serving at full width, after phase 14:
   ``cli.serve --bf16 --slots 16 --kvPageTokens 128 --prefixCache`` over
   HTTP, graphed, with phase 14's primer, 16 requests and /predict, the
   LM's embedding x0.02 before the build (phase 14's weights, so the
   quality report sees them), once each with ``--speculate 4``
   (self-draft), ``--speculate 4 --draftDims 256,2,2`` (a seeded 2-layer
   draft of head dim 128: its prefills run ``flash_fwd_sm90`` too) and
   ``--quantize int8``, ``fp8``, ``int8+kv8``, ``fp8+kv8``. Checked: every
   answer is 200; ``flash_fwd`` launches at least 12 x (full prefills +
   /predict batches) + the draft's layers x installs; finite logits;
   speculative greedy requests equal phase 14's bf16 tokens and the
   self-draft accepts every proposal; the served tokens equal the same
   traffic through a ``DecodeEngine`` of the server's route, graphed and
   eager (``graphs=False``); a kv8 pool of a 384-token prompt's rows,
   gathered back, is bit for bit ``kv_fake_quant`` of them. Printed:
   accept rate, target dispatches a generated token, draft steps,
   ``quant_agreement`` and ``quant_logit_max_err``, weight bytes and KV
   bytes a full slot, and a decode-rate table (16 greedy requests of 64
   prompt and 24 new tokens, graphed: ms a step or round, decode
   tokens/s) of the plain engine beside each run, with the card's name
   and power limit.

17. BASELINE configs 1 and 2 through their CLIs, after phase 16:
   ``cli.lenet train -b 128 --maxEpoch 2 --checkpoint DIR`` on MNIST-sized
   idx files written here from a seed (60000 and 10000 class-banded 28 x
   28 images), then ``cli.lenet test --model DIR``: finite falling
   losses, Top-1 of at least 0.5 and equal to the training run's last
   validation, images/s of each epoch. ``cli.vgg train -b 128 --maxEpoch
   1`` (``vgg_for_cifar10`` at full width, f32) on 10000 class-banded
   seeded CIFAR records, once with ``--fusedBN apply`` and once with
   ``stats``, the counts set to 0 just before each run: finite falling
   losses and exactly 14 launches a step of each of the mode's two BN
   kernels (added to the kernels line's launches). The four BN kernels
   against their plain versions at VGG's six (rows, C) shapes at batch
   128, 131072 x 64 down to the 2-D BN's 128 x 512, as in phase 7, each
   timed over a replay of 10 calls, twice (``BN_TIMING_LIGHT``; phase 7's
   3 replays of 20). ``cli.perf -m lenet5`` and ``-m vgg16``, bf16 batch 32: finite losses,
   images/s. Each rate line carries the card's name and power limit.

18. BASELINE config 4, after phase 17: ``cli.inception train -b 32
   --maxEpoch 1`` on a seeded class-banded JPEG folder written here with
   PIL (10 classes of 32 training and 8 validation 256 x 256 images) as
   ``inception_v1``, and as ``inception_v2`` with ``--fusedBN apply`` and
   ``stats``, the counts set to 0 just before each run: finite losses,
   exactly 57 launches a step of each of the mode's two BN kernels (none
   for v1; added to the kernels line's launches), images/s, and
   ``cli.inception test --model`` on each run's checkpoint printing its
   last validation's Top-1 and Top-5 lines. AlexNet at 1000 classes from
   a seeded ``.caffemodel`` of the real blob shapes (~244 MB, written
   here on a thread beside phase 17) through ``cli.loadmodel --modelType caffe`` on that val folder,
   then exported with ``save_torch_module`` and run as ``--modelType
   torch``: the same Top-1 and Top-5 lines, images/s (load included),
   and on one fixed batch each import's logits on the card within
   ``ALEXNET_LOGIT_TOL`` of max|logit| of the CPU forward. The four BN
   kernels against their plain versions at the 33 (rows, C) shapes that
   forward hooks collect from Inception-v2's 57 BNs at batch 32 (401408
   x 64 down to 1568 x C, C from 16 to 384), as in phase 7, timed as
   phase 17's.
   ``cli.perf
   -m inception_v1``, ``-m inception_v2 --fusedBN apply`` (57 launches a
   step of each fused kernel) and ``-m alexnet`` (227 x 227), bf16 batch
   32: finite losses, images/s.

19. The rest of the ResNet slice, after phase 18. (a) MFU: ``cli.perf``
   rows ``resnet50_fba``, ``resnet50_s2d --fusedBN apply``,
   ``resnet50_bnss --fusedBN apply`` (its stat-sampled BNs take no
   kernel) at batch 128 and ``transformer_lm_1k_hd128`` at batch 8, bf16,
   ``--innerSteps 4`` (``resnet50_fba`` and the LM through ``cli.perf``'s
   main with ``--lint strict``: phase 30 (b)): images/s or tokens/s, the
   analytic step count and its split, ``mfu`` against the matched peak,
   exact launches; gated 0 < mfu <= 1, a matched peak, the count equal to
   a fresh build's at the same batch (counted on the CPU in a process of
   its own beside phase 18), ResNet-50's 20-32 GF an image. (b) The
   conv layout policy: ``resnet50_fba`` at batch 128 under
   ``--convLayout default``, ``NHWC,NHWC,NCHW``, ``NCHW,NCHW,NCHW`` and
   ``GEMM,GEMM,GEMM``, 4 eager steps and 6 graphed: images/s, the first 3
   losses, 53 launches a step of each fused BN kernel, each first loss
   within ``POLICY_LOSS_TOL`` of the default's and the graphed losses at
   steps 2 and 4 within it of the eager ones; then ``tools/conv_probe.py --geom`` at ResNet-50's shapes
   (its rows printed) and ``resnet50_fba`` under ``--convGeom`` that
   file. (c) The s2d stem with ``weight_from_conv7(w7)`` against the
   7x7/2 pad-3 conv of ``w7`` at batch 128, bf16 and f32 (f32 within
   ``S2D_F32_TOL``); ``cli.resnet train --dataset imagenet --depth 50
   --s2d --fusedBN apply -b 32 --maxEpoch 1`` on phase 18's seeded JPEG
   folder (finite losses, 53 launches a step of each fused kernel), then
   ``test --s2d`` printing the run's last Top-1 and Top-5 lines. (d) Time
   to accuracy: ``cli.perf -m resnet20_cifar --timeToAcc 0.9 --imageSize
   32 --fusedBN apply -b 128 --maxEpoch 10`` (easy grade: reached, every
   curve point later than the one before), then ``--ttaHard
   --trainPerClass 300 --valPerClass 60 --valEvery 20 --maxEpoch 2`` on
   record shards the harness's own writer wrote on a thread beside phase
   18, given as ``--data record:DIR`` (its curve printed). The kernels line counts phase 19's launches too,
   and a line before it gives phase 19's BN launches by mode.

20. Data parallelism (``bigdl_tpu_torch.parallel``), after phase 19. (a)
   World size 1 over NCCL: a one-rank NCCL group (``init_distributed(...,
   backend="nccl")``), ``Optimizer(strategy=DataParallel(...))`` (ZeRO-1
   on, compression off) for 3 eager steps of ResNet-50 ``_fba`` bf16 at
   batch 128 beside the same run without a strategy, cuDNN
   deterministic: the losses equal bit for bit, 53 launches a step of
   each fused BN kernel, and the strategy run's step ms and images/s.
   (b) Two ranks on the one card over gloo (``parallel.launch.spawn``,
   ``init_distributed(backend="gloo")``, a time limit that kills the
   group): ``resnet_cifar(20)`` f32 ``--fusedBN apply`` at global batch
   128 (64 a rank), 3 steps of ``cli.perf``'s step, parameters and losses
   against one process on the same global batch within ``DP_CIFAR_TOL``,
   and again with ``--gradCompress bf16`` (``wire_bytes * 2 ==
   wire_bytes_f32``, the last loss within 5% of f32); ``cli.perf.run(
   "resnet50_fba", 128, strategy="dp")`` bf16, 3 steps: exactly 53
   ``bn_stats`` and 53 ``bn_bwd_stats`` a step on each rank and none of
   the fused pair, finite losses, then each of the 53 synced BN layers'
   outputs in one forward against ``bn_fwd_apply`` on the global batch
   (rank 1's input and output broadcast to rank 0), one layer at a time,
   within ``BN_TOL``; ``cli.perf.run("transformer_lm_1k_hd128", 8,
   strategy="dp")`` bf16, 3 steps: 12 launches a step of each flash kernel
   on each rank, losses within ``DP_LM_TOL`` of phase 3's single process.
   Step ms and images/s or tokens/s with the card's name and power limit.
   (c) With two cards or more, ``torchrun --nproc_per_node N -m
   bigdl_tpu_torch.cli.perf -m resnet50_fba --strategy dp`` over NCCL and
   its JSON line; with one card, a line saying (c) did not run.

21. BASELINE config 5, the recurrent path, after phase 20; none of the
   port's seven kernels runs on it, and their counts must not move. (a)
   ``cli.textclassification -b 128 --maxEpoch 2`` at its defaults
   (``--sequenceLength 500 --maxWordsNum 5000 --embeddingDim 100``) on a
   seeded ``20news-18828`` tree of 20 classes of 100 documents of 500-700
   Zipf words, each class with its own band of topic words, beside a
   seeded ``glove.6B/glove.6B.100d.txt`` whose topic vectors cluster by
   class: finite falling losses, a last Top-1 >= ``TEXT_TOP1`` (0.2, 4x
   chance), records/s of each epoch. (b)
   ``cli.rnn train -b 128 --maxEpoch 1`` at its defaults (``--vocabSize
   4000 --seqLength 20 --hiddenSize 40``) on a seeded Zipf ``input.txt``
   of 50,000 words: finite falling losses and a finite ``perplexity
   is``
   line. (c) ``birnn_classifier`` and ``lstm_classifier`` (5002 ids, embed
   100, 128 a direction, 20 classes) on (a)'s ids (T = 500) through the
   Optimizer at batch 128, f32: the BiRNN for 6 steps eager and 12 as
   CUDA graphs of 2 steps (the graphed losses at steps 2, 4 and 6 within
   ``RNN_LOSS_TOL`` of the eager ones, the last below the first), the
   LSTM graphed; ms a step, records/s, the graphs' capture and
   instantiate seconds, and the CUDA kernels of one eager step
   (``torch.profiler``). (d) The BiRNN's ``BiRecurrent`` against cuDNN's
   bidirectional ``torch.nn.LSTM`` loaded with its weights (a yardstick
   the port never calls) on one batch: final states within ``RNN_TOL``
   of max|ref|, forward + backward ms of the port eager, the port as a
   CUDA graph and cuDNN. (e) ``utils.gradcheck.check_gradients`` on the
   card: ``birnn_classifier(50, 8, 16, 2)`` at T = 12 passes at the JAX
   defaults; ``simple_rnn(20, 16, 20)``'s gradient, cut every 2 steps,
   fails the full check (as in the JAX package) and matches central
   differences of the objective it truncates to. (f) ``cli.autoencoder
   train -b 128 --maxEpoch 1 --adagrad --learningRate 0.01`` on phase
   17's seeded MNIST files (finite falling losses, records/s), then
   ``LBFGS(max_iter=20, line_search=True)`` on the autoencoder's MSE over
   1024 images: every accepted iterate lowers the loss; ms an iteration.

22. The rest of the attention models, after phase 21. Kernels 1-3 at
   shapes no earlier phase launched, through ``check_flash`` and
   ``check_flash_bwd``: the long rows' attention (1 x 8 x 16384² and
   32768² x 128 causal, bf16) against twins run a chunk of 2048 query
   rows at a time (rows i..i+c see keys 0..i+c-1; an f32 score matrix
   takes 1 GB a head at 16k), and ViT's non-causal 196 tokens at (64, 6)
   and (64, 3) heads of 128 in bf16 and (64, 3) in f32; the first shape
   of each call twice gives the same bits; times, bounds and
   ``scaled_dot_product_attention``'s forward and backward. (a) ``cli.perf -m
   transformer_lm_16k`` (remat "dots") and ``-m transformer_lm_32k``
   ("full") at batch 1 in bf16, graphed (2 steps a replay) and eager over
   the same 4 steps: the graphed losses within ``LONG_LOSS_TOL`` of the
   eager ones at the same steps, exactly 24 ``flash_fwd`` (the forward
   runs again in each layer's backward), 12 ``flash_dq`` and 12
   ``flash_dkv`` a step, tokens/s, MFU and peak memory; the 16k row at
   full width and 2 layers with remat "dots" and "full" against none:
   the same loss, the gradients within ``LONG_GRAD_TOL`` of max|g|. (b)
   ``cli.perf -m vit_b16`` and ``-m vit_s16`` at batch 64, bf16,
   ``--innerSteps 4``: images/s, MFU, finite losses, 12 launches of each
   flash kernel a step. (c) A (b, s_k) key-padding mask through
   ``flash_attention`` at (4, 8, 8192, 128) bf16 takes
   ``blockwise_attention`` (block 512, no kernel launch), within
   ``KP_TOL`` of the dense path run 1024 query rows at a time; the peak
   memory of the blockwise forward below the dense one's (both printed,
   with the blockwise forward and backward). (d) ``Sequential(MoE,
   Linear, LogSoftMax)``, d 1024, 8 experts of Linear(d, 4d), ReLU,
   Linear(4d, d), top-2, capacity 2.0, 8 x 1024 tokens a step, through
   the ``Optimizer`` in bf16 with the auxiliary loss, eager and as CUDA
   graphs of 4 steps for 16 steps: every step's criterion loss graphed
   within ``MOE_LOSS_TOL`` of eager, the logged loss above it by 0.01 x
   the auxiliary loss, step ms. The launches of (a)'s and (b)'s
   ``cli.perf`` runs join the kernels line's; the 2-layer remat check's,
   driven by hand, do not.

23. The serving front, after phase 22: ``transformer_lm_1k_hd128`` in
   bf16, 16 slots of 128-token pages, ``--randomInit`` with phase 14's
   embedding x0.02. (a) One server in this process with ``--reqTrace on
   --slo FRONT_SLO --accessLog``: phase 14's 16 prompt lengths (8 to 700
   tokens) as 16 concurrent streamed ``/generate``, then the same 16
   buffered, greedy: every stream's frames concatenate to its buffered
   tokens bit for bit, each request's rid is echoed and the access log
   holds one finished line per request; TTFT p50/p99 (server-side, from
   the access log, and client-side: the first frame streamed, the whole
   answer buffered) and TPOT p50; a stream dropped after 2 frames is
   cancelled and ``kv_pages_in_use`` returns to its baseline; the same
   traffic on a ``--speculate 4`` server, streamed = buffered again. The
   flash launches of both join the kernels line. (c) ``python -m
   bigdl_tpu_torch.cli.fleet ... --fleet 2 --prefixCache`` as a
   subprocess on the same card, its workers loading a checkpoint of (a)'s
   weights (v0): the four prompts of at most a page, buffered and
   streamed through the router, equal (a)'s tokens; the router's added
   latency (direct to a worker against through the router, medians of
   ``ROUTER_REPS`` turns); each worker's boot time and peak memory; a
   SIGKILLed worker is restarted (``restarts`` 1 in ``/debug/fleet``,
   its restart time) while ``/readyz`` stays 200; ``/metrics`` carries
   ``worker="0"``/``"1"`` series and fleet totals. (d) With a prefix cached
   under v0 on each worker, a rolling swap (``POST /admin/reload``) to a
   checkpoint of seed 1 (v1) under ``SWAP_CLIENTS`` client threads: no
   5xx, every answer v0 or v1 and equal to (a)'s tokens on that version
   ((a)'s server swapped in place to v1, its graphed decode equal to an
   eager engine built on v1); after the swap the prompt sharing the
   cached prefix gives v1's tokens on both workers; the swap's length.
   (b) On (a)'s server: ``dispatch@request:2`` answers the 2nd request
   503 and the 3rd 200; ``worker_kill@infer:1`` answers the killed
   forward's /predict 500, then the watchdog's fast 503, ``/readyz`` 503
   and ``/healthz`` 200. The workers' launches are in their processes and
   are not counted.

24. The autotuner (``bigdl_tpu_torch.tuning``) on the card, after phase
   23, its cache in a fresh ``build/autotune_phase24``. (a) ``measure``:
   each namespace swept at the shapes the main paths give it, each
   candidate timed in device time over CUDA-graph replays (input copies
   rotated past the L2 where they fit in it): ``bn_stats`` and ``bn_fba``
   (through the kernels' own calls) at 401408 x 256, 6272 x 288 and 128 x
   512 bf16, ReLU on (and off at 401408 x 256, ResNet-50's stage-1 BNs
   before the sum); ``flash`` at the key-padded 1k shape; ``kv_pages``
   for the 1k LM's cache; ``quant`` at its prefill (512 rows) and decode
   (16 rows) products; ``grad_comm`` at one NCCL rank for ResNet-50's
   gradient; ``conv_geom`` at ResNet-50's 7x7/2 stem and a 1x1, each
   pass. Each key's decision, its ``best_ms`` and the default's ms print.
   (b) ``cached``: the same consultations replay every decision with
   source ``cached``, time nothing, and leave the file's bytes as they
   were; each BN kernel under its tuned plan matches its plain version
   within phase 7's tolerances (untuned and tuned ms printed). (c)
   ``serve resnet50 --classes 1000 --fusedBN apply --autotune cached
   --randomInit`` through ``cli.serve.build_app``, f32, over HTTP from a
   thread: /predict batches of 2 and 3 seeded images answer 200 with
   scores within ``LOGIT_TOL`` of max|score| of the offline eval forward,
   /healthz 200; graphs captured, build and warm-up seconds, peak memory.
   (d) ``cli.perf -m resnet50_fba`` bf16 batch 128 with ``--autotune
   off`` and then ``cached``: images/s, 53 launches a step of each fused
   BN kernel, and the second line's ``autotune`` naming the BN and conv
   keys it consulted (the tuned 401408 x 256 ReLU-off key among them).
   (e) An
   untied ``transformer_lm_1k_hd128`` (a ``head`` Linear, seeded,
   embedding x0.02) served in f32 over HTTP: greedy ``/generate`` equal to
   its offline ``generate``, its prefills through ``flash_fwd``. The
   launches of (d) and (e) join the kernels line's.

25. Recovery on the main path, after phase 24. (a) ResNet-50 ``_fba`` bf16
   batch 128, 4 steps a dispatch (graphed), 8 seeded batches for 16 steps,
   a checkpoint every 4, cuDNN deterministic: once without faults, then
   through ``cli.common.run_optimize`` under ``--supervise`` with
   ``RECOVERY_PLAN`` (``stall@data``, ``corrupt@ckpt_save`` on state.8 so
   that resume falls back a pair, ``dispatch@step``, ``io@ckpt_save``,
   ``preempt_soft@step``): four attempts resume at iterations 0, 4, 4 and
   8; each attempt's losses and the final parameters equal the fault-free
   run's bit for bit, the supervisor's events name every fault, each
   attempt launches the fused BN pair 53 times a step it ran, and the last
   attempt's peak memory is within 1.1x of the first's. (b)
   ``supervise_command`` around ``cli.resnet train --dataset cifar10
   --fusedBN apply --stepsPerDispatch 4 --checkpoint DIR --model DIR
   --supervise --faultPlan ...`` (children run cuDNN deterministic): a
   kill at a step, then one inside a checkpoint write, each child dying
   with exit code 75; the final ``model.<n>`` equals an uninterrupted
   child's bit for bit, ``BIGDL_FAULT_LOG`` lists both kills, ``test
   --model DIR`` prints the uninterrupted run's top-1 line; then
   ``tools.chaos_run --kills 2 --kill-in-ckpt`` on the card says equal.
   (c) (a)'s check for ``resnet_cifar(20)`` f32 ``--fusedBN apply`` with
   ``preempt_soft@step:3``, its snapshots on a ``file://`` path and then
   as DCP directories; ``serve resnet20_cifar --classes 10 --model <the
   DCP directory>``'s ``/predict`` scores against the eager forward of
   the trained weights. (d) The CIFAR CLI at 4 gloo ranks sharing the
   card (``parallel.launch.spawn``), ``--strategy dp --elastic hold``,
   then ``scale``, with ``kill_device@step:5:1``: rank 3 leaves with exit
   code 0, the job ends at 3 ranks with a reshape event (4 -> 3,
   ``restore_ms``, the bucket bytes), each step after it launches
   ``bn_stats`` and ``bn_bwd_stats`` once a BN on each rank, and its
   losses are within ``DP_CIFAR_TOL`` of one process on the same padded
   (129) or trimmed (126) global batches; with ``--minDevices 4`` every
   rank exits with the ``elastic:`` message. (e) ``cli.perf -m
   resnet50_fba --strategy dp`` at 4 gloo ranks, global batch 32, without
   a fault and then ``--elastic hold`` with ``kill_device@step:3:1``: the
   line carries ``reshape`` (4 -> 3) and ``supervisor``, finite losses,
   53 of each synced BN kernel a step on each rank; images/s before and
   after (its job starts when (b)'s end and runs beside (c) and (d)).
26. Tensor parallel and FSDP, after phase 25; the gloo jobs are 2 ranks
   sharing the card (``parallel.launch.spawn``). The kernels against
   their plain versions at the tp:2 per-rank geometry of
   ``transformer_lm_1k_hd128`` (4 query heads, 1 KV head expanded to 4,
   d = 128): ``flash_fwd`` bf16 and f32 at batch 8 x 1024 and 2 x 64,
   the backward pair at batch 8 x 1024. (a) ``serve --strategy tp:2`` at
   full width through ``cli.serve.build_app`` on each rank (rank 0 leads,
   rank 1 follows; the f32 server with ``--lint strict``, phase 30 (c)):
   in f32 the greedy /generate of 4 prompts equals a
   one-rank engine's token for token; in bf16 the /predict forward's
   logits differ from one rank's bf16 by at most 3x that one's own error
   against f32; each rank's ``flash_fwd`` launches and the head count and
   dim they ran at. (b) ``serve --strategy dp:2 --devices
   cuda:0,cuda:0`` in this process at seq 256, each replica its own CUDA
   graphs: 8 concurrent /generate equal the same prompts through replica
   0 alone, bit for bit; both replicas served; /metrics has
   ``replica="0"``/``"1"`` series and the fleet gauges. (c) ``TensorParallel``
   tp:2 training of ``transformer_lm_1k_hd128`` cut to 2 layers: f32 (the
   FMA kernels) 4 steps within 1e-4 of one process in loss and 1e-4 of
   max|p| in every parameter; bf16 ``cli.perf --strategy tp`` launches
   ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` on every rank and prints
   tokens/s (gloo through the host, not scaling). (d)
   ``FullyShardedDataParallel`` for ``resnet_cifar(20)`` f32 ``--fusedBN
   apply``, 4 steps: parameters within 1e-5 of ``DataParallel``'s,
   ``bn_stats``/``bn_bwd_stats`` launched on every rank, each rank's
   resident parameter and optimizer-state bytes and peak memory beside
   ``DataParallel``'s. (a)'s and (d)'s jobs start before phase 25 and
   run on threads beside it and (b). (c)'s job also takes one f32 tp:2
   step with LARS and one with LAMB (the split leaves' norms all-reduced
   over the model axis): parameters within 1e-4 of max|p| of one process.
27. Sequence, pipeline and expert parallelism, after phase 26, in one
   2-rank gloo job sharing the card (``parallel.launch.spawn``), no kernel
   on these paths (the ring folds K/V in plain PyTorch, the blocks take
   dense attention, the experts are Linear/ReLU/Linear, as in the JAX
   package). (a) ``cli.perf -m transformer_lm_16k --strategy sp:2`` in
   bf16 at batch 1 x 16384 tokens (12 layers of 1024, 8 heads of 128):
   finite losses, no ``flash_fwd`` launch (the ring replaced it),
   tokens/s a rank and peak memory a rank, below one process running the
   same model with blockwise attention at 16384 tokens; then 2 layers of
   that width at 4096 tokens in f32, one step at sp:2 against one process
   with blockwise attention: the loss within 1e-5 relative, every
   parameter within 1e-5 of max|p|. (b) ``cli.perf -m
   transformer_lm_1k_hd128 --strategy pp:2`` (12 blocks of 1024, micro 2)
   in bf16 at batch 8: records/s; the harness in f32 at batch 4 x 256 for
   2 steps against the unsplit stack in one process (losses within 1e-5
   relative, each stage's parameters within 1e-5 of max|p|), each rank's
   parameter bytes half the stack's. (c) ``--strategy ep:2`` (2 experts
   1024 -> 2048 -> 1024, top-2, capacity 2.0) in bf16 at batch 4:
   records/s; f32 parity as (b), each rank's expert bytes half.
28. Observability at full width, after phase 27 (``--obs``,
   ``--traceDir``, ``--traceSteps``, ``--metricsPort``; each run's
   launches join the kernels line). (a) ``cli.perf -m resnet50_fba -b 128
   -i 8``, without ``--obs`` and then with it, ``--traceSteps 3@3
   --metricsPort 0``: images/s of both; exact BN launches; the window is
   verified and attributed, ``bn_norm`` holds ``bn_coop_kernel``, conv
   time is non-zero, ``host_other`` is under 5% of device time (every
   category's costliest kernel names print, host_other's too); the phase
   columns sum to within 10% of ``seconds``; ``/metrics`` has
   ``train_phase_dispatch_ms_bucket``, ``hbm_bytes_in_use`` and an
   ``attrib_`` gauge; ``hbm_peak_bytes`` is live and at most the card's
   memory. (b) ``transformer_lm_1k_hd128`` b8 ``--innerSteps 4 -i 4``
   graphed, off and ``--traceSteps 2@1``: tokens/s of both, exact flash
   launches, ``attention`` holds the three flash kernels, the phase sum,
   and the window's ``mfu_device`` at least 0.9x the line's ``mfu``. (c)
   ``cli.resnet train --dataset cifar10 --fusedBN apply`` on phase 10's
   seeded records, one epoch, ``--traceSteps 2@2``: the span file holds
   ``data_wait``, ``h2d``, ``dispatch`` and ``device``, and the window
   holds kernels. (d) ``resnet50_fbn`` b128 ``-i 2 --traceSteps 1@1``:
   ``bn_coop_kernel`` in ``bn_norm``, exact launches. (e) ``explain --mem
   resnet50_fba -b 32 --json``: the fit's prediction at batch 128 within
   20% of (a)'s ``hbm_peak_bytes`` (less what the script held before
   (a)'s model). (f) A process running ``cli.perf -m resnet50 -b 512
   --obs --traceDir D`` with its allocator capped at 0.15 of the card,
   started first and run beside (a)-(e), dies on the allocator's OOM
   and leaves ``D/memory_report.json`` with the plan and the largest
   live tensors.
29. Batch scoring and prediction, after phase 28 (``cli.batch_predict``,
   ``serving/bulk.py``, ``cli.predict``). Its data (seeded 256 x 256
   JPEGs from write_jpeg_folder, as record shards through
   ``write_image_shards``) is written, and (b)'s child started, on a
   thread beside phase 27. (a) ``batch-predict --modelName vit_s16 -b 64
   --strategy dp:2 --devices cuda:0,cuda:0 --dataWorkers 4 --stage device
   --scores --obs`` over 272 records (a tail of 16), in this process:
   ``merge_shards`` gives every record once, the scores equal, bit for
   bit, an engine built by hand (graphed, the same weights) over the same
   eval-mode source in the plan's chunks, and ``flash_fwd`` launched (its
   launches join the kernels line); images/s and ``stall_frac``
   (PIL-decode-bound). (b) ``batch-predict --modelName resnet50 -b 128
   --checkpointEvery 2`` over 424 records in a child that SIGKILLs itself
   once its first cursor is written and one more batch's lines are in a
   shard; resumed here with the same command: it starts at batch 2, and
   the shards and the cursor are byte-identical to an uninterrupted run
   here (cuDNN deterministic in both processes). (c) ``serve resnet50
   --strategy tp:2`` and ``dp:2+tp:2`` in f32 on phase 26 (a)'s 2-rank
   gloo job (``tp_image_serve``): one /predict of 4 rows, its scores
   within ``TP_IMAGE_TOL`` of max|score| of one process's eager forward,
   preds equal where the top-2 margin exceeds that. (d) ``predict
   --modelName resnet50 -b 8 --topN 5`` over 20 JPEGs on a ``save_module``
   file and on a weights checkpoint of the same seeded model (the
   ``--modelName`` rebuild): the same printed lines. (e) (c)'s /metrics
   ``_info`` carries the provenance core (``bn_fused``, ``autotune``,
   ``conv_layouts``, ``conv_geom_decisions``) and the topology.
30. The lint (``bigdl_tpu_torch.analysis``, ``cli/lint.py``): traces on
   fake tensors, on the CPU, launching nothing. (a) Beside phase 27, one
   process runs ``cli.main lint`` over LINT_CASES: ``resnet50 -b 128``
   reports LINT_R50_RULES (the JAX CLI's families less the stated
   differences), ``--fusedBN apply --convLayout GEMM,GEMM,GEMM`` no
   ``fusion-*`` finding and no error, the composed ``tp:2 --gradCompress
   bf16 --quantize int8+kv8 --kvPageTokens 128 --speculate 4 --strict``
   config exits 0, and ``resnet50 -b 300000 --no-trace``'s
   ``hbm-oversubscribed`` reads the card's ``total_memory``; then the
   kernel sites of one traced ``resnet50_fba`` b128 and LM b8 step; that
   process launches no kernel. A second, ``python -m
   bigdl_tpu_torch.cli.main lint transformer_lm --strategy tp:3
   --strict`` (the JAX shardlint test's mis-sharded config), exits 2 on
   shard rules. (b) Phase 19's ``resnet50_fba`` and LM rows run with
   ``--lint strict``: their lines carry ``lint`` with 0 errors, their
   exact launches show the pre-flight launched nothing, and the sites a
   traced step records (53 + 53 BN; 12/12/12 flash) equal the launches
   the card counted a step; one eager ``resnet50_fba`` step under
   ``torch.cuda.set_sync_debug_mode("error")`` makes no host sync. (c)
   Phase 26 (a)'s ``serve --strategy tp:2 --lint strict`` starts, serves
   and stamps ``lint_mesh`` ``model:2`` with 0 errors.

Any failed phase exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script and every process it starts keep their compiled bytecode under
``build/pycache`` of the checkout (see :func:`_keep_bytecode`).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float32": 67e12}    # f32 FMA outside the tensor cores
# kernel vs plain: (b, h, s_q, s_k, d, causal, dtype, segments)
SHAPES = [(8, 8, 1024, 1024, 128, True, "bfloat16", False),  # training's
          (1, 8, 1024, 1024, 128, True, "bfloat16", False),
          (1, 8, 1024, 1024, 128, True, "float32", False),
          (2, 8, 512, 512, 64, True, "bfloat16", False),
          (2, 8, 512, 512, 64, False, "bfloat16", False),
          (1, 8, 16, 1024, 128, True, "bfloat16", False),
          (1, 8, 1000, 1000, 128, True, "float32", False),
          (1, 8, 16, 16, 128, True, "bfloat16", False),
          (1, 8, 1000, 1000, 128, True, "bfloat16", False),
          (1, 8, 1000, 1000, 64, True, "bfloat16", False),
          (1, 8, 16, 1024, 64, True, "bfloat16", False),
          (8, 8, 1024, 1024, 128, True, "bfloat16", True),
          # long prompts: 32 key tiles a query tile, where the per-tile
          # work and not a tile's start and end sets the time
          (2, 8, 4096, 4096, 128, True, "bfloat16", False),
          # off the main paths, where the forward is furthest behind the
          # library: every key tile of every unit live (no causal skip),
          # and 1024 short units of at most 4 key tiles
          (8, 8, 1024, 1024, 128, False, "bfloat16", False),
          (16, 16, 512, 512, 128, True, "bfloat16", False)]
# (atol O, atol lse, rtol): f32 sums the softmax in another order than
# the plain version; bf16 rounds P to bf16 at another running max
TOL = {"float32": (2e-5, 2e-5, 1e-5), "bfloat16": (2e-2, 1e-2, 0.0)}
# prefill next-token logits, kernel vs plain, as a fraction of max|logit|
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# backward pair vs plain: (b, h, s_q, s_k, d, causal, dtype, segments)
BWD_SHAPES = [(8, 8, 1024, 1024, 128, True, "bfloat16", False),
              (1, 8, 1024, 1024, 128, True, "float32", False),
              (2, 8, 512, 512, 64, False, "bfloat16", False),
              (1, 8, 1000, 1000, 128, True, "float32", False),
              (1, 8, 16, 1024, 128, True, "bfloat16", False),
              (8, 8, 1024, 1024, 128, True, "bfloat16", True)]
# max|d|/max|ref| per gradient: f32 sums in another order than the plain
# version; bf16 also rounds P and dS to bf16 at other points
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# one step's parameter gradients through the kernels vs the plain
# versions, max|dg| / max|g| per tensor
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_ITERS = 8, 2, 5
# cli.transformerlm train at the widths of transformer_lm_1k_hd128, on a
# corpus sized to a few steps of batch 8
CLI_DIMS = ["--dModel", "1024", "--numLayers", "12", "--numHeads", "8",
            "--seqLength", "1024", "--vocabSize", "32000", "-b", "8"]
CORPUS_WORDS = 40000
DEV = "cuda"
PROMPT_LENS = (3, 17, 64, 300)
MAX_NEW = 16
MODEL = "transformer_lm_1k_hd128"
# the paged serving phase: 16 slots of 128-token pages and the prefix
# cache; 16 concurrent requests, prompts of 8 to 700 tokens, half of them
# a shared 256-token prefix plus a suffix shorter than a page (each hits
# the entry a primer request leaves), every other one sampled
PAGED_SLOTS, PAGE_TOKENS, SHARED_PREFIX = 16, 128, 256
PAGED_LENS = (8, 13, 31, 64, 130, 250, 480, 700)
SUFFIX_LENS = (1, 9, 20, 40, 64, 80, 100, 127)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
# the speculative and quantized phase: phase 14's traffic and server flags
# in bf16, with --speculate 4 (self-draft, and a 2-layer head-128 draft)
# and each --quantize mode; the decode-rate rows fill the 16 slots with
# greedy requests of RATE_PROMPT prompt tokens and RATE_NEW new ones
SPEC_K, DRAFT_DIMS = 4, "256,2,2"
QUANT_MODES = ("int8", "fp8", "int8+kv8", "fp8+kv8")
RATE_PROMPT, RATE_NEW = 64, 24
# BN kernels vs plain: NHWC (batch, h, w, C) of ResNet-50 at batch 128,
# seen as (rows, C), and a ragged shape
BN_SHAPES = [(128, 112, 112, 64), (128, 56, 56, 256), (128, 28, 28, 512),
             (128, 7, 7, 2048), (10, 10, 10, 100)]
BN_EPS = 1e-5
# max|d|/max|ref| of y/dx: f32 and the plain version differ only in the
# order of the per-channel sums; in bf16 that can move a value across a
# rounding boundary (one bf16 ulp, 2^-8 of it). The f32 sums, means and
# vars: 1e-4 (sums of up to 1.6M rows in another order)
BN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BN_SUM_TOL = 1e-4
# the one-launch BN kernels: the same bits on a second call and on a
# CUDA-graph replay of the call (every sum in an order fixed by the plan)
REPEAT_CHECKED = ("bn_stats", "bn_bwd_stats", "bn_fwd_apply",
                  "bn_bwd_fused")
RESNET_BATCH, RESNET_WARMUP, RESNET_ITERS = 128, 2, 5
RESNET_ROWS = {"resnet50_fba": {"bn_fwd_apply": 53, "bn_bwd_fused": 53},
               "resnet50_fbn": {"bn_stats": 53, "bn_bwd_stats": 53},
               "resnet50": {}}
# one f32 step through the BN kernels vs their plain versions, per tensor
# max|dg|/max|g|: (worst, median). The two differ only in the order of the
# BN sums; a ReLU whose input lies within that difference of 0 flips,
# which moves one term of a gradient's sum over positions (a few percent of
# a small tensor's gradient), so the worst is loose and the median tight
BN_GRAD_TOL = (5e-2, 1e-5)
BN_STAT_TOL = 1e-5
BN_LOSS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
BN_GRAD_BATCH = 32
CIFAR_RECORDS, CIFAR_BATCH = 256, 128  # per file: 10 training iterations
# the training loop graphed: K steps a dispatch; ResNet-50 over 8 batches
# (two epochs of 16 steps), resnet_cifar(20) over 10 (20 steps: groups of
# K and ragged tails of 2); cli.perf --innerSteps: one warm-up dispatch
# (eager, then the capture) and INNER_ITERS replays
OPT_K = 4
OPT_BATCHES, OPT_STEPS = 8, 16
CIFAR_OPT_BATCHES, CIFAR_OPT_STEPS = 10, 20
INNER_ITERS = 3
POLY_ITERS = 64  # the Optimizer phases' Poly(0.5, 64) schedule
# the input pipeline phase: the CIFAR CLI over 2 epochs of phase 10's
# files in every (stage, workers) pair; ResNet-50 fed by the native
# pipeline over 1024 images of 256 x 256 x 3 (8 batches of 128 an epoch)
# for PIPE_EPOCHS epochs; the record path over PIPE_JPEGS JPEGs
PIPE_STAGES = ("off", "host", "device")
PIPE_WORKERS = (0, 4)
PIPE_IMAGES, PIPE_SIDE, PIPE_CROP, PIPE_THREADS = 1024, 256, 224, 8
PIPE_EPOCHS = 3
PIPE_JPEGS, PIPE_RECORD_ITERS = 512, 8
# phase 17: LeNet-5 on MNIST (seeded class-banded idx files at MNIST's
# size) and VGG-for-CIFAR (seeded class-banded records, 2000 a file: 10000
# training, 2000 test) through their CLIs at batch 128; VGG's 14 BNs at
# its six (rows, C) shapes at batch 128; the perf zoo's lenet5 and vgg16
# rows, bf16 at the JAX harness's default batch
MNIST_TRAIN, MNIST_TEST, LENET_EPOCHS = 60000, 10000, 2
VGG_RECORDS, VGG_BATCH, VGG_BNS = 2000, 128, 14
# the BN checks of phases 17 and 18 at their models' shapes time each
# call over one replay of a 10-call graph, twice (phase 7's: three replays
# of 20)
BN_TIMING_LIGHT = (10, 2)
VGG_BN_SHAPES = [(128, 32, 32, 64), (128, 16, 16, 128), (128, 8, 8, 256),
                 (128, 4, 4, 512), (128, 2, 2, 512), (128, 1, 1, 512)]
ZOO_ROWS, ZOO_BATCH, ZOO_ITERS = ("lenet5", "vgg16"), 32, 10
# phase 18: Inception-v1/v2 through cli.inception on a seeded class-banded
# JPEG folder (10 classes of 32 training and 8 validation 256 x 256
# images) at batch 32, one epoch; Inception-v2's 57 BNs a step; AlexNet at
# 1000 classes through the Caffe and Torch importers (cli.loadmodel) on
# that val folder at 227 x 227; the perf zoo's inception and alexnet rows
INC_CLASSES, INC_TRAIN, INC_VAL, INC_SIDE, INC_BATCH = 10, 32, 8, 256, 32
INC_BNS, INC_LR = 57, "0.01"
INC_ROWS = (("inception_v1", None), ("inception_v2", "apply"),
            ("alexnet", None))
# AlexNet's logits on the card against the CPU forward of the same
# imported weights, max|d| / max|ref| (f32, TF32 off: the two differ in
# the order of their sums)
ALEXNET_LOGIT_TOL = 1e-4
# phase 19: the rest of the ResNet slice. MFU rows through cli.perf with
# --innerSteps 4 (one warm-up dispatch, MFU_ITERS timed): (row, --fusedBN,
# batch, kernel launches a step). resnet50_bnss keeps its BNs plain: a
# stat-sampled BN takes no kernel (as in the JAX package)
MFU_ROWS = (("resnet50_fba", None, 128,
             {"bn_fwd_apply": 53, "bn_bwd_fused": 53}),
            ("resnet50_s2d", "apply", 128,
             {"bn_fwd_apply": 53, "bn_bwd_fused": 53}),
            ("resnet50_bnss", "apply", 128, {}),
            ("transformer_lm_1k_hd128", None, 8,
             {"flash_fwd": 12, "flash_dq": 12, "flash_dkv": 12}))
MFU_INNER, MFU_ITERS = 4, 3
# phase 30 (b): these MFU rows run through cli.perf's main with --lint
# strict (its two warm-up dispatches, run's default, before MFU_ITERS)
MFU_LINT_ROWS = ("resnet50_fba", "transformer_lm_1k_hd128")
RESNET50_GF_PER_IMAGE = (20e9, 32e9)  # the JAX package's test range
# the conv layout policies ResNet-50 _fba runs under: POLICY_STEPS eager
# steps, then graphed (2 + 1 dispatches of POLICY_STEPS // 2 steps); each
# first loss within POLICY_LOSS_TOL of the default's, the graphed losses
# at steps 2 and 4 within it of the eager ones (bf16 activations: the
# layouts run other cuDNN algorithms, summing in other orders, on a loss
# near ln 1000)
POLICIES = ("default", "NHWC,NHWC,NCHW", "NCHW,NCHW,NCHW", "GEMM,GEMM,GEMM")
POLICY_ROW, POLICY_BNS = "resnet50_fba", 53
POLICY_STEPS = 4
POLICY_LOSS_TOL = 5e-2
S2D_F32_TOL = 1e-4  # the s2d stem against the 7x7/2 conv, f32, TF32 off
S2D_BATCH = 32
TTA_EASY = ["-m", "resnet20_cifar", "--timeToAcc", "0.9", "--imageSize",
            "32", "--fusedBN", "apply", "-b", "128", "--maxEpoch", "10"]
# the hard grade's curve is printed, not gated: 2 epochs of 300 + 60
# images a class, its record shards written by the harness's own writer
# on a thread beside phase 18
TTA_HARD_PER_CLASS = (300, 60)
TTA_HARD = TTA_EASY[:-1] + ["2", "--ttaHard", "--trainPerClass",
                            str(TTA_HARD_PER_CLASS[0]), "--valPerClass",
                            str(TTA_HARD_PER_CLASS[1]), "--valEvery", "20"]


# phase 20: data parallelism
DP_STEPS = 3
DP_CIFAR_BATCH = 128
# 2 ranks against one process after 3 f32 steps: the conv and BN sums run
# over 64 rows a rank (and the BN ones through the stats kernels) where the
# one process sums 128 (through the fused block)
DP_CIFAR_TOL = {"loss": 1e-4, "params": 1e-4}
DP_LM_TOL = 1e-2  # relative, bf16: each rank's products over 4 rows of 8
DP_TIMEOUT_S = 420
DP_WORKER = "chip_smoke:dp_worker"  # the spawn target of phase 20 (b)
# phase 21: BASELINE config 5. (a) cli.textclassification on a seeded
# 20news-style tree: 20 classes of 100 documents of 500-700 words
NEWS_CLASSES, NEWS_DOCS, NEWS_WORDS = 20, 100, (500, 700)
NEWS_TOPIC_WORDS, NEWS_TOPIC_P, NEWS_GLOVE_SPREAD = 50, 0.2, 0.2
TEXT_BATCH, TEXT_EPOCHS = 128, 2
# the last Top-1 of (a), 4x chance: 24 steps of the reference's SGD train
# the text CNN only so far (without the GloVe file it stays at chance)
TEXT_TOP1 = 0.2
RNN_LM_WORDS = 50000  # (b) cli.rnn's input.txt
# (c) the config-5 models at (a)'s widths: T = 500, batch TEXT_BATCH
RNN_EMBED, RNN_HIDDEN = 100, 128
RNN_EAGER_STEPS, RNN_GRAPH_STEPS, RNN_K = 6, 12, 2
RNN_LOSS_TOL = 1e-4  # graphed against eager losses, f32, TF32 off
RNN_TOL = 1e-4  # (d) final states against cuDNN's, of max|ref|, f32
LBFGS_BATCH, LBFGS_ITERS = 1024, 20  # (f)
# phase 22: the rest of the attention models. (a) the long-context LM
# rows at batch 1, each with its own remat, graphed (K steps a replay)
# and eager over the same steps
LONG_ROWS = {"transformer_lm_16k": "dots", "transformer_lm_32k": "full"}
LONG_ITERS, LONG_INNER = 1, 2
LONG_LOSS_TOL = 1e-3  # graphed against eager losses, bf16
LONG_GRAD_LAYERS = 2  # remat against none at 16k, full width, 2 layers
LONG_GRAD_TOL = 1e-2  # of max|g|, bf16
# kernels 1-3 at the long rows' attention, each against its twin run a
# chunk of LONG_CHUNK query rows at a time (a whole f32 score matrix takes
# 1 GB a head at 16k and 4 GB at 32k)
LONG_SHAPES = [(1, 8, 16384, 16384, 128, True, "bfloat16", False),
               (1, 8, 32768, 32768, 128, True, "bfloat16", False)]
LONG_CHUNK = 2048
# (b) the ViT rows, graphed; kernels 1-3 at their shapes, and one f32
VIT_ROWS = ("vit_b16", "vit_s16")
VIT_BATCH, VIT_ITERS, VIT_INNER = 64, 3, 4
VIT_SHAPES = [(64, 6, 196, 196, 128, False, "bfloat16", False),
              (64, 3, 196, 196, 128, False, "bfloat16", False),
              (64, 3, 196, 196, 128, False, "float32", False)]
# (c) a key-padding mask through flash_attention -> blockwise
KP_SHAPE, KP_CHUNK, KP_TOL = (4, 8, 8192, 128), 1024, 2e-2
# (d) an MoE step through the Optimizer: d 1024, 8 experts of a 4d MLP,
# top-2, capacity 2.0, 8 x 1024 tokens a step
MOE_D, MOE_EXPERTS, MOE_TOPK, MOE_CAP = 1024, 8, 2, 2.0
MOE_BATCH, MOE_SEQ, MOE_CLASSES = 8, 1024, 16
MOE_BATCHES, MOE_STEPS, MOE_K = 8, 16, 4
MOE_LOSS_TOL = 1e-3  # graphed against eager criterion losses, bf16
# phase 23: the serving front. Phase 14's server flags and prompts in bf16
# (no prefix cache in (a)); the fleet of (c)-(d) boots 2 workers of them
# with --prefixCache from a checkpoint of (a)'s weights
FRONT_MODEL = [MODEL]
FRONT_PLATFORM = []  # ["--platform", "cpu"] to rehearse on the CPU
FRONT_SLO = "ttft=2000,tpot=100"
FLEET_BOOT_S = 300  # the fleet's boot, and a restart, must take less
ROUTER_REPS = 3  # direct/router/router/direct /generate turns
SWAP_CLIENTS = 3  # client threads sending during the rolling swap


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def print_ptxas(log, kernels):
    """ptxas's register and spill lines of the instances of ``kernels``
    (e.g. ``flash_dq_bf16<128>``, ``flash_fwd_sm90<128, true>``), any
    warning it gave, and any "Potential Performance Loss" note (an info
    line: serialized wgmma shows there)."""
    for block in log.split("Compiling entry function '")[1:]:
        # the mangled name ends in <length>flash_..._bf16ILi<D>E[Lb<0|1>E]
        m = re.search(r"\d(flash_[a-z0-9_]+?)ILi(\d+)E(?:Lb([01])E)?",
                      block.split("'")[0])
        if m is None or m.group(1) not in kernels:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        args = m.group(2) + ("" if m.group(3) is None else
                             ", true" if m.group(3) == "1" else ", false")
        print(f"    {m.group(1)}<{args}>: "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spill stores, "
              f"{spill.group(2) if spill else '?'} bytes spill loads",
              flush=True)
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            print(f"    {line.strip()}", flush=True)


def print_ptxas_bn(log):
    """ptxas's registers, shared memory and spills of each bn_coop_kernel
    instance (the four BN kernels are its modes), and any warning or
    "Potential Performance Loss" note of bn.cu."""
    modes = ("stats", "fwd", "bwd_stats", "bwd_fused")
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"bn_coop_kernelILi(\d)E(13__nv_bfloat16|f)Li(\d+)E"
                      r"Lb([01])E", block.split("'")[0])
        if m is None:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        print(f"    bn_coop_kernel<{modes[int(m.group(1))]}, "
              f"{'bf16' if m.group(2) != 'f' else 'f32'}, V={m.group(3)}, "
              f"relu={m.group(4)}>: {regs.group(1) if regs else '?'} "
              f"registers, {smem.group(1) if smem else '0'} bytes static "
              f"smem, {spill.group(1) if spill else '?'} bytes spill "
              f"stores, {spill.group(2) if spill else '?'} bytes spill "
              f"loads", flush=True)
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            print(f"    {line.strip()}", flush=True)


def live_scores(torch, b, h, sq, sk, causal, seg=None):
    """The score entries the function needs over all (batch, head): per
    query row i, the keys it sees, min(s_k, q_offset + i + 1) under the
    bottom-right causal mask (q_offset = s_k - s_q), and only keys of its
    own segment when ``seg`` (b, s) is given."""
    if seg is not None:
        see = seg[:, :, None] == seg[:, None, :]
        if causal:
            see &= torch.ones(sq, sk, dtype=torch.bool,
                              device=seg.device).tril(sk - sq)
        return h * int(see.sum())
    if not causal:
        return b * h * sq * sk
    return b * h * sum(min(sk, max(0, sk - sq + i + 1)) for i in range(sq))


def flash_bound_ms(entries, b, h, sq, sk, d, dtype):
    """max(operations / peak, bytes / HBM rate): the QK^T and PV products
    over the ``entries`` live scores (``live_scores``), one read of q, k, v
    and one write of o and lse."""
    ops = 4 * entries * d
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def bwd_bound_ms(entries, b, h, sq, sk, d, dtype, products, n_out):
    """max(operations / peak, bytes / HBM rate) of one backward kernel:
    ``products`` matrix products over the ``entries`` live scores
    (``live_scores``), reading q, do, k, v, lse and delta once and writing
    ``n_out`` (b, h, s, d) tensors."""
    ops = 2 * products * entries * d
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = (item * b * h * d * (2 * sq + 2 * sk) + 2 * 4 * b * h * sq
               + item * b * h * d * (sq if n_out == 1 else 2 * sk))
    t_ops, t_bytes = ops / PEAK_OPS[dtype], n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def packed_segments(torch, b, s, seed):
    """(b, s) segment ids from ``pack_sequences`` of seeded document
    lengths into rows of s - 64, then 64 id-0 padding positions."""
    import numpy as np

    from bigdl_tpu_torch.dataset import pack_sequences

    rs = np.random.RandomState(seed)
    docs = [[1] * n for n in rs.randint(20, 400, 6 * b)]
    _, seg = pack_sequences(docs, s - 64)
    if seg.shape[0] < b:
        fail(f"packed_segments: {seg.shape[0]} packed rows, need {b}")
    return torch.from_numpy(np.pad(seg[:b], ((0, 0), (0, 64)))).cuda()


def twin_fwd(torch, ak, q, k, v, causal, seg, chunk=None):
    """The plain forward's (o, lse); with ``chunk`` (causal, s_q = s_k, no
    segments) run a chunk of query rows at a time: rows i..e-1 see keys
    0..e-1 under the bottom-right causal mask, so each chunk is the plain
    version on (q[i:e], k[:e], v[:e])."""
    if not chunk:
        return ak.flash_attention_reference(q, k, v, causal, seg)
    b, h, s, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, device=q.device)
    for i in range(0, s, chunk):
        e = min(s, i + chunk)
        o[..., i:e, :], lse_i = ak.flash_attention_reference(
            q[..., i:e, :], k[..., :e, :], v[..., :e, :], True)
        lse[..., i:e] = lse_i.view(b, h, e - i)
    return o, lse.view(b * h, s)


def twin_bwd(torch, ak, q, k, v, o, lse, do, causal, seg, chunk=None):
    """The plain backward pair's (dq, dk, dv); with ``chunk`` as in
    ``twin_fwd``: dq of each chunk of query rows, and its parts of dk and
    dv over keys 0..e-1 added up in f32 before the one cast the plain
    version makes."""
    if not chunk:
        return ak.flash_bwd_reference(q, k, v, o, lse, do, causal, seg)
    b, h, s, _ = q.shape
    lse, delta = lse.view(b, h, s), ak._delta(o, do).view(b, h, s)
    dq = torch.empty_like(q)
    dk, dv = (torch.zeros(t.shape, device=t.device) for t in (k, v))
    for i in range(0, s, chunk):
        e = min(s, i + chunk)
        qi, ki, doi = q[..., i:e, :], k[..., :e, :], do[..., i:e, :]
        p, ds = ak._bwd_probs(qi, ki, v[..., :e, :], doi, lse[..., i:e],
                              delta[..., i:e], True, None)
        dq[..., i:e, :] = torch.matmul(ds.to(k.dtype).float(),
                                       ki.float()).to(q.dtype)
        dk_i, dv_i = ak._dkv_from(qi, doi, p, ds, torch.float32,
                                  torch.float32)
        dk[..., :e, :] += dk_i
        dv[..., :e, :] += dv_i
        del p, ds, dk_i, dv_i
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def library_bwd_ms(torch, q, k, v, do, causal, iters=20, reps=3):
    """Device ms of the backward of ``scaled_dot_product_attention`` alone:
    one forward, then ``torch.autograd.grad`` over it captured into a CUDA
    graph and replayed. Autograd runs a backward op on the stream of its
    forward op, so the forward runs on the capturing stream."""
    import torch.nn.functional as F

    sq, sk = q.shape[-2], k.shape[-2]
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    mask = None
    if causal and sq != sk:  # the library's is_causal is top-left
        mask = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
                >= torch.arange(sk, device="cuda")[None, :])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = (F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
             if mask is not None else
             F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal))
        for _ in range(2):
            torch.autograd.grad(o, (qq, kk, vv), do, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            torch.autograd.grad(o, (qq, kk, vv), do, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def check_flash_bwd(torch, ak, shapes=BWD_SHAPES, chunk=None):
    """flash_dq / flash_dkv (and the forward with segments) against their
    plain versions on the card, with times and bounds; with ``chunk`` the
    plain versions run a chunk of query rows at a time (``twin_bwd``) and
    are not timed."""
    from bigdl_tpu_torch.tools.timing import device_ms

    rows = []
    for b, h, sq, sk, d, causal, dt, use_seg in shapes:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=DEV).manual_seed(sq * 5 + sk + d)
        q, k, v = (torch.randn(b, h, s, d, device=DEV, generator=g)
                   .to(dtype) for s in (sq, sk, sk))
        # dO as autograd hands it over: a (b, s, h, d) buffer seen as
        # (b, h, s, d), the backward of the heads merge
        do = torch.randn(b, sq, h, d, device=DEV, generator=g).to(
            dtype).transpose(1, 2)
        seg = packed_segments(torch, b, sq, seed=sq) if use_seg else None
        o, lse = ak.flash_fwd(q, k, v, causal, seg)
        o_ref, lse_ref = twin_fwd(torch, ak, q, k, v, causal, seg, chunk)
        delta = ak._delta(o, do)
        dq = ak.flash_dq(q, k, v, do, lse, delta, causal, seg)
        dk, dv = ak.flash_dkv(q, k, v, do, lse, delta, causal, seg)
        rq, rk, rv = twin_bwd(torch, ak, q, k, v, o, lse, do, causal, seg,
                              chunk)
        torch.cuda.synchronize()
        if not rows:  # the training step's shape: the same bits twice
            dq2 = ak.flash_dq(q, k, v, do, lse, delta, causal, seg)
            dk2, dv2 = ak.flash_dkv(q, k, v, do, lse, delta, causal, seg)
            torch.cuda.synchronize()
            same = {n: bool(torch.equal(a, b)) for n, a, b in (
                ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
            print(f"flash_bwd b={b} h={h} s_q={sq} s_k={sk} d={d} {dt}: "
                  f"a second run gives the same bits: {same}", flush=True)
            if not all(same.values()):
                fail(f"the backward pair is not deterministic: {same}")
        rel = lambda a, r: float((a.float() - r.float()).abs().max()
                                 / r.float().abs().max().clamp_min(1e-30))
        err = {"dq": rel(dq, rq), "dk": rel(dk, rk), "dv": rel(dv, rv),
               "o": rel(o, o_ref)}
        tol = BWD_TOL[dt]
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, dq, dk, dv))
        ok = finite and all(e <= tol for e in err.values())
        row = {"shape": [b, h, sq, sk, d], "causal": causal, "dtype": dt,
               "segments": use_seg, "rel_err": err, "ok": ok,
               "dq_abs_err": float((dq.float() - rq.float()).abs().max()),
               "dkv_abs_err": max(float((dk.float() - rk.float()).abs().max()),
                                  float((dv.float() - rv.float()).abs().max())),
               "dq_ms": device_ms(lambda: ak.flash_dq(
                   q, k, v, do, lse, delta, causal, seg)),
               "dkv_ms": device_ms(lambda: ak.flash_dkv(
                   q, k, v, do, lse, delta, causal, seg)),
               "delta_ms": device_ms(lambda: ak._delta(o, do)),
               "plain_ms": None if chunk else device_ms(
                   lambda: ak.flash_bwd_reference(q, k, v, o, lse, do,
                                                  causal, seg)),
               "library_ms": None if use_seg else library_bwd_ms(
                   torch, q, k, v, do, causal)}
        # the library's backward computes its own delta: the pair plus
        # delta is the like-for-like figure
        row["pair_plus_delta_ms"] = (row["dq_ms"] + row["dkv_ms"]
                                     + row["delta_ms"])
        entries = live_scores(torch, b, h, sq, sk, causal, seg)
        row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound_ms(
            entries, b, h, sq, sk, d, dt, 3, 1)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound_ms(
            entries, b, h, sq, sk, d, dt, 4, 2)
        if use_seg:
            row["fwd_seg_ms"] = device_ms(lambda: ak.flash_fwd(q, k, v,
                                                               causal, seg))
            row["fwd_seg_bound_ms"], _ = flash_bound_ms(entries, b, h, sq,
                                                        sk, d, dt)
        rows.append(row)
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        plain = ("n/a" if row["plain_ms"] is None
                 else f"{row['plain_ms']:.4f}")
        print(f"flash_bwd b={b} h={h} s_q={sq} s_k={sk} d={d} "
              f"causal={int(causal)} {dt} segments={int(use_seg)}: "
              f"max|d|/max|ref| dQ={err['dq']:.2e} dK={err['dk']:.2e} "
              f"dV={err['dv']:.2e} O={err['o']:.2e} "
              f"dq_ms={row['dq_ms']:.4f} (bound {row['dq_bound_ms']:.4f} "
              f"{row['dq_bound_by']}) dkv_ms={row['dkv_ms']:.4f} (bound "
              f"{row['dkv_bound_ms']:.4f} {row['dkv_bound_by']}) "
              f"delta_ms={row['delta_ms']:.4f} pair_plus_delta_ms="
              f"{row['pair_plus_delta_ms']:.4f} library_bwd_ms={lib} "
              f"plain_ms={plain}"
              + (f" chunks of {chunk} query rows" if chunk else "")
              + (f" fwd_seg_ms={row['fwd_seg_ms']:.4f} (bound "
                 f"{row['fwd_seg_bound_ms']:.4f})" if use_seg else "")
              + f" {'ok' if ok else 'FAIL'}", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"the backward kernels disagree with their plain versions at "
             f"{[(r['shape'], r['dtype'], r['rel_err']) for r in bad]}")
    return rows


def train_run(torch, card):
    """Full-width training steps through ``cli.perf.run``, plain and with
    remat="full"; returns (result, launches of the plain run, launches of
    the remat run)."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    runs = {}
    for remat, warmup, iters in ((False, TRAIN_WARMUP, TRAIN_ITERS),
                                 ("full", 1, 1)):
        ops.reset_kernel_launches()
        out = perf.run(MODEL, batch=TRAIN_BATCH, iterations=iters,
                       dtype=torch.bfloat16, warmup=warmup, remat=remat)
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        steps = warmup + iters
        tag = "remat=full" if remat else "no remat"
        print(f"[train {tag}] {MODEL} bf16 batch {TRAIN_BATCH} on {card}: "
              f"{out['tokens_per_second']} tokens/s, "
              f"{out['records_per_second']} records/s over {iters} timed "
              f"steps ({out['seconds']} s); losses "
              f"{[round(x, 4) for x in out['losses']]}; launches {n} over "
              f"{steps} steps", flush=True)
        if not all(math.isfinite(x) for x in out["losses"]):
            fail(f"[train {tag}] non-finite loss: {out['losses']}")
        want = dict({k: 0 for k in n},
                    flash_fwd=(24 if remat else 12) * steps,
                    flash_dq=12 * steps, flash_dkv=12 * steps)
        if n != want:
            fail(f"[train {tag}] kernel launches {n}, expected {want} "
                 f"(12 layers per step)")
        runs[remat] = (out, n)
    out = runs[False][0]
    if not out["losses"][-1] < out["losses"][0]:
        fail(f"[train] the loss did not fall over {len(out['losses'])} "
             f"steps on one batch: {out['losses']}")
    return out, runs[False][1], runs["full"][1]


def grads_check(torch, ak):
    """One step's parameter gradients through the kernels against the
    same step through the plain versions (each layer's attention swapped
    for a Function of the twins, as the prefill check swaps attn_fn)."""
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion

    class Twins(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            o, lse = ak.flash_attention_reference(q, k, v, causal)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return ak.flash_bwd_reference(q, k, v, o, lse, do,
                                          ctx.causal) + (None,)

    def twin_attn(q, k, v, causal=False, mask=None):
        return Twins.apply(q, k, v, causal)

    crit = TimeDistributedCriterion(ClassNLLCriterion())
    for dt, layers, batch in (("bfloat16", None, 2), ("float32", 2, 2)):
        model, (s,) = perf.build_model(
            MODEL, **({} if layers is None else {"num_layers": layers}))
        with torch.no_grad():
            model.emb.weight.mul_(0.02)  # let attention, not the token's
            # own embedding, decide the logits
        model.compute_dtype = getattr(torch, dt) if dt == "bfloat16" else None
        model = model.to(DEV).train()
        g = torch.Generator().manual_seed(7)
        x = torch.randint(0, perf.LM_VOCAB, (batch, s), generator=g).to(DEV)
        y = torch.randint(0, perf.LM_VOCAB, (batch, s), generator=g).to(DEV)

        def grads():
            model.zero_grad(set_to_none=True)
            crit(model(x).float(), y).backward()
            return {n: p.grad.float().clone()
                    for n, p in model.named_parameters()}

        g_kernel = grads()
        kernels = [layer.mha.attn_fn for layer in model.encoder]
        for layer in model.encoder:
            layer.mha.attn_fn = twin_attn
        try:
            g_twin = grads()
        finally:
            for layer, fn in zip(model.encoder, kernels):
                layer.mha.attn_fn = fn
        worst, where = 0.0, None
        for n, gt in g_twin.items():
            gk = g_kernel[n]
            if not bool(torch.isfinite(gk).all()):
                fail(f"[grads {dt}] non-finite gradient of {n}")
            rel = float((gk - gt).abs().max() / gt.abs().max().clamp_min(
                1e-30))
            if rel > worst:
                worst, where = rel, n
        n_layers = len(model.encoder)
        print(f"[grads {dt}] {MODEL} ({n_layers} layers, batch {batch}): "
              f"{len(g_twin)} parameter gradients, kernels vs plain "
              f"versions worst max|dg|/max|g| = {worst:.3e} ({where}; "
              f"tolerance {GRAD_TOL[dt]:.0e})", flush=True)
        if worst > GRAD_TOL[dt]:
            fail(f"[grads {dt}] gradient of {where} through the kernels "
                 f"differs from the plain versions' by {worst:.3e} of "
                 f"max|g|")
        del model


def corpus_word(i):
    """The synthetic corpora's word ``i``: letters only (the tokenizer
    keeps letters)."""
    out = "w"
    while True:
        out += chr(97 + i % 26)
        i //= 26
        if not i:
            return out


def write_corpus(path, n_words, seed=0, vocab=5000):
    """A Zipf-distributed word stream over a synthetic vocabulary of
    letter-only words (``corpus_word``), split into sentences of 4-39
    words that end in "."."""
    import numpy as np

    word = corpus_word
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    words = rs.choice(vocab, n_words, p=p / p.sum())
    out, i = [], 0
    while i < n_words:
        n = rs.randint(4, 40)
        out.append(" ".join(word(w) for w in words[i:i + n]) + " .")
        i += n
    with open(path, "w") as f:
        f.write("\n".join(out))


class LogLines:
    """Collects the messages of the ``bigdl_tpu_torch`` logger while
    installed (``with LogLines() as lines``)."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.lines.append(record.getMessage())

        self.lines, self.handler = [], Handler()
        self.log = logging.getLogger("bigdl_tpu_torch")
        self.log.addHandler(self.handler)
        self.log.setLevel(logging.INFO)
        return self.lines

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)


def cli_runs(torch):
    """``cli.transformerlm train`` at full width, plain and --packed;
    returns the launches of the two runs."""
    import contextlib
    import io
    import math
    import re
    import tempfile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import transformerlm
    from bigdl_tpu_torch.ops import attention_kernel as ak

    seg_launches = {"flash_dq": 0, "flash_dkv": 0}
    launch_bwd = ak._launch_bwd

    def counting(name, q, k, v, do, lse, delta, causal, segments, outs):
        if segments is not None:
            seg_launches[name] += 1
        return launch_bwd(name, q, k, v, do, lse, delta, causal, segments,
                          outs)

    launches = {}
    ak._launch_bwd = counting
    try:
        with tempfile.TemporaryDirectory() as tmp, LogLines() as lines:
            write_corpus(os.path.join(tmp, "input.txt"), CORPUS_WORDS)
            base = ["train", "-f", tmp, *CLI_DIMS, "--flash", "--bf16",
                    "--maxEpoch", "1", "--logEvery", "1"]
            for packed in (False, True):
                tag = "packed" if packed else "plain"
                lines.clear()
                for name in seg_launches:
                    seg_launches[name] = 0
                out = io.StringIO()
                ops.reset_kernel_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    transformerlm.main(base + (["--packed"] if packed else []))
                torch.cuda.synchronize()
                n = ops.kernel_launches()
                text = out.getvalue()
                trains = [ln for ln in lines
                          if re.match(r"Train \d+ in .*Loss is ", ln)]
                # "perplexity is P", or "perplexity is inf (mean held-out
                # nll L overflows exp)" where exp(L) is past the f64 range
                ppl = re.search(r"perplexity is ([0-9.]+|inf \(mean held-out "
                                r"nll ([0-9.]+))", text)
                nll = (None if not ppl else float(ppl.group(2)) if
                       ppl.group(2) else math.log(float(ppl.group(1))))
                print(f"[cli {tag}] {time.perf_counter() - t0:.1f}s, "
                      f"{len(trains)} 'Train ... Loss is' lines (last: "
                      f"{trains[-1] if trains else None!r}); "
                      f"{text.strip().splitlines()[-1] if text else ''}; "
                      f"launches {n}, backward launches with segments "
                      f"{seg_launches}", flush=True)
                if not trains:
                    fail(f"[cli {tag}] no 'Train ... Loss is' line")
                if nll is None or not math.isfinite(nll):
                    fail(f"[cli {tag}] no finite held-out nll in {text!r}")
                if n["flash_dq"] == 0 or n["flash_dkv"] == 0:
                    fail(f"[cli {tag}] the backward kernels did not run: {n}")
                if packed and min(seg_launches.values()) == 0:
                    fail(f"[cli packed] the backward kernels ran without "
                         f"segments: {seg_launches}")
                launches[tag] = n
    finally:
        ak._launch_bwd = launch_bwd
    return launches


def fwd_kernel_name(d, dt):
    """The kernel ``flash_fwd`` launches at head dim ``d`` in ``dt``, by
    the shape rule in ``csrc/flash_fwd.cu`` (``flash_fwd_kernel``)."""
    import ctypes

    from bigdl_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").flash_fwd_kernel
    fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int] * 2
    return fn(d, int(dt == "bfloat16")).decode()


def check_flash(torch, ak, shapes=SHAPES, chunk=None):
    """flash_fwd against its plain version on the card, with times, bounds
    and the library's forward; with ``chunk`` the plain version runs a
    chunk of query rows at a time (``twin_fwd``) and is not timed."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.tools.timing import device_ms

    rows = []
    for b, h, sq, sk, d, causal, dt, use_seg in shapes:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=DEV).manual_seed(sq * 7 + sk)
        q = torch.randn(b, h, sq, d, device=DEV, generator=g).to(dtype)
        k = torch.randn(b, h, sk, d, device=DEV, generator=g).to(dtype)
        v = torch.randn(b, h, sk, d, device=DEV, generator=g).to(dtype)
        seg = packed_segments(torch, b, sq, seed=sq) if use_seg else None
        o, lse = ak.flash_fwd(q, k, v, causal, seg)
        o_ref, lse_ref = twin_fwd(torch, ak, q, k, v, causal, seg, chunk)
        torch.cuda.synchronize()
        if not rows:  # the training step's shape: the same bits twice
            o2, lse2 = ak.flash_fwd(q, k, v, causal, seg)
            torch.cuda.synchronize()
            same = bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2))
            print(f"flash_fwd b={b} h={h} s_q={sq} s_k={sk} d={d} {dt}: a "
                  f"second run gives the same bits: {same}", flush=True)
            if not same:
                fail("the forward is not deterministic")
        atol_o, atol_l, rtol = TOL[dt]
        d_o = (o.float() - o_ref.float()).abs()
        d_l = (lse - lse_ref).abs()
        ok = (bool(torch.all(d_o <= atol_o + rtol * o_ref.float().abs()))
              and bool(torch.all(d_l <= atol_l + rtol * lse_ref.abs())))
        mask = None
        if causal and sq != sk:  # the library's is_causal is top-left
            mask = (torch.arange(sq, device=DEV)[:, None] + (sk - sq)
                    >= torch.arange(sk, device=DEV)[None, :])
        lib = (lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
               ) if mask is not None else (
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal))
        row = {"shape": [b, h, sq, sk, d], "causal": causal, "dtype": dt,
               "segments": use_seg,
               "kernel": fwd_kernel_name(d, dt),
               "max_abs_err": float(d_o.max()),
               "max_abs_err_lse": float(d_l.max()),
               "ms": device_ms(lambda: ak.flash_fwd(q, k, v, causal, seg)),
               "plain_ms": None if chunk else device_ms(
                   lambda: ak.flash_attention_reference(q, k, v, causal,
                                                        seg)),
               "library_ms": None if use_seg else device_ms(lib), "ok": ok}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            live_scores(torch, b, h, sq, sk, causal, seg), b, h, sq, sk, d,
            dt)
        rows.append(row)
        lib_ms = ("-" if row["library_ms"] is None
                  else f"{row['library_ms']:.4f}")
        plain = ("-" if row["plain_ms"] is None
                 else f"{row['plain_ms']:.4f}")
        print(f"flash_fwd b={b} h={h} s_q={sq} s_k={sk} d={d} "
              f"causal={int(causal)} {dt}{' segments' if use_seg else ''} "
              f"[{row['kernel']}]: max|dO|={row['max_abs_err']:.3e} "
              f"max|dlse|={row['max_abs_err_lse']:.3e} "
              f"kernel_ms={row['ms']:.4f} plain_ms={plain} "
              f"library_ms={lib_ms} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"flash_fwd disagrees with its plain version at "
             f"{[(r['shape'], r['dtype'], r['segments']) for r in bad]}")
    return rows


def _post(port, path, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def serve_run(torch, bf16):
    """One serving run; returns (launches, generate latencies, tokens/s)."""
    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.serving import make_server

    tag = "bf16" if bf16 else "f32"
    dt = "bfloat16" if bf16 else "float32"
    argv = [MODEL, "--randomInit", "--slots", "4", "--buckets", "1,2,4",
            "--port", "0"] + (["--bf16"] if bf16 else [])
    t0 = time.perf_counter()
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser().parse_args(
        argv))
    model = app.decoder.model
    with torch.no_grad():
        # N(0, 1) embeddings times sqrt(d_model) make every greedy step
        # echo the last token; at std 0.02 the layers pick the tokens
        model.emb.weight.mul_(0.02)
    print(f"[{tag}] build_app {time.perf_counter() - t0:.1f}s, "
          f"{sum(p.numel() for p in model.parameters())} parameters",
          flush=True)
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, model.vocab, n).tolist() for n in PROMPT_LENS]
    rows = rs.randint(0, model.vocab, (2, 64)).tolist()
    def metrics():
        st, page = _get(port, "/metrics")
        if st != 200:
            fail(f"[{tag}] /metrics answered {st}")
        vals = {}
        for line in page.splitlines():
            if line.startswith("bigdl_serving_"):
                name, _, val = line[len("bigdl_serving_"):].rpartition(" ")
                vals[name] = float(val)
        return vals

    try:
        # ---- warm-up, outside the counted run: the first request loads
        # the CUDA modules and library handles, which would land in the
        # measured latencies
        for path, body in (("/generate", {"tokens": [1, 2, 3],
                                          "max_new_tokens": 2}),
                           ("/predict", {"inputs": rows})):
            st, out = _post(port, path, body)
            if st != 200:
                fail(f"[{tag}] warm-up {path} answered {st}: {out}")
        before = metrics()
        # ---- the main path: counts from 0, traffic, counts read
        ops.reset_kernel_launches()
        results, lat = {}, {}

        def gen(i):
            t = time.perf_counter()
            results[i] = _post(port, "/generate",
                               {"tokens": prompts[i],
                                "max_new_tokens": MAX_NEW})
            lat[i] = 1e3 * (time.perf_counter() - t)

        t_gen = time.perf_counter()
        threads = [threading.Thread(target=gen, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_gen
        st_pred, pred = _post(port, "/predict", {"inputs": rows})
        st_h, _ = _get(port, "/healthz")
        st_r, _ = _get(port, "/readyz")
        after = metrics()
        torch.cuda.synchronize()
        launches = ops.kernel_launches()["flash_fwd"]

        statuses = [results.get(i, (None,))[0] for i in range(len(prompts))]
        print(f"[{tag}] /generate {statuses} /predict {st_pred} /healthz "
              f"{st_h} /readyz {st_r} /metrics 200", flush=True)
        if statuses != [200] * len(prompts) or (st_pred, st_h, st_r) \
                != (200, 200, 200):
            fail(f"[{tag}] an endpoint did not answer 200: {results}, "
                 f"{st_pred} {pred if st_pred != 200 else ''}")
        prefills, flushes = (after[k] - before[k] for k in (
            "prefills_total", "batcher_flushes_total"))
        need = 12 * (prefills + flushes)
        print(f"[{tag}] flash_fwd launches {launches} over {int(prefills)} "
              f"prefills + {int(flushes)} /predict batches "
              f"(need >= {int(need)})", flush=True)
        if launches < need:
            fail(f"[{tag}] the kernel ran {launches} times, fewer than "
                 f"{int(need)}: prefill did not go through it")

        # ---- /predict equals the offline forward at the same shape, and
        # rows of a length off the ladder (40 tokens, padded to 64) replay
        # the graphs captured at start-up: no graph is added
        graphs = app.engine.graphs
        n_graphs = len(graphs)
        odd = rs.randint(0, model.vocab, (1, 40)).tolist()
        st_odd, pred_odd = _post(port, "/predict", {"inputs": odd})
        if st_odd != 200:
            fail(f"[{tag}] /predict of 40-token rows answered {st_odd}")
        agree = []
        with torch.no_grad():
            for x, out in ((rows, pred), (odd, pred_odd)):
                ref = model(torch.tensor(x, device="cuda")).argmax(-1)
                agree.append(float((torch.tensor(out["predictions"],
                                                 device="cuda")
                                    == ref).float().mean()))
        want = len(app.engine.buckets) * len(app.engine.lengths)
        print(f"[{tag}] /predict argmax agreement with the offline forward "
              f"{agree[0]:.4f} (64-token rows), {agree[1]:.4f} (40-token "
              f"rows); {len(graphs)} /predict graphs before and after, "
              f"{len(app.engine.buckets)} batch x "
              f"{len(app.engine.lengths)} length buckets", flush=True)
        if not bf16 and agree != [1.0, 1.0]:
            fail("[f32] /predict differs from the offline forward")
        if not n_graphs == len(graphs) == want:
            fail(f"[{tag}] {len(graphs)} /predict graphs ({n_graphs} before "
                 f"the 40-token rows), expected {want}")

        # ---- (c) prefill logits: kernel vs plain version, on the card
        ref_attn = (lambda q, k, v, causal, mask:
                    ak.flash_attention_reference(q, k, v, causal)[0])
        worst = 0.0
        with torch.no_grad():
            for p in prompts:
                x = torch.tensor([p], device="cuda")
                lg_k = model.prefill_logits(x, model.init_cache(1)).float()
                kernel_fns = [layer.mha.attn_fn for layer in model.encoder]
                for layer in model.encoder:
                    layer.mha.attn_fn = ref_attn
                try:
                    lg_r = model.prefill_logits(x, model.init_cache(1)).float()
                finally:
                    for layer, fn in zip(model.encoder, kernel_fns):
                        layer.mha.attn_fn = fn
                if not bool(torch.isfinite(lg_k).all()):
                    fail(f"[{tag}] non-finite prefill logits")
                rel = float((lg_k - lg_r).abs().max() / lg_r.abs().max())
                worst = max(worst, rel)
        print(f"[{tag}] prefill logits kernel vs plain: max|d|/max|ref| = "
              f"{worst:.3e} (tolerance {LOGIT_TOL[dt]:.0e})", flush=True)
        if worst > LOGIT_TOL[dt]:
            fail(f"[{tag}] prefill logits through the kernel differ from "
                 f"the plain version's by {worst:.3e} of max|logit|")

        # ---- (b) f32: served tokens equal the offline generate
        if not bf16:
            for i, p in enumerate(prompts):
                served = results[i][1]["tokens"]
                offline = model.generate([p], MAX_NEW)[0].tolist()
                if served != offline:
                    j = next(n for n, (a, b) in enumerate(zip(served, offline))
                             if a != b)
                    with torch.no_grad():
                        lg = model.prefill_logits(
                            torch.tensor([p + offline[:j]], device="cuda"),
                            model.init_cache(1))[0].float()
                    top2 = torch.topk(lg, 2).values
                    fail(f"[f32] prompt {len(p)}: /generate differs from the "
                         f"offline generate at step {j} (top-2 logit gap "
                         f"{float(top2[0] - top2[1]):.3e}): {served} vs "
                         f"{offline}")
            print("[f32] every /generate equals the offline generate",
                  flush=True)
        gen_tokens = sum(len(results[i][1]["tokens"])
                         for i in range(len(prompts)))
        return launches, [lat[i] for i in range(len(prompts))], \
            gen_tokens / wall, results
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        thr.join(30)


def paged_requests(vocab):
    """(primer, [(prompt, sampling kwargs)] of the 16 requests)."""
    import numpy as np

    rs = np.random.RandomState(1)
    shared = rs.randint(0, vocab, SHARED_PREFIX).tolist()
    prompts = [rs.randint(0, vocab, n).tolist() for n in PAGED_LENS]
    prompts += [shared + rs.randint(0, vocab, n).tolist()
                for n in SUFFIX_LENS]
    return shared + [0], [(p, dict(SAMPLED, seed=100 + i) if i % 2 else {})
                          for i, p in enumerate(prompts)]


def drive(eng, primer, reqs):
    """The primer, then every request at once, through a DecodeEngine."""
    eng.generate(primer, 2)
    futs = [eng.submit(p, MAX_NEW, **kw) for p, kw in reqs]
    while not all(f.done() for f in futs):
        if eng.step() == 0 and not all(f.done() for f in futs):
            fail("a decode engine went idle with requests unresolved")
    return [f.result() for f in futs]


def route_logits(torch, model, prompt, hit_eng=None):
    """The f32 next-token logits after ``prompt``: an eager prefill (a
    miss's route: the flash kernel), or, through ``hit_eng``, the logits
    its install leaves, where the prompt must be a prefix hit (the copied
    pages, then the suffix prefill through the decode attention)."""
    with torch.no_grad():
        if hit_eng is None:
            return model.prefill_logits(
                torch.tensor([prompt], device="cuda"),
                model.init_cache(1))[0].float()
        hits = hit_eng._pfx.hits
        fut = hit_eng.submit(prompt, 1)
        lg = hit_eng._logits[0].clone()  # every slot was free: slot 0
        while not fut.done():
            hit_eng.step()
    if hit_eng._pfx.hits != hits + 1:
        fail(f"a {len(prompt)}-token prompt was not a prefix hit")
    return lg


def decision_scores(torch, lg, prompt_len, j, kw):
    """The scores a decision at step ``j`` takes its argmax of: the
    logits, warped and noised as the draw does for a sampled request."""
    from bigdl_tpu_torch.serving.sampling import (gumbel_noise, request_key,
                                                  warp_logits)
    if not kw:
        return lg
    key = request_key(torch.tensor(kw["seed"], device="cuda"),
                      prompt_len + j)
    return (warp_logits(lg, kw["temperature"], kw["top_k"], kw["top_p"])
            + gumbel_noise(key, lg.numel()))


def compare_tokens(torch, model, tag, what, reqs, got, ref, hit_eng,
                   exact=()):
    """Each request's tokens (``got``; a prefix hit's in the requests not
    in ``exact``) against a route that misses (``ref``). A hit's suffix
    goes through the decode attention where its miss runs the flash
    prefill, so their logits differ within ``LOGIT_TOL`` (checked apart).
    A token may differ only outside ``exact``, and only where the two
    routes' measured logits explain it: at the first step j that differs,
    the decision (argmax of the logits, warped and noised when sampled)
    is taken again from each route's logits after prompt + tokens[:j]
    (``route_logits``), and the two must differ, i.e. the measured
    difference between the routes crosses that decision's margin. A
    sampled decision can turn on the top-k or nucleus boundary as well as
    on its argmax. The miss's margin between the two tokens and both
    decisions are printed."""
    ties = 0
    for i, ((p, kw), a, b) in enumerate(zip(reqs, got, ref)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        x, y = a[j], b[j]
        miss = decision_scores(torch, route_logits(torch, model, p + b[:j]),
                               len(p), j, kw)
        gap = float(miss[y] - miss[x])
        d_hit = d_miss = int(miss.argmax())
        if i not in exact:
            hit = route_logits(torch, model, p + b[:j], hit_eng)
            d_hit = int(decision_scores(torch, hit, len(p), j, kw).argmax())
        print(f"[{tag}] {what}: request {i} ({len(p)} tokens"
              f"{', sampled' if kw else ''}) differs at step {j}: hit "
              f"{x}, miss {y}; the miss's scores put {y} {gap:.3e} above "
              f"{x}; taken again, the hit's logits decide {d_hit}, the "
              f"miss's {d_miss}", flush=True)
        if i in exact or d_hit == d_miss:
            fail(f"[{tag}] {what}: request {i} differs at step {j}, "
                 f"beyond what the routes' logits explain: {a} vs {b}")
        ties += 1
    print(f"[{tag}] {what}: {len(reqs) - ties} of {len(reqs)} requests "
          f"equal, {ties} at a decision the routes' logits split",
          flush=True)


def paged_serve_run(torch, bf16, card):
    """The paged serving phase (docstring, phase 14); returns (flash_fwd
    launches of the counted traffic, the decode step rows)."""
    import gc

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import DecodeEngine, make_server
    from bigdl_tpu_torch.tools.profile_decode import profile_row

    tag = "paged bf16" if bf16 else "paged f32"
    dt = "bfloat16" if bf16 else "float32"
    argv = [MODEL, "--randomInit", "--slots", str(PAGED_SLOTS),
            "--kvPageTokens", str(PAGE_TOKENS), "--prefixCache",
            "--buckets", "1,2,4", "--port", "0"] + (["--bf16"] if bf16 else [])
    t0 = time.perf_counter()
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser().parse_args(
        argv))
    model = app.decoder.model
    with torch.no_grad():
        model.emb.weight.mul_(0.02)  # as serve_run: the layers pick tokens
    print(f"[{tag}] build_app with every graph captured "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    primer, reqs = paged_requests(model.vocab)
    rows = [[1, 2, 3, 4] * 16, [5, 6, 7, 8] * 16]

    def metrics():
        st, page = _get(port, "/metrics")
        if st != 200:
            fail(f"[{tag}] /metrics answered {st}")
        return {ln[len("bigdl_serving_"):].rpartition(" ")[0]:
                float(ln.rpartition(" ")[2]) for ln in page.splitlines()
                if ln.startswith("bigdl_serving_")}

    def post_all(batch):
        out = {}

        def one(i, p, kw):
            out[i] = _post(port, "/generate", dict(
                kw, tokens=p, max_new_tokens=MAX_NEW))

        ths = [threading.Thread(target=one, args=(i, p, kw))
               for i, (p, kw) in batch]
        for t in ths:
            t.start()
        for t in ths:
            t.join(600)
        if any(out.get(i, (None,))[0] != 200 for i, _ in batch):
            fail(f"[{tag}] a /generate did not answer 200: {out}")
        return [out[i][1]["tokens"] for i, _ in batch]

    try:
        st, out = _post(port, "/generate", {"tokens": primer,
                                            "max_new_tokens": 2})
        if st != 200:
            fail(f"[{tag}] the primer /generate answered {st}: {out}")
        before = metrics()
        ops.reset_kernel_launches()
        t = time.perf_counter()
        served = post_all(list(enumerate(reqs)))
        wall = time.perf_counter() - t
        st_pred, _ = _post(port, "/predict", {"inputs": rows})
        after = metrics()
        torch.cuda.synchronize()
        launches = ops.kernel_launches()["flash_fwd"]
        if st_pred != 200:
            fail(f"[{tag}] /predict answered {st_pred}")
        # the sampled requests whose route cannot change on a second
        # send (a hit both times, or too short to have left an entry)
        twice = [i for i, (p, kw) in enumerate(reqs) if kw and (
            i >= len(PAGED_LENS) or len(p) <= PAGE_TOKENS)]
        again = post_all([(i, reqs[i]) for i in twice])
        pfx_pages = app.decoder._pfx.cached_pages()
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        thr.join(30)
    d = {k: after[k] - before.get(k, 0.0) for k in after}
    hits = d["prefix_cache_hits_total"]
    full = d["prefills_total"] - hits
    need = 12 * (full + d["batcher_flushes_total"])
    print(f"[{tag}] 16 concurrent /generate + 1 /predict: "
          f"{sum(map(len, served)) / wall:.1f} generated tokens/s, "
          f"{int(hits)} prefix hits, flash_fwd launches {launches} over "
          f"{int(full)} full prefills + {int(d['batcher_flushes_total'])} "
          f"/predict batches (need >= {int(need)}); kv_pages_in_use "
          f"{int(after['kv_pages_in_use'])} after the traffic, the prefix "
          f"cache holds {pfx_pages} ({card})", flush=True)
    if hits != len(SUFFIX_LENS):
        fail(f"[{tag}] {hits} prefix hits, expected {len(SUFFIX_LENS)}")
    if launches < need:
        fail(f"[{tag}] flash_fwd ran {launches} times, fewer than {need}")
    if after["kv_pages_in_use"] != pfx_pages or pfx_pages == 0:
        fail(f"[{tag}] {after['kv_pages_in_use']} pages in use once traffic "
             f"ended, the prefix cache holds {pfx_pages}")
    if again != [served[i] for i in twice]:
        fail(f"[{tag}] the same seeds drew other tokens the second time")
    print(f"[{tag}] {len(twice)} sampled requests sent again drew the "
          f"same tokens", flush=True)

    # the same traffic through engines built here on the same model: the
    # server's route graphed, the same eagerly, and a dense engine
    cache_dtype = torch.bfloat16 if bf16 else None
    routes, engines = {}, {}
    for name, kw in (("paged graphed", dict(graphs=True)),
                     ("paged eager", dict(graphs=False)),
                     ("dense graphed", dict(graphs=True, paged=False))):
        paged = kw.pop("paged", True)
        eng = engines[name] = DecodeEngine(
            model, slots=PAGED_SLOTS, cache_dtype=cache_dtype, device="cuda",
            kv_page_tokens=PAGE_TOKENS if paged else None,
            prefix_cache=paged, **kw)
        routes[name] = drive(eng, primer, reqs)
    hit_eng = engines["paged graphed"]  # its cache holds the prefix
    if routes["paged graphed"] != served:
        fail(f"[{tag}] the server's tokens differ from the same route's "
             f"through a DecodeEngine")
    if routes["paged eager"] != routes["paged graphed"]:
        fail(f"[{tag}] eager and graphed paged decoding differ")
    print(f"[{tag}] served = paged graphed = paged eager, every request "
          f"(greedy and sampled)", flush=True)
    hit_idx = range(len(PAGED_LENS), len(reqs))
    # each hit's first logits against its miss's, directly
    worst = 0.0
    for i in hit_idx:
        miss = route_logits(torch, model, reqs[i][0])
        hit = route_logits(torch, model, reqs[i][0], hit_eng)
        if not bool(torch.isfinite(hit).all()):
            fail(f"[{tag}] non-finite logits at prefix hit {i}")
        worst = max(worst, float((hit - miss).abs().max()
                                 / miss.abs().max()))
    print(f"[{tag}] first logits, prefix hit vs miss, {len(hit_idx)} "
          f"requests: max|d|/max|miss| = {worst:.3e} (tolerance "
          f"{LOGIT_TOL[dt]:.0e})", flush=True)
    if worst > LOGIT_TOL[dt]:
        fail(f"[{tag}] a prefix hit's first logits differ from its miss's "
             f"by {worst:.3e} of max|logit|")
    compare_tokens(torch, model, tag, "paged (prefix hits) vs dense (all "
                   "misses)", reqs, served, routes["dense graphed"], hit_eng,
                   exact=[i for i in range(len(reqs)) if i not in hit_idx])
    if not bf16:
        greedy = [i for i, r in enumerate(reqs) if not r[1]]
        offline = [model.generate([reqs[i][0]], MAX_NEW)[0].tolist()
                   for i in greedy]
        compare_tokens(torch, model, tag, "greedy /generate vs the offline "
                       "generate", [reqs[i] for i in greedy],
                       [served[i] for i in greedy], offline, hit_eng,
                       exact=[n for n, i in enumerate(greedy)
                              if i not in hit_idx])
    for eng in engines.values():
        eng.close()
    del engines, hit_eng
    steps = {}
    for kv, mode, pt, graphs in (("dense", "eager", None, False),
                                 ("dense", "graphed", None, True),
                                 ("paged", "eager", PAGE_TOKENS, False),
                                 ("paged", "graphed", PAGE_TOKENS, True)):
        r = profile_row(model, PAGED_SLOTS, pt, graphs)
        r.pop("events")
        steps[(kv, mode)] = r
        print(f"[{tag}] decode step, {kv} {mode}, {PAGED_SLOTS} slots: "
              f"{r['step_ms']:.3f} ms (host clock), {r['tokens_per_s']:.1f} "
              f"generated tokens/s, device {r['device_ms']:.3f} ms a step, "
              f"busy {100 * r['busy']:.1f}%, {r['kernels']:.0f} kernels a "
              f"step ({card})", flush=True)
    del app, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, steps, served


def scaled_embedding(torch):
    """While active, ``cli.serve.build_app`` builds the LM with its
    embedding x0.02, the weights phases 6 and 14 serve (they scale it after
    the build): quantization and its quality report then see them."""
    import contextlib

    from bigdl_tpu_torch.cli import perf

    @contextlib.contextmanager
    def patched():
        build = perf.build_model

        def scaled(*a, **kw):
            model, shape = build(*a, **kw)
            with torch.no_grad():
                model.emb.weight.mul_(0.02)
            return model, shape

        perf.build_model = scaled
        try:
            yield
        finally:
            perf.build_model = build
    return patched()


def decode_row(torch, eng):
    """Decode rate of ``eng`` (16 slots, idle): 16 greedy requests of
    RATE_PROMPT tokens and RATE_NEW new ones each, all installed first,
    then the steps timed on the host clock to the last token, ended by a
    synchronize. Returns (ms a step, decode tokens/s, the accept rate of
    the proposals, or None); the tokens a speculative install emits are
    not counted."""
    import numpy as np

    m = eng.metrics
    spec = (lambda: (m._metrics["spec_accepted_total"].value,
                     m._metrics["spec_proposed_total"].value)) \
        if eng.speculate else (lambda: (0.0, 0.0))
    acc0, prop0 = spec()
    rs = np.random.RandomState(2)
    futs = [eng.submit(rs.randint(0, eng.model.vocab, RATE_PROMPT).tolist(),
                       RATE_NEW) for _ in range(PAGED_SLOTS)]
    at_install = sum(len(r.out) for r in eng._reqs if r is not None)
    torch.cuda.synchronize()
    t0, steps = time.perf_counter(), 0
    while not all(f.done() for f in futs):
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(f.result()) for f in futs) - at_install
    acc, prop = spec()
    return (1e3 * wall / steps, tokens / wall,
            (acc - acc0) / (prop - prop0) if eng.speculate else None)


def kv8_pool_check(torch, model, card):
    """A full-width prompt's dense K/V rows written into kv8 pages and
    gathered back: bit for bit ``kv_fake_quant`` of the rows, on the
    card."""
    import numpy as np

    from bigdl_tpu_torch.serving import kv_pages as kvp
    from bigdl_tpu_torch.serving.quant import kv_fake_quant

    n = 3 * PAGE_TOKENS
    x = torch.tensor([np.random.RandomState(3).randint(
        0, model.vocab, n).tolist()], device=DEV)
    dense = model.init_cache(1, model.max_len, torch.bfloat16)
    kv = kvp.PagedKvCache(model.encoder, slots=1, max_len=model.max_len,
                          page_tokens=PAGE_TOKENS, dtype=torch.bfloat16,
                          device=DEV, quantized=True)
    with torch.no_grad():
        model.prefill_logits(x, dense)
        kv.reserve(0, n)
        pages = kv.page_table[0, :3]
        kvp.scatter_pages(kv.pools, [{k: c[k][:, :, :n] for k in c}
                                     for c in dense], pages)
        back = kvp.gather_cache(kv.pools, pages)
    bad = [(i, k) for i, (b, c) in enumerate(zip(back, dense)) for k in b
           if not torch.equal(b[k], kv_fake_quant(c[k][0, :, :n]))]
    print(f"[spec/quant] kv8 pool of a {n}-token prompt ({len(back)} "
          f"layers, k and v) gathered back vs kv_fake_quant of its dense "
          f"rows: {'bit-equal' if not bad else f'differs at {bad}'} "
          f"({card})", flush=True)
    if bad:
        fail(f"[spec/quant] kv8 pools gathered back differ from "
             f"kv_fake_quant at (layer, k/v) {bad}")


def spec_quant_serve_run(torch, card, plain_served):
    """The speculative and quantized serving phase (docstring, phase 16);
    ``plain_served`` is phase 14's bf16 tokens. Returns the flash_fwd
    launches of the counted traffic."""
    import gc

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.serving import (DecodeEngine, MetricsRegistry,
                                         make_server)
    from bigdl_tpu_torch.serving.quant import weight_bytes

    base = [MODEL, "--randomInit", "--bf16", "--slots", str(PAGED_SLOTS),
            "--kvPageTokens", str(PAGE_TOKENS), "--prefixCache",
            "--buckets", "1,2,4", "--port", "0"]
    runs = [("spec self-draft", ["--speculate", str(SPEC_K)]),
            (f"spec draft {DRAFT_DIMS}", ["--speculate", str(SPEC_K),
                                           "--draftDims", DRAFT_DIMS])]
    runs += [(f"quantize {m}", ["--quantize", m]) for m in QUANT_MODES]
    launches, table = 0, []

    # the unquantized, non-speculative row of the decode-rate table
    with scaled_embedding(torch):
        model, _ = build_model(MODEL)
    model.compute_dtype = torch.bfloat16
    model = model.to(DEV)
    kv8_pool_check(torch, model, card)
    eng = DecodeEngine(model, slots=PAGED_SLOTS, cache_dtype=torch.bfloat16,
                       device=DEV, kv_page_tokens=PAGE_TOKENS,
                       prefix_cache=True)
    table.append(("plain", weight_bytes(model),
                  eng._kv.bytes_per_page * eng._kv.max_pages)
                 + decode_row(torch, eng))
    eng.close()
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()

    for tag, extra in runs:
        t0 = time.perf_counter()
        with scaled_embedding(torch):
            app, _, _, _ = serve_cli.build_app(
                serve_cli.build_parser().parse_args(base + extra))
        dec, model = app.decoder, app.decoder.model
        prov = app.metrics._provenance
        print(f"[{tag}] build_app (quality report and every graph "
              f"captured) {time.perf_counter() - t0:.1f}s: weights "
              f"{prov['weight_bytes']} bytes read a step, KV "
              f"{dec._kv.bytes_per_page * dec._kv.max_pages} bytes a "
              f"full slot ({card})", flush=True)
        srv = make_server(app, "127.0.0.1", 0)
        port = srv.server_address[1]
        thr = threading.Thread(target=srv.serve_forever, daemon=True)
        thr.start()
        primer, reqs = paged_requests(model.vocab)

        def metrics():
            st, page = _get(port, "/metrics")
            if st != 200:
                fail(f"[{tag}] /metrics answered {st}")
            return {ln[len("bigdl_serving_"):].rpartition(" ")[0]:
                    float(ln.rpartition(" ")[2]) for ln in page.splitlines()
                    if ln.startswith("bigdl_serving_")}

        try:
            st, out = _post(port, "/generate", {"tokens": primer,
                                                "max_new_tokens": 2})
            if st != 200:
                fail(f"[{tag}] the primer /generate answered {st}: {out}")
            before = metrics()
            ops.reset_kernel_launches()
            res = {}

            def one(i, p, kw):
                res[i] = _post(port, "/generate", dict(
                    kw, tokens=p, max_new_tokens=MAX_NEW))

            ths = [threading.Thread(target=one, args=(i, p, kw))
                   for i, (p, kw) in enumerate(reqs)]
            t = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join(600)
            wall = time.perf_counter() - t
            st_pred, _ = _post(port, "/predict",
                               {"inputs": [[1, 2, 3, 4] * 16]})
            after = metrics()
            torch.cuda.synchronize()
            n = ops.kernel_launches()["flash_fwd"]
        finally:
            srv.shutdown()
            srv.server_close()
            thr.join(30)
        if any(res.get(i, (None,))[0] != 200 for i in range(len(reqs))) \
                or st_pred != 200:
            fail(f"[{tag}] an endpoint did not answer 200: {res} {st_pred}")
        served = [res[i][1]["tokens"] for i in range(len(reqs))]
        d = {k: after[k] - before.get(k, 0.0) for k in after}
        hits = d["prefix_cache_hits_total"]
        full = d["prefills_total"] - hits
        draft_layers = len(dec.draft_model.encoder) if dec.speculate else 0
        need = (len(model.encoder) * (full + d["batcher_flushes_total"])
                + draft_layers * d["prefills_total"])
        launches += n
        gen = d["generated_tokens_total"]
        drafts = (f"{int(d['prefills_total'])} draft prefills of "
                  f"{draft_layers} layers, " if dec.speculate else "")
        print(f"[{tag}] {len(reqs)} concurrent /generate + 1 /predict: "
              f"{sum(map(len, served)) / wall:.1f} generated tokens/s, "
              f"{int(hits)} prefix hits, flash_fwd launches {n} over "
              f"{int(full)} full prefills, {drafts}"
              f"{int(d['batcher_flushes_total'])} /predict batches (need "
              f">= {int(need)}) ({card})", flush=True)
        if n < need:
            fail(f"[{tag}] flash_fwd ran {n} times, fewer than {need}")
        if not bool(torch.isfinite(dec._logits).all()):
            fail(f"[{tag}] non-finite logits in the decode engine")
        with torch.no_grad():
            for p, _ in reqs[:4]:
                lg = model.prefill_logits(torch.tensor([p], device=DEV),
                                          model.init_cache(1))
                if not bool(torch.isfinite(lg).all()):
                    fail(f"[{tag}] non-finite prefill logits")
        if dec.speculate:
            rate = d["spec_accepted_total"] / d["spec_proposed_total"]
            print(f"[{tag}] accept rate {rate:.4f} "
                  f"({int(d['spec_accepted_total'])} of "
                  f"{int(d['spec_proposed_total'])} proposals), "
                  f"{d['decode_steps_total'] / gen:.4f} target dispatches a "
                  f"generated token ({int(d['decode_steps_total'])} verify "
                  f"rounds, each over every active slot, for {int(gen)} "
                  f"tokens), {int(d['spec_draft_steps_total'])} draft "
                  f"slot-steps ({card})", flush=True)
            if dec.draft_model is dec.model and rate != 1.0:
                fail(f"[{tag}] the self-draft's accept rate is {rate}")
            greedy = [i for i, (_, kw) in enumerate(reqs) if not kw]
            diff = [i for i in greedy if served[i] != plain_served[i]]
            if diff:
                fail(f"[{tag}] greedy requests {diff} differ from phase 14's "
                     f"tokens without speculation: "
                     f"{[(served[i], plain_served[i]) for i in diff]}")
            print(f"[{tag}] the {len(greedy)} greedy requests equal phase "
                  f"14's tokens without speculation", flush=True)
        else:
            print(f"[{tag}] quant_agreement {prov['quant_agreement']}, "
                  f"quant_logit_max_err {prov['quant_logit_max_err']} "
                  f"against the bf16 model ({card})", flush=True)
        app.close()
        # the same traffic through engines of the server's route on the
        # same model: graphed (the server's tokens) and eager
        kw = dict(slots=PAGED_SLOTS, cache_dtype=torch.bfloat16,
                  device=DEV, kv_page_tokens=dec.page_tokens,
                  prefix_cache=True, speculate=dec.speculate,
                  draft_model=(None if dec.draft_model is dec.model
                               else dec.draft_model),
                  quantize=dec.quantize)
        routes = {}
        for graphs in (False, True):
            eng = DecodeEngine(model, graphs=graphs,
                               metrics=MetricsRegistry(), **kw)
            routes[graphs] = drive(eng, primer, reqs)
            if graphs:
                row = decode_row(torch, eng)
            eng.close()
        if routes[True] != served or routes[False] != routes[True]:
            fail(f"[{tag}] served, graphed and eager tokens differ: "
                 f"{[i for i in range(len(reqs)) if not served[i] == routes[True][i] == routes[False][i]]}")
        print(f"[{tag}] served = graphed = eager, every request (greedy and "
              f"sampled)", flush=True)
        table.append((tag, prov["weight_bytes"],
                      dec._kv.bytes_per_page * dec._kv.max_pages) + row)
        del app, dec, model, eng
        gc.collect()
        torch.cuda.empty_cache()
    for tag, wb, kvb, ms, tps, rate in table:
        acc = "" if rate is None else f", accept rate {rate:.4f}"
        print(f"[spec/quant] {MODEL} bf16, {PAGED_SLOTS} slots of "
              f"{PAGE_TOKENS}-token pages, graphed, {tag}: decode step "
              f"{ms:.3f} ms (host clock; a round when speculative), "
              f"{tps:.1f} decode tokens/s{acc}, weights {wb} bytes, KV "
              f"{kvb} bytes a full slot ({card})", flush=True)
    return launches


def bn_bound_ms(kernel, rows, c, item):
    """max(bytes / HBM rate, operations / f32 peak) of one BN kernel: every
    (rows, C) input read once and output written once (dy and x of
    bn_bwd_stats in their own dtype), the (C,) vectors in and out, and the
    f32 operations a value needs (sums, normalise, affine, mask, dx)."""
    n, vec = rows * c, 4 * c
    nbytes, ops = {"bn_stats": (n * item + 2 * vec, 3 * n),
                   "bn_bwd_stats": (2 * n * item + 4 * vec, 5 * n),
                   "bn_fwd_apply": (2 * n * item + 4 * vec, 6 * n),
                   "bn_bwd_fused": (3 * n * item + 6 * vec, 14 * n)}[kernel]
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def bn_repeat(torch, run, first):
    """{"same_bits": a second call gives ``first``'s bits, "graph_eq": so
    does a replay of the call captured in a CUDA graph}."""
    same = all(torch.equal(a, b) for a, b in zip(run(), first))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    graph.replay()
    torch.cuda.synchronize()
    replayed = all(torch.equal(a, b) for a, b in zip(static, first))
    del graph
    return {"same_bits": same, "graph_eq": replayed}


def check_bn(torch, shapes=None, timing=(20, 3)):
    """The four BN kernels against their plain versions at ``shapes``
    (default BN_SHAPES), bf16 and f32 (ReLU on and off for the fused
    pair), with device times (``timing``: device_ms's calls a graph and
    replays), the library's time and the bound. Returns {(kernel, shape,
    dtype, relu): row}."""
    from bigdl_tpu_torch.ops import bn_kernel as bk
    from bigdl_tpu_torch.tools.timing import device_ms

    def errs(got, ref):
        return ([float((a.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp_min(1e-30))
                 for a, r in zip(got, ref)],
                max(float((a.float() - r.float()).abs().max())
                    for a, r in zip(got, ref)))

    rows_out, bad = {}, []
    for b, h, w, c in shapes or BN_SHAPES:
        rows = b * h * w
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(rows + c)
            x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5
                 + 0.3).to(dtype)
            dy = torch.randn(rows, c, device="cuda", generator=g).to(dtype)
            gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
            beta = 0.2 * torch.randn(c, device="cuda", generator=g)
            _, mean, var = bk.bn_fwd_apply_reference(x, gamma, beta, BN_EPS)
            inv = torch.rsqrt(var + BN_EPS)
            # the library's NCHW-shaped channels_last views of (b, h, w, C)
            x4, dy4 = (t.view(b, h, w, c).permute(0, 3, 1, 2) for t in (x, dy))
            running = (torch.zeros(c, device="cuda"),
                       torch.ones(c, device="cuda"))
            cases = [
                ("bn_stats", False, lambda: bk.bn_stats(x),
                 lambda: bk.bn_stats_reference(x),
                 lambda: torch.batch_norm_stats(x4, BN_EPS)),
                ("bn_bwd_stats", False,
                 lambda: bk.bn_bwd_stats(dy, x, mean, inv),
                 lambda: bk.bn_bwd_stats_reference(dy, x, mean, inv),
                 lambda: torch.batch_norm_backward_reduce(
                     dy4, x4, mean, inv, gamma, True, True, True))]
            for relu in (False, True):
                cases += [
                    ("bn_fwd_apply", relu,
                     lambda r=relu: bk.bn_fwd_apply(x, gamma, beta, BN_EPS, r),
                     lambda r=relu: bk.bn_fwd_apply_reference(
                         x, gamma, beta, BN_EPS, r),
                     lambda: torch.batch_norm(x4, gamma, beta, *running,
                                              True, 0.1, BN_EPS, True)),
                    ("bn_bwd_fused", relu,
                     lambda r=relu: bk.bn_bwd_fused(dy, x, mean, inv, gamma,
                                                    beta, r),
                     lambda r=relu: bk.bn_bwd_fused_reference(
                         dy, x, mean, inv, gamma, beta, r),
                     lambda: torch.ops.aten.native_batch_norm_backward(
                         dy4, x4, gamma, None, None, mean, inv, True, BN_EPS,
                         [True, True, True]))]
            for kernel, relu, run, plain, library in cases:
                got, ref = run(), plain()
                torch.cuda.synchronize()
                rel, abs_err = errs(got, ref)
                # y/dx first for the fused pair; the rest are f32 sums,
                # means and vars
                tols = ([BN_TOL[dt]] if kernel in ("bn_fwd_apply",
                                                   "bn_bwd_fused") else [])
                tols += [BN_SUM_TOL] * (len(rel) - len(tols))
                finite = all(bool(torch.isfinite(t.float()).all())
                             for t in got)
                ok = finite and all(e <= t for e, t in zip(rel, tols))
                if kernel in REPEAT_CHECKED:
                    repeat = bn_repeat(torch, run, got)
                    ok = ok and all(repeat.values())
                row = {"shape": [rows, c], "dtype": dt, "relu": relu,
                       "rel_err": rel, "max_abs_err": abs_err, "ok": ok,
                       "ms": device_ms(run, *timing),
                       "plain_ms": device_ms(plain, *timing),
                       "library_ms": device_ms(library, *timing)}
                if kernel in REPEAT_CHECKED:
                    row.update(repeat)
                row["bound_ms"], row["bound_by"] = bn_bound_ms(
                    kernel, rows, c, x.element_size())
                rows_out[(kernel, (b, h, w, c), dt, relu)] = row
                print(f"{kernel} rows={rows} C={c} {dt} relu={int(relu)}: "
                      f"max|d|/max|ref| {['%.1e' % e for e in rel]} "
                      f"kernel_ms={row['ms']:.4f} plain_ms="
                      f"{row['plain_ms']:.4f} library_ms="
                      f"{row['library_ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                      + (f"same bits twice {int(repeat['same_bits'])} "
                         f"graph replay = eager {int(repeat['graph_eq'])} "
                         if kernel in REPEAT_CHECKED else "")
                      + f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append((kernel, rows, c, dt, relu, rel))
            del x, dy, x4, dy4
    if bad:
        fail(f"BN kernels disagree with their plain versions: {bad}")
    return rows_out


def resnet_runs(torch, card):
    """ResNet-50 training through ``cli.perf.run`` as each RESNET_ROWS
    row; returns {row: (result, launches)}."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    out = {}
    steps = RESNET_WARMUP + RESNET_ITERS
    for name, per_step in RESNET_ROWS.items():
        ops.reset_kernel_launches()
        res = perf.run(name, batch=RESNET_BATCH, iterations=RESNET_ITERS,
                       dtype=torch.bfloat16, warmup=RESNET_WARMUP,
                       data_type="random")
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        print(f"[{name}] bf16 batch {RESNET_BATCH} on {card}: "
              f"{res['records_per_second']} images/s over {RESNET_ITERS} "
              f"timed steps ({res['seconds']} s); fused_bn "
              f"{res['fused_bn']}; losses "
              f"{[round(v, 4) for v in res['losses']]}; launches "
              f"{ {k: v for k, v in n.items() if v} } over {steps} steps",
              flush=True)
        if not all(math.isfinite(v) for v in res["losses"]):
            fail(f"[{name}] non-finite loss: {res['losses']}")
        want = {k: per_step.get(k, 0) * steps for k in n}
        if n != want:
            fail(f"[{name}] kernel launches {n}, expected {want}")
        out[name] = (res, n)
        torch.cuda.empty_cache()
    return out


def bn_grads_check(torch):
    """One training step through the BN kernels against the same step with
    the four wrappers swapped for their plain versions (which the
    Functions then call), in both fused modes:

    * ``resnet_cifar(20)`` f32: the loss, every parameter gradient and the
      running statistics of the whole step;
    * ResNet-50 bf16 at full width: the loss of the whole step, and each of
      the 53 BatchNormalizations on the input and output gradient it met in
      the step through the kernels: y, dx, dγ, dβ and its running
      statistics, kernels against plain versions. The whole step's
      parameter gradients are printed, not held to a tolerance: beside
      them is the same step through the plain versions with their BN
      statistics summed in f64, which moves them as far with no kernel
      involved (a 50-layer network at init is that sensitive to how its
      BN sums round)."""
    from bigdl_tpu_torch import models, nn, ops
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import bn_kernel as bk

    names = ("bn_stats", "bn_bwd_stats", "bn_fwd_apply", "bn_bwd_fused")
    originals = {n: getattr(bk, n) for n in names}
    originals.update({n + "_reference": getattr(bk, n + "_reference")
                      for n in names})

    def stats_f64(x2d):
        xd = x2d.double()
        return xd.sum(0).float(), (xd * xd).sum(0).float()

    def bwd_stats_f64(dy2d, x2d, mean, inv):
        dd, xh = dy2d.double(), (x2d.float() - mean) * inv
        return dd.sum(0).float(), (dd * xh.double()).sum(0).float()

    def use_plain(plain, f64=False):
        """The wrappers (plain False), or their plain versions, whose
        statistics (``bn_stats_reference``, which ``bn_fwd_apply_reference``
        calls, and ``bn_bwd_stats_reference``) are summed in f64 when
        ``f64``."""
        for n, fn in originals.items():
            setattr(bk, n, fn)
        if f64:
            bk.bn_stats_reference = stats_f64
            bk.bn_bwd_stats_reference = bwd_stats_f64
        if plain:
            for n in names:
                setattr(bk, n, getattr(bk, n + "_reference"))

    def rel(a, r):
        return float((a.float() - r.float()).abs().max()
                     / r.float().abs().max().clamp_min(1e-30))

    crit = ClassNLLCriterion()
    cases = (("float32", "resnet_cifar(20)", (32, 32, 3), 10, BN_GRAD_BATCH),
             ("bfloat16", "resnet50", (224, 224, 3), 1000, BN_GRAD_BATCH))
    for dt, label, shape, classes, batch in cases:
        for mode in ("apply", "stats"):
            gen = torch.Generator().manual_seed(0)
            model = (models.resnet50(fused_bn=mode, generator=gen)
                     if label == "resnet50" else
                     models.resnet_cifar(20, fused_bn=mode, generator=gen))
            model = model.to(DEV).train()
            bns = {n: m for n, m in model.named_modules()
                   if isinstance(m, nn.BatchNormalization)}
            start = {k: v.clone() for k, v in model.state_dict().items()}
            g = torch.Generator().manual_seed(1)
            x = torch.randn(batch, *shape, generator=g).to(
                DEV, getattr(torch, dt))
            y = torch.randint(0, classes, (batch,), generator=g).to(DEV)
            seen = {}

            def record(name):
                def hook(mod, inp, out):
                    seen[name] = [inp[0].detach()]
                    out.register_hook(lambda d: seen[name].append(d))
                return hook

            def step(plain, f64=False):
                use_plain(plain, f64)
                hooks = [] if plain else [m.register_forward_hook(record(n))
                                          for n, m in bns.items()]
                try:
                    model.load_state_dict(start)
                    model.zero_grad(set_to_none=True)
                    ops.reset_kernel_launches()
                    loss = crit(model(x).float(), y)
                    loss.backward()
                    torch.cuda.synchronize()
                finally:
                    use_plain(False)
                    for h in hooks:
                        h.remove()
                return (float(loss.detach()),
                        {n: p.grad.float().clone()
                         for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()},
                        sum(ops.kernel_launches().values()))

            l_k, g_k, s_k, n_k = step(plain=False)
            l_t, g_t, s_t, n_t = step(plain=True)
            _, g_64, _, _ = step(plain=True, f64=True)
            if n_k == 0 or n_t != 0:
                fail(f"[bn grads {dt} {mode}] launches {n_k} / {n_t}: the "
                     f"two steps did not take their paths")
            if any(not bool(torch.isfinite(v).all()) for v in g_k.values()):
                fail(f"[bn grads {dt} {mode}] a non-finite gradient")
            errs = {n: rel(g_k[n], g_t[n]) for n in g_t}
            ranked = sorted(errs.values())
            worst, median = ranked[-1], ranked[len(ranked) // 2]
            f64 = sorted(rel(g_64[n], g_t[n]) for n in g_t)
            stat = max(rel(s_k[n], s_t[n]) for n in s_t)
            loss_rel = abs(l_k - l_t) / abs(l_t)
            print(f"[bn grads {dt} {mode}] {label} batch {batch}: loss "
                  f"{l_k:.6f} through the kernels, {l_t:.6f} through the "
                  f"plain versions; {len(errs)} parameter gradients "
                  f"max|dg|/max|g| worst {worst:.3e} "
                  f"({max(errs, key=errs.get)}), median {median:.3e} "
                  f"(the plain versions with f64 BN sums against f32: "
                  f"worst {f64[-1]:.3e}, median {f64[len(f64) // 2]:.3e}); "
                  f"running stats worst {stat:.3e}; launches {n_k}",
                  flush=True)
            if loss_rel > BN_LOSS_TOL[dt]:
                fail(f"[bn grads {dt} {mode}] losses differ by {loss_rel:.3e}")
            if dt == "float32" and (worst > BN_GRAD_TOL[0]
                                    or median > BN_GRAD_TOL[1]
                                    or stat > BN_STAT_TOL):
                fail(f"[bn grads {dt} {mode}] the step through the kernels "
                     f"differs from the plain versions' (gradients worst "
                     f"{worst:.3e}, median {median:.3e}; stats {stat:.3e})")
            # each BN on what it met in the step through the kernels
            layer = {"y": 0.0, "dx": 0.0, "dgamma": 0.0, "dbeta": 0.0,
                     "running": 0.0}
            for name, m in bns.items():
                xin, dy = seen[name]
                outs = []
                for plain in (False, True):
                    use_plain(plain)
                    saved = (m.running_mean.clone(), m.running_var.clone())
                    try:
                        xx = xin.clone().requires_grad_()
                        out = m(xx)
                        grads = torch.autograd.grad(
                            out, (xx, m.weight, m.bias), dy)
                        outs.append((out, *grads, m.running_mean.clone(),
                                     m.running_var.clone()))
                    finally:
                        use_plain(False)
                        m.running_mean.copy_(saved[0])
                        m.running_var.copy_(saved[1])
                (yk, dxk, dgk, dbk, rmk, rvk), (yt, dxt, dgt, dbt, rmt,
                                                 rvt) = outs
                for key, e in (("y", rel(yk, yt)), ("dx", rel(dxk, dxt)),
                               ("dgamma", rel(dgk, dgt)),
                               ("dbeta", rel(dbk, dbt)),
                               ("running", max(rel(rmk, rmt),
                                               rel(rvk, rvt)))):
                    layer[key] = max(layer[key], e)
            print(f"[bn layers {dt} {mode}] {label}: {len(bns)} "
                  f"BatchNormalizations on the step's own inputs, kernels "
                  f"vs plain versions, worst max|d|/max|ref| "
                  f"{ {k: float('%.2e' % v) for k, v in layer.items()} } "
                  f"(tolerances y/dx {BN_TOL[dt]:.0e}, the rest "
                  f"{BN_SUM_TOL:.0e})", flush=True)
            if (max(layer["y"], layer["dx"]) > BN_TOL[dt]
                    or max(layer["dgamma"], layer["dbeta"],
                           layer["running"]) > BN_SUM_TOL):
                fail(f"[bn layers {dt} {mode}] a BN layer through the "
                     f"kernels differs from the plain versions: {layer}")
            del model, seen
            torch.cuda.empty_cache()


def write_cifar(folder, n, seed=0, banded=False):
    """cifar-10-binary files of ``n`` random records each: five
    ``data_batch_<i>.bin`` and a ``test_batch.bin``. With ``banded`` the
    pixels are at most 127 and label k lights rows 3k..3k+2 of every
    channel (a class a model can learn)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
        if banded:
            img = rec[:, 1:].reshape(n, 3, 32, 32) // 2
            rows = 3 * rec[:, :1] + np.arange(3)  # (n, 3)
            img[np.arange(n)[:, None], :, rows] = 250
            rec[:, 1:] = img.reshape(n, 3072)
        rec.astype(np.uint8).tofile(os.path.join(folder, name))


def cifar_cli_run(torch):
    """``cli.resnet train --dataset cifar10 --fusedBN apply
    --stepsPerDispatch OPT_K --checkpoint DIR`` for one epoch, then
    ``cli.resnet test --model DIR``: its top-1 line must be the training
    run's last validation line. Returns the training run's launches."""
    import contextlib
    import io
    import tempfile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import resnet as resnet_cli

    with tempfile.TemporaryDirectory() as tmp, LogLines() as lines:
        write_cifar(tmp, CIFAR_RECORDS)
        ck = os.path.join(tmp, "ckpt")
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        resnet_cli.main(["train", "--dataset", "cifar10", "-f", tmp,
                         "--fusedBN", "apply", "-b", str(CIFAR_BATCH),
                         "--maxEpoch", "1", "--logEvery", "1",
                         "--stepsPerDispatch", str(OPT_K),
                         "--checkpoint", ck])
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        trains = [ln for ln in lines
                  if re.match(r"Train \d+ in .*Loss is ", ln)]
        top1 = [ln for ln in lines if ln.startswith("top1 accuracy is ")]
        files = sorted(os.listdir(ck))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resnet_cli.main(["test", "-f", tmp, "--model", ck, "-b",
                             str(CIFAR_BATCH)])
        tested = [ln for ln in out.getvalue().splitlines()
                  if ln.startswith("top1 accuracy is ")]
    iters = sum(int(re.match(r"Train (\d+) ", ln).group(1)) for ln in
                trains) // CIFAR_BATCH
    print(f"[cifar cli] {time.perf_counter() - t0:.1f}s, {len(trains)} "
          f"'Train ... Loss is' lines over {iters} iterations (last: "
          f"{trains[-1] if trains else None!r}); "
          f"{top1[-1] if top1 else 'no top1 line'}; checkpoint {files}; "
          f"test: {tested[-1] if tested else 'no top1 line'}; launches "
          f"{ {k: v for k, v in n.items() if v} }", flush=True)
    if not trains or not top1:
        fail("[cifar cli] no 'Train ... Loss is' or 'top1 accuracy' line")
    if not tested or tested[-1] != top1[-1]:
        fail(f"[cifar cli] test gives {tested[-1:]}, the training run's "
             f"last validation {top1[-1]!r}")
    want = dict({k: 0 for k in n}, bn_fwd_apply=19 * iters,
                bn_bwd_fused=19 * iters)
    if n != want:
        fail(f"[cifar cli] launches {n}, expected {want} (19 BNs an "
             f"iteration)")
    return n


class LossRecorder:
    """A criterion that also writes each step's loss into a device buffer
    at a device index, with no host sync: under a CUDA graph each replayed
    step writes its own slot, so every step's loss is read after the run."""

    def __init__(self, torch, crit, n, device):
        self.crit = crit
        self.buf = torch.full((n,), float("nan"), device=device)
        self.i = torch.zeros(1, dtype=torch.int64, device=device)

    def __call__(self, out, target):
        loss = self.crit(out, target)
        self.buf.index_copy_(0, self.i, loss.detach().float().view(1))
        self.i.add_(1)
        return loss

    def losses(self):
        return self.buf[:int(self.i)].tolist()


def optimizer_run(torch, make_model, data, k, end, compute_dtype=None,
                  ckpt=None, resume=None, shuffle=False, strategy=None,
                  graph_stats=None, crit=None):
    """One ``Optimizer`` run (SGD(0.01, momentum 0.9) with the schedule
    Poly(0.5, POLY_ITERS)) over ``data``
    (a list of (x, y) batches, held in a ``BatchDataSet``) with
    ``steps_per_dispatch=k`` up to iteration ``end``, checkpointing every
    ``k`` iterations into ``ckpt`` (keep_last=1) and resuming from
    ``resume`` when given, under ``strategy`` (a ``DataParallel``) when
    given; returns (every step's loss, kernel launches, images/s of the
    dispatches after the first two, log lines). A ``graph_stats`` dict
    gets the step graph's capture and instantiate seconds (None where no
    graph was captured). ``crit``: the criterion (``ClassNLLCriterion``
    unless given)."""
    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Poly, Trigger

    x = np.concatenate([b[0] for b in data])
    y = np.concatenate([b[1] for b in data])
    batch = len(data[0][0])
    model = make_model()
    rec = LossRecorder(torch, crit or ClassNLLCriterion(), end, DEV)
    opt = Optimizer(model, BatchDataSet(x, y, batch, shuffle=shuffle), rec,
                    optim_method=SGD(0.01, momentum=0.9,
                                     schedule=Poly(0.5, POLY_ITERS)),
                    end_when=Trigger.max_iteration(end), log_every=1,
                    compute_dtype=compute_dtype, steps_per_dispatch=k,
                    strategy=strategy, device=DEV)
    if ckpt:
        opt.set_checkpoint(Trigger.several_iteration(k), ckpt,
                           keep_last=1)
    if resume:
        opt.resume(resume)
    with LogLines() as lines:
        ops.reset_kernel_launches()
        opt.optimize()
        torch.cuda.synchronize()
        n = ops.kernel_launches()
    rates = [float(m.group(1)) for m in (
        re.search(r"Throughput is ([0-9.]+) records/second", ln)
        for ln in lines) if m]
    steady = rates[2:] or rates
    ips = sorted(steady)[len(steady) // 2] if steady else float("nan")
    if graph_stats is not None:
        g = opt._graph
        graph_stats.update(
            capture_s=getattr(g, "capture_s", None),
            instantiate_s=getattr(g, "instantiate_s", None))
    del opt, model
    torch.cuda.empty_cache()
    return rec.losses(), n, ips, list(lines)


def image_batches(n, batch, shape, classes, seed):
    """``n`` seeded random (x, y) batches: N(0, 1) f32 images, labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch,) + shape, dtype=np.float32),
             rng.integers(0, classes, batch).astype(np.int32))
            for _ in range(n)]


def diff(a, b):
    """max |a - b| over two loss lists of one length, inf if they differ
    in length."""
    if len(a) != len(b):
        return float("inf")
    return max((abs(u - v) for u, v in zip(a, b)), default=0.0)


def graphed_optimizer_runs(torch, card):
    """The training loop as a user runs it, eager (twice) and as CUDA
    graphs of ``OPT_K`` steps: ResNet-50 ``_fba`` in bf16 at batch 128
    over ``OPT_BATCHES`` batches for ``OPT_STEPS`` steps, and
    ``resnet_cifar(20)`` f32 ``--fusedBN apply`` over ``CIFAR_OPT_BATCHES``
    for ``CIFAR_OPT_STEPS`` (dispatch groups, ragged tails and an epoch
    boundary). cuDNN runs its deterministic algorithms here, so two eager
    runs agree bit for bit and a graph must too. Returns the launches of
    every run."""
    import math

    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.cli import perf

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cases = [
        ("resnet50_fba", lambda: perf.build_model("resnet50_fba",
                                                  generator=gen())[0],
         image_batches(OPT_BATCHES, RESNET_BATCH, (224, 224, 3), 1000, 1),
         OPT_STEPS, torch.bfloat16, 53),
        ("resnet_cifar20", lambda: models.resnet_cifar(
            20, 10, fused_bn="apply", generator=gen()),
         image_batches(CIFAR_OPT_BATCHES, CIFAR_BATCH, (32, 32, 3), 10, 2),
         CIFAR_OPT_STEPS, None, 19)]
    launches = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make, data, steps, dt, n_bn in cases:
            runs = {}
            for tag, k in (("eager", 1), ("eager again", 1),
                           (f"graph K={OPT_K}", OPT_K)):
                t0 = time.perf_counter()
                losses, n, ips, _ = optimizer_run(torch, make, data, k, steps,
                                                  compute_dtype=dt)
                print(f"[optimizer {name} {tag}] on {card}: {steps} steps in "
                      f"{time.perf_counter() - t0:.1f}s, {ips:.1f} images/s "
                      f"(median dispatch past the first two); BN launches "
                      f"{n['bn_fwd_apply']} + {n['bn_bwd_fused']}; losses "
                      f"{losses}", flush=True)
                if len(losses) != steps or not all(
                        math.isfinite(v) for v in losses):
                    fail(f"[optimizer {name} {tag}] expected {steps} finite "
                         f"losses, got {losses}")
                want = dict({kk: 0 for kk in n}, bn_fwd_apply=n_bn * steps,
                            bn_bwd_fused=n_bn * steps)
                if n != want:
                    fail(f"[optimizer {name} {tag}] launches {n}, expected "
                         f"{want}")
                runs[tag] = losses
                launches.append(n)
            ee = diff(runs["eager"], runs["eager again"])
            ge = diff(runs[f"graph K={OPT_K}"], runs["eager"])
            print(f"[optimizer {name}] max |loss| difference: eager vs "
                  f"eager {ee}, graph vs eager {ge}", flush=True)
            if ge > ee:
                fail(f"[optimizer {name}] the graphed losses differ from the "
                     f"eager ones by {ge}, more than two eager runs ({ee})")
    finally:
        torch.backends.cudnn.deterministic = det
    return launches


def resume_runs(torch, card):
    """Checkpoint and resume on the card, graphed (K = ``OPT_K``): an
    uninterrupted run of 4*K steps; a run stopped at K (``end_when``) that
    checkpoints every K steps (keep_last=1); a second ``Optimizer`` that
    resumes from that directory and runs to 4*K, capturing its graph after
    the resume loaded the static tensors. Its losses must be those of the
    uninterrupted run's last 3*K steps, bit for bit (cuDNN deterministic),
    for ``resnet_cifar(20)`` f32 and ResNet-50 ``_fba`` bf16, both over a
    shuffled epoch boundary. Returns the launches of every run."""
    import tempfile

    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.cli import perf

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    steps = 4 * OPT_K
    cases = [
        ("resnet_cifar20", lambda: models.resnet_cifar(
            20, 10, fused_bn="apply", generator=gen()),
         image_batches(3 * OPT_K, CIFAR_BATCH, (32, 32, 3), 10, 3), None),
        ("resnet50_fba", lambda: perf.build_model("resnet50_fba",
                                                  generator=gen())[0],
         image_batches(3 * OPT_K, RESNET_BATCH, (224, 224, 3), 1000, 4),
         torch.bfloat16)]
    launches = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make, data, dt in cases:
            with tempfile.TemporaryDirectory() as ck:
                full, n0, _, _ = optimizer_run(torch, make, data, OPT_K,
                                               steps, dt, shuffle=True)
                head, n1, _, _ = optimizer_run(torch, make, data, OPT_K,
                                               OPT_K, dt, ckpt=ck,
                                               shuffle=True)
                files = sorted(os.listdir(ck))
                tail, n2, _, lines = optimizer_run(
                    torch, make, data, OPT_K, steps, dt, ckpt=ck, resume=ck,
                    shuffle=True)
                files_after = sorted(os.listdir(ck))
            resumed = [ln for ln in lines if ln.startswith("Resuming at ")]
            d = diff(tail, full[OPT_K:])
            print(f"[resume {name}] on {card}: stopped at {OPT_K} steps "
                  f"({files}); {resumed[0] if resumed else 'no resume line'};"
                  f" after: {files_after}; steps {OPT_K + 1}-{steps} max "
                  f"|loss| difference against the uninterrupted run: {d}; "
                  f"losses {tail}", flush=True)
            if head != full[:OPT_K]:
                fail(f"[resume {name}] the first {OPT_K} steps differ: "
                     f"{head} vs {full[:OPT_K]}")
            if not resumed or d != 0.0:
                fail(f"[resume {name}] the resumed run is not the "
                     f"uninterrupted one: {tail} vs {full[OPT_K:]}")
            if files_after != [f"{p}.{steps}{e}" for p in ("model", "state")
                               for e in ("", ".manifest.json", ".sha256")]:
                fail(f"[resume {name}] keep_last=1 left {files_after}")
            launches += [n0, n1, n2]
    finally:
        torch.backends.cudnn.deterministic = det
    return launches


def inner_steps_runs(torch, card):
    """``cli.perf`` with ``inner_steps`` = K: K SGD steps on the resident
    batch as one CUDA graph a dispatch, for ResNet-50 ``_fba`` and
    ``_fbn`` (bf16, batch 128) and the LM (bf16, batch 8, remat off and
    full); finite falling losses, and each kernel's launches over every
    step, the graph's replays included. Returns {row: (result,
    launches)}."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    rows = [(name, dict(batch=RESNET_BATCH, data_type="random"),
             {k: v for k, v in per.items()}, None)
            for name, per in RESNET_ROWS.items() if per]
    rows += [(MODEL, dict(batch=TRAIN_BATCH, remat=remat),
              {"flash_fwd": 24 if remat else 12, "flash_dq": 12,
               "flash_dkv": 12}, remat) for remat in (False, "full")]
    out = {}
    for name, kw, per_step, remat in rows:
        ops.reset_kernel_launches()
        res = perf.run(name, iterations=INNER_ITERS, dtype=torch.bfloat16,
                       warmup=1, inner_steps=OPT_K, **kw)
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        steps = (1 + INNER_ITERS) * OPT_K
        rate = (f"{res['tokens_per_second']} tokens/s"
                if res["tokens_per_second"] else
                f"{res['records_per_second']} images/s")
        tag = f"{name}{' remat=full' if remat else ''}"
        print(f"[innerSteps {OPT_K} {tag}] bf16 batch {res['batch']} on "
              f"{card}: {rate} over {INNER_ITERS} x {OPT_K} graphed steps "
              f"({res['seconds']} s); losses "
              f"{[round(v, 4) for v in res['losses']]}; launches "
              f"{ {k: v for k, v in n.items() if v} } over {steps} steps",
              flush=True)
        if not all(math.isfinite(v) for v in res["losses"]):
            fail(f"[innerSteps {tag}] non-finite loss: {res['losses']}")
        if not res["losses"][-1] < res["losses"][0]:
            fail(f"[innerSteps {tag}] the loss did not fall: "
                 f"{res['losses']}")
        want = {k: per_step.get(k, 0) * steps for k in n}
        if n != want:
            fail(f"[innerSteps {tag}] launches {n}, expected {want}")
        out[tag] = (res, n)
        torch.cuda.empty_cache()
    return out


def native_build():
    """Phase 15 (a): build and load the native library; print its flavour.
    Returns whether it decodes JPEG."""
    from bigdl_tpu_torch.dataset import native

    t0 = time.perf_counter()
    if not native.available():
        fail(f"[native] the native library did not build or load: "
             f"{native.load_error()}")
    jpeg = native.jpeg_available()
    print(f"[native] {native.library_path()} loaded in "
          f"{time.perf_counter() - t0:.1f}s, flavour: "
          f"{'with libjpeg' if jpeg else 'without libjpeg (JPEG decodes through PIL)'}",
          flush=True)
    return jpeg


class _Recorded:
    """Installs ``rec`` as what ``nn.ClassNLLCriterion()`` builds while in
    use, so a CLI run's criterion records every step's loss on the
    device."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        from bigdl_tpu_torch import nn

        self.orig = nn.ClassNLLCriterion
        nn.ClassNLLCriterion = lambda *a, **k: self.rec
        return self.rec

    def __exit__(self, *exc):
        from bigdl_tpu_torch import nn

        nn.ClassNLLCriterion = self.orig


def pipeline_cifar_runs(torch):
    """Phase 15 (b): the CIFAR CLI, augmented by the native pipeline,
    graphed (K = OPT_K), over 2 epochs, in every (stage, workers) pair;
    cuDNN deterministic, so every run's losses must be the first's, bit
    for bit. Returns the launches of every run."""
    import math
    import tempfile

    from bigdl_tpu_torch import nn, ops
    from bigdl_tpu_torch.cli import resnet as resnet_cli

    steps = 2 * (5 * CIFAR_RECORDS // CIFAR_BATCH)
    runs, launches = {}, []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar(tmp, CIFAR_RECORDS)
            for stage in PIPE_STAGES:
                for workers in PIPE_WORKERS:
                    rec = LossRecorder(torch, nn.ClassNLLCriterion(), steps,
                                       DEV)
                    t0 = time.perf_counter()
                    with _Recorded(rec), LogLines() as lines:
                        ops.reset_kernel_launches()
                        resnet_cli.main(
                            ["train", "--dataset", "cifar10", "-f", tmp,
                             "--fusedBN", "apply", "-b", str(CIFAR_BATCH),
                             "--maxEpoch", "2", "--logEvery", "10",
                             "--stepsPerDispatch", str(OPT_K), "--stage",
                             stage, "--dataWorkers", str(workers)])
                        torch.cuda.synchronize()
                        n = ops.kernel_launches()
                    losses = rec.losses()
                    top1 = [ln for ln in lines
                            if ln.startswith("top1 accuracy is ")]
                    tag = f"--stage {stage} --dataWorkers {workers}"
                    print(f"[pipeline cifar {tag}] {steps} steps in "
                          f"{time.perf_counter() - t0:.1f}s; "
                          f"{top1[-1] if top1 else 'no top1 line'}; BN "
                          f"launches {n['bn_fwd_apply']} + "
                          f"{n['bn_bwd_fused']}; losses {losses}",
                          flush=True)
                    if len(losses) != steps or not all(
                            math.isfinite(v) for v in losses):
                        fail(f"[pipeline cifar {tag}] expected {steps} "
                             f"finite losses, got {losses}")
                    want = dict({k: 0 for k in n}, bn_fwd_apply=19 * steps,
                                bn_bwd_fused=19 * steps)
                    if n != want:
                        fail(f"[pipeline cifar {tag}] launches {n}, "
                             f"expected {want} (19 BNs a step)")
                    runs[tag] = losses
                    launches.append(n)
    finally:
        torch.backends.cudnn.deterministic = det
    first = next(iter(runs.values()))
    differ = [tag for tag, v in runs.items() if v != first]
    print(f"[pipeline cifar] losses bit-equal across {len(runs)} runs: "
          f"{not differ}", flush=True)
    if differ:
        fail(f"[pipeline cifar] the losses of {differ} differ from "
             f"{next(iter(runs))}'s")
    return launches


class EpochClock:
    """A dataset wrapper that notes when each epoch's iteration starts;
    at the second epoch's start it first waits for the card, so the clock
    starts on an idle device. Everything else passes through."""

    def __init__(self, torch, inner):
        self.torch, self.inner, self.starts = torch, inner, []

    def __iter__(self):
        if len(self.starts) == 1:
            self.torch.cuda.synchronize()
        self.starts.append(time.perf_counter())
        return iter(self.inner)

    def size(self):
        return self.inner.size()

    def shuffle(self, seed=None):
        self.inner.shuffle(seed)

    def skip_epoch(self):
        self.inner.skip_epoch()


def native_feed(np, seed=0):
    """Phase 15 (c)'s feed: NativePrefetchDataSet over PIPE_IMAGES seeded
    uint8 images of PIPE_SIDE^2 x 3 and labels of 1000 classes."""
    from bigdl_tpu_torch.dataset import (IMAGENET_MEAN, IMAGENET_STD,
                                         NativePrefetchDataSet)

    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (PIPE_IMAGES, PIPE_SIDE, PIPE_SIDE, 3),
                        dtype=np.uint8)
    labels = rs.randint(0, 1000, PIPE_IMAGES).astype(np.int32)
    return lambda: NativePrefetchDataSet(
        images, labels, RESNET_BATCH, crop=(PIPE_CROP, PIPE_CROP),
        train=True, mean=IMAGENET_MEAN, std=IMAGENET_STD, seed=seed,
        n_threads=PIPE_THREADS)


def feed_rates(torch, make, card):
    """The feed alone (no model): images/s of the native pipeline and of
    it behind each staging mode (device batches claimed by the current
    stream, the copies synchronised at the end), over PIPE_EPOCHS epochs
    after a warm-up one (threads, pinned blocks, page mappings)."""
    from bigdl_tpu_torch.dataset.pipeline import DeviceBatch, wrap_pipeline

    out = {}
    for stage in PIPE_STAGES:
        ds, _ = wrap_pipeline(make(), stage=stage, depth=2)
        for _ in ds:
            pass
        ds.shuffle()
        torch.cuda.synchronize()
        n, t0 = 0, time.perf_counter()
        for _ in range(PIPE_EPOCHS):
            for b in ds:
                if isinstance(b, DeviceBatch):
                    b.claim()
                n += len(b.input)
            ds.shuffle()
        torch.cuda.synchronize()
        out[stage] = n / (time.perf_counter() - t0)
        print(f"[feed] native pipeline, --stage {stage}, no model, on "
              f"{card}: {out[stage]:.1f} images/s ({n} images, "
              f"{PIPE_THREADS} threads)", flush=True)
    return out


def fed_optimizer_run(torch, dataset, steps):
    """ResNet-50 ``_fba`` through ``Optimizer(steps_per_dispatch=OPT_K)``
    in bf16 over ``dataset`` for PIPE_EPOCHS epochs, one log point (hence
    one sync) at the end, so the loop runs ahead of the card across epoch
    boundaries as a long epoch would; returns (losses, launches, images/s
    over epochs 2.., from an idle card to the end, phase seconds)."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    model = perf.build_model("resnet50_fba",
                             generator=torch.Generator().manual_seed(0))[0]
    rec = LossRecorder(torch, ClassNLLCriterion(), steps, DEV)
    clock = EpochClock(torch, dataset)
    per_epoch = steps // PIPE_EPOCHS
    opt = Optimizer(model, clock, rec,
                    optim_method=SGD(0.01, momentum=0.9),
                    end_when=Trigger.max_epoch(PIPE_EPOCHS),
                    log_every=steps, compute_dtype=torch.bfloat16,
                    steps_per_dispatch=OPT_K, device=DEV)
    with LogLines():
        ops.reset_kernel_launches()
        opt.optimize()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        n = ops.kernel_launches()
    ips = (PIPE_EPOCHS - 1) * per_epoch * RESNET_BATCH / (
        t_end - clock.starts[1])
    phases = opt.phase_totals()
    del opt, model
    torch.cuda.empty_cache()
    return rec.losses(), n, ips, phases


class _Resident:
    """A dataset of batches already on the card (each a DeviceBatch with
    nothing to wait for)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def size(self):
        return sum(len(b.input) for b in self.batches)

    def shuffle(self, seed=None):
        pass


def resnet50_feed_runs(torch, card):
    """Phase 15 (c): the feed alone, then the graphed ResNet-50 loop fed
    by it through each staging mode, beside the loop over batches already
    on the card and cli.perf's graphed step on a resident batch, in
    cuDNN's default mode (the resident step also in its deterministic
    mode). Returns (rows, launches of every run)."""
    import math

    import numpy as np

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.dataset.pipeline import DeviceBatch, wrap_pipeline
    from bigdl_tpu_torch import ops

    if torch.backends.cudnn.deterministic:
        fail("[resnet50 feed] cuDNN deterministic is on outside phases "
             "12-13")
    make = native_feed(np)
    rows = {"feed": feed_rates(torch, make, card)}
    per_epoch = PIPE_IMAGES // RESNET_BATCH
    steps = PIPE_EPOCHS * per_epoch
    first = [DeviceBatch(torch.as_tensor(b.input).to(DEV),
                         torch.as_tensor(b.target).to(DEV))
             for _, b in zip(range(per_epoch), make())]
    cases = [("resident on the card", lambda: _Resident(first))]
    cases += [(f"native --stage {stage}",
               lambda stage=stage: wrap_pipeline(make(), stage=stage,
                                                 depth=2)[0])
              for stage in ("host", "device")]
    launches = []
    for tag, build in cases:
        losses, n, ips, ph = fed_optimizer_run(torch, build(), steps)
        print(f"[resnet50 feed] Optimizer graphed K={OPT_K}, bf16 batch "
              f"{RESNET_BATCH}, {tag}, on {card}: {ips:.1f} images/s over "
              f"epochs 2-{PIPE_EPOCHS}; data_wait "
              f"{ph.get('data_wait', 0.0):.3f}s, h2d {ph.get('h2d', 0.0):.3f}s,"
              f" h2d_staged {ph.get('h2d_staged', 0.0):.3f}s, dispatch "
              f"{ph.get('dispatch', 0.0):.3f}s over {steps} steps; losses "
              f"{[round(v, 4) for v in losses]}", flush=True)
        if len(losses) != steps or not all(math.isfinite(v)
                                           for v in losses):
            fail(f"[resnet50 feed {tag}] expected {steps} finite losses, "
                 f"got {losses}")
        want = dict({k: 0 for k in n}, bn_fwd_apply=53 * steps,
                    bn_bwd_fused=53 * steps)
        if n != want:
            fail(f"[resnet50 feed {tag}] launches {n}, expected {want}")
        rows[tag] = {"images_per_s": ips, **ph}
        launches.append(n)
    del first
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            ops.reset_kernel_launches()
            res = perf.run("resnet50_fba", batch=RESNET_BATCH,
                           iterations=steps // OPT_K, dtype=torch.bfloat16,
                           warmup=1, inner_steps=OPT_K, data_type="random")
            torch.cuda.synchronize()
            n = ops.kernel_launches()
        finally:
            torch.backends.cudnn.deterministic = False
        mode = "deterministic" if det else "default"
        print(f"[resnet50 feed] cli.perf --innerSteps {OPT_K} on a resident "
              f"batch, cuDNN {mode} mode, on {card}: "
              f"{res['records_per_second']} images/s", flush=True)
        total = (1 + steps // OPT_K) * OPT_K
        want = dict({k: 0 for k in n}, bn_fwd_apply=53 * total,
                    bn_bwd_fused=53 * total)
        if n != want or not all(math.isfinite(v) for v in res["losses"]):
            fail(f"[resnet50 feed] cli.perf resident ({mode}): launches "
                 f"{n} (expected {want}), losses {res['losses']}")
        rows[f"cli.perf resident, cuDNN {mode}"] = res["records_per_second"]
        launches.append(n)
        torch.cuda.empty_cache()
    return rows, launches


def record_path_run(torch, card, jpeg):
    """Phase 15 (d): seeded JPEG shards through ``cli.perf --data
    record:DIR --dataWorkers 8 --stage device`` (ResNet-50 ``_fba``, bf16,
    batch 128). The shards are written with PIL; where there is no PIL
    the phase reports that it waits. Returns the run's launches (None
    when it waits)."""
    import io
    import math
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.dataset.recordfile import (RecordWriter,
                                                    pack_image_record)

    try:
        from PIL import Image
    except ImportError:
        print("[record path] waits: no PIL here to write JPEG shards",
              flush=True)
        return None
    rs = np.random.RandomState(7)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for s in range(PIPE_JPEGS // 128):
            with RecordWriter(os.path.join(
                    tmp, f"rec-{s:05d}-of-{PIPE_JPEGS // 128:05d}.btr")) as w:
                for _ in range(128):
                    buf = io.BytesIO()
                    Image.fromarray(rs.randint(
                        0, 256, (PIPE_SIDE, PIPE_SIDE, 3)).astype(
                        np.uint8)).save(buf, format="JPEG", quality=90)
                    w.write(pack_image_record(int(rs.randint(0, 1000)),
                                              buf.getvalue()))
        made = time.perf_counter() - t0
        ops.reset_kernel_launches()
        res = perf.run("resnet50_fba", batch=RESNET_BATCH,
                       iterations=PIPE_RECORD_ITERS, dtype=torch.bfloat16,
                       warmup=2, data_source=f"record:{tmp}",
                       data_workers=8, prefetch_depth=2, stage="device")
        torch.cuda.synchronize()
        n = ops.kernel_launches()
    print(f"[record path] {PIPE_JPEGS} seeded JPEGs of {PIPE_SIDE}^2 in "
          f"{made:.1f}s; cli.perf -m resnet50_fba --data record:DIR "
          f"--dataWorkers 8 --stage device, bf16 batch {RESNET_BATCH}, "
          f"JPEG decoded by {'libjpeg' if jpeg else 'PIL'}, on {card}: "
          f"{res['records_per_second']} images/s; losses "
          f"{[round(v, 4) for v in res['losses']]}", flush=True)
    steps = 2 + PIPE_RECORD_ITERS
    want = dict({k: 0 for k in n}, bn_fwd_apply=53 * steps,
                bn_bwd_fused=53 * steps)
    if n != want or not all(math.isfinite(v) for v in res["losses"]):
        fail(f"[record path] launches {n} (expected {want}), losses "
             f"{res['losses']}")
    return n


def pipeline_runs(torch, card):
    """Phase 15: returns (rows of (c), launches of every run)."""
    jpeg = native_build()
    launches = pipeline_cifar_runs(torch)
    rows, n = resnet50_feed_runs(torch, card)
    launches += n
    n = record_path_run(torch, card, jpeg)
    if n is not None:
        launches.append(n)
    return rows, launches


def write_mnist(folder, n_train, n_test, seed=0):
    """MNIST idx files (``train-*`` and ``t10k-*``) of 28 x 28 images:
    noise up to 59, and label k lights rows 2k+4..2k+6."""
    import struct

    import numpy as np

    rs = np.random.RandomState(seed)
    for stem, n in (("train", n_train), ("t10k", n_test)):
        y = rs.randint(0, 10, n).astype(np.uint8)
        x = rs.randint(0, 60, (n, 28, 28)).astype(np.uint8)
        x[np.arange(n)[:, None], 2 * y[:, None] + 4 + np.arange(3)] = 220
        with open(os.path.join(folder, f"{stem}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with open(os.path.join(folder, f"{stem}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.tobytes())


def _train_lines(lines, batch):
    """(losses of the full-batch ``Train`` lines, images/s of each
    ``Epoch ... done`` line)."""
    losses = [float(m.group(2)) for m in (
        re.match(r"Train (\d+) in .*Loss is (\S+)", ln) for ln in lines)
        if m and int(m.group(1)) == batch]
    rates = [float(m.group(1)) for m in (
        re.search(r"Epoch \d+ done: .*\(([\d.]+) rec/s", ln)
        for ln in lines) if m]
    return losses, rates


def _falls(losses, k=3):
    import math
    return (len(losses) >= 2 * k and all(math.isfinite(v) for v in losses)
            and sum(losses[-k:]) < sum(losses[:k]))


def lenet_run(torch, card):
    """``cli.lenet train -b 128 --maxEpoch 2 --checkpoint DIR`` on seeded
    MNIST-sized idx files, then ``cli.lenet test --model DIR``: finite
    falling losses, Top-1 far above chance (0.1), the test's Top-1 the
    training run's last validation; images/s of each epoch."""
    import contextlib
    import io
    import tempfile

    from bigdl_tpu_torch.cli import lenet as lenet_cli

    with tempfile.TemporaryDirectory() as tmp, LogLines() as lines:
        write_mnist(tmp, MNIST_TRAIN, MNIST_TEST)
        ck = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        lenet_cli.main(["train", "-f", tmp, "-b", str(VGG_BATCH),
                        "--maxEpoch", str(LENET_EPOCHS), "--logEvery", "20",
                        "--checkpoint", ck])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lenet_cli.main(["test", "-f", tmp, "--model", ck, "-b",
                            str(VGG_BATCH)])
    losses, rates = _train_lines(lines, VGG_BATCH)
    top1 = [ln for ln in lines if ln.startswith("top1 accuracy is ")]
    tested = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("top1 accuracy is ")]
    acc = (float(re.search(r"AccuracyResult\(([\d.]+)", tested[-1]).group(1))
           if tested else 0.0)
    print(f"[lenet5 cli] MNIST {MNIST_TRAIN} images x {LENET_EPOCHS} "
          f"epochs at batch {VGG_BATCH} in {secs:.1f}s on {card}: "
          f"{[round(r, 1) for r in rates]} images/s per epoch; losses "
          f"{[round(v, 4) for v in losses[:3]]} ... "
          f"{[round(v, 4) for v in losses[-3:]]}; "
          f"{top1[-1] if top1 else 'no top1 line'}; test: "
          f"{tested[-1] if tested else 'no top1 line'}", flush=True)
    if not _falls(losses):
        fail(f"[lenet5 cli] losses not finite and falling: {losses}")
    if not tested or not top1 or tested[-1] != top1[-1] or acc < 0.5:
        fail(f"[lenet5 cli] top-1 {tested[-1:]} (training's last "
             f"{top1[-1:]}), expected the same and >= 0.5")
    return {"images_per_s": rates, "top1": acc}


def vgg_runs(torch, card):
    """``cli.vgg train -b 128 --maxEpoch 1`` on seeded class-banded CIFAR
    records, once with ``--fusedBN apply`` and once with ``stats``, the
    launch counts set to 0 just before each run: finite falling losses
    and exactly VGG_BNS launches a step of each of the mode's two BN
    kernels and none of any other. Returns {mode: (images/s, launches,
    steps)}."""
    import tempfile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import vgg as vgg_cli

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_cifar(tmp, VGG_RECORDS, seed=3, banded=True)
        for mode, kernels in (("apply", ("bn_fwd_apply", "bn_bwd_fused")),
                              ("stats", ("bn_stats", "bn_bwd_stats"))):
            with LogLines() as lines:
                ops.reset_kernel_launches()
                t0 = time.perf_counter()
                vgg_cli.main(["train", "-f", tmp, "-b", str(VGG_BATCH),
                              "--maxEpoch", "1", "--logEvery", "1",
                              "--fusedBN", mode])
                torch.cuda.synchronize()
                n = ops.kernel_launches()
                secs = time.perf_counter() - t0
            losses, rates = _train_lines(lines, VGG_BATCH)
            top1 = [ln for ln in lines if ln.startswith("top1 accuracy is ")]
            steps = len(losses)
            print(f"[vgg cli --fusedBN {mode}] {5 * VGG_RECORDS} images at "
                  f"batch {VGG_BATCH}, {steps} steps in {secs:.1f}s on "
                  f"{card}: {[round(r, 1) for r in rates]} images/s; "
                  f"losses {[round(v, 4) for v in losses[:3]]} ... "
                  f"{[round(v, 4) for v in losses[-3:]]}; "
                  f"{top1[-1] if top1 else 'no top1 line'}; launches "
                  f"{ {k: v for k, v in n.items() if v} }", flush=True)
            if not _falls(losses):
                fail(f"[vgg cli {mode}] losses not finite and falling: "
                     f"{losses}")
            want = {k: VGG_BNS * steps if k in kernels else 0 for k in n}
            if n != want:
                fail(f"[vgg cli {mode}] launches {n}, expected {want} "
                     f"({VGG_BNS} BNs a step)")
            out[mode] = (rates[-1] if rates else 0.0, n, steps)
    return out


def zoo_perf_runs(torch, card):
    """``cli.perf`` rows ``lenet5`` and ``vgg16`` (bf16, batch ZOO_BATCH,
    2 warm-up and ZOO_ITERS timed steps): finite losses, no BN kernel
    launched (neither model has a BN). Returns {row: result}."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    out = {}
    for name in ZOO_ROWS:
        ops.reset_kernel_launches()
        res = perf.run(name, batch=ZOO_BATCH, iterations=ZOO_ITERS,
                       dtype=torch.bfloat16, warmup=2)
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        print(f"[perf {name}] bf16 batch {ZOO_BATCH} on {card}: "
              f"{res['records_per_second']} images/s over {ZOO_ITERS} timed "
              f"steps ({res['seconds']} s); losses "
              f"{[round(v, 4) for v in res['losses']]}", flush=True)
        if not all(math.isfinite(v) for v in res["losses"]) or any(
                n.values()):
            fail(f"[perf {name}] losses {res['losses']}, launches {n}")
        out[name] = res
        torch.cuda.empty_cache()
    return out


def baseline_runs(torch, card):
    """Phase 17: BASELINE configs 1 and 2 through their CLIs, VGG's BN
    shapes and the perf zoo's rows. Returns (rows, the VGG runs'
    launches, the BN rows)."""
    t0 = time.perf_counter()
    lenet = lenet_run(torch, card)
    vgg = vgg_runs(torch, card)
    bn_rows = check_bn(torch, VGG_BN_SHAPES, BN_TIMING_LIGHT)
    zoo = zoo_perf_runs(torch, card)
    print(f"[phase 17] {time.perf_counter() - t0:.1f}s", flush=True)
    rows = {"lenet5 cli (last epoch)": lenet["images_per_s"][-1]}
    rows.update({f"vgg cli --fusedBN {m}": r for m, (r, _, _) in vgg.items()})
    rows.update({f"perf {k} bf16 batch {ZOO_BATCH}": v["records_per_second"]
                 for k, v in zoo.items()})
    return rows, [n for _, n, _ in vgg.values()], bn_rows


def write_jpeg_folder(root, seed=0, splits=(("train", INC_TRAIN),
                                             ("val", INC_VAL)),
                      classes=INC_CLASSES):
    """``root/train/c<k>/<i>.jpg`` (INC_TRAIN a class) and ``root/val/...``
    (INC_VAL a class), INC_SIDE square: noise up to 99 and, for class k,
    a bright band across rows 20k..20k+19 of channel k % 3 (a class the
    models can learn). Written with PIL. ``splits``: (folder, images a
    class) pairs; ``classes``: the class count."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    for split, per in splits:
        for k in range(classes):
            d = os.path.join(root, split, f"c{k}")
            os.makedirs(d)
            for i in range(per):
                img = rs.randint(0, 100, (INC_SIDE, INC_SIDE, 3))
                img[20 * k:20 * k + 20, :, k % 3] = 240
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(d, f"{i}.jpg"), quality=90)


def _printed_lines(run, argv):
    """(the ``<method> is`` lines ``run(argv)`` prints, its seconds)."""
    import contextlib
    import io

    import torch

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run(argv)
    torch.cuda.synchronize()
    return ([ln for ln in out.getvalue().splitlines() if " is " in ln],
            time.perf_counter() - t0)


def inception_cli_runs(torch, card, folder):
    """``cli.inception train -b 32 --maxEpoch 1`` as ``inception_v1`` and
    as ``inception_v2`` with ``--fusedBN apply`` and ``stats``, the counts
    set to 0 just before each run, then ``cli.inception test --model`` on
    each run's checkpoint: finite losses, exactly INC_BNS launches a step
    of each of the mode's two BN kernels (none for v1), the test's Top-1
    and Top-5 lines the training run's last validation. Returns {tag:
    (images/s, launches)}."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import inception as inception_cli

    out = {}
    for name, mode, kernels in (
            ("inception_v1", None, ()),
            ("inception_v2", "apply", ("bn_fwd_apply", "bn_bwd_fused")),
            ("inception_v2", "stats", ("bn_stats", "bn_bwd_stats"))):
        tag = name + (f" --fusedBN {mode}" if mode else "")
        ck = os.path.join(folder, f"ck_{name}_{mode}")
        argv = ["train", "-f", folder, "-b", str(INC_BATCH), "--maxEpoch",
                "1", "--logEvery", "1", "--modelName", name, "--classNum",
                str(INC_CLASSES), "--learningRate", INC_LR, "--checkpoint",
                ck] + (["--fusedBN", mode] if mode else [])
        with LogLines() as lines:
            ops.reset_kernel_launches()
            t0 = time.perf_counter()
            inception_cli.main(argv)
            torch.cuda.synchronize()
            n = ops.kernel_launches()
            secs = time.perf_counter() - t0
        losses, rates = _train_lines(lines, INC_BATCH)
        val = [ln for ln in lines if ln.startswith(("top1 accuracy is ",
                                                    "top5 accuracy is "))]
        tested, _ = _printed_lines(inception_cli.main, [
            "test", "-f", folder, "--model", ck, "-b", str(INC_BATCH),
            "--modelName", name, "--classNum", str(INC_CLASSES)])
        steps = len(losses)
        print(f"[inception cli {tag}] {INC_CLASSES * INC_TRAIN} images at "
              f"batch {INC_BATCH}, {steps} steps in {secs:.1f}s on {card}: "
              f"{[round(r, 1) for r in rates]} images/s; losses "
              f"{[round(v, 4) for v in losses]}; {val[-2:]}; test: "
              f"{tested}; launches {({k: v for k, v in n.items() if v})}",
              flush=True)
        if steps != INC_CLASSES * INC_TRAIN // INC_BATCH or not all(
                math.isfinite(v) for v in losses):
            fail(f"[inception cli {tag}] losses {losses}")
        want = {k: INC_BNS * steps if k in kernels else 0 for k in n}
        if n != want:
            fail(f"[inception cli {tag}] launches {n}, expected {want} "
                 f"({INC_BNS} BNs a step)")
        if len(val) < 2 or tested != val[-2:]:
            fail(f"[inception cli {tag}] test printed {tested}, the "
                 f"training run's last validation {val[-2:]}")
        out[tag] = (rates[-1] if rates else 0.0, n)
        torch.cuda.empty_cache()
    return out


ALEXNET_CAFFE = [("conv1", (96, 3, 11, 11)), ("conv2", (256, 48, 5, 5)),
                 ("conv3", (384, 256, 3, 3)), ("conv4", (384, 192, 3, 3)),
                 ("conv5", (256, 192, 3, 3)), ("fc6", (4096, 9216)),
                 ("fc7", (4096, 4096)), ("fc8", (1000, 4096))]


def write_alexnet_caffe(folder, seed=0):
    """A seeded AlexNet ``.caffemodel`` of the real blob shapes (weights
    N(0, 2 / fan_in), biases N(0, 0.01)), written as protobuf wire bytes
    (the new layer format, packed floats), and a deploy prototxt. Returns
    (prototxt, caffemodel)."""
    import numpy as np

    def varint(n):
        out = b""
        while True:
            b7, n = n & 0x7F, n >> 7
            if not n:
                return out + bytes([b7])
            out += bytes([b7 | 0x80])

    def field(fno, data):
        return varint((fno << 3) | 2) + varint(len(data)) + data

    def blob(a):
        dims = field(1, b"".join(varint(d) for d in a.shape))
        return field(7, dims) + field(5, a.astype("<f4").tobytes())

    rng = np.random.default_rng(seed)
    weights = os.path.join(folder, "alexnet.caffemodel")
    proto = os.path.join(folder, "deploy.prototxt")
    with open(weights, "wb") as f:
        f.write(field(1, b"AlexNet"))
        for name, shape in ALEXNET_CAFFE:
            w = rng.standard_normal(shape, dtype=np.float32)
            w *= np.float32((2.0 / np.prod(shape[1:])) ** 0.5)
            b = 0.1 * rng.standard_normal(shape[0], dtype=np.float32)
            kind = b"InnerProduct" if name.startswith("fc") else \
                b"Convolution"
            f.write(field(100, field(1, name.encode()) + field(2, kind)
                          + field(7, blob(w)) + field(7, blob(b))))
    with open(proto, "w") as f:
        f.write('name: "AlexNet"\ninput: "data"\n' + "".join(
            f'layer {{ name: "{n}" type: "'
            f'{"InnerProduct" if n.startswith("fc") else "Convolution"}" }}\n'
            for n, _ in ALEXNET_CAFFE))
    return proto, weights


def caffe_start():
    """Phase 18's seeded AlexNet ``.caffemodel`` (``write_alexnet_caffe``,
    ~244 MB), written into a fresh directory on a thread beside phase 17.
    Returns the handle :func:`alexnet_import_runs` takes."""
    import tempfile

    state = {"dir": tempfile.mkdtemp(prefix="caffe_")}

    def write():
        t0 = time.perf_counter()
        try:
            state["paths"] = write_alexnet_caffe(state["dir"])
        except BaseException as e:  # reported by alexnet_import_runs
            state["error"] = repr(e)
        state["s"] = time.perf_counter() - t0

    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th, state


def alexnet_import_runs(torch, card, folder, caffe):
    """AlexNet at 1000 classes through ``cli.loadmodel --modelType caffe``
    on the val folder at 227 x 227, the same weights exported with
    ``save_torch_module`` and run again as ``--modelType torch``: the two
    runs print the same Top-1 and Top-5 lines; on one fixed batch the
    logits of each import on the card match the CPU forward of the caffe
    import within ALEXNET_LOGIT_TOL of max|logit|. ``caffe``:
    :func:`caffe_start`'s handle, the caffemodel. Returns {tag:
    images/s}."""
    import shutil

    import numpy as np

    from bigdl_tpu_torch.cli import loadmodel as loadmodel_cli
    from bigdl_tpu_torch.interop import (load_caffe, load_torch_module,
                                         save_torch_module)
    from bigdl_tpu_torch.models import alexnet

    th, state = caffe
    th.join()
    if "error" in state:
        fail(f"[alexnet import] writing the caffemodel: {state['error']}")
    t0 = time.perf_counter()
    proto, weights = state["paths"]
    t7 = os.path.join(folder, "alexnet.t7")
    model = load_caffe(alexnet(1000, generator=torch.Generator()
                               .manual_seed(0)), weights).eval()
    save_torch_module(model, t7, example_input=(1, 227, 227, 3))
    print(f"[alexnet import] caffemodel {os.path.getsize(weights)} bytes "
          f"written in {state['s']:.1f}s beside phase 17, .t7 "
          f"{os.path.getsize(t7)} bytes exported in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    n_val = INC_CLASSES * INC_VAL // INC_BATCH * INC_BATCH
    val = os.path.join(folder, "val")
    rows, printed = {}, {}
    for kind, argv in (("caffe", ["--modelName", "alexnet", "--model", proto,
                                  "--weights", weights]),
                       ("torch", ["--model", t7, "--imageSize", "227"])):
        printed[kind], secs = _printed_lines(loadmodel_cli.main, [
            "--modelType", kind, "-f", val, "-b", str(INC_BATCH),
            "--classNum", "1000"] + argv)
        rows[f"loadmodel --modelType {kind} alexnet"] = n_val / secs
        print(f"[alexnet loadmodel {kind}] {n_val} images at batch "
              f"{INC_BATCH} in {secs:.2f}s on {card}: {n_val / secs:.1f} "
              f"images/s (load included); {printed[kind]}", flush=True)
    if len(printed["caffe"]) != 2 or printed["caffe"] != printed["torch"]:
        fail(f"[alexnet import] caffe printed {printed['caffe']}, torch "
             f"{printed['torch']}")
    x = torch.from_numpy(np.random.RandomState(18).randn(
        8, 227, 227, 3).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        scale = float(ref.abs().max())
        for kind, m in (("caffe", model.to(DEV)),
                        ("torch", load_torch_module(t7, device=DEV))):
            got = m(x.to(DEV)).cpu()
            err = float((got - ref).abs().max()) / scale
            print(f"[alexnet {kind} import] logits on the card vs the CPU "
                  f"forward: max|d|/max|ref| {err:.2e}", flush=True)
            if not err <= ALEXNET_LOGIT_TOL:
                fail(f"[alexnet {kind} import] logits off by {err:.2e} of "
                     f"max|ref| (tolerance {ALEXNET_LOGIT_TOL})")
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(state["dir"], ignore_errors=True)
    return rows


def inception_bn_shapes(torch):
    """[(b, h, w, C), count] of the inputs Inception-v2's 57 BNs meet in a
    batch-INC_BATCH forward on the card, from forward hooks."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import inception_v2

    model = inception_v2(1000).to(DEV).eval()
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, nn.BatchNormalization)]
    with torch.no_grad():
        model(torch.zeros(INC_BATCH, 224, 224, 3, device=DEV))
    for h in hooks:
        h.remove()
    del model
    if len(seen) != INC_BNS:
        fail(f"[inception_v2] {len(seen)} BNs met in a forward, expected "
             f"{INC_BNS}")
    shapes = sorted(set(seen), key=lambda s: (-s[1], s[3]))
    return [(s, seen.count(s)) for s in shapes]


def inception_perf_runs(torch, card):
    """``cli.perf`` rows ``inception_v1``, ``inception_v2 --fusedBN
    apply`` and ``alexnet`` (bf16, batch ZOO_BATCH, 2 warm-up and
    ZOO_ITERS timed steps): finite losses, exactly INC_BNS launches a step
    of each fused kernel for v2 and none elsewhere. Returns {row: (result,
    launches)}."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    out = {}
    steps = 2 + ZOO_ITERS
    for name, fused in INC_ROWS:
        ops.reset_kernel_launches()
        res = perf.run(name, batch=ZOO_BATCH, iterations=ZOO_ITERS,
                       dtype=torch.bfloat16, warmup=2, fused_bn=fused)
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        print(f"[perf {name}{' --fusedBN ' + fused if fused else ''}] bf16 "
              f"batch {ZOO_BATCH} on {card}: {res['records_per_second']} "
              f"images/s over {ZOO_ITERS} timed steps ({res['seconds']} s); "
              f"losses {[round(v, 4) for v in res['losses']]}; launches "
              f"{({k: v for k, v in n.items() if v})}", flush=True)
        kernels = ("bn_fwd_apply", "bn_bwd_fused") if fused else ()
        want = {k: INC_BNS * steps if k in kernels else 0 for k in n}
        if not all(math.isfinite(v) for v in res["losses"]) or n != want:
            fail(f"[perf {name}] losses {res['losses']}, launches {n}, "
                 f"expected {want}")
        out[name] = (res, n)
        torch.cuda.empty_cache()
    return out


def inception_runs(torch, card, caffe):
    """Phase 18: BASELINE config 4. Inception through ``cli.inception``,
    AlexNet through the Caffe and Torch importers (its caffemodel
    ``caffe``'s, :func:`caffe_start`), the BN kernels at Inception-v2's
    shapes, the perf zoo's inception and alexnet rows. Returns (rows, the
    runs' launches, the BN rows)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_jpeg_folder(tmp, seed=18)
        print(f"[phase 18] {INC_CLASSES * (INC_TRAIN + INC_VAL)} JPEGs "
              f"written in {time.perf_counter() - t0:.1f}s", flush=True)
        cli = inception_cli_runs(torch, card, tmp)
        rows = alexnet_import_runs(torch, card, tmp, caffe)
    shapes = inception_bn_shapes(torch)
    print(f"[inception_v2] batch {INC_BATCH}: {len(shapes)} (rows, C) "
          f"shapes over {INC_BNS} BNs: " + ", ".join(
              f"{b * h * w}x{c}" + (f" ({k})" if k > 1 else "")
              for (b, h, w, c), k in shapes), flush=True)
    bn_rows = check_bn(torch, [s for s, _ in shapes], BN_TIMING_LIGHT)
    zoo = inception_perf_runs(torch, card)
    print(f"[phase 18] {time.perf_counter() - t0:.1f}s", flush=True)
    rows.update({f"inception cli {tag}": r for tag, (r, _) in cli.items()})
    rows.update({f"perf {k}{' --fusedBN ' + f if f else ''} bf16 batch "
                 f"{ZOO_BATCH}": zoo[k][0]["records_per_second"]
                 for k, f in INC_ROWS})
    launches = ([n for _, n in cli.values()]
                + [n for _, n in zoo.values()])
    return rows, launches, bn_rows


# phase 19 (a)'s counts of fresh builds of MFU_ROWS on the meta device,
# counted on the CPU in a process of its own: {row: GF}
MFU_COUNT_CHILD = (
    "import json, sys, torch\n"
    "from bigdl_tpu_torch.cli import perf\n"
    "out = {}\n"
    "for name, batch in json.loads(sys.argv[1]):\n"
    "    with torch.device('meta'):\n"
    "        model, _ = perf.build_model(name)\n"
    "    c = perf.step_flops(model, name, batch, torch.bfloat16)\n"
    "    out[name] = round((c['matmul'] + c['conv']) / 1e9, 3)\n"
    "print(json.dumps(out))\n")


def slice_prep_start():
    """Phase 19's CPU work, started beside phase 18: (a)'s counts
    of fresh builds in a child process (MFU_COUNT_CHILD) and (d)'s
    hard-grade record shards, written on a thread by the harness's own
    writer (``cli.perf._make_class_image_tree``, ``write_image_shards``)
    with the arguments ``run_time_to_acc`` gives them. Returns the handle
    :func:`resnet_slice_runs` takes."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", MFU_COUNT_CHILD,
         json.dumps([[name, batch] for name, _, batch, _ in MFU_ROWS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=here), cwd=here)
    tmp = tempfile.mkdtemp(prefix="tta_hard_")
    state = {}

    def write():
        try:
            from bigdl_tpu_torch.cli import perf
            from bigdl_tpu_torch.dataset import write_image_shards

            t0 = time.perf_counter()
            size = int(TTA_EASY[TTA_EASY.index("--imageSize") + 1])
            for split, per, seed in (("train", TTA_HARD_PER_CLASS[0], 0),
                                     ("val", TTA_HARD_PER_CLASS[1], 1)):
                tree = os.path.join(tmp, "imgs", split)
                perf._make_class_image_tree(tree, 10, per, size, seed=seed,
                                            hard=True)
                write_image_shards(tree, os.path.join(tmp, "shards", split),
                                   prefix=split, images_per_shard=256,
                                   workers=4)
            state["s"] = time.perf_counter() - t0
        except BaseException as e:  # reported by tta_runs
            state["error"] = repr(e)

    th = threading.Thread(target=write, daemon=True)
    th.start()
    return proc, th, tmp, state


def _mfu_counts(prep):
    """Phase 19 (a)'s counts from :func:`slice_prep_start`'s child."""
    out, err = prep[0].communicate(timeout=600)
    if prep[0].returncode != 0:
        fail(f"[mfu] the counting process exited {prep[0].returncode}: "
             f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _launched(torch, run):
    """(``run()``, the kernel launches it made), the counts set to 0 just
    before it."""
    from bigdl_tpu_torch import ops

    ops.reset_kernel_launches()
    out = run()
    torch.cuda.synchronize()
    return out, ops.kernel_launches()


def mfu_runs(torch, card, prep):
    """Phase 19 (a): MFU_ROWS through ``cli.perf.run`` graphed: finite
    losses, exact launches, 0 < mfu <= 1 against a matched peak, the
    analytic count equal to the count of a fresh build of the row at the
    same batch (``prep``'s child, on the CPU), ResNet-50's in the JAX
    test's range per image. Returns {row: (result, launches)}."""
    import math

    from bigdl_tpu_torch.cli import perf

    out, counts = {}, _mfu_counts(prep)
    for name, fused, batch, per_step in MFU_ROWS:
        image = name in perf.IMAGE_CONFIGS
        linted = name in MFU_LINT_ROWS
        if linted:  # phase 30 (b): the lint's pre-flight, then the run
            argv = ["-m", name, "-b", str(batch), "-i", str(MFU_ITERS),
                    "--innerSteps", str(MFU_INNER), "--dataType", "random",
                    "--lint", "strict"] + (["--fusedBN", fused] if fused
                                           else [])
            res, n = _launched(torch, lambda: perf.main(argv))
            if not isinstance(res, dict):
                fail(f"[mfu {name}] --lint strict refused the run: {res}")
        else:
            res, n = _launched(torch, lambda: perf.run(
                name, batch=batch, iterations=MFU_ITERS,
                dtype=torch.bfloat16, warmup=1, fused_bn=fused,
                inner_steps=MFU_INNER, data_type="random"))
        steps = ((2 if linted else 1) + MFU_ITERS) * MFU_INNER
        res["steps"] = steps
        cpu_gf = counts[name]
        rate = (f"{res['records_per_second']} images/s" if image else
                f"{res['tokens_per_second']} tokens/s")
        print(f"[mfu {name}{' --fusedBN ' + fused if fused else ''}] bf16 "
              f"batch {batch}, --innerSteps {MFU_INNER} on {card}: {rate}; "
              f"step_gflops_analytic {res['step_gflops_analytic']} "
              f"{res['step_gflops_by_kind']} (CPU count {cpu_gf}); mfu "
              f"{res['mfu']} ({res['mfu_pct']}% of "
              f"{res['peak_flops_assumed']:.4g} FLOP/s, "
              f"{res['peak_flops_device_match']}); launches "
              f"{ {k: v for k, v in n.items() if v} } over {steps} steps"
              + (f"; lint {res['lint']}" if linted else ""), flush=True)
        if linted and res.get("lint", {}).get("errors") != 0:
            fail(f"[mfu {name}] the line's lint {res.get('lint')}")
        want = {k: per_step.get(k, 0) * steps for k in n}
        if not all(math.isfinite(v) for v in res["losses"]) or n != want:
            fail(f"[mfu {name}] losses {res['losses']}, launches {n}, "
                 f"expected {want}")
        if not 0 < res["mfu"] <= 1 or res["peak_flops_device_match"] \
                .startswith("UNMATCHED"):
            fail(f"[mfu {name}] mfu {res['mfu']} against "
                 f"{res['peak_flops_device_match']}")
        if res["step_gflops_analytic"] != cpu_gf:
            fail(f"[mfu {name}] the card's count "
                 f"{res['step_gflops_analytic']} GF, the CPU's {cpu_gf}")
        per_image = res["step_gflops_analytic"] * 1e9 / batch
        lo, hi = RESNET50_GF_PER_IMAGE
        if name.startswith("resnet50") and not lo < per_image < hi:
            fail(f"[mfu {name}] {per_image / 1e9:.3f} GF an image")
        out[name] = (res, n)
        torch.cuda.empty_cache()
    sync_free_step(torch, card)
    return out


def sync_free_step(torch, card):
    """Phase 30 (b): one eager ``resnet50_fba`` step (cli.perf's, batch
    RESNET_BATCH, bf16) under ``torch.cuda.set_sync_debug_mode("error")``,
    after a warm-up step: the step the lint found no host sync in makes
    none on the card."""
    from bigdl_tpu_torch.cli import perf

    step, model, _, _ = perf.train_step("resnet50_fba", RESNET_BATCH,
                                        dtype=torch.bfloat16,
                                        data_type="random")
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step()
    except RuntimeError as e:
        fail(f"[phase 30 (b)] the resnet50_fba step synchronised with the "
             f"host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[phase 30 (b)] resnet50_fba bf16 batch {RESNET_BATCH}: one "
          f"eager step under set_sync_debug_mode('error') made no host "
          f"sync (loss {float(loss):.4f}) on {card}", flush=True)
    del step, model
    torch.cuda.empty_cache()


def policy_runs(torch, card):
    """Phase 19 (b): ResNet-50 ``_fba`` under each of POLICIES, eager and
    graphed; then ``tools/conv_probe.py --geom`` at ResNet-50's shapes and
    the row under ``--convGeom`` that file. Returns ({tag: images/s},
    launches)."""
    import math
    import tempfile

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.tools import conv_probe

    per_step = POLICY_BNS
    rows, launches, base = {}, [], None
    for spec in POLICIES:
        kw = dict(batch=RESNET_BATCH, dtype=torch.bfloat16,
                  data_type="random", conv_layout=spec)
        eager, n_e = _launched(torch, lambda: perf.run(
            POLICY_ROW, iterations=POLICY_STEPS, warmup=0, **kw))
        graphed, n_g = _launched(torch, lambda: perf.run(
            POLICY_ROW, iterations=2, warmup=1,
            inner_steps=POLICY_STEPS // 2, **kw))
        el, gl = eager["losses"], graphed["losses"]
        base = base or el
        print(f"[policy {spec}] {POLICY_ROW} bf16 batch {RESNET_BATCH} on "
              f"{card}: graphed {graphed['records_per_second']} images/s "
              f"(eager {eager['records_per_second']}); conv_layouts "
              f"{graphed.get('conv_layouts')}; first losses "
              f"{[round(v, 4) for v in el[:3]]}; graphed at steps "
              f"{POLICY_STEPS // 2}, {POLICY_STEPS} "
              f"{[round(v, 4) for v in gl[:2]]} vs eager "
              f"{[round(el[POLICY_STEPS // 2 - 1], 4), round(el[-1], 4)]}",
              flush=True)
        half = POLICY_STEPS // 2
        for n, steps in ((n_e, POLICY_STEPS), (n_g, 3 * half)):
            want = {k: per_step * steps if k in ("bn_fwd_apply",
                                                 "bn_bwd_fused") else 0
                    for k in n}
            if n != want:
                fail(f"[policy {spec}] launches {n}, expected {want}")
        if not all(math.isfinite(v) for v in el + gl) or \
                abs(el[0] - base[0]) > POLICY_LOSS_TOL or \
                abs(gl[0] - el[half - 1]) > POLICY_LOSS_TOL or \
                abs(gl[1] - el[POLICY_STEPS - 1]) > POLICY_LOSS_TOL:
            fail(f"[policy {spec}] eager losses {el}, graphed {gl}, the "
                 f"default's first {base[0]} (tolerance {POLICY_LOSS_TOL})")
        rows[f"--convLayout {spec}"] = graphed["records_per_second"]
        launches += [n_e, n_g]
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        geom = os.path.join(tmp, "geom.json")
        t0 = time.perf_counter()
        conv_probe.main(["--geom", geom])
        with open(geom) as f:
            decisions = json.load(f)["decisions"]
        print(f"[conv probe] {len(decisions)} geometries in "
              f"{time.perf_counter() - t0:.1f}s on {card}: " + "; ".join(
                  f"{d['geom']['kh']}x{d['geom']['kw']}/s"
                  f"{d['geom']['stride'][0]} {d['geom']['cin']}->"
                  f"{d['geom']['cout']} {d['layouts']}" for d in decisions),
              flush=True)
        res, n = _launched(torch, lambda: perf.run(
            POLICY_ROW, batch=RESNET_BATCH, iterations=MFU_ITERS,
            warmup=1, inner_steps=MFU_INNER, dtype=torch.bfloat16,
            data_type="random", conv_geom=geom))
    print(f"[policy --convGeom probe decisions] {POLICY_ROW} bf16 batch "
          f"{RESNET_BATCH}, --innerSteps {MFU_INNER} on {card}: "
          f"{res['records_per_second']} images/s; losses "
          f"{[round(v, 4) for v in res['losses']]}", flush=True)
    steps = (1 + MFU_ITERS) * MFU_INNER
    if not all(math.isfinite(v) for v in res["losses"]) or \
            n["bn_fwd_apply"] != per_step * steps or not res.get(
                "conv_geom"):
        fail(f"[policy --convGeom] losses {res['losses']}, launches {n}, "
             f"conv_geom {res.get('conv_geom')}")
    rows["--convGeom probe decisions"] = res["records_per_second"]
    return rows, launches + [n]


def s2d_runs(torch, card):
    """Phase 19 (c): the s2d stem with ``weight_from_conv7(w7)`` against
    the 7x7/2 pad-3 conv of ``w7`` at batch 128 (bf16, f32); ``cli.resnet
    train --dataset imagenet --depth 50 --s2d --fusedBN apply`` on a
    seeded JPEG folder, then ``test --s2d`` on its checkpoint. Returns
    (images/s, launches)."""
    import math
    import tempfile

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.cli import resnet as resnet_cli
    from bigdl_tpu_torch.models import SpaceToDepthStem
    from bigdl_tpu_torch.ops import conv2d as c2d

    gen = torch.Generator().manual_seed(19)
    conv7 = nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  init="xavier", generator=gen).to(DEV)
    stem = SpaceToDepthStem(64).to(DEV)
    with torch.no_grad():
        stem.weight.copy_(SpaceToDepthStem.weight_from_conv7(conv7.weight))
        x = torch.randn(RESNET_BATCH, 224, 224, 3, generator=gen).to(DEV)
        for dtype in (torch.bfloat16, torch.float32):
            ref = conv7(x.to(dtype)).float()
            err = float((stem(x.to(dtype)).float() - ref).abs().max())
            print(f"[s2d stem] batch {RESNET_BATCH} {dtype} on {card}: "
                  f"max|stem - conv7x7/2| {err:.3g} (max|ref| "
                  f"{float(ref.abs().max()):.3g})", flush=True)
            if dtype == torch.float32 and not err <= S2D_F32_TOL:
                fail(f"[s2d stem] f32 max abs error {err}")
    del conv7, stem, x, ref
    with tempfile.TemporaryDirectory() as tmp:
        write_jpeg_folder(tmp, seed=19)
        ck = os.path.join(tmp, "ck")
        argv = ["--dataset", "imagenet", "-f", tmp, "--depth", "50",
                "--s2d", "--classNum", str(INC_CLASSES), "-b",
                str(S2D_BATCH)]
        train = ["--maxEpoch", "1", "--logEvery", "1", "--fusedBN", "apply",
                 "--learningRate", INC_LR, "--checkpoint", ck]
        with LogLines() as lines:
            _, n = _launched(torch, lambda: resnet_cli.main(
                ["train"] + argv + train))
        losses, rates = _train_lines(lines, S2D_BATCH)
        val = [ln for ln in lines if ln.startswith(("top1 accuracy is ",
                                                    "top5 accuracy is "))]
        tested, _ = _printed_lines(resnet_cli.main,
                                   ["test"] + argv + ["--model", ck])
    c2d.reset_conv_pass_layouts()  # --s2d pinned the all-NHWC default
    steps = INC_CLASSES * INC_TRAIN // S2D_BATCH
    print(f"[s2d cli] ResNet-50 --s2d --fusedBN apply batch {S2D_BATCH}, "
          f"{steps} steps on {card}: {[round(r, 1) for r in rates]} "
          f"images/s; losses {[round(v, 4) for v in losses]}; {val[-2:]}; "
          f"test: {tested}; launches {({k: v for k, v in n.items() if v})}",
          flush=True)
    want = {k: 53 * steps if k in ("bn_fwd_apply", "bn_bwd_fused") else 0
            for k in n}
    if len(losses) != steps or not all(math.isfinite(v) for v in losses) \
            or n != want:
        fail(f"[s2d cli] losses {losses}, launches {n}, expected {want}")
    if len(tested) != 2 or tested != val[-2:]:
        fail(f"[s2d cli] test printed {tested}, the training run's last "
             f"validation {val[-2:]}")
    return (rates[-1] if rates else 0.0), n


def tta_runs(torch, card, prep):
    """Phase 19 (d): ``cli.perf --timeToAcc`` on resnet20_cifar, the easy
    grade (gated: reached, rising wall_s; its data written by the
    harness) and the hard one (printed; its shards ``prep``'s, given as
    ``--data record:DIR``). Returns (results, launches)."""
    import contextlib
    import io
    import shutil

    from bigdl_tpu_torch.cli import perf

    _, th, tmp, state = prep
    th.join()
    if "error" in state:
        fail(f"[tta hard] writing its shards: {state['error']}")
    print(f"[tta hard] {sum(TTA_HARD_PER_CLASS) * 10} images written as "
          f"record shards in {state['s']:.1f}s beside phase 18",
          flush=True)
    hard = TTA_HARD + ["--data", "record:" + os.path.join(tmp, "shards")]
    out, launches = {}, []
    for tag, argv in (("easy", TTA_EASY), ("hard", hard)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, n = _launched(torch, lambda: perf.main(argv))
        curve = [(round(p["wall_s"], 2), round(p["top1"], 4))
                 for p in res["curve"]]
        print(f"[tta {tag}] {' '.join(argv)} on {card}: reached "
              f"{res['reached']} in {res['time_to_acc_s']} s (train "
              f"{res['train_wall_s']} s, setup {res['setup_s']} s, "
              f"{time.perf_counter() - t0:.1f} s in all), final top1 "
              f"{res['final_top1']}, {res['epochs_run']} epochs; curve "
              f"(wall_s, top1) {curve}; launches "
              f"{({k: v for k, v in n.items() if v})}", flush=True)
        walls = [p[0] for p in curve]
        if tag == "easy" and (not res["reached"] or not curve or any(
                b <= a for a, b in zip(walls, walls[1:]))):
            fail(f"[tta easy] reached {res['reached']}, curve {curve}")
        out[tag] = res
        launches.append(n)
    shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


def resnet_slice_runs(torch, card, prep):
    """Phase 19: MFU, the conv layout policy, the s2d stem, time to
    accuracy; ``prep`` is :func:`slice_prep_start`'s handle. Returns
    (rows, launches)."""
    t0 = time.perf_counter()
    mfu = mfu_runs(torch, card, prep)
    policy_rows, launches = policy_runs(torch, card)
    s2d_rate, s2d_n = s2d_runs(torch, card)
    tta, tta_n = tta_runs(torch, card, prep)
    print(f"[phase 19] {time.perf_counter() - t0:.1f}s", flush=True)
    linted = {k: {"launches_a_step": {m: v // r["steps"]
                                      for m, v in n.items() if v},
                  "lint": r["lint"]}
              for k, (r, n) in mfu.items() if k in MFU_LINT_ROWS}
    rows = {f"mfu {k}": r for k, (r, _) in mfu.items()}
    rows.update({f"policy {k}": r for k, r in policy_rows.items()})
    rows["s2d cli"] = s2d_rate
    rows.update({f"tta {k}": r for k, r in tta.items()})
    return (rows, [n for _, n in mfu.values()] + launches + [s2d_n]
            + tta_n, linted)


def _cifar_dp_step(torch, strategy, grad_compress=None):
    """3 steps of ``cli.perf``'s step for ``resnet20_cifar`` f32 with the
    fused BN block at global batch ``DP_CIFAR_BATCH`` on random images;
    returns (losses, {name: parameter as numpy}, launches, ms a step)."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    ops.reset_kernel_launches()
    step, model, _, _ = perf.train_step(
        "resnet20_cifar", DP_CIFAR_BATCH, torch.float32, DEV,
        fused_bn="apply", data_type="random", strategy=strategy)
    losses = [float(step())]  # the first step builds what the rest reuse
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [float(step()) for _ in range(DP_STEPS - 1)]
    ms = (time.perf_counter() - t0) * 1e3 / (DP_STEPS - 1)
    n = ops.kernel_launches()
    params = {k: v.detach().float().cpu().numpy()
              for k, v in model.state_dict().items()}
    return losses, params, n, ms


def _bn_layer_check(torch, dist, model, x):
    """One forward of ``model`` (training mode, no grad) on this rank's
    part ``x`` of a global batch: each BatchNormalization's output, and
    rank 1's input and output broadcast to rank 0, which holds the two
    halves' outputs against ``bn_fwd_apply`` on the whole batch. Returns
    (layers checked, the worst max|d| / max|ref|) on rank 0."""
    from bigdl_tpu_torch.nn.norm import BatchNormalization
    from bigdl_tpu_torch.ops import bn_kernel

    rank = dist.get_rank()
    worst, count = [0.0], [0]

    def hook(mod, inp, out):
        xs, ys = inp[0].detach().contiguous(), out.detach().contiguous()
        x1 = xs.clone() if rank == 1 else torch.empty_like(xs)
        y1 = ys.clone() if rank == 1 else torch.empty_like(ys)
        dist.broadcast(x1, src=1)
        dist.broadcast(y1, src=1)
        if rank != 0:
            return
        xg, yg = torch.cat([xs, x1]), torch.cat([ys, y1])
        c = xg.shape[-1]
        ref, _, _ = bn_kernel.bn_fwd_apply(xg.reshape(-1, c), mod.weight,
                                           mod.bias, mod.eps, mod.fuse_relu)
        ref = ref.float()
        d = float((yg.reshape(-1, c).float() - ref).abs().max())
        worst[0] = max(worst[0], d / max(float(ref.abs().max()), 1e-30))
        count[0] += 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, BatchNormalization)]
    try:
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return count[0], worst[0]


def dp_worker(args):
    """Phase 20 (b) on one rank of a 2-rank gloo job on the one card (the
    ``parallel.launch.spawn`` target): the CIFAR row plain and compressed,
    ResNet-50 ``_fba`` through ``cli.perf.run`` and its synced BN layers
    one at a time, the LM through ``cli.perf.run``. Returns what it
    measured; raises on any failed check (the job then fails)."""
    import math

    import numpy as np
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.parallel import (DataParallel,
                                          make_grad_comm_config, make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world": world}

    losses, params, n, ms = _cifar_dp_step(
        torch, DataParallel(make_mesh({"data": world})))
    np.savez(os.path.join(args["dir"], f"cifar_r{rank}.npz"), **params)
    out["cifar"] = {"losses": losses, "launches": n, "ms": ms}
    strat = DataParallel(make_mesh({"data": world}),
                         grad_comm=make_grad_comm_config("bf16"))
    bf16_losses, _, _, _ = _cifar_dp_step(torch, strat)
    out["cifar_bf16"] = {"losses": bf16_losses,
                         "info": strat.grad_comm_info()}

    runs = {}
    for tag, model_name, batch, dt in (
            ("resnet50", "resnet50_fba", RESNET_BATCH, "random"),
            ("lm", MODEL, TRAIN_BATCH, "constant")):
        (res, n) = _launched(torch, lambda: perf.run(
            model_name, batch=batch, iterations=DP_STEPS - 1, warmup=1,
            dtype=torch.bfloat16, data_type=dt, strategy="dp"))
        res = {k: res[k] for k in ("losses", "records_per_second",
                                   "tokens_per_second", "seconds",
                                   "iterations", "n_devices", "mesh",
                                   "grad_compress", "grad_buckets")}
        res["launches"] = n
        runs[tag] = res
        if not all(math.isfinite(v) for v in res["losses"]):
            raise RuntimeError(f"rank {rank} {tag}: losses {res['losses']}")
        torch.cuda.empty_cache()
    out.update(runs)

    step, model, _, _ = perf.train_step(
        "resnet50_fba", RESNET_BATCH, torch.bfloat16, DEV,
        data_type="random", strategy=DataParallel(make_mesh({"data": world})))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(RESNET_BATCH, 224, 224, 3).astype(
        np.float32)).to(torch.bfloat16)
    per = RESNET_BATCH // world
    out["bn_layers"] = _bn_layer_check(
        torch, dist, model, x[rank * per:(rank + 1) * per].to(DEV))
    del step, model
    torch.cuda.empty_cache()
    return out


def dp_runs(torch, card, lm_ref):
    """Phase 20: data parallelism. ``lm_ref`` is phase 3's single-process
    losses of the LM row (the same batch and steps). Returns (rows of
    rates, the launches of the strategy runs)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.parallel import (DataParallel, init_distributed,
                                          make_mesh)
    from bigdl_tpu_torch.parallel.launch import free_port, spawn

    t_phase = time.perf_counter()
    rows, launches = {}, []

    # (a) one rank over NCCL, through the Optimizer
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    make = lambda: perf.build_model("resnet50_fba",  # noqa: E731
                                    generator=gen())[0]
    data = image_batches(DP_STEPS, RESNET_BATCH, (224, 224, 3), 1000, 7)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, _, _, _ = optimizer_run(torch, make, data, 1, DP_STEPS,
                                     compute_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        got, n, ips, _ = optimizer_run(
            torch, make, data, 1, DP_STEPS, compute_dtype=torch.bfloat16,
            strategy=DataParallel(make_mesh({"data": 1})))
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()
    print(f"[dp (a)] resnet50_fba bf16 batch {RESNET_BATCH}, one NCCL rank "
          f"through Optimizer(strategy=DataParallel) on {card}: losses "
          f"{got}, without a strategy {ref}; {1e3 * RESNET_BATCH / ips:.1f} "
          f"ms a step ({ips:.1f} images/s, the last step; {wall:.1f}s for "
          f"the run with its build); BN launches {n['bn_fwd_apply']} + "
          f"{n['bn_bwd_fused']}", flush=True)
    if got != ref:
        fail(f"[dp (a)] the one-rank strategy's losses {got} differ from "
             f"the plain run's {ref}")
    want = dict({k: 0 for k in n}, bn_fwd_apply=53 * DP_STEPS,
                bn_bwd_fused=53 * DP_STEPS)
    if n != want:
        fail(f"[dp (a)] launches {n}, expected {want}")
    launches.append(n)
    rows["dp (a) resnet50_fba 1 rank"] = ips

    # (b) two gloo ranks on the one card
    torch.cuda.empty_cache()
    single, sparams, _, _ = _cifar_dp_step(torch, None)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dp_phase_") as td:
        t0 = time.perf_counter()
        try:
            res = spawn(DP_WORKER, 2, {"dir": td},
                        timeout_s=DP_TIMEOUT_S, backend="gloo")
        except (RuntimeError, TimeoutError) as e:
            fail(f"[dp (b)] the 2-rank job failed: {e}")
        print(f"[dp (b)] 2 gloo ranks on one card: {time.perf_counter() - t0:.1f}s "
              f"for the job", flush=True)
        rparams = [dict(np.load(os.path.join(td, f"cifar_r{r}.npz")))
                   for r in range(2)]
    for r in range(2):
        c = res[r]["cifar"]
        dl = max(abs(a - b) for a, b in zip(c["losses"], single))
        dp = max(float(np.abs(rparams[r][k] - v).max())
                 for k, v in sparams.items())
        print(f"[dp (b) cifar rank {r}] resnet_cifar(20) f32 --fusedBN apply "
              f"global batch {DP_CIFAR_BATCH} on {card}: losses "
              f"{c['losses']} (one process {single}), max |d loss| {dl:.3g}, "
              f"max |d param| {dp:.3g}; {c['ms']:.1f} ms a step "
              f"({DP_CIFAR_BATCH / c['ms'] * 1e3:.1f} images/s); launches "
              f"{c['launches']}", flush=True)
        if dl > DP_CIFAR_TOL["loss"] or dp > DP_CIFAR_TOL["params"]:
            fail(f"[dp (b) cifar rank {r}] beyond {DP_CIFAR_TOL}")
        n = c["launches"]
        if (n["bn_stats"], n["bn_bwd_stats"], n["bn_fwd_apply"],
                n["bn_bwd_fused"]) != (19 * DP_STEPS, 19 * DP_STEPS, 0, 0):
            fail(f"[dp (b) cifar rank {r}] BN launches {n}")
        b16 = res[r]["cifar_bf16"]
        info = b16["info"]
        rel = abs(b16["losses"][-1] - c["losses"][-1]) / abs(c["losses"][-1])
        print(f"[dp (b) cifar bf16 rank {r}] losses {b16['losses']}, last "
              f"within {rel:.3g} of f32; grad_comm {info}", flush=True)
        if info["wire_bytes"] * 2 != info["wire_bytes_f32"] or rel > 0.05:
            fail(f"[dp (b) cifar bf16 rank {r}] wire {info}, rel {rel}")
        r50, lm = res[r]["resnet50"], res[r]["lm"]
        n = r50["launches"]
        want = dict({k: 0 for k in n}, bn_stats=53 * DP_STEPS,
                    bn_bwd_stats=53 * DP_STEPS)
        print(f"[dp (b) resnet50_fba rank {r}] bf16 global batch "
              f"{RESNET_BATCH} on {card}: {r50['records_per_second']} "
              f"images/s for the job, {1e3 * r50['seconds'] / r50['iterations']:.1f} "
              f"ms a step; losses {r50['losses']}; launches {n}", flush=True)
        if n != want:
            fail(f"[dp (b) resnet50_fba rank {r}] launches {n}, expected "
                 f"{want}")
        n = lm["launches"]
        want = dict({k: 0 for k in n}, flash_fwd=12 * DP_STEPS,
                    flash_dq=12 * DP_STEPS, flash_dkv=12 * DP_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lm["losses"], lm_ref))
        print(f"[dp (b) {MODEL} rank {r}] bf16 global batch {TRAIN_BATCH} x "
              f"1024 on {card}: {lm['tokens_per_second']} tokens/s for the "
              f"job, {1e3 * lm['seconds'] / lm['iterations']:.1f} ms a step; "
              f"losses {lm['losses']} (one process {lm_ref[:DP_STEPS]}, "
              f"max rel {rel:.3g}); launches {n}", flush=True)
        if n != want or rel > DP_LM_TOL:
            fail(f"[dp (b) {MODEL} rank {r}] launches {n} (expected {want}), "
                 f"rel {rel} (bound {DP_LM_TOL})")
        launches += [r50["launches"], lm["launches"], c["launches"]]
    layers, worst = res[0]["bn_layers"]
    print(f"[dp (b) resnet50_fba] {layers} synced BN layers, each against "
          f"bn_fwd_apply on the global batch: worst max|d|/max|ref| "
          f"{worst:.3g} (bound {BN_TOL['bfloat16']})", flush=True)
    if layers != 53 or worst > BN_TOL["bfloat16"]:
        fail(f"[dp (b) resnet50_fba] {layers} layers, worst {worst}")
    rows["dp (b) resnet50_fba 2 ranks"] = res[0]["resnet50"][
        "records_per_second"]
    rows["dp (b) cifar20 2 ranks"] = DP_CIFAR_BATCH / res[0]["cifar"]["ms"] * 1e3

    # (c) NCCL across cards, where there are two
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[dp (c)] not run: torchrun --nproc_per_node N over NCCL needs "
              f"two cards or more, this machine has {cards}", flush=True)
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(cards), "-m",
               "bigdl_tpu_torch.cli.perf", "-m", "resnet50_fba", "--strategy",
               "dp", "-b", str(RESNET_BATCH * cards), "-i", "3",
               "--dataType", "random"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=DP_TIMEOUT_S,
                               cwd=os.path.dirname(os.path.abspath(__file__)))
        except subprocess.TimeoutExpired:
            fail("[dp (c)] torchrun did not finish in time")
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        print(f"[dp (c)] torchrun over {cards} cards: rc {p.returncode}; "
              f"{lines[-1] if lines else p.stderr[-2000:]}", flush=True)
        if p.returncode != 0 or not lines:
            fail("[dp (c)] torchrun failed")
    print(f"[phase 20] {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows, launches


def write_news(folder, seed=0, vocab=5000):
    """The reference's baseDir for text classification, from ``seed``: a
    20news-style tree ``20news-18828/class<NN>/<doc>`` of ``NEWS_DOCS``
    documents in each of ``NEWS_CLASSES`` classes, each of 500-700 words
    drawn as ``write_corpus`` draws them (Zipf over ``vocab`` words), a
    word becoming with probability ``NEWS_TOPIC_P`` one of its class's
    ``NEWS_TOPIC_WORDS`` topic words (a band of ids past ``vocab``); and
    ``glove.6B/glove.6B.100d.txt`` with a 100-d vector for every word,
    N(0, NEWS_GLOVE_SPREAD) each, plus a centre of its class's for a topic
    word (pretrained vectors cluster a topic's words)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    gdir = os.path.join(folder, "glove.6B")
    os.makedirs(gdir)
    centres = rs.randn(NEWS_CLASSES, 100)
    with open(os.path.join(gdir, "glove.6B.100d.txt"), "w") as f:
        for w in range(vocab + NEWS_CLASSES * NEWS_TOPIC_WORDS):
            v = rs.randn(100) * NEWS_GLOVE_SPREAD
            if w >= vocab:
                v += centres[(w - vocab) // NEWS_TOPIC_WORDS]
            f.write(corpus_word(w) + " " + " ".join(f"{a:.4f}" for a in v)
                    + "\n")
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    root = os.path.join(folder, "20news-18828")
    for c in range(NEWS_CLASSES):
        cdir = os.path.join(root, f"class{c:02d}")
        os.makedirs(cdir)
        for i in range(NEWS_DOCS):
            n = rs.randint(NEWS_WORDS[0], NEWS_WORDS[1] + 1)
            words = rs.choice(vocab, n, p=p)
            topic = rs.rand(n) < NEWS_TOPIC_P
            words[topic] = (vocab + c * NEWS_TOPIC_WORDS
                            + rs.randint(0, NEWS_TOPIC_WORDS, topic.sum()))
            with open(os.path.join(cdir, f"{i:04d}"), "w") as f:
                f.write(" ".join(corpus_word(w) for w in words))


def text_cli_run(torch, card, folder):
    """Phase 21 (a): ``cli.textclassification`` at its defaults on the
    seeded baseDir: finite falling losses, a last Top-1 >= ``TEXT_TOP1``
    against 20 classes, records/s of each epoch."""
    from bigdl_tpu_torch.cli import textclassification as tc

    t0 = time.perf_counter()
    with LogLines() as lines:
        tc.main(["-f", folder, "-b", str(TEXT_BATCH), "--maxEpoch",
                 str(TEXT_EPOCHS), "--logEvery", "1"])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses, rates = _train_lines(lines, TEXT_BATCH)
    top1 = [ln for ln in lines if ln.startswith("top1 accuracy is ")]
    acc = (float(re.search(r"AccuracyResult\(([\d.]+)", top1[-1]).group(1))
           if top1 else 0.0)
    print(f"[textclassification cli] {NEWS_CLASSES} x {NEWS_DOCS} docs, "
          f"--sequenceLength 500 --maxWordsNum 5000 --embeddingDim 100, "
          f"{TEXT_EPOCHS} epochs at batch {TEXT_BATCH} in {secs:.1f}s on "
          f"{card}: {[round(r, 1) for r in rates]} records/s per epoch; "
          f"losses {[round(v, 4) for v in losses[:3]]} ... "
          f"{[round(v, 4) for v in losses[-3:]]}; "
          f"{top1[-1] if top1 else 'no top1 line'}", flush=True)
    if not _falls(losses):
        fail(f"[textclassification cli] losses not finite and falling: "
             f"{losses}")
    if acc < TEXT_TOP1:
        fail(f"[textclassification cli] last top-1 {acc}, expected >= "
             f"{TEXT_TOP1} against {NEWS_CLASSES} classes")
    return rates


def rnn_cli_run(torch, card, folder):
    """Phase 21 (b): ``cli.rnn train`` at its defaults (--vocabSize 4000
    --seqLength 20 --hiddenSize 40) for one epoch at batch 128 on a
    seeded Zipf ``input.txt``: finite falling losses and a finite
    ``perplexity is`` line."""
    import contextlib
    import io
    import math

    from bigdl_tpu_torch.cli import rnn as rnn_cli

    write_corpus(os.path.join(folder, "input.txt"), RNN_LM_WORDS)
    out = io.StringIO()
    t0 = time.perf_counter()
    with LogLines() as lines, contextlib.redirect_stdout(out):
        rnn_cli.main(["train", "-f", folder, "-b", "128", "--maxEpoch",
                      "1"])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses, rates = _train_lines(lines, 128)
    ppl = re.findall(r"^perplexity is (\S+)$", out.getvalue(), re.M)
    print(f"[rnn cli] {RNN_LM_WORDS} words, 1 epoch at batch 128 in "
          f"{secs:.1f}s on {card}: {[round(r, 1) for r in rates]} "
          f"records/s; losses {[round(v, 4) for v in losses[:3]]} ... "
          f"{[round(v, 4) for v in losses[-3:]]}; perplexity "
          f"{ppl[-1] if ppl else None}", flush=True)
    if not _falls(losses):
        fail(f"[rnn cli] losses not finite and falling: {losses}")
    if not ppl or not math.isfinite(float(ppl[-1])):
        fail(f"[rnn cli] no finite 'perplexity is' line: {ppl}")
    return rates


def step_kernels(torch, model, x, y):
    """The CUDA kernels of one eager training step (forward, NLL,
    autograd, the port's SGD update), counted by ``torch.profiler``
    after one warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD

    params = dict(model.named_parameters())
    method = SGD(0.01, momentum=0.9)
    state = method.init(params)
    crit = ClassNLLCriterion()

    def step():
        loss = crit(model(x), y)
        gs = torch.autograd.grad(loss, list(params.values()))
        method.update(dict(zip(params, gs)), state, params)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def rnn_model_runs(torch, card, x, y, vocab):
    """Phase 21 (c): ``birnn_classifier`` and ``lstm_classifier`` (embed
    ``RNN_EMBED``, ``RNN_HIDDEN`` a direction, 20 classes) through the
    Optimizer on (a)'s ids, f32: the BiRNN eager and as CUDA graphs of
    ``RNN_K`` steps (losses within ``RNN_LOSS_TOL``), the LSTM graphed.
    Returns (rows, the BiRNN's builder, the first batch's ids on the
    card)."""
    import math

    from bigdl_tpu_torch import models

    b = TEXT_BATCH
    data = [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b])
            for i in range(len(x) // b)]

    def make(build):
        return lambda: build(vocab, RNN_EMBED, RNN_HIDDEN, NEWS_CLASSES,
                             generator=torch.Generator().manual_seed(0))

    make_bi = make(models.birnn_classifier)
    rows, stats = {}, {}
    eager, _, ips_e, _ = optimizer_run(torch, make_bi, data, 1,
                                       RNN_EAGER_STEPS)
    graphed, _, ips_g, _ = optimizer_run(torch, make_bi, data, RNN_K,
                                         RNN_GRAPH_STEPS, graph_stats=stats)
    model = make_bi().to(DEV)
    xb = torch.from_numpy(data[0][0]).to(DEV)
    yb = torch.from_numpy(data[0][1]).to(DEV)
    kernels = step_kernels(torch, model, xb, yb)
    del model
    diffs = [abs(graphed[i] - eager[i]) for i in (1, 3, 5)]
    print(f"[birnn] birnn_classifier({vocab}, {RNN_EMBED}, {RNN_HIDDEN}, "
          f"{NEWS_CLASSES}) f32 T={x.shape[1]} batch {b} on {card}: eager "
          f"{1e3 * b / ips_e:.1f} ms a step ({ips_e:.1f} records/s), graphed "
          f"K={RNN_K} {1e3 * b / ips_g:.1f} ms a step ({ips_g:.1f} "
          f"records/s); graph capture {stats.get('capture_s')} s, "
          f"instantiate {stats.get('instantiate_s')} s; {kernels} CUDA "
          f"kernels in one eager step (torch.profiler); losses eager "
          f"{[round(v, 5) for v in eager]}, graphed "
          f"{[round(v, 5) for v in graphed]}; |graphed - eager| at steps "
          f"2, 4, 6: {diffs}", flush=True)
    if DEV == "cuda" and stats.get("capture_s") is None:
        fail("[birnn] the Optimizer captured no step graph")
    if not all(math.isfinite(v) for v in eager + graphed) or \
            len(eager) != RNN_EAGER_STEPS or len(graphed) != RNN_GRAPH_STEPS:
        fail(f"[birnn] losses not all finite or missing: {eager} {graphed}")
    if max(diffs) > RNN_LOSS_TOL:
        fail(f"[birnn] graphed losses differ from eager by {max(diffs)} "
             f"(> {RNN_LOSS_TOL})")
    if not graphed[-1] < graphed[0]:
        fail(f"[birnn] the graphed run's last loss {graphed[-1]} is not "
             f"below its first {graphed[0]}")
    lstm, _, ips_l, _ = optimizer_run(torch, make(models.lstm_classifier),
                                      data, RNN_K, RNN_GRAPH_STEPS,
                                      graph_stats=stats)
    print(f"[lstm] lstm_classifier({vocab}, {RNN_EMBED}, {RNN_HIDDEN}, "
          f"{NEWS_CLASSES}) f32 graphed K={RNN_K} on {card}: "
          f"{1e3 * b / ips_l:.1f} ms a step ({ips_l:.1f} records/s), "
          f"capture {stats.get('capture_s')} s, instantiate "
          f"{stats.get('instantiate_s')} s; losses "
          f"{[round(v, 5) for v in lstm]}", flush=True)
    if not all(math.isfinite(v) for v in lstm):
        fail(f"[lstm] losses not finite: {lstm}")
    rows.update({"birnn eager ms": 1e3 * b / ips_e,
                 "birnn graphed ms": 1e3 * b / ips_g,
                 "lstm graphed ms": 1e3 * b / ips_l,
                 "birnn kernels a step": kernels})
    return rows, make_bi, xb


def _ms(torch, fn, reps):
    """Host ms a call of ``fn`` over ``reps`` calls after one, synchronized
    (the eager recurrence is launch-bound: its host time is its time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def cudnn_yardstick(torch, card, make_bi, ids):
    """Phase 21 (d): the port's ``BiRecurrent`` against cuDNN's LSTM
    (``torch.nn.LSTM``, never called by the port) on one batch of (a)'s
    embedded ids, f32: the final states (forward at T-1, backward at 0)
    within ``RNN_TOL`` of max|ref|, and forward + backward ms of the port
    eager, the port as a CUDA graph, and cuDNN."""
    model = make_bi().to(DEV)
    bi = model[1]
    with torch.no_grad():
        emb = model[0](ids)
    fwd, bwd = bi.fwd.cell, bi.bwd.cell
    h = RNN_HIDDEN
    lstm = torch.nn.LSTM(RNN_EMBED, h, batch_first=True,
                         bidirectional=True).to(DEV)
    with torch.no_grad():
        for cell, sfx in ((fwd, ""), (bwd, "_reverse")):
            bias = cell.bias.detach().clone()
            bias[h:2 * h] += cell.forget_bias
            getattr(lstm, "weight_ih_l0" + sfx).copy_(cell.w_ih.t())
            getattr(lstm, "weight_hh_l0" + sfx).copy_(cell.w_hh.t())
            getattr(lstm, "bias_ih_l0" + sfx).copy_(bias)
            getattr(lstm, "bias_hh_l0" + sfx).zero_()
        got = bi(emb)
        _, (h_n, _) = lstm(emb)
        ref = torch.cat([h_n[0], h_n[1]], -1)
    err = float((got - ref).abs().max() / ref.abs().max())
    params = [emb] + list(bi.parameters())
    emb.requires_grad_(True)
    gy = torch.randn(got.shape, device=DEV,
                     generator=torch.Generator(DEV).manual_seed(0))
    lparams = [emb] + list(lstm.parameters())

    def port_step():
        return torch.autograd.grad(bi(emb), params, gy)

    def cudnn_step():
        _, (hn, _) = lstm(emb)
        return torch.autograd.grad(torch.cat([hn[0], hn[1]], -1), lparams,
                                   gy)

    eager_ms = _ms(torch, port_step, 3)
    cudnn_ms = _ms(torch, cudnn_step, 10)
    graph_ms = float("nan")
    if DEV == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            port_step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            port_step()
        graph_ms = _ms(torch, graph.replay, 10)
        del graph
    print(f"[birnn vs cuDNN] BiRecurrent(LSTMCell({RNN_EMBED}, {h}) x 2) "
          f"f32 batch {emb.shape[0]} T={emb.shape[1]} on {card}: final "
          f"states max|d|/max|ref| {err:.3e} (RNN_TOL {RNN_TOL}); forward "
          f"+ backward: port eager {eager_ms:.1f} ms, port as a CUDA graph "
          f"{graph_ms:.1f} ms, cuDNN LSTM {cudnn_ms:.2f} ms", flush=True)
    if not err <= RNN_TOL:
        fail(f"[birnn vs cuDNN] final states differ by {err:.3e} of "
             f"max|ref| (> {RNN_TOL})")
    del model, lstm
    return {"birnn fwd+bwd eager ms": eager_ms,
            "birnn fwd+bwd graph ms": graph_ms,
            "cudnn lstm fwd+bwd ms": cudnn_ms}


def gradcheck_runs(torch, card):
    """Phase 21 (e): ``utils.gradcheck.check_gradients`` on the card at
    the JAX defaults: ``birnn_classifier(50, 8, 16, 2)`` at T=12 (full
    BPTT) passes. ``simple_rnn(20, 16, 20)`` cuts BPTT every 2 steps, so
    its gradient is not the loss's (the full check must fail, as it does
    in the JAX package): it is held against central differences of the
    loss with the hidden state entering the last cut (step 10) held at
    its value."""
    import numpy as np

    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.core import flatten_params
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.utils import check_gradients, numerical_grad

    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    crit = ClassNLLCriterion()
    g = torch.Generator().manual_seed(0)
    bi = models.birnn_classifier(50, 8, 16, 2, generator=g).to(DEV)
    ids = torch.from_numpy(rs.randint(0, 50, (4, 12)).astype(np.int32)).to(
        DEV)
    yb = torch.from_numpy(rs.randint(0, 2, 4)).to(DEV)
    check_gradients(lambda p: crit(torch.func.functional_call(
        bi, p, (ids,)), yb), {k: v.detach()
                              for k, v in bi.named_parameters()})
    m = models.simple_rnn(20, 16, 20, generator=g).to(DEV)
    x = torch.from_numpy(rs.randn(4, 12, 20).astype(np.float32)).to(DEV)
    ym = torch.from_numpy(rs.randint(0, 20, 4)).to(DEV)
    params = {k: v.detach() for k, v in m.named_parameters()}

    def loss(p):
        return crit(torch.func.functional_call(m, p, (x,)), ym)

    try:
        check_gradients(loss, params)
        fail("[gradcheck] simple_rnn's truncated gradient passed the full "
             "check: the cut did not cut")
    except AssertionError:
        pass
    cell = m[0].cell
    with torch.no_grad():
        h = cell.initial_hidden(4, device=DEV)
        for t in range(10):
            _, h = cell((x[:, t], h))

    def held(p):
        cp = {k[len("0.cell."):]: v for k, v in p.items()
              if k.startswith("0.cell.")}
        hh = h
        for t in (10, 11):
            yt, hh = torch.func.functional_call(cell, cp, ((x[:, t], hh),))
        out = torch.func.functional_call(
            m[1], {"weight": p["1.weight"], "bias": p["1.bias"]}, (yt,))
        return crit(m[2](out), ym)

    flat, unflatten = flatten_params(params)
    v = flat.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(loss(unflatten(v)), v)
    idx, num = numerical_grad(lambda f: held(unflatten(f)), flat, 1e-3)
    np.testing.assert_allclose(auto.cpu().numpy()[idx], num, rtol=2e-2,
                               atol=5e-3)
    print(f"[gradcheck] on {card}: birnn_classifier(50, 8, 16, 2) T=12 "
          f"passes check_gradients; simple_rnn(20, 16, 20) (bptt_truncate "
          f"2) fails the full check, as in JAX, and its gradient is the "
          f"held objective's within the same tolerances; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def autoencoder_runs(torch, card, folder):
    """Phase 21 (f): ``cli.autoencoder train --adagrad`` for an epoch on
    phase 17's seeded MNIST files (finite falling losses, records/s),
    then ``LBFGS(max_iter=LBFGS_ITERS, line_search=True)`` on the
    autoencoder's MSE over a fixed ``LBFGS_BATCH``-image batch: every
    accepted iterate lowers the loss, which stays finite."""
    import math

    import numpy as np

    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.cli import autoencoder as ae_cli
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import LBFGS

    write_mnist(folder, MNIST_TRAIN, MNIST_TEST)
    t0 = time.perf_counter()
    with LogLines() as lines:
        ae_cli.main(["train", "-f", folder, "-b", "128", "--maxEpoch", "1",
                     "--adagrad", "--learningRate", "0.01"])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses, rates = _train_lines(lines, 128)
    print(f"[autoencoder cli] {MNIST_TRAIN} images, 1 epoch at batch 128, "
          f"Adagrad(0.01), in {secs:.1f}s on {card}: "
          f"{[round(r, 1) for r in rates]} records/s; losses "
          f"{[round(v, 5) for v in losses[:3]]} ... "
          f"{[round(v, 5) for v in losses[-3:]]}", flush=True)
    if not _falls(losses):
        fail(f"[autoencoder cli] losses not finite and falling: {losses}")

    x, _ = load_mnist(folder, train=True)
    xb = torch.from_numpy(x[:LBFGS_BATCH].astype(np.float32) / 255.0).to(DEV)
    target = xb.reshape(len(xb), -1)
    model = models.autoencoder(
        32, generator=torch.Generator().manual_seed(0)).to(DEV)
    crit = MSECriterion()
    evals = [0]

    def feval(p):
        evals[0] += 1
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = crit(torch.func.functional_call(model, p, (xb,)), target)
        gs = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, gs))

    params = {k: v.detach() for k, v in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = LBFGS(max_iter=LBFGS_ITERS, line_search=True).optimize(
        feval, params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    iters = len(hist) - 1
    print(f"[lbfgs] autoencoder(32) MSE over {LBFGS_BATCH} images on "
          f"{card}: {iters} iterations, {evals[0]} evaluations, "
          f"{1e3 * secs / max(iters, 1):.2f} ms an iteration; losses "
          f"{[round(v, 5) for v in hist]}", flush=True)
    if iters < 1 or not all(math.isfinite(v) for v in hist) or not all(
            b < a for a, b in zip(hist, hist[1:])):
        fail(f"[lbfgs] an accepted iterate did not lower the loss, or it "
             f"is not finite: {hist}")
    return {"autoencoder cli records/s": rates[-1] if rates else None,
            "lbfgs ms an iteration": 1e3 * secs / max(iters, 1)}


def rnn_runs(torch, card):
    """Phase 21: BASELINE config 5, the recurrent path, (a) to (f). None
    of the port's seven kernels is on this path: their launch counts
    must not move. Returns its rows."""
    import tempfile

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import textclassification as tc

    t_phase = time.perf_counter()
    ops.reset_kernel_launches()  # main sums the phases' returned counts
    rows = {}
    with tempfile.TemporaryDirectory(prefix="rnn_phase_") as td:
        news = os.path.join(td, "news")
        write_news(news)
        rows["textclassification cli records/s"] = text_cli_run(
            torch, card, news)[-1]
        lm = os.path.join(td, "lm")
        os.makedirs(lm)
        rows["rnn cli records/s"] = rnn_cli_run(torch, card, lm)[-1]
        x, y, n_train, d, _ = tc.split_corpus(news, 500, 5000, 42, 0.8)
        model_rows, make_bi, ids = rnn_model_runs(
            torch, card, x[:n_train], y[:n_train], len(d))
        rows.update(model_rows)
        rows.update(cudnn_yardstick(torch, card, make_bi, ids))
        gradcheck_runs(torch, card)
        mnist = os.path.join(td, "mnist")
        os.makedirs(mnist)
        rows.update(autoencoder_runs(torch, card, mnist))
    if any(ops.kernel_launches().values()):
        fail(f"[phase 21] the recurrent path launched the port's kernels: "
             f"{ops.kernel_launches()}")
    print(f"[phase 21] {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def long_row_runs(torch, card):
    """Phase 22 (a): each long-context row through ``cli.perf.run`` at
    batch 1 in bf16, graphed (``LONG_INNER`` steps a replay) and eager
    over the same steps: the graphed losses against the eager ones,
    exact launches (the flash forward runs again in each layer's
    backward under either remat), tokens/s, MFU and the peak memory of
    each run. Returns ({tag: value}, [launches])."""
    import math

    from bigdl_tpu_torch.cli import perf

    rows, counts = {}, []
    for row, remat in LONG_ROWS.items():
        steps = (1 + LONG_ITERS) * LONG_INNER
        want = {"flash_fwd": 24 * steps, "flash_dq": 12 * steps,
                "flash_dkv": 12 * steps}
        runs = {}
        for mode in ("graphed", "eager"):
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            kw = (dict(iterations=LONG_ITERS, inner_steps=LONG_INNER)
                  if mode == "graphed" else dict(iterations=steps - 1))
            res, launched = _launched(torch, lambda: perf.run(
                row, batch=1, dtype=torch.bfloat16, warmup=1, **kw))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            n = {k: v for k, v in launched.items() if v}
            print(f"[phase 22 {row} {mode}] bf16 batch 1 on {card}: "
                  f"{res['tokens_per_second']} tokens/s, mfu {res['mfu']} "
                  f"({res['mfu_pct']}% of {res['peak_flops_assumed']:.4g}"
                  f", {res['peak_flops_device_match']}), step GFLOPs "
                  f"{res['step_gflops_analytic']}, remat {res['remat']}, "
                  f"peak memory {peak:.2f} GiB; losses "
                  f"{[round(x, 5) for x in res['losses']]}; launches {n} "
                  f"over {steps} steps", flush=True)
            if (not all(math.isfinite(x) for x in res["losses"])
                    or n != want or res["remat"] != remat
                    or not 0 < res["mfu"] <= 1):
                fail(f"[phase 22 {row} {mode}] losses {res['losses']}, "
                     f"launches {n} (expected {want}), remat "
                     f"{res['remat']}, mfu {res['mfu']}")
            runs[mode] = res
            counts.append(launched)
            rows[f"{row} {mode} tokens/s"] = res["tokens_per_second"]
            rows[f"{row} {mode} mfu"] = res["mfu"]
            rows[f"{row} {mode} peak GiB"] = round(peak, 2)
        graphed = runs["graphed"]["losses"]
        eager = runs["eager"]["losses"][LONG_INNER - 1::LONG_INNER]
        gap = diff(graphed, eager)
        print(f"[phase 22 {row}] graphed losses {graphed} against the "
              f"eager ones at the same steps {eager}: max |d| {gap}",
              flush=True)
        if gap > LONG_LOSS_TOL:
            fail(f"[phase 22 {row}] graphed and eager losses differ by "
                 f"{gap} > {LONG_LOSS_TOL}")
        rows[f"{row} graphed vs eager max|dloss|"] = gap
    return rows, counts


def remat_grads_check(torch, row="transformer_lm_16k"):
    """Phase 22 (a): one step's loss and gradients of the 16k row at full
    width and ``LONG_GRAD_LAYERS`` layers with remat "dots" and "full"
    against remat off (bf16, the same weights and tokens): the recomputed
    flash forward must give what the first one gave, each remat with
    its own exact launches. This hand-driven copy is not a main path: its
    launches stay out of the kernels line."""
    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion

    seq = perf.LM_CONFIGS[row]["max_len"]
    toks = torch.from_numpy(np.random.RandomState(22).randint(
        0, perf.LM_VOCAB, (1, seq + 1)).astype(np.int64)).to(DEV)
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    out, counts = {}, []
    for remat in (False, "dots", "full"):
        _free(torch)
        model, _ = perf.build_model(row, num_layers=LONG_GRAD_LAYERS,
                                    remat=remat)
        model.compute_dtype = torch.bfloat16
        model = model.to(DEV).train()
        ops.reset_kernel_launches()
        loss = crit(model(toks[:, :-1]).float(), toks[:, 1:])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        counts.append(ops.kernel_launches())
        out[remat] = (float(loss.detach()), [g.float() for g in grads])
        del model, loss, grads
    base_loss, base = out[False]
    scale = max(float(g.abs().max()) for g in base)
    for remat in ("dots", "full"):
        loss, grads = out[remat]
        gap = max(float((a - b).abs().max()) for a, b in zip(base, grads))
        same = all(bool(torch.equal(a, b)) for a, b in zip(base, grads))
        print(f"[phase 22 remat] {row} at {LONG_GRAD_LAYERS} layers, bf16: "
              f"remat {remat} loss {loss} against remat off {base_loss}; "
              f"max|dg|/max|g| {gap / scale:.3e} (bit for bit: {same}); "
              f"launches {counts[1 if remat == 'dots' else 2]}", flush=True)
        if loss != base_loss or gap > LONG_GRAD_TOL * scale:
            fail(f"[phase 22 remat] remat {remat} moved the loss ({loss} "
                 f"vs {base_loss}) or the gradients ({gap / scale:.3e})")
    per = {False: 1, "dots": 2, "full": 2}
    for remat, n in zip((False, "dots", "full"), counts):
        want = {"flash_fwd": per[remat] * LONG_GRAD_LAYERS,
                "flash_dq": LONG_GRAD_LAYERS, "flash_dkv": LONG_GRAD_LAYERS}
        if {k: v for k, v in n.items() if v} != want:
            fail(f"[phase 22 remat] remat {remat}: launches {n}, expected "
                 f"{want}")


def vit_row_runs(torch, card):
    """Phase 22 (b): ``vit_b16`` and ``vit_s16`` through ``cli.perf.run``
    at batch ``VIT_BATCH`` in bf16, ``VIT_INNER`` graphed steps a replay:
    images/s, MFU, finite losses, 12 launches of each flash kernel a
    step. Returns ({tag: value}, [launches])."""
    import math

    from bigdl_tpu_torch.cli import perf

    rows, counts = {}, []
    for row in VIT_ROWS:
        _free(torch)
        res, launched = _launched(torch, lambda: perf.run(
            row, batch=VIT_BATCH, iterations=VIT_ITERS, dtype=torch.bfloat16,
            warmup=1, inner_steps=VIT_INNER, data_type="random"))
        steps = (1 + VIT_ITERS) * VIT_INNER
        n = {k: v for k, v in launched.items() if v}
        want = {"flash_fwd": 12 * steps, "flash_dq": 12 * steps,
                "flash_dkv": 12 * steps}
        print(f"[phase 22 {row}] bf16 batch {VIT_BATCH}, --innerSteps "
              f"{VIT_INNER} on {card}: {res['records_per_second']} images/s,"
              f" mfu {res['mfu']} ({res['mfu_pct']}% of "
              f"{res['peak_flops_assumed']:.4g}), step GFLOPs "
              f"{res['step_gflops_analytic']} {res['step_gflops_by_kind']}; "
              f"losses {[round(x, 4) for x in res['losses']]}; launches {n} "
              f"over {steps} steps", flush=True)
        if (not all(math.isfinite(x) for x in res["losses"]) or n != want
                or not 0 < res["mfu"] <= 1):
            fail(f"[phase 22 {row}] losses {res['losses']}, launches {n} "
                 f"(expected {want}), mfu {res['mfu']}")
        counts.append(launched)
        rows[f"{row} images/s"] = res["records_per_second"]
        rows[f"{row} mfu"] = res["mfu"]
    return rows, counts


def keypad_run(torch, card):
    """Phase 22 (c): a (b, s_k) key-padding mask through
    ``flash_attention`` at ``KP_SHAPE`` bf16 takes ``blockwise_attention``
    (no kernel launch), against the dense path run a chunk of query rows
    at a time; the peak memory over what was allocated before, and the
    host-clock ms, of the blockwise and the dense forward, and of the
    blockwise forward with its backward. Returns {tag: value}."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.nn import attention as dense
    from bigdl_tpu_torch.ops import attention_kernel as ak

    b, h, s, d = KP_SHAPE
    g = torch.Generator(device=DEV).manual_seed(22)
    q, k, v = (torch.randn(b, h, s, d, device=DEV, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    keep = torch.rand(b, s, device=DEV, generator=g) > 0.25
    keep[:, 0] = True
    calls = []
    real = ak.blockwise_attention

    def spy(*a, **kw):
        calls.append(kw.get("block_k"))
        return real(*a, **kw)

    def measured(fn):
        _free(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return out, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    ak.blockwise_attention = spy
    try:
        ops.reset_kernel_launches()
        with torch.no_grad():
            out, blk_ms, blk_gib = measured(
                lambda: ak.flash_attention(q, k, v, mask=keep))
        n = {k_: v_ for k_, v_ in ops.kernel_launches().items() if v_}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        _, bwd_ms, bwd_gib = measured(lambda: torch.autograd.grad(
            ak.flash_attention(qg, kg, vg, mask=keep), (qg, kg, vg),
            torch.ones_like(q)))
    finally:
        ak.blockwise_attention = real
    worst = scale = 0.0
    with torch.no_grad():
        for i in range(0, s, KP_CHUNK):
            ref = dense.dot_product_attention(
                q[..., i:i + KP_CHUNK, :], k, v, mask=keep[:, None, None, :])
            worst = max(worst, float((out[..., i:i + KP_CHUNK, :].float()
                                      - ref.float()).abs().max()))
            scale = max(scale, float(ref.float().abs().max()))
        del ref
        _, dense_ms, dense_gib = measured(lambda: dense.dot_product_attention(
            q, k, v, mask=keep[:, None, None, :]))
    err = worst / scale
    print(f"[phase 22 key padding] flash_attention(mask=(b, s_k)) at "
          f"{list(KP_SHAPE)} bf16 on {card}: blockwise (block_k "
          f"{calls[:1]}) max|d|/max|ref| {err:.3e} against the dense path "
          f"in chunks of {KP_CHUNK} rows; kernel launches {n}; forward peak "
          f"{blk_gib:.3f} GiB ({blk_ms:.1f} ms) against dense "
          f"{dense_gib:.3f} GiB ({dense_ms:.1f} ms); blockwise forward + "
          f"backward peak {bwd_gib:.3f} GiB ({bwd_ms:.1f} ms)", flush=True)
    if calls != [512, 512] or n or err > KP_TOL or not \
            blk_gib < dense_gib:
        fail(f"[phase 22 key padding] blockwise calls {calls}, launches {n}"
             f", error {err}, peak {blk_gib} vs dense {dense_gib} GiB")
    return {"key padding blockwise fwd GiB": round(blk_gib, 3),
            "key padding dense fwd GiB": round(dense_gib, 3),
            "key padding blockwise fwd+bwd GiB": round(bwd_gib, 3)}


def moe_run(torch, card):
    """Phase 22 (d): ``Sequential(MoE, Linear, LogSoftMax)`` (d
    ``MOE_D``, ``MOE_EXPERTS`` experts of Linear(d, 4d), ReLU, Linear(4d,
    d), top-2, capacity 2.0) through the ``Optimizer`` in bf16 with the
    auxiliary loss (weight 0.01) on 8 x 1024 tokens a step, eager and as
    CUDA graphs of ``MOE_K`` steps: every step's criterion loss graphed
    against eager, the logged loss above it by 0.01 x the auxiliary loss
    (1 to E), step ms. Returns {tag: value}."""
    import numpy as np

    from bigdl_tpu_torch import nn

    def make():
        g = torch.Generator().manual_seed(22)

        def expert():
            return nn.Sequential(nn.Linear(MOE_D, 4 * MOE_D, generator=g),
                                 nn.ReLU(),
                                 nn.Linear(4 * MOE_D, MOE_D, generator=g))

        return nn.Sequential(
            nn.MoE(expert, MOE_EXPERTS, MOE_D, top_k=MOE_TOPK,
                   capacity_factor=MOE_CAP, generator=g),
            nn.Linear(MOE_D, MOE_CLASSES, generator=g), nn.LogSoftMax())

    rng = np.random.default_rng(22)
    data = [(rng.standard_normal((MOE_BATCH, MOE_SEQ, MOE_D),
                                 dtype=np.float32),
             rng.integers(0, MOE_CLASSES, (MOE_BATCH, MOE_SEQ))
             .astype(np.int32)) for _ in range(MOE_BATCHES)]
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    runs = {}
    for k in (1, MOE_K):
        _free(torch)
        runs[k] = optimizer_run(torch, make, data, k, MOE_STEPS,
                                compute_dtype=torch.bfloat16, crit=crit)
    eager, graphed = runs[1][0], runs[MOE_K][0]
    gap = diff(eager, graphed)
    logged = [float(m.group(1)) for m in (
        re.search(r"Loss is ([0-9.]+)", ln) for ln in runs[1][3]) if m]
    aux = [a - c for a, c in zip(logged, eager)]
    step_ms = {k: 1e3 * MOE_BATCH / r[2] for k, r in runs.items()}
    print(f"[phase 22 moe] d {MOE_D}, {MOE_EXPERTS} experts, top-{MOE_TOPK}"
          f", capacity {MOE_CAP}, {MOE_BATCH} x {MOE_SEQ} tokens, bf16 on "
          f"{card}: criterion losses eager {[round(x, 4) for x in eager]}, "
          f"graphed (K={MOE_K}) max |d| {gap}; logged minus criterion "
          f"(0.01 x aux) {[round(x, 4) for x in aux]}; step "
          f"{step_ms[1]:.2f} ms eager, {step_ms[MOE_K]:.2f} ms graphed; "
          f"launches {runs[MOE_K][1]}", flush=True)
    if (len(eager) != MOE_STEPS or gap > MOE_LOSS_TOL
            or not all(np.isfinite(eager))
            or len(aux) != MOE_STEPS
            or not all(0.005 <= a <= 0.01 * MOE_EXPERTS + 0.005
                       for a in aux)):
        fail(f"[phase 22 moe] eager {eager}, graphed {graphed}, logged "
             f"{logged}")
    return {"moe step ms eager": round(step_ms[1], 3),
            "moe step ms graphed": round(step_ms[MOE_K], 3)}


def attention_slice_runs(torch, card):
    """Phase 22: the rest of the attention models, (a) to (d). Returns
    ({tag: value}, [launches of the main paths], kernel rows)."""
    from bigdl_tpu_torch.ops import attention_kernel as ak

    t_phase = time.perf_counter()
    _free(torch)
    krows = (check_flash(torch, ak, LONG_SHAPES, LONG_CHUNK)
             + check_flash_bwd(torch, ak, LONG_SHAPES, LONG_CHUNK))
    _free(torch)
    krows += check_flash(torch, ak, VIT_SHAPES) + check_flash_bwd(
        torch, ak, VIT_SHAPES)
    rows, counts = long_row_runs(torch, card)
    remat_grads_check(torch)
    vit_rows, vit_n = vit_row_runs(torch, card)
    rows.update(vit_rows)
    counts += vit_n
    rows.update(keypad_run(torch, card))
    rows.update(moe_run(torch, card))
    _free(torch)
    print(f"[phase 22] {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows, counts, krows


# ---------------------------------------------------------------- phase 23
def _stream_post(port, body, rid=None, drop_after=None, timeout=600):
    """A streamed /generate over a raw socket: (status, headers, [frames],
    seconds to the first frame, seconds to the end). ``drop_after``:
    close the socket after that many frames (a client that goes away)."""
    import socket

    data = json.dumps(dict(body, stream=True)).encode()
    head = (f"POST /generate HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            + (f"x-request-id: {rid}\r\n" if rid else "") + "\r\n")
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    t0 = time.perf_counter()
    sock.sendall(head.encode() + data)
    f = sock.makefile("rb")
    try:
        status = int(f.readline().split()[1])
        headers = {}
        while True:
            line = f.readline().decode().strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if "chunked" not in headers.get("transfer-encoding", ""):
            out = json.loads(f.read(int(headers["content-length"])))
            return status, headers, [out], None, time.perf_counter() - t0
        frames, first, buf = [], None, b""
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                break
            buf += f.read(n)
            f.readline()  # the chunk's CRLF
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                if first is None:
                    first = time.perf_counter() - t0
                if not frame.startswith(b"data: "):
                    fail(f"[phase 23] a stream frame without 'data: ': "
                         f"{frame}")
                frames.append(json.loads(frame[6:]))
            if drop_after is not None and len(frames) >= drop_after:
                break
        return status, headers, frames, first, time.perf_counter() - t0
    finally:
        f.close()
        sock.close()


def _post_h(port, path, body, rid=None, timeout=600):
    """(status, headers, body) of a JSON POST."""
    hdr = {"Content-Type": "application/json"}
    if rid:
        hdr["x-request-id"] = rid
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), headers=hdr)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, \
                json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, \
            json.loads(e.read())


def _get_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _parallel(fn, items):
    """fn(i, item) for every item on its own thread; {i: result}."""
    out = {}

    def one(i, it):
        out[i] = fn(i, it)

    ths = [threading.Thread(target=one, args=(i, it))
           for i, it in enumerate(items)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(600)
    if len(out) != len(items):
        fail(f"[phase 23] {len(items) - len(out)} client threads did not "
             f"finish")
    return out


def front_args(extra=(), weights=("--randomInit",)):
    """The serve flags of phase 23's server and workers."""
    return list(FRONT_MODEL) + list(weights) + FRONT_PLATFORM + [
        "--bf16", "--slots", str(PAGED_SLOTS), "--kvPageTokens",
        str(PAGE_TOKENS), "--buckets", "1,2,4", "--port", "0"] + list(extra)


def front_model(torch, seed):
    """Phase 23's LM from ``seed`` with its embedding x0.02, on the CPU
    (the weights of --randomInit at seed 0)."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.models import TransformerLM

    a = serve_cli.build_parser().parse_args(front_args())
    g = torch.Generator().manual_seed(seed)
    if a.vocabSize is not None:
        model = TransformerLM(a.vocabSize, d_model=a.dModel,
                              num_layers=a.numLayers, num_heads=a.numHeads,
                              max_len=a.seq or 128, attn_impl="flash",
                              generator=g)
    else:
        model, _ = build_model(a.model, seq_len=a.seq, generator=g)
    with torch.no_grad():
        model.emb.weight.mul_(0.02)
    return model


def front_server(torch, extra=()):
    """(app, server, port, thread) of a phase 23 server in this process,
    its embedding x0.02 as phase 14's."""
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import make_server

    t0 = time.perf_counter()
    app, _, _, _ = serve_cli.build_app(serve_cli.build_parser().parse_args(
        front_args(extra)))
    with torch.no_grad():
        app.decoder.model.emb.weight.mul_(0.02)
    srv = make_server(app, "127.0.0.1", 0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    print(f"[phase 23] build_app {' '.join(extra)} with every graph "
          f"captured {time.perf_counter() - t0:.1f}s", flush=True)
    return app, srv, srv.server_address[1], thr


def stop_server(app, srv, thr):
    srv.shutdown()
    srv.server_close()
    app.close()
    thr.join(30)


def stream_vs_buffered(port, tag, prompts):
    """16 streamed, then the same 16 buffered, greedy, concurrently:
    (streamed tokens, buffered tokens, stream first-frame seconds,
    buffered seconds). Streamed tokens must equal the buffered ones bit
    for bit. The rids are ``<tag>-s<i>`` and ``<tag>-b<i>``."""
    rtag = tag.replace(" ", "-")

    def streamed(i, p):
        st, hdr, frames, first, _ = _stream_post(
            port, {"tokens": p, "max_new_tokens": MAX_NEW},
            rid=f"{rtag}-s{i:02d}")
        if st != 200 or not frames or not frames[-1].get("done"):
            fail(f"[phase 23 {tag}] stream {i} answered {st}: {frames}")
        if hdr.get("x-request-id") != f"{rtag}-s{i:02d}":
            fail(f"[phase 23 {tag}] stream {i} echoed rid "
                 f"{hdr.get('x-request-id')}")
        toks = [t for f in frames[:-1] for t in f["tokens"]]
        if frames[-1]["prompt_len"] != len(p) or \
                frames[-1]["tokens_out"] != len(toks):
            fail(f"[phase 23 {tag}] stream {i}'s done frame {frames[-1]}")
        return toks, first

    def buffered(i, p):
        t0 = time.perf_counter()
        st, hdr, out = _post_h(port, "/generate",
                               {"tokens": p, "max_new_tokens": MAX_NEW},
                               rid=f"{rtag}-b{i:02d}")
        if st != 200 or hdr.get("x-request-id") != f"{rtag}-b{i:02d}":
            fail(f"[phase 23 {tag}] buffered {i} answered {st} "
                 f"{hdr.get('x-request-id')}: {out}")
        return out["tokens"], time.perf_counter() - t0

    s = _parallel(streamed, prompts)
    b = _parallel(buffered, prompts)
    s_toks = [s[i][0] for i in range(len(prompts))]
    b_toks = [b[i][0] for i in range(len(prompts))]
    diff = [i for i in range(len(prompts)) if s_toks[i] != b_toks[i]]
    if diff:
        fail(f"[phase 23 {tag}] streamed tokens differ from buffered at "
             f"requests {diff}: {[(s_toks[i], b_toks[i]) for i in diff]}")
    print(f"[phase 23 {tag}] {len(prompts)} streamed = {len(prompts)} "
          f"buffered greedy requests, token for token", flush=True)
    return (s_toks, b_toks, [s[i][1] for i in range(len(prompts))],
            [b[i][1] for i in range(len(prompts))])


def front_inproc_run(torch, card):
    """Phase 23 (a): returns (rows, flash_fwd launches, the app and its
    server (kept for (b) and (d)), the greedy requests and their
    tokens)."""
    import tempfile

    from bigdl_tpu_torch import ops

    rows = {}
    access = os.path.join(tempfile.mkdtemp(prefix="front_"), "access.jsonl")
    app, srv, port, thr = front_server(torch, [
        "--reqTrace", "on", "--slo", FRONT_SLO, "--accessLog", access])
    _, reqs = paged_requests(app.decoder.model.vocab)
    prompts = [p for p, _ in reqs]
    st, _, out = _post_h(port, "/generate", {"tokens": [1, 2, 3],
                                             "max_new_tokens": 2})
    if st != 200:
        fail(f"[phase 23 a] the warm-up /generate answered {st}: {out}")
    with open(access) as f:
        n_warm = sum(1 for _ in f)
    ops.reset_kernel_launches()
    s_toks, b_toks, s_first, b_wall = stream_vs_buffered(port, "a", prompts)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()["flash_fwd"]
    need = 12 * 2 * len(prompts)
    print(f"[phase 23 a] flash_fwd launches {launches} over "
          f"{2 * len(prompts)} prefills (need >= {need})", flush=True)
    if launches < need:
        fail(f"[phase 23 a] flash_fwd ran {launches} times, fewer than "
             f"{need}: a prefill did not go through it")
    # the access log: one line per request, the rids echoed
    with open(access) as f:
        lines = [json.loads(ln) for ln in f][n_warm:]
    recs = {r["rid"]: r for r in lines}
    want = {f"a-{k}{i:02d}" for k in "sb" for i in range(len(prompts))}
    if len(lines) != len(want) or set(recs) != want:
        fail(f"[phase 23 a] the access log has {len(lines)} lines for "
             f"{len(want)} requests: {sorted(set(recs) ^ want)}")
    bad = [r for r in lines if r["state"] != "finished"
           or r["tokens_out"] != MAX_NEW]
    if bad:
        fail(f"[phase 23 a] access-log records not finished: {bad[:2]}")
    ttft = {k: [recs[f"a-{k}{i:02d}"]["ttft_ms"]
                for i in range(len(prompts))] for k in "sb"}
    tpot = [r["tpot_ms"] for r in lines]
    rows["a TTFT ms, streamed, server (p50/p99)"] = (
        f"{_pct(ttft['s'], .5):.2f}/{_pct(ttft['s'], .99):.2f}")
    rows["a TTFT ms, buffered, server (p50/p99)"] = (
        f"{_pct(ttft['b'], .5):.2f}/{_pct(ttft['b'], .99):.2f}")
    rows["a first frame ms, streamed, client (p50/p99)"] = (
        f"{1e3 * _pct(s_first, .5):.2f}/{1e3 * _pct(s_first, .99):.2f}")
    rows["a whole answer ms, buffered, client (p50/p99)"] = (
        f"{1e3 * _pct(b_wall, .5):.2f}/{1e3 * _pct(b_wall, .99):.2f}")
    rows["a TPOT ms p50"] = f"{_pct(tpot, .5):.3f}"
    st, dbg = _get_json(port, "/debug/requests")
    if st != 200 or "slo" not in dbg or dbg["dropped"] != 0:
        fail(f"[phase 23 a] /debug/requests answered {st}: "
             f"{str(dbg)[:300]}")
    rows["a SLO " + FRONT_SLO + " goodput"] = dbg["slo"]["goodput_frac"]
    # a client that goes away mid-stream: its slot and pages come back
    base = app.decoder.kv_pages_in_use()
    cancelled = app.metrics._metrics["decode_cancelled_total"]
    n_cancel = cancelled.value
    st, _, frames, _, _ = _stream_post(port, {"tokens": prompts[5],
                                              "max_new_tokens": 256},
                                       rid="a-drop", drop_after=2)
    t0 = time.perf_counter()
    while (app.decoder.kv_pages_in_use() != base
           or app.decoder.queue_load()) and time.perf_counter() - t0 < 30:
        time.sleep(0.05)
    rec = [r for r in app.decoder.debug_snapshot()["slots"]
           if r.get("rid") == "a-drop"]
    print(f"[phase 23 a] a client dropped after {len(frames)} frames: "
          f"kv_pages_in_use {app.decoder.kv_pages_in_use()} (baseline "
          f"{base}) after {time.perf_counter() - t0:.2f}s", flush=True)
    if st != 200 or app.decoder.kv_pages_in_use() != base or rec or \
            cancelled.value != n_cancel + 1:
        fail(f"[phase 23 a] the dropped stream kept its slot or pages, or "
             f"was not cancelled: {app.decoder.kv_pages_in_use()} in use, "
             f"baseline {base}, {cancelled.value - n_cancel} cancelled")
    # the same traffic under --speculate 4: streamed = buffered again
    spec, ssrv, sport, sthr = front_server(torch, ["--speculate",
                                                   str(SPEC_K)])
    try:
        ops.reset_kernel_launches()
        sp_s, _, _, _ = stream_vs_buffered(sport, "a speculate", prompts)
        torch.cuda.synchronize()
        spec_launches = ops.kernel_launches()["flash_fwd"]
    finally:
        stop_server(spec, ssrv, sthr)
        del spec
        _free(torch)
    same = sum(a == b for a, b in zip(sp_s, s_toks))
    rows["a --speculate 4 streams equal to plain"] = \
        f"{same} of {len(prompts)}"
    print(f"[phase 23 a] --speculate {SPEC_K}: flash_fwd launches "
          f"{spec_launches}; {same} of {len(prompts)} speculative streams "
          f"equal the plain ones ({card})", flush=True)
    if spec_launches < need:
        fail(f"[phase 23 a] speculative flash_fwd ran {spec_launches} times")
    return rows, launches + spec_launches, (app, srv, port, thr), \
        prompts, b_toks


def fault_runs(torch, port, app):
    """Phase 23 (b) on (a)'s server: ``dispatch@request:2`` answers the
    2nd request 503 and the 3rd 200; ``worker_kill@infer:1`` kills the
    batcher's worker on its first forward (that /predict 500), after
    which /predict answers the watchdog's fast 503 and /readyz 503."""
    from bigdl_tpu_torch.resilience import faults

    body = {"tokens": [1, 2, 3], "max_new_tokens": 2}
    faults.install_plan(faults.parse_plan("dispatch@request:2"))
    got = [_post_h(port, "/generate", body)[0] for _ in range(3)]
    print(f"[phase 23 b] dispatch@request:2: /generate {got}", flush=True)
    if got != [200, 503, 200]:
        fail(f"[phase 23 b] dispatch@request:2 gave {got}, expected "
             f"[200, 503, 200]")
    faults.install_plan(faults.parse_plan("worker_kill@infer:1"))
    rows = {"inputs": [[1, 2, 3, 4] * 4]}
    st1 = _post_h(port, "/predict", rows)[0]
    t0 = time.perf_counter()
    st2, _, out2 = _post_h(port, "/predict", rows)
    dt = time.perf_counter() - t0
    st_r, _ = _get_json(port, "/readyz")
    st_h, _ = _get_json(port, "/healthz")
    faults.clear_plan()
    print(f"[phase 23 b] worker_kill@infer:1: /predict {st1} then {st2} in "
          f"{1e3 * dt:.1f} ms ({out2.get('error', '')[:60]}), /readyz "
          f"{st_r}, /healthz {st_h}", flush=True)
    if (st1, st2, st_r, st_h) != (500, 503, 503, 200) or dt > 2.0:
        fail(f"[phase 23 b] worker_kill@infer:1 gave /predict {st1}, {st2} "
             f"({dt:.2f}s), /readyz {st_r}, /healthz {st_h}")


class _Fleet:
    """``python -m bigdl_tpu_torch.cli.fleet`` as a subprocess: its
    stdout read on a thread, each line stamped with its arrival."""

    def __init__(self, argv):
        self.lines = []
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bigdl_tpu_torch.cli.fleet"] + argv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            bufsize=1, cwd=os.path.dirname(os.path.abspath(__file__)))
        self.port = None
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0,
                               line.rstrip("\n")))
            m = re.search(r"fleet on http://[^:]+:(\d+)", line)
            if m:
                self.port = int(m.group(1))

    def wait_ready(self, timeout):
        t_end = time.perf_counter() + timeout
        while self.port is None:
            if self.proc.poll() is not None or time.perf_counter() > t_end:
                tail = "\n".join(ln for _, ln in self.lines[-40:])
                self.stop()
                fail(f"[phase 23 c] the fleet did not come up (rc "
                     f"{self.proc.poll()}):\n{tail}")
            time.sleep(0.1)

    def line_at(self, pattern):
        return [(t, ln) for t, ln in self.lines if re.search(pattern, ln)]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)


def fleet_runs(torch, card, app, port, prompts, tokens_v0):
    """Phase 23 (c) and (d) against (a)'s server (``app`` at ``port``,
    weights v0). Returns rows."""
    import signal
    import tempfile

    from bigdl_tpu_torch.interop.checkpoint import save_model
    from bigdl_tpu_torch.serving import DecodeEngine
    from bigdl_tpu_torch.serving.fleet.swap import swap_app_weights

    rows = {}
    td = tempfile.mkdtemp(prefix="fleet_")
    for name, model in (("v0", app.decoder.model),
                        ("v1", front_model(torch, 1))):
        os.makedirs(os.path.join(td, name))
        save_model(os.path.join(td, name, "model.1"), model)
    short = [i for i, p in enumerate(prompts) if len(p) <= PAGE_TOKENS]
    fleet = _Fleet(front_args(["--modelVersion", "v0", "--fleet", "2",
                               "--prefixCache", "--reqTrace", "on",
                               "--fleetHeartbeatS", "0.2"],
                              weights=("--model", os.path.join(td, "v0"))))
    try:
        fleet.wait_ready(FLEET_BOOT_S)
        fport = fleet.port
        boots = {int(m.group(1)): t for t, ln in fleet.line_at(
            r"^\[worker (\d)\] serving ") for m in [re.match(
                r"^\[worker (\d)\]", ln)]}
        for t, ln in fleet.line_at(r"^\[worker \d\] worker \d built"):
            print(f"[phase 23 c] {ln} ({card})", flush=True)
        rows["c worker boot s (spawn to serving line)"] = ", ".join(
            f"{boots[i]:.1f}" for i in sorted(boots))
        st, tbl = _get_json(fport, "/debug/fleet")
        wports = {w["worker"]: w["port"] for w in tbl["workers"]}
        # (c) buffered and streamed through the router equal (a)'s tokens
        for i in short:
            st, hdr, out = _post_h(fport, "/generate",
                                   {"tokens": prompts[i],
                                    "max_new_tokens": MAX_NEW},
                                   rid=f"c-b{i:02d}")
            sst, shdr, frames, _, _ = _stream_post(
                fport, {"tokens": prompts[i], "max_new_tokens": MAX_NEW},
                rid=f"c-s{i:02d}")
            stoks = [t for f in frames[:-1] for t in f.get("tokens", [])]
            if (st, sst) != (200, 200) or out["tokens"] != tokens_v0[i] \
                    or stoks != tokens_v0[i] \
                    or hdr.get("x-request-id") != f"c-b{i:02d}" \
                    or shdr.get("x-request-id") != f"c-s{i:02d}":
                fail(f"[phase 23 c] request {i} through the router: {st} "
                     f"{out}, stream {sst} {stoks}, (a) {tokens_v0[i]}")
        print(f"[phase 23 c] {len(short)} buffered and {len(short)} "
              f"streamed requests through the router equal (a)'s tokens",
              flush=True)
        # the router's added latency: direct to a worker vs through it
        body = {"tokens": prompts[short[0]], "max_new_tokens": MAX_NEW}
        times = {"direct": [], "router": []}
        for _ in range(ROUTER_REPS):
            for k, p in (("direct", wports[0]), ("router", fport),
                         ("router", fport), ("direct", wports[0])):
                t0 = time.perf_counter()
                if _post_h(p, "/generate", body)[0] != 200:
                    fail(f"[phase 23 c] a {k} latency request failed")
                times[k].append(1e3 * (time.perf_counter() - t0))
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        rows["c /generate ms direct / through the router (medians)"] = (
            f"{med['direct']:.2f} / {med['router']:.2f}")
        rows["c router's added ms"] = f"{med['router'] - med['direct']:.2f}"
        # SIGKILL worker 0: /readyz stays 200, the router restarts it
        pid0 = [w["pid"] for w in tbl["workers"] if w["worker"] == 0][0]
        os.kill(pid0, signal.SIGKILL)
        t_kill = time.perf_counter()
        ready, w0 = [], None
        while time.perf_counter() - t_kill < FLEET_BOOT_S:
            ready.append(_get_json(fport, "/readyz")[0])
            w0 = [w for w in _get_json(fport, "/debug/fleet")[1]["workers"]
                  if w["worker"] == 0][0]
            if w0["routable"] and w0["pid"] != pid0:
                break
            time.sleep(0.05)
        t_restart = time.perf_counter() - t_kill
        print(f"[phase 23 c] worker 0 SIGKILLed: /readyz "
              f"{sorted(set(ready))} over {len(ready)} polls, back in "
              f"rotation after {t_restart:.1f}s with restarts "
              f"{w0['restarts']} ({card})", flush=True)
        if set(ready) != {200} or not w0["routable"] or w0["restarts"] != 1:
            fail(f"[phase 23 c] after the SIGKILL: /readyz {set(ready)}, "
                 f"worker 0 {w0}")
        rows["c worker restart s (SIGKILL to routable)"] = f"{t_restart:.1f}"
        for t, ln in fleet.line_at(r"^\[worker 0\] worker 0 built")[1:]:
            print(f"[phase 23 c] restarted: {ln} ({card})", flush=True)
        st, page = _get(fport, "/metrics")
        for needle in ('worker="0"', 'worker="1"', "# fleet aggregate",
                       "bigdl_fleet_worker_restarts_total 1"):
            if needle not in page:
                fail(f"[phase 23 c] the router's /metrics lacks {needle!r}")
        print("[phase 23 c] the router's /metrics carries worker=\"0\"/"
              "\"1\" series and fleet totals", flush=True)

        # (d) the rolling swap to v1 under a steady stream
        _, tbl = _get_json(fport, "/debug/fleet")
        wports = {w["worker"]: w["port"] for w in tbl["workers"]}
        shared = prompts[len(PAGED_LENS)][:SHARED_PREFIX]
        probe = shared + prompts[len(PAGED_LENS) + 1][SHARED_PREFIX:]
        for w, p in wports.items():  # cache the shared prefix under v0
            st, _, _ = _post_h(p, "/generate", {"tokens": shared + [0],
                                                "max_new_tokens": 2})
            _, _, out = _post_h(p, "/generate", {"tokens": probe,
                                                 "max_new_tokens": 2})
        _, dbg = _get_json(wports[0], "/debug/requests")
        if dbg["recent"][-1]["prefix_hit_tokens"] != SHARED_PREFIX:
            fail(f"[phase 23 d] the probe was no prefix hit before the "
                 f"swap: {dbg['recent'][-1]}")
        got, stop = [], threading.Event()

        def client(k):
            n = 0
            while not stop.is_set():
                i = short[(n + k) % len(short)]
                got.append((i,) + _post_h(fport, "/generate", {
                    "tokens": prompts[i], "max_new_tokens": MAX_NEW}))
                n += 1

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(SWAP_CLIENTS)]
        for t in clients:
            t.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        st, _, res = _post_h(fport, "/admin/reload", {
            "checkpoint": os.path.join(td, "v1"), "version": "v1"})
        t_swap = time.perf_counter() - t0
        time.sleep(1.0)
        stop.set()
        for t in clients:
            t.join(120)
        if st != 200:
            fail(f"[phase 23 d] /admin/reload answered {st}: {res}")
        rows["d rolling swap s (2 workers)"] = f"{t_swap:.2f}"
        # the v1 reference: (a)'s server swapped in place (graphed), and an
        # eager engine built on the v1 checkpoint
        swap_app_weights(app, os.path.join(td, "v1"), "v1")
        ref = {}
        for i in short + ["probe"]:
            p = probe if i == "probe" else prompts[i]
            st, hdr, out = _post_h(port, "/generate",
                                   {"tokens": p, "max_new_tokens": MAX_NEW})
            if st != 200 or hdr.get("x-model-version") != "v1":
                fail(f"[phase 23 d] (a) after its swap: {st} {hdr}")
            ref[i] = out["tokens"]
        m1 = front_model(torch, 1).to(DEV)
        m1.compute_dtype = torch.bfloat16
        eager = DecodeEngine(m1, slots=PAGED_SLOTS,
                             cache_dtype=torch.bfloat16, device=DEV,
                             kv_page_tokens=PAGE_TOKENS, graphs=False)
        e_toks = {i: eager.generate(probe if i == "probe" else prompts[i],
                                    MAX_NEW) for i in ref}
        eager.close()
        del eager, m1
        if e_toks != ref:
            fail(f"[phase 23 d] the graphed decode after the in-place swap "
                 f"differs from an eager engine on v1: {ref} vs {e_toks}")
        print(f"[phase 23 d] (a)'s graphed decode after its in-place swap = "
              f"an eager engine built on v1, {len(ref)} requests",
              flush=True)
        vers = {}
        for i, st, hdr, out in got:
            v = hdr.get("x-model-version")
            vers[v] = vers.get(v, 0) + 1
            want = {"v0": tokens_v0[i], "v1": ref[i]}.get(v)
            if st != 200 or out.get("tokens") != want:
                fail(f"[phase 23 d] a request during the swap: {st} "
                     f"version {v}, tokens {out} (v0 {tokens_v0[i]}, v1 "
                     f"{ref[i]})")
        print(f"[phase 23 d] {len(got)} requests during the swap, no 5xx, "
              f"by version {vers}, each equal to its version's tokens; the "
              f"swap took {t_swap:.2f}s: {res['workers']} ({card})",
              flush=True)
        if set(vers) != {"v0", "v1"}:
            fail(f"[phase 23 d] versions seen during the swap: {vers}")
        for w, p in wports.items():
            st, hdr, out = _post_h(p, "/generate", {
                "tokens": probe, "max_new_tokens": MAX_NEW})
            if st != 200 or out["tokens"] != ref["probe"] or \
                    hdr.get("x-model-version") != "v1":
                fail(f"[phase 23 d] worker {w}: the probe sharing a prefix "
                     f"cached under v0 gave {out} "
                     f"({hdr.get('x-model-version')}), v1's tokens are "
                     f"{ref['probe']}")
        print("[phase 23 d] after the swap, a prompt sharing a prefix cached "
              "under v0 gives v1's tokens on both workers", flush=True)
    finally:
        fleet.stop()
    return rows


def serving_front_runs(torch, card):
    """Phase 23: the serving front. Returns ({tag: value}, flash_fwd
    launches of (a)'s traffic)."""
    t_phase = time.perf_counter()
    rows, launches, (app, srv, port, thr), prompts, toks = \
        front_inproc_run(torch, card)
    try:
        rows.update(fleet_runs(torch, card, app, port, prompts, toks))
        fault_runs(torch, port, app)
    finally:
        from bigdl_tpu_torch.resilience import faults
        from bigdl_tpu_torch.serving import reqtrace

        faults.clear_plan()
        stop_server(app, srv, thr)
        reqtrace.set_request_tracer(None)
    del app
    _free(torch)
    print(f"[phase 23] {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows, launches


# ---------------------------------------------------------------- phase 24
# (a)'s sweep: the BN shapes (ResNet-50's stage 1, Inception-v2's 6272 x
# 288, VGG's 2-D 128 x 512; bf16, the fused pair with ReLU on, and off at
# 401408 x 256 as ResNet-50's stage-1 BNs before the sum take it), the
# key-padded 1k attention, the served LM's KV pages and int8 products, the
# bucket bound at one rank, ResNet-50's 7x7/2 stem and a 1x1
TUNE_BN = [(401408, 256, (True, False)), (6272, 288, (True,)),
           (128, 512, (True,))]
TUNE_PREFILL_ROWS, TUNE_DECODE_ROWS = 512, 16
INT8_TOL = 1e-6  # native int8, card vs CPU, max|d|/max|ref| in f32
TUNE_QUANT_KN = [(1024, 1024), (1024, 256), (1024, 4096), (4096, 1024)]
TUNE_GEOMS = [((7, 7, 2, 2, 3, 64, 1, 1, 1, "bfloat16"), (128, 224, 224, 3),
               False),
              ((1, 1, 1, 1, 256, 64, 1, 1, 1, "bfloat16"), (128, 56, 56, 256),
               True)]
TUNE_PREDICT = (2, 3)           # (c)'s /predict batches (3 pads to 4)
TUNE_PERF_ITERS = 5
TUNE_PROMPTS = (5, 33, 200)     # (e)'s greedy prompts
TUNE_NEW = 12


def _default_ms(op, config):
    """The default candidate's ms in the latest measurement of ``op``."""
    from bigdl_tpu_torch.tuning import measure
    return next((ms for c, ms in measure.LAST.get(op, ())
                 if all(c.get(k) == v for k, v in config.items())), None)


def tune_consult(torch, card, report):
    """Every consultation of (a), in the mode installed: the BN kernels
    called (their wrappers ask the tuner), then the other surfaces.
    ``report`` prints each key's decision beside its default's time."""
    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.ops import bn_kernel as bk
    from bigdl_tpu_torch.ops.attention_kernel import flash_block_k
    from bigdl_tpu_torch.parallel import init_distributed
    from bigdl_tpu_torch.parallel.launch import free_port
    import torch.distributed as dist

    bf16 = torch.bfloat16
    for rows, c, relus in TUNE_BN:
        g = torch.Generator(device="cuda").manual_seed(rows + c)
        x = torch.randn(rows, c, device="cuda", generator=g).to(bf16)
        vec = torch.ones(c, device="cuda")
        bk.bn_stats(x)
        report("bn_stats", tuning.make_key(
            "bn_stats", rows=rows, channels=c, dtype="bfloat16"),
            "bn_stats:default")
        for relu in relus:
            bk.bn_fwd_apply(x, vec, vec * 0, BN_EPS, relu)
            report("bn_fba", tuning.make_key(
                "bn_fba", rows=rows, channels=c, dtype="bfloat16",
                relu=int(relu)), "bn_fba:default")
        del x
    flash_block_k(1024, 1024, 128, True, bf16)
    report("flash", tuning.make_key("flash", seq_q=1024, seq_k=1024,
                                    head_dim=128, causal=1,
                                    dtype="bfloat16"), {"block_k": 512})
    tuning.kv_page_tokens(1024, 2, 128, bf16)
    report("kv_pages", tuning.make_key("kv_pages", max_len=1024, kv_heads=2,
                                       head_dim=128, dtype="bfloat16"),
           {"page_tokens": 128})
    for m, rows in ((TUNE_PREFILL_ROWS, TUNE_PREFILL_ROWS),
                    (1, TUNE_DECODE_ROWS)):
        for k, n in TUNE_QUANT_KN:
            tuning.quant_matmul_kind(m, k, n, bf16, rows=rows)
            report("quant", tuning.make_key("quant", m=m, k=k, n=n,
                                            dtype="bfloat16"),
                   {"kind": "dequant"})
    from bigdl_tpu_torch.cli import perf
    model, _ = perf.build_model("resnet50_fba")
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    del model
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        tuning.grad_bucket_bytes(param_bytes, 1, "bfloat16")
    finally:
        dist.destroy_process_group()
    report("grad_comm", tuning.make_key(
        "grad_comm", param_mib=-(-param_bytes // 2 ** 20), n_devices=1,
        dtype="bfloat16"), {"bucket_bytes": 4 * 2 ** 20})
    for geom, x_shape, gemm_ok in TUNE_GEOMS:
        for p in ("fwd", "dgrad", "wgrad"):
            tuning.conv_geom_layout(p, geom, x_shape, gemm_ok)
            report("conv_geom", tuning.conv_geom_key(p, geom),
                   {"layout": "NHWC"})


def tuned_bn_check(torch, card):
    """Each BN kernel under its tuned plan (the tuner in ``cached``) at
    (a)'s shapes against its plain version, within phase 7's tolerances;
    each kernel's device ms under the untuned and the tuned plan."""
    from bigdl_tpu_torch.ops import bn_kernel as bk
    from bigdl_tpu_torch.tools.timing import device_ms

    bad = []
    for rows, c, _ in TUNE_BN:
        g = torch.Generator(device="cuda").manual_seed(rows + c + 1)
        x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5
             + 0.3).to(torch.bfloat16)
        dy = torch.randn(rows, c, device="cuda", generator=g).to(x.dtype)
        gamma = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
        beta = 0.2 * torch.randn(c, device="cuda", generator=g)
        _, mean, var = bk.bn_fwd_apply_reference(x, gamma, beta, BN_EPS)
        inv = torch.rsqrt(var + BN_EPS)
        cases = (
            ("bn_stats", bk._STATS, False, lambda: bk.bn_stats(x),
             lambda: bk.bn_stats_reference(x)),
            ("bn_bwd_stats", bk._BWD_STATS, False,
             lambda: bk.bn_bwd_stats(dy, x, mean, inv),
             lambda: bk.bn_bwd_stats_reference(dy, x, mean, inv)),
            ("bn_fwd_apply", bk._FWD, True,
             lambda: bk.bn_fwd_apply(x, gamma, beta, BN_EPS, True),
             lambda: bk.bn_fwd_apply_reference(x, gamma, beta, BN_EPS, True)),
            ("bn_bwd_fused", bk._BWD_FUSED, True,
             lambda: bk.bn_bwd_fused(dy, x, mean, inv, gamma, beta, True),
             lambda: bk.bn_bwd_fused_reference(dy, x, mean, inv, gamma,
                                               beta, True)))
        for name, mode, relu, run, plain in cases:
            slab = bk._tuned_slab(mode, x, bk._vec(c, [x]), relu)
            got, ref = run(), plain()
            torch.cuda.synchronize()
            rel = [float((a.float() - r.float()).abs().max()
                         / r.float().abs().max().clamp_min(1e-30))
                   for a, r in zip(got, ref)]
            tols = [BN_TOL["bfloat16"]] if name in ("bn_fwd_apply",
                                                    "bn_bwd_fused") else []
            tols += [BN_SUM_TOL] * (len(rel) - len(tols))
            ok = all(bool(torch.isfinite(t.float()).all()) for t in got) \
                and all(e <= t for e, t in zip(rel, tols))
            with bk.pinned_slab(None):
                base_ms = device_ms(run)
            tuned_ms = device_ms(run)
            print(f"[phase 24 a] {name} {rows}x{c} bf16 relu={int(relu)} "
                  f"under its tuned plan (slab {slab or 'untuned'}): "
                  f"max|d|/max|ref| {['%.1e' % e for e in rel]} untuned "
                  f"{base_ms:.4f} ms, tuned {tuned_ms:.4f} ms on {card} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append((name, rows, c, rel))
        del x, dy
    if bad:
        fail(f"[phase 24 a] BN kernels under tuned plans disagree with "
             f"their plain versions: {bad}")


def int8_check(torch, card):
    """The native-int8 product on the card: ``torch._int_mm``'s int32
    sums equal the exact integer product of the same int8 operands, and
    the whole product (the dynamic activation scale, both scales in the
    epilogue) is within ``INT8_TOL`` of max|ref| of the same arithmetic on
    the CPU in f32 (the card divides by the scalar 127 as a multiply by
    its reciprocal, an ulp off the CPU's quotient); which row counts
    ``torch._int_mm`` takes."""
    from bigdl_tpu_torch.serving.quant import native_int8_product
    from bigdl_tpu_torch.tuning import autotune as at

    g = torch.Generator().manual_seed(8)
    k, n = 1024, 256
    q = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 0.01
    worst = 0.0
    for rows in (TUNE_PREFILL_ROWS, 24, 32, 40):
        x = torch.randn(rows, k, generator=g)
        xq = torch.randint(-127, 128, (rows, k), generator=g,
                           dtype=torch.int8)
        acc = torch._int_mm(xq.to(DEV), q.to(DEV)).cpu()
        exact = (xq.long() @ q.long()).to(torch.int32)
        got = native_int8_product(x.to(DEV), q.to(DEV), s.to(DEV),
                                  torch.float32).cpu()
        ref = native_int8_product(x, q, s, torch.float32)
        err = float((got - ref).abs().max() / ref.abs().max())
        worst = max(worst, err)
        if not torch.equal(acc, exact) or err > INT8_TOL \
                or not at.int_mm_ok(rows, k, n):
            fail(f"[phase 24 a] native int8 at {rows} x {k} x {n}: int32 "
                 f"sums exact {torch.equal(acc, exact)}, max|d|/max|ref| "
                 f"{err}, int_mm_ok {at.int_mm_ok(rows, k, n)}")
    taken = {}
    for rows in (16, 17, 20, 33, 100):
        try:
            torch._int_mm(torch.ones(rows, k, dtype=torch.int8, device=DEV),
                          q.to(DEV))
            torch.cuda.synchronize()
            taken[rows] = True
        except RuntimeError:
            taken[rows] = False
        if taken[rows] and not at.int_mm_ok(rows, k, n):
            print(f"[phase 24 a] note: torch._int_mm takes {rows} rows, "
                  f"which int_mm_ok refuses", flush=True)
        if not taken[rows] and at.int_mm_ok(rows, k, n):
            fail(f"[phase 24 a] torch._int_mm refuses {rows} rows, which "
                 f"int_mm_ok offers")
    print(f"[phase 24 a] native int8 on the card: int32 sums exact, the "
          f"product within {worst:.1e} of max|ref| of the CPU's (f32, "
          f"{TUNE_PREFILL_ROWS}/24/32/40 x {k} x {n}); torch._int_mm takes "
          f"rows {taken} on {card}", flush=True)


def tune_serve_run(torch, card):
    """(c): ``serve resnet50 --classes 1000 --fusedBN apply --autotune
    cached --randomInit`` through ``cli.serve.build_app``, f32, over HTTP
    from a thread: /predict batches of seeded images against the offline
    eval forward, /healthz; graphs, warm-up seconds and peak memory."""
    import numpy as np

    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import make_server

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app, engine, in_shape, _ = serve_cli.build_app(
        serve_cli.build_parser().parse_args(
            ["resnet50", "--classes", "1000", "--fusedBN", "apply",
             "--autotune", "cached", "--randomInit", "--port", "0"]))
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    srv = make_server(app, "127.0.0.1", 0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    port = srv.server_address[1]
    rs = np.random.RandomState(24)
    try:
        got, xs = [], []
        for n in TUNE_PREDICT:
            x = np.round(rs.randn(n, *in_shape), 2).astype(np.float32)
            st, out = _post(port, "/predict", {"inputs": x.tolist(),
                                               "return_scores": True})
            if st != 200:
                fail(f"[phase 24 c] /predict of {n} images answered {st}: "
                     f"{str(out)[:200]}")
            got.append(np.asarray(out["scores"], np.float32))
            xs.append(x)
        st_h, _ = _get(port, "/healthz")
        with torch.no_grad():
            ref = [engine.module(torch.from_numpy(x).to(DEV)).float().cpu()
                   .numpy() for x in xs]
        graphs = len(engine.graphs)
    finally:
        stop_server(app, srv, thr)
    err = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, ref))
    print(f"[phase 24 c] serve resnet50 --fusedBN apply --autotune cached "
          f"f32: /predict {list(TUNE_PREDICT)} images 200, /healthz {st_h}, "
          f"scores vs the offline eval forward max|d|/max|ref| {err:.2e} "
          f"(tolerance {LOGIT_TOL['float32']}); {graphs} graphs captured, "
          f"build and warm-up {warm:.1f}s, peak memory {peak:.2f} GiB on "
          f"{card}", flush=True)
    if st_h != 200 or err > LOGIT_TOL["float32"] or graphs != len(
            engine.buckets):
        fail(f"[phase 24 c] /healthz {st_h}, score error {err}, graphs "
             f"{graphs} for buckets {engine.buckets}")
    del app, engine
    _free(torch)
    return {"resnet50 serve build+warm-up s": round(warm, 1),
            "resnet50 serve peak GiB": round(peak, 2)}


def tune_perf_runs(torch, card):
    """(d): ``cli.perf -m resnet50_fba`` with ``--autotune off`` and then
    ``cached``: rates, BN launches (exactly 53 a step of each fused
    kernel), and the second line's ``autotune`` with the BN and conv keys
    it consulted."""
    import math

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf

    rows, counts = {}, []
    steps = RESNET_WARMUP + TUNE_PERF_ITERS
    for mode in ("off", "cached"):
        ops.reset_kernel_launches()
        res = perf.run("resnet50_fba", batch=RESNET_BATCH,
                       iterations=TUNE_PERF_ITERS, dtype=torch.bfloat16,
                       warmup=RESNET_WARMUP, data_type="random",
                       autotune=mode)
        torch.cuda.synchronize()
        n = ops.kernel_launches()
        counts.append(n)
        want = {k: (53 * steps if k in ("bn_fwd_apply", "bn_bwd_fused")
                    else 0) for k in n}
        ann = res.get("autotune")
        keys = sorted((ann or {}).get("decisions", {}))
        print(f"[phase 24 d] cli.perf -m resnet50_fba --autotune {mode} bf16 "
              f"batch {RESNET_BATCH} on {card}: {res['records_per_second']} "
              f"images/s, BN launches "
              f"{ {k: v for k, v in n.items() if v} } over {steps} steps; "
              f"autotune {'absent' if ann is None else ann['mode']}, "
              f"{len(keys)} keys", flush=True)
        if mode == "cached":
            for k in keys:
                if not k.startswith("conv_geom") or "default" != \
                        ann["decisions"][k]:
                    print(f"  {k}: {ann['decisions'][k]}", flush=True)
        if not all(math.isfinite(v) for v in res["losses"]) or n != want:
            fail(f"[phase 24 d] --autotune {mode}: losses {res['losses']}, "
                 f"launches {n}, expected {want}")
        if (mode == "off") != (ann is None) or (mode == "cached" and not (
                any(k.startswith("bn_fba|") for k in keys)
                and any(k.startswith("conv_geom|") for k in keys)
                and ann["decisions"].get(
                    "bn_fba|channels=256|dtype=bfloat16|relu=0|rows=401408",
                    "default") != "default")):
            fail(f"[phase 24 d] --autotune {mode}: the line's autotune "
                 f"{ann}")
        rows[f"resnet50_fba --autotune {mode} images/s"] = \
            res["records_per_second"]
        torch.cuda.empty_cache()
    return rows, counts


def untied_serve_run(torch, card):
    """(e): an untied ``transformer_lm_1k_hd128`` (seeded, embedding
    x0.02) served in f32 over HTTP: greedy /generate equals its offline
    ``generate``, and its prefills launch ``flash_fwd`` (12 a prefill at
    least, replays credited). Returns flash_fwd launches."""
    import numpy as np

    from bigdl_tpu_torch import models, ops
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.obs.metrics import MetricsRegistry
    from bigdl_tpu_torch.serving import (DecodeEngine, InferenceEngine,
                                         MicroBatcher, ServingApp,
                                         make_server)
    from bigdl_tpu_torch.serving.graphs import GraphPool

    cfg = perf.LM_CONFIGS[MODEL]
    model = models.transformer_lm(
        perf.LM_VOCAB, attn_impl="flash", tie_embeddings=False,
        generator=torch.Generator().manual_seed(0), **cfg).to(DEV).eval()
    with torch.no_grad():
        model.emb.weight.mul_(0.02)
    metrics, pool = MetricsRegistry(), GraphPool(torch.device(DEV))
    engine = InferenceEngine(model, buckets=(1,), lengths=(64,),
                             metrics=metrics, device=DEV, graphs=pool)
    engine.warmup((cfg["max_len"],), np.int32)
    decoder = DecodeEngine(model, slots=4, metrics=metrics, device=DEV,
                           graphs=pool)
    batcher = MicroBatcher(engine.predict_scores, metrics=metrics)
    decoder.start()
    app = ServingApp(name="untied", metrics=metrics, engine=engine,
                     batcher=batcher, decoder=decoder)
    srv = make_server(app, "127.0.0.1", 0)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    rs = np.random.RandomState(25)
    prompts = [rs.randint(0, perf.LM_VOCAB, n).tolist()
               for n in TUNE_PROMPTS]
    try:
        ops.reset_kernel_launches()
        outs = [_post(srv.server_address[1], "/generate",
                      {"tokens": p, "max_new_tokens": TUNE_NEW})
                for p in prompts]
        torch.cuda.synchronize()
        launches = ops.kernel_launches()["flash_fwd"]
    finally:
        stop_server(app, srv, thr)
    ref = [model.generate(torch.tensor([p], device=DEV), TUNE_NEW)[0]
           .tolist() for p in prompts]
    same = [st == 200 and out["tokens"] == r
            for (st, out), r in zip(outs, ref)]
    print(f"[phase 24 e] untied {MODEL} f32 on {card}: /generate = offline "
          f"generate {same}, flash_fwd launches {launches} over "
          f"{len(prompts)} prefills", flush=True)
    if not all(same) or launches < cfg["num_layers"] * len(prompts):
        fail(f"[phase 24 e] untied head: {outs} vs {ref}, flash_fwd "
             f"launches {launches}")
    del app, engine, decoder, model
    _free(torch)
    return launches


def tuning_runs(torch, card):
    """Phase 24: the autotuner on the card. Returns ({tag: value},
    [launches of (d)'s runs], (e)'s flash_fwd launches)."""
    import shutil

    from bigdl_tpu_torch import tuning
    from bigdl_tpu_torch.ops import conv2d as c2d
    from bigdl_tpu_torch.tuning import measure

    t_phase = time.perf_counter()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "autotune_phase24")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["BIGDL_TPU_AUTOTUNE_CACHE"] = cache
    rows = {}
    try:
        # (a) measure: every key timed on the card, its decision beside
        # the default's time
        tuning.reset()
        tuning.set_mode("measure")
        measured = {}

        def report(op, key, default):
            ent = tuning.get_cache().get(key)
            if ent is None or ent.get("source") != "measured":
                fail(f"[phase 24 a] {key}: not measured ({ent})")
            base = (measure.LAST[default][0][1] if isinstance(default, str)
                    else _default_ms(op, default))
            measured[key] = ent
            cands = measure.LAST.get(op, ())
            print(f"[phase 24 a] {key}: {ent['config']} best_ms "
                  f"{ent['best_ms']} default ms "
                  f"{'n/a' if base is None else round(base, 4)} over "
                  f"{len(cands)} candidates ("
                  + ", ".join(f"{'/'.join(str(v) for v in c.values())} "
                              f"{ms:.4f}" for c, ms in cands)
                  + f") on {card}", flush=True)
            rows[f"{key} best_ms / default ms"] = (
                ent["best_ms"], None if base is None else round(base, 4))

        t0 = time.perf_counter()
        tune_consult(torch, card, report)
        print(f"[phase 24 a] {len(measured)} keys measured in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        with open(tuning.cache_path(), "rb") as f:
            blob = f.read()
        # (b) cached: the same consultations replay every decision, time
        # nothing and leave the file's bytes as they were
        tuning.reset()
        tuning.set_mode("cached")
        measure.LAST.clear()
        replayed = {}

        def replay(op, key, default):
            replayed[key] = tuning.annotation()["decisions"].get(key)

        tune_consult(torch, card, replay)
        with open(tuning.cache_path(), "rb") as f:
            same = f.read() == blob
        bad = {k: v for k, v in replayed.items()
               if not isinstance(v, dict) or v.get("source") != "cached"
               or {kk: vv for kk, vv in v.items() if kk != "source"}
               != measured[k]["config"]}
        print(f"[phase 24 b] cached: {len(replayed)} decisions replayed, "
              f"{len(measure.LAST)} timed, file unchanged {same}",
              flush=True)
        if bad or measure.LAST or not same:
            fail(f"[phase 24 b] cached replay: {bad}, timed "
                 f"{list(measure.LAST)}, file unchanged {same}")
        tuned_bn_check(torch, card)
        int8_check(torch, card)
        _free(torch)
        # (c)-(e)
        rows.update(tune_serve_run(torch, card))
        perf_rows, counts = tune_perf_runs(torch, card)
        rows.update(perf_rows)
        tuning.set_mode("off")
        launches = untied_serve_run(torch, card)
    finally:
        tuning.reset()
        c2d.reset_conv_pass_layouts()
        os.environ.pop("BIGDL_TPU_AUTOTUNE_CACHE", None)
    print(f"[phase 24] {time.perf_counter() - t_phase:.1f}s", flush=True)
    return rows, counts, launches


# phase 25: recovery on the main path. (a) the supervised ResNet-50 _fba
# run: 8 seeded batches, 16 steps, 4 a dispatch, a checkpoint every 4, and
# the plan below (attempts resume at iterations 0, 4, 4 and 8 and run 8,
# 4, 4 and 8 steps); (b) the CIFAR CLI killed twice by os._exit; (c)
# file:// and DCP snapshots; (d) the CIFAR CLI at 4 gloo ranks losing
# rank 3 before step RECOVERY_KILL_STEP; (e) cli.perf -m resnet50_fba the
# same way
RECOVERY_BATCHES, RECOVERY_STEPS, RECOVERY_K = 8, 16, 4
RECOVERY_PLAN = ("stall@data:3:0.01;corrupt@ckpt_save:4;dispatch@step:3;"
                 "io@ckpt_save:5;preempt_soft@step:6")
RECOVERY_RESUMES = [0, 4, 4, 8]       # each attempt's resumed iteration
RECOVERY_ATTEMPT_STEPS = [8, 4, 4, 8]  # and the steps it ran
RECOVERY_PEAK_RATIO = 1.1
SNAPSHOT_PLAN = "preempt_soft@step:3"  # (c): resume at 8
# (b): the first child's plan, the second's (its state.20 write), none
KILL_PLANS = ["preempt@step:6;preempt@ckpt_save:4", "preempt@ckpt_save:2",
              ""]
KILL_EPOCHS = 2
# (d) and (e)
ELASTIC_RANKS = 4
# the CIFAR CLI at 77 records a training file: 3 iterations an epoch, a
# checkpoint at 3 and 6, rank 3 lost before step 5, steps 4-6 at 3 ranks
ELASTIC_RECORDS, ELASTIC_EPOCH_ITERS, RECOVERY_KILL_STEP = 77, 3, 5
ELASTIC_LR = "0.005"  # random labels: a larger rate makes the run chaotic
ELASTIC_BATCH = {"hold": 129, "scale": 126}  # 128 at 3 ranks
ELASTIC_WORKER = "chip_smoke:elastic_worker"
PERF_ELASTIC_WORKER = "chip_smoke:perf_elastic_worker"
PERF_ELASTIC_MODEL = "resnet50_fba"
PERF_ELASTIC_BATCH, PERF_ELASTIC_ITERS = 32, 3
CIFAR_BNS = 19  # resnet_cifar(20)'s BN layers
# ["--platform", "cpu"] to rehearse (b), (d) and (e) on the CPU
RECOVERY_PLATFORM = []


def recovery_opt(torch, make_model, data, ckpt, recs, dtype=None,
                 sharded=False):
    """The Optimizer of phase 25 (a) and (c): ``optimizer_run``'s recipe
    (SGD momentum, Poly(0.5, POLY_ITERS)) over ``data`` shuffled each
    epoch, ``RECOVERY_K`` steps a dispatch up to ``RECOVERY_STEPS``, a
    checkpoint every ``RECOVERY_K`` iterations into ``ckpt``; its
    LossRecorder is appended to ``recs``."""
    import numpy as np

    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Poly, Trigger

    x = np.concatenate([b[0] for b in data])
    y = np.concatenate([b[1] for b in data])
    rec = LossRecorder(torch, ClassNLLCriterion(), RECOVERY_STEPS, DEV)
    recs.append(rec)
    opt = Optimizer(make_model(), BatchDataSet(x, y, len(data[0][0]),
                                               shuffle=True), rec,
                    optim_method=SGD(0.01, momentum=0.9,
                                     schedule=Poly(0.5, POLY_ITERS)),
                    end_when=Trigger.max_iteration(RECOVERY_STEPS),
                    log_every=1, compute_dtype=dtype,
                    steps_per_dispatch=RECOVERY_K, device=DEV)
    opt.set_checkpoint(Trigger.several_iteration(RECOVERY_K), ckpt,
                       sharded=sharded)
    return opt


def supervised_recovery(torch, tag, make_model, data, plan, ckpt,
                        dtype=None, sharded=False):
    """A fault-free run, then ``cli.common.run_optimize`` under
    ``--supervise`` with ``plan`` installed. Returns (the fault-free
    losses, its final parameters, the supervised result, the attempts:
    [{"resume", "losses", "launches", "peak_gib"}], the supervisor's
    annotation, the injected events)."""
    import tempfile
    from types import SimpleNamespace

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.resilience import faults

    with tempfile.TemporaryDirectory() as ref_ck:
        recs = []
        full_opt = recovery_opt(torch, make_model, data, ref_ck, recs, dtype,
                                sharded)
        trained = full_opt.optimize()
        full = recs[0].losses()
        ref_params = {k: v.detach().clone()
                      for k, v in trained.params.items()}
        del full_opt, trained
    _free(torch)
    recs, attempts = [], []

    def close_attempt():
        torch.cuda.synchronize()
        attempts.append({"launches": ops.kernel_launches(),
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30})

    def make():
        if recs:
            close_attempt()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        return recovery_opt(torch, make_model, data, ckpt, recs, dtype,
                            sharded)

    print(f"[phase 25 {tag}] fault plan: {plan}", flush=True)
    sups = []
    from bigdl_tpu_torch.resilience import supervisor as sup_mod

    class Recorded(sup_mod.Supervisor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sups.append(self)

    saved = sup_mod.Supervisor
    sup_mod.Supervisor = Recorded
    faults.install_plan(faults.parse_plan(plan))
    t0 = time.perf_counter()
    try:
        with LogLines() as lines:
            result = common.run_optimize(make, SimpleNamespace(
                supervise=5, checkpoint=ckpt, seed=0))
            close_attempt()
        events = faults.injected_events()
        ann = sups[-1].annotation()  # with the injector's events
    finally:
        faults.clear_plan()
        sup_mod.Supervisor = saved
    wall = time.perf_counter() - t0
    resumes = [0] + [int(m.group(1)) for m in (
        re.search(r"Resuming at epoch \d+, iteration (\d+)", ln)
        for ln in lines) if m]
    for a, rec, r in zip(attempts, recs, resumes):
        a.update(resume=r, losses=rec.losses())
    retries = [e for e in sups[-1].events if e.get("event") == "retry"]
    return full, ref_params, result, attempts, ann, events, wall, retries


def check_recovery(tag, full, ref_params, result, attempts, want_resumes):
    """Each attempt's losses are the fault-free run's at its steps, and
    the final parameters are the fault-free run's, bit for bit."""
    import torch

    if [a["resume"] for a in attempts] != want_resumes:
        fail(f"[phase 25 {tag}] attempts resumed at "
             f"{[a['resume'] for a in attempts]}, expected {want_resumes}")
    for i, a in enumerate(attempts):
        r, got = a["resume"], a["losses"]
        if got != full[r:r + len(got)]:
            fail(f"[phase 25 {tag}] attempt {i + 1} (resumed at {r}) "
                 f"losses {got} differ from the fault-free run's "
                 f"{full[r:r + len(got)]}")
    if attempts[-1]["resume"] + len(attempts[-1]["losses"]) != len(full):
        fail(f"[phase 25 {tag}] the last attempt ended at "
             f"{attempts[-1]['resume'] + len(attempts[-1]['losses'])} steps"
             f", the fault-free run at {len(full)}")
    got = result.params
    bad = [k for k in ref_params
           if not torch.equal(got[k].cpu(), ref_params[k].cpu())]
    if sorted(got) != sorted(ref_params) or bad:
        fail(f"[phase 25 {tag}] final parameters differ from the "
             f"fault-free run's: {bad[:5]}")


def recovery_main_path(torch, card):
    """Phase 25 (a); returns (rows, the launches of every attempt)."""
    import tempfile

    from bigdl_tpu_torch.cli import perf

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    make = lambda: perf.build_model("resnet50_fba",  # noqa: E731
                                    generator=gen())[0]
    data = image_batches(RECOVERY_BATCHES, RESNET_BATCH, (224, 224, 3),
                         1000, 25)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as ck:
            (full, ref_params, result, attempts, ann, events, wall,
             retries) = supervised_recovery(torch, "a", make, data,
                                            RECOVERY_PLAN, ck,
                                            torch.bfloat16)
    finally:
        torch.backends.cudnn.deterministic = det
    check_recovery("a", full, ref_params, result, attempts,
                   RECOVERY_RESUMES)
    kinds = sorted({e["fault"] for e in events})
    named = sorted({e["fault"] for e in ann["events"] if "fault" in e})
    print(f"[phase 25 a] resnet50_fba bf16 batch {RESNET_BATCH}, "
          f"{RECOVERY_K} steps a dispatch, supervised on {card}: "
          f"{len(attempts)} attempts resumed at "
          f"{[a['resume'] for a in attempts]}, steps "
          f"{[len(a['losses']) for a in attempts]}, {ann['retries']} "
          f"retries (backoff s {[e['backoff_s'] for e in retries]}), "
          f"{wall:.1f}s for the supervised run; peak memory GiB a attempt "
          f"{[round(a['peak_gib'], 2) for a in attempts]}; faults fired "
          f"{[(e['fault'], e['site'], e['visit']) for e in events]}; "
          f"losses and final parameters equal to the fault-free run's",
          flush=True)
    want_kinds = ["corrupt", "dispatch", "io", "preempt_soft", "stall"]
    if kinds != want_kinds or named != want_kinds:
        fail(f"[phase 25 a] faults fired {kinds}, named by the supervisor "
             f"{named}, expected {want_kinds}")
    for i, (a, steps) in enumerate(zip(attempts, RECOVERY_ATTEMPT_STEPS)):
        n = a["launches"]
        want = dict({k: 0 for k in n}, bn_fwd_apply=53 * steps,
                    bn_bwd_fused=53 * steps)
        if len(a["losses"]) != steps or n != want:
            fail(f"[phase 25 a] attempt {i + 1}: {len(a['losses'])} steps "
                 f"and launches {n}, expected {steps} steps and {want}")
    if attempts[-1]["peak_gib"] > RECOVERY_PEAK_RATIO * \
            attempts[0]["peak_gib"]:
        fail(f"[phase 25 a] the last attempt's peak memory "
             f"{attempts[-1]['peak_gib']:.2f} GiB exceeds "
             f"{RECOVERY_PEAK_RATIO}x the first's "
             f"{attempts[0]['peak_gib']:.2f} GiB")
    rows = {"(a) retries": ann["retries"],
            "(a) supervised run s": round(wall, 1),
            "(a) peak GiB by attempt": [round(a["peak_gib"], 2)
                                        for a in attempts]}
    return rows, [a["launches"] for a in attempts]


# the CLI children of (b) run cuDNN deterministic, as this process's
# bit-for-bit phases do
CLI_CHILD = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
             "torch.backends.cuda.matmul.allow_tf32 = False; "
             "torch.backends.cudnn.allow_tf32 = False; "
             "from bigdl_tpu_torch.cli import resnet; "
             "resnet.main(sys.argv[1:])")


def _kill_children(tmp, state):
    """Phase 25 (b)'s CLI child processes (run on a thread beside (a), (c)
    and (d): they only start processes and wait): the uninterrupted
    child, then ``supervise_command`` around the killed ones. Fills
    ``state``; checks nothing."""
    from bigdl_tpu_torch.resilience.supervisor import (RetryPolicy,
                                                       supervise_command)

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    log = os.path.join(tmp, "faults.jsonl")

    def argv(ck, plan):
        out = [sys.executable, "-c", CLI_CHILD, "train", "--dataset",
               "cifar10", "-f", tmp, "--fusedBN", "apply", "-b",
               str(CIFAR_BATCH), "--maxEpoch", str(KILL_EPOCHS),
               "--logEvery", "1", "--stepsPerDispatch", str(OPT_K),
               "--checkpoint", ck, "--model", ck, "--supervise"]
        out += RECOVERY_PLATFORM
        return out + (["--faultPlan", plan] if plan else [])

    t0 = time.perf_counter()
    state["ref"] = subprocess.run(argv(os.path.join(tmp, "ck_ref"), ""),
                                  capture_output=True, text=True, env=env,
                                  cwd=here, timeout=600)
    state["t_ref"] = time.perf_counter() - t0

    def make_argv(attempt):
        plan = KILL_PLANS[min(attempt, len(KILL_PLANS) - 1)]
        print(f"[phase 25 b] child {attempt + 1}: --faultPlan {plan!r}",
              flush=True)
        return argv(os.path.join(tmp, "ck"), plan)

    t0 = time.perf_counter()
    state["rc"], state["events"] = supervise_command(
        make_argv, policy=RetryPolicy(budget=4, base_s=0.05, max_s=0.5),
        env=dict(env, BIGDL_FAULT_LOG=log), cwd=here)
    state["t_sup"] = time.perf_counter() - t0


def _chaos_child(tmp, state):
    """``tools.chaos_run --kills 2 --kill-in-ckpt`` on the card (a second
    thread beside :func:`_kill_children`). Fills ``state``."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    state["chaos"] = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.tools.chaos_run",
         "--kills", "2", "--kill-in-ckpt", "--workdir",
         os.path.join(tmp, "chaos")] + RECOVERY_PLATFORM,
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=here),
        cwd=here, timeout=600)
    state["t_chaos"] = time.perf_counter() - t0


def process_kill_start():
    """Phase 25 (b), started: seeded CIFAR files in a fresh directory,
    ``_kill_children`` and ``_chaos_child`` on two threads. Returns the
    handle that :func:`process_kill_finish` takes."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="phase25b_")
    write_cifar(tmp, CIFAR_RECORDS)
    state = {}

    def guarded(fn):
        def run():
            try:
                fn(tmp, state)
            except BaseException as e:  # reported by process_kill_finish
                state["error"] = repr(e)
        return run

    threads = [threading.Thread(target=guarded(fn), daemon=True)
               for fn in (_kill_children, _chaos_child)]
    for t in threads:
        t.start()
    return threads, tmp, state


def process_kill_finish(torch, card, handle):
    """Phase 25 (b): ``supervise_command`` around the CIFAR training CLI
    under ``--supervise --faultPlan`` (KILL_PLANS), each child resuming
    from ``--checkpoint`` (``--model`` the same directory): two children
    die with exit code 75, the final ``model.<n>`` equals an uninterrupted
    child's bit for bit, the fault log lists both kills, and ``cli.resnet
    test`` of the directory prints the uninterrupted run's last top-1
    line; ``tools.chaos_run --kills 2 --kill-in-ckpt`` on the card says
    equal. Waits for :func:`process_kill_start`'s thread. Returns rows."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from bigdl_tpu_torch.cli import resnet as resnet_cli
    from bigdl_tpu_torch.resilience import PREEMPT_RC
    from bigdl_tpu_torch.utils.file import load_leaves

    threads, tmp, st = handle
    for t in threads:
        t.join()
    try:
        if "error" in st:
            fail(f"[phase 25 b] the children's thread raised {st['error']}")
        ref = st["ref"]
        if ref.returncode != 0:
            fail(f"[phase 25 b] the uninterrupted child exited "
                 f"{ref.returncode}: {ref.stderr[-2000:]}")
        rc, events = st["rc"], st["events"]
        codes = [e.get("rc") for e in events if "rc" in e]
        with open(os.path.join(tmp, "faults.jsonl")) as f:
            kills = [json.loads(ln) for ln in f if ln.strip()]
        last = f"model.{KILL_EPOCHS * 10}"
        a, _ = load_leaves(os.path.join(tmp, "ck_ref", last))
        b, _ = load_leaves(os.path.join(tmp, "ck", last))
        equal = len(a) == len(b) and all(np.array_equal(u, v)
                                         for u, v in zip(a, b))
        top1_ref = [ln for ln in (ref.stdout + ref.stderr).splitlines()
                    if "top1 accuracy is " in ln]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resnet_cli.main(["test", "-f", tmp, "--model",
                             os.path.join(tmp, "ck"), "-b",
                             str(CIFAR_BATCH)] + RECOVERY_PLATFORM)
        tested = [ln for ln in out.getvalue().splitlines()
                  if ln.startswith("top1 accuracy is ")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    restarts = sum(1 for e in events if e.get("event") == "restart")
    print(f"[phase 25 b] the CIFAR CLI on {card}: uninterrupted child "
          f"{st['t_ref']:.1f}s; supervised children {st['t_sup']:.1f}s, rc "
          f"{rc}, {restarts} restarts, exits {codes}; fault log "
          f"{[(k['fault'], k['site'], k['visit']) for k in kills]}; "
          f"{last} equal to the uninterrupted run's: {equal}; test "
          f"{tested[-1:]} vs the uninterrupted run's "
          f"{top1_ref[-1].split(' - ')[-1] if top1_ref else None}",
          flush=True)
    if rc != 0 or restarts != 2 or [k["fault"] for k in kills] != [
            "preempt", "preempt"] or sorted(k["site"] for k in kills) != [
            "ckpt_save", "step"]:
        fail(f"[phase 25 b] rc {rc}, {restarts} restarts, fault log {kills}"
             f" (two preempts, at step and ckpt_save, expected; the child "
             f"exit code of a preemption is {PREEMPT_RC})")
    if not equal:
        fail(f"[phase 25 b] the supervised {last} differs from the "
             f"uninterrupted run's")
    if not tested or not top1_ref or not top1_ref[-1].endswith(tested[-1]):
        fail(f"[phase 25 b] test prints {tested[-1:]}, the uninterrupted "
             f"run's last validation {top1_ref[-1:]}")
    ch = st["chaos"]
    line = [ln for ln in ch.stdout.splitlines() if ln.startswith("{")]
    res = json.loads(line[-1]) if line else {}
    print(f"[phase 25 b] tools.chaos_run --kills 2 --kill-in-ckpt on "
          f"{card}: rc {ch.returncode}, {st['t_chaos']:.1f}s, equal "
          f"{res.get('equal')}, kills {res.get('kills')}, restarts "
          f"{res.get('restarts')}", flush=True)
    if ch.returncode != 0 or res.get("equal") is not True:
        fail(f"[phase 25 b] chaos_run: {ch.stdout[-1500:]} "
             f"{ch.stderr[-1500:]}")
    return {"(b) uninterrupted child s": round(st["t_ref"], 1),
            "(b) two kills, supervised children s": round(st["t_sup"], 1),
            "(b) chaos_run s": round(st["t_chaos"], 1)}


def snapshot_runs(torch, card):
    """Phase 25 (c): (a)'s check for ``resnet_cifar(20)`` f32 ``--fusedBN
    apply`` under SNAPSHOT_PLAN, its snapshots once on a ``file://`` path
    and once as DCP directories; then ``cli.serve.build_app`` of
    ``resnet20_cifar --classes 10`` with ``--model`` the DCP directory,
    whose ``/predict`` scores equal the eager forward of the trained
    weights. Returns (rows, launches)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import models
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import make_server
    from bigdl_tpu_torch.utils.orbax_ckpt import is_sharded

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    make = lambda: models.resnet_cifar(20, 10, fused_bn="apply",  # noqa
                                       generator=gen())
    data = image_batches(RECOVERY_BATCHES, CIFAR_BATCH, (32, 32, 3), 10, 26)
    rows, launches = {}, []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="phase25c_") as tmp:
            for tag, ck, sharded in (
                    ("file://", "file://" + os.path.join(tmp, "ck"), False),
                    ("DCP", os.path.join(tmp, "dcp"), True)):
                (full, ref_params, result, attempts, ann, events, wall,
                 _) = supervised_recovery(torch, f"c {tag}", make, data,
                                          SNAPSHOT_PLAN, ck, sharded=sharded)
                check_recovery(f"c {tag}", full, ref_params, result,
                               attempts, [0, 8])
                launches += [a["launches"] for a in attempts]
                print(f"[phase 25 c] resnet_cifar(20) f32 --fusedBN apply, "
                      f"{tag} snapshots ({ck}) on {card}: resumed at "
                      f"{[a['resume'] for a in attempts]}, losses and final "
                      f"parameters equal to the fault-free run's; "
                      f"{wall:.1f}s", flush=True)
                rows[f"(c) {tag} supervised run s"] = round(wall, 1)
            dcp = os.path.join(tmp, "dcp")
            newest = os.path.join(dcp, f"model.{RECOVERY_STEPS}")
            if not is_sharded(newest):
                fail(f"[phase 25 c] {newest} is not a DCP snapshot")
            trained = result.module.eval()
            app, engine, in_shape, _ = serve_cli.build_app(
                serve_cli.build_parser().parse_args(
                    ["resnet20_cifar", "--classes", "10", "--fusedBN",
                     "apply", "--model", dcp, "--port", "0"]))
            srv = make_server(app, "127.0.0.1", 0)
            thr = threading.Thread(target=srv.serve_forever, daemon=True)
            thr.start()
            try:
                rs = np.random.RandomState(25)
                x = np.round(rs.randn(3, *in_shape), 2).astype(np.float32)
                st, out = _post(srv.server_address[1], "/predict",
                                {"inputs": x.tolist(),
                                 "return_scores": True})
                with torch.no_grad():
                    ref = trained(torch.from_numpy(x).to(DEV)).float() \
                        .cpu().numpy()
            finally:
                stop_server(app, srv, thr)
    finally:
        torch.backends.cudnn.deterministic = det
    if st != 200:
        fail(f"[phase 25 c] /predict from the DCP snapshot answered {st}: "
             f"{str(out)[:200]}")
    got = np.asarray(out["scores"], np.float32)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[phase 25 c] serve resnet20_cifar --model <DCP directory>: "
          f"/predict of 3 images 200, scores vs the eager forward of the "
          f"trained weights max|d|/max|ref| {err:.2e} (tolerance "
          f"{LOGIT_TOL['float32']})", flush=True)
    if err > LOGIT_TOL["float32"]:
        fail(f"[phase 25 c] served scores differ from the trained "
             f"weights' eager forward by {err}")
    del app, engine, trained, result
    _free(torch)
    return rows, launches


def elastic_worker(args):
    """Phase 25 (d) on one rank of a 4-rank gloo job on the one card (the
    ``parallel.launch.spawn`` target): ``cli.resnet train ... --strategy
    dp --elastic POLICY`` with each of ``args["argvs"]`` in turn, each
    attempt's losses into the summary ``args["dir"]/sum_r<rank>``;
    returns a list with, for each run, its give-up message, or the
    ranks each attempt built at, the final rank count, the reshapes and
    the launches of the last attempt. A rank lost to a re-formation
    leaves the job (exit code 0)."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.cli import resnet as resnet_cli
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.resilience import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    rank = dist.get_rank()
    sups, builds = [], []

    class Recorded(elastic.ElasticSupervisor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sups.append(self)

    elastic.ElasticSupervisor = Recorded
    build = common.build_optimizer

    def recorded_build(*a, **kw):
        opt = build(*a, **kw)
        opt.set_summary(os.path.join(args["dir"], f"sum_r{rank}"))
        builds.append(opt.strategy.world)
        ops.reset_kernel_launches()  # the attempt's own launches
        return opt

    common.build_optimizer = recorded_build
    from bigdl_tpu_torch.resilience import faults
    out = []
    for argv in args["argvs"]:
        sups.clear()
        builds.clear()
        try:
            resnet_cli.main(argv)
        except SystemExit as e:
            if e.code in (0, None):
                raise  # a rank lost to the re-formation leaves the job
            out.append({"rank": rank, "exit": str(e.code)})
            faults.clear_plan()  # the next run starts with every rank
            continue
        torch.cuda.synchronize()
        out.append({"rank": rank, "builds": list(builds),
                    "world": common._world(), "reshapes": sups[-1].reshapes,
                    "launches": ops.kernel_launches()})
    return out


class FitRows:
    """A training dataset whose batches are fitted (padded or trimmed) as
    an ``ElasticDataParallel`` of ``ranks`` ranks fits its global batch:
    one process's view of the re-formed job's batches."""

    def __init__(self, inner, policy, ranks):
        from bigdl_tpu_torch.parallel.mesh import Mesh
        from bigdl_tpu_torch.resilience.elastic import ElasticDataParallel

        self.inner = inner
        self._dp = ElasticDataParallel(Mesh("data", ranks, 0),
                                       batch_policy=policy)

    def __iter__(self):
        import numpy as np

        for x, y in self.inner:
            yield (self._dp._fit_rows(np.asarray(x)),
                   self._dp._fit_rows(np.asarray(y)))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _summary_losses(d):
    """{iteration: loss} of a summary's train.jsonl, the last row of each
    iteration winning."""
    out = {}
    with open(os.path.join(d, "train.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out[r["iteration"]] = r["loss"]
    return out


def elastic_cli_runs(torch, card):
    """Phase 25 (d): the CIFAR CLI at 4 gloo ranks sharing the card,
    ``--elastic hold`` and then ``scale``, losing rank 3 before step
    RECOVERY_KILL_STEP; then ``--minDevices 4``, which gives up. Returns
    (rows, launches of the ranks' last attempts)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.cli import common
    from bigdl_tpu_torch.cli import resnet as resnet_cli
    from bigdl_tpu_torch.parallel.launch import spawn

    rows, launches = {}, []
    with tempfile.TemporaryDirectory(prefix="phase25d_") as tmp:
        write_cifar(tmp, CIFAR_BATCH)  # the test split: one batch
        for i in range(1, 6):  # the training files: ELASTIC_RECORDS each
            os.truncate(os.path.join(tmp, f"data_batch_{i}.bin"),
                        ELASTIC_RECORDS * 3073)
        # the hold job first runs --minDevices 4, which gives up on every
        # rank (all stay), then the elastic run
        min_argv = ["train", "--dataset", "cifar10", "-f", tmp,
                    "--fusedBN", "apply", "-b", str(CIFAR_BATCH),
                    "--maxEpoch", "2", "--strategy", "dp", "--elastic",
                    "hold", "--minDevices", str(ELASTIC_RANKS),
                    "--checkpoint", os.path.join(tmp, "ck_min"),
                    "--faultPlan", f"kill_device@step:{RECOVERY_KILL_STEP}:1"
                    ] + RECOVERY_PLATFORM
        for policy in ("hold", "scale"):
            ck = os.path.join(tmp, f"ck_{policy}")
            work = os.path.join(tmp, policy)
            os.makedirs(work)
            argv = ["train", "--dataset", "cifar10", "-f", tmp, "--fusedBN",
                    "apply", "-b", str(CIFAR_BATCH), "--maxEpoch", "2",
                    "--learningRate", ELASTIC_LR,
                    "--logEvery", "1", "--strategy", "dp", "--elastic",
                    policy, "--checkpoint", ck, "--faultPlan",
                    f"kill_device@step:{RECOVERY_KILL_STEP}:1"
                    ] + RECOVERY_PLATFORM
            argvs = ([min_argv] if policy == "hold" else []) + [argv]
            t0 = time.perf_counter()
            try:
                job = spawn(ELASTIC_WORKER, ELASTIC_RANKS,
                            {"argvs": argvs, "dir": work},
                            timeout_s=DP_TIMEOUT_S, backend="gloo")
            except (RuntimeError, TimeoutError) as e:
                fail(f"[phase 25 d {policy}] the 4-rank job failed: {e}")
            wall = time.perf_counter() - t0
            if policy == "hold":
                # (the lost rank's list is gone with it)
                gave_up = [r[0].get("exit") for r in job if r is not None]
                print(f"[phase 25 d] --minDevices {ELASTIC_RANKS}: every "
                      f"rank exits with {gave_up[0]!r}", flush=True)
                if len(gave_up) != ELASTIC_RANKS - 1 or not all(
                        e and e.startswith(
                        f"elastic: {ELASTIC_RANKS - 1} healthy device(s) < "
                        f"--minDevices {ELASTIC_RANKS}") for e in gave_up):
                    fail(f"[phase 25 d] --minDevices {ELASTIC_RANKS} gave "
                         f"{gave_up}")
            res = [r and r[-1] for r in job]
            # one process on the same fitted global batches, resumed from
            # the pair the re-formed job resumed from
            ref_in = os.path.join(tmp, f"ref_in_{policy}")
            os.makedirs(ref_in)
            resumed = ((RECOVERY_KILL_STEP - 1) // ELASTIC_EPOCH_ITERS
                       * ELASTIC_EPOCH_ITERS)
            for f in os.listdir(ck):
                if f.split(".")[1] == str(resumed):
                    shutil.copy(os.path.join(ck, f), ref_in)
            split, build = resnet_cli._one_split, common.build_optimizer
            resnet_cli._one_split = lambda f, b, train, aug: (
                FitRows(split(f, b, train, aug), policy, ELASTIC_RANKS - 1)
                if train else split(f, b, train, aug))

            def recorded_build(*a, **kw):
                opt = build(*a, **kw)
                opt.set_summary(os.path.join(tmp, f"ref_sum_{policy}"))
                return opt

            common.build_optimizer = recorded_build
            try:
                resnet_cli.main(["train", "--dataset", "cifar10", "-f", tmp,
                                 "--fusedBN", "apply", "-b",
                                 str(CIFAR_BATCH), "--maxEpoch", "2",
                                 "--learningRate", ELASTIC_LR,
                                 "--logEvery", "1", "--model", ref_in,
                                 "--checkpoint",
                                 os.path.join(tmp, f"ref_ck_{policy}")]
                                + RECOVERY_PLATFORM)
            finally:
                resnet_cli._one_split, common.build_optimizer = split, build
            ref = _summary_losses(os.path.join(tmp, f"ref_sum_{policy}"))
            got = _summary_losses(os.path.join(work, "sum_r0"))
            after = [i for i in sorted(ref) if i > resumed]
            d = max(abs(got[i] - ref[i]) for i in after)
            lost = [r for r in range(ELASTIC_RANKS) if res[r] is None]
            ok = [r for r in res if r is not None]
            ev = ok[0]["reshapes"][0] if ok and ok[0]["reshapes"] else {}
            steps = len(after)
            print(f"[phase 25 d {policy}] cli.resnet cifar10 --strategy dp "
                  f"--elastic {policy} global batch {CIFAR_BATCH} "
                  f"({ELASTIC_BATCH[policy]} at {ELASTIC_RANKS - 1} ranks), "
                  f"{ELASTIC_RANKS} gloo ranks on {card}: {wall:.1f}s for "
                  f"the job; rank(s) {lost} left with exit code 0; ranks "
                  f"built at {ok[0]['builds'] if ok else None} and ended at "
                  f"{[r['world'] for r in ok]}; reshape {ev}; losses after "
                  f"the reshape (iterations {after[0]}-{after[-1]}) vs one "
                  f"process on the same batches max|d| {d:.3g} (tolerance "
                  f"{DP_CIFAR_TOL['loss']}); launches a rank "
                  f"{[{k: v for k, v in r['launches'].items() if v} for r in ok]}",
                  flush=True)
            if lost != [ELASTIC_RANKS - 1] or len(ok) != ELASTIC_RANKS - 1 \
                    or any(r["world"] != ELASTIC_RANKS - 1 for r in ok):
                fail(f"[phase 25 d {policy}] lost {lost}, ended at "
                     f"{[r['world'] for r in ok]}")
            if (ev.get("from_devices"), ev.get("to_devices")) != (
                    ELASTIC_RANKS, ELASTIC_RANKS - 1) or \
                    ev.get("restore_ms") is None or \
                    ev.get("bucket_bytes_before") is None or \
                    ev.get("bucket_bytes_after") is None:
                fail(f"[phase 25 d {policy}] reshape event {ev}")
            for r in ok:
                n = r["launches"]
                want = dict({k: 0 for k in n}, bn_stats=CIFAR_BNS * steps,
                            bn_bwd_stats=CIFAR_BNS * steps)
                if n != want:
                    fail(f"[phase 25 d {policy}] rank {r['rank']} launched "
                         f"{n} after the reshape, expected {want}")
                launches.append(n)
            if d > DP_CIFAR_TOL["loss"]:
                fail(f"[phase 25 d {policy}] losses after the reshape "
                     f"{[got[i] for i in after]} vs one process "
                     f"{[ref[i] for i in after]}")
            rows[f"(d) {policy} job s"] = round(wall, 1)
            rows[f"(d) {policy} restore ms"] = ev.get("restore_ms")
    return rows, launches


def perf_elastic_worker(args):
    """Phase 25 (e) on one rank of a 4-rank gloo job: ``cli.perf`` with
    each of ``args["argvs"]`` in turn; returns, for each, its line, its
    losses and the launches of its last attempt (the counts set to 0 as
    each attempt builds its step). A rank lost to a re-formation leaves
    the job (exit code 0)."""
    import torch

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    step = perf.train_step

    def counted(*a, **kw):
        ops.reset_kernel_launches()
        return step(*a, **kw)

    perf.train_step = counted
    runs = []
    for argv in args["argvs"]:
        out = perf.main(argv)  # a lost rank's SystemExit(0) leaves the job
        torch.cuda.synchronize()
        runs.append(dict(out, launches=ops.kernel_launches()))
    return runs


def elastic_perf_start(after):
    """Phase 25 (e), started on a thread once the threads ``after`` ((b)'s)
    have ended: ``cli.perf -m resnet50_fba --strategy dp`` at 4 gloo ranks
    on the card, global batch PERF_ELASTIC_BATCH, in one job: without a
    fault, then ``--elastic hold`` with ``kill_device@step:3:1``. It runs
    beside (c) and (d), whose checks its load cannot change, as its own
    cannot be (the reshape, launches, finite losses); its images/s are
    taken under their load. Returns the handle :func:`elastic_perf_runs`
    takes."""
    from bigdl_tpu_torch.parallel.launch import spawn

    base = ["-m", PERF_ELASTIC_MODEL, "-b", str(PERF_ELASTIC_BATCH), "-i",
            str(PERF_ELASTIC_ITERS), "--strategy", "dp", "--dataType",
            "random"] + RECOVERY_PLATFORM
    state = {}

    def run():
        for t in after:
            t.join()
        t0 = time.perf_counter()
        try:
            state["job"] = spawn(
                PERF_ELASTIC_WORKER, ELASTIC_RANKS,
                {"argvs": [base, base + ["--elastic", "hold", "--faultPlan",
                                         "kill_device@step:3:1"]]},
                timeout_s=DP_TIMEOUT_S, backend="gloo")
        except BaseException as e:  # reported by elastic_perf_runs
            state["error"] = repr(e)
        state["wall"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, state


def elastic_perf_runs(torch, card, handle):
    """Phase 25 (e), waited for and checked. Returns (rows, launches)."""
    import math

    th, state = handle
    th.join()
    if "error" in state:
        fail(f"[phase 25 e] the 4-rank job failed: {state['error']}")
    job, wall = state["job"], state["wall"]
    before = job[0][0]
    res = [r and r[-1] for r in job]
    line = res[0]
    steps = line.get("warmup", 0) + line.get("iterations", 0)
    ok = [r for r in res if r is not None]
    print(f"[phase 25 e] cli.perf -m resnet50_fba --strategy dp global batch "
          f"{PERF_ELASTIC_BATCH} on {card} ({wall:.1f}s for the job): 4 gloo"
          f" ranks {before['records_per_second']} images/s; --elastic hold "
          f"with kill_device@step:3:1: {line.get('n_devices')} ranks, "
          f"{line.get('records_per_second')} images/s after the reshape, "
          f"reshape {line.get('reshape')}, "
          f"elastic {line.get('elastic')}, supervisor retries "
          f"{(line.get('supervisor') or {}).get('retries')}, losses "
          f"{[round(v, 4) for v in line.get('losses', [])]}", flush=True)
    rs = line.get("reshape") or {}
    if (rs.get("from_devices"), rs.get("to_devices")) != (
            ELASTIC_RANKS, ELASTIC_RANKS - 1) or "supervisor" not in line \
            or job[ELASTIC_RANKS - 1] is not None:
        fail(f"[phase 25 e] line {line}")
    if not all(math.isfinite(v) for r in ok for v in r["losses"]):
        fail(f"[phase 25 e] losses {[r['losses'] for r in ok]}")
    for r in ok:
        n = r["launches"]
        want = dict({k: 0 for k in n}, bn_stats=53 * steps,
                    bn_bwd_stats=53 * steps)
        if n != want:
            fail(f"[phase 25 e] a rank launched {n}, expected {want}")
    rows = {"(e) job s": round(wall, 1),
            "(e) 4 ranks images/s": before["records_per_second"],
            "(e) 3 ranks after the reshape images/s":
                line["records_per_second"],
            "(e) reshape restore ms": rs.get("restore_ms")}
    return rows, [r["launches"] for r in ok]


def recovery_runs(torch, card):
    """Phase 25: recovery on the main path; (b)'s child processes run on a
    thread beside (a), (c) and (d), whose checks their load on the card
    and the host cannot change (bits, launches, per-process memory), and
    (e)'s job follows them on that thread. Returns (rows, launches)."""
    t_phase = time.perf_counter()
    rows, launches = {}, []
    kills = process_kill_start()
    perf_e = elastic_perf_start(kills[0])
    for tag, run in (
            ("(a)", lambda: recovery_main_path(torch, card)),
            ("(c)", lambda: snapshot_runs(torch, card)),
            ("(d)", lambda: elastic_cli_runs(torch, card)),
            ("(b) after (a), (c), (d)",
             lambda: (process_kill_finish(torch, card, kills), [])),
            ("(e)", lambda: elastic_perf_runs(torch, card, perf_e))):
        t0 = time.perf_counter()
        r, n = run()
        rows.update(r)
        launches += n
        rows[f"{tag} s"] = round(time.perf_counter() - t0, 1)
        _free(torch)
    rows["phase 25 s"] = round(time.perf_counter() - t_phase, 1)
    return rows, launches


# ------------------------------------------------------------------ phase 26
# tensor parallel and FSDP: the gloo jobs' constants
TP_DEPTH = 2          # layers of the tp:2 training rows (full width)
TP_CUT = MODEL + "_tp2cut"  # MODEL at TP_DEPTH layers, in perf.LM_CONFIGS
TP_TRAIN_BATCH, TP_TRAIN_STEPS = 8, 4
TP_ROW_LEN = 64       # the bf16 prefill rows (2 of them) of phase 26 (a)
TP_TOL = {"loss": 1e-4, "params": 1e-4}  # params: of max|p|
TP_BF16_FACTOR = 3.0  # tp:2 bf16 logits vs one rank, x one rank's own error
FSDP_BATCH, FSDP_STEPS, FSDP_TOL = 128, 4, 1e-5


def _lars():
    from bigdl_tpu_torch.optim import LARS
    return LARS(1.0, momentum=0.9, weight_decay=1e-4)


def _lamb():
    from bigdl_tpu_torch.optim import LAMB
    return LAMB(1e-3, weight_decay=1e-2)


# phase 26 (c): the per-tensor-norm methods, one f32 tp:2 step each
TP_NORM_METHODS = {"lars": _lars, "lamb": _lamb}
DP_SERVE_SEQ, DP_SERVE_REQS = 256, 8
TP_TIMEOUT_S = 600
TP_SERVE_WORKER = "chip_smoke:tp_serve_worker"
TP_TRAIN_WORKER = "chip_smoke:tp_train_worker"
FSDP_WORKER = "chip_smoke:fsdp_worker"
# the tp:2 per-rank attention geometry of MODEL (4 of its 8 query heads, 1
# of its 2 KV heads, expanded to 4): the kernels against their plain
# versions there
TP_SHAPES = [(TP_TRAIN_BATCH, 4, 1024, 1024, 128, True, "bfloat16", False),
             (TP_TRAIN_BATCH, 4, 1024, 1024, 128, True, "float32", False),
             (2, 4, TP_ROW_LEN, TP_ROW_LEN, 128, True, "bfloat16", False)]


def _tp_cut_row():
    """Register TP_CUT: MODEL's row of ``cli.perf`` at TP_DEPTH layers."""
    from bigdl_tpu_torch.cli import perf
    perf.LM_CONFIGS[TP_CUT] = dict(perf.LM_CONFIGS[MODEL],
                                   num_layers=TP_DEPTH)


def _tp_prompts():
    import numpy as np
    rs = np.random.RandomState(26)
    prompts = [rs.randint(0, 32000, n).tolist() for n in PROMPT_LENS]
    rows = rs.randint(0, 32000, (2, TP_ROW_LEN)).astype(np.int32)
    return prompts, rows


def tp_serve_worker(args):
    """Phase 26 (a) on one rank of a 2-rank gloo job: ``serve MODEL
    --strategy tp:2`` through ``cli.serve.build_app``, f32 (with ``--lint
    strict``: phase 30 (c)) then bf16, the embedding scaled by 0.02 as
    phase 6 does. Rank 0 answers the greedy /generate of each prompt
    (f32) and the /predict forward of 2 rows (bf16, saved beside the
    job); rank 1 follows. Returns each run's kernel launches on this rank,
    the geometry its attention ran at and, on rank 0, the lint's vetted
    mesh and error count."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    rank = dist.get_rank()
    prompts, rows = _tp_prompts()
    out = {"rank": rank}
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        argv = [MODEL, "--randomInit", "--slots", "4", "--buckets", "1,2",
                "--no-warmup", "--strategy", "tp:2"] + (
                    ["--bf16"] if bf16 else ["--lint", "strict"])
        t0 = time.perf_counter()
        app = serve_cli.build_app(serve_cli.build_parser().parse_args(
            argv))[0]
        model = app.decoder.model
        lint = {}
        if not bf16 and not getattr(app, "follower", False):
            lint = {"lint_mesh": app.metrics._provenance.get("lint_mesh"),
                    "lint_errors": app.engine.lint_annotation["errors"]}
        with torch.no_grad():
            model.emb.weight.mul_(0.02)
        mha = model.encoder[0].mha
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        if getattr(app, "follower", False):
            calls = app.serve()
            app.close()
        else:
            calls = None
            try:
                if bf16:
                    np.save(os.path.join(args["dir"], "tp_bf16.npy"),
                            app.engine.predict_scores(rows))
                else:
                    toks = []
                    for p in prompts:
                        st, body = app.dispatch_post(
                            "/generate", {"tokens": p,
                                          "max_new_tokens": MAX_NEW})
                        if st != 200:
                            raise RuntimeError(f"/generate {st}: {body}")
                        toks.append(body["tokens"])
                    out["tokens"] = toks
            finally:
                app.close()
        torch.cuda.synchronize()
        out[tag] = {"launches": ops.kernel_launches(),
                    "heads": mha.num_heads, "kv_heads": mha.num_kv_heads,
                    "head_dim": mha.head_dim, "calls": calls,
                    "build_s": round(build_s, 1),
                    "run_s": round(time.perf_counter() - t0, 1), **lint}
        del app, model
        torch.cuda.empty_cache()
    out.update(tp_image_serve(args))
    return out


def tp_image_serve(args):
    """Phase 29 (c) on one rank of phase 26 (a)'s job: ``serve TP_IMAGE
    --strategy tp:2`` and ``dp:2+tp:2`` through ``cli.serve.build_app``,
    f32; rank 0 answers one /predict of TP_IMAGE_ROWS rows (2 a batch)
    and saves its scores and its /metrics page beside the job; rank 1
    follows. Returns each run's followed calls and seconds."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.cli import serve as serve_cli

    out = {}
    x = _tp_image_rows()
    for strat in TP_IMAGE_STRATEGIES:
        t0 = time.perf_counter()
        app = serve_cli.build_app(serve_cli.build_parser().parse_args(
            [TP_IMAGE, "--randomInit", "--buckets", "1,2", "--no-warmup",
             "--strategy", strat] + BULK_PLATFORM))[0]
        if getattr(app, "follower", False):
            calls = app.serve()
            app.close()
        else:
            calls = None
            try:
                st, body = app.dispatch_post("/predict", {
                    "inputs": x.tolist(), "return_scores": True})
                if st != 200:
                    raise RuntimeError(f"/predict {st}: {body}")
                tag = _tp_image_tag(strat)
                np.save(os.path.join(args["dir"], f"{tag}.npy"),
                        np.asarray(body["scores"], np.float32))
                with open(os.path.join(args["dir"], f"{tag}.metrics"),
                          "w") as f:
                    f.write(app.handle_metrics())
            finally:
                app.close()
        out[strat] = {"calls": calls,
                      "s": round(time.perf_counter() - t0, 1)}
        del app
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def tp_train_worker(args):
    """Phase 26 (c) on one rank of a 2-rank gloo job: TP_CUT trained at
    ``TensorParallel`` tp:2 through ``cli.perf.train_step`` in f32 (the
    FMA flash kernels) for TP_TRAIN_STEPS steps; rank 0 then runs the same
    steps in one process and compares the losses and the gathered whole
    parameters. Then ``cli.perf.run(--strategy tp)`` in bf16 (the wgmma
    kernels): its launches and tokens/s."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.parallel import TensorParallel, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    _tp_cut_row()
    rank = dist.get_rank()
    strat = TensorParallel(make_mesh({"data": 1, "model": 2}), None)
    (step, model, _, _), n = _launched(torch, lambda: perf.train_step(
        TP_CUT, TP_TRAIN_BATCH, torch.float32, DEV, strategy=strat))
    (losses, n) = _launched(torch, lambda: [
        float(step()) for _ in range(TP_TRAIN_STEPS)])
    whole = strat.gather(dict(model.named_parameters()), None, None)[0]
    mha = model.encoder[0].mha
    out = {"rank": rank, "f32": {"losses": losses, "launches": n,
                                 "heads": mha.num_heads,
                                 "kv_heads": mha.num_kv_heads}}
    del step, model
    torch.cuda.empty_cache()
    if rank == 0:
        step1, model1, _, _ = perf.train_step(TP_CUT, TP_TRAIN_BATCH,
                                              torch.float32, DEV)
        ref = [float(step1()) for _ in range(TP_TRAIN_STEPS)]
        p1 = dict(model1.named_parameters())
        pmax = max(float(p.detach().abs().max()) for p in p1.values())
        out["f32"].update(
            ref=ref, pmax=pmax,
            dloss=max(abs(a - b) for a, b in zip(losses, ref)),
            dparam=max(float((whole[k] - p.detach()).abs().max())
                       for k, p in p1.items()))
        del step1, model1, p1
    del whole
    torch.cuda.empty_cache()
    # LARS and LAMB: one f32 step each, the split leaves' norms whole
    for name, make in TP_NORM_METHODS.items():
        strat = TensorParallel(make_mesh({"data": 1, "model": 2}), None)
        step, model, _, _ = perf.train_step(
            TP_CUT, TP_TRAIN_BATCH, torch.float32, DEV, strategy=strat,
            optim_method=make())
        loss = float(step())
        whole = strat.gather(dict(model.named_parameters()), None, None)[0]
        del step, model
        torch.cuda.empty_cache()
        out[name] = {"loss": loss}
        if rank == 0:
            step1, model1, _, _ = perf.train_step(
                TP_CUT, TP_TRAIN_BATCH, torch.float32, DEV,
                optim_method=make())
            ref = float(step1())
            p1 = dict(model1.named_parameters())
            out[name].update(
                ref=ref, pmax=max(float(p.detach().abs().max())
                                  for p in p1.values()),
                dparam=max(float((whole[k] - p.detach()).abs().max())
                           for k, p in p1.items()))
            del step1, model1, p1
        del whole
        torch.cuda.empty_cache()
    dist.barrier()
    (res, n) = _launched(torch, lambda: perf.run(
        TP_CUT, batch=TP_TRAIN_BATCH, iterations=3, warmup=1,
        dtype=torch.bfloat16, strategy="tp"))
    out["bf16"] = {k: res[k] for k in ("losses", "tokens_per_second",
                                       "n_devices", "mesh", "strategy")}
    out["bf16"]["launches"] = n
    return out


def fsdp_worker(args):
    """Phase 26 (d) on one rank of a 2-rank gloo job: ``resnet_cifar(20)``
    f32 ``--fusedBN apply`` through ``cli.perf.train_step`` for FSDP_STEPS
    steps under ``FullyShardedDataParallel``, then under
    ``DataParallel``: the parameters of the two (whole again after
    ``unplace``), each run's launches, the parameter storage this rank
    holds, its optimizer state (SGD momentum: its own parameters' bytes)
    and its peak memory."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.parallel import (DataParallel,
                                          FullyShardedDataParallel,
                                          make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    rank = dist.get_rank()
    out, params = {"rank": rank}, {}
    for kind, make in (("fsdp", FullyShardedDataParallel),
                       ("dp", DataParallel)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        strat = make(make_mesh({"data": 2}))
        (step, model, _, _), _ = _launched(torch, lambda: perf.train_step(
            "resnet20_cifar", FSDP_BATCH, torch.float32, DEV,
            fused_bn="apply", data_type="random", strategy=strat))
        (losses, n) = _launched(torch, lambda: [
            float(step()) for _ in range(FSDP_STEPS)])
        ps = dict(model.named_parameters())
        total = sum(p.numel() * p.element_size() for p in ps.values())
        own = sum(p.numel() * p.element_size() for k, p in ps.items()
                  if strat.owner(k) == rank)
        resident = strat.resident_bytes() if kind == "fsdp" else total
        peak = torch.cuda.max_memory_allocated()
        strat.unplace(model)
        params[kind] = {k: v.detach().float().clone()
                        for k, v in model.state_dict().items()}
        out[kind] = {"losses": losses, "launches": n,
                     "param_bytes": resident, "param_bytes_whole": total,
                     "opt_bytes": own, "peak_bytes": peak,
                     "gathers": getattr(strat, "gathers", 0),
                     "max_whole_modules": getattr(strat,
                                                  "max_whole_modules", 0)}
        del step, model, ps
    out["dparam"] = max(float((params["fsdp"][k] - v).abs().max())
                        for k, v in params["dp"].items())
    return out


def _spawn_bg(target, args, state, key):
    """``spawn(target)`` at 2 gloo ranks on a thread; its results, or its
    error, land in ``state[key]``."""
    from bigdl_tpu_torch.parallel.launch import spawn

    def run():
        t0 = time.perf_counter()
        try:
            state[key] = spawn(target, 2, args, timeout_s=TP_TIMEOUT_S,
                               backend="gloo")
        except BaseException as e:  # reported by the phase
            state[key + " error"] = repr(e)
        state[key + " s"] = round(time.perf_counter() - t0, 1)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _job(state, key, tag):
    if key + " error" in state:
        fail(f"[phase 26 {tag}] the 2-rank job failed: {state[key + ' error']}")
    return state[key]


def tp_dp_serve_run(torch, card):
    """Phase 26 (b): ``serve MODEL --strategy dp:2 --devices cuda:0,cuda:0``
    in this process, each replica its own engines and CUDA graphs, over
    HTTP: DP_SERVE_REQS concurrent greedy /generate equal, bit for bit,
    the same prompts through replica 0 alone; both replicas served; the
    labelled series and the fleet gauges on /metrics. Returns (rows,
    flash_fwd launches of the traffic)."""
    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.cli import serve as serve_cli
    from bigdl_tpu_torch.serving import make_server

    argv = [MODEL, "--randomInit", "--slots", "4", "--buckets", "1,2",
            "--seq", str(DP_SERVE_SEQ), "--strategy", "dp:2", "--devices",
            "cuda:0,cuda:0", "--port", "0"]
    t0 = time.perf_counter()
    app = serve_cli.build_app(serve_cli.build_parser().parse_args(argv))[0]
    reps = app.replicas.replicas
    with torch.no_grad():
        for rep in reps:
            rep.decoder.model.emb.weight.mul_(0.02)
    build_s = time.perf_counter() - t0
    graphs = [len(rep.decoder.graphs) + len(rep.engine.graphs)
              for rep in reps]
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rs = np.random.RandomState(262)
    prompts = [rs.randint(0, 32000, int(n)).tolist() for n in
               rs.randint(3, DP_SERVE_SEQ - MAX_NEW, DP_SERVE_REQS)]
    try:
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        results = {}

        def gen(i):
            results[i] = _post(port, "/generate", {
                "tokens": prompts[i], "max_new_tokens": MAX_NEW})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=gen, args=(i,))
                   for i in range(DP_SERVE_REQS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        n = ops.kernel_launches()["flash_fwd"]
        st, page = _get(port, "/metrics")
        alone = [reps[0].decoder.submit(p, MAX_NEW).result(600)
                 for p in prompts]
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
    bad = [i for i in range(DP_SERVE_REQS) if results[i][0] != 200]
    if bad:
        fail(f"[phase 26 (b)] /generate answered {results[bad[0]]}")
    got = [results[i][1]["tokens"] for i in range(DP_SERVE_REQS)]
    served = {}
    for line in page.splitlines():
        for r in ("0", "1"):
            if line.startswith(
                    f'bigdl_serving_generated_tokens_total{{replica="{r}"}}'):
                served[r] = float(line.rsplit(" ", 1)[1])
    gauges = {g: any(line.startswith(f"bigdl_serving_{g} ")
                     for line in page.splitlines())
              for g in ("replicas", "replicas_live", "kv_cache_bytes",
                        "kv_pages_in_use", "fleet_generated_tokens_total")}
    print(f"[phase 26 (b)] {MODEL} dp:2 on one card ({card}), seq "
          f"{DP_SERVE_SEQ}: build {build_s:.1f}s, graphs a replica "
          f"{graphs}; {DP_SERVE_REQS} concurrent /generate of {MAX_NEW} "
          f"tokens in {wall:.2f}s; tokens a replica {served}; fleet gauges "
          f"{gauges}; equal to replica 0 alone: {got == alone}; flash_fwd "
          f"launches {n}", flush=True)
    if got != alone:
        fail("[phase 26 (b)] dp:2 tokens differ from replica 0's alone")
    if st != 200 or len(served) != 2 or min(served.values()) <= 0 \
            or not all(gauges.values()) or min(graphs) == 0 or n == 0:
        fail(f"[phase 26 (b)] replicas {served}, gauges {gauges}, graphs "
             f"{graphs}, launches {n}")
    return {"(b) dp:2 tokens/s": round(DP_SERVE_REQS * MAX_NEW / wall, 1)}, n


def tp_start():
    """Phase 26 (a) and (d), started: their 2-rank gloo jobs on threads,
    beside phase 25's in-process runs (whose checks are bits, launches and
    per-process memory) and then phase 26's own. Returns the handle
    :func:`tp_runs` takes."""
    import tempfile

    state = {"t0": time.perf_counter(),
             "dir": tempfile.mkdtemp(prefix="phase26_")}
    state["threads"] = [
        _spawn_bg(TP_SERVE_WORKER, {"dir": state["dir"]}, state, "a"),
        _spawn_bg(FSDP_WORKER, {"dir": state["dir"]}, state, "d")]
    return state


def tp_runs(torch, card, state=None):
    """Phase 26: tensor parallel and FSDP. (a) and (d) run as 2-rank gloo
    jobs on threads (started by :func:`tp_start`, here when ``state`` is
    None) beside (b) and the kernel checks at the tp:2 per-rank geometry,
    then (c) alone. Returns (rows, launches of the main paths)."""
    import numpy as np

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import attention_kernel as ak
    from bigdl_tpu_torch.serving import DecodeEngine

    t_phase = time.perf_counter()
    state = state or tp_start()
    rows, launches, td, bg = {}, [], state["dir"], state["threads"]

    # the kernels at the tp:2 per-rank geometry, against their plain
    # versions
    for r in check_flash(torch, ak, shapes=TP_SHAPES):
        print(f"[phase 26 kernels] flash_fwd {r['shape']} {r['dtype']} "
              f"({r['kernel']}): max|d| {r['max_abs_err']:.3g}, "
              f"{r['ms']:.3f} ms", flush=True)
    for r in check_flash_bwd(torch, ak, shapes=TP_SHAPES[:2]):
        print(f"[phase 26 kernels] flash_dq/flash_dkv {r['shape']} "
              f"{r['dtype']}: max|d| {r['dq_abs_err']:.3g} / "
              f"{r['dkv_abs_err']:.3g}, {r['dq_ms']:.3f} / {r['dkv_ms']:.3f} "
              f"ms", flush=True)

    # (b) dp:2 in this process
    t0 = time.perf_counter()
    r, n = tp_dp_serve_run(torch, card)
    rows.update(r)
    launches.append({"flash_fwd": n})
    rows["(b) s"] = round(time.perf_counter() - t0, 1)
    _free(torch)

    # the one-rank references of (a): the greedy tokens in f32, the
    # /predict forward in f32 and bf16
    prompts, xrows = _tp_prompts()
    model, _ = perf.build_model(MODEL)
    with torch.no_grad():
        model.emb.weight.mul_(0.02)
    model = model.to(DEV).eval()
    eng = DecodeEngine(model, slots=4, device=DEV, graphs=False)
    try:
        ref_tokens = [eng.generate(p, MAX_NEW) for p in prompts]
    finally:
        eng.close()
    x = torch.from_numpy(xrows).to(DEV)
    with torch.no_grad():
        ref32 = model(x).float()
        model.compute_dtype = torch.bfloat16
        ref16 = model(x).float()
    del model, eng
    _free(torch)

    for t in bg:
        t.join()
    res = _job(state, "a", "(a)")
    tp16 = torch.from_numpy(np.load(os.path.join(td, "tp_bf16.npy"))).to(
        DEV)
    own = float((ref16 - ref32).abs().max())
    err = float((tp16 - ref16).abs().max())
    for rr in res:
        for tag in ("f32", "bf16"):
            g = rr[tag]
            print(f"[phase 26 (a) rank {rr['rank']} {tag}] {MODEL} tp:2 on "
                  f"{card}: flash_fwd ran at {g['heads']} query heads and "
                  f"{g['kv_heads']} KV head(s) of {g['head_dim']} a rank, "
                  f"{g['launches']['flash_fwd']} launches; build "
                  f"{g['build_s']}s, traffic {g['run_s']}s, followed calls "
                  f"{g['calls']}", flush=True)
            if g["launches"]["flash_fwd"] == 0 or g["heads"] != 4 \
                    or g["head_dim"] != 128:
                fail(f"[phase 26 (a) rank {rr['rank']} {tag}] {g}")
            launches.append(g["launches"])
    lead = [rr["f32"] for rr in res if rr["rank"] == 0][0]
    print(f"[phase 30 (c)] serve {MODEL} --strategy tp:2 --lint strict "
          f"(phase 26 (a)'s f32 job) on {card}: started and served; "
          f"lint_mesh {lead.get('lint_mesh')!r}, the forward's lint "
          f"errors {lead.get('lint_errors')}", flush=True)
    if lead.get("lint_mesh") != "model:2" or lead.get("lint_errors") != 0:
        fail(f"[phase 30 (c)] rank 0's lint stamp {lead}")
    rows["(a) lint_mesh"] = lead["lint_mesh"]
    same = res[0]["tokens"] == ref_tokens
    print(f"[phase 26 (a)] f32 greedy /generate of {len(prompts)} prompts "
          f"(lengths {list(PROMPT_LENS)}, {MAX_NEW} new tokens) equal one "
          f"rank's engine: {same}; bf16 /predict logits vs one rank's bf16: "
          f"max|d| {err:.4g}, one rank's own error vs f32 {own:.4g} (bound "
          f"{TP_BF16_FACTOR}x); {state['a s']}s for the job", flush=True)
    if not same or err > TP_BF16_FACTOR * own:
        fail(f"[phase 26 (a)] tokens equal {same}, bf16 max|d| {err} vs "
             f"{TP_BF16_FACTOR} x {own}")
    rows["(a) s"] = state["a s"]

    res = _job(state, "d", "(d)")
    for rr in res:
        f, d = rr["fsdp"], rr["dp"]
        print(f"[phase 26 (d) rank {rr['rank']}] resnet_cifar(20) f32 "
              f"--fusedBN apply global batch {FSDP_BATCH}, {FSDP_STEPS} "
              f"steps on {card}: FSDP losses {f['losses']}, DataParallel "
              f"{d['losses']}, max|d param| {rr['dparam']:.3g}; parameter "
              f"bytes resident {f['param_bytes']} (DataParallel "
              f"{d['param_bytes']}), optimizer-state bytes {f['opt_bytes']} "
              f"(DataParallel ZeRO-1 {d['opt_bytes']}), peak memory "
              f"{f['peak_bytes']} (DataParallel {d['peak_bytes']}); "
              f"{f['gathers']} gathers, at most {f['max_whole_modules']} "
              f"module(s) whole; BN launches {f['launches']['bn_stats']} + "
              f"{f['launches']['bn_bwd_stats']}", flush=True)
        if rr["dparam"] > FSDP_TOL or f["launches"]["bn_stats"] == 0 \
                or f["launches"]["bn_bwd_stats"] == 0 \
                or f["param_bytes"] >= d["param_bytes"]:
            fail(f"[phase 26 (d) rank {rr['rank']}] {rr}")
        launches.append(f["launches"])
    rows["(d) s"] = state["d s"]

    # (c) alone: its tokens/s measures gloo through the host
    t0 = time.perf_counter()
    from bigdl_tpu_torch.parallel.launch import spawn
    try:
        res = spawn(TP_TRAIN_WORKER, 2, {"dir": td}, timeout_s=TP_TIMEOUT_S,
                    backend="gloo")
    except (RuntimeError, TimeoutError) as e:
        fail(f"[phase 26 (c)] the 2-rank job failed: {e}")
    f32 = res[0]["f32"]
    print(f"[phase 26 (c)] {TP_CUT} ({TP_DEPTH} layers of {MODEL}) tp:2 f32 "
          f"batch {TP_TRAIN_BATCH} on {card}: losses {f32['losses']}, one "
          f"process {f32['ref']}, max|d loss| {f32['dloss']:.3g}, max|d "
          f"param| {f32['dparam']:.3g} of max|p| {f32['pmax']:.3g}",
          flush=True)
    if f32["dloss"] > TP_TOL["loss"] or \
            f32["dparam"] > TP_TOL["params"] * f32["pmax"]:
        fail(f"[phase 26 (c)] f32 tp:2 beyond {TP_TOL}")
    for name in TP_NORM_METHODS:
        m = res[0][name]
        dloss = abs(m["loss"] - m["ref"])
        print(f"[phase 26 (c)] {TP_CUT} tp:2 f32 one {name.upper()} step on "
              f"{card}: loss {m['loss']:.6g}, one process {m['ref']:.6g}, "
              f"max|d param| {m['dparam']:.3g} of max|p| {m['pmax']:.3g} "
              f"(the split leaves' norms all-reduced)", flush=True)
        if dloss > TP_TOL["loss"] or \
                m["dparam"] > TP_TOL["params"] * m["pmax"]:
            fail(f"[phase 26 (c)] {name} tp:2 beyond {TP_TOL}")
    for rr in res:
        b = rr["bf16"]
        n32, n16 = rr["f32"]["launches"], b["launches"]
        print(f"[phase 26 (c) rank {rr['rank']}] f32 launches {n32}; bf16 "
              f"cli.perf --strategy tp: losses {b['losses']}, "
              f"{b['tokens_per_second']} tokens/s over mesh {b['mesh']} "
              f"(2 gloo ranks sharing one card: this measures gloo through "
              f"the host, not scaling), launches {n16}", flush=True)
        for n in (n32, n16):
            if min(n["flash_fwd"], n["flash_dq"], n["flash_dkv"]) == 0:
                fail(f"[phase 26 (c) rank {rr['rank']}] launches {n}")
        launches += [n32, n16]
        rows[f"(c) rank {rr['rank']} bf16 tokens/s"] = b["tokens_per_second"]
    rows["(c) s"] = round(time.perf_counter() - t0, 1)
    rows["phase 26 s"] = round(time.perf_counter() - t_phase, 1)
    rows["phase 26 s from its jobs' start"] = round(
        time.perf_counter() - state["t0"], 1)
    return rows, launches


# ------------------------------------------------------------------ phase 27
# sequence, pipeline and expert parallelism: one 2-rank gloo job sharing
# the card
SP_ROW, SP_SEQ, SP_ITERS = "transformer_lm_16k", 16384, 1  # (a)'s speed row
SP_CUT, SP_CUT_SEQ = MODEL + "_sp2cut", 4096  # (a)'s f32 parity row
SP_BLOCK = 512        # the ring's key block, and the blockwise reference's
PP_BATCH, EP_BATCH, SPE_ITERS = 8, 4, 3  # (b) and (c)'s speed runs (MODEL)
SPE_PARITY_BATCH, SPE_PARITY_SEQ, SPE_PARITY_STEPS = 4, 256, 2
SPE_TOL = {"loss": 1e-5, "params": 1e-5}  # loss: relative; params: of max|p|
SPE_TIMEOUT_S = 450
SPE_WORKER = "chip_smoke:spe_worker"


def _sp_cut_row():
    """Register SP_CUT: SP_ROW's row of ``cli.perf`` at 2 layers and
    SP_CUT_SEQ tokens (full width: 1024, 8 heads of 128)."""
    from bigdl_tpu_torch.cli import perf
    perf.LM_CONFIGS[SP_CUT] = dict(perf.LM_CONFIGS[SP_ROW], num_layers=2,
                                   max_len=SP_CUT_SEQ)


def _peak(torch, run):
    """(``run()``, the peak bytes allocated on the card while it ran)."""
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    res = run()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated()


def _harness_parity(torch, name, rank):
    """Phase 27 (b)/(c) parity: ``cli.perf``'s ``name`` harness at MODEL's
    width in f32 over the 2-rank mesh for SPE_PARITY_STEPS steps against
    the same harness unsplit in this process: the losses, this rank's
    parameters (its stage or its experts, the gate) and their bytes."""
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.parallel import make_mesh

    axes = {"pipe": 2, "data": 1} if name == "pp" else {"expert": 2}
    kw = dict(strat_name=name, model_name=MODEL, batch=SPE_PARITY_BATCH,
              mesh_axes=axes, dtype=torch.float32,
              seq_len=SPE_PARITY_SEQ, device=DEV)
    h = perf._setup_strategy_harness(mesh=make_mesh(axes), **kw)
    losses = [float(h["step"]()) for _ in range(SPE_PARITY_STEPS)]
    mine = {k: p.detach() for k, p in h["module"].named_parameters()}
    stacked = h["module"] if name == "pp" else h["module"].experts
    lo, hi = stacked.stage
    own = sum(p.numel() * p.element_size()
              for k, p in mine.items() if k != "gate")
    del h
    _free(torch)
    r = perf._setup_strategy_harness(mesh=None, **kw)
    ref = [float(r["step"]()) for _ in range(SPE_PARITY_STEPS)]
    full = {k: p.detach() for k, p in r["module"].named_parameters()}
    whole = sum(p.numel() * p.element_size()
                for k, p in full.items() if k != "gate")
    pmax = max(float(p.abs().max()) for p in full.values())
    dparam = max(float((mine[k] - (p if k == "gate" else p[lo:hi]))
                       .abs().max()) for k, p in full.items())
    del r, full, mine
    _free(torch)
    dist.barrier()
    return {"losses": losses, "ref": ref, "pmax": pmax, "dparam": dparam,
            "stage": [lo, hi], "param_bytes": own,
            "param_bytes_whole": whole,
            "dloss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref))}


def spe_worker(args):
    """Phase 27 on one rank of a 2-rank gloo job: (a) sp:2, (b) pp:2 and
    (c) ep:2 in turn (see the module docstring)."""
    import functools

    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.attention_kernel import blockwise_attention
    from bigdl_tpu_torch.parallel import (SequenceParallel, make_mesh,
                                          make_ring_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    rank = dist.get_rank()
    blockwise = functools.partial(blockwise_attention, block_k=SP_BLOCK)
    out = {"rank": rank}

    # (a) sp:2 at SP_SEQ tokens, bf16: speed, peak memory and launches
    t0 = time.perf_counter()
    (line, n), peak = _peak(torch, lambda: _launched(torch, lambda: perf.run(
        SP_ROW, batch=1, iterations=SP_ITERS, warmup=1,
        dtype=torch.bfloat16, seq_len=SP_SEQ, strategy="sp")))
    sp = out["sp"] = {k: line[k] for k in (
        "losses", "tokens_per_second", "mesh", "n_devices", "strategy",
        "mfu", "seconds")}
    sp.update(peak_bytes=peak, launches=n)
    _free(torch)  # rank 1's cache too, while rank 0 runs the reference
    dist.barrier()
    if rank == 0:  # the same model in one process, blockwise attention
        def one():
            step, _, _, _ = perf.train_step(SP_ROW, 1, torch.bfloat16, DEV,
                                            seq_len=SP_SEQ,
                                            attn_impl=blockwise)
            return float(step())

        sp["one_loss"], sp["one_peak_bytes"] = _peak(torch, one)
        _free(torch)
    dist.barrier()
    sp["s"] = round(time.perf_counter() - t0, 1)

    # (a) parity: SP_CUT in f32, one step of the ring under
    # SequenceParallel against one process with blockwise attention
    t0 = time.perf_counter()
    _sp_cut_row()
    mesh = make_mesh({"data": 1, "seq": 2})
    ring = make_ring_attention(mesh, "seq", batch_axis="data",
                               block_k=SP_BLOCK)
    step, model, _, _ = perf.train_step(
        SP_CUT, 1, torch.float32, DEV, strategy=SequenceParallel(mesh),
        attn_impl=ring)
    loss = float(step())
    mine = {k: p.detach() for k, p in model.named_parameters()}
    del step, model
    step1, model1, _, _ = perf.train_step(SP_CUT, 1, torch.float32, DEV,
                                          attn_impl=blockwise)
    ref = float(step1())
    p1 = {k: p.detach() for k, p in model1.named_parameters()}
    sp["parity"] = {
        "loss": loss, "ref": ref,
        "pmax": max(float(p.abs().max()) for p in p1.values()),
        "dparam": max(float((mine[k] - p).abs().max())
                      for k, p in p1.items()),
        "s": round(time.perf_counter() - t0, 1)}
    del step1, model1, p1, mine
    _free(torch)
    dist.barrier()

    # (b) pp:2 and (c) ep:2: cli.perf's speed line in bf16, then parity
    for name, batch in (("pp", PP_BATCH), ("ep", EP_BATCH)):
        t0 = time.perf_counter()
        line, peak = _peak(torch, lambda: perf.run(
            MODEL, batch=batch, iterations=SPE_ITERS, warmup=1,
            dtype=torch.bfloat16, strategy=name))
        r = out[name] = {k: line[k] for k in (
            "losses", "records_per_second", "tokens_per_second", "mesh",
            "n_devices", "strategy", "mfu", "seconds")}
        r["peak_bytes"] = peak
        _free(torch)
        dist.barrier()
        r["parity"] = _harness_parity(torch, name, rank)
        r["s"] = round(time.perf_counter() - t0, 1)
    return out


def spe_runs(torch, card):
    """Phase 27: sequence, pipeline and expert parallelism in one 2-rank
    gloo job sharing the card. Returns {tag: value}."""
    import math

    from bigdl_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    _free(torch)
    try:
        res = spawn(SPE_WORKER, 2, {}, timeout_s=SPE_TIMEOUT_S,
                    backend="gloo")
    except (RuntimeError, TimeoutError) as e:
        fail(f"[phase 27] the 2-rank job failed: {e}")
    rows = {}
    gib = 2.0 ** 30
    one = res[0]["sp"]
    for rr in res:
        sp = rr["sp"]
        per_rank = sp["tokens_per_second"] / sp["n_devices"]
        print(f"[phase 27 (a) rank {rr['rank']}] cli.perf -m {SP_ROW} "
              f"--strategy sp:2 bf16 batch 1 x {SP_SEQ} tokens on {card}: "
              f"losses {sp['losses']}, {sp['tokens_per_second']} tokens/s "
              f"over mesh {sp['mesh']} ({per_rank:.1f} a rank; 2 gloo "
              f"ranks sharing one card), mfu {sp['mfu']}, peak memory "
              f"{sp['peak_bytes'] / gib:.2f} GiB a rank; launches "
              f"{sp['launches']}", flush=True)
        if not all(math.isfinite(v) for v in sp["losses"]) \
                or sp["strategy"] != "sp" or sp["launches"]["flash_fwd"]:
            fail(f"[phase 27 (a) rank {rr['rank']}] {sp}")
        rows[f"(a) rank {rr['rank']} tokens/s a rank"] = round(per_rank, 1)
        rows[f"(a) rank {rr['rank']} peak GiB"] = round(
            sp["peak_bytes"] / gib, 2)
    ratio = max(rr["sp"]["peak_bytes"] for rr in res) / one["one_peak_bytes"]
    print(f"[phase 27 (a)] one process, blockwise attention (block "
          f"{SP_BLOCK}), the same model at {SP_SEQ} tokens: first loss "
          f"{one['one_loss']:.6g} (sp:2 {one['losses'][0]:.6g}), peak "
          f"memory {one['one_peak_bytes'] / gib:.2f} GiB; sp:2's peak a "
          f"rank is {ratio:.3f} of it", flush=True)
    if ratio >= 1.0:
        fail(f"[phase 27 (a)] sp:2 peak a rank {ratio:.3f} of one process")
    rows["(a) peak a rank / one process"] = round(ratio, 3)
    par = one["parity"]
    dloss = abs(par["loss"] - par["ref"]) / abs(par["ref"])
    print(f"[phase 27 (a)] {SP_CUT} (2 layers of width 1024, 8 heads of "
          f"128, {SP_CUT_SEQ} tokens) f32 one step at sp:2 on {card}: loss "
          f"{par['loss']:.7g}, one process (blockwise) {par['ref']:.7g}, "
          f"relative {dloss:.3g}; max|d param| {par['dparam']:.3g} of "
          f"max|p| {par['pmax']:.3g} ({par['s']}s)", flush=True)
    if dloss > SPE_TOL["loss"] or \
            par["dparam"] > SPE_TOL["params"] * par["pmax"]:
        fail(f"[phase 27 (a)] f32 sp:2 beyond {SPE_TOL}")
    rows["(a) s"] = one["s"] + par["s"]
    for tag, name in (("(b)", "pp"), ("(c)", "ep")):
        for rr in res:
            r, par = rr[name], rr[name]["parity"]
            print(f"[phase 27 {tag} rank {rr['rank']}] cli.perf -m {MODEL} "
                  f"--strategy {name}:2 bf16 on {card}: losses "
                  f"{r['losses']}, {r['records_per_second']} records/s "
                  f"({r['tokens_per_second']} tokens/s) over mesh "
                  f"{r['mesh']} (2 gloo ranks sharing one card), mfu "
                  f"{r['mfu']}, peak memory {r['peak_bytes'] / gib:.2f} "
                  f"GiB; f32 {SPE_PARITY_STEPS} steps at batch "
                  f"{SPE_PARITY_BATCH} x {SPE_PARITY_SEQ}: losses "
                  f"{par['losses']}, one process {par['ref']}, relative "
                  f"{par['dloss']:.3g}, max|d param| {par['dparam']:.3g} "
                  f"of max|p| {par['pmax']:.3g}; "
                  f"{'blocks' if name == 'pp' else 'experts'} "
                  f"{par['stage']}, {par['param_bytes']} parameter bytes "
                  f"of the whole {par['param_bytes_whole']}", flush=True)
            if not all(math.isfinite(v) for v in r["losses"]) \
                    or r["strategy"] != name \
                    or par["dloss"] > SPE_TOL["loss"] \
                    or par["dparam"] > SPE_TOL["params"] * par["pmax"] \
                    or 2 * par["param_bytes"] != par["param_bytes_whole"]:
                fail(f"[phase 27 {tag} rank {rr['rank']}] {r}")
            rows[f"{tag} rank {rr['rank']} records/s"] = \
                r["records_per_second"]
        rows[f"{tag} s"] = res[0][name]["s"]
    rows["phase 27 s"] = round(time.perf_counter() - t_phase, 1)
    return rows


# ------------------------------------------------------------------ phase 28
# observability: --obs, capture windows, attribution, the memory plan and
# the OOM autopsy on the main paths
OBS_RESNET = ("resnet50_fba", 128, 8, "3@3")     # (a): row, batch, iters
OBS_LM = (MODEL, 8, 4, 4, "2@1")                 # (b): ..., innerSteps
OBS_FBN = ("resnet50_fbn", 128, 2, "1@1")        # (d)
OBS_MEM_BATCH = 32                               # (e): plans at 32, 64
# (f): a batch that does not fit the allocator's cap in its process (a
# fraction of the card: the OOM comes after a few GB, not after 80)
OBS_OOM, OBS_OOM_FRACTION = ("resnet50", 512), 0.15
OBS_HOST_OTHER_MAX = 0.05  # of device time, in the windows of (a)-(d)
OBS_PHASE_TOL = 0.10       # the phase columns' sum against seconds
OBS_MEM_TOL = 0.20         # (e)'s prediction against (a)'s live peak
OBS_PLATFORM = []  # ["--platform", "cpu"] to rehearse on the CPU


def _obs_perf(torch, argv):
    """``cli.perf.main(argv)`` with the launch counts set to 0 just
    before it; (line, launches). The tracer and the registry start fresh,
    so each run's spans and gauges are its own."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.cli import perf

    obs.disable()
    obs.reset_registry()
    _free(torch)
    out = io_quiet(lambda: _launched(torch, lambda: perf.main(
        argv + OBS_PLATFORM)))
    obs.disable()
    return out


def io_quiet(run):
    """``run()`` with its standard output kept out of this script's (the
    perf line, the span and listener notices)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return run()


def _window(tag, line, want_ok=True):
    """The line's one capture window, checked: verified, attributed, and
    its top kernel names by category printed (host_other's too)."""
    caps = (line.get("obs") or {}).get("captures") or []
    if len(caps) != 1:
        fail(f"[phase 28 {tag}] expected one capture window, got {caps}")
    cap = caps[0]
    print(f"[phase 28 {tag}] window steps {cap['start_step']}.."
          f"{cap['stop_step'] - 1} ({cap['trigger']}): ok {cap['ok']}, "
          f"{cap.get('error') or ''}{cap.get('attrib_error') or ''}",
          flush=True)
    if not cap["ok"] or "attrib_error" in cap or "attrib" not in cap:
        fail(f"[phase 28 {tag}] capture window failed: {cap}")
    a = cap["attrib"]
    for c, d in a["categories"].items():
        print(f"[phase 28 {tag}]   {c}: {d['s']:.5f} s ({100 * d['frac']:.2f}%"
              f" of {a['total_device_s']:.5f} s device time): "
              f"{cap['top'].get(c, [])}", flush=True)
    print(f"[phase 28 {tag}]   host_other top names: "
          f"{cap['top'].get('host_other', [])}; mfu {a.get('mfu')}",
          flush=True)
    other = a["categories"].get("host_other", {"frac": 0.0})["frac"]
    if other >= OBS_HOST_OTHER_MAX:
        fail(f"[phase 28 {tag}] host_other is {other:.4f} of device time "
             f"(limit {OBS_HOST_OTHER_MAX})")
    return cap


def _phase_sum(tag, line):
    s = sum(line[f"{p}_s"] for p in ("data_wait", "h2d", "dispatch",
                                     "device", "ckpt"))
    print(f"[phase 28 {tag}] phases data_wait {line['data_wait_s']} h2d "
          f"{line['h2d_s']} dispatch {line['dispatch_s']} device "
          f"{line['device_s']} ckpt {line['ckpt_s']}: sum {s:.4f} s of "
          f"{line['seconds']} s (capture windows {line['obs']['capture_s']}"
          f" s, outside the timed region)", flush=True)
    if abs(s - line["seconds"]) > OBS_PHASE_TOL * line["seconds"]:
        fail(f"[phase 28 {tag}] the phase columns sum to {s:.4f} s, not "
             f"within {OBS_PHASE_TOL:.0%} of {line['seconds']} s")


def _exact(tag, n, per_step, steps):
    want = {k: per_step.get(k, 0) * steps for k in n}
    if n != want:
        fail(f"[phase 28 {tag}] kernel launches {n}, expected {want}")


def _has_kernels(tag, cap, cat, names):
    tops = cap["top"].get(cat, [])
    missing = [n for n in names if not any(n in t for t in tops)]
    if missing:
        fail(f"[phase 28 {tag}] {cat} lacks {missing}: {tops}")


OBS_OOM_CHILD = ("import sys, torch\n"
                 "if torch.cuda.is_available():\n"
                 "    torch.cuda.set_per_process_memory_fraction({frac})\n"
                 "from bigdl_tpu_torch.cli import perf\n"
                 "perf.main(sys.argv[1:])\n")


def obs_oom_start(tmp):
    """Phase 28 (f), started (it runs beside (a)-(e)): a process running
    ``cli.perf -m resnet50 --obs --traceDir D`` at a batch that overflows
    its allocator's cap (``OBS_OOM_FRACTION`` of the card). Returns the
    handle :func:`obs_oom_finish` takes."""
    d = os.path.join(tmp, "f")
    name, b = OBS_OOM
    proc = subprocess.Popen(
        [sys.executable, "-c", OBS_OOM_CHILD.format(frac=OBS_OOM_FRACTION),
         "-m", name, "-b", str(b), "-i", "1", "--obs", "--traceDir", d]
        + OBS_PLATFORM, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, d, time.perf_counter()


def obs_oom_finish(handle):
    """Phase 28 (f), waited for: the process must exit non-zero on the
    allocator's OOM and leave the report with the plan and the largest
    live tensors."""
    from bigdl_tpu_torch.obs import memory

    proc, d, t0 = handle
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    name, b = OBS_OOM
    path = os.path.join(d, memory.OOM_REPORT_NAME)
    rep = {}
    if os.path.exists(path):
        with open(path) as f:
            rep = json.load(f)
    top = rep.get("top_live_buffers") or []
    print(f"[phase 28 (f)] cli.perf -m {name} -b {b} --obs under an "
          f"allocator cap of {OBS_OOM_FRACTION} of the card: exit "
          f"{proc.returncode} {time.perf_counter() - t0:.1f}s after its "
          f"start; "
          f"report {'written' if rep else None}: context "
          f"{rep.get('context')}, error {str(rep.get('error'))[:160]!r}, "
          f"plan total {(rep.get('plan') or {}).get('total_bytes')}, "
          f"{len(top)} top live buffers (largest {top[:2]})", flush=True)
    if proc.returncode == 0 or not rep.get("plan") or not top:
        fail(f"[phase 28 (f)] no OOM report: {out[-2500:]}")


def obs_runs(torch, card):
    """Phase 28: the observability layer at full width. Returns (rows,
    [launches of each main-path run])."""
    import math
    import tempfile

    from bigdl_tpu_torch.cli import main as cli_main
    from bigdl_tpu_torch.obs import memory
    from bigdl_tpu_torch.utils import kineto

    t_phase = time.perf_counter()
    rows, launches = {}, []
    total = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as tmp:
        # (f) starts first: its process spends its first ~20 s importing
        # (host work on one core), so its card work comes after (b)
        oom = obs_oom_start(tmp)
        try:
            # (a) ResNet-50 _fba, obs-off then obs-on
            name, b, iters, spec = OBS_RESNET
            base = ["-m", name, "-b", str(b), "-i", str(iters)]
            off, n_off = _obs_perf(torch, base)
            d = os.path.join(tmp, "a")
            line, n = _obs_perf(torch, base + [
                "--obs", "--traceDir", d, "--traceSteps", spec,
                "--metricsPort", "0"])
            launches += [n_off, n]
            for tag, ln, k in (("(a) off", off, n_off),
                               ("(a) --obs", line, n)):
                finite = all(math.isfinite(v) for v in ln["losses"])
                print(f"[phase 28 {tag}] cli.perf -m {name} -b {b} -i "
                      f"{iters} on {card}: {ln['records_per_second']} "
                      f"images/s ({ln['seconds']} s), losses finite "
                      f"{finite}; launches "
                      f"{ {x: v for x, v in k.items() if v} }", flush=True)
            for k_ in (n_off, n):
                _exact("(a)", k_, {"bn_fwd_apply": 53, "bn_bwd_fused": 53},
                       2 + iters)
            cap = _window("(a)", line)
            _has_kernels("(a)", cap, "bn_norm", ["bn_coop_kernel"])
            if not cap["attrib"]["categories"].get("conv", {}).get("s"):
                fail(f"[phase 28 (a)] no conv time: {cap['attrib']}")
            _phase_sum("(a)", line)
            with urllib.request.urlopen(line["obs"]["metrics_url"],
                                        timeout=30) as r:
                page = r.read().decode()
            for want in ("train_phase_dispatch_ms_bucket", "hbm_bytes_in_use",
                         "attrib_"):
                if want not in page:
                    fail(f"[phase 28 (a)] /metrics lacks {want}")
            mem = line["mem"]
            print(f"[phase 28 (a)] hbm_peak_bytes {line['hbm_peak_bytes']} of "
                  f"{total} (headroom {line['hbm_headroom_frac']}), source "
                  f"{mem['source']}; plan {mem['categories']} total "
                  f"{mem['total_bytes']} (the allocator's peak over the "
                  f"warm-up, less what was held before the model)", flush=True)
            if mem["source"] != "live" \
                    or not 0 < line["hbm_peak_bytes"] <= total:
                fail(f"[phase 28 (a)] memory columns {mem}")
            for p_ in ("records_per_second", "seconds"):
                rows[f"(a) {name} b{b} {p_} off / --obs"] = (off[p_], line[p_])
            # the bytes (a)'s run held at its peak: the process's peak less
            # what the script held before (a)'s model
            base_a = (mem.get("live") or {}).get("base_bytes", 0)
            peak_a = line["hbm_peak_bytes"] - base_a

            # (b) the 1k LM, graphed, obs-off then obs-on
            name, b, k, iters, spec = OBS_LM
            base = ["-m", name, "-b", str(b), "--innerSteps", str(k), "-i",
                    str(iters)]
            off, n_off = _obs_perf(torch, base)
            line, n = _obs_perf(torch, base + [
                "--obs", "--traceDir", os.path.join(tmp, "b"), "--traceSteps",
                spec])
            launches += [n_off, n]
            for tag, ln, kk in (("(b) off", off, n_off),
                                ("(b) --obs", line, n)):
                print(f"[phase 28 {tag}] cli.perf -m {name} -b {b} "
                      f"--innerSteps {k} -i {iters} on {card}: "
                      f"{ln['tokens_per_second']} tokens/s ({ln['seconds']} "
                      f"s), mfu {ln['mfu']}; launches "
                      f"{ {x: v for x, v in kk.items() if v} }", flush=True)
            for k_ in (n_off, n):
                _exact("(b)", k_, {"flash_fwd": 12, "flash_dq": 12,
                                   "flash_dkv": 12}, k * (2 + iters))
            cap = _window("(b)", line)
            _has_kernels("(b)", cap, "attention", ["flash_fwd", "flash_dq",
                                                   "flash_dkv"])
            _phase_sum("(b)", line)
            mfu_dev = cap["attrib"]["mfu"]["mfu_device"]
            print(f"[phase 28 (b)] mfu_device {mfu_dev} against the line's "
                  f"mfu {line['mfu']}", flush=True)
            if mfu_dev < 0.9 * line["mfu"]:
                fail(f"[phase 28 (b)] mfu_device {mfu_dev} < 0.9 x "
                     f"{line['mfu']}")
            for p_ in ("tokens_per_second", "seconds"):
                rows[f"(b) {name} b{b} x{k} graphed {p_} off / --obs"] = (
                    off[p_], line[p_])

            _free(torch)
            # (c) the CIFAR training CLI through the Optimizer
            from bigdl_tpu_torch import obs
            from bigdl_tpu_torch.cli import resnet as resnet_cli

            cifar = os.path.join(tmp, "cifar")
            os.makedirs(cifar)
            write_cifar(cifar, CIFAR_RECORDS)
            dc = os.path.join(tmp, "c")
            obs.disable()
            obs.reset_registry()
            _, n = io_quiet(lambda: _launched(torch, lambda: resnet_cli.main([
                "train", "--dataset", "cifar10", "-f", cifar, "--fusedBN",
                "apply", "-b", str(CIFAR_BATCH), "--maxEpoch", "1", "--obs",
                "--traceDir", dc, "--traceSteps", "2@2"] + OBS_PLATFORM)))
            obs.disable()
            launches.append(n)
            with open(os.path.join(dc, "spans.trace.json")) as f:
                spans = {e["name"] for e in json.load(f)["traceEvents"]}
            trace = kineto.find_trace(os.path.join(dc, "capture_2"))
            planes = kineto.parse_trace(trace) if trace else []
            dev = kineto.device_planes(planes)
            totals = kineto.op_totals(dev)
            kern = sorted(totals, key=lambda s: -totals[s]["total_ps"])[:3]
            print(f"[phase 28 (c)] cli.resnet train --dataset cifar10 --obs "
                  f"--traceSteps 2@2 on {card}: spans {sorted(spans)}; window "
                  f"{trace}: {len(dev)} device plane(s), "
                  f"{len(totals)} kernel names (costliest {kern}); "
                  f"launches { {x: v for x, v in n.items() if v} }",
                  flush=True)
            if not {"data_wait", "h2d", "dispatch", "device"} <= spans \
                    or not dev or not any(ln.events for p in dev
                                          for ln in p.lines):
                fail("[phase 28 (c)] the Optimizer's spans or window are "
                     "missing")

            # (d) ResNet-50 _fbn: the stats pair attributed
            name, b, iters, spec = OBS_FBN
            line, n = _obs_perf(torch, ["-m", name, "-b", str(b), "-i",
                                        str(iters), "--obs", "--traceDir",
                                        os.path.join(tmp, "d"), "--traceSteps",
                                        spec])
            launches.append(n)
            print(f"[phase 28 (d)] cli.perf -m {name} -b {b} -i {iters} --obs "
                  f"on {card}: {line['records_per_second']} images/s; "
                  f"launches "
                  f"{ {x: v for x, v in n.items() if v} }", flush=True)
            _exact("(d)", n, {"bn_stats": 53, "bn_bwd_stats": 53}, 2 + iters)
            cap = _window("(d)", line)
            _has_kernels("(d)", cap, "bn_norm", ["bn_coop_kernel"])

            # (e) the memory forecast against (a)'s live peak
            _free(torch)
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, n = _launched(torch, lambda: cli_main.main([
                    "explain", "--mem", OBS_RESNET[0], "-b",
                    str(OBS_MEM_BATCH),
                    "--json"] + OBS_PLATFORM))
            launches.append(n)
            plan = json.loads(buf.getvalue().strip().splitlines()[-1])
            fc = plan["forecast"]
            b_a = OBS_RESNET[1]
            pred = fc["fixed_bytes"] + fc["bytes_per_sample"] * b_a
            print(f"[phase 28 (e)] explain --mem {OBS_RESNET[0]} -b "
                  f"{OBS_MEM_BATCH} on {card}: plan {plan['categories']} "
                  f"total "
                  f"{plan['total_bytes']} (b{OBS_MEM_BATCH}), "
                  f"{plan['plan_2x']['total_bytes']} (b{2 * OBS_MEM_BATCH}); "
                  f"{fc['bytes_per_sample']} B a sample, fixed "
                  f"{fc['fixed_bytes']}, predicted max batch "
                  f"{fc['predicted_max_batch']}; predicted at b{b_a} {pred} "
                  f"against (a)'s hbm_peak_bytes less the {base_a} bytes held "
                  f"before its model, {peak_a} ({pred / peak_a:.3f})",
                  flush=True)
            if abs(pred - peak_a) > OBS_MEM_TOL * peak_a:
                fail(f"[phase 28 (e)] predicted {pred} not within "
                     f"{OBS_MEM_TOL:.0%} of {peak_a}")
            rows["(e) predicted / measured peak at b128"] = round(
                pred / peak_a, 3)

        except BaseException:
            oom[0].kill()  # a failed check stops the process too
            oom[0].wait()
            raise
        # (f) a batch that does not fit: the OOM autopsy
        obs_oom_finish(oom)
    rows["phase 28 s"] = round(time.perf_counter() - t_phase, 1)
    return rows, launches


# ------------------------------------------------------------------ phase 30
# the lint (bigdl_tpu_torch.analysis, cli/lint.py) on the card's machine.
# (a)'s lint CLI runs, in one child process through cli.main (JSON files
# read back): the rule set the JAX CLI's `lint resnet50` gives, less the
# stated differences (every BN shape takes the kernels; a 0-d f32 constant
# does not promote) plus the in-place update
LINT_R50_RULES = {"fusion-bn-unfused", "dtype-upcast", "fusion-conv-gemm",
                  "layout-c128", "donate-ok"}
LINT_CASES = (
    ("resnet50", ["resnet50", "-b", "128"]),
    ("resnet50 tuned", ["resnet50", "-b", "128", "--fusedBN", "apply",
                        "--convLayout", "GEMM,GEMM,GEMM"]),
    ("flagship", [MODEL, "--strategy", "tp:2", "--gradCompress", "bf16",
                  "--quantize", "int8+kv8", "--kvPageTokens", "128",
                  "--speculate", "4", "--strict"]),
    # argument-side trees past the card's memory: the rule reads the
    # card's total_memory
    ("hbm", ["resnet50", "-b", "300000", "--no-trace"]),
)
# the mis-sharded tp:3 LM of the JAX package's shardlint test, as its own
# `python -m bigdl_tpu_torch.cli.main lint` process: exit code 2
LINT_MISSHARDED = ["transformer_lm", "--strategy", "tp:3", "--strict"]
# (b)'s rows: the kernel sites one traced step records, against the
# launches phase 19 counted a step
LINT_SITE_ROWS = (("resnet50_fba", 128), (MODEL, 8))


def lint_child(workdir):
    """Phase 30 (a), in a child process: LINT_CASES through ``cli.main
    lint``, each with ``--json``, then LINT_SITE_ROWS' kernel sites of one
    traced step (``analysis.trace_train_step`` on a meta build). Prints
    one JSON object: each case's exit code, seconds and report; each
    row's sites by kernel; this process's kernel launches (none)."""
    import contextlib
    import io
    from collections import Counter

    import torch

    from bigdl_tpu_torch import analysis, ops
    from bigdl_tpu_torch.analysis import fx_walk
    from bigdl_tpu_torch.cli import main as cli_main
    from bigdl_tpu_torch.cli import perf

    out = {"cases": {}, "sites": {}}
    for tag, argv in LINT_CASES:
        path = os.path.join(workdir, tag.replace(" ", "_") + ".json")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main.main(["lint"] + argv + ["--json", path])
        with open(path) as f:
            out["cases"][tag] = {"rc": rc, "report": json.load(f),
                                 "s": round(time.perf_counter() - t0, 1)}
    for name, batch in LINT_SITE_ROWS:
        t0 = time.perf_counter()
        with torch.device("meta"):
            model, in_shape = perf.build_model(name)
        graph = analysis.trace_train_step(
            model, in_shape, batch, is_lm=name in perf.LM_CONFIGS)
        out["sites"][name] = dict(Counter(
            s.kernel for s in fx_walk.kernel_sites(graph)))
        out["sites"][name + " s"] = round(time.perf_counter() - t0, 1)
    out["launches"] = ops.kernel_launches()
    print(json.dumps(out), flush=True)


def lint_start():
    """Phase 30 (a), started beside phase 27: :func:`lint_child` and the
    mis-sharded ``python -m bigdl_tpu_torch.cli.main lint`` process, each
    on a thread (the lint traces on the CPU). Returns the handle
    :func:`lint_finish` takes."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="phase30_")
    env = dict(os.environ, PYTHONPATH=here)
    state = {"t0": time.perf_counter()}

    def run(key, argv):
        t0 = time.perf_counter()
        try:
            state[key] = subprocess.run(argv, capture_output=True,
                                        text=True, env=env, cwd=here,
                                        timeout=900)
        except BaseException as e:  # reported by lint_finish
            state[key + " error"] = repr(e)
        state[key + " s"] = round(time.perf_counter() - t0, 1)

    threads = [threading.Thread(target=run, args=a, daemon=True) for a in (
        ("child", [sys.executable, "-c",
                   f"import chip_smoke; chip_smoke.lint_child({tmp!r})"]),
        ("missharded", [sys.executable, "-m", "bigdl_tpu_torch.cli.main",
                        "lint"] + LINT_MISSHARDED))]
    for t in threads:
        t.start()
    return threads, state, tmp


def lint_finish(torch, card, handle, linted):
    """Phase 30 (a) and (b)'s sites, checked: the resnet50 rule set, the
    tuned config free of fusion findings, the flagship tp:2 config and
    the hbm case's rule reading the card's total_memory, the tp:3 process
    exiting 2 on shard rules, no launch in the lint's process, and each
    of ``linted``'s rows (phase 19's launches a step and its line's
    ``lint``) launching what the lint's trace recorded a step. Returns
    rows."""
    import shutil

    threads, state, tmp = handle
    t_wait = time.perf_counter()
    for t in threads:
        t.join()
    wait = time.perf_counter() - t_wait
    shutil.rmtree(tmp, ignore_errors=True)
    for key in ("child", "missharded"):
        if key + " error" in state:
            fail(f"[phase 30 (a)] {key}: {state[key + ' error']}")
    child = state["child"]
    if child.returncode != 0:
        fail(f"[phase 30 (a)] the lint process exited {child.returncode}: "
             f"{child.stderr[-3000:]}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    cases = res["cases"]
    for tag, c in cases.items():
        rules = sorted({f["rule"] for f in c["report"]["findings"]})
        print(f"[phase 30 (a)] lint {' '.join(dict(LINT_CASES)[tag])}: rc "
              f"{c['rc']}, {c['report']['summary']}, {c['s']}s on the CPU "
              f"beside phase 27 ({card}): {rules}", flush=True)
    r50 = {f["rule"] for f in cases["resnet50"]["report"]["findings"]}
    tuned = cases["resnet50 tuned"]["report"]
    if r50 != LINT_R50_RULES or cases["resnet50"]["rc"] != 0:
        fail(f"[phase 30 (a)] resnet50's rules {sorted(r50)}, expected "
             f"{sorted(LINT_R50_RULES)}")
    if tuned["summary"]["errors"] or any(
            f["family"] == "fusion" for f in tuned["findings"]):
        fail(f"[phase 30 (a)] the tuned resnet50 config: {tuned}")
    if cases["flagship"]["rc"] != 0:
        fail(f"[phase 30 (a)] the flagship tp:2 config exited "
             f"{cases['flagship']['rc']}: {cases['flagship']['report']}")
    hbm = [f for f in cases["hbm"]["report"]["findings"]
           if f["rule"] == "hbm-oversubscribed"]
    total = torch.cuda.get_device_properties(0).total_memory
    if not hbm or hbm[0]["detail"]["hbm_bytes"] != total:
        fail(f"[phase 30 (a)] hbm: {hbm}, the card's total_memory {total}")
    mis = state["missharded"]
    print(f"[phase 30 (a)] python -m bigdl_tpu_torch.cli.main lint "
          f"{' '.join(LINT_MISSHARDED)}: exit code {mis.returncode}, "
          f"{state['missharded s']}s; the hbm rule read total_memory "
          f"{total} bytes of {card}", flush=True)
    if mis.returncode != 2 or "shard-" not in mis.stdout:
        fail(f"[phase 30 (a)] the tp:3 lint exited {mis.returncode}: "
             f"{mis.stdout[-2000:]} {mis.stderr[-2000:]}")
    if any(res["launches"].values()):
        fail(f"[phase 30 (a)] the lint's process launched {res['launches']}")
    for name, _ in LINT_SITE_ROWS:
        sites, got = res["sites"][name], linted[name]["launches_a_step"]
        print(f"[phase 30 (b)] {name}: kernel sites a traced step {sites} "
              f"({res['sites'][name + ' s']}s); launches a step on the card "
              f"{got} (phase 19, its pre-flight's lint "
              f"{linted[name]['lint']}) ({card})", flush=True)
        if sites != got:
            fail(f"[phase 30 (b)] {name}: the lint recorded {sites} a "
                 f"step, the card launched {got}")
    print(f"[phase 30] (a) beside phase 27: {state['child s']}s and "
          f"{state['missharded s']}s, waited {wait:.1f}s in line", flush=True)
    return {"(a) lint process s": state["child s"],
            "(a) tp:3 process s": state["missharded s"],
            "(a) wait in line s": round(wait, 1)}


# ------------------------------------------------------------------ phase 29
# predict and batch-predict: bulk scoring over record shards of seeded
# JPEGs, kill and resume, image tp serving, the provenance core
BULK_VIT = ("vit_s16", 64, 8, 34)        # (a): model, -b, classes, a class
BULK_RESNET = ("resnet50", 128, 8, 53)   # (b): 424 = 3 batches + 40
BULK_EVERY = 2                           # (b)'s --checkpointEvery
TP_IMAGE = "resnet50"                    # (c), f32, on phase 26's job
TP_IMAGE_STRATEGIES = ("tp:2", "dp:2+tp:2")
TP_IMAGE_ROWS = 4                        # (c)'s /predict rows, 2 a batch
TP_IMAGE_TOL = 1e-4                      # (c): of max|score| of one process
PREDICT_IMAGES, PREDICT_BATCH = 20, 8    # (d): images (2 classes), -b
BULK_DEVICES, BULK_STAGE = "cuda:0,cuda:0", "device"  # (a)'s replicas
BULK_PLATFORM = []  # ["--platform", "cpu"] to rehearse on the CPU
# (b)'s child: batch-predict, SIGKILLed by itself once its first cursor is
# written and one more batch's lines are in a shard (flushed), so the
# resume truncates them
BULK_CHILD = ("import os, signal, sys, torch\n"
              "torch.backends.cudnn.deterministic = True\n"
              "torch.backends.cuda.matmul.allow_tf32 = False\n"
              "torch.backends.cudnn.allow_tf32 = False\n"
              "from bigdl_tpu_torch.serving import bulk\n"
              "save, write = bulk.save_cursor, bulk.ShardSink.write_batch\n"
              "def save_cursor(*a, **k):\n"
              "    save(*a, **k)\n"
              "    bulk.saved = True\n"
              "def write_batch(self, *a, **k):\n"
              "    n = write(self, *a, **k)\n"
              "    if getattr(bulk, 'saved', False):\n"
              "        self._f.flush()\n"
              "        os.kill(os.getpid(), signal.SIGKILL)\n"
              "    return n\n"
              "bulk.save_cursor = save_cursor\n"
              "bulk.ShardSink.write_batch = write_batch\n"
              "from bigdl_tpu_torch.cli import batch_predict\n"
              "batch_predict.main(sys.argv[1:])\n")


def _tp_image_rows():
    import numpy as np
    return np.random.RandomState(29).randn(TP_IMAGE_ROWS, 224, 224,
                                           3).astype(np.float32)


def _tp_image_tag(strategy):
    return "tp_image_" + strategy.replace(":", "").replace("+", "_")


def _bulk_argv(row, shards, out):
    name, b, _, _ = row
    return (["--modelName", name, "-b", str(b), "--randomInit", "-f",
             "record:" + shards, "--out", out, "--dataWorkers", "4",
             "--obs"] + BULK_PLATFORM)


def bulk_start():
    """Phase 29's data and (b)'s killed child, started on a thread beside
    phase 27 (:func:`bulk_data`). Returns the handle :func:`bulk_runs`
    takes."""
    import tempfile

    h = {"dir": tempfile.mkdtemp(prefix="phase29_")}

    def run():
        try:
            bulk_data(h)
        except BaseException as e:  # reported by the phase
            h["error"] = repr(e)

    h["thread"] = threading.Thread(target=run, daemon=True)
    h["thread"].start()
    return h


def bulk_data(h):
    """Seeded 256 x 256 JPEGs (write_jpeg_folder) as record shards for (a)
    and (b) (``write_image_shards``), a folder for (d), in ``h["dir"]``;
    then (b)'s child, which SIGKILLs itself after its first cursor."""
    from bigdl_tpu_torch.dataset.recordfile import write_image_shards

    t0 = time.perf_counter()
    d = h["dir"]
    for key, (_, _, classes, per) in (("a", BULK_VIT), ("b", BULK_RESNET)):
        root = os.path.join(d, f"jpeg_{key}")
        write_jpeg_folder(root, seed=29, splits=(("all", per),),
                          classes=classes)
        h[key] = os.path.join(d, f"shards_{key}")
        write_image_shards(os.path.join(root, "all"), h[key],
                           images_per_shard=128)
    write_jpeg_folder(os.path.join(d, "jpeg_d"), seed=30,
                      splits=(("all", PREDICT_IMAGES // 2),), classes=2)
    h["data_s"] = round(time.perf_counter() - t0, 1)
    h["killed"] = os.path.join(d, "b_killed")
    h["log"] = os.path.join(d, "b_child.log")
    h["t0"] = time.perf_counter()
    with open(h["log"], "w") as log:  # a file: a pipe could fill and block
        h["proc"] = subprocess.Popen(
            [sys.executable, "-c", BULK_CHILD]
            + _bulk_argv(BULK_RESNET, h["b"], h["killed"])
            + ["--checkpointEvery", str(BULK_EVERY)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=log, stderr=subprocess.STDOUT)


def _shard_bytes(out):
    from bigdl_tpu_torch.serving import bulk
    got = {}
    for name in sorted(os.listdir(out)):
        if name.startswith("scores-") or name == bulk.CURSOR_FILE:
            with open(os.path.join(out, name), "rb") as f:
                got[name] = f.read()
    return got


def _maxd(a, b):
    import numpy as np
    return float(np.abs(a - b).max()) if a.shape == b.shape else None


def _bulk_reference(torch, row, shards):
    """Phase 29 (a)'s reference: an engine built by hand (the same seeded
    weights, graphed, the two buckets the run's batches and tail take)
    driven over the eval-mode source in the plan's chunks."""
    import numpy as np

    from bigdl_tpu_torch.cli import batch_predict
    from bigdl_tpu_torch.cli.perf import _short_side, build_model
    from bigdl_tpu_torch.dataset.pipeline import StreamingSampleSource
    from bigdl_tpu_torch.dataset.streaming import RecordImageDataSet
    from bigdl_tpu_torch.serving import InferenceEngine

    name, b, classes, per = row
    n = classes * per
    tail = n % b
    model, size = build_model(name, class_num=1000)  # batch-predict's
    eng = InferenceEngine(model, buckets=(1 << (tail - 1).bit_length(), b),
                          device=DEV)
    eng.warmup(size, np.float32)
    crop = tuple(size[:2])
    src = StreamingSampleSource(RecordImageDataSet(
        shards, batch_size=b, crop=crop, train=False,
        short_side=_short_side(crop), mean=list(batch_predict.RECORD_MEAN),
        std=list(batch_predict.RECORD_STD), n_threads=1, window=1))
    try:
        return np.concatenate([
            np.asarray(eng.predict_scores(src.collate(
                [src.load(i, 0) for i in range(s, min(s + b, n))]).input),
                np.float64) for s in range(0, n, b)])
    finally:
        eng.close()


def bulk_runs(torch, card, h, tp_state):
    """Phase 29: batch-predict, predict, image tp serving, provenance.
    Returns (rows, [launches of each main-path run])."""
    import contextlib
    import io

    import numpy as np

    from bigdl_tpu_torch.cli import batch_predict, predict
    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.interop.checkpoint import save_model
    from bigdl_tpu_torch.serving import bulk
    from bigdl_tpu_torch.utils.file import save_module

    t_phase = time.perf_counter()
    h["thread"].join()
    if "error" in h:
        fail(f"[phase 29] writing the data or starting (b)'s child: "
             f"{h['error']}")
    rows, launches, d = {}, [], h["dir"]
    _free(torch)

    # (a) ViT-S/16 over 2 replicas on the card, device-staged
    name, b, classes, per = BULK_VIT
    n = classes * per
    out = os.path.join(d, "a")
    rep, got_n = io_quiet(lambda: _launched(torch, lambda: batch_predict.main(
        _bulk_argv(BULK_VIT, h["a"], out) + [
            "--strategy", "dp:2", "--devices", BULK_DEVICES, "--stage",
            BULK_STAGE, "--scores"])))
    launches.append(got_n)
    merged = bulk.merge_shards(out)
    cover = [r["i"] for r in merged] == list(range(n))
    ref = _bulk_reference(torch, BULK_VIT, h["a"])
    got = np.asarray([r["scores"] for r in merged], np.float64)
    same = got.shape == ref.shape and np.array_equal(got, ref)
    print(f"[phase 29 (a)] batch-predict --modelName {name} -b {b} "
          f"--strategy dp:2 --devices {BULK_DEVICES} --dataWorkers 4 --stage "
          f"{BULK_STAGE} --scores on {card}: {rep['records']} records in "
          f"{rep['batches']} batches ({n % b} in the tail), shard lines "
          f"{[sum(1 for _ in open(p)) for p in rep['shards']]}, every record "
          f"once: {cover}; scores equal an engine driven by hand, bit for "
          f"bit: {same} (max|d| "
          f"{_maxd(got, ref)}); {rep['images_per_second']} images/s, "
          f"stall_frac "
          f"{rep['stall_frac']}, data_wait {rep['data_wait_s']}s, device "
          f"{rep['device_s']}s of {rep['seconds']}s; flash_fwd launches "
          f"{got_n['flash_fwd']}", flush=True)
    if not (cover and same and got_n["flash_fwd"] > 0
            and rep["groups"] == 2):
        fail(f"[phase 29 (a)] coverage {cover}, bit-equal {same}, launches "
             f"{got_n}")
    rows["(a) images/s"] = rep["images_per_second"]
    rows["(a) stall_frac"] = rep["stall_frac"]
    _free(torch)

    # (b) the killed child resumed here, against an uninterrupted run
    name, b, classes, per = BULK_RESNET
    n = classes * per
    argv = ["--checkpointEvery", str(BULK_EVERY)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        full = io_quiet(lambda: _launched(torch, lambda: batch_predict.main(
            _bulk_argv(BULK_RESNET, h["b"], os.path.join(d, "b_full"))
            + argv)))[0]
        try:
            h["proc"].wait(timeout=600)
        except subprocess.TimeoutExpired:
            h["proc"].kill()
            h["proc"].wait()
        child_s = time.perf_counter() - h["t0"]
        with open(h["log"]) as f:
            log = f.read()
        cur = bulk.load_cursor(h["killed"]) or {}
        past = sum(os.path.getsize(p) for p in bulk.shard_paths(
            h["killed"], 1)) - sum(cur.get("offsets", [0]))
        res, res_n = io_quiet(lambda: _launched(
            torch, lambda: batch_predict.main(
                _bulk_argv(BULK_RESNET, h["b"], h["killed"]) + argv)))
        launches.append(res_n)
    finally:
        torch.backends.cudnn.deterministic = det
    equal = _shard_bytes(h["killed"]) == _shard_bytes(
        os.path.join(d, "b_full"))
    cover = [r["i"] for r in bulk.merge_shards(h["killed"])] == \
        list(range(n))
    print(f"[phase 29 (b)] batch-predict --modelName {name} -b {b} "
          f"--checkpointEvery {BULK_EVERY} over {n} records on {card}: the "
          f"child exited {h['proc'].returncode} {child_s:.1f}s after its "
          f"start, its cursor at batch {cur.get('next_batch')} with {past} "
          f"bytes past it; the resume started at batch "
          f"{res['resumed_from_batch']}, scored "
          f"{res['records_scored_this_run']} records; shards and cursor "
          f"byte-identical to the "
          f"uninterrupted run: {equal}; every record once: {cover}; "
          f"uninterrupted {full['images_per_second']} images/s, stall_frac "
          f"{full['stall_frac']}; resume {res['images_per_second']} "
          f"images/s, stall_frac {res['stall_frac']}", flush=True)
    if h["proc"].returncode != -9 or cur.get("next_batch") != BULK_EVERY \
            or past <= 0 or res["resumed_from_batch"] != BULK_EVERY \
            or not equal or not cover:
        fail(f"[phase 29 (b)] killed child or resume wrong: {log[-2500:]}")
    rows["(b) images/s"] = full["images_per_second"]
    rows["(b) stall_frac"] = full["stall_frac"]
    _free(torch)

    # (c) and (e): phase 26's job served TP_IMAGE at tp:2 and dp:2+tp:2
    x = _tp_image_rows()
    model = build_model(TP_IMAGE, class_num=1000)[0].to(DEV).eval()
    with torch.no_grad():
        ref = torch.cat([model(torch.from_numpy(x[i:i + 2]).to(DEV))
                         for i in range(0, len(x), 2)]).float().cpu().numpy()
    del model
    _free(torch)
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > TP_IMAGE_TOL * scale
    for strat in TP_IMAGE_STRATEGIES:
        tag = _tp_image_tag(strat)
        got = np.load(os.path.join(tp_state["dir"], f"{tag}.npy"))
        err = float(np.abs(got - ref).max())
        preds = bool((got.argmax(-1)[sure] == ref.argmax(-1)[sure]).all())
        with open(os.path.join(tp_state["dir"], f"{tag}.metrics")) as f:
            info = next((ln for ln in f.read().splitlines()
                         if ln.startswith("bigdl_serving_info")), "")
        core = {k: re.search(k + r'="([^"]*)"', info) for k in (
            "bn_fused", "autotune", "conv_layouts", "conv_geom_decisions",
            "strategy", "serving_tp")}
        core = {k: m.group(1) if m else None for k, m in core.items()}
        print(f"[phase 29 (c)] serve {TP_IMAGE} --strategy {strat} f32 on 2 "
              f"gloo ranks sharing {card}: /predict of {len(x)} rows, "
              f"max|d| {err:.4g} against one process (bound "
              f"{TP_IMAGE_TOL} x max|score| {scale:.4g}); preds equal where "
              f"the top-2 margin exceeds it ({int(sure.sum())} rows): "
              f"{preds}", flush=True)
        print(f"[phase 29 (e)] /metrics provenance of {strat}: {core}",
              flush=True)
        if err > TP_IMAGE_TOL * scale or not preds:
            fail(f"[phase 29 (c)] {strat}: max|d| {err}, preds {preds}")
        if None in core.values() or core["strategy"] != strat \
                or core["bn_fused"] != "off":
            fail(f"[phase 29 (e)] {strat}: provenance {info[:600]}")
        rows[f"(c) {strat} max|d|"] = err

    # (d) predict: a save_module file against a --modelName rebuild
    model = build_model("resnet50")[0]
    f_mod, f_w = os.path.join(d, "resnet50.module"), os.path.join(
        d, "resnet50.weights")
    save_module(model, f_mod)
    save_model(f_w, model)
    del model
    lines = []
    for f_ in (f_mod, f_w):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            (_, n_d) = _launched(torch, lambda: predict.main(
                ["--model", f_, "--modelName", "resnet50", "-f",
                 os.path.join(d, "jpeg_d", "all"), "-b", str(PREDICT_BATCH),
                 "--topN", "5"] + BULK_PLATFORM))
        launches.append(n_d)
        lines.append([ln for ln in buf.getvalue().splitlines() if "\t" in ln])
    print(f"[phase 29 (d)] predict --modelName resnet50 -b {PREDICT_BATCH} "
          f"--topN 5 over {PREDICT_IMAGES} JPEGs on {card}: the save_module "
          f"file's lines equal the rebuild's: {lines[0] == lines[1]} "
          f"({len(lines[0])} lines; first {lines[0][:1]})", flush=True)
    if lines[0] != lines[1] or len(lines[0]) != PREDICT_IMAGES:
        fail(f"[phase 29 (d)] {lines}")
    rows["data s"] = h["data_s"]
    rows["phase 29 s"] = round(time.perf_counter() - t_phase, 1)
    return rows, launches


# main's phase functions, each timed ("[time] name: s" after it returns)
TIMED_PHASES = ("check_flash", "check_flash_bwd", "check_bn", "train_run",
                "grads_check", "cli_runs", "serve_run", "paged_serve_run",
                "spec_quant_serve_run", "resnet_runs", "bn_grads_check",
                "inner_steps_runs", "cifar_cli_run", "graphed_optimizer_runs",
                "resume_runs", "pipeline_runs", "baseline_runs",
                "inception_runs", "resnet_slice_runs", "dp_runs", "rnn_runs",
                "attention_slice_runs", "serving_front_runs", "tuning_runs",
                "recovery_runs", "tp_runs", "spe_runs", "obs_runs",
                "bulk_runs", "lint_finish")


def _time_phases(names=TIMED_PHASES):
    """Replace each of main's phase functions by one that prints its
    seconds: the script's time by phase."""
    g = globals()
    for name in names:
        def timed(*a, _fn=g[name], _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                print(f"[time] {_name}: {time.perf_counter() - t0:.1f}s",
                      flush=True)
        g[name] = timed


def _keep_bytecode(root):
    """Keep compiled bytecode under ``root/build/pycache``, for this
    process and (through the environment) every process it starts. Where
    the environment sets ``PYTHONDONTWRITEBYTECODE`` and the installed
    packages hold no bytecode, each new process compiles torch, its
    compiler stack and the port from source: ~7 s of a ``cli.perf``
    process's 20 s start on an H100 host, and the script starts dozens."""
    d = os.path.join(root, "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = d
    sys.pycache_prefix = d
    sys.dont_write_bytecode = False


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this script needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.isdir(os.path.join(here, "bigdl_tpu_torch")):
        _keep_bytecode(here)
    sys.path.insert(0, here)
    try:
        from bigdl_tpu_torch.ops import _build
        from bigdl_tpu_torch.ops import attention_kernel as ak
    except ImportError as e:
        fail(f"the bigdl_tpu_torch package is not beside this script ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _time_phases()
    t_start = t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, info in _build.build_info().items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                           info["log"])]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill",
                                                info["log"]))
        print(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"of spill stores and loads", flush=True)
        if name == "flash_bwd":
            print_ptxas(info["log"], ("flash_dq_bf16", "flash_dkv_bf16"))
        if name == "flash_fwd":
            print_ptxas(info["log"], ("flash_fwd_sm90",))
        if name == "bn":
            print_ptxas_bn(info["log"])

    rows = check_flash(torch, ak)
    bwd_rows = check_flash_bwd(torch, ak)
    bn_rows = check_bn(torch)
    # the main paths, each driven with the counts set to 0 just before it
    # and read just after: LM training (perf, plain and remat), the LM
    # training CLI (plain and packed), serving (f32 and bf16), ResNet-50
    # training (perf, three BN modes), the CIFAR training CLI (graphed,
    # with its checkpoint tested), cli.perf's graphed rows, the Optimizer
    # eager and graphed, and resume; a graph's replays count as launches
    from bigdl_tpu_torch import ops
    launches = {name: 0 for name in ops.kernel_launches()}
    train, *train_n = train_run(torch, card)
    grads_check(torch, ak)
    for n in train_n + list(cli_runs(torch).values()):
        for name in launches:
            launches[name] += n[name]
    for bf16 in (False, True):
        n, lat, tps, _ = serve_run(torch, bf16)
        launches["flash_fwd"] += n
    paged_steps = {}
    for bf16 in (False, True):
        n, paged_steps[bf16], paged_served = paged_serve_run(torch, bf16,
                                                             card)
        launches["flash_fwd"] += n
    launches["flash_fwd"] += spec_quant_serve_run(torch, card, paged_served)
    resnet = resnet_runs(torch, card)
    bn_grads_check(torch)
    inner = inner_steps_runs(torch, card)
    for n in ([n for _, n in resnet.values()] + [cifar_cli_run(torch)]
              + [n for _, n in inner.values()]
              + graphed_optimizer_runs(torch, card)
              + resume_runs(torch, card)):
        for name in launches:
            launches[name] += n[name]
    pipe_rows, pipe_n = pipeline_runs(torch, card)
    for n in pipe_n:
        for name in launches:
            launches[name] += n[name]
    caffe = caffe_start()  # phase 18's caffemodel, beside 17
    base_rows, base_n, _ = baseline_runs(torch, card)
    slice_prep = slice_prep_start()  # phase 19's CPU work, beside 18
    inc_rows, inc_n, _ = inception_runs(torch, card, caffe)
    slice_rows, slice_n, linted = resnet_slice_runs(torch, card,
                                                    slice_prep)
    dp_rows, dp_n = dp_runs(torch, card, train["losses"])
    rnn_rows = rnn_runs(torch, card)
    attn_rows, attn_n, _ = attention_slice_runs(torch, card)
    front_rows, front_n = serving_front_runs(torch, card)
    launches["flash_fwd"] += front_n
    tune_rows, tune_n, untied_n = tuning_runs(torch, card)
    launches["flash_fwd"] += untied_n
    tp_started = tp_start()  # phase 26's gloo jobs, beside phase 25
    rec_rows, rec_n = recovery_runs(torch, card)
    tp_rows, tp_n = tp_runs(torch, card, tp_started)
    # phase 29's data and its killed child, beside phase 27
    bulk_started = bulk_start()
    # phase 27's paths (the ring, dense attention, the MoE) run no kernel
    lint_started = lint_start()  # phase 30 (a)'s lint processes
    spe_rows = spe_runs(torch, card)
    obs_rows, obs_n = obs_runs(torch, card)
    bulk_rows, bulk_n = bulk_runs(torch, card, bulk_started, tp_started)
    lint_rows = lint_finish(torch, card, lint_started, linted)
    for n in (base_n + inc_n + slice_n + dp_n + attn_n + tune_n + rec_n
              + obs_n + bulk_n):
        for name in launches:
            launches[name] += n[name]
    for n in tp_n:  # some counts name only the kernel they hold
        for name in launches:
            launches[name] += n.get(name, 0)
    print("[phase 19] BN launches by mode: " + ", ".join(
        f"{k} {sum(n[k] for n in slice_n)}" for k in
        ("bn_stats", "bn_bwd_stats", "bn_fwd_apply", "bn_bwd_fused")),
        flush=True)
    print(f"[bf16] {MODEL} on {card}: {tps:.1f} generated tokens/s over 4 "
          f"concurrent requests, /generate latencies ms "
          f"{[round(x, 1) for x in lat]} (prompts {list(PROMPT_LENS)}, "
          f"{MAX_NEW} new tokens each)", flush=True)
    for bf16, steps in paged_steps.items():
        print(f"[serve {'bf16' if bf16 else 'f32'}] {MODEL} decode step at "
              f"{PAGED_SLOTS} slots on {card}: " + ", ".join(
                  f"{kv} {mode} {r['step_ms']:.3f} ms "
                  f"({r['tokens_per_s']:.1f} tokens/s)"
                  for (kv, mode), r in steps.items()), flush=True)
    print(f"[train] {MODEL} bf16 batch {TRAIN_BATCH} on {card}: "
          f"{train['tokens_per_second']} tokens/s", flush=True)
    for name, (res, _) in resnet.items():
        print(f"[{name}] bf16 batch {RESNET_BATCH} on {card}: "
              f"{res['records_per_second']} images/s", flush=True)
    for tag, (res, _) in inner.items():
        rate = (f"{res['tokens_per_second']} tokens/s"
                if res["tokens_per_second"] else
                f"{res['records_per_second']} images/s")
        print(f"[innerSteps {OPT_K} {tag}] bf16 batch {res['batch']} on "
              f"{card}: {rate}", flush=True)

    for tag, r in pipe_rows.items():
        print(f"[pipeline] {tag} on {card}: "
              + (f"{r:.1f} images/s" if isinstance(r, float) else
                 ", ".join(f"{k} {v:.3f}" for k, v in r.items())),
              flush=True)

    for tag, r in {**base_rows, **inc_rows}.items():
        print(f"[baseline] {tag} on {card}: {r:.1f} images/s", flush=True)
    for tag, r in dp_rows.items():
        print(f"[{tag}] on {card}: {r:.1f} images/s", flush=True)
    for tag, r in rnn_rows.items():
        print(f"[phase 21] {tag} on {card}: {r}", flush=True)
    for tag, r in attn_rows.items():
        print(f"[phase 22] {tag} on {card}: {r}", flush=True)
    for tag, r in front_rows.items():
        print(f"[phase 23] {tag} on {card}: {r}", flush=True)
    for tag, r in tune_rows.items():
        print(f"[phase 24] {tag} on {card}: {r}", flush=True)
    for tag, r in rec_rows.items():
        print(f"[phase 25] {tag} on {card}: {r}", flush=True)
    for tag, r in tp_rows.items():
        print(f"[phase 26] {tag} on {card}: {r}", flush=True)
    for tag, r in spe_rows.items():
        print(f"[phase 27] {tag} on {card}: {r}", flush=True)
    for tag, r in obs_rows.items():
        print(f"[phase 28] {tag} on {card}: {r}", flush=True)
    for tag, r in bulk_rows.items():
        print(f"[phase 29] {tag} on {card}: {r}", flush=True)
    for tag, r in lint_rows.items():
        print(f"[phase 30] {tag} on {card}: {r}", flush=True)

    head, bwd = rows[0], bwd_rows[0]  # the training step's 8 x 8 x 1024^2
    common = {"route": "cuda", "check": "pass", "shape": head["shape"],
              "dtype": head["dtype"]}
    src = "bigdl_tpu_torch/ops/csrc/"
    kernels = [
        dict(common, name="flash_fwd", source=src + "flash_fwd.cu",
             kernel=head["kernel"],
             replaces="bigdl_tpu/ops/attention_kernel.py:211",
             launches=launches["flash_fwd"], max_abs_err=head["max_abs_err"],
             ms=head["ms"], plain_ms=head["plain_ms"],
             bound_ms=head["bound_ms"], bound_by=head["bound_by"],
             library_ms=head["library_ms"]),
        # plain_ms and library_ms of the backward are one figure for the
        # pair (the plain backward and the library's backward compute dQ,
        # dK and dV together)
        dict(common, name="flash_dq", source=src + "flash_bwd.cu",
             replaces="bigdl_tpu/ops/attention_kernel.py:289",
             launches=launches["flash_dq"], max_abs_err=bwd["dq_abs_err"],
             ms=bwd["dq_ms"], plain_ms=bwd["plain_ms"],
             bound_ms=bwd["dq_bound_ms"], bound_by=bwd["dq_bound_by"],
             library_ms=bwd["library_ms"]),
        dict(common, name="flash_dkv", source=src + "flash_bwd.cu",
             replaces="bigdl_tpu/ops/attention_kernel.py:344",
             launches=launches["flash_dkv"], max_abs_err=bwd["dkv_abs_err"],
             ms=bwd["dkv_ms"], plain_ms=bwd["plain_ms"],
             bound_ms=bwd["dkv_bound_ms"], bound_by=bwd["dkv_bound_by"],
             library_ms=bwd["library_ms"])]
    # the BN rows at ResNet-50's stage-1 shape in bf16, the fused pair with
    # its ReLU (33 of the 53 BNs absorb one)
    for name, line, relu in (("bn_stats", 93, False),
                             ("bn_bwd_stats", 165, False),
                             ("bn_fwd_apply", 350, True),
                             ("bn_bwd_fused", 423, True)):
        r = bn_rows[(name, (128, 56, 56, 256), "bfloat16", relu)]
        kernels.append(dict(
            common, name=name, source=src + "bn.cu",
            replaces=f"bigdl_tpu/ops/bn_kernel.py:{line}", shape=r["shape"],
            dtype=r["dtype"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on the main paths")
    # the fleet workers' launches (phase 23 (c)-(d)) are in their own
    # processes and are not in these counts
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
