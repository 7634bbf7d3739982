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
   ``/healthz``, ``/readyz`` and ``/metrics``. Checked: every answer is
   200; the prefill logits through the kernel match those through the
   plain version on the card; the kernel's launch count over the traffic
   is at least 12 x (prefills + /predict batches); in f32, each
   ``/generate`` equals the offline ``TransformerLM.generate``.
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

Any failed phase exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
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


def check_flash_bwd(torch, ak):
    """flash_dq / flash_dkv (and the forward with segments) against their
    plain versions on the card, with times and bounds."""
    from bigdl_tpu_torch.tools.timing import device_ms

    rows = []
    for b, h, sq, sk, d, causal, dt, use_seg in BWD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(sq * 5 + sk + d)
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=g)
                   .to(dtype) for s in (sq, sk, sk))
        # dO as autograd hands it over: a (b, s, h, d) buffer seen as
        # (b, h, s, d), the backward of the heads merge
        do = torch.randn(b, sq, h, d, device="cuda", generator=g).to(
            dtype).transpose(1, 2)
        seg = packed_segments(torch, b, sq, seed=sq) if use_seg else None
        o, lse = ak.flash_fwd(q, k, v, causal, seg)
        o_ref, lse_ref = ak.flash_attention_reference(q, k, v, causal, seg)
        delta = ak._delta(o, do)
        dq = ak.flash_dq(q, k, v, do, lse, delta, causal, seg)
        dk, dv = ak.flash_dkv(q, k, v, do, lse, delta, causal, seg)
        rq, rk, rv = ak.flash_bwd_reference(q, k, v, o, lse, do, causal, seg)
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
               "plain_ms": device_ms(lambda: ak.flash_bwd_reference(
                   q, k, v, o, lse, do, causal, seg)),
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
        print(f"flash_bwd b={b} h={h} s_q={sq} s_k={sk} d={d} "
              f"causal={int(causal)} {dt} segments={int(use_seg)}: "
              f"max|d|/max|ref| dQ={err['dq']:.2e} dK={err['dk']:.2e} "
              f"dV={err['dv']:.2e} O={err['o']:.2e} "
              f"dq_ms={row['dq_ms']:.4f} (bound {row['dq_bound_ms']:.4f} "
              f"{row['dq_bound_by']}) dkv_ms={row['dkv_ms']:.4f} (bound "
              f"{row['dkv_bound_ms']:.4f} {row['dkv_bound_by']}) "
              f"delta_ms={row['delta_ms']:.4f} pair_plus_delta_ms="
              f"{row['pair_plus_delta_ms']:.4f} library_bwd_ms={lib} "
              f"plain_ms={row['plain_ms']:.4f}"
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


def write_corpus(path, n_words, seed=0, vocab=5000):
    """A Zipf-distributed word stream over a synthetic vocabulary of
    letter-only words (the tokenizer keeps letters), split into sentences
    of 4-39 words that end in "."."""
    import numpy as np

    def word(i):
        out = "w"
        while True:
            out += chr(97 + i % 26)
            i //= 26
            if not i:
                return out

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


def check_flash(torch, ak):
    import torch.nn.functional as F

    from bigdl_tpu_torch.tools.timing import device_ms

    rows = []
    for b, h, sq, sk, d, causal, dt, use_seg in SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
        q = torch.randn(b, h, sq, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, h, sk, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, h, sk, d, device="cuda", generator=g).to(dtype)
        seg = packed_segments(torch, b, sq, seed=sq) if use_seg else None
        o, lse = ak.flash_fwd(q, k, v, causal, seg)
        o_ref, lse_ref = ak.flash_attention_reference(q, k, v, causal, seg)
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
            mask = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
                    >= torch.arange(sk, device="cuda")[None, :])
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
               "plain_ms": device_ms(lambda: ak.flash_attention_reference(
                   q, k, v, causal, seg)),
               "library_ms": None if use_seg else device_ms(lib), "ok": ok}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            live_scores(torch, b, h, sq, sk, causal, seg), b, h, sq, sk, d,
            dt)
        rows.append(row)
        lib_ms = ("-" if row["library_ms"] is None
                  else f"{row['library_ms']:.4f}")
        print(f"flash_fwd b={b} h={h} s_q={sq} s_k={sk} d={d} "
              f"causal={int(causal)} {dt}{' segments' if use_seg else ''} "
              f"[{row['kernel']}]: max|dO|={row['max_abs_err']:.3e} "
              f"max|dlse|={row['max_abs_err_lse']:.3e} "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
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

        # ---- /predict equals the offline forward at the same shape
        with torch.no_grad():
            ref = model(torch.tensor(rows, device="cuda")).argmax(-1)
        agree = float((torch.tensor(pred["predictions"], device="cuda")
                       == ref).float().mean())
        print(f"[{tag}] /predict argmax agreement with the offline forward "
              f"{agree:.4f}", flush=True)
        if not bf16 and agree != 1.0:
            fail("[f32] /predict differs from the offline forward")

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


def check_bn(torch):
    """The four BN kernels against their plain versions at BN_SHAPES, bf16
    and f32 (ReLU on and off for the fused pair), with device times, the
    library's time and the bound. Returns {(kernel, shape, dtype, relu):
    row}."""
    from bigdl_tpu_torch.ops import bn_kernel as bk
    from bigdl_tpu_torch.tools.timing import device_ms

    def errs(got, ref):
        return ([float((a.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp_min(1e-30))
                 for a, r in zip(got, ref)],
                max(float((a.float() - r.float()).abs().max())
                    for a, r in zip(got, ref)))

    rows_out, bad = {}, []
    for b, h, w, c in BN_SHAPES:
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
                       "ms": device_ms(run), "plain_ms": device_ms(plain),
                       "library_ms": device_ms(library)}
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


def write_cifar(folder, n, seed=0):
    """cifar-10-binary files of ``n`` random records each: five
    ``data_batch_<i>.bin`` and a ``test_batch.bin``."""
    import numpy as np

    rs = np.random.RandomState(seed)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                              rs.randint(0, 256, (n, 3072))], axis=1)
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
                  ckpt=None, resume=None, shuffle=False):
    """One ``Optimizer`` run (SGD(0.01, momentum 0.9) with the schedule
    Poly(0.5, POLY_ITERS)) over ``data``
    (a list of (x, y) batches, held in a ``BatchDataSet``) with
    ``steps_per_dispatch=k`` up to iteration ``end``, checkpointing every
    ``k`` iterations into ``ckpt`` (keep_last=1) and resuming from
    ``resume`` when given; returns (every step's loss, kernel launches,
    images/s of the dispatches after the first two, log lines)."""
    import numpy as np

    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import BatchDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Poly, Trigger

    x = np.concatenate([b[0] for b in data])
    y = np.concatenate([b[1] for b in data])
    batch = len(data[0][0])
    model = make_model()
    rec = LossRecorder(torch, ClassNLLCriterion(), end, DEV)
    opt = Optimizer(model, BatchDataSet(x, y, batch, shuffle=shuffle), rec,
                    optim_method=SGD(0.01, momentum=0.9,
                                     schedule=Poly(0.5, POLY_ITERS)),
                    end_when=Trigger.max_iteration(end), log_every=1,
                    compute_dtype=compute_dtype, steps_per_dispatch=k,
                    device=DEV)
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


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    resnet = resnet_runs(torch, card)
    bn_grads_check(torch)
    inner = inner_steps_runs(torch, card)
    for n in ([n for _, n in resnet.values()] + [cifar_cli_run(torch)]
              + [n for _, n in inner.values()]
              + graphed_optimizer_runs(torch, card)
              + resume_runs(torch, card)):
        for name in launches:
            launches[name] += n[name]
    print(f"[bf16] {MODEL} on {card}: {tps:.1f} generated tokens/s over 4 "
          f"concurrent requests, /generate latencies ms "
          f"{[round(x, 1) for x in lat]} (prompts {list(PROMPT_LENS)}, "
          f"{MAX_NEW} new tokens each)", flush=True)
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
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
