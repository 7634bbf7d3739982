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
   the segments leave live). The forward at 8 shapes; the backward pair
   (``flash_dq``, ``flash_dkv``) and the forward with ``segments`` at 6.
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

Any failed phase exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
            "float32": 67e12}    # f32 FMA outside the tensor cores
# kernel vs plain: (b, h, s_q, s_k, d, causal, dtype)
SHAPES = [(8, 8, 1024, 1024, 128, True, "bfloat16"),  # the training step's
          (1, 8, 1024, 1024, 128, True, "bfloat16"),
          (1, 8, 1024, 1024, 128, True, "float32"),
          (2, 8, 512, 512, 64, True, "bfloat16"),
          (2, 8, 512, 512, 64, False, "bfloat16"),
          (1, 8, 16, 1024, 128, True, "bfloat16"),
          (1, 8, 1000, 1000, 128, True, "float32"),
          (1, 8, 16, 16, 128, True, "bfloat16")]
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


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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
               "plain_ms": device_ms(lambda: ak.flash_bwd_reference(
                   q, k, v, o, lse, do, causal, seg)),
               "library_ms": None if use_seg else library_bwd_ms(
                   torch, q, k, v, do, causal)}
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
              f"plain_ms={row['plain_ms']:.4f} library_bwd_ms={lib}"
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
        want = {"flash_fwd": (24 if remat else 12) * steps,
                "flash_dq": 12 * steps, "flash_dkv": 12 * steps}
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


def cli_runs(torch):
    """``cli.transformerlm train`` at full width, plain and --packed;
    returns the launches of the two runs."""
    import contextlib
    import io
    import logging
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

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    handler = Lines()
    log = logging.getLogger("bigdl_tpu_torch")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    launches = {}
    ak._launch_bwd = counting
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_corpus(os.path.join(tmp, "input.txt"), CORPUS_WORDS)
            base = ["train", "-f", tmp, *CLI_DIMS, "--flash", "--bf16",
                    "--maxEpoch", "1", "--logEvery", "1"]
            for packed in (False, True):
                tag = "packed" if packed else "plain"
                handler.lines.clear()
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
                trains = [ln for ln in handler.lines
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
        log.removeHandler(handler)
    return launches


def check_flash(torch, ak):
    import torch.nn.functional as F

    from bigdl_tpu_torch.tools.timing import device_ms

    rows = []
    for b, h, sq, sk, d, causal, dt in SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(sq * 7 + sk)
        q = torch.randn(b, h, sq, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, h, sk, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, h, sk, d, device="cuda", generator=g).to(dtype)
        o, lse = ak.flash_fwd(q, k, v, causal)
        o_ref, lse_ref = ak.flash_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
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
               "max_abs_err": float(d_o.max()),
               "max_abs_err_lse": float(d_l.max()),
               "ms": device_ms(lambda: ak.flash_fwd(q, k, v, causal)),
               "plain_ms": device_ms(lambda: ak.flash_attention_reference(
                   q, k, v, causal)),
               "library_ms": device_ms(lib), "ok": ok}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            live_scores(torch, b, h, sq, sk, causal), b, h, sq, sk, d, dt)
        rows.append(row)
        print(f"flash_fwd b={b} h={h} s_q={sq} s_k={sk} d={d} "
              f"causal={int(causal)} {dt}: max|dO|={row['max_abs_err']:.3e} "
              f"max|dlse|={row['max_abs_err_lse']:.3e} "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"flash_fwd disagrees with its plain version at "
             f"{[(r['shape'], r['dtype']) for r in bad]}")
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

    t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, info in _build.build_info().items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows = check_flash(torch, ak)
    bwd_rows = check_flash_bwd(torch, ak)
    # the main paths, each driven with the counts set to 0 just before it
    # and read just after: training (perf, plain and remat), the training
    # CLI (plain and packed), serving (f32 and bf16)
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    train, *train_n = train_run(torch, card)
    grads_check(torch, ak)
    for n in train_n + list(cli_runs(torch).values()):
        for name in launches:
            launches[name] += n[name]
    for bf16 in (False, True):
        n, lat, tps, _ = serve_run(torch, bf16)
        launches["flash_fwd"] += n
    print(f"[bf16] {MODEL} on {card}: {tps:.1f} generated tokens/s over 4 "
          f"concurrent requests, /generate latencies ms "
          f"{[round(x, 1) for x in lat]} (prompts {list(PROMPT_LENS)}, "
          f"{MAX_NEW} new tokens each)", flush=True)
    print(f"[train] {MODEL} bf16 batch {TRAIN_BATCH} on {card}: "
          f"{train['tokens_per_second']} tokens/s", flush=True)

    head, bwd = rows[0], bwd_rows[0]  # the training step's 8 x 8 x 1024^2
    common = {"route": "cuda", "check": "pass", "shape": head["shape"],
              "dtype": head["dtype"]}
    src = "bigdl_tpu_torch/ops/csrc/"
    kernels = [
        dict(common, name="flash_fwd", source=src + "flash_fwd.cu",
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
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
