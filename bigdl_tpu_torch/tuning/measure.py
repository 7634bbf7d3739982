"""Candidate timing for the autotuner, on the card only (counterpart of
``bigdl_tpu/tuning/measure.py``).

Each candidate is timed in device time: its calls are captured into one
CUDA graph and replays of it are timed with CUDA events
(:func:`rotated_ms`, the scheme of ``tools.timing.device_ms``), so the
host's launch time does not enter. Where one call's operands are smaller
than twice the card's L2 (50 MB on an H100), the captured calls rotate
through enough copies of the inputs to cover that, so no candidate is
timed on operands already in L2. The gradient all-reduce, whose
collectives a graph does not take under every backend, is timed eagerly
with CUDA events.

Candidates run in a fixed order, and :func:`_pick` keeps the first
strictly fastest, so equal times re-pick the same candidate. The kernel
launches a measurement makes are not counted in the wrappers' launch
counts (``ops.kernel_launches``). :data:`LAST` keeps every candidate's
time of the latest measurement of each key, for reports.

These routines never run in dry mode (``autotune.dry_run()``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

__all__ = ["rotated_ms", "eager_ms", "measure_flash_blocks",
           "measure_bn_row_block", "measure_fba_row_block",
           "measure_conv_layouts", "measure_conv_geom",
           "measure_grad_buckets", "measure_kv_page_tokens",
           "measure_quant_matmul", "CONV_PROBE_SHAPES", "L2_BYTES", "LAST"]

L2_BYTES = 50 * 2 ** 20  # an H100's L2
_MAX_SETS = 1024         # the most input copies one timing rotates through
_ITERS = 20
_REPS = 3

# op -> [(config, ms), ...] of its latest measurement, candidate order
LAST: Dict[str, list] = {}


@contextlib.contextmanager
def _uncounted():
    """Restore the kernel wrappers' launch counts afterwards: tuning is
    not the run it tunes."""
    from bigdl_tpu_torch import ops
    before = ops.kernel_launches()
    try:
        yield
    finally:
        now = ops.kernel_launches()
        ops.add_kernel_launches({k: before[k] - now[k] for k in now})


def _sets(nbytes: int) -> int:
    """Input copies that cover twice the L2 for operands of ``nbytes``."""
    if nbytes <= 0 or nbytes >= 2 * L2_BYTES:
        return 1
    return min(_MAX_SETS, -(-2 * L2_BYTES // nbytes))


def rotated_ms(call: Callable[[int], object], sets: int = 1,
               iters: int = _ITERS, reps: int = _REPS) -> float:
    """Milliseconds of device time per ``call(i)``, ``i`` cycling over
    ``sets`` input copies: max(iters, sets) calls captured into one CUDA
    graph, replayed ``reps`` times between two CUDA events."""
    import torch

    n = max(int(iters), int(sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for i in range(min(n, 2)):
            call(i % sets)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            call(i % sets)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    return ms


def eager_ms(fn: Callable[[], object], iters: int = 5) -> float:
    """Milliseconds per eager ``fn()`` between two CUDA events, after one
    warm-up call: for work a graph cannot hold (collectives)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pick(timed: Sequence[Tuple[dict, float]]) -> Tuple[dict, float]:
    """First strictly fastest candidate in presentation order."""
    best, best_ms = timed[0]
    for cfg, ms in timed[1:]:
        if ms < best_ms:
            best, best_ms = cfg, ms
    return best, best_ms


def _done(op: str, timed: List[Tuple[dict, float]]) -> Tuple[dict, float]:
    LAST[op] = [(dict(c), float(ms)) for c, ms in timed]
    return _pick(timed)


def _gen():
    import torch
    return torch.Generator(device="cuda").manual_seed(0)


def _torch_dtype(dtype):
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).replace("torch.", ""))


def measure_flash_blocks(s_q: int, s_k: int, d: int, causal: bool,
                         dtype, candidates: Sequence[Tuple[int, int]]
                         ) -> Tuple[dict, float]:
    """Forward and backward of ``blockwise_attention`` under a key-padding
    mask (the path ``flash_block_k`` feeds; a quarter of the keys padded)
    per (block_q, block_k) candidate, on a (1, 8) problem of the shape's
    sequence geometry."""
    import torch

    from bigdl_tpu_torch.ops.attention_kernel import blockwise_attention

    dt, g = _torch_dtype(dtype), _gen()
    shape_q, shape_k = (1, 8, s_q, d), (1, 8, s_k, d)
    one = (2 * s_q * d + 2 * s_k * d) * 8 * torch.finfo(dt).bits // 8
    sets = _sets(one)
    qkv = [tuple(torch.randn(s, generator=g, device="cuda", dtype=dt)
                 .requires_grad_() for s in (shape_q, shape_k, shape_k))
           for _ in range(sets)]
    mask = torch.arange(s_k, device="cuda")[None, :] < s_k - s_k // 4
    timed = []
    with _uncounted():
        for bq, bk in candidates:
            def call(i, bk=bk):
                q, k, v = qkv[i]
                out = blockwise_attention(q, k, v, causal=causal, mask=mask,
                                          block_k=bk)
                return torch.autograd.grad(out.float().sum(), (q, k, v))

            timed.append(({"block_q": bq, "block_k": bk},
                          rotated_ms(call, sets, iters=4)))
    return _done("flash", timed)


def _bn_inputs(rows: int, c: int, dtype, n_ops: int):
    import torch
    dt, g = _torch_dtype(dtype), _gen()
    sets = _sets(rows * c * torch.finfo(dt).bits // 8 * n_ops)
    xs = [tuple(torch.randn(rows, c, generator=g, device="cuda", dtype=dt)
                for _ in range(n_ops)) for _ in range(sets)]
    return xs, sets


def _bn_vectors(c: int):
    import torch
    g = _gen()
    return (torch.randn(c, generator=g, device="cuda") * 0.1,
            torch.rand(c, generator=g, device="cuda") + 0.5,
            torch.rand(c, generator=g, device="cuda") + 0.5,
            torch.randn(c, generator=g, device="cuda") * 0.1)


def _bn_sweep(op: str, heights, pair) -> Tuple[dict, float]:
    """Time ``pair()`` (both kernels that share the key) under each slab
    height; the plan's height is pinned through ``bn_kernel.pinned_slab``.
    ``LAST[op + ":default"]`` gets the untuned plans' time."""
    from bigdl_tpu_torch.ops import bn_kernel

    timed = []
    with _uncounted():
        with bn_kernel.pinned_slab(None):
            LAST[op + ":default"] = [({}, pair())]
        for h in heights:
            with bn_kernel.pinned_slab(int(h)):
                timed.append(({"row_block": int(h)}, pair()))
    return _done(op, timed)


def measure_bn_row_block(rows: int, c: int, dtype,
                         heights: Sequence[int]) -> Tuple[dict, float]:
    """``bn_stats`` + ``bn_bwd_stats`` (the two kernels of the key) per
    slab height on the exact (rows, C) shape."""
    from bigdl_tpu_torch.ops.bn_kernel import bn_bwd_stats, bn_stats

    xs, sets = _bn_inputs(rows, c, dtype, 2)
    mean, inv, _, _ = _bn_vectors(c)

    def call(i):
        x, dy = xs[i]
        bn_stats(x)
        return bn_bwd_stats(dy, x, mean, inv)

    return _bn_sweep("bn_stats", heights, lambda: rotated_ms(call, sets))


def measure_fba_row_block(rows: int, c: int, dtype, relu: bool,
                          heights: Sequence[int]) -> Tuple[dict, float]:
    """``bn_fwd_apply`` + ``bn_bwd_fused`` (one fused block's forward and
    backward) per slab height on the exact (rows, C) shape."""
    from bigdl_tpu_torch.ops.bn_kernel import bn_bwd_fused, bn_fwd_apply

    xs, sets = _bn_inputs(rows, c, dtype, 2)
    mean, inv, gamma, beta = _bn_vectors(c)

    def call(i):
        x, dy = xs[i]
        bn_fwd_apply(x, gamma, beta, 1e-5, relu)
        return bn_bwd_fused(dy, x, mean, inv, gamma, beta, relu)

    return _bn_sweep("bn_fba", heights, lambda: rotated_ms(call, sets))


def measure_grad_buckets(param_bytes: int, n_devices: int, dtype,
                         candidates: Sequence[int]) -> Tuple[dict, float]:
    """One whole bucketed all-reduce of ``param_bytes`` of f32 gradient
    per bucket bound: each bucket cast to the 16-bit wire dtype, summed
    over the process group (where one is initialized) and cast back, as
    ``parallel.grad_comm`` does. Timed eagerly (the collectives)."""
    import torch
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel.grad_comm import (compress_bucket,
                                                    decompress_bucket)

    mode = "fp16" if _torch_dtype(dtype) == torch.float16 else "bf16"
    n_elems = max(1, int(param_bytes) // 4)
    x = torch.randn(n_elems, generator=_gen(), device="cuda")
    timed = []
    for bound in candidates:
        per = max(1, int(bound) // 4)

        def reduce_all(per=per):
            outs = []
            for piece in torch.split(x, per):
                c = compress_bucket(piece, mode)
                if dist.is_initialized():
                    dist.all_reduce(c)
                outs.append(decompress_bucket(c))
            return torch.cat(outs)

        timed.append(({"bucket_bytes": int(bound)}, eager_ms(reduce_all)))
    return _done("grad_comm", timed)


# the distinct ResNet-50 bottleneck geometries at batch 32 (n, h, w, cin,
# cout, kh, kw, stride), the JAX package's set
CONV_PROBE_SHAPES: Tuple[Tuple[int, int, int, int, int, int, int, int],
                         ...] = (
    (32, 224, 224, 3, 64, 7, 7, 2),
    (32, 56, 56, 64, 64, 1, 1, 1),
    (32, 56, 56, 64, 64, 3, 3, 1),
    (32, 28, 28, 128, 128, 3, 3, 1),
    (32, 14, 14, 256, 256, 3, 3, 1),
    (32, 7, 7, 512, 512, 3, 3, 1),
)


def _conv_pass_ms(pass_name: str, layout: str, x, w, stride, padding,
                  groups: int = 1, dilation=(1, 1)) -> float:
    """One pass of one conv under ``layout`` (``ops.conv2d``'s own pass
    functions), in device ms."""
    import torch

    from bigdl_tpu_torch.ops import conv2d as c2d

    if pass_name == "fwd":
        return rotated_ms(lambda i: c2d._conv_fwd(
            x, w, stride, padding, dilation, groups, layout), iters=5)
    with torch.no_grad():
        dy = torch.ones_like(c2d._conv_fwd(x, w, stride, padding, dilation,
                                           groups, "NHWC"))
    fn = c2d._conv_dgrad if pass_name == "dgrad" else c2d._conv_wgrad
    return rotated_ms(lambda i: fn(dy, x, w, stride, padding, dilation,
                                   groups, layout), iters=5)


def measure_conv_geom(pass_name: str, geom: tuple, x_shape: tuple,
                      candidates: Sequence[str]) -> Tuple[dict, float]:
    """One conv pass of one geometry under each candidate layout at the
    activation shape the run presented (NHWC ``x_shape``), with the
    symmetric padding of a SAME conv (none at a 1x1)."""
    import torch

    kh, kw, sh, sw, cin, cout, groups, dh, dw, dtype_name = geom
    n, h, w_ = int(x_shape[0]), int(x_shape[1]), int(x_shape[2])
    dt, g = _torch_dtype(dtype_name), _gen()
    x = torch.randn(n, h, w_, cin, generator=g, device="cuda", dtype=dt)
    wgt = torch.randn(cout, cin // groups, kh, kw, generator=g,
                      device="cuda", dtype=dt)
    pad = (kh // 2, kw // 2)
    timed = []
    with torch.no_grad():
        for layout in candidates:
            timed.append(({"layout": layout}, _conv_pass_ms(
                pass_name, layout, x, wgt, (sh, sw), pad, groups,
                (dh, dw))))
    return _done("conv_geom", timed)


def measure_conv_layouts(dtype) -> Tuple[dict, float]:
    """One layout a pass for the whole run: each of fwd/dgrad/wgrad under
    NHWC and NCHW summed over :data:`CONV_PROBE_SHAPES`, the per-pass
    smaller total winning (NHWC on a tie). Returns ({pass: layout},
    the winners' total ms)."""
    import torch

    dt, g = _torch_dtype(dtype), _gen()
    totals = {p: {"NHWC": 0.0, "NCHW": 0.0} for p in ("fwd", "dgrad",
                                                      "wgrad")}
    with torch.no_grad():
        for n, h, w, cin, cout, kh, kw, stride in CONV_PROBE_SHAPES:
            x = torch.randn(n, h, w, cin, generator=g, device="cuda",
                            dtype=dt)
            wgt = torch.randn(cout, cin, kh, kw, generator=g, device="cuda",
                              dtype=dt)
            for layout in ("NHWC", "NCHW"):
                for p in totals:
                    totals[p][layout] += _conv_pass_ms(
                        p, layout, x, wgt, (stride, stride),
                        (kh // 2, kw // 2))
    decision, best_total = {}, 0.0
    for p, per in totals.items():
        lay = "NCHW" if per["NCHW"] < per["NHWC"] else "NHWC"
        decision[p] = lay
        best_total += per[lay]
    LAST["conv_layouts"] = [(dict(totals[p]), 0.0) for p in totals]
    return decision, best_total


def measure_kv_page_tokens(max_len: int, kv_heads: int, head_dim: int,
                           dtype, candidates: Sequence[int]
                           ) -> Tuple[dict, float]:
    """The two data movements paging adds to a decode step, per page
    size: one slot's pages gathered into the contiguous view the step
    reads, and one token's K/V scattered back into its page."""
    import torch

    dt, g = _torch_dtype(dtype), _gen()
    timed = []
    for pt in candidates:
        mp = max_len // pt
        one = (1 + mp) * kv_heads * pt * head_dim * torch.finfo(dt).bits // 8
        sets = _sets(one)
        pools = [torch.randn(1 + mp, kv_heads, pt, head_dim, generator=g,
                             device="cuda").to(dt) for _ in range(sets)]
        pages = torch.arange(1, mp + 1, device="cuda")
        tok = torch.ones(kv_heads, head_dim, device="cuda", dtype=dt)

        def roundtrip(i, pt=pt, mp=mp, pages=pages, tok=tok):
            pool = pools[i]
            view = pool[pages].transpose(0, 1).reshape(kv_heads, mp * pt,
                                                       head_dim)
            pool[mp, :, pt - 1, :] = tok + view[:, -1, :]

        timed.append(({"page_tokens": int(pt)}, rotated_ms(roundtrip, sets)))
    return _done("kv_pages", timed)


def measure_quant_matmul(rows: int, k: int, n: int, dtype,
                         native_ok: bool = True) -> Tuple[dict, float]:
    """The quantized product's kinds at (rows, k) x (k, n): dequant-fused
    (``(x @ q.to(dt)) * s``) first, so a tie keeps it, then native int8
    where ``torch._int_mm`` takes the shape."""
    import torch

    from bigdl_tpu_torch.serving.quant import native_int8_product

    dt, g = _torch_dtype(dtype), _gen()
    one = rows * k * torch.finfo(dt).bits // 8 + k * n
    sets = _sets(one)
    xs = [torch.randn(rows, k, generator=g, device="cuda", dtype=dt)
          for _ in range(sets)]
    qs = [torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                        dtype=torch.int8) for _ in range(sets)]
    s = torch.full((n,), 0.01, device="cuda")

    def dequant(i):
        return (xs[i] @ qs[i].to(dt)) * s.to(dt)

    def native(i):
        return native_int8_product(xs[i], qs[i], s, dt)

    kinds = [("dequant", dequant)] + ([("native-int8", native)]
                                      if native_ok else [])
    timed = [({"kind": kind}, rotated_ms(fn, sets)) for kind, fn in kinds]
    return _done("quant", timed)
