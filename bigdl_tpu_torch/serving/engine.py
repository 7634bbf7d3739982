"""Online inference engine: bucketed forwards over an eval-mode module
(counterpart of ``bigdl_tpu/serving/engine.py``).

A request of n rows pads up to the smallest declared batch bucket >= n
(chunking through the largest bucket first), so the device only ever
sees ``len(buckets)`` batch shapes. Padding repeats the last real row,
and padding waste is metered (``padded_rows_total`` vs ``rows_total``).
For a causal sequence model the caller also declares length buckets
(``lengths``): a row of L tokens is right-padded to the smallest length
>= L and its output cut back to L, which is exact because no position
attends past itself.

On the card each (batch bucket, geometry) forward is a CUDA graph
(``serving.graphs``, the counterpart of the JAX package's per-bucket
compile): a chunk is staged into its static input buffer, the graph
replays, and its output is copied to the host. ``warmup`` captures every
bucket at every geometry it serves, before any serving thread starts;
after it, ``validate`` refuses any other geometry, so the graphs and the
memory they hold are fixed at start-up. Every graph writes its output
into one buffer, sized by the largest, which is captured first.
``quantize`` serves a copy of the module with int8 or fp8 weights
(``serving.quant``). ``predict_scores`` is the ``infer`` fault site (a
``worker_kill`` there is fatal to the batcher's worker thread), and with
``--reqTrace`` on it attributes each chunk's compute window to the
requests whose rows it carried. An image classifier is served the same
way with no length buckets: ``warmup`` takes the input shape and dtype
``cli.perf.build_model`` gives, and ``compute_dtype`` casts floating
inputs (``serve --bf16``) as the JAX engine does. Under ``tp`` (a tp:K
engine, ``serving.sharding``) rank 0's forwards run on every rank.
``lint`` (``serve --lint[=strict]``) arms :meth:`InferenceEngine.
preflight_lint`: the lint of the served forward, before ``warmup``
dispatches anything.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from bigdl_tpu_torch.core.module import resolve_device
from bigdl_tpu_torch.obs import memory as _obs_mem
from bigdl_tpu_torch.obs.spans import span as _obs_span
from bigdl_tpu_torch.resilience.faults import hook as _fault_hook
from bigdl_tpu_torch.serving import quant as _q
from bigdl_tpu_torch.serving.graphs import GraphPool, GraphSet
from bigdl_tpu_torch.serving.reqtrace import get as _get_reqtracer

__all__ = ["InferenceEngine", "power_of_two_buckets"]


def power_of_two_buckets(max_batch: int, min_bucket: int = 1) -> tuple:
    """The default bucket ladder: powers of two from ``min_bucket`` up to
    and including ``max_batch`` (always a member, power of two or not), so
    a tail batch wastes at most half a bucket and the engine holds
    log2(max_batch) programs."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = max(1, min_bucket)
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _dtype_str(a) -> str:
    """The numpy dtype string of an array's or a tensor's elements (the
    graph key's)."""
    if isinstance(a, torch.Tensor):
        return np.dtype(str(a.dtype).replace("torch.", "")).str
    return a.dtype.str


class InferenceEngine:
    """Eval-mode forward over fixed batch buckets on ``device`` (CUDA
    unless the caller asks for the CPU). ``predict_scores(x)`` returns,
    row for row, what an unpadded forward gives. Inputs go to the module
    as they are: an LM takes token ids and applies its own
    ``compute_dtype`` after the embedding. ``lengths``: the length
    buckets of a causal module (axis 1 of its input and output), or None.
    ``graphs``: True (the engine's own
    :class:`~bigdl_tpu_torch.serving.graphs.GraphPool`), False (eager), or
    a pool shared with a decode engine. ``quantize``: a ``--quantize``
    mode; its weight format (int8, fp8) is served, the kv8 part is the
    decode engine's. ``compute_dtype``: floating inputs are cast to it
    before the module (an image model's bf16 activations). ``tp``: the
    :class:`~bigdl_tpu_torch.serving.sharding.TPLink` of a tp:K engine
    (the module placed on this rank): rank 0's forwards are broadcast with
    their chunk and run eagerly on every rank."""

    def __init__(self, module, *, buckets: Sequence[int] = (1, 2, 4, 8, 16,
                                                            32),
                 lengths: Optional[Sequence[int]] = None,
                 metrics=None, device="cuda",
                 graphs: Union[bool, GraphPool] = True,
                 quantize: Optional[str] = None, compute_dtype=None,
                 tp=None, lint: Optional[str] = None):
        self.device = resolve_device(device)
        self.lint_mode = lint if lint in ("on", "strict") else None
        self.lint_annotation = None
        self._linted = False
        self._tp = tp if tp is not None and tp.size > 1 else None
        if self._tp is not None:
            if isinstance(graphs, GraphPool) and graphs.enabled:
                raise ValueError("a tp engine runs its forwards eagerly: "
                                 "pass graphs=False or an eager pool")
            graphs = graphs if isinstance(graphs, GraphPool) else False
            self._tp.register("predict.forward", self._run_chunk)
        self.compute_dtype = compute_dtype
        self.quantize = quantize or "off"
        wfmt, _ = _q.parse_quantize(quantize)
        self.module = _q.quantize_params(module.to(self.device),
                                         wfmt).eval()
        pool = (graphs if isinstance(graphs, GraphPool)
                else GraphPool(self.device, enabled=graphs))
        self.graphs = GraphSet(pool)
        self._inputs: dict = {}  # (input shape, dtype) -> static input
        self._out = None         # the output buffer every forward writes
        self._served: set = set()  # (row shape, dtype) warmup captured
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.lengths = (tuple(sorted(set(int(n) for n in lengths)))
                        if lengths else None)
        if self.lengths and self.lengths[0] < 1:
            raise ValueError(f"lengths must be positive ints, got {lengths}")
        if metrics is not None:
            self._m_rows = metrics.counter(
                "rows_total", "input rows submitted to the engine")
            self._m_pad = metrics.counter(
                "padded_rows_total",
                "bucket-padding rows (waste) run alongside real rows")
            metrics.gauge(
                "padding_waste_fraction",
                "padded_rows_total / (rows_total + padded_rows_total)",
                fn=self._padding_waste)
        else:
            self._m_rows = self._m_pad = None

    def _padding_waste(self) -> float:
        real, pad = self._m_rows.value, self._m_pad.value
        return pad / (real + pad) if real + pad else 0.0

    def _length_for(self, n: int) -> int:
        """Smallest length bucket >= n."""
        b = next((b for b in self.lengths if b >= n), None)
        if b is None:
            raise ValueError(f"rows of {n} positions exceed the largest "
                             f"length bucket, {self.lengths[-1]}")
        return b

    def _geometry(self, row_shape) -> tuple:
        row_shape = tuple(row_shape)
        if self.lengths is None:
            return row_shape
        return (self._length_for(row_shape[0]),) + row_shape[1:]

    def _emit(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` as f32, in the engine's one output buffer. Forwards run
        one at a time under the pool's lock and their output is copied to
        the host before it is released, so every graph shares the buffer;
        it is sized by the first (largest) capture and never moves."""
        y = y.float()
        n = y.numel()
        if self._out is None or self._out.numel() < n:
            if len(self.graphs):
                raise RuntimeError(
                    f"an output of {n} elements exceeds the "
                    f"{self._out.numel()} the captured graphs write "
                    f"(warmup captures the largest geometry first)")
            self._out = torch.empty(n, dtype=torch.float32,
                                    device=self.device)
        return self._out[:n].view(y.shape).copy_(y)

    def _stage(self, chunk):
        """(key, fn): ``chunk`` (an array, or a tensor on the host or the
        card) copied into its geometry's static input, and the forward
        over that input (call under the pool's work)."""
        t = chunk if isinstance(chunk, torch.Tensor) else \
            torch.from_numpy(chunk)
        key = (tuple(chunk.shape), _dtype_str(chunk))
        x = self._inputs.get(key)
        if x is None:
            x = self._inputs[key] = torch.empty(
                chunk.shape, dtype=t.dtype, device=self.device)
        x.copy_(t)
        cd = self.compute_dtype
        if cd is not None and x.is_floating_point():
            return key, lambda: self._emit(self.module(x.to(cd)))
        return key, lambda: self._emit(self.module(x))

    @torch.no_grad()
    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        """The module's output for one bucket-sized chunk, through the
        graph of its geometry."""
        with self.graphs.pool.work():
            if self._tp is not None:
                if isinstance(chunk, torch.Tensor):  # broadcast from host
                    chunk = chunk.cpu().numpy()
                return self._tp.call("predict.forward", chunk)
            return self._run_chunk(chunk)

    @torch.no_grad()
    def _run_chunk(self, chunk: np.ndarray) -> np.ndarray:
        key, fn = self._stage(chunk)
        # a copy: the buffer is every forward's (a CPU tensor's .cpu()
        # would share it)
        return self.graphs.run(key, fn).to("cpu", copy=True).numpy()

    def preflight_lint(self, feat_shape, dtype, quiet: bool = False) -> int:
        """The lint of the served forward at the largest bucket and
        length, traced on fake tensors before anything is dispatched.
        Returns the report's exit code (0 = serve; nonzero = strict mode
        found error-severity findings); the summary annotation is kept
        either way. ``quiet``: a rank other than the first of a tp
        engine (it lints, and refuses, as rank 0 does, without
        printing)."""
        if self.lint_mode is None or self._linted:
            return 0
        self._linted = True
        from bigdl_tpu_torch.analysis import lint_fn
        from bigdl_tpu_torch.analysis.fx_walk import fake_mode
        from bigdl_tpu_torch.cli.common import run_preflight_lint

        row = tuple(feat_shape)
        if self.lengths:
            row = (self.lengths[-1],) + row[1:]
        mode = fake_mode()
        with mode:  # a fake input on the engine's device: no allocation
            x = torch.empty((self.buckets[-1],) + row, device=self.device,
                            dtype=torch.from_numpy(np.zeros((), dtype)).dtype)
        cd = self.compute_dtype

        def forward(x):
            if cd is not None and x.is_floating_point():
                x = x.to(cd)
            return self.module(x)

        with torch.no_grad():
            report = lint_fn(forward, x, mode=mode)
        rc, ann = run_preflight_lint(report,
                                     strict=(self.lint_mode == "strict"),
                                     quiet=quiet)
        self.lint_annotation = ann if rc == 0 else report.annotation()
        return rc

    @torch.no_grad()
    def warmup(self, feat_shape, dtype=np.float32) -> None:
        """Run every bucket once at every geometry the engine serves (each
        length bucket with ``lengths``, else ``feat_shape``), largest
        first, and on the card capture its graph; afterwards ``validate``
        refuses any other geometry. The first request then pays for no
        kernel build, library set-up or capture."""
        feat_shape, dt = tuple(feat_shape), np.dtype(dtype)
        geoms = ([(n,) + feat_shape[1:] for n in self.lengths]
                 if self.lengths else [feat_shape])
        with self.graphs.pool.work():
            for g in reversed(geoms):
                for b in reversed(self.buckets):
                    key, fn = self._stage(np.zeros((b,) + g, dt))
                    if not self.graphs.enabled:
                        fn()
                    elif key not in self.graphs:
                        self.graphs.capture(key, fn)
                self._served.add((g, dt.str))

    def close(self) -> None:
        """Drop the graphs, their static inputs and the output buffer."""
        with self.graphs.pool.work():
            self.graphs.clear()
            self._inputs.clear()
            self._served.clear()
            self._out = None

    def validate(self, x: np.ndarray) -> None:
        """Raise ValueError for an input the engine does not serve: token
        ids outside an LM's vocabulary (on a CUDA device an out-of-range
        gather is a device-side assert that ends the process, not an error
        one request can carry), rows longer than the largest length
        bucket, or, once ``warmup`` has run, a geometry it did not
        capture."""
        vocab = getattr(self.module, "vocab", None)
        if vocab is not None and x.size and not np.issubdtype(
                x.dtype, np.floating) and (x.min() < 0 or x.max() >= vocab):
            raise ValueError(f"token ids must be in [0, {vocab})")
        if self.lengths is not None and not 1 <= x.shape[1] <= \
                self.lengths[-1]:
            raise ValueError(f"rows of {x.shape[1]} positions: this engine "
                             f"serves 1 to {self.lengths[-1]}")
        if self._served and (self._geometry(x.shape[1:]),
                             x.dtype.str) not in self._served:
            served = sorted(f"{g} {np.dtype(d).name}"
                            for g, d in self._served)
            raise ValueError(f"rows of shape {tuple(x.shape[1:])} "
                             f"{x.dtype.name}: the geometries captured at "
                             f"start-up are {', '.join(served)}")

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the largest bucket (callers chunk)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def predict_scores(self, x, rids=None) -> np.ndarray:
        """Raw model outputs for every row of ``x`` (any row count): an
        array, or a tensor on the host or the card (a staged batch).
        ``rids``: the request id of each row, or None; each chunk's
        compute window goes to the requests whose rows it carried."""
        _fault_hook("infer")  # no-op unless --faultPlan installed one
        if isinstance(x, torch.Tensor) and self.lengths is not None:
            x = x.cpu().numpy()
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        n = len(x)
        if n == 0:
            return np.zeros((0,), np.float32)
        rt = _get_reqtracer() if rids is not None else None
        length = x.shape[1] if self.lengths is not None else None
        if length is not None and self._length_for(length) > length:
            # right-pad the positions, repeating the last: a causal
            # module's outputs at positions < length do not see them
            pad = [(0, 0), (0, self._length_for(length) - length)]
            x = np.pad(x, pad + [(0, 0)] * (x.ndim - 2), mode="edge")
        outs = []
        i = 0
        while i < n:
            take = min(n - i, self.buckets[-1])
            bucket = self.bucket_for(take)
            chunk = x[i:i + take]
            pad = bucket - take
            if pad > 0:
                # repeat the last real row: in-distribution filler
                chunk = (torch.cat([chunk, chunk[-1:].expand(
                    pad, *chunk.shape[1:])])
                         if isinstance(chunk, torch.Tensor) else
                         np.concatenate([chunk, np.repeat(chunk[-1:], pad,
                                                          axis=0)]))
            with _obs_span("infer", bucket=bucket, rows=take):
                t0c = rt.clock() if rt is not None else 0.0
                # a device OOM writes its memory report (--traceDir, the
                # fault log), then fails the request as before
                with _obs_mem.oom_guard("serving_predict"):
                    outs.append(self._forward(chunk)[:take])
            if rt is not None:
                t1c = rt.clock()
                for rid in rids[i:i + take]:
                    if rid is not None:
                        rt.note_compute(rid, t0c, t1c)
            if self._m_rows is not None:
                self._m_rows.inc(take)
                self._m_pad.inc(pad)
            i += take
        out = np.concatenate(outs)
        return out if length is None else out[:, :length]

    def provenance(self) -> dict:
        """The engine's config for ``/metrics`` scrapes: its buckets and
        dtype, and the shared core (``bn_fused``, ``autotune``,
        ``conv_layouts``, ``conv_geom_decisions``) of
        ``cli.provenance.provenance_dict``, as the JAX engine stamps it.
        ``device`` and ``length_buckets`` are the port's own."""
        from bigdl_tpu_torch.cli.provenance import provenance_dict

        dtype = (self.compute_dtype
                 or getattr(self.module, "compute_dtype", None)
                 or torch.float32)
        prov = {"buckets": ",".join(str(b) for b in self.buckets),
                "compute_dtype": str(dtype).replace("torch.", ""),
                **provenance_dict(self.module, flat=True),
                "device": str(self.device), "quantize": self.quantize}
        if self.lengths:
            prov["length_buckets"] = ",".join(str(n) for n in self.lengths)
        if self.lint_annotation is not None:
            prov["lint"] = self.lint_annotation
        return prov
