"""Device-memory attribution: explain every byte, forecast the fit,
autopsy the OOM (counterpart of ``bigdl_tpu/obs/memory.py``; the memory
twin of ``obs/attrib.py``). Four surfaces:

* **plan** -- :func:`build_plan`: a per-category byte table (parameters,
  optimizer state, gradients, activations, KV cache, input batch) of one
  training step. The known trees take their bytes; the measured total is
  the caching allocator's peak over a warmed step
  (``torch.cuda.reset_peak_memory_stats`` before it,
  ``max_memory_allocated`` after it, less what was allocated before the
  model was built), where the JAX plan reads the compiler's
  ``memory_analysis()``. The table totals to the measured number BY
  CONSTRUCTION: ``gradients`` takes ``min(gradient bytes, rest)`` and
  ``activations`` the remainder. Without a measurement (the CPU) the plan
  is abstract-only, as JAX's ``build_plan(compiled=None)`` is.
* **live sampling** -- :class:`HbmSampler` reads
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
  ``.peak``) and publishes ``hbm_bytes_in_use``, ``hbm_peak_bytes`` and
  ``hbm_largest_free_block_bytes`` gauges plus Chrome-trace counter
  events. The allocator exposes no largest free block: the gauge is the
  free bytes ``torch.cuda.mem_get_info`` reports plus the bytes the
  allocator reserved but has not handed out, and each reading says so.
  On the CPU every sample is a cheap None.
* **OOM post-mortem** -- the training dispatch, the perf harness's
  warm-up and the serving engines run inside :func:`oom_guard`, which
  hands an exception to :func:`handle_oom` and re-raises it; for a
  device OOM that writes a MemoryReport (the last plan, live stats, the
  largest live CUDA tensors, the headroom history) to the installed
  ``--traceDir`` and stamps the fault log.
* **fit forecaster** -- :func:`forecast` fits total bytes linearly over
  two plans at different batch sizes and predicts the max batch that
  fits the card; ``cli.explain --mem <model>`` renders it
  (:func:`plan_for_model` / :func:`render`).

The cross-layer channel is one module-level install:
``install(trace_dir=..., plan=..., sampler=...)`` arms the OOM path
process-wide, and a call site stays one ``with oom_guard(ctx):`` that
never changes the semantics of the run it observes (:func:`handle_oom`
never raises)."""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import time
from typing import Iterator, Optional, Tuple

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = [
    "CPU_NOMINAL_BYTES", "device_hbm_bytes", "tree_bytes", "build_plan",
    "forecast", "plan_for_model", "render", "compact",
    "serving_kv_plan", "forecast_slots",
    "HbmSampler", "install", "installed_plan", "installed_trace_dir",
    "is_resource_exhausted", "handle_oom", "oom_guard",
    "write_oom_report", "OOM_REPORT_NAME", "FREE_BLOCK_SOURCE",
]

# the CPU's nominal capacity, so headroom stays defined in CPU runs (the
# JAX table's "cpu" entry)
CPU_NOMINAL_BYTES = 8e9

OOM_REPORT_NAME = "memory_report.json"

# what hbm_largest_free_block_bytes reads (the allocator has no such
# number): said beside every reading
FREE_BLOCK_SOURCE = "mem_get_info free + reserved-but-unallocated"


def _is_cuda(device) -> bool:
    return device is not None and getattr(device, "type", device) == "cuda"


def device_hbm_bytes(device=None) -> Tuple[float, str]:
    """``(bytes, matched_label)`` of one device: on a card its
    ``total_memory`` (``torch.cuda.get_device_properties``), labelled
    ``total_memory(<name>)``; on the CPU the 8e9 nominal, labelled
    ``cpu``. ``device`` None is the card when there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_NOMINAL_BYTES, "cpu"
    props = torch.cuda.get_device_properties(device)
    return float(props.total_memory), f"total_memory({props.name})"


def tree_bytes(tree) -> int:
    """Total leaf bytes of a tree (dicts, lists, tuples) of tensors,
    numpy arrays, or anything exposing ``shape`` and ``dtype``."""
    if tree is None:
        return 0
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nbytes = getattr(tree, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def _grad_comm_pad(grad_comm: Optional[dict]) -> int:
    """Extra bytes the bucketed gradient all-reduce holds beyond the raw
    gradient tree (only the bucket padding counts)."""
    if not grad_comm:
        return 0
    pad = grad_comm.get("pad_bytes")
    if pad is not None:
        return int(pad)
    n = int(grad_comm.get("n_buckets") or 0)
    bb = grad_comm.get("bucket_bytes")
    total = grad_comm.get("total_bytes") or grad_comm.get("wire_bytes")
    if n and bb and total:  # worst case: the last bucket padded
        return max(0, int(n) * int(bb) - int(total))
    return 0


def _device_name(device) -> str:
    if _is_cuda(device):
        import torch
        return torch.cuda.get_device_name(device)
    return "cpu"


def build_plan(measured: Optional[int] = None, *, params=None,
               opt_state=None, batch=None, kv_cache=None,
               grad_comm: Optional[dict] = None, device=None,
               batch_size: Optional[int] = None,
               model_name: Optional[str] = None) -> dict:
    """The memory plan: a per-category byte table that totals to
    ``measured`` (the allocator's peak over one warmed step, bytes the
    step holds) when given. Without it the plan is abstract-only:
    argument-side rows from the trees, a parameter-sized gradient
    estimate, no activation row."""
    params_b = tree_bytes(params)
    opt_b = tree_bytes(opt_state)
    input_b = tree_bytes(batch)
    kv_b = tree_bytes(kv_cache)
    grads_b = params_b + _grad_comm_pad(grad_comm)

    cats = {"params": params_b, "optimizer": opt_b, "gradients": grads_b,
            "activations": 0, "kv_cache": kv_b, "input": input_b,
            "outputs": 0, "unattributed": 0}
    if measured is not None:
        measured = int(measured)
        known = params_b + opt_b + input_b + kv_b
        if known <= measured:
            rest = measured - known
            cats["gradients"] = min(grads_b, rest)
            cats["activations"] = rest - cats["gradients"]
        else:
            # the trees overshoot the peak (a tree the step never held on
            # the card): scale the known rows down so the table totals
            scale = measured / known
            for k in ("params", "optimizer", "kv_cache", "input"):
                cats[k] = int(cats[k] * scale)
            cats["gradients"] = 0
            cats["unattributed"] = measured - (
                cats["params"] + cats["optimizer"] + cats["kv_cache"]
                + cats["input"])
        total = sum(cats.values())
    else:
        total = params_b + opt_b + grads_b + input_b + kv_b

    hbm, hbm_label = device_hbm_bytes(device)
    plan = {
        "categories": cats,
        "total_bytes": int(total),
        "measured_total_bytes": measured,
        "hbm_bytes": int(hbm),
        "hbm_match": hbm_label,
        "headroom_bytes": int(hbm - total),
        "headroom_frac": round((hbm - total) / hbm, 4) if hbm else None,
        "batch": batch_size,
    }
    if model_name:
        plan["model"] = model_name
    plan["device"] = _device_name(device)
    return plan


def forecast(plan_small: dict, plan_big: dict) -> dict:
    """Linear fit of total bytes over batch size from two plans:
    ``total(b) = fixed + slope * b`` (the slope is the per-sample
    activation and input cost, the intercept the model-resident state);
    predicts the max batch that still fits the device."""
    na, nb = plan_small.get("batch"), plan_big.get("batch")
    if not na or not nb or na == nb:
        raise ValueError("forecast needs two plans at distinct batch "
                         f"sizes, got {na!r} and {nb!r}")
    if na > nb:
        plan_small, plan_big, na, nb = plan_big, plan_small, nb, na
    ta = float(plan_small["total_bytes"])
    tb = float(plan_big["total_bytes"])
    slope = (tb - ta) / (nb - na)
    fixed = ta - slope * na
    cap = float(plan_big["hbm_bytes"])
    if slope > 0:
        max_batch = int(math.floor((cap - fixed) / slope))
    else:  # degenerate (a toy model): no bound
        max_batch = None
    return {
        "bytes_per_sample": int(slope),
        "fixed_bytes": int(fixed),
        "fit_batches": [na, nb],
        "hbm_bytes": int(cap),
        "predicted_max_batch": (max_batch if max_batch is None
                                else max(max_batch, 0)),
    }


def _free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def plan_for_model(model_name: str, batch: int,
                   seq_len: Optional[int] = None, use_bf16: bool = True,
                   device=None) -> dict:
    """The memory plan of one ``cli.perf`` training step of a zoo model
    at ``batch`` (SGD with momentum on one resident batch, bf16
    activations as ``cli.perf``'s default unless ``use_bf16`` is False):
    the ``explain --mem`` and forecaster entry. On the card the step runs
    twice and the second's allocator peak is the measured total; on the
    CPU (``device="cpu"``) nothing runs and the plan is abstract-only."""
    import torch

    from bigdl_tpu_torch.cli import perf
    from bigdl_tpu_torch.core.module import resolve_device

    device = resolve_device(device)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    measured = None
    if device.type == "cuda":
        _free_card(torch)
        base = torch.cuda.memory_allocated(device)
    step, model, _, _ = perf.train_step(model_name, batch, dtype, device,
                                        seq_len=seq_len)
    if device.type == "cuda":
        float(step())  # builds the kernels and the step's workspaces
        torch.cuda.reset_peak_memory_stats(device)
        float(step())
        measured = torch.cuda.max_memory_allocated(device) - base
    plan = build_plan(measured, params=dict(model.named_parameters()),
                      opt_state=step.opt_state, batch=step.batch,
                      device=device, batch_size=batch,
                      model_name=model_name)
    del step, model
    if device.type == "cuda":
        _free_card(torch)
    return plan


def serving_kv_plan(model_name: str, *, seq_len: Optional[int] = None,
                    page_tokens: Optional[int] = None,
                    quantize: Optional[str] = None,
                    cache_dtype=None, device=None) -> dict:
    """Per-slot serving byte accounting for a transformer_lm row: the KV
    cache of one decode slot (a dense slab, or the kv8 page-pool layout:
    int8 rows plus one f32 scale per (page, head, token), as
    ``serving.kv_pages.QuantPool`` holds them) and the resident weight
    bytes under ``--quantize`` (``serving.quant.weight_bytes``). The
    dtype-aware half of ``explain --mem``: :func:`forecast_slots` fits
    the max slots from it."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.cli.perf import build_model
    from bigdl_tpu_torch.serving.quant import (parse_quantize,
                                               quantize_params,
                                               weight_bytes)

    if not model_name.startswith("transformer_lm"):
        raise ValueError("serving_kv_plan targets transformer_lm* models "
                         f"(decode KV slots), got {model_name!r}")
    model, _ = build_model(model_name, seq_len=seq_len)
    wfmt, kv8 = parse_quantize(quantize) if quantize else (None, False)
    L = int(model.max_len)
    pt = page_tokens
    if kv8 and pt is None:
        # the serve CLI's page ladder for --quantize kv8
        for cand in (128, 64, 32, 256):
            if L % cand == 0:
                pt = cand
                break
        if pt is None:
            raise ValueError(f"no page size in (128, 64, 32, 256) "
                             f"divides max_len {L}; pass page_tokens")
    dt = np.dtype(cache_dtype) if cache_dtype is not None \
        else np.dtype(np.float32)
    tdt = torch.from_numpy(np.zeros(0, dt)).dtype
    kv_slot = 0
    for layer in model.init_cache(1, L, tdt):
        for leaf in layer.values():
            _, kh, _, hd = leaf.shape
            if kv8:
                # QuantPool: q int8 (pages, kh, pt, hd) + s f32 (pages,
                # kh, pt); a slot owns L/pt pages
                kv_slot += (L // pt) * (kh * pt * hd * 1 + kh * pt * 4)
            else:
                kv_slot += leaf.numel() * leaf.element_size()
    dense_b = weight_bytes(model)
    if wfmt is not None:
        model = quantize_params(model, wfmt)
    params_b = weight_bytes(model)
    hbm, hbm_label = device_hbm_bytes(device)
    return {
        "model": model_name,
        "quantize": quantize or "off",
        "max_len": L,
        "page_tokens": pt,
        "cache_dtype": dt.name,
        "kv_bytes_per_slot": int(kv_slot),
        "params_bytes": int(params_b),
        "params_bytes_f32": int(dense_b),
        "hbm_bytes": int(hbm),
        "hbm_match": hbm_label,
    }


def forecast_slots(plan: dict, hbm_bytes=None) -> dict:
    """Max decode slots that fit: ``(hbm - weights) / kv_bytes_per_slot``,
    the serving twin of :func:`forecast`."""
    cap = float(hbm_bytes if hbm_bytes is not None
                else plan["hbm_bytes"])
    fixed = float(plan["params_bytes"])
    per = float(plan["kv_bytes_per_slot"])
    n = int(math.floor((cap - fixed) / per)) if per > 0 else None
    return {
        "hbm_bytes": int(cap),
        "fixed_bytes": int(fixed),
        "kv_bytes_per_slot": int(per),
        "predicted_max_slots": (max(n, 0) if n is not None else None),
    }


# ------------------------------------------------------------ rendering
def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return (f"{n:.0f} {unit}" if unit == "B"
                    else f"{n:.2f} {unit}")
        n /= 1024.0
    return f"{n:.2f} GiB"


def render(plan: dict, fc: Optional[dict] = None) -> str:
    """Human table of the plan (and forecast, when given)."""
    from bigdl_tpu_torch.utils.table import format_table

    total = max(1, plan["total_bytes"])
    rows = []
    for cat, b in plan["categories"].items():
        if not b:
            continue
        rows.append([cat, _fmt_bytes(b), f"{100.0 * b / total:.1f}%"])
    rows.append(["TOTAL", _fmt_bytes(plan["total_bytes"]), "100.0%"])
    lines = [format_table(["category", "bytes", "frac"], rows)]
    mt = plan.get("measured_total_bytes")
    if mt is not None:
        drift = (abs(plan["total_bytes"] - mt) / mt * 100.0) if mt else 0.0
        lines.append(f"allocator peak      {_fmt_bytes(mt)}  "
                     f"(table drift {drift:.2f}%)")
    lines.append(f"device HBM          {_fmt_bytes(plan['hbm_bytes'])}  "
                 f"(match: {plan['hbm_match']})")
    hf = plan.get("headroom_frac")
    lines.append(f"headroom            "
                 f"{_fmt_bytes(plan['headroom_bytes'])}  "
                 f"({100.0 * hf:.1f}% free)" if hf is not None else
                 f"headroom            {_fmt_bytes(plan['headroom_bytes'])}")
    if fc is not None:
        lines.append("")
        lines.append(f"per-sample slope    "
                     f"{_fmt_bytes(fc['bytes_per_sample'])}/sample "
                     f"(fit over b={fc['fit_batches']})")
        lines.append(f"fixed (model state) {_fmt_bytes(fc['fixed_bytes'])}")
        mb = fc.get("predicted_max_batch")
        lines.append(f"predicted max batch "
                     f"{mb if mb is not None else 'unbounded (flat slope)'}")
    return "\n".join(lines)


def compact(plan: dict) -> dict:
    """The small spelling stamped into perf lines as the ``mem`` dict."""
    return {
        "categories": {k: int(v) for k, v in plan["categories"].items()
                       if v},
        "total_bytes": plan["total_bytes"],
        "measured_total_bytes": plan.get("measured_total_bytes"),
        "hbm_bytes": plan["hbm_bytes"],
        "hbm_match": plan["hbm_match"],
        "headroom_frac": plan.get("headroom_frac"),
        "batch": plan.get("batch"),
    }


# --------------------------------------------------------- live sampling
class HbmSampler:
    """Live device-memory readings from the caching allocator: gauges on
    the shared registry, Chrome-trace counter events, and a bounded
    headroom history for the OOM post-mortem. On the CPU every sample is
    a cheap None and the gauges never appear. The readings are the
    process's; ``base_bytes`` (what the process held before the run
    began) rides beside them in :meth:`annotation`."""

    def __init__(self, device=None, registry=None, history: int = 512,
                 trace_counters: bool = True, base_bytes: int = 0):
        import torch

        if device is not None:
            device = torch.device(device)
        self.device = device if _is_cuda(device) else None
        self.hbm_bytes, self.hbm_match = device_hbm_bytes(device or "cpu")
        self.trace_counters = trace_counters
        self.history: list = []  # [(step, bytes_in_use, peak)] bounded
        self._history_cap = int(history)
        self.last: Optional[dict] = None
        self._peak_seen = 0
        self._registered = False
        self._registry = registry
        self.base_bytes = int(base_bytes)

    def _read(self) -> dict:
        import torch

        stats = torch.cuda.memory_stats(self.device)
        alloc = int(stats.get("allocated_bytes.all.current", 0))
        reserved = int(stats.get("reserved_bytes.all.current", 0))
        free, _ = torch.cuda.mem_get_info(self.device)
        return {"bytes_in_use": alloc,
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", 0)),
                "reserved_bytes": reserved,
                "largest_free_block_bytes": int(free) + reserved - alloc}

    def _ensure_gauges(self) -> None:
        if self._registered:
            return
        from bigdl_tpu_torch.obs.metrics import get_registry
        reg = self._registry or get_registry()
        reg.gauge("hbm_bytes_in_use", "live device bytes in use",
                  fn=lambda: (self.last or {}).get("bytes_in_use", 0))
        reg.gauge("hbm_peak_bytes", "peak device bytes in use",
                  fn=lambda: self._peak_seen)
        reg.gauge("hbm_largest_free_block_bytes",
                  f"bytes the card could still hand out "
                  f"({FREE_BLOCK_SOURCE})",
                  fn=lambda: (self.last or {}).get(
                      "largest_free_block_bytes", 0))
        self._registered = True

    def sample(self, step: Optional[int] = None) -> Optional[dict]:
        """One live reading; the normalized stats dict, or None on the
        CPU or when the allocator cannot be read."""
        if self.device is None:
            return None
        try:
            s = self._read()
        except RuntimeError:
            return None
        self.last = s
        self._peak_seen = max(self._peak_seen,
                              s["peak_bytes_in_use"] or s["bytes_in_use"])
        self._ensure_gauges()
        if len(self.history) >= self._history_cap:
            del self.history[: self._history_cap // 2]
        self.history.append((step, s["bytes_in_use"],
                             s["peak_bytes_in_use"]))
        if self.trace_counters:
            from bigdl_tpu_torch.obs.spans import counter as _counter
            _counter("hbm", {"bytes_in_use": s["bytes_in_use"],
                             "largest_free_block":
                                 s["largest_free_block_bytes"]})
        return s

    @property
    def peak_bytes(self) -> Optional[int]:
        return self._peak_seen or None

    def annotation(self) -> Optional[dict]:
        if self.last is None:
            return None
        return {"last": dict(self.last), "peak_bytes": self._peak_seen,
                "base_bytes": self.base_bytes,
                "samples": len(self.history),
                "largest_free_block_source": FREE_BLOCK_SOURCE}


# ------------------------------------------------------ OOM post-mortem
# process-wide context, armed once by install_observability
_CONTEXT: dict = {"trace_dir": None, "plan": None, "sampler": None}


def install(trace_dir: Optional[str] = None, plan: Optional[dict] = None,
            sampler: Optional[HbmSampler] = None) -> None:
    """Arm the OOM post-mortem path process-wide. Each argument updates
    only when given, so the CLI installs the trace dir early and the
    harness the plan later."""
    if trace_dir is not None:
        _CONTEXT["trace_dir"] = str(trace_dir)
    if plan is not None:
        _CONTEXT["plan"] = plan
    if sampler is not None:
        _CONTEXT["sampler"] = sampler


def installed_plan() -> Optional[dict]:
    return _CONTEXT["plan"]


def installed_trace_dir() -> Optional[str]:
    return _CONTEXT["trace_dir"]


def _reset_context() -> None:  # tests
    _CONTEXT.update(trace_dir=None, plan=None, sampler=None)


def is_resource_exhausted(exc: BaseException) -> bool:
    """Is this exception a device OOM? ``torch.cuda.OutOfMemoryError``,
    or a message with "CUDA out of memory" (the allocator's) or the JAX
    package's RESOURCE_EXHAUSTED spellings."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return ("CUDA out of memory" in msg
            or "RESOURCE_EXHAUSTED" in msg
            or "Resource exhausted" in msg
            or "Out of memory" in msg)


def _top_live_buffers(n: int = 15) -> list:
    """The N largest live tensors on the card (on the CPU when CUDA was
    never initialised): who holds the bytes at crash time. Tensors that
    share a storage count once, as the storage's bytes."""
    import gc

    import torch

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    seen: dict = {}
    for obj in gc.get_objects():
        try:
            # type(), not isinstance: a module-level proxy object can warn
            # when its __class__ is read
            if not issubclass(type(obj), torch.Tensor) \
                    or obj.is_cuda != on_card or obj.is_meta:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), str(obj.device))
            nbytes = st.nbytes()
        except (RuntimeError, ReferenceError):
            continue
        if nbytes and key not in seen:
            seen[key] = {"shape": list(obj.shape), "dtype": str(obj.dtype),
                         "device": str(obj.device), "nbytes": int(nbytes)}
    rows = sorted(seen.values(), key=lambda r: -r["nbytes"])
    return rows[:n]


def write_oom_report(trace_dir: str, *, context: str,
                     exc: Optional[BaseException] = None,
                     plan: Optional[dict] = None,
                     sampler: Optional[HbmSampler] = None) -> str:
    """Write the MemoryReport JSON to ``trace_dir`` and return its path
    (:func:`handle_oom` adds the installed context and the never-raise
    wrapping)."""
    report = {
        "event": "oom",
        "context": context,
        "time": time.time(),
        "error": (f"{type(exc).__name__}: {exc}"[:500]
                  if exc is not None else None),
        "plan": plan,
        "live": sampler.annotation() if sampler is not None else None,
        "headroom_history": (list(sampler.history[-64:])
                             if sampler is not None else []),
        "top_live_buffers": _top_live_buffers(),
    }
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, OOM_REPORT_NAME)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def handle_oom(exc: BaseException, context: str) -> Optional[str]:
    """Call from an except clause around a dispatch (then re-raise).
    For a device OOM: writes the MemoryReport to the installed trace
    dir, appends the event to the fault log (``BIGDL_FAULT_LOG``), drops
    an instant event on the span timeline and bumps ``oom_total``.
    Returns the report's path (or None); NEVER raises: the autopsy must
    not change how the crash propagates."""
    try:
        if not is_resource_exhausted(exc):
            return None
        path = None
        trace_dir = _CONTEXT["trace_dir"]
        if trace_dir:
            try:
                path = write_oom_report(trace_dir, context=context,
                                        exc=exc, plan=_CONTEXT["plan"],
                                        sampler=_CONTEXT["sampler"])
                logger.error("OOM in %s: memory report -> %s",
                             context, path)
            except Exception as we:
                logger.warning("OOM report write failed: %s", we)
        else:
            logger.error("OOM in %s (no --traceDir: post-mortem report "
                         "skipped): %s", context, str(exc)[:200])
        # the fault log's JSONL + fsync contract (resilience.faults)
        log_path = os.environ.get("BIGDL_FAULT_LOG")
        if log_path:
            try:
                with open(log_path, "a") as f:
                    f.write(json.dumps({
                        "event": "oom", "context": context,
                        "report": path,
                        "error": f"{type(exc).__name__}: {exc}"[:200],
                        "time": time.time()}) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        from bigdl_tpu_torch.obs.metrics import get_registry
        from bigdl_tpu_torch.obs.spans import instant as _instant
        _instant("oom", context=context, report=path)
        get_registry().counter(
            "oom_total", "device OOM crashes autopsied").inc()
        return path
    except Exception as e:  # the autopsy never raises
        logger.warning("OOM handler failed: %s", e)
        return None


@contextlib.contextmanager
def oom_guard(context: str) -> Iterator[None]:
    """``with oom_guard("train_dispatch"): step()``: an exception from
    the body goes through :func:`handle_oom` (a report for a device OOM)
    and propagates unchanged; nothing is retried or swallowed."""
    try:
        yield
    except Exception as e:
        handle_oom(e, context)
        raise
