"""Quantized serving weights: per-channel int8 or fp8 with the dequant
folded into the product (counterpart of ``bigdl_tpu/serving/quant.py``).

The 2-D projection weights (``Linear``, the attention projections, the
MLP pair and the tied embedding) go to 8 bits when an engine is built,
and the modules' own forwards read them unchanged:

* :class:`QuantizedWeight` is a module holding the 8-bit tensor ``q`` and
  one f32 ``scale`` per channel of axis 1 (per-channel symmetric) as
  buffers, so a model moves, and a captured graph reads, the 8-bit bytes.
  :func:`quantize_params` puts one where each eligible parameter was.
* The modules read a weight as ``x @ w.to(x.dtype)`` (and the tied head
  as ``h @ w.to(h.dtype).T``). ``QuantizedWeight.to(dtype)`` returns a
  :class:`_QView`, and the product lands in its ``__rmatmul__``:
  ``(x @ q.to(dt)) * scale``, the scale an epilogue on the output channels
  (exact: it commutes with the contraction); the transposed head folds it
  into the prologue instead, ``(h * scale) @ q.to(dt).T``, the scale then
  on the contraction channels.
* ``LookupTable`` gathers through :meth:`QuantizedWeight.take_rows`: the
  8-bit rows, then the scale.

The product is ``q.to(dt)`` and ``torch.matmul``, the JAX package's
dequant-fused default. Its native-int8 kind, chosen per shape by the
``quant`` namespace of tuning, waits for the port's tuning.

Quality is measured: :func:`quant_report` decodes greedily through the
full-precision and the quantized model, teacher-forced on the first's
tokens, and reports their argmax agreement and largest logit difference.
The 8-bit KV pools (``kv8``) live in ``serving.kv_pages``; this module
holds the weights and :func:`kv_fake_quant`, the pools' round trip on a
dense tensor.
"""

from __future__ import annotations

import copy
import logging
from typing import Optional, Tuple

import torch
from torch import nn

from bigdl_tpu_torch.serving.kv_pages import kv_quant_rows

logger = logging.getLogger(__name__)

__all__ = ["QuantizedWeight", "quantize_weight", "quantize_params",
           "is_quantized", "parse_quantize", "fp8_supported",
           "kv_fake_quant", "quant_report", "weight_bytes",
           "QUANTIZE_CHOICES"]

QUANTIZE_CHOICES = ("off", "int8", "fp8", "kv8", "int8+kv8", "fp8+kv8")

# parameter names of the 2-D projection weights across the model zoo; the
# biases and norm scales stay in full precision
_QUANT_KEYS = frozenset({"weight", "wq", "wk", "wv", "wo", "w1", "w2"})

_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
_EPS = 1e-8


def fp8_supported() -> bool:
    """True where this torch build has ``float8_e4m3fn``."""
    return hasattr(torch, "float8_e4m3fn")


def parse_quantize(mode: Optional[str]) -> Tuple[Optional[str], bool]:
    """``--quantize`` value -> ``(weight_fmt, kv8)``, weight_fmt
    ``"int8"``, ``"fp8"`` or None. ``fp8`` falls back to ``int8`` (with a
    log line) where torch has no ``float8_e4m3fn``."""
    if mode is None:
        return None, False
    mode = str(mode)
    if mode not in QUANTIZE_CHOICES:
        raise ValueError(
            f"--quantize must be one of {'/'.join(QUANTIZE_CHOICES)}, "
            f"got {mode!r}")
    if mode == "off":
        return None, False
    parts = mode.split("+")
    wfmt = next((p for p in parts if p in ("int8", "fp8")), None)
    if wfmt == "fp8" and not fp8_supported():
        logger.warning("quantize: this torch build has no float8_e4m3fn; "
                       "falling back to int8 weights")
        wfmt = "int8"
    return wfmt, "kv8" in parts


class QuantizedWeight(nn.Module):
    """A 2-D weight stored in 8 bits with per-channel f32 scales over axis
    1. ``shape`` is the logical weight's. ``.to(dtype)`` gives the
    :class:`_QView` the modules multiply by; a device move moves ``q`` and
    ``scale``, and no cast changes their dtypes."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, fmt: str):
        super().__init__()
        self.fmt = fmt
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def extra_repr(self) -> str:
        return f"{self.fmt}, shape={tuple(self.shape)}, q={self.q.dtype}"

    def _apply(self, fn, recurse=True):
        # follow a device move only: the 8-bit tensor and its f32 scales
        # keep their dtypes under a model's .to(dtype) or .half()
        dev = fn(self.scale[:0]).device
        self.q, self.scale = self.q.to(dev), self.scale.to(dev)
        return self

    def to(self, *args, **kwargs):
        if len(args) == 1 and not kwargs and isinstance(args[0], torch.dtype):
            return _QView(self, args[0], transposed=False)
        return super().to(*args, **kwargs)

    def take_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """The embedding gather: 8-bit rows, then scaled -> f32 rows, as a
        gather from the dequantized weight gives."""
        return self.q[idx.long()].to(self.scale.dtype) * self.scale

    def dequantize(self) -> torch.Tensor:
        """The full-precision weight back (tests and reports)."""
        return self.q.to(self.scale.dtype) * self.scale[None, :]


class _QView:
    """What ``QuantizedWeight.to(dtype)`` hands a module: not a tensor, so
    ``x @ view`` falls to :meth:`__rmatmul__`, where the dequant folds
    into the product."""

    __slots__ = ("_w", "_dt", "_transposed")

    def __init__(self, w: QuantizedWeight, dt, transposed: bool):
        self._w, self._dt, self._transposed = w, dt, transposed

    @property
    def T(self) -> "_QView":
        return _QView(self._w, self._dt, not self._transposed)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self._w, self._dt
        scale = w.scale.to(dt)
        if self._transposed:
            # w is (n, k) with its scale on k, the contraction dim here:
            # x @ (q * s).T == (x * s) @ q.T
            return (x * scale) @ w.q.to(dt).T
        # the scale is on the output channels: it commutes with the
        # contraction
        return (x @ w.q.to(dt)) * scale


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedWeight)


def quantize_weight(w: torch.Tensor, fmt: str = "int8") -> QuantizedWeight:
    """Per-channel symmetric quantization of a 2-D weight over axis 1: one
    scale a column (an output channel of ``x @ w``; a contraction channel
    of the tied head's ``h @ w.T``)."""
    if is_quantized(w):
        return w
    if w.ndim != 2:
        raise ValueError(f"quantize_weight wants a 2-D weight, got shape "
                         f"{tuple(w.shape)}")
    if fmt == "fp8" and not fp8_supported():
        fmt = "int8"
    wf = w.detach().float()
    amax = wf.abs().amax(dim=0).clamp_min(_EPS)
    if fmt == "int8":
        scale = amax / 127.0
        q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    elif fmt == "fp8":
        scale = amax / _FP8_MAX
        q = (wf / scale[None, :]).clamp(-_FP8_MAX, _FP8_MAX).to(
            torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantize format {fmt!r}")
    return QuantizedWeight(q, scale, fmt)


def _eligible(module: nn.Module):
    """(owner, name, parameter) of every eligible projection weight."""
    for owner in module.modules():
        for name, p in owner.named_parameters(recurse=False):
            if (name in _QUANT_KEYS and p.ndim == 2
                    and p.dtype.is_floating_point):
                yield owner, name, p


def quantize_params(module: nn.Module, fmt: Optional[str]) -> nn.Module:
    """A copy of ``module`` whose eligible projection weights (parameters
    named in ``_QUANT_KEYS``, 2-D, floating) are :class:`QuantizedWeight`
    modules; the rest is copied as it is. ``fmt`` None returns ``module``,
    and so does a module with nothing left to quantize (engines may apply
    this to a model the CLI quantized)."""
    if fmt is None:
        return module
    found = list(_eligible(module))
    if not found:
        return module
    # copy everything but the weights about to be replaced
    memo = {id(p): None for _, _, p in found}
    qmod = copy.deepcopy(module, memo)
    owners = dict(qmod.named_modules())
    names = {id(m): n for n, m in module.named_modules()}
    for owner, name, p in found:
        target = owners[names[id(owner)]]
        delattr(target, name)
        setattr(target, name, quantize_weight(p, fmt))
    return qmod


def weight_bytes(module: nn.Module) -> int:
    """Bytes of the weights a forward reads: every parameter, and the 8-bit
    tensors and scales of the quantized ones."""
    return (sum(p.numel() * p.element_size() for p in module.parameters())
            + sum(m.nbytes for m in module.modules() if is_quantized(m)))


def kv_fake_quant(vals: torch.Tensor) -> torch.Tensor:
    """``vals`` (..., head_dim) through the kv8 storage format
    (``serving.kv_pages.kv_quant_rows``) and back, as a pool's gather
    dequantizes: a dense cache put through this equals a quantized pool
    gathered back, bit for bit."""
    q, s = kv_quant_rows(vals)
    return (q.float() * s[..., None]).to(vals.dtype)


@torch.no_grad()
def quant_report(model, qmodel, *, prompt, max_new_tokens: int = 16,
                 kv8: bool = False, cache_dtype=None) -> dict:
    """Greedy-decode quality of ``qmodel`` against ``model``: both decode
    ``prompt`` teacher-forced on ``model``'s greedy tokens, so each
    step's logits compare like for like. ``kv8`` also puts the quantized
    run's cache rows through the kv8 format as they are written (the
    prompt's once, each decoded token's as it lands), the paged pools'
    semantics on a dense cache. Returns ``{"agreement": argmax match
    rate, "logit_max_err": max |logits_q - logits|, "steps": n}``."""
    dev, cache_dtype = model.device, cache_dtype or torch.float32
    toks = torch.tensor([list(prompt)], dtype=torch.long, device=dev)
    p = toks.shape[1]
    max_len = p + int(max_new_tokens)

    def run(m, fake, forced):
        cache = m.init_cache(1, max_len, cache_dtype)
        outs = [m.prefill_logits(toks, cache).float()]
        if fake:
            for layer in cache:
                for t in layer.values():
                    t[:, :, :p] = kv_fake_quant(t[:, :, :p])
        for i in range(int(max_new_tokens) - 1):
            tok = (forced[i] if forced is not None
                   else torch.argmax(outs[-1], dim=-1))
            outs.append(m.decode_logits(tok.reshape(1, 1), cache,
                                        p + i).float())
            if fake:
                for layer in cache:
                    for t in layer.values():
                        t[:, :, p + i] = kv_fake_quant(t[:, :, p + i])
        return torch.stack(outs, 0)  # (steps, 1, vocab)

    ref = run(model, False, None)
    got = run(qmodel, kv8, list(torch.argmax(ref, dim=-1)))
    agree = float((ref.argmax(-1) == got.argmax(-1)).float().mean())
    err = float((ref.double() - got.double()).abs().max())
    return {"agreement": agree, "logit_max_err": err,
            "steps": int(ref.shape[0])}
