"""Temperature / top-k / top-p sampling on the device for the decode
engine (counterpart of ``warp_logits``/``sample_token``/``request_key`` in
``bigdl_tpu/serving/spec_decode.py``).

One vectorised pass over all slots: the knobs (``temp``, ``top_k``,
``top_p``, ``seed``) are per-slot tensors on the logits' device, and
nothing here reads a value back to the host, so the pass runs inside a
captured decode step. ``top_k = 0`` and ``top_p >= 1`` disable their
filters exactly (the keep mask is all True, so the warp is bitwise
``logits / temp``).

Randomness is a counter hash of (request seed, position, stream tag): the
splitmix64 finaliser dropout uses (``nn.structural``), folded as
``jax.random.fold_in`` folds a key. An eager step and a graph replay draw
the same token for the same seed and position, on any device; the numbers
are not those of jax's threefry. A draw is Gumbel-max over the warped
logits with 24-bit uniforms from the hash of (key, vocabulary index).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.core.module import (_GOLDEN, _MIX1, _MIX2, _mix, _srl,
                                         fold_seed)

__all__ = ["warp_logits", "sample_tokens", "sample_token", "request_key",
           "uniforms", "gumbel_noise", "STREAM_STEP", "STREAM_DRAFT",
           "STREAM_ACCEPT", "STREAM_RESIDUAL"]

# stream tags folded into per-request keys, as in the JAX package, so the
# consumers of randomness never share a counter
STREAM_STEP = 0        # plain-path sampling at a position
STREAM_DRAFT = 1       # draft proposal sampling (speculative)
STREAM_ACCEPT = 2      # acceptance uniforms (speculative)
STREAM_RESIDUAL = 3    # rejection-residual resampling (speculative)


def _fold(key: torch.Tensor, i) -> torch.Tensor:
    """splitmix64 of (key, i): ``fold_seed``, with an int or a tensor
    counter (whose product wraps in int64)."""
    if isinstance(i, int):
        return fold_seed(key, i)
    return _mix(key * _GOLDEN + (i + 1) * _MIX1)


def request_key(seed, pos, stream: int = STREAM_STEP) -> torch.Tensor:
    """int64 key(s) of (request seed, position, stream): the same seed,
    position and stream give the same key, eagerly or in a replay."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=seed.device)
    return _fold(_fold(seed, pos), stream)


def uniforms(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) f32 uniforms in (0, 1) from (...,) int64 keys: entry j is
    the top 24 bits of the hash of (key, j), moved half a step off 0 and
    1."""
    idx = torch.arange(n, device=key.device, dtype=torch.int64)
    bits = _srl(_mix(idx * _MIX2 + key[..., None] * _GOLDEN), 40)
    return (bits.float() + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(key: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., vocab) f32 Gumbel(0, 1) noise from (...,) int64 keys, one
    :func:`uniforms` draw an entry."""
    return -torch.log(-torch.log(uniforms(key, vocab)))


def _knob(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """A per-row knob as a tensor on ``like``'s device, (...,) to match
    ``like``'s leading dims (Python numbers broadcast)."""
    t = torch.as_tensor(x, dtype=dtype, device=like.device)
    return t.expand(like.shape[:-1])


def warp_logits(logits: torch.Tensor, temp, top_k, top_p) -> torch.Tensor:
    """Warp (..., vocab) logits row by row: divide by ``temp`` (``temp <=
    0`` leaves the row unscaled), keep the ``top_k`` largest (0 keeps all)
    and the smallest prefix of descending probabilities whose mass reaches
    ``top_p`` (>= 1 keeps all); the rest become -1e30. The knobs are
    (...,) tensors or numbers. One descending sort serves both filters,
    and thresholds replace a top-k of traced size, as in the JAX
    package."""
    v = logits.shape[-1]
    temp = _knob(temp, logits, logits.dtype)
    top_k = _knob(top_k, logits, torch.int64)
    top_p = _knob(top_p, logits, logits.dtype)
    lg = logits / torch.where(temp > 0, temp, 1.0)[..., None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    keep = lg >= srt.gather(-1, (k - 1)[..., None])
    prob = torch.softmax(srt, dim=-1)
    nucleus = (torch.cumsum(prob, dim=-1) - prob) < torch.clamp(
        top_p, 0.0, 1.0)[..., None]
    n_keep = torch.clamp(nucleus.sum(dim=-1), min=1)
    pth = srt.gather(-1, (n_keep - 1)[..., None])
    keep &= (top_p >= 1.0)[..., None] | (lg >= pth)
    return lg.masked_fill(~keep, -1e30)


def sample_tokens(logits, pos, temp, top_k, top_p, seed,
                  warp: bool = True) -> torch.Tensor:
    """(S,) int64 tokens from (S, vocab) f32 logits and (S,) knobs: the
    argmax of the raw logits where ``temp <= 0``, else a Gumbel-max draw
    keyed by (seed, pos). ``warp=False`` is the sort-free program of
    temperature-only traffic; with the filters off both programs draw the
    same token."""
    greedy = torch.argmax(logits, dim=-1)
    if warp:
        lg = warp_logits(logits, temp, top_k, top_p)
    else:
        lg = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    noise = gumbel_noise(request_key(seed, pos), logits.shape[-1])
    sampled = torch.argmax(lg + noise, dim=-1)
    return torch.where(temp > 0, sampled, greedy)


def sample_token(logits: torch.Tensor, temp: float, top_k: int, top_p: float,
                 seed: int, pos: int) -> int:
    """One token from a (vocab,) logit vector, as the engine draws it for a
    request of ``seed`` at position ``pos``."""
    lg = logits.float()[None]
    dev = lg.device

    def t(x, dt):
        return torch.tensor([x], dtype=dt, device=dev)

    return int(sample_tokens(lg, t(pos, torch.int64),
                             t(temp, torch.float32), t(top_k, torch.int64),
                             t(top_p, torch.float32),
                             t(int(seed) & 0xFFFFFFFF, torch.int64))[0])
