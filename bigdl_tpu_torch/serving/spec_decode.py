"""Speculative decoding primitives (counterpart of
``bigdl_tpu/serving/spec_decode.py``).

A draft LM proposes K tokens with K cheap single-token steps; the target
LM scores them all, and the position after them, in one chunked
``verify_logits``, and an exact acceptance rule decides how many stand.
The target then runs ``1/(accepted+1)`` steps per emitted token, and the
output distribution is unchanged:

* **greedy** (temperature 0): proposal j stands iff it is the target's
  argmax at its position; the first rejection is replaced by that argmax,
  and a full acceptance appends the bonus argmax. Token for token the
  sequence plain greedy decoding emits.
* **sampled**: speculative rejection sampling (Leviathan et al., Chen et
  al.): a proposal ``d ~ q`` stands with probability ``min(1, p(d) /
  q(d))``; the first rejection is redrawn from ``normalize(max(p - q,
  0))``, and a full acceptance draws the bonus from ``p``. The emitted
  tokens are distributed as draws from the target alone.

Both functions run over every slot at once (leading dims, where the JAX
package ``vmap``s one slot's function) with per-slot knob tensors, and
read nothing back to the host, so they run inside the engine's captured
graphs. Randomness is the port's counter hash (``serving.sampling``): the
draft's draw is Gumbel-max keyed by (seed, pos, ``STREAM_DRAFT``), the
acceptance uniforms come from (seed, pos, ``STREAM_ACCEPT``), and the
correction or bonus is Gumbel-max keyed by (seed, pos,
``STREAM_RESIDUAL``) folded with the accepted count. The same seed gives
the same tokens, eagerly or in a replay; the numbers are not those of
jax's threefry.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.serving.sampling import (STREAM_ACCEPT, STREAM_DRAFT,
                                              STREAM_RESIDUAL, STREAM_STEP,
                                              _fold, gumbel_noise,
                                              request_key, sample_token,
                                              uniforms, warp_logits)

__all__ = ["warp_logits", "sample_token", "request_key", "draft_propose",
           "accept_chunk", "parse_draft_dims", "STREAM_STEP",
           "STREAM_DRAFT", "STREAM_ACCEPT", "STREAM_RESIDUAL"]


def _slots(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """A per-slot knob as an (S,) tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=dtype, device=like.device).expand(
        like.shape[0])


def draft_propose(logits: torch.Tensor, temp, top_k, top_p, seed, pos):
    """The draft's proposals at ``pos``: (S, vocab) f32 logits and (S,)
    knobs -> ((S,) tokens, (S, vocab) q), q the warped draft distribution
    the acceptance test needs. Greedy slots propose the draft's argmax."""
    warped = warp_logits(logits, temp, top_k, top_p)
    q = torch.softmax(warped, dim=-1)
    key = request_key(seed, pos, STREAM_DRAFT)
    sampled = torch.argmax(warped + gumbel_noise(key, logits.shape[-1]),
                           dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(_slots(temp, logits, logits.dtype) > 0, sampled,
                       greedy), q


def accept_chunk(target_logits: torch.Tensor, draft_q: torch.Tensor,
                 proposals: torch.Tensor, temp, top_k, top_p, seed, pos, *,
                 accept_u: Optional[torch.Tensor] = None,
                 residual_noise: Optional[torch.Tensor] = None):
    """Exact acceptance of every slot's verified chunk.

    ``target_logits``: (S, m, vocab) f32, row j the target's distribution
    after the chunk's first j+1 feeds (feed 0 is the slot's pending token,
    feeds 1..m-1 its proposals). ``draft_q``: (S, m-1, vocab), the warped
    draft distributions the proposals were drawn from; ``proposals``:
    (S, m-1). The knobs are (S,) tensors or numbers. Returns ``(emitted,
    n_emit, n_accept)``: ``emitted[i, :n_emit[i]]`` is what slot i
    appends this round (its accepted proposals and one correction or
    bonus), ``n_accept`` its accepted count. m = 1 (no proposals) verifies
    the pending feed alone.

    ``accept_u`` ((S, m-1) uniforms) and ``residual_noise`` ((S, vocab)
    Gumbel noise) replace the hashed draws, so the rule can be checked
    against another package's draws."""
    s, m, v = target_logits.shape
    temp = _slots(temp, target_logits, target_logits.dtype)
    sampled = temp > 0
    greedy = torch.argmax(target_logits, dim=-1)                  # (S, m)
    warped = warp_logits(target_logits, temp[:, None],
                         _slots(top_k, target_logits, torch.int64)[:, None],
                         _slots(top_p, target_logits,
                                target_logits.dtype)[:, None])
    p = torch.softmax(warped, dim=-1)                             # (S, m, v)
    props = proposals.long()
    p_d = p[:, :m - 1].gather(-1, props[..., None])[..., 0]
    q_d = draft_q.gather(-1, props[..., None])[..., 0]
    if accept_u is None:
        accept_u = uniforms(request_key(seed, pos, STREAM_ACCEPT), m - 1)
    ok = torch.where(sampled[:, None],
                     accept_u * q_d.clamp_min(1e-30) < p_d,
                     props == greedy[:, :m - 1])
    # the accepted prefix: the first rejection stops everything after it
    n_accept = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)       # (S,)
    # correction (first rejection) or bonus (full acceptance): max(p - q,
    # 0) renormalised; past the last proposal the draft row is zero, so
    # the residual is p itself
    q_pad = torch.cat([draft_q, draft_q.new_zeros(s, 1, v)], dim=1)
    at = n_accept[:, None, None].expand(s, 1, v)
    p_a = p.gather(1, at)[:, 0]
    resid = (p_a - q_pad.gather(1, at)[:, 0]).clamp_min(0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 0, resid / mass, p_a)
    if residual_noise is None:
        residual_noise = gumbel_noise(
            _fold(request_key(seed, pos, STREAM_RESIDUAL), n_accept), v)
    extra = torch.where(
        sampled,
        torch.argmax(torch.log(resid.clamp_min(1e-38)) + residual_noise,
                     dim=-1),
        greedy.gather(1, n_accept[:, None])[:, 0])
    # emitted: the accepted proposals, then the correction or bonus
    prop_pad = torch.cat([props, props.new_zeros(s, 1)], dim=1)
    idx = torch.arange(m, device=props.device)[None]
    na = n_accept[:, None]
    emitted = torch.where(idx < na, prop_pad,
                          torch.where(idx == na, extra[:, None],
                                      torch.zeros_like(prop_pad)))
    return emitted, n_accept + 1, n_accept


def parse_draft_dims(spec: str) -> dict:
    """``--draftDims d_model,num_layers,num_heads`` -> the draft
    ``TransformerLM``'s keyword arguments."""
    parts = [int(x) for x in str(spec).split(",")]
    if len(parts) != 3:
        raise ValueError(
            f"--draftDims wants d_model,num_layers,num_heads; got {spec!r}")
    d_model, num_layers, num_heads = parts
    if d_model % num_heads:
        raise ValueError(f"draft d_model {d_model} must be divisible by "
                         f"num_heads {num_heads}")
    return {"d_model": d_model, "num_layers": num_layers,
            "num_heads": num_heads}
