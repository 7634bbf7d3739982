"""Decoder-only transformer LM (counterpart of
``bigdl_tpu/models/transformer_lm.py``): LookupTable embedding scaled by
sqrt(d_model), sinusoidal positions or RoPE, a causal pre-LN encoder,
final LayerNorm and a head tied to the embedding, or an untied ``head``
``Linear(d_model, vocab)`` (``tie_embeddings=False``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn import (LayerNorm, Linear, LookupTable,
                                PositionalEncoding, TransformerEncoder)
from bigdl_tpu_torch.nn.attention import seq_offset

__all__ = ["TransformerLM", "transformer_lm", "packed_lm_targets",
           "PackedNLLCriterion"]


def packed_lm_targets(tokens, segments):
    """Next-token targets of packed rows: target[i] = tokens[i+1], weight
    0 wherever the next token is another document's (or padding). Returns
    ((b, s) targets, (b, s) f32 weights)."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    nxt = torch.cat([segments[:, 1:], torch.zeros_like(segments[:, :1])],
                    dim=1)
    weights = ((segments == nxt) & (segments != 0)).float()
    return targets, weights


class PackedNLLCriterion:
    """Weighted next-token NLL of (b, s, vocab) log-probs at the
    ``(targets, weights)`` of :func:`packed_lm_targets`: the mean over live
    positions, on the scale of the unpacked TimeDistributed(ClassNLL)."""

    def __call__(self, logp, target):
        targets, weights = target
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        w = weights.to(nll.dtype)
        return (nll * w).sum() / w.sum().clamp_min(1.0)


class TransformerLM(nn.Module):
    """Parameters are named after the JAX param tree (``emb.weight``,
    ``encoder.0.mha.wq``, ``ln_f.bias``, the untied ``head.weight`` and
    ``head.bias``), so a tree converted by
    :func:`bigdl_tpu_torch.interop.params_from_jax` loads by name.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts activations right
    after the embedding lookup; parameters stay f32. ``dropout`` and
    ``remat`` (False, ``"full"`` or ``"dots"``) act in training, as in
    :class:`~bigdl_tpu_torch.nn.TransformerEncoder`."""

    def __init__(self, vocab: int, d_model: int = 256, num_layers: int = 4,
                 num_heads: int = 4, d_ff: Optional[int] = None,
                 max_len: int = 2048, dropout: float = 0.0,
                 attn_impl=None, remat=False,
                 tie_embeddings: bool = True, compute_dtype=None,
                 num_kv_heads: Optional[int] = None,
                 pos_encoding: str = "sinusoidal",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pos_encoding not in ("sinusoidal", "rope"):
            raise ValueError(f"pos_encoding {pos_encoding!r} not in "
                             f"('sinusoidal', 'rope')")
        self.vocab, self.d_model, self.max_len = vocab, d_model, max_len
        self.rope = pos_encoding == "rope"
        self.compute_dtype = compute_dtype
        self.emb = LookupTable(vocab, d_model, generator=generator)
        self.pos = PositionalEncoding(d_model, max_len)
        self.encoder = TransformerEncoder(
            num_layers, d_model, num_heads, d_ff, causal=True,
            dropout=dropout, attn_impl=attn_impl, remat=remat,
            num_kv_heads=num_kv_heads, rope=self.rope,
            rope_max_len=max_len, generator=generator)
        self.ln_f = LayerNorm(d_model)
        self.tie = tie_embeddings
        self.head = (None if tie_embeddings
                     else Linear(d_model, vocab, generator=generator))

    def tp_param_children(self) -> dict:
        """Param key -> child, so ``parallel.megatron_specs`` walks the
        embedding, the encoder blocks and the head (the JAX method)."""
        out = {"emb": self.emb, "encoder": self.encoder, "ln_f": self.ln_f}
        if self.head is not None:
            out["head"] = self.head
        return out

    def fsdp_outer_params(self) -> list:
        """Parameters this forward reads outside their module: the tied
        head's embedding (``parallel.FullyShardedDataParallel`` gathers
        them for the whole call)."""
        return [] if self.head is not None else ["emb.weight"]

    @property
    def device(self) -> torch.device:
        return self.emb.weight.device

    def load_jax_params(self, tree) -> "TransformerLM":
        """Load a JAX ``TransformerLM.init`` tree (nested dicts of arrays),
        strictly by name."""
        from bigdl_tpu_torch.interop import params_from_jax
        self.load_state_dict(params_from_jax(tree), strict=True)
        return self

    # ---------------------------------------------------------- forward
    def _embed(self, tokens):
        h = self.emb(tokens)
        if self.compute_dtype is not None:
            h = h.to(self.compute_dtype)
        return h * math.sqrt(self.d_model)

    def head_logits(self, h):
        """The output head: final LayerNorm, then the untied ``head``, or
        the embedding transposed -> logits in ``h``'s dtype. Every path
        (training, prefill, decode, paged, speculative) ends here."""
        h = self.ln_f(h)
        if self.head is not None:
            return self.head(h)
        tp = self.emb._tp
        if tp is not None:
            # the tied head contracts over the split features: this rank's
            # slice of h, then the partial logits reduced
            return tp.reduce(tp.scatter(h, -1)
                             @ self.emb.weight.to(h.dtype).T)
        return h @ self.emb.weight.to(h.dtype).T

    def forward(self, tokens, seed=None):
        """(batch, seq) int tokens, or ``(tokens, segments)`` for packed
        rows (the segment ids confine attention to each document) ->
        (batch, seq, vocab) f32 log-probs. ``seed`` (an int or an int64
        tensor) seeds dropout in training mode. Under sequence parallelism
        (the ring as ``attn_impl``) ``tokens`` is this rank's chunk, and its
        positions start at the chunk's global offset."""
        segments = None
        if isinstance(tokens, (tuple, list)):
            tokens, segments = tokens
        h = self._embed(tokens)
        # under sequence parallelism this rank's chunk starts past 0
        off = seq_offset(self.encoder[0].mha.attn_fn, tokens.shape[-1])
        if not self.rope:
            h = self.pos(h, off)
        elif off + tokens.shape[-1] > self.max_len:
            raise ValueError(f"sequence length {tokens.shape[-1]} exceeds "
                             f"max_len {self.max_len}")
        if segments is None:
            h = self.encoder(h, seed)
        else:
            h = self.encoder((h, segments.to(h.device)), seed)[0]
        return torch.log_softmax(self.head_logits(h).float(), dim=-1)

    # --------------------------------------------- autoregressive decoding
    def embed_at(self, tokens, pos):
        """Embed (b, s) tokens at absolute positions pos..pos+s-1; ``pos``
        is an int or a (b,) tensor of per-row starts: what the first
        layer of a decode or prefill takes."""
        h = self._embed(tokens)
        if self.rope:
            return h
        s = tokens.shape[1]
        if isinstance(pos, int):
            pe = self.pos.table[pos:pos + s]
        else:
            at = pos.to(h.device).long()[:, None] + torch.arange(
                s, device=h.device)
            pe = self.pos.table[at]
        return h + pe.to(h.dtype)

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=None) -> list:
        dtype = dtype or self.compute_dtype or torch.float32
        return self.encoder.init_cache(batch, max_len or self.max_len, dtype,
                                       self.device)

    def prefill_logits(self, tokens, cache, last=None):
        """Run the prompt once, fill ``cache`` (positions 0..s-1, in place)
        and return the (b, vocab) next-token logits at position ``last``
        (default s-1): an int, or a device index tensor (0-d, (1,) or (b,))
        as the JAX package's traced ``last``, so one captured prefill
        serves every prompt length of its bucket. With the prompt
        right-padded to a bucket, ``last`` = true_len - 1 gives the
        unpadded prompt's logits."""
        h = self.encoder.prefill(self.embed_at(tokens, 0), cache)
        if last is None:
            h_last = h[:, -1:]
        elif isinstance(last, int):
            h_last = h[:, last:last + 1]
        else:
            idx = last.reshape(-1, 1, 1).expand(h.shape[0], 1, h.shape[-1])
            h_last = h.gather(1, idx.to(h.device))
        return self.head_logits(h_last)[:, 0]

    def _positions(self, tok, pos):
        if isinstance(pos, int):
            return torch.full((tok.shape[0],), pos, dtype=torch.long,
                              device=tok.device)
        return pos

    def decode_logits(self, tok, cache, pos):
        """One step: ``tok`` (b, 1) at position ``pos`` (int, or a (b,)
        tensor with one position per row) -> (b, vocab) logits."""
        return self.verify_logits(tok, cache, pos)[:, 0]

    def verify_logits(self, toks, cache, pos):
        """Chunked decode: ``toks`` (b, m) at absolute positions
        ``pos``..``pos+m-1`` (``pos`` an int or a (b,) tensor) -> (b, m,
        vocab) logits, row i the next-token distribution after feeding
        ``toks[:, :i+1]``; writes the chunk's K/V into ``cache``. The
        suffix prefill of a prefix-cache hit (and the speculative verify
        of the JAX package). The caller keeps pos + m <= max_len."""
        pos = self._positions(toks, pos)
        h = self.embed_at(toks, pos)
        h = self.encoder.decode_step(h, cache, pos)
        return self.head_logits(h)

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens: int, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        """KV-cache decoding of (b, s) prompts -> (b, max_new_tokens) ids.
        Greedy (temperature 0) takes the argmax of the raw logits, as the
        JAX package does. Sampling draws Gumbel noise from ``generator``
        (default: a CPU generator seeded 0): deterministic per seed, but
        not the numbers jax's threefry would give."""
        prompt = torch.as_tensor(prompt, dtype=torch.long, device=self.device)
        b, s = prompt.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"prompt ({s}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds max_len "
                             f"{self.max_len}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cache = self.init_cache(b)
        logits = self.prefill_logits(prompt, cache)
        out = torch.zeros((b, max_new_tokens), dtype=torch.long,
                          device=self.device)
        for i in range(max_new_tokens):
            lg = logits.float()
            if temperature <= 0.0:
                tok = torch.argmax(lg, dim=-1)
            else:
                lg = lg / temperature
                if top_k is not None and top_k < self.vocab:
                    kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
                    lg = lg.masked_fill(lg < kth, -1e30)
                u = torch.rand(lg.shape, generator=generator,
                               device=generator.device).to(lg.device)
                tok = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
            out[:, i] = tok
            logits = self.decode_logits(tok[:, None], cache, s + i)
        return out


def transformer_lm(vocab: int, **kw) -> TransformerLM:
    return TransformerLM(vocab, **kw)
