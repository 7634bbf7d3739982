"""Vision Transformer (counterpart of ``bigdl_tpu/models/vit.py``): a
stride-p patchify convolution on NHWC images, sinusoidal positions over
the patch tokens, a pre-LN non-causal encoder, a final LayerNorm, the
mean over the patch tokens (no class token), a Linear head and f32
log-probabilities.

``num_heads`` defaults to ``d_model // 128`` (heads of 128), so
``vit_b16`` has 6 heads and ``vit_s16`` 3. Parameters are named after the
JAX param tree (``patch.weight``, ``encoder.0.mha.wq``, ``ln.weight``,
``head.bias``), so a JAX ViT loads with ``interop.load_jax``."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn import (LayerNorm, Linear, PositionalEncoding,
                                SpatialConvolution, TransformerEncoder)

__all__ = ["ViT", "vit", "vit_b16", "vit_s16"]


class ViT(Module):
    """``attn_impl`` (None, ``"flash"``, ``"blockwise"`` or a callable)
    and ``remat`` (False, ``"full"`` or ``"dots"``) act on the encoder as
    in :class:`~bigdl_tpu_torch.nn.TransformerEncoder`; ``dropout`` draws
    from the forward's ``seed`` in training."""

    def __init__(self, class_num: int = 1000, image_size: int = 224,
                 patch_size: int = 16, d_model: int = 768,
                 num_layers: int = 12, num_heads: Optional[int] = None,
                 d_ff: Optional[int] = None, dropout: float = 0.0,
                 attn_impl=None, remat=False, name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name or "ViT")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} not divisible by "
                             f"patch_size {patch_size}")
        if num_heads is None:
            num_heads = max(1, d_model // 128)
        self.d_model = d_model
        self.n_patches = (image_size // patch_size) ** 2
        p = patch_size
        self.patch = SpatialConvolution(3, d_model, p, p, p, p, 0, 0,
                                        generator=generator)
        self.pos = PositionalEncoding(d_model, self.n_patches)
        self.encoder = TransformerEncoder(
            num_layers, d_model, num_heads, d_ff, causal=False,
            dropout=dropout, attn_impl=attn_impl, remat=remat,
            generator=generator)
        self.ln = LayerNorm(d_model)
        self.head = Linear(d_model, class_num, generator=generator)

    def forward(self, x, seed=None):
        """(b, h, w, 3) NHWC images -> (b, class_num) f32 log-probs."""
        t = self.patch(x)
        b, gh, gw, d = t.shape
        t = self.pos(t.reshape(b, gh * gw, d))
        t = self.ln(self.encoder(t, seed))
        logits = self.head(t.mean(dim=1))
        return torch.log_softmax(logits.float(), dim=-1)


def vit(class_num: int = 1000, **kw) -> ViT:
    return ViT(class_num, **kw)


def vit_b16(class_num: int = 1000, **kw) -> ViT:
    """ViT-Base/16: 12 layers, d 768, 6 heads of 128 (86M parameters)."""
    kw.setdefault("patch_size", 16)
    return ViT(class_num, d_model=768, num_layers=12, **kw)


def vit_s16(class_num: int = 1000, **kw) -> ViT:
    """ViT-Small/16: 12 layers, d 384, 3 heads of 128 (22M parameters)."""
    kw.setdefault("patch_size", 16)
    return ViT(class_num, d_model=384, num_layers=12, **kw)
