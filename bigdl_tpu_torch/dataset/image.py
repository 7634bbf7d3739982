"""Image transformer stages (counterpart of ``bigdl_tpu/dataset/image.py``;
reference dataset/image/).

Stages map (image, label) samples host-side with numpy; each draws its
randomness from a ``RandomState`` seeded once, in the JAX package's order,
so the two packages transform the same samples the same way. The C++
prefetch pipeline (``dataset/native.py``) is the multi-threaded path
(reference image/MTLabeledBGRImgToBatch.scala:48-133).

Images are HWC arrays; grey images have C=1.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = [
    "GreyImgNormalizer", "BGRImgNormalizer", "BGRImgPixelNormalizer",
    "HFlip", "BGRImgCropper", "BGRImgRdmCropper", "ColorJitter", "Lighting",
    "compute_mean_std",
]


def compute_mean_std(images: np.ndarray, per_channel: bool = True):
    """Two-pass dataset mean/std (reference BGRImgNormalizer.scala:132's
    accumulation, vectorized)."""
    axes = (0, 1, 2) if per_channel else None
    mean = images.mean(axis=axes, dtype=np.float64)
    std = images.std(axis=axes, dtype=np.float64)
    return mean, std


class _SampleTransform(Transformer):
    """Per-(image, label) map stage."""

    def _map(self, img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    def __call__(self, it: Iterator) -> Iterator:
        for img, label in it:
            yield self._map(img, self._rng), label


class GreyImgNormalizer(_SampleTransform):
    """(x - mean) / std with scalar stats (reference
    dataset/image/GreyImgNormalizer.scala)."""

    def __init__(self, mean: float, std: float):
        super().__init__()
        self.mean, self.std = float(mean), float(std)

    def _map(self, img, rng):
        return (img.astype(np.float32) - self.mean) / self.std


class BGRImgNormalizer(_SampleTransform):
    """Per-channel (x - mean) / std (reference BGRImgNormalizer.scala)."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def _map(self, img, rng):
        return (img.astype(np.float32) - self.mean) / self.std


class BGRImgPixelNormalizer(_SampleTransform):
    """Subtract a full per-pixel mean image (reference
    BGRImgPixelNormalizer.scala, used by Caffe-style pipelines)."""

    def __init__(self, mean_image: np.ndarray):
        super().__init__()
        self.mean_image = mean_image.astype(np.float32)

    def _map(self, img, rng):
        return img.astype(np.float32) - self.mean_image


class HFlip(_SampleTransform):
    """Random horizontal flip (reference dataset/image/HFlip.scala)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        super().__init__(seed)
        self.threshold = threshold

    def _map(self, img, rng):
        return img[:, ::-1] if rng.rand() < self.threshold else img


class BGRImgCropper(_SampleTransform):
    """Center crop (reference BGRImgCropper.scala with CropCenter)."""

    def __init__(self, crop_w: int, crop_h: int):
        super().__init__()
        self.crop_w, self.crop_h = crop_w, crop_h

    def _map(self, img, rng):
        h, w = img.shape[:2]
        y0 = (h - self.crop_h) // 2
        x0 = (w - self.crop_w) // 2
        return img[y0:y0 + self.crop_h, x0:x0 + self.crop_w]


class BGRImgRdmCropper(_SampleTransform):
    """Random crop after optional padding (reference BGRImgRdmCropper.scala)."""

    def __init__(self, crop_w: int, crop_h: int, padding: int = 0,
                 seed: int = 0):
        super().__init__(seed)
        self.crop_w, self.crop_h, self.padding = crop_w, crop_h, padding

    def _map(self, img, rng):
        if self.padding:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
        h, w = img.shape[:2]
        y0 = rng.randint(0, h - self.crop_h + 1)
        x0 = rng.randint(0, w - self.crop_w + 1)
        return img[y0:y0 + self.crop_h, x0:x0 + self.crop_w]


class ColorJitter(_SampleTransform):
    """Random brightness/contrast/saturation in random order
    (reference dataset/image/ColoJitter.scala, 93 LoC)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        super().__init__(seed)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _grs(img):
        # BGR grayscale weights (reference uses BGR layout)
        return (0.114 * img[..., 0] + 0.587 * img[..., 1]
                + 0.299 * img[..., 2])[..., None]

    def _map(self, img, rng):
        img = img.astype(np.float32)
        ops = [self._bright, self._contrast, self._saturate]
        rng.shuffle(ops)
        for op in ops:
            img = op(img, rng)
        return img

    def _bright(self, img, rng):
        a = 1.0 + rng.uniform(-self.brightness, self.brightness)
        return img * a

    def _contrast(self, img, rng):
        a = 1.0 + rng.uniform(-self.contrast, self.contrast)
        mean = self._grs(img).mean()
        return img * a + mean * (1 - a)

    def _saturate(self, img, rng):
        a = 1.0 + rng.uniform(-self.saturation, self.saturation)
        grey = self._grs(img)
        return img * a + grey * (1 - a)


class Lighting(_SampleTransform):
    """PCA lighting noise (reference dataset/image/Lighting.scala) with the
    standard ImageNet eigen-decomposition, BGR order."""

    EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    EIGVEC = np.asarray([[0.4009, 0.7192, -0.5675],
                         [-0.8140, -0.0045, -0.5808],
                         [0.4203, -0.6948, -0.5836]], np.float32)

    def __init__(self, alpha_std: float = 0.1, seed: int = 0):
        super().__init__(seed)
        self.alpha_std = alpha_std

    def _map(self, img, rng):
        alpha = rng.normal(0, self.alpha_std, 3).astype(np.float32)
        noise = (self.EIGVEC * alpha * self.EIGVAL).sum(axis=1)
        return img.astype(np.float32) + noise
