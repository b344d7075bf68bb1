"""Composable preprocessor classes for image classification.

Port of `differential_equations_resnet_tpu/data/preprocessors.py`, kept in
the port so that it imports no JAX.  It stays NumPy on the host and draws
the same random numbers as the JAX package's for the same seeds.  NumPy
rebuilds of the nine tf.data preprocessors in
`dataset_utils/tf_dataset_preprocessors_image_classification.py:22-181`.
Each instance is a callable dataset transform: ``preprocessor(dataset) ->
dataset`` mapping over elements, exactly like the reference classes wrap
``dataset.map``.  ``num_parallel_calls`` is accepted everywhere for API
parity (host-side parallelism comes from `NumpyDataset.prefetch`).

Vectorized fast path: preprocessors whose semantics permit it also expose
``apply_batch(images (B,H,W,C), labels) -> (images, labels)`` — one
whole-batch NumPy transform with per-image random draws.  When every
preprocessor in a chain supports it, `create_dataset_from_arrays` runs the
vectorized gather pipeline and applies the chain batch-at-a-time instead of
dropping to per-element Python iteration, which is many times slower.
Randomness is drawn per element in
both paths, so the augmentation distribution is identical.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

from differential_equations_resnet_tpu_torch.data.pipeline import NumpyDataset


class UnpackImagesLabels:
    """{'image': ..., 'label': ...} dict elements -> (image, label) tuples."""

    def __init__(self, num_parallel_calls: Optional[int] = None):
        self.num_parallel_calls = num_parallel_calls

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        return dataset.map(
            lambda sample: (sample["image"], sample["label"]),
            num_parallel_calls=self.num_parallel_calls,
        )


class ConvertLabelsToOneHot:
    def __init__(self, num_classes: int, num_parallel_calls: Optional[int] = None):
        self.num_classes = num_classes
        self.num_parallel_calls = num_parallel_calls

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            one_hot = np.zeros((self.num_classes,), dtype=np.float32)
            one_hot[int(label)] = 1.0
            return image, one_hot

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        one_hot = np.zeros((len(labels), self.num_classes), dtype=np.float32)
        one_hot[np.arange(len(labels)), np.asarray(labels, np.int64)] = 1.0
        return images, one_hot


def _decode_image_bytes(data: bytes, channels: Optional[int]) -> np.ndarray:
    """Decode encoded image bytes (JPEG/PNG/...) to an HWC uint8 array."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise RuntimeError(
            "Image decoding requires Pillow; store raw arrays in records "
            "instead, or install PIL."
        ) from e
    img = Image.open(io.BytesIO(data))
    if channels == 1:
        img = img.convert("L")
    elif channels in (3, None):
        img = img.convert("RGB")
    elif channels == 4:
        img = img.convert("RGBA")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class DecodeImages:
    def __init__(self, channels: int = 3, num_parallel_calls: Optional[int] = None):
        self.channels = channels
        self.num_parallel_calls = num_parallel_calls

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        return dataset.map(
            lambda image, label: (_decode_image_bytes(image, self.channels), label),
            num_parallel_calls=self.num_parallel_calls,
        )


class DecodeJPEGImages:
    def __init__(
        self,
        channels: Optional[int] = None,
        ratio: int = 1,
        num_parallel_calls: Optional[int] = None,
    ):
        self.channels = channels
        self.ratio = ratio
        self.num_parallel_calls = num_parallel_calls

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            arr = _decode_image_bytes(image, self.channels)
            if self.ratio > 1:
                arr = arr[:: self.ratio, :: self.ratio]
            return arr, label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)


class RandomCrop:
    """Square random crop with side = scale * min(H, W)
    (reference RandomCrop, preprocessors :83-111)."""

    def __init__(
        self,
        aspect_ratio: float = 1,
        scale: float = 0.9,
        channels: int = 3,
        num_parallel_calls: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.aspect_ratio = aspect_ratio
        self.scale = scale
        self.channels = channels
        self.num_parallel_calls = num_parallel_calls
        self._rng = np.random.default_rng(seed)

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            h, w = image.shape[0], image.shape[1]
            side = int(min(h, w) * self.scale)
            top = int(self._rng.integers(0, h - side + 1))
            left = int(self._rng.integers(0, w - side + 1))
            return image[top : top + side, left : left + side], label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        n, h, w = images.shape[:3]
        side = int(min(h, w) * self.scale)
        tops = self._rng.integers(0, h - side + 1, size=n)
        lefts = self._rng.integers(0, w - side + 1, size=n)
        rows = tops[:, None] + np.arange(side)          # (N, side)
        cols = lefts[:, None] + np.arange(side)         # (N, side)
        out = images[
            np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]
        ]
        return out, labels


def resize_bilinear(image: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with TF-1 `resize_images` conventions
    (align_corners=False: src = dst * in/out)."""
    in_h, in_w = image.shape[:2]
    out_h, out_w = target_size
    if (in_h, in_w) == (out_h, out_w):
        return image.astype(np.float32)
    img = image.astype(np.float32)

    def axis_coords(n_in, n_out):
        src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
        lo = np.floor(src).astype(np.int64)
        lo = np.clip(lo, 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    y0, y1, fy = axis_coords(in_h, out_h)
    x0, x1, fx = axis_coords(in_w, out_w)
    top = img[y0][:, x0] * (1 - fx)[None, :, None] + img[y0][:, x1] * fx[None, :, None]
    bot = img[y1][:, x0] * (1 - fx)[None, :, None] + img[y1][:, x1] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


def resize_bilinear_batch(
    images: np.ndarray, target_size: Tuple[int, int]
) -> np.ndarray:
    """Batched :func:`resize_bilinear` over (B, H, W, C) with shared coords
    (all images in an array batch have the same shape)."""
    in_h, in_w = images.shape[1:3]
    out_h, out_w = target_size
    if (in_h, in_w) == (out_h, out_w):
        return images.astype(np.float32)
    img = images.astype(np.float32)

    def axis_coords(n_in, n_out):
        src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        return lo, hi, (src - lo).astype(np.float32)

    y0, y1, fy = axis_coords(in_h, out_h)
    x0, x1, fx = axis_coords(in_w, out_w)
    fx = fx[None, None, :, None]
    fy = fy[None, :, None, None]
    top = img[:, y0][:, :, x0] * (1 - fx) + img[:, y0][:, :, x1] * fx
    bot = img[:, y1][:, :, x0] * (1 - fx) + img[:, y1][:, :, x1] * fx
    return top * (1 - fy) + bot * fy


class Resize:
    def __init__(
        self,
        target_size: Tuple[int, int],
        preserve_aspect_ratio: bool = False,
        num_parallel_calls: Optional[int] = None,
    ):
        self.target_size = tuple(target_size)
        self.preserve_aspect_ratio = preserve_aspect_ratio
        self.num_parallel_calls = num_parallel_calls

    def _target_for(self, h: int, w: int) -> Tuple[int, int]:
        target = self.target_size
        if self.preserve_aspect_ratio:
            ratio = min(target[0] / h, target[1] / w)
            target = (max(1, int(h * ratio)), max(1, int(w * ratio)))
        return target

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            return resize_bilinear(image, self._target_for(*image.shape[:2])), label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        return resize_bilinear_batch(
            images, self._target_for(*images.shape[1:3])
        ), labels


class ResizeWithPad:
    """Aspect-preserving resize then centered zero padding to target size
    (tf.image.resize_image_with_pad parity)."""

    def __init__(self, target_size: Tuple[int, int], num_parallel_calls=None):
        self.target_size = tuple(target_size)
        self.num_parallel_calls = num_parallel_calls

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        th, tw = self.target_size

        def fn(image, label):
            h, w = image.shape[:2]
            ratio = min(th / h, tw / w)
            rh, rw = max(1, int(round(h * ratio))), max(1, int(round(w * ratio)))
            resized = resize_bilinear(image, (rh, rw))
            pad_top = (th - rh) // 2
            pad_left = (tw - rw) // 2
            out = np.zeros((th, tw) + image.shape[2:], dtype=resized.dtype)
            out[pad_top : pad_top + rh, pad_left : pad_left + rw] = resized
            return out, label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        th, tw = self.target_size
        h, w = images.shape[1:3]
        ratio = min(th / h, tw / w)
        rh, rw = max(1, int(round(h * ratio))), max(1, int(round(w * ratio)))
        resized = resize_bilinear_batch(images, (rh, rw))
        pad_top, pad_left = (th - rh) // 2, (tw - rw) // 2
        out = np.zeros((len(images), th, tw) + images.shape[3:], resized.dtype)
        out[:, pad_top : pad_top + rh, pad_left : pad_left + rw] = resized
        return out, labels


class RandomFlipLeftRight:
    def __init__(self, num_parallel_calls=None, seed: Optional[int] = None):
        self.num_parallel_calls = num_parallel_calls
        self._rng = np.random.default_rng(seed)

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            if self._rng.random() < 0.5:
                image = image[:, ::-1]
            return image, label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        flip = self._rng.random(len(images)) < 0.5
        return np.where(flip[:, None, None, None], images[:, :, ::-1], images), labels


def _to_unit_float(image: np.ndarray) -> Tuple[np.ndarray, bool]:
    if np.issubdtype(image.dtype, np.integer):
        return image.astype(np.float32) / 255.0, True
    return image.astype(np.float32), False


def _from_unit_float(image: np.ndarray, was_int: bool, dtype) -> np.ndarray:
    if was_int:
        return np.clip(np.round(image * 255.0), 0, 255).astype(dtype)
    return image


class RandomBrightness:
    """Add a uniform delta in [-max_delta, max_delta] (unit-float scale),
    tf.image.random_brightness parity."""

    def __init__(self, max_delta: float = 0.5, num_parallel_calls=None, seed=None):
        self.max_delta = max_delta
        self.num_parallel_calls = num_parallel_calls
        self._rng = np.random.default_rng(seed)

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            delta = float(self._rng.uniform(-self.max_delta, self.max_delta))
            unit, was_int = _to_unit_float(image)
            return _from_unit_float(unit + delta, was_int, image.dtype), label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        deltas = self._rng.uniform(-self.max_delta, self.max_delta, len(images))
        unit, was_int = _to_unit_float(images)
        out = unit + deltas[:, None, None, None].astype(np.float32)
        return _from_unit_float(out, was_int, images.dtype), labels


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB->HSV on unit floats (tf.image convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, axis=-1)
    minc = np.min(rgb, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    choices = [
        np.stack([v, t, p], -1),
        np.stack([q, v, p], -1),
        np.stack([p, v, t], -1),
        np.stack([p, q, v], -1),
        np.stack([t, p, v], -1),
        np.stack([v, p, q], -1),
    ]
    out = np.zeros(hsv.shape, dtype=hsv.dtype)
    for k, choice in enumerate(choices):
        out = np.where((i == k)[..., None], choice, out)
    return out


class RandomSaturation:
    """Scale HSV saturation by a uniform factor in [lower, upper]
    (tf.image.random_saturation parity)."""

    def __init__(self, lower: float = 0.5, upper: float = 1.5, num_parallel_calls=None, seed=None):
        self.lower = lower
        self.upper = upper
        self.num_parallel_calls = num_parallel_calls
        self._rng = np.random.default_rng(seed)

    def __call__(self, dataset: NumpyDataset) -> NumpyDataset:
        def fn(image, label):
            factor = float(self._rng.uniform(self.lower, self.upper))
            unit, was_int = _to_unit_float(image)
            hsv = rgb_to_hsv(unit)
            hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0.0, 1.0)
            out = hsv_to_rgb(hsv)
            return _from_unit_float(out, was_int, image.dtype), label

        return dataset.map(fn, num_parallel_calls=self.num_parallel_calls)

    def apply_batch(self, images, labels):
        factors = self._rng.uniform(self.lower, self.upper, len(images))
        unit, was_int = _to_unit_float(images)
        hsv = rgb_to_hsv(unit)  # shape-agnostic over leading axes
        hsv[..., 1] = np.clip(
            hsv[..., 1] * factors[:, None, None].astype(np.float32), 0.0, 1.0
        )
        out = hsv_to_rgb(hsv)
        return _from_unit_float(out, was_int, images.dtype), labels
