"""Batch-vectorized random augmentations as torch ops on the images' device.

Port of `differential_equations_resnet_tpu/data/jit_augment.py`: the same
transforms, on float images on the 0-255 scale, shape (N, H, W, C), with
parameters drawn independently per image.  They run between the gather and
the train step of the device-resident epoch (`train.train_step.
make_device_epoch`), on the card, a few small kernels a batch.

Each transform takes an explicit `torch.Generator` (on the images' device)
where the JAX package takes a `jax.random` key, and is split in two: a draw
of its per-image parameters (``draw_*``) and a pure application of them
(``apply_*``).  ``random_*`` is the two together.  The two packages draw
different numbers from the same seed, so tests hand both the same drawn
parameters.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Augment = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def _uniform(generator: torch.Generator, n: int, low: float, high: float, device) -> torch.Tensor:
    return low + (high - low) * torch.rand(n, generator=generator, device=device)


def draw_flip(generator: torch.Generator, n: int, device=None) -> torch.Tensor:
    """(n,) bool: which images to mirror, each with probability 1/2."""
    return torch.rand(n, generator=generator, device=device) < 0.5


def apply_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_flip_left_right(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Per-image 50% horizontal flip (reference RandomFlipLeftRight)."""
    return apply_flip(images, draw_flip(generator, images.shape[0], images.device))


def draw_brightness(generator: torch.Generator, n: int, max_delta: float = 0.5,
                    device=None) -> torch.Tensor:
    """(n,) deltas uniform in [-max_delta, max_delta)."""
    return _uniform(generator, n, -max_delta, max_delta, device)


def apply_brightness(images: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Add each image's delta on the unit-float scale, then round (half to
    even, as jnp.round) and clip back to 0-255."""
    out = images / 255.0 + deltas[:, None, None, None]
    return torch.clamp(torch.round(out * 255.0), 0.0, 255.0)


def random_brightness(generator: torch.Generator, images: torch.Tensor,
                      max_delta: float = 0.5) -> torch.Tensor:
    return apply_brightness(images, draw_brightness(generator, images.shape[0], max_delta,
                                                    images.device))


def draw_offsets(generator: torch.Generator, n: int, high_top: int, high_left: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tops, lefts): (n,) integers uniform in [0, high_top) and [0, high_left)."""
    tops = torch.randint(0, high_top, (n,), generator=generator, device=device)
    lefts = torch.randint(0, high_left, (n,), generator=generator, device=device)
    return tops, lefts


def apply_crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
               height: int, width: int) -> torch.Tensor:
    """Each image's (height, width) window at (tops[i], lefts[i]), by one
    gather (no per-image loop, no host round trip)."""
    n = images.shape[0]
    rows = tops[:, None] + torch.arange(height, device=images.device)
    cols = lefts[:, None] + torch.arange(width, device=images.device)
    batch = torch.arange(n, device=images.device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop(generator: torch.Generator, images: torch.Tensor, scale: float = 0.9) -> torch.Tensor:
    """Per-image square crop with side = int(min(H, W) * scale) at a uniform
    offset (reference RandomCrop semantics)."""
    n, h, w = images.shape[:3]
    side = int(min(h, w) * scale)
    tops, lefts = draw_offsets(generator, n, h - side + 1, w - side + 1, images.device)
    return apply_crop(images, tops, lefts, side, side)


def apply_pad_crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
                   padding: int) -> torch.Tensor:
    """Zero-pad by ``padding`` on each side, then crop back to (H, W) at
    each image's offset."""
    h, w = images.shape[1:3]
    padded = torch.nn.functional.pad(images, (0, 0, padding, padding, padding, padding))
    return apply_crop(padded, tops, lefts, h, w)


def pad_random_crop(generator: torch.Generator, images: torch.Tensor, padding: int = 4) -> torch.Tensor:
    """Standard CIFAR augmentation: zero-pad by ``padding``, then crop back
    to the original size at a per-image uniform offset."""
    tops, lefts = draw_offsets(generator, images.shape[0], 2 * padding + 1, 2 * padding + 1,
                               images.device)
    return apply_pad_crop(images, tops, lefts, padding)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """tf.image-convention RGB->HSV on unit floats."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(delta),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc), maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(*options):
        return torch.gather(torch.stack(options, dim=-1), -1, sector)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def draw_saturation(generator: torch.Generator, n: int, lower: float = 0.5, upper: float = 1.5,
                    device=None) -> torch.Tensor:
    """(n,) saturation factors uniform in [lower, upper)."""
    return _uniform(generator, n, lower, upper, device)


def apply_saturation(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Scale HSV saturation by each image's factor, rounded back to the
    0-255 grid."""
    hsv = _rgb_to_hsv(images / 255.0)
    s = torch.clamp(hsv[..., 1] * factors[:, None, None], 0.0, 1.0)
    rgb = _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))
    return torch.clamp(torch.round(rgb * 255.0), 0.0, 255.0)


def random_saturation(generator: torch.Generator, images: torch.Tensor, lower: float = 0.5,
                      upper: float = 1.5) -> torch.Tensor:
    """Scale HSV saturation by a per-image uniform factor in [lower, upper]
    (tf.image.random_saturation parity)."""
    return apply_saturation(images, draw_saturation(generator, images.shape[0], lower, upper,
                                                    images.device))


def compose(*fns: Augment) -> Augment:
    """Chain augmentations; each draws from the same generator in turn."""

    def apply(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
        for fn in fns:
            images = fn(generator, images)
        return images

    return apply


def standard_cifar_augment(flip: bool = True, crop_padding: int = 4,
                           brightness_delta: float = 0.0) -> Augment:
    """The usual CIFAR recipe as one callable for
    `make_device_epoch(augment=...)` / `Training(jit_augment=...)`."""
    fns = []
    if crop_padding:
        fns.append(lambda g, x: pad_random_crop(g, x, crop_padding))
    if flip:
        fns.append(random_flip_left_right)
    if brightness_delta:
        fns.append(lambda g, x: random_brightness(g, x, brightness_delta))
    return compose(*fns)
