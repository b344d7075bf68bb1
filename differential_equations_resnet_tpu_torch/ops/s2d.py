"""Space-to-depth packed convolution, in PyTorch: a stride-1 3x3 SAME conv on
(H, W, C) reshaped exactly into a stride-1 3x3 SAME conv on (H/b, W/b,
b*b*C).

Port of `differential_equations_resnet_tpu/ops/s2d.py`.  `space_to_depth`
is a permutation of pixels, so it commutes with the elementwise ops of a
residual step (relu, the bias broadcast per channel through the tiled
packed bias, the residual add).  The kernel transform reproduces the
original SAME zero padding: packed tap (u, v) at output phase (p, q) reaches
original tap (b*u + r - p, b*v + s - q) from input phase (r, s), which is a
valid 3x3 offset for exactly the in-range combinations; the others get a
zero weight, and the packed space's zero padding supplies the zeros the
original padding did.

Layout: packed channel c' = (p * b + q) * C + c for phase (p, q),
phase-major and original-channel-minor, as in the JAX package.  Every
function here is a permutation or a gather with a zero mask, so its output
is bit-identical to the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import constant_cache


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), phase-major channel layout."""
    n, h, w, c = x.shape
    b = block
    if h % b or w % b:
        raise ValueError(f"space_to_depth: ({h}, {w}) is not divisible by block {b}")
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, b * b * c)


def depth_to_space(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Inverse of `space_to_depth`."""
    n, hb, wb, cb = x.shape
    b = block
    c = cb // (b * b)
    x = x.reshape(n, hb, wb, b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hb * b, wb * b, c)


@functools.lru_cache(maxsize=None)
def _pack_kernel_indices(block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static gather map of the packed-kernel transform (3x3, stride 1).

    Returns (tap_index, valid) of shape (3, 3, b, b, b, b):
    tap_index[u, v, r, s, p, q] is the flat 3*3 index of the original tap
    (di, dj) = (b*u + r - p, b*v + s - q) (u, v, di, dj stored 0-based), and
    valid marks the in-range combinations."""
    b = block
    u = np.arange(3)[:, None, None, None, None, None] - 1
    v = np.arange(3)[None, :, None, None, None, None] - 1
    r = np.arange(b)[None, None, :, None, None, None]
    s = np.arange(b)[None, None, None, :, None, None]
    p = np.arange(b)[None, None, None, None, :, None]
    q = np.arange(b)[None, None, None, None, None, :]
    di = b * u + r - p
    dj = b * v + s - q
    shape = np.broadcast_shapes(di.shape, dj.shape)
    di, dj = np.broadcast_to(di, shape), np.broadcast_to(dj, shape)
    valid = (np.abs(di) <= 1) & (np.abs(dj) <= 1)
    tap = np.where(valid, (di + 1) * 3 + (dj + 1), 0).astype(np.int32)
    return tap, valid


@constant_cache
def _device_indices(block: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_pack_kernel_indices` as tensors on ``device`` (the flat tap index
    and the (3, 3, b, b, b, b, 1, 1) mask of the out-of-range
    combinations), made once per device: a
    host-to-device copy on every call cannot be captured in a CUDA graph."""
    tap, valid = _pack_kernel_indices(block)
    with torch.inference_mode(False):
        return (torch.as_tensor(tap.reshape(-1), dtype=torch.long).to(device),
                torch.as_tensor(~valid)[..., None, None].to(device))


def pack_kernel_s2d(kernel: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., 3, 3, C_in, C_out) HWIO kernel -> (..., 3, 3, b*b*C_in,
    b*b*C_out) packed kernel, for one kernel or a stacked (L, 3, 3, C, C)
    one (leading axes kept), as one gather and a mask.  Differentiable: the
    gradient of the packed kernel folds back onto the dense one."""
    b = block
    *lead, kh, kw, cin, cout = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError("s2d packing is specialized to 3x3 stride-1 kernels")
    index, invalid = _device_indices(b, kernel.device)
    n = len(lead)
    flat = kernel.reshape(*lead, 9, cin, cout)
    gathered = flat.index_select(n, index).reshape(*lead, 3, 3, b, b, b, b, cin, cout)
    gathered = gathered.masked_fill(invalid, 0.0)
    # -> (..., u, v, (r s ci), (p q co))
    gathered = gathered.permute(*range(n), n, n + 1, n + 2, n + 3, n + 6, n + 4, n + 5, n + 7)
    return gathered.reshape(*lead, 3, 3, b * b * cin, b * b * cout)


def pack_bias_s2d(bias: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., C) bias -> (..., b*b*C): every phase sees the original bias."""
    return bias.repeat(*([1] * (bias.dim() - 1)), block * block)
