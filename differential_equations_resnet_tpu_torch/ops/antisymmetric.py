"""Packed anti-centrosymmetric 3x3 convolution kernels, in PyTorch.

Port of `differential_equations_resnet_tpu/ops/antisymmetric.py` (the packed
3x3 layout).  A dense HWIO kernel ``K`` (3, 3, C, C) is antisymmetric when

    K[:, :, i, j] == -rot180(K[:, :, j, i])      for all channel pairs (i, j),

with the spatial centre of every diagonal block pinned to the constant
``gamma``.  Its free parameters are per-channel vectors a, b, c, d, laid out
on the diagonal blocks as

    [[ a,  b,  c],
     [ d,  g, -d],
     [-c, -b, -a]]        with g = gamma,

and ``cross`` (3, 3, C*(C-1)//2): the free blocks of the channel pairs
c_in > c_out, ordered by c_out ascending and then c_in ascending.  The blocks
with c_in < c_out are their mirrors ``-rot180(cross)``.

Materialization is advanced-index assignment, which autograd differentiates,
so a gradient with respect to the dense kernel folds back onto the packed
leaves.

The general k x k layout (`AntisymKxKParams`, `init_antisym_kxk`,
`materialize_kxk`, `pack_kxk`) holds each diagonal spatial block's free
entries in ``diag`` and mirrors them anti-centrosymmetrically (the
antisymmetric kernel type) or centrosymmetrically (the centrosymmetric
kernel type, whose odd-k centre is free).

The dense-lower layout (`Antisym3x3DenseParams`, the bottleneck family's
mid-conv) keeps the same free parameters with ``cross`` at its natural
(c_in > c_out) positions of a (..., 3, 3, C, C) tensor, so that
`materialize_3x3_from_dense` is a mask, a flip, a transpose and an add, with
no gather or scatter.  `dense_from_packed` and `packed_from_dense` convert
between the layouts bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import constant_cache


class Antisym3x3Params(NamedTuple):
    """Packed free parameters of a 3x3 antisymmetric conv, optionally with a
    leading stacked-layer axis ``(L, ...)``."""

    a: torch.Tensor                       # (..., C)
    b: torch.Tensor                       # (..., C)
    c: torch.Tensor                       # (..., C)
    d: torch.Tensor                       # (..., C)
    cross: torch.Tensor                   # (..., 3, 3, C*(C-1)//2)
    bias: Optional[torch.Tensor] = None   # (..., C) or None


class Antisym3x3DenseParams(NamedTuple):
    """The dense-lower storage of the same free parameters: ``cross`` is
    (..., 3, 3, C, C), strictly lower (c_in > c_out), zeros elsewhere."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    cross: torch.Tensor
    bias: Optional[torch.Tensor] = None


class AntisymKxKParams(NamedTuple):
    """Packed free parameters of the general k x k (anti-)centrosymmetric
    conv."""

    diag: torch.Tensor                    # (..., n_diag_free, C)
    cross: torch.Tensor                   # (..., k, k, C*(C-1)//2)
    bias: Optional[torch.Tensor] = None


def num_cross_pairs(channels: int) -> int:
    return channels * (channels - 1) // 2


@functools.lru_cache(maxsize=None)
def cross_pair_indices(channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """(c_in, c_out) index arrays of the free cross-channel blocks, ordered
    by c_out ascending and then c_in ascending."""
    pairs = [(i, j) for j in range(channels) for i in range(j + 1, channels)]
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(pairs, dtype=np.int64)
    return arr[:, 0], arr[:, 1]


def he_truncated_normal(
    generator: torch.Generator,
    shape: Sequence[int],
    fan_in: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """He-style init: N(0, 2/fan_in) truncated at 2 standard deviations.

    Drawn on the CPU from ``generator``.  The numbers differ from JAX's for
    any seed; the distribution is the same."""
    stddev = float(np.sqrt(2.0 / float(fan_in)))
    unit = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(unit, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (stddev * unit).to(dtype)


def init_antisym_3x3(
    generator: torch.Generator,
    channels: int,
    use_bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Antisym3x3Params:
    """Each free scalar He-truncated-normal with fan_in = 9*C; bias zero."""
    fan_in = 9 * channels
    draw = lambda shape: he_truncated_normal(generator, shape, fan_in, dtype)
    return Antisym3x3Params(
        a=draw((channels,)),
        b=draw((channels,)),
        c=draw((channels,)),
        d=draw((channels,)),
        cross=draw((3, 3, num_cross_pairs(channels))),
        bias=torch.zeros((channels,), dtype=dtype) if use_bias else None,
    )


def _diag_blocks(a, b, c, d, gamma: float, axis: int) -> torch.Tensor:
    """[[a, b, c], [d, g, -d], [-c, -b, -a]] stacked at ``axis`` (rows) and
    ``axis + 1`` (columns)."""
    g = torch.full_like(a, gamma)
    return torch.stack(
        [
            torch.stack([a, b, c], dim=axis),
            torch.stack([d, g, -d], dim=axis),
            torch.stack([-c, -b, -a], dim=axis),
        ],
        dim=axis,
    )


@constant_cache
def _cross_index_tensors(channels: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cross_pair_indices` as long tensors on ``device``, made once per
    (channels, device): a host-to-device copy on every materialization
    cannot be captured in a CUDA graph.  Never written to; made outside
    inference mode, so that autograd may use them whoever asked first."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(np.ascontiguousarray(arr), dtype=torch.long, device=device)
                     for arr in cross_pair_indices(channels))


def materialize_3x3(params: Antisym3x3Params, gamma: float = 0.0) -> torch.Tensor:
    """Packed params -> dense (3, 3, C, C) HWIO kernel."""
    a = params.a
    channels = a.shape[-1]
    kernel = a.new_zeros((3, 3, channels, channels))
    idx = torch.arange(channels, device=a.device)
    kernel[:, :, idx, idx] = _diag_blocks(a, params.b, params.c, params.d, gamma, 0)
    if channels > 1:
        ci, co = _cross_index_tensors(channels, a.device)
        kernel[:, :, ci, co] = params.cross
        kernel[:, :, co, ci] = -params.cross.flip(0, 1)
    return kernel


def materialize_3x3_stacked(
    params: Antisym3x3Params, gamma: float = 0.0
) -> torch.Tensor:
    """Stacked packed params (leading layer axis L) -> dense (L, 3, 3, C, C)
    kernels, all layers in one indexed assignment."""
    a = params.a
    num_layers, channels = a.shape
    kernel = a.new_zeros((num_layers, 3, 3, channels, channels))
    idx = torch.arange(channels, device=a.device)
    kernel[:, :, :, idx, idx] = _diag_blocks(
        a, params.b, params.c, params.d, gamma, 1
    )
    if channels > 1:
        ci, co = _cross_index_tensors(channels, a.device)
        kernel[:, :, :, ci, co] = params.cross
        kernel[:, :, :, co, ci] = -params.cross.flip(1, 2)
    return kernel


def dense_from_packed(params: Antisym3x3Params) -> Antisym3x3DenseParams:
    """Packed (..., 3, 3, P) cross -> the dense-lower (..., 3, 3, C, C)
    storage, zeros off the strictly lower triangle (one indexed write; for
    init and conversion, not a hot path)."""
    channels = params.a.shape[-1]
    cross = params.cross.new_zeros(tuple(params.cross.shape[:-1]) + (channels, channels))
    if channels > 1:
        ci, co = _cross_index_tensors(channels, cross.device)
        cross[..., ci, co] = params.cross
    return Antisym3x3DenseParams(params.a, params.b, params.c, params.d, cross, params.bias)


def packed_from_dense(params: Antisym3x3DenseParams) -> Antisym3x3Params:
    """Inverse of `dense_from_packed` (one gather)."""
    ci, co = _cross_index_tensors(params.a.shape[-1], params.cross.device)
    return Antisym3x3Params(params.a, params.b, params.c, params.d,
                            params.cross[..., ci, co], params.bias)


def init_antisym_3x3_dense(
    generator: torch.Generator,
    channels: int,
    use_bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> Antisym3x3DenseParams:
    """Dense-layout init: draws exactly what `init_antisym_3x3` draws from
    the same generator state, scattered into place."""
    return dense_from_packed(init_antisym_3x3(generator, channels, use_bias, dtype))


@constant_cache
def _lower_and_eye(channels: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strictly lower (c_in > c_out) mask and the identity, (C, C), on
    ``device``, made once (capture-safe, as `_cross_index_tensors`)."""
    with torch.inference_mode(False):
        lower = torch.ones(channels, channels, dtype=torch.bool, device=device).tril(-1)
        return lower, torch.eye(channels, device=device)


def materialize_3x3_from_dense(
    params: Antisym3x3DenseParams, gamma: float = 0.0
) -> torch.Tensor:
    """Dense-lower params -> the full (..., 3, 3, C, C) HWIO kernel, with no
    gather or scatter:

        W = lower_mask * cross
        K = W - flip_hw(W) transposed over (c_in, c_out) + diag(a, b, c, d, gamma) * I

    The same kernel as `materialize_3x3` of the packed params.  Leading
    (stacked-layer) dimensions pass through, so a whole (L, ...) stack
    materializes at once."""
    a = params.a
    lower, eye = _lower_and_eye(a.shape[-1], a.device)
    diag = _diag_blocks(a, params.b, params.c, params.d, gamma, a.dim() - 1)
    w = torch.where(lower, params.cross, 0.0)
    kernel = w - w.flip(-4, -3).transpose(-1, -2)
    return kernel + diag[..., None] * eye.to(a.dtype)


def pack_3x3(
    kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> Antisym3x3Params:
    """Inverse of `materialize_3x3` up to the constant gamma centre: the
    packed free parameters of a dense (3, 3, C, C) kernel."""
    channels = kernel.shape[-1]
    idx = torch.arange(channels, device=kernel.device)
    diag = kernel[:, :, idx, idx]  # (3, 3, C)
    ci, co = _cross_index_tensors(channels, kernel.device)
    return Antisym3x3Params(
        a=diag[0, 0],
        b=diag[0, 1],
        c=diag[0, 2],
        d=diag[1, 0],
        cross=kernel[:, :, ci, co],
        bias=bias,
    )


@functools.lru_cache(maxsize=None)
def _diag_layout(kernel_size: int, antisymmetric: bool):
    """The free entries of a k x k (anti-)centrosymmetric diagonal block, as
    the JAX package lays them out: entry (i, j) of the upper half (j >= i) is
    free where ``j > i`` or ``j == i and i <= k//2 - 1``, and its mirror is
    (k-1-i, k-1-j), negated (antisymmetric) or not (centrosymmetric).  For
    odd k the centre is the constant gamma in the antisymmetric case and one
    more free entry, its own mirror, otherwise.

    Returns (free_flat, mirror_flat, center_flat_or_None), flat k*k
    indices."""
    free, mirror = [], []
    center = None
    for i in range(kernel_size):
        for j in range(i, kernel_size):
            if j > i or (j == i and i <= kernel_size // 2 - 1):
                free.append(i * kernel_size + j)
                mirror.append((kernel_size - 1 - i) * kernel_size + (kernel_size - 1 - j))
            elif j == i and i == kernel_size // 2 and kernel_size % 2 == 1:
                if antisymmetric:
                    center = i * kernel_size + j
                else:
                    free.append(i * kernel_size + j)
                    mirror.append(i * kernel_size + j)
    return np.asarray(free, np.int64), np.asarray(mirror, np.int64), center


def num_diag_free(kernel_size: int, antisymmetric: bool = True) -> int:
    """Free entries of one diagonal (per-channel) spatial block."""
    return int(_diag_layout(kernel_size, antisymmetric)[0].size)


@functools.lru_cache(maxsize=None)
def _diag_gather(kernel_size: int, antisymmetric: bool):
    """For each flat position p of a k x k diagonal block: the free entry it
    copies (``num_diag_free`` where none: a zero slot), its sign, and a 1
    at the constant-gamma centre.  A position written by both the free and
    the mirror list (the centrosymmetric centre) copies its entry once, as
    the JAX package's second ``.at[].set`` overwrites the first, so its
    gradient is counted once."""
    free, mirror, center = _diag_layout(kernel_size, antisymmetric)
    source = np.full(kernel_size * kernel_size, free.size, np.int64)
    sign = np.zeros(kernel_size * kernel_size, np.float32)
    source[free], sign[free] = np.arange(free.size), 1.0
    source[mirror], sign[mirror] = np.arange(free.size), -1.0 if antisymmetric else 1.0
    centre = np.zeros(kernel_size * kernel_size, np.float32)
    if center is not None:
        centre[center] = 1.0
    return source, sign, centre


@constant_cache
def _diag_gather_tensors(kernel_size: int, antisymmetric: bool, device: torch.device):
    """`_diag_gather` as tensors on ``device``, made once (capture-safe, as
    `_cross_index_tensors`)."""
    with torch.inference_mode(False):
        source, sign, centre = _diag_gather(kernel_size, antisymmetric)
        return (torch.as_tensor(source, device=device),
                torch.as_tensor(sign, device=device), torch.as_tensor(centre, device=device))


def init_antisym_kxk(
    generator: torch.Generator,
    kernel_size: int,
    channels: int,
    antisymmetric: bool = True,
    use_bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> AntisymKxKParams:
    """Each free scalar He-truncated-normal with fan_in = k*k*C; bias zero."""
    fan_in = kernel_size * kernel_size * channels
    return AntisymKxKParams(
        diag=he_truncated_normal(
            generator, (num_diag_free(kernel_size, antisymmetric), channels), fan_in, dtype),
        cross=he_truncated_normal(
            generator, (kernel_size, kernel_size, num_cross_pairs(channels)), fan_in, dtype),
        bias=torch.zeros((channels,), dtype=dtype) if use_bias else None,
    )


def materialize_kxk(
    params: AntisymKxKParams,
    kernel_size: int,
    gamma: float = 0.0,
    antisymmetric: bool = True,
) -> torch.Tensor:
    """Packed params -> dense (..., k, k, C, C) HWIO kernel.

    The diagonal blocks are (anti-)centrosymmetric as ``antisymmetric``
    says; the cross-channel mirror blocks are always ``-rot180`` of the free
    blocks, as in the JAX package.  Leading (stacked-layer) dimensions pass
    through, so a whole (L, ...) stack materializes at once.  The diagonal
    blocks are a gather of the free entries (see `_diag_gather`)."""
    k = kernel_size
    diag = params.diag
    channels = diag.shape[-1]
    lead = tuple(diag.shape[:-2])
    source, sign, centre = _diag_gather_tensors(k, antisymmetric, diag.device)
    slots = torch.cat([diag, diag.new_zeros(lead + (1, channels))], dim=-2)
    flat = slots[..., source, :] * sign[:, None].to(diag.dtype)
    if gamma:
        flat = flat + gamma * centre[:, None].to(diag.dtype)
    blocks = flat.reshape(lead + (k, k, channels))
    kernel = diag.new_zeros(lead + (k, k, channels, channels))
    idx = torch.arange(channels, device=diag.device)
    kernel[..., idx, idx] = blocks
    if channels > 1:
        ci, co = _cross_index_tensors(channels, diag.device)
        kernel[..., ci, co] = params.cross
        kernel[..., co, ci] = -params.cross.flip(-3, -2)
    return kernel


def pack_kxk(
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    antisymmetric: bool = True,
) -> AntisymKxKParams:
    """Inverse of `materialize_kxk` (up to the constant gamma centre in the
    antisymmetric case): the packed free parameters of a dense (..., k, k,
    C, C) kernel."""
    k, channels = kernel.shape[-3], kernel.shape[-1]
    lead = tuple(kernel.shape[:-4])
    free, _, _ = _diag_layout(k, antisymmetric)
    idx = torch.arange(channels, device=kernel.device)
    diag_flat = kernel[..., idx, idx].reshape(lead + (k * k, channels))
    ci, co = _cross_index_tensors(channels, kernel.device)
    return AntisymKxKParams(
        diag=diag_flat[..., torch.as_tensor(free, device=kernel.device), :],
        cross=kernel[..., ci, co],
        bias=bias,
    )
