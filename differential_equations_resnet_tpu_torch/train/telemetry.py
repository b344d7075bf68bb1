"""Per-layer gradient mean-norm telemetry and its CSV logger.

Port of `differential_equations_resnet_tpu/train/telemetry.py`.  The
telemetry is the reference's product: one scalar ||grad||_2 / size(grad) per
convolutional layer and step.  The layer structure is explicit in the
parameter tree, so the norms of a stacked (L, ...) run of identity blocks
are one reduction over the stack, for every kernel type: the antisymmetric
leaves of either layout (a, b, c, d, cross; divisor the free degrees of
freedom 4C + 9C(C-1)/2, so the dense-lower layout, whose other cross
entries are zeros with zero gradient, reports what the packed one does),
the packed k x k leaves (diag and cross; divisor their sizes) or the dense
kernel (divisor k*k*C*C).  Biases and batch norm are left out.

Names match the reference CSV columns: ``conv1_kernel_gradient_mean_norm``,
then for the single-block family
``res{stage}_{block}_branch2_kernel_gradient_mean_norm`` per residual layer,
and for the bottleneck family
``res{stage}_{block}_branch2b_kernel_gradient_mean_norm`` per block, the
norm of its 3x3 mid-conv.  `SummaryWriter` and the moment and mean-norm
summaries are the reference's tf.summary scalars.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.models.blocks import ConvParams
from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import (
    BottleneckResNetConfig,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNetConfig,
    stage_plans,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    Antisym3x3Params,
    AntisymKxKParams,
    num_cross_pairs,
)

_ANTISYM_3X3 = (Antisym3x3Params, Antisym3x3DenseParams)


def _mean_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x) / x.numel()


def _kernel_leaves(block_grads) -> List[torch.Tensor]:
    """The kernel leaves of a layer's (or a stack's) grads, biases left out:
    the antisymmetric parameters of either layout, the packed k x k ones, or
    the dense conv kernel."""
    if isinstance(block_grads, _ANTISYM_3X3):
        return [block_grads.a, block_grads.b, block_grads.c, block_grads.d, block_grads.cross]
    if isinstance(block_grads, AntisymKxKParams):
        return [block_grads.diag, block_grads.cross]
    if isinstance(block_grads, ConvParams):
        return [block_grads.kernel]
    raise TypeError(f"Unsupported block grads type {type(block_grads)}.")


def _per_layer_free_size(block_grads, stacked: bool = True) -> int:
    """Free degrees of freedom of one layer (of a stack, where ``stacked``):
    4C + 9C(C-1)/2 for antisymmetric kernels of either layout, else the
    sizes of the kernel leaves (without their leading layer axis), as the
    JAX package counts them."""
    if isinstance(block_grads, _ANTISYM_3X3):
        channels = block_grads.a.shape[-1]
        return 4 * channels + 9 * num_cross_pairs(channels)
    start = 1 if stacked else 0
    return sum(int(np.prod(leaf.shape[start:])) for leaf in _kernel_leaves(block_grads))


def _stacked_mean_norms(block_grads) -> torch.Tensor:
    """(L,) mean norms of a stack's grads: one reduction over the stack."""
    leaves = _kernel_leaves(block_grads)
    sq = sum(torch.sum(torch.square(leaf), dim=tuple(range(1, leaf.dim()))) for leaf in leaves)
    return torch.sqrt(sq) / _per_layer_free_size(block_grads)


def gradient_metric_names(config) -> List[str]:
    names = ["conv1_kernel_gradient_mean_norm"]
    if isinstance(config, SingleBlockResNetConfig):
        for s, plan in enumerate(stage_plans(config)):
            stage = s + 2
            block = 0
            if plan.has_conv_block:
                names.append(f"res{stage}_{block}_branch2_kernel_gradient_mean_norm")
                block = 1
            for i in range(plan.num_identity):
                names.append(f"res{stage}_{block + i}_branch2_kernel_gradient_mean_norm")
    elif isinstance(config, BottleneckResNetConfig):
        for s, num_blocks in enumerate(config.blocks_per_stage):
            names += [f"res{s + 2}_{b}_branch2b_kernel_gradient_mean_norm"
                      for b in range(num_blocks)]
    else:
        raise TypeError(f"Unsupported config type {type(config)}.")
    return names


def gradient_mean_norms(grads, config) -> torch.Tensor:
    """Per-layer gradient mean norms of a gradient tree (the parameter
    tree's layout), ordered as `gradient_metric_names`, on the grads'
    device.  Bottleneck blocks report their 3x3 mid-conv: the conv block's,
    then the stacked identity blocks'."""
    values = [_mean_norm(grads["stem"].kernel).reshape(1)]
    if isinstance(config, SingleBlockResNetConfig):
        for plan, sg in zip(stage_plans(config), grads["stages"]):
            if plan.has_conv_block:
                values.append(_mean_norm(sg["conv_main"].kernel).reshape(1))
            if sg["blocks"] is not None:
                values.append(_stacked_mean_norms(sg["blocks"]))
    elif isinstance(config, BottleneckResNetConfig):
        for sg in grads["stages"]:
            conv2 = sg["conv_block"]["conv2"]
            sq = sum(torch.sum(torch.square(leaf)) for leaf in _kernel_leaves(conv2))
            values.append((torch.sqrt(sq) / _per_layer_free_size(conv2, stacked=False)).reshape(1))
            if sg["identity_blocks"] is not None:
                values.append(_stacked_mean_norms(sg["identity_blocks"]["conv2"]))
    else:
        raise TypeError(f"Unsupported config type {type(config)}.")
    return torch.cat(values)


class CsvLogger:
    """Space-delimited CSV logger with the reference's columns
    (gradient_history and evaluation_metrics files)."""

    def __init__(self, path: str, fieldnames: Sequence[str], delimiter: str = " "):
        self.path = path
        self.fieldnames = list(fieldnames)
        self.delimiter = delimiter
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_header = not (os.path.exists(path) and os.path.getsize(path) > 0)
        self._fp = open(path, "a", buffering=1)
        if write_header:
            self._fp.write(self.delimiter.join(self.fieldnames) + "\n")

    def log(self, values: Sequence) -> None:
        if len(values) != len(self.fieldnames):
            raise ValueError(f"Expected {len(self.fieldnames)} values, got {len(values)}.")
        self._fp.write(self.delimiter.join(str(v) for v in values) + "\n")

    def close(self) -> None:
        self._fp.close()


def add_moments_summary(writer: "SummaryWriter", name: str, value, step: int) -> None:
    """Log mean / stddev / max / min of a tensor (reference
    `training/tf_variable_summaries.py:3-22`)."""
    arr = _numpy(value)
    writer.scalar(f"{name}/mean", float(arr.mean()), step)
    writer.scalar(f"{name}/stddev", float(arr.std()), step)
    writer.scalar(f"{name}/max", float(arr.max()), step)
    writer.scalar(f"{name}/min", float(arr.min()), step)


def add_mean_norm_summary(
    writer: "SummaryWriter", name: str, value, step: int, order: int = 2
) -> None:
    """Log ||v||_order / size(v) (reference
    `training/tf_variable_summaries.py:24-38`)."""
    arr = _numpy(value).reshape(-1)
    writer.scalar(f"{name}/mean_norm", float(np.linalg.norm(arr, ord=order) / arr.size), step)


def _numpy(value) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array, reduced on the
    host as the JAX package reduces it."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class SummaryWriter:
    """Scalar summary writer: TensorBoard (through
    `torch.utils.tensorboard`) where the ``tensorboard`` package is
    installed, else one JSON object a line in ``<log_dir>/scalars.jsonl``,
    byte for byte as the JAX package's writer."""

    def __init__(self, log_dir: str, use_tensorboard: Optional[bool] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._jsonl = None
        if use_tensorboard is None or use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter as TBWriter
            except ImportError:
                if use_tensorboard:
                    raise
            else:
                self._tb = TBWriter(log_dir=log_dir)
        if self._tb is None:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
            )

    def scalars(self, values: dict, step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
