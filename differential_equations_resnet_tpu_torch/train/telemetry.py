"""Per-layer gradient mean-norm telemetry and its CSV logger.

Port of `differential_equations_resnet_tpu/train/telemetry.py` for the
single-block family.  The telemetry is the reference's product: one scalar
||grad||_2 / size(grad) per convolutional layer and step.  The layer
structure is explicit in the parameter tree, so the norms of a stacked
(L, ...) run of identity blocks are one reduction over the stack.

Names match the reference CSV columns: ``conv1_kernel_gradient_mean_norm``,
then ``res{stage}_{block}_branch2_kernel_gradient_mean_norm`` per residual
layer.  The bottleneck family waits for ROADMAP A12; the TensorBoard-style
`SummaryWriter` and the moment summaries wait for the harness (A7).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNetConfig,
    stage_plans,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    num_cross_pairs,
)


def _check_config(config) -> None:
    if isinstance(config, SingleBlockResNetConfig):
        return
    if type(config).__name__ == "BottleneckResNetConfig":
        raise NotImplementedError(
            "gradient telemetry of the bottleneck family waits for its port (ROADMAP A12)"
        )
    raise TypeError(f"Unsupported config type {type(config)}.")


def _mean_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x) / x.numel()


def _stacked_mean_norms(blocks: Antisym3x3Params) -> torch.Tensor:
    """(L,) mean norms of stacked packed antisymmetric grads.  Biases are
    excluded and the divisor counts the layer's free degrees of freedom,
    4C + 9 * C(C-1)/2, as the JAX package does."""
    leaves = [blocks.a, blocks.b, blocks.c, blocks.d, blocks.cross]
    sq = sum(torch.sum(torch.square(leaf), dim=tuple(range(1, leaf.dim()))) for leaf in leaves)
    channels = blocks.a.shape[-1]
    return torch.sqrt(sq) / (4 * channels + 9 * num_cross_pairs(channels))


def gradient_metric_names(config) -> List[str]:
    _check_config(config)
    names = ["conv1_kernel_gradient_mean_norm"]
    for s, plan in enumerate(stage_plans(config)):
        stage = s + 2
        block = 0
        if plan.has_conv_block:
            names.append(f"res{stage}_{block}_branch2_kernel_gradient_mean_norm")
            block = 1
        for i in range(plan.num_identity):
            names.append(f"res{stage}_{block + i}_branch2_kernel_gradient_mean_norm")
    return names


def gradient_mean_norms(grads, config) -> torch.Tensor:
    """Per-layer gradient mean norms of a gradient tree (the parameter
    tree's layout), ordered as `gradient_metric_names`, on the grads'
    device."""
    _check_config(config)
    values = [_mean_norm(grads["stem"].kernel).reshape(1)]
    for plan, sg in zip(stage_plans(config), grads["stages"]):
        if plan.has_conv_block:
            values.append(_mean_norm(sg["conv_main"].kernel).reshape(1))
        if sg["blocks"] is not None:
            values.append(_stacked_mean_norms(sg["blocks"]))
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
