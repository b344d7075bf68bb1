"""Pipeline parallelism over depth.

Port of `differential_equations_resnet_tpu/parallel/pipeline.py`: the
GPipe-style static schedule.  The stacked layer parameters (L, ...) are
split along the layer axis over the mesh's ``pipe`` axis (stage p holds
layers [p*L/P, (p+1)*L/P)), the batch into M microbatches, and every
rank runs the same P + M - 1 ticks: at tick t stage p applies its layers
to microbatch t - p and hands the result to stage p + 1 (`ring_hop`, one
`batch_isend_irecv`).  Ticks outside 0 <= t - p < M (the fill and the
drain) compute on whatever the buffer holds and are masked, as in the
JAX package; here this also keeps every rank's sequence of collectives
the same in the forward and in the backward, where the hop's backward
hands the cotangent back a stage.  The masks are tensors, never Python
branches, so every rank builds the same autograd graph.  Each stage body
is rematerialized (non-reentrant `torch.utils.checkpoint`, the JAX
package's `jax.checkpoint`).  The last stage's outputs are summed over
``pipe`` (`sum_over`), so every rank returns them.

Gradients follow the conventions of `parallel.collectives`: the ranks of
``pipe`` compute the same loss from the returned output, the kernels and
the input reach the stages through `copy_to_group`, and every rank ends
with the whole stack's dK, db and dx.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from differential_equations_resnet_tpu_torch.ops.conv import euler_relu_step
from differential_equations_resnet_tpu_torch.parallel import tensor_parallel
from differential_equations_resnet_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_rows,
    ring_hop,
    sum_over,
)
from differential_equations_resnet_tpu_torch.parallel.mesh import axis_size
from differential_equations_resnet_tpu_torch.models.blocks import ConvParams


def _flag(like: torch.Tensor, value: bool) -> torch.Tensor:
    """A 0-d bool on ``like``'s device, made by a fill (no host copy, so a
    CUDA graph can capture it)."""
    return like.new_full((), bool(value), dtype=torch.bool)


def pipeline_scan(
    stage_params: Any,
    x_micro: torch.Tensor,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    group,
) -> torch.Tensor:
    """The per-rank pipeline loop over the ``pipe`` process ``group``.

    stage_params: this stage's slice of the stacked layer parameters (a
        tuple of tensors, leading axis L/P).
    x_micro: (M, mb, H, W, C) microbatches, the same on every rank; only
        stage 0 reads them.
    stage_fn: (stage_params, y) -> y, the stage body.
    Returns (M, mb, H, W, C): the output microbatches, valid on the last
    stage (zeros elsewhere)."""
    p = dist.get_rank(group)
    n_stages = dist.get_world_size(group)
    m = x_micro.shape[0]
    n_ticks = m + n_stages - 1
    params = tuple(stage_params)

    def body(*args):
        return stage_fn(args[:-1], args[-1])

    first = _flag(x_micro, p == 0)
    zeros = torch.zeros_like(x_micro[0])
    buf = zeros
    outputs = [zeros] * m
    for t in range(n_ticks):
        # Stage 0 takes microbatch t (zeros once the feed is exhausted).
        feed = x_micro[t] if t < m else zeros
        buf = torch.where(first, feed, buf)
        y = checkpoint(body, *params, buf, use_reentrant=False, preserve_rng_state=False)
        y = torch.where(_flag(y, 0 <= t - p < m), y, zeros)
        # The last stage banks microbatch t - (P - 1).
        out_idx = min(max(t - (n_stages - 1), 0), m - 1)
        banked = _flag(y, p == n_stages - 1 and t - (n_stages - 1) >= 0)
        outputs[out_idx] = torch.where(banked, y, outputs[out_idx])
        # Hand the activation to the next stage (nothing reads the last
        # tick's hand-off, so it is not made).
        if t < n_ticks - 1:
            buf = ring_hop(y, group)
    return torch.stack(outputs)


def _stage_fn(h: float, tp_group):
    """The stage body: its L/P Euler steps, in Megatron form over
    ``tp_group`` where there is one."""

    def stage(params, y):
        kernels, biases = params
        for layer in range(kernels.shape[0]):
            if tp_group is None:
                y = euler_relu_step(y, kernels[layer], biases[layer], h)
            else:
                y = tensor_parallel.euler_step(
                    y, ConvParams(kernels[layer], biases[layer]), h, tp_group)
        return y

    return stage


def _batch_axes(batch_spec) -> Sequence[str]:
    if batch_spec is None:
        return ()
    if isinstance(batch_spec, str):
        return (batch_spec,)
    return tuple(a for a in batch_spec if a is not None)


def pipeline_blocks_apply(
    kernels: torch.Tensor,
    biases: torch.Tensor,
    x: torch.Tensor,
    h: float,
    mesh,
    axis_name: str = "pipe",
    num_microbatches: Optional[int] = None,
    batch_spec: Union[str, Sequence[Optional[str]], None] = (),
    tp_axis: Optional[str] = None,
) -> torch.Tensor:
    """An L-layer Euler identity stack pipelined over ``mesh[axis_name]``.

    kernels: (L, 3, 3, C, C) dense kernels (already materialized or s2d
        packed), the same on every rank; each stage takes its layers.
    biases: (L, C).
    x: (B, H, W, C), the same on every rank.  ``batch_spec`` names the mesh
        axes the batch is split over (the JAX ``P("data")``, here a tuple
        of names): each rank then runs its rows, and the result is
        gathered back.
    Returns (B, H, W, C), the same on every rank.

    ``tp_axis`` composes channel tensor parallelism inside each stage
    (tp x pp): each rank of ``mesh[tp_axis]`` convolves the full
    activations into its c_out slice and the slices are all-gathered every
    layer (`parallel.tensor_parallel`).  Raises the JAX package's
    `ValueError`s for layers that do not split over the stages, channels
    that do not split over the TP axis and a batch that does not split
    into the microbatches."""
    n_stages = axis_size(mesh, axis_name)
    num_layers = kernels.shape[0]
    if num_layers % n_stages:
        raise ValueError(
            f"num_layers ({num_layers}) must divide evenly into "
            f"{n_stages} pipeline stages"
        )
    if tp_axis is not None:
        channels = kernels.shape[-1]
        if channels % axis_size(mesh, tp_axis):
            raise ValueError(
                f"channels ({channels}) must divide evenly over the "
                f"{axis_size(mesh, tp_axis)}-way tensor-parallel axis {tp_axis!r}"
            )
    batch_axes = _batch_axes(batch_spec)
    batch = x.shape[0]
    for axis in batch_axes:
        batch //= axis_size(mesh, axis)
    m = num_microbatches or n_stages
    if batch % m:
        raise ValueError(f"batch ({batch}) must divide into {m} microbatches")

    # The batch split: each rank's rows, the kernels' gradients summed over
    # the rows' ranks.
    for axis in batch_axes:
        group = mesh.get_group(axis)
        kernels, biases, x = (copy_to_group(t, group) for t in (kernels, biases, x))
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        x = x[rank * (x.shape[0] // size):(rank + 1) * (x.shape[0] // size)]

    pipe = mesh.get_group(axis_name)
    p = dist.get_rank(pipe)
    per = num_layers // n_stages
    kernels = copy_to_group(kernels, pipe)[p * per:(p + 1) * per]
    biases = copy_to_group(biases, pipe)[p * per:(p + 1) * per]
    tp_group = None
    if tp_axis is not None:
        tp_group = mesh.get_group(tp_axis)
        kernels, biases = tensor_parallel.shard_out_channels(ConvParams(kernels, biases), tp_group)
    x_in = copy_to_group(x, pipe)
    x_micro = x_in.reshape((m, x_in.shape[0] // m) + tuple(x_in.shape[1:]))
    outputs = pipeline_scan((kernels, biases), x_micro, _stage_fn(float(h), tp_group), pipe)
    # Valid only on the last stage: the sum over the stages gives every rank
    # the result.
    outputs = torch.where(_flag(outputs, p == n_stages - 1), outputs, torch.zeros_like(outputs))
    y = sum_over(outputs, pipe).reshape(x.shape)
    for axis in reversed(batch_axes):
        y = gather_rows(y, mesh.get_group(axis))
    return y
