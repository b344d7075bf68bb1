"""The training step and its loops: forward, cross-entropy from logits,
backward, Adam, the batch metrics and the per-layer gradient mean norms;
the K-step, device-resident epoch, evaluation and prediction loops.

Port of `differential_equations_resnet_tpu/train/train_step.py`.  The JAX
package jits pure functions of a `TrainState`; here the parameters live in
the model (an `nn.Module`) and the Adam slots in the optimizer, and a step
updates both in place.  The train step runs the forward with ``train=True``
(batch norm on the batch's statistics, its running statistics, the model's
buffers, updated in place; with ``accum_steps > 1`` they go through the
microbatches in order, as the JAX package threads them), evaluation and
prediction with ``train=False``.  On the card a fused identity stack's
forward and backward are the hand-written kernels B1 and B2 (one launch
each a step); nothing is synchronized with the host inside a step: the
metrics and the grad-norm row come back as device tensors.

The loops (`make_multi_step`, `make_device_epoch`, `make_multi_eval_step`,
`make_device_eval`, `make_predict_step`) keep the JAX signatures.  On CUDA
each captures one train step (or one eval or predict batch) once in a
`torch.cuda.CUDAGraph` over static input buffers, and replays it: a step
then costs a copy of its batch into the static buffers, one
``graph.replay()`` and a copy of its telemetry row into a device buffer of
rows, which the caller reads once.  The learning rate is the optimizer's
0-d device tensor (`make_adam` builds Adam with ``capturable=True`` on
CUDA), set before each replay.  A capture that fails raises; there is no
eager fallback.  The warm-up calls before a capture change the parameters,
the optimizer's state and the batch-norm buffers; each is given back its
value before the capture, so a replayed step starts where an eager one
would.  On the CPU the same functions run the step eagerly in a loop.  Each
capture opens a graph in the record of hand-kernel calls
(`utils.tracing.STACKS.capture`) and each replay adds that graph's totals
(`STACKS.replay`), so the record counts the replays' launches, not the
capture's, without this module knowing which kernels exist: it imports
none of them.

A graph holds the addresses of the parameters, the gradients and the
optimizer's state tensors at capture: after ``optimizer.load_state_dict``
(which replaces the state tensors) build the loop again.  ``donate`` and
``unroll`` are accepted and mean nothing here.

``mesh`` (a `parallel.mesh.create_mesh` mesh) makes every builder's
function what the JAX package's step sharded over the mesh computes.
Every rank calls it with the same global batch and keeps its own rows
(`parallel.mesh.shard_batch`, over the ``data`` axis); the forward runs
inside `parallel.collectives.data_parallel`, so batch norm takes the
moments of the whole batch; after the backward one flat all-reduce over
``data`` gives every rank the mean gradient, the global loss (the mean of
the ranks' means) and the summed ``correct`` and ``count``
(`_reduce_over_data`); the grad-norm row is computed from the reduced
gradients and Adam steps the same parameters on every rank.  With
``accum_steps = k`` each rank splits its own rows into k contiguous
microbatches: the JAX package's device-major split.  The device-resident
epoch draws the same order on every rank from the same generator and
gathers each rank's rows of each global batch; augmentation runs on the
whole global batch, so the generators stay in step, and each rank keeps
its own rows.  Evaluation sums the ranks' rows; prediction gathers them,
so every rank returns the whole batch's output; an int8 model's
activation scales are then the whole batch's in evaluation too, as in
training (`ops.quantize.absmax_groups`).  On CUDA the loops stay
graph replays, which capture NCCL's collectives; over gloo (which cannot
be captured) a loop raises naming the backend, with no eager fallback.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from differential_equations_resnet_tpu_torch.models.blocks import l2_kernel_penalty
from differential_equations_resnet_tpu_torch.models.single_block_resnet import map_leaves
from differential_equations_resnet_tpu_torch.parallel.collectives import all_gather_single, data_parallel
from differential_equations_resnet_tpu_torch.parallel.mesh import axis_size, shard_batch
from differential_equations_resnet_tpu_torch.train.telemetry import gradient_mean_norms
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, span

Metrics = Dict[str, torch.Tensor]
# Warm-up calls on a side stream before a capture (PyTorch's recipe for
# capturing a whole network): lazy initialisation happens outside the graph.
WARMUP_CALLS = 3


def _data_group(mesh, axis: str = "data"):
    """The process group of this rank's ``axis`` line, or None without a
    mesh or where the mesh has no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def _bind_mesh(model, mesh):
    """The model as the step builders run it on ``mesh``: its config bound
    to the mesh's data-axis size and platform (`with_mesh_context`, where
    the model has one).  The port's forward sees each rank's own rows, so
    its layout gates count per-device rows without it; the binding keeps
    the config the JAX package's step would see."""
    if mesh is None:
        return model
    binder = getattr(model, "with_mesh_context", None)
    if binder is None:
        return model
    return binder(data_axis_size=axis_size(mesh, "data"), device_platform=mesh.device_type)


def _local(mesh, *arrays, axis: str = "data"):
    """This rank's rows of each global array (the arrays themselves without
    a mesh)."""
    return arrays if mesh is None else shard_batch(mesh, arrays, axis)


def _reduce_over_data(params, group, loss, correct, count):
    """One all-reduce over ``group`` of every gradient and the three
    metrics: the gradients and the loss become their means over the ranks,
    ``correct`` and ``count`` their sums.  The gradients are written back
    in place; returns (loss, correct, count)."""
    ranks = dist.get_world_size(group)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    flat.div_(ranks)
    flat = torch.cat([flat, correct.reshape(1), count.reshape(1)])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = flat[offset:offset + n].view_as(p).clone()
        else:
            p.grad.copy_(flat[offset:offset + n].view_as(p))
        offset += n
    return flat[offset], flat[offset + 1], flat[offset + 2]


def _sum_over_data(values: torch.Tensor, mesh) -> torch.Tensor:
    """``values`` summed over the mesh's data axis (itself without one)."""
    group = _data_group(mesh)
    if group is not None:
        values = values.clone()
        dist.all_reduce(values, group=group)
    return values


def _require_capturable(mesh, model) -> None:
    """Raise unless the collectives of ``mesh`` and of the model's
    ``tp_mesh``/``pp_mesh`` on CUDA tensors can be captured in a CUDA graph
    (NCCL's can; gloo's cannot)."""
    config = model.config
    for m in (mesh, getattr(config, "tp_mesh", None), getattr(config, "pp_mesh", None)):
        if m is None:
            continue
        backend = str(dist.get_backend(m.get_group(0)))
        if "nccl" not in backend:
            raise RuntimeError(
                f"a CUDA graph cannot capture the {backend} backend's collectives: the "
                "captured loops need an NCCL mesh on CUDA (run make_train_step eagerly "
                "over gloo)."
            )


def init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Create every parameter's Adam state now, as zeros, as optax's
    ``init`` does and as `torch.optim.Adam` would at its first step: the
    checkpoint structure is then the same before and after the first step,
    and a CUDA graph can capture the state's addresses."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            on_device = group["capturable"] or group["fused"]
            state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device) if on_device
                             else torch.tensor(0.0, dtype=torch.float32))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def make_adam(
    params: Iterable[torch.Tensor], learning_rate: float = 1e-3, epsilon: float = 1e-7
) -> torch.optim.Adam:
    """Adam with the reference's hyperparameters (tf.train.AdamOptimizer(lr,
    epsilon=1e-07)), its state created at once (`init_adam_state`).
    torch.optim.Adam's update is optax's, lr * m_hat / (sqrt(v_hat) + eps).

    For parameters on CUDA it is ``capturable=True`` with the learning rate
    as a 0-d device tensor, so that a CUDA graph can capture a step and the
    rate can change between replays; the eager step uses the same
    optimizer.  On the CPU, where PyTorch refuses ``capturable``, the rate is
    a float.  The train step sets the rate every step."""
    params = list(params)
    if params and params[0].is_cuda:
        optimizer = torch.optim.Adam(
            params, lr=torch.tensor(learning_rate, dtype=torch.float32, device=params[0].device),
            eps=epsilon, capturable=True)
    else:
        optimizer = torch.optim.Adam(params, lr=learning_rate, eps=epsilon)
    init_adam_state(optimizer)
    return optimizer


@dataclasses.dataclass
class TrainState:
    """What the JAX package's TrainState holds: the step count, the
    parameters (here inside the model) and the optimizer state (inside the
    optimizer).  The harness advances ``step`` after each update."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> TrainState:
    return TrainState(model, optimizer if optimizer is not None else make_adam(model.parameters()))


def per_example_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N,) categorical cross-entropy from integer labels (N,) or one-hot or
    soft labels (N, num_classes)."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    if labels.dim() == logits.dim():
        return -torch.sum(labels.float() * log_probs, dim=-1)
    return -torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]


def cross_entropy_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy over the batch."""
    return per_example_cross_entropy(logits, labels).mean()


def _hits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    target = labels.argmax(dim=-1) if labels.dim() > 1 else labels.long()
    return (logits.argmax(dim=-1) == target).float()


def _correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _hits(logits, labels).sum()


def build_loss_fn(model: nn.Module) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The training objective ``(images, labels) -> (loss, logits)``: mean
    cross-entropy from logits plus, with ``config.l2_regularization > 0``,
    the L2 kernel penalty (which the reference declares on every kernel).
    The forward runs in train mode, so batch norm updates its running
    statistics."""
    l2_weight = float(model.config.l2_regularization or 0.0)

    def loss_fn(images, labels):
        logits = model(images, return_logits=True, train=True)
        loss = cross_entropy_from_logits(logits, labels)
        if l2_weight:
            loss = loss + l2_kernel_penalty(model.params(), l2_weight)
        return loss, logits

    return loss_fn


def _set_lr(optimizer: torch.optim.Optimizer, lr) -> None:
    """The learning rate of every group: written into the group's device
    tensor where it is one (no host-to-device copy), else set as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            if isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)


def _build_update(model, optimizer, with_gradient_metrics: bool, accum_steps: int,
                  mesh=None, axis: str = "data"):
    """``update(images, labels) -> (metrics, grad_norms)``: one optimizer
    step at the rate the optimizer holds, on this rank's rows.  This is
    what a graph captures.  Over a mesh the gradients and metrics are
    reduced over its ``axis`` (`_reduce_over_data`) before the grad norms
    and the update."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}.")
    loss_fn = build_loss_fn(model)
    group = _data_group(mesh, axis)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def update(images: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        n = images.shape[0]
        k = accum_steps
        if n % k:
            warnings.warn(
                f"batch of {n} is not divisible by accum_steps={k}; training it "
                "monolithically (full-batch activation memory for this batch).",
                stacklevel=3,
            )
            k = 1
        losses, correct = [], 0.0
        with data_parallel(group):
            for x, y in zip(images.chunk(k), labels.chunk(k)):
                loss, logits = loss_fn(x, y)
                (loss / k).backward()
                losses.append(loss.detach())
                correct = correct + _correct(logits.detach(), y)
        loss = torch.stack(losses).mean()
        # On the device without a host tensor: capturable.
        count = images.new_full((), n, dtype=torch.float32)
        if group is not None:
            loss, correct, count = _reduce_over_data(params, group, loss, correct, count)
        grad_norms = (
            gradient_mean_norms(map_leaves(lambda p: p.grad, model.params()), model.config)
            if with_gradient_metrics
            else torch.zeros(0, device=images.device)
        )
        optimizer.step()
        return {"loss": loss, "correct": correct, "count": count}, grad_norms

    return update


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    with_gradient_metrics: bool = True,
    accum_steps: int = 1,
    *,
    mesh=None,
) -> Callable[[torch.Tensor, torch.Tensor, float], Tuple[Metrics, torch.Tensor]]:
    """``step(images, labels, lr) -> (metrics, grad_norms)``: one eager
    update of ``model`` by ``optimizer`` at learning rate ``lr``.

    metrics = {"loss", "correct", "count"} (device scalars); grad_norms has
    shape (1 + num_layers,), ordered as `gradient_metric_names` (empty with
    ``with_gradient_metrics=False``).

    ``accum_steps=k > 1`` splits the batch into k equal microbatches, runs
    forward and backward on each and applies one update with the averaged
    gradient: the monolithic step's update (the L2 penalty averages back to
    one application) at one microbatch's activation memory.  A batch that k
    does not divide is trained monolithically, with a warning.  The loss is
    the mean of the microbatch losses, correct their sum.

    ``mesh``: every rank passes the same global batch and gets the same
    metrics, grad norms and parameters (module docstring)."""
    model = _bind_mesh(model, mesh)
    update = _build_update(model, optimizer, with_gradient_metrics, accum_steps, mesh)

    def step(images: torch.Tensor, labels: torch.Tensor, lr):
        _set_lr(optimizer, lr)
        return update(*_local(mesh, images, labels))

    return step


def pack_row(metrics: Metrics, grad_norms: torch.Tensor) -> torch.Tensor:
    """One telemetry row on the device: [loss, correct, count, *grad_norms]."""
    scalars = [metrics[k].reshape(1) for k in ("loss", "correct", "count")]
    return torch.cat(scalars + [grad_norms.reshape(-1)])


def unpack_rows(rows: torch.Tensor) -> Tuple[Metrics, torch.Tensor]:
    """(K, 3 + W) rows -> (metrics {each (K,)}, grad_norms (K, W))."""
    return {"loss": rows[:, 0], "correct": rows[:, 1], "count": rows[:, 2]}, rows[:, 3:]


def _graph_tensors(model: nn.Module, optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Every parameter, optimizer-state tensor and buffer of the model (the
    batch-norm running statistics): what a warm-up changes and the capture
    must leave as it found."""
    tensors = list(model.buffers())
    for group in optimizer.param_groups:
        for p in group["params"]:
            tensors.append(p.data)
            state = optimizer.state.get(p)
            if not state:
                raise ValueError(
                    "CUDA graph capture needs the optimizer's state to exist before the "
                    "capture (make_adam creates it; see init_adam_state)."
                )
            tensors.extend(v for v in state.values() if isinstance(v, torch.Tensor))
    return tensors


def _lr_tensors(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    tensors = [group["lr"] for group in optimizer.param_groups]
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors) or not all(
            group.get("capturable") for group in optimizer.param_groups):
        raise ValueError(
            "a CUDA graph of the train step needs an optimizer with capturable=True and a "
            "learning rate held in a device tensor (make_adam builds one)."
        )
    return tensors


def _capture(what: str, fn, inputs, keep: Sequence[torch.Tensor] = ()):
    """Capture ``fn(*inputs)`` (static device tensors, already filled) in a
    CUDA graph after `WARMUP_CALLS` calls on a side stream; every tensor of
    ``keep`` is given back its value from before the warm-up, in place.
    Returns (graph, outputs, the record's `CapturedGraph` of its hand-kernel
    calls, named ``what``: `utils.tracing.STACKS.capture`).  Raises, naming
    ``what``, if the capture fails: there is no eager fallback."""
    saved = [t.clone() for t in keep]
    side = torch.cuda.Stream(device=inputs[0].device)
    side.wait_stream(torch.cuda.current_stream(inputs[0].device))
    try:
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*inputs)
        torch.cuda.current_stream(inputs[0].device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(keep, saved):
                t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with STACKS.capture(what) as recorded, torch.cuda.graph(graph):
            outputs = fn(*inputs)
    except RuntimeError as e:
        raise RuntimeError(f"CUDA graph capture of the {what} failed: {e}") from e
    return graph, outputs, recorded


class _Replayed:
    """``fn`` over CUDA tensors, captured once per input shapes and dtypes
    (`_capture`) and replayed over static copies of the inputs.  The output
    is the graph's own: the next call overwrites it.  ``keep()`` names the
    state the warm-up must leave as it found it.  Each replay adds the
    hand-kernel calls its graph holds to the record (`STACKS.replay`)."""

    def __init__(self, what: str, fn, keep=tuple):
        self.what, self.fn, self.keep = what, fn, keep
        self.graphs = {}

    def __call__(self, *inputs: torch.Tensor):
        key = tuple((tuple(t.shape), t.dtype) for t in inputs)
        if key not in self.graphs:
            with span("deqres.capture"):
                static = [t.clone() for t in inputs]
                self.graphs[key] = (static, *_capture(self.what, self.fn, static, self.keep()))
        static, graph, outputs, recorded = self.graphs[key]
        with span("deqres.replay"):
            for s, t in zip(static, inputs):
                s.copy_(t)
            graph.replay()
        STACKS.replay(recorded)
        return outputs


class _StepRunner:
    """One train step ``(images, labels, lr) -> telemetry row`` on this
    rank's rows: the eager step on the CPU, a replayed graph on CUDA (whose
    row the next call overwrites: copy it first).  Over a mesh the row is
    the reduced one, the same on every rank."""

    def __init__(self, model, optimizer, with_gradient_metrics, accum_steps, mesh=None):
        self.optimizer, self.mesh, self.model = optimizer, mesh, model
        model = _bind_mesh(model, mesh)
        update = _build_update(model, optimizer, with_gradient_metrics, accum_steps, mesh)
        self.row = lambda images, labels: pack_row(*update(images, labels))
        self.replayed = _Replayed("train step", self.row, lambda: _graph_tensors(model, optimizer))

    def __call__(self, images: torch.Tensor, labels: torch.Tensor, lr) -> torch.Tensor:
        if not images.is_cuda:
            _set_lr(self.optimizer, lr)
            return self.row(images, labels)
        _lr_tensors(self.optimizer)  # raises unless the rate is a device tensor
        _require_capturable(self.mesh, self.model)
        _set_lr(self.optimizer, lr)
        return self.replayed(images.to(torch.float32), labels)


def make_multi_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh=None,
    with_gradient_metrics: bool = True,
    donate: bool = True,
    unroll: int = 1,
    accum_steps: int = 1,
):
    """K train steps over pre-staged batches:

        multi(images (K,B,H,W,C), labels (K,B), lrs (K,))
            -> (metrics {each (K,)}, grad_norms (K, 1+L))

    with per-step telemetry stacked on the device.  On CUDA each step is a
    replay of one captured step (see the module docstring): the K steps
    cost K replays and no host synchronization.  ``accum_steps``: each
    batch is itself microbatched (see `make_train_step`).  ``mesh``: the
    global batches, each rank training on its rows of each."""
    runner = _StepRunner(model, optimizer, with_gradient_metrics, accum_steps, mesh)

    def multi(images: torch.Tensor, labels: torch.Tensor, lrs):
        lrs = torch.as_tensor(lrs, dtype=torch.float32).to(images.device)
        rows = None
        for i in range(images.shape[0]):
            with span("deqres.step"):
                row = runner(*_local(mesh, images[i], labels[i]), lrs[i])
                if rows is None:
                    rows = row.new_empty((images.shape[0], row.numel()))
                rows[i].copy_(row)
        return unpack_rows(rows)

    return multi


def make_device_epoch(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    mesh=None,
    with_gradient_metrics: bool = True,
    augment=None,
    donate: bool = True,
    accum_steps: int = 1,
):
    """A device-resident epoch:

        epoch(features (N,H,W,C), labels (N,), generator, lrs (steps,))
            -> (metrics {each (steps,)}, grad_norms (steps, 1+L))

    The dataset lives on the device (uint8 recommended: 4x fewer bytes) and
    never comes back to the host.  ``torch.randperm(N, generator=...)`` on
    the features' device draws the epoch's order without replacement; step
    i gathers ``perm[i*B:(i+1)*B]``, casts to fp32, applies ``augment(
    generator, images)`` (`data.jit_augment`) and trains.  So ``steps *
    batch_size <= N`` must hold.  ``generator`` lives on the features'
    device and drives the shuffle and then each step's augmentation, in
    that order.  On CUDA every step is a replay of one captured step; the
    gather and the augmentation run eagerly between replays (a few small
    kernels).

    ``mesh``: every rank holds the whole dataset and a generator seeded
    alike, draws the same order, and gathers its rows of each global batch
    of ``batch_size``; with ``augment`` it gathers and augments the whole
    global batch (the draws are made at its shape, as without a mesh) and
    keeps its rows.  The epoch then equals the meshless one."""
    if batch_size % accum_steps:
        raise ValueError(
            f"accum_steps ({accum_steps}) must divide batch_size "
            f"({batch_size}): the device-resident epoch gathers exact "
            "batch_size batches, so a non-dividing accum_steps would fall "
            "back to the monolithic step on every batch."
        )
    runner = _StepRunner(model, optimizer, with_gradient_metrics, accum_steps, mesh)

    def epoch(features: torch.Tensor, labels: torch.Tensor, generator: torch.Generator, lrs):
        steps = len(lrs)
        n = features.shape[0]
        if steps * batch_size > n:
            raise ValueError(
                f"Device-resident epochs draw batches without replacement: "
                f"steps * batch_size ({steps} * {batch_size}) exceeds the "
                f"{n} examples in the device-resident dataset."
            )
        with span("deqres.epoch.begin"):
            lrs = torch.as_tensor(lrs, dtype=torch.float32).to(features.device)
            perm = torch.randperm(n, generator=generator, device=features.device)
        rows = None
        for i in range(steps):
            with span("deqres.step"):
                idx = perm[i * batch_size:(i + 1) * batch_size]
                if augment is None:
                    (idx,) = _local(mesh, idx)
                x = features.index_select(0, idx).to(torch.float32)
                y = labels.index_select(0, idx)
                if augment is not None:
                    x, y = _local(mesh, augment(generator, x), y)
                row = runner(x, y, lrs[i])
                if rows is None:
                    rows = row.new_empty((steps, row.numel()))
                rows[i].copy_(row)
        return unpack_rows(rows)

    return epoch


def make_eval_step(model: nn.Module, *, mesh=None) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """``(images, labels) -> metrics``: plain cross-entropy (never the L2
    penalty, as the reference's evaluation), the correct count and the
    count.  Eager.  ``mesh``: the global batch's metrics, each rank
    evaluating its rows."""
    model = _bind_mesh(model, mesh)

    def step(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        images, labels = _local(mesh, images, labels)
        with torch.no_grad(), data_parallel(_data_group(mesh)):
            logits = model(images, return_logits=True, train=False)
            count = images.new_full((), images.shape[0], dtype=torch.float32)
            if mesh is None:
                return {"loss": cross_entropy_from_logits(logits, labels),
                        "correct": _correct(logits, labels), "count": count}
            total, correct, count = _sum_over_data(torch.stack([
                per_example_cross_entropy(logits, labels).sum(), _correct(logits, labels),
                count]), mesh)
            return {"loss": total / count, "correct": correct, "count": count}

    return step


def _eval_row(model, mesh=None):
    """``row(images, labels, valid) -> [loss, correct, count]`` of one eval
    batch, ``valid`` (B,) masking padding: the loss is the mean over the
    valid examples.  Eager on the CPU, a replayed graph on CUDA (its row
    then the graph's own).  ``mesh``: the global batch's row, each rank
    evaluating its rows of the three arguments."""
    model = _bind_mesh(model, mesh)

    def row(images, labels, valid):
        with torch.no_grad(), data_parallel(_data_group(mesh)):
            logits = model(images, return_logits=True, train=False)
            count = valid.sum()
            total = (per_example_cross_entropy(logits, labels) * valid).sum()
            correct = (_hits(logits, labels) * valid).sum()
            if mesh is not None:
                total, correct, count = _sum_over_data(torch.stack([total, correct, count]), mesh)
            return torch.stack([total / count.clamp(min=1.0), correct, count])

    replayed = _Replayed("eval batch", row)

    def run(images, labels, valid):
        images, labels, valid = _local(mesh, images.to(torch.float32), labels, valid)
        if not images.is_cuda:
            return row(images, labels, valid)
        _require_capturable(mesh, model)
        return replayed(images, labels, valid)

    return run


def make_multi_eval_step(model: nn.Module, mesh=None, unroll: int = 1):
    """K-batch evaluation: ``(images (K,B,...), labels (K,B)) -> metrics
    {each (K,)}``, each batch a replay of one captured eval batch on
    CUDA.  Loss is plain cross-entropy."""
    runner = _eval_row(model, mesh)

    def multi(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        k, batch = images.shape[:2]
        valid = torch.ones(batch, dtype=torch.float32, device=images.device)
        rows = images.new_empty((k, 3), dtype=torch.float32)
        for i in range(k):
            rows[i].copy_(runner(images[i], labels[i], valid))
        return {"loss": rows[:, 0], "correct": rows[:, 1], "count": rows[:, 2]}

    return multi


def make_device_eval(model: nn.Module, batch_size: int, mesh=None):
    """A full pass over a device-resident dataset:

        eval_all(features (N,H,W,C), labels (N,))
            -> metrics {"loss", "correct", "count": each (steps,)}

    steps = ceil(N / batch_size); the ragged last batch is zero-padded and
    masked, its loss the mean over its valid examples, so the metrics equal
    feeding per-batch results to `StreamingMetrics`.  Every batch is a
    replay of one captured eval batch on CUDA."""
    runner = _eval_row(model, mesh)

    def eval_all(features: torch.Tensor, labels: torch.Tensor) -> Metrics:
        n = features.shape[0]
        steps = -(-n // batch_size)
        device = features.device
        rows = torch.empty((steps, 3), dtype=torch.float32, device=device)
        full = torch.ones(batch_size, dtype=torch.float32, device=device)
        for i in range(steps):
            start = i * batch_size
            x, y = features[start:start + batch_size], labels[start:start + batch_size]
            valid = full
            if len(x) < batch_size:
                pad = batch_size - len(x)
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
                y = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
                valid = (torch.arange(batch_size, device=device) < n - start).float()
            rows[i].copy_(runner(x, y, valid))
        return {"loss": rows[:, 0], "correct": rows[:, 1], "count": rows[:, 2]}

    return eval_all


def _gather_rows(local: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' rows over the mesh's data axis, in rank order (``local``
    itself without one)."""
    group = _data_group(mesh)
    if group is None:
        return local
    out = local.new_empty((dist.get_world_size(group) * local.shape[0],) + tuple(local.shape[1:]))
    all_gather_single(out, local.contiguous(), group=group)
    return out


def make_predict_step(model: nn.Module, mesh=None):
    """``predict(images) -> model output`` (softmax probabilities, the
    reference predictor's output), a new tensor on the images' device.  On
    CUDA a replay of one captured forward per batch shape.  ``mesh``: each
    rank runs its rows and every rank returns the whole batch's output."""
    model = _bind_mesh(model, mesh)

    def forward(images):
        with torch.no_grad(), data_parallel(_data_group(mesh)):
            return _gather_rows(model(images, train=False), mesh)

    replayed = _Replayed("predict batch", forward)

    def predict(images: torch.Tensor) -> torch.Tensor:
        (images,) = _local(mesh, images.to(torch.float32))
        if not images.is_cuda:
            return forward(images)
        _require_capturable(mesh, model)
        return replayed(images).clone()

    return predict
