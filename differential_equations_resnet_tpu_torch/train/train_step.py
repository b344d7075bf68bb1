"""The training step: forward, cross-entropy from logits, backward, Adam, the
batch metrics and the per-layer gradient mean norms.

Port of `differential_equations_resnet_tpu/train/train_step.py`
(`make_adam`, the loss, `make_train_step`, `make_eval_step`).  The JAX
package jits a pure function of a `TrainState`; here the parameters live in
the model (an `nn.Module`) and the Adam slots in the optimizer, and a step
updates both in place.  On the card the identity stack's forward and
backward are the hand-written kernels B1 and B2 (one launch each a step);
nothing is synchronized with the host inside a step: the metrics and the
grad-norm row come back as device tensors.

Left for later: the device mesh (ROADMAP A15), the multi-step and
device-resident epoch loops (A9), and the harness with checkpoints (A7).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from differential_equations_resnet_tpu_torch.models.blocks import l2_kernel_penalty
from differential_equations_resnet_tpu_torch.models.single_block_resnet import map_leaves
from differential_equations_resnet_tpu_torch.train.telemetry import gradient_mean_norms

Metrics = Dict[str, torch.Tensor]


def make_adam(
    params: Iterable[torch.Tensor], learning_rate: float = 1e-3, epsilon: float = 1e-7
) -> torch.optim.Adam:
    """Adam with the reference's hyperparameters (tf.train.AdamOptimizer(lr,
    epsilon=1e-07)).  torch.optim.Adam's update is optax's, lr * m_hat /
    (sqrt(v_hat) + eps); the train step sets the learning rate every step."""
    return torch.optim.Adam(params, lr=learning_rate, eps=epsilon)


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


def _correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    target = labels.argmax(dim=-1) if labels.dim() > 1 else labels.long()
    return (logits.argmax(dim=-1) == target).sum().float()


def build_loss_fn(model: nn.Module) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The training objective ``(images, labels) -> (loss, logits)``: mean
    cross-entropy from logits plus, with ``config.l2_regularization > 0``,
    the L2 kernel penalty (which the reference declares on every kernel)."""
    l2_weight = float(model.config.l2_regularization or 0.0)

    def loss_fn(images, labels):
        logits = model(images, return_logits=True)
        loss = cross_entropy_from_logits(logits, labels)
        if l2_weight:
            loss = loss + l2_kernel_penalty(model.params(), l2_weight)
        return loss, logits

    return loss_fn


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    with_gradient_metrics: bool = True,
    accum_steps: int = 1,
) -> Callable[[torch.Tensor, torch.Tensor, float], Tuple[Metrics, torch.Tensor]]:
    """``step(images, labels, lr) -> (metrics, grad_norms)``: one update of
    ``model`` by ``optimizer`` at learning rate ``lr``.

    metrics = {"loss", "correct", "count"} (device scalars); grad_norms has
    shape (1 + num_layers,), ordered as `gradient_metric_names` (empty with
    ``with_gradient_metrics=False``).

    ``accum_steps=k > 1`` splits the batch into k equal microbatches, runs
    forward and backward on each and applies one update with the averaged
    gradient: the monolithic step's update (the L2 penalty averages back to
    one application) at one microbatch's activation memory.  A batch that k
    does not divide is trained monolithically, with a warning.  The loss is
    the mean of the microbatch losses, correct their sum."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}.")
    loss_fn = build_loss_fn(model)

    def step(images: torch.Tensor, labels: torch.Tensor, lr: float):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        n = images.shape[0]
        k = accum_steps
        if n % k:
            warnings.warn(
                f"batch of {n} is not divisible by accum_steps={k}; training it "
                "monolithically (full-batch activation memory for this batch).",
                stacklevel=2,
            )
            k = 1
        losses, correct = [], 0.0
        for x, y in zip(images.chunk(k), labels.chunk(k)):
            loss, logits = loss_fn(x, y)
            (loss / k).backward()
            losses.append(loss.detach())
            correct = correct + _correct(logits.detach(), y)
        grad_norms = (
            gradient_mean_norms(map_leaves(lambda p: p.grad, model.params()), model.config)
            if with_gradient_metrics
            else torch.zeros(0, device=images.device)
        )
        optimizer.step()
        metrics = {
            "loss": torch.stack(losses).mean(),
            "correct": correct,
            "count": torch.tensor(float(n), device=images.device),
        }
        return metrics, grad_norms

    return step


def make_eval_step(model: nn.Module) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """``(images, labels) -> metrics``: plain cross-entropy (never the L2
    penalty, as the reference's evaluation), the correct count and the
    count."""

    def step(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        with torch.no_grad():
            logits = model(images, return_logits=True)
            return {
                "loss": cross_entropy_from_logits(logits, labels),
                "correct": _correct(logits, labels),
                "count": torch.tensor(float(images.shape[0]), device=images.device),
            }

    return step
