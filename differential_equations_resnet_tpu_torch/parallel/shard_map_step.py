"""The explicit-collective data-parallel train step.

Port of `differential_equations_resnet_tpu/parallel/shard_map_step.py`.
The JAX package has two data-parallel steps: `make_train_step(mesh=...)`,
where XLA inserts the gradient all-reduce, and this one, where the step is
written per shard with `lax.pmean`/`lax.psum` over the named axis.  In the
port every step is written per shard with explicit collectives, so this is
the same update as `train.make_train_step(mesh=...)` (`_build_update`),
over the axis named ``axis``: each rank's loss is the mean over its rows,
one all-reduce after the backward makes the gradient and the loss their
means over the axis and sums ``correct`` and ``count``.  As in the JAX
package, a batch-norm model is refused: there the per-shard statistics
would not be the global batch's (here `make_train_step(mesh=...)` takes
the global moments)."""

from __future__ import annotations

from differential_equations_resnet_tpu_torch.train.train_step import (
    _build_update,
    _local,
    _set_lr,
)


def make_shard_map_train_step(
    model,
    optimizer,
    mesh,
    axis: str = "data",
    with_gradient_metrics: bool = True,
    donate: bool = True,
    accum_steps: int = 1,
):
    """``step(images, labels, lr) -> (metrics, grad_norms)`` over ``mesh``:
    every rank passes the same global batch, trains on its rows of it
    (split over ``axis``) and gets the same metrics, grad-norm row and
    parameters.  ``accum_steps=k``: each rank's rows in k contiguous
    microbatches, one reduction a step.  ``donate`` is accepted and means
    nothing here."""
    if getattr(model.config, "use_batch_norm", False):
        raise ValueError(
            "make_shard_map_train_step does not support BatchNorm models "
            "(per-shard batch statistics != global-batch statistics); use "
            "make_train_step(mesh=...) instead."
        )
    update = _build_update(model, optimizer, with_gradient_metrics, accum_steps, mesh, axis)

    def step(images, labels, lr):
        _set_lr(optimizer, lr)
        return update(*_local(mesh, images, labels, axis=axis))

    return step
