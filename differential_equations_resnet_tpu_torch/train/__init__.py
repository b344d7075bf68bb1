"""Training of the port: the train and eval steps, streaming metrics,
per-layer gradient-norm telemetry with its CSV logger, and learning-rate
schedules (the JAX package's `train/` up to its harness, which is ROADMAP
A7)."""

from differential_equations_resnet_tpu_torch.train.metrics import StreamingMetrics
from differential_equations_resnet_tpu_torch.train.schedules import (
    constant_schedule,
    exponential_decay_schedule,
    linear_warmup_schedule,
    piecewise_constant_schedule,
)
from differential_equations_resnet_tpu_torch.train.telemetry import (
    CsvLogger,
    gradient_mean_norms,
    gradient_metric_names,
)
from differential_equations_resnet_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    make_adam,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "CsvLogger",
    "StreamingMetrics",
    "TrainState",
    "constant_schedule",
    "create_train_state",
    "exponential_decay_schedule",
    "gradient_mean_norms",
    "gradient_metric_names",
    "linear_warmup_schedule",
    "make_adam",
    "make_eval_step",
    "make_train_step",
    "piecewise_constant_schedule",
]
