"""Training of the port: the train and eval steps and their K-step,
device-resident and CUDA-graph loops, the `Training` harness, checkpoints,
streaming metrics, per-layer gradient-norm telemetry with its CSV and
summary writers, the telemetry CSV analysis and learning-rate schedules
(the JAX package's `train/`; every builder and `Training` take a device
mesh, `parallel/`)."""

from differential_equations_resnet_tpu_torch.train.checkpoint import Checkpointer
from differential_equations_resnet_tpu_torch.train.history import TrainingHistory, plot_lines
from differential_equations_resnet_tpu_torch.train.metrics import StreamingMetrics
from differential_equations_resnet_tpu_torch.train.schedules import (
    constant_schedule,
    exponential_decay_schedule,
    linear_warmup_schedule,
    piecewise_constant_schedule,
)
from differential_equations_resnet_tpu_torch.train.telemetry import (
    CsvLogger,
    SummaryWriter,
    add_mean_norm_summary,
    add_moments_summary,
    gradient_mean_norms,
    gradient_metric_names,
)
from differential_equations_resnet_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    init_adam_state,
    make_adam,
    make_device_epoch,
    make_device_eval,
    make_eval_step,
    make_multi_eval_step,
    make_multi_step,
    make_predict_step,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.train.training import Training

__all__ = [
    "Checkpointer",
    "CsvLogger",
    "StreamingMetrics",
    "SummaryWriter",
    "TrainState",
    "Training",
    "TrainingHistory",
    "add_mean_norm_summary",
    "add_moments_summary",
    "constant_schedule",
    "create_train_state",
    "exponential_decay_schedule",
    "gradient_mean_norms",
    "gradient_metric_names",
    "init_adam_state",
    "linear_warmup_schedule",
    "make_adam",
    "make_device_epoch",
    "make_device_eval",
    "make_eval_step",
    "make_multi_eval_step",
    "make_multi_step",
    "make_predict_step",
    "make_train_step",
    "piecewise_constant_schedule",
    "plot_lines",
]
