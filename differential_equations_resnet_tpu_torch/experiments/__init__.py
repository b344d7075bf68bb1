"""The port's experiments: the conv-matrix spectrum, the forward
stability report and the gamma sweep of the deep-stability study, and the
width x depth train-throughput sweep (the JAX package's `experiments/`,
the sweep over a device mesh included)."""

from differential_equations_resnet_tpu_torch.experiments.deep_stability import (  # noqa: F401
    conv_matrix_spectrum,
    forward_stability_report,
    gamma_sweep,
)
from differential_equations_resnet_tpu_torch.experiments.sweeps import (  # noqa: F401
    imagenet32_config,
    measure_train_throughput,
    width_depth_sweep,
)
