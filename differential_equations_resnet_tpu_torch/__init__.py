"""PyTorch/CUDA port of `differential_equations_resnet_tpu`, for NVIDIA Hopper.

The JAX package is the reference this package is held against; this package
imports neither `jax` nor any module of the JAX package, and keeps its own
copy of whatever it needs from there.

Layouts.  Public functions keep the JAX package's layouts so that the two can
be compared like with like: activations are NHWC, conv kernels are HWIO
(kh, kw, c_in, c_out), and parameters are the same NamedTuples (here holding
torch tensors) with stacked ``(L, ...)`` leaves for a run of identity blocks.
Internally `ops.conv` hands PyTorch's convolution NCHW/OIHW views, and the
fused integrator kernel reads the HWIO stack as (L, 9C, C).  The one place the
two packages' parameter trees meet is `utils.weight_utils.params_from_jax` /
`params_to_jax`.

Devices.  Entry points run on CUDA unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU device they raise rather
than quietly run on the CPU (`resolve_device`).  On CPU tensors every
hand-written kernel's wrapper runs its plain PyTorch version; on CUDA tensors
it launches the kernel or raises.  fp32 convolutions run with TF32 off,
their backward included, so fp32 means fp32 on the card as it does in the
reference.

Module map (each module names its JAX counterpart):

- `ops.antisymmetric`          <- `ops/antisymmetric.py` (packed 3x3 layout)
- `ops.conv`                   <- `ops/conv.py` (`conv2d_same`,
  `euler_relu_step`, `conv_relu_field`)
- `ops.kernels.fused_integrator` <- `ops/pallas/fused_integrator.py` (forward
  kernel B1, backward kernel B2, their autograd Function)
- `models.blocks`              <- `models/blocks.py` (with `l2_kernel_penalty`)
- `models.single_block_resnet` <- `models/single_block_resnet.py`
- `train.train_step`           <- `train/train_step.py` (Adam, loss, train and
  eval steps)
- `train.telemetry`            <- `train/telemetry.py` (gradient mean norms,
  `CsvLogger`)
- `train.metrics`, `train.schedules` <- `train/metrics.py`, `train/schedules.py`
- `utils.weight_utils`         <- the JAX <-> port parameter converter
- `utils.serving`              <- `utils/serving.py`
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises `RuntimeError` when CUDA is asked for, by name or by
    default, and no CUDA device is present."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass device='cpu' to run the plain "
            "PyTorch path on the CPU."
        )
    return resolved
