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

- `ops.antisymmetric`          <- `ops/antisymmetric.py` (packed 3x3, k x k
  and dense-lower layouts)
- `ops.conv`                   <- `ops/conv.py` (`conv2d_same`,
  `conv2d_valid`, `antisym_conv2d_3x3`, `euler_relu_step`, `conv_relu_field`)
- `ops.kernels.fused_integrator` <- `ops/pallas/fused_integrator.py` (forward
  kernel B1, backward kernel B2, their autograd Function)
- `ops.quantize`               <- `ops/quantize.py` (dynamic w8a8 int8 convs
  on `torch._int_mm`, the int8 training steps)
- `ops.s2d`                    <- `ops/s2d.py` (space-to-depth transforms)
- `models.blocks`              <- `models/blocks.py` (batch norm, pooling,
  `l2_kernel_penalty`)
- `models.single_block_resnet` <- `models/single_block_resnet.py`
- `models.bottleneck_resnet`   <- `models/bottleneck_resnet.py`
- `models.quantized`           <- `models/quantized.py` (int8 serving)
- `train.train_step`           <- `train/train_step.py` (Adam, loss, train and
  eval steps)
- `train.telemetry`            <- `train/telemetry.py` (gradient mean norms,
  `CsvLogger`)
- `train.metrics`, `train.schedules` <- `train/metrics.py`, `train/schedules.py`
- `parallel.mesh`, `parallel.shard_map_step`, `parallel.pipeline` <-
  `parallel/` (meshes of ranks on `torch.distributed`, the
  explicit-collective step, pipeline parallelism), with
  `parallel.collectives` (the autograd collectives) and
  `parallel.tensor_parallel` (the Megatron form of ``tp_mesh``)
- `utils.weight_utils`         <- the JAX <-> port parameter converter
- `utils.serving`              <- `utils/serving.py`
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

__all__ = ["constant_cache", "lazy_names", "ops", "resolve_device"]


def lazy_names(package: str, names: dict):
    """A module ``__getattr__`` for ``package`` that imports each name of
    ``names`` from its submodule (``names[name]``) on first use; a submodule
    named None is the name itself.  The port's package inits re-export the
    JAX package's names so, without importing every module at once."""

    def __getattr__(name):
        if name not in names:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        import importlib

        if names[name] is None:
            return importlib.import_module(f"{package}.{name}")
        return getattr(importlib.import_module(f"{package}.{names[name]}"), name)

    return __getattr__


__getattr__ = lazy_names(__name__, {"ops": None})  # the JAX package's top-level name


def constant_cache(fn):
    """``functools.lru_cache`` for a function that makes constant tensors
    once per (arguments, device), so that no host-to-device copy lands in a
    captured CUDA graph, except while `torch.export` (or `torch.compile`)
    traces: a traced call makes its tensor anew, as a constant of the graph,
    and caches nothing, since what it made is a fake tensor."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def constant(*args):
        return fn(*args) if torch.compiler.is_compiling() else cached(*args)

    constant.cache_clear = cached.cache_clear
    return constant


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
