"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and are built at first use (`_build`).
The JAX package's `ops.pallas` names are imported on first use."""

from differential_equations_resnet_tpu_torch import lazy_names

_LAZY = {
    "fused_euler_3x3": "fused_integrator",
    "fused_euler_eligible": "fused_integrator",
}

__getattr__ = lazy_names(__name__, _LAZY)
