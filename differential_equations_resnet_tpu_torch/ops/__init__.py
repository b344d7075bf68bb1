"""Operators of the port: packed antisymmetric kernels, convolutions,
the ODE integrators, int8 convs and the hand-written kernels under
`ops.kernels`.  The JAX package's names here are imported on first use."""

from differential_equations_resnet_tpu_torch import lazy_names

_LAZY = {
    "Antisym3x3DenseParams": "antisymmetric",
    "Antisym3x3Params": "antisymmetric",
    "AntisymKxKParams": "antisymmetric",
    "cross_pair_indices": "antisymmetric",
    "dense_from_packed": "antisymmetric",
    "he_truncated_normal": "antisymmetric",
    "init_antisym_3x3": "antisymmetric",
    "init_antisym_3x3_dense": "antisymmetric",
    "init_antisym_kxk": "antisymmetric",
    "materialize_3x3": "antisymmetric",
    "materialize_3x3_from_dense": "antisymmetric",
    "materialize_3x3_stacked": "antisymmetric",
    "materialize_kxk": "antisymmetric",
    "num_cross_pairs": "antisymmetric",
    "num_diag_free": "antisymmetric",
    "pack_3x3": "antisymmetric",
    "packed_from_dense": "antisymmetric",
    "antisym_conv2d_3x3": "conv",
    "conv2d_same": "conv",
    "INTEGRATOR_STAGES": "integrators",
    "euler_step": "integrators",
    "get_integrator": "integrators",
    "integrate": "integrators",
    "midpoint_step": "integrators",
    "rk4_step": "integrators",
    "QuantizedConvParams": "quantize",
    "dynamic_int8_conv_same": "quantize",
    "quantize_activations_per_tensor": "quantize",
    "quantize_kernel_per_cout": "quantize",
}

__getattr__ = lazy_names(__name__, _LAZY)
