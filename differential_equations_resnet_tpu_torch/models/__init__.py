"""Model families of the port: the single-block ODE-ResNet and the bottleneck
ResNet-50/101/152, and their int8 serving forward.  The JAX package's other
names here (the layer parameters and batch norm of `models.blocks`, the
single-block factory) are imported on first use."""

from differential_equations_resnet_tpu_torch import lazy_names
from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import (
    BottleneckResNet,
    BottleneckResNetConfig,
    build_resnet,
    get_resnet_build_function,
    resnet_preset,
)
from differential_equations_resnet_tpu_torch.models.quantized import (
    apply_quantized,
    apply_resnet_quantized,
    apply_single_block_resnet_quantized,
    make_quantized_forward,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNet,
    SingleBlockResNetConfig,
    build_single_block_resnet,
    cifar10_single_block_config,
)

__all__ = [
    "BottleneckResNet",
    "BottleneckResNetConfig",
    "SingleBlockResNet",
    "SingleBlockResNetConfig",
    "apply_quantized",
    "apply_resnet_quantized",
    "apply_single_block_resnet_quantized",
    "build_resnet",
    "build_single_block_resnet",
    "cifar10_single_block_config",
    "get_resnet_build_function",
    "make_quantized_forward",
    "resnet_preset",
]

_LAZY = {
    "BatchNormParams": "blocks",
    "BatchNormState": "blocks",
    "ConvParams": "blocks",
    "DenseParams": "blocks",
    "batch_norm": "blocks",
    "init_batch_norm": "blocks",
    "init_conv": "blocks",
    "init_dense": "blocks",
    "get_single_block_resnet_build_function": "single_block_resnet",
}

__getattr__ = lazy_names(__name__, _LAZY)
