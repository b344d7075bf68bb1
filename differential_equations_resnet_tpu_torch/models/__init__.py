"""Model families of the port: the single-block ODE-ResNet and the bottleneck
ResNet-50/101/152, and their int8 serving forward."""

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
