"""Model families of the port (the single-block ODE-ResNet, for inference)."""

from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNet,
    SingleBlockResNetConfig,
    build_single_block_resnet,
    cifar10_single_block_config,
)

__all__ = [
    "SingleBlockResNet",
    "SingleBlockResNetConfig",
    "build_single_block_resnet",
    "cifar10_single_block_config",
]
