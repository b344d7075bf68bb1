"""The system under test, as the runners build it: the port's configuration
and model from a configuration file, holding the weights drawn from the
seed (`perfbench.weights`).  The port draws its own weights when it builds
a model's tree; that tree serves for its structure and shapes only, and
every leaf is then the seed's, drawn on the device."""

from __future__ import annotations

import sys
import time
from typing import Dict, Tuple

import torch

from perfbench import weights as seeded


class MetricContext:
    """What a per-layer metric's reader gets: the trace, the configuration
    and traffic files, and the runner's counts of the traced window
    (``info``: ``kind``, ``batch``, ``calls`` of the step or request)."""

    def __init__(self, trace, config: dict, traffic: dict, info: dict):
        self.trace, self.config, self.traffic, self.info = trace, config, traffic, info


def port_config(config: dict):
    from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

    return config_from_json(config["model"], config["family"])


def _tree(config: dict, port_cfg):
    """The port's parameter tree of ``port_cfg``, for its structure and
    shapes: the port's own init, on the CPU, from a throwaway generator
    (the port builds no model without drawing its weights)."""
    from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import init_resnet
    from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
        init_single_block_resnet,
    )

    if config["family"] == "bottleneck":
        return init_resnet(port_cfg, torch.Generator().manual_seed(0))[0]
    return init_single_block_resnet(port_cfg, torch.Generator().manual_seed(0))


def dense_lower(config: dict):
    """Which leaves hold a dense-lower antisymmetric ``cross``."""
    return lambda name: config["family"] == "bottleneck" and name.endswith("conv2__cross")


def build(config: dict, seed: int, device) -> Tuple[torch.nn.Module, Dict[str, Tuple[int, ...]]]:
    """(the port's model holding the seed's weights on ``device``, the
    leaves' shapes by name)."""
    from differential_equations_resnet_tpu_torch.models import BottleneckResNet, SingleBlockResNet

    port_cfg = port_config(config)
    tree = _tree(config, port_cfg)
    shapes = {name: tuple(leaf.shape) for name, leaf in seeded.leaves(tree)}
    drawn = seeded.make_weights(shapes, seed, device, dense_lower(config))
    params = seeded.rebuild(tree, lambda name, _: drawn[name])
    cls = BottleneckResNet if config["family"] == "bottleneck" else SingleBlockResNet
    model = cls(port_cfg, params=params, device=device)
    return model, shapes


def initial_weights(config: dict, shapes, seed: int, device):
    """The seed's weights again, for the reference and the checks."""
    return seeded.make_weights(shapes, seed, device, dense_lower(config))


def stamp(label: str, start: float) -> None:
    """A set-up phase's end, in seconds from the process's start, on
    standard error."""
    print(f"setup {label}: {time.perf_counter() - start:.3f} s", file=sys.stderr, flush=True)


def device_kind(device) -> str:
    return torch.cuda.get_device_name(0) if str(device).startswith("cuda") else "cpu"


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if str(device).startswith("cuda") else 0

