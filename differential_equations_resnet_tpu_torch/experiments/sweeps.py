"""Width x depth train-throughput sweeps.

Port of `differential_equations_resnet_tpu/experiments/sweeps.py`.  Each cell builds
a single-block ODE-ResNet at (width, depth) on the ImageNet-32 workload and
measures sustained train steps a second on synthetic data, every step a
replay of one captured CUDA graph (`train.make_multi_step`), with model
TFLOP/s and MFU against the card's peak for the dtype the cell computes in
(`utils.flops.peak_of`: ``mfu_vs_bf16_peak`` or ``mfu_vs_fp32_peak``).
`imagenet32_config` and `width_depth_sweep` compute in bf16 by default, as
the JAX package's do; a bf16 cell runs every layer on cuDNN, as the JAX
package runs it on XLA (its kernel gate takes fp32 only).  An fp32 cell's
identity stack runs on B1/B2 or layer by layer as
`models.single_block_resnet.identity_route` says.

``mesh`` (`parallel.create_mesh`) runs every cell's steps over the mesh
(`make_multi_step(mesh=...)`, each rank its rows of the global batch) on
its device type; ``model_tflops`` is then the whole mesh's rate and the
MFU is per device, divided over ``mesh.size()``, as in the JAX package.

Left behind, because it was measured on a TPU: the JAX package's no-remat
capacity rule (``remat=None`` is off here).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models import (
    SingleBlockResNetConfig,
    build_single_block_resnet,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import compute_dtype_of
from differential_equations_resnet_tpu_torch.parallel.mesh import shard_params
from differential_equations_resnet_tpu_torch.train.train_step import make_adam, make_multi_step
from differential_equations_resnet_tpu_torch.utils.flops import (
    mfu,
    peak_of,
    single_block_train_flops,
)


def imagenet32_config(
    num_layers: int = 28,
    num_filters: int = 64,
    final_time: float = 8.0,
    kernel_type: str = "antisymmetric",
    compute_dtype=torch.bfloat16,
    **overrides,
) -> SingleBlockResNetConfig:
    """ImageNet-32-scale workload: 32x32 inputs, 1000 classes, a wider
    trunk, bf16 compute."""
    return SingleBlockResNetConfig(
        image_shape=(32, 32, 3),
        kernel_type=kernel_type,
        kernel_size=3,
        h=final_time / num_layers,
        num_stages=2,
        blocks_per_stage=(num_layers,),
        filters_per_block=(num_filters,),
        strides=((1, 1),),
        num_classes=1000,
        subtract_mean=127.5,
        divide_by_stddev=127.5,
        compute_dtype=compute_dtype,
        **overrides,
    )


def measure_train_throughput(
    config: SingleBlockResNetConfig,
    batch_size: int,
    mesh=None,
    steps: int = 50,
    warmup: int = 5,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """Sustained train-step throughput of one configuration: ``warmup``
    steps (the capture among them), then ``steps`` steps on one batch,
    timed on the host clock up to a read of the last step's loss.  MFU is
    against the peak of the config's compute dtype (``mfu_vs_bf16_peak`` or
    ``mfu_vs_fp32_peak``), per device of ``mesh``.  ``device`` defaults to
    the mesh's device type."""
    device = resolve_device(device if device is not None or mesh is None else mesh.device_type)
    model = build_single_block_resnet(
        config, generator=torch.Generator().manual_seed(seed), device=device)
    if mesh is not None:
        shard_params(mesh, model)
    multi = make_multi_step(model, make_adam(model.parameters()), mesh=mesh)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.uniform(0, 255, (batch_size,) + tuple(config.image_shape)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, config.num_classes, (batch_size,))).to(device)

    def run(n):
        metrics, _ = multi(x.expand(n, *x.shape), y.expand(n, *y.shape), [1e-3] * n)
        return float(metrics["loss"][-1])  # waits for the last step

    run(warmup)
    start = time.perf_counter()
    run(steps)
    elapsed = time.perf_counter() - start
    steps_per_sec = steps / elapsed
    flops_step = single_block_train_flops(config, batch_size)
    peak_name, peak = peak_of(compute_dtype_of(config))
    devices = mesh.size() if mesh is not None else 1
    return {
        "steps_per_sec": steps_per_sec,
        "images_per_sec": steps_per_sec * batch_size,
        "step_ms": 1e3 * elapsed / steps,
        "model_tflops": flops_step * steps_per_sec / 1e12,
        f"mfu_vs_{peak_name}_peak": mfu(flops_step, steps_per_sec, peak) / devices,
    }


def width_depth_sweep(
    widths: Sequence[int] = (16, 32, 64),
    depths: Sequence[int] = (16, 32, 64),
    batch_size: int = 128,
    mesh=None,
    num_classes: int = 1000,
    compute_dtype=torch.bfloat16,
    steps: int = 30,
    kernel_type: str = "antisymmetric",
    remat: Optional[bool] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[Tuple[int, int], Dict[str, float]]:
    """`measure_train_throughput` at every (width, depth) grid point.
    ``remat=None`` means off.  ``mesh``: see `measure_train_throughput`."""
    results: Dict[Tuple[int, int], Dict[str, float]] = {}
    for width in widths:
        for depth in depths:
            config = imagenet32_config(num_layers=depth, num_filters=width,
                                       kernel_type=kernel_type, compute_dtype=compute_dtype,
                                       remat=bool(remat))
            if num_classes != 1000:
                config = dataclasses.replace(config, num_classes=num_classes)
            results[(width, depth)] = measure_train_throughput(
                config, batch_size, mesh=mesh, steps=steps, device=device)
    return results
