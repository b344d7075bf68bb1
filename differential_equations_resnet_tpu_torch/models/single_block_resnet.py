"""Single-block ODE-ResNets, in PyTorch.

Port of `differential_equations_resnet_tpu/models/single_block_resnet.py`
(config, stage plans, init and the forward pass).  A residual block is one
forward-Euler step of dY/dt = relu(K(t) Y + b), and a stage's run of
identity blocks is the fused L-layer integrator `fused_euler_3x3`: the
hand-written CUDA kernels on the card (B1 forward, B2 backward), their plain
PyTorch versions on the CPU.  Gradients flow through every leaf, so the
model trains (`train.train_step`); with no batch norm, train mode and eval
mode compute the same forward.

What the port covers so far: Euler, antisymmetric 3x3 kernels, no batch
norm, fp32.  The config accepts every key of the JAX package's
``config.json``; features outside it raise `NotImplementedError` naming the
ROADMAP item they wait on when the model is built.  Accepted and ignored,
because they do not change the numbers of a forward or backward pass:

- ``use_pallas``: on the card the fused kernel is always the path;
- ``s2d_block``, ``s2d_force``, ``s2d_max_rows``: space-to-depth is an exact
  layout transform whose gate stays off on CUDA until it is measured there;
- ``remat``, ``scan_unroll``, ``data_axis_size``, ``device_platform``,
  ``pp_axis``, ``pp_microbatches``, ``pp_batch_axis``, ``tp_axis``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models.blocks import (
    ConvParams,
    apply_fc_activation,
    dense,
    global_average_pool,
    init_conv,
    init_dense,
    max_pool_2x2,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    init_antisym_3x3,
)
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same
from differential_equations_resnet_tpu_torch.ops.kernels.fused_integrator import (
    fused_euler_3x3,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """"float32" for torch.float32 or "float32"."""
    return dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class SingleBlockResNetConfig:
    """The keyword surface of the JAX package's `SingleBlockResNetConfig`,
    field for field, with the same validation."""

    image_shape: Tuple[int, int, int] = (32, 32, 3)
    kernel_type: str = "antisymmetric"
    kernel_size: int = 3
    h: float = 1.0
    gamma: float = 0.0
    num_stages: int = 5
    blocks_per_stage: Tuple[int, ...] = (3, 4, 6, 3)
    filters_per_block: Tuple[int, ...] = (64, 128, 256, 512)
    strides: Tuple[Tuple[int, int], ...] = ((2, 2), (2, 2), (2, 2), (2, 2))
    include_top: bool = True
    fc_activation: Optional[str] = "softmax"
    num_classes: Optional[int] = None
    use_batch_norm: bool = False
    use_max_pooling: Tuple[bool, ...] = (False, False, False, False)
    l2_regularization: float = 0.0
    subtract_mean: Optional[Any] = None
    divide_by_stddev: Optional[Any] = None
    integrator: str = "euler"
    remat: bool = False
    compute_dtype: Any = torch.float32
    use_pallas: bool = False
    scan_unroll: int = 1
    s2d_block: int = 0
    s2d_force: bool = False
    s2d_max_rows: Optional[int] = None
    data_axis_size: int = 1
    device_platform: Optional[str] = None
    pp_mesh: Any = None
    pp_axis: str = "pipe"
    pp_microbatches: int = 0
    pp_batch_axis: Any = None
    int8_forward: bool = False
    int8_backward: str = "ste"
    tp_mesh: Any = None
    tp_axis: str = "model"

    def __post_init__(self):
        if self.include_top and self.num_classes is None:
            raise ValueError(
                "You must pass a positive integer for `num_classes` if "
                "`include_top` is `True`."
            )
        if self.kernel_type not in ("antisymmetric", "regular", "centrosymmetric"):
            raise ValueError(f"Unknown kernel_type {self.kernel_type!r}.")
        if self.integrator != "euler" and self.use_batch_norm:
            raise ValueError(
                "midpoint/rk4 integrators require use_batch_norm=False (the "
                "block must be a pure ODE field)."
            )
        if self.int8_backward not in ("ste", "dgrad", "wgrad", "full"):
            raise ValueError(
                f"int8_backward must be 'ste', 'dgrad', 'wgrad', or 'full', "
                f"got {self.int8_backward!r}."
            )
        if self.int8_backward != "ste" and not self.int8_forward:
            raise ValueError(
                "int8_backward='dgrad'/'wgrad'/'full' requires int8_forward=True."
            )
        if self.kernel_type == "antisymmetric" and self.kernel_size != 3:
            raise ValueError("The antisymmetric kernel path is specialized to 3x3.")

    @property
    def name(self) -> str:
        return f"single_block_resnet_{self.kernel_type}"


def cifar10_single_block_config(
    num_layers: int = 64,
    final_time: float = 8.0,
    num_filters: int = 16,
    kernel_type: str = "antisymmetric",
    gamma: float = 0.0,
    **overrides,
) -> SingleBlockResNetConfig:
    """The headline CIFAR-10 configuration: 64 layers, h = final_time /
    num_layers, 16 filters, input scaled by 127.5.  Unlike the JAX package it
    does not default to ``s2d_block=2``: that default was chosen on a TPU."""
    defaults = dict(kernel_size=3)
    defaults.update(overrides)
    return SingleBlockResNetConfig(
        image_shape=(32, 32, 3),
        kernel_type=kernel_type,
        h=final_time / num_layers,
        gamma=gamma,
        num_stages=2,
        blocks_per_stage=(num_layers,),
        filters_per_block=(num_filters,),
        strides=((1, 1),),
        include_top=True,
        fc_activation="softmax",
        num_classes=10,
        use_batch_norm=False,
        use_max_pooling=(False, False, False, False),
        subtract_mean=127.5,
        divide_by_stddev=127.5,
        **defaults,
    )


def unsupported_reason(config: SingleBlockResNetConfig) -> str:
    """What of ``config`` this slice does not run, with the ROADMAP item it
    waits on, or "" where the whole config is covered."""
    if config.use_batch_norm:
        return "use_batch_norm=True (batch norm, ROADMAP A10)"
    if config.integrator != "euler":
        return f"integrator={config.integrator!r} (midpoint and RK4, ROADMAP A4 and A10)"
    if config.kernel_type != "antisymmetric":
        return (f"kernel_type={config.kernel_type!r} (regular and centrosymmetric "
                "kernels, ROADMAP A2 and A5)")
    if config.int8_forward:
        return "int8_forward=True (int8 convolutions, ROADMAP A13)"
    if config.pp_mesh is not None or config.tp_mesh is not None:
        return "pp_mesh/tp_mesh (pipeline and tensor parallelism, ROADMAP A15)"
    if dtype_name(config.compute_dtype) != "float32":
        return (f"compute_dtype={dtype_name(config.compute_dtype)} "
                "(reduced-precision compute, ROADMAP A5)")
    return ""


@dataclasses.dataclass(frozen=True)
class _StagePlan:
    pool: bool
    has_conv_block: bool
    num_identity: int
    filters: int
    strides: Tuple[int, int]
    in_channels: int


def stage_plans(config: SingleBlockResNetConfig) -> Tuple[_StagePlan, ...]:
    """Static per-stage structure: which stages open with a strided or
    widening conv block, and how many identity blocks follow."""
    plans = []
    channels = config.filters_per_block[0]
    for s in range(config.num_stages - 1):
        pool = bool(config.use_max_pooling[s])
        filters = config.filters_per_block[s]
        strides = tuple(config.strides[s])
        identity_only = ((s == 0) and not pool) or (
            not pool
            and config.filters_per_block[s] == config.filters_per_block[s - 1]
            and strides == (1, 1)
        )
        if identity_only:
            plans.append(
                _StagePlan(pool, False, config.blocks_per_stage[s], channels, strides, channels)
            )
        else:
            plans.append(
                _StagePlan(
                    pool, True, config.blocks_per_stage[s] - 1, filters, strides, channels
                )
            )
            channels = filters
    return tuple(plans)


def _stack(params):
    return type(params[0])(*[torch.stack(leaves) for leaves in zip(*params)])


def init_single_block_resnet(
    config: SingleBlockResNetConfig, generator: torch.Generator
) -> dict:
    """The parameter tree, drawn on the CPU from ``generator``: ``{"stem":
    ConvParams, "stages": [{"conv_main", "conv_shortcut" (conv-block stages
    only), "blocks": stacked Antisym3x3Params or None}], "head":
    DenseParams}``."""
    ks = (config.kernel_size, config.kernel_size)
    params = {"stem": init_conv(generator, ks, config.image_shape[-1], config.filters_per_block[0])}
    stages = []
    for plan in stage_plans(config):
        sp = {}
        if plan.has_conv_block:
            sp["conv_main"] = init_conv(generator, ks, plan.in_channels, plan.filters)
            sp["conv_shortcut"] = init_conv(generator, (1, 1), plan.in_channels, plan.filters)
        sp["blocks"] = (
            _stack([init_antisym_3x3(generator, plan.filters) for _ in range(plan.num_identity)])
            if plan.num_identity else None
        )
        stages.append(sp)
    params["stages"] = stages
    if config.include_top:
        plans = stage_plans(config)
        final = plans[-1].filters if plans else config.filters_per_block[0]
        params["head"] = init_dense(generator, final, config.num_classes)
    return params


def _apply_conv_block(x: torch.Tensor, sp: dict, strides) -> torch.Tensor:
    """main = relu(conv_kxk(x, stride)); shortcut = conv_1x1(x, stride)."""
    main = conv2d_same(x, sp["conv_main"].kernel, strides=strides, bias=sp["conv_main"].bias)
    shortcut = conv2d_same(
        x, sp["conv_shortcut"].kernel, strides=strides, bias=sp["conv_shortcut"].bias
    )
    return torch.relu(main) + shortcut


def apply_single_block_resnet(
    params: dict,
    x: torch.Tensor,
    config: SingleBlockResNetConfig,
    return_logits: bool = False,
) -> torch.Tensor:
    """Forward pass on NHWC images.  ``return_logits=True`` skips the final
    fc_activation (softmax)."""
    x = x.to(torch.float32)
    if config.subtract_mean is not None:
        x = x - torch.as_tensor(config.subtract_mean, dtype=x.dtype, device=x.device)
    if config.divide_by_stddev is not None:
        x = x / torch.as_tensor(config.divide_by_stddev, dtype=x.dtype, device=x.device)
    stem = params["stem"]
    x = torch.relu(conv2d_same(x, stem.kernel, strides=tuple(config.strides[0]), bias=stem.bias))
    for plan, sp in zip(stage_plans(config), params["stages"]):
        if plan.pool:
            x = max_pool_2x2(x)
        if plan.has_conv_block:
            x = _apply_conv_block(x, sp, plan.strides)
        if sp["blocks"] is not None:
            # On CUDA a state a kernel declines raises NotImplementedError.
            x = fused_euler_3x3(x, sp["blocks"], config.h, config.gamma)
    if config.include_top:
        x = dense(global_average_pool(x), params["head"])
        if not return_logits:
            x = apply_fc_activation(x, config.fc_activation)
    return x


def _named_leaves(tree, prefix=""):
    """(name, tensor) for every tensor of a parameter tree, names joined by
    "__" (state_dict keys), None leaves skipped."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field, value in zip(tree._fields, tree):
            yield from _named_leaves(value, f"{prefix}__{field}" if prefix else field)
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _named_leaves(value, f"{prefix}__{key}" if prefix else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _named_leaves(value, f"{prefix}__{i}" if prefix else str(i))


def map_leaves(fn, tree):
    """The parameter tree with ``fn`` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_leaves(fn, v) for v in tree])
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return tree


class SingleBlockResNet(nn.Module):
    """The model as an `nn.Module`: its parameter tree (the JAX package's
    layout) is registered leaf by leaf as `nn.Parameter`s, so ``state_dict``
    keys are the tree paths joined by "__" (``stem__kernel``,
    ``stages__0__blocks__cross``, ...).

    Give either ``params`` (a parameter tree, e.g. from
    `utils.weight_utils.params_from_jax`) or a ``generator`` to draw them.
    ``device`` defaults to CUDA (see `resolve_device`)."""

    def __init__(
        self,
        config: SingleBlockResNetConfig,
        params: Optional[dict] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        reason = unsupported_reason(config)
        if reason:
            raise NotImplementedError(f"The PyTorch port does not run {reason} yet.")
        if (params is None) == (generator is None):
            raise TypeError("Pass exactly one of `params` and `generator`.")
        self.config = config
        device = resolve_device(device)
        if params is None:
            params = init_single_block_resnet(config, generator)
        self.tree = map_leaves(
            lambda t: nn.Parameter(t.detach().to(device, torch.float32)), params
        )
        for name, leaf in _named_leaves(self.tree):
            self.register_parameter(name, leaf)

    def params(self) -> dict:
        """The parameter tree; its leaves are this module's parameters."""
        return self.tree

    def forward(self, x: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        return apply_single_block_resnet(self.tree, x, self.config, return_logits)


def build_single_block_resnet(
    config: Optional[SingleBlockResNetConfig] = None,
    *,
    params: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> SingleBlockResNet:
    """Constructor with the reference's keyword surface: either a
    `SingleBlockResNetConfig` or its fields as keywords, e.g.::

        build_single_block_resnet(image_shape=(32, 32, 3), num_stages=2,
                                  blocks_per_stage=[64], filters_per_block=[16],
                                  strides=[(1, 1)], num_classes=10, h=0.125,
                                  generator=torch.Generator().manual_seed(0))
    """
    if config is None:
        for key in ("blocks_per_stage", "filters_per_block", "use_max_pooling", "image_shape"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        if "strides" in kwargs:
            kwargs["strides"] = tuple(tuple(s) for s in kwargs["strides"])
        kwargs.pop("verbose", None)
        config = SingleBlockResNetConfig(**kwargs)
    elif kwargs:
        raise TypeError("Pass either a config object or keyword arguments, not both.")
    return SingleBlockResNet(config, params, generator=generator, device=device)
