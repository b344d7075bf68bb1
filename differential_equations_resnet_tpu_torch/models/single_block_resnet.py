"""Single-block ODE-ResNets, in PyTorch.

Port of `differential_equations_resnet_tpu/models/single_block_resnet.py`
(config, stage plans, init and the forward pass).  A residual block is one
step of dY/dt = relu(K(t) Y + b): forward Euler, explicit midpoint or RK4,
or, with ``use_batch_norm``, the Euler step conv -> batch norm -> relu.
Every kernel type runs: antisymmetric (packed 3x3), regular (dense k x k)
and centrosymmetric (packed k x k, trainable centre).  A stage's identity
stack is first made dense, (L, k, k, C, C) kernels for all layers at once
(`_dense_blocks`), then takes one of two routes, chosen from the dense
stack's shapes and the config before anything is launched
(`identity_route`):

- the fused route: an fp32 Euler stack of 3x3 kernels without batch norm
  or ``int8_forward``, any kernel type, within the JAX kernel gate's reach
  (C <= 128, H*W <= 4096) runs as the fused L-layer integrator
  `fused_euler_dense`: the hand-written kernels B1 (forward) and B2
  (backward) on the card, each in the variant its shape takes
  (`ops.kernels.fused_integrator.kernel_variant`), their plain PyTorch
  versions on the CPU;
- the per-layer route, everything else: int8, midpoint, RK4, k != 3, batch
  norm, bf16 or fp16 compute (the JAX gate takes fp32 only), and Euler 3x3
  stacks past the reach, run layer by layer on cuDNN with TF32 off,
  each layer checkpointed where ``remat`` is set.  A stack without batch
  norm runs there in one of three forms (`per_layer_form`), in this order:
  "int8" with ``int8_forward`` (`ops.quantize.euler_relu_step_int8`, or the
  integrator over `conv_relu_field_int8`, per-tensor weight scales, the
  backward as ``int8_backward`` says), "s2d" where `_s2d_eligible` packs
  it (`ops.s2d`: an exact relayout into (H/b, W/b, b*b*C), 3x3 only), else
  "direct" (`euler_relu_step`, or the integrator over `conv_relu_field`);
  with batch norm it is conv, batch norm and relu.

Over a device mesh (ROADMAP A15, `parallel/`) two more routes come first:
with ``pp_mesh`` the Euler stack is pipelined over depth
(`parallel.pipeline.pipeline_blocks_apply`, each stage's layers on one
rank of the mesh's ``pp_axis``), and with ``tp_mesh`` every stack the JAX
package would not run on its Pallas kernel runs layer by layer in Megatron
form over the mesh's ``tp_axis`` (`parallel.tensor_parallel`: each rank
convolves the full activations into its slice of the output channels, the
slices are all-gathered): the Euler, int8, s2d, midpoint and RK4 forms and
batch norm alike.  Where the JAX package runs Pallas, each rank runs B1/B2
on full channels, as JAX runs its kernel on the replicated stack.

`route_counts` counts the stacks each route ran, `per_layer_counts` the
per-layer stacks by form, and `mesh_route_counts` the stacks run
"tensor_parallel" or "pipeline" (Python calls: a replayed CUDA graph adds
none).  A per-layer stack without batch norm on one rank also reports
itself to the record of hand-kernel calls (`utils.tracing.STACKS`), as
kernel "per_layer" in its form with no launch, beside the fused stacks'
B1 and B2 calls.  Gradients flow through every leaf, so the model
trains (`train.train_step`).  The forward takes ``train`` as the JAX
``apply`` does: with batch norm, train mode normalizes by the batch's
statistics and updates the running ones (the model's buffers), eval mode
uses the running ones; without it the two compute the same forward.

``compute_dtype`` (fp32, bf16 or fp16) is the JAX package's: the input is
cast to it at entry, every convolution, batch norm and dense layer computes
in its input's dtype (kernels and biases cast to it), the head runs on an
fp32 input and the loss's log-softmax in fp32 (`train.train_step`); the
parameters, Adam's slots, checkpoints and the gradient telemetry stay fp32.

The config accepts every key of the JAX package's ``config.json``, with
the JAX package's validation (``int8_forward`` excludes batch norm,
``use_pallas`` and ``pp_mesh``; ``pp_mesh`` takes the plain Euler stack;
tp x pp takes one mesh).  Accepted and ignored, because they do not
change the numbers of a forward or backward pass:

- ``remat`` on the fused route, which keeps only the stack's input anyway,
  and on the pipelined one, whose stages are always rematerialized;
- ``scan_unroll``, ``data_axis_size``, ``device_platform`` (the step
  builders bind the last two from the mesh, `with_mesh_context`; the
  forward sees each rank's own rows, so the s2d gate counts per-device rows
  without them);
- ``pp_batch_axis``: under a data mesh the step has already given each
  rank its rows, so the pipeline takes them as they are.

The space-to-depth gate keeps the JAX rule except its default row count
(`_s2d_eligible`): ``s2d_force`` packs on any device, an explicit
``s2d_max_rows`` packs a stack of at most that many input rows on the card,
and with neither nothing is packed (the JAX default, 32768 rows, was
measured on a TPU).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import warnings
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from differential_equations_resnet_tpu_torch import constant_cache, resolve_device
from differential_equations_resnet_tpu_torch.models.blocks import (
    BatchNormState,
    ConvParams,
    apply_fc_activation,
    batch_norm,
    dense,
    global_average_pool,
    init_batch_norm,
    init_conv,
    init_dense,
    max_pool_2x2,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    AntisymKxKParams,
    init_antisym_3x3,
    init_antisym_kxk,
    materialize_3x3_stacked,
    materialize_kxk,
)
from differential_equations_resnet_tpu_torch.ops.conv import (
    conv2d_same,
    conv_relu_field,
    euler_relu_step,
)
from differential_equations_resnet_tpu_torch.ops.integrators import (
    get_integrator,
    layer_slice,
    num_layers,
    run_layers,
)
from differential_equations_resnet_tpu_torch.ops.kernels.fused_integrator import (
    fused_euler_dense,
    fused_euler_eligible,
    in_reference_reach,
)
from differential_equations_resnet_tpu_torch.ops.quantize import (
    conv_relu_field_int8,
    euler_relu_step_int8,
)
from differential_equations_resnet_tpu_torch.ops.s2d import (
    depth_to_space,
    pack_bias_s2d,
    pack_kernel_s2d,
    space_to_depth,
)
from differential_equations_resnet_tpu_torch.parallel import tensor_parallel
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """"float32" for torch.float32 or "float32"."""
    return dtype if isinstance(dtype, str) else str(dtype).replace("torch.", "")


def compute_dtype_of(config) -> torch.dtype:
    """A config's ``compute_dtype`` (a torch dtype or its name) as a torch
    dtype."""
    return DTYPES[dtype_name(config.compute_dtype)]


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
        if self.pp_mesh is not None and (
            self.integrator != "euler" or self.use_batch_norm or self.use_pallas
        ):
            raise ValueError(
                "pp_mesh (pipeline parallelism) requires the plain Euler "
                "identity stack: integrator='euler', use_batch_norm=False, "
                "use_pallas=False."
            )
        if (
            self.pp_mesh is not None
            and self.tp_mesh is not None
            and self.tp_mesh is not self.pp_mesh
        ):
            raise ValueError(
                "Composing pipeline and tensor parallelism (tp x pp) "
                "requires ONE mesh carrying both axes: pass the same Mesh "
                "as pp_mesh and tp_mesh (with pp_axis and tp_axis naming "
                "its two axes)."
            )
        if self.int8_forward and (
            self.use_batch_norm or self.use_pallas or self.pp_mesh is not None
        ):
            raise ValueError(
                "int8_forward requires the plain integrator identity stack: "
                "use_batch_norm=False, use_pallas=False, pp_mesh=None."
            )
        if self.int8_backward not in ("ste", "dgrad", "wgrad", "full"):
            raise ValueError(
                f"int8_backward must be 'ste', 'dgrad', 'wgrad', or 'full', "
                f"got {self.int8_backward!r}."
            )
        if self.int8_backward != "ste" and not self.int8_forward:
            raise ValueError(
                "int8_backward='dgrad'/'wgrad'/'full' requires "
                "int8_forward=True (the backward quantizes against the "
                "forward's int8 kernel)."
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
    """What of ``config`` the port does not run, or "" where the whole
    config is covered."""
    return dtype_reason(config)


def dtype_reason(config) -> str:
    """Why ``config.compute_dtype`` is not one the port computes in, or ""."""
    name = dtype_name(config.compute_dtype)
    if name not in DTYPES:
        return f"compute_dtype={name} (the port computes in {', '.join(DTYPES)})"
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


def _init_identity_blocks(generator: torch.Generator, config: SingleBlockResNetConfig,
                          num_blocks: int, channels: int):
    """Stacked (L, ...) parameters of a run of identity blocks: packed 3x3
    antisymmetric, packed k x k centrosymmetric or dense k x k regular."""
    if num_blocks == 0:
        return None
    k = config.kernel_size
    if config.kernel_type == "antisymmetric":
        draw = lambda: init_antisym_3x3(generator, channels)
    elif config.kernel_type == "centrosymmetric":
        draw = lambda: init_antisym_kxk(generator, k, channels, antisymmetric=False)
    else:
        draw = lambda: init_conv(generator, (k, k), channels, channels)
    return stack_trees([draw() for _ in range(num_blocks)])


def _stacked_batch_norm(num_blocks: int, channels: int):
    """(BatchNormParams, BatchNormState) of ``num_blocks`` layers, (L, C)."""
    return tuple(type(t)(*[leaf.repeat(num_blocks, 1) for leaf in t])
                 for t in init_batch_norm(channels))


def init_single_block_resnet(
    config: SingleBlockResNetConfig, generator: torch.Generator
) -> dict:
    """The parameter tree, drawn on the CPU from ``generator``: ``{"stem":
    ConvParams, "stem_bn", "stages": [{"conv_main", "conv_shortcut",
    "bn_main", "bn_shortcut" (conv-block stages only), "blocks": stacked
    Antisym3x3Params, AntisymKxKParams or ConvParams, or None,
    "blocks_bn"}], "head": DenseParams}``, the batch-norm parameters (scale
    1, offset 0) only with ``use_batch_norm``.  `init_single_block_state`
    gives the running statistics."""
    ks = (config.kernel_size, config.kernel_size)
    bn = config.use_batch_norm
    params = {"stem": init_conv(generator, ks, config.image_shape[-1], config.filters_per_block[0])}
    if bn:
        params["stem_bn"] = init_batch_norm(config.filters_per_block[0])[0]
    stages = []
    for plan in stage_plans(config):
        sp = {}
        if plan.has_conv_block:
            sp["conv_main"] = init_conv(generator, ks, plan.in_channels, plan.filters)
            sp["conv_shortcut"] = init_conv(generator, (1, 1), plan.in_channels, plan.filters)
            if bn:
                sp["bn_main"] = init_batch_norm(plan.filters)[0]
                sp["bn_shortcut"] = init_batch_norm(plan.filters)[0]
        sp["blocks"] = _init_identity_blocks(generator, config, plan.num_identity, plan.filters)
        if bn and plan.num_identity:
            sp["blocks_bn"] = _stacked_batch_norm(plan.num_identity, plan.filters)[0]
        stages.append(sp)
    params["stages"] = stages
    if config.include_top:
        plans = stage_plans(config)
        final = plans[-1].filters if plans else config.filters_per_block[0]
        params["head"] = init_dense(generator, final, config.num_classes)
    return params


def init_single_block_state(config: SingleBlockResNetConfig) -> dict:
    """The state tree, the JAX package's ``model_state``: ``{"stem_bn",
    "stages": [{"bn_main", "bn_shortcut", "blocks_bn"}]}`` of
    `BatchNormState` running statistics (mean 0, variance 1) with
    ``use_batch_norm``, else ``{"stages": [{}, ...]}``."""
    bn = config.use_batch_norm
    state = {"stem_bn": init_batch_norm(config.filters_per_block[0])[1]} if bn else {}
    stages = []
    for plan in stage_plans(config):
        ss = {}
        if bn and plan.has_conv_block:
            ss["bn_main"] = init_batch_norm(plan.filters)[1]
            ss["bn_shortcut"] = init_batch_norm(plan.filters)[1]
        if bn and plan.num_identity:
            ss["blocks_bn"] = _stacked_batch_norm(plan.num_identity, plan.filters)[1]
        stages.append(ss)
    state["stages"] = stages
    return state


def _apply_conv_block(x: torch.Tensor, sp: dict, ss: dict, config: SingleBlockResNetConfig,
                      strides, train: bool):
    """main = relu(BN(conv_kxk(x, stride))); shortcut = BN(conv_1x1(x,
    stride)); out = main + shortcut (BN only with ``use_batch_norm``).
    Returns (out, the stage's new batch-norm state)."""
    main = conv2d_same(x, sp["conv_main"].kernel, strides=strides, bias=sp["conv_main"].bias)
    shortcut = conv2d_same(
        x, sp["conv_shortcut"].kernel, strides=strides, bias=sp["conv_shortcut"].bias
    )
    new_ss = {}
    if config.use_batch_norm:
        main, new_ss["bn_main"] = batch_norm(main, sp["bn_main"], ss["bn_main"], train)
        shortcut, new_ss["bn_shortcut"] = batch_norm(
            shortcut, sp["bn_shortcut"], ss["bn_shortcut"], train)
    return torch.relu(main) + shortcut, new_ss


def _input_constant(value, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A config's subtract_mean / divide_by_stddev (a scalar or per-channel
    values) as a tensor of ``dtype`` on ``device`` (JAX ``jnp.asarray(value,
    x.dtype)``), made once per (values, device, dtype): a host-to-device
    copy on every forward cannot be captured in a CUDA graph.  It stays a
    device tensor, not a Python scalar, because CUDA divides by a Python
    scalar as a multiplication by its reciprocal, which can move the last
    bit."""
    values = np.asarray(value, dtype=np.float32)
    return _device_constant(tuple(values.ravel().tolist()), values.shape, device, dtype)


@constant_cache
def _device_constant(values: Tuple[float, ...], shape, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):  # usable by autograd whoever asked first
        return torch.tensor(values, dtype=torch.float32).reshape(shape).to(device, dtype)


def _dense_blocks(blocks, config: SingleBlockResNetConfig) -> ConvParams:
    """Stacked block parameters -> stacked dense ``ConvParams`` ((L, k, k, C,
    C) kernels, (L, C) biases), every layer materialized at once and
    differentiably, so a dense-kernel gradient folds back onto packed
    leaves.  Centrosymmetric kernels keep their trainable centre: gamma is
    unused, as in the JAX package."""
    if isinstance(blocks, Antisym3x3Params):
        return ConvParams(materialize_3x3_stacked(blocks, config.gamma), blocks.bias)
    if isinstance(blocks, AntisymKxKParams):
        return ConvParams(materialize_kxk(blocks, config.kernel_size, antisymmetric=False),
                          blocks.bias)
    return blocks


# Identity stacks run by each route since the counts were last set to 0,
# and the per-layer ones by form (`per_layer_form`).
route_counts = {"fused": 0, "per_layer": 0}
per_layer_counts = {"int8": 0, "s2d": 0, "direct": 0}
mesh_route_counts = {"tensor_parallel": 0, "pipeline": 0}


def jax_runs_pallas(config: SingleBlockResNetConfig, x: torch.Tensor) -> bool:
    """Whether the JAX package would run this stage's identity stack on its
    Pallas kernel: ``use_pallas``, antisymmetric (packed, with a bias),
    Euler, no batch norm, and an fp32 4-D state within its gate's reach
    (JAX `_pallas_eligible` and `fused_euler_eligible`)."""
    return (config.use_pallas and config.kernel_type == "antisymmetric"
            and config.integrator == "euler" and not config.use_batch_norm
            and x.dim() == 4 and x.dtype == torch.float32 and in_reference_reach(x.shape))


def identity_route(config: SingleBlockResNetConfig, x: torch.Tensor, dense: ConvParams) -> str:
    """"fused" for an fp32 Euler stack of 3x3 kernels (the dense stack's own
    shape) without batch norm, of any kernel type, within the JAX kernel
    gate's reach: one B1 call (and one B2 call in the backward) on the
    card, in the variant the shape takes (`kernel_variant`).
    "per_layer" for every other stack, as the JAX package runs it on XLA's
    convolutions, an ``int8_forward`` stack first of all.  Decided from
    shapes, dtype and the config, before anything is launched.

    Over a mesh: "pipeline" with ``pp_mesh``; "tensor_parallel" with
    ``tp_mesh`` for every stack the JAX package would not run on Pallas
    (which keeps "fused", each rank on full channels)."""
    if config.pp_mesh is not None:
        return "pipeline"
    if config.tp_mesh is not None and not jax_runs_pallas(config, x):
        return "tensor_parallel"
    if (config.int8_forward or config.use_batch_norm or config.integrator != "euler"
            or tuple(dense.kernel.shape[1:3]) != (3, 3) or not fused_euler_eligible(x, dense)):
        return "per_layer"
    return "fused"


def _s2d_eligible(config: SingleBlockResNetConfig, x: torch.Tensor) -> bool:
    """Whether a per-layer stack without batch norm runs space-to-depth
    packed: a 3x3 kernel, a block b > 1 that divides H and W, and either
    ``s2d_force`` (any device) or, on the card only, an explicit
    ``s2d_max_rows`` of at least the stack's N*H*W input rows.  The JAX
    rule, except its default: with ``s2d_max_rows=None`` the card packs
    nothing (the JAX package's 32768 rows were measured on a TPU).  On the
    CPU only ``s2d_force`` packs, as in the JAX package."""
    b = config.s2d_block
    rows = x.shape[0] * x.shape[1] * x.shape[2]
    max_rows = config.s2d_max_rows
    return (
        b > 1
        and config.kernel_size == 3
        and x.shape[1] % b == 0
        and x.shape[2] % b == 0
        and (config.s2d_force or (x.is_cuda and max_rows is not None and rows <= max_rows))
    )


def per_layer_form(config: SingleBlockResNetConfig, x: torch.Tensor) -> str:
    """The form a per-layer stack without batch norm runs in: "int8" with
    ``int8_forward`` (which overrides s2d, as in the JAX package), "s2d"
    where `_s2d_eligible`, else "direct"."""
    if config.int8_forward:
        return "int8"
    return "s2d" if _s2d_eligible(config, x) else "direct"


def _pack_params_s2d(dense: ConvParams, config: SingleBlockResNetConfig) -> ConvParams:
    """Stacked dense (L, 3, 3, C, C) kernels and (L, C) biases in their
    space-to-depth packed form, all layers in one gather (`ops.s2d`)."""
    b = config.s2d_block
    return ConvParams(pack_kernel_s2d(dense.kernel, b), pack_bias_s2d(dense.bias, b))


def _per_layer_stack(x: torch.Tensor, dense: ConvParams, config: SingleBlockResNetConfig,
                     form: str) -> torch.Tensor:
    """A stack without batch norm, layer by layer, in ``form``
    (`per_layer_form`): each layer an Euler step or the integrator's field
    evaluations, with int8 convs for "int8", and for "s2d" in packed space
    (activations packed once, every layer's kernel in one gather, unpacked
    once; the JAX `_apply_identity_blocks_s2d` and the packed branch of
    `_apply_identity_blocks_multieval`)."""
    h = config.h
    if form == "int8":
        euler = functools.partial(euler_relu_step_int8, backward=config.int8_backward)
        field_of = functools.partial(conv_relu_field_int8, backward=config.int8_backward)
    else:
        euler, field_of = euler_relu_step, conv_relu_field
    if config.integrator == "euler":
        step = lambda y, p: euler(y, p.kernel, p.bias, h)
    else:
        method = get_integrator(config.integrator)
        field = lambda y, p: field_of(y, p.kernel, p.bias)
        step = lambda y, p: method(field, y, h, p)
    if form != "s2d":
        return run_layers(step, x, dense, remat=config.remat)
    b = config.s2d_block
    y = run_layers(step, space_to_depth(x, b), _pack_params_s2d(dense, config),
                   remat=config.remat)
    return depth_to_space(y, b)


def _tensor_parallel_stack(x, dense: ConvParams, config: SingleBlockResNetConfig, form: str,
                           group) -> torch.Tensor:
    """`_per_layer_stack` in Megatron form over ``group``: the field is
    `tensor_parallel.field` on this rank's c_out slice of the kernels, or
    `tensor_parallel.int8_field` on the whole layer (its scales are the
    whole kernel's and cotangent's)."""
    b = config.s2d_block
    if form == "s2d":
        dense, x = _pack_params_s2d(dense, config), space_to_depth(x, b)
    if form == "int8":
        params = ConvParams(*dense)
        field = lambda y, p: tensor_parallel.int8_field(y, p, group, config.int8_backward)
    else:
        params = tensor_parallel.shard_out_channels(dense, group)
        field = lambda y, p: tensor_parallel.field(y, p, group)
    if config.integrator == "euler":
        step = lambda y, p: y + config.h * field(y, p)
    else:
        method = get_integrator(config.integrator)
        step = lambda y, p: method(field, y, config.h, p)
    y = run_layers(step, x, params, remat=config.remat)
    return depth_to_space(y, b) if form == "s2d" else y


def _pipelined_stack(x: torch.Tensor, dense: ConvParams,
                     config: SingleBlockResNetConfig) -> torch.Tensor:
    """The Euler stack pipelined over ``config.pp_mesh[config.pp_axis]``
    (`parallel.pipeline`), with channel TP inside each stage when
    ``tp_mesh`` is the same mesh; packed in s2d form where `_s2d_eligible`
    (the JAX `_apply_identity_blocks_pipelined`).  The rows are this rank's
    own: under a data mesh the step has split the batch already."""
    from differential_equations_resnet_tpu_torch.parallel.pipeline import pipeline_blocks_apply

    kernel, bias = dense.kernel, dense.bias
    packed = _s2d_eligible(config, x)
    if packed:
        kernel, bias = _pack_params_s2d(dense, config)
        x = space_to_depth(x, config.s2d_block)
    y = pipeline_blocks_apply(
        kernel, bias, x, config.h, config.pp_mesh, axis_name=config.pp_axis,
        num_microbatches=config.pp_microbatches or None,
        tp_axis=config.tp_axis if config.tp_mesh is not None else None,
    )
    return depth_to_space(y, config.s2d_block) if packed else y


def _warn_int8_divergent_backward(config: SingleBlockResNetConfig, x: torch.Tensor) -> None:
    """int8_backward='dgrad'/'full' quantizes the cotangent on the residual
    stream, and the JAX package measured such training diverge at trunk
    widths >= 64 at every depth, rate and quantizer scheme it tried (the
    rounding compounds ~exp(T*lambda) over the reverse sweep, a property of
    the architecture, not of a device).  Warns at C >= 64; narrow stacks
    stay silent."""
    if config.int8_backward not in ("dgrad", "full") or x.shape[-1] < 64:
        return
    warnings.warn(
        f"int8_backward={config.int8_backward!r} at trunk width C={x.shape[-1]} >= 64: "
        "this mode diverged in training at lane-filling widths in the JAX "
        "package's measurements, at every depth, rate and cotangent-quantizer "
        "scheme tried.  It is kept for throughput measurement; train with "
        "int8_backward='wgrad' (the same int8 residual memory) or 'ste'.",
        stacklevel=3,
    )


def _batch_norm_stack(x, dense: ConvParams, bn_params, bn_state, config, train: bool,
                      tp_group=None):
    """The Euler stack with batch norm, layer by layer: y + h * relu(BN(conv(y)
    + b)), each layer checkpointed where ``remat`` is set (the running
    statistics are outputs of the checkpointed step, so a recompute in the
    backward does not apply them twice).  With ``tp_group`` the conv is the
    Megatron form of `parallel.tensor_parallel` (this rank's output
    channels, all-gathered before the norm).  Returns (y, the stack's new
    (L, C) BatchNormState)."""
    if tp_group is None:
        conv = lambda y, p: conv2d_same(y, p.kernel, bias=p.bias)
    else:
        dense = tensor_parallel.shard_out_channels(dense, tp_group)
        conv = lambda y, p: tensor_parallel.conv(y, p, tp_group)

    def step(y, p, bn_p, bn_s):
        z, new = batch_norm(conv(y, p), bn_p, bn_s, train)
        return y + config.h * torch.relu(z), new.mean, new.var

    y, means, variances = x, [], []
    for layer in range(num_layers(dense)):
        args = (y, layer_slice(dense, layer), layer_slice(bn_params, layer),
                layer_slice(bn_state, layer))
        if config.remat:
            y, mean, var = checkpoint(step, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            y, mean, var = step(*args)
        means.append(mean)
        variances.append(var)
    return y, BatchNormState(torch.stack(means), torch.stack(variances))


def _record_per_layer(x: torch.Tensor, dense: ConvParams, form: str) -> None:
    """The per-layer stack to the record of hand-kernel calls
    (`utils.tracing.STACKS`), as kernel "per_layer" in variant ``form``
    with no launch of its own (cuDNN's), into the graph being captured if
    any, so that a captured step lists every identity stack on its route."""
    _, height, width, channels = x.shape
    entry = StackEntry("per_layer", (height, width, channels, num_layers(dense)), form, 0, 0)
    STACKS.add(entry, x.is_cuda and torch.cuda.is_current_stream_capturing())


def _apply_identity_blocks(x: torch.Tensor, sp: dict, ss: dict,
                           config: SingleBlockResNetConfig, train: bool):
    """A stage's identity stack on its route (`identity_route`).  Returns
    (y, the stage's new batch-norm state)."""
    _warn_int8_divergent_backward(config, x)
    dense = _dense_blocks(sp["blocks"], config)
    route = identity_route(config, x, dense)
    tp_group = (config.tp_mesh.get_group(config.tp_axis) if route == "tensor_parallel"
                else None)
    new_ss = {}
    if route == "pipeline":
        y = _pipelined_stack(x, dense, config)
    elif route == "fused":
        y = fused_euler_dense(x, dense.kernel, dense.bias, float(config.h))
    elif config.use_batch_norm:
        y, new_ss["blocks_bn"] = _batch_norm_stack(x, dense, sp["blocks_bn"], ss["blocks_bn"],
                                                   config, train, tp_group)
    else:
        form = per_layer_form(config, x)
        if tp_group is None:
            _record_per_layer(x, dense, form)
            y = _per_layer_stack(x, dense, config, form)
        else:
            y = _tensor_parallel_stack(x, dense, config, form, tp_group)
        per_layer_counts[form] += 1
    (mesh_route_counts if route in mesh_route_counts else route_counts)[route] += 1
    return y, new_ss


def normalize_input(x: torch.Tensor, config) -> torch.Tensor:
    """The images cast to the config's compute dtype, less
    ``subtract_mean``, over ``divide_by_stddev``, both in that dtype."""
    x = x.to(compute_dtype_of(config))
    if config.subtract_mean is not None:
        x = x - _input_constant(config.subtract_mean, x.device, x.dtype)
    if config.divide_by_stddev is not None:
        x = x / _input_constant(config.divide_by_stddev, x.device, x.dtype)
    return x


def _stem(params: dict, state: dict, x: torch.Tensor, config: SingleBlockResNetConfig,
          train: bool, new_state: dict) -> torch.Tensor:
    """The normalized input through the stem conv, batch norm (its new
    running statistics into ``new_state``) and relu."""
    x = normalize_input(x, config)
    stem = params["stem"]
    x = conv2d_same(x, stem.kernel, strides=tuple(config.strides[0]), bias=stem.bias)
    if config.use_batch_norm:
        x, new_state["stem_bn"] = batch_norm(x, params["stem_bn"], state["stem_bn"], train)
    return torch.relu(x)


def head(params: dict, x: torch.Tensor, config, return_logits: bool) -> torch.Tensor:
    """Either family's top: global average pool, the dense layer on an fp32
    input and, unless ``return_logits``, the fc activation (x itself
    without ``include_top``)."""
    if not config.include_top:
        return x
    x = dense(global_average_pool(x).to(torch.float32), params["head"])
    return x if return_logits else apply_fc_activation(x, config.fc_activation)


def apply_single_block_resnet(
    params: dict,
    state: dict,
    x: torch.Tensor,
    config: SingleBlockResNetConfig,
    train: bool = False,
    return_logits: bool = False,
):
    """Forward pass on NHWC images, the JAX ``apply``: returns (output,
    new_state), new_state ``state`` itself without batch norm.
    ``return_logits=True`` skips the final fc_activation (softmax)."""
    new_state = {"stages": []}
    x = _stem(params, state, x, config, train, new_state)
    for plan, sp, ss in zip(stage_plans(config), params["stages"], state["stages"]):
        stage_ss = {}
        if plan.pool:
            x = max_pool_2x2(x)
        if plan.has_conv_block:
            x, conv_ss = _apply_conv_block(x, sp, ss, config, plan.strides, train)
            stage_ss.update(conv_ss)
        if sp["blocks"] is not None:
            x, blocks_ss = _apply_identity_blocks(x, sp, ss, config, train)
            stage_ss.update(blocks_ss)
        new_state["stages"].append(stage_ss)
    return head(params, x, config, return_logits), (new_state if config.use_batch_norm else state)


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


def stack_trees(trees):
    """One tree whose tensor leaves are the ``trees``' leaves stacked on a
    new leading (layer) axis: dicts and NamedTuples of tensors, None leaves
    staying None."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[stack_trees(list(leaves)) for leaves in zip(*trees)])
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return None


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


class TreeModel(nn.Module):
    """An `nn.Module` over a parameter tree and a state tree in the JAX
    package's layouts: each parameter leaf is registered as an
    `nn.Parameter` and each state leaf (batch-norm running statistics) as a
    buffer, both named by their tree paths joined by "__", so ``state_dict``
    keys are ``stem__kernel``, ``stages__0__blocks__cross``,
    ``stem_bn__mean``, ....  Subclasses call `_register` and `_forward`."""

    def _register(self, params, state, template, device: torch.device) -> None:
        """Register copies of ``params`` and ``state`` (default:
        ``template``, the init state, whose structure a given state must
        have) on ``device``: a model never shares storage with the trees it
        was built from, another model's included."""
        self.tree = map_leaves(
            lambda t: nn.Parameter(t.detach().to(device, torch.float32, copy=True)), params
        )
        self._param_names = []
        for name, leaf in _named_leaves(self.tree):
            self.register_parameter(name, leaf)
            self._param_names.append(name)
        want = dict(_named_leaves(template))
        values = want if state is None else dict(_named_leaves(state))
        misfit = sorted(k for k in set(values) | set(want) if k not in values or k not in want
                        or tuple(values[k].shape) != tuple(want[k].shape))
        if misfit:
            raise ValueError(f"the state tree does not fit the config at {misfit[:5]}")
        self._state_names = list(want)  # in the template's order, as `state` maps it
        for name in self._state_names:
            self.register_buffer(name, values[name].detach().to(device, torch.float32, copy=True))
        self._state_template = template

    def params(self) -> dict:
        """The parameter tree; its leaves are this module's parameters."""
        return self.tree

    def state(self) -> dict:
        """The state tree; its leaves are this module's buffers."""
        leaves = iter([self._buffers[name] for name in self._state_names])
        return map_leaves(lambda _: next(leaves), self._state_template)

    def _forward(self, apply, x: torch.Tensor, train: bool, return_logits: bool) -> torch.Tensor:
        """``apply(params, state, x, config, train, return_logits)``; in train
        mode the new state is written into the buffers, in place (so a CUDA
        graph that captured them sees it)."""
        leaves = iter([self._parameters[name] for name in self._param_names])
        # The registered parameters, not the tree's own references: while
        # `torch.export` traces, they are the ones it swapped in.
        params = map_leaves(lambda _: next(leaves), self.tree)
        out, new_state = apply(params, self.state(), x, self.config, train, return_logits)
        if train and self._state_names:
            new = dict(_named_leaves(new_state))
            with torch.no_grad():
                for name in self._state_names:
                    self._buffers[name].copy_(new[name])
        return out


class SingleBlockResNet(TreeModel):
    """The single-block model as an `nn.Module` (see `TreeModel`).

    Give either ``params`` (a parameter tree, e.g. from
    `utils.weight_utils.params_from_jax`) or a ``generator`` to draw them;
    ``state`` (the running statistics, e.g. from `state_from_jax`) defaults
    to the init state.  ``device`` defaults to CUDA (see
    `resolve_device`)."""

    def __init__(
        self,
        config: SingleBlockResNetConfig,
        params: Optional[dict] = None,
        state: Optional[dict] = None,
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
        self._register(params, state, init_single_block_state(config), device)

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                train: bool = False) -> torch.Tensor:
        """The model's output (probabilities, or logits with
        ``return_logits``); ``train=True`` is the JAX ``apply(...,
        train=True)``: batch statistics, and the running ones updated."""
        return self._forward(apply_single_block_resnet, x, train, return_logits)

    def with_mesh_context(self, data_axis_size: Optional[int] = None,
                          device_platform: Optional[str] = None) -> "SingleBlockResNet":
        """The model with its config bound to a mesh's data-axis size and
        platform (an explicit ``device_platform`` wins), as the JAX step
        builders bind it (`train.train_step._bind_mesh`): a shallow copy
        that shares this model's parameters and buffers, or the model
        itself where nothing changes."""
        changes = {}
        if data_axis_size is not None and data_axis_size != self.config.data_axis_size:
            changes["data_axis_size"] = data_axis_size
        if device_platform is not None and self.config.device_platform is None:
            changes["device_platform"] = device_platform
        if not changes:
            return self
        bound = copy.copy(self)
        bound.config = dataclasses.replace(self.config, **changes)
        return bound


def build_single_block_resnet(
    config: Optional[SingleBlockResNetConfig] = None,
    *,
    params: Optional[dict] = None,
    state: Optional[dict] = None,
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
    return SingleBlockResNet(config, params, state, generator=generator, device=device)


def get_single_block_resnet_build_function(**kwargs):
    """Factory form: a function of no arguments that builds the model
    (`build_single_block_resnet` with ``kwargs``)."""
    return lambda: build_single_block_resnet(**kwargs)
