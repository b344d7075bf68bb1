"""Bottleneck ResNet-50/101/152 with an optional antisymmetric 3x3 mid-conv,
in PyTorch.

Port of `differential_equations_resnet_tpu/models/bottleneck_resnet.py`
(config, presets, init and the forward pass), the reference's
`models/tfkeras_resnets.py` family: a stem (zero pad 3, 7x7 stride-2 VALID
conv, batch norm, relu, zero pad 1, 3x3 stride-2 VALID max pool), then four
stages of bottleneck blocks (1x1, 3x3, 1x1 convs, each with batch norm), the
first of each stage with a projection shortcut, then global average pool,
dense and softmax.  Version 1 strides a stage's first block on its 1x1 conv,
version 1.5 on its 3x3 conv.  With ``kernel_type="antisymmetric"`` and a
``None`` mid width the 3x3 mid-conv is antisymmetric, in the dense-lower
layout (`ops.antisymmetric.Antisym3x3DenseParams`).

A stage's identity blocks are stacked (L, ...) leaves, as in the JAX
package; they run in a Python loop over layer slices, their antisymmetric
mid-conv kernels materialized for all L layers at once.  Every convolution
runs on cuDNN with TF32 off on the card (`ops.conv`): the JAX package runs
this family on XLA's convolutions and has no Pallas kernel for it.

`BottleneckResNet` is the `nn.Module`: its parameters are the tree's leaves
and the batch-norm running statistics its buffers (`TreeModel`), and its
forward takes ``train`` as JAX ``apply`` does.  ``compute_dtype`` is the
JAX package's, as in the single-block family: the input cast to it, every
convolution and batch norm in its input's dtype, the head on an fp32
input, the parameters fp32.  With ``int8_forward`` the stride-1 convs of
the main path of every block whose mid width is at least
``int8_min_mid_channels`` (256, the JAX package's gate: it decides which
convs are quantized, so it is part of the function) run dynamic w8a8
(`ops.quantize.conv_int8_same`, per-tensor weight scales, the backward as
``int8_backward`` says); strided convs and the shortcuts stay fp.
`models.quantized` serves either family with int8 convs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models.blocks import (
    batch_norm,
    epilogue_of,
    init_batch_norm,
    init_conv,
    init_dense,
    max_pool,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    TreeModel,
    dtype_reason,
    head,
    normalize_input,
    stack_trees,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    init_antisym_3x3_dense,
    materialize_3x3_from_dense,
)
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same, conv2d_valid
from differential_equations_resnet_tpu_torch.ops.integrators import layer_slice, num_layers
from differential_equations_resnet_tpu_torch.ops.quantize import conv_int8_same

Filters = Tuple[int, Optional[int], int]

_PRESETS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
_PRESET_FILTERS: Tuple[Filters, ...] = (
    (64, 64, 256),
    (128, 128, 512),
    (256, 256, 1024),
    (512, 512, 2048),
)
STEM_FILTERS = 64


@dataclasses.dataclass(frozen=True)
class BottleneckResNetConfig:
    """The keyword surface of the JAX package's `BottleneckResNetConfig`,
    field for field, with the same validation."""

    image_shape: Tuple[int, int, int] = (224, 224, 3)
    kernel_type: str = "antisymmetric"
    include_top: bool = True
    fc_activation: Optional[str] = "softmax"
    num_classes: Optional[int] = None
    l2_regularization: float = 0.0
    subtract_mean: Optional[Any] = None
    divide_by_stddev: Optional[Any] = None
    version: float = 1
    blocks_per_stage: Tuple[int, int, int, int] = (3, 4, 6, 3)
    filters_per_block: Tuple[Filters, ...] = _PRESET_FILTERS
    use_batch_norm: bool = True
    gamma: float = 0.0
    compute_dtype: Any = torch.float32
    int8_forward: bool = False
    int8_backward: str = "ste"
    int8_min_mid_channels: int = 256

    def __post_init__(self):
        if self.include_top and self.num_classes is None:
            raise ValueError(
                "You must pass a positive integer for `num_classes` if "
                "`include_top` is `True`."
            )
        if self.version not in (1, 1.5):
            raise ValueError("Supported values for `version` are 1 and 1.5.")
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

    @property
    def name(self) -> str:
        return f"resnet_{self.kernel_type}"


def resnet_preset(
    preset: str, num_classes: int, antisymmetric_mid: bool = False, **overrides
) -> BottleneckResNetConfig:
    """The ResNet-50/101/152 presets.  With ``antisymmetric_mid=True`` every
    mid width is None, which makes the 3x3 mid-convs antisymmetric."""
    if preset not in _PRESETS:
        raise ValueError(
            "`preset` must be one of 'resnet50', 'resnet101', 'resnet152', "
            f"but you passed preset={preset!r}."
        )
    filters = tuple((f0, None if antisymmetric_mid else f1, f2)
                    for (f0, f1, f2) in _PRESET_FILTERS)
    return BottleneckResNetConfig(
        blocks_per_stage=_PRESETS[preset],
        filters_per_block=filters,
        use_batch_norm=True,
        num_classes=num_classes,
        kernel_type="antisymmetric" if antisymmetric_mid else "regular",
        **overrides,
    )


def unsupported_reason(config: BottleneckResNetConfig) -> str:
    """What of ``config`` the port does not run, or "" where the whole
    config is covered."""
    return dtype_reason(config)


def _mid_is_antisym(config: BottleneckResNetConfig, filters: Filters) -> bool:
    """The reference's rule: antisymmetric kernels and a None mid width."""
    return config.kernel_type == "antisymmetric" and filters[1] is None


def _mid_width(config: BottleneckResNetConfig, filters: Filters) -> int:
    return filters[0] if _mid_is_antisym(config, filters) else filters[1]


def _init_bottleneck_block(generator: torch.Generator, config: BottleneckResNetConfig,
                           in_channels: int, filters: Filters) -> dict:
    """Parameters of one block's main path (1x1, 3x3, 1x1 convs and their
    batch norms); the antisymmetric mid-conv in the dense-lower layout."""
    f0, f1, f2 = filters
    p = {"conv1": init_conv(generator, (1, 1), in_channels, f0)}
    if _mid_is_antisym(config, filters):
        p["conv2"] = init_antisym_3x3_dense(generator, f0)
    else:
        p["conv2"] = init_conv(generator, (3, 3), f0, f1)
    p["conv3"] = init_conv(generator, (1, 1), _mid_width(config, filters), f2)
    if config.use_batch_norm:
        for name, channels in (("bn1", f0), ("bn2", _mid_width(config, filters)), ("bn3", f2)):
            p[name] = init_batch_norm(channels)[0]
    return p


def _block_state(config: BottleneckResNetConfig, filters: Filters) -> dict:
    if not config.use_batch_norm:
        return {}
    widths = (filters[0], _mid_width(config, filters), filters[2])
    return {name: init_batch_norm(c)[1] for name, c in zip(("bn1", "bn2", "bn3"), widths)}


def init_resnet_state(config: BottleneckResNetConfig) -> dict:
    """The state tree, the JAX package's ``model_state``: the running
    statistics (mean 0, variance 1) of every batch norm, ``{"stem_bn",
    "stages": [{"conv_block": {"bn1", "bn2", "bn3"}, "bn_shortcut",
    "identity_blocks": stacked, or None}]}`` (empty dicts without batch
    norm)."""
    bn = config.use_batch_norm
    state = {"stem_bn": init_batch_norm(STEM_FILTERS)[1]} if bn else {}
    stages = []
    for num_blocks, filters in zip(config.blocks_per_stage, config.filters_per_block):
        ss = {"conv_block": _block_state(config, filters)}
        if bn:
            ss["bn_shortcut"] = init_batch_norm(filters[2])[1]
        ss["identity_blocks"] = (stack_trees([_block_state(config, filters)] * (num_blocks - 1))
                                 if num_blocks > 1 else None)
        stages.append(ss)
    state["stages"] = stages
    return state


def init_resnet(config: BottleneckResNetConfig, generator: torch.Generator):
    """(params, state), the parameters drawn on the CPU from
    ``generator``: ``{"stem", "stem_bn", "stages": [{"conv_block": {"conv1",
    "conv2", "conv3", "bn1", "bn2", "bn3"}, "shortcut", "bn_shortcut",
    "identity_blocks": stacked, or None}], "head"}``."""
    params = {"stem": init_conv(generator, (7, 7), config.image_shape[-1], STEM_FILTERS)}
    if config.use_batch_norm:
        params["stem_bn"] = init_batch_norm(STEM_FILTERS)[0]
    in_channels = STEM_FILTERS
    stages = []
    for num_blocks, filters in zip(config.blocks_per_stage, config.filters_per_block):
        sp = {"conv_block": _init_bottleneck_block(generator, config, in_channels, filters),
              "shortcut": init_conv(generator, (1, 1), in_channels, filters[2])}
        if config.use_batch_norm:
            sp["bn_shortcut"] = init_batch_norm(filters[2])[0]
        in_channels = filters[2]
        sp["identity_blocks"] = (
            stack_trees([_init_bottleneck_block(generator, config, in_channels, filters)
                         for _ in range(num_blocks - 1)]) if num_blocks > 1 else None)
        stages.append(sp)
    params["stages"] = stages
    if config.include_top:
        params["head"] = init_dense(generator, config.filters_per_block[-1][2], config.num_classes)
    return params, init_resnet_state(config)


def mid_kernel(conv2, gamma: float) -> torch.Tensor:
    """The dense HWIO kernel of a 3x3 mid-conv, (3, 3, C, C), or of a stack
    of them, (L, 3, 3, C, C), all layers at once: materialized from the
    dense-lower antisymmetric layout, or the regular conv's own kernel.
    (`utils.weight_utils.convert_antisym_layout` makes a packed tree
    dense.)"""
    if isinstance(conv2, Antisym3x3DenseParams):
        return materialize_3x3_from_dense(conv2, gamma)
    return conv2.kernel


def _block_int8(config: BottleneckResNetConfig, mid_width: int) -> bool:
    """Whether a block's stride-1 main-path convs run int8: the flag is on
    and the block's mid width clears ``int8_min_mid_channels``."""
    return config.int8_forward and mid_width >= config.int8_min_mid_channels


def _conv_or_int8(y, kernel, bias, strides, q: bool, backward: str):
    """A stride-1 conv of an int8 block in dynamic w8a8; every other conv
    fp (the int8 backward's transposed-kernel adjoint is stride-1 SAME
    only)."""
    if q and tuple(strides) == (1, 1):
        b = bias if bias is not None else torch.zeros(kernel.shape[-1], device=kernel.device)
        return conv_int8_same(y, kernel, b, "per_tensor", backward)
    return conv2d_same(y, kernel, strides=strides, bias=bias)


def _apply_bottleneck_main(x, p, s, kernel, config, strides, train, residual=None):
    """Main path of a bottleneck block, 1x1 -> 3x3 (``kernel``, dense) ->
    1x1 with batch norm and relu, striding as ``config.version`` says, the
    stride-1 convs int8 where `_block_int8` says so; given a ``residual``,
    ``relu(main + residual)``.  Each relu, and the residual add, is its
    batch norm's epilogue (`blocks.batch_norm`) where the model has batch
    norm.  Returns (y, the block's new batch-norm state)."""
    if config.version == 1:
        strides_1x1, strides_3x3 = strides, (1, 1)
    else:
        strides_1x1, strides_3x3 = (1, 1), strides
    q, backward = _block_int8(config, kernel.shape[-1]), config.int8_backward
    new_s = {}

    def norm(y, name, epilogue, residual=None):
        if not config.use_batch_norm:
            return epilogue_of(y, epilogue, residual)
        y, new_s[name] = batch_norm(y, p[name], s[name], train, epilogue, residual)
        return y

    y = _conv_or_int8(x, p["conv1"].kernel, p["conv1"].bias, strides_1x1, q, backward)
    y = _conv_or_int8(norm(y, "bn1", "relu"), kernel, p["conv2"].bias, strides_3x3, q, backward)
    y = _conv_or_int8(norm(y, "bn2", "relu"), p["conv3"].kernel, p["conv3"].bias, (1, 1), q,
                      backward)
    return norm(y, "bn3", "none" if residual is None else "add_relu", residual), new_s


def _stem(params: dict, state: dict, x: torch.Tensor, config: BottleneckResNetConfig,
          train: bool, new_state: dict) -> torch.Tensor:
    """The normalized input through the stem: zero pad 3, 7x7 stride-2 VALID
    conv, batch norm (its new running statistics into ``new_state``), relu,
    zero pad 1 and 3x3 stride-2 max pool."""
    x = F.pad(normalize_input(x, config), (0, 0, 3, 3, 3, 3))
    x = conv2d_valid(x, params["stem"].kernel, strides=(2, 2), bias=params["stem"].bias)
    if config.use_batch_norm:
        x, new_state["stem_bn"] = batch_norm(x, params["stem_bn"], state["stem_bn"], train,
                                             "relu")
    else:
        x = torch.relu(x)
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    return max_pool(x, (3, 3), (2, 2))


def apply_resnet(
    params: dict,
    state: dict,
    x: torch.Tensor,
    config: BottleneckResNetConfig,
    train: bool = False,
    return_logits: bool = False,
):
    """Forward pass on NHWC images, the JAX ``apply``: returns (output,
    new_state), new_state ``state`` itself without batch norm."""
    bn = config.use_batch_norm
    new_state = {"stages": []}
    x = _stem(params, state, x, config, train, new_state)

    for stage, (sp, ss) in enumerate(zip(params["stages"], state["stages"])):
        strides = (1, 1) if stage == 0 else (2, 2)
        stage_ss = {}
        main, stage_ss["conv_block"] = _apply_bottleneck_main(
            x, sp["conv_block"], ss["conv_block"], mid_kernel(sp["conv_block"]["conv2"], config.gamma),
            config, strides, train)
        shortcut = conv2d_same(x, sp["shortcut"].kernel, strides=strides, bias=sp["shortcut"].bias)
        if bn:  # main is done first, so bn_shortcut takes the add: relu(shortcut + main)
            x, stage_ss["bn_shortcut"] = batch_norm(
                shortcut, sp["bn_shortcut"], ss["bn_shortcut"], train, "add_relu", main)
        else:
            x = torch.relu(main + shortcut)

        blocks = sp["identity_blocks"]
        stage_ss["identity_blocks"] = None
        if blocks is not None:
            kernels = mid_kernel(blocks["conv2"], config.gamma)
            block_states = []
            for layer in range(num_layers(blocks)):
                x, block_ss = _apply_bottleneck_main(
                    x, layer_slice(blocks, layer), layer_slice(ss["identity_blocks"], layer),
                    kernels[layer], config, (1, 1), train, residual=x)
                block_states.append(block_ss)
            stage_ss["identity_blocks"] = stack_trees(block_states)
        new_state["stages"].append(stage_ss)

    return head(params, x, config, return_logits), (new_state if bn else state)


class BottleneckResNet(TreeModel):
    """The bottleneck family as an `nn.Module` (see `TreeModel`): give
    ``params`` (e.g. from `utils.weight_utils.params_from_jax`) or a
    ``generator``; ``state`` (e.g. from `state_from_jax`) defaults to the
    init state.  ``device`` defaults to CUDA (see `resolve_device`)."""

    def __init__(
        self,
        config: BottleneckResNetConfig,
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
            params, _ = init_resnet(config, generator)
        self._register(params, state, init_resnet_state(config), device)

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                train: bool = False) -> torch.Tensor:
        """The model's output (probabilities, or logits with
        ``return_logits``); ``train=True`` normalizes by the batch's
        statistics and updates the running ones."""
        return self._forward(apply_resnet, x, train, return_logits)


def build_resnet(
    config: Optional[BottleneckResNetConfig] = None,
    *,
    params: Optional[dict] = None,
    state: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs,
) -> BottleneckResNet:
    """Constructor with the reference's keyword surface: either a
    `BottleneckResNetConfig` or its fields as keywords, including
    ``preset='resnet50'|'resnet101'|'resnet152'``."""
    if config is None:
        preset = kwargs.pop("preset", None)
        if preset is not None:
            kwargs["blocks_per_stage"] = _PRESETS[preset]
        if "blocks_per_stage" in kwargs:
            kwargs["blocks_per_stage"] = tuple(kwargs["blocks_per_stage"])
        if "filters_per_block" in kwargs:
            kwargs["filters_per_block"] = tuple(tuple(f) for f in kwargs["filters_per_block"])
        if "image_shape" in kwargs:
            kwargs["image_shape"] = tuple(kwargs["image_shape"])
        config = BottleneckResNetConfig(**kwargs)
    elif kwargs:
        raise TypeError("Pass either a config object or keyword arguments, not both.")
    return BottleneckResNet(config, params, state, generator=generator, device=device)


def get_resnet_build_function(**kwargs):
    """Factory form: a function of no arguments that builds the model."""
    return lambda: build_resnet(**kwargs)
