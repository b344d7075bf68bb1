"""Carry parameters between the JAX package and the port.

This is the one place where the two packages' parameter trees meet.  Both use
the same layouts (HWIO conv kernels, (d_in, d_out) dense kernels, stacked
(L, ...) leaves), so a conversion is a change of container and array type:

- `params_from_jax` takes the JAX parameter tree as NumPy arrays (dicts,
  lists, and NamedTuples or any objects with the parameter fields) and
  returns the port's tree of torch tensors; `state_from_jax` does the same
  for the JAX ``model_state`` (batch-norm running statistics), which a
  model takes as its ``state``;
- `params_to_jax` returns NumPy arrays in the port's NamedTuples, or in the
  classes the caller names, e.g. the JAX package's own.

Parameter objects are recognised by field name, never by importing the JAX
package.

Weight surgery, the rest of the JAX package's `utils/weight_utils.py`:
pickling a parameter tree with NumPy leaves (`pickle_model_weights`, read
back by a restricted unpickler, `load_pickled_weights`, which also reads the
JAX package's pickles), depth doubling (`double_model_depth`,
`double_load_weights`: every stacked layer repeated twice, h halved so the
final time T = h*L stays) and the reference's list-of-{kernel, bias} format
(`export_reference_weights`, `import_reference_weights`) for every kernel
type.  `convert_antisym_layout` converts every antisymmetric leaf of a tree
between the packed and the dense-lower layout, bit for bit.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.models.blocks import (
    BatchNormParams,
    BatchNormState,
    ConvParams,
    DenseParams,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    SingleBlockResNetConfig,
    _named_leaves,
    stack_trees,
    stage_plans,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    Antisym3x3Params,
    AntisymKxKParams,
    dense_from_packed,
    materialize_3x3,
    materialize_kxk,
    pack_3x3,
    pack_kxk,
    packed_from_dense,
)
from differential_equations_resnet_tpu_torch.ops.integrators import layer_slice, num_layers

PARAM_CLASSES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (ConvParams, DenseParams, BatchNormParams, BatchNormState,
                Antisym3x3Params, Antisym3x3DenseParams, AntisymKxKParams)
}

# Where each package (the JAX package's, this one) defines the parameter
# classes its pickles name.
_CLASS_MODULES = {
    f"{package}.{module}": names
    for package in ("differential_equations_resnet_tpu", "differential_equations_resnet_tpu_torch")
    for module, names in (
        ("models.blocks", ("ConvParams", "DenseParams", "BatchNormParams", "BatchNormState")),
        ("ops.antisymmetric", ("Antisym3x3Params", "Antisym3x3DenseParams", "AntisymKxKParams")),
    )
}
# What NumPy's pickling of arrays and dtypes needs (numpy 1 and 2 paths;
# protocol 5 rebuilds arrays with `_frombuffer`, older ones `_reconstruct`).
_NUMPY_GLOBALS = {
    (f"numpy.{core}.{module}", name)
    for core in ("core", "_core")
    for module, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}


class ParamsUnpickler(pickle.Unpickler):
    """Unpickles a parameter tree with NumPy leaves, written by either
    package (`pickle_model_weights`, a JAX export's ``params.pkl``), onto the
    port's parameter classes; every other global is refused, so the port
    never imports the JAX package."""

    def find_class(self, module: str, name: str):
        if name in _CLASS_MODULES.get(module, ()):
            return PARAM_CLASSES[name]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a parameter pickle may not reference {module}.{name}")


def _param_class(obj) -> Optional[type]:
    """The port class a parameter object corresponds to, by its class name
    where that is one of ours, else by its fields; None for a container."""
    named = PARAM_CLASSES.get(type(obj).__name__)
    if named is not None:
        return named
    has = lambda *fields: all(hasattr(obj, f) for f in fields)
    if has("a", "b", "c", "d", "cross"):
        packed = np.ndim(obj.cross) == np.ndim(obj.a) + 2
        return Antisym3x3Params if packed else Antisym3x3DenseParams
    if has("diag", "cross"):
        return AntisymKxKParams
    if has("scale", "offset"):
        return BatchNormParams
    if has("mean", "var"):
        return BatchNormState
    if has("kernel", "bias"):
        # Conv kernels are (k, k, C_in, C_out), stacked (L, k, k, C, C).
        return DenseParams if np.ndim(obj.kernel) == 2 else ConvParams
    return None


def _convert(tree, leaf: Callable[[Any], Any], make: Callable[[type, list], Any]):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, leaf, make) for k, v in tree.items()}
    cls = None if isinstance(tree, (list, np.ndarray, torch.Tensor)) else _param_class(tree)
    if cls is not None:
        return make(cls, [_convert(getattr(tree, f), leaf, make) for f in cls._fields])
    if isinstance(tree, (list, tuple)):
        return [_convert(v, leaf, make) for v in tree]
    return leaf(tree)


def params_from_jax(tree) -> Any:
    """The JAX package's parameter tree (NumPy leaves) -> the port's tree of
    fp32 torch tensors on the CPU."""
    return _convert(
        tree,
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)),
        lambda cls, values: cls(*values),
    )


def state_from_jax(tree) -> Any:
    """The JAX package's ``model_state`` tree (NumPy leaves; `BatchNormState`
    recognised by its fields) -> the port's state tree of fp32 tensors on
    the CPU, which `SingleBlockResNet` and `BottleneckResNet` take as
    ``state`` and hold as buffers."""
    return params_from_jax(tree)


def convert_antisym_layout(params, to: str):
    """Every antisymmetric-conv leaf of a parameter tree converted between
    the packed (..., 3, 3, P) and the dense-lower (..., 3, 3, C, C) layouts
    (``to`` = 'dense' or 'packed'), bit for bit; every other leaf passes
    through.  For trees saved before the bottleneck mid-convs took the
    dense layout."""
    if to not in ("dense", "packed"):
        raise ValueError(f"`to` must be 'dense' or 'packed', got {to!r}.")

    def convert(node):
        if isinstance(node, Antisym3x3Params) and to == "dense":
            return dense_from_packed(node)
        if isinstance(node, Antisym3x3DenseParams) and to == "packed":
            return packed_from_dense(node)
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return node

    return convert(params)


def adam_state_from_jax(adam_state, optimizer: torch.optim.Optimizer) -> dict:
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; NumPy
    leaves, ``mu``/``nu`` in the JAX parameter tree's layout) as a state_dict
    for ``optimizer``, a torch Adam over a port model's ``parameters()`` of
    the same tree, for ``optimizer.load_state_dict``.  optax's count of
    updates is torch's ``step``: both take the bias corrections at it.  The
    hyperparameters stay the optimizer's own; ``load_state_dict`` moves the
    step to the card for a capturable Adam."""
    # In the order the model registers its parameters.
    mu = [t for _, t in _named_leaves(params_from_jax(adam_state.mu))]
    nu = [t for _, t in _named_leaves(params_from_jax(adam_state.nu))]
    target = optimizer.state_dict()
    indices = [i for group in target["param_groups"] for i in group["params"]]
    if not len(mu) == len(nu) == len(indices):
        raise ValueError(f"the Adam state has {len(mu)} leaves, the optimizer {len(indices)} parameters")
    step = float(np.asarray(adam_state.count))
    state = {i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": m, "exp_avg_sq": v}
             for i, m, v in zip(indices, mu, nu)}
    return {"state": state, "param_groups": target["param_groups"]}


def params_to_jax(tree, classes: Optional[Mapping[str, type]] = None) -> Any:
    """The port's parameter tree -> NumPy leaves, each parameter object built
    by ``classes[<port class name>]`` (default: the port's own classes), so
    that ``params_to_jax(tree, {"ConvParams": jax_blocks.ConvParams, ...})``
    gives a tree the JAX package's ``model.apply`` takes."""
    lookup = dict(PARAM_CLASSES, **(classes or {}))
    return _convert(
        tree,
        lambda t: t.detach().cpu().numpy(),
        lambda cls, values: lookup[cls.__name__](*values),
    )


def _numpy_leaf(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tensor_leaf(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _map_tree(fn, tree) -> Any:
    """``tree`` with ``fn`` applied to every array or tensor leaf, parameter
    objects rebuilt as the port's classes."""
    return _convert(tree, fn, lambda cls, values: cls(*values))


def pickle_model_weights(params, save_filename: str) -> None:
    """Pickle a parameter tree (tensor or NumPy leaves) with NumPy leaves in
    the port's parameter classes, the JAX package's `pickle_model_weights`
    format."""
    with open(save_filename, "wb") as f:
        pickle.dump(_map_tree(_numpy_leaf, params), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickled_weights(load_filename: str):
    """A pickled parameter tree with NumPy leaves, written by either package,
    through `ParamsUnpickler` (never a bare ``pickle.load``);
    `params_from_jax` turns it into tensors."""
    with open(load_filename, "rb") as f:
        return ParamsUnpickler(f).load()


def _doubled_stages(params) -> dict:
    twice = lambda a: (torch.repeat_interleave(a, 2, dim=0) if isinstance(a, torch.Tensor)
                       else np.repeat(np.asarray(a), 2, axis=0))
    stages = []
    for sp in params["stages"]:
        sp = dict(sp)
        for key in ("blocks", "blocks_bn"):
            if sp.get(key) is not None:
                sp[key] = _map_tree(twice, sp[key])
        stages.append(sp)
    return dict(params, stages=stages)


def double_model_depth(params, config: SingleBlockResNetConfig):
    """Depth-doubling continuation: (new_params, new_config) with every
    stacked residual layer repeated into two consecutive layers and h halved,
    so the ODE's final time h*L stays.  Stem and head are shared."""
    new_config = dataclasses.replace(
        config, blocks_per_stage=tuple(2 * b for b in config.blocks_per_stage), h=config.h / 2.0)
    return _doubled_stages(params), new_config


def double_load_weights(model_params, weights_pickle_file: str, config=None):
    """Load pickled (l+2)-layer params and return the doubled (2l+2)-layer
    params, with the doubled config when ``config`` is given."""
    saved = load_pickled_weights(weights_pickle_file)
    if config is None:
        return _doubled_stages(saved)
    return double_model_depth(saved, config)


def export_reference_weights(params, config: SingleBlockResNetConfig) -> List[dict]:
    """The reference's pickle payload: one {'kernel', 'bias'} dict of NumPy
    arrays per trainable layer in graph order (stem, conv blocks, residual
    layers, head), packed layers materialized to dense (k, k, C, C)
    kernels."""
    params = _map_tree(_tensor_leaf, params)
    entry = lambda kernel, bias: {"kernel": _numpy_leaf(kernel), "bias": _numpy_leaf(bias)}
    out = [entry(*params["stem"])]
    with torch.no_grad():
        for plan, sp in zip(stage_plans(config), params["stages"]):
            if plan.has_conv_block:
                out += [entry(*sp["conv_main"]), entry(*sp["conv_shortcut"])]
            blocks = sp["blocks"]
            if blocks is None:
                continue
            for layer in range(num_layers(blocks)):
                block = layer_slice(blocks, layer)
                if isinstance(block, Antisym3x3Params):
                    kernel = materialize_3x3(block, gamma=config.gamma)
                elif isinstance(block, AntisymKxKParams):
                    kernel = materialize_kxk(block, config.kernel_size, gamma=config.gamma,
                                             antisymmetric=config.kernel_type == "antisymmetric")
                else:
                    kernel = block.kernel
                out.append(entry(kernel, block.bias))
    if config.include_top:
        out.append(entry(*params["head"]))
    return out


def import_reference_weights(weights: List[dict], params, config: SingleBlockResNetConfig):
    """A reference-format weights list loaded into a parameter tree of the
    same architecture as ``params`` (which gives the kernel type of each
    stack; packed layers are packed again by `pack_3x3` / `pack_kxk`).
    Returns a new tree of tensors."""
    params = _map_tree(_tensor_leaf, params)
    it = iter(weights)

    def take():
        w = next(it)
        return _tensor_leaf(w["kernel"]), _tensor_leaf(w["bias"])

    new_params = dict(params, stem=ConvParams(*take()))
    stages = []
    for plan, sp in zip(stage_plans(config), params["stages"]):
        sp = dict(sp)
        if plan.has_conv_block:
            sp["conv_main"] = ConvParams(*take())
            sp["conv_shortcut"] = ConvParams(*take())
        blocks = sp["blocks"]
        if blocks is not None:
            layers = []
            for _ in range(num_layers(blocks)):
                kernel, bias = take()
                if isinstance(blocks, Antisym3x3Params):
                    layers.append(pack_3x3(kernel, bias))
                elif isinstance(blocks, AntisymKxKParams):
                    layers.append(pack_kxk(kernel, bias,
                                           antisymmetric=config.kernel_type == "antisymmetric"))
                else:
                    layers.append(ConvParams(kernel, bias))
            sp["blocks"] = stack_trees(layers)
        stages.append(sp)
    new_params["stages"] = stages
    if config.include_top:
        new_params["head"] = DenseParams(*take())
    return new_params
