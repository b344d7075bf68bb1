"""Carry parameters between the JAX package and the port.

This is the one place where the two packages' parameter trees meet.  Both use
the same layouts (HWIO conv kernels, (d_in, d_out) dense kernels, stacked
(L, ...) leaves), so a conversion is a change of container and array type:

- `params_from_jax` takes the JAX parameter tree as NumPy arrays (dicts,
  lists, and NamedTuples or any objects with the parameter fields) and
  returns the port's tree of torch tensors;
- `params_to_jax` returns NumPy arrays in the port's NamedTuples, or in the
  classes the caller names, e.g. the JAX package's own.

Parameter objects are recognised by field name, never by importing the JAX
package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.models.blocks import (
    BatchNormParams,
    BatchNormState,
    ConvParams,
    DenseParams,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import _named_leaves
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3DenseParams,
    Antisym3x3Params,
    AntisymKxKParams,
)

PARAM_CLASSES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (ConvParams, DenseParams, BatchNormParams, BatchNormState,
                Antisym3x3Params, Antisym3x3DenseParams, AntisymKxKParams)
}


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
        return ConvParams if np.ndim(obj.kernel) == 4 else DenseParams
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
