"""Explicit time integrators for dY/dt = f(Y, theta(t)), in PyTorch.

Port of `differential_equations_resnet_tpu/ops/integrators.py`.  The residual
block ``y <- y + h * relu(conv(y) + b)`` is the forward-Euler step of the
stable ODE; midpoint and RK4 take two and four evaluations of the same field
a step.  The depth is a loop over stacked (L, ...) per-layer parameters: layer
l takes slice l of every leaf.

``remat=True`` wraps each step in `torch.utils.checkpoint.checkpoint`
(non-reentrant), so its activations are recomputed in the backward instead
of kept.  The field draws no random numbers, so the checkpoint does not save
and restore the RNG state (``preserve_rng_state=False``), which also keeps a
remat step capturable in a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Field = Callable[..., torch.Tensor]  # f(y, params) -> dy/dt


def euler_step(f: Field, y: torch.Tensor, h: float, params: Any) -> torch.Tensor:
    """Forward Euler: y + h*f(y).  The reference's residual block."""
    return y + h * f(y, params)


def midpoint_step(f: Field, y: torch.Tensor, h: float, params: Any) -> torch.Tensor:
    """Explicit midpoint (RK2): y + h*f(y + (h/2)*f(y))."""
    return y + h * f(y + (0.5 * h) * f(y, params), params)


def rk4_step(f: Field, y: torch.Tensor, h: float, params: Any) -> torch.Tensor:
    """Classic fourth-order Runge-Kutta."""
    k1 = f(y, params)
    k2 = f(y + (0.5 * h) * k1, params)
    k3 = f(y + (0.5 * h) * k2, params)
    k4 = f(y + h * k3, params)
    return y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_INTEGRATORS = {"euler": euler_step, "midpoint": midpoint_step, "rk4": rk4_step}

# Field evaluations a step (FLOP accounting, benchmarks).
INTEGRATOR_STAGES = {"euler": 1, "midpoint": 2, "rk4": 4}


def get_integrator(method: str):
    try:
        return _INTEGRATORS[method]
    except KeyError:
        raise ValueError(
            f"Unknown integrator {method!r}; expected one of {sorted(_INTEGRATORS)}."
        ) from None


def layer_slice(tree: Any, layer: int) -> Any:
    """Slice ``layer`` of every tensor leaf of a stacked parameter tree
    (tensors, NamedTuples, dicts, lists and tuples; None passes through)."""
    if isinstance(tree, torch.Tensor):
        return tree[layer]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[layer_slice(v, layer) for v in tree])
    if isinstance(tree, dict):
        return {k: layer_slice(v, layer) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(layer_slice(v, layer) for v in tree)
    return tree


def num_layers(tree: Any) -> int:
    """The leading (layer) size of a stacked parameter tree's first tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    values = tree.values() if isinstance(tree, dict) else tree
    for value in values:
        if value is not None:
            return num_layers(value)
    raise ValueError("the stacked parameters hold no tensor")


def run_layers(step: Callable[[torch.Tensor, Any], torch.Tensor], y0: torch.Tensor,
               stacked_params: Any, remat: bool = False) -> torch.Tensor:
    """``y <- step(y, params_l)`` for l = 0..L-1, each step checkpointed
    where ``remat`` says so."""
    y = y0
    for layer in range(num_layers(stacked_params)):
        params = layer_slice(stacked_params, layer)
        if remat:
            y = checkpoint(step, y, params, use_reentrant=False, preserve_rng_state=False)
        else:
            y = step(y, params)
    return y


def integrate(
    f: Field,
    y0: torch.Tensor,
    stacked_params: Any,
    h: float,
    method: str = "euler",
    remat: bool = False,
    unroll: int = 1,
) -> torch.Tensor:
    """Integrate y' = f(y, theta_l) over L steps of size h.

    ``stacked_params`` is a tree whose leaves carry a leading layer axis
    (L, ...); step l uses slice l.  ``remat=True`` recomputes each step in
    the backward (activation memory O(1) in depth for one more forward
    evaluation).  ``unroll`` is accepted for the JAX signature and changes
    nothing."""
    method_step = get_integrator(method)
    return run_layers(lambda y, p: method_step(f, y, h, p), y0, stacked_params, remat)


def integrate_with_trajectory(
    f: Field,
    y0: torch.Tensor,
    stacked_params: Any,
    h: float,
    method: str = "euler",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like `integrate`, and also the trajectory (L, ...) of the states
    after each step: (y_L, trajectory)."""
    method_step = get_integrator(method)
    states = []
    y = y0
    for layer in range(num_layers(stacked_params)):
        y = method_step(f, y, h, layer_slice(stacked_params, layer))
        states.append(y)
    return y, torch.stack(states)
