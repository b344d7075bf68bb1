"""Deep-stability diagnostics: the conv-matrix spectrum, the forward
stability report and the gamma sweep.

Port of `differential_equations_resnet_tpu/experiments/deep_stability.py`:

- the convolution *matrix* M of an antisymmetric kernel satisfies
  M = A + gamma*I with A^T = -A, so spec(M) lies on the line Re(z) = gamma
  (`conv_matrix_spectrum` builds M and checks it, on the host in float64);
- the forward flow's amplification ||y_L|| / ||y_0|| stays bounded for
  gamma <= 0 and small h (`forward_stability_report`);
- `gamma_sweep` trains the deep (100-step) configuration briefly at each
  gamma and reports the gradient-flow diagnostics.  Its steps go through
  the port's train step, a replayed CUDA graph on the card
  (`train.make_multi_step`), with every batch staged on the device first
  and the telemetry rows read once a gamma.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3,
)
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same
from differential_equations_resnet_tpu_torch.ops.integrators import integrate_with_trajectory
from differential_equations_resnet_tpu_torch.train.train_step import make_adam, make_multi_step


def conv_matrix_spectrum(
    params: Antisym3x3Params,
    gamma: float,
    height: int,
    width: int,
) -> Dict[str, np.ndarray]:
    """The doubly-blocked Toeplitz matrix M of the convolution (stride 1,
    SAME) of the materialized kernel, its eigenvalues and its antisymmetry
    defect max |M + M^T - 2*gamma*I|, all in float64 on the host.  For an
    exactly antisymmetric kernel ``real_part_error`` (max |Re(z) - gamma|)
    and ``antisymmetry_defect`` are ~0."""
    channels = params.a.shape[-1]
    n = height * width * channels
    with torch.no_grad():
        kernel = materialize_3x3(Antisym3x3Params(*[
            None if t is None else t.detach().cpu() for t in params]), gamma=gamma).double()
        eye = torch.eye(n, dtype=torch.float64).reshape(n, height, width, channels)
        m = conv2d_same(eye, kernel).reshape(n, n).T.numpy()
    eigenvalues = np.linalg.eigvals(m)
    defect = np.abs(m + m.T - 2.0 * gamma * np.eye(n)).max()
    return {
        "eigenvalues": eigenvalues,
        "real_part_error": np.abs(np.real(eigenvalues) - gamma).max(),
        "antisymmetry_defect": defect,
    }


def forward_stability_report(
    blocks: Antisym3x3Params,
    gamma: float,
    h: float,
    x: torch.Tensor,
    activation: str = "relu",
) -> Dict[str, np.ndarray]:
    """Integrate the stacked blocks over the input and report the state
    norm after each step and the amplification ||y_L|| / ||y_0||."""
    act = getattr(torch, activation, None) or getattr(torch.nn.functional, activation)

    def field(y, p):
        return act(conv2d_same(y, materialize_3x3(p, gamma=gamma), bias=p.bias))

    with torch.no_grad():
        _, trajectory = integrate_with_trajectory(field, x, blocks, h)
        norms = torch.linalg.vector_norm(trajectory.reshape(trajectory.shape[0], -1), dim=-1)
        norms = norms.cpu().numpy()
        n0 = float(torch.linalg.vector_norm(x))
    states = np.concatenate([[n0], norms])
    return {
        "state_norms": states,
        "amplification": norms[-1] / n0,
        "max_step_growth": float(np.max(np.diff(states) / norms.clip(min=1e-30))),
    }


def sweep_diagnostics(norms: np.ndarray, loss: float, accuracy: float) -> Dict[str, float]:
    """A gamma's row of the sweep from its grad-norm history (steps, 1 + L):
    the final loss and accuracy and the gradient-flow diagnostics over the
    residual layers (the stem's column left out, as the reference's
    notebook does)."""
    layer_norms = norms[:, 1:]
    means = layer_norms.mean(axis=1, keepdims=True)
    return {
        "final_loss": float(loss),
        "final_accuracy": float(accuracy),
        "grad_norm_relative_deviation": float(np.sqrt(np.mean((layer_norms / means) ** 2))),
        "grad_norm_std_over_layers": float(np.std(layer_norms, axis=1).mean()),
        "grad_norm_last_first_ratio": float((layer_norms[:, -1] / layer_norms[:, 0]).mean()),
    }


def gamma_sweep(
    gammas: Sequence[float],
    num_layers: int = 100,
    num_filters: int = 8,
    final_time: float = 8.0,
    train_steps: int = 50,
    batch_size: int = 32,
    num_train: int = 2048,
    seed: int = 0,
    learning_rate: float = 1e-3,
    data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[float, Dict[str, float]]:
    """Short trainings over gamma on the deep (default 100-Euler-step)
    configuration: for each gamma the final loss and accuracy and the
    gradient-flow diagnostics of its grad-norm rows (`sweep_diagnostics`).
    Batch indices are drawn from ``numpy.random.default_rng(seed)``, one
    draw a step, as the JAX package draws them; the model's parameters come
    from a torch generator seeded with ``seed`` (the same distribution as
    the JAX package's, other numbers).  Runs on CUDA unless ``device`` says
    otherwise."""
    from differential_equations_resnet_tpu_torch.data.cifar10 import synthetic_cifar10

    device = resolve_device(device)
    if data is None:
        images, labels, *_ = synthetic_cifar10(num_train, 1, seed=seed)
    else:
        images, labels = data
    results: Dict[float, Dict[str, float]] = {}
    rng = np.random.default_rng(seed)
    for gamma in gammas:
        config = cifar10_single_block_config(
            num_layers=num_layers, final_time=final_time, num_filters=num_filters,
            gamma=float(gamma), remat=True,
        )
        model = build_single_block_resnet(
            config, generator=torch.Generator().manual_seed(seed), device=device)
        multi = make_multi_step(model, make_adam(model.parameters(), learning_rate))
        idx = np.stack([rng.integers(0, len(images), size=batch_size) for _ in range(train_steps)])
        xs = torch.from_numpy(np.asarray(images[idx], dtype=np.float32)).to(device)
        ys = torch.from_numpy(np.asarray(labels[idx])).to(device)
        metrics, norms = multi(xs, ys, [learning_rate] * train_steps)
        results[float(gamma)] = sweep_diagnostics(
            norms.cpu().numpy(), float(metrics["loss"][-1]),
            float(metrics["correct"][-1] / metrics["count"][-1]))
    return results
