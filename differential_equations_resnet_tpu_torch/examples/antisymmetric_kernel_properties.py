"""Antisymmetric-kernel prototype and post-training property checks — the
workflow of the reference's `antisymmetric_conv_kernel.ipynb` (layer
prototype, a short fit, then kernel slices to confirm that
skew-centrosymmetry survives optimization) and the v6 notebook's
channel-antisymmetry check (kernel[:, :, i, j] against kernel[:, :, j, i]).

Port of the JAX package's ``examples/antisymmetric_kernel_properties.py``.
The checks are numeric assertions on the materialized (3, 3, C, C) kernels:

  1. spatial skew-centrosymmetry of every diagonal block,
  2. kernel[:, :, i, j] == -rot180(kernel[:, :, j, i]) for off-diagonal pairs,
  3. the centre of every diagonal block == gamma,
  4. the doubly-blocked Toeplitz matrix M of the conv satisfies
     M + M^T = 2*gamma*I (every eigenvalue's real part is gamma), the
     Haber-Ruthotto stability condition,

before and after a short fit on seeded synthetic CIFAR-10 (4 layers x 8
filters by default: on the card the stack trains on the fused kernels B1
and B2).  The structure is parametric, so optimization cannot break it.

    python -m differential_equations_resnet_tpu_torch.examples.antisymmetric_kernel_properties
"""

import argparse

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.data.cifar10 import synthetic_cifar10
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.ops.antisymmetric import materialize_3x3_stacked
from differential_equations_resnet_tpu_torch.train import Training


def conv_toeplitz_matrix(kernel: np.ndarray, height: int, width: int) -> np.ndarray:
    """The doubly-blocked Toeplitz matrix of a stride-1 SAME conv with the
    HWIO ``kernel`` on a (height, width) grid."""
    k, _, c_in, c_out = kernel.shape
    pad = k // 2
    n = height * width
    m = np.zeros((n * c_out, n * c_in))
    for oy in range(height):
        for ox in range(width):
            for dy in range(k):
                for dx in range(k):
                    iy, ix = oy + dy - pad, ox + dx - pad
                    if 0 <= iy < height and 0 <= ix < width:
                        out_base = (oy * width + ox) * c_out
                        in_base = (iy * width + ix) * c_in
                        m[out_base:out_base + c_out, in_base:in_base + c_in] += kernel[dy, dx].T
    return m


def _center_only() -> np.ndarray:
    z = np.zeros((3, 3))
    z[1, 1] = 1.0
    return z


def check_kernel_properties(kernel: np.ndarray, gamma: float, label: str) -> None:
    """Assert the four properties of one (3, 3, C, C) kernel; raises
    AssertionError where one fails."""
    c = kernel.shape[-1]
    for i in range(c):  # 1 and 3: diagonal blocks
        block = kernel[:, :, i, i]
        np.testing.assert_allclose(block + block[::-1, ::-1], 2 * gamma * _center_only(),
                                   atol=1e-6)
        assert abs(block[1, 1] - gamma) < 1e-6, f"centre {block[1, 1]} != gamma {gamma}"
    for i in range(c):  # 2: channel pairs
        for j in range(i + 1, c):
            np.testing.assert_allclose(kernel[:, :, i, j], -kernel[::-1, ::-1, j, i], atol=1e-6)
    m = conv_toeplitz_matrix(kernel, 6, 6)  # 4: on a small grid
    np.testing.assert_allclose(m + m.T, 2 * gamma * np.eye(m.shape[0]), atol=1e-5)
    eig_real = np.linalg.eigvals(m).real
    print(f"  [{label}] all {c}x{c} channel pairs skew-consistent; "
          f"Re(eig(M)) in [{eig_real.min():+.2e}, {eig_real.max():+.2e}] (gamma={gamma})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--num-filters", type=int, default=8)
    parser.add_argument("--gamma", type=float, default=0.02)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    model = build_single_block_resnet(
        cifar10_single_block_config(num_layers=args.num_layers, num_filters=args.num_filters,
                                    gamma=args.gamma),
        generator=torch.Generator().manual_seed(0), device=args.device,
    )
    train_x, train_y, test_x, test_y, _ = synthetic_cifar10(1024, 256, seed=0)
    trainer = Training(model, train_features=train_x, train_labels=train_y,
                       val_features=test_x, val_labels=test_y, batch_size=32,
                       record_summaries=False)

    def kernels_of():
        blocks = model.params()["stages"][0]["blocks"]
        with torch.no_grad():
            return materialize_3x3_stacked(blocks, args.gamma).cpu().numpy()

    print("before training:")
    check_kernel_properties(kernels_of()[0], args.gamma, "layer 0, init")
    trainer.train(epochs=1, steps_per_epoch=args.steps,
                  learning_rate_schedule=lambda s: 1e-3, eval_steps=4)
    print("after training (structure is parametric — preserved exactly):")
    dense = kernels_of()
    for layer in (0, len(dense) - 1):
        check_kernel_properties(dense[layer], args.gamma, f"layer {layer}, trained")
    print("kernel[:, :, 1, 1] =\n", dense[0][:, :, 1, 1])
    if dense.shape[-1] > 3:
        print("kernel[:, :, 1, 3] =\n", dense[0][:, :, 1, 3])
        print("-rot180(kernel[:, :, 3, 1]) =\n", -dense[0][::-1, ::-1, 3, 1])
    trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
