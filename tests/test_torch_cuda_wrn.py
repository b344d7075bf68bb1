"""The WRN-40-4 configuration (``perfbench/configs/wrn-40-4-antisym-cifar10.
json``: Zagoruyko and Komodakis's layout with the antisymmetric Euler step,
widths 64, 128 and 256, batch 128) on the card.

Its captured train step holds the band B1 at 32x32x64 (16 bands an image,
in groups of the images the card holds at once), the wide B1 at
16x16x128, the 8x8x256 stack layer by layer on cuDNN (past the kernels'
reach of C <= 128), and the wide B2 at 16x16x128 and 32x32x64: the port's
record of hand-kernel calls (`utils.tracing.STACKS`) lists the five in
that order, and each replay adds the wide variants' launches, L for B1 and
3L for B2.  The first step's loss at batch 8 agrees with the benchmark's
plain reference.  Every test needs a CUDA device and skips itself without
one.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wrn.py
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import make_adam, make_multi_step
from differential_equations_resnet_tpu_torch.train import make_train_step
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import program, reference  # noqa: E402

pytestmark = pytest.mark.cuda

BATCH, SEED = 128, 3_250_000_017
CELL_LIMITS = ROOT / "perfbench" / "cells" / "wrn-40-4.train-resident.json"


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs);
    TF32 off for the reference's convolutions; the record cleared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    STACKS.clear()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield
    STACKS.clear()


def configuration() -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / "wrn-40-4-antisym-cifar10.json")
                      .read_text())


def batch(n: int, steps: int = 1):
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 255, (steps, n, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (steps, n)))
    return images.cuda(), labels.cuda()


def band_b1():
    """(bands an image, launches) of the band B1 at 32x32x64, batch 128."""
    bands = fi.kernel_bands((BATCH, 32, 32, 64))
    return bands, -(-BATCH // fi.resident_images(32, 32, 64, bands))


def test_the_captured_step_records_every_stack_on_its_route(card):
    model, _ = program.build(configuration(), SEED, "cuda")
    multi = make_multi_step(model, make_adam(model.parameters()))
    images, labels = batch(BATCH)
    metrics, _ = multi(images, labels, [1e-3])
    assert torch.isfinite(metrics["loss"]).all()
    bands, launches = band_b1()
    assert bands == 16
    want = [StackEntry("B1", (32, 32, 64, 12), "band", bands, launches),
            StackEntry("B1", (16, 16, 128, 11), "wide", 0, 11),
            StackEntry("per_layer", (8, 8, 256, 11), "direct", 0, 0),
            StackEntry("B2", (16, 16, 128, 11), "wide", 0, 33),
            StackEntry("B2", (32, 32, 64, 12), "wide", 0, 36)]
    assert STACKS.graph("train step") == want
    STACKS.reset()
    metrics, _ = multi(images, labels, [1e-3])  # one replay, no capture
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]).all()
    assert (STACKS.launches("B1", "wide"), STACKS.launches("B2", "wide")) == (11, 69)
    assert (STACKS.calls("B1", "wide"), STACKS.calls("B2", "wide")) == (1, 2)
    assert (STACKS.launches("B1", "band"), STACKS.launches("B2", "band")) == (launches, 0)
    assert (STACKS.calls("per_layer", "direct"), STACKS.launches("per_layer")) == (1, 0)


def test_the_first_loss_matches_the_plain_reference(card):
    config = configuration()
    model, shapes = program.build(config, SEED, "cuda")
    images, labels = batch(8)
    metrics, _ = make_train_step(model, make_adam(model.parameters()))(images[0], labels[0],
                                                                        1e-3)
    got = float(metrics["loss"])
    weights = program.initial_weights(config, shapes, SEED, "cuda")
    want = reference.first_steps(config["family"], config["model"], weights, {},
                                 lambda t: (images[0], labels[0]), 1e-3, 1e-7, steps=1)
    limit = json.loads(CELL_LIMITS.read_text())["limits"]["loss1"]
    assert abs(got - want["loss"][0]) / abs(want["loss"][0]) <= limit
