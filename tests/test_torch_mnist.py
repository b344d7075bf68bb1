"""The port's MNIST module (`data/mnist.py`) against the JAX package's: the
IDX reader and the synthetic fallback give the same bytes, the
single-block MNIST config is the JAX package's (with ``s2d_block=0`` on
both sides: the port does not default to the JAX package's TPU-chosen 2),
and the model at 2 layers x 4 filters gives the JAX package's logits and
train step from the same parameters."""

import gzip
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.data import mnist as jax_mnist
from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.train import (
    create_train_state as jax_create_train_state,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.data import mnist
from differential_equations_resnet_tpu_torch.examples import mnist_smoke
from differential_equations_resnet_tpu_torch.train import create_train_state, make_train_step
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

from torch_parity import jax_params_with_biases, norm_rel, port_model

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core, and small CPU
    convolutions slow down many times over when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_idx(path, arr, magic, compress):
    dims = arr.shape if magic == 2051 else (len(arr),)
    payload = struct.pack(">I" + "I" * len(dims), magic, *dims) + arr.tobytes()
    with (gzip.open if compress else open)(str(path) + (".gz" if compress else ""), "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "gzip"])
def test_idx_round_trip_matches_jax(tmp_path, compress):
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("t10k", 5)):
        write_idx(tmp_path / f"{split}-images-idx3-ubyte",
                  rng.integers(0, 256, (n, 28, 28)).astype(np.uint8), 2051, compress)
        write_idx(tmp_path / f"{split}-labels-idx1-ubyte",
                  rng.integers(0, 10, n).astype(np.uint8), 2049, compress)
    assert mnist.find_mnist_directory(extra=(str(tmp_path),)) == str(tmp_path)
    assert jax_mnist.find_mnist_directory(extra=(str(tmp_path),)) == str(tmp_path)
    got, want = mnist.build_mnist_dataset(str(tmp_path)), jax_mnist.build_mnist_dataset(str(tmp_path))
    assert got[0].shape == (12, 28, 28, 1) and got[2].shape == (5, 28, 28, 1)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[4] == want[4]
    (tmp_path / "bad").write_bytes(struct.pack(">I", 1234))
    for module in (mnist, jax_mnist):
        with pytest.raises(ValueError, match="unrecognized IDX magic 1234"):
            module._read_idx(str(tmp_path / "bad"))
    assert mnist.find_mnist_directory(extra=(str(tmp_path / "missing"),)) is None


def test_synthetic_mnist_is_byte_equal_to_jax():
    got, want = mnist.synthetic_mnist(50, 20, seed=3), jax_mnist.synthetic_mnist(50, 20, seed=3)
    for a, b in zip(got[:4], want[:4]):
        assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[4] == want[4]


def jax_config(**kwargs):
    return jax_mnist.mnist_single_block_config(s2d_block=0, **kwargs)


@pytest.mark.parametrize("kwargs", [{}, dict(num_layers=2, num_filters=4, kernel_type="regular",
                                             final_time=2.0)])
def test_config_is_the_jax_packages_without_its_s2d_default(kwargs):
    config = mnist.mnist_single_block_config(**kwargs)
    assert config == config_from_json(_config_to_json(jax_config(**kwargs)), "single_block")
    assert config.s2d_block == 0 and config.image_shape == (28, 28, 1)
    assert jax_mnist.mnist_single_block_config(**kwargs).s2d_block == 2


def mnist_batch(batch=4, seed=0):
    images, labels, *_ = mnist.synthetic_mnist(batch, 1, seed=seed)
    return images.astype(np.float32), labels


def test_logits_match_jax():
    config = jax_config(num_layers=2, num_filters=4)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, seed=1)
    model = port_model(config, params)
    images, _ = mnist_batch(batch=5)
    want, _ = jax_model.apply(params, state, jnp.asarray(images), train=False, return_logits=True)
    with torch.no_grad():
        got = model(torch.from_numpy(images), return_logits=True)
    assert got.shape == (5, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_train_step_matches_jax():
    """One step at batch 4 from the same parameters: loss within 1e-5, the
    grad-norm row within 1e-3 (relative), correct equal."""
    config = jax_config(num_layers=2, num_filters=4)
    jax_model = jax_build(config)
    params, _ = jax_params_with_biases(jax_model, seed=2)
    tx = jax_make_adam()
    state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    state = state._replace(params=params, opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False)
    model = port_model(config, params)
    state_t = create_train_state(model)
    port_step = make_train_step(state_t.model, state_t.optimizer)
    images, labels = mnist_batch(seed=4)
    _, jax_metrics, jax_norms = jax_step(state, jnp.asarray(images), jnp.asarray(labels), LR)
    metrics, norms = port_step(torch.from_numpy(images), torch.from_numpy(labels), LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    assert float(metrics["correct"]) == float(jax_metrics["correct"])
    assert norms.shape == np.asarray(jax_norms).shape == (3,)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-3)
    assert norm_rel(norms.numpy(), np.asarray(jax_norms)) < 1e-3


def test_mnist_example_fits_evaluates_and_predicts_on_the_cpu(capsys):
    assert mnist_smoke.main(["--device", "cpu", "--num-layers", "2", "--num-filters", "4",
                             "--synthetic-train-size", "64", "--synthetic-test-size", "32",
                             "--steps-per-epoch", "2", "--batch-size", "16"]) == 0
    out = capsys.readouterr().out
    assert "# test loss" in out
    probs = [float(line.split("\t")[1]) for line in out.splitlines() if line.startswith("#   ")]
    assert len(probs) == 10 and abs(sum(probs) - 1) < 1e-3
