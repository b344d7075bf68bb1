"""The port's serving export/load: it serves the JAX package's export
directories with the same probabilities, round-trips its own exactly, and
refuses what it does not serve."""

import json
import os
import pickle

import numpy as np
import jax
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.utils import serving as jax_serving
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

TOL = dict(rtol=5e-5, atol=5e-5)


def jax_export(tmp_path, layers=3, filters=8, seed=0):
    model = jax_build(jax_cifar10_config(num_layers=layers, num_filters=filters))
    params, state = model.init(jax.random.key(seed))
    out = jax_serving.export_model(
        model, str(tmp_path / "jax_export"), params=params, model_state=state,
        batch_size=4, stablehlo=False,
    )
    return out


def images(batch, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (batch, 32, 32, 3)).astype(np.float32)


def test_serves_a_jax_export_with_the_same_probabilities(tmp_path):
    export_dir = jax_export(tmp_path)
    assert os.path.isfile(os.path.join(export_dir, "params.pkl"))
    x = images(4)
    want_predict, want_manifest = jax_serving.load_exported(export_dir)
    predict, manifest = load_exported(export_dir, device="cpu")
    assert manifest == want_manifest
    np.testing.assert_allclose(predict(x), want_predict(x), **TOL)
    # Any batch size, not just the exported one.
    assert predict(x[:1]).shape == (1, 10)


def test_jax_export_ignores_the_stablehlo_artifact(tmp_path):
    model = jax_build(jax_cifar10_config(num_layers=2, num_filters=4))
    params, state = model.init(jax.random.key(1))
    export_dir = jax_serving.export_model(
        model, str(tmp_path / "hlo"), params=params, model_state=state, batch_size=2,
    )
    assert os.path.isfile(os.path.join(export_dir, "forward.hlo"))
    x = images(2, seed=1)
    predict, _ = load_exported(export_dir, device="cpu")
    np.testing.assert_allclose(predict(x), np.asarray(model.apply(params, state, x)[0]), **TOL)


def test_own_export_round_trip_is_exact(tmp_path):
    model = build_single_block_resnet(
        cifar10_single_block_config(num_layers=4, num_filters=8),
        generator=torch.Generator().manual_seed(2), device="cpu",
    )
    export_dir = export_model(model, str(tmp_path / "port_export"), batch_size=3)
    with open(os.path.join(export_dir, "config.json")) as f:
        manifest = json.load(f)
    assert manifest["family"] == "single_block" and manifest["batch_size"] == 3
    assert manifest["config"]["compute_dtype"] == "float32"
    predict, _ = load_exported(export_dir, device="cpu")
    x = images(3, seed=2)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    # At the exported batch the compiled forward.pt2 serves, bit for bit.
    np.testing.assert_array_equal(predict(x), want)
    assert predict.routes == {"compiled": 1, "rebuilt": 0}
    rebuilt, _ = load_exported(export_dir, prefer_stablehlo=False, device="cpu")
    np.testing.assert_array_equal(rebuilt(x), want)


def test_int8_manifest_is_served(tmp_path):
    """An export marked int8 (which raised naming ROADMAP A13 before the
    port served int8) is served by the quantized forward: at 4 filters,
    under the 128 gate, that is the fp model's answer, bit for bit.  The
    port's own int8 export records the mark; another quantize value
    raises."""
    export_dir = jax_export(tmp_path, layers=2, filters=4)
    path = os.path.join(export_dir, "config.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["quantize"] = "int8"
    with open(path, "w") as f:
        json.dump(manifest, f)
    predict, manifest = load_exported(export_dir, device="cpu")
    fp_predict, _ = load_exported(jax_export(tmp_path / "fp", layers=2, filters=4), device="cpu")
    x = images(2, seed=3)
    assert manifest["quantize"] == "int8"
    np.testing.assert_array_equal(predict(x), fp_predict(x))
    model = build_single_block_resnet(
        cifar10_single_block_config(num_layers=2, num_filters=4),
        generator=torch.Generator(), device="cpu",
    )
    out = export_model(model, str(tmp_path / "int8"), quantize="int8")
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["quantize"] == "int8"
    with pytest.raises(ValueError, match="quantize"):
        export_model(model, str(tmp_path / "int4"), quantize="int4")


def test_other_families_raise(tmp_path):
    """A manifest of a family the port does not know raises; "bottleneck"
    is served (tests/test_torch_bottleneck_training.py)."""
    export_dir = jax_export(tmp_path, layers=2, filters=4)
    path = os.path.join(export_dir, "config.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["family"] = "wide_resnet"
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="unknown model family 'wide_resnet'"):
        load_exported(export_dir, device="cpu")


class _Smuggled:
    def __reduce__(self):
        return (os.getcwd, ())


def test_params_pkl_may_hold_nothing_but_parameters(tmp_path):
    export_dir = jax_export(tmp_path, layers=2, filters=4)
    with open(os.path.join(export_dir, "params.pkl"), "wb") as f:
        pickle.dump({"params": _Smuggled(), "model_state": {}}, f)
    with pytest.raises(pickle.UnpicklingError, match="getcwd"):
        load_exported(export_dir, device="cpu")
