"""The port's regular and centrosymmetric kernel types and its midpoint and
RK4 integrators against the JAX package: the model's forward against JAX
`apply` and 3 train steps against JAX `make_train_step` (loss, correct
count, grad-norm row, parameters after Adam), with remat on and off; the
routes the identity stack takes; depth doubling, the pickle round trip and
the reference weight format, the 8L8F golden fixture included."""

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import blocks as jax_blocks
from differential_equations_resnet_tpu.models import (
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu.train import (
    create_train_state as jax_create_train_state,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.utils import weight_utils as jax_weight_utils
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.models.blocks import ConvParams, l2_kernel_penalty
from differential_equations_resnet_tpu_torch.ops.antisymmetric import AntisymKxKParams
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step
from differential_equations_resnet_tpu_torch.utils import weight_utils
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

from golden.make_golden import fixture_config
from torch_parity import jax_params_with_biases, norm_rel, port_model

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=5e-5, atol=5e-5)  # tests/test_golden_fixture.py's bound
LR = 1e-3
# The JAX package's parameter classes, by name, for `params_to_jax`.
JAX_CLASSES = {
    "ConvParams": jax_blocks.ConvParams,
    "DenseParams": jax_blocks.DenseParams,
    "Antisym3x3Params": jax_antisym.Antisym3x3Params,
    "AntisymKxKParams": jax_antisym.AntisymKxKParams,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (kernel type, kernel size, integrator, remat)
CASES = [
    ("regular", 3, "euler", False),
    ("regular", 3, "euler", True),
    ("centrosymmetric", 3, "euler", False),
    ("centrosymmetric", 5, "euler", False),
    ("centrosymmetric", 5, "euler", True),
    ("antisymmetric", 3, "midpoint", False),
    ("antisymmetric", 3, "rk4", True),
    ("regular", 3, "midpoint", True),
    ("regular", 5, "rk4", False),
    ("centrosymmetric", 3, "rk4", False),
]
IDS = [f"{t}-k{k}-{i}{'-remat' if r else ''}" for t, k, i, r in CASES]


def config_of(kernel_type, k, integrator, remat, layers=2, filters=4, **kw):
    """A small CIFAR-10 config at the headline step size h = 8/64."""
    return jax_cifar10_config(num_layers=layers, final_time=0.125 * layers, num_filters=filters,
                              kernel_type=kernel_type, kernel_size=k, integrator=integrator,
                              remat=remat, s2d_block=0, **kw)


def batches(steps, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(steps)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_jax_apply(case):
    """Logits and probabilities at 2L x 4F, batch 2, against JAX apply on
    the same parameters, to 5e-5 (the golden fixture's bound)."""
    config = config_of(*case)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 3)
    model = port_model(config, params)
    x = np.random.default_rng(3).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        for logits in (True, False):
            want, _ = jax_model.apply(params, state, jnp.asarray(x), return_logits=logits)
            np.testing.assert_allclose(model(torch.from_numpy(x), return_logits=logits).numpy(),
                                       np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_three_train_steps_match_jax(case):
    """3 steps at 2L x 4F, batch 4, from the same params (L2 on, so the
    packed k x k leaves' penalty is in it): loss and grad-norm row to 1e-4
    relative, correct and count exactly, every parameter after each Adam
    update elementwise to 2e-6 (tests/test_torch_train.py's bounds)."""
    config = config_of(*case, l2_regularization=1e-3)
    jax_model = jax_build(config)
    params, _ = jax_params_with_biases(jax_model, 1)
    tx = jax_make_adam()
    state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    state = state._replace(params=params, opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False)
    model = port_model(config, params)
    step = make_train_step(model, make_adam(model.parameters()))
    for images, labels in batches(3):
        state, jax_metrics, jax_norms = jax_step(state, jnp.asarray(images), jnp.asarray(labels), LR)
        metrics, norms = step(torch.from_numpy(images), torch.from_numpy(labels), LR)
        np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-4)
        assert float(metrics["correct"]) == float(jax_metrics["correct"])
        assert float(metrics["count"]) == float(jax_metrics["count"]) == len(images)
        assert norms.shape == (3,)
        np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
        got = jax.tree.leaves(weight_utils.params_to_jax(model.params(), JAX_CLASSES))
        want = jax.tree.leaves(state.params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=0)


def test_l2_penalty_covers_packed_kxk_leaves():
    config = config_of("centrosymmetric", 5, "euler", False)
    params, _ = jax_params_with_biases(jax_build(config), 4)
    model = port_model(config, params)
    blocks = model.params()["stages"][0]["blocks"]
    assert isinstance(blocks, AntisymKxKParams)
    np.testing.assert_allclose(float(l2_kernel_penalty(model.params(), 1e-2).detach()),
                               float(jax_blocks.l2_kernel_penalty(params, 1e-2)), rtol=1e-6)


def _route(kernel_type, k=3, integrator="euler", channels=8, grad=True, **fields):
    """The route of the stage-0 stack of a 2L x ``channels`` config (JAX
    config fields in ``fields``), with or without a gradient."""
    config = dataclasses.replace(config_from_json(_config_to_json(
        config_of(kernel_type, k, integrator, False, filters=channels))), **fields)
    blocks = sbr.init_single_block_resnet(config, torch.Generator().manual_seed(0))
    blocks = blocks["stages"][0]["blocks"]
    blocks = type(blocks)(*[None if t is None else t.requires_grad_(grad) for t in blocks])
    with torch.set_grad_enabled(grad):
        return sbr.identity_route(config, torch.zeros(2, 32, 32, channels),
                                  sbr._dense_blocks(blocks, config))


def test_routes():
    """The route is decided from the dense stack's shapes and the config,
    with or without a gradient: fused for every kernel type's 3x3 Euler
    stack within the reach, whichever variant of B1 and B2 its shape takes
    (at 32x32 C = 8 the band ones, C = 60 a wide B2, 72 and 128 both wide);
    the per-layer route for k = 5, midpoint, RK4 and C > 128, as the JAX
    package runs all of them on XLA's convolutions."""
    for kernel_type in ("antisymmetric", "regular", "centrosymmetric"):
        for grad in (True, False):
            for channels in (8, 60, 72, 128):
                assert _route(kernel_type, channels=channels, grad=grad) == "fused"
        for integrator in ("midpoint", "rk4"):
            assert _route(kernel_type, integrator=integrator) == "per_layer"
    assert _route("regular", channels=136) == "per_layer"
    for kernel_type in ("regular", "centrosymmetric"):
        assert _route(kernel_type, k=5) == "per_layer"


def test_declined_stacks_follow_the_jax_decision():
    """Batch norm always takes the per-layer route (JAX skips Pallas with
    it); a stack that needs a wide kernel variant takes the fused route
    whether or not the JAX package would run it on Pallas (use_pallas,
    antisymmetric, within its gate's reach: C <= 128)."""
    for kernel_type in ("antisymmetric", "regular"):
        for grad in (True, False):
            assert _route(kernel_type, grad=grad, use_batch_norm=True) == "per_layer"
            assert _route(kernel_type, grad=grad, use_batch_norm=True,
                          use_pallas=True) == "per_layer"
    for grad in (True, False):
        assert _route("antisymmetric", channels=72, grad=grad, use_pallas=True) == "fused"
        assert _route("antisymmetric", channels=128, grad=grad, use_pallas=True) == "fused"
        assert _route("regular", channels=72, grad=grad, use_pallas=True) == "fused"
        assert _route("regular", channels=128, grad=grad, use_pallas=True) == "fused"
        assert _route("centrosymmetric", channels=72, grad=grad, use_pallas=True) == "fused"
    assert _route("antisymmetric", channels=60, use_pallas=True) == "fused"
    assert _route("antisymmetric", channels=60, use_pallas=False) == "fused"
    assert _route("antisymmetric", channels=136, use_pallas=True) == "per_layer"
    assert _route("antisymmetric", integrator="rk4", use_pallas=True) == "per_layer"


def test_a_width_b2_declines_raises_on_the_card(monkeypatch):
    """On the card an Euler 3x3 stack at a width the band B2 declines (C =
    60 at 32x32), where a gradient is needed, no longer raises: with
    use_pallas and antisymmetric kernels, where the JAX package runs Pallas,
    it trains on B1 (band) and B2 (wide), and so does a regular one; under
    no_grad B1 alone runs.  CUDA-looking CPU tensors stand in for the
    card, with the kernels' launches recorded instead of made; B1's op is
    replaced by its CUDA kernel, which the dispatcher picks from the
    tensor's real device."""
    from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

    launched = []
    monkeypatch.setattr(fi, "_launch", lambda *args: launched.append("B1") or args[0])
    monkeypatch.setattr(fi, "fused_euler_fwd_op", fi._fused_euler_fwd_cuda)
    monkeypatch.setattr(fi, "_launch_bwd", lambda x, k, b, g, *rest: launched.append("B2") or (
        g, torch.zeros_like(k), torch.zeros_like(b)))

    def stage(kernel_type, **fields):
        config = config_from_json(_config_to_json(
            config_of(kernel_type, 3, "euler", False, filters=60, **fields)))
        blocks = sbr.init_single_block_resnet(config, torch.Generator().manual_seed(0))
        # Made dense here, off the stand-in card; a dense stack passes through.
        dense = sbr._dense_blocks(blocks["stages"][0]["blocks"], config)
        return config, {"blocks": ConvParams(*[t.detach().requires_grad_() for t in dense])}

    regular, regular_stage = stage("regular")
    pallas, pallas_stage = stage("antisymmetric", use_pallas=True)
    x = torch.zeros(2, 32, 32, 60)
    assert fi.kernel_variant(x.shape) == "band" and fi.kernel_variant(x.shape, True) == "wide"
    sbr.route_counts.update(fused=0, per_layer=0)
    with monkeypatch.context() as card:
        card.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
        y, _ = sbr._apply_identity_blocks(x, regular_stage, {}, regular, True)
        y.sum().backward()
        assert launched == ["B1", "B2"]
        launched.clear()
        y, _ = sbr._apply_identity_blocks(x, pallas_stage, {}, pallas, True)
        y.sum().backward()
        assert launched == ["B1", "B2"]
        assert pallas_stage["blocks"].kernel.grad is not None
        with torch.no_grad():
            sbr._apply_identity_blocks(x, pallas_stage, {}, pallas, False)
    assert launched == ["B1", "B2", "B1"]
    assert sbr.route_counts == {"fused": 3, "per_layer": 0}


@pytest.mark.parametrize("kernel_type,k,integrator,route", [
    ("regular", 3, "euler", "fused"),
    ("centrosymmetric", 5, "euler", "per_layer"),
    ("antisymmetric", 3, "rk4", "per_layer"),
])
def test_route_counts_follow_the_model(kernel_type, k, integrator, route):
    """A forward and a train step each count one stack on their route; on
    the CPU no kernel launches (the plain versions run)."""
    from differential_equations_resnet_tpu_torch.utils.tracing import STACKS

    config = config_from_json(_config_to_json(config_of(kernel_type, k, integrator, False)))
    model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(1), device="cpu")
    sbr.route_counts.update(fused=0, per_layer=0)
    launches = (STACKS.launches("B1"), STACKS.launches("B2"))
    (images, labels), = batches(1, batch=2)
    with torch.no_grad():
        model(torch.from_numpy(images))
    make_train_step(model, make_adam(model.parameters()))(
        torch.from_numpy(images), torch.from_numpy(labels), LR)
    assert sbr.route_counts == {"fused": 0, "per_layer": 0, route: 2}
    assert (STACKS.launches("B1"), STACKS.launches("B2")) == launches


@pytest.mark.parametrize("kernel_type,k", [("antisymmetric", 3), ("regular", 3),
                                           ("centrosymmetric", 5)])
def test_double_model_depth_matches_jax(kernel_type, k):
    """Each stacked layer twice, h halved: the same parameters and config as
    the JAX package's, and the same forward on them."""
    config = config_of(kernel_type, k, "euler", False, layers=3)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 6)
    want_params, want_config = jax_weight_utils.double_model_depth(params, config)
    model = port_model(config, params)
    got_params, got_config = weight_utils.double_model_depth(model.params(), model.config)
    assert got_config == config_from_json(_config_to_json(want_config))
    assert got_config.blocks_per_stage == (6,) and got_config.h == config.h / 2
    got = jax.tree.leaves(weight_utils.params_to_jax(got_params, JAX_CLASSES))
    want = jax.tree.leaves(want_params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    doubled = build_single_block_resnet(got_config, params=got_params, device="cpu")
    x = np.random.default_rng(6).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want_out, _ = jax_build(want_config).apply(want_params, state, jnp.asarray(x), return_logits=True)
    with torch.no_grad():
        np.testing.assert_allclose(doubled(torch.from_numpy(x), return_logits=True).numpy(),
                                   np.asarray(want_out), **TOL)


@pytest.mark.parametrize("kernel_type,k", [("antisymmetric", 3), ("regular", 3),
                                           ("centrosymmetric", 3), ("centrosymmetric", 5)])
def test_reference_format_round_trip_matches_jax(kernel_type, k):
    """export_reference_weights gives the JAX package's list of {kernel,
    bias} arrays bit for bit; import_reference_weights gives back the
    parameters (bit for bit) and the JAX package's import of the same
    list."""
    config = config_of(kernel_type, k, "euler", False, layers=3, gamma=0.05)
    params, _ = jax_params_with_biases(jax_build(config), 7)
    model = port_model(config, params)
    got = weight_utils.export_reference_weights(model.params(), model.config)
    want = jax_weight_utils.export_reference_weights(params, config)
    assert len(got) == len(want) == 1 + 3 + 1
    for g, w in zip(got, want):
        assert set(g) == {"kernel", "bias"}
        np.testing.assert_array_equal(g["kernel"], np.asarray(w["kernel"]))
        np.testing.assert_array_equal(g["bias"], np.asarray(w["bias"]))
    back = weight_utils.import_reference_weights(got, model.params(), model.config)
    jax_back = jax_weight_utils.import_reference_weights(want, params, config)
    for g, w, p in zip(jax.tree.leaves(weight_utils.params_to_jax(back, JAX_CLASSES)),
                       jax.tree.leaves(jax_back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w))
        if kernel_type != "antisymmetric":  # the antisymmetric centre is gamma, not a leaf
            np.testing.assert_array_equal(g, np.asarray(p))


def test_golden_fixture_through_reference_import():
    """The 8L8F reference-format fixture through the port's own
    import_reference_weights (no JAX in the path): logits and probabilities
    against the fp64 oracle to 5e-5, and export gives the fixture back."""
    with open(os.path.join(GOLDEN_DIR, "reference_weights_8L8F.pkl"), "rb") as f:
        weights = pickle.load(f)
    x = np.load(os.path.join(GOLDEN_DIR, "input_batch.npy"))
    config = config_from_json(_config_to_json(fixture_config()))
    template = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                         device="cpu")
    params = weight_utils.import_reference_weights(weights, template.params(), config)
    model = build_single_block_resnet(config, params=params, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x), return_logits=True).numpy(),
                                   np.load(os.path.join(GOLDEN_DIR, "expected_logits_fp64.npy")), **TOL)
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   np.load(os.path.join(GOLDEN_DIR, "expected_probs_fp64.npy")), **TOL)
    exported = weight_utils.export_reference_weights(params, config)
    for g, w in zip(exported, weights):
        np.testing.assert_allclose(g["kernel"], w["kernel"], rtol=0, atol=1e-7)
        np.testing.assert_array_equal(g["bias"], w["bias"])


def test_pickles_of_both_packages(tmp_path):
    """pickle_model_weights / load_pickled_weights round trip bit for bit;
    a JAX-written pickle loads through the restricted unpickler; and
    double_load_weights equals the JAX package's."""
    config = config_of("centrosymmetric", 3, "euler", False)
    params, _ = jax_params_with_biases(jax_build(config), 8)
    model = port_model(config, params)
    weight_utils.pickle_model_weights(model.params(), str(tmp_path / "port.pkl"))
    jax_weight_utils.pickle_model_weights(params, str(tmp_path / "jax.pkl"))
    for name in ("port.pkl", "jax.pkl"):
        loaded = weight_utils.params_from_jax(weight_utils.load_pickled_weights(str(tmp_path / name)))
        assert isinstance(loaded["stages"][0]["blocks"], AntisymKxKParams)
        assert isinstance(loaded["stem"], ConvParams)
        got = dict(build_single_block_resnet(model.config, params=loaded, device="cpu").state_dict())
        for key, value in model.state_dict().items():
            assert torch.equal(got[key], value), (name, key)
    got = weight_utils.double_load_weights(None, str(tmp_path / "jax.pkl"))
    want = jax_weight_utils.double_load_weights(None, str(tmp_path / "jax.pkl"))
    for g, w in zip(jax.tree.leaves(weight_utils.params_to_jax(
            weight_utils.params_from_jax(got), JAX_CLASSES)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    doubled, new_config = weight_utils.double_load_weights(None, str(tmp_path / "port.pkl"),
                                                           model.config)
    assert new_config.blocks_per_stage == (4,)
    assert norm_rel(doubled["stages"][0]["blocks"].diag[1], params["stages"][0]["blocks"].diag[0]) == 0
    # Anything but parameter classes and NumPy arrays is refused.
    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump({"x": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError):
        weight_utils.load_pickled_weights(str(tmp_path / "evil.pkl"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flop_counts_match_jax(case):
    """The model FLOP count (field evaluations x k*k) equals the JAX
    package's for every kernel type, kernel size and integrator."""
    from differential_equations_resnet_tpu.utils import flops as jax_flops
    from differential_equations_resnet_tpu_torch.utils import flops

    config = config_of(*case, layers=64, filters=16)
    port_config = config_from_json(_config_to_json(config))
    for batch in (1, 32):
        assert flops.single_block_train_flops(port_config, batch) == \
            jax_flops.single_block_train_flops(config, batch)


@pytest.mark.parametrize("kernel_type,k", [("regular", 3), ("centrosymmetric", 5)])
def test_serves_jax_exports_of_other_kernel_types(tmp_path, kernel_type, k):
    """A JAX package export (config.json + params.pkl) of a regular or
    centrosymmetric model loads through the restricted unpickler and
    predicts what the JAX package's loader predicts, to 5e-5."""
    from differential_equations_resnet_tpu.utils import serving as jax_serving
    from differential_equations_resnet_tpu_torch.utils.serving import load_exported

    config = config_of(kernel_type, k, "euler", False)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 10)
    export_dir = jax_serving.export_model(jax_model, str(tmp_path / "jax"), params=params,
                                          model_state=state, batch_size=2, stablehlo=False)
    predict, manifest = load_exported(export_dir, device="cpu")
    assert manifest["config"]["kernel_type"] == kernel_type
    want_predict, _ = jax_serving.load_exported(export_dir)
    x = np.random.default_rng(10).uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(predict(x), np.asarray(want_predict(x)), **TOL)
