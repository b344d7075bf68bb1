"""The port's experiments against the JAX package's: the conv-matrix
spectrum and the forward stability report on the same parameters, the gamma
sweep's diagnostics on one fixed grad-norm history, and tiny gamma and
width x depth sweeps on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import differential_equations_resnet_tpu.train as jax_train
from differential_equations_resnet_tpu import experiments as jax_experiments
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.parallel import create_mesh
from differential_equations_resnet_tpu_torch import experiments
from differential_equations_resnet_tpu_torch.experiments import deep_stability
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.flops import PEAK_FLOPS

from torch_parity import both_packed, euler_case, packed_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("gamma", [0.0, 0.2])
def test_conv_matrix_spectrum_matches_jax(gamma):
    """On the same packed params (4 channels, 4x4 grid): the eigenvalues,
    sorted, to 1e-5 (the JAX package builds M in fp32, the port in
    float64 from the fp32 kernel, whose gamma centre is gamma rounded to
    fp32); the real-part error and the antisymmetry defect ~0 in both."""
    p_jax, p_torch = both_packed(packed_leaves(np.random.default_rng(1), 4))
    want = jax_experiments.conv_matrix_spectrum(p_jax, gamma, 4, 4)
    got = experiments.conv_matrix_spectrum(p_torch, gamma, 4, 4)
    assert got["eigenvalues"].shape == want["eigenvalues"].shape == (64,)
    order = lambda z: z[np.lexsort((np.round(z.imag, 5), np.round(z.real, 5)))]
    np.testing.assert_allclose(order(got["eigenvalues"]), order(want["eigenvalues"]), atol=1e-5)
    assert got["real_part_error"] < 1e-8 and want["real_part_error"] < 1e-5
    assert got["antisymmetry_defect"] < 1e-8 and want["antisymmetry_defect"] < 1e-5


def test_forward_stability_report_matches_jax():
    """The state norms of 3 layers at 8x8x8 (batch 4), the amplification and
    the largest step growth, to 1e-5 relative."""
    (x_j, blocks_j), (x_t, blocks_t) = euler_case(seed=2)
    want = jax_experiments.forward_stability_report(blocks_j, 0.05, 0.125, x_j)
    got = experiments.forward_stability_report(blocks_t, 0.05, 0.125, x_t)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["state_norms"], np.asarray(want["state_norms"]), rtol=1e-5)
    np.testing.assert_allclose(got["amplification"], float(want["amplification"]), rtol=1e-5)
    np.testing.assert_allclose(got["max_step_growth"], want["max_step_growth"], rtol=1e-4, atol=1e-7)


def test_gamma_sweep_diagnostics_equal_jax_on_a_fixed_history(monkeypatch):
    """Both sweeps fed the same grad-norm rows and metrics (each package's
    train step replaced by one that returns them): the same final loss and
    accuracy and the same three diagnostics, to 1e-6 relative."""
    steps, layers = 4, 3
    history = np.random.default_rng(3).uniform(0.1, 2.0, (2, steps, 1 + layers)).astype(np.float32)
    losses = [[2.5, 2.0, 1.5, 1.25], [3.0, 2.5, 2.25, 2.0]]
    corrects = [[1.0, 2.0, 3.0, 3.0], [0.0, 1.0, 1.0, 2.0]]

    def jax_make_train_step(model, tx, **_):
        calls = []

        def step(state, images, labels, lr):
            g, i = len(jax_make_train_step.built) - 1, len(calls)
            calls.append(i)
            metrics = {"loss": jnp.float32(losses[g][i]), "correct": jnp.float32(corrects[g][i]),
                       "count": jnp.float32(4)}
            return state, metrics, jnp.asarray(history[g, i])

        jax_make_train_step.built.append(step)
        return step

    jax_make_train_step.built = []
    monkeypatch.setattr(jax_train, "make_train_step", jax_make_train_step)
    want = jax_experiments.gamma_sweep([0.0, 0.1], num_layers=layers, num_filters=4,
                                       train_steps=steps, batch_size=4, num_train=16)

    built = []

    def make_multi_step(model, optimizer):
        g = len(built)
        built.append(g)

        def multi(images, labels, lrs):
            assert images.shape == (steps, 4, 32, 32, 3) and len(lrs) == steps
            metrics = {"loss": torch.tensor(losses[g]), "correct": torch.tensor(corrects[g]),
                       "count": torch.full((steps,), 4.0)}
            return metrics, torch.from_numpy(history[g])

        return multi

    monkeypatch.setattr(deep_stability, "make_multi_step", make_multi_step)
    got = experiments.gamma_sweep([0.0, 0.1], num_layers=layers, num_filters=4, train_steps=steps,
                                  batch_size=4, num_train=16, device="cpu")
    assert list(got) == list(want) == [0.0, 0.1]
    for gamma in want:
        assert set(got[gamma]) == set(want[gamma])
        for key, value in want[gamma].items():
            np.testing.assert_allclose(got[gamma][key], value, rtol=1e-6, err_msg=key)


def test_tiny_gamma_sweep_on_the_cpu():
    """The real sweep at 2 layers x 4 filters, 3 steps at batch 4: the JAX
    sweep's keys, finite values, one row per gamma."""
    got = experiments.gamma_sweep([0.0, 0.05], num_layers=2, num_filters=4, train_steps=3,
                                  batch_size=4, num_train=32, device="cpu")
    assert list(got) == [0.0, 0.05]
    for row in got.values():
        assert set(row) == {"final_loss", "final_accuracy", "grad_norm_relative_deviation",
                            "grad_norm_std_over_layers", "grad_norm_last_first_ratio"}
        assert all(np.isfinite(v) for v in row.values())
        assert 0.0 <= row["final_accuracy"] <= 1.0


def test_imagenet32_config():
    """The JAX package's workload, in its default bf16 compute (which raised
    naming ROADMAP A5 before the port computed in bf16), and in fp32 when
    asked."""
    want = jax_experiments.imagenet32_config(num_layers=8, num_filters=32)
    got = experiments.imagenet32_config(num_layers=8, num_filters=32)
    assert got == config_from_json(_config_to_json(want))
    assert got.compute_dtype == torch.bfloat16 and got.num_classes == 1000 and got.h == 1.0
    want = jax_experiments.imagenet32_config(num_layers=8, num_filters=32, compute_dtype=jnp.float32)
    got = experiments.imagenet32_config(num_layers=8, num_filters=32, compute_dtype=torch.float32)
    assert got == config_from_json(_config_to_json(want))


def test_tiny_width_depth_sweep_on_the_cpu():
    """Every grid point's throughput row, in bf16 by default as the JAX
    package's sweep, its MFU against the bf16 peak (against the fp32 peak
    for an fp32 sweep); over a one-rank mesh, its MFU divided over the
    mesh's size as in the JAX package."""
    keys = {"steps_per_sec", "images_per_sec", "step_ms", "model_tflops"}
    got = experiments.width_depth_sweep(widths=(4,), depths=(1, 2), batch_size=2, num_classes=10,
                                        steps=2, device="cpu")
    assert list(got) == [(4, 1), (4, 2)]
    for row in got.values():
        assert set(row) == keys | {"mfu_vs_bf16_peak"}
        assert all(np.isfinite(v) and v > 0 for v in row.values())
        assert row["images_per_sec"] == pytest.approx(2 * row["steps_per_sec"])
        assert row["mfu_vs_bf16_peak"] == pytest.approx(
            row["model_tflops"] * 1e12 / PEAK_FLOPS["h100_sxm_bf16"])
    fp32 = experiments.width_depth_sweep(widths=(4,), depths=(1,), batch_size=2, num_classes=10,
                                         steps=2, compute_dtype=torch.float32, device="cpu")
    assert set(fp32[(4, 1)]) == keys | {"mfu_vs_fp32_peak"}
    mesh = create_mesh((1,), ("data",), device_type="cpu")
    meshed = experiments.width_depth_sweep(widths=(4,), depths=(1,), batch_size=2, num_classes=10,
                                           steps=2, mesh=mesh)
    row = meshed[(4, 1)]
    assert set(row) == keys | {"mfu_vs_bf16_peak"}
    assert row["mfu_vs_bf16_peak"] == pytest.approx(
        row["model_tflops"] * 1e12 / PEAK_FLOPS["h100_sxm_bf16"] / mesh.size())
