"""The port's device meshes on gloo CPU ranks (parallel/mesh.py and
`mesh=` of the train-step builders) against the JAX package on its
virtual CPU mesh.

Four ranks stand in for the four devices of a JAX ``data`` mesh.  They are
spawned once for the whole file (tests/torch_dist.py) and run every case
(tests/torch_mesh_cases.py); each test below compares its case with the
JAX package's step over ``create_mesh((4,), ("data",))``, at PERF.md §2's
bounds: the loss to 1e-5, the grad-norm row to 1e-3 (both relative),
correct and count exactly, the parameters after to 1e-3.  The
device-resident epoch, evaluation and prediction are held against the
port's own meshless loops (the epoch's order is drawn by torch)."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.models import cifar10_single_block_config
from differential_equations_resnet_tpu_torch.parallel import initialize_multihost, local_batch_slice
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_from_jax, state_from_jax

import torch_mesh_cases
from torch_dist import run_ranks
from torch_parity import (
    assert_params_close,
    assert_rows_close,
    assert_trees_close,
    case_result,
    jax_mesh,
    jax_params_and_state,
    jax_params_with_biases,
    jax_train,
    port_config_of,
    to_numpy,
)

WORLD = 4
LR = 1e-3


def config(**kw):
    return dataclasses.replace(
        cifar10_single_block_config(num_layers=2, num_filters=8, s2d_block=0), **kw)


def batches(steps, batch=8, seed=0, size=8):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int64)) for _ in range(steps)]


def trees(cfg, seed=1, batch_norm=False):
    """(JAX params, JAX state, port params, port state) from one JAX init."""
    model = jax_build(cfg)
    params, state = (jax_params_and_state if batch_norm else jax_params_with_biases)(model, seed)
    params, state = to_numpy(params), to_numpy(state)
    return params, state, params_from_jax(params), state_from_jax(state)


PLAIN = trees(config())
NORMED = trees(config(use_batch_norm=True), batch_norm=True)
DATA = batches(2)
ACCUM = batches(2, batch=16, seed=3)
FEATURES = np.random.default_rng(5).integers(0, 256, (80, 8, 8, 3)).astype(np.uint8)
LABELS = np.random.default_rng(6).integers(0, 10, 80).astype(np.int64)


def cases():
    dp = dict(config=port_config_of(config()), params=PLAIN[2], lr=LR)
    bn = dict(config=port_config_of(config(use_batch_norm=True)), params=NORMED[2],
              state=NORMED[3], lr=LR)
    epoch = dict(config=port_config_of(config()), params=PLAIN[2], features=FEATURES,
                 labels=LABELS, batch_size=8, steps=4, lr=LR, mesh_shape=(WORLD,))
    return [
        ("layout", "mesh_layout", {}),
        ("dp", "train", dict(dp, batches=DATA, mesh_shape=(WORLD,))),
        ("dp_bn", "train", dict(bn, batches=DATA, mesh_shape=(WORLD,))),
        ("dp_bn_frozen", "train", dict(bn, batches=DATA, mesh_shape=(WORLD,), lr=0.0)),
        ("dp_accum", "train", dict(dp, batches=ACCUM, mesh_shape=(WORLD,), accum_steps=2)),
        ("dp_2x2", "train", dict(dp, batches=DATA, mesh_shape=(2, 2),
                                 mesh_names=("data", "model"))),
        ("epoch", "device_epochs", epoch),
        ("epoch_augmented", "device_epochs", dict(epoch, augment=True)),
        ("epoch_accum", "device_epochs", dict(epoch, accum_steps=2)),
        ("eval", "evaluation", dict(config=port_config_of(config()), params=PLAIN[2],
                                    images=FEATURES[:44].astype(np.float32),
                                    labels=LABELS[:44], batch_size=8, mesh_shape=(WORLD,))),
        ("eval_bn", "evaluation", dict(config=port_config_of(config(use_batch_norm=True)),
                                       params=NORMED[2], state=NORMED[3],
                                       images=FEATURES[:16].astype(np.float32),
                                       labels=LABELS[:16], batch_size=8, mesh_shape=(WORLD,))),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ranks")
    train = dict(config=port_config_of(config()), params=PLAIN[2], features=FEATURES[:64],
                 labels=LABELS[:64], val_features=FEATURES[64:], val_labels=LABELS[64:],
                 directory=str(directory))
    more = [("training", "training", train),
            ("sweep", "sweep", dict(config=port_config_of(config()), batch_size=8))]
    return run_ranks(torch_mesh_cases.run, WORLD, directory, cases() + more)


def each(ranks, name):
    return [case_result(r, name) for r in ranks]


def test_create_mesh_shard_batch_and_shard_params(ranks):
    """create_mesh's default and 2-D shapes, a mesh over fewer ranks than the
    world (the others get no coordinate) and the JAX error; shard_batch's
    rows in the JAX device-major order (coordinate i on data holds rows
    [i*B/d, (i+1)*B/d)); shard_params gives every rank the origin's values;
    local_batch_slice is each process's share."""
    for rank, got in enumerate(each(ranks, "layout")):
        assert got["default"] == ((WORLD,), ("data",), (rank,))
        assert got["two"] == ((2, 2), (rank // 2, rank % 2))
        assert got["sub"] == ((rank,) if rank < 2 else None)
        assert got["mesh_error"] == "Mesh shape (3, 2) needs 6 devices, have 4."
        assert got["placements"] == ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())")
        lo = 4 * (rank // 2)
        np.testing.assert_array_equal(got["rows"][0], np.arange(16).reshape(8, 2)[lo:lo + 4])
        np.testing.assert_array_equal(got["rows"][1], np.arange(8)[lo:lo + 4])
        np.testing.assert_array_equal(got["params"][0], np.zeros(3))
        np.testing.assert_array_equal(got["params"][1], np.zeros(2))
        assert got["local"] == slice(2 * rank, 2 * rank + 2)


def test_initialize_multihost_joins_two_processes_over_tcp(tmp_path):
    """Two processes join through initialize_multihost at a TCP address (a
    port free on this host), as `tests/test_multihost.py` does for JAX."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    got = run_ranks(torch_mesh_cases.multihost, 2, tmp_path, f"127.0.0.1:{port}", init=False)
    assert [g["sum"] for g in got] == [3.0, 3.0] and [g["world"] for g in got] == [2, 2]
    assert [g["slice"] for g in got] == [slice(0, 4), slice(4, 8)]


def test_one_process_needs_no_process_group_of_its_own():
    """initialize_multihost is a no-op for one process, and local_batch_slice
    is then the whole batch (JAX `mesh.py:85-86`)."""
    initialize_multihost("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized() or torch.distributed.get_world_size() == 1
    assert local_batch_slice(8) == slice(0, 8)


def assert_matches_jax(got_ranks, want, batch_norm=False):
    """Every rank's rows and parameters against JAX's (the batch-norm
    bounds of tests/torch_parity.py `assert_params_close` with batch norm),
    and every rank's the same."""
    for got in got_ranks:
        assert_rows_close(got["rows"], want["rows"])
        if batch_norm:
            assert_params_close(got["params"], want["params"], steps=len(want["rows"]), lr=LR)
        else:
            assert_trees_close(got["params"], want["params"], atol=1e-3)
    first = got_ranks[0]
    for got in got_ranks[1:]:  # every rank holds the same numbers
        np.testing.assert_array_equal(got["rows"], first["rows"])
        for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)


def test_data_parallel_step_matches_jax(ranks):
    """Two DP steps at global batch 8 over 4 ranks, against JAX's
    make_train_step(mesh=...) over 4 devices."""
    want = jax_train(config(), PLAIN[0], DATA, LR, mesh=jax_mesh((WORLD,), ("data",)))
    assert_matches_jax(each(ranks, "dp"), want)


def test_data_parallel_step_on_a_two_axis_mesh_matches_jax(ranks):
    """A (data 2, model 2) mesh without tp_mesh: the model axis replicates
    the step, the data axis splits the batch."""
    want = jax_train(config(), PLAIN[0], DATA, LR,
                     mesh=jax_mesh((2, 2), ("data", "model")))
    assert_matches_jax(each(ranks, "dp_2x2"), want)


def test_data_parallel_batch_norm_step_matches_jax(ranks):
    """Batch norm over the data mesh normalizes by the whole batch's moments
    (all-reduced with their gradient): loss and row against JAX's sharded
    step, the parameters under the batch-norm bounds (a conv bias that
    feeds a norm has a true gradient of 0, which each package's Adam steps
    by its own roundoff), the running statistics the same on every rank and
    within 1e-4 of JAX's."""
    want = jax_train(config(use_batch_norm=True), NORMED[0], DATA, LR, state=NORMED[1],
                     mesh=jax_mesh((WORLD,), ("data",)))
    got = each(ranks, "dp_bn")
    assert_matches_jax(got, want, batch_norm=True)
    for g in got:
        assert_trees_close(g["buffers"], want["state"], atol=1e-4, rtol=1e-4)
        assert_trees_close(g["buffers"], got[0]["buffers"], atol=0.0)


def test_data_parallel_batch_norm_eval_logits_match_jax(ranks):
    """Two batch-norm steps at rate 0 over the data mesh move only the
    running statistics (from the whole batch's moments): the eval-mode
    logits after them to 1e-4 of JAX's, and the rows as above."""
    want = jax_train(config(use_batch_norm=True), NORMED[0], DATA, 0.0, state=NORMED[1],
                     mesh=jax_mesh((WORLD,), ("data",)))
    for g in each(ranks, "dp_bn_frozen"):
        assert_rows_close(g["rows"], want["rows"])
        np.testing.assert_allclose(g["logits"], want["logits"], atol=1e-4, rtol=1e-4)


def test_accumulated_data_parallel_step_matches_jax(ranks):
    """accum_steps=2 over 4 ranks at global batch 16: each rank splits its 4
    rows into 2 contiguous microbatches, JAX's device-major split."""
    want = jax_train(config(), PLAIN[0], ACCUM, LR, mesh=jax_mesh((WORLD,), ("data",)),
                     accum_steps=2)
    assert_matches_jax(each(ranks, "dp_accum"), want)


@pytest.mark.parametrize("name", ["epoch", "epoch_augmented", "epoch_accum"])
def test_device_epoch_on_the_mesh_equals_the_meshless_epoch(ranks, name):
    """The device-resident epoch (4 steps of 8 from 80 images, the same
    generator seed) on 4 ranks against the same epoch without a mesh: the
    same order, the same augmentation draws, the same rows and parameters,
    with and without augmentation and with accumulation."""
    for got in each(ranks, name):
        assert_rows_close(got["mesh"]["rows"], got["meshless"]["rows"])
        assert_trees_close(got["mesh"]["params"], got["meshless"]["params"], atol=1e-5)


@pytest.mark.parametrize("name", ["eval", "eval_bn"])
def test_evaluation_and_prediction_on_the_mesh_equal_the_meshless_ones(ranks, name):
    """make_eval_step, make_multi_eval_step, make_device_eval (a ragged last
    batch of 4 over 4 ranks) and make_predict_step on the mesh: the whole
    batch's metrics and outputs on every rank, equal to the meshless ones."""
    for got in each(ranks, name):
        for key in ("step", "multi", "device"):
            np.testing.assert_allclose(got["mesh"][key], got["meshless"][key], rtol=1e-6)
        np.testing.assert_allclose(got["mesh"]["predict"], got["meshless"]["predict"],
                                   rtol=1e-6, atol=1e-7)


def test_training_on_the_mesh_equals_training_without_one(ranks):
    """Training(mesh=...): two streaming epochs (each rank reads the same
    seeded global batches and keeps its rows), a device-resident epoch and
    their evaluations give the meshless run's history and parameters; rank 0
    alone writes the CSVs and the checkpoints, under the names a meshless
    run writes; every rank restores the final checkpoint."""
    for rank, got in enumerate(each(ranks, "training")):
        mesh, meshless = got["mesh"], got["meshless"]
        assert [h[:2] for h in mesh["history"]] == [h[:2] for h in meshless["history"]]
        np.testing.assert_allclose([h[2:] for h in mesh["history"]],
                                   [h[2:] for h in meshless["history"]], rtol=1e-5)
        assert_trees_close(mesh["params"], meshless["params"], atol=1e-5)
        assert_trees_close(mesh["restored"], mesh["params"], atol=0.0)
        assert mesh["restored_step"] == meshless["restored_step"] == 8
        np.testing.assert_allclose(mesh["predict"], meshless["predict"], rtol=1e-5, atol=1e-6)
        if rank == 0:
            assert mesh["files"] == meshless["files"] and len(mesh["files"]) == 4
            assert mesh["csvs"] == meshless["csvs"] == 2


def test_throughput_sweep_over_the_mesh_divides_mfu_over_its_devices(ranks):
    """measure_train_throughput(mesh=...) on 4 ranks (an fp32 cell): the
    aggregate model TFLOP/s, the MFU per device, as the JAX package's."""
    from differential_equations_resnet_tpu_torch.utils.flops import peak_of

    _, peak = peak_of(torch.float32)
    for got in each(ranks, "sweep"):
        row = got["row"]
        assert all(np.isfinite(v) and v > 0 for v in row.values())
        assert row["mfu_vs_fp32_peak"] == pytest.approx(
            row["model_tflops"] * 1e12 / peak / got["size"])
