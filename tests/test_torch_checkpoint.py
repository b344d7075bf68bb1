"""The port's checkpoints: the JAX package's metric-encoded names, latest and
garbage collection, the sidecar, a bit-exact resume with the Adam slots, and
structure drift refused."""

import json
import os

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu.models import cifar10_single_block_config as jax_config
from differential_equations_resnet_tpu.train import Checkpointer as JaxCheckpointer
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.data import synthetic_cifar10
from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
from differential_equations_resnet_tpu_torch.train import (
    Checkpointer,
    TrainState,
    Training,
    constant_schedule,
    make_adam,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core, and small CPU
    convolutions slow down many times over when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 1e-3


def model(num_layers=2, num_filters=4, seed=0):
    cfg = config_from_json(_config_to_json(
        jax_config(num_layers=num_layers, num_filters=num_filters, s2d_block=0)))
    return build_single_block_resnet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def state(**kw):
    m = model(**kw)
    return TrainState(m, make_adam(m.parameters()))


def batches(n=3, seed=0):
    x, y, *_ = synthetic_cifar10(8 * n, 1, seed=seed)
    return [(torch.from_numpy(x[8 * i:8 * i + 8]), torch.from_numpy(y[8 * i:8 * i + 8])) for i in range(n)]


@pytest.mark.parametrize("args", [
    dict(step=7),
    dict(step=12, name="m", tags=("a", "b")),
    dict(step=3, tags=("default",), metrics={"loss": 1.23456, "accuracy": 0.5}),
])
def test_checkpoint_names_match_jax(tmp_path, args):
    assert Checkpointer(str(tmp_path)).checkpoint_name(**args) == \
        JaxCheckpointer(str(tmp_path), backend="pickle").checkpoint_name(**args)


def test_latest_garbage_collection_and_sidecar(tmp_path):
    s = state()
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (3, 1, 2):
        path = ckpt.save(s, step, tags=("t",), metrics={"loss": 0.5 * step, "accuracy": 0.25})
    # Kept: the two highest steps, whatever the order they were written in.
    assert ckpt.list_checkpoints() == ["t_step-00000002_loss-1.0000_accuracy-0.2500",
                                       "t_step-00000003_loss-1.5000_accuracy-0.2500"]
    assert ckpt.latest() == "t_step-00000003_loss-1.5000_accuracy-0.2500"
    assert sorted(os.listdir(tmp_path)) == sorted(
        [n for c in ckpt.list_checkpoints() for n in (c, c + ".meta.json")])
    meta = ckpt.read_meta(path)
    assert meta["step"] == 2 and meta["metrics"] == {"loss": 1.0, "accuracy": 0.25}
    assert meta["structure"]["model"]["stem__kernel"] == [3, 3, 3, 4]
    assert meta["structure"]["optimizer"]["class"] == "Adam"
    assert ckpt.read_meta(str(tmp_path / "missing")) is None
    assert Checkpointer(str(tmp_path / "empty")).latest() is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(s)
    with pytest.raises(ValueError, match="torch checkpoints"):
        Checkpointer(str(tmp_path), backend="orbax")


def test_resumed_run_equals_an_uninterrupted_run(tmp_path):
    """Three steps straight through, against one step, a save, a restore
    into a new model and optimizer, and two more steps: parameters, Adam
    slots and metrics bit for bit."""
    data = batches()
    straight, first = state(), state()
    run = make_train_step(straight.model, straight.optimizer)
    want = [run(x, y, LR) for x, y in data]
    make_train_step(first.model, first.optimizer)(*data[0], LR)
    path = Checkpointer(str(tmp_path)).save(first, 1)
    resumed = state(seed=5)  # other parameters, overwritten by the restore
    Checkpointer(str(tmp_path)).restore(resumed, path)
    assert resumed.step == 1
    for p, q in zip(resumed.model.parameters(), first.model.parameters()):
        assert torch.equal(p, q)
    step = make_train_step(resumed.model, resumed.optimizer)
    got = [step(x, y, LR) for x, y in data[1:]]
    for (m, n), (mw, nw) in zip(got, want[1:]):
        assert torch.equal(m["loss"], mw["loss"]) and torch.equal(n, nw)
    for p, q in zip(resumed.model.parameters(), straight.model.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    straight.optimizer.state_dict()["state"].values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k])


def test_structure_drift_raises(tmp_path):
    s = state(num_layers=2)
    path = Checkpointer(str(tmp_path)).save(s, 1)
    for other in (state(num_layers=3), state(num_filters=6)):
        with pytest.raises(ValueError, match="different structure"):
            Checkpointer(str(tmp_path)).restore(other, path)
    sgd = TrainState(s.model, torch.optim.SGD(s.model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="optimizer Adam"):
        Checkpointer(str(tmp_path)).restore(sgd, path)
    # A sidecar without a fingerprint (written by hand) is not checked.
    meta_path = path + ".meta.json"
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["structure"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert Checkpointer(str(tmp_path)).restore(state(), path).step == 1


def test_training_saves_best_and_resumes(tmp_path):
    """Best-metric checkpointing from the harness, then load_variables into
    a new trainer: step, parameters and Adam slots come back, and the
    restored trainer trains on."""
    x, y, vx, vy, _ = synthetic_cifar10(128, 32, seed=1)
    kw = dict(train_features=x, train_labels=y, val_features=vx, val_labels=vy, batch_size=16)
    trainer = Training(model(), **kw)
    trainer.train(2, 3, constant_schedule(LR), save_during_training=True,
                  save_dir=str(tmp_path / "best"), save_frequency=1, save_best_only=False,
                  monitor="accuracy", verbose=False)
    ckpt = Checkpointer(str(tmp_path / "best"))
    assert len(ckpt.list_checkpoints()) == 2 and "step-00000006" in ckpt.latest()
    path = trainer.save(str(tmp_path / "manual"), tags=["t"], name="m")
    assert os.path.basename(path).startswith("m_t_step-00000006")
    again = Training(model(seed=3), **kw)
    again.load_variables(path + "/")
    assert again.global_step == 6
    for p, q in zip(again.model.parameters(), trainer.model.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(again.optimizer.state_dict()["state"].values(),
                    trainer.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    history = again.train(1, 2, constant_schedule(LR), eval_frequency=None, verbose=False)
    assert again.global_step == 8 and np.isfinite(history["train"][-1]["mean_loss"])
