"""The port's training harness against the JAX package's: `Training` in both
packages from the same parameters and Adam state on the same data, the
K-step and device-resident loops against a per-step replay, the telemetry
writers, the telemetry CSV analysis and the FLOP counts."""

import json
import os
import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    SingleBlockResNetConfig as JaxConfig,
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.train import (
    SummaryWriter as JaxSummaryWriter,
    Training as JaxTraining,
    TrainingHistory as JaxTrainingHistory,
    create_train_state as jax_create_train_state,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.train import telemetry as jax_telemetry
from differential_equations_resnet_tpu.utils import flops as jax_flops
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.data import jit_augment, synthetic_cifar10
from differential_equations_resnet_tpu_torch.models import single_block_resnet
from differential_equations_resnet_tpu_torch.ops import antisymmetric
from differential_equations_resnet_tpu_torch.train import (
    SummaryWriter,
    Training,
    TrainingHistory,
    add_mean_norm_summary,
    add_moments_summary,
    constant_schedule,
    make_adam,
    make_device_epoch,
    make_device_eval,
    make_eval_step,
    make_multi_eval_step,
    make_multi_step,
    make_predict_step,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.parallel import create_mesh
from differential_equations_resnet_tpu_torch.utils import flops
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.weight_utils import adam_state_from_jax

from torch_parity import jax_params_with_biases, port_model, to_numpy


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
EXACT_LR = 2.0 ** -10  # exactly representable: float and fp32 rates agree


def config(num_layers=3, num_filters=8, **kw):
    return jax_cifar10_config(num_layers=num_layers, num_filters=num_filters, s2d_block=0, **kw)


def data(seed=0):
    return synthetic_cifar10(256, 64, seed=seed)


def adam_state(opt_state):
    """optax's ScaleByAdamState inside an inject_hyperparams(adam) state."""
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def read_rows(directory, kind):
    """(header, rows) of the one ``*_<kind>.csv`` in ``directory``."""
    (name,) = [f for f in os.listdir(directory) if f.endswith(f"_{kind}.csv")]
    with open(os.path.join(directory, name)) as f:
        header, *rows = f.read().splitlines()
    return header, np.asarray([[float(v) for v in r.split(" ")] for r in rows])


def assert_rows_agree(got, want):
    """global_step and accuracy exactly; mean_loss and the grad norms to
    1e-4 relative (fp32 sums in other orders through 3 layers and Adam)."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=1e-4)


@pytest.mark.parametrize("start", ["fresh", "mid_run_adam"])
def test_training_matches_jax(tmp_path, start):
    """Both packages' `Training` from the same parameters and Adam state
    (fresh, or two updates into a run, carried over by
    `adam_state_from_jax`) on the same data seed: the training and
    evaluation CSV rows, history, best_metrics and predict agree."""
    cfg = config()
    jax_model = jax_build(cfg)
    params, _ = jax_params_with_biases(jax_model, 3)
    tx = jax_make_adam()
    opt_state = tx.init(params)
    if start == "mid_run_adam":
        state = jax_create_train_state(jax_model, jax.random.key(0), tx)
        state = state._replace(params=params, opt_state=opt_state)
        step = jax_make_train_step(jax_model, tx, donate=False)
        rng = np.random.default_rng(9)
        for _ in range(2):
            state, _, _ = step(state, jnp.asarray(rng.uniform(0, 255, (8, 32, 32, 3)), jnp.float32),
                               jnp.asarray(rng.integers(0, 10, 8)), LR)
        params, opt_state = state.params, state.opt_state
    tx_x, tx_y, vx, vy, _ = data()
    common = dict(train_features=tx_x, train_labels=tx_y, val_features=vx, val_labels=vy,
                  batch_size=32, csv_logger_name="run")
    ref = JaxTraining(jax_model, csv_logger_dir=str(tmp_path / "jax"), optimizer=tx, **common)
    ref.state = ref.state._replace(params=params, opt_state=opt_state)
    model = port_model(cfg, params)
    optimizer = make_adam(model.parameters())
    optimizer.load_state_dict(adam_state_from_jax(to_numpy(adam_state(opt_state)), optimizer))
    port = Training(model, csv_logger_dir=str(tmp_path / "port"), optimizer=optimizer, **common)
    run = dict(epochs=2, steps_per_epoch=4, learning_rate_schedule=constant_schedule(LR),
               summaries_frequency=2, verbose=False)
    want_history, got_history = ref.train(**run), port.train(**run)
    ref.close(), port.close()
    for kind in ("training", "evaluation"):
        (h_got, got), (h_want, want) = read_rows(tmp_path / "port", kind), read_rows(tmp_path / "jax", kind)
        assert h_got == h_want
        assert len(got) == (4 if kind == "training" else 2)
        assert_rows_agree(got, want)
    for split in ("train", "eval"):
        assert len(got_history[split]) == len(want_history[split]) == 2
        for g, w in zip(got_history[split], want_history[split]):
            assert (g["epoch"], g["step"], g["accuracy"]) == (w["epoch"], w["step"], w["accuracy"])
            np.testing.assert_allclose(g["mean_loss"], w["mean_loss"], rtol=1e-5)
    assert port.best_metrics["accuracy"] == ref.best_metrics["accuracy"]
    np.testing.assert_allclose(port.best_metrics["loss"], ref.best_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(port.predict(vx[:40]), ref.predict(vx[:40]), rtol=1e-5, atol=1e-5)


def port_cpu_model(seed=0, **kw):
    cfg = config_from_json(_config_to_json(config(**kw)))
    return single_block_resnet.build_single_block_resnet(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def twins(**kw):
    """Two port models with equal parameters and fresh Adam."""
    a, b = port_cpu_model(**kw), port_cpu_model(**kw)
    return (a, make_adam(a.parameters())), (b, make_adam(b.parameters()))


def assert_same_params(a, b):
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_multi_step_equals_per_step_replay():
    (m1, o1), (m2, o2) = twins()
    x, y = data()[:2]
    images, labels = torch.from_numpy(x[:96]).reshape(3, 32, 32, 32, 3), torch.from_numpy(y[:96]).reshape(3, 32)
    metrics, norms = make_multi_step(m1, o1)(images, labels, [EXACT_LR] * 3)
    step = make_train_step(m2, o2)
    for i in range(3):
        m, n = step(images[i], labels[i], EXACT_LR)
        assert float(metrics["loss"][i]) == float(m["loss"])
        assert float(metrics["correct"][i]) == float(m["correct"])
        assert float(metrics["count"][i]) == 32
        assert torch.equal(norms[i], n)
    assert_same_params(m1, m2)


@pytest.mark.parametrize("augment", [None, "standard"])
def test_device_epoch_equals_per_step_replay_over_the_same_permutation(augment):
    """One device-resident epoch on the CPU: the permutation and then each
    step's augmentation drawn from the generator, replayed step by step."""
    (m1, o1), (m2, o2) = twins()
    x, y = (torch.from_numpy(a) for a in data()[:2])
    fn = jit_augment.standard_cifar_augment(brightness_delta=0.1) if augment else None
    lrs = [EXACT_LR * (i + 1) for i in range(5)]
    metrics, norms = make_device_epoch(m1, o1, 32, augment=fn)(
        x, y, torch.Generator().manual_seed(11), lrs)
    assert metrics["loss"].shape == (5,) and norms.shape == (5, 4)
    g = torch.Generator().manual_seed(11)
    perm = torch.randperm(len(x), generator=g)
    step = make_train_step(m2, o2)
    for i in range(5):
        idx = perm[i * 32:(i + 1) * 32]
        images = x[idx].float()
        if fn is not None:
            images = fn(g, images)
        m, n = step(images, y[idx], lrs[i])
        assert float(metrics["loss"][i]) == float(m["loss"])
        assert torch.equal(norms[i], n)
    assert_same_params(m1, m2)


def test_device_epoch_rejects_oversubscribed_steps():
    (m, o), _ = twins(num_layers=1)
    epoch = make_device_epoch(m, o, batch_size=32)
    with pytest.raises(ValueError, match="without replacement"):
        epoch(torch.zeros(64, 32, 32, 3, dtype=torch.uint8), torch.zeros(64, dtype=torch.long),
              torch.Generator(), [LR] * 3)  # 3 * 32 > 64
    with pytest.raises(ValueError, match="must divide batch_size"):
        make_device_epoch(m, o, batch_size=32, accum_steps=3)
    trainer = Training(m, train_features=np.zeros((64, 32, 32, 3), np.uint8),
                       train_labels=np.zeros(64, np.int64), batch_size=32)
    with pytest.raises(ValueError, match="without replacement"):
        trainer.train(1, 3, constant_schedule(LR), device_data=True, verbose=False)


def test_device_eval_and_multi_eval_match_the_eval_step():
    """The masked device pass over a ragged set and the K-batch eval agree
    with per-batch eval steps fed to StreamingMetrics semantics."""
    model, _ = twins()[0]
    x, y = (torch.from_numpy(a) for a in data()[2:4])
    x, y = x[:50], y[:50]
    step = make_eval_step(model)
    per_batch = [step(x[i:i + 16], y[i:i + 16]) for i in range(0, 50, 16)]
    got = make_device_eval(model, 16)(x, y)
    assert got["count"].tolist() == [16, 16, 16, 2]
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(got[k].numpy(), [float(m[k]) for m in per_batch], rtol=1e-6)
    multi = make_multi_eval_step(model)(x[:48].reshape(3, 16, 32, 32, 3), y[:48].reshape(3, 16))
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(multi[k].numpy(), [float(m[k]) for m in per_batch[:3]], rtol=1e-6)
    probs = make_predict_step(model)(x[:5])
    assert probs.shape == (5, 10)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def port_trainer(tmp_path, model=None, **kw):
    tx_x, tx_y, vx, vy, _ = data()
    return Training(model or port_cpu_model(), train_features=tx_x, train_labels=tx_y,
                    val_features=vx, val_labels=vy, batch_size=32,
                    csv_logger_dir=str(tmp_path), csv_logger_name="run", **kw)


def test_training_scan_steps_equals_the_per_step_path(tmp_path):
    """scan_steps=3 over 8 steps is accepted for the JAX signature and
    changes nothing: it writes the rows and evaluates to the results of the
    run without it."""
    rows = []
    for k, directory in ((0, tmp_path / "single"), (3, tmp_path / "scan")):
        trainer = port_trainer(directory)
        history = trainer.train(1, 8, constant_schedule(EXACT_LR), summaries_frequency=1,
                                scan_steps=k, verbose=False)
        trainer.close()
        rows.append((read_rows(directory, "training")[1], history))
    (single, h1), (scan, h2) = rows
    np.testing.assert_array_equal(scan, single)
    assert h1["eval"][0]["accuracy"] == h2["eval"][0]["accuracy"]
    np.testing.assert_allclose(h1["eval"][0]["mean_loss"], h2["eval"][0]["mean_loss"], rtol=1e-6)


def test_training_device_data_mode(tmp_path):
    """device_data=True with jit_augment: one device-resident epoch, then
    the full device evaluation of all 64 validation images (ragged batch
    masked), which agrees with the streaming evaluation."""
    trainer = port_trainer(tmp_path, jit_augment=jit_augment.standard_cifar_augment())
    history = trainer.train(2, 8, constant_schedule(LR), summaries_frequency=4,
                            device_data=True, verbose=False)
    assert trainer.global_step == 16
    assert read_rows(tmp_path, "training")[1][:, 0].tolist() == [4, 8, 12, 16]
    trainer.eval_metrics._drain()
    assert trainer.eval_metrics._count == 64
    streaming = trainer.evaluate("val")
    assert streaming["accuracy"] == history["eval"][-1]["accuracy"]
    np.testing.assert_allclose(streaming["mean_loss"], history["eval"][-1]["mean_loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="jit_augment runs inside"):
        trainer.train(1, 2, constant_schedule(LR), verbose=False)
    trainer.close()


def test_accum_steps_end_to_end(tmp_path):
    """Training(accum_steps=2) trains the monolithic run's numbers."""
    rows = []
    for k in (1, 2):
        trainer = port_trainer(tmp_path / str(k), accum_steps=k)
        trainer.train(1, 4, constant_schedule(LR), summaries_frequency=1, verbose=False)
        trainer.close()
        rows.append(read_rows(tmp_path / str(k), "training")[1])
    assert_rows_agree(rows[1], rows[0])
    with pytest.raises(ValueError, match="must divide batch_size"):
        port_trainer(tmp_path / "bad", accum_steps=3)


def test_dispatch_failure_retires_the_producer(tmp_path):
    trainer = port_trainer(tmp_path)
    real_step = trainer._train_step
    calls = {"n": 0}

    def failing_step(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("boom")
        return real_step(*args)

    trainer._train_step = failing_step
    with pytest.raises(RuntimeError, match="boom"):
        trainer.train(1, 8, constant_schedule(LR), eval_frequency=None, verbose=False)

    def producers():
        return [t for t in threading.enumerate() if t.name == "deqres-staging-producer"]

    deadline = time.time() + 12.0
    while producers() and time.time() < deadline:
        time.sleep(0.05)
    assert not producers()
    trainer._train_step = real_step
    history = trainer.train(1, 4, constant_schedule(LR), eval_frequency=None, verbose=False)
    assert np.isfinite(history["train"][-1]["mean_loss"])
    trainer.close()


def test_train_rejects_bad_arguments(tmp_path):
    trainer = port_trainer(tmp_path)
    for kwargs, match in ((dict(eval_dataset="validation"), "eval_dataset"),
                          (dict(monitor="acc"), "monitor"),
                          (dict(save_during_training=True), "save_dir"),
                          (dict(saver="orbax", save_during_training=True, save_dir=str(tmp_path)),
                           "torch checkpoints")):
        with pytest.raises(ValueError, match=match):
            trainer.train(1, 2, constant_schedule(LR), verbose=False, **kwargs)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        trainer.train(1, 0, constant_schedule(LR), verbose=False)
    with pytest.raises(ValueError, match="num_steps"):
        trainer.evaluate("val", num_steps=0)
    with pytest.raises(ValueError, match="dataset must be"):
        trainer.evaluate("test")
    trainer.close()


def _run_training(m, o, mesh):
    features, labels, vf, vl = (a[:96] for a in data()[:4])
    trainer = Training(m, train_features=features, train_labels=labels, val_features=vf,
                       val_labels=vl, batch_size=16, optimizer=o, mesh=mesh, record_summaries=False)
    history = trainer.train(1, 2, constant_schedule(LR), verbose=False)
    out = [torch.tensor([history["train"][0]["mean_loss"], history["eval"][0]["mean_loss"]])]
    return out + [torch.from_numpy(trainer.predict(vf[:20]))]


def _batch(n=8, k=None):
    rng = np.random.default_rng(0)
    shape = (n, 32, 32, 3) if k is None else (k, n, 32, 32, 3)
    return (torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, shape[:-3]).astype(np.int64)))


def _flat(*trees):
    out = []
    for t in trees:
        if isinstance(t, dict):
            out += [t[k].reshape(-1) for k in sorted(t)]
        else:
            out.append(t.reshape(-1))
    return out


@pytest.mark.parametrize("build", [
    _run_training,
    lambda m, o, mesh: _flat(*make_train_step(m, o, mesh=mesh)(*_batch(), LR)),
    lambda m, o, mesh: _flat(*make_multi_step(m, o, mesh=mesh)(*_batch(k=2), [LR, LR])),
    lambda m, o, mesh: _flat(*make_device_epoch(m, o, 8, mesh=mesh)(
        *(t.to(torch.uint8) if t.is_floating_point() else t for t in _batch(24)),
        torch.Generator().manual_seed(0), [LR, LR])),
    lambda m, o, mesh: _flat(make_eval_step(m, mesh=mesh)(*_batch())),
    lambda m, o, mesh: _flat(make_multi_eval_step(m, mesh=mesh)(*_batch(k=2))),
    lambda m, o, mesh: _flat(make_device_eval(m, 8, mesh=mesh)(*_batch(20))),
    lambda m, o, mesh: _flat(make_predict_step(m, mesh=mesh)(_batch()[0])),
], ids=["Training", "make_train_step", "make_multi_step", "make_device_epoch", "make_eval_step",
        "make_multi_eval_step", "make_device_eval", "make_predict_step"])
def test_every_builder_runs_on_a_mesh_of_one_rank(build):
    """Each builder and `Training` on a one-rank data mesh (this process,
    no launcher: parallel.create_mesh makes the group) gives what it gives
    without a mesh, bit for bit; the multi-rank meshes are held against
    the JAX package in tests/test_torch_mesh.py."""
    (m1, o1), (m2, o2) = twins(num_layers=1)
    mesh = create_mesh((1,), ("data",), device_type="cpu")
    got, want = build(m1, o1, mesh), build(m2, o2, None)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert_same_params(m1, m2)


def test_training_without_summaries_reports_the_same_epoch(tmp_path):
    """record_summaries=False feeds the epoch's rows to the streaming
    accumulator: the same mean loss and accuracy as the logged run."""
    results = []
    for record in (True, False):
        trainer = port_trainer(tmp_path / str(record), record_summaries=record)
        history = trainer.train(1, 4, constant_schedule(EXACT_LR), eval_frequency=None,
                                verbose=False)
        trainer.close()
        results.append(history["train"][0])
    logged, unlogged = results
    assert logged["accuracy"] == unlogged["accuracy"]
    np.testing.assert_allclose(logged["mean_loss"], unlogged["mean_loss"], rtol=1e-6)
    assert not os.path.exists(tmp_path / "False")


def test_a_replay_counts_the_launches_its_graph_holds():
    """The record's totals grow by what a captured graph holds at each
    replay (`StackRecord.replay`), B1, B2, their wide variants and batch
    norm alike; the capture adds none, an eager call (a warm-up's) adds at
    once, and `reset` zeroes the totals but not the graph's own."""
    from differential_equations_resnet_tpu_torch.utils.tracing import StackEntry, StackRecord

    record = StackRecord()
    step = [StackEntry("B1", (32, 32, 16, 64), "band", 4, 1),
            StackEntry("B1", (32, 32, 72, 2), "wide", 0, 2),
            StackEntry("BN", (32, 32, 32, 72), "forward", 0, 1),
            StackEntry("BN", (32, 32, 32, 72), "backward", 0, 3),
            StackEntry("B2", (32, 32, 72, 2), "wide", 0, 6),
            StackEntry("B2", (32, 32, 16, 64), "band", 4, 2)]
    with record.capture("train step") as graph:
        for entry in step:
            record.add(entry, captured=True)
        record.add(step[0], captured=False)  # a warm-up call on another stream
    assert record.graph("train step") == step
    assert (record.calls("B1"), record.launches("B1")) == (1, 1)
    assert record.calls("B2") == record.calls("BN") == 0
    for _ in range(3):
        record.replay(graph)
    assert (record.calls("B1"), record.launches("B1")) == (7, 10)
    assert (record.calls("B1", "wide"), record.launches("B1", "wide")) == (3, 6)
    assert (record.calls("B2"), record.launches("B2"), record.launches("B2", "band")) == (6, 24, 6)
    assert (record.calls("BN"), record.launches("BN")) == (6, 12)
    record.reset()
    assert record.calls("B1") == record.launches("B2") == record.launches("BN") == 0
    record.replay(graph)
    assert [record.launches(k) for k in ("B1", "B2", "BN")] == [3, 8, 4]
    assert record.graph("train step") == step


def test_evaluate_train_does_not_consume_the_training_iterator():
    from differential_equations_resnet_tpu_torch.data import create_dataset_from_arrays

    x = np.zeros((96, 32, 32, 3), np.float32)
    x[:, 0, 0, 0] = np.arange(96)
    ds = create_dataset_from_arrays(x, np.zeros(96, np.int64), batch_size=32, shuffle=False)
    trainer = Training(port_cpu_model(num_layers=1), train_dataset=ds, batch_size=32)
    first = next(trainer._train_iter)[0][:, 0, 0, 0]
    trainer.evaluate(dataset="train", num_steps=2)
    second = next(trainer._train_iter)[0][:, 0, 0, 0]
    np.testing.assert_array_equal(first, np.arange(0, 32))
    np.testing.assert_array_equal(second, np.arange(32, 64))


def test_summaries_and_profile(tmp_path, monkeypatch):
    """Summary rows at summaries_frequency through the JSONL writer (no
    tensorboard), and a torch.profiler chrome trace of the profiled epoch."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = port_trainer(tmp_path / "csv", summaries_dir=str(tmp_path / "sum"),
                           summaries_name="run")
    trainer.train(2, 4, constant_schedule(LR), summaries_frequency=2,
                  profile_dir=str(tmp_path / "prof"), profile_epoch=2, verbose=False)
    trainer.close()
    with open(tmp_path / "sum" / "run" / "train" / "scalars.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = {r["tag"] for r in records}
    assert {"learning_rate", "mean_loss", "accuracy", "conv1_kernel_gradient_mean_norm"} <= tags
    assert sorted({r["step"] for r in records}) == [2, 4, 6, 8]
    with open(tmp_path / "sum" / "run" / "eval" / "scalars.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [4, 4, 8, 8]
    assert os.listdir(tmp_path / "prof") == ["epoch_2.trace.json"]


def test_summary_writer_jsonl_is_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    value = rng.standard_normal((3, 4)).astype(np.float32)
    for cls, name in ((SummaryWriter, "port"), (JaxSummaryWriter, "jax")):
        writer = cls(str(tmp_path / name), use_tensorboard=False)
        writer.scalar("a", 0.5, 1)
        writer.scalars({"loss": np.float32(1.25), "acc": 0.125}, 2)
        summaries = (add_moments_summary, add_mean_norm_summary) if name == "port" else (
            jax_telemetry.add_moments_summary, jax_telemetry.add_mean_norm_summary)
        for fn in summaries:
            fn(writer, "w", value, 3)
        writer.flush()
        writer.close()
    port = (tmp_path / "port" / "scalars.jsonl").read_bytes()
    assert port == (tmp_path / "jax" / "scalars.jsonl").read_bytes()
    assert port.count(b"\n") == 8


def test_summary_helpers_take_device_tensors(tmp_path):
    writer = SummaryWriter(str(tmp_path), use_tensorboard=False)
    add_moments_summary(writer, "t", torch.tensor([1.0, 3.0]), 0)
    add_mean_norm_summary(writer, "t", torch.tensor([3.0, 4.0]), 0)
    writer.close()
    with open(tmp_path / "scalars.jsonl") as f:
        values = {r["tag"]: r["value"] for r in map(json.loads, f)}
    assert values == {"t/mean": 2.0, "t/stddev": 1.0, "t/max": 3.0, "t/min": 1.0, "t/mean_norm": 2.5}


def test_training_history_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    names = ["global_step", "mean_loss", "accuracy"] + [f"g{i}" for i in range(9)]
    train_csv, eval_csv = tmp_path / "t_training.csv", tmp_path / "t_evaluation.csv"
    rows = [" ".join([str(10 * s), str(2.0 / s), str(0.1 * s)] + [str(v) for v in rng.uniform(1e-4, 1e-3, 9)])
            for s in range(1, 301)]
    train_csv.write_text(" ".join(names) + "\n" + "\n".join(rows) + "\n")
    eval_csv.write_text("global_step mean_loss accuracy\n10 2.0 0.1\n20 1.5 0.3\n")
    got, want = (cls(str(train_csv), str(eval_csv)) for cls in (TrainingHistory, JaxTrainingHistory))
    for attr in ("training_steps", "training_mean_loss", "training_accuracy", "gradient_norms",
                 "evaluation_steps", "evaluation_mean_loss", "evaluation_accuracy"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got.gradient_names == want.gradient_names
    for method in ("gradient_norm_relative_deviation", "gradient_norm_standard_deviation",
                   "gradient_norm_relative_comparison"):
        for reduce in (True, False):
            np.testing.assert_array_equal(getattr(got, method)(reduce=reduce),
                                          getattr(want, method)(reduce=reduce))
    header_only = tmp_path / "h_training.csv"
    header_only.write_text(" ".join(names) + "\n")
    with pytest.raises(ValueError, match="no data rows"):
        TrainingHistory(str(header_only))


@pytest.mark.parametrize("cfg", [
    jax_cifar10_config(num_layers=64, num_filters=16),
    jax_cifar10_config(num_layers=8, num_filters=32, integrator="rk4"),
    JaxConfig(image_shape=(12, 12, 3), num_stages=3, blocks_per_stage=(2, 3),
              filters_per_block=(4, 8), strides=((1, 1), (2, 2)),
              use_max_pooling=(False, True, False, False), num_classes=5),
])
def test_flop_counts_match_jax(cfg):
    port_cfg = config_from_json(_config_to_json(cfg))
    for batch in (1, 32):
        assert flops.single_block_forward_flops(port_cfg, batch) == \
            jax_flops.single_block_forward_flops(cfg, batch)
        assert flops.single_block_train_flops(port_cfg, batch) == \
            jax_flops.single_block_train_flops(cfg, batch)
    assert flops.mfu(67e12, 1.0) == 1.0
    assert flops.mfu(1e12, 2.0, flops.PEAK_FLOPS["h100_sxm_bf16"]) == pytest.approx(2 / 989)


def test_capture_safe_constants_are_bit_identical(monkeypatch):
    """The cached device constants (input mean and scale, cross-pair
    indices) and the device-made count give the previous forward and train
    step bit for bit: the previous code is put back by monkeypatching."""
    x, y = (torch.from_numpy(a[:8]) for a in data()[:2])
    results = []
    for previous in (False, True):
        if previous:
            monkeypatch.setattr(single_block_resnet, "_input_constant",
                                lambda v, d, dtype: torch.as_tensor(v, dtype=dtype, device=d))
            monkeypatch.setattr(antisymmetric, "_cross_index_tensors", lambda c, d: tuple(
                torch.as_tensor(a, dtype=torch.long, device=d)
                for a in antisymmetric.cross_pair_indices(c)))
        model = port_cpu_model(num_layers=2, num_filters=6)
        with torch.inference_mode():  # the cached constants stay usable by autograd
            forward = model(x.float())
        metrics, norms = make_train_step(model, make_adam(model.parameters()))(x, y, LR)
        results.append([forward.detach(), metrics["loss"], metrics["count"], norms,
                        *[p.detach().clone() for p in model.parameters()]])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    assert float(results[0][2]) == 8.0
