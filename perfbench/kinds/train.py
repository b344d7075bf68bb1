"""Training cells: whole epochs of the port's `Training.train`.

Set-up builds one `Training` (the model holding the seed's weights, Adam,
the data set drawn from the seed) and drives it through its first three
steps, each a one-step epoch through the same call and feed as the window,
reading each step's loss, the first gradient from Adam's state after one
step, the first telemetry row from its CSV, the running statistics after
one step and the parameters' change after three.  The same object then
trains whole epochs for at least ``seconds`` (with ``trace``, the
traffic's ``trace_epochs`` epochs under the profiler; with ``seconds`` 0,
none).  Once the window
has closed and the trainer is freed, the reference replays the three
steps (`perfbench.reference.first_steps`).

Traffic keys: ``kind`` "train", ``feed`` "device" (the device-resident
epoch, `Training.train(device_data=True)`, with the configuration's
augmentation on the card) or "stream" (`Training.train`'s default: batches
assembled on the host by its producer thread, staged in pinned memory, no
augmentation), ``summaries_frequency`` of the window's CSV rows,
``trace_epochs``.  Configuration keys used: ``family``, ``model``,
``train_images``, ``train`` (``batch_size``, ``learning_rate``,
``adam_epsilon``), ``data`` (``augment``: `standard_cifar_augment`'s
``crop_padding`` and ``flip``, or null).
"""

from __future__ import annotations

import gc
import glob
import math
import os
import shutil
import tempfile
import time

import torch

from perfbench import checks, frozen, program, reference
from perfbench import weights as seeded
from perfbench.trace import span, traced

FIRST_STEPS = 3


def _csv_row(directory: str, step: int) -> list:
    """The gradient mean norms the trainer logged at ``step``."""
    (path,) = glob.glob(os.path.join(directory, "*_training.csv"))
    with open(path) as f:
        next(f)
        for line in f:
            fields = line.split()
            if int(fields[0]) == step:
                return [float(v) for v in fields[3:]]
    raise ValueError(f"no CSV row for step {step}")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        start: float) -> dict:
    from differential_equations_resnet_tpu_torch.data.jit_augment import standard_cifar_augment
    from differential_equations_resnet_tpu_torch.train import Training, make_adam

    resident = {"device": True, "stream": False}[traffic["feed"]]
    model_d, recipe = config["model"], config["train"]
    batch, lr = recipe["batch_size"], recipe["learning_rate"]
    eps = recipe["adam_epsilon"]
    augment = config["data"].get("augment") if resident else None
    images, labels = seeded.images_and_labels(
        config["train_images"], model_d["image_shape"], model_d["num_classes"], seed, "train",
        device)
    host_x, host_y = images.cpu().numpy(), labels.cpu().numpy()
    del images, labels
    program.stamp("data", start)
    model, shapes = program.build(config, seed, device)
    program.stamp("model", start)
    state_shapes = {n: tuple(b.shape) for n, b in model.named_buffers()}
    optimizer = make_adam(model.parameters(), learning_rate=lr, epsilon=eps)
    logs = tempfile.mkdtemp(prefix="perfbench-train-")
    trainer = Training(
        model, train_features=host_x, train_labels=host_y, batch_size=batch, optimizer=optimizer,
        data_seed=seed, jit_augment=standard_cifar_augment(**augment) if augment else None,
        csv_logger_dir=logs, csv_logger_name="bench", record_summaries=True)
    steps_per_epoch = len(host_x) // batch
    program.stamp("trainer", start)

    def epoch(steps: int, frequency: int) -> dict:
        return trainer.train(epochs=1, steps_per_epoch=steps,
                             learning_rate_schedule=lambda step: lr, eval_frequency=None,
                             summaries_frequency=frequency, device_data=resident,
                             verbose=False)

    # -- the first steps, read from the program -------------------------------
    got: dict = {"loss": []}
    params = dict(model.named_parameters())
    for t in range(FIRST_STEPS):
        got["loss"].append(epoch(1, 1)["train"][-1]["mean_loss"])
        if t == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            got["grad"] = {n: _norm(optimizer.state[p]["exp_avg"]) / (1 - beta1)
                           for n, p in params.items()}
            buffers = dict(model.named_buffers())
            got["bn"] = {n: _norm(buffers[n] - (0.0 if n.endswith("__mean") else 1.0))
                         for n in state_shapes}
            got["row"] = _csv_row(logs, 1)
    start_weights = program.initial_weights(config, shapes, seed, device)
    got["change"] = {n: _norm(p - start_weights[n]) for n, p in params.items()}
    del start_weights
    if device == "cuda":
        torch.cuda.synchronize()

    # -- the window ---------------------------------------------------------------
    program.stamp("first steps", start)
    setup_s = time.perf_counter() - start
    epochs, the_trace = 0, None
    if trace:
        def window():
            for _ in range(traffic["trace_epochs"]):
                with span("window", True):
                    epoch(steps_per_epoch, traffic["summaries_frequency"])
                    if device == "cuda":
                        torch.cuda.synchronize()

        the_trace = traced(window, "window")
        epochs = traffic["trace_epochs"]
        window_s = the_trace.window_us / 1e6
    elif seconds <= 0:  # the readings alone (perfbench.calibrate)
        window_s = math.nan
    else:
        w0 = time.perf_counter()
        while True:
            epoch(steps_per_epoch, traffic["summaries_frequency"])
            if device == "cuda":
                torch.cuda.synchronize()
            epochs += 1
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
    steps = epochs * steps_per_epoch
    memory = program.memory_peak(device)
    kind = program.device_kind(device)

    # -- the reference, once the program's state is freed ---------------------------
    trainer.close()
    del trainer, model, optimizer, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(logs, ignore_errors=True)
    want = reference.first_steps(
        config["family"], model_d, program.initial_weights(config, shapes, seed, device),
        reference.initial_state(state_shapes, device),
        batches(traffic, config, torch.from_numpy(host_x).to(device),
                torch.from_numpy(host_y).to(device), seed), lr, eps, FIRST_STEPS)
    return {
        "metrics": {"setup_s": setup_s, "train_images_per_s": steps * batch / window_s},
        "attempted": steps, "failed": 0,
        "numbers": checks.training_numbers(got, want),
        "readings": {"program": got, "reference": want},
        "trace": the_trace,
        "info": {"kind": "train", "batch": batch, "calls": steps},
        "memory_peak_bytes": memory, "device_kind": kind,
    }



def batches(traffic: dict, config: dict, features, labels, seed: int):
    """The reference's replay of the feed's batches (`reference`)."""
    batch = config["train"]["batch_size"]
    if traffic["feed"] == "stream":
        return reference.streamed_batches(features, labels, seed, batch)
    augment = config["data"].get("augment")
    return reference.resident_batches(features, labels, seed, batch,
                                      frozen.cifar_augment(**augment) if augment else None)
