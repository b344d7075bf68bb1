"""The training harness: the user-facing `Training` class.

Port of `differential_equations_resnet_tpu/train/training.py`: the epoch
loop with its double-buffered
host staging, the device-resident (``device_data``) loop of `train_step`,
gradient accumulation, evaluation on the validation or the training set,
per-layer gradient-norm CSV and summary rows, best-metric checkpointing,
``predict``, ``save`` and ``load_variables``.

Every train step and eval batch runs through one step of `train_step`:
eager on the CPU, a replay of one captured CUDA graph on CUDA.

Differences from the JAX package:

- The model holds its own parameters (built from a generator or given
  ``params``), so ``seed`` is accepted and ignored: the JAX package's
  ``Training`` draws the parameters again from it (`create_train_state`).
- ``scan_steps`` is accepted and changes nothing: the JAX package fuses K
  steps into one dispatch with ``lax.scan``, while here every step is
  already one replay (or, on the CPU, one eager step).
- ``optimizer`` is a torch optimizer over the model's parameters (default
  `make_adam`), not an optax transform; checkpoints are torch checkpoints
  (``saver="torch"``).
- ``profile_dir`` writes a `torch.profiler` chrome trace of epoch
  ``profile_epoch`` (``epoch_<n>.trace.json``) in place of a `jax.profiler`
  trace.
- The device-resident epoch draws its order and augmentation from a
  `torch.Generator` seeded from ``data_seed`` and the global step.
- ``mesh`` (`parallel.create_mesh`): every rank runs the same `Training`.
  The model's parameters are broadcast from the mesh's origin
  (`shard_params`); each rank reads the same seeded global batches and
  keeps its own rows (`shard_batch`, before the copy to the device); the
  steps reduce over the mesh (`train.train_step`), so every rank holds the
  same metrics, rows and parameters.  Rank 0 alone writes the CSVs, the
  summaries and the checkpoints (the file a meshless run writes), then a
  barrier; every rank restores a checkpoint.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from differential_equations_resnet_tpu_torch.data.pipeline import (
    NumpyDataset,
    create_dataset_from_arrays,
)
from differential_equations_resnet_tpu_torch.parallel.mesh import shard_batch, shard_params
from differential_equations_resnet_tpu_torch.train.checkpoint import Checkpointer
from differential_equations_resnet_tpu_torch.train.metrics import StreamingMetrics
from differential_equations_resnet_tpu_torch.train.telemetry import (
    CsvLogger,
    SummaryWriter,
    gradient_metric_names,
)
from differential_equations_resnet_tpu_torch.train.train_step import (
    TrainState,
    _eval_row,
    _StepRunner,
    make_adam,
    make_device_epoch,
    make_device_eval,
    make_predict_step,
    unpack_rows,
)
from differential_equations_resnet_tpu_torch.utils.tracing import span


class _ProducerStopped(Exception):
    """Internal: the dispatch loop asked the staging producer to exit."""


def _fold_in(seed: int, step: int) -> int:
    """A generator seed from the data seed and the global step: one
    reproducible stream per epoch."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (2 ** 63)


class Training:
    """End-to-end trainer.

    Data is either ready-made batched `NumpyDataset`s (elements = (images,
    labels) batches) or in-memory arrays, as the reference's 'tfrecord' and
    'arrays' dataset modes.  The model (a `SingleBlockResNet` or a
    `BottleneckResNet`) fixes the device: CUDA, or the CPU for a model built
    with ``device="cpu"``.  Training runs its forward in train mode (batch
    norm updates its running statistics), evaluation and prediction in eval
    mode."""

    def __init__(
        self,
        model,
        train_dataset: Optional[NumpyDataset] = None,
        val_dataset: Optional[NumpyDataset] = None,
        train_features: Optional[np.ndarray] = None,
        train_labels: Optional[np.ndarray] = None,
        val_features: Optional[np.ndarray] = None,
        val_labels: Optional[np.ndarray] = None,
        batch_size: int = 32,
        optimizer: Optional[torch.optim.Optimizer] = None,
        global_step: int = 0,
        record_summaries: bool = True,
        summaries: Sequence[str] = ("mean_gradient_norms",),
        summaries_dir: Optional[str] = None,
        summaries_name: Optional[str] = None,
        csv_logger_dir: Optional[str] = None,
        csv_logger_name: Optional[str] = None,
        mesh=None,
        seed: int = 0,
        data_seed: Optional[int] = 0,
        jit_augment=None,
        accum_steps: int = 1,
    ):
        self.model = model
        self.mesh = mesh
        if mesh is not None:
            shard_params(mesh, model)
        # Under a mesh only rank 0 writes files (CSVs, summaries, checkpoints).
        self._writer = mesh is None or dist.get_rank() == 0
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}.")
        if batch_size % self.accum_steps:
            raise ValueError(
                f"accum_steps ({accum_steps}) must divide batch_size "
                f"({batch_size}): accumulation averages EQUAL microbatches "
                "so it reproduces the monolithic step exactly."
            )
        self.record_summaries = record_summaries
        self.summaries = tuple(summaries)

        # -- data ------------------------------------------------------------
        self._num_train_examples = len(train_features) if train_features is not None else None
        self._num_val_examples = len(val_features) if val_features is not None else None
        if train_dataset is None and train_features is not None:
            train_dataset = create_dataset_from_arrays(
                train_features, train_labels, batch_size,
                shuffle=True, repeat=True, drop_remainder=True, seed=data_seed,
            )
        if val_dataset is None and val_features is not None:
            val_dataset = create_dataset_from_arrays(
                val_features, val_labels, batch_size,
                shuffle=False, repeat=True, drop_remainder=False, seed=data_seed,
            )
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self._train_iter: Optional[Iterator] = iter(train_dataset) if train_dataset is not None else None
        self._val_iter: Optional[Iterator] = iter(val_dataset) if val_dataset is not None else None
        self._train_arrays = (train_features, train_labels) if train_features is not None else None
        self._val_arrays = (val_features, val_labels) if val_features is not None else None
        self._device_arrays: dict = {}  # 'train' / 'val' -> (features, labels) on the device
        self._jit_augment = jit_augment
        self._data_seed = data_seed if data_seed is not None else 0

        # -- the steps -----------------------------------------------------------
        self.optimizer = optimizer if optimizer is not None else make_adam(model.parameters())
        self.state = TrainState(model, self.optimizer, int(global_step))
        self._with_norms = "mean_gradient_norms" in self.summaries
        self._build_steps()

        # -- metrics / logging -------------------------------------------------
        self.train_metrics = StreamingMetrics()
        self.eval_metrics = StreamingMetrics()
        self.gradient_names = gradient_metric_names(model.config)
        self.best_metrics = {"loss": np.inf, "accuracy": 0.0}
        self.history: dict = {"train": [], "eval": []}

        self._summary_writer = None
        self._eval_summary_writer = None
        if record_summaries and summaries_dir and self._writer:
            run = summaries_name or model.config.name
            self._summary_writer = SummaryWriter(os.path.join(summaries_dir, run, "train"))
            self._eval_summary_writer = SummaryWriter(os.path.join(summaries_dir, run, "eval"))
        self._train_csv = None
        self._eval_csv = None
        if record_summaries and csv_logger_dir and self._writer:
            stamp = time.strftime("%Y%m%d-%H%M%S")
            base = f"{csv_logger_name or 'history'}_{stamp}"
            self._train_csv = CsvLogger(
                os.path.join(csv_logger_dir, base + "_training.csv"),
                ["global_step", "mean_loss", "accuracy"] + self.gradient_names,
            )
            self._eval_csv = CsvLogger(
                os.path.join(csv_logger_dir, base + "_evaluation.csv"),
                ["global_step", "mean_loss", "accuracy"],
            )

    def _build_steps(self) -> None:
        """The step functions: ``_train_step(images, labels, lr) -> row``
        and ``_eval_row(images, labels, valid) -> [loss, correct, count]``,
        eager on the CPU and replayed on CUDA (each row then the graph's
        own, overwritten by the next call).  On CUDA they hold graphs over
        the optimizer's state tensors, so a restore (which replaces them)
        builds them again."""
        self._train_step = _StepRunner(self.model, self.optimizer, self._with_norms,
                                       self.accum_steps, self.mesh)
        self._eval_row = _eval_row(self.model, self.mesh)
        self._predict_step = make_predict_step(self.model, self.mesh)
        self._device_epoch = None
        self._device_eval_fn = None

    # -- helpers ---------------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self.state.step

    def _to_device(self, array, non_blocking: bool = False) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device, non_blocking=non_blocking)

    def _staged(self, array) -> torch.Tensor:
        """A host batch (this rank's rows of it, under a mesh) as a tensor the
        dispatch loop copies to the device without waiting: page-locked
        where the device is CUDA."""
        if self.mesh is not None:
            (array,) = shard_batch(self.mesh, (array,))
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _device_data(self, source: str):
        """The 'train' or 'val' arrays on the device, uploaded once."""
        if source not in self._device_arrays:
            features, labels = self._train_arrays if source == "train" else self._val_arrays
            self._device_arrays[source] = (self._to_device(features),
                                           self._to_device(np.asarray(labels)))
        return self._device_arrays[source]

    # -- train -------------------------------------------------------------------

    def train(
        self,
        epochs: int,
        steps_per_epoch: int,
        learning_rate_schedule: Callable[[int], float],
        eval_dataset: str = "val",
        eval_frequency: Optional[int] = 1,
        eval_steps: Optional[int] = None,
        save_during_training: bool = False,
        save_dir: Optional[str] = None,
        save_best_only: bool = True,
        save_tags: Sequence[str] = ("default",),
        save_name: str = "",
        save_frequency: int = 5,
        saver: str = "torch",
        monitor: str = "loss",
        summaries_frequency: int = 10,
        scan_steps: int = 0,
        device_data: bool = False,
        profile_dir: Optional[str] = None,
        profile_epoch: int = 1,
        verbose: bool = True,
    ) -> dict:
        """Run the training loop (the JAX package's `Training.train`).

        ``eval_dataset`` is 'val' or 'train' (a fresh pass of the training
        set); ``eval_steps=None`` means one full pass when the example count
        is known, which in ``device_data`` mode is the device-resident
        evaluation.  ``scan_steps`` is accepted for the JAX signature and
        changes nothing (see the module docstring).  ``device_data=True``
        uploads the training arrays once and runs each epoch through
        `make_device_epoch`.  ``profile_dir`` writes a `torch.profiler`
        chrome trace of epoch ``profile_epoch``, its CSV and summary rows
        included.

        Under any open `torch.profiler` window (``profile_dir`` opens one)
        the epoch records the named host ranges that `utils.tracing`
        lists; without a window nothing is recorded."""
        if self._train_iter is None:
            raise ValueError("No training dataset was provided.")
        if monitor not in ("loss", "accuracy"):
            raise ValueError("`monitor` must be 'loss' or 'accuracy'.")
        if eval_dataset not in ("train", "val"):
            raise ValueError(f"`eval_dataset` must be 'train' or 'val', got {eval_dataset!r}.")
        checkpointer = None
        if save_during_training:
            if save_dir is None:
                raise ValueError("save_during_training=True requires save_dir.")
            checkpointer = Checkpointer(save_dir, backend=saver)
        if self._jit_augment is not None and not device_data:
            raise ValueError(
                "jit_augment runs inside the device-resident epoch only; call "
                "train(device_data=True), or use the host preprocessors "
                "(data/preprocessors.py) for the streaming paths.  Silently "
                "training unaugmented would corrupt the experiment."
            )
        if steps_per_epoch < 1:
            raise ValueError(
                f"steps_per_epoch must be >= 1, got {steps_per_epoch} (a batch size "
                "larger than the dataset reduces a device-resident epoch to zero steps)."
            )
        if device_data:
            if self._train_arrays is None:
                raise ValueError(
                    "device_data=True requires in-memory train arrays "
                    "(Training(train_features=..., train_labels=...))."
                )
            n = len(self._train_arrays[0])
            if steps_per_epoch * self.batch_size > n:
                raise ValueError(
                    f"device_data=True draws batches without replacement: "
                    f"steps_per_epoch*batch_size ({steps_per_epoch}*{self.batch_size}) "
                    f"exceeds the {n} training examples."
                )
            if self._device_epoch is None:
                self._device_epoch = make_device_epoch(
                    self.model, self.optimizer, self.batch_size, mesh=self.mesh,
                    with_gradient_metrics=self._with_norms, augment=self._jit_augment,
                    accum_steps=self.accum_steps)

        for epoch in range(1, epochs + 1):
            self.train_metrics.reset()
            epoch_start = time.time()
            epoch_first_step = self.global_step + 1
            profiling = profile_dir is not None and epoch == profile_epoch
            with self._profiler(profile_dir if profiling else None, epoch):
                if device_data:
                    rows, lrs = self._device_data_epoch(steps_per_epoch, learning_rate_schedule)
                else:
                    rows, lrs = self._streaming_epoch(steps_per_epoch, learning_rate_schedule)
                with span("deqres.epoch.log"):
                    train_results = self._log_epoch(rows, lrs, epoch_first_step,
                                                    summaries_frequency)
            self.history["train"].append({"epoch": epoch, "step": self.global_step, **train_results})
            if verbose:
                dt = time.time() - epoch_start
                print(
                    f"Epoch {epoch}/{epochs}: loss={train_results['mean_loss']:.4f} "
                    f"acc={train_results['accuracy']:.4f} ({steps_per_epoch / dt:.2f} steps/s)"
                )

            # -- periodic evaluation (reference :603-619) -------------------------
            eval_results = None
            if eval_frequency and epoch % eval_frequency == 0:
                eval_results = self._evaluate(eval_dataset, eval_steps, prefer_device=device_data)
            if eval_results is not None:
                self.history["eval"].append({"epoch": epoch, "step": self.global_step, **eval_results})
                if self._eval_csv is not None:
                    self._eval_csv.log([self.global_step, eval_results["mean_loss"],
                                        eval_results["accuracy"]])
                if self._eval_summary_writer is not None:
                    self._eval_summary_writer.scalars(eval_results, self.global_step)
                if verbose:
                    print(f"  eval: loss={eval_results['mean_loss']:.4f} "
                          f"acc={eval_results['accuracy']:.4f}")

            # -- best-metric bookkeeping + checkpointing (reference :625-668) ----
            monitored = eval_results if eval_results is not None else train_results
            improved = (
                monitored["mean_loss"] < self.best_metrics["loss"]
                if monitor == "loss"
                else monitored["accuracy"] > self.best_metrics["accuracy"]
            )
            self.best_metrics["loss"] = min(self.best_metrics["loss"], monitored["mean_loss"])
            self.best_metrics["accuracy"] = max(self.best_metrics["accuracy"], monitored["accuracy"])
            if checkpointer is not None and epoch % save_frequency == 0 and (
                    improved or not save_best_only):
                self._save(checkpointer, name=save_name, tags=save_tags,
                           metrics={"loss": monitored["mean_loss"],
                                    "accuracy": monitored["accuracy"]})
        return self.history

    def _profiler(self, profile_dir: Optional[str], epoch: int):
        """A `torch.profiler` window around one epoch, written as a chrome
        trace on exit; a null context where ``profile_dir`` is None."""
        if profile_dir is None:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, f"epoch_{epoch}.trace.json")
        return profile(activities=activities,
                       on_trace_ready=lambda prof: prof.export_chrome_trace(trace))

    def _device_data_epoch(self, steps: int, schedule):
        """One device-resident epoch: (telemetry rows (steps, 3 + W) on the
        device, learning rates)."""
        with span("deqres.epoch.begin"):
            lrs = [float(schedule(self.global_step + i)) for i in range(steps)]
            features, labels = self._device_data("train")
            generator = torch.Generator(device=self.device)
            generator.manual_seed(_fold_in(self._data_seed, self.global_step))
        metrics, grad_norms = self._device_epoch(
            features, labels, generator, np.asarray(lrs, np.float32))
        self.state.step += steps
        scalars = torch.stack([metrics[k] for k in ("loss", "correct", "count")], 1)
        return torch.cat([scalars, grad_norms], 1), lrs

    def _streaming_epoch(self, steps_per_epoch: int, schedule):
        """One epoch fed by a producer thread that assembles batches on the
        host (pinned for CUDA), double-buffered through a bounded queue, so
        the dispatch loop never waits on host staging; learning rates are
        computed ahead from the producer's own step counter.  Returns the
        telemetry rows (steps, 3 + W) on the device and the rates."""
        rows, lrs = None, []
        stage_q: queue.Queue = queue.Queue(maxsize=2)
        # If the dispatch loop dies mid-epoch the producer must not stay
        # blocked on the full queue holding its place in self._train_iter:
        # stop_event and a timed put let it exit promptly.
        stop_event = threading.Event()

        def _put(item) -> None:
            while not stop_event.is_set():
                try:
                    stage_q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue
            raise _ProducerStopped()

        def _producer(first_step: int, total: int) -> None:
            try:
                for step in range(first_step, first_step + total):
                    images, labels = next(self._train_iter)
                    _put(("batch", self._staged(images), self._staged(labels),
                          float(schedule(step))))
            except _ProducerStopped:
                pass  # the consumer asked us to exit; nothing to report
            except BaseException as e:  # noqa: BLE001 - handed to the dispatch loop, which re-raises
                try:
                    _put(("error", e))
                except _ProducerStopped:
                    pass
            else:
                try:
                    _put(("end",))
                except _ProducerStopped:
                    pass

        with span("deqres.epoch.begin"):
            producer = threading.Thread(
                target=_producer, args=(self.global_step, steps_per_epoch),
                daemon=True, name="deqres-staging-producer",
            )
            producer.start()
        try:
            while True:
                with span("deqres.feed.wait"):
                    item = stage_q.get()
                kind = item[0]
                if kind == "error":
                    raise item[1]
                if kind == "end":
                    break
                with span("deqres.step"):
                    _, images, labels, lr = item
                    row = self._train_step(images.to(self.device, non_blocking=True),
                                           labels.to(self.device, non_blocking=True), lr)
                    if rows is None:
                        rows = row.new_empty((steps_per_epoch, row.numel()))
                    rows[len(lrs)].copy_(row)
                    lrs.append(lr)
                    self.state.step += 1
        except BaseException:
            # The dispatch loop died mid-epoch (checkpoint I/O error, user
            # interrupt).  The producer may have run ahead and may be stuck
            # in next(self._train_iter): the train iterator is rebuilt from
            # the dataset, so a zombie producer never races a later train()
            # on the same iterator and the data position is well defined.
            if self.train_dataset is not None:
                self._train_iter = iter(self.train_dataset)
            raise
        finally:
            # Retire the producer whether the epoch finished or not: signal
            # stop, drain what it is blocked on, and wait for it to exit.
            stop_event.set()
            try:
                while True:
                    stage_q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=10.0)
        return rows, lrs

    def _log_epoch(self, rows, lrs, epoch_first_step: int, summaries_frequency: int) -> dict:
        """Write the epoch's CSV and summary rows from its telemetry, fetched
        from the device in one copy, and return its mean loss and accuracy.
        Without summaries the rows go to the streaming accumulator."""
        if not self.record_summaries:
            metrics, _ = unpack_rows(rows)
            self.train_metrics.update(metrics["loss"], metrics["correct"], metrics["count"])
            return self.train_metrics.results()
        host_rows = rows.cpu().numpy()
        losses, corrects, counts = host_rows[:, 0], host_rows[:, 1], host_rows[:, 2]
        norms = host_rows[:, 3:]
        # The reference's streaming metrics mid-epoch: the running mean of
        # batch losses and the running accuracy.
        mean_loss_run = np.cumsum(losses) / np.arange(1, len(losses) + 1)
        acc_run = np.cumsum(corrects) / np.maximum(np.cumsum(counts), 1.0)
        for i in range(len(host_rows)):
            step = epoch_first_step + i
            if step % summaries_frequency != 0:
                continue
            if self._train_csv is not None:
                self._train_csv.log([step, mean_loss_run[i], acc_run[i]]
                                    + [float(n) for n in norms[i]])
            if self._summary_writer is not None:
                self._summary_writer.scalar("learning_rate", lrs[i], step)
                self._summary_writer.scalars(
                    {"mean_loss": mean_loss_run[i], "accuracy": acc_run[i]}, step)
                if self._with_norms:
                    for name, value in zip(self.gradient_names, norms[i]):
                        self._summary_writer.scalar(name, float(value), step)
        return {"mean_loss": float(mean_loss_run[-1]), "accuracy": float(acc_run[-1])}

    # -- evaluation ---------------------------------------------------------------

    def _run_eval(self, iterator, num_steps: int) -> dict:
        """Evaluate num_steps batches, each through the eval step, their
        rows gathered on the device and read once."""
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}.")
        rows = torch.empty((num_steps, 3), dtype=torch.float32, device=self.device)
        for i in range(num_steps):
            images, labels = (self._to_device(a) for a in next(iterator))
            rows[i].copy_(self._eval_row(
                images, labels, images.new_ones(images.shape[0], dtype=torch.float32)))
        self.eval_metrics.reset()
        self.eval_metrics.update(rows[:, 0], rows[:, 1], rows[:, 2])
        return self.eval_metrics.results()

    def _device_eval(self, source: str) -> dict:
        """A full pass over the device-resident 'val' or 'train' arrays
        (`make_device_eval`), uploaded once."""
        if self._device_eval_fn is None:
            self._device_eval_fn = make_device_eval(self.model, self.batch_size, mesh=self.mesh)
        metrics = self._device_eval_fn(*self._device_data(source))
        self.eval_metrics.reset()
        self.eval_metrics.update(metrics["loss"], metrics["correct"], metrics["count"])
        return self.eval_metrics.results()

    def _evaluate(self, source: str, eval_steps: Optional[int],
                  prefer_device: bool = False) -> Optional[dict]:
        """Mid-training evaluation on 'val' or 'train'.  ``eval_steps=None``
        is one full pass when the example count is known; with
        ``prefer_device`` that pass is the device-resident evaluation.
        None where the dataset is not there (evaluation skipped)."""
        arrays = self._val_arrays if source == "val" else self._train_arrays
        if source == "val":
            stream = self.val_dataset
            n = self._num_val_examples
            full_pass = None if n is None else -(-n // self.batch_size)
        else:
            stream = self.train_dataset
            n = self._num_train_examples
            full_pass = None if n is None else max(1, n // self.batch_size)  # drops the remainder
        if stream is None and arrays is None:
            return None
        if eval_steps is not None and eval_steps < 1:
            raise ValueError(f"eval_steps must be >= 1, got {eval_steps}.")
        if prefer_device and arrays is not None:
            device_full = -(-len(arrays[0]) // self.batch_size)
            if eval_steps is None or eval_steps == device_full:
                return self._device_eval(source)
        if eval_steps is None:
            eval_steps = full_pass
        if eval_steps is None:
            raise ValueError(
                "eval_steps is required when the dataset was passed as a "
                "pipeline object (example count unknown)."
            )
        # 'val' reuses the repeating val iterator; 'train' gets a fresh
        # stream so evaluation never consumes training batches.
        iterator = self._val_iter if source == "val" else iter(stream)
        return self._run_eval(iterator, eval_steps)

    def evaluate(self, dataset: str = "val", num_steps: Optional[int] = None,
                 scan_steps: int = 0, device_data: bool = False) -> dict:
        """Standalone evaluation over a fresh pass of ``dataset`` ('val' or
        'train').  ``scan_steps`` is accepted for the JAX signature and
        changes nothing; ``device_data=True`` runs one full device-resident
        pass (array-backed data, ``num_steps`` None or the full-pass
        count)."""
        if dataset == "train":
            source = self.train_dataset
            n = self._num_train_examples
            full_pass = None if n is None else max(1, n // self.batch_size)
        elif dataset == "val":
            source = self.val_dataset
            n = self._num_val_examples
            full_pass = None if n is None else -(-n // self.batch_size)
        else:
            raise ValueError("dataset must be 'train' or 'val'.")
        if device_data:
            arrays = self._train_arrays if dataset == "train" else self._val_arrays
            if arrays is None:
                raise ValueError(f"evaluate(device_data=True) requires array-backed data for {dataset!r}.")
            device_full = -(-len(arrays[0]) // self.batch_size)
            if num_steps not in (None, device_full):
                raise ValueError(
                    f"evaluate(device_data=True) always runs one full pass ({device_full} "
                    f"batches); num_steps={num_steps} is not supported."
                )
            return self._device_eval(dataset)
        if source is None:
            raise ValueError(f"No {dataset} dataset available.")
        if num_steps is None:
            if full_pass is None:
                raise ValueError(
                    "num_steps is required when the dataset was passed as a "
                    "pipeline object (example count unknown)."
                )
            num_steps = full_pass
        return self._run_eval(iter(source), num_steps)

    # -- inference -----------------------------------------------------------------

    def predict(self, images: np.ndarray, batch_size: Optional[int] = None) -> np.ndarray:
        """Model outputs (softmax probabilities) for images, as a NumPy array.
        The last partial batch is padded with copies of its last image, so
        every batch has one shape (one captured graph on CUDA)."""
        batch_size = batch_size or self.batch_size
        outputs = []
        for start in range(0, len(images), batch_size):
            chunk = images[start:start + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            out = self._predict_step(self._to_device(chunk)).cpu().numpy()
            outputs.append(out[: len(out) - pad] if pad else out)
        return np.concatenate(outputs, axis=0)

    # -- persistence ------------------------------------------------------------------

    def _save(self, checkpointer: Checkpointer, name: str, tags, metrics) -> str:
        """Write a checkpoint: under a mesh rank 0 writes it (every rank
        holds the same state) and the ranks meet at a barrier.  Returns its
        path on every rank."""
        if self._writer:
            path = checkpointer.save(self.state, self.global_step, name=name, tags=tags,
                                     metrics=metrics)
        else:
            path = os.path.join(checkpointer.base_dir, checkpointer.checkpoint_name(
                self.global_step, name, tags, metrics))
        if self.mesh is not None:
            dist.barrier()
        return path

    def save(self, save_dir: str, tags: Sequence[str] = ("default",), name: str = "",
             saver: str = "torch") -> str:
        """Checkpoint the step, the model and the optimizer (reference
        `save`); under a mesh rank 0 writes it (`_save`)."""
        return self._save(Checkpointer(save_dir, backend=saver), name=name, tags=tags,
                          metrics={"loss": self.best_metrics["loss"],
                                   "accuracy": self.best_metrics["accuracy"]})

    def load_variables(self, path: str) -> None:
        """Restore a checkpoint into this trainer (reference
        `load_variables`): model, Adam slots and step, on every rank of a
        mesh.  The loops are built again, since the optimizer's state
        tensors are new."""
        path = os.path.abspath(path.rstrip("/"))
        Checkpointer(os.path.dirname(path)).restore(self.state, path)
        self._build_steps()

    def close(self) -> None:
        """Release the loggers (reference `close`)."""
        for writer in (self._summary_writer, self._eval_summary_writer):
            if writer is not None:
                writer.close()
        for logger in (self._train_csv, self._eval_csv):
            if logger is not None:
                logger.close()
