"""Streaming metrics with explicit reset, on torch tensors.

Port of `differential_equations_resnet_tpu/train/metrics.py`: per-batch
scalars stay on the device as the train and eval steps return them, and a
drain reduces them there and copies the three sums to the host at once."""

from __future__ import annotations

import torch


class StreamingMetrics:
    """Accumulates the mean loss (the unweighted mean of batch losses, as
    tf.metrics.mean over per-batch scalars) and the accuracy (total correct
    over total examples, as tf.metrics.accuracy)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._pending = []  # (loss, correct, count): tensors or numbers
        self._loss_sum = 0.0
        self._loss_batches = 0
        self._correct = 0.0
        self._count = 0.0

    def update(self, loss, correct, count) -> None:
        """Record one batch, or a (K,) vector of K batches.  Device tensors
        are kept as they are: the host waits for them only in a drain."""
        self._pending.append((loss, correct, count))

    def _drain(self) -> None:
        if not self._pending:
            return
        device = next((v.device for p in self._pending for v in p
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
        columns = [
            torch.cat([torch.as_tensor(p[i], dtype=torch.float32, device=device).reshape(-1)
                       for p in self._pending])
            for i in range(3)
        ]
        sums = torch.stack([c.sum() for c in columns]).tolist()  # one copy to the host
        self._loss_sum += sums[0]
        self._loss_batches += int(columns[0].numel())
        self._correct += sums[1]
        self._count += sums[2]
        self._pending.clear()

    @property
    def mean_loss(self) -> float:
        self._drain()
        return self._loss_sum / max(self._loss_batches, 1)

    @property
    def accuracy(self) -> float:
        self._drain()
        return self._correct / max(self._count, 1.0)

    def results(self) -> dict:
        return {"mean_loss": self.mean_loss, "accuracy": self.accuracy}
