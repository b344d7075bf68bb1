"""Offline analysis of training telemetry CSVs.

Library port of the `TrainingHistory` class embedded in the reference's v7
experiment notebook (cell 27): loaders for the gradient-history and
evaluation-metrics CSVs plus the three scalar gradient-flow diagnostics used
as the paper-style evidence (relative deviation, per-step std over layers,
last/first-layer ratio), and the 3-D surface plot of gradient norm x layer x
step (matplotlib gated).

A copy of `differential_equations_resnet_tpu/train/history.py`, kept in the
port so that it imports no JAX; matplotlib is imported only inside the
plotting methods."""

from __future__ import annotations

import csv
from typing import Optional, Sequence, Tuple

import numpy as np


def _bounds(bounds, default_stop):
    start = 0 if bounds[0] is None else bounds[0]
    stop = default_stop if bounds[1] is None else bounds[1]
    step = 1 if bounds[2] is None else bounds[2]
    return start, stop, step


class TrainingHistory:
    """Loads the space-delimited CSVs written by `Training`
    (columns: global_step mean_loss accuracy [per-layer gradient norms...])."""

    def __init__(
        self,
        training_history_filepath: Optional[str] = None,
        evaluation_history_filepath: Optional[str] = None,
        delimiter: str = " ",
    ):
        if training_history_filepath is not None:
            steps, losses, accs, gnorms = [], [], [], []
            with open(training_history_filepath, "r") as fp:
                reader = csv.reader(fp, delimiter=delimiter)
                self.training_header = next(reader)
                self.gradient_names = self.training_header[3:]
                for row in reader:
                    steps.append(int(row[0]))
                    losses.append(float(row[1]))
                    accs.append(float(row[2]))
                    gnorms.append(np.asarray(row[3:], dtype=np.float64))
            if not gnorms:
                raise ValueError(
                    f"{training_history_filepath} has a header but no data "
                    "rows — the run was interrupted before its first "
                    "telemetry flush (rows are written every "
                    "summaries_frequency steps)."
                )
            self.training_steps = np.asarray(steps)
            self.training_mean_loss = np.asarray(losses)
            self.training_accuracy = np.asarray(accs)
            self.gradient_norms = np.stack(gnorms, axis=0)
            self.num_time_steps_training, self.num_layers = self.gradient_norms.shape

        if evaluation_history_filepath is not None:
            steps, losses, accs = [], [], []
            with open(evaluation_history_filepath, "r") as fp:
                reader = csv.reader(fp, delimiter=delimiter)
                self.evaluation_header = next(reader)
                for row in reader:
                    steps.append(int(row[0]))
                    losses.append(float(row[1]))
                    accs.append(float(row[2]))
            self.evaluation_steps = np.asarray(steps)
            self.evaluation_mean_loss = np.asarray(losses)
            self.evaluation_accuracy = np.asarray(accs)

    # -- scalar diagnostics ---------------------------------------------------

    def gradient_norm_relative_deviation(
        self,
        reduce: bool = True,
        layer_bounds: Tuple = (1, None, None),
        step_bounds: Tuple = (None, None, 100),
    ):
        """sqrt(mean((g_i / mean_i(g))^2)) over layers (and steps if
        reduce=True).  1.0 means perfectly uniform gradient flow over depth.
        By default layer 0 (the stem conv) is excluded, as in the notebook."""
        ls, lstop, lstep = _bounds(layer_bounds, self.num_layers)
        g = self.gradient_norms[:, ls:lstop:lstep]
        means = np.mean(g, axis=1)
        deviations = np.power(g / means[:, None], 2)
        axis = None if reduce else 1
        reduced = np.sqrt(np.average(deviations, axis=axis))
        if reduce:
            return reduced
        ss, sstop, sstep = _bounds(step_bounds, self.num_time_steps_training)
        return reduced[ss:sstop:sstep]

    def gradient_norm_standard_deviation(
        self,
        reduce: bool = True,
        layer_bounds: Tuple = (1, None, 2),
        step_bounds: Tuple = (None, None, 100),
    ):
        """Per-step std of gradient norms over layers (mean over steps if
        reduce=True)."""
        ls, lstop, lstep = _bounds(layer_bounds, self.num_layers)
        stds = np.std(self.gradient_norms[:, ls:lstop:lstep], axis=1)
        if reduce:
            return np.average(stds)
        ss, sstop, sstep = _bounds(step_bounds, self.num_time_steps_training)
        return stds[ss:sstop:sstep]

    def gradient_norm_relative_comparison(
        self,
        reduce: bool = True,
        last: int = -1,
        first: int = 0,
        step_bounds: Tuple = (None, None, 100),
    ):
        """Ratio of the last layer's gradient norm to the first layer's —
        ~1 indicates no vanishing/exploding across depth."""
        ss, sstop, sstep = _bounds(step_bounds, self.num_time_steps_training)
        relative = (
            self.gradient_norms[ss:sstop:sstep, last]
            / self.gradient_norms[ss:sstop:sstep, first]
        )
        return np.average(relative) if reduce else relative

    # -- plotting (matplotlib gated) -------------------------------------------

    def plot_gradient_norm_surface(self, step_stride: int = 10, **surface_kwargs):
        """3-D surface of gradient norm x layer x training step (the v7
        notebook's headline figure)."""
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

        g = self.gradient_norms[::step_stride]
        steps = self.training_steps[::step_stride]
        layers = np.arange(self.num_layers)
        xx, yy = np.meshgrid(layers, steps)
        fig = plt.figure(figsize=(12, 8))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_surface(xx, yy, g, **surface_kwargs)
        ax.set_xlabel("layer")
        ax.set_ylabel("training step")
        ax.set_zlabel("gradient mean norm")
        return fig, ax

    def plot_metrics(self):
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
        ax1.plot(self.training_steps, self.training_mean_loss, label="train loss")
        if hasattr(self, "evaluation_steps"):
            ax1.plot(self.evaluation_steps, self.evaluation_mean_loss, label="val loss")
        ax1.set_xlabel("step"), ax1.legend()
        ax2.plot(self.training_steps, self.training_accuracy, label="train acc")
        if hasattr(self, "evaluation_steps"):
            ax2.plot(self.evaluation_steps, self.evaluation_accuracy, label="val acc")
        ax2.set_xlabel("step"), ax2.legend()
        return fig, (ax1, ax2)


def plot_lines(
    lines: Sequence[np.ndarray],
    labels: Sequence[str],
    xlabel: str = "",
    ylabel: str = "",
    x: Optional[np.ndarray] = None,
):
    """Helper mirroring the notebook's `plot_lines` (v7 nb cell 27)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    for line, label in zip(lines, labels):
        if x is None:
            ax.plot(line, label=label)
        else:
            ax.plot(x, line, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    return fig, ax
