"""Checkpoint and resume.

Port of `differential_equations_resnet_tpu/train/checkpoint.py` on
`torch.save`: a checkpoint is a directory under a metric-encoded name
(``[name_][tags_]step-00000042[_loss-0.1234_accuracy-0.5000]``) holding
``state.pt`` = {"step", "model" (the model's state_dict: its parameters and
its batch-norm running statistics), "optimizer" (the optimizer's state_dict,
Adam slots included)}, beside a sidecar
``<name>.meta.json`` with the step, the monitored metrics and a structure
fingerprint that stands in for the JAX package's treedef: the state_dict's
keys and shapes and the optimizer's state layout.  `restore` loads with
``torch.load(weights_only=True)`` onto the model's device and raises
`ValueError` when the structure drifted.  The JAX package's Orbax and pickle
checkpoints cannot be read without JAX and are out of scope.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def structure(state) -> dict:
    """The structure fingerprint of a `TrainState`: every state_dict key with
    its shape, and the optimizer's class, parameters per group and, for each
    parameter that has state, that state's keys and shapes."""
    model = {k: list(v.shape) for k, v in state.model.state_dict().items()}
    optimizer = state.optimizer
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    slots = {
        str(index[id(p)]): {k: list(v.shape) if isinstance(v, torch.Tensor) else type(v).__name__
                            for k, v in sorted(s.items())}
        for p, s in optimizer.state.items() if s
    }
    return {"model": model, "optimizer": {
        "class": type(optimizer).__name__,
        "groups": [len(group["params"]) for group in optimizer.param_groups],
        "state": slots,
    }}


def _drift(saved: dict, target: dict) -> str:
    """Where two fingerprints disagree ("" where they agree).  A parameter
    with no optimizer state on one side (an optimizer not yet stepped)
    agrees with any state on the other."""
    if saved["model"] != target["model"]:
        keys = sorted(set(saved["model"]) ^ set(target["model"])) or [
            k for k in saved["model"] if saved["model"][k] != target["model"].get(k)]
        return f"model state_dict differs at {keys[:5]}"
    s, t = saved["optimizer"], target["optimizer"]
    if (s["class"], s["groups"]) != (t["class"], t["groups"]):
        return (f"optimizer {s['class']} with groups {s['groups']} saved, "
                f"{t['class']} with {t['groups']} in the target")
    for i in set(s["state"]) & set(t["state"]):
        if s["state"][i] != t["state"][i]:
            return f"optimizer state of parameter {i}: {s['state'][i]} saved, {t['state'][i]} in the target"
    return ""


class Checkpointer:
    """Save and restore `TrainState`s under metric-encoded directory names
    (parity with the reference `Training.save`, which embeds tags and the
    monitored metrics in the checkpoint name), keeping the newest
    ``max_to_keep``."""

    def __init__(self, base_dir: str, backend: str = "torch", max_to_keep: Optional[int] = 5):
        if backend != "torch":
            raise ValueError(
                f"The port writes torch checkpoints (backend='torch'), not {backend!r}: the "
                "JAX package's Orbax and pickle checkpoints need JAX."
            )
        self.base_dir = os.path.abspath(base_dir)
        self.backend = backend
        self.max_to_keep = max_to_keep
        os.makedirs(self.base_dir, exist_ok=True)

    # -- naming -------------------------------------------------------------

    def checkpoint_name(self, step: int, name: str = "", tags=(), metrics=None) -> str:
        parts = [name] if name else []
        parts += list(tags or [])
        parts.append(f"step-{int(step):08d}")
        for key, value in (metrics or {}).items():
            parts.append(f"{key}-{value:.4f}")
        return "_".join(parts)

    def _path(self, checkpoint_name: str) -> str:
        return os.path.join(self.base_dir, checkpoint_name)

    def list_checkpoints(self):
        if not os.path.isdir(self.base_dir):
            return []
        return [
            d for d in sorted(os.listdir(self.base_dir))
            if re.search(r"step-\d+", d) and not d.endswith(".meta.json")
        ]

    def latest(self) -> Optional[str]:
        entries = self.list_checkpoints()
        if not entries:
            return None
        return max(entries, key=lambda d: int(re.search(r"step-(\d+)", d).group(1)))

    # -- save/restore ---------------------------------------------------------

    def save(self, state: Any, step: int, name: str = "", tags=(), metrics=None) -> str:
        """Write ``state`` (a `TrainState`) and its sidecar; returns the
        checkpoint's path."""
        path = self._path(self.checkpoint_name(step, name, tags, metrics))
        os.makedirs(path, exist_ok=True)
        torch.save({"step": int(step), "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()},
                   os.path.join(path, STATE_FILE))
        meta = {
            "step": int(step),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "structure": structure(state),
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        self._garbage_collect()
        return path

    def read_meta(self, path: str) -> Optional[dict]:
        """The sidecar of a checkpoint path (None where there is none)."""
        meta_path = path.rstrip("/") + ".meta.json"
        if not os.path.isfile(meta_path):
            return None
        with open(meta_path) as f:
            return json.load(f)

    def restore(self, target: Any, path: Optional[str] = None) -> Any:
        """Load a checkpoint into ``target`` (a `TrainState`: its model and
        optimizer, in place, tensors onto the model's device) and return it
        with the saved step.  ``path`` defaults to the latest.  The
        optimizer keeps its own kind of learning rate (a device tensor for a
        capturable Adam) and its ``capturable``/``foreach``/``fused``
        settings; its state and other hyperparameters come from the
        checkpoint.  Raises `ValueError` when the checkpoint's structure
        differs from the target's."""
        if path is None:
            name = self.latest()
            if name is None:
                raise FileNotFoundError(f"No checkpoints in {self.base_dir}.")
            path = self._path(name)
        meta = self.read_meta(path)
        target_structure = structure(target)
        if meta is not None and "structure" in meta:
            drift = _drift(meta["structure"], target_structure)
            if drift:
                raise ValueError(
                    f"Checkpoint {path} was saved with a different structure than the "
                    f"restore target: {drift}."
                )
        device = next(target.model.parameters()).device
        payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                             weights_only=True)
        target.model.load_state_dict(payload["model"])
        saved_opt = payload["optimizer"]
        for saved, group in zip(saved_opt["param_groups"], target.optimizer.param_groups):
            for key in ("capturable", "foreach", "fused", "differentiable"):
                if key in group:
                    saved[key] = group[key]
            if isinstance(group["lr"], torch.Tensor):
                saved["lr"] = torch.as_tensor(saved["lr"], dtype=group["lr"].dtype).to(
                    group["lr"].device)
            else:
                saved["lr"] = float(saved["lr"])
        target.optimizer.load_state_dict(saved_opt)
        target.step = int(payload["step"])
        return target

    def _garbage_collect(self) -> None:
        if self.max_to_keep is None:
            return
        entries = self.list_checkpoints()
        entries.sort(key=lambda d: int(re.search(r"step-(\d+)", d).group(1)))
        for stale in entries[: max(0, len(entries) - self.max_to_keep)]:
            shutil.rmtree(self._path(stale), ignore_errors=True)
            try:
                os.unlink(self._path(stale) + ".meta.json")
            except OSError:
                pass
