"""Serving export and load for the port.

Port of `differential_equations_resnet_tpu/utils/serving.py`.  An export
directory holds

    config.json   {"family", "batch_size", "quantize", "config"}, the JAX
                  package's schema
    params.pt     the model's state_dict (torch.save)

`load_exported` also serves a directory written by the JAX package: it reads
that package's ``config.json`` and ``params.pkl`` and ignores its StableHLO
``forward.hlo``.  ``params.pkl`` is read by a restricted unpickler that maps
the JAX package's parameter NamedTuples onto the port's own classes and
refuses every other global apart from NumPy's array reconstruction, so the
port never imports the JAX package.  Every kernel type is exported and
served; ``export_model(..., checkpoint=...)`` exports the parameters of a
training checkpoint (the port's `train.checkpoint` format).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    DTYPES,
    SingleBlockResNet,
    SingleBlockResNetConfig,
    build_single_block_resnet,
    dtype_name,
)
from differential_equations_resnet_tpu_torch.utils.weight_utils import (
    ParamsUnpickler,
    params_from_jax,
)

PARAMS_FILE = "params.pt"
JAX_PARAMS_FILE = "params.pkl"


def config_to_json(config: SingleBlockResNetConfig) -> dict:
    d = dataclasses.asdict(config)
    d["compute_dtype"] = dtype_name(d["compute_dtype"])
    return d


def config_from_json(d: dict) -> SingleBlockResNetConfig:
    d = dict(d)
    if d.get("compute_dtype") in DTYPES:
        d["compute_dtype"] = DTYPES[d["compute_dtype"]]
    for key in ("blocks_per_stage", "filters_per_block", "use_max_pooling", "image_shape"):
        if isinstance(d.get(key), list):
            d[key] = tuple(d[key])
    if isinstance(d.get("strides"), list):
        d["strides"] = tuple(tuple(s) for s in d["strides"])
    return SingleBlockResNetConfig(**d)


def export_model(
    model: SingleBlockResNet,
    output_dir: str,
    checkpoint: Optional[str] = None,
    batch_size: int = 1,
    quantize: Optional[str] = None,
) -> str:
    """Write ``model``'s config and parameters to ``output_dir``; returns its
    absolute path.  With ``checkpoint`` (a checkpoint directory written by
    `train.Checkpointer`, e.g. by ``Training.save`` or ``cli train
    --save-dir``) its parameters are first restored into ``model``, which
    must have the checkpoint's structure.  ``batch_size`` is recorded in the
    manifest as the JAX package records it; the port's loader serves any
    batch size."""
    if quantize == "int8":
        raise NotImplementedError("int8 serving waits on ROADMAP item A13.")
    if quantize is not None:
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if checkpoint is not None:
        from differential_equations_resnet_tpu_torch.train.checkpoint import Checkpointer
        from differential_equations_resnet_tpu_torch.train.train_step import (
            create_train_state,
        )

        path = os.path.abspath(checkpoint.rstrip("/"))
        Checkpointer(os.path.dirname(path)).restore(create_train_state(model), path)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(
            {
                "family": "single_block",
                "batch_size": int(batch_size),
                "quantize": None,
                "config": config_to_json(model.config),
            },
            f,
            indent=2,
        )
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(output_dir, PARAMS_FILE))
    return os.path.abspath(output_dir)


def _load_params(export_dir: str):
    """The parameter tree of an export, from the port's params.pt (as a
    state_dict) or the JAX package's params.pkl (as a tree)."""
    ours = os.path.join(export_dir, PARAMS_FILE)
    if os.path.isfile(ours):
        return torch.load(ours, map_location="cpu", weights_only=True), None
    with open(os.path.join(export_dir, JAX_PARAMS_FILE), "rb") as f:
        blobs = ParamsUnpickler(f).load()
    return None, params_from_jax(blobs["params"])


def load_exported(
    export_dir: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """Load a serving export (the port's or the JAX package's).  Returns
    ``(predict, manifest)``: ``predict(images (B, H, W, C) float32) ->
    probabilities`` as a NumPy array, for any batch size B.

    Runs on CUDA unless ``device`` says otherwise; raises where CUDA is
    missing and the CPU was not asked for."""
    device = resolve_device(device)
    with open(os.path.join(export_dir, "config.json")) as f:
        manifest = json.load(f)
    if manifest.get("quantize") == "int8":
        raise NotImplementedError("int8 serving waits on ROADMAP item A13.")
    if manifest.get("family") != "single_block":
        raise NotImplementedError(
            f"model family {manifest.get('family')!r} waits on ROADMAP item A12."
        )
    config = config_from_json(manifest["config"])
    state_dict, params = _load_params(export_dir)
    if params is None:
        model = build_single_block_resnet(
            config, generator=torch.Generator().manual_seed(0), device=device
        )
        model.load_state_dict(state_dict, strict=True)
    else:
        model = build_single_block_resnet(config, params=params, device=device)
    model.eval()

    def predict(images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, dtype=np.float32)).to(device)
            return model(x).cpu().numpy()

    return predict, manifest
