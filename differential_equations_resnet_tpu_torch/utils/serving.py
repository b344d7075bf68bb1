"""Serving export and load for the port.

Port of `differential_equations_resnet_tpu/utils/serving.py`.  An export
directory holds

    config.json   {"family", "batch_size", "quantize", "config"}, the JAX
                  package's schema; the family is "single_block" or
                  "bottleneck"
    params.pt     the model's state_dict (torch.save): its parameters and
                  its batch-norm running statistics

`load_exported` also serves a directory written by the JAX package: it reads
that package's ``config.json`` and ``params.pkl`` (``params`` and
``model_state``) and ignores its StableHLO ``forward.hlo``.  ``params.pkl``
is read by a restricted unpickler that maps the JAX package's parameter
NamedTuples onto the port's own classes and refuses every other global apart
from NumPy's array reconstruction, so the port never imports the JAX
package.  Both families and every kernel type are exported and served;
``export_model(..., checkpoint=...)`` exports the parameters and state of a
training checkpoint (the port's `train.checkpoint` format).

``quantize="int8"`` records ``"quantize": "int8"`` in ``config.json``, as
the JAX package does; the parameters stay fp32 and the weights are
quantized when the export is loaded.  `load_exported` serves an int8 export
of either package through `models.quantized.make_quantized_forward`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import (
    BottleneckResNet,
    BottleneckResNetConfig,
)
from differential_equations_resnet_tpu_torch.models.quantized import make_quantized_forward
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    DTYPES,
    SingleBlockResNet,
    SingleBlockResNetConfig,
    dtype_name,
)
from differential_equations_resnet_tpu_torch.utils.weight_utils import (
    ParamsUnpickler,
    params_from_jax,
    state_from_jax,
)

PARAMS_FILE = "params.pt"
JAX_PARAMS_FILE = "params.pkl"
# Each family's (config class, model class), by the manifest's name.
FAMILIES = {
    "single_block": (SingleBlockResNetConfig, SingleBlockResNet),
    "bottleneck": (BottleneckResNetConfig, BottleneckResNet),
}


def config_to_json(config) -> dict:
    d = dataclasses.asdict(config)
    d["compute_dtype"] = dtype_name(d["compute_dtype"])
    return d


def config_from_json(d: dict, family: str = "single_block"):
    """The config of a manifest's ``"config"`` (either package's) for
    ``family``."""
    d = dict(d)
    if d.get("compute_dtype") in DTYPES:
        d["compute_dtype"] = DTYPES[d["compute_dtype"]]
    for key in ("blocks_per_stage", "use_max_pooling", "image_shape"):
        if isinstance(d.get(key), list):
            d[key] = tuple(d[key])
    if isinstance(d.get("filters_per_block"), list):
        d["filters_per_block"] = tuple(tuple(f) if isinstance(f, list) else f
                                       for f in d["filters_per_block"])
    if isinstance(d.get("strides"), list):
        d["strides"] = tuple(tuple(s) for s in d["strides"])
    return _family(family)[0](**d)


def _family(name: str):
    if name not in FAMILIES:
        raise ValueError(f"unknown model family {name!r}; expected one of {sorted(FAMILIES)}")
    return FAMILIES[name]


def export_model(
    model: Union[SingleBlockResNet, BottleneckResNet],
    output_dir: str,
    checkpoint: Optional[str] = None,
    batch_size: int = 1,
    quantize: Optional[str] = None,
) -> str:
    """Write ``model``'s config, parameters and state to ``output_dir``;
    returns its absolute path.  With ``checkpoint`` (a checkpoint directory
    written by `train.Checkpointer`, e.g. by ``Training.save`` or ``cli
    train --save-dir``) its parameters and state are first restored into
    ``model``, which must have the checkpoint's structure.  ``batch_size``
    is recorded in the manifest as the JAX package records it; the port's
    loader serves any batch size.  ``quantize="int8"`` marks the export for
    int8 serving (module docstring)."""
    if quantize not in (None, "int8"):
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
                "family": next(name for name, (_, cls) in FAMILIES.items()
                               if isinstance(model, cls)),
                "batch_size": int(batch_size),
                "quantize": quantize,
                "config": config_to_json(model.config),
            },
            f,
            indent=2,
        )
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(output_dir, PARAMS_FILE))
    return os.path.abspath(output_dir)


def _load_params(export_dir: str):
    """(state_dict, None, None) of the port's params.pt, or (None, params,
    state) trees of the JAX package's params.pkl."""
    ours = os.path.join(export_dir, PARAMS_FILE)
    if os.path.isfile(ours):
        return torch.load(ours, map_location="cpu", weights_only=True), None, None
    with open(os.path.join(export_dir, JAX_PARAMS_FILE), "rb") as f:
        blobs = ParamsUnpickler(f).load()
    return None, params_from_jax(blobs["params"]), state_from_jax(blobs["model_state"])


def load_exported(
    export_dir: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """Load a serving export (the port's or the JAX package's, either
    family).  Returns ``(predict, manifest)``: ``predict(images (B, H, W,
    C) float32) -> probabilities`` (eval mode: batch norm on the running
    statistics) as a NumPy array, for any batch size B; for an export
    marked ``"quantize": "int8"`` with int8 convs
    (`models.quantized.make_quantized_forward`).

    Runs on CUDA unless ``device`` says otherwise; raises where CUDA is
    missing and the CPU was not asked for."""
    device = resolve_device(device)
    with open(os.path.join(export_dir, "config.json")) as f:
        manifest = json.load(f)
    model_cls = _family(manifest.get("family"))[1]
    config = config_from_json(manifest["config"], manifest["family"])
    state_dict, params, state = _load_params(export_dir)
    if params is None:
        model = model_cls(config, generator=torch.Generator().manual_seed(0), device=device)
        model.load_state_dict(state_dict, strict=True)
    else:
        model = model_cls(config, params, state, device=device)
    model.eval()
    forward = make_quantized_forward(model) if manifest.get("quantize") == "int8" else model

    def predict(images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, dtype=np.float32)).to(device)
            return forward(x).cpu().numpy()

    return predict, manifest
