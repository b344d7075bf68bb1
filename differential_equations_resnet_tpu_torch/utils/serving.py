"""Serving export and load for the port.

Port of `differential_equations_resnet_tpu/utils/serving.py`.  An export
directory holds

    config.json   {"family", "batch_size", "quantize", "config"}, the JAX
                  package's schema; the family is "single_block" or
                  "bottleneck"
    params.pt     the model's state_dict (torch.save): its parameters and
                  its batch-norm running statistics
    forward.pt2   the eval forward (probabilities) at the manifest's batch
                  size, traced by `torch.export` and saved with
                  `torch.export.save`: a program of aten ops and B1's
                  dispatcher op (``deqres_torch::fused_euler_fwd``) that
                  runs without the model's Python code.  It takes the place
                  of the JAX package's StableHLO ``forward.hlo``; it is not
                  StableHLO.

`load_exported` serves ``forward.pt2`` where the batch is the manifest's
and rebuilds the model from config and parameters for any other batch, for
``prefer_stablehlo=False`` and for an export without the program.  On the
card the manifest's batch replays one captured CUDA graph (one launch of
B1 a request of a fused model); other batches run eagerly.  The program
runs with cuDNN's TF32 off, as the model's own convolutions do (the flag
is global and ``torch.export`` does not record it).  A ``forward.pt2``
that is there and preferred but does not load or run raises: nothing
falls back to the rebuilt path.

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
the JAX package does, and traces `models.quantized.QuantizedForward` into
``forward.pt2``: its weights are quantized at export, as the JAX package
quantizes inside its traced forward.  ``params.pt`` keeps the fp32 weights,
which the rebuilt path quantizes when the export is loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from differential_equations_resnet_tpu_torch import resolve_device
from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import (
    BottleneckResNet,
    BottleneckResNetConfig,
)
from differential_equations_resnet_tpu_torch.models.quantized import QuantizedForward
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    DTYPES,
    SingleBlockResNet,
    SingleBlockResNetConfig,
    _named_leaves,
    dtype_name,
)
from differential_equations_resnet_tpu_torch.ops.conv import cudnn_tf32_off
from differential_equations_resnet_tpu_torch.train.train_step import _Replayed
from differential_equations_resnet_tpu_torch.utils.tracing import span
from differential_equations_resnet_tpu_torch.utils.weight_utils import (
    ParamsUnpickler,
    params_from_jax,
    state_from_jax,
)

PARAMS_FILE = "params.pt"
FORWARD_FILE = "forward.pt2"
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


class _Probabilities(nn.Module):
    """The eval forward `export_model` traces: ``model``'s probabilities,
    batch norm on the running statistics."""

    def __init__(self, model):
        super().__init__()
        self.model, self.config = model, model.config

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, train=False)


def _load_trees(model, params, model_state) -> None:
    """``params`` (and ``model_state``, where given) copied into ``model``'s
    parameters and buffers; the trees must have the model's structure."""
    values = model.state_dict()
    values.update(_named_leaves(params))
    if model_state is not None:
        values.update(_named_leaves(model_state))
    model.load_state_dict(values, strict=True)


def export_model(
    model: Union[SingleBlockResNet, BottleneckResNet],
    output_dir: str,
    checkpoint: Optional[str] = None,
    params: Any = None,
    model_state: Any = None,
    batch_size: int = 1,
    stablehlo: bool = True,
    seed: int = 0,
    quantize: Optional[str] = None,
) -> str:
    """Write ``model``'s serving export to ``output_dir``; returns its
    absolute path.  The JAX package's signature and defaults.

    The parameters and state exported are, in this order of priority,
    ``params`` / ``model_state`` (the port's trees, as ``model.params()`` /
    ``model.state()`` give them), those of ``checkpoint`` (a checkpoint
    directory written by `train.Checkpointer`, e.g. by ``Training.save`` or
    ``cli train --save-dir``), or the model's own; either of the first two
    is loaded into ``model`` first, which must have its structure.  ``seed``
    is accepted and ignored: the port's model holds its own parameters (as
    `train.Training` does with its seed).

    ``stablehlo=True`` (the JAX keyword, kept so that code written against
    the JAX package runs) also writes ``forward.pt2``: `torch.export` of the
    eval forward at (``batch_size``, *image_shape) float32 on the model's
    device, not StableHLO (module docstring).  ``quantize="int8"`` marks the
    export for int8 serving and traces the int8 forward."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if params is not None:
        _load_trees(model, params, model_state)
    elif checkpoint is not None:
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
    if stablehlo:
        device = next(model.parameters()).device
        x = torch.zeros((batch_size, *model.config.image_shape), dtype=torch.float32,
                        device=device)
        served = QuantizedForward(model) if quantize == "int8" else _Probabilities(model)
        with torch.no_grad():
            program = torch.export.export(served, (x,))
        torch.export.save(program, os.path.join(output_dir, FORWARD_FILE))
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


def _rebuilt_forward(export_dir: str, manifest: dict, device: torch.device):
    """The model rebuilt from the export's config and parameters (the
    port's or the JAX package's): its eval forward, or the int8 one for an
    export marked so."""
    model_cls = _family(manifest.get("family"))[1]
    config = config_from_json(manifest["config"], manifest["family"])
    state_dict, params, state = _load_params(export_dir)
    if params is None:
        model = model_cls(config, generator=torch.Generator().manual_seed(0), device=device)
        model.load_state_dict(state_dict, strict=True)
    else:
        model = model_cls(config, params, state, device=device)
    model.eval()
    return QuantizedForward(model) if manifest.get("quantize") == "int8" else _Probabilities(model)


class _Fp32Program(nn.Module):
    """A loaded program run with cuDNN's TF32 off (on the CPU the flag
    changes nothing).  The model's convolutions switch it off themselves
    (`ops.conv.cudnn_tf32_off`), but the switch is a global flag that
    ``torch.export`` does not record, so without this the program's fp32
    convolutions would run, and be captured, in TF32."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self.program = program

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with cudnn_tf32_off():
            return self.program(x)


def load_program(path: str, device: torch.device) -> nn.Module:
    """``forward.pt2`` loaded and moved to ``device`` (an export made on
    the CPU runs on the card), as a module that runs with cuDNN's TF32 off
    (`_Fp32Program`); raises where it does not load."""
    from torch.export.passes import move_to_device_pass

    try:
        program = torch.export.load(path)
    except Exception as e:  # a corrupt or foreign file: name it, never fall back
        raise RuntimeError(f"the compiled forward {path} does not load: {e}") from e
    return _Fp32Program(move_to_device_pass(program, str(device)).module())


def load_exported(
    export_dir: str,
    prefer_stablehlo: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """Load a serving export (the port's or the JAX package's, either
    family).  Returns ``(predict, manifest)``: ``predict(images (B, H, W,
    C) float32) -> probabilities`` (eval mode: batch norm on the running
    statistics) as a NumPy array, for any batch size B; for an export
    marked ``"quantize": "int8"`` with int8 convs
    (`models.quantized.QuantizedForward`).

    A batch of the manifest's size runs the export's ``forward.pt2`` where
    it has one and ``prefer_stablehlo`` (the JAX keyword) is true; every
    other batch, and every batch of a JAX export, runs the model rebuilt
    from config and parameters, which is built only when a batch first
    needs it.  On CUDA the manifest's batch replays one captured CUDA
    graph (`train.train_step._Replayed`), so a predictor holds at most
    one; other batch sizes run eagerly.  A ``forward.pt2`` that is
    preferred but does not load or run raises.

    ``predict`` may be called from several threads: it serves one request
    at a time (a replayed graph's inputs and outputs are shared buffers).

    Runs on CUDA unless ``device`` says otherwise; raises where CUDA is
    missing and the CPU was not asked for."""
    device = resolve_device(device)
    with open(os.path.join(export_dir, "config.json")) as f:
        manifest = json.load(f)
    config = config_from_json(manifest["config"], manifest.get("family"))
    program_path = os.path.join(export_dir, FORWARD_FILE)
    paths = {"compiled": None, "rebuilt": None}
    if prefer_stablehlo and os.path.isfile(program_path):
        paths["compiled"] = load_program(program_path, device)
    else:
        paths["rebuilt"] = _rebuilt_forward(export_dir, manifest, device)
    batch_shape = (int(manifest["batch_size"]), *config.image_shape)
    replayed = {}  # path -> its graph at the manifest's batch (CUDA only)
    routes = {"compiled": 0, "rebuilt": 0}
    lock = threading.Lock()

    def predict(images: np.ndarray) -> np.ndarray:
        with span("deqres.predict.h2d"):
            x = torch.as_tensor(np.asarray(images, dtype=np.float32)).to(device)
        fits = tuple(x.shape) == batch_shape
        route = "compiled" if paths["compiled"] is not None and fits else "rebuilt"
        with lock, torch.no_grad():
            routes[route] += 1
            if paths[route] is None:
                paths[route] = _rebuilt_forward(export_dir, manifest, device)
            forward = paths[route]
            if device.type == "cuda" and fits:
                if route not in replayed:
                    replayed[route] = _Replayed(f"{route} serving forward", forward)
                forward = replayed[route]
            out = forward(x)
            with span("deqres.predict.d2h"):
                return out.cpu().numpy()

    # Requests served by each path.  ``predict`` must not refer to itself:
    # in a reference cycle its captured graphs would be destroyed whenever
    # the garbage collector runs, which, during another graph's capture,
    # invalidates that capture.
    predict.routes = routes
    return predict, manifest
