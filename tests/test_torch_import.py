"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, its sources import neither, and its entry points refuse to run on
the CPU unless asked to."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import differential_equations_resnet_tpu_torch as port
from differential_equations_resnet_tpu_torch.utils.serving import load_exported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "differential_equations_resnet_tpu_torch")


def port_modules():
    return [
        m.name for m in pkgutil.walk_packages([PORT_DIR], prefix=port.__name__ + ".")
    ]


def test_fresh_import_loads_no_jax():
    modules = [port.__name__, *port_modules()]
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'differential_equations_resnet_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, check=True, timeout=300,
    )
    assert len(modules) >= 12
    assert {f"{port.__name__}.train.{name}"
            for name in ("metrics", "schedules", "telemetry", "train_step")} <= set(modules)
    assert {f"{port.__name__}.{name}" for name in (
        "ops.integrators", "experiments", "experiments.deep_stability", "experiments.sweeps",
        "utils.weight_utils", "cli", "data.records", "data.preprocessors", "data.mnist",
        "native.codec", "native.loader")} <= set(modules)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|differential_equations_resnet_tpu)(\.|\s|$)",
    re.MULTILINE,
)


@pytest.mark.parametrize(
    "path",
    sorted(
        os.path.relpath(os.path.join(root, f), REPO)
        for root, _, files in os.walk(PORT_DIR) for f in files if f.endswith(".py")
    ) + ["chip_smoke.py"],
)
def test_source_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        source = f.read()
    assert not _FORBIDDEN.findall(source), path


def test_resolve_device(monkeypatch):
    assert port.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="No CUDA device"):
        port.resolve_device("cuda")


def test_load_exported_without_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        load_exported(str(tmp_path))
