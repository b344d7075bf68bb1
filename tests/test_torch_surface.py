"""The port's import surface: every public name of every JAX `__init__`
(the names it imports, read from its source) resolves in the port's
counterpart, `ops.pallas` mapping to `ops.kernels`; the port's lazy names
load no JAX."""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = "differential_equations_resnet_tpu"
PORT = "differential_equations_resnet_tpu_torch"
# JAX __init__ (relative to the package) -> the port's counterpart module.
MODULES = {
    "": "",
    "models": "models",
    "ops": "ops",
    "ops.pallas": "ops.kernels",
    "utils": "utils",
    "train": "train",
    "data": "data",
    "experiments": "experiments",
    "parallel": "parallel",
    "native": "native",
}


def public_names(module: str):
    """The names the JAX package's ``__init__`` of ``module`` imports, from
    its source (so no worker's import history changes the list)."""
    path = os.path.join(REPO, JAX_PACKAGE, *module.split(".") if module else [], "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
    return [n for n in names if not n.startswith("_")]


@pytest.mark.parametrize("module", list(MODULES), ids=[m or "package" for m in MODULES])
def test_every_public_name_resolves(module):
    names = public_names(module)
    assert names
    target = ".".join(p for p in (PORT, MODULES[module]) if p)
    port = importlib.import_module(target)
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{target} lacks {missing}"


def test_lazy_names_load_no_jax():
    """Resolving every lazy name in a fresh process imports neither JAX nor
    the JAX package."""
    lookups = "".join(
        f"getattr(importlib.import_module({'.'.join(p for p in (PORT, port) if p)!r}), {n!r})\n"
        for module, port in MODULES.items() for n in public_names(module))
    code = ("import importlib, json, sys\n" + lookups
            + "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
              f"('jax', 'jaxlib', {JAX_PACKAGE!r}))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_single_block_build_function():
    from differential_equations_resnet_tpu_torch.models import (
        SingleBlockResNet,
        get_single_block_resnet_build_function,
    )
    import torch

    build = get_single_block_resnet_build_function(
        image_shape=(32, 32, 3), num_stages=2, blocks_per_stage=[2], filters_per_block=[4],
        strides=[(1, 1)], num_classes=10, h=0.125, generator=torch.Generator().manual_seed(0),
        device="cpu")
    model = build()
    assert isinstance(model, SingleBlockResNet) and model.config.blocks_per_stage == (2,)
