"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- a configuration: the file its ``configs`` entry names;
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's correctness limits: ``cells/<cell>.json``;
- the runner of a traffic's ``kind``: ``kinds/<kind>.py``;
- a per-layer metric's reader: ``metrics/<metric>.py``, a module with
  ``read(ctx) -> float or None``.

A later cell, configuration, mix or metric is added as files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str) -> ModuleType:
    """The module in the file ``path`` (whose name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench._found.{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    checkout) and ``home`` (the benchmark's folder)."""

    def __init__(self, root: Path, home: Path = HERE, spec: Optional[dict] = None):
        self.root, self.home = Path(root), Path(home)
        self.spec = spec if spec is not None else _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for config in self.spec["configs"]:
            if config["name"] == name:
                return config
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.root / self.config_entry(name)["file"])

    def traffic(self, name: str) -> dict:
        return _json(self.home / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _json(self.home / "cells" / f"{cell}.json")["limits"]

    def kind(self, name: str) -> ModuleType:
        return load_module(self.home / "kinds" / f"{name}.py", f"kind_{name}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.home / "metrics" / f"{metric}.py", f"metric_{metric}")

    def _applies(self, metric: dict, cell: str, reported: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves", cell) in reported if "moves" in metric else True

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell, [])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics ``cell`` reports."""
        reported = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.spec["per_layer"] if self._applies(m, cell, reported)]
