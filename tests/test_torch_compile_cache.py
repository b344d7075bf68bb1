"""`utils.compile_cache.enable_compile_cache`: the JAX package's variables,
None without CUDA, the directory's precedence, idempotence, and the kernels'
builder placing its libraries under the chosen root."""

import os

import pytest
import torch

from differential_equations_resnet_tpu_torch.ops.kernels import _build
from differential_equations_resnet_tpu_torch.utils import compile_cache


@pytest.fixture
def cache(monkeypatch):
    """A CUDA that is there, a fresh enabled state, the builder's root
    restored afterwards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(compile_cache, "_ENABLED", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("DEQRES_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("DEQRES_COMPILE_CACHE_DIR", raising=False)
    return compile_cache


@pytest.mark.parametrize("value", ["0", "false", "no"])
def test_opt_out(cache, monkeypatch, tmp_path, value):
    monkeypatch.setenv("DEQRES_COMPILE_CACHE", value)
    root = _build.BUILD_ROOT
    assert cache.enable_compile_cache(str(tmp_path)) is None
    assert _build.BUILD_ROOT == root


def test_none_without_cuda(cache, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = _build.BUILD_ROOT
    assert cache.enable_compile_cache(str(tmp_path)) is None
    assert _build.BUILD_ROOT == root and not os.listdir(tmp_path)


def test_directory_precedence(cache, monkeypatch, tmp_path):
    """``cache_dir``, else ``DEQRES_COMPILE_CACHE_DIR``, else
    ``~/.cache/deqres/cuda``."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cache.enable_compile_cache() == str(tmp_path / "home" / ".cache" / "deqres" / "cuda")
    monkeypatch.setattr(cache, "_ENABLED", None)
    monkeypatch.setenv("DEQRES_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cache.enable_compile_cache() == str(tmp_path / "env")
    monkeypatch.setattr(cache, "_ENABLED", None)
    assert cache.enable_compile_cache(str(tmp_path / "arg")) == str(tmp_path / "arg")
    assert os.path.isdir(tmp_path / "arg")


def test_idempotent(cache, tmp_path):
    first = cache.enable_compile_cache(str(tmp_path / "a"))
    assert cache.enable_compile_cache(str(tmp_path / "b")) == first == str(tmp_path / "a")
    assert str(_build.BUILD_ROOT) == first


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_libraries_land_under_the_root(cache, tmp_path, name):
    cache.enable_compile_cache(str(tmp_path))
    path = _build.library_path(name)
    assert path.parent == tmp_path / _build.SOURCES[name].subdir
    assert path.name.startswith(f"lib{name}-")


def test_the_cli_enables_it_for_the_card_only(cache, monkeypatch, tmp_path, capsys):
    """Subcommands on the card call it before their first build; a host-only
    subcommand and ``--device cpu`` do not."""
    from differential_equations_resnet_tpu_torch import cli

    calls = []
    monkeypatch.setattr(cache, "enable_compile_cache", lambda: calls.append(1))
    monkeypatch.setattr(cli, "cmd_export", lambda args: 0)
    monkeypatch.setattr(cli, "cmd_analyze", lambda args: 0)
    assert cli.main(["export", str(tmp_path / "e"), "--device", "cpu"]) == 0
    assert cli.main(["analyze", str(tmp_path / "t.csv")]) == 0
    assert calls == []
    assert cli.main(["export", str(tmp_path / "e")]) == 0
    assert calls == [1]
