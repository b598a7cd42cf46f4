"""Entry-point setup: the compile cache's place and the GPU requirement."""

import os
import pathlib
import subprocess

import pytest

import jax

from openmeters_tpu import runtime_env

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cache_defaults_to_a_fixed_path_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime_env.cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert str(os.getpid()) not in path
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    assert runtime_env.setup_compile_cache() == path
    assert calls == [("jax_compilation_cache_dir", path)]


def test_cache_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    assert runtime_env.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_require_gpu_refuses_other_platforms():
    assert runtime_env.device_summary()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        runtime_env.require_gpu()


def test_card_line_reports_a_missing_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert runtime_env.card_line() == "nvidia-smi unavailable (FileNotFoundError)"
