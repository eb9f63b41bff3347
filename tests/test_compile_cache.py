"""Compile-cache placement (utils/compile_cache.py)."""

import os

import jax
import pytest

from cpu_ray_tracing_implementation_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    return calls


def test_env_var_is_honoured(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable(backend="gpu") == str(tmp_path)
    assert updates == []     # JAX reads the variable itself


def test_fixed_repo_path_on_gpu(updates):
    path = compile_cache.enable(backend="gpu")
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]


def test_no_cache_on_cpu(updates):
    assert compile_cache.enable(backend="cpu") is None
    assert compile_cache.enable() is None    # this suite runs on the CPU
    assert updates == []
