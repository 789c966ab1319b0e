"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins, else a
fixed directory inside the checkout."""

import os

import jax

from hsa_tpu import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert updates == []


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    want = os.path.join(REPO, ".cache", "xla")
    assert cache.compile_cache_dir() == want
    assert cache.enable_compile_cache() == want
    assert updates == [("jax_compilation_cache_dir", want)]
    assert os.path.isdir(want)
