"""The compile-cache rule every entry point follows (utils/cache.py):
``JAX_COMPILATION_CACHE_DIR`` when set, and nothing else is set;
otherwise ``<checkout>/.jax_cache``, a fixed path."""

import os

import jax
import pytest

from pyfeaturetrack_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkout_is_the_repo_root():
    assert os.path.samefile(cache.CHECKOUT, REPO)
    assert os.path.exists(os.path.join(cache.CHECKOUT, "pyproject.toml"))


def test_env_dir_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_the_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(cache.CHECKOUT, ".jax_cache")
    assert cache.enable_compile_cache() == want
    assert cache.enable_compile_cache() == want   # no pid, time or tmp name
    assert calls == [("jax_compilation_cache_dir", want)] * 2


@pytest.mark.parametrize("entry", ["bench.py", "chip_smoke.py",
                                   "__graft_entry__.py",
                                   "pyfeaturetrack_tpu/cli.py",
                                   "tests/conftest.py"])
def test_every_entry_point_uses_the_rule(entry):
    with open(os.path.join(REPO, entry)) as f:
        src = f.read()
    assert "enable_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
