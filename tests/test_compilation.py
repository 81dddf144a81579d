"""utils.compilation: where the persistent compile cache lives."""
import pathlib

import jax
import pytest

from rsba_tpu.utils import compilation

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_cache_dir_follows_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilation.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
