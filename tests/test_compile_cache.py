"""The entry scripts' persistent compile cache: JAX_COMPILATION_CACHE_DIR
when set, otherwise the fixed ``<repo>/.jax_cache``."""

import os

import jax
import pytest

from directtrajopt_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    before = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])


def test_env_dir_is_the_only_one(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets no directory of its own
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_repo_cache(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache") == compile_cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
