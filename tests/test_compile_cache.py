"""The persistent compile cache helper used by the entry points."""

import jax
import pytest

from resampler_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("env_dir", [None, "/nonexistent/cache"],
                         ids=["unset", "set"])
def test_enable_compile_cache_directory(monkeypatch, restore_cache_config,
                                        env_dir):
    """Unset, the cache goes to ``<repo>/.jax_cache``; set, the helper
    reports that directory and configures no other."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    path = compile_cache.enable_compile_cache()
    if env_dir is None:
        assert path == str(compile_cache.REPO_CACHE_DIR)
        assert compile_cache.REPO_CACHE_DIR.name == ".jax_cache"
        assert (compile_cache.REPO_CACHE_DIR.parent / "bench.py").exists()
        assert jax.config.jax_compilation_cache_dir == path
    else:
        assert path == env_dir
        assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
