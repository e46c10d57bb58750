"""The persistent compilation cache follows JAX_COMPILATION_CACHE_DIR
when it is set, and otherwise lives at one fixed path in the checkout."""
import os

import jax

from photon_tpu.utils.compile_cache import (DEFAULT_DIR, compile_cache_dir,
                                            enable_compile_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert compile_cache_dir(env) == "/somewhere/else"


def test_default_is_fixed_path_in_checkout_and_ignored():
    assert compile_cache_dir({}) == DEFAULT_DIR
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) \
        == DEFAULT_DIR
    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_points_jax_at_the_directory(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    # the test session itself was configured by conftest
    assert before == compile_cache_dir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
