"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache is
``.jax_cache`` at the root of the checkout, a fixed path, so a later
process of the same checkout finds what an earlier one compiled.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory for this process's environment."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns
    the directory.  Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
