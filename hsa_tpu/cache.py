"""Where the program keeps what it makes at run time.

One directory inside the checkout, ``.cache/`` (listed in .gitignore),
holds the XLA compile cache, the native library build and the benchmark
indexes.  The one exception is the compile cache when
``JAX_COMPILATION_CACHE_DIR`` is set: JAX then reads that variable itself
and nothing here overrides it.
"""

from __future__ import annotations

import os

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    ".cache")


def compile_cache_dir() -> str:
    """The persistent XLA compile cache directory in effect."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(ROOT, "xla"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    A fixed path is part of every cache key, so a second run in the same
    checkout finds what the first compiled.
    """
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        import jax
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
