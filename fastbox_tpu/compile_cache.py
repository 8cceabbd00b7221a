"""Where this package keeps JAX's persistent compilation cache.

One rule for every entry point (bench.py, chip_smoke.py, the scripts and
the examples): ``JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise
``<checkout>/.jax_cache`` (listed in ``.gitignore``).  A fixed path matters
because the cache directory is part of what a later process looks up.
"""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the package's cache
    directory; call before the first compilation.  Returns the directory.
    """
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
