"""Where the persistent XLA compile cache lives, for every entry point.

One rule: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself, so nothing else is set), otherwise ``<checkout>/.jax_cache``, a
fixed path that ``.gitignore`` lists. The path is part of the cache key,
so it is never built from a temp name, a pid or the time. The library
calls this from no import; entry points call it before their first
compile.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The directory the rule above picks."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return it."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
