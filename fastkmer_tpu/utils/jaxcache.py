"""Persistent XLA compilation cache setup.

Compiling the batch step and the merge variants is a large part of a cold
run; JAX's persistent cache makes every jit after the first process free.
The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
nothing is configured in code then.  Otherwise it lives at a fixed path
inside the checkout (``.jax_cache/``, listed in .gitignore): the path is
part of the cache key, so a directory that moved would never hit.
Imported for its side effect by pipeline/cli/bench.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> None:
    import jax

    if os.environ.get(ENV_VAR):
        return  # JAX reads the variable itself
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


enable()
