"""Persistent XLA compilation cache.

The framework's CLI and serving entry points run as separate processes, and
first-time XLA compiles of the fingerprint/match graphs take seconds.
Enabling JAX's persistent compilation cache makes every process after the
first reuse the compiled executables from disk.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself; nothing else is set in code), otherwise one fixed
directory inside the checkout, :data:`DEFAULT_DIR` (``<repo>/.jax_cache``,
listed in ``.gitignore``). The path is part of the cache's key, so it
never moves.

The reference has no analogue — it is C compiled ahead of time; this is the
JIT-world equivalent of shipping a compiled module.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
_enabled = False


def enable_compilation_cache() -> None:
    """Idempotently enable the on-disk compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; the
    ``TIRESIAS_NO_COMPILE_CACHE`` env var disables the cache entirely.
    """
    global _enabled
    if _enabled or os.environ.get("TIRESIAS_NO_COMPILE_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
