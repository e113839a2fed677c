"""Persistent XLA compilation cache for the CLI and other entry points.

The reference binary's whole runtime for a small image is file I/O plus a
few ms of compute (main.rs:8-68); a jit-compiled pipeline that recompiles
from scratch on every process start cannot match that single-shot UX.
Wiring jax's persistent compilation cache makes every process after the
first pay only the cache deserialization.

Where the cache lives is decided outside the program: when
JAX_COMPILATION_CACHE_DIR is set, jax reads it itself and this module sets
no directory; otherwise the cache goes to `.jax_cache` in the checkout
(git-ignored). The AOT executable cache (utils/aot_cache.py) keeps its
artifacts under the same root.

Callers invoke enable() BEFORE the first jit trace. Library users who
manage their own jax.config are unaffected unless they call it.
"""

from __future__ import annotations

import os

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"

_CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)

_enabled = False


def cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return os.environ.get(ENV_DIR) or _CHECKOUT_DIR


def enable() -> str | None:
    """Turn on jax's persistent compilation cache (idempotent).

    Set JPEG_TPU_NO_CACHE=1 to disable entirely (returns None). Returns
    the cache directory in use.
    """
    global _enabled
    if os.environ.get("JPEG_TPU_NO_CACHE") == "1":
        return None
    path = cache_dir()
    if _enabled:
        return path
    os.makedirs(path, exist_ok=True)

    import jax

    if not os.environ.get(ENV_DIR):
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every compile that costs more than the deserialization itself;
    # the CLI's pipeline programs all take seconds.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
    return path
