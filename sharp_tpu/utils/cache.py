"""Persistent XLA compilation cache and the checkout-local cache root.

The composed fold program (projection + distance + linkage + multi-cut
scoring + wMetaC) takes tens of seconds to compile cold; the persistent
cache makes that a one-time cost per shape class. Everything the package
caches (compiled programs, the native codec build, benchmark data) lives
under `<checkout>/.cache`, which `.gitignore` lists — never outside the
checkout.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_DONE = False


def local_cache_dir(*parts: str) -> str:
    """`<checkout>/.cache/<parts>`, created on demand."""
    path = os.path.join(REPO_ROOT, ".cache", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.cache/jax`.

    A fixed path matters: the directory is part of the cache's key, so a
    moving directory never hits."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or local_cache_dir(
        "jax"
    )


def enable_compilation_cache() -> None:
    global _DONE
    if _DONE:
        return
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)
    _DONE = True
