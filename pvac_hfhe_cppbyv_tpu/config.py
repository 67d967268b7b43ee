"""Debug configuration (reference: include/pvac/core/config.hpp:9-21) and
the placement of JAX's persistent compilation cache.

Debug level comes from the ``PVAC_DBG`` or ``HFHE_DBG`` environment variable
(0 = silent, 1 = info, 2 = verbose), and can be overridden at runtime.
"""
from __future__ import annotations

import os
import pathlib


def _init_debug_level() -> int:
    for var in ("PVAC_DBG", "HFHE_DBG"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return max(0, min(2, int(v)))
            except ValueError:
                pass
    return 0


_g_dbg = _init_debug_level()


def get_debug_level() -> int:
    return _g_dbg


def set_debug_level(level: int) -> None:
    global _g_dbg
    _g_dbg = max(0, min(2, int(level)))


def dbg(level: int, msg: str) -> None:
    if _g_dbg >= level:
        print(msg, flush=True)


def compile_cache_dir() -> str:
    """Where JAX keeps its persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise ``.jax_cache``
    at the root of the checkout, a fixed path (the path is part of the
    cache key, so a moving directory would never hit)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (the only place the repo sets it) and return the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path

