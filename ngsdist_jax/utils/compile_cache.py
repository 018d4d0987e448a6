"""Persistent XLA compilation cache.

GPU compiles of the engine take seconds each, and a cold CLI run is
mostly compilation; jax's persistent compilation cache makes every
shape compile once per cache directory instead of once per process.

Where the cache lives:
  JAX_COMPILATION_CACHE_DIR set   jax reads it itself; nothing is set here.
  otherwise                       CACHE_DIR, one fixed directory inside the
                                  checkout (listed in .gitignore).
The path is part of the cache's identity, so it is never built from a
temp name, a pid or the time.  NGSDIST_COMPILE_CACHE=0 turns the
in-checkout default off.
"""

from __future__ import annotations

import os
from typing import Optional

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
# Compiles shorter than this are not worth a cache entry.
MIN_COMPILE_SECS = 1.0

_enabled = False


def cache_dir() -> Optional[str]:
    """The directory enable() sets, or None when it sets nothing (the
    environment already names one, or the default is turned off)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if os.environ.get("NGSDIST_COMPILE_CACHE") == "0":
        return None
    return CACHE_DIR


def enable() -> None:
    """Idempotently turn on the persistent compilation cache."""
    global _enabled
    if _enabled:
        return
    target = cache_dir()
    if target is None:
        return
    import jax

    # Device backends only: CPU compiles are fast, and XLA:CPU persists
    # AOT-compiled code keyed to the build host's CPU features — a VM
    # migration then makes every cache load print a glog warning to
    # stderr (breaking reference stderr parity) before recompiling.
    if jax.default_backend() == "cpu":
        return
    os.makedirs(target, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", target)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    _enabled = True
