"""Persistent XLA compilation cache.

The reference pays Julia JIT warm-up once per session; our analog is XLA
compilation, which takes seconds to minutes per solver executable.  JAX
ships a persistent on-disk cache keyed by the (HLO, compile options,
backend version) fingerprint — with it, a later run of an unchanged
executable loads instead of compiling.

Call `enable_persistent_cache()` BEFORE the first jit compilation.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Enable the on-disk compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other directory; otherwise the cache lives at the fixed path
    `<repo>/.jax_cache` (a fixed path keeps cache keys stable across runs).
    The entry thresholds are lowered so every solver executable that takes
    a second or more to compile is kept."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = _DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
