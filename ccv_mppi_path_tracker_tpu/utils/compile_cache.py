"""Persistent XLA compilation cache.

Kept in ``JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise in
``<checkout>/.jax_cache``, so repeat runs (CLI, bench.py, chip_smoke.py)
skip recompiling the kernel and the step.
"""

from __future__ import annotations

import os


def enable_compile_cache(path: str | None = None) -> str:
    import jax

    if path is None:
        path = os.environ.get(
            "JAX_COMPILATION_CACHE_DIR",
            os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))),
                ".jax_cache",
            ),
        )
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
