"""The persistent compilation cache of the JAX package
(relation_tpu/utils/compile_cache.py) caches XLA programs. The port compiles
no XLA program: its CUDA kernels are kept built in relation_tpu_torch/_build/
(ops/kernels/_build.py) and eager PyTorch compiles nothing. These functions
accept the same settings (TPU.COMPILE_CACHE_DIR, the
RELATION_TPU_COMPILE_CACHE variable) so that the drivers take the JAX
package's configs, and do nothing."""

from __future__ import annotations


def enable_compile_cache(cache_dir: str) -> None:
    """Accepted and ignored (no XLA program to cache)."""


def enable_from_env_or_cfg(cfg=None) -> None:
    """Accepted and ignored (no XLA program to cache)."""
