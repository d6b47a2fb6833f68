"""Persistent XLA compilation cache setup.

Where JAX_COMPILATION_CACHE_DIR is set, JAX already keeps its cache there
and nothing is set in code. Otherwise the cache lives at a fixed
`<checkout>/.jax_cache` (listed in .gitignore): the path is part of what
makes a later process find an entry, so it must not move.
"""
import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable(path: str = CACHE_DIR) -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def map_region_count() -> int:
    """This process's current mmap-region count (Linux)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


# Comfortable margin under the Linux default vm.max_map_count (65530):
# a single heavy test (interpret-mode Pallas compiles) can add >20K
# regions, so the guard fires well before half the hard limit.
MAP_REGION_SOFT_LIMIT = 30_000


def clear_if_bloated(limit: int = MAP_REGION_SOFT_LIMIT) -> bool:
    """Drop jax's in-process executable caches when this process holds too
    many mmap regions.

    Every live compiled XLA:CPU executable pins LLVM-JIT code/data
    mappings. A long-lived process that keeps compiling new programs (the
    cold test suite, a many-shape decode service) accumulates mmap regions
    until the kernel's vm.max_map_count, at which point the NEXT JIT
    allocation fails inside LLVM and the process aborts or segfaults.
    Recompiles after a clear are served from the persistent on-disk cache
    as cheap loads.

    Returns True when a clear was performed."""
    if map_region_count() < limit:
        return False
    import jax
    jax.clear_caches()
    return True
