"""Where JAX's persistent compilation cache lives.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
directory is set here. Otherwise the cache is one fixed directory inside the
checkout (.cache/jax, git-ignored): the directory is part of the cache key,
so a path that moved between runs would never hit.
"""
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The compile-cache directory this process uses."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".cache", "jax")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir()."""
    import jax

    d = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return d
