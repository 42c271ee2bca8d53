"""directdemod-tpu: software-radio framework on JAX.

See README.md for the architecture map. The compute path is JAX/XLA; the
behavioral reference is aerospaceresearch/DirectDemod.
"""
import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    $JAX_COMPILATION_CACHE_DIR when it is set, else `<checkout>/.jax_cache`.
    The path is part of the cache key, so it is fixed, not per-process."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


# Every process keeps its compiled programs in one fixed directory, so a
# second run of the same shapes loads them instead of compiling again. A
# directory that cannot be created is an error, not a silently cold cache.
_cache = compile_cache_dir()
_os.makedirs(_cache, exist_ok=True)
_jax.config.update("jax_compilation_cache_dir", _cache)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "1.0.0"
