"""Host<->device transfer helpers.

Every dtype crosses the host boundary as itself: these are thin wrappers
that give the package one place to upload, download and fill, plus
`global_get` for arrays sharded across processes.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def zeros(shape, dtype):
    """jnp.zeros (kept as the package's one fill helper)."""
    return jnp.zeros(shape, dtype)


def ones(shape, dtype):
    """jnp.ones (kept as the package's one fill helper)."""
    return jnp.ones(shape, dtype)


def device_put(x: np.ndarray, dtype=None, sharding=None):
    """Upload a host array (any shape and dtype, cast to `dtype` when
    given), optionally with a sharding."""
    arr = jnp.asarray(np.asarray(x), dtype=dtype)
    return jax.device_put(arr, sharding) if sharding is not None else arr


def device_put_u8(raw: np.ndarray, sharding=None):
    """Upload a uint8 byte buffer (last axis = bytes)."""
    return device_put(np.ascontiguousarray(raw, dtype=np.uint8),
                      sharding=sharding)


def global_get(y) -> np.ndarray:
    """device_get that also works on cross-process sharded arrays: when the
    current process does not hold every shard (a multi-host mesh), the
    global value is assembled with a process_allgather collective instead
    of np.asarray (which raises on non-addressable arrays). Single-process
    arrays take the plain device_get path untouched."""
    if isinstance(y, np.ndarray):
        return y
    if getattr(y, "is_fully_addressable", True):
        return device_get(y)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(y, tiled=True))


def device_get(y) -> np.ndarray:
    """Download a device array (any shape and dtype) to numpy."""
    return np.asarray(y)
