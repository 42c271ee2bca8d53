"""Device-side IQ unpacking: raw interleaved uint8 -> complex baseband.

Behavioral reference: the source byte contract ``(I + jQ) - (127.5 + 127.5j)``
over interleaved uint8 pairs (ref source.py:117-118, 209).

Device design: the host feed is the pipeline's narrowest pipe (PCIe).
Uploading the *raw bytes* moves 2 bytes/sample instead of the 8
bytes/sample of a float32-pair complex upload, and the unpack itself becomes
the first fused device op -- XLA folds the subtract into whatever consumes the
samples, so the unpack is free. This replaces the host-side converter
(io/native) on the hot path; the host converter remains for host-only
consumers (accurate-sync window reads, Doppler waterfall).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

IQ_U8_OFFSET = 127.5


def iq_u8_to_complex(raw: jnp.ndarray, real_dtype=jnp.float32) -> jnp.ndarray:
    """(..., 2N) interleaved uint8 -> (..., N) complex, minus the 127.5 offset.

    Jit-safe; output dtype is the complex counterpart of `real_dtype`.

    The 1-D hot path reshapes the bytes to (rows, 256) first -- a bitcast on
    the byte stream's natural linear layout -- so the convert runs dense and
    the deinterleave is a short-stride shuffle instead of a 1-D stride-2
    gather over the whole capture (on the machine this was first tuned for,
    that gather dominated the whole PSK pipeline; not measured on the GPU,
    ROADMAP S2).
    """
    off = jnp.asarray(IQ_U8_OFFSET, dtype=real_dtype)
    if raw.ndim == 1 and raw.shape[0] >= 4096:
        nb = raw.shape[0]
        rows = -(-nb // 256)
        rp = jnp.pad(raw, (0, rows * 256 - nb)) \
            .reshape(rows, 256).astype(real_dtype)
        re = rp[:, 0::2].reshape(-1)[: nb // 2] - off
        im = rp[:, 1::2].reshape(-1)[: nb // 2] - off
        return lax.complex(re, im)
    f = raw.astype(real_dtype)
    return lax.complex(f[..., 0::2] - off, f[..., 1::2] - off)


def supports_raw(source) -> bool:
    """True when `source` can serve raw interleaved uint8 byte slices
    (host-side `read_raw` or device-resident `read_raw_device`)."""
    return callable(getattr(source, "read_raw", None)) \
        or callable(getattr(source, "read_raw_device", None))
