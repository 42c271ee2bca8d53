"""AM envelope demodulation.

Behavioral reference: `demod_am.demod` = ``abs(hilbert(sig))``
(ref demod_am.py:29). The reference applies it *per 240000-sample block with no
carried state* (ref decode_noaa.py:647-653); that blockwise semantics is part
of the numeric contract and is reproduced here as a batched FFT over equal
blocks plus one remainder block.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import fftutil


def analytic(x: jnp.ndarray) -> jnp.ndarray:
    """scipy.signal.hilbert semantics for a real 1-D signal (last axis).

    Routed through fftutil so ragged block lengths (e.g. the 240000-block
    remainder) use chirp-z instead of an O(n^2) dense-DFT fallback."""
    n = x.shape[-1]
    cdt = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    X = fftutil.fft_any(x.astype(cdt), axis=-1)
    h = jnp.zeros(n, dtype=X.real.dtype)
    if n % 2 == 0:
        h = h.at[0].set(1.0).at[n // 2].set(1.0).at[1:n // 2].set(2.0)
    else:
        h = h.at[0].set(1.0).at[1:(n + 1) // 2].set(2.0)
    return fftutil.ifft_any(X * h, axis=-1)


def envelope(x: jnp.ndarray) -> jnp.ndarray:
    """|hilbert(x)| along the last axis."""
    return jnp.abs(analytic(x))


def envelope_lowpass(x: jnp.ndarray, fs: float, cutoff: float,
                     state=None):
    """AM demodulation by low-pass filtering |x| (`demod_amFLT`,
    ref demod_am.py:35-62): Butterworth LP over the magnitude, with carried
    state for chunked streams. Returns (envelope, new_state)."""
    from .iir import IirFilter
    filt = IirFilter.design_butter(fs, cutoff, order=6, kind="lowpass")
    if state is None:
        state = filt.initial_state_step(
            jnp.float64 if x.dtype in (jnp.float64, jnp.complex128)
            else jnp.float32)
    return filt.apply(jnp.abs(x), state)


def envelope_blocked(x: jnp.ndarray, block: int) -> jnp.ndarray:
    """Envelope per fixed-size block with no cross-block state, matching the
    reference's chunked AM demod (ref decode_noaa.py:644-653, block=240000).

    The full blocks are processed as one batched FFT; the remainder (if any)
    gets its own length-specialized FFT.
    """
    n = x.shape[0]
    nfull = n // block
    out = []
    if nfull:
        full = envelope(x[: nfull * block].reshape(nfull, block)).reshape(-1)
        out.append(full)
    rem = n - nfull * block
    if rem:
        out.append(envelope(x[nfull * block:]))
    return out[0] if len(out) == 1 else jnp.concatenate(out)
