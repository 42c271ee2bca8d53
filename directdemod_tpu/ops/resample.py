"""Rate conversion: strided decimation with phase carry, and FFT resampling.

Behavioral references:
  * `comm.bwLim(strict=False)` (ref comm.py:118-129): integer-stride pick
    ``x[off::J]`` with the phase ``off`` carried across blocks so the kept
    samples sit on global indices that are multiples of J. Rate bookkeeping is
    ``int(fs / J)`` -- integer truncation included.
  * `comm.bwLim(strict=True)` (ref comm.py:110-116) and the per-line pixel
    resample (ref decode_noaa.py:350-351): ``scipy.signal.resample`` Fourier
    resampling, reproduced bin-for-bin below.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import fftutil


def decim_params(fs: int, target: int) -> tuple[int, int]:
    """(stride J, new integer rate) for bwLim -- ref comm.py:119,128."""
    j = int(fs // target) if fs >= target else None
    if j is None:
        raise ValueError("target rate above source rate")
    return j, int(fs / j)


def decim_phase(global_start: int, stride: int) -> int:
    """Closed-form carried decimator phase for a block starting at
    `global_start`: kept samples are the global indices ≡ 0 (mod stride).

    Equivalent to the reference's chained carry
    ``off' = (J - (len-off) % J) % J`` starting from 0 (ref comm.py:122-125),
    evaluated without touching earlier blocks -- this is what makes the stream
    shardable with zero communication for this op.
    """
    return (-global_start) % stride


def decim_count(n: int, off: int, stride: int) -> int:
    """Number of kept samples in a block of length n with phase off."""
    return max(0, -(-(n - off) // stride)) if n > off else 0


def decimate(x: jnp.ndarray, off, stride: int, out_len: int) -> jnp.ndarray:
    """x[off::stride] with a host-known output length (static shape)."""
    idx = jnp.asarray(off, dtype=jnp.int32) + stride * jnp.arange(out_len, dtype=jnp.int32)
    return jnp.take(x, idx, mode="clip")


@partial(jax.jit, static_argnums=(1,))
def fft_resample(x: jnp.ndarray, num: int) -> jnp.ndarray:
    """scipy.signal.resample for a real 1-D signal along the last axis.

    Matches scipy's spectral truncation/zero-padding rules including the
    half-Nyquist-bin handling in both directions.

    Jitted (num static): callers like the per-line APT resample benefit
    from the fusion.
    """
    n = x.shape[-1]
    if num == n:
        return x
    real_in = not jnp.iscomplexobj(x)
    scale = float(num) / float(n)
    nkeep = min(num, n)
    nyq = nkeep // 2 + 1
    if real_in:
        X = fftutil.rfft_any(x, axis=-1)
        Y = jnp.zeros(x.shape[:-1] + (num // 2 + 1,), dtype=X.dtype)
        Y = Y.at[..., :nyq].set(X[..., :nyq])
        if nkeep % 2 == 0:
            if num < n:
                Y = Y.at[..., nkeep // 2].set(Y[..., nkeep // 2] * 2.0)
            else:
                Y = Y.at[..., nkeep // 2].set(Y[..., nkeep // 2] * 0.5)
        return fftutil.irfft_any(Y, num, axis=-1) * scale
    X = fftutil.fft_any(x, axis=-1)
    Y = jnp.zeros(x.shape[:-1] + (num,), dtype=X.dtype)
    Y = Y.at[..., :nyq].set(X[..., :nyq])
    if nkeep > 2:
        Y = Y.at[..., nyq - nkeep:].set(X[..., nyq - nkeep:])
    if nkeep % 2 == 0:
        half = nkeep // 2
        if num < n:
            # fold the input's -N/2 bin into the output's +N/2 bin
            Y = Y.at[..., half].add(X[..., n - half])
        else:
            Y = Y.at[..., half].set(Y[..., half] * 0.5)
            Y = Y.at[..., num - half].set(Y[..., half])
    return fftutil.ifft_any(Y, axis=-1) * scale
