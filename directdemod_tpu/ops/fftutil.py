"""Arbitrary-length FFTs that only ever run 5-smooth FFT lengths on device.

The policy: an FFT runs directly when its length is 5-smooth with a small
odd part (2^a 3^b 5^c with 8 | n and 3^b 5^c <= 2048, or any 5-smooth
n <= 4096 — `fft_len_ok`); every other length goes through Bluestein's
chirp-z below. The bound was set where the system was first built, whose
compiler lowered a large odd factor to a dense O(n^2) DFT; whether cuFFT
needs it is not yet measured (ROADMAP S6). The reference freely FFTs
ragged lengths (scipy.signal.hilbert at ref demod_am.py:29 over arbitrary
blocks, scipy.signal.resample at ref comm.py:114 / decode_noaa.py:350), so the
numeric contract pins the exact length-n DFT.

This module computes the exact length-n DFT for ANY n via Bluestein's chirp-z
identity, using only 5-smooth FFTs:

    X[k] = A[k] * (a * b)[k + n - 1],  a[m] = x[m] A[m],
    A[m] = exp(-i pi m^2 / n),         b[j] = exp(+i pi j^2 / n), |j| < n

The chirps depend only on n (static under jit), so they are built host-side in
exact integer-mod fp64 arithmetic (m^2 mod 2n stays exact where a naive fp64
m^2 for large m would lose the phase entirely) and baked as constants; the
device does two smooth FFTs and elementwise work.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from ..utils import hostio


def is_5smooth(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


MAX_ODD_FACTOR = 2048   # bound on the non-power-of-two part (module doc)


def odd_part(n: int) -> int:
    while n % 2 == 0:
        n //= 2
    return n


def fft_len_ok(n: int) -> bool:
    """True when a length-n FFT runs directly (see the module doc): a
    5-smooth length whose odd part is at most MAX_ODD_FACTOR, or any
    5-smooth length up to 4096."""
    return is_5smooth(n) and (
        n <= 4096 or (n % 8 == 0 and odd_part(n) <= MAX_ODD_FACTOR))


def smooth_len(n: int) -> int:
    """Next direct FFT length >= n: 2^a 3^b 5^c with a >= 3 and odd part
    3^b 5^c <= MAX_ODD_FACTOR (see fft_len_ok)."""
    best = 1 << max(0, (n - 1)).bit_length()
    best = max(best, 8)
    p5 = 1
    while p5 <= MAX_ODD_FACTOR:
        p35 = p5
        while p35 <= MAX_ODD_FACTOR:
            x = p35 * 8
            while x < n:
                x *= 2
            best = min(best, x)
            p35 *= 3
        p5 *= 5
    return best


@lru_cache(maxsize=64)
def _bluestein_consts(n: int):
    """(A[n], Bf[m], m) for length-n chirp-z: A = forward chirp, Bf = smooth
    FFT of the padded inverse chirp. Exact phases via integer m^2 mod 2n."""
    k = np.arange(n, dtype=np.int64)
    ph = (k * k) % (2 * n)                      # exact: w^{k^2}, w = e^{-i pi/n}
    A = np.exp(-1j * np.pi * ph.astype(np.float64) / n)
    m = smooth_len(2 * n - 1)
    j = np.arange(-(n - 1), n, dtype=np.int64)
    phb = (j * j) % (2 * n)
    b = np.exp(1j * np.pi * phb.astype(np.float64) / n)
    bp = np.zeros(m, dtype=np.complex128)
    bp[: 2 * n - 1] = b
    Bf = np.fft.fft(bp)
    return A, Bf, m


def fft_any(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """jnp.fft.fft over `axis` for any length, smooth-FFT-only on device."""
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    cdt = jnp.complex128 if x.dtype in (jnp.float64, jnp.complex128) \
        else jnp.complex64
    x = x.astype(cdt)
    if fft_len_ok(n):
        y = jnp.fft.fft(x, axis=-1)
    else:
        A, Bf, m = _bluestein_consts(n)
        # chirp constants: under a jit trace they become embedded constants
        Aj = hostio.device_put(A, dtype=cdt)
        Bj = hostio.device_put(Bf, dtype=cdt)
        a = jnp.fft.fft(x * Aj, n=m, axis=-1)
        c = jnp.fft.ifft(a * Bj, axis=-1)[..., n - 1: 2 * n - 1]
        y = Aj * c
    return y if axis == -1 else jnp.moveaxis(y, -1, axis)


def ifft_any(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """jnp.fft.ifft over `axis` for any length (conjugation identity)."""
    n = x.shape[axis]
    if fft_len_ok(n):
        return jnp.fft.ifft(x, axis=axis)
    return jnp.conj(fft_any(jnp.conj(x), axis=axis)) / n


def rfft_any(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """jnp.fft.rfft over `axis` for any length."""
    n = x.shape[axis]
    if fft_len_ok(n):
        return jnp.fft.rfft(x, axis=axis)
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    y = fft_any(x)[..., : n // 2 + 1]
    return y if axis == -1 else jnp.moveaxis(y, -1, axis)


def irfft_any(x: jnp.ndarray, n: int, axis: int = -1) -> jnp.ndarray:
    """jnp.fft.irfft(..., n=n) over `axis` for any n: rebuild the Hermitian
    spectrum and take the real inverse."""
    if fft_len_ok(n):
        return jnp.fft.irfft(x, n=n, axis=axis)
    if axis != -1:
        x = jnp.moveaxis(x, axis, -1)
    half = n // 2 + 1
    if x.shape[-1] < half:     # jnp.fft.irfft zero-pads short spectra; match it
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, half - x.shape[-1])])
    x = x[..., :half]
    tail = jnp.conj(x[..., 1: (n + 1) // 2])[..., ::-1]
    full = jnp.concatenate([x, tail], axis=-1)
    y = jnp.real(ifft_any(full))
    return y if axis == -1 else jnp.moveaxis(y, -1, axis)
