"""Cross-correlation and sync-pattern search.

Behavioral references:
  * `scipy.signal.correlate(h, n, mode='same')` as used for sync search
    (ref decode_noaa.py:671,703-710; decode_funcube.py:252).
  * The normalized correlator ``cor / sqrt(moving_energy * needle_energy)``
    (ref decode_noaa.py:659-675).
  * Needle builders: the repeated-bit sync trains (ref decode_noaa.py:690-694).

All correlations are FFT-based on device (the needles run 560..113k samples;
direct conv would waste work at those lengths).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .fftutil import smooth_len as _fft_len


def fft_convolve_full(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Linear convolution (full) via FFT; complex-safe."""
    n = x.shape[-1] + w.shape[-1] - 1
    m = _fft_len(n)
    cplx = jnp.iscomplexobj(x) or jnp.iscomplexobj(w)
    if cplx:
        X = jnp.fft.fft(x, n=m)
        W = jnp.fft.fft(w, n=m)
        return jnp.fft.ifft(X * W)[..., :n]
    X = jnp.fft.rfft(x, n=m)
    W = jnp.fft.rfft(w, n=m)
    return jnp.fft.irfft(X * W, n=m)[..., :n]


def convolve_same_fft(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """np.convolve(x, w, 'same') via FFT (for long kernels)."""
    k = w.shape[-1]
    full = fft_convolve_full(x, w)
    start = (k - 1) // 2
    return full[..., start:start + x.shape[-1]]


def correlate_same(x: jnp.ndarray, needle: jnp.ndarray) -> jnp.ndarray:
    """scipy.signal.correlate(x, needle, mode='same')."""
    w = needle[::-1].conj() if jnp.iscomplexobj(needle) else needle[::-1]
    # correlate 'same' centering differs from convolve 'same' when len is even:
    # full index offset is (k-1)//2 for convolve but k//2 for correlate
    k = needle.shape[-1]
    full = fft_convolve_full(x, w)
    start = (k - 1) // 2
    return full[..., start:start + x.shape[-1]]


def moving_energy(x: jnp.ndarray, wlen: int) -> jnp.ndarray:
    """np.convolve(x*x, ones(wlen), 'same') (ref decode_noaa.py:672)."""
    return convolve_same_fft(x * x, jnp.ones(wlen, dtype=x.dtype))


def norm_correlate(haystack: jnp.ndarray, needle: jnp.ndarray) -> jnp.ndarray:
    """Reference's normalized correlation (ref decode_noaa.py:659-675):
    ``correlate(h, n, 'same') / sqrt(moving_energy(h) * sum(n^2))``."""
    cor = correlate_same(haystack, needle)
    sums = moving_energy(haystack, needle.shape[-1])
    return cor / jnp.sqrt(sums * jnp.sum(needle * needle))


def norm_correlate_multi(haystack: jnp.ndarray,
                         needles: jnp.ndarray) -> jnp.ndarray:
    """`norm_correlate` against a (k, L) stack of equal-length real needles,
    sharing one haystack FFT and one moving-energy pass across all k.

    The NOAA crude sync correlates the same envelope against the A and B
    trains (ref decode_noaa.py:786-790); separately that costs two haystack
    FFTs and two identical energy convolutions — fused, the haystack spectrum
    and the energy term are computed once (the energy window depends only on
    the needle *length*, equal for A and B). Returns (k, n)."""
    if jnp.iscomplexobj(haystack) or jnp.iscomplexobj(needles):
        raise ValueError("norm_correlate_multi is real-only")
    k_len = needles.shape[-1]
    n = haystack.shape[-1] + k_len - 1
    m = _fft_len(n)
    X = jnp.fft.rfft(haystack, n=m)
    W = jnp.fft.rfft(needles[..., ::-1], n=m)
    full = jnp.fft.irfft(X[None, :] * W, n=m)[..., :n]
    start = (k_len - 1) // 2
    cor = full[..., start:start + haystack.shape[-1]]
    sums = moving_energy(haystack, k_len)
    energy = jnp.sum(needles * needles, axis=-1, keepdims=True)
    return cor / jnp.sqrt(sums[None, :] * energy)


def _frames(x: jnp.ndarray, blk: int, halo_l: int, halo_r: int):
    """Overlapping frames: row i covers x[i*blk - halo_l : i*blk + blk +
    halo_r) with zero padding at both edges. Returns ((nb, blk+halo_l+halo_r),
    nb)."""
    n = x.shape[-1]
    nb = -(-n // blk)
    ep = jnp.pad(x, (halo_l, nb * blk - n + halo_r))
    starts = jnp.arange(nb, dtype=jnp.int32) * blk
    flen = blk + halo_l + halo_r
    return jax.vmap(lambda i: lax.dynamic_slice(ep, (i,), (flen,)))(starts), nb


def norm_correlate_multi_blocked(haystack: jnp.ndarray,
                                 needles: jnp.ndarray,
                                 blk: int = 1 << 17) -> jnp.ndarray:
    """`norm_correlate_multi` via overlap-save: the haystack splits into
    `blk`-wide frames with needle-length halos and every FFT runs BATCHED
    over frames.

    One multi-million-point 1-D FFT was the slow shape on the machine this
    was first tuned for; ~30 batched 135k-point FFTs compute the identical
    correlation (not yet measured against one FFT on the GPU, ROADMAP S6).
    Energy frames share the correlation
    frames (framing commutes with elementwise squaring), so the whole
    normalized A+B correlation costs two batched rffts + one batched irfft."""
    if jnp.iscomplexobj(haystack) or jnp.iscomplexobj(needles):
        raise ValueError("norm_correlate_multi_blocked is real-only")
    n = haystack.shape[-1]
    L = needles.shape[-1]
    if n <= 2 * blk:
        return norm_correlate_multi(haystack, needles)
    halo_l, halo_r = L // 2, (L - 1) // 2
    frames, nb = _frames(haystack, blk, halo_l, halo_r)   # (nb, blk + L - 1)
    m = _fft_len(blk + 2 * (L - 1))
    X = jnp.fft.rfft(frames, n=m)
    X2 = jnp.fft.rfft(frames * frames, n=m)
    W = jnp.fft.rfft(needles[..., ::-1], n=m)             # (k, M)
    Wo = jnp.fft.rfft(jnp.ones(L, dtype=haystack.dtype), n=m)
    cor_f = jnp.fft.irfft(X[None, :, :] * W[:, None, :], n=m)
    en_f = jnp.fft.irfft(X2 * Wo[None, :], n=m)
    # frame-local correlate-'same' output for global p = i*blk + p' sits at
    # conv_full(frame, w_rev)[p' + L - 1]
    cor = cor_f[..., L - 1: L - 1 + blk].reshape(needles.shape[0], nb * blk)
    sums = en_f[..., L - 1: L - 1 + blk].reshape(nb * blk)
    energy = jnp.sum(needles * needles, axis=-1, keepdims=True)
    return cor[:, :n] / jnp.sqrt(sums[None, :n] * energy)


def apt_needle(sync_bits, samp_rate: float, t_bit: float,
               positive: bool = True) -> np.ndarray:
    """Build the APT sync needle at `samp_rate` (ref decode_noaa.py:690-694):
    each bit repeated round(samp_rate * t_bit) times; positive form maps
    {0,1} -> {11,244}/255, signed form subtracts 0.5."""
    rep = int(round(samp_rate * t_bit))
    bits = np.repeat(np.asarray(sync_bits, dtype=np.float64), rep)
    if positive:
        return (bits * 233.0 + 11.0) / 255.0
    return bits - 0.5
