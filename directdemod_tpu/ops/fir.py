"""FIR filtering as strided convolution.

Behavioral reference: `filter.applyOn` (ref filters.py:53-75) in its three modes
(stateful `lfilter` with carried `zi`, zero-phase `filtfilt`, plain `lfilter`),
and the strided decimation that follows it (`comm.bwLim`, ref comm.py:119-129).

Design notes:
  * Stateful chunked filtering is overlap-save: the carried scipy `zi` state is
    replaced by the last `ntaps-1` *input* samples (for a pure FIR the two are
    equivalent; the reference's `lfilter_zi` seed equals an all-ones history,
    see ops/design.step_history_equivalent).
  * Filter + decimate fuse into ONE strided `lax.conv_general_dilated`; only
    every J-th output is ever computed.
  * Complex data with real taps costs two real convolutions; complex taps
    (DDC-modulated, see models) cost four.
  * Precision: the parity contract is f32-grade. On an H100 a float32 *dot*
    at default precision runs in TF32 (measured: `_rconv_blocked` 3.9e-4
    relative error at default, 2.0e-7 at HIGHEST), so that dot asks for
    HIGHEST. The convolutions measured f32-grade at default (fir_decimate
    3.9e-7 relative to the fp64 oracle at 1M outputs), so they keep it.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils import hostio


def _rconv_direct(x: jnp.ndarray, w: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """Degenerate (1,1,N) conv -- used for short inputs; long stride-1
    inputs take `_rconv_blocked`."""
    lhs = x[None, None, :]
    rhs = w[None, None, :].astype(x.dtype)
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=x.dtype,
    )
    return out[0, 0]


def _rconv_polyphase(x: jnp.ndarray, w: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Strided conv as a polyphase *channel* conv: out[m] = sum_i w[i] x[m*J+i]
    becomes a width-ceil(K/J) convolution over J input channels."""
    j = stride
    k = w.shape[0]
    m = (x.shape[0] - k) // j + 1
    q = -(-k // j)
    mp = m + q                       # rows after padding to a multiple of J
    xp = jnp.pad(x, (0, mp * j - x.shape[0])) if mp * j > x.shape[0] \
        else x[: mp * j]
    lanes = xp.reshape(mp, j).T      # (J, M') : lanes[r, a] = x[a*J + r]
    wp = jnp.pad(w, (0, q * j - k)).reshape(q, j).T   # (J, Q)
    out = lax.conv_general_dilated(
        lanes[None], wp[None].astype(x.dtype),
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=x.dtype,
    )
    return out[0, 0, :m]


def _rconv_blocked(x: jnp.ndarray, w: jnp.ndarray, block: int = 128) -> jnp.ndarray:
    """Stride-1 conv as a blocked im2col matmul: rows of `block` outputs
    against a banded (S*block, block) tap matrix. HIGHEST precision: a
    default-precision f32 dot runs in TF32 on the GPU (see module doc)."""
    k = w.shape[0]
    m = x.shape[0] - k + 1
    a = -(-m // block)               # row count
    s = -(-(block + k - 1) // block)  # shifted copies needed
    need = (a + s - 1) * block
    xp = jnp.pad(x, (0, need - x.shape[0])) if need > x.shape[0] else x[:need]
    base = xp.reshape(a + s - 1, block)
    frames = jnp.concatenate([base[i:i + a] for i in range(s)], axis=1)  # (A, S*B)
    # banded tap matrix H[t, b] = w[t - b] for 0 <= t-b < K
    d = (jnp.arange(s * block)[:, None] - jnp.arange(block)[None, :])
    mask = (d >= 0) & (d < k)
    wj = jnp.asarray(w, dtype=x.dtype)
    h = jnp.where(mask, jnp.take(wj, jnp.clip(d, 0, k - 1)), 0)
    out = jnp.dot(frames, h, preferred_element_type=x.dtype,
                  precision=lax.Precision.HIGHEST)
    return out.reshape(-1)[:m]


def _rconv_fft(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Stride-1 VALID correlation via FFT overlap-save -- the right lowering
    once the kernel is long enough that im2col matmuls waste work."""
    k = w.shape[0]
    m = x.shape[0] - k + 1
    seg = 1
    while seg < 4 * k:
        seg *= 2
    step = seg - k + 1
    n_blk = -(-m // step)
    xp = jnp.pad(x, (0, n_blk * step + k - 1 - x.shape[0]))
    starts = jnp.arange(n_blk) * step
    blocks = jax.vmap(lambda s0: lax.dynamic_slice(xp, (s0,), (seg,)))(starts)
    wf = jnp.fft.rfft(w[::-1].astype(x.dtype), n=seg)
    conv = jnp.fft.irfft(jnp.fft.rfft(blocks, n=seg, axis=-1) * wf,
                         n=seg, axis=-1)
    return conv[:, k - 1:].reshape(-1)[:m]


_BLOCKED_MIN = 1 << 20
_FFT_MIN_TAPS = 1024


def _rconv(x: jnp.ndarray, w: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """Real 1-D VALID cross-correlation with stride (kernel not flipped),
    dispatched to a lowering by size/stride/kernel length."""
    if stride > 1:
        return _rconv_polyphase(x, w, stride)
    if w.shape[0] >= _FFT_MIN_TAPS and x.shape[0] >= 4 * w.shape[0]:
        return _rconv_fft(x, w)
    if x.shape[0] >= _BLOCKED_MIN:
        return _rconv_blocked(x, w)
    return _rconv_direct(x, w, stride)


def conv_valid(x: jnp.ndarray, w: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """VALID sliding dot-product sum_i w[i] * x[s*m + i], complex-aware."""
    xc = jnp.iscomplexobj(x)
    wc = jnp.iscomplexobj(w)
    if not xc and not wc:
        return _rconv(x, w, stride)
    if xc and not wc:
        re = _rconv(jnp.real(x), w, stride)
        im = _rconv(jnp.imag(x), w, stride)
        return lax.complex(re, im)
    if xc and wc:
        xr, xi = jnp.real(x), jnp.imag(x)
        wr, wi = jnp.real(w), jnp.imag(w)
        re = _rconv(xr, wr, stride) - _rconv(xi, wi, stride)
        im = _rconv(xr, wi, stride) + _rconv(xi, wr, stride)
        return lax.complex(re, im)
    # real signal, complex taps
    wr, wi = jnp.real(w), jnp.imag(w)
    return lax.complex(_rconv(x, wr, stride), _rconv(x, wi, stride))


def fir_apply(x: jnp.ndarray, taps: jnp.ndarray,
              hist: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stateful FIR: y[n] = sum_k b[k] x[n-k] with history for n-k < 0.

    Equivalent to scipy `lfilter(b, [1], x, zi)` with the state carried across
    blocks (ref filters.py:64-70). Returns (y, new_hist) with len(y)==len(x).
    """
    k = taps.shape[0]
    xp = jnp.concatenate([hist.astype(x.dtype), x])
    w = taps[::-1]                      # corr(xp, reversed(b)) == causal conv
    y = conv_valid(xp, w)
    return y, xp[-(k - 1):]


def fir_decimate(x: jnp.ndarray, taps: jnp.ndarray, hist: jnp.ndarray,
                 off: jnp.ndarray, out_len: int, stride: int
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused FIR + stride-decimation producing y[off + stride*m], m < out_len.

    Identical to filtering the whole block then taking `[off::stride]`
    (ref comm.py:119-129 after filters.py:69) but computes only the kept
    outputs. `off` is the carried decimator phase; for a stream it is
    closed-form `(-global_start) % stride` (see stream.plan). `out_len` must be
    host-computed (static shape).
    """
    k = taps.shape[0]
    xp = jnp.concatenate([hist.astype(x.dtype), x])
    w = taps[::-1]
    need = (out_len - 1) * stride + k
    seg = lax.dynamic_slice(jnp.pad(xp, (0, stride)), (off,), (need,))
    y = conv_valid(seg, w, stride=stride)
    return y, xp[-(k - 1):]


def fir_zero_phase(x: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """Zero-phase FIR == scipy `filtfilt(b, [1], x)` (ref filters.py:73).

    Implements filtfilt's default 'pad' method exactly: odd extension of
    3*ntaps samples at both ends, forward pass seeded with `zi*x[0]` (for a
    FIR that is a constant `x[0]` history), backward pass likewise, then crop.
    """
    k = int(np.asarray(taps).shape[0])
    padlen = 3 * k
    n = x.shape[0]
    if n <= padlen:
        raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
    t = jnp.asarray(taps, dtype=jnp.result_type(x.dtype, jnp.float32)
                    if not jnp.iscomplexobj(x) else x.dtype)
    head = 2 * x[0] - x[1:padlen + 1][::-1]
    tail = 2 * x[-1] - x[-padlen - 1:-1][::-1]
    ext = jnp.concatenate([head, x, tail])
    # forward, history = constant ext[0] (complex-safe ones: hostio.ones)
    h0 = hostio.ones((k - 1,), x.dtype) * ext[0]
    yf, _ = fir_apply(ext, t, h0)
    # backward on the reversed forward output
    yr = yf[::-1]
    h1 = hostio.ones((k - 1,), x.dtype) * yr[0]
    yb, _ = fir_apply(yr, t, h1)
    y = yb[::-1]
    return y[padlen:padlen + n]


def ones_history(ntaps: int, dtype) -> jnp.ndarray:
    """First-block FIR history reproducing the reference's lfilter_zi seed."""
    return hostio.ones((ntaps - 1,), dtype)


def convolve_same(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """np.convolve(x, w, mode='same') (used by the normalized correlator,
    ref decode_noaa.py:672)."""
    k = w.shape[0]
    lpad = (k - 1) // 2    # 'same' keeps full-conv samples [(k-1)//2 : (k-1)//2+n)
    xp = jnp.pad(x, (k - 1 - lpad, lpad))
    return conv_valid(xp, w[::-1])


def correlate_same(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Direct (non-FFT) scipy.signal.correlate(x, w, 'same').

    Exact sliding sums matter when the downstream consumer relies on flat
    regions being *exactly* zero (the AFSK edge detector feeds a threshold-less
    peak picker, ref decode_afsk1200.py:158-170; FFT round-off there creates
    phantom peaks)."""
    return convolve_same(x, w[::-1].conj() if jnp.iscomplexobj(w) else w[::-1])
