"""The remaining peak-detection variants of the vendored billauer module.

Behavioral reference: `peakdetect_fft` / `peakdetect_parabola` / `peakdetect_sine`
/ `peakdetect_sine_locked` / `peakdetect_spline` / `peakdetect_zero_crossing` and
their helpers `_smooth` / `zero_crossings` (ref peakdetect.py:257-766). No decode
path uses them in-tree (only `peakdetect` is, ref decode_afsk1200.py:170), but
they are part of the reference's public surface, so they exist here as analysis
utilities with the same [max_peaks, min_peaks] -> [[x, y], ...] contract.

Design notes:
  * dense work (smoothing conv, FFT interpolation, B-spline prefilter scan,
    batched window fits) runs on device;
  * the per-peak curve_fit loops of the reference collapse into *batched*
    closed-form least squares: the parabola model `a (x-tau)^2 + c` is an
    overparametrized quadratic, so its LS optimum is the closed-form 3x3
    normal-equation solve, vmapped over all peak windows at once; the sine
    model `A sin(2 pi f (x-tau) + pi/2)` is linear in (a, b) for fixed f
    (`a cos + b sin`), so the locked fit is one batched 2x2 solve and the
    unlocked fit adds a few Gauss-Newton steps on f;
  * ragged bin bookkeeping (between zero crossings) stays on host over the
    sparse crossing list.

Deviations from the reference, on purpose:
  * `peakdetect_sine`/`_sine_locked` crash on Python 3 upstream
    (`zip(...)[0]`, ref peakdetect.py:453-454); here the raw-peak frequency
    estimate uses the same quantity computed py3-correctly.
  * the reference returns lazy `map` objects from the parabola/sine variants
    (ref peakdetect.py:386-391); here plain lists.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .peaks import lookahead_peaks

_WINDOWS = {
    "flat": lambda n: np.ones(n, np.float64),
    "hanning": np.hanning,
    "hamming": np.hamming,
    "bartlett": np.bartlett,
    "blackman": np.blackman,
}


# --------------------------------------------------------------------- smoothing
def smooth(x, window_len: int = 11, window: str = "hanning") -> np.ndarray:
    """Reflected-end window smoothing (ref peakdetect.py:655-715): the signal
    is extended with mirrored copies at both ends and convolved with the
    normalized window; output length is len(x) + window_len - 1."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("smooth only accepts 1 dimension arrays.")
    if x.size < window_len:
        raise ValueError("Input vector needs to be bigger than window size.")
    if window_len < 3:
        return x
    if window not in _WINDOWS:
        raise ValueError(f"Window is not one of {sorted(_WINDOWS)}")
    w = _WINDOWS[window](window_len)
    ext = np.r_[x[window_len - 1:0:-1], x, x[-1:-window_len:-1]]
    # host conv on purpose: the downstream sign-change detection is bit-
    # sensitive at near-zero samples, and these windows are tens of taps on
    # analysis-sized arrays -- oracle-exactness beats device offload here
    return np.convolve(w / w.sum(), ext, mode="valid")


# ----------------------------------------------------------------- zero crossings
def zero_crossings(y_axis, window_len: int = 11, window_f: str = "hanning",
                   offset_corrected: bool = False) -> np.ndarray:
    """Sign-change indices of the smoothed signal, with the reference's
    validity test and one-shot offset-correction recursion
    (ref peakdetect.py:718-766). Note the recursion smooths twice, exactly as
    upstream (it recurses on the already-smoothed array)."""
    y = np.asarray(y_axis, dtype=np.float64)
    length = len(y)
    ys = smooth(y, window_len, window_f)[:length]
    indices = np.where(np.diff(np.sign(ys)))[0]

    diff = np.diff(indices)
    if diff.size and diff.std() / diff.mean() > 0.1:
        ev, od = diff[::2], diff[1::2]
        if (ev.size and od.size and not offset_corrected
                and ev.std() / ev.mean() < 0.1 and od.std() / od.mean() < 0.1):
            offset = np.mean([ys.max(), ys.min()])
            return zero_crossings(ys - offset, window_len, window_f, True)
        raise ValueError("False zero-crossings found, indicates problem "
                         "with smoothing window or unhandled offset")
    if len(indices) < 1:
        raise ValueError("No zero crossings found")
    return indices - (window_len // 2 - 1)


# ------------------------------------------------------------- zero-crossing bins
def peaks_zero_crossing(y_axis, x_axis=None, window: int = 11):
    """Max/min of alternating inter-crossing bins
    (ref peakdetect.py:580-652). Returns [max_peaks, min_peaks]."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.arange(len(y)) if x_axis is None else np.asarray(x_axis)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")

    zc = zero_crossings(y, window_len=window)
    # the smoothing-delay shift can push the first crossing below 0 (the
    # reference then crashes on an empty bin, ref peakdetect.py:632); clip
    spans = [(max(int(s), 0), int(e)) for s, e in zip(zc, zc[1:])
             if e > max(int(s), 0)]
    even = spans[::2]
    odd = spans[1::2]

    def bin_max(spans):
        out = []
        for s, e in spans:
            k = s + int(np.argmax(y[s:e]))
            out.append([x[k], y[k]])
        return out

    def bin_min(spans):
        out = []
        for s, e in spans:
            k = s + int(np.argmin(y[s:e]))
            out.append([x[k], y[k]])
        return out

    s0, e0 = even[0]
    if abs(y[s0:e0].max()) > abs(y[s0:e0].min()):
        return [bin_max(even), bin_min(odd)]
    return [bin_max(odd), bin_min(even)]


# ----------------------------------------------------------------- FFT interpolation
def peaks_fft(y_axis, x_axis, pad_len: int = 20):
    """Zero-padded-FFT time-domain interpolation between the first and last
    zero crossing, then lookahead peak detection on the upsampled waveform
    (ref peakdetect.py:257-337)."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    zc = zero_crossings(y, window_len=11)
    last = -1 - (1 - len(zc) & 1)       # keep a whole number of periods
    seg = y[zc[0]:zc[last]]

    n_fft = len(seg)
    n_pad = 2 ** (int(np.log2(n_fft * pad_len)) + 1)
    yi = np.asarray(_fft_interp(jnp.asarray(seg), n_pad))
    xi = np.linspace(x[zc[0]], x[zc[last]], len(yi))

    delta = float(np.abs(np.diff(y)).max() * 2)
    max_p, min_p = lookahead_peaks(jnp.asarray(yi), 500, delta)
    return [[[xi[int(i)], v] for i, v in max_p],
            [[xi[int(i)], v] for i, v in min_p]]


@partial(jax.jit, static_argnums=(1,))
def _fft_interp(seg, n_pad: int):
    """Mid-spectrum zero padding: X[:n/2] ++ zeros ++ X[n/2:], scaled by the
    length ratio (ref peakdetect.py:313-324)."""
    from .fftutil import fft_any, ifft_any
    n = seg.shape[0]
    f = fft_any(seg)
    padded = jnp.concatenate(
        [f[: n // 2], jnp.zeros(n_pad - n, dtype=f.dtype), f[n // 2:]])
    return jnp.real(ifft_any(padded)) * (n_pad / n)


# ------------------------------------------------------------------ window gather
def _peak_windows(y: np.ndarray, x: np.ndarray, idx: np.ndarray, points: int):
    """Stack the `points`-wide windows around each raw peak index. Windows are
    clipped at the array ends (the reference slices, which silently shortens
    edge windows; clipping keeps them fixed-width for batching)."""
    half = points // 2
    offs = np.arange(-half, half + 1)
    cols = np.clip(idx[:, None] + offs[None, :], 0, len(y) - 1)
    return x[cols], y[cols]


@jax.jit
def _fit_quadratic(xw, yw):
    """Batched closed-form LS quadratic fit; returns (vertex_x, vertex_y).
    Same optimum as the reference's curve_fit of a*(x-tau)**2+c
    (ref peakdetect.py:101-120) because that model is an overparametrized
    quadratic. Windows are mean-centered for conditioning."""
    x0 = jnp.mean(xw, axis=1, keepdims=True)
    xc = xw - x0
    V = jnp.stack([xc * xc, xc, jnp.ones_like(xc)], axis=-1)   # (B, P, 3)
    # HIGHEST: a default-precision f32 contraction runs in TF32 on the GPU
    G = jnp.einsum("bpi,bpj->bij", V, V, precision=lax.Precision.HIGHEST)
    r = jnp.einsum("bpi,bp->bi", V, yw, precision=lax.Precision.HIGHEST)
    abc = jnp.linalg.solve(G, r[..., None])[..., 0]             # y = a t^2 + b t + c
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    tau = -b / (2 * a)
    return tau + x0[:, 0], c - b * b / (4 * a)


def peaks_parabola(y_axis, x_axis, points: int = 31):
    """Parabola-refined peaks: raw zero-crossing peaks, then a batched
    quadratic LS fit per window (ref peakdetect.py:340-391)."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    points += 1 - points % 2
    max_raw, min_raw = peaks_zero_crossing(y)      # index-valued x
    out = []
    for raw in (max_raw, min_raw):
        idx = np.asarray([int(p[0]) for p in raw])
        xw, yw = _peak_windows(y, x, idx, points)
        px, pv = _fit_quadratic(jnp.asarray(xw), jnp.asarray(yw))
        out.append([[float(a), float(b)] for a, b in zip(px, pv)])
    return out


# ----------------------------------------------------------------------- sine fits
@partial(jax.jit, static_argnums=(3,))
def _fit_cosine(xw, yw, hz0, lock: bool, iters: int = 8):
    """Batched fit of y = A sin(2 pi f (x - tau) + pi/2) == A cos(w (x - tau))
    (ref peakdetect.py:457-493). For fixed f the model is linear in
    (a, b) = (A cos(w tau), A sin(w tau)); unlocked mode refines f by a short
    damped Gauss-Newton on the shared-frequency residual per window."""
    def solve_ab(w):
        c = jnp.cos(w[:, None] * xw)
        s = jnp.sin(w[:, None] * xw)
        g11 = jnp.sum(c * c, axis=1)
        g12 = jnp.sum(c * s, axis=1)
        g22 = jnp.sum(s * s, axis=1)
        r1 = jnp.sum(c * yw, axis=1)
        r2 = jnp.sum(s * yw, axis=1)
        det = g11 * g22 - g12 * g12
        a = (g22 * r1 - g12 * r2) / det
        b = (g11 * r2 - g12 * r1) / det
        return a, b

    w = jnp.full((xw.shape[0],), 2 * jnp.pi * hz0, dtype=xw.dtype)
    if not lock:
        def step(w, _):
            a, b = solve_ab(w)
            model = a[:, None] * jnp.cos(w[:, None] * xw) \
                + b[:, None] * jnp.sin(w[:, None] * xw)
            resid = yw - model
            dm_dw = xw * (-a[:, None] * jnp.sin(w[:, None] * xw)
                          + b[:, None] * jnp.cos(w[:, None] * xw))
            num = jnp.sum(dm_dw * resid, axis=1)
            den = jnp.sum(dm_dw * dm_dw, axis=1) + 1e-12
            return w + 0.5 * num / den, None
        w, _ = lax.scan(step, w, None, length=iters)
    a, b = solve_ab(w)
    amp = jnp.hypot(a, b)
    phase = jnp.arctan2(b, a)                 # y = amp cos(w x - phase)
    # tau = nearest extremum of the fitted cosine to the window center
    xc = xw[:, xw.shape[1] // 2]
    k = jnp.round((w * xc - phase) / jnp.pi)
    tau = (phase + jnp.pi * k) / w
    sign = jnp.where(jnp.mod(k, 2) == 0, 1.0, -1.0)
    return tau, sign * amp


def peaks_sine(y_axis, x_axis, points: int = 31, lock_frequency: bool = False):
    """Sine-model-refined peaks (ref peakdetect.py:394-514): global offset
    from the raw peak means, frequency seeded from raw peak spacing, batched
    cosine LS fit per window; returns [[tau, A + offset], ...] per polarity
    (A carries the minima's negative sign, as upstream)."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    points += 1 - points % 2
    max_raw, min_raw = peaks_zero_crossing(y)
    offset = np.mean([np.mean([p[1] for p in max_raw]),
                      np.mean([p[1] for p in min_raw])])
    # raw peak spacing -> frequency seed, in x units (the reference computes
    # this in index units then fits in x units, which only coincide for an
    # index x-axis; its py3-broken zip also never runs -- fixed here)
    dx = np.mean([np.mean(np.diff([x[int(p[0])] for p in max_raw])),
                  np.mean(np.diff([x[int(p[0])] for p in min_raw]))])
    hz0 = 1.0 / dx

    out = []
    for raw in (max_raw, min_raw):
        idx = np.asarray([int(p[0]) for p in raw])
        xw, yw = _peak_windows(y, x, idx, points)
        px, pa = _fit_cosine(jnp.asarray(xw), jnp.asarray(yw - offset),
                             hz0, bool(lock_frequency))
        out.append([[float(a), float(b) + offset] for a, b in zip(px, pa)])
    return out


def peaks_sine_locked(y_axis, x_axis, points: int = 31):
    """peaks_sine with the frequency locked to the raw estimate
    (ref peakdetect.py:517-531)."""
    return peaks_sine(y_axis, x_axis, points, True)


# ------------------------------------------------------------------ cubic spline
_SPLINE_POLE = np.sqrt(3.0) - 2.0


@jax.jit
def _cspline_coeffs(y):
    """Cubic B-spline prefilter (mirror-symmetric), the device analog of
    scipy's cspline1d used by the reference (ref peakdetect.py:572): causal +
    anticausal first-order recursions via lax.scan with exact mirror inits."""
    z = _SPLINE_POLE
    n = y.shape[0]
    # causal init with the full-length mirror sum (scipy's exact form)
    pows = z ** jnp.arange(n, dtype=y.dtype)
    c0 = y[0] + z * jnp.dot(pows, y, precision=lax.Precision.HIGHEST)

    def fwd(carry, yi):
        c = yi + z * carry
        return c, c
    _, cp = lax.scan(fwd, c0, y[1:])
    cp = jnp.concatenate([jnp.array([c0], dtype=y.dtype), cp])

    # anticausal init
    cN = (z / (z - 1.0)) * cp[-1]

    def bwd(carry, ci):
        c = z * (carry - ci)
        return c, c
    _, cm = lax.scan(bwd, cN, cp[:-1][::-1])
    cm = jnp.concatenate([cm[::-1], jnp.array([cN], dtype=y.dtype)])
    return cm * 6.0


@jax.jit
def _cspline_eval(coeffs, u):
    """Evaluate sum_k c[k] beta3(u - k) with mirror-symmetric coefficient
    extension; u is in (fractional) sample units."""
    n = coeffs.shape[0]
    base = jnp.floor(u).astype(jnp.int32)
    acc = jnp.zeros_like(u)
    for off in (-1, 0, 1, 2):
        k = base + off
        # mirror-symmetric index fold into [0, n-1]
        k = jnp.abs(k)
        k = jnp.where(k > n - 1, 2 * (n - 1) - k, k)
        t = jnp.abs(u - (base + off).astype(u.dtype))
        b3 = jnp.where(t < 1.0, 2.0 / 3.0 - t * t + 0.5 * t ** 3,
                       jnp.where(t < 2.0, ((2.0 - t) ** 3) / 6.0, 0.0))
        acc = acc + coeffs[k] * b3
    return acc


def peaks_spline(y_axis, x_axis, pad_len: int = 20):
    """B-spline-interpolated zero-crossing peaks (ref peakdetect.py:534-577):
    resolution is raised (pad_len+1)x by evaluating the cubic spline on a
    dense grid, then binned extrema between crossings."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    dx = x[1] - x[0]
    xi = np.linspace(x.min(), x.max(), len(x) * (pad_len + 1))
    u = (xi - x[0]) / dx
    coeffs = _cspline_coeffs(jnp.asarray(y))
    yi = np.asarray(_cspline_eval(coeffs, jnp.asarray(u)))
    return peaks_zero_crossing(yi, xi)
