"""IIR (Butterworth) filtering as block-parallel second-order sections.

Behavioral reference: `filters.butter` + `filter.applyOn` (ref
filters.py:232-273, 53-75): scipy `lfilter(b, a, x, zi)` with the DF2T state
carried across blocks, plus the `filtfilt` zero-phase mode (ref filters.py:73).

Device design: a per-sample recurrence is serial, and powers of a
high-order companion matrix overflow, so each filter is factored into biquads
(see ops/design.butter_sos) and every biquad is evaluated with the exact
linear-systems block decomposition:

    z[t] = A z[t-1] + B x[t],   y[t] = C z[t-1] + D x[t]      (A is 2x2)

For a block of length L with incoming state s:

    y[t] = (C A^t) s + (h * x)[t]        zero-input response + causal conv
    s'   = A^L s + sum_t A^(L-1-t) B x[t]

Per-sample work is a batched FFT convolution with `h[:L]` plus two skinny
matmuls against host-precomputed fp64 constants; only the 2-dim block-boundary
states are sequential (one `lax.scan` over ~N/L steps). Output equals scipy's
`lfilter` up to fp rounding -- cross-block influence flows exactly through the
state, not through any truncated tail. The matmuls ask for HIGHEST precision:
a default-precision float32 matmul runs in TF32 on the GPU, three decimal
digits, far from the f32-grade contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import hostio
from jax import lax

from . import design


def _biquad_state_space(section):
    """DF2T state-space (A, B, C, D) for one SOS row [b0 b1 b2 1 a1 a2]."""
    b0, b1, b2, a0, a1, a2 = (float(v) for v in section)
    b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    B = np.array([b1 - a1 * b0, b2 - a2 * b0])
    C = np.array([1.0, 0.0])
    D = b0
    return A, B, C, D


def _mm(a, b):
    """Full-f32 matmul for the block decomposition (see module doc), with
    at most one complex operand. The complex side is split into real and
    imaginary parts against the real matrix: exact, and XLA's GPU autotuner
    fails to compile a complex64 dot at HIGHEST precision."""
    if jnp.iscomplexobj(b):
        return lax.complex(_mm(a, jnp.real(b)), _mm(a, jnp.imag(b)))
    if jnp.iscomplexobj(a):
        return lax.complex(_mm(jnp.real(a), b), _mm(jnp.imag(a), b))
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def _segment_constants(A, B, C, D, L):
    """(h[:L], S rows C A^t, G rows A^(L-1-t) B, A^L)."""
    m = A.shape[0]
    S = np.empty((L, m))
    h = np.empty(L)
    h[0] = D
    v = C.copy()
    for t in range(L):
        S[t] = v
        if t + 1 < L:
            h[t + 1] = v @ B
        v = v @ A
    G = np.empty((L, m))
    w = B.copy()
    for t in range(L - 1, -1, -1):
        G[t] = w
        w = A @ w
    AL = np.linalg.matrix_power(A, L)
    return h, S, G, AL


def _biquad_zi_step(section) -> np.ndarray:
    """Steady-state DF2T state of this biquad for a unit-step input."""
    b = np.asarray(section[:3], dtype=np.float64)
    a = np.asarray(section[3:], dtype=np.float64)
    return design.lfilter_zi(b, a)


def _dc_gain(section) -> float:
    return float(np.sum(section[:3]) / np.sum(section[3:]))


@dataclass(frozen=True)
class IirFilter:
    """A cascade of second-order sections with block-parallel evaluation.

    `sos` is a tuple of 6-tuples (rows of a scipy-style SOS matrix). State is a
    flat (2 * n_sections,) vector. Build once on the host; `apply` is jittable.
    """
    sos: tuple
    block: int = 4096

    @staticmethod
    @lru_cache(maxsize=128)
    def design_butter(fs, cutoff_a, cutoff_b=None, order=6, kind="lowpass",
                      block=4096) -> "IirFilter":
        """Mirrors the reference constructor (ref filters.py:238-273).

        Cached: chunk loops (and `am.envelope_lowpass`) re-request the same
        design every block; the host-side ZPK->SOS walk runs once."""
        if kind in ("lowpass", "highpass"):
            wn = cutoff_a / (0.5 * fs)
        else:
            wn = [cutoff_a / (0.5 * fs), cutoff_b / (0.5 * fs)]
        sos = design.butter_sos(order, wn, btype=kind)
        return IirFilter(tuple(tuple(r) for r in sos), block)

    @staticmethod
    def from_ba(b, a, block=4096) -> "IirFilter":
        """Single (possibly high-order) section -- only safe for low orders."""
        n = max(len(b), len(a))
        if n > 3:
            raise ValueError("use design_butter / SOS for order > 2")
        b = np.pad(np.asarray(b, dtype=np.float64), (0, 3 - len(b)))
        a = np.pad(np.asarray(a, dtype=np.float64), (0, 3 - len(a)))
        return IirFilter((tuple(np.concatenate([b, a])),), block)

    @property
    def n_sections(self) -> int:
        return len(self.sos)

    def ba(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat (b, a) polynomials (for tests / introspection)."""
        b, a = np.array([1.0]), np.array([1.0])
        for s in self.sos:
            b = np.convolve(b, np.asarray(s[:3]))
            a = np.convolve(a, np.asarray(s[3:]))
        return b, a

    def initial_state_step(self, dtype=jnp.float32) -> jnp.ndarray:
        """First-block seed matching the reference quirk: raw `lfilter_zi`
        (steady state of a *unit step*, not scaled by x[0]) -- ref
        filters.py:45,69. Per section the equivalent seed is its own step
        steady-state scaled by the DC gain of the upstream sections."""
        states = []
        gain_in = 1.0
        for s in self.sos:
            states.append(_biquad_zi_step(s) * gain_in)
            gain_in *= _dc_gain(s)
        return hostio.device_put(np.concatenate(states), dtype=dtype)

    def initial_state_zero(self, dtype=jnp.float32) -> jnp.ndarray:
        return hostio.zeros((2 * self.n_sections,), dtype)

    @lru_cache(maxsize=64)
    def _consts(self, L: int):
        out = []
        for s in self.sos:
            A, B, C, D = _biquad_state_space(s)
            out.append(_segment_constants(A, B, C, D, L))
        return out

    def _apply_section(self, x, z, consts, consts_tail, np_last):
        h, S, G, AL = consts
        L = len(h)
        n = int(x.shape[0])
        nb = -(-n // L)
        cplx = jnp.iscomplexobj(x)
        rdt = jnp.float64 if x.dtype in (jnp.float64, jnp.complex128) else jnp.float32
        cdt = jnp.complex128 if rdt == jnp.float64 else jnp.complex64

        from .fftutil import smooth_len
        m = smooth_len(2 * L - 1)      # >= linear-conv length, 5-smooth FFT size
        hf = jnp.fft.fft(jnp.asarray(h, dtype=rdt).astype(cdt), n=m)
        Sj = jnp.asarray(S, dtype=rdt)
        Gj = jnp.asarray(G, dtype=rdt)
        ALj = jnp.asarray(AL, dtype=rdt)

        xb = jnp.pad(x, (0, nb * L - n)).reshape(nb, L)
        f = _mm(xb, Gj)                                   # (nb, 2)
        # unroll: every while-loop trip carries a fixed overhead that
        # dominates this tiny (2,)@(2,2) body; unrolling changes no
        # arithmetic
        _, s_hist = lax.scan(lambda s, fj: (_mm(s, ALj.T) + fj, s),
                             z.astype(f.dtype), f, unroll=32)

        conv = jnp.fft.ifft(jnp.fft.fft(xb.astype(cdt), n=m, axis=-1) * hf,
                            axis=-1)[:, :L]
        conv = conv if cplx else conv.real
        y = (conv + _mm(s_hist, Sj.T)).reshape(-1)[:n].astype(x.dtype)

        if np_last == L:
            z_out = _mm(s_hist[-1], ALj.T) + f[-1]
        else:
            _, _, Gp, ALp = consts_tail
            z_out = (_mm(s_hist[-1], jnp.asarray(ALp, dtype=rdt).T)
                     + _mm(xb[-1, :np_last], jnp.asarray(Gp, dtype=rdt)))
        return y, z_out

    @partial(jax.jit, static_argnums=(0,))
    def apply(self, x: jnp.ndarray, z: jnp.ndarray
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Exact lfilter through the cascade; returns (y, z').
        Jitted as one unit (the cascade is ~40 XLA ops)."""
        n = int(x.shape[0])
        L = min(self.block, max(16, n))
        np_last = n - (-(-n // L) - 1) * L
        consts = self._consts(L)
        consts_tail = consts if np_last == L else self._consts(np_last)
        zs = z.reshape(self.n_sections, 2)
        z_out = []
        y = x
        for i in range(self.n_sections):
            y, zo = self._apply_section(y, zs[i], consts[i],
                                        consts_tail[i], np_last)
            z_out.append(zo)
        return y, jnp.stack(z_out).reshape(-1)

    @partial(jax.jit, static_argnums=(0,))
    def zero_phase(self, x: jnp.ndarray) -> jnp.ndarray:
        """scipy filtfilt(b, a, x) default 'pad' method (ref filters.py:73)."""
        b, a = self.ba()
        padlen = 3 * max(len(b), len(a))
        n = x.shape[0]
        if n <= padlen:
            raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
        head = 2 * x[0] - x[1:padlen + 1][::-1]
        tail = 2 * x[-1] - x[-padlen - 1:-1][::-1]
        ext = jnp.concatenate([head, x, tail])
        dt = (jnp.float64 if x.dtype in (jnp.float64, jnp.complex128)
              else jnp.float32)
        zi = self.initial_state_step(dt)
        yf, _ = self.apply(ext, zi * ext[0])
        yr = yf[::-1]
        yb, _ = self.apply(yr, zi * yr[0])
        return yb[::-1][padlen:padlen + n]
