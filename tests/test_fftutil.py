"""Arbitrary-length FFT parity: fftutil vs numpy on awkward (non-5-smooth)
lengths — the sizes that fftutil routes through Bluestein's chirp-z.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from directdemod_tpu.ops import fftutil

# 136470 is the real-world Hilbert remainder block that produced a 74 GB
# allocation before chirp-z routing; keep a scaled-down cousin (2 * 3 * 5 * 7
# * 11 * 13) plus primes and even/odd mixes.
LENGTHS = [7, 97, 1009, 4097, 30030, 8192, 1250, 2187]


@pytest.mark.parametrize("n", LENGTHS)
def test_fft_ifft_any(n, rng):
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = np.asarray(fftutil.fft_any(jnp.asarray(x)))
    want = np.fft.fft(x)
    scale = max(1.0, np.abs(want).max())
    assert np.max(np.abs(got - want)) / scale < 2e-5
    back = np.asarray(fftutil.ifft_any(jnp.asarray(got)))
    assert np.max(np.abs(back - x)) < 2e-4


@pytest.mark.parametrize("n", [97, 4097, 30030])
def test_rfft_irfft_any(n, rng):
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(fftutil.rfft_any(jnp.asarray(x)))
    want = np.fft.rfft(x)
    scale = max(1.0, np.abs(want).max())
    assert np.max(np.abs(got - want)) / scale < 2e-5
    back = np.asarray(fftutil.irfft_any(jnp.asarray(got), n))
    assert np.max(np.abs(back - x)) < 2e-4


def test_batched_axis(rng):
    x = rng.standard_normal((4, 1009)).astype(np.float32)
    got = np.asarray(fftutil.fft_any(jnp.asarray(x), axis=-1))
    want = np.fft.fft(x, axis=-1)
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 2e-5


def test_smooth_passthrough(rng):
    # 5-smooth lengths take the direct jnp.fft path
    assert fftutil.is_5smooth(240000) and not fftutil.is_5smooth(136470)
    x = rng.standard_normal(3840).astype(np.float32)
    got = np.asarray(fftutil.fft_any(jnp.asarray(x)))
    assert np.allclose(got, np.fft.fft(x), atol=1e-2)


def test_hilbert_awkward_length(rng):
    import scipy.signal as ss
    from directdemod_tpu.ops import am
    n = 13647                       # non-smooth, like the remainder block
    x = rng.standard_normal(n).astype(np.float64)
    got = np.asarray(am.envelope(jnp.asarray(x)))
    want = np.abs(ss.hilbert(x))
    assert np.max(np.abs(got - want)) < 1e-8


def test_resample_awkward_lengths(rng):
    import scipy.signal as ss
    from directdemod_tpu.ops import resample as rs
    x = rng.standard_normal(1013).astype(np.float64)
    for num in (509, 2027):
        got = np.asarray(rs.fft_resample(jnp.asarray(x), num))
        want = ss.resample(x, num)
        assert np.max(np.abs(got - want)) < 1e-8, num


def test_bluestein_large_realistic_n(rng):
    """ADVICE r1: the motivating ~136k-sample Hilbert remainder block, in
    complex64 — the chirp multiplies run in c64 on device, so the error is
    larger than the small-n cases; the documented bound is 2e-4 relative
    (observed ~3e-5 on CPU c64, leaving headroom for device rounding)."""
    n = 136470                      # 2 * 3^3 * 7 * 19^2: non-smooth, large
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = np.asarray(fftutil.fft_any(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) / scale < 2e-4


def test_irfft_any_short_spectrum_pads(rng):
    """ADVICE r1: jnp.fft.irfft(n=...) zero-pads a spectrum shorter than
    n//2+1; the Bluestein fallback must match."""
    n = 1009                        # prime -> Bluestein path
    x = rng.standard_normal(n).astype(np.float64)
    spec = np.fft.rfft(x)[: n // 2 - 100]        # deliberately short
    got = np.asarray(fftutil.irfft_any(jnp.asarray(spec), n))
    want = np.fft.irfft(spec, n=n)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-9
