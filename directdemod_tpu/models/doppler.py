"""Doppler-shift estimation from an averaged FFT waterfall.

Behavioral reference: `sandbox/frequency_shift.py:5-149` (a production
dependency of the funcube decoder, ref decode_funcube.py:5,205): 8192-point
windows over the *raw byte stream* (adc offset -127), magnitude spectra
accumulated in groups of ~1 second, per-group argmax inside the channel band,
10%-length rolling-mean smoothing, indexed by relative chunk position.

Device design: all window FFTs run as one batched device FFT; grouping/argmax is
vectorized. The reference recomputes the whole waterfall for every chunk
(O(chunks * full file)); the track is deterministic, so we compute it once and
cache -- same values, ~60x less work on a one-hour capture.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils import hostio

WINDOW = 2048 * 2 * 2


def _accumulated_rows(raw_bytes: np.ndarray, window: int, every: float):
    """Group-accumulated |FFT| rows (ref frequency_shift.py:5-44)."""
    n_win = len(raw_bytes) // (2 * window)
    if n_win == 0:
        return np.empty((0, window))
    b = np.asarray(raw_bytes[: n_win * 2 * window], dtype=np.float32)
    iq = (b[0::2] - 127.0) + 1j * (b[1::2] - 127.0)
    frames = hostio.device_put(iq.reshape(n_win, window), dtype=jnp.complex64)
    mags = np.asarray(jnp.abs(jnp.fft.fft(frames, axis=-1)))
    rows = []
    acc = np.zeros(window)
    count = 0
    for k in range(n_win):
        acc = mags[k] if count == 0 and k == 0 else acc + mags[k]
        count += 1
        if count >= every:
            rows.append(np.log(np.fft.fftshift(acc) / window / every))
            acc = np.zeros(window)
            count = 0
    return np.asarray(rows)


def _rolling_mean(track: np.ndarray, w: int) -> np.ndarray:
    """The reference's edge-handling rolling mean (ref frequency_shift.py:46-57)."""
    n = len(track)
    out = np.empty(n)
    for i in range(n):
        if i < w // 2:
            out[i] = np.mean(track[0:w])
        elif i > n - w // 2:
            out[i] = np.mean(track[-(w // 2):])
        else:
            out[i] = np.mean(track[i - w // 2: i - w // 2 + w])
    return out


def find_shift(raw_bytes, samp_rate, center_freq, channel_freq, bandwidth
               ) -> np.ndarray:
    """Smoothed frequency-offset track in Hz over relative capture time
    (ref frequency_shift.py:60-126)."""
    window = WINDOW
    xf = np.fft.fftshift(np.fft.fftfreq(window, 1.0 / samp_rate))
    df = xf[1] - xf[0]
    every = (len(raw_bytes) / (samp_rate * 2.0)) * 8192.0 / window
    rows = _accumulated_rows(raw_bytes, window, every)
    center = (samp_rate / 2 + (channel_freq - center_freq)) / df
    b0 = int(center - bandwidth / (2 * df))
    b1 = int(center + bandwidth / (2 * df))
    band = rows[:, b0:b1]
    band = band - np.min(band, axis=-1, keepdims=True)
    track = np.argmax(band, axis=-1) - bandwidth / (2 * df)
    w = int(len(track) * 0.1)
    if w >= 1:
        track = _rolling_mean(track, w)
    return np.asarray(track) * df


class DopplerTracker:
    """Cached per-chunk Doppler correction (ref frequency_shift.py:128-149)."""

    def __init__(self, raw_bytes, samp_rate, center_freq, channel_freq,
                 bandwidth=20000):
        self._args = (raw_bytes, samp_rate, center_freq, channel_freq, bandwidth)
        self._track = None

    @property
    def track(self) -> np.ndarray:
        if self._track is None:
            self._track = find_shift(*self._args)
        return self._track

    def correct(self, chunk_number: int, chunk_count: int) -> float:
        """Shift (Hz) for chunk k of n, nearest-track-row lookup
        (ref frequency_shift.py:128-144)."""
        shift = self.track
        position = chunk_number / chunk_count
        step = 1.0 / (len(shift) - 1)
        x1 = int(np.floor(position / step + step / 2))
        return float(shift[min(x1, len(shift) - 1)])
