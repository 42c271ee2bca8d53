"""Numerically-controlled oscillator (frequency shifting) for long streams.

Behavioral reference: `comm.commSignal.offsetFreq` (ref comm.py:63-78):
``x[n] *= exp(-2j*pi*f*(g0+n)/Fs)`` with ``g0`` the global index of the first
sample (carried through the chunker KV store in the reference; here an explicit
argument).

Device design: global indices reach 1e9+, so a single fp32 phase ramp loses
~0.1 rad by the end of a 20M-sample block. We anchor the phase in fp64 on the
host every `SUBBLOCK` samples (a handful of scalars per block) and let the
device extend each anchor with a short local fp32 ramp, bounding the phase
error at ~1e-4 rad regardless of stream position.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

SUBBLOCK = 8192


@jax.jit
def _osc_apply(x, ph):
    """x * exp(j*ph), one fused dispatch."""
    return x * jnp.exp(1j * ph).astype(x.dtype)


def phase_anchors(freq: float, fs: float, start: int, n: int,
                  sub: int = SUBBLOCK, dtype=np.float32) -> np.ndarray:
    """Host fp64: phase (mod 2pi) at the start of each sub-block."""
    nsub = -(-n // sub)
    idx = start + sub * np.arange(nsub, dtype=np.float64)
    ph = (-2.0 * np.pi * float(freq) / float(fs)) * idx
    return np.mod(ph, 2.0 * np.pi).astype(dtype)


def mix(x: jnp.ndarray, omega: float, anchors: jnp.ndarray,
        sub: int = SUBBLOCK) -> jnp.ndarray:
    """Device: multiply x by exp(j*(anchor_b + omega*r)) for local offset r.

    `omega` is the per-sample phase increment -2*pi*f/fs (constant baked at
    trace time); `anchors` come from `phase_anchors` and set the precision.
    """
    n = x.shape[0]
    dt = anchors.dtype
    ramp = jnp.asarray(omega, dtype=dt) * jnp.arange(sub, dtype=dt)
    ph = (anchors[:, None] + ramp[None, :]).reshape(-1)[:n]
    return _osc_apply(x, ph)


def mix_array_freq(x: jnp.ndarray, freqs: np.ndarray, fs: float,
                   start: int = 0) -> jnp.ndarray:
    """Per-sample frequency offsets (Doppler ramps), chunk-local indices.

    Matches ref comm.py:77 with an array `freqOffset` and no chunker (the
    funcube path constructs commSignal without a chunker, so n restarts at 0
    each chunk -- ref decode_funcube.py:199,228). Phase is the *instantaneous*
    frequency times absolute time, not an integrated phase, mirroring the
    reference formula exactly.

    `freqs` must be host-side (the Doppler track is computed on the host); the
    mean frequency's phase ramp rides the same host-fp64 anchor mechanism as
    `phase_anchors`, and only the small per-sample delta runs in fp32 — a
    Doppler spread of a few kHz over a 20M-sample chunk keeps the fp32 delta
    phase well under 1e-3 rad of error.
    """
    n = int(x.shape[0])
    freqs_np = np.asarray(freqs, dtype=np.float64).reshape(-1)
    base = float(freqs_np[0])
    delta = jnp.asarray(freqs_np - base, dtype=jnp.float32)
    idx_local = jnp.arange(n, dtype=jnp.float32)
    anchors = jnp.asarray(phase_anchors(base, fs, start, n))
    omega = np.float32(-2.0 * np.pi * base / fs)
    ramp = omega * jnp.arange(SUBBLOCK, dtype=jnp.float32)
    ph_base = (anchors[:, None] + ramp[None, :]).reshape(-1)[:n]
    ph_delta = (-2.0 * np.pi / fs) * delta * (idx_local + jnp.float32(start))
    return _osc_apply(x, ph_base + ph_delta)
