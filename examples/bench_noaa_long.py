#!/usr/bin/env python3
"""Long-capture NOAA decode: a full-pass-scale synthetic capture decoded
device-resident.

    python examples/bench_noaa_long.py [--minutes M]

Also a scale stress test: at >= 5 minutes the envelope line-start indices
pass 2^24, exercising the exact (hi, lo) packing throughout (the round-3
ADVICE float32-quantization hazard).

Prints one JSON line.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def _rational(num: float, den: int) -> tuple[int, int]:
    """num/den as a reduced integer ratio (num must be an integer value)."""
    from math import gcd
    num = int(round(num))
    g = gcd(num, den)
    return num // g, den // g


def synth_long_bytes(n_lines: int, fs: int = 2048000,
                     offset_hz: float = 30000.0, dev_hz: float = 17000.0,
                     chunk: int = 1 << 24, seed: int = 0) -> np.ndarray:
    """Full-pass APT synthesis straight to interleaved uint8 IQ bytes, run
    as a JAX program on the default device (seconds for a 10-minute pass on
    a GPU). The signal model is tests/apt_synth.synthesize's: the planted
    gradient lines, luminance -> 2400 Hz subcarrier amplitude, FM onto
    `offset_hz`, 0.05 complex Gaussian noise, 8-bit quantization.

    Phases stay exact without float64: the word index and the subcarrier
    and carrier phases are integer ratios of the sample index, evaluated
    as (host remainder + chunk-local integer) so every intermediate fits
    int32; only the FM modulation integral is accumulated in float32,
    chunk by chunk, with its carry reduced mod 2 pi."""
    import jax
    import jax.numpy as jnp
    from apt_synth import apt_line_words, WORD_RATE

    lines = []
    for i in range(n_lines):
        a = np.linspace(30, 220, 1000) + 10 * (i % 3)
        b = np.linspace(220, 30, 1000)
        lines.append(apt_line_words(a, b))
    words = jnp.asarray(np.concatenate(lines), jnp.float32)
    n_words = int(words.shape[0])

    w_num, w_den = _rational(WORD_RATE, fs)        # word index ratio
    s_num, s_den = _rational(2400.0, fs)           # subcarrier cycles
    c_num, c_den = _rational(offset_hz, fs)        # carrier cycles
    if chunk * max(w_num, s_num, c_num) + max(w_den, s_den, c_den) >= 2**31:
        raise ValueError("chunk too long for int32 phase arithmetic")
    kdev = np.float32(2 * np.pi * dev_hz / fs)
    two_pi = np.float32(2 * np.pi)

    @jax.jit
    def one_chunk(carry, w_q, w_r, s_r, c_r, key):
        i = jnp.arange(chunk, dtype=jnp.int32)
        widx = jnp.minimum(w_q + (w_r + i * w_num) // w_den, n_words - 1)
        env = 0.05 + 0.9 * words[widx] / 255.0
        sub = ((s_r + i * s_num) % s_den).astype(jnp.float32) / s_den
        mod = carry + jnp.cumsum(kdev * env * jnp.cos(two_pi * sub))
        car = ((c_r + i * c_num) % c_den).astype(jnp.float32) / c_den
        phase = two_pi * car + mod
        noise = 0.05 * jax.random.normal(key, (2, chunk), jnp.float32)
        iq = jnp.stack([jnp.cos(phase) + noise[0], jnp.sin(phase) + noise[1]],
                       axis=-1)
        u8 = jnp.clip(jnp.round(iq * 90.0 + 127.5), 0, 255).astype(jnp.uint8)
        return jnp.mod(mod[-1], two_pi), u8.reshape(-1)

    n = int((n_lines * 0.5 + 0.25) * fs)
    out = np.empty(2 * n, dtype=np.uint8)
    key = jax.random.key(seed)
    carry = jnp.float32(0.0)
    for k, s0 in enumerate(range(0, n, chunk)):
        w_q, w_r = divmod(s0 * w_num, w_den)
        carry, u8 = one_chunk(carry, w_q, w_r, (s0 * s_num) % s_den,
                              (s0 * c_num) % c_den, jax.random.fold_in(key, k))
        e = min(n, s0 + chunk)
        out[2 * s0: 2 * e] = np.asarray(u8)[: 2 * (e - s0)]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--cache", type=str, default=None,
                    help="path to cache the synthesized byte capture")
    args = ap.parse_args()

    import jax
    from directdemod_tpu.io.sources import DeviceRawSource
    from directdemod_tpu.models.noaa import NoaaDecoder

    fs = 2048000
    n_lines = int(args.minutes * 60 * 2)
    t0 = time.perf_counter()
    if args.cache and os.path.exists(args.cache):
        raw = np.fromfile(args.cache, dtype=np.uint8)
    else:
        raw = synth_long_bytes(n_lines, fs)
        if args.cache:
            raw.tofile(args.cache)
    synth_s = time.perf_counter() - t0
    capture_s = len(raw) / 2 / fs
    print(json.dumps({"phase": "synth", "seconds": round(synth_s, 1),
                      "capture_seconds": round(capture_s, 1)}),
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    src = DeviceRawSource.from_host_bytes(raw, fs)
    jax.block_until_ready(src._raw)
    upload_s = time.perf_counter() - t0

    # warm (compiles shapes for this capture length)
    dec = NoaaDecoder(src, offset=30000)
    t0 = time.perf_counter()
    useful = dec.useful
    img = dec.get_image()
    warm_s = time.perf_counter() - t0

    dec2 = NoaaDecoder(src, offset=30000)
    t0 = time.perf_counter()
    useful = dec2.useful
    img = dec2.get_image()
    dt = time.perf_counter() - t0

    print(json.dumps({
        "metric": "noaa_long_resident_decode",
        "value": round(dt, 3),
        "unit": "s",
        "capture_seconds": round(capture_s, 1),
        "capture_samples": len(raw) // 2,
        "realtime_factor": round(capture_s / dt, 1),
        "useful": useful,
        "image_shape": list(img.shape),
        "warm_incl_compile_s": round(warm_s, 1),
        "one_time_upload_s": round(upload_s, 1),
        "device": jax.devices()[0].device_kind,
        "stages": dec2.profiler.report(),
    }))


if __name__ == "__main__":
    main()
