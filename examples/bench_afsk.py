#!/usr/bin/env python3
"""AFSK1200/APRS decode benchmark on the default JAX device: the fused
single-dispatch pipeline on a device-resident raw-u8 capture, timed with
each lowering of the peak walk (`ops.peaks.walk_lowering`), vs the
reference's own decode_afsk1200 timed on the host (short capture,
per-sample extrapolation — its per-sample Python loops run minutes/minute).

    python examples/bench_afsk.py [--dur S] [--skip-ref]

Prints one JSON line.
"""
import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

PAYLOAD = "bench frame payload 0123456789"


def _wire(dur_s: float, n_frames_cap: int = 10_000):
    """Flag-delimited wire bits of as many identical frames as fit `dur_s`
    (~0.2 s of idle marks between frames); returns (wire, n_frames)."""
    from test_afsk1200 import make_ax25_frame, stuff_bits
    flags = [0, 1, 1, 1, 1, 1, 1, 0]
    one = stuff_bits(make_ax25_frame(info=PAYLOAD))
    gap = [1] * 240
    wire = flags * 3
    n_frames = 0
    while (len(wire) + 90 + len(one) + len(flags) * 6 + len(gap)) / 1200.0 \
            < dur_s and n_frames < n_frames_cap:
        wire += one + flags * 3 + gap + flags * 3
        n_frames += 1
    return wire, n_frames


def frame_count(dur_s: float) -> int:
    """Frames `_synth(dur_s, ...)` plants."""
    return _wire(dur_s)[1]


def _synth(dur_s: float, fs: int, offset_hz: float, n_frames_cap: int = 10_000):
    from test_afsk1200 import afsk_modulate
    wire, n_frames = _wire(dur_s, n_frames_cap)
    iq = afsk_modulate(wire, fs, offset_hz=offset_hz)
    rng = np.random.default_rng(5)
    iq = iq + 0.02 * (rng.standard_normal(len(iq))
                      + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    raw = np.empty(2 * len(iq), np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 127.5), 0, 255)
    return raw, n_frames, len(iq) / fs


def _reference_rt(fs: int, offset_hz: float, dur_s: float = 4.0):
    """Time the mounted reference's decode_afsk1200 on a short capture on
    this host; returns (real-time factor, measured seconds, capture s)."""
    import scipy
    import scipy.fftpack
    import scipy.signal
    import scipy.signal.windows as sw
    # compatibility aliases for the reference's old-scipy imports (shims to
    # RUN the mounted reference for a same-host baseline, nothing more)
    scipy.ifft = scipy.fftpack.ifft
    if not hasattr(np, "Inf"):
        np.Inf = np.inf
    for alias, val in (("int", int), ("float", float), ("bool", bool),
                       ("complex", complex), ("object", object)):
        if not hasattr(np, alias):
            setattr(np, alias, val)
    for name in ("blackmanharris", "hamming", "gaussian"):
        if not hasattr(scipy.signal, name):
            setattr(scipy.signal, name, getattr(sw, name))
    sys.path.insert(0, "/root/reference")
    from directdemod import source as ref_source
    from directdemod import decode_afsk1200 as ref_afsk

    raw, n_frames, cap_s = _synth(dur_s, fs, offset_hz)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ref.wav")
        with open(path, "wb") as f:
            data = raw.tobytes()
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, fs,
                                          fs * 2, 2, 8))
            f.write(b"data" + struct.pack("<I", len(data)) + data)
        src = ref_source.IQwav(path)
        t0 = time.perf_counter()
        dec = ref_afsk.decode_afsk1200(src, offset_hz, 22050)
        msg = dec.getMsg
        dt = time.perf_counter() - t0
    return cap_s / dt, dt, cap_s, int(dec.useful)


def _decode_seconds(src, offset, lowering: str, reps: int = 3):
    """Warm decode (compiles), then best-of-`reps` wall seconds, with the
    peak walk forced to `lowering`; returns (seconds, warm seconds,
    frames, useful)."""
    from unittest import mock

    import jax
    from directdemod_tpu.models.afsk1200 import Afsk1200Decoder
    from directdemod_tpu.ops import peaks

    jax.clear_caches()              # retrace under the forced lowering
    with mock.patch.object(peaks, "walk_lowering", lambda platform: lowering):
        t0 = time.perf_counter()
        Afsk1200Decoder(src, offset).get_frames()
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            dec = Afsk1200Decoder(src, offset)
            t0 = time.perf_counter()
            frames = dec.get_frames()
            times.append(time.perf_counter() - t0)
    return min(times), warm_s, frames, dec.useful


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--ref-dur", type=float, default=4.0)
    ap.add_argument("--skip-ref", action="store_true")
    args = ap.parse_args()

    import jax
    from directdemod_tpu.io.sources import DeviceRawSource
    from directdemod_tpu.ops import peaks

    fs, offset = 2048000, 12000
    raw, n_frames, cap_s = _synth(args.dur, fs, offset)
    dev = jax.devices()[0]
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
            if dev.platform == "gpu" else None)

    t0 = time.perf_counter()
    src = DeviceRawSource.from_host_bytes(raw, fs)
    jax.block_until_ready(src._raw)
    upload_s = time.perf_counter() - t0

    out = {"metric": "afsk_decode", "unit": "s",
           "device": dev.device_kind, "card": card,
           "capture_seconds": round(cap_s, 1),
           "capture_samples": len(raw) // 2,
           "frames_expected": n_frames,
           "one_time_upload_s": round(upload_s, 3)}
    default = peaks.walk_lowering(dev.platform)
    for lowering in dict.fromkeys((default, "scan")):
        dt, warm_s, frames, useful = _decode_seconds(src, offset, lowering)
        out[lowering] = {"wallclock_s": dt, "warm_incl_compile_s": warm_s,
                         "frames_decoded": len(frames), "useful": useful,
                         "realtime_factor": cap_s / dt}
    if not args.skip_ref:
        try:
            ref_rt, ref_dt, ref_cap, ref_useful = _reference_rt(
                fs, offset, args.ref_dur)
            out["reference_same_host"] = {
                "capture_seconds": round(ref_cap, 1),
                "wallclock_s": round(ref_dt, 2),
                "realtime_factor": round(ref_rt, 3),
                "useful": ref_useful,
            }
        except Exception as e:
            out["reference_error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(out))
    if any(out[lw]["frames_decoded"] != n_frames
           for lw in dict.fromkeys((default, "scan"))):
        sys.exit("not every planted frame decoded")


if __name__ == "__main__":
    main()
