#!/usr/bin/env python3
"""End-to-end NOAA APT decode wall-clock: this framework on the default JAX
device vs the reference implementation (ref decode_noaa.py:20-882) on the
host, on the same synthetic capture.

    python examples/bench_noaa_e2e.py [--lines N] [--skip-reference]

The decode runs in ONE worker subprocess, the only process that opens the
device; the parent synthesizes, runs the reference on the host and fails
loudly when the worker fails.

Prints one JSON line:
  {"metric": "noaa_e2e_wallclock", "value": <seconds>, "unit": "s", ...}
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


class ArraySource:
    """In-memory IQ source with the reference source ABC surface
    (ref source.py:18-47)."""
    sourceType = -1

    def __init__(self, iq, fs):
        self._iq = np.asarray(iq, dtype=np.complex64)
        self.sampFreq = fs
        self.length = len(self._iq)

    def read(self, i, j):
        return self._iq[i:j]


def worker(iq_path: str) -> None:
    """One decode on the default JAX device; prints JSON.

    Times TWO modes on the same capture:
      * feed-inclusive — file bytes -> raw-u8 upload -> device unpack ->
        image (the production cold path);
      * device-resident — the raw bytes already in device memory
        (io.sources.DeviceRawSource), measuring decode compute + dispatch
        only, which is what a production host link (GB/s) would see."""
    import logging

    import jax
    from directdemod_tpu.io.sources import DeviceRawSource, IQDat
    from directdemod_tpu.models.noaa import NoaaDecoder

    # shape audit: count every jit trace/compile the cold decode triggers
    jax.config.update("jax_log_compiles", True)
    compile_count = {"n": 0}

    class _CompileCounter(logging.Handler):
        def emit(self, record):
            if "Compiling" in record.getMessage():
                compile_count["n"] += 1
    logging.getLogger("jax._src.interpreters.pxla").addHandler(
        _CompileCounter())
    logging.getLogger("jax._src.dispatch").addHandler(_CompileCounter())

    fs = 2048000
    src = IQDat(iq_path + ".dat", fs)

    def decode(source):
        dec = NoaaDecoder(source, offset=30000)
        useful = dec.useful
        img = dec.get_image()
        return useful, img, dec

    t0 = time.perf_counter()
    decode(src)              # full-capture warm-up: compiles every jit shape
    warm = time.perf_counter() - t0   # the timed runs below hit them warm
    cold_compiles = compile_count["n"]

    t0 = time.perf_counter()
    useful, img, dec = decode(src)
    dt = time.perf_counter() - t0

    src_dev = DeviceRawSource.from_file(iq_path + ".dat", fs)
    decode(src_dev)                    # warm the resident-path jit shapes
    t0 = time.perf_counter()
    useful_r, img_r, dec_r = decode(src_dev)
    dt_res = time.perf_counter() - t0

    import jax
    np.save(iq_path + ".img.npy", img)
    print(json.dumps({
        "wallclock_s": round(dt, 3),
        "useful": useful,
        "image_shape": list(img.shape),
        "resident_wallclock_s": round(dt_res, 3),
        # strict equality plus the matching-pixel fraction: the two paths
        # chunk the capture at different boundaries, so a last-ulp
        # difference can flip isolated uint8 pixels at quantization
        # boundaries without any decode divergence
        "resident_image_equal": bool(np.array_equal(img, img_r)),
        "resident_image_pixel_match": (
            round(float(np.mean(img == img_r)), 6)
            if img.shape == img_r.shape else 0.0),
        "resident_stages": dec_r.profiler.report(),
        "warmup_incl_compile_s": round(warm, 1),
        "cold_decode_jit_compiles": cold_compiles,
        "total_jit_compiles": compile_count["n"],
        "stages": dec.profiler.report(),
        "device": jax.devices()[0].device_kind,
    }))


def run_reference(iq, fs):
    sys.path.insert(0, "/root/reference")
    # the 2018-era reference targets scipy 1.0 / numpy 1.14; alias moved
    # symbols (same shims as tests/test_reference_parity.py)
    import scipy
    import scipy.signal as ss
    for name in ("hamming", "blackmanharris", "gaussian"):
        if not hasattr(ss, name):
            setattr(ss, name, getattr(ss.windows, name))
    if not hasattr(scipy, "ifft"):
        scipy.ifft = scipy.fft.ifft
    if not hasattr(np, "Inf"):
        np.Inf = np.inf
    if not hasattr(np, "int"):
        np.int = int
    from directdemod import decode_noaa

    class RefSource(ArraySource):
        sourceType = 0

    dec = decode_noaa.decode_noaa(RefSource(iq, fs), 30000)
    t0 = time.perf_counter()
    useful = dec.useful
    img = dec.getImage
    dt = time.perf_counter() - t0
    return dt, useful, np.asarray(img)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lines", type=int, default=60)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--worker", type=str, default=None)
    args = ap.parse_args()

    if args.worker:
        worker(args.worker)
        return

    from apt_synth import synthesize, FS
    iq, _ = synthesize(n_lines=args.lines, snr_db=18)
    capture_s = len(iq) / FS

    with tempfile.TemporaryDirectory() as td:
        iq_path = os.path.join(td, "capture.npy")
        np.save(iq_path, iq.astype(np.complex64))
        # interleaved-uint8 .dat for the production file->image path; the
        # synth already quantized, so real/imag + 127.5 are exact bytes
        raw = np.empty(2 * len(iq), dtype=np.uint8)
        raw[0::2] = np.round(iq.real + 127.5).astype(np.uint8)
        raw[1::2] = np.round(iq.imag + 127.5).astype(np.uint8)
        raw.tofile(iq_path + ".dat")

        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", iq_path],
            capture_output=True, text=True, timeout=1800,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            sys.stderr.write(p.stderr[-4000:] + "\n")
            sys.exit(f"decode worker failed (exit {p.returncode})")
        res = json.loads(lines[-1])
        img = np.load(iq_path + ".img.npy")

    out = {"metric": "noaa_e2e_wallclock", "value": res.pop("wallclock_s"),
           "unit": "s", "capture_seconds": round(capture_s, 1),
           "capture_samples": len(iq),
           "realtime_factor": None, **res}
    out["realtime_factor"] = round(capture_s / out["value"], 1)
    if res.get("resident_wallclock_s"):
        out["resident_realtime_factor"] = round(
            capture_s / res["resident_wallclock_s"], 1)

    if not args.skip_reference:
        try:
            rdt, ruseful, rimg = run_reference(iq, FS)
            out["reference_wallclock_s"] = round(rdt, 3)
            out["reference_useful"] = ruseful
            out["vs_baseline"] = round(rdt / out["value"], 1)
            rows = min(img.shape[0], rimg.shape[0])
            if rows and img.shape[1] == rimg.shape[1]:
                a = img[:rows].astype(np.float64)
                b = rimg[:rows].astype(np.float64)
                cors = [np.corrcoef(a[r], b[r])[0, 1] for r in range(rows)
                        if a[r].std() > 0 and b[r].std() > 0]
                if cors:
                    out["image_row_corr_vs_reference"] = round(
                        float(np.median(cors)), 4)
        except Exception as e:      # keep the device result if the A/B dies
            out["reference_error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
