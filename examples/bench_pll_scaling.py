#!/usr/bin/env python3
"""Single-chip scaling of the segment-parallel PLL scan: the funcube decoder
run sequentially vs n_segments in {2, 4, 8} on the same synthesized capture.

    python examples/bench_pll_scaling.py [--dur S]

Reports wall-clock per mode plus sync agreement vs the sequential result
(the segment-parallel mode is the approximate scaling strategy — per-segment
re-lock with a warmup halo, the same transient tolerance the reference
accepts at its own chunk boundaries; semantics of ref
decode_funcube.py:235-298)."""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dur", type=float, default=None)
    ap.add_argument("--host-source", action="store_true",
                    help="feed from host memory instead of HBM-resident "
                         "bytes (adds the upload to every timed run)")
    args = ap.parse_args()

    import numpy as np
    import jax
    from test_psk_sync import _bpsk_capture, FS
    from directdemod_tpu import constants as K
    from directdemod_tpu.io.sources import ArraySource, DeviceRawSource
    from directdemod_tpu.models.funcube import FuncubeDecoder

    spacing = K.FUNCUBE_FRAME_SPACING_S
    dur = args.dur or (2.0 + 5 * spacing + 1.2)
    frames = [2.0 + k * spacing for k in range(32)
              if 2.0 + k * spacing + 1.0 < dur]
    cap = _bpsk_capture(frames, dur_s=dur)
    dev = jax.devices()[0]

    if args.host_source:
        src = ArraySource(cap, FS)
        upload_s = None
    else:
        # uint8-quantize like a real SDR capture and park the bytes on the
        # device ONCE: the timed runs then measure the scan + pass-2
        # scaling, not the upload (a fixed, segment-count-independent cost)
        raw = np.empty(2 * len(cap), np.uint8)
        raw[0::2] = np.clip(np.round(cap.real + 127.5), 0, 255)
        raw[1::2] = np.clip(np.round(cap.imag + 127.5), 0, 255)
        t0 = time.perf_counter()
        src = DeviceRawSource.from_host_bytes(raw, FS)
        jax.block_until_ready(src._raw)
        upload_s = round(time.perf_counter() - t0, 3)

    results = {}
    base_syncs = None
    for n_seg in (1, 2, 4, 8, 16, 32, 64):
        dec = FuncubeDecoder(src, 5000,
                             n_segments=(n_seg if n_seg > 1 else None))
        t0 = time.perf_counter()
        syncs = dec.get_syncs()
        warm = time.perf_counter() - t0
        dec2 = FuncubeDecoder(src, 5000,
                              n_segments=(n_seg if n_seg > 1 else None))
        t0 = time.perf_counter()
        syncs = dec2.get_syncs()
        dt = time.perf_counter() - t0
        if n_seg == 1:
            base_syncs = np.asarray(syncs, dtype=np.float64)
        got = np.asarray(syncs, dtype=np.float64)
        agree = None
        if base_syncs is not None and len(base_syncs) and len(got):
            # fraction of sequential syncs matched within 2 samples
            hits = sum(1 for s in base_syncs
                       if np.min(np.abs(got - s)) <= 2.0)
            agree = round(hits / len(base_syncs), 3)
        results[f"n{n_seg}"] = {
            "wallclock_s": round(dt, 3),
            "warm_s": round(warm, 3),
            "n_syncs": len(syncs),
            "useful": dec2.useful,
            "sync_agreement_vs_sequential": agree,
            "speedup_vs_sequential": None,
        }
    seq = results["n1"]["wallclock_s"]
    for key, r in results.items():
        r["speedup_vs_sequential"] = round(seq / r["wallclock_s"], 2)

    print(json.dumps({
        "metric": "pll_segment_scaling",
        "unit": "s",
        "device": dev.device_kind,
        "capture_seconds": round(dur, 1),
        "capture_samples": len(cap),
        "source": "host" if args.host_source else "device-resident",
        "one_time_upload_s": upload_s,
        **results,
    }))


if __name__ == "__main__":
    main()
