#!/usr/bin/env python3
"""Phase-level profile of the device-resident NOAA decode on real hardware:
time each dispatch/download/host-walk of the warm decode separately.

    python examples/profile_noaa_resident.py [--lines N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def t(name, fn, reps=1):
    best = None
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    print(json.dumps({"phase": name, "seconds": round(best, 4)}), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lines", type=int, default=60)
    args = ap.parse_args()

    from apt_synth import synthesize
    import jax
    from directdemod_tpu import constants as K
    from directdemod_tpu.io.sources import DeviceRawSource
    from directdemod_tpu.models import apt
    from directdemod_tpu.models.noaa import (AM_BLOCK, NoaaDecoder,
                                             _apt_needles, _sync_cap,
                                             _resident_sync_kernel)
    from directdemod_tpu.models.frontend import DdcFm
    from directdemod_tpu.ops import design, iir
    from directdemod_tpu.utils import hostio

    iq, _ = synthesize(n_lines=args.lines, snr_db=18)
    raw_np = np.empty(2 * len(iq), dtype=np.uint8)
    raw_np[0::2] = np.round(iq.real + 127.5).astype(np.uint8)
    raw_np[1::2] = np.round(iq.imag + 127.5).astype(np.uint8)
    src = DeviceRawSource.from_host_bytes(raw_np, 2048000)

    # warm decode (compiles everything)
    dec = NoaaDecoder(src, offset=30000)
    t("warm_full_decode", lambda: (dec.useful, dec.get_image())[0])

    # phase timings on a fresh decoder (warm jits)
    dec2 = NoaaDecoder(src, offset=30000)
    fe = DdcFm(src.sampFreq, 30000.0, design.blackmanharris(151),
               K.NOAA_FMBW, fm=True)
    rate = fe.out_rate
    n_audio = fe.block_out_len(0, src.length) - 1
    needles = _apt_needles(rate)
    k = int(2 * (n_audio / rate)) + 2
    cap = _sync_cap(n_audio)
    raw = src.read_raw_device(0, src.length)
    jax.block_until_ready(raw)

    res = {}

    def sync_kernel():
        out = jax.block_until_ready(_resident_sync_kernel(
            fe, raw, needles, src.length, AM_BLOCK, k,
            float(K.NOAA_PEAKHEIGHTWIGGLE), cap))
        res["out"] = out
        return out

    t("resident_sync_kernel", sync_kernel, reps=2)
    audio, packed, cors, thr = res["out"]

    t("packed_download(%.2fMB)" % (packed.size * 4 / 1e6),
      lambda: hostio.device_get(packed))
    p = hostio.device_get(packed)

    t("crude_sync_post(host)",
      lambda: dec2._crude_sync_post(packed, cors, thr, rate, cap))
    sa, sb = dec2._crude_sync_post(packed, cors, thr, rate, cap)

    # image stage pieces
    bp = iir.IirFilter.design_butter(rate, 400, 4400, order=6,
                                     kind="bandpass")
    csync_a = np.asarray(sa, dtype=np.float64)
    csync_b = np.asarray(sb, dtype=np.float64)
    ucsync = csync_a.copy()
    csync_a = apt.fill_syncs(csync_a, n_audio)
    csync_b = apt.fill_syncs(csync_b, n_audio)
    if csync_b and csync_a and csync_b[0] < csync_a[0]:
        csync_b.pop(0)
    if csync_b and csync_a and csync_b[-1] < csync_a[-1]:
        csync_a.pop(-1)

    t("assemble_image(fused total)",
      lambda: apt.assemble_image(None, rate, csync_a, csync_b, ucsync,
                                 audio_dev=audio, bp=bp, am_block=AM_BLOCK),
      reps=2)

    # inside assemble: kernel dispatch+download vs host walk
    num_pixels = int(0.5 / K.NOAA_T)
    half = num_pixels // 2
    strip_len = int(len(K.NOAA_SYNCA) * K.NOAA_T * rate)
    n_lines = len(csync_a)
    spans_a, spans_b, keep = [], [], []
    for i in range(n_lines):
        sa_, sb_ = int(csync_a[i]), int(csync_b[i])
        ea, eb = sb_, sb_ + int(0.25 * rate)
        if i + 1 < n_lines:
            eb = int(csync_a[i + 1])
        if eb > n_audio or ea > n_audio or sa_ < 0 or sb_ < 0:
            continue
        keep.append(i)
        spans_a.append((sa_, ea))
        spans_b.append((sb_, eb))
    t("image_stage_fused(kernel+download)",
      lambda: apt._image_stage_fused(audio, bp, AM_BLOCK, strip_len,
                                     num_pixels, half, spans_a, spans_b),
      reps=2)
    probe, st_a, st_b, mats_a, mats_b = apt._image_stage_fused(
        audio, bp, AM_BLOCK, strip_len, num_pixels, half, spans_a, spans_b)
    t("calibration_walk(host)",
      lambda: apt._calibration_walk(probe, mats_a, mats_b, st_a, st_b,
                                    csync_a, ucsync, keep, num_pixels))


if __name__ == "__main__":
    main()
