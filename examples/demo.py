#!/usr/bin/env python3
"""One-command demo: synthesize captures for every decoder and run the full
CLI on them. Outputs land in ./demo_output.

    python examples/demo.py [--mesh N]
"""
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def write_wav(path, iq, fs, scale=90.0):
    u8 = np.empty(2 * len(iq), np.uint8)
    u8[0::2] = np.clip(np.round(iq.real * scale + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(iq.imag * scale + 127.5), 0, 255).astype(np.uint8)
    payload = u8.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 2, fs, fs * 2, 2, 8))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def main():
    mesh = []
    if "--mesh" in sys.argv:
        mesh = [f"--mesh={sys.argv[sys.argv.index('--mesh') + 1]}"]
    if "--cpu" in sys.argv:
        # run on host CPU: functional checks shouldn't grab a shared GPU
        # (env vars alone don't override the accelerator plugin)
        import jax
        jax.config.update("jax_platforms", "cpu")

    from apt_synth import synthesize, FS
    from test_afsk1200 import make_ax25_frame, stuff_bits, afsk_modulate
    from directdemod_tpu import cli

    out = os.path.abspath("demo_output")
    os.makedirs(out, exist_ok=True)
    os.chdir(out)

    print("=== NOAA APT ===")
    iq, _ = synthesize(n_lines=14, snr_db=18)
    wav = "SDRSharp_20260817_000000Z_137590000Hz_IQ.wav"
    write_wav(wav, iq, FS, scale=1.0)
    cli.main(mesh + ["-ce", "-f", "137620000", "-d", "noaa", "-o", "noaa",
                     "-r", "noaa_report.json", wav])

    print("=== AFSK1200 / APRS ===")
    flags = [0, 1, 1, 1, 1, 1, 1, 0]
    wire = flags * 3 + stuff_bits(make_ax25_frame(info="demo: aprs!")) + flags * 3
    iq2 = afsk_modulate(wire, FS, offset_hz=30000)
    wav2 = "SDRSharp_20260817_000001Z_145795000Hz_IQ.wav"
    write_wav(wav2, iq2, FS)
    cli.main(["-ce", "-f", "145825000", "-d", "afsk1200",
              "-r", "aprs_report.json", wav2])

    print("=== Funcube BPSK ===")
    from test_psk_sync import _bpsk_capture
    from directdemod_tpu import constants as K
    sp = K.FUNCUBE_FRAME_SPACING_S
    iq3 = _bpsk_capture([1.0, 1.0 + sp], dur_s=1.0 + sp + 1.0, offset_hz=30000,
                        carrier_err=100.0)
    wav3 = "SDRSharp_20260817_000002Z_145935000Hz_IQ.wav"
    write_wav(wav3, iq3, FS, scale=1.0)
    cli.main(["-ce", "-f", "145965000", "-d", "funcube", "-o", "funcube",
              "-r", "funcube_report.json", wav3])

    print("=== outputs ===")
    for f in sorted(os.listdir(".")):
        print(" ", f, os.path.getsize(f), "bytes")


if __name__ == "__main__":
    main()
