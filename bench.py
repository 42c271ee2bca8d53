#!/usr/bin/env python3
"""Front-end benchmark: IQ Msamples/s through the fused DDC+FM chain on one
device, for each raw-byte lowering.

Measures the fused front end (offsetFreq -> blackman-harris(151) ->
decimate-by-34 -> polar discriminator; the chain of ref decode_noaa.py:623 /
decode_fm.py:64-68) in steady state on device-resident 20M-sample blocks
(constants.PROC_CHUNKSIZE): the byte-GEMM (`gemm_u8`, ops/ddc_conv) and the
XLA polyphase conv on the unpacked block (`xla`, ops/fir). Each is timed
with `block_until_ready`, best of several runs after a warm-up.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": ..., "card": ..., ...}
where `value` is the lowering `frontend_lowering` picks on this platform.
Exits non-zero when the measurement fails; it never reports a number it did
not measure in this run.
"""
import json
import subprocess
import sys
import time

import numpy as np


def _card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _best_seconds(fn, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())                      # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def frontend_msamps(block: int = 20_000_000) -> dict:
    """Msamples/s of one steady-state raw block through each lowering."""
    import jax
    import jax.numpy as jnp
    from directdemod_tpu.models.frontend import DdcFm
    from directdemod_tpu.ops import design, fir, unpack
    from directdemod_tpu.ops.ddc_conv import byte_plan, ddc_fm_bytes

    fe = DdcFm(2048000, 30000, design.blackmanharris(151), 60000, fm=True)
    J, k = fe.stride, len(fe.taps)
    out_len = (block - k) // J + 1
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.integers(0, 256, 2 * block, dtype=np.uint8))
    rot = np.complex64(fe.rot)
    cp = jnp.ones(1, jnp.complex64)
    plan = byte_plan(fe.taps_mod[::-1], J)
    tm = jnp.asarray(fe.taps_mod, jnp.complex64)

    @jax.jit
    def gemm(r, c_prev):
        return ddc_fm_bytes(plan, r, rot, c_prev, out_len)[0]

    @jax.jit
    def xla(r, c_prev):
        x = unpack.iq_u8_to_complex(r, jnp.float32)
        c = fir.conv_valid(x, tm[::-1], stride=J)
        prev = jnp.concatenate([c_prev, c[:-1]])
        return jnp.angle(c * jnp.conj(prev) * rot)

    return {name: block / _best_seconds(lambda f=f: f(raw, cp)) / 1e6
            for name, f in (("gemm_u8", gemm), ("xla", xla))}


def main() -> int:
    import jax
    from directdemod_tpu.models.frontend import frontend_lowering

    dev = jax.devices()[0]
    rates = frontend_msamps()
    chosen = frontend_lowering(dev.platform, raw=True)
    print(json.dumps({
        "metric": "frontend_throughput",
        "value": rates[chosen],
        "unit": "Msamples/s",
        "lowering": chosen,
        "device": dev.device_kind,
        "platform": dev.platform,
        "card": _card(),
        "measures": "device-resident 20M-sample raw blocks, steady state, "
                    "fused unpack+DDC+FM, best of 5 with block_until_ready",
        "msamples_per_s": rates,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
