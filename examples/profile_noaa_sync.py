#!/usr/bin/env python3
"""Profile the NOAA crude-sync + image-stage sub-ops on the default device.

Times each candidate bottleneck of `_crude_sync_kernel` / `_filt_env_kernel`
separately (warm, post-compile) so the round-4 perf work targets the real
cost, not a guess. Prints one JSON line per measurement.

    python examples/profile_noaa_sync.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
from jax import lax

from directdemod_tpu.models.noaa import AM_BLOCK, _crude_sync_kernel, _sync_cap
from directdemod_tpu.ops import am as am_ops
from directdemod_tpu.ops import correlate as corr_ops
from directdemod_tpu.ops import iir, peaks
from directdemod_tpu import constants as K
from directdemod_tpu.utils import hostio

N = 3_644_234          # envelope length of the 60-line bench capture
RATE = 60235


def bench(name, fn, reps=3):
    fn()                               # warm (compile)
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / reps
    print(json.dumps({"op": name, "seconds": round(dt, 4)}), flush=True)
    return dt


def main():
    rng = np.random.default_rng(0)
    audio_np = rng.standard_normal(N).astype(np.float32)
    audio = hostio.device_put(audio_np)
    jax.block_until_ready(audio)

    na = corr_ops.apt_needle(K.NOAA_SYNCA, RATE, K.NOAA_T, True)
    nb = corr_ops.apt_needle(K.NOAA_SYNCB, RATE, K.NOAA_T, True)
    needles = jnp.asarray(np.stack([na, nb]), dtype=jnp.float32)
    jax.block_until_ready(needles)
    k = int(2 * (N / RATE)) + 2
    cap = _sync_cap(N)
    print(json.dumps({"n": N, "k": k, "cap": cap,
                      "needle_len": len(na)}), flush=True)

    # 1. the full fused kernel (device only, no download)
    f_full = jax.jit(lambda a: _crude_sync_kernel(
        a, needles, AM_BLOCK, k, float(K.NOAA_PEAKHEIGHTWIGGLE), cap))
    bench("crude_sync_kernel(all)", lambda: f_full(audio))

    # 2. download of the packed result
    packed = f_full(audio)[0]
    jax.block_until_ready(packed)
    bench("download_packed(%.1fMB)" % (packed.size * 4 / 1e6),
          lambda: hostio.device_get(packed), reps=2)

    # 3. envelope alone
    f_env = jax.jit(lambda a: am_ops.envelope_blocked(a, AM_BLOCK))
    bench("envelope_blocked", lambda: f_env(audio))

    env = f_env(audio)
    jax.block_until_ready(env)

    # 4. the fused A/B normalized correlation (one big rfft)
    f_corr = jax.jit(lambda e: corr_ops.norm_correlate_multi(e, needles))
    bench("norm_correlate_multi", lambda: f_corr(env))

    cors = f_corr(env)
    jax.block_until_ready(cors)

    # 5. top-k thresholds
    def f_thr(c):
        top = peaks.top_k_exact(c, k)
        bot = -peaks.top_k_exact(-c, k)
        return jnp.mean(top, axis=-1), jnp.mean(bot, axis=-1)
    f_thr_j = jax.jit(f_thr)
    bench("top_k_exact x2", lambda: f_thr_j(cors))

    at, ab = f_thr_j(cors)
    thr = at - K.NOAA_PEAKHEIGHTWIGGLE * (at - ab)
    jax.block_until_ready(thr)

    # 6. the vmapped nonzero compaction at the current cap
    def f_nz(c, t):
        mask = c > t[:, None]
        idx = jax.vmap(lambda m: jnp.nonzero(m, size=cap,
                                             fill_value=-1)[0])(mask)
        vals = jnp.take_along_axis(c, jnp.maximum(idx, 0), axis=-1)
        return idx, vals
    f_nz_j = jax.jit(f_nz)
    bench("nonzero_compact(cap=%d)" % cap, lambda: f_nz_j(cors, thr))

    # 6b. nonzero at a much smaller cap
    small = 16384
    def f_nz_s(c, t):
        mask = c > t[:, None]
        idx = jax.vmap(lambda m: jnp.nonzero(m, size=small,
                                             fill_value=-1)[0])(mask)
        vals = jnp.take_along_axis(c, jnp.maximum(idx, 0), axis=-1)
        return idx, vals
    bench("nonzero_compact(cap=%d)" % small, lambda: jax.jit(f_nz_s)(cors, thr))

    # 6c. sort-free compaction via two-stage top_k over an index-encoding key
    def f_tk(c, t):
        mask = c > t[:, None]
        n = c.shape[-1]
        key = jnp.where(mask, (jnp.float32(n) - jnp.arange(n, jnp.float32)),
                        jnp.float32(-1.0))
        vals = peaks.top_k_exact(key, small)
        return vals
    try:
        bench("topk_compact(cap=%d)" % small, lambda: jax.jit(f_tk)(cors, thr))
    except Exception as e:
        print(json.dumps({"op": "topk_compact", "error": str(e)[:200]}),
              flush=True)

    # 7. count-only reduce + scalar download
    f_cnt = jax.jit(lambda c, t: jnp.sum((c > t[:, None]).astype(jnp.int32),
                                         axis=-1))
    cnt = f_cnt(cors, thr)
    jax.block_until_ready(cnt)
    bench("count+download", lambda: hostio.device_get(f_cnt(cors, thr)))

    # 8. image stage: zero-phase bandpass + blocked envelope
    bp = iir.IirFilter.design_butter(RATE, 400, 4400, order=6,
                                     kind="bandpass")
    f_img = jax.jit(lambda a: am_ops.envelope_blocked(bp.zero_phase(a),
                                                      AM_BLOCK))
    bench("filt_env_kernel", lambda: f_img(audio))
    env2 = f_img(audio)
    jax.block_until_ready(env2)

    # 9. download of the full envelope (the image stage's host copy)
    bench("download_env(%.1fMB)" % (env2.size * 4 / 1e6),
          lambda: hostio.device_get(env2), reps=2)

    # 10. alternative correlation: direct conv via conv_general_dilated
    w = needles[:, ::-1]

    def f_conv(e):
        x4 = e[None, None, :]
        k4 = w[:, None, :]                       # (2, 1, L) OIW
        out = lax.conv_general_dilated(
            x4, k4, window_strides=(1,),
            padding=[(len(na) // 2, len(na) - 1 - len(na) // 2)],
            dimension_numbers=("NCH", "OIH", "NCH"))
        return out[0]
    try:
        bench("direct_conv_560tap", lambda: jax.jit(f_conv)(env))
    except Exception as e:
        print(json.dumps({"op": "direct_conv", "error": str(e)[:200]}),
              flush=True)

    # 11. overlap-save batched-FFT correlation
    def f_olap(e):
        L = len(na)
        blk = 1 << 17
        halo = 1 << 10                           # >= L
        nb_ = -(-N // blk)
        total = nb_ * blk + halo
        ep = jnp.pad(e, (0, total - N))
        frames = jax.vmap(
            lambda i: lax.dynamic_slice(ep, (i * blk,), (blk + halo,)))(
                jnp.arange(nb_))
        m = blk + halo
        X = jnp.fft.rfft(frames, n=m)
        W = jnp.fft.rfft(w, n=m)
        full = jnp.fft.irfft(X[:, None, :] * W[None, :, :], n=m)
        seg = full[:, :, L - 1 - L // 2: L - 1 - L // 2 + blk]
        return jnp.moveaxis(seg, 1, 0).reshape(2, nb_ * blk)[:, :N]
    bench("overlap_save_corr", lambda: jax.jit(f_olap)(env))

    # check parity of overlap-save vs the giant-FFT version
    alt = np.asarray(jax.jit(f_olap)(env))
    ref_c = np.asarray(corr_ops.correlate_same(env, needles[0]))
    err = float(np.max(np.abs(alt[0] - ref_c)))
    print(json.dumps({"op": "overlap_save_err", "max_abs_err": err}),
          flush=True)

    # 12. moving energy via cumsum vs fft
    f_me = jax.jit(lambda e: corr_ops.moving_energy(e, len(na)))
    bench("moving_energy_fft", lambda: f_me(env))

    def f_me_cs(e):
        cs = jnp.cumsum((e * e).astype(jnp.float64))
        L = len(na)
        lo = L // 2 + 1
        cs = jnp.pad(cs, (lo, L))
        upper = lax.dynamic_slice(cs, (L,), (N,))
        return (upper - cs[:N]).astype(jnp.float32)
    bench("moving_energy_cumsum", lambda: jax.jit(f_me_cs)(env))


if __name__ == "__main__":
    main()
