"""Peak detection and grouping for sync search.

Behavioral references:
  * APT sync peak selection (ref decode_noaa.py:712-751): top-k based adaptive
    threshold, then min-distance grouping keeping the max of each group.
  * `peakdetect` lookahead max/min alternation (ref peakdetect.py:141-254,
    the vendored billauer algorithm; only this entry point is used in-tree,
    by decode_afsk1200.py:170).

Device does the dense work (correlation, thresholds, rolling-window maxima);
the inherently sequential grouping walks run on the host over the *sparse*
candidate lists, which are thousands of elements, not tens of millions.
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..utils import hostio

log = logging.getLogger(__name__)

# Compacted-candidate cap: a healthy APT sync correlation yields ~2 candidates
# per second of capture, so 2^18 covers ~36 h; the cap binding means the
# adaptive threshold collapsed (e.g. pure noise) and candidates were DROPPED.
CANDIDATE_CAP = 1 << 18


def top_k_exact(x: jnp.ndarray, k: int, block: int = 4096) -> jnp.ndarray:
    """Exact top-k values of the last axis, two-stage.

    `lax.top_k` over a multi-million-element axis lowers to one enormous
    sort; splitting into `block`-wide rows, taking
    per-row top-k (batched small sorts), and reducing the k*rows survivors
    is exact — the global top-k is a subset of the per-block top-k — and
    orders of magnitude faster. Falls back to plain top_k for short inputs."""
    n = x.shape[-1]
    if n <= 4 * block or k >= block:
        return lax.top_k(x, k)[0]
    nb = n // block
    head = x[..., : nb * block].reshape(x.shape[:-1] + (nb, block))
    cand = lax.top_k(head, k)[0].reshape(x.shape[:-1] + (nb * k,))
    tail = x[..., nb * block:]
    if tail.shape[-1]:
        cand = jnp.concatenate([cand, tail], axis=-1)
    return lax.top_k(cand, k)[0]


def adaptive_threshold(cor: jnp.ndarray, samp_rate: float,
                       wiggle: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's peak-height floor (ref decode_noaa.py:713-723):
    mean of the top-k values, pulled down by `wiggle` times the top-to-bottom
    spread, with k = int(2 * duration_seconds) + 2. Returns (threshold, k)."""
    n = cor.shape[0]
    k = int(2 * (n / samp_rate)) + 2
    top = top_k_exact(cor, k)
    bot = -top_k_exact(-cor, k)
    avg_top = jnp.sum(top) / k
    avg_bot = jnp.sum(bot) / k
    return avg_top - wiggle * (avg_top - avg_bot), k


def candidates_above(cor: jnp.ndarray, threshold: jnp.ndarray,
                     cap: int = CANDIDATE_CAP) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (index, value) pairs where cor > threshold, in index order.

    The mask reduction runs on device; indices come back compacted to at most
    `cap` entries (a 2-per-second sync signal leaves candidates sparse). When
    the cap binds — a noise capture whose adaptive threshold collapsed — the
    tail of the candidate list is dropped and a warning is logged."""
    n = cor.shape[0]
    cap = min(cap, n)
    mask = cor > threshold
    # count first (one scalar down), then compact to the next power of two
    # >= count: a healthy capture downloads ~64 candidates, not the full cap
    # buffer (2^18 entries)
    total = int(hostio.device_get(jnp.sum(mask.astype(jnp.int32))))
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0)
    if total > cap:
        log.warning(
            "sync candidate cap bound: %d above-threshold samples, "
            "keeping the first %d — threshold likely collapsed "
            "(noise-only capture?)", total, cap)
    size = min(cap, 1 << (min(total, cap) - 1).bit_length())
    idx = jnp.nonzero(mask, size=size, fill_value=-1)[0]
    # gather the values with the indices still on device: no int re-upload,
    # one f32 download (fill slots gather cor[-1], dropped by the mask below)
    vals_dev = cor[idx]
    idx_np = hostio.device_get(idx)
    vals_np = hostio.device_get(vals_dev)
    keep = idx_np >= 0
    return idx_np[keep], vals_np[keep]


def group_peaks(indices: np.ndarray, values: np.ndarray,
                min_dist: float) -> np.ndarray:
    """Min-distance grouping keeping the maximum of each run
    (ref decode_noaa.py:731-746). Host walk over the sparse candidate list."""
    best_idx = None
    best_val = None
    out = []
    for i, v in zip(indices, values):
        if best_idx is not None and (i - best_idx) >= min_dist:
            out.append(best_idx)
            best_idx, best_val = None, None
        if best_val is None or best_val < v:
            best_idx, best_val = i, v
    out.append(best_idx)
    return np.sort(np.asarray([o for o in out if o is not None]))


def find_sync_peaks(cor: jnp.ndarray, samp_rate: float, needle_len: int,
                    wiggle: float, min_dist_s: float) -> np.ndarray:
    """Full APT peak pipeline; returns sync *start* indices
    (peak centers shifted back by needle_len//2, ref decode_noaa.py:749)."""
    thr, _ = adaptive_threshold(cor, samp_rate, wiggle)
    idx, vals = candidates_above(cor, thr)
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    peaks = group_peaks(idx, vals, min_dist_s * samp_rate)
    return np.sort(peaks - needle_len // 2)


def host_find_sync_peaks(cor: np.ndarray, samp_rate: float, needle_len: int,
                         wiggle: float, min_dist_s: float) -> np.ndarray:
    """find_sync_peaks computed entirely on the HOST for an already-downloaded
    correlation row (the accurate-sync walk iterates many short windows,
    each too small to be worth a device dispatch).
    Identical semantics: exact top-k adaptive threshold, candidates in index
    order, min-distance grouping."""
    cor = np.asarray(cor)
    n = len(cor)
    k = int(2 * (n / samp_rate)) + 2
    if k >= n:
        top = np.sort(cor)[::-1][:k]
        bot = np.sort(cor)[:k]
    else:
        top = np.partition(cor, n - k)[n - k:]
        bot = np.partition(cor, k - 1)[:k]
    avg_top = float(np.sum(top) / k)
    avg_bot = float(np.sum(bot) / k)
    thr = avg_top - wiggle * (avg_top - avg_bot)
    idx = np.flatnonzero(cor > thr)
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    grouped = group_peaks(idx, cor[idx], min_dist_s * samp_rate)
    return np.sort(grouped - needle_len // 2)


# --------------------------------------------------------------------- lookahead peaks

@jax.jit
def _lookahead_scan(y, fwd_max, fwd_min, delta):
    """Exact device replay of the alternating max/min walk
    (ref peakdetect.py:196-241). Emits per-index fire events."""
    idx = jnp.arange(y.shape[0], dtype=jnp.int32)

    def body(carry, inp):
        mx, mn, mxpos, mnpos = carry
        yi, fmax, fmin, i = inp
        upd_mx = yi > mx
        mx = jnp.where(upd_mx, yi, mx)
        mxpos = jnp.where(upd_mx, i, mxpos)
        upd_mn = yi < mn
        mn = jnp.where(upd_mn, yi, mn)
        mnpos = jnp.where(upd_mn, i, mnpos)

        fire_max = (yi < mx - delta) & jnp.isfinite(mx) & (fmax < mx)
        # on a max fire the reference `continue`s past the min branch
        fire_min = (~fire_max) & (yi > mn + delta) & jnp.isfinite(mn) & (fmin > mn)

        out = (fire_max, mxpos, mx, fire_min, mnpos, mn)
        mx2 = jnp.where(fire_max, jnp.inf, jnp.where(fire_min, -jnp.inf, mx))
        mn2 = jnp.where(fire_max, jnp.inf, jnp.where(fire_min, -jnp.inf, mn))
        return (mx2, mn2, mxpos, mnpos), out

    init = (jnp.float32(-jnp.inf).astype(y.dtype),
            jnp.float32(jnp.inf).astype(y.dtype),
            jnp.int32(0), jnp.int32(0))
    _, outs = lax.scan(body, init, (y, fwd_max, fwd_min, idx))
    return outs


def _forward_window_extrema(y: jnp.ndarray, w: int):
    """fwd_max[i] = max(y[i:i+w]), fwd_min[i] = min(y[i:i+w]) for the valid
    range i < len(y)-w+1 (the walk never consults beyond it)."""
    mx = lax.reduce_window(y, -jnp.inf, lax.max, (w,), (1,), "VALID")
    mn = lax.reduce_window(y, jnp.inf, lax.min, (w,), (1,), "VALID")
    return mx, mn


# ------------------------------------------------------ GPU walk kernel
def walk_lowering(platform: str) -> str:
    """The peak walk's lowering for a JAX platform: one Pallas Triton
    program on a CUDA GPU ('triton'), the plain `lax.scan` on the CPU
    ('scan'). Every caller of the walk goes through this choice; a
    platform with neither is an error, not a silent fallback."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "scan"
    raise ValueError(f"no peak-walk lowering for platform {platform!r}")


def _walk_kernel(y_ref, fmax_ref, fmin_ref, delta_ref, zeros_ref, out_ref):
    """The whole alternating max/min walk in ONE Triton program.

    The walk is a per-sample recurrence. As a `lax.scan` every sample is a
    while-loop trip (at least one kernel launch on a GPU); here the state
    (mx, mn, mxpos, mnpos, event count) stays in registers while y and its
    forward-window extrema stream through once. Fires are written straight
    into their compacted slot of the packed record (`lookahead_events_packed`
    format), so no XLA compaction follows. `out_ref` aliases a zeroed
    buffer (`zeros_ref`): unused rows stay zero, as in the scan path."""
    del zeros_ref
    n = y_ref.shape[0]
    cap = (out_ref.shape[0] - 1) // 5
    delta = delta_ref[0]

    def body(i, carry):
        mx, mn, mxpos, mnpos, cnt = carry
        yi = y_ref[i]
        upd_mx = yi > mx
        mx = jnp.where(upd_mx, yi, mx)
        mxpos = jnp.where(upd_mx, i, mxpos)
        upd_mn = yi < mn
        mn = jnp.where(upd_mn, yi, mn)
        mnpos = jnp.where(upd_mn, i, mnpos)
        fire_max = (yi < mx - delta) & jnp.isfinite(mx) & (fmax_ref[i] < mx)
        fire_min = ((~fire_max) & (yi > mn + delta) & jnp.isfinite(mn)
                    & (fmin_ref[i] > mn))
        fire = fire_max | fire_min
        tag = lax.select(fire_max, jnp.float32(32768.0), jnp.float32(0.0))

        @pl.when(fire & (cnt < cap))
        def _():
            # lax.div/rem: indices are non-negative, and the Triton lowering
            # takes the truncating forms (jnp's floor forms add sign fixups)
            base = 5 * cnt
            pos = jnp.where(fire_max, mxpos, mnpos)
            q = jnp.int32(4096)
            out_ref[base] = tag + lax.div(i, q).astype(jnp.float32)
            out_ref[base + 1] = lax.rem(i, q).astype(jnp.float32)
            out_ref[base + 2] = lax.div(pos, q).astype(jnp.float32)
            out_ref[base + 3] = lax.rem(pos, q).astype(jnp.float32)
            out_ref[base + 4] = jnp.where(fire_max, mx, mn)

        mx2 = jnp.where(fire_max, jnp.inf, jnp.where(fire_min, -jnp.inf, mx))
        mn2 = jnp.where(fire_max, jnp.inf, jnp.where(fire_min, -jnp.inf, mn))
        return mx2, mn2, mxpos, mnpos, cnt + fire.astype(jnp.int32)

    init = (jnp.float32(-jnp.inf), jnp.float32(jnp.inf),
            jnp.int32(0), jnp.int32(0), jnp.int32(0))
    *_, cnt = lax.fori_loop(jnp.int32(0), jnp.int32(n), body, init)
    out_ref[5 * cap] = cnt.astype(jnp.float32)


@partial(jax.jit, static_argnums=(1, 3, 4))
def _lookahead_events_triton(y, lookahead: int, delta, cap: int,
                             interpret: bool = False):
    """lookahead_events_packed through the Triton walk kernel (f32);
    `interpret` runs the kernel in the Pallas interpreter (tests only)."""
    limit = y.shape[0] - lookahead
    fwd_max, fwd_min = _forward_window_extrema(y, lookahead)

    def f32(a):
        return a[:limit].astype(jnp.float32)

    size = 5 * cap + 1
    return pl.pallas_call(
        _walk_kernel,
        out_shape=jax.ShapeDtypeStruct((size,), jnp.float32),
        input_output_aliases={4: 0},
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lookahead_walk",
    )(f32(y), f32(fwd_max), f32(fwd_min),
      jnp.asarray(delta, jnp.float32).reshape(1),
      jnp.zeros((size,), jnp.float32))


@partial(jax.jit, static_argnums=(1, 3))
def _lookahead_events_scan(y, lookahead: int, delta, cap: int):
    """lookahead_events_packed through the plain `lax.scan` walk and an XLA
    compaction of its per-index fire events."""
    n = y.shape[0]
    limit = n - lookahead
    fwd_max, fwd_min = _forward_window_extrema(y, lookahead)
    outs = _lookahead_scan(y[:limit], fwd_max[:limit], fwd_min[:limit],
                           jnp.asarray(delta, dtype=y.dtype))
    f_max, mxpos, mxval, f_min, mnpos, mnval = outs
    fire = f_max | f_min
    csum = jnp.cumsum(fire.astype(jnp.int32))
    cnt = csum[-1]
    idx = jnp.arange(limit, dtype=jnp.int32)
    pos = jnp.where(f_max, mxpos, mnpos)
    val = jnp.where(f_max, mxval, mnval).astype(jnp.float32)
    rows = jnp.stack([
        f_max.astype(jnp.float32) * 32768.0
        + jnp.floor_divide(idx, 4096).astype(jnp.float32),
        jnp.remainder(idx, 4096).astype(jnp.float32),
        jnp.floor_divide(pos, 4096).astype(jnp.float32),
        jnp.remainder(pos, 4096).astype(jnp.float32),
        val], axis=-1)
    tgt = jnp.where(fire, csum - 1, cap)
    packed = jnp.zeros((cap, 5), jnp.float32).at[tgt].set(rows, mode="drop")
    return jnp.concatenate([packed.reshape(-1),
                            cnt.astype(jnp.float32)[None]])


def lookahead_events_packed(y, lookahead: int, delta, cap: int):
    """Device side of `lookahead_peaks` with the fire events COMPACTED on
    device: one (cap, 5) f32 tensor [is_max*2^15 + i_hi, i_lo, pos_hi,
    pos_lo, value] in index order plus the total count appended, instead of
    six full-length downloads. Jittable, so it fuses into a caller's
    single-dispatch pipeline. Counts beyond `cap` are dropped (the caller
    checks the count and asks again with a larger cap).

    The walk's lowering is `walk_lowering` of the default backend."""
    y = jnp.asarray(y)
    if walk_lowering(jax.default_backend()) == "triton":
        return _lookahead_events_triton(y, lookahead, delta, cap)
    return _lookahead_events_scan(y, lookahead, delta, cap)


def unpack_lookahead_events(flat: np.ndarray, lookahead: int, n: int,
                            cap: int):
    """Host inverse of lookahead_events_packed -> (max_peaks, min_peaks)
    [index, value] lists, replaying the reference's first-hit pop and
    end-of-signal break (ref peakdetect.py:196-254). Returns None when the
    event record overflowed `cap`."""
    cnt = int(flat[-1])
    if cnt > cap:
        return None
    ev = flat[:-1].reshape(cap, 5)[:cnt]
    col0 = ev[:, 0].astype(np.int64)
    is_max = col0 >= 32768
    i_arr = (col0 % 32768) * 4096 + ev[:, 1].astype(np.int64)
    pos_arr = ev[:, 2].astype(np.int64) * 4096 + ev[:, 3].astype(np.int64)
    max_peaks, min_peaks = [], []
    for k in range(cnt):
        if is_max[k]:
            max_peaks.append([int(pos_arr[k]), float(ev[k, 4])])
        else:
            min_peaks.append([int(pos_arr[k]), float(ev[k, 4])])
        if i_arr[k] + lookahead >= n:    # reference breaks after this append
            break
    if max_peaks or min_peaks:
        first_is_max = bool(is_max[0]) if cnt else False
        if cnt:
            if first_is_max:
                max_peaks.pop(0)
            else:
                min_peaks.pop(0)
    return max_peaks, min_peaks


def lookahead_peaks(y, lookahead: int, delta: float = 0.0
                    ) -> tuple[list, list]:
    """Alternating max/min peak picking with lookahead confirmation, matching
    `peakdetect` (ref peakdetect.py:141-254; the only variant used in-tree,
    by decode_afsk1200.py:170). Returns (max_peaks, min_peaks) as
    [index, value] pairs.

    Fire events compact ON DEVICE and only the sparse event record
    downloads. When the record overflows its cap the walk runs again with
    one slot per index, which cannot overflow."""
    y = jnp.asarray(y)
    n = int(y.shape[0])
    if lookahead < 1:
        raise ValueError("lookahead must be >= 1")
    if n <= lookahead:
        return [], []
    limit = n - lookahead          # reference iterates y[:-lookahead]

    def walk(cap):
        flat = hostio.device_get(lookahead_events_packed(
            y, lookahead, float(delta), cap))
        return unpack_lookahead_events(flat, lookahead, n, cap)

    got = walk(min(limit, 1 << 18))
    # overflow: every index fires at most once, so `limit` slots suffice
    return got if got is not None else walk(limit)


def _lookahead_peaks_dense(y, lookahead: int, delta: float
                           ) -> tuple[list, list]:
    """Plain reference of the walk: the `lax.scan` fire events downloaded
    in full and replayed on the host (tests and chip_smoke.py compare the
    packed walk with it)."""
    n = int(y.shape[0])
    fwd_max, fwd_min = _forward_window_extrema(y, lookahead)
    limit = n - lookahead
    outs = _lookahead_scan(y[:limit], fwd_max[:limit], fwd_min[:limit],
                           jnp.asarray(delta, dtype=y.dtype))
    f_max, mxpos, mxval, f_min, mnpos, mnval = (
        hostio.device_get(o) for o in outs)

    events = []
    for i in np.flatnonzero(f_max | f_min):
        if f_max[i]:
            events.append((i, True, int(mxpos[i]), float(mxval[i])))
        else:
            events.append((i, False, int(mnpos[i]), float(mnval[i])))
        if i + lookahead >= n:      # reference breaks after this append
            break

    max_peaks = [[p, v] for (_, is_max, p, v) in events if is_max]
    min_peaks = [[p, v] for (_, is_max, p, v) in events if not is_max]
    if events:
        if events[0][1]:
            max_peaks.pop(0)
        else:
            min_peaks.pop(0)
    return max_peaks, min_peaks
