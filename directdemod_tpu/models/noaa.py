"""NOAA APT decoder.

Behavioral reference: `decode_noaa` (ref decode_noaa.py:20-882): FM front-end
-> AM envelope -> normalized sync correlation -> usefulness test -> calibrated
image assembly -> accurate per-sync refinement, plus false-color and channel
IDs.

Device design:
  * front end = fused DdcFm (models/frontend.py) -- one strided conv per block;
  * AM + correlation = batched FFTs (ops/am, ops/correlate);
  * peak grouping / sync filling / calibration = sparse host walks;
  * accurate sync = one *batched* device pass over all +/-3-sync windows at
    full IQ rate (vmapped zero-phase filter -> FM -> Hilbert -> normalized
    correlation), replacing the reference's per-sync Python loop
    (ref decode_noaa.py:844-877).

Sampling-rate contract: the "40960 Hz" crude-sync request decays to the
emergent int-stride rate int(2048000/34) = 60235 Hz exactly as in the
reference (comm.bwLim integer arithmetic), and all sync indices live at that
rate.
"""
from __future__ import annotations

import logging
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as K
from ..ops import am as am_ops
from ..ops import correlate as corr_ops
from ..ops import design, fir, fm as fm_ops, iir, peaks, resample as rs
from ..utils import hostio
from ..utils.profiling import Profiler
from .frontend import DdcFm

log = logging.getLogger(__name__)

AM_BLOCK = 60000 * 4        # blockwise-Hilbert chunk (ref decode_noaa.py:647)


class NoaaDecoder:
    """Decode NOAA APT from an IQ source.

    Mirrors the reference surface: `useful`, `get_audio()`, `get_image()`,
    `image_a/image_b`, `get_color()`, `channel_id`, `get_crude_sync()`,
    `get_accurate_sync()`; all lazily cached like the reference's properties.
    """

    def __init__(self, sigsrc, offset: float, bw: int | None = None,
                 dtype=jnp.complex64, mesh=None):
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = int(bw) if bw else K.NOAA_FMBW
        self.dtype = dtype
        self.mesh = mesh             # optional: shard front-end + sync search
        self._audio = None           # (signal, rate) at crude-sync rate
        self._audio_strict = None    # (signal, rate) at NOAA_AUDSAMPRATE
        self._sync_a = None
        self._sync_b = None
        self._sync_rate = None
        self._useful = 0
        self._image = None
        self._color = None
        self._ch_id = (None, None)
        self._accurate = None
        self.profiler = Profiler()     # per-stage Msamples/s (utils.profiling)

    # ------------------------------------------------------------- front end
    def _fm_audio(self, target_rate: int, strict: bool,
                  device_out: bool = False):
        """The chunked FM chain (ref decode_noaa.py:600-629) via the fused
        DDC. strict=False leaves the emergent decimated rate; strict=True
        Fourier-resamples per block (ref comm.py:110-116 semantics)."""
        fe = DdcFm(self.src.sampFreq, self.offset,
                   design.blackmanharris(151), self.bw, fm=True)
        decim_rate = fe.out_rate
        # second bwLim: integer stride from the decimated rate
        j2 = int(decim_rate // target_rate) if not strict else 1
        out_rate = int(decim_rate / j2) if not strict else target_rate

        if (self.mesh is None and not strict and j2 == 1 and fe.fm
                and callable(getattr(self.src, "read_raw_device", None))):
            # device-resident capture: ONE dispatch for the whole front end
            # (XLA block 0 + one scanned chunk step over the remainder; see
            # DdcFm.resident_frontend). Same per-output window dots as the
            # blocked file-fed path below, without its per-block dispatches.
            n = self.src.length
            with self.profiler.stage("fm_frontend", n):
                raw = self.src.read_raw_device(0, n)
                audio = fe.resident_frontend(raw, n)
            return (audio if device_out
                    else hostio.device_get(audio)), out_rate

        if self.mesh is not None and not strict and j2 == 1:
            # chunk-parallel front end over the mesh's time axis. Without a
            # strict resample the chain is block-size-invariant (all carries
            # are exact), so pick blocks that keep every device busy.
            from ..parallel.sharded import ShardedDdcFm
            ndev = self.mesh.shape["time"]
            blk = int(min(K.PROC_CHUNKSIZE,
                          max(1 << 20, self.src.length // (2 * ndev))))
            with self.profiler.stage("fm_frontend", self.src.length):
                audio, _ = ShardedDdcFm(fe, self.mesh).process(
                    self.src, blk, dtype=self.dtype)
            return audio, out_rate

        # blocked loop for file-fed AND device-resident sources alike: the
        # feeder slices `read_raw_device` captures on device (no link
        # traffic), and DdcFmStream runs steady-state raw blocks through the
        # lowering `frontend_lowering` picks. One code path for both keeps
        # the two modes on the same window dots, and chunking
        # bounds HBM (a whole-capture dispatch would OOM multi-hour
        # captures: complex64 is 4x the raw bytes before conv transients).
        from ..io.feeder import BlockFeeder
        from .frontend import DdcFmStream
        stream = DdcFmStream(fe, dtype=self.dtype)
        outs = []
        off2 = 0
        with BlockFeeder(self.src, K.PROC_CHUNKSIZE, dtype=self.dtype,
                         raw="auto") as feeder:
            for (s, e, x) in feeder:
                with self.profiler.stage("fm_frontend", e - s):
                    y = stream.step(x, s)
                if strict:
                    num = int(target_rate * y.shape[0] / decim_rate)
                    y = rs.fft_resample(y, num)
                elif j2 > 1:
                    n_pre = int(y.shape[0])
                    cnt = rs.decim_count(n_pre, off2, j2)
                    y = rs.decimate(y, off2, j2, cnt)
                    off2 = (j2 - (n_pre - off2) % j2) % j2
                outs.append(y if device_out else np.asarray(y))
        if device_out:
            # audio stays resident in device memory: downstream envelope +
            # sync correlation consume it without a host transfer.
            return jnp.concatenate(outs), out_rate
        return np.concatenate(outs), out_rate

    def get_audio(self):
        """Audio at NOAA_AUDSAMPRATE (ref decode_noaa.py:85-96)."""
        if self._audio_strict is None:
            self._audio_strict = self._fm_audio(K.NOAA_AUDSAMPRATE, strict=True)
        return self._audio_strict

    # ------------------------------------------------------------- crude sync
    def _am_envelope(self, sig) -> jnp.ndarray:
        """Blockwise Hilbert envelope (ref decode_noaa.py:631-657); stays on
        device (a no-op when `sig` is already resident)."""
        return am_ops.envelope_blocked(
            jnp.asarray(sig, dtype=jnp.float32), AM_BLOCK)

    def _correlate_and_find(self, sig: np.ndarray, rate: int, sync_bits,
                            use_filter: bool = False,
                            norm: bool = True, pos_needle: bool = True):
        """Normalized correlation + adaptive peak grouping
        (ref decode_noaa.py:677-767)."""
        needle = corr_ops.apt_needle(sync_bits, rate, K.NOAA_T, pos_needle)
        x = jnp.asarray(sig, dtype=jnp.float32)
        if use_filter:
            x = fir.fir_zero_phase(x, design.hamming(492))
        nj = jnp.asarray(needle, dtype=jnp.float32)
        cor = (corr_ops.norm_correlate(x, nj) if norm
               else corr_ops.correlate_same(x, nj))
        return peaks.find_sync_peaks(cor, rate, len(needle),
                                     K.NOAA_PEAKHEIGHTWIGGLE,
                                     K.NOAA_MINPEAKDIST), np.asarray(cor)

    def get_crude_sync(self):
        """Sync locations at the crude rate (ref decode_noaa.py:769-806)."""
        if self._sync_a is None:
            fe = DdcFm(self.src.sampFreq, self.offset,
                       design.blackmanharris(151), self.bw, fm=True)
            if (self.mesh is None and fe.out_rate // K.NOAA_CRUDESYNCSAMPRATE <= 1
                    and callable(getattr(self.src, "read_raw_device", None))):
                # resident capture: front end + sync scan as ONE dispatch
                rate = fe.out_rate
                n_audio = fe.block_out_len(0, self.src.length) - 1
                needles = _apt_needles(rate)
                k = int(2 * (n_audio / rate)) + 2
                cap = _sync_cap(n_audio)
                with self.profiler.stage("frontend+sync", self.src.length):
                    raw = self.src.read_raw_device(0, self.src.length)
                    audio, packed, cors, thr = _resident_sync_kernel(
                        fe, raw, needles, self.src.length, AM_BLOCK, k,
                        float(K.NOAA_PEAKHEIGHTWIGGLE), cap)
                    self._sync_a, self._sync_b = self._crude_sync_post(
                        packed, cors, thr, rate, cap)
                self._audio = (audio, rate)
                self._sync_rate = rate
                self._useful = self._usefulness()
                return [self._sync_a, self._sync_b]
            audio, rate = self._fm_audio(K.NOAA_CRUDESYNCSAMPRATE,
                                         strict=False,
                                         device_out=self.mesh is None)
            self._audio = (audio, rate)
            self._sync_rate = rate
            n = int(audio.shape[0]) if hasattr(audio, "shape") else len(audio)
            log.info("NOAA crude sync: correlating %d samples at %d Hz",
                     n, rate)
            with self.profiler.stage("sync_correlate", 2 * n):
                if self.mesh is not None:
                    from ..parallel.correlate import sharded_find_sync_peaks
                    env = np.asarray(self._am_envelope(audio))
                    self._sync_a = sharded_find_sync_peaks(
                        self.mesh, env,
                        corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True),
                        rate, K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
                    self._sync_b = sharded_find_sync_peaks(
                        self.mesh, env,
                        corr_ops.apt_needle(K.NOAA_SYNCB, rate, K.NOAA_T, True),
                        rate, K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
                else:
                    self._sync_a, self._sync_b = self._crude_sync_fused(
                        audio, rate)
            self._useful = self._usefulness()
        return [self._sync_a, self._sync_b]

    def _crude_sync_fused(self, audio, rate: int):
        """Single-dispatch crude-sync scan: blocked envelope + fused A/B
        normalized correlation + adaptive thresholds + candidate counts run
        as ONE jitted program (the dense part of ref decode_noaa.py:769-806).

        The unfused form was ~30 eager dispatches; the fused form is one
        program plus three small downloads."""
        n = int(audio.shape[0]) if hasattr(audio, "shape") else len(audio)
        needles = _apt_needles(rate)
        k = int(2 * (n / rate)) + 2
        cap = _sync_cap(n)
        packed, cors, thr = _crude_sync_kernel(
            jnp.asarray(audio, dtype=jnp.float32), needles, AM_BLOCK, k,
            float(K.NOAA_PEAKHEIGHTWIGGLE), cap)
        return self._crude_sync_post(packed, cors, thr, rate, cap)

    def _crude_sync_post(self, packed, cors, thr, rate: int, cap: int):
        """Host side of the crude-sync scan: unpack the ONE download,
        group peaks, handle slot overflow via the exact fallback."""
        na_len = len(corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True))
        p = hostio.device_get(packed)              # the stage's ONE download
        idx_np = (p[:, :cap, 0].astype(np.int64) * 4096
                  + p[:, :cap, 1].astype(np.int64))
        vals_np = p[:, :cap, 2]
        counts_np = (p[:, cap, 0].astype(np.int64) * 4096
                     + p[:, cap, 1].astype(np.int64))
        out = []
        for row in range(2):
            total = int(counts_np[row])
            if total > cap:
                # slots overflowed (threshold collapse / extreme sync
                # density): exact unbounded fallback on the same cors row
                log.warning("sync candidate slots bound (%d > %d); "
                            "falling back to exact extraction",
                            total, cap)
                cand_i, cand_v = peaks.candidates_above(cors[row], thr[row])
            else:
                keep = idx_np[row] >= 0
                cand_i, cand_v = idx_np[row][keep], vals_np[row][keep]
            grouped = peaks.group_peaks(cand_i, cand_v,
                                        K.NOAA_MINPEAKDIST * rate)
            out.append(np.sort(grouped - na_len // 2)
                       if len(grouped) else np.empty(0, dtype=np.int64))
        return out[0], out[1]

    def _usefulness(self) -> int:
        """10 consecutive syncs spaced 0.5 s within 5 samples
        (ref decode_noaa.py:793-804)."""
        for syncs in (self._sync_a, self._sync_b):
            d = np.abs(np.diff(syncs) - self._sync_rate * 0.5)
            w = K.NOAA_DETECTCONSSYNCSNUM
            if len(d) >= w:
                wins = np.lib.stride_tricks.sliding_window_view(d, w)
                if np.min(np.max(wins, axis=-1)) < K.NOAA_DETECTMAXCHANGE:
                    return 1
        return 0

    @property
    def useful(self) -> int:
        if self._sync_a is None:
            self.get_crude_sync()
        return self._useful

    # ------------------------------------------------------------- image
    def get_image(self) -> np.ndarray:
        """Calibrated APT image (ref decode_noaa.py:255-465)."""
        if self._image is None:
            from . import apt
            self.get_crude_sync()
            audio, rate = self._audio
            bp = iir.IirFilter.design_butter(rate, 400, 4400, order=6,
                                             kind="bandpass")
            if self.mesh is not None:
                # exact sharded filtfilt + block-parallel envelope: with the
                # sharded front end and sync search above, no device stage of
                # the image path is sequential (the calibration walk in
                # apt.assemble_image is host-side O(lines))
                from ..parallel.am import sharded_envelope_blocked
                from ..parallel.iir import sharded_zero_phase
                filtered = sharded_zero_phase(
                    self.mesh, bp, np.asarray(audio, dtype=np.float32))
                env = sharded_envelope_blocked(self.mesh, filtered, AM_BLOCK)
                env_dev = None
            else:
                # the bandpass/envelope/probe/strip preamble fuses into ONE
                # dispatch inside apt.assemble_image (audio_dev form); the
                # envelope never crosses the link
                env = None
                env_dev = None

            n_env = len(env) if env is not None else int(audio.shape[0])
            csync_a = np.asarray(self._sync_a, dtype=np.float64) \
                / self._sync_rate * rate
            csync_b = np.asarray(self._sync_b, dtype=np.float64) \
                / self._sync_rate * rate
            ucsync = csync_a.copy()
            csync_a = apt.fill_syncs(csync_a, n_env)
            csync_b = apt.fill_syncs(csync_b, n_env)

            # channel A first, pairwise (ref decode_noaa.py:294-303)
            if csync_b and csync_a and csync_b[0] < csync_a[0]:
                csync_b.pop(0)
            if csync_b and csync_a and csync_b[-1] < csync_a[-1]:
                csync_a.pop(-1)
            if len(csync_a) != len(csync_b):
                log.error("sync A/B count mismatch; deriving B from A")
                csync_b = list(np.asarray(csync_a) + int(0.25 * rate))

            if env is None:
                img, ida, idb = apt.assemble_image(
                    None, rate, csync_a, csync_b, ucsync,
                    audio_dev=audio, bp=bp, am_block=AM_BLOCK)
            else:
                img, ida, idb = apt.assemble_image(env, rate, csync_a,
                                                   csync_b, ucsync,
                                                   am_dev=env_dev)
            self._image = img
            self._ch_id = (ida, idb)
        return self._image

    @property
    def channel_id(self):
        if self._image is None:
            self.get_image()
        return list(self._ch_id)

    @property
    def image_a(self) -> np.ndarray:
        return self.get_image()[:, :1040]

    @property
    def image_b(self) -> np.ndarray:
        return self.get_image()[:, 1040:]

    def get_color(self) -> np.ndarray:
        """False-color composite from channels A+B (ref decode_noaa.py:536-598),
        vectorized HSV mapping."""
        if self._color is None:
            from .falsecolor import false_color
            self._color = false_color(self.image_a, self.image_b)
        return self._color

    # ------------------------------------------------------------- accurate sync
    def get_accurate_sync(self, use_norm_correlate: bool = True):
        """Sub-window sync refinement at full IQ rate
        (ref decode_noaa.py:808-880), batched on device.

        Returns [asyncA, diff(asyncA), qualityA, timeA,
                 asyncB, diff(asyncB), qualityB, timeB].
        """
        if self._accurate is not None and self._accurate[0] == use_norm_correlate:
            return self._accurate[1]
        self.get_crude_sync()
        fs = self.src.sampFreq
        sync_time = K.NOAA_T * len(K.NOAA_SYNCA)
        width = int(3 * sync_time * fs)

        # the min-distance grouping degenerates to one group per window
        # whenever the group distance exceeds the window, making the whole
        # per-window walk a batched argmax reduction (_accurate_fast_kernel)
        fast = (self.mesh is None
                and K.NOAA_MINPEAKDIST * fs >= 2 * width)
        resident = callable(getattr(self.src, "read_raw_device", None))
        raw_dev = (self.src.read_raw_device(0, self.src.length)
                   if fast and resident else None)

        per_needle = []
        for bits, syncs in ((K.NOAA_SYNCA, self._sync_a),
                            (K.NOAA_SYNCB, self._sync_b)):
            centers = np.asarray(syncs, dtype=np.float64) / self._sync_rate * fs
            starts = []
            for c in centers:
                s, e = int(c) - width, int(c) + width
                if s < 0 or e > self.src.length:
                    continue
                starts.append(s)
            needle = corr_ops.apt_needle(bits, fs, K.NOAA_T,
                                         positive=use_norm_correlate)
            per_needle.append((starts, needle))

        if (fast and raw_dev is not None
                and any(st for st, _ in per_needle)):
            # all-windows path: one dispatch + one packed download PER
            # NEEDLE (2 dispatches for the whole stage)
            group = 64
            results = []
            for st, needle in per_needle:
                if not st:
                    results.append(([], [], []))
                    continue
                n_g = -(-len(st) // group)
                st_pad = (st + [st[0]] * (n_g * group - len(st)))
                arr = np.asarray(st_pad, np.int64)
                hl = np.stack([(arr // 4096).astype(np.float32),
                               (arr % 4096).astype(np.float32)])
                mets = hostio.device_get(_accurate_fast_resident_all(
                    raw_dev, jnp.asarray(hl),
                    jnp.asarray(needle, jnp.float32), 2 * width, group,
                    (self.offset, float(fs)), use_norm_correlate,
                    len(needle), float(K.NOAA_PEAKHEIGHTWIGGLE)))
                det, quals, tsyncs = [], [], []
                flat = mets.reshape(-1, 6)[: len(st)]
                for row, s0 in zip(flat, st):
                    has, hi, lo, q, ts, ts_ok = row
                    if has < 0.5:
                        continue
                    det.append(int(hi) * 4096 + int(lo) + s0)
                    quals.append(float(q))
                    tsyncs.append(float(ts) if ts_ok > 0.5 else None)
                results.append((det, quals, tsyncs))
            return self._finish_accurate(results, fs, use_norm_correlate)

        results = []
        for (starts, needle), (bits, syncs) in zip(
                per_needle, ((K.NOAA_SYNCA, self._sync_a),
                             (K.NOAA_SYNCB, self._sync_b))):
            if not starts:
                results.append(([], [], []))
                continue
            nj = jnp.asarray(needle, dtype=jnp.float32)
            ln = len(needle)

            if fast:
                # device windows (resident: gathered from HBM bytes) +
                # one reduction dispatch + one tiny download per group
                det, quals, tsyncs = [], [], []
                for g0 in range(0, len(starts), 64):
                    gs = starts[g0:g0 + 64]
                    nw = len(gs)
                    # fixed 64-row batches: one jit shape, and BIT-identical
                    # to the resident all-windows path (_accurate_fast_
                    # resident_all scans fixed-64 groups; batch shape
                    # changes perturb XLA's FFT factorization rounding
                    # enough to move a flat argmax by a sample)
                    bucket = 64
                    gs_pad = gs + [gs[0]] * (bucket - nw)
                    if raw_dev is not None:
                        hl = np.asarray(gs_pad, np.int64)
                        hl = jnp.asarray(np.stack(
                            [(hl // 4096).astype(np.float32),
                             (hl % 4096).astype(np.float32)]))
                        batch = _gather_iq_windows(raw_dev, hl, 2 * width)
                    else:
                        rows = np.stack([self.src.read(s0, s0 + 2 * width)
                                         for s0 in gs_pad])
                        batch = hostio.device_put(rows, dtype=self.dtype)
                    met = hostio.device_get(_accurate_fast_kernel(
                        batch, nj, (self.offset, float(fs)),
                        use_norm_correlate, ln,
                        float(K.NOAA_PEAKHEIGHTWIGGLE)))
                    for row in range(nw):
                        has, hi, lo, q, ts, ts_ok = met[row]
                        if has < 0.5:
                            continue
                        det.append(int(hi) * 4096 + int(lo) + gs[row])
                        quals.append(float(q))
                        tsyncs.append(float(ts) if ts_ok > 0.5 else None)
                results.append((det, quals, tsyncs))
                continue

            wins = [self.src.read(s0, s0 + 2 * width) for s0 in starts]
            env_rows, cor_rows = [], []
            if self.mesh is not None:
                # windows are independent: shard the batch axis over `time`
                from jax.sharding import NamedSharding, PartitionSpec as P
                ndev = self.mesh.shape["time"]
                group = 64 * ndev
                for g0 in range(0, len(wins), group):
                    rows = np.stack(wins[g0:g0 + group])
                    nw = rows.shape[0]
                    pad = (-nw) % ndev
                    if pad:    # repeated rows (not zeros: NaN via norm), dropped
                        rows = np.concatenate(
                            [rows, np.repeat(rows[:1], pad, 0)])
                    batch = hostio.device_put(
                        rows, dtype=self.dtype,
                        sharding=NamedSharding(self.mesh, P("time", None)))
                    env, cor = _accurate_windows_sharded(
                        self.mesh, batch, nj, (self.offset, float(fs)),
                        use_norm_correlate)
                    env_rows.append(hostio.global_get(env)[:nw])
                    cor_rows.append(hostio.global_get(cor)[:nw])
            else:
                # group-batched so arbitrarily long captures stay within HBM;
                # ragged last groups pad up to a power-of-two row count so
                # the jit cache holds O(log) shapes, not one per capture
                # length (shape audit, round 4)
                for g0 in range(0, len(wins), 64):
                    rows = np.stack(wins[g0:g0 + 64])
                    nw = rows.shape[0]
                    bucket = 1 << (nw - 1).bit_length()
                    if bucket > nw:     # repeated rows, dropped after
                        rows = np.concatenate(
                            [rows, np.repeat(rows[:1], bucket - nw, 0)])
                    batch = hostio.device_put(rows, dtype=self.dtype)
                    env, cor = _accurate_windows_batch(
                        batch, nj, (self.offset, float(fs)),
                        use_norm_correlate)
                    env_rows.append(np.asarray(env)[:nw])
                    cor_rows.append(np.asarray(cor)[:nw])
            env_np = np.concatenate(env_rows)
            cor_np = np.concatenate(cor_rows)

            det, quals, tsyncs = [], [], []
            for row, s0 in enumerate(starts):
                pk = peaks.host_find_sync_peaks(cor_np[row], fs, ln,
                                                K.NOAA_PEAKHEIGHTWIGGLE,
                                                K.NOAA_MINPEAKDIST)
                if len(pk) == 0:
                    continue
                p = int(pk[0])
                det.append(p + s0)
                quals.append(float(cor_np[row][p + ln // 2]))
                if p + 2 * ln < env_np.shape[1]:
                    tsyncs.append(float(np.mean(env_np[row][p + ln:p + 2 * ln])))
                else:
                    tsyncs.append(None)
            results.append((det, quals, tsyncs))

        return self._finish_accurate(results, fs, use_norm_correlate)

    def _finish_accurate(self, results, fs, use_norm_correlate):
        (da, qa, ta), (db, qb, tb) = results
        out = [da, list(np.diff(da)), qa, ta, db, list(np.diff(db)), qb, tb]
        self._accurate = (use_norm_correlate, out)
        return out


def _apt_needles(rate: int) -> jnp.ndarray:
    """(2, L) A/B sync needle stack at `rate` (ref decode_noaa.py:690-694)."""
    na = corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    nb = corr_ops.apt_needle(K.NOAA_SYNCB, rate, K.NOAA_T, True)
    return jnp.asarray(np.stack([na, nb]), dtype=jnp.float32)


@partial(jax.jit, static_argnums=(0, 3, 4, 5, 6, 7))
def _resident_sync_kernel(fe, raw, needles, n: int, block: int, k: int,
                          wiggle: float, cap: int):
    """Device-resident capture: fused front end (DdcFm.resident_frontend)
    AND the whole crude-sync scan in ONE dispatch; the audio stays resident
    for the image stage. Returns (audio, packed, cors, thr)."""
    audio = fe.resident_frontend(raw, n)
    packed, cors, thr = _crude_sync_kernel(audio, needles, block, k,
                                           wiggle, cap)
    return audio, packed, cors, thr


def _sync_cap(n: int) -> int:
    """In-kernel candidate slots per needle. Each sync peak raises a plateau
    of ~100 above-threshold samples (measured ~n/300 candidates on clean
    captures), so n//64 leaves ~4x margin while keeping the packed download
    ~1 MB at bench scale. Short/noisy captures overflow routinely (the
    adaptive threshold collapses); the host checks `counts` and falls back
    to the exact unbounded path then (regression-tested:
    test_crude_sync_overflow_fallback)."""
    return min(n, max(4096, n // 64))


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _crude_sync_kernel(audio, needles, block: int, k: int, wiggle: float,
                       cap: int):
    """Envelope -> fused A/B correlation -> adaptive thresholds -> compacted
    candidates, all in one compiled program (NoaaDecoder._crude_sync_fused).

    Candidates come back pre-compacted to `cap` fixed slots so the host
    needs no count round-trip (and no fresh compile per dynamic size)."""
    env = am_ops.envelope_blocked(audio, block)
    # overlap-save batched form: blocks of one FFT length instead of one
    # multi-million-point 1-D FFT
    cors = corr_ops.norm_correlate_multi_blocked(env, needles)
    top = peaks.top_k_exact(cors, k)
    bot = -peaks.top_k_exact(-cors, k)
    avg_top = jnp.mean(top, axis=-1)
    avg_bot = jnp.mean(bot, axis=-1)
    thr = avg_top - wiggle * (avg_top - avg_bot)
    mask = cors > thr[:, None]
    counts = jnp.sum(mask.astype(jnp.int32), axis=-1)
    idx = jax.vmap(lambda m: jnp.nonzero(m, size=cap, fill_value=-1)[0])(mask)
    vals = jnp.take_along_axis(cors, jnp.maximum(idx, 0), axis=-1)
    # single-download packing: indices ride as exact (hi, lo) f32 halves
    # (any int32: v = hi*4096 + lo), counts in an extra slot row, so the
    # whole stage returns ONE f32 tensor
    hi = jnp.floor_divide(idx, 4096).astype(jnp.float32)
    lo = jnp.remainder(idx, 4096).astype(jnp.float32)
    packed = jnp.stack([hi, lo, vals], axis=-1)            # (2, cap, 3)
    crow = jnp.zeros((2, 1, 3), jnp.float32) \
        .at[:, 0, 0].set(jnp.floor_divide(counts, 4096).astype(jnp.float32)) \
        .at[:, 0, 1].set(jnp.remainder(counts, 4096).astype(jnp.float32))
    packed = jnp.concatenate([packed, crow], axis=1)       # (2, cap+1, 3)
    return packed, cors, thr


@jax.jit
def _accurate_window_envelope(batch, offset, fs):
    """Per-window chain at full rate (ref decode_noaa.py:852): NCO (window-
    local phase, matching the chunker-less commSignal) -> zero-phase
    blackman-harris -> FM -> Hilbert envelope."""
    n = batch.shape[1]
    ph = (-2.0 * np.pi * offset / fs) * jnp.arange(n, dtype=jnp.float32)
    osc = jnp.exp(1j * ph).astype(batch.dtype)
    mixed = batch * osc[None, :]
    taps = design.blackmanharris(151)

    def one(row):
        f = fir.fir_zero_phase(row, taps)
        d, _ = fm_ops.quad_demod(f, None)
        return am_ops.envelope(d)

    return jax.vmap(one)(mixed)


@partial(jax.jit, static_argnums=(2,))
def _gather_iq_windows(raw, starts_hl, n_win: int):
    """Gather fixed-width IQ windows straight from device-resident capture
    bytes (no host transfer per window): (rows, n_win) complex. Starts
    are SAMPLE indices as exact (hi, lo) f32 pairs; the gather runs on a
    (n, 2) byte view so the index stays a sample count — a byte offset
    (2x) would overflow int32 past 2^30 samples (~8.7 min), and 10-minute
    passes are in scope."""
    from ..ops import unpack
    starts = (starts_hl[0].astype(jnp.int32) * 4096
              + starts_hl[1].astype(jnp.int32))
    pairs = raw.reshape(-1, 2)
    rows = jax.vmap(lambda s0: jax.lax.dynamic_slice(
        pairs, (s0, jnp.int32(0)), (n_win, 2)))(starts)
    rows = rows.reshape(rows.shape[0], 2 * n_win)   # row-major: interleaved
    return unpack.iq_u8_to_complex(rows, jnp.float32)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _accurate_fast_kernel(batch, nj, offset_fs: tuple, use_norm: bool,
                          ln: int, wiggle: float):
    """The whole per-window accurate-sync reduction in one dispatch.

    Valid whenever NOAA_MINPEAKDIST * fs >= window length (true for the
    reference constants: 0.45 s * 2.048 MHz = 921600 >> the 118k window):
    the min-distance grouping then degenerates to one group per window, so
    find_sync_peaks(cor_row)[0] == argmax(cor_row) - ln//2 exactly, the
    quality sample cor[p + ln//2] is the max itself, and the "time sync"
    is a windowed mean of the envelope. Returns (rows, 6) f32:
    [has_peak, p_hi, p_lo, quality, tsync_mean, tsync_valid]."""
    return _accurate_fast_core(batch, nj, offset_fs, use_norm, ln, wiggle)


def _accurate_fast_core(batch, nj, offset_fs: tuple, use_norm: bool,
                        ln: int, wiggle: float):
    env, cor = _accurate_windows_batch(batch, nj, offset_fs, use_norm)
    n = cor.shape[1]
    fs = offset_fs[1]
    k = int(2 * (n / fs)) + 2
    top = jax.lax.top_k(cor, k)[0]
    bot = -jax.lax.top_k(-cor, k)[0]
    avg_t = jnp.sum(top, axis=-1) / k
    avg_b = jnp.sum(bot, axis=-1) / k
    thr = avg_t - wiggle * (avg_t - avg_b)
    mx = jnp.max(cor, axis=-1)
    am = jnp.argmax(cor, axis=-1).astype(jnp.int32)
    p = am - ln // 2
    ts_start = jnp.clip(p + ln, 0, n - ln)
    ts = jax.vmap(lambda e, s0: jnp.mean(
        jax.lax.dynamic_slice(e, (s0,), (ln,))))(env, ts_start)
    hi = jnp.floor_divide(p, 4096).astype(jnp.float32)
    lo = jnp.remainder(p, 4096).astype(jnp.float32)
    return jnp.stack([(mx > thr).astype(jnp.float32), hi, lo, mx, ts,
                      ((p + 2 * ln) < n).astype(jnp.float32)], axis=-1)


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _accurate_fast_resident_all(raw, starts_hl, nj, n_win: int, group: int,
                                offset_fs: tuple, use_norm: bool, ln: int,
                                wiggle: float):
    """EVERY accurate-sync window of one needle in ONE dispatch with ONE
    packed download (the fast path used to issue one dispatch and one
    download per 64-window group; a long pass has hundreds of syncs).
    Groups of `group` windows gather from the resident capture bytes
    inside a lax.scan (bounding peak HBM to one group's windows), the
    per-window reduction is _accurate_fast_core, and the
    (n_groups, group, 6) metrics tensor is the only transfer — the stage
    costs 2 dispatches total (one per needle).

    starts_hl: (2, n_groups*group) f32 — exact (hi, lo) sample-index
    halves, padded with repeats."""
    # dense (rows, 128) byte view — a true bitcast. The (n, 2) pair view
    # _gather_iq_windows uses is fine when XLA fuses it into a single
    # gather, but materialized across a scan boundary it takes a 64x
    # lane-padded layout (a 5-min capture tried to allocate 78 GB).
    rows_need = -(-(2 * n_win) // 128) + 2
    raw2 = jnp.pad(raw, (0, (-raw.shape[0]) % 128 + rows_need * 128)) \
        .reshape(-1, 128)
    sh = jnp.moveaxis(starts_hl.reshape(2, -1, group), 1, 0)

    def gather_one(s0):
        # sample s0 -> byte 128*(s0//64) + 2*(s0%64), two-level to stay
        # inside int32 on multi-GB captures
        q = s0 // 64
        r = 2 * (s0 % 64)
        block = jax.lax.dynamic_slice(
            raw2, (q, jnp.int32(0)), (rows_need, 128)).reshape(-1)
        return jax.lax.dynamic_slice(block, (r,), (2 * n_win,))

    from ..ops import unpack

    def step(_, hl):
        starts = (hl[0].astype(jnp.int32) * 4096
                  + hl[1].astype(jnp.int32))
        win_bytes = jax.vmap(gather_one)(starts)
        batch = unpack.iq_u8_to_complex(win_bytes, jnp.float32)
        met = _accurate_fast_core(batch, nj, offset_fs, use_norm,
                                  ln, wiggle)
        return 0, met

    _, mets = jax.lax.scan(step, 0, sh)
    return mets


@partial(jax.jit, static_argnums=(2, 3))
def _accurate_windows_batch(batch, nj, offset_fs: tuple, use_norm: bool):
    """envelope + hamming zero-phase + correlation for a window batch
    (ref decode_noaa.py:844-877, batched)."""
    offset, fs = offset_fs
    env = _accurate_window_envelope(batch, offset, fs)
    filt = jax.vmap(lambda r: fir.fir_zero_phase(r, design.hamming(492)))(env)
    corr_fn = (corr_ops.norm_correlate if use_norm
               else corr_ops.correlate_same)
    cor = jax.vmap(lambda r: corr_fn(r, nj))(filt)
    return env, cor


@partial(jax.jit, static_argnums=(0, 3, 4))
def _accurate_windows_sharded(mesh, batch, nj, offset_fs: tuple,
                              use_norm: bool):
    """_accurate_windows_batch with the window-batch axis sharded over the
    mesh's `time` axis (windows are independent; no collectives)."""
    from jax.sharding import PartitionSpec as P

    def body(b, n):
        return _accurate_windows_batch(b, n, offset_fs, use_norm)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("time", None), P(None)),
        out_specs=(P("time", None), P("time", None)))(batch, nj)
