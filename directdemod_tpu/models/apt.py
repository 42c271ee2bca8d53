"""APT image-line assembly and radiometric calibration.

Behavioral reference: the image stage of `decode_noaa.getImage`
(ref decode_noaa.py:255-508): sync filling, per-line Fourier resample to a
multiple of 1040 pixels, median pixel estimation, the 8-step calibration-wedge
state machine (slope/intercept via linear regression), telemetry channel-ID
readout, and uint8 quantization with a backup image when calibration never
locks.

Device split: per-line resample+median is the bulk work -- lines are grouped by
length and batched through one FFT resample per group on device. The
calibration walk is O(lines) host work by construction (FIFO medians over a
few hundred scalars per line).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .. import constants as K
from ..ops import am as am_ops
from ..ops import resample as rs
from ..utils import hostio


# ------------------------------------------------------------------ sync filling

def fill_syncs(csync, max_len) -> list:
    """Filter outlier syncs and synthesize missed ones (ref
    decode_noaa.py:467-508): keep pairs spaced within 200 samples of the modal
    spacing, then extend backward from the first valid sync and forward from
    each anchor.

    Degenerate inputs return best-effort results instead of crashing or
    hanging like the reference (empty/single lists hit IndexError there;
    near-duplicate detections make the modal spacing 0 and the forward fill
    an infinite loop), so a noise capture that slipped past `useful` degrades
    to the backup-image path rather than a stack trace (the graceful-
    degradation intent of ref decode_noaa.py:454-456). A "no pair within
    wiggle of the modal spacing" case cannot occur: the mode is itself an
    observed pair spacing, so that pair always qualifies."""
    wiggle = 200
    csync = list(csync)
    if len(csync) < 2:
        return sorted(float(c) for c in csync)
    diffs = np.diff(csync)
    vals, counts = np.unique(diffs, return_counts=True)
    mode = vals[np.argmax(counts)]
    if mode <= wiggle:
        # duplicate/near-duplicate detections dominate: a <=wiggle modal
        # spacing cannot anchor filling (the forward fill would never
        # advance) -- pass the detections through unmodified
        return sorted(float(c) for c in csync)

    valid: list = []
    for i in range(len(csync) - 1):
        if abs(csync[i + 1] - csync[i] - mode) < wiggle:
            if csync[i] not in valid:
                valid.append(csync[i])
            if csync[i + 1] not in valid:
                valid.append(csync[i + 1])
    corrected = valid[:]

    c = valid[0] - mode
    while c > wiggle:
        corrected.append(c)
        c -= mode

    anchor, c = 0, mode
    while valid[anchor] + c < max_len:
        nxt_exists = (anchor + 1) < len(valid)
        if nxt_exists and (abs(valid[anchor + 1] - c - valid[anchor]) < wiggle
                           or c + valid[anchor] > valid[anchor + 1]):
            anchor += 1
            c = mode
        else:
            corrected.append(valid[anchor] + c)
            c += mode
    return list(np.sort(corrected))


# ------------------------------------------------------------------ batched resample

_SYNC_BITS = len(K.NOAA_SYNCA)          # 40: rows consumed by calibration


def _pack_starts(starts) -> jnp.ndarray:
    """Exact (hi, lo) float32 packing of line-start indices: a plain f32
    start quantizes above 2^24 (~4.6 min of 60 kHz envelope), silently
    misaligning lines on full passes. hi/lo are each < 2^24 for any
    |start| < 2^36 (a 36 h capture)."""
    s = np.asarray(starts, dtype=np.int64)
    return jnp.asarray(np.stack([(s // 4096).astype(np.float32),
                                 (s % 4096).astype(np.float32)]))


@partial(jax.jit, static_argnums=(2, 3, 4))
def _lines_kernel(x, starts_hl, ln: int, num: int, unit: int):
    """Gather `ln`-sample spans at `starts` from the device envelope,
    Fourier-resample to `num`, reshape (unit, k), and reduce: per-pixel
    median (the image row, ref decode_noaa.py:350-354) plus the first
    `_SYNC_BITS` rows (the calibration sync-train samples,
    ref decode_noaa.py:357-369). One dispatch per line-length group; only
    the reduced outputs cross the link. Starts ride as exact (hi, lo) f32
    pairs (see _pack_starts)."""
    starts = (starts_hl[0].astype(jnp.int32) * 4096
              + starts_hl[1].astype(jnp.int32))
    rows = jax.vmap(lambda s0: lax.dynamic_slice(x, (s0,), (ln,)))(starts)
    resz = rs.fft_resample(rows, num)
    mats = resz.reshape(rows.shape[0], unit, num // unit)
    return jnp.median(mats, axis=-1), mats[:, :_SYNC_BITS, :]


@partial(jax.jit, static_argnums=(1,))
def _probe_kernel(am, num_pixels: int):
    """The whole-signal coarse median line feeding the initial contrast
    (ref decode_noaa.py:309-313), reduced on device: (num_pixels,) out."""
    k = am.shape[0] // num_pixels
    return jnp.median(am[: k * num_pixels].reshape(num_pixels, k), axis=-1)


@partial(jax.jit, static_argnums=(2,))
def _strip_medians_kernel(am, starts_hl, strip_len: int):
    """Per-line telemetry-strip medians median(am[s : s+strip_len]) batched
    on device (ref decode_noaa.py:371-373 reads the strip just before each
    sync). One dispatch for all full-width strips."""
    starts = (starts_hl[0].astype(jnp.int32) * 4096
              + starts_hl[1].astype(jnp.int32))
    rows = jax.vmap(lambda s0: lax.dynamic_slice(am, (s0,), (strip_len,)))(
        starts)
    return jnp.median(rows, axis=-1)


@partial(jax.jit, static_argnums=(1,))
def _head_kernel(am, size: int):
    return am[:size]


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _image_stage_kernel(audio, bp, block: int, strip_len: int,
                        num_pixels: int, group_spec: tuple,
                        starts_hl_a, starts_hl_b, group_starts):
    """The image stage's ENTIRE device work in ONE dispatch returning ONE
    flat f32 buffer: zero-phase bandpass + blocked Hilbert envelope
    (ref decode_noaa.py:274,631-657), the contrast probe (ref :309-313),
    both channels' telemetry-strip medians (ref :371-373), and every
    line-length group's resample+median reduction (ref :350-369).

    `group_spec`: static tuple of (ln, num, unit, rows) per length group;
    `group_starts`: matching tuple of (2, rows) hi/lo start arrays. The
    whole stage costs one dispatch and one download."""
    env = am_ops.envelope_blocked(bp.zero_phase(audio), block)
    kk = env.shape[0] // num_pixels
    probe = jnp.median(env[: kk * num_pixels].reshape(num_pixels, kk),
                       axis=-1)

    def unpack_hl(starts_hl):
        return (starts_hl[0].astype(jnp.int32) * 4096
                + starts_hl[1].astype(jnp.int32))

    def strips(starts_hl):
        rows = jax.vmap(lambda s0: lax.dynamic_slice(
            env, (s0,), (strip_len,)))(unpack_hl(starts_hl))
        return jnp.median(rows, axis=-1)

    outs = [probe, strips(starts_hl_a), strips(starts_hl_b)]
    for (ln, num, unit, _rows), st_hl in zip(group_spec, group_starts):
        rows = jax.vmap(lambda s0: lax.dynamic_slice(
            env, (s0,), (ln,)))(unpack_hl(st_hl))
        resz = rs.fft_resample(rows, num)
        mats = resz.reshape(rows.shape[0], unit, num // unit)
        outs.append(jnp.median(mats, axis=-1).ravel())
        outs.append(mats[:, :_SYNC_BITS, :].ravel())
    return jnp.concatenate([o.astype(jnp.float32).ravel() for o in outs])


def _strip_medians(am, am_dev, sync_starts, strip_len: int) -> np.ndarray:
    """np.median(am[max(s - strip_len, 0): s]) per line, 0.0 when s <= 0
    (the host walk's per-line strip estimate). With a device-resident
    envelope the full-width strips batch into ONE device reduce; the rare
    capture-head strips (0 < s < strip_len) download one small head slice."""
    starts = [int(s) for s in sync_starts]
    out = np.zeros(len(starts))
    if am is not None:
        for i, s in enumerate(starts):
            if s > 0:
                out[i] = float(np.median(am[max(s - strip_len, 0): s]))
        return out
    full = [(i, s) for i, s in enumerate(starts) if s >= strip_len]
    if full:
        med = hostio.device_get(_strip_medians_kernel(
            am_dev, _pack_starts([s - strip_len for _, s in full]),
            strip_len))
        for (i, _), m in zip(full, np.atleast_1d(med)):
            out[i] = float(m)
    short = [(i, s) for i, s in enumerate(starts) if 0 < s < strip_len]
    if short:
        head = hostio.device_get(
            _head_kernel(am_dev, min(int(am_dev.shape[0]), strip_len)))
        for i, s in short:
            out[i] = float(np.median(head[:s]))
    return out


def _resample_lines_two(am, spans_a: list, spans_b: list, unit: int,
                        am_dev=None):
    """_resample_lines_batched over BOTH channels with shared length
    groups: A and B spans of equal length ride the same device dispatch
    (typically halving the image stage's kernel-launch count — the modal
    line length dominates both channels)."""
    merged = spans_a + spans_b
    out = _resample_lines_batched(am, merged, unit, am_dev)
    na = len(spans_a)
    return ({i: out[i] for i in range(na)},
            {i: out[na + i] for i in range(len(spans_b))})


def _resample_lines_batched(am: np.ndarray, spans: list, unit: int,
                            am_dev=None):
    """For each (start, end) span, Fourier-resample am[start:end] to
    (len//unit)*unit samples and reshape to (unit, k) -- the reference's
    per-line `signal.resample` + reshape (ref decode_noaa.py:350-354) batched
    by identical length on device. Returns {line_index: (median_row (unit,),
    head (_SYNC_BITS, k))}. With `am_dev` (device-resident envelope) the
    spans are gathered, resampled, and median-reduced ON device; only the
    per-line reductions are downloaded."""
    groups: dict[int, list] = {}
    for li, (s, e) in enumerate(spans):
        # degenerate (duplicate/out-of-order) syncs yield empty or reversed
        # spans; treat them as zero-length lines instead of feeding a
        # negative resample size downstream
        groups.setdefault(max(e - s, 0), []).append(li)
    out: dict[int, tuple] = {}
    for ln, members in groups.items():
        k = ln // unit
        if k == 0:
            for li in members:
                out[li] = (np.zeros(0), np.zeros((_SYNC_BITS, 0)))
            continue
        num = k * unit
        if am_dev is not None:
            starts = _pack_starts([spans[li][0] for li in members])
            med, head = _lines_kernel(am_dev, starts, ln, num, unit)
            med = hostio.device_get(med)
            head = hostio.device_get(head)
            for row, li in enumerate(members):
                out[li] = (med[row], head[row])
            continue
        batch = np.stack([am[spans[li][0]:spans[li][1]] for li in members])
        resz = np.asarray(rs.fft_resample(jnp.asarray(batch), num))
        for row, li in enumerate(members):
            mat = resz[row].reshape(unit, k)
            out[li] = (np.median(mat, axis=-1), mat[:_SYNC_BITS])
    return out


# ------------------------------------------------------------------ calibration

@dataclass
class _Calib:
    """Calibration-wedge state machine (ref decode_noaa.py:315-425)."""
    low: float
    high: float
    fifo_len: int = K.NOAA_COLORCORRECT_FIFOLEN
    low_fifo: list = field(default_factory=list)
    high_fifo: list = field(default_factory=list)
    corr_pix: list = field(default_factory=list)
    corr_sig: list = field(default_factory=list)
    corr_sig2: list = field(default_factory=list)
    chid1: list = field(default_factory=list)
    chid2: list = field(default_factory=list)
    last_pix: float | None = None
    last_sig: float | None = None
    state: int = 0
    wedge_pix: list = field(default_factory=list)
    wedge_sig: list = field(default_factory=list)
    slope: float | None = None
    intercept: float | None = None
    ch_id_a: int | None = None
    ch_id_b: int | None = None

    def update_from_sync_train(self, line_matrix: np.ndarray) -> None:
        """Re-estimate low/high from the known sync-train bits of a detected
        (not synthesized) line (ref decode_noaa.py:357-369).

        The reference extends and re-trims the FIFOs per sync bit; batching
        to one concatenate+trim per FIFO per line leaves the final contents
        (and hence the medians) identical — row order is preserved within
        each bit class — while cutting the walk's Python-list overhead
        (~2 s of a 600-line image's host time)."""
        bits = np.asarray(K.NOAA_SYNCA)
        lows = np.asarray(line_matrix)[bits == 0].ravel()
        highs = np.asarray(line_matrix)[bits == 1].ravel()
        self.low_fifo = np.concatenate(
            [np.asarray(self.low_fifo), lows])[-self.fifo_len:]
        self.high_fifo = np.concatenate(
            [np.asarray(self.high_fifo), highs])[-self.fifo_len:]
        v11 = float(np.median(self.low_fifo))
        v244 = float(np.median(self.high_fifo))
        span = (v244 - v11) / (244.0 - 11.0)
        self.low = v11 - span * (11.0 - 0.0)
        self.high = v11 - span * (11.0 - 255.0)

    def step_wedge(self, strip_a: float, strip_b: float) -> None:
        """One line of the wedge detector (ref decode_noaa.py:371-425).
        strip_a/strip_b are the pre-sync telemetry-strip medians."""
        self.corr_pix.append(255.0 * (strip_a - self.low) / (self.high - self.low))
        self.corr_pix = self.corr_pix[-3:]
        out_pix = float(np.median(self.corr_pix))
        self.corr_sig.append(strip_a)
        self.corr_sig = self.corr_sig[-3:]
        out_sig = float(np.median(self.corr_sig))
        self.corr_sig2.append(strip_b)
        self.corr_sig2 = self.corr_sig2[-3:]
        out_sig2 = float(np.median(self.corr_sig2))

        self.chid1.append(out_sig2)
        self.chid1 = self.chid1[-100:]
        self.chid2.append(out_sig)
        self.chid2 = self.chid2[-100:]

        if self.last_pix is None or abs(out_pix - self.last_pix) > 255.0 / 16:
            if self.state == 0 and self.last_sig is not None:
                self.wedge_pix = [self.last_pix, out_pix]
                self.wedge_sig = [self.last_sig, out_sig]
                self.state = 1
            elif 1 <= self.state <= 6:
                if out_pix - self.wedge_pix[-1] > 2 * 255.0 / (8 * 3):
                    self.wedge_pix.append(out_pix)
                    self.wedge_sig.append(out_sig)
                    self.state += 1
                else:
                    self.state = 0
            elif self.state == 7:
                if self.wedge_pix[-1] - out_pix > 2 * 255.0 / 3:
                    self.wedge_sig = [out_sig] + self.wedge_sig
                    targets = np.arange(9) * 255.0 / 8
                    self.slope, self.intercept = _linregress(
                        np.asarray(self.wedge_sig), targets)
                    if len(self.chid1) > 1 + 64 + 8:
                        self.ch_id_a = int(np.round(
                            (self.slope * np.median(self.chid1[-1 - 64 - 8:-1 - 64])
                             + self.intercept) / (255.0 / 8)))
                        self.ch_id_b = int(np.round(
                            (self.slope * np.median(self.chid2[-1 - 64 - 8:-1 - 64])
                             + self.intercept) / (255.0 / 8)))
                    self.chid1, self.chid2 = [], []
                self.state = 0
        self.last_pix = out_pix
        self.last_sig = out_sig


def _linregress(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares slope/intercept (the subset of scipy.stats.linregress
    used at ref decode_noaa.py:413)."""
    mx, my = np.mean(x), np.mean(y)
    dx = x - mx
    slope = float(np.dot(dx, y - my) / np.dot(dx, dx))
    return slope, float(my - slope * mx)


def _quantize(line: np.ndarray, scale: float, offset: float) -> np.ndarray:
    q = np.round(line * scale + offset)
    return np.clip(q, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ assembly

def assemble_image(am: np.ndarray, rate: int, csync_a: list, csync_b: list,
                   ucsync: np.ndarray, am_dev=None, audio_dev=None,
                   bp=None, am_block: int | None = None
                   ) -> tuple[np.ndarray, int | None, int | None]:
    """Build the calibrated APT image from the AM envelope and filled syncs
    (ref decode_noaa.py:305-461). Returns (image, channel_id_a, channel_id_b).

    Input forms, fastest first:
      * `audio_dev` (+ `bp`, `am_block`): the device-resident FM audio —
        the ENTIRE image-stage device work (bandpass, envelope, probe,
        strip medians, every line group's resample+median) fuses into ONE
        dispatch + ONE packed download (_image_stage_kernel);
      * `am_dev`: device-resident envelope; per-line reductions on device;
      * `am`: host envelope (the sharded multi-host path).
    """
    num_pixels = int(0.5 / K.NOAA_T)           # 2080 px per full line
    half = int(num_pixels * 0.5)               # 1040 per channel
    if audio_dev is not None:
        n_am = int(audio_dev.shape[0])
    else:
        n_am = len(am) if am is not None else int(am_dev.shape[0])

    # per-line spans
    n_lines = len(csync_a)
    spans_a, spans_b, keep = [], [], []
    for i in range(n_lines):
        sa, sb = int(csync_a[i]), int(csync_b[i])
        ea = sb
        eb = sb + int(0.25 * rate)
        if i + 1 < n_lines:
            eb = int(csync_a[i + 1])
        if eb > n_am or ea > n_am or sa < 0 or sb < 0:
            continue
        keep.append(i)
        spans_a.append((sa, ea))
        spans_b.append((sb, eb))

    strip_len = int(len(K.NOAA_SYNCA) * K.NOAA_T * rate)

    if audio_dev is not None:
        probe, strips_a, strips_b, mats_a, mats_b = _image_stage_fused(
            audio_dev, bp, am_block, strip_len, num_pixels, half,
            spans_a, spans_b)
    else:
        # initial contrast from a coarse whole-signal median line
        # (ref decode_noaa.py:309-313)
        if am is not None:
            probe = am[: (n_am // num_pixels) * num_pixels]
            probe = probe.reshape(num_pixels, -1)
            probe = np.median(probe, axis=-1)
        else:
            probe = hostio.device_get(_probe_kernel(am_dev, num_pixels))
        strips_a = _strip_medians(am, am_dev, [s for (s, _) in spans_a],
                                  strip_len)
        strips_b = _strip_medians(am, am_dev, [s for (s, _) in spans_b],
                                  strip_len)
        mats_a, mats_b = _resample_lines_two(am, spans_a, spans_b, half,
                                             am_dev)
    return _calibration_walk(probe, mats_a, mats_b, strips_a, strips_b,
                             csync_a, ucsync, keep, num_pixels)


def _calibration_walk(probe, mats_a, mats_b, strips_a, strips_b,
                      csync_a, ucsync, keep, num_pixels
                      ) -> tuple[np.ndarray, int | None, int | None]:
    """The host-side calibration/quantization walk over per-line reductions
    (ref decode_noaa.py:315-461): O(lines), a few hundred scalars each."""
    low, high = np.percentile(probe, (0.5, 99.5))
    calib = _Calib(low=float(low), high=float(high))

    image: list = []
    backup: list = []
    buffered: list = []
    ucset = set(float(u) for u in ucsync)

    for li, i in enumerate(keep):
        (med_a, head_a), (med_b, _) = mats_a[li], mats_b[li]

        if float(csync_a[i]) in ucset and head_a.shape[1] > 0:
            calib.update_from_sync_train(head_a)

        calib.step_wedge(float(strips_a[li]), float(strips_b[li]))

        line = np.concatenate([med_a, med_b])

        if calib.slope is None or calib.intercept is None:
            buffered.append(line.copy())
            backup.append(_quantize(line, 255.0 / (calib.high - calib.low),
                                    -255.0 * calib.low / (calib.high - calib.low)))
        else:
            if buffered:
                for b in buffered:
                    image.append(_quantize(b, calib.slope, calib.intercept))
                buffered = []
            image.append(_quantize(line, calib.slope, calib.intercept))

    if not image:
        image = backup                         # ref decode_noaa.py:454-456

    lens = [len(r) for r in image]
    if not lens:
        return np.zeros((0, num_pixels), dtype=np.uint8), None, None
    accepted = max(set(lens), key=lens.count)
    img = np.asarray([r for r in image if len(r) == accepted])
    return img, calib.ch_id_a, calib.ch_id_b


def _image_stage_fused(audio_dev, bp, am_block: int, strip_len: int,
                       num_pixels: int, unit: int, spans_a, spans_b):
    """Host driver for _image_stage_kernel: ONE dispatch + ONE download for
    the whole image-stage device work. Returns
    (probe, strips_a, strips_b, mats_a, mats_b)."""
    def pow2(n):
        return 1 << (max(n, 1) - 1).bit_length()

    def pack_strip_starts(spans):
        full = [(i, s - strip_len) for i, (s, _) in enumerate(spans)
                if s >= strip_len]
        ws = [w for _, w in full] or [0]
        ws = ws + [ws[0]] * (pow2(len(ws)) - len(ws))
        return full, _pack_starts(ws)

    full_a, hl_a = pack_strip_starts(spans_a)
    full_b, hl_b = pack_strip_starts(spans_b)

    # merged A/B length groups (A and B share the modal line length)
    merged = list(spans_a) + list(spans_b)
    groups: dict[int, list] = {}
    for li, (s, e) in enumerate(merged):
        groups.setdefault(max(e - s, 0), []).append(li)
    spec = []              # (ln, num, unit, rows_bucket)
    g_starts = []
    g_members = []
    for ln in sorted(groups):
        members = groups[ln]
        k = ln // unit
        if k == 0:
            continue       # degenerate spans: zero-length lines, host-filled
        rows = pow2(len(members))
        starts = [merged[li][0] for li in members]
        starts = starts + [starts[0]] * (rows - len(starts))
        spec.append((ln, k * unit, unit, rows))
        g_starts.append(_pack_starts(starts))
        g_members.append(members)

    flat = hostio.device_get(_image_stage_kernel(
        jnp.asarray(audio_dev, dtype=jnp.float32), bp, am_block, strip_len,
        num_pixels, tuple(spec), hl_a, hl_b, tuple(g_starts)))

    # unpack by the static layout
    off = 0

    def take(n):
        nonlocal off
        out = flat[off: off + n]
        off += n
        return out

    probe = take(num_pixels)
    med_a = take(hl_a.shape[1])
    med_b = take(hl_b.shape[1])
    strips_a = np.zeros(len(spans_a))
    strips_b = np.zeros(len(spans_b))
    for (i, _), m in zip(full_a, med_a):
        strips_a[i] = float(m)
    for (i, _), m in zip(full_b, med_b):
        strips_b[i] = float(m)

    mats: dict[int, tuple] = {}
    for (ln, num, un, rows), members in zip(spec, g_members):
        k = num // un
        med = take(rows * un).reshape(rows, un)
        head = take(rows * _SYNC_BITS * k).reshape(rows, _SYNC_BITS, k)
        for row, li in enumerate(members):
            mats[li] = (med[row], head[row])
    for li in range(len(merged)):       # degenerate spans
        if li not in mats:
            mats[li] = (np.zeros(0), np.zeros((_SYNC_BITS, 0)))

    # capture-head strips (0 < s < strip_len): rare, one small extra read
    for strips, spans in ((strips_a, spans_a), (strips_b, spans_b)):
        short = [(i, s) for i, (s, _) in enumerate(spans)
                 if 0 < s < strip_len]
        if short:
            env_head = hostio.device_get(_env_head_kernel(
                jnp.asarray(audio_dev, dtype=jnp.float32), bp, am_block,
                strip_len))
            for i, s in short:
                strips[i] = float(np.median(env_head[:s]))

    na = len(spans_a)
    return (probe, strips_a, strips_b,
            {i: mats[i] for i in range(na)},
            {i: mats[na + i] for i in range(len(spans_b))})


@partial(jax.jit, static_argnums=(1, 2, 3))
def _env_head_kernel(audio, bp, block: int, size: int):
    """First `size` samples of the filtered envelope (capture-head strip
    fallback; recomputing the head is cheaper than keeping the whole
    envelope resident for a rare path)."""
    return am_ops.envelope_blocked(bp.zero_phase(audio), block)[:size]
