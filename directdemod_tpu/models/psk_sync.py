"""Funcube/Meteor frame-sync detection: chunk loop + two-pass max-sync search.

Behavioral reference: `decode_funcube.getSyncs` / `decode_meteorm2.getSyncs`
(ref decode_funcube.py:148-306, decode_meteorm2.py:145-332). The reference
interleaves, per *sample*: (1) conditional buffering of PLL-rotated samples
near expected frame positions, (2) a correlation countdown, (3) Gardner/AGC/
Costas symbol processing with rolling-buffer "minsync" detection.

Device restructuring into two passes:
  pass 1 (device): ops/pll.symbol_scan -- all PLL state at symbol rate.
  pass 2 (host+device): the per-sample buffering/countdown is *replayed
  analytically*: the armed region is an interval arithmetic problem over the
  symbol->sample map, the buffered values are a gather of the stored filtered
  stream rotated by the piecewise-constant PLL phasor, and the max-sync
  correlation is one FFT correlation per detected frame.

The NCO phase restarts at every chunk (the reference builds its commSignal
without a chunker -- ref decode_funcube.py:199), and the Butterworth low-pass
carries state across chunks (filter built once outside the loop -- ref
decode_funcube.py:160). Both quirks are reproduced.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from functools import partial

from jax import lax

from ..constants import PROC_CHUNKSIZE
from ..ops import iir, nco, unpack
from ..ops.pll import (PskParams, _segments_core, initial_state,
                       pack_symbol_outs, pack_symbol_outs_owned,
                       symbol_scan, symbol_scan_segments,
                       unpack_symbol_outs)
from ..stream import plan as plan_mod
from ..utils import hostio

log = logging.getLogger(__name__)


@partial(jax.jit, static_argnums=(2,))
def _slice_fixed(arr, start, size: int):
    return lax.dynamic_slice(arr, (start,), (size,))


class _DeviceStream:
    """A retained span [lo, hi) of the filtered stream kept ON DEVICE.

    Pass 2 only ever reads the few correlation windows around detected
    frames (~2x the needle length each); downloading the whole filtered
    block per chunk (~160 MB of complex64 at 20 M samples) would move far
    more than it reads. Window reads slice on device and download KBs
    instead; slice sizes round up to 4096-multiples so the jit cache holds
    a handful of shapes, not one per window."""

    def __init__(self, arr, lo: int):
        self.arr = arr
        self.lo = int(lo)

    @property
    def hi(self) -> int:
        return self.lo + int(self.arr.shape[0])

    def get(self, a: int, b: int) -> np.ndarray:
        """Download stream[a:b] (global coordinates, [lo, hi)-clipped)."""
        a = max(a, self.lo)
        b = min(b, self.hi)
        if b <= a:
            return np.empty(0, dtype=np.complex64)
        n = int(self.arr.shape[0])
        size = min(n, -(-(b - a) // 4096) * 4096)
        start = min(a - self.lo, n - size)
        win = hostio.device_get(_slice_fixed(self.arr, jnp.int32(start),
                                             size))
        off = (a - self.lo) - start
        return win[off: off + (b - a)]


class _DeviceStreamChain:
    """_DeviceStream over a LIST of contiguous device blocks: no device-side
    concatenation at all (no whole-capture copy). Window reads may straddle
    block boundaries; parts download separately and join on host."""

    def __init__(self):
        self.segs: list = []       # [(device arr, global lo)], contiguous

    def append(self, arr, lo: int) -> None:
        self.segs.append((arr, int(lo)))

    @property
    def lo(self) -> int:
        return self.segs[0][1] if self.segs else 0

    @property
    def hi(self) -> int:
        if not self.segs:
            return 0
        arr, lo = self.segs[-1]
        return lo + int(arr.shape[0])

    def get(self, a: int, b: int) -> np.ndarray:
        parts = []
        for arr, lo in self.segs:
            hi = lo + int(arr.shape[0])
            aa, bb = max(a, lo), min(b, hi)
            if bb > aa:
                parts.append(_DeviceStream(arr, lo).get(aa, bb))
        if not parts:
            return np.empty(0, dtype=np.complex64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def prune(self, keep_from: int) -> None:
        """Drop whole blocks that end at or before `keep_from`."""
        self.segs = [(arr, lo) for (arr, lo) in self.segs
                     if lo + int(arr.shape[0]) > keep_from]


@partial(jax.jit, static_argnums=(0, 1, 4))
def _block_pipeline_seq(p, lp, x, lp_state, omega, anchors, scan_state,
                        sync, sync1):
    """ONE dispatch per stream block: unpack (raw u8) -> chunk-local NCO ->
    Butterworth low-pass -> fused symbol scan -> packed outputs, plus the
    anchor rebase for the next block. `omega` is the static per-sample NCO
    increment (0.0 skips the mixer at trace time)."""
    if x.dtype == jnp.uint8:
        x = unpack.iq_u8_to_complex(x, jnp.float32)
    if omega != 0.0:
        x = nco.mix(x, omega, anchors)
    x, lp_state = lp.apply(x, lp_state)
    scan_state, outs = symbol_scan(p, x, scan_state, sync, sync1)
    scan_state = scan_state._replace(
        anchor=scan_state.anchor - jnp.int32(x.shape[0]))
    return pack_symbol_outs(outs), x, lp_state, scan_state


@partial(jax.jit, static_argnums=(0, 1, 4, 6, 7, 8))
def _capture_pipeline(p, lp, raw_or_x, lp_state, omega, anchors_tuple,
                      plan_tuple: tuple, n_segments: int,
                      warmup_symbols: int, sync, sync1):
    """The WHOLE capture in ONE dispatch: unpack, per-chunk NCO (the
    reference's phase-restart quirk preserved by a static unrolled loop
    over the chunk plan), continuous low-pass, and either the sequential
    fused symbol scan or the capture-level segmented scan, ending in the
    packed-outputs tensor: one dispatch + one download for the capture
    instead of ~4 per 20M-sample block.

    Capture-level segmentation (vs per-block) makes the parallel fraction
    n/n_segments of the WHOLE capture, so the segment speedup is no longer
    capped by the per-block sequential scan."""
    x = raw_or_x
    if x.dtype == jnp.uint8:
        x = unpack.iq_u8_to_complex(x, jnp.float32)
    if omega != 0.0:
        parts = [nco.mix(lax.slice(x, (s,), (e,)), omega, anch)
                 for (s, e), anch in zip(plan_tuple, anchors_tuple)]
        x = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    x, _ = lp.apply(x, lp_state)
    if n_segments > 1:
        outs, owned = _segments_core(p, x, (sync, sync1), n_segments,
                                     warmup_symbols, 0)
        return pack_symbol_outs_owned(outs, owned), x
    state = initial_state(p, int(jnp.asarray(sync).shape[0]))
    _, outs = symbol_scan(p, x, state, sync, sync1)
    return pack_symbol_outs(outs), x


# capture-level segmentation cap: the filtered capture plus the segment
# gather both materialize, ~16 B/sample total
_CAPTURE_SEG_MAX = 128_000_000


@partial(jax.jit, static_argnums=(0, 1, 4, 7, 8))
def _block_pipeline_seg(p, lp, x, lp_state, omega, anchors, filt_prefix,
                        n_segments: int, warmup_symbols: int, sync, sync1):
    """_block_pipeline_seq with the segment-parallel scan: the previous
    block's filtered warmup tail rides in as `filt_prefix` (length 0 on the
    first block) and the next tail returns without leaving the device."""
    if x.dtype == jnp.uint8:
        x = unpack.iq_u8_to_complex(x, jnp.float32)
    if omega != 0.0:
        x = nco.mix(x, omega, anchors)
    x, lp_state = lp.apply(x, lp_state)
    xw = jnp.concatenate([filt_prefix, x]) \
        if filt_prefix.shape[0] else x
    outs, owned = _segments_core(p, xw, (sync, sync1), n_segments,
                                 warmup_symbols, int(filt_prefix.shape[0]))
    warm = int(warmup_symbols * p.symbol_period)
    return (pack_symbol_outs_owned(outs, owned), x, xw[-warm:], lp_state)


class _RecordingStream:
    """Dry-run stand-in for a stream: records every requested window range
    and returns zeros. Pass 2's control flow (arming windows, countdowns,
    retriggers) depends only on the SYMBOL streams, never on the window
    sample values, so a dry run discovers exactly which spans the real run
    will read."""

    def __init__(self, inner):
        self.inner = inner
        self.ranges: list = []

    @property
    def lo(self) -> int:
        return self.inner.lo

    @property
    def hi(self) -> int:
        return self.inner.hi

    def get(self, a: int, b: int) -> np.ndarray:
        a2, b2 = max(a, self.lo), min(b, self.hi)
        if b2 <= a2:
            return np.empty(0, dtype=np.complex64)
        self.ranges.append((a2, b2))
        return np.zeros(b2 - a2, dtype=np.complex64)


class _CachedStream:
    """Serves the ranges a _RecordingStream discovered from one batched
    prefetch; anything else falls through to the inner stream."""

    def __init__(self, inner, cache: dict):
        self.inner = inner
        self.cache = cache

    @property
    def lo(self) -> int:
        return self.inner.lo

    @property
    def hi(self) -> int:
        return self.inner.hi

    def get(self, a: int, b: int) -> np.ndarray:
        a2, b2 = max(a, self.lo), min(b, self.hi)
        hit = self.cache.get((a2, b2))
        return hit if hit is not None else self.inner.get(a, b)


@partial(jax.jit, static_argnums=(2,))
def _gather_windows(arr, starts_hl, size: int):
    starts = (starts_hl[0].astype(jnp.int32) * 4096
              + starts_hl[1].astype(jnp.int32))
    return jax.vmap(lambda s0: lax.dynamic_slice(arr, (s0,), (size,)))(starts)


def _prefetch_windows(chain: _DeviceStreamChain, ranges: list) -> dict:
    """ONE gather dispatch + ONE download for all of pass 2's correlation
    windows (not one transfer per window). Returns {(a, b): np window}."""
    if not ranges:
        return {}
    arrs = [a for a, _ in chain.segs]
    base = chain.lo
    full = arrs[0] if len(arrs) == 1 else jnp.concatenate(arrs)
    n = int(full.shape[0])
    size = max(b - a for a, b in ranges)
    size = min(n, -(-size // 4096) * 4096)
    starts = [min(max(a - base, 0), n - size) for a, _ in ranges]
    hl = np.stack([(np.asarray(starts, np.int64) // 4096).astype(np.float32),
                   (np.asarray(starts, np.int64) % 4096).astype(np.float32)])
    wins = hostio.device_get(_gather_windows(full, jnp.asarray(hl), size))
    cache = {}
    for (a, b), s0, row in zip(ranges, starts, wins):
        off = (a - base) - int(s0)
        cache[(a, b)] = row[off: off + (b - a)]
    return cache


class _CoverageError(Exception):
    """A sparse symbol view was asked for data outside its gathered spans
    (margins too tight); the caller falls back to the dense download."""


class _DenseSymbols:
    """Pass-2 symbol-stream view over fully downloaded per-chunk arrays."""

    def __init__(self, a_chunks, ph_chunks, ch_chunks):
        self.a = np.concatenate(a_chunks) if a_chunks else np.empty(0)
        self.ph = np.concatenate(ph_chunks) if ph_chunks else np.empty(0)
        self.ch = (np.concatenate(ch_chunks) if ch_chunks
                   else np.empty(0, np.int64))

    def sym_sample(self, j: int):
        """Global sample of 0-based symbol j (ctr becomes j+1 there)."""
        return int(self.a[j]) if 0 <= j < len(self.a) else None

    def phase_at(self, n_arr: np.ndarray) -> np.ndarray:
        """PLL phase in effect at samples n_arr: the phase of the last
        symbol with a_idx < n (pllObj.output is updated when a symbol
        processes -- ref decode_funcube.py:61)."""
        pos = np.searchsorted(self.a, n_arr, side="left") - 1
        return np.where(pos >= 0, self.ph[np.clip(pos, 0, None)], 0.0)

    def chosen_before(self, n: int) -> int:
        pos = np.searchsorted(self.a, n, side="left") - 1
        return int(self.ch[pos]) if pos >= 0 else 0


class _SparseSymbols:
    """Pass-2 symbol view backed by gathered SPANS of the symbol table.

    The arming/countdown replay reads symbol data only near minsync events
    (the symbol->sample map at arm boundaries, phases over correlation
    windows, the needle choice at window end) -- KBs of a multi-MB stream.
    Spans are (j0, a, ph, ch) with j0 the 0-based global symbol index of the
    span's first entry; every lookup VERIFIES the answer is determined by the
    gathered data (the true predecessor is in-span or provably the global
    last) and raises _CoverageError otherwise, so a margin miss degrades to
    the exact dense path instead of a silent wrong answer."""

    def __init__(self, spans: list, total: int):
        spans = sorted(spans, key=lambda s: s[0])
        self.total = int(total)
        self._j0s = [s[0] for s in spans]
        if spans:
            self.a = np.concatenate([s[1] for s in spans])
            self.ph = np.concatenate([s[2] for s in spans])
            self.ch = np.concatenate([s[3] for s in spans])
            self.g = np.concatenate([s[0] + np.arange(len(s[1]))
                                     for s in spans])
        else:
            self.a = np.empty(0)
            self.ph = np.empty(0)
            self.ch = np.empty(0, np.int64)
            self.g = np.empty(0, np.int64)

    def sym_sample(self, j: int):
        if j >= self.total:
            return None
        pos = np.searchsorted(self.g, j)
        if pos < len(self.g) and self.g[pos] == j:
            return int(self.a[pos])
        raise _CoverageError(f"symbol {j} not gathered")

    def _pred(self, n_arr: np.ndarray) -> np.ndarray:
        """Concat-index of the predecessor symbol (a < n), -1 for none;
        raises unless the answer is determined by the gathered spans."""
        n_arr = np.asarray(n_arr)
        pos = np.searchsorted(self.a, n_arr, side="left") - 1
        if len(self.a) == 0:
            if self.total == 0:
                return np.full(n_arr.shape, -1, np.int64)
            raise _CoverageError("empty sparse view, nonempty stream")
        none_ok = (self.g[0] == 0)       # span 0 starts at global symbol 0
        bad_none = (pos < 0) & ~none_ok
        g = self.g[np.clip(pos, 0, None)]
        nxt = np.concatenate([self.g[1:], [-2]])[np.clip(pos, 0, None)]
        determined = (g == self.total - 1) | (nxt == g + 1)
        bad = (pos >= 0) & ~determined
        if np.any(bad_none) or np.any(bad):
            raise _CoverageError("predecessor lookup outside gathered spans")
        return pos

    def phase_at(self, n_arr: np.ndarray) -> np.ndarray:
        pos = self._pred(n_arr)
        return np.where(pos >= 0, self.ph[np.clip(pos, 0, None)], 0.0)

    def chosen_before(self, n: int) -> int:
        pos = int(self._pred(np.asarray([n]))[0])
        return int(self.ch[pos]) if pos >= 0 else 0


# minsync-event cap for the sparse pass-2 path; more events than this (a
# pathological capture) falls back to the dense download, which is exact
_MAX_EVENTS = 4096


@partial(jax.jit, static_argnums=(1, 2))
def _events_and_table(packed, max_ev: int, use_owned: bool):
    """Device-side compaction of the packed symbol tensor into
      * a small event record (minsync ctr + sample, f32-exact) ready to
        download, with [n_events, n_symbols] appended, and
      * the dense per-symbol table [chosen*2^15 + a_hi, a_lo, phase] that
        STAYS ON DEVICE for span gathers (_gather_table_rows).
    Ordering matches the host-side seg_take/valid concatenation exactly
    (seg-major flatten of the owned/valid symbols)."""
    pk = packed.reshape(-1, 3).astype(jnp.float32)
    col0 = pk[:, 0]
    flags = jnp.floor(col0 / 32768.0)
    hi = col0 - flags * 32768.0
    fl = flags.astype(jnp.int32)
    valid = (fl & 1) > 0
    mask = ((fl & 16) > 0) if use_owned else valid
    csum = jnp.cumsum(mask.astype(jnp.int32))
    n_sym = csum[-1]
    n = pk.shape[0]
    ch = (fl >> 2) & 3
    rows = jnp.stack([ch.astype(jnp.float32) * 32768.0 + hi,
                      pk[:, 1], pk[:, 2]], axis=-1)
    idx = jnp.where(mask, csum - 1, n)
    tbl = jnp.zeros((n, 3), jnp.float32).at[idx].set(rows, mode="drop")
    em = mask & ((fl & 2) > 0)
    ecs = jnp.cumsum(em.astype(jnp.int32))
    n_ev = ecs[-1]
    erows = jnp.stack([csum.astype(jnp.float32), hi, pk[:, 1]], axis=-1)
    eidx = jnp.where(em, ecs - 1, max_ev)
    ev = jnp.zeros((max_ev, 3), jnp.float32).at[eidx].set(erows, mode="drop")
    flat = jnp.concatenate([
        ev.reshape(-1),
        jnp.stack([n_ev, n_sym]).astype(jnp.float32)])
    return flat, tbl


@partial(jax.jit, static_argnums=(2,))
def _gather_table_rows(tbl, starts_hl, size: int):
    starts = (starts_hl[0].astype(jnp.int32) * 4096
              + starts_hl[1].astype(jnp.int32))
    return jax.vmap(
        lambda s0: lax.dynamic_slice(
            tbl, (s0, jnp.zeros((), s0.dtype)), (size, 3)))(starts)


class _HostStream:
    """_DeviceStream's surface over a plain numpy span (tests / host paths)."""

    def __init__(self, arr: np.ndarray, lo: int):
        self.arr = arr
        self.lo = int(lo)

    @property
    def hi(self) -> int:
        return self.lo + len(self.arr)

    def get(self, a: int, b: int) -> np.ndarray:
        a = max(a, self.lo)
        b = min(b, self.hi)
        if b <= a:
            return np.empty(0, dtype=np.complex64)
        return self.arr[a - self.lo: b - self.lo]


def _lim(x: np.ndarray) -> np.ndarray:
    """ref decode_funcube.py:88-97: clamp to [-128,127], values in (0,1)->1,
    (-1,0)->-1, else int truncation."""
    out = np.trunc(x)
    out = np.where((x > 0) & (x < 1), 1, out)
    out = np.where((x > -1) & (x < 0), -1, out)
    return np.clip(out, -128, 127)


@dataclass
class _SyncConfig:
    sym_sync: np.ndarray        # 0/1 pattern at symbol rate (buffer compare)
    sym_sync_alt: np.ndarray    # QPSK alternate (== sym_sync for BPSK)
    needles: list               # +-128-valued full-rate needles (1 or 3)
    entries_per_sample: int     # 1 bpsk, 2 qpsk (interleaved I/Q)
    cap_entries: int            # maxResBuff cap (2 * len(needle))
    arm_pre_syms: int           # arming starts at ctr > lastMin + this
    arm_end_syms: int           # arming ends past ctr > lastMin + this
    frame_spacing: float        # expected sync spacing (samples)
    spacing_tol: float          # usefulness tolerance (samples)


class PskSyncDetector:
    """Shared driver; see FuncubeDecoder / MeteorM2Decoder for the configs."""

    def __init__(self, sigsrc, offset, bw: int, params: PskParams,
                 cfg: _SyncConfig, freq_fn=None, dtype=jnp.complex64,
                 block_size: int = PROC_CHUNKSIZE,
                 n_segments: int | None = None, mesh=None,
                 warmup_symbols: int = 2000):
        """`n_segments` > 1 switches the PLL to the segment-parallel scan
        (ops/pll.symbol_scan_segments): each block is split into segments with
        a `warmup_symbols` re-lock halo, scanned concurrently (vmapped on one
        chip; sharded over `mesh`'s time axis when given). This is the
        approximate scaling mode -- the same re-lock-transient tolerance the
        reference accepts at its own chunk boundaries (SURVEY 2.4)."""
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = bw
        self.p = params
        self.cfg = cfg
        self.freq_fn = freq_fn      # optional per-chunk Doppler freq array fn
        self.block_size = int(block_size)
        self.dtype = dtype
        self.mesh = mesh
        if n_segments is None and mesh is not None:
            n_segments = int(mesh.shape["time"])
        self.n_segments = int(n_segments) if n_segments else 1
        self.warmup_symbols = int(warmup_symbols)
        self._useful = 0
        self._syncs = None
        # pass-2 incremental state
        self._consumed = 0        # minsync events fully absorbed
        self._open = None         # open correlation cluster
        self._prev_lm = None      # lastMin before the open cluster
        self._stale = None        # armed-window buffer left after the arming
        #                           end passed with no trigger (see
        #                           _maybe_snapshot_stale)

    @property
    def useful(self) -> int:
        return self._useful

    # ---------------------------------------------------------------- pass 1+2
    def get_syncs(self) -> list:
        if self._syncs is not None:
            return self._syncs
        p, cfg = self.p, self.cfg
        lp = iir.IirFilter.design_butter(self.src.sampFreq, self.bw, order=6,
                                         kind="lowpass")
        lp_state = lp.initial_state_step(jnp.float32).astype(jnp.complex64)
        scan_state = initial_state(p, len(cfg.sym_sync))
        sync_j = jnp.asarray(cfg.sym_sync, jnp.float32)
        sync1_j = jnp.asarray(cfg.sym_sync_alt, jnp.float32)

        # growing symbol history (host)
        a_idx: list = []          # global sample of each symbol's A event
        phases: list = []
        chosens: list = []
        minsyncs: list = []       # (symbol_number(ctr), global_sample)

        # stream retention for pass 2: a chain of the filtered device
        # blocks — no device-side copies, windows download on demand
        stream = _DeviceStreamChain()
        max_win = cfg.cap_entries // cfg.entries_per_sample \
            + cfg.cap_entries // cfg.entries_per_sample + 8

        max_syncs: list = []

        use_raw = unpack.supports_raw(self.src)
        parallel = self.n_segments > 1
        omega = (float(np.float32(-2 * np.pi * self.offset
                                  / self.src.sampFreq))
                 if self.offset != 0.0 else 0.0)
        no_anch = hostio.zeros((1,), jnp.float32)
        filt_prefix = hostio.zeros((0,), jnp.complex64)
        plan = plan_mod.plan_blocks(self.src.length, self.block_size)
        resident = callable(getattr(self.src, "read_raw_device", None))
        anch_cache: dict = {}

        def read_block(s, e):
            if resident:
                return self.src.read_raw_device(s, e)
            if use_raw:
                return hostio.device_put_u8(self.src.read_raw(s, e))
            return hostio.device_put(self.src.read(s, e), dtype=self.dtype)

        def block_nco(ci, s, e):
            if self.freq_fn is not None:
                return None, None                    # handled by caller
            if omega == 0.0:
                return 0.0, no_anch
            if (e - s) not in anch_cache:
                anch_cache[e - s] = hostio.device_put(
                    nco.phase_anchors(self.offset, self.src.sampFreq,
                                      0, e - s))
            return omega, anch_cache[e - s]

        if (self.mesh is None and self.freq_fn is None
                and self.block_size == PROC_CHUNKSIZE
                and self.src.length <= _CAPTURE_SEG_MAX):
            # whole-capture fast path: ONE dispatch (unpack + per-chunk NCO
            # + filter + scan + pack) and ONE packed download, sequential
            # or capture-level segmented
            if self.src.length not in anch_cache:
                anch_cache[self.src.length] = tuple(
                    hostio.device_put(nco.phase_anchors(
                        self.offset, self.src.sampFreq, 0, e - s))
                    for (s, e) in plan) if omega != 0.0 else (no_anch,)
            packed, x_f = _capture_pipeline(
                p, lp, read_block(0, self.src.length), lp_state, omega,
                anch_cache[self.src.length], tuple(plan), self.n_segments,
                self.warmup_symbols, sync_j, sync1_j)
            stream.append(x_f, 0)
            # sparse pass 2 (round 5): download only the minsync events and
            # the event-adjacent symbol spans the replay actually reads
            # (KBs), instead of the whole 3-f32-per-symbol tensor (MBs over
            # a ~10 MB/s link). Falls back to the exact dense download on
            # event overflow or a coverage miss.
            sparse = self._sparse_pass2_inputs(packed, parallel)
            if sparse is not None:
                view_s, minsyncs_s = sparse
                try:
                    self._syncs = self._replay_with_view(minsyncs_s, view_s,
                                                         stream)
                    return self._syncs
                except _CoverageError as e:
                    log.info("sparse pass-2 fell back to dense: %s", e)
                    self._consumed, self._open = 0, None
                    self._prev_lm, self._stale = None, None
            pk = hostio.device_get(packed)
            (valid, ai_all, ph_all, ch_all, mf_all,
             ow) = unpack_symbol_outs(pk)
            if parallel:
                seg_take = lambda col: np.concatenate(
                    [col[si][ow[si]] for si in range(self.n_segments)])
                ai = seg_take(ai_all)
                ph, ch, mf = (seg_take(ph_all), seg_take(ch_all),
                              seg_take(mf_all))
            else:
                ai = ai_all[valid]
                ph, ch, mf = ph_all[valid], ch_all[valid], mf_all[valid]
            a_idx.append(ai)
            phases.append(ph)
            chosens.append(ch)
            for k in np.flatnonzero(mf):
                minsyncs.append((k + 1, int(ai[k])))
            self._syncs = self._replay_with_view(
                minsyncs, _DenseSymbols(a_idx, phases, chosens), stream)
            return self._syncs

        for ci, (s, e) in enumerate(plan):
            if resident:
                # capture already on device: slice there, unpack in the
                # fused block pipeline
                x = self.src.read_raw_device(s, e)
            elif use_raw:
                x = hostio.device_put_u8(self.src.read_raw(s, e))
            else:
                x = hostio.device_put(self.src.read(s, e), dtype=self.dtype)
            if self.freq_fn is not None:
                # Doppler path: per-sample frequency track (host-computed),
                # mixed outside the fused pipeline
                if x.dtype == jnp.uint8:
                    x = jax.jit(unpack.iq_u8_to_complex)(x)
                freqs = self.freq_fn(ci, len(plan), e - s)
                x = nco.mix_array_freq(x, jnp.asarray(freqs, jnp.float32),
                                       self.src.sampFreq, start=0)
                blk_omega, anch = 0.0, no_anch
            elif omega != 0.0:
                # chunk-local NCO phase (reference quirk: no chunker);
                # anchors depend only on the block LENGTH (local indices)
                if (e - s) not in anch_cache:
                    anch_cache[e - s] = hostio.device_put(
                        nco.phase_anchors(self.offset, self.src.sampFreq,
                                          0, e - s))
                blk_omega, anch = omega, anch_cache[e - s]
            else:
                blk_omega, anch = 0.0, no_anch

            # ONE dispatch + ONE download per block
            if parallel and self.mesh is None:
                prefix = int(filt_prefix.shape[0])
                packed, x_f, filt_prefix, lp_state = _block_pipeline_seg(
                    p, lp, x, lp_state, blk_omega, anch, filt_prefix,
                    self.n_segments, self.warmup_symbols, sync_j, sync1_j)
                pk = hostio.device_get(packed)
                _, ai_all, ph_all, ch_all, mf_all, ow = unpack_symbol_outs(pk)
                seg_take = lambda col: np.concatenate(
                    [col[si][ow[si]] for si in range(self.n_segments)])
                ai = seg_take(ai_all) - prefix + s
                ph = seg_take(ph_all)
                ch = seg_take(ch_all)
                mf = seg_take(mf_all)
            elif parallel:
                # mesh-sharded segment scan (dryrun / pod path)
                if x.dtype == jnp.uint8:
                    x = jax.jit(unpack.iq_u8_to_complex)(x)
                if blk_omega != 0.0:
                    x = nco.mix(x, np.float32(blk_omega), anch)
                x, lp_state = lp.apply(x, lp_state)
                if int(filt_prefix.shape[0]):
                    xw = jnp.concatenate([filt_prefix, x])
                else:
                    xw = x
                prefix = int(filt_prefix.shape[0])
                outs, owned = symbol_scan_segments(
                    p, xw, sync_j, sync1_j, self.n_segments,
                    self.warmup_symbols, owned_start=prefix, mesh=self.mesh)
                pk = hostio.device_get(pack_symbol_outs_owned(outs, owned))
                _, ai_all, ph_all, ch_all, mf_all, ow = unpack_symbol_outs(pk)
                seg_take = lambda col: np.concatenate(
                    [col[si][ow[si]] for si in range(self.n_segments)])
                ai = seg_take(ai_all) - prefix + s
                ph = seg_take(ph_all)
                ch = seg_take(ch_all)
                mf = seg_take(mf_all)
                warm = int(self.warmup_symbols * p.symbol_period)
                filt_prefix = xw[-warm:]
                x_f = x
            else:
                packed, x_f, lp_state, scan_state = _block_pipeline_seq(
                    p, lp, x, lp_state, blk_omega, anch, scan_state,
                    sync_j, sync1_j)
                pk = hostio.device_get(packed)
                (valid, ai_all, ph_all, ch_all, mf_all,
                 _ow) = unpack_symbol_outs(pk)
                ai = ai_all[valid] + s
                ph = ph_all[valid]
                ch = ch_all[valid]
                mf = mf_all[valid]
            base_ctr = sum(len(a) for a in a_idx)
            a_idx.append(ai)
            phases.append(ph)
            chosens.append(ch)
            for k in np.flatnonzero(mf):
                minsyncs.append((base_ctr + k + 1, int(ai[k])))

            # pass 2 incremental processing with the available stream span
            # (device-resident blocks; only correlation windows download)
            stream.append(x_f, s)
            max_syncs = self._drain_corr_jobs(
                minsyncs, a_idx, phases, chosens, stream, stream.lo,
                stream.hi, max_syncs,
                final=(ci == len(plan) - 1))
            stream.prune(stream.hi - max_win)

        self._syncs = self._finalize(max_syncs)
        return self._syncs

    # ---------------------------------------------------------------- helpers
    def _replay_with_view(self, minsyncs, view, stream) -> list:
        """Dry-run the replay to discover the needed windows, batch them in
        ONE gather+download, then replay for real (the walk's control flow
        never depends on window sample values), and finalize."""
        snap = (self._consumed, dict(self._open) if self._open else None,
                self._prev_lm, dict(self._stale) if self._stale else None)
        rec = _RecordingStream(stream)
        self._dry_run = True
        try:
            self._drain_corr_jobs(minsyncs, view, None, None, rec,
                                  stream.lo, stream.hi, [], final=True)
        finally:
            self._dry_run = False
        (self._consumed, self._open, self._prev_lm, self._stale) = snap
        cache = _prefetch_windows(stream, rec.ranges)
        max_syncs = self._drain_corr_jobs(
            minsyncs, view, None, None, _CachedStream(stream, cache),
            stream.lo, stream.hi, [], final=True)
        return self._finalize(max_syncs)

    def _sparse_pass2_inputs(self, packed, use_owned: bool):
        """Build (symbols view, minsyncs) for pass 2 from the device-resident
        packed tensor with ~KB downloads: ONE event download plus ONE span
        gather sized by the arming geometry. Returns None when the event
        record overflowed (dense fallback)."""
        p, cfg = self.p, self.cfg
        flat, tbl = _events_and_table(packed, _MAX_EVENTS, use_owned)
        fl = hostio.device_get(flat)
        n_ev, n_sym = int(fl[-2]), int(fl[-1])
        if n_ev > _MAX_EVENTS:
            return None
        ev = fl[:-2].reshape(_MAX_EVENTS, 3)[:n_ev]
        ctrs = ev[:, 0].astype(np.int64)
        samps = ev[:, 1].astype(np.int64) * 4096 + ev[:, 2].astype(np.int64)
        minsyncs = [(int(c), int(s)) for c, s in zip(ctrs, samps)]
        if n_ev == 0:
            return _SparseSymbols([], n_sym), minsyncs
        # span geometry: each event's replay reads phases over the
        # correlation window ([first - cap, last + countdown] in samples),
        # the arm boundary symbols of the previous event (prev + arm_pre /
        # arm_end), and the stale-window tail before arm_end
        T = p.symbol_period
        cap_samples = cfg.cap_entries // cfg.entries_per_sample
        countdown = cfg.cap_entries + 1
        back = int((cap_samples + countdown) / T) + 64
        fwd = int(countdown / T) + 64
        back2 = int(cap_samples / T) + 16
        size = min(n_sym, back + fwd)
        if size <= 0:
            return _SparseSymbols([], n_sym), minsyncs
        starts: set = set()
        for c in ctrs:
            j = int(c) - 1
            starts.add(j - back)
            starts.add(j + cfg.arm_pre_syms - 16)
            starts.add(j + cfg.arm_end_syms - back2 - 16)
        lim = max(0, n_sym - size)
        rows = sorted({max(0, min(int(s), lim)) for s in starts})
        hl = np.stack([(np.asarray(rows, np.int64) // 4096)
                       .astype(np.float32),
                       (np.asarray(rows, np.int64) % 4096)
                       .astype(np.float32)])
        got = hostio.device_get(
            _gather_table_rows(tbl, jnp.asarray(hl), size))
        spans = []
        for s0, row in zip(rows, got):
            col0 = row[:, 0].astype(np.int64)
            ch = col0 // 32768
            a = (col0 % 32768) * 4096 + row[:, 1].astype(np.int64)
            spans.append((s0, a, row[:, 2].astype(np.float64), ch))
        # merge overlapping rows into disjoint spans (row starts are sorted;
        # fixed row size makes the overlap a pure prefix drop)
        merged = []
        for s0, a, ph, ch in spans:
            if merged and s0 < merged[-1][0] + len(merged[-1][1]):
                keep = merged[-1][0] + len(merged[-1][1]) - s0
                if keep >= len(a):
                    continue
                m0, ma, mp, mc = merged[-1]
                merged[-1] = (m0, np.concatenate([ma, a[keep:]]),
                              np.concatenate([mp, ph[keep:]]),
                              np.concatenate([mc, ch[keep:]]))
            else:
                merged.append((s0, a, ph, ch))
        return _SparseSymbols(merged, n_sym), minsyncs

    def _drain_corr_jobs(self, minsyncs, a_idx, phases, chosens,
                         stream, lo, hi, max_syncs, final=False):
        """Advance the arming/countdown state machine over newly seen minsync
        events; run correlations whose countdown completes inside the
        available stream [lo, hi). `stream` is a _DeviceStream/_HostStream
        (a raw numpy span is adapted for direct callers/tests). `a_idx` is
        either the per-chunk list of symbol sample indices (dense, with
        `phases`/`chosens` the matching lists) or an already-built symbols
        view (_DenseSymbols/_SparseSymbols; `phases`/`chosens` then None)."""
        if isinstance(stream, np.ndarray):
            stream = _HostStream(stream, lo)
        cfg = self.cfg
        eps = cfg.entries_per_sample
        cap_samples = cfg.cap_entries // eps
        countdown = cfg.cap_entries + 1          # samples past the last trigger

        view = (a_idx if isinstance(a_idx, (_DenseSymbols, _SparseSymbols))
                else _DenseSymbols(a_idx, phases, chosens))

        while True:
            if self._open is None:
                if self._consumed >= len(minsyncs):
                    # arming window may have closed with no trigger this
                    # chunk: preserve its buffer for a later-cluster replay
                    self._maybe_snapshot_stale(
                        None, view, stream, lo, hi, cap_samples)
                    break
                ctr_t, samp_t = minsyncs[self._consumed]
                self._maybe_snapshot_stale(
                    ctr_t, view, stream, lo, hi, cap_samples)
                self._consumed += 1
                self._open = {"first": samp_t, "first_ctr": ctr_t,
                              "last": samp_t, "last_ctr": ctr_t,
                              "prev_lm": self._prev_lm}
            # absorb retriggers within the countdown (retain reset,
            # ref decode_funcube.py:294)
            while (self._consumed < len(minsyncs)
                   and minsyncs[self._consumed][1]
                   <= self._open["last"] + countdown):
                ctr_t, samp_t = minsyncs[self._consumed]
                self._consumed += 1
                self._open["last"] = samp_t
                self._open["last_ctr"] = ctr_t
            corr_at = self._open["last"] + countdown
            if corr_at >= hi:
                if final:
                    # capture ended mid-countdown: the reference never
                    # correlates this cluster
                    self._prev_lm = self._open["last_ctr"]
                    self._open = None
                    self._stale = None
                    continue
                break
            prev_lm = self._open["prev_lm"]
            we = corr_at
            past_end = (prev_lm is not None
                        and self._open["first_ctr"]
                        > prev_lm + cfg.arm_end_syms)
            if past_end:
                # the trigger fired AFTER the arming window closed
                # (ctr > lastMin + arm_end_syms, ref decode_funcube.py:241's
                # end clause): the reference's buffer then holds the STALE
                # tail of the closed armed window plus the fresh countdown
                # samples after the trigger, and it reports
                # maxBuffStart + argmax over that discontiguous buffer as if
                # it were contiguous -- reproduced verbatim.
                fresh_ws = max(self._open["first"] + 1, lo)
                vals = self._quantize_window(
                    stream.get(fresh_ws, we + 1), fresh_ws, view)
                report_ws = fresh_ws
                if self._stale is not None:
                    vals = np.concatenate([self._stale["vals"], vals])
                    report_ws = self._stale["ws"]
            else:
                # window start: pre-trigger sliding buffer begins at the
                # arming boundary of the *previous* frame's lastMin, capped
                # to the buffer size (ref decode_funcube.py:240-249)
                ws = self._open["first"] + 1
                if prev_lm is not None:
                    arm_samp = view.sym_sample(prev_lm + cfg.arm_pre_syms)
                    if arm_samp is not None and arm_samp + 1 < ws:
                        ws = max(arm_samp + 1,
                                 self._open["first"] + 1 - cap_samples)
                ws = max(ws, lo)
                vals = self._quantize_window(
                    stream.get(ws, we + 1), ws, view)
                report_ws = ws
            needle_i = 0
            if len(cfg.needles) > 1:
                needle_i = view.chosen_before(we)
            sync_pos = self._correlate_vals(vals, report_ws,
                                            cfg.needles[needle_i])
            max_syncs.append(sync_pos)
            log.info("MAXSYNC %s", sync_pos)
            self._prev_lm = self._open["last_ctr"]
            self._open = None
            self._stale = None
        return max_syncs

    def _maybe_snapshot_stale(self, next_ctr, view, stream, lo, hi,
                              cap_samples):
        """Capture the sliding buffer of an armed window that closed with no
        trigger (ref decode_funcube.py:240-241: buffering stops once
        ctr > lastMin + arm_end_syms but maxResBuff is only cleared by a
        correlation, so its last `cap` samples survive until the next
        trigger). Called with `next_ctr` = the next pending trigger's symbol
        count (None at chunk end when no trigger is pending)."""
        cfg = self.cfg
        if self._stale is not None or self._prev_lm is None:
            return
        boundary = self._prev_lm + cfg.arm_end_syms
        if next_ctr is not None and next_ctr <= boundary:
            return                      # window got a trigger: no stale buffer
        end_samp = view.sym_sample(boundary)
        if end_samp is None or end_samp >= hi:
            return                      # window still open / not streamed yet
        arm_samp = view.sym_sample(self._prev_lm + cfg.arm_pre_syms)
        ws = end_samp + 1 - cap_samples
        if arm_samp is not None:
            ws = max(ws, arm_samp + 1)
        ws = max(ws, lo)
        if ws > end_samp:
            return
        self._stale = {
            "ws": ws,
            "vals": self._quantize_window(
                stream.get(ws, end_samp + 1), ws, view)}

    def _quantize_window(self, seg: np.ndarray, ws: int, view) -> np.ndarray:
        """Rotate by the PLL phasor and quantize like the reference
        (ref decode_funcube.py:243 `lim(real(i*pllObj.output)/2)`)."""
        cfg = self.cfg
        n_arr = ws + np.arange(len(seg))
        ph = view.phase_at(n_arr)
        rot = seg * np.exp(-1j * ph)
        if cfg.entries_per_sample == 1:
            return _lim(np.real(rot) / 2.0)
        vals = np.empty(2 * len(seg))
        vals[0::2] = _lim(np.real(rot) / 2.0)
        vals[1::2] = _lim(np.imag(rot) / 2.0)
        return vals

    def _correlate_vals(self, vals: np.ndarray, report_ws: int,
                        needle: np.ndarray) -> float:
        """|correlate('same')| argmax, reported as maxBuffStart + argmax
        (ref decode_funcube.py:253-255). Runs as a HOST FFT: the windows
        are ~20k samples, too small to be worth a device dispatch each
        (ROADMAP S3 is to measure that on the GPU). During a dry-run replay
        (window prefetch discovery) the result is unused — skip."""
        if getattr(self, "_dry_run", False):
            return float(report_ws)
        n, k = len(vals), len(needle)
        m = 1 << max(n + k - 1, 2).bit_length()
        full = np.fft.irfft(np.fft.rfft(vals, m)
                            * np.fft.rfft(needle[::-1], m), m)[: n + k - 1]
        cor = np.abs(full[(k - 1) // 2: (k - 1) // 2 + n])
        am = int(np.argmax(cor))
        if self.cfg.entries_per_sample == 1:
            return float(report_ws + am)
        return float(report_ws + am / 2.0)

    def _finalize(self, max_syncs: list) -> list:
        cfg = self.cfg
        if max_syncs:
            d = np.abs(np.diff(max_syncs) - cfg.frame_spacing)
            if len(d) and np.min(d) < cfg.spacing_tol:
                self._useful = 1
            return list(max_syncs)[1:]
        return []
