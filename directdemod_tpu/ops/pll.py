"""Carrier/timing recovery: AGC + Costas loop + Gardner, as a symbol-rate scan.

Behavioral reference: the per-sample loops of `decode_funcube` / `decode_meteorm2`
(ref decode_funcube.py:17-103,235-298; decode_meteorm2.py:16-103,229-321):
  * AGC: slow DC tracker + amplitude tracker with a gain cap
    (ref decode_funcube.py:17-35)
  * Costas PLL (BPSK or QPSK error), alpha/beta loop with lock detection that
    halves the bandwidth on lock (ref decode_funcube.py:37-86)
  * Gardner timing recovery sampling mid/full symbol points
    (ref decode_funcube.py:264-274)
  * rolling hard-decision buffer compared against the frame sync word
    ("minsync", ref decode_funcube.py:277-294)

Device restructuring: the reference iterates every *sample* (2.048 MHz) in
Python; all state changes actually happen at *symbol* boundaries (the B
mid-point and A sample). The scan below advances event-by-event (2 events per
symbol) with `dynamic_slice` gathers, cutting the sequential length by the
samples-per-symbol factor (~170x for funcube) while computing bit-identical
state updates. Per-sample work (the max-sync buffering) is reconstructed
afterwards from the emitted per-symbol phase/positions (see models/psk_sync).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils import hostio


@dataclass(frozen=True)
class PskParams:
    """Static configuration for one detector variant."""
    fs: float                    # input sample rate
    sym_rate: float              # symbol rate (12000 funcube, 72000 meteor)
    qpsk: bool                   # costas error form
    agc_mean0: float             # AGC amplitude-tracker init (180 / 3)
    agc_gain_cap: float          # gain cap (20 / 200)
    costas_bw: float             # loop bandwidth (0.05235833333*6 / 0.008727)
    costas_damping: float = 0.70710678118
    minsync_thresh: float = 0.0  # distance trigger (120 / 30)

    @property
    def symbol_period(self) -> float:
        return self.fs / self.sym_rate


class PskState(NamedTuple):
    stage: jnp.ndarray        # 0 = B pending, 1 = A pending
    anchor: jnp.ndarray       # local sample index of last A event
    timing: jnp.ndarray       # Gardner timing phase after last A
    g_b: jnp.ndarray          # last mid-symbol sample (post AGC)
    g_c: jnp.ndarray          # previous symbol sample (post AGC, pre PLL)
    agc_dc: jnp.ndarray
    agc_mean: jnp.ndarray
    phase: jnp.ndarray
    freq: jnp.ndarray
    pll_mean: jnp.ndarray
    locked: jnp.ndarray
    ctr: jnp.ndarray          # completed-symbol count
    last_min: jnp.ndarray     # symbol ctr of last minsync (-1 = none)
    buf: jnp.ndarray          # rolling hard-decision entries
    buf2: jnp.ndarray         # second buffer (meteor I/Q-swapped; unused bpsk)
    buf_fill: jnp.ndarray
    chosen: jnp.ndarray       # meteor needle selection (0/1/2)


class SymbolOut(NamedTuple):
    valid: jnp.ndarray
    a_idx: jnp.ndarray        # local sample index of the A event
    phase_out: jnp.ndarray    # PLL phase used for this symbol's rotation
    minsync: jnp.ndarray
    chosen: jnp.ndarray
    corrected: jnp.ndarray    # post-PLL symbol value


def initial_state(p: PskParams, sync_len: int) -> PskState:
    f32 = jnp.float32
    czero = hostio.zeros((), jnp.complex64)
    return PskState(
        stage=jnp.int32(0),
        anchor=jnp.int32(0),
        timing=f32(0.0),
        g_b=czero,
        g_c=czero,
        agc_dc=czero,
        agc_mean=f32(p.agc_mean0),
        phase=f32(0.0),
        freq=f32(0.001),
        pll_mean=f32(1.0),
        locked=jnp.bool_(False),
        ctr=jnp.int32(0),
        last_min=jnp.int32(-1),
        buf=jnp.zeros(sync_len, jnp.float32),
        buf2=jnp.zeros(sync_len, jnp.float32),
        buf_fill=jnp.int32(0),
        chosen=jnp.int32(0),
    )


def _alpha_beta(p: PskParams, locked):
    bw = jnp.where(locked, p.costas_bw / 2.0, p.costas_bw)
    denom = 1.0 + 2.0 * p.costas_damping * bw + bw * bw
    return (4 * p.costas_damping * bw) / denom, (4 * bw * bw) / denom


def _agc(p: PskParams, dc, mean, inp):
    """ref decode_funcube.py:22-35 (meteor variant differs in constants)."""
    dc2 = (dc * (1024.0 * 1024.0 - 1.0) + inp) / (1024.0 * 1024.0)
    v = inp - dc2
    mean2 = (mean * (65536.0 - 1.0) + jnp.abs(v)) / 65536.0
    gain = jnp.where(180.0 / mean2 > p.agc_gain_cap,
                     p.agc_gain_cap, 180.0 / mean2)
    return dc2, mean2, v * gain.astype(v.real.dtype)


def _hyp(x):
    """Quantized tanh lookup (ref decode_funcube.py:51-53,83-86): clamp to
    [-128, 127], floor(x+128) indexing."""
    xi = jnp.floor(x + 128.0)
    xi = jnp.clip(xi, 0.0, 255.0) - 128.0
    return jnp.where(x > 127.0, 1.0, jnp.where(x < -128.0, -1.0, jnp.tanh(xi)))


def _costas(p: PskParams, phase, freq, mean, locked, samp):
    """ref decode_funcube.py:60-81 / decode_meteorm2.py:59-81."""
    out_phasor = jnp.exp(-1j * phase).astype(jnp.complex64)
    corrected = samp * out_phasor
    re, im = jnp.real(corrected), jnp.imag(corrected)
    if p.qpsk:
        err = (im * _hyp(re) - re * _hyp(im)) / 255.0
    else:
        err = im * _hyp(re) / 255.0
    mean2 = (mean * 39999.0 + jnp.abs(err)) / 40000.0
    err = jnp.clip(err, -1.0, 1.0)
    alpha, beta = _alpha_beta(p, locked)
    # math.fmod semantics: result keeps the sign of the dividend
    raw = phase + freq + alpha * err
    phase2 = jnp.sign(raw) * jnp.mod(jnp.abs(raw), 2.0 * np.pi)
    freq2 = freq + beta * err
    locked2 = jnp.where(~locked & (mean2 < 0.2), True,
                        jnp.where(locked & (mean2 > 0.5), False, locked))
    return phase2, freq2, mean2, locked2, corrected


def _lim_bin(x):
    return jnp.where(x <= 0.0, 0.0, 1.0)


@partial(jax.jit, static_argnums=(0,))
def symbol_scan(p: PskParams, x: jnp.ndarray, state: PskState,
                sync: jnp.ndarray, sync1: jnp.ndarray
                ) -> tuple[PskState, SymbolOut]:
    """Run the event scan over one block of the filtered complex stream.

    `sync`: the 0/1 frame-sync pattern at symbol rate; `sync1`: the
    alternating-flipped QPSK ambiguity variant (pass `sync` again for BPSK).
    Events whose sample index falls beyond this block leave the state unchanged
    (they replay from the carried state in the next block).

    One scan step processes BOTH events of a symbol (the mid-symbol B sample
    and the decision A sample) back-to-back: B's only effect on A is the AGC
    state and `g_b`, both threaded straight through inside the step, so
    fusing halves the sequential length while staying bit-identical to the
    reference's per-sample walk (ref decode_funcube.py:261-298). The scan is
    unrolled 8x: every while-loop trip carries a fixed overhead that would
    otherwise dominate this scalar-recurrence-bound loop (the factor is not
    yet tuned on the GPU, ROADMAP S2)."""
    n = x.shape[0]
    T = p.symbol_period
    sync = jnp.asarray(sync, jnp.float32)
    sync1 = jnp.asarray(sync1, jnp.float32)
    slen = sync.shape[0]
    half = slen / 2.0

    # margin scales with n: worst-case cumulative Gardner timing drift
    # (|resync|*T/2e6 per symbol) can exceed a fixed +3 over the round-5
    # whole-capture path's 128M-sample scans; 4e-6 relative keeps the same
    # per-sample slack the old 20M-sample per-block loop re-amortized
    # (ADVICE r04)
    n_events = int(n / T) + 3 + int(n * 4e-6 / T)

    def push2(buf, v1, v2):
        return jnp.concatenate([buf[2:], jnp.stack([v1, v2])])

    def step(s: PskState, _):
        # B and A offsets are both functions of the SAME (anchor, timing):
        # timing/anchor only advance at A events, so when this step starts at
        # stage 0 both indices are known up front.
        at_b = s.stage == 0
        m_b = jnp.ceil(T / 2.0 - s.timing).astype(jnp.int32)
        m_a = jnp.ceil(T - s.timing).astype(jnp.int32)
        idx_b = s.anchor + m_b
        idx_a = s.anchor + m_a
        b_valid = at_b & (idx_b < n)
        # starting at stage 0, A may only run when B ran (idx_a >= idx_b
        # makes that implication automatic); starting at stage 1, B is a
        # carried value from the previous block
        a_valid = idx_a < n

        xb = lax.dynamic_slice(x, (jnp.clip(idx_b, 0, n - 1),), (1,))[0]
        xa = lax.dynamic_slice(x, (jnp.clip(idx_a, 0, n - 1),), (1,))[0]

        # ---- B event: AGC the mid-symbol sample
        dc_b, mean_b, gb_new = _agc(p, s.agc_dc, s.agc_mean, xb)
        dc1 = jnp.where(b_valid, dc_b, s.agc_dc)
        mean1 = jnp.where(b_valid, mean_b, s.agc_mean)
        g_b = jnp.where(b_valid, gb_new, s.g_b)

        # ---- A event: AGC, Gardner update, PLL, minsync
        dc_a, mean_a, ga = _agc(p, dc1, mean1, xa)
        resync = (jnp.imag(ga) - jnp.imag(s.g_c)) * jnp.imag(g_b)
        timing_a = s.timing + m_a.astype(jnp.float32) - T \
            + resync * T / 2000000.0
        ph2, fr2, pm2, lk2, corrected = _costas(
            p, s.phase, s.freq, s.pll_mean, s.locked, ga)
        ctr_a = s.ctr + 1

        if p.qpsk:
            gate = (s.last_min < 0) | (ctr_a > s.last_min + jnp.int32(0.1 * p.sym_rate))
            b1 = push2(s.buf, _lim_bin(jnp.real(corrected)),
                       _lim_bin(jnp.imag(corrected)))
            b2 = push2(s.buf2, _lim_bin(jnp.imag(corrected)),
                       _lim_bin(jnp.real(corrected)))
            buf_a = jnp.where(gate, b1, s.buf)
            buf2_a = jnp.where(gate, b2, s.buf2)
            fill_a = jnp.where(gate, jnp.minimum(s.buf_fill + 2, slen), s.buf_fill)
            full = fill_a >= slen
            c1 = jnp.abs(jnp.sum(jnp.abs(buf_a - sync)) - half)
            c4 = jnp.abs(jnp.sum(jnp.abs(buf2_a - sync1)) - half)
            hit1 = full & gate & (c1 > p.minsync_thresh)
            hit4 = full & gate & (c4 > p.minsync_thresh)
            # needle choice, last assignment wins (ref decode_meteorm2.py:307-312)
            chosen_a = s.chosen
            chosen_a = jnp.where(hit1, 0, chosen_a)
            chosen_a = jnp.where(hit4, 2, chosen_a)
            is_min = hit1 | hit4
        else:
            buf_a = jnp.concatenate([s.buf[1:],
                                     _lim_bin(jnp.real(corrected))[None]])
            buf2_a = s.buf2
            fill_a = jnp.minimum(s.buf_fill + 1, slen)
            full = fill_a >= slen
            dist = jnp.abs(jnp.sum(jnp.abs(buf_a - sync)) - half)
            is_min = full & (dist > p.minsync_thresh)
            chosen_a = s.chosen
        last_min_a = jnp.where(is_min, ctr_a, s.last_min)

        def sel(a_val, old):
            return jnp.where(a_valid, a_val, old)

        new = PskState(
            # A ran -> next symbol starts at B; only B ran (or a carried
            # stage-1 step hit the block end) -> A still pending
            stage=jnp.where(a_valid, jnp.int32(0),
                            jnp.where(b_valid | ~at_b, jnp.int32(1),
                                      jnp.int32(0))),
            anchor=sel(idx_a, s.anchor),
            timing=sel(timing_a, s.timing),
            g_b=g_b,
            g_c=sel(ga, s.g_c),
            agc_dc=sel(dc_a, dc1),
            agc_mean=sel(mean_a, mean1),
            phase=sel(ph2, s.phase),
            freq=sel(fr2, s.freq),
            pll_mean=sel(pm2, s.pll_mean),
            locked=sel(lk2, s.locked),
            ctr=sel(ctr_a, s.ctr),
            last_min=sel(last_min_a, s.last_min),
            buf=sel(buf_a, s.buf),
            buf2=sel(buf2_a, s.buf2),
            buf_fill=sel(fill_a, s.buf_fill),
            chosen=sel(chosen_a, s.chosen),
        )
        out = SymbolOut(
            valid=a_valid,
            a_idx=idx_a,
            phase_out=s.phase,       # phasor in effect during this symbol
            minsync=a_valid & is_min,
            chosen=chosen_a,
            corrected=corrected,
        )
        return new, out

    return lax.scan(step, state, None, length=n_events, unroll=8)


@jax.jit
def pack_symbol_outs(outs: SymbolOut, owned=None) -> jnp.ndarray:
    """Pack the per-symbol output streams into ONE float32 tensor
    (..., n_events, 3) = [flags<<14 | a_idx_hi, a_idx_lo, phase] so the whole
    block's results cross the link in a single compact download (the
    download scales with capture length, so the booleans ride as one
    bit-packed float). flags = valid | minsync<<1 |
    chosen<<2 | owned<<4 (all < 2^5, exact in f32); a_idx rides as an
    exact (hi, lo) f32 pair, a_idx = hi*4096 + lo."""
    hi = jnp.floor_divide(outs.a_idx, 4096).astype(jnp.float32)
    lo = jnp.remainder(outs.a_idx, 4096).astype(jnp.float32)
    flags = (outs.valid.astype(jnp.float32)
             + 2.0 * outs.minsync.astype(jnp.float32)
             + 4.0 * outs.chosen.astype(jnp.float32))
    if owned is not None:
        flags = flags + 16.0 * owned.astype(jnp.float32)
    # flags (<32) fold into the hi field: flags*2^15 + hi < 2^20, exact in
    # f32 for any a_idx < 2^27 = 134M samples (covers the whole-capture
    # fast path's 128M cap; per-block paths are far smaller)
    return jnp.stack([flags * 32768.0 + hi, lo, outs.phase_out], axis=-1)


@jax.jit
def pack_symbol_outs_owned(outs: SymbolOut, owned) -> jnp.ndarray:
    """pack_symbol_outs with the segment-ownership mask in flags bit 4."""
    return pack_symbol_outs(outs, owned)


def unpack_symbol_outs(packed: np.ndarray):
    """Host-side inverse of pack_symbol_outs: returns (valid, a_idx, phase,
    chosen, minsync, owned) numpy arrays (unfiltered; apply the masks).
    `owned` is all-False unless the pack carried an ownership mask."""
    col0 = packed[..., 0].astype(np.int64)
    flags, hi = col0 // 32768, col0 % 32768
    a_idx = hi * 4096 + packed[..., 1].astype(np.int64)
    return ((flags & 1) > 0, a_idx, packed[..., 2],
            (flags >> 2) & 3, (flags & 2) > 0, (flags & 16) > 0)


def segment_plan(n: int, n_segments: int, warmup_symbols: int,
                 symbol_period: float, owned_start: int = 0
                 ) -> list[tuple[int, int, int]]:
    """(start, end, scan_from) spans for block-parallel PLL processing.

    Each segment owns an equal slice of [owned_start, n) but starts scanning
    `warmup_symbols` earlier (clamped at 0) so AGC/Costas/Gardner re-lock
    before the owned region -- the same transient tolerance the reference
    accepts at its own chunk boundaries (SURVEY 2.4). `owned_start` lets a
    caller prepend warmup context from the previous stream block so segment 0
    re-locks too (it has no warmup only at the true start of the capture).
    """
    per = -(-(n - owned_start) // n_segments)
    warm = int(warmup_symbols * symbol_period)
    plan = []
    for i in range(n_segments):
        s = owned_start + i * per
        e = min(n, s + per)
        plan.append((s, e, max(0, s - warm)))
    return plan


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _segments_core(p: PskParams, x, syncs, n_segments: int,
                   warmup_symbols: int, owned_start: int):
    """Single-dispatch segment scan: pad + gather + broadcast init + vmapped
    scan + ownership mask all inside one jit (one dispatch, not one per
    eager op)."""
    sync, sync1 = syncs
    n = int(x.shape[0])
    plan = segment_plan(n, n_segments, warmup_symbols, p.symbol_period,
                        owned_start)
    seg_len = max(e - sf for (_, e, sf) in plan)
    starts = jnp.asarray([sf for (_, _, sf) in plan], jnp.int32)
    owned_from = jnp.asarray([s for (s, _, _) in plan], jnp.int32)
    owned_to = jnp.asarray([e for (_, e, _) in plan], jnp.int32)

    xp = jnp.pad(x, (0, seg_len))
    segs = jax.vmap(lambda s0: lax.dynamic_slice(xp, (s0,), (seg_len,)))(starts)

    init = initial_state(p, int(jnp.asarray(sync).shape[0]))
    init_b = jax.tree.map(
        lambda v: jnp.broadcast_to(v, (n_segments,) + v.shape), init)
    _, outs = jax.vmap(
        lambda xs, st: symbol_scan(p, xs, st, sync, sync1))(segs, init_b)
    a_global = outs.a_idx + starts[:, None]
    owned = outs.valid & (a_global >= owned_from[:, None]) \
        & (a_global < owned_to[:, None])
    return outs._replace(a_idx=a_global), owned


def symbol_scan_segments(p: PskParams, x: jnp.ndarray, sync, sync1,
                         n_segments: int, warmup_symbols: int = 2000,
                         owned_start: int = 0, mesh=None):
    """Run `symbol_scan` independently over overlapping segments (vmapped --
    the parallel/approximate mode; exact sequential mode is `symbol_scan`).

    Returns per-segment SymbolOut plus an `owned` mask that drops warmup
    symbols (those whose A-sample falls before the segment's owned region).
    a_idx values are global (in x's coordinates). With `mesh`, the segment
    axis is sharded over the mesh's `time` axis so the vmapped scans run one
    per device under the SPMD partitioner.
    """
    sync = jnp.asarray(sync, jnp.float32)
    sync1 = jnp.asarray(sync1, jnp.float32)
    if mesh is None:
        return _segments_core(p, x, (sync, sync1), n_segments,
                              warmup_symbols, owned_start)

    n = int(x.shape[0])
    plan = segment_plan(n, n_segments, warmup_symbols, p.symbol_period,
                        owned_start)
    seg_len = max(e - sf for (_, e, sf) in plan)
    starts = jnp.asarray([sf for (_, _, sf) in plan], jnp.int32)
    owned_from = jnp.asarray([s for (s, _, _) in plan], jnp.int32)
    owned_to = jnp.asarray([e for (_, e, _) in plan], jnp.int32)

    xp = jnp.pad(x, (0, seg_len))
    segs = jax.vmap(lambda s0: lax.dynamic_slice(xp, (s0,), (seg_len,)))(starts)

    slen = jnp.asarray(sync).shape[0]
    init = initial_state(p, slen)
    init_b = jax.tree.map(lambda v: jnp.broadcast_to(v, (n_segments,) + v.shape),
                          init)
    scan_f = lambda xs, st: symbol_scan(p, xs, st, sync, sync1)
    # route through the SPMD partitioner: one segment scan per device
    from jax.sharding import NamedSharding, PartitionSpec as P
    xspec = NamedSharding(mesh, P("time", None))
    sspec = jax.tree.map(
        lambda v: NamedSharding(
            mesh, P(*(("time",) + (None,) * (v.ndim - 1)))), init_b)
    _, outs = jax.jit(jax.vmap(scan_f),
                      in_shardings=(xspec, sspec))(segs, init_b)
    a_global = outs.a_idx + starts[:, None]
    owned = outs.valid & (a_global >= owned_from[:, None]) \
        & (a_global < owned_to[:, None])
    return outs._replace(a_idx=a_global), owned
