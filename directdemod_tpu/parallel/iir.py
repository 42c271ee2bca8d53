"""Exact time-sharded IIR filtering (and zero-phase filtfilt) over a mesh.

The single-device engine (ops/iir.IirFilter) already evaluates each biquad as
zero-state convolution + a boundary-state recurrence over fixed-size blocks.
Sharding the time axis reuses the same linearity one level up: each shard
filters its local span from a ZERO incoming state, and the true incoming
state's contribution is added afterwards as a rank-2 correction

    y_local(t) += s_in . (C A^t)          (zero-input response)
    s_out       = s_in . (A^T)^n + g      (g = shard's zero-state final state)

so the only cross-shard data is the per-section 2-vector aggregate `g`: one
`all_gather` of (ndev, 2) floats per biquad, then every shard folds the
aggregates of its predecessors through host-precomputed powers of A. The
result is bit-comparable to the sequential cascade (same block decomposition,
same constants) -- not a warmup-halo approximation.

Used by the NOAA image stage (`--mesh` decode): the zero-phase 400-4400 Hz
bandpass (ref decode_noaa.py:274) runs forward+backward sharded, with the
filtfilt reflect padding (39 samples) and the ragged tail handled exactly by
a sequential epilogue on the carried state.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.iir import IirFilter, _biquad_state_space, _mm
from ..utils import hostio


@lru_cache(maxsize=32)
def _shard_consts(filt: IirFilter, n_local: int):
    """Per-section host constants for an n_local-sample shard:
    W (n_local, 2) rows C A^t (zero-input response basis) and M = (A^T)^n."""
    out = []
    for s in filt.sos:
        A, B, C, D = _biquad_state_space(s)
        # rows C A^t by doubling: W_{2k} = [W_k ; W_k A^k]
        W = C[None, :].copy()
        Ak = A.copy()
        while W.shape[0] < n_local:
            W = np.concatenate([W, W @ Ak])
            Ak = Ak @ Ak
        W = W[:n_local]
        M = np.linalg.matrix_power(A, n_local).T
        out.append((W, M))
    return out


@lru_cache(maxsize=32)
def _mpow(filt: IirFilter, n_local: int, ndev: int):
    """Powers M^0..M^ndev of each section's shard-transition matrix."""
    pows = []
    for (W, M) in _shard_consts(filt, n_local):
        p = [np.eye(2)]
        for _ in range(ndev):
            p.append(p[-1] @ M)
        pows.append(np.stack(p))
    return pows


@partial(jax.jit, static_argnums=(0, 1))
def _sharded_lfilter(mesh, filt: IirFilter, x2d, zi):
    """x2d: (ndev, n_local) sharded over `time`; zi: (2 * n_sections,) initial
    state of the GLOBAL stream.

    Returns (y2d sharded like x2d, per-shard exit states (ndev, 2*ns)); the
    global final state is the last shard's row.
    """
    ndev = mesh.shape["time"]
    n_local = int(x2d.shape[1])
    L = min(filt.block, max(16, n_local))
    np_last = n_local - (-(-n_local // L) - 1) * L
    consts = filt._consts(L)
    consts_tail = consts if np_last == L else filt._consts(np_last)
    sec = _shard_consts(filt, n_local)
    pows = _mpow(filt, n_local, ndev)

    def body(local, zi_in):
        y = local[0]
        rdt = jnp.float64 if y.dtype in (jnp.float64, jnp.complex128) \
            else jnp.float32
        pos = lax.axis_index("time")
        zis = zi_in.reshape(filt.n_sections, 2).astype(rdt)
        z_out = []
        for i in range(filt.n_sections):
            W = jnp.asarray(sec[i][0], dtype=rdt)
            M = jnp.asarray(sec[i][1], dtype=rdt)
            Mp = jnp.asarray(pows[i], dtype=rdt)       # (ndev+1, 2, 2)
            y0, g = filt._apply_section(y, jnp.zeros(2, rdt), consts[i],
                                        consts_tail[i], np_last)
            gg = lax.all_gather(g, "time")             # (ndev, 2)
            # s_in = zi . M^pos + sum_{j<pos} g_j . M^(pos-1-j)
            s_in = _mm(zis[i], Mp[pos])
            for j in range(ndev - 1):
                term = _mm(gg[j], Mp[jnp.clip(pos - 1 - j, 0, ndev)])
                s_in = s_in + jnp.where(j < pos, term, jnp.zeros_like(term))
            corr = _mm(W, s_in).astype(y0.dtype)
            y = y0 + corr
            z_out.append(_mm(s_in, M) + g)
        return y[None], jnp.stack(z_out).reshape(-1)[None].astype(zi_in.dtype)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("time", None), P(None)),
        out_specs=(P("time", None), P("time", None)),
        check_vma=False)(x2d, zi)


def sharded_lfilter(mesh, filt: IirFilter, x: np.ndarray, zi: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Exact lfilter of a long 1-D host signal over the mesh's `time` axis;
    the ragged tail (len(x) % ndev) runs sequentially from the carried state.
    Returns (y, final_state)."""
    ndev = mesh.shape["time"]
    n = len(x)
    n_local = n // ndev
    main = n_local * ndev
    zi = jnp.asarray(zi)
    if n_local == 0:
        y, zf = filt.apply(jnp.asarray(x), zi)
        return np.asarray(y), np.asarray(zf)
    x2d = hostio.device_put(np.ascontiguousarray(x[:main]).reshape(ndev, n_local),
                            sharding=NamedSharding(mesh, P("time", None)))
    y2d, zs = _sharded_lfilter(mesh, filt, x2d, zi)
    y = hostio.global_get(y2d).reshape(-1)
    zf = hostio.global_get(zs)[-1]
    if main < n:
        yt, zf = filt.apply(jnp.asarray(x[main:]), jnp.asarray(zf))
        y = np.concatenate([y, np.asarray(yt)])
        zf = np.asarray(zf)
    return y, zf


def sharded_zero_phase(mesh, filt: IirFilter, x: np.ndarray) -> np.ndarray:
    """scipy filtfilt 'pad' (ref filters.py:73) sharded over `time`; exact
    (matches ops/iir.IirFilter.zero_phase up to fp association)."""
    b, a = filt.ba()
    padlen = 3 * max(len(b), len(a))
    n = len(x)
    if n <= padlen:
        raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
    head = 2 * x[0] - x[1:padlen + 1][::-1]
    tail = 2 * x[-1] - x[-padlen - 1:-1][::-1]
    ext = np.concatenate([head, x, tail])
    zi = np.asarray(filt.initial_state_step(
        jnp.float64 if x.dtype in (np.float64, np.complex128) else jnp.float32))
    yf, _ = sharded_lfilter(mesh, filt, ext, zi * ext[0])
    yr = yf[::-1]
    yb, _ = sharded_lfilter(mesh, filt, yr, zi * yr[0])
    return yb[::-1][padlen:padlen + n]
