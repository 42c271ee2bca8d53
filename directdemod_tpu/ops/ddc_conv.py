"""Dense byte-domain DDC: the whole `unpack -> NCO -> FIR -> decimate` chain
(ref decode_noaa.py:617-624 / source.py:117-118 byte contract) as ONE
aligned bf16 matmul over 128-byte rows.

Why this shape: a direct lowering runs one sliver dot of (outputs, 2J) x
(2J, 2) per output block -- N=2 output columns, far too thin for a matrix
unit. This lowering keeps the raw interleaved IQ bytes in their natural
linear order and *chooses the math to fit the hardware*:

  * The byte stream reshapes (bitcast-free) to rows of 128 bytes, so loads
    are dense and unpadded.
  * Outputs group by the polyphase period:  G = 128/gcd(2J, 128) consecutive
    outputs share a window of P = 2J*G/128 rows (plus a small spill).  The
    group's G complex outputs become 2G *output channels* of a single
    matmul/conv with contraction over the whole (W_rows x 128) byte window:
    M = n_groups, K = W_rows*128 (~2.4k), N = 2G (64 for the NOAA J=34 chain).
  * The taps (including the -127.5 byte offset, the NCO modulation and the
    interleaved I/Q sign structure) are baked HOST-SIDE in fp64 into a
    structured-sparse kernel tensor ker[r, l, ch], so the device program is
    literally `bytes-matrix @ constant` plus a constant subtract.
  * Precision: the bytes are integers 0..255, EXACT in bfloat16.  The f32
    tap tensor is split into `nsplit` bf16 residual parts host-side
    (hi/mid/lo); `sum_s bytes @ part_s` with f32 accumulation reproduces
    full f32-tap accuracy in `nsplit` single-pass bf16 matmuls, because the
    byte operand never needs splitting (docs/experiments.md D2). TF32 never
    applies: the operands are bf16.

The structured kernel wastes MACs (K ~ 2432 vs 302 live taps per output, a
~8x pad; ROADMAP S7) but is one dense GEMM. On an NVIDIA H100 it runs the
fused chain 3.4x faster than the XLA polyphase conv (bench.py; numbers in
CHANGES.md), so `models/frontend.frontend_lowering` picks it on the GPU.
"""
from __future__ import annotations

from functools import partial
from math import gcd

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

import ml_dtypes


class BytePlan:
    """Host-side compilation of (reversed modulated taps, stride) into the
    dense byte-domain kernel tensors.

    Output m of the plan covers bytes seg[2*m*J .. 2*(m*J+K)) of the byte
    segment it is applied to, i.e. complex samples x[m*J .. m*J+K), exactly
    the window contract of ops/fir.fir_decimate.
    """

    def __init__(self, taps_rev: np.ndarray, stride: int, nsplit: int = 3):
        J = int(stride)
        w = np.asarray(taps_rev, dtype=np.complex128)
        K = w.shape[0]
        twoJ = 2 * J
        g = gcd(twoJ, 128)
        self.J, self.K = J, K
        self.G = 128 // g                 # outputs per group
        self.P = twoJ // g                # 128-byte rows per group
        self.W = ((self.G - 1) * twoJ + 2 * K - 1) // 128 + 1   # window rows
        self.nsplit = int(nsplit)

        self.taps_rev = w                 # fp64, for the oracle
        # byte-domain tap vectors: x[s] = (b[2s]-127.5) + 1j (b[2s+1]-127.5)
        v_re = np.zeros(2 * K)
        v_im = np.zeros(2 * K)
        v_re[0::2], v_re[1::2] = np.real(w), -np.imag(w)
        v_im[0::2], v_im[1::2] = np.imag(w), np.real(w)
        self.off_re = 127.5 * float(np.sum(v_re))
        self.off_im = 127.5 * float(np.sum(v_im))

        # ker[r, l, p] = v[128 r + l - 2J p]   (structured band)
        u = (128 * np.arange(self.W)[:, None, None]
             + np.arange(128)[None, :, None]
             - twoJ * np.arange(self.G)[None, None, :])
        valid = (u >= 0) & (u < 2 * K)
        uc = np.clip(u, 0, 2 * K - 1)
        ker = np.concatenate([np.where(valid, v_re[uc], 0.0),
                              np.where(valid, v_im[uc], 0.0)], axis=2)

        parts, resid = [], ker
        for _ in range(self.nsplit):
            p = resid.astype(ml_dtypes.bfloat16)
            parts.append(p)
            resid = resid - p.astype(np.float64)
        self.parts = parts                # list of (W, 128, 2G) bf16

    # value-hashed: BytePlan rides as a static jit argument (see DdcFm.__hash__
    # for the measured retrace cost of the default id() hash)
    def __hash__(self):
        return hash((self.J, self.K, self.nsplit,
                     self.parts[0].tobytes()))

    def __eq__(self, other):
        return (isinstance(other, BytePlan) and self.J == other.J
                and self.nsplit == other.nsplit
                and len(self.parts) == len(other.parts)
                and all(np.array_equal(a, b)
                        for a, b in zip(self.parts, other.parts)))

    def rows_needed(self, out_len: int) -> int:
        a = -(-out_len // self.G)
        return (a - 1) * self.P + self.W

    # ------------------------------------------------------------- device
    def _ker(self, s: int) -> jnp.ndarray:
        # closed-over numpy bakes into the executable without a transfer
        return jnp.asarray(self.parts[s], dtype=jnp.bfloat16)

    def _finish(self, out, out_len: int):
        g = self.G
        re = out[:, :g].reshape(-1)[:out_len] - jnp.float32(self.off_re)
        im = out[:, g:].reshape(-1)[:out_len] - jnp.float32(self.off_im)
        return re, im

    def _rows(self, seg: jnp.ndarray, out_len: int, extra_rows: int = 0):
        r = self.rows_needed(out_len) + extra_rows
        need = r * 128
        segp = seg
        if seg.shape[0] < need:
            segp = jnp.pad(seg, (0, need - seg.shape[0]))
        else:
            segp = lax.slice(segp, (0,), (need,))
        return segp.reshape(r, 128).astype(jnp.bfloat16)

    @partial(jax.jit, static_argnums=(0, 2))
    def apply_conv(self, seg: jnp.ndarray, out_len: int):
        """conv_general_dilated lowering: input (1, rows, 128) channels=lanes,
        kernel (W, 128, 2G), stride P rows.  Returns (re, im) f32."""
        rows = self._rows(seg, out_len)
        a = -(-out_len // self.G)
        acc = None
        for s in range(self.nsplit):
            o = lax.conv_general_dilated(
                rows[None], self._ker(s), window_strides=(self.P,),
                padding="VALID", dimension_numbers=("NHC", "HIO", "NHC"),
                preferred_element_type=jnp.float32)
            acc = o if acc is None else acc + o
        return self._finish(acc[0, :a], out_len)

    @partial(jax.jit, static_argnums=(0, 2))
    def apply_dot(self, seg: jnp.ndarray, out_len: int):
        """Two-matmul lowering: group rows (A, P*128) hit the main band
        ker[:P] and the (W-P)-row spill reads the next group's head.
        Identical math, plain dots instead of a strided conv."""
        a = -(-out_len // self.G)
        spill_rows = self.W - self.P
        rows = self._rows(seg, out_len,
                          extra_rows=(a + 1) * self.P + spill_rows
                          - self.rows_needed(out_len))
        grp = rows[: (a + 1) * self.P].reshape(a + 1, self.P * 128)
        out = None
        for s in range(self.nsplit):
            kf = self._ker(s).reshape(self.W * 128, 2 * self.G)
            main, spill = kf[: self.P * 128], kf[self.P * 128:]
            o = jnp.dot(grp[:a], main, preferred_element_type=jnp.float32)
            o = o + jnp.dot(grp[1:, : spill_rows * 128], spill,
                            preferred_element_type=jnp.float32)
            out = o if out is None else out + o
        return self._finish(out, out_len)

    # -------------------------------------------------------------- oracle
    def oracle(self, seg: np.ndarray, out_len: int) -> np.ndarray:
        """fp64 numpy reference of the identical window contract:
        out[m] = sum_k taps_rev[k] x[m*J + k], x the unpacked samples."""
        b = np.asarray(seg, dtype=np.float64)[: 2 * ((out_len - 1) * self.J
                                                     + self.K)] - 127.5
        x = b[0::2] + 1j * b[1::2]
        win = np.lib.stride_tricks.sliding_window_view(x, self.K)[::self.J]
        out = np.empty(out_len, dtype=np.complex128)
        step = 1 << 15
        for m in range(0, out_len, step):
            out[m: m + step] = win[m: m + step] @ self.taps_rev
        return out


_PLANS: dict = {}


def byte_plan(taps_rev, stride: int, nsplit: int = 3) -> BytePlan:
    """Process-wide plan cache keyed by tap values."""
    key = (np.asarray(taps_rev, np.complex128).tobytes(), int(stride),
           int(nsplit))
    p = _PLANS.get(key)
    if p is None:
        p = _PLANS[key] = BytePlan(taps_rev, stride, nsplit)
    return p


@partial(jax.jit, static_argnums=(0, 3, 4))
def ddc_bytes(plan: BytePlan, seg: jnp.ndarray, c_prev: jnp.ndarray,
              out_len: int, mode: str = "dot"):
    """Complex decimated stream from raw bytes; returns ((re, im), c_last).
    `c_prev` is unused (kept for FM-wrapper signature symmetry)."""
    re, im = (plan.apply_dot(seg, out_len) if mode == "dot"
              else plan.apply_conv(seg, out_len))
    return (re, im), lax.complex(re[-1:], im[-1:])


@partial(jax.jit, static_argnums=(0, 4, 5))
def ddc_fm_bytes(plan: BytePlan, seg: jnp.ndarray, rot: jnp.ndarray,
                 c_prev: jnp.ndarray, out_len: int, mode: str = "dot"):
    """Fused unpack+DDC+FM from raw interleaved uint8, dense-matmul
    lowering.  Returns (audio, c_last)."""
    (re, im), c_last = ddc_bytes(plan, seg, c_prev, out_len, mode)
    c = lax.complex(re, im)
    prev = jnp.concatenate([c_prev.astype(c.dtype), c[:-1]])
    audio = jnp.angle(c * jnp.conj(prev) * rot.astype(c.dtype))
    return audio, c_last
