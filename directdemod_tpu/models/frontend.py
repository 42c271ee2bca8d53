"""Fused digital down-converter (DDC) front-ends.

The reference's per-chunk chain  `offsetFreq -> FIR -> bwLim -> fm-demod`
(ref decode_noaa.py:623, decode_fm.py:64-68, decode_afsk1200.py:79-94) is
algebraically collapsed here into a single strided convolution:

    u[n] = x[n] e^{-j w n}                (NCO, w = 2 pi f / Fs, n global)
    y[n] = sum_k b[k] u[n-k]              (FIR)
    kept only at n = J m                  (decimation phase 0 at global 0)

        y[J m] = e^{-j w J m} * c[m],  c[m] = sum_k (b[k] e^{j w k}) x[Jm-k]

so modulating the taps once (host fp64) removes the NCO entirely, and the
decimating FIR computes only every J-th output (J ~ 34: a 34x FLOP cut vs the
reference's filter-everything-then-stride).  The FM polar discriminator then
cancels the residual phasors *analytically*:

    angle(y[Jm] conj(y[J(m-1)])) = angle(c[m] conj(c[m-1]) e^{-j w J})

leaving one constant rotation -- the hot path carries no trigonometry at all
and has no long-stream phase-precision problem by construction.

Outputs match the unfused op pipeline (and hence the reference's chunked
semantics); parity is enforced in tests/test_pipeline.py and
tests/test_ddc_conv.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..constants import PROC_CHUNKSIZE
from ..ops import fir, resample as rs, unpack
from ..utils import hostio


@dataclass(eq=False)
class DdcFm:
    """Fused shift+filter+decimate(+FM) front-end over a chunked source.

    Parameters mirror the reference chain: `freq` is the channel offset fed to
    offsetFreq, `taps` the FIR window, `bw_target` the first bwLim target.
    `fm` selects whether the FM discriminator is fused in (noaa/fm paths) or
    the complex decimated stream is returned (afsk path, which FM-demods the
    assembled signal later).
    """
    fs: int
    freq: float
    taps: np.ndarray
    bw_target: int
    fm: bool = True

    def __hash__(self):
        # value-based: DdcFm rides as a STATIC jit argument (self in _step /
        # resident_frontend). The default id() hash made every freshly
        # constructed decoder retrace + re-lower every jit graph — measured
        # ~4 s of host time per warm NOAA decode (round-4 bench) even with
        # the persistent compile cache hitting.
        return hash((self.fs, float(self.freq),
                     np.asarray(self.taps).tobytes(), self.bw_target,
                     self.fm))

    def __eq__(self, other):
        return (isinstance(other, DdcFm)
                and self.fs == other.fs and self.freq == other.freq
                and self.bw_target == other.bw_target and self.fm == other.fm
                and np.array_equal(self.taps, other.taps))

    def __post_init__(self):
        self.stride, self.out_rate_decim = rs.decim_params(self.fs, self.bw_target)
        k = len(self.taps)
        w = 2.0 * np.pi * float(self.freq) / float(self.fs)
        # modulated taps b~[k] = b[k] e^{+j w k}  (fp64 on host, cast at trace)
        self.taps_mod = (np.asarray(self.taps, dtype=np.float64)
                         * np.exp(1j * w * np.arange(k))).astype(np.complex128)
        # constant discriminator rotation e^{-j w J}
        self.rot = np.exp(-1j * w * self.stride)
        # first-block raw-x history equivalent to the reference's lfilter_zi
        # seed on the NCO'd stream: u_hist = 1  =>  x_hist[m] = e^{+j w m}
        self.hist0 = np.exp(1j * w * np.arange(-(k - 1), 0)).astype(np.complex128)
        self.out_rate = self.out_rate_decim

    # ---------------------------------------------------------------- device step
    @partial(jax.jit, static_argnums=(0, 5, 6))
    def _step(self, x, hist, c_prev, off, out_len: int, first: bool):
        if x.dtype == jnp.uint8:
            # raw interleaved IQ bytes: unpack on device (2 bytes/sample over
            # the host link; the -127.5 subtract fuses into the conv input)
            x = unpack.iq_u8_to_complex(x, jnp.real(hist).dtype)
        dt = x.dtype
        tm = jnp.asarray(self.taps_mod, dtype=dt)
        c, hist2 = fir.fir_decimate(x, tm, hist, off, out_len, self.stride)
        if not self.fm:
            return c, hist2, c[-1:]
        rot = jnp.asarray(self.rot, dtype=dt)
        if first:
            audio = jnp.angle(c[1:] * jnp.conj(c[:-1]) * rot)
        else:
            prev = jnp.concatenate([c_prev, c[:-1]])
            audio = jnp.angle(c * jnp.conj(prev) * rot)
        return audio, hist2, c[-1:]

    # ---------------------------------------------------------------- chunk loop
    def init_state(self, dtype=jnp.complex64):
        hist = hostio.device_put(self.hist0, dtype=dtype)
        return hist, hostio.zeros((1,), dtype)

    def block_out_len(self, start: int, n: int) -> int:
        off = rs.decim_phase(start, self.stride)
        return rs.decim_count(n, off, self.stride)

    def process_block(self, x, state, start: int):
        """One block; `start` is the block's global sample index (host int).

        `off` rides into the jitted step as a traced scalar so the compile
        count stays at ~2 shapes per block size (out_len varies by one),
        not one per decimator phase.
        """
        hist, c_prev = state
        n = int(x.shape[0]) // 2 if x.dtype == jnp.uint8 else int(x.shape[0])
        off = rs.decim_phase(start, self.stride)
        out_len = rs.decim_count(n, off, self.stride)
        y, hist2, c_last = self._step(x, hist, c_prev, jnp.int32(off), out_len,
                                      bool(start == 0))
        return y, (hist2, c_last)

    @partial(jax.jit, static_argnums=(0, 2))
    def resident_frontend(self, raw, n: int):
        """Whole-capture fused front end (unpack+DDC+FM) for a
        DEVICE-RESIDENT raw-byte capture, in ONE dispatch; see
        `_resident_scan`. Requires fm=True."""
        return self._resident_scan(
            raw, n, True, frontend_lowering(jax.default_backend(), raw=True))

    @partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
    def _resident_scan(self, raw, n: int, fm: bool, lowering: str,
                       chunk: int = PROC_CHUNKSIZE):
        """Whole-capture resident front end: block 0 runs the XLA step from
        the virtual warmup history, the remainder runs as ONE lax.scan step
        over `chunk`-sample chunks through the raw-byte `lowering`
        ('gemm_u8' or 'xla', see `frontend_lowering`). Per-output windows
        are the identical 151-tap dots the blocked DdcFmStream computes.
        Peak device memory is bounded per chunk, not by the capture size;
        the scan compiles one step for any number of chunks.

        Byte offsets exceed int32 at 2 B/sample beyond ~1 GB, so chunk
        slicing is two-level: a row slice of the (rows, 128) byte plane,
        then a fine slice — all indices stay < 2^25. Chunks are sized to a
        J multiple so every chunk yields exactly C/J outputs and assembly
        is a reshape, not a scatter."""
        from ..ops.ddc_conv import byte_plan
        J, k = self.stride, len(self.taps_mod)
        C = (chunk // J) * J               # decimation-grid-aligned chunks
        rot = jnp.asarray(self.rot, jnp.complex64)
        hist = jnp.asarray(self.hist0, jnp.complex64)
        tm = jnp.asarray(self.taps_mod, jnp.complex64)
        total_out = rs.decim_count(n, 0, J)
        out_n = total_out - 1 if fm else total_out
        b0 = min(n, C)
        x0 = unpack.iq_u8_to_complex(lax.slice(raw, (0,), (2 * b0,)),
                                     jnp.float32)
        out_len0 = rs.decim_count(b0, 0, J)
        c0, _ = fir.fir_decimate(x0, tm, hist, jnp.int32(0), out_len0, J)
        head = jnp.angle(c0[1:] * jnp.conj(c0[:-1]) * rot) if fm else c0
        if b0 >= n:
            return head
        n_chunks = -(-(n - b0) // C)
        cnt = C // J                       # outputs per chunk, exactly
        need = 2 * ((cnt - 1) * J + k)
        rows_need = -(-need // 128) + 1
        pad = rows_need * 128 + 2 * C + 256
        rawp = jnp.pad(raw, (0, pad + (-(2 * n + pad)) % 128))
        raw2 = rawp.reshape(-1, 128)
        if lowering == "gemm_u8":
            plan = byte_plan(self.taps_mod[::-1], J)

            def ddc(seg):
                return lax.complex(*plan.apply_dot(seg, cnt))
        elif lowering == "xla":
            def ddc(seg):
                x = unpack.iq_u8_to_complex(seg, jnp.float32)
                return fir.conv_valid(x, tm[::-1], stride=J)
        else:
            raise ValueError(f"unknown front-end lowering {lowering!r}")

        def step(cp, i):
            pos = jnp.int32(b0) + i * jnp.int32(C)
            # byte start s = 2*(pos - (k-1)) without overflowing i32:
            # pos = 64*ph + pl  =>  s = 128*ph + cc,  cc small
            ph = pos // 64
            pl = pos % 64
            cc = 2 * (pl - jnp.int32(k - 1))
            q = ph + cc // 128
            r = cc % 128
            rows = lax.dynamic_slice(
                raw2, (q, jnp.int32(0)), (rows_need, 128)).reshape(-1)
            c_arr = ddc(lax.dynamic_slice(rows, (r,), (need,)))
            if fm:
                prev = jnp.concatenate([cp, c_arr[:-1]])
                vals = jnp.angle(c_arr * jnp.conj(prev) * rot)
            else:
                vals = c_arr
            return c_arr[-1:], vals

        _, vals = lax.scan(step, c0[-1:],
                           jnp.arange(n_chunks, dtype=jnp.int32))
        flat = vals.reshape(-1)[: out_n - head.shape[0]]
        return jnp.concatenate([head.astype(flat.dtype), flat])

    @partial(jax.jit, static_argnums=(0, 2))
    def resident_complex(self, raw_or_x, n: int):
        """Whole-capture fused DDC (no FM) for a device-resident capture,
        inside one traced program: returns the complex decimated stream c
        with the identical per-output windows as the blocked path. Raw u8
        input runs `_resident_scan`; complex input runs one whole-capture
        fir_decimate. Used by the AFSK fused pipeline (fm=False chain of
        ref decode_afsk1200.py:74-95)."""
        J, k = self.stride, len(self.taps_mod)
        tm = jnp.asarray(self.taps_mod, jnp.complex64)
        hist = jnp.asarray(self.hist0, jnp.complex64)
        if raw_or_x.dtype != jnp.uint8:
            out_len = rs.decim_count(n, 0, J)
            c, _ = fir.fir_decimate(raw_or_x.astype(jnp.complex64), tm, hist,
                                    jnp.int32(0), out_len, J)
            return c
        return self._resident_scan(
            raw_or_x, n, False,
            frontend_lowering(jax.default_backend(), raw=True))

    def process(self, source, block_size: int = PROC_CHUNKSIZE,
                dtype=jnp.complex64, raw: bool | str = "auto",
                lowering: str | None = None):
        """Full chunked run with a double-buffered host feed; returns
        (output ndarray, out_rate). `raw='auto'` feeds raw uint8 bytes and
        unpacks on device when the source supports it (4x less link traffic).

        `lowering` forces the steady-state block lowering (see
        DdcFmStream); None takes `frontend_lowering`'s choice."""
        from ..io.feeder import BlockFeeder
        stream = DdcFmStream(self, dtype=dtype, lowering=lowering)
        outs = []
        with BlockFeeder(source, block_size, dtype=dtype, raw=raw) as feeder:
            for (s, e, x) in feeder:
                outs.append(hostio.device_get(stream.step(x, s)))
        return np.concatenate(outs), self.out_rate


# Raw-byte front-end lowering per JAX platform. On the GPU the dense bf16
# byte-GEMM (ops/ddc_conv) measured faster than the XLA polyphase conv on
# 20M-sample blocks at the oracle tolerance (bench.py; numbers in
# CHANGES.md); on the CPU the polyphase conv is the plain lowering.
_RAW_LOWERING = {"gpu": "gemm_u8", "cpu": "xla"}


def frontend_lowering(platform: str, raw: bool) -> str:
    """The one choice of front-end lowering, from what the code observes:
    the JAX platform, and whether the input is raw interleaved u8 bytes
    (only bytes can take the byte-GEMM). Returns 'gemm_u8' or 'xla'."""
    if not raw:
        return "xla"
    try:
        return _RAW_LOWERING[platform]
    except KeyError:
        raise ValueError(
            f"no front-end lowering for platform {platform!r}") from None


class DdcFmStream:
    """Streaming front-end driver over blocks of one capture.

    Block 0 (and any non-raw block) runs the XLA `DdcFm._step`; steady-state
    raw-uint8 blocks of an FM chain run the fused unpack+DDC+FM byte-GEMM
    (ops/ddc_conv) when the lowering is 'gemm_u8'. `lowering` None takes
    `frontend_lowering`'s choice for raw bytes; 'xla' or 'gemm_u8' forces
    one (tests compare the two). The first block always takes XLA: its
    warmup history is the virtual all-ones NCO stream (DdcFm.hist0), which
    is not byte-representable. Cross-lowering state stays consistent — the
    conv history for a raw stream is derivable from the carried tail
    BYTES, so an XLA block mid-stream (e.g. a source that stops yielding
    raw) stays exact."""

    def __init__(self, fe: "DdcFm", dtype=jnp.complex64,
                 lowering: str | None = None):
        self.fe = fe
        self.dtype = dtype
        self.lowering = lowering or frontend_lowering(jax.default_backend(),
                                                      raw=True)
        self.state = fe.init_state(dtype)
        self.raw_hist = None          # device u8 tail, 2*(K-1) bytes

    def step(self, x, s: int):
        """One block (device array, complex or raw u8) at global sample
        index `s`; returns the device audio/output block."""
        fe = self.fe
        k = len(fe.taps_mod)
        is_u8 = x.dtype == jnp.uint8
        if (self.lowering == "gemm_u8" and fe.fm and is_u8 and s > 0
                and self.raw_hist is not None):
            n = int(x.shape[0]) // 2
            off = rs.decim_phase(s, fe.stride)
            out_len = rs.decim_count(n, off, fe.stride)
            from ..ops.ddc_conv import byte_plan
            y, c_last, tail = _gemm_u8_step(
                byte_plan(fe.taps_mod[::-1], fe.stride),
                self.raw_hist, x, np.complex64(fe.rot),
                self.state[1].astype(jnp.complex64), jnp.int32(off),
                fe.stride, out_len, k)
            # the complex conv history stays DERIVABLE from the raw tail
            # (see class doc); it is materialized lazily only if a later
            # block takes the XLA step
            self.state = (None, c_last.astype(self.dtype))
            self.raw_hist = tail
            return y
        if self.state[0] is None:
            # XLA block after byte-GEMM blocks: rebuild the complex history
            # from the carried tail bytes
            hist = unpack.iq_u8_to_complex(self.raw_hist,
                                           jnp.float32).astype(self.dtype)
            self.state = (hist, self.state[1])
        y, self.state = fe.process_block(x, self.state, s)
        self.raw_hist = x[-2 * (k - 1):] if is_u8 else None
        return y


@partial(jax.jit, static_argnums=(0, 6, 7, 8))
def _gemm_u8_step(plan, raw_hist, x_u8, rot, c_prev, off, stride: int,
                  out_len: int, k: int):
    """One steady-state block through the byte-GEMM, with the history
    concatenation and the next tail slice in the same dispatch.

    raw_cat = [previous tail bytes (2*(K-1)) | block bytes]; the kept output
    m covers sample off + m*stride of that concatenation -- the same window
    alignment as ops/fir.fir_decimate's `seg`. Returns (audio, c_last,
    tail)."""
    from ..ops.ddc_conv import ddc_fm_bytes
    raw_cat = jnp.concatenate([raw_hist, x_u8])
    need = 2 * ((out_len - 1) * stride + k)
    seg = jax.lax.dynamic_slice(
        jnp.pad(raw_cat, (0, 2 * stride)), (2 * off,), (need,))
    audio, c_last = ddc_fm_bytes(plan, seg, rot, c_prev, out_len)
    return audio, c_last, x_u8[-2 * (k - 1):]
