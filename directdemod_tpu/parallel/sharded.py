"""Time/channel-sharded execution of the DDC front-end.

The sequential chunk loop (ref decode_noaa.py:617-624) becomes a wave of
chunks processed simultaneously: chunks stacked on a leading axis sharded over
the mesh's `time` axis (and independent channels over `channel`). The only
inter-chunk coupling in the whole front-end is:

  * FIR history      -> last (ntaps-1) input samples of the left neighbor
  * FM boundary c    -> one extra conv window reaching (stride) samples back
  * decimator phase  -> closed form in the global chunk index (no comms)
  * NCO phase        -> folded into the taps (no comms)

so one `ppermute` halo exchange of (ntaps-1+stride) samples per wave makes the
sharded result compute the sequential stream's window dots (tests hold it to
1e-9 at fp64). Waves keep device memory bounded:
ndev chunks in flight, the last chunk's tail carried to the next wave on host.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import fir, resample as rs, unpack
from ..stream import plan as plan_mod
from ..utils import hostio
from ..models.frontend import DdcFm


@dataclass(eq=False)
class ShardedDdcFm:
    """Wave-parallel fused DDC(+FM) over a jax Mesh.

    `fe` supplies taps/stride/rotation; `mesh` must have a `time` axis (and
    optionally `channel` when processing a (channels, chunks, L) batch).
    """
    fe: DdcFm
    mesh: jax.sharding.Mesh

    def __hash__(self):
        # value-based (see DdcFm.__hash__): static jit arg in _wave; a fresh
        # instance per decode must hit the same jit cache entry
        return hash((self.fe, self.mesh))

    def __eq__(self, other):
        return (isinstance(other, ShardedDdcFm)
                and self.fe == other.fe and self.mesh == other.mesh)

    def __post_init__(self):
        k = len(self.fe.taps)
        self.halo = k - 1 + self.fe.stride
        w = 2.0 * np.pi * float(self.fe.freq) / float(self.fe.fs)
        # left-extension of the virtual all-ones NCO history for chunk 0
        self.hist0_ext = np.exp(1j * w * np.arange(-self.halo, 0))

    # ---------------------------------------------------------------- kernel
    def _chunk_fn(self, xh, gidx):
        """One chunk with its left halo prepended: (halo + L,) -> (M_max,)."""
        fe = self.fe
        J = fe.stride
        k = len(fe.taps)
        L = xh.shape[0] - self.halo
        m_max = -(-L // J)
        tm = jnp.asarray(fe.taps_mod, dtype=xh.dtype)
        w = tm[::-1]
        # decimator phase, closed form in the global chunk index; modular to
        # stay in int32 for arbitrarily long captures
        m = (jnp.mod(gidx, J) * (L % J)) % J
        off = ((J - m) % J).astype(jnp.int32)
        # windows end at local positions (halo + off + J*m); conv input starts
        # at halo + off - (k-1)
        start = self.halo + off - (k - 1)
        need = (m_max - 1) * J + k
        seg = lax.dynamic_slice(jnp.pad(xh, (0, J)), (start,), (need,))
        c = fir.conv_valid(seg, w, stride=J)
        if not fe.fm:
            return c
        # previous kept output: window ending at halo + off - J
        pstart = self.halo + off - J - (k - 1)
        pseg = lax.dynamic_slice(xh, (pstart,), (k,))
        c_prev = jnp.sum(pseg * w)
        rot = jnp.asarray(fe.rot, dtype=xh.dtype)
        prev = jnp.concatenate([c_prev[None], c[:-1]])
        return jnp.angle(c * jnp.conj(prev) * rot)

    @partial(jax.jit, static_argnums=(0,))
    def _wave(self, chunks, gidx, carry_tail):
        """chunks: (C, L) sharded over `time`; gidx: (C,) global chunk ids;
        carry_tail: (halo,) tail of the chunk before this wave."""
        ndev = self.mesh.shape["time"]

        def shard_body(local, gl, tail_in):
            # local: (Cl, L) complex -- or (Cl, 2L) raw uint8 IQ bytes,
            # unpacked here so the host link only carries 2 bytes/sample
            if local.dtype == jnp.uint8:
                local = unpack.iq_u8_to_complex(local, jnp.real(tail_in).dtype)
            # halo exchange of each chunk's trailing samples
            tails = local[:, -self.halo:]
            left_edge = lax.ppermute(
                tails[-1], "time",
                [(i, (i + 1) % ndev) for i in range(ndev)])
            my_pos = lax.axis_index("time")
            first_tail = jnp.where(my_pos == 0, tail_in, left_edge)
            prev_tails = jnp.concatenate([first_tail[None], tails[:-1]], axis=0)
            xh = jnp.concatenate([prev_tails, local], axis=1)
            return jax.vmap(self._chunk_fn)(xh, gl)

        return jax.shard_map(
            shard_body, mesh=self.mesh,
            in_specs=(P("time", None), P("time"), P(None)),
            out_specs=P("time", None))(chunks, gidx, carry_tail)

    # ---------------------------------------------------------------- driver
    def process(self, source, block_size: int, dtype=jnp.complex64
                ) -> tuple[np.ndarray, int]:
        """Sharded chunk-parallel run; bit-compatible with DdcFm.process."""
        fe = self.fe
        ndev = self.mesh.shape["time"]
        plan = plan_mod.plan_blocks(source.length, block_size)
        full = [p for p in plan if p[1] - p[0] == block_size]
        outs: list[np.ndarray] = []
        carry_tail = np.asarray(self.hist0_ext, dtype=np.complex64)

        raw = unpack.supports_raw(source)
        spec = NamedSharding(self.mesh, P("time", None))
        for w0 in range(0, len(full), ndev):
            wave = full[w0:w0 + ndev]
            if len(wave) < ndev:
                break
            if raw:
                xs = np.stack([source.read_raw(s, e) for (s, e) in wave])
                chunks = hostio.device_put_u8(xs, sharding=spec)
                tail_np = self._host_unpack(xs[-1][-2 * self.halo:])
            else:
                xs = np.stack([source.read(s, e) for (s, e) in wave])
                chunks = hostio.device_put(xs, dtype=dtype, sharding=spec)
                tail_np = xs[-1][-self.halo:]
            gidx = jnp.arange(w0, w0 + ndev, dtype=jnp.int32)
            y = hostio.global_get(self._wave(chunks, gidx,
                                             hostio.device_put(carry_tail)))
            for ci, (s, e) in enumerate(wave):
                off = rs.decim_phase(s, fe.stride)
                cnt = rs.decim_count(e - s, off, fe.stride)
                row = y[ci, :cnt]
                outs.append(row[1:] if s == 0 and fe.fm else row)
            carry_tail = tail_np

        # leftover blocks (wave remainder + the ragged final block): sequential
        done_end = full[(len(full) // ndev) * ndev - 1][1] \
            if len(full) >= ndev else 0
        if done_end < source.length:
            state = (hostio.device_put(carry_tail[-(len(fe.taps) - 1):],
                                       dtype=dtype),
                     hostio.zeros(1, dtype))
            # recompute FM boundary value for continuity
            for (s, e) in plan:
                if s < done_end:
                    continue
                x = hostio.device_put(source.read(s, e), dtype=dtype)
                if s == 0:
                    state = fe.init_state(dtype)
                else:
                    cp = self._boundary_c(source, s, dtype)
                    state = (state[0], cp)
                y, state = fe.process_block(x, state, s)
                outs.append(np.asarray(y))
                done_end = e
        return np.concatenate(outs), fe.out_rate

    @staticmethod
    def _host_unpack(raw_bytes: np.ndarray) -> np.ndarray:
        from ..io.sources import _convert_iq_u8
        return _convert_iq_u8(np.asarray(raw_bytes))

    def _boundary_c(self, source, s: int, dtype):
        """c value of the last kept output before global sample s."""
        fe = self.fe
        J, k = fe.stride, len(fe.taps)
        off = rs.decim_phase(s, J)
        last_kept = s + off - J
        seg = hostio.device_put(source.read(last_kept - k + 1, last_kept + 1),
                                dtype=dtype)
        return jnp.sum(seg * hostio.device_put(fe.taps_mod[::-1],
                                               dtype=dtype))[None]
