"""Generic wide/narrow FM decoder (broadcast audio, NOAA raw audio...).

Behavioral reference: `decode_fm` (ref decode_fm.py:15-72): per chunk
`offsetFreq -> blackmanHarris(151) -> bwLim(bw) -> fm -> bwLim(audioFreq,
strict)` -- here the fused DDC front-end plus per-chunk strict Fourier
resample.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..constants import PROC_CHUNKSIZE
from ..ops import design, resample as rs
from .frontend import DdcFm


class FmDecoder:
    def __init__(self, sigsrc, offset: float, bw: int | None = None,
                 audio_freq: int | None = None, strict: bool = True,
                 dtype=jnp.complex64):
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = int(bw) if bw else 30000
        self.audio_freq = int(audio_freq) if audio_freq else 15000
        self.strict = strict
        self.dtype = dtype
        self._audio = None

    def get_audio(self) -> tuple[np.ndarray, int]:
        """Returns (audio, rate)."""
        if self._audio is not None:
            return self._audio
        fe = DdcFm(self.src.sampFreq, self.offset,
                   design.blackmanharris(151), self.bw, fm=True)
        decim_rate = fe.out_rate
        outs = []
        off2 = 0
        j2 = 1 if self.strict else max(1, int(decim_rate // self.audio_freq))
        out_rate = self.audio_freq if self.strict else int(decim_rate / j2)
        from ..io.feeder import BlockFeeder
        from .frontend import DdcFmStream
        stream = DdcFmStream(fe, dtype=self.dtype)   # frontend_lowering's pick
        with BlockFeeder(self.src, PROC_CHUNKSIZE, dtype=self.dtype,
                         raw="auto") as feeder:
            for (s, e, x) in feeder:
                y = stream.step(x, s)
                if self.strict:
                    y = rs.fft_resample(
                        y, int(self.audio_freq * y.shape[0] / decim_rate))
                elif j2 > 1:
                    n_pre = int(y.shape[0])
                    cnt = rs.decim_count(n_pre, off2, j2)
                    y = rs.decimate(y, off2, j2, cnt)
                    off2 = (j2 - (n_pre - off2) % j2) % j2
                outs.append(np.asarray(y))
        self._audio = (np.concatenate(outs), out_rate)
        return self._audio
