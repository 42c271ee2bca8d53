"""IQ capture sources (host-side, memory-mapped).

Behavioral reference: `source.IQwav / IQdat / IQwavAlt` (ref source.py:53-324).
The byte-level contract reproduced here:
  * WAV: 2-channel uint8 SDRSharp recording; samples are ``(I + jQ) - (127.5 + 127.5j)``
    as complex64 (ref source.py:117-118). The raw post-header byte stream stays
    available as `.memmap` for the Doppler waterfall (ref source.py:66).
  * DAT: raw interleaved uint8, even bytes I, odd bytes Q (ref source.py:209).
  * `limit(offset, end)` windows reads like `limitData` (ref source.py:120-138).

Reads go through the native C++ converter when built (io.native), falling back
to NumPy. Conversion is the host-side feed of the device pipeline, so it is
worth real optimization: the uint8->complex64 unpack runs at memory bandwidth.
"""
from __future__ import annotations

import struct

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants
from ..utils import hostio


def _wav_data_offset(path: str) -> tuple[int, int, int]:
    """Parse a RIFF/WAVE header: (data_offset, sample_rate, n_channels)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate, nch = None, None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk found")
            tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if tag == b"fmt ":
                fmt = f.read(size)
                nch = struct.unpack("<H", fmt[2:4])[0]
                rate = struct.unpack("<I", fmt[4:8])[0]
            elif tag == b"data":
                return f.tell(), rate, nch
            else:
                f.seek(size, 1)


class _BaseIQ:
    """Common read/limit plumbing for uint8 interleaved-IQ byte streams."""

    source_type: int
    # sourceType/sampFreq/length mirror the reference property surface
    # (ref source.py:18-47) so decoders are source-agnostic.

    def __init__(self, data: np.ndarray, samp_freq: int):
        self._bytes = data            # raw interleaved uint8 (I0 Q0 I1 Q1 ...)
        self._samp_freq = int(samp_freq)
        self._total = len(data) // 2
        self._offset = 0
        self._limit = self._total
        self.memmap = data            # Doppler waterfall input (ref source.py:66)

    @property
    def sampFreq(self) -> int:
        return self._samp_freq

    @property
    def sourceType(self) -> int:
        return self.source_type

    @property
    def length(self) -> int:
        return self._limit

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        """complex64 samples in [from_index, to_index) relative to the window."""
        if to_index is None:
            to_index = from_index + 1
        if (from_index < 0 or to_index < 0 or from_index >= self.length
                or to_index > self.length):
            raise ValueError("read range outside the source window")
        a = self._offset + from_index
        b = self._offset + to_index
        raw = self._bytes[2 * a: 2 * b]
        return _convert_iq_u8(raw)

    def read_raw(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        """Raw interleaved uint8 bytes for [from_index, to_index) samples.

        The device-side unpack path (ops/unpack.iq_u8_to_complex) consumes
        this directly: 2 bytes/sample over the host->device link instead of 8,
        with the -127.5 conversion fused into the first device op.
        """
        if to_index is None:
            to_index = from_index + 1
        if (from_index < 0 or to_index < 0 or from_index >= self.length
                or to_index > self.length):
            raise ValueError("read range outside the source window")
        a = self._offset + from_index
        b = self._offset + to_index
        return self._bytes[2 * a: 2 * b]

    def limit(self, init_offset: int | None = None,
              final_limit: int | None = None) -> None:
        """Window subsequent reads (ref source.py:120-138)."""
        self._offset = init_offset if init_offset is not None else 0
        if final_limit is not None:
            self._limit = final_limit - self._offset
        else:
            self._limit = self._total

    # reference-compatible alias
    limitData = limit


def _convert_iq_u8(raw: np.ndarray) -> np.ndarray:
    """uint8 interleaved IQ -> complex64 with the -127.5 offset, via the native
    converter when available."""
    from . import native
    if native.available():
        return native.iq_u8_to_c64(raw)
    out = np.empty(len(raw) // 2, dtype=np.complex64)
    f = raw.astype(np.float32)
    out.real = f[0::2] - np.float32(127.5)
    out.imag = f[1::2] - np.float32(127.5)
    return out


class IQWav(_BaseIQ):
    """SDRSharp IQ.wav source (ref source.py:53-138). The sample rate comes
    from the WAV header unless overridden."""

    source_type = constants.SOURCE_IQWAV

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        off, rate, nch = _wav_data_offset(filename)
        if nch not in (None, 2):
            raise ValueError(f"{filename}: expected 2-channel IQ wav, got {nch}")
        data = np.memmap(filename, dtype=np.uint8, mode="r", offset=off)
        super().__init__(data, given_samp_freq or rate)


class IQWavAlt(_BaseIQ):
    """Header-skipping memmap WAV reader kept for API parity with the
    reference's Experiment-2 variant (ref source.py:237-324); assumes the
    standard 44-byte header and the default SDR rate."""

    source_type = constants.SOURCE_IQWAV

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        data = np.memmap(filename, dtype=np.uint8, mode="r", offset=44)
        super().__init__(data, given_samp_freq or int(constants.IQ_SDRSAMPRATE))


class IQDat(_BaseIQ):
    """Raw interleaved uint8 .dat source (ref source.py:144-230)."""

    source_type = constants.SOURCE_IQDAT

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        data = np.memmap(filename, dtype=np.uint8, mode="r")
        super().__init__(data, given_samp_freq or int(constants.IQ_SDRSAMPRATE))


class ArraySource:
    """In-memory source for tests/synthesis; same surface as the file sources."""

    source_type = constants.SOURCE_IQDAT

    def __init__(self, samples: np.ndarray, samp_freq: int):
        self._a = np.asarray(samples)
        self._samp_freq = int(samp_freq)
        self._offset = 0
        self._limit = len(self._a)
        self.memmap = None

    @property
    def sampFreq(self) -> int:
        return self._samp_freq

    @property
    def sourceType(self) -> int:
        return self.source_type

    @property
    def length(self) -> int:
        return self._limit

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        if to_index is None:
            to_index = from_index + 1
        if (from_index < 0 or to_index < 0 or from_index >= self.length
                or to_index > self.length):
            raise ValueError("read range outside the source window")
        return self._a[self._offset + from_index: self._offset + to_index]

    def limit(self, init_offset=None, final_limit=None):
        self._offset = init_offset if init_offset is not None else 0
        self._limit = (final_limit - self._offset) if final_limit is not None \
            else len(self._a)

    limitData = limit


# Device-resident captures: sample positions on the device are int32
# (ROADMAP R1), so no capture over 2^31 samples may be uploaded whole, and
# the decode needs room beside the capture: one padded copy of its bytes
# (DdcFm._resident_scan), per-sample outputs and chunk-bounded working
# memory. A device that reports no memory limit (the CPU) is capped by the
# sample count alone.
RESIDENT_MAX_SAMPLES = 1 << 31
RESIDENT_RESERVE_BYTES = 4 << 30


def resident_max_bytes(device=None) -> int | None:
    """Capture bytes that may be uploaded whole to `device` (default: the
    first JAX device): a third of its allocator limit after
    RESIDENT_RESERVE_BYTES, for the capture, its padded copy and the
    decode's per-sample outputs. None when the device reports no limit."""
    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return max(0, (int(stats["bytes_limit"]) - RESIDENT_RESERVE_BYTES) // 3)


def fits_resident(n_samples: int, bytes_per_sample: int = 2) -> bool:
    """Whether an n-sample capture may be decoded device-resident."""
    if n_samples > RESIDENT_MAX_SAMPLES:
        return False
    cap = resident_max_bytes()
    return cap is None or n_samples * bytes_per_sample <= cap


class DeviceRawSource:
    """IQ capture resident in device memory as raw interleaved uint8 bytes.

    When the capture fits (`fits_resident`), upload it ONCE and decode
    without touching the host link again: `BlockFeeder` recognises
    `read_raw_device` and slices blocks on device instead of re-uploading
    them. Mirrors the source ABC surface (ref source.py:18-47) for
    rate/length bookkeeping; `read`/`read_raw` download for host consumers.
    """

    source_type = constants.SOURCE_IQDAT

    def __init__(self, raw_dev, samp_freq: int):
        if raw_dev.dtype != jnp.uint8:
            raise ValueError("DeviceRawSource wants uint8 interleaved bytes")
        self._raw = raw_dev
        self._samp_freq = int(samp_freq)
        self._total = int(raw_dev.shape[0]) // 2
        self._offset = 0
        self._limit = self._total

    @classmethod
    def from_host_bytes(cls, raw: np.ndarray, samp_freq: int):
        src = cls(hostio.device_put_u8(np.asarray(raw, dtype=np.uint8)),
                  samp_freq)
        # host copy for host-only consumers (the Doppler waterfall reads
        # `memmap` — ref source.py:66); windowed to the uploaded span
        src.memmap = np.asarray(raw, dtype=np.uint8)
        return src

    @classmethod
    def from_file(cls, path: str, samp_freq: int):
        return cls.from_host_bytes(np.fromfile(path, dtype=np.uint8),
                                   samp_freq)

    @property
    def sampFreq(self) -> int:
        return self._samp_freq

    @property
    def sourceType(self) -> int:
        return self.source_type

    @property
    def length(self) -> int:
        return self._limit

    def limit(self, init_offset: int | None = None,
              final_limit: int | None = None) -> None:
        """Window subsequent reads (ref source.py:120-138), sliced on
        device — no re-upload."""
        self._offset = init_offset if init_offset is not None else 0
        if final_limit is not None:
            self._limit = final_limit - self._offset
        else:
            self._limit = self._total

    limitData = limit

    def read_raw_device(self, from_index: int, to_index: int):
        a = self._offset + from_index
        b = self._offset + to_index
        return self._raw[2 * a: 2 * b]

    def read_raw(self, from_index: int, to_index: int) -> np.ndarray:
        return hostio.device_get(self.read_raw_device(from_index, to_index))

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        if to_index is None:
            to_index = from_index + 1
        from ..ops import unpack
        dev = unpack.iq_u8_to_complex(
            self.read_raw_device(from_index, to_index), jnp.float32)
        return hostio.device_get(dev)


def open_source(filename: str, given_samp_freq: int | None = None):
    """Dispatch by extension like the CLI does (ref main.py:133-138)."""
    if filename.endswith(".wav"):
        return IQWav(filename, given_samp_freq)
    if filename.endswith(".dat"):
        return IQDat(filename, given_samp_freq)
    raise ValueError("only .wav and .dat sources are supported")
