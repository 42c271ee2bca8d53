"""Double-buffered host -> device block feeder.

The stream runtime's host side (file read + uint8 unpack + device upload)
overlaps with device compute: a background thread stays `depth` blocks ahead,
so the device never waits on the memmap. This replaces the reference's
synchronous `source.read` inside the chunk loop (ref decode_noaa.py:619-623):
the device chain is far faster than the host feed, so overlap hides the
device time behind IO.
"""
from __future__ import annotations

import queue
import threading

import jax.numpy as jnp

from ..stream import plan as plan_mod
from ..utils import hostio


class BlockFeeder:
    """Iterate (start, end, device_block) over a source's block plan with
    background prefetch. Use as a context manager or rely on exhaustion."""

    def __init__(self, source, block_size: int, dtype=jnp.complex64,
                 depth: int = 2, blocks=None, raw: bool | str = False,
                 sharding=None):
        """`raw`: upload interleaved uint8 bytes (2 bytes/sample) instead of
        host-unpacked complex (8 bytes/sample); the consumer unpacks on device
        (ops/unpack). 'auto' enables it when the source supports read_raw.
        `sharding`: optional jax sharding for the uploaded block (e.g.
        replicated over a mesh so sharded consumers can mix it with
        mesh-distributed state)."""
        from ..ops import unpack
        self.source = source
        self.dtype = dtype
        self.sharding = sharding
        if raw == "auto":
            raw = unpack.supports_raw(source)
        elif raw and not unpack.supports_raw(source):
            raise ValueError("source has no read_raw; cannot feed raw bytes")
        self.raw = bool(raw)
        self.plan = blocks if blocks is not None \
            else plan_mod.plan_blocks(source.length, block_size)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for (s, e) in self.plan:
                if self._stop.is_set():
                    return
                if self.raw and callable(getattr(self.source,
                                                 "read_raw_device", None)):
                    # capture already resident on device: slice there, no
                    # host link traffic (io.sources.DeviceRawSource)
                    block = self.source.read_raw_device(s, e)
                    if self.sharding is not None:
                        import jax
                        block = jax.device_put(block, self.sharding)
                elif self.raw:
                    block = hostio.device_put_u8(self.source.read_raw(s, e),
                                                 sharding=self.sharding)
                else:
                    block = hostio.device_put(self.source.read(s, e),
                                              dtype=self.dtype,
                                              sharding=self.sharding)
                self._q.put((s, e, block))
        except Exception as exc:  # surface errors to the consumer
            self._q.put(exc)
        finally:
            self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
