"""Tutorial 4: multi-chip decoding over a device mesh.

The reference processes one chunk at a time on one core; here the SAME
chunked-stream semantics shard over a `(time, channel)` device mesh:

  * the `time` axis splits a long capture into device-resident waves, with
    filter tails exchanged as ppermute halos (the same windows as sequential —
    the chunk-state contract of ref chunker.py:54-84 made collective);
  * the `channel` axis decodes independent `-f` channels concurrently
    (ref main.py:147's sequential loop made parallel).

No multi-GPU host handy? Virtual CPU devices exercise the identical program:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python tutorial/4_mesh.py
"""
import sys

import numpy as np

from directdemod_tpu.io import sources
from directdemod_tpu.ops import filters
from directdemod_tpu.parallel.mesh import make_mesh
from directdemod_tpu.stream.api import Stream

file_name = sys.argv[1] if len(sys.argv) > 1 else "IQ.wav"
if file_name == "IQ.wav":
    import os as _os
    sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _sample import ensure_capture
    ensure_capture(file_name)
src = sources.open_source(file_name)

chain = (Stream(src)
         .shift(30000)
         .filter(filters.blackman_harris(151))
         .bw_limit(60000)
         .fm_demod())

# sequential baseline
seq, rate = chain.run_fused()

# the same chain over every available device (time-sharded waves)
import jax
mesh = make_mesh(time=len(jax.devices()))
sharded, _ = chain.run_sharded(mesh)

print(f"devices: {len(jax.devices())}  rate: {rate}")
print("sharded == sequential:", bool(np.max(np.abs(seq - sharded)) < 1e-6))

# multi-channel: decode several frequencies in one pass, sharded over the
# mesh's channel axis (see models/multichannel.MultiDdcFm and --mesh in the
# CLI for the production wiring)
