"""Tutorial 3: chunked streams and state (ref tutorial/3_chunking.py).

The chain carries all cross-block state (filter tails, FM boundary sample,
decimator phase) in an explicit pytree, so any block size gives bit-identical
output -- and `run_sharded` spreads the blocks over a device mesh.
"""
import sys

from directdemod_tpu.io import sources
from directdemod_tpu.ops import filters
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

small, rate = chain.run(block_size=1_000_000)
fused, _ = chain.run_fused()            # same numbers, fused DDC fast path
print("chunked == fused:", abs(small - fused).max() < 1e-5)

# across a device mesh (virtual CPU devices work too):
# from directdemod_tpu.parallel.mesh import make_mesh
# audio, rate = chain.run_sharded(make_mesh(time=8))
