"""Host<->device transfer helpers (utils/hostio): every dtype and shape the
decoders move must round-trip exactly."""
import numpy as np
import jax.numpy as jnp

from directdemod_tpu.utils import hostio


def test_device_put_complex_roundtrip(rng):
    x = (rng.standard_normal(513) + 1j * rng.standard_normal(513)).astype(np.complex64)
    d = hostio.device_put(x, dtype=jnp.complex64)
    assert d.dtype == jnp.complex64
    assert np.array_equal(hostio.device_get(d), x)


def test_device_put_u8_roundtrip(rng):
    for n in (4000, 4001, 4002, 4003):       # odd and even lengths
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        d = hostio.device_put_u8(raw)
        assert d.dtype == jnp.uint8 and np.array_equal(hostio.device_get(d), raw)


def test_device_get_complex_roundtrip(rng):
    x = (rng.standard_normal(257) + 1j * rng.standard_normal(257)).astype(np.complex64)
    out = hostio.device_get(jnp.asarray(x))
    assert out.dtype == np.complex64 and np.array_equal(out, x)


def test_device_get_int_exact(rng):
    """Any int32 downloads bit-exactly, negatives and the extremes included
    (sync sample indices are int32)."""
    vals = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 4096),
        [0, 1, -1, 4095, 4096, -4096, 2**31 - 1, -2**31, 2**24, -2**24]],
    ).astype(np.int32)
    out = hostio.device_get(jnp.asarray(vals))
    assert out.dtype == np.int32 and np.array_equal(out, vals)


def test_device_get_bool_roundtrip(rng):
    m = rng.random(1000) > 0.5
    out = hostio.device_get(jnp.asarray(m))
    assert out.dtype == np.bool_ and np.array_equal(out, m)


def test_device_get_float_passthrough(rng):
    x = rng.standard_normal(100).astype(np.float32)
    assert np.array_equal(hostio.device_get(jnp.asarray(x)), x)
    assert hostio.device_get(x) is x            # host arrays pass untouched


def test_device_put_complex_2d(rng):
    """Arbitrary shapes survive the upload (the accurate-sync window batches
    are 2-D)."""
    x = (rng.standard_normal((7, 129))
         + 1j * rng.standard_normal((7, 129))).astype(np.complex64)
    d = hostio.device_put(x, dtype=jnp.complex64)
    assert d.shape == x.shape and np.array_equal(hostio.device_get(d), x)


def test_device_put_complex128_coerces(rng):
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64))
    d = hostio.device_put(x, dtype=jnp.complex64)
    assert d.dtype == jnp.complex64
    assert np.allclose(hostio.device_get(d), x.astype(np.complex64))


def test_device_put_complex_sharded(rng):
    """An upload with a mesh sharding lands with the requested sharding and
    the exact values."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from directdemod_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(time=len(jax.devices()))
    x = (rng.standard_normal((8, 32))
         + 1j * rng.standard_normal((8, 32))).astype(np.complex64)
    sh = NamedSharding(mesh, P("time", None))
    d = hostio.device_put(x, dtype=jnp.complex64, sharding=sh)
    assert np.array_equal(hostio.device_get(d), x)
    assert d.sharding.is_equivalent_to(sh, x.ndim)


def test_global_get_single_process_passthrough():
    """global_get == device_get for fully-addressable arrays (the
    multi-process allgather path is exercised by test_distributed)."""
    x = jnp.arange(8, dtype=jnp.float32)
    np.testing.assert_array_equal(hostio.global_get(x), np.arange(8.0))
    a = np.arange(4.0)
    assert hostio.global_get(a) is a


def test_device_put_u8_chunked_conversion():
    """A multi-MB odd-length byte capture round-trips exactly."""
    raw = np.arange(3_000_005, dtype=np.int64).astype(np.uint8)
    got = hostio.device_get(hostio.device_put_u8(raw))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, raw)
