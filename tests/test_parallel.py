"""Sharded == sequential: the chunked-stream parity contract, on an 8-device
virtual CPU mesh (the multi-device analog of the reference's chunked==unchunked
experiments 3/5/6)."""
import numpy as np
import pytest
import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource
from directdemod_tpu.models.frontend import DdcFm
from directdemod_tpu.ops import design
from directdemod_tpu.parallel.mesh import make_mesh
from directdemod_tpu.parallel.sharded import ShardedDdcFm

FS = 2048000


@pytest.fixture(scope="module")
def capture(request):
    rng = np.random.default_rng(11)
    n = 8 * 100_000 + 100_000 + 777      # 8 full waves + leftover + ragged
    t = np.arange(n) / FS
    x = (np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 400 * t)))
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex128)


def test_sharded_matches_sequential_fm(capture):
    src = ArraySource(capture, FS)
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000, fm=True)
    ref, rate = fe.process(src, block_size=100_000, dtype=jnp.complex128)

    mesh = make_mesh(time=8, channel=1)
    sh = ShardedDdcFm(fe, mesh)
    ours, rate2 = sh.process(src, block_size=100_000, dtype=jnp.complex128)
    assert rate == rate2
    assert len(ours) == len(ref)
    assert np.max(np.abs(ours - ref)) < 1e-9


def test_sharded_matches_sequential_complex_stream(capture):
    src = ArraySource(capture, FS)
    fe = DdcFm(FS, 12000, design.blackmanharris(151), 22050, fm=False)
    ref, _ = fe.process(src, block_size=100_000, dtype=jnp.complex128)
    sh = ShardedDdcFm(fe, make_mesh(time=8, channel=1))
    ours, _ = sh.process(src, block_size=100_000, dtype=jnp.complex128)
    assert len(ours) == len(ref)
    assert np.max(np.abs(ours - ref)) < 1e-8 * np.max(np.abs(ref))


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(time=3, channel=2)


def test_multichannel_matches_per_channel(capture):
    """One-pass multi-channel DDC == independent per-channel runs."""
    from directdemod_tpu.models.multichannel import MultiDdcFm
    src = ArraySource(capture[:400_000], FS)
    freqs = (30000.0, -12000.0, 5000.0)
    multi = MultiDdcFm(FS, freqs, design.blackmanharris(151), 60000, fm=True)
    got, rate = multi.process(src, block_size=150_000, dtype=jnp.complex128)
    assert got.shape[0] == 3
    for ci, f in enumerate(freqs):
        fe = DdcFm(FS, f, design.blackmanharris(151), 60000, fm=True)
        ref, r2 = fe.process(src, block_size=150_000, dtype=jnp.complex128)
        assert r2 == rate
        assert np.max(np.abs(got[ci] - ref)) < 1e-9, ci


def test_multichannel_on_channel_mesh(capture):
    """Channel-sharded MultiDdcFm == the unsharded one-pass run."""
    from directdemod_tpu.models.multichannel import MultiDdcFm
    src = ArraySource(capture[:400_000], FS)
    freqs = (30000.0, -12000.0, 5000.0, -40000.0)
    taps = design.blackmanharris(151)
    ref, rate = MultiDdcFm(FS, freqs, taps, 60000, fm=True).process(
        src, block_size=150_000, dtype=jnp.complex128)
    mesh = make_mesh(time=2, channel=4)
    got, rate2 = MultiDdcFm(FS, freqs, taps, 60000, fm=True,
                            mesh=mesh).process(
        src, block_size=150_000, dtype=jnp.complex128)
    assert rate == rate2
    assert np.max(np.abs(got - ref)) < 1e-12

    with pytest.raises(ValueError):
        MultiDdcFm(FS, freqs[:3], taps, 60000, mesh=mesh)


def test_stream_run_sharded(capture):
    """Chainable API end of the mesh path."""
    from directdemod_tpu.stream.api import Stream
    src = ArraySource(capture, FS)
    chain = (Stream(src, dtype=jnp.complex128)
             .shift(30000)
             .filter(design.blackmanharris(151))
             .bw_limit(60000)
             .fm_demod())
    ref, rate = chain.run_fused(block_size=100_000)
    got, rate2 = chain.run_sharded(make_mesh(time=8), block_size=100_000)
    assert rate == rate2
    assert np.max(np.abs(got - ref)) < 1e-9


def test_sharded_sync_correlation_matches_sequential():
    """Needle-halo sharded correlation + gathered adaptive threshold finds the
    same APT syncs as the single-device path."""
    from directdemod_tpu import constants as K
    from directdemod_tpu.ops import correlate as C, peaks
    from directdemod_tpu.parallel.correlate import sharded_find_sync_peaks
    from tests.apt_synth import synthesize

    iq, _ = synthesize(n_lines=12, snr_db=20)
    # make a crude envelope-like real signal: |iq| beats won't have syncs, so
    # instead decode the envelope the proper way via the NOAA front end
    from directdemod_tpu.models.noaa import NoaaDecoder
    from directdemod_tpu.io.sources import ArraySource
    dec = NoaaDecoder(ArraySource(iq, FS), 30000)
    audio, rate = dec._fm_audio(K.NOAA_CRUDESYNCSAMPRATE, strict=False)
    env = dec._am_envelope(audio)

    needle = C.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    seq = peaks.find_sync_peaks(
        C.norm_correlate(jnp.asarray(env, jnp.float32),
                         jnp.asarray(needle, jnp.float32)),
        rate, len(needle), K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)

    mesh = make_mesh(time=8, channel=1)
    got = sharded_find_sync_peaks(mesh, env, needle, rate,
                                  K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
    assert len(got) == len(seq)
    assert np.max(np.abs(np.asarray(got) - np.asarray(seq))) <= 1


def test_noaa_decoder_on_mesh():
    """Full NOAA decode with the mesh-sharded front end + sync search equals
    the sequential decode."""
    from directdemod_tpu.models.noaa import NoaaDecoder
    from tests.apt_synth import synthesize
    iq, _ = synthesize(n_lines=12, snr_db=20)
    seq = NoaaDecoder(ArraySource(iq, FS), 30000)
    img_seq = seq.get_image()
    mesh = make_mesh(time=8, channel=1)
    par = NoaaDecoder(ArraySource(iq, FS), 30000, mesh=mesh)
    assert par.useful == 1
    img_par = par.get_image()
    assert img_seq.shape == img_par.shape
    # identical sync decisions should give identical images
    assert np.array_equal(np.asarray(seq.get_crude_sync()[0]),
                          np.asarray(par.get_crude_sync()[0]))
    assert np.mean(img_seq == img_par) > 0.99
    # accurate sync: sharded window batch == sequential batch
    acc_seq = seq.get_accurate_sync()
    acc_par = par.get_accurate_sync()
    assert acc_seq[0] == acc_par[0] and acc_seq[4] == acc_par[4]
    assert np.allclose(acc_seq[2], acc_par[2], atol=1e-5)


def test_sharded_iir_matches_sequential():
    """Exact sharded lfilter / filtfilt == the single-device SOS engine."""
    from directdemod_tpu.ops.iir import IirFilter
    from directdemod_tpu.parallel.iir import sharded_lfilter, sharded_zero_phase
    rng = np.random.default_rng(3)
    filt = IirFilter.design_butter(60235, 400, 4400, order=6, kind="bandpass")
    mesh = make_mesh(time=8, channel=1)
    for n in (100_000, 100_003):        # even split + ragged tail
        x = rng.standard_normal(n)
        zi = np.asarray(filt.initial_state_step(jnp.float64)) * x[0]
        ref_y, ref_z = filt.apply(jnp.asarray(x), jnp.asarray(zi))
        got_y, got_z = sharded_lfilter(mesh, filt, x, zi)
        scale = np.max(np.abs(np.asarray(ref_y)))
        assert np.max(np.abs(got_y - np.asarray(ref_y))) < 1e-9 * scale, n
        assert np.allclose(got_z, np.asarray(ref_z), atol=1e-9 * scale)

        ref_zp = np.asarray(filt.zero_phase(jnp.asarray(x)))
        got_zp = sharded_zero_phase(mesh, filt, x)
        assert np.max(np.abs(got_zp - ref_zp)) < 1e-9 * scale, n


def test_sharded_envelope_matches_sequential():
    from directdemod_tpu.ops import am as am_ops
    from directdemod_tpu.parallel.am import sharded_envelope_blocked
    rng = np.random.default_rng(4)
    x = rng.standard_normal(7 * 2400 + 991).astype(np.float32)
    mesh = make_mesh(time=8, channel=1)
    ref = np.asarray(am_ops.envelope_blocked(jnp.asarray(x), 2400))
    got = sharded_envelope_blocked(mesh, x, 2400)
    assert np.max(np.abs(got - ref)) < 1e-5
