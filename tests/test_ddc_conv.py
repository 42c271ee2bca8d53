"""Dense byte-matmul DDC lowering (ops/ddc_conv) vs the fp64 oracle and the
XLA polyphase lowering, through the production stream and resident paths,
and the one choice between them (models/frontend.frontend_lowering).
chip_smoke.py checks both lowerings against the oracle on the card, and
bench.py times them."""
import numpy as np
import jax.numpy as jnp
import pytest

from directdemod_tpu.models import frontend
from directdemod_tpu.models.frontend import DdcFm, DdcFmStream
from directdemod_tpu.ops import design
from directdemod_tpu.ops.ddc_conv import byte_plan, ddc_bytes, ddc_fm_bytes


def _fe():
    return DdcFm(2048000, 30000, design.blackmanharris(151), 60000, fm=True)


def _ref_c(fe, raw, out_len):
    x = (raw[0::2].astype(np.float64) - 127.5) \
        + 1j * (raw[1::2].astype(np.float64) - 127.5)
    w = np.asarray(fe.taps_mod)[::-1]
    j, k = fe.stride, len(fe.taps)
    return np.asarray([np.dot(w, x[m * j:m * j + k]) for m in range(out_len)])


def test_byte_plan_geometry():
    fe = _fe()
    plan = byte_plan(fe.taps_mod[::-1], fe.stride)
    # J=34: lcm(68,128)=2176 -> 32 outputs / 17 rows per group, 19-row window
    assert (plan.G, plan.P, plan.W) == (32, 17, 19)
    assert plan.parts[0].shape == (19, 128, 64)


def test_dot_and_conv_match_oracle(rng):
    fe = _fe()
    j, k = fe.stride, len(fe.taps)
    out_len = 517                              # ragged (not a group multiple)
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k) + 32) \
        .astype(np.uint8)
    plan = byte_plan(fe.taps_mod[::-1], j)
    ref = plan.oracle(raw, out_len)
    assert np.max(np.abs(ref - _ref_c(fe, raw, out_len))) < 1e-9

    for mode in ("dot", "conv"):
        (re, im), c_last = ddc_bytes(plan, jnp.asarray(raw),
                                     jnp.zeros(1, jnp.complex64),
                                     out_len, mode)
        c = np.asarray(re) + 1j * np.asarray(im)
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(c - ref)) / scale < 5e-6, mode
        assert abs(complex(np.asarray(c_last)[0]) - ref[-1]) / scale < 5e-6


def test_nsplit_precision_ladder(rng):
    """bf16 residual splits: bytes are exact in bf16, so nsplit parts give
    ~2^-8/−16/−24 relative tap accuracy (the round-5 precision experiment,
    docs/experiments.md)."""
    fe = _fe()
    j, k = fe.stride, len(fe.taps)
    out_len = 256
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k)).astype(np.uint8)
    ref = byte_plan(fe.taps_mod[::-1], j).oracle(raw, out_len)
    scale = np.max(np.abs(ref))
    errs = []
    for ns in (1, 2, 3):
        plan = byte_plan(fe.taps_mod[::-1], j, nsplit=ns)
        (re, im), _ = ddc_bytes(plan, jnp.asarray(raw),
                                jnp.zeros(1, jnp.complex64), out_len, "dot")
        errs.append(np.max(np.abs(np.asarray(re) + 1j * np.asarray(im) - ref))
                    / scale)
    assert errs[0] < 3e-2 and errs[1] < 3e-4 and errs[2] < 5e-6
    assert errs[2] < errs[1] < errs[0]


def test_fm_wrapper_matches_oracle(rng):
    """ddc_fm_bytes (fused unpack+DDC+FM) vs the discriminator applied to
    the fp64 oracle, with a carried c_prev."""
    fe = _fe()
    j, k = fe.stride, len(fe.taps)
    out_len = 700
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k)).astype(np.uint8)
    cp = np.asarray([1.0 + 0.5j], np.complex64)
    rot = np.complex64(fe.rot)
    plan = byte_plan(fe.taps_mod[::-1], j)
    a1, c1 = ddc_fm_bytes(plan, jnp.asarray(raw), jnp.asarray(rot),
                          jnp.asarray(cp), out_len)
    c = plan.oracle(raw, out_len)
    prev = np.concatenate([cp.astype(np.complex128), c[:-1]])
    ref = np.angle(c * np.conj(prev) * fe.rot)
    d = np.abs(np.asarray(a1) - ref)
    assert np.percentile(d, 99.9) < 1e-4
    assert d.max() < 2e-2
    assert abs(complex(np.asarray(c1)[0]) - c[-1]) / np.max(np.abs(c)) < 5e-6


def test_gemm_u8_stream_backend_matches_xla(rng):
    """DdcFmStream lowering 'gemm_u8' (the GPU choice) vs 'xla' over
    multiple raw blocks — chunk-boundary byte-history carry included."""
    n_blk, blocks = 150_000, 3
    raw = rng.integers(0, 256, 2 * n_blk * blocks).astype(np.uint8)
    fe = _fe()

    ref_stream = DdcFmStream(fe, lowering="xla")
    got_stream = DdcFmStream(fe, lowering="gemm_u8")
    for i in range(blocks):
        seg = jnp.asarray(raw[2 * i * n_blk: 2 * (i + 1) * n_blk])
        r = np.asarray(ref_stream.step(seg, i * n_blk))
        g = np.asarray(got_stream.step(seg, i * n_blk))
        d = np.abs(r - g)
        assert np.percentile(d, 99.9) < 1e-4
        assert d.max() < 2e-2


def test_resident_frontend_gemm_matches_blocked(rng):
    """resident_frontend (the platform's lowering) vs the blocked gemm
    stream on the same raw capture."""
    n = 420_000
    raw_np = rng.integers(0, 256, 2 * n).astype(np.uint8)
    fe = _fe()

    stream = DdcFmStream(fe, lowering="gemm_u8")
    blk = 150_000
    ref = np.concatenate([
        np.asarray(stream.step(jnp.asarray(raw_np[2 * s: 2 * min(s + blk, n)]),
                               s))
        for s in range(0, n, blk)])
    got = np.asarray(fe.resident_frontend(jnp.asarray(raw_np), n))
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert np.percentile(d, 99.9) < 1e-4
    assert d.max() < 2e-2


def test_gemm_u8_process_matches_xla_stream(tmp_path, rng):
    """Production DdcFm.process with the byte-GEMM lowering vs the XLA
    lowering on a multi-block raw .dat stream (chunk-boundary byte-history
    carry included). Angle outputs are fp32 in both; tolerance is
    distributional because the polar discriminator amplifies rounding where
    |c| is tiny."""
    from directdemod_tpu.io.sources import IQDat

    n = 700_000
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    p = tmp_path / "c.dat"
    raw.tofile(p)
    src = IQDat(str(p), 2048000)
    fe = _fe()
    a1, r1 = fe.process(src, block_size=200_000, lowering="xla")
    a2, r2 = fe.process(src, block_size=200_000, lowering="gemm_u8")
    assert r1 == r2 and len(a1) == len(a2)
    d = np.abs(a1 - a2)
    assert np.percentile(d, 99.9) < 1e-4
    assert d.max() < 2e-2


def test_ddcfm_stream_mixed_lowering_state(rng):
    """DdcFmStream: byte-GEMM steady blocks followed by an XLA block must
    carry exact state across the lowering switch (the complex conv history
    is refreshed from the raw tail bytes)."""
    from directdemod_tpu.ops import unpack

    n_blk, blocks = 150_000, 3
    raw = rng.integers(0, 256, 2 * n_blk * blocks).astype(np.uint8)
    fe = _fe()

    ref_stream = DdcFmStream(fe, lowering="xla")
    ref = [np.asarray(ref_stream.step(
        jnp.asarray(raw[2 * i * n_blk: 2 * (i + 1) * n_blk]), i * n_blk))
        for i in range(blocks)]

    got_stream = DdcFmStream(fe, lowering="gemm_u8")
    got = []
    for i in range(blocks):
        seg = raw[2 * i * n_blk: 2 * (i + 1) * n_blk]
        if i == 2:   # complex block: forces the XLA step mid-stream
            x = unpack.iq_u8_to_complex(jnp.asarray(seg), jnp.float32)
        else:
            x = jnp.asarray(seg)
        got.append(np.asarray(got_stream.step(x, i * n_blk)))

    for r, g in zip(ref, got):
        d = np.abs(r - g)
        assert np.percentile(d, 99.9) < 1e-4
        assert d.max() < 2e-2


@pytest.mark.parametrize("lowering", ["gemm_u8", "xla"])
def test_resident_frontend_matches_blocked_stream(rng, lowering):
    """DdcFm._resident_scan (XLA block 0 + scanned chunk steps) vs the
    blocked DdcFmStream on the same raw capture, with a small chunk so the
    scan arm runs (production chunks are 20M samples, larger than any CPU
    test capture): the per-output windows are identical dots."""
    n = 420_000
    raw_np = rng.integers(0, 256, 2 * n).astype(np.uint8)
    fe = _fe()
    stream = DdcFmStream(fe, lowering="xla")
    blk = 150_000
    ref = np.concatenate([
        np.asarray(stream.step(jnp.asarray(raw_np[2 * s: 2 * min(s + blk, n)]),
                               s))
        for s in range(0, n, blk)])
    got = np.asarray(fe._resident_scan(jnp.asarray(raw_np), n, True,
                                       lowering, 100_000))
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert np.percentile(d, 99.9) < 1e-4
    assert d.max() < 2e-2


def test_resident_complex_scan_matches_fir_decimate(rng):
    """The fm=False resident stream (AFSK's front end) through the scanned
    chunks equals one whole-capture fir_decimate of the unpacked bytes."""
    from directdemod_tpu.ops import fir, unpack
    from directdemod_tpu.ops import resample as rs

    n = 300_000
    raw_np = rng.integers(0, 256, 2 * n).astype(np.uint8)
    fe = DdcFm(2048000, 12000, design.blackmanharris(151), 22050, fm=False)
    x = unpack.iq_u8_to_complex(jnp.asarray(raw_np), jnp.float32)
    ref, _ = fir.fir_decimate(x, jnp.asarray(fe.taps_mod, jnp.complex64),
                              jnp.asarray(fe.hist0, jnp.complex64),
                              jnp.int32(0), rs.decim_count(n, 0, fe.stride),
                              fe.stride)
    got = fe._resident_scan(jnp.asarray(raw_np), n, False, "gemm_u8", 50_000)
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-6


def test_frontend_lowering_choice():
    """One function picks the lowering: bytes take the byte-GEMM on the GPU
    and the polyphase conv on the CPU; complex input can only take the
    polyphase conv; an unknown platform is an error."""
    assert frontend.frontend_lowering("gpu", raw=True) == "gemm_u8"
    assert frontend.frontend_lowering("cpu", raw=True) == "xla"
    assert frontend.frontend_lowering("gpu", raw=False) == "xla"
    with pytest.raises(ValueError):
        frontend.frontend_lowering("rocm", raw=True)


def test_stream_and_resident_share_the_choice(monkeypatch, rng):
    """DdcFmStream's default and resident_frontend both take
    frontend_lowering's answer for the platform."""
    seen = []

    def choose(platform, raw):
        seen.append((platform, raw))
        return "gemm_u8"

    monkeypatch.setattr(frontend, "frontend_lowering", choose)
    fe = DdcFm(2048000, 30000, design.blackmanharris(151), 60000, fm=True)
    assert DdcFmStream(fe).lowering == "gemm_u8"
    raw = jnp.asarray(rng.integers(0, 256, 2 * 50_000).astype(np.uint8))
    fe.resident_frontend(raw, 50_000)
    import jax
    assert seen == [(jax.default_backend(), True)] * 2


def test_odd_stride_plan(rng):
    """A stride whose 2J shares only a factor 2 with 128 (J=25 -> G=64)
    exercises the general group geometry."""
    j = 25
    taps = design.blackmanharris(101)
    w = 2.0 * np.pi * 12000.0 / 1_000_000.0
    taps_mod = (taps * np.exp(1j * w * np.arange(101)))[::-1]
    plan = byte_plan(taps_mod, j)
    assert plan.G == 64 and plan.P == 25
    out_len = 201
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + 101) + 7) \
        .astype(np.uint8)
    ref = plan.oracle(raw, out_len)
    (re, im), _ = ddc_bytes(plan, jnp.asarray(raw),
                            jnp.zeros(1, jnp.complex64), out_len, "dot")
    c = np.asarray(re) + 1j * np.asarray(im)
    assert np.max(np.abs(c - ref)) / np.max(np.abs(ref)) < 5e-6
