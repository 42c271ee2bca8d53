"""The AFSK peak walk: the Triton walk kernel (Pallas interpret mode here)
against the plain lax.scan walk, its CUDA lowering, and the one platform
choice of lowering. The compiled kernel runs on the card in chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from directdemod_tpu.ops import peaks


def _stress_y(n, seed=0):
    """|edge correlation| of a noisy square wave: fires every few samples."""
    rng = np.random.default_rng(seed)
    bf = np.sign(np.sin(np.arange(n) / 9.0) + 0.3 * rng.standard_normal(n))
    k = np.concatenate([-np.ones(9), np.ones(9)])
    return np.abs(np.convolve(bf, k, "same") / 18).astype(np.float32)


def test_triton_walk_matches_dense_scan():
    n, lookahead, cap = 6144, 11, 4096
    y = jnp.asarray(_stress_y(n))
    flat = np.asarray(peaks._lookahead_events_triton(
        y, lookahead, 0.0, cap, interpret=True))
    got = peaks.unpack_lookahead_events(flat, lookahead, n, cap)
    want = peaks._lookahead_peaks_dense(y, lookahead, 0.0)
    assert got is not None
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[0]) > 50          # the stress input actually fires


def test_triton_walk_overflow_reports():
    n, lookahead, cap = 6144, 11, 8    # tiny cap: must flag, not truncate
    y = jnp.asarray(_stress_y(n, seed=1))
    flat = np.asarray(peaks._lookahead_events_triton(
        y, lookahead, 0.0, cap, interpret=True))
    assert peaks.unpack_lookahead_events(flat, lookahead, n, cap) is None
    full = np.asarray(peaks._lookahead_events_scan(y, lookahead, 0.0, cap))
    assert flat[-1] == full[-1]       # both count every fire, kept or not


@pytest.mark.parametrize("delta", [0.0, 0.05])
def test_triton_walk_packed_equals_scan_packed(delta):
    """The kernel writes the scan path's packed record bit for bit, the
    zeroed unused rows included."""
    n, lookahead, cap = 4000, 11, 2048
    y = jnp.asarray(_stress_y(n, seed=2))
    a = np.asarray(peaks._lookahead_events_triton(
        y, lookahead, delta, cap, interpret=True))
    b = np.asarray(peaks._lookahead_events_scan(y, lookahead, delta, cap))
    np.testing.assert_array_equal(a, b)


def test_triton_walk_lowers_for_cuda():
    """The kernel lowers through Pallas' Triton route for a CUDA target on
    a host with no card (the GPU compiler itself runs on the card)."""
    y = jnp.asarray(_stress_y(4096))
    lowered = peaks._lookahead_events_triton.trace(
        y, 11, 0.0, 1024).lower(lowering_platforms=("cuda",))
    assert "lookahead_walk" in lowered.as_text()


def test_walk_lowering_by_platform():
    assert peaks.walk_lowering("gpu") == "triton"
    assert peaks.walk_lowering("cpu") == "scan"
    with pytest.raises(ValueError):
        peaks.walk_lowering("rocm")


def test_dispatcher_follows_platform_choice(monkeypatch):
    """lookahead_events_packed takes the lowering walk_lowering names for
    the default backend, and nothing else."""
    calls = []
    monkeypatch.setattr(peaks, "walk_lowering",
                        lambda platform: calls.append(platform) or "triton")
    monkeypatch.setattr(
        peaks, "_lookahead_events_triton",
        lambda y, la, d, cap: peaks._lookahead_events_scan(y, la, d, cap) + 1)
    y = jnp.asarray(_stress_y(2048))
    got = np.asarray(peaks.lookahead_events_packed(y, 11, 0.0, 512))
    want = np.asarray(peaks._lookahead_events_scan(y, 11, 0.0, 512)) + 1
    np.testing.assert_array_equal(got, want)
    assert calls == [jax.default_backend()]


def test_lookahead_peaks_rewalks_on_overflow(monkeypatch):
    """When the first event record overflows, lookahead_peaks walks again
    with one slot per index and returns the complete lists."""
    n, lookahead = 3000, 11
    y = jnp.asarray(_stress_y(n, seed=3))
    caps = []
    real = peaks.lookahead_events_packed

    def overflow_first(y_, la, d, cap):
        caps.append(cap)
        if len(caps) == 1:                 # an overflowed record
            return jnp.zeros(5 * cap + 1).at[-1].set(cap + 1)
        return real(y_, la, d, cap)

    monkeypatch.setattr(peaks, "lookahead_events_packed", overflow_first)
    got = peaks.lookahead_peaks(y, lookahead)
    assert got == peaks._lookahead_peaks_dense(y, lookahead, 0.0)
    assert caps == [min(n - lookahead, 1 << 18), n - lookahead]


@pytest.mark.gpu
def test_triton_walk_compiled_matches_dense(gpu):
    """The compiled kernel on the card (chip_smoke.py runs this at the
    length of a 60 s AFSK capture)."""
    n, lookahead, cap = 1 << 16, 11, 1 << 14
    y = jnp.asarray(_stress_y(n))
    flat = np.asarray(peaks._lookahead_events_triton(y, lookahead, 0.0, cap))
    got = peaks.unpack_lookahead_events(flat, lookahead, n, cap)
    assert got == peaks._lookahead_peaks_dense(y, lookahead, 0.0)
