"""Runtime placement: where the persistent compile cache lives, and which
captures may be decoded device-resident."""
import os
import subprocess
import sys

import pytest

import directdemod_tpu
from directdemod_tpu.io import sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PRINT_CACHE = ("import directdemod_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert directdemod_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert directdemod_tpu.compile_cache_dir() == os.path.join(REPO,
                                                               ".jax_cache")


def _cache_dir_of_fresh_process(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    p = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       check=True)
    return p.stdout.strip().splitlines()[-1]


def test_compile_cache_lands_in_env_dir(tmp_path):
    """With the variable set, a fresh process caches there and nowhere
    else, creating the directory."""
    want = str(tmp_path / "cache")
    assert _cache_dir_of_fresh_process(want) == want
    assert os.path.isdir(want)


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir_of_fresh_process(None) == os.path.join(REPO,
                                                             ".jax_cache")


def test_resident_sample_limit():
    """Positions on the device are int32: no capture over 2^31 samples is
    admitted, whatever the device's memory (the CPU reports no limit)."""
    assert sources.RESIDENT_MAX_SAMPLES == 1 << 31
    assert sources.fits_resident(1 << 31)
    assert not sources.fits_resident((1 << 31) + 1)
    assert not sources.fits_resident((1 << 31) + 1, bytes_per_sample=1)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit,want", [
    (None, None),
    (sources.RESIDENT_RESERVE_BYTES // 2, 0),
    (sources.RESIDENT_RESERVE_BYTES + 3 * (1 << 30), 1 << 30),
])
def test_resident_max_bytes_from_memory_stats(limit, want):
    stats = None if limit is None else {"bytes_limit": limit}
    assert sources.resident_max_bytes(_Dev(stats)) == want


def test_resident_byte_cap_binds(monkeypatch):
    monkeypatch.setattr(sources, "resident_max_bytes",
                        lambda device=None: 1000)
    assert sources.fits_resident(500)                 # 1000 raw bytes
    assert not sources.fits_resident(501)
    assert not sources.fits_resident(200, bytes_per_sample=8)
