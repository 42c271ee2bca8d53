"""CLI surface: flag parsing quirks, end-to-end decode, JSON report."""
import json
import os
import struct

import numpy as np
import pytest

from directdemod_tpu import cli
from tests.apt_synth import synthesize, FS


def _write_wav(path, iq, scale=1.0):
    u8 = np.empty(2 * len(iq), np.uint8)
    u8[0::2] = np.clip(np.round(iq.real * scale + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(iq.imag * scale + 127.5), 0, 255).astype(np.uint8)
    payload = u8.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 2, FS, FS * 2, 2, 8))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


@pytest.fixture(scope="module")
def noaa_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    iq, _ = synthesize(n_lines=12, snr_db=20)
    path = str(d / "SDRSharp_20170830_073907Z_137590000Hz_IQ.wav")
    _write_wav(path, iq)
    return path


def test_cli_noaa_with_report_and_filename_centre(noaa_wav, tmp_path):
    """-ce style: centre frequency parsed from the file name (ref main.py:167-173)."""
    report = str(tmp_path / "report.json")
    out = str(tmp_path / "outimg")
    rc = cli.main(["-f", "137620000", "-d", "noaa", "-o", out,
                   "-r", report, noaa_wav])
    assert rc == 0
    rep = json.load(open(report))
    assert rep["centreFreq"] == 137590000
    ch = rep["channels"][0]
    assert ch["offset"] == 30000
    assert ch["usefulness"] == 1
    assert out + ".png" in ch["filesCreated"]
    assert os.path.exists(out + ".png")


def test_cli_sync_flag_quirk(noaa_wav, tmp_path):
    """-sync parses as ('-s','ync') and must not be taken as a start index."""
    report = str(tmp_path / "r.json")
    out = str(tmp_path / "o2")
    rc = cli.main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out, "-sync", "-noimage", "-r", report, noaa_wav])
    assert rc == 0
    ch = json.load(open(report))["channels"][0]
    assert ch["syncDetect"] is True and ch["image"] is False
    assert out + ".csv" in ch["filesCreated"]
    assert not os.path.exists(out + ".png")
    # csv has the 8 reference columns
    header = open(out + ".csv").readline()
    assert header.count(",") == 8


def test_cli_iq_swap_negates_offset(noaa_wav, tmp_path):
    report = str(tmp_path / "r.json")
    cli.main(["-q", "-c", "137590000", "-f", "137620000", "-d", "noaa",
              "-noimage", "-r", report, noaa_wav])
    assert json.load(open(report))["channels"][0]["offset"] == -30000


def test_cli_bad_decoder_is_fenced(noaa_wav, tmp_path):
    """A failing channel must not kill the run (ref main.py:347-349)."""
    report = str(tmp_path / "r.json")
    rc = cli.main(["-c", "137590000", "-f", "1", "-d", "noaa",
                   "-e", "99999999999", "-r", report, noaa_wav])
    assert rc == 0
    assert os.path.exists(report)


def test_cli_noise_only_capture(tmp_path):
    """No signal -> usefulness 0, no image files, clean exit."""
    rng = np.random.default_rng(0)
    n = FS  # 1 second of noise
    iq = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    path = str(tmp_path / "SDRSharp_20170830_073907Z_137590000Hz_IQ.wav")
    _write_wav(path, iq, scale=60.0)
    report = str(tmp_path / "r.json")
    out = str(tmp_path / "noise_out")
    rc = cli.main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out, "-r", report, path])
    assert rc == 0
    ch = json.load(open(report))["channels"][0]
    assert ch["usefulness"] == 0
    assert not os.path.exists(out + ".png")


def test_cli_funcube_segments(tmp_path):
    """--segments reaches the PSK decoder: segment-parallel funcube decode
    from the CLI produces the same sync as the sequential decoder API."""
    from directdemod_tpu import constants as K
    from directdemod_tpu.io.sources import ArraySource
    from directdemod_tpu.models.funcube import FuncubeDecoder
    from tests.test_psk_sync import _bpsk_capture
    spacing = K.FUNCUBE_FRAME_SPACING_S
    cap = _bpsk_capture([2.0, 2.0 + spacing], dur_s=2.0 + spacing + 1.2)
    seq = FuncubeDecoder(ArraySource(cap, FS), 5000)
    syncs_seq = seq.get_syncs()
    assert len(syncs_seq) == 1

    path = str(tmp_path / "SDRSharp_20170830_073907Z_145940000Hz_IQ.dat")
    u8 = np.empty(2 * len(cap), np.uint8)
    u8[0::2] = np.clip(np.round(cap.real + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(cap.imag + 127.5), 0, 255).astype(np.uint8)
    u8.tofile(path)
    out = str(tmp_path / "fc")
    report = str(tmp_path / "r.json")
    rc = cli.main(["-c", "145940000", "-f", "145945000", "-d", "funcube",
                   "--segments", "4", "-o", out, "-r", report, path])
    assert rc == 0
    ch = json.load(open(report))["channels"][0]
    assert ch["usefulness"] == 1
    rows = open(out + ".csv").read().strip().splitlines()
    assert len(rows) == 2                      # header + one sync
    got = float(rows[1].split(",")[0])
    assert abs(got - syncs_seq[0]) < 0.01 * FS


def test_cli_meteor_segments(tmp_path):
    """--segments also reaches the meteor decoder: segment-parallel QPSK
    decode from the CLI matches the sequential decoder API."""
    from directdemod_tpu import constants as K
    from directdemod_tpu.io.sources import ArraySource
    from directdemod_tpu.models.meteorm2 import MeteorM2Decoder
    from tests.test_psk_sync import _qpsk_capture
    spacing = K.METEOR_FRAME_SPACING_S
    frames = [0.5 + i * spacing for i in range(5)]
    cap = _qpsk_capture(frames, dur_s=1.4)
    seq = MeteorM2Decoder(ArraySource(cap, FS), 4000)
    syncs_seq = seq.get_syncs()
    assert len(syncs_seq) >= 2

    path = str(tmp_path / "SDRSharp_20170830_073907Z_137896000Hz_IQ.dat")
    u8 = np.empty(2 * len(cap), np.uint8)
    u8[0::2] = np.clip(np.round(cap.real + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(cap.imag + 127.5), 0, 255).astype(np.uint8)
    u8.tofile(path)
    out = str(tmp_path / "mm")
    report = str(tmp_path / "r.json")
    rc = cli.main(["-c", "137896000", "-f", "137900000", "-d", "meteor",
                   "--segments", "4", "-o", out, "-r", report, path])
    assert rc == 0
    ch = json.load(open(report))["channels"][0]
    assert ch["usefulness"] == 1
    rows = open(out + ".csv").read().strip().splitlines()[1:]
    got = np.asarray([float(r.split(",")[0]) for r in rows])
    # every sequential sync has a CLI counterpart nearby (re-lock tolerance)
    for s0 in syncs_seq:
        assert np.min(np.abs(got - s0)) < 0.02 * FS


def test_cli_resident_noaa(noaa_wav, tmp_path):
    """--resident uploads the capture once into a DeviceRawSource and the
    decoders take the single-dispatch resident paths; output must equal the
    blocked-feed decode bit for bit."""
    out_r = str(tmp_path / "res")
    out_b = str(tmp_path / "blk")
    rep_r = str(tmp_path / "rep_r.json")
    rc = cli.main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out_r, "-r", rep_r, "--resident", noaa_wav])
    assert rc == 0
    rep = json.load(open(rep_r))
    ch = rep["channels"][0]
    assert ch["usefulness"] == 1 and ch["resident"] is True
    assert os.path.exists(out_r + ".png")
    rc = cli.main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out_b, noaa_wav])
    assert rc == 0
    from PIL import Image
    a = np.asarray(Image.open(out_r + ".png"))
    b = np.asarray(Image.open(out_b + ".png"))
    assert a.shape == b.shape
    assert np.array_equal(a, b)


def test_cli_resident_capacity_fallback(noaa_wav, tmp_path, monkeypatch):
    """A capture over the resident capacity keeps the blocked feed (and
    still decodes)."""
    from directdemod_tpu.io import sources
    monkeypatch.setattr(sources, "resident_max_bytes",
                        lambda device=None: 1024)
    rep = str(tmp_path / "rep.json")
    out = str(tmp_path / "cap")
    rc = cli.main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out, "-r", rep, "--resident", noaa_wav])
    assert rc == 0
    ch = json.load(open(rep))["channels"][0]
    assert ch["usefulness"] == 1 and ch["resident"] is False
    assert os.path.exists(out + ".png")


def test_cli_funcube_resident_segments(tmp_path):
    """--resident composes with --segments on the PSK path: the uploaded
    DeviceRawSource feeds the whole-capture fast path and the syncs match
    the file-fed decode."""
    from directdemod_tpu import constants as K
    from tests.test_psk_sync import _bpsk_capture
    spacing = K.FUNCUBE_FRAME_SPACING_S
    cap = _bpsk_capture([2.0, 2.0 + spacing], dur_s=2.0 + spacing + 1.2)
    path = str(tmp_path / "SDRSharp_20170830_073907Z_145940000Hz_IQ.dat")
    u8 = np.empty(2 * len(cap), np.uint8)
    u8[0::2] = np.clip(np.round(cap.real + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(cap.imag + 127.5), 0, 255).astype(np.uint8)
    u8.tofile(path)

    outs, reports = [], []
    for i, extra in enumerate(([], ["--resident"])):
        out = str(tmp_path / f"fc{i}")
        rep = str(tmp_path / f"r{i}.json")
        rc = cli.main(["-c", "145940000", "-f", "145945000", "-d", "funcube",
                       "--segments", "4", "-o", out, "-r", rep]
                      + extra + [path])
        assert rc == 0
        outs.append(open(out + ".csv").read())
        reports.append(json.load(open(rep))["channels"][0])
    assert reports[0]["usefulness"] == reports[1]["usefulness"] == 1
    assert reports[1]["resident"] is True
    assert outs[0] == outs[1]                  # identical sync csv
