"""The port's ``cli/evaluate.py``, ``cli/wavlst.py`` and ``utils/plotting.py``
against the JAX package's, on the CPU.

Both evaluate CLIs score the same two directories (two speech-like 24 kHz
files, one with noise and one delayed, and one too short for PESQ and
STOI): the JSON must agree key for key, PESQ, STOI and ESTOI equal, the mel
distance within 1e-5 relative, the skipped files as null with their counts.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from academicodec_tpu.cli import evaluate as jevaluate
from academicodec_tpu.cli import wavlst as jwavlst

from academicodec_tpu_torch.cli import evaluate, wavlst
from academicodec_tpu_torch.data.wavio import write_wav
from academicodec_tpu_torch.utils import plotting
from tests.test_pesq import _add_noise, _speech_like
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

SR = 24000


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    ref_dir, deg_dir = root / "ref", root / "deg"
    ref_dir.mkdir(), deg_dir.mkdir()
    x = _speech_like(SR, seconds=1.5).astype(np.float32)
    delayed = np.concatenate([np.zeros(240), x[:-240]])
    for name, ref, deg in (("a.wav", x, _add_noise(x, 15.0)), ("b.wav", x, delayed),
                           ("c.wav", x[6000:7500], x[6000:7500])):
        write_wav(str(ref_dir / name), ref, SR)
        write_wav(str(deg_dir / name), deg.astype(np.float32), SR)
    write_wav(str(deg_dir / "unpaired.wav"), x, SR)
    return root


def _run_both(dirs, monkeypatch, *extra):
    ours, theirs = str(dirs / "ours.json"), str(dirs / "theirs.json")
    flags = ["--ref_dir", str(dirs / "ref"), "--deg_dir", str(dirs / "deg"), "--sr", str(SR), *extra]
    evaluate.main(flags + ["--json_out", ours, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["evaluate", *flags, "--json_out", theirs])
    jevaluate.main()

    def strict(c):
        raise AssertionError(f"non-strict JSON constant {c}")

    return [json.loads(open(p).read(), parse_constant=strict) for p in (ours, theirs)]


def _close(got, want, key):
    if want is None or got is None:
        assert got is None and want is None, (key, got, want)
    elif key.startswith("mel_l1"):
        assert abs(got - want) <= 1e-5 * abs(want), (key, got, want)
    elif key.startswith("si_snr"):
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), (key, got, want)
    else:
        assert got == want, (key, got, want)


@pytest.mark.parametrize("estoi", [False, True])
def test_evaluate_cli_json_equals_jax(dirs, monkeypatch, capsys, estoi):
    ours, theirs = _run_both(dirs, monkeypatch, *(["--estoi"] if estoi else []))
    assert sorted(ours) == sorted(theirs) == ["mean", "per_file", "skipped"]
    assert ours["skipped"] == theirs["skipped"]
    assert ours["skipped"]["pesq_wb"] == ours["skipped"]["stoi"] == 1
    assert ("estoi" in ours["mean"]) == estoi
    assert sorted(ours["mean"]) == sorted(theirs["mean"])
    for k in ours["mean"]:
        _close(ours["mean"][k], theirs["mean"][k], k)
    assert len(ours["per_file"]) == len(theirs["per_file"]) == 3
    for a, b in zip(ours["per_file"], theirs["per_file"]):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k], k)
    assert ours["per_file"][2]["pesq_nb"] is None and math.isfinite(ours["mean"]["pesq_nb"])
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("pesq_wb:")]
    assert len(lines) == 2 and lines[0].endswith("(skipped 1/3 files)") and lines[0] == lines[1]


def test_evaluate_cli_needs_a_card_unless_cpu_is_asked_for(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--ref_dir", str(dirs / "ref"), "--deg_dir", str(dirs / "deg")])


def test_wavlst_writes_the_jax_file(tmp_path, monkeypatch):
    (tmp_path / "w" / "sub").mkdir(parents=True)
    for rel in ("b.wav", "a.wav", "sub/c.wav", "sub/skip.flac"):
        (tmp_path / "w" / rel).write_bytes(b"")
    ours, theirs = str(tmp_path / "ours.lst"), str(tmp_path / "theirs.lst")
    wavlst.main(["--wavdir", str(tmp_path / "w"), "--outfile", ours])
    monkeypatch.setattr(sys, "argv", ["wavlst", "--wavdir", str(tmp_path / "w"), "--outfile", theirs])
    jwavlst.main()
    text = open(ours).read()
    assert text == open(theirs).read() and len(text.splitlines()) == 3


def test_plotting_returns_a_path_or_none_without_matplotlib(tmp_path, monkeypatch):
    mel = np.random.default_rng(0).standard_normal((16, 40)).astype(np.float32)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert plotting.save_spectrogram_png(mel, str(tmp_path / "m.png")) is None
    else:
        path = plotting.save_spectrogram_png(mel, str(tmp_path / "m.png"))
        assert path == str(tmp_path / "m.png") and os.path.getsize(path) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plotting.save_spectrogram_png(mel, str(tmp_path / "n.png")) is None
    assert not os.path.exists(tmp_path / "n.png")


def test_chip_smoke_phase_evaluate_rehearsal():
    """chip_smoke's ``evaluate`` phase at a tiny width on the CPU: both codec
    CLIs on two speech-like files, ``cli.evaluate`` on each output, the
    identical pair's anchors."""
    import chip_smoke

    hifi = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), encoder_base_channels=8, n_codes=64)
    r = chip_smoke.phase_evaluate("cpu", n_files=2, min_seconds=1.0, max_seconds=1.5,
                                  overrides=dict(n_filters=4, dimension=32, bins=64), hifi_overrides=hifi)
    for tag in ("encodec", "hificodec"):
        assert sorted(r[tag]["mean"]) == ["estoi", "mel_l1", "pesq_nb", "pesq_wb", "si_snr", "stoi"]
        assert r[tag]["mel_card_vs_cpu_rel"] == 0.0 and not any(r[tag]["skipped"].values())
    assert abs(r["identical"]["pesq_wb"] - 4.644) <= 1e-3
