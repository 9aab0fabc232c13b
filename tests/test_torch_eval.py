"""The port's objective metrics against the JAX package's, on the CPU.

Seeded speech-like pairs at 16 kHz, 3 s (tests/test_pesq.py's signal): the
identical pair, the reference with noise at SNR 10 dB, the reference
delayed by 12 ms, and a pair too short for STOI's 384 ms segments and
PESQ's 0.25 s. STOI, ESTOI, PESQ nb/wb and ``time_align`` are the same host
arithmetic in both packages and must be equal; SI-SNR within 1e-12 abs;
the mel distance (the port's on a torch device, JAX's in jnp) within 1e-5
relative; ``evaluate_pair`` the same keys and values, the NaN rows too.
"""

import math
import sys

import numpy as np
import pytest
import torch

from academicodec_tpu.eval import metrics as jmetrics
from academicodec_tpu.eval import pesq as jpesq
from academicodec_tpu.eval import stoi as jstoi

from academicodec_tpu_torch.eval import metrics, pesq, stoi
from tests.test_pesq import _add_noise, _speech_like
from tests.test_torch_train import one_torch_thread  # noqa: F401 (an autouse fixture)

SR = 16000
DELAY = int(0.012 * SR)


@pytest.fixture(scope="module")
def pairs():
    """``name -> (reference, degraded)``."""
    x = _speech_like(SR)
    return {
        "identical": (x, x.copy()),
        "snr10": (x, _add_noise(x, 10.0)),
        "delay12ms": (x, np.concatenate([np.zeros(DELAY), x[:-DELAY]])),
    }


@pytest.fixture(scope="module")
def short():
    x = _speech_like(SR)[SR // 4: SR // 4 + 2000]
    return x, _add_noise(x, 20.0)


@pytest.mark.parametrize("name", ["identical", "snr10", "delay12ms"])
def test_stoi_and_estoi_equal_jax(pairs, name):
    ref, deg = pairs[name]
    assert stoi.stoi(ref, deg, SR) == jstoi.stoi(ref, deg, SR)
    assert stoi.stoi(ref, deg, SR, extended=True) == jstoi.stoi(ref, deg, SR, extended=True)
    both = stoi.stoi_and_estoi(ref, deg, SR)
    assert both == jstoi.stoi_and_estoi(ref, deg, SR)
    if name == "identical":
        assert both[0] > 0.99


@pytest.mark.parametrize("mode", ["nb", "wb"])
@pytest.mark.parametrize("name", ["identical", "snr10", "delay12ms"])
def test_pesq_equals_jax(pairs, name, mode):
    ref, deg = pairs[name]
    got = pesq.pesq(SR, ref, deg, mode)
    assert got == jpesq.pesq(SR, ref, deg, mode)
    if name == "identical":
        assert got == pytest.approx({"nb": 4.549, "wb": 4.644}[mode], abs=1e-3)


@pytest.mark.parametrize("name", ["identical", "delay12ms"])
def test_time_align_equals_jax(pairs, name):
    ref, deg = pairs[name]
    got = pesq.time_align(ref, deg, SR)
    assert got == jpesq.time_align(ref, deg, SR) and got
    if name == "delay12ms":
        assert all(abs(d - DELAY) <= 64 for _s, _e, d in got)


def test_too_short_raises_in_both(short):
    ref, deg = short
    for mod in (stoi, jstoi):
        with pytest.raises(ValueError):
            mod.stoi(ref, deg, SR)
        with pytest.raises(ValueError):
            mod.stoi_and_estoi(ref, deg, SR)
    for mod in (pesq, jpesq):
        with pytest.raises(ValueError, match="short"):
            mod.pesq(SR, ref[:1000], deg[:1000], "nb")


@pytest.mark.parametrize("name", ["identical", "snr10", "delay12ms"])
def test_si_snr_and_mel_distance_match_jax(pairs, name):
    ref, deg = pairs[name]
    assert abs(metrics.si_snr(deg, ref) - jmetrics.si_snr(deg, ref)) <= 1e-12
    want = jmetrics.mel_distance(deg, ref, SR)
    got = metrics.mel_distance(deg, ref, SR, device="cpu")
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (got, want)


def _same_row(got: dict, want: dict, mel_rtol=1e-5):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k == "mel_l1":
            assert abs(g - w) <= mel_rtol * max(abs(w), 1e-6), (k, g, w)
        elif k == "si_snr":
            assert abs(g - w) <= 1e-12, (k, g, w)
        elif math.isnan(w):
            assert math.isnan(g), (k, g)
        else:
            assert g == w, (k, g, w)


@pytest.mark.parametrize("estoi", [False, True])
def test_evaluate_pair_equals_jax(pairs, short, estoi):
    """Every key and value, including the NaN rows of a pair too short for
    STOI and PESQ."""
    rows = [pairs["snr10"], short]
    if estoi:
        rows = [pairs["identical"], short]
    for ref, deg in rows:
        got = metrics.evaluate_pair(deg, ref, SR, estoi=estoi, device="cpu")
        want = jmetrics.evaluate_pair(deg, ref, SR, estoi=estoi)
        _same_row(got, want)
    assert all(math.isnan(got[k]) for k in ("stoi", "pesq_nb", "pesq_wb"))


def test_strict_raises_without_the_external_packages(pairs, monkeypatch):
    """``strict`` requires pesq and pystoi (absent here; hidden if installed)."""
    ref, deg = pairs["snr10"]
    for mod in ("pesq", "pystoi"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(RuntimeError, match="pystoi"):
        metrics.evaluate_pair(deg, ref, SR, strict=True, device="cpu")
    with pytest.raises(RuntimeError, match="'pesq'"):
        metrics.pesq_score(deg, ref, SR, strict=True)


def test_mel_distance_needs_a_card_unless_cpu_is_asked_for(pairs):
    ref, deg = pairs["snr10"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.mel_distance(deg, ref, SR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.evaluate_pair(deg, ref, SR)
