"""Objective reconstruction metrics.

The port of ``academicodec_tpu/eval/metrics.py``: SI-SNR, the multi-scale
mel distance, STOI/ESTOI (``eval/stoi.py``, pystoi-equivalent numerics, the
reference's compute_stoi.py:12-27 tooling) and PESQ nb+wb (``eval/pesq.py``,
ITU-T P.862/P.862.2, reference compute_pesq.py:11-32, the same resampling to
16 kHz). SI-SNR, STOI and PESQ run on the host in numpy, as in the JAX
package; the mel distance runs on a torch device, the card unless
``device="cpu"`` is asked for. When the external ``pesq`` package is
installed its scores are reported beside (``*_ext`` keys); ``strict`` makes
that cross-check, and pystoi's, mandatory.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import numpy as np
import torch

from academicodec_tpu_torch.models.soundstream import resolve_device
from academicodec_tpu_torch.ops.stft import mel_spectrogram_torchaudio


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SNR in dB over 1-D signals (higher is better)."""
    eps = 1e-8
    n = min(est.shape[-1], ref.shape[-1])
    est, ref = est[..., :n], ref[..., :n]
    est = est - est.mean(axis=-1, keepdims=True)
    ref = ref - ref.mean(axis=-1, keepdims=True)
    proj = (np.sum(est * ref, axis=-1, keepdims=True) * ref) / (
        np.sum(ref**2, axis=-1, keepdims=True) + eps
    )
    noise = est - proj
    ratio = (np.sum(proj**2, axis=-1) + eps) / (np.sum(noise**2, axis=-1) + eps)
    return float(np.mean(10.0 * np.log10(ratio)))


def mel_distance(
    est: np.ndarray, ref: np.ndarray, sr: int, device: Union[str, torch.device] = "cuda",
) -> float:
    """Mean L1 distance between 64-band log-mels at scales 2^6..2^11 (the
    shape of the training reconstruction loss, usable as a cheap eval
    proxy), in f32 on ``device``; a CUDA device without a card raises."""
    device = resolve_device(device)
    n = min(est.shape[-1], ref.shape[-1])
    e = torch.as_tensor(np.asarray(est[..., :n], np.float32).reshape(1, -1)).to(device)
    r = torch.as_tensor(np.asarray(ref[..., :n], np.float32).reshape(1, -1)).to(device)
    total = 0.0
    scales = [2**i for i in range(6, 12)]
    for s in scales:
        me = mel_spectrogram_torchaudio(e, sr, max(s, 512), s // 4, s, n_mels=64)
        mr = mel_spectrogram_torchaudio(r, sr, max(s, 512), s // 4, s, n_mels=64)
        total += float(torch.mean(torch.abs(torch.log(me + 1e-7) - torch.log(mr + 1e-7))))
    return total / len(scales)


def pesq_score(
    deg: np.ndarray, ref: np.ndarray, sr: int, strict: bool = False
) -> Dict[str, float]:
    """Narrow+wide-band PESQ at 16 kHz (resampled), the reference's convention
    (compute_pesq.py:11-32), from the native P.862 implementation
    (``eval/pesq.py``); the external ``pesq`` package's scores ride along
    under ``*_ext`` when it is installed. ``strict=True`` makes that
    cross-check mandatory: a missing package or a failing cross-check raises
    instead of reporting native-only scores (``cli/evaluate.py --strict``)."""
    from scipy.signal import resample_poly

    from academicodec_tpu_torch.eval.pesq import pesq as native_pesq

    if sr != 16000:
        g = math.gcd(16000, sr)
        deg = resample_poly(deg, 16000 // g, sr // g)
        ref = resample_poly(ref, 16000 // g, sr // g)
    n = min(len(deg), len(ref))
    out = {
        "pesq_nb": float(native_pesq(16000, ref[:n], deg[:n], "nb")),
        "pesq_wb": float(native_pesq(16000, ref[:n], deg[:n], "wb")),
    }
    try:  # pragma: no cover - not installed here
        from pesq import pesq as ext_pesq
    except ImportError:
        if strict:
            raise RuntimeError(
                "strict cross-check requested but the external 'pesq' "
                "package (ITU P.862 wrapper) is not installed — native "
                "scores cannot be validated in this environment"
            )
        return out
    try:  # pragma: no cover - not installed here
        out["pesq_nb_ext"] = float(ext_pesq(16000, ref[:n], deg[:n], "nb"))
        out["pesq_wb_ext"] = float(ext_pesq(16000, ref[:n], deg[:n], "wb"))
    except Exception:
        # the package's own runtime errors (not ValueError) must not abort an
        # evaluation whose native scores succeeded, unless strict
        if strict:
            raise
        out["pesq_nb_ext"] = float("nan")
        out["pesq_wb_ext"] = float("nan")
    return out


def stoi_score(deg: np.ndarray, ref: np.ndarray, sr: int) -> float:
    """STOI from the native implementation (``eval/stoi.py``); pystoi is
    used only as the ``strict`` cross-check."""
    from academicodec_tpu_torch.eval.stoi import stoi

    n = min(len(deg), len(ref))
    return float(stoi(ref[:n], deg[:n], sr))


def evaluate_pair(
    deg: np.ndarray, ref: np.ndarray, sr: int, estoi: bool = False,
    strict: bool = False, device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """All metrics for one (degraded, reference) pair, with the JAX package's
    keys: SI-SNR, the mel distance, STOI (and ESTOI) and PESQ nb/wb.
    ``strict=True`` requires the external cross-checks to run for both PESQ
    (:func:`pesq_score`) and STOI (pystoi, under ``stoi_ext``/``estoi_ext``)
    and refuses to record a failure as NaN. ``device`` is the mel
    distance's."""
    out = {"si_snr": si_snr(deg, ref), "mel_l1": mel_distance(deg, ref, sr, device=device)}
    if strict:
        try:  # pragma: no cover - not installed here
            from pystoi import stoi as ext_stoi
        except ImportError:
            raise RuntimeError(
                "strict cross-check requested but the external 'pystoi' "
                "package is not installed — native STOI cannot be "
                "validated in this environment"
            )
    n = min(len(deg), len(ref))
    try:
        if estoi:
            # one shared front-end pass for both measures
            from academicodec_tpu_torch.eval.stoi import stoi_and_estoi

            out["stoi"], out["estoi"] = stoi_and_estoi(ref[:n], deg[:n], sr)
        else:
            out["stoi"] = stoi_score(deg, ref, sr)
        if strict:  # pragma: no cover - pystoi not installed here
            out["stoi_ext"] = float(ext_stoi(ref[:n], deg[:n], sr))
            if estoi:
                out["estoi_ext"] = float(ext_stoi(ref[:n], deg[:n], sr, extended=True))
    except ValueError:
        # too short or all silent for the 384 ms STOI segments: recorded as
        # NaN so that aggregate reports disclose the excluded rows, unless
        # strict, where a silent skip defeats the cross-check
        if strict:
            raise
        out["stoi"] = float("nan")
        if estoi:
            out["estoi"] = float("nan")
    try:
        out.update(pesq_score(deg, ref, sr, strict=strict))
    except ValueError:
        if strict:
            raise
        out["pesq_nb"] = float("nan")  # too short for PESQ: disclosed
        out["pesq_wb"] = float("nan")
    return out
