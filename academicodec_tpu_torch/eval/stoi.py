"""Native STOI / ESTOI (no external deps beyond numpy/scipy).

The port's copy of ``academicodec_tpu/eval/stoi.py``: the same arithmetic
in the same order, so it gives the JAX package's floats exactly.

Faithful implementation of the short-time objective intelligibility
measure (Taal, Hendriks, Heusdens, Jensen, ICASSP 2011) and its extended
variant (Jensen & Taal, 2016), numerically matching the ``pystoi``
package the reference's evaluation script shells out to
(evaluation_metric/calculate_voc_obj_metrics/metrics/compute_stoi.py:12-27):
same 10 kHz operating rate, octave-compatible polyphase resampler, 256/128
Hann analysis, 512-pt rFFT, 15 third-octave bands from 150 Hz, 40 dB
silent-frame dynamic range, N=30-frame segments, beta=-15 dB clipping.

Host-side numpy by design: evaluation is offline, sequential over files,
and the FFTs are tiny (moving it to the card would change its numbers).
"""

from __future__ import annotations

import numpy as np

FS = 10000  # operating sample rate (Hz)
N_FRAME = 256  # analysis window length
NFFT = 512  # FFT size
NUMBAND = 15  # number of third-octave bands
MINFREQ = 150  # lowest band center frequency (Hz)
N_SEG = 30  # frames per intermediate-intelligibility segment (384 ms)
BETA = -15.0  # lower SDR clipping bound (dB)
DYN_RANGE = 40.0  # silent-frame dynamic range (dB)
_EPS = np.finfo(np.float64).eps


def _resample_window_oct(p: int, q: int) -> np.ndarray:
    """Octave-style anti-aliasing Kaiser window for resample_poly."""
    g = np.gcd(p, q)
    p, q = p // g, q // g
    log10_rejection = -3.0
    stopband_cutoff_f = 1.0 / (2 * max(p, q))
    roll_off_width = stopband_cutoff_f / 10.0
    rejection_db = -20.0 * log10_rejection
    l = int(np.ceil(rejection_db / (22.9 * roll_off_width)))
    t = np.arange(-l, l + 1)
    ideal = 2 * p * stopband_cutoff_f * np.sinc(2 * stopband_cutoff_f * t)
    if rejection_db >= 96.0:
        beta = 0.1102 * (rejection_db - 8.7)
    elif rejection_db > 21.0:
        beta = 0.5842 * (rejection_db - 21.0) ** 0.4 + 0.07886 * (rejection_db - 21.0)
    else:
        beta = 0.0
    return ideal * np.kaiser(2 * l + 1, beta)


def resample_oct(x: np.ndarray, p: int, q: int) -> np.ndarray:
    """Octave-compatible polyphase resampling (matches pystoi.utils)."""
    from scipy.signal import resample_poly

    h = _resample_window_oct(p, q)
    return resample_poly(x, p, q, window=h / np.sum(h))


def thirdoct(fs: int = FS, nfft: int = NFFT, num_bands: int = NUMBAND,
             min_freq: float = MINFREQ) -> tuple[np.ndarray, np.ndarray]:
    """Third-octave band matrix ``[num_bands, nfft//2+1]`` and center freqs."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1.0
    return obm, cf


def _frames(x: np.ndarray, framelen: int, hop: int, last_exclusive: bool) -> np.ndarray:
    # pystoi quirk: remove_silent_frames iterates to len(x)-framelen+1,
    # the STFT iterates to len(x)-framelen (exclusive).
    stop = len(x) - framelen + (0 if last_exclusive else 1)
    idx = np.arange(0, max(stop, 0), hop)
    return x[idx[:, None] + np.arange(framelen)[None, :]]


def _hann_interior(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1]


def remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_range: float = DYN_RANGE,
                         framelen: int = N_FRAME, hop: int = N_FRAME // 2
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Drop frames more than ``dyn_range`` dB below the loudest clean frame,
    then overlap-add the survivors back into waveforms."""
    w = _hann_interior(framelen)
    xf = _frames(x, framelen, hop, last_exclusive=False) * w
    yf = _frames(y, framelen, hop, last_exclusive=False) * w
    energies = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = (np.max(energies) - dyn_range - energies) < 0
    xf, yf = xf[mask], yf[mask]

    def ola(frames: np.ndarray) -> np.ndarray:
        n = (frames.shape[0] - 1) * hop + framelen if frames.shape[0] else 0
        out = np.zeros(n)
        for i, fr in enumerate(frames):
            out[i * hop : i * hop + framelen] += fr
        return out

    return ola(xf), ola(yf)


def _stft(x: np.ndarray, win: int = N_FRAME, nfft: int = NFFT, hop: int = N_FRAME // 2
          ) -> np.ndarray:
    fr = _frames(x, win, hop, last_exclusive=True) * _hann_interior(win)
    return np.fft.rfft(fr, n=nfft, axis=1)


def _row_col_normalize(seg: np.ndarray) -> np.ndarray:
    """ESTOI normalization: zero-mean/unit-norm rows then columns.

    ``seg`` is ``[n_segments, bands, N_SEG]``; rows run over time (axis 2),
    columns over bands (axis 1).
    """
    s = seg - np.mean(seg, axis=2, keepdims=True)
    s = s / (np.linalg.norm(s, axis=2, keepdims=True) + _EPS)
    s = s - np.mean(s, axis=1, keepdims=True)
    s = s / (np.linalg.norm(s, axis=1, keepdims=True) + _EPS)
    return s


def _segments(ref: np.ndarray, deg: np.ndarray, fs: int):
    """Shared STOI/ESTOI front-end: resample, drop silent frames, STFT,
    third-octave bands, sliding ``[n_segments, bands, N_SEG]`` windows."""
    if ref.shape != deg.shape:
        n = min(ref.shape[-1], deg.shape[-1])
        ref, deg = ref[..., :n], deg[..., :n]
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if fs != FS:
        ref = resample_oct(ref, FS, fs)
        deg = resample_oct(deg, FS, fs)
    ref, deg = remove_silent_frames(ref, deg)
    if len(ref) < N_FRAME:
        raise ValueError("signal too short (all-silent?) for STOI")

    obm, _ = thirdoct()
    x_spec = _stft(ref).T  # [freq, frames]
    y_spec = _stft(deg).T
    x_tob = np.sqrt(obm @ np.square(np.abs(x_spec)))  # [bands, frames]
    y_tob = np.sqrt(obm @ np.square(np.abs(y_spec)))
    if x_tob.shape[1] < N_SEG:
        raise ValueError("fewer than 30 analysis frames after silence removal")

    x_seg = np.stack([x_tob[:, m - N_SEG : m] for m in range(N_SEG, x_tob.shape[1] + 1)])
    y_seg = np.stack([y_tob[:, m - N_SEG : m] for m in range(N_SEG, y_tob.shape[1] + 1)])
    return x_seg, y_seg


def _estoi_from_segments(x_seg: np.ndarray, y_seg: np.ndarray) -> float:
    x_n = _row_col_normalize(x_seg)
    y_n = _row_col_normalize(y_seg)
    return float(np.sum(x_n * y_n / N_SEG) / x_n.shape[0])


def _stoi_from_segments(x_seg: np.ndarray, y_seg: np.ndarray) -> float:
    norm = np.linalg.norm(x_seg, axis=2, keepdims=True) / (
        np.linalg.norm(y_seg, axis=2, keepdims=True) + _EPS
    )
    y_prime = np.minimum(y_seg * norm, x_seg * (1 + 10.0 ** (-BETA / 20.0)))
    y_prime = y_prime - np.mean(y_prime, axis=2, keepdims=True)
    x_c = x_seg - np.mean(x_seg, axis=2, keepdims=True)
    y_prime = y_prime / (np.linalg.norm(y_prime, axis=2, keepdims=True) + _EPS)
    x_c = x_c / (np.linalg.norm(x_c, axis=2, keepdims=True) + _EPS)
    j, m = x_c.shape[0], x_c.shape[1]
    return float(np.sum(x_c * y_prime) / (j * m))


def stoi_and_estoi(ref: np.ndarray, deg: np.ndarray, fs: int) -> tuple[float, float]:
    """Both measures from one front-end pass (the expensive half)."""
    x_seg, y_seg = _segments(ref, deg, fs)
    return _stoi_from_segments(x_seg, y_seg), _estoi_from_segments(x_seg, y_seg)


def stoi(ref: np.ndarray, deg: np.ndarray, fs: int, extended: bool = False) -> float:
    """STOI between clean ``ref`` and degraded ``deg`` (same length, 1-D)."""
    x_seg, y_seg = _segments(ref, deg, fs)
    if extended:
        return _estoi_from_segments(x_seg, y_seg)
    return _stoi_from_segments(x_seg, y_seg)
