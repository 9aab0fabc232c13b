"""Native PESQ — ITU-T P.862 (narrowband) / P.862.2 (wideband), numpy.

The port's copy of ``academicodec_tpu/eval/pesq.py``: host numpy and scipy,
the same arithmetic in the same order, so it gives the JAX package's floats
exactly (tests/test_torch_eval.py).

Replaces the reference evaluation's external ``pesq`` package
(evaluation_metric/calculate_voc_obj_metrics/metrics/compute_pesq.py:11-32)
the same way ``eval/stoi.py`` replaced ``pystoi``: a host-side numpy
implementation with no external dependency, so the metric every codec
paper leads with is runnable in-tree.

Pipeline (the P.862 architecture, in order):
  1. level alignment — both signals scaled to a fixed target power in the
     350–3250 Hz band;
  2. input filtering — the IRS receive characteristic (narrowband) or a
     100 Hz high-pass (wideband, P.862.2);
  3. time alignment — envelope cross-correlation for the crude delay,
     utterance detection, then per-utterance fine alignment via a
     confidence-weighted histogram of framewise cross-correlation peaks;
  4. perceptual model — 50 %-overlapped Hann spectra, Bark-warped pitch
     power densities, partial frequency compensation of the reference,
     smoothed short-term gain compensation of the degraded signal, Zwicker
     loudness transform, masked disturbance densities, and the asymmetry
     factor for additive (coding-noise-like) distortions;
  5. aggregation — weighted L2/L1 band norms per frame, L6 over 20-frame
     split-second intervals, L2 over time; raw score
     ``4.5 − 0.1·D − 0.0309·DA`` mapped to MOS-LQO by P.862.1 (nb) or
     P.862.2 (wb).

Fidelity status (be honest with consumers of these numbers):
  * The structure, constants and order of operations follow the published
    ITU-T P.862 algorithm; the perceptual-model calibration constants
    (``SP``/``SL``), the IRS receive response, the disturbance weights and
    the MOS-LQO mappings are the standard's values.
  * The Bark band edges and absolute-threshold table are REGENERATED from
    the published psychoacoustic formulas (Zwicker bark scale, Terhardt
    threshold-in-quiet) rather than copied from the ITU data tables.
    Utterance splitting for time-VARYING delay is implemented
    (``_align_split``: recursive confidence-gated splitting per P.862
    §10.2.4). Scores are therefore expected to track the ITU
    implementation closely but are not bit-exact; `tests/test_pesq.py`
    pins the exact anchors that hold by construction (identical input ⇒
    4.549 nb / 4.644 wb), the behavioral contract (monotonicity in SNR,
    delay invariance, time-varying-delay recovery, plausible MOS for
    standard degradations), and full-precision regression fixtures over a
    deterministic degradation matrix that would expose any future ±0.1 MOS
    drift.  When the external ``pesq`` package is available,
    ``eval/metrics.pesq_score`` cross-checks against it
    (``cli/evaluate.py --strict`` makes that cross-check mandatory).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

_EPS = 1e-12

SEARCHBUFFER = 75  # alignment search range, in downsample (4 ms) units
DATAPADDING_MS = 320  # zero padding appended to both signals (ms)
TARGET_POWER = 1e7  # level-alignment target power (350-3250 Hz band)
ZWICKER_POWER = 0.23

_CFG = {
    8000: dict(downsample=32, nfft=512, align_nfft=512, nb=42,
               sp=2.764344e-5, sl=1.866055e-1),
    16000: dict(downsample=64, nfft=1024, align_nfft=1024, nb=49,
                sp=6.910853e-6, sl=1.866055e-1),
}

# IRS receive characteristic (P.862 narrowband input filter), piecewise
# (Hz, dB); -200 dB ≡ stopband
_IRS_DB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0),
])


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker & Terhardt critical-band rate (bark) of frequency in Hz."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _terhardt_db(f: np.ndarray) -> np.ndarray:
    """Absolute threshold in quiet (dB SPL), Terhardt 1979."""
    khz = np.maximum(np.asarray(f, np.float64), 20.0) / 1000.0
    return (
        3.64 * khz**-0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz**4
    )


class _BandTable:
    """Uniform-in-bark band partition of the FFT bins with per-band centre
    frequency, bark width, and absolute threshold power."""

    def __init__(self, fs: int, nfft: int, nb: int):
        f_bins = np.arange(nfft // 2) * fs / nfft
        z_max = float(_bark(fs / 2.0))
        edges_z = np.linspace(0.0, z_max, nb + 1)
        z_bins = _bark(f_bins)
        self.bin_band = np.clip(
            np.searchsorted(edges_z, z_bins, side="right") - 1, 0, nb - 1
        )
        self.nb = nb
        self.width_bark = np.diff(edges_z)  # uniform, kept per-band for Lp
        centre_z = 0.5 * (edges_z[:-1] + edges_z[1:])
        self.centre_bark = centre_z
        # invert bark -> Hz numerically for centre frequencies
        grid_f = np.linspace(1.0, fs / 2.0, 4096)
        self.centre_hz = np.interp(centre_z, _bark(grid_f), grid_f)
        self.abs_thresh = 10.0 ** (_terhardt_db(self.centre_hz) / 10.0)
        # number of bins per band (for the power-density normalization)
        self.bins_per_band = np.maximum(
            np.bincount(self.bin_band, minlength=nb), 1
        )

    def to_bark(self, hz_power: np.ndarray, sp: float) -> np.ndarray:
        """Hz power spectrum ``[n_bins]`` -> pitch power density ``[nb]``."""
        sums = np.bincount(
            self.bin_band, weights=hz_power, minlength=self.nb
        )
        return sp * sums


_BAND_CACHE: dict = {}


def _bands(fs: int) -> _BandTable:
    if fs not in _BAND_CACHE:
        cfg = _CFG[fs]
        _BAND_CACHE[fs] = _BandTable(fs, cfg["nfft"], cfg["nb"])
    return _BAND_CACHE[fs]


# ---------------------------------------------------------------------------
# stage 1+2: level alignment and input filtering
# ---------------------------------------------------------------------------

def _fft_filter_db(x: np.ndarray, fs: int, pts: np.ndarray) -> np.ndarray:
    """Zero-phase FFT filtering with a piecewise-linear dB response."""
    n = len(x)
    nfft = 1 << (n - 1).bit_length()
    spec = np.fft.rfft(x, nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    gain_db = np.interp(freqs, pts[:, 0], pts[:, 1], left=pts[0, 1],
                        right=pts[-1, 1])
    out = np.fft.irfft(spec * 10.0 ** (gain_db / 20.0), nfft)
    return out[:n]


def _bandpass_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    n = len(x)
    nfft = 1 << (n - 1).bit_length()
    spec = np.abs(np.fft.rfft(x, nfft)) ** 2
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    band = spec[(freqs >= lo) & (freqs <= hi)]
    # Parseval: mean-square of the band-limited signal
    return 2.0 * float(band.sum()) / (nfft * max(n, 1))


def _fix_power_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale so the 350-3250 Hz band has mean power TARGET_POWER."""
    p = _bandpass_power(x, fs, 350.0, 3250.0)
    return x * math.sqrt(TARGET_POWER / (p + _EPS))


def _input_filter(x: np.ndarray, fs: int, mode: str) -> np.ndarray:
    if mode == "nb":
        return _fft_filter_db(x, fs, _IRS_DB)
    # wideband (P.862.2): flat response with a 100 Hz high-pass
    from scipy.signal import butter, sosfiltfilt

    sos = butter(2, 100.0, btype="highpass", fs=fs, output="sos")
    return sosfiltfilt(sos, x)


# ---------------------------------------------------------------------------
# stage 3: time alignment
# ---------------------------------------------------------------------------

def _envelope(x: np.ndarray, block: int) -> np.ndarray:
    n = len(x) // block
    e = np.abs(x[: n * block]).reshape(n, block).sum(axis=1)
    return np.log10(1.0 + e)


def _crude_candidates(
    ref: np.ndarray, deg: np.ndarray, block: int, k: int = 3
) -> List[int]:
    """Top-``k`` well-separated peaks of the envelope cross-correlation
    (lags k of Σ er[i]·ed[i+k], k may be negative), in sample units, best
    first. On near-periodic envelopes (steady syllabic modulation) the
    single argmax can lock onto an envelope-period alias — noise decides
    among near-equal peaks — so ``time_align`` scores each candidate by
    fine-alignment confidence instead of trusting the argmax."""
    er = _envelope(ref, block)
    ed = _envelope(deg, block)
    er = er - er.mean()
    ed = ed - ed.mean()
    n = len(er) + len(ed) - 1
    nfft = 1 << (n - 1).bit_length()
    c = np.fft.irfft(np.fft.rfft(ed, nfft) * np.conj(np.fft.rfft(er, nfft)), nfft)
    cc = np.concatenate([c[-(len(er) - 1):], c[: len(ed)]])
    picks: List[int] = []
    for i in np.argsort(cc)[::-1]:
        lag = int(i) - (len(er) - 1)
        if all(abs(lag - p) > 2 for p in picks):
            picks.append(lag)
        if len(picks) == k:
            break
    return [p * block for p in picks]


def _utterances(ref: np.ndarray, fs: int, block: int) -> List[Tuple[int, int]]:
    """Active-speech sections in sample units: envelope 35 dB under the
    peak marks silence; gaps < 200 ms are bridged, sections < 200 ms are
    dropped (whole file as one utterance if nothing qualifies)."""
    e = _envelope(ref, block)
    if not len(e):
        return [(0, len(ref))]
    db = 20.0 * e  # log10 envelope -> dB-like
    active = db > (db.max() - 35.0)
    min_len = max(1, int(0.2 * fs) // block)
    sections: List[Tuple[int, int]] = []
    start = None
    gap = 0
    for i, a in enumerate(active):
        if a:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap > min_len:
                sections.append((start, i - gap + 1))
                start, gap = None, 0
    if start is not None:
        sections.append((start, len(active)))
    sections = [(s * block, e_ * block) for s, e_ in sections
                if (e_ - s) >= min_len]
    return sections or [(0, len(ref))]


def _fine_align(
    ref: np.ndarray, deg: np.ndarray, start: int, stop: int,
    crude: int, align_nfft: int,
) -> Tuple[int, float]:
    """Per-utterance delay from framewise cross-correlation. Both frames
    are EQUAL-length and Hann-windowed at corresponding positions (ref at
    t, deg at t+crude), so the residual-lag search within ±align_nfft/2 is
    energy-unbiased — correlating one windowed frame against a long
    unwindowed search region would let louder neighbouring speech win.
    The per-frame correlation FUNCTIONS are summed before the argmax: the
    coherent sum is the utterance's global cross-correlation, which
    disambiguates pitch-period aliases that defeat peak-voting on strongly
    periodic material. Returns (delay_samples, confidence)."""
    hop = align_nfft // 4  # 75 % overlap
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(align_nfft) / align_nfft))
    max_res = align_nfft // 2
    nfft2 = 2 * align_nfft
    csum = np.zeros(2 * max_res + 1)
    for fstart in range(start, stop - align_nfft, hop):
        rf = ref[fstart : fstart + align_nfft] * window
        ds = fstart + crude
        if ds < 0 or ds + align_nfft > len(deg):
            continue
        df = deg[ds : ds + align_nfft] * window
        c = np.fft.irfft(
            np.fft.rfft(df, nfft2) * np.conj(np.fft.rfft(rf, nfft2)), nfft2
        )
        # lag l in [-max_res, max_res]: index l -> c[l] (c[nfft2+l] for l<0)
        csum += np.concatenate([c[-max_res:], c[: max_res + 1]])
    if csum.max() <= 0.0:
        return crude, 0.0
    # de-bias the Hann taper: a residual lag l only overlaps
    # Σ_n w[n]·w[n+l] of the window mass, which would otherwise pull the
    # argmax toward small |l| (pitch-period aliases win on periodic input)
    wc = np.fft.irfft(np.abs(np.fft.rfft(window, nfft2)) ** 2, nfft2)
    ww = np.concatenate([wc[-max_res:], wc[: max_res + 1]])
    csum = csum / np.maximum(ww, 0.2 * ww.max())
    best = int(np.argmax(csum))
    conf = float(csum[best] / (np.abs(csum).mean() + _EPS))
    return crude + best - max_res, conf


def _align_split(
    ref: np.ndarray, deg: np.ndarray, s: int, e: int,
    crude: int, align_nfft: int, fs: int, depth: int = 0,
    whole: Tuple[int, float] | None = None,
) -> List[Tuple[int, int, int]]:
    """P.862 utterance splitting for time-VARYING delay (ITU P.862 §10.2.4,
    'utterance splitting'; reference delegates to the pesq package which
    implements it — compute_pesq.py:11-32): when a delay CHANGE inside an
    utterance is better explained by two independently-aligned halves —
    both halves' correlation peaks are sharper than the whole's — the
    utterance recursively splits at the best candidate point. A genuine
    change is required (≥ one downsample block apart); sample-level jitter
    between half-estimates never splits, so constant-delay material keeps
    its single-utterance alignment bit-for-bit. ``whole`` optionally passes
    a precomputed ``_fine_align(ref, deg, s, e, crude, ...)`` result so the
    candidate-ranking pass in ``time_align`` is not repeated here."""
    d, conf = whole if whole is not None else _fine_align(
        ref, deg, s, e, crude, align_nfft
    )
    if conf <= 1.5:  # flat histogram: keep the crude estimate
        d = crude
    min_half = max(2 * align_nfft, int(0.32 * fs))
    if depth >= 2 or (e - s) < 2 * min_half:
        return [(s, e, d)]
    best = None
    for frac in (0.35, 0.5, 0.65):
        m = s + int((e - s) * frac)
        d1, c1 = _fine_align(ref, deg, s, m, crude, align_nfft)
        d2, c2 = _fine_align(ref, deg, m, e, crude, align_nfft)
        if abs(d1 - d2) <= _CFG[fs]["downsample"]:
            continue  # not a real delay change
        score = min(c1, c2)
        if score > max(conf, 1.5) and (best is None or score > best[0]):
            best = (score, m)
    if best is None:
        return [(s, e, d)]
    m = best[1]
    return (
        _align_split(ref, deg, s, m, crude, align_nfft, fs, depth + 1)
        + _align_split(ref, deg, m, e, crude, align_nfft, fs, depth + 1)
    )


def time_align(
    ref: np.ndarray, deg: np.ndarray, fs: int
) -> List[Tuple[int, int, int]]:
    """``[(utt_start, utt_stop, delay_samples), ...]`` over ``ref``."""
    cfg = _CFG[fs]
    block = cfg["downsample"]
    search = SEARCHBUFFER * block
    utts = _utterances(ref, fs, block)
    # candidate crude delays, disambiguated by fine-alignment confidence
    # (the raw envelope-xcorr argmax aliases on periodic envelopes)
    cands = list(dict.fromkeys(
        int(np.clip(c, -search, search))
        for c in _crude_candidates(ref, deg, block)
    ))
    # rank candidates by summed fine-alignment confidence, caching each
    # per-utterance result — _align_split's top level reuses the winner's
    # instead of recomputing the dominant-cost framewise FFT pass
    fine: dict = {}

    def _total_conf(cr: int) -> float:
        return sum(
            fine.setdefault(
                (cr, s, e), _fine_align(ref, deg, s, e, cr, cfg["align_nfft"])
            )[1]
            for (s, e) in utts
        )

    crude = max(cands, key=_total_conf) if len(cands) > 1 else cands[0]
    out = []
    for (s, e) in utts:
        # (the residual-lag search inside is bounded by align_nfft/2; the
        # ±search clamp is applied to the result below)
        for (us, ue, d) in _align_split(ref, deg, s, e, crude,
                                        cfg["align_nfft"], fs,
                                        whole=fine.get((crude, s, e))):
            out.append((us, ue, int(np.clip(d, -search, search))))
    return out


# ---------------------------------------------------------------------------
# stage 4: perceptual model
# ---------------------------------------------------------------------------

def _pseudo_lp(d: np.ndarray, w: np.ndarray, p: float) -> float:
    """ITU pseudo-Lp band norm: weighted p-mean times total weight."""
    total_w = float(w.sum())
    r = float(np.sum((np.abs(d) * w) ** p))
    return (r / total_w) ** (1.0 / p) * total_w


def _loudness(dens: np.ndarray, bands: _BandTable, sl: float) -> np.ndarray:
    """Zwicker loudness density; low-band exponent correction as in P.862."""
    t = bands.abs_thresh
    z = bands.centre_bark
    h = np.where(z < 4.0, (6.0 / (z + 2.0)) ** 0.15, 1.0)
    mzp = ZWICKER_POWER * h
    loud = sl * (t / 0.5) ** mzp * ((0.5 + 0.5 * dens / t) ** mzp - 1.0)
    return np.where(dens > t, loud, 0.0)


def _perceptual_model(
    ref: np.ndarray, deg: np.ndarray, fs: int,
    delays: List[Tuple[int, int, int]],
) -> Tuple[float, float]:
    cfg = _CFG[fs]
    nfft, hop = cfg["nfft"], cfg["nfft"] // 2
    bands = _bands(fs)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))

    pad = SEARCHBUFFER * cfg["downsample"] + int(DATAPADDING_MS * fs / 1000)
    refp = np.concatenate([ref, np.zeros(pad)])
    degp = np.concatenate([deg, np.zeros(pad)])

    n_frames = max((len(ref) + int(DATAPADDING_MS * fs / 1000)) // hop - 1, 1)

    def delay_at(pos: int) -> int:
        for (s, e, d) in delays:
            if s <= pos < e:
                return d
        return delays[-1][2] if pos >= delays[-1][1] else delays[0][2]

    ref_bark = np.zeros((n_frames, bands.nb))
    deg_bark = np.zeros((n_frames, bands.nb))
    for fr in range(n_frames):
        sr_ = fr * hop
        sd_ = sr_ + delay_at(sr_ + hop)
        sd_ = max(sd_, 0)
        rseg = refp[sr_ : sr_ + nfft]
        dseg = degp[sd_ : sd_ + nfft]
        if len(rseg) < nfft:
            rseg = np.pad(rseg, (0, nfft - len(rseg)))
        if len(dseg) < nfft:
            dseg = np.pad(dseg, (0, nfft - len(dseg)))
        rsp = np.abs(np.fft.rfft(rseg * window))[: nfft // 2] ** 2
        dsp = np.abs(np.fft.rfft(dseg * window))[: nfft // 2] ** 2
        ref_bark[fr] = bands.to_bark(rsp, cfg["sp"])
        deg_bark[fr] = bands.to_bark(dsp, cfg["sp"])

    def total_audible(dens: np.ndarray, factor: float = 1.0) -> np.ndarray:
        audible = np.where(dens > factor * bands.abs_thresh, dens, 0.0)
        return audible.sum(axis=-1)

    speech_active = total_audible(ref_bark) >= 1e7

    # partial frequency compensation: pull the REFERENCE toward the degraded
    # long-term spectrum so linear filtering is only partly penalized
    act = ref_bark[speech_active] if speech_active.any() else ref_bark
    actd = deg_bark[speech_active] if speech_active.any() else deg_bark
    ratio = np.clip(
        (actd.mean(axis=0) + 1000.0) / (act.mean(axis=0) + 1000.0),
        0.01, 100.0,
    )
    ref_comp = ref_bark * ratio

    # smoothed short-term gain compensation of the degraded signal
    deg_comp = np.empty_like(deg_bark)
    h_prev = 1.0
    for fr in range(n_frames):
        gain = (total_audible(ref_comp[fr]) + 5e3) / (
            total_audible(deg_bark[fr]) + 5e3
        )
        h_prev = gain if fr == 0 else 0.8 * h_prev + 0.2 * gain
        deg_comp[fr] = deg_bark[fr] * float(np.clip(h_prev, 3e-4, 5.0))

    d_frames = np.zeros(n_frames)
    da_frames = np.zeros(n_frames)
    w = bands.width_bark
    for fr in range(n_frames):
        lr = _loudness(ref_comp[fr], bands, cfg["sl"])
        ld = _loudness(deg_comp[fr], bands, cfg["sl"])
        d = ld - lr
        m = 0.25 * np.minimum(ld, lr)
        d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)
        # asymmetry factor: additive spectral components (coding noise)
        # count more than components the codec removed
        asym = ((deg_comp[fr] + 50.0) / (ref_comp[fr] + 50.0)) ** 1.2
        asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
        weight = ((total_audible(ref_comp[fr]) + 1e5) / 1e7) ** 0.04
        d_frames[fr] = min(_pseudo_lp(d, w, 2.0) / weight, 45.0)
        da_frames[fr] = min(_pseudo_lp(d * asym, w, 1.0) / weight, 45.0)

    def lpq(x: np.ndarray, p_syl: float = 6.0, p_time: float = 2.0,
            syl: int = 20) -> float:
        if not len(x):
            return 0.0
        vals = []
        for s in range(0, len(x), syl // 2):
            chunk = x[s : s + syl]
            if len(chunk):
                vals.append(np.mean(chunk**p_syl) ** (1.0 / p_syl))
        return float(np.mean(np.asarray(vals) ** p_time) ** (1.0 / p_time))

    return lpq(d_frames), lpq(da_frames)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def pesq_raw(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "nb") -> float:
    """Raw P.862 score ``4.5 − 0.1·D − 0.0309·DA`` (before MOS-LQO mapping)."""
    if fs not in _CFG:
        raise ValueError(f"fs must be 8000 or 16000, got {fs}")
    if mode not in ("nb", "wb"):
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    if mode == "wb" and fs != 16000:
        raise ValueError("wideband PESQ requires fs=16000")
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if n < fs // 4:
        raise ValueError("signals too short for PESQ (need >= 0.25 s)")

    ref = _fix_power_level(ref, fs)
    deg = _fix_power_level(deg, fs)
    ref = _input_filter(ref, fs, mode)
    deg = _input_filter(deg, fs, mode)
    delays = time_align(ref, deg, fs)
    d_symm, d_asymm = _perceptual_model(ref, deg, fs, delays)
    return 4.5 - 0.1 * d_symm - 0.0309 * d_asymm


def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "nb") -> float:
    """MOS-LQO via the P.862.1 (nb) / P.862.2 (wb) mapping — the value the
    external ``pesq`` package returns. Signature-compatible with it."""
    raw = pesq_raw(fs, ref, deg, mode)
    if mode == "wb":
        return 0.999 + 4.0 / (1.0 + math.exp(-1.3669 * raw + 3.8224))
    return 0.999 + 4.0 / (1.0 + math.exp(-1.4945 * raw + 4.6607))
