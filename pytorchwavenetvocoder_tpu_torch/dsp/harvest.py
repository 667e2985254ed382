"""Harvest F0 estimation (Morise 2017, Interspeech: "Harvest: A
high-performance fundamental frequency estimator from speech signals").

This is the F0 analysis the reference reaches through WORLD-via-sprocket
(`feature_extract.py:154-160,179`).  The implementation follows the
published algorithm structure:

1. **Candidate generation** — the signal (decimated to 8 kHz) is passed
   through a bank of Nuttall-windowed band-pass filters whose center
   frequencies are log-spaced over [f0_floor, f0_ceil].  For each
   filtered signal, four event trains are detected: negative-going zero
   crossings, positive-going zero crossings, peaks, and dips.  Each
   train yields interval-based frequency estimates; where the four
   agree, their mean becomes an F0 candidate whose score is the
   relative deviation of the four estimates.
2. **Refinement** — each candidate is re-estimated from the
   instantaneous frequencies of its first harmonics (spectral
   reassignment with a Blackman window of ±1.5 periods,
   amplitude-weighted harmonic average), with a new reliability score
   from the harmonic consistency.
3. **Contour fixing** — per 1-ms frame the best refined candidate is
   selected; unreliable frames are dropped, voiced segments shorter
   than 9 ms removed, segments extended through the candidate pool
   under a 18 % per-ms continuity bound, and the voiced contour is
   smoothed with a zero-phase low-pass before resampling to the
   requested frame shift.

All stages are vectorized over frames/events (the original is per-frame
C++); the constants are the published ones where the paper fixes them
(9 ms minimum voicing run, 0.18 continuity bound, 1-ms internal frame
period, four event types, Nuttall-windowed filters) and documented here
where the paper leaves them to the implementation (channel density,
reliability thresholds).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

_TARGET_FS = 8000.0       # analysis rate: candidates need <= 4 harmonics
_BASIC_PERIOD_MS = 1.0    # internal candidate frame period (paper Sec.2)
_CHANNELS_PER_OCTAVE = 24.0
_MIN_VOICED_MS = 9.0      # minimum voiced run (paper: short segments removed)
_ALLOWED_STEP = 0.18      # max relative F0 change per ms when extending
_MAX_CANDIDATES = 6


def _decimate(x: np.ndarray, fs: int):
    """Resample to the 8 kHz analysis rate (polyphase, zero-phase)."""
    if fs <= _TARGET_FS:
        return np.asarray(x, np.float64), float(fs)
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(int(_TARGET_FS), int(fs)).limit_denominator(1000)
    y = resample_poly(np.asarray(x, np.float64), frac.numerator,
                      frac.denominator)
    return y, fs * frac.numerator / frac.denominator


def _nuttall(n: int) -> np.ndarray:
    """Nuttall window (the filter prototype Harvest specifies)."""
    t = np.linspace(0.0, 1.0, n)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def _smooth_fft_size(need: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) FFT size >= ``need``.

    pocketfft runs mixed radix-2/3/5 natively, so these sizes cost
    ~proportionally to their length — a 5-smooth pad wastes at most 20%
    where the next power of two can waste 2x.  The ladder is also much
    coarser than "any length", so the per-band transfer-function cache
    below hits across utterances of different durations.
    """
    best = 1 << max(int(need - 1).bit_length(), 0)
    f5 = 1
    while f5 < 2 * need:
        f35 = f5
        while f35 < 2 * need:
            s = f35
            while s < need:
                s *= 2
            if s < best:
                best = s
            f35 *= 3
        f5 *= 5
    return best


# (n_fft, fs, boundary bytes) -> (n_bands, n_fft//2+1) filter spectra.
# Reuse is granular: the 5-smooth FFT ladder steps every ~2-4%, so the
# cache only hits when utterance durations cluster within one step (or
# repeat, as in re-analysis passes) — a mixed-duration corpus rebuilds
# the bank per distinct size, which costs about as much as the batched
# irfft it feeds.  The small LRU bounds resident memory, not rebuilds.
_H_CACHE: OrderedDict = OrderedDict()
_H_CACHE_MAX = 3


def _band_pass_bank(x: np.ndarray, fs: float,
                    boundary_f0s: np.ndarray) -> np.ndarray:
    """Filter the signal with each channel's Nuttall band-pass.

    The channel filter is a Nuttall window of length 4 periods of the
    boundary frequency, modulated to that frequency (a band-pass whose
    bandwidth scales with its center), applied by FFT convolution with
    group delay compensated.  The filter spectra are cached across
    calls and the per-band inverse transforms run as one batched FFT.
    """
    n = len(x)
    halves = np.round(fs / boundary_f0s * 2.0).astype(int)
    max_half = int(halves.max())
    n_fft = _smooth_fft_size(n + 4 * max_half + 2)
    key = (n_fft, float(fs), boundary_f0s.tobytes())
    H = _H_CACHE.get(key)
    if H is None:
        # single precision: the filtered signals are consumed only
        # through zero-crossing/peak event *times* (linearly
        # interpolated), where f32 FFT noise (~1e-6 relative) is 5
        # orders below the candidate-agreement thresholds — and the
        # refinement stage re-estimates from the full-precision signal
        H = np.empty((len(boundary_f0s), n_fft // 2 + 1), np.complex64)
        for i, bf in enumerate(boundary_f0s):
            half = int(halves[i])
            m = np.arange(-half, half + 1)
            w = _nuttall(2 * half + 1) * np.cos(2 * np.pi * bf * m / fs)
            H[i] = np.fft.rfft(w, n=n_fft)
        _H_CACHE[key] = H
        if len(_H_CACHE) > _H_CACHE_MAX:
            _H_CACHE.popitem(last=False)
    else:
        _H_CACHE.move_to_end(key)
    X = np.fft.rfft(x, n=n_fft).astype(np.complex64)
    Y = np.fft.irfft(X[None, :] * H, n=n_fft, axis=1)
    # compensate each filter's group delay; hand the event stage f64
    # rows (f32 values) so downstream numpy ops don't promote-convert
    # on every call
    out = np.empty((len(boundary_f0s), n), np.float64)
    for i in range(len(boundary_f0s)):
        out[i] = Y[i, halves[i]:halves[i] + n]
    return out


def _batch_events(S: np.ndarray, fs: float) -> list:
    """Per-row event trains of a (bands, n) signal matrix.

    Each row's events are its negative-going zero crossings with
    linearly interpolated positions; frequency = 1/interval between
    successive events, located at the interval midpoint.  Returns a
    list of (locations_sec, interval_frequencies) or None per row.
    The crossing detection and gathers run batched over all rows (one
    pass instead of one per band); only the tiny per-event arrays are
    handled row by row.
    """
    mask = (S[:, :-1] > 0) & (S[:, 1:] <= 0)
    rows, cols = np.nonzero(mask)          # row-major sorted
    s0 = S[rows, cols]
    s1 = S[rows, cols + 1]
    times = (cols + s0 / (s0 - s1)) / fs
    bounds = np.searchsorted(rows, np.arange(S.shape[0] + 1))
    out = []
    for b in range(S.shape[0]):
        t = times[bounds[b]:bounds[b + 1]]
        if len(t) < 3:
            out.append(None)
            continue
        intervals = np.diff(t)
        good = intervals > 0
        if good.sum() < 2:
            out.append(None)
            continue
        out.append((((t[:-1] + t[1:]) / 2.0)[good], 1.0 / intervals[good]))
    return out


def _tracks_from_trains(trains: list, t_axis: np.ndarray):
    """Interpolate one band's four event trains onto ``t_axis``.

    Returns (4, T) frequencies and a (T,) validity mask (all four trains
    must cover the time), or None when any train is too sparse.
    """
    if any(tr is None for tr in trains):
        return None, None
    tracks = np.empty((4, len(t_axis)))
    valid = np.ones(len(t_axis), bool)
    for i, (locs, freq) in enumerate(trains):
        tracks[i] = np.interp(t_axis, locs, freq)
        valid &= (t_axis >= locs[0]) & (t_axis <= locs[-1])
    return tracks, valid


def _four_event_tracks_all(filtered: np.ndarray, fs: float):
    """Per-band four event trains of the whole (bands, n) filter bank.

    One batched `_batch_events` pass per event type (negative-going zero
    crossings, positive-going zero crossings, peaks, dips) instead of
    one per (band, type).  Returns trains[b] = the band's 4 trains.
    """
    dy = np.diff(filtered, axis=1)
    # one standalone call per operand: each negated bank copy is freed
    # as soon as its call returns (a (filtered, -filtered, dy, -dy)
    # tuple would hold four bank-sized arrays alive at once)
    per_type = [_batch_events(filtered, fs),
                _batch_events(-filtered, fs),
                _batch_events(dy, fs),
                _batch_events(-dy, fs)]
    return list(zip(*per_type))


def _raw_candidates(x8: np.ndarray, fs8: float, t_axis: np.ndarray,
                    f0_floor: float, f0_ceil: float):
    """Per-frame candidate pool (T, K) f0 + (T, K) relative deviation.

    Channels whose four event tracks agree contribute their mean as a
    candidate; agreement is measured as the standard deviation of the
    four estimates relative to the mean (lower = better).  Candidates
    outside [f0_floor, f0_ceil] or far from the channel's band are
    discarded.  The best ``_MAX_CANDIDATES`` per frame are kept.
    """
    n_ch = int(np.ceil(
        np.log2(f0_ceil / f0_floor) * _CHANNELS_PER_OCTAVE)) + 1
    boundary = f0_floor * 2.0 ** (np.arange(n_ch) / _CHANNELS_PER_OCTAVE)
    filtered = _band_pass_bank(x8, fs8, boundary)

    T = len(t_axis)
    cand_f0 = np.zeros((T, _MAX_CANDIDATES))
    cand_dev = np.full((T, _MAX_CANDIDATES), np.inf)
    worst = cand_dev[:, -1].copy()
    all_trains = _four_event_tracks_all(filtered, fs8)
    for bf, trains in zip(boundary, all_trains):
        tracks, valid = _tracks_from_trains(list(trains), t_axis)
        if tracks is None:
            continue
        mean = tracks.mean(axis=0)
        dev = np.sqrt(((tracks - mean) ** 2).sum(axis=0) / 3.0)
        rel = np.where(mean > 0, dev / np.maximum(mean, 1e-9), np.inf)
        ok = (valid & (mean >= f0_floor) & (mean <= f0_ceil)
              & (mean >= bf / 1.6) & (mean <= bf * 1.6) & (rel < 0.35))
        better = ok & (rel < worst)
        if not better.any():
            continue
        rows = np.where(better)[0]
        # replace each row's worst candidate, keep pool sorted by dev
        slot = np.argmax(cand_dev[rows], axis=1)
        cand_f0[rows, slot] = mean[rows]
        cand_dev[rows, slot] = rel[rows]
        worst = cand_dev.max(axis=1)
    order = np.argsort(cand_dev, axis=1)
    rows = np.arange(T)[:, None]
    cand_f0 = cand_f0[rows, order]
    cand_dev = cand_dev[rows, order]
    # dedupe within each frame: adjacent channels vote for the same f0
    # (the band gate spans ~1.6x vs 1/24-octave channel spacing); keep
    # only the best-scored representative of each 3% cluster so the
    # refinement stage doesn't re-window near-identical candidates
    for j in range(1, cand_f0.shape[1]):
        dup = np.zeros(T, bool)
        for i in range(j):
            with np.errstate(invalid="ignore"):
                dup |= (cand_f0[:, i] > 0) & (
                    np.abs(cand_f0[:, j] - cand_f0[:, i])
                    < 0.03 * cand_f0[:, i])
        cand_f0[dup, j] = 0.0
        cand_dev[dup, j] = np.inf
    order = np.argsort(cand_dev, axis=1)
    return cand_f0[rows, order], cand_dev[rows, order]


def _refine_candidates(x8: np.ndarray, fs8: float, t_axis: np.ndarray,
                       cand_f0: np.ndarray):
    """Instantaneous-frequency refinement of every candidate.

    For candidate f0 at time t: Blackman window of half-width 1.5/f0
    around t, spectral-reassignment instantaneous frequency
    ``IF(w) = f_bin - (fs/2pi) Im{X_w'(w) conj(X_w(w))} / |X_w(w)|^2``
    (X_w' uses the window's time derivative), refined f0 = amplitude-
    weighted mean of IF(k f0)/k over harmonics k <= 6 below Nyquist,
    and score = amplitude-weighted relative deviation of those harmonic
    estimates (lower = more reliable).
    """
    T, K = cand_f0.shape
    flat = cand_f0.ravel()
    live = flat > 0
    if not live.any():
        return cand_f0, np.full_like(cand_f0, np.inf)
    f0s_all = flat[live]
    centers_all = np.round(np.repeat(t_axis, K)[live] * fs8).astype(int)

    # bucket rows by their per-row FFT size — a pure function of the
    # candidate f0 (next power of two covering the +-1.5-period window)
    # — so low-f0 candidates don't force every row onto the largest
    # padded width, AND so the spectral grid each candidate is evaluated
    # on is deterministic per row rather than depending on which other
    # rows share its bucket (the device path, dsp/harvest_jax.py,
    # reproduces the identical grid closed-form per row)
    half_all = np.round(1.5 * fs8 / f0s_all).astype(int)
    refined_all = np.zeros(len(f0s_all))
    score_all = np.full(len(f0s_all), np.inf)
    nffts = 2 ** np.ceil(np.log2(2 * half_all + 1)).astype(int)
    for nf in np.unique(nffts):
        sel = nffts == nf
        r, s = _refine_rows(x8, fs8, f0s_all[sel], centers_all[sel],
                            half_all[sel], int(nf))
        refined_all[sel] = r
        score_all[sel] = s

    out_f0 = np.zeros(T * K)
    out_sc = np.full(T * K, np.inf)
    ok = (refined_all > 0) & np.isfinite(score_all)
    out_f0[live] = np.where(ok, refined_all, 0.0)
    out_sc[live] = np.where(ok, score_all, np.inf)
    return out_f0.reshape(T, K), out_sc.reshape(T, K)


def _refine_rows(x8: np.ndarray, fs8: float, f0s: np.ndarray,
                 centers: np.ndarray, half: np.ndarray, n_fft: int):
    max_half = int(half.max())   # 2*max_half + 1 <= n_fft by bucketing
    m = np.arange(-max_half, max_half + 1)
    pos = centers[:, None] + m[None, :]
    xp = np.pad(x8, (max_half, max_half))
    seg = xp[np.clip(pos + max_half, 0, len(xp) - 1)]
    seg = np.where((pos >= 0) & (pos < len(x8)), seg, 0.0)

    # per-row Blackman over its own +-half support, and its derivative.
    # half is an integer with a small value range (~1.5 periods at the
    # analysis rate), so build each distinct window once and gather —
    # the transcendentals drop from O(rows * W) to O(uniques * W)
    uh, inv = np.unique(half, return_inverse=True)
    hw = uh[:, None].astype(np.float64)
    phase = np.pi * m[None, :] / (hw + 1.0)
    in_win = np.abs(m[None, :]) <= uh[:, None]
    win = np.where(in_win, 0.42 + 0.5 * np.cos(phase)
                   + 0.08 * np.cos(2 * phase), 0.0)[inv]
    dwin = np.where(in_win,
                    -(np.pi / (hw + 1.0))
                    * (0.5 * np.sin(phase) + 0.16 * np.sin(2 * phase)),
                    0.0)[inv]  # d win / d n

    Xw = np.fft.rfft(seg * win, n=n_fft, axis=1)
    Xd = np.fft.rfft(seg * dwin, n=n_fft, axis=1)

    # the instantaneous frequency is only consumed at the <= 6 harmonic
    # bins of each row — gather those first instead of evaluating the
    # reassignment formula over the full spectrum
    df = fs8 / n_fft
    ks = np.arange(1, 7)[None, :]
    n_harm = np.minimum(6, (fs8 / 2.0 / f0s).astype(int))
    use = ks <= n_harm[:, None]                              # (rows, 6)
    bins = np.clip(np.round(ks * f0s[:, None] / df).astype(int), 0,
                   Xw.shape[1] - 1)
    Xw_b = np.take_along_axis(Xw, bins, axis=1)
    Xd_b = np.take_along_axis(Xd, bins, axis=1)
    power = Xw_b.real ** 2 + Xw_b.imag ** 2 + 1e-30
    inst = (bins * df
            - (fs8 / (2.0 * np.pi))
            * (Xd_b.imag * Xw_b.real - Xd_b.real * Xw_b.imag) / power)
    est = inst / ks
    amp = np.where(use, np.sqrt(power), 0.0)
    amp_sum = amp.sum(axis=1)
    refined = (amp * est).sum(axis=1) / np.maximum(amp_sum, 1e-30)
    dev = (amp * np.abs(est - refined[:, None])).sum(axis=1)
    score = dev / (np.maximum(amp_sum, 1e-30) * np.maximum(refined, 1e-9))
    return refined, score


def _runs(mask: np.ndarray):
    """[(start, end)) index pairs of True runs."""
    d = np.diff(np.concatenate([[0], mask.astype(int), [0]]))
    return list(zip(np.where(d == 1)[0], np.where(d == -1)[0]))


def _fix_contour(cand_f0: np.ndarray, cand_sc: np.ndarray,
                 f0_floor: float, f0_ceil: float,
                 score_threshold: float = 0.015) -> np.ndarray:
    """Best-candidate selection + the published contour-fixing steps:
    drop unreliable frames, remove short voiced runs, extend runs
    through the candidate pool under the continuity bound, merge."""
    T, K = cand_f0.shape
    best = np.argmin(cand_sc, axis=1)
    rows = np.arange(T)
    f0 = cand_f0[rows, best]
    sc = cand_sc[rows, best]
    f0 = np.where((sc < score_threshold) & (f0 >= f0_floor)
                  & (f0 <= f0_ceil), f0, 0.0)

    # remove voiced runs shorter than the minimum (9 ms at the 1-ms rate)
    min_run = int(_MIN_VOICED_MS / _BASIC_PERIOD_MS)
    for s, e in _runs(f0 > 0):
        if e - s < min_run:
            f0[s:e] = 0.0

    # extend each run while some candidate stays within the continuity
    # bound of the boundary value (the pool may hold a reliable f0 the
    # per-frame threshold rejected)
    ext = f0.copy()
    relaxed = 4.0 * score_threshold
    for s, e in _runs(f0 > 0):
        ref = f0[e - 1]
        t = e
        while t < T and ext[t] == 0:
            diffs = np.abs(cand_f0[t] - ref) / max(ref, 1e-9)
            j = int(np.argmin(diffs))
            if diffs[j] > _ALLOWED_STEP or cand_sc[t, j] > relaxed:
                break
            ext[t] = cand_f0[t, j]
            ref = ext[t]
            t += 1
        ref = f0[s]
        t = s - 1
        while t >= 0 and ext[t] == 0:
            diffs = np.abs(cand_f0[t] - ref) / max(ref, 1e-9)
            j = int(np.argmin(diffs))
            if diffs[j] > _ALLOWED_STEP or cand_sc[t, j] > relaxed:
                break
            ext[t] = cand_f0[t, j]
            ref = ext[t]
            t -= 1
    return ext


def _smooth_contour(f0: np.ndarray) -> np.ndarray:
    """Zero-phase 2nd-order low-pass over each voiced run (the final
    smoothing step; voiced/unvoiced boundaries are left untouched)."""
    from scipy.signal import butter, filtfilt

    # ~30 Hz cutoff at the 1 kHz candidate rate
    b, a = butter(2, 30.0 / (0.5 * 1000.0 / _BASIC_PERIOD_MS))
    out = f0.copy()
    for s, e in _runs(f0 > 0):
        if e - s > 12:  # filtfilt needs padding room
            out[s:e] = filtfilt(b, a, f0[s:e])
    return out


def harvest(x: np.ndarray, fs: int, f0_floor: float = 71.0,
            f0_ceil: float = 800.0, shiftms: float = 5.0) -> np.ndarray:
    """Harvest F0 track at the requested frame shift (0 = unvoiced).

    Output length matches the convention used throughout the framework:
    ``len(x) // hop + 1`` frames at ``hop = fs * shiftms / 1000``.
    """
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    n_out = len(x) // hop + 1
    if len(x) < int(0.05 * fs) or not np.any(x):
        return np.zeros(n_out)

    x8, fs8 = _decimate(x, fs)
    duration = len(x8) / fs8
    t_axis = np.arange(0.0, duration, _BASIC_PERIOD_MS / 1000.0)

    # keep the channel bank inside what the analysis rate supports
    f0_floor = max(f0_floor, 3.0 * fs8 / len(x8)) if len(x8) else f0_floor
    f0_ceil = min(f0_ceil, fs8 / 4.0)

    cand_f0, _ = _raw_candidates(x8, fs8, t_axis, f0_floor, f0_ceil)
    cand_f0, cand_sc = _refine_candidates(x8, fs8, t_axis, cand_f0)
    f0_1ms = _fix_contour(cand_f0, cand_sc, f0_floor, f0_ceil)
    f0_1ms = _smooth_contour(f0_1ms)

    # resample the 1-ms track to the requested shift
    idx = np.clip(np.round(np.arange(n_out) * hop / fs
                           / (_BASIC_PERIOD_MS / 1000.0)).astype(int),
                  0, max(len(f0_1ms) - 1, 0))
    if len(f0_1ms) == 0:
        return np.zeros(n_out)
    return f0_1ms[idx]
