"""F0 estimation and continuous-F0 interpolation.

Replaces the WORLD (Harvest/DIO) F0 analysis the reference reaches via
sprocket (`feature_extract.py:154-183`).  WORLD itself is a C++
dependency that is not available; this is an original normalized-
autocorrelation tracker with the same *surface*: frame-rate F0 in Hz with
0 for unvoiced frames, bounded by (minf0, maxf0), at a ``shiftms`` hop.

``convert_to_continuous_f0`` mirrors the reference helper
(`feature_extract.py:80-113`): binary uv flag + linear interpolation of
voiced F0 across unvoiced gaps, with edge values held.
"""

from __future__ import annotations

import numpy as np


def convert_to_continuous_f0(f0: np.ndarray):
    """(T,) f0-with-zeros -> (uv (T,), continuous f0 (T,))."""
    f0 = np.asarray(f0, np.float64).copy()
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0

    nz = np.nonzero(f0)[0]
    start_idx, end_idx = nz[0], nz[-1]
    f0[:start_idx] = f0[start_idx]
    f0[end_idx:] = f0[end_idx]
    nz = np.nonzero(f0)[0]
    cont_f0 = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont_f0


def _frame_autocorr(frames: np.ndarray, max_lag: int) -> np.ndarray:
    """Normalized autocorrelation per frame via FFT (n_frames, max_lag+1)."""
    n = frames.shape[1]
    n_fft = 1
    while n_fft < 2 * n:
        n_fft *= 2
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    ac = np.fft.irfft(np.abs(spec) ** 2, n=n_fft, axis=1)[:, : max_lag + 1]
    return ac


def extract_f0(x: np.ndarray, fs: int, minf0: float = 40.0,
               maxf0: float = 400.0, shiftms: float = 5.0,
               voicing_threshold: float | None = None,
               method: str = "harvest") -> np.ndarray:
    """Frame-rate F0 track in Hz; 0 marks unvoiced frames.

    ``method="harvest"`` (default) runs the published Harvest algorithm
    (dsp/harvest.py — band-pass filter bank, four-event interval
    candidates, instantaneous-frequency refinement, contour fixing),
    matching the analysis the reference reaches through WORLD
    (`feature_extract.py:154-160,179`).  ``method="nac"`` keeps the
    original normalized-autocorrelation + Viterbi tracker
    (``extract_f0_nac``) as a fast fallback.

    ``voicing_threshold`` is an NAC-tracker knob (unvoiced-state
    emission, default 0.45); Harvest has no such parameter — its
    voicing decision is the published contour-fixing procedure — so an
    explicit value with ``method="harvest"`` is refused rather than
    silently ignored.
    """
    if method == "harvest":
        if voicing_threshold is not None:
            raise ValueError(
                "voicing_threshold only applies to method='nac'; the "
                "published Harvest algorithm has no voicing threshold")
        from pytorchwavenetvocoder_tpu_torch.dsp.harvest import harvest

        return harvest(x, fs, f0_floor=minf0, f0_ceil=maxf0,
                       shiftms=shiftms)
    if method != "nac":
        raise ValueError(f"method must be 'harvest' or 'nac', got {method!r}")
    return extract_f0_nac(x, fs, minf0, maxf0, shiftms,
                          0.45 if voicing_threshold is None
                          else voicing_threshold)


def extract_f0_nac(x: np.ndarray, fs: int, minf0: float = 40.0,
                   maxf0: float = 400.0, shiftms: float = 5.0,
                   voicing_threshold: float = 0.45) -> np.ndarray:
    """Frame-rate F0 track in Hz; 0 marks unvoiced frames.

    Method: per frame, normalized autocorrelation (NAC) over the lag range
    [fs/maxf0, fs/minf0]; the top-K NAC local maxima (parabolic-refined)
    become period candidates; a Viterbi pass over {unvoiced} + candidates
    picks the contour maximizing NAC emission minus octave-continuity and
    voicing-switch penalties.  Contour tracking without any external
    dependency; voicing = the Viterbi path (unvoiced emission =
    ``voicing_threshold``) with an energy floor gate.
    """
    x = np.asarray(x, np.float64)
    x = x - np.mean(x)
    hop = int(fs * shiftms / 1000.0)
    min_lag = max(2, int(fs / maxf0))
    max_lag = int(np.ceil(fs / minf0))
    frame_len = min(len(x), 2 * max_lag + hop)
    if len(x) < frame_len or frame_len <= max_lag:
        n_frames = max(1, len(x) // hop + 1)
        return np.zeros(n_frames)

    # centered frames, edge-padded
    half = frame_len // 2
    xp = np.pad(x, (half, half + frame_len), "constant")
    n_frames = len(x) // hop + 1
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[idx]

    ac = _frame_autocorr(frames, max_lag)
    energy = ac[:, 0] + 1e-12

    # NAC with a mild lag-window to de-bias long lags
    lags = np.arange(max_lag + 1)
    norm = np.maximum(1e-12, 1.0 - lags / frame_len)
    nac = ac / energy[:, None] / norm[None, :]
    nac[:, :min_lag] = -1.0

    # ---- candidate peaks (top-K local NAC maxima, parabolic-refined) ----
    K = 4
    is_peak = np.zeros_like(nac, bool)
    is_peak[:, 1:-1] = (nac[:, 1:-1] >= nac[:, :-2]) & (nac[:, 1:-1] >= nac[:, 2:])
    masked = np.where(is_peak, nac, -np.inf)
    cand_lag = np.argsort(masked, axis=1)[:, -K:]            # (T, K)
    rows = np.arange(n_frames)[:, None]
    cand_val = masked[rows, cand_lag]                        # -inf = absent

    l0 = np.clip(cand_lag, min_lag + 1, max_lag - 1)
    y_m, y_0, y_p = nac[rows, l0 - 1], nac[rows, l0], nac[rows, l0 + 1]
    denom = y_m - 2 * y_0 + y_p
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (y_m - y_p) / safe, 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    lag_ref = np.where(cand_lag == l0, l0 + delta, cand_lag).astype(np.float64)
    cand_f0 = fs / np.maximum(lag_ref, 1.0)                  # (T, K)

    in_range = (cand_f0 >= minf0) & (cand_f0 <= maxf0)
    energy_floor = 1e-4 * np.max(energy)
    frame_ok = energy > energy_floor
    cand_ok = in_range & np.isfinite(cand_val) & frame_ok[:, None]
    cand_val = np.where(cand_ok, cand_val, -np.inf)

    # ---- Viterbi over {unvoiced} + K candidates per frame --------------
    # Emission: NAC value with a small RAPT-style lag bias (favoring the
    # shortest period among near-equal peaks kills subharmonic lock-in);
    # unvoiced emits ``voicing_threshold``.  Transition: octave-distance
    # penalty between voiced states, a fixed toll for voicing changes.
    # This replaces global-median octave "correction", which cannot
    # represent legitimate octave jumps in the contour.
    LAM = 0.35       # per-octave continuity penalty
    TOLL = 0.12      # voiced <-> unvoiced switch penalty
    LAG_BIAS = 0.01  # per-octave-of-lag emission bias toward short lags
    n_states = K + 1  # state 0 = unvoiced
    em = np.full((n_frames, n_states), -np.inf)
    em[:, 0] = voicing_threshold
    em[:, 1:] = cand_val - LAG_BIAS * np.log2(
        np.maximum(lag_ref, min_lag) / min_lag)
    logf = np.where(cand_val > -np.inf, np.log2(np.maximum(cand_f0, 1e-6)), 0.0)

    score = em[0].copy()
    back = np.zeros((n_frames, n_states), np.int8)
    for t in range(1, n_frames):
        trans = np.zeros((n_states, n_states))
        trans[0, 1:] = trans[1:, 0] = TOLL
        df = np.abs(logf[t - 1][:, None] - logf[t][None, :])
        trans[1:, 1:] = LAM * df
        total = score[:, None] - trans
        back[t] = np.argmax(total, axis=0)
        score = total[back[t], np.arange(n_states)] + em[t]

    f0 = np.zeros(n_frames)
    s = int(np.argmax(score))
    for t in range(n_frames - 1, -1, -1):
        if s > 0:
            f0[t] = cand_f0[t, s - 1]
        s = int(back[t, s])
    return f0
