"""D4C band-aperiodicity estimation (Morise 2016, Speech Communication:
"D4C, a band-aperiodicity estimator for high-quality speech synthesis").

This is the aperiodicity analysis behind the reference's ``codeap``
conditioning channels (`feature_extract.py:182` via sprocket/WORLD).
The published construction, step for step (vectorized over frames):

1. **Group delay** — per frame, a Blackman window of half-width 2/f0
   (four pitch periods); with ``X`` the windowed spectrum and ``X_t``
   the spectrum of the time-weighted windowed waveform, the group delay
   is ``gd(w) = Re{X_t(w) conj(X(w))} / |X(w)|^2``.
2. **Static group delay** — rectangular smoothing of width f0/2 on the
   frequency axis.  Averaging over half a harmonic spacing makes the
   periodic component's group delay *static* (a smooth function of
   frequency) while an aperiodic component keeps fluctuating — this is
   the estimator's core discrimination.
3. **Coarse band statistic** — for each 3-kHz band center, the static
   group delay is windowed with a Nuttall window (half-width 3 kHz;
   the static component, pedestal included, is deliberately kept in —
   the main-lobe power subtraction below accounts for it) and
   Fourier-transformed.  A static segment
   concentrates its power in the transform's main lobe (the Nuttall
   lobe spans ~8/L of the padded length); a fluctuating segment spreads
   it.  The band aperiodicity is the power fraction OUTSIDE the largest
   main-lobe-count components: ``10 log10(1 - top_k_power/total)``.
4. **Voicing** — unvoiced frames (f0 = 0, as in the raw Harvest track)
   are fully aperiodic: 0 dB, the WORLD convention.

Band count is WORLD's ``floor(min(15000, fs/2 - 3000) / 3000)`` with
centers at 3000(b+1) Hz; outputs are clipped to [-60, 0] dB as the
downstream pipeline expects.
"""

from __future__ import annotations

import numpy as np

from pytorchwavenetvocoder_tpu_torch.dsp.harvest import _nuttall

FLOOR_DB = -60.0
EPS = 1e-12


def n_codeap_bands(fs: int) -> int:
    """WORLD's coded-aperiodicity band count for a sampling rate."""
    frequency_interval = 3000.0
    upper_limit = 15000.0
    return max(1, int(min(upper_limit, fs / 2.0 - frequency_interval)
                      / frequency_interval))


def _static_group_delay(frames: np.ndarray, f0: np.ndarray, fs: int,
                        fftl: int) -> np.ndarray:
    """(T, fftl//2+1) static group delay in seconds (steps 1-2).

    Both the group-delay numerator ``Re{X_t conj(X)}`` and the power
    ``|X|^2`` are smoothed with width f0/2 BEFORE the division: the raw
    quotient is meaningless between harmonics (0/0), while the smoothed
    quotient is the power-weighted group delay over each half harmonic
    spacing — static for a periodic component, fluctuating for noise.
    A T0/8 pedestal is added so the periodic component's static delay
    is never accidentally zero (a frame centered exactly on a pulse
    would otherwise have no static power to anchor the band statistic).
    """
    half = np.minimum(np.round(2.0 * fs / f0).astype(int), fftl // 2 - 1)
    idx = np.arange(fftl)[None, :] - fftl // 2
    in_win = np.abs(idx) <= half[:, None]
    ph = np.pi * idx / (half[:, None] + 1.0)
    win = np.where(in_win, 0.42 + 0.5 * np.cos(ph) + 0.08 * np.cos(2 * ph),
                   0.0)
    xw = frames * win
    t_rel = idx / fs  # seconds relative to the frame center
    X = np.fft.rfft(xw, axis=1)
    Xt = np.fft.rfft(xw * t_rel, axis=1)
    power = np.abs(X) ** 2
    num = (Xt * np.conj(X)).real
    num_s = _smooth(num, f0 / 2.0, fs, fftl)
    pow_s = _smooth(power, f0 / 2.0, fs, fftl)
    floor = np.maximum(pow_s.max(axis=1, keepdims=True) * 1e-8, EPS)
    # pedestal scale T0/8: large enough that a pitch-synchronous frame
    # still anchors a static component, small enough that full-band
    # noise reads ~-2 dB instead of being dragged toward periodicity by
    # the pedestal's own main-lobe power (calibrated on analytic
    # signals; see tests/test_d4c.py)
    return num_s / np.maximum(pow_s, floor) + 0.125 / f0[:, None]


def _smooth(signal: np.ndarray, width_hz: np.ndarray, fs: int,
            fftl: int) -> np.ndarray:
    """Fractional-width rectangular smoothing on the frequency axis
    (same continuous-axis formulation as CheapTrick's, applied to an
    arbitrary per-frame signal)."""
    from pytorchwavenetvocoder_tpu_torch.dsp.cheaptrick import _linear_smoothing

    # _linear_smoothing takes the width as 2/3*f0; feed it an f0 that
    # produces the requested width and remove its positivity floor
    pseudo_f0 = width_hz * 1.5
    off = signal.min() - 1.0
    return _linear_smoothing(signal - off, pseudo_f0, fs, fftl) + off


def d4c(frames: np.ndarray, f0: np.ndarray, fs: int,
        fftl: int) -> np.ndarray:
    """(T, n_bands) coarse band aperiodicity in dB, 0 = fully aperiodic.

    ``frames`` are (T, fftl) waveform windows centered on the frame
    times; ``f0`` is the raw F0 track (0 = unvoiced).
    """
    f0 = np.asarray(f0, np.float64)
    T = frames.shape[0]
    n_bands = n_codeap_bands(fs)
    out = np.zeros((T, n_bands))
    voiced = f0 > 0
    if not voiced.any():
        return out

    f0_floor = 4.0 * fs / fftl  # the window must fit 4 periods
    f0v = np.clip(f0[voiced], f0_floor, fs / 8.0)
    sgd = _static_group_delay(frames[voiced], f0v, fs, fftl)

    df = fs / fftl
    n_half1 = fftl // 2 + 1
    half_bins = int(round(3000.0 / df))
    L = 2 * half_bins + 1
    nuttall = _nuttall(L)
    n_seg_fft = 1
    while n_seg_fft < L:
        n_seg_fft *= 2
    # power of a static segment concentrates in the Nuttall main lobe:
    # ~8 transform bins at the unpadded length, scaled by the padding
    n_static = max(1, int(round(8.0 * n_seg_fft / L / 2.0)))

    for b in range(n_bands):
        center = int(round(3000.0 * (b + 1) / df))
        lo = center - half_bins
        hi = center + half_bins + 1
        lo_c, hi_c = max(lo, 0), min(hi, n_half1)
        seg = np.zeros((sgd.shape[0], L))
        seg[:, lo_c - lo: hi_c - lo] = sgd[:, lo_c:hi_c]
        # the static component (incl. the T0/8 pedestal) stays in: it is
        # exactly what the main-lobe power subtraction accounts for
        seg = seg * nuttall[None, :]
        P = np.abs(np.fft.rfft(seg, n=n_seg_fft, axis=1)) ** 2
        # real-input rfft halves the spectrum; double interior bins so
        # the sorted-power ratio sees the full-circle energy
        P[:, 1:-1] *= 2.0
        P_sorted = np.sort(P, axis=1)[:, ::-1]
        total = P_sorted.sum(axis=1) + EPS
        static_part = P_sorted[:, :n_static].sum(axis=1)
        ratio = np.maximum(1.0 - static_part / total, 10.0 ** (FLOOR_DB / 10.0))
        out[voiced, b] = 10.0 * np.log10(ratio)
    return np.clip(out, FLOOR_DB, 0.0)
