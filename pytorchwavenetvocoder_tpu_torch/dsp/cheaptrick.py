"""CheapTrick spectral-envelope estimation (Morise 2015, Speech
Communication: "CheapTrick, a spectral envelope estimator for
high-quality speech synthesis").

This is the envelope analysis the reference reaches through
WORLD-via-sprocket before mel-cepstral coding
(`feature_extract.py:154-160,182-183`).  The published algorithm, step
for step (all vectorized over frames):

1. **F0-adaptive windowing** — Hanning window of half-width 1.5/f0
   (three pitch periods), normalized to unit power, with the weighted
   mean subtracted so the windowed segment has no DC bias.
2. **Power spectrum + DC correction** — the band below f0 is
   contaminated by the window's DC leakage; the mirror image of the
   band above f0 (reflected at f0) is added to it.
3. **Linear smoothing** — rectangular smoothing of width 2/3 * f0 on
   the piecewise-linear power spectrum (fractional-width boxcar via the
   interpolated cumulative integral), which removes the harmonic comb.
4. **Infinitesimal noise** — an epsilon floor keeps the log well
   defined (deterministic here, where the original adds random noise of
   the same magnitude: feature extraction must be reproducible).
5. **Liftering with recovery** — in the cepstral domain the smoothing
   lifter ``sinc(pi f0 q)`` removes the residual harmonic interference
   and the compensation lifter ``(1 - 2 q1) + 2 q1 cos(2 pi f0 q)``
   with the published ``q1 = -0.15`` restores the spectral tilt the
   smoothing flattened.

Unvoiced frames use the 500-Hz default F0 (short window, wide-band
smoothing); the working F0 is floored at ``3 fs / fft_size`` so three
periods always fit the window.
"""

from __future__ import annotations

import numpy as np

Q1 = -0.15              # published liftering coefficient
DEFAULT_F0 = 500.0      # working f0 for unvoiced frames
EPS = 1e-10


def _adaptive_window(f0: np.ndarray, fs: int, fftl: int):
    """(T, fftl) per-frame 3-period Hanning windows, unit power."""
    half = np.minimum(np.round(1.5 * fs / f0).astype(int), fftl // 2 - 1)
    idx = np.arange(fftl)[None, :] - fftl // 2
    in_win = np.abs(idx) <= half[:, None]
    win = np.where(in_win,
                   0.5 + 0.5 * np.cos(np.pi * idx / (half[:, None] + 1)),
                   0.0)
    win /= np.sqrt(np.sum(win ** 2, axis=1, keepdims=True)) + 1e-12
    return win


def _windowed_power_spectrum(frames: np.ndarray, win: np.ndarray,
                             fftl: int) -> np.ndarray:
    """Step 1-2a: windowed power spectra with the DC bias removed.

    The weighted mean ``sum(w x)/sum(w)`` is subtracted inside the
    window support so the window's DC leak does not masquerade as
    low-frequency envelope energy.
    """
    wsum = win.sum(axis=1, keepdims=True)
    bias = np.sum(win * frames, axis=1, keepdims=True) / np.maximum(
        wsum, 1e-12)
    xw = (frames - bias) * win
    return np.abs(np.fft.rfft(xw, n=fftl, axis=1)) ** 2


def _dc_correction(spec: np.ndarray, f0: np.ndarray, fs: int,
                   fftl: int) -> np.ndarray:
    """Step 2b: add the mirror of the band above f0 to the band below.

    For bins with frequency w < f0 the corrected spectrum is
    ``P(w) + P(2 f0 - w)`` (linear interpolation at the mirrored
    frequency), making the low end consistent with a harmonic at f0.
    """
    n_half1 = fftl // 2 + 1
    freqs = np.arange(n_half1) * fs / fftl
    T = spec.shape[0]
    mirror_freq = 2.0 * f0[:, None] - freqs[None, :]
    pos = np.clip(mirror_freq / (fs / fftl), 0, n_half1 - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_half1 - 1)
    frac = pos - lo
    rows = np.arange(T)[:, None]
    mirrored = spec[rows, lo] * (1 - frac) + spec[rows, hi] * frac
    below = freqs[None, :] < f0[:, None]
    return spec + np.where(below, mirrored, 0.0)


def _linear_smoothing(spec: np.ndarray, f0: np.ndarray, fs: int,
                      fftl: int) -> np.ndarray:
    """Step 3: fractional-width rectangular smoothing (width 2/3 f0).

    Each output bin is the mean of the piecewise-linear input over
    ``[w - f0/3, w + f0/3]``, computed from the interpolated cumulative
    integral — the continuous-axis formulation, not a rounded discrete
    boxcar, so the smoothing width tracks f0 exactly.
    """
    n_half1 = fftl // 2 + 1
    df = fs / fftl
    T = spec.shape[0]
    # reflect-extend so the integral is defined beyond both edges:
    # position -k mirrors bin k (about DC) and position (n-1)+k mirrors
    # bin n-1-k (about Nyquist) — a short right extension would truncate
    # the boxcar at Nyquist and bias the top ~f0/3 band low
    ext = np.concatenate([spec[:, 1:][:, ::-1], spec, spec[:, -2::-1]],
                         axis=1)
    orig0 = n_half1 - 1  # index of bin 0 in the extension
    # cumulative trapezoid integral along the extended axis
    cum = np.concatenate(
        [np.zeros((T, 1)),
         np.cumsum(0.5 * (ext[:, 1:] + ext[:, :-1]) * df, axis=1)], axis=1)

    def integral_at(freq_pos):
        pos = np.clip(freq_pos / df + orig0, 0, ext.shape[1] - 1.001)
        lo = np.floor(pos).astype(int)
        frac = pos - lo
        rows = np.arange(T)[:, None]
        base = cum[rows, lo]
        # add the partial trapezoid into the fractional bin
        a = ext[rows, lo]
        b = ext[rows, np.minimum(lo + 1, ext.shape[1] - 1)]
        return base + df * frac * (a + 0.5 * frac * (b - a))

    width = (2.0 / 3.0) * f0[:, None]
    freqs = np.arange(n_half1)[None, :] * df
    upper = integral_at(freqs + width / 2.0)
    lower = integral_at(freqs - width / 2.0)
    return np.maximum((upper - lower) / width, EPS)


def _lifter_with_recovery(spec: np.ndarray, f0: np.ndarray, fs: int,
                          fftl: int) -> np.ndarray:
    """Step 5: sinc smoothing lifter + q1 compensation lifter."""
    cep = np.fft.irfft(np.log(spec), n=fftl, axis=1)
    q = np.arange(fftl) * (1.0 / fs)
    q = np.minimum(q, fftl / fs - q)  # symmetric quefrency axis
    arg = np.pi * f0[:, None] * q[None, :]
    safe = np.maximum(arg, 1e-9)
    sinc = np.where(arg > 1e-9, np.sin(safe) / safe, 1.0)
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * np.cos(2.0 * arg)
    return np.exp(np.fft.rfft(cep * sinc * comp, axis=1).real)


def cheaptrick(frames: np.ndarray, f0: np.ndarray, fs: int,
               fftl: int) -> np.ndarray:
    """Spectral envelopes (T, fftl//2+1) of pre-cut centered frames.

    ``frames`` are (T, fftl) windows of the waveform centered on each
    frame time; ``f0`` is the per-frame (continuous) F0 in Hz, 0 or
    non-positive marking unvoiced (handled with the 500-Hz default).
    """
    f0 = np.asarray(f0, np.float64)
    f0_floor = 3.0 * fs / fftl
    f0 = np.clip(np.where(f0 > 0, f0, DEFAULT_F0), f0_floor, fs / 8.0)

    win = _adaptive_window(f0, fs, fftl)
    spec = _windowed_power_spectrum(frames, win, fftl)
    spec = _dc_correction(spec, f0, fs, fftl)
    spec = _linear_smoothing(spec, f0, fs, fftl)
    spec = spec + EPS  # infinitesimal noise floor (deterministic)
    return _lifter_with_recovery(spec, f0, fs, fftl)
