"""STFT and mel-spectrogram, librosa-compatible semantics.

The reference's melspc path (`feature_extract.py:199-237`) calls
``librosa.feature.melspectrogram(x, fs, n_fft, hop_length, n_mels, fmin,
fmax, power=1.0)``; librosa is unavailable here, so this module
re-implements the consumed behavior: centered reflect-padded Hann STFT,
magnitude (power=1) spectrum, and a Slaney-style mel filterbank with
Slaney area normalization (librosa defaults ``htk=False, norm='slaney'``).
"""

from __future__ import annotations

import numpy as np


def hz_to_mel(f, htk: bool = False):
    """Hz -> mel.  Slaney formula by default (librosa's default)."""
    f = np.asanyarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    mels)
    return mels


def mel_to_hz(m, htk: bool = False):
    m = np.asanyarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_min + f_sp * m
    log_region = m >= min_log_mel
    freqs = np.where(log_region,
                     min_log_hz * np.exp(logstep * (m - min_log_mel)),
                     freqs)
    return freqs


def mel_filterbank(fs: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney") -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular mel filterbank."""
    if fmax is None:
        fmax = fs / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, fs / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights


def frame_signal(x: np.ndarray, frame_length: int, hop_length: int,
                 center: bool = True, pad_mode: str = "reflect") -> np.ndarray:
    """Slice x into overlapping frames (n_frames, frame_length)."""
    if center:
        x = np.pad(x, (frame_length // 2, frame_length // 2), mode=pad_mode)
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    return x[idx]


def stft(x: np.ndarray, n_fft: int = 1024, hop_length: int = 256,
         window: str = "hann", center: bool = True) -> np.ndarray:
    """Complex STFT (n_frames, 1 + n_fft//2), librosa conventions
    (Hann window, centered reflect padding)."""
    from scipy.signal import get_window

    win = get_window(window, n_fft, fftbins=True)
    frames = frame_signal(np.asarray(x, np.float64), n_fft, hop_length, center)
    return np.fft.rfft(frames * win[None, :], n=n_fft, axis=1)


def melspectrogram(x: np.ndarray, fs: int, n_fft: int = 1024,
                   hop_length: int = 256, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   power: float = 1.0) -> np.ndarray:
    """Mel spectrogram (n_frames, n_mels); power=1.0 = magnitude mel
    (reference's setting, `feature_extract.py:221-228`)."""
    spec = np.abs(stft(x, n_fft=n_fft, hop_length=hop_length)) ** power
    fb = mel_filterbank(fs, n_fft, n_mels, fmin, fmax)
    return spec @ fb.T
