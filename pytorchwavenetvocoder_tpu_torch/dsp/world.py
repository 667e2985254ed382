"""WORLD acoustic analysis: [uv, cont_f0_lpf, mcep, codeap].

Provides the feature surface the reference gets from WORLD-via-sprocket
(`feature_extract.py:151-196`): per-frame F0/uv, 20 Hz low-passed
continuous F0, mel-cepstral spectral envelope, and coded band
aperiodicity, concatenated in the same column order and dimensioning
(e.g. fs=16k, mcep_dim=24 -> 1+1+25+1 = 28 = the arctic recipes' n_aux).

The three analyses implement the published WORLD algorithms:
  f0      — Harvest (dsp/harvest.py): band-pass filter bank four-event
            candidates + instantaneous-frequency refinement
  mcep    — CheapTrick envelope (dsp/cheaptrick.py): F0-adaptive window,
            DC correction, 2/3*f0 smoothing, q1=-0.15 liftering,
            mel-cepstrally coded (UELS mcep, dsp/cepstrum.py)
  codeap  — D4C (dsp/d4c.py): static-group-delay band aperiodicity in
            dB (0 = aperiodic, -60 = periodic), with WORLD's band count
            floor((min(15000, fs/2-3000))/3000) at 3 kHz centers
"""

from __future__ import annotations

import numpy as np

from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import sp2mc_batch
from pytorchwavenetvocoder_tpu_torch.dsp.d4c import d4c, n_codeap_bands  # noqa: F401 (re-export)
from pytorchwavenetvocoder_tpu_torch.dsp.f0 import (
    convert_to_continuous_f0,
    extract_f0,
)
from pytorchwavenetvocoder_tpu_torch.dsp.filters import low_pass_filter

EPS = 1e-10


def _centered_frames(x: np.ndarray, frame_len: int, hop: int,
                     n_frames: int) -> np.ndarray:
    half = frame_len // 2
    xp = np.pad(x, (half, half + frame_len), "constant")
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n_frames)[:, None]
    return xp[idx]


def spectral_envelope_mcep(x: np.ndarray, fs: int, shiftms: float,
                           fftl: int, mcep_dim: int, mcep_alpha: float,
                           n_frames: int,
                           cont_f0: np.ndarray | None = None,
                           frames: np.ndarray | None = None) -> np.ndarray:
    """(n_frames, mcep_dim+1) mel-cepstra of the spectral envelope.

    With ``cont_f0``, runs the published CheapTrick algorithm
    (``dsp/cheaptrick.py`` — the reference's envelope estimator,
    `feature_extract.py:154-160`): F0-adaptive 3-period Hanning window
    with DC-bias removal, DC correction below f0, fractional-width
    2/3*f0 rectangular smoothing on the continuous frequency axis, and
    the sinc + q1=-0.15 liftering with recovery.  Without ``cont_f0``,
    falls back to fixed Hanning-window periodogram mcep.  All steps are
    vectorized over frames.
    """
    hop = int(fs * shiftms / 1000.0)
    x = np.asarray(x, np.float64)
    if frames is None:
        frames = _centered_frames(x, fftl, hop, n_frames)   # (T, fftl)
    if cont_f0 is None:
        win = np.hanning(fftl)
        spec = np.abs(np.fft.rfft(frames * win[None, :], axis=1)) ** 2
        return sp2mc_batch(np.maximum(spec, EPS), mcep_dim, mcep_alpha)

    from pytorchwavenetvocoder_tpu_torch.dsp.cheaptrick import cheaptrick

    f0 = np.asarray(cont_f0, np.float64)[:n_frames]
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)), "edge")
    env = cheaptrick(frames, f0, fs, fftl)
    return sp2mc_batch(np.maximum(env, EPS), mcep_dim, mcep_alpha)


def band_aperiodicity(x: np.ndarray, fs: int, f0: np.ndarray,
                      shiftms: float, n_frames: int,
                      fftl: int = 1024,
                      frames: np.ndarray | None = None) -> np.ndarray:
    """(n_frames, n_bands) D4C coarse band aperiodicity in dB.

    Runs the published D4C static-group-delay estimator (dsp/d4c.py) on
    centered frames.  ``f0`` is the raw (zeros = unvoiced) track, the
    WORLD convention: unvoiced frames are fully aperiodic (0 dB).
    """
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    f0 = np.asarray(f0, np.float64)[:n_frames]
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)))
    if frames is None:
        frames = _centered_frames(x, fftl, hop, n_frames)
    return d4c(frames, f0, fs, fftl)


def world_analyze(x: np.ndarray, fs: int, shiftms: float = 5.0,
                  minf0: float = 40.0, maxf0: float = 400.0,
                  fftl: int = 1024, mcep_dim: int = 24,
                  mcep_alpha: float = 0.41) -> np.ndarray:
    """Full WORLD-style feature matrix (n_frames, 2 + mcep_dim+1 + n_bands):
    columns [uv, cont_f0_lpf, mcep..., codeap...] in the reference's
    concatenation order (`feature_extract.py:186-188`)."""
    x = np.asarray(x, np.float64)
    hop = int(fs * shiftms / 1000.0)
    n_frames = len(x) // hop + 1

    f0 = extract_f0(x, fs, minf0=minf0, maxf0=maxf0, shiftms=shiftms)
    f0 = f0[:n_frames]
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)))
    uv, cont_f0 = convert_to_continuous_f0(f0)
    frame_rate = int(1.0 / (shiftms * 0.001))
    cont_f0_lpf = low_pass_filter(cont_f0, frame_rate, cutoff=20)

    # both estimators consume the same centered frames — cut once
    frames = _centered_frames(x, fftl, hop, n_frames)
    mcep = spectral_envelope_mcep(x, fs, shiftms, fftl, mcep_dim,
                                  mcep_alpha, n_frames, cont_f0=cont_f0,
                                  frames=frames)
    # D4C consumes the RAW f0 (zeros for unvoiced -> 0 dB aperiodicity),
    # matching how the reference feeds WORLD's f0 into the ap analysis
    codeap = band_aperiodicity(x, fs, f0, shiftms, n_frames, fftl=fftl,
                               frames=frames)

    return np.concatenate([uv[:, None].astype(np.float64),
                           cont_f0_lpf[:, None], mcep, codeap], axis=1)
