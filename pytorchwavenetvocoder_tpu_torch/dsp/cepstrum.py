"""Mel-cepstral analysis (the SPTK surface the reference consumes).

Provides equivalents of the pysptk functions the reference calls:
``mcep`` (`feature_extract.py:144`), ``mc2b`` (`noise_shaping.py:41`) and
the ``sp2mc`` path used by sprocket for WORLD envelopes.

The mel-cepstrum is computed as in SPTK's mcep (Fukada & Tokuda's
mel-cepstral analysis): the warped-cepstrum solution (real cepstrum of
the floored log spectrum + Oppenheim ``freqt`` recursion) initializes a
Newton iteration on the UELS criterion

    eps(c) = (1/2pi) \\int [ e^{R(l)} - R(l) - 1 ] dl,
    R(l) = log Stilde(l) - 2 sum_m c_m cos(m l)

evaluated on the uniformly-sampled WARPED frequency axis l (Stilde is
the periodogram resampled onto that axis, obtained by running the full
cepstrum through freqt).  At the optimum the residual spectrum
E = e^{R} satisfies r_0 = 1 and r_m = 0 (m = 1..order), where r_m are
E's Fourier coefficients — the optimality condition the tests assert.
Refinement is on by default, matching ``pysptk.mcep`` semantics
(reference `feature_extract.py:144`).
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Frequency-transform a cepstrum by the all-pass warping ``alpha``.

    Oppenheim recursion; (M+1,) -> (order+1,).  ``alpha > 0`` warps
    linear-frequency cepstra to mel; ``-alpha`` inverts.
    """
    c = np.asarray(c, np.float64)
    g = np.zeros(order + 1)
    beta = 1.0 - alpha * alpha
    for i in range(len(c) - 1, -1, -1):
        prev = g.copy()
        g[0] = c[i] + alpha * prev[0]
        if order >= 1:
            g[1] = beta * prev[0] + alpha * prev[1]
        for m in range(2, order + 1):
            g[m] = prev[m - 1] + alpha * (prev[m] - g[m - 1])
    return g


def freqt_batch(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Vectorized ``freqt`` over a leading frame axis: (F, M1) ->
    (F, order+1).  Same Oppenheim recursion; the two sequential loop
    nests run in python but every step is a numpy op over all frames,
    which is ~50x faster than calling ``freqt`` per frame."""
    c = np.asarray(c, np.float64)
    F, m1 = c.shape
    g = np.zeros((F, order + 1))
    beta = 1.0 - alpha * alpha
    for i in range(m1 - 1, -1, -1):
        prev = g
        g = np.empty_like(prev)
        g[:, 0] = c[:, i] + alpha * prev[:, 0]
        if order >= 1:
            g[:, 1] = beta * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            g[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - g[:, m - 1])
    return g


def sp2mc_batch(power_spec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Vectorized ``sp2mc`` over frames: (F, n_fft//2+1) -> (F, order+1).

    Uses the native library when built (C++ loop), else batched numpy.
    """
    import os

    power_spec = np.asarray(power_spec, np.float64)
    if not os.environ.get("WNDSP_DISABLE_NATIVE"):
        from pytorchwavenetvocoder_tpu_torch import native

        if native.available():
            return native.sp2mc_batch(power_spec, order, alpha)
    n_fft = (power_spec.shape[1] - 1) * 2
    log_spec = 0.5 * np.log(np.maximum(power_spec, EPS))
    cep = np.fft.irfft(log_spec, n=n_fft, axis=1)[:, : n_fft // 2 + 1]
    cep[:, 1:-1] *= 2.0
    return freqt_batch(cep, order, alpha)


def mc2b(mc: np.ndarray, alpha: float) -> np.ndarray:
    """Mel-cepstrum -> MLSA filter coefficients (pysptk.mc2b)."""
    mc = np.asarray(mc, np.float64)
    b = np.zeros_like(mc)
    b[-1] = mc[-1]
    for m in range(len(mc) - 2, -1, -1):
        b[m] = mc[m] - alpha * b[m + 1]
    return b


def b2mc(b: np.ndarray, alpha: float) -> np.ndarray:
    """MLSA filter coefficients -> mel-cepstrum (inverse of mc2b)."""
    b = np.asarray(b, np.float64)
    mc = np.zeros_like(b)
    mc[-1] = b[-1]
    for m in range(len(b) - 2, -1, -1):
        mc[m] = b[m] + alpha * b[m + 1]
    return mc


def _log_spec_to_cepstrum(log_spec: np.ndarray, n_fft: int) -> np.ndarray:
    """One-sided log spectrum (n_fft//2+1,) -> real cepstrum (n_fft//2+1,)."""
    c = np.fft.irfft(log_spec, n=n_fft)
    cep = c[: n_fft // 2 + 1].copy()
    return cep


def sp2mc(power_spec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Power spectrum (one-sided, n_fft//2+1) -> mel-cepstrum (order+1,).

    Equivalent surface of pysptk.sp2mc: cepstrum of 0.5*log(power), then
    freqt to the warped axis.
    """
    n_fft = (len(power_spec) - 1) * 2
    log_spec = 0.5 * np.log(np.maximum(power_spec, EPS))
    cep = _log_spec_to_cepstrum(log_spec, n_fft)
    # double interior terms: one-sided cepstrum of a symmetric sequence
    cep[1:-1] *= 2.0
    return freqt(cep, order, alpha)


def mc2sp(mc: np.ndarray, alpha: float, n_fft: int) -> np.ndarray:
    """Mel-cepstrum -> power spectrum (inverse of sp2mc)."""
    c = freqt(mc, n_fft // 2, -alpha)
    c[1:-1] *= 0.5  # undo one-sided doubling (Nyquist term appears once)
    full = np.zeros(n_fft)
    full[: n_fft // 2 + 1] = c
    full[n_fft // 2 + 1:] = c[1: n_fft // 2][::-1]
    log_spec = np.fft.rfft(full).real
    return np.exp(2.0 * log_spec)


def _warped_log_spec(power_spec: np.ndarray, alpha: float) -> np.ndarray:
    """Resample log(power)/1 onto the uniformly-sampled warped axis.

    Warping the frequency axis of a log spectrum is exactly ``freqt`` on
    its full (untruncated) Fourier-coefficient sequence.
    Returns the one-sided warped log power spectrum (n_fft//2+1,).
    """
    n_fft = (len(power_spec) - 1) * 2
    log_spec = 0.5 * np.log(power_spec)
    cep = _log_spec_to_cepstrum(log_spec, n_fft)
    cep[1:-1] *= 2.0
    cw = freqt(cep, n_fft // 2, alpha)
    cw[1:-1] *= 0.5
    full = np.zeros(n_fft)
    full[: n_fft // 2 + 1] = cw
    full[n_fft // 2 + 1:] = cw[1: n_fft // 2][::-1]
    return 2.0 * np.fft.rfft(full).real  # log power on the warped axis


def uels_refine(c: np.ndarray, power_spec: np.ndarray, alpha: float,
                n_iter: int = 30, threshold: float = 1e-8) -> np.ndarray:
    """Newton iterations of mel-cepstral analysis (SPTK mcep's loop).

    c: initial warped cepstrum (order+1,), power_spec: one-sided
    periodogram (n_fft//2+1,).  Returns the UELS-optimal coefficients.
    """
    order = len(c) - 1
    n_fft = (len(power_spec) - 1) * 2
    log_sw = _warped_log_spec(power_spec, alpha)       # (n_fft//2+1,)
    c = np.asarray(c, np.float64).copy()
    idx = np.arange(1, order + 1)
    for _ in range(n_iter):
        # model log amplitude on the warped grid:
        # log|H| = c_0 + sum_m c_m cos(m lam); the mel-cepstrum uses the
        # doubled-interior convention, so the mirrored FFT input halves
        # the interior terms
        cz = np.zeros(n_fft)
        cz[0] = c[0]
        cz[1: order + 1] = 0.5 * c[1:]
        cz[n_fft - order: n_fft] = 0.5 * c[1:][::-1]
        logh = np.fft.rfft(cz).real                    # (n_fft//2+1,)
        r_spec = np.exp(log_sw - 2.0 * logh)           # residual E(lam)
        # Fourier coefficients of E (real, even) up to lag 2*order
        r = np.fft.irfft(r_spec, n=n_fft)[: 2 * order + 1]
        # gain-normalize analytically each iteration (c0 <- c0 +
        # log(r0)/2 makes r0 = 1 exactly); Newton runs on c1..cM only —
        # without this the undamped step overshoots and diverges
        c[0] += 0.5 * np.log(r[0])
        r = r / r[0]
        grad = r[1: order + 1]
        if np.max(np.abs(grad)) < threshold:
            break
        # Newton: (Toeplitz(r) + Hankel(r)) delta = grad on m,n >= 1
        H = (r[np.abs(idx[:, None] - idx[None, :])]
             + r[idx[:, None] + idx[None, :]])
        try:
            delta = np.linalg.solve(H, grad)
        except np.linalg.LinAlgError:
            break
        c[1:] += delta
    return c


def mcep(frame: np.ndarray, order: int = 24, alpha: float = 0.41,
         eps: float = EPS, n_fft: int | None = None,
         refine: bool = True) -> np.ndarray:
    """Mel-cepstrum of a windowed waveform frame (pysptk.mcep surface,
    etype=1 semantics: periodogram floored at ``eps``).

    ``refine=True`` (default) runs the UELS Newton iterations like SPTK;
    ``refine=False`` returns the warped-cepstrum initialization only.
    """
    frame = np.asarray(frame, np.float64)
    if n_fft is None:
        n_fft = len(frame)
    spec = np.maximum(np.abs(np.fft.rfft(frame, n=n_fft)) ** 2, eps)
    c = sp2mc(spec, order, alpha)
    if refine:
        c = uels_refine(c, spec, alpha)
    return c


def stft_mcep(x: np.ndarray, fftl: int = 512, shiftl: int = 256,
              dim: int = 25, alpha: float = 0.41, window: str = "hamming",
              is_padding: bool = False) -> np.ndarray:
    """Framewise STFT mel-cepstrum (reference ``stft_mcep``,
    `feature_extract.py:116-148`): non-centered frames of length ``fftl``
    hopped by ``shiftl``, windowed, mcep per frame -> (n_frames, dim+1)."""
    import os

    from scipy.signal import get_window

    x = np.asarray(x, np.float64)
    if is_padding:
        n_pad = fftl - (len(x) - fftl) % shiftl
        x = np.pad(x, (0, n_pad), "reflect")
    if not os.environ.get("WNDSP_DISABLE_NATIVE"):
        from pytorchwavenetvocoder_tpu_torch import native

        if native.available():
            return native.stft_mcep(x, fftl, shiftl, dim, alpha, window)
    n_frame = (len(x) - fftl) // shiftl + 1
    win = get_window(window, fftl)
    out = np.empty((n_frame, dim + 1))
    for i in range(n_frame):
        out[i] = mcep(x[shiftl * i: shiftl * i + fftl] * win, dim, alpha)
    return out
