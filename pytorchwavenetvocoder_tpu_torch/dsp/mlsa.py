"""MLSA noise-shaping filter.

Replaces ``pysptk.synthesis.Synthesizer(MLSADF(order, alpha), hopsize)``
(`noise_shaping.py:57-64`).  The reference only ever uses a
**time-invariant** filter (the averaged mel-cepstrum tiled over all
frames, `noise_shaping.py:80-85`), so instead of the per-sample MLSA
lattice (a Pade *approximation* of exp(F(z))), the filter is realized
exactly: the minimum-phase transfer function H(z) = exp(sum b_m Φ_m(z))
is evaluated on the FFT grid from the unwarped cepstrum and applied by
FFT convolution.  This is both closer to the mathematical target than
MLSA's Pade ladder and orders of magnitude faster on wide signals.

Consequence: the inverse filter (coef * -1, `noise_shaping.py:54-55`) is
the exact reciprocal, so noise weighting followed by restoration is an
identity up to IR truncation — a property the reference pair only holds
approximately.

A time-varying per-frame variant (the full pysptk Synthesizer surface)
is provided via per-hop IR convolution with overlap-add tails.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve

from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import b2mc, freqt


def mlsa_impulse_response(coef: np.ndarray, alpha: float,
                          n_fft: int = 8192, ir_length: int = 2048) -> np.ndarray:
    """Causal minimum-phase impulse response of exp(sum b_m Φ_m(z)).

    coef are MLSA filter coefficients (mc2b output).  The warped cepstrum
    is unwarped with freqt(-alpha); exp of its causal DFT gives the
    minimum-phase spectrum; the IFFT is the IR, truncated to ``ir_length``.
    """
    mc = b2mc(np.asarray(coef, np.float64), alpha)
    c = freqt(mc, n_fft // 2, -alpha)
    buf = np.zeros(n_fft)
    buf[: len(c)] = c
    H = np.exp(np.fft.fft(buf))
    h = np.fft.ifft(H).real
    return h[:ir_length]


def mlsa_filter(x: np.ndarray, coef: np.ndarray, alpha: float,
                n_fft: int = 8192, ir_length: int = 2048) -> np.ndarray:
    """Filter ``x`` with the time-invariant MLSA filter of ``coef``.

    Same-length output (causal filtering), matching the synthesizer's
    behavior on tiled coefficients.  Dispatches to the native C++ path
    (native/wndsp.cc, ~20x faster) when the library is built; set
    WNDSP_DISABLE_NATIVE=1 to force the numpy implementation.
    """
    import os

    if not os.environ.get("WNDSP_DISABLE_NATIVE"):
        from pytorchwavenetvocoder_tpu_torch import native

        if native.available():
            return native.mlsa_filter(np.asarray(x, np.float64), coef, alpha,
                                      n_fft=n_fft, ir_length=ir_length)
    h = mlsa_impulse_response(coef, alpha, n_fft=n_fft, ir_length=ir_length)
    return fftconvolve(np.asarray(x, np.float64), h)[: len(x)]


def mlsa_filter_tv(x: np.ndarray, coefs: np.ndarray, alpha: float,
                   hopsize: int, n_fft: int = 4096,
                   ir_length: int = 1024) -> np.ndarray:
    """Time-varying variant: per-frame coefficients (n_frames, M+1),
    each hop-block filtered with its frame's IR, tails overlap-added."""
    x = np.asarray(x, np.float64)
    out = np.zeros(len(x) + ir_length)
    for t in range(coefs.shape[0]):
        start = t * hopsize
        if start >= len(x):
            break
        block = x[start: start + hopsize]
        h = mlsa_impulse_response(coefs[t], alpha, n_fft=n_fft,
                                  ir_length=ir_length)
        y = fftconvolve(block, h)
        out[start: start + len(y)] += y
    return out[: len(x)]
