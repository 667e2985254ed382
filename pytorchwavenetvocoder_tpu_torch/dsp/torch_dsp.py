"""The feature transforms and the WORLD analyses on a torch device.

Counterpart of the JAX package's ``dsp/jax_dsp.py``: the same
transforms, step for step, as PyTorch ops on the tensors' own device
(``torch.fft``, ``torch.cummax``, ``torch.linalg.solve``), checked
against the JAX functions and the port's host DSP
(``tests/test_torch_device_dsp.py``).  No function here is a kernel
written by hand: none of the JAX ones reaches ``pl.pallas_call``.

Every function takes tensors and computes in their dtype on their
device.  The tests hold float64 to the JAX package's float64 and float32 to
its float32 (the dtype a TPU computes in); ``feature_extract --device``
runs float64 on the card too, where float32 misses the host path by more
than the features' float32 storage (PERF.md).  Constants
come from the port's host copies (``dsp/spectral.py``, ``dsp/cepstrum.py``,
``dsp/cheaptrick.py``, ``dsp/d4c.py``, ``dsp/harvest.py``).

Where the JAX module runs a sequential scan, this one does not:

- ``freqt`` is linear in the cepstrum, so its warping matrix is built
  once per (input length, order, alpha) by the host ``freqt_batch`` on
  the identity in float64 and applied as a product (``freqt_torch``);
- the compensated cumulative sum is a Hillis-Steele doubling over the
  (hi, lo) pair (``_dd_cumsum``).

The products (the warping matrix, the mel filter bank) run in full
float32 whatever the process's TF32 flags say (``full_f32_products``).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import freqt_batch
from pytorchwavenetvocoder_tpu_torch.dsp.spectral import mel_filterbank


@contextlib.contextmanager
def full_f32_products():
    """Float32 products in full float32 (no TF32, no bf16 passes) for the
    duration, whatever the process set; the setting is restored after."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """A host constant as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                           device=like.device)


def stft_torch(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
               center: bool = True) -> torch.Tensor:
    """Complex STFT of (T,) or (B, T) -> (..., n_frames, n_fft//2+1).

    Hann window, centered reflect padding (librosa conventions; matches
    dsp.spectral.stft)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if center:
        x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2),
                                    mode="reflect")
    frames = x.unfold(-1, n_fft, hop_length)           # (B, n_frames, n_fft)
    # scipy/librosa periodic Hann
    k = torch.arange(n_fft, dtype=x.dtype, device=x.device)
    win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * k / n_fft)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return spec[0] if squeeze else spec


def melspectrogram_torch(x: torch.Tensor, fs: int, n_fft: int = 1024,
                         hop_length: int = 256, n_mels: int = 80,
                         fmin: float = 0.0, fmax: float | None = None,
                         power: float = 1.0, log10: bool = False,
                         center: bool = True) -> torch.Tensor:
    """Mel spectrogram (..., n_frames, n_mels); parity with
    dsp.spectral.melspectrogram (+ optional log10(max(eps, .)))."""
    spec = torch.abs(stft_torch(x, n_fft=n_fft, hop_length=hop_length,
                                center=center)) ** power
    fb = _const(mel_filterbank(fs, n_fft, n_mels, fmin, fmax), spec)
    with full_f32_products():
        m = spec @ fb.T
    if log10:
        m = torch.log10(torch.clamp(m, min=1e-10))
    return m


@functools.lru_cache(maxsize=8)
def _warp_matrix_host(m1: int, order: int, alpha: float) -> np.ndarray:
    # freqt is linear in c: row i is the warp of the i-th unit cepstrum
    w = freqt_batch(np.eye(m1), order, alpha)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=16)
def _warp_matrix(m1: int, order: int, alpha: float, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(_warp_matrix_host(m1, order, alpha), dtype=dtype,
                        device=device)


def freqt_torch(c: torch.Tensor, order: int, alpha: float) -> torch.Tensor:
    """Batched frequency warping: (..., M1) -> (..., order+1).

    The Oppenheim recursion of dsp.cepstrum.freqt as one product with its
    warping matrix (built in float64 on the host, cached on the device)."""
    w = _warp_matrix(c.shape[-1], order, float(alpha), c.device, c.dtype)
    with full_f32_products():
        return c @ w


def _doubler(n_half1: int, like: torch.Tensor, inner: float) -> torch.Tensor:
    d = torch.full((n_half1,), inner, dtype=like.dtype, device=like.device)
    d[0] = d[-1] = 1.0
    return d


def sp2mc_torch(power_spec: torch.Tensor, order: int, alpha: float,
                n_fft: int | None = None, floor=1e-10) -> torch.Tensor:
    """Batched power spectrum -> mel-cepstrum (parity with
    dsp.cepstrum.sp2mc): (..., n_fft//2+1) -> (..., order+1).

    ``floor`` (scalar or broadcastable tensor) is the absolute power floor
    under the log; rescaled callers must rescale it with their input."""
    ps = power_spec
    n_half1 = ps.shape[-1]
    if n_fft is None:
        n_fft = (n_half1 - 1) * 2
    log_spec = 0.5 * torch.log(torch.maximum(ps, torch.as_tensor(
        floor, dtype=ps.dtype, device=ps.device)))
    cep = torch.fft.irfft(log_spec, n=n_fft, dim=-1)[..., :n_half1]
    return freqt_torch(cep * _doubler(n_half1, ps, 2.0), order, alpha)


def _mirror(c: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(..., M+1) one-sided coefficients -> (..., n_fft) symmetric seq."""
    m1 = c.shape[-1]
    out = c.new_zeros(c.shape[:-1] + (n_fft,))
    out[..., :m1] = c
    out[..., n_fft - m1 + 1:] = torch.flip(c[..., 1:], dims=(-1,))
    return out


def uels_refine_torch(c: torch.Tensor, power_spec: torch.Tensor,
                      alpha: float, order: int,
                      n_iter: int = 15) -> torch.Tensor:
    """Batched UELS Newton refinement (parity with
    dsp.cepstrum.uels_refine, fixed iteration count):
    c (..., order+1), power_spec (..., n_fft//2+1)."""
    ps = power_spec
    c = c.to(ps.dtype).clone()
    n_half1 = ps.shape[-1]
    n_fft = (n_half1 - 1) * 2

    # warped log spectrum: full freqt of the log-power cepstrum
    log_spec = 0.5 * torch.log(ps)
    cep = torch.fft.irfft(log_spec, n=n_fft, dim=-1)[..., :n_half1]
    cw = freqt_torch(cep * _doubler(n_half1, ps, 2.0), n_fft // 2, alpha)
    log_sw = 2.0 * torch.fft.rfft(
        _mirror(cw * _doubler(n_half1, ps, 0.5), n_fft), n=n_fft,
        dim=-1).real

    idx = torch.arange(1, order + 1, device=ps.device)
    habs = torch.abs(idx[:, None] - idx[None, :])
    hsum = idx[:, None] + idx[None, :]
    for _ in range(n_iter):
        halved = c.clone()
        halved[..., 1:] *= 0.5
        logh = torch.fft.rfft(_mirror(halved, n_fft), n=n_fft, dim=-1).real
        E = torch.exp(log_sw - 2.0 * logh)
        r = torch.fft.irfft(E, n=n_fft, dim=-1)[..., :2 * order + 1]
        c[..., 0] += 0.5 * torch.log(r[..., 0])
        r = r / r[..., :1]
        H = r[..., habs] + r[..., hsum]
        c[..., 1:] += torch.linalg.solve(H, r[..., 1:order + 1, None])[..., 0]
    return c


def stft_mcep_torch(x: torch.Tensor, fftl: int = 512, shiftl: int = 256,
                    dim: int = 25, alpha: float = 0.41,
                    refine: bool = True) -> torch.Tensor:
    """Framewise STFT mel-cepstrum (parity with dsp.cepstrum.stft_mcep):
    non-centered Hamming frames, UELS Newton refinement by default."""
    frames = x.unfold(-1, fftl, shiftl)                # (n_frame, fftl)
    # periodic Hamming (scipy get_window's fftbins=True default)
    k = torch.arange(fftl, dtype=x.dtype, device=x.device)
    win = 0.54 - 0.46 * torch.cos(2.0 * np.pi * k / fftl)
    spec = torch.clamp(torch.abs(torch.fft.rfft(frames * win, dim=-1)) ** 2,
                       min=1e-10)
    c = sp2mc_torch(spec, dim, alpha)
    if refine:
        c = uels_refine_torch(c, spec, alpha, dim)
    return c


def mlsa_filter_torch(x: torch.Tensor, coef: torch.Tensor, alpha: float,
                      n_fft: int = 8192, ir_length: int = 2048) -> torch.Tensor:
    """Time-invariant MLSA filtering on the device (parity with
    dsp.mlsa.mlsa_filter): minimum-phase IR + FFT convolution."""
    # b2mc: mc[m] = b[m] + alpha b[m+1]
    mc = coef.clone()
    mc[:-1] += alpha * coef[1:]
    c = freqt_torch(mc, n_fft // 2, -alpha)
    buf = c.new_zeros(n_fft)
    buf[:c.shape[0]] = c
    h = torch.fft.ifft(torch.exp(torch.fft.fft(buf))).real[:ir_length]
    n_conv = int(2 ** np.ceil(np.log2(x.shape[-1] + ir_length)))
    y = torch.fft.irfft(torch.fft.rfft(x, n=n_conv)
                        * torch.fft.rfft(h, n=n_conv), n=n_conv)
    return y[:x.shape[-1]]


# ---------------------------------------------------------------------------
# WORLD analyses on the device (parity with dsp/cheaptrick.py and dsp/d4c.py)
# ---------------------------------------------------------------------------

def _two_sum(ah, al, bh, bl):
    """The compensated sum of two (hi, lo) pairs (JAX ``_dd_cumsum``'s
    operator): Knuth's TwoSum of the hi parts, the lo parts and the error
    added, renormalised."""
    s = ah + bh
    t = s - ah
    e = (ah - (s - t)) + (bh - t)
    lo = e + al + bl
    hi = s + lo
    return hi, lo - (hi - s)


def _dd_cumsum(x: torch.Tensor):
    """Compensated (two-float) inclusive cumulative sum along axis 1.

    The smoothing integral differences two nearly-equal cumulative
    totals; a plain float32 cumsum drops every increment smaller than
    ~total*2^-24, which destroys the low-power bins of a high-dynamic-range
    spectrum.  The running total is carried as an unevaluated (hi, lo)
    pair.  Hillis-Steele doubling: log2(n) steps, each combining every
    element with the one ``shift`` before it.  The operator is not exactly
    associative in floating point, so the pairs differ from JAX's
    ``associative_scan`` (another tree) by their rounding; hi + lo agree
    to ~2^-44 of the running total in float32."""
    hi, lo = x.clone(), torch.zeros_like(x)
    n, shift = x.shape[1], 1
    while shift < n:
        nh, nl = _two_sum(hi[:, :-shift], lo[:, :-shift],
                          hi[:, shift:], lo[:, shift:])
        hi[:, shift:] = nh
        lo[:, shift:] = nl
        shift *= 2
    return hi, lo


def _linear_smoothing_torch(spec: torch.Tensor, f0: torch.Tensor, fs: int,
                            fftl: int, floor=1e-10) -> torch.Tensor:
    """Fractional-width (2/3 f0) rectangular smoothing on the continuous
    frequency axis; parity with dsp.cheaptrick._linear_smoothing.

    ``floor`` (scalar or per-frame (T, 1)) is the positivity floor on the
    smoothed value: callers that rescale their input rescale the floor
    with it."""
    n_half1 = fftl // 2 + 1
    df = fs / fftl
    # full reflection about DC and about Nyquist (see the numpy impl)
    ext = torch.cat([torch.flip(spec[:, 1:], dims=(1,)), spec,
                     torch.flip(spec[:, :-1], dims=(1,))], dim=1)
    n_ext = ext.shape[1]
    orig0 = n_half1 - 1
    ch, cl = _dd_cumsum(0.5 * (ext[:, 1:] + ext[:, :-1]) * df)
    zero = spec.new_zeros((spec.shape[0], 1))
    cum_hi = torch.cat([zero, ch], dim=1)
    cum_lo = torch.cat([zero, cl], dim=1)

    def integral_at(freq_pos):
        pos = torch.clamp(freq_pos / df + orig0, 0, n_ext - 1.001)
        lo = torch.floor(pos).long()
        frac = pos - lo.to(pos.dtype)
        a = torch.gather(ext, 1, lo)
        b = torch.gather(ext, 1, torch.clamp(lo + 1, max=n_ext - 1))
        part = df * frac * (a + 0.5 * frac * (b - a))
        return torch.gather(cum_hi, 1, lo), torch.gather(cum_lo, 1, lo) + part

    width = (2.0 / 3.0) * f0[:, None]
    freqs = (torch.arange(n_half1, dtype=spec.dtype, device=spec.device)
             * df)[None, :]
    up_hi, up_lo = integral_at(freqs + width / 2.0)
    lo_hi, lo_lo = integral_at(freqs - width / 2.0)
    # difference hi parts first (the cancellation), then add the small
    # residuals: this is where the compensation pays off
    integral = (up_hi - lo_hi) + (up_lo - lo_lo)
    return torch.maximum(integral / width, torch.as_tensor(
        floor, dtype=spec.dtype, device=spec.device))


def cheaptrick_torch(frames: torch.Tensor, f0: torch.Tensor, fs: int,
                     fftl: int, power_floor=None) -> torch.Tensor:
    """CheapTrick spectral envelopes (T, fftl//2+1) on the device.

    ``power_floor`` (scalar or per-frame (T, 1), default the numpy spec's
    EPS=1e-10) is the absolute power-domain floor: a caller that rescales
    the frames by k passes EPS*k^2 to keep the floor at the same physical
    level.  Step-for-step parity with dsp.cheaptrick.cheaptrick: F0-adaptive
    3-period Hanning window with DC-bias removal, DC correction below f0,
    fractional 2/3*f0 smoothing, and the sinc + q1 = -0.15 liftering with
    recovery."""
    from pytorchwavenetvocoder_tpu_torch.dsp.cheaptrick import (
        DEFAULT_F0,
        EPS,
        Q1,
    )

    if power_floor is None:
        power_floor = EPS
    dt, dev = frames.dtype, frames.device
    f0 = f0.to(dt)
    f0_floor = 3.0 * fs / fftl
    f0 = torch.clamp(torch.where(f0 > 0, f0, torch.full_like(f0, DEFAULT_F0)),
                     f0_floor, fs / 8.0)
    n_half1 = fftl // 2 + 1

    # F0-adaptive window, unit power, weighted-mean (DC bias) removal
    half = torch.clamp(torch.round(1.5 * fs / f0), max=fftl // 2 - 1)
    idx = (torch.arange(fftl, device=dev) - fftl // 2)[None, :].to(dt)
    in_win = torch.abs(idx) <= half[:, None]
    win = torch.where(in_win,
                      0.5 + 0.5 * torch.cos(np.pi * idx / (half[:, None] + 1.0)),
                      torch.zeros((), dtype=dt, device=dev))
    win = win / (torch.sqrt(torch.sum(win ** 2, dim=1, keepdim=True)) + 1e-12)
    wsum = torch.sum(win, dim=1, keepdim=True)
    bias = torch.sum(win * frames, dim=1, keepdim=True) / torch.clamp(
        wsum, min=1e-12)
    xw = (frames - bias) * win
    spec = torch.abs(torch.fft.rfft(xw, n=fftl, dim=1)) ** 2

    # DC correction: add the mirror of the band above f0 below it
    freqs = torch.arange(n_half1, dtype=dt, device=dev) * (fs / fftl)
    mirror_freq = 2.0 * f0[:, None] - freqs[None, :]
    pos = torch.clamp(mirror_freq / (fs / fftl), 0, n_half1 - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=n_half1 - 1)
    frac = pos - lo.to(dt)
    mirrored = (torch.gather(spec, 1, lo) * (1 - frac)
                + torch.gather(spec, 1, hi) * frac)
    below = freqs[None, :] < f0[:, None]
    spec = spec + torch.where(below, mirrored, torch.zeros_like(mirrored))

    spec = _linear_smoothing_torch(spec, f0, fs, fftl,
                                   floor=power_floor) + power_floor

    # liftering with recovery
    cep = torch.fft.irfft(torch.log(spec), n=fftl, dim=1)
    q = torch.arange(fftl, dtype=dt, device=dev) * (1.0 / fs)
    q = torch.minimum(q, fftl / fs - q)
    arg = np.pi * f0[:, None] * q[None, :]
    safe = torch.clamp(arg, min=1e-9)
    sinc = torch.where(arg > 1e-9, torch.sin(safe) / safe,
                       torch.ones((), dtype=dt, device=dev))
    comp = (1.0 - 2.0 * Q1) + 2.0 * Q1 * torch.cos(2.0 * arg)
    return torch.exp(torch.fft.rfft(cep * sinc * comp, dim=1).real)


def d4c_torch(frames: torch.Tensor, f0: torch.Tensor, fs: int,
              fftl: int) -> torch.Tensor:
    """D4C coarse band aperiodicity (T, n_bands) in dB on the device.

    Parity with dsp.d4c.d4c; unvoiced frames (f0 <= 0) are fully aperiodic
    (0 dB).  All frames are computed and the unvoiced rows masked after."""
    from pytorchwavenetvocoder_tpu_torch.dsp.d4c import (
        EPS,
        FLOOR_DB,
        n_codeap_bands,
    )
    from pytorchwavenetvocoder_tpu_torch.dsp.harvest import _nuttall

    dt, dev = frames.dtype, frames.device
    f0 = f0.to(dt)
    voiced = f0 > 0
    n_bands = n_codeap_bands(fs)
    f0_floor = 4.0 * fs / fftl
    f0v = torch.clamp(torch.where(voiced, f0, torch.full_like(f0, f0_floor)),
                      f0_floor, fs / 8.0)

    # static group delay (steps 1-2)
    half = torch.clamp(torch.round(2.0 * fs / f0v), max=fftl // 2 - 1)
    idx = (torch.arange(fftl, device=dev) - fftl // 2)[None, :].to(dt)
    in_win = torch.abs(idx) <= half[:, None]
    ph = np.pi * idx / (half[:, None] + 1.0)
    win = torch.where(in_win, 0.42 + 0.5 * torch.cos(ph)
                      + 0.08 * torch.cos(2 * ph),
                      torch.zeros((), dtype=dt, device=dev))
    xw = frames * win
    t_rel = idx / fs
    X = torch.fft.rfft(xw, dim=1)
    Xt = torch.fft.rfft(xw * t_rel, dim=1)
    power = torch.abs(X) ** 2
    num = (Xt * torch.conj(X)).real
    # per-frame power normalization: sgd = num/power is scale-invariant,
    # and O(1) inputs keep the float32 smoothing well-conditioned at any
    # waveform scale (int16-range or unit-range)
    k = 1.0 / torch.clamp(torch.amax(power, dim=1, keepdim=True), min=1e-30)
    power = power * k
    num = num * k

    def smooth(signal, width_hz):
        # floorless on the raw signal: the numpy spec's min-offset exists
        # only to dodge its smoothing's positivity floor, and running
        # floorless is analytically identical (smoothing preserves
        # constants, the band never reaches the clip edges) and far better
        # in float32, where re-adding a large offset cancels the small
        # null-bin values away
        return _linear_smoothing_torch(signal, width_hz * 1.5, fs, fftl,
                                       floor=-np.inf)

    num_s = smooth(num, f0v / 2.0)
    pow_s = smooth(power, f0v / 2.0)
    floor = torch.clamp(torch.amax(pow_s, dim=1, keepdim=True) * 1e-8,
                        min=EPS)
    sgd = num_s / torch.maximum(pow_s, floor) + 0.125 / f0v[:, None]

    df = fs / fftl
    n_half1 = fftl // 2 + 1
    half_bins = int(round(3000.0 / df))
    L = 2 * half_bins + 1
    nuttall = _const(_nuttall(L), frames)
    n_seg_fft = 1
    while n_seg_fft < L:
        n_seg_fft *= 2
    n_static = max(1, int(round(8.0 * n_seg_fft / L / 2.0)))

    cols = []
    for b in range(n_bands):
        center = int(round(3000.0 * (b + 1) / df))
        lo_b = center - half_bins
        hi_b = center + half_bins + 1
        lo_c, hi_c = max(lo_b, 0), min(hi_b, n_half1)
        seg = sgd.new_zeros((sgd.shape[0], L))
        seg[:, lo_c - lo_b: hi_c - lo_b] = sgd[:, lo_c:hi_c]
        P = torch.abs(torch.fft.rfft(seg * nuttall, n=n_seg_fft, dim=1)) ** 2
        P[:, 1:-1] *= 2.0
        # ascending sort + direct tail sum: algebraically the numpy spec's
        # 1 - static/total, free of the cancellation a small float32
        # aperiodic ratio suffers in the subtraction
        P_asc = torch.sort(P, dim=1).values
        tail = torch.sum(P_asc[:, :P.shape[1] - n_static], dim=1)
        total = torch.sum(P_asc, dim=1) + EPS
        ratio = torch.clamp((tail + EPS) / total, min=10.0 ** (FLOOR_DB / 10.0))
        cols.append(10.0 * torch.log10(ratio))
    out = torch.stack(cols, dim=1)
    out = torch.where(voiced[:, None], out, torch.zeros_like(out))
    return torch.clamp(out, FLOOR_DB, 0.0)


def _world_frames_torch(frames: torch.Tensor, cont_f0: torch.Tensor,
                        f0_raw: torch.Tensor, fs: int, fftl: int,
                        mcep_dim: int, mcep_alpha: float):
    """Device part of the WORLD analysis: (mcep, codeap) from frames.

    Frames are normalized to unit peak per frame before the spectral
    analyses, so the float32 arithmetic is well-conditioned at any waveform
    scale (the host pipeline feeds int16-range floats).  The envelope then
    scales by k^2, which shifts only the 0th mel-cepstral coefficient by
    log k (freqt is linear and maps a c0 delta to c0), so the exact
    compensation is mc0 -= log k; D4C is a power ratio and needs none."""
    peak = torch.clamp(torch.amax(torch.abs(frames), dim=1, keepdim=True),
                       min=1e-6)
    fn = frames / peak
    # the numpy pipeline's absolute 1e-10 power floors, rescaled to the
    # normalized frame scale so they bite at the same physical level
    floor_n = 1e-10 / (peak * peak)
    env = cheaptrick_torch(fn, cont_f0, fs, fftl, power_floor=floor_n)
    mcep = sp2mc_torch(torch.maximum(env, floor_n), mcep_dim, mcep_alpha,
                       floor=floor_n)
    mcep[:, 0] += torch.log(peak[:, 0])
    codeap = d4c_torch(fn, f0_raw, fs, fftl)
    return mcep, codeap


def world_analyze_torch(x: np.ndarray, fs: int, shiftms: float = 5.0,
                        minf0: float = 40.0, maxf0: float = 400.0,
                        fftl: int = 1024, mcep_dim: int = 24,
                        mcep_alpha: float = 0.41, frame_bucket: int = 256,
                        device="cuda", dtype=torch.float64) -> np.ndarray:
    """WORLD feature matrix with the spectral analyses on the device.

    Same output contract as ``dsp.world.world_analyze`` (columns [uv,
    cont_f0_lpf, mcep..., codeap...]); a thin wrapper over
    ``world_analyze_torch_many`` with ``frame_bucket`` as the device
    batch."""
    return world_analyze_torch_many(
        [x], fs, shiftms=shiftms, minf0=minf0, maxf0=maxf0, fftl=fftl,
        mcep_dim=mcep_dim, mcep_alpha=mcep_alpha, device_batch=frame_bucket,
        device=device, dtype=dtype)[0]


def world_analyze_torch_many(xs: list, fs: int, shiftms: float = 5.0,
                             minf0: float = 40.0, maxf0: float = 400.0,
                             fftl: int = 1024, mcep_dim: int = 24,
                             mcep_alpha: float = 0.41,
                             device_batch: int = 4096,
                             f0_device: str = "host", device="cuda",
                             dtype=torch.float64) -> list:
    """WORLD analysis of MANY waveforms with cross-utterance batching.

    CheapTrick and D4C are per frame, so the frames of all utterances are
    concatenated and processed in ``(device_batch, fftl)`` slices on
    ``device`` in ``dtype`` (float64 by default: in float32, the JAX
    package's dtype, with its conditioning fixes, the recipes' analyses
    miss the host's contract of 4e-4 on Klatt speech at 22,050 Hz, PERF.md).
    Harvest F0
    runs per utterance on the host by default; ``f0_device="torch"`` runs
    its heavy stages on ``device`` too (``dsp.harvest_torch``, float32).
    The rows that pad the last slice are unvoiced and their continuous F0
    repeats the last frame's.  Returns one feature matrix per input,
    [uv, cont_f0_lpf, mcep, codeap]."""
    import logging
    import time

    from pytorchwavenetvocoder_tpu_torch.dsp.f0 import (
        convert_to_continuous_f0,
        extract_f0,
    )
    from pytorchwavenetvocoder_tpu_torch.dsp.filters import low_pass_filter
    from pytorchwavenetvocoder_tpu_torch.dsp.world import _centered_frames

    device = torch.device(device)
    hop = int(fs * shiftms / 1000.0)
    frame_rate = int(1.0 / (shiftms * 0.001))
    t0 = time.perf_counter()
    if f0_device == "torch":
        from pytorchwavenetvocoder_tpu_torch.dsp.harvest_torch import (
            harvest_torch_many,
        )

        f0s_pre = harvest_torch_many(
            [np.asarray(x, np.float64) for x in xs], fs, f0_floor=minf0,
            f0_ceil=maxf0, shiftms=shiftms, device=device)
    elif f0_device == "host":
        f0s_pre = None
    else:
        raise ValueError(
            f"f0_device must be 'host' or 'torch', got {f0_device!r}")
    per_utt = []
    for i, x in enumerate(xs):
        x = np.asarray(x, np.float64)
        n_frames = len(x) // hop + 1
        f0 = (f0s_pre[i] if f0s_pre is not None
              else extract_f0(x, fs, minf0=minf0, maxf0=maxf0,
                              shiftms=shiftms))
        f0 = f0[:n_frames]
        if len(f0) < n_frames:
            f0 = np.pad(f0, (0, n_frames - len(f0)))
        uv, cont_f0 = convert_to_continuous_f0(f0)
        per_utt.append({
            "n": n_frames, "uv": uv,
            "lpf": low_pass_filter(cont_f0, frame_rate, cutoff=20),
            "frames": _centered_frames(x, fftl, hop, n_frames),
            "cont": cont_f0, "f0": f0,
        })

    frames = np.concatenate([u["frames"] for u in per_utt])
    cont = np.concatenate([u["cont"] for u in per_utt])
    f0_raw = np.concatenate([u["f0"] for u in per_utt])
    total = len(frames)
    pad = -total % device_batch
    frames = np.pad(frames, ((0, pad), (0, 0)))
    cont = np.pad(cont, (0, pad), mode="edge")
    f0_raw = np.pad(f0_raw, (0, pad))  # padded rows unvoiced
    logging.debug("world_many: host prep of %d utts (%d frames): %.2f s",
                  len(xs), total, time.perf_counter() - t0)

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    mceps, codeaps = [], []
    for s in range(0, total + pad, device_batch):
        t0 = time.perf_counter()
        sl = slice(s, s + device_batch)
        m, c = _world_frames_torch(put(frames[sl]), put(cont[sl]),
                                   put(f0_raw[sl]), fs, fftl, mcep_dim,
                                   mcep_alpha)
        mceps.append(m.double().cpu().numpy())
        codeaps.append(c.double().cpu().numpy())
        logging.debug("world_many: device slice %d: %.2f s",
                      s // device_batch, time.perf_counter() - t0)
    mcep = np.concatenate(mceps)[:total]
    codeap = np.concatenate(codeaps)[:total]

    out, off = [], 0
    for u in per_utt:
        n = u["n"]
        out.append(np.concatenate(
            [u["uv"][:, None].astype(np.float64), u["lpf"][:, None],
             mcep[off:off + n], codeap[off:off + n]], axis=1))
        off += n
    return out
