"""Mel-cepstral distortion (MCD) — the framework's fidelity metric.

BASELINE.md's north star requires "waveform MCD parity vs reference
checkpoints"; this module provides the measurement: framewise
mel-cepstra of both signals (excluding the gain term c0) compared with
the standard 10*sqrt(2)/ln(10) scaling.

Alignment: AR vocoders drift in time relative to the reference (the
one-sample seed offset, MLSA group delay, and any frame-rate rounding
all shift frames), so a fixed offset is not enough for a parity
instrument.  Default alignment is frame-level DTW (band-constrained,
symmetric step pattern) over the c0-free mel-cepstra; the per-path-cell
mean is the standard speech-synthesis MCD.  ``align="offset"`` keeps the
cheaper ±frame-offset search for smoke use.

Silence gating (``power_threshold_db``) is applied AFTER alignment:
path cells (or offset-aligned pairs) where both frames sit more than
that many dB below their own signal's loudest frame are excluded from
the average.  Gating each signal against its OWN peak keeps an overall
gain offset from gating the two sides asymmetrically, and gating after
alignment keeps the sequences temporally intact for DTW.
"""

from __future__ import annotations

import numpy as np

from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import stft_mcep

MCD_CONST = 10.0 * np.sqrt(2.0) / np.log(10.0)


def _dtw_path(a: np.ndarray, b: np.ndarray, band: int):
    """Best-path DTW over Euclidean frame distance.

    Symmetric steps (diag/up/left), Sakoe-Chiba band of ``band`` frames
    around the diagonal.  Returns (path_i, path_j, local_costs) arrays
    along the best path.

    Dispatches to the C++ ``wndsp_dtw_band`` when the native library is
    built (bit-identical path, ~16-100x faster — full 104-utterance eval
    sets in seconds); ``_dtw_path_numpy`` is the executable spec and
    tests assert the two paths are equal.  Set ``WNDSP_DISABLE_NATIVE=1``
    to force the numpy implementation (same switch as the other native
    dispatches).
    """
    import os

    if not os.environ.get("WNDSP_DISABLE_NATIVE"):
        from pytorchwavenetvocoder_tpu_torch import native

        if native.dtw_available():
            return native.dtw_band(a, b, band)
    return _dtw_path_numpy(a, b, band)


def _dtw_path_numpy(a: np.ndarray, b: np.ndarray, band: int):
    Ta, Tb = a.shape[0], b.shape[0]
    band = max(band, abs(Ta - Tb) + 1)
    INF = np.inf
    acc = np.full((Ta, Tb), INF)
    dist = np.full((Ta, Tb), INF)
    back = np.zeros((Ta, Tb), np.int8)  # 0=diag 1=up(i-1,j) 2=left(i,j-1)
    dim = a.shape[1]
    for i in range(Ta):
        lo = max(0, i * Tb // Ta - band)
        hi = min(Tb, i * Tb // Ta + band + 1)
        # strict left-to-right accumulation over dims: np.sum's pairwise
        # reduction rounds differently from the native kernel's
        # sequential loop (~1 ulp), which could flip a near-tie
        # tie-break and break the bit-identical-path contract with
        # wndsp_dtw_band; summing column-by-column pins both
        # implementations to the same order
        sq = (b[lo:hi] - a[i]) ** 2
        acc_d = np.zeros(hi - lo)
        for c in range(dim):
            acc_d += sq[:, c]
        d = np.sqrt(acc_d)
        dist[i, lo:hi] = d
        if i == 0:
            acc[0, lo:hi] = np.cumsum(d)
            back[0, lo:hi] = 2
            back[0, 0] = -1
            continue
        for j, dj in zip(range(lo, hi), d):
            best, step = INF, 0
            if acc[i - 1, j] < best:
                best, step = acc[i - 1, j], 1
            if j > 0:
                if acc[i - 1, j - 1] <= best:
                    best, step = acc[i - 1, j - 1], 0
                if acc[i, j - 1] < best:
                    best, step = acc[i, j - 1], 2
            if best < INF:
                acc[i, j] = best + dj
                back[i, j] = step
    if not np.isfinite(acc[-1, -1]):
        raise ValueError("DTW band too narrow for these lengths")
    pi, pj = [], []
    i, j = Ta - 1, Tb - 1
    while True:
        pi.append(i)
        pj.append(j)
        if i == 0 and j == 0:
            break
        s = back[i, j]
        if s == 0:
            i, j = i - 1, j - 1
        elif s == 1:
            i -= 1
        else:
            j -= 1
    pi = np.asarray(pi[::-1])
    pj = np.asarray(pj[::-1])
    return pi, pj, dist[pi, pj]


def compute_mcd(x_ref: np.ndarray, x_gen: np.ndarray, fs: int,
                mcep_dim: int = 24, mcep_alpha: float = 0.41,
                fftl: int = 512, shift_search: int = 2,
                align: str = "dtw", dtw_band: int = 16,
                power_threshold_db: float | None = None) -> float:
    """MCD in dB between two waveforms (lower is better; ~0 = identical).

    Frames both signals (hop = fftl//2), drops c0 (gain).  With
    ``align="dtw"`` (default) frames are DTW-aligned within a
    ±``dtw_band``-frame band; ``align="offset"`` takes the best constant
    offset in ±``shift_search`` frames.  ``power_threshold_db`` (e.g.
    -40) drops aligned pairs where both frames are more than that many
    dB below their own signal's loudest frame (applied after alignment;
    see module docstring).
    """
    if align not in ("dtw", "offset"):
        raise ValueError(f"align must be 'dtw' or 'offset', got {align!r}")
    shiftl = fftl // 2
    n = min(len(x_ref), len(x_gen))
    if n < fftl * 2:
        raise ValueError("signals too short for MCD")
    x_ref = np.asarray(x_ref, np.float64)[:n]
    x_gen = np.asarray(x_gen, np.float64)[:n]

    mc_ref = stft_mcep(x_ref, fftl, shiftl, mcep_dim, mcep_alpha)
    mc_gen = stft_mcep(x_gen, fftl, shiftl, mcep_dim, mcep_alpha)

    if power_threshold_db is not None:
        ln = np.log(10.0) / 20.0  # c0 is log-gain (natural log)
        thr_ref = mc_ref[:, 0].max() + power_threshold_db * ln
        thr_gen = mc_gen[:, 0].max() + power_threshold_db * ln

    def keep_mask(i_ref, j_gen):
        if power_threshold_db is None:
            return np.ones(len(i_ref), bool)
        ok_ref = mc_ref[i_ref, 0] >= thr_ref
        ok_gen = mc_gen[j_gen, 0] >= thr_gen
        keep = ok_ref | ok_gen  # drop only both-silent pairs
        return keep if keep.any() else np.ones(len(i_ref), bool)

    a = mc_ref[:, 1:]
    b = mc_gen[:, 1:]

    if align == "dtw":
        pi, pj, costs = _dtw_path(a, b, dtw_band)
        keep = keep_mask(pi, pj)
        return float(MCD_CONST * np.mean(costs[keep]))

    best = np.inf
    for off in range(-shift_search, shift_search + 1):
        if off >= 0:
            ia = np.arange(off, a.shape[0])
            jb = np.arange(0, b.shape[0] - off)
        else:
            ia = np.arange(0, a.shape[0] + off)
            jb = np.arange(-off, b.shape[0])
        m = min(len(ia), len(jb))
        if m == 0:
            continue
        ia, jb = ia[:m], jb[:m]
        keep = keep_mask(ia, jb)
        d = np.sqrt(np.sum((a[ia[keep]] - b[jb[keep]]) ** 2, axis=1))
        best = min(best, float(np.mean(MCD_CONST * d)))
    return best


def mcd_from_wavs(ref_path: str, gen_path: str, mcep_dim: int = 24,
                  mcep_alpha: float = 0.41, **kwargs) -> float:
    """MCD between two wav files (must share a sampling rate)."""
    from pytorchwavenetvocoder_tpu_torch.utils import read_wav

    x_ref, fs1 = read_wav(ref_path, dtype="float64")
    x_gen, fs2 = read_wav(gen_path, dtype="float64")
    assert fs1 == fs2, "sampling rates differ"
    return compute_mcd(x_ref, x_gen, fs1, mcep_dim, mcep_alpha, **kwargs)
