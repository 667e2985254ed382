"""Harvest F0 estimation with the heavy stages on a torch device.

Counterpart of the JAX package's ``dsp/harvest_jax.py``: the same
reformulation of the host ``dsp/harvest.py``'s two compute-heavy stages,
as PyTorch ops batched over utterances and rows:

- **candidate generation**: the Nuttall band-pass bank by batched
  rfft/irfft; the negative-going-crossing / peak / dip event trains are
  never compacted: a prefix cummax / suffix cummin over the masked event
  COLUMNS (exact integers, the sub-sample fraction gathered per column)
  hands every analysis frame its four neighbouring events, and the
  interval-frequency interpolation is evaluated closed-form in
  frame-relative coordinates (``_event_tracks``, one batched function over
  all rows); the per-frame candidate pool is the K smallest deviations;
- **instantaneous-frequency refinement**: each live (frame, candidate)
  row evaluates the spectral-reassignment formula at its <= 6 harmonic
  bins by direct DTFT on the row's own spectral grid (n_fft = next power
  of two covering the row's window), in chunks of ``_REFINE_CHUNK`` rows.

The sequential tail (contour fixing and smoothing, O(T) host work) is the
host implementation itself.  In float32 (the default, the JAX module's
dtype) the numbers differ from the host path through float32 arithmetic and
the bucket-padded filter-bank FFT sizes (``_BUCKETS``), as the JAX module's
do; in float64 only where the host's complex64 filter bank rounds an event
time across an integer window or bin.  ``tests/test_torch_harvest_device.py``
holds this module to ``harvest_jax`` and to the host ``harvest``.
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.dsp.harvest import (
    _BASIC_PERIOD_MS,
    _CHANNELS_PER_OCTAVE,
    _MAX_CANDIDATES,
    _decimate,
    _fix_contour,
    _nuttall,
    _smooth_contour,
)
from pytorchwavenetvocoder_tpu_torch.dsp.torch_dsp import full_f32_products

# utterance micro-batch per device call, capped by 2^20 // bucket so the
# (4C, bucket) event matrices stay bounded in device memory
_U_BATCH = 8
# sample-length buckets at the 8 kHz analysis rate (1 s .. 32 s); the
# bucket sets the filter-bank FFT size, so it sets the numbers
_BUCKETS = (8192, 16384, 32768, 65536, 131072, 262144)
# refinement rows per chunk (bounds the (rows, 6, W) DTFT phase tables to
# ~100 MB)
_REFINE_CHUNK = 4096
# sentinels for "no event" in the column scans: far outside any bucket's
# column range, with headroom so +-1 shifts cannot wrap an int32
_NO_EVT_LO = -(1 << 30)
_NO_EVT_HI = 1 << 30


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


# LRU-capped like the host's _H_CACHE: one 32-s-bucket bank is ~170 MB on
# the device, and a long-lived process varying (f0_floor, f0_ceil) per
# speaker must not accumulate one forever
_BANK_CACHE: OrderedDict = OrderedDict()
_BANK_CACHE_MAX = 3


def _bank_constants(n_b: int, fs8: float, f0_floor: float, f0_ceil: float,
                    device, dtype=torch.float32):
    """(H, halves, boundary, n_fft) of one bucket on ``device``, LRU-cached.

    The host ``_band_pass_bank``'s construction (a Nuttall window of 4
    boundary periods modulated to the boundary frequency), evaluated once
    in float64 and put on the device as complex (of ``dtype``), int64 and
    ``dtype`` tensors."""
    device = torch.device(device)
    key = (n_b, float(fs8), float(f0_floor), float(f0_ceil), str(device),
           dtype)
    hit = _BANK_CACHE.get(key)
    if hit is not None:
        _BANK_CACHE.move_to_end(key)
        return hit
    n_ch = int(np.ceil(
        np.log2(f0_ceil / f0_floor) * _CHANNELS_PER_OCTAVE)) + 1
    boundary = f0_floor * 2.0 ** (np.arange(n_ch) / _CHANNELS_PER_OCTAVE)
    halves = np.round(fs8 / boundary * 2.0).astype(np.int64)
    n_fft = _next_pow2(n_b + 4 * int(halves.max()) + 2)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    H = torch.empty((n_ch, n_fft // 2 + 1), dtype=cdt, device=device)
    for i, bf in enumerate(boundary):
        half = int(halves[i])
        m = np.arange(-half, half + 1)
        w = _nuttall(2 * half + 1) * np.cos(2 * np.pi * bf * m / fs8)
        H[i] = torch.as_tensor(np.fft.rfft(w, n=n_fft), dtype=cdt)
    out = (H, torch.as_tensor(halves, device=device),
           torch.as_tensor(boundary, dtype=dtype, device=device), n_fft)
    _BANK_CACHE[key] = out
    if len(_BANK_CACHE) > _BANK_CACHE_MAX:
        _BANK_CACHE.popitem(last=False)
    return out


def _event_tracks(sig: torch.Tensor, col_cap: torch.Tensor,
                  t: torch.Tensor):
    """Signal rows (R, n) -> (interval-frequency tracks, validity), both
    (R, T) on the frame times ``t`` (T,) in samples.

    The host ``_events_intervals`` + ``np.interp`` step: events are
    negative-going zero crossings with linearly interpolated positions;
    track = 1/interval (cycles per sample) interpolated at interval
    midpoints; frames outside the midpoint span, and rows with < 3 events,
    are invalid.  ``col_cap`` (R,) bounds each row's crossing-pair columns
    to its true signal extent (the padded bucket tail and the filter
    ringing past the utterance end must produce no event the exact-length
    host path never sees).

    A prefix cummax / suffix cummin over the masked event columns gives
    every frame its neighbouring events.  A column holds at most one event,
    with position in (col, col+1], so event positions strictly increase
    and the interpolation needs only the two adjacent intervals,
    ``e_m1 <= e0 <= t < e1 <= e2``.  The scans carry exact integer columns;
    every position enters the arithmetic relative to the frame time t, so
    the interval error stays at the rounding of the interval itself
    whatever the signal's length."""
    R, n = sig.shape
    dev = sig.device
    s0, s1 = sig[:, :-1], sig[:, 1:]
    cols = torch.arange(n - 1, dtype=torch.int32, device=dev)
    mask = (s0 > 0) & (s1 <= 0) & (cols[None, :] < col_cap[:, None])
    one = torch.ones((), dtype=sig.dtype, device=dev)
    frac = torch.where(mask, s0 / torch.where(mask, s0 - s1, one),
                       torch.zeros((), dtype=sig.dtype, device=dev))
    del s0, s1
    lo = torch.tensor(_NO_EVT_LO, dtype=torch.int32, device=dev)
    hi = torch.tensor(_NO_EVT_HI, dtype=torch.int32, device=dev)
    # last event column <= col, first event column >= col
    cm = torch.cummax(torch.where(mask, cols, lo), dim=1).values
    rm = torch.flip(torch.cummin(torch.flip(torch.where(mask, cols, hi),
                                            dims=(1,)), dim=1).values,
                    dims=(1,))
    count = mask.sum(dim=1)
    del mask
    cm_prev = torch.cat([lo.expand(R, 1), cm[:, :-1]], dim=1)
    rm_next = torch.cat([rm[:, 1:], hi.expand(R, 1)], dim=1)

    def at(a, c):
        return torch.gather(a, 1, torch.clamp(c, 0, n - 2).long())

    def rel(c):
        """Event position relative to t; +-inf for the sentinels."""
        r = (torch.clamp(c, 0, n - 2).to(t.dtype) - t) + at(frac, c)
        return torch.where(c <= _NO_EVT_LO // 2, -np.inf,
                           torch.where(c >= _NO_EVT_HI // 2, np.inf, r))

    ct = torch.clamp(torch.floor(t).to(torch.int32), 0, n - 2)    # (T,)
    ctr = ct.expand(R, -1)
    has_ct = at(cm, ctr) == ctr               # an event inside column ct?
    r_ct = (ct.to(t.dtype) - t) + at(frac, ctr)
    # bounding events of the interval holding t (one event a column: only
    # column ct itself is ambiguous, later columns are all > t)
    c0 = torch.where(has_ct & (r_ct <= 0), ctr, at(cm_prev, ctr))
    c1 = torch.where(has_ct & (r_ct > 0), ctr, at(rm_next, ctr))
    # the events one step further out
    c_m1 = at(cm_prev, c0)
    c2 = at(rm_next, c1)
    r0, r1 = rel(c0), rel(c1)
    r_m1, r2 = rel(c_m1), rel(c2)

    f_cur = 1.0 / (r1 - r0)
    mid = 0.5 * (r0 + r1)
    f_rgt = 1.0 / (r2 - r1)
    mid_r = 0.5 * (r1 + r2)
    f_lft = 1.0 / (r0 - r_m1)
    mid_l = 0.5 * (r_m1 + r0)
    wr = (0.0 - mid) / (mid_r - mid)
    wl = (0.0 - mid_l) / (mid - mid_l)
    val_r = torch.where(torch.isfinite(r2), f_cur + (f_rgt - f_cur) * wr,
                        f_cur)
    val_l = torch.where(torch.isfinite(r_m1), f_lft + (f_cur - f_lft) * wl,
                        f_cur)
    track = torch.where(0.0 >= mid, val_r, val_l)

    c_first = rm[:, :1]
    c_last = cm[:, -1:]
    mid_first = 0.5 * (rel(c_first) + rel(at(rm_next, c_first)))
    mid_last = 0.5 * (rel(at(cm_prev, c_last)) + rel(c_last))
    valid = (count[:, None] >= 3) & (mid_first <= 0.0) & (mid_last >= 0.0)
    return torch.where(valid, track, torch.zeros_like(track)), valid


def _raw_candidates_device(x8b: torch.Tensor, n_true: torch.Tensor, H, halves,
                           boundary, t: torch.Tensor, fs8: float, n_fft: int,
                           f0_floor: float, f0_ceil: float):
    """The host ``_raw_candidates`` for a micro-batch of U utterances.

    ``x8b`` (U, n_b) zero-padded signals at the analysis rate, ``n_true``
    (U,) their lengths.  Returns (U, T, K) candidate f0 (Hz) and relative
    deviation, sorted ascending by deviation, 3%-deduplicated.  K =
    min(_MAX_CANDIDATES, channels): a narrow f0 range builds a bank with
    fewer channels than the pool width."""
    U, n_b = x8b.shape
    C = H.shape[0]
    X = torch.fft.rfft(x8b, n=n_fft, dim=1)
    Y = torch.fft.irfft(X[:, None, :] * H[None], n=n_fft, dim=2)
    del X
    # compensate each band's group delay (host slices y[half:half+n])
    idx = halves[:, None] + torch.arange(n_b, device=x8b.device)[None, :]
    y = torch.gather(Y, 2, idx.expand(U, C, n_b))               # (U, C, n_b)
    del Y
    dy = torch.diff(y, dim=2)
    dyp = torch.cat([dy, dy[..., -1:]], dim=2)
    del dy
    # rows: the four event types of every band.  Replicating dy's last
    # sample can never fabricate an event (s0 == s1 fails one strict side
    # of the crossing test), and real dy events keep their columns.
    S = torch.cat([y, -y, dyp, -dyp], dim=1).reshape(U * 4 * C, n_b)
    del y, dyp
    # host pair columns: <= n_true-2 on y rows, <= n_true-3 on dy rows
    # (dy itself is one sample shorter than y)
    caps = torch.cat([(n_true - 1)[:, None].expand(U, 2 * C),
                      (n_true - 2)[:, None].expand(U, 2 * C)],
                     dim=1).reshape(-1)
    track, valid = _event_tracks(S, caps, t)
    del S
    T = t.shape[0]
    tracks4 = (track * fs8).reshape(U, 4, C, T)  # cycles/sample -> Hz
    valid4 = valid.reshape(U, 4, C, T).all(dim=1)                # (U, C, T)

    mean = tracks4.mean(dim=1)
    dev = torch.sqrt(((tracks4 - mean[:, None]) ** 2).sum(dim=1) / 3.0)
    inf = torch.full((), np.inf, dtype=mean.dtype, device=mean.device)
    rel = torch.where(mean > 0, dev / torch.clamp(mean, min=1e-9), inf)
    bf = boundary[None, :, None]
    ok = (valid4 & (mean >= f0_floor) & (mean <= f0_ceil)
          & (mean >= bf / 1.6) & (mean <= bf * 1.6) & (rel < 0.35))
    relg = torch.where(ok, rel, inf).transpose(1, 2)            # (U, T, C)

    # the host's replace-the-worst streaming pool keeps exactly the K
    # smallest deviations; a stable sort breaks ties by the lower channel
    # index, as lax.top_k does
    K = min(_MAX_CANDIDATES, C)
    cand_dev, ch = torch.sort(relg, dim=2, stable=True)
    cand_dev, ch = cand_dev[..., :K].clone(), ch[..., :K]
    cand_f0 = torch.gather(mean.transpose(1, 2), 2, ch)
    live = torch.isfinite(cand_dev)
    cand_f0 = torch.where(live, cand_f0, torch.zeros_like(cand_f0))

    # dedupe 3% clusters (adjacent channels vote for the same f0)
    for j in range(1, K):
        dup = torch.zeros_like(live[..., 0])
        for i in range(j):
            dup |= ((cand_f0[..., i] > 0)
                    & (torch.abs(cand_f0[..., j] - cand_f0[..., i])
                       < 0.03 * cand_f0[..., i]))
        cand_f0[..., j] = torch.where(dup, 0.0, cand_f0[..., j])
        cand_dev[..., j] = torch.where(dup, inf, cand_dev[..., j])
    order = torch.argsort(cand_dev, dim=2, stable=True)
    return (torch.gather(cand_f0, 2, order), torch.gather(cand_dev, 2, order))


def _refine_device(x8b: torch.Tensor, n_true: torch.Tensor,
                   cand_f0: torch.Tensor, t: torch.Tensor, fs8: float,
                   max_half: int):
    """The host ``_refine_candidates`` for a micro-batch: cand_f0 (U, T, K)
    -> refined f0 and score (U, T, K).

    Every live (frame, candidate) row gets a Blackman window of half-width
    1.5/f0 centred on its frame, the spectral-reassignment instantaneous
    frequency at its <= 6 harmonic bins, and the amplitude-weighted refined
    f0 and reliability score.  The harmonic bins lie on the host's own
    per-row spectral grid (n_fft = next power of two covering the row's
    window) and are evaluated by direct DTFT: the rfft phase reference is a
    per-row constant factor that cancels in |X_w|^2 and Im{X_d conj(X_w)}.
    Dead rows (f0 0) are not computed: each row is independent, so the
    result is that of computing all of them."""
    U, n_b = x8b.shape
    _, T, K = cand_f0.shape
    dt, dev = x8b.dtype, x8b.device
    m = torch.arange(-max_half, max_half + 1, device=dev)
    mf = m.to(dt)
    ks = torch.arange(1, 7, dtype=dt, device=dev)

    flat_f0 = cand_f0.reshape(-1)
    rows = torch.nonzero(flat_f0 > 0)[:, 0]
    out_f0 = torch.zeros_like(flat_f0)
    out_sc = torch.full_like(flat_f0, np.inf)
    centers = torch.round(t).long()
    for s in range(0, rows.shape[0], _REFINE_CHUNK):
        r = rows[s:s + _REFINE_CHUNK]
        f0 = flat_f0[r]
        u = torch.div(r, T * K, rounding_mode="floor")
        ctr = centers[torch.div(r, K, rounding_mode="floor") % T]
        f0safe = torch.clamp(f0, min=1.0)
        half = torch.clamp(torch.round(1.5 * fs8 / f0safe), max=max_half)
        pos = ctr[:, None] + m[None, :]
        inside = (pos >= 0) & (pos < n_true[u][:, None])
        seg = torch.where(inside, x8b[u[:, None], torch.clamp(pos, 0, n_b - 1)],
                          torch.zeros((), dtype=dt, device=dev))
        hw = half[:, None]
        phase = np.pi * mf[None, :] / (hw + 1.0)
        in_win = torch.abs(mf[None, :]) <= hw
        zero = torch.zeros((), dtype=dt, device=dev)
        win = torch.where(in_win, 0.42 + 0.5 * torch.cos(phase)
                          + 0.08 * torch.cos(2 * phase), zero)
        dwin = torch.where(in_win,
                           -(np.pi / (hw + 1.0))
                           * (0.5 * torch.sin(phase)
                              + 0.16 * torch.sin(2 * phase)), zero)
        # per-row spectral grid, the host's: df = fs8/nf with nf =
        # 2^ceil(log2(2*half+1)) (2*half+1 is odd, so log2 is never an
        # exact integer and ceil is exact)
        nf = torch.exp2(torch.ceil(torch.log2(2.0 * half + 1.0)))
        df = fs8 / nf
        n_harm = torch.clamp(fs8 / 2.0 / torch.clamp(f0safe, min=1e-9),
                             max=6.0)
        use = ks[None, :] <= n_harm[:, None]
        bins = torch.clamp(torch.round(ks[None, :] * f0[:, None]
                                       / df[:, None]),
                           min=0.0)
        bins = torch.minimum(bins, nf[:, None] / 2.0)            # (rows, 6)
        # direct DTFT at the harmonic bins.  theta = 2 pi bins m / nf with
        # bins*m an exact integer (< 2^24) and nf a power of two, so
        # reducing mod 1 before scaling by 2 pi keeps the angles at full
        # precision (2 pi f m / fs8 would lose 5 digits at theta ~ 700 rad)
        ratio = bins[:, :, None] * mf[None, None, :] / nf[:, None, None]
        theta = (2.0 * np.pi) * (ratio - torch.floor(ratio))
        del ratio
        trig = torch.cat([torch.cos(theta), torch.sin(theta)], dim=1)
        del theta
        # (rows, 12, W) x (rows, W, 2): the four real DTFT products at once,
        # in full float32 (a frequency estimator held to the host at
        # float32 rounding)
        with full_f32_products():
            prod = torch.bmm(trig, torch.stack([seg * win, seg * dwin],
                                               dim=2))
        del trig
        Xw_re, Xw_im = prod[:, :6, 0], -prod[:, 6:, 0]
        Xd_re, Xd_im = prod[:, :6, 1], -prod[:, 6:, 1]
        power = Xw_re ** 2 + Xw_im ** 2 + 1e-30
        inst = (bins * df[:, None]
                - (fs8 / (2.0 * np.pi))
                * (Xd_im * Xw_re - Xd_re * Xw_im) / power)
        est = inst / ks[None, :]
        amp = torch.where(use, torch.sqrt(power), zero)
        amp_sum = amp.sum(dim=1)
        refined = (amp * est).sum(dim=1) / torch.clamp(amp_sum, min=1e-30)
        dev_ = (amp * torch.abs(est - refined[:, None])).sum(dim=1)
        score = dev_ / (torch.clamp(amp_sum, min=1e-30)
                        * torch.clamp(refined, min=1e-9))
        ok = (refined > 0) & torch.isfinite(score)
        out_f0[r] = torch.where(ok, refined, zero)
        out_sc[r] = torch.where(ok, score, torch.full_like(score, np.inf))
    return out_f0.reshape(U, T, K), out_sc.reshape(U, T, K)


def harvest_torch_many(xs: list, fs: int, f0_floor: float = 71.0,
                       f0_ceil: float = 800.0, shiftms: float = 5.0,
                       device="cuda", dtype=torch.float32) -> list:
    """Harvest F0 of MANY waveforms with the heavy stages on ``device``.

    Same output contract as ``dsp.harvest.harvest`` per utterance.  The
    stages compute in ``dtype``: float32 by default, the JAX module's dtype,
    whose event stage rounds as the host's complex64 filter bank does
    (float64 moves other threshold-straddling frames: on the Klatt corpora
    of ``chip_smoke.py`` [features] it agreed with the host's voicing less
    often, PERF.md).
    Utterances are decimated to the 8 kHz analysis rate on the host,
    grouped into sample-length buckets (``_BUCKETS``), and each group runs
    as zero-padded micro-batches of up to ``_U_BATCH`` (at most 2^20
    samples a batch).  Contour fixing and smoothing are the host's.

    Utterances too short for the channel bank (where the host adjusts
    ``f0_floor`` from the signal length: shorter than ``3 fs8 / f0_floor``
    samples at the analysis rate) or longer than the largest bucket take
    the host ``harvest``, as in the JAX module; each is logged and counted
    in ``harvest_torch_many.host_utterances``."""
    from pytorchwavenetvocoder_tpu_torch.dsp.harvest import harvest as _host

    device = torch.device(device)
    results: list = [None] * len(xs)
    ceil_cap = None
    groups: dict = {}
    metas: dict = {}
    for i, x in enumerate(xs):
        x = np.asarray(x, np.float64)
        hop = int(fs * shiftms / 1000.0)
        n_out = len(x) // hop + 1
        if len(x) < int(0.05 * fs) or not np.any(x):
            results[i] = np.zeros(n_out)
            continue
        x8, fs8 = _decimate(x, fs)
        if ceil_cap is None:
            ceil_cap = min(f0_ceil, fs8 / 4.0)
        floor = max(f0_floor, 3.0 * fs8 / len(x8)) if len(x8) else f0_floor
        if floor != f0_floor or len(x8) > _BUCKETS[-1]:
            logging.info("harvest_torch_many: utterance %d (%d samples at "
                         "%g Hz) takes the host Harvest", i, len(x8), fs8)
            harvest_torch_many.host_utterances += 1
            results[i] = _host(x, fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                               shiftms=shiftms)
            continue
        n_b = next(b for b in _BUCKETS if b >= len(x8))
        groups.setdefault((n_b, fs8), []).append(i)
        metas[i] = (x8, n_out, hop)

    for (n_b, fs8), idxs in groups.items():
        H, halves, boundary, n_fft = _bank_constants(
            n_b, fs8, f0_floor, ceil_cap, device, dtype)
        max_half = int(np.round(1.5 * fs8 / f0_floor))
        t_frames = int(np.ceil(n_b / (fs8 * _BASIC_PERIOD_MS / 1000.0)))
        t = torch.arange(t_frames, dtype=dtype, device=device) * \
            torch.tensor(fs8 * _BASIC_PERIOD_MS / 1000.0, dtype=dtype)
        u_batch = min(_U_BATCH, max(1, (1 << 20) // n_b))
        for g0 in range(0, len(idxs), u_batch):
            batch = idxs[g0:g0 + u_batch]
            xb = np.zeros((len(batch), n_b))
            for j, i in enumerate(batch):
                xb[j, :len(metas[i][0])] = metas[i][0]
            x8b = torch.as_tensor(xb, dtype=dtype, device=device)
            nt = torch.as_tensor([len(metas[i][0]) for i in batch],
                                 device=device)
            cf0, _ = _raw_candidates_device(x8b, nt, H, halves, boundary, t,
                                            fs8, n_fft, f0_floor, ceil_cap)
            cf0, csc = _refine_device(x8b, nt, cf0, t, fs8, max_half)
            cf0 = cf0.double().cpu().numpy()
            csc = csc.double().cpu().numpy()
            for j, i in enumerate(batch):
                x8, n_out, hop = metas[i]
                t_true = len(np.arange(0.0, len(x8) / fs8,
                                       _BASIC_PERIOD_MS / 1000.0))
                f0_1ms = _fix_contour(cf0[j, :t_true], csc[j, :t_true],
                                      f0_floor, ceil_cap)
                f0_1ms = _smooth_contour(f0_1ms)
                pick = np.clip(np.round(np.arange(n_out) * hop / fs
                                        / (_BASIC_PERIOD_MS / 1000.0))
                               .astype(int), 0, max(len(f0_1ms) - 1, 0))
                results[i] = (f0_1ms[pick] if len(f0_1ms)
                              else np.zeros(n_out))
    return results


harvest_torch_many.host_utterances = 0


def harvest_torch(x: np.ndarray, fs: int, f0_floor: float = 71.0,
                  f0_ceil: float = 800.0, shiftms: float = 5.0,
                  device="cuda", dtype=torch.float32) -> np.ndarray:
    """Single-utterance convenience wrapper over ``harvest_torch_many``."""
    return harvest_torch_many([x], fs, f0_floor=f0_floor, f0_ceil=f0_ceil,
                              shiftms=shiftms, device=device, dtype=dtype)[0]
