"""Source-filter (Klatt-style) pseudo-speech synthesizer for validation.

With no network and no recorded speech at hand, fidelity gates
(learning smoke, int8-vs-bf16 MCD, cross-framework e2e) need a corpus
that exercises what the vocoder actually models about SPEECH — none of
which a vibrato harmonic tone has:

- a glottal source with jitter/shimmer and aspiration, not a clean sine
  stack, so Harvest sees a realistic (noisy-periodic) F0 target;
- time-varying FORMANT structure (vowel-to-vowel trajectories through a
  cascade of second-order resonators), so CheapTrick/mcep model a moving
  spectral envelope, not a fixed comb;
- genuine voiced/unvoiced alternation (fricatives, plosive
  closure+burst, word pauses), so the continuous-F0/uv leg and D4C
  aperiodicity see real transitions;
- sentence prosody (declination + per-syllable accents) in a
  per-speaker F0 range matching the recipe conf (arctic slt: 120-275).

This is the classical cascade formant synthesis (Klatt 1980, "Software
for a cascade/parallel formant synthesizer", JASA 67) — synthetic but
structurally *speech*, unlike a tone corpus.  Used by
scripts/tpu_speech_smoke.sh and the e2e fidelity tests; deterministic
per (seed, index).

Reference context: the corpora this stands in for are the recipes'
stage-0 downloads (reference egs/arctic/sd/run.sh:98-123), which need
network access.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# Formant targets (F1..F4 Hz) and bandwidths, adapted from
# Peterson & Barney (1952) / Klatt (1980) female values.
_VOWELS = {
    "a": (850, 1220, 2810, 3900),
    "i": (310, 2790, 3310, 4200),
    "u": (370, 950, 2670, 3900),
    "e": (610, 2330, 2990, 4100),
    "o": (590, 920, 2710, 3900),
    "ae": (860, 2050, 2850, 4000),
}
_BW = (90, 110, 170, 250)

# consonants: (kind, params)
#   nasal: formant-like with low F1, damped
#   fric:  (center_hz, bw_hz, gain) noise band; voiced=False
#   plosive: closure + burst
_CONSONANTS = {
    "m": ("nasal", (250, 1100, 2200, 3300)),
    "n": ("nasal", (250, 1500, 2500, 3300)),
    "s": ("fric", (5500, 3000, 1.0)),
    "sh": ("fric", (3300, 2200, 1.1)),
    "f": ("fric", (4500, 5000, 0.45)),
    "h": ("fric", (1200, 2500, 0.35)),
    "p": ("plosive", (900, 2500)),
    "t": ("plosive", (4000, 3500)),
    "k": ("plosive", (2200, 1800)),
}


def _resonator_coefs(f: np.ndarray, bw: np.ndarray, fs: float):
    """Klatt digital resonator y[n] = A x[n] + B y[n-1] + C y[n-2]."""
    c = -np.exp(-2.0 * np.pi * bw / fs)
    b = 2.0 * np.exp(-np.pi * bw / fs) * np.cos(2.0 * np.pi * f / fs)
    a = 1.0 - b - c
    return a, b, c


def _cascade(x: np.ndarray, tracks: np.ndarray, bws, fs: float,
             frame: int) -> np.ndarray:
    """Run x through a cascade of resonators with per-frame coefficient
    updates (tracks: (n_frames, n_formants) Hz), lfilter state carried
    across frames so the filters stay continuous."""
    n_form = tracks.shape[1]
    y = x
    for j in range(n_form):
        a, b, c = _resonator_coefs(tracks[:, j], np.full(len(tracks),
                                                         float(bws[j])), fs)
        out = np.empty_like(y)
        zi = np.zeros(2)
        for t in range(len(tracks)):
            lo, hi = t * frame, min((t + 1) * frame, len(y))
            if lo >= len(y):
                break
            seg, zi = lfilter([a[t]], [1.0, -b[t], -c[t]], y[lo:hi], zi=zi)
            out[lo:hi] = seg
        y = out
    return y


def _glottal_source(f0: np.ndarray, voiced: np.ndarray, fs: float,
                    rng: np.random.RandomState) -> np.ndarray:
    """Rosenberg-pulse train with jitter/shimmer + aspiration noise.

    f0/voiced are per-sample tracks; the pulse is the classical
    polynomial glottal flow derivative, one period at a time.
    """
    n = len(f0)
    src = np.zeros(n)
    pos = 0
    while pos < n:
        if not voiced[pos]:
            pos += 16
            continue
        t0 = fs / max(f0[pos], 50.0)
        t0 *= 1.0 + 0.012 * rng.randn()           # jitter
        period = max(int(round(t0)), 16)
        amp = 1.0 + 0.06 * rng.randn()            # shimmer
        op = int(period * 0.6)                    # open phase
        cl = int(period * 0.15)                   # return phase
        t = np.arange(op)
        pulse = np.zeros(period)
        pulse[:op] = 0.5 * (1.0 - np.cos(np.pi * t / op))     # opening
        tc = np.arange(cl)
        pulse[op:op + cl] = np.cos(0.5 * np.pi * tc / cl)     # closure
        dpulse = np.diff(pulse, prepend=0.0) * amp
        hi = min(pos + period, n)
        src[pos:hi] += dpulse[:hi - pos]
        pos += period
    # aspiration: breathiness on voiced frames, silence elsewhere
    src += 0.02 * rng.randn(n) * voiced
    return src


def _fric_noise(n: int, center: float, bw: float, fs: float,
                rng: np.random.RandomState) -> np.ndarray:
    a, b, c = _resonator_coefs(np.array([center]), np.array([bw]), fs)
    x = rng.randn(n)
    y, _ = lfilter([a[0]], [1.0, -b[0], -c[0]], x, zi=np.zeros(2))
    return y


def synthesize_utterance(index: int, fs: int = 16000, seed: int = 0,
                         f0_range=(120.0, 275.0),
                         n_syllables=None) -> np.ndarray:
    """One nonsense-word utterance as int16 at fs.

    Deterministic in (seed, index).  f0_range defaults to the arctic
    slt conf (egs/arctic/sd/conf/slt.f0 in the reference: "120 275").
    """
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2 ** 31))
    frame = int(0.005 * fs)                       # 5 ms coefficient frames

    vowel_keys = sorted(_VOWELS)
    cons_keys = sorted(_CONSONANTS)
    if n_syllables is None:
        n_syll = rng.randint(4, 10)
    elif isinstance(n_syllables, tuple):
        n_syll = rng.randint(n_syllables[0], n_syllables[1])
    else:
        n_syll = int(n_syllables)

    # build segment list: (type, phone, dur_s)
    segs = []
    for s in range(n_syll):
        if rng.rand() < 0.85:                     # onset consonant
            segs.append(("C", cons_keys[rng.randint(len(cons_keys))],
                         rng.uniform(0.05, 0.12)))
        segs.append(("V", vowel_keys[rng.randint(len(vowel_keys))],
                     rng.uniform(0.09, 0.22)))
        if rng.rand() < 0.25:                     # coda
            segs.append(("C", cons_keys[rng.randint(len(cons_keys))],
                         rng.uniform(0.04, 0.10)))
        if rng.rand() < 0.3:                      # word boundary pause
            segs.append(("SIL", "", rng.uniform(0.04, 0.12)))
    segs.append(("SIL", "", 0.05))

    total = int(sum(d for _, _, d in segs) * fs)
    n_frames = total // frame + 1
    total = n_frames * frame

    # per-frame formant target track (interpolated through segments)
    tracks = np.zeros((n_frames, 4))
    voiced_f = np.zeros(n_frames, bool)
    fric_mask = np.zeros(total)
    fric_spec = []                                # (lo, hi, center, bw, gain)
    burst_spans = []                              # (pos, center, bw)
    cur = 0
    prev_form = np.array(_VOWELS["a"], float)
    for kind, ph, dur in segs:
        length = int(dur * fs)
        flo, fhi = cur // frame, min((cur + length) // frame + 1, n_frames)
        if kind == "V":
            target = np.array(_VOWELS[ph], float)
            for t in range(flo, fhi):
                w = min(1.0, (t - flo) / max((fhi - flo) * 0.4, 1.0))
                tracks[t] = (1 - w) * prev_form + w * target
            voiced_f[flo:fhi] = True
            prev_form = target
        elif kind == "C":
            ckind, par = _CONSONANTS[ph]
            if ckind == "nasal":
                target = np.array(par, float)
                tracks[flo:fhi] = target
                voiced_f[flo:fhi] = True
                prev_form = target
            elif ckind == "fric":
                c0, bw, gain = par
                tracks[flo:fhi] = prev_form
                fric_mask[cur:cur + length] = gain
                fric_spec.append((cur, cur + length, c0, bw, gain))
            else:                                 # plosive
                c0, bw = par
                tracks[flo:fhi] = prev_form
                burst_at = cur + int(length * 0.7)
                burst_spans.append((burst_at, c0, bw))
        else:
            tracks[flo:fhi] = prev_form
        cur += length

    # F0 contour: declination + per-syllable accent + slow wander
    base = rng.uniform(f0_range[0] * 1.25, f0_range[1] * 0.75)
    tt = np.linspace(0.0, 1.0, n_frames)
    contour = base * (1.12 - 0.25 * tt)
    contour *= 1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * tt
                                   * (total / fs))
    contour += base * 0.02 * np.cumsum(rng.randn(n_frames)) / np.sqrt(
        np.arange(1, n_frames + 1))
    contour = np.clip(contour, f0_range[0], f0_range[1])

    f0 = np.repeat(contour, frame)[:total]
    voiced = np.repeat(voiced_f, frame)[:total].astype(float)
    # amplitude envelope: smooth syllable-level energy
    env_f = np.where(voiced_f, 1.0, 0.25) * (1.0 - 0.3 * tt)
    env = np.repeat(env_f, frame)[:total]
    env = lfilter(*_smooth_ba(fs, 30.0), env)

    src = _glottal_source(f0, voiced > 0.5, fs, rng) * env
    speech = _cascade(src, tracks, _BW, fs, frame)

    # fricatives: shaped noise added after the cascade (parallel branch)
    for lo, hi, c0, bw, gain in fric_spec:
        hi = min(hi, total)
        if hi <= lo:
            continue
        noise = _fric_noise(hi - lo, c0, bw, fs, rng)
        ramp = np.minimum(np.arange(hi - lo) / (0.01 * fs), 1.0)
        ramp *= ramp[::-1]
        speech[lo:hi] += 0.25 * gain * noise * ramp

    # plosive bursts: 15 ms shaped-noise transients
    for pos, c0, bw in burst_spans:
        blen = int(0.015 * fs)
        hi = min(pos + blen, total)
        if hi <= pos:
            continue
        noise = _fric_noise(hi - pos, c0, bw, fs, rng)
        decay = np.exp(-np.arange(hi - pos) / (0.004 * fs))
        speech[pos:hi] += 0.5 * noise * decay

    speech = speech / (np.max(np.abs(speech)) + 1e-9)
    return np.round(speech * 0.45 * 32767.0).astype(np.int16)


def _smooth_ba(fs: float, cutoff: float):
    """One-pole smoother for envelopes."""
    a = np.exp(-2.0 * np.pi * cutoff / fs)
    return [1.0 - a], [1.0, -a]


def make_corpus(outdir: str, n_utts: int, fs: int = 16000, seed: int = 0,
                prefix: str = "arctic_a", f0_range=(120.0, 275.0),
                n_syllables=None) -> None:
    """Write an arctic-layout corpus of pseudo-speech wavs."""
    import os

    from scipy.io import wavfile

    os.makedirs(outdir, exist_ok=True)
    for i in range(n_utts):
        x = synthesize_utterance(i, fs=fs, seed=seed, f0_range=f0_range,
                                 n_syllables=n_syllables)
        wavfile.write(os.path.join(outdir, f"{prefix}{i:04d}.wav"), fs, x)


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "klatt_corpus"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    fs = int(sys.argv[3]) if len(sys.argv) > 3 else 16000
    make_corpus(out, n, fs=fs)
    print(f"wrote {n} pseudo-speech utterances to {out}")
