"""The one traffic generator: every cell's inputs from its traffic file
(``traffic/<name>.json``), its configuration and ``--seed``.

Two kinds of traffic:

- ``decode``: fleets of the configuration's ``decode_batch_size`` (B)
  utterances decoded in lockstep.  Every fleet holds the same lengths: the
  B quantiles, at (i + 0.5) / B, of the duration distribution the file
  gives (``durations``), scaled by the configuration's ``duration_scale``
  (1 where it has none), cut to whole frames.  The seed permutes them over the rows and draws the
  standardized aux features, so every seed brings the same work in
  another order.  Fleet i decodes in ``MODES[min(i, len(MODES) - 1)]``,
  sampling with the generator ``sampling_generator`` makes from the seed;
  ``quantize`` (default false) decodes on the program's int8 path.
- ``train``: training windows of the configuration's ``batch_length``
  (rounded to whole frames as the trainer rounds it: ``(rf +
  batch_length) // uf`` frames), ``ranks`` processes with one window each
  per step (the configuration's ``batch_size`` over the ranks), cycled
  over ``WINDOWS_PER_RANK`` distinct windows a rank holds in host memory.
  A window is a synthetic utterance, a few damped partials and noise,
  with standardized features; the configuration's architecture
  (``arch/<name>.py``) makes the program's inputs and next-sample
  targets of it (the mu-law WaveNet codes it in mu-law classes), as it
  gives a decode row's first input.

Everything here is numpy on the host, as the program's own feeders give
it (and one ``torch.Generator`` for the sampler); nothing depends on the
program.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from port_bench.bounds import receptive_field
from port_bench.spec import architecture

_FLEET, _WINDOW = 3, 7      # the streams' tags in each generator's seed
#: A decode window's first fleet decodes greedily (the recipes' ``argmax``
#: mode, whose served classes the reference judges without noise), every
#: later one samples (the recipes' default).
MODES = ("argmax", "sampling")
#: The distinct training windows a rank holds and cycles over.
WINDOWS_PER_RANK = 64


def _rng(seed: int, tag: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, tag, index])


def _quantiles(spec: dict, q: np.ndarray) -> np.ndarray:
    """Durations (s) at the probabilities ``q`` of the distribution
    ``spec``: "lognormal" (median_s, sigma), "beta" (a, b on [lo_s,
    hi_s], its CDF integrated on a fine grid) or "table" (``s``: the
    durations of a sample of a corpus, in any order; its quantiles,
    interpolated linearly between the sorted values)."""
    if spec["dist"] == "lognormal":
        nd = NormalDist()
        return np.array([spec["median_s"] * math.exp(spec["sigma"]
                                                      * nd.inv_cdf(p))
                         for p in q])
    if spec["dist"] == "beta":
        a, b = spec["a"], spec["b"]
        u = (np.arange(200_000) + 0.5) / 200_000
        cdf = np.cumsum(u ** (a - 1) * (1 - u) ** (b - 1))
        cdf /= cdf[-1]
        x = np.interp(q, cdf, u)
        return spec["lo_s"] + x * (spec["hi_s"] - spec["lo_s"])
    if spec["dist"] == "table":
        return np.quantile(np.asarray(spec["s"], dtype=np.float64), q)
    raise ValueError(f"unknown duration distribution {spec['dist']!r}")


def fleet_frames(traffic: dict, cfg: dict) -> np.ndarray:
    """The frame counts of a fleet's utterances, shortest first."""
    B = cfg["decode_batch_size"]
    q = (np.arange(B) + 0.5) / B
    secs = (_quantiles(traffic["durations"], q)
            * cfg.get("duration_scale", 1.0))
    fps = cfg["fs"] / cfg["upsampling_factor"]
    return np.maximum(1, np.rint(secs * fps)).astype(np.int64)


def sampling_generator(seed: int):
    """The generator a decode window hands the program's sampler."""
    return torch.Generator().manual_seed(seed % 2 ** 64)


def fleet_mode(i: int) -> str:
    return MODES[min(i, len(MODES) - 1)]


def fleet(traffic: dict, cfg: dict, seed: int, i: int):
    """Fleet i as the program's decode feeder yields it: ``(ids, (x, h,
    n_samples))``, x the (B, 1) first inputs (the architecture's
    ``first_input``: the mu-law WaveNet's seed class), h (B, frames, A)
    float32 features zero-padded to the longest, n_samples frames * uf - 1
    a row; with each row's own frames ``h[b, :frames[b]]``."""
    rng = _rng(seed, _FLEET, i)
    frames = fleet_frames(traffic, cfg)[rng.permutation(
        cfg["decode_batch_size"])]
    B, A = len(frames), cfg["n_aux"]
    h = rng.standard_normal((B, int(frames.max()), A), dtype=np.float32)
    for b, n in enumerate(frames):
        h[b, n:] = 0.0
    x = architecture(cfg).first_input(cfg, B)
    n_samples = [int(n) * cfg["upsampling_factor"] - 1 for n in frames]
    ids = [f"f{i:04d}_r{b:04d}" for b in range(B)]
    return ids, (x, h, n_samples)


def window_length(cfg: dict) -> int:
    """Samples of a training window: the trainer's ``batch_length`` with
    the receptive field, cut to whole frames (as the program's
    ``data/generator.py::train_generator`` cuts it)."""
    uf = cfg["upsampling_factor"]
    return (receptive_field(cfg) + cfg["batch_length"]) // uf * uf


def train_window(cfg: dict, seed: int, j: int):
    """Training window j: the architecture's ``train_inputs`` of its T + 1
    samples and its (T / uf, A) float32 features: for the mu-law WaveNet
    ``(x (T,) int32, h, t (T,) int32)``, t x one sample ahead."""
    rng = _rng(seed, _WINDOW, j)
    T, fs = window_length(cfg), cfg["fs"]
    n = np.arange(T + 1) / fs
    wav = 0.02 * rng.standard_normal(T + 1)
    for _ in range(4):
        f0 = rng.uniform(80.0, 400.0)
        wav += (rng.uniform(0.05, 0.2) * np.exp(-n * rng.uniform(0.0, 2.0))
                * np.sin(2 * np.pi * f0 * n + rng.uniform(0, 2 * np.pi)))
    wav = np.clip(wav, -1.0, 1.0)
    h = rng.standard_normal((T // cfg["upsampling_factor"], cfg["n_aux"]),
                            dtype=np.float32)
    return architecture(cfg).train_inputs(cfg, wav, h)


def window_index(traffic: dict, rank: int, step: int) -> int:
    """The corpus window that ``rank`` trains on at ``step``: rank r holds
    windows r, r + ranks, ...; a step takes each rank's next one, cycling
    over ``WINDOWS_PER_RANK``."""
    return (step % WINDOWS_PER_RANK) * traffic["ranks"] + rank


def rank_batches(traffic: dict, cfg: dict, seed: int, rank: int) -> list:
    """The (x, h, t) batches of one rank, in step order, each with a
    leading batch dimension of 1."""
    out = []
    for s in range(WINDOWS_PER_RANK):
        x, h, t = train_window(cfg, seed, window_index(traffic, rank, s))
        out.append((x[None], h[None], t[None]))
    return out
