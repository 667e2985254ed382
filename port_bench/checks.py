"""How ``correct`` is decided: what the timed path produced, compared with
the plain reference of the configuration's architecture (its module
``arch/<name>.py`` names it: ``reference/wavenet.py`` for the mu-law
WaveNet) once the window has closed and the program's state is freed.
Every number compared has its limit in ``limits/<workload>.json``; a run
is correct when every number is within its limit.  ``PERF.md`` gives the
readings each limit was set from.  What follows is the mu-law WaveNet's;
the architecture's hooks (``read_served``, ``decode_noise``,
``served_gaps``, ``reference_train_steps``, ``train_numbers``) decide what
a served wav holds, the gaps and the training numbers.

Decode: every wav the window delivered is read back (16-bit PCM, the
stdlib's ``wave``): it must exist, hold its utterance's length and only
the PCM values of mu-law classes (``wav_errors``, exact: 0).  In every
fleet, the longest utterance and others drawn from the seed are run
through the reference, teacher-forced on the served classes, from the same
features and weights: ``greedy_gap`` is the widest gap by which a served
class's logit lies below the best, in the greedy fleets; ``sampled_gap``
the same in the sampled fleets, with the sampler's noise, worked out again
from the seed (``reference/sampler.py``), added to the reference's logits.

Training: the reference takes the same initial weights (made again from
the seed) and the same windows through the checked steps.  ``loss_gap``:
the largest relative gap of a step's loss; ``grad_gap``: the first step's
gradient, as the optimizer's first moment holds it, by the worst leaf: the
gap between the program's and the reference's norm of the leaf, over the
larger of the reference's norm of that leaf and of the median leaf;
``grad_gap_median``: the median of the leaves' gaps of the first
gradient, which is steady from seed to seed where the worst leaf is the
scalar upsampling bias's rounding noise (PERF.md); ``grad_diff_median``:
the median leaf's norm of the difference of the first gradients, over the
larger of the reference's norm of that leaf and of the median leaf, which
a lower precision moves at first order where it moves the norms at second
(PERF.md); ``update_gap``: the
worst leaf's gap of the params' change over the checked steps, leaving
out leaves whose reference gradient is under a thousandth of the median
leaf's; ``route_off``: 1 where the step ran off the fused route the
card's configuration states (exact: 0).
"""

from __future__ import annotations

import os
import wave

import numpy as np
import torch

from port_bench import spec
from port_bench import traffic as tr
from port_bench.weights import make_params

ADAM_BETA1 = 0.9
#: The training steps the comparison follows from the initial weights.
CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorchwavenetvocoder_tpu")


def forbidden_modules(modules) -> list:
    """The top-level names among ``modules`` (``sys.modules``) that the
    benchmark's processes must not hold, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell's ``limits`` name: each within its limit; one the run did not
    produce, or one that is not finite, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and bool(np.isfinite(value)) \
            and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(limits), out


def read_pcm(path: str):
    """The samples (int16) and rate of a 16-bit mono wav, or (None, None)
    for another format."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            return None, None
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2"),
                w.getframerate())


def decode(cfg: dict, traffic: dict, seed: int, device, outdir: str,
           fleets: list, rows: list) -> dict:
    """``wav_errors`` over the wavs under ``outdir`` of the fleets whose
    indices ``fleets`` lists, in the order they were decoded;
    ``greedy_gap`` and ``sampled_gap`` over the (fleet, row) pairs
    ``rows`` of each mode."""
    arch = spec.architecture(cfg)
    errors, served, sizes = 0, {}, {}
    for i in fleets:
        ids, (_x, _h, n_samples) = tr.fleet(traffic, cfg, seed, i)
        sizes[i] = (len(ids), max(n_samples))
        for b, (name, n) in enumerate(zip(ids, n_samples)):
            got = arch.read_served(cfg, os.path.join(outdir, name + ".wav"),
                                   n)
            if got is None:
                errors += 1
            elif (i, b) in rows:
                served[(i, b)] = got
    out = dict(wav_errors=errors)
    if not rows:
        return out
    noise = arch.decode_noise(cfg, seed, device, fleets, sizes)
    params = make_params(cfg, seed, device)
    uf = cfg["upsampling_factor"]
    for i, b in rows:
        mode = tr.fleet_mode(i)
        key = "greedy_gap" if mode == "argmax" else "sampled_gap"
        if (i, b) not in served:
            out[key] = float("inf")
            continue
        _ids, (_x, h, n_samples) = tr.fleet(traffic, cfg, seed, i)
        n = n_samples[b]
        g = arch.served_gaps(params, cfg, h[b, :(n + 1) // uf],
                             served[(i, b)],
                             None if mode == "argmax" else noise(i, b, n))
        out[key] = max(out.get(key, 0.0), float(g.max()))
    del params
    return out


def reference_steps(cfg: dict, traffic: dict, seed: int, world: int,
                    device, mm=torch.matmul, ranks_used=None) -> dict:
    """The reference's checked steps from the seed's weights, its products
    through ``mm`` (the architecture's ``control_matmul`` for the
    control)."""
    steps = []
    for s in range(CHECKED_STEPS):
        per_rank = []
        for r in range(world):
            x, h, t = tr.train_window(cfg, seed,
                                      tr.window_index(traffic, r, s))
            per_rank.append(tuple(torch.as_tensor(a[None], device=device)
                                  for a in (x, h, t)))
        steps.append(per_rank)
    return spec.architecture(cfg).reference_train_steps(
        make_params(cfg, seed, device, bf16_values=False), cfg, steps,
        mm=mm, ranks_used=ranks_used)


def train(cell, seed: int, device, losses: list, grad1: dict, after: dict,
          world: int, route: str) -> dict:
    cfg = cell.config
    r = reference_steps(cfg, cell.traffic, seed, world, device)
    theta0 = make_params(cfg, seed, device, bf16_values=False)
    out = cell.arch.train_numbers(losses, grad1, after, theta0, r)
    want = "fused" if torch.device(device).type == "cuda" else "plain"
    out["route_off"] = 0.0 if route == want else 1.0
    return out
