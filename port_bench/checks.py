"""How ``correct`` is decided: what the timed path produced, compared with
the plain reference (``reference/wavenet.py``) once the window has closed
and the program's state is freed.  Every number compared has its limit in
``limits/<workload>.json``; a run is correct when every number is within
its limit.  ``PERF.md`` gives the readings each limit was set from.

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

from port_bench import traffic as tr
from port_bench.reference import wavenet as ref
from port_bench.weights import make_params

ADAM_BETA1 = 0.9
#: The training steps the comparison follows from the initial weights.
CHECKED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorchwavenetvocoder_tpu")
#: Leaves whose reference gradient is below this share of the median
#: leaf's move under Adam by round-off alone: not in ``update_gap``.
STILL_LEAF = 1e-3


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


def _read_pcm(path: str):
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            return None, None
        return (np.frombuffer(w.readframes(w.getnframes()), "<i2"),
                w.getframerate())


def read_served(cfg: dict, path: str, n: int):
    """The mu-law classes a wav holds, or None where it is missing, of
    another length or rate, or holds a value no class writes."""
    if not os.path.exists(path):
        return None
    pcm, fs = _read_pcm(path)
    if pcm is None or fs != cfg["fs"] or len(pcm) != n:
        return None
    table = ref.mulaw_pcm_table(cfg["n_quantize"])
    inverse = np.full(65536, -1, np.int64)
    inverse[table.astype(np.int64) + 32768] = np.arange(len(table))
    served = inverse[pcm.astype(np.int64) + 32768]
    return None if (served < 0).any() else served


def _noise(cfg: dict, seed: int, device, fleets: list, sizes: dict):
    """The sampler's noise of each sampled fleet among ``fleets`` (in the
    order they were decoded, one generator's draws), as a function of
    (fleet, row, steps); ``sizes`` maps a fleet to its (rows, longest)."""
    from port_bench.reference import sampler

    gen = tr.sampling_generator(seed)
    sampled = [i for i in fleets if tr.fleet_mode(i) == "sampling"]
    Q = cfg["n_quantize"]
    if torch.device(device).type == "cuda":
        seeds = dict(zip(sampled, sampler.fleet_seeds(gen, len(sampled))))
        return lambda i, b, n: sampler.kernel_noise(seeds[i], b, n, Q, device)
    drawn = {i: sampler.plain_noise(gen, *sizes[i], Q) for i in sampled}
    return lambda i, b, n: drawn[i][b, :n].to(device)


def decode(cfg: dict, traffic: dict, seed: int, device, outdir: str,
           fleets: list, rows: list) -> dict:
    """``wav_errors`` over the wavs under ``outdir`` of the fleets whose
    indices ``fleets`` lists, in the order they were decoded;
    ``greedy_gap`` and ``sampled_gap`` over the (fleet, row) pairs
    ``rows`` of each mode."""
    errors, served, sizes = 0, {}, {}
    for i in fleets:
        ids, (_x, _h, n_samples) = tr.fleet(traffic, cfg, seed, i)
        sizes[i] = (len(ids), max(n_samples))
        for b, (name, n) in enumerate(zip(ids, n_samples)):
            got = read_served(cfg, os.path.join(outdir, name + ".wav"), n)
            if got is None:
                errors += 1
            elif (i, b) in rows:
                served[(i, b)] = got
    out = dict(wav_errors=errors)
    if not rows:
        return out
    ref.strict_float32()
    noise = _noise(cfg, seed, device, fleets, sizes)
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
        g = ref.served_gaps(params, cfg, h[b, :(n + 1) // uf], served[(i, b)],
                            tr.seed_class(cfg),
                            None if mode == "argmax" else noise(i, b, n))
        out[key] = max(out.get(key, 0.0), float(g.max()))
    del params
    return out


def reference_steps(cfg: dict, traffic: dict, seed: int, world: int,
                    device, mm=torch.matmul, ranks_used=None) -> dict:
    """The reference's checked steps from the seed's weights."""
    ref.strict_float32()
    steps = []
    for s in range(CHECKED_STEPS):
        per_rank = []
        for r in range(world):
            x, h, t = tr.train_window(cfg, seed,
                                      tr.window_index(traffic, r, s))
            per_rank.append(tuple(torch.as_tensor(a[None], device=device)
                                  for a in (x, h, t)))
        steps.append(per_rank)
    return ref.train_steps(make_params(cfg, seed, device, bf16_values=False),
                           cfg, steps,
                           cfg["lr"], cfg["weight_decay"], mm=mm,
                           ranks_used=ranks_used)


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def _leaf_gaps(prog: dict, refs: dict, keys) -> list:
    med = float(np.median([refs[k] for k in keys]))
    return [abs(prog[k] - refs[k]) / max(refs[k], med, 1e-30) for k in keys]


def train_numbers(losses: list, grad1: dict, after: dict, theta0: dict,
                  r: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``grad_gap_median``,
    ``grad_diff_median`` and ``update_gap`` of a run's ``losses``, first
    gradient and params after the checked steps, against the reference's
    ``r`` from ``theta0``."""
    keys = ref.leaves(theta0)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r["losses"]))
    g_ref = {k: _norm(r["grad1"][k]) for k in keys}
    dev = theta0[keys[0][0]][keys[0][1]].device
    g_prog = {k: _norm(grad1[k].to(dev)) for k in keys}
    d_ref = {k: _norm(r["params"][k[0]][k[1]] - theta0[k[0]][k[1]])
             for k in keys}
    d_prog = {k: _norm(after[k].to(dev) - theta0[k[0]][k[1]])
              for k in keys}
    med = float(np.median(list(g_ref.values())))
    moving = [k for k in keys if g_ref[k] >= STILL_LEAF * med]
    grad_gaps = _leaf_gaps(g_prog, g_ref, keys)
    diffs = [_norm(grad1[k].to(dev) - r["grad1"][k]) / max(g_ref[k], med,
                                                            1e-30)
             for k in keys]
    return dict(loss_gap=loss_gap, grad_gap=max(grad_gaps),
                grad_gap_median=float(np.median(grad_gaps)),
                grad_diff_median=float(np.median(diffs)),
                update_gap=max(_leaf_gaps(d_prog, d_ref, moving)))


def train(cell, seed: int, device, losses: list, grad1: dict, after: dict,
          world: int, route: str) -> dict:
    cfg = cell.config
    r = reference_steps(cfg, cell.traffic, seed, world, device)
    theta0 = make_params(cfg, seed, device, bf16_values=False)
    out = train_numbers(losses, grad1, after, theta0, r)
    want = "fused" if torch.device(device).type == "cuda" else "plain"
    out["route_off"] = 0.0 if route == want else 1.0
    return out
