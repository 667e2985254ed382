"""The mu-law WaveNet: kan-bayashi/PytorchWaveNetVocoder's conditional
WaveNet as the port (``pytorchwavenetvocoder_tpu_torch``) runs it, and
the architecture of every configuration without an ``architecture`` key.

A one-hot causal input over ``n_quantize`` mu-law classes, L =
``dilation_depth`` x ``dilation_repeat`` gated layers whose gate has the
residual width (``dil.w (L, k, R, 2R)``, ``skip.w (L, R, S)``, ``res.w
(L, R, R)``), a ReLU / 1x1 post stack and a softmax over the classes.  Its
plain reference is ``reference/wavenet.py``, its sampler's noise
``reference/sampler.py``.  The harness finds this module by file
(``spec.architecture``); ``README.md`` says what each hook takes and
returns.  Nothing of the program is imported here at import time.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from port_bench import checks
from port_bench import traffic as tr
from port_bench.bounds import bound_s
from port_bench.reference import wavenet as ref

#: The keys of a configuration file that are the model's
#: (``WaveNetConfig``'s); the rest are the recipe's or notes.
MODEL_KEYS = ("n_quantize", "n_aux", "n_resch", "n_skipch", "dilation_depth",
              "dilation_repeat", "kernel_size", "upsampling_factor",
              "compute_dtype")
#: The program's training step; a test names a broken one in its place.
STEP_FACTORY = "pytorchwavenetvocoder_tpu_torch.parallel.train:make_train_step"
#: Leaves whose reference gradient is below this share of the median
#: leaf's move under Adam by round-off alone: not in ``update_gap``.
STILL_LEAF = 1e-3


# ---- the model ----------------------------------------------------------

def layout(cfg: dict) -> list:
    """(group, name, shape, Xavier bound or None for a bias, centre)."""
    Q, A, R, S = cfg["n_quantize"], cfg["n_aux"], cfg["n_resch"], \
        cfg["n_skipch"]
    L = cfg["dilation_depth"] * cfg["dilation_repeat"]
    k = cfg["kernel_size"]

    def xavier(kk, fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in * kk + fan_out * kk))

    return [
        ("causal", "w", (k, Q, R), xavier(k, Q, R), 0.0),
        ("dil", "w", (L, k, R, 2 * R), xavier(k, R, R), 0.0),
        ("aux", "w", (L, A, 2 * R), xavier(1, A, R), 0.0),
        ("skip", "w", (L, R, S), xavier(1, R, S), 0.0),
        ("res", "w", (L, R, R), xavier(1, R, R), 0.0),
        ("post1", "w", (S, S), xavier(1, S, S), 0.0),
        ("post2", "w", (S, Q), xavier(1, S, Q), 0.0),
        ("causal", "b", (R,), None, 0.0),
        ("dil", "b", (L, 2 * R), None, 0.0),
        ("aux", "b", (L, 2 * R), None, 0.0),
        ("skip", "b", (L, S), None, 0.0),
        ("res", "b", (L, R), None, 0.0),
        ("post1", "b", (S,), None, 0.0),
        ("post2", "b", (Q,), None, 0.0),
        # the upsampler starts near replication
        ("upsampling", "w", (cfg["upsampling_factor"],), None, 1.0),
        ("upsampling", "b", (), None, 0.0),
    ]


def _program_config(cfg: dict):
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig

    return WaveNetConfig(**{k: cfg[k] for k in MODEL_KEYS})


def decoder(cfg: dict, params: dict, device):
    """The program's ``WaveNet`` on ``device``, as ``decode_batches``
    takes it."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNet

    return WaveNet(_program_config(cfg), params=params, device=device)


def train_step(cfg: dict, params: dict, factory, n_devices: int):
    """The program's training state from ``params`` and the step that
    ``factory`` (the program's ``make_train_step`` or one in its place)
    builds: ``(state, step_fn)``."""
    from pytorchwavenetvocoder_tpu_torch.parallel.train import (
        create_train_state,
    )

    wcfg = _program_config(cfg)
    state = create_train_state(wcfg, lr=cfg["lr"],
                               weight_decay=cfg["weight_decay"],
                               params=params)
    step_fn = factory(wcfg, lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                      n_devices=n_devices)
    return state, step_fn


# ---- the traffic --------------------------------------------------------

def seed_class(cfg: dict) -> int:
    """The mu-law class of silence, which every utterance starts from."""
    return int(math.floor(0.5 * (cfg["n_quantize"] - 1) + 0.5))


def first_input(cfg: dict, rows: int) -> np.ndarray:
    """(rows, 1) int32: the seed class of every row."""
    return np.full((rows, 1), seed_class(cfg), np.int32)


def train_inputs(cfg: dict, wav: np.ndarray, h: np.ndarray):
    """A window's ``(x (T,) int32, h, t (T,) int32)`` from its T + 1
    samples ``wav`` in [-1, 1]: the samples mu-law coded; t is x one
    sample ahead."""
    T = len(wav) - 1
    m = cfg["n_quantize"] - 1
    fx = np.sign(wav) * np.log1p(m * np.abs(wav)) / np.log1p(m)
    cls = np.floor((fx + 1) / 2 * m + 0.5).astype(np.int32)
    return cls[:T], h, cls[1:]


# ---- the decode check ---------------------------------------------------

def read_served(cfg: dict, path: str, n: int):
    """The mu-law classes a wav holds, or None where it is missing, of
    another length or rate, or holds a value no class writes."""
    if not os.path.exists(path):
        return None
    pcm, fs = checks.read_pcm(path)
    if pcm is None or fs != cfg["fs"] or len(pcm) != n:
        return None
    table = ref.mulaw_pcm_table(cfg["n_quantize"])
    inverse = np.full(65536, -1, np.int64)
    inverse[table.astype(np.int64) + 32768] = np.arange(len(table))
    served = inverse[pcm.astype(np.int64) + 32768]
    return None if (served < 0).any() else served


def decode_noise(cfg: dict, seed: int, device, fleets: list, sizes: dict):
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


def served_gaps(params: dict, cfg: dict, frames: np.ndarray,
                served: np.ndarray, noise) -> torch.Tensor:
    """The reference's gap below its best logit of each served class,
    teacher-forced from the seed class (``ref.served_gaps``), in strict
    float32."""
    ref.strict_float32()
    return ref.served_gaps(params, cfg, frames, served, seed_class(cfg),
                           noise)


# ---- the training check -------------------------------------------------

def reference_train_steps(params: dict, cfg: dict, steps: list,
                          mm=torch.matmul, ranks_used=None) -> dict:
    """The reference's Adam steps (``ref.train_steps``) at the
    configuration's ``lr`` and ``weight_decay``, in strict float32."""
    ref.strict_float32()
    return ref.train_steps(params, cfg, steps, cfg["lr"], cfg["weight_decay"],
                           mm=mm, ranks_used=ranks_used)


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


# ---- the controls -------------------------------------------------------

#: The reference's product with both operands in float8: the precision
#: next below the bfloat16 the configurations state (the training control)
control_matmul = ref.fp8_matmul


def decode_controls(cell, seed: int, device, fleets) -> dict:
    """``{who: numbers}`` of a decode cell's control on ``fleets``: the
    program's own int8 path, the precision next below the configurations'
    bfloat16; none for a traffic that is int8 already (int4 is below it,
    which the program lacks)."""
    if cell.traffic.get("quantize", False):
        return {}
    from port_bench.controls import decode_fleets

    return {"control_int8": decode_fleets(cell, seed, device, True, fleets)}


# ---- the operations and bytes (``bounds.py`` dispatches here) -----------
#
# The K1-K3 counts are copies of ``chip_smoke.py``'s ``ar_bound``,
# ``stack_bound`` and ``bwd_bound``, with one change: K1 is counted over
# the row-steps the utterances need (the sum of each row's length), not
# over the rows times the fleet's longest, which a ragged fleet runs but
# does not need.

def dilations(cfg: dict) -> list:
    return [2 ** i for _ in range(cfg["dilation_repeat"])
            for i in range(cfg["dilation_depth"])]


def receptive_field(cfg: dict) -> int:
    return (cfg["kernel_size"] - 1) * sum(dilations(cfg)) + 1


def _dims(cfg: dict):
    return (cfg["n_resch"], cfg["n_skipch"], cfg["n_aux"],
            cfg["dilation_depth"] * cfg["dilation_repeat"],
            cfg["kernel_size"], cfg["n_quantize"])


def ar_bound_s(cfg: dict, lengths, quantize: bool = False) -> float:
    """K1, one call over a fleet whose row b needs ``lengths[b]`` steps:
    the weight packs once (int8 with their column scales), the ring slots
    the needed steps read and write, the aux columns they use, the samples;
    the layer products (int8 under ``quantize``) and the aux and post
    products (bf16)."""
    R, S, A, L, k, Q = _dims(cfg)
    cols = 2 * k * R + S + R
    pack = L * R * cols * (1 if quantize else 2)
    if quantize:
        pack += L * cols * 4
    other = (L * A * 2 * R * 2 + L * (2 * R + S + R) * 4 + k * Q * R * 2
             + R * 4 + S * S * 2 + S * 4 + S * Q * 2 + Q * 4)
    caps = [(k - 1) * d for d in dilations(cfg)]
    width = 2 * R * 2 if k == 2 else R * (1 if quantize else 2)
    ring = sum(min(n * (k - 1), c) + min(n, c)
               for n in lengths for c in caps) * width
    steps = sum(lengths)
    nbytes = pack + other + ring + steps * A * 4 + steps * 4
    layer = 2 * steps * L * (k * R * 2 * R + R * (S + R))
    small = 2 * steps * (L * A * 2 * R + S * S + S * Q)
    if quantize:
        return bound_s(nbytes, small, layer)
    return bound_s(nbytes, layer + small)


def stack_train_bound_s(cfg: dict, B: int, T: int) -> float:
    """K2 in training mode: stream0 bf16 and h_up f32 in, the layer
    weights; out the L-1 streams, the saves (bf16) and the f32 skip sum."""
    R, S, A, L, k, _Q = _dims(cfg)
    M = B * T
    w = (k * R * 2 * R * 2 + A * 2 * R * 2 + 2 * 2 * R * 4 + R * R * 2
         + R * 4 + R * S * 2 + S * 4)
    nbytes = (M * R * 2 + M * A * 4 + L * w + (L - 1) * M * R * 2
              + L * M * 2 * R * 2 + M * S * 4)
    ops = (2 * M * L * (k * R * 2 * R + A * 2 * R)
           + 2 * M * (L * R * S + (L - 1) * R * R))
    return bound_s(nbytes, ops)


def stack_bwd_bound_s(cfg: dict, B: int, T: int) -> float:
    """K3: x0, the streams and saves (bf16), h_up and dskip (f32) and the
    weights in; every f32 gradient, dstream0 and dh_up out."""
    R, S, A, L, k, _Q = _dims(cfg)
    M = B * T
    nbytes = (M * R * 2 * L + L * M * 2 * R * 2 + M * A * 4 + M * S * 4
              + L * (k * R * 2 * R + A * 2 * R + R * S + R * R) * 2
              + L * (k * R * 2 * R + A * 2 * R + R * S + R * R
                     + 4 * R + S + R) * 4
              + M * R * 2 + M * A * 4)
    ops = L * 2 * M * (R * R + R * S + 2 * k * R * 2 * R + 2 * 2 * R * A
                       + R * S + R * R)
    return bound_s(nbytes, ops)


def decode_flops_per_sample(cfg: dict) -> float:
    """The plain model's operations for one AR step of one row, at the
    configuration's own widths: each layer's gate (its k taps and the aux
    term), skip and residual products, and the post stack.  The input
    conv of a one-hot id is a row gather and counts none."""
    R, S, A, L, k, Q = _dims(cfg)
    return 2.0 * (L * (k * R * 2 * R + A * 2 * R + R * (S + R))
                  + S * S + S * Q)


def train_flops_per_position(cfg: dict) -> float:
    """Forward and backward (three times the forward) of one training
    position: the gates and aux terms, the skip products, the residual
    products the next layer reads (L - 1: the last one feeds nothing), the
    post stack."""
    R, S, A, L, k, Q = _dims(cfg)
    fwd = 2.0 * (L * (k * R * 2 * R + A * 2 * R + R * S)
                 + (L - 1) * R * R + S * S + S * Q)
    return 3.0 * fwd
