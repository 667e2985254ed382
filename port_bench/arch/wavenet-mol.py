"""The mixture-of-logistics WaveNet vocoder (r9y9/wavenet_vocoder's
mixture preset, the vocoder of Tacotron 2) as the port
(``pytorchwavenetvocoder_tpu_torch``, ``WaveNetConfig(output="mol")``)
runs it: a scalar sample through a 1x1 input, L gated layers whose gate
(2G) is narrower than the residual stream (R), output and skip scaled by
sqrt(0.5), a ReLU / 1x1 post stack to 3M mixture outputs, the
conditioning upsampled by ConvTranspose2d stages.  Its plain reference is
``reference/wavenet_mol.py``.  The harness finds this module by file
(``spec.architecture``); ``README.md`` says what each hook takes and
returns.  Nothing of the program is imported here at import time.

The head's rows are drawn where a trained model's head sits (``layout``):
the logits' columns at ``LOGIT_BOUND_SHARE`` times the Xavier bound, so
that the mixture weights differ as a trained model's do (logits spread by
~0.7 at the recipe's widths, against ~0.08 at the bound), the means' at
the bound (spread ~0.2, inside (-1, 1)), and the log-scales' biases
centred at ``LOG_SCALE_CENTRE``, so that a logistic's draw moves a sample
by a few hundredths.  Then few samples are clamped and the gap of the
sample's value binds (``served_gaps``).

What a decode run is held to (``served_gaps``): at every checked step,
teacher-forced on the served samples, the component that explains the
served sample best, the least over the components c of max(c's gap below
the best score, ``VALUE_SCALE`` x |served - c's sample|); the scores are
the logits, plus in a sampled fleet the Gumbel noise of the program's
uniforms, and c's sample is its mean (greedy) or its logistic's draw under
the program's uniform, clamped to [-1, 1].  A component chosen without its
noise, a scale or a uniform other than the program's, or a sample of
another value shows in one or the other.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from port_bench import checks
from port_bench import traffic as tr
from port_bench.bounds import bound_s
from port_bench.reference import wavenet_mol as ref

#: The keys of a configuration file that are the model's
#: (``WaveNetConfig``'s); the rest are the recipe's or notes.
MODEL_KEYS = ("n_quantize", "n_aux", "n_resch", "n_skipch", "n_gatech",
              "n_mix", "dilation_depth", "dilation_repeat", "kernel_size",
              "upsampling_factor", "upsampling_scales",
              "freq_axis_kernel_size", "log_scale_min", "dropout", "output",
              "compute_dtype")
#: The program's training step; a test names a broken one in its place.
STEP_FACTORY = "pytorchwavenetvocoder_tpu_torch.parallel.train:make_train_step"
#: Leaves whose reference gradient is below this share of the median
#: leaf's move under Adam by round-off alone: not in ``update_gap``.
STILL_LEAF = 1e-3
#: The sample's gap weighs as this many logits per unit of amplitude: a
#: hundredth of the amplitude (~330 16-bit steps) as a tenth of a logit.
VALUE_SCALE = 10.0
#: The centre of the head's log-scale biases: exp(-3) ~ 0.05
LOG_SCALE_CENTRE = -3.0
#: The logits' columns of the head at this many times the Xavier bound
LOGIT_BOUND_SHARE = 8.0
#: The seed of the program's dropout masks in a training cell
#: (``make_train_step(dropout_seed=)``), which the reference draws again
DROPOUT_SEED = 20171216

#: The products of the reference in ``served_gaps`` (the control puts
#: float8 in their place for its own readings)
_product = {"mm": torch.matmul}


# ---- the model ----------------------------------------------------------

def _widths(cfg: dict):
    return (cfg["n_aux"], cfg["n_resch"], cfg["n_skipch"], cfg["n_gatech"],
            cfg["dilation_depth"] * cfg["dilation_repeat"],
            cfg["kernel_size"], cfg["n_mix"])


def layout(cfg: dict) -> list:
    """(group, name, shape, Xavier bound or None for a bias, centre).  The
    head's three parts are leaves of their own (``head_logit``,
    ``head_mean``, ``head_scale``), which ``model_params`` joins into the
    program's ``post2``."""
    A, R, S, G, L, k, M = _widths(cfg)
    F_ = cfg["freq_axis_kernel_size"]

    def xavier(kk, fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in * kk + fan_out * kk))

    head = xavier(1, S, 3 * M)
    out = [
        ("causal", "w", (1, 1, R), xavier(1, 1, R), 0.0),
        ("dil", "w", (L, k, R, 2 * G), xavier(k, R, 2 * G), 0.0),
        ("aux", "w", (L, A, 2 * G), xavier(1, A, 2 * G), 0.0),
        ("skip", "w", (L, G, S), xavier(1, G, S), 0.0),
        ("res", "w", (L, G, R), xavier(1, G, R), 0.0),
        ("post1", "w", (S, S), xavier(1, S, S), 0.0),
        ("head_logit", "w", (S, M), LOGIT_BOUND_SHARE * head, 0.0),
        ("head_mean", "w", (S, M), head, 0.0),
        ("head_scale", "w", (S, M), head, 0.0),
        ("causal", "b", (R,), None, 0.0),
        ("dil", "b", (L, 2 * G), None, 0.0),
        ("skip", "b", (L, S), None, 0.0),
        ("res", "b", (L, R), None, 0.0),
        ("post1", "b", (S,), None, 0.0),
        ("head_logit", "b", (M,), None, 0.0),
        ("head_mean", "b", (M,), None, 0.0),
        ("head_scale", "b", (M,), None, LOG_SCALE_CENTRE),
    ]
    for i, s in enumerate(cfg["upsampling_scales"]):
        # each stage near replication: its taps small around 1 / F
        out += [("upsampling", f"w{i}", (F_, s), None, 1.0 / F_),
                ("upsampling", f"b{i}", (), None, 0.0)]
    return out


def model_params(params: dict) -> dict:
    """The layout's leaves as the model's: the head's parts joined into
    ``post2`` ([logits | means | log-scales]).  The conditioning 1x1 has no
    bias (r9y9's), so ``aux`` holds ``w`` alone."""
    out = {g: dict(d) for g, d in params.items()
           if not g.startswith("head_")}
    out["post2"] = {n: torch.cat([params[p][n] for p in
                                  ("head_logit", "head_mean", "head_scale")],
                                 dim=-1) for n in ("w", "b")}
    return out


def layout_params(model: dict, like: dict) -> dict:
    """The model's leaves back in the layout of ``like`` (the inverse of
    ``model_params``)."""
    M = like["head_logit"]["b"].shape[0]
    out = {g: {n: model[g][n] for n in like[g]} for g in like
           if not g.startswith("head_")}
    for i, part in enumerate(("head_logit", "head_mean", "head_scale")):
        out[part] = {n: model["post2"][n][..., i * M:(i + 1) * M]
                     for n in ("w", "b")}
    return out


def _program_config(cfg: dict):
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig

    return WaveNetConfig(**{k: cfg[k] for k in MODEL_KEYS})


def decoder(cfg: dict, params: dict, device):
    """The program's ``WaveNet`` on ``device``, as ``decode_batches``
    takes it."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNet

    return WaveNet(_program_config(cfg), params=model_params(params),
                   device=device)


def train_step(cfg: dict, params: dict, factory, n_devices: int):
    """The program's training state from ``params`` and the step that
    ``factory`` builds, its dropout masks drawn from ``DROPOUT_SEED``:
    ``(state, step_fn)``."""
    from pytorchwavenetvocoder_tpu_torch.parallel.train import (
        create_train_state,
    )

    wcfg = _program_config(cfg)
    state = create_train_state(wcfg, lr=cfg["lr"],
                               weight_decay=cfg["weight_decay"],
                               params=model_params(params))
    step_fn = factory(wcfg, lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                      n_devices=n_devices, dropout_seed=DROPOUT_SEED)
    return state, step_fn


# ---- the traffic --------------------------------------------------------

def first_input(cfg: dict, rows: int) -> np.ndarray:
    """(rows, 1) float32: silence, 0.0, r9y9's first input."""
    return np.zeros((rows, 1), np.float32)


def train_inputs(cfg: dict, wav: np.ndarray, h: np.ndarray):
    """A window's ``(x (T,) float32, h, t (T,) float32)`` from its T + 1
    samples ``wav`` in [-1, 1]: t is x one sample ahead."""
    wav = wav.astype(np.float32)
    return wav[:-1], h, wav[1:]


# ---- the decode check ---------------------------------------------------

def read_served(cfg: dict, path: str, n: int):
    """The samples a 16-bit wav holds (PCM / 32768), or None where it is
    missing or of another length or rate."""
    if not os.path.exists(path):
        return None
    pcm, fs = checks.read_pcm(path)
    if pcm is None or fs != cfg["fs"] or len(pcm) != n:
        return None
    return pcm.astype(np.float32) / np.float32(32768.0)


def kernel_uniforms(seed: int, row: int, n: int, M: int,
                    device) -> torch.Tensor:
    """(n, M + 1) float32: the uniforms in (0, 1) of ``row`` at steps 0 ..
    n - 1 of a fleet sampled under ``seed`` by K1's MoL sampler: uniform j
    (the M components', then the logistic's) is word j % 4 of the
    Philox4x32-10 block of the counter (j // 4, row, step, 1) under the key
    (seed mod 2**32, seed // 2**32), as ``((w >> 9) + 0.5) * 2**-23``."""
    from port_bench.reference import sampler

    groups = -(-(M + 1) // 4)
    i64 = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(groups, **i64)[None, :]
    c2 = torch.arange(n, **i64)[:, None]
    zero = torch.zeros((), **i64)
    words = sampler.philox4x32_10(c0, zero + row, c2, zero + 1,
                                  (seed & 0xFFFFFFFF,
                                   (seed >> 32) & 0xFFFFFFFF))
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    w = w.reshape(n, groups * 4)[:, :M + 1]
    return ((w >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)


def decode_noise(cfg: dict, seed: int, device, fleets: list, sizes: dict):
    """The sampler's uniforms of each sampled fleet among ``fleets`` (in
    the order they were decoded, one generator's draws), as a function of
    (fleet, row, steps) giving ``(u (n, M), v (n,))``: on the card K1's
    Philox layout (``kernel_uniforms``) under one seed a fleet; on the CPU
    the plain loop's ``torch.rand((rows, M + 1), float64)`` a step."""
    from port_bench.reference import sampler

    gen = tr.sampling_generator(seed)
    sampled = [i for i in fleets if tr.fleet_mode(i) == "sampling"]
    M = cfg["n_mix"]
    if torch.device(device).type == "cuda":
        seeds = dict(zip(sampled, sampler.fleet_seeds(gen, len(sampled))))

        def noise(i, b, n):
            u = kernel_uniforms(seeds[i], b, n, M, device)
            return u[:, :M], u[:, M]
        return noise
    drawn = {}
    for i in sampled:
        rows, steps = sizes[i]
        drawn[i] = torch.stack([torch.rand((rows, M + 1), generator=gen,
                                           dtype=torch.float64)
                                for _ in range(steps)], dim=1)

    def plain(i, b, n):
        u = drawn[i][b, :n].to(device)
        return u[:, :M], u[:, M]
    return plain


def served_gaps(params: dict, cfg: dict, frames: np.ndarray,
                served: np.ndarray, noise) -> torch.Tensor:
    """The reference's gap at each served sample (``ref.served_gaps``),
    in strict float32."""
    ref.strict_float32()
    return ref.served_gaps(model_params(params), cfg, frames, served, noise,
                           VALUE_SCALE, mm=_product["mm"])


# ---- the training check -------------------------------------------------

def dropout_masks(cfg: dict, shape, rank: int, step: int, device) -> list:
    """The L dropout masks (0 or 1 / (1 - p), ``shape`` (B, T, R)) of the
    program's training step ``step`` on ``rank`` under ``DROPOUT_SEED``,
    drawn as ``parallel/train.py::dropout_masks`` draws them; None where
    the configuration has no dropout."""
    from pytorchwavenetvocoder_tpu_torch.parallel.train import (
        dropout_masks as program_masks,
    )

    return program_masks(_program_config(cfg), shape, DROPOUT_SEED, rank,
                         step, device)


def reference_train_steps(params: dict, cfg: dict, steps: list,
                          mm=torch.matmul, ranks_used=None) -> dict:
    """The reference's Adam steps (``ref.train_steps``) at the
    configuration's ``lr`` and ``weight_decay``, with the program's
    dropout masks, in strict float32; the params and gradients in the
    layout's leaves."""
    ref.strict_float32()
    masks = None
    if cfg.get("dropout", 0.0):
        masks = [[dropout_masks(cfg, (x.shape[0], x.shape[1],
                                      cfg["n_resch"]), r, s, x.device)
                  for r, (x, _h, _t) in enumerate(windows)]
                 for s, windows in enumerate(steps)]
    r = ref.train_steps(model_params(params), cfg, steps, cfg["lr"],
                        cfg["weight_decay"], mm=mm, ranks_used=ranks_used,
                        masks=masks)
    return dict(losses=r["losses"], grad1=_as_layout(r["grad1"], params),
                params=layout_params(r["params"], params))


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def _leaf_gaps(prog: dict, refs: dict, keys) -> list:
    med = float(np.median([refs[k] for k in keys]))
    return [abs(prog[k] - refs[k]) / max(refs[k], med, 1e-30) for k in keys]


def _as_layout(leaves: dict, like: dict) -> dict:
    """``{(group, name): tensor}`` of the program's leaves in the layout's
    leaves."""
    model = {}
    for (g, n), t in leaves.items():
        model.setdefault(g, {})[n] = t
    lay = layout_params(model, like)
    return {(g, n): t for g, d in lay.items() for n, t in d.items()}


def train_numbers(losses: list, grad1: dict, after: dict, theta0: dict,
                  r: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``grad_gap_median``,
    ``grad_diff_median`` and ``update_gap`` of a run's ``losses``, first
    gradient and params after the checked steps (the program's leaves, or
    the layout's), against the reference's ``r`` from ``theta0`` (the
    layout's), as the mu-law WaveNet's are defined."""
    if any(g == "post2" for g, _n in grad1):
        grad1, after = _as_layout(grad1, theta0), _as_layout(after, theta0)
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

#: The reference's product with both operands in float8 e4m3: the
#: precision next below the bfloat16 the configuration states
control_matmul = ref.fp8_matmul


def decode_controls(cell, seed: int, device, fleets) -> dict:
    """``{who: numbers}`` of a decode cell's control on ``fleets``: the
    program's served wavs judged by the reference in float8 at every
    product (``control_fp8``), one precision below the configuration's
    bfloat16; the program lacks a path below bf16 for this model."""
    from port_bench.controls import decode_fleets

    _product["mm"] = control_matmul
    try:
        return {"control_fp8": decode_fleets(cell, seed, device, False,
                                             fleets)}
    finally:
        _product["mm"] = torch.matmul


# ---- the operations and bytes (``bounds.py`` dispatches here) -----------

def dilations(cfg: dict) -> list:
    return [2 ** i for _ in range(cfg["dilation_repeat"])
            for i in range(cfg["dilation_depth"])]


def receptive_field(cfg: dict) -> int:
    return (cfg["kernel_size"] - 1) * sum(dilations(cfg)) + 1


def _layer_macs(cfg: dict) -> int:
    """A layer's multiply-adds for one position: the gate's k taps and the
    aux term (R, A -> 2G), the skip and output 1x1s (G -> S + R)."""
    A, R, S, G, _L, k, _M = _widths(cfg)
    return k * R * 2 * G + A * 2 * G + G * (S + R)


def ar_bound_s(cfg: dict, lengths, quantize: bool = False) -> float:
    """K1, one call over a fleet whose row b needs ``lengths[b]`` steps:
    the bf16 weight pack once, the biases and the post stack, the raw ring
    slots the needed steps read (k - 1 taps) and write, the aux columns
    they use, the samples; the layer and post products in bf16.  The head
    is counted at its 3M columns, the 1x1 input at none (a scaled row)."""
    A, R, S, G, L, k, M = _widths(cfg)
    pack = L * (k * R * 2 * G + A * 2 * G + G * (S + R)) * 2
    other = (L * (2 * G + S + R) * 4 + R * 2 + R * 4 + S * S * 2 + S * 4
             + S * 3 * M * 2 + 3 * M * 4)
    caps = [(k - 1) * d for d in dilations(cfg)]
    ring = sum(min(n * (k - 1), c) + min(n, c)
               for n in lengths for c in caps) * R * 2
    steps = sum(lengths)
    nbytes = pack + other + ring + steps * A * 4 + steps * 4
    ops = 2 * steps * (L * _layer_macs(cfg) + S * S + S * 3 * M)
    return bound_s(nbytes, ops)


def stack_train_bound_s(cfg: dict, B: int, T: int) -> float:
    """A fused training forward of the stack at the MoL widths (the
    program trains this model on the plain route; counted for a later
    training cell): stream0 bf16 and h_up f32 in, the layer weights, the
    L - 1 streams, the saves and the f32 skip sum out."""
    A, R, S, G, L, k, _M = _widths(cfg)
    M_ = B * T
    w = (k * R * 2 * G + A * 2 * G + G * (S + R)) * 2 \
        + (2 * G + S + R) * 4
    nbytes = (M_ * R * 2 + M_ * A * 4 + L * w + (L - 1) * M_ * R * 2
              + L * M_ * 2 * G * 2 + M_ * S * 4)
    return bound_s(nbytes, 2 * M_ * L * _layer_macs(cfg))


def stack_bwd_bound_s(cfg: dict, B: int, T: int) -> float:
    """The stack's backward at the MoL widths: twice the forward's
    products; the streams, saves, aux and dskip in, every gradient out."""
    A, R, S, G, L, k, _M = _widths(cfg)
    M_ = B * T
    nbytes = (M_ * R * 2 * L + L * M_ * 2 * G * 2 + M_ * A * 4 + M_ * S * 4
              + L * (k * R * 2 * G + A * 2 * G + G * (S + R)) * 6
              + M_ * R * 2 + M_ * A * 4)
    return bound_s(nbytes, 4 * M_ * L * _layer_macs(cfg))


def decode_flops_per_sample(cfg: dict) -> float:
    """The plain model's operations for one AR step of one row: each
    layer's gate (its k taps and the aux term), skip and output products,
    and the post stack to the 3M head; the 1x1 input of a scalar is a
    scaled row and counts none."""
    _A, _R, S, _G, L, _k, M = _widths(cfg)
    return 2.0 * (L * _layer_macs(cfg) + S * S + S * 3 * M)


def train_flops_per_position(cfg: dict) -> float:
    """Forward and backward (three times the forward) of one training
    position."""
    _A, _R, S, _G, L, _k, M = _widths(cfg)
    return 3.0 * 2.0 * (L * _layer_macs(cfg) + S * S + S * 3 * M)
