"""The yardstick's arithmetic: published peaks of one H100 and the least
time the card could take for each kernel's work, frozen here so that no
later change to the program moves it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity.  A
bound is the larger of the bytes a kernel must move (each input read once,
each output written once) at the HBM rate and its operations at the peak
rate of their type.  The K1-K3 counts are copies of ``chip_smoke.py``'s
``ar_bound``, ``stack_bound`` and ``bwd_bound``, with one change: K1 is
counted over the row-steps the utterances need (the sum of each row's
length), not over the rows times the fleet's longest, which a ragged fleet
runs but does not need.

Every function takes the configuration as the dict of
``configs/<name>.json``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def dilations(cfg: dict) -> list:
    return [2 ** i for _ in range(cfg["dilation_repeat"])
            for i in range(cfg["dilation_depth"])]


def receptive_field(cfg: dict) -> int:
    return (cfg["kernel_size"] - 1) * sum(dilations(cfg)) + 1


def _dims(cfg: dict):
    return (cfg["n_resch"], cfg["n_skipch"], cfg["n_aux"],
            cfg["dilation_depth"] * cfg["dilation_repeat"],
            cfg["kernel_size"], cfg["n_quantize"])


def bound_s(nbytes: float, ops_bf16: float, ops_int8: float = 0.0) -> float:
    """The least seconds for ``nbytes`` of memory traffic and the given
    operations (bf16 and int8 at their own peaks)."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops_bf16 / BF16_FLOPS + ops_int8 / INT8_OPS)


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
