"""The yardstick's arithmetic: published peaks of one H100 and the least
time the card could take for each kernel's work, frozen so that no later
change to the program moves it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity.  A
bound is the larger of the bytes a kernel must move (each input read once,
each output written once) at the HBM rate and its operations at the peak
rate of their type (``bound_s``).  The operations and bytes of a kernel's
work are the architecture's: every function below but ``bound_s`` takes
the configuration as the dict of ``configs/<name>.json`` and hands it to
the function of the same name in the configuration's architecture module
(``spec.architecture``; ``arch/wavenet-mulaw.py`` by default), so that a
reader reads a new architecture's cell unchanged.
"""

from __future__ import annotations

from port_bench import spec

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def dilations(cfg: dict) -> list:
    return spec.architecture(cfg).dilations(cfg)


def receptive_field(cfg: dict) -> int:
    return spec.architecture(cfg).receptive_field(cfg)


def bound_s(nbytes: float, ops_bf16: float, ops_int8: float = 0.0) -> float:
    """The least seconds for ``nbytes`` of memory traffic and the given
    operations (bf16 and int8 at their own peaks)."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops_bf16 / BF16_FLOPS + ops_int8 / INT8_OPS)


def ar_bound_s(cfg: dict, lengths, quantize: bool = False) -> float:
    """K1, one call over a fleet whose row b needs ``lengths[b]`` steps
    (int8 products under ``quantize``)."""
    return spec.architecture(cfg).ar_bound_s(cfg, lengths, quantize)


def stack_train_bound_s(cfg: dict, B: int, T: int) -> float:
    """K2 in training mode, over B windows of T positions."""
    return spec.architecture(cfg).stack_train_bound_s(cfg, B, T)


def stack_bwd_bound_s(cfg: dict, B: int, T: int) -> float:
    """K3, over B windows of T positions."""
    return spec.architecture(cfg).stack_bwd_bound_s(cfg, B, T)


def decode_flops_per_sample(cfg: dict) -> float:
    """The plain model's operations for one AR step of one row."""
    return spec.architecture(cfg).decode_flops_per_sample(cfg)


def train_flops_per_position(cfg: dict) -> float:
    """Forward and backward of one training position."""
    return spec.architecture(cfg).train_flops_per_position(cfg)
