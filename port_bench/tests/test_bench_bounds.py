"""The frozen operation and byte counts against hand counts at small
widths."""

import pytest

from port_bench import bounds

CFG = dict(n_quantize=8, n_aux=2, n_resch=4, n_skipch=3, dilation_depth=2,
           dilation_repeat=1, kernel_size=2)


def test_receptive_field():
    assert bounds.receptive_field(CFG) == 1 * (1 + 2) + 1
    arctic = dict(CFG, dilation_depth=10, dilation_repeat=3)
    assert bounds.receptive_field(arctic) == 3070


def test_decode_flops_per_sample_by_hand():
    # a layer: gate 2 taps x 4 x 8, aux 2 x 8, skip 4 x 3, res 4 x 4;
    # post 3 x 3 + 3 x 8; two layers; two operations a product term
    layer = 2 * 4 * 8 + 2 * 8 + 4 * 3 + 4 * 4
    assert bounds.decode_flops_per_sample(CFG) == 2 * (2 * layer + 9 + 24)


def test_train_flops_per_position_by_hand():
    # the last layer's residual product feeds nothing
    fwd = 2 * (2 * (2 * 4 * 8 + 2 * 8 + 4 * 3) + 1 * 4 * 4 + 9 + 24)
    assert bounds.train_flops_per_position(CFG) == 3 * fwd


def test_ar_bound_counts_the_needed_row_steps():
    # operations: per needed row-step 2 x (layers x (gate + res/skip) + aux
    # + post); the pack once; ragged rows count their own steps
    ops_step = 2 * (2 * (2 * 4 * 8 + 4 * (3 + 4)) + 2 * 2 * 8 + 9 + 24)
    lengths = [5, 1]
    ops = ops_step * sum(lengths)
    caps = [1, 2]
    ring = sum(min(n, c) + min(n, c) for n in lengths for c in caps) * 16
    pack = 2 * 4 * (2 * 2 * 4 + 3 + 4) * 2
    other = (2 * 2 * 8 * 2 + 2 * (8 + 3 + 4) * 4 + 2 * 8 * 4 * 2 + 4 * 4
             + 9 * 2 + 3 * 4 + 24 * 2 + 8 * 4)
    nbytes = pack + other + ring + 6 * 2 * 4 + 6 * 4
    want = max(nbytes / bounds.HBM_BYTES_PER_S, ops / bounds.BF16_FLOPS)
    assert bounds.ar_bound_s(CFG, lengths) == pytest.approx(want, rel=1e-12)
    # a ragged fleet is not counted at its longest row
    assert bounds.ar_bound_s(CFG, [5, 1]) < bounds.ar_bound_s(CFG, [5, 5])


def test_stack_bounds_by_hand():
    B, T, M = 1, 6, 6
    R, S, A, L, k = 4, 3, 2, 2, 2
    ops_f = 2 * M * L * (k * R * 2 * R + A * 2 * R) \
        + 2 * M * (L * R * S + (L - 1) * R * R)
    ops_b = L * 2 * M * (R * R + R * S + 2 * k * R * 2 * R + 2 * 2 * R * A
                         + R * S + R * R)
    # at these widths the bytes bound both
    assert bounds.stack_train_bound_s(CFG, B, T) * bounds.HBM_BYTES_PER_S \
        > ops_f / bounds.BF16_FLOPS * bounds.HBM_BYTES_PER_S
    w = (k * R * 2 * R * 2 + A * 2 * R * 2 + 2 * 2 * R * 4 + R * R * 2
         + R * 4 + R * S * 2 + S * 4)
    nbytes = (M * R * 2 + M * A * 4 + L * w + (L - 1) * M * R * 2
              + L * M * 2 * R * 2 + M * S * 4)
    assert bounds.stack_train_bound_s(CFG, B, T) == pytest.approx(
        nbytes / bounds.HBM_BYTES_PER_S)
    big = dict(CFG, n_resch=512, n_skipch=256, n_aux=28, dilation_depth=10,
               dilation_repeat=3)
    # at the flagship's widths and window the operations bound them
    R, S, A, L = 512, 256, 28, 30
    M = 23040
    ops_f = 2 * M * L * (k * R * 2 * R + A * 2 * R) \
        + 2 * M * (L * R * S + (L - 1) * R * R)
    ops_b = L * 2 * M * (R * R + R * S + 2 * k * R * 2 * R + 2 * 2 * R * A
                         + R * S + R * R)
    assert bounds.stack_train_bound_s(big, 1, M) == pytest.approx(
        ops_f / bounds.BF16_FLOPS)
    assert bounds.stack_bwd_bound_s(big, 1, M) == pytest.approx(
        ops_b / bounds.BF16_FLOPS)
