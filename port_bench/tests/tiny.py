"""Cells at a size the CPU runs in seconds, for the harness's own tests:
the program's plain PyTorch path on the CPU, float32 so that the sound
program reads close to nought."""

from __future__ import annotations

import json

from port_bench import spec

CONFIG = dict(n_quantize=256, n_aux=5, n_resch=16, n_skipch=16,
              dilation_depth=3, dilation_repeat=1, kernel_size=2,
              upsampling_factor=4, compute_dtype="float32", fs=16000,
              lr=1e-3, weight_decay=0.0, batch_length=40, batch_size=1,
              decode_batch_size=4)
DECODE = dict(kind="decode",
              durations=dict(dist="lognormal", median_s=0.003, sigma=0.25),
              check_rows=2)
TRAIN = dict(kind="train", ranks=1)
LIMITS = dict(wav_errors=0, greedy_gap=1e-3, sampled_gap=1e-3, loss_gap=1e-4,
              grad_gap=1e-3, grad_gap_median=1e-3, grad_diff_median=1e-3,
              update_gap=1e-3, route_off=0)


def cell(kind: str, ranks: int = 1, kernel_size: int = 2) -> spec.Cell:
    """A tiny cell measured with the metrics of the real cell of its kind."""
    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    like = {"decode": "arctic-sd.decode-b32",
            "train": "arctic-sd.train-dp4" if ranks > 1
            else "arctic-sd.train-t23040"}[kind]
    traffic = dict(DECODE) if kind == "decode" else dict(TRAIN, ranks=ranks)
    names = (("wav_errors", "greedy_gap", "sampled_gap") if kind == "decode"
             else ("loss_gap", "grad_gap", "grad_gap_median",
                   "grad_diff_median", "update_gap", "route_off"))
    return spec.Cell(
        name=like, chips=1,
        config=dict(CONFIG, kernel_size=kernel_size, batch_size=ranks),
        traffic=traffic, limits={k: LIMITS[k] for k in names},
        end_to_end=[m for m in bench["end_to_end"] if spec._applies(m, like)],
        per_layer=[m for m in bench["per_layer"] if spec._applies(m, like)])
