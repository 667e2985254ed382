#!/usr/bin/env python
"""Floor probe: the serial WaveNet-shaped matmul chain, nothing else.

The port of ``scripts/matmul_chain_probe.py``: 30 layers of dependent
products at the AR loop's widths (R=512, S=256) on a (B, 512) bf16 carry,
run n_steps times, with no ring, aux, sampling or output.  On a CUDA device
one cooperative kernel (``csrc/matmul_chain.cu``) runs the whole chain, so
its time per step is what a one-kernel AR loop would pay for its serial
spine; ``--device cpu`` runs the plain PyTorch version.  Variants: split
(default), merged, spine, full, dual, int8, int8raw
(``ops/matmul_chain.py``).  Weights and x0 are random, from ``--seed``.

As the script does, it runs the chain once (on a CUDA device that call also
builds the kernels) and then three times on inputs shifted by s * 1e-3,
and prints the best time per step and the rate, with the operations
counted as the script counts them (every column, dead ones included).

``phase_times`` runs the kernel once with its phase times on and returns
where a stage's time goes (``chip_smoke.py`` [K4] prints it).

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.matmul_chain_probe
[B] [n_steps] [variant] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("B", nargs="?", type=int, default=128)
    parser.add_argument("n_steps", nargs="?", type=int, default=4000)
    parser.add_argument("variant", nargs="?", default="split",
                        choices=mc.VARIANTS)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel; the default) or cpu (the "
                             "plain version)")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def phase_times(x0, weights, variant: str, n_steps: int) -> dict:
    """One run of the kernel with its phase times on: microseconds per stage
    (a step is 60), means over the blocks that had a unit, of asking for
    the operands, waiting for them, the products and the sums + epilogue;
    the mean barrier wait over all blocks (a block's arrival to the last
    one's); and the stage itself (the run's time over 60 n).  The marks add
    a block sync per stage."""
    dev = x0.device
    plan = mc.chain_plan(variant, x0.shape[0], dev)
    ph = torch.zeros((plan["grid"], 8), dtype=torch.int64, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mc.matmul_chain(x0, weights, variant, n_steps, phases=ph)
    end.record()
    torch.cuda.synchronize(dev)
    ph = ph.double().cpu()
    work = ph[:, 4] > 0
    stages = ph[work, 4].sum()
    out = {name: (ph[work, k].sum() / stages).item() / 1e3 for k, name in
           enumerate(("ask", "wait", "products", "epilogue"))}
    out["barrier"] = (ph[:, 5].sum() / ph[:, 6].sum()).item() / 1e3
    out["stage"] = 1e3 * start.elapsed_time(end) / (60 * n_steps)
    return out


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; the CPU
    for a CPU device."""
    if dev.type != "cuda":
        return "cpu (plain version)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else \
        f"{torch.cuda.get_device_name(dev)}, power limit not read"


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("matmul_chain_probe: --device cuda (the default) "
                           "needs a CUDA device; torch.cuda.is_available() "
                           "is false (--device cpu runs the plain version)")
    B, n, variant = args.B, args.n_steps, args.variant
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    weights = mc.make_chain_weights(variant, gen, dev)
    x0 = torch.randn((B, mc.R), generator=gen, device=dev).to(torch.bfloat16)

    def run(x):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = mc.matmul_chain(x, weights, variant, n)
            end.record()
            torch.cuda.synchronize(dev)
            return y, start.elapsed_time(end) / 1e3
        t0 = time.time()
        y = mc.matmul_chain(x, weights, variant, n)
        return y, time.time() - t0

    t0 = time.time()
    y, _ = run(x0)
    build_s = time.time() - t0
    times = [run(x0 + s * 1e-3)[1] for s in range(3)]
    el = min(times)
    ops = mc.step_ops(variant, B)
    us = el / n * 1e6
    rate = ops / (el / n) / 1e12
    card = card_name(dev)
    print(f"chain B={B} variant={variant}: {us:.2f} us/step  {rate:.1f} "
          f"T(FL)OPs (build {build_s:.1f}s) | {card}", flush=True)
    return dict(us_per_step=us, tops=rate, build_s=build_s, out=y, card=card)


if __name__ == "__main__":
    main()
