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

``--turns ROOT_A ROOT_B`` times two checkouts of the repo against each
other (an older one unpacked by ``git archive``, and this one): one process
per tree runs that tree's own probe at each ``--variants`` x ``--sizes``
for ``n_steps`` steps, in turns A, B, B, A, and the best of each tree's two
readings is printed per (variant, B).

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.matmul_chain_probe
[B] [n_steps] [variant] [--device cuda|cpu]``, or ``... [n_steps] --turns
ROOT_A ROOT_B [--variants split,spine,int8] [--sizes 16,32,128,256]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
    parser.add_argument("--turns", nargs=2, metavar=("ROOT_A", "ROOT_B"),
                        help="time two checkouts' own probes in turns")
    parser.add_argument("--variants", default="split,spine,int8")
    parser.add_argument("--sizes", default="16,32,128,256")
    return parser


def phase_times(x0, weights, variant: str, n_steps: int) -> dict:
    """One run of the kernel with its phase times on: microseconds per
    unit, means over the blocks' units, of the producer's asking for a
    unit's operands (its issue time, the counter poll excluded) and its
    poll of the rows' counter ("wait"), the consumers' wait for the unit's
    first chunk, its products (and within them the first chunk's arrival to
    the last one's) and its epilogue to the arrival; the polls a wait took;
    and the stage itself (the run's time over 60 n).  The
    producer works a unit ahead of the consumers, so the parts overlap."""
    dev = x0.device
    p = mc.chain_plan(variant, x0.shape[0], dev)
    ph = torch.zeros((p["grid"], mc.PHASE_SLOTS), dtype=torch.int64,
                     device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mc.matmul_chain(x0, weights, variant, n_steps, phases=ph)
    end.record()
    torch.cuda.synchronize(dev)
    ph = ph.double().sum(dim=0).cpu()
    units, waits = ph[4].item(), ph[6].item()
    return {"ask": ph[0].item() / waits / 1e3,
            "ask after the poll": ph[9].item() / waits / 1e3,
            "wait": ph[5].item() / waits / 1e3,
            "first chunk": ph[1].item() / units / 1e3,
            "products": ph[2].item() / units / 1e3,
            "of which chunks arriving": ph[8].item() / units / 1e3,
            "epilogue": ph[3].item() / units / 1e3,
            "polls": ph[7].item() / waits,
            "stage": 1e3 * start.elapsed_time(end) / (60 * n_steps)}


#: One process of ``turns``: the tree at ``root``'s own probe at each
#: (variant, B), one JSON line each
_TURN = """
import json, sys
sys.path.insert(0, {root!r})
from pytorchwavenetvocoder_tpu_torch.bin import matmul_chain_probe as p
for v, b in {configs!r}:
    r = p.main([str(b), str({n}), v])
    print("TURN " + json.dumps([v, b, r["us_per_step"]]), flush=True)
"""


def turns(roots, configs, n_steps: int) -> dict:
    """Each tree's probe at ``configs`` ((variant, B) pairs), one process
    per tree in turns A, B, B, A; returns {(variant, B): (best us/step of
    A, of B)}."""
    got = {}
    for i in (0, 1, 1, 0):
        root = os.path.abspath(roots[i])
        code = _TURN.format(root=root, configs=list(configs), n=n_steps)
        res = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"the probe of {root} failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        for line in res.stdout.splitlines():
            if line.startswith("TURN "):
                v, b, us = json.loads(line[5:])
                got.setdefault((v, b), ([], []))[i].append(us)
    return {k: (min(a), min(b)) for k, (a, b) in got.items()}


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
    if args.turns:
        configs = [(v, int(b)) for v in args.variants.split(",")
                   for b in args.sizes.split(",")]
        res = turns(args.turns, configs, args.n_steps)
        card = card_name(torch.device("cuda"))
        for (v, b), (ua, ub) in res.items():
            print(f"turns {v} B={b}: {args.turns[0]} {ua:.1f} / "
                  f"{args.turns[1]} {ub:.1f} us/step ({ub / ua:.3f}x) | "
                  f"{card}", flush=True)
        return {"turns": res, "card": card}
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
    print(f"chain B={B} variant={variant}: {us:.2f} us/step  "
          f"{rate:.1f} T(FL)OPs (build {build_s:.1f}s) | {card}", flush=True)
    return dict(us_per_step=us, tops=rate, build_s=build_s, out=y, card=card)


if __name__ == "__main__":
    main()
