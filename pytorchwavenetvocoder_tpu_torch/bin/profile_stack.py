#!/usr/bin/env python
"""Device time of the layer-stack kernels (K2 training mode and K3) on a
CUDA card.

At one of the two flagship configurations, with random weights and inputs
(seeded), at the flagship training window (``--batch_length`` 20000 ->
T = 23,040 arctic, 15000 -> 21,120 ljspeech; B = 1), runs one training
forward (``ops/train_kernel.py::layer_stack_fwd_train``) and its backward
(``layer_stack_bwd``): prints each wrapper's time (CUDA events, the mean of
``--reps`` calls after one unmeasured call), then ``torch.profiler``'s
device microseconds per kernel over one forward and backward, summed by
kernel name (one row per product-core instance, the reductions and the
column sums, and PyTorch's own copies in the wrappers: the weights packed
and cast per call), and the card's name and power limit.

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.profile_stack --model
arctic``.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    WaveNetConfig,
    init_wavenet_params,
)
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

#: The flagships: arctic-sd (kernel_size 2) and ljspeech-sd (kernel_size 3),
#: with the window their recipes' --batch_length gives
MODELS = {
    "arctic": dict(n_aux=28, kernel_size=2, upsampling_factor=80, T=23040),
    "ljspeech": dict(n_aux=39, kernel_size=3, upsampling_factor=110, T=21120),
}


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else torch.cuda.get_device_name(0))


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="arctic")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_stack: no CUDA device (the kernels have no "
                         "CPU mode, and a CPU time is no device time)")
    from torch.profiler import ProfilerActivity, profile

    m = dict(MODELS[args.model])
    T = m.pop("T")
    cfg = WaveNetConfig(n_quantize=256, n_resch=512, n_skipch=256,
                        dilation_depth=10, dilation_repeat=3,
                        compute_dtype="bfloat16", **m)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(args.seed)
    lw = tk.layer_weights(init_wavenet_params(cfg, gen, device=dev))
    s0 = (0.5 * torch.randn((1, T, cfg.n_resch), generator=gen)).to(
        dev, torch.bfloat16)
    h = torch.randn((1, T, cfg.n_aux), generator=gen).to(dev)
    dskip = 1e-3 * torch.randn((1, T, cfg.n_skipch), generator=gen).to(dev)

    def fwd():
        return tk.layer_stack_fwd_train(lw, cfg, s0, h)

    _, streams, st = fwd()

    def bwd():
        return tk.layer_stack_bwd(lw, cfg, s0, streams, st, h, dskip)

    fwd_ms, bwd_ms = event_ms(fwd, args.reps), event_ms(bwd, args.reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd()
        bwd()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            r = rows.setdefault(ev.name, [0, 0.0])
            r[0] += 1
            us = getattr(ev, "device_time", None)
            r[1] += ev.cuda_time if us is None else us
    print(f"[profile_stack] {args.model} B=1 T={T} k={cfg.kernel_size}: "
          f"K2 train {fwd_ms:.3f} ms, K3 {bwd_ms:.3f} ms (CUDA events, mean "
          f"of {args.reps}) | {card()}", flush=True)
    print("[profile_stack] device us over one forward and backward, by "
          "kernel (launches):")
    total = 0.0
    for name, (n, us) in sorted(rows.items(), key=lambda i: -i[1][1]):
        total += us
        print(f"    {us:10.1f} us  {n:4d}  {name[:110]}")
    print(f"    {total:10.1f} us  device busy in all", flush=True)
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, rows=rows)


if __name__ == "__main__":
    main()
