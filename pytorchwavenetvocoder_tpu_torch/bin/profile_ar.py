#!/usr/bin/env python
"""Per-launch device time of the AR kernel (K1) on a CUDA card.

Decodes a fleet of random rows with random weights (seeded) at one of the
two flagship configurations, then runs ``torch.profiler`` over ``--steps``
argmax steps of ``ops/ar_kernel.py::ar_generate`` and prints, per CUDA
kernel, its launches and device microseconds per step (the wrapper's
per-call work, such as packing the weights, spread over the steps), the
device-busy sum and the host clock per step.

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.profile_ar --model
ljspeech --batch 16 [--quantize]``.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    WaveNetConfig,
    _pad_seed,
    _warmup_state,
    init_wavenet_params,
)
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak

#: The flagships: arctic-sd (kernel_size 2) and ljspeech-sd (kernel_size 3)
MODELS = {
    "arctic": dict(n_aux=28, kernel_size=2, upsampling_factor=80),
    "ljspeech": dict(n_aux=39, kernel_size=3, upsampling_factor=110),
}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="ljspeech")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--quantize", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ar needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg = WaveNetConfig(n_resch=512, n_skipch=256, dilation_depth=10,
                        dilation_repeat=3, compute_dtype="bfloat16",
                        **MODELS[args.model])
    params = init_wavenet_params(cfg, torch.Generator().manual_seed(args.seed),
                                 dev)
    r = np.random.RandomState(args.seed)
    B, n, T = args.batch, args.steps, cfg.receptive_field
    x = torch.as_tensor(r.randint(0, 256, (B, T)), device=dev)
    h = torch.as_tensor(r.randn(B, T + 2 * n, cfg.n_aux).astype(np.float32),
                        device=dev)
    x, h = _pad_seed(cfg, x, h)
    h = h.contiguous()
    carry, maxes = _warmup_state(params, cfg, x, h, bf16_intermediates=True,
                                 collect_act_maxes=True, impl="cuda")
    q = {}
    if args.quantize:
        scales = ak.act_scales_from_maxes(maxes)
        if cfg.kernel_size > 2:
            carry = (ak.int8_ring_fill(carry[0], scales, cfg),) + carry[1:]
        q = dict(quantize=True, act_scales=scales)
    T0 = x.shape[1]
    ak.ar_generate(params, cfg, carry, h, T0, n, "argmax", **q)   # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        ak.ar_generate(params, cfg, carry, h, T0 + n, n, "argmax", **q)
        torch.cuda.synchronize()
        host_us = 1e6 * (time.time() - t0) / n
    rows = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        # kernel rows only: an aten op's row repeats its kernels' time
        on_device = getattr(e, "device_type", None) == \
            torch.autograd.DeviceType.CUDA
        if dev_us > 0 and on_device and e.key != "Activity Buffer Request":
            rows[e.key] = (e.count, dev_us / n)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    busy = sum(us for _c, us in rows.values())
    print(f"[profile_ar] {args.model} k={cfg.kernel_size} B={B} "
          f"{'int8' if args.quantize else 'bf16'} x {n} steps | {smi}")
    for key, (count, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:9.2f} us/step  {count / n:6.1f} launches/step  "
              f"{key[:90]}")
    print(f"  device busy {busy:.1f} us/step, host clock {host_us:.1f} "
          f"us/step, idle share {1 - busy / host_us:.3f}")
    return dict(rows=rows, busy_us=busy, host_us=host_us)


if __name__ == "__main__":
    main()
