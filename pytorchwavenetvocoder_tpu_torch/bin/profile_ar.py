#!/usr/bin/env python
"""Device time of the AR kernel (K1) on a CUDA card.

Decodes a fleet of random rows with random weights (seeded) at one of the
two flagship configurations, then runs ``torch.profiler`` over ``--steps``
argmax steps of ``ops/ar_kernel.py::ar_generate`` and prints, per CUDA
kernel, its launches and device microseconds per step (the wrapper's
per-call work, such as packing the weights, spread over the steps), the
device-busy sum and the host clock per step.  bf16, and int8 with
``--quantize``: the persistent kernel runs the steps in one launch, whose
device microseconds per step it names on a line of their own, followed by
its phase times per stage and its counter waits (the mean microseconds of
a unit's wait for the stage before it, and the waits per step).

``--turns B1,B2,...`` times the kernel's two gate designs instead (int8
with ``--quantize``), the gate cut into units and the streamed gate, in
turns (units, stream, stream, units; best of each, CUDA events) at each
fleet size, from one carry of the largest sliced, and names the one
``ar_gate`` picks: where ``AR_STREAM_FROM_B`` is read.

``--n_resch`` sets the residual width (default the flagships' 512; the
kernels take it to 2,048).

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.profile_ar --model
ljspeech --batch 16 [--quantize] [--n_resch 2048]``, or ``... --model
ljspeech --turns 128,192,256 [--quantize]``.
"""

from __future__ import annotations

import argparse
import re
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

#: An AR-loop kernel's name as the profiler reports it, demangled
#: (``void ar_persistent_kernel<3, true>(ApArgs)``) or not (``_Z20ar_...``)
AR_LOOP_KERNEL = re.compile(r"(?<![A-Za-z])ar_\w+?_kernel")


#: Throwaway kernels at the head of each trace of ``ar_loop_kernels``
_HEAD = 16


def ar_loop_kernels(fn, tries: int = 5, margin_s: float = 0.25
                    ) -> tuple[list[str], list[str], list[int]]:
    """The AR-loop device kernels that ``torch.profiler`` records while
    ``fn()`` runs on the current card: ``(their names, every device
    kernel's name, the device kernels each trace taken recorded)``.

    A marker kernel (``torch.cuda._sleep``) runs before and after ``fn``,
    ``margin_s`` of host time from the trace's edges, so that a trace can
    be told from one whose device records fell outside its window (the
    profiler drops those): a trace without both markers recorded nothing
    that can be counted and is taken again, at most ``tries`` times, after
    which this raises.  The profiler can also drop a trace's first device
    records (up to 4 seen on an H100 after a long run of small kernels,
    whatever the margin), so ``_HEAD`` throwaway kernels run before the
    first marker.
    """
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    head = torch.zeros(1, device="cuda")
    seen = []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(margin_s)
            for _ in range(_HEAD):
                head.add_(1)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(margin_s)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append(len(names))
        if sum("spin_kernel" in nm for nm in names) == 2:
            loop = [nm for nm in names if AR_LOOP_KERNEL.search(nm)]
            return loop, names, seen
    raise RuntimeError(f"torch.profiler lost device records in {tries} "
                       f"traces (device kernels recorded: {seen}); the last "
                       f"recorded {sorted(set(names))}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="ljspeech")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--quantize", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_resch", type=int, default=512)
    parser.add_argument("--turns", default="",
                        help="comma-separated fleet sizes: time both gate "
                        "designs (int8 with --quantize) in turns at each "
                        "instead of profiling")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ar needs a CUDA device")
    turn_b = [int(b) for b in args.turns.split(",") if b]
    if turn_b:
        args.batch = max(turn_b)
    dev = torch.device("cuda:0")
    cfg = WaveNetConfig(n_resch=args.n_resch, n_skipch=256,
                        dilation_depth=10, dilation_repeat=3,
                        compute_dtype="bfloat16",
                        **MODELS[args.model])
    params = init_wavenet_params(cfg, torch.Generator().manual_seed(args.seed),
                                 dev)
    r = np.random.RandomState(args.seed)
    B, n, T = args.batch, args.steps, cfg.receptive_field
    x = torch.as_tensor(r.randint(0, 256, (B, T)), device=dev)
    h = torch.as_tensor(r.randn(B, T + 3 * n, cfg.n_aux).astype(np.float32),
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if turn_b:
        return turns(params, cfg, carry, h, T0, n, turn_b, args.model, smi,
                     **q)
    gate = ak.ar_gate(cfg, B, args.quantize)
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
    busy = sum(us for _c, us in rows.values())
    print(f"[profile_ar] {args.model} n_resch {cfg.n_resch} "
          f"k={cfg.kernel_size} B={B} "
          f"{'int8' if args.quantize else 'bf16'} x {n} steps "
          f"(gate: {gate}) | {smi}")
    for key, (count, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:9.2f} us/step  {count / n:6.1f} launches/step  "
              f"{key[:90]}")
    loop = [(c, us) for key, (c, us) in rows.items()
            if "ar_persistent_kernel" in key]
    print(f"  the AR loop: {sum(c for c, _ in loop)} launch(es) of "
          f"ar_persistent_kernel for {n} steps, "
          f"{sum(us for _, us in loop):.2f} us/step of device time")
    print(f"  device busy {busy:.1f} us/step, host clock {host_us:.1f} "
          f"us/step, idle share {1 - busy / host_us:.3f}")
    # where a step of the persistent kernel goes, from its phase times
    phases = ak.ar_phase_times(params, cfg, carry, h, T0 + 2 * n, n, **q)
    print("  us per stage (means over the blocks with a unit); waits: us "
          "per counter wait, waits per step:")
    for st, v in phases.items():
        print(f"    {st:8s} " + ", ".join(f"{k} {x:.2f}"
                                           for k, x in v.items()))
    return dict(rows=rows, busy_us=busy, host_us=host_us, phases=phases)


def turns(params, cfg, carry, h, T0: int, n: int, sizes: list, model: str,
          smi: str, quantize: bool = False,
          act_scales: torch.Tensor | None = None) -> dict:
    """Both gate designs (bf16, or int8 with ``quantize``) in turns at each
    fleet size of ``sizes``, n argmax steps a call, from the first rows of
    ``carry``; returns {B: {gate: us/step, "gate": ar_gate's pick}}."""
    def us_per_step(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return 1e3 * t0.elapsed_time(t1) / 3 / n

    out = {}
    for b in sizes:
        c_b = tuple(t[:, :b].contiguous() if i == 0 else t[:b].contiguous()
                    for i, t in enumerate(carry))
        h_b = h[:b].contiguous()
        got = {"units": [], "stream": []}
        for gate in ("units", "stream", "stream", "units"):
            got[gate].append(us_per_step(lambda: ak.ar_generate_on(
                gate, params, cfg, c_b, h_b, T0, n, quantize, act_scales)))
        out[b] = {g: min(v) for g, v in got.items()}
        out[b]["gate"] = ak.ar_gate(cfg, b, quantize)
        print(f"[profile_ar turns] {model} k={cfg.kernel_size} "
              f"{'int8' if quantize else 'bf16'} B={b}: "
              f"gate cut into units {out[b]['units']:.1f} us/step, streamed "
              f"{out[b]['stream']:.1f} (ratio "
              f"{out[b]['stream'] / out[b]['units']:.3f}), ar_gate picks "
              f"{out[b]['gate']} | {smi}", flush=True)
    return out


if __name__ == "__main__":
    main()
