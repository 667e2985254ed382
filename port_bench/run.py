"""Run one cell of the benchmark and print its result line.

    python3 -m port_bench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by name
(``spec.py``).  The run needs as many CUDA devices as the cell's ``chips``
and refuses to run elsewhere: it exits with code 3 and prints no result.
With ``--trace 0`` the result's metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones, read from a ``torch.profiler``
trace.  The numbers compared for ``correct`` are printed beside their
limits as the last lines of standard error and, under ``checks``, last in
the result.  The run exits with code 4, and prints no result, if JAX, flax
or the JAX package was loaded in this process or in a rank.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

from port_bench import spec

#: The program's and the harness's build and kernel caches, inside the
#: checkout at fixed paths, so that only a checkout's first run builds.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m port_bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def measure(cell, seconds: float, seed: int, trace: bool, device: str,
            t_start: float, backend: str = "nccl",
            step_factory: str | None = None) -> dict:
    """The cell's result, without the device's name: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``memory_peak_bytes``, the
    trace's busy and window seconds and breakdown, ``checks``, and the
    forbidden modules the run's processes held."""
    import torch

    from port_bench import checks

    if cell.kind == "train":
        from port_bench import train_cell

        out = train_cell.run(cell, seconds, seed, device, t_start, trace,
                             backend=backend, step_factory=step_factory)
        numbers = out.pop("numbers")
    else:
        from port_bench import decode_cell
        from port_bench.trace import Traced

        dev = torch.device(device)
        r = decode_cell.run(cell, seconds, seed, dev, t_start,
                            Traced(dev) if trace else None)
        try:
            r.update(config=cell.config, chips=cell.chips)
            metrics = spec.read_metrics(
                cell.per_layer if trace else cell.end_to_end, r)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            fleets = list(range(r["fleets"]))
            rows = decode_cell.fleet_rows_to_check(cell.traffic, fleets,
                                                   r["lengths"], seed)
            numbers = checks.decode(cell.config, cell.traffic, seed, dev,
                                    r["outdir"], fleets, rows)
        finally:
            shutil.rmtree(r["workdir"], ignore_errors=True)
        out = dict(metrics=metrics, attempted=r["utterances"],
                   failed=numbers["wav_errors"],
                   memory_peak_bytes=r["memory_peak_bytes"],
                   modules=checks.forbidden_modules(sys.modules))
        tr = r["trace"]
        if tr is not None:
            out.update(busy_s=tr.busy_s(), trace_window_s=tr.window_s,
                       breakdown=dict(device_ops=tr.top_ops(),
                                      idle_gaps=tr.idle_gaps()))
    correct, compared = checks.judge(numbers, cell.limits)
    out.update(correct=correct, checks=compared)
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = get_parser().parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except KeyError as e:
        print(f"port_bench: {e.args[0]}", file=sys.stderr)
        return 2
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(spec.ROOT / rel)

    import torch

    from port_bench import checks

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = measure(cell, args.seconds, args.seed, bool(args.trace), "cuda",
                  t_start)
    held = sorted(set(out.pop("modules"))
                  | set(checks.forbidden_modules(sys.modules)))
    if held:
        print(f"port_bench: the run loaded {', '.join(held)}",
              file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell.chips,
                  memory_peak_bytes=int(out["memory_peak_bytes"]))
    result = dict(correct=out["correct"], attempted=int(out["attempted"]),
                  failed=int(out["failed"]), metrics=out["metrics"],
                  device=device)
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["trace_window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
