"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
traced window, read back from its Chrome trace.

``Traced`` starts the profiler (CPU and CUDA activity), runs throwaway
kernels before the window because a trace drops its first device records,
and marks the window with a span of its own.  ``Trace`` holds what the
readers need: every device operation (kernels, copies, sets) with its name,
start and length, the benchmark's spans (``record_function``), and the
host operations, all on the profiler's clock in microseconds.
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

WINDOW_SPAN = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
THROWAWAY_KERNELS = 16


class Trace:
    def __init__(self, events: list):
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in events if e.get("cat") in DEVICE_CATS
             and e.get("ph") == "X"), key=lambda d: d[1])
        self.host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                     for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X"]
        win = [h for h in self.host if h[0] == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0, self.t1 = win[0][1], win[0][1] + win[0][2]
        # device operations inside the window, clipped to it
        self.ops = [(n, max(s, self.t0), min(s + d, self.t1))
                    for n, s, d in self.device
                    if s + d > self.t0 and s < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def spans(self, name: str) -> list:
        """(start, end) in microseconds of the benchmark's spans ``name``."""
        return sorted((s, s + d) for n, s, d in self.host if n == name)

    def busy_intervals(self, t0: float | None = None,
                       t1: float | None = None) -> list:
        """The union of device operations in [t0, t1] (default: the
        window), as sorted disjoint (start, end)."""
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        out: list = []
        for _n, s, e in self.ops:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, t0: float | None = None, t1: float | None = None
               ) -> float:
        return sum(e - s for s, e in self.busy_intervals(t0, t1)) * 1e-6

    def op_seconds(self, match) -> float:
        """Summed seconds of the window's device operations whose name
        ``match(name)`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches of the window with no device
        operation, each named by the innermost host operation or span
        running at its middle."""
        busy = self.busy_intervals()
        gaps, at = [], self.t0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inside = [(d, name) for name, hs, d in self.host
                      if hs <= mid <= hs + d and name != WINDOW_SPAN]
            label = min(inside)[1] if inside else "no host operation traced"
            out.append([label[:160], (e - s) * 1e-6])
        return out


class Traced:
    """Profile the block; ``window()`` marks the traced window inside it.
    After the block, ``trace`` holds the parsed ``Trace``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.trace: Trace | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        x = torch.zeros(1, device=self.device)
        for _ in range(THROWAWAY_KERNELS):
            x.add_(1.0)
        _sync(self.device)
        return self

    def window(self):
        return torch.profiler.record_function(WINDOW_SPAN)

    def __exit__(self, *exc):
        _sync(self.device)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)
        return False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
