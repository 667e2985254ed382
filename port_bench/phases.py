"""Where a run's set-up goes: named marks on the host clock, printed to
standard error before the window (not a metric; for reading set-up)."""

from __future__ import annotations

import sys
import time


class Phases:
    def __init__(self, t_start: float, who: str = ""):
        self.marks = [("start", t_start)]
        self.who = who

    def mark(self, name: str) -> float:
        t = time.perf_counter()
        self.marks.append((name, t))
        return t

    def report(self) -> None:
        parts = [f"{n} {t - p:.2f} s" for (_, p), (n, t)
                 in zip(self.marks, self.marks[1:])]
        # one write, so that ranks' lines do not interleave
        sys.stderr.write(f"port_bench set-up{self.who}: "
                         + ", ".join(parts) + "\n")
        sys.stderr.flush()
