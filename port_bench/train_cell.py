"""A training cell: steps of the program's training step
(``parallel/train.py::make_train_step``'s ``step_fn``) on one device, or
data-parallel over ranks (``parallel/distributed.py::spawn_local``, one
process a card, the gradients averaged by ``all_reduce_mean``).

Set-up builds one training state from the seed's weights (broadcast from
rank 0, so every rank starts alike) and drives it through its first steps
on distinct windows, keeping what the comparison needs: each step's loss,
the first step's gradient as the optimizer holds it, and the params after
the checked steps (``checks.CHECKED_STEPS``).  ``ESTIMATE_STEPS`` more
steps, timed with CUDA events, give the step time, from which rank 0 fixes the window's step count for every rank:
the steps that fill ``--seconds``.  The window runs them as
``bin/train.py::train_loop``'s body does (the numpy batch moved in by the
step, the loss summed on the device and read once at the end), with a
CUDA event after every step.  A ``--trace 1`` run traces
``TRACE_STEPS`` steps in the middle of the window.  The configuration's
``batch_size`` is the global batch: one window a rank a step, so it has
to equal the traffic's ``ranks``.

Rank 0 then frees the program's state and runs the reference
(``checks.train``) and the metric readers.
"""

from __future__ import annotations

import importlib
import math
import sys
import time

import numpy as np
import torch

from port_bench import traffic as tr
from port_bench.phases import Phases
from port_bench.weights import make_params

#: Steps timed in set-up to fix the window's step count
ESTIMATE_STEPS = 10
#: Steps a ``--trace 1`` run traces, from the middle of the window
TRACE_STEPS = 60


def _factory(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Step times on the device (CUDA events), or on the host elsewhere."""

    def __init__(self, device: torch.device, n: int):
        self.cuda = device.type == "cuda"
        self.marks = ([torch.cuda.Event(enable_timing=True)
                       for _ in range(n + 1)] if self.cuda else [0.0] * (n + 1))

    def mark(self, i: int) -> None:
        if self.cuda:
            self.marks[i].record()
        else:
            self.marks[i] = time.perf_counter()

    def elapsed_ms(self, i: int, j: int) -> float:
        if self.cuda:
            return self.marks[i].elapsed_time(self.marks[j])
        return 1e3 * (self.marks[j] - self.marks[i])

    def intervals_ms(self, n: int) -> list:
        return [self.elapsed_ms(i, i + 1) for i in range(n)]


def build(cell, seed: int, info, step_factory: str | None = None):
    """The training state from the seed's weights (rank 0's, broadcast),
    the step (the architecture's ``STEP_FACTORY``, or ``step_factory`` in
    its place), and this rank's batches."""
    import torch.distributed as dist

    from pytorchwavenetvocoder_tpu_torch.convert import param_leaves

    cfg = cell.config
    params = make_params(cfg, seed, info.device, bf16_values=False)
    if info.world > 1:
        for _g, _n, t in param_leaves(params):
            dist.broadcast(t, 0)
    state, step_fn = cell.arch.train_step(
        cfg, params, _factory(step_factory or cell.arch.STEP_FACTORY),
        info.world)
    return state, step_fn, tr.rank_batches(cell.traffic, cfg, seed,
                                           info.rank)


def first_steps(state, step_fn, batches: list, checked: int, rank: int):
    """Drive the state through its checked steps; returns each step's
    loss, and on rank 0 the first step's gradient as the optimizer's first
    moment holds it and the params after the last (on the host)."""
    from port_bench import checks

    keys = [(g, n) for g in state.params for n in state.params[g]]
    losses, grad1 = [], None
    for s in range(checked):
        state, loss = step_fn(state, *batches[s % len(batches)])
        losses.append(loss.detach().clone())
        if s == 0 and rank == 0:
            grad1 = {}
            for g, n in keys:
                p = state.params[g][n]
                moment = state.optimizer.state.get(p, {}).get("exp_avg")
                grad1[(g, n)] = (torch.zeros_like(p) if moment is None else
                                 moment / (1.0 - checks.ADAM_BETA1)).cpu()
    after = ({(g, n): state.params[g][n].detach().to("cpu", copy=True)
              for g, n in keys} if rank == 0 else None)
    return [float(v) for v in losses], grad1, after


def rank_main(info, job: dict) -> dict:
    """One rank of a training cell (all of it where the cell has one)."""
    import torch.distributed as dist

    from port_bench import checks, spec
    from port_bench.trace import Traced

    cell, seed, seconds = job["cell"], job["seed"], job["seconds"]
    cfg, traffic = cell.config, cell.traffic
    dev, world, rank = info.device, info.world, info.rank
    phases = Phases(job["t_start"], f" (rank {rank})")
    phases.mark("start to rank")
    state, step_fn, batches = build(cell, seed, info, job["step_factory"])
    phases.mark("weights, state and batches")
    W = len(batches)
    checked = checks.CHECKED_STEPS
    losses, grad1, after = first_steps(state, step_fn, batches, checked,
                                       rank)
    phases.mark("checked steps")

    # the step time, and from it the window's steps
    est = ESTIMATE_STEPS
    clock = _Clock(dev, est)
    clock.mark(0)
    for i in range(est):
        state, _loss = step_fn(state, *batches[(checked + i) % W])
    clock.mark(est)
    _sync(dev)
    t_step = clock.elapsed_ms(0, est) / 1e3 / est
    n = steps_for(seconds, t_step)
    if world > 1:
        box = torch.tensor([n], device=dev)
        dist.broadcast(box, 0)
        n = int(box)
        dist.barrier()
    _sync(dev)
    phases.mark("step time")

    # the window
    k0 = checked + est
    a = n // 2
    b = min(n, a + TRACE_STEPS)
    traced = Traced(dev) if job["trace"] else None
    span = None
    clock = _Clock(dev, n)
    loss_acc = torch.zeros((), dtype=torch.float64, device=dev)
    phases.report()
    t_window = time.perf_counter()
    clock.mark(0)
    for i in range(n):
        if traced is not None and i == a:
            _sync(dev)
            traced.__enter__()
            span = traced.window()
            span.__enter__()
        state, loss = step_fn(state, *batches[(k0 + i) % W])
        loss_acc += loss
        clock.mark(i + 1)
        if traced is not None and i == b - 1:
            _sync(dev)
            span.__exit__(None, None, None)
            traced.__exit__(None, None, None)
    loss_mean = float(loss_acc) / n
    window_s = time.perf_counter() - t_window
    step_ms = clock.intervals_ms(n)
    route = step_fn.route
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del state, step_fn, loss, loss_acc
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    trace = None if traced is None else traced.trace
    out = dict(rank=rank, memory_peak_bytes=peak,
               busy_s=None if trace is None else trace.busy_s(),
               modules=checks.forbidden_modules(sys.modules))
    if rank != 0:
        return out
    run = dict(kind="train", config=cfg, chips=world,
               setup_s=t_window - job["t_start"], window_s=window_s,
               steps=n, step_ms=step_ms,
               window_positions=tr.window_length(cfg), trace=trace,
               traced_steps=(b - a) if trace is not None else 0)
    out.update(
        metrics=spec.read_metrics(
            cell.per_layer if job["trace"] else cell.end_to_end, run),
        numbers=checks.train(cell, seed, dev, losses, grad1, after, world,
                             route),
        attempted=n, failed=0 if np.isfinite(loss_mean) else n)
    if trace is not None:
        out.update(trace_window_s=trace.window_s,
                   breakdown=dict(device_ops=trace.top_ops(),
                                  idle_gaps=trace.idle_gaps()))
    return out


def run(cell, seconds: float, seed: int, device: str, t_start: float,
        trace: bool, backend: str = "nccl",
        step_factory: str | None = None) -> dict:
    """Run the cell's ranks and merge what they return: rank 0's run, the
    fullest device's peak, the ranks' mean busy seconds."""
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        RankInfo,
        spawn_local,
    )

    ranks = cell.traffic["ranks"]
    if cell.config["batch_size"] != ranks:
        raise ValueError(f"{cell.name}: the configuration's batch_size "
                         f"{cell.config['batch_size']} is not one window a "
                         f"rank over the traffic's {ranks} ranks")
    job = dict(cell=cell, seed=seed, seconds=seconds, trace=trace,
               t_start=t_start, step_factory=step_factory)
    if ranks == 1:
        outs = [rank_main(RankInfo.alone(device), job)]
    else:
        if torch.device(device).type == "cuda":
            # one nvcc build here, not one per rank (host only: no CUDA)
            from pytorchwavenetvocoder_tpu_torch._build import build_kernels

            build_kernels()
        here = importlib.import_module("port_bench.train_cell")
        outs = spawn_local(ranks, here.rank_main, (job,), device_arg=device,
                           backend=backend)
    head = outs[0]
    busy = [o["busy_s"] for o in outs if o["busy_s"] is not None]
    head["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    head["busy_s"] = float(np.mean(busy)) if busy else None
    head["modules"] = sorted({m for o in outs for m in o["modules"]})
    return head


def steps_for(seconds: float, step_s: float) -> int:
    """The steps whose time is nearest ``seconds`` (one at least)."""
    return max(1, int(math.floor(seconds / step_s + 0.5)))
