"""A decode cell: fleets of utterances through the program's decode entry,
``bin/decode.py::decode_batches``, as ``decode_rank`` feeds it (a
``BackgroundGenerator`` over the fleets), with the program's writer
thread writing each utterance's wav.

Set-up makes the weights on the device, builds the program's model (the
configuration's architecture's ``decoder``: the mu-law WaveNet's
``WaveNet``), and decodes one short fleet (``WARMUP_STEPS`` steps) of
the cell's rows in each mode the window uses, so every kernel is built
and every shape of the window warmed.  The traffic's ``quantize``
(default false) decodes on the program's int8 path, in the warm-up and
the window alike.  The window then decodes fleets while the next one is
due to end nearer to ``--seconds`` than the last: the first fleet
always, fleet i > 0 only while the elapsed time plus half the last
fleet's wall time is within ``--seconds``.  Consecutive fleets of one
mode share one ``decode_batches`` call; the window closes when the last
call returns, its writer joined.

After the window the wavs are read back and judged (``checks.py``): the
longest row and ``check_rows`` - 1 others drawn from the seed in every
fleet.
"""

from __future__ import annotations

import itertools
import os
import shutil
import tempfile
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from port_bench import traffic as tr
from port_bench.phases import Phases
from port_bench.weights import make_params

FLEET_SPAN = "port_bench.fleet"
CALL_SPAN = "port_bench.decode_batches"
#: The warm-up fleet's index: one no window reaches
WARMUP_FLEET = 2 ** 31
#: The steps of the warm-up fleet in each mode
WARMUP_STEPS = 64


class _Fleets:
    """The window's fleets, pulled one by one under the window's rule."""

    def __init__(self, source, seconds: float):
        self.source = source
        self.seconds = seconds
        self.t0 = None
        self.starts: list = []
        self.closed = False

    def _may_start(self, i: int) -> bool:
        if i == 0:
            return True
        now = time.perf_counter()
        return (now - self.t0) + 0.5 * (now - self.starts[-1]) <= self.seconds

    def of_mode(self, mode: str):
        """The next fleets of ``mode``, while the rule lets them start."""
        while not self.closed:
            i = len(self.starts)
            if tr.fleet_mode(i) != mode:
                return
            if not self._may_start(i):
                self.closed = True
                return
            try:
                item = next(self.source)
            except StopIteration:
                self.closed = True
                return
            self.starts.append(time.perf_counter())
            yield item


class _Spanned:
    """The model as ``decode_batches`` sees it, with a span around each
    fleet's call into ``models.wavenet``."""

    def __init__(self, model):
        self.model = model
        self.config = model.config

    def batch_fast_generate(self, *args, **kwargs):
        with torch.profiler.record_function(FLEET_SPAN):
            return self.model.batch_fast_generate(*args, **kwargs)


def _feeder(traffic, cfg, seed, stop: threading.Event):
    for i in itertools.count():
        if stop.is_set():
            return
        yield tr.fleet(traffic, cfg, seed, i)


def run(cell, seconds: float, seed: int, device, t_start: float,
        traced=None) -> dict:
    """Set up, measure, and return what the readers and checks need.
    ``traced``: a ``trace.Traced`` for a ``--trace 1`` run."""
    from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
    from pytorchwavenetvocoder_tpu_torch.utils import BackgroundGenerator

    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    phases = Phases(t_start)
    phases.mark("start to cell")
    model = _Spanned(cell.arch.decoder(cfg, make_params(cfg, seed, device),
                                       device))
    phases.mark("weights")
    workdir = tempfile.mkdtemp(prefix="port_bench_decode_")
    quantize = bool(traffic.get("quantize", False))
    B = cfg["decode_batch_size"]
    try:
        # warm-up: the cell's rows, a few steps each, in every mode
        ids, (x, h, _n) = tr.fleet(traffic, cfg, seed, WARMUP_FLEET)
        frames = -(-WARMUP_STEPS // cfg["upsampling_factor"]) + 1
        for mode in sorted(set(tr.MODES)):
            decode_batches(model, [(ids, (x, h[:, :frames],
                                          [WARMUP_STEPS] * B))],
                           os.path.join(workdir, "warm"), mode=mode,
                           generator=torch.Generator().manual_seed(1),
                           fs=cfg["fs"], quantize=quantize)
        _sync(device)
        phases.mark("warm-up fleets")

        stop = threading.Event()
        source = BackgroundGenerator(
            _feeder(traffic, cfg, seed, stop), max_prefetch=2)
        fleets = _Fleets(source, seconds)
        gen = tr.sampling_generator(seed)
        outdir = os.path.join(workdir, "wav")
        records = []
        phases.report()
        with (traced if traced is not None else nullcontext()), \
                (traced.window() if traced is not None else nullcontext()):
            t_window = time.perf_counter()
            fleets.t0 = t_window
            while not fleets.closed:
                mode = tr.fleet_mode(len(fleets.starts))
                with torch.profiler.record_function(CALL_SPAN):
                    res = decode_batches(model, fleets.of_mode(mode), outdir,
                                         mode=mode, generator=gen,
                                         fs=cfg["fs"], quantize=quantize)
                records += res["batches"]
                if not res["batches"]:
                    break
            window_s = time.perf_counter() - t_window
        stop.set()
        while True:         # let the feeder thread end
            try:
                next(source)
            except StopIteration:
                break
        source.join(timeout=60)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        n_fleets = len(records)
        lengths = [tr.fleet(traffic, cfg, seed, i)[1][2]
                   for i in range(n_fleets)]
        return dict(kind="decode", workdir=workdir, outdir=outdir,
                    setup_s=t_window - t_start, window_s=window_s,
                    fleets=n_fleets, lengths=lengths, quantize=quantize,
                    samples=int(sum(sum(n) for n in lengths)),
                    utterances=int(sum(len(n) for n in lengths)),
                    ar_steps=int(sum(max(n) for n in lengths)),
                    memory_peak_bytes=peak,
                    trace=None if traced is None else traced.trace)
    except BaseException:
        shutil.rmtree(workdir, ignore_errors=True)
        raise


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fleet_rows_to_check(traffic: dict, fleets: list, lengths: list,
                        seed: int) -> list:
    """(fleet, row) pairs the reference judges: in each of the ``fleets``
    (indices, with each one's row lengths in ``lengths``) its longest row
    and ``check_rows`` - 1 others drawn from the seed."""
    out = []
    for i, n in zip(fleets, lengths):
        longest = int(np.argmax(n))
        rest = [b for b in range(len(n)) if b != longest]
        rng = np.random.default_rng([seed % 2 ** 64, 11, i])
        pick = rng.choice(len(rest), size=min(len(rest),
                                              traffic["check_rows"] - 1),
                          replace=False)
        out += [(i, longest)] + [(i, rest[j]) for j in sorted(pick)]
    return out
