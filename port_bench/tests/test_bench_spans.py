"""The readers of the program's spans and counters, on hand-made traces
and runs: each reads its value, and reads nothing where the program
recorded no such span or counter (as a program without them); the
row-step share of a decode window on the CPU equals the count from its
fleets' lengths."""

import shutil
import sys

import pytest

from port_bench import decode_cell, spec
from port_bench import traffic as tr
from port_bench.tests import tiny
from port_bench.trace import WINDOW_SPAN, Trace


def _trace(*spans):
    """A trace of a 10 ms window holding host spans (name, start us,
    length us)."""
    return Trace([dict(name=n, ts=s, dur=d, ph="X", cat="user_annotation")
                  for n, s, d in ((WINDOW_SPAN, 0.0, 10000.0),) + spans])


DECODE = (
    ("decode.next_fleet", 100.0, 10.0), ("decode.next_fleet", 3000.0, 30.0),
    ("decode.next_fleet", 6000.0, 5.0), ("decode.next_fleet", -50.0, 40.0),
    ("wavenet.pack", 200.0, 100.0), ("wavenet.pack", 220.0, 30.0),
    ("wavenet.pack", 3100.0, 10.0),
    ("decode.writer_join", 2000.0, 200.0),
    ("decode.writer_join", 9000.0, 400.0))
TRAIN = (
    ("train.step", 100.0, 300.0), ("train.batch_in", 100.0, 200.0),
    ("train.step", 500.0, 400.0), ("train.batch_in", 500.0, 300.0))
#: a window's 17 useful of 27 row-steps, after two warm-up fleets of 4
#: rows x 64 steps
WARM = 2 * 4 * decode_cell.WARMUP_STEPS
COUNTERS = dict(ar_persistent=4, ar_persistent_int8=0, layer_stack_fwd=4,
                row_steps=27 + WARM, useful_row_steps=17 + WARM)

# (metric, kind, what it reads): a wait of 45 us over 2 fleets (the span
# before the window left out); joins of 200 and 400 us; packs of 100 us
# (one holding another) and 10 us over 2 fleets; 17 of 27 row-steps;
# copies of 200 and 300 us and steps of 300 and 400 us over 2 steps
CASES = [("fleet_wait_ms", "decode", 0.0225),
         ("writer_join_ms", "decode", 0.3),
         ("pack_ms_per_fleet", "decode", 0.055),
         ("k1_useful_row_steps", "decode", 100.0 * 17 / 27),
         ("batch_in_ms", "train", 0.25),
         ("batch_in_ms.dp4", "train", 0.25),
         ("step_host_ms", "train", 0.1),
         ("step_host_ms.dp4", "train", 0.1)]


def _run(kind, trace=True):
    if kind == "decode":
        return dict(kind="decode", fleets=2, config=tiny.CONFIG,
                    trace=_trace(*DECODE) if trace else _trace())
    return dict(kind="train", traced_steps=2,
                trace=_trace(*TRAIN) if trace else _trace())


def _counted(monkeypatch, counters):
    """The program's decode counters read as ``counters``."""
    import pytorchwavenetvocoder_tpu_torch.bin.decode as decode

    monkeypatch.setattr(decode, "decode_counters", lambda: dict(counters))


@pytest.mark.parametrize("metric, kind, want", CASES)
def test_reader_reads_the_program_s_records(metric, kind, want, monkeypatch):
    _counted(monkeypatch, COUNTERS)
    assert spec.reader(metric)(_run(kind)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric, kind, _want", CASES)
def test_reader_finds_nothing_without_the_program_s_records(metric, kind,
                                                            _want,
                                                            monkeypatch):
    # the warm-up fleets alone: no window row-step counted
    _counted(monkeypatch, dict(COUNTERS, row_steps=WARM,
                               useful_row_steps=WARM))
    read = spec.reader(metric)
    assert read(_run(kind, trace=False)) is None
    other = "train" if kind == "decode" else "decode"
    assert read(_run(other)) is None


@pytest.mark.parametrize("metric, kind, _want", CASES)
def test_reader_of_a_program_without_them_finds_nothing(metric, kind, _want,
                                                        monkeypatch):
    import pytorchwavenetvocoder_tpu_torch.bin.decode as decode

    monkeypatch.setitem(sys.modules,
                        "pytorchwavenetvocoder_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(decode, "decode_counters")
    assert spec.reader(metric)(_run(kind)) is None


def test_row_step_share_of_a_window_is_the_fleets_count(monkeypatch):
    """A tiny decode window on the CPU in a fresh count (as a run's own
    process): the reader's share equals the one from the fleets' lengths,
    the warm-up fleets taken out."""
    from pytorchwavenetvocoder_tpu_torch.models import wavenet

    monkeypatch.setattr(wavenet, "ROW_STEPS", dict(run=0, useful=0))
    cell, seed = tiny.cell("decode"), 2 ** 31 + 91
    r = decode_cell.run(cell, 0.5, seed, "cpu", 0.0)
    shutil.rmtree(r["workdir"], ignore_errors=True)
    lengths = [tr.fleet(cell.traffic, cell.config, seed, i)[1][2]
               for i in range(r["fleets"])]
    want = 100.0 * sum(map(sum, lengths)) / sum(len(n) * max(n)
                                                 for n in lengths)
    run = dict(r, config=cell.config)
    assert want < 100.0
    assert spec.reader("k1_useful_row_steps")(run) == pytest.approx(
        want, rel=1e-12)
