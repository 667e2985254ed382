"""The share of K1's counter waits whose first poll found the stage before
done, from the program's counters (``bin/decode.py::decode_counters``,
``k1_waits_ready`` over ``k1_waits``), in %: a unit's wait for the units
of the previous stage.  High: the waits sit off the critical path; low:
units wait for each other's rows.

The counters hold every launch of the run's process, the set-up's two
warm-up fleets too (their ``decode_cell.WARMUP_STEPS`` steps against the
window's tens of thousands).  A program without the counters (one whose
stages end in grid barriers) reads nothing."""


def read(run):
    if run["kind"] != "decode":
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_counters,
        )
    except ImportError:
        return None
    counters = decode_counters()
    waits = counters.get("k1_waits", 0)
    if waits <= 0:
        return None
    return 100.0 * counters["k1_waits_ready"] / waits
