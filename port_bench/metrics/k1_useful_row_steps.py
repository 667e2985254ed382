"""The share of K1's row-steps that decode an utterance's sample: the
utterances' samples over rows x the fleet's longest, summed over the
window's fleets, from the program's counters (``bin/decode.py::
decode_counters``, ``useful_row_steps`` over ``row_steps``), in %.

The counters hold everything the run's process decoded: the window's
fleets and, before them, the set-up's warm-up fleets (one a mode, every
row ``decode_cell.WARMUP_STEPS`` long, so every one of their row-steps
useful), which are taken out."""

from port_bench import traffic as tr
from port_bench.decode_cell import WARMUP_STEPS


def read(run):
    if run["kind"] != "decode":
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_counters,
        )
    except ImportError:     # a program that counts no row-steps
        return None
    counters = decode_counters()
    warm = (len(set(tr.MODES)) * run["config"]["decode_batch_size"]
            * WARMUP_STEPS)
    ran = counters["row_steps"] - warm
    if ran <= 0:
        return None
    return 100.0 * (counters["useful_row_steps"] - warm) / ran
