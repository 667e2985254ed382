"""The reader of K1's counter waits, ``k1_waits_ready``, on hand-made
counters: the share of waits whose first poll found the stage before
done, and nothing on a training run, where no wait was counted, or on a
program without the counters."""

import pytest

from port_bench import spec
from port_bench.tests.test_bench_spans import COUNTERS, _counted, _run


def test_k1_waits_ready_reads_the_share_of_ready_waits(monkeypatch):
    _counted(monkeypatch, dict(COUNTERS, k1_waits=400, k1_waits_ready=300))
    read = spec.reader("k1_waits_ready")
    assert read(_run("decode")) == pytest.approx(75.0, rel=1e-12)
    assert read(_run("train")) is None


@pytest.mark.parametrize("counters", [
    COUNTERS,                                    # a program without them
    dict(COUNTERS, k1_waits=0, k1_waits_ready=0)])  # no K1 launch counted
def test_k1_waits_ready_finds_nothing_without_waits(counters, monkeypatch):
    _counted(monkeypatch, counters)
    assert spec.reader("k1_waits_ready")(_run("decode")) is None


def test_k1_waits_ready_of_a_program_without_counters_finds_nothing(
        monkeypatch):
    import pytorchwavenetvocoder_tpu_torch.bin.decode as decode

    monkeypatch.delattr(decode, "decode_counters")
    assert spec.reader("k1_waits_ready")(_run("decode")) is None
