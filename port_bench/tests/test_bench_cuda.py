"""The controls on the card, at the cells' own sizes, one seed each: the
program's int8 decode fails a decode cell's limits, the float8 reference
in the program's place fails a training cell's, and so do the faults of
data-parallel training.  Marked ``cuda``: they skip without a card.

    python -m pytest -q -m cuda port_bench/tests/test_bench_cuda.py
"""

import pytest
import torch

from port_bench import checks, controls, spec

pytestmark = pytest.mark.cuda
SEED = 2 ** 31 + 4242


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("name", ["arctic-sd.decode-b32",
                                  "ljspeech-sd.decode-b256"])
def test_int8_decode_fails_the_limits(name, device):
    cell = spec.load_cell(name)
    correct, compared = checks.judge(
        controls.decode_fleets(cell, SEED, device, quantize=True),
        cell.limits)
    assert not correct, compared


@pytest.mark.parametrize("name", ["arctic-sd.train-t23040",
                                  "arctic-sd.train-dp4"])
def test_training_controls_fail_the_limits(name, device):
    cell = spec.load_cell(name)
    for who, numbers in controls.reference_controls(cell, SEED,
                                                    device).items():
        correct, compared = checks.judge(dict(numbers, route_off=0.0),
                                         cell.limits)
        assert not correct, (who, compared)
