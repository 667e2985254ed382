"""A run with the timed path broken underneath comes out not correct:
the harness's run at a tiny size on the CPU (its look for a card
skipped), once sound and once for each fault a cell can have."""

import pytest
import torch

from port_bench import run
from port_bench.tests import tiny

SEED = 2 ** 31 + 77


def _measure(cell, step_factory=None):
    return run.measure(cell, 0.5, SEED, False, "cpu", 0.0, backend="gloo",
                       step_factory=step_factory)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [2, 3])
def test_sound_decode_is_correct(k):
    out = _measure(tiny.cell("decode", kernel_size=k))
    assert out["correct"], out["checks"]
    assert out["checks"]["greedy_gap"]["value"] < 1e-4
    assert out["checks"]["sampled_gap"]["value"] < 1e-4
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("quantize", [False, True])
def test_the_traffic_chooses_the_int8_path(quantize, monkeypatch):
    from pytorchwavenetvocoder_tpu_torch.models import wavenet

    real, seen = wavenet.batch_fast_generate, set()

    def spy(*args, **kwargs):
        seen.add(kwargs["quantize"])
        return real(*args, **kwargs)
    monkeypatch.setattr(wavenet, "batch_fast_generate", spy)
    cell = tiny.cell("decode")
    cell.traffic = dict(cell.traffic, quantize=quantize)
    out = _measure(cell)
    assert seen == {quantize}
    assert out["failed"] == 0 and out["checks"]["wav_errors"]["value"] == 0


def _alter_token(monkeypatch):
    from pytorchwavenetvocoder_tpu_torch.models import wavenet

    real = wavenet._generate_loop

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, 5] = (out[0, 5] + 128) % 256
        return out
    monkeypatch.setattr(wavenet, "_generate_loop", altered)


def _drop_half(monkeypatch):
    from pytorchwavenetvocoder_tpu_torch.models import wavenet

    real = wavenet.batch_fast_generate

    def half(*args, **kwargs):
        out = real(*args, **kwargs)
        return out[: len(out) // 2]
    monkeypatch.setattr(wavenet, "batch_fast_generate", half)


def _state_unchanged(monkeypatch):
    from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel

    real = ar_kernel.ar_step_logits

    def stale(weights, config, act_buf, *args, **kwargs):
        return real(weights, config, act_buf.clone(), *args, **kwargs)
    monkeypatch.setattr(ar_kernel, "ar_step_logits", stale)


def _sampler(monkeypatch, broken):
    from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel

    real = ar_kernel._sample

    def sample(logits, mode, generator):
        if mode != "sampling":
            return real(logits, mode, generator)
        return broken(real, logits, generator)
    monkeypatch.setattr(ar_kernel, "_sample", sample)


def _sampler_temperature(monkeypatch):
    _sampler(monkeypatch, lambda real, logits, g: real(0.5 * logits,
                                                       "sampling", g))


def _sampler_noise_stale(monkeypatch):
    first = []

    def stale(real, logits, g):
        u = torch.rand(logits.shape, generator=g, dtype=torch.float64)
        first.append(u)
        return (logits.double() - torch.log(-torch.log(first[0]))).argmax(-1)
    _sampler(monkeypatch, stale)


@pytest.mark.parametrize("fault", [_alter_token, _drop_half,
                                   _state_unchanged, _sampler_temperature,
                                   _sampler_noise_stale],
                         ids=["token_altered", "half_the_fleet_left_out",
                              "ring_state_unchanged", "sampler_temperature",
                              "sampler_noise_stale"])
def test_decode_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _measure(tiny.cell("decode"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_sampler_temperature,
                                   _sampler_noise_stale],
                         ids=["sampler_temperature", "sampler_noise_stale"])
def test_a_sampler_fault_fails_the_sampled_fleets(fault, monkeypatch):
    fault(monkeypatch)
    checks = _measure(tiny.cell("decode"))["checks"]
    assert checks["greedy_gap"]["value"] <= checks["greedy_gap"]["limit"]
    assert checks["sampled_gap"]["value"] > checks["sampled_gap"]["limit"]


def test_sound_training_is_correct():
    out = _measure(tiny.cell("train"))
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_samples_per_s"]["value"] > 0


def test_training_step_that_leaves_the_state_unchanged_is_not_correct(
        monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = _measure(tiny.cell("train"))
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("factory", [
    None, "port_bench.tests.faults:exchange_left_out",
    "port_bench.tests.faults:half_batch"],
    ids=["sound", "exchange_left_out", "half_batch"])
def test_data_parallel_ranks(factory):
    out = _measure(tiny.cell("train", ranks=4), step_factory=factory)
    assert out["correct"] == (factory is None), out["checks"]
