"""The mixture-of-logistics WaveNet (``arch/wavenet-mol.py``) through the
harness at a size the CPU runs in seconds: a decode cell and a training
cell through ``run.measure`` come out correct on the program's plain path
(float32); a sampler that reuses the previous step's logistic uniform,
takes the scale as exp(2 log_s), or picks the component without its noise
in a sampled fleet comes out not correct; the module's K1 noise is the
kernel's Philox layout; and neither the module nor its reference imports
JAX or the program when imported."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import run, spec, weights
from port_bench import traffic as tr

SEED = 2 ** 31 + 91
HERE = Path(__file__).resolve().parents[1]

CONFIG = dict(architecture="wavenet-mol", output="mol", n_quantize=65536,
              n_mix=3, n_aux=5, n_resch=16, n_gatech=8, n_skipch=16,
              dilation_depth=3, dilation_repeat=1, kernel_size=3,
              upsampling_factor=16, upsampling_scales=[4, 4],
              freq_axis_kernel_size=3, log_scale_min=-32.23619130191664,
              dropout=0.05, compute_dtype="float32", fs=22050, lr=1e-3,
              weight_decay=0.0, batch_length=64, batch_size=1,
              decode_batch_size=4)
LIMITS = dict(wav_errors=0, greedy_gap=1e-3, sampled_gap=1e-3, loss_gap=1e-4,
              grad_gap=1e-2, grad_gap_median=1e-2, grad_diff_median=1e-2,
              update_gap=1e-2, route_off=0)


def _cell(kind: str) -> spec.Cell:
    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    like = {"decode": "ljspeech-mol.decode-b32",
            "train": "arctic-sd.train-t23040"}[kind]
    traffic = (dict(kind="decode", durations=dict(dist="lognormal",
                                                  median_s=0.004,
                                                  sigma=0.25), check_rows=2)
               if kind == "decode" else dict(kind="train", ranks=1))
    names = (("wav_errors", "greedy_gap", "sampled_gap") if kind == "decode"
             else ("loss_gap", "grad_gap", "grad_gap_median",
                   "grad_diff_median", "update_gap", "route_off"))
    return spec.Cell(
        name=like, chips=1, config=dict(CONFIG), traffic=traffic,
        limits={k: LIMITS[k] for k in names},
        end_to_end=[m for m in bench["end_to_end"] if spec._applies(m, like)],
        per_layer=[m for m in bench["per_layer"] if spec._applies(m, like)])


def _measure(cell):
    return run.measure(cell, 0.5, SEED, False, "cpu", 0.0, backend="gloo")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_mol_decode_is_correct():
    """float32 program and reference: the gaps are the 16-bit PCM's
    rounding, half a step of 2^-15 weighed by the module's VALUE_SCALE,
    and what the reference's inputs, the rounded samples, move."""
    out = _measure(_cell("decode"))
    assert out["correct"], out["checks"]
    pcm = 0.5 / 32768 * spec.architecture(CONFIG).VALUE_SCALE
    assert out["checks"]["greedy_gap"]["value"] <= 2 * pcm
    assert out["checks"]["sampled_gap"]["value"] <= 2 * pcm
    assert out["failed"] == 0 and out["attempted"] > 0


def test_sound_mol_training_is_correct():
    out = _measure(_cell("train"))
    assert out["correct"], out["checks"]


def _reuse_uniform(monkeypatch):
    """The logistic's uniform of the step before, not the step's own."""
    from pytorchwavenetvocoder_tpu_torch.models import mol

    real, last = mol.mol_value, {}

    def value(means, log_scales, c, v):
        if v is None:
            return real(means, log_scales, c, v)
        prev = last.get(v.shape, v)
        last[v.shape] = v
        return real(means, log_scales, c, prev)
    monkeypatch.setattr(mol, "mol_value", value)


def _scale_squared(monkeypatch):
    """The logistic's scale taken as exp(2 log_s)."""
    from pytorchwavenetvocoder_tpu_torch.models import mol

    real = mol.mol_value
    monkeypatch.setattr(mol, "mol_value",
                        lambda means, ls, c, v: real(means, 2 * ls, c, v))


def _no_component_noise(monkeypatch):
    """The component by argmax of the logits in a sampled fleet."""
    from pytorchwavenetvocoder_tpu_torch.models import mol

    real = mol.mol_choose
    monkeypatch.setattr(mol, "mol_choose", lambda logits, u: real(logits,
                                                                  None))


@pytest.mark.parametrize("fault", [_reuse_uniform, _scale_squared,
                                   _no_component_noise])
def test_a_mol_sampler_fault_fails_the_sampled_fleets(fault, monkeypatch):
    fault(monkeypatch)
    out = _measure(_cell("decode"))
    assert not out["correct"]
    assert out["checks"]["sampled_gap"]["value"] > LIMITS["sampled_gap"]
    assert out["checks"]["greedy_gap"]["value"] <= LIMITS["greedy_gap"]


def test_kernel_uniforms_are_the_philox_layout():
    """Uniform j of (row, step) is word j % 4 of the Philox4x32-10 block
    of the counter (j // 4, row, step, 1): Random123's known-answer vector
    for the counter (0, 0, 0, 0) under the key (0, 0) is 6627e8d5
    e169c58d bc57ac4c 9b00dbd8, and a counter with its last word 1 gives
    other bits."""
    from port_bench.reference import sampler

    arch = spec.architecture(CONFIG)
    words = sampler.philox4x32_10(*(torch.zeros((), dtype=torch.int64)
                                    for _ in range(4)), (0, 0))
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]
    u = arch.kernel_uniforms(12345, 3, 5, 10, "cpu")
    assert u.shape == (5, 11) and u.dtype == torch.float32
    assert bool((u > 0).all() and (u < 1).all())
    w = sampler.philox4x32_10(torch.tensor(2), torch.tensor(3),
                              torch.tensor(4), torch.tensor(1), (12345, 0))
    assert u[4, 10].item() == ((int(w[2]) >> 9) + 0.5) / 2 ** 23


def test_layout_round_trips_and_the_head_is_centred():
    arch = spec.architecture(CONFIG)
    params = weights.make_params(CONFIG, SEED, "cpu")
    model = arch.model_params(params)
    assert model["post2"]["w"].shape == (16, 9)
    assert "b" not in model["aux"]
    back = arch.layout_params(model, params)
    assert all(torch.equal(back[g][n], params[g][n]) for g in params
               for n in params[g])
    assert float(params["head_scale"]["b"].mean()) < -2.5


def test_mol_config_file_holds_the_preset():
    with open(HERE / "configs" / "ljspeech-mol.json") as f:
        cfg = json.load(f)
    arch = spec.architecture(cfg)
    wc = arch._program_config(cfg)
    assert (wc.n_layers, wc.n_resch, wc.gate_ch, wc.n_skipch, wc.n_out,
            wc.receptive_field) == (24, 512, 256, 256, 30, 505)
    assert np.prod(cfg["upsampling_scales"]) == cfg["upsampling_factor"]
    assert sorted(cfg["reduced"]) == ["decode_batch_size", "duration_scale"]
    frames = tr.fleet_frames(
        json.load(open(HERE / "traffic" / "decode-ljspeech-mol.json")), cfg)
    assert len(frames) == 32 and frames.max() * 256 < 2.6 * 22050


@pytest.mark.parametrize("name", ["arch/wavenet-mol.py",
                                  "reference/wavenet_mol.py"])
def test_mol_modules_import_nothing_of_the_program(name):
    """At import time: no JAX and nothing of the program (the module
    imports the program inside the functions that build its model)."""
    path = HERE / name
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    mods = {a.name for n in top if isinstance(n, ast.Import)
            for a in n.names} | {n.module for n in top
                                 if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in mods} & {
        "jax", "jaxlib", "flax", "pytorchwavenetvocoder_tpu",
        "pytorchwavenetvocoder_tpu_torch"}
    code = (f"import sys, importlib.util; sys.path.insert(0, {str(HERE.parent)!r});"
            f"s = importlib.util.spec_from_file_location('m', {str(path)!r});"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m);"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'pytorchwavenetvocoder_tpu', "
            "'pytorchwavenetvocoder_tpu_torch')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
