"""The architecture hook (``spec.architecture``): the mu-law WaveNet's
numbers, weights and traffic are those the harness gave before it had the
hook; an architecture added as new files only (a module, a configuration,
traffic, limits and entries in a copy of the checkout) is reached on every
path of a run, its controls and its bounds; an unknown one fails at
``load_cell`` with the file it looked for."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import controls, run, spec, weights
from port_bench import traffic as tr
from port_bench.tests import tiny

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")

# What the harness gave, on the CPU with 2 threads, before the hook: the
# checks numbers at the tiny cells (the sound program, float32 and
# bfloat16; the int8 decode control; the training control and fault), and
# sha256 digests of the real configurations' weights and cells' traffic.
PARENT = {
    "decode_k2": {"greedy_gap": 0.0, "sampled_gap": 0.0, "wav_errors": 0},
    "decode_k3": {"greedy_gap": 0.0, "sampled_gap": 0.0, "wav_errors": 0},
    "decode_bf16_k2": {"greedy_gap": 0.00018936395645141602,
                       "sampled_gap": 0.0, "wav_errors": 0},
    "decode_bf16_k3": {"greedy_gap": 0.0, "sampled_gap": 0.0,
                       "wav_errors": 0},
    "decode_int8_k2": {"greedy_gap": 0.00018936395645141602,
                       "sampled_gap": 0.0, "wav_errors": 0},
    "decode_int8_k3": {"greedy_gap": 0.000178605318069458,
                       "sampled_gap": 0.0, "wav_errors": 0},
    "train_k2": {"grad_diff_median": 1.2378156161744232e-07,
                 "grad_gap": 1.5555131075050494e-07,
                 "grad_gap_median": 1.9059319523916356e-08,
                 "loss_gap": 8.574998220687869e-08, "route_off": 0.0,
                 "update_gap": 7.564041962112565e-08},
    "train_k3": {"grad_diff_median": 1.418786323309825e-07,
                 "grad_gap": 1.5387538118898292e-07,
                 "grad_gap_median": 9.530912165703065e-09,
                 "loss_gap": 1.722411658797829e-07, "route_off": 0.0,
                 "update_gap": 7.5874417505486855e-06},
    "controls_k2": {
        "control_fp8": {"grad_diff_median": 0.26366205790005603,
                        "grad_gap": 0.13138888875041269,
                        "grad_gap_median": 0.049538199518106604,
                        "loss_gap": 0.0003818166367066853,
                        "update_gap": 0.05256196578188775},
        "state_unchanged": {"grad_diff_median": 0.9825109449297063,
                            "grad_gap": 1.0,
                            "grad_gap_median": 0.9825109449297063,
                            "loss_gap": 0.00019379495978754584,
                            "update_gap": 1.0}},
    "controls_k3": {
        "control_fp8": {"grad_diff_median": 0.24712946273639907,
                        "grad_gap": 0.20402980501774898,
                        "grad_gap_median": 0.048522524140410125,
                        "loss_gap": 0.00023778693895103832,
                        "update_gap": 0.08287656066268821},
        "state_unchanged": {"grad_diff_median": 0.966880545606321,
                            "grad_gap": 1.0,
                            "grad_gap_median": 0.966880545606321,
                            "loss_gap": 6.984132274826378e-05,
                            "update_gap": 1.0}},
}
WEIGHTS = {
    ("arctic-sd", True): "7f71eb0bb3e550ce876301f2ff90dab9eb"
                         "b26e91329f433e1ed477d7dd0818c7",
    ("arctic-sd", False): "9812b679dd4ccc0ffe152eb60203a5f308"
                          "39e528f970b8a9ae5b15dd12bd1f57",
    ("arctic-sd-dp4", True): "7f71eb0bb3e550ce876301f2ff90dab9eb"
                             "b26e91329f433e1ed477d7dd0818c7",
    ("arctic-sd-dp4", False): "9812b679dd4ccc0ffe152eb60203a5f308"
                              "39e528f970b8a9ae5b15dd12bd1f57",
    ("ljspeech-sd", True): "a836bef926c7df67178527cd1d096b7ab5"
                           "33086661984a6e021e669e3ca3493c",
    ("ljspeech-sd", False): "51f3f023d7b38e505bfef980bb03eb23a9"
                            "f8368e075b0e3db5b5ff441dc3231a",
}
FLEETS = {  # fleet 1 of the seed
    "arctic-sd.decode-b32": "6806b16c2e435da2c8fbdacdd1b66a4e95"
                            "cc392bca13356741884c424a2a0a02",
    "ljspeech-sd.decode-b256": "3b2b6fa3c876ca1cf73aa8d9e4fac9132e"
                               "b2d2751dcfcb94a6fc09c82dc3a7f7",
}
WINDOWS = {  # windows 0 and 5 of the seed
    "arctic-sd.train-t23040": "b581d979f201a55f1235b689d7475146dc"
                              "013acd5b0dbdb0621163ae6df00c62",
    "arctic-sd.train-dp4": "b581d979f201a55f1235b689d7475146dc"
                           "013acd5b0dbdb0621163ae6df00c62",
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ---- identity: the mu-law WaveNet's numbers do not move -----------------

@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("variant", ["", "bf16_", "int8_"])
def test_decode_numbers_are_the_parent_s(k, variant):
    cell = tiny.cell("decode", kernel_size=k)
    if variant == "bf16_":
        cell.config = dict(cell.config, compute_dtype="bfloat16")
    got = controls.decode_fleets(cell, SEED, CPU, variant == "int8_", (0, 1))
    assert got == PARENT[f"decode_{variant}k{k}"]


@pytest.mark.parametrize("k", [2, 3])
def test_training_numbers_are_the_parent_s(k):
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import RankInfo

    cell = tiny.cell("train", kernel_size=k)
    got = controls.program_steps_rank(RankInfo.alone(CPU),
                                      dict(cell=cell, seeds=[SEED]))
    assert got == [(SEED, PARENT[f"train_k{k}"])]
    assert controls.reference_controls(cell, SEED, CPU) == \
        PARENT[f"controls_k{k}"]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("name", ["arctic-sd", "arctic-sd-dp4",
                                  "ljspeech-sd"])
def test_weights_are_the_parent_s(name, bf16):
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    p = weights.make_params(cfg, SEED, "cpu", bf16_values=bf16)
    assert _digest(p[g][n] for g in sorted(p) for n in sorted(p[g])) == \
        WEIGHTS[(name, bf16)]


@pytest.mark.parametrize("name", sorted(FLEETS) + sorted(WINDOWS))
def test_traffic_is_the_parent_s(name):
    cell = spec.load_cell(name)
    if name in FLEETS:
        _ids, (x, h, n) = tr.fleet(cell.traffic, cell.config, SEED, 1)
        assert _digest([x, h, np.asarray(n)]) == FLEETS[name]
    else:
        assert _digest(a for j in (0, 5) for a in tr.train_window(
            cell.config, SEED, j)) == WINDOWS[name]


# ---- reach: an architecture of new files is on every path ---------------

def _add_recorder(root) -> None:
    """Into the checkout copy ``root``: the recorder as ``arch/recorder.py``,
    a tiny configuration naming it, its traffic and limits, and a decode
    and a training cell of it in BENCHMARK.json, measured with the metrics
    of the real cells of their kinds."""
    here = root / "port_bench"
    shutil.copy(spec.HERE / "tests" / "arch_recorder.py",
                here / "arch" / "recorder.py")
    files = {
        "configs/tiny-recorder.json": dict(
            tiny.CONFIG, name="tiny-recorder", architecture="recorder",
            reduced=[]),
        "traffic/tiny-decode.json": tiny.DECODE,
        "traffic/tiny-train.json": tiny.TRAIN,
        "limits/tiny-recorder.decode.json": {
            k: tiny.LIMITS[k] for k in ("wav_errors", "greedy_gap",
                                        "sampled_gap")},
        "limits/tiny-recorder.train.json": {
            k: tiny.LIMITS[k] for k in ("loss_gap", "grad_gap",
                                        "grad_gap_median", "grad_diff_median",
                                        "update_gap", "route_off")},
    }
    for rel, data in files.items():
        with open(here / rel, "w") as f:
            json.dump(data, f)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny-recorder", source="a test",
                                 file="port_bench/configs/tiny-recorder.json",
                                 reduced=[], why="a test"))
    for new, traffic, like in (
            ("tiny-recorder.decode", "tiny-decode", "arctic-sd.decode-b32"),
            ("tiny-recorder.train", "tiny-train", "arctic-sd.train-t23040")):
        bench["workloads"].append(dict(name=new, config="tiny-recorder",
                                       traffic=traffic, chips=1, why="a test"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and like in m["workloads"]:
                m["workloads"].append(new)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


def _reach() -> None:
    """In the copy: both cells through ``run.measure``, their controls,
    and every reader and function of ``bounds.py`` that takes a
    configuration, on the recorder's cells; prints what was correct and
    the hooks each of these called."""
    from port_bench import bounds
    from port_bench.trace import WINDOW_SPAN, Trace

    torch.set_num_threads(2)
    calls = spec.architecture({"architecture": "recorder"}).CALLS
    out, seen = {}, {}

    def phase(name, fn):
        calls.clear()
        out[name] = fn()
        seen[name] = sorted(calls)

    for kind in ("decode", "train"):
        cell = spec.load_cell(f"tiny-recorder.{kind}")
        phase(kind, lambda: run.measure(cell, 0.5, SEED, False, "cpu", 0.0,
                                        backend="gloo")["correct"])
        phase(kind + " controls", lambda: sorted(
            who for _s, who, _n in controls.readings(cell, [], [SEED], CPU)))
    cfg = cell.config
    trace = Trace([dict(name=n, ts=s, dur=d, ph="X", cat=c) for n, s, d, c in (
        (WINDOW_SPAN, 0.0, 1e4, "user_annotation"),
        ("ar_persistent_kernel<2, false, false>", 10.0, 5e3, "kernel"),
        ("wg_kernel", 6e3, 3e3, "kernel"))])
    runs = dict(
        decode=dict(kind="decode", config=cfg, trace=trace, quantize=False,
                    lengths=[[15, 7, 11, 3]], samples=36, window_s=1.0,
                    chips=1),
        train=dict(kind="train", config=cfg, trace=trace, chips=1,
                   window_positions=40, traced_steps=2))
    for metric, kind in (("k1_roofline", "decode"), ("mfu.decode", "decode"),
                         ("mfu.train", "train"),
                         ("stack_train_roofline", "train")):
        phase(metric, lambda: spec.reader(metric)(runs[kind]) > 0)
    for fn in (bounds.dilations, bounds.receptive_field):
        phase("bounds." + fn.__name__, lambda: bool(fn(cfg)))
    print(json.dumps(dict(out=out, calls=seen)))


#: The hooks each part of the reach test calls
REACHED = {
    "decode": ["decoder", "first_input", "layout", "read_served",
               "decode_noise", "served_gaps"],
    "decode controls": ["decode_controls", "decoder", "first_input", "layout",
                        "read_served", "decode_noise", "served_gaps"],
    "train": ["layout", "receptive_field", "reference_train_steps",
              "train_inputs", "train_numbers", "train_step"],
    "train controls": ["control_matmul", "layout", "receptive_field",
                       "reference_train_steps", "train_inputs",
                       "train_numbers"],
    "k1_roofline": ["ar_bound_s"],
    "mfu.decode": ["decode_flops_per_sample"],
    "mfu.train": ["train_flops_per_position"],
    "stack_train_roofline": ["stack_bwd_bound_s", "stack_train_bound_s"],
    "bounds.dilations": ["dilations"],
    "bounds.receptive_field": ["receptive_field"],
}


def test_an_architecture_of_new_files_is_on_every_path(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    _add_recorder(root)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(spec.ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c",
         "from port_bench.tests.test_bench_arch import _reach; _reach()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["out"] == dict(
        {"decode": True, "decode controls": ["control_int8"], "train": True,
         "train controls": ["control_fp8", "state_unchanged"]},
        **{k: True for k in REACHED if k not in ("decode", "train")
           and "controls" not in k})
    assert got["calls"] == {k: sorted(v) for k, v in REACHED.items()}
    assert {h for v in REACHED.values() for h in v} == set(spec.ARCH_HOOKS)


# ---- an unknown architecture --------------------------------------------

def _checkout_naming(tmp_path, monkeypatch, architecture: str) -> str:
    """A checkout whose one cell's configuration names ``architecture``,
    made the harness's; returns the cell's name."""
    here = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "limits", "arch"):
        (here / sub).mkdir(parents=True)
    with open(here / "configs" / "odd.json", "w") as f:
        json.dump(dict(tiny.CONFIG, name="odd", architecture=architecture),
                  f)
    with open(here / "traffic" / "tiny-decode.json", "w") as f:
        json.dump(tiny.DECODE, f)
    with open(here / "limits" / "odd.decode.json", "w") as f:
        json.dump({"wav_errors": 0}, f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(dict(workloads=[dict(name="odd.decode", config="odd",
                                       traffic="tiny-decode", chips=1)],
                       end_to_end=[], per_layer=[]), f)
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return "odd.decode"


def test_an_unknown_architecture_fails_at_load_cell(tmp_path, monkeypatch,
                                                    capsys):
    name = _checkout_naming(tmp_path, monkeypatch, "no-such-net")
    want = str(tmp_path / "port_bench" / "arch" / "no-such-net.py")
    with pytest.raises(KeyError) as e:
        spec.load_cell(name)
    assert want in e.value.args[0]
    assert run.main(["--workload", name, "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and want in out.err


def test_an_architecture_without_a_hook_is_refused(tmp_path, monkeypatch):
    name = _checkout_naming(tmp_path, monkeypatch, "partial")
    with open(tmp_path / "port_bench" / "arch" / "partial.py", "w") as f:
        f.write("MODEL_KEYS = ()\nSTEP_FACTORY = 'm:f'\n"
                "def layout(cfg):\n    return []\n")
    cell = spec.load_cell(name)
    with pytest.raises(AttributeError, match="decoder, train_step"):
        cell.arch
    assert "port_bench.arch.partial" not in sys.modules
