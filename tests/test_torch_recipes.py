"""The port's recipes (``egs_torch/``, written by
``python -m pytorchwavenetvocoder_tpu_torch.recipes``): every ``run.sh``
parses, the committed tree is the emitter's output, each recipe keeps the
JAX recipe's settings and tool flags but for the listed differences, and
the arctic/sd recipe runs stages 1-6 on the CPU at tiny widths."""

import os
import re
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

from pytorchwavenetvocoder_tpu_torch import recipes
from pytorchwavenetvocoder_tpu_torch.eval.klatt import make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EGS_TORCH = os.path.join(ROOT, "egs_torch")
NAMES = sorted(recipes.RECIPES)
TOOLS = ("feature_extract", "calc_stats", "noise_shaping", "train", "decode",
         "eval_mcd")
# the run outputs .gitignore lists under egs_torch/
RUN_OUTPUTS = {"exp", "data", "downloads", "hdf5", "wav"}


def _read(*parts):
    with open(os.path.join(*parts)) as f:
        return f.read()


def _files(top):
    """{relative path: (bytes, executable)} of the tree, run outputs and
    caches left out."""
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in RUN_OUTPUTS
                   and not x.startswith("wav_") and x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = (
                    fh.read(), bool(os.stat(path).st_mode & stat.S_IXUSR))
    return out


def _settings(run_sh: str) -> dict:
    """The settings block (``name=value  # comment`` lines before the
    command-line overrides): name -> value."""
    head = run_sh.split(". parse_options.sh")[0]
    return dict(re.findall(r"^([A-Za-z_]\w*)=(\([^)]*\)|\"[^\"]*\"|\S*)",
                           head, flags=re.M))


def _tool_calls(run_sh: str, tool_re: str) -> list:
    """(tool, sorted flags) of every tool call, in order; a call is one
    shell command (lines joined at their trailing backslash)."""
    calls = []
    for cmd in run_sh.replace("\\\n", " ").splitlines():
        m = re.search(tool_re, cmd)
        if m:
            calls.append((m.group(1), sorted(set(
                re.findall(r"\s(--\w+)", cmd[m.end():])))))
    return calls


@pytest.mark.parametrize("name", NAMES)
def test_run_sh_parses(name):
    path = os.path.join(EGS_TORCH, name, "run.sh")
    res = subprocess.run(["bash", "-n", path], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    assert os.stat(path).st_mode & stat.S_IXUSR


def test_committed_tree_is_the_emitters_output(tmp_path, capsys):
    recipes.main(str(tmp_path))
    assert capsys.readouterr().out.count("generated") == len(NAMES) == 11
    want, got = _files(str(tmp_path)), _files(EGS_TORCH)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.mark.parametrize("name", NAMES)
def test_recipe_keeps_the_jax_recipes_settings_and_flags(name):
    """Names and defaults of every setting, stage digits, the expdir naming
    and each tool call's flags are the JAX recipe's; the port adds
    ``device`` (to train and decode) and ``dist_backend`` (to train), and
    runs each tool as ``python3 -m pytorchwavenetvocoder_tpu_torch.bin.*``."""
    jax_sh = _read(ROOT, "egs", name, "run.sh")
    port_sh = _read(EGS_TORCH, name, "run.sh")
    assert _settings(port_sh) == dict(_settings(jax_sh), device="cuda",
                                      dist_backend="auto")
    jax_calls = _tool_calls(jax_sh, r"\s(" + "|".join(TOOLS) + r")\.py\b")
    port_calls = _tool_calls(
        port_sh, r"python3 -m pytorchwavenetvocoder_tpu_torch\.bin\.("
        + "|".join(TOOLS) + r")\b")
    added = {"train": ["--device", "--dist_backend"], "decode": ["--device"]}
    assert port_calls == [(t, sorted(f + added.get(t, [])))
                          for t, f in jax_calls]
    assert {t for t, _ in port_calls} == set(TOOLS)
    for pattern in (r"wants (\d)", r"^\s*expdir=.*$", r"banner \d .*$"):
        assert re.findall(pattern, port_sh, flags=re.M) == \
            re.findall(pattern, jax_sh, flags=re.M)
    assert not re.search(r"\b\w+\.py \\$", port_sh, flags=re.M)
    path_sh = _read(EGS_TORCH, name, "path.sh")
    assert "export PYTHONPATH=$PRJ_ROOT:" in path_sh
    assert "$PRJ_ROOT/egs/utils" in path_sh
    assert "pytorchwavenetvocoder_tpu/bin" not in path_sh
    assert _read(EGS_TORCH, name, "cmd.sh") == _read(ROOT, "egs", name,
                                                      "cmd.sh")


def test_arctic_sd_recipe_runs_stages_1_to_6_on_the_cpu(tmp_path):
    """``run.sh --stage 123456`` of the emitted arctic/sd recipe, copied out
    of the tree, at tiny widths with ``--device cpu`` on
    tests/test_torch_cli_pipeline.py's corpus (three 2-syllable Klatt
    utterances, seed 0) laid out as stage 0 would: every stage's log ends
    with code 0 and the MCD report lists the eval set."""
    recipe = tmp_path / "sd"
    shutil.copytree(os.path.join(EGS_TORCH, "arctic", "sd"), recipe)
    wavdir = tmp_path / "corpus"
    make_corpus(str(wavdir), 3, fs=16000, seed=0, n_syllables=2)
    names = sorted(os.listdir(wavdir))
    for subset, chosen in (("tr_slt", names), ("ev_slt", names[1:])):
        os.makedirs(recipe / "data" / subset)
        (recipe / "data" / subset / "wav.scp").write_text(
            "".join(f"{wavdir / n}\n" for n in chosen))
    env = dict(os.environ, PRJ_ROOT=ROOT, OMP_NUM_THREADS="2",
               PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    res = subprocess.run(
        ["bash", "./run.sh", "--stage", "123456", "--n_resch", "16",
         "--n_skipch", "16", "--dilation_depth", "3", "--dilation_repeat",
         "1", "--iters", "3", "--batch_length", "400",
         "--checkpoint_interval", "3", "--device", "cpu", "--n_jobs", "2",
         "--decode_batch_size", "2", "--eval_mcd", "true"],
        cwd=recipe, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    logs = [os.path.join(d, f) for d, _, fs in os.walk(recipe / "exp")
            for f in fs if f.endswith(".log")]
    assert len(logs) >= 7
    for log in logs:
        assert "# Ended (code 0)" in _read(log).splitlines()[-1], log
    [expdir] = [d for d in os.listdir(recipe / "exp") if d.startswith("tr_")]
    train_log = _read(recipe / "exp" / expdir / "log" / "tr_slt.log")
    assert "train step route: plain" in train_log
    report = _read(recipe / "exp" / expdir / "wav_nsf" / "mcd.txt")
    lines = report.splitlines()
    per_utt = dict(ln.split() for ln in lines if not ln.startswith("#"))
    assert sorted(per_utt) == names[1:]
    assert all(np.isfinite(float(v)) for v in per_utt.values())
    assert lines[-1].split()[:2] == ["#", "mean"]
