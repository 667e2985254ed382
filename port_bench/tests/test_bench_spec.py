"""The harness finds each cell's files by name, refuses an unknown cell,
refuses to run without a card, and BENCHMARK.json keeps to its format."""

import json
import re

import pytest

from port_bench import run, spec

with open(spec.ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.kind in ("decode", "train")
    for key in cell.model_keys:
        assert key in cell.config
    assert cell.limits and set(cell.limits) >= (
        {"wav_errors", "greedy_gap", "sampled_gap"} if cell.kind == "decode"
        else {"loss_gap", "grad_gap", "grad_gap_median", "update_gap",
              "route_off"})
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_a_metric_split_by_cell_reads_as_its_quantity():
    assert spec.reader("train_samples_per_s.dp4") is not None
    run = dict(kind="train", chips=4, window_positions=10, steps=3,
               window_s=2.0)
    assert spec.reader("train_samples_per_s.dp4")(run) == \
        spec.reader("train_samples_per_s")(run) == 60.0


def test_unknown_cell_is_refused(capsys):
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")
    assert run.main(["--workload", "no-such.cell", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    import torch

    for var in run.CACHE_DIRS:          # restored after the test
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        for w in m.get("workloads", CELLS):
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", CELLS)
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        with open(spec.ROOT / c["file"]) as f:
            held = json.load(f)
        assert held["name"] == c["name"] and held["reduced"] == c["reduced"]
        assert all(k in held for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        cell_metrics = [m for m in METRICS
                        if w["name"] in m.get("workloads", CELLS)]
        assert any(m in BENCH["per_layer"] for m in cell_metrics)
