"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell, its configuration and its traffic; the
configuration is ``configs/<config>.json``, the traffic
``traffic/<traffic>.json``, the limits of its comparison
``limits/<workload>.json``, and each metric a reader
``metrics/<metric>.py`` with ``read(run) -> float | None`` (or, for a
metric ``<quantity>.<cells>``, the quantity's reader).  A later cell,
traffic mix or metric is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: The keys of a configuration file that are the model's
#: (``WaveNetConfig``'s); the rest are the recipe's or notes.
MODEL_KEYS = ("n_quantize", "n_aux", "n_resch", "n_skipch", "dilation_depth",
              "dilation_repeat", "kernel_size", "upsampling_factor",
              "compute_dtype")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    model_keys: tuple = MODEL_KEYS

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises ``KeyError`` for a
    name it does not hold."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has: "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``; where there is no
    such file, that of the name without its last ``.`` part, so that a
    quantity split by cell (``train_samples_per_s.dp4``, with its own
    bound) reads as the quantity does."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader(metric.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: list, run: dict) -> dict:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
