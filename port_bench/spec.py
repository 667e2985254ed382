"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell, its configuration and its traffic; the
configuration is ``configs/<config>.json``, the traffic
``traffic/<traffic>.json``, the limits of its comparison
``limits/<workload>.json``, and each metric a reader
``metrics/<metric>.py`` with ``read(run) -> float | None`` (or, for a
metric ``<quantity>.<cells>``, the quantity's reader).  A configuration's
``architecture`` (default ``wavenet-mulaw``) names the module
``arch/<architecture>.py`` that holds everything that varies by
architecture (``ARCH_HOOKS``; ``README.md`` says what each takes and
returns).  A later cell, traffic mix, metric or architecture is new files
and new entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: The architecture of a configuration without an ``architecture`` key
DEFAULT_ARCHITECTURE = "wavenet-mulaw"
#: The constants an architecture module defines: the keys of a
#: configuration file that are the program's model's, and the program's
#: training-step factory as ``"module:function"``
ARCH_CONSTANTS = ("MODEL_KEYS", "STEP_FACTORY")
#: The functions an architecture module defines
ARCH_HOOKS = (
    # the model: its weights, the program's decoder and training step
    "layout", "decoder", "train_step",
    # the traffic: a decode row's first input, a training window's inputs
    "first_input", "train_inputs",
    # the decode check: the served wavs, the sampler's noise, the gaps
    "read_served", "decode_noise", "served_gaps",
    # the training check: the reference's steps and the numbers compared
    "reference_train_steps", "train_numbers",
    # the controls: the reference's products one precision down, and a
    # decode cell's control readings
    "control_matmul", "decode_controls",
    # the operations and bytes behind ``bounds.py``
    "dilations", "receptive_field", "ar_bound_s", "stack_train_bound_s",
    "stack_bwd_bound_s", "decode_flops_per_sample",
    "train_flops_per_position")


def architecture_path(config: dict) -> Path:
    """The file of the configuration's architecture module; raises
    ``KeyError``, naming the file, where there is none."""
    name = config.get("architecture", DEFAULT_ARCHITECTURE)
    path = HERE / "arch" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"configuration {config.get('name', '?')!r} names "
                       f"the architecture {name!r}, but there is no {path}")
    return path


def architecture(config: dict):
    """The architecture module of ``config``, loaded by path once a
    process (as ``spec.reader`` loads a metric's); raises ``KeyError``
    where it has no file and ``AttributeError`` where it lacks a constant
    or a hook."""
    name = config.get("architecture", DEFAULT_ARCHITECTURE)
    key = "port_bench.arch." + name.replace("-", "_").replace(".", "_")
    module = sys.modules.get(key)
    if module is not None:
        return module
    path = architecture_path(config)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [n for n in ARCH_CONSTANTS + ARCH_HOOKS
               if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"{path} does not define {', '.join(missing)}")
    sys.modules[key] = module
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def arch(self):
        """The configuration's architecture module."""
        return architecture(self.config)

    @property
    def model_keys(self) -> tuple:
        """The keys of the configuration that are the model's; the rest
        are the recipe's or notes."""
        return self.arch.MODEL_KEYS


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises ``KeyError`` for a
    name it does not hold, or whose configuration names an architecture
    that has no module."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has: "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    config = _json(HERE / "configs" / f"{w['config']}.json")
    architecture_path(config)
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
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
