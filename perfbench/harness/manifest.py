"""The cell a run measures, found by name in ``BENCHMARK.json``: its
configuration file, its traffic mix (``mixes/<traffic>.json``), the limits
of its check (``limits/<cell>.json``), the readers of its per-layer metrics
(``metrics/<metric>.py``) and the model its configuration names
(``models/<backbone>.py``). A cell, a mix, a metric or a model is added as
a file of its own and an entry of the manifest; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, NamedTuple

from .session import HERE, ROOT


class Cell(NamedTuple):
    name: str
    config: dict  # the configuration file
    mix: dict  # the traffic mix file
    limits: dict  # {number: limit} of the check; empty where none is set
    end_to_end: list  # the manifest's entries that this cell reports
    per_layer: list
    chips: int = 1  # the cards the cell runs on, one process a card


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest at ``root``; raises KeyError for a
    cell the manifest does not have."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has: {', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{w['traffic']}.json").read_text())
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, config, mix, limits,
                [m for m in man["end_to_end"] if _reports(m, name)],
                [m for m in man["per_layer"] if _reports(m, name)], w["chips"])


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = HERE) -> Callable:
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    return _module(bench_dir / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}").read


def model(backbone: str, bench_dir: Path = HERE) -> ModuleType:
    """``models/<backbone>.py``: its ``port(model_cfg, num_channels, device)``
    builds the program's module, its ``reference(...)`` the plain float32
    copy, and its optional ``weights(model, seed, device)`` draws the weights
    where ``configure.draw_weights``'s rule does not fit; ``HEAD``, where it
    is given, names the modules the control leaves at the head's dtype."""
    path = bench_dir / "models" / f"{backbone}.py"
    if not path.exists():
        raise KeyError(f"no model file models/{backbone}.py for the configuration's backbone")
    return _module(path, f"perfbench_model_{backbone}")
