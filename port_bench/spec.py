"""What a cell is made of, found by name under the checkout.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and the per-layer metrics. Everything else is a file of its
own under this folder:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the model,
  data and optimizer YAMLs as ``pcseqlearning_tpu_torch.train`` composes
  them, the schedule's length, ``source``, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the mode, batch, pool and the parameters of
  the generator it names, ``generators/<generator>.py``;
- ``modes/<mode>.py``: what runs in the window for the mode a traffic file
  names (``setup``, ``window``, ``traced_window``, ``check``; see
  ``harness``), and what its window reports;
- ``limits/<workload>.json``: each compared number's limit, with the
  readings it was set from;
- ``metrics/<metric>.py``: a reader, ``read(record)``, of the traced run's
  record, returning a number or None; with ``MODULES`` (the program's
  modules it spans) and ``LAYER`` (the span's name) where it reads a span.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    root: Path
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list = field(default_factory=list)  # (name, unit, reader module)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_file(root, kind, name):
    path = Path(root) / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{HERE.name}_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name, root):
    """The reader module of per-layer metric ``name``."""
    return _load_file(root, "metrics", name)


def load_generator(name, root):
    """The traffic generator module ``name``."""
    return _load_file(root, "generators", name)


def load_mode(name, root):
    """The mode module ``name``: what runs in the window."""
    return _load_file(root, "modes", name)


def _reported(metric, workload, e2e_names):
    wl = metric.get("workloads")
    if wl is not None:
        return workload in wl
    return metric.get("moves") in e2e_names


def load_cell(root, workload):
    """The cell ``workload`` of ``root/BENCHMARK.json``. Raises KeyError for
    a name it does not hold."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [(m["name"], m["unit"], load_reader(m["name"], root))
                 for m in bench["per_layer"] if _reported(m, workload, names)]
    return Cell(root=root, workload=workload, chips=int(w["chips"]),
                config=load_json(root / conf["file"]),
                traffic=load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / HERE.name / "limits" / f"{workload}.json"),
                end_to_end=[(m["name"], m["unit"]) for m in e2e], per_layer=per_layer)
