"""A cell as ``BENCHMARK.json`` names it, resolved to its data files.

A workload entry names a configuration and a traffic mix; the files are
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``cells/<workload>.json``, and each metric is read by
``metrics/<metric>.py``. A metric applies to the cells its ``workloads``
key lists; an end-to-end metric without the key to every cell, a
per-layer one without it to every cell that reports the end-to-end
metric it ``moves``.

A configuration that names a mesh, ``"mesh": {"table": T, "shard": S,
"query": Q}``, runs across ``T * S * Q`` cards, which must equal its
cells' ``chips``: one process per card through the program's sharded
engines (``multicard.py``), its ``layout`` choosing the inline or the
compact engine, one batch in flight (traffic ``depth`` 1). A
configuration without the key runs on one card (``run.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC_FILE = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def data_file(kind: str, name: str) -> str:
    """``<benchmark>/<kind>/<name>.json``."""
    return os.path.join(HERE, kind, f"{name}.json")


def metric_file(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One workload with its configuration, traffic and cell parameters,
    and the metrics it reports."""

    name: str
    config: dict
    traffic: dict
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1

    @property
    def batch(self) -> int:
        return int(self.params["batch"])


def load_cell(workload: str, spec: dict = None) -> Cell:
    """The cell ``workload`` of ``spec`` (by default ``BENCHMARK.json``)."""
    spec = load_json(SPEC_FILE) if spec is None else spec
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (one of "
                       f"{sorted(entries)})")
    w = entries[workload]
    e2e = [m for m in spec["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in names and applies(m, workload)]
    return Cell(name=workload,
                config=load_json(data_file("configs", w["config"])),
                traffic=load_json(data_file("traffic", w["traffic"])),
                params=load_json(data_file("cells", workload)),
                end_to_end=e2e, per_layer=per_layer, chips=int(w["chips"]))


def reader(name: str) -> Callable:
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"),
        metric_file(name))
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` for each metric whose reader found
    something to read; a reader that finds nothing returns None and its
    metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
