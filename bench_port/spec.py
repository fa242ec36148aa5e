"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``mixes/<traffic>.json``),
its limits for ``correct`` (``limits/<cell>.json``), the entry and the
reference its configuration names (``entries/<entry>.py``,
``references/<reference>.py``), and each metric's reader
(``metrics/<metric>.py``). Adding a configuration, a mix, a metric or a
cell adds files and entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """Everything one cell runs from: ``workload`` (its entry in
    ``BENCHMARK.json``), ``config``, ``mix``, ``limits``, and the
    end-to-end and per-layer metrics it reports."""
    bench = load()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": work,
        "config": _read_json(ROOT / conf["file"]),
        "mix": _read_json(HERE / "mixes" / f"{work['traffic']}.json"),
        "limits": _read_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def entry(config: dict):
    return importlib.import_module(f"bench_port.entries.{config['entry']}")


def reference(config: dict):
    return importlib.import_module(f"bench_port.references.{config['reference']}")


def metric(name: str):
    return importlib.import_module(f"bench_port.metrics.{name.replace('.', '_')}")


def replaced(base, values: dict):
    """``base`` (a frozen dataclass, such as the program's default
    configuration) with the fields that ``values`` names set: a dict
    replaces fields inside that field's nested dataclass, a list becomes a
    tuple. Fields that ``values`` leaves out keep ``base``'s, so a field
    the program adds later takes its default; a key ``base`` lacks raises."""
    out = {}
    for k, v in values.items():
        cur = getattr(base, k)
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            v = replaced(cur, v)
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return dataclasses.replace(base, **out)
