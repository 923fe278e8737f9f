"""Everything a cell needs, found by name, so that a configuration, a
traffic mix, a per-layer metric or a set of limits is added by adding files
and ``BENCHMARK.json`` entries, never by editing a file that is there:

* the cell: ``workloads[]`` of ``BENCHMARK.json`` at the root, by ``name``;
* its configuration: ``configs[]`` by the cell's ``config``, whose ``file``
  (relative to the root) holds the sequences, the segment and the
  ``MullsConfig`` fields it sets;
* its traffic mix: ``traffic/<traffic>.json`` beside the harness;
* the limits of the comparison: ``limits/<config>.json``, else
  ``limits/default.json``;
* a metric: ``metrics/<name>.py``, a module with ``read(run)`` that returns
  the number, or None when it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def apply_overrides(obj, overrides: dict):
    """A frozen dataclass with the fields of a nested dict replaced
    (a nested dataclass takes a nested dict)."""
    kw = {}
    for key, val in overrides.items():
        if not any(f.name == key for f in dataclasses.fields(obj)):
            raise KeyError(f"{type(obj).__name__} has no field {key!r}")
        cur = getattr(obj, key)
        kw[key] = (apply_overrides(cur, val)
                   if isinstance(val, dict) and dataclasses.is_dataclass(cur)
                   else val)
    return dataclasses.replace(obj, **kw)


class Catalog:
    """The benchmark as files under ``root`` (the checkout) and ``here``
    (the harness's folder)."""

    def __init__(self, root: str, here: str = HERE):
        self.root = root
        self.here = here
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.here, "traffic", name + ".json")) as f:
            return json.load(f)

    def limits(self, config: str) -> dict:
        for name in (config, "default"):
            path = os.path.join(self.here, "limits", name + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        raise FileNotFoundError("no limits/<config>.json nor "
                                "limits/default.json")

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that a cell
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        path = os.path.join(self.here, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def readers(self, cell: str) -> Dict[str, object]:
        return {m["name"]: self.reader(m["name"])
                for m in self.metrics(cell, "per_layer")}
