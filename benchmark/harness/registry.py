"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is an entry of ``workloads``. Its
configuration is the JSON file that the ``configs`` entry names; its
traffic mix is ``traffic/<traffic>.json``, whose ``driver`` names the
module ``drivers/<driver>.py`` that drives the program; its limits are
``limits/<cell>.json``; each of its metrics is read by
``metrics/<metric>.py``. So a new configuration, mix, metric or cell is
new files plus new entries, and no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """The benchmark description and the files it names, under
    ``root`` (the checkout) and ``bench_dir`` (this folder)."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.bench_dir, "traffic", name + ".json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.bench_dir, "limits", cell + ".json"))

    def driver(self, name: str):
        return _module(os.path.join(self.bench_dir, "drivers", name + ".py"),
                       f"bench_driver_{name}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: ``per_layer`` with ``trace``, else
        ``end_to_end``; an entry with ``workloads`` only where it lists
        the cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _module(os.path.join(self.bench_dir, "metrics",
                                    metric + ".py"),
                       f"bench_metric_{metric.replace('.', '_')}").read
