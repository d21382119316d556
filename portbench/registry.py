"""Find the benchmark's parts by name.

Each configuration, cell, entry and metric is a file of its own, looked
up by the name `BENCHMARK.json` gives it:

  configs/<name>.json   a configuration: sizes, source, cuts, guarantee
  cells/<name>.json     a cell: its configuration, entry, input and loop
  entries/<name>.py     how one job calls the program, and what of its
                        output the reference checks
  metrics/<name>.py     a metric's reader: read(ctx) -> number or None

Later cells, configurations and metrics add files; none edits one.
`Registry(roots)` searches each root in turn, so a test can put
throwaway parts in a directory of its own ahead of the committed ones.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, roots=(HERE,), benchmark: dict = None):
        self.roots = list(roots)
        self._modules = {}
        if benchmark is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                benchmark = json.load(f)
        self.benchmark = benchmark

    def _path(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            path = os.path.join(root, kind, name + ext)
            if os.path.exists(path):
                return path
        raise KeyError(f"no {kind}/{name}{ext} under {self.roots}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self._path(kind, name, ".json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        path = self._path(kind, name, ".py")
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name}".replace("-", "_")
                .replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def entry(self, name: str):
        return self._module("entries", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def workload(self, name: str) -> dict:
        """The cell's line in BENCHMARK.json's `workloads`."""
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The BENCHMARK.json metrics a run of `cell` reports: the
        end-to-end ones without a trace, the per-layer ones with it;
        a metric with `workloads` only in the cells it lists."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark[kind]
                if cell in m.get("workloads", [cell])]
