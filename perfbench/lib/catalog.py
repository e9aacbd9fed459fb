"""Finds a cell's parts by name, so that a configuration, a traffic mix,
a cell's limits or a metric is added as a file and an entry, never by an
edit: the cell in ``BENCHMARK.json``, its configuration at the entry's
``file``, its traffic at ``<paths[0]>/traffic/<traffic>.json``, its
correctness limits at ``<paths[0]>/limits/<cell>.json`` and each
metric's reader at ``<paths[0]>/metrics/<metric>.py`` (a module with
``read(run) -> float | None``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from .spec import ModelSpec, from_config


class Catalog:
    def __init__(self, bench_path: Path):
        self.bench_path = Path(bench_path)
        self.root = self.bench_path.parent
        self.bench = json.loads(self.bench_path.read_text())
        self.home = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> Dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in {self.bench_path}")

    def config(self, name: str) -> Dict:
        for cfg in self.bench["configs"]:
            if cfg["name"] == name:
                return json.loads((self.root / cfg["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.bench_path}")

    def spec(self, name: str) -> ModelSpec:
        return from_config(name, self.config(name))

    def traffic(self, name: str) -> Dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.home / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics this cell reports: the end-to-end ones without
        ``trace``, the per-layer ones with it."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
