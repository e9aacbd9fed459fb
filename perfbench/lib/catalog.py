"""Finds a cell's parts by name, so that a configuration, a model
family, a traffic mix, a cell's limits or a metric is added as a file
and an entry, never by an edit: the cell in ``BENCHMARK.json``, its
configuration at the entry's ``file``, the configuration's model family
(the file's ``"family"`` key) at ``<paths[0]>/families/<family>.py``
(what the harness asks of an architecture: see ``families/dense.py``),
its traffic at ``<paths[0]>/traffic/<traffic>.json``, its correctness
limits at ``<paths[0]>/limits/<cell>.json`` and each metric's reader at
``<paths[0]>/metrics/<metric>.py`` (a module with ``read(run) -> float |
None``). So a configuration of a new architecture is its file, its
family's module and that family's plain reference, all added as files.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List


def _load(path: Path, name: str) -> ModuleType:
    """The module at ``path``, loaded by path under ``name`` (registered
    in ``sys.modules``, as a dataclass in it needs)."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Catalog:
    def __init__(self, bench_path: Path):
        self.bench_path = Path(bench_path)
        self.root = self.bench_path.parent
        self.bench = json.loads(self.bench_path.read_text())
        self.home = self.root / self.bench["paths"][0]
        self._families: Dict[str, ModuleType] = {}

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

    def family(self, name: str) -> ModuleType:
        """The model family of configuration ``name``, loaded once."""
        family = self.config(name)["family"]
        if family not in self._families:
            self._families[family] = _load(
                self.home / "families" / f"{family}.py",
                "perfbench_family_" + family)
        return self._families[family]

    def spec(self, name: str) -> Any:
        """Configuration ``name`` as its family describes it."""
        return self.family(name).spec(name, self.config(name))

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
        return _load(self.home / "metrics" / f"{metric}.py",
                     "perfbench_metric_" + metric).read
