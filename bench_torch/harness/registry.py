"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

Layout under the benchmark's folder (``ROOT``), one file a part, so that a
later change adds a configuration, a traffic mix, a kind of work or a
per-layer metric by adding files and entries, never by editing one:

- ``configs/<config>.json``: the configuration as it is run (its sizes, the
  program's preset, ``source``, ``reduced``, ``assumed``, the deployment).
- ``traffic/<mix>.json``: parameters of a mix; ``driver`` names its kind.
- ``drivers/<kind>.py``: a class ``Driver`` that runs that kind of work.
- ``reference/<family>.py``: the plain PyTorch reference of a model family.
- ``limits/<workload>.json``: the limits that decide ``correct`` in a cell.
- ``metrics/<metric>.py``: a function ``read(records)`` for one metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


class Registry:
    """The benchmark file and the folder whose files it names."""

    def __init__(self, bench_path: Optional[Path] = None, root: Optional[Path] = None):
        self.root = Path(root or ROOT)
        self.bench_path = Path(bench_path or self.root.parent / "BENCHMARK.json")
        with open(self.bench_path) as f:
            self.bench = json.load(f)
        self._modules: Dict[Path, ModuleType] = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.bench_path}")

    def _json(self, sub: str, name: str) -> dict:
        with open(self.root / sub / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def module(self, sub: str, name: str) -> ModuleType:
        """``<root>/<sub>/<name>.py``, loaded once (names may hold dots)."""
        path = self.root / sub / f"{name}.py"
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"bench_torch_{sub}_{name}".replace(".", "_").replace("-", "_"), path)
            if spec is None or spec.loader is None:
                raise ImportError(f"cannot load {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics a cell reports: those with no
        ``workloads`` key and those that list the cell."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics a cell reports: those that list it (every
        per-layer entry names its cells)."""
        return [m for m in self.bench["per_layer"] if workload in m["workloads"]]
