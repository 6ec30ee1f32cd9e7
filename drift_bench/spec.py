"""A cell, found by name: ``BENCHMARK.json``'s entry, its configuration's
file, its traffic mix (``traffic/<traffic>.json``), its limits
(``checks/<cell>.json``) and the readers of its metrics
(``metrics/<metric>.py``, each with a ``read(run)``).

A later change adds a cell, a traffic mix or a metric by adding files and
entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``'s ``read``."""
        path = self.bench / "metrics" / f"{metric}.py"
        mod_spec = importlib.util.spec_from_file_location(
            f"drift_bench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT, bench: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its data files under
    ``bench`` (``root/drift_bench`` by default)."""
    bench = bench if bench is not None else root / "drift_bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    limits_path = bench / "checks" / f"{name}.json"
    limits = (json.loads(limits_path.read_text())["limits"]
              if limits_path.exists() else {})
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench=bench)
