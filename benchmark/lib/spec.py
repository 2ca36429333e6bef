"""What a run is told, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits and its metric readers.

Every part is a file of its own, so a later change adds a cell, a mix, a
configuration, a reader or a kernel class by adding a file:

- ``configs/<config>.json``: the model, its published sizes and sources,
  ``reduced``, ``assumed`` and the precision;
- ``traffic/<mix>.json``: a mix's parameters; its ``kind`` names the runner
  ``runners/<kind>.py``;
- ``limits/<cell>.json``: the numbers that decide ``correct``, each with its
  limit and the readings it was set from;
- ``metrics/<metric>.py`` (else ``metrics/<metric up to its first dot>.py``):
  a reader with ``read(summary) -> float | None``;
- ``kernel_classes/<class>/*.txt``: kernel-name fragments, one a line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import types
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (every cell, without a ``workloads`` list)."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else benchmark()
    (entry,) = [w for w in bench["workloads"] if w["name"] == name] or [None]
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (config,) = [c for c in bench["configs"] if c["name"] == entry["config"]]
    return Cell(
        name=name, chips=entry["chips"],
        config=load_json(ROOT / config["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def runner(kind: str) -> types.ModuleType:
    return importlib.import_module(f"benchmark.runners.{kind}")


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> types.ModuleType:
    """The reader module of ``metric``: ``metrics/<metric>.py``, else the
    file of its family, ``metrics/<metric up to its first dot>.py``."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for metric {metric!r} under {bench_dir / 'metrics'}")


def kernel_classes(bench_dir: Path = BENCH_DIR) -> dict[str, list[str]]:
    """Each class's name fragments, from every ``.txt`` file in its directory
    (blank lines and ``#`` comments skipped)."""
    out: dict[str, list[str]] = {}
    for d in sorted(p for p in (bench_dir / "kernel_classes").iterdir() if p.is_dir()):
        frags = []
        for f in sorted(d.glob("*.txt")):
            frags += [s.strip() for s in f.read_text().splitlines() if s.strip() and not s.startswith("#")]
        out[d.name] = frags
    return out
