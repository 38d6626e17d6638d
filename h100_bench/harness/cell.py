"""A cell's files, found by the names in ``BENCHMARK.json``.

For the cell ``<config>.<traffic>`` of ``workloads``:

* ``configs/<config>.json``, the configuration as it is run (the entry's
  ``file``), and ``configs/<config>.py``, its hooks: ``make_run``, which
  returns the cell's run (``harness.trainer_run`` for training through the
  program's ``Trainer``), and what that run calls (the program's build,
  the weights, the readings, the counts, the reference);
* ``traffic/<traffic>.json``, the traffic mix, a JSON file of parameters,
  and ``generators/<generator>.py``, the module its ``generator`` key
  names: ``check(mix, path)`` refuses parameters it does not know, and
  ``make_pool(mix, cfg, seed)`` makes the mix's host batches for a
  configuration from the seed (a new mix of an existing generator is a new
  data file);
* ``checks/<cell>.json``, the limit of each number that decides ``correct``;
* ``metrics/<metric>.py`` for each per-layer metric that lists the cell
  under its ``workloads``, a module whose ``read(segment)`` returns the
  metric or None.

An end-to-end metric is reported in every cell, or in those its
``workloads`` lists.

A later change adds a configuration, a mix, a cell or a metric as new files
and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_mix(path: Path) -> Tuple[Dict, ModuleType]:
    """The traffic mix at ``path`` and its generator, the mix checked by it."""
    mix = json.loads(Path(path).read_text())
    if "generator" not in mix:
        raise ValueError(f"{path}: a traffic mix names its generator")
    generator = load_module(BENCH_DIR / "generators" / f"{mix['generator']}.py",
                            f"h100_bench_generator_{mix['generator']}")
    generator.check(mix, path)
    return mix, generator


@dataclass
class Cell:
    name: str
    workload: Dict
    config_entry: Dict
    config: Dict
    model: ModuleType
    mix: Dict
    generator: ModuleType
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, ModuleType]
    run_seconds: int


def load(cell_name: str, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in workloads:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json: {sorted(workloads)}")
    workload = workloads[cell_name]
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    bench_dir = root / "h100_bench"
    model = load_module(bench_dir / "configs" / f"{entry['name']}.py",
                        f"h100_bench_config_{entry['name']}")
    mix, generator = load_mix(bench_dir / "traffic" / f"{workload['traffic']}.json")
    limits = json.loads((bench_dir / "checks" / f"{cell_name}.json").read_text())["limits"]
    end_to_end = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    per_layer = [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      f"h100_bench_metric_{m['name'].replace('.', '_')}")
               for m in per_layer}
    return Cell(cell_name, workload, entry, config, model, mix, generator, limits, end_to_end,
                per_layer, readers, int(bench["run_seconds"]))


__all__ = ["BENCH_DIR", "Cell", "ROOT", "load", "load_mix", "load_module"]
