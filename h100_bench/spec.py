"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

- the configuration: the file that the ``configs`` entry names (its
  ``family`` names the plain reference, ``reference/<family>.py``);
- the traffic mix: ``traffic/<traffic>.json`` (its ``kind`` names the
  general driver, ``drivers/<kind>.py``);
- the limits of the comparison that decides ``correct``:
  ``limits/<cell>.json``;
- the per-layer metrics whose ``workloads`` list the cell:
  ``metrics/<name>.py``, each a ``read(ctx)`` returning a number or None.

Adding a cell takes a ``BENCHMARK.json`` entry and, where new, these files;
no code changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def family(self):
        return importlib.import_module(f"h100_bench.reference.{self.config['family']}")

    @property
    def driver(self):
        return importlib.import_module(f"h100_bench.drivers.{self.mix['kind']}")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"unknown workload {name!r}; have "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"]
    return Cell(name=name, chips=work["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                mix=json.loads((HERE / "traffic" / f"{work['traffic']}.json").read_text()),
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
