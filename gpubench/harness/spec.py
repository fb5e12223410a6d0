"""What a run is made of, found by name: the cell's entry in
``BENCHMARK.json``, its configuration file, its traffic file, its
correctness limits and the files of its metrics.

* ``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``)
  and the metrics, each naming the cells it is reported in.
* A configuration is the file the entry of ``configs`` names.
* A traffic mix is ``gpubench/traffic/<traffic>.json``.
* A cell's limits are ``gpubench/limits/<cell>.json``.
* A metric is ``gpubench/metrics/<metric>.json``: the reader it uses
  (``gpubench/readers/<reader>.py``, whose ``read(record, **params)``
  returns the value or None) and that reader's parameters.
* The parts of a configuration's task that differ between tasks are named
  by keys of its file (``parts``); a file that names none of them gets the
  GOLF autoencoder's.

Adding a cell, a configuration, a mix or a metric adds files and entries;
none of the harness's code names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent      # gpubench/
ROOT = HERE.parent                                 # the checkout


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def module(package: str, name: str):
    """The module ``gpubench/<package>/<name>.py``."""
    return importlib.import_module(f"gpubench.{package}.{name}")


@dataclasses.dataclass
class Parts:
    """What a configuration file names of its task, each key with its
    default (the GOLF autoencoder's):

    * ``model.class_path``: the task's key in the port's task table
      (``golf_tpu_torch.tasks.cli.BUILD_FNS``), ``VoiceAutoEncoder``; its
      builder takes ``model.init_args``, or the whole ``model`` section
      where it has none;
    * ``reference``: the plain reference, ``gpubench/reference/<name>.py``,
      ``golf``;
    * ``spans``: where a traced run's layer spans come from, ``hooks``
      (``harness/trace.py::Spans``, around the autoencoder's encoder,
      decoder, criterion and optimizer) or ``program`` (the program's own
      recorder, ``golf_tpu_torch.utils.profiling``);
    * ``flops``: the FLOPs count, ``gpubench/counts/<name>.py``, ``flops``;
    * ``faults``: the faults ``control.py`` plants in the program,
      ``<module>.<function>`` of ``gpubench/faults/<module>.py``; without
      the key, those of GOLF's end filter (``harness/faults.py``);
    * ``fields``: the inputs the task's entries take beyond x and f0, each
      a N(0, 1) draw of the shape its ``shape`` gives after the batch's
      rows (``clip`` is the clip's samples, ``clip-<k>`` k fewer),
      ``{"noise": {"shape": ["clip"]}}``.
    """

    task: str
    model: Dict
    reference: str
    spans: str
    flops: str
    faults: Optional[List[str]]
    fields: Dict[str, Dict]


SPANS = ("hooks", "program")
FIELDS = {"noise": {"shape": ["clip"]}}     # the GOLF decoder's noise


def parts(config: Dict) -> Parts:
    """The parts that ``config`` (a configuration file's dict) names."""
    model = config["model"]
    out = Parts(
        task=model.get("class_path", "VoiceAutoEncoder").rpartition(".")[2],
        model=model.get("init_args", model),
        reference=config.get("reference", "golf"),
        spans=config.get("spans", "hooks"),
        flops=config.get("flops", "flops"),
        faults=config.get("faults"),
        fields=config.get("fields", FIELDS))
    if out.spans not in SPANS:
        raise ValueError(f"spans {out.spans!r} is not one of {SPANS}")
    return out


def reference(config: Dict):
    """The configuration's reference module."""
    return module("reference", parts(config).reference)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    reader: str
    params: Dict

    def read(self, record: Dict) -> Optional[float]:
        mod = module("readers", self.reader)
        value = mod.read(record, **self.params)
        return None if value is None else float(value)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def metric(entry: Dict, base: Path = HERE) -> Metric:
    data = load_json(base / "metrics" / f"{entry['name']}.json")
    params = {k: v for k, v in data.items() if k != "reader"}
    return Metric(entry["name"], entry["unit"], entry["better"],
                  data["reader"], params)


def in_cell(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    files; raises KeyError for a cell that is not there."""
    if bench is None:
        bench = load_json(root / "BENCHMARK.json")
    base = root / "gpubench"
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        config=load_json(root / conf["file"]),
        traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        chips=entry["chips"],
        end_to_end=[metric(m, base) for m in bench["end_to_end"]
                    if in_cell(m, name)],
        per_layer=[metric(m, base) for m in bench["per_layer"]
                   if in_cell(m, name)])
