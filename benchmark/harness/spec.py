"""A cell from data: ``BENCHMARK.json`` names it, and its configuration,
traffic mix, output-check limits and per-layer metric readers are files
found by name:

* ``benchmark/configs/<config>.json``: the model configuration as it is
  run (the program's ``Config`` fields, grouped as the program groups
  them), its source, its precision per path; an optional ``reference``
  names its plain reference, ``benchmark/reference/<reference>.py``
  (``steps`` where it names none); its cut for the CPU tests, where it
  has one, is ``benchmark/tests/cuts/<config>.json``;
* ``benchmark/traffic/<traffic>.json``: the mix (sizes, pools, batch,
  fog, and ``kind``);
* ``benchmark/harness/kinds/<kind>.py``: the driver of a mix's kind
  (``serve``, ``train``, ``scda`` so far), with ``run(...)``;
* ``benchmark/limits/<workload>.json``: the limit of each number the
  output check compares, with the readings it was set from;
* ``benchmark/metrics/<metric>.py``: a reader with ``read(run)`` that
  returns the metric's value, or None where it finds nothing to read.

A later cell, mix, configuration, kind or metric is a new file and a new
entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import SimpleNamespace
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


def ns(obj):
    """Nested dicts -> attribute namespaces (lists stay lists)."""
    if isinstance(obj, dict):
        return SimpleNamespace(**{k: ns(v) for k, v in obj.items()})
    return obj


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything its files say."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json; "
                           f"there are {sorted(by_name)}")
        self.entry = by_name[name]
        self.name = name
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[
            self.entry["config"]]
        self.config_dict = load_json(os.path.join(root, cfg_entry["file"]))
        self.cfg = ns({k: self.config_dict[k] for k in
                       ("model", "train", "test", "anchors", "adapt", "data")})
        self.reference = reference(self.config_dict.get("reference", "steps"),
                                   root)
        self.traffic_dict = load_json(os.path.join(
            root, "benchmark", "traffic", self.entry["traffic"] + ".json"))
        self.traffic = ns(self.traffic_dict)
        limits_path = os.path.join(root, "benchmark", "limits", name + ".json")
        limits = load_json(limits_path) if os.path.exists(limits_path) else {}
        self.limits = limits.get("limits", {})
        self.not_compared = set(limits.get("not_compared", {}))
        self.chips = int(self.entry["chips"])

    @property
    def kind(self) -> str:
        return self.traffic.kind

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list that move an end-to-end metric it has."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def _load(kind: str, name: str, path: str):
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: str = ROOT):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    return _load("metric", name, os.path.join(
        root, "benchmark", "metrics", name + ".py")).read


def kind_runner(kind: str, root: str = ROOT):
    """``benchmark/harness/kinds/<kind>.py``'s ``run``; an unknown kind
    raises."""
    if not isinstance(kind, str) or not NAME.match(kind):
        raise KeyError(f"no traffic kind named {kind!r}")
    return _load("kind", kind, os.path.join(
        root, "benchmark", "harness", "kinds", kind + ".py")).run


def reference(name: str, root: str = ROOT):
    """``benchmark/reference/<name>.py``, the plain reference a
    configuration names (the interface: ``reference/__init__.py``); an
    unknown name raises."""
    if not isinstance(name, str) or not NAME.match(name):
        raise KeyError(f"no reference named {name!r}")
    return _load("reference", name, os.path.join(
        root, "benchmark", "reference", name + ".py"))


def readers(cell: Cell) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], cell.root) for m in cell.per_layer()}
