"""Finds the benchmark's pieces by name: nothing here names a cell.

  * ``configs/<config>.json``: a configuration's keys as it is run, its
    source, and what was cut (``reduced``) or assumed (``assumed``);
  * ``traffic/<mix>.json``: a traffic mix, the parameters that
    ``inputs.py``, ``serving.py`` and ``training.py`` read;
  * ``workloads/<cell>.json``: a cell: its configuration, its traffic, its
    chips and the limits of its correctness check;
  * ``metrics/<metric>.py``: a per-layer metric's reader.

A later cell, configuration, mix or metric is a new file here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def _path(kind: str, name: str, ext: str = ".json") -> str:
    return os.path.join(HERE, kind, name + ext)


def _names(kind: str, ext: str) -> List[str]:
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind))
                  if f.endswith(ext))


def load(kind: str, name: str) -> Dict:
    with open(_path(kind, name)) as f:
        return json.load(f)


def cells() -> List[str]:
    return _names("workloads", ".json")


def cell(name: str) -> Dict:
    """The cell ``name`` with its configuration (``arch``) and traffic
    (``mix``) loaded."""
    if name not in cells():
        raise KeyError(f"no cell {name!r}; cells: {', '.join(cells())}")
    c = load("workloads", name)
    c["name"] = name
    c["arch"] = load("configs", c["config"])
    c["mix"] = load("traffic", c["traffic"])
    return c


def metric_readers() -> Dict[str, ModuleType]:
    """Every per-layer metric's reader module, by metric name. A reader
    defines ``MOVES`` (the end-to-end metric it should move), ``UNIT``,
    ``LAYER`` and ``read(ctx)``, which returns a number or None."""
    out = {}
    for name in _names("metrics", ".py"):
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{len(out)}", _path("metrics", name, ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
