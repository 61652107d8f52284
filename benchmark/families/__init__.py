"""The model families the benchmark can serve, one module each.

A configuration file's ``"network"`` key names its family: the module
``families/<network>.py``. A second family is a new module here and its
plain reference under ``reference/``; no other file of the harness names
a family. A family module defines:

  * ``TINY``: the CPU rehearsal's cut of the configuration (widths and
    lengths only);
  * ``weights(arch, seed, device) -> (params, state)``: the seeded
    parameters and the model's state, made on ``device`` in one draw
    (``inputs.uniform_leaves``);
  * ``window(arch) -> (in_len, out_len)``: the inference window;
  * ``forward(params, state, arch, wins, precision)``: the reference
    forward over windows ``wins`` [k, in_len, C] at ``precision``
    (``"fp32"``, or the control's ``"tf32"``), -> {source: [k, out_len,
    C]} for every source the network computes (the difference source is
    the engine's rule, ``reference/engine.py``);
  * ``calls(arch, in_len, b) -> [work.Call]``: the work of one forward over
    ``b`` windows, in the order the model runs it;
  * ``FLOP_OPS``: the ``Call.op`` names whose FLOPs ``work["flops"]``
    counts (the mfu readers' numerator).

A family that can be trained (a ``"train"`` cell, ``training.py``) also
defines the ``TRAINING_HOOKS``: ``train_window(arch) -> (in_len,
out_len)``, ``train_flops(arch, in_len)`` (a training step's FLOPs a
window) and ``reference_steps`` (the reference's first steps, with the
signature of ``reference/train.py::run_steps``).
"""

from __future__ import annotations

import importlib
import os
from types import ModuleType
from typing import List, Mapping

HERE = os.path.dirname(os.path.abspath(__file__))
TRAINING_HOOKS = ("train_window", "train_flops", "reference_steps")


class FamilyError(ValueError):
    """A configuration the harness cannot run: no result line."""
    code = 2


def names() -> List[str]:
    """The families there are: the modules of this directory."""
    return sorted(f[:-3] for f in os.listdir(HERE)
                  if f.endswith(".py") and f != "__init__.py")


def of(arch: Mapping) -> ModuleType:
    """The family module of the configuration ``arch``."""
    network = arch.get("network")
    if network not in names():
        raise FamilyError(f"no model family for network {network!r}; "
                          f"families: {', '.join(names())}")
    return importlib.import_module(f"{__name__}.{network}")


def trainer(arch: Mapping) -> ModuleType:
    """The family of ``arch`` where it can be trained; refused otherwise,
    before a training cell sets anything up."""
    family = of(arch)
    missing = [h for h in TRAINING_HOOKS if not hasattr(family, h)]
    if missing:
        raise FamilyError(f"network {arch['network']!r} has no training "
                          f"hooks ({', '.join(missing)}): a 'train' cell "
                          f"cannot run it")
    return family
