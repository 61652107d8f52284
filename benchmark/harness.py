"""One run of one cell: set-up, the measured window, the check, the line.

``run`` sets up the cell's system and traffic (``serving.Serving`` or
``training.Training``, by the traffic's ``kind``), times the window with
tracing off (``trace=False``: the end-to-end metrics) or under the
profiler (``trace=True``: the per-layer metrics, read by the cell's
readers in ``metrics/``), reads the peak memory, frees the program's
state, runs the reference over what the window produced, and returns the
result line's object with the check's readings. ``rehearsal`` runs the
same code on the CPU at a tiny size for the benchmark's own tests; it
reports no measured metric.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
from types import SimpleNamespace
from typing import Dict, Mapping, Optional

import torch

from benchmark import catalog, families
from benchmark import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "waveunet_tpu")

UNITS = {"separated_audio_s_per_s": "audio-s/s",
         "clip_latency_p95_ms": "ms",
         "trained_audio_s_per_s": "audio-s/s",
         "setup_s": "s"}

# The CPU rehearsal's cut of a traffic mix: lengths only. The model
# family's ``TINY`` cuts the configuration.
TINY_MIX = {"lengths_s": {"min": 0.3, "max": 1.0, "count": 3,
                          "spacing": "linear"},
            "batch": 2, "check_extra": 1}


class RunError(RuntimeError):
    """A run that must end without a result line (exit code ``code``)."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def check_imports() -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: "
                       f"{', '.join(found[:10])}", 4)


def process_age() -> float:
    """Seconds since this process started (Linux's /proc clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def power_limit() -> Optional[str]:
    """nvidia-smi's "name, power.limit" line of the first card, if any: a
    card set below 700 W runs slower under load."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def shrink(cell: Dict) -> Dict:
    """The cell at the rehearsal's size: the family's ``TINY`` and
    ``TINY_MIX``."""
    cell = dict(cell)
    cell["arch"] = dict(cell["arch"], **families.of(cell["arch"]).TINY)
    cell["mix"] = dict(cell["mix"], **{k: v for k, v in TINY_MIX.items()
                                       if k in cell["mix"]})
    return cell


def set_up(cell: Mapping, seed: int, device: torch.device,
           control: Optional[str] = None):
    """The cell's system under test and traffic, set up."""
    kind = cell["mix"]["kind"]
    if kind == "separate":
        from benchmark import serving
        system = (serving.reference_system(control) if control else None)
        return serving.Serving(cell, seed, device, system)
    if kind == "train":
        from benchmark import training
        return training.Training(cell, seed, device, control)
    raise ValueError(f"traffic kind {kind!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, trace: bool = False,
        rehearsal: bool = False, control: Optional[str] = None) -> Dict:
    cell = catalog.cell(name)
    families.of(cell["arch"])  # an unknown network is refused first
    try:
        import waveunet_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        raise RunError(f"the program is missing: {e}", 2) from e
    if rehearsal:
        cell, device, trace = shrink(cell), torch.device("cpu"), False
    else:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card",
                           2)
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} found", 2)
        device = torch.device("cuda", 0)
    from benchmark import port
    d = set_up(cell, seed, device, control)
    _sync(device)
    setup_s = process_age()
    held: Dict = {}
    c0 = port.launch_counts()
    if trace:
        with tr.profiled(held):
            with tr.window():
                w = d.window(seconds, torch.profiler.record_function)
                _sync(device)
            c1 = port.launch_counts()
    else:
        w = d.window(seconds, lambda _: contextlib.nullcontext())
        _sync(device)
        c1 = port.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    e2e = d.end_to_end(w)
    ctx = SimpleNamespace(cell=cell, work=d.work(w),
                          timeline=held.get("timeline"),
                          launches={k: c1[k] - c0[k] for k in c1})
    d.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = d.check(w)
    check_imports()  # what the program loaded, the reference's run too
    return result(cell, w, e2e, setup_s, ctx, checks, peak, trace,
                  rehearsal, device), checks


def result(cell, w, e2e, setup_s, ctx, checks, peak, trace, rehearsal,
           device) -> Dict:
    limits = cell["limits"]
    judged = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    correct = (w["failed"] == 0 and checks.get("compared", 1) > 0
               and all(v["value"] <= v["limit"] for v in judged.values()))
    metrics: Dict = {}
    names = cell["mix"]["end_to_end"]
    if trace or rehearsal:  # a rehearsal has no timeline: counts only
        for mname, reader in catalog.metric_readers().items():
            if reader.MOVES in names:
                v = reader.read(ctx)
                if v is not None:
                    metrics[mname] = {"value": v, "unit": reader.UNIT}
    else:
        for mname in names:
            metrics[mname] = {"value": e2e[mname], "unit": UNITS[mname]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if rehearsal:
        dev = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0,
               "memory_peak_bytes": None}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": peak,
               "power_limit": power_limit()}
    out = {"correct": bool(correct),
           "attempted": w["attempted"],
           "failed": w["failed"], "metrics": metrics, "device": dev}
    tl = ctx.timeline
    if trace and tl is not None:
        dev["busy_s"], dev["window_s"] = tl.busy_s, tl.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tl.device_ops],
                            "idle_gaps": [list(x) for x in tl.idle_gaps]}
    out["checks"] = judged
    return out
