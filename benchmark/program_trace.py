"""The program's own spans, for the per-layer readers of the engine.

Beside ``port.py``, the benchmark's only other contact with the program.
``waveunet_tpu_torch.tracing`` keeps a record of the spans inside
``Separator.separate`` and the resampler while a torch profiler records:
in a ``--trace 1`` run, the measured window alone (``trace.profiled``).
A program without that module keeps no record, and the readers then
read nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


def record() -> Optional[Dict]:
    """The program's record (``{"spans": {name: (count, total_s,
    self_s)}, "counters": {...}}``), or None where it keeps none."""
    try:
        from waveunet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.record()


def total_s(rec: Dict, name: str) -> float:
    """Seconds in every span ``name`` of the record."""
    return rec["spans"].get(name, (0, 0.0, 0.0))[1]


def host_s(rec: Dict) -> float:
    """Seconds in ``separate`` with the host not waiting on the card."""
    return total_s(rec, "separate") - total_s(rec, "separate.wait")


def wait_s(rec: Dict) -> float:
    return total_s(rec, "separate.wait")


def resample_s(rec: Dict) -> float:
    return total_s(rec, "resample")


def window_share(ctx, seconds: Callable[[Dict], float]) -> Optional[float]:
    """Percent of the traced window that ``seconds(record)`` is; None
    without a timeline, or where the program recorded no ``separate``."""
    if ctx.timeline is None:
        return None
    rec = record()
    if rec is None or "separate" not in rec["spans"]:
        return None
    return 100.0 * seconds(rec) / ctx.timeline.window_s
