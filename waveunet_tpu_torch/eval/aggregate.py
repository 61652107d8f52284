"""Metric aggregation over per-track JSON results.

The port's copy of ``waveunet_tpu/eval/aggregate.py``, writing and reading
the same JSON bytes, so either package aggregates the other's results. It
mirrors the reference's ``compute_mean_metrics`` (``Evaluate.py:195-231``):
collects per-frame metric values per instrument from a folder of
museval-style JSONs and returns NaN-aware (median, MAD, mean, SD) per source.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np


def write_track_json(path: str, track_name: str, targets: Dict[str, Dict[str, np.ndarray]],
                     win: float = 1.0, hop: float = 1.0):
    """Write one track's framewise metrics in museval's JSON schema."""
    out = {"targets": [], "museval_version": "waveunet_tpu-bsseval"}
    for name, metrics in targets.items():
        frames = []
        n_frames = len(next(iter(metrics.values())))
        for fi in range(n_frames):
            frames.append({
                "time": fi * hop,
                "duration": win,
                "metrics": {k: (None if np.isnan(v[fi]) else float(v[fi]))
                            for k, v in metrics.items()},
            })
        out["targets"].append({"name": name, "frames": frames})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # Atomic write: the eval harness resumes by JSON existence, so a file
    # truncated by an interrupt would be both permanently skipped AND crash
    # aggregation.
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, path)


def compute_mean_metrics(json_folder: str, compute_averages: bool = True,
                         metric: str = "SDR", return_names: bool = False):
    """NaN-aware (median, MAD, mean, SD) per source over all segment frames.

    Sources are pooled by target NAME (first-seen order), not by position —
    positional pooling (the reference's approach, `Evaluate.py:208-227`)
    silently cross-contaminates sources when tracks carry different target
    sets or orders. ``return_names=True``
    additionally returns the source-name list aligned with the result.
    """
    files = sorted(glob.glob(os.path.join(json_folder, "*.json")))
    inst: Dict[str, List[float]] = {}
    for path in files:
        # exact-name filter: endswith("test.json") would also drop any TRACK
        # named *test (e.g. "soundtest.json") from the aggregates
        if os.path.basename(path) == "test.json":
            continue
        # Malformed/foreign files must name themselves: a results folder can
        # collect stray JSONs (aborted runs, other tools), and a bare
        # AttributeError from deep inside the walk gives the user nothing to
        # delete (found by fuzzing).
        try:
            with open(path) as f:
                js = json.load(f)
            for i, tgt in enumerate(js.get("targets", []) or []):
                vals = inst.setdefault(str(tgt.get("name", f"target_{i}")),
                                       [])
                for frame in tgt.get("frames") or []:
                    v = (frame.get("metrics") or {}).get(metric)
                    vals.append(np.nan if v is None else float(v))
        except (json.JSONDecodeError, AttributeError, TypeError,
                ValueError) as e:
            raise ValueError(
                f"malformed track-results JSON {path!r}: {e}") from e
    names = list(inst)
    arrays = [np.asarray(v, dtype=np.float64) for v in inst.values()]
    if compute_averages:
        result = [(np.nanmedian(a),
                   np.nanmedian(np.abs(a - np.nanmedian(a))),
                   np.nanmean(a),
                   np.nanstd(a)) for a in arrays]
    else:
        result = arrays
    return (result, names) if return_names else result
