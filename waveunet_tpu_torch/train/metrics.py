"""Training observability: a JSONL metric log, TensorBoard when present,
and a ``torch.profiler`` trace.

Counterpart of ``waveunet_tpu/train/metrics.py``: the same append-only
``metrics.jsonl`` under ``<log_dir>/<experiment_id>/`` with the same record
keys (``step``, ``time`` and the scalars), mirrored to tensorboardX when it
is installed.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator


class MetricLogger:
    def __init__(self, log_dir: str, experiment_id: str,
                 use_tensorboard: bool = True):
        self.dir = os.path.join(log_dir, str(experiment_id))
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(self.dir)

    def log(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the CPU and, where there is
    one, the CUDA device) and write it to ``log_dir`` as a Chrome trace;
    the counterpart of the JAX package's start/stop profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{int(time.time())}.json"))
