"""Training observability: a JSONL metric log and TensorBoard when present.

Counterpart of ``waveunet_tpu/train/metrics.py``: the same append-only
``metrics.jsonl`` under ``<log_dir>/<experiment_id>/`` with the same record
keys (``step``, ``time`` and the scalars), mirrored to tensorboardX when it
is installed. A ``torch.profiler`` trace of the port's work is the
``profile`` command's (``cli.py``).
"""

from __future__ import annotations

import json
import os
import time


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
