"""Checkpoints of the training state, in the port's own format.

Counterpart of ``waveunet_tpu/train/checkpoint.py`` without orbax: every
save is one directory ``<model_base_dir>/<experiment_id>/step_<10 digits>``
holding ``state.pt``, a ``torch.save`` of ``{"params", "model_state",
"opt_state", "step"}`` with every tensor on the host. A save is written
under a temporary name beside its final one and renamed into place, so a
crash leaves at most a ``step_X.tmp-...`` directory, which neither
``latest_checkpoint`` nor the retention policy counts.

``save_checkpoint_async`` snapshots the state on its device (one copy of
each tensor, enqueued before the next step updates the originals in place),
then copies it to the host, writes it and applies the retention policy in
one background thread; ``wait_for_saves`` joins and re-raises, and
``after_saves`` runs a callable after every write queued before it (the
best-model marker must never name a directory still being written).
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import torch

_STEP_DIR = re.compile(r"^step_\d+$")
STATE_FILE = "state.pt"


def _is_step_dir(name: str) -> bool:
    """Exactly ``step_<digits>``: a crashed write's temporary sibling is
    never resumed from nor counted."""
    return bool(_STEP_DIR.fullmatch(name))


def step_path(base_dir: str, experiment_id: str, step: int) -> str:
    return os.path.abspath(os.path.join(base_dir, str(experiment_id),
                                        f"step_{step:010d}"))


def _map(state: Any, fn: Callable) -> Any:
    """Apply ``fn`` to every tensor of a nested dict; other leaves pass."""
    if isinstance(state, dict):
        return {k: _map(v, fn) for k, v in state.items()}
    return fn(state) if isinstance(state, torch.Tensor) else state


def _write(path: str, host_state: Any) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(host_state, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):  # a save of the same step replaces it
        shutil.rmtree(path)
    os.rename(tmp, path)


def save_checkpoint(base_dir: str, experiment_id: str, step: int,
                    state: Any) -> str:
    """Write ``state`` now; returns the step directory's path."""
    path = step_path(base_dir, experiment_id, step)
    _write(path, _map(state, lambda t: t.detach().cpu()))
    return path


class AsyncWriter:
    """One background writer thread (made on first use) and its queue of
    pending writes, at most ``max_in_flight`` of them."""

    def __init__(self, max_in_flight: int = 2):
        self.max_in_flight = max_in_flight
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def _submit(self, fn: Callable) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-write")
        self._pending.append(self._pool.submit(fn))

    def save(self, base_dir: str, experiment_id: str, step: int, state: Any,
             prune_keep: int = 0, protect=()) -> str:
        path = step_path(base_dir, experiment_id, step)
        # bound the snapshots held on the device and how late an error shows
        while len(self._pending) >= self.max_in_flight:
            self._pending.pop(0).result()
        snap = _map(state, lambda t: t.detach().clone())
        ready = None
        if any(t.is_cuda for t in _tensors(snap)):
            ready = torch.cuda.Event()
            ready.record()

        def write():
            if ready is not None:
                ready.synchronize()
            _write(path, _map(snap, lambda t: t.cpu()))
            if prune_keep > 0:
                prune_checkpoints(base_dir, experiment_id, prune_keep,
                                  protect=tuple(protect) + (path,))

        self._submit(write)
        return path

    def wait(self) -> None:
        while self._pending:
            self._pending.pop(0).result()

    def after(self, fn: Callable[[], None]) -> None:
        if not self._pending:
            fn()
        else:
            self._submit(fn)


def _tensors(state: Any) -> List[torch.Tensor]:
    if isinstance(state, dict):
        return [t for v in state.values() for t in _tensors(v)]
    return [state] if isinstance(state, torch.Tensor) else []


_writer = AsyncWriter()


def save_checkpoint_async(base_dir: str, experiment_id: str, step: int,
                          state: Any, prune_keep: int = 0,
                          protect=()) -> str:
    """Snapshot ``state`` on its device now, then write it (and prune to the
    newest ``prune_keep``, never the paths in ``protect`` nor this one) in
    the background. Returns the final path at once; ``wait_for_saves`` must
    run before that path is restored."""
    return _writer.save(base_dir, experiment_id, step, state, prune_keep,
                        protect)


def wait_for_saves() -> None:
    """Block until every background write has landed; re-raises the first
    write error."""
    _writer.wait()


def after_saves(fn: Callable[[], None]) -> None:
    """Run ``fn()`` after every write pending now, without blocking: on the
    writer thread behind them, or at once when none is pending."""
    _writer.after(fn)


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The state saved at ``path`` (a step directory); tensors on the host
    unless ``map_location`` says otherwise."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location or "cpu", weights_only=True)


def prune_checkpoints(base_dir: str, experiment_id: str, keep: int,
                      protect=()) -> None:
    """Keep the newest ``keep`` step directories (0 keeps all, as the
    reference's Saver did); paths in ``protect`` are never removed."""
    if keep <= 0:
        return
    d = os.path.join(base_dir, str(experiment_id))
    if not os.path.isdir(d):
        return
    protected = {os.path.abspath(p) for p in protect if p}
    steps = sorted(f for f in os.listdir(d) if _is_step_dir(f))
    for f in steps[:-keep]:
        path = os.path.abspath(os.path.join(d, f))
        if path not in protected:
            shutil.rmtree(path, ignore_errors=True)


def latest_checkpoint(base_dir: str, experiment_id: str) -> Optional[str]:
    d = os.path.join(base_dir, str(experiment_id))
    if not os.path.isdir(d):
        return None
    steps = [f for f in os.listdir(d) if _is_step_dir(f)]
    if not steps:
        return None
    return os.path.join(d, max(steps))
