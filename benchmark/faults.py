"""Faults planted in the program's timed path, for the check's own tests.

Each is a context manager that breaks one thing where the program does
it, for the benchmark's tests (on the CPU, in the rehearsal) and for the
readings that set a limit's upper end (``calibrate.py``, on the card).
A check that passes with any of them planted is no check.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def answer_altered():
    """``separate`` returns its first stem with one sample moved by 0.01."""
    from waveunet_tpu_torch.infer.engine import Separator
    real = Separator.separate

    def separate(self, mix, sr):
        out = real(self, mix, sr)
        first = next(iter(out))
        out[first] = out[first].copy()
        out[first][out[first].shape[0] // 2, 0] += 0.01
        return out

    with mock.patch.object(Separator, "separate", separate):
        yield


@contextlib.contextmanager
def half_windows():
    """Each chunk's forward leaves out the second half of its windows
    (their outputs are zero)."""
    from waveunet_tpu_torch.infer.engine import Separator
    real = Separator._chunk_fwd

    def chunk_fwd(self, params, song, pos):
        out = real(self, params, song, pos)
        half = (pos.shape[0] + 1) // 2
        return {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                for k, v in out.items()}

    with mock.patch.object(Separator, "_chunk_fwd", chunk_fwd):
        yield


@contextlib.contextmanager
def state_unchanged():
    """Adam's update does nothing: every step returns its state as it was."""
    from waveunet_tpu_torch.train.step import Adam
    with mock.patch.object(Adam, "update_", lambda self, p, g, s: None):
        yield


@contextlib.contextmanager
def half_batch():
    """The loss is the mean over the first half of the batch's rows."""
    from waveunet_tpu_torch.train import step
    real = step.make_loss_fn

    def make_loss_fn(cfg, training, mesh=None):
        fn = real(cfg, training, mesh)

        def loss_fn(params, state, batch, generator=None):
            half = {k: v[:(v.shape[0] + 1) // 2] for k, v in batch.items()}
            return fn(params, state, half, generator)
        return loss_fn

    with mock.patch.object(step, "make_loss_fn", make_loss_fn):
        yield


@contextlib.contextmanager
def loss_altered():
    """The loss the step returns, and so its gradients, 0.1% too large."""
    from waveunet_tpu_torch.train import step
    real = step.make_loss_fn

    def make_loss_fn(cfg, training, mesh=None):
        fn = real(cfg, training, mesh)

        def loss_fn(params, state, batch, generator=None):
            loss, new_state = fn(params, state, batch, generator)
            return loss * 1.001, new_state
        return loss_fn

    with mock.patch.object(step, "make_loss_fn", make_loss_fn):
        yield


SERVING = {"answer_altered": answer_altered, "half_windows": half_windows}
TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "loss_altered": loss_altered}
ALL = {**SERVING, **TRAINING}
