"""Training cells: the fused epoch on a device-resident bank.

Set-up writes the configuration's training songs (seeded stems and their
mix) into the port's song cache under ``TMPDIR``, builds one
``DeviceBank`` and one fused epoch over its sampler (``make_scanned_epoch``,
one step a call), and drives that epoch through its first three steps from
the seeded weights: the first runs eagerly while the step's CUDA graph is
captured, the next two replay it. The window goes on with the same object,
one call a step, until a step ends ``--seconds`` or more after the
window's start.

The check reruns those first three steps in the reference (the same seeded
weights and songs, the sampler's draws worked out again) and compares each
step's loss (``loss_gap``: the largest relative gap), the first gradient
as Adam received it (its first moment after one step over 1 - b1;
``grad_gap``: the worst leaf's gap of norms over the larger of its
reference norm and the median leaf's), and each leaf's change after three
steps (``change_gap``: the median leaf's gap, measured the same way). The
worst leaf's change gap swings from seed to seed with a few bias elements
whose gradient is all but zero, which Adam's normalised step turns into
moves of either sign; it is reported beside (``change_gap_worst``) and
not judged. A leaf whose reference gradient's norm is under a thousandth
of the median leaf's moves by round-off alone and is left out of the
change (the learned interpolations' weights, at these sizes).

The training window, a step's FLOPs and the reference's steps are the
model family's training hooks (``families/``); a cell whose family has
none is refused before anything is set up.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from benchmark import families, inputs
from benchmark.reference import train as ref
from benchmark.reference.sources import source_names

CHECK_STEPS = 3
MOVED = 1e-3   # a leaf counts in the change if its reference gradient's
               # norm is at least this share of the median leaf's


def _leaves(tree) -> Dict:
    return {(k, n): t for k, v in tree.items() for n, t in v.items()}


def _clone(tree) -> Dict:
    return {kn: t.detach().clone() for kn, t in _leaves(tree).items()}


class Training:
    """The fused epoch and its bank for one run; ``control`` puts the
    reference at that precision in the program's place (no window)."""

    def __init__(self, cell: Mapping, seed: int, device: torch.device,
                 control: str = None):
        self.arch, self.mix = cell["arch"], cell["mix"]
        self.family = families.trainer(self.arch)
        self.device, self.key = device, seed
        self.batch = self.mix["batch"]
        self.in_len, self.out_len = self.family.train_window(self.arch)
        params, self.mstate = self.family.weights(self.arch, seed, device)
        self.p0 = _clone(params)
        self.stems = self._songs(seed)
        if device.type == "cuda":  # the peak is the program's, from here
            torch.cuda.reset_peak_memory_stats(device)
        if control is not None:
            r = self.family.reference_steps(
                params, self.arch, self._bank(), seed, CHECK_STEPS,
                self.batch, self.arch["init_sup_sep_lr"], control)
            self.seen = {"losses": r["losses"], "grads1": r["grads1"],
                         "params": r["params"]}
            self.epoch = None
            return
        self.dir = tempfile.mkdtemp(prefix="bench-bank-")
        try:
            self._write()
            self._start(params)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def _songs(self, seed):
        """[(source -> [n, 2] float32)] of every training song."""
        gen = torch.Generator(device=self.device).manual_seed(seed ^ 0xBA4C)
        n = int(round(self.arch["train_song_s"] * self.arch["expected_sr"]))
        names = source_names(self.arch)
        return [{s: (0.45 * inputs.audio(gen, n, self.arch["expected_sr"],
                                         self.device)).cpu().numpy()
                 for s in names} for _ in range(self.arch["train_songs"])]

    def _bank(self):
        names = source_names(self.arch)
        return [torch.as_tensor(np.stack([ref.quantise(s[k]) for k in names]),
                                device=self.device) for s in self.stems]

    def _write(self):
        from benchmark import port
        d = port.song_dir(self.arch, self.dir)
        os.makedirs(d)
        for i, s in enumerate(self.stems):
            port.write_song(os.path.join(d, f"song_{i:04d}.npz"),
                            dict(s, mix=sum(s.values())))

    def _start(self, params):
        from benchmark import port
        self.bank, self.epoch = port.fused_epoch(self.arch, self.dir,
                                                 self.batch, self.device)
        self.params = params
        self.opt = port.adam_state(self.arch, params)
        losses = []
        for t in range(CHECK_STEPS):
            losses.append(float(self._step(t)[0]))
            if t == 0:
                grads1 = {kn: m / (1 - 0.9)
                          for kn, m in _clone(self.opt["mu"]).items()}
        self.seen = {"losses": losses, "grads1": grads1,
                     "params": _clone(params)}
        self.step = CHECK_STEPS

    def _step(self, t: int) -> np.ndarray:
        return self.epoch(self.params, self.mstate, self.opt, self.key, t)[3]

    def window(self, seconds: float, span: Callable) -> Dict:
        """One fused-epoch call a step; a control has no window."""
        if self.epoch is None:
            return {"steps": 0, "window_s": float(seconds), "failed": 0,
                    "attempted": 0}
        steps = 0
        t_start = time.perf_counter()
        while True:
            with span("step"):
                self._step(self.step)
            self.step += 1
            steps += 1
            t1 = time.perf_counter()
            if t1 - t_start >= seconds:
                return {"steps": steps, "window_s": t1 - t_start,
                        "failed": 0, "attempted": steps}

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        audio = w["steps"] * self.batch * self.out_len / self.arch[
            "expected_sr"]
        return {"trained_audio_s_per_s": audio / w["window_s"]}

    def work(self, w: Dict) -> Dict:
        """The steps' FLOPs: the family's count a window and step."""
        return {"calls": [], "flops": self.family.train_flops(
            self.arch, self.in_len) * self.batch * w["steps"]}

    def free(self) -> None:
        self.epoch = self.bank = self.params = self.opt = None

    def check(self, w: Dict) -> Dict[str, float]:
        """The gaps of the first three steps from the reference's."""
        r = self.family.reference_steps(
            _tree(self.p0), self.arch, self._bank(), self.key, CHECK_STEPS,
            self.batch, self.arch["init_sup_sep_lr"])
        rows = [x for step in r["rows"] for x in step]
        seen = self.seen
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(seen["losses"], r["losses"]))
        g_ref = {kn: float(g.norm()) for kn, g in r["grads1"].items()}
        g_med = float(np.median(list(g_ref.values())))
        grad = {kn: abs(float(seen["grads1"][kn].norm()) - g_ref[kn])
                / max(g_ref[kn], g_med) for kn in g_ref}
        grad_worst = max(grad, key=grad.get)
        moved = [kn for kn in g_ref if g_ref[kn] >= MOVED * g_med]
        d_ref = {kn: float((r["params"][kn] - self.p0[kn]).norm())
                 for kn in moved}
        d_med = float(np.median(list(d_ref.values())))
        change = {kn: abs(float((seen["params"][kn] - self.p0[kn]).norm())
                          - d_ref[kn]) / max(d_ref[kn], d_med)
                  for kn in moved}
        worst = max(change, key=change.get)
        return {"loss_gap": loss_gap, "grad_gap": grad[grad_worst],
                "change_gap": float(np.median(list(change.values()))),
                "rows_repeated": float(len(rows) - len(set(rows))),
                "change_gap_worst": change[worst],
                "change_gap_worst_leaf": "/".join(worst),
                "grad_gap_leaf": "/".join(grad_worst),
                "losses": r["losses"],
                "left_out": sorted("/".join(kn) for kn in g_ref
                                   if kn not in moved)}


def _tree(flat: Mapping) -> Dict:
    out: Dict = {}
    for (k, n), t in flat.items():
        out.setdefault(k, {})[n] = t
    return out
