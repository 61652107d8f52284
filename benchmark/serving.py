"""Serving cells: one caller, a closed loop on ``Separator.separate``.

The mix's pool of requests (lengths from its traffic file, audio from the
seed) cycles in a seeded order. Each request is a whole ``separate`` call,
host audio in and host stems out; the next starts when it returns. The
window runs from the first request's start to the completion of the first
request that ends ``--seconds`` or more after it.

Set-up: the weights and the pool on the card, a ``Separator``, its
``precompile`` up to the mix's longest request (as the command line's
warm-up does), and ``warm_up``.

Answers kept for the check: the first request of every pool entry and a
seeded sample of the later ones, each compared with the reference once
the window has closed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

from benchmark import inputs, work
from benchmark.reference import engine, shapes


def model_frames(arch: Mapping, n: int, sr: int) -> int:
    """A request's frames at the model's rate."""
    return -(-n * arch["expected_sr"] // sr)


def windows_needed(arch: Mapping, frames: int) -> int:
    in_len, out_len = shapes.get_padding(arch, shapes.infer_frames(arch))
    return -(-max(frames, in_len) // out_len)


class Serving:
    """The system under test and its traffic for one run."""

    def __init__(self, cell: Mapping, seed: int, device: torch.device,
                 system: Callable = None):
        self.arch, self.mix = cell["arch"], cell["mix"]
        self.device = device
        self.params = inputs.weights(self.arch, seed, device)
        self.sr = self.mix["input_sr"] or self.arch["expected_sr"]
        self.lengths = inputs.lengths_s(self.mix["lengths_s"])
        self.pool = inputs.songs(self.lengths, self.sr, seed, device)
        if device.type == "cuda":  # the peak is the program's, from here
            torch.cuda.reset_peak_memory_stats(device)
        self.order = inputs.order(len(self.pool), seed)
        self.system = (system or port_system)(self)
        self.warm_up()
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        self.keep = set(range(len(self.pool))) | {
            len(self.pool) + int(i) for i in rng.choice(
                4 * len(self.pool), size=self.mix["check_extra"],
                replace=False)}

    def warm_up(self) -> None:
        """One request as long as the mix's longest, at the model's rate
        (the host buffers grow to their largest), and where the mix comes
        at another rate, a short one through the resampler."""
        model_sr = self.arch["expected_sr"]
        frames = model_frames(self.arch, max(len(p) for p in self.pool),
                              self.sr)
        self.system(np.zeros((frames, 2), np.float32), model_sr)
        if self.sr != model_sr:
            self.system(self.pool[0][:self.sr], self.sr)

    def window(self, seconds: float, span: Callable) -> Dict:
        """The closed loop, each request inside ``span(name)``; returns the
        window's requests and length."""
        reqs: List[Dict] = []
        failed = 0
        t_start = time.perf_counter()
        i = 0
        while True:
            entry = self.order[i % len(self.order)]
            song = self.pool[entry]
            t0 = time.perf_counter()
            try:
                with span("request"):
                    out = self.system(song, self.sr)
            except Exception as e:  # a failed request, counted
                print(f"request {i} failed: {type(e).__name__}: {e}")
                out, failed = None, failed + 1
            t1 = time.perf_counter()
            frames = model_frames(self.arch, song.shape[0], self.sr)
            reqs.append(dict(entry=entry, audio_s=song.shape[0] / self.sr,
                             latency_s=t1 - t0,
                             windows=windows_needed(self.arch, frames),
                             out=out if i in self.keep else None,
                             ok=out is not None))
            i += 1
            if t1 - t_start >= seconds:
                return {"requests": reqs, "window_s": t1 - t_start,
                        "attempted": len(reqs), "failed": failed}

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        reqs = w["requests"]
        audio = sum(r["audio_s"] for r in reqs if r["ok"])
        lat = np.array([r["latency_s"] for r in reqs]) * 1e3
        return {"separated_audio_s_per_s": audio / w["window_s"],
                "clip_latency_p95_ms": float(np.percentile(lat, 95))}

    def work(self, w: Dict) -> Dict:
        """What the window's requests needed, for the per-layer readers."""
        in_len, _ = shapes.get_padding(self.arch,
                                       shapes.infer_frames(self.arch))
        calls = [c for r in w["requests"]
                 for c in work.request_calls(self.arch, in_len,
                                             r["windows"])]
        return {"calls": calls,
                "flops": sum(c.flops for c in calls if c.op != "interp")}

    def check(self, w: Dict) -> Dict[str, float]:
        """The widest gap of a kept stem sample from the reference's, over
        every kept request (the reference runs once a pool entry)."""
        refs: Dict[int, Dict[str, np.ndarray]] = {}
        worst = 0.0
        n = 0
        for r in w["requests"]:
            if r["out"] is None:
                continue
            e = r["entry"]
            if e not in refs:
                refs[e] = engine.separate(self.params, self.arch,
                                          self.pool[e], self.sr, self.device,
                                          batch=self.arch["infer_batch"])
            worst = max(worst, stem_gap(r["out"], refs[e]))
            n += 1
        return {"stem_gap": worst, "compared": n}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.system = None


def stem_gap(out: Mapping, ref: Mapping) -> float:
    """max |out - ref| over every stem and sample; inf where a stem is
    missing, misshapen or not finite."""
    if set(out) != set(ref):
        return float("inf")
    worst = 0.0
    for k, r in ref.items():
        o = np.asarray(out[k])
        if o.shape != r.shape or not np.isfinite(o).all():
            return float("inf")
        worst = max(worst, float(np.max(np.abs(o - r))))
    return worst


def port_system(s: Serving) -> Callable:
    """``Separator.separate`` of the port, its graphs captured up to the
    mix's longest request."""
    from benchmark import port
    return port.separator(s.arch, s.params, s.device, max(s.lengths))


def reference_system(precision: str) -> Callable:
    """The reference in the program's place (the control)."""
    def make(s: Serving) -> Callable:
        def separate(mix, sr):
            return engine.separate(s.params, s.arch, mix, sr, s.device,
                                   precision, batch=s.arch["infer_batch"])
        return separate
    return make
