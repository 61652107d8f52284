"""Serving cells: one caller, a closed loop on ``Separator.separate``.

The mix's pool of requests (lengths from its traffic file, audio from the
seed) cycles in a seeded order. Each request is a whole ``separate`` call,
host audio in and host stems out; the next starts when it returns. The
window runs from the first request's start to the completion of the first
request that ends ``--seconds`` or more after it.

The model is the configuration's family (``families/``): its weights,
window, reference forward and work. Set-up: the weights and the pool on
the card, a ``Separator``, its ``precompile`` up to the mix's longest
request (as the command line's warm-up does), and ``warm_up``.

Answers kept for the check: the first request of every pool entry and a
seeded sample of the later ones, each compared with the reference once
the window has closed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from benchmark import families, inputs, work
from benchmark.reference import engine


def model_frames(arch: Mapping, n: int, sr: int) -> int:
    """A request's frames at the model's rate."""
    return -(-n * arch["expected_sr"] // sr)


def windows_needed(window: Tuple[int, int], frames: int) -> int:
    """The windows of (input, output) lengths ``window`` that a request of
    ``frames`` at the model's rate needs."""
    in_len, out_len = window
    return -(-max(frames, in_len) // out_len)


class Serving:
    """The system under test and its traffic for one run."""

    def __init__(self, cell: Mapping, seed: int, device: torch.device,
                 system: Callable = None):
        self.arch, self.mix = cell["arch"], cell["mix"]
        self.family = families.of(self.arch)
        self.device = device
        self.params, self.state = self.family.weights(self.arch, seed,
                                                      device)
        self.io = self.family.window(self.arch)  # (input, output)
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
                             windows=windows_needed(self.io, frames),
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
        in_len, _ = self.io
        calls = [c for r in w["requests"]
                 for c in work.request_calls(self.family.calls, self.arch,
                                             in_len, r["windows"])]
        return {"calls": calls,
                "flops": sum(c.flops for c in calls
                             if c.op in self.family.FLOP_OPS)}

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
                refs[e] = reference_separate(self)(self.pool[e], self.sr)
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
    return port.separator(s.arch, s.params, s.state, s.device,
                          max(s.lengths))


def reference_separate(s: Serving, precision: str = "fp32") -> Callable:
    """``separate(mix, sr)`` of the reference: the engine's rules over the
    family's reference forward at ``precision``."""
    def forward(wins):
        return s.family.forward(s.params, s.state, s.arch, wins, precision)

    def separate(mix, sr):
        return engine.separate(forward, s.io, s.arch, mix, sr,
                               s.device, batch=s.arch["infer_batch"])
    return separate


def reference_system(precision: str) -> Callable:
    """The reference in the program's place (the control)."""
    return lambda s: reference_separate(s, precision)
