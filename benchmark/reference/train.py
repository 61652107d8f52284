"""Training steps, written from the trainer's documented semantics.

The bank holds each song's sources as int16, ``round(clip(x, -1, 1) *
32767)``. Step ``t`` of stream ``key`` draws, for every row of the batch,
62-bit integers from a counter-based hash (splitmix64's finaliser ``mix``
over 64-bit words): ``h = mix(t + mix(key))`` and lane ``l`` of row ``b``
is ``mix(h + b * lanes + l) >> 2``. Lane 0 picks the song (modulo the song
count), lane 1 the window's start (modulo the song's length minus the
input length, at least 1), lanes 2.. each source's gain, ``0.7 + 0.3 * u``
with ``u`` the draw's top 24 bits over 2^24. The sources of the window are
read back as ``int16 / 32767``, scaled, summed into the mix, and
centre-cropped to the output as targets. The loss is the mean over sources
of the mean squared error; Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected) updates every parameter.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from benchmark.reference import shapes, waveunet
from benchmark.reference.sources import source_names

M64 = (1 << 64) - 1


def mix64(x):
    """splitmix64's finaliser on a Python int or a uint64 array."""
    if isinstance(x, int):
        x = (x + 0x9E3779B97F4A7C15) & M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
        return x ^ (x >> 31)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def draws(key: int, step: int, rows: int, lanes: int) -> np.ndarray:
    """[rows, lanes] uint64 draws of 62 bits."""
    h = mix64((step + mix64(key & M64)) & M64)
    with np.errstate(over="ignore"):
        lane = np.uint64(h) + np.arange(rows * lanes, dtype=np.uint64)
    return (mix64(lane) >> np.uint64(2)).reshape(rows, lanes)


def quantise(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def batch_at(bank: Sequence[torch.Tensor], arch: Mapping, key: int,
             step: int, batch: int, in_len: int, out_len: int):
    """(batch dict, [(song, start)] of each row) of step ``step``; ``bank``
    is one int16 [sources, length, C] tensor a song."""
    names = source_names(arch)
    S = len(names)
    d = draws(key, step, batch, 2 + S)
    rows, where = [], []
    for b in range(batch):
        song = int(d[b, 0] % np.uint64(len(bank)))
        valid = max(bank[song].shape[1] - in_len, 1)
        start = int(d[b, 1] % np.uint64(valid))
        rows.append(bank[song][:, start:start + in_len])
        where.append((song, start))
    dev = bank[0].device
    wins = torch.stack(rows).to(torch.float32) / torch.full(
        (), 32767.0, device=dev)  # [B, S, in_len, C]
    u = torch.as_tensor((d[:, 2:] >> np.uint64(38)).astype(np.float32),
                        device=dev) * (1.0 / (1 << 24))
    wins = wins * (u * (1.0 - 0.7) + 0.7).view(batch, S, 1, 1)
    pad = (in_len - out_len) // 2
    out = {n: wins[:, i, pad:pad + out_len] for i, n in enumerate(names)}
    out["mix"] = wins.sum(dim=1)
    return out, where


def loss_of(params, arch, batch_) -> torch.Tensor:
    names = source_names(arch)
    est = waveunet.forward(params, arch, batch_["mix"], training=True,
                           precision=arch["_precision"])
    return sum(torch.mean(torch.square(batch_[n] - est[n]))
               for n in names) / len(names)


def run_steps(params0: Mapping, arch: Mapping, bank: List[torch.Tensor],
              key: int, n_steps: int, batch: int, lr: float,
              precision: str = "fp32") -> Dict:
    """``n_steps`` Adam steps from ``params0`` (left untouched). Returns
    the losses, the first step's gradients, the parameters after the
    steps, and each step's (song, start) rows."""
    in_len, out_len = shapes.get_padding(arch, arch["num_frames"])
    a = dict(arch, _precision=precision)
    params = {k: {n: t.detach().clone().requires_grad_(True)
                  for n, t in v.items()} for k, v in params0.items()}
    leaves = [(k, n) for k, v in params.items() for n in v]
    mu = {kn: torch.zeros_like(params[kn[0]][kn[1]]) for kn in leaves}
    nu = {kn: torch.zeros_like(params[kn[0]][kn[1]]) for kn in leaves}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grads1, rows = [], None, []
    for t in range(1, n_steps + 1):
        batch_, where = batch_at(bank, arch, key, t - 1, batch, in_len,
                                 out_len)
        rows.append(where)
        with waveunet.tf32(precision == "tf32"):
            loss = loss_of(params, a, batch_)
            g = torch.autograd.grad(loss, [params[k][n] for k, n in leaves])
        losses.append(float(loss.detach()))
        if grads1 is None:
            grads1 = {kn: gi.detach().clone() for kn, gi in zip(leaves, g)}
        tt = torch.tensor(float(t), device=loss.device)
        bc1, bc2 = 1.0 - b1 ** tt, 1.0 - b2 ** tt
        with torch.no_grad():
            for kn, gi in zip(leaves, g):
                mu[kn] = (1.0 - b1) * gi + b1 * mu[kn]
                nu[kn] = (1.0 - b2) * (gi * gi) + b2 * nu[kn]
                p = params[kn[0]][kn[1]]
                p.copy_(p + (mu[kn] / bc1) / (torch.sqrt(nu[kn] / bc2)
                                              + eps) * (-lr))
    return {"losses": losses, "grads1": grads1,
            "params": {kn: params[kn[0]][kn[1]].detach() for kn in leaves},
            "rows": rows}
