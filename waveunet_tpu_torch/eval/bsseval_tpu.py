"""Device-batched BSS-Eval v4 in fp32: Gram solves with iterative refinement.

The port's counterpart of ``waveunet_tpu/eval/bsseval_tpu.py``, in
PyTorch. The host scorer (``eval/bsseval.py``) factorises one [S*C*L]^2 fp64
Gram per 1-second window on one CPU core; this one moves the arithmetic onto
the card, batched over windows (``window_batch``) and over sources:

  * every window's reference and estimate FFTs, its lag-gathered
    block-Toeplitz Gram, the ridged Cholesky factorisations and the solves
    run as batched ``torch.fft`` and ``torch.linalg`` calls (the JAX package
    computes this outside any Pallas kernel too, so library calls are the
    port here);
  * fp32 Cholesky + ``refine_iters`` rounds of residual refinement
    (A += solve(D - G @ A)) against the unridged Gram recover near-fp64
    solutions; the products run in true fp32 (``tf32_scope(False)``: a TF32
    product in the refinement would put its own error back);
  * a relative ridge (1e-5 of the mean diagonal) keeps the near-singular
    Grams of real music factorisable; silent blocks have zero columns, so
    the coefficients the ridge gives them multiply zero signal;
  * every least-squares right-hand side is a residual signal (the projector
    identities e_spat = P_j(e - s), e_interf = P_all(e - P_j e),
    e_artif = r_j - P_all r_j), so each projection's fp32 error is relative
    to an already small residual, and the metric energies come from
    time-domain projection signals, as on the host.

The two-ridge gate: every metric is computed at relative ridges 1e-5 and
1e-4, and a window whose metrics move by ``hybrid_tol`` dB or more between
the two (or turn non-finite on one side only) is recomputed on the host in
fp64. A failed factorisation NaNs that window's factor, as JAX's Cholesky
does, so the same windows reach the gate: ``torch.linalg.cholesky`` would
raise and stop the host instead.

Accuracy against the host fp64 scorer, as in the JAX package
(``tests/test_torch_eval.py`` holds both to the host on the same inputs):
SDR is solve-free; ISR, SIR and SAR agree to 0.01 dB on well-conditioned
windows. On ill-conditioned real-music windows the JAX package measured
0.1-3 dB of fp32 error in SIR and SAR that no fp32-computable gate flags
(that module's docstring); publication-grade numbers come from the host
scorer or from ``eval/bsseval_tpu64.py``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.device import (DeviceLike, refuse_multi_gpu,
                                       resolve_device)
from waveunet_tpu_torch.eval.bsseval import (FILTER_LEN, _nfft_for,
                                             bss_eval_window)
from waveunet_tpu_torch.ops.conv import tf32_scope

NAMES = ("SDR", "ISR", "SIR", "SAR")
RIDGES = (1e-5, 1e-4)  # the metrics' ridge, and the gate's second one


@functools.lru_cache(maxsize=8)
def _lag_index(L: int, nfft: int, device: torch.device) -> torch.Tensor:
    a = torch.arange(L, device=device)
    return (a[None, :] - a[:, None]) % nfft  # [a, b] -> b - a


def _factor(M: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of M + ridge * I; NaN where it fails."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    f, info = torch.linalg.cholesky_ex(M + ridge[..., None, None] * eye)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(f, float("nan")), f)


def _window_kernel(refs: torch.Tensor, ests: torch.Tensor, L: int,
                   nfft: int, refine_iters: int, with_gate: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metrics of a batch of windows. refs, ests: [B, S, n, C] float32.
    Returns ([B, 4, S] metrics, [B] gate): the gate is the largest |dB
    difference| over sources and metrics between ridges 1e-5 and 1e-4
    (zeros with ``with_gate=False``, which skips the second ridge)."""
    B, S, n, C = refs.shape
    KC, CL = S * C, C * L
    N = KC * L
    n_out = n + L - 1
    refs_flat = refs.permute(0, 1, 3, 2).reshape(B, KC, n)

    RF = torch.fft.rfft(refs_flat, nfft, dim=-1)                  # [B, KC, F]
    # r[i, j, tau] = sum_t refs_j[t] refs_i[t + tau]
    r = torch.fft.irfft(RF[:, :, None, :] * RF[:, None, :, :].conj(),
                        nfft, dim=-1)                             # [B,KC,KC,nfft]
    # G[(i, a), (j, b)] = sum_t refs_i[t - a] refs_j[t - b] = r_ij[b - a]
    G = r[..., _lag_index(L, nfft, refs.device)]                  # [B,i,j,a,b]
    G = G.permute(0, 1, 3, 2, 4).reshape(B, N, N)
    G4 = G.view(B, S, CL, S, CL)
    Gj = torch.stack([G4[:, j, :, j, :] for j in range(S)], 1)    # [B,S,CL,CL]
    mean_diag = G.diagonal(dim1=-2, dim2=-1).mean(-1)             # [B]
    RFs = RF.view(B, S, C, -1)                                    # source j's
    RFall = RF[:, None]                                           # [B,1,KC,F]

    ref_energy = (refs ** 2).sum((2, 3))                          # [B, S]
    s_pad = torch.zeros((B, S, C, n_out), dtype=refs.dtype,
                        device=refs.device)
    e_pad = torch.zeros_like(s_pad)
    s_pad[..., :n] = refs.transpose(2, 3)
    e_pad[..., :n] = ests.transpose(2, 3)
    r_s = e_pad - s_pad                                           # e - s

    def cross(RF_sub, x):
        """M^T x: the correlation of x [..., C, m] with every L-shifted
        reference of RF_sub [..., k, F]. Returns [..., k*L, C]."""
        XF = torch.fft.rfft(x, nfft, dim=-1)                      # [..., C, F]
        d = torch.fft.irfft(XF[..., None, :, :]
                            * RF_sub[..., :, None, :].conj(),
                            nfft, dim=-1)[..., :L]                # [..., k,C,L]
        return d.transpose(-1, -2).reshape(*d.shape[:-3], -1, C)

    def project(RF_sub, coeffs):
        """The projection signal: per-reference L-tap filters, summed.
        RF_sub [..., k, F], coeffs [..., k*L, C] -> [..., C, n_out]."""
        k = RF_sub.shape[-2]
        h = coeffs.reshape(*coeffs.shape[:-2], k, L, C).transpose(-1, -2)
        HF = torch.fft.rfft(h, nfft, dim=-1)                      # [..., k,C,F]
        seg = torch.fft.irfft(HF * RF_sub[..., :, None, :], nfft, dim=-1)
        return seg.sum(-3)[..., :n_out]

    def refined(cho, M, rhs):
        A = torch.cholesky_solve(rhs, cho)
        for _ in range(refine_iters):
            A = A + torch.cholesky_solve(rhs - M @ A, cho)
        return A

    def db(num, den):
        # den == 0 -> +inf, num == 0 -> -inf, 0/0 -> nan: the host's `_db`
        return 10.0 * torch.log10(num / den)

    nan = torch.tensor(float("nan"), dtype=refs.dtype, device=refs.device)
    silent_est = (e_pad ** 2).sum((2, 3)) == 0.0                  # [B, S]
    valid = ref_energy > 0

    def metrics_at(ridge_scale):
        ridge = ridge_scale * mean_diag + 1e-30                   # [B]
        cho = _factor(G, ridge)                                   # [B, N, N]
        choj = _factor(Gj, ridge[:, None])                        # [B,S,CL,CL]
        # e_spat = P_j(e - s)
        e_spat = project(RFs, refined(choj, Gj, cross(RFs, r_s)))
        # e_interf = P_all(e - P_j(e)),   e - P_j(e) = r_s - e_spat;
        # every source's right-hand side shares the one all-sources system
        r_j = r_s - e_spat
        rhs = cross(RFall, r_j).permute(0, 2, 1, 3).reshape(B, N, S * C)
        A2 = refined(cho, G, rhs).reshape(B, N, S, C).permute(0, 2, 1, 3)
        e_interf = project(RFall, A2)                             # [B,S,C,n]
        e_artif = r_j - e_interf

        def energy(x):
            return (x ** 2).sum((2, 3))                           # [B, S]

        sdr = db(ref_energy, energy(r_s))
        isr = db(ref_energy, energy(e_spat))
        # An exactly silent estimate gives the host exact zeros (its
        # right-hand side is the raw estimate): SIR = SAR = 0/0 = nan. The
        # residual formulation leaves fp32 residue there instead.
        sir = torch.where(silent_est, nan,
                          db(energy(s_pad + e_spat), energy(e_interf)))
        sar = torch.where(silent_est, nan,
                          db(energy(s_pad + e_spat + e_interf),
                             energy(e_artif)))
        m = torch.stack([sdr, isr, sir, sar], -1)                 # [B, S, 4]
        return torch.where(valid[..., None], m, nan)

    m_lo = metrics_at(RIDGES[0])
    if not with_gate:
        return m_lo.transpose(1, 2), torch.zeros(B, device=refs.device)
    m_hi = metrics_at(RIDGES[1])
    # equal non-finites (both nan, both the same inf) are stable; any
    # finite/non-finite mismatch flags the window
    stable = (m_lo == m_hi) | (m_lo.isnan() & m_hi.isnan())
    d = torch.where(stable, torch.zeros_like(m_lo), (m_lo - m_hi).abs())
    d = torch.where(d.isnan(), torch.full_like(d, float("inf")), d)
    return m_lo.transpose(1, 2), d.amax((1, 2))


def window_starts(n: int, win: int, hop: int) -> np.ndarray:
    """The framewise scorers' window starts over a track of n samples."""
    return np.arange(0, max(n - win + 1, 1), hop)


def device_windows(track: torch.Tensor, starts: np.ndarray, win: int
                   ) -> torch.Tensor:
    """Windows of a device track [S, n, C] at ``starts`` as [B, S, win, C];
    a window past the end is zero-padded (exact: correlations and energies
    of the padded window are the sliced window's)."""
    S, n, C = track.shape
    short = int(starts[-1]) + win - n
    if short > 0:
        track = torch.cat([track, track.new_zeros((S, short, C))], 1)
    idx = (torch.as_tensor(starts, device=track.device)[:, None]
           + torch.arange(win, device=track.device))              # [B, win]
    return track[:, idx].permute(1, 0, 2, 3)


def device_window_metrics(references: np.ndarray, estimates: np.ndarray,
                          rate: int, win_s: float = 1.0, hop_s: float = 1.0,
                          filter_len: int = FILTER_LEN, refine_iters: int = 2,
                          window_batch: int = 8, with_gate: bool = True,
                          device: DeviceLike = None
                          ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Every window's fp32 metrics and gate, before any host fallback:
    ({metric: [S, n_frames]}, [n_frames] gates)."""
    dev = resolve_device(device)
    S, n, C = references.shape
    win = int(win_s * rate)
    hop = int(hop_s * rate)
    starts = window_starts(n, win, hop)
    nfft = _nfft_for(win)
    out = np.full((4, S, len(starts)), np.nan)
    gates = np.zeros(len(starts))
    with torch.no_grad(), tf32_scope(False):
        refs = torch.from_numpy(np.asarray(references, np.float32)).to(dev)
        ests = torch.from_numpy(np.asarray(estimates, np.float32)).to(dev)
        for b0 in range(0, len(starts), window_batch):
            chunk = starts[b0:b0 + window_batch]
            res, gate = _window_kernel(device_windows(refs, chunk, win),
                                       device_windows(ests, chunk, win),
                                       filter_len, nfft, refine_iters,
                                       with_gate)                 # [B, 4, S]
            out[:, :, b0:b0 + len(chunk)] = res.permute(1, 2, 0).cpu().numpy()
            gates[b0:b0 + len(chunk)] = gate.cpu().numpy()
    return dict(zip(NAMES, out)), gates


def bss_eval_framewise_tpu(references: np.ndarray, estimates: np.ndarray,
                           rate: int, win_s: float = 1.0, hop_s: float = 1.0,
                           filter_len: int = FILTER_LEN,
                           refine_iters: int = 2,
                           window_batch: int = 8,
                           mesh=None,
                           hybrid_tol: Optional[float] = 0.1,
                           host_pool=None,
                           device: DeviceLike = None
                           ) -> Dict[str, np.ndarray]:
    """Device-batched framewise metrics; the contract of
    ``bsseval.bss_eval_framewise``. references/estimates: [S, n, C].

    Windows whose two-ridge gate reads ``hybrid_tol`` dB or more (or NaN)
    are recomputed on the host in fp64 (``bsseval.bss_eval_window``), fanned
    out over ``host_pool`` (an executor) when given. ``hybrid_tol=None``
    scores every window on the device at one ridge. Runs on the card unless
    ``device="cpu"``; ``mesh`` (several cards) is not ported."""
    refuse_multi_gpu(mesh)
    out, gates = device_window_metrics(
        references, estimates, rate, win_s, hop_s, filter_len, refine_iters,
        window_batch, with_gate=hybrid_tol is not None, device=device)
    if hybrid_tol is None:
        return out
    S, n, C = references.shape
    win = int(win_s * rate)
    starts = window_starts(n, win, int(hop_s * rate))
    flagged = np.nonzero(~(gates < hybrid_tol))[0]  # NaN gates flag too

    def args(fi):  # host convention: slice, no pad
        sl = slice(starts[fi], min(starts[fi] + win, n))
        return references[:, sl], estimates[:, sl], filter_len

    if host_pool is not None:
        futs = [(fi, host_pool.submit(bss_eval_window, *args(fi)))
                for fi in flagged]
        results = [(fi, f.result()) for fi, f in futs]
    else:
        results = [(fi, bss_eval_window(*args(fi))) for fi in flagged]
    for fi, res in results:
        for k in NAMES:
            out[k][:, fi] = res[k]
    if len(flagged):
        print(f"  [tpu_bss] {len(flagged)}/{len(starts)} "
              f"regularization-sensitive windows recomputed on host fp64")
    return out
