"""BSS-Eval v4 (images, framewise) on the host in fp64: SDR / ISR / SIR / SAR.

The port's copy of ``waveunet_tpu/eval/bsseval.py`` (numpy and scipy only;
the port imports nothing of the JAX package), bit for bit the same
arithmetic. It implements the museval v4 metrics the reference uses for its
headline numbers (the reference's ``Evaluate.py:71``) from the published
BSS Eval definitions (Vincent et al.; sigsep museval v4 conventions):

  For each 1-second window, each estimated source image ŝ_j is decomposed via
  least-squares projections onto spaces of L=512-tap filtered reference images:

    P_j   = proj onto {shifted s_j}            (target + spatial space)
    P_all = proj onto {shifted s_1..s_K}       (all-sources space)
    e_spat   = P_j(ŝ_j)  - s_j
    e_interf = P_all(ŝ_j) - P_j(ŝ_j)
    e_artif  = ŝ_j - P_all(ŝ_j)

    SDR = 10 log10 ||s_j||² / ||e_spat + e_interf + e_artif||²
    ISR = 10 log10 ||s_j||² / ||e_spat||²
    SIR = 10 log10 ||s_j + e_spat||² / ||e_interf||²
    SAR = 10 log10 ||s_j + e_spat + e_interf||² / ||e_artif||²

  Signals are zero-padded to n + L - 1 for the filtered projections; windows
  whose reference is silent yield NaN (museval behavior), which the aggregation
  (`aggregate.py`) treats NaN-aware exactly like the reference.

The Gram/Toeplitz systems are assembled from FFT cross-correlations; one Gram
factorisation per window is shared across all estimated sources.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.fft import irfft, rfft

FILTER_LEN = 512


def _nfft_for(n: int) -> int:
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    return nfft


def _gram(RF: np.ndarray, nfft: int, L: int) -> np.ndarray:
    """Block-Toeplitz Gram matrix of L-shifted references from their rffts."""
    from scipy.linalg import toeplitz

    K = RF.shape[0]
    G = np.zeros((K * L, K * L))
    lags = np.arange(L)
    for i in range(K):
        for j in range(i, K):
            # blk[a, b] = sum_t refs_i[t - a] refs_j[t - b] = r_ij[b - a],
            # negative lags wrapped at the tail of the ifft buffer.
            r = irfft(RF[i] * np.conj(RF[j]), nfft)
            blk = toeplitz(r[(-lags) % nfft], r[lags])
            G[i * L:(i + 1) * L, j * L:(j + 1) * L] = blk
            if i != j:
                G[j * L:(j + 1) * L, i * L:(i + 1) * L] = blk.T
    return G


def _gram_exact(refs_flat: np.ndarray, L: int) -> np.ndarray:
    """`_gram` with direct per-lag matmul correlations instead of FFTs.

    The FFT assembly's irfft spreads an ABSOLUTE eps*||x||^2-scale rounding
    across every lag, which swamps small true correlations; on near-singular
    real-music Grams (cond 1e14-1e18 measured on the bundled fixtures) that
    assembly noise alone moves SIR/SAR by up to 27 dB at fp64 (see
    tests/test_bsseval_tpu64.py). The direct per-lag sums keep each entry's
    error relative to its own summands — the strictly more accurate
    arithmetic, and the assembly the fp64 device path uses (TPU XLA has no
    f64 FFT). Default stays "fft" for museval-convention compatibility."""
    K, n = refs_flat.shape
    x = refs_flat.astype(np.float64)
    rpos = np.zeros((K, K, L))
    rpos[:, :, 0] = x @ x.T
    for lag in range(1, L):
        rpos[:, :, lag] = x[:, :n - lag] @ x[:, lag:].T
    a = np.arange(L)
    lagm = a[None, :] - a[:, None]                        # [a, b] = b - a
    pos = rpos[:, :, np.maximum(lagm, 0)]
    neg = rpos[:, :, np.maximum(-lagm, 0)]
    # blk_ij[a, b] = sum_t refs_i[t-a] refs_j[t-b] = rpos[j, i, b-a] (b >= a)
    G4 = np.where(lagm[None, None] >= 0, pos.transpose(1, 0, 2, 3), neg)
    return G4.transpose(0, 2, 1, 3).reshape(K * L, K * L)


def _cross_exact(refs_flat: np.ndarray, est: np.ndarray, L: int) -> np.ndarray:
    """`_cross` with direct per-lag matmul correlations (see `_gram_exact`)."""
    K, n = refs_flat.shape
    x = refs_flat.astype(np.float64)
    e = est.astype(np.float64)
    C = est.shape[0]
    D = np.zeros((K * L, C))
    D[0::L, :] = x @ e[:, :n].T
    for lag in range(1, L):
        m = min(n, e.shape[1] - lag)
        D[lag::L, :] = x[:, :m] @ e[:, lag:lag + m].T
    return D


def _cross(RF: np.ndarray, est: np.ndarray, nfft: int, L: int) -> np.ndarray:
    """D[(i, lag), c] = sum_t est_c[t] refs_i[t - lag]."""
    K = RF.shape[0]
    C = est.shape[0]
    EF = rfft(est, nfft, axis=1)
    D = np.zeros((K * L, C))
    lags = np.arange(L)
    for i in range(K):
        for c in range(C):
            d = irfft(EF[c] * np.conj(RF[i]), nfft)
            D[i * L:(i + 1) * L, c] = d[lags]
    return D


def _project(RF: np.ndarray, coeffs: np.ndarray, nfft: int, n_out: int
             ) -> np.ndarray:
    """Apply per-reference L-tap filters and sum: returns [C, n_out]."""
    K = RF.shape[0]
    L = coeffs.shape[0] // K
    C = coeffs.shape[1]
    out = np.zeros((C, n_out))
    for i in range(K):
        HF = rfft(coeffs[i * L:(i + 1) * L, :].T, nfft, axis=1)  # [C, nfft]
        seg = irfft(HF * RF[i][None, :], nfft, axis=1)[:, :n_out]
        out += seg
    return out


class _GramSolver:
    """Factorise the all-sources Gram once per window; every estimated source
    reuses the factorisation (the Gram is estimate-independent). The Gram is
    symmetric PSD, so Cholesky is used first (2x faster than LU and stable for
    SPD), falling back to LU and finally to a minimum-norm lstsq for singular
    Grams (silent sources)."""

    def __init__(self, G: np.ndarray):
        from scipy.linalg import cho_factor, lu_factor
        self._G = G
        self._cho = None
        self._lu = None
        try:
            self._cho = cho_factor(G, check_finite=False)
        except Exception:
            try:
                self._lu = lu_factor(G, check_finite=False)
            except Exception:
                pass

    def solve(self, D: np.ndarray) -> np.ndarray:
        if self._cho is not None:
            from scipy.linalg import cho_solve
            out = cho_solve(self._cho, D, check_finite=False)
            if np.all(np.isfinite(out)):
                return out
        if self._lu is not None:
            from scipy.linalg import lu_solve
            out = lu_solve(self._lu, D, check_finite=False)
            if np.all(np.isfinite(out)):
                return out
        # singular Gram (e.g. silent sources): minimum-norm solution
        return np.linalg.lstsq(self._G, D, rcond=None)[0]


def _db(num: float, den: float) -> float:
    if den <= 0:
        return np.inf if num > 0 else np.nan
    if num <= 0:
        return -np.inf
    return 10.0 * np.log10(num / den)


def bss_eval_window(references: np.ndarray, estimates: np.ndarray,
                    filter_len: int = FILTER_LEN,
                    assembly: str = "fft") -> Dict[str, np.ndarray]:
    """Metrics for one window.

    references/estimates: [n_src, n_samples, n_chan].
    Returns dict of arrays [n_src] for SDR/ISR/SIR/SAR (NaN for silent refs).
    ``assembly``: how Gram/cross correlations are computed — "fft" (museval
    convention) or "exact" (direct per-lag sums; see `_gram_exact` for when
    the two differ and why exact is the more accurate arithmetic).
    """
    assert assembly in ("fft", "exact")
    S, n, C = references.shape
    L = filter_len
    refs_flat = references.transpose(0, 2, 1).reshape(S * C, n)
    n_out = n + L - 1

    sdr = np.full(S, np.nan)
    isr = np.full(S, np.nan)
    sir = np.full(S, np.nan)
    sar = np.full(S, np.nan)

    ref_energy = (references ** 2).sum(axis=(1, 2))
    if not np.any(ref_energy > 0):
        return {"SDR": sdr, "ISR": isr, "SIR": sir, "SAR": sar}

    # Reference rffts computed once per window and shared by the Gram, every
    # cross-correlation, and every projection.
    nfft = _nfft_for(n)
    RF = rfft(refs_flat, nfft, axis=1)
    G_all = (_gram_exact(refs_flat, L) if assembly == "exact"
             else _gram(RF, nfft, L))  # one Gram per window, all sources
    solver = _GramSolver(G_all)
    for j in range(S):
        if ref_energy[j] == 0:
            continue
        est = estimates[j].T  # [C, n]
        D_all = (_cross_exact(refs_flat, est, L) if assembly == "exact"
                 else _cross(RF, est, nfft, L))
        A_all = solver.solve(D_all)
        proj_all = _project(RF, A_all, nfft, n_out)

        # Sub-system for the single-source (spatial) projection.
        rows = np.concatenate([
            np.arange((j * C + c) * L, (j * C + c + 1) * L) for c in range(C)])
        A_j = _GramSolver(G_all[np.ix_(rows, rows)]).solve(D_all[rows])
        proj_j = _project(RF[j * C:(j + 1) * C], A_j, nfft, n_out)

        s_pad = np.zeros((C, n_out))
        s_pad[:, :n] = references[j].T
        e_pad = np.zeros((C, n_out))
        e_pad[:, :n] = est

        e_spat = proj_j - s_pad
        e_interf = proj_all - proj_j
        e_artif = e_pad - proj_all

        s2 = float((s_pad ** 2).sum())
        sdr[j] = _db(s2, float(((e_pad - s_pad) ** 2).sum()))
        isr[j] = _db(s2, float((e_spat ** 2).sum()))
        sir[j] = _db(float(((s_pad + e_spat) ** 2).sum()),
                     float((e_interf ** 2).sum()))
        sar[j] = _db(float(((s_pad + e_spat + e_interf) ** 2).sum()),
                     float((e_artif ** 2).sum()))
    return {"SDR": sdr, "ISR": isr, "SIR": sir, "SAR": sar}


def bss_eval_framewise(references: np.ndarray, estimates: np.ndarray,
                       rate: int, win_s: float = 1.0, hop_s: float = 1.0,
                       filter_len: int = FILTER_LEN, assembly: str = "fft"
                       ) -> Dict[str, np.ndarray]:
    """Framewise metrics over a full track (museval v4 default framing:
    1 s windows, 1 s hop). Returns dict of [n_src, n_frames] arrays."""
    S, n, C = references.shape
    win = int(win_s * rate)
    hop = int(hop_s * rate)
    starts = list(range(0, max(n - win + 1, 1), hop))
    out = {k: np.full((S, len(starts)), np.nan)
           for k in ("SDR", "ISR", "SIR", "SAR")}
    for fi, st in enumerate(starts):
        sl = slice(st, min(st + win, n))
        res = bss_eval_window(references[:, sl], estimates[:, sl], filter_len,
                              assembly=assembly)
        for k in out:
            out[k][:, fi] = res[k]
    return out
