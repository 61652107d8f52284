"""Full-precision (fp64) device BSS-Eval: FFT-free, matmul and solves only.

The port's counterpart of ``waveunet_tpu/eval/bsseval_tpu64.py``, in
PyTorch fp64 on the card, batched over windows. It runs the host fp64
algorithm (``eval/bsseval.bss_eval_window``: raw-estimate right-hand sides,
an unridged Gram, Cholesky and else LU) with the host's "exact" assembly:

  * the Gram and the cross-correlations are TILED SHIFTED MATMULS
    (``_corr``): c[p, q, lag] = sum_u x_p[u] y_q[u + lag], one [P, n] x
    [Q, n, 128] product per tile of 128 lags, so no [n, L] matrix of shifted
    copies is ever formed;
  * no time-domain projections: every BSS energy is a QUADRATIC FORM in the
    Gram. With M the shifted-reference matrix and A the solved coefficients:
        ||M A||^2        = tr(A^T G A)
        <x, M A>         = tr((M^T x)^T A)
    and M^T s for a reference s is a Gram correlation, free.

The H100 has native fp64 FFTs, but an FFT assembly would compute another
metric: on near-singular real-music windows (cond(G) ~ 1e15) the host's own
FFT-against-exact choice moves SIR and SAR by up to 27 dB
(``tests/test_bsseval_tpu64.py``), and this scorer is held to the exact
assembly within 1e-3 dB. SDR is solve-free and equal under every scheme.

A silent reference channel makes the Gram exactly singular: the host then
falls through LU to a minimum-norm lstsq, whose coefficients are zero on
that channel. Patching only the zero diagonal entries reproduces that (their
right-hand side is zero, so the solve returns zeros there) and leaves every
other window's Gram as it was.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from waveunet_tpu_torch.device import (DeviceLike, refuse_multi_gpu,
                                       resolve_device)
from waveunet_tpu_torch.eval.bsseval import FILTER_LEN
from waveunet_tpu_torch.eval.bsseval_tpu import (NAMES, device_windows,
                                                 window_starts)

_LAG_TILE = 128


def _corr(x: torch.Tensor, y: torch.Tensor, L: int) -> torch.Tensor:
    """c[..., p, q, lag] = sum_u x[..., p, u] y[..., q, u + lag], lag < L.

    x: [..., P, n]; y: [..., Q, m], zero past m. Tiled over the lag axis, so
    the largest temporary is [..., Q, n, 128]."""
    n, m = x.shape[-1], y.shape[-1]
    ntile = -(-L // _LAG_TILE)
    yp = F.pad(y, (0, max(0, n + ntile * _LAG_TILE - m)))
    tiles = []
    for t0 in range(0, ntile * _LAG_TILE, _LAG_TILE):
        sh = yp[..., t0:t0 + n + _LAG_TILE - 1].unfold(-1, _LAG_TILE, 1)
        tiles.append(torch.einsum("...pn,...qnt->...pqt", x, sh))
    return torch.cat(tiles, -1)[..., :L]


def _build_gram(rpos: torch.Tensor, L: int) -> torch.Tensor:
    """The block-Toeplitz Gram from positive-lag correlations.

    rpos: [..., K, K, L], rpos[i, j, lag] = sum_u refs_i[u] refs_j[u + lag].
    G[(i, a), (j, b)] = sum_t refs_i[t - a] refs_j[t - b]
                      = rpos[j, i, b - a] if b >= a else rpos[i, j, a - b]
    (``bsseval._gram``'s layout)."""
    K = rpos.shape[-2]
    a = torch.arange(L, device=rpos.device)
    lag = a[None, :] - a[:, None]                         # [a, b] = b - a
    pos = rpos[..., lag.clamp(min=0)]                     # [..., i, j, a, b]
    neg = rpos[..., (-lag).clamp(min=0)]
    G4 = torch.where(lag >= 0, pos.transpose(-3, -4), neg)
    return G4.transpose(-3, -2).reshape(*rpos.shape[:-3], K * L, K * L)


def _host_style_solve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The host ``_GramSolver``'s choice per batch element: Cholesky where
    it succeeds (``cholesky_ex``'s info is 0 exactly where scipy's
    ``cho_factor`` does not raise; a failed factor is partial, not NaN),
    else pivoted LU. The host's last resort, lstsq on an exactly singular
    LU, is reached only by silent sources, whose rows the silent-reference
    rule and the zero-diagonal patch take care of."""
    cho, info = torch.linalg.cholesky_ex(G)
    return torch.where((info == 0)[..., None, None],
                       torch.cholesky_solve(rhs, cho), _lu_solve(G, rhs))


def _lu_solve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """G^-1 rhs by pivoted LU, for G [..., N, N] and rhs [..., N, k] of the
    same batch shape. On the CPU one matrix at a time: PyTorch's batched
    CPU LU fails inside MKL (a DLASWP parameter error, then a hang) when it
    runs on a few intra-op threads."""
    if G.device.type == "cpu":
        out = [torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(g)[:2], r)
               for g, r in zip(G.reshape(-1, *G.shape[-2:]),
                               rhs.reshape(-1, *rhs.shape[-2:]))]
        return torch.stack(out).reshape(rhs.shape)
    lu, piv, _ = torch.linalg.lu_factor_ex(G)
    return torch.linalg.lu_solve(lu, piv, rhs)


def _window_kernel_f64(refs: torch.Tensor, ests: torch.Tensor, L: int
                       ) -> torch.Tensor:
    """Metrics of a batch of windows in fp64. refs, ests: [B, S, n, C]
    float64. Returns [B, 4, S].

        ||s + e_spat||^2 = A_j^T G_j A_j
        ||e_spat||^2     = A_j^T G_j A_j - 2 A_j.q_j + ||s||^2
        ||e_interf||^2   = B^T G B,  B = A_all - embed(A_j)
        ||proj_all||^2   = A_all^T G A_all
        ||e_artif||^2    = ||e||^2 - 2 A_all.D_j + A_all^T G A_all
    (q_j = M_j^T s, from the Gram correlations.)"""
    B, S, n, C = refs.shape
    KC, CL = S * C, C * L
    N = KC * L
    refs_flat = refs.permute(0, 1, 3, 2).reshape(B, KC, n)
    ests_flat = ests.permute(0, 1, 3, 2).reshape(B, KC, n)

    rpos = _corr(refs_flat, refs_flat, L)                 # [B, KC, KC, L]
    G = _build_gram(rpos, L)                              # [B, N, N]
    # D[(i, a), q] = sum_t est_q[t] refs_i[t - a]  (host `_cross` layout)
    D = _corr(refs_flat, ests_flat, L).transpose(-1, -2).reshape(B, N, KC)
    # M^T s for source j's own references: Qs[(i, a), (j, c)]
    Qs = rpos.transpose(-1, -2).reshape(B, N, KC)

    diag = G.diagonal(dim1=-2, dim2=-1)
    md = diag.mean(-1, keepdim=True)
    G = G + torch.diag_embed(torch.where(diag == 0.0, md,
                                         torch.zeros_like(diag)))
    G4 = G.view(B, S, CL, S, CL)

    ref_energy = (refs ** 2).sum((2, 3))                  # [B, S]
    res_energy = ((ests - refs) ** 2).sum((2, 3))
    est_energy = (ests ** 2).sum((2, 3))

    def block(X, j):  # source j's rows and columns of an [B, N, KC] matrix
        return X[:, j * CL:(j + 1) * CL, j * C:(j + 1) * C]

    def per_source(X):  # [B, N, S*C] -> [B, S, N, C]
        return X.reshape(B, N, S, C).permute(0, 2, 1, 3)

    # one factorisation of the shared all-sources Gram for every source
    A_all = per_source(_host_style_solve(G, D))           # [B, S, N, C]
    D_j = per_source(D)
    Gj = torch.stack([G4[:, j, :, j, :] for j in range(S)], 1)
    A_j = _host_style_solve(Gj, torch.stack([block(D, j) for j in range(S)],
                                            1))           # [B, S, CL, C]
    q_j = torch.stack([block(Qs, j) for j in range(S)], 1)

    def quad(X, Y):  # sum(X * Y) per window and source
        return (X * Y).sum((-2, -1))

    def gram_times(X):  # G @ X for X [B, S, N, C]
        cols = X.permute(0, 2, 1, 3).reshape(B, N, S * C)
        return per_source(G @ cols)

    pj2 = quad(A_j, Gj @ A_j)                             # ||s + e_spat||^2
    e_spa2 = pj2 - 2 * quad(A_j, q_j) + ref_energy        # ||e_spat||^2
    Bm = A_all.clone()
    for j in range(S):
        Bm[:, j, j * CL:(j + 1) * CL] -= A_j[:, j]
    e_int2 = quad(Bm, gram_times(Bm))                     # ||e_interf||^2
    pa2 = quad(A_all, gram_times(A_all))                  # ||proj_all||^2
    e_art2 = est_energy - 2 * quad(A_all, D_j) + pa2

    def db(num, den):
        return 10.0 * torch.log10(num / den)

    e_spa2, e_int2, e_art2, pj2, pa2 = (
        x.clamp(min=0.0) for x in (e_spa2, e_int2, e_art2, pj2, pa2))
    m = torch.stack([db(ref_energy, res_energy), db(ref_energy, e_spa2),
                     db(pj2, e_int2), db(pa2, e_art2)], 1)  # [B, 4, S]
    return torch.where((ref_energy > 0)[:, None], m,
                       torch.full_like(m, float("nan")))


def bss_eval_framewise_tpu64(references: np.ndarray, estimates: np.ndarray,
                             rate: int, win_s: float = 1.0,
                             hop_s: float = 1.0,
                             filter_len: int = FILTER_LEN,
                             window_batch: int = 4, mesh=None,
                             device: DeviceLike = None
                             ) -> Dict[str, np.ndarray]:
    """Framewise metrics in device fp64; the contract of
    ``bsseval.bss_eval_framewise``. references/estimates: [S, n, C]. Runs
    on the card unless ``device="cpu"``; ``mesh`` is not ported."""
    refuse_multi_gpu(mesh)
    dev = resolve_device(device)
    S, n, C = references.shape
    win = int(win_s * rate)
    starts = window_starts(n, win, int(hop_s * rate))
    out = np.full((4, S, len(starts)), np.nan)
    with torch.no_grad():
        refs = torch.from_numpy(np.asarray(references, np.float64)).to(dev)
        ests = torch.from_numpy(np.asarray(estimates, np.float64)).to(dev)
        for b0 in range(0, len(starts), window_batch):
            chunk = starts[b0:b0 + window_batch]
            res = _window_kernel_f64(device_windows(refs, chunk, win),
                                     device_windows(ests, chunk, win),
                                     filter_len)          # [B, 4, S]
            out[:, :, b0:b0 + len(chunk)] = res.permute(1, 2, 0).cpu().numpy()
    return dict(zip(NAMES, out))
