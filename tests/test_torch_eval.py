"""The port's scorers and aggregation against the JAX package's, on the CPU.

Same numpy inputs from a seed through both packages:
  * the host fp64 scorer (``eval/bsseval.py``, numpy and scipy): equal bit
    for bit, both assemblies, including the silent-reference lstsq path;
  * the JSON writer and the aggregation: the same bytes, read across;
  * the fp32 device scorer: within 0.01 dB + rtol 1e-4 of the host (the
    JAX package's tolerance, ``tests/test_bsseval_tpu.py``), and the same
    windows flagged by the two-ridge gate as the JAX scorer flags;
  * the fp64 device scorer: its correlation assembly against an explicit
    shift matrix at 1e-10, and its metrics against the host's exact
    assembly (1e-9 dB where the JAX package's own test holds it so, 1e-6 at
    L = 512, and the silent-source cases), and a Gram that Cholesky
    refuses taking the LU path.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.eval import aggregate as jax_aggregate
from waveunet_tpu.eval import bsseval as jax_bsseval
from waveunet_tpu.eval import bsseval_tpu as jax_tpu

from waveunet_tpu_torch.eval import aggregate, bsseval
from waveunet_tpu_torch.eval.bsseval_tpu import (bss_eval_framewise_tpu,
                                                 device_window_metrics)
from waveunet_tpu_torch.eval.bsseval_tpu64 import (_build_gram, _corr,
                                                   _host_style_solve,
                                                   bss_eval_framewise_tpu64)
from torch_cpu import few_threads  # noqa: F401

NAMES = ("SDR", "ISR", "SIR", "SAR")


def _mix_case(rng, S, n, C):
    """tests/test_bsseval_tpu.py's correlated case."""
    refs = rng.standard_normal((S, n, C))
    refs = 0.6 * refs + 0.8 * rng.standard_normal((1, n, C))
    ests = np.empty_like(refs)
    for j in range(S):
        ests[j] = 0.9 * np.roll(refs[j], (j * 3) % 5, axis=0)
        ests[j] += 0.2 * refs[(j + 1) % S]
        ests[j] += 0.05 * rng.standard_normal((n, C))
    return refs.astype(np.float32), ests.astype(np.float32)


def _leak_case(rng, S, n, C):
    """tests/test_bsseval_tpu64.py's case."""
    refs = rng.standard_normal((S, n, C)) * 0.1
    ests = refs + 0.02 * rng.standard_normal((S, n, C)) \
        + 0.03 * np.roll(refs, 1, axis=0)
    return refs, ests


def _maxdiff(a, b):
    """Largest |a - b|; a NaN on one side only is infinitely far."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    d = np.abs(a - b)
    d[np.isnan(a)] = 0.0
    return float(np.max(d)) if d.size else 0.0


# -- host fp64 scorer -----------------------------------------------------------

@pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")
@pytest.mark.parametrize("assembly", ["fft", "exact"])
@pytest.mark.parametrize("case", ["stereo", "mono3", "silent_ref",
                                  "silent_est"])
def test_host_scorer_bit_for_bit(case, assembly):
    rng = np.random.default_rng(10)
    S, C = (3, 1) if case == "mono3" else (2, 2)
    refs, ests = _mix_case(rng, S, 2 * 600 + 77, C)
    if case == "silent_ref":
        refs[1] = 0.0  # a singular Gram: Cholesky, LU, then lstsq
    if case == "silent_est":
        ests[0] = 0.0
    got = bsseval.bss_eval_framewise(refs, ests, 600, filter_len=24,
                                     assembly=assembly)
    want = jax_bsseval.bss_eval_framewise(refs, ests, 600, filter_len=24,
                                          assembly=assembly)
    for k in NAMES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- aggregation ------------------------------------------------------------------

def _metrics():
    return {"vocals": {"SDR": np.array([3.0, 4.0, np.nan]),
                       "ISR": np.array([10.0, 11.0, np.nan]),
                       "SIR": np.array([8.0, np.inf, np.nan]),
                       "SAR": np.array([7.0, 6.0, np.nan])},
            "accompaniment": {k: np.array([11.0, 12.5, 13.0])
                              for k in NAMES}}


def test_track_json_bytes_and_cross_reads(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    aggregate.write_track_json(str(ours / "song.json"), "song", _metrics())
    jax_aggregate.write_track_json(str(theirs / "song.json"), "song",
                                   _metrics())
    assert (ours / "song.json").read_bytes() == \
        (theirs / "song.json").read_bytes()
    for folder in (ours, theirs):
        got, names = aggregate.compute_mean_metrics(str(folder),
                                                    return_names=True)
        want, jnames = jax_aggregate.compute_mean_metrics(str(folder),
                                                          return_names=True)
        assert names == jnames == ["vocals", "accompaniment"]
        np.testing.assert_array_equal(np.array(got), np.array(want))
    np.testing.assert_allclose(got[0][0], 3.5)


@pytest.mark.parametrize("payload", ["{", "null", '{"targets": ["x"]}'])
def test_aggregate_malformed_json_names_the_file(tmp_path, payload):
    (tmp_path / "bad.json").write_text(payload)
    with pytest.raises(ValueError, match="bad.json"):
        aggregate.compute_mean_metrics(str(tmp_path))


# -- fp32 device scorer -------------------------------------------------------------

def _jax_gates(refs, ests, rate, L):
    """The JAX scorer's two-ridge gate of every window."""
    win = rate
    starts = np.arange(0, max(refs.shape[1] - win + 1, 1), rate)
    kern = jax_tpu._get_kernel(L, jax_bsseval._nfft_for(win), 2, None, True)
    rb = np.stack([refs[:, s:s + win] for s in starts])
    eb = np.stack([ests[:, s:s + win] for s in starts])
    return np.asarray(kern(jnp.asarray(rb), jnp.asarray(eb))[1])


def _assert_close(host, dev):
    for k in NAMES:
        h, d = host[k], dev[k]
        both_nan = np.isnan(h) & np.isnan(d)
        np.testing.assert_allclose(d[~both_nan], h[~both_nan], atol=0.01,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")
@pytest.mark.parametrize("case", ["mono", "stereo", "three_stereo",
                                  "silent_ref", "silent_est"])
def test_fp32_scorer_matches_host_and_flags_as_jax(case):
    rate, L, S, C = 512, 32, 2, 1
    if case == "stereo":
        C = 2
    if case == "three_stereo":
        rate, S, C = 1024, 3, 2
    rng = np.random.default_rng(100 + len(case))
    refs, ests = _mix_case(rng, S, 3 * rate + 64, C)
    if case == "silent_ref":
        refs[1] = 0.0
    if case == "silent_est":
        ests[1] = 0.0
    host = bsseval.bss_eval_framewise(refs, ests, rate, filter_len=L)
    dev = bss_eval_framewise_tpu(refs, ests, rate, filter_len=L,
                                 device="cpu")
    _, gates = device_window_metrics(refs, ests, rate, filter_len=L,
                                     device="cpu")
    jax_flags = ~(_jax_gates(refs, ests, rate, L) < 0.1)
    np.testing.assert_array_equal(~(gates < 0.1), jax_flags)
    for k in NAMES:  # flagged windows are the host's own numbers
        np.testing.assert_array_equal(dev[k][:, jax_flags],
                                      host[k][:, jax_flags], err_msg=k)
    if case == "silent_ref":
        assert np.all(np.isnan(dev["SDR"][1]))
        host, dev = ({k: v[:1] for k, v in m.items()} for m in (host, dev))
    _assert_close(host, dev)


def test_fp32_scorer_production_filter():
    """L = 512 (museval's), 1 s windows at a reduced rate that keeps the
    system overdetermined (win 4096 > S*C*L = 2048)."""
    rate = 4096
    refs, ests = _mix_case(np.random.default_rng(7), 2, 2 * rate + 512, 1)
    host = bsseval.bss_eval_framewise(refs, ests, rate, filter_len=512)
    dev = bss_eval_framewise_tpu(refs, ests, rate, filter_len=512,
                                 device="cpu")
    _assert_close(host, dev)


@pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")
def test_fp32_scorer_single_ridge_and_host_pool():
    """hybrid_tol=None scores every window on the device at one ridge; a
    host pool recomputes the flagged windows to the same numbers."""
    from concurrent.futures import ThreadPoolExecutor

    rate = 512
    refs, ests = _mix_case(np.random.default_rng(3), 2, 2 * rate, 1)
    refs[1] = 0.0
    pure = bss_eval_framewise_tpu(refs, ests, rate, filter_len=32,
                                  hybrid_tol=None, device="cpu")
    lo, _ = device_window_metrics(refs, ests, rate, filter_len=32,
                                  with_gate=False, device="cpu")
    for k in NAMES:
        np.testing.assert_array_equal(pure[k], lo[k])
    inline = bss_eval_framewise_tpu(refs, ests, rate, filter_len=32,
                                    hybrid_tol=0.0, device="cpu")
    with ThreadPoolExecutor(2) as pool:
        pooled = bss_eval_framewise_tpu(refs, ests, rate, filter_len=32,
                                        hybrid_tol=0.0, host_pool=pool,
                                        device="cpu")
    host = bsseval.bss_eval_framewise(refs, ests, rate, filter_len=32)
    for k in NAMES:  # tol 0 flags every window: all the host's
        np.testing.assert_array_equal(inline[k], host[k])
        np.testing.assert_array_equal(pooled[k], host[k])


def test_fp32_scorer_short_track_pads_one_window():
    """A track shorter than a window is one zero-padded window, whose
    correlations and energies are the sliced window's."""
    rate = 512
    refs, ests = _mix_case(np.random.default_rng(4), 2, 400, 1)
    host = bsseval.bss_eval_framewise(refs, ests, rate, filter_len=16)
    dev = bss_eval_framewise_tpu(refs, ests, rate, filter_len=16,
                                 device="cpu")
    assert dev["SDR"].shape == (2, 1)
    _assert_close(host, dev)


def test_fp32_factor_failure_is_nan_not_an_error():
    """cholesky_ex's failure NaNs that batch element's factor (JAX's
    Cholesky NaN-fills), so the gate sees it; the others stay exact."""
    from waveunet_tpu_torch.eval.bsseval_tpu import _factor

    good = torch.eye(3) * 2.0
    bad = -torch.eye(3)
    f = _factor(torch.stack([good, bad]), torch.zeros(2))
    torch.testing.assert_close(f[0], torch.linalg.cholesky(good))
    assert torch.isnan(f[1]).all()


# -- fp64 device scorer ------------------------------------------------------------

def test_f64_corr_and_gram_match_explicit_shift_matrix():
    rng = np.random.default_rng(7)
    K, n, L = 3, 300, 17
    refs = rng.standard_normal((K, n))
    n_out = n + L - 1
    M = np.zeros((n_out, K * L))
    for i in range(K):
        for a in range(L):
            M[a:a + n, i * L + a] = refs[i]
    rpos = _corr(torch.from_numpy(refs), torch.from_numpy(refs), L)
    G = _build_gram(rpos, L).numpy()
    np.testing.assert_allclose(G, M.T @ M, rtol=0, atol=1e-10)
    e = rng.standard_normal((2, n))
    D = _corr(torch.from_numpy(refs), torch.from_numpy(e), L).numpy()
    e_pad = np.zeros((2, n_out))
    e_pad[:, :n] = e
    np.testing.assert_allclose(D.transpose(0, 2, 1).reshape(K * L, 2),
                               M.T @ e_pad.T, rtol=0, atol=1e-10)


@pytest.mark.filterwarnings("ignore::scipy.linalg.LinAlgWarning")
@pytest.mark.parametrize("case,tol", [("well_conditioned", 1e-9),
                                      ("production_filter", 1e-6),
                                      ("silent_ref", 1e-9),
                                      ("three_one_silent", 1e-6)])
def test_f64_scorer_matches_host_exact_assembly(case, tol):
    rng = np.random.default_rng(len(case))
    S, n, C, L = 2, 4000, 2, 64
    if case == "production_filter":
        n, L = 8192, 512
    if case in ("silent_ref", "three_one_silent"):
        S, n, C, L = (2 if case == "silent_ref" else 3), 3000, 1, 32
    refs, ests = _leak_case(rng, S, n, C)
    if case == "silent_ref":
        refs[1] = 0.0
    if case == "three_one_silent":
        refs[2] = ests[2] = 0.0
    host = bsseval.bss_eval_window(refs, ests, filter_len=L,
                                   assembly="exact")
    dev = bss_eval_framewise_tpu64(refs, ests, rate=n, filter_len=L,
                                   window_batch=2, device="cpu")
    live = S - 1 if case in ("silent_ref", "three_one_silent") else S
    for k in NAMES:
        h, d = host[k][:live], dev[k][:live, 0]
        if case == "silent_ref":
            # no interference space left: the denominator sits at the
            # rounding floor, so cap at +250 dB (effectively infinite)
            h, d = np.minimum(h, 250.0), np.minimum(d, 250.0)
        assert _maxdiff(h, d) < tol, (k, h, d)
        if case == "silent_ref":
            assert np.all(np.isnan(dev[k][1])), k


def test_f64_scorer_framewise_against_jax_package():
    """The port's f64 scorer and the JAX package's on the same track,
    several windows and a batch that does not divide them."""
    from waveunet_tpu.eval.bsseval_tpu64 import (
        bss_eval_framewise_tpu64 as jax_tpu64)

    refs, ests = _leak_case(np.random.default_rng(9), 2, 3 * 700 + 50, 2)
    got = bss_eval_framewise_tpu64(refs, ests, 700, filter_len=16,
                                   window_batch=2, device="cpu")
    want = jax_tpu64(refs, ests, 700, filter_len=16, window_batch=2)
    for k in NAMES:
        assert _maxdiff(got[k], want[k]) < 1e-9, k


def test_f64_singular_gram_takes_the_lu_path():
    """A symmetric Gram that Cholesky refuses (an indefinite one, as the
    host's near-singular real-music Grams are numerically) is solved by
    pivoted LU, per batch element; a PD one beside it keeps Cholesky."""
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    pd = Q @ np.diag(np.linspace(1.0, 2.0, 40)) @ Q.T
    indef = Q @ np.diag(np.linspace(-1e-3, 2.0, 40)) @ Q.T
    rhs = rng.standard_normal((2, 40, 3))
    G = torch.from_numpy(np.stack([pd, indef]))
    _, info = torch.linalg.cholesky_ex(G)
    assert info.tolist()[0] == 0 and info.tolist()[1] > 0
    got = _host_style_solve(G, torch.from_numpy(rhs)).numpy()
    cho = torch.cholesky_solve(torch.from_numpy(rhs[0]),
                               torch.linalg.cholesky(G[0])).numpy()
    np.testing.assert_array_equal(got[0], cho)
    np.testing.assert_allclose(got[1], np.linalg.solve(indef, rhs[1]),
                               rtol=1e-9, atol=1e-9)


def test_device_scorers_refuse_a_mesh():
    """The fp32 scorer takes the port's mesh only; the fp64 scorer takes
    none, as the JAX package's takes none."""
    refs, ests = _leak_case(np.random.default_rng(1), 2, 600, 1)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        bss_eval_framewise_tpu(refs, ests, 600, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        bss_eval_framewise_tpu64(refs, ests, 600, mesh=object(),
                                 device="cpu")
