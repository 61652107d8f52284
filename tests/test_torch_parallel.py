"""The port's data parallelism on the CPU, against the JAX package.

Counterpart of ``tests/test_parallel.py``. A rank of the port is one
process; here the processes are joined over gloo on the CPU:

  * in this process, a world of one (gloo on a file store): the mesh
    helpers and their errors, ``pod_weighted_mean`` exact in float64, and
    every mesh path bit for bit equal to its mesh-free path;
  * two spawned ranks (one module fixture; ``torch_parallel_ranks.py``
    runs every check in each and writes its results): the data-parallel
    step against JAX's single-device step and JAX's step on a 2-device
    mesh, the ranks bit-identical, U7's data-parallel step (batch norm
    over the ranks) against JAX's 2-device step and against one process,
    the window-parallel ``Separator`` against JAX's ``Separator`` and
    against JAX's ``resident_sweep`` on a 2-device mesh, the mesh-sharded
    bank, and the sharded BSS-Eval;
  * the ``train`` and ``evaluate`` commands as two pod processes each;
  * ``dryrun_multichip(2)``.

Every spawned process has a timeout on its rendezvous, its collectives and
its join, so a hung collective fails its test.
"""

import datetime
import json
import multiprocessing as mp
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.infer.engine import Separator as JaxSeparator
from waveunet_tpu.models import spectrogram_unet as jax_su
from waveunet_tpu.models.waveunet import init_waveunet as jax_init
from waveunet_tpu.ops import shapes as jax_shapes
from waveunet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from waveunet_tpu.train.step import make_train_step as jax_make_train_step
from waveunet_tpu_torch.compat.params import (params_from_numpy,
                                              params_to_numpy)
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.data.audio_io import write_wav
from waveunet_tpu_torch.eval.bsseval_tpu import bss_eval_framewise_tpu
from waveunet_tpu_torch.eval.harness import evaluate_musdb
from waveunet_tpu_torch.infer.engine import Separator
from waveunet_tpu_torch.infer.wire import quantize_int16
from waveunet_tpu_torch.models.waveunet import init_waveunet
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.parallel import distributed as D
from waveunet_tpu_torch.parallel.dryrun import dryrun_multichip
from waveunet_tpu_torch.parallel.mesh import (Mesh, check_mesh, gather_rows,
                                              make_mesh, put_batch_sharded,
                                              put_replicated)
from waveunet_tpu_torch.train.step import (make_eval_step,
                                           make_scanned_epoch,
                                           make_train_step)
from test_torch_train_loop import make_cache
from torch_cpu import few_threads  # noqa: F401
from torch_parallel_ranks import (SWEEP, U7_LR, U7_SEED, U7_SMALL,
                                  eval_config,
                                  eval_params, flatten, run_rank, unflatten)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120      # a spawned rank's whole run
CLI_S = 180       # a pod CLI process's whole run
LOSS_RTOL = 1e-5  # tests/test_parallel.py:52-56
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
SEP_ATOL = 1e-5   # tests/test_parallel.py:87
SWEEP_ATOL = 2e-5  # separate() against JAX's sweep (test_torch_sweep.py)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_inputs():
    """test_parallel.py:29-41: baseline, 2 layers, 128 frames, 8 filters,
    batch 8, params from the JAX init."""
    cfg = jax_get_config("baseline", num_layers=2, num_frames=128,
                         num_initial_filters=8, batch_size=8)
    params = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    _, out_len = jax_shapes.get_padding(cfg, cfg.num_frames)
    rng = np.random.default_rng(1337)
    srcs = {s: (0.2 * rng.standard_normal((8, out_len, 1))).astype(
        np.float32) for s in cfg.source_names}
    in_len, _ = jax_shapes.get_padding(cfg, cfg.num_frames)
    pad = (in_len - out_len) // 2
    batch = dict(srcs)
    batch["mix"] = np.pad(sum(srcs.values()), [(0, 0), (pad, pad), (0, 0)])
    return cfg, params, batch


def sep_inputs():
    cfg = jax_get_config("baseline_context", num_layers=3, num_frames=256,
                         infer_batch=2)
    params = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    _, out_len = jax_shapes.get_padding(cfg, cfg.num_frames)
    audio = (0.1 * np.random.default_rng(7).standard_normal(
        (out_len * 7 + 13, 1))).astype(np.float32)
    return cfg, params, audio


def u7_inputs():
    """The spectrogram U-Net at U7_SMALL, params and state from the JAX
    init moved off their zeros (so batch norm has statistics to move), and
    a seeded global batch of 4."""
    jcfg = jax_get_config("unet_spectrogram", **U7_SMALL)
    p, st = jax_su.init_spectrogram_unet(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.normal(
        size=a.shape).astype(np.float32), p)
    st = jax.tree_util.tree_map(lambda a: np.abs(
        np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)),
        st)
    shape = (jcfg.batch_size, jcfg.num_frames, 1)
    batch = {k: (0.2 * rng.standard_normal(shape)).astype(np.float32)
             for k in ("mix",) + tuple(jcfg.source_names)}
    return jcfg, p, st, batch


def jax_u7_mesh_step(jcfg, p, st, batch):
    """JAX's U7 step on a 2-device mesh with dropout keeping every value
    (its masks cannot be drawn in PyTorch): (loss, params, state)."""
    mesh2 = jax_make_mesh(devices=jax.devices()[:2])
    init_opt, step = jax_make_train_step(jcfg, U7_LR, mesh=mesh2)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax.random, "bernoulli",
                    lambda key, p, shape: jnp.ones(shape, bool))
        p2, st2, _, loss = step(jp, jax.tree_util.tree_map(jnp.asarray, st),
                                init_opt(jp),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0))
    return float(loss), np_tree(p2), np_tree(st2)


def port_u7_step(p, st, batch):
    """The port's U7 step in one process on the whole global batch, dropout
    on: (loss, params, state)."""
    init_opt, step = make_train_step(get_config("unet_spectrogram",
                                                **U7_SMALL), U7_LR,
                                     device="cpu")
    tp = params_from_numpy(p, "cpu")
    tp, tst, _, loss = step(tp, params_from_numpy(st, "cpu"), init_opt(tp),
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            torch.Generator().manual_seed(U7_SEED))
    return float(loss), params_to_numpy(tp), params_to_numpy(tst)


def is_bias_before_batch_norm(layer, leaf):
    """A conv bias that a training batch norm follows (every U7 conv but
    the mask's)."""
    return leaf == "bias" and not layer.endswith("/mask")


def sweep_song(out_len, n_win=13):
    """A song of ``n_win`` windows, the last right-aligned."""
    n = out_len * (n_win - 1) + 31
    return (0.1 * np.random.default_rng(5).standard_normal((n, 1))).astype(
        np.float32)


def jax_mesh_sweeps(params, audio):
    """JAX's resident sweep on a 2-device mesh, per wire."""
    mesh2 = jax_make_mesh(devices=jax.devices()[:2])
    out = {}
    for wire in ("float32", "int16"):
        jsep = JaxSeparator(jax_get_config("baseline", infer_wire_dtype=wire,
                                           **SWEEP),
                            jax.tree_util.tree_map(jnp.asarray, params),
                            mesh=mesh2)
        padded = np.pad(audio, [(jsep.pad, jsep.pad), (0, 0)])
        if wire == "int16":
            padded = quantize_int16(padded)
        fn, _ = jsep.resident_sweep(audio.shape[0])
        got, _ = fn(jsep.params, jnp.asarray(padded))
        out[wire] = {k: np.asarray(v) for k, v in got.items()}
    return out


def bss_inputs():
    rng = np.random.default_rng(11)
    refs = (0.1 * rng.standard_normal((2, 5 * 256, 1))).astype(np.float32)
    ests = (0.9 * refs + 0.05 * rng.standard_normal(refs.shape)).astype(
        np.float32)
    return refs, ests


# -- a world of one, in this process ------------------------------------------

@pytest.fixture
def group1(tmp_path):
    """A gloo process group of one rank, destroyed afterwards."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        yield make_mesh(devices=["cpu"])
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    assert mesh.backend is None and mesh.device == torch.device("cpu")


@pytest.mark.parametrize("shape,axes", [(None, ("data",)), ((-1,), ("data",)),
                                        ((1, -1), ("a", "b"))])
def test_make_mesh_shapes(group1, shape, axes):
    mesh = make_mesh(shape, axes, devices=["cpu"])
    assert mesh.size == 1 and mesh.axis_names == axes
    assert mesh.backend == "gloo"


@pytest.mark.parametrize("kw,match", [
    (dict(shape=(2,)), r"mesh shape \(2,\) != 1 devices"),
    (dict(shape=(1,), axis_names=("a", "b")), "do not name"),
    (dict(devices=["cpu", "cpu"]), "one process per card")])
def test_make_mesh_errors(group1, kw, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(**{"devices": ["cpu"], **kw})


def test_put_helpers_and_batch_slices(group1):
    mesh = group1
    tree = {"a": {"w": np.arange(6, dtype=np.float32)}}
    rep = put_replicated(tree, mesh)
    assert torch.equal(rep["a"]["w"], torch.arange(6, dtype=torch.float32))
    x = np.arange(24, dtype=np.float32).reshape(8, 3, 1)
    assert torch.equal(put_batch_sharded(x, mesh), torch.from_numpy(x))
    assert D.local_batch_slice(8) == slice(0, 8)
    glob = D.global_batch_from_local(mesh, {"mix": x})
    assert torch.equal(glob["mix"], torch.from_numpy(x))
    assert D.replicated_local_view(tree) is tree
    neg = torch.tensor([[-0.0, float("nan")]])
    got = gather_rows(neg, mesh)
    assert torch.equal(got.view(torch.int32), neg.view(torch.int32))
    assert D.initialize() == 0  # already up: the rank, nothing else


def test_pod_weighted_mean_is_float64_exact(group1, capsys):
    x = 1.0 + 2.0 ** -30  # float32 rounds it to 1.0
    assert np.float32(x) == 1.0
    assert D.pod_weighted_mean(x, 1) == x
    assert D.pod_weighted_mean(3 * x, 3) == 3 * x / 3
    assert D.pod_weighted_mean(0.0, 0) == float("inf")
    assert "no batches" in capsys.readouterr().out


def _tiny_step_inputs():
    cfg = get_config("baseline", num_layers=2, num_frames=128,
                     num_initial_filters=8, batch_size=4)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    rng = np.random.default_rng(3)
    batch = {s: torch.from_numpy((0.2 * rng.standard_normal(
        (4, out_len, 1))).astype(np.float32)) for s in cfg.source_names}
    batch["mix"] = torch.from_numpy((0.2 * rng.standard_normal(
        (4, in_len, 1))).astype(np.float32))
    return cfg, batch


def _fresh(cfg):
    return init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")


def test_world_of_one_step_is_the_mesh_free_step_bit_for_bit(group1):
    cfg, batch = _tiny_step_inputs()
    runs = []
    for mesh in (None, group1):
        init_opt, step = make_train_step(cfg, 1e-3, device="cpu", mesh=mesh)
        p = _fresh(cfg)
        o = init_opt(p)
        losses = []
        for _ in range(2):
            p, _, o, loss = step(p, {}, o, batch)
            losses.append(loss)
        runs.append((p, o, losses))
    (p1, o1, l1), (p2, o2, l2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    for k in p1:
        for n in p1[k]:
            assert torch.equal(p1[k][n], p2[k][n]), (k, n)
            assert torch.equal(o1["nu"][k][n], o2["nu"][k][n]), (k, n)
    ev = [make_eval_step(cfg, device="cpu", mesh=m)(p1, {}, batch)
          for m in (None, group1)]
    assert torch.equal(ev[0], ev[1])


def test_world_of_one_fused_epoch_is_the_mesh_free_epoch(group1, capsys):
    cfg, batch = _tiny_step_inputs()

    def sample(key, step):
        return batch

    out = []
    for mesh in (None, group1):
        init_opt, _ = make_train_step(cfg, 1e-3, device="cpu")
        epoch = make_scanned_epoch(cfg, 1e-3, 3, sample, chunk=2,
                                   device="cpu", mesh=mesh)
        p = _fresh(cfg)
        p, _, _, losses = epoch(p, {}, init_opt(p), 1, 0)
        out.append((p, losses))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    for k in out[0][0]:
        for n in out[0][0][k]:
            assert torch.equal(out[0][0][k][n], out[1][0][k][n])
    out = capsys.readouterr().out
    assert "1-rank mesh (gloo): the eager loop on cpu" in out


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_world_of_one_separator_is_the_single_device_engine(group1, wire):
    cfg = get_config("baseline_context", num_layers=3, num_frames=256,
                     infer_batch=2, infer_wire_dtype=wire)
    _, out_len = shapes.get_padding(cfg, cfg.num_frames)
    audio = (0.1 * np.random.default_rng(5).standard_normal(
        (out_len * 5 + 11, 1))).astype(np.float32)
    params = _fresh(cfg)
    one = Separator(cfg, params, device="cpu").separate(audio,
                                                        cfg.expected_sr)
    sep = Separator(cfg, params, mesh=group1)
    assert sep.batch == sep.local_batch == 2
    got = sep.separate(audio, cfg.expected_sr)
    for s in cfg.source_names:
        np.testing.assert_array_equal(got[s], one[s])
    # one rank keeps the single-device schedule; several share full tails
    single = Separator(cfg, params, device="cpu")
    assert [sep._chunk_sizes(n) for n in (1, 5, 11)] == [
        single._chunk_sizes(n) for n in (1, 5, 11)]
    two = Separator(cfg, params, mesh=Mesh((2,), ("data",),
                                           torch.device("cpu"), 1))
    assert (two.batch, two._chunk_sizes(11), two._pow2_sizes()) == (
        4, [4, 4, 4], [2])


def test_world_of_one_scorer_is_the_mesh_free_scorer(group1):
    refs, ests = bss_inputs()
    kw = dict(rate=256, filter_len=16, window_batch=3)
    a = bss_eval_framewise_tpu(refs, ests, device="cpu", **kw)
    b = bss_eval_framewise_tpu(refs, ests, mesh=group1, **kw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _mesh_callers(tmp_path):
    from waveunet_tpu_torch.eval.harness import evaluate_musdb
    from waveunet_tpu_torch.train.loop import optimise

    cfg = get_config("baseline", num_layers=2, num_frames=128,
                     num_initial_filters=4)
    refs, ests = bss_inputs()
    return {
        "check_mesh": lambda m: check_mesh(m),
        "make_train_step": lambda m: make_train_step(cfg, 1e-3, mesh=m),
        "make_eval_step": lambda m: make_eval_step(cfg, mesh=m),
        "make_scanned_epoch": lambda m: make_scanned_epoch(
            cfg, 1e-3, 2, None, mesh=m),
        "Separator": lambda m: Separator(cfg, _fresh(cfg), mesh=m),
        "bss_eval_framewise_tpu": lambda m: bss_eval_framewise_tpu(
            refs, ests, 256, filter_len=16, mesh=m),
        "optimise": lambda m: optimise(cfg, mesh=m, device="cpu"),
        "evaluate_musdb": lambda m: evaluate_musdb(cfg, _fresh(cfg), mesh=m,
                                                   device="cpu"),
    }


@pytest.mark.parametrize("caller", ["check_mesh", "make_train_step",
                                    "make_eval_step", "make_scanned_epoch",
                                    "Separator", "bss_eval_framewise_tpu",
                                    "optimise", "evaluate_musdb"])
@pytest.mark.parametrize("bad", ["jax_mesh", "device_list"])
def test_a_mesh_that_is_not_a_port_mesh_raises_type_error(caller, bad,
                                                          tmp_path):
    mesh = (jax_make_mesh(devices=jax.devices()[:1]) if bad == "jax_mesh"
            else ["cpu"])
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        _mesh_callers(tmp_path)[caller](mesh)


def test_world_of_one_u7_step_is_the_mesh_free_step(group1):
    """Dropout on, the same generator: a one-rank mesh takes the mesh-free
    batch norm and masks, bit for bit."""
    _, p, st, batch = u7_inputs()
    runs = []
    for mesh in (None, group1):
        init_opt, step = make_train_step(
            get_config("unet_spectrogram", **U7_SMALL), 1e-3, device="cpu",
            mesh=mesh)
        tp, tst = params_from_numpy(p, "cpu"), params_from_numpy(st, "cpu")
        tp, tst, _, loss = step(tp, tst, init_opt(tp),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                torch.Generator().manual_seed(U7_SEED))
        runs.append((loss, params_to_numpy(tp), params_to_numpy(tst)))
    (l1, p1, s1), (l2, p2, s2) = runs
    assert torch.equal(l1, l2)
    for a, b in ((p1, p2), (s1, s2)):
        for k in a:
            for n in a[k]:
                np.testing.assert_array_equal(a[k][n], b[k][n], err_msg=k)


def test_u7_trains_on_a_two_rank_mesh(two_ranks):
    """Two ranks step U7 together: the same loss, parameters and moved
    statistics on both, the statistics moved from their start."""
    a, b = two_ranks["ranks"]
    _, _, st, _ = two_ranks["u7"]
    for name in ("u7_keep", "u7_drop"):
        assert np.isfinite(a[f"{name}_loss"])
        assert a[f"{name}_loss"] == b[f"{name}_loss"]
        keys = [k for k in a if k.startswith((f"{name}_params/",
                                              f"{name}_state/"))]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        moved = unflatten(a, f"{name}_state")
        assert all(not np.array_equal(moved[k][s], st[k][s])
                   for k in st for s in st[k])


# -- two spawned ranks -------------------------------------------------------

def start_ranks(target, n, workdir):
    """``target(rank, n, workdir)`` in ``n`` spawned processes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, n, str(workdir)))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, timeout=JOIN_S):
    """Every process must exit 0 within ``timeout`` (a hung one is
    killed)."""
    for p in procs:
        p.join(timeout)
    hung = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert not any(hung) and codes == [0] * len(procs), (hung, codes)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, and the JAX references on the same inputs."""
    work = tmp_path_factory.mktemp("ranks")
    tcfg, tparams, batch = train_inputs()
    scfg, sparams, audio = sep_inputs()
    refs, ests = bss_inputs()
    u7 = u7_inputs()
    wcfg = jax_get_config("baseline", **SWEEP)
    wparams = np_tree(jax_init(jax.random.PRNGKey(3), wcfg))
    waudio = sweep_song(jax_shapes.get_padding(wcfg, wcfg.num_frames)[1])
    _make_db(work, noise=True)
    np.savez(work / "inputs.npz", audio=audio, bss_refs=refs, bss_ests=ests,
             sweep_audio=waudio,
             **{f"batch/{k}": v for k, v in batch.items()},
             **{f"u7batch/{k}": v for k, v in u7[3].items()},
             **flatten("train_params", tparams),
             **flatten("sep_params", sparams),
             **flatten("u7_params", u7[1]), **flatten("u7_state", u7[2]),
             **flatten("sweep_params", wparams))
    procs = start_ranks(run_rank, 2, work)  # the JAX references meanwhile

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    p0 = jax.tree_util.tree_map(jnp.asarray, tparams)
    init_opt, step1 = jax_make_train_step(tcfg, 1e-4)
    p1, _, _, l1 = step1(copy(p0), {}, init_opt(p0), jb,
                         jax.random.PRNGKey(0))
    mesh2 = jax_make_mesh(devices=jax.devices()[:2])
    init_opt, step2 = jax_make_train_step(tcfg, 1e-4, mesh=mesh2)
    p2, _, _, l2 = step2(copy(p0), {}, init_opt(p0), jb,
                         jax.random.PRNGKey(0))
    single = JaxSeparator(scfg, jax.tree_util.tree_map(jnp.asarray,
                                                       sparams)).separate(
        audio, scfg.expected_sr)
    u7_keep = jax_u7_mesh_step(*u7)
    u7_drop = port_u7_step(*u7[1:])
    sweeps = jax_mesh_sweeps(wparams, waudio)
    ecfg = eval_config(str(work / "db"))
    one_eval = evaluate_musdb(ecfg, eval_params(ecfg), tpu_bss=True,
                              output_path=str(work / "one_eval"),
                              device="cpu")
    join_ranks(procs)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return {"work": work, "one_eval": np.asarray(one_eval, np.float64),
            "ranks": ranks, "cfg": tcfg, "sep_cfg": scfg,
            "jax_steps": {"single": (float(l1), np_tree(p1)),
                          "mesh2": (float(l2), np_tree(p2))},
            "jax_sep": single, "u7": u7,
            "u7_refs": {"u7_keep": u7_keep, "u7_drop": u7_drop},
            "jax_sweeps": sweeps}


def test_two_ranks_form_one_mesh(two_ranks):
    assert [r["mesh"].tolist() for r in two_ranks["ranks"]] == [[2, 0],
                                                                  [2, 1]]
    assert all(bool(r["odd_rows_raised"]) for r in two_ranks["ranks"])


@pytest.mark.parametrize("ref", ["single", "mesh2"])
def test_dp_step_matches_jax(two_ranks, ref):
    """The 2-rank step against JAX's single-device step and JAX's step on
    a 2-device mesh (test_parallel.py:29-56)."""
    loss, params = two_ranks["jax_steps"][ref]
    r0 = two_ranks["ranks"][0]
    np.testing.assert_allclose(float(r0["train_loss"]), loss,
                               rtol=LOSS_RTOL)
    got = unflatten(r0, "stepped")
    for k in params:
        for n in params[k]:
            np.testing.assert_allclose(got[k][n], params[k][n],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("name", ["u7_keep", "u7_drop"])
def test_u7_dp_step_matches_one_process(two_ranks, name):
    """Two ranks of U7, 2 rows each of the global batch of 4: with dropout
    keeping every value against JAX's step on a 2-device mesh
    (``u7_keep``), with dropout on against the port's step in one process
    on the whole batch with the same generator (``u7_drop``). Loss,
    parameters and moved statistics at tests/test_parallel.py's
    tolerances."""
    loss, params, state = two_ranks["u7_refs"][name]
    _, init, _, _ = two_ranks["u7"]
    r0 = two_ranks["ranks"][0]
    np.testing.assert_allclose(float(r0[f"{name}_loss"]), loss,
                               rtol=LOSS_RTOL)
    for prefix, want in (("params", params), ("state", state)):
        got = unflatten(r0, f"{name}_{prefix}")
        assert sorted(got) == sorted(want)
        for k in want:
            for n in want[k]:
                if prefix == "params" and is_bias_before_batch_norm(k, n):
                    # its true gradient is 0 (the batch mean takes the bias
                    # out again) and each side's is rounding noise, which
                    # Adam's first step scales up to as much as lr: both
                    # moved by at most lr, not in the same direction
                    for side in (got, want):
                        assert np.abs(side[k][n] - init[k][n]).max() <= U7_LR
                    continue
                np.testing.assert_allclose(got[k][n], want[k][n],
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           err_msg=f"{prefix} {k}/{n}")


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_mesh_separate_matches_jax_mesh_sweep(two_ranks, wire):
    """Two ranks' separate() (chunks of 8 windows, 4 a rank, gathered onto
    every rank) against JAX's resident sweep on a 2-device mesh; the ranks
    return the same stems."""
    a, b = two_ranks["ranks"]
    want = two_ranks["jax_sweeps"][wire]
    assert a[f"mesh_sep_{wire}_sizes"].tolist() == [8, 8]
    for s, v in want.items():
        np.testing.assert_allclose(a[f"mesh_sep_{wire}/{s}"], v,
                                   atol=SWEEP_ATOL, err_msg=s)
        np.testing.assert_array_equal(a[f"mesh_sep_{wire}/{s}"],
                                      b[f"mesh_sep_{wire}/{s}"])


def test_ranks_hold_bit_identical_params(two_ranks):
    a, b = two_ranks["ranks"]
    assert a["train_loss"] == b["train_loss"]
    for prefix in ("stepped", "eager", "fused"):
        keys = [k for k in a if k.startswith(prefix + "/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dp_eval_step_matches_the_whole_batch(two_ranks):
    from waveunet_tpu.train.step import make_eval_step as jax_eval_step

    _, params, batch = train_inputs()
    want = float(jax_eval_step(two_ranks["cfg"])(
        jax.tree_util.tree_map(jnp.asarray, params), {},
        {k: jnp.asarray(v) for k, v in batch.items()}))
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(float(r["eval_loss"]), want,
                                   rtol=LOSS_RTOL)


def test_window_parallel_separator_matches_jax(two_ranks):
    a, b = two_ranks["ranks"]
    for s in two_ranks["sep_cfg"].source_names:
        np.testing.assert_allclose(a[f"sep/{s}"], two_ranks["jax_sep"][s],
                                   atol=SEP_ATOL)
        np.testing.assert_array_equal(a[f"sep/{s}"], b[f"sep/{s}"])


def test_sharded_bank_song_provenance(two_ranks):
    """Each rank's rows come only from its round-robin songs
    (test_parallel.py:415-447), and the shards agree on one padded size."""
    n_songs = 12
    for rank, r in enumerate(two_ranks["ranks"]):
        assert r["bank_songs"][0] == 6
        allowed = np.asarray([(i + 1) / 100
                              for i in range(rank, n_songs, 2)])
        for rows in r["bank_rows"]:
            assert rows.shape[0] == 8  # 16 a step over 2 ranks
            for row in rows:
                vals = np.unique(row)
                assert vals.size == 1, "window crossed a song or the padding"
                assert np.isclose(vals[0], allowed, atol=1e-4).any()
    assert len({int(r["bank_songs"][1]) for r in two_ranks["ranks"]}) == 1


def test_sharded_bank_errors_on_every_rank(two_ranks):
    for r in two_ranks["ranks"]:
        assert "song per device" in str(r["too_few"])
        assert "not divisible by 2 mesh devices" in str(r["odd_batch"])


def test_sharded_bank_eager_stream_is_the_fused_epoch(two_ranks):
    for r in two_ranks["ranks"]:
        np.testing.assert_array_equal(r["eager_losses"], r["fused_losses"])
        for k in [k for k in r if k.startswith("eager/")]:
            np.testing.assert_array_equal(r[k], r["fused/" + k[6:]])


def test_sharded_bank_serves_the_stored_mix(two_ranks):
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["stored_mix"], 0.9, atol=1e-3)
        assert np.all(r["stored_vocals"] > 0) and np.all(
            r["stored_vocals"] < 0.2)


def test_pod_weighted_mean_over_uneven_shards(two_ranks):
    for r in two_ranks["ranks"]:
        assert float(r["wmean_empty"]) == 0.5
        assert float(r["wmean_exact"]) == (1.0 + 2.0 ** -30) / 2
        assert float(r["wmean_none"]) == float("inf")


def test_sharded_scorer_equals_the_unsharded_run(two_ranks):
    for r in two_ranks["ranks"]:
        for k in ("SDR", "ISR", "SIR", "SAR"):
            np.testing.assert_allclose(r[f"bss_mesh/{k}"], r[f"bss_one/{k}"],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    a, b = two_ranks["ranks"]
    np.testing.assert_array_equal(a["bss_mesh/SIR"], b["bss_mesh/SIR"])


def test_window_parallel_evaluate_musdb_matches_one_process(two_ranks):
    """Both ranks return the single-process statistics; rank 0 wrote one
    JSON a track. The fp32 scorer's solves round by their batch (each rank
    factorises half of every window batch), so the windows' ISR, SIR and
    SAR are held to the fp32 scorer's accuracy contract against the host,
    0.01 dB + rtol 1e-4 (tests/test_bsseval_tpu.py:29-35); SDR is
    solve-free and held to 1e-6."""
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["eval_stats"], two_ranks["one_eval"],
                                   rtol=1e-6, atol=1e-6)
    work = two_ranks["work"]
    for song in ("songP", "songQ"):
        a, b = (json.load(open(work / d / "test" / f"{song}.json"))
                for d in ("mesh_eval", "one_eval"))
        for ta, tb in zip(a["targets"], b["targets"]):
            for fa, fb in zip(ta["frames"], tb["frames"]):
                for k in ("SDR", "ISR", "SIR", "SAR"):
                    ma, mb = (np.nan if m[k] is None else m[k]
                              for m in (fa["metrics"], fb["metrics"]))
                    tol = (dict(rtol=1e-6, atol=1e-6) if k == "SDR"
                           else dict(rtol=1e-4, atol=0.01))
                    np.testing.assert_allclose(ma, mb, err_msg=k, **tol)


# -- the pod CLI -------------------------------------------------------------

_SR = 8192
_CFG = dict(num_layers=2, num_frames=256, num_initial_filters=4,
            expected_sr=_SR, batch_size=4, epoch_it=2,
            num_snippets_per_track=4, cache_size=8, worse_epochs=1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _make_db(root, noise=False):
    """Two test songs: the pod's evaluation strides them, songP to rank 0
    and songQ to rank 1. Sine stems as in tests/test_parallel.py, or noise
    stems, whose Grams the fp32 scorer keeps on the device (a sine's it
    sends to the host fp64 scorer, seconds a window)."""
    t = np.arange(_SR * 2) / _SR
    rng = np.random.default_rng(4)
    for song, f0, f1 in (("songP", 440.0, 220.0), ("songQ", 330.0, 110.0)):
        d = root / "db" / "test" / song
        d.mkdir(parents=True)
        voc = (0.3 * np.sin(2 * np.pi * f0 * t))[:, None].astype(np.float32)
        acc = (0.3 * np.sin(2 * np.pi * f1 * t))[:, None].astype(np.float32)
        if noise:
            voc, acc = (0.2 * rng.standard_normal((t.size, 1))
                        .astype(np.float32) for _ in range(2))
        write_wav(str(d / "vocals.wav"), voc, _SR)
        write_wav(str(d / "accompaniment.wav"), acc, _SR)
        write_wav(str(d / "mixture.wav"), voc + acc, _SR)


def run_pod(args):
    """``python -m waveunet_tpu_torch <args>`` as two pod processes on the
    CPU; both must exit 0 within CLI_S. Returns their outputs."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "waveunet_tpu_torch", *args, "platform=cpu",
         f"coordinator=127.0.0.1:{port}", "num_processes=2",
         f"process_id={i}"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CLI_S)
            assert p.returncode == 0, out[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_pod_cli_train(tmp_path):
    """Two ranks of ``train`` (test_parallel.py:182): the sharded bank,
    equal losses on both ranks, metrics and checkpoints from rank 0 only,
    and the track-sharded final evaluation aggregated by rank 0."""
    kw = dict(_CFG, data_path=str(tmp_path / "cache"),
              musdb_path=str(tmp_path / "db"),
              estimates_path=str(tmp_path / "est"),
              model_base_dir=str(tmp_path / "ckpts"),
              log_dir=str(tmp_path / "logs"))
    make_cache(tmp_path, get_config("baseline", **kw), n_songs=4)
    _make_db(tmp_path)
    outs = run_pod(["train", "baseline", *[f"{k}={v}" for k, v in kw.items()],
                    "experiment_id=podtrain", "max_epochs=1", "final_eval=1",
                    "max_tracks=2", "tpu_bss=1"])

    banks = [re.search(r"device-sharded bank: (\d+) songs", o) for o in outs]
    assert all(banks), outs[0][-2000:]
    assert [int(m.group(1)) for m in banks] == [2, 2]

    def losses(o):
        vals = re.findall(r"Validation (?:improved .* -> |worsened to )"
                          r"([0-9.eE+-]+|inf)", o)
        final = re.search(r"Best model: (.*); test loss ([0-9.eE+-]+)", o)
        assert vals and final, o[-2000:]
        return [float(v) for v in vals], final.group(1), float(final.group(2))

    (v0, best0, t0), (v1, best1, t1) = losses(outs[0]), losses(outs[1])
    assert v0 == v1 and t0 == t1 and best0 == best1
    assert len(v0) == 2 and all(np.isfinite(v0)) and np.isfinite(t0)
    assert os.path.isdir(best0)
    assert os.path.exists(tmp_path / "ckpts" / "podtrain" / "best.txt")
    recs = [json.loads(line) for line in
            open(tmp_path / "logs" / "podtrain" / "metrics.jsonl")]
    # one writer: each epoch's validation logged once, not once a rank
    assert len([r for r in recs if "valid_loss" in r]) == 2
    for i, song in enumerate(("songP", "songQ")):
        assert f"Separating {song}" in outs[i], outs[i][-1500:]
        assert os.path.exists(tmp_path / "est" / "test" / f"{song}.json")
    assert "Skipping songQ (shard 1/2's track)" in outs[0]
    assert "Skipping songP (shard 0/2's track)" in outs[1]
    assert ": SDR median" in outs[0] and ": SDR median" not in outs[1]


def test_pod_cli_evaluate(tmp_path):
    """Two ranks of ``evaluate`` (test_parallel.py:287): disjoint track
    shards, rank 0's table over both."""
    _make_db(tmp_path)
    outs = run_pod(["evaluate", "baseline", "random_init=1",
                    f"musdb_path={tmp_path / 'db'}",
                    f"estimates_path={tmp_path / 'est'}",
                    *[f"{k}={v}" for k, v in _CFG.items()]])
    for i, song in enumerate(("songP", "songQ")):
        assert f"pod test eval: scoring track shard {i}/2" in outs[i]
        assert f"Separating {song}" in outs[i], outs[i][-1500:]
        assert os.path.exists(tmp_path / "est" / "test" / f"{song}.json")
    assert ": SDR median" in outs[0], outs[0][-1500:]
    assert ": SDR median" not in outs[1], outs[1][-1500:]


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2)
