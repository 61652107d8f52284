"""What each rank of the port's two-process CPU tests runs.

``tests/test_torch_parallel.py`` writes the inputs (parameters from the JAX
init, batches, audio) to ``inputs.npz``, spawns ``run_rank`` in two
processes joined over gloo, and asserts on the ``rank<r>.npz`` files they
write. This module imports the port and numpy only, so a rank starts
without JAX.
"""

import os
import sys
import traceback

import numpy as np
import torch

TIMEOUT_S = 60.0  # every collective and the rendezvous


def flatten(prefix, tree):
    return {f"{prefix}/{layer}/{name}": np.asarray(v)
            for layer, leaves in tree.items() for name, v in leaves.items()}


def unflatten(arrays, prefix):
    tree = {}
    for key in arrays:
        if key.startswith(prefix + "/"):
            # a layer name may hold a "/" (the spectrogram U-Net's)
            layer, name = key[len(prefix) + 1:].rsplit("/", 1)
            tree.setdefault(layer, {})[name] = arrays[key]
    return tree


def synthetic_tracks(cfg, n_songs, min_len, rng, constant=False):
    """The JAX tests' songs: source j of song i the flat value
    (i+1)*(j+1)/100 when ``constant`` (provenance survives int16), noise
    otherwise; a silent stored mixture."""
    tracks = []
    for i in range(n_songs):
        n = min_len + 300 + 41 * i
        t = {}
        for j, s in enumerate(cfg.source_names):
            if constant:
                t[s] = np.full((n, cfg.num_channels),
                               (i + 1) * (j + 1) / 100, np.float32)
            else:
                t[s] = (0.2 * rng.standard_normal((n, cfg.num_channels))
                        ).astype(np.float32)
        t["mix"] = np.zeros((n, cfg.num_channels), np.float32)
        tracks.append(t)
    return tracks


def _checks(rank, n, workdir):
    from waveunet_tpu_torch.compat.params import (params_from_numpy,
                                                  params_to_numpy)
    from waveunet_tpu_torch.config import get_config
    from waveunet_tpu_torch.data.device_cache import ShardedBank
    from waveunet_tpu_torch.eval.bsseval_tpu import bss_eval_framewise_tpu
    from waveunet_tpu_torch.infer.engine import Separator, window_positions
    from waveunet_tpu_torch.models.waveunet import init_waveunet
    from waveunet_tpu_torch.ops import shapes
    from waveunet_tpu_torch.parallel import distributed as D
    from waveunet_tpu_torch.parallel.mesh import make_mesh, put_batch_sharded
    from waveunet_tpu_torch.train.step import (make_eval_step,
                                               make_scanned_epoch,
                                               make_train_step)

    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    mesh = make_mesh(devices=["cpu"])
    out["mesh"] = np.asarray([mesh.size, mesh.rank])

    # the data-parallel train step and eval step (test_parallel.py:29-69)
    cfg = get_config("baseline", num_layers=2, num_frames=128,
                     num_initial_filters=8, batch_size=8)
    batch = {k[len("batch/"):]: inp[k] for k in inp.files
             if k.startswith("batch/")}
    params = params_from_numpy(unflatten(inp, "train_params"), "cpu")
    init_opt, step = make_train_step(cfg, 1e-4, mesh=mesh)
    params, _, _, loss = step(params, {}, init_opt(params),
                              put_batch_sharded(batch, mesh))
    out["train_loss"] = np.asarray(float(loss))
    out.update(flatten("stepped", params_to_numpy(params)))
    ev = make_eval_step(cfg, mesh=mesh)
    out["eval_loss"] = np.asarray(float(ev(
        params_from_numpy(unflatten(inp, "train_params"), "cpu"), {},
        put_batch_sharded(batch, mesh))))
    try:
        put_batch_sharded(np.zeros((7, 4, 1), np.float32), mesh)
        out["odd_rows_raised"] = np.asarray(False)
    except ValueError:
        out["odd_rows_raised"] = np.asarray(True)

    # window-parallel separation (test_parallel.py:73-87)
    scfg = get_config("baseline_context", num_layers=3, num_frames=256,
                      infer_batch=2)
    sep = Separator(scfg, params_from_numpy(unflatten(inp, "sep_params"),
                                            "cpu"), mesh=mesh)
    for name, v in sep.separate(inp["audio"], scfg.expected_sr).items():
        out[f"sep/{name}"] = v

    # the mesh-sharded bank (test_parallel.py:361-519)
    bcfg = get_config("baseline", num_layers=2, num_frames=256,
                      num_initial_filters=4, batch_size=16,
                      augmentation=False)
    in_len, out_len = shapes.get_padding(bcfg, bcfg.num_frames)
    rng = np.random.default_rng(0)
    bank = ShardedBank.from_tracks(
        bcfg, in_len, out_len, mesh,
        synthetic_tracks(bcfg, 12, in_len, rng, constant=True),
        batch_size=bcfg.batch_size)
    out["bank_songs"] = np.asarray([bank.local_songs, bank.nbytes()])
    src0 = bcfg.source_names[0]
    out["bank_rows"] = np.stack([bank.sample(3, t)[src0].numpy()
                                 for t in range(4)])
    try:
        ShardedBank.from_tracks(bcfg, in_len, out_len, mesh,
                                synthetic_tracks(bcfg, 1, in_len, rng),
                                batch_size=8)
        out["too_few"] = np.asarray("")
    except ValueError as e:
        out["too_few"] = np.asarray(str(e))
    try:
        bank.set_batch(15)
        out["odd_batch"] = np.asarray("")
    except ValueError as e:
        out["odd_batch"] = np.asarray(str(e))

    mix_tracks = synthetic_tracks(bcfg, 8, in_len, rng, constant=True)
    for t in mix_tracks:
        t["mix"] = np.full_like(t["mix"], 0.9)  # != sum(sources)
    mbank = ShardedBank.from_tracks(bcfg, in_len, out_len, mesh, mix_tracks,
                                    batch_size=8)
    b = next(mbank.batches(0))
    out["stored_mix"] = b["mix"].numpy()
    out["stored_vocals"] = b["vocals"].numpy()

    # eager steps over bank.batches against the fused epoch, same stream
    ecfg = get_config("baseline", num_layers=2, num_frames=256,
                      num_initial_filters=4, batch_size=8, epoch_it=4)
    e_in, e_out = shapes.get_padding(ecfg, ecfg.num_frames)
    ebank = ShardedBank.from_tracks(
        ecfg, e_in, e_out, mesh, synthetic_tracks(ecfg, 8, e_in, rng),
        batch_size=ecfg.batch_size)
    eparams = params_to_numpy(init_waveunet(torch.Generator().manual_seed(1),
                                            ecfg, "cpu"))
    p = params_from_numpy(eparams, "cpu")
    init_opt, estep = make_train_step(ecfg, 1e-4, mesh=mesh)
    o = init_opt(p)
    it = ebank.batches(5)
    eager = []
    for _ in range(ecfg.epoch_it):
        p, _, o, loss = estep(p, {}, o, next(it))
        eager.append(float(loss))
    out["eager_losses"] = np.asarray(eager)
    out.update(flatten("eager", params_to_numpy(p)))
    p2 = params_from_numpy(eparams, "cpu")
    epoch = make_scanned_epoch(ecfg, 1e-4, ecfg.epoch_it, ebank.sample,
                               chunk=3, device="cpu", mesh=mesh,
                               presharded_batch=True)
    p2, _, _, fused = epoch(p2, {}, init_opt(p2), 5, 0)
    out["fused_losses"] = fused
    out.update(flatten("fused", params_to_numpy(p2)))

    # validation means over shards of different sizes, one of them empty
    out["wmean_empty"] = np.asarray(D.pod_weighted_mean(
        1.5 if rank == 0 else 0.0, 3 if rank == 0 else 0))
    out["wmean_exact"] = np.asarray(D.pod_weighted_mean(
        1.0 if rank == 0 else 2.0 ** -30, 1))
    out["wmean_none"] = np.asarray(D.pod_weighted_mean(0.0, 0))

    # the spectrogram U-Net's data-parallel step: batch-norm statistics and
    # dropout masks over the global batch of 4, 2 rows a rank
    from waveunet_tpu_torch.models import spectrogram_unet as su

    ucfg = u7_config()
    ubatch = put_batch_sharded({k[len("u7batch/"):]: inp[k]
                                for k in inp.files
                                if k.startswith("u7batch/")}, mesh)
    keep_all = su.dropout
    for name, drop in (("u7_keep", lambda x, gen, mesh=None: x / 0.5),
                       ("u7_drop", keep_all)):
        su.dropout = drop
        try:
            p = params_from_numpy(unflatten(inp, "u7_params"), "cpu")
            st = params_from_numpy(unflatten(inp, "u7_state"), "cpu")
            init_opt, ustep = make_train_step(ucfg, U7_LR, mesh=mesh)
            p, st, _, loss = ustep(p, st, init_opt(p), ubatch,
                                   torch.Generator().manual_seed(U7_SEED))
        finally:
            su.dropout = keep_all
        out[f"{name}_loss"] = np.asarray(float(loss))
        out.update(flatten(f"{name}_params", params_to_numpy(p)))
        out.update(flatten(f"{name}_state", params_to_numpy(st)))

    # the window-parallel separate() at the JAX sweep tests' config, both
    # wires: chunks of 8 windows, 4 a rank, gathered onto every rank
    for wire in ("float32", "int16"):
        wcfg = get_config("baseline", infer_wire_dtype=wire, **SWEEP)
        wsep = Separator(wcfg, params_from_numpy(
            unflatten(inp, "sweep_params"), "cpu"), mesh=mesh)
        audio = inp["sweep_audio"]
        got = wsep.separate(audio, wcfg.expected_sr)
        for name, v in got.items():
            out[f"mesh_sep_{wire}/{name}"] = v
        out[f"mesh_sep_{wire}_sizes"] = np.asarray(wsep._chunk_sizes(
            len(window_positions(audio.shape[0], wsep.out_len))))

    # window-parallel fp32 BSS-Eval against the same call without a mesh
    refs, ests = inp["bss_refs"], inp["bss_ests"]
    kw = dict(rate=256, filter_len=16, window_batch=2)
    m_mesh = bss_eval_framewise_tpu(refs, ests, mesh=mesh, **kw)
    m_one = bss_eval_framewise_tpu(refs, ests, device="cpu", **kw)
    for k in m_mesh:
        out[f"bss_mesh/{k}"] = m_mesh[k]
        out[f"bss_one/{k}"] = m_one[k]

    # evaluate_musdb on the mesh: separation and fp32 scorer sharded
    from waveunet_tpu_torch.eval.harness import evaluate_musdb
    ecfg = eval_config(os.path.join(workdir, "db"))
    stats = evaluate_musdb(
        ecfg, eval_params(ecfg), mesh=mesh, tpu_bss=True,
        output_path=os.path.join(workdir, "mesh_eval"))
    out["eval_stats"] = np.asarray(stats, np.float64)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


# the spectrogram U-Net of the two-rank step (test_torch_train_step.py's
# U7_SMALL at a global batch of 4) and its dropout generator's seed
U7_SMALL = dict(num_layers=3, num_frames=768 * 7 + 1024,
                num_initial_filters=4, batch_size=4)
U7_SEED = 7
U7_LR = 1e-4
# the JAX package's sweep tests' engine (tests/test_infer.py:322)
SWEEP = dict(num_layers=3, num_frames=256, infer_batch=4,
             infer_num_frames=None, output_type="difference")


def u7_config():
    from waveunet_tpu_torch.config import get_config
    return get_config("unet_spectrogram", **U7_SMALL)


def eval_config(db):
    from waveunet_tpu_torch.config import get_config
    return get_config("baseline", num_layers=2, num_frames=256,
                      num_initial_filters=4, expected_sr=8192, infer_batch=2,
                      musdb_path=db)


def eval_params(cfg):
    from waveunet_tpu_torch.models.waveunet import init_waveunet
    return init_waveunet(torch.Generator().manual_seed(2), cfg, "cpu")


def run_rank(rank, n, workdir):
    """Spawn target: join the group over a file store, run every check,
    write ``rank<r>.npz``; any failure exits 1 with its traceback."""
    try:
        torch.set_num_threads(1)
        import datetime

        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            _checks(rank, n, workdir)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
