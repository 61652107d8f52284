"""A multi-process dry run of the data-parallel paths on the CPU.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: ``n_devices``
spawned processes, one rank each, joined over gloo on localhost, run at
that function's shrunk ``full`` config (3 layers, 256 frames, 8 filters,
batch 2 a rank) one data-parallel training step, the fused epoch over a
replicated bank sampler, the fused epoch over a ``ShardedBank``, a
window-parallel separation of both model families (the spectrogram U-Net
at inference: its training needs batch statistics over the ranks, which
the port lacks), and the window-parallel fp32 BSS-Eval. Every rank checks
that its results are finite and that its parameters are rank 0's bit for
bit.

    python -m waveunet_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import socket
import sys
import traceback

import numpy as np
import torch

JOIN_TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_on_every_rank(tree, mesh) -> bool:
    """Every tensor of ``tree`` equals rank 0's, bit for bit."""
    from waveunet_tpu_torch.parallel.mesh import all_reduce_, broadcast_

    differ = torch.zeros(1, dtype=torch.int64)
    for leaves in tree.values():
        for t in leaves.values():
            ref = broadcast_(t.detach().clone(), mesh)
            differ += int(not torch.equal(ref, t))
    return int(all_reduce_(differ, mesh)[0]) == 0


def _rank_main(rank: int, n: int, port: int) -> None:
    from waveunet_tpu_torch.config import get_config
    from waveunet_tpu_torch.data.device_cache import ShardedBank, build_sampler
    from waveunet_tpu_torch.eval.bsseval_tpu import bss_eval_framewise_tpu
    from waveunet_tpu_torch.infer.engine import Separator
    from waveunet_tpu_torch.models.waveunet import init_waveunet
    from waveunet_tpu_torch.ops import shapes
    from waveunet_tpu_torch.parallel import distributed as D
    from waveunet_tpu_torch.parallel.mesh import make_mesh, put_batch_sharded
    from waveunet_tpu_torch.train.step import (make_scanned_epoch,
                                               make_train_step)

    torch.set_num_threads(1)
    D.initialize(f"127.0.0.1:{port}", n, rank, device="cpu",
                 timeout_s=JOIN_TIMEOUT_S)
    try:
        mesh = make_mesh((n,), devices=["cpu"])
        cfg = get_config("full", num_layers=3, num_frames=256,
                         num_initial_filters=8, batch_size=2 * n)
        in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
        params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
        init_opt, step = make_train_step(cfg, cfg.init_sup_sep_lr,
                                         mesh=mesh)
        opt_state = init_opt(params)

        rng = np.random.default_rng(0)
        srcs = {s: (0.1 * rng.standard_normal(
            (cfg.batch_size, out_len, cfg.num_channels))).astype(np.float32)
            for s in cfg.source_names}
        pad = (in_len - out_len) // 2
        batch = dict(srcs)
        batch["mix"] = np.pad(sum(srcs.values()),
                              [(0, 0), (pad, pad), (0, 0)])
        params, _, opt_state, loss = step(params, {}, opt_state,
                                          put_batch_sharded(batch, mesh))
        loss = float(loss)
        assert np.isfinite(loss), loss

        # the fused epoch over a replicated bank: each rank its rows
        S = cfg.num_sources
        bank = torch.from_numpy((np.clip(rng.standard_normal(
            (S, 8 * in_len, cfg.num_channels)) * 0.1, -1, 1)
            * 32767).astype(np.int16))
        starts = torch.tensor([0, 4 * in_len])
        valids = torch.tensor([3 * in_len, 3 * in_len])
        sampler = build_sampler(cfg, in_len, out_len, cfg.batch_size,
                                augment=False)

        def sample(key, i):
            return sampler(bank, starts, valids, key, i)

        epoch_fn = make_scanned_epoch(cfg, 1e-4, 3, sample, device="cpu",
                                      mesh=mesh)
        params, _, opt_state, losses = epoch_fn(params, {}, opt_state, 1, 0)
        assert np.all(np.isfinite(losses)), losses

        # the fused epoch over the mesh-sharded bank
        rng2 = np.random.default_rng(1)
        tracks = []
        for i in range(n):
            m = in_len + 200 + 37 * i
            t = {s: (0.1 * rng2.standard_normal((m, cfg.num_channels))
                     ).astype(np.float32) for s in cfg.source_names}
            t["mix"] = np.zeros((m, cfg.num_channels), np.float32)
            tracks.append(t)
        sbank = ShardedBank.from_tracks(cfg, in_len, out_len, mesh, tracks,
                                        batch_size=cfg.batch_size)
        pod_epoch = make_scanned_epoch(cfg, 1e-4, 3, sbank.sample,
                                       device="cpu", mesh=mesh,
                                       presharded_batch=True)
        params, _, opt_state, pod_losses = pod_epoch(params, {}, opt_state,
                                                     3, 3)
        assert np.all(np.isfinite(pod_losses)), pod_losses
        assert _same_on_every_rank(params, mesh), "ranks' params differ"

        # window-parallel separation, both model families
        sep = Separator(cfg.replace(infer_batch=2), params, mesh=mesh)
        audio = (0.1 * rng.standard_normal((out_len * (2 * n) + 17,
                                            cfg.num_channels))
                 ).astype(np.float32)
        for v in sep.separate(audio, cfg.expected_sr).values():
            assert v.shape == audio.shape and np.all(np.isfinite(v))

        from waveunet_tpu_torch.models.spectrogram_unet import (
            init_spectrogram_unet)
        scfg = get_config("unet_spectrogram", num_layers=2,
                          num_frames=768 * 3 + 1024, num_initial_filters=4,
                          infer_batch=1)
        _, s_out = shapes.get_padding(scfg, scfg.num_frames)
        sparams, sstate = init_spectrogram_unet(
            torch.Generator().manual_seed(3), scfg, "cpu")
        s_sep = Separator(scfg, sparams, model_state=sstate, mesh=mesh)
        s_audio = (0.1 * rng.standard_normal((s_out * n + 13, 1))
                   ).astype(np.float32)
        for v in s_sep.separate(s_audio, scfg.expected_sr).values():
            assert v.shape == s_audio.shape and np.all(np.isfinite(v))

        # window-parallel BSS-Eval
        rate = 256
        refs = (0.1 * rng.standard_normal((2, 2 * n * rate, 1))
                ).astype(np.float32)
        ests = (0.9 * refs + 0.05 * rng.standard_normal(refs.shape)
                ).astype(np.float32)
        m = bss_eval_framewise_tpu(refs, ests, rate=rate, filter_len=16,
                                   window_batch=n, mesh=mesh)
        assert np.all(np.isfinite(m["SDR"])), m["SDR"]
        if rank == 0:
            print(f"dryrun_multichip({n}) OK, loss={loss:.6f}, "
                  f"scanned epoch OK, pod sharded-bank scanned epoch OK, "
                  f"ranks identical, inference sweep OK, spectrogram "
                  f"inference OK, sharded BSS-Eval OK", flush=True)
    finally:
        D.shutdown()


def _rank_entry(rank: int, n: int, port: int) -> None:
    try:
        _rank_main(rank, n, port)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run over ``n_devices`` spawned gloo CPU processes; raises
    RuntimeError if a rank fails or does not finish in JOIN_TIMEOUT_S."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, n_devices, port))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {hung} "
                           f"hung, exit codes {codes}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
