"""Training loop: epochs, early-stopped rounds, checkpoints, resume.

Counterpart of the single-process path of ``waveunet_tpu/train/loop.py``:

  * ``train_one_epoch``: ``epoch_it`` eager steps over a batch iterator (the
    device bank's, or the host pipeline's);
    ``train_one_epoch_scanned``: the fused epoch over the device bank
    (``train/step.py::make_scanned_epoch``; CUDA graph replays on the card);
  * ``evaluate``: the running-mean validation loss over one deterministic
    pass (the device ``EvalBank``'s sweep through the hand-written kernels
    on the card, or the host pipeline's eval batches);
  * ``optimise``: two rounds, the second at twice the batch and lr 1e-5,
    each stopped after ``worse_epochs`` epochs without a better validation
    loss; a checkpoint every epoch (written in the background), the
    ``best.txt`` marker behind it, and the test loss of the best checkpoint
    at the end. Adam's slots carry across the round boundary and across a
    resume, as the reference restores every variable.

The entry points run on the CUDA card unless given ``device="cpu"``.
Multi-GPU training is not ported: a ``mesh`` or an initialised process
group of more than one process raises.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.data.pipeline import BatchPipeline
from waveunet_tpu_torch.device import (DeviceLike, refuse_multi_gpu,
                                       resolve_device)
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.train import checkpoint as ckpt
from waveunet_tpu_torch.train.metrics import MetricLogger
from waveunet_tpu_torch.train.step import (make_eval_step, make_optimizer,
                                           make_scanned_epoch,
                                           make_train_step, step_generator)


@dataclass
class TrainState:
    params: Any
    model_state: Any  # batch-norm moving statistics ({} for the Wave-U-Net)
    opt_state: Any    # train/step.py::Adam state
    step: int

    def as_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "model_state": self.model_state,
                "opt_state": self.opt_state, "step": self.step}


def num_params(params) -> int:
    return sum(t.numel() for leaves in params.values()
               for t in leaves.values())


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def make_train_source(cfg: Config, in_len: int, out_len: int,
                      seed_offset: int = 0, device: DeviceLike = None):
    """(bank, None) with the device-resident bank when it fits, else
    (None, the host pipeline's prefetched batches)."""
    dev = resolve_device(device)
    if cfg.device_data:
        try:
            from waveunet_tpu_torch.data.device_cache import DeviceBank
            bank = DeviceBank(cfg, "train", in_len, out_len,
                              max_bytes=cfg.device_data_max_bytes, device=dev)
            print(f"Training from device-resident bank: {bank.n_songs} "
                  f"songs, {bank.nbytes() / 1e6:.0f} MB on {dev}")
            return bank, None
        except (FileNotFoundError, ValueError) as e:
            print(f"Device bank unavailable ({e}); using host pipeline")
    pipe = BatchPipeline(cfg, "train", in_len, out_len,
                         seed=cfg.seed + seed_offset)
    return None, pipe.prefetched(pipe.train_batches())


def make_eval_source(cfg: Config, partition: str, in_len: int, out_len: int,
                     batch_size: Optional[int] = None,
                     device: DeviceLike = None):
    """The device-resident ``EvalBank`` when it fits, else None (the caller
    takes the host pipeline)."""
    dev = resolve_device(device)
    if cfg.device_data:
        try:
            from waveunet_tpu_torch.data.device_cache import EvalBank
            bank = EvalBank(cfg, partition, in_len, out_len,
                            batch_size=batch_size or cfg.batch_size,
                            max_bytes=cfg.device_data_max_bytes, device=dev)
            print(f"Evaluating {partition!r} from device-resident bank: "
                  f"{bank.n_windows} windows, {bank.nbytes() / 1e6:.0f} MB "
                  f"on {dev}")
            return bank
        except (FileNotFoundError, ValueError) as e:
            print(f"Device eval bank unavailable ({e}); using host pipeline")
    return None


def init_state(cfg: Config, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> TrainState:
    """Fresh parameters from ``generator`` (a CPU generator seeded with
    ``cfg.seed`` by default), zero Adam slots, step 0, on ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(cfg.seed)
    if cfg.network == "unet":
        from waveunet_tpu_torch.models.waveunet import init_waveunet
        params, model_state = init_waveunet(gen, cfg, dev), {}
    else:
        from waveunet_tpu_torch.models.spectrogram_unet import (
            init_spectrogram_unet)
        params, model_state = init_spectrogram_unet(gen, cfg, dev)
    opt_state = make_optimizer(cfg.init_sup_sep_lr).init(params)
    return TrainState(params, model_state, opt_state, 0)


def _device_batch(batch, device: torch.device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_one_epoch(cfg: Config, state: TrainState, step_fn,
                    batches: Iterator[Dict[str, Any]],
                    logger: Optional[MetricLogger] = None
                    ) -> Tuple[TrainState, float]:
    """``cfg.epoch_it`` eager steps. The step of absolute index s uses the
    batch ``next(batches)`` and, for U7, the dropout generator of s."""
    params, mstate, opt_state = state.params, state.model_state, state.opt_state
    device = next(iter(next(iter(params.values())).values())).device
    losses = []
    t0 = time.time()
    for it in range(cfg.epoch_it):
        batch = _device_batch(next(batches), device)
        gen = step_generator(cfg, state.step + it, device)
        params, mstate, opt_state, loss = step_fn(params, mstate, opt_state,
                                                  batch, gen)
        if logger is not None and (it % 50 == 0 or it == cfg.epoch_it - 1):
            logger.log(state.step + it, sep_loss=float(loss))
        losses.append(loss)
    mean_loss = float(torch.stack(losses).cpu().numpy().mean())
    dt = time.time() - t0
    if logger is not None:
        logger.log(state.step + cfg.epoch_it, epoch_mean_loss=mean_loss,
                   steps_per_sec=cfg.epoch_it / dt)
    return TrainState(params, mstate, opt_state,
                      state.step + cfg.epoch_it), mean_loss


def train_one_epoch_scanned(cfg: Config, state: TrainState, epoch_fn,
                            key: int, logger: Optional[MetricLogger] = None
                            ) -> Tuple[TrainState, float]:
    """The fused epoch from ``state.step``; logs at the eager loop's points
    (every 50th step and the last)."""
    t0 = time.time()
    params, mstate, opt_state, losses = epoch_fn(
        state.params, state.model_state, state.opt_state, key, state.step)
    dt = time.time() - t0
    if logger is not None:
        its = list(range(0, cfg.epoch_it, 50))
        if cfg.epoch_it - 1 not in its:
            its.append(cfg.epoch_it - 1)
        for it in its:
            logger.log(state.step + it, sep_loss=float(losses[it]))
        logger.log(state.step + cfg.epoch_it,
                   epoch_mean_loss=float(losses.mean()),
                   steps_per_sec=cfg.epoch_it / dt)
    return TrainState(params, mstate, opt_state,
                      state.step + cfg.epoch_it), float(losses.mean())


def evaluate(cfg: Config, params, model_state, eval_step,
             batches: Iterator[Dict[str, Any]]) -> float:
    """Running-mean loss over one deterministic pass of host batches; inf
    when there is no full batch (0 would pass for a perfect score)."""
    device = next(iter(next(iter(params.values())).values())).device
    total, n = 0.0, 0
    for batch in batches:
        loss = float(eval_step(params, model_state,
                               _device_batch(batch, device)))
        n += 1
        total += (loss - total) / n
    if n == 0:
        print("WARNING: evaluation produced no batches; returning inf")
        return float("inf")
    return total


def optimise(cfg: Config, experiment_id: Optional[str] = None, mesh=None,
             resume_path: Optional[str] = None,
             max_epochs_per_round: Optional[int] = None,
             device: DeviceLike = None) -> Tuple[str, float]:
    """Two early-stopped rounds of training; returns (best checkpoint path,
    test loss of the best checkpoint)."""
    refuse_multi_gpu(mesh)
    dev = resolve_device(device)
    if experiment_id is None:
        experiment_id = str(np.random.randint(0, 1_000_000))
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    logger = MetricLogger(cfg.log_dir, experiment_id)
    with open(os.path.join(logger.dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    state = init_state(cfg, device=dev)
    print(f"Sep_Vars: {num_params(state.params)}")
    if resume_path:
        r = _to(ckpt.restore_checkpoint(resume_path), dev)
        state = TrainState(r["params"], r["model_state"], r["opt_state"],
                           int(r["step"]))

    best_loss = float("inf")
    best_path = None
    epoch = 0
    round_cfgs = [cfg, cfg.replace(batch_size=cfg.batch_size * 2,
                                   init_sup_sep_lr=1e-5)]
    bank = None
    valid_bank = None
    valid_bank_tried = False
    for rnd, rcfg in enumerate(round_cfgs):
        if rnd == 1:
            print("Finished first round of training, entering fine-tuning "
                  "stage")
        # The Adam state carries over: only the learning rate changes.
        _, step_fn = make_train_step(rcfg, rcfg.init_sup_sep_lr, device=dev)
        eval_step = make_eval_step(rcfg, device=dev)
        epoch_fn = None
        train_it = None
        key = rcfg.seed + rnd
        if bank is None:
            bank, train_it = make_train_source(rcfg, in_len, out_len,
                                               seed_offset=rnd, device=dev)
        else:
            # the round-1 bank: only the batch changes, nothing uploads again
            bank.set_batch(rcfg.batch_size)
        if bank is not None and cfg.scan_epoch:
            epoch_fn = make_scanned_epoch(rcfg, rcfg.init_sup_sep_lr,
                                          rcfg.epoch_it, bank.sample,
                                          chunk=rcfg.scan_chunk, device=dev)
        elif bank is not None:
            # from the absolute step, the fused epoch's stream
            train_it = bank.batches(key, start=state.step)

        if not valid_bank_tried:
            valid_bank = make_eval_source(rcfg, "valid", in_len, out_len,
                                          batch_size=rcfg.batch_size,
                                          device=dev)
            valid_bank_tried = True
        elif valid_bank is not None:
            valid_bank.set_batch(rcfg.batch_size)

        worse = 0
        epochs_this_round = 0
        while worse < rcfg.worse_epochs:
            if (max_epochs_per_round is not None
                    and epochs_this_round >= max_epochs_per_round):
                break
            print(f"EPOCH: {epoch}")
            t_ep = time.time()
            if epoch_fn is not None:
                state, train_loss = train_one_epoch_scanned(
                    rcfg, state, epoch_fn, key, logger)
            else:
                state, train_loss = train_one_epoch(rcfg, state, step_fn,
                                                    train_it, logger)
            t_train = time.time()
            path = ckpt.save_checkpoint_async(
                cfg.model_base_dir, experiment_id, state.step,
                state.as_dict(), prune_keep=cfg.keep_checkpoints,
                protect=(best_path,))
            t_ckpt = time.time()
            if valid_bank is not None:
                curr = valid_bank.evaluate(state.params, state.model_state)
            else:
                valid_pipe = BatchPipeline(rcfg, "valid", in_len, out_len,
                                           seed=rcfg.seed)
                curr = evaluate(rcfg, state.params, state.model_state,
                                eval_step, valid_pipe.eval_batches())
            t_valid = time.time()
            print(f"epoch {epoch} wall: train {t_train - t_ep:.1f}s | "
                  f"checkpoint {t_ckpt - t_train:.1f}s | "
                  f"valid {t_valid - t_ckpt:.1f}s | "
                  f"total {t_valid - t_ep:.1f}s")
            logger.log(state.step, valid_loss=curr,
                       epoch_wall_s=t_valid - t_ep,
                       valid_wall_s=t_valid - t_ckpt,
                       checkpoint_wall_s=t_ckpt - t_train)
            epoch += 1
            epochs_this_round += 1
            if curr < best_loss:
                print(f"Validation improved {best_loss} -> {curr}")
                best_loss, best_path, worse = curr, path, 0
                marker = os.path.join(cfg.model_base_dir, str(experiment_id),
                                      "best.txt")

                def _write_marker(marker=marker, path=path):
                    with open(marker, "w") as f:
                        f.write(path + "\n")

                # behind the write of `path`: a reader of the marker never
                # finds a directory still being written
                ckpt.after_saves(_write_marker)
            else:
                worse += 1
                print(f"Validation worsened to {curr}")

    print(f"TRAINING FINISHED - testing best model {best_path}")
    ckpt.wait_for_saves()
    if best_path is not None:
        r = _to(ckpt.restore_checkpoint(best_path), dev)
        params, model_state = r["params"], r["model_state"]
    else:
        params, model_state = state.params, state.model_state
    test_bank = make_eval_source(cfg, "test", in_len, out_len,
                                 batch_size=cfg.batch_size, device=dev)
    if test_bank is not None:
        test_loss = test_bank.evaluate(params, model_state)
    else:
        test_pipe = BatchPipeline(cfg, "test", in_len, out_len, seed=cfg.seed)
        test_loss = evaluate(cfg, params, model_state,
                             make_eval_step(cfg, device=dev),
                             test_pipe.eval_batches())
    logger.log(state.step, test_loss=test_loss)
    logger.close()
    return best_path or "", test_loss
