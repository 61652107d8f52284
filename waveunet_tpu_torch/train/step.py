"""Training and eval steps: loss, Adam, and the fused epoch.

Counterpart of ``waveunet_tpu/train/step.py``. The loss is the JAX
package's: per-source MSE on raw audio averaged over the sources (the
target's tail cropped to an iSTFT output's length), or, for U7a, L1 between
the masked magnitudes and ``|stft|`` of the target's first channel. The
optimiser is optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected), written out as tensor ops (``Adam``) so the
same arithmetic runs eagerly and inside a CUDA graph, and its state carries
to and from optax's through ``compat/params.py``.

A step is one forward and backward through the plain differentiable ops
(cuDNN convs on the card; the hand-written kernels have no backward, and
the JAX package keeps Pallas out of training too), then Adam in place. It
runs inside ``precision_scope(cfg.conv_precision)`` (full fp32 by default)
with cuDNN's deterministic algorithms, so a fused epoch repeats the eager
loop bit for bit.

``make_scanned_epoch`` is the counterpart of ``scan_epoch=True``: on the
card, one step (device sampling, forward, backward, Adam) is captured as a
CUDA graph and replayed; the absolute step lives in a device tensor the
graph increments, and the losses land in a device vector read once a
``scan_chunk``. On the CPU the same function runs the same loop without a
graph.

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank computes the
loss and gradients of its rows of the global batch; one ``all_reduce``
over a flat fp32 buffer of every gradient and the loss gives their mean
over the ranks before Adam, so the ranks' updates are identical, and the
parameters are broadcast from rank 0 once. A world of one is the mesh-free
step bit for bit. Under NCCL the fused epoch captures the all-reduce in
its CUDA graph; gloo collectives cannot be captured, so under gloo it runs
the eager loop. The spectrogram U-Net takes its batch-norm statistics over
the whole sharded batch (a differentiable all-reduce of each rank's sums,
``models/spectrogram_unet.py::_bn_train``) and each rank draws the dropout
masks of the global batch and keeps its rows, so N ranks step as one
process does at the same global batch. Its fused epoch runs the eager loop
on every backend, as it does without a mesh: its dropout generator is
seeded on the host each step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.models.spectrogram_unet import deterministic_cudnn
from waveunet_tpu_torch.models.waveunet import apply_waveunet
from waveunet_tpu_torch.ops.conv import precision_scope
from waveunet_tpu_torch.ops.kernels import capture
from waveunet_tpu_torch.ops.stft import stft_magnitude
from waveunet_tpu_torch.parallel.mesh import (Mesh, all_reduce_,
                                              broadcast_tree_, check_mesh,
                                              put_batch_sharded)

Tree = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]


def make_forward(cfg: Config, mesh: Optional[Mesh] = None) -> Callable:
    """forward(params, state, x, training, generator) -> (outputs, new_state):
    raw audio, or U7a's magnitudes when it trains on the L1 magnitude loss;
    the Wave-U-Net's state is empty. ``mesh``: the spectrogram U-Net trains
    with the global batch's statistics and dropout masks (``x`` is this
    rank's rows)."""
    if cfg.network == "unet":
        def forward(params, state, x, training, generator=None):
            return apply_waveunet(params, cfg, x, training), state
        return forward

    from waveunet_tpu_torch.models.spectrogram_unet import (
        apply_spectrogram_unet)
    return_spec = not cfg.raw_audio_loss

    def forward(params, state, x, training, generator=None):
        return apply_spectrogram_unet(params, cfg, x, training, state,
                                      return_spectrogram=return_spec,
                                      generator=generator,
                                      mesh=mesh if training else None)
    return forward


def make_loss_fn(cfg: Config, training: bool,
                 mesh: Optional[Mesh] = None) -> Callable:
    """loss(params, state, batch, generator) -> (0-d tensor, new_state): the
    loss of ``batch`` (this rank's rows with ``mesh``)."""
    forward = make_forward(cfg, mesh)
    spectro_l1 = cfg.network == "unet_spectrogram" and not cfg.raw_audio_loss

    def loss_fn(params, state, batch, generator=None):
        est, new_state = forward(params, state, batch["mix"], training,
                                 generator)
        total = 0.0
        for name in cfg.source_names:
            target, pred = batch[name], est[name]
            if spectro_l1:
                total = total + torch.mean(
                    torch.abs(stft_magnitude(target[..., 0]) - pred))
            else:
                # an iSTFT output is hop*(F-1)+frame_len <= the input: crop
                # the target's tail to it
                target = target[:, :pred.shape[1], :]
                total = total + torch.mean(torch.square(target - pred))
        return total / cfg.num_sources, new_state

    return loss_fn


class Adam:
    """optax's ``adam`` as tensor ops, in optax's order of operations:

        count += 1
        mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
        p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

    The state is ``{"count": int32 0-d tensor, "mu": tree, "nu": tree}`` on
    the parameters' device; every operation is a device op, so an update is
    capturable in a CUDA graph and the count never leaves the card. The
    learning rate is a constant of the instance, as it is of a jitted step.
    """

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Tree) -> Dict:
        dev = next(iter(next(iter(params.values())).values())).device
        zeros = {layer: {n: torch.zeros_like(t) for n, t in leaves.items()}
                 for layer, leaves in params.items()}
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": zeros,
                "nu": {layer: {n: t.clone() for n, t in leaves.items()}
                       for layer, leaves in zeros.items()}}

    @torch.no_grad()
    def update_(self, params: Tree, grads: Tree, state: Dict) -> None:
        """One Adam step, in place on ``params`` and ``state``."""
        b1, b2 = self.b1, self.b2
        state["count"].add_(1)
        t = state["count"].to(torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for layer, leaves in params.items():
            for n, p in leaves.items():
                g = grads[layer][n]
                mu, nu = state["mu"][layer][n], state["nu"][layer][n]
                mu.copy_((1.0 - b1) * g + b1 * mu)
                nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p.copy_(p + u * (-self.lr))


def make_optimizer(lr: float) -> Adam:
    """Adam with TF1's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return Adam(lr)


def _leaves(tree: Tree) -> List[torch.Tensor]:
    return [t for leaves in tree.values() for t in leaves.values()]


@contextlib.contextmanager
def _step_scope(cfg: Config) -> Iterator[None]:
    """What every training step runs in: the config's conv precision, and
    cuDNN with deterministic algorithms and no autotuning (so a replayed
    graph repeats the eager step bit for bit)."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        with precision_scope(cfg.conv_precision), deterministic_cudnn():
            yield
    finally:
        torch.backends.cudnn.benchmark = prev


def value_and_grad(loss_fn: Callable, params: Tree, state: Tree,
                   batch: Batch, generator=None
                   ) -> Tuple[torch.Tensor, Tree, Tree]:
    """(loss, new_state, grads) with grads keyed like ``params``; every
    parameter must be reached by the loss."""
    leaves = _leaves(params)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        loss, new_state = loss_fn(params, state, batch, generator)
        flat = torch.autograd.grad(loss, leaves)
    it = iter(flat)
    grads = {layer: {n: next(it) for n in leaves_}
             for layer, leaves_ in params.items()}
    return loss.detach(), new_state, grads


def mean_over_ranks(mesh: Mesh, loss: torch.Tensor, grads: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
    """(loss, grads) averaged over the mesh's ranks by one ``all_reduce``
    of a flat fp32 buffer; the values themselves in a world of one."""
    leaves = _leaves(grads)
    flat = torch.cat([g.reshape(-1) for g in leaves] + [loss.reshape(1)])
    flat = all_reduce_(flat, mesh) / mesh.size
    parts = iter(torch.split(flat[:-1], [g.numel() for g in leaves]))
    return flat[-1], {layer: {n: next(parts).view_as(g)
                              for n, g in leaves_.items()}
                      for layer, leaves_ in grads.items()}


def _replicate_once(held: Dict, mesh: Mesh, params: Tree, mstate: Tree,
                    opt_state: Dict) -> None:
    """Broadcast the trees from rank 0 the first time these parameter
    tensors come by."""
    key = tuple(t.data_ptr() for t in _leaves(params))
    if held.get("replicated") != key:
        broadcast_tree_((params, mstate, opt_state), mesh)
        held["replicated"] = key


def _mesh_and_device(mesh, device: DeviceLike
                     ) -> Tuple[Optional[Mesh], torch.device]:
    """The checked mesh and the step's device (the mesh's, when given)."""
    mesh = check_mesh(mesh)
    if mesh is None:
        return None, resolve_device(device)
    return mesh, mesh.device


def train_step(cfg: Config, loss_fn: Callable, tx: Adam, params: Tree,
               mstate: Tree, opt_state: Dict, batch: Batch,
               generator=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One step in place on params, model state and Adam state; returns the
    loss as a device scalar (no host synchronisation). With ``mesh``,
    ``batch`` is this rank's rows, and the loss and gradients are averaged
    over the ranks before Adam."""
    with _step_scope(cfg):
        loss, new_state, grads = value_and_grad(loss_fn, params, mstate,
                                                batch, generator)
        if mesh is not None:
            loss, grads = mean_over_ranks(mesh, loss, grads)
        tx.update_(params, grads, opt_state)
        with torch.no_grad():
            for layer, stats in new_state.items():
                for n, t in stats.items():
                    if mstate[layer][n] is not t:
                        mstate[layer][n].copy_(t)
    return loss


def _check_device(params: Tree, device: torch.device) -> None:
    got = _leaves(params)[0].device
    if got.type != device.type:
        raise ValueError(f"the step was built for {device} and got "
                         f"parameters on {got}")


def make_train_step(cfg: Config, lr: float, device: DeviceLike = None,
                    mesh=None) -> Tuple[Callable, Callable]:
    """(init_opt, step) with ``step(params, state, opt_state, batch,
    generator) -> (params, state, opt_state, loss)``: the returned trees are
    the ones passed in, updated in place. The step runs on ``device`` (the
    CUDA card by default) and refuses parameters elsewhere.

    With ``mesh`` it runs on ``mesh.device``, ``batch`` is this rank's rows
    of the global batch (``put_batch_sharded``), the loss and gradients
    are averaged over the ranks, and the first call for a set of parameter
    tensors broadcasts them (and the model and Adam state) from rank 0."""
    mesh, dev = _mesh_and_device(mesh, device)
    loss_fn = make_loss_fn(cfg, training=True, mesh=mesh)
    tx = make_optimizer(lr)
    held: Dict = {}

    def step(params, mstate, opt_state, batch, generator=None):
        _check_device(params, dev)
        if mesh is not None:
            _replicate_once(held, mesh, params, mstate, opt_state)
        loss = train_step(cfg, loss_fn, tx, params, mstate, opt_state, batch,
                          generator, mesh)
        return params, mstate, opt_state, loss

    return tx.init, step


def step_generator(cfg: Config, step: int,
                   device: torch.device) -> Optional[torch.Generator]:
    """The dropout generator of absolute step ``step`` (U7 only; the
    Wave-U-Net draws nothing): a pure function of (seed, step), so a resumed
    or chunked run draws the same masks."""
    if cfg.network == "unet":
        return None
    seed = (cfg.seed * 1_000_003 + step) % (2 ** 63)
    return torch.Generator(device).manual_seed(seed)


def make_scanned_epoch(cfg: Config, lr: float, n_steps: int,
                       sample_fn: Callable, chunk: Optional[int] = None,
                       device: DeviceLike = None, mesh=None,
                       presharded_batch: bool = False) -> Callable:
    """The fused epoch: ``epoch(params, mstate, opt_state, key, step0) ->
    (params, mstate, opt_state, losses)`` runs ``n_steps`` steps of
    ``sample_fn(key, step_tensor)`` -> train step, in place, and returns the
    losses as numpy.

    The epoch runs on ``device`` (the CUDA card by default) and refuses
    parameters elsewhere. On the card the Wave-U-Net's step is captured as
    a CUDA graph (``ops/kernels.capture``) at the round's first step, which
    runs eagerly as the capture's warm-up, and replayed for every later
    step of this and later epochs. The absolute step lives in a device
    tensor that each step increments; losses go to a device vector read
    once a ``chunk`` steps (``cfg.scan_chunk``), so no step waits for the
    host. U7 draws its dropout masks from a host-seeded generator per step
    and runs the loop eagerly. Chunking and the step it starts from do not
    change the stream.

    With ``mesh`` each step is the data-parallel step of
    ``make_train_step``: ``sample_fn`` gives the global batch and each rank
    takes its rows, or with ``presharded_batch`` (a ``ShardedBank``'s
    ``sample``) this rank's rows already. The graph captures the NCCL
    all-reduce; under gloo, which cannot be captured, the epoch runs the
    eager loop, and the choice is printed.
    """
    mesh, dev = _mesh_and_device(mesh, device)
    use_graph = dev.type == "cuda" and cfg.network == "unet"
    if mesh is not None:
        if use_graph and mesh.backend not in (None, "nccl"):
            use_graph = False
            why = (f"the eager loop: {mesh.backend} collectives cannot be "
                   f"captured in a CUDA graph")
        elif cfg.network != "unet":
            why = (f"the eager loop on {dev}: the spectrogram U-Net's "
                   f"dropout generator is seeded on the host each step")
        else:
            why = ("one CUDA graph a step, the all-reduce captured"
                   if use_graph else f"the eager loop on {dev}")
        print(f"fused epoch over a {mesh.size}-rank mesh "
              f"({mesh.backend or 'no process group'}): {why}")
    loss_fn = make_loss_fn(cfg, training=True, mesh=mesh)
    tx = make_optimizer(lr)
    chunk = chunk if chunk and chunk < n_steps else n_steps
    static: Dict = {}

    def one_step(params, mstate, opt_state, key, generator=None):
        batch = sample_fn(key, static["step"])
        if mesh is not None and not presharded_batch:
            batch = put_batch_sharded(batch, mesh)
        loss = train_step(cfg, loss_fn, tx, params, mstate, opt_state, batch,
                          generator, mesh)
        static["losses"].index_copy_(0, static["slot"].view(1), loss.view(1))
        static["slot"].add_(1)
        static["step"].add_(1)

    def buffers(device):
        if static.get("device") != device:
            static.clear()
            static.update(device=device, graph=None, graph_key=None,
                          step=torch.zeros((), dtype=torch.int64,
                                           device=device),
                          slot=torch.zeros((), dtype=torch.int64,
                                           device=device),
                          losses=torch.zeros((chunk,), device=device))

    def epoch(params, mstate, opt_state, key: int, step0: int):
        _check_device(params, dev)
        device = _leaves(params)[0].device
        buffers(device)
        if mesh is not None:
            _replicate_once(static, mesh, params, mstate, opt_state)
        static["step"].fill_(step0)
        out: List[np.ndarray] = []
        done = 0
        while done < n_steps:
            m = min(chunk, n_steps - done)
            static["slot"].zero_()
            for i in range(m):
                if use_graph:
                    _graph_step(params, mstate, opt_state, key)
                else:
                    one_step(params, mstate, opt_state, key,
                             step_generator(cfg, step0 + done + i, device))
            # one sync a chunk; a copy, since the buffer is reused
            out.append(static["losses"][:m].to("cpu", copy=True).numpy())
            done += m
        return params, mstate, opt_state, np.concatenate(out)

    def _graph_step(params, mstate, opt_state, key):
        tensors = (_leaves(params) + _leaves(mstate) + _leaves(opt_state["mu"])
                   + _leaves(opt_state["nu"]) + [opt_state["count"]])
        graph_key = (key, tuple(t.data_ptr() for t in tensors))
        if static["graph"] is not None and static["graph_key"] == graph_key:
            static["graph"].replay()
            return
        # the capture's eager warm-up is this step; the graph replays the
        # later ones
        static["graph"] = capture(
            lambda: one_step(params, mstate, opt_state, key))
        static["graph_key"] = graph_key

    epoch.graph_state = static  # the captured graph, for inspection
    return epoch


def make_eval_step(cfg: Config, device: DeviceLike = None,
                   mesh=None) -> Callable:
    """eval_step(params, state, batch) -> 0-d loss tensor, in inference mode
    (batch norm on the moving statistics): the kernels' forward on the card
    (the default ``device``), their plain versions on the CPU. With
    ``mesh``, ``batch`` is this rank's rows and the loss is the mean over
    the ranks."""
    mesh = check_mesh(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    loss_fn = make_loss_fn(cfg, training=False)

    def eval_step(params, state, batch):
        _check_device(params, dev)
        with torch.no_grad():
            loss = loss_fn(params, state, batch)[0]
            if mesh is not None:
                loss = all_reduce_(loss.reshape(1).clone(),
                                   mesh)[0] / mesh.size
            return loss

    return eval_step
