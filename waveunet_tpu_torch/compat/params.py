"""Weights bridge between the JAX package's parameter pytree and the port.

Both packages key parameters the same way (``down_i``, ``bottleneck``,
``interp_i``, ``up_i``, ``out_<src>``, each ``{"kernel", "bias"}`` or
``{"weights"}``) and keep TF layouts (conv kernel ``[width, in, out]``), so
the bridge converts arrays and renames nothing. A JAX pytree becomes numpy
with ``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side;
this module never imports JAX. optax's Adam state (``count``, ``mu``,
``nu``, the moments keyed like the params) crosses the same way, so a JAX
``TrainState`` can go on training in the port.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from waveunet_tpu_torch.device import DeviceLike, resolve_device

NumpyParams = Dict[str, Dict[str, np.ndarray]]
TorchParams = Dict[str, Dict[str, torch.Tensor]]


def params_from_numpy(arrays: Mapping[str, Mapping[str, np.ndarray]],
                      device: DeviceLike = None) -> TorchParams:
    """Nested dict of numpy arrays -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {layer: {name: torch.tensor(np.asarray(a, np.float32), device=dev)
                    for name, a in leaves.items()}
            for layer, leaves in arrays.items()}


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> NumpyParams:
    """Port parameters -> nested dict of float32 numpy arrays on the host."""
    return {layer: {name: t.detach().to("cpu", torch.float32).numpy()
                    for name, t in leaves.items()}
            for layer, leaves in params.items()}


def adam_state_from_numpy(count, mu: Mapping[str, Mapping[str, np.ndarray]],
                          nu: Mapping[str, Mapping[str, np.ndarray]],
                          device: DeviceLike = None) -> Dict:
    """optax's Adam state as numpy (``count``, and ``mu`` and ``nu`` keyed
    like the params) -> the port's ``train/step.py::Adam`` state on
    ``device``. On the JAX side the state is
    ``(ScaleByAdamState(count, mu, nu), EmptyState())``; pass its fields
    through ``np.asarray``."""
    dev = resolve_device(device)
    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                                  device=dev),
            "mu": params_from_numpy(mu, dev),
            "nu": params_from_numpy(nu, dev)}


def adam_state_to_numpy(state: Mapping) -> tuple:
    """The port's Adam state -> ``(count, mu, nu)`` as numpy: an int32
    scalar and two nested dicts of float32 arrays, optax's
    ``ScaleByAdamState`` fields."""
    return (np.asarray(int(state["count"]), np.int32),
            params_to_numpy(state["mu"]), params_to_numpy(state["nu"]))
