"""Bridges into and out of the port: JAX params pytrees, Adam moments and
JSON model configs.

The port keeps the JAX package's parameter layout (see
``models/wavenet.py``), so a JAX params pytree maps onto the port's params
dict key for key, shape for shape, value for value, and back.  The Adam
moments move the same way: a checkpoint holds them as params-shaped
``mu``/``nu`` trees with a step ``count`` (the form the JAX
``restore_train_state`` grafts onto its optax state), and torch's Adam
holds them per parameter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.models.wavenet import Params, WaveNetConfig


def param_leaves(params: Params) -> list:
    """``(group, name, tensor)`` for every leaf, in the params dict's order:
    the order the port's optimizer holds them in."""
    return [(g, n, t) for g, leaves in params.items() for n, t in leaves.items()]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def params_from_jax(tree: dict, device="cpu") -> Params:
    """A JAX params pytree (nested dict of numpy arrays, as a checkpoint's
    ``"model"`` entry holds it) -> the port's params dict of torch tensors:
    same keys, shapes, dtypes and values."""
    return {group: {name: torch.as_tensor(np.array(v, copy=True),
                                          device=device)
                    for name, v in leaves.items()}
            for group, leaves in tree.items()}


def params_to_jax(params: Params) -> dict:
    """The port's params -> a JAX params pytree of numpy arrays (the inverse
    of ``params_from_jax``): a checkpoint's ``"model"`` entry."""
    return {group: {name: _to_numpy(t) for name, t in leaves.items()}
            for group, leaves in params.items()}


def adam_moments_to_jax(optimizer: torch.optim.Optimizer,
                        params: Params) -> dict:
    """torch Adam's per-parameter state -> ``{"count", "mu", "nu"}`` with
    params-shaped numpy trees (zeros and count 0 before the first step)."""
    mu: dict = {}
    nu: dict = {}
    count = 0
    for g, n, p in param_leaves(params):
        s = optimizer.state.get(p, {})
        if s:
            count = int(s["step"])
        mu.setdefault(g, {})[n] = _to_numpy(s["exp_avg"] if s
                                            else torch.zeros_like(p))
        nu.setdefault(g, {})[n] = _to_numpy(s["exp_avg_sq"] if s
                                            else torch.zeros_like(p))
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def adam_moments_from_jax(optimizer: torch.optim.Optimizer, params: Params,
                          count, mu: dict, nu: dict) -> None:
    """Load params-shaped ``mu``/``nu`` trees and the step ``count`` into a
    torch Adam built over ``params`` (``parallel/train.py::make_optimizer``).
    """
    state = {}
    for i, (g, n, p) in enumerate(param_leaves(params)):
        state[i] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.as_tensor(np.asarray(mu[g][n]), dtype=p.dtype,
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu[g][n]),
                                          dtype=p.dtype, device=p.device),
        }
    optimizer.load_state_dict(
        {"state": state,
         "param_groups": optimizer.state_dict()["param_groups"]})


def config_from_json_conf(conf: dict) -> WaveNetConfig:
    """Build a WaveNetConfig from the framework's JSON model.conf.

    The JSON keeps the pipeline's frame factor in ``upsampling_factor``
    with ``use_upsampling_layer`` holding the on/off switch; the config
    encodes "off" as factor 0 (`convert.py:194-207` of the JAX package).
    """
    config = WaveNetConfig.from_dict(conf)
    if not conf.get("use_upsampling_layer", True):
        config = dataclasses.replace(config, upsampling_factor=0)
    return config
