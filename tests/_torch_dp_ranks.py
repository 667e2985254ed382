"""Rank functions for tests/test_torch_parallel.py and tests/test_torch_cuda.py.

``parallel/distributed.py::spawn_local`` starts each rank in a fresh
interpreter that imports its function by name, so the functions live here,
in a module that imports only the port (the ranks never load JAX).
"""

import hashlib

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.convert import (
    adam_moments_to_jax,
    params_from_jax,
    params_to_jax,
)
from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
from pytorchwavenetvocoder_tpu_torch.parallel.distributed import shard_rows
from pytorchwavenetvocoder_tpu_torch.parallel.train import (
    create_train_state,
    make_train_step,
)


def params_digest(params) -> str:
    """A hash of every param's bytes, in order."""
    h = hashlib.sha256()
    for leaves in params.values():
        for t in leaves.values():
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def dp_steps(info, conf: dict, params: dict, batches: list, lr: float,
             weight_decay: float, fused=None) -> dict:
    """Adam steps of ``make_train_step`` on this rank's rows
    (``shard_rows``) of each global batch, from the numpy params tree
    ``params`` on the rank's device: per step the loss, the params (numpy)
    and their digest, and the Adam moments at the end."""
    torch.set_num_threads(1)
    config = WaveNetConfig(**conf)
    state = create_train_state(config, lr=lr, weight_decay=weight_decay,
                               params=params_from_jax(params, info.device))
    step = make_train_step(config, lr=lr, weight_decay=weight_decay,
                           fused=fused, n_devices=info.world)
    out = dict(losses=[], params=[], digests=[])
    for batch in batches:
        state, loss = step(state, *shard_rows(tuple(batch), info.rank,
                                              info.world))
        out["losses"].append(float(loss))
        out["params"].append(params_to_jax(state.params))
        out["digests"].append(params_digest(state.params))
    out["moments"] = adam_moments_to_jax(state.optimizer, state.params)
    out["route"] = step.route
    out["device"] = str(info.device)
    return out


def dp_digests(info, *args) -> dict:
    """``dp_steps`` without the params and moments (small enough to
    return from ranks at wide configs)."""
    return {k: v for k, v in dp_steps(info, *args).items()
            if k not in ("params", "moments")}


def np_tree(params) -> dict:
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in params.items()}
