"""Rank functions for tests/test_torch_parallel.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_tracing.py and
tests/test_torch_cuda.py.

``parallel/distributed.py::spawn_local`` starts each rank in a fresh
interpreter that imports its function by name, so the functions live here,
in a module that imports only the port (the ranks never load JAX).
"""

import hashlib

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.convert import (
    adam_moments,
    adam_moments_to_jax,
    params_from_jax,
    params_to_jax,
)
from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
    restore_train_state,
)
from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
    all_reduce_mean,
    shard_rows,
)
from pytorchwavenetvocoder_tpu_torch.parallel.mesh import (
    gather_params,
    shard_params,
)
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


def allreduce_spans(info) -> dict:
    """``all_reduce_mean`` of a tensor holding the rank under a CPU
    profiler: the program's spans the profiler saw, and the mean."""
    from torch.profiler import ProfilerActivity, profile

    t = torch.full((3,), float(info.rank))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        all_reduce_mean([t])
    return dict(spans=[e.name for e in prof.events()
                       if e.name.startswith("train.")], value=t.tolist())


def np_tree(params) -> dict:
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in params.items()}


def _replicated_digest(params, grid) -> str:
    """A hash of the bytes of the leaves the model axis does not shard."""
    h = hashlib.sha256()
    for g, leaves in params.items():
        for n, t in leaves.items():
            if (g, n) not in grid.layout:
                h.update(t.detach().contiguous().view(torch.uint8).numpy()
                         .tobytes())
    return h.hexdigest()


def tp_job(info, conf: dict, params: dict, batches: list, lr: float,
           weight_decay: float, mp: int, remat: bool = False,
           resume: str | None = None) -> dict:
    """Adam steps of ``make_train_step(model_parallel=mp)`` on this rank's
    shards (``shard_params`` of the numpy params tree ``params``, or the
    checkpoint ``resume`` restored into them) and on the rows of its data
    index (``Grid.rows``) of each global batch.  Per step: the loss, the
    gathered params (numpy) and a digest of the replicated leaves; the
    first step's gathered gradients; the gathered Adam moments at the end;
    this rank's shard shapes."""
    config = WaveNetConfig(**conf)
    step = make_train_step(config, lr=lr, weight_decay=weight_decay,
                           remat=remat, n_devices=info.world,
                           model_parallel=mp)
    grid = step.grid
    state = create_train_state(config, lr=lr, weight_decay=weight_decay,
                               params=shard_params(params, grid,
                                                   info.device))
    if resume is not None:
        restore_train_state(resume, state, grid)
    out = dict(losses=[], params=[], replicated=[], route=None,
               coords=(grid.data_index, grid.model_index), start=state.step,
               shapes={g: {n: tuple(t.shape) for n, t in leaves.items()}
                       for g, leaves in state.params.items()})
    for i, batch in enumerate(batches):
        state, loss = step(state, *grid.rows(tuple(batch)))
        out["losses"].append(float(loss))
        out["params"].append(params_to_jax(gather_params(state.params, grid)))
        out["replicated"].append(_replicated_digest(state.params, grid))
        if i == 0:
            out["grads"] = params_to_jax(gather_params(
                {g: {n: t.grad for n, t in leaves.items()}
                 for g, leaves in state.params.items()}, grid))
    count, mu, nu = adam_moments(state.optimizer, state.params)
    out["moments"] = dict(count=count, mu=params_to_jax(gather_params(mu,
                                                                      grid)),
                          nu=params_to_jax(gather_params(nu, grid)))
    out["route"] = step.route
    return out


def tp_jobs(info, jobs: dict) -> dict:
    """Run each of ``jobs`` (name -> ``tp_job``'s arguments after ``info``)
    in turn; and ``make_train_step(fused=True, model_parallel=2)``, whose
    refusal message is returned under ``"fused_refusal"``."""
    torch.set_num_threads(1)
    out = {name: tp_job(info, *args) for name, args in jobs.items()}
    try:
        make_train_step(WaveNetConfig(), fused=True, n_devices=info.world,
                        model_parallel=2)
        out["fused_refusal"] = None
    except ValueError as e:
        out["fused_refusal"] = str(e)
    return out
