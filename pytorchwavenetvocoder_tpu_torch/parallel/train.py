"""The training step, on one device, or data- and tensor-parallel over ranks.

Counterpart of ``pytorchwavenetvocoder_tpu/parallel/train.py`` (reference
training inner loop, `train.py:527-539`): Adam and a cross-entropy with the
first ``receptive_field`` positions masked out of the loss
(`train.py:534-536`), weight decay as torch-Adam L2 on the gradient.  The
layer stack runs through the fused CUDA training kernels
(``ops/train_kernel.py::FusedLayerStack``) or the plain PyTorch forward
with autograd.  In a process group (``parallel/distributed.py``, one rank
per device) each rank takes the gradient of its rows and the ranks average
the gradients before the optimizer step, as the JAX step's ``pmean`` over
the ``data`` axis.  With ``model_parallel > 1`` the ranks form JAX's
(data, model) grid (``parallel/mesh.py``): each holds its model index's
shards of the params and Adam moments and runs the plain forward tensor
parallel over its model group.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.convert import param_leaves
from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    Params,
    WaveNetConfig,
    init_wavenet_params,
    wavenet_forward,
)
from pytorchwavenetvocoder_tpu_torch.utils import tracing


@dataclasses.dataclass
class TrainState:
    """Everything the optimizer step mutates: the params (leaf tensors that
    require grad), the optimizer over them, and the step count."""

    params: Params
    optimizer: torch.optim.Optimizer
    step: int


def make_optimizer(params: Params, lr: float = 1e-4,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam over the params in ``param_leaves`` order, with weight decay as
    L2 on the gradient (torch Adam semantics, `train.py:457-460`): the same
    update as optax ``add_decayed_weights`` then ``adam``, eps 1e-8 outside
    the square root in both."""
    return torch.optim.Adam([t for _g, _n, t in param_leaves(params)], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_train_state(config: WaveNetConfig, lr: float = 1e-4,
                       weight_decay: float = 0.0,
                       params: Params | None = None,
                       generator: torch.Generator | None = None,
                       device="cpu") -> TrainState:
    """A fresh state: ``params`` (default: ``init_wavenet_params`` from
    ``generator`` on ``device``) made leaf tensors that require grad, and
    a fresh optimizer."""
    if params is None:
        params = init_wavenet_params(config, generator, device)
    for _g, _n, t in param_leaves(params):
        t.requires_grad_(True)
    return TrainState(params=params,
                      optimizer=make_optimizer(params, lr, weight_decay),
                      step=0)


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   receptive_field: int) -> torch.Tensor:
    """Mean cross-entropy over positions >= receptive_field.

    The reference slices ``[:, receptive_field:]`` before the loss
    (`train.py:534-536`); masking keeps the shape.  Negative targets mark
    padding (the utterance-mode trainer pads windows to length buckets)
    and are excluded from the mean; an all-masked batch gives 0.
    """
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    pos = torch.arange(targets.shape[1], device=targets.device)
    mask = ((pos[None, :] >= receptive_field) & (targets >= 0)).to(ce.dtype)
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)


def dropout_masks(config: WaveNetConfig, shape, seed: int, rank: int,
                  step: int, device) -> list | None:
    """The L dropout masks of training step ``step`` on data rank ``rank``
    (None where ``config.dropout`` is 0): each ``keep / (1 - p)`` with
    ``keep = torch.rand(shape) >= p``, drawn layer by layer from a
    ``torch.Generator`` on ``device`` seeded from (seed, rank, step)
    through ``np.random.SeedSequence``, so that a check can draw them
    again."""
    p = config.dropout
    if not p:
        return None
    state = np.random.SeedSequence([seed, rank, step]).generate_state(
        1, np.uint64)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(state[0]))
    return [(torch.rand(shape, generator=gen, device=device) >= p).float()
            / (1.0 - p) for _ in range(config.n_layers)]


def masked_mol_loss(y: torch.Tensor, targets: torch.Tensor,
                    config: WaveNetConfig,
                    receptive_field: int) -> torch.Tensor:
    """The MoL model's mean negative log-likelihood over positions >=
    receptive_field (r9y9's masked mixture loss)."""
    from pytorchwavenetvocoder_tpu_torch.models.mol import mol_loss

    pos = torch.arange(targets.shape[1], device=targets.device)
    mask = (pos[None, :] >= receptive_field).expand_as(targets)
    dt = torch.promote_types(y.dtype, torch.float32)
    return mol_loss(y.to(dt), targets.to(dt), config.n_mix,
                    config.n_quantize, config.log_scale_min, mask)


def make_train_step(config: WaveNetConfig, lr: float = 1e-4,
                    weight_decay: float = 0.0, remat: bool = False,
                    bf16_intermediates: bool | None = None,
                    fused: bool | None = None, n_devices: int = 1,
                    model_parallel: int = 1,
                    dropout_seed: int = 0) -> Callable:
    """Build ``step_fn(state, batch_x, batch_h, batch_t) -> (state, loss)``.

    The batch (numpy or tensors) moves to the params' device; the state is
    updated in place and returned; ``loss`` is a 0-dim tensor on the
    device (reading it synchronizes).  The step sets the optimizer's lr and
    weight decay to ``lr``/``weight_decay``.

    ``remat`` recomputes the residual layers in the backward (plain path
    only).  ``bf16_intermediates`` (default: on for bf16 configs)
    materializes the plain path's layer matmul outputs in bf16.  ``fused``
    routes the layer stack through the fused training kernels
    (``FusedLayerStack``); the default (None) picks it when the params are
    on a CUDA device, the config is bf16 and ``supports_fused_train``
    holds, as the JAX package does for its TPU backend.  ``step_fn.route``
    names the route of the last step ("fused" or "plain"); a change of
    route is logged.

    Data parallel: in a process group (``torch.distributed`` initialized,
    one rank per device, each with its own rows of the global batch) the
    step averages every param gradient over the ranks
    (``all_reduce_mean``, in ``param_leaves`` order, the loss in the same
    bucket) between the backward and ``opt.step()``, so every rank applies
    the same update; the loss returned is the mean of the ranks' losses
    (the JAX step's ``pmean``).  ``n_devices`` must equal the group's size
    (1 outside a group), which is data x model.

    Tensor parallel: ``model_parallel`` > 1 ranks per model group, which
    must divide the group's size (JAX ``make_mesh``), build the grid
    (``mesh.make_grid``, collective: every rank calls this function), kept
    as ``step_fn.grid`` (None at 1).  The state holds this rank's shards
    (``mesh.shard_params``); the ranks of a model group take the same rows
    (``Grid.rows``).  The route is the plain one (``fused=None``), and
    ``fused=True`` raises, as in JAX.  After the backward the gradients of
    the replicated leaves used as a slice (``causal.b``) are summed over
    the model group, then every gradient and the loss are averaged over
    the data group only; Adam runs on the shards (elementwise: the full
    update's shards).

    The mixture-of-logistics model (``config.mol``): float samples in and
    as targets, its likelihood (``models/mol.py::mol_loss``, span
    ``train.loss``) over the positions from the receptive field on, and
    each layer's conv input dropped out at ``config.dropout`` with the masks
    of ``dropout_masks`` (from ``dropout_seed``, the rank and the step).  It
    trains on the plain route: ``fused=True`` raises, as it does for a
    mu-law model with dropout (``train_kernel.py::fused_model_error``).
    """
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        all_reduce_mean,
        world_size,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.mesh import (
        make_grid,
        sliced_replicated,
    )

    if n_devices != world_size():
        raise ValueError(
            f"n_devices={n_devices}, but this process is in a group of "
            f"{world_size()} rank(s): data parallelism runs one rank per "
            "device (bin/train.py --n_devices, torchrun, or "
            "parallel/distributed.py::spawn_local)")
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the "
                         f"{n_devices} device(s) (data x model)")
    if fused:
        from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
            fused_model_error,
        )

        why = fused_model_error(config)
        if why is not None:
            raise ValueError(f"fused=True: {why} (--fused false or auto)")
    if model_parallel > 1 and fused:
        # the fused kernels are one-device programs: the model axis would
        # leave their gradients divergent across it
        raise ValueError(
            f"fused=True requires a model axis of 1 (got model_parallel="
            f"{model_parallel}): tensor parallelism runs the plain route")
    grid = make_grid(config, model_parallel) if model_parallel > 1 else None
    data_parallel = torch.distributed.is_initialized()
    rank = torch.distributed.get_rank() if data_parallel else 0
    rf = config.receptive_field
    if bf16_intermediates is None:
        bf16_intermediates = config.dtype == torch.bfloat16

    def use_fused(device: torch.device, T: int) -> bool:
        if fused is not None:
            return fused
        if grid is not None:
            return False
        from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
            supports_fused_train,
        )

        return (device.type == "cuda" and config.dtype == torch.bfloat16
                and supports_fused_train(config, T))

    def step_fn(state: TrainState, batch_x, batch_h, batch_t):
        with tracing.span(tracing.TRAIN_STEP):
            device = state.params["causal"]["w"].device
            with tracing.span(tracing.TRAIN_BATCH_IN):
                bx = torch.as_tensor(batch_x, device=device)
                bh = torch.as_tensor(batch_h, device=device)
                bt = torch.as_tensor(batch_t, device=device)
                bx, bt = ((bx.float(), bt.float()) if config.mol
                          else (bx.long(), bt.long()))
            on_fused = use_fused(device, bx.shape[1])
            route = "fused" if on_fused else "plain"
            if route != step_fn.route:
                logging.info("train step route: %s (device %s, compute_dtype "
                             "%s, fused=%s)", route, device,
                             config.compute_dtype,
                             "auto" if fused is None else fused)
                step_fn.route = route
            opt = state.optimizer
            for group in opt.param_groups:
                group["lr"] = lr
                group["weight_decay"] = weight_decay
            opt.zero_grad(set_to_none=True)
            with tracing.span(tracing.TRAIN_FORWARD):
                # the fused route takes no masks (fused_model_error)
                masks = None if on_fused else dropout_masks(
                    config, (bx.shape[0], bx.shape[1], config.n_resch),
                    dropout_seed, rank, state.step, device)
                logits = wavenet_forward(state.params, config, bx, bh,
                                         remat=remat and not on_fused,
                                         bf16_intermediates=bf16_intermediates,
                                         fused=on_fused, tp=grid,
                                         dropout_masks=masks)
                if config.mol:
                    with tracing.span(tracing.TRAIN_LOSS):
                        loss = masked_mol_loss(logits, bt, config, rf)
                else:
                    loss = masked_ce_loss(logits, bt, rf)
            with tracing.span(tracing.TRAIN_BACKWARD):
                loss.backward()
            loss = loss.detach()
            if data_parallel:
                leaves = [t for _g, _n, t in param_leaves(state.params)]
                for t in leaves:
                    if t.grad is None:
                        t.grad = torch.zeros_like(t)
                loss = loss.clone()
                if grid is None:
                    all_reduce_mean([t.grad for t in leaves] + [loss])
                else:
                    for g, n in sliced_replicated(grid):
                        torch.distributed.all_reduce(
                            state.params[g][n].grad, group=grid.model_group)
                    if grid.n_data > 1:
                        all_reduce_mean([t.grad for t in leaves] + [loss],
                                        group=grid.data_group)
            with tracing.span(tracing.TRAIN_ADAM):
                opt.step()
            state.step += 1
            return state, loss

    step_fn.route = None
    step_fn.grid = grid
    return step_fn
