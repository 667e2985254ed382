"""Tensor parallelism: the (data, model) grid of ranks.

Counterpart of the ``model`` axis of ``pytorchwavenetvocoder_tpu/parallel/
mesh.py``.  Where the JAX package lays a ``(data, model)`` mesh over the
devices of one program and lets XLA place the collectives, the port runs
one process per device (``parallel/distributed.py``) and places them by
hand:

- the grid is JAX's ``devices.reshape(n // mp, mp)``: rank r has data
  index ``r // mp`` and model index ``r % mp``, so a model group is ``mp``
  consecutive ranks; ``make_grid`` builds the model and data subgroups;
- ``model_pspec`` is a copy of JAX's ``_model_pspec``: which dimension of a
  param leaf (or of its Adam moments) the model axis shards, or None
  (replicated).  The gate's dilated conv is row-parallel (its input R
  sharded), the causal, skip and res products column-parallel (their
  outputs sharded), post1 row-parallel over the sharded skip sum; a leaf
  whose dimension the model size does not divide stays replicated;
- ``shard_params`` / ``gather_params`` carry a full params tree to this
  rank's shards and back (they extend ``convert.py::params_from_jax`` and
  ``params_to_jax``);
- ``Grid.sum`` (a sum over the model group in the forward, the identity in
  the backward) closes a row-parallel product; ``Grid.sum_grad`` (the
  identity in the forward, a sum in the backward) opens a column-parallel
  product on a replicated input.

The training forward (``models/wavenet.py::wavenet_forward(..., tp=grid)``)
and step (``parallel/train.py::make_train_step(model_parallel=mp)``) use
them; the fused kernels stay one-device programs, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
    rank,
    shard_rows,
    world_size,
)

# (group, name) -> (the leaf's ndim, the dimension the model axis shards)
_RULES = {
    ("causal", "w"): (3, 2),   # (k, Q, R): output columns
    ("dil", "w"): (4, 2),      # (L, k, R, 2R): rows, the input R
    ("skip", "w"): (3, 2),     # (L, R, S): output columns
    ("res", "w"): (3, 2),      # (L, R, R): output columns
    ("post1", "w"): (2, 0),    # (S, S): rows, over the sharded skip sum
    ("skip", "b"): (2, 1),     # (L, S): follows the column output
    ("res", "b"): (2, 1),      # (L, R): follows the column output
}


def model_pspec(group: str, name: str, shape, mp: int) -> int | None:
    """The dimension of the param leaf ``group.name`` of full ``shape`` that a
    model axis of size ``mp`` shards, or None where the leaf is replicated:
    JAX ``parallel/mesh.py::_model_pspec`` (a leaf without a rule, or whose
    dimension ``mp`` does not divide, replicates; so does every leaf at
    ``mp == 1``).  Adam's moments follow their leaf."""
    rule = _RULES.get((group, name))
    if mp <= 1 or rule is None:
        return None
    ndim, dim = rule
    if len(shape) == ndim and shape[dim] % mp == 0:
        return dim
    return None


class _SumOverModel(torch.autograd.Function):
    """Sum over the model group in the forward; the identity backward (the
    summed value feeds replicated work, whose gradient every rank holds)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumGradOverModel(torch.autograd.Function):
    """The identity forward; a sum over the model group in the backward (a
    replicated input of a column-parallel product: each rank's gradient
    covers its own columns only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx, op=dist.ReduceOp.SUM, group=ctx.group)
        return dx, None


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid and the shards it holds.

    ``layout`` maps ``(group, name)`` to the dimension the model axis shards
    (``model_pspec`` on the full shapes); a leaf not in it is replicated.
    ``model_group`` / ``data_group`` are the ``torch.distributed`` groups
    of the ranks sharing this rank's data index / model index."""

    mp: int
    n_data: int
    data_index: int
    model_index: int
    layout: dict
    model_group: Any
    data_group: Any

    @property
    def split_r(self) -> bool:
        """The residual width is sharded (causal, dil, res leaves)."""
        return ("res", "w") in self.layout

    @property
    def split_s(self) -> bool:
        """The skip width is sharded (skip, post1 leaves)."""
        return ("skip", "w") in self.layout

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOverModel.apply(x, self.model_group)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        return _SumGradOverModel.apply(x, self.model_group)

    def part(self, x, dim: int):
        """This rank's block of ``x`` (a tensor or an array) along ``dim``."""
        n = x.shape[dim] // self.mp
        idx = [slice(None)] * len(x.shape)
        idx[dim] = slice(self.model_index * n, (self.model_index + 1) * n)
        return x[tuple(idx)]

    def local(self, group: str, name: str, x):
        """This rank's shard of the full leaf (or moment) ``group.name``."""
        dim = self.layout.get((group, name))
        return x if dim is None else self.part(x, dim)

    def fan_out(self, g: torch.Tensor):
        """The gate output ``g`` (replicated) as the input of the res and of
        the skip product: through ``sum_grad`` where that product's columns
        are sharded, once where both are."""
        if self.split_r and self.split_s:
            g = self.sum_grad(g)
            return g, g
        return (self.sum_grad(g) if self.split_r else g,
                self.sum_grad(g) if self.split_s else g)

    def rows(self, batch):
        """This rank's rows of a global batch: those of its data index (the
        ranks of one model group take the same rows)."""
        return shard_rows(batch, self.data_index, self.n_data)


def grid_coords(rank_: int, mp: int) -> tuple[int, int]:
    """(data index, model index) of ``rank_`` on a model axis of ``mp``."""
    return rank_ // mp, rank_ % mp


def make_grid(config, model_parallel: int) -> Grid:
    """The grid of this process group with model groups of
    ``model_parallel`` ranks, for the params of ``config``.  Every rank of
    the group calls it (``new_group`` is collective: each rank creates every
    group, in the same order).  Raises where ``model_parallel`` does not
    divide the group's size."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import param_shapes

    world, me = world_size(), rank()
    mp = model_parallel
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel={mp} must divide the {world} "
                         "rank(s) of the process group")
    n_data = world // mp
    data_index, model_index = grid_coords(me, mp)
    layout = {(g, n): dim for g, leaves in param_shapes(config).items()
              for n, shape in leaves.items()
              if (dim := model_pspec(g, n, shape, mp)) is not None}
    model_group = data_group = None
    if dist.is_initialized():
        for d in range(n_data):
            grp = dist.new_group(list(range(d * mp, (d + 1) * mp)))
            if d == data_index:
                model_group = grp
        for m in range(mp):
            grp = dist.new_group(list(range(m, world, mp)))
            if m == model_index:
                data_group = grp
    return Grid(mp, n_data, data_index, model_index, layout, model_group,
                data_group)


def shard_params(tree: dict, grid: Grid, device="cpu") -> dict:
    """A full params tree (numpy arrays, as a checkpoint's ``"model"`` entry,
    or tensors) -> this rank's shards as the port's params: contiguous
    tensors on ``device``."""

    def shard(g, n, v):
        if isinstance(v, torch.Tensor):
            return grid.local(g, n, v.detach()).contiguous().clone().to(device)
        return torch.as_tensor(np.array(grid.local(g, n, np.asarray(v)),
                                        copy=True), device=device)

    return {g: {n: shard(g, n, v) for n, v in leaves.items()}
            for g, leaves in tree.items()}


def gather_params(params: dict, grid: Grid) -> dict:
    """The inverse of ``shard_params`` over the model group: every sharded
    leaf's blocks gathered in model-index order (``all_gather``, a
    collective of the model group), the replicated leaves as they are.
    Works on any params-shaped tree of tensors (Adam's moments too)."""
    out = {}
    for g, leaves in params.items():
        out[g] = {}
        for n, t in leaves.items():
            dim = grid.layout.get((g, n))
            if dim is None:
                out[g][n] = t.detach()
                continue
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(grid.mp)]
            dist.all_gather(parts, t, group=grid.model_group)
            out[g][n] = torch.cat(parts, dim=dim)
    return out


def sliced_replicated(grid: Grid) -> list:
    """The replicated leaves each rank uses a slice of: their gradients are
    zero outside the slice, so the step sums them over the model group.
    ``causal.b`` (replicated in ``model_pspec``) is added to the causal
    product's sharded columns."""
    return [("causal", "b")] if grid.split_r else []
