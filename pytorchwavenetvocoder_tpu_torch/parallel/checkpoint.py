"""The 3-file model bundle: checkpoint pickle and JSON model.conf.

A checkpoint is the JAX package's ``checkpoint-<iter>.pkl``: a pickle of
``{"model": params, "optimizer": opt_state, "iterations": step}`` whose
trees hold numpy arrays (`parallel/checkpoint.py:34-70` there).  One bundle
serves both packages:

- reading: a JAX checkpoint's ``"optimizer"`` entry pickles optax state
  classes (``ScaleByAdamState``, ``EmptyState``...), so a plain
  ``pickle.load`` needs optax and jax.  ``load_checkpoint`` unpickles
  through a restricted ``Unpickler`` instead: numpy arrays and plain
  containers load as themselves, optax/jax classes become the inert
  ``OpaqueState`` (a tuple of the pickled fields), and any other class is
  refused.  ``restore_train_state`` finds the Adam state among them by its
  pickled class and reads ``(count, mu, nu)`` by position;
- writing: ``save_checkpoint`` writes ``"model"`` as the JAX params tree of
  numpy arrays and ``"optimizer"`` as ``{"adam_moments": {"count", "mu",
  "nu"}}`` with params-shaped trees, the form the JAX
  ``restore_train_state`` grafts onto its own optax state.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import re
from typing import Any

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.parallel.distributed import barrier, rank

#: Module roots whose classes load as ``OpaqueState``.
_OPAQUE_ROOTS = ("optax", "jax", "jaxlib", "flax", "chex")
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice",
             "range", "object"}


class OpaqueState(tuple):
    """Stand-in for an optax/jax state class in a checkpoint: keeps the
    pickled fields as a tuple and does nothing else."""

    pickled_class = ""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root == "numpy" or (module, name) == ("collections", "OrderedDict"):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if root in _OPAQUE_ROOTS:
            return type(name, (OpaqueState,),
                        {"pickled_class": f"{module}.{name}"})
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which the restricted "
            "unpickler does not load")


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint payload dict (see the module docstring)."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def load_model_conf(path: str) -> dict[str, Any]:
    """Read model.conf (JSON); ``path`` may be its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.conf")
    with open(path) as f:
        return json.load(f)


def save_checkpoint(checkpoint_dir: str, state, iterations: int | None = None,
                    final: bool = False, grid=None) -> str:
    """Write ``checkpoint-<iter>.pkl`` (or ``checkpoint-final.pkl``) from a
    ``parallel.train.TrainState``.

    Atomic: the payload goes to a tmp file in the same directory, is
    fsynced and then ``os.replace``d, so a preemption mid-write never leaves
    a truncated pickle under the final name.  A final checkpoint gets an
    ``.iter`` sidecar with its iteration count, which
    ``find_latest_checkpoint`` reads without unpickling the payload.

    In a process group only rank 0 writes, and every rank waits at a
    barrier until the file is in place; every rank returns the path.
    Without a tensor-parallel ``grid`` (``parallel/mesh.py``) the ranks hold
    the same state; with one, the ranks of data index 0 first gather the
    params and both Adam moments over their model group
    (``mesh.gather_params``), so the file is the one a single process
    would write.
    """
    from pytorchwavenetvocoder_tpu_torch.convert import adam_moments

    if iterations is None:
        iterations = int(state.step)
    name = "checkpoint-final.pkl" if final else f"checkpoint-{iterations}.pkl"
    path = os.path.join(checkpoint_dir, name)
    params = state.params
    moments = None
    if grid is None or grid.data_index == 0:
        moments = adam_moments(state.optimizer, params)
    if grid is not None and grid.data_index == 0:
        from pytorchwavenetvocoder_tpu_torch.parallel.mesh import (
            gather_params,
        )

        count, mu, nu = moments
        params = gather_params(params, grid)
        moments = (count, gather_params(mu, grid), gather_params(nu, grid))
    if rank() == 0:
        _write_checkpoint(path, params, moments, iterations, final)
    barrier()
    return path


def _write_checkpoint(path: str, params, moments, iterations: int,
                      final: bool) -> None:
    from pytorchwavenetvocoder_tpu_torch.convert import params_to_jax

    count, mu, nu = moments
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "model": params_to_jax(params),
        "optimizer": {"adam_moments": {"count": np.asarray(count, np.int32),
                                       "mu": params_to_jax(mu),
                                       "nu": params_to_jax(nu)}},
        "iterations": int(iterations),
    }
    tmp = path + ".tmp"
    if final and os.path.exists(path + ".iter"):
        # drop the stale sidecar first so a crash between the two renames
        # cannot pair an old iteration count with the new payload
        os.remove(path + ".iter")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if final:
        iter_tmp = path + ".iter.tmp"
        with open(iter_tmp, "w") as f:
            f.write(str(int(iterations)))
        os.replace(iter_tmp, path + ".iter")
    logging.info("%d-iter checkpoint created.", iterations)


def _find_adam_state(opt):
    """The pickled optax ``ScaleByAdamState`` in a JAX optimizer state (an
    ``OpaqueState``, fields by position: count, mu, nu), or None."""
    if (isinstance(opt, OpaqueState)
            and type(opt).pickled_class.endswith(".ScaleByAdamState")):
        return opt
    if isinstance(opt, (tuple, list)):
        for element in opt:
            found = _find_adam_state(element)
            if found is not None:
                return found
    return None


def restore_train_state(path: str, state, grid=None):
    """Restore params, Adam moments and step from ``path`` into a
    ``parallel.train.TrainState`` of the same model (in place; returns it).

    ``payload["optimizer"]`` may be ``{"adam_moments": {count, mu, nu}}``
    (this package's checkpoints, or the JAX ``convert_checkpoint``'s), a
    JAX optax state (its ``ScaleByAdamState`` is read by position), or
    None (the optimizer stays fresh).  With a tensor-parallel ``grid`` the
    state holds this rank's shards: the full tree is read and the params
    and moments are cut to them (``Grid.local``).
    """
    from pytorchwavenetvocoder_tpu_torch.convert import (
        adam_moments_from_jax,
        param_leaves,
    )

    def local(tree):
        if grid is None:
            return tree
        return {g: {n: grid.local(g, n, np.asarray(v))
                    for n, v in leaves.items()}
                for g, leaves in tree.items()}

    payload = load_checkpoint(path)
    model = local(payload["model"])
    with torch.no_grad():
        for g, n, t in param_leaves(state.params):
            t.copy_(torch.as_tensor(np.asarray(model[g][n])))
    opt = payload.get("optimizer")
    moments = None
    if isinstance(opt, dict) and "adam_moments" in opt:
        m = opt["adam_moments"]
        moments = (m["count"], m["mu"], m["nu"])
    elif opt is not None:
        moments = _find_adam_state(opt)
        if moments is None:
            raise ValueError(f"{path}: no Adam state in its optimizer entry")
    if moments is not None:
        count, mu, nu = moments[:3]
        adam_moments_from_jax(state.optimizer, state.params, count, local(mu),
                              local(nu))
        logging.info("restored Adam moments (count=%d).", int(np.asarray(count)))
    state.step = int(payload["iterations"])
    return state


def _is_loadable(path: str) -> bool:
    """True iff ``path`` unpickles cleanly.  Writes are atomic, so this
    only trips on damaged storage or a writer without the tmp + replace."""
    try:
        load_checkpoint(path)
        return True
    except Exception:
        logging.warning("skipping unreadable checkpoint %s", path)
        return False


def find_latest_checkpoint(checkpoint_dir: str) -> str | None:
    """The newest *loadable* checkpoint path in ``checkpoint_dir``, if any.

    ``checkpoint-final.pkl`` counts as newest when its stored iteration is
    >= every numbered checkpoint's (a completed short run relaunched by a
    preemption-recovery loop must not restart from scratch).  Truncated or
    otherwise unpicklable files, numbered or final, are skipped, so
    ``--resume latest`` lands on the newest good checkpoint.
    """
    numbered = []
    for p in glob.glob(os.path.join(checkpoint_dir, "checkpoint-*.pkl")):
        m = re.search(r"checkpoint-(\d+)\.pkl$", p)
        if m:
            numbered.append((int(m.group(1)), p))
    numbered.sort(reverse=True)
    best, best_it = None, -1
    for it, p in numbered:      # newest first; probe until one loads
        if _is_loadable(p):
            best, best_it = p, it
            break
    final = os.path.join(checkpoint_dir, "checkpoint-final.pkl")
    if os.path.exists(final):
        try:
            if os.path.exists(final + ".iter"):      # cheap sidecar
                with open(final + ".iter") as f:
                    final_it = int(f.read().strip())
            else:
                final_it = int(load_checkpoint(final)["iterations"])
            if final_it >= best_it and _is_loadable(final):
                return final
        except (OSError, ValueError, KeyError, pickle.UnpicklingError,
                EOFError):
            pass    # an unreadable final checkpoint: use the numbered ones
    return best


def save_model_conf(expdir: str, conf: dict[str, Any]) -> str:
    """Write model.conf (JSON) next to the checkpoints: rank 0 writes, the
    ranks of a process group meet at a barrier after it."""
    path = os.path.join(expdir, "model.conf")
    if rank() == 0:
        os.makedirs(expdir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(conf, f, indent=2, sort_keys=True, default=str)
    barrier()
    return path
