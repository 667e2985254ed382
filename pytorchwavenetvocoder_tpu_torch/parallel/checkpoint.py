"""Reading the 3-file model bundle: checkpoint pickle and JSON model.conf.

A checkpoint is the JAX package's ``checkpoint-<iter>.pkl``: a pickle of
``{"model": params, "optimizer": opt_state, "iterations": step}`` whose
trees hold numpy arrays (`parallel/checkpoint.py:34-70` there).  Its
``"optimizer"`` entry pickles optax state classes (``ScaleByAdamState``,
``EmptyState``...), so a plain ``pickle.load`` needs optax and jax.
``load_checkpoint`` unpickles through a restricted ``Unpickler`` instead:
numpy arrays and plain containers load as themselves, optax/jax classes
become the inert ``OpaqueState`` (a tuple of the pickled fields), and any
other class is refused.  Decode reads only ``"model"`` and
``"iterations"``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

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
