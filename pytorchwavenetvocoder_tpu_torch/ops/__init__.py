"""Compute ops: mu-law codec, feature scaling; the kernels live in
``ops/ar_kernel.py`` (AR loop) and ``ops/train_kernel.py`` (layer stack).

The names below are imported at first use: ``ops.scaler`` (numpy) serves
``bin/calc_stats.py`` without importing torch."""

import importlib

_LAZY = {"decode_mu_law": "mulaw", "decode_mu_law_torch": "mulaw",
         "encode_mu_law": "mulaw", "encode_mu_law_torch": "mulaw",
         "StandardScaler": "scaler", "FusedLayerStack": "train_kernel",
         "fused_layer_stack": "train_kernel",
         "fused_train_constraint_error": "train_kernel",
         "supports_fused_train": "train_kernel"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
