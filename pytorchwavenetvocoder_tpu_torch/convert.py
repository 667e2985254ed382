"""Bridges into the port: JAX params pytrees and JSON model configs.

The port keeps the JAX package's parameter layout (see
``models/wavenet.py``), so a JAX params pytree maps onto the port's params
dict key for key, shape for shape, value for value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.models.wavenet import Params, WaveNetConfig


def params_from_jax(tree: dict, device="cpu") -> Params:
    """A JAX params pytree (nested dict of numpy arrays, as a checkpoint's
    ``"model"`` entry holds it) -> the port's params dict of torch tensors:
    same keys, shapes, dtypes and values."""
    return {group: {name: torch.as_tensor(np.array(v, copy=True),
                                          device=device)
                    for name, v in leaves.items()}
            for group, leaves in tree.items()}


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
