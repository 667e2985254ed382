"""Checkpoint and model-config reading (multi-GPU is not yet ported)."""

from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_model_conf,
)
