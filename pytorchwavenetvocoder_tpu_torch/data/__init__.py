"""Host-side batch generators for training and decoding."""

from pytorchwavenetvocoder_tpu_torch.data.generator import (  # noqa: F401
    decode_generator,
    train_generator,
    validate_length,
)
