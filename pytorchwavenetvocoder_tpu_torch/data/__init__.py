"""Host-side batch generators for decoding."""

from pytorchwavenetvocoder_tpu_torch.data.generator import decode_generator  # noqa: F401
