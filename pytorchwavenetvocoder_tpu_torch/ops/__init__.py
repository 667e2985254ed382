"""Compute ops: mu-law codec, feature scaling, the decode kernels."""

from pytorchwavenetvocoder_tpu_torch.ops.mulaw import (  # noqa: F401
    decode_mu_law,
    decode_mu_law_torch,
    encode_mu_law,
    encode_mu_law_torch,
)
from pytorchwavenetvocoder_tpu_torch.ops.scaler import StandardScaler  # noqa: F401
