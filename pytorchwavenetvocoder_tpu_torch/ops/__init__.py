"""Compute ops: mu-law codec, feature scaling; the kernels live in
``ops/ar_kernel.py`` (AR loop) and ``ops/train_kernel.py`` (layer stack)."""

from pytorchwavenetvocoder_tpu_torch.ops.mulaw import (  # noqa: F401
    decode_mu_law,
    decode_mu_law_torch,
    encode_mu_law,
    encode_mu_law_torch,
)
from pytorchwavenetvocoder_tpu_torch.ops.scaler import StandardScaler  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (  # noqa: F401
    FusedLayerStack,
    fused_layer_stack,
    fused_train_constraint_error,
    supports_fused_train,
)
