"""PyTorch + CUDA port of the WaveNet vocoder framework.

A second package beside the JAX reference ``pytorchwavenetvocoder_tpu``:
the same parameter layout, bundle format, decode and training paths, in
PyTorch, with the TPU kernels of those paths rewritten by hand for NVIDIA
Hopper (``csrc/``, built with ``nvcc`` at first use).  It imports nothing
of JAX or of the JAX package.

Layer map:
  CLIs (bin/decode.py, bin/train.py)
  ->  model and train step (models/wavenet.py: warm-up + AR loop, the
      training forward; parallel/train.py: loss, Adam)
  ->  kernels (ops/train_kernel.py, ops/ar_kernel.py; csrc/*.cu)
  ->  host I/O (utils/, data/generator.py, parallel/checkpoint.py)
"""

__version__ = "0.1.0"

from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law, encode_mu_law  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNet, WaveNetConfig  # noqa: F401
