"""PyTorch + CUDA port of the WaveNet vocoder framework.

A second package beside the JAX reference ``pytorchwavenetvocoder_tpu``:
the same parameter layout, bundle format, decode and training paths, in
PyTorch, with the TPU kernels of those paths rewritten by hand for NVIDIA
Hopper (``csrc/``, built with ``nvcc`` at first use).  It imports nothing
of JAX or of the JAX package.

Layer map:
  CLIs (bin/decode.py, bin/train.py; the host preprocessing and scoring
      CLIs bin/feature_extract.py, calc_stats.py, noise_shaping.py,
      eval_mcd.py)
  ->  model and train step (models/wavenet.py: warm-up + AR loop, the
      training forward; parallel/train.py: loss, Adam)
  ->  kernels (ops/train_kernel.py, ops/ar_kernel.py; csrc/*.cu)
  ->  host I/O and DSP (utils/, data/generator.py, parallel/checkpoint.py;
      dsp/, eval/, native.py)

The package's names below are imported at first use, so the host CLIs,
which need no torch, start without importing it (each recipe stage is a
process of its own).
"""

import importlib

__version__ = "0.1.0"

_LAZY = {"decode_mu_law": "ops.mulaw", "encode_mu_law": "ops.mulaw",
         "WaveNet": "models.wavenet", "WaveNetConfig": "models.wavenet"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
