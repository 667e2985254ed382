"""Model family: conditional mu-law WaveNet."""

from pytorchwavenetvocoder_tpu_torch.models.wavenet import (  # noqa: F401
    WaveNet,
    WaveNetConfig,
    init_wavenet_params,
    wavenet_forward,
)
