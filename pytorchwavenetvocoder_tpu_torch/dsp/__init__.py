"""Digital signal processing, implemented from scratch.

The reference reaches all of its DSP through native dependencies —
WORLD (C++) via sprocket, SPTK (C) via pysptk, and librosa
(`feature_extract.py:15-24`, `noise_shaping.py:16`).  None of those are
available here; this package provides the consumed surfaces:

- spectral:   STFT, mel filterbank, mel-spectrogram (librosa semantics)
- cepstrum:   freqt / mcep / mc2b / b2mc / sp2mc (SPTK surface; UELS mcep)
- harvest:    the published Harvest F0 estimator
- cheaptrick: the published CheapTrick spectral-envelope estimator
- d4c:        the published D4C band-aperiodicity estimator
- f0:         extract_f0 dispatch (harvest default) + continuous-F0 interp
- world:      combined WORLD analysis [uv, cont_f0_lpf, mcep, codeap]
- mlsa:       MLSA noise-shaping filter (pysptk.synthesis surface)
- filters:    FIR high-pass / low-pass (scipy-backed, reference semantics)

Host (numpy/scipy) code, copied from the JAX package's ``dsp`` package with
its imports pointed here.  The device DSP, the counterpart of the JAX
package's ``jax_dsp`` and ``harvest_jax``, is in two submodules that import
torch and are not imported here (the host CLIs start without torch):

- torch_dsp:     STFT, mel-spectrogram, freqt, sp2mc, UELS mcep, MLSA,
                 CheapTrick, D4C and the batched WORLD analysis on a torch
                 device (``feature_extract --device cuda``)
- harvest_torch: Harvest F0's candidate and refinement stages on a torch
                 device (``feature_extract --f0_device torch``)
"""

from pytorchwavenetvocoder_tpu_torch.dsp.filters import (  # noqa: F401
    low_cut_filter,
    low_pass_filter,
)
from pytorchwavenetvocoder_tpu_torch.dsp.spectral import (  # noqa: F401
    mel_filterbank,
    melspectrogram,
    stft,
)
from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import (  # noqa: F401
    b2mc,
    freqt,
    mc2b,
    mcep,
    sp2mc,
    stft_mcep,
)
from pytorchwavenetvocoder_tpu_torch.dsp.f0 import (  # noqa: F401
    convert_to_continuous_f0,
    extract_f0,
)
# Bind the WORLD-algorithm submodules at the package root.  A
# `from .cheaptrick import cheaptrick` would rebind the package
# attribute from the submodule to the function, breaking
# `dsp.cheaptrick.<internal>` access (tests pin the published
# constants that way); the functions live one level down instead:
# dsp.cheaptrick.cheaptrick / dsp.harvest.harvest / dsp.d4c.d4c.
import pytorchwavenetvocoder_tpu_torch.dsp.cheaptrick  # noqa: F401
import pytorchwavenetvocoder_tpu_torch.dsp.d4c  # noqa: F401
import pytorchwavenetvocoder_tpu_torch.dsp.harvest  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.dsp.d4c import n_codeap_bands  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.dsp.world import world_analyze  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.dsp.mlsa import (  # noqa: F401
    mlsa_filter,
    mlsa_impulse_response,
)
