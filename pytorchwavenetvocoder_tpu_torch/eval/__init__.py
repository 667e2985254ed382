"""Evaluation metrics: mel-cepstral distortion parity harness."""

from pytorchwavenetvocoder_tpu_torch.eval.mcd import compute_mcd, mcd_from_wavs  # noqa: F401
