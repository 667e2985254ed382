"""Mu-law companding codec.

Behavioral parity target: reference ``wavenet_vocoder/nets/wavenet.py:17-47``
(numpy encode/decode with ``mu - 1`` compression constant and the
``floor(.. + 0.5)`` rounding rule).  Integer outputs of :func:`encode_mu_law`
are bit-exact vs the reference formula.

Host (numpy) variants feed the data path and the wav writer; the torch
variants run the same formula on a tensor, on whatever device it lies.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_mu_law(x: np.ndarray, mu: int = 256) -> np.ndarray:
    """Encode waveform in [-1, 1] to integer classes ``0 .. mu-1`` (numpy).

    Uses compression constant ``mu - 1`` and round-half-up quantization,
    matching reference semantics (`wavenet.py:17-30`).
    """
    m = mu - 1
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(m)
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int64)


def decode_mu_law(y: np.ndarray, mu: int = 256) -> np.ndarray:
    """Decode integer classes back to waveform in [-1, 1] (numpy).

    Matches reference semantics (`wavenet.py:33-47`).
    """
    m = mu - 1
    fx = (y - 0.5) / m * 2 - 1
    return np.sign(fx) / m * ((1 + m) ** np.abs(fx) - 1)


def encode_mu_law_torch(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Tensor mu-law encode; same formula as the numpy variant.

    Computes in float64 so the integer classes match the host (numpy f64)
    encoder exactly at floor boundaries.
    """
    x = x.to(torch.float64)
    m = float(mu - 1)
    fx = torch.sign(x) * torch.log1p(m * x.abs()) / np.log1p(m)
    return torch.floor((fx + 1.0) / 2.0 * m + 0.5).to(torch.int32)


def decode_mu_law_torch(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Tensor mu-law decode; same formula as the numpy variant (float32)."""
    m = float(mu - 1)
    fx = (y.to(torch.float32) - 0.5) / m * 2.0 - 1.0
    return torch.sign(fx) / m * (torch.pow(1.0 + m, fx.abs()) - 1.0)
