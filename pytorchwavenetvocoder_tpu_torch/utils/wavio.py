"""WAV file I/O.

The reference reads/writes wavs through ``soundfile`` (libsndfile) and
``scipy.io.wavfile``.  libsndfile is not available here, so this module
provides the two consumed surfaces on top of ``scipy.io.wavfile``:

- ``read_wav(path, dtype="float32")`` — like ``soundfile.read``: returns
  ``(data, fs)`` with int16 PCM scaled to [-1, 1) when a float dtype is
  requested (reference ``bin/train.py:121``).
- ``write_wav(path, data, fs, subtype="PCM_16")`` — like
  ``soundfile.write`` with PCM_16: scales float input by 32768 with
  clipping to [-32768, 32767] (libsndfile PCM_16 semantics, reference
  ``bin/decode.py:318-319``); int16 input is written as-is (reference
  ``bin/noise_shaping.py:87``).
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path: str, dtype: str = "float32"):
    """Read a wav file; returns (data, fs)."""
    fs, data = wavfile.read(path)
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        if data.dtype == np.int16:
            data = data.astype(dtype) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(dtype) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(dtype) - 128.0) / 128.0
        else:
            data = data.astype(dtype)
    else:
        data = data.astype(dtype)
    return data, fs


def write_wav(path: str, data: np.ndarray, fs: int) -> None:
    """Write a wav file as 16-bit PCM.

    Float input scales by 32768 (clipped to int16 range), matching
    libsndfile PCM_16 semantics and making float round-trips through
    read_wav symmetric.
    """
    data = np.asarray(data)
    if np.issubdtype(data.dtype, np.floating):
        data = np.clip(np.rint(data * 32768.0), -32768, 32767).astype(np.int16)
    elif data.dtype != np.int16:
        data = data.astype(np.int16)
    wavfile.write(path, fs, data)
