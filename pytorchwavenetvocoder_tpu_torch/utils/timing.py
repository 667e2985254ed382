"""Frame-rate to sample-rate timing helpers."""

from __future__ import annotations

import numpy as np


def extend_time(feats: np.ndarray, upsampling_factor: int) -> np.ndarray:
    """Replicate each frame ``upsampling_factor`` times along time.

    (T, D) -> (T * upsampling_factor, D).  Used on the
    ``use_upsampling_layer=false`` path (reference ``utils/utils.py:220-242``).
    """
    feats = np.asarray(feats)
    return np.repeat(feats, upsampling_factor, axis=0).astype(np.float32)
