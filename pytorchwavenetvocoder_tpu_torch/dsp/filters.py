"""FIR pre-filters.

Same semantics as the reference's ``low_cut_filter`` / ``low_pass_filter``
(`feature_extract.py:33-77`): 255-tap firwin designs, with the low-pass
variant edge-padding and compensating group delay.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import firwin, lfilter


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70) -> np.ndarray:
    """High-pass (low-cut) FIR filter, 255 taps."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    fil = firwin(255, norm_cutoff, pass_zero=False)
    return lfilter(fil, 1, x)


def low_pass_filter(x: np.ndarray, fs: int, cutoff: float = 70,
                    padding: bool = True) -> np.ndarray:
    """Low-pass FIR filter with edge padding and delay compensation."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    numtaps = 255
    fil = firwin(numtaps, norm_cutoff)
    x_pad = np.pad(x, (numtaps, numtaps), "edge")
    lpf_x = lfilter(fil, 1, x_pad)
    return lpf_x[numtaps + numtaps // 2: -numtaps // 2]
