"""The 95th percentile of the step-to-step times on rank 0's device
timeline (a CUDA event after every step), over every step of the
window."""

import numpy as np


def read(run):
    if run["kind"] != "train":
        return None
    return float(np.percentile(run["step_ms"], 95))
