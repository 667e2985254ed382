"""Waveform positions trained in the window over all ranks (ranks x one
window of T positions x steps), over the window's seconds (host clock, to
the loss read after the last step)."""


def read(run):
    if run["kind"] != "train":
        return None
    return (run["chips"] * run["window_positions"] * run["steps"]
            / run["window_s"])
