"""Audio samples of the utterances delivered in the window, over the
window's seconds (host clock, to the last decode call's return)."""


def read(run):
    if run["kind"] != "decode":
        return None
    return run["samples"] / run["window_s"]
