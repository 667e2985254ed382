"""The share of the traced steps' window in which no device operation ran
on rank 0, in %."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
