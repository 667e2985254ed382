"""The share of the traced window in which no device operation ran, in
%."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
