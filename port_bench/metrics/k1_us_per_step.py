"""K1's device time in the window over the AR steps it ran (each fleet
runs its longest utterance's steps)."""

from port_bench.kernels import K1, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    sec = trace.op_seconds(matcher(K1))
    return sec * 1e6 / run["ar_steps"] if sec > 0 else None
