"""The warm-up's layer-stack kernel (K2 over the receptive field) per
fleet: its device time in the window over the fleets."""

from port_bench.kernels import STACK, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    sec = trace.op_seconds(matcher(STACK))
    return sec * 1e3 / run["fleets"] if sec > 0 else None
