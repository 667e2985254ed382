"""K2 in training mode and K3 (the fused layer stack's forward and
backward): their device time per traced step on rank 0."""

from port_bench.kernels import STACK, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    sec = trace.op_seconds(matcher(STACK))
    return sec * 1e3 / run["traced_steps"] if sec > 0 else None
