"""The gradients' all-reduce (NCCL kernels) per traced step on rank 0's
device."""

from port_bench.kernels import COLLECTIVE, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    sec = trace.op_seconds(matcher(COLLECTIVE))
    return sec * 1e3 / run["traced_steps"] if sec > 0 else None
