"""Every other device operation of the step (the embed, upsampling, post
stack, loss, Adam, copies), less the layer stack and the collectives:
device time per traced step on rank 0."""

from port_bench.kernels import COLLECTIVE, STACK, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    stack, coll = matcher(STACK), matcher(COLLECTIVE)
    sec = trace.op_seconds(lambda n: not stack(n) and not coll(n))
    return sec * 1e3 / run["traced_steps"]
