"""K2 (training mode) and K3's share of their roofline: the least time of
their work (``bounds.stack_train_bound_s`` + ``stack_bwd_bound_s``, one
window a rank) over their device time, on rank 0, in %."""

from port_bench.bounds import stack_bwd_bound_s, stack_train_bound_s
from port_bench.kernels import STACK, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    sec = trace.op_seconds(matcher(STACK))
    if sec <= 0:
        return None
    T, cfg = run["window_positions"], run["config"]
    need = stack_train_bound_s(cfg, 1, T) + stack_bwd_bound_s(cfg, 1, T)
    return 100.0 * need * run["traced_steps"] / sec
