"""The model's operations in the traced steps (``bounds.
train_flops_per_position`` x T x ranks, at the configuration's own
widths) over the traced window's seconds, the cards and their bf16 peak,
in %."""

from port_bench.bounds import BF16_FLOPS, train_flops_per_position


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train":
        return None
    flops = (train_flops_per_position(run["config"]) * run["window_positions"]
             * run["chips"] * run["traced_steps"])
    return 100.0 * flops / (trace.window_s * run["chips"] * BF16_FLOPS)
