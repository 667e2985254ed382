"""The plain model's operations for the samples the window delivered
(``bounds.decode_flops_per_sample``, at the configuration's own widths)
over the window's seconds and the card's bf16 peak, in %."""

from port_bench.bounds import BF16_FLOPS, decode_flops_per_sample


def read(run):
    if run.get("trace") is None or run["kind"] != "decode":
        return None
    flops = decode_flops_per_sample(run["config"]) * run["samples"]
    return 100.0 * flops / (run["window_s"] * run["chips"] * BF16_FLOPS)
