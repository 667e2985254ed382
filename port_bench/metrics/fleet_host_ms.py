"""A fleet's wall time in ``models.wavenet`` (the benchmark's span around
each ``batch_fast_generate`` call) less the device's busy time inside it,
the mean over the window's fleets."""

from port_bench.decode_cell import FLEET_SPAN


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    spans = trace.spans(FLEET_SPAN)
    if not spans:
        return None
    host = [(e - s) * 1e-6 - trace.busy_s(s, e) for s, e in spans]
    return 1e3 * sum(host) / len(host)
