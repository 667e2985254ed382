"""K1's share of its roofline: the least time its fleets' work needs
(``bounds.ar_bound_s``, counted over the row-steps the utterances need,
int8 where the traffic decodes int8), over K1's device time in the
window, in %."""

from port_bench.bounds import ar_bound_s
from port_bench.kernels import K1, matcher


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    sec = trace.op_seconds(matcher(K1))
    if sec <= 0:
        return None
    need = sum(ar_bound_s(run["config"], n, quantize=run["quantize"])
               for n in run["lengths"])
    return 100.0 * need / sec
