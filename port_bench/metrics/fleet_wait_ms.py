"""The wait in ``bin.decode`` for the next fleet (the program's
``decode.next_fleet`` spans around the prefetch queue's ``next``), host
ms per fleet of the window."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode" or not run["fleets"]:
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            DECODE_NEXT_FLEET,
        )
    except ImportError:     # a program that records no spans
        return None
    spans = [(s, e) for s, e in trace.spans(DECODE_NEXT_FLEET)
             if s >= trace.t0 and e <= trace.t1]
    if not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / run["fleets"]
