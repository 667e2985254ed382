"""The decode path's weight packing in ``models.wavenet`` (the program's
``wavenet.pack`` spans, the outermost where one holds another: the
padding to the kernels' widths, K2's layer weights, K1's pack and its
units), host ms per fleet of the window."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode" or not run["fleets"]:
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            WAVENET_PACK,
        )
    except ImportError:     # a program that records no spans
        return None
    outer: list = []
    for s, e in trace.spans(WAVENET_PACK):
        if s < trace.t0 or e > trace.t1:
            continue
        if outer and s < outer[-1][1]:
            outer[-1][1] = max(outer[-1][1], e)
        else:
            outer.append([s, e])
    if not outer:
        return None
    return 1e-3 * sum(e - s for s, e in outer) / run["fleets"]
