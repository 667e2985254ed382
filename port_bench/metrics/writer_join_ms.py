"""The end of a ``decode_batches`` call in ``bin.decode``: handing the
writer thread its end and joining it, while it writes the last fleet's
wavs (the program's ``decode.writer_join`` spans), host ms per call in the
window."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode":
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            DECODE_WRITER_JOIN,
        )
    except ImportError:     # a program that records no spans
        return None
    spans = [(s, e) for s, e in trace.spans(DECODE_WRITER_JOIN)
             if s >= trace.t0 and e <= trace.t1]
    if not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / len(spans)
