"""The training step's copies of the batch to the device in
``parallel.train`` (the program's ``train.batch_in`` spans), host ms per
traced step on rank 0: from pageable memory the copy waits for the
device's queue to drain."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train" or not run["traced_steps"]:
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            TRAIN_BATCH_IN,
        )
    except ImportError:     # a program that records no spans
        return None
    spans = [(s, e) for s, e in trace.spans(TRAIN_BATCH_IN)
             if s >= trace.t0 and e <= trace.t1]
    if not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / run["traced_steps"]
