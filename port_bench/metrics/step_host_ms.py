"""The training step's host time in ``parallel.train`` but its batch
copies (the program's ``train.step`` spans less their ``train.batch_in``
spans: issuing the forward, backward, all-reduce and Adam), host ms per
traced step on rank 0."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "train" or not run["traced_steps"]:
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            TRAIN_BATCH_IN,
            TRAIN_STEP,
        )
    except ImportError:     # a program that records no spans
        return None

    def total(name):
        spans = [(s, e) for s, e in trace.spans(name)
                 if s >= trace.t0 and e <= trace.t1]
        return sum(e - s for s, e in spans), len(spans)

    (step, n_step), (copy, _n) = total(TRAIN_STEP), total(TRAIN_BATCH_IN)
    if not n_step:
        return None
    return 1e-3 * (step - copy) / run["traced_steps"]
