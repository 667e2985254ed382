"""The conditioning network's device time per fleet: the device operations
that start while the program's ``wavenet.upsample`` span is open (the MoL
model's ConvTranspose2d stages in a fleet's prep; the device is idle when
the prep begins, so it runs them as the host issues them), in ms over the
window's fleets.  None where the program records no such span."""


def read(run):
    trace = run.get("trace")
    if trace is None or run["kind"] != "decode" or not run["fleets"]:
        return None
    try:
        from pytorchwavenetvocoder_tpu_torch.utils.tracing import (
            WAVENET_UPSAMPLE,
        )
    except ImportError:     # a program that records no such span
        return None
    spans = [(s, e) for s, e in trace.spans(WAVENET_UPSAMPLE)
             if s >= trace.t0 and e <= trace.t1]
    if not spans:
        return None
    sec = sum(e - s for _n, s, e in trace.ops
              if any(a <= s <= b for a, b in spans)) * 1e-6
    return 1e3 * sec / run["fleets"] if sec > 0 else None
