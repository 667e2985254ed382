"""The port's spans and counters on the CPU: the decode and training spans
land in a ``torch.profiler`` trace in the order the work runs, the AR
loop's row-step counters count rows x the longest and the utterances'
samples, a profiler changes no value, and with none attached a span is
a flag check."""

import contextlib
import json
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_dp_ranks import allreduce_spans
from pytorchwavenetvocoder_tpu_torch.bin.decode import (
    decode_batches,
    decode_counters,
)
from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetConfig,
)
from pytorchwavenetvocoder_tpu_torch.parallel import distributed as D
from pytorchwavenetvocoder_tpu_torch.parallel.train import (
    create_train_state,
    make_train_step,
)
from pytorchwavenetvocoder_tpu_torch.utils import tracing

torch.set_num_threads(2)

CONF = dict(n_quantize=256, n_aux=4, n_resch=16, n_skipch=16,
            dilation_depth=3, dilation_repeat=1, kernel_size=2,
            upsampling_factor=4, compute_dtype="float32")
#: every span name the program records
NAMES = {v for k, v in vars(tracing).items() if k.isupper() and "_" in k
         and isinstance(v, str)}


def _model():
    return WaveNet(WaveNetConfig(**CONF),
                   generator=torch.Generator().manual_seed(0))


def _fleet(lengths, seed, tag):
    """A fleet of utterances ``tag``0.. of ``lengths`` samples: seed ids
    and frame-rate aux that cover them."""
    rng = np.random.RandomState(seed)
    B, up = len(lengths), CONF["upsampling_factor"]
    x = np.full((B, 1), 128, np.int32)
    h = rng.randn(B, -(-max(lengths) // up) + 1,
                  CONF["n_aux"]).astype(np.float32)
    return [f"{tag}{b}" for b in range(B)], (x, h, list(lengths))


def _spans(prof, tmp_path):
    """(start, end, name) of the program's spans in the exported trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e["name"] in NAMES)


def _decode(model, outdir, mode="argmax", seed=5):
    fleets = [_fleet([7, 13, 4], 1, "a"), _fleet([9, 5], 2, "b")]
    return decode_batches(model, iter(fleets), str(outdir), mode=mode,
                          impl="plain",
                          generator=torch.Generator().manual_seed(seed))


def test_decode_spans_follow_the_fleets(tmp_path):
    model = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _decode(model, tmp_path / "wav")
    assert len(res["batches"]) == 2
    spans = _spans(prof, tmp_path)
    fleet = [tracing.DECODE_NEXT_FLEET, tracing.WAVENET_PREP,
             tracing.WAVENET_WARMUP, tracing.WAVENET_AR_LOOP,
             tracing.WAVENET_COPY_OUT]
    # the plain path packs no weights; the last wait finds the end
    assert [n for _s, _e, n in spans] == 2 * fleet + [
        tracing.DECODE_NEXT_FLEET, tracing.DECODE_WRITER_JOIN]
    for (_s0, e0, _n0), (s1, _e1, _n1) in zip(spans, spans[1:]):
        assert e0 <= s1          # one after another, none inside another


@pytest.mark.parametrize("chunk, run", [(None, 3 * 9), (1, 5 + 9 + 3)])
def test_row_step_counters(chunk, run, monkeypatch):
    if chunk is None:
        monkeypatch.delenv("WNV_DECODE_FLEET_CHUNK", raising=False)
    else:
        monkeypatch.setenv("WNV_DECODE_FLEET_CHUNK", str(chunk))
    model = _model()
    _ids, (x, h, n) = _fleet([5, 9, 3], 3, "c")
    before = decode_counters()
    out = model.batch_fast_generate(x, h, n, mode="argmax", impl="plain")
    after = decode_counters()
    assert [len(o) for o in out] == [5, 9, 3]
    got = {k: after[k] - before[k] for k in after}
    assert got == dict(ar_persistent=0, ar_persistent_int8=0,
                       layer_stack_fwd=0, row_steps=run,
                       useful_row_steps=17, k1_waits=0, k1_waits_ready=0,
                       mol_clamped=0)


def _train_setup():
    cfg = WaveNetConfig(**dict(CONF, upsampling_factor=0))
    state = create_train_state(cfg, lr=1e-3,
                               generator=torch.Generator().manual_seed(0))
    step = make_train_step(cfg, lr=1e-3, fused=False)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 40)).astype(np.int32)
    h = rng.randn(2, 40, CONF["n_aux"]).astype(np.float32)
    t = rng.randint(0, 256, (2, 40)).astype(np.int32)
    return state, step, (x, h, t)


def test_train_step_spans_hold_the_phases(tmp_path):
    state, step, batch = _train_setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *batch)
    spans = _spans(prof, tmp_path)
    assert [n for _s, _e, n in spans] == [
        tracing.TRAIN_STEP, tracing.TRAIN_BATCH_IN, tracing.TRAIN_FORWARD,
        tracing.TRAIN_BACKWARD, tracing.TRAIN_ADAM]
    (s0, e0, _), inner = spans[0], spans[1:]
    assert all(s0 <= s and e <= e0 for s, e, _n in inner)
    for (_s, e, _n), (s1, _e1, _n1) in zip(inner, inner[1:]):
        assert e <= s1


def _traced(fn, on: bool):
    with (profile(activities=[ProfilerActivity.CPU]) if on
          else contextlib.nullcontext()):
        return fn()


def _decoded(tmp_path, on: bool):
    model, out = _model(), tmp_path / ("on" if on else "off")
    _traced(lambda: _decode(model, out, mode="sampling"), on)
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


def _trained(_tmp_path, on: bool):
    state, step, batch = _train_setup()

    def steps():
        return [float(step(state, *batch)[1]) for _ in range(2)]
    losses = _traced(steps, on)
    return losses, [t.detach().clone() for g in state.params.values()
                    for t in g.values()]


@pytest.mark.parametrize("run", [_decoded, _trained])
def test_a_profiler_changes_no_value(run, tmp_path):
    off, on = run(tmp_path, False), run(tmp_path, True)
    if run is _decoded:
        assert len(off) == 5 and off == on
    else:
        assert off[0] == on[0]
        assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))


def test_span_off_records_nothing_and_costs_a_nullcontext():
    assert not torch._C._autograd._profiler_enabled()
    off = tracing.span(tracing.TRAIN_STEP)
    assert off is tracing.span(tracing.DECODE_NEXT_FLEET)
    assert isinstance(off, contextlib.nullcontext)

    def spanned():
        with tracing.span(tracing.TRAIN_STEP):
            pass

    def bare():
        with contextlib.nullcontext():
            pass
    best = {}
    for _ in range(5):
        for f in (spanned, bare):
            t = timeit.timeit(f, number=10 ** 5)
            best[f] = min(best.get(f, t), t)
    assert best[spanned] <= 2 * best[bare], best


def test_all_reduce_mean_enters_its_span():
    ranks = D.spawn_local(2, allreduce_spans, (), device_arg="cpu",
                          backend="gloo", timeout_s=60, deadline_s=180)
    for r in ranks:
        assert r["spans"] == [tracing.TRAIN_ALLREDUCE]
        assert r["value"] == [0.5, 0.5, 0.5]
