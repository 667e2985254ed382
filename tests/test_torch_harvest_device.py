"""The port's device Harvest (``dsp/harvest_torch.py``) against the JAX
package's (``dsp/harvest_jax.py``) and the host ``dsp/harvest.py``, and
``feature_extract --f0_device torch`` against the JAX CLI's ``--f0_device
jax``.

In float32 (JAX's dtype) the device path is the host algorithm with
float32 arithmetic and bucket-padded filter-bank FFTs, so its agreement
with the host is behavioural (the bounds of ``tests/test_harvest_jax.py``:
voicing flips only on threshold-straddling frames, voiced f0 at float32
rounding of the event times), and with JAX, which shares the formulation
and the dtype, tighter; in float64 it is the host algorithm to float64
rounding.  Signals
stay at <= 1.5 s and share one f0 range and bucket where they can, so the
JAX programs compile once per worker.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.bin import feature_extract as j_feature_extract
from pytorchwavenetvocoder_tpu.dsp import harvest as H
from pytorchwavenetvocoder_tpu.dsp import harvest_jax as HJ
from pytorchwavenetvocoder_tpu.utils import read_hdf5

from pytorchwavenetvocoder_tpu_torch.bin import feature_extract as p_feature_extract
from pytorchwavenetvocoder_tpu_torch.dsp import harvest_torch as HT
from test_torch_device_dsp import _extract, corpus  # noqa: F401 (fixture)

torch.set_num_threads(2)

FS = 16000
CPU = torch.device("cpu")


def _modulated(seconds=1.0, f0=120.0, seed=0):
    """Harmonics with a 3 Hz, 5% vibrato and a little noise (the JAX
    suite's host-agreement signal, cut to one bucket)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    f0c = f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))
    ph = 2 * np.pi * np.cumsum(f0c) / FS
    return (np.sin(ph) + 0.3 * np.sin(2 * ph)
            + 0.05 * rng.standard_normal(len(t)))


def _agreement(got, want):
    """(voicing agreement, median and max relative f0 on frames voiced in
    both, share voiced)."""
    vg, vw = got > 0, want > 0
    both = vg & vw
    rel = np.abs(got[both] - want[both]) / want[both]
    return (vg == vw).mean(), np.median(rel), rel.max(), both.mean()


def test_bank_constants_match_jax_and_cache_by_device_and_dtype():
    want = HJ._bank_constants(8192, 8000.0, 71.0, 400.0)
    got = HT._bank_constants(8192, 8000.0, 71.0, 400.0, CPU)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert got[3] == want[3]
    assert HT._bank_constants(8192, 8000.0, 71.0, 400.0, "cpu") is got
    g64 = HT._bank_constants(8192, 8000.0, 71.0, 400.0, CPU, torch.float64)
    assert g64 is not got and g64[0].dtype == torch.complex128
    np.testing.assert_allclose(g64[0].numpy(), want[0], rtol=1e-6, atol=1e-6)
    assert all(k[4] == "cpu" for k in HT._BANK_CACHE)
    # LRU-capped: a fourth key evicts the least recently used
    for ceil in (300.0, 350.0, 390.0):
        HT._bank_constants(8192, 8000.0, 71.0, ceil, CPU)
    assert len(HT._BANK_CACHE) == HT._BANK_CACHE_MAX
    assert HT._bank_constants(8192, 8000.0, 71.0, 400.0, CPU) is not got


def test_event_tracks_match_jax_rows():
    """The batched event tracks against JAX's per-row function, vmapped,
    in float32 on band-passed rows with crossings on and off the frame
    times, and caps that cut some rows short."""
    rng = np.random.RandomState(0)
    n, R = 3000, 12
    tt = np.arange(n)
    S = np.stack([np.sin(2 * np.pi * tt / (20 + 7 * r) + r)
                  + 0.05 * rng.randn(n) for r in range(R)]).astype(np.float32)
    S[3, :] = 0.0                      # no events
    S[4, 1000:] = 0.0                  # events stop mid-row
    caps = np.array([n - 1] * 6 + [n - 2, 2000, 50, 10, n - 1, 1500],
                    np.int32)
    t = (np.arange(n // 8, dtype=np.float32) * np.float32(8.0))
    got_tr, got_v = HT._event_tracks(torch.as_tensor(S),
                                     torch.as_tensor(caps), torch.as_tensor(t))
    with jax.enable_x64(False):
        want_tr, want_v = jax.jit(jax.vmap(
            lambda s, c: HJ._event_tracks_row(s, c, jnp.asarray(t))))(
                S, caps)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.numpy()[[0, 1, 2, 5]].mean() > 0.9
    assert not got_v.numpy()[3].any()
    # identical formulas in float32, rounded apart by the two compilers in
    # a few elements (measured: 1 of 4,500 at 1.3e-6, two ulps)
    np.testing.assert_allclose(got_tr.numpy(), np.asarray(want_tr),
                               rtol=1e-5, atol=0)


def _jax_stages(x8, n_b, f0_floor, f0_ceil, fs8=8000.0):
    """JAX's candidate and refinement stages for one utterance, float32."""
    Hb, halves, boundary, n_fft = HJ._bank_constants(n_b, fs8, f0_floor,
                                                     f0_ceil)
    t_frames = int(np.ceil(n_b / (fs8 / 1000.0)))
    max_half = int(np.round(1.5 * fs8 / f0_floor))
    xb = np.zeros(n_b, np.float32)
    xb[:len(x8)] = x8
    with jax.enable_x64(False):
        t = jnp.arange(t_frames, dtype=jnp.float32) * jnp.float32(fs8 / 1000)

        @jax.jit
        def run(xb, nt):
            cf0, cdev = HJ._raw_candidates_device(
                xb, nt, jnp.asarray(Hb), jnp.asarray(halves),
                jnp.asarray(boundary), t, fs8, n_b, n_fft, f0_floor, f0_ceil)
            return (cf0, cdev) + HJ._refine_device(xb, nt, cf0, t, fs8,
                                                   max_half)

        return [np.asarray(a) for a in run(xb, np.int32(len(x8)))]


def _torch_stages(x8, n_b, f0_floor, f0_ceil, fs8=8000.0,
                  dtype=torch.float32):
    Hb, halves, boundary, n_fft = HT._bank_constants(n_b, fs8, f0_floor,
                                                     f0_ceil, CPU, dtype)
    t_frames = int(np.ceil(n_b / (fs8 / 1000.0)))
    t = torch.arange(t_frames, dtype=dtype) * torch.tensor(fs8 / 1000,
                                                           dtype=dtype)
    xb = np.zeros((1, n_b))
    xb[0, :len(x8)] = x8
    xb = torch.as_tensor(xb, dtype=dtype)
    nt = torch.tensor([len(x8)])
    cf0, cdev = HT._raw_candidates_device(xb, nt, Hb, halves, boundary, t,
                                          fs8, n_fft, f0_floor, f0_ceil)
    rf0, rsc = HT._refine_device(xb, nt, cf0, t, fs8,
                                 int(np.round(1.5 * fs8 / f0_floor)))
    return [a[0].double().numpy() for a in (cf0, cdev, rf0, rsc)]


def test_candidate_and_refine_stages_match_jax():
    """Both device stages on one utterance, float32 in both packages: the
    candidate pools agree where both are live (the padded-FFT outputs round
    apart at ~1e-7, which can move only a threshold-straddling candidate),
    and the refinement of the same pool agrees to float32 rounding."""
    x8, fs8 = H._decimate(_modulated(), FS)
    jf0, jdev, jrf0, jsc = _jax_stages(x8, 8192, 71.0, 400.0)
    tf0, tdev, trf0, tsc = _torch_stages(x8, 8192, 71.0, 400.0)
    assert tf0.shape == jf0.shape == (1024, 6)
    live = (tf0 > 0) & (jf0 > 0)
    assert live.sum() > 900 and ((tf0 > 0) == (jf0 > 0)).mean() > 0.995
    # where two adjacent channels' deviations tie to float32 rounding, the
    # packages may keep either one of the 3% cluster (measured: 5 of 989
    # live slots, 1.6e-4 apart); the refinement below re-estimates both
    rel = np.abs(tf0[live] - jf0[live]) / jf0[live]
    assert (rel < 1e-5).mean() > 0.99 and rel.max() < 0.03, rel.max()
    close = rel < 1e-5
    np.testing.assert_allclose(tdev[live][close], jdev[live][close],
                               rtol=1e-2, atol=1e-6)
    both = (trf0 > 0) & (jrf0 > 0)
    assert ((trf0 > 0) == (jrf0 > 0)).mean() > 0.995
    rel = np.abs(trf0[both] - jrf0[both]) / jrf0[both]
    assert np.median(rel) < 5e-7 and rel.max() < 1e-4, (np.median(rel),
                                                         rel.max())
    # float64: the host's candidates come from its complex64 filter bank,
    # so they agree as the float32 pools above do; the refinement of one
    # pool is the host's to float64 rounding
    tf0_64, _, trf0_64, tsc_64 = _torch_stages(x8, 8192, 71.0, 400.0,
                                               dtype=torch.float64)
    t_axis = np.arange(0.0, len(x8) / fs8, 1e-3)
    hf0, _ = H._raw_candidates(x8, fs8, t_axis, 71.0, 400.0)
    T_ = len(t_axis)
    live = (tf0_64[:T_] > 0) & (hf0 > 0)
    assert ((tf0_64[:T_] > 0) == (hf0 > 0)).mean() > 0.995
    rel = np.abs(tf0_64[:T_][live] - hf0[live]) / hf0[live]
    assert (rel < 1e-5).mean() > 0.99 and rel.max() < 0.03, rel.max()
    hrf0, hsc = H._refine_candidates(x8, fs8, t_axis, tf0_64[:T_])
    np.testing.assert_allclose(trf0_64[:T_], hrf0, rtol=1e-9)
    np.testing.assert_allclose(tsc_64[:T_][np.isfinite(hsc)],
                               hsc[np.isfinite(hsc)], rtol=1e-6, atol=1e-12)


def test_harvest_torch_float32_tracks_jax_and_host():
    """The JAX suite's host-agreement bounds, for the port's float32 path
    against the host and against ``harvest_jax``."""
    x = _modulated()
    got = HT.harvest_torch(x, FS, 71, 400, device=CPU)
    host = H.harvest(x, FS, 71, 400)
    want = HJ.harvest_jax(x, FS, 71, 400)
    assert got.shape == host.shape == want.shape
    for other in (host, want):
        agree, med, worst, voiced = _agreement(got, other)
        assert agree > 0.995 and voiced > 0.8, (agree, voiced)
        # measured 1.2e-8 median, 4.9e-8 max against the host
        assert med < 5e-7 and worst < 1e-4, (med, worst)


def test_harvest_torch_float64_is_the_host_algorithm():
    """float64 against the host Harvest."""
    x = _modulated(seconds=1.3, f0=210.0, seed=4)
    got = HT.harvest_torch(x, FS, 71, 400, device=CPU, dtype=torch.float64)
    host = H.harvest(x, FS, 71, 400)
    agree, med, worst, voiced = _agreement(got, host)
    assert agree == 1.0 and voiced > 0.8, (agree, voiced)
    # the host filters in complex64 (its event times carry float32
    # rounding), the float64 path in complex128; the refinement re-estimates
    # from the float64 signal, so the tracks are equal to float64 rounding
    # except where the candidate's rounding moves an integer window
    # half-width or harmonic bin, which shifts that frame's refined f0 and,
    # through the smoothing, its neighbours' (measured here: 1.3e-15 median,
    # 9.3e-5 max)
    assert med < 1e-12 and worst < 1e-3, (med, worst)


def test_harvest_torch_many_matches_single_across_buckets(monkeypatch):
    """Utterances of three buckets, and micro-batches of two (``_U_BATCH``
    patched), must not leak into each other: the many path equals each
    utterance run alone."""
    xs = [_modulated(0.7, 140.0, 1), _modulated(1.5, 190.0, 2),
          _modulated(0.4, 250.0, 3), _modulated(0.9, 170.0, 5),
          _modulated(1.0, 120.0, 6)]
    monkeypatch.setattr(HT, "_U_BATCH", 2)
    many = HT.harvest_torch_many(xs, FS, 71, 400, device=CPU)
    for x, got in zip(xs, many):
        one = HT.harvest_torch(x, FS, 71, 400, device=CPU)
        np.testing.assert_array_equal(got, one)
        assert (got > 0).mean() > 0.8


def test_short_utterance_takes_the_host_route_and_is_counted(caplog):
    """Where the host raises f0_floor from the signal length (60 ms: 480
    samples at 8 kHz, under 3 fs8 / 40 = 600), the utterance runs the host
    Harvest bit for bit, is logged, and counted; silence and utterances
    under 50 ms are unvoiced without either."""
    t = np.arange(int(0.06 * FS)) / FS
    x = np.sin(2 * np.pi * 200 * t)
    before = HT.harvest_torch_many.host_utterances
    with caplog.at_level(logging.INFO):
        got = HT.harvest_torch_many([x, np.zeros(16001), x[:700]], FS,
                                    f0_floor=40.0, f0_ceil=400.0, device=CPU)
    np.testing.assert_array_equal(
        got[0], H.harvest(x, FS, f0_floor=40.0, f0_ceil=400.0))
    assert HT.harvest_torch_many.host_utterances == before + 1
    assert "takes the host Harvest" in caplog.text
    assert len(got[1]) == 16001 // 80 + 1 and not got[1].any()
    assert len(got[2]) == 700 // 80 + 1 and not got[2].any()


def test_narrow_f0_range_clamps_the_candidate_pool():
    """A narrow [minf0, maxf0] builds fewer channels (5) than the 6-wide
    candidate pool; the pool clamps to the channel count."""
    t = np.arange(FS) / FS
    x = sum(np.sin(2 * np.pi * 210.0 * k * t) / k for k in range(1, 5))
    got = HT.harvest_torch(x, FS, f0_floor=200.0, f0_ceil=220.0, device=CPU)
    host = H.harvest(x, FS, f0_floor=200.0, f0_ceil=220.0)
    v = got > 0
    assert v.mean() > 0.9
    assert np.median(np.abs(got[v] - 210.0) / 210.0) < 1e-3
    assert ((host > 0) == v).mean() > 0.97


def test_feature_extract_f0_device_torch_tracks_the_jax_cli(corpus, tmp_path):
    """``--device cpu --f0_device torch`` against the JAX CLI's ``--device
    jax --f0_device jax``: both run Harvest's heavy stages in float32, so
    voicing agrees and voiced f0 differs at float32 rounding of the event
    times; and against the host F0 path by the JAX CLI test's bounds."""
    root, names = corpus
    _extract(j_feature_extract, root / "wav.scp", tmp_path / "jax", "world",
             "--device", "jax", "--f0_device", "jax")
    _extract(p_feature_extract, root / "wav.scp", tmp_path / "port", "world",
             "--device", "cpu", "--f0_device", "torch")
    _extract(p_feature_extract, root / "wav.scp", tmp_path / "host", "world",
             "--n_jobs", "1")
    for n in names:
        h5 = n.replace(".wav", ".h5")
        want = read_hdf5(str(tmp_path / "jax" / h5), "/world")
        got = read_hdf5(str(tmp_path / "port" / h5), "/world")
        host = read_hdf5(str(tmp_path / "host" / h5), "/world")
        assert got.shape == want.shape == host.shape
        for other, agree, med in ((want, 1.0, 1e-5), (host, 0.97, 1e-3)):
            uv_a, uv_b = got[:, 0], other[:, 0]
            assert (uv_a == uv_b).mean() >= agree, (uv_a == uv_b).mean()
            both = (uv_a > 0) & (uv_b > 0)
            rel = np.abs(got[both, 1] - other[both, 1]) / other[both, 1]
            assert both.mean() > 0.3 and np.median(rel) < med, np.median(rel)
