"""The port's device DSP (``dsp/torch_dsp.py``) against the JAX package's
(``dsp/jax_dsp.py``) on the same numpy inputs: in float64 against JAX under
the suite's x64, and in float32 against JAX with x64 off (the dtype a TPU
and the card compute in), and the ``feature_extract --device cpu`` h5 files
against the JAX CLI's ``--device jax``.

Tolerances: float64 comparisons hold the two packages to float64 rounding
(both compute the same formulas; where the port reorders a computation --
freqt as a product with its warping matrix, the compensated cumsum as a
doubling scan -- the bound is the JAX tests' own against numpy, or says
why it is looser); float32 comparisons are bounded by float32 rounding of
the quantity compared, relative to its scale, and by the JAX float32 tests'
bounds against the host (``tests/test_jax_dsp.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax

from pytorchwavenetvocoder_tpu.bin import feature_extract as j_feature_extract
from pytorchwavenetvocoder_tpu.dsp import cepstrum as npc
from pytorchwavenetvocoder_tpu.dsp import jax_dsp as J
from pytorchwavenetvocoder_tpu.dsp import spectral as nps
from pytorchwavenetvocoder_tpu.dsp.cheaptrick import cheaptrick
from pytorchwavenetvocoder_tpu.dsp.d4c import d4c
from pytorchwavenetvocoder_tpu.eval.klatt import make_corpus
from pytorchwavenetvocoder_tpu.utils import read_hdf5

from pytorchwavenetvocoder_tpu_torch.bin import feature_extract as p_feature_extract
from pytorchwavenetvocoder_tpu_torch.dsp import torch_dsp as T

torch.set_num_threads(2)

FS = 16000


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def scale(a):
    return float(np.abs(np.asarray(a)).max())


def test_stft_torch_matches_jax():
    x = np.random.RandomState(0).randn(8000)
    want = np.asarray(J.stft_jax(x, n_fft=512, hop_length=128))
    got = T.stft_torch(t64(x), n_fft=512, hop_length=128).numpy()
    assert got.shape == want.shape
    assert err(got, want) < 1e-12 * scale(want)
    # uncentred and batched (the CLI's bucket-free melspc path centres)
    xb = np.random.RandomState(1).randn(2, 3000)
    np.testing.assert_allclose(
        T.stft_torch(t64(xb), 256, 64, center=False).numpy(),
        np.asarray(J.stft_jax(xb, 256, 64, center=False)), atol=1e-11)
    with jax.enable_x64(False):
        want32 = np.asarray(J.stft_jax(x.astype(np.float32), 512, 128))
    got32 = T.stft_torch(t32(x), 512, 128).numpy()
    # float32 rounding of a 512-point FFT: a few ulps of the largest bin
    # (measured 1.5e-7 of it, against the host and JAX alike)
    assert err(got32, want32) < 2e-6 * scale(want32)
    assert err(np.abs(got32), np.abs(nps.stft(x, 512, 128))) \
        < 2e-6 * scale(want32)


def test_melspectrogram_torch_matches_jax():
    x = np.random.RandomState(1).randn(FS)
    kw = dict(n_fft=1024, hop_length=80, n_mels=80)
    want = np.asarray(J.melspectrogram_jax(x, FS, **kw))
    got = T.melspectrogram_torch(t64(x), FS, **kw).numpy()
    assert err(got, want) < 1e-12 * scale(want)
    xb = np.random.RandomState(2).randn(3, 4000)
    np.testing.assert_allclose(
        T.melspectrogram_torch(t64(xb), FS, hop_length=80,
                               log10=True).numpy(),
        np.asarray(J.melspectrogram_jax(xb, FS, hop_length=80, log10=True)),
        atol=1e-11)
    with jax.enable_x64(False):
        want32 = np.asarray(J.melspectrogram_jax(x.astype(np.float32), FS,
                                                 **kw))
    got32 = T.melspectrogram_torch(t32(x), FS, **kw).numpy()
    # float32 FFT and filter-bank product: measured 2e-8 of the largest bin
    assert err(got32, want32) < 1e-6 * scale(want)
    assert err(got32, nps.melspectrogram(x, FS, **kw)) < 1e-6 * scale(want)


def test_freqt_torch_matches_jax():
    rng = np.random.RandomState(3)
    c = rng.randn(26) * np.exp(-0.2 * np.arange(26))
    cb = rng.randn(5, 26)
    # the JAX tests' bound against numpy's recursion (the product with the
    # warping matrix rounds apart from the scan at ~1e-16)
    for order in (0, 1, 24, 63):
        np.testing.assert_allclose(T.freqt_torch(t64(c), order, 0.41).numpy(),
                                   np.asarray(J.freqt_jax(c, order, 0.41)),
                                   atol=1e-9)
    np.testing.assert_allclose(T.freqt_torch(t64(cb), 24, -0.41).numpy(),
                               np.asarray(J.freqt_jax(cb, 24, -0.41)),
                               atol=1e-9)
    with jax.enable_x64(False):
        want32 = np.asarray(J.freqt_jax(c.astype(np.float32), 63, 0.41))
    got32 = T.freqt_torch(t32(c), 63, 0.41).numpy()
    # float32: the product sums 26 terms, the scan runs 26 x 63 updates;
    # both are within a few ulps of |c|'s scale (measured 1.2e-7)
    assert err(got32, want32) < 1e-6 * scale(c)
    assert err(got32, npc.freqt(c, 63, 0.41)) < 1e-6 * scale(c)


def test_sp2mc_torch_matches_jax():
    ps = np.exp(np.random.RandomState(4).randn(3, 257))
    np.testing.assert_allclose(T.sp2mc_torch(t64(ps), 24, 0.41).numpy(),
                               np.asarray(J.sp2mc_jax(ps, 24, 0.41)),
                               atol=1e-9)
    # a per-row floor (the WORLD path's rescaled one) bites per row
    floor = np.array([[1e-10], [2.0], [1e-10]])
    np.testing.assert_allclose(
        T.sp2mc_torch(t64(ps), 24, 0.41, floor=t64(floor)).numpy(),
        np.asarray(J.sp2mc_jax(ps, 24, 0.41, floor=floor)), atol=1e-9)
    with jax.enable_x64(False):
        want32 = np.asarray(J.sp2mc_jax(ps.astype(np.float32), 24, 0.41))
    got32 = T.sp2mc_torch(t32(ps), 24, 0.41).numpy()
    # float32 log spectrum and 257-point inverse FFT (measured 3.7e-8)
    assert err(got32, want32) < 1e-6
    assert err(got32, [npc.sp2mc(p, 24, 0.41) for p in ps]) < 1e-6


def test_mirror_matches_jax():
    c = np.random.RandomState(8).randn(2, 3, 9)
    np.testing.assert_array_equal(T._mirror(t64(c), 16).numpy(),
                                  np.asarray(J._mirror(c, 16)))
    np.testing.assert_array_equal(T._mirror(t64(c), 40).numpy(),
                                  np.asarray(J._mirror(c, 40)))


def test_stft_mcep_and_uels_match_jax(monkeypatch):
    monkeypatch.setenv("WNDSP_DISABLE_NATIVE", "1")
    x = np.random.RandomState(5).randn(6000)
    want = np.asarray(J.stft_mcep_jax(x, 512, 256, 25))
    got = T.stft_mcep_torch(t64(x), 512, 256, 25).numpy()
    # the JAX test's bound against numpy (measured 2e-15 between the two)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, npc.stft_mcep(x, 512, 256, 25), atol=1e-6)
    np.testing.assert_allclose(
        T.stft_mcep_torch(t64(x), 512, 256, 25, refine=False).numpy(),
        np.asarray(J.stft_mcep_jax(x, 512, 256, 25, refine=False)),
        atol=1e-9)
    # uels_refine alone from a perturbed start
    spec = np.maximum(np.abs(np.fft.rfft(
        x[:512] * np.hamming(513)[:512])) ** 2, 1e-10)[None]
    c0 = np.asarray(J.sp2mc_jax(spec, 25, 0.41)) + 0.01
    np.testing.assert_allclose(
        T.uels_refine_torch(t64(c0), t64(spec), 0.41, 25, n_iter=4).numpy(),
        np.asarray(J.uels_refine_jax(c0, spec, 0.41, 25, n_iter=4)),
        atol=1e-9)
    with jax.enable_x64(False):
        want32 = np.asarray(J.stft_mcep_jax(x.astype(np.float32), 512, 256,
                                            25))
    got32 = T.stft_mcep_torch(t32(x), 512, 256, 25).numpy()
    # float32: 15 Newton steps on a 25 x 25 Toeplitz-plus-Hankel system
    # from float32 spectra; measured 4.8e-7 (JAX's own float32 against
    # numpy: 2.4e-7)
    assert err(got32, want32) < 1e-5
    assert err(got32, npc.stft_mcep(x, 512, 256, 25)) < 1e-5


def test_mlsa_filter_torch_matches_jax(monkeypatch):
    monkeypatch.setenv("WNDSP_DISABLE_NATIVE", "1")
    from pytorchwavenetvocoder_tpu.dsp import mlsa as npm

    rng = np.random.RandomState(6)
    coef = npc.mc2b(np.concatenate(
        [[0.0], 0.3 * rng.randn(25) * np.exp(-0.2 * np.arange(25))]), 0.41)
    x = rng.randn(8000)
    got = T.mlsa_filter_torch(t64(x), t64(coef), 0.41).numpy()
    np.testing.assert_allclose(got, np.asarray(J.mlsa_filter_jax(x, coef,
                                                                 0.41)),
                               atol=1e-9)
    np.testing.assert_allclose(got, npm.mlsa_filter(x, coef, 0.41), atol=1e-6)
    with jax.enable_x64(False):
        want32 = np.asarray(J.mlsa_filter_jax(
            x.astype(np.float32), coef.astype(np.float32), 0.41))
    got32 = T.mlsa_filter_torch(t32(x), t32(coef), 0.41).numpy()
    # float32 8,192-point exp/FFT impulse response and a 16,384-point
    # convolution (measured 1.7e-6 on a unit-variance signal)
    assert err(got32, want32) < 2e-5 * scale(x)
    assert err(got32, npm.mlsa_filter(x, coef, 0.41)) < 2e-5 * scale(x)


def _world_test_frames(T_=40, fftl=1024):
    rng = np.random.RandomState(0)
    n = fftl + 80 * T_
    x = (np.sin(2 * np.pi * np.cumsum(np.full(n, 170.0)) / FS)
         + 0.1 * rng.randn(n))
    f0 = 180 + 30 * np.sin(2 * np.pi * 2 * np.arange(T_) / T_)
    idx = np.arange(fftl)[None, :] + 80 * np.arange(T_)[:, None]
    return x[idx], f0


def test_dd_cumsum_matches_jax_and_the_exact_sum():
    """The doubling scan against JAX's ``associative_scan`` of the same
    operator.  The operator is not exactly associative in floating point,
    so the two trees may round the (hi, lo) pairs apart; hi + lo carries
    ~2x the mantissa, so both stay within 2^-40 of the running total of
    the exact (float64) sum of the float32 inputs (measured: equal)."""
    frames, _ = _world_test_frames()
    x = np.abs(frames) * np.exp(np.random.RandomState(9).randn(*frames.shape)
                                * 6.0)   # ~5 decades of dynamic range
    j_scan = jax.jit(J._dd_cumsum)
    hi, lo = T._dd_cumsum(t64(x))
    jh, jl = j_scan(x)
    np.testing.assert_allclose(hi.numpy() + lo.numpy(),
                               np.asarray(jh) + np.asarray(jl),
                               rtol=1e-15, atol=0)
    x32 = x.astype(np.float32)
    exact = np.cumsum(x32.astype(np.float64), axis=1)
    hi, lo = T._dd_cumsum(t32(x32))
    with jax.enable_x64(False):
        jh, jl = jax.jit(J._dd_cumsum)(x32)
    for h, lw in ((hi.numpy(), lo.numpy()), (np.asarray(jh), np.asarray(jl))):
        got = h.astype(np.float64) + lw.astype(np.float64)
        assert (np.abs(got - exact) / exact[:, -1:]).max() < 2.0 ** -40
    # a plain float32 cumsum misses by ~2^-24 of the total
    plain = np.cumsum(x32, axis=1).astype(np.float64)
    assert (np.abs(plain - exact) / exact[:, -1:]).max() > 2.0 ** -30


def test_linear_smoothing_matches_jax():
    frames, f0 = _world_test_frames()
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    j_smooth = jax.jit(J._linear_smoothing_jax, static_argnums=(2, 3))
    np.testing.assert_allclose(
        T._linear_smoothing_torch(t64(spec), t64(f0), FS, 1024).numpy(),
        np.asarray(j_smooth(spec, f0, FS, 1024)), rtol=1e-12)
    # floorless on a signed signal (D4C's use): float64 rounding of the
    # differenced totals, relative to the signal's scale
    floor = np.full((len(f0), 1), -np.inf)
    np.testing.assert_allclose(
        T._linear_smoothing_torch(t64(spec - spec.mean()), t64(f0), FS, 1024,
                                  floor=t64(floor)).numpy(),
        np.asarray(j_smooth(spec - spec.mean(), f0, FS, 1024, floor)),
        rtol=1e-9, atol=1e-12 * scale(spec))


def test_cheaptrick_torch_matches_jax():
    frames, f0 = _world_test_frames()
    f0 = f0.copy()
    f0[::9] = 0.0    # unvoiced rows take CheapTrick's default f0
    ref_db = 10 * np.log10(cheaptrick(frames, f0, FS, 1024))
    got = T.cheaptrick_torch(t64(frames), t64(f0), FS, 1024).numpy()
    want = np.asarray(J.cheaptrick_jax(frames, f0, FS, 1024))
    # float64: the JAX test's bound against numpy, in dB
    np.testing.assert_allclose(10 * np.log10(got), 10 * np.log10(want),
                               atol=1e-7)
    np.testing.assert_allclose(10 * np.log10(got), ref_db, atol=1e-7)
    with jax.enable_x64(False):
        want32 = np.asarray(J.cheaptrick_jax(frames.astype(np.float32),
                                             f0.astype(np.float32), FS, 1024))
    got32 = T.cheaptrick_torch(t32(frames), t32(f0), FS, 1024).numpy()
    # float32: the JAX float32 test's bound, a hundredth of a dB (measured
    # 1.5e-4 dB against numpy, 1.7e-4 against JAX)
    for other in (10 * np.log10(want32.astype(np.float64)), ref_db):
        assert err(10 * np.log10(got32.astype(np.float64)), other) < 0.01


def test_d4c_torch_matches_jax():
    frames, f0 = _world_test_frames()
    f0 = f0.copy()
    f0[::7] = 0.0    # unvoiced rows come back exactly 0 dB
    ref = d4c(frames, f0, FS, 1024)
    got = T.d4c_torch(t64(frames), t64(f0), FS, 1024).numpy()
    np.testing.assert_allclose(got, np.asarray(J.d4c_jax(frames, f0, FS,
                                                         1024)), atol=1e-7)
    np.testing.assert_allclose(got, ref, atol=1e-7)
    assert np.all(got[::7] == 0.0)
    with jax.enable_x64(False):
        want32 = np.asarray(J.d4c_jax(frames.astype(np.float32),
                                      f0.astype(np.float32), FS, 1024))
    got32 = T.d4c_torch(t32(frames), t32(f0), FS, 1024).numpy()
    # float32: the JAX float32 test's bound (measured 2.5e-5 dB against
    # numpy, 2.9e-5 against JAX)
    assert err(got32, want32) < 0.01 and err(got32, ref) < 0.01
    assert np.all(got32[::7] == 0.0)


def test_world_frames_torch_f32_at_int16_scale():
    """The whole device analysis in float32 at the pipeline's input scale
    (int16-range floats): peak normalisation and the rescaled floors hold
    it to the float64 host within the JAX test's 1e-3 (measured 5.8e-6
    mcep, 2.5e-5 codeap), and to JAX's float32 path within the same."""
    from pytorchwavenetvocoder_tpu.dsp.cepstrum import sp2mc

    frames, f0 = _world_test_frames()
    f0u = f0.copy()
    f0u[::7] = 0.0
    fi16 = frames * 8000.0
    env = cheaptrick(fi16, f0, FS, 1024)
    mcep_ref = np.stack([sp2mc(np.maximum(env[t], 1e-10), 24, 0.41)
                         for t in range(env.shape[0])])
    cod_ref = d4c(fi16, f0u, FS, 1024)
    m32, c32 = T._world_frames_torch(t32(fi16), t32(f0), t32(f0u), FS, 1024,
                                     24, 0.41)
    with jax.enable_x64(False):
        jm, jc = J._world_frames_jax(fi16.astype(np.float32),
                                     f0.astype(np.float32),
                                     f0u.astype(np.float32), FS, 1024, 24,
                                     0.41)
    assert err(m32, mcep_ref) < 1e-3 and err(c32, cod_ref) < 1e-3
    assert err(m32, jm) < 1e-3 and err(c32, jc) < 1e-3
    m64, c64 = T._world_frames_torch(t64(fi16), t64(f0), t64(f0u), FS, 1024,
                                     24, 0.41)
    jm, jc = J._world_frames_jax(fi16, f0, f0u, FS, 1024, 24, 0.41)
    np.testing.assert_allclose(m64.numpy(), np.asarray(jm), atol=1e-9)
    np.testing.assert_allclose(c64.numpy(), np.asarray(jc), atol=1e-9)


def _tones():
    rng = np.random.RandomState(7)
    xs = []
    for dur, f0 in [(0.31, 120.0), (0.44, 200.0), (0.23, 90.0)]:
        t = np.arange(int(FS * dur)) / FS
        xs.append(8000.0 * (np.sin(2 * np.pi * f0 * t)
                            + 0.01 * rng.randn(len(t))))
    return xs


@pytest.mark.parametrize("f0_device", ["host", "torch"])
def test_world_analyze_torch_many_matches_jax(f0_device):
    """Cross-utterance batching with device_batch=64, so slice boundaries
    fall inside utterances, against ``world_analyze_jax_many``.  Host F0:
    the uv and f0 columns are the same host Harvest's, bit for bit, and the
    rest within float64 rounding.  Device F0 (float32 in both packages):
    voicing agrees, f0 within float32 rounding of the event times."""
    xs = _tones()
    kw = dict(minf0=60, maxf0=300, device_batch=64)
    got = T.world_analyze_torch_many(xs, FS, f0_device=f0_device,
                                     device="cpu", **kw)
    want = J.world_analyze_jax_many(
        xs, FS, f0_device={"host": "host", "torch": "jax"}[f0_device], **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (g.shape[0], 2 + 25 + 1)
        if f0_device == "host":
            np.testing.assert_array_equal(g[:, :2], w[:, :2])
            np.testing.assert_allclose(g[:, 2:], w[:, 2:], atol=1e-9)
        else:
            np.testing.assert_array_equal(g[:, 0], w[:, 0])
            # relative f0 (measured 1.2e-5 on the low-passed track) and the
            # envelope analysed at that f0
            np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4)
            np.testing.assert_allclose(g[:, 2:], w[:, 2:], atol=1e-3)
    with pytest.raises(ValueError, match="f0_device"):
        T.world_analyze_torch_many(xs, FS, f0_device="jax", device="cpu")


def test_world_analyze_torch_float32_and_single_utterance():
    """float32 on the CPU against JAX's with x64 off (the card's dtype;
    the JAX contract on its chip: max |d| <= 4e-4 against the host), and the
    one-utterance wrapper equal to the many path's row of it."""
    xs = _tones()
    got = T.world_analyze_torch_many(xs, FS, minf0=60, maxf0=300,
                                     device_batch=64, device="cpu",
                                     dtype=torch.float32)
    with jax.enable_x64(False):
        want = J.world_analyze_jax_many(xs, FS, minf0=60, maxf0=300,
                                        device_batch=64)
    host = T.world_analyze_torch_many(xs, FS, minf0=60, maxf0=300,
                                      device_batch=64, device="cpu")
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(g[:, :2], w[:, :2])
        assert err(g, w) < 4e-4 and err(g, h) < 4e-4   # measured 4.6e-5
    one = T.world_analyze_torch(xs[1], FS, minf0=60, maxf0=300,
                                device="cpu")
    np.testing.assert_allclose(one, host[1], atol=1e-9)


def test_full_f32_products_restore_the_setting():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")   # TF32 on a card
        with T.full_f32_products():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two short Klatt utterances (2 syllables, ~0.5 s) and their list."""
    root = tmp_path_factory.mktemp("klatt")
    make_corpus(str(root / "wav"), 2, fs=FS, seed=0, n_syllables=2)
    names = sorted(os.listdir(root / "wav"))
    (root / "wav.scp").write_text(
        "".join(f"{root / 'wav' / n}\n" for n in names))
    return root, names


def _extract(cli, wav_scp, out, feature_type, *flags):
    fftl = "512" if feature_type == "mcep" else "1024"
    # mcep: a 20 ms shift keeps the per-frame UELS short
    shiftms = "20" if feature_type == "mcep" else "5"
    cli.main(["--waveforms", str(wav_scp), "--hdf5dir", str(out),
              "--fs", str(FS), "--shiftms", shiftms, "--feature_type",
              feature_type, "--minf0", "120", "--maxf0", "275", "--fftl",
              fftl, "--mspc_dim", "20", "--save_wav", "false", "--n_jobs",
              "2", "--verbose", "0", *flags])


@pytest.mark.parametrize("feature_type", ["world", "melspc", "mcep"])
def test_feature_extract_device_cpu_writes_what_the_jax_cli_writes(
        corpus, tmp_path, feature_type):
    """``--device cpu`` (float64 on the CPU) against the JAX CLI's
    ``--device jax`` (float64 under the suite's x64), as stored (float32):
    world's uv and f0 columns come from the same host Harvest and are
    equal; everything else within one float32 rounding of its value."""
    root, names = corpus
    _extract(j_feature_extract, root / "wav.scp", tmp_path / "jax",
             feature_type, "--device", "jax")
    _extract(p_feature_extract, root / "wav.scp", tmp_path / "port",
             feature_type, "--device", "cpu")
    for n in names:
        h5 = n.replace(".wav", ".h5")
        want = read_hdf5(str(tmp_path / "jax" / h5), "/" + feature_type)
        got = read_hdf5(str(tmp_path / "port" / h5), "/" + feature_type)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape and len(got) > 10
        if feature_type == "world":
            np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-9)


def _d4c_extended(frames, f0, fs, fftl):
    """The host D4C with its smoothing in extended precision (np.longdouble):
    the host algorithm's value without its float64 cancellation."""
    from pytorchwavenetvocoder_tpu_torch.dsp import cheaptrick, d4c as p_d4c

    def smooth(signal, width_hz, fs, fftl):
        s = signal.astype(np.longdouble)
        off = s.min() - 1.0
        return (cheaptrick._linear_smoothing(
            s - off, 1.5 * width_hz.astype(np.longdouble), fs, fftl)
            + off).astype(np.float64)

    prev, p_d4c._smooth = p_d4c._smooth, smooth
    try:
        return p_d4c.d4c(frames, f0, fs, fftl)
    finally:
        p_d4c._smooth = prev


def test_host_d4c_cancels_quiet_frames_where_the_device_path_does_not():
    """A fault of the host D4C, the JAX package's and the port's copy alike
    (``dsp/d4c.py::_smooth``): it subtracts one offset, the least value over
    the utterance's voiced frames, before smoothing, and in float64 that
    cancels a quiet frame's values away.  On Klatt utterance 0 (seed 0, 3-7
    syllables) at ljspeech-sd's settings (22,050 Hz, f0 40-400, fftl 1,024)
    the host's codeap misses the same algorithm with extended-precision
    smoothing by 8.4e-3 dB, where the device path (per-frame normalised,
    smoothing floorless) in float64 stays within 1e-6 (measured 8e-7) on
    every frame with a sample (D4C of an all-zero frame is 0/0)."""
    from pytorchwavenetvocoder_tpu_torch.dsp.d4c import d4c as host_d4c
    from pytorchwavenetvocoder_tpu_torch.dsp.f0 import extract_f0
    from pytorchwavenetvocoder_tpu_torch.dsp.filters import low_cut_filter
    from pytorchwavenetvocoder_tpu_torch.dsp.world import _centered_frames
    from pytorchwavenetvocoder_tpu_torch.eval.klatt import synthesize_utterance

    fs, hop = 22050, 110
    x = low_cut_filter(synthesize_utterance(
        0, fs=fs, seed=0, n_syllables=(3, 7)).astype(np.float64), fs, 70)
    n = len(x) // hop + 1
    f0 = extract_f0(x, fs, minf0=40, maxf0=400, shiftms=5)[:n]
    frames = _centered_frames(x, 1024, hop, n)
    live = np.abs(frames).max(axis=1) > 0
    exact = _d4c_extended(frames, f0, fs, 1024)[live]
    host = host_d4c(frames, f0, fs, 1024)[live]
    peak = np.maximum(np.abs(frames).max(axis=1, keepdims=True), 1e-6)
    dev = T.d4c_torch(t64(frames / peak), t64(f0), fs, 1024).numpy()[live]
    assert err(host, exact) > 1e-3
    assert err(dev, exact) < 1e-6
