"""The port's host DSP (``pytorchwavenetvocoder_tpu_torch/dsp``, ``native.py``)
against the JAX package's: every function bit-equal to its twin on the same
seeded inputs (a short Klatt utterance and seeded noise), once with both
packages on the native library (built for the test run from
``native/wndsp.cc``) and once with both on the numpy path."""

import types

import numpy as np
import pytest

from pytorchwavenetvocoder_tpu import native as j_native
from pytorchwavenetvocoder_tpu.dsp import cepstrum as j_cep
from pytorchwavenetvocoder_tpu.dsp import cheaptrick as j_ct
from pytorchwavenetvocoder_tpu.dsp import d4c as j_d4c
from pytorchwavenetvocoder_tpu.dsp import f0 as j_f0
from pytorchwavenetvocoder_tpu.dsp import filters as j_filt
from pytorchwavenetvocoder_tpu.dsp import harvest as j_hv
from pytorchwavenetvocoder_tpu.dsp import mlsa as j_mlsa
from pytorchwavenetvocoder_tpu.dsp import spectral as j_spec
from pytorchwavenetvocoder_tpu.dsp import world as j_world
from pytorchwavenetvocoder_tpu.eval.klatt import synthesize_utterance

from _torch_native import dsp_path, wndsp_lib  # noqa: F401 (fixtures)
from pytorchwavenetvocoder_tpu_torch import dsp as p_dsp
from pytorchwavenetvocoder_tpu_torch import native as p_native
from pytorchwavenetvocoder_tpu_torch.dsp import cepstrum as p_cep
from pytorchwavenetvocoder_tpu_torch.dsp import cheaptrick as p_ct
from pytorchwavenetvocoder_tpu_torch.dsp import d4c as p_d4c
from pytorchwavenetvocoder_tpu_torch.dsp import f0 as p_f0
from pytorchwavenetvocoder_tpu_torch.dsp import filters as p_filt
from pytorchwavenetvocoder_tpu_torch.dsp import harvest as p_hv
from pytorchwavenetvocoder_tpu_torch.dsp import mlsa as p_mlsa
from pytorchwavenetvocoder_tpu_torch.dsp import spectral as p_spec
from pytorchwavenetvocoder_tpu_torch.dsp import world as p_world

FS = 16000
J = types.SimpleNamespace(cep=j_cep, ct=j_ct, d4c=j_d4c, f0=j_f0,
                          filt=j_filt, hv=j_hv, mlsa=j_mlsa, spec=j_spec,
                          world=j_world, native=j_native)
P = types.SimpleNamespace(cep=p_cep, ct=p_ct, d4c=p_d4c, f0=p_f0,
                          filt=p_filt, hv=p_hv, mlsa=p_mlsa, spec=p_spec,
                          world=p_world, native=p_native)


def _inputs():
    rng = np.random.RandomState(0)
    speech = synthesize_utterance(3, fs=FS, seed=1, n_syllables=2)
    x = speech.astype(np.float64)
    frames = p_world._centered_frames(x, 1024, 80, len(x) // 80 + 1)
    f0 = j_f0.extract_f0(x, FS, minf0=120, maxf0=275)[: len(frames)]
    mc = np.concatenate([[0.0], 0.3 * rng.randn(24) * np.exp(
        -0.2 * np.arange(24))])
    return types.SimpleNamespace(
        x=x, noise=rng.randn(6000), frames=frames, f0=f0, mc=mc,
        coef=j_cep.mc2b(mc, 0.41), power=np.exp(rng.randn(7, 513)),
        frame=rng.randn(512) * np.hamming(512),
        a=rng.randn(40, 24), b=rng.randn(46, 24))


@pytest.fixture(scope="module")
def X():
    return _inputs()


# name -> the call on one package's modules (D) with the inputs (X); each
# returns arrays
CASES = {
    "filters.low_cut_filter": lambda D, X: D.filt.low_cut_filter(X.x, FS, 70),
    "filters.low_pass_filter": lambda D, X: D.filt.low_pass_filter(
        X.f0, 200, cutoff=20),
    "spectral.stft": lambda D, X: D.spec.stft(X.x, 1024, 256),
    "spectral.mel_filterbank": lambda D, X: D.spec.mel_filterbank(
        FS, 1024, 80, fmin=70, fmax=7600),
    "spectral.melspectrogram": lambda D, X: D.spec.melspectrogram(
        X.x / 32768, FS, n_fft=1024, hop_length=80, n_mels=80),
    "cepstrum.freqt": lambda D, X: D.cep.freqt(X.mc, 63, -0.41),
    "cepstrum.mc2b/b2mc": lambda D, X: (D.cep.mc2b(X.mc, 0.41),
                                     D.cep.b2mc(X.mc, 0.41)),
    "cepstrum.sp2mc": lambda D, X: D.cep.sp2mc(X.power[0], 24, 0.41),
    "cepstrum.sp2mc_batch": lambda D, X: D.cep.sp2mc_batch(X.power, 24, 0.41),
    "cepstrum.mcep": lambda D, X: D.cep.mcep(X.frame, 24, 0.41),
    "cepstrum.stft_mcep": lambda D, X: D.cep.stft_mcep(X.noise, 512, 256, 24),
    "mlsa.mlsa_impulse_response": lambda D, X: D.mlsa.mlsa_impulse_response(
        X.coef, 0.41),
    "mlsa.mlsa_filter": lambda D, X: D.mlsa.mlsa_filter(X.x, X.coef, 0.41),
    "harvest.harvest": lambda D, X: D.hv.harvest(X.x, FS, 120, 275),
    "cheaptrick.cheaptrick": lambda D, X: D.ct.cheaptrick(
        X.frames, X.f0, FS, 1024),
    "d4c.d4c": lambda D, X: D.d4c.d4c(X.frames, X.f0, FS, 1024),
    "f0.extract_f0/convert_to_continuous_f0": lambda D, X: (
        D.f0.extract_f0(X.x, FS, minf0=120, maxf0=275),
        *D.f0.convert_to_continuous_f0(X.f0)),
    "world.world_analyze": lambda D, X: D.world.world_analyze(
        X.x, FS, minf0=120, maxf0=275),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dsp_function_is_bit_equal_to_jax(name, dsp_path, X):
    want, got = CASES[name](J, X), CASES[name](P, X)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# the bindings themselves, on the library only
NATIVE = {
    "mcep/uels_refine": lambda N, X: (
        N.mcep(X.frame, 24, 0.41),
        N.uels_refine(j_cep.mcep(X.frame, 24, 0.41, refine=False),
                      np.abs(np.fft.rfft(X.frame)) ** 2, 0.41)),
    "mu_law": lambda N, X: (N.encode_mu_law(X.noise / 4.0),
                         N.decode_mu_law(np.arange(256))),
    "dtw_band": lambda N, X: N.dtw_band(X.a, X.b, 8),
}


@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_binding_is_bit_equal_to_jax(name, wndsp_lib, monkeypatch,
                                            X):
    for mod in (j_native, p_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setenv("WNDSP_LIB", wndsp_lib)
    assert p_native.dtw_available() and j_native.dtw_available()
    for w, g in zip(NATIVE[name](j_native, X), NATIVE[name](p_native, X)):
        np.testing.assert_array_equal(g, w)


def test_dsp_package_exports_the_jax_host_surface():
    """The port's ``dsp`` package exports the JAX one's names, less the
    device DSP (``harvest_jax``, ``jax_dsp``: not ported)."""
    import pytorchwavenetvocoder_tpu.dsp as jdsp

    # the package name is bound by the packages' own submodule imports
    want = {n for n in vars(jdsp) if not n.startswith("_")} - {
        "harvest_jax", "jax_dsp", "pytorchwavenetvocoder_tpu"}
    have = {n for n in vars(p_dsp) if not n.startswith("_")}
    assert want <= have
    assert not {"harvest_jax", "jax_dsp", "pytorchwavenetvocoder_tpu"} & have


def test_native_library_is_found_in_the_port_build_dir(monkeypatch,
                                                       tmp_path, wndsp_lib):
    """Without ``WNDSP_LIB`` (and where ``make -C native`` built no
    ``native/libwndsp.so``), the port loads the copy ``_build.build_native``
    puts at ``_build.native_lib_path()``."""
    import os
    import shutil

    from pytorchwavenetvocoder_tpu_torch import _build

    lib = tmp_path / "libwndsp_test.so"
    shutil.copy(wndsp_lib, lib)
    monkeypatch.setattr(_build, "native_lib_path", lambda: lib)
    monkeypatch.delenv("WNDSP_LIB", raising=False)
    monkeypatch.setattr(p_native, "_TRIED", False)
    monkeypatch.setattr(p_native, "_LIB", None)
    made = [p for p in (_build.NATIVE_SRC.parent / "libwndsp.so",
                        _build.PKG_DIR / "libwndsp.so") if p.exists()]
    assert p_native.lib_path() == str(made[0] if made else lib)
    assert os.path.basename(p_native.lib_path()).startswith("libwndsp")
