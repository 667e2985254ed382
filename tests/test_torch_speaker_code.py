"""The speaker-code path against the JAX package: ``/speaker_code`` read
from the feature files and tiled as one more aux column after the
features, which the stats do not cover and the scaler passes through; the
port's generator and scaler as the JAX package's
(tests/test_generator.py's two speaker-code tests, on the same files), and
both CLIs with ``--use_speaker_code true``: each resumes the other's
bundle, and their argmax decodes write byte-equal wavs."""

import json
import os

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu.bin import decode as jax_decode
from pytorchwavenetvocoder_tpu.bin import train as jax_train
from pytorchwavenetvocoder_tpu.data import train_generator as jax_generator
from pytorchwavenetvocoder_tpu.ops.mulaw import encode_mu_law as jax_mulaw
from pytorchwavenetvocoder_tpu.ops.scaler import (
    StandardScaler as JaxScaler,
    feature_transform as jax_feature_transform,
)

from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.bin import train as torch_train
from pytorchwavenetvocoder_tpu_torch.data import train_generator
from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
from pytorchwavenetvocoder_tpu_torch.ops.scaler import (
    StandardScaler,
    feature_transform,
)
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import load_checkpoint
from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5, write_wav

torch.set_num_threads(2)

#: feature dims (the stats') and the aux width with the speaker code
N_FEAT, UF = 28, 80


def _dataset(tmp_path, n=2, n_feat=N_FEAT, uf=UF):
    """tests/test_generator.py's make_dataset (random wavs of 0.4-0.7 s at
    16 kHz, WORLD-like features a frame per ``uf`` samples), with
    ``/speaker_code`` i written into file i."""
    rng = np.random.RandomState(0)
    wav_list, feat_list = [], []
    for i in range(n):
        T = int(16000 * rng.uniform(0.4, 0.7))
        wav, feat = str(tmp_path / f"utt{i}.wav"), str(tmp_path / f"utt{i}.h5")
        write_wav(wav, rng.uniform(-0.5, 0.5, T).astype(np.float32), 16000)
        write_hdf5(feat, "/world",
                   rng.randn(T // uf + 1, n_feat).astype(np.float32))
        write_hdf5(feat, "/speaker_code", np.asarray([float(i)], np.float32))
        wav_list.append(wav)
        feat_list.append(feat)
    return wav_list, feat_list


def _windows(gen, n):
    return [next(gen) for _ in range(n)]


def _same_windows(want, got):
    for ((wx, wh), wt), ((gx, gh), gt) in zip(want, got):
        for a, b in ((wx, gx), (wh, gh), (wt, gt)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_train_generator_speaker_code(tmp_path):
    """``use_speaker_code`` appends the tiled /speaker_code column (JAX
    tests/test_generator.py::test_train_generator_speaker_code): the same
    windows as the JAX generator's, over both utterances and an epoch
    boundary."""
    wav_list, feat_list = _dataset(tmp_path)
    common = dict(receptive_field=100, batch_length=500, batch_size=1,
                  upsampling_factor=UF, use_upsampling_layer=True,
                  use_speaker_code=True, shuffle=False, seed=0)
    got = _windows(train_generator(wav_list, feat_list,
                                   wav_transform=encode_mu_law, **common), 60)
    (bx, bh), bt = got[0]
    assert bh.shape[2] == N_FEAT + 1
    assert np.all(bh[0, :, N_FEAT] == bh[0, 0, N_FEAT])
    want = _windows(jax_generator(wav_list, feat_list,
                                  wav_transform=jax_mulaw, **common), 60)
    _same_windows(want, got)
    # each utterance's own code
    assert {float(w[0][1][0, 0, N_FEAT]) for w in got} == {0.0, 1.0}


def test_feature_transform_passes_speaker_code_through(tmp_path):
    """The stats cover only the feature dims; the speaker-code column
    appended after passes through unscaled (JAX
    tests/test_generator.py::test_feature_transform_passes_speaker_code_through):
    the port's transform gives the JAX one's values, refuses the same
    widths, and the generator with it gives the JAX generator's windows."""
    mine, theirs = StandardScaler(), JaxScaler()
    for s in (mine, theirs):
        s.mean_ = np.full(N_FEAT, 2.0)
        s.scale_ = np.full(N_FEAT, 4.0)
    tf, jtf = feature_transform(mine), jax_feature_transform(theirs)
    h = np.random.RandomState(1).randn(5, N_FEAT + 1).astype(np.float32)
    out = tf(h)
    np.testing.assert_array_equal(out, jtf(h))
    np.testing.assert_allclose(out[:, :N_FEAT], (h[:, :N_FEAT] - 2.0) / 4.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(out[:, N_FEAT], h[:, N_FEAT])   # untouched
    np.testing.assert_array_equal(tf(np.ones((5, N_FEAT))),
                                  jtf(np.ones((5, N_FEAT))))
    for width in (N_FEAT - 1, N_FEAT + 2):
        for t in (tf, jtf):
            with pytest.raises(ValueError):
                t(np.ones((5, width)))

    wav_list, feat_list = _dataset(tmp_path)
    common = dict(receptive_field=100, batch_length=500, batch_size=1,
                  upsampling_factor=UF, use_upsampling_layer=True,
                  use_speaker_code=True, shuffle=False, seed=0)
    got = _windows(train_generator(wav_list, feat_list,
                                   wav_transform=encode_mu_law,
                                   feat_transform=tf, **common), 4)
    want = _windows(jax_generator(wav_list, feat_list,
                                  wav_transform=jax_mulaw,
                                  feat_transform=jtf, **common), 4)
    _same_windows(want, got)
    bh = got[0][0][1]
    assert bh.shape[2] == N_FEAT + 1
    assert np.all(np.abs(bh[0, :, N_FEAT]) <= 1.0)   # code column unscaled


# ---------------------------------------------------------------------------
# the two CLIs
# ---------------------------------------------------------------------------

#: a small corpus's feature dims; the models' n_aux is one more
CLI_FEAT = 4


def _corpus(tmp_path):
    """Sine-plus-noise wavs at 16 kHz, WORLD-like features (a frame more or
    less than the wav covers), /speaker_code per file (two speakers) and
    stats over the feature dims only."""
    rng = np.random.RandomState(0)
    wavdir, featdir = tmp_path / "wav", tmp_path / "hdf5"
    os.makedirs(wavdir, exist_ok=True)
    for i, n in enumerate((4000, 6400, 5200)):
        t = np.arange(n)
        wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t / 16000) \
            + 0.01 * rng.randn(n)
        write_wav(str(wavdir / f"u{i}.wav"), wav.astype(np.float32), 16000)
        feat = str(featdir / f"u{i}.h5")
        write_hdf5(feat, "/world", rng.randn(n // UF + (i % 3) - 1,
                                             CLI_FEAT).astype(np.float32))
        write_hdf5(feat, "/speaker_code", np.asarray([float(i % 2)],
                                                     np.float32))
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean",
               (0.1 * rng.randn(CLI_FEAT)).astype(np.float32))
    write_hdf5(stats, "/world/scale",
               (1 + rng.rand(CLI_FEAT)).astype(np.float32))
    return str(wavdir), str(featdir), stats


def _train_argv(corpus, expdir, iters, *extra):
    wavdir, featdir, stats = corpus
    return ["--waveforms", wavdir, "--feats", featdir, "--stats", stats,
            "--expdir", expdir, "--use_speaker_code", "true",
            "--n_aux", str(CLI_FEAT + 1), "--n_resch", "16",
            "--n_skipch", "16", "--dilation_depth", "3",
            "--dilation_repeat", "1", "--upsampling_factor", str(UF),
            "--batch_length", "400", "--batch_size", "2", "--lr", "1e-3",
            "--compute_dtype", "float32", "--intervals", "2",
            "--checkpoint_interval", "100", "--iters", str(iters),
            "--verbose", "0", *extra]


def _iterations(expdir):
    return load_checkpoint(os.path.join(expdir, "checkpoint-final.pkl")
                           )["iterations"]


def test_speaker_code_clis_resume_each_other_and_decode_alike(tmp_path):
    corpus = _corpus(tmp_path)
    exp_port, exp_jax = str(tmp_path / "exp_port"), str(tmp_path / "exp_jax")
    # the port trains; the JAX CLI resumes its bundle
    res = torch_train.main(_train_argv(corpus, exp_port, 4, "--device",
                                       "cpu"))
    assert res["state"].step == 4 and res["route"] == "plain"
    assert all(np.isfinite(l) for _, l, _ in res["intervals"])
    conf = json.load(open(os.path.join(exp_port, "model.conf")))
    assert conf["use_speaker_code"] is True
    assert conf["n_aux"] == CLI_FEAT + 1
    jax_train.main(_train_argv(corpus, exp_port, 6, "--resume", "latest"))
    assert _iterations(exp_port) == 6
    # the JAX CLI trains; the port resumes its bundle
    jax_train.main(_train_argv(corpus, exp_jax, 4))
    assert _iterations(exp_jax) == 4
    res = torch_train.main(_train_argv(corpus, exp_jax, 6, "--resume",
                                       "latest", "--device", "cpu"))
    assert res["start"] == 4 and res["state"].step == 6
    assert _iterations(exp_jax) == 6

    # argmax decodes of the bundle both trained, its conf in float64 (the
    # byte-equal decode tests' dtype), through each CLI's speaker-code path
    conf = json.load(open(os.path.join(exp_port, "model.conf")))
    conf["compute_dtype"] = "float64"
    with open(os.path.join(exp_port, "model.conf"), "w") as f:
        json.dump(conf, f)
    _wavdir, featdir, stats = corpus
    common = ["--feats", featdir, "--stats", stats, "--checkpoint",
              os.path.join(exp_port, "checkpoint-final.pkl"), "--config",
              exp_port, "--batch_size", "2", "--fs", "16000", "--mode",
              "argmax", "--verbose", "0"]
    out_jax, out_torch = str(tmp_path / "wav_jax"), str(tmp_path / "wav_torch")
    jax_decode.main(common + ["--outdir", out_jax])
    dec = torch_decode.main(common + ["--outdir", out_torch, "--device",
                                      "cpu"])
    names = ["u0.wav", "u1.wav", "u2.wav"]
    assert sorted(os.listdir(out_jax)) == names
    assert sorted(os.listdir(out_torch)) == names
    for n in names:
        with open(os.path.join(out_jax, n), "rb") as f:
            want = f.read()
        with open(os.path.join(out_torch, n), "rb") as f:
            assert f.read() == want, n
    assert dec["n_utts"] == 3
