"""The port's training input and CLI against the JAX package: the same
train_generator windows for the same files and seed, the same utterance
buckets, and ``bin/train.py`` training a tiny wav/h5 corpus on the CPU into
a bundle the port's decoder reads, resuming from it, refusing what is not
ported."""

import itertools
import os

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu.bin import train as jax_train
from pytorchwavenetvocoder_tpu.data import train_generator as jax_generator
from pytorchwavenetvocoder_tpu.ops.mulaw import encode_mu_law as jax_mulaw

from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.bin import train as torch_train
from pytorchwavenetvocoder_tpu_torch.data import train_generator
from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import load_checkpoint
from pytorchwavenetvocoder_tpu_torch.utils import (
    read_hdf5,
    read_wav,
    write_hdf5,
    write_wav,
)

torch.set_num_threads(2)

N_AUX, UF = 4, 80


def _corpus(tmp_path, lengths=(4000, 6400, 5200)):
    """Sine-plus-noise wavs at 16 kHz, random WORLD-like features at one
    frame per UF samples (a frame more or less than the wav covers, as
    real extraction leaves), and stats."""
    rng = np.random.RandomState(0)
    wavdir, featdir = tmp_path / "wav", tmp_path / "hdf5"
    os.makedirs(wavdir, exist_ok=True)
    for i, n in enumerate(lengths):
        t = np.arange(n)
        wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t / 16000) \
            + 0.01 * rng.randn(n)
        write_wav(str(wavdir / f"u{i}.wav"), wav.astype(np.float32), 16000)
        frames = n // UF + (i % 3) - 1
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(frames, N_AUX).astype(np.float32))
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", (0.1 * rng.randn(N_AUX)).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(N_AUX)).astype(np.float32))
    wavs = sorted(str(wavdir / f) for f in os.listdir(wavdir))
    feats = [w.replace(str(wavdir), str(featdir)).replace(".wav", ".h5")
             for w in wavs]
    return str(wavdir), str(featdir), stats, wavs, feats


# mini-batch windows with and without the learned upsampler, and whole
# utterances (B=1)
@pytest.mark.parametrize("batch_length, use_layer, batch_size",
                         [(400, True, 2), (300, False, 3), (None, True, 1)])
def test_train_generator_matches_jax(tmp_path, batch_length, use_layer,
                                     batch_size):
    _, _, _, wavs, feats = _corpus(tmp_path)
    common = dict(receptive_field=8, batch_length=batch_length,
                  batch_size=batch_size, upsampling_factor=UF,
                  use_upsampling_layer=use_layer, shuffle=True, seed=3)
    want = jax_generator(wavs, feats, wav_transform=jax_mulaw, **common)
    got = train_generator(wavs, feats, wav_transform=encode_mu_law, **common)
    for (wx, wh), wt in itertools.islice(want, 8):   # over epoch boundaries
        (gx, gh), gt = next(got)
        for a, b in ((wx, gx), (wh, gh), (wt, gt)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_length_buckets_match_jax():
    for n in list(range(1, 70)) + [96, 100, 1000, 4097]:
        assert torch_train._length_bucket(n) == jax_train._length_bucket(n)
    rng = np.random.RandomState(1)
    for uf, T, frames in ((8, 400, 50), (0, 97, 97), (0, 128, 128)):
        bx = rng.randint(0, 256, (1, T)).astype(np.int32)
        bt = rng.randint(0, 256, (1, T)).astype(np.int32)
        bh = rng.randn(1, frames, 3).astype(np.float32)
        want = jax_train._pad_utterance_batch(bx, bh, bt, uf)
        got = torch_train._pad_utterance_batch(bx, bh, bt, uf)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def _train_argv(tmp_path, *extra):
    wavdir, featdir, stats, _, _ = _corpus(tmp_path)
    return [
        "--waveforms", wavdir, "--feats", featdir, "--stats", stats,
        "--expdir", str(tmp_path / "exp"), "--n_aux", str(N_AUX),
        "--n_resch", "16", "--n_skipch", "16", "--dilation_depth", "3",
        "--dilation_repeat", "1", "--upsampling_factor", str(UF),
        "--batch_length", "400", "--batch_size", "2", "--lr", "1e-3",
        "--intervals", "2", "--checkpoint_interval", "3", "--device", "cpu",
        "--verbose", "0", *extra]


def test_train_cli_writes_a_bundle_the_decoder_reads(tmp_path):
    argv = _train_argv(tmp_path, "--iters", "12",
                       "--profile_dir", str(tmp_path / "prof"))
    res = torch_train.main(argv)
    expdir = tmp_path / "exp"
    assert res["start"] == 0 and res["state"].step == 12
    assert res["route"] == "plain"                  # auto on the CPU
    assert [i for i, _, _ in res["intervals"]] == [2, 4, 6, 8, 10, 12]
    assert all(np.isfinite(l) for _, l, _ in res["intervals"])
    names = set(os.listdir(expdir))
    assert {"model.conf", "checkpoint-3.pkl", "checkpoint-12.pkl",
            "checkpoint-final.pkl", "checkpoint-final.pkl.iter"} <= names
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    payload = load_checkpoint(str(expdir / "checkpoint-final.pkl"))
    assert payload["iterations"] == 12
    assert int(payload["optimizer"]["adam_moments"]["count"]) == 12
    assert payload["model"]["dil"]["w"].dtype == np.float32

    featdir = str(tmp_path / "hdf5")
    out = str(tmp_path / "gen")
    dec = torch_decode.main([
        "--feats", featdir, "--stats", str(tmp_path / "stats.h5"),
        "--checkpoint", str(expdir / "checkpoint-final.pkl"),
        "--config", str(expdir), "--outdir", out, "--batch_size", "3",
        "--device", "cpu", "--verbose", "0"])
    assert dec["n_utts"] == 3
    for f in sorted(os.listdir(featdir)):
        wav, fs = read_wav(os.path.join(out, f.replace(".h5", ".wav")))
        frames = read_hdf5(os.path.join(featdir, f), "/world").shape[0]
        assert fs == 16000 and wav.shape == (frames * UF - 1,)
        assert np.isfinite(wav).all()


def test_train_cli_resumes_latest(tmp_path):
    torch_train.main(_train_argv(tmp_path, "--iters", "4"))
    res = torch_train.main(_train_argv(tmp_path, "--iters", "6",
                                       "--resume", "latest"))
    assert res["start"] == 4 and res["state"].step == 6
    assert load_checkpoint(str(tmp_path / "exp" / "checkpoint-final.pkl")
                           )["iterations"] == 6


@pytest.mark.parametrize("extra, error, match", [
    # each rank trains batch_size / n_devices rows: a batch the ranks do not
    # divide trains on one rank, with the JAX CLI's warning (error None)
    (["--n_devices", "2", "--batch_size", "3"], None,
     "batch size 3 not divisible by 2 devices; falling back to single "
     "device."),
    (["--model_parallel", "2"], NotImplementedError, "not yet ported"),
    (["--fused", "true", "--compute_dtype", "float32"], ValueError,
     "bfloat16"),
    (["--fused", "true"], ValueError, "envelope"),   # 16 channels
])
def test_train_cli_refuses(tmp_path, caplog, extra, error, match):
    argv = _train_argv(tmp_path, "--iters", "1", *extra)
    if error is None:
        res = torch_train.main(argv)
        assert "ranks" not in res and res["state"].step == 1
        assert match in caplog.text
        return
    with pytest.raises(error, match=match):
        torch_train.main(argv)
