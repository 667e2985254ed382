"""The slice end to end on the CPU: a bundle written by the JAX package is
decoded by the port's ``bin/decode.py`` and by the JAX one, in argmax mode
at f64; the wav files are byte-identical."""

import os

import numpy as np
import pytest
import torch

import jax

from pytorchwavenetvocoder_tpu.bin import decode as jax_decode
from pytorchwavenetvocoder_tpu.models.wavenet import WaveNetConfig
from pytorchwavenetvocoder_tpu.parallel import (
    create_train_state,
    save_checkpoint,
    save_model_conf,
)
from pytorchwavenetvocoder_tpu.utils import write_hdf5

from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode

torch.set_num_threads(2)


def _bundle(tmp_path, n_aux=8, uf=10, kernel_size=2):
    cfg = WaveNetConfig(n_aux=n_aux, n_resch=16, n_skipch=16,
                        dilation_depth=4, dilation_repeat=1,
                        kernel_size=kernel_size,
                        upsampling_factor=uf, compute_dtype="float64")
    state = create_train_state(jax.random.PRNGKey(0), cfg, lr=1e-3)
    expdir = tmp_path / "exp"
    ckpt = save_checkpoint(str(expdir), state, iterations=3)
    save_model_conf(str(expdir), dict(cfg.to_dict(), feature_type="world",
                                      use_upsampling_layer=True,
                                      use_speaker_code=False))
    rng = np.random.RandomState(0)
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", (rng.randn(n_aux) * 0.1).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(n_aux)).astype(np.float32))
    featdir = tmp_path / "feats"
    for i, frames in enumerate([5, 3, 4]):
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(frames, n_aux).astype(np.float32))
    return ckpt, str(expdir), stats, str(featdir)


def test_port_decode_wavs_byte_identical_to_jax(tmp_path):
    ckpt, expdir, stats, featdir = _bundle(tmp_path)
    common = ["--feats", featdir, "--stats", stats, "--checkpoint", ckpt,
              "--config", expdir, "--batch_size", "2", "--fs", "16000",
              "--mode", "argmax", "--verbose", "0"]
    out_jax, out_torch = str(tmp_path / "wav_jax"), str(tmp_path / "wav_torch")
    jax_decode.main(common + ["--outdir", out_jax])
    res = torch_decode.main(common + ["--outdir", out_torch,
                                      "--device", "cpu"])
    names = sorted(os.listdir(out_jax))
    assert names == ["u0.wav", "u1.wav", "u2.wav"]
    assert sorted(os.listdir(out_torch)) == names
    for n in names:
        with open(os.path.join(out_jax, n), "rb") as f:
            want = f.read()
        with open(os.path.join(out_torch, n), "rb") as f:
            assert f.read() == want, n
    assert res["n_utts"] == 3
    assert res["n_samples"] == (5 + 3 + 4) * 10 - 3


def test_port_decode_sampling_runs_and_refuses_unported_flags(tmp_path):
    ckpt, expdir, stats, featdir = _bundle(tmp_path)
    common = ["--feats", featdir, "--stats", stats, "--checkpoint", ckpt,
              "--config", expdir, "--batch_size", "3", "--verbose", "0",
              "--device", "cpu"]
    out = str(tmp_path / "wav")
    res = torch_decode.main(common + ["--outdir", out, "--mode", "sampling",
                                      "--intervals", "7"])
    assert res["n_utts"] == 3 and len(os.listdir(out)) == 3
    # a rank per CUDA device: more ranks than devices (none here) raise,
    # naming the count, before any rank starts
    with pytest.raises(ValueError, match="device_count"):
        torch_decode.main(common[:-2] + ["--outdir", out, "--n_devices", "2",
                                         "--device", "cuda"])
    # --quantize decodes kernel_size 2 and 3 (tests/test_torch_int8.py);
    # int8 with kernel_size 4 is refused, by name, before any work
    ckpt4, expdir4, stats4, featdir4 = _bundle(tmp_path / "k4", kernel_size=4)
    with pytest.raises(NotImplementedError, match="kernel_size=4"):
        torch_decode.main(["--feats", featdir4, "--stats", stats4,
                           "--checkpoint", ckpt4, "--config", expdir4,
                           "--verbose", "0", "--device", "cpu", "--outdir",
                           out, "--quantize"])
