"""The plain reference agrees with the program's plain PyTorch path at a
small width (this test may import both; the reference imports nothing of
the program), and its mu-law table is the wav writer's."""

import os

import numpy as np
import pytest
import torch

from port_bench import checks, spec, weights
from port_bench import traffic as tr
from port_bench.reference import wavenet as ref
from port_bench.tests import tiny


@pytest.mark.parametrize("k", [2, 3])
def test_forward_matches_the_program(k):
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        WaveNetConfig,
        wavenet_forward,
    )

    cfg = dict(tiny.CONFIG, kernel_size=k)
    p = weights.make_params(cfg, 3, "cpu")
    x, h, _t = tr.train_window(dict(cfg, batch_length=60), 3, 0)
    xt = torch.as_tensor(x[None]).long()
    ht = torch.as_tensor(h[None])
    wcfg = WaveNetConfig(**{key: cfg[key] for key in
                            ("n_quantize", "n_aux", "n_resch", "n_skipch",
                             "dilation_depth", "dilation_repeat",
                             "kernel_size", "upsampling_factor",
                             "compute_dtype")})
    want = wavenet_forward(p, wcfg, xt, ht)
    got = ref.forward(p, cfg, xt, ref.upsample(p, ht, cfg["upsampling_factor"]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_adam_is_torch_s():
    torch.manual_seed(0)
    w = torch.randn(5, 3)
    grads = [torch.randn(5, 3) for _ in range(3)]
    p = {"g": {"w": w.clone()}}
    opt = ref.Adam(1e-3)
    tw = w.clone().requires_grad_(True)
    topt = torch.optim.Adam([tw], lr=1e-3)
    for g in grads:
        opt.step(p, {("g", "w"): g})
        tw.grad = g.clone()
        topt.step()
    torch.testing.assert_close(p["g"]["w"], tw.detach(), rtol=0, atol=1e-7)


def test_mulaw_table_is_the_wav_writer_s(tmp_path):
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law
    from pytorchwavenetvocoder_tpu_torch.utils import write_wav

    classes = np.arange(256)
    path = os.path.join(tmp_path, "a.wav")
    write_wav(path, decode_mu_law(classes, 256).astype(np.float32), 16000)
    cfg = dict(fs=16000, n_quantize=256)
    read_served = spec.architecture(cfg).read_served
    np.testing.assert_array_equal(read_served(cfg, path, 256), classes)
    assert len(set(ref.mulaw_pcm_table(256).tolist())) == 256
    assert read_served(cfg, path, 255) is None
    assert read_served(dict(cfg, fs=22050), path, 256) is None


def test_fp8_control_moves_the_numbers():
    cfg = tiny.CONFIG
    sound = checks.reference_steps(cfg, tiny.TRAIN, 4, 1, "cpu")
    fp8 = checks.reference_steps(cfg, tiny.TRAIN, 4, 1, "cpu",
                                 mm=ref.fp8_matmul)
    theta0 = weights.make_params(cfg, 4, "cpu", bf16_values=False)
    after = {k: fp8["params"][k[0]][k[1]] for k in ref.leaves(theta0)}
    got = spec.architecture(cfg).train_numbers(fp8["losses"], fp8["grad1"],
                                               after, theta0, sound)
    assert got["grad_gap"] > 1e-2


def test_philox_is_the_published_philox4x32_10():
    from port_bench.reference.sampler import philox4x32_10

    # known-answer vectors of Random123's kat_vectors (philox4x32 10 rounds)
    for ctr, key, want in [
            ((0, 0, 0, 0), (0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
             (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]:
        got = philox4x32_10(*[torch.tensor(c, dtype=torch.int64)
                              for c in ctr], key)
        assert tuple(int(w) for w in got) == want


def test_kernel_noise_reads_the_word_of_each_class():
    import math

    from port_bench.reference.sampler import kernel_noise, philox4x32_10

    seed, row, Q = 2 ** 61 + 12345, 7, 10
    noise = kernel_noise(seed, row, 5, Q, "cpu")
    assert noise.shape == (5, Q) and noise.dtype == torch.float32
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    for step, cls in [(0, 0), (3, 5), (4, 9)]:
        w = int(philox4x32_10(t(cls // 4), t(row), t(step), t(0),
                              (seed % 2 ** 32, seed // 2 ** 32))[cls % 4])
        u = ((w >> 9) + 0.5) * 2.0 ** -23
        assert float(noise[step, cls]) == pytest.approx(
            -math.log(-math.log(u)), rel=1e-6)
