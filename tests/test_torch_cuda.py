"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
On a machine with an NVIDIA Hopper GPU and nvcc (``--noconftest``: the
suite's conftest imports jax, which these tests do not need):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _cfg(**kw):
    base = dict(n_quantize=256, n_aux=28, n_resch=128, n_skipch=128,
                dilation_depth=4, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(kw)
    return P.WaveNetConfig(**base)


def _params(cfg, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = P.init_wavenet_params(cfg, gen, dev)
    for group in ("dil", "aux", "res", "skip"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen).to(dev)
    return params


def test_layer_stack_kernel_matches_plain(dev):
    cfg = _cfg()
    params = _params(cfg, dev)
    rng = np.random.RandomState(0)
    B, T = 3, 700   # T not a multiple of the kernel's 32-row tile
    s0 = torch.as_tensor(rng.randn(B, T, cfg.n_resch) * 0.5,
                         dtype=torch.bfloat16, device=dev)
    h = torch.as_tensor(rng.randn(B, T, cfg.n_aux), dtype=torch.float32,
                        device=dev)
    lw = tk.layer_weights(params)
    before = tk.layer_stack_streams.launches
    got = tk.layer_stack_streams(lw, cfg, s0, h)
    assert tk.layer_stack_streams.launches == before + 1
    hb = h.to(torch.bfloat16)
    for l in range(1, cfg.n_layers):
        want, _ = tk.ref_layer(lw, l - 1, cfg.dilations[l - 1], got[l - 1], hb)
        # one layer on the same input: a bf16 ulp where sums round apart
        d = (got[l].float() - want.float()).abs()
        assert d.max().item() <= 1e-2 * want.float().abs().max().item()
        assert (d > 0).float().mean().item() <= 1e-2


# B=1: one partial row tile; 20: two tiles, the second partial; 65: two
# 64-row chunks on the kernels' second grid axis, the second of one row
@pytest.mark.parametrize("B", [1, 20, 65])
def test_ar_kernel_matches_plain(dev, B):
    cfg = _cfg()
    params = _params(cfg, dev, seed=1)
    rng = np.random.RandomState(1)
    n = 24
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)),
                        device=dev)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32, device=dev)
    carry = P._warmup_state(params, cfg, x, h, bf16_intermediates=True,
                            impl="cuda")
    T0 = x.shape[1]
    agree = []
    cp = tuple(t.clone() for t in carry)
    for i in range(n):
        ck = tuple(t.clone() for t in cp)
        sk = ak.ar_generate(params, cfg, ck, h, T0 + i, 1, "argmax")
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i)
        ring = (ck[0].float() - cp[0].float()).abs().max().item()
        assert ring <= 2e-2 * cp[0].float().abs().max().item()
        agree.append((sk == sp).float().mean().item())
    assert np.mean(agree) >= 0.97

    def sample(seed):
        return ak.ar_generate(params, cfg, tuple(t.clone() for t in carry), h,
                              T0, n, "sampling",
                              torch.Generator().manual_seed(seed))

    s = sample(0)
    assert s.shape == (B, n) and s.min() >= 0 and s.max() < 256
    assert torch.equal(s, sample(0))          # the seed fixes the stream
    assert not torch.equal(s, sample(1))


def test_cuda_path_raises_outside_envelope(dev):
    for cfg in (_cfg(kernel_size=3), _cfg(compute_dtype="float32"),
                _cfg(n_resch=1152)):
        params = _params(cfg, dev)
        x = np.zeros((2, 1), np.int32)
        h = np.zeros((2, 40, cfg.n_aux), np.float32)
        with pytest.raises(NotImplementedError):
            P.batch_fast_generate(params, cfg, x, h, [10, 10], impl="cuda")


def test_batch_fast_generate_cuda_runs_both_kernels(dev):
    cfg = _cfg(upsampling_factor=10)
    params = _params(cfg, dev, seed=2)
    rng = np.random.RandomState(2)
    x = np.full((3, 1), 128, np.int32)
    h = rng.randn(3, 6, cfg.n_aux).astype(np.float32)
    k1, k2 = ak.ar_generate.launches, tk.layer_stack_streams.launches
    out = P.batch_fast_generate(params, cfg, x, h, [59, 40, 20],
                                mode="sampling",
                                generator=torch.Generator().manual_seed(3))
    assert [len(o) for o in out] == [59, 40, 20]
    assert ak.ar_generate.launches == k1 + 1
    assert tk.layer_stack_streams.launches == k2 + 1
