"""The port's CUDA kernels (the AR loop in bf16 and int8, the layer stack's
warm-up and training forward, its backward, the matmul-chain probe) against
their plain PyTorch versions, on the card.

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
from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc
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


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_layer_stack_kernel_matches_plain(dev, kernel_size):
    cfg = _cfg(kernel_size=kernel_size)
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
# 64-row chunks on the kernels' second grid axis, the second of one row;
# kernel_size 3 (raw rings, the lag gather) at each
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("B", [1, 20, 65])
def test_ar_kernel_matches_plain(dev, B, kernel_size):
    cfg = _cfg(kernel_size=kernel_size)
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


# the fleets of the bf16 test: one partial row tile, two, two 64-row chunks
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("B", [1, 20, 65])
def test_ar_int8_kernel_matches_plain(dev, B, kernel_size):
    """K1-int8 against the plain int8 loop on the same carry and scales:
    the integer products are exact in both and the epilogues round alike,
    so only the aux sum's order and the sigmoid/tanh differ (an f32 ulp).
    Where that flips an int8 value, the rest of the row's layers move by
    int8 quanta: a minority of the ring values a step writes differ, each
    by a few quanta (max|d| <= 5e-2 of max|ring|, share <= 0.25).
    kernel_size 3 runs on the int8 ring of ``int8_ring_fill``."""
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=5)
    rng = np.random.RandomState(5)
    n = 24
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)),
                        device=dev)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32, device=dev)
    carry, maxes = P._warmup_state(params, cfg, x, h, bf16_intermediates=True,
                                   collect_act_maxes=True, impl="cuda")
    scales = ak.act_scales_from_maxes(maxes)
    if kernel_size == 3:
        carry = (ak.int8_ring_fill(carry[0], scales, cfg),) + carry[1:]
    T0 = x.shape[1]
    caps, offs, _ = P._buffer_layout(cfg)
    agree = []
    cp = tuple(t.clone() for t in carry)
    for i in range(n):
        ck = tuple(t.clone() for t in cp)
        before = ak.ar_generate.int8_launches
        sk = ak.ar_generate(params, cfg, ck, h, T0 + i, 1, "argmax",
                            quantize=True, act_scales=scales)
        assert ak.ar_generate.int8_launches == before + 1
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i, quantize=True, act_scales=scales)
        p = T0 - 1 + i
        rows = [o + p % c for o, c in zip(offs, caps)]
        want = cp[0][rows].float()
        d = (ck[0][rows].float() - want).abs()
        assert d.max().item() <= 5e-2 * want.abs().max().item()
        assert (d > 0).float().mean().item() <= 0.25
        rest = torch.ones(ck[0].shape[0], dtype=torch.bool, device=dev)
        rest[rows] = False
        assert torch.equal(ck[0][rest], cp[0][rest])   # other slots untouched
        agree.append((sk == sp).float().mean().item())
    assert np.mean(agree) >= 0.97

    def sample(seed):
        return ak.ar_generate(params, cfg, tuple(t.clone() for t in carry), h,
                              T0, n, "sampling",
                              torch.Generator().manual_seed(seed),
                              quantize=True, act_scales=scales)

    s = sample(0)
    assert s.shape == (B, n) and s.min() >= 0 and s.max() < 256
    assert torch.equal(s, sample(0))
    assert not torch.equal(s, sample(1))


def test_int8_refusals(dev):
    cfg = _cfg(kernel_size=4)
    params = _params(cfg, dev)
    x = np.zeros((2, 1), np.int32)
    h = np.zeros((2, 40, cfg.n_aux), np.float32)
    with pytest.raises(NotImplementedError, match="int8"):
        P.batch_fast_generate(params, cfg, x, h, [10, 10], impl="cuda",
                              quantize=True)
    cfg = _cfg()
    params = _params(cfg, dev)
    xt = torch.zeros((2, cfg.receptive_field), dtype=torch.int64, device=dev)
    ht = torch.zeros((2, cfg.receptive_field + 4, cfg.n_aux), device=dev)
    carry = P._warmup_state(params, cfg, xt, ht, bf16_intermediates=True,
                            impl="cuda")
    with pytest.raises(ValueError, match="act_scales"):
        ak.ar_generate(params, cfg, carry, ht, xt.shape[1], 4, "argmax",
                       quantize=True)
    with pytest.raises(ValueError, match="act_scales"):
        ak.ar_generate(params, cfg, carry, ht, xt.shape[1], 4, "argmax",
                       quantize=True,
                       act_scales=torch.zeros((cfg.n_layers, 1), device=dev))


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_batch_fast_generate_int8_runs_k1_int8(dev, kernel_size):
    cfg = _cfg(upsampling_factor=10, kernel_size=kernel_size)
    params = _params(cfg, dev, seed=6)
    rng = np.random.RandomState(6)
    x = np.full((3, 1), 128, np.int32)
    h = rng.randn(3, 6, cfg.n_aux).astype(np.float32)
    k1, k1q = ak.ar_generate.launches, ak.ar_generate.int8_launches
    k2 = tk.layer_stack_streams.launches
    out = P.batch_fast_generate(params, cfg, x, h, [59, 40, 20],
                                mode="argmax", quantize=True)
    assert [len(o) for o in out] == [59, 40, 20]
    assert ak.ar_generate.int8_launches == k1q + 1
    assert ak.ar_generate.launches == k1
    assert tk.layer_stack_streams.launches == k2 + 1


def test_cuda_path_raises_outside_envelope(dev):
    for cfg in (_cfg(kernel_size=4), _cfg(compute_dtype="float32"),
                _cfg(n_resch=1152)):
        params = _params(cfg, dev)
        x = np.zeros((2, 1), np.int32)
        h = np.zeros((2, 40, cfg.n_aux), np.float32)
        with pytest.raises(NotImplementedError):
            P.batch_fast_generate(params, cfg, x, h, [10, 10], impl="cuda")


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_batch_fast_generate_cuda_runs_both_kernels(dev, kernel_size):
    cfg = _cfg(upsampling_factor=10, kernel_size=kernel_size)
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


def _cos_rel(want, got):
    a, b = want.double().flatten(), got.double().flatten()
    cos = (a @ b / (a.norm() * b.norm() + 1e-30)).item()
    rel = ((a - b).abs().max() / (a.abs().max() + 1e-9)).item()
    return cos, rel


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_train_kernels_match_plain(dev, kernel_size):
    """K2 training mode and K3 at a ragged T (not a multiple of the 32-row
    tile) and B=3, against their plain versions on the same inputs."""
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=4)
    rng = np.random.RandomState(4)
    B, T = 3, 700
    s0 = torch.as_tensor(rng.randn(B, T, cfg.n_resch) * 0.5,
                         dtype=torch.bfloat16, device=dev)
    h = torch.as_tensor(rng.randn(B, T, cfg.n_aux), dtype=torch.float32,
                        device=dev)
    dskip = torch.as_tensor(rng.randn(B, T, cfg.n_skipch),
                            dtype=torch.float32, device=dev)
    lw = tk.layer_weights(params)
    n_fwd, n_bwd = tk.layer_stack_fwd_train.launches, tk.layer_stack_bwd.launches
    skip, streams, st = tk.layer_stack_fwd_train(lw, cfg, s0, h)
    assert tk.layer_stack_fwd_train.launches == n_fwd + 1
    # each layer on the kernel's own input stream: sigma, tanh and the
    # stream move by at most a bf16 ulp, where sums round apart
    hb, x = h.to(torch.bfloat16), s0
    skip_ref = torch.zeros_like(skip)
    for l, d in enumerate(cfg.dilations):
        s, t = tk._ref_gate(lw, l, d, x, hb)
        want = torch.cat([s, t], -1).to(torch.bfloat16).float()
        diff = (st[l].float() - want).abs()
        assert diff.max().item() <= 2 ** -8 and (diff > 0).float().mean() <= 1e-2
        g = (s * t).to(torch.bfloat16)
        skip_ref += P._dot(g, lw["skip_w"][l].to(torch.bfloat16)) + lw["skip_b"][l]
        if l < cfg.n_layers - 1:
            want = tk._ref_res(lw, l, g, x).float()
            diff = (streams[l].float() - want).abs()
            assert diff.max().item() <= 1e-2 * want.abs().max().item()
            assert (diff > 0).float().mean().item() <= 1e-2
            x = streams[l]
    assert _cos_rel(skip_ref, skip)[1] <= 1e-2
    # K3 on the kernel's saves: only summation order differs; dz flips by a
    # bf16 ulp chain through the bf16 dx of 8 layers
    got = tk.layer_stack_bwd(lw, cfg, s0, streams, st, h, dskip)
    assert tk.layer_stack_bwd.launches == n_bwd + 1
    ref = tk.ref_layer_stack_bwd(lw, cfg, s0, streams, st, h, dskip)
    pairs = [(k, ref[0][k], got[0][k]) for k in ref[0]]
    pairs += [("stream0", ref[1], got[1]), ("h_up", ref[2], got[2])]
    for name, want, mine in pairs:
        assert mine.dtype == want.dtype and mine.shape == want.shape, name
        cos, rel = _cos_rel(want, mine)
        assert cos > 0.99999 and rel < 1e-2, (name, cos, rel)
    # no atomics: a second run is bitwise equal
    again = tk.layer_stack_bwd(lw, cfg, s0, streams, st, h, dskip)
    for k in got[0]:
        assert torch.equal(got[0][k], again[0][k]), k
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


def test_fused_train_raises_outside_envelope(dev):
    for cfg in (_cfg(kernel_size=4), _cfg(n_skipch=96)):
        params = _params(cfg, dev)
        x = torch.zeros((1, 64), dtype=torch.int64, device=dev)
        h = torch.zeros((1, 64, cfg.n_aux), device=dev)
        with pytest.raises(ValueError, match="envelope"):
            P.wavenet_forward(params, cfg, x, h, fused=True)
        s0 = torch.zeros((1, 64, cfg.n_resch), dtype=torch.bfloat16,
                         device=dev)
        with pytest.raises(NotImplementedError):
            tk.layer_stack_fwd_train(tk.layer_weights(params), cfg, s0, h)


# B=20: two row tiles, the second partial (dual: halves of 10, each padded
# to its own tile); B=1: one row (dual: two, one per half); B=200: 13 row
# tiles, cut into 13 row groups; all at two steps, where the bf16 chains
# are still finite
@pytest.mark.parametrize("B", [1, 20, 200])
@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_matmul_chain_kernel_matches_plain(dev, variant, B):
    B = max(B, 2) if variant == "dual" else B
    gen = torch.Generator(device=dev).manual_seed(7)
    w = mc.make_chain_weights(variant, gen, dev)
    x0 = torch.randn((B, mc.R), generator=gen, device=dev).to(torch.bfloat16)
    before = mc.matmul_chain.launches
    got = mc.matmul_chain(x0, w, variant, 2)
    assert mc.matmul_chain.launches == before + 1    # one launch, all steps
    again = mc.matmul_chain(x0, w, variant, 2)
    assert torch.equal(got, again)                   # fixed-order reduction
    want = mc.matmul_chain_reference(x0, w, variant, 2)
    assert torch.isfinite(got.float()).all()
    if variant == "int8raw":
        assert torch.equal(got, want)
        return
    # limits of tests/test_torch_matmul_chain.py: summation-order flips
    # carried through the chain
    d = (got.float() - want.float()).abs()
    rel = (d.max() / want.float().abs().max()).item()
    if variant == "int8":
        assert rel <= 2e-2 and (d > 0).float().mean().item() <= 0.25
    else:
        assert rel <= 3e-2, rel
