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

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX
from pytorchwavenetvocoder_tpu_torch.bin.profile_ar import ar_loop_kernels
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


# (kernel_size, B, T, dilation_depth, dilation_repeat): T not a multiple
# of the kernels' 128-row tiles (700, 1,001), B = 3, a window shorter than
# one tile (50), and dilations up to 512, larger than a tile (depth 10: one
# repeat of 10 layers, near the 8 layers the limits below were set at)
STACK_SHAPES = [(2, 3, 700, 4, 2), (3, 3, 700, 4, 2), (2, 1, 1001, 10, 1),
                (3, 3, 1001, 10, 1), (2, 3, 50, 4, 2)]


def _check_streams(cfg, params, B, T, seed=0, share=1e-2):
    rng = np.random.RandomState(seed)
    dev = params["dil"]["w"].device
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
        assert (d > 0).float().mean().item() <= share


@pytest.mark.parametrize("kernel_size, B, T, depth, repeat", STACK_SHAPES)
def test_layer_stack_kernel_matches_plain(dev, kernel_size, B, T, depth,
                                          repeat):
    cfg = _cfg(kernel_size=kernel_size, dilation_depth=depth,
               dilation_repeat=repeat)
    _check_streams(cfg, _params(cfg, dev), B, T)


def test_layer_stack_kernel_at_sd_minis_padded_widths(dev):
    """The sd-mini recipe's widths (n_resch 32, n_skipch 16, 5 layers) as
    the cuda route pads them (``kernel_multiples``,
    ``pad_params_for_kernels``) through the warm-up kernel."""
    cfg = _cfg(n_resch=32, n_skipch=16, dilation_depth=5, dilation_repeat=1)
    params, pc = P.pad_params_for_kernels(_params(cfg, dev), cfg,
                                          P.kernel_multiples(cfg))
    assert pc.n_resch == 128 and tk.layer_stack_constraint_error(pc) is None
    _check_streams(pc, params, 8, cfg.receptive_field)


def _bf16_counts():
    return ak.ar_generate.launches


# B=1: one partial row tile; 20: two tiles, the second partial; 65: a
# partial last 64-row slab; 200 and 1000: the streamed gate's slabs over
# several blocks, the other stages' units more than blocks (1000: several
# row groups of one column group, its last row group partial);
# kernel_size 3 (raw rings, the lag rows read straight from the ring) at
# each.  Each fleet runs on the gate design ``ar_gate`` picks (streamed
# from AR_STREAM_FROM_B rows); ``test_both_bf16_kernels_match_plain``
# holds both at one fleet.
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("B", [1, 20, 65, 200, 1000])
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
        before = _bf16_counts()
        sk = ak.ar_generate(params, cfg, ck, h, T0 + i, 1, "argmax")
        assert _bf16_counts() == before + 1
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


def _int8_counts():
    return ak.ar_generate.int8_persistent_launches


def _int8_carry(params, cfg, dev, B, n, seed, layer0_scale=None):
    """The cuda warm-up's carry with its calibrated scales (kernel_size 3:
    the int8 ring of ``int8_ring_fill``); ``layer0_scale`` replaces layer
    0's."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)),
                        device=dev)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32, device=dev)
    carry, maxes = P._warmup_state(params, cfg, x, h, bf16_intermediates=True,
                                   collect_act_maxes=True, impl="cuda")
    scales = ak.act_scales_from_maxes(maxes)
    if layer0_scale is not None:
        scales[0] = layer0_scale
    if cfg.kernel_size == 3:
        carry = (ak.int8_ring_fill(carry[0], scales, cfg),) + carry[1:]
    return carry, h, x.shape[1], scales


def _int8_same_state(params, cfg, carry, h, T0, scales, n, kernel):
    """``kernel`` (c, p, steps) against the plain int8 loop step by step
    from the plain loop's state: the integer products are exact in both
    and the epilogues round alike, so only the aux sum's order and the
    sigmoid/tanh differ (an f32 ulp).  Where that flips an int8 value, the
    rest of the row's layers move by int8 quanta: a minority of the ring
    values a step writes differ, each by a few quanta (max|d| <= 5e-2 of
    max|ring|, share <= 0.25); argmax agreement >= 0.97."""
    caps, offs, _ = P._buffer_layout(cfg)
    agree = []
    cp = tuple(t.clone() for t in carry)
    for i in range(n):
        ck = tuple(t.clone() for t in cp)
        sk = kernel(ck, T0 + i, 1)
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i, quantize=True, act_scales=scales)
        p = T0 - 1 + i
        rows = [o + p % c for o, c in zip(offs, caps)]
        want = cp[0][rows].float()
        d = (ck[0][rows].float() - want).abs()
        assert d.max().item() <= 5e-2 * want.abs().max().item()
        assert (d > 0).float().mean().item() <= 0.25
        rest = torch.ones(ck[0].shape[0], dtype=torch.bool,
                          device=ck[0].device)
        rest[rows] = False
        assert torch.equal(ck[0][rest], cp[0][rest])   # other slots untouched
        agree.append((sk == sp).float().mean().item())
    assert np.mean(agree) >= 0.97


# the fleets of the bf16 test; each on the int8 gate design ar_gate picks
# (streamed from AR_STREAM_FROM_B rows)
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("B", [1, 20, 65, 200, 1000])
def test_ar_int8_kernel_matches_plain(dev, B, kernel_size):
    """K1-int8 against the plain int8 loop on the same carry and scales
    (``_int8_same_state``'s limits), counted once per call."""
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=5)
    n = 24
    carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 5)

    def kernel(c_, p, steps):
        before = _int8_counts()
        out = ak.ar_generate(params, cfg, c_, h, p, steps, "argmax",
                             quantize=True, act_scales=scales)
        assert _int8_counts() == before + 1
        return out

    _int8_same_state(params, cfg, carry, h, T0, scales, n, kernel)

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
    k1, k1q = ak.ar_generate.launches, _int8_counts()
    k2 = tk.layer_stack_streams.launches
    out = P.batch_fast_generate(params, cfg, x, h, [59, 40, 20],
                                mode="argmax", quantize=True)
    assert [len(o) for o in out] == [59, 40, 20]
    assert _int8_counts() == k1q + 1
    assert ak.ar_generate.launches == k1
    assert tk.layer_stack_streams.launches == k2 + 1


# both int8 gate designs at one fleet, whichever ar_gate picks there: 200
# rows (the streamed gate's slabs, more units than blocks in the cut into
# units)
@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_both_int8_kernels_match_plain(dev, kernel_size, gate):
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=11)
    n = 16
    carry, h, T0, scales = _int8_carry(params, cfg, dev, 200, n, 11)
    before = _int8_counts()
    _int8_same_state(params, cfg, carry, h, T0, scales, n,
                     lambda c_, p, steps: ak.ar_generate_on(
                         gate, params, cfg, c_, h, p, steps, quantize=True,
                         act_scales=scales))
    assert _int8_counts() == before      # not counted as the path's


@pytest.mark.parametrize("B", [8, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_int8_kernel_one_launch_per_call(dev, kernel_size, B):
    """The int8 route makes one device launch of the AR loop per call, with
    either gate design (the launch loop it replaced made 65-66 per
    step)."""
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=4)
    carry, h, T0, scales = _int8_carry(params, cfg, dev, B, 12, 4)
    assert ak.ar_gate(cfg, B, quantize=True, device=dev) == (
        "units" if B == 8 else "stream")

    def call():
        return ak.ar_generate(params, cfg, carry, h, T0, 12, "argmax",
                              quantize=True, act_scales=scales)

    call()        # the build
    torch.cuda.synchronize()
    loop, names, _ = ar_loop_kernels(call)
    assert len(loop) == 1 and "ar_persistent_kernel" in loop[0], (loop, names)


@pytest.mark.parametrize("quantize", [False, True])
def test_widths_off_the_tiling_decode_on_the_card(dev, quantize):
    """The sd-mini recipe's widths (n_resch 32, n_skipch 16): the cuda
    route pads them to the kernels' multiples and decodes through K2 and
    K1 on the card (``impl="auto"``), each launched once (chip_smoke.py's
    [main mini] holds K1 against the plain loop on the padded carry)."""
    cfg = _cfg(n_resch=32, n_skipch=16, dilation_depth=5, dilation_repeat=1,
               upsampling_factor=10)
    params = _params(cfg, dev, seed=12)
    rng = np.random.RandomState(12)
    x = np.full((3, 1), 128, np.int32)
    hf = rng.randn(3, 6, cfg.n_aux).astype(np.float32)
    n_list = [59, 40, 20]
    k1, k1q = _bf16_counts(), _int8_counts()
    k2 = tk.layer_stack_streams.launches
    out = P.batch_fast_generate(params, cfg, x, hf, n_list, mode="argmax",
                                quantize=quantize)
    assert [len(o) for o in out] == n_list
    assert tk.layer_stack_streams.launches == k2 + 1
    if quantize:
        assert _int8_counts() == k1q + 1
        assert _bf16_counts() == k1
    else:
        assert _bf16_counts() == k1 + 1
    assert all(((o >= 0) & (o < cfg.n_quantize)).all() for o in out)


def _same_state(params, cfg, carry, h, T0, n, kernel, plain_cfg=None,
                share=None):
    """``kernel`` (c, p, steps) against the plain loop (on ``plain_cfg``,
    default ``cfg``) step by step from the plain loop's state: the [K1]
    limits, the ring after each step within 2e-2 of max|ring| and argmax
    agreement >= 0.97.  ``share``: the most of layer 0's new ring slot that
    may differ (one layer on the same input, as ``_check_streams``)."""
    caps, offs, _ = P._buffer_layout(cfg)
    agree, cp = [], tuple(t.clone() for t in carry)
    for i in range(n):
        ck = tuple(t.clone() for t in cp)
        sk = kernel(ck, T0 + i, 1)
        sp = ak.ar_generate_reference(params, plain_cfg or cfg, cp, h, T0, 1,
                                      "argmax", i0=i)
        ring = (ck[0].float() - cp[0].float()).abs().max().item()
        assert ring <= 2e-2 * cp[0].float().abs().max().item()
        if share is not None:
            row = offs[0] + (T0 - 1 + i) % caps[0]
            d = ck[0][row].float() != cp[0][row].float()
            assert d.float().mean().item() <= share
        agree.append((sk == sp).float().mean().item())
    assert np.mean(agree) >= 0.97


def _random_carry(params, cfg, dev, B, n, seed):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)),
                        device=dev)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32, device=dev)
    carry = P._warmup_state(params, cfg, x, h, bf16_intermediates=True,
                            impl="cuda")
    return carry, h, x.shape[1]


# both bf16 gate designs at one fleet, whichever ar_gate picks there: 200
# rows (the streamed gate's slabs, more units than blocks in the cut into
# units)
@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_both_bf16_kernels_match_plain(dev, kernel_size, gate):
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=9)
    n = 16
    carry, h, T0 = _random_carry(params, cfg, dev, 200, n, 9)
    before = _bf16_counts()
    _same_state(params, cfg, carry, h, T0, n,
                lambda c_, p, steps: ak.ar_generate_on(gate, params, cfg, c_,
                                                       h, p, steps))
    assert _bf16_counts() == before      # not counted as the path's


def test_wide_k3_config_runs_on_the_streamed_gate(dev):
    """kernel_size 3 at n_resch=768: no cut of the gate into units fits
    shared memory (K = 3R + aux), so every fleet's gate streams K; held
    against the plain loop, and decoded through ``batch_fast_generate``."""
    cfg = _cfg(kernel_size=3, n_resch=768)
    params = _params(cfg, dev, seed=10)
    assert ak.ar_gate(cfg, 1, device=dev) == "stream"
    n = 16
    carry, h, T0 = _random_carry(params, cfg, dev, 20, n, 10)
    _same_state(params, cfg, carry, h, T0, n,
                lambda c_, p, steps: ak.ar_generate(params, cfg, c_, h, p,
                                                    steps, "argmax"))
    before = _bf16_counts()
    x = np.full((2, 1), 128, np.int32)
    hf = np.random.RandomState(10).randn(2, 40, cfg.n_aux).astype(np.float32)
    out = P.batch_fast_generate(params, cfg, x, hf, [30, 12], mode="argmax")
    assert [len(o) for o in out] == [30, 12]
    assert _bf16_counts() == before + 1


def test_cuda_path_raises_outside_envelope(dev):
    # n_resch past K2's MAX_RESCH in int8, as in bf16 (the warm-up kernel
    # refuses it; int8 takes every width the bf16 route takes)
    for cfg, quantize in ((_cfg(kernel_size=4), False),
                          (_cfg(compute_dtype="float64"), False),
                          (_cfg(n_resch=tk.MAX_RESCH + 128), True),
                          (_cfg(n_aux=AUX_MAX + 1), False)):
        params = _params(cfg, dev)
        x = np.zeros((2, 1), np.int32)
        h = np.zeros((2, 40, cfg.n_aux), np.float32)
        with pytest.raises(NotImplementedError):
            P.batch_fast_generate(params, cfg, x, h, [10, 10], impl="cuda",
                                  quantize=quantize)


def _wide_share(cfg):
    """The share of elements a layer may flip by a bf16 ulp against the
    plain layer at the gate's K = kR + aux_width(n_aux): a flip needs the
    two f32 sums to straddle a rounding boundary, and their difference
    grows with the terms summed (the card read 3.4-6.0e-6 x K for K 1,600
    to 6,208), so 1e-5 x K, and the other tests' 1e-2 below K = 1,000."""
    K = cfg.kernel_size * cfg.n_resch + tk.aux_width(cfg.n_aux)
    return max(1e-2, 1e-5 * K)


#: K3's gradients where the aux or residual width is past the other tests':
#: chip_smoke.py [K3]'s relative limit (its cosine limit is 0.9999; these
#: keep 0.99999), as the dz flips above feed eight layers of bf16 dx
WIDE_GRAD_REL = 3e-2


# conditioning wider than the first AR kernel's 96 rows: one past it, a
# 128-band mel with a speaker-code column (129), 256 and AUX_MAX; fleets
# 16 and 64 (gate units) and 256 (streamed), each gate design at each
WIDE_AUX = [97, 129, 256, AUX_MAX]


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [16, 64, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_ar_kernels_at_wide_aux_match_plain(dev, n_aux, kernel_size, B, gate):
    """K1 in bf16 and int8 with the aux rows past 96 (the warm-up's K2 on
    the same width first), both gate designs, against the plain loops
    with the [K1] and int8 limits."""
    cfg = _cfg(kernel_size=kernel_size, n_aux=n_aux)
    params = _params(cfg, dev, seed=13)
    n = 6
    carry, h, T0 = _random_carry(params, cfg, dev, B, n, 13)
    _same_state(params, cfg, carry, h, T0, n,
                lambda c_, p, steps: ak.ar_generate_on(gate, params, cfg, c_,
                                                       h, p, steps))
    carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 13)
    _int8_same_state(params, cfg, carry, h, T0, scales, n,
                     lambda c_, p, steps: ak.ar_generate_on(
                         gate, params, cfg, c_, h, p, steps, quantize=True,
                         act_scales=scales))


#: residual widths past the first int8 route's 1,024: 9 x 128 (what JAX's
#: ``supports_pallas_ar`` takes) and K2's MAX_RESCH
WIDE_RESCH = [1152, 2048]


def _wide_resch_cfg(n_resch, kernel_size):
    return _cfg(kernel_size=kernel_size, n_resch=n_resch, n_skipch=256)


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [16, 64, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_resch", WIDE_RESCH)
def test_ar_kernels_at_wide_resch_match_plain(dev, n_resch, quantize,
                                              kernel_size, B, gate):
    """K1 in bf16 and int8 past n_resch 1,024 (the warm-up's K2 on the same
    width first), on each gate design ``ar_plan`` has for the case, against
    the plain loops: bf16 with the [K1] limits and layer 0's ring slot
    within ``_wide_share``, int8 with ``_int8_same_state``'s."""
    cfg = _wide_resch_cfg(n_resch, kernel_size)
    try:
        ak.ar_plan(cfg, B, quantize=quantize, device=dev, gate=gate)
    except ValueError as e:
        pytest.skip(f"ar_plan has no {gate} gate for this case: {e}")
    params = _params(cfg, dev, seed=18)
    n = 6
    if quantize:
        carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 18)
        _int8_same_state(params, cfg, carry, h, T0, scales, n,
                         lambda c_, p, steps: ak.ar_generate_on(
                             gate, params, cfg, c_, h, p, steps,
                             quantize=True, act_scales=scales))
    else:
        carry, h, T0 = _random_carry(params, cfg, dev, B, n, 18)
        _same_state(params, cfg, carry, h, T0, n,
                    lambda c_, p, steps: ak.ar_generate_on(
                        gate, params, cfg, c_, h, p, steps),
                    share=_wide_share(cfg))


def saturate_layer0(params, cfg):
    """Weights whose layer-0 integer sums pass 2^24 at n_resch >= 1,041:
    the causal conv constant, so every channel of layer 0's input is equal
    (``kernel_size / 4``; at the scale ``kernel_size / 4 / 127`` it
    quantizes to 127 everywhere: a saturated stream), and
    the current tap's gate columns of channel 0 (its sigmoid and its tanh
    column) constant at 127 / 4096 but one row at 126 / 4096 (exact in
    bf16), so both quantize to 127 with one 126:
    an odd sum of 127 (R - 1) * 127 + 127 * 126, past 2^24 and not an f32
    value.  In place; returns ``params``."""
    k = cfg.kernel_size
    params["causal"]["w"].fill_(0.25)
    params["causal"]["b"].zero_()
    for col in (0, cfg.n_resch):
        w = params["dil"]["w"][0, k - 1, :, col]
        w.fill_(127 / 4096)
        w[0] = 126 / 4096
    return params


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_int8_kernel_past_2_24_matches_plain(dev, kernel_size):
    """K1-int8 where layer 0's integer sums pass 2^24 (``saturate_layer0``
    at n_resch 1,152, the int8 gate ``ar_gate`` picks at 16 rows): the
    kernel's s32 sums and the plain loop's float64 ones, each rounded once
    to f32, agree through the carry (``_int8_same_state``).  The old f32
    sums were not exact there; the bit-level proof is the CPU product test
    (tests/test_torch_int8_wide.py), as the bf16 ring cannot show one unit
    in 2^24."""
    cfg = _wide_resch_cfg(1152, kernel_size)
    params = saturate_layer0(_params(cfg, dev, seed=19), cfg)
    B, n = 16, 6
    carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 19,
                                       layer0_scale=kernel_size / 4 / 127)
    # the stream is saturated: layer 0 quantizes every channel to 127
    x0 = carry[0].new_full((), kernel_size / 4, dtype=torch.float32)
    assert torch.round(x0 * (1.0 / scales[0])).item() == 127
    q = ak.quantize_ar_weights(params, cfg)[
        "w4" if kernel_size == 2 else "w6"][0, :, 0].long()
    assert q.sum().item() * 127 > 2 ** 24 and q.sum().item() % 2 == 1
    _int8_same_state(params, cfg, carry, h, T0, scales, n,
                     lambda c_, p, steps: ak.ar_generate(
                         params, cfg, c_, h, p, steps, "argmax",
                         quantize=True, act_scales=scales))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_kernel_one_launch_per_call_at_n_resch_2048(dev, kernel_size,
                                                       quantize):
    """At K2's MAX_RESCH the route makes one device launch of the AR loop
    per call, bf16 and int8, on the gate design ``ar_gate`` picks."""
    cfg = _wide_resch_cfg(2048, kernel_size)
    params = _params(cfg, dev, seed=4)
    B, n = 64, 12
    if quantize:
        carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 4)
    else:
        carry, h, T0 = _random_carry(params, cfg, dev, B, n, 4)
        scales = None

    def call():
        return ak.ar_generate(params, cfg, carry, h, T0, n, "argmax",
                              quantize=quantize, act_scales=scales)

    call()        # the build
    torch.cuda.synchronize()
    loop, names, _ = ar_loop_kernels(call)
    assert len(loop) == 1 and "ar_persistent_kernel" in loop[0], (loop, names)


@pytest.mark.parametrize("B", [16, 20])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_units_gate_on_the_wide_caps_matches_plain(dev, kernel_size, B):
    """The flagship widths at AUX_MAX rows: no regular cap fits the bf16
    gate cut into units (a unit's slice of K = R + Ap or 3R + Ap rows), so
    its plan sizes the two weight buffers apart (``AR_W_WIDE``,
    ``AR_W1_CAPS``); held to the plain loop with [K1]'s limits, on the
    design ``ar_gate`` picks there."""
    cfg = _cfg(kernel_size=kernel_size, n_aux=AUX_MAX, n_resch=512,
               n_skipch=256)
    plan = ak.ar_plan(cfg, B, device=dev)
    w = plan["smem_w"]
    assert ak.ar_gate(cfg, B, device=dev) == "units"
    assert w[0] == 0 and w[1] != plan["smem_a"] - w[1]      # two sizes
    params = _params(cfg, dev, seed=17)
    n = 6
    carry, h, T0 = _random_carry(params, cfg, dev, B, n, 17)
    _same_state(params, cfg, carry, h, T0, n,
                lambda c_, p, steps: ak.ar_generate(params, cfg, c_, h, p,
                                                    steps, "argmax"))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_kernel_one_launch_per_call_at_wide_aux(dev, kernel_size,
                                                   quantize):
    """n_aux 129 (a speaker-coded 128-band mel): ``batch_fast_generate``
    with ``impl="auto"`` on the card runs K2 once and K1 once, one device
    launch of the AR loop."""
    cfg = _cfg(kernel_size=kernel_size, n_aux=129, upsampling_factor=10)
    params = _params(cfg, dev, seed=14)
    rng = np.random.RandomState(14)
    x = np.full((3, 1), 128, np.int32)
    hf = rng.randn(3, 6, cfg.n_aux).astype(np.float32)
    k1 = _int8_counts() if quantize else _bf16_counts()
    k2 = tk.layer_stack_streams.launches
    out = P.batch_fast_generate(params, cfg, x, hf, [59, 40, 20],
                                mode="argmax", quantize=quantize)
    assert [len(o) for o in out] == [59, 40, 20]
    assert (_int8_counts() if quantize else _bf16_counts()) == k1 + 1
    assert tk.layer_stack_streams.launches == k2 + 1
    B, n = 16, 12
    if quantize:
        carry, h, T0, scales = _int8_carry(params, cfg, dev, B, n, 14)
    else:
        carry, h, T0 = _random_carry(params, cfg, dev, B, n, 14)
        scales = None

    def call():
        return ak.ar_generate(params, cfg, carry, h, T0, n, "argmax",
                              quantize=quantize, act_scales=scales)

    call()
    torch.cuda.synchronize()
    loop, names, _ = ar_loop_kernels(call)
    assert len(loop) == 1 and "ar_persistent_kernel" in loop[0], (loop, names)


@pytest.mark.parametrize("B", [8, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_kernel_one_launch_per_call(dev, kernel_size, B):
    """The bf16 route makes one device launch of the AR loop per call,
    whatever the number of steps and the gate design (the launch loop it
    replaced made 65-66 per step)."""
    cfg = _cfg(kernel_size=kernel_size)
    params = _params(cfg, dev, seed=4)
    rng = np.random.RandomState(4)
    n = 12
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)),
                        device=dev)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32, device=dev)
    carry = P._warmup_state(params, cfg, x, h, bf16_intermediates=True,
                            impl="cuda")
    ak.ar_generate(params, cfg, carry, h, x.shape[1], 1, "argmax")   # build
    torch.cuda.synchronize()
    loop, names, _ = ar_loop_kernels(lambda: ak.ar_generate(
        params, cfg, carry, h, x.shape[1], n, "argmax"))
    assert len(loop) == 1 and "ar_persistent_kernel" in loop[0], (loop, names)


def test_float32_bundle_decodes_through_k1(dev, tmp_path):
    """A float32 conf (what the JAX bin/convert_checkpoint.py writes for a
    reference checkpoint) at the arctic flagship's widths decodes through
    ``decode_batches(impl="auto")`` on the card as the bf16 conf on the
    same weights: K2 and K1 once per fleet.  From that route's carry, K1
    meets the [K1] limits against the plain loop on the same bf16-cast
    weights (the bf16 conf's plain loop)."""
    import json
    import pickle

    from pytorchwavenetvocoder_tpu_torch.bin.decode import (
        decode_batches,
        load_model,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import read_wav

    cfg = P.WaveNetConfig(n_quantize=256, n_aux=28, n_resch=512,
                          n_skipch=256, dilation_depth=10, dilation_repeat=1,
                          kernel_size=2, upsampling_factor=80,
                          compute_dtype="float32")
    params = _params(cfg, dev, seed=8)
    conf = dict(cfg.to_dict(), use_upsampling_layer=True,
                feature_type="world", use_speaker_code=False)
    (tmp_path / "model.conf").write_text(json.dumps(conf))
    tree = {g: {k: v.cpu().numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}
    ckpt = tmp_path / "checkpoint-0.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump({"model": tree, "optimizer": None, "iterations": 0}, f)
    model, _conf = load_model(str(ckpt), str(tmp_path), dev)
    rng = np.random.RandomState(8)
    B, frames = 4, [3, 5, 4, 2]
    h = rng.randn(B, max(frames), cfg.n_aux).astype(np.float32)
    x = np.full((B, 1), 128, np.int32)
    n_list = [f * cfg.upsampling_factor - 1 for f in frames]
    ids = [f"u{b}" for b in range(B)]
    k1, k2 = _bf16_counts(), tk.layer_stack_streams.launches
    decode_batches(model, [(ids, (x, h, n_list))], str(tmp_path / "wav"),
                   mode="sampling", impl="auto", fs=16000,
                   generator=torch.Generator().manual_seed(1))
    assert _bf16_counts() == k1 + 1
    assert tk.layer_stack_streams.launches == k2 + 1
    for b, n in enumerate(n_list):
        wav, _fs = read_wav(str(tmp_path / "wav" / f"u{b}.wav"))
        assert wav.shape == (n,) and np.isfinite(wav).all()
    # K1 from the f32 route's carry against the plain bf16 loop
    kcfg = P._kernel_config(cfg)
    assert kcfg.compute_dtype == "bfloat16"
    n = 16
    carry, ht, T0 = _random_carry(params, kcfg, dev, B, n, 8)
    assert carry[0].dtype == torch.bfloat16
    _same_state(params, cfg, carry, ht, T0, n,
                lambda c_, p, steps: ak.ar_generate(params, cfg, c_, ht, p,
                                                    steps, "argmax"),
                plain_cfg=kcfg)


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


@pytest.mark.parametrize("kernel_size, B, T, depth, repeat", STACK_SHAPES)
def test_train_kernels_match_plain(dev, kernel_size, B, T, depth, repeat):
    """K2 training mode and K3 at ragged T (not a multiple of the 128-row
    tile), B=3, dilations past a tile, against their plain versions on the
    same inputs; K3 bitwise equal over two runs."""
    _check_train(_cfg(kernel_size=kernel_size, dilation_depth=depth,
                      dilation_repeat=repeat), dev, B, T)


def test_train_kernels_at_widths_the_first_kernels_refused(dev):
    """kernel_size 3 at n_resch 640 (the first kernels' staged dz tiles
    stopped kernel_size 3 training at 512)."""
    _check_train(_cfg(kernel_size=3, n_resch=640, n_skipch=256,
                      dilation_depth=3), dev, 2, 300)


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_stack_kernels_at_wide_aux_match_plain(dev, n_aux, kernel_size):
    """K2 (streams and training) and K3 with the aux rows past 96: the
    gate's aux K steps, K3's dh and aux weight gradient in
    ceil(n_aux / 128) column and row tiles."""
    cfg = _cfg(kernel_size=kernel_size, n_aux=n_aux)
    params = _params(cfg, dev, seed=15)
    _check_streams(cfg, params, 3, 700, seed=15, share=_wide_share(cfg))
    _check_train(cfg, dev, 2, 700, share=_wide_share(cfg),
                 grad_rel=WIDE_GRAD_REL)


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_resch", [1152, 2048])
def test_stack_kernels_at_wide_resch_match_plain(dev, n_resch, kernel_size):
    """K2 (streams and training) and K3 past n_resch 1,024, to MAX_RESCH:
    what lets the bf16 decode take n_resch 1,152, as the JAX K1 does."""
    assert n_resch <= tk.MAX_RESCH
    cfg = _cfg(kernel_size=kernel_size, n_resch=n_resch, n_skipch=256,
               dilation_depth=3)
    params = _params(cfg, dev, seed=16)
    _check_streams(cfg, params, 2, 300, seed=16, share=_wide_share(cfg))
    _check_train(cfg, dev, 2, 300, share=_wide_share(cfg),
                 grad_rel=WIDE_GRAD_REL)


def _check_train(cfg, dev, B, T, share=1e-2, grad_rel=1e-2):
    params = _params(cfg, dev, seed=4)
    rng = np.random.RandomState(4)
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
        assert diff.max().item() <= 2 ** -8 and (diff > 0).float().mean() <= share
        g = (s * t).to(torch.bfloat16)
        skip_ref += P._dot(g, lw["skip_w"][l].to(torch.bfloat16)) + lw["skip_b"][l]
        if l < cfg.n_layers - 1:
            want = tk._ref_res(lw, l, g, x).float()
            diff = (streams[l].float() - want).abs()
            assert diff.max().item() <= 1e-2 * want.abs().max().item()
            assert (diff > 0).float().mean().item() <= share
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
        assert cos > 0.99999 and rel < grad_rel, (name, cos, rel)
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


# B=1, 20, 63 (one padded slab; dual: halves of 1, 10 and 32, each padded
# to its own), 64, 200, 512 and 1,024 (1, 4, 8 and 16 slabs; 200 a partial
# one); all at two steps, where the bf16 chains are still finite
@pytest.mark.parametrize("B", [1, 20, 63, 64, 200, 512, 1024])
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


# A wait that let a unit read rows before their writers arrived changes
# integers, which int8raw carries to the end: 200 steps (12,000 dependent
# products) bit-equal to the plain chain, on one padded slab (16), two slabs
# (128), four (256) and sixteen, with two units a block (1,024)
@pytest.mark.parametrize("B", [16, 128, 256, 1024])
def test_matmul_chain_int8raw_exact_over_200_steps(dev, B):
    gen = torch.Generator(device=dev).manual_seed(11)
    w = mc.make_chain_weights("int8raw", gen, dev)
    x0 = (torch.randn((B, mc.R), generator=gen, device=dev) * 40).to(
        torch.bfloat16)
    got = mc.matmul_chain(x0, w, "int8raw", 200)
    want = mc.matmul_chain_reference(x0, w, "int8raw", 200)
    assert torch.equal(got, want)
    assert (want.float().abs() > 0).float().mean().item() > 0.5


def test_matmul_chain_barrier_modes_run(dev):
    for mode in mc.BARRIER_MODES:
        mc.barrier_chain(20, dev, mode=mode)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="mode"):
        mc.barrier_chain(2, dev, mode="spin")


def test_two_gloo_ranks_on_one_card_stay_bitwise_equal(dev):
    """Data parallel on the card: 2 gloo ranks sharing cuda:0, 3 fused
    steps on their halves of a global batch of 2 x 700; after every step
    both ranks hold the same params, bit for bit, on the fused route."""
    from _torch_dp_ranks import dp_digests, np_tree

    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        spawn_local,
    )

    cfg = _cfg()
    params = np_tree(P.init_wavenet_params(cfg, torch.Generator()
                                           .manual_seed(0)))
    r = np.random.RandomState(0)
    batches = [(r.randint(0, 256, (2, 700)).astype(np.int32),
                r.randn(2, 700, cfg.n_aux).astype(np.float32),
                r.randint(0, 256, (2, 700)).astype(np.int32))
               for _ in range(3)]
    ranks = spawn_local(2, dp_digests, (cfg.to_dict(), params, batches, 1e-3,
                                        0.0, True),
                        device_arg="cuda:0", backend="gloo", timeout_s=120,
                        deadline_s=300)
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:0"]
    assert all(r["route"] == "fused" for r in ranks)
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len(set(ranks[0]["digests"])) == 3
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert np.isfinite(ranks[0]["losses"]).all()


def test_one_rank_per_card_refuses_more_ranks_than_cards(dev, tmp_path,
                                                         monkeypatch, caplog):
    """--device cuda puts rank r on cuda:r: on a one-card machine two ranks
    are clamped to one process on the card with the JAX CLI's warning (no
    rank spawned); a card index past the count is still refused, naming the
    device count, before any rank starts."""
    from pytorchwavenetvocoder_tpu_torch.bin import decode as decode_cli
    from pytorchwavenetvocoder_tpu_torch.parallel import distributed

    if torch.cuda.device_count() != 1:
        pytest.skip("checks a one-card machine")
    argv = ["--feats", str(tmp_path), "--stats", "-", "--checkpoint", "-",
            "--config", "-", "--outdir", str(tmp_path / "wav"),
            "--n_devices", "2", "--verbose", "0"]
    seen = []
    monkeypatch.setattr(distributed, "spawn_local", lambda *a, **k:
                        pytest.fail("spawned ranks for a clamped run"))
    monkeypatch.setattr(decode_cli, "decode_rank", lambda info, args, feats:
                        seen.append(info) or dict(n_utts=0, n_samples=0,
                                                  seconds=0.0, batches=[]))
    decode_cli.main(argv + ["--device", "cuda"])
    assert [(i.world, i.device.type) for i in seen] == [(1, "cuda")]
    assert "requested 2 devices but only 1 available." in caplog.text
    with pytest.raises(ValueError, match=r"device_count\(\) is 1"):
        decode_cli.main(argv + ["--device", "cuda:1"])