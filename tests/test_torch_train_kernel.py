"""The training stack's plain versions against the JAX package: the forward
with saves (K2 training mode) and its backward (K3) against the Pallas
kernels in interpret mode and against ``jax.grad`` of the JAX
``ref_layer_stack``; ``FusedLayerStack`` and ``wavenet_forward(fused=True)``
on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.ops import train_kernel as jtk

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX
from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

torch.set_num_threads(2)

BF = torch.bfloat16


def _cfgs(**kw):
    base = dict(n_quantize=256, n_aux=20, n_resch=128, n_skipch=128,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _data(jc, B=2, T=1700, seed=0):
    """The size tests/test_train_kernel.py runs: B=2, T=1700, 3x2 layers,
    R=S=128, A=20; inputs and the skip cotangent made with numpy."""
    jp = J.init_wavenet_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.RandomState(seed)
    stream0 = (rng.randn(B, T, jc.n_resch) * 0.5).astype(np.float32)
    h_up = rng.randn(B, T, jc.n_aux).astype(np.float32)
    dskip = rng.randn(B, T, jc.n_skipch).astype(np.float32)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, pp, stream0, h_up, dskip


def _bf(a) -> torch.Tensor:
    """A JAX (bf16) array as a torch bf16 tensor."""
    return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(BF)


def _close(want, got, cos_min, rel_max, name):
    a = np.asarray(want, np.float64)
    b = np.asarray(got, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    assert cos > cos_min, (name, cos)
    assert rel < rel_max, (name, rel)


def _grads(dlw, dstream0, dh):
    """Every gradient as (name, float32 numpy)."""
    out = [(k, v.float().numpy()) for k, v in dlw.items()]
    return out + [("stream0", dstream0.float().numpy()),
                  ("h_up", dh.float().numpy())]


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_forward_with_saves_matches_pallas_interpret(kernel_size):
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp, stream0, h_up, _ = _data(jc)
    skip_j, (_x0, streams_j, st_j, _hb) = jtk._fwd_pallas(
        jc, jtk._layer_weights(jp), jnp.asarray(stream0), jnp.asarray(h_up),
        interpret=True, save_st=True)
    T, L, R = stream0.shape[1], pc.n_layers, pc.n_resch
    streams_j, st_j = _bf(streams_j[:L - 1, :, :T]), _bf(st_j[:, :, :T])
    lw = tk.layer_weights(pp)
    skip, streams, st = tk.ref_layer_stack(lw, pc, torch.tensor(stream0),
                                           torch.tensor(h_up))
    assert skip.dtype == torch.float32 and streams.dtype == st.dtype == BF
    assert tuple(streams.shape) == tuple(streams_j.shape)
    assert tuple(st.shape) == tuple(st_j.shape)
    # the f32 skip sum inherits the streams' bf16 flips, chained: 1e-2
    skip_j = np.asarray(skip_j)
    assert np.abs(skip.numpy() - skip_j).max() <= 1e-2 * np.abs(skip_j).max()
    # each layer on the Pallas kernel's own input stream: both round to
    # bf16 after f32 sums taken in another order, so an element moves by at
    # most one bf16 ulp (2^-8 of its magnitude; sigma, tanh <= 1) and only
    # where the sums straddle a rounding boundary: <= 0.5% of elements
    hb = torch.tensor(h_up).to(BF)
    x = torch.tensor(stream0).to(BF)
    for l, d in enumerate(pc.dilations):
        s, t = tk._ref_gate(lw, l, d, x, hb)
        mine = torch.cat([s.to(BF), t.to(BF)], -1).float()
        diff = (mine - st_j[l].float()).abs()
        assert diff.max().item() <= 2 ** -8, (l, diff.max().item())
        assert (diff > 0).float().mean().item() <= 5e-3, l
        if l < L - 1:
            out = tk._ref_res(lw, l, (s * t).to(BF), x).float()
            want = streams_j[l].float()
            diff = (out - want).abs()
            assert diff.max().item() <= 5e-3 * want.abs().max().item(), l
            assert (diff > 0).float().mean().item() <= 5e-3, l
            x = streams_j[l]
    # the whole plain stack chained: 1e-2 of max|stream| (the flips above
    # feed the later layers' sums)
    for l in range(L - 1):
        want = streams_j[l].float()
        assert (streams[l].float() - want).abs().max().item() <= \
            1e-2 * want.abs().max().item(), l
    assert tk.supports_fused_train(pc, T)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_backward_matches_pallas_interpret(kernel_size):
    """One case per kernel size, interpret mode being slow: the plain
    backward on the JAX kernel's own saves and the same dskip.  Only the f32
    summation order differs, so dz differs by a bf16 ulp where a sum
    straddles a rounding boundary, and those flips chain through the bf16
    dx of six layers: cos > 0.99999 and max|d| < 1e-2 of max|ref| for every
    gradient (the kernel_size 2 readings were >= 0.9999991 and <= 5.6e-3,
    dstream0 the largest)."""
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp, stream0, h_up, dskip = _data(jc)
    jlw = jtk._layer_weights(jp)
    _, (x0, streams_j, st_j, hb) = jtk._fwd_pallas(
        jc, jlw, jnp.asarray(stream0), jnp.asarray(h_up), interpret=True)
    dlw_j, ds0_j, dh_j = jtk._bwd_pallas(jc, jlw, x0, streams_j, st_j, hb,
                                         jnp.asarray(dskip), interpret=True)
    T, L = stream0.shape[1], pc.n_layers
    got = tk.ref_layer_stack_bwd(
        tk.layer_weights(pp), pc, _bf(x0[:, :T]), _bf(streams_j[:L - 1, :, :T]),
        _bf(st_j[:, :, :T]), torch.tensor(h_up), torch.tensor(dskip))
    want = {k: np.asarray(v) for k, v in dlw_j.items()}
    want["stream0"] = np.asarray(ds0_j.astype(jnp.float32))
    want["h_up"] = np.asarray(dh_j)
    assert got[1].dtype == BF and got[2].dtype == torch.float32
    for name, g in _grads(*got):
        _close(want[name], g, 0.99999, 1e-2, name)


# odd B and a T that is not a multiple of the kernels' 32-row tile; the
# second lagged tap (kernel_size 3) at both
@pytest.mark.parametrize("B, T, kernel_size", [
    pytest.param(3, 1000, 2, id="3-1000"), pytest.param(2, 777, 2, id="2-777"),
    pytest.param(3, 1000, 3, id="k3-3-1000"),
    pytest.param(2, 777, 3, id="k3-2-777")])
def test_backward_matches_jax_autodiff(B, T, kernel_size):
    """The plain forward's saves and plain backward against jax.grad of the
    JAX ref_layer_stack, which flows f32 where the backward rounds (saves,
    dz, dx chain, dh partials) to bf16: the JAX kernel's own limits against
    the same autodiff, cos > 0.9999 and rel < 3e-2
    (tests/test_train_kernel.py:116-119)."""
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp, stream0, h_up, dskip = _data(jc, B=B, T=T, seed=B)

    def loss(lw, s0, h):
        return jnp.sum(jtk.ref_layer_stack(lw, jc, s0, h) * dskip)

    g_lw, g_s0, g_h = jax.grad(loss, argnums=(0, 1, 2))(
        jtk._layer_weights(jp), jnp.asarray(stream0), jnp.asarray(h_up))
    want = {k: np.asarray(v) for k, v in g_lw.items()}
    want["stream0"], want["h_up"] = np.asarray(g_s0), np.asarray(g_h)
    lw = tk.layer_weights(pp)
    s0 = torch.tensor(stream0)
    _, streams, st = tk.ref_layer_stack(lw, pc, s0, torch.tensor(h_up))
    got = tk.ref_layer_stack_bwd(lw, pc, s0.to(BF), streams, st,
                                 torch.tensor(h_up), torch.tensor(dskip))
    for name, g in _grads(*got):
        _close(want[name], g, 0.9999, 3e-2, name)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_fused_layer_stack_autograd_is_the_plain_backward(kernel_size):
    """On the CPU FusedLayerStack runs the plain versions: its autograd
    gradients equal ref_layer_stack_bwd on the same saves exactly, in the
    primal dtypes (f32 weights, bf16 stream0 and h_up)."""
    jc, pc = _cfgs(dilation_depth=2, kernel_size=kernel_size)
    _, pp, stream0, h_up, dskip = _data(jc, B=2, T=300, seed=3)
    for leaves in pp.values():
        for t in leaves.values():
            t.requires_grad_(True)
    s0 = torch.tensor(stream0).to(BF).requires_grad_(True)
    h = torch.tensor(h_up).to(BF).requires_grad_(True)
    out = tk.fused_layer_stack(pp, pc, s0, h)
    (out * torch.tensor(dskip)).sum().backward()
    lw = {k: v.detach() for k, v in tk.layer_weights(pp).items()}
    skip, streams, st = tk.ref_layer_stack(lw, pc, s0.detach(), h.detach())
    np.testing.assert_array_equal(out.detach().numpy(), skip.numpy())
    dlw, ds0, dh = tk.ref_layer_stack_bwd(lw, pc, s0.detach(), streams, st,
                                          h.detach(), torch.tensor(dskip))
    assert s0.grad.dtype == BF and h.grad.dtype == BF
    np.testing.assert_array_equal(s0.grad.float().numpy(), ds0.float().numpy())
    np.testing.assert_array_equal(h.grad.float().numpy(),
                                  dh.to(BF).float().numpy())
    for key, t in tk.layer_weights(pp).items():
        assert t.grad.dtype == torch.float32, key
        np.testing.assert_array_equal(t.grad.numpy(), dlw[key].numpy(), key)


def test_wavenet_forward_fused_close_to_jax_bf16_intermediates():
    """wavenet_forward(fused=True) on the CPU (the plain stack through
    FusedLayerStack) against the JAX wavenet_forward(bf16_intermediates=True):
    they differ by where bf16 rounding lands (the saved sigma/tanh vs the
    gate inputs), the JAX test's own limits for its fused path
    (tests/test_train_kernel.py:143-146): max|d| < 0.15, corr > 0.9999."""
    jc, pc = _cfgs(upsampling_factor=10)
    jp = J.init_wavenet_params(jax.random.PRNGKey(2), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.RandomState(2)
    B, frames = 2, 170
    x = rng.randint(0, 256, (B, frames * 10)).astype(np.int32)
    h = rng.randn(B, frames, jc.n_aux).astype(np.float32)
    want = np.asarray(J.wavenet_forward(jp, jc, jnp.asarray(x), jnp.asarray(h),
                                        bf16_intermediates=True))
    got = P.wavenet_forward(pp, pc, torch.as_tensor(x).long(),
                            torch.as_tensor(h), fused=True)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 0.15, np.abs(got - want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_fused_constraint_is_hoppers():
    flag = P.WaveNetConfig(compute_dtype="bfloat16", upsampling_factor=80)
    assert tk.fused_train_constraint_error(flag, 23040) is None
    assert tk.supports_fused_train(flag, 5)        # no tile-count cadence
    for kw, what in ((dict(kernel_size=4), "kernel_size"),
                     (dict(n_skipch=96), "n_skipch"),
                     (dict(n_resch=96), "n_resch"),
                     (dict(n_aux=AUX_MAX + 1), "n_aux"),
                     (dict(n_resch=tk.MAX_RESCH + 128), "n_resch")):
        cfg = P.WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
        assert what in tk.fused_train_constraint_error(cfg, 20000), kw
    # every aux width to AUX_MAX, and residual streams to MAX_RESCH
    for kw in (dict(n_aux=200), dict(n_aux=AUX_MAX),
               dict(n_resch=1152), dict(n_resch=tk.MAX_RESCH)):
        cfg = P.WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
        assert tk.fused_train_constraint_error(cfg, 20000) is None, kw
    assert "empty" in tk.fused_train_constraint_error(flag, 0)
    # the ljspeech flagship (egs/ljspeech/sd/run.sh) fits, at both aux widths
    for n_aux in (39, 80):
        lj = P.WaveNetConfig(n_aux=n_aux, kernel_size=3, upsampling_factor=110,
                             compute_dtype="bfloat16")
        assert tk.fused_train_constraint_error(lj, 21120) is None
    # the product core's ring streams K in 64-deep stages: one block's
    # shared memory is the same at every width, so the widths the first
    # kernels' staged rows refused (n_resch 1024; kernel_size 3 from 640)
    # now run
    smem = tk._smem_bytes(flag)
    assert smem == tk._smem_bytes(P.WaveNetConfig(
        kernel_size=3, n_resch=1024, n_aux=96, compute_dtype="bfloat16"))
    assert max(smem.values()) <= 232448
    for kw in (dict(n_resch=1024), dict(kernel_size=3, n_resch=640),
               dict(kernel_size=3, n_resch=1024)):
        cfg = P.WaveNetConfig(**dict(dict(compute_dtype="bfloat16"), **kw))
        assert tk.fused_train_constraint_error(cfg, 20000) is None, kw
        assert tk.layer_stack_constraint_error(cfg) is None, kw


def test_fused_forward_refuses_f32_and_outside_the_envelope():
    _, pc = _cfgs(n_resch=16, n_skipch=16, n_aux=8)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(0))
    x = torch.zeros((1, 64), dtype=torch.int64)
    h = torch.zeros((1, 64, pc.n_aux))
    with pytest.raises(ValueError, match="envelope.*n_resch"):
        P.wavenet_forward(pp, pc, x, h, fused=True)
    _, pf = _cfgs(compute_dtype="float32")
    pp = P.init_wavenet_params(pf, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bfloat16"):
        P.wavenet_forward(pp, pf, x, torch.zeros((1, 64, pf.n_aux)),
                          fused=True)


def test_wrappers_refuse_other_devices():
    _, pc = _cfgs()
    lw = tk.layer_weights(P.init_wavenet_params(pc, device="meta"))
    s0 = torch.empty((1, 40, pc.n_resch), dtype=BF, device="meta")
    h = torch.empty((1, 40, pc.n_aux), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.layer_stack_fwd_train(lw, pc, s0, h)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.layer_stack_bwd(lw, pc, s0, s0, s0, h,
                           torch.empty((1, 40, pc.n_skipch), device="meta"))
