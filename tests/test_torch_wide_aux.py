"""Conditioning wider than the first AR kernel's 96 aux rows, against the
JAX package, whose kernels take any n_aux: one past 96 (97), a
speaker-coded 128-band mel (129: 128 bands and the speaker-code column)
and 257, at small depth (3 x 2 layers, R = S = 128), kernel_size 2 and 3.

The port's plain versions (what its wrappers run for CPU tensors) against
the JAX decoders (the f64 scan, bit-equal in argmax; the bf16 Pallas K1 in
interpret mode, with ``aux.b`` = 0 as that kernel drops the aux bias), the
Pallas training kernels in interpret mode (the forward with saves and the
backward), and three float64 Adam steps; each with the tolerance of the
n_aux <= 96 test it mirrors (tests/test_torch_ar.py,
tests/test_torch_train_kernel.py, tests/test_torch_train.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.ops import train_kernel as jtk
from pytorchwavenetvocoder_tpu.ops.ar_kernel import pallas_ar_generate
from pytorchwavenetvocoder_tpu.parallel import train as jtr

from pytorchwavenetvocoder_tpu_torch.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk
from pytorchwavenetvocoder_tpu_torch.parallel import train as ptr

torch.set_num_threads(2)

BF = torch.bfloat16
WIDE_AUX = [97, 129, 257]


def _cfgs(**kw):
    base = dict(n_quantize=256, n_aux=129, n_resch=128, n_skipch=128,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="float64")
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _params(jc, seed, aux_b=True, dtype=None):
    """JAX's init with every bias drawn (``aux.b`` zero unless ``aux_b``),
    as (JAX tree of numpy arrays, the port's params)."""
    jp = jax.tree.map(np.asarray, J.init_wavenet_params(
        jax.random.PRNGKey(seed), jc))
    rng = np.random.RandomState(seed)
    for group, leaves in jp.items():
        if "b" in leaves and (aux_b or group != "aux"):
            b = leaves["b"]
            leaves["b"] = (0.05 * rng.randn(*b.shape)).astype(b.dtype)
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, params_from_jax(jp)


def _seed_inputs(jc, B, n, seed):
    rng = np.random.RandomState(seed)
    T = jc.receptive_field
    x = rng.randint(0, 256, (B, T)).astype(np.int32)
    h = rng.randn(B, T + n, jc.n_aux).astype(np.float32)
    return x, h


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_argmax_bit_equal_to_jax_scan_f64(n_aux, kernel_size):
    """The warm-up and the plain loop in float64, with every bias drawn:
    the samples are JAX ``_scan_from_state``'s, bit for bit."""
    jc, pc = _cfgs(n_aux=n_aux, kernel_size=kernel_size)
    jp, pp = _params(jc, 3)
    n = 24
    x, h = _seed_inputs(jc, 3, n, seed=n_aux)
    xj, hj = J._pad_seed(jc, jnp.asarray(x), jnp.asarray(h, jnp.float64))
    T0 = xj.shape[1]
    carry = J._warmup_state(jax.tree.map(jnp.asarray, jp), jc, xj, hj)
    want = np.asarray(J._scan_from_state(
        jax.tree.map(jnp.asarray, jp), jc, carry, hj, T0, n, "argmax",
        jax.random.PRNGKey(0)))
    hp = torch.as_tensor(h, dtype=torch.float64)
    pcarry = P._warmup_state(pp, pc, torch.as_tensor(x), hp)
    got = ak.ar_generate_reference(pp, pc, pcarry, hp, T0, n, "argmax")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_bf16_matches_pallas_interpret(n_aux, kernel_size):
    """bf16 on the JAX carry against the Pallas K1 in interpret mode (B=4,
    n=20, aux.b = 0): the same bf16 products with f32 sums, bit-equal in
    argmax here (a near-tie within f32 summation noise could flip one)."""
    jc, pc = _cfgs(n_aux=n_aux, kernel_size=kernel_size,
                   compute_dtype="bfloat16")
    jp, pp = _params(jc, 3, aux_b=False)
    jp = jax.tree.map(jnp.asarray, jp)
    B, n = 4, 20
    x, h = _seed_inputs(jc, B, n, seed=n_aux + 1)
    xj, hj = J._pad_seed(jc, jnp.asarray(x), jnp.asarray(h, jnp.float32))
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    want = np.asarray(pallas_ar_generate(jp, jc, carry, hj, T0, n, "argmax",
                                         jax.random.PRNGKey(0),
                                         interpret=True))
    tc = tuple(torch.tensor(np.asarray(c.astype(jnp.float32))).to(
        BF if i == 0 else torch.int32) for i, c in enumerate(carry))
    got = ak.ar_generate(pp, pc, tc, torch.tensor(np.asarray(hj)), T0, n,
                         "argmax")
    np.testing.assert_array_equal(got.numpy(), want)


def _stack_data(jc, seed, B=2, T=1000):
    jp, pp = _params(jc, seed, dtype=np.float32)
    rng = np.random.RandomState(seed)
    stream0 = (rng.randn(B, T, jc.n_resch) * 0.5).astype(np.float32)
    h_up = rng.randn(B, T, jc.n_aux).astype(np.float32)
    dskip = rng.randn(B, T, jc.n_skipch).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), pp, stream0, h_up, dskip


def _bf(a) -> torch.Tensor:
    return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(BF)


def _close(want, got, cos_min, rel_max, name):
    a = np.asarray(want, np.float64)
    b = np.asarray(got, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    assert cos > cos_min, (name, cos)
    assert rel < rel_max, (name, rel)


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_stack_forward_and_backward_match_pallas_interpret(n_aux,
                                                           kernel_size):
    """The training forward with saves and its backward against
    ``_fwd_pallas(save_st=True)`` and ``_bwd_pallas`` in interpret mode,
    every bias drawn (the training kernels keep the aux bias).  Forward:
    each layer on the Pallas kernel's own input stream moves sigma | tanh
    by at most a bf16 ulp on at most 0.5% of elements, the chained streams
    within 1e-2 of max|stream|, the skip sum within 1e-2 of its max.
    Backward on the Pallas saves: cos > 0.99999 and max|d| < 1e-2 of
    max|ref| for every gradient, dh_up (n_aux wide) included."""
    jc, pc = _cfgs(n_aux=n_aux, kernel_size=kernel_size,
                   compute_dtype="bfloat16")
    jp, pp, stream0, h_up, dskip = _stack_data(jc, n_aux)
    jlw = jtk._layer_weights(jp)
    skip_j, (x0, streams_j, st_j, hb) = jtk._fwd_pallas(
        jc, jlw, jnp.asarray(stream0), jnp.asarray(h_up), interpret=True,
        save_st=True)
    T, L = stream0.shape[1], pc.n_layers
    lw = tk.layer_weights(pp)
    skip, streams, st = tk.ref_layer_stack(lw, pc, torch.tensor(stream0),
                                           torch.tensor(h_up))
    skip_j = np.asarray(skip_j)
    assert np.abs(skip.numpy() - skip_j).max() <= 1e-2 * np.abs(skip_j).max()
    sj, tj = _bf(streams_j[:L - 1, :, :T]), _bf(st_j[:, :, :T])
    x = torch.tensor(stream0).to(BF)
    hbt = torch.tensor(h_up).to(BF)
    for l, d in enumerate(pc.dilations):
        s, t = tk._ref_gate(lw, l, d, x, hbt)
        diff = (torch.cat([s.to(BF), t.to(BF)], -1).float()
                - tj[l].float()).abs()
        assert diff.max().item() <= 2 ** -8, (l, diff.max().item())
        assert (diff > 0).float().mean().item() <= 5e-3, l
        if l < L - 1:
            want = sj[l].float()
            assert (streams[l].float() - want).abs().max().item() <= \
                1e-2 * want.abs().max().item(), l
            x = sj[l]
    dlw_j, ds0_j, dh_j = jtk._bwd_pallas(jc, jlw, x0, streams_j, st_j, hb,
                                         jnp.asarray(dskip), interpret=True)
    dlw, ds0, dh = tk.ref_layer_stack_bwd(
        lw, pc, _bf(x0[:, :T]), sj, tj, torch.tensor(h_up),
        torch.tensor(dskip))
    assert tuple(dh.shape) == (2, T, n_aux)
    want = {k: np.asarray(v) for k, v in dlw_j.items()}
    want["stream0"] = np.asarray(ds0_j.astype(jnp.float32))
    want["h_up"] = np.asarray(dh_j)
    got = [(k, v.float().numpy()) for k, v in dlw.items()]
    got += [("stream0", ds0.float().numpy()), ("h_up", dh.float().numpy())]
    for name, g in got:
        _close(want[name], g, 0.99999, 1e-2, name)


def _batch(cfg, seed, B=2, T=128):
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randint(100, 156, (1, 16)), (B, T // 16 + 1))[:, :T + 1]
    h = rng.randn(B, T, cfg.n_aux).astype(np.float32)
    return x[:, :-1].astype(np.int32), h, x[:, 1:].astype(np.int32)


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("n_aux", WIDE_AUX)
def test_three_steps_float64_match_jax(n_aux, kernel_size):
    """Three Adam steps in float64 from the same params (every bias drawn)
    and batches: the loss to 1e-10 relative, the params to 1e-10
    absolute, as at n_aux 4 (tests/test_torch_train.py)."""
    jc, pc = _cfgs(n_aux=n_aux, kernel_size=kernel_size,
                   dilation_repeat=1)
    jp, pp = _params(jc, 5, dtype=np.float64)
    js = jtr.create_train_state(jax.random.PRNGKey(5), jc, lr=1e-3,
                                params=jax.tree.map(jnp.asarray, jp))
    ps = ptr.create_train_state(pc, lr=1e-3, params=pp)
    jstep = jtr.make_train_step(jc, lr=1e-3, donate=False)
    pstep = ptr.make_train_step(pc, lr=1e-3)
    for seed in range(3):
        bx, bh, bt = _batch(jc, seed)
        js, jl = jstep(js, bx, bh, bt)
        ps, pl = pstep(ps, bx, bh, bt)
        assert float(pl) == pytest.approx(float(jl), rel=1e-10), seed
    assert pstep.route == "plain"
    got = params_to_jax(ps.params)
    for g, leaves in js.params.items():
        for n, v in leaves.items():
            np.testing.assert_allclose(np.asarray(got[g][n]), np.asarray(v),
                                       rtol=0, atol=1e-10, err_msg=f"{g}.{n}")
