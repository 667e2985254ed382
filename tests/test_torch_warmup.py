"""The warm-up: the plain version of the layer-stack kernel (K2) against the
JAX Pallas kernel in interpret mode and its JAX replica, and the port's
``_warmup_state`` carry against the JAX one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.ops import train_kernel as jtk

from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

torch.set_num_threads(2)


def _cfgs(**kw):
    base = dict(n_quantize=256, n_aux=20, n_resch=128, n_skipch=128,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _stack_data(jc, B=2, T=1700, seed=0):
    """The size tests/test_train_kernel.py::test_fused_forward_bit_exact
    runs: B=2, T=1700, 3x2 layers, R=S=128, A=20."""
    jp = J.init_wavenet_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.RandomState(seed)
    stream0 = (rng.randn(B, T, jc.n_resch) * 0.5).astype(np.float32)
    h_up = rng.randn(B, T, jc.n_aux).astype(np.float32)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jp, pp, stream0, h_up


def _layer_close(got, want, name):
    """One layer on the same bf16 input in two implementations: each rounds
    to bf16 after sums taken in another order, so a few elements land one
    bf16 ulp (2^-8 of their magnitude) away.  Worst element within 5e-3 of
    max|stream|, and at most 0.5% of the elements differ."""
    d = np.abs(got - want)
    scale = np.abs(want).max()
    assert d.max() <= 5e-3 * scale, (name, d.max(), scale)
    assert (d > 0).mean() <= 5e-3, (name, (d > 0).mean())


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_streams_match_pallas_interpret(kernel_size):
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp, stream0, h_up = _stack_data(jc)
    _, (_x0, s_arr, _st, _hb) = jtk._fwd_pallas(
        jc, jtk._layer_weights(jp), jnp.asarray(stream0), jnp.asarray(h_up),
        interpret=True, save_st=False)
    s_arr = np.asarray(s_arr.astype(jnp.float32))
    got = tk.layer_stack_streams(tk.layer_weights(pp), pc,
                                 torch.as_tensor(stream0),
                                 torch.as_tensor(h_up))
    T = stream0.shape[1]
    assert len(got) == pc.n_layers
    np.testing.assert_array_equal(
        got[0].float().numpy(),
        np.asarray(jnp.asarray(stream0).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    lw = tk.layer_weights(pp)
    hb = torch.as_tensor(h_up).to(torch.bfloat16)
    for l in range(1, pc.n_layers):
        want = s_arr[l - 1, :, :T]
        assert got[l].dtype == torch.bfloat16
        # chained: one-ulp flips feed the later layers' sums
        assert np.abs(got[l].float().numpy() - want).max() <= \
            1e-2 * np.abs(want).max(), l
        # layer l-1 alone, on the Pallas kernel's own input stream
        prev = got[0] if l == 1 else torch.tensor(s_arr[l - 2, :, :T])
        one, _ = tk.ref_layer(lw, l - 1, pc.dilations[l - 1],
                              prev.to(torch.bfloat16), hb)
        _layer_close(one.float().numpy(), want, f"layer {l - 1}")


def test_skip_sum_matches_jax_ref_layer_stack():
    jc, pc = _cfgs()
    jp, pp, stream0, h_up = _stack_data(jc, T=600, seed=1)
    want = np.asarray(jtk.ref_layer_stack(jtk._layer_weights(jp), jc,
                                          jnp.asarray(stream0),
                                          jnp.asarray(h_up)))
    streams, skip = tk.ref_layer_stack_streams(
        tk.layer_weights(pp), pc, torch.as_tensor(stream0),
        torch.as_tensor(h_up), return_skip=True)
    assert len(streams) == pc.n_layers
    # the f32 skip sum inherits the streams' bf16 ulp flips (see
    # _layer_close), chained over the layers: 1e-2 of max|skip|
    assert np.abs(skip.numpy() - want).max() <= 1e-2 * np.abs(want).max()


def _carry_inputs(jc, B, n, seed):
    rng = np.random.RandomState(seed)
    T = jc.receptive_field + 5
    x = rng.randint(0, 256, (B, T)).astype(np.int32)
    h = rng.randn(B, T + n, jc.n_aux).astype(np.float32)
    return x, h


# f64: the same op sequence in both frameworks, to 1e-10.  f32: GEMM sums
# in another order (~1e-7 relative each) through six layers and the ring
# projection: 1e-5 of max|ring|.
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_warmup_state_matches_jax(kernel_size, dtype):
    jc, pc = _cfgs(kernel_size=kernel_size, compute_dtype=dtype,
                   n_resch=16, n_skipch=16, n_aux=8)
    jp = J.init_wavenet_params(jax.random.PRNGKey(4), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    x, h = _carry_inputs(jc, 3, 4, seed=4)
    (want, want_max) = J._warmup_state(jp, jc, jnp.asarray(x),
                                       jnp.asarray(h), collect_act_maxes=True)
    got, got_max = P._warmup_state(pp, pc, torch.as_tensor(x),
                                   torch.as_tensor(h), collect_act_maxes=True)
    ring_w, ring_g = np.asarray(want[0]), got[0].numpy()
    assert ring_g.shape == ring_w.shape and ring_g.dtype == ring_w.dtype
    tol = 1e-10 if dtype == "float64" else 1e-5 * np.abs(ring_w).max()
    assert np.abs(ring_g - ring_w).max() <= tol
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got_max.numpy(), np.asarray(want_max),
                               rtol=1e-5)


def test_warmup_bf16_ring_close_to_jax():
    """bf16 warm-up with bf16 intermediates (the production decode
    setting) on the CPU: both take ``_forward_collect``'s path."""
    jc, pc = _cfgs(n_resch=32, n_skipch=32, n_aux=8)
    jp = J.init_wavenet_params(jax.random.PRNGKey(5), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    x, h = _carry_inputs(jc, 2, 4, seed=5)
    want = J._warmup_state(jp, jc, jnp.asarray(x), jnp.asarray(h),
                           bf16_intermediates=True)
    got = P._warmup_state(pp, pc, torch.as_tensor(x), torch.as_tensor(h),
                          bf16_intermediates=True)
    ring_w = np.asarray(want[0].astype(jnp.float32))
    ring_g = got[0].float().numpy()
    assert got[0].dtype == torch.bfloat16
    assert np.abs(ring_g - ring_w).max() <= 2e-2 * np.abs(ring_w).max()


def test_warmup_kernel_path_needs_bf16_intermediates():
    _, pc = _cfgs(n_resch=16, n_skipch=16, n_aux=8)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(0))
    x = torch.zeros((1, pc.receptive_field), dtype=torch.int64)
    h = torch.zeros((1, pc.receptive_field, pc.n_aux))
    with pytest.raises(ValueError, match="bf16_intermediates"):
        P._warmup_state(pp, pc, x, h, bf16_intermediates=False, impl="cuda")
