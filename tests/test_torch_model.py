"""The port's model core against the JAX package: params bridge, building
blocks and the forward pass, on the same numpy params and inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J

from pytorchwavenetvocoder_tpu_torch.convert import (
    config_from_json_conf,
    params_from_jax,
)
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P

torch.set_num_threads(2)


def _configs(**kw):
    base = dict(n_quantize=256, n_aux=28, n_resch=16, n_skipch=16,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0)
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _params(jc, seed=0):
    jp = J.init_wavenet_params(jax.random.PRNGKey(seed), jc)
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, params_from_jax(tree)


def test_params_from_jax_keeps_keys_shapes_values():
    jc, _ = _configs(upsampling_factor=80, kernel_size=3)
    _, tree, pp = _params(jc)
    assert pp.keys() == tree.keys()
    for group, leaves in tree.items():
        assert pp[group].keys() == leaves.keys()
        for name, v in leaves.items():
            t = pp[group][name]
            assert tuple(t.shape) == v.shape
            assert t.dtype == torch.float32 and v.dtype == np.float32
            np.testing.assert_array_equal(t.numpy(), v)


def test_init_layout_matches_jax():
    jc, pc = _configs(upsampling_factor=10)
    _, tree, _ = _params(jc)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(0))
    for group, leaves in tree.items():
        for name, v in leaves.items():
            assert tuple(pp[group][name].shape) == v.shape
    np.testing.assert_array_equal(pp["upsampling"]["w"].numpy(), 1.0)
    # Xavier bound of the fused gate conv: sqrt(6 / (R k + R k))
    bound = np.sqrt(6.0 / (2 * 16 * 2))
    assert float(pp["dil"]["w"].abs().max()) <= bound


# f64: both frameworks run the same f64 op sequence; sums in another order
#   differ by a few ulps, far below 1e-10.
# f32: XLA and ATen block their f32 GEMM sums differently (~1e-7 relative
#   per dot); six layers of gates and the post stack keep the logits within
#   1e-4 of max|logit|.
@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("upsampling_factor", [0, 80])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_forward_matches_jax(kernel_size, upsampling_factor, dtype):
    jc, pc = _configs(kernel_size=kernel_size,
                      upsampling_factor=upsampling_factor,
                      compute_dtype=dtype)
    jp, _, pp = _params(jc, seed=1)
    rng = np.random.RandomState(1)
    T = 240
    x = rng.randint(0, 256, (2, T)).astype(np.int32)
    Th = T // upsampling_factor if upsampling_factor else T
    h = rng.randn(2, Th, jc.n_aux).astype(np.float32)
    want = np.asarray(J.wavenet_forward(jp, jc, jnp.asarray(x),
                                        jnp.asarray(h)))
    got = P.wavenet_forward(pp, pc, torch.as_tensor(x),
                            torch.as_tensor(h)).numpy()
    assert got.shape == want.shape == (2, T, 256)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_bf16_intermediates_forward_close_to_jax():
    # bf16 storage of every gate input and stream: a one-ulp (2^-8)
    # rounding flip in one framework moves the logits by that much
    jc, pc = _configs(compute_dtype="bfloat16")
    jp, _, pp = _params(jc, seed=2)
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (2, 120)).astype(np.int32)
    h = rng.randn(2, 120, jc.n_aux).astype(np.float32)
    want = np.asarray(J.wavenet_forward(jp, jc, jnp.asarray(x),
                                        jnp.asarray(h),
                                        bf16_intermediates=True))
    got = P.wavenet_forward(pp, pc, torch.as_tensor(x), torch.as_tensor(h),
                            bf16_intermediates=True).float().numpy()
    assert np.abs(got - want.astype(np.float32)).max() <= \
        2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_input_embed_exact(dtype, kernel_size):
    jc, pc = _configs(compute_dtype=dtype, kernel_size=kernel_size)
    jp, _, pp = _params(jc, seed=3)
    rng = np.random.RandomState(3)
    # ids outside [0, Q) wrap mod Q
    x = rng.randint(-300, 600, (3, 50)).astype(np.int32)
    want = np.asarray(J.input_embed(jnp.asarray(x), jp, jc))
    got = P.input_embed(torch.as_tensor(x), pp, pc).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_upsample_aux_exact():
    jc, pc = _configs(upsampling_factor=80)
    jp, tree, _ = _params(jc)
    rng = np.random.RandomState(4)
    tree["upsampling"]["w"] = rng.randn(80).astype(np.float32)
    tree["upsampling"]["b"] = np.float32(0.3)
    jp["upsampling"] = {k: jnp.asarray(v) for k, v in tree["upsampling"].items()}
    pp = params_from_jax(tree)
    h = rng.randn(2, 7, jc.n_aux).astype(np.float32)
    want = np.asarray(J.upsample_aux(jp, jc, jnp.asarray(h)))
    got = P.upsample_aux(pp, pc, torch.as_tensor(h)).numpy()
    assert got.shape == (2, 560, jc.n_aux)
    np.testing.assert_array_equal(got, want)


def test_wavenet_module_loads_jax_params():
    jc, pc = _configs(upsampling_factor=10)
    jp, tree, _ = _params(jc, seed=5)
    net = P.WaveNet(pc).load_jax_params(tree)
    assert net.receptive_field == jc.receptive_field
    rng = np.random.RandomState(5)
    x = rng.randint(0, 256, (1, 50)).astype(np.int32)
    h = rng.randn(1, 5, jc.n_aux).astype(np.float32)
    want = np.asarray(J.wavenet_forward(jp, jc, jnp.asarray(x),
                                        jnp.asarray(h)))
    got = net(x, h).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert sorted(dict(net.named_parameters())) == sorted(
        f"layers.{g}.{n}" for g, leaves in tree.items() for n in leaves)


def test_config_from_json_conf():
    conf = dict(J.WaveNetConfig(upsampling_factor=80).to_dict(),
                use_upsampling_layer=False, feature_type="world")
    assert config_from_json_conf(conf).upsampling_factor == 0
    conf["use_upsampling_layer"] = True
    cfg = config_from_json_conf(conf)
    assert cfg.upsampling_factor == 80 and cfg.receptive_field == 3070
    with pytest.raises(ValueError):
        P.WaveNetConfig(compute_dtype="float16")


def test_mu_law_numpy_and_torch_match_jax():
    from pytorchwavenetvocoder_tpu.ops import mulaw as jmu

    from pytorchwavenetvocoder_tpu_torch.ops import mulaw as pmu

    rng = np.random.RandomState(7)
    x = np.concatenate([rng.uniform(-1, 1, 5000), [-1.0, 0.0, 1.0]])
    want = jmu.encode_mu_law(x, 256)
    np.testing.assert_array_equal(pmu.encode_mu_law(x, 256), want)
    np.testing.assert_array_equal(
        pmu.encode_mu_law_torch(torch.as_tensor(x), 256).numpy(), want)
    ids = np.arange(256)
    np.testing.assert_array_equal(pmu.decode_mu_law(ids, 256),
                                  jmu.decode_mu_law(ids, 256))
    np.testing.assert_allclose(
        pmu.decode_mu_law_torch(torch.as_tensor(ids), 256).numpy(),
        np.asarray(jmu.decode_mu_law_jax(jnp.asarray(ids), 256)),
        rtol=1e-6, atol=1e-7)
