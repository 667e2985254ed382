"""The AR sample loop: the plain version of the AR kernel (K1) against the
JAX decoders, and the port's naive == fast == batched invariant."""

import numpy as np
import pytest
import torch
from scipy.stats import chi2

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.ops.ar_kernel import pallas_ar_generate

from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak

torch.set_num_threads(2)


def _cfgs(**kw):
    base = dict(n_quantize=256, n_aux=8, n_resch=16, n_skipch=16,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="float64")
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _params(jc, seed):
    jp = J.init_wavenet_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _seed_inputs(jc, B, n, seed, extra=0):
    rng = np.random.RandomState(seed)
    T = jc.receptive_field + extra
    x = rng.randint(0, 256, (B, T)).astype(np.int32)
    h = rng.randn(B, T + n, jc.n_aux).astype(np.float32)
    return x, h


def _to_torch(carry):
    return tuple(torch.tensor(np.asarray(c)) for c in carry)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_argmax_bit_equal_to_jax_scan_f64(kernel_size):
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp = _params(jc, 3)
    n = 30
    x, h = _seed_inputs(jc, 3, n, seed=3, extra=4)
    xj, hj = J._pad_seed(jc, jnp.asarray(x), jnp.asarray(h, jnp.float64))
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    want = np.asarray(J._scan_from_state(jp, jc, carry, hj, T0, n, "argmax",
                                         jax.random.PRNGKey(0)))
    # the loop alone, from the JAX carry
    got = ak.ar_generate_reference(pp, pc, _to_torch(carry),
                                   torch.tensor(np.asarray(hj)), T0, n,
                                   "argmax")
    np.testing.assert_array_equal(got.numpy(), want)
    # warm-up and loop of the port
    pcarry = P._warmup_state(pp, pc, torch.as_tensor(x),
                             torch.as_tensor(h, dtype=torch.float64))
    got = ak.ar_generate_reference(pp, pc, pcarry,
                                   torch.as_tensor(h, dtype=torch.float64),
                                   T0, n, "argmax")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel_size,upsampling_factor",
                         [(2, 0), (3, 0), (2, 10)])
def test_naive_equals_fast_equals_batched_f64(kernel_size, upsampling_factor):
    """The load-bearing invariant (tests/test_wavenet.py:111-173): naive
    full-forward AR == ring-buffer AR == batched ring-buffer AR, ragged."""
    _, pc = _cfgs(kernel_size=kernel_size,
                  upsampling_factor=upsampling_factor)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(6))
    n_list = [18, 7, 12]
    B = len(n_list)
    rng = np.random.RandomState(6)
    x = rng.randint(0, 256, (B, pc.receptive_field)).astype(np.int32)
    uf = max(upsampling_factor, 1)
    Th = -(-(pc.receptive_field + max(n_list)) // uf)
    h = rng.randn(B, Th, pc.n_aux).astype(np.float32)
    batch = P.batch_fast_generate(pp, pc, x, h, n_list, mode="argmax")
    assert [len(b) for b in batch] == n_list
    for b, n in enumerate(n_list):
        fast = P.fast_generate(pp, pc, x[b:b + 1], h[b:b + 1], n,
                               mode="argmax")
        naive = P.generate(pp, pc, x[b:b + 1], h[b:b + 1], n, mode="argmax")
        np.testing.assert_array_equal(naive, fast)
        np.testing.assert_array_equal(batch[b], fast)


def test_short_seed_padded_like_jax():
    jc, pc = _cfgs()
    jp, pp = _params(jc, 5)
    n = 15
    x = np.full((1, 1), 128, np.int32)
    h = np.random.RandomState(5).randn(1, n + 1, jc.n_aux).astype(np.float32)
    want = J.fast_generate(jp, jc, x, h, n, mode="argmax")
    got = P.fast_generate(pp, pc, x, h, n, mode="argmax")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.generate(pp, pc, x, h, n, mode="argmax"),
                                  got)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_bf16_matches_pallas_interpret(kernel_size):
    """At tests/test_ar_kernel.py's bf16 config (B=4, n=20) the plain loop
    takes the Pallas kernel's bf16 matmul inputs with f32 accumulation on
    the same carry (kernel_size 3: raw bf16 rings, two lagged taps); its
    argmax samples are bit-equal here (a near-tie of two logits within f32
    summation noise could flip one)."""
    jc, pc = _cfgs(n_aux=28, n_resch=128, n_skipch=128,
                   compute_dtype="bfloat16", kernel_size=kernel_size)
    jp, pp = _params(jc, 3)
    B, n = 4, 20
    x, h = _seed_inputs(jc, B, n, seed=0)
    xj, hj = J._pad_seed(jc, jnp.asarray(x), jnp.asarray(h, jnp.float32))
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    want = np.asarray(pallas_ar_generate(jp, jc, carry, hj, T0, n, "argmax",
                                         jax.random.PRNGKey(0),
                                         interpret=True))
    tc = tuple(torch.tensor(np.asarray(c.astype(jnp.float32))).to(
        torch.bfloat16 if i == 0 else torch.int32) for i, c in enumerate(carry))
    got = ak.ar_generate(pp, pc, tc, torch.tensor(np.asarray(hj)), T0, n,
                         "argmax")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_float32_conf_kernel_route_matches_jax(kernel_size):
    """A float32 conf on the CUDA route runs as the bf16 conf on the same
    weights (``_kernel_config``).  Its warm-up ring (the warm-up kernel's
    route, which takes its plain version for CPU tensors) against JAX
    ``_warmup_state`` on the float32 conf: each of the 6 layers rounds its
    stream to bf16 (2^-8 relative), so the ring moves by a few bf16 ulps,
    <= 2e-2 of max|ring|.  The plain bf16 loop (the kernels' yardstick) on
    JAX's ring against JAX's Pallas kernel (interpret mode) on the float32
    conf, which casts its weights and ring to bf16: bit-equal argmax, as
    in ``test_bf16_matches_pallas_interpret``."""
    jc, pc = _cfgs(n_aux=28, n_resch=128, n_skipch=128,
                   compute_dtype="float32", kernel_size=kernel_size)
    jp, pp = _params(jc, 3)
    B, n = 4, 20
    x, h = _seed_inputs(jc, B, n, seed=0)
    xj, hj = J._pad_seed(jc, jnp.asarray(x), jnp.asarray(h, jnp.float32))
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    want = np.asarray(pallas_ar_generate(jp, jc, carry, hj, T0, n, "argmax",
                                         jax.random.PRNGKey(0),
                                         interpret=True))
    kc = P._kernel_config(pc)
    assert kc.compute_dtype == "bfloat16"
    ht = torch.tensor(np.asarray(hj))
    ring, _hist, _prev = P._warmup_state(
        pp, kc, torch.tensor(np.asarray(xj)).long(), ht,
        bf16_intermediates=True, impl="cuda")
    jring = torch.tensor(np.asarray(carry[0]))
    assert ring.dtype == torch.bfloat16 and ring.shape == jring.shape
    assert ((ring.float() - jring).abs().max().item()
            <= 2e-2 * jring.abs().max().item())
    tc = (jring.to(torch.bfloat16),) + tuple(
        torch.tensor(np.asarray(c)).to(torch.int32) for c in carry[1:])
    got = ak.ar_generate_reference(pp, kc, tc, ht, T0, n, "argmax")
    np.testing.assert_array_equal(got.numpy(), want)


def test_aux_bias_matches_jax_scan():
    """The port keeps the aux bias ``aux.b`` (reference ``aux_1x1_*.bias``):
    with a nonzero aux.b the plain loop (and so the kernel, which folds it
    into its gate bias) matches JAX ``_scan_from_state`` bit-for-bit in
    argmax.  The JAX Pallas kernel drops aux.b (its ``_pack_weights``
    omits it): a fault of the reference, ROADMAP Queue 3."""
    jc, pc = _cfgs(n_resch=32, n_skipch=32, compute_dtype="float32")
    jp, _ = _params(jc, 9)
    rng = np.random.RandomState(9)
    jp["aux"]["b"] = jnp.asarray(
        rng.uniform(-0.5, 0.5, jp["aux"]["b"].shape).astype(np.float32))
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    n = 20
    x, h = _seed_inputs(jc, 4, n, seed=9)
    xj, hj = jnp.asarray(x), jnp.asarray(h)
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    want = np.asarray(J._scan_from_state(jp, jc, carry, hj, T0, n, "argmax",
                                         jax.random.PRNGKey(0)))
    got = ak.ar_generate(pp, pc, _to_torch(carry), torch.tensor(h), T0, n,
                         "argmax")
    np.testing.assert_array_equal(got.numpy(), want)
    # the bias matters here: dropped, the samples differ
    pp["aux"]["b"] = torch.zeros_like(pp["aux"]["b"])
    dropped = ak.ar_generate(pp, pc, _to_torch(carry), torch.tensor(h), T0,
                             n, "argmax")
    assert not np.array_equal(dropped.numpy(), want)


def _chi_square_p(counts, probs):
    """Pearson chi-square p-value, the rarest classes pooled until every
    bin expects >= 5."""
    exp = probs * counts.sum()
    obs_b, exp_b, acc_o, acc_e = [], [], 0.0, 0.0
    for i in np.argsort(exp):
        acc_o += counts[i]
        acc_e += exp[i]
        if acc_e >= 5:
            obs_b.append(acc_o)
            exp_b.append(acc_e)
            acc_o = acc_e = 0.0
    obs_b[-1] += acc_o
    exp_b[-1] += acc_e
    obs_b, exp_b = np.asarray(obs_b), np.asarray(exp_b)
    stat = ((obs_b - exp_b) ** 2 / exp_b).sum()
    return chi2.sf(stat, len(obs_b) - 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sampling_chi_square_against_softmax(dtype):
    _, pc = _cfgs(compute_dtype=dtype)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(8))
    pp["post2"]["w"] = pp["post2"]["w"] * 4   # a peaked, uneven softmax
    x, h = _seed_inputs(pc, 1, 1, seed=8)
    x, h = torch.as_tensor(x), torch.as_tensor(h)
    ring, hist, prev = P._warmup_state(pp, pc, x, h)
    T0 = x.shape[1]
    logits = ak.ar_step_logits(ak._step_weights(pp, pc), pc, ring.clone(),
                               torch.cat([hist, prev[:, None]], dim=1), h,
                               T0 - 1)
    probs = torch.softmax(logits[0].double(), dim=0).numpy()
    N = 20000
    carry = (ring.expand(-1, N, -1).contiguous(), hist.expand(N, -1).clone(),
             prev.expand(N).clone())
    s = ak.ar_generate(pp, pc, carry, h.expand(N, -1, -1), T0, 1, "sampling",
                       torch.Generator().manual_seed(9))
    counts = np.bincount(s[:, 0].numpy(), minlength=pc.n_quantize)
    assert _chi_square_p(counts, probs) >= 1e-3


def test_sampling_seeded_and_chunked_stream_identical():
    _, pc = _cfgs(compute_dtype="float32")
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(2))
    x, h = _seed_inputs(pc, 2, 40, seed=2)

    def run(seed, intervals=None, mode="sampling"):
        return P.batch_fast_generate(pp, pc, x, h, [40, 33], mode=mode,
                                     generator=torch.Generator().manual_seed(
                                         seed), intervals=intervals)

    a, b, c = run(0), run(0), run(1)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert any((u != v).any() for u, v in zip(a, c))
    for mode in ("sampling", "argmax"):
        for u, v in zip(run(3, mode=mode), run(3, intervals=9, mode=mode)):
            np.testing.assert_array_equal(u, v)


def test_carry_updated_in_place_continues_the_stream():
    jc, pc = _cfgs(kernel_size=3)
    _, pp = _params(jc, 4)
    x, h = _seed_inputs(jc, 2, 25, seed=4)
    x, h = torch.as_tensor(x), torch.as_tensor(h, dtype=torch.float64)
    T0 = x.shape[1]
    carry = P._warmup_state(pp, pc, x, h)
    whole = ak.ar_generate_reference(pp, pc, tuple(t.clone() for t in carry),
                                     h, T0, 25, "argmax")
    first = ak.ar_generate_reference(pp, pc, carry, h, T0, 10, "argmax")
    rest = ak.ar_generate_reference(pp, pc, carry, h, T0, 15, "argmax", i0=10)
    np.testing.assert_array_equal(torch.cat([first, rest], 1).numpy(),
                                  whole.numpy())
    assert int(carry[2][0]) == int(whole[0, -1])


def test_kernel_weight_pack_layout():
    """The CUDA kernel's pack: current tap with sigmoid/tanh columns
    interleaved in groups of 8, then the past tap; skip|res fused."""
    _, pc = _cfgs(n_resch=128, n_skipch=128, compute_dtype="bfloat16")
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(1))
    pk = ak.pack_ar_weights(pp, pc)
    R, bf = pc.n_resch, torch.bfloat16
    cur = pp["dil"]["w"][:, 1].to(bf)
    w4 = pk["w4"]
    assert w4.shape == (pc.n_layers, R, 4 * R) and w4.dtype == bf
    for q in range(R // 8):
        torch.testing.assert_close(w4[:, :, 16 * q: 16 * q + 8],
                                   cur[:, :, 8 * q: 8 * q + 8], rtol=0, atol=0)
        torch.testing.assert_close(w4[:, :, 16 * q + 8: 16 * q + 16],
                                   cur[:, :, R + 8 * q: R + 8 * q + 8],
                                   rtol=0, atol=0)
    torch.testing.assert_close(w4[:, :, 2 * R:], pp["dil"]["w"][:, 0].to(bf),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        pk["zb"], pp["dil"]["b"] + pp["aux"]["b"], rtol=0, atol=0)
    assert pk["wsr"].shape == (pc.n_layers, R, pc.n_skipch + R)


def test_kernel_weight_pack_layout_kernel_size_3():
    """kernel_size 3: the gate pack is [current | lag d | lag 2d], every
    block interleaved like the current tap (all three feed the gate); lag
    j*d multiplies dil_w[2 - j], as in the JAX pack."""
    _, pc = _cfgs(n_resch=128, n_skipch=128, compute_dtype="bfloat16",
                  kernel_size=3)
    pp = P.init_wavenet_params(pc, torch.Generator().manual_seed(1))
    pk = ak.pack_ar_weights(pp, pc)
    R, bf = pc.n_resch, torch.bfloat16
    w6 = pk["w6"]
    assert "w4" not in pk
    assert w6.shape == (pc.n_layers, R, 6 * R) and w6.dtype == bf
    for j in range(3):
        blk = w6[:, :, 2 * R * j: 2 * R * (j + 1)]
        torch.testing.assert_close(ak._deinterleave(blk),
                                   pp["dil"]["w"][:, 2 - j].to(bf),
                                   rtol=0, atol=0)
    assert pk["causal_w"].shape == (3, pc.n_quantize, R)
