"""int8 decode past n_resch 1,024 on the CPU: the plain int8 loop's
integer products are exact at every width (``ops/ar_kernel.py::
int8_product``), so the port serves the widths the JAX int8 kernel takes.

- The product: operands whose exact sum passes 2^24 and is no f32 value.
  The port's product equals the exact int64 sum rounded once to f32, and
  JAX's ``jnp.dot(int8, int8, preferred_element_type=jnp.int32)`` cast to
  f32 (what its int8 Pallas kernel computes, `ops/ar_kernel.py:558-562`
  there), bit for bit.  An f32 accumulation of the same products in K
  order, the old plain loop's f32 sums, misses.
- The loop at n_resch 1,152 (9 x 128, which JAX's ``supports_pallas_ar``
  takes): argmax samples bit-equal to JAX's int8 Pallas kernel in
  interpret mode on the same carry and scales (``aux.b = 0``, as that
  kernel drops the aux bias; tests/test_torch_int8.py says why).  It
  needs the weight scales as that kernel computes them under jit,
  ``max |w| * fl(1/127)``: at this width the division by 127 rounds 194
  of the seed's column scales an ulp apart, and the logits then move by
  ~5e-3.
- ``bin/decode.py --quantize`` at n_resch 1,152 writes the wavs of the
  library call.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.ops import ar_kernel as jak

from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
from test_torch_int8 import _bundle, _carry_to_torch

torch.set_num_threads(2)

#: 9 x 128: past the first int8 route's 1,024, and on JAX's 128 grid
WIDE_R = 1152


def _past_2_24_operands(K=WIDE_R):
    """(4, K) activations and (K, 6) weights, int8 values, whose exact
    column sums pass 2^24: every activation +127 and
    col 0: +127 on every row (127^2 K, even: an f32 value);
    col 1: as col 0 but one weight 126 (odd: no f32 value);
    col 2: as col 0 but one weight 1 (odd);
    col 3: alternating 127 and 125 (odd products, sum even);
    col 4: seeded in [120, 127] (odd or even, row by row);
    col 5: as col 4 but negative, so the sums pass -2^24.
    Row 1 has one activation 1 and row 2 one activation -127 against
    them, so the rows differ."""
    rng = np.random.RandomState(0)
    a = np.full((4, K), 127, np.int8)
    a[1, 5] = 1
    a[2, 7] = -127
    w = np.full((K, 6), 127, np.int8)
    w[3, 1] = 126
    w[9, 2] = 1
    w[1::2, 3] = 125
    w[:, 4] = rng.randint(120, 128, K)
    w[:, 5] = -rng.randint(120, 128, K)
    return a, w


def test_int8_product_is_the_exact_sum_rounded_once():
    a, w = _past_2_24_operands()
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert (np.abs(exact) > 2 ** 24).all()
    once = exact.astype(np.float64).astype(np.float32)
    assert (once.astype(np.int64) != exact).any()        # no f32 value
    got = ak.int8_product(torch.tensor(a), torch.tensor(w)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, once)
    # JAX's int8 kernel: int32 accumulation, then one cast to f32
    jx = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(w),
                            preferred_element_type=jnp.int32
                            ).astype(jnp.float32))
    np.testing.assert_array_equal(got, jx)
    # the operands the loop hands it: integer-valued f32 activations and
    # float64 weights (``_step_weights``), and the int8 ring rows as they are
    got = ak.int8_product(torch.tensor(a, dtype=torch.float32),
                          torch.tensor(w, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, once)
    # control: the same products summed in f32, in K order (an f32
    # accumulator walking K: the old plain loop's f32 sums) miss
    acc = np.zeros(once.shape, np.float32)
    for k in range(a.shape[1]):
        acc = acc + (a[:, k:k + 1].astype(np.float32)
                     * w[k:k + 1].astype(np.float32))
    assert (acc != once).any()
    assert (acc != jx).any()


def _cfgs(kernel_size):
    """n_resch 1,152, n_skipch 256, 3 x 1 layers, bf16."""
    base = dict(n_quantize=256, n_aux=28, n_resch=WIDE_R, n_skipch=256,
                dilation_depth=3, dilation_repeat=1, kernel_size=kernel_size,
                upsampling_factor=0, compute_dtype="bfloat16")
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_weight_scales_at_n_resch_1152_are_the_jax_kernels(kernel_size):
    """The int8 column scales and weights at n_resch 1,152 equal the JAX
    kernel's quantization as it runs, under jit (ops/ar_kernel.py:481-485
    there), bit for bit; the division by 127 evaluated eagerly, the
    formula as written, differs in some columns at this width."""
    jc, pc = _cfgs(kernel_size)
    jp = J.init_wavenet_params(jax.random.PRNGKey(21), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    wpack = jak._pack_weights(jp, jc)[0]

    def scales(wpack):
        wf = wpack.astype(jnp.float32)
        return jnp.maximum(jnp.max(jnp.abs(wf), axis=1), 1e-8) / 127.0

    want = np.asarray(jax.jit(scales)(wpack))
    q = ak.quantize_ar_weights(pp, pc)
    R, gk = WIDE_R, "w4" if kernel_size == 2 else "w6"
    if kernel_size == 2:
        blocks = [ak._deinterleave(q[gk + "_scale"][:, :2 * R]),
                  q[gk + "_scale"][:, 2 * R:]]
    else:
        blocks = [ak._deinterleave(q[gk + "_scale"][:, 2 * R * j:
                                                    2 * R * (j + 1)])
                  for j in range(3)]
    got = torch.cat(blocks + [q["wsr_scale"]], dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.asarray(scales(wpack)) != want).any()


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_loop_at_n_resch_1152_matches_pallas_interpret(kernel_size):
    """The plain int8 loop against JAX's int8 Pallas kernel (interpret) at
    n_resch 1,152 on the same carry and scales, 8 argmax steps of 4 rows:
    bit-equal samples (tests/test_torch_int8.py's limit at n_resch 128);
    the port's bf16 loop on the same inputs is not."""
    jc, pc = _cfgs(kernel_size)
    assert jak.supports_pallas_ar(jc)
    assert ak.int8_constraint_error(pc) is None
    jp = J.init_wavenet_params(jax.random.PRNGKey(21), jc)
    pp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert not pp["aux"]["b"].any()
    B, n = 4, 8
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (B, jc.receptive_field)).astype(np.int32)
    h = rng.randn(B, jc.receptive_field + n, jc.n_aux).astype(np.float32)
    xj, hj = jnp.asarray(x), jnp.asarray(h)
    T0 = x.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    scales = jak.calibrate_act_scales(jp, jc, xj, hj)
    want = np.asarray(jak.pallas_ar_generate(
        jp, jc, carry, hj, T0, n, "argmax", jax.random.PRNGKey(0),
        interpret=True, quantize=True, act_scales=scales))
    st, ht = torch.tensor(np.asarray(scales)), torch.tensor(h)
    tc = _carry_to_torch(carry)
    if kernel_size == 3:
        tc = (ak.int8_ring_fill(tc[0], st, pc),) + tc[1:]
    got = ak.ar_generate(pp, pc, tc, ht, T0, n, "argmax", quantize=True,
                         act_scales=st)
    np.testing.assert_array_equal(got.numpy(), want)
    bf16 = ak.ar_generate(pp, pc, _carry_to_torch(carry), ht, T0, n,
                          "argmax")
    assert not np.array_equal(bf16.numpy(), want)


def test_decode_cli_quantize_at_n_resch_1152_writes_the_library_wavs(
        tmp_path, monkeypatch):
    """``bin/decode.py --quantize --device cpu`` at n_resch 1,152 writes,
    byte for byte, the wavs of ``batch_fast_generate(quantize=True,
    impl="plain")`` on the batches it reads."""
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law
    from pytorchwavenetvocoder_tpu_torch.utils import write_wav

    common = _bundle(tmp_path, n_resch=WIDE_R, n_skipch=256)
    seen = {}
    real = torch_decode.decode_batches

    def spy(model, batch_iter, outdir, **kw):
        seen.update(model=model, batches=list(batch_iter), kw=kw)
        return real(model, seen["batches"], outdir, **kw)

    monkeypatch.setattr(torch_decode, "decode_batches", spy)
    out_q = tmp_path / "wav_q"
    res = torch_decode.main(common + ["--outdir", str(out_q), "--quantize"])
    model, batches = seen["model"], seen["batches"]
    assert seen["kw"]["quantize"] is True
    assert res["n_utts"] == 3 and len(batches) == 2
    assert model.config.n_resch == WIDE_R
    lib = tmp_path / "wav_lib"
    lib.mkdir()
    names = []
    for feat_ids, (x, h, n_list) in batches:
        out = P.batch_fast_generate(model.params, model.config, x, h,
                                    list(n_list), mode="argmax",
                                    impl="plain", quantize=True)
        for feat_id, samples in zip(feat_ids, out):
            write_wav(str(lib / f"{feat_id}.wav"),
                      decode_mu_law(samples, 256).astype(np.float32), 16000)
            names.append(f"{feat_id}.wav")
    assert sorted(os.listdir(out_q)) == sorted(names) == [
        "u0.wav", "u1.wav", "u2.wav"]
    for name in names:
        assert (out_q / name).read_bytes() == (lib / name).read_bytes(), name
