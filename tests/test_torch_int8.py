"""int8 decode (``quantize=True``) on the CPU: the plain version of the AR
kernel's int8 variant against the JAX package's int8 Pallas kernel in
interpret mode, the weight quantization and the warm-up calibration against
the JAX formulas, the slice end to end (library and ``bin/decode.py``), and
fleet auto-capping.

Every comparison with the JAX Pallas kernel keeps ``aux.b = 0`` (as
``init_wavenet_params`` gives it): that kernel drops the aux bias, which
the port keeps (``tests/test_torch_ar.py::test_aux_bias_matches_jax_scan``).
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

torch.set_num_threads(2)


def _cfgs(**kw):
    """tests/test_ar_kernel.py's small_cfg: R=S=128, 3 x 2 layers, bf16."""
    base = dict(n_quantize=256, n_aux=28, n_resch=128, n_skipch=128,
                dilation_depth=3, dilation_repeat=2, kernel_size=2,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _params(jc, seed):
    jp = J.init_wavenet_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _inputs(jc, B, n, seed):
    """tests/test_ar_kernel.py's ``_make``: a full receptive field of random
    ids and randn aux."""
    rng = np.random.RandomState(seed)
    T = jc.receptive_field
    x = rng.randint(0, 256, (B, T)).astype(np.int32)
    h = rng.randn(B, T + n, jc.n_aux).astype(np.float32)
    return x, h


def _carry_to_torch(carry):
    ring, hist, prev = (np.asarray(c.astype(jnp.float32)) for c in carry)
    return (torch.tensor(ring).to(torch.bfloat16),
            torch.tensor(hist).to(torch.int32),
            torch.tensor(prev).to(torch.int32))


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_weight_quantization_matches_jax_formula(kernel_size):
    """Bit-equal int8 weights and scales to 1e-7, after undoing the port's
    interleave of the gate's sigmoid and tanh columns (the current tap at
    kernel_size 2; every tap block, [cur | lag d | lag 2d], at 3)."""
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp = _params(jc, 3)
    wpack = jak._pack_weights(jp, jc)[0]

    # the JAX kernel's quantization, ops/ar_kernel.py:481-485, compiled as
    # the kernel runs it, inside pallas_ar_generate's jit: XLA folds the
    # division by the constant 127 into a product with fl(1/127), which
    # rounds some scales an ulp away from the division evaluated eagerly
    @jax.jit
    def quantize(wpack):
        wf = wpack.astype(jnp.float32)
        wscale = jnp.maximum(jnp.max(jnp.abs(wf), axis=1), 1e-8) / 127.0
        return jnp.clip(jnp.round(wf / wscale[:, None, :]), -127,
                        127).astype(jnp.int8), wscale

    want_q, want_s = (np.asarray(t) for t in quantize(wpack))
    q = ak.quantize_ar_weights(pp, pc)
    R = pc.n_resch
    gk = "w4" if kernel_size == 2 else "w6"
    assert q[gk].dtype == torch.int8 and q["wsr"].dtype == torch.int8

    def unpack(wz, wsr):
        """The port's gate and skip/res packs in JAX ``_pack_weights``'
        column order."""
        if kernel_size == 2:
            blocks = [ak._deinterleave(wz[..., : 2 * R]), wz[..., 2 * R:]]
        else:
            blocks = [ak._deinterleave(wz[..., 2 * R * j: 2 * R * (j + 1)])
                      for j in range(3)]
        return torch.cat(blocks + [wsr], dim=-1).numpy()

    got_q = unpack(q[gk], q["wsr"])
    got_s = unpack(q[gk + "_scale"], q["wsr_scale"])
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-7, atol=0)
    assert np.abs(got_q).max() == 127 and got_q.min() >= -127


# f32: the same op sequence in both frameworks, GEMM sums in another order
# (~1e-7 relative) through six layers: 1e-6.  bf16: the gate is rounded to
# bf16, and a gate whose f32 value the two frameworks round one ulp (2^-8)
# apart moves a layer's max by ~1e-4: 1e-3.
@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-6),
                                         ("bfloat16", 1e-3)])
@pytest.mark.parametrize("B", [4, 72])   # one block of 8 rows / ragged blocks
def test_warmup_calibration_matches_jax(B, dtype, rtol):
    """The port's warm-up maxes -> scales against JAX ``calibrate_act_scales``
    (a separate teacher-forced pass in blocks of 8 rows); the port's own
    ``calibrate_act_scales`` agrees with both."""
    jc, pc = _cfgs(compute_dtype=dtype)
    jp, pp = _params(jc, 11)
    x, h = _inputs(jc, B, 8, seed=4)
    want = np.asarray(jak.calibrate_act_scales(jp, jc, jnp.asarray(x),
                                               jnp.asarray(h)))
    # on the module's 2 intra-op threads: the warm-up no longer depends on
    # the thread count (test_warmup_streams_do_not_depend_on_the_thread_count)
    carry, maxes = P._warmup_state(pp, pc, torch.as_tensor(x),
                                   torch.as_tensor(h), collect_act_maxes=True)
    oracle = ak.calibrate_act_scales(pp, pc, torch.as_tensor(x),
                                     torch.as_tensor(h))
    ref = P._warmup_state(pp, pc, torch.as_tensor(x), torch.as_tensor(h))
    got = ak.act_scales_from_maxes(maxes)
    assert got.shape == (pc.n_layers, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    np.testing.assert_allclose(oracle.numpy(), got.numpy(), rtol=1e-6)
    # collecting the maxes leaves the carry as it was
    for a, b in zip(carry, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warmup_streams_do_not_depend_on_the_thread_count(dtype):
    """The f32 warm-up (and so the int8 calibration maxes) is bitwise the
    same on 1 to 8 intra-op threads.  ``torch.sigmoid``'s vectorised body
    and scalar tail round ~4% of inputs an ulp apart, and the threads' split
    decides which elements fall in a tail: with it, B=150 and B=451 differed
    from one thread on 7 and 8 threads."""
    jc, pc = _cfgs(compute_dtype=dtype)
    _, pp = _params(jc, 11)
    threads = torch.get_num_threads()
    try:
        for B in (150, 451):
            x, h = _inputs(jc, B, 0, seed=4)
            x, h = torch.as_tensor(x), torch.as_tensor(h)
            torch.set_num_threads(1)
            want = P._forward_collect(pp, pc, x, h)
            for n in (2, 3, 4, 7, 8):
                torch.set_num_threads(n)
                got = P._forward_collect(pp, pc, x, h)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (B, n)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("parts", [1, 2, 8])
def test_warmup_maxes_hold_under_other_summation_orders(monkeypatch, parts):
    """The f32 calibration case's tolerance, 1e-6, against the size of a
    summation-order difference: every product of the warm-up summed over
    its K in ``parts`` f32 pieces (1: float64 rounded once to f32) moves
    the scales by less than 3e-7."""
    jc, pc = _cfgs(compute_dtype="float32")
    _, pp = _params(jc, 11)
    x, h = _inputs(jc, 4, 8, seed=4)

    def scales():
        _, maxes = P._warmup_state(pp, pc, torch.as_tensor(x),
                                   torch.as_tensor(h), collect_act_maxes=True)
        return ak.act_scales_from_maxes(maxes).numpy()

    want = scales()

    def split_dot(a, w, out_dtype=None):
        if parts == 1:
            y = (a.double() @ w.double()).float()
        else:
            step = -(-w.shape[0] // parts)
            y = sum(a[..., k:k + step].float() @ w[k:k + step].float()
                    for k in range(0, w.shape[0], step))
        return y if out_dtype is None else y.to(out_dtype)

    monkeypatch.setattr(P, "_dot", split_dot)
    np.testing.assert_allclose(scales(), want, rtol=3e-7)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_matches_pallas_interpret(kernel_size):
    """The plain int8 loop against JAX's int8 Pallas kernel (interpret) on
    the same carry and scales: the integer products are exact in both, so
    the argmax samples are bit-equal (a near-tie within f32 rounding of
    the sigmoid/tanh could flip one).  kernel_size 3 runs on the int8 ring
    of ``int8_ring_fill``, as JAX fills its own.  The port's bf16 loop on
    the same inputs is not, so the comparison sees the quantization."""
    jc, pc = _cfgs(kernel_size=kernel_size)
    jp, pp = _params(jc, 12)
    B, n = 8, 16
    x, h = _inputs(jc, B, n, seed=6)
    xj, hj = jnp.asarray(x), jnp.asarray(h)
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    scales = jak.calibrate_act_scales(jp, jc, xj, hj)
    want = np.asarray(jak.pallas_ar_generate(
        jp, jc, carry, hj, T0, n, "argmax", jax.random.PRNGKey(0),
        interpret=True, quantize=True, act_scales=scales))
    st = torch.tensor(np.asarray(scales))
    ht = torch.tensor(h)
    tc = _carry_to_torch(carry)
    if kernel_size == 3:
        tc = (ak.int8_ring_fill(tc[0], st, pc),) + tc[1:]
    got = ak.ar_generate(pp, pc, tc, ht, T0, n, "argmax",
                         quantize=True, act_scales=st)
    np.testing.assert_array_equal(got.numpy(), want)
    bf16 = ak.ar_generate(pp, pc, _carry_to_torch(carry), ht, T0, n,
                          "argmax")
    assert not np.array_equal(bf16.numpy(), want)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_fleet_is_warmup_scales_then_loop(kernel_size):
    """``batch_fast_generate(quantize=True)`` on the plain route: the
    warm-up with the maxes, their scales (kernel_size 3: the ring filled
    as int8 under them), the int8 loop: nothing else."""
    jc, pc = _cfgs(kernel_size=kernel_size)
    _, pp = _params(jc, 2)
    n_list = [40, 25, 33]
    x, h = _inputs(jc, len(n_list), max(n_list), seed=3)
    got = P.batch_fast_generate(pp, pc, x, h, n_list, mode="argmax",
                                quantize=True, impl="plain")
    xt, ht = torch.as_tensor(x, dtype=torch.int64), torch.as_tensor(h)
    carry, maxes = P._warmup_state(pp, pc, xt, ht, collect_act_maxes=True)
    scales = ak.act_scales_from_maxes(maxes)
    if kernel_size == 3:
        carry = (ak.int8_ring_fill(carry[0], scales, pc),) + carry[1:]
    want = ak.ar_generate_reference(pp, pc, carry, ht, xt.shape[1],
                                    max(n_list), "argmax", quantize=True,
                                    act_scales=scales)
    for b, n in enumerate(n_list):
        np.testing.assert_array_equal(got[b], want[b, :n].numpy())
    bf16 = P.batch_fast_generate(pp, pc, x, h, n_list, mode="argmax",
                                 impl="plain")
    assert any(not np.array_equal(a, b) for a, b in zip(got, bf16))


def test_int8_tracks_jax_scan():
    """JAX's own gate for its int8 kernel (tests/test_ar_kernel.py:242-262):
    the int8 trajectory tracks the f32 scan decoder, median |d class| <= 2
    and a share within 10 classes > 0.7."""
    jc, pc = _cfgs()
    jp, pp = _params(jc, 5)
    n, B = 30, 4
    x, h = _inputs(jc, B, n, seed=2)
    xj, hj = jnp.asarray(x), jnp.asarray(h)
    T0 = xj.shape[1]
    carry = J._warmup_state(jp, jc, xj, hj)
    ref = np.asarray(J._scan_from_state(jp, jc, carry, hj, T0, n, "argmax",
                                        jax.random.PRNGKey(0)))
    out = P.batch_fast_generate(pp, pc, x, h, [n] * B, mode="argmax",
                                quantize=True, impl="plain")
    diff = np.abs(ref.astype(int) - np.stack(out).astype(int))
    assert np.median(diff) <= 2, np.median(diff)
    assert (diff <= 10).mean() > 0.7, (diff.mean(), (diff <= 10).mean())


def _bundle(tmp_path, kernel_size=2, n_resch=128, n_skipch=128):
    """A port-written bundle (checkpoint, model.conf, stats.h5) and three
    feature files, bf16 3 x 1 layers of ``n_resch`` (and ``n_skipch``)
    channels, upsampling 10."""
    from pytorchwavenetvocoder_tpu_torch.parallel import (
        create_train_state,
        save_checkpoint,
        save_model_conf,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

    cfg = P.WaveNetConfig(n_aux=8, n_resch=n_resch, n_skipch=n_skipch,
                          dilation_depth=3, dilation_repeat=1,
                          kernel_size=kernel_size, upsampling_factor=10,
                          compute_dtype="bfloat16")
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(4))
    expdir = tmp_path / "exp"
    ckpt = save_checkpoint(str(expdir), state, iterations=1)
    save_model_conf(str(expdir), dict(cfg.to_dict(), feature_type="world",
                                      use_upsampling_layer=True,
                                      use_speaker_code=False))
    rng = np.random.RandomState(1)
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", (rng.randn(8) * 0.1).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(8)).astype(np.float32))
    featdir = tmp_path / "feats"
    for i, frames in enumerate([5, 3, 4]):
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(frames, 8).astype(np.float32))
    return ["--stats", stats, "--checkpoint", ckpt, "--config", str(expdir),
            "--feats", str(featdir), "--batch_size", "2", "--mode", "argmax",
            "--device", "cpu", "--verbose", "0"]


@pytest.mark.parametrize("kernel_size", [
    pytest.param(2, id="k2"), pytest.param(3, id="k3")])
def test_decode_cli_quantize_writes_the_library_int8_wavs(tmp_path,
                                                          monkeypatch,
                                                          kernel_size):
    """``bin/decode.py --quantize --device cpu`` writes, byte for byte, the
    wavs of ``batch_fast_generate(quantize=True, impl="plain")`` on the
    batches it reads (kernel_size 3 too, the ljspeech models' size);
    without ``--quantize`` the wavs differ."""
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law
    from pytorchwavenetvocoder_tpu_torch.utils import write_wav

    common = _bundle(tmp_path, kernel_size)
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
    assert model.config.kernel_size == kernel_size
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
    monkeypatch.setattr(torch_decode, "decode_batches", real)
    out_b = tmp_path / "wav_bf16"
    torch_decode.main(common + ["--outdir", str(out_b)])
    assert any((out_b / n).read_bytes() != (out_q / n).read_bytes()
               for n in names)


# ---------------------------------------------------------------------------
# fleet auto-capping
# ---------------------------------------------------------------------------

N_LIST = [11, 7, 13, 9, 10]


def _fleet(dtype, seed=7):
    _, pc = _cfgs(compute_dtype=dtype, n_resch=16, n_skipch=16, n_aux=8)
    gen = torch.Generator().manual_seed(seed)
    pp = P.init_wavenet_params(pc, gen)
    for g in ("dil", "aux", "skip", "res"):
        pp[g]["b"] = 0.05 * torch.randn(pp[g]["b"].shape, generator=gen)
    x, h = _inputs(pc, len(N_LIST), max(N_LIST), seed)
    return pc, pp, x, h


def _cap_env(kind, pc):
    """The environment that splits the fleet of 5 into [2, 2, 1]."""
    if kind == "chunk":
        return {"WNV_DECODE_FLEET_CHUNK": "2"}
    est = P._fleet_hbm_bytes(pc, len(N_LIST), max(N_LIST))
    # ceil(est / budget) = 3 -> 5 // 3 = 1 row per sub-fleet; a budget of
    # est / 2 gives 5 // 2 = 2
    return {"WNV_DECODE_HBM_BUDGET": str(est // 2 + 1)}


def _decode(pc, pp, x, h, n_list, **kw):
    return P.batch_fast_generate(pp, pc, x, h, n_list, impl="plain", **kw)


@pytest.mark.parametrize("kind", ["chunk", "budget"])
def test_capped_fleet_f64_equals_unsplit(kind, monkeypatch):
    """float64: a capped fleet's argmax rows are bit-equal to the unsplit
    fleet's (in f32, BLAS blocking may round a row apart with B)."""
    pc, pp, x, h = _fleet("float64")
    whole = _decode(pc, pp, x, h, N_LIST, mode="argmax")
    calls = []
    real = P._warmup_state

    def spy(params, config, x_, *a, **k):
        calls.append(x_.shape[0])
        return real(params, config, x_, *a, **k)

    monkeypatch.setattr(P, "_warmup_state", spy)
    for name, value in _cap_env(kind, pc).items():
        monkeypatch.setenv(name, value)
    capped = _decode(pc, pp, x, h, N_LIST, mode="argmax")
    assert calls == [2, 2, 1]
    for a, b in zip(capped, whole):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["chunk", "budget"])
def test_capped_int8_fleet_equals_its_sub_fleets(kind, monkeypatch):
    """int8: each sub-fleet calibrates its own scales, so a capped fleet's
    rows are bit-equal to the same rows decoded as a fleet of their own;
    the scales differ from the unsplit fleet's."""
    pc, pp, x, h = _fleet("bfloat16")
    whole = _decode(pc, pp, x, h, N_LIST, mode="argmax", quantize=True)
    alone = []
    for b0 in (0, 2, 4):
        alone += _decode(pc, pp, x[b0:b0 + 2], h[b0:b0 + 2],
                         N_LIST[b0:b0 + 2], mode="argmax", quantize=True)
    for name, value in _cap_env(kind, pc).items():
        monkeypatch.setenv(name, value)
    capped = _decode(pc, pp, x, h, N_LIST, mode="argmax", quantize=True)
    for a, b in zip(capped, alone):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(capped, whole))


def test_capped_sampling_is_seeded(monkeypatch):
    """Sampling through a capped fleet: the same seed gives the same
    samples, another seed others; sub-fleets draw from their own
    generators (seeded from one draw of the caller's and the index)."""
    pc, pp, x, h = _fleet("float32")
    monkeypatch.setenv("WNV_DECODE_FLEET_CHUNK", "2")

    def run(seed):
        return _decode(pc, pp, x, h, N_LIST, mode="sampling",
                       generator=torch.Generator().manual_seed(seed))

    a, b, c = run(5), run(5), run(6)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert any(not np.array_equal(u, v) for u, v in zip(a, c))
    g = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2**62, (1,), generator=g))
    first = _decode(pc, pp, x[:2], h[:2], N_LIST[:2], mode="sampling",
                    generator=P._sub_generator(g, seed, 0))
    for u, v in zip(a[:2], first):
        np.testing.assert_array_equal(u, v)


def test_fleet_bytes_hand_count(monkeypatch):
    """The flagship fleet of 32 x 8,000 samples: ring 3,069 slots x 32 rows
    x 1,024 bf16; f32 aux over 3,071 + 8,000 positions x 28; the AR
    kernel's scratch per row (f32 stream 512, skip 256, logits 256, ids 2;
    bf16 relu(skip) and post1's output 2 x 264, the stream with its aux
    column 512 + 32 + 8, the gate 520); the int32 output."""
    cfg = P.WaveNetConfig(compute_dtype="bfloat16")
    ring = 3069 * 32 * 1024 * 2
    h_up = 32 * (3070 + 1 + 8000) * 28 * 4
    scratch = 32 * ((512 + 256 + 256 + 2) * 4 + (2 * 264 + 552 + 520) * 2)
    out = 32 * 8000 * 4
    assert P._fleet_hbm_bytes(cfg, 32, 8000) == ring + h_up + scratch + out
    monkeypatch.delenv("WNV_DECODE_HBM_BUDGET", raising=False)
    assert P._decode_hbm_budget(torch.device("cpu")) == float("inf")
    monkeypatch.setenv("WNV_DECODE_HBM_BUDGET", "1e6")
    assert P._decode_hbm_budget(torch.device("cpu")) == 1e6


def test_fleet_bytes_hand_count_int8_kernel_size_3():
    """The ljspeech flagship fleet of 16 x 11,000 samples in int8: the loop
    holds the int8 ring (6,138 slots x 16 rows x 512), the f32 aux over
    6,139 + 1 + 11,000 positions x 39, the AR kernel's scratch per row (f32
    stream 512, skip 256, logits 256, ids 3; bf16 relu(skip) and post1's
    output 2 x 264; the int8 stream and gate 2 x 528 bytes, the bf16 aux
    column 48 + 8) and the int32 output; the ring fill holds the bf16 ring,
    the int8 ring and the f32 copy of the largest layer's ring (2 x 512
    slots) beside the aux.  The fill is the peak."""
    cfg = P.WaveNetConfig(n_aux=39, kernel_size=3, upsampling_factor=110,
                          compute_dtype="bfloat16")
    slots = 2 * 3069
    h_up = 16 * (6139 + 1 + 11000) * 39 * 4
    f32 = (512 + 256 + 256 + 3) * 4 + 2 * 264 * 2
    loop = (slots * 16 * 512 + h_up + 16 * (f32 + 2 * 528 + 56 * 2)
            + 16 * 11000 * 4)
    fill = slots * 16 * 512 * 3 + 1024 * 16 * 512 * 4 + h_up
    assert fill > loop
    assert P._fleet_hbm_bytes(cfg, 16, 11000, quantize=True) == fill
    # bf16 at kernel_size 3: the bf16 ring, the bf16 stream with its aux
    # column (512 + 48 + 8) and the gate (520)
    assert P._fleet_hbm_bytes(cfg, 16, 11000) == (
        slots * 16 * 512 * 2 + h_up + 16 * (f32 + (568 + 520) * 2)
        + 16 * 11000 * 4)


def test_int8_ring_fill_matches_jax_formula():
    """``int8_ring_fill`` on a JAX warm-up's raw ring is bit-equal to the
    JAX kernel's fill, ``clip(round(ring / s), -127, 127)`` with each
    layer's scale (`ops/ar_kernel.py:437-445`)."""
    jc, pc = _cfgs(kernel_size=3)
    jp, _ = _params(jc, 8)
    x, h = _inputs(jc, 4, 4, seed=8)
    xj, hj = jnp.asarray(x), jnp.asarray(h)
    ring = J._warmup_state(jp, jc, xj, hj)[0]
    scales = jak.calibrate_act_scales(jp, jc, xj, hj)
    caps = [2 * d for d in jc.dilations]
    lidx = jnp.asarray(np.repeat(np.arange(jc.n_layers), caps))
    s = scales.astype(jnp.float32)[lidx, 0][:, None, None]
    want = np.asarray(jnp.clip(jnp.round(ring.astype(jnp.float32) / s),
                               -127, 127).astype(jnp.int8))
    ring_t = torch.tensor(np.asarray(ring.astype(jnp.float32))).to(torch.bfloat16)
    got = ak.int8_ring_fill(ring_t, torch.tensor(np.asarray(scales)), pc)
    assert got.dtype == torch.int8 and got.shape == ring_t.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 64     # the scales' range is used


def test_int8_kernel_size_3_refuses_a_bf16_ring():
    """The int8 loop at kernel_size 3 runs on the int8 ring only: a bf16
    ring (the warm-up's, not yet filled) raises instead of being read as
    int8 rows."""
    jc, pc = _cfgs(kernel_size=3)
    _, pp = _params(jc, 2)
    x, h = _inputs(jc, 2, 3, seed=2)
    carry, maxes = P._warmup_state(pp, pc, torch.as_tensor(x),
                                   torch.as_tensor(h), collect_act_maxes=True)
    with pytest.raises(ValueError, match="int8_ring_fill"):
        ak.ar_generate(pp, pc, carry, torch.as_tensor(h), x.shape[1], 3,
                       "argmax", quantize=True,
                       act_scales=ak.act_scales_from_maxes(maxes))


# ---------------------------------------------------------------------------
# channel widths off the kernels' tiling: zero-padded on the cuda route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_size", [2, 3])
@pytest.mark.parametrize("dtype, quantize", [("float64", False),
                                             ("bfloat16", True)])
def test_padded_params_decode_as_the_unpadded(dtype, quantize, kernel_size):
    # the sd-mini recipe's widths (egs/arctic/sd-mini/run.sh: 32 / 16),
    # padded as the cuda route pads them (n_resch to the warm-up's 128,
    # n_skipch to the AR kernel's 16; and to 128),
    # decode argmax-equal through the plain loop: exact zeros in float64,
    # and in int8 integer products that gain only zero terms and scales
    # and activation maxes that stay as they were
    pc = P.WaveNetConfig(n_quantize=256, n_aux=28, n_resch=32, n_skipch=16,
                         dilation_depth=5, dilation_repeat=1,
                         kernel_size=kernel_size, upsampling_factor=0,
                         compute_dtype=dtype)
    gen = torch.Generator().manual_seed(17)
    pp = P.init_wavenet_params(pc, gen)
    for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
        b = pp[group]["b"]
        pp[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    rng = np.random.RandomState(kernel_size)
    B, n = 4, 40
    x = rng.randint(0, 256, (B, pc.receptive_field))
    h = rng.randn(B, pc.receptive_field + n, pc.n_aux).astype(np.float32)
    want = P.batch_fast_generate(pp, pc, x, h, [n] * B, mode="argmax",
                                 impl="plain", quantize=quantize)
    for multiple in ((128, 16), (128, 128)):
        qp, qc = P.pad_params_for_kernels(pp, pc, multiple)
        assert (qc.n_resch, qc.n_skipch) == multiple
        assert qc.receptive_field == pc.receptive_field
        got = P.batch_fast_generate(qp, qc, x, h, [n] * B, mode="argmax",
                                    impl="plain", quantize=quantize)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # widths on the multiples are left as they are
    same = P.pad_params_for_kernels(qp, qc, (16, 16))
    assert same[0] is qp and same[1] is qc


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_route_per_fleet_size(kernel_size, monkeypatch):
    # the int8 kernel's gate design, decided from the int8 plan and the
    # fleet against AR_STREAM_FROM_B, before any work
    pc = P.WaveNetConfig(n_quantize=256, n_aux=28, n_resch=512, n_skipch=256,
                         dilation_depth=10, dilation_repeat=3,
                         kernel_size=kernel_size, upsampling_factor=0,
                         compute_dtype="bfloat16")
    start = ak.AR_STREAM_FROM_B[(kernel_size, True)]
    for B in (1, 16, 32, 256, 512, 2048):
        want = "stream" if B >= start else "units"
        assert ak.ar_gate(pc, B, quantize=True) == want
    monkeypatch.setitem(ak.AR_STREAM_FROM_B, (kernel_size, True), 64)
    assert ak.ar_gate(pc, 63, quantize=True) == "units"
    assert ak.ar_gate(pc, 64, quantize=True) == "stream"
    # the bf16 gate keeps its own threshold
    assert ak.ar_gate(pc, 64) == ak.ar_gate(pc, 64, quantize=False)
    # the int8 envelope states the kernel's tiling
    narrow = P.WaveNetConfig(n_resch=48, n_skipch=48, compute_dtype="bfloat16",
                             kernel_size=kernel_size)
    assert ak.ar_kernel_constraint_error(narrow) is None
    assert "32" in ak.ar_kernel_constraint_error(narrow, True)
    assert "16-deep k tiles" in ak.ar_kernel_constraint_error(
        P.WaveNetConfig(n_resch=40, n_skipch=48, compute_dtype="bfloat16",
                        kernel_size=kernel_size), True)