"""The mixture-of-logistics WaveNet vocoder on the port's normal path,
held on the CPU to the benchmark's plain reference
(``port_bench/reference/wavenet_mol.py``, float32 plain torch written from
r9y9/wavenet_vocoder's preset, nothing of the port) at a small size with
seeded random weights: the forward's head outputs, the upsampler, the
loss and its gradients, the plain AR loop teacher-forced, the sampler,
a training step with its dropout masks, the decode CLI's wavs, and the
refusals; and K1's stage plan and packs for the MoL model, emulated unit by
unit against the plain loop.

Tolerances: float32 against float32 differ by the order of the sums (the
port adds the conv taps, aux term and biases in another order), a few
ulps of the largest value a product feeds, so 1e-5 relative to the
largest head output; a reference whose products are rounded to bf16 lands
~1e-3 away and fails that (``test_bf16_products_fail_the_float32_limit``).
float64 agrees to 1e-12.  The loss's bin mass is the difference of two
sigmoids 2 / 65535 apart, each near 1/2, so float32 inputs a few ulps apart
give masses ~1e-3 apart (the float32 gradients measured 1.9e-3 apart, the
loss 9e-6): in float32 the gradients are held to 1e-2 and the loss to
5e-5, in float64 both to 1e-10.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from port_bench.reference import wavenet_mol as ref
from pytorchwavenetvocoder_tpu_torch.models import mol as M
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
from pytorchwavenetvocoder_tpu_torch.parallel import train as PT

torch.set_num_threads(2)

F32_TOL = 1e-5
F64_TOL = 1e-12


def _cfg(**kw):
    base = dict(output="mol", n_quantize=65536, n_mix=3, n_aux=5, n_resch=32,
                n_gatech=16, n_skipch=24, dilation_depth=3, dilation_repeat=2,
                kernel_size=3, upsampling_factor=16, upsampling_scales=(4, 4),
                compute_dtype="float32")
    base.update(kw)
    return P.WaveNetConfig(**base)


def _params(cfg, seed=0, dtype=torch.float32):
    """Seeded random weights with every bias non-zero and the head's
    log-scales near -2, so that the mixtures and logistics both move."""
    gen = torch.Generator().manual_seed(seed)
    params = P.init_wavenet_params(cfg, gen)
    out = {}
    for g, d in params.items():
        out[g] = {}
        for n, t in d.items():
            t = t + 0.1 * torch.randn(t.shape, generator=gen)
            out[g][n] = t.to(dtype)
    out["post2"]["b"][2 * cfg.n_mix:] -= 2.0
    return out


def _ref_cfg(cfg):
    return dict(dataclasses.asdict(cfg), n_gatech=cfg.gate_ch)


def _inputs(cfg, B=2, frames=6, seed=1, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    T = frames * cfg.upsampling_factor
    x = (0.3 * torch.randn((B, T), generator=gen)).clamp(-1, 1).to(dtype)
    h = torch.randn((B, frames, cfg.n_aux), generator=gen).to(dtype)
    return x, h


def _close(a, b, tol):
    scale = b.abs().max().item()
    return (a - b).abs().max().item() <= tol * max(scale, 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_forward_head_outputs_match_the_reference(dtype):
    cfg = _cfg(compute_dtype=dtype)
    dt = cfg.dtype
    params = _params(cfg, dtype=dt)
    x, h = _inputs(cfg, dtype=dt)
    got = P.wavenet_forward(params, cfg, x, h)
    aux = ref.upsample(params, h, _ref_cfg(cfg))
    want = ref.forward(params, _ref_cfg(cfg), x, aux)
    assert got.shape == (2, x.shape[1], 3 * cfg.n_mix)
    assert _close(got, want, F32_TOL if dtype == "float32" else F64_TOL)


def test_bf16_products_fail_the_float32_limit():
    """The float32 limit is tight enough that a reference whose products
    take bf16 operands fails it."""
    cfg = _cfg()
    params = _params(cfg)
    x, h = _inputs(cfg)
    got = P.wavenet_forward(params, cfg, x, h)

    def mm_bf16(a, b):
        return torch.matmul(a.to(torch.bfloat16).float(),
                            b.to(torch.bfloat16).float())

    aux = ref.upsample(params, h, _ref_cfg(cfg))
    rounded = ref.forward(params, _ref_cfg(cfg), x, aux, mm=mm_bf16)
    assert not _close(got, rounded, F32_TOL)


@pytest.mark.parametrize("scales", [(4, 4), (2, 8), (16,)])
def test_upsampler_is_conv_transpose2d_and_relu(scales):
    cfg = _cfg(upsampling_scales=scales)
    params = _params(cfg)
    _x, h = _inputs(cfg)
    got = P.upsample_aux(params, cfg, h)
    want = ref.upsample(params, h, _ref_cfg(cfg))
    assert got.shape == (2, h.shape[1] * 16, cfg.n_aux)
    assert _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype, loss_tol, grad_tol",
                         [("float32", 5e-5, 1e-2), ("float64", 1e-10, 1e-10)])
def test_loss_and_every_gradient_match_the_reference(dtype, loss_tol,
                                                     grad_tol):
    cfg = _cfg(compute_dtype=dtype)
    params = _params(cfg, dtype=cfg.dtype)
    x, h = _inputs(cfg, dtype=cfg.dtype)
    t = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    t[0, 5], t[1, 7] = 1.0, -1.0          # the edge bins
    rf = cfg.receptive_field
    p1 = {g: {n: v.clone().requires_grad_(True) for n, v in d.items()}
          for g, d in params.items()}
    loss = PT.masked_mol_loss(P.wavenet_forward(p1, cfg, x, h), t, cfg, rf)
    loss.backward()
    want, grads = ref.loss_and_grads(params, _ref_cfg(cfg), (x, h, t))
    assert abs(loss.item() - want.item()) <= loss_tol * abs(want.item())
    for g, n in ref.leaves(params):
        assert _close(p1[g][n].grad, grads[(g, n)], grad_tol), (g, n)


def test_loss_switches_as_pixelcnn_does():
    """PixelCNN++'s three cases: a bin's mass, the density at its centre
    where the mass is under 1e-5, and the tails at the edges."""
    y = torch.tensor([[0.0, 0.5, -2.0, 0.0, 0.0, -30.0]])    # M = 2
    for x in (0.25, 1.0, -1.0):
        t = torch.tensor([x])
        got = M.mol_loss(y, t, 2, 65536, M.LOG_SCALE_MIN)
        want = ref.nll(y, t, dict(n_mix=2, n_quantize=65536,
                                  log_scale_min=M.LOG_SCALE_MIN)).mean()
        assert torch.isfinite(got) and abs(got - want) <= 1e-6 * abs(want)


def test_plain_ar_loop_teacher_forced_gives_the_reference_head():
    """The plain AR loop's step (``ar_step_logits``), fed the samples of
    a sequence after the warm-up, gives the reference's full forward's head
    outputs at every step."""
    cfg = _cfg()
    params = _params(cfg, seed=3)
    rf = cfg.receptive_field
    n = 12
    x, h = _inputs(cfg, B=2, frames=4, seed=3)
    seq = x[:, :rf + n]
    h_up = P.upsample_aux(params, cfg, h)[:, :rf + n]
    carry = P._warmup_state(params, cfg, seq[:, :rf], h_up)
    weights = ak._step_weights(params, cfg)
    got = []
    for i in range(n):
        ids = seq[:, rf - 1 + i:rf + i]
        got.append(ak.ar_step_logits(weights, cfg, carry[0], ids, h_up,
                                     rf - 1 + i))
    got = torch.stack(got, dim=1)
    want = ref.forward(params, _ref_cfg(cfg), seq, h_up)[:, rf - 1:rf - 1 + n]
    assert _close(got, want, F32_TOL)


def test_sampler_component_and_value_under_given_noise():
    gen = torch.Generator().manual_seed(5)
    Mx, n = 4, 200
    y = torch.randn((n, 3 * Mx), generator=gen, dtype=torch.float64)
    y[:, 2 * Mx:] -= 2.0
    u = torch.rand((n, Mx), generator=gen, dtype=torch.float64)
    v = torch.rand((n,), generator=gen, dtype=torch.float64)
    cfg = dict(n_mix=Mx, log_scale_min=M.LOG_SCALE_MIN)
    logits, means, ls = M.mol_split(y, Mx, M.LOG_SCALE_MIN)
    c = M.mol_choose(logits, u)
    got = M.mol_value(means, ls, c, v)
    score, value = ref.candidates(y, cfg, u, v)
    assert torch.equal(c, score.argmax(dim=-1))
    assert torch.allclose(got, value.gather(1, c[:, None])[:, 0], rtol=0,
                          atol=1e-15)
    # greedy: the likeliest component's mean, clamped
    g = M.mol_value(means, ls, M.mol_choose(logits, None), None)
    s0, v0 = ref.candidates(y, cfg, None, None)
    assert torch.equal(g, v0.gather(1, s0.argmax(-1)[:, None])[:, 0])
    # the one draw a step: M uniforms for the component, then the
    # logistic's, from the generator
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    s = M.mol_sample(y[:3], Mx, M.LOG_SCALE_MIN, "sampling", g1)
    uu = torch.rand((3, Mx + 1), generator=g2, dtype=torch.float64)
    want = M.mol_value(means[:3], ls[:3], M.mol_choose(logits[:3],
                                                       uu[:, :Mx]),
                       uu[:, Mx])
    assert torch.equal(s, want.float())


def test_naive_and_fast_generation_agree():
    """The parity invariant for the MoL model: the naive full forward a
    sample and the ring-buffer loop give the same samples in float64,
    greedy and sampled."""
    cfg = _cfg(compute_dtype="float64")
    params = _params(cfg, seed=4, dtype=torch.float64)
    net = P.WaveNet(cfg, params=params)
    h = np.random.RandomState(4).randn(1, 3, cfg.n_aux)
    x = np.zeros((1, 1), np.float32)
    for mode in ("argmax", "sampling"):
        fast = net.batch_fast_generate(x, h, [30], mode=mode,
                                       generator=torch.Generator()
                                       .manual_seed(2))[0]
        naive = net.generate(x, h, 30, mode=mode,
                             generator=torch.Generator().manual_seed(2))
        assert fast.dtype == np.float32 and np.array_equal(fast, naive)


def test_one_training_step_with_its_dropout_masks():
    """The port's training step (plain route, dropout at p = 0.05 from
    ``dropout_masks``) against the reference's Adam step with the same
    masks: the loss, every gradient and every weight after the step."""
    cfg = _cfg(dropout=0.05)
    params = _params(cfg, seed=6)
    x, h = _inputs(cfg, B=1, frames=6, seed=6)
    t = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    state = PT.create_train_state(
        cfg, lr=1e-3, params={g: {n: v.clone() for n, v in d.items()}
                              for g, d in params.items()})
    step = PT.make_train_step(cfg, lr=1e-3, fused=False, dropout_seed=42)
    grads = {}

    def keep(g, n):
        return lambda grad: grads.__setitem__((g, n), grad.clone())

    hooks = [state.params[g][n].register_hook(keep(g, n))
             for g, n in ref.leaves(state.params)]
    state, loss = step(state, x.numpy(), h.numpy(), t.numpy())
    for hk in hooks:
        hk.remove()
    masks = PT.dropout_masks(cfg, (1, x.shape[1], cfg.n_resch), 42, 0, 0,
                             "cpu")
    assert sum(float((m == 0).float().mean()) for m in masks) > 0
    r = ref.train_steps(params, _ref_cfg(cfg), [[(x, h, t)]], 1e-3,
                        masks=[[masks]])
    assert abs(loss.item() - r["losses"][0]) <= 5e-5 * abs(r["losses"][0])
    for g, n in ref.leaves(params):
        # float32: the loss's gradients to 1e-2 (the module's note); Adam's
        # first step moves each weight by lr sign(grad) (|grad| >> eps), so
        # a weight whose tiny gradient's sign the two round apart lands 2 lr
        # away: at most 2 lr, and on at most 1% of a leaf's weights more
        # than a float32 rounding apart
        assert _close(grads[(g, n)], r["grad1"][(g, n)], 1e-2), (g, n)
        d = (state.params[g][n].detach() - r["params"][g][n]).abs()
        assert d.max() <= 2.01e-3, (g, n)
        assert (d > 1e-6 * r["params"][g][n].abs().max()).float().mean() \
            <= 0.01, (g, n)


def test_decode_cli_writes_a_mol_fleets_wavs(tmp_path):
    """``bin/decode.py::decode_batches`` writes each utterance's samples
    as 16-bit PCM, no mu-law decode, in both modes."""
    from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
    from pytorchwavenetvocoder_tpu_torch.utils import read_wav

    cfg = _cfg()
    net = P.WaveNet(cfg, params=_params(cfg, seed=8))
    rng = np.random.RandomState(8)
    h = rng.randn(3, 4, cfg.n_aux).astype(np.float32)
    x = np.zeros((3, 1), np.float32)
    for mode in ("argmax", "sampling"):
        out = tmp_path / mode
        want = net.batch_fast_generate(x, h, [40, 63, 25], mode=mode,
                                       generator=torch.Generator()
                                       .manual_seed(3))
        res = decode_batches(net, [(["a", "b", "c"], (x, h, [40, 63, 25]))],
                             str(out), mode=mode,
                             generator=torch.Generator().manual_seed(3),
                             fs=22050)
        assert res["n_samples"] == 128
        for name, w in zip("abc", want):
            got, fs = read_wav(str(out / f"{name}.wav"))
            assert fs == 22050 and len(got) == len(w)
            assert np.array_equal(got, np.clip(np.rint(w * 32768.0), -32768,
                                               32767) / 32768.0)


def test_fused_training_and_int8_are_refused_for_mol():
    cfg = _cfg(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="mu-law"):
        PT.make_train_step(cfg, fused=True)
    from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
        supports_fused_train,
    )

    assert not supports_fused_train(cfg, 4000)
    net = P.WaveNet(cfg, params=_params(cfg))
    with pytest.raises(NotImplementedError, match="mu-law"):
        net.batch_fast_generate(np.zeros((1, 1), np.float32),
                                np.zeros((1, 2, cfg.n_aux), np.float32),
                                [5], quantize=True, impl="plain")


def test_train_cli_refuses_fused_true_for_mol():
    from pytorchwavenetvocoder_tpu_torch.bin import train

    with pytest.raises(ValueError, match="mu-law model"):
        train.main(["--waveforms", "w", "--feats", "f", "--stats", "s",
                    "--expdir", "e", "--output", "mol", "--fused", "true",
                    "--device", "cpu"])


def test_mu_law_config_dict_is_unchanged():
    """The MoL fields stay out of a mu-law model's dict (the JAX package
    reads the same model.conf), and a MoL dict round-trips."""
    mu = P.WaveNetConfig(n_aux=39, kernel_size=3)
    assert set(mu.to_dict()) == {"n_quantize", "n_aux", "n_resch",
                                 "n_skipch", "dilation_depth",
                                 "dilation_repeat", "kernel_size",
                                 "upsampling_factor", "compute_dtype"}
    cfg = _cfg(dropout=0.05)
    assert P.WaveNetConfig.from_dict(cfg.to_dict()) == cfg


def test_scales_follow_the_head():
    """The output and skip scales are the head's: sqrt(0.5) each in the MoL
    model (r9y9's legacy form), 1 in the mu-law model; neither is a field,
    so neither reaches a model.conf."""
    mu, mol = P.WaveNetConfig(), _cfg()
    assert mu.residual_scale == mu.skip_scale == 1.0
    assert mol.residual_scale == mol.skip_scale == math.sqrt(0.5)
    assert "residual_scale" not in mol.to_dict()
    assert "skip_scale" not in mol.to_dict()


def _mu_cfg(**kw):
    base = dict(n_quantize=16, n_aux=3, n_resch=128, n_skipch=128,
                dilation_depth=2, dilation_repeat=1, kernel_size=2,
                compute_dtype="bfloat16")
    base.update(kw)
    return P.WaveNetConfig(**base)


def test_dropout_keeps_a_mu_law_model_off_the_fused_route():
    """The fused training kernels take no dropout masks: a mu-law model
    with dropout is outside them (``--fused auto`` takes the plain route,
    ``fused=True`` raises with the reason), and without dropout it is
    inside them."""
    from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
        fused_train_constraint_error,
        supports_fused_train,
    )

    assert supports_fused_train(_mu_cfg(), 4000)
    cfg = _mu_cfg(dropout=0.05)
    assert "dropout" in fused_train_constraint_error(cfg, 4000)
    with pytest.raises(ValueError, match="dropout"):
        PT.make_train_step(cfg, fused=True)
    params = P.init_wavenet_params(cfg)
    x = torch.zeros((1, 8), dtype=torch.long)
    h = torch.zeros((1, 8, cfg.n_aux))
    masks = PT.dropout_masks(cfg, (1, 8, cfg.n_resch), 0, 0, 0, "cpu")
    with pytest.raises(ValueError, match="dropout"):
        P.wavenet_forward(params, cfg, x, h, fused=True, dropout_masks=masks)


def test_mu_law_dropout_steps_on_the_plain_route_with_its_masks():
    """``fused=None`` (auto) trains a mu-law model with dropout on the plain
    route, and its loss is the one of ``wavenet_forward`` under the masks
    that ``dropout_masks`` draws for the step, not that without them."""
    cfg = _mu_cfg(compute_dtype="float32", dropout=0.3)
    params = P.init_wavenet_params(cfg, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, cfg.n_quantize, (1, 12), generator=gen)
    t = torch.randint(0, cfg.n_quantize, (1, 12), generator=gen)
    h = torch.randn((1, 12, cfg.n_aux), generator=gen)
    masks = PT.dropout_masks(cfg, (1, 12, cfg.n_resch), 9, 0, 0, "cpu")
    rf = cfg.receptive_field
    with torch.no_grad():
        want = PT.masked_ce_loss(P.wavenet_forward(
            params, cfg, x, h, dropout_masks=masks), t, rf)
        bare = PT.masked_ce_loss(P.wavenet_forward(params, cfg, x, h), t, rf)
    step = PT.make_train_step(cfg, lr=1e-3, dropout_seed=9)
    state = PT.create_train_state(
        cfg, lr=1e-3, params={g: {n: v.clone() for n, v in d.items()}
                              for g, d in params.items()})
    _, loss = step(state, x, h, t)
    assert step.route == "plain"
    # the same float32 forward under the same masks: equal to round-off
    assert abs(float(loss) - float(want)) < 1e-5
    assert abs(float(want) - float(bare)) > 1e-3


def test_train_cli_refuses_fused_true_for_dropout():
    from pytorchwavenetvocoder_tpu_torch.bin import train

    with pytest.raises(ValueError, match="dropout"):
        train.main(["--waveforms", "w", "--feats", "f", "--stats", "s",
                    "--expdir", "e", "--dropout", "0.05", "--fused", "true",
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# K1's MoL plan and packs, emulated unit by unit
# ---------------------------------------------------------------------------


def _emulate_mol(params, cfg, carry, h_up, T0, max_n, plan):
    """The MoL instances of csrc/ar_persistent.cu in greedy steps, stage
    by stage and unit by unit: each unit's A rows and packed weights
    (``pack_ar_units``) through one f32 product, then its epilogue's index
    math (the gate at G, the res stage's sqrt(0.5) scales, post2 at the
    head's padded columns), the MoL sample and the 1x1 embed.  Returns
    (B, max_n) float32."""
    from tests.test_torch_ar_plan import _stream_unit_w, _unit_run

    ring, _hist, prev = carry
    R, S, A, L, G = (cfg.n_resch, cfg.n_skipch, cfg.n_aux, cfg.n_layers,
                     cfg.gate_ch)
    Mx, Q = cfg.n_mix, ak.head_columns(cfg)
    B, Ap, bf = prev.shape[0], -(-A // 16) * 16, torch.bfloat16
    pk = ak.pack_ar_weights(params, cfg)
    units = ak.pack_ar_units(pk, plan, cfg)
    _caps, offs, _ = P._buffer_layout(cfg)
    xs = torch.zeros((B, R + Ap), dtype=bf)
    of = torch.zeros((B, R))
    skip = torch.zeros((B, S))
    gs, sr, h1 = (torch.zeros((B, n), dtype=bf) for n in (G, S, S))
    logits = torch.zeros((B, Q))
    y = prev.clone()
    out = torch.zeros((B, max_n))

    def embed(p):
        v = y[:, None] * pk["causal_w"][0, 0].float() + pk["causal_b"][None]
        of.copy_(v)
        xs[:, :R] = v.to(bf)
        xs[:, R:R + A] = h_up[:, p].to(bf)

    def stage(name, l, p, epi):
        s = plan["stages"][name]
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                grp = cols[0][0] // s["cw"]
                if name == "gate":
                    d = cfg.dilations[l]
                    a = torch.cat([xs[r0:r1]] + [
                        ring[offs[l] + (p - j * d) % (2 * d), r0:r1]
                        for j in (1, 2)], dim=1)
                else:
                    a = {"res": gs, "post1": sr, "post2": h1}[name][r0:r1]
                if s.get("stream"):
                    w = torch.cat(_stream_unit_w(units, plan, cfg, l, grp))
                    hc = s["cw"] // 2
                    ch = grp * hc + torch.arange(hc)
                    bias = torch.cat([pk["zb"][l, ch], pk["zb"][l, G + ch]])
                else:
                    t, bias = _unit_run(units, plan, name, l, grp)
                    w = t.permute(0, 2, 1, 3).reshape(t.shape[0] * 16, -1)
                epi(a.float() @ w.float(), bias, grp, r0, r1, s["cw"])

    for i in range(max_n):
        p = T0 - 1 + i
        embed(p)
        for l in range(L):
            d = cfg.dilations[l]

            def gate_epi(z, bias, grp, r0, r1, cw):
                hc = cw // 2
                ci = torch.arange(hc)
                c = grp * hc + ci
                cs = (ci >> 3) * 16 + (ci & 7)
                gs[r0:r1, c] = (torch.sigmoid(z[:, cs] + bias[ci])
                                * torch.tanh(z[:, cs + 8] + bias[hc + ci])
                                ).to(bf)

            def res_epi(z, bias, grp, r0, r1, cw):
                col = grp * cw + torch.arange(cw)
                v = z + bias
                sk, rs = col < S, col >= S
                if sk.any():
                    c_ = col[sk]
                    nv = (v[:, sk] if l == 0 else
                          (v[:, sk] + skip[r0:r1, c_]) * cfg.skip_scale)
                    skip[r0:r1, c_] = nv
                    if l == L - 1:
                        sr[r0:r1, c_] = torch.relu(nv).to(bf)
                if rs.any():
                    j = col[rs] - S
                    old = of[r0:r1, j].clone()
                    of[r0:r1, j] = (v[:, rs] + old) * cfg.residual_scale
                    xs[r0:r1, j] = of[r0:r1, j].to(bf)
                    ring[offs[l] + p % (2 * d), r0:r1, j] = old.to(bf)

            stage("gate", l, p, gate_epi)
            stage("res", l, p, res_epi)

        def post1_epi(z, bias, grp, r0, r1, cw):
            col = grp * cw + torch.arange(cw)
            h1[r0:r1, col] = torch.relu(z + bias).to(bf)

        def post2_epi(z, bias, grp, r0, r1, cw):
            col = grp * cw + torch.arange(cw)
            logits[r0:r1, col] = z + bias

        stage("post1", 0, p, post1_epi)
        stage("post2", 0, p, post2_epi)
        assert not logits[:, 3 * Mx:].any()       # the head's zero padding
        y = M.mol_sample(logits[:, :3 * Mx], Mx, cfg.log_scale_min, "argmax")
        out[:, i] = y
    prev.copy_(y)
    return out


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [5, 37])
def test_mol_emulated_stages_decode_as_the_plain_loop(B, gate):
    """K1's MoL plan and packs at G = R / 2 on a small grid (blocks take
    several units): greedy steps from the plain loop's state, samples
    within 1e-2 on 97% of the row-steps (bf16 operands), over one call."""
    cfg = _cfg(compute_dtype="bfloat16", n_resch=64, n_gatech=32,
               n_skipch=32, n_aux=20, n_mix=4, upsampling_factor=0,
               upsampling_scales=())
    params = _params(cfg, seed=11)
    plan = ak.ar_plan(cfg, B, grid=7, gate=gate)
    assert plan["stages"]["gate"]["N"] == 2 * cfg.gate_ch
    assert plan["stages"]["res"]["K"] == cfg.gate_ch
    assert plan["stages"]["post2"]["N"] == 16
    rng = np.random.RandomState(B)
    n = 6
    x = torch.as_tensor(0.3 * rng.randn(B, cfg.receptive_field),
                        dtype=torch.float32)
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32)
    carry = P._warmup_state(params, cfg, x, h)
    T0 = x.shape[1]
    agree = []
    cp = tuple(t.clone() for t in carry)
    for i in range(n):
        ce = tuple(t.clone() for t in cp)
        se = _emulate_mol(params, cfg, ce, h, T0 + i, 1, plan)
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i)
        agree.append(((se - sp).abs() <= 1e-2).float().mean().item())
    assert np.mean(agree) >= 0.97
    ce = tuple(t.clone() for t in carry)
    se = _emulate_mol(params, cfg, ce, h, T0, n, plan)
    assert torch.equal(ce[2], se[:, -1])


def test_mol_kernel_constraints():
    cfg = _cfg(compute_dtype="bfloat16", n_skipch=32)
    assert ak.ar_kernel_constraint_error(cfg) is None
    assert "kernel_size 3" in ak.ar_kernel_constraint_error(
        dataclasses.replace(cfg, kernel_size=2))
    assert "mu-law" in ak.int8_constraint_error(cfg)
    assert ak.head_columns(cfg) == 16
    shapes = ak.ar_stage_shapes(cfg)
    assert shapes["gate"][2] == 2 * cfg.gate_ch
    assert shapes["res"][0] == cfg.gate_ch


def _mol_corpus(tmp_path, n_aux=4, uf=16, lengths=(3000, 4200, 3600)):
    """Sine-plus-noise wavs at 22,050 Hz, random mel-like features at one
    frame per ``uf`` samples, and their stats."""
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5, write_wav

    rng = np.random.RandomState(0)
    wavdir, featdir = tmp_path / "wav", tmp_path / "hdf5"
    wavdir.mkdir()
    for i, n in enumerate(lengths):
        t = np.arange(n)
        wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t / 22050) \
            + 0.01 * rng.randn(n)
        write_wav(str(wavdir / f"u{i}.wav"), wav.astype(np.float32), 22050)
        write_hdf5(str(featdir / f"u{i}.h5"), "/melspc",
                   rng.randn(n // uf, n_aux).astype(np.float32))
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/melspc/mean", np.zeros(n_aux, np.float32))
    write_hdf5(stats, "/melspc/scale", np.ones(n_aux, np.float32))
    return str(wavdir), str(featdir), stats


def test_train_and_decode_clis_take_the_mol_model(tmp_path):
    """``bin/train.py --output mol`` trains a tiny MoL model on the plain
    route (dropout on) into a bundle that ``bin/decode.py`` decodes into
    wavs of the features' lengths, in both modes."""
    import os

    from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
    from pytorchwavenetvocoder_tpu_torch.bin import train as torch_train
    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        load_model_conf,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import read_hdf5, read_wav

    wavdir, featdir, stats = _mol_corpus(tmp_path)
    expdir = tmp_path / "exp"
    res = torch_train.main([
        "--waveforms", wavdir, "--feats", featdir, "--stats", stats,
        "--expdir", str(expdir), "--feature_type", "melspc", "--output",
        "mol", "--n_mix", "3", "--n_quantize", "65536", "--n_aux", "4",
        "--n_resch", "16", "--n_gatech", "8", "--n_skipch", "16",
        "--dilation_depth", "3", "--dilation_repeat", "1", "--kernel_size",
        "3", "--upsampling_factor", "16", "--upsampling_scales", "4,4",
        "--dropout", "0.05", "--batch_length", "320", "--batch_size", "2",
        "--lr", "1e-3", "--iters", "4", "--intervals", "2",
        "--checkpoint_interval", "4", "--device", "cpu", "--verbose", "0"])
    assert res["route"] == "plain" and res["state"].step == 4
    assert all(np.isfinite(l) for _, l, _ in res["intervals"])
    conf = load_model_conf(str(expdir))
    assert conf["output"] == "mol" and conf["upsampling_scales"] == [4, 4]
    loaded = P.WaveNetConfig.from_dict(conf)
    assert loaded.residual_scale == loaded.skip_scale == math.sqrt(0.5)
    for mode in ("argmax", "sampling"):
        out = str(tmp_path / mode)
        dec = torch_decode.main([
            "--feats", featdir, "--stats", stats,
            "--checkpoint", str(expdir / "checkpoint-final.pkl"),
            "--config", str(expdir), "--outdir", out, "--batch_size", "3",
            "--fs", "22050", "--mode", mode, "--device", "cpu",
            "--verbose", "0"])
        assert dec["n_utts"] == 3
        for f in sorted(os.listdir(featdir)):
            wav, fs = read_wav(os.path.join(out, f.replace(".h5", ".wav")))
            frames = read_hdf5(os.path.join(featdir, f), "/melspc").shape[0]
            assert fs == 22050 and wav.shape == (frames * 16 - 1,)
            assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
