"""The persistent AR kernel's plan and weight layout (``ops/ar_kernel.py``:
``ar_plan``, ``ar_stage_units``, ``pack_ar_units``), on the CPU: every
output of every stage is computed by exactly one unit, the per-unit packs
hold exactly ``pack_ar_weights``' values, and a step-by-step emulation of
the kernel's stages (its A rows, its packed weights, its epilogues' index
math) decodes as the plain loop does."""

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak

torch.set_num_threads(2)

#: the flagship widths (arctic k=2, ljspeech k=3) and the narrow [K1 chi2]
#: config of chip_smoke.py
WIDTHS = {"flagship": dict(n_resch=512, n_skipch=256),
          "narrow": dict(n_resch=128, n_skipch=128)}


def _cfg(kernel_size, width, **kw):
    base = dict(n_quantize=256, n_aux=28 if kernel_size == 2 else 39,
                dilation_depth=10, dilation_repeat=3, kernel_size=kernel_size,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(WIDTHS[width])
    base.update(kw)
    return P.WaveNetConfig(**base)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [1, 15, 16, 17, 65, 200, 256, 1000, 16384])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_plan_covers_every_output_once(kernel_size, B, width):
    cfg = _cfg(kernel_size, width)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS)
    assert plan["smem"] <= ak.AR_SMEM_MAX
    w = plan["smem_w"][1]
    assert plan["smem_a"] == 2 * w
    for name, (K, quarters, N) in ak.ar_stage_shapes(cfg).items():
        s = plan["stages"][name]
        assert (s["K"], s["quarters"], s["N"]) == (K, quarters, N)
        # each region holds the stage's largest unit
        assert (K * quarters + 2) * s["cw"] * 2 <= w
        a_row = K + ak.AR_A_PAD * (2 if name == "gate" and kernel_size == 3
                                   else 1)
        assert s["a_row"] == a_row
        assert 16 * s["mt"] * a_row * 2 <= plan["smem_p"] - plan["smem_a"]
        assert s["ks"] * 16 * s["mt"] * quarters * s["cw"] * 4 \
            <= plan["smem_e"] - plan["smem_p"]
        assert 16 * s["mt"] * s["cw"] * 4 <= plan["smem"] - plan["smem_e"]
        assert 1 <= s["ks"] <= K // 16 and 1 <= s["mt"] <= 4
        seen = np.zeros((B, quarters * N), np.uint8)
        units = 0
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                assert r1 - r0 <= 16 * s["mt"] and r0 < r1
                for c0, c1 in cols:
                    seen[r0:r1, c0:c1] += 1
                units += 1
        assert units == s["units"]
        assert (seen == 1).all(), name


def _unit_run(units, plan, name, l, grp):
    """The tiles ((K/16, quarters*cw/16, 16, 16) bf16) and the biases (cw
    f32) of one unit's run in ``pack_ar_units``' layout."""
    s = plan["stages"][name]
    run = units[name][l, grp]
    cw = s["cw"]
    tiles = run[:-2 * cw].reshape(s["K"] // 16, s["quarters"] * cw // 16,
                                  16, 16)
    return tiles, run[-2 * cw:].contiguous().view(torch.float32)


def _unpack(units, plan, name):
    """Inverse of the per-unit pack: the (L, K, quarters * N) weights
    with column q * N + g * cw + j, and the (L, G * cw) biases in the
    units' order."""
    s = plan["stages"][name]
    L, G = units[name].shape[:2]
    runs = [[_unit_run(units, plan, name, l, g) for g in range(G)]
            for l in range(L)]
    t = torch.stack([torch.stack([r[0] for r in row]) for row in runs])
    KT, ntu = t.shape[2:4]
    q, cw = s["quarters"], s["cw"]
    w = t.permute(0, 2, 4, 1, 3, 5).reshape(L, KT * 16, G, q, cw)
    bias = torch.stack([torch.cat([r[1] for r in row]) for row in runs])
    return w.permute(0, 1, 3, 2, 4).reshape(L, KT * 16, q * G * cw), bias


@pytest.mark.parametrize("B", [16, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_pack_ar_units_unpacks_bit_equal(kernel_size, B):
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1)
    params = P.init_wavenet_params(cfg, torch.Generator().manual_seed(3))
    pk = ak.pack_ar_weights(params, cfg)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS)
    units = ak.pack_ar_units(pk, plan, cfg)
    R, A = cfg.n_resch, cfg.n_aux
    Ap = -(-A // 16) * 16
    gate, zb = _unpack(units, plan, "gate")
    # the gate's biases: per column group, its sigmoid channels' zb, then
    # its tanh channels'
    hc = plan["stages"]["gate"]["cw"] // 2
    assert torch.equal(zb, pk["zb"].reshape(-1, 2, R // hc, hc)
                       .transpose(1, 2).reshape(zb.shape))
    aux = ak._interleave(pk["auxw"])
    if kernel_size == 2:
        w4 = pk["w4"]
        assert torch.equal(gate[:, :R, :2 * R], w4[..., :2 * R])
        assert torch.equal(ak._deinterleave(gate[:, :R, 2 * R:]),
                           w4[..., 2 * R:])
        assert torch.equal(gate[:, R:R + A, :2 * R], aux)
        assert not gate[:, R + A:].any() and not gate[:, R:, 2 * R:].any()
    else:
        w6 = pk["w6"]
        assert torch.equal(gate[:, :R], w6[..., :2 * R])
        assert torch.equal(gate[:, R:R + A], aux)
        assert not gate[:, R + A:R + Ap].any()
        assert torch.equal(gate[:, R + Ap:2 * R + Ap], w6[..., 2 * R:4 * R])
        assert torch.equal(gate[:, 2 * R + Ap:], w6[..., 4 * R:])
    for name, w, b in (("res", pk["wsr"], pk["srb"]),
                       ("post1", pk["post1_w"][None], pk["post1_b"][None]),
                       ("post2", pk["post2_w"][None], pk["post2_b"][None])):
        got_w, got_b = _unpack(units, plan, name)
        assert torch.equal(got_w, w) and torch.equal(got_b, b)


def _emulate(params, cfg, carry, h_up, T0, max_n, plan):
    """The persistent kernel's argmax steps, stage by stage and unit by unit
    as csrc/ar_persistent.cu runs them: each unit's A rows and packed
    weight slice through one f32 product, then its epilogue's index math.
    Updates the carry in place; returns (B, max_n) int32."""
    ring, hist, prev = carry
    R, S, Q, A, L, k = (cfg.n_resch, cfg.n_skipch, cfg.n_quantize,
                        cfg.n_aux, cfg.n_layers, cfg.kernel_size)
    B, Ap, bf = prev.shape[0], -(-A // 16) * 16, torch.bfloat16
    pk = ak.pack_ar_weights(params, cfg)
    units = ak.pack_ar_units(pk, plan, cfg)
    caps, offs, _ = P._buffer_layout(cfg)
    xs = torch.zeros((B, R + Ap), dtype=bf)
    of = torch.zeros((B, R))
    skip = torch.zeros((B, S))
    gs, sr, h1 = (torch.zeros((B, n), dtype=bf) for n in (R, S, S))
    logits = torch.zeros((B, Q))
    ids = torch.cat([hist, prev[:, None]], dim=1).clone()
    out = torch.zeros((B, max_n), dtype=torch.int32)

    def embed(p):
        v = pk["causal_b"][None].clone()
        for j in range(k):
            v = v + pk["causal_w"][j][ids[:, j].long() % Q].float()
        of.copy_(v)
        xs[:, :R] = v.to(bf)
        xs[:, R:R + A] = h_up[:, p].to(bf)

    def stage(name, l, p, epi):
        s = plan["stages"][name]
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                grp = cols[0][0] // s["cw"]
                if name == "gate":
                    parts = [xs[r0:r1]]
                    if k == 3:
                        d = cfg.dilations[l]
                        for j in (1, 2):
                            slot = offs[l] + (p - j * d) % (2 * d)
                            parts.append(ring[slot, r0:r1])
                    a = torch.cat(parts, dim=1)
                else:
                    a = {"res": gs, "post1": sr, "post2": h1}[name][r0:r1]
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
                zs, zt = z[:, cs], z[:, cs + 8]
                if k == 2:
                    rr = ring[offs[l] + p % d, r0:r1]
                    zs = zs + rr[:, c].float()
                    zt = zt + rr[:, R + c].float()
                    rr[:, c] = z[:, cw + cs].to(bf)
                    rr[:, R + c] = z[:, cw + cs + 8].to(bf)
                gs[r0:r1, c] = (torch.sigmoid(zs + bias[ci])
                                * torch.tanh(zt + bias[hc + ci])).to(bf)

            def res_epi(z, bias, grp, r0, r1, cw):
                col = grp * cw + torch.arange(cw)
                v = z + bias
                sk, rs = col < S, col >= S
                if sk.any():
                    c_ = col[sk]
                    nv = v[:, sk] if l == 0 else v[:, sk] + skip[r0:r1, c_]
                    skip[r0:r1, c_] = nv
                    if l == L - 1:
                        sr[r0:r1, c_] = torch.relu(nv).to(bf)
                if rs.any():
                    j = col[rs] - S
                    old = of[r0:r1, j].clone()
                    of[r0:r1, j] = v[:, rs] + old
                    xs[r0:r1, j] = of[r0:r1, j].to(bf)
                    if k == 3:
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
        smp = logits.argmax(dim=1).to(torch.int32)
        out[:, i] = smp
        ids = torch.cat([ids[:, 1:], smp[:, None]], dim=1)
    hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return out


@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_emulated_stages_decode_as_the_plain_loop(kernel_size, B):
    # small grids make blocks take several units (and row groups split)
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1,
               n_aux=20)
    gen = torch.Generator().manual_seed(11)
    params = P.init_wavenet_params(cfg, gen)
    for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    rng = np.random.RandomState(kernel_size)
    n = 6
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)))
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32)
    x, h = P._pad_seed(cfg, x, h)
    T0 = x.shape[1]
    carry = P._warmup_state(params, cfg, x, h)
    plan = ak.ar_plan(cfg, B, grid=7)
    # the ring after one step, every layer's written slot included
    ce, cp = (tuple(t.clone() for t in carry) for _ in range(2))
    _emulate(params, cfg, ce, h, T0, 1, plan)
    ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax")
    d = (ce[0].float() - cp[0].float()).abs().max().item()
    assert d <= 2e-2 * cp[0].float().abs().max().item()
    # same-state argmax agreement over n steps
    agree = []
    for i in range(n):
        ce = tuple(t.clone() for t in cp)
        se = _emulate(params, cfg, ce, h, T0 + i, 1, plan)
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i)
        agree.append((se == sp).float().mean().item())
    assert np.mean(agree) >= 0.97
    # and over several steps in one call (the embed of the sampled ids)
    ce, cp = (tuple(t.clone() for t in carry) for _ in range(2))
    se = _emulate(params, cfg, ce, h, T0, n, plan)
    sp = ak.ar_generate_reference(params, cfg, cp, h, T0, n, "argmax")
    assert (se == sp).float().mean().item() >= 0.9
    assert torch.equal(ce[2], se[:, -1])
