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


def _covered_once(plan, name, B, cols, rows_max):
    """Every (row, column) of stage ``name`` computed by exactly one unit of
    the blocks' runs; returns the units."""
    seen = np.zeros((B, cols), np.uint8)
    units = 0
    for block in range(plan["grid"]):
        for (r0, r1), cs in ak.ar_stage_units(plan, name, block):
            assert r1 - r0 <= rows_max and r0 < r1
            for c0, c1 in cs:
                seen[r0:r1, c0:c1] += 1
            units += 1
    assert (seen == 1).all(), name
    return units


def _check_stream(plan, cfg, quantize):
    """A streamed gate's cut: its chunks, ring and unit count agree with the
    shapes, and the ring lies in shared memory after buffer 1."""
    s = plan["stages"]["gate"]
    R, k = cfg.n_resch, cfg.kernel_size
    Ap = -(-cfg.n_aux // 16) * 16
    quarters = 2 if k == 2 else 1
    assert s["stream"] and (s["quarters"], s["N"]) == (quarters, 2 * R)
    assert s["m"] in (1, 2) and s["nw"] in ak.AR_STREAM_NW
    assert ak._stream_sums(k, quantize) * s["nw"] // 2 <= ak.AR_STREAM_ACC
    assert s["nw"] * (2 if s["m"] == 1 else 1) == quarters * s["cw"]
    assert (s["nw"] // quarters) % 16 == 0
    if quantize:
        want = (-(-R // 128), -(-R // 128) if k == 3 else 0, -(-Ap // 64))
    else:
        want = (-(-(R + Ap) // 64), -(-R // 64) if k == 3 else 0, 0)
    assert (s["nx"], s["nl"], s["na"]) == want
    assert s["nc"] == s["nx"] + 2 * s["nl"] + s["na"]
    assert s["a_bytes"] == 64 * s["m"] * 128
    assert s["w_bytes"] == quarters * s["cw"] * 128
    assert s["run"] == s["nc"] * s["w_bytes"]
    assert s["units"] == (2 * R // s["cw"]) * -(-plan["B"] // (64 * s["m"]))
    w = plan["smem_w"][0]
    assert plan["smem_w"][1] == 0 and plan["smem_a"] == 2 * w
    assert plan["smem_ring"] == w and 2 <= s["stages"] <= 4
    assert (w + 1024 + s["stages"] * (s["a_bytes"] + s["w_bytes"])
            <= plan["smem"] <= ak.AR_SMEM_MAX)
    units = _covered_once(plan, "gate", plan["B"], quarters * 2 * R,
                          64 * s["m"])
    assert units == s["units"]


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [1, 15, 16, 17, 65, 200, 208, 256, 320, 512,
                               1000, 16384])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_ar_plan_covers_every_output_once(kernel_size, B, width):
    cfg = _cfg(kernel_size, width)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS)
    assert plan["smem"] <= ak.AR_SMEM_MAX
    stream = plan["stages"]["gate"].get("stream", False)
    w = plan["smem_w"][0 if stream else 1]
    assert plan["smem_a"] == 2 * w
    if stream:
        _check_stream(plan, cfg, False)
    for name, (K, quarters, N) in ak.ar_stage_shapes(cfg).items():
        s = plan["stages"][name]
        if s.get("stream"):
            continue
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


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [1, 15, 64, 65, 130, 16384])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_stream_plan_covers_every_output_once(kernel_size, B, width,
                                              quantize):
    # the streamed gate asked for at any fleet: 64-row slabs over ragged
    # fleets, and blocks that take several units where the grid is short
    cfg = _cfg(kernel_size, width)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=quantize,
                      gate="stream")
    _check_stream(plan, cfg, quantize)
    for name in ("res", "post1", "post2"):
        K, quarters, N = ak.ar_stage_shapes(cfg, quantize)[name]
        s = plan["stages"][name]
        assert _covered_once(plan, name, B, quarters * N,
                             16 * s["mt"]) == s["units"]


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [208, 256, 320, 512, 1000])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_stream_plan_fits_the_grid_evenly(kernel_size, B, width, quantize):
    # no more units than blocks, so no block takes a second unit while
    # others wait at the barrier, and every stage's shared memory fits
    cfg = _cfg(kernel_size, width)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=quantize,
                      gate="stream")
    s = plan["stages"]["gate"]
    per = [len(list(ak.ar_stage_units(plan, "gate", b)))
           for b in range(plan["grid"])]
    assert s["units"] <= plan["grid"] and sum(per) == s["units"]
    assert max(per) - min(per) <= 1
    assert plan["smem"] <= ak.AR_SMEM_MAX
    _check_stream(plan, cfg, quantize)


def test_stream_cut_takes_the_fewest_bytes_that_fit_the_grid():
    # bf16 kernel_size 3 at the JAX package's fleet of 256: 64 rows x 32
    # gate columns, 4 row blocks x 32 column groups = 128 units, one a
    # block; each reads (64 + 32) x K x 2 bytes (K = 3R + Ap)
    cfg = _cfg(3, "flagship")
    s = ak.ar_plan(cfg, 256, grid=ak.H100_SMS, gate="stream")["stages"]["gate"]
    assert (s["m"], s["cw"], s["nw"], s["units"]) == (1, 32, 16, 128)
    for B in (208, 512, 1000):
        got = ak.ar_plan(cfg, B, grid=ak.H100_SMS, gate="stream")
        g = got["stages"]["gate"]
        # every other cut that fits the grid reads at least as many bytes
        for m in (1, 2):
            for cw in (32, 64, 128, 256):
                units = (1024 // cw) * -(-B // (64 * m))
                if units <= ak.H100_SMS and cw // (2 if m == 1 else 1) <= 128:
                    assert 64 * g["m"] + g["cw"] <= 64 * m + cw


@pytest.mark.parametrize("n_resch", [768, 1024])
@pytest.mark.parametrize("B", [1, 16, 256])
def test_wide_resch_k3_has_a_persistent_plan(n_resch, B):
    # K = 3R + Ap no longer caps the gate's cut: it streams
    cfg = _cfg(3, "flagship", n_resch=n_resch)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS)
    assert plan["stages"]["gate"]["stream"]
    assert plan["smem"] <= ak.AR_SMEM_MAX
    with pytest.raises(ValueError, match="no cut"):
        ak.ar_plan(cfg, B, grid=ak.H100_SMS, gate="units")
    _check_stream(plan, cfg, False)


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


def _stream_unit_w(units, plan, cfg, l, grp):
    """A streamed gate unit's run read back: per K segment (the stream's
    rows, the lags d and 2d, the int8 path's bf16 aux rows) its weights,
    (K of the segment, quarters * cw) with column q * cw + j in quarter
    order, bf16 or int8 as packed (the chunks unswizzled, the zero rows
    past each segment's K checked and cut)."""
    s = plan["stages"]["gate"]
    R, k = cfg.n_resch, cfg.kernel_size
    Ap = -(-cfg.n_aux // 16) * 16
    q, cw = s["quarters"], s["cw"]
    P = 2 if s["m"] == 1 else 1
    ncols = q * cw
    run = units["gate"][l, grp]
    assert run.dtype == torch.uint8 and run.numel() == s["run"]
    tiles = ak._swizzle128(run.reshape(s["nc"], ncols, 128))
    if plan["quantize"]:
        segs = [(s["nx"], R, torch.int8)] * (3 if k == 3 else 1) \
            + [(s["na"], Ap, torch.bfloat16)]
    else:
        segs = [(s["nx"], R + Ap, torch.bfloat16)] \
            + [(s["nl"], R, torch.bfloat16)] * (2 if k == 3 else 0)
    out, c0 = [], 0
    for nch, K, dt in segs:
        t = tiles[c0:c0 + nch].contiguous().view(dt)     # (nch, ncols, depth)
        c0 += nch
        w = t.permute(0, 2, 1).reshape(-1, ncols)           # (nch * depth, ncols)
        assert not w[K:].float().any()
        # columns in the warpgroups' order (part, quarter, j) -> (quarter,
        # part, j)
        w = w[:K].reshape(K, P, q, cw // P).transpose(1, 2).reshape(K, ncols)
        out.append(w)
    assert c0 == s["nc"]
    return out


def _stream_unpack(units, plan, cfg):
    """Every streamed unit read back (``_stream_unit_w``) as whole
    segments, (L, K, quarters * N) each with column q * N + c."""
    s = plan["stages"]["gate"]
    L, G, q, cw = cfg.n_layers, s["G"], s["quarters"], s["cw"]
    per = [[_stream_unit_w(units, plan, cfg, l, g) for g in range(G)]
           for l in range(L)]
    segs = []
    for i in range(len(per[0][0])):
        t = torch.stack([torch.stack([per[l][g][i] for g in range(G)])
                         for l in range(L)])          # (L, G, K, q * cw)
        K = t.shape[2]
        segs.append(t.reshape(L, G, K, q, cw).permute(0, 2, 3, 1, 4)
                    .reshape(L, K, q * G * cw))
    return segs


@pytest.mark.parametrize("B", [16, 256, 1000])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_pack_ar_units_unpacks_bit_equal(kernel_size, B):
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1)
    params = P.init_wavenet_params(cfg, torch.Generator().manual_seed(3))
    pk = ak.pack_ar_weights(params, cfg)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS)
    units = ak.pack_ar_units(pk, plan, cfg)
    R, A = cfg.n_resch, cfg.n_aux
    Ap = -(-A // 16) * 16
    if plan["stages"]["gate"].get("stream"):
        # the streamed gate's chunks hold the same rows; its biases are
        # pack_ar_weights' zb, read in channel order
        gate = torch.cat(_stream_unpack(units, plan, cfg), dim=1)
    else:
        gate, zb = _unpack(units, plan, "gate")
        # the gate's biases: per column group, its sigmoid channels' zb,
        # then its tanh channels'
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
                if s.get("stream"):
                    # the unit's chunks read back; its biases zb of its
                    # sigmoid then tanh channels
                    w = torch.cat(_stream_unit_w(units, plan, cfg, l, grp))
                    hc = s["cw"] // 2
                    ch = grp * hc + torch.arange(hc)
                    bias = torch.cat([pk["zb"][l, ch], pk["zb"][l, R + ch]])
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


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_emulated_stages_decode_as_the_plain_loop(kernel_size, B, gate):
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
    plan = ak.ar_plan(cfg, B, grid=7, gate=gate)
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


# ---------------------------------------------------------------------------
# int8 (quantize=True): the plan, the per-unit runs and the stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("B", [1, 16, 17, 32, 65, 208, 256, 320, 512, 1000])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_ar_plan_covers_every_output_once(kernel_size, B, width):
    cfg = _cfg(kernel_size, width)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=True)
    assert plan["quantize"] and plan["smem"] <= ak.AR_SMEM_MAX
    R, Ap = cfg.n_resch, -(-cfg.n_aux // 16) * 16
    stream = plan["stages"]["gate"].get("stream", False)
    w = plan["smem_w"][0 if stream else 1]
    if stream:
        _check_stream(plan, cfg, True)
    for name, (K, quarters, N) in ak.ar_stage_shapes(cfg, True).items():
        s = plan["stages"][name]
        if s.get("stream"):
            continue
        rows, cw = 16 * s["mt"], s["cw"]
        if name in ("gate", "res"):
            # int8 weights, (gate) bf16 aux tiles, f32 scales and biases
            segs = 3 if name == "gate" and kernel_size == 3 else 1
            gate = name == "gate"
            assert K == R and s["segs"] == segs
            run = (segs * K * quarters * cw + (2 * Ap * cw if gate else 0)
                   + 4 * (segs * quarters * cw + (2 if gate else 1) * cw))
            a_row = (R + 16 + (2 * (Ap + 8) if gate else 0)
                     + (2 * R + 16 if gate and kernel_size == 3 else 0))
            sums = (4 * segs * s["ks"] * rows * quarters * cw
                    + (4 * rows * cw if gate else 0))
            assert 1 <= s["ks"] <= K // 32
        else:
            run = (K * quarters + 2) * cw * 2
            a_row = 2 * (K + ak.AR_A_PAD)
            sums = s["ks"] * rows * quarters * cw * 4
            assert s["segs"] == 0 and 1 <= s["ks"] <= K // 16
        assert (s["w"], s["a"], s["p"]) == (run, rows * a_row, sums)
        assert run <= w and run % 16 == 0
        assert rows * a_row <= plan["smem_p"] - plan["smem_a"]
        assert sums <= plan["smem_e"] - plan["smem_p"]
        assert rows * cw * 4 <= plan["smem"] - plan["smem_e"]
        seen = np.zeros((B, quarters * N), np.uint8)
        units = 0
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                assert r1 - r0 <= rows and r0 < r1
                for c0, c1 in cols:
                    seen[r0:r1, c0:c1] += 1
                units += 1
        assert units == s["units"]
        assert (seen == 1).all(), name


def _unit_run_i8(units, plan, cfg, name, l, grp):
    """One int8 unit's run in ``pack_ar_units``' layout, read back from its
    bytes: the int8 weights (segs, R, quarters*cw) with the unit's columns
    in quarter order, (gate) the aux weights (Ap, cw) bf16, the column
    scales (segs, quarters*cw) and the biases (f32)."""
    s = plan["stages"][name]
    R, Ap = cfg.n_resch, -(-cfg.n_aux // 16) * 16
    cols, segs = s["quarters"] * s["cw"], s["segs"]
    run = units[name][l, grp]
    assert run.dtype == torch.uint8 and run.numel() == s["w"]
    n8 = segs * R * cols
    t = run[:n8].view(torch.int8).reshape(segs, R // 32, cols // 16, 2, 2, 8,
                                          16)
    # [seg][k chunk][tile][column half][k half][column][k byte]
    w = t.permute(0, 1, 4, 6, 2, 3, 5).reshape(segs, R, cols)
    o, aux = n8, None
    if name == "gate":
        n = Ap * s["cw"] * 2
        aux = (run[o:o + n].view(torch.bfloat16)
               .reshape(Ap // 16, s["cw"] // 16, 16, 16)
               .permute(0, 2, 1, 3).reshape(Ap, s["cw"]))
        o += n
    f = run[o:].view(torch.float32)
    return w, aux, f[:segs * cols].reshape(segs, cols), f[segs * cols:]


def _unpack_i8(units, plan, cfg, name):
    """Inverse of the int8 per-unit pack: the (L, segs, R, quarters * N)
    int8 weights and (L, segs, quarters * N) scales with column q * N + g *
    cw + j, (gate) the (L, Ap, cw * G) aux weights, and the (L, G, nb)
    biases of each unit."""
    s = plan["stages"][name]
    q, cw, G = s["quarters"], s["cw"], s["G"]
    runs = [[_unit_run_i8(units, plan, cfg, name, l, g) for g in range(G)]
            for l in range(cfg.n_layers)]

    def quarter_major(x):
        # (L, G, ..., q * cw) -> (L, ..., q * G * cw)
        x = x.reshape(*x.shape[:-1], q, cw).movedim(1, -2)
        return x.reshape(*x.shape[:-3], q * G * cw)

    w = quarter_major(torch.stack([torch.stack([r[0] for r in row])
                                   for row in runs]))
    sc = quarter_major(torch.stack([torch.stack([r[2] for r in row])
                                    for row in runs]))
    aux = (torch.stack([torch.cat([r[1] for r in row], dim=1)
                        for row in runs]) if name == "gate" else None)
    bias = torch.stack([torch.stack([r[3] for r in row]) for row in runs])
    return w, sc, aux, bias


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [16, 256])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_pack_ar_units_unpacks_bit_equal(kernel_size, B, gate):
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1)
    gen = torch.Generator().manual_seed(5)
    params = P.init_wavenet_params(cfg, gen)
    for group in ("dil", "aux", "skip", "res"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    pk = ak.pack_ar_weights(params, cfg)
    q = ak.quantize_ar_weights(params, cfg)
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=True, gate=gate)
    units = ak.pack_ar_units(pk, plan, cfg)
    R, A, L = cfg.n_resch, cfg.n_aux, cfg.n_layers
    if gate == "stream":
        _check_stream_i8(units, plan, cfg, pk, q)
    else:
        _check_units_gate_i8(units, plan, cfg, pk, q, params)
    w, sc, _, bias = _unpack_i8(units, plan, cfg, "res")
    assert torch.equal(w[:, 0], q["wsr"])
    assert torch.equal(sc[:, 0], q["wsr_scale"])
    assert torch.equal(bias.reshape(L, -1), pk["srb"])
    # post1 and post2 are bf16 runs, as in the bf16 plan
    for name in ("post1", "post2"):
        got_w, got_b = _unpack(units, plan, name)
        want_w = pk[name + "_w"][None]
        assert torch.equal(got_w, want_w)
        assert torch.equal(got_b, pk[name + "_b"][None])


def _check_stream_i8(units, plan, cfg, pk, q):
    """The streamed int8 gate's runs and scales hold ``_quantize_pack``'s
    weights and column scales and the bf16 aux rows."""
    R, A, k = cfg.n_resch, cfg.n_aux, cfg.kernel_size
    segs = _stream_unpack(units, plan, cfg)
    aux, gsc = segs.pop(), units["gate_scales"]
    if k == 2:
        # one int8 product over [current | past], the past tap interleaved
        # like the current one; scales in channel order
        assert len(segs) == 1 and gsc.shape[1] == 2
        assert torch.equal(segs[0][..., :2 * R], q["w4"][..., :2 * R])
        assert torch.equal(ak._deinterleave(segs[0][..., 2 * R:]),
                           q["w4"][..., 2 * R:])
        assert torch.equal(gsc[:, 0], ak._deinterleave(q["w4_scale"][:, :2 * R]))
        assert torch.equal(gsc[:, 1], q["w4_scale"][:, 2 * R:])
        assert not aux[..., 2 * R:].any()
    else:
        assert len(segs) == 3 and gsc.shape[1] == 3
        for j in range(3):
            blk = slice(j * 2 * R, (j + 1) * 2 * R)
            assert torch.equal(segs[j], q["w6"][..., blk])
            assert torch.equal(gsc[:, j], ak._deinterleave(q["w6_scale"][:, blk]))
    assert torch.equal(aux[:, :A, :2 * R], ak._interleave(pk["auxw"]))
    assert not aux[:, A:].any()


def _check_units_gate_i8(units, plan, cfg, pk, q, params):
    """The int8 gate's per-unit runs (the gate cut into units)."""
    R, A, L, kernel_size = cfg.n_resch, cfg.n_aux, cfg.n_layers, cfg.kernel_size
    w, sc, aux, bias = _unpack_i8(units, plan, cfg, "gate")
    if kernel_size == 2:
        # the past tap interleaved like the current one, weights and scales
        assert torch.equal(w[:, 0, :, :2 * R], q["w4"][..., :2 * R])
        assert torch.equal(ak._deinterleave(w[:, 0, :, 2 * R:]),
                           q["w4"][..., 2 * R:])
        assert torch.equal(sc[:, 0, :2 * R], q["w4_scale"][:, :2 * R])
        assert torch.equal(ak._deinterleave(sc[:, 0, 2 * R:]),
                           q["w4_scale"][:, 2 * R:])
    else:
        for j in range(3):
            blk = slice(j * 2 * R, (j + 1) * 2 * R)
            assert torch.equal(w[:, j], q["w6"][..., blk])
            assert torch.equal(sc[:, j], q["w6_scale"][:, blk])
    # the aux rows over the current tap's columns, zero-padded to tiles
    assert torch.equal(aux[:, :A], ak._interleave(pk["auxw"]))
    assert not aux[:, A:].any()
    # per column group: aux_b of its sigmoid then tanh channels, then dil_b
    hc = plan["stages"]["gate"]["cw"] // 2
    for i, key in enumerate(("aux", "dil")):
        want = params[key]["b"].reshape(L, 2, R // hc, hc).transpose(1, 2)
        assert torch.equal(bias[..., i * 2 * hc:(i + 1) * 2 * hc],
                           want.reshape(L, R // hc, 2 * hc))


def _stream_run_i8(units, plan, cfg, pk, l, grp):
    """A streamed int8 gate unit as ``_unit_run_i8`` gives a unit's run:
    the int8 weights (segs, R, quarters*cw), the aux weights over the
    current tap's cw columns, the column scales (segs, quarters*cw) in
    the units' interleaved order (from "gate_scales", channel order) and
    the biases [aux_b, dil_b], each of the unit's sigmoid then tanh
    channels."""
    s = plan["stages"]["gate"]
    R, cw = cfg.n_resch, s["cw"]
    segs = _stream_unit_w(units, plan, cfg, l, grp)
    aux = segs.pop()[:, :cw]
    gsc = units["gate_scales"][l]
    cols = slice(grp * cw, (grp + 1) * cw)
    il = [ak._interleave(gsc[j])[cols] for j in range(gsc.shape[0])]
    sc = torch.stack([torch.cat(il)] if cfg.kernel_size == 2 else il)
    hc = cw // 2
    ch = grp * hc + torch.arange(hc)
    eb = torch.cat([pk[key][l, c] for key in ("auxb", "dilb")
                    for c in (ch, R + ch)])
    return torch.stack(segs), aux, sc, eb


def _emulate_i8(params, cfg, carry, h_up, T0, max_n, plan, scales):
    """The persistent kernel's int8 argmax steps, stage by stage and unit by
    unit as csrc/ar_persistent.cu runs them (Q8): each unit's int8 A rows
    and the weights read back from its packed run through exact integer
    products, the aux term a bf16 product, then its epilogue's index math
    and f32 order of sums; post1 and post2 as in ``_emulate``.  Updates
    the carry in place; returns (B, max_n) int32."""
    ring, hist, prev = carry
    R, S, Q, A, L, k = (cfg.n_resch, cfg.n_skipch, cfg.n_quantize,
                        cfg.n_aux, cfg.n_layers, cfg.kernel_size)
    B, bf = prev.shape[0], torch.bfloat16
    pk = ak.pack_ar_weights(params, cfg)
    units = ak.pack_ar_units(pk, plan, cfg)
    caps, offs, _ = P._buffer_layout(cfg)
    asc = scales.reshape(-1).float()
    ainv = 1.0 / asc
    gscale = torch.tensor(ak.GATE_SCALE, dtype=torch.float32)
    ginv = 1.0 / gscale
    of, skip, logits = (torch.zeros((B, n)) for n in (R, S, Q))
    xq, gq = torch.zeros((B, R)), torch.zeros((B, R))
    xa = torch.zeros((B, A), dtype=bf)
    sr, h1 = (torch.zeros((B, S), dtype=bf) for _ in range(2))
    ids = torch.cat([hist, prev[:, None]], dim=1).clone()
    out = torch.zeros((B, max_n), dtype=torch.int32)

    def quant(v):
        return torch.clamp(torch.round(v), -127, 127)

    def embed(p):
        v = pk["causal_w"][0][ids[:, 0].long() % Q].float()
        for j in range(1, k):
            v = v + pk["causal_w"][j][ids[:, j].long() % Q].float()
        v = v + pk["causal_b"]
        of.copy_(v)
        xq.copy_(quant(v * ainv[0]))
        xa.copy_(h_up[:, p].to(bf))

    def int8_stage(name, l, p, epi):
        s = plan["stages"][name]
        d = cfg.dilations[l]
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                grp = cols[0][0] // s["cw"]
                if s.get("stream"):
                    w, aux, sc, eb = _stream_run_i8(units, plan, cfg, pk, l,
                                                    grp)
                else:
                    w, aux, sc, eb = _unit_run_i8(units, plan, cfg, name, l,
                                                  grp)
                if name == "gate":
                    parts = [xq[r0:r1]] + [
                        ring[offs[l] + (p - j * d) % (2 * d), r0:r1].float()
                        for j in range(1, w.shape[0])]
                    za = xa[r0:r1].float() @ aux[:A].float()
                else:
                    parts, za = [gq[r0:r1]], None
                # exact integer sums, as the int32 MMA sums
                z = [(a.double() @ w[j].double()).float()
                     for j, a in enumerate(parts)]
                epi(z, za, sc, eb, grp, r0, r1, s["cw"])

    def bf_stage(name, epi):
        s = plan["stages"][name]
        src = {"post1": sr, "post2": h1}[name]
        for block in range(plan["grid"]):
            for (r0, r1), cols in ak.ar_stage_units(plan, name, block):
                grp = cols[0][0] // s["cw"]
                t, bias = _unit_run(units, plan, name, 0, grp)
                w = t.permute(0, 2, 1, 3).reshape(t.shape[0] * 16, -1)
                epi(src[r0:r1].float() @ w.float(), bias, grp, r0, r1,
                    s["cw"])

    for i in range(max_n):
        p = T0 - 1 + i
        embed(p)
        for l in range(L):
            d = cfg.dilations[l]

            def gate_epi(z, za, sc, eb, grp, r0, r1, cw):
                hc = cw // 2
                ci = torch.arange(hc)
                c = grp * hc + ci
                cs = (ci >> 3) * 16 + (ci & 7)
                ct = cs + 8

                def dq(j, col):
                    return z[j][:, col] * (asc[l] * sc[j][col])
                za_s, za_t = za[:, cs] + eb[ci], za[:, ct] + eb[hc + ci]
                if k == 2:
                    rr = ring[offs[l] + p % d, r0:r1]
                    ps, pt = rr[:, c].float(), rr[:, R + c].float()
                    rr[:, c] = dq(0, cw + cs).to(bf)
                    rr[:, R + c] = dq(0, cw + ct).to(bf)
                else:
                    ps, pt = dq(1, cs) + dq(2, cs), dq(1, ct) + dq(2, ct)
                zs = dq(0, cs) + ((ps + za_s) + eb[cw + ci])
                zt = dq(0, ct) + ((pt + za_t) + eb[cw + hc + ci])
                gq[r0:r1, c] = quant(torch.sigmoid(zs) * torch.tanh(zt)
                                     * ginv)

            def res_epi(z, za, sc, eb, grp, r0, r1, cw):
                col = grp * cw + torch.arange(cw)
                v = z[0] * (gscale * sc[0]) + eb
                for jj in range(cw):
                    cc = int(col[jj])
                    if cc < S:
                        nv = v[:, jj] + (skip[r0:r1, cc] if l else 0.0)
                        skip[r0:r1, cc] = nv
                        if l == L - 1:
                            sr[r0:r1, cc] = torch.relu(nv).to(bf)
                    else:
                        j = cc - S
                        old = of[r0:r1, j].clone()
                        of[r0:r1, j] = v[:, jj] + old
                        if l + 1 < L:
                            xq[r0:r1, j] = quant(of[r0:r1, j] * ainv[l + 1])
                        if k == 3:
                            ring[offs[l] + p % (2 * d), r0:r1, j] = \
                                quant(old * ainv[l]).to(ring.dtype)

            int8_stage("gate", l, p, gate_epi)
            int8_stage("res", l, p, res_epi)

        def post1_epi(z, bias, grp, r0, r1, cw):
            col = grp * cw + torch.arange(cw)
            h1[r0:r1, col] = torch.relu(z + bias).to(bf)

        def post2_epi(z, bias, grp, r0, r1, cw):
            col = grp * cw + torch.arange(cw)
            logits[r0:r1, col] = z + bias

        bf_stage("post1", post1_epi)
        bf_stage("post2", post2_epi)
        smp = logits.argmax(dim=1).to(torch.int32)
        out[:, i] = smp
        ids = torch.cat([ids[:, 1:], smp[:, None]], dim=1)
    hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return out


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_int8_emulated_stages_decode_as_the_plain_int8_loop(kernel_size, B,
                                                             gate):
    # small grids make blocks take several units (and row groups split);
    # the limits are chip_smoke.py's [K1 int8]: the ring written in one
    # step within 5e-2 of max|ring| with at most a quarter of it differing,
    # same-state argmax >= 0.97
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1,
               n_aux=20)
    gen = torch.Generator().manual_seed(13)
    params = P.init_wavenet_params(cfg, gen)
    for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    rng = np.random.RandomState(20 + kernel_size)
    n = 6
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)))
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32)
    x, h = P._pad_seed(cfg, x, h)
    T0 = x.shape[1]
    carry, maxes = P._warmup_state(params, cfg, x, h, collect_act_maxes=True)
    scales = ak.act_scales_from_maxes(maxes)
    if kernel_size == 3:
        carry = (ak.int8_ring_fill(carry[0], scales, cfg),) + carry[1:]
    plan = ak.ar_plan(cfg, B, grid=7, quantize=True, gate=gate)
    q = dict(quantize=True, act_scales=scales)
    # the ring slots written by the first step, every layer
    caps, offs, _ = P._buffer_layout(cfg)
    rows = torch.tensor([o + (T0 - 1) % c for o, c in zip(offs, caps)])
    ce, cp = (tuple(t.clone() for t in carry) for _ in range(2))
    _emulate_i8(params, cfg, ce, h, T0, 1, plan, scales)
    ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax", **q)
    want = cp[0][rows].float()
    diff = (ce[0][rows].float() - want).abs()
    assert diff.max().item() <= 5e-2 * want.abs().max().item()
    assert (diff > 0).float().mean().item() <= 0.25
    agree = []
    for i in range(n):
        ce = tuple(t.clone() for t in cp)
        se = _emulate_i8(params, cfg, ce, h, T0 + i, 1, plan, scales)
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i, **q)
        agree.append((se == sp).float().mean().item())
    assert np.mean(agree) >= 0.97
    ce, cp = (tuple(t.clone() for t in carry) for _ in range(2))
    se = _emulate_i8(params, cfg, ce, h, T0, n, plan, scales)
    sp = ak.ar_generate_reference(params, cfg, cp, h, T0, n, "argmax", **q)
    assert (se == sp).float().mean().item() >= 0.9
    assert torch.equal(ce[2], se[:, -1])


# ---------------------------------------------------------------------------
# conditioning past the 96 aux rows the caps were set for
# ---------------------------------------------------------------------------

#: the flagship windows the recipes train on (arctic-sd k=2, ljspeech-sd k=3)
FLAGSHIP_T = {2: 23040, 3: 21120}


def _buffer_caps(plan):
    """The two weight buffers' bytes as csrc/ar_persistent.cu's check_plan
    reads them from the offsets: [buffer 0 | buffer 1 | A rows], or with a
    streamed gate [buffer 1 | buffer 0 | A rows]."""
    lo = 1 if plan["stages"]["gate"].get("stream") else 0
    w = plan["smem_w"]
    caps = [0, 0]
    caps[lo] = w[1 - lo] - w[lo]
    caps[1 - lo] = plan["smem_a"] - w[1 - lo]
    assert w[lo] == 0 and min(caps) >= 0
    return caps


def _kernel_bytes(cfg, name, s, quantize):
    """(weight run, A rows, sums, epilogue operands) of a unit of stage
    ``name`` as check_plan computes them."""
    R, Ap, k = cfg.n_resch, -(-cfg.n_aux // 16) * 16, cfg.kernel_size
    K, quarters, _N = ak.ar_stage_shapes(cfg, quantize)[name]
    rows, cw = 16 * s["mt"], s["cw"]
    cols = quarters * cw
    gate = name == "gate"
    if s["segs"]:
        w = (s["segs"] * K * cols + (2 * Ap * cw if gate else 0)
             + 4 * (s["segs"] * cols + (2 if gate else 1) * cw))
        a = rows * (R + 16 + (2 * (Ap + 8) if gate else 0)
                    + (2 * R + 16 if gate and k == 3 else 0))
        p = 4 * s["segs"] * s["ks"] * rows * cols + (4 * rows * cw if gate
                                                     else 0)
    else:
        w = (K * cols + 2 * cw) * 2
        a = rows * (K + (2 if gate and k == 3 else 1) * ak.AR_A_PAD) * 2
        p = 4 * s["ks"] * rows * cols
    return w, a, p, rows * cw * 4


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_every_aux_width_has_a_plan_of_each_design(kernel_size):
    """At the flagship widths every n_aux 1..AUX_MAX is in the envelope of
    K1 (bf16, int8), K2 and K3, and every fleet 16-512 has a plan of each
    gate design, bf16 and int8, within a block's shared memory.  The plans
    depend on n_aux through its whole 16-row tiles only (``_aux_pad``), so
    the 64 widths 16, 32, .. AUX_MAX are every plan there is."""
    from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX
    from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

    T = FLAGSHIP_T[kernel_size]
    for n_aux in range(1, AUX_MAX + 1):
        cfg = _cfg(kernel_size, "flagship", n_aux=n_aux)
        assert ak.ar_kernel_constraint_error(cfg) is None, n_aux
        assert ak.ar_kernel_constraint_error(cfg, quantize=True) is None
        assert tk.layer_stack_constraint_error(cfg) is None, n_aux
        assert tk.fused_train_constraint_error(cfg, T) is None, n_aux
    for Ap in range(16, AUX_MAX + 1, 16):
        cfg = _cfg(kernel_size, "flagship", n_aux=Ap)
        for quantize in (False, True):
            for gate in ak.AR_GATES:
                for B in (16, 32, 64, 128, 256, 512):
                    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS,
                                      quantize=quantize, gate=gate)
                    assert plan["smem"] <= ak.AR_SMEM_MAX
                    caps = _buffer_caps(plan)
                    for name in ak.AR_STAGES:
                        s = plan["stages"][name]
                        if not s.get("stream"):
                            assert s["w"] <= caps[ak.AR_STAGES.index(name)
                                                  & 1], (Ap, B, name)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("n_aux", [129, 1024])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_wide_aux_plans_cover_every_output_once(kernel_size, n_aux, gate,
                                                quantize):
    """A speaker-coded 128-band mel (n_aux 129) and AUX_MAX at the flagship
    widths, B 16-512, each gate design, bf16 and int8: each unit's bytes
    are the kernel's own count and fit its region (a wide units gate's
    buffers each of its own stages' size), and every output of every stage
    is computed by exactly one unit."""
    cfg = _cfg(kernel_size, "flagship", n_aux=n_aux)
    for B in (16, 32, 64, 128, 256, 512):
        plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=quantize,
                          gate=gate)
        assert plan["smem"] <= ak.AR_SMEM_MAX
        caps = _buffer_caps(plan)
        if gate == "stream":
            _check_stream(plan, cfg, quantize)
        for i, (name, (K, quarters, N)) in enumerate(
                ak.ar_stage_shapes(cfg, quantize).items()):
            s = plan["stages"][name]
            if s.get("stream"):
                continue
            w, a, p, e = _kernel_bytes(cfg, name, s, quantize)
            assert (s["w"], s["a"], s["p"], s["e"]) == (w, a, p, e), name
            assert w <= caps[i & 1] and a <= plan["smem_p"] - plan["smem_a"]
            assert p <= plan["smem_e"] - plan["smem_p"]
            assert e <= plan["smem"] - plan["smem_e"]
            assert _covered_once(plan, name, B, quarters * N,
                                 16 * s["mt"]) == s["units"]


def _wide_aux_decode(kernel_size, B, gate, quantize, seed):
    """n_aux 129 at the narrow width, 3 layers: the emulated stages (bf16
    or int8) against the plain loop, with the limits of the n_aux 20 tests
    above (same-state argmax >= 0.97; bf16 ring within 2e-2 of max|ring|,
    int8 within 5e-2 with at most a quarter of the written slots apart)."""
    cfg = _cfg(kernel_size, "narrow", dilation_depth=3, dilation_repeat=1,
               n_aux=129)
    gen = torch.Generator().manual_seed(seed)
    params = P.init_wavenet_params(cfg, gen)
    for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    rng = np.random.RandomState(seed + kernel_size)
    n = 6
    x = torch.as_tensor(rng.randint(0, 256, (B, cfg.receptive_field)))
    h = torch.as_tensor(rng.randn(B, cfg.receptive_field + n, cfg.n_aux),
                        dtype=torch.float32)
    x, h = P._pad_seed(cfg, x, h)
    T0 = x.shape[1]
    plan = ak.ar_plan(cfg, B, grid=7, quantize=quantize, gate=gate)
    caps, offs, _ = P._buffer_layout(cfg)
    rows = torch.tensor([o + (T0 - 1) % c for o, c in zip(offs, caps)])
    if quantize:
        carry, maxes = P._warmup_state(params, cfg, x, h,
                                       collect_act_maxes=True)
        scales = ak.act_scales_from_maxes(maxes)
        if kernel_size == 3:
            carry = (ak.int8_ring_fill(carry[0], scales, cfg),) + carry[1:]
        q = dict(quantize=True, act_scales=scales)

        def emulate(c_, p, steps):
            return _emulate_i8(params, cfg, c_, h, p, steps, plan, scales)
    else:
        carry = P._warmup_state(params, cfg, x, h)
        q = {}

        def emulate(c_, p, steps):
            return _emulate(params, cfg, c_, h, p, steps, plan)
    ce, cp = (tuple(t.clone() for t in carry) for _ in range(2))
    emulate(ce, T0, 1)
    ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax", **q)
    want = cp[0][rows].float()
    diff = (ce[0][rows].float() - want).abs()
    assert diff.max().item() <= (5e-2 if quantize else 2e-2) * \
        want.abs().max().item()
    if quantize:
        assert (diff > 0).float().mean().item() <= 0.25
    agree = []
    for i in range(n):
        ce = tuple(t.clone() for t in cp)
        se = emulate(ce, T0 + i, 1)
        sp = ak.ar_generate_reference(params, cfg, cp, h, T0, 1, "argmax",
                                      i0=i, **q)
        agree.append((se == sp).float().mean().item())
    assert np.mean(agree) >= 0.97


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_wide_aux_emulated_stages_decode_as_the_plain_loop(kernel_size, gate):
    _wide_aux_decode(kernel_size, 37, gate, False, 31)


@pytest.mark.parametrize("gate", ak.AR_GATES)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_wide_aux_int8_emulated_stages_decode_as_the_plain_int8_loop(
        kernel_size, gate):
    _wide_aux_decode(kernel_size, 37, gate, True, 33)


# ---------------------------------------------------------------------------
# the kernel's waits: a counter a stage, its targets and the schedule
# ---------------------------------------------------------------------------

#: fleets on both sides of every unit height and gate design
WAIT_FLEETS = [1, 16, 17, 31, 32, 33, 48, 63, 64, 128, 256, 512]
#: the stages a unit waits on: the previous stage of each (the gate of
#: layer 0 waits on the sample stage, later gates on the res stage)
WAITS_ON = {"res": "gate", "post1": "res", "post2": "post1",
            "sample": "post2"}


def _stage_rows(plan, stage, block):
    """The row ranges of the units ``block`` takes in ``stage`` (an
    ``AR_STAGES`` name or "sample"), in the kernel's order."""
    if stage == "sample":
        return list(ak.ar_sample_units(plan, block))
    return [rows for rows, _ in ak.ar_stage_units(plan, stage, block)]


def _per_row(plan, stage):
    """The units of one run of ``stage`` that write each row."""
    return 1 if stage == "sample" else plan["stages"][stage]["G"]


def _units_plan(kernel_size, B, quantize):
    """The plan of the kernel's units instance (the one with counter
    waits) for the flagship widths: ``ar_plan``'s where its gate is cut
    into units, else the one ``gate="units"`` asks for; and ``ar_plan``'s
    own.  A plan whose gate streams waits at grid barriers: no counter
    waits."""
    cfg = _cfg(kernel_size, "flagship")
    plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=quantize)
    if plan["stages"]["gate"].get("stream"):
        assert ak.ar_waits_per_step(plan, cfg.n_layers) == 0
        plan = ak.ar_plan(cfg, B, grid=ak.H100_SMS, quantize=quantize,
                          gate="units")
    return plan


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B", WAIT_FLEETS)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_stage_targets_count_the_units(kernel_size, B, quantize):
    plan = _units_plan(kernel_size, B, quantize)
    grid, tiles = plan["grid"], plan["tiles_max"]
    # the shortest units whose gate cut fits the grid
    fits = plan["stages"]["gate"]["units"] <= grid
    assert fits or tiles == 4
    if fits and tiles > 1:
        shorter = ak._plan_units_at(_cfg(kernel_size, "flagship"),
                                    quantize, B, grid, tiles - 1)
        assert shorter is None or shorter["stages"]["gate"]["units"] > grid
    waits = 0
    for stage in ak.AR_STAGES + ("sample",):
        count = 0
        with_unit = set()
        for block in range(grid):
            rows = _stage_rows(plan, stage, block)
            for r0, r1 in rows:
                assert 0 < r1 - r0 <= 16 * tiles, (stage, r0, r1)
                count += 1
            if rows:
                with_unit.add(block)
            waits += len(rows)
        # each target is the units that write the stage's rows
        assert ak.ar_stage_target(plan, stage) == count, stage
        # the blocks that wait in the stage are those with a unit: the
        # kernel's contiguous runs, one unit a block where the grid holds
        # them all
        units = (-(-B // ak.AR_SAMPLE_ROWS) if stage == "sample"
                 else plan["stages"][stage]["units"])
        assert with_unit == {b for b in range(grid)
                             if (b + 1) * units // grid > b * units // grid}
        assert len(with_unit) == min(units, grid)
    assert waits == ak.ar_waits_per_step(plan, 1)


def _schedule(plan, n_layers, steps):
    """Each block's units in the kernel's order: (stage, its run, rows,
    the stage it waits on, that stage's runs it waits for).  The first
    step's embed is the sample stage's first run."""
    runs = dict.fromkeys(ak.AR_STAGES, 0)
    runs["sample"] = 1
    order = [("sample", 0, None, 0)]
    for _step in range(steps):
        for l in range(n_layers):
            for stage in ("gate", "res"):
                on = WAITS_ON.get(stage) or ("res" if l else "sample")
                order.append((stage, runs[stage], on, runs[on]))
                runs[stage] += 1
        for stage in ("post1", "post2", "sample"):
            on = WAITS_ON[stage]
            order.append((stage, runs[stage], on, runs[on]))
            runs[stage] += 1
    progs = [[(stage, run, rows, on, n)
              for stage, run, on, n in order
              for rows in _stage_rows(plan, stage, block)]
             for block in range(plan["grid"])]
    return progs, runs


def _run_schedule(plan, B, progs, ctr0, reached, order=None):
    """Run ``progs`` (``_schedule``'s) greedily block by block (in
    ``order``, default the blocks' own) on u32
    counters that start at ``ctr0``, a unit starting once
    ``reached(counter, target)`` holds for the counter it polls (both mod
    2^32, the target ``ctr0`` + runs x ``ar_stage_target``).  Returns the
    blocks' positions, the counters, and the units that started before
    every unit of the previous stage's run on their rows was done."""
    ctr = {}
    done = {}        # (stage, run) -> units done on each row
    early = 0
    pos = [0] * len(progs)
    moved = True
    while moved:
        moved = False
        for b in order or range(len(progs)):
            prog = progs[b]
            while pos[b] < len(prog):
                stage, run, (r0, r1), on, n = prog[pos[b]]
                if on is not None:
                    target = (ctr0 + n * ak.ar_stage_target(plan, on)) % 2**32
                    if not reached(ctr.get(on, ctr0), target):
                        break
                    rows = done.get((on, n - 1), np.zeros(B, np.int64))[r0:r1]
                    early += not (rows == _per_row(plan, on)).all()
                ctr[stage] = (ctr.get(stage, ctr0) + 1) % 2**32
                done.setdefault((stage, run), np.zeros(B, np.int64))
                done[(stage, run)][r0:r1] += 1
                pos[b] += 1
                moved = True
    return pos, ctr, early


def _wrap_safe(counter, target):
    """``wn_hopper.cuh::wait_counter``'s test: (counter - target) mod 2^32
    read as a signed 32-bit integer is not negative."""
    return (counter - target) % 2**32 < 2**31


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B", WAIT_FLEETS)
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_schedule_on_the_counters_runs_three_steps(kernel_size, B, quantize):
    """The kernel's schedule at 2 layers a step: each block takes its units
    in the kernel's order and starts one only when the counter it polls
    has reached its target; run greedily block by block, every block
    reaches the end of 3 steps (no deadlock), each unit starting only once
    every unit of the previous stage's run on its rows is done (so no
    target is too low), and each counter ends at its runs x its target."""
    plan = _units_plan(kernel_size, B, quantize)
    progs, runs = _schedule(plan, 2, 3)
    pos, ctr, early = _run_schedule(plan, B, progs, 0, lambda c, t: c >= t)
    assert pos == [len(p) for p in progs], "deadlock"
    assert early == 0
    for stage, n in ctr.items():
        assert n == runs[stage] * ak.ar_stage_target(plan, stage)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("B", [1, 17, 32, 48, 160])
@pytest.mark.parametrize("kernel_size", [2, 3])
def test_counters_that_wrap_order_the_schedule(kernel_size, B, quantize):
    """The kernel's counters start at ``AR_CTR0`` = 2^32 - 1, so each wraps
    at its first arrival, as a counter of a long decode does past 2^32
    arrivals (about 1.1M steps of 128 gate units at 30 layers): on the
    wrap-safe test the schedule runs as from zero, each counter ending at
    ``AR_CTR0`` + its runs x its target mod 2^32; an unsigned ``>=`` lets
    a unit start before its rows are done, so the card's tests, which run
    every launch from ``AR_CTR0``, fail on it.  Block 0, which holds the
    first unit of every stage, runs last: the others then poll counters
    that no unit has reached yet."""
    assert ak.AR_CTR0 == 2**32 - 1
    plan = _units_plan(kernel_size, B, quantize)
    progs, runs = _schedule(plan, 2, 3)
    order = list(range(1, plan["grid"])) + [0]
    pos, ctr, early = _run_schedule(plan, B, progs, ak.AR_CTR0, _wrap_safe,
                                    order)
    assert pos == [len(p) for p in progs], "deadlock"
    assert early == 0
    for stage, n in ctr.items():
        assert n == (ak.AR_CTR0 + runs[stage]
                     * ak.ar_stage_target(plan, stage)) % 2**32
    _, _, early = _run_schedule(plan, B, progs, ak.AR_CTR0,
                                lambda c, t: c >= t, order)
    assert early > 0
