"""The matmul-chain probe (``scripts/matmul_chain_probe.py``) and its port
on the CPU: the port's plain chain against the JAX Pallas kernel itself.

The script runs as it is (``runpy``, argv ``B n variant``) with
``pallas_call`` in interpret mode; its first chain call's inputs and output
are captured and the run stops there.  ``jax.jit`` is the identity for the
run (the capture needs concrete arrays), x64 is off as the script expects,
and its compilation-cache settings are dropped, so nothing is written
beside it.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl

from pytorchwavenetvocoder_tpu_torch.bin import matmul_chain_probe as probe
from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "matmul_chain_probe.py")

#: the order in which the script hands its weights to pallas_call
#: (`:61-88` there; full and dual also ship ws, which they never read)
SHIPPED = {"split": ("wc", "wp", "ws"), "merged": ("wm", "ws"),
           "spine": ("wc", "ws"), "full": ("wc", "ws", "wb"),
           "dual": ("wc", "ws", "wb"), "int8": ("w1", "w2", "wsc"),
           "int8raw": ("w1", "w2")}


class _Captured(Exception):
    pass


def _jax_probe(monkeypatch, B, n, variant):
    """(x0, {name: weight}, out) of the script's first chain call, numpy."""
    cap = {}
    real_pallas_call = pl.pallas_call
    real_update = jax.config.update

    def pallas_call(kernel, **kw):
        f = real_pallas_call(kernel, **dict(kw, interpret=True))

        def call(*args):
            out = f(*args)
            cap["args"] = [np.asarray(a) for a in args]
            cap["out"] = np.asarray(out)
            raise _Captured
        return call

    def update(name, value):
        if "cache" not in name:
            real_update(name, value)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    monkeypatch.setattr(jax.config, "update", update)
    monkeypatch.setattr(sys, "argv", [SCRIPT, str(B), str(n), variant])
    # the script's int32 shifts take a Python int, which x64 (on in this
    # suite) would make int64
    with jax.enable_x64(False), pytest.raises(_Captured):
        runpy.run_path(SCRIPT, run_name="__main__")
    x0, *weights = cap["args"]
    return x0, dict(zip(SHIPPED[variant], weights)), cap["out"]


# at B=8 and two steps: the bf16 chains grow (~700 from randn) but stay
# finite, and the step boundary (int8's bf16 carry, int8raw's truncation)
# is crossed once
@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_plain_chain_matches_the_jax_pallas_kernel(monkeypatch, variant):
    B, n = 8, 2
    x0, weights, out = _jax_probe(monkeypatch, B, n, variant)
    assert x0.shape == (B, mc.R) and out.shape == (B, mc.R)
    w = mc.chain_weights_from_numpy(weights)
    x = torch.from_numpy(x0.astype(np.float32)).to(torch.bfloat16)
    got = mc.matmul_chain_reference(x, w, variant, n)
    assert got.dtype == torch.bfloat16 and got.shape == (B, mc.R)
    got = got.float().numpy()
    want = out.astype(np.float32)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    if variant == "int8raw":
        # integer products and shifts: exact in both
        np.testing.assert_array_equal(got, want)
        return
    # f32 sums in another order (XLA's dot against PyTorch's) round a few
    # bf16 values the other way, and the chain carries every flip through
    # the later layers and steps: the same plain chain with f64 instead of
    # f32 sums moves by 1.4e-2 to 1.5e-2 of max|out| (B=128, two steps),
    # and this comparison reads 1.1e-2 to 1.7e-2 (2-3.5 bf16 ulps at the
    # largest values), so the limit is 3e-2.  int8: the integer products
    # and the dequantization agree exactly, but sigmoid and tanh an f32 ulp
    # apart flip a gate quantum now and then, which moves every column of
    # its row a little: 8.3e-3 of max|out| in 7.8% of the elements here;
    # limits 2e-2 and 25%.  A dropped weight or a per-tensor scale moves
    # the output by its own size.
    d = np.abs(got - want)
    rel = d.max() / np.abs(want).max()
    if variant == "int8":
        assert rel <= 2e-2 and (d > 0).mean() <= 0.25, (rel, (d > 0).mean())
    else:
        assert rel <= 3e-2, rel


def test_wrapper_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    w = mc.make_chain_weights("int8raw", gen)
    x0 = torch.randn((5, mc.R), generator=gen).to(torch.bfloat16)
    before = mc.matmul_chain.launches
    got = mc.matmul_chain(x0, w, "int8raw", 2)
    assert mc.matmul_chain.launches == before     # no kernel launch
    assert torch.equal(got, mc.matmul_chain_reference(x0, w, "int8raw", 2))
    with pytest.raises(ValueError, match="unsupported device"):
        mc.matmul_chain(x0.to("meta"), w, "int8raw", 2)
    with pytest.raises(ValueError, match="variant"):
        mc.matmul_chain(x0, w, "tiled", 2)


@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_weights_have_the_script_shapes_and_bytes(variant):
    w = mc.make_chain_weights(variant, torch.Generator().manual_seed(0))
    assert tuple(w) == mc.VARIANT_WEIGHTS[variant]
    assert sum(t.numel() * t.element_size() for t in w.values()) == \
        mc.weight_bytes(variant)
    for name, t in w.items():
        if t.dtype == torch.int8:
            assert t.abs().max() <= 127
        elif name == "wsc":
            assert t.min() >= 1e-4
        else:   # randn x 0.02
            assert 0.015 < t.float().std() < 0.025
    # the weights the variant reads, each once: 86.5 / 55.1 / 62.9 / 43.6 /
    # 43.3 MB (split and merged / spine / full and dual / int8 / int8raw)
    mb = {"split": 86.5, "merged": 86.5, "spine": 55.1, "full": 62.9,
          "dual": 62.9, "int8": 43.6, "int8raw": 43.3}[variant]
    assert abs(mc.weight_bytes(variant) / 1e6 - mb) < 0.1
    # the script's FLOP count (`:222-228`)
    R, S, L = mc.R, mc.S, mc.L
    want = {"split": 2 * 4 * R * (2 * 2 * R + (S + R)) * L,
            "merged": 2 * 4 * (2 * R) * (2 * R) * L + 2 * 4 * R * (S + R) * L,
            "spine": 2 * 4 * R * (2 * R + S + R) * L,
            "full": 2 * 4 * R * 2 * R * 2 * L,
            "dual": 2 * 4 * R * 2 * R * 2 * L,
            "int8": 2 * 4 * R * (4 * R + S + R) * L,
            "int8raw": 2 * 4 * R * (4 * R + S + R) * L}[variant]
    assert mc.step_ops(variant, 4) == want


#: the fleets the plan is pinned at: one row, a 16-row tile and one row
#: past it, one row short of a slab and a slab, K1's fleets, B with a
#: partial slab, and the kernel's largest
PLAN_B = (1, 16, 17, 63, 64, 128, 200, 256, 512, 1024)


def _allowed_cws(Nq, q):
    """the columns per quarter the kernel takes for a unit (powers of two,
    so a unit's columns are all dead or all live, whose wgmma width q cw is
    one of 16-128)"""
    return [cw for cw in (8, 16, 32, 64, 128, 256, 512)
            if Nq % cw == 0 and q * cw in mc.MC_NW]


def _check_plan(plan, variant, B, caps):
    grid, rows, rg, Mp = plan["grid"], plan["rows"], plan["rg"], plan["Mp"]
    assert Mp >= B and Mp == rows * rg and rows == mc.MC_SLAB
    assert 1 <= grid <= caps["blocks"]
    esz = 1 if variant in mc.INT8_VARIANTS else 2
    shapes = mc._products(variant)
    upb = 1
    for pr, (K, N, q) in zip(plan["products"], shapes):
        assert (pr["K"], pr["N"], pr["quarters"]) == (K, N, q)
        assert pr["nc"] == K * esz // mc.MC_CHUNK and pr["nc"] % 2 == 0
        # every live and dead column of every row, exactly once
        seen = torch.zeros((Mp, N), dtype=torch.int32)
        Nq, cw, G = N // q, pr["cw"], pr["G"]
        assert pr["units"] == rg * G and G * cw == Nq
        for u in range(pr["units"]):
            rgi, g = divmod(u, G)
            for qq in range(q):
                c0 = qq * Nq + g * cw
                seen[rgi * rows:(rgi + 1) * rows, c0:c0 + cw] += 1
        assert bool((seen == 1).all())
        # the cut is the kernel's, with the fewest units a block, then
        # the narrowest
        cws = _allowed_cws(Nq, q)
        assert cw in cws and mc.S % cw == 0 and pr["nw"] == q * cw
        least = min(-(-rg * Nq // c // grid) for c in cws)
        assert -(-pr["units"] // grid) == least
        assert cw == min(c for c in cws if -(-rg * Nq // c // grid) == least)
        upb = max(upb, least)
    assert plan["units_per_block"] == upb
    # the ring and the buffers fit the 227 KB a block may take
    p1, p2 = plan["products"]
    group = plan["group"]
    assert group in (1, 2, 4)
    assert all(p["nc"] % (2 * group) == 0 for p in (p1, p2))
    assert plan["a_bytes"] == rows * mc.MC_CHUNK * group
    assert plan["stage_bytes"] >= plan["a_bytes"] + group * max(p1["w_bytes"],
                                                                p2["w_bytes"])
    assert plan["stage_bytes"] % 1024 == 0
    assert 2 <= plan["stages"] <= mc.MC_RING_MAX
    assert plan["scratch"] >= 256 * max(p1["nw"], p2["nw"])
    epi = max(rows * p["cw"] * 4 + (16 * p["quarters"] * p["cw"] // 4
                                    if variant == "int8" else 0)
              for p in (p1, p2))
    assert plan["epi"] >= epi
    assert plan["smem"] == (1024 + 2 * mc.MC_RING_MAX * 8 + plan["stages"]
                            * plan["stage_bytes"] + plan["scratch"]
                            + plan["epi"])
    assert plan["smem"] <= 227 * 1024
    # the counter targets are the producers' column groups
    assert p2["target"] == p1["G"] and p1["target"] == p2["G"]
    assert plan["init_target"] == grid and plan["counters"] == 2 * rg + 1
    # dual's halves are cut alike: no row group straddles the two
    if variant == "dual":
        Mh = plan["Mh"]
        assert Mp == 2 * Mh and Mh >= B - B // 2
        assert Mh % rows == 0 and rg == 2 * (Mh // rows)
    else:
        assert plan["Mh"] == 0
    arr = mc.plan_array(plan)
    assert arr.dtype == torch.int32 and arr.numel() == 32


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("variant", mc.VARIANTS)
def test_chain_plan_covers_every_column_once(variant, B):
    B = max(B, 2) if variant == "dual" else B
    plan = mc.chain_plan(variant, B, caps=mc.H100_CAPS)
    _check_plan(plan, variant, B, mc.H100_CAPS)
    # units per block: 1 wherever the grid allows; int8 at 1,024 rows
    # needs 256 first-product units of 64 rows x 32 channels x 4 quarters
    # (the widest wgmma, 128 columns)
    assert plan["units_per_block"] == (
        2 if variant in mc.INT8_VARIANTS and B == 1024 else 1)


# a card that holds fewer blocks co-resident than the H100's 132 (another
# part, or a kernel that needs more registers): the plan cuts for the grid
# it can have, and a card with no cooperative launch or no room is refused
@pytest.mark.parametrize("blocks", [64, 100])
@pytest.mark.parametrize("variant, B", [("split", 128), ("spine", 256),
                                        ("int8", 128), ("full", 512),
                                        ("int8raw", 1024), ("dual", 200)])
def test_chain_plan_fits_a_smaller_card(variant, B, blocks):
    caps = dict(mc.H100_CAPS, blocks=blocks)
    plan = mc.chain_plan(variant, B, caps=caps)
    _check_plan(plan, variant, B, caps)
    assert plan["grid"] <= blocks
    with pytest.raises(ValueError, match="cooperative"):
        mc.chain_plan(variant, B, caps=dict(caps, cooperative=False))
    with pytest.raises(ValueError, match="fits"):
        mc.chain_plan(variant, B, caps=dict(caps, blocks=0))


def _unswizzle(tile: torch.Tensor) -> torch.Tensor:
    """(n, 128) bytes of a swizzled tile -> row-major: row r's 16-byte
    chunk j lies at chunk j ^ (r % 8)"""
    n = tile.shape[0]
    out = torch.empty_like(tile)
    for r in range(n):
        for j in range(8):
            out[r, 16 * j:16 * j + 16] = tile[r, 16 * (j ^ (r % 8)):
                                              16 * (j ^ (r % 8)) + 16]
    return out


@pytest.mark.parametrize("variant, B", [("split", 16), ("split", 128),
                                        ("int8", 16), ("int8", 256),
                                        ("full", 200)])
def test_packed_units_hold_the_unit_columns(variant, B):
    # the kernel's unit (layer l, column group g) reads one run: per
    # 128-byte K chunk a W tile whose row q * cw + c is column q * N /
    # quarters + g * cw + c, the chunk's K values, in the 128-byte swizzle
    w = mc.make_chain_weights(variant, torch.Generator().manual_seed(1))
    plan = mc.chain_plan(variant, B, caps=mc.H100_CAPS)
    p1, p2 = mc.pack_chain_weights(w, variant, plan)
    ref1, ref2 = mc.product_weights(w, variant)
    if variant == "split":
        assert torch.equal(ref1, torch.cat([w["wc"], w["wp"]], dim=1))
    for packed, ref, pr in ((p1, ref1, plan["products"][0]),
                            (p2, ref2, plan["products"][1])):
        Lw, K, N = ref.shape
        q, cw, G, nc = pr["quarters"], pr["cw"], pr["G"], pr["nc"]
        esz = ref.element_size()
        depth = mc.MC_CHUNK // esz
        assert packed.dtype == torch.uint8
        assert packed.shape == (Lw, G, nc * q * cw * mc.MC_CHUNK)
        tiles = packed.view(Lw, G, nc, q * cw, 8, 16)
        raw = ref.contiguous().view(torch.uint8)       # (Lw, K, N * esz)
        rng = np.random.RandomState(0)
        for _ in range(100):
            l, g, k = rng.randint(Lw), rng.randint(G), rng.randint(K)
            qq, cc = rng.randint(q), rng.randint(cw)
            col, r = qq * (N // q) + g * cw + cc, qq * cw + cc
            kb = (k % depth) * esz                     # byte of the row
            h = (kb // 16) ^ (r % 8)
            got = tiles[l, g, k // depth, r, h, kb % 16:kb % 16 + esz]
            assert torch.equal(got, raw[l, k, col * esz:(col + 1) * esz])


@pytest.mark.parametrize("variant, B", [("split", 128), ("spine", 16),
                                        ("int8raw", 64)])
def test_unit_sums_from_the_ring_match_the_plain_products(variant, B):
    # one unit of each product as the kernel forms it: ring position p of
    # np = nc / group holds the group of K chunks (p // 2 + (p % 2) np / 2)
    # * group + i (A columns mod R for the first product: [out | out]) and
    # their unswizzled W tiles; the even positions sum the first half of K,
    # the odd ones the second (split: out @ wc, out @ wp), against the plain
    # products in float64
    gen = torch.Generator().manual_seed(5)
    w = mc.make_chain_weights(variant, gen)
    plan = mc.chain_plan(variant, B, caps=mc.H100_CAPS)
    packs = mc.pack_chain_weights(w, variant, plan)
    q8 = variant in mc.INT8_VARIANTS
    rows = plan["rows"]
    if q8:
        A = [torch.randint(-127, 128, (rows, mc.R), generator=gen,
                           dtype=torch.int8)] * 2
    else:
        A = [torch.randn((rows, mc.R), generator=gen).to(torch.bfloat16)] * 2
    l = 3
    for i, (packed, ref) in enumerate(zip(packs,
                                          mc.product_weights(w, variant))):
        pr = plan["products"][i]
        q, cw, G, nc = pr["quarters"], pr["cw"], pr["G"], pr["nc"]
        esz = 1 if q8 else 2
        depth = mc.MC_CHUNK // esz
        dt = torch.int8 if q8 else torch.bfloat16
        g = G - 1
        run = packed[l, g].view(nc, q * cw, mc.MC_CHUNK)
        halves = [torch.zeros((rows, q * cw), dtype=torch.float64)
                  for _ in range(2)]
        group = plan["group"]
        np_ = nc // group
        for p in range(np_):
            for gi in range(group):
                c = (p // 2 + (p % 2) * (np_ // 2)) * group + gi
                Wt = _unswizzle(run[c]).view(dt).double()      # (q cw, depth)
                a0 = (c * depth) % mc.R if i == 0 else c * depth
                At = A[i][:, a0:a0 + depth].double()
                halves[p % 2] += At @ Wt.T
        cols = torch.cat([torch.arange(qq * (ref.shape[2] // q) + g * cw,
                                       qq * (ref.shape[2] // q) + (g + 1) * cw)
                          for qq in range(q)])
        Ak = (torch.cat([A[i], A[i]], dim=1) if ref.shape[1] == 2 * mc.R
              else A[i]).double()
        K = ref.shape[1]
        first = Ak[:, :K // 2] @ ref[l, :K // 2, cols].double()
        second = Ak[:, K // 2:] @ ref[l, K // 2:, cols].double()
        torch.testing.assert_close(halves[0], first, rtol=1e-12, atol=1e-9)
        torch.testing.assert_close(halves[1], second, rtol=1e-12, atol=1e-9)


def test_weights_from_numpy_refuse_other_shapes():
    with pytest.raises(ValueError, match="shape"):
        mc.chain_weights_from_numpy({"wc": np.zeros((2, 3), np.float32)})
    with pytest.raises(ValueError, match="unknown"):
        mc.chain_weights_from_numpy({"wz": np.zeros((2, 3), np.float32)})


def test_probe_cli_on_the_cpu(capsys):
    res = probe.main(["8", "2", "split", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("chain B=8 variant=split: ")
    assert "us/step" in line and "T(FL)OPs" in line and "cpu" in line
    assert res["out"].shape == (8, mc.R)
    assert torch.isfinite(res["out"].float()).all()
    assert res["us_per_step"] > 0


def test_probe_cli_defaults_to_cuda_and_says_so():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs the kernel")
    with pytest.raises(RuntimeError, match="--device cuda"):
        probe.main(["8", "2", "split"])
